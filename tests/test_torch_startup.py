"""The entry points' shared start-up in the port: the default grids
(`data/default_configs`) byte for byte the JAX package's; every entry point
writing them where they are missing instead of raising; `-profile DIR`
through `config.maybe_profile` and `utils/logging.profile_trace`; and
`utils/debugging`: VPC_DEBUG_NANS, `checked`, VPC_PLATFORM."""

import json
import os
import shutil

import pytest
import torch

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.data import default_configs as jdefaults
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.data import default_configs
from vae_posterior_consistency_tpu_torch.experiment_main import (
    active_learning,
    ais_eval,
    imputation,
    imputation_mnar,
)
from vae_posterior_consistency_tpu_torch.utils import debugging, logging
from cli_harness import REPO

GRIDS = ("imputation_args.json", "imputation_args_mnar.json")
ENTRY_POINTS = {"imputation": imputation, "imputation_mnar": imputation_mnar,
                "active_learning": active_learning, "ais_eval": ais_eval}


@pytest.fixture
def device_default(monkeypatch):
    """Restores the `-device` default that VPC_PLATFORM may change."""
    monkeypatch.setitem(tcfg._EXTRA_FLAGS, "device",
                        tcfg._EXTRA_FLAGS["device"])
    monkeypatch.delenv("VPC_PLATFORM", raising=False)


@pytest.fixture
def no_anomaly():
    """Leaves the NaN tripwire (the dispatch mode and autograd's anomaly
    detection) off after the test."""
    yield
    debugging.enable_nan_debugging(False)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("name", GRIDS)
def test_default_grids_are_byte_identical_to_jax(tmp_path, name):
    default_configs.write_default_configs(str(tmp_path / "port"))
    jdefaults.write_default_configs(str(tmp_path / "jax"))
    got = _read(tmp_path / "port" / name)
    assert got == _read(tmp_path / "jax" / name)
    # the records are the repo's own grid's
    assert ([json.loads(line) for line in got.decode().splitlines()]
            == [json.loads(line) for line in open(
                os.path.join(REPO, "Data", name)) if line.strip()])


def test_record_builders_match_jax():
    assert default_configs.mcar_records() == jdefaults.mcar_records()
    assert default_configs.mnar_records() == jdefaults.mnar_records()
    assert len(default_configs.mcar_records()) == 39
    assert default_configs._record(vae_type="x", K=3) == jdefaults._record(
        vae_type="x", K=3)


def test_an_existing_file_is_not_overwritten(tmp_path):
    path = tmp_path / "imputation_args.json"
    path.write_text("kept\n")
    default_configs.write_default_configs(str(tmp_path))
    assert path.read_text() == "kept\n"
    assert (tmp_path / "imputation_args_mnar.json").stat().st_size > 0
    default_configs.write_default_configs(str(tmp_path), overwrite=True)
    assert path.read_text().count("\n") == 39


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_each_entry_point_writes_the_grid_where_it_is_missing(
        tmp_path, monkeypatch, entry):
    """In an empty directory each entry point writes both default grids
    (as JAX's do) and gets as far as the first record's data, which is
    the first file it then misses."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError) as err:
        ENTRY_POINTS[entry].main(["-device", "cpu"])
    assert "imputation_args" not in str(err.value)
    assert os.path.join("Data", "wine") in str(err.value)
    jdefaults.write_default_configs(str(tmp_path / "jax"))
    for name in GRIDS:
        assert (_read(tmp_path / "Data" / name)
                == _read(tmp_path / "jax" / name))


def _one_record_dir(tmp_path):
    os.makedirs(tmp_path / "Data")
    shutil.copytree(os.path.join(REPO, "Data", "wine"),
                    tmp_path / "Data" / "wine")
    record = json.loads(open(os.path.join(
        REPO, "Data", "imputation_args.json")).readlines()[33])
    record["epoch"]["default"] = 1
    record["M"]["default"] = 1
    (tmp_path / "Data" / "imputation_args.json").write_text(
        json.dumps(record) + "\n")
    return tmp_path


def test_profile_prints_jax_line_and_leaves_a_trace(tmp_path, monkeypatch,
                                                    capsys):
    """`-profile DIR` on the CPU: JAX's line, then a Chrome trace of the
    whole run (record 34, one epoch) in DIR, naming the run's operations."""
    monkeypatch.chdir(_one_record_dir(tmp_path))
    assert imputation.main(["-device", "cpu", "-profile", "prof"]) == 0
    out = capsys.readouterr().out
    record = {"vae_type": {"default": "reg_vae1", "help": ""}}
    jcfg.maybe_profile(jcfg.setup_parser(record, "x").parse_args(
        ["-profile", "prof"]))
    jax_line = capsys.readouterr().out.splitlines()[0]
    assert jax_line == "[profile] tracing to prof"
    assert out.splitlines()[1] == jax_line  # after the device line
    (trace,) = os.listdir("prof")
    with open(os.path.join("prof", trace)) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::addmm") or n.startswith("aten::mm")
               for n in names), sorted(names)[:20]


def test_profile_trace_writes_on_exit(tmp_path):
    logdir = str(tmp_path / "t")
    with logging.profile_trace(logdir) as where:
        assert where == logdir
        torch.ones(4).sum()
    (trace,) = os.listdir(logdir)
    assert trace.endswith(".pt.trace.json")
    assert os.path.getsize(os.path.join(logdir, trace)) > 0


def test_no_profile_flag_is_a_no_op(capsys):
    args = tcfg.setup_parser({"vae_type": {"default": "reg_vae1"}},
                             "x").parse_args([])
    with tcfg.maybe_profile(args):
        pass
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("value,on", [("1", True), ("", False)])
def test_vpc_debug_nans_turns_on_anomaly_detection(monkeypatch, no_anomaly,
                                                   value, on):
    monkeypatch.setenv("VPC_DEBUG_NANS", value)
    torch.autograd.set_detect_anomaly(False)
    assert debugging.enable_nan_debugging_from_env() is on
    assert torch.is_anomaly_enabled() is on


def test_an_entry_point_reads_vpc_debug_nans(tmp_path, monkeypatch,
                                             no_anomaly):
    monkeypatch.setenv("VPC_DEBUG_NANS", "1")
    torch.autograd.set_detect_anomaly(False)
    monkeypatch.chdir(_one_record_dir(tmp_path))
    assert imputation.main(["-device", "cpu"]) == 0
    assert torch.is_anomaly_enabled()


def test_checked_raises_on_a_nan_and_passes_finite_outputs():
    def fn(x):
        return {"loss": x.sum(), "parts": (x, torch.log(x))}

    ok = torch.tensor([1.0, 2.0])
    out = debugging.checked(fn)(ok)
    assert torch.equal(out["parts"][0], ok)
    with pytest.raises(FloatingPointError, match=r"\['parts'\]\[1\]"):
        debugging.checked(fn)(torch.tensor([1.0, -1.0]))
    with pytest.raises(FloatingPointError, match=r"\['loss'\]"):
        debugging.checked(fn)(torch.tensor([float("inf"), 1.0]))
    # integer outputs are not checked
    assert debugging.checked(lambda: torch.arange(3))().tolist() == [0, 1, 2]


def test_vpc_platform_sets_the_device_default(monkeypatch, device_default):
    record = {"vae_type": {"default": "reg_vae1", "help": ""}}
    assert debugging.apply_platform_from_env() is None
    assert tcfg.setup_parser(record, "x").parse_args([]).device == "cuda"
    monkeypatch.setenv("VPC_PLATFORM", "cpu")
    assert debugging.apply_platform_from_env() == "cpu"
    assert tcfg.setup_parser(record, "x").parse_args([]).device == "cpu"
    # an explicit -device wins
    assert tcfg.setup_parser(record, "x").parse_args(
        ["-device", "cuda"]).device == "cuda"
    monkeypatch.setenv("VPC_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="VPC_PLATFORM"):
        debugging.apply_platform_from_env()


def test_vpc_platform_reaches_an_entry_point(tmp_path, monkeypatch, capsys,
                                             device_default):
    """VPC_PLATFORM=cpu: the entry point runs on the CPU with no -device
    flag (its default is cuda)."""
    monkeypatch.setenv("VPC_PLATFORM", "cpu")
    monkeypatch.chdir(_one_record_dir(tmp_path))
    assert imputation.main([]) == 0
    assert capsys.readouterr().out.startswith("Device: cpu ")


def _inf_decoder_eval(jc):
    """JAX and port eval_vae inputs whose parameters hold no NaN but whose
    forward makes one: an encoder bias at +inf makes z infinite, and the
    decoder's first matmul adds +inf and -inf."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vae_posterior_consistency_tpu.data import loaders as jloaders
    from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
    from vae_posterior_consistency_tpu.models import get_model as jget_model
    from vae_posterior_consistency_tpu_torch.data import loaders as tloaders
    from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt

    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 1.0, (8, 5)).astype(np.float32)
    m = (rng.random((8, 5)) < 0.7).astype(np.float32)
    jparams = jget_model(jc).init(jax.random.PRNGKey(1), jc, 5)
    flat = jckpt._flatten(jparams)
    key = sorted(k for k in flat
                 if k.startswith("encoder") and k.endswith("/b"))[-1]
    flat[key] = np.full_like(flat[key], np.inf)
    *path, leaf = key.split("/")
    node = jparams
    for part in path:
        node = node[part]
    node[leaf] = jnp.asarray(flat[key])
    assert all(not np.isnan(v).any() for v in flat.values())
    jds = jloaders.Dataset(jloaders.Split(jnp.asarray(x), jnp.asarray(m),
                                          "train"), None, 5)
    tds = tloaders.Dataset(tloaders.Split(torch.from_numpy(x),
                                          torch.from_numpy(m), "train"),
                           None, 5)
    return jds, tds, jparams, tckpt.params_from_jax(flat, "cpu")


def test_a_nan_made_in_an_eval_forward_raises_in_both_packages(no_anomaly):
    """VPC_DEBUG_NANS (ROADMAP C.7): a NaN made only in `eval_vae`'s
    forward, where autograd's anomaly mode sees nothing, raises
    FloatingPointError under JAX's jax_debug_nans and the port's tripwire;
    with the tripwire off both evaluate to NaN metrics, and popping it
    leaves no mode behind."""
    import jax
    import numpy as np

    from vae_posterior_consistency_tpu.engine import evaluate as jeval
    from vae_posterior_consistency_tpu_torch.engine import evaluate as teval

    kw = dict(vae_type="vanilla_vae1", epoch=1, batch_size=8, M=1)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    jds, tds, jparams, tparams = _inf_decoder_eval(jc)
    assert np.isnan(teval.eval_vae(tds, tc, params=tparams, save=False,
                                   device="cpu")["train"]["rmse"])
    debugging.enable_nan_debugging(True)
    with pytest.raises(FloatingPointError, match="NaN in the output of"):
        teval.eval_vae(tds, tc, params=tparams, save=False, device="cpu")
    debugging.enable_nan_debugging(False)
    assert np.isnan(teval.eval_vae(tds, tc, params=tparams, save=False,
                                   device="cpu")["train"]["rmse"])
    before = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        with pytest.raises(FloatingPointError):
            jeval.eval_vae(jds, jc, params=jparams, save=False)
    finally:
        jax.config.update("jax_debug_nans", before)


def test_a_nan_made_in_a_backward_raises_naming_its_operator(no_anomaly):
    """The tripwire checks the backward's operators too: d sqrt(x) at 0 is
    inf, times 0 a NaN, which raises where anomaly detection's own NaN
    check is off; the forward made none."""
    debugging.enable_nan_debugging(True)
    assert torch.is_anomaly_enabled()
    x = torch.zeros(3, requires_grad=True)
    y = (torch.sqrt(x) * 0.0).sum()
    assert y.item() == 0.0
    with pytest.raises(FloatingPointError, match="NaN in the output of"):
        y.backward()
