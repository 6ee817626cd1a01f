"""The port's CSV imputer (`examples/impute_csv`) against the JAX package's
`examples/impute_csv.py`: the same normalisation of the observed cells
(bit for bit, the all-NaN column included), the same table written back,
and, under JAX's replayed keys, the same imputations."""

import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

import vae_posterior_consistency_tpu.config as jcfg
from test_torch_serve import _jax_noise
from test_torch_train import JaxKeyStream
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu.engine import serve as jserve
from vae_posterior_consistency_tpu.engine import train as jtrain
from vae_posterior_consistency_tpu.models import get_model as jget_model
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.examples import impute_csv as timp

REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_impute_csv", REPO / "examples" / "impute_csv.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_table(path, empty_col=False, n=20, D=5, seed=0):
    """A float table of n rows with about 30% of its cells blank and the
    others on scales from 0.1 to 1 about means 0 to D - 1, so below 10 in
    magnitude; `empty_col` blanks column 2."""
    rng = np.random.default_rng(seed)
    raw = (rng.standard_normal((n, D)) * np.logspace(-1, 0, D)
           + np.arange(D)).astype(np.float32)
    raw[rng.random((n, D)) < 0.3] = np.nan
    if empty_col:
        raw[:, 2] = np.nan
    with open(path, "w") as fh:
        for row in raw:
            fh.write(",".join("" if np.isnan(v) else repr(float(v))
                              for v in row) + "\n")
    return raw


@pytest.fixture
def no_rng_impl(monkeypatch):
    # the JAX example sets the records' PRNG implementation (rbg); this
    # process keeps the tests' threefry
    monkeypatch.setattr(jcfg, "apply_rng_impl", lambda cfg: None)


@pytest.mark.parametrize("empty_col", [False, True])
def test_the_table_is_normalised_and_written_back_as_in_jax(
        tmp_path, monkeypatch, capsys, no_rng_impl, empty_col):
    """Both examples with their trainer and server replaced by stand-ins
    that record what they are handed and impute 0.25 everywhere: the same
    training inputs bit for bit, the same stderr, the same file."""
    src = tmp_path / "in.csv"
    _write_table(src, empty_col)
    seen = {}

    def fake_train(tag):
        def train(ds, cfg, **kw):
            seen[tag] = (np.asarray(ds.train.x), np.asarray(ds.train.mask),
                         cfg.batch_size, cfg.epoch, cfg.M, cfg.reg_type,
                         cfg.p_missingness)
            return {}, None
        return train

    class FakeServer:
        def __init__(self, params, cfg, D, buckets, **kw):
            self.buckets = buckets

        def impute(self, x, mask):
            return np.full(x.shape, 0.25, np.float32), np.zeros(x.shape[0])

    monkeypatch.setattr(jtrain, "train", fake_train("jax"))
    monkeypatch.setattr(jserve, "ImputationServer", FakeServer)
    monkeypatch.setattr(timp.train_engine, "train", fake_train("port"))
    monkeypatch.setattr(timp, "ImputationServer", FakeServer)
    common = ["--input", str(src), "--epochs", "3"]
    monkeypatch.setattr("sys.argv", ["impute_csv.py", *common, "--output",
                                     str(tmp_path / "jax.csv")])
    _jax_example().main()
    jerr = capsys.readouterr().err
    timp.main([*common, "--output", str(tmp_path / "port.csv"),
               "--device", "cpu"])
    terr = capsys.readouterr().err
    assert terr.replace("port.csv", "jax.csv") == jerr
    assert ("no observed values" in terr) == empty_col
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(a, b)
    assert (tmp_path / "port.csv").read_bytes() == (
        tmp_path / "jax.csv").read_bytes()


@pytest.mark.parametrize("vae_type", ["reg_vae1", "reg_EDDI1"])
def test_the_imputations_match_jax_under_its_keys(tmp_path, monkeypatch,
                                                   no_rng_impl, vae_type):
    """JAX's example end to end (3 epochs) against `impute_table` from
    JAX's initial parameters under its replayed training and serving keys:
    the written table within atol 1e-4 (the file holds 6 significant
    digits of values below 10: it rounds them by at most 5e-6)."""
    src = tmp_path / "in.csv"
    raw = _write_table(src, seed=1)
    assert np.nanmax(np.abs(raw)) < 10
    monkeypatch.setattr("sys.argv", [
        "impute_csv.py", "--input", str(src), "--output",
        str(tmp_path / "jax.csv"), "--epochs", "3", "--vae_type", vae_type])
    _jax_example().main()
    want = np.loadtxt(tmp_path / "jax.csv", delimiter=",")

    kw = dict(vae_type=vae_type, epoch=3, batch_size=raw.shape[0],
              p_missingness=30, reg_type="kl_reg", seed=0, M=2)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    k_init, k_run = jax.random.split(jax.random.PRNGKey(jc.seed))
    init = jget_model(jc).init(k_init, jc, raw.shape[1])
    got, score = timp.impute_table(
        raw, epochs=3, vae_type=vae_type, device="cpu",
        params=tckpt.params_from_jax(jckpt._flatten(init), "cpu"),
        noise=JaxKeyStream(k_run, tc), serve_noise=_jax_noise(tc))
    assert got.shape == raw.shape and np.isfinite(score).all()
    observed = ~np.isnan(raw)
    np.testing.assert_array_equal(got[observed], raw[observed])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_without_cuda_it_asks_for_the_cpu(tmp_path, monkeypatch):
    src = tmp_path / "in.csv"
    _write_table(src)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        timp.main(["--input", str(src), "--output", str(tmp_path / "o.csv")])
    assert not (tmp_path / "o.csv").exists()
