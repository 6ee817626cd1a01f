"""The port's active-learning seed ensemble against the JAX package's:
`active_learning_ensemble` of S = 3 stacked replicas (parameters carried
across through the checkpoint flat keys) under JAX's replayed key tree
(`JaxALKeys`) for the gauss, EDDI, flow and MIWAE families; each replica
against the port's serial `active_learning_func` of its parameters under
the same draws, asked for in the same order (so any stateful source gives
both the same values), and under the default noise for the gauss family;
the `.seed{s}` artifacts against JAX's in name, shape and dtype; and the AL entry point's `-seeds` and `-ensemble true` paths
against JAX's, run over the same trained checkpoints."""

import json
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu import config as jcfg
from vae_posterior_consistency_tpu.engine import active_learning as jal
from vae_posterior_consistency_tpu.engine import artifacts as jart
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.engine import active_learning as tal
from vae_posterior_consistency_tpu_torch.engine import artifacts as tart
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.experiment_main import (
    active_learning,
    imputation,
)
from cli_harness import REPO, grid_record
from test_torch_active_learning import (
    EPISODES,
    FLOW_KNOT_ATOL,
    FLOW_KNOT_SHARE,
    JaxALKeys,
    _assert_gaps,
    _data,
    _params,
)

#: the replicas' parameter seeds (S = 3)
SEEDS = (7, 8, 9)
#: rewards and curves against JAX: ten O(1) chaini 'KL' terms cancelling to
#: a reward, each rounded at about 1e-6 after 50- to 128-wide layers, and
#: MSE means of decoder outputs in [0, 1]
ATOL, RTOL = 1e-5, 1e-4
#: imputations: decoder outputs after the same layers
IM_ATOL = 1e-5
#: a replica against the serial episode: the same math with the replica
#: axis batched into the GEMMs, rounded in another order
SERIAL_ATOL, SERIAL_RTOL = 1e-5, 1e-4
#: the wine width and test split's size
D, N = 13, 17


def _tol(R):
    return ATOL + RTOL * np.abs(R)


def _stacked(jc, head_scale):
    """S replicas' parameters: JAX's stacked on a leading axis, and the
    port's from the same flat checkpoint keys, stacked the same way."""
    pairs = [_params(jc, head_scale, seed) for seed in SEEDS]
    jens = jax.tree_util.tree_map(lambda *a: jnp.stack(a),
                                  *[p[0] for p in pairs])
    flats = [tckpt.flatten(p[1]) for p in pairs]
    tens = tckpt.unflatten({k: torch.stack([f[k] for f in flats])
                            for k in flats[0]})
    return jens, tens, [p[1] for p in pairs]


@pytest.fixture(scope="module")
def ensembles(tmp_path_factory):
    """Each family's S-replica ensemble run by both packages from the same
    parameters and keys, each saved to a directory of its own."""
    cache = {}

    def run(vae_type):
        if vae_type not in cache:
            M, repeat, head_scale, extra = EPISODES[vae_type]
            kw = dict(vae_type=vae_type, M=M, seed=3, missing_rate=30,
                      **extra)
            jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
            jens, tens, singles = _stacked(jc, head_scale)
            x, mask = _data()
            key = jax.random.PRNGKey(5)
            jroot = str(tmp_path_factory.mktemp(f"jax_{vae_type}"))
            troot = str(tmp_path_factory.mktemp(f"port_{vae_type}"))
            want = jal.active_learning_ensemble(
                x, mask, jc, jens, experiments_root=jroot, Repeat=repeat,
                key=key)
            keys, draws, order = JaxALKeys(key, tc), {}, []

            def recording(kind, r, step, shape):
                drawn = keys(kind, r, step, shape)
                draws[kind, r, step, tuple(shape)] = drawn
                order.append((kind, r, step, tuple(shape)))
                return drawn

            got = tal.active_learning_ensemble(
                x, mask, tc, tens, experiments_root=troot, Repeat=repeat,
                noise=recording, device="cpu")
            cache[vae_type] = dict(
                jc=jc, tc=tc, jroot=jroot, troot=troot, x=x, mask=mask,
                singles=singles, tens=tens, draws=draws, order=order,
                want={k: np.asarray(v) for k, v in want.items()},
                got={k: v.numpy() for k, v in got.items()})
        return cache[vae_type]

    return run


@pytest.mark.parametrize("vae_type", sorted(EPISODES))
def test_ensemble_matches_jax(ensembles, vae_type):
    """Every replica's rewards, reveals, imputations and curve against
    JAX's ensemble, once each row's top-two gap clears the tolerance."""
    run = ensembles(vae_type)
    want, got = run["want"], run["got"]
    M, repeat, _, _ = EPISODES[vae_type]
    S = len(SEEDS)
    assert got["R_hist"].shape == want["R_hist"].shape == (
        S, repeat, D - 1, N, D - 1)
    assert got["im"].shape == (S, repeat, D - 1, M, N, D)
    _assert_gaps(want["R_hist"], _tol)
    np.testing.assert_array_equal(got["action"], want["action"])
    err = np.abs(got["R_hist"] - want["R_hist"])
    off = err > _tol(want["R_hist"])
    if vae_type == "reg_flow1":
        # a sampled z within rounding of a spline knot takes the next bin
        # in one package (ROADMAP C.4.6)
        assert off.mean() <= FLOW_KNOT_SHARE, np.argwhere(off)
        assert err.max() <= FLOW_KNOT_ATOL, err.max()
    else:
        assert not off.any(), (err.max(), np.argwhere(off)[:5])
    np.testing.assert_allclose(got["im"], want["im"], rtol=0, atol=IM_ATOL)
    np.testing.assert_allclose(got["information_curve"],
                               want["information_curve"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("vae_type", sorted(EPISODES))
def test_each_replica_is_the_serial_episode(ensembles, vae_type):
    """Replica s of the fixture's ensemble equals the port's serial episode
    of replica s's parameters under the same draws (JAX's, as the
    ensemble drew them), and the serial episode asks for its draws in the
    order and at the shapes the ensemble drew them (`replay_noise`): so
    under a stateful source, the default noise of every CLI run, both get
    the same values."""
    run = ensembles(vae_type)
    tc, x, draws = run["tc"], run["x"], run["draws"]
    repeat = EPISODES[vae_type][1]
    ens = {k: torch.from_numpy(v) for k, v in run["got"].items()}
    for s, params in enumerate(run["singles"]):
        asked = []

        def replay(kind, r, step, shape):
            asked.append((kind, r, step, tuple(shape)))
            return draws[asked[-1]]

        serial = tal.active_learning_func(
            None, x, run["mask"], tc, params=params, Repeat=repeat,
            noise=replay, save=False, device="cpu")
        assert asked == run["order"], s
        _assert_gaps(serial["R_hist"].numpy(),
                     lambda R: SERIAL_ATOL + SERIAL_RTOL * np.abs(R))
        assert torch.equal(ens["action"][s], serial["action"]), s
        for name in tal.ARTIFACTS:
            np.testing.assert_allclose(ens[name][s].numpy(),
                                       serial[name].numpy(),
                                       rtol=SERIAL_RTOL, atol=SERIAL_ATOL,
                                       err_msg=f"replica {s}, {name}")


def test_a_replica_under_the_default_noise_is_the_serial_episode():
    """Under the default noise (one stateful generator, as every CLI run
    draws) replica s of the gauss family's ensemble equals the port's
    serial episode of replica s's parameters, over two repeats."""
    M, repeat, head_scale, extra = EPISODES["vanilla_vae1"]
    kw = dict(vae_type="vanilla_vae1", M=M, seed=3, missing_rate=30,
              **extra)
    tc = tcfg.RunConfig(**kw)
    _, tens, singles = _stacked(jcfg.RunConfig(**kw), head_scale)
    x, mask = _data()
    ens = tal.active_learning_ensemble(x, mask, tc, tens, Repeat=repeat,
                                       save=False, device="cpu")
    for s, params in enumerate(singles):
        serial = tal.active_learning_func(None, x, mask, tc, params=params,
                                          Repeat=repeat, save=False,
                                          device="cpu")
        _assert_gaps(serial["R_hist"].numpy(),
                     lambda R: SERIAL_ATOL + SERIAL_RTOL * np.abs(R))
        assert torch.equal(ens["action"][s], serial["action"]), s
        for name in tal.ARTIFACTS:
            np.testing.assert_allclose(ens[name][s].numpy(),
                                       serial[name].numpy(),
                                       rtol=SERIAL_RTOL, atol=SERIAL_ATOL,
                                       err_msg=f"replica {s}, {name}")


@pytest.mark.parametrize("vae_type", sorted(EPISODES))
def test_seed_artifacts_match_jax_in_names_shapes_and_dtypes(ensembles,
                                                             vae_type):
    run = ensembles(vae_type)
    jpaths = jart.active_learning_paths(run["jc"], run["jroot"])
    tpaths = tart.active_learning_paths(run["tc"], run["troot"])
    for s in range(len(SEEDS)):
        sfx = "" if s == 0 else f".seed{s}"
        for name in tal.ARTIFACTS:
            assert (os.path.relpath(tpaths[name] + sfx, run["troot"])
                    == os.path.relpath(jpaths[name] + sfx, run["jroot"]))
            want = torch.load(jpaths[name] + sfx, weights_only=False)
            got = torch.load(tpaths[name] + sfx, weights_only=True)
            assert got.dtype == want.dtype == torch.float32, name
            assert got.shape == want.shape, name
            np.testing.assert_array_equal(got.numpy(), run["got"][name][s])
    # al_final_mse of replica 0 only, one value a repeat
    recs = []
    for root in (run["jroot"], run["troot"]):
        path = os.path.join(root, run["tc"].experiment_type,
                            run["tc"].data_type, "metrics.jsonl")
        with open(path) as fh:
            recs.append([json.loads(line) for line in fh])
    (jrec,), (trec,) = recs
    assert trec["metric"] == jrec["metric"] == "al_final_mse"
    np.testing.assert_allclose(trec["value"], jrec["value"], rtol=RTOL)


def test_mesh_raises_naming_its_slice():
    """Since slice 10 part 2 the ensemble episode runs on a mesh: on a
    one-device mesh it is the single-device episode, bit for bit."""
    from torch_dist_worker import one_rank_mesh

    kw = dict(vae_type="vanilla_vae1", M=2)
    tc = tcfg.RunConfig(**kw)
    x, mask = _data()
    x = x[:4]
    _, tens, _ = _stacked(jcfg.RunConfig(**kw), 1.0)
    tens = tckpt.unflatten({k: v[:1] for k, v in
                            tckpt.flatten(tens).items()})
    plain = tal.active_learning_ensemble(x, mask, tc, tens, save=False,
                                         device="cpu")
    with one_rank_mesh() as mesh:
        meshed = tal.active_learning_ensemble(x, mask, tc, tens, save=False,
                                              mesh=mesh, device="cpu")
    for name in tal.ARTIFACTS:
        assert torch.equal(plain[name], meshed[name]), name


# ---------------------------------------------------------------------------
# the entry point's ensemble paths against JAX's
# ---------------------------------------------------------------------------

#: synth_small records (120 rows of 6: episodes of 5 reveals), trained 1
#: epoch by the port's imputation entry point, narrow, M = 2
BASE = dict(data_type="synth_small", epoch=1, batch_size=16, M=2, train_k=1,
            valid_k=1, latent_dim=4, missing_rate=30, hid_dim=32)
GRID = [grid_record(vae_type=v, **BASE) for v in ("reg_vae1", "vanilla_vae1")]
#: the entry point's ensemble paths: (training flags, AL flags)
AL_PATHS = {
    "-seeds 2": (["-seeds", "2"], ["-seeds", "2"]),
    "-ensemble true -missings 10,30": (
        ["-ensemble", "true", "-seeds", "2", "-missings", "10,30"],
        ["-ensemble", "true", "-seeds", "2", "-missings", "10,30"]),
}


def _workdir(path):
    os.makedirs(path / "Data")
    shutil.copytree(os.path.join(REPO, "Data", "synth_small"),
                    path / "Data" / "synth_small")
    (path / "Data" / "imputation_args.json").write_text("\n".join(GRID)
                                                        + "\n")
    return path


def _written(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(os.path.join(root,
                                                          "experiments"))
                  for f in files)


def _shape_of_lines(out):
    """The printed lines of a run with every decimal number blanked: what
    JAX's and the port's runs share whatever their draws."""
    return [re.sub(r"-?\d+\.\d+", "#", ln) for ln in out.splitlines()
            if ln.startswith(("===", "  "))]


def _run_jax_al(monkeypatch, workdir, flags):
    import importlib

    jmod = importlib.import_module("experiment_main.active_learning")
    # the JAX entry point sets the records' PRNG implementation (rbg);
    # this process keeps the tests' threefry
    monkeypatch.setattr(jmod, "apply_rng_impl", lambda cfg: None)
    monkeypatch.setattr("sys.argv", ["active_learning.py", *flags])
    monkeypatch.chdir(workdir)
    jmod._run_grid(list(jcfg.iter_jsonl_configs(
        os.path.join("Data", "imputation_args.json"))))


@pytest.mark.parametrize("path", sorted(AL_PATHS))
def test_entry_point_ensemble_writes_what_jax_writes(tmp_path, monkeypatch,
                                                     capsys, path):
    """Over a reg and a vanilla record trained by the port: the port's and
    JAX's AL entry points print the same lines (numbers aside) and write
    the same files, `.seed1` siblings included; every curve is finite."""
    train_flags, al_flags = AL_PATHS[path]
    port_dir = _workdir(tmp_path / "port")
    monkeypatch.chdir(port_dir)
    assert imputation.main(["-device", "cpu", *train_flags]) == 0
    jax_dir = tmp_path / "jax"
    shutil.copytree(port_dir, jax_dir)
    trained = set(_written(port_dir))
    capsys.readouterr()
    assert active_learning.main(["-device", "cpu", *al_flags]) == 0
    port_out = capsys.readouterr().out
    _run_jax_al(monkeypatch, jax_dir, al_flags)
    jax_out = capsys.readouterr().out
    assert _written(port_dir) == _written(jax_dir)
    new = set(_written(port_dir)) - trained
    assert sum(f.endswith(".seed1") for f in new) == len(new) // 2 > 0
    want = _shape_of_lines(jax_out)
    assert want and _shape_of_lines(port_out) == want
    finals = [float(v) for v in re.findall(r"s\d=(-?\d+\.\d+)", port_out)]
    assert finals and np.isfinite(finals).all()
