"""The port's AIS seed ensemble (`engine/ais.eval_ais_ensemble`) against the
JAX package's: S = 3 stacked replicas of the gauss, flow, MIWAE and
notMIWAE bridges anneal the same chains (5 rows, 4 chains a row, linear
T = 10) under JAX's replayed keys; replica s against the port's serial
`eval_ais` of its parameters under the same draws, asked for in the same
order (so any stateful source gives both the same values), and under the
default noise for the gauss bridge; the `.seed{s}` artifacts; and `ais_eval -seeds 2` (with and without `-bdmc true`) against
JAX's entry point over the same checkpoints.

As in tests/test_torch_ais.py, every accept decision's log-space gap is
asserted to clear GAP before values are compared (ROADMAP C.4.13)."""

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
from vae_posterior_consistency_tpu.data import loaders as jloaders
from vae_posterior_consistency_tpu.engine import ais as jais
from vae_posterior_consistency_tpu.engine import checkpoint as jckpt
from vae_posterior_consistency_tpu.models import get_model as jget_model
from vae_posterior_consistency_tpu_torch import config as tcfg
from vae_posterior_consistency_tpu_torch.data import loaders as tloaders
from vae_posterior_consistency_tpu_torch.engine import ais as tais
from vae_posterior_consistency_tpu_torch.engine import checkpoint as tckpt
from vae_posterior_consistency_tpu_torch.experiment_main import ais_eval
from vae_posterior_consistency_tpu_torch.models import get_model
from test_torch_ais import (
    FAMILIES,
    JaxChainKeys,
    _assert_gaps,
    _record,
    _workdir,
    recorded_port_steps,
)

#: S replicas, rows a split, chains a row, temperatures
S, ROWS, CHAINS, T = 3, 5, 4, 10
#: the configs' seed, so the chains' keys (JAX's PRNGKey(seed + 4), the
#: port's generators from seed + 4): one whose 2 x 9 x 60 decisions all
#: clear GAP in both streams, so that none can flip on rounding
SEED = 3
L, D = 3, 6
#: logw against JAX: sums of log p(x|z) up to ~1e3 in size (the flow's
#: obs_logvar = -8); latents after T-1 HMC proposals of ten leapfrog steps,
#: a few float32 ulps a step on |z| ~ 1
LOGW_RTOL = 1e-5
Z_ATOL = 1e-5


def _stacked(vae_type, extra):
    """S replicas' parameters from JAX inits, JAX's stacked and the port's
    from the same flat checkpoint keys; and each replica's port copy."""
    kw = dict(vae_type=vae_type, latent_dim=L, ais_schedule="linear",
              n_ais_dist=T, seed=SEED, **extra)
    jc, tc = jcfg.RunConfig(**kw), tcfg.RunConfig(**kw)
    inits = [jget_model(jc).init(jax.random.PRNGKey(s), jc, D)
             for s in range(S)]
    jens = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *inits)
    singles = [tckpt.params_from_jax(jckpt._flatten(p), "cpu")
               for p in inits]
    flats = [tckpt.flatten(p) for p in singles]
    tens = tckpt.unflatten({k: torch.stack([f[k] for f in flats])
                            for k in flats[0]})
    return jc, tc, jens, tens, singles


def _datasets():
    rng = np.random.default_rng(11)
    x = {st: rng.uniform(size=(ROWS, D)).astype(np.float32)
         for st in ("train", "test")}
    jds = jloaders.Dataset(
        *[jloaders.Split(jnp.asarray(x[st]), jnp.ones((ROWS, D)), st)
          for st in ("train", "test")], obs_dim=D)
    tds = tloaders.Dataset(
        *[tloaders.Split(torch.tensor(x[st]), torch.ones(ROWS, D), st)
          for st in ("train", "test")], obs_dim=D)
    return jds, tds


def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root):
            torch.load(os.path.join(d, f), weights_only=False)
            for d, _, files in os.walk(root) for f in files
            if ".pt" in f}


@pytest.fixture(scope="module")
def ensembles(tmp_path_factory):
    """Each family's ensemble run by both packages (the port's under JAX's
    keys, each split's draws recorded), what each printed, and the port's
    accept decisions, computed once for the module's tests."""
    import contextlib
    import io

    cache = {}

    def run(vae_type, extra):
        if vae_type in cache:
            return cache[vae_type]
        jc, tc, jens, tens, singles = _stacked(vae_type, extra)
        jds, tds = _datasets()
        jroot = str(tmp_path_factory.mktemp(f"jax_{vae_type}"))
        troot = str(tmp_path_factory.mktemp(f"port_{vae_type}"))
        jax_out, port_out = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(jax_out):
            want = jais.eval_ais_ensemble(jds, jc, jens, n_sample=CHAINS,
                                          experiments_root=jroot)
        key = jax.random.PRNGKey(tc.seed + 4)
        draws, order = [{}, {}], [[], []]

        def source(i):
            keys = JaxChainKeys(jax.random.fold_in(key, i), T)

            def recording(kind, t, shape, df=None):
                draws[i][kind, t, tuple(shape)] = keys(kind, t, shape)
                order[i].append((kind, t, tuple(shape)))
                return draws[i][kind, t, tuple(shape)]

            return recording

        with pytest.MonkeyPatch.context() as mp, \
                recorded_port_steps(mp) as steps, \
                contextlib.redirect_stdout(port_out):
            got = tais.eval_ais_ensemble(
                tds, tc, tens, n_sample=CHAINS, experiments_root=troot,
                noise=source, device="cpu")
        cache[vae_type] = dict(
            tc=tc, tds=tds, singles=singles, want=want, got=got,
            steps=steps, draws=draws, order=order, jroot=jroot, troot=troot,
            jax_out=jax_out.getvalue(), port_out=port_out.getvalue())
        return cache[vae_type]

    return run


@pytest.mark.parametrize("vae_type,extra", FAMILIES,
                         ids=[f for f, _ in FAMILIES])
def test_ensemble_matches_jax(ensembles, vae_type, extra):
    """Every replica's estimate and final chains, and every artifact
    (`<stage>_ais.pt{sfx}`, `<stage>_ais_true_latents.pt{sfx}`, 0-d float64
    and [B0, n, L] float32) and metric record, against JAX's ensemble."""
    run = ensembles(vae_type, extra)
    tc, want, got, steps = run["tc"], run["want"], run["got"], run["steps"]
    jroot, troot = run["jroot"], run["troot"]
    assert run["port_out"] == run["jax_out"]
    assert len(steps) == 2 * (T - 1)
    for prob, u, _ in steps:
        assert prob.shape == (S, ROWS * CHAINS)
        _assert_gaps(prob, u)
    assert sorted(got) == sorted(want) == ["test", "train"]
    for stage in got:
        assert got[stage].logw.dtype == np.float64
        assert got[stage].logw.shape == (S,)
        np.testing.assert_allclose(got[stage].logw, want[stage].logw,
                                   rtol=LOGW_RTOL)
        assert got[stage].latents.shape == (S, ROWS, CHAINS, L)
        np.testing.assert_allclose(got[stage].latents, want[stage].latents,
                                   rtol=0, atol=Z_ATOL)
    jtree, ttree = _tree(jroot), _tree(troot)
    assert sorted(ttree) == sorted(jtree) and len(ttree) == 4 * S
    assert any(rel.endswith("test_ais.pt.seed2") for rel in ttree)
    for rel, want_t in jtree.items():
        got_t = ttree[rel]
        assert got_t.dtype == want_t.dtype and got_t.shape == want_t.shape, rel
        torch.testing.assert_close(got_t, want_t, rtol=LOGW_RTOL, atol=Z_ATOL)

    def records(root):
        path = os.path.join(root, tc.experiment_type, tc.data_type,
                            "metrics.jsonl")
        return [json.loads(line) for line in open(path)]

    jrec, trec = records(jroot), records(troot)
    assert [(r["metric"], r["stage"]) for r in trec] == [
        (r["metric"], r["stage"]) for r in jrec] == [
        ("ais_logw", "train"), ("ais_logw", "test")]
    for a, b in zip(trec, jrec):
        np.testing.assert_allclose(a["value"], b["value"], rtol=LOGW_RTOL)


@pytest.mark.parametrize("vae_type,extra", FAMILIES,
                         ids=[f for f, _ in FAMILIES])
def test_each_replica_is_the_serial_eval_ais(ensembles, vae_type, extra):
    """Replica s of the fixture's ensemble is `eval_ais` of replica s's
    parameters: the same chains, drawn from the same per-split draws
    (JAX's, as the ensemble drew them), which the serial run asks for in
    the order and at the shapes the ensemble drew them: so under a
    stateful source, the default noise of every CLI run, both get the
    same values."""
    run = ensembles(vae_type, extra)
    tc, tds, ens, steps = run["tc"], run["tds"], run["got"], run["steps"]
    draws = run["draws"]

    for s, params in enumerate(run["singles"]):
        asked = [[], []]

        def source(i):
            def replay(kind, t, shape, df=None):
                asked[i].append((kind, t, tuple(shape)))
                return draws[i][asked[i][-1]]

            return replay

        serial = tais.eval_ais(tds, tc, params=params, n_sample=CHAINS,
                               noise=source, save=False, device="cpu")
        assert asked == run["order"], s
        for stage, res in serial.items():
            np.testing.assert_allclose(ens[stage].logw[s], res.logw,
                                       rtol=LOGW_RTOL, err_msg=stage)
            np.testing.assert_allclose(ens[stage].latents[s], res.latents,
                                       rtol=0, atol=Z_ATOL, err_msg=stage)
    for prob, u, _ in steps:
        _assert_gaps(prob, u)


def test_a_replica_under_the_default_noise_is_the_serial_eval_ais(
        monkeypatch):
    """Under the default noise (a stateful generator a split, as every CLI
    run draws) replica s of the gauss bridge's ensemble is `eval_ais` of
    replica s's parameters."""
    vae_type, extra = FAMILIES[0]
    _, tc, _, tens, singles = _stacked(vae_type, extra)
    _, tds = _datasets()
    with recorded_port_steps(monkeypatch) as steps:
        ens = tais.eval_ais_ensemble(tds, tc, tens, n_sample=CHAINS,
                                     save=False, device="cpu")
    for s, params in enumerate(singles):
        serial = tais.eval_ais(tds, tc, params=params, n_sample=CHAINS,
                               save=False, device="cpu")
        for stage, res in serial.items():
            np.testing.assert_allclose(ens[stage].logw[s], res.logw,
                                       rtol=LOGW_RTOL, err_msg=stage)
            np.testing.assert_allclose(ens[stage].latents[s], res.latents,
                                       rtol=0, atol=Z_ATOL, err_msg=stage)
    for prob, u, _ in steps:
        _assert_gaps(prob, u)


def test_mesh_raises_naming_its_slice():
    """Since slice 10 part 2 the ensemble's chains run on a mesh: on a
    one-device mesh it is the single-device run, bit for bit."""
    from torch_dist_worker import one_rank_mesh

    _, tc, _, tens, _ = _stacked("reg_vae1", {})
    _, tds = _datasets()
    sched = tais.linear_schedule(3)
    plain = tais.eval_ais_ensemble(tds, tc, tens, schedule=sched,
                                   n_sample=2, save=False, device="cpu")
    with one_rank_mesh() as mesh:
        meshed = tais.eval_ais_ensemble(tds, tc, tens, schedule=sched,
                                        n_sample=2, save=False, mesh=mesh,
                                        device="cpu")
    for stage, res in plain.items():
        np.testing.assert_array_equal(res.logw, meshed[stage].logw)
        np.testing.assert_array_equal(res.latents, meshed[stage].latents)


@pytest.mark.parametrize("flags", [[], ["-bdmc", "true"]],
                         ids=["seeds", "seeds-bdmc"])
def test_entry_point_seeds_prints_jax_lines_and_writes_seed_files(
        tmp_path, monkeypatch, capsys, flags):
    """`ais_eval -seeds 2` over record 34 (linear T=3, 2 chains a row) and
    its two seed checkpoints: the port and JAX print the same lines, each
    port value its artifact's, write the same files (`.seed1` included),
    and under `-bdmc true` both skip BDMC with JAX's line."""
    import importlib

    record = _record(34, n_ais_dist=3, n_ais_iwae=2)
    cfg = tcfg.RunConfig.from_jsonl_record(record)
    port_dir = _workdir(tmp_path / "port", [record], [cfg])
    path = tckpt.checkpoint_path(cfg, str(port_dir / "experiments"))
    tckpt.save(get_model(cfg).init(torch.Generator().manual_seed(2), cfg, 13,
                                   device="cpu"), path + ".seed1")
    jax_dir = tmp_path / "jax"
    shutil.copytree(port_dir, jax_dir)
    argv = ["-seeds", "2", *flags]
    monkeypatch.chdir(port_dir)
    assert ais_eval.main(["-device", "cpu", *argv]) == 0
    port_out = capsys.readouterr().out
    jmod = importlib.import_module("experiment_main.ais_eval")
    monkeypatch.setattr(jmod, "apply_rng_impl", lambda c: None)
    monkeypatch.setattr("sys.argv", ["ais_eval.py", *argv])
    monkeypatch.chdir(jax_dir)
    jmod.main()
    jax_out = capsys.readouterr().out

    def shape(out):
        return [re.sub(r"-?\d+\.\d+", "#", ln) for ln in out.splitlines()
                if ln.startswith("  ")]

    assert shape(port_out) == shape(jax_out)
    assert len(shape(port_out)) == 2 + bool(flags)
    base = os.path.join("experiments", "reg_vae1", "wine", "elbos",
                        "30_missing", "3000_epochs")
    for ln in port_out.splitlines():
        m = re.fullmatch(r"  \[(\w+)\] AIS log p\(x\) = (\S+)±(\S+)  "
                         r"s0=(\S+) s1=(\S+)", ln)
        if m is None:
            continue
        stage, vals = m.group(1), [float(v) for v in m.group(4, 5)]
        for s, v in enumerate(vals):
            saved = torch.load(os.path.join(
                str(port_dir), base, f"{stage}_ais.pt"
                + ("" if s == 0 else ".seed1")), weights_only=False)
            assert saved.dtype == torch.float64 and saved.dim() == 0
            assert f"{saved.item():.4f}" == f"{v:.4f}"
    if flags:
        assert ("  [bdmc] skipped: -bdmc certifies one checkpoint's "
                "schedule; run it without -seeds") in port_out
    assert sorted(_tree(str(port_dir / "experiments"))) == sorted(
        _tree(str(jax_dir / "experiments")))
