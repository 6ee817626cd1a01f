"""The evaluator's captured CUDA graph (`engine/evaluate._BatchGraph`): on a
CUDA device a split of at least `_GRAPH_MIN_STEPS` batches replays one
captured `_batch_stats` for each batch. The tests marked `cuda` hold the
replayed path against the eager one on the card, from the same draws; the
others hold the decision and the CPU path, which stays eager. This file
imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_eval_graph.py -m cuda --noconftest
"""

import math

import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.data.loaders import Dataset, Split
from vae_posterior_consistency_tpu_torch.engine import evaluate
from vae_posterior_consistency_tpu_torch.engine.train import draw
from vae_posterior_consistency_tpu_torch.models import get_model
from vae_posterior_consistency_tpu_torch.utils import debugging, tracing

KINDS = ("perm", "mask_p", "eps")
COUNTERS = ("eval_eager_batches", "eval_graph_captures",
            "eval_graph_replays")

#: the families and widths the card's tests evaluate: gauss EDDI at the
#: MNIST width and the gauss VAE, a flow, a regularized MIWAE (fresh
#: mask_p, two eps branches) and a notMIWAE at a small valid_k, gauss
#: EDDI in bf16, and a vanilla MIWAE at the grid's valid_k (IW1 at 320,000
#: samples a batch)
CASES = {
    "reg_EDDI1_784": dict(vae_type="reg_EDDI1", data_type="mnist", D=784),
    "reg_vae1": dict(vae_type="reg_vae1", D=13),
    "reg_flow1": dict(vae_type="reg_flow1", D=13),
    "reg_MIWAE1": dict(vae_type="reg_MIWAE1", valid_k=20, D=13),
    "vanilla_notMIWAE1": dict(vae_type="vanilla_notMIWAE1", valid_k=20,
                              D=13),
    "reg_EDDI1_784_bf16": dict(vae_type="reg_EDDI1", data_type="mnist",
                               D=784, compute_dtype="bfloat16"),
    "vanilla_MIWAE1_k5000": dict(vae_type="vanilla_MIWAE1", valid_k=5000,
                                 D=13),
}


class Draws:
    """Noise keyed by (kind, rep, step) alone: every run, and both splits,
    draw the same; `calls` lists each call in its order."""

    def __init__(self, seed, device):
        self.seed, self.device, self.calls = seed, device, []

    def __call__(self, kind, rep, step, shape):
        self.calls.append((kind, rep, step, tuple(shape)))
        key = ((self.seed * 7 + KINDS.index(kind)) * 1009 + rep) * 100_003
        gen = torch.Generator(device=self.device).manual_seed(key + step)
        return draw(gen, kind, shape, self.device)


def _case(name, M=2, n_train=300, n_test=100, **over):
    spec = {**CASES[name], **over}
    D = spec.pop("D")
    cfg = RunConfig(missing_rate=30, seed=3, M=M, batch_size=64, **spec)
    rng = np.random.default_rng(5)

    def split(n, stage):
        x = rng.uniform(0.0, 1.0, (n, D)).astype(np.float32)
        m = (rng.random((n, D)) < 0.7).astype(np.float32)
        return Split(torch.from_numpy(x), torch.from_numpy(m), stage)

    return cfg, Dataset(split(n_train, "train"), split(n_test, "test"), D)


def _params(cfg, D, device):
    gen = torch.Generator(device=device).manual_seed(11)
    return get_model(cfg).init(gen, cfg, D, device=device)


def _run(ds, cfg, params, device, noise=None):
    """eval_vae under a torch profiler (the tracer records only then):
    (results, {counter: total})."""
    tracing.take()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        res = evaluate.eval_vae(ds, cfg, params=params, save=False,
                                noise=noise or Draws(1, device),
                                device=device)
    totals = dict.fromkeys(COUNTERS, 0)
    for r in tracing.take():
        if isinstance(r, tracing.Count) and r.name in totals:
            totals[r.name] += r.n
    return res, totals


def _batches(ds, cfg):
    return sum(cfg.M * math.ceil(s.n / min(cfg.batch_size, s.n))
               for s in (ds.train, ds.test))


# -- the decision and the CPU path (run everywhere) -------------------------

@pytest.mark.parametrize("device,batches,want", [
    ("cpu", 1, False), ("cpu", 10**6, False),
    ("cuda", 1, False), ("cuda", evaluate._GRAPH_MIN_STEPS - 1, False),
    ("cuda", evaluate._GRAPH_MIN_STEPS, True), ("cuda", 10**6, True)])
def test_the_graph_engages_on_a_cuda_device_from_min_steps(device, batches,
                                                          want):
    assert evaluate._use_graph(torch.device(device), batches) is want


def test_no_graph_while_a_dispatch_mode_is_pushed():
    """The NaN tripwire reads each operator's output back: no capture
    under it, however many batches."""
    debugging.enable_nan_debugging(True)
    try:
        assert not evaluate._use_graph(torch.device("cuda"), 10**6)
    finally:
        debugging.enable_nan_debugging(False)
    assert evaluate._use_graph(torch.device("cuda"), 10**6)


def test_the_cell_shape_engages():
    """70,000 MNIST rows in batches of 64 at M=1: 938 and 157 batches."""
    assert evaluate._use_graph(torch.device("cuda"), 157)


@pytest.mark.parametrize("name", ["reg_EDDI1_784", "reg_vae1", "reg_flow1",
                                  "reg_MIWAE1", "vanilla_notMIWAE1"])
def test_the_cpu_path_runs_every_batch_eagerly(name):
    cfg, ds = _case(name, M=3, n_train=70, n_test=20)
    cfg = cfg.replace(valid_k=min(cfg.valid_k, 5))
    res, counts = _run(ds, cfg, _params(cfg, ds.obs_dim, "cpu"), "cpu")
    assert counts == {"eval_eager_batches": _batches(ds, cfg),
                      "eval_graph_captures": 0, "eval_graph_replays": 0}
    assert all(np.isfinite(v) for s in res.values() for v in s.values())


# -- the replayed path on the card -------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph path runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _graph_and_eager(monkeypatch, ds, cfg, params, device):
    """(graph results, its counters, its draws, eager results, its draws),
    the graph engaged at any batch count, then at none."""
    monkeypatch.setattr(evaluate, "_GRAPH_MIN_STEPS", 1)
    g_noise = Draws(1, device)
    got, counts = _run(ds, cfg, params, device, g_noise)
    monkeypatch.setattr(evaluate, "_GRAPH_MIN_STEPS", 10**9)
    e_noise = Draws(1, device)
    want, eager_counts = _run(ds, cfg, params, device, e_noise)
    assert eager_counts["eval_eager_batches"] == _batches(ds, cfg)
    return got, counts, g_noise.calls, want, e_noise.calls


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_replayed_batches_equal_eager_ones(cuda, monkeypatch, name):
    """The replay runs the kernels the eager batch runs, in its order, on
    copies of the same inputs, so the eight means agree bit for bit (no
    tolerance: a difference would be a different kernel or order, which
    the port does not allow here)."""
    cfg, ds = _case(name)
    params = _params(cfg, ds.obs_dim, cuda)
    got, counts, g_calls, want, e_calls = _graph_and_eager(
        monkeypatch, ds, cfg, params, cuda)
    assert got == want
    assert all(np.isfinite(v) for s in got.values() for v in s.values())
    # one capture, shared by both splits (64-row batches in both)
    assert counts == {"eval_eager_batches": 1, "eval_graph_captures": 1,
                      "eval_graph_replays": _batches(ds, cfg) - 1}
    assert g_calls == e_calls


@pytest.mark.cuda
def test_the_draws_are_made_once_a_batch_in_order(cuda, monkeypatch):
    cfg, ds = _case("reg_MIWAE1", M=3, n_train=150, n_test=40)
    params = _params(cfg, ds.obs_dim, cuda)
    *_, g_calls, _, e_calls = _graph_and_eager(monkeypatch, ds, cfg, params,
                                               cuda)
    want = []
    for split in (ds.train, ds.test):
        bsz = min(64, split.n)
        for m in range(cfg.M):
            want.append(("perm", m, 0, (split.n,)))
            for s in range(math.ceil(split.n / bsz)):
                want += [("mask_p", m, s, (bsz, ds.obs_dim)),
                         ("eps", m, s, (2, bsz, cfg.valid_k,
                                        cfg.latent_dim))]
    assert g_calls == e_calls == want


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["reg_EDDI1_784", "reg_MIWAE1"])
def test_splits_of_other_batch_sizes_capture_their_own(cuda, monkeypatch,
                                                        name):
    """Train: 130 rows, 3 batches of 64 with 62 rows wrap-padded; test: 17
    rows, one batch of 17 (under the batch size)."""
    cfg, ds = _case(name, M=4, n_train=130, n_test=17)
    params = _params(cfg, ds.obs_dim, cuda)
    got, counts, g_calls, want, e_calls = _graph_and_eager(
        monkeypatch, ds, cfg, params, cuda)
    assert got == want and g_calls == e_calls
    assert counts == {"eval_eager_batches": 2, "eval_graph_captures": 2,
                      "eval_graph_replays": _batches(ds, cfg) - 2}


@pytest.mark.cuda
def test_nan_parameters_give_nan(cuda, monkeypatch):
    cfg, ds = _case("reg_EDDI1_784")
    params = _params(cfg, ds.obs_dim, cuda)
    leaf = params["decoder"]
    while isinstance(leaf, dict):
        leaf = leaf[sorted(leaf)[0]]
    leaf.fill_(float("nan"))
    monkeypatch.setattr(evaluate, "_GRAPH_MIN_STEPS", 1)
    res, counts = _run(ds, cfg, params, cuda)
    assert counts["eval_graph_replays"] == _batches(ds, cfg) - 1
    assert all(np.isnan(v) for s in res.values() for v in s.values())


@pytest.mark.cuda
def test_a_patched_batch_stats_is_what_the_graph_replays(cuda, monkeypatch):
    cfg, ds = _case("reg_EDDI1_784")
    params = _params(cfg, ds.obs_dim, cuda)
    monkeypatch.setattr(evaluate, "_GRAPH_MIN_STEPS", 10**9)
    want, _ = _run(ds, cfg, params, cuda)
    real, calls = evaluate._batch_stats, []

    def doubled(*args):
        calls.append(1)
        return 2.0 * real(*args)

    monkeypatch.setattr(evaluate, "_batch_stats", doubled)
    monkeypatch.setattr(evaluate, "_GRAPH_MIN_STEPS", 1)
    got, counts = _run(ds, cfg, params, cuda)
    assert len(calls) == 2  # the warm-up and the capture
    assert counts["eval_graph_replays"] == _batches(ds, cfg) - 1
    assert got == {st: {k: 2.0 * v for k, v in m.items()}
                   for st, m in want.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["reg_EDDI1_784", "reg_flow1"])
def test_the_fixed_phases_of_the_graph_path(cuda, monkeypatch, name):
    """Two calls of two batch shapes each (train: batches of 64; test: one
    of 17 rows): in each call, each shape's first batch records one
    `eval.warmup` and then one `eval.capture`, siblings inside that
    `eval.batch`; the call records one `eval.release`, the last span under
    its root."""
    cfg, ds = _case(name, M=4, n_train=130, n_test=17)
    params = _params(cfg, ds.obs_dim, cuda)
    monkeypatch.setattr(evaluate, "_GRAPH_MIN_STEPS", 1)
    tracing.take()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            evaluate.eval_vae(ds, cfg, params=params, save=False,
                              noise=Draws(1, cuda), device=cuda)
    recs = [r for r in tracing.take() if isinstance(r, tracing.Span)]
    roots = [s for s in recs if s.name == "eval_vae"]
    assert len(roots) == 2
    for root in roots:
        mine = [s for s in recs if s.root == root.id]
        batches = {s.id for s in mine if s.name == "eval.batch"}
        warm = sorted((s for s in mine if s.name == "eval.warmup"),
                      key=lambda s: s.start_ns)
        capture = sorted((s for s in mine if s.name == "eval.capture"),
                         key=lambda s: s.start_ns)
        assert len(warm) == len(capture) == 2
        for w, c in zip(warm, capture):
            assert w.parent == c.parent and w.parent in batches
            assert w.end_ns <= c.start_ns
        (release,) = [s for s in mine if s.name == "eval.release"]
        assert release.parent == root.id
        assert max(s.end_ns for s in mine if s is not root) == (
            release.end_ns) <= root.end_ns


@pytest.mark.cuda
def test_no_memory_outlives_the_call(cuda, monkeypatch):
    cfg, ds = _case("reg_EDDI1_784")
    params = _params(cfg, ds.obs_dim, cuda)
    monkeypatch.setattr(evaluate, "_GRAPH_MIN_STEPS", 1)
    _run(ds, cfg, params, cuda)  # the capture stream's cuBLAS workspace
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    _, counts = _run(ds, cfg, params, cuda)
    torch.cuda.synchronize()
    assert counts["eval_graph_captures"] == 1
    assert torch.cuda.memory_allocated() == before
