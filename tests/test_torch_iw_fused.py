"""IW1 (`ops/fused_iw`, `csrc/iw_decode.cu`): MIWAE's importance-weighted
evaluation step in one call (the encoder, the per-sample terms and the
reductions over K), and the rule by which `models/miwae.eval_step` takes it.

On the CPU: the plain version is the eager composition (`forward`,
`_branch_terms` and the reductions `eval_step` took before IW1 held them)
to the bit, `eval_step` through IW1 equals it, the rule sends gradients and
bf16 to the eager path, and a replica axis or a vmapped call is the serial
calls. The tests marked `cuda` hold the kernel against the plain version on
the card, its bits from run to run and its device operations a step. This
file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_iw_fused.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.data.loaders import Dataset, Split
from vae_posterior_consistency_tpu_torch.engine import checkpoint, evaluate
from vae_posterior_consistency_tpu_torch.models import get_model, miwae
from vae_posterior_consistency_tpu_torch.nn import core
from vae_posterior_consistency_tpu_torch.ops import _kernel
from vae_posterior_consistency_tpu_torch.ops import fused_iw
from vae_posterior_consistency_tpu_torch.ops.math import (
    kl_diag_diag_scale_elems,
    normal_logpdf_scale,
    std_normal_logpdf,
)
from vae_posterior_consistency_tpu_torch.utils import tracing

TYPES = ("vanilla_MIWAE1", "reg_MIWAE1")


def _case(vae_type, B, K, D=13, L=10, seed=0, device="cpu"):
    """(cfg, params, x, mask, mask_p, eps) at the wine width: seeded
    parameters (torch's Linear init), rows in [0, 1), 70% observed."""
    cfg = RunConfig(vae_type=vae_type, latent_dim=L, valid_k=K)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = get_model(cfg).init(gen, cfg, D, device=device)
    rng = np.random.default_rng(seed + 1)
    x = rng.uniform(0.0, 1.0, (B, D))
    mask = rng.random((B, D)) < 0.7
    mask_p = mask * (rng.random((B, D)) < 0.7)
    eps = rng.standard_normal(miwae.eval_noise(cfg, B, D)["eps"])
    x, mask, mask_p, eps = (torch.tensor(a, dtype=torch.float32,
                                         device=device)
                            for a in (x, mask, mask_p, eps))
    return cfg, params, x, mask, mask_p, eps


def _stream(cfg, x, mask, mask_p, eps):
    """IW1's rows for the model's stream: the stacked q and p rows of a
    regularized type (extra on the q rows), the rows themselves else:
    (x, mask, extra, eps)."""
    B = x.shape[0]
    if not cfg.info.regularized:
        return x, mask, None, eps
    return (torch.cat([x, x]), torch.cat([mask, mask_p]),
            mask * (1.0 - mask_p), eps.reshape(2 * B, *eps.shape[2:]))


def _call(cfg, params, x, mask, mask_p, eps):
    """iw_fused on the model's stream."""
    return fused_iw.iw_fused(*_stream(cfg, x, mask, mask_p, eps),
                             params["encoder"], params["decoder"],
                             miwae.NEGL_DIVISOR)


def _before(params, x, mask, mask_p, eps, cfg):
    """`eval_step`'s eager composition as it stood before IW1 took the
    encoder and the reductions over K: `forward` and `_branch_terms` on the
    stream, then the weights, the bounds and the sums over K of the q rows
    (and, for a regularized type, of the p rows) taken apart."""
    B = x.shape[0]
    xs, ms, extra, es = _stream(cfg, x, mask, mask_p, eps)
    out = miwae.forward(params, xs, ms, es, cfg)
    _, log_w, logpx_imp, log_pxz = miwae._branch_terms(out, xs, ms)
    xm = torch.einsum("bk,bkd->bd", torch.softmax(log_w[:B], dim=1),
                      out["x_mean"][:B])
    if not cfg.info.regularized:
        row_negl = torch.sum(logpx_imp, dim=1) / miwae.NEGL_DIVISOR
        return {"x_imputed": xm,
                "row_loss": -torch.logsumexp(log_w, dim=1),
                "row_negl": row_negl, "row_negl_imp": row_negl}
    q = -torch.logsumexp(log_w[:B], dim=1)
    p = -torch.logsumexp(log_w[B:], dim=1)
    reg_like = torch.mean(torch.sum(log_pxz[:B] * extra[:, None, :], dim=-1),
                          dim=1)
    mean, scale = out["mean"], out["scale"]
    kl = torch.mean(kl_diag_diag_scale_elems(mean[:B], scale[:B], mean[B:],
                                             scale[B:]), dim=-1)
    row_loss = q + cfg.alpha * (kl - q + p - reg_like)
    return {"x_imputed": xm, "row_loss": row_loss, "row_negl": row_loss,
            "row_negl_imp": row_loss}


def _eager(monkeypatch):
    """`eval_step` as it was before IW1: forward and _branch_terms."""
    monkeypatch.setattr(miwae, "_fused", lambda: False)


def _recorded_counts(fn):
    """fn() under a CPU profiler (the tracer records only then): (its
    result, {counter: total})."""
    tracing.take()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    totals = {}
    for r in tracing.take():
        if isinstance(r, tracing.Count):
            totals[r.name] = totals.get(r.name, 0) + r.n
    return out, totals


# -- the plain version is the eager composition ------------------------------

#: (B, K, D): one row, the wine test split's 17 and a full batch of 64; K
#: below a tile, across tiles and the grid's 5000, none a multiple of 64;
#: the wine width and one past a chunk of the head's features
PLAIN_CASES = [(1, 7, 13), (17, 7, 13), (64, 100, 13), (17, 5000, 13),
               (64, 5000, 13), (17, 300, 30)]


@pytest.mark.parametrize("B,K,D", PLAIN_CASES)
@pytest.mark.parametrize("vae_type", TYPES)
def test_the_plain_version_is_the_eager_composition(vae_type, B, K, D):
    """Every output to the bit: the per-sample terms (x_mean, logpxobs,
    logpx_imp, log p(z), log q, log_w assembled from them, the sum under
    `extra` on the q rows and 0 on the p rows) against `forward` and
    `_branch_terms`; then IW1's outputs against the composition `eval_step`
    ran before IW1 held the reductions: the q rows' imputation, each row's
    -logsumexp, the sum of logpx_imp over 5000, the mean under `extra`, and
    the encoder's mean and scale."""
    cfg, params, *batch = _case(vae_type, B, K, D=D)
    x, mask, extra, eps = _stream(cfg, *batch)
    with torch.no_grad():
        x_imputed, per_row, mean, scale = _call(cfg, params, *batch)
        out = miwae.forward(params, x, mask, eps, cfg)
        logpxobs, log_w, logpx_imp, log_pxz = miwae._branch_terms(out, x,
                                                                  mask)
        x_mean, terms = fused_iw.sample_terms(x, mask, extra, out["mean"],
                                              out["scale"], eps,
                                              params["decoder"])
        want = _before(params, *batch, cfg)
    N = x.shape[0]
    assert terms.shape == (4 if extra is None else 5, N, K)
    assert torch.equal(x_mean, out["x_mean"])
    assert torch.equal(terms[0], logpxobs)
    assert torch.equal(terms[1], logpx_imp)
    assert torch.equal(terms[2], torch.sum(std_normal_logpdf(out["z"]), -1))
    assert torch.equal(terms[3], torch.sum(normal_logpdf_scale(
        out["z"], out["mean"][:, None, :], out["scale"][:, None, :]), -1))
    assert torch.equal(terms[0] + terms[2] - terms[3], log_w)
    assert x_imputed.shape == (N, D) and per_row.shape == (3, N)
    assert torch.equal(x_imputed[:B], want["x_imputed"])
    assert torch.equal(mean, out["mean"]) and torch.equal(scale, out["scale"])
    assert torch.equal(per_row[0], -torch.logsumexp(log_w, dim=1))
    assert torch.equal(per_row[1], torch.sum(logpx_imp, dim=1)
                       / miwae.NEGL_DIVISOR)
    if extra is None:
        assert torch.equal(per_row[0], want["row_loss"])
        assert torch.equal(per_row[1], want["row_negl"])
        assert not per_row[2].any()
    else:
        assert torch.equal(terms[4, :B], miwae._extra_sum(log_pxz, extra))
        assert not terms[4, B:].any()
        assert torch.equal(per_row[2, :B], torch.mean(
            miwae._extra_sum(log_pxz, extra), dim=1))
        assert not per_row[2, B:].any()


# -- eval_step through IW1 ----------------------------------------------------

@pytest.mark.parametrize("B,K,D", [(1, 7, 13), (17, 7, 13), (64, 50, 13),
                                   (17, 9, 30)])
@pytest.mark.parametrize("vae_type", TYPES)
def test_eval_step_through_iw1_equals_the_eager_composition(
        vae_type, B, K, D, monkeypatch):
    """`eval_step` through IW1, its eager path and the composition it ran
    before IW1 held the encoder and the reductions, to the bit; one IW1
    call counts its samples, and no rows of its own."""
    cfg, params, x, mask, mask_p, eps = _case(vae_type, B, K, D=D)
    step = get_model(cfg).eval_step
    with torch.no_grad():
        got, counts = _recorded_counts(
            lambda: step(params, x, mask, mask_p, eps, cfg))
        before = _before(params, x, mask, mask_p, eps, cfg)
        _eager(monkeypatch)
        want = step(params, x, mask, mask_p, eps, cfg)
    assert sorted(got) == sorted(want) == sorted(before) == [
        "row_loss", "row_negl", "row_negl_imp", "x_imputed"]
    for name in want:
        assert torch.equal(got[name], want[name]), name
        assert torch.equal(got[name], before[name]), name
    streams = 2 if cfg.info.regularized else 1
    assert counts["iw_fused_samples"] == counts["iw_samples"] == (
        streams * B * K)
    assert "iw_fused_rows" not in counts


# -- the rule: who runs IW1 ---------------------------------------------------

@pytest.mark.parametrize("mode", ["grad", "bf16", "no_grad"])
@pytest.mark.parametrize("vae_type", TYPES)
def test_gradients_and_bf16_take_the_eager_path(vae_type, mode,
                                                monkeypatch):
    """With gradients enabled, or under compute_dtype('bfloat16'), the
    step runs `forward` and `_branch_terms` and counts no
    `iw_fused_samples`; without gradients in float32 it counts B x K a
    stream."""
    B, K = 9, 11
    cfg, params, x, mask, mask_p, eps = _case(vae_type, B, K)
    if mode == "bf16":
        cfg = cfg.replace(compute_dtype="bfloat16")
    step = get_model(cfg).eval_step
    calls = []
    forward = miwae.forward
    monkeypatch.setattr(miwae, "forward",
                        lambda *a: calls.append(1) or forward(*a))
    grad = torch.enable_grad() if mode == "grad" else torch.no_grad()
    with grad:
        got, counts = _recorded_counts(
            lambda: step(params, x, mask, mask_p, eps, cfg))
    samples = (2 if cfg.info.regularized else 1) * B * K
    assert counts["iw_samples"] == samples
    if mode == "no_grad":
        assert counts["iw_fused_samples"] == samples and not calls
    else:
        assert "iw_fused_samples" not in counts and calls == [1]
        assert "iw_fused_rows" not in counts
        with torch.no_grad(), core.compute_dtype(
                "bfloat16" if mode == "bf16" else "float32"):
            monkeypatch.setattr(miwae, "forward", forward)
            _eager(monkeypatch)
            want = miwae.eval_step(params, x, mask, mask_p, eps, cfg)
        for name in want:
            assert torch.equal(got[name].detach(), want[name]), name


def test_training_runs_the_eager_composition():
    cfg, params, x, mask, mask_p, eps = _case("reg_MIWAE1", 6, 5)
    _, counts = _recorded_counts(lambda: get_model(cfg).train_loss(
        params, x, mask, mask_p, eps, 1.0, cfg))
    assert counts["iw_samples"] == 2 * 6 * 5
    assert "iw_fused_samples" not in counts
    assert "iw_fused_rows" not in counts


@pytest.mark.parametrize("network", ["encoder", "decoder"])
def test_iw1_refuses_gradients(network):
    cfg, params, *batch = _case("vanilla_MIWAE1", 3, 4)
    leaf = params[network]["layer1"]["w"].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        _call(cfg, params, *batch)
    with torch.no_grad():
        _call(cfg, params, *batch)
    leaf.requires_grad_(False)


# -- ensembles: vmap ----------------------------------------------------------

def _two_replicas(vae_type, B, K):
    cfg, p0, x, mask, mask_p, eps = _case(vae_type, B, K, seed=0)
    _, p1, *_ = _case(vae_type, B, K, seed=1)
    flat = [checkpoint.flatten(p) for p in (p0, p1)]
    stacked = checkpoint.unflatten({k: torch.stack([f[k] for f in flat])
                                    for k in flat[0]})
    return cfg, (p0, p1), stacked, x, mask, mask_p, eps


@pytest.mark.parametrize("vae_type", TYPES)
def test_a_vmapped_eval_step_is_two_serial_calls(vae_type):
    """Two replicas' parameters vmapped, the rows and draws shared, as
    `engine/evaluate._chunked` runs an ensemble: IW1's vmap rule folds the
    replicas into one call, and each replica's rows equal its serial
    call's, to the bit (the encoder runs inside the call, a replica at a
    time on the CPU)."""
    B, K = 7, 9
    cfg, serial, stacked, x, mask, mask_p, eps = _two_replicas(vae_type, B,
                                                               K)
    step = get_model(cfg).eval_step

    def one(p, x, mask, mask_p):
        return step(p, x, mask, mask_p, eps, cfg)

    p_mask = mask_p if cfg.info.regularized else None
    with torch.no_grad():
        got, counts = _recorded_counts(lambda: torch.func.vmap(
            one, in_dims=(0, None, None, None))(stacked, x, mask, p_mask))
        want = [step(p, x, mask, p_mask, eps, cfg) for p in serial]
    streams = 2 if cfg.info.regularized else 1
    assert counts["iw_fused_samples"] == streams * B * K
    assert "iw_fused_rows" not in counts
    for name in want[0]:
        for r in range(2):
            assert torch.equal(got[name][r], want[r][name]), name


def _replica_call(cfg, stacked, batch, how):
    """IW1 on two replicas' networks over shared rows: vmapped, or called
    with the replica axis on every input."""
    def call(enc, dec, *rows):
        return fused_iw.iw_fused(*rows, enc, dec, miwae.NEGL_DIVISOR)

    rows = _stream(cfg, *batch)
    if how == "vmap":
        return torch.func.vmap(call, in_dims=(0, 0, None, None, None, None))(
            stacked["encoder"], stacked["decoder"], *rows)
    return call(stacked["encoder"], stacked["decoder"],
                *(None if t is None else t.expand(2, *t.shape)
                  for t in rows))


@pytest.mark.parametrize("how", ["vmap", "replica_axis"])
@pytest.mark.parametrize("vae_type", TYPES)
def test_a_vmapped_iw1_call_is_the_serial_calls_bit_for_bit(vae_type, how):
    cfg, serial, stacked, *batch = _two_replicas(vae_type, 5, 6)
    with torch.no_grad():
        got = _replica_call(cfg, stacked, batch, how)
        for r, p in enumerate(serial):
            want = _call(cfg, p, *batch)
            assert all(torch.equal(g[r], w) for g, w in zip(got, want))


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: IW1 against its plain version on the card. Both compute in float32 from
#: the same inputs; the kernel sums each 128-term product in its own order
#: (cuBLAS in another), and its sums over D, L and K too. Relative gaps of
#: 1e-7 a term carry through sigmoid, the log-density and the weights:
#: x_imputed (a convex combination of locations in [0, 1]) within
#: X_MEAN_ATOL, every other output (magnitudes about 0.1-100) within
#: TERMS_RTOL of its size, or TERMS_ATOL near zero.
X_MEAN_ATOL = 2e-6
TERMS_RTOL = 2e-5
TERMS_ATOL = 5e-5

#: cuGraphNodeType of a kernel, a copy and a fill
_OP_NODES = (0, 1, 2)


def _assert_iw1_matches_plain(cfg, params, batch):
    got = _call(cfg, params, *batch)
    torch.cuda.synchronize()
    leaves = (*fused_iw.mlp_leaves(params["encoder"]),
              *fused_iw.mlp_leaves(params["decoder"]))
    x, mask, extra, eps = _stream(cfg, *batch)
    want = fused_iw.iw_fused_reference(x, mask, extra, eps,
                                       miwae.NEGL_DIVISOR, *leaves)
    gaps = [((g - w).abs() / (w.abs() + 1.0)).max().item()
            for g, w in zip(got, want)]
    print("relative gaps x_imputed, per_row, mean, scale:",
          ", ".join(f"{v:.3e}" for v in gaps))
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=X_MEAN_ATOL)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=TERMS_RTOL, atol=TERMS_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,D,L", [
    (64, 5000, 13, 10), (17, 5000, 13, 10), (1, 5000, 13, 10),
    (3, 7, 13, 10), (5, 41, 30, 4), (2, 300, 784, 10), (2, 5000, 784, 10),
    (9, 129, 1, 32), (64, 1, 13, 10)])
@pytest.mark.parametrize("vae_type", TYPES)
def test_iw1_matches_its_plain_version_on_the_card(cuda, vae_type, B, K, D,
                                                   L):
    """The cell's shapes (64 and 17 rows at K = 5000), one row, ragged
    tiles, tiles of many rows (K = 1), more than one chunk of features
    (D = 30, 784), rows whose partial sums outgrow the merging block's
    shared memory (D = 784 at K = 5000), one feature, L = 4 and 32; one
    call each."""
    cfg, params, *batch = _case(vae_type, B, K, D=D, L=L, device=cuda)
    with torch.no_grad():
        before = _kernel.launches["iw_fused"]
        _assert_iw1_matches_plain(cfg, params, batch)
    assert _kernel.launches["iw_fused"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,D", [(64, 5000, 13), (5, 300, 30)])
@pytest.mark.parametrize("vae_type", TYPES)
def test_iw1_gives_the_same_bits_twice(cuda, vae_type, B, K, D):
    """Its sums run in an order the shapes fix, whichever block merges."""
    cfg, params, *batch = _case(vae_type, B, K, D=D, device=cuda)
    with torch.no_grad():
        first = _call(cfg, params, *batch)
        second = _call(cfg, params, *batch)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _graph_ops(fn):
    """The kernel, copy and fill nodes of a CUDA graph captured from one
    call of fn (as `chip_smoke.device_ops` counts them)."""
    import ctypes

    libcuda = ctypes.CDLL("libcuda.so.1")
    stream = torch.cuda.Stream()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert libcuda.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert libcuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        assert libcuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                          ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    graph.reset()
    return sum(k in _OP_NODES for k in kinds)


@pytest.mark.cuda
def test_a_vanilla_eval_step_is_two_device_operations(cuda):
    """One IW1 call (the encoder's launch, then the body's) and nothing
    else: no eager encoder, weights or sums around it."""
    cfg, params, x, mask, mask_p, eps = _case("vanilla_MIWAE1", 64, 5000,
                                              device=cuda)
    step = get_model(cfg).eval_step
    with torch.no_grad():
        step(params, x, mask, mask_p, eps, cfg)  # binds the kernel
        before = _kernel.launches["iw_fused"]
        step(params, x, mask, mask_p, eps, cfg)
        assert _kernel.launches["iw_fused"] == before + 1
        assert _graph_ops(lambda: step(params, x, mask, mask_p, eps,
                                       cfg)) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["vmap", "replica_axis"])
def test_iw1_replicas_in_one_launch(cuda, how):
    """Two replicas vmapped, or on a replica axis, with the rows and the
    noise shared: one call, each replica bit for bit its own call."""
    cfg, serial, stacked, *batch = _two_replicas("reg_MIWAE1", 64, 500)
    batch = [t.to(cuda) for t in batch]
    serial = [checkpoint.on_device(p, cuda) for p in serial]
    stacked = checkpoint.on_device(stacked, cuda)
    with torch.no_grad():
        before = _kernel.launches["iw_fused"]
        got = _replica_call(cfg, stacked, batch, how)
        assert _kernel.launches["iw_fused"] == before + 1
        for r, p in enumerate(serial):
            want = _call(cfg, p, *batch)
            assert all(torch.equal(g[r], w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("vae_type", TYPES)
def test_one_launch_a_stream_a_batch(cuda, vae_type):
    """eval_vae calls IW1 once a batch (a regularized type's q and p
    branches are one stacked stream), as B1 and B2f count theirs."""
    cfg = RunConfig(vae_type=vae_type, latent_dim=10, valid_k=300, M=1,
                    batch_size=64, missing_rate=30, seed=3)
    rng = np.random.default_rng(5)

    def split(n, stage):
        x = torch.tensor(rng.uniform(0.0, 1.0, (n, 13)), dtype=torch.float32)
        m = torch.tensor(rng.random((n, 13)) < 0.7, dtype=torch.float32)
        return Split(x, m, stage)

    ds = Dataset(split(150, "train"), split(17, "test"), 13)
    params = get_model(cfg).init(torch.Generator(device=cuda).manual_seed(1),
                                 cfg, 13, device=cuda)
    before = _kernel.launches["iw_fused"]
    res = evaluate.eval_vae(ds, cfg, params=params, save=False, device=cuda)
    batches = 3 + 1  # under _GRAPH_MIN_STEPS a split: every batch eager
    assert _kernel.launches["iw_fused"] == before + batches
    assert all(np.isfinite(v) for s in res.values() for v in s.values())
