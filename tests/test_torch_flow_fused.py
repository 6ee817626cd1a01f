"""F1 (`ops/fused_flow`, `csrc/flow_spline.cu`): the flow posterior's three
spline layers in one call, and the rule by which `nn/flow.flow_forward`
takes it.

On the CPU: the plain version is the eager stack of `flow_forward` to the
bit, at bin edges, at and beyond the interval's ends and on bins of nearly
no mass, for both tails; the rule sends gradients, bf16, ActNorm, other
dtypes and functorch-wrapped inputs to the eager stack and everything else
to the wrapper; `flow_fused_rows` is counted only under a profiler; a
vmapped ensemble equals its serial calls; the evaluator's results do not
move. The tests marked `cuda` hold the kernel against its plain version on
the card with no element apart, its launches a call and the device
operations of a flow evaluation batch. This file imports neither JAX nor
the JAX package:

    python -m pytest tests/test_torch_flow_fused.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.data.loaders import Dataset, Split
from vae_posterior_consistency_tpu_torch.engine import evaluate
from vae_posterior_consistency_tpu_torch.models import flow_vae, get_model
from vae_posterior_consistency_tpu_torch.nn import core
from vae_posterior_consistency_tpu_torch.nn import flow
from vae_posterior_consistency_tpu_torch.ops import _kernel, fused_flow
from vae_posterior_consistency_tpu_torch.utils import tracing

TAILS = ("clamp", "linear")
#: inputs on the interval's ends, just inside and beyond them, and on the
#: bin edges and midpoints of 10 bins on [-1, 1]
SPECIAL = (-1.0, 1.0, -1.0000001, 1.0000001, -0.9999999, 0.9999999, 0.0,
           -0.8, -0.6, -0.4, -0.2, 0.2, 0.4, 0.6, 0.8, -0.5, 0.5, 0.1, -0.1,
           0.3, 2.5, -3.0, 7.0, float("inf"), float("-inf"))


def _inputs(shape, num_bins, seed=0, device="cpu"):
    """(eps [*shape], bin logits [*shape, num_bins]): standard normal noise
    scaled by 1.5 (about a half of it outside [-1, 1]) with SPECIAL values
    written over its first cells, and logits of spread 3 where every 7th
    cell has one dominant bin (the others' mass near 1e-17) and every 11th
    bins of mass about 1e-35 beside a normal one."""
    gen = torch.Generator().manual_seed(seed)
    eps = 1.5 * torch.randn(shape, generator=gen)
    flat = eps.view(-1)
    k = min(len(SPECIAL), flat.numel())
    flat[:k] = torch.tensor(SPECIAL[:k])
    logits = 3.0 * torch.randn((*shape, num_bins), generator=gen)
    cells = logits.view(-1, num_bins)
    cells[::7] = -40.0
    cells[::7, 3 % num_bins] = 0.0
    cells[::11, ::2] = -80.0
    return eps.to(device), logits.to(device)


def _tables(logits):
    return flow._normalize_pdf(logits)


def _eager(eps, logits, tails):
    """`flow_forward`'s eager stack: with gradients enabled, as training
    runs it."""
    L, nb = logits.shape[-2:]
    with torch.enable_grad():
        return flow.flow_forward(eps, logits.flatten(-2), L, num_bins=nb,
                                 tails=tails)


def _same(got, want):
    """Every element of both outputs equal, the same bits (NaN nowhere)."""
    for g, w in zip(got, want):
        assert not torch.isnan(w).any()
        assert g.shape == w.shape and torch.equal(g, w), (
            (g != w).sum().item())


# -- the plain version (run everywhere) ---------------------------------------

@pytest.mark.parametrize("tails", TAILS)
@pytest.mark.parametrize("shape,num_bins", [
    ((64, 10), 10), ((17, 10), 10), ((1025, 10), 10), ((3, 21, 10), 10),
    ((50, 6), 4)], ids=str)
def test_the_plain_version_is_the_eager_stack(tails, shape, num_bins):
    eps, logits = _inputs(shape, num_bins)
    want = _eager(eps, logits, tails)
    _same(fused_flow.flow_spline_reference(eps, *_tables(logits), tails),
          want)
    # and flow_forward without gradients, which takes the wrapper
    with torch.no_grad():
        _same(flow.flow_forward(eps, logits.flatten(-2), shape[-1],
                                num_bins=num_bins, tails=tails), want)


def test_the_inputs_reach_every_edge_case():
    """The seeded inputs hold cells on both sides of the interval, on
    bin edges and on bins of nearly no mass, chosen by the first layer."""
    eps, logits = _inputs((1025, 10), 10)
    pdf, _ = _tables(logits)
    pos = (eps + 1.0) / 2.0 * 10
    inside = (eps >= -1) & (eps <= 1)
    assert (~inside).sum() > 100 and inside.sum() > 100
    assert ((pos == torch.floor(pos)) & inside).sum() >= 8
    b = torch.clamp(torch.floor(torch.where(inside, pos, 5.0)).long(), 0, 9)
    chosen = torch.gather(pdf, -1, b.unsqueeze(-1)).squeeze(-1)
    assert (chosen < 1e-12).sum() >= 5


def test_the_kernel_contract(monkeypatch):
    eps, logits = _inputs((8, 10), 10)
    pdf, cdf = _tables(logits)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_flow.flow_spline_kernel(eps, pdf, cdf, "clamp")
    monkeypatch.setattr(_kernel, "check_inputs", lambda what, ts: None)
    for bad in ((eps[:4], pdf, cdf), (eps, pdf, cdf[..., :-1]),
                (eps, pdf[:, :5], cdf)):
        with pytest.raises(ValueError, match="flow_spline: want"):
            fused_flow.flow_spline_kernel(*bad, "clamp")
    assert _kernel.PLAIN["flow_spline"] is fused_flow.flow_spline_reference


# -- the rule -----------------------------------------------------------------

@pytest.fixture
def spy(monkeypatch):
    """The calls `flow_forward` makes of the wrapper."""
    calls = []
    real = fused_flow.flow_spline

    def spied(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(fused_flow, "flow_spline", spied)
    return calls


@pytest.mark.parametrize("tails", TAILS)
def test_without_gradients_in_float32_the_wrapper_runs(spy, tails):
    eps, logits = _inputs((64, 10), 10)
    with torch.no_grad():
        flow.flow_forward(eps, logits.flatten(-2), 10, tails=tails)
    with torch.inference_mode():
        flow.flow_forward(eps, logits.flatten(-2), 10, tails=tails)
    assert len(spy) == 2 and all(c[3] == tails for c in spy)


@pytest.mark.parametrize("mode", ["grad", "bf16", "actnorm", "float64",
                                  "vmap"])
def test_everything_else_keeps_the_eager_stack(spy, mode):
    eps, logits = _inputs((64, 10), 10)
    ctx = logits.flatten(-2)
    act = None
    if mode == "actnorm":
        act = [flow.actnorm_init(10, "cpu") for _ in range(flow.NUM_LAYERS)]
    if mode == "float64":
        eps, ctx = eps.double(), ctx.double()
    if mode == "grad":
        want = _eager(eps, logits, "clamp")
        got = flow.flow_forward(eps, ctx.requires_grad_(), 10)
        _same([t.detach() for t in got], want)
    elif mode == "bf16":
        with torch.no_grad(), core.compute_dtype("bfloat16"):
            flow.flow_forward(eps, ctx, 10)
    elif mode == "vmap":
        stacked = torch.stack([ctx, ctx.flip(0)])
        with torch.no_grad():
            got = torch.func.vmap(
                lambda c: flow.flow_forward(eps, c, 10))(stacked)
            for r in range(2):
                _same([t[r] for t in got],
                      flow.flow_forward(eps, stacked[r], 10))
        assert len(spy) == 2  # the two serial calls only
        return
    else:
        with torch.no_grad():
            flow.flow_forward(eps, ctx, 10, actnorm=act)
    assert spy == []


def test_the_inverse_and_training_keep_the_eager_stack(spy):
    cfg = RunConfig(vae_type="reg_flow1", hid_dim=32)
    params = _params(cfg, 13)
    x, mask, eps = _batch(13, 16)
    with torch.no_grad():
        z, _ = flow_vae.encode(params, x, mask, eps, cfg)
        flow_vae.encoder_log_prob(params, z, x, mask, cfg)
    assert len(spy) == 1  # the encode, not the inverse
    flow_vae.train_loss(params, x, mask, mask, torch.stack([eps, eps]), 0,
                        cfg)
    assert len(spy) == 1


def _recorded(fn):
    tracing.take()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()
    return [r for r in tracing.take() if isinstance(r, tracing.Count)]


def test_flow_fused_rows_is_counted_only_under_a_profiler():
    eps, logits = _inputs((3, 21, 10), 10)
    ctx = logits.flatten(-2)
    tracing.take()
    with torch.no_grad():
        flow.flow_forward(eps, ctx, 10)
    assert tracing.take() == []
    with torch.no_grad():
        counts = _recorded(lambda: flow.flow_forward(eps, ctx, 10))
    assert sorted((c.name, c.n) for c in counts) == [
        ("flow_fused_rows", 63), ("flow_rows", 63)]
    counts = _recorded(lambda: flow.flow_forward(eps, ctx, 10))  # gradients
    assert [(c.name, c.n) for c in counts] == [("flow_rows", 63)]


# -- the model and the evaluator ----------------------------------------------

def _params(cfg, D, seed=11, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(seed)
    return get_model(cfg).init(gen, cfg, D, device=device)


def _batch(D, B, seed=5, device="cpu"):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(0.0, 1.0, (B, D)), dtype=torch.float32)
    mask = torch.tensor(rng.random((B, D)) < 0.7, dtype=torch.float32)
    eps = torch.tensor(rng.standard_normal((B, 10)), dtype=torch.float32)
    return x.to(device), mask.to(device), eps.to(device)


def test_a_vmapped_ensemble_is_its_serial_calls(spy):
    """Three replicas of a flow model vmapped through `eval_step`, rows and
    noise shared (as `eval_vae_ensemble` calls it): each replica its own
    serial call, which takes F1's wrapper, bit for bit."""
    cfg = RunConfig(vae_type="reg_flow1", hid_dim=32)
    serial = [_params(cfg, 13, seed=s) for s in (1, 2, 3)]
    stacked = torch.utils._pytree.tree_map(lambda *t: torch.stack(t),
                                           *serial)
    x, mask, eps = _batch(13, 64)
    model = get_model(cfg)
    with torch.no_grad():
        got = torch.func.vmap(
            lambda p: model.eval_step(p, x, mask, None, eps, cfg))(stacked)
        assert spy == []
        for r, p in enumerate(serial):
            want = model.eval_step(p, x, mask, None, eps, cfg)
            for name in want:
                assert torch.equal(got[name][r], want[name]), name
    assert len(spy) == 3


def _dataset(D=13, n_train=70, n_test=17, seed=5):
    rng = np.random.default_rng(seed)

    def split(n, stage):
        x = rng.uniform(0.0, 1.0, (n, D)).astype(np.float32)
        m = (rng.random((n, D)) < 0.7).astype(np.float32)
        return Split(torch.from_numpy(x), torch.from_numpy(m), stage)

    return Dataset(split(n_train, "train"), split(n_test, "test"), D)


@pytest.mark.parametrize("tails", TAILS)
def test_eval_vae_through_the_wrapper_equals_the_eager_stack(monkeypatch,
                                                            tails):
    cfg = RunConfig(vae_type="reg_flow1", hid_dim=32, M=3, seed=3,
                    missing_rate=30, flow_tails=tails)
    ds = _dataset()
    params = _params(cfg, ds.obs_dim)
    tracing.take()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = evaluate.eval_vae(ds, cfg, params=params, save=False,
                                device="cpu")
    counts = {}
    for r in tracing.take():
        if isinstance(r, tracing.Count):
            counts[r.name] = counts.get(r.name, 0) + r.n
    # 3 reps of 2 + 1 batches of (64 and 17) rows, every one through F1
    assert counts["flow_fused_rows"] == counts["flow_rows"] == 3 * (128 + 17)
    monkeypatch.setattr(flow, "_fused", lambda eps, pdf_logits: False)
    want = evaluate.eval_vae(ds, cfg, params=params, save=False,
                             device="cpu")
    assert got == want


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: cuGraphNodeType of a kernel, a copy and a fill
_OP_NODES = (0, 1, 2)


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
@pytest.mark.parametrize("tails", TAILS)
def test_f1_equals_its_plain_version_on_the_card(cuda, tails):
    """131,072 rows x 10 cells (and the edge cases of `_inputs`): no
    element of z or log_prob apart from the plain version's on the card,
    nor from the eager stack's."""
    eps, logits = _inputs((1 << 17, 10), 10, seed=7, device=cuda)
    pdf, cdf = _tables(logits)
    with torch.no_grad():
        before = _kernel.launches["flow_spline"]
        got = fused_flow.flow_spline(eps, pdf, cdf, tails)
        assert _kernel.launches["flow_spline"] == before + 1
        plain = fused_flow.flow_spline_reference(eps, pdf, cdf, tails)
    apart = [int((g != w).sum()) for g, w in zip(got, plain)]
    print(f"F1 {tails} {tuple(eps.shape)}: elements apart from the plain "
          f"version (z, log_prob) {apart}")
    _same(got, plain)
    _same(got, _eager(eps, logits, tails))


@pytest.mark.cuda
def test_f1_at_the_flows_shapes_on_the_card(cuda):
    """The evaluation batches [64, 10], [17, 10] and the AL episode's
    [10200, 10], and a leading axis: equal to the plain version."""
    for shape in ((64, 10), (17, 10), (10200, 10), (4, 17, 10), (1, 10)):
        eps, logits = _inputs(shape, 10, seed=len(shape), device=cuda)
        with torch.no_grad():
            _same(fused_flow.flow_spline(eps, *_tables(logits), "clamp"),
                  fused_flow.flow_spline_reference(eps, *_tables(logits),
                                                   "clamp"))


@pytest.mark.cuda
def test_one_launch_a_flow_forward_on_the_card(cuda):
    eps, logits = _inputs((64, 10), 10, device=cuda)
    ctx = logits.flatten(-2)
    with torch.no_grad():
        flow.flow_forward(eps, ctx, 10)  # binds the kernel
        before = _kernel.launches["flow_spline"]
        first = flow.flow_forward(eps, ctx, 10)
        assert _kernel.launches["flow_spline"] == before + 1
        second = flow.flow_forward(eps, ctx, 10)
        _same(first, second)
        # the tables (softmax, cumsum, two fills, cat) and F1
        assert _graph_ops(lambda: flow.flow_forward(eps, ctx, 10)) <= 6
    before = _kernel.launches["flow_spline"]
    flow.flow_forward(eps, ctx.requires_grad_(), 10)
    assert _kernel.launches["flow_spline"] == before


#: the device operations a flow evaluation batch (`_batch_stats`: the
#: model's `eval_step` and the evaluator's statistics) may hold with F1,
#: and how many fewer than with the eager stack it holds at least: the
#: eager stack's three passes are about 88 operations, F1's path six (the
#: tables' five and F1). Measured on an H100 (torch 2.11): 97 with F1, 183
#: with the eager stack; the encoder, the decoder, the likelihood's sums
#: and the statistics are the other 91.
FLOW_BATCH_OPS = 100
FLOW_STACK_SAVED = 80


@pytest.mark.cuda
def test_a_flow_evaluation_batch_on_the_card(cuda, monkeypatch):
    """record 10's model at its widths: the captured batch and the
    captured `eval_step` each hold at least FLOW_STACK_SAVED device
    operations fewer than with the eager stack, the batch at most
    FLOW_BATCH_OPS, and the batch gives the eager stack's bits."""
    cfg = RunConfig(vae_type="reg_flow1", missing_rate=30)
    model = get_model(cfg)
    params = _params(cfg, 13, device=cuda)
    x, mask, eps = _batch(13, 64, device=cuda)
    w = torch.ones(64, device=cuda)

    def batch():
        return evaluate._batch_stats(model, cfg, params, x, mask, None, eps,
                                     w)

    def step():
        return model.eval_step(params, x, mask, None, eps, cfg)

    with torch.no_grad():
        fused = batch()
        n_fused, n_step_fused = _graph_ops(batch), _graph_ops(step)
        monkeypatch.setattr(flow, "_fused", lambda eps, pdf_logits: False)
        eager = batch()
        n_eager, n_step_eager = _graph_ops(batch), _graph_ops(step)
    print(f"a flow evaluation batch [64, 13]: {n_fused} device operations "
          f"with F1, {n_eager} with the eager stack; its eval_step "
          f"{n_step_fused} and {n_step_eager}")
    assert torch.equal(fused, eager)
    assert n_fused <= FLOW_BATCH_OPS
    assert n_eager - n_fused >= FLOW_STACK_SAVED
    assert n_step_eager - n_step_fused >= FLOW_STACK_SAVED


@pytest.mark.cuda
def test_eval_vae_on_the_card_keeps_its_bits(cuda, monkeypatch):
    """record 10's shapes at M=5 (both splits through the captured graph):
    the same means with F1 as with the eager stack, bit for bit."""
    cfg = RunConfig(vae_type="reg_flow1", missing_rate=30, M=5, seed=3)
    ds = _dataset(n_train=161)
    ds = Dataset(*(Split(s.x.to(cuda), s.mask.to(cuda), s.stage)
                   for s in (ds.train, ds.test)), ds.obs_dim)
    params = _params(cfg, ds.obs_dim, device=cuda)
    before = _kernel.launches["flow_spline"]
    got = evaluate.eval_vae(ds, cfg, params=params, save=False, device=cuda)
    # the warm-up and the capture of each batch shape (64, 17)
    assert _kernel.launches["flow_spline"] == before + 4
    monkeypatch.setattr(flow, "_fused", lambda eps, pdf_logits: False)
    want = evaluate.eval_vae(ds, cfg, params=params, save=False, device=cuda)
    assert got == want
