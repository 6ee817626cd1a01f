"""IW2 (`ops/fused_iw_mnar`, `csrc/iw_decode.cu`): notMIWAE's importance-
weighted evaluation step in one call (the encoder, the per-sample terms with
the self-masking log-pmf, and the reductions over K), and the rule by which
`models/notmiwae.eval_step` takes it.

On the CPU: the plain version is the eager composition (`forward`,
`_branch` and the reductions `eval_step` took before IW2 held them) to the
bit, `eval_step` through IW2 equals its eager path, the rule sends
gradients, bf16 and the other missingness processes to the eager path, the
step records the one span `notmiwae.decode`, and a replica axis or a
vmapped call is the serial calls. The tests marked `cuda` hold the kernel
against the plain version on the card within the MNAR cell's limits, its
bits from run to run, its replicas and its device operations a step. This
file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_notmiwae_fused.py -m cuda --noconftest
"""

import math

import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.engine import checkpoint, evaluate
from vae_posterior_consistency_tpu_torch.models import get_model, notmiwae
from vae_posterior_consistency_tpu_torch.ops import _kernel
from vae_posterior_consistency_tpu_torch.ops import fused_iw_mnar
from vae_posterior_consistency_tpu_torch.utils import tracing

TYPES = ("changed", "author")


def _case(B, K, D=12, L=10, not_miwae_type="changed", fixed=False, seed=0,
          device="cpu", vae_type="reg_notMIWAE1"):
    """(cfg, params, x, mask, eps) at the MNAR wine width: seeded
    parameters (torch's Linear init, xavier W and b), rows in [0, 1), 70%
    observed."""
    cfg = RunConfig(vae_type=vae_type, latent_dim=L, valid_k=K,
                    not_miwae_type=not_miwae_type, fixed_iwae_bound=fixed)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = get_model(cfg).init(gen, cfg, D, device=device)
    rng = np.random.default_rng(seed + 1)
    x = rng.uniform(0.0, 1.0, (B, D))
    mask = rng.random((B, D)) < 0.7
    eps = rng.standard_normal((B, K, L))
    x, mask, eps = (torch.tensor(a, dtype=torch.float32, device=device)
                    for a in (x, mask, eps))
    return cfg, params, x, mask, eps


def _before(params, x, mask, eps, cfg):
    """`eval_step`'s eager composition as it stood before IW2: `forward` and
    `_branch` on the q branch, then the softmax imputation, the bound and
    the mean of RE over K; with the encoder's mean and logvar."""
    K = eps.shape[1]
    out = notmiwae.forward(params, x, mask, eps, cfg)
    RE, _, _, l_w = notmiwae._branch(params, out, x, mask,
                                     "selfmasking_known")
    sign = -1.0 if cfg.fixed_iwae_bound else 1.0
    return (torch.einsum("bk,bkd->bd", torch.softmax(-l_w, dim=1),
                         out["x_mean"]),
            sign * (torch.logsumexp(sign * l_w, dim=1) - math.log(K)),
            torch.mean(RE, dim=1), out["mean"], out["logvar"])


def _step(cfg, params, x, mask, eps, **kw):
    return get_model(cfg).eval_step(params, x, mask, None, eps, cfg, **kw)


def _recorded(fn):
    """fn() under a CPU profiler (the tracer records only then): (its
    result, the records)."""
    tracing.take()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, tracing.take()


def _totals(recs):
    totals = {}
    for r in recs:
        if isinstance(r, tracing.Count):
            totals[r.name] = totals.get(r.name, 0) + r.n
    return totals


# -- the plain version is the eager composition ------------------------------

#: (B, K, D): one row, a few, the wine table's 178; K below a tile, across
#: tiles, none a multiple of 64; the wine width and one past a chunk of the
#: head's features
PLAIN_CASES = [(1, 7, 12), (9, 100, 12), (178, 130, 12), (5, 77, 30)]


@pytest.mark.parametrize("B,K,D", PLAIN_CASES)
@pytest.mark.parametrize("fixed", [False, True], ids=["bound", "fixed"])
@pytest.mark.parametrize("not_miwae_type", TYPES)
def test_the_plain_version_is_the_eager_composition(not_miwae_type, fixed,
                                                    B, K, D):
    """Every output to the bit against the composition `eval_step` ran
    before IW2: the imputation, the bound (the reference's positive-l_w
    form, or the fixed one), the mean of RE over K, the encoder's mean and
    logvar."""
    cfg, params, x, mask, eps = _case(B, K, D, not_miwae_type=not_miwae_type,
                                      fixed=fixed)
    with torch.no_grad():
        x_imputed, per_row, mean, logvar = fused_iw_mnar.iw_mnar(
            x, mask, eps, params, cfg)
        want = _before(params, x, mask, eps, cfg)
    assert x_imputed.shape == (B, D) and per_row.shape == (2, B)
    for got, w in zip((x_imputed, per_row[0], per_row[1], mean, logvar),
                      want):
        assert torch.equal(got, w)


def test_the_plain_version_runs_the_models_own_branch(monkeypatch):
    """The plain version is the model's composition, looked up at each
    call: a `_branch` patched in the model (log p(s|x) left out, the
    benchmark's planted fault) changes what IW2 returns on the CPU."""
    cfg, params, x, mask, eps = _case(6, 20)
    with torch.no_grad():
        sound = fused_iw_mnar.iw_mnar(x, mask, eps, params, cfg)
        branch = notmiwae._branch
        monkeypatch.setattr(notmiwae, "_branch", lambda *a, **kw: branch(
            *a, **{**kw, "with_s": False}))
        faulty = fused_iw_mnar.iw_mnar(x, mask, eps, params, cfg)
    assert not torch.equal(sound[0], faulty[0])
    assert torch.equal(sound[2], faulty[2])  # the encoder is untouched


@pytest.mark.parametrize("name", ["encoder", "decoder"])
def test_the_leaves_round_trip(name):
    cfg, params, *_ = _case(2, 3)
    leaves = fused_iw_mnar.leaves_of(params)
    assert len(leaves) == 18
    back = fused_iw_mnar.params_of(leaves)
    flat, flat_back = (checkpoint.flatten(p[name]) for p in (params, back))
    assert flat.keys() == flat_back.keys()
    assert all(flat[k] is flat_back[k] for k in flat)
    assert back["W"] is params["W"] and back["b"] is params["b"]


def test_the_shapes_are_checked(monkeypatch):
    """The kernel's shape contract (its device check, which the CPU fails
    first, set aside)."""
    cfg, params, x, mask, eps = _case(3, 5)
    monkeypatch.setattr(_kernel, "check_inputs", lambda *a: None)
    with pytest.raises(ValueError, match="iw_mnar: want"):
        fused_iw_mnar._shapes(x, mask, eps[:, :, :4],
                              fused_iw_mnar.leaves_of(params))


# -- eval_step through IW2 ----------------------------------------------------

@pytest.mark.parametrize("B,K", [(1, 7), (17, 9), (64, 50)])
@pytest.mark.parametrize("vae_type", ["vanilla_notMIWAE1", "reg_notMIWAE1"])
@pytest.mark.parametrize("not_miwae_type", TYPES)
def test_eval_step_through_iw2_equals_its_eager_path(not_miwae_type,
                                                     vae_type, B, K,
                                                     monkeypatch):
    """`eval_step` through IW2 and its eager path, to the bit; one IW2 call
    counts its samples twice (`iw_samples`, `iw_fused_samples`) and records
    the one span `notmiwae.decode`."""
    cfg, params, x, mask, eps = _case(B, K, not_miwae_type=not_miwae_type,
                                      vae_type=vae_type)
    with torch.no_grad():
        got, recs = _recorded(lambda: _step(cfg, params, x, mask, eps))
        monkeypatch.setattr(notmiwae, "_fused", lambda: False)
        want = _step(cfg, params, x, mask, eps)
    assert sorted(got) == sorted(want) == [
        "row_loss", "row_negl", "row_negl_imp", "x_imputed"]
    for name in want:
        assert torch.equal(got[name], want[name]), name
    totals = _totals(recs)
    assert totals == {"iw_samples": B * K, "iw_fused_samples": B * K}
    assert [r.name for r in recs if isinstance(r, tracing.Span)] == [
        "notmiwae.decode"]


# -- the rule: who runs IW2 ---------------------------------------------------

@pytest.mark.parametrize("mode", ["grad", "bf16", "selfmasking", "linear",
                                  "no_grad"])
def test_gradients_bf16_and_other_processes_take_the_eager_path(
        mode, monkeypatch):
    """With gradients enabled, under compute_dtype('bfloat16') or with a
    missingness process other than the default, the step runs `forward`
    and `_branch` and counts no `iw_fused_samples`; without gradients in
    float32 under the default process it counts B x K."""
    B, K = 9, 11
    cfg, params, x, mask, eps = _case(B, K)
    if mode == "bf16":
        cfg = cfg.replace(compute_dtype="bfloat16")
    kw = ({"missing_process": mode} if mode in ("selfmasking", "linear")
          else {})
    calls = []
    forward = notmiwae.forward
    monkeypatch.setattr(notmiwae, "forward",
                        lambda *a: calls.append(1) or forward(*a))
    grad = torch.enable_grad() if mode == "grad" else torch.no_grad()
    with grad:
        got, recs = _recorded(lambda: _step(cfg, params, x, mask, eps, **kw))
    totals = _totals(recs)
    assert totals["iw_samples"] == B * K
    if mode == "no_grad":
        # (on the CPU the plain version runs `forward` too, unrecorded)
        assert totals["iw_fused_samples"] == B * K
        return
    assert "iw_fused_samples" not in totals and calls == [1]
    monkeypatch.setattr(notmiwae, "_fused", lambda: False)
    with torch.no_grad():
        want = get_model(cfg).eval_step(params, x, mask, None, eps, cfg,
                                        **kw)
    for name in want:
        assert torch.equal(got[name].detach(), want[name]), name


def test_training_runs_the_eager_composition():
    cfg, params, x, mask, eps = _case(6, 5)
    eps = torch.stack([eps, eps])
    _, recs = _recorded(lambda: get_model(cfg).train_loss(
        params, x, mask, mask, eps, 1.0, cfg))
    totals = _totals(recs)
    assert totals["iw_samples"] == 2 * 6 * 5
    assert "iw_fused_samples" not in totals


@pytest.mark.parametrize("network", ["encoder", "decoder"])
def test_iw2_refuses_gradients(network):
    cfg, params, x, mask, eps = _case(3, 4)
    leaf = params[network]["trunk"]["layer1"]["w"].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fused_iw_mnar.iw_mnar(x, mask, eps, params, cfg)
    with torch.no_grad():
        fused_iw_mnar.iw_mnar(x, mask, eps, params, cfg)
    leaf.requires_grad_(False)


# -- ensembles: vmap ----------------------------------------------------------

def _replicas(R, B, K, device="cpu", **kw):
    """R seeded replicas' parameters, serial and stacked, and shared rows
    and draws."""
    cases = [_case(B, K, seed=r, device=device, **kw) for r in range(R)]
    cfg, _, x, mask, eps = cases[0]
    serial = [c[1] for c in cases]
    flat = [checkpoint.flatten(p) for p in serial]
    stacked = checkpoint.unflatten({k: torch.stack([f[k] for f in flat])
                                    for k in flat[0]})
    return cfg, serial, stacked, x, mask, eps


@pytest.mark.parametrize("how", ["vmap", "replica_axis"])
@pytest.mark.parametrize("not_miwae_type", TYPES)
def test_replicas_are_the_serial_calls_bit_for_bit(not_miwae_type, how):
    """Two replicas' parameters vmapped through `eval_step` (as
    `engine/evaluate._chunked` runs `eval_vae_mnar_ensemble`), or on a
    replica axis through `iw_mnar`, with the rows and draws shared: one
    call, and each replica equals its serial call to the bit."""
    B, K = 7, 9
    cfg, serial, stacked, x, mask, eps = _replicas(
        2, B, K, not_miwae_type=not_miwae_type)
    with torch.no_grad():
        if how == "vmap":
            got, recs = _recorded(lambda: torch.func.vmap(
                lambda p: _step(cfg, p, x, mask, eps))(stacked))
            assert _totals(recs)["iw_fused_samples"] == B * K
            want = [_step(cfg, p, x, mask, eps) for p in serial]
            for r in range(2):
                for name in want[r]:
                    assert torch.equal(got[name][r], want[r][name]), name
            return
        got = fused_iw_mnar.iw_mnar(
            *(t.expand(2, *t.shape) for t in (x, mask, eps)), stacked, cfg)
        for r, p in enumerate(serial):
            want = fused_iw_mnar.iw_mnar(x, mask, eps, p, cfg)
            assert all(torch.equal(g[r], w) for g, w in zip(got, want))


def test_the_mnar_evaluator_runs_iw2_once_a_rep(monkeypatch):
    """`eval_vae_mnar` at M=2 calls IW2 once a rep: its RMSE equals the
    eager path's to the bit."""
    cfg, params, x, mask, _ = _case(30, 12)
    cfg = cfg.replace(M=2)
    calls = []
    iw = fused_iw_mnar.iw_mnar
    monkeypatch.setattr(fused_iw_mnar, "iw_mnar",
                        lambda *a: calls.append(1) or iw(*a))
    got = evaluate.eval_vae_mnar(x, mask, cfg, params=params, save=False,
                                 device="cpu")
    assert len(calls) == 2
    monkeypatch.setattr(notmiwae, "_fused", lambda: False)
    assert got == evaluate.eval_vae_mnar(x, mask, cfg, params=params,
                                         save=False, device="cpu")
    assert len(calls) == 2


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: IW2 against its plain version on the card, the MNAR cell's limits
#: (benchmark/limits/notmiwae_wine_mnar.eval_mnar.json): an imputed value
#: (a convex combination of means in [0, 1]) within IMPUTED_ATOL, the
#: bound and the mean of RE (magnitudes about 1-100) within ROW_RTOL of
#: their size, the encoder's statistics within STATS_TOL
IMPUTED_ATOL = 1e-6
ROW_RTOL = 1e-6
STATS_TOL = 1e-5

#: cuGraphNodeType of a kernel, a copy and a fill
_OP_NODES = (0, 1, 2)


def _gaps(got, want):
    """(x_imputed's largest absolute gap, the per-row outputs' largest gap
    relative to max(1, size), the statistics' largest gap)."""
    x_gap = (got[0] - want[0]).abs().max().item()
    row = max(((g - w).abs() / w.abs().clamp(min=1.0)).max().item()
              for g, w in zip(got[1], want[1:3]))
    stats = max((g - w).abs().max().item() for g, w in zip(got[2:], want[3:]))
    return x_gap, row, stats


def _assert_iw2_matches_plain(cfg, params, x, mask, eps):
    with torch.no_grad():
        before = _kernel.launches["iw_mnar"]
        got = fused_iw_mnar.iw_mnar(x, mask, eps, params, cfg)
        torch.cuda.synchronize()
        assert _kernel.launches["iw_mnar"] == before + 1
        want = _before(params, x, mask, eps, cfg)
    x_gap, row, stats = _gaps(got, want)
    print(f"IW2 {cfg.not_miwae_type} fixed={cfg.fixed_iwae_bound} "
          f"{tuple(eps.shape)} D={x.shape[1]}: x_imputed {x_gap:.3e}, "
          f"per_row (relative) {row:.3e}, mean/logvar {stats:.3e}")
    assert x_gap <= IMPUTED_ATOL and row <= ROW_RTOL and stats <= STATS_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,D,L", [
    (178, 10000, 12, 10), (17, 10000, 12, 10), (1, 10000, 12, 10),
    (3, 7, 12, 10), (5, 41, 30, 4), (17, 2000, 30, 10), (9, 129, 1, 32),
    (64, 1, 12, 10)])
@pytest.mark.parametrize("not_miwae_type", TYPES)
def test_iw2_matches_its_plain_version_on_the_card(cuda, not_miwae_type, B,
                                                   K, D, L):
    """The cell's shape (178 rows at K = 10,000), one row, ragged tiles,
    tiles of many rows (K = 1), more than one chunk of features (D = 30),
    one feature, L = 4 and 32; one call each."""
    _assert_iw2_matches_plain(*_case(B, K, D, L, not_miwae_type,
                                     device=cuda))


def _double(tree):
    return {k: _double(v) if isinstance(v, dict) else v.double()
            for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("not_miwae_type", TYPES)
def test_iw2_at_784_features_on_the_card(cuda, not_miwae_type):
    """Rows whose partial sums outgrow the merging block's shared memory
    (D = 784 at K = 5000), one call. At 784 features l_w is some 60 times
    larger than at the cell's 12, and the softmax over K all but picks one
    sample, so float32 rounding of l_w moves x_imputed some 60 times more
    than in the cell (1.6e-06 and 4.0e-06 against the float32 eager path on
    the card): the kernel is held to the float64 composition no further
    than four times the float32 eager composition's own distance from it,
    and its bound and mean of RE to the cell's limit."""
    cfg, params, x, mask, eps = _case(2, 5000, 784, 10, not_miwae_type,
                                      device=cuda)
    with torch.no_grad():
        got = fused_iw_mnar.iw_mnar(x, mask, eps, params, cfg)
        want = _before(params, x, mask, eps, cfg)
        exact = _before(_double(params), x.double(), mask.double(),
                        eps.double(), cfg)
    x_gap, row, stats = _gaps(got, want)
    kernel_err = (got[0].double() - exact[0]).abs().max().item()
    eager_err = (want[0].double() - exact[0]).abs().max().item()
    print(f"IW2 {not_miwae_type} (2, 5000, 10) D=784: x_imputed against "
          f"float64 {kernel_err:.3e} (float32 eager {eager_err:.3e}), "
          f"against float32 eager {x_gap:.3e}; per_row (relative) "
          f"{row:.3e}, mean/logvar {stats:.3e}")
    assert kernel_err <= 4 * eager_err + 1e-7
    assert row <= ROW_RTOL and stats <= STATS_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("not_miwae_type", TYPES)
def test_iw2_under_the_fixed_bound_on_the_card(cuda, not_miwae_type):
    _assert_iw2_matches_plain(*_case(178, 10000, not_miwae_type=not_miwae_type,
                                     fixed=True, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,D", [(178, 10000, 12), (5, 300, 30)])
def test_iw2_gives_the_same_bits_twice(cuda, B, K, D):
    """Its sums run in an order the shapes fix, whichever block merges."""
    cfg, params, x, mask, eps = _case(B, K, D, device=cuda)
    with torch.no_grad():
        first = fused_iw_mnar.iw_mnar(x, mask, eps, params, cfg)
        second = fused_iw_mnar.iw_mnar(x, mask, eps, params, cfg)
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
def test_an_eval_step_is_one_call_of_two_device_operations(cuda):
    """One IW2 call (the encoder's launch, then the body's) and nothing
    else: no eager encoder, weights or sums around it."""
    cfg, params, x, mask, eps = _case(178, 10000, device=cuda)
    with torch.no_grad():
        _step(cfg, params, x, mask, eps)  # binds the kernel
        before = _kernel.launches["iw_mnar"]
        _step(cfg, params, x, mask, eps)
        assert _kernel.launches["iw_mnar"] == before + 1
        assert _graph_ops(lambda: _step(cfg, params, x, mask, eps)) == 2


@pytest.mark.cuda
def test_a_vmapped_ensemble_of_three_is_three_single_calls(cuda):
    """Three replicas vmapped through `eval_step`, the rows and the noise
    shared: one launch, and each replica bit for bit its own call."""
    cfg, serial, stacked, x, mask, eps = _replicas(3, 178, 2000,
                                                   device=cuda)
    with torch.no_grad():
        before = _kernel.launches["iw_mnar"]
        got = torch.func.vmap(lambda p: _step(cfg, p, x, mask, eps))(stacked)
        assert _kernel.launches["iw_mnar"] == before + 1
        for r, p in enumerate(serial):
            want = _step(cfg, p, x, mask, eps)
            for name in want:
                assert torch.equal(got[name][r], want[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["grad", "bf16"])
def test_the_eager_fallback_on_the_card(cuda, mode):
    """With gradients enabled, or under bf16, the step launches no IW2 and
    runs the eager composition on the card."""
    cfg, params, x, mask, eps = _case(17, 500, device=cuda)
    if mode == "bf16":
        cfg = cfg.replace(compute_dtype="bfloat16")
    grad = torch.enable_grad() if mode == "grad" else torch.no_grad()
    before = _kernel.launches["iw_mnar"]
    with grad:
        got = _step(cfg, params, x, mask, eps)
    assert _kernel.launches["iw_mnar"] == before
    assert all(torch.isfinite(v).all() for v in got.values())
    if mode == "grad":
        with torch.no_grad():
            fused = _step(cfg, params, x, mask, eps)
        assert (got["x_imputed"].detach() - fused["x_imputed"]).abs().max(
        ) <= IMPUTED_ATOL


@pytest.mark.cuda
def test_the_mnar_evaluator_launches_iw2_once_a_rep(cuda):
    cfg, params, x, mask, _ = _case(178, 10000, device=cuda)
    cfg = cfg.replace(M=2)
    before = _kernel.launches["iw_mnar"]
    rmse = evaluate.eval_vae_mnar(x, mask, cfg, params=params, save=False,
                                  device=cuda)
    assert _kernel.launches["iw_mnar"] == before + 2
    assert math.isfinite(rmse)
