"""IW1 (`ops/fused_iw`, `csrc/iw_decode.cu`): the importance-weighted MIWAE
terms in one pass, and the rule by which `models/miwae.eval_step` takes it.

On the CPU: the plain version is the eager composition (`forward` and
`_branch_terms`) to the bit, `eval_step` through IW1 equals it, the rule
sends gradients and bf16 to the eager path, and a vmapped call is the
serial calls. The tests marked `cuda` hold the kernel against the plain
version on the card. This file imports neither JAX nor the JAX package:

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


def _stream(cfg, params, x, mask, mask_p, eps):
    """IW1's inputs for the model's stream: the stacked q and p rows of a
    regularized type (extra on the q rows), the rows themselves else."""
    B = x.shape[0]
    extra = None
    if cfg.info.regularized:
        x, mask, extra = (torch.cat([x, x]), torch.cat([mask, mask_p]),
                          mask * (1.0 - mask_p))
        eps = eps.reshape(2 * B, *eps.shape[2:])
    mean, scale = miwae.encode(params, x, mask, cfg)
    return x, mask, extra, mean, scale, eps


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

@pytest.mark.parametrize("B,K", [(17, 7), (64, 7), (17, 5000), (64, 5000)])
@pytest.mark.parametrize("vae_type", TYPES)
def test_the_plain_version_is_the_eager_composition(vae_type, B, K):
    """Every output to the bit: x_mean, logpxobs, logpx_imp, log p(z),
    log q, log_w assembled from them, and the sum under `extra` on the q
    rows (0 on the p rows)."""
    cfg, params, *batch = _case(vae_type, B, K)
    x, mask, extra, mean, scale, eps = _stream(cfg, params, *batch)
    with torch.no_grad():
        x_mean, terms = fused_iw.iw_fused(x, mask, extra, mean, scale, eps,
                                          params["decoder"])
        out = miwae.forward(params, x, mask, eps, cfg)
        logpxobs, log_w, logpx_imp, log_pxz = miwae._branch_terms(out, x,
                                                                  mask)
    assert terms.shape == (4 if extra is None else 5, x.shape[0], K)
    assert torch.equal(x_mean, out["x_mean"])
    assert torch.equal(terms[0], logpxobs)
    assert torch.equal(terms[1], logpx_imp)
    assert torch.equal(terms[2], torch.sum(std_normal_logpdf(out["z"]), -1))
    assert torch.equal(terms[3], torch.sum(normal_logpdf_scale(
        out["z"], mean[:, None, :], scale[:, None, :]), -1))
    assert torch.equal(terms[0] + terms[2] - terms[3], log_w)
    if extra is not None:
        assert torch.equal(terms[4, :B], miwae._extra_sum(log_pxz, extra))
        assert not terms[4, B:].any()


# -- eval_step through IW1 ----------------------------------------------------

@pytest.mark.parametrize("B,K", [(17, 7), (64, 50)])
@pytest.mark.parametrize("vae_type", TYPES)
def test_eval_step_through_iw1_equals_the_eager_composition(
        vae_type, B, K, monkeypatch):
    cfg, params, x, mask, mask_p, eps = _case(vae_type, B, K)
    step = get_model(cfg).eval_step
    with torch.no_grad():
        got, counts = _recorded_counts(
            lambda: step(params, x, mask, mask_p, eps, cfg))
        _eager(monkeypatch)
        want = step(params, x, mask, mask_p, eps, cfg)
    assert sorted(got) == sorted(want) == ["row_loss", "row_negl",
                                           "row_negl_imp", "x_imputed"]
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert counts["iw_fused_samples"] == counts["iw_samples"] == (
        (2 if cfg.info.regularized else 1) * B * K)


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


def test_iw1_refuses_gradients():
    cfg, params, *batch = _case("vanilla_MIWAE1", 3, 4)
    x, mask, extra, mean, scale, eps = _stream(cfg, params, *batch)
    leaf = params["decoder"]["layer1"]["w"].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fused_iw.iw_fused(x, mask, extra, mean, scale, eps,
                          params["decoder"])
    with torch.no_grad():
        fused_iw.iw_fused(x, mask, extra, mean, scale, eps,
                          params["decoder"])
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
    call's."""
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
    for name in want[0]:
        for r in range(2):
            # the encoder's vmapped products batch the replicas
            torch.testing.assert_close(got[name][r], want[r][name],
                                       rtol=1e-6, atol=1e-6, msg=name)


def test_a_vmapped_iw1_call_is_the_serial_calls_bit_for_bit():
    cfg, serial, stacked, *batch = _two_replicas("reg_MIWAE1", 5, 6)
    streams = [_stream(cfg, p, *batch) for p in serial]
    x, mask, extra, _, _, eps = streams[0]
    mean = torch.stack([s[3] for s in streams])
    scale = torch.stack([s[4] for s in streams])

    def call(dec, mean, scale):
        return fused_iw.iw_fused(x, mask, extra, mean, scale, eps, dec)

    with torch.no_grad():
        got = torch.func.vmap(call)(stacked["decoder"], mean, scale)
        for r, p in enumerate(serial):
            want = call(p["decoder"], mean[r], scale[r])
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
#: (cuBLAS in another), and its sums over D and L too. Relative gaps of
#: 1e-7 a term carry through sigmoid and the log-density: x_mean (in
#: [0, 1]) within X_MEAN_ATOL, each per-sample sum (magnitudes about 1-100)
#: within TERMS_RTOL of its size, or TERMS_ATOL near zero.
X_MEAN_ATOL = 2e-6
TERMS_RTOL = 2e-5
TERMS_ATOL = 5e-5


def _assert_iw1_matches_plain(inputs, decoder):
    x_mean, terms = fused_iw.iw_fused(*inputs, decoder)
    torch.cuda.synchronize()
    want_x, want_t = fused_iw.iw_fused_reference(
        *inputs, *fused_iw.decoder_leaves(decoder))
    gap_x = (x_mean - want_x).abs().max().item()
    gap_t = ((terms - want_t).abs() / (want_t.abs() + 1.0)).max().item()
    print(f"x_mean gap {gap_x:.3e}, terms relative gap {gap_t:.3e}")
    torch.testing.assert_close(x_mean, want_x, rtol=0, atol=X_MEAN_ATOL)
    torch.testing.assert_close(terms, want_t, rtol=TERMS_RTOL,
                               atol=TERMS_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,D,L", [
    (64, 5000, 13, 10), (17, 5000, 13, 10), (3, 7, 13, 10), (5, 41, 30, 4),
    (2, 300, 784, 10), (9, 129, 1, 32)])
@pytest.mark.parametrize("vae_type", TYPES)
def test_iw1_matches_its_plain_version_on_the_card(cuda, vae_type, B, K, D,
                                                   L):
    """The cell's shapes (64 and 17 rows at K = 5000), ragged tiles, more
    than one chunk of features (D = 30, 784), one feature, L = 4 and 32."""
    cfg, params, *batch = _case(vae_type, B, K, D=D, L=L, device=cuda)
    with torch.no_grad():
        inputs = _stream(cfg, params, *batch)
        before = _kernel.launches["iw_fused"]
        _assert_iw1_matches_plain(inputs, params["decoder"])
    assert _kernel.launches["iw_fused"] == before + 1


@pytest.mark.cuda
def test_iw1_replicas_in_one_launch(cuda):
    """Two replicas vmapped with the rows and the noise shared: one
    launch, each replica bit for bit its own call."""
    cfg, serial, stacked, *batch = _two_replicas("reg_MIWAE1", 64, 500)
    batch = [t.to(cuda) for t in batch]
    serial = [checkpoint.on_device(p, cuda) for p in serial]
    stacked = checkpoint.on_device(stacked, cuda)
    streams = [_stream(cfg, p, *batch) for p in serial]
    x, mask, extra, _, _, eps = streams[0]
    mean = torch.stack([s[3] for s in streams])
    scale = torch.stack([s[4] for s in streams])

    def call(dec, mean, scale):
        return fused_iw.iw_fused(x, mask, extra, mean, scale, eps, dec)

    with torch.no_grad():
        before = _kernel.launches["iw_fused"]
        got = torch.func.vmap(call)(stacked["decoder"], mean, scale)
        assert _kernel.launches["iw_fused"] == before + 1
        for r, p in enumerate(serial):
            want = call(p["decoder"], mean[r], scale[r])
            assert all(torch.equal(g[r], w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("vae_type", TYPES)
def test_one_launch_a_stream_a_batch(cuda, vae_type):
    """eval_vae launches IW1 once a batch (a regularized type's q and p
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
