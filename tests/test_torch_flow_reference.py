"""The port's flow-posterior VAE evaluation (`reg_flow1`: `eval_step`,
`eval_vae`, and `nn/flow`'s spline stack both ways) against the
benchmark's plain reference, `benchmark/reference/flow.py` (plain torch,
written from the reference class's equations; loaded by path), on seeded
random weights on the CPU. Inputs include base noise in the clamp tails
(outside [-1, 1]), on the bin edges and on the top of the interval, and a
cdf whose cumulative sum does not end on exactly 1. The comparison is
tight enough to refuse the reference's TF32 control and two planted
faults: a flow of two spline layers, and a cdf whose top edge is the
cumulative sum's own last entry rather than exactly 1 (which only the
inverse pass reads).

Sizes: D=5, hidden 16, latent 4 (so 4 bins a latent), batches of 8, M=2.

Tolerances, each with its reason:
- the spline's outputs and log q are held to equal bits (`SPLINE_ATOL`
  0): the reference decides the bins with the same float32 operations in
  the same order (a `floor` of (x + 1) / 2 * L, cdf_left + alpha * pdf),
  as it must, since a bin flip changes log q by O(1);
- a row's numbers (RE over the observed and over the hidden cells, the
  loss RE + KL) to 1e-6 of the largest of them: the reference takes the
  Gaussian density from torch.distributions (x^2 / (2 exp(-8)) where the
  port has 0.5 x^2 exp(8)), so they agree to a float32 quantum of a
  row's sum, up to 2.1e-7 relative here; the imputation, which is the
  same decoder's mean, to the bit;
- `eval_vae`'s eight means (four metrics of two splits) to 1e-6
  relative: the same rows, reduced in another order (a quantum of a mean
  of about 500 is 6e-8 relative).
TF32's 10-bit operands move the spline's outputs by 1.4e-4, a row's
numbers by 1.9e-5 and every mean by 2.1e-6 or more here; a two-layer flow
moves log q by O(1), a cdf without its exact top edge the inverse's log q
of the last bin by about 2e-3.
"""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.data.loaders import Dataset, Split
from vae_posterior_consistency_tpu_torch.engine import checkpoint, evaluate
from vae_posterior_consistency_tpu_torch.models import flow_vae
from vae_posterior_consistency_tpu_torch.nn import flow as flowlib

SPLINE_ATOL = 0.0
ROW_RTOL = 1e-6
MEANS_RTOL = 1e-6
D, H, L, B, M = 5, 16, 4, 8, 2
ROWS = {"x_imputed": "x_imputed", "row_loss": "loss", "row_negl": "negl",
        "row_negl_imp": "negl_imp"}


def _load_reference():
    path = (Path(__file__).resolve().parents[1] / "benchmark" / "reference"
            / "flow.py")
    spec = importlib.util.spec_from_file_location("flow_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_reference()
CFG = {"obs_dim": D, "latent_dim": L, "encoder_trunk": [H, H],
       "decoder": [H] * 4}


def _run_cfg():
    return RunConfig(vae_type="reg_flow1", hid_dim=H, latent_dim=L,
                     batch_size=B, M=M, missing_rate=30)


def _weights(seed=30):
    """Flat parameters, each leaf U(+-bound) as `param_specs` states."""
    g = torch.Generator().manual_seed(seed)
    return {key: (torch.rand(shape, generator=g) * 2.0 - 1.0) * bound
            for key, shape, bound in ref.param_specs(CFG)}


def _nested(p):
    return checkpoint.unflatten({k: v.clone() for k, v in p.items()})


def _rows(n, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, D, generator=g)
    return x, (torch.rand(n, D, generator=g) >= 0.3).float(), g


def _eps(g, n):
    """Base noise over the tails, the bin edges and the interval's ends:
    N(0, 1.5^2), then the edges -1, -0.5, 0, 0.5, 1 of the 4 bins and +-3
    in the first rows."""
    eps = torch.randn(n, L, generator=g) * 1.5
    special = torch.tensor([-1.0, -0.5, 0.0, 0.5, 1.0, 3.0, -3.0, 1.0 + 1e-7])
    k = min(n * L, special.numel())
    eps.view(-1)[:k] = special[:k]
    return eps


def _gap(a, b, scale=None):
    scale = b.abs().max() if scale is None else scale
    return ((a - b).abs().max() / scale).item()


class Recorded:
    """A noise source for `eval_vae` that keeps its draws."""

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)
        self.kept = []

    def __call__(self, kind, rep, step, shape):
        t = (torch.randperm(shape[0], generator=self.gen) if kind == "perm"
             else _eps(self.gen, shape[0]))
        self.kept.append(t)
        return t


def _means(p, ds, kept):
    """{stage: {metric: mean}} of the reference, from the kept draws."""
    draws, out = iter(kept), {}
    for split in (ds.train, ds.test):
        bsz = min(B, split.n)
        steps = -(-split.n // bsz)
        stats = []
        for _ in range(M):
            perm = next(draws)
            eps = torch.cat([next(draws) for _ in range(steps)])
            stats.append(ref.evaluate_split(p, CFG, split.x, split.mask,
                                            perm, eps, bsz)[0])
        out[split.stage] = dict(zip(evaluate.METRICS,
                                    torch.stack(stats).mean(1).mean(0)
                                    .tolist()))
    return out


def gaps(mode=None):
    """{comparison: (gap, tolerance)} of the port against the reference;
    mode 'tf32' computes the reference under its TF32 control."""
    ctl = ref.precision(mode) if mode else ref.precision("fp32")
    p = _weights()
    params, rc = _nested(p), _run_cfg()
    out = {}
    with ctl:
        # eval_step's rows on one batch
        x, m, g = _rows(B, 1)
        eps = _eps(g, B)
        got = flow_vae.eval_step(params, x, m, None, eps, rc)
        want = ref.eval_rows(p, x, m, eps)
        for name, key in ROWS.items():
            tol = SPLINE_ATOL if name == "x_imputed" else ROW_RTOL
            out[f"eval_step.{name}"] = (_gap(got[name], want[key]), tol)
        # the spline stack both ways on the encoder's bin logits
        ctx = flow_vae.layers.flow_context_encoder_apply(params["encoder"],
                                                         x, m)
        logits = ref.context(p, x, m)
        z, log_q = flowlib.flow_forward(eps, ctx, L)
        z_ref, log_q_ref = ref.flow(eps, logits)
        out["flow.z"] = (_gap(z, z_ref, 1.0), SPLINE_ATOL)
        out["flow.log_q"] = (_gap(log_q, log_q_ref, 1.0), SPLINE_ATOL)
        inv = flowlib.flow_log_prob(z, ctx, L)
        out["flow.log_prob"] = (_gap(inv, ref.log_prob(z, logits), 1.0),
                                SPLINE_ATOL)
        # the inverse on logits whose last bin is small and whose cumsum
        # does not end on 1: the top edge decides its slope
        logits, top = _thin_top_bin()
        y = torch.full(logits.shape[:-1], 0.9999)
        got = flowlib.flow_log_prob(y, logits.reshape(-1, L * L), L)
        out["flow.log_prob_top"] = (_gap(got, ref.log_prob(y, logits), 1.0),
                                    SPLINE_ATOL)
        # eval_vae's eight means, eagerly on the CPU
        ds = _dataset()
        noise = Recorded(7)
        res = evaluate.eval_vae(ds, rc, params=params, save=False,
                                noise=noise, device="cpu")
        for stage, means in _means(p, ds, noise.kept).items():
            for k, v in means.items():
                out[f"eval_vae.{stage}.{k}"] = (
                    abs(res[stage][k] - v) / abs(v), MEANS_RTOL)
    return out


def _thin_top_bin(n=64):
    """Bin logits [n, L, L] whose last bin holds about 3e-4 of the mass,
    and the cumsum's last entries (not all exactly 1)."""
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(n, L, L, generator=g)
    logits[..., -1] = -8.0
    return logits, torch.cumsum(torch.softmax(logits, -1), -1)[..., -1]


def _dataset():
    x, m, _ = _rows(26, 2)
    return Dataset(train=Split(x[:20], m[:20], "train"),
                   test=Split(x[20:], m[20:], "test"), obs_dim=D)


def _failed(found):
    return {k: g for k, (g, tol) in found.items()
            if not math.isfinite(g) or g > tol}


def test_the_port_agrees_with_the_reference():
    found = gaps()
    assert not _failed(found), found
    # the cases the inputs were chosen for were met
    assert (_thin_top_bin()[1] != 1.0).any()


def test_the_clamp_tails_map_as_zero_and_the_edges_land_in_their_bins():
    """In both, base noise outside [-1, 1] goes where 0 goes, with log q
    of its own base density; on an edge of the 4 bins a layer gives the
    cdf at that edge."""
    p = _weights()
    x, m, _ = _rows(1, 4)
    x, m = x.expand(4, D), m.expand(4, D)  # one row's bin logits, 4 times
    logits = ref.context(p, x, m)
    ctx = flow_vae.layers.flow_context_encoder_apply(_nested(p)["encoder"],
                                                     x, m)
    eps = torch.tensor([[3.0, -0.5, -1.0, 0.5], [0.0, -0.5, -1.0, 0.5],
                        [-3.0, -0.5, -1.0, 0.5], [1.0 + 1e-7, 0.0, 1.0, 0.0]])
    z, log_q = flowlib.flow_forward(eps, ctx, L)
    z_ref, log_q_ref = ref.flow(eps, logits)
    assert torch.equal(z, z_ref) and torch.equal(log_q, log_q_ref)
    base = -0.5 * eps.square() - 0.5 * math.log(2 * math.pi)
    assert (z[:, 0] == z[1, 0]).all()
    assert torch.allclose(log_q[:, 0] - base[:, 0],
                          (log_q[1, 0] - base[1, 0]).expand(4))
    y, ld = flowlib.unconstrained_linear_spline(eps, logits)
    y_ref, ld_ref = ref.spline(eps, logits)
    assert torch.equal(y, y_ref) and torch.equal(ld, ld_ref)
    _, cdf = ref._cdf(logits)
    assert y[1, 1] == cdf[1, 1, 1] * 2.0 - 1.0  # -0.5: bin 1 from its edge
    assert y[1, 2] == -1.0 and y[3, 2] == 1.0  # the interval's two ends
    assert y[1, 3] == cdf[1, 3, 3] * 2.0 - 1.0  # 0.5: bin 3 from its edge


@pytest.mark.parametrize("fault", ["two_layers", "no_top_edge", "tf32"])
def test_a_planted_fault_or_lower_precision_fails(fault, monkeypatch):
    """A flow of two spline layers, a cdf that keeps the cumulative sum's
    own last entry as its top edge, and the reference under TF32 each
    fail the comparison that the sound port passes."""
    mode = None
    if fault == "two_layers":
        monkeypatch.setattr(flowlib, "NUM_LAYERS", 2)
    elif fault == "no_top_edge":
        def normalize(unnormalized_pdf):
            pdf = torch.softmax(unnormalized_pdf, dim=-1)
            cdf = torch.cumsum(pdf, dim=-1)
            return pdf, torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)

        monkeypatch.setattr(flowlib, "_normalize_pdf", normalize)
    else:
        mode = "tf32"
    failed = _failed(gaps(mode))
    assert failed
    if fault == "no_top_edge":
        # the forward pass never reads the top edge; the inverse does
        assert "flow.log_prob_top" in failed
        assert set(failed) <= {"flow.log_prob", "flow.log_prob_top"}, failed
