"""The port's not-MIWAE MNAR evaluation (`reg_notMIWAE1`, `eval_vae_mnar`)
against the benchmark's plain reference, `benchmark/reference/notmiwae.py`
(plain torch, written from the published model and the reference class;
loaded by path), on seeded random weights on the CPU: `eval_step`'s rows
(the imputation, the row bound, the row's negative likelihood) for both
`not_miwae_type` variants under the configuration's missingness process
('selfmasking_known'; the reference leaves the other two out), and
`eval_vae_mnar`'s RMSE over two reps, agree; the reference's TF32 control
and the two planted faults (half of the samples, log p(s|x) left out) do
not; and the reference reads NaN where the program would score another
number of importance samples than the configuration states.

Sizes: D=12 (wine less its target), 20 rows, K=64 importance samples, an
MNAR mask by the program's rule (the first 6 features hidden above their
column's mean).

Tolerance, rtol 5e-6 on a row's numbers: both sides compute the same
float32 mathematics in other orders (the reference takes the densities
from torch.distributions, whose Normal takes log(exp(logvar / 2)) where
the port has logvar / 2, the Bernoulli's log-pmf as a binary cross
entropy, and the imputation as a product, where the port has an einsum),
so a row's numbers agree to a few float32 quanta after two 128-wide
layers, sums over 12 cells and 10 latents and a logsumexp over K (up to
about 6e-7 relative here). The imputation is held to 5e-6 of the largest
imputed value: under 'author' its linear mean head gives terms of both
signs, whose weighted sum can lie near 0 (1e-7 absolute, 3e-4 relative
there). The RMSE, one mean over 62 holes, agrees to 1e-6 (here to the
bit). TF32's 10-bit operands move a row's numbers by 2e-6 to 1e-4 (their
largest gap is the test's) and the RMSE by 6.5e-6, the faults by more.
"""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.engine import checkpoint, evaluate
from vae_posterior_consistency_tpu_torch.models import notmiwae

RTOL = 5e-6
RMSE_RTOL = 1e-6
D, L, K, N = 12, 10, 64, 20
VARIANTS = ("changed", "author")


def _load_reference():
    path = (Path(__file__).resolve().parents[1] / "benchmark" / "reference"
            / "notmiwae.py")
    spec = importlib.util.spec_from_file_location("notmiwae_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_reference()


def _cfg(variant="changed"):
    """The reference's configuration dict at this size."""
    return {"obs_dim": D, "latent_dim": L, "encoder_trunk": [128, 128],
            "decoder_trunk": [128, 128], "valid_k": K,
            "not_miwae_type": variant, "missing_process": "selfmasking_known"}


def _run_cfg(variant="changed", **kw):
    return RunConfig(vae_type="reg_notMIWAE1", valid_k=K,
                     not_miwae_type=variant, **kw)


def _weights(seed=28):
    """Flat parameters {"encoder/trunk/layer0/w": ...}, each leaf
    U(+-bound) as the reference's `param_specs` states."""
    g = torch.Generator().manual_seed(seed)
    return {key: (torch.rand(shape, generator=g) * 2.0 - 1.0) * bound
            for key, shape, bound in ref.param_specs(_cfg())}


def _table(g, n=N):
    """Rows in [0, 1] and their MNAR mask: the first D // 2 features hidden
    above their column's mean (the program's `data/generate._mnar_mask`)."""
    x = torch.rand(n, D, generator=g)
    mask = torch.ones(n, D)
    head = x[:, :D // 2]
    mask[:, :D // 2] = (head <= head.mean(0)).float()
    return x, mask


def _gap(a, b):
    return float(((a - b).abs() / b.abs()).max())


def test_param_specs_are_the_ports_leaves():
    """The port's init also holds the 'linear' process's map, which the
    configuration's process does not read."""
    port = checkpoint.flatten(notmiwae.init(
        torch.Generator().manual_seed(0), _run_cfg(), D, device="cpu"))
    specs = {key: tuple(shape) for key, shape, _ in ref.param_specs(_cfg())}
    assert specs == {key: tuple(t.shape) for key, t in port.items()
                     if not key.startswith("logits_lin/")}


@pytest.mark.parametrize("variant", VARIANTS)
def test_eval_step_rows_match_the_reference(variant):
    weights = _weights()
    g = torch.Generator().manual_seed(1)
    x, mask = _table(g)
    eps = torch.randn(N, K, L, generator=g)
    with torch.no_grad():
        out = notmiwae.eval_step(checkpoint.unflatten(weights), x, mask,
                                 None, eps, _run_cfg(variant))
    r = ref.eval_rows(weights, _cfg(variant), x, mask, eps)
    scale = float(r["x_imputed"].abs().max())
    torch.testing.assert_close(out["x_imputed"], r["x_imputed"], rtol=RTOL,
                               atol=RTOL * scale)
    for port_key, ref_key in (("row_loss", "loss"), ("row_negl", "negl"),
                              ("row_negl_imp", "negl")):
        torch.testing.assert_close(out[port_key], r[ref_key], rtol=RTOL,
                                   atol=0.0, msg=port_key)


class _Recorder:
    """A noise source that keeps each draw, in order."""

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)
        self.kept = []

    def __call__(self, kind, rep, step, shape):
        t = torch.randn(shape, generator=self.gen)
        self.kept.append((kind, t))
        return t


def _evaluated(variant, M=2):
    weights = _weights()
    x, mask = _table(torch.Generator().manual_seed(2))
    noise = _Recorder(3)
    rmse = evaluate.eval_vae_mnar(x, mask, _run_cfg(variant, M=M),
                                  params=checkpoint.unflatten(weights),
                                  save=False, noise=noise, device="cpu")
    return weights, x, mask, rmse, noise.kept


def _reference_rmse(weights, variant, x, mask, draws, mode="fp32",
                    with_s=True):
    with ref.precision(mode):
        reps = [ref.evaluate(weights, _cfg(variant), x, mask, eps,
                             with_s=with_s)["rmse"] for _, eps in draws]
    return float(torch.stack(reps).mean())


@pytest.mark.parametrize("variant", VARIANTS)
def test_eval_vae_mnar_rmse_matches_the_reference(variant):
    weights, x, mask, rmse, draws = _evaluated(variant)
    # one eps a rep, nothing else: the family's eval_noise
    assert [kind for kind, _ in draws] == ["eps", "eps"]
    assert all(t.shape == (N, K, L) for _, t in draws)
    want = _reference_rmse(weights, variant, x, mask, draws)
    assert rmse == pytest.approx(want, rel=RMSE_RTOL, abs=0.0)


def test_the_tf32_control_differs_by_more_than_the_tolerance():
    weights, x, mask, rmse, draws = _evaluated("changed")
    ctl = _reference_rmse(weights, "changed", x, mask, draws, mode="tf32")
    assert abs(rmse - ctl) / abs(ctl) > RMSE_RTOL
    g = torch.Generator().manual_seed(4)
    x, mask = _table(g)
    eps = torch.randn(N, K, L, generator=g)
    r = ref.eval_rows(weights, _cfg(), x, mask, eps)
    with ref.precision("tf32"):
        t = ref.eval_rows(weights, _cfg(), x, mask, eps)
    assert max(_gap(t[k], r[k]) for k in ("x_imputed", "loss", "negl")) > (
        RTOL)


def test_half_of_the_samples_is_caught(monkeypatch):
    """The planted fault `half_k`: each rep's `eval_step` sees only the
    first K / 2 samples."""
    mnar_rmse = evaluate._mnar_rmse
    monkeypatch.setattr(
        evaluate, "_mnar_rmse",
        lambda model, cfg, params, x, mask, mask_p, eps: mnar_rmse(
            model, cfg, params, x, mask, mask_p, eps[:, :K // 2]))
    weights, x, mask, rmse, draws = _evaluated("changed")
    want = _reference_rmse(weights, "changed", x, mask, draws)
    assert abs(rmse - want) / abs(want) > 10 * RMSE_RTOL


def test_leaving_out_the_missingness_model_is_caught(monkeypatch):
    """The planted fault `no_missingness`: log p(s|x) is left out of l_w.
    The reference without it agrees with the faulty program; with it, it
    does not."""
    branch = notmiwae._branch
    monkeypatch.setattr(notmiwae, "_branch", lambda *a, **k: branch(
        *a, **{**k, "with_s": False}))
    weights, x, mask, rmse, draws = _evaluated("changed")
    want = _reference_rmse(weights, "changed", x, mask, draws)
    assert abs(rmse - want) / abs(want) > 10 * RMSE_RTOL
    without = _reference_rmse(weights, "changed", x, mask, draws,
                              with_s=False)
    assert rmse == pytest.approx(without, rel=RMSE_RTOL, abs=0.0)


@pytest.mark.parametrize("k", [K // 2, K + 1])
def test_another_k_than_valid_k_reads_nan(k):
    g = torch.Generator().manual_seed(5)
    x, mask = _table(g)
    eps = torch.randn(N, k, L, generator=g)
    r = ref.evaluate(_weights(), _cfg(), x, mask, eps)
    assert math.isnan(float(r["rmse"]))
    assert torch.isnan(r["x_imputed"]).all()


def test_blocks_do_not_move_a_row(monkeypatch):
    """Samples taken a few at a time give what one block gives: the
    reductions over K run once, at the end."""
    weights = _weights()
    g = torch.Generator().manual_seed(6)
    x, mask = _table(g)
    eps = torch.randn(N, K, L, generator=g)
    whole = ref.eval_rows(weights, _cfg(), x, mask, eps)
    monkeypatch.setattr(ref, "BLOCK_SAMPLES", 3 * N)
    blocks = ref.eval_rows(weights, _cfg(), x, mask, eps)
    for key in whole:
        torch.testing.assert_close(blocks[key], whole[key], rtol=RTOL,
                                   atol=0.0)
