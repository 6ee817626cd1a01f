"""The port's MIWAE evaluation (`vanilla_MIWAE1`) against the benchmark's
plain reference, `benchmark/reference/miwae.py` (plain torch, written from
the published model and the reference class; loaded by path), on seeded
random weights on the CPU: `eval_step`'s rows and `eval_vae`'s eight means
agree; the reference's TF32 control does not; and the reference reads NaN
where the program would score another number of importance samples than
the configuration states.

Sizes: D=13 (wine), batches of 16 rows, K=64 importance samples.

Tolerance, rtol 1e-5: both sides compute the same float32 mathematics in
other orders (the reference takes the densities from torch.distributions,
whose Student-t sums its terms otherwise, and the imputation as a
product, where the port has an einsum; the blocks of rows), so a row's
numbers agree to a few float32 quanta after two 128-wide layers, a sum of
13 cells and a logsumexp over K (1e-7 to 3e-6 relative here, the larger
on a row loss near 0, which K=64 allows: the bound has no -log K). TF32's
10-bit operands move them by 1e-5 to 1e-2.
"""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

from vae_posterior_consistency_tpu_torch.config import RunConfig
from vae_posterior_consistency_tpu_torch.data.loaders import Dataset, Split
from vae_posterior_consistency_tpu_torch.engine import checkpoint, evaluate
from vae_posterior_consistency_tpu_torch.models import miwae

RTOL = 1e-5
D, L, K, BATCH = 13, 10, 64, 16
METRICS = ("rmse", "loss", "negl", "negl_imp")


def _load_reference():
    path = (Path(__file__).resolve().parents[1] / "benchmark" / "reference"
            / "miwae.py")
    spec = importlib.util.spec_from_file_location("miwae_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_reference()

#: the reference's configuration dict at this size
CFG = {"obs_dim": D, "latent_dim": L, "encoder_trunk": [128, 128],
       "decoder": [128, 128], "valid_k": K}


@pytest.fixture(scope="module")
def weights():
    """Flat parameters {"encoder/layer0/w": ...}, each leaf U(+-bound) as
    the reference's `param_specs` states, from a seeded generator."""
    g = torch.Generator().manual_seed(24)
    return {key: (torch.rand(shape, generator=g) * 2.0 - 1.0) * bound
            for key, shape, bound in ref.param_specs(CFG)}


def _table(g, n):
    x = torch.rand(n, D, generator=g)
    mask = (torch.rand(n, D, generator=g) >= 0.5).float()
    return x, mask


def _gap(a, b):
    return float(((a - b).abs() / b.abs()).max())


def test_param_specs_are_the_ports_leaves():
    cfg = RunConfig(vae_type="vanilla_MIWAE1")
    port = checkpoint.flatten(miwae.init(torch.Generator().manual_seed(0),
                                         cfg, D, device="cpu"))
    specs = {key: tuple(shape) for key, shape, _ in ref.param_specs(CFG)}
    assert specs == {key: tuple(t.shape) for key, t in port.items()}


def test_eval_step_rows_match_the_reference(weights):
    g = torch.Generator().manual_seed(1)
    x, mask = _table(g, BATCH)
    eps = torch.randn(BATCH, K, L, generator=g)
    cfg = RunConfig(vae_type="vanilla_MIWAE1", valid_k=K)
    with torch.no_grad():
        out = miwae.eval_step(checkpoint.unflatten(weights), x, mask, None,
                              eps, cfg)
    r = ref.eval_rows(weights, CFG, x, mask, eps)
    for port_key, ref_key in (("x_imputed", "x_imputed"), ("row_loss", "loss"),
                              ("row_negl", "negl"),
                              ("row_negl_imp", "negl_imp")):
        torch.testing.assert_close(out[port_key], r[ref_key], rtol=RTOL,
                                   atol=0.0, msg=port_key)


class _Recorder:
    """A noise source that keeps each draw, in order."""

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)
        self.kept = []

    def __call__(self, kind, rep, step, shape):
        if kind == "perm":
            t = torch.randperm(shape[0], generator=self.gen)
        else:
            t = torch.randn(shape, generator=self.gen)
        self.kept.append((kind, t))
        return t


def _reference_means(weights, ds, cfg, draws, mode="fp32"):
    """{stage: {metric: mean}} of the reference over the draws `eval_vae`
    made, split by split and rep by rep as the program batches them."""
    draws = iter(draws)
    out = {}
    for split in (ds.train, ds.test):
        bsz = min(cfg.batch_size, split.n)
        steps = -(-split.n // bsz)
        reps = []
        for _ in range(cfg.M):
            kind, perm = next(draws)
            assert kind == "perm"
            eps = torch.cat([next(draws)[1] for _ in range(steps)])
            with ref.precision(mode):
                stats, _ = ref.evaluate_split(weights, CFG, split.x,
                                              split.mask, perm, eps, bsz)
            reps.append(stats.mean(0))
        out[split.stage] = dict(zip(METRICS,
                                    torch.stack(reps).mean(0).tolist()))
    return out


@pytest.fixture(scope="module")
def evaluated(weights):
    g = torch.Generator().manual_seed(2)
    x, mask = _table(g, 34)
    ds = Dataset(train=Split(x[:24], mask[:24], "train"),
                 test=Split(x[24:], mask[24:], "test"), obs_dim=D)
    cfg = RunConfig(vae_type="vanilla_MIWAE1", valid_k=K, batch_size=BATCH,
                    M=2)
    noise = _Recorder(3)
    res = evaluate.eval_vae(ds, cfg, params=checkpoint.unflatten(weights),
                            save=False, noise=noise, device="cpu")
    return ds, cfg, res, noise.kept


def test_eval_vae_means_match_the_reference(weights, evaluated):
    ds, cfg, res, draws = evaluated
    # a perm a rep and split, one draw a batch: 2 x (1 + 2) + 2 x (1 + 1)
    assert len(draws) == 10
    want = _reference_means(weights, ds, cfg, draws)
    for stage in ("train", "test"):
        for k in METRICS:
            assert res[stage][k] == pytest.approx(want[stage][k], rel=RTOL,
                                                  abs=0.0), (stage, k)


def test_the_tf32_control_differs_by_more_than_the_tolerance(weights,
                                                             evaluated):
    ds, cfg, res, draws = evaluated
    ctl = _reference_means(weights, ds, cfg, draws, mode="tf32")
    gap = max(abs(res[s][k] - ctl[s][k]) / abs(ctl[s][k])
              for s in ("train", "test") for k in METRICS)
    assert gap > RTOL


def test_the_tf32_control_moves_the_rows(weights):
    g = torch.Generator().manual_seed(4)
    x, mask = _table(g, BATCH)
    eps = torch.randn(BATCH, K, L, generator=g)
    r = ref.eval_rows(weights, CFG, x, mask, eps)
    with ref.precision("tf32"):
        t = ref.eval_rows(weights, CFG, x, mask, eps)
    assert max(_gap(t[k], r[k]) for k in ("x_imputed", "loss", "negl")) > (
        RTOL)


@pytest.mark.parametrize("k", [K // 2, K + 1])
def test_another_k_than_valid_k_reads_nan(weights, k):
    g = torch.Generator().manual_seed(5)
    x, mask = _table(g, 20)
    perm = torch.randperm(20, generator=g)
    eps = torch.randn(2 * BATCH, k, L, generator=g)
    stats, _ = ref.evaluate_split(weights, CFG, x, mask, perm, eps, BATCH)
    assert stats.shape == (2, 4)
    assert all(math.isnan(v) for v in stats.flatten().tolist())


def test_blocks_do_not_move_a_row(weights, monkeypatch):
    """Rows taken one at a time give what a whole batch gives: every
    statistic is a row's own."""
    g = torch.Generator().manual_seed(6)
    x, mask = _table(g, 5)
    eps = torch.randn(5, K, L, generator=g)
    whole = ref.eval_rows(weights, CFG, x, mask, eps)
    monkeypatch.setattr(ref, "BLOCK_SAMPLES", K)
    single = ref.eval_rows(weights, CFG, x, mask, eps)
    for key in whole:
        torch.testing.assert_close(single[key], whole[key], rtol=RTOL,
                                   atol=0.0)
