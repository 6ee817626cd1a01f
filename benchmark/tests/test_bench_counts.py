"""The frozen FLOP and byte counts against `chip_smoke.py`'s functions and
the bounds PERF.md §6 records, at the shapes the paths launch."""

import ast
from pathlib import Path

import pytest

from counts import flops, kernels

ROOT = Path(__file__).resolve().parents[2]
FUNCS = ("_bound", "embed_pool_bound_ms", "embed_pool_bwd_bound_ms",
         "fused_posterior_bound_ms", "fused_posterior_bwd_bound_ms")


def _smoke():
    """chip_smoke.py's bound functions and peaks, taken from its source
    (importing it would start its watchdog)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name in FUNCS)
            or (isinstance(n, ast.Assign) and any(
                getattr(t, "id", "") in ("PEAK_BYTES_S", "PEAK_F32_S")
                for t in n.targets))]
    ns = {}
    exec(compile(ast.Module(keep, []), "chip_smoke", "exec"), ns)
    return ns


SHAPES = [  # (kernel, shape, chip_smoke function, its args, PERF.md ms)
    ("embed_pool_fwd", dict(S=2, B=64, D=784, K=10), "embed_pool_bound_ms",
     (2, 64, 784, 10), 0.000200),
    ("embed_pool_fwd", dict(S=1, B=64, D=784, K=10), "embed_pool_bound_ms",
     (1, 64, 784, 10), 0.000139),
    ("embed_pool_fwd", dict(S=1, B=512, D=784, K=10), "embed_pool_bound_ms",
     (1, 512, 784, 10), 0.000983),
    ("embed_pool_fwd", dict(S=1, B=64, D=13, K=10), "embed_pool_bound_ms",
     (1, 64, 13, 10), 0.000003),
    ("embed_pool_fwd", dict(S=1, B=10200, D=13, K=10), "embed_pool_bound_ms",
     (1, 10200, 13, 10), 0.000439),
    ("embed_pool_bwd", dict(S=2, B=64, D=784, K=10, dx=False, dmasks=False),
     "embed_pool_bwd_bound_ms", (2, 64, 784, 10, False, False), 0.000219),
    ("fused_posterior_fwd", dict(B=64, L=10), "fused_posterior_bound_ms",
     (64, 10), 0.000006),
    ("fused_posterior_bwd", dict(B=64, L=10), "fused_posterior_bwd_bound_ms",
     (64, 10), 0.000009),
]


@pytest.mark.parametrize("kernel,shape,fn,args,perf_ms", SHAPES)
def test_bounds_match_the_smoke(kernel, shape, fn, args, perf_ms):
    smoke = _smoke()
    assert smoke["PEAK_BYTES_S"] == kernels.PEAKS["bytes_per_s"]
    assert smoke["PEAK_F32_S"] == kernels.PEAKS["float32_flops_per_s"]
    seconds, what = kernels.KERNELS[kernel][0](**shape)
    ms, smoke_what = smoke[fn](*args)
    assert seconds * 1e3 == pytest.approx(ms, rel=1e-12)
    assert what == smoke_what
    assert round(seconds * 1e3, 6) == pytest.approx(perf_ms, abs=1e-6)


def test_least_seconds_sums_launches():
    shape = dict(S=1, B=64, D=784, K=10)
    one, _ = kernels.embed_pool_fwd(**shape)
    total, by = kernels.least_seconds([("embed_pool_fwd", shape, 7)])[
        "embed_pool_fwd"]
    assert total == pytest.approx(7 * one)
    assert by == {"bytes": 7, "operations": 0}


def test_flops_from_widths():
    cfg = {"obs_dim": 784, "K": 10, "latent_dim": 10,
           "encoder_trunk": [500, 500, 200], "decoder": [200, 500, 500]}
    dense_enc = 2 * (10 * 500 + 500 * 500 + 500 * 200 + 200 * 20)
    dense_dec = 2 * (10 * 200 + 200 * 500 + 500 * 500 + 500 * 784)
    embed = 2 * 784 * 10
    assert flops.encoder_row(cfg) == embed + embed + dense_enc
    assert flops.decoder_row(cfg) == dense_dec
    assert flops.eval_rows(cfg, 64) == (64 * (2 * embed + dense_enc
                                              + dense_dec)
                                        + 2 * 784 * 10 * 10)
    fwd = 64 * (embed + 2 * embed + 2 * dense_enc + 2 * dense_dec) + (
        2 * 784 * 10 * 10)
    assert flops.train_steps(cfg, 5, 64) == 3 * fwd * 5
