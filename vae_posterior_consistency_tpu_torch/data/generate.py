"""Fabricate the per-dataset artifact files the experiment pipeline reads
(port of the JAX package's `data/generate.py`: from the same seed, the
same tensors and index files).

The reference expects pre-built artifacts under `Data/<data_type>/` that are not
shipped with it (reference: src/utils/loaders.py:322-326, 361-366;
src/experiment_main/active_learning.py:35-45):

    data.pt                     [N, D] float tensor
    mask_<rate>_missing<i>.pt   [N, D] bool MCAR observation mask, i in {1,2,3}
    mnar_mask_missing<i>.pt     [N, D] float32 MNAR observation mask (reference generators emit float)
    rand_perm<i>.pt             [N] long permutation
    train_index<i>.csv / test_index<i>.csv   row-index lists

and for MNIST: experiment_{train,test}_{data,mask}.pt
(reference: src/utils/loaders.py:285-289).

This module generates all of them from offline sources (sklearn's bundled wine /
digits / breast-cancer datasets, or synthetic tables), saved with `torch.save`
so the artifact format is interchangeable with the reference's. sklearn is
imported inside the functions that need it: the rest of the port runs
without it.

Usage:  python3 -m vae_posterior_consistency_tpu_torch.data.generate [--tiny] [--root Data]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def _source_table(data_type: str, rng: np.random.Generator) -> np.ndarray:
    if data_type == "wine":
        # GENUINE data: sklearn's bundled UCI *wine* table (178 x 13 real
        # chemical measurements). NOTE this is a different, much smaller
        # dataset than the reference author's UCI *wine-quality* tensors
        # (~4.9k x 12, not shipped and not obtainable offline) — see the
        # data-fidelity banner in RESULTS.md.
        from sklearn.datasets import load_wine

        return load_wine().data.astype(np.float32)  # [178, 13]
    if data_type == "digits":
        # GENUINE data: sklearn's bundled UCI handwritten-digits table
        # (1797 x 64 = flattened real 8x8 grayscale scans, scaled to [0,1]).
        # 10x the rows and 5x the dims of wine — the closest genuine,
        # offline-available analogue to the reference's MNIST regime
        # (reference: src/utils/loaders.py:249-316).
        from sklearn.datasets import load_digits

        x = load_digits().data.astype(np.float32) / 16.0  # [1797, 64]
        # drop the 3 zero-range pixel columns (0, 32, 39 — always-blank
        # border pixels): minmax normalization divides by (max - min) in
        # BOTH stacks (reference src/utils/loaders.py:327-336) and is
        # undefined on constant columns. Values stay genuine; [1797, 61].
        return x[:, (x.max(0) - x.min(0)) > 0]
    if data_type == "cancer":
        # GENUINE data: sklearn's bundled UCI breast-cancer-Wisconsin table
        # (569 x 30 real cell-nucleus measurements). A second real-world
        # table at a different shape point than wine (178x13) and digits
        # (1797x61): mid-size rows, 30 heterogeneous-scale columns (minmax
        # normalization in both stacks handles the scale spread,
        # reference src/utils/loaders.py:327-336).
        from sklearn.datasets import load_breast_cancer

        x = load_breast_cancer().data.astype(np.float32)  # [569, 30]
        return x[:, (x.max(0) - x.min(0)) > 0]
    if data_type == "synth_small":
        # tiny correlated Gaussian table for fast tests / verification drives
        n, d = 120, 6
        w = rng.normal(size=(3, d))
        z = rng.normal(size=(n, 3))
        return (z @ w + 0.1 * rng.normal(size=(n, d))).astype(np.float32)
    if data_type == "synth":
        n, d = 4096, 12
        w = rng.normal(size=(4, d))
        z = rng.normal(size=(n, 4))
        return (z @ w + 0.1 * rng.normal(size=(n, d))).astype(np.float32)
    raise ValueError(f"unknown data_type {data_type!r}")


def _mnar_mask(x: np.ndarray) -> np.ndarray:
    """MNAR: hide cells above the column mean in the first D/2 features
    (mirrors reference src/utils/utils.py:48-60)."""
    n, d = x.shape
    # float32, not bool: the reference's own MNAR generators build the mask
    # with torch.ones_like(X) (float) + zeroing (utils.py:48-60), and its
    # REG_notMIWAE_v2 loss computes `1 - mask` which torch rejects for bool
    # tensors (VAE.py:2407) — bool MNAR artifacts could never have been what
    # the author ran with. MCAR artifacts stay bool (utils.py:36-39).
    mask = np.ones((n, d), dtype=np.float32)
    half = d // 2
    mask[:, :half] = x[:, :half] <= x[:, :half].mean(axis=0)
    return mask


def generate_uci(root: str, data_type: str, rates=(30, 50), n_splits=3,
                 test_frac=0.1, seed=1234) -> None:
    rng = np.random.default_rng(seed)
    x = _source_table(data_type, rng)
    n = x.shape[0]
    out = os.path.join(root, data_type)
    os.makedirs(out, exist_ok=True)
    torch.save(torch.from_numpy(x), os.path.join(out, "data.pt"))
    for i in range(1, n_splits + 1):
        perm = rng.permutation(n)
        n_test = max(1, int(n * test_frac))
        test_idx, train_idx = perm[:n_test], perm[n_test:]
        np.savetxt(os.path.join(out, f"train_index{i}.csv"), train_idx[None],
                   delimiter=",", fmt="%d")
        np.savetxt(os.path.join(out, f"test_index{i}.csv"), test_idx[None],
                   delimiter=",", fmt="%d")
        rand_perm = rng.permutation(n)
        torch.save(torch.from_numpy(rand_perm),
                   os.path.join(out, f"rand_perm{i}.pt"))
        for rate in rates:
            mcar = rng.random(x.shape) < (1.0 - rate / 100.0)
            torch.save(torch.from_numpy(mcar),
                       os.path.join(out, f"mask_{rate}_missing{i}.pt"))
        # the MNAR loader permutes data rows by rand_perm<i> but loads the
        # mask unpermuted (reference: src/utils/loaders.py:362-366), so the
        # artifact must be generated from the PERMUTED table for mask row r
        # to describe data row perm[r] — otherwise the missingness decorrelates
        # from the values and the "MNAR" experiment is silently MCAR
        torch.save(torch.from_numpy(_mnar_mask(x[rand_perm])),
                   os.path.join(out, f"mnar_mask_missing{i}.pt"))


def generate_mnist(root: str, rate=30, seed=1234) -> None:
    """Stand-in 784-dim image table from sklearn's bundled digits (8x8 upsampled
    to 28x28) — the reference's MNIST artifacts were likewise built offline.

    GENUINE MNIST takes precedence: if the artifact files already exist (e.g.
    converted from real IDX downloads), they are left untouched — this
    generator only fills the gap on hosts with no dataset."""
    out_dir = os.path.join(root, "mnist")
    expected = [
        os.path.join(out_dir, f"experiment_{s}_{k}.pt")
        for s in ("train", "test") for k in ("data", "mask")
    ]
    present = [p for p in expected if os.path.exists(p)]
    if len(present) == len(expected):
        return
    if present:
        # a PARTIAL set (e.g. an interrupted convert_mnist_idx.py run) must
        # not be silently completed with stand-ins, nor overwritten — either
        # would mix genuine and fabricated tensors under one dataset
        missing = sorted(set(expected) - set(present))
        raise FileExistsError(
            f"partial MNIST artifact set in {out_dir}: "
            f"{[os.path.basename(p) for p in present]} exist but "
            f"{[os.path.basename(p) for p in missing]} do not — finish the "
            "genuine conversion or delete the "
            "partial files to regenerate stand-ins"
        )
    rng = np.random.default_rng(seed)
    from sklearn.datasets import load_digits

    imgs = load_digits().images.astype(np.float32) / 16.0  # [N, 8, 8]
    up = np.kron(imgs, np.ones((1, 3, 3), np.float32))  # [N, 24, 24]
    pad = np.zeros((up.shape[0], 28, 28), np.float32)
    pad[:, 2:26, 2:26] = up
    x = pad.reshape(-1, 784)
    n_test = max(1, x.shape[0] // 10)
    perm = rng.permutation(x.shape[0])
    splits = {"test": perm[:n_test], "train": perm[n_test:]}
    out = os.path.join(root, "mnist")
    os.makedirs(out, exist_ok=True)
    for stage, idx in splits.items():
        mask = rng.random((len(idx), 784)) < (1.0 - rate / 100.0)
        torch.save(torch.from_numpy(x[idx]),
                   os.path.join(out, f"experiment_{stage}_data.pt"))
        torch.save(torch.from_numpy(mask),
                   os.path.join(out, f"experiment_{stage}_mask.pt"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default="Data")
    ap.add_argument("--tiny", action="store_true",
                    help="only generate the synth_small test dataset")
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args(argv)
    if args.tiny:
        generate_uci(args.root, "synth_small", seed=args.seed)
        return
    for ds in ("wine", "digits", "cancer", "synth_small", "synth"):
        generate_uci(args.root, ds, seed=args.seed)
    generate_mnist(args.root, seed=args.seed)
    print(f"artifacts written under {args.root}/")


if __name__ == "__main__":
    main()
