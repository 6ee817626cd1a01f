"""Convert MNIST's IDX files into the `.pt` files the MNIST loader reads
(port of the JAX package's `tools/convert_mnist_idx.py`).

The reference reads prebuilt `experiment_{train,test}_{data,mask}.pt`
tensors (src/utils/loaders.py:249-316). This tool builds them from the IDX
image files every MNIST mirror distributes (`train-images-idx3-ubyte[.gz]`,
`t10k-images-idx3-ubyte[.gz]`): pixels scaled to [0, 1] (the decoder ends
in a sigmoid, reference VAE.py:41-44) and seeded MCAR observation masks
from the data plane's xorshift128+ stream (`data/native_io.mcar_mask`, at
`seed` for train and `seed + 1` for test), so the files are the same bytes
on every host and in both packages. `data/loaders.data_loader_mnist` reads
them, or `data/generate`'s stand-in where there are none.

Usage:
  python -m vae_posterior_consistency_tpu_torch.tools.convert_mnist_idx \\
      --train_images path/to/train-images-idx3-ubyte.gz \\
      --test_images  path/to/t10k-images-idx3-ubyte.gz \\
      [--out Data/mnist] [--missing_rate 30] [--seed 1234]
"""

from __future__ import annotations

import argparse
import gzip
import os
import struct

import numpy as np
import torch

from vae_posterior_consistency_tpu_torch.data import native_io


def read_idx_images(path: str) -> np.ndarray:
    """An IDX3 image file (gzipped or not) -> float32 [N, rows*cols] in
    [0, 1]. ValueError for another magic number or a truncated file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        magic, n, rows, cols = struct.unpack(">IIII", fh.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: not an IDX3 image file "
                             f"(magic {magic}, expected 2051)")
        buf = fh.read(n * rows * cols)
    if len(buf) != n * rows * cols:
        raise ValueError(f"{path}: truncated — {len(buf)} bytes for "
                         f"{n}x{rows}x{cols}")
    x = np.frombuffer(buf, np.uint8).reshape(n, rows * cols)
    return x.astype(np.float32) / 255.0


def convert(train_images: str, test_images: str, out: str,
            missing_rate: int = 30, seed: int = 1234) -> None:
    """Write out/experiment_{train,test}_{data,mask}.pt: the images float32
    [N, 784], the masks bool (True = observed)."""
    os.makedirs(out, exist_ok=True)
    for stage, path, mask_seed in (("train", train_images, seed),
                                   ("test", test_images, seed + 1)):
        x = read_idx_images(path)
        mask = native_io.mcar_mask(x.shape, missing_rate, mask_seed) > 0.5
        torch.save(torch.from_numpy(x),
                   os.path.join(out, f"experiment_{stage}_data.pt"))
        torch.save(torch.from_numpy(mask),
                   os.path.join(out, f"experiment_{stage}_mask.pt"))
        print(f"{stage}: {x.shape[0]} images x {x.shape[1]} px, "
              f"observed {float(mask.mean()):.3f} -> {out}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--train_images", required=True)
    ap.add_argument("--test_images", required=True)
    ap.add_argument("--out", default="Data/mnist")
    ap.add_argument("--missing_rate", type=int, default=30)
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args(argv)
    convert(args.train_images, args.test_images, args.out,
            args.missing_rate, args.seed)


if __name__ == "__main__":
    main()
