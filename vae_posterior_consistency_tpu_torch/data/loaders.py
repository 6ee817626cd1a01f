"""Dataset loading into tensors on one device (port of the JAX package's
`data/loaders.py`: the UCI MCAR pipeline and MNIST).

Reads the same artifacts as the JAX package with `torch.load`: `data.pt`,
`mask_{rate}_missing{i}.pt` and the `{train,test}_index{i}.csv` split
indices for UCI tables (reference: src/utils/loaders.py:319-354), and the
prebuilt `experiment_{train,test}_{data,mask}.pt` for MNIST (reference:
src/utils/loaders.py:249-316). Normalisation runs in numpy on the host, as
in the JAX package, so both packages see the same float32 values.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from vae_posterior_consistency_tpu_torch.config import parse_vae_type


@dataclasses.dataclass
class Split:
    """One data split, resident on one device."""

    x: torch.Tensor  # [N, D] float32
    mask: torch.Tensor  # [N, D] float32 observation mask (1 = observed)
    stage: str  # 'train' | 'test'

    @property
    def n(self) -> int:
        return self.x.shape[0]


@dataclasses.dataclass
class Dataset:
    train: Split
    test: "Split | None"
    obs_dim: int


def _load(path, device):
    t = torch.load(path, map_location="cpu", weights_only=True)
    return t.to(device=device, dtype=torch.float32)


def _load_np(path) -> np.ndarray:
    return np.asarray(torch.load(path, map_location="cpu", weights_only=True))


def _load_indices(path) -> np.ndarray:
    return np.loadtxt(path, delimiter=",", ndmin=1).astype(np.int64).reshape(
        -1)


def _transform(data: np.ndarray, how: str) -> np.ndarray:
    """minmax, or 'stand' with the Bessel-corrected std (torch's .std(0)
    default). The reference's unguarded divide is kept: a constant column
    gives NaN (reference: src/utils/loaders.py:327-336)."""
    if how == "minmax":
        lo, hi = data.min(axis=0), data.max(axis=0)
        return (data - lo) / (hi - lo)
    if how == "stand":
        return (data - data.mean(axis=0)) / data.std(axis=0, ddof=1)
    raise ValueError(f"data_transform must be 'minmax' or 'stand', got "
                     f"{how!r}")


def data_loader(data_path, vae_type, missing_rate, batch_size, data_type,
                data_transform="minmax", device="cuda") -> Dataset:
    """The UCI MCAR pipeline (reference: src/utils/loaders.py:319-354): the
    split index is the first digit of `vae_type` ('1' if none).
    `batch_size` is unused, as in the JAX package."""
    index = parse_vae_type(vae_type).split_index or "1"
    base = os.path.join(data_path, data_type)
    data = _load_np(os.path.join(base, "data.pt")).astype(np.float32)
    mask = _load_np(os.path.join(
        base, f"mask_{missing_rate}_missing{index}.pt")).astype(np.float32)
    data = _transform(data, data_transform)
    tr = _load_indices(os.path.join(base, f"train_index{index}.csv"))
    te = _load_indices(os.path.join(base, f"test_index{index}.csv"))

    def split(rows, stage):
        return Split(torch.from_numpy(np.ascontiguousarray(data[rows])).to(
                         device),
                     torch.from_numpy(np.ascontiguousarray(mask[rows])).to(
                         device),
                     stage)

    return Dataset(train=split(tr, "train"), test=split(te, "test"),
                   obs_dim=data.shape[1])


def data_loader_mnist(data_path, vae_type, missing_rate, batch_size,
                      data_type="mnist", data_transform="minmax",
                      device="cuda") -> Dataset:
    """Prebuilt MNIST artifacts (reference: src/utils/loaders.py:249-316).
    `vae_type`, `missing_rate`, `batch_size` and `data_transform` are unused,
    as in the JAX package: the artifacts fix the split and the mask."""
    base = os.path.join(data_path, data_type)

    def split(stage):
        return Split(_load(os.path.join(base, f"experiment_{stage}_data.pt"),
                           device),
                     _load(os.path.join(base, f"experiment_{stage}_mask.pt"),
                           device),
                     stage)

    return Dataset(train=split("train"), test=split("test"), obs_dim=28 * 28)
