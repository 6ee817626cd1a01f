"""Dataset loading into tensors on one device (port of the JAX package's
`data/loaders.py`; MNIST so far).

Reads the same `experiment_{train,test}_{data,mask}.pt` artifacts as the JAX
package (reference: src/utils/loaders.py:249-316) with `torch.load`.
"""

from __future__ import annotations

import dataclasses
import os

import torch


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
