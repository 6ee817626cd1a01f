"""Device-mesh construction and sharding rules (port of the JAX package's
`parallel/mesh.py`).

The JAX package is one controller over a `jax.sharding.Mesh` with two axes;
here a run is one process a device (`torchrun`), joined in a
`torch.distributed` process group, and the mesh is a `DeviceMesh` over the
group's ranks with the same two axes:

- `dp`: data parallelism. Each dp rank takes its rows of every batch, and
  the gradients are averaged over the dp group (`parallel/train_parallel`).
- `tp`: tensor parallelism. Parameter leaves at least `TP_MIN_DIM` wide are
  stored sharded over tp as DTensors, by JAX's rule leaf for leaf
  (`param_sharding_rule`); the ranks gather them to full tensors for the
  model's compute (ROADMAP C.4.23).

`make_mesh` returns a `Mesh`: the `DeviceMesh`, the rank's device, and a
`shape` mapping, so `dict(mesh.shape)` is `{'dp': 2, 'tp': 1}` as in JAX.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from vae_posterior_consistency_tpu_torch.engine import checkpoint

#: only shard parameter leaves at least this wide over `tp` (the JAX
#: package's threshold, kept so both packages shard the same leaves)
TP_MIN_DIM = 128

#: the mesh's axis names, in order
AXES = ("dp", "tp")


def factor_devices(n: int) -> tuple[int, int]:
    """Split n devices into (dp, tp): tp=2 when n >= 4 and even."""
    if n >= 4 and n % 2 == 0:
        return n // 2, 2
    return n, 1


@dataclasses.dataclass
class Mesh:
    """A (dp, tp) `DeviceMesh` over the process group's ranks and this
    rank's device."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    device: torch.device

    @property
    def shape(self) -> dict:
        return {name: self.device_mesh.size(i) for i, name in enumerate(AXES)}

    def rank(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of the ranks that share this rank's other
        coordinate (the dp group reduces the gradients)."""
        return self.device_mesh.get_group(axis)


def rank_device(device) -> torch.device:
    """This rank's device of type `device`: `cuda:LOCAL_RANK` (the current
    device when LOCAL_RANK is unset), or the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    if device.index is not None:
        return device
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None
                        else torch.cuda.current_device())


def make_mesh(devices=None, dp: int | None = None, tp: int | None = None,
              device="cuda") -> Mesh:
    """A (dp, tp) mesh over the ranks `devices` (all ranks of the default
    process group by default), rank r at position divmod(r, tp); (dp, tp)
    is `factor_devices(len(devices))` unless both are given."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    devices = (list(range(dist.get_world_size())) if devices is None
               else list(devices))
    n = len(devices)
    if dp is None or tp is None:
        dp, tp = factor_devices(n)
    assert dp * tp == n, f"dp({dp}) * tp({tp}) != devices({n})"
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dm = DeviceMesh(dev.type, np.asarray(devices).reshape(dp, tp).tolist(),
                    mesh_dim_names=AXES)
    return Mesh(dm, dev)


def batch_sharding(mesh: Mesh) -> list:
    """[B, D] batches: rows sharded over dp, features replicated."""
    from torch.distributed.tensor import Replicate, Shard

    del mesh
    return [Shard(0), Replicate()]


def param_sharding_rule(leaf, mesh: Mesh) -> list:
    """The tensor-parallel placements of one parameter leaf, the JAX
    package's rule (mesh.py:51-65): a [fan_in, fan_out] matrix shards
    fan_out over tp when it is at least TP_MIN_DIM wide, else fan_in when
    that is; a 1-D leaf at least TP_MIN_DIM long shards; everything else is
    replicated. Every leaf is replicated over dp."""
    from torch.distributed.tensor import Replicate, Shard

    del mesh
    shape = tuple(leaf.shape)
    if len(shape) == 2 and shape[1] >= TP_MIN_DIM:
        return [Replicate(), Shard(1)]
    if len(shape) == 2 and shape[0] >= TP_MIN_DIM:
        return [Replicate(), Shard(0)]
    if len(shape) == 1 and shape[0] >= TP_MIN_DIM:
        return [Replicate(), Shard(0)]
    return [Replicate(), Replicate()]


def params_shardings(params, mesh: Mesh) -> dict:
    """{flat key: placements} over `params` (`checkpoint.flatten`'s keys)."""
    return {k: param_sharding_rule(v, mesh)
            for k, v in checkpoint.flatten(params).items()}


def shard_params(params, mesh: Mesh) -> dict:
    """`params` (full tensors, the same on every rank) as DTensors on the
    mesh by `param_sharding_rule`, each rank keeping its shard, on the
    rank's device; nested as `params` is. The shards are copies: training
    them leaves `params` as it was."""
    from torch.distributed.tensor import distribute_tensor

    return checkpoint.unflatten({
        k: distribute_tensor(v.detach().to(mesh.device).clone(),
                             mesh.device_mesh, param_sharding_rule(v, mesh))
        for k, v in checkpoint.flatten(params).items()})


def full_params(params) -> dict:
    """DTensor leaves gathered to full tensors (autograd follows the
    gather); plain tensors pass as they are. Every rank of the mesh must
    call it."""
    from torch.distributed.tensor import DTensor

    return checkpoint.unflatten({
        k: v.full_tensor() if isinstance(v, DTensor) else v
        for k, v in checkpoint.flatten(params).items()})
