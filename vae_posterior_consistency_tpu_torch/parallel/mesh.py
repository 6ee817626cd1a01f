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

Rows. Every engine that runs over a mesh without a collective in its
compute (the ensembles' replica axis, the AL test rows, the AIS chains, the
served request rows) dp-shards one leading axis the same way: the axis is
padded to a multiple of dp (`padded_rows`, the JAX package's `-(-n // dp)
* dp`), dp rank r holds the r-th equal block of it (`Rows`; the tp ranks of
one dp index hold the same rows, as JAX's P("dp", ...) replicates over tp),
its draws are made at the padded global shape and cut to its block
(`RankRows`), and its results are all-gathered over the dp group and cut
back to the real rows (`Rows.gather`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

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


# ---------------------------------------------------------------------------
# dp-sharded rows
# ---------------------------------------------------------------------------


def padded_rows(n: int, dp: int) -> int:
    """`n` rows rounded up to a multiple of `dp` (the JAX package's
    even-shard rule, `-(-n // dp) * dp`)."""
    return -(-n // dp) * dp


def pad_rows(t: torch.Tensor, padded: int, fill: float = 0.0) -> torch.Tensor:
    """`t` with rows of `fill` appended along axis 0 up to `padded` rows."""
    extra = padded - t.shape[0]
    if extra == 0:
        return t
    return torch.cat([t, t.new_full((extra, *t.shape[1:]), fill)])


@dataclasses.dataclass(frozen=True)
class Rows:
    """This rank's block of a dp-sharded leading axis: `n` real rows padded
    to `padded` (a multiple of dp), dp rank `r` holding rows [lo, hi).
    `group` is the dp process group the blocks are gathered over (None on
    one rank)."""

    n: int
    padded: int
    dp: int
    r: int
    group: object = None

    @property
    def local(self) -> int:
        return self.padded // self.dp

    @property
    def lo(self) -> int:
        return self.r * self.local

    @property
    def hi(self) -> int:
        return self.lo + self.local

    def pad(self, t: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
        """The global `t` (its `n` real rows along axis 0) with rows of
        `fill` up to `padded`."""
        return pad_rows(t, self.padded, fill)

    def weights(self, device=None) -> torch.Tensor:
        """This rank's block of the row weights, float32: 1 on a real row,
        0 on a padded one."""
        return (torch.arange(self.lo, self.hi, device=device)
                < self.n).to(torch.float32)

    def take(self, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This rank's block of the padded global `t` along `axis`."""
        return t.narrow(axis, self.lo, self.local)

    def gather(self, t: torch.Tensor, axis: int = 0,
               cut: bool = True) -> torch.Tensor:
        """The blocks `t` of every dp rank along `axis`, in rank order (an
        all-gather over the dp group), cut to the `n` real rows unless
        `cut` is False. Every rank of the group calls it."""
        if self.dp > 1:
            parts = [torch.empty_like(t) for _ in range(self.dp)]
            dist.all_gather(parts, t.contiguous(), group=self.group)
            t = torch.cat(parts, dim=axis)
        return t.narrow(axis, 0, self.n) if cut else t

    def gather_tree(self, params, cut: bool = True) -> dict:
        """`gather` of every leaf of nested `params` along axis 0."""
        from vae_posterior_consistency_tpu_torch.engine import checkpoint

        return checkpoint.unflatten({
            k: self.gather(v.detach(), cut=cut)
            for k, v in checkpoint.flatten(params).items()})

    def take_tree(self, params) -> dict:
        """`take` of every leaf of nested `params` along axis 0."""
        from vae_posterior_consistency_tpu_torch.engine import checkpoint

        return checkpoint.unflatten({
            k: self.take(v) for k, v in checkpoint.flatten(params).items()})


def rows_of(mesh: Optional[Mesh], n: int,
            padded: Optional[int] = None) -> Rows:
    """This rank's `Rows` of an axis of `n` rows on `mesh` (padded to
    `padded`, by default `padded_rows(n, dp)`); with no mesh, all of
    them."""
    if mesh is None:
        return Rows(n, n if padded is None else padded, 1, 0)
    dp = mesh.shape["dp"]
    padded = padded_rows(n, dp) if padded is None else padded
    if padded % dp:
        raise ValueError(f"{padded} rows do not divide over dp={dp}")
    return Rows(n, padded, dp, mesh.rank("dp"), mesh.group("dp"))


class RankRows:
    """A noise source handing this rank its rows. Asked for a draw of its
    own shape (the last positional argument: `noise(kind, ..., shape)`),
    it draws `dp` times as many rows along the kind's row axis
    `rows[kind]` from `noise` and returns block r of it, contiguous; a kind
    whose axis is None is shared and passes through whole, and a kind
    missing from `rows` raises KeyError. An ensemble source's `epoch(epoch,
    n, steps, shapes)` draws are cut the same way, each of its keys along
    its axis in `rows`."""

    def __init__(self, noise, rows: dict, dp: int, r: int):
        self.noise, self.rows, self.dp, self.r = noise, rows, dp, r

    def _axis(self, kind):
        if kind not in self.rows:
            raise KeyError(f"{kind!r} has no row axis in this rank's table "
                           f"{sorted(self.rows)} (None marks a shared draw)")
        return self.rows[kind]

    def _block(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        b = t.shape[axis] // self.dp
        return t.narrow(axis, self.r * b, b).contiguous()

    def __call__(self, kind, *args, **kw):
        axis = self._axis(kind)
        if axis is None:
            return self.noise(kind, *args, **kw)
        *lead, shape = args
        full = list(shape)
        full[axis] = shape[axis] * self.dp
        return self._block(self.noise(kind, *lead, tuple(full), **kw), axis)

    def epoch(self, epoch: int, n: int, steps: int, shapes: dict) -> dict:
        drawn = self.noise.epoch(epoch, n, steps, shapes)
        axes = {k: self._axis(k) for k in drawn}
        return {k: v if axes[k] is None else self._block(v, axes[k])
                for k, v in drawn.items()}
