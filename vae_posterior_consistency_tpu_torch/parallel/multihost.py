"""The process group of a multi-device run (port of the JAX package's
`parallel/multihost.py`).

JAX runs one controller that sees every device; a torch run is one process
a device, started by `torchrun`, which sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT. `initialize` joins the group those name (a
no-op without them, as JAX's is unconfigured), on NCCL for the card and
gloo for the CPU; the entry points call it once their `-device` is parsed
(ROADMAP C.4.22: the JAX entry points never call theirs). `ensure_group`
makes a world-size-1 group when a one-device mesh is asked for without
torchrun. Only the coordinator, rank 0, writes files and prints.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import torch
import torch.distributed as dist

#: the variables torchrun sets for each rank
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")

#: whether this module made the default group (and so destroys it)
_OWNED = False


def _init(device, **kw) -> None:
    """The default group on NCCL for a CUDA `device` (this rank's card
    bound to it), else on gloo. No fallback: an NCCL group that cannot be
    made raises."""
    global _OWNED
    from vae_posterior_consistency_tpu_torch.parallel.mesh import rank_device

    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **kw)
    _OWNED = True


def initialize(device="cuda") -> bool:
    """Join the process group torchrun's variables describe, this rank on
    `cuda:LOCAL_RANK` (or the CPU for a CPU `device`). A no-op when they
    are unset or a group exists. Returns whether it made the group."""
    if dist.is_initialized() or not all(os.environ.get(v)
                                        for v in TORCHRUN_ENV):
        return False
    _init(device, init_method="env://")
    return True


def ensure_group(device="cuda") -> None:
    """A default process group: the existing one, or a world-size-1 group
    on a file store in a fresh temporary directory."""
    if dist.is_initialized():
        return
    store = os.path.join(tempfile.mkdtemp(prefix="vpc_pg_"), "store")
    _init(device, init_method=f"file://{store}", rank=0, world_size=1)


def shutdown() -> None:
    """Destroy the default group if this module made it."""
    global _OWNED
    if _OWNED and dist.is_initialized():
        dist.destroy_process_group()
    _OWNED = False


def global_mesh(dp: int | None = None, tp: int | None = None,
                device="cuda"):
    """The (dp, tp) mesh over every rank of the group."""
    from vae_posterior_consistency_tpu_torch.parallel import mesh as meshlib

    return meshlib.make_mesh(dp=dp, tp=tp, device=device)


def shard_host_data(mesh, x: torch.Tensor):
    """This rank's rows `x` as its shard of the global dp-sharded batch (a
    DTensor placed [Shard(0), Replicate()]; every dp rank holds as many
    rows)."""
    from torch.distributed.tensor import DTensor

    from vae_posterior_consistency_tpu_torch.parallel.mesh import (
        batch_sharding,
    )

    return DTensor.from_local(x.to(mesh.device), mesh.device_mesh,
                              batch_sharding(mesh), run_check=False)


def is_coordinator() -> bool:
    """Rank 0 of the group, or True with no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier(device) -> None:
    """Wait on the host until every rank has reached this point (one
    all-reduce of a scalar, read back)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        flag = torch.zeros(1, device=device)
        dist.all_reduce(flag)
        flag.item()


@contextlib.contextmanager
def coordinator_stdout():
    """Standard output as it is on the coordinator, discarded elsewhere, so
    a run on N ranks prints its lines once."""
    if is_coordinator():
        yield
        return
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield
