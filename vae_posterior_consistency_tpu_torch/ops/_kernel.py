"""The seam between the port's kernel wrappers and their C entry points.

Each wrapper module (`fused_posterior`: B1 and its backward;
`fused_embed_pool`: B2f, B2b; `fused_iw`: IW1; `fused_iw_mnar`: IW2, which
shares IW1's source and skeleton; `fused_flow`: F1) keeps its kernel's
contract: the plain version, the shape checks and, where the kernel is
reached under autograd or vmap, the autograd Function and its vmap rule. What lies between that contract and the C entry point is here, once:

- `entry`: a C entry point of a `csrc/*.cu` library (`_build`), bound at its
  first call, so nothing is built or loaded at import. A launch passes the
  device index and the device's current stream, raises on a CUDA error and
  is counted in `launches` under the kernel's name;
- `PLAIN`: each kernel's plain version under the same name;
- the checks and layouts every kernel takes: `on_cpu`, `check_inputs`,
  `columns`, `replica_slices`, `sm_count`;
- the vmap rule that folds a vmapped axis into the kernels' replica axis:
  `logical_dim`, `fold_replicas`, `unfold_replicas`.

Launches are counted here, not through `utils/tracing`: the tests and
`chip_smoke.py` read exact counts without a profiler, and `tracing.count`
records only while one runs.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from vae_posterior_consistency_tpu_torch.ops import _build

#: launches of each kernel on the card: embed_pool_fwd, embed_pool_bwd,
#: fused_posterior_fwd, fused_posterior_bwd, iw_fused (IW1), iw_mnar (IW2),
#: flow_spline (F1)
launches: collections.Counter = collections.Counter()
#: each kernel's plain version, under its name in `launches`. The wrappers
#: call their plain versions by their module's name at each call, so one
#: patched in the module is the one that runs.
PLAIN: dict = {}


def entry(stem, symbol, argtypes, counter, plain):
    """`symbol` of `csrc/<stem>.cu` as launch(device, *args): `argtypes` are
    its arguments before the device index and the stream, which the launch
    appends. Registers `plain` as the kernel's plain version in `PLAIN`."""
    PLAIN[counter] = plain

    @functools.cache
    def bind():
        lib = _build.library(stem)
        fn = getattr(lib, symbol)
        fn.argtypes = [*argtypes, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return lib, fn

    def launch(device, *args):
        lib, fn = bind()
        code = fn(*args, device.index,
                  torch.cuda.current_stream(device).cuda_stream)
        if code != 0:
            msg = lib.vpc_error_string(code).decode()
            raise RuntimeError(f"{counter} kernel launch: CUDA error {code} "
                               f"({msg})")
        launches[counter] += 1

    return launch


def on_cpu(*tensors) -> bool:
    """Whether every tensor given (None skipped) is on the CPU: the plain
    versions take those, the kernels everything else or raise."""
    return all(t.device.type == "cpu" for t in tensors if t is not None)


def check_inputs(what, tensors):
    """The contract every kernel shares: the tensors (None skipped, the
    first given not None) on one CUDA device, float32. Shapes are each
    kernel's own. Inputs that pass take one loop, no set or list: the
    check runs on every launch."""
    device = tensors[0].device
    for t in tensors:
        if t is not None and (t.device != device
                              or t.dtype != torch.float32):
            break
    else:
        if device.type == "cuda":
            return
    tensors = [t for t in tensors if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1 or device.type != "cuda":
        raise ValueError(f"{what}: every input must lie on one CUDA device "
                         f"(or all on the CPU), got "
                         f"{sorted(map(str, devices))}")
    raise TypeError(f"{what}: the kernel takes float32 only, got "
                    f"{sorted({str(t.dtype) for t in tensors})}")


def columns(t, apart=False):
    """`t` with contiguous columns, copied only where they are not; rows and
    replicas keep their strides. The two callers differ at two edges, and
    each keeps its rule: IW1 takes a width of 1 at any stride; B1
    (`apart`) copies that too, and rows that overlap (a row stride below
    the width, 0 for rows expanded)."""
    if apart:
        ok = t.stride(-1) == 1 and t.stride(-2) >= t.shape[-1]
    else:
        ok = t.stride(-1) == 1 or t.shape[-1] == 1
    return t if ok else t.contiguous()


def replica_slices(t, lead):
    """`t` with each replica's slice contiguous (the replica stride kept, 0
    included: one tensor shared by the replicas), copied only where a slice
    is not; `lead` 1 with a replica axis, 0 without. Read on the strides,
    without making a view."""
    want = 1
    for size, stride in zip(reversed(t.shape[lead:]),
                            reversed(t.stride()[lead:])):
        if size != 1 and stride != want:
            return t.contiguous()
        want *= size
    return t


@functools.cache
def sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def logical_dim(t, dim) -> int:
    """The number of axes a vmap rule's input `t` has inside the vmap."""
    return t.dim() - (dim is not None)


def fold_replicas(t, dim, V, lead):
    """A vmap rule's input `t` (vmapped at `dim`, or not vmapped: None) as V
    replicas folded into its replica axis: [V, ...] when it has none inside
    the vmap (`lead` 0), [V*R, ...] when it has R (`lead` 1). An input that
    is not vmapped is expanded without a copy (stride 0 on the new axis)."""
    t = t.movedim(dim, 0) if dim is not None else t.expand(V, *t.shape)
    return t.flatten(0, 1) if lead else t


def unfold_replicas(t, V, lead):
    """An output of a folded call back as [V, ...]: unchanged for `lead` 0,
    [V, R, ...] for `lead` 1."""
    return t.unflatten(0, (V, -1)) if lead else t
