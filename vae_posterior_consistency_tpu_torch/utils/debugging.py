"""Numerical-anomaly tripwires and the entry points' environment switches
(port of the JAX package's `utils/debugging.py`).

The reference enables torch's anomaly detection in every entry point
(reference: src/experiment_main/imputation.py:19, a NaN/inf tripwire at a
heavy runtime cost). Here it is opt-in, as in the JAX package:

- `enable_nan_debugging()`: the JAX package's `jax_debug_nans`, which
  raises at the first NaN any operation makes: a dispatch mode
  (`NanTripwire`) raises FloatingPointError at the first floating output
  of an operator that holds a NaN, forward or backward, and autograd's
  anomaly detection prints the forward of a failing backward; every entry
  point turns both on when VPC_DEBUG_NANS is set
  (`enable_nan_debugging_from_env`). Each operator's output is then read
  back on the host: a slow, debugging-only mode.
- `checked(fn)`: fn with its outputs checked, raising FloatingPointError at
  the first non-finite one (torch has no `checkify`).
- `apply_platform_from_env()`: VPC_PLATFORM=cpu or cuda sets the default of
  the entry points' `-device` flag.
"""

from __future__ import annotations

import os

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

#: the values VPC_PLATFORM may take: the port's two devices
PLATFORMS = ("cpu", "cuda")

#: operators whose output is uninitialised memory, not a result (the
#: kernels' wrappers allocate their outputs with torch.empty and the
#: kernel writes them)
UNINITIALISED = frozenset({
    torch.ops.aten.empty, torch.ops.aten.empty_like,
    torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
    torch.ops.aten.new_empty_strided})


class NanTripwire(TorchDispatchMode):
    """Raises FloatingPointError, naming the operator, at the first
    floating output that holds a NaN (infinities pass, as under
    `jax_debug_nans`). A sharded tensor (a DTensor of the multi-device
    engine) is checked on this rank's shard."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in UNINITIALISED:
            return out
        for t in pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            if hasattr(t, "to_local"):
                t = t.to_local()
            if t.is_floating_point() and bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"NaN in the output of {func} (shape {list(t.shape)})")
        return out


#: the tripwire pushed by `enable_nan_debugging`, or None
_TRIPWIRE = None


def enable_nan_debugging(enable: bool = True) -> None:
    """The global NaN tripwire: `NanTripwire` pushed (or, with `enable`
    False, popped) and autograd's anomaly detection set to `enable`, for
    the forward's stack trace of an error raised in a backward. Its own
    NaN check stays off: the tripwire checks every backward operator
    already, and that check calls an operator (aten._is_any_true) that the
    multi-device engine's DTensor gradients do not have."""
    global _TRIPWIRE
    torch.autograd.set_detect_anomaly(enable, check_nan=False)
    if enable and _TRIPWIRE is None:
        _TRIPWIRE = NanTripwire()
        _TRIPWIRE.__enter__()
    elif not enable and _TRIPWIRE is not None:
        _TRIPWIRE.__exit__(None, None, None)
        _TRIPWIRE = None


def _leaves(out, path="output"):
    if isinstance(out, torch.Tensor):
        yield path, out
    elif isinstance(out, dict):
        for k, v in out.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(out, (list, tuple)):
        for i, v in enumerate(out):
            yield from _leaves(v, f"{path}[{i}]")


def checked(fn):
    """fn wrapped so that it raises FloatingPointError naming the first
    output tensor (nested in dicts, lists and tuples, in their order) that
    holds a NaN or an infinity; a floating output only.

    Usage: loss = checked(train_loss)(params, ...)."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for path, t in _leaves(out):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"{getattr(fn, '__name__', 'fn')}: non-finite value in "
                    f"{path} (shape {list(t.shape)})")
        return out

    return wrapper


def enable_nan_debugging_from_env(var: str = "VPC_DEBUG_NANS") -> bool:
    """Turn on the NaN tripwire when the environment variable `var` is set
    and not empty, the opt-in form of the reference's unconditional
    detect_anomaly (PARITY.md documented deviation #7). Every entry point
    calls it first. Returns whether it did."""
    if os.environ.get(var):
        enable_nan_debugging()
        return True
    return False


def apply_platform_from_env(var: str = "VPC_PLATFORM"):
    """VPC_PLATFORM=cpu or cuda makes that device the default of the entry
    points' `-device` flag (an explicit `-device` still wins); unset or
    empty, nothing changes. Any other value raises ValueError: the port
    never falls back from one device to the other on its own. Every entry
    point calls it first. Returns the device set, or None."""
    from vae_posterior_consistency_tpu_torch import config

    plat = os.environ.get(var, "").strip()
    if not plat:
        return None
    if plat not in PLATFORMS:
        raise ValueError(f"{var}={plat!r}: want one of {PLATFORMS}")
    config.set_default_device(plat)
    return plat
