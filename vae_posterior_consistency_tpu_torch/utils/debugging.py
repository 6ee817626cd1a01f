"""Numerical-anomaly tripwires and the entry points' environment switches
(port of the JAX package's `utils/debugging.py`).

The reference enables torch's anomaly detection in every entry point
(reference: src/experiment_main/imputation.py:19, a NaN/inf tripwire at a
heavy runtime cost). Here it is opt-in, as in the JAX package:

- `enable_nan_debugging()`: `torch.autograd.set_detect_anomaly(True)`, so a
  backward that makes a NaN raises with the forward's stack trace; every
  entry point turns it on when VPC_DEBUG_NANS is set
  (`enable_nan_debugging_from_env`).
- `checked(fn)`: fn with its outputs checked, raising FloatingPointError at
  the first non-finite one (torch has no `checkify`).
- `apply_platform_from_env()`: VPC_PLATFORM=cpu or cuda sets the default of
  the entry points' `-device` flag.
"""

from __future__ import annotations

import os

import torch

#: the values VPC_PLATFORM may take: the port's two devices
PLATFORMS = ("cpu", "cuda")


def enable_nan_debugging(enable: bool = True) -> None:
    """The global NaN tripwire: autograd's anomaly detection."""
    torch.autograd.set_detect_anomaly(enable)


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
    """Turn on anomaly detection when the environment variable `var` is set
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
