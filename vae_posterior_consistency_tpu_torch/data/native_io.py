"""The port's native host-side data plane: ctypes bindings for its own copy
of the C++ library, `csrc/vpc_io.cpp` (port of the JAX package's
`data/native_io.py`).

A float32 CSV reader (the loaders' split-index CSVs), a bit-packed
observation-mask codec and offline MCAR mask sampling with xorshift128+.
The library is host code, not a device kernel: it builds at first use with
g++ into `build/vpc_torch_io/libvpc_io_<hash>.so` at the repo root, or
under `~/.cache/vpc_torch_io` where the checkout is not writable
(`ops/_build.build_dir`; the hash covers the source and the flags, so an
edited source builds anew; the library is written under a name of its own
and `os.replace`d into place) and is loaded only if its ABI version is
`ABI_VERSION`. Every function has the JAX package's numpy fallback, taken
where the library cannot be built or loaded, so that artifacts are the
same bits with or without g++;
`library()` raises instead. Each read and each MCAR mask that went
through the library counts in `read_csv.native_calls` or
`mcar_mask.native_calls`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from vae_posterior_consistency_tpu_torch.ops._build import build_dir

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "vpc_io.cpp"
BUILD_DIR = build_dir("vpc_torch_io")
#: portable code (no -march=native): the library may be copied between hosts
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
GXX_TIMEOUT_S = 120
#: must equal csrc/vpc_io.cpp's vpc_io_abi_version(): a library of another
#: version would be called with the wrong argument lists
ABI_VERSION = 3

_lock = threading.Lock()
_lib = None
_error = None


def _path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libvpc_io_{h.hexdigest()[:16]}.so"


def _build_and_load() -> ctypes.CDLL:
    path = _path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True,
                              timeout=GXX_TIMEOUT_S)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {SOURCE.name} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.vpc_io_abi_version.restype = ctypes.c_int64
    abi = int(lib.vpc_io_abi_version())
    if abi != ABI_VERSION:
        raise RuntimeError(f"{path}: ABI version {abi}, expected "
                           f"{ABI_VERSION}")
    i64, f32p, u8p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                      ctypes.POINTER(ctypes.c_uint8))
    lib.vpc_csv_count.argtypes = [ctypes.c_char_p, ctypes.POINTER(i64),
                                  ctypes.POINTER(i64)]
    lib.vpc_csv_count.restype = ctypes.c_int
    lib.vpc_csv_parse.argtypes = [ctypes.c_char_p, f32p, i64, i64]
    lib.vpc_csv_parse.restype = i64
    lib.vpc_pack_mask.argtypes = [f32p, i64, u8p]
    lib.vpc_pack_mask.restype = None
    lib.vpc_unpack_mask.argtypes = [u8p, i64, f32p]
    lib.vpc_unpack_mask.restype = None
    lib.vpc_mcar_mask.argtypes = [i64, ctypes.c_double, ctypes.c_uint64,
                                  f32p]
    lib.vpc_mcar_mask.restype = None
    return lib


def library() -> ctypes.CDLL:
    """The loaded library, built first if need be; raises RuntimeError (or
    OSError, FileNotFoundError) saying why it cannot be had."""
    global _lib, _error
    with _lock:
        if _lib is None:
            try:
                _lib = _build_and_load()
            except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
                _error = exc
                raise
        return _lib


def _load():
    """The library, or None where it cannot be built or loaded (the first
    attempt's error is kept, and not retried)."""
    if _lib is None and _error is None:
        try:
            library()
        except (OSError, RuntimeError, subprocess.SubprocessError):
            pass
    return _lib


def available() -> bool:
    return _load() is not None


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


# ---------------------------------------------------------------------------
# CSV ingestion
# ---------------------------------------------------------------------------


def read_csv(path: str) -> np.ndarray:
    """A numeric CSV as float32 [rows, cols]. FileNotFoundError for a
    missing file, ValueError for a ragged one (a row with another number of
    values than the first)."""
    lib = _load()
    if lib is None:
        return np.loadtxt(path, delimiter=",", dtype=np.float32).reshape(
            -1, _numpy_cols(path))
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    if lib.vpc_csv_count(str(path).encode(), ctypes.byref(rows),
                         ctypes.byref(cols)):
        raise FileNotFoundError(path)
    n = rows.value * cols.value
    out = np.empty(n, np.float32)
    got = lib.vpc_csv_parse(str(path).encode(), _f32p(out), n, cols.value)
    read_csv.native_calls += 1
    if got <= -2:
        raise ValueError(f"{path}: ragged CSV — data row {-got - 2} does not "
                         f"have {cols.value} values")
    if got != n:
        raise ValueError(f"{path}: parsed {got} values, expected {n}")
    return out.reshape(rows.value, cols.value)


read_csv.native_calls = 0


def _numpy_cols(path: str) -> int:
    with open(path) as fh:
        return len(fh.readline().split(","))


# ---------------------------------------------------------------------------
# Mask codec
# ---------------------------------------------------------------------------


def pack_mask(mask: np.ndarray) -> np.ndarray:
    """A float32 0/1 mask as LSB-first bit-packed uint8 (8x smaller)."""
    flat = np.ascontiguousarray(mask, np.float32).reshape(-1)
    lib = _load()
    if lib is None:
        return np.packbits(flat.astype(bool), bitorder="little")
    out = np.empty((flat.size + 7) // 8, np.uint8)
    lib.vpc_pack_mask(_f32p(flat), flat.size,
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def unpack_mask(packed: np.ndarray, shape) -> np.ndarray:
    """The inverse of pack_mask: a float32 mask of `shape`."""
    n = int(np.prod(shape))
    lib = _load()
    if lib is None:
        bits = np.unpackbits(packed, bitorder="little")[:n]
        return bits.astype(np.float32).reshape(shape)
    packed = np.ascontiguousarray(packed, np.uint8)
    if packed.size < (n + 7) // 8:
        raise ValueError(f"unpack_mask: {packed.size} bytes hold fewer than "
                         f"the {n} bits of shape {tuple(shape)}")
    out = np.empty(n, np.float32)
    lib.vpc_unpack_mask(packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        n, _f32p(out))
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# MCAR mask sampling
# ---------------------------------------------------------------------------


def _xorshift128p_uniforms(n: int, seed: int) -> np.ndarray:
    """The xorshift128+ stream of csrc/vpc_io.cpp's vpc_mcar_mask, as
    float64 uniforms in [0, 1) (the top 53 bits of each output): the
    fallback's, bit for bit the library's for a seed. A host loop on Python
    ints, for offline artifacts only."""
    M = 0xFFFFFFFFFFFFFFFF
    s0 = (seed ^ 0x9E3779B97F4A7C15) & M
    s1 = ((seed << 1) | 1) & M
    out = np.empty(n, np.float64)
    scale = 1.0 / 9007199254740992.0
    for i in range(n):
        x, y = s0, s1
        s0 = y
        x ^= (x << 23) & M
        s1 = x ^ y ^ (x >> 17) ^ (y >> 26)
        out[i] = (((s1 + y) & M) >> 11) * scale
    return out


def mcar_mask(shape, missing_rate: float, seed: int) -> np.ndarray:
    """An offline MCAR observation mask (1 = observed, with probability
    1 - missing_rate / 100), float32 of `shape`; the library and the
    fallback draw the same xorshift128+ stream, so a seed gives the same
    bits on every host."""
    n = int(np.prod(shape))
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    lib = _load()
    if lib is None:
        u = _xorshift128p_uniforms(n, seed)
        return (u < 1.0 - missing_rate / 100.0).astype(np.float32).reshape(
            shape)
    out = np.empty(n, np.float32)
    lib.vpc_mcar_mask(n, float(missing_rate), seed, _f32p(out))
    mcar_mask.native_calls += 1
    return out.reshape(shape)


mcar_mask.native_calls = 0
