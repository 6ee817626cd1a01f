"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `csrc/*.cu` compiles at first use into its own shared library with a
plain C interface: no PyTorch headers, so a build takes seconds, not minutes.
The libraries go to `build/vpc_torch_kernels/lib<source>_<hash>.so` at the
repo root, or under `~/.cache/vpc_torch_kernels` where the checkout is not
writable (an installed package; `build_dir`); the hash covers every source
and header and the flags, so an edited source builds anew. All sources
compile at once, one nvcc process each. Each
writes to a name of its own and is `os.replace`d into place, so two processes
that build at once cannot see half a library, and there is no lock file to be
left behind.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: the directory that holds the package: the repo root in a checkout
ROOT = Path(__file__).resolve().parents[2]


def build_dir(name: str, root: Path = ROOT) -> Path:
    """Where a build of the port goes: `root/build/<name>` when that
    directory, or `root` before it exists, is writable (a checkout), else
    `~/.cache/<name>` (an installed package in a read-only place), as the
    JAX package's data plane builds beside its source or under the cache."""
    base = root / "build"
    if os.access(base if base.is_dir() else root, os.W_OK):
        return base / name
    return Path.home() / ".cache" / name


BUILD_DIR = build_dir("vpc_torch_kernels")
#: `-Xptxas=-v` only reports registers, shared memory and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(
            f"nvcc not found on PATH or at {path}; set CUDA_HOME to the CUDA "
            "toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> tuple[dict[str, Path], str]:
    """Compile every source whose library is missing, all at once.

    Returns ({source stem: library path}, what nvcc printed). Raises
    RuntimeError with nvcc's stderr if any source fails to compile."""
    tag = _digest()
    libs = {src.stem: BUILD_DIR / f"lib{src.stem}_{tag}.so"
            for src in sorted(CSRC.glob("*.cu"))}
    todo = [(stem, out) for stem, out in libs.items() if not out.exists()]
    if not todo:
        return libs, ""
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    log, errors = [], []
    try:
        for stem, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{stem}.cu")]
            procs.append((stem, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for stem, out, tmp, proc in procs:
            stdout, stderr = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {stem}.cu (exit "
                              f"{proc.returncode}):\n{stderr}{stdout}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, out)
            log.append(f"{stem}.cu:\n{stdout}{stderr}")
    finally:
        for _, _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
                tmp.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs, "".join(log)


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<stem>.cu`, built first if need be."""
    with _lock:
        if stem not in _libs:
            paths, _ = build_all()
            lib = ctypes.CDLL(str(paths[stem]))
            lib.vpc_error_string.argtypes = [ctypes.c_int]
            lib.vpc_error_string.restype = ctypes.c_char_p
            _libs[stem] = lib
        return _libs[stem]

