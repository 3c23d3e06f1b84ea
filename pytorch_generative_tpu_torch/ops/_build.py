"""Builds the hand-written CUDA kernels in ``csrc/`` and loads them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
first use by ``nvcc`` for Hopper (``sm_90a``) into ``build/<name>-<hash>.so``
beside this package's sources, keyed by a hash of the source, the shared
headers ``csrc/*.cuh`` and the flags, then loaded with ``ctypes``. Nothing
is built at import. The compiler's ``-Xptxas -v`` report (registers, shared
memory, spills) is kept in ``build/<name>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {candidate} and on PATH); the CUDA "
            "kernels can only be built where the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built to, keyed by its content, the
    shared headers and the flags."""
    src = CSRC / f"{name}.cu"
    key = b"".join(p.read_bytes() for p in [src, *sorted(CSRC.glob("*.cuh"))])
    key += " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """Compiles ``csrc/<name>.cu`` unless a build of this exact source exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def load(name: str) -> ctypes.CDLL:
    """Builds (if needed) and loads ``csrc/<name>.cu``; cached per process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raises if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: cudaError {err}")


def declare(fn, argtypes, restype=ctypes.c_int):
    """Sets a C entry point's argument and result types before its first
    call (64-bit pointers otherwise pass as 32-bit ints); returns ``fn``."""
    if fn.argtypes is None:
        fn.restype = restype
        fn.argtypes = argtypes
    return fn


def check_aligned(name, t, kernel):
    """Raises unless ``t`` starts on a 16-byte boundary, for a kernel that
    reads it 16 bytes at a time (``float4`` or 16-byte ``cp.async``). A
    contiguous view at an offset, e.g. of a flat parameter buffer, may not:
    ``contiguous()`` returns it unchanged."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the {kernel} kernel reads 16 bytes at a time and needs "
                         f"a 16-byte aligned start, got offset {t.data_ptr() % 16} bytes")


def check_tensor(name, t, shape, device, kernel, dtype=torch.float32, aligned=False):
    """Raises unless ``t`` is a contiguous tensor of ``dtype`` (float32 by
    default) and ``shape`` on ``device``, with ``aligned`` also starting on
    a 16-byte boundary: what the kernels take."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {kernel} takes {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned:
        check_aligned(name, t, kernel)


def dispatch(cuda_fn, plain_fn, *args):
    """The kernel for a CUDA tensor, the plain version for a CPU tensor
    (by the device of the first tensor argument); raises for any other
    device."""
    t = next(a for a in args if isinstance(a, torch.Tensor))
    if t.is_cuda:
        return cuda_fn(*args)
    if t.device.type != "cpu":
        raise ValueError(f"no kernel for device {t.device}")
    return plain_fn(*args)
