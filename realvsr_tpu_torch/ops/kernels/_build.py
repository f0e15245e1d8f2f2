"""Build the hand-written CUDA kernels of ``realvsr_tpu_torch/csrc`` and load
them with ctypes.

Each ``csrc/<name>.cu`` (plus the shared ``common.cuh``) is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library with a plain C
interface, at first use, into ``realvsr_tpu_torch/build/`` (listed in
``.gitignore``).  The library's file name carries a hash of its sources and
flags, so an edited source is rebuilt and a stale library is never loaded.
:func:`build` compiles several sources at once, one ``nvcc`` process each,
all started together.  A failed build raises.

Every exported C function launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
:func:`check_tensor` is the wrappers' shared validation of what they pass.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
# the C entry points' element-type suffixes and activation codes (common.cuh)
SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
ACTS = {None: 0, "relu": 1, "lrelu": 2}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def lib_path(name: str) -> Path:
    """Library path for ``csrc/<name>.cu`` at the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict[str, str]:
    """Compile the named sources that are not built yet, in parallel.

    Returns each built source's compiler output (``-Xptxas -v``: registers,
    shared memory and spills per kernel).  Raises if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str, functions: tuple) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``.

    ``functions``: ``((symbol, (argtype, ...)), ...)``; each gets its
    ``argtypes`` and an ``int`` restype (the ``cudaError_t`` it returns).
    """
    build([name])
    lib = ctypes.CDLL(str(lib_path(name)))
    for symbol, argtypes in functions:
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def check_tensor(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    """Raise unless ``t`` has this shape, dtype and device and is contiguous
    and 16-byte aligned, as the kernels read it."""
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected {dtype} "
                         f"on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
