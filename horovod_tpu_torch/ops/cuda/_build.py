"""Build and load the port's CUDA kernels.

Every ``horovod_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together) and linked into
one shared library with a plain C interface, loaded with ``ctypes``.  The
library lives in ``horovod_tpu_torch/csrc/build/``, named by a hash of the
sources and flags, and is built at the first CUDA call.  Nothing happens at
import time: the module imports on a machine without ``nvcc``.

A failed build or load raises; there is no fallback.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

# dtype codes understood by the kernels (csrc/common.cuh hvd::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lib = None
_lock = threading.Lock()


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "horovod_tpu_torch: nvcc not found (set CUDA_HOME); the CUDA "
            "kernels cannot be built")
    return found


def _run_all(cmds):
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failures = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}")
    if failures:
        raise RuntimeError("horovod_tpu_torch: kernel build failed\n"
                           + "\n".join(failures))


def target():
    """Where ``build`` puts the library of these sources and flags."""
    return BUILD_DIR / f"libhvd_kernels_{_digest()}.so"


def build():
    """Compile the sources into ``csrc/build/libhvd_kernels_<hash>.so``
    unless it exists; returns its path."""
    path = target()
    if path.exists():
        return path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                  for src, obj in zip(sources(), objs)])
        partial = Path(tmp) / path.name
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(partial),
                   *map(str, objs)]])
        os.replace(partial, path)  # atomic: racing builds agree
    return path


def lib():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


@functools.cache
def function(name, *argtypes):
    """The C entry point ``name`` with its argument types declared, bound
    once; every entry point returns a ``cudaError_t`` as ``int``."""
    fn = getattr(lib(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err, what):
    if err != 0:
        raise RuntimeError(f"horovod_tpu_torch: {what} failed to launch: "
                           f"CUDA error {err}")


def stream_ptr(tensor):
    return torch.cuda.current_stream(tensor.device).cuda_stream


def dtype_code(tensor, what):
    try:
        return DTYPE_CODES[tensor.dtype]
    except KeyError:
        raise TypeError(f"{what}: unsupported dtype {tensor.dtype}; "
                        f"expected one of {list(DTYPE_CODES)}") from None
