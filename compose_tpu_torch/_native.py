"""Build and bind the port's CUDA kernels (compose_tpu_torch/csrc/*.cu).

The kernels have a plain C interface. At first use they are compiled by
nvcc for sm_90a into one shared library under ``build/kernels/`` at the
root of the checkout (git-ignored), named by a hash of the sources and
flags so a stale library is never loaded, and bound with ctypes. Nothing is
built at import: CPU-only machines import every module without nvcc.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; `check` turns a nonzero code into an exception.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

_PKG = pathlib.Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# --fmad=false: nvcc would fuse a*b+c into one FMA; torch's eager ops never
# do, and the kernels are compared with their plain versions bitwise.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: name -> argtypes (all return int, a cudaError_t).
_SIGNATURES = {
    # qmin, qmass, qmax, extra, out, nt, ncell, stream
    "glbl_caas_f64": (_P, _P, _P, _P, _P, _I, _I, _P),
    # rhom, rho, Q, qmin, qmax, b, out, nt, ncell, stream
    "limit_caas_f64": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    # w, F, q, c2d_idx, c2d_mask, out, nt, cnn, ndgll, stream
    "dss_q_f64": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
}


def _sources():
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    cand = shutil.which("nvcc")
    if cand is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
    if cand is None or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return cand


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcompose_kernels-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    """The bound kernel library, built on first call if needed."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = [str(s) for s in _sources() if s.suffix == ".cu"]
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                                   f"{res.stdout}\n{res.stderr}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    handle = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return handle


def check(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {code}")


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name, dtype, shape):
    """Validate a kernel operand: CUDA, dtype, shape, contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()
