"""Build and bind the port's CUDA kernels (compose_tpu_torch/csrc/*.cu).

The kernels have a plain C interface. At first use each source is compiled
by its own nvcc process for sm_90a (all started together), and the objects
are linked into one shared library under ``build/kernels/`` at the root of
the checkout (git-ignored), named by a hash of the sources and flags so a
stale library is never loaded, and bound with ctypes. Nothing is built at
import: CPU-only machines import every module without nvcc.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``. Each is called through its `Kernel` in `KERNELS`,
which turns a nonzero code into an exception and counts the launch.

A wrapper given DTensors (torch.distributed.tensor, the cell-sharded step
of parallel/sharding.py) cannot hand their storage to a kernel: it routes
the call through `on_local`, which places the operands as the kernel needs
them and launches it on each rank's local tensors.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG = pathlib.Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# --fmad=false: nvcc would fuse a*b+c into one FMA; torch's eager ops never
# do, and the kernels are compared with their plain versions bitwise.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: name -> argtypes (all return int, a cudaError_t). Each
# kernel has an f64 and an f32 entry, instantiated from one template.
_ARGTYPES = {
    # qmin, qmass, qmax, extra, out, nt, ncell, cluster, warps, width,
    # chunks, rounds, stream
    "glbl_caas": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # rhom, rho, Q, qmin, qmax, b, out, nt, ncell, np2, stream
    "limit_caas": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # w, F, q, slots, out, nt, nin (row length of w, F, q), nout (output
    # slots), stream
    "dss_q": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # p, out, n, nsub, normalize, wind, table (host doubles), stream
    "dopri5": (_P, _P, _I, _I, _I, _I, _P, _P),
    # rhom, qmin, qm, qmax, extra (or null), extra_stride, out, scratch,
    # table, nlev, nt, nleaf, stream
    "qlt_tree": (_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P),
    # p_idx (the points the index reads), p, corners, ci, w (or a), b (or
    # null), n, ne, max_its, wide (w in f64), table (host doubles), stream
    "locate": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    "locate_ab": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
}
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_SIGNATURES = {f"{k}_{sfx}": v for k, v in _ARGTYPES.items()
               for sfx in _SUFFIX.values()}


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


_BUILD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    """The bound kernel library, built on first call if needed (by one
    thread, if several ask at once)."""
    with _BUILD_LOCK:
        return _load()


def _load() -> ctypes.CDLL:
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            nvcc = _nvcc()
            objs, procs = [], []
            for src in _sources():
                if src.suffix == ".cu":
                    objs.append(os.path.join(tmp, src.stem + ".o"))
                    procs.append(subprocess.Popen(
                        [nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], str(src)],
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True))
            _wait_all(procs)
            out = os.path.join(tmp, so.name)
            _wait_all([subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", out, *objs],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)])
            os.replace(out, so)
    handle = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return handle


def _wait_all(procs):
    """Wait for every nvcc process; raise with the output of those that
    failed."""
    logs = [(p.args, p.communicate()[0], p.returncode) for p in procs]
    bad = [f"{' '.join(a)}\n-> {rc}\n{log}" for a, log, rc in logs if rc]
    if bad:
        raise RuntimeError("nvcc failed:\n" + "\n".join(bad))


class Kernel:
    """One C entry point. Calling it launches the kernel on `stream`,
    raises on a launch error, and adds one to `launches` (under a lock:
    the shards of a LocalComm launch from several threads)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self._lock = threading.Lock()

    def __call__(self, *args, stream):
        code = getattr(lib(), self.name)(*args, stream)
        if code != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed: cudaError "
                               f"{code}")
        with self._lock:
            self.launches += 1


KERNELS = {name: Kernel(name) for name in _SIGNATURES}


def kernel(base: str, dtype) -> Kernel:
    """The Kernel of `base` ('glbl_caas', 'limit_caas', 'dss_q', 'dopri5',
    'qlt_tree', 'locate', 'locate_ab') for float dtype `dtype`."""
    if dtype not in _SUFFIX:
        raise TypeError(f"{base}: no kernel for {dtype}")
    return KERNELS[f"{base}_{_SUFFIX[dtype]}"]


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def has_dtensor(*args) -> bool:
    """Whether any argument is a DTensor. Plain tensors and numbers answer
    without importing torch.distributed."""
    for a in args:
        if isinstance(a, torch.Tensor) and type(a) is not torch.Tensor:
            from torch.distributed.tensor import DTensor
            if isinstance(a, DTensor):
                return True
    return False


def on_local(fn, args, placements=None, out_placements=None, n_out=1):
    """fn(*args) for a call with DTensor operands, through
    torch.distributed.tensor.experimental.local_map: each DTensor is first
    redistributed to its entry of `placements` (one placement list per
    argument; None: Replicate for every one), fn runs on the rank's local
    tensors (plain tensors, which stand for replicated values, and numbers
    pass as they are), and its `n_out` tensor outputs are wrapped as
    DTensors with `out_placements` (default Replicate)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    rep = [Replicate()]
    placements = placements or [rep] * len(args)
    in_pl = tuple(p if isinstance(a, torch.Tensor) else None
                  for a, p in zip(args, placements))
    if out_placements is None:
        out_placements = rep if n_out == 1 else (rep,) * n_out
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_pl, redistribute_inputs=True)(*args)


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
