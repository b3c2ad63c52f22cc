"""Device and dtype helpers.

The numerics need float64 (mass conservation to ~1e-13, bounds to a few
ulp); torch's default dtype is float32, so every tensor the port creates
names its dtype. The single-precision route (`driver.run(x64=False)`, the
counterpart of the JAX package's COMPOSE_TPU_X64=0) names float32 instead.

Entry points run on the current CUDA device unless the caller asks for the
CPU; asking for CUDA where there is none raises instead of running
somewhere else.
"""

import numpy as np
import torch

F64 = torch.float64
F32 = torch.float32

_NP_DTYPES = {F64: np.float64, F32: np.float32}


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device` ('cpu', 'cuda', 'cuda:1', a torch.device,
    or None for the current CUDA device). Raises RuntimeError if a CUDA
    device is asked for and unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def real_dtype(x64: bool) -> torch.dtype:
    """The working float type: float64, or float32 on the single-precision
    route."""
    return F64 if x64 else F32


def np_scalar(dtype: torch.dtype):
    """The numpy scalar type of a torch float dtype (host-side scalar
    arithmetic rounded like the device tensors)."""
    return _NP_DTYPES[dtype]
