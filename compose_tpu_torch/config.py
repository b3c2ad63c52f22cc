"""Device and dtype helpers.

The numerics need float64 (mass conservation to ~1e-13, bounds to a few
ulp); torch's default dtype is float32, so every tensor the port creates
names its dtype. The device is always given by the caller: asking for CUDA
where there is none raises instead of running somewhere else.
"""

import numpy as np
import torch

F64 = torch.float64
F32 = torch.float32

_NP_DTYPES = {F64: np.float64, F32: np.float32}


def resolve_device(device) -> torch.device:
    """torch.device for `device` ('cpu', 'cuda', 'cuda:1', or a
    torch.device). Raises if a CUDA device is asked for and unavailable."""
    if device is None:
        raise ValueError("device must be given explicitly ('cpu' or 'cuda')")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def np_scalar(dtype: torch.dtype):
    """The numpy scalar type of a torch float dtype (host-side scalar
    arithmetic rounded like the device tensors)."""
    return _NP_DTYPES[dtype]
