"""Checkpoint and resume of transport runs (compose_tpu.checkpoint): the
restart tuple (step, t, rho, q) plus the caller's metadata, in a directory
holding `state.pt` (torch.save of the CPU tensors) and
`compose_meta.json`. Tensors are saved bit for bit, so a restored run
continues bitwise like an uninterrupted one."""

import json
import os

import torch

from .config import resolve_device

_STATE = "state.pt"
_META = "compose_meta.json"


def save(path, step, t, rho, q, meta=None):
    """Write the checkpoint directory `path` (created if needed; an
    earlier checkpoint there is replaced)."""
    meta = dict(meta or {})
    meta.update(step=int(step), t=float(t))
    os.makedirs(path, exist_ok=True)
    torch.save({"rho": rho.detach().cpu(), "q": q.detach().cpu()},
               os.path.join(path, _STATE))
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f)


def restore(path, device="cuda"):
    """Read a checkpoint; returns (step, t, rho, q, meta) with rho and q on
    `device` (the current CUDA device unless the CPU is asked for)."""
    dev = resolve_device(device)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    state = torch.load(os.path.join(path, _STATE), map_location="cpu",
                       weights_only=True)
    return (meta["step"], meta["t"], state["rho"].to(dev),
            state["q"].to(dev), meta)
