"""Deterministic, decomposition-invariant reductions (compose_tpu.ops.reduce).

`torch.sum` promises no summation order, so every global sum of the port
goes through `bfb_sum`: pad with zeros to the next power of two, then sum
ADJACENT pairs level by level. Every aligned power-of-two block is then a
complete subtree, so block partials reproduce the global sum bitwise, and
the adds are exactly those of the JAX package's `bfb_sum` (bitwise equal
results on the same inputs).
"""

import torch


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _pair_fold(x):
    """Adjacent-pair tree sum over the last axis, whose length must be a
    power of two."""
    while x.shape[-1] > 1:
        y = x.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2))
        x = y[..., 0] + y[..., 1]
    return x[..., 0]


def bfb_sum(x, dim: int = -1):
    """Sum along `dim` with the fixed adjacent-pair binary-tree order."""
    x = torch.movedim(x, dim, -1)
    n = x.shape[-1]
    p = next_pow2(n)
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    return _pair_fold(x)


def bfb_sum_cells(x):
    """bfb_sum over the two trailing axes (..., ncell, np2) flattened. With
    np2 a power of two every cell is an aligned subtree, so folding cells
    first is the same DAG as the flat sum."""
    np2 = x.shape[-1]
    if np2 & (np2 - 1):
        return bfb_sum(x.reshape(x.shape[:-2] + (-1,)))
    return bfb_sum(_pair_fold(x))
