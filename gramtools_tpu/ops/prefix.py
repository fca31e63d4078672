"""Exact int32 prefix sums for the vBWT scan step.

The scan step (mapping/search_jax_log.py) takes three kinds of prefix
sum per step: hit-slot assignment over per-state marker counts, hit
ownership, and the dense repack of survivors and newborns. Every value
they produce is an index, so they must be exact: an int32 ``cumsum`` is
exact up to 2**31, where a float matmul formulation is not (a float32
matmul may run in TF32 on the GPU, which keeps 11 significant bits).
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp


def prefix_sum(x, exclusive: bool = False):
    """Prefix sum along the LAST axis; any leading batch dims are summed
    independently. x: int/bool array. Returns int32, inclusive by
    default."""
    x = x.astype(jnp.int32)
    out = jnp.cumsum(x, axis=-1)
    return out - x if exclusive else out


def prefix_sum_np(x, exclusive: bool = False):
    """Numpy twin (exact int64 accumulation) for tests."""
    c = np.cumsum(x.astype(np.int64), axis=-1)
    if exclusive:
        c = c - x.astype(np.int64)
    return c.astype(np.int32)
