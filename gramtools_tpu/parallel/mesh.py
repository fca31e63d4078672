"""Multi-chip data parallelism: reads sharded over a device mesh,
coverage merged per shard with no locks.

The reference's scaling story is OpenMP threads over a 5,000-read buffer
with atomic coverage updates (quasimap.cpp:90-117, SURVEY §2.3). The
device equivalent: the vBWT index is replicated across the mesh,
each buffer's (read, orientation) rows round-robin over the 'data' axis,
every shard runs the identical phased genealogy-log scan + fused
device-side selection/recording (mapping/search_jax_log.py +
mapping/record_jax.py) on its row slice, and the per-shard coverage
diff arrays stay sharded until one end-of-run reduction — no atomics,
no critical sections. The per-read seeded selection RNG (SURVEY §7.1)
makes results shard-count invariant by construction
(tests/test_mesh_engine.py pins 1-vs-8-device equality at 5,000x150bp
including the device-record and retry paths).

``MeshLogEngine`` is a thin configuration of the production
``LogBatchedEngine`` — one engine, one recorder, one scalar oracle —
so every single-chip feature (fused record, overflow retry, sticky
canonical shapes, adaptive hit budget) is the mesh feature set too.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..mapping.device_index import DeviceIndex
from ..mapping.search_jax_log import LogBatchedEngine


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("data",))


def make_sharded_log_search(mesh: Mesh, di: DeviceIndex, cfg,
                            reads_per_shard: int, phases=None):
    """Data-parallel scan-only runner (genealogy-log engine): reads_T
    columns and the carry shard over 'data', the index is replicated,
    and each shard runs the identical phased scan. Per-shard genealogy
    logs return sharded (concatenated in shard order, each of the
    static per-shard length). Combine with parallel/sharded_index.py
    for a ('data', 'idx') mesh when the occ table itself must shard.

    Used by the scaling-curve harness and the sharded-index equivalence
    tests; the full production pipeline (seeding, fused record, retry)
    over a mesh is ``MeshLogEngine``."""
    from ..mapping.search_jax_log import _log_search_phases, auto_phases

    def shard_fn(di_rep, reads_T, carry, p):
        return _log_search_phases(di_rep, reads_T, carry, p, reads_per_shard)

    di_specs = jax.tree_util.tree_map(lambda _: P(), di)
    carry_specs = (P("data"),) * 5
    log_spec = (P("data"), P("data"))

    @functools.lru_cache(maxsize=None)
    def build(p):
        sharded = shard_map(
            functools.partial(shard_fn, p=p), mesh=mesh,
            in_specs=(di_specs, P(None, "data"), carry_specs),
            out_specs=(carry_specs, log_spec),
            check_vma=False,
        )
        return jax.jit(sharded)

    def run(reads_T, carry):
        p = phases
        if p is None:
            p = auto_phases(reads_T.shape[0], reads_per_shard, cfg)
        return build(tuple(p))(di, reads_T, carry)

    return run


class MeshLogEngine(LogBatchedEngine):
    """Data-parallel production mapping engine over a device mesh.

    Drop-in for ``quasimap_reads(engine=...)``: identical feature set to
    the single-chip engine (it IS the single-chip engine, configured
    with a mesh) — vectorised seeding, fused device-side selection +
    coverage recording, full-budget overflow retry, host fallback for
    the hard residue. Requires the array-backed kmer index
    (index.kmer_index_vec.build_kmer_index_vectorised); the dict-based
    oracle index has no ``seed_batch`` and is rejected with a clear
    error at first use.
    """

    def __init__(self, idx, kmer_size: int, mesh: Optional[Mesh] = None,
                 cfg=None):
        super().__init__(idx, kmer_size, cfg=cfg,
                         mesh=mesh if mesh is not None else make_mesh())
