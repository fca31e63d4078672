"""SA-range-sharded FM index: graphs larger than one device's HBM.

The occ table is the index's dominant device array: 16 bytes per BWT
position ((n+1, 4) int32 prefix counts, search_jax.DeviceIndex). A
4.4Mb M.tb graph is ~70MB -- trivially replicated -- but a human-scale
(3Gb+) graph graph is tens of GB, beyond one chip. The reference cannot
scale past one node at all (SURVEY §2.3: OpenMP only); here the index
gains a second mesh axis.

Design (SURVEY §7 M7): shard occ rows by SA range over mesh axis "idx".
Every device runs the identical search step on the same state pool; the
occ row gather becomes

    gather(occ_local, rows - offset) masked to the local range,
    then psum over "idx"

-- each row is owned by exactly one shard, so the psum reconstructs the
full gather. Queries stay replicated (they are KB-scale; the table is
the thing that cannot be), so one collective runs per gather.
This composes with data parallelism: a ("data", "idx") mesh shards reads
over "data" and the index over "idx"; coverage psums over "data"
(parallel/mesh.py) are unchanged.

The step itself is the production genealogy-log engine
(mapping/search_jax_log.py) with the occ gather injected -- no second
search implementation to keep in sync.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..mapping.device_index import DeviceIndex
from ..mapping.search_jax_log import (
    LogConfig,
    _log_search_phases,
    auto_phases,
)


def shard_occ(occ: np.ndarray, n_shards: int):
    """Pad occ rows to a multiple of n_shards. Returns (padded, rows_per_shard)."""
    rows = occ.shape[0]
    rows_per_shard = -(-rows // n_shards)
    padded = np.zeros((rows_per_shard * n_shards, occ.shape[1]), occ.dtype)
    padded[:rows] = occ
    return padded, rows_per_shard


def make_index_sharded_log_search(mesh: Mesh, di: DeviceIndex, cfg: LogConfig,
                                  num_reads: int, phases=None):
    """Index-sharded (and optionally data-parallel) log-engine search.

    mesh must have an "idx" axis (occ SA-range shards); if it also has a
    "data" axis, reads_T columns and the carry are sharded over it and
    ``num_reads`` is the per-data-shard read count. Returns
    run(reads_T, carry) -> (final_carry, (log_parent, log_event));
    with a "data" axis the log arrays are the per-shard logs
    concatenated in shard order (each of the static per-shard length).
    """
    assert "idx" in mesh.axis_names, "mesh needs an 'idx' axis"
    n_idx = mesh.shape["idx"]
    has_data = "data" in mesh.axis_names

    occ_np = np.asarray(di.occ)
    occ_pad, rows_per_shard = shard_occ(occ_np, n_idx)
    # the narrow-step table shards by the same SA ranges: in the tail
    # phases the collective then moves ONE int32 per state instead of
    # two 4-int occ rows (the occ psum remains for warm phases and the
    # narrow wide-budget/newborn sub-paths)
    nt_np = np.asarray(di.narrow_tab)
    has_narrow = nt_np.shape[0] == di.size
    nt_pad, nt_rows_per_shard = shard_occ(
        nt_np[:, None] if has_narrow else np.zeros((n_idx, 1), np.int32),
        n_idx)
    # di travels with a stub occ: the real table goes in sharded
    small = DeviceIndex(**{
        **{f: getattr(di, f) for f in (
            "sym_start", "sa", "marker_prefix", "marker_sa_pos",
            "pos_to_locus", "marker_rank_locus", "sentinel_row",
            "out_lo", "out_hi", "ops_kind", "ops_site", "ops_allele",
            "size", "n_outcomes", "n_ops")},
        "occ": jnp.zeros((1, 4), occ_np.dtype),
        "narrow_tab": jnp.zeros(1, jnp.int32)})

    def shard_fn(di_rep, occ_local, nt_local, reads_T, carry, p):
        off = jax.lax.axis_index("idx") * rows_per_shard

        def occ_rows(rows):
            r = jnp.clip(rows, 0, di_rep.size)
            local = r - off
            ok = (local >= 0) & (local < rows_per_shard)
            v = occ_local[jnp.clip(local, 0, rows_per_shard - 1)]
            v = jnp.where(ok[..., None], v, 0)
            return jax.lax.psum(v, "idx")

        narrow_rows = None
        if has_narrow:
            noff = jax.lax.axis_index("idx") * nt_rows_per_shard

            def narrow_rows(rows):
                r = jnp.clip(rows, 0, di_rep.size - 1)
                local = r - noff
                ok = (local >= 0) & (local < nt_rows_per_shard)
                v = nt_local[jnp.clip(local, 0, nt_rows_per_shard - 1), 0]
                return jax.lax.psum(jnp.where(ok, v, 0), "idx")

        return _log_search_phases(di_rep, reads_T, carry, p, num_reads,
                                  occ_rows=occ_rows,
                                  narrow_rows=narrow_rows)

    di_specs = jax.tree_util.tree_map(lambda _: P(), small)
    data = "data" if has_data else None
    reads_spec = P(None, data)
    carry_specs = (P(data),) * 5
    log_spec = (P(data), P(data))

    import functools

    @functools.lru_cache(maxsize=None)
    def build(p):
        sharded = shard_map(
            functools.partial(shard_fn, p=p), mesh=mesh,
            in_specs=(di_specs, P("idx", None), P("idx", None), reads_spec,
                      carry_specs),
            out_specs=(carry_specs, log_spec),
            check_vma=False,
        )
        return jax.jit(sharded)

    occ_dev = jax.device_put(
        occ_pad, jax.sharding.NamedSharding(mesh, P("idx", None)))
    nt_dev = jax.device_put(
        nt_pad, jax.sharding.NamedSharding(mesh, P("idx", None)))

    def run(reads_T, carry):
        p = phases
        if p is None:
            p = auto_phases(reads_T.shape[0], num_reads, cfg,
                            narrow=has_narrow)
        return build(tuple(p))(small, occ_dev, nt_dev, reads_T, carry)

    return run
