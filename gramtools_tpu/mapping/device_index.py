"""Device-staged index tables + shape helpers.

``DeviceIndex`` stages the FM-index occ/SA tables, the marker-rank ->
jump-locus table and the jump-outcome tables (mapping/jump_table.py) as
device arrays, registered as a pytree so jitted kernels receive them as
buffers (reused across graphs of identical shapes), not baked-in
constants. Shared by the production genealogy-log engine
(search_jax_log.py), the device recorder (record_jax.py) and the
SA-range index sharding (parallel/sharded_index.py).

Reference tables this corresponds to: PRG_Info's fm_index + masks
(libgramtools include/prg/prg_info.hpp:22-59), re-designed as dense
int32 occ prefix rows + full SA for batched gathers (SURVEY &sect;7.1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from .jump_table import JumpTable, build_jump_table
from .search import PrgIndex


def _next_pow2(x: int, floor: int = 1) -> int:
    out = floor
    while out < x:
        out *= 2
    return out


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if x > 0 else 0


def _build_narrow_tab(fm, marker_rank_locus: np.ndarray) -> np.ndarray:
    """Packed per-BWT-position table for the narrow-interval scan step
    (search_jax_log._build_narrow_step).

    After ~6 extension steps nearly every live state's SA interval is a
    singleton (hi == lo): the suffix it represents is unique in the
    text. For such a state the whole LF-extension + marker test needs
    only the symbol AT lo and one precomputed value, so the tail phases
    gather ONE int32 per state per step instead of two 4-int occ rows:

        narrow_tab[i] = (sym << 24) | val
        sym: 0 sentinel, 1-4 DNA base, 5 marker
        val: LF destination C[b] + rank_b(i) for DNA;
             the jump locus id (marker_rank_locus[rank]) for markers

    Requires n < 2^24 and all loci ids < 2^24; a 1-element stub is
    returned otherwise and the engine keeps the wide step everywhere
    (auto_phases narrow plan is gated on narrow_tab.shape[0] == n)."""
    n = fm.size
    if n >= (1 << 24):
        return np.zeros(1, dtype=np.int32)
    bwt = fm.bwt
    is_dna = (bwt >= 1) & (bwt <= 4)
    is_marker = bwt > 4
    sym = np.where(is_dna, bwt, np.where(is_marker, 5, 0)).astype(np.int64)
    # LF destination for DNA rows: C[b] + occ_b(i)   (occ is (4, n+1))
    bc = np.clip(bwt - 1, 0, 3)
    lf = (fm.sym_start[np.clip(bwt, 0, 4)].astype(np.int64)
          + fm.occ[bc, np.arange(n)])
    # marker rank at i = #markers in bwt[0:i] -> jump locus id
    mrl = marker_rank_locus
    if mrl.size == 0:
        mrl = np.zeros(1, dtype=np.int64)
    loc = mrl[np.clip(fm.marker_prefix[:n], 0, mrl.size - 1)]
    val = np.where(is_marker, loc, np.where(is_dna, lf, 0)).astype(np.int64)
    if val.size and int(val.max()) >= (1 << 24):
        return np.zeros(1, dtype=np.int32)
    return ((sym << 24) | val).astype(np.int32)


@dataclass
class DeviceIndex:
    """PrgIndex arrays staged for device kernels.

    Registered as a pytree (int metadata static) so it is passed to
    jitted kernels as device buffers, not baked-in constants."""

    occ: jnp.ndarray            # (n+1, 4) prefix counts, transposed for gathers
    narrow_tab: jnp.ndarray     # (n,) packed narrow-step table (see below)
    sym_start: jnp.ndarray      # (max_sym+1,)
    sa: jnp.ndarray             # (n,)
    marker_prefix: jnp.ndarray  # (n+1,)
    marker_sa_pos: jnp.ndarray  # (n_markers,) padded to >=1
    pos_to_locus: jnp.ndarray   # (len_prg,)
    marker_rank_locus: jnp.ndarray  # (n_markers,) jump locus per marker rank
    sentinel_row: jnp.ndarray   # () BWT row holding the 0 sentinel
    out_lo: jnp.ndarray         # (L, B)
    out_hi: jnp.ndarray
    ops_kind: jnp.ndarray       # (L, B, O)
    ops_site: jnp.ndarray
    ops_allele: jnp.ndarray
    size: int                   # n = fm size
    n_outcomes: int             # B
    n_ops: int                  # O

    @classmethod
    def build(cls, idx: PrgIndex, jt: Optional[JumpTable] = None) -> "DeviceIndex":
        if jt is None:
            jt = build_jump_table(idx)
        fm = idx.fm
        marker_sa_pos = fm.marker_sa_pos
        if marker_sa_pos.size == 0:
            marker_sa_pos = np.zeros(1, dtype=np.int32)
        # marker rank -> jump locus directly (collapses the dependent
        # marker_sa_pos -> sa -> pos_to_locus gather chain to one gather)
        marker_prg_pos = fm.sa[np.clip(marker_sa_pos, 0, fm.size - 1)]
        marker_rank_locus = jt.pos_to_locus[
            np.clip(marker_prg_pos, 0, jt.pos_to_locus.shape[0] - 1)]
        narrow_tab = _build_narrow_tab(fm, marker_rank_locus)
        return cls(
            occ=jnp.asarray(np.ascontiguousarray(fm.occ.T)),
            narrow_tab=jnp.asarray(narrow_tab),
            sym_start=jnp.asarray(fm.sym_start),
            sa=jnp.asarray(fm.sa),
            marker_prefix=jnp.asarray(fm.marker_prefix),
            marker_sa_pos=jnp.asarray(marker_sa_pos),
            pos_to_locus=jnp.asarray(jt.pos_to_locus),
            marker_rank_locus=jnp.asarray(marker_rank_locus),
            sentinel_row=jnp.asarray(
                np.int32(np.flatnonzero(fm.bwt == 0)[0])),
            out_lo=jnp.asarray(jt.out_lo),
            out_hi=jnp.asarray(jt.out_hi),
            ops_kind=jnp.asarray(jt.ops_kind.astype(np.int32)),
            ops_site=jnp.asarray(jt.ops_site),
            ops_allele=jnp.asarray(jt.ops_allele),
            size=fm.size,
            n_outcomes=jt.max_outcomes,
            n_ops=jt.max_ops,
        )


jax.tree_util.register_dataclass(
    DeviceIndex,
    data_fields=["occ", "narrow_tab", "sym_start", "sa", "marker_prefix",
                 "marker_sa_pos", "pos_to_locus", "marker_rank_locus",
                 "sentinel_row", "out_lo", "out_hi", "ops_kind", "ops_site",
                 "ops_allele"],
    meta_fields=["size", "n_outcomes", "n_ops"],
)


