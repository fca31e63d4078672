"""Device-side selection + coverage recording.

Round-1's engine ran the vBWT scan on device but shipped the genealogy
log home every buffer and did path replay, mapping-instance selection
and coverage recording in numpy (coverage_fast.py). Profiling showed
steady-state e2e dominated by exactly that host-side tail:
packed-result transfer + replay + select/record.

This module moves the whole post-scan pipeline onto the device, fused
into the same jit as the scan:

  1. genealogy replay: chase parent pointers for every live pool state
     (bounded-depth gather loop) and apply the jump-table ops root->leaf
     with masked scatters -- the device twin of
     search_jax_log.replay_paths_vectorised;
  2. encapsulated split of no-path states (budgeted occurrence
     expansion + run-merge) and non-variant occurrence counting
     (encapsulated_search.cpp:30-107 semantics);
  3. LocusFinder: traversed + traversing-derived loci + ancestor chains
     (gathers over precomputed per-site ancestor tables), sorted
     dedup, site-uniqueness / allele-conflict checks -> fallback flags
     (coverage_common.cpp:10-83);
  4. class grouping by base-site key rows (lexicographic multi-key
     lax.sort, std::map order parity) and the vectorised mt19937
     first-draw uniform pick (coverage_common.cpp:85-177);
  5. recording: per-base coverage as +1/-1 boundary scatters into a
     persistent device DIFF array (prefix-summed once at end of run:
     for all-ones range increments, min(prefix_sum, 65535) equals the
     reference's saturating per-increment adds, allele_base.cpp:240-242)
     and selected loci emitted as compact (row, site, allele) triples
     (host folds allele-sum + grouped counts through the existing
     pending machinery -- cheap and bit-identical).

All sorts are multi-key ``lax.sort`` over int32 operands (JAX runs
32-bit by default; packed 64-bit keys would truncate silently), and the
mt19937 pick arithmetic stays within uint32 (total * floor(2^32-1 /
total) <= 2^32-1). Everything is fixed-shape; states/rows that exceed a
static budget or hit a hard edge case (duplicate site in one path, RNG
rejection branch, chain deeper than the cap) set a per-row fallback
flag and are re-done exactly by the host scalar path -- never silently
dropped. Fallback rows contribute NOTHING here (triples masked,
envelopes dropped), so device + host contributions are disjoint by
construction.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from ..prg.markers import ALLELE_UNKNOWN
from .jump_table import OP_ENTER, OP_EXIT
from .search import PrgIndex
from .device_index import DeviceIndex

# static budgets (overflow -> per-row host fallback). Per-state caps:
MAX_CHAIN = 32       # genealogy chain depth (events per state)
TCAP = 16            # traversed/traversing loci per state
KCAP = 12            # base (level-1) sites per state (a 150bp read
                     # crosses ~3.4 sites on an M.tb-density graph;
                     # P(>12) ~ 4e-5 vs P(>8) ~ 1% of mapped rows)
# Per-buffer expansion budgets scale with the row count (R): fixed
# budgets worked at 5,000-read buffers but would mass-spill to host
# fallback at throughput-mode buffer sizes. R is a static (sticky)
# shape, so these stay compile-time constants.
ECAP_BASE = 4096     # encapsulated-split occurrence expansion slots
TRCAP_BASE = 4096    # traversing-state occurrence expansion slots
WCAP_BASE = 8192     # per-base walk lanes (selected-state occurrences)
EMITCAP_BASE = 32768  # per-base walk emissions per buffer
LCAP_BASE = 61440    # compacted traversed-loci lanes: sum of n_trav over
                     # live pool states + enc lanes ~ 0.8*R rows x ~3.4
                     # crossed sites = ~2.8/row; budget 6/row (r5's first
                     # 16384-base budget mass-spilled 34k rows/buffer)


def buffer_caps(R: int):
    """(ecap, trcap, wcap, emitcap, lcap) for an R-row buffer: the
    round-2 constants at R<=10240, scaled linearly above."""
    s = max(R, 10240)
    return (max(ECAP_BASE, (ECAP_BASE * s) // 10240),
            max(TRCAP_BASE, (TRCAP_BASE * s) // 10240),
            max(WCAP_BASE, (WCAP_BASE * s) // 10240),
            max(EMITCAP_BASE, (EMITCAP_BASE * s) // 10240),
            max(LCAP_BASE, (LCAP_BASE * s) // 10240))

# fallback reason bits (per-row int32 mask; 0 = no fallback). Kept as
# a mask all the way to the host so tuning can see WHICH class fires.
FB_CHAIN = 1        # genealogy chain deeper than MAX_CHAIN / TCAP paths
FB_ENC = 2          # encapsulated-split expansion spilled ecap
FB_DUP_SITE = 4     # duplicate site in one state's own path
FB_TRAV = 8         # traversing-state expansion spilled trcap
FB_KCAP = 16        # more base sites per state than KCAP
FB_CONFLICT = 32    # same (state, site) with conflicting alleles
FB_RNG = 64         # mt19937 uniform_int rejection branch
FB_TRIPS = 128      # selected loci spilled trip_cap
FB_WALK = 256       # per-base walk lanes spilled wcap
FB_EMIT = 512       # per-base emissions spilled emitcap
FB_LOCI = 1024      # compacted traversed-loci lanes spilled lcap
FB_NAMES = {FB_CHAIN: "chain_depth", FB_ENC: "encapsulated_spill",
            FB_DUP_SITE: "dup_site", FB_TRAV: "traversing_spill",
            FB_KCAP: "kcap", FB_CONFLICT: "allele_conflict",
            FB_RNG: "rng_rejection", FB_TRIPS: "trip_spill",
            FB_WALK: "walk_spill", FB_EMIT: "emit_spill",
            FB_LOCI: "loci_spill"}

_URNG_RANGE = (1 << 32) - 1
_PAD = -1            # key padding: sorts before any site marker (>= 5)
# host-side scalar, NOT jnp: an eager jax.Array module constant embeds a
# device Array in every traced program, and lowering then calls ._value
# on it -- a device round trip at import time of every process.
_BIG = np.int32(2 ** 30)


@dataclass
class RecordTables:
    """Graph/selection tables staged on device for the record pipeline."""

    ra_node: jnp.ndarray        # (len_prg,) int32: PRG position -> node
    ra_offset: jnp.ndarray      # (len_prg,) int32: offset within node seq
    nt_site: jnp.ndarray        # (n_nodes,) int32 site marker or 0
    nt_allele: jnp.ndarray      # (n_nodes,) int32 (ALLELE_UNKNOWN = -1)
    nt_seq_len: jnp.ndarray     # (n_nodes,) int32
    nt_in_bubble: jnp.ndarray   # (n_nodes,) bool
    nt_n_edges: jnp.ndarray     # (n_nodes,) int32
    nt_edge_off: jnp.ndarray    # (n_nodes+1,) int32 CSR offsets
    nt_edges: jnp.ndarray       # (n_edges,) int32
    nt_cov_start: jnp.ndarray   # (n_nodes,) int32 (-1 = no coverage)
    anc_len: jnp.ndarray        # (n_sites,) int32 ancestor-chain lengths
    anc_site: jnp.ndarray       # (n_sites, A) int32
    anc_allele: jnp.ndarray     # (n_sites, A) int32
    base_site: jnp.ndarray      # (n_sites,) int32 level-1 ancestor marker
    nt_walk: jnp.ndarray        # (n_nodes, 4) int32 [n_edges, seq_len,
                                #  in_bubble, edge_off]: the per-base
                                #  walk's per-iteration node metadata as
                                #  ONE row gather
    cov_size: int               # flat per-base coverage length
    n_nodes: int
    max_anc: int

    @classmethod
    def build(cls, idx: PrgIndex) -> "RecordTables":
        from .coverage_fast import SiteMeta

        g = idx.graph
        nt = g.node_tables()
        sm = SiteMeta(idx)
        return cls(
            ra_node=jnp.asarray(g.ra_node.astype(np.int32)),
            ra_offset=jnp.asarray(g.ra_offset.astype(np.int32)),
            nt_site=jnp.asarray(nt.site_id.astype(np.int32)),
            nt_allele=jnp.asarray(nt.allele_id.astype(np.int32)),
            nt_seq_len=jnp.asarray(nt.seq_len.astype(np.int32)),
            nt_in_bubble=jnp.asarray(nt.in_bubble),
            nt_n_edges=jnp.asarray(nt.n_edges.astype(np.int32)),
            nt_edge_off=jnp.asarray(nt.edge_offset.astype(np.int32)),
            nt_edges=jnp.asarray(nt.edges.astype(np.int32)),
            nt_cov_start=jnp.asarray(nt.cov_start.astype(np.int32)),
            anc_len=jnp.asarray(sm.anc_len.astype(np.int32)),
            anc_site=jnp.asarray(sm.anc_site.astype(np.int32)),
            anc_allele=jnp.asarray(sm.anc_allele.astype(np.int32)),
            base_site=jnp.asarray(sm.base_site.astype(np.int32)),
            nt_walk=jnp.asarray(np.stack([
                nt.n_edges.astype(np.int32),
                nt.seq_len.astype(np.int32),
                nt.in_bubble.astype(np.int32),
                nt.edge_offset[:nt.seq_len.size].astype(np.int32)], axis=1)),
            cov_size=int(g.coverage.size),
            n_nodes=int(nt.seq_len.size),
            max_anc=int(sm.max_depth),
        )


jax.tree_util.register_dataclass(
    RecordTables,
    data_fields=["ra_node", "ra_offset", "nt_site", "nt_allele", "nt_seq_len",
                 "nt_in_bubble", "nt_n_edges", "nt_edge_off", "nt_edges",
                 "nt_cov_start", "anc_len", "anc_site", "anc_allele",
                 "base_site", "nt_walk"],
    meta_fields=["cov_size", "n_nodes", "max_anc"],
)


@dataclass
class SeedTables:
    """The kmer index's seed-state payloads, RESIDENT on device.

    Shipping per-buffer gathered copies of the seed path arrays (two
    (n_states, P, 2) int32 pads ~= 22MB at throughput buffer sizes)
    would put that transfer on every buffer. These tables are
    uploaded ONCE per index; per buffer only the placed state INDICES
    cross the link and the device gathers payloads locally. Paths are
    CSR-packed ((sum n_trav, 2) flat + per-state offsets) -- most seed
    states carry 0-2 path entries, so the dense (Ns, P, 2) layout is
    ~90% padding."""

    k_lo: jnp.ndarray       # (Ns,) int32 seed SA interval lo
    k_hi: jnp.ndarray       # (Ns,) int32
    k_nt: jnp.ndarray       # (Ns,) int32 traversed-path lengths
    k_ni: jnp.ndarray       # (Ns,) int32 traversing-path lengths
    k_toff: jnp.ndarray     # (Ns,) int32 CSR offsets into t_flat
    k_ioff: jnp.ndarray     # (Ns,) int32 CSR offsets into i_flat
    t_flat: jnp.ndarray     # (sum n_trav | 1, 2) int32
    i_flat: jnp.ndarray     # (sum n_ing | 1, 2) int32
    n_states: int
    max_path: int

    @classmethod
    def build(cls, kmer_index) -> "SeedTables":
        def csr(arr, lens):
            lens64 = lens.astype(np.int64)
            off = np.zeros(lens64.size, np.int64)
            off[1:] = np.cumsum(lens64)[:-1]
            total = int(lens64.sum())
            rows = np.repeat(np.arange(lens64.size), lens64)
            slots = np.arange(total) - np.repeat(off, lens64)
            flat = (arr[rows, slots].astype(np.int32) if total
                    else np.zeros((1, 2), np.int32))
            return off.astype(np.int32), flat

        toff, t_flat = csr(kmer_index.trav, kmer_index.n_trav)
        ioff, i_flat = csr(kmer_index.ing, kmer_index.n_ing)
        return cls(
            k_lo=jnp.asarray(kmer_index.lo.astype(np.int32)),
            k_hi=jnp.asarray(kmer_index.hi.astype(np.int32)),
            k_nt=jnp.asarray(kmer_index.n_trav.astype(np.int32)),
            k_ni=jnp.asarray(kmer_index.n_ing.astype(np.int32)),
            k_toff=jnp.asarray(toff), k_ioff=jnp.asarray(ioff),
            t_flat=jnp.asarray(t_flat), i_flat=jnp.asarray(i_flat),
            n_states=int(kmer_index.lo.size),
            max_path=int(kmer_index.trav.shape[1]),
        )


jax.tree_util.register_dataclass(
    SeedTables,
    data_fields=["k_lo", "k_hi", "k_nt", "k_ni", "k_toff", "k_ioff",
                 "t_flat", "i_flat"],
    meta_fields=["n_states", "max_path"],
)


# --------------------------------------------------------------------------
# stage 1: genealogy replay on device
# --------------------------------------------------------------------------


def replay_device(di: DeviceIndex, f_pref, log_parent, log_event,
                  st: "SeedTables", alive, stage: int = 99):
    """Rebuild (trav, n_trav, ing, n_ing) for every pool state.

    f_pref: (N,) genealogy refs (negative = GLOBAL seed-state index
    -p-1 into the resident SeedTables); alive: (N,) bool. Returns trav
    (N, TCAP, 2), n_trav, ing (N, TCAP, 2), n_ing, bad (N,) bool (chain
    depth / path capacity overflow)."""
    N = f_pref.shape[0]
    Lg = max(log_event.shape[0], 1)
    le = log_event if log_event.shape[0] else jnp.zeros(1, jnp.int32)
    lp = log_parent if log_parent.shape[0] else jnp.zeros(1, jnp.int32)

    # chain chase with DYNAMIC depth: production chains are ~#sites the
    # read crossed (3-6), so running the static MAX_CHAIN=32 levels
    # wasted ~6x device iterations; the while_loop stops when every
    # chain hit its seed (the per-iteration any() reduction is cheap
    # next to the (N,) gathers it saves)
    lple = jnp.stack([lp, le], axis=1)     # (Lg, 2): one row gather/level

    def chase_cond(carry):
        p, events, d = carry
        return jnp.any(p >= 0) & (d < MAX_CHAIN)

    def chase(carry):
        p, events, d = carry
        live = p >= 0
        pc = jnp.clip(p, 0, Lg - 1)
        rows = lple[pc]                    # (N, 2)
        ev = jnp.where(live, rows[:, 1], -1)
        events = jax.lax.dynamic_update_index_in_dim(events, ev, d, axis=0)
        p = jnp.where(live, rows[:, 0], p)
        return p, events, d + 1

    p0 = jnp.where(alive, f_pref, jnp.full_like(f_pref, -1))
    p, events, depth = jax.lax.while_loop(
        chase_cond, chase,
        (p0, jnp.full((MAX_CHAIN, N), -1, jnp.int32), jnp.int32(0)))
    bad = alive & (p >= 0)  # chain longer than MAX_CHAIN
    seed_idx = jnp.clip(-p - 1, 0, max(st.n_states - 1, 0))
    if stage <= 1:                     # chase loop only
        z2 = jnp.zeros((N, TCAP, 2), jnp.int32)
        zn = jnp.sum(events, axis=0).astype(jnp.int32) * 0
        return z2, zn + seed_idx.astype(jnp.int32) * 0, z2, zn, bad

    # seed paths gathered from the RESIDENT CSR tables by global index
    P0c = min(st.max_path, TCAP)
    trav = jnp.zeros((N, TCAP, 2), jnp.int32)
    ing = jnp.zeros((N, TCAP, 2), jnp.int32)
    n_trav = st.k_nt[seed_idx].astype(jnp.int32)
    n_ing = st.k_ni[seed_idx].astype(jnp.int32)
    if P0c:
        sl = jnp.arange(P0c, dtype=jnp.int32)
        tg = jnp.clip(st.k_toff[seed_idx][:, None] + sl[None, :], 0,
                      st.t_flat.shape[0] - 1)
        ig = jnp.clip(st.k_ioff[seed_idx][:, None] + sl[None, :], 0,
                      st.i_flat.shape[0] - 1)
        tmask = (sl[None, :] < n_trav[:, None])[:, :, None]
        imask = (sl[None, :] < n_ing[:, None])[:, :, None]
        trav = trav.at[:, :P0c].set(jnp.where(tmask, st.t_flat[tg], 0))
        ing = ing.at[:, :P0c].set(jnp.where(imask, st.i_flat[ig], 0))
    bad |= alive & ((n_trav > TCAP) | (n_ing > TCAP))
    if stage <= 2:                     # + seed-path gather
        return trav, n_trav, ing, n_ing, bad

    kind2 = di.ops_kind.reshape(-1, di.n_ops)
    site2 = di.ops_site.reshape(-1, di.n_ops)
    allele2 = di.ops_allele.reshape(-1, di.n_ops)
    ar = jnp.arange(N)

    # apply root->leaf: start at the deepest level the chase actually
    # reached (events past the chain end are -1); paired (site, allele)
    # writes land in ONE row scatter each
    def apply_level(carry):
        trav, n_trav, ing, n_ing, bad, d = carry
        ev = jax.lax.dynamic_index_in_dim(events, jnp.maximum(d, 0),
                                          axis=0, keepdims=False)
        valid = ev >= 0
        evc = jnp.clip(ev, 0, kind2.shape[0] - 1)
        # ONE (N, O) row gather per table per level (not O element
        # gathers): gather cost is per gathered ROW on this hardware
        kind_rows = kind2[evc]
        site_rows = site2[evc]
        allele_rows = allele2[evc]
        for o in range(di.n_ops):
            kind = jnp.where(valid, kind_rows[:, o], 0)
            site = site_rows[:, o]
            allele = allele_rows[:, o]
            is_exit = kind == OP_EXIT
            is_enter = kind == OP_ENTER
            # exit: pop traversing (if any), append (site, allele)
            n_ing = jnp.where(is_exit & (n_ing > 0), n_ing - 1, n_ing)
            wpos = jnp.where(is_exit, jnp.minimum(n_trav, TCAP), TCAP)
            trav = trav.at[ar, wpos].set(
                jnp.stack([site, allele], axis=1), mode="drop")
            bad = bad | (is_exit & (n_trav >= TCAP))
            n_trav = jnp.where(is_exit, jnp.minimum(n_trav + 1, TCAP), n_trav)
            # enter: push (site, ALLELE_UNKNOWN)
            wpos = jnp.where(is_enter, jnp.minimum(n_ing, TCAP), TCAP)
            ing = ing.at[ar, wpos].set(
                jnp.stack([site, jnp.full_like(site, ALLELE_UNKNOWN)],
                          axis=1), mode="drop")
            bad = bad | (is_enter & (n_ing >= TCAP))
            n_ing = jnp.where(is_enter, jnp.minimum(n_ing + 1, TCAP), n_ing)
        return trav, n_trav, ing, n_ing, bad, d - 1

    trav, n_trav, ing, n_ing, bad, _ = jax.lax.while_loop(
        lambda c: c[5] >= 0, apply_level,
        (trav, n_trav, ing, n_ing, bad, depth - 1))
    return trav, n_trav, ing, n_ing, bad


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def _expand_budget(widths, cap: int):
    """Device twin of coverage_fast._expand with a static output budget.

    widths: (M,) int32 >= 0. Returns (item_of (cap,), offset (cap,),
    valid (cap,), spilled (M,) -- item had occurrences past the cap).

    item_of comes from a run-start scatter + prefix-max instead of
    searchsorted: the binary search was log2(M) dependent gather rounds
    over (cap,) and measured as the dominant block of the select
    pipeline (tools/profile_record_device.py stage 1); the scatter +
    associative max-scan are plain vector ops."""
    import os as _os
    widths = widths.astype(jnp.int32)
    M = widths.shape[0]
    cum = jnp.cumsum(widths)
    total = cum[-1]
    start = cum - widths                       # (M,) run starts
    nz = widths > 0
    g = jnp.arange(cap, dtype=jnp.int32)
    if _os.environ.get("GRAMTOOLS_TPU_EXPAND", "scan") == "searchsorted":
        item_of = jnp.searchsorted(cum, g, side="right")
        item_of = jnp.clip(item_of, 0, max(M - 1, 0))
    else:
        # mark each run's start lane with item_index + 1 (0 = before any
        # run); run starts are strictly increasing over nz items, so
        # marks never collide. prefix-max fills each run with its owner.
        marks = jnp.zeros(cap, jnp.int32).at[
            jnp.where(nz & (start < cap), jnp.clip(start, 0, cap - 1), cap)
        ].max(jnp.arange(1, M + 1, dtype=jnp.int32), mode="drop")
        item_of = jax.lax.associative_scan(jnp.maximum, marks) - 1
        item_of = jnp.clip(item_of, 0, max(M - 1, 0))
    valid = g < jnp.minimum(total, cap)
    offset = g - start[item_of]
    spilled = nz & (cum > cap)
    return item_of, offset.astype(jnp.int32), valid, spilled


def _segment_first(group_start_flags):
    """Index of each element's group start (prefix-max of flagged idx)."""
    n = group_start_flags.shape[0]
    idx = jnp.where(group_start_flags, jnp.arange(n, dtype=jnp.int32), 0)
    return jax.lax.associative_scan(jnp.maximum, idx)


def _flag_rows(R, cond, rows):
    """(R,) bool with True at rows[i] where cond[i] (out-of-range drops)."""
    return jnp.zeros(R, bool).at[jnp.where(cond, rows, R)].set(
        True, mode="drop")


def _flag_rows_bit(R, cond, rows, bit):
    """(R,) int32 with `bit` at rows[i] where cond[i]."""
    return jnp.zeros(R, jnp.int32).at[jnp.where(cond, rows, R)].max(
        jnp.int32(bit), mode="drop")


def _neighbor_diff(*cols):
    """Element i differs from i-1 in any column (True at i=0)."""
    out = None
    for c in cols:
        d = jnp.concatenate([jnp.ones(1, bool), c[1:] != c[:-1]])
        out = d if out is None else (out | d)
    return out


# --------------------------------------------------------------------------
# stages 2-5
# --------------------------------------------------------------------------


def select_and_record_device(
        di: DeviceIndex, rt: RecordTables,
        # final pool states (N,):
        f_rid, f_lo, f_hi, trav, n_trav, ing, n_ing, state_bad,
        # per row (R,):
        row_ok, row_first_raw, row_len,
        # persistent coverage diff array (cov_size+1,) int32:
        cov_diff, trip_cap: int = 0, stage: int = 99):
    """Selection + recording for one scanned buffer.

    Returns (fallback (R,), mapped (R,), trip_row, trip_site,
    trip_allele, cov_diff) -- trip arrays are (trip_cap,) sorted by
    (row, site, allele) with row > R marking unused slots; duplicates
    (multiple chosen-class states sharing a locus) are left in for the
    host's neighbour-dedup. Semantics twin of
    coverage_fast.select_and_record.

    ``stage`` is an OBSERVABILITY knob (tools/profile_record_device.py):
    values < 99 return shape-compatible dummies after the numbered block
    so each block's device cost can be measured as a prefix delta.
    Production callers never pass it."""
    if trip_cap <= 0:
        trip_cap = 16 * row_ok.shape[0]
    N = f_rid.shape[0]
    R = row_ok.shape[0]
    ecap, trcap, wcap, emitcap, lcap = buffer_caps(R)

    def _stage_out(fallback, cov_diff):
        z = jnp.zeros(trip_cap, jnp.int32)
        return (fallback, jnp.zeros(R, bool), jnp.full(trip_cap, R + 1,
                                                       jnp.int32), z, z,
                cov_diff)
    ar_n = jnp.arange(N)
    rid_c = jnp.clip(f_rid, 0, R - 1)
    alive = (f_rid >= 0) & row_ok[rid_c]
    fallback = _flag_rows_bit(R, state_bad & alive, rid_c, FB_CHAIN)

    if stage <= 0:                     # measurement floor (plumbing only)
        return _stage_out(fallback, cov_diff)

    has_path = (n_trav > 0) | (n_ing > 0)

    # ---- encapsulated split of no-path states ------------------------------
    np_mask = alive & ~has_path
    widths = jnp.where(np_mask, f_hi - f_lo + 1, 0).astype(jnp.int32)
    e_item, e_off, e_valid, e_spill = _expand_budget(widths, ecap)
    fallback |= _flag_rows_bit(R, e_spill, rid_c, FB_ENC)
    occ_sa = jnp.clip(f_lo[e_item] + e_off, 0, di.size - 1)
    occ_node = rt.ra_node[jnp.clip(di.sa[occ_sa], 0,
                                   rt.ra_node.shape[0] - 1)]
    occ_site = jnp.where(e_valid, rt.nt_site[occ_node], 0)
    occ_allele = rt.nt_allele[occ_node]
    occ_row = rid_c[e_item]

    nonvar = jnp.zeros(R + 1, jnp.int32).at[
        jnp.where(e_valid & (occ_site == 0), occ_row, R)].add(
        1, mode="drop")[:R]

    # run-merge consecutive same-(item, site, allele) occurrences: each
    # run becomes one encapsulated pseudo-state at its start lane
    enc = e_valid & (occ_site > 0)
    prev_same = jnp.concatenate([
        jnp.zeros(1, bool),
        (e_item[1:] == e_item[:-1]) & (occ_site[1:] == occ_site[:-1])
        & (occ_allele[1:] == occ_allele[:-1]) & enc[:-1] & enc[1:]])
    enc_start = enc & ~prev_same
    nxt_same = jnp.concatenate([prev_same[1:], jnp.zeros(1, bool)])
    run_first = _segment_first(enc_start | ~enc)
    enc_hi = jnp.zeros(ecap + 1, jnp.int32).at[
        jnp.where(enc & ~nxt_same, run_first, ecap)].set(
        occ_sa.astype(jnp.int32), mode="drop")[:ecap]

    # ---- unified state table: N pool states then ecap enc lanes ------------
    NS = N + ecap
    ps_row = jnp.concatenate([rid_c, occ_row])
    ps_live = jnp.concatenate([alive & has_path, enc_start])
    ps_lo = jnp.concatenate([f_lo.astype(jnp.int32),
                             occ_sa.astype(jnp.int32)])
    ps_hi = jnp.concatenate([f_hi.astype(jnp.int32), enc_hi])
    ps_ntrav = jnp.concatenate([
        jnp.where(alive & has_path, n_trav, 0),
        jnp.where(enc_start, 1, 0).astype(n_trav.dtype)])
    ps_ning = jnp.concatenate([jnp.where(alive & has_path, n_ing, 0),
                               jnp.zeros(ecap, n_ing.dtype)])
    enc_trav = jnp.zeros((ecap, TCAP, 2), jnp.int32)
    enc_trav = enc_trav.at[:, 0, 0].set(jnp.where(enc_start, occ_site, 0))
    enc_trav = enc_trav.at[:, 0, 1].set(jnp.where(enc_start, occ_allele, 0))
    ps_trav = jnp.concatenate([trav, enc_trav], axis=0)
    last_i = jnp.clip(n_ing - 1, 0, TCAP - 1)
    ing_parent = jnp.concatenate([
        jnp.where(n_ing > 0, ing[ar_n, last_i, 0], 0),
        jnp.zeros(ecap, jnp.int32)])

    if stage <= 1:                     # enc split + unified table
        return _stage_out(fallback, cov_diff)

    # ---- site-uniqueness (duplicate site within one state's own path) ------
    slot = jnp.arange(TCAP, dtype=jnp.int32)[None, :]
    own_t = jnp.where(slot < ps_ntrav[:, None], ps_trav[:, :, 0],
                      jnp.int32(2 ** 28) + slot)
    ing_pad = jnp.concatenate([ing, jnp.zeros((ecap, TCAP, 2), jnp.int32)],
                              axis=0)
    own_i = jnp.where(slot < ps_ning[:, None], ing_pad[:, :, 0],
                      jnp.int32(2 ** 28) + TCAP + slot)
    own = jnp.sort(jnp.concatenate([own_t, own_i], axis=1), axis=1)
    dup_site = jnp.any(own[:, 1:] == own[:, :-1], axis=1) & ps_live
    fallback |= _flag_rows_bit(R, dup_site, ps_row, FB_DUP_SITE)

    if stage <= 2:                     # + dup-site block
        return _stage_out(fallback, cov_diff)

    # ---- loci: traversed + traversing-derived + ancestors -------------------
    # COMPACTED via a budget expansion: the dense (NS, TCAP) lane grid
    # is ~80% padding (mean n_trav ~3.4 of TCAP=16) and every downstream
    # 3-key sort paid for it -- the sorts were the measured bulk of the
    # fused record program (tools/profile_record_device.py)
    t_counts = jnp.where(ps_live, ps_ntrav.astype(jnp.int32), 0)
    li_item, li_off, li_valid, li_spill = _expand_budget(t_counts, lcap)
    fallback |= _flag_rows_bit(R, li_spill, ps_row, FB_LOCI)
    l1_pair = ps_trav[li_item, jnp.clip(li_off, 0, TCAP - 1)]  # (lcap, 2)
    l1_state = li_item
    l1_site = l1_pair[:, 0]
    l1_allele = l1_pair[:, 1]
    l1_valid = li_valid

    tr_w = jnp.where(ps_live & (ps_ning > 0), ps_hi - ps_lo + 1, 0)
    tr_item, tr_off, tr_valid, tr_spill = _expand_budget(
        tr_w.astype(jnp.int32), trcap)
    fallback |= _flag_rows_bit(R, tr_spill, ps_row, FB_TRAV)
    tr_sa = jnp.clip(ps_lo[tr_item] + tr_off, 0, di.size - 1)
    tr_node = rt.ra_node[jnp.clip(di.sa[tr_sa], 0, rt.ra_node.shape[0] - 1)]
    l2_state = tr_item
    l2_site = jnp.where(tr_valid, ing_parent[tr_item], 0)
    l2_allele = rt.nt_allele[tr_node]
    l2_valid = tr_valid

    base_state = jnp.concatenate([l1_state, l2_state])
    base_site_m = jnp.concatenate([l1_site, l2_site])
    base_allele = jnp.concatenate([l1_allele, l2_allele])
    base_valid = jnp.concatenate([l1_valid, l2_valid]) & (base_site_m >= 5)

    A = max(rt.max_anc, 0)
    sidx = jnp.clip((base_site_m - 5) // 2, 0, rt.anc_len.shape[0] - 1)
    parts = [(base_state, base_site_m, base_allele, base_valid)]
    for a in range(A):
        parts.append((base_state, rt.anc_site[sidx, a],
                      rt.anc_allele[sidx, a],
                      base_valid & (a < rt.anc_len[sidx])))
    l_state = jnp.concatenate([p[0] for p in parts])
    l_site = jnp.concatenate([p[1] for p in parts])
    l_allele = jnp.concatenate([p[2] for p in parts])
    l_valid = jnp.concatenate([p[3] for p in parts])

    # ---- dedup loci per (state, site, allele); conflicts -> fallback --------
    l_key = jnp.where(l_valid, l_state, NS + 1)  # invalid sorts last
    trip_state, trip_site, trip_allele = jax.lax.sort(
        (l_key, l_site, l_allele), num_keys=3)
    k_valid = trip_state <= NS  # NS+1 = invalid
    uniq = _neighbor_diff(trip_state, trip_site, trip_allele)
    trip_keep = uniq & k_valid
    trip_state = jnp.clip(trip_state, 0, NS - 1)
    same_ss = trip_keep & ~_neighbor_diff(trip_state, trip_site) \
        & jnp.concatenate([jnp.zeros(1, bool), trip_keep[:-1]])
    fallback |= _flag_rows_bit(R, same_ss, ps_row[trip_state],
                               FB_CONFLICT)
    LT = trip_state.shape[0]

    if stage <= 3:                     # + loci build + dedup sort
        return _stage_out(fallback, cov_diff)

    # ---- base-site key rows per state ---------------------------------------
    b_base = rt.base_site[
        jnp.clip((trip_site - 5) // 2, 0, rt.base_site.shape[0] - 1)]
    b_key = jnp.where(trip_keep, trip_state, NS + 1)
    kb_state, kb_site = jax.lax.sort((b_key, b_base), num_keys=2)
    b_uniq = _neighbor_diff(kb_state, kb_site) & (kb_state <= NS)
    st_start = _neighbor_diff(kb_state)
    # position of each unique (state, base) within its state: count of
    # unique entries since the state's first element
    uniq_cum = jnp.cumsum(b_uniq.astype(jnp.int32))
    first_idx = _segment_first(st_start)
    uniq_before_state = jnp.where(
        first_idx > 0, uniq_cum[jnp.maximum(first_idx - 1, 0)], 0)
    pos_in_state = uniq_cum - 1 - uniq_before_state
    too_many = b_uniq & (pos_in_state >= KCAP)
    fallback |= _flag_rows_bit(R, too_many,
                               ps_row[jnp.clip(kb_state, 0, NS - 1)], FB_KCAP)
    key_mat = jnp.full((NS + 1, KCAP), _PAD, jnp.int32)
    key_mat = key_mat.at[
        jnp.where(b_uniq & ~too_many, kb_state, NS),
        jnp.clip(pos_in_state, 0, KCAP - 1)].set(kb_site, mode="drop")
    key_mat = key_mat[:NS]

    # ---- classes per row: lexicographic multi-key sort ----------------------
    sort_row = jnp.where(ps_live, ps_row, R)
    operands = tuple([sort_row] + [key_mat[:, c] for c in range(KCAP)]
                     + [jnp.arange(NS, dtype=jnp.int32)])
    sorted_ops = jax.lax.sort(operands, num_keys=KCAP + 1)
    s_row = sorted_ops[0]
    s_keys = sorted_ops[1:KCAP + 1]
    s_state = sorted_ops[KCAP + 1]
    live_s = s_row < R
    new_row = _neighbor_diff(s_row)
    new_class = (new_row | _neighbor_diff(*s_keys)) & live_s
    class_id = jnp.cumsum(new_class.astype(jnp.int32)) - 1
    row_first_class = class_id[_segment_first(new_row)]
    class_ord = class_id - row_first_class
    n_classes = jnp.zeros(R + 1, jnp.int32).at[
        jnp.where(new_class, s_row, R)].add(1, mode="drop")[:R]

    # ---- uniform pick per row (libstdc++ uniform_int first draw) ------------
    # all quantities fit in uint32: scaling = floor((2^32-1)/total), and
    # past = total * scaling <= 2^32-1 by construction
    total = nonvar + n_classes
    active_row = n_classes > 0
    totals = jnp.maximum(total, 1).astype(jnp.uint32)
    scaling = jnp.uint32(_URNG_RANGE) // totals
    past = totals * scaling
    rdraw = row_first_raw.astype(jnp.uint32)
    fallback |= jnp.where(active_row & (rdraw >= past),
                          jnp.int32(FB_RNG), 0)  # rejection branch -> host
    selected = 1 + (rdraw // jnp.maximum(scaling, jnp.uint32(1))).astype(
        jnp.int32)
    chosen_ord = selected - nonvar - 1
    do_record = active_row & (chosen_ord >= 0) & (chosen_ord < n_classes)

    s_row_c = jnp.clip(s_row, 0, R - 1)
    sel_sorted = live_s & do_record[s_row_c] & (class_ord ==
                                                chosen_ord[s_row_c])
    st_selected = jnp.zeros(NS, bool).at[s_state].set(sel_sorted)

    mapped = _flag_rows(R, alive, rid_c)  # any live state => "mapped"

    if stage <= 4:                     # + key rows + class sort + pick
        return _stage_out(fallback, cov_diff)

    # ---- preliminary triple-capacity check (BEFORE per-base recording, so
    # spilled rows can still fall back cleanly with zero device traces) ----
    t_row = ps_row[trip_state]
    t_sel = trip_keep & st_selected[trip_state] & (fallback[t_row] == 0)
    t_key = jnp.where(t_sel, t_row, R + 1)
    pre_row = jax.lax.sort(t_key)
    if t_key.shape[0] > trip_cap:
        over = pre_row[trip_cap:]
        fallback |= _flag_rows_bit(R, over <= R, jnp.clip(over, 0, R - 1),
                                   FB_TRIPS)

    if stage <= 5:                     # + preliminary trip check
        return _stage_out(fallback, cov_diff)

    # ---- per-base coverage (may add fallback rows; do it before triples) ---
    cov_diff, fallback = _record_per_base_device(
        di, rt, ps_row, ps_lo, ps_hi, ps_trav, ps_ntrav, st_selected,
        row_len, fallback, cov_diff, wcap, emitcap)

    if stage <= 6:                     # + per-base walk + envelope
        return _stage_out(fallback, cov_diff)

    # ---- triples of the chosen classes, compact prefix of the sort ----------
    # fallback only grew since the preliminary check, so the valid prefix
    # is guaranteed to fit in trip_cap
    t_sel = trip_keep & st_selected[trip_state] & (fallback[t_row] == 0)
    t_key = jnp.where(t_sel, t_row, R + 1)
    trip_row_o, trip_site_o, trip_allele_o = jax.lax.sort(
        (t_key, trip_site, trip_allele), num_keys=3)
    pad = max(trip_cap - trip_row_o.shape[0], 0)
    if pad:
        trip_row_o = jnp.concatenate(
            [trip_row_o, jnp.full(pad, R + 1, jnp.int32)])
        trip_site_o = jnp.concatenate([trip_site_o, jnp.zeros(pad, jnp.int32)])
        trip_allele_o = jnp.concatenate(
            [trip_allele_o, jnp.zeros(pad, jnp.int32)])
    return (fallback, mapped, trip_row_o[:trip_cap], trip_site_o[:trip_cap],
            trip_allele_o[:trip_cap], cov_diff)


def _record_per_base_device(di, rt, ps_row, ps_lo, ps_hi, ps_trav, ps_ntrav,
                            st_selected, row_len, fallback, cov_diff,
                            wcap=WCAP_BASE, emitcap=EMITCAP_BASE):
    """Device twin of coverage_fast._run_walks + envelope + apply.

    Walk lanes = occurrence expansion of selected states; emissions
    (read, node, start, end) -> envelope per (read, node) via sorted
    segment min/max -> +1/-1 boundary scatters on the persistent diff
    array. Returns (cov_diff, fallback-with-additions)."""
    R = row_len.shape[0]
    w = jnp.where(st_selected, ps_hi - ps_lo + 1, 0).astype(jnp.int32)
    w_item, w_off, w_valid, w_spill = _expand_budget(w, wcap)
    fallback = fallback | _flag_rows_bit(R, w_spill, ps_row, FB_WALK)

    occ_sa = jnp.clip(ps_lo[w_item] + w_off, 0, di.size - 1)
    prg_pos = jnp.clip(di.sa[occ_sa], 0, rt.ra_node.shape[0] - 1)
    cur0 = rt.ra_node[prg_pos].astype(jnp.int32)
    start0 = rt.ra_offset[prg_pos].astype(jnp.int32)
    read_of = jnp.clip(ps_row[w_item], 0, R - 1)
    remaining0 = row_len[read_of].astype(jnp.int32)
    full = w_off == 0
    trav_idx0 = ps_ntrav[w_item].astype(jnp.int32)
    trav_w = ps_trav[w_item]        # (wcap, TCAP, 2)

    # State tuple layout (lane-count generic so the long-tail phase can
    # run over a COMPACTED lane set -- see below):
    # (active, first_iter, cur, start, remaining, trav_idx,
    #  trav_l (lanes,TCAP,2), read_l, full_l, emits, cursor, spill)

    def make_body(lanes: int):
        ar = jnp.arange(lanes)

        def body(state):
            (active, first_iter, cur, start, remaining, trav_idx,
             trav_l, read_l, full_l, emits, cursor, spill) = state
            # per-iteration node metadata: ONE (lanes, 4) row gather
            wrows = rt.nt_walk[cur]
            n_edges = wrows[:, 0]
            move = active & ~first_iter
            dead = move & ((remaining <= 0) | (n_edges == 0))
            active = active & ~dead
            move = move & ~dead

            is_bubble_entry = move & (n_edges > 1)
            trav_idx = jnp.where(is_bubble_entry, trav_idx - 1, trav_idx)
            choice = jnp.where(
                is_bubble_entry,
                trav_l[ar, jnp.clip(trav_idx, 0, TCAP - 1), 1], 0)
            nxt = rt.nt_edges[jnp.clip(wrows[:, 3] + choice, 0,
                                       rt.nt_edges.shape[0] - 1)]
            cur = jnp.where(move, nxt, cur)
            start = jnp.where(move, 0, start)
            wrows = jnp.where(move[:, None], rt.nt_walk[cur], wrows)

            consume = active & (first_iter | move)
            seq_len = wrows[:, 1]
            in_bubble = wrows[:, 2] > 0
            has_seq = seq_len > 0
            end = jnp.where(
                has_seq, jnp.minimum(seq_len - 1, start + remaining - 1), 0)
            used = jnp.where(consume & has_seq, end - start + 1, 0)
            remaining = remaining - used

            emit = consume & has_seq & in_bubble
            pos_in = jnp.cumsum(emit.astype(jnp.int32)) - 1
            dest = jnp.where(emit, cursor + pos_in, emitcap)
            n_emit = jnp.sum(emit.astype(jnp.int32))
            spill = spill | ((cursor + n_emit) > emitcap)
            # all four emission fields in ONE (emitcap+1, 4) row scatter
            erows = jnp.stack([read_l, cur, start, end], axis=1)
            emits = emits.at[dest].set(erows, mode="drop")
            cursor = jnp.minimum(cursor + n_emit, emitcap)

            returned_now = jnp.where(first_iter,
                                     consume & in_bubble,
                                     move & (in_bubble | is_bubble_entry))
            active = active & ~(~full_l & returned_now)
            return (active, jnp.zeros(lanes, bool), cur, start, remaining,
                    trav_idx, trav_l, read_l, full_l, emits, cursor, spill)

        return body

    emits0 = jnp.zeros((emitcap + 1, 4), jnp.int32).at[:, 0].set(_BIG)
    state = (w_valid, jnp.ones(wcap, bool), cur0, start0, remaining0,
             trav_idx0, trav_w, read_of, full, emits0, jnp.int32(0),
             jnp.array(False))

    def _compact(state, cur_w, new_w, fallback):
        """Pack the still-active lanes into a new_w-lane state; lanes
        past the budget flag their row FB_WALK (exact host re-map)."""
        act = state[0]
        rank = jnp.cumsum(act.astype(jnp.int32)) - act.astype(jnp.int32)
        slot = jnp.full((new_w + 1,), cur_w, jnp.int32).at[
            jnp.where(act & (rank < new_w), rank, new_w)].set(
            jnp.arange(cur_w, dtype=jnp.int32), mode="drop")
        sel = jnp.clip(slot[:new_w], 0, cur_w - 1)
        live = slot[:new_w] < cur_w
        spillw = act & (rank >= new_w)
        fallback = fallback | _flag_rows_bit(R, spillw, state[7], FB_WALK)
        packed = (live & state[0][sel],) + tuple(
            state[i][sel] for i in range(1, 9)) + state[9:]
        return packed, fallback

    # EXPERIMENTAL staged schedule (GRAMTOOLS_TPU_WALK_STAGED=1):
    # fixed-width runs with geometric lane compaction, sized from
    # MEASURED lane-walk lengths (a site is ~5 nodes: entry/exit markers
    # + 1bp allele nodes; a 150bp window spans p50=16 / p99=36 / max~51
    # nodes -> compaction at iterations 22/30/38 against budgets 1/2,
    # 1/4, 1/8). OFF BY DEFAULT: it has not been measured on the GPU;
    # profile it against the plain loop before enabling.
    import os as _os
    if _os.environ.get("GRAMTOOLS_TPU_WALK_STAGED", "0") == "1":
        cur_w = wcap
        for n_iter, next_w in ((22, max(wcap // 2, 1024)),
                               (8, max(wcap // 4, 1024)),
                               (8, max(wcap // 8, 1024))):
            body = make_body(cur_w)
            state = jax.lax.fori_loop(0, n_iter, lambda i, s: body(s),
                                      state)
            state, fallback = _compact(state, cur_w, next_w, fallback)
            cur_w = next_w
    else:
        cur_w = wcap
    (_, _, _, _, _, _, _, _, _, emits, _, spill) = jax.lax.while_loop(
        lambda s: jnp.any(s[0]), make_body(cur_w), state)
    e_row = emits[:emitcap, 0]
    e_node = emits[:emitcap, 1]
    e_start = emits[:emitcap, 2]
    e_end = emits[:emitcap, 3]

    # emission spill: capacity bug-out -- every read with a selected state
    # falls back (expected never at the scaled emitcap; ~1 node per
    # crossed site)
    sel_rows = _flag_rows(R, st_selected, ps_row)
    fallback = fallback | jnp.where(spill & sel_rows, jnp.int32(FB_EMIT), 0)

    k_row, k_node, s_s, en_s = jax.lax.sort(
        (e_row, e_node, e_start, e_end), num_keys=2)
    valid_e = k_row < _BIG
    gstart = _neighbor_diff(k_row, k_node)
    first_of = _segment_first(gstart)
    seg_min = jnp.full(emitcap + 1, _BIG).at[
        jnp.where(valid_e, first_of, emitcap)].min(s_s, mode="drop")
    seg_max = jnp.full(emitcap + 1, jnp.int32(-1)).at[
        jnp.where(valid_e, first_of, emitcap)].max(en_s, mode="drop")
    is_rep = gstart & valid_e
    rep_node = jnp.clip(k_node, 0, rt.n_nodes - 1)
    rep_row = jnp.clip(k_row, 0, R - 1)
    keep = is_rep & (fallback[rep_row] == 0)
    covs = rt.nt_cov_start[rep_node]
    keep &= covs >= 0
    ar_e = jnp.arange(emitcap)
    lo_flat = covs + seg_min[ar_e]
    hi_flat = covs + seg_max[ar_e] + 1
    # diff-array boundary adds; slot cov_size doubles as the drop target
    # AND the legitimate end-boundary of last-base ranges -- both lie past
    # the prefix-sum horizon, so the aliasing never reaches counts
    cov_diff = cov_diff.at[jnp.where(keep, lo_flat, rt.cov_size)].add(
        1, mode="drop")
    cov_diff = cov_diff.at[jnp.where(keep, hi_flat, rt.cov_size)].add(
        -1, mode="drop")
    return cov_diff, fallback


def finalise_cov_diff(cov_diff: np.ndarray) -> np.ndarray:
    """Prefix-sum the diff array into per-base counts (uint16 range,
    saturated -- equivalent to per-increment saturation for +1 ranges)."""
    counts = np.cumsum(cov_diff[:-1].astype(np.int64))
    return np.minimum(counts, np.iinfo(np.uint16).max).astype(np.uint16)
