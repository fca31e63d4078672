"""Genealogy-log vBWT search: the scan carries no variant paths at all.

THE production device engine (third generation: the round-1 slot and
flat-pool engines are retired -- one device engine, one device recorder,
one scalar oracle). Profiling the retired flat-pool engine showed a
large share of per-step HBM traffic was path machinery: every
state dragged two (P, 2) path arrays through the dense repack scatter
each step, and every marker hit replayed a masked O-op write loop over
(G, B, P) buffers -- even though paths are only *read* once, on the
host, after the scan.

This engine stores no paths on device. Each pool state carries a single
``pref`` word: a reference into a genealogy log. When a marker hit
spawns a newborn state, the step emits one log record
``(parent_pref, event)`` through ``lax.scan``'s stacked outputs --
a dense (steps, G, B, 2) array -- and the newborn's pref points at that
record. Seed states get negative prefs indexing the host-side seed list.
After the scan the host reconstructs paths only for the states that
survived: chase parent pointers to a seed (chains are as short as the
number of sites the read crossed), then replay the jump-table ops
root->leaf. The exit/enter op semantics replayed here are those of
vBWT_jump.cpp:51-92 and 230-265 (see jump_table.py).

Wins vs the flat engine:
  * scan carry is 4 int32 words/state (was 4 + 2*(P,2) paths + 2 counts);
    the repack concat+scatter moves ~9x less data;
  * the (G, B, O) op-application loop disappears from the device step;
  * no path-capacity bound: deep nesting cannot overflow (the flat
    engine's cfg.path host-fallback class is gone);
  * one build-time table ``marker_rank_locus`` collapses the marker-hit
    chain of three dependent gathers (marker_sa_pos -> sa ->
    pos_to_locus) into one.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map

from .search import PrgIndex, SearchState
from .device_index import DeviceIndex, _next_pow2, _round_up
from ..ops.prefix import prefix_sum


@dataclass
class LogConfig:
    # N: live-state capacity. This is a CAP, not the per-step width --
    # auto_phases right-sizes the warm pool to the row count and shrinks
    # after die-off, so a large cap costs nothing on sparse graphs but
    # stops dense graphs (many kmer seeds per read) from spilling whole
    # reads to the host engine at seeding time.
    pool: int = 262144
    hits: int = 2048     # G: marker hits per step per 4096 rows


def _row_capacity(n_rows: int) -> int:
    """Batch-row padding: pow2 keeps the compiled-shape count low for
    small batches; past 4096 rows, pow2 wastes up to ~2x device work
    (a 5000-read buffer is 10000 oriented rows -> 16384), so pad to a
    2048 multiple instead. Production buffers are a fixed 5000 reads,
    so this still compiles once."""
    if n_rows <= 4096:
        return _next_pow2(n_rows, floor=8)
    return _round_up(n_rows, 2048)


def _build_log_step(di: DeviceIndex, cfg: LogConfig, num_reads: int,
                    occ_rows=None):
    """occ_rows: optional (rows)->(rows..., 4) gather over the occ table.
    The default gathers the replicated di.occ; parallel/sharded_index.py
    injects a psum-of-partial-gathers over an SA-range-sharded occ so
    graphs larger than one device's HBM still run this exact step."""
    B = di.n_outcomes
    N = cfg.pool
    G = cfg.hits
    n = di.size
    if occ_rows is None:
        occ_rows = lambda rows: di.occ[jnp.clip(rows, 0, n)]
    # jump-outcome lo/hi stacked once per phase (hoisted out of the scan
    # body by jit) so newborn intervals come from ONE gather, not two
    L = di.out_lo.shape[0]
    out_cat = jnp.concatenate([di.out_lo, di.out_hi])   # (2L,B)

    def step(carry, xs):
        # the step is a chain of small dependent gathers and scatters,
        # so every gather/scatter pair below is fused into one op
        # wherever the dataflow allows -- lo/hi occ rows in one 2N
        # gather, all five per-hit state fields in one stacked (N,5)
        # gather, the four repack scatters in one (N+1,4) row scatter,
        # both overflow scatters in one.
        base_row, log_base = xs
        (read_id, lo, hi, pref, overflow) = carry
        valid = read_id >= 0
        rid = jnp.clip(read_id, 0, num_reads - 1)
        base = jnp.where(valid, base_row[rid], 0)       # (N,)
        active = valid & (base > 0)

        # ---- 1. occ row gathers: LF + marker counts (one 2N gather) -----
        rows2 = occ_rows(jnp.concatenate([lo, hi + 1]))  # (2N,4)
        row_lo, row_hi = rows2[:N], rows2[N:]
        onehot = (base[:, None] == jnp.arange(1, 5))    # (N,4)
        first = di.sym_start[jnp.clip(base, 0, 4)]
        nlo = first + jnp.sum(row_lo * onehot, axis=1)
        nhi = first + jnp.sum(row_hi * onehot, axis=1) - 1
        ext_alive = active & (nlo <= nhi)
        kept_lo = jnp.where(active, nlo, lo)
        kept_hi = jnp.where(active, nhi, hi)
        keep = ext_alive | (valid & ~active)            # padding steps persist

        # markers in bwt[0:i) = i - #dna(<i) - #sentinel(<i)
        sent = di.sentinel_row
        m_lo = lo - jnp.sum(row_lo, axis=1) - (lo > sent)
        m_hi = (hi + 1) - jnp.sum(row_hi, axis=1) - (hi + 1 > sent)
        cnt = jnp.where(active, m_hi - m_lo, 0)         # (N,)

        # ---- 2. global hit enumeration ----------------------------------
        # exact int32 prefix sums (ops/prefix.py): their values are
        # slot indices, so no float formulation is allowed here
        nz = cnt > 0
        two = prefix_sum(jnp.stack([cnt, nz.astype(jnp.int32)]))   # (2,N)
        cum, nzc = two[0], two[1]
        total = cum[-1]
        g = jnp.arange(G)
        start_of = cum - cnt                             # (N,)
        rank = nzc - nz.astype(jnp.int32)                # run index per state
        # hit -> owning state WITHOUT a binary search and WITHOUT a
        # log-depth prefix-max: run starts come in increasing state
        # order, so owner(g) = nz_states[#run_starts_at_or_before_g - 1].
        # Both scatters share one (2G+1,) buffer (slot 2G = dump).
        sc = jnp.zeros((2 * G + 1,), jnp.int32).at[jnp.concatenate([
            jnp.where(nz & (rank < G), rank, 2 * G),
            jnp.where(nz & (start_of < G), G + start_of, 2 * G)])].set(
            jnp.concatenate([jnp.arange(N, dtype=jnp.int32),
                             jnp.ones((N,), jnp.int32)]), mode="drop")
        nz_states, starts01 = sc[:G], sc[G:2 * G]
        rank_of_g = prefix_sum(starts01)
        s_of_g = nz_states[jnp.clip(rank_of_g - 1, 0, G - 1)]
        s_of_g = jnp.clip(s_of_g, 0, N - 1)
        hit_ok = g < jnp.minimum(total, G)
        # every per-hit state field in ONE (N,5) stacked gather
        state_cols = jnp.stack([start_of, m_lo, base, pref, rid], axis=1)
        hit_cols = state_cols[s_of_g]                    # (G,5)
        hit_pos = hit_cols[:, 1] + (g - hit_cols[:, 0])
        j_base = hit_cols[:, 2]                          # (G,)
        # states whose hits spill past the budget flag their read
        spilled = active & (cum > G) & (cnt > 0)

        # marker rank -> jump locus, one precomputed gather
        loc = jnp.where(hit_ok,
                        di.marker_rank_locus[
                            jnp.clip(hit_pos, 0,
                                     di.marker_rank_locus.shape[0] - 1)],
                        -1)                              # (G,)

        # ---- 3. outcomes + LF of newborns (G,B) -------------------------
        li = jnp.clip(loc, 0, L - 1)
        jbound = out_cat[jnp.concatenate([li, li + L])]  # (2G,B)
        j_lo, j_hi = jbound[:G], jbound[G:]
        cand_ok = (loc >= 0)[:, None] & (j_lo >= 0)
        jrows = occ_rows(jnp.concatenate([j_lo, j_hi + 1]))  # (2G,B,4)
        jrow_lo, jrow_hi = jrows[:G], jrows[G:]
        j_onehot = (j_base[:, None] == jnp.arange(1, 5))  # (G,4)
        j_first = di.sym_start[jnp.clip(j_base, 0, 4)]
        e_lo = j_first[:, None] + jnp.sum(jrow_lo * j_onehot[:, None, :], axis=2)
        e_hi = j_first[:, None] + jnp.sum(jrow_hi * j_onehot[:, None, :], axis=2) - 1
        cand_ok &= e_lo <= e_hi

        # genealogy log records for this step's candidates
        rec_parent = jnp.broadcast_to(hit_cols[:, 3][:, None], (G, B))
        rec_event = li[:, None] * B + jnp.arange(B)[None, :]   # (G,B)
        c_pref = log_base + g[:, None] * B + jnp.arange(B)[None, :]
        c_rid = jnp.broadcast_to(hit_cols[:, 4][:, None], (G, B))

        # ---- 4. dense repack: survivors then newborns -------------------
        flags = jnp.concatenate([keep, cand_ok.reshape(-1)])
        pos = prefix_sum(flags) - 1
        dest = jnp.where(flags & (pos < N), pos, N)      # N = dump slot
        all_rid = jnp.concatenate([rid, c_rid.reshape(-1)])
        dropped = flags & (pos >= N)
        # one overflow scatter for both spill classes
        ovf_idx = jnp.concatenate([jnp.where(spilled, rid, num_reads),
                                   jnp.where(dropped, all_rid, num_reads)])
        overflow = overflow.at[ovf_idx].set(True, mode="drop")

        # all four carry arrays repacked by ONE row scatter
        cat = jnp.stack([
            jnp.concatenate([jnp.where(keep, read_id, -1),
                             jnp.where(cand_ok, c_rid, -1).reshape(-1)]),
            jnp.concatenate([kept_lo, e_lo.reshape(-1)]),
            jnp.concatenate([kept_hi, e_hi.reshape(-1)]),
            jnp.concatenate([pref, c_pref.reshape(-1)]),
        ], axis=1)                                       # (N+GB, 4)
        fills = jnp.array([-1, 0, 0, 0], cat.dtype)
        out = jnp.broadcast_to(fills, (N + 1, 4)).at[dest].set(
            cat, mode="drop")[:N]
        new_read_id, new_lo, new_hi, new_pref = (
            out[:, 0], out[:, 1], out[:, 2], out[:, 3])

        return ((new_read_id, new_lo, new_hi, new_pref, overflow),
                (rec_parent, rec_event))

    return step


def _phase4(entry):
    """Phase entries are (n_steps, pool, hits[, narrow_w[, kind]]):
    3-tuples are classic wide-step phases (narrow_w = 0); a 4th element
    > 0 selects the narrow-interval step with that wide-state budget; a
    5th element "locked" selects the slot-locked narrow step (pool slot
    i <-> read i; pool must equal the per-shard row count)."""
    if len(entry) == 5:
        return entry
    if len(entry) == 4:
        return entry + ("",)
    n_steps, pool, hits = entry
    return n_steps, pool, hits, 0, ""


def _build_narrow_step(di: DeviceIndex, cfg: LogConfig, num_reads: int,
                       wide_budget: int, occ_rows=None, locked: bool = False,
                       narrow_rows=None):
    """Narrow-interval scan step: the tail-phase fast path.

    After ~6 extension steps nearly every live state's SA interval is a
    singleton (hi == lo) -- the suffix is unique in the text -- so the
    classic step's two 4-int occ-row gathers per state are ~13 gathered
    ints spent answering a question one precomputed int32 answers
    (device_index._build_narrow_tab): the symbol at lo plus either the
    LF destination (DNA) or the jump locus (marker). The step gathers
    narrow_tab once per state; the <= wide_budget non-singleton states
    (fresh marker-jump newborns, repeats) take a compacted classic
    sub-path through the same occ_rows gather; wide states past the
    budget flag their read (same-shape retry pass, then exact host
    re-map -- correctness never depends on the budget).

    locked=False (plain narrow): the pool is hole-allocated instead of
    dense-repacked -- survivors stay in their slot and newborns scatter
    into dead slots, so the big (N+G*B, 4) repack scatter of the wide
    step becomes a (G*B, 4) one.

    locked=True (slot-locked): pool slot i IS read i (N == num_reads ==
    per-shard rows; see _lock_pool). In the tail ~every live read holds
    exactly one state, so locking the layout deletes the remaining
    N-sized random accesses: the per-state base is base_row itself (no
    rid gather), overflow flags are vector ORs (no N-wide scatter), and
    a newborn lands in its read's own slot (a (G*B, 4) scatter). A read
    briefly holding two surviving states (parent survives AND a newborn
    arrives, or two newborns survive -- a genuinely multi-mapping read)
    is flagged overflow: the same-shape retry re-flags it and the exact
    host path re-maps it, trading the rare ambiguous read for a ~2x
    cheaper step on the ~unique majority.

    Holes/locking mean the pool is NOT front-packed, so these phases
    must be final (auto_phases emits narrow -> locked tail segments;
    _resize_pool shrinking after one would drop live states)."""
    B = di.n_outcomes
    N = cfg.pool
    G = cfg.hits
    W = wide_budget
    n = di.size
    if occ_rows is None:
        occ_rows = lambda rows: di.occ[jnp.clip(rows, 0, n)]
    if narrow_rows is None:
        narrow_rows = lambda rows: di.narrow_tab[jnp.clip(rows, 0, n - 1)]
    L = di.out_lo.shape[0]
    out_cat = jnp.concatenate([di.out_lo, di.out_hi])   # (2L,B)
    HB = G * B
    if locked:
        assert N == num_reads, (N, num_reads)

    def step(carry, xs):
        base_row, log_base = xs
        (read_id, lo, hi, pref, overflow) = carry
        valid = read_id >= 0
        if locked:
            rid = jnp.arange(N, dtype=read_id.dtype)   # slot i <-> read i
            base = jnp.where(valid, base_row, 0)       # no gather
        else:
            rid = jnp.clip(read_id, 0, num_reads - 1)
            base = jnp.where(valid, base_row[rid], 0)
        active = valid & (base > 0)
        single = lo == hi

        # ---- 1. narrow path: ONE packed int32 gather per state ----------
        t = narrow_rows(lo)
        sym = t >> 24                 # 0 sentinel, 1-4 DNA, 5 marker
        val = t & 0xFFFFFF            # LF destination / jump locus

        # ---- 2. wide sub-path: classic occ rows for <= W wide states ----
        wideflag = active & ~single
        w_ord = prefix_sum(wideflag.astype(jnp.int32))
        w_rank = w_ord - wideflag.astype(jnp.int32)
        w_slot = jnp.full((W + 1,), N, jnp.int32).at[
            jnp.where(wideflag & (w_rank < W), w_rank, W)].set(
            jnp.arange(N, dtype=jnp.int32), mode="drop")
        w_idx = jnp.clip(w_slot[:W], 0, N - 1)
        w_live = w_slot[:W] < N
        w_lo, w_hi, w_base = lo[w_idx], hi[w_idx], base[w_idx]
        rows2 = occ_rows(jnp.concatenate([w_lo, w_hi + 1]))   # (2W,4)
        row_lo, row_hi = rows2[:W], rows2[W:]
        onehot = (w_base[:, None] == jnp.arange(1, 5))
        first = di.sym_start[jnp.clip(w_base, 0, 4)]
        w_nlo = first + jnp.sum(row_lo * onehot, axis=1)
        w_nhi = first + jnp.sum(row_hi * onehot, axis=1) - 1
        sent = di.sentinel_row
        w_mlo = w_lo - jnp.sum(row_lo, axis=1) - (w_lo > sent)
        w_mhi = (w_hi + 1) - jnp.sum(row_hi, axis=1) - (w_hi + 1 > sent)
        wcols = jnp.stack([w_nlo, w_nhi, w_mlo, w_mhi], axis=1)
        wball = jnp.zeros((N + 1, 4), jnp.int32).at[
            jnp.where(w_live, w_idx, N)].set(wcols, mode="drop")[:N]
        covered = single | (wideflag & (w_rank < W))
        spill_w = wideflag & (w_rank >= W)

        # ---- 3. merged extension + marker counts ------------------------
        nlo = jnp.where(single, val, wball[:, 0])
        nhi = jnp.where(single, val, wball[:, 1])
        ok = jnp.where(single, sym == base, wball[:, 0] <= wball[:, 1])
        ext_alive = active & covered & ok
        kept_lo = jnp.where(active & covered, nlo, lo)
        kept_hi = jnp.where(active & covered, nhi, hi)
        keep = ext_alive | (valid & ~active)    # padding steps persist
        cnt = jnp.where(active & covered,
                        jnp.where(single, (sym == 5).astype(jnp.int32),
                                  wball[:, 3] - wball[:, 2]), 0)

        # ---- 4. global hit enumeration (as the wide step) ---------------
        nz = cnt > 0
        two = prefix_sum(jnp.stack([cnt, nz.astype(jnp.int32)]))
        cum, nzc = two[0], two[1]
        total = cum[-1]
        g = jnp.arange(G)
        start_of = cum - cnt
        rank = nzc - nz.astype(jnp.int32)
        sc = jnp.zeros((2 * G + 1,), jnp.int32).at[jnp.concatenate([
            jnp.where(nz & (rank < G), rank, 2 * G),
            jnp.where(nz & (start_of < G), G + start_of, 2 * G)])].set(
            jnp.concatenate([jnp.arange(N, dtype=jnp.int32),
                             jnp.ones((N,), jnp.int32)]), mode="drop")
        nz_states, starts01 = sc[:G], sc[G:2 * G]
        rank_of_g = prefix_sum(starts01)
        s_of_g = jnp.clip(nz_states[jnp.clip(rank_of_g - 1, 0, G - 1)],
                          0, N - 1)
        hit_ok = g < jnp.minimum(total, G)
        # hitfield: marker rank (wide) or the jump locus itself (narrow)
        hitfield = jnp.where(single, val, wball[:, 2])
        state_cols = jnp.stack([start_of, hitfield, base, pref, rid,
                                single.astype(jnp.int32)], axis=1)
        hit_cols = state_cols[s_of_g]                    # (G,6)
        hit_pos = hit_cols[:, 1] + (g - hit_cols[:, 0])
        direct = hit_cols[:, 5] == 1
        j_base = hit_cols[:, 2]
        spilled = active & (cum > G) & (cnt > 0)
        loc = jnp.where(hit_ok,
                        jnp.where(direct, hit_cols[:, 1],
                                  di.marker_rank_locus[jnp.clip(
                                      hit_pos, 0,
                                      di.marker_rank_locus.shape[0] - 1)]),
                        -1)                              # (G,)

        # ---- 5. outcomes + LF of newborns (G,B): as the wide step -------
        li = jnp.clip(loc, 0, L - 1)
        jbound = out_cat[jnp.concatenate([li, li + L])]  # (2G,B)
        j_lo, j_hi = jbound[:G], jbound[G:]
        cand_ok = (loc >= 0)[:, None] & (j_lo >= 0)
        jrows = occ_rows(jnp.concatenate([j_lo, j_hi + 1]))  # (2G,B,4)
        jrow_lo, jrow_hi = jrows[:G], jrows[G:]
        j_onehot = (j_base[:, None] == jnp.arange(1, 5))  # (G,4)
        j_first = di.sym_start[jnp.clip(j_base, 0, 4)]
        e_lo = j_first[:, None] + jnp.sum(jrow_lo * j_onehot[:, None, :],
                                          axis=2)
        e_hi = j_first[:, None] + jnp.sum(jrow_hi * j_onehot[:, None, :],
                                          axis=2) - 1
        cand_ok &= e_lo <= e_hi
        rec_parent = jnp.broadcast_to(hit_cols[:, 3][:, None], (G, B))
        rec_event = li[:, None] * B + jnp.arange(B)[None, :]
        c_pref = log_base + g[:, None] * B + jnp.arange(B)[None, :]
        c_rid = jnp.broadcast_to(hit_cols[:, 4][:, None], (G, B))

        cand = cand_ok.reshape(-1)                       # (HB,)
        all_rid_c = c_rid.reshape(-1)
        if locked:
            # ---- 6L. slot-locked placement: newborn -> its read's slot --
            # per-read newborn count ((HB,) scatter-add, no cumsum)
            nb_cnt = jnp.zeros((N + 1,), jnp.int32).at[
                jnp.where(cand, all_rid_c, N)].add(1, mode="drop")[:N]
            # a read may hold ONE state: parent xor sole newborn
            conflict = (nb_cnt > 1) | ((nb_cnt == 1) & keep)
            place = cand & (nb_cnt[jnp.clip(all_rid_c, 0, N - 1)] == 1) \
                & ~keep[jnp.clip(all_rid_c, 0, N - 1)]
            dest = jnp.where(place, all_rid_c, N)
            # overflow: ALL flag classes are (N,) slot-aligned vectors
            overflow = overflow | spilled | spill_w | conflict
            up = jnp.stack([jnp.where(keep, read_id, -1),
                            kept_lo, kept_hi, pref], axis=1)  # (N,4)
            ncols = jnp.stack([all_rid_c, e_lo.reshape(-1),
                               e_hi.reshape(-1), c_pref.reshape(-1)], axis=1)
            out = jnp.concatenate(
                [up, jnp.full((1, 4), -1, up.dtype)], axis=0).at[dest].set(
                ncols, mode="drop")[:N]
            # conflicted reads are host-bound: clear the slot so their
            # half-complete state never reaches the result merge
            rid_out = jnp.where(conflict, -1, out[:, 0])
            return ((rid_out, out[:, 1], out[:, 2], out[:, 3], overflow),
                    (rec_parent, rec_event))

        # ---- 6. hole allocation: newborns scatter into dead slots -------
        hole = ~keep
        M = max(N, HB)
        two2 = prefix_sum(jnp.stack([
            jnp.pad(hole.astype(jnp.int32), (0, M - N)),
            jnp.pad(cand.astype(jnp.int32), (0, M - HB))]))
        h_ord, c_ord = two2[0][:N], two2[1][:HB]
        h_rank = h_ord - hole.astype(jnp.int32)
        c_rank = c_ord - cand.astype(jnp.int32)
        n_holes = h_ord[-1]
        slot_of_rank = jnp.full((HB + 1,), N, jnp.int32).at[
            jnp.where(hole & (h_rank < HB), h_rank, HB)].set(
            jnp.arange(N, dtype=jnp.int32), mode="drop")[:HB]
        placed_ok = cand & (c_rank < jnp.minimum(n_holes, HB))
        dest = jnp.where(placed_ok,
                         slot_of_rank[jnp.clip(c_rank, 0, HB - 1)], N)
        dropped = cand & ~placed_ok
        ovf_idx = jnp.concatenate([
            jnp.where(spilled | spill_w, rid, num_reads),
            jnp.where(dropped, all_rid_c, num_reads)])
        overflow = overflow.at[ovf_idx].set(True, mode="drop")

        up = jnp.stack([jnp.where(keep, read_id, -1),
                        kept_lo, kept_hi, pref], axis=1)  # (N,4)
        ncols = jnp.stack([all_rid_c, e_lo.reshape(-1),
                           e_hi.reshape(-1), c_pref.reshape(-1)], axis=1)
        out = jnp.concatenate(
            [up, jnp.full((1, 4), -1, up.dtype)], axis=0).at[dest].set(
            ncols, mode="drop")[:N]
        return ((out[:, 0], out[:, 1], out[:, 2], out[:, 3], overflow),
                (rec_parent, rec_event))

    return step


def _lock_pool(carry, pool: int, num_reads: int):
    """Transition into a slot-locked phase: scatter each read's SOLE
    live state into slot rid; reads holding >1 state (multi-mapping at
    this depth -- rare past ~16 extended bases) are flagged overflow for
    the exact host path. pool == num_reads == per-shard rows."""
    read_id, lo, hi, pref, overflow = carry
    R = pool
    valid = read_id >= 0
    ridc = jnp.clip(read_id, 0, R - 1)
    cnt = jnp.zeros((R + 1,), jnp.int32).at[
        jnp.where(valid, ridc, R)].add(1, mode="drop")[:R]
    overflow = overflow | (cnt > 1)
    place = valid & (cnt[ridc] == 1)
    dest = jnp.where(place, ridc, R)
    cat = jnp.stack([ridc, lo, hi, pref], axis=1)
    out = jnp.full((R + 1, 4), -1, cat.dtype).at[dest].set(
        cat, mode="drop")[:R]
    # unplaced slots: read_id -1, numeric fields zeroed
    placed = out[:, 0] >= 0
    z = lambda a: jnp.where(placed, a, 0)
    return (out[:, 0], z(out[:, 1]), z(out[:, 2]), z(out[:, 3]), overflow)


def _resize_pool(carry, pool: int, num_reads: int):
    """Live states are dense-packed at the pool front (the repack
    guarantees it), so shrinking = slicing; states sliced off flag their
    read for exact host re-mapping."""
    read_id, lo, hi, pref, overflow = carry
    N = read_id.shape[0]
    if N == pool:
        return carry
    if N > pool:
        tail = read_id[pool:]
        dropped = tail >= 0
        overflow = overflow.at[jnp.where(dropped, tail, num_reads)].set(
            True, mode="drop")
        return (read_id[:pool], lo[:pool], hi[:pool], pref[:pool], overflow)
    pad = pool - N
    z = lambda a: jnp.concatenate([a, jnp.zeros((pad,), a.dtype)])
    return (jnp.concatenate([read_id, jnp.full((pad,), -1, read_id.dtype)]),
            z(lo), z(hi), z(pref), overflow)


def _log_search_phases(di: DeviceIndex, reads_T, carry, phases, num_reads,
                       occ_rows=None, collect_live=False, narrow_rows=None):
    """phases: tuple of (n_steps, pool, hits) segments covering the scan.

    The live-state count and marker-hit volume both peak right after
    seeding (multiple kmer seed states per read) and decay to ~1 state
    per read within ~10 steps on SNP-dense graphs; later segments run
    with smaller pools/hit budgets, which the per-step gather volume is
    proportional to.

    collect_live=True additionally returns per-phase live-state counts
    (pool occupancy, for bench.py's roofline accounting)."""
    # reads ship as uint8 (4x less host->device traffic than int32 --
    # the read matrix is the largest per-buffer transfer); widen on
    # device where the comparisons need int
    reads_T = reads_T.astype(jnp.int32)
    logs_p, logs_e = [], []
    live = []
    log_base = 0
    offset = 0
    for entry in phases:
        n_steps, pool, hits, narrow_w, kind = _phase4(entry)
        cfg = LogConfig(pool=pool, hits=hits)
        narrow_ok = narrow_w > 0 and (
            narrow_rows is not None or di.narrow_tab.shape[0] == di.size)
        if kind == "locked" and narrow_ok:
            carry = _lock_pool(carry, pool, num_reads)
            step = _build_narrow_step(di, cfg, num_reads, narrow_w,
                                      occ_rows=occ_rows, locked=True,
                                      narrow_rows=narrow_rows)
        elif narrow_ok:
            carry = _resize_pool(carry, pool, num_reads)
            step = _build_narrow_step(di, cfg, num_reads, narrow_w,
                                      occ_rows=occ_rows,
                                      narrow_rows=narrow_rows)
        else:
            carry = _resize_pool(carry, pool, num_reads)
            step = _build_log_step(di, cfg, num_reads, occ_rows=occ_rows)
        lb = log_base + jnp.arange(n_steps, dtype=jnp.int32) * (
            hits * di.n_outcomes)
        xs = (jax.lax.slice_in_dim(reads_T, offset, offset + n_steps), lb)
        # unrolling the scan body lets XLA schedule/fuse ACROSS steps
        # at the price of compile time (off by default)
        import os as _os
        unroll = int(_os.environ.get("GRAMTOOLS_TPU_UNROLL", "1"))
        carry, (lp, le) = jax.lax.scan(step, carry, xs,
                                       unroll=min(unroll, n_steps))
        logs_p.append(lp.reshape(-1))
        logs_e.append(le.reshape(-1))
        if collect_live:
            live.append(jnp.sum(carry[0] >= 0))
        log_base += n_steps * hits * di.n_outcomes
        offset += n_steps
    logs = (jnp.concatenate(logs_p), jnp.concatenate(logs_e))
    if collect_live:
        return carry, logs, jnp.stack(live)
    return carry, logs


def _occ_rows_for(di: DeviceIndex, blocks, rank: str):
    """Rank-implementation selector for the occ gather: None = the dense
    (n+1, 4) int32 prefix-table gather; "packed" = the bit-packed block
    rank (ops/rank.py: record gather + XOR/mask/popcount)."""
    if rank == "dense" or blocks is None:
        return None
    from ..ops.rank import make_packed_occ_rows

    return make_packed_occ_rows(blocks, di.size)


@partial(jax.jit, static_argnames=("phases", "num_reads", "rank"))
def _log_search_impl(di: DeviceIndex, reads_T, carry, phases, num_reads,
                     blocks=None, rank="dense"):
    return _log_search_phases(di, reads_T, carry, phases, num_reads,
                              occ_rows=_occ_rows_for(di, blocks, rank))


@partial(jax.jit, static_argnames=("phases", "num_reads", "rank"))
def _log_search_probe(di: DeviceIndex, reads_T, carry, phases, num_reads,
                      blocks=None, rank="dense"):
    """Scan variant returning per-phase live-state counts alongside the
    final carry -- bench.py's pool-occupancy probe."""
    return _log_search_phases(di, reads_T, carry, phases, num_reads,
                              occ_rows=_occ_rows_for(di, blocks, rank),
                              collect_live=True)


def _packed_body(di: DeviceIndex, reads_T, carry, phases, num_reads,
                 blocks=None, rank="dense"):
    """Scan + pack final carry and genealogy log into ONE flat int32
    array (shared by the single-chip jit and the shard_map builder)."""
    carry, (lp, le) = _log_search_phases(
        di, reads_T, carry, phases, num_reads,
        occ_rows=_occ_rows_for(di, blocks, rank))
    rid, lo, hi, pref, ovf = carry
    return jnp.concatenate([rid, lo, hi, pref, ovf.astype(jnp.int32),
                            lp.reshape(-1), le.reshape(-1)])


@partial(jax.jit, static_argnames=("phases", "num_reads", "rank"))
def _log_search_packed(di: DeviceIndex, reads_T, carry, phases, num_reads,
                       blocks=None, rank="dense"):
    """Like _log_search_impl but returns ONE flat int32 array: the
    engine packs the final carry + genealogy log on device and unpacks
    on host, so a buffer's result comes back in one transfer instead of
    one per leaf."""
    return _packed_body(di, reads_T, carry, phases, num_reads,
                        blocks=blocks, rank=rank)


def _pack_reads2(reads_T: np.ndarray) -> np.ndarray:
    """(steps, SR) uint8 base codes 0..4 -> (steps/4, SR) uint8 packed
    2-bit codes (code = base-1 mod 4; zero-pads become 3 and are masked
    on device by row_len -- see _unpack_reads2). Quarters the read
    matrix's host->device bytes."""
    steps = reads_T.shape[0]
    assert steps % 4 == 0, steps
    pr = (reads_T - np.uint8(1)) & np.uint8(3)
    return (pr[0::4] | (pr[1::4] << 2) | (pr[2::4] << 4)
            | (pr[3::4] << 6)).astype(np.uint8)


def _unpack_reads2(reads_p, row_len, steps: int, kmer_size: int):
    """2-bit packed read matrix -> (steps, SR) int32 base codes.

    reads_p: (ceil(steps/4), SR) uint8, 4 bases/byte along the step
    axis (code = base-1). Bases past a row's body (row_len - k) are 0
    (= inactive), reproducing the legacy zero-padded reads_T. Packing
    quarters the largest remaining per-buffer host->device transfer."""
    b = reads_p.astype(jnp.int32)
    parts = [(b >> (2 * j)) & 3 for j in range(4)]
    codes = jnp.stack(parts, axis=1).reshape(4 * reads_p.shape[0],
                                             reads_p.shape[1])[:steps]
    n_steps_row = jnp.clip(row_len - kmer_size, 0, steps)
    return jnp.where(jnp.arange(steps)[:, None] < n_steps_row[None, :],
                     codes + 1, 0)


def _record_body(di: DeviceIndex, rt, st, reads_p, slot_sidx, slot_row,
                 row_ok, row_first_raw, row_len, cov_diff,
                 phases, num_reads, trip_cap, kmer_size,
                 blocks=None, rank="dense"):
    """Fused scan + device-side selection/recording (record_jax.py),
    shared by the single-chip jit and the shard_map builder.

    Nothing bulky crosses the host<->device link in either direction:
    reads arrive 2-bit packed, the initial carry is built on device from
    the placed seed-state indices (payloads gathered from the resident
    record_jax.SeedTables), the genealogy log is replayed on device,
    per-base coverage accumulates in the donated diff array, and the
    packed result is just per-row flags + compact selected-loci
    triples."""
    from .record_jax import replay_device, select_and_record_device

    steps = sum(e[0] for e in phases)
    reads_T = _unpack_reads2(reads_p, row_len, steps, kmer_size)

    # initial carry from the placed (slot -> seed state, row) maps
    sidx_ok = slot_sidx >= 0
    sidc = jnp.clip(slot_sidx, 0, st.n_states - 1)
    carry = (jnp.where(sidx_ok, slot_row, -1).astype(jnp.int32),
             jnp.where(sidx_ok, st.k_lo[sidc], 0).astype(jnp.int32),
             jnp.where(sidx_ok, st.k_hi[sidc], 0).astype(jnp.int32),
             jnp.where(sidx_ok, -(slot_sidx + 1), 0).astype(jnp.int32),
             jnp.zeros((num_reads,), bool))

    carry, (lp, le) = _log_search_phases(
        di, reads_T, carry, phases, num_reads,
        occ_rows=_occ_rows_for(di, blocks, rank))
    rid, lo, hi, pref, ovf = carry
    alive = rid >= 0
    # observability knobs (profiling only; see select_and_record_device
    # docstring -- production never sets them)
    import os as _os
    r_stage = int(_os.environ.get("GRAMTOOLS_TPU_REPLAY_STAGE", "99"))
    s_stage = int(_os.environ.get("GRAMTOOLS_TPU_RECORD_STAGE", "99"))
    trav, n_trav, ing, n_ing, bad = replay_device(
        di, pref, lp, le, st, alive, stage=r_stage)
    row_ok2 = row_ok & ~ovf
    fallback, mapped, t_row, t_site, t_allele, cov_diff = \
        select_and_record_device(
            di, rt, rid, lo, hi, trav, n_trav, ing, n_ing, bad,
            row_ok2, row_first_raw, row_len, cov_diff, trip_cap=trip_cap,
            stage=s_stage)
    packed = jnp.concatenate([
        ovf.astype(jnp.int32), fallback.astype(jnp.int32),
        mapped.astype(jnp.int32), t_row, t_site, t_allele])
    return packed, cov_diff


@partial(jax.jit, static_argnames=("phases", "num_reads", "trip_cap",
                                   "kmer_size", "rank"),
         donate_argnums=(9,))
def _log_search_record(di: DeviceIndex, rt, st, reads_p, slot_sidx, slot_row,
                       row_ok, row_first_raw, row_len, cov_diff,
                       phases, num_reads, trip_cap, kmer_size,
                       blocks=None, rank="dense"):
    return _record_body(di, rt, st, reads_p, slot_sidx, slot_row,
                        row_ok, row_first_raw, row_len, cov_diff,
                        phases, num_reads, trip_cap, kmer_size,
                        blocks=blocks, rank=rank)


def _unpack_record_result(flat: np.ndarray, num_reads: int, trip_cap: int,
                          n_shards: int = 1):
    """Host-side split of the fused record output into GLOBAL row space.

    For n_shards > 1 the flat array is the shard-order concatenation of
    per-shard blocks [ovf | fallback | mapped | t_row | t_site |
    t_allele]; flag bits land at their global rows (local * S + shard)
    and the triples' local rows globalise likewise. Returns (overflow,
    fallback, mapped, loci_rows) with loci_rows the neighbour-deduped
    (row, site, allele) triples (a row lives in exactly one shard, so
    per-shard dedup is global dedup)."""
    S = n_shards
    R = num_reads
    block = 3 * R + 3 * trip_cap
    assert flat.size == S * block, (flat.size, S, block)
    ovf = np.zeros(S * R, dtype=bool)
    fallback = np.zeros(S * R, dtype=np.int32)   # reason bitmask, 0 = ok
    mapped = np.zeros(S * R, dtype=bool)
    loci_parts = []
    for s in range(S):
        seg = flat[s * block:(s + 1) * block]
        rows_g = (np.arange(R) * S + s) if S > 1 else np.arange(R)
        ovf[rows_g] = seg[:R].astype(bool)
        fallback[rows_g] = seg[R:2 * R]
        mapped[rows_g] = seg[2 * R:3 * R].astype(bool)
        t = seg[3 * R:]
        t_row = t[:trip_cap]
        t_site = t[trip_cap:2 * trip_cap]
        t_allele = t[2 * trip_cap:3 * trip_cap]
        valid = t_row < R
        uniq = np.ones(trip_cap, dtype=bool)
        if trip_cap > 1:
            uniq[1:] = ((t_row[1:] != t_row[:-1])
                        | (t_site[1:] != t_site[:-1])
                        | (t_allele[1:] != t_allele[:-1]))
        keep = valid & uniq
        g_row = t_row[keep] * S + s if S > 1 else t_row[keep]
        loci_parts.append(np.stack(
            [g_row, t_site[keep], t_allele[keep]], axis=1).astype(np.int64))
    loci_rows = (np.concatenate(loci_parts) if len(loci_parts) > 1
                 else loci_parts[0])
    return ovf, fallback, mapped, loci_rows


def _unpack_result(flat: np.ndarray, phases, num_reads: int,
                   n_outcomes: int, n_shards: int = 1):
    """Host-side split of the scan+pack output into GLOBAL row space.

    For n_shards > 1 the flat array is the shard-order concatenation of
    per-shard blocks [rid | lo | hi | pref | ovf | lp | le]; local read
    ids map to global rows (local * S + shard), per-shard log references
    (non-negative prefs and log parents) shift by the shard's log
    offset, and the overflow flags land at their global rows. Returns
    (carry_np, log_parent, log_event) with carry arrays concatenated
    over shards."""
    S = n_shards
    N = phases[-1][1]
    L = sum(e[0] * e[2] for e in phases) * n_outcomes
    block = 4 * N + num_reads + 2 * L
    assert flat.size == S * block, (flat.size, S, block)
    rid = np.empty(S * N, flat.dtype)
    lo = np.empty(S * N, flat.dtype)
    hi = np.empty(S * N, flat.dtype)
    pref = np.empty(S * N, flat.dtype)
    ovf = np.zeros(S * num_reads, dtype=bool)
    lp = np.empty(S * L, flat.dtype)
    le = np.empty(S * L, flat.dtype)
    for s in range(S):
        seg = flat[s * block:(s + 1) * block]
        r = seg[:N]
        p = seg[3 * N:4 * N]
        if S > 1:
            r = np.where(r >= 0, r * S + s, r)
            p = np.where((seg[:N] >= 0) & (p >= 0), p + s * L, p)
        rid[s * N:(s + 1) * N] = r
        lo[s * N:(s + 1) * N] = seg[N:2 * N]
        hi[s * N:(s + 1) * N] = seg[2 * N:3 * N]
        pref[s * N:(s + 1) * N] = p
        ovf_local = seg[4 * N:4 * N + num_reads].astype(bool)
        if S > 1:
            rows = np.arange(num_reads) * S + s
            ovf[rows] = ovf_local
        else:
            ovf = ovf_local
        lseg = seg[4 * N + num_reads:]
        lps = lseg[:L]
        if S > 1:
            lps = np.where(lps >= 0, lps + s * L, lps)
        lp[s * L:(s + 1) * L] = lps
        le[s * L:(s + 1) * L] = lseg[L:]
    return (rid, lo, hi, pref, ovf), lp, le


def auto_phases(steps: int, num_reads: int, cfg: LogConfig,
                n_seed_states: int = 0, narrow: Optional[bool] = None):
    """Segment plan sized from MEASURED state/hit decay (4.4Mb/100k-site
    graph, 150bp reads, k=10, scaled to rows): live states collapse
    124k -> 60k -> 37k -> 28k over steps 0..4 and stay flat at ~0.67
    states/row; marker hits burst to ~15.8k@40960 rows in step 0 and
    settle under ~1.6k from step 3 on. The per-step device cost is
    dominated by terms LINEAR in (pool + hit budget) -- the LF occ
    gather, the newborn jump/occ gathers and the repack scatter
    (tools/step_ablate.py) -- so the plan shrinks both as fast as the
    measured decay allows: 2 warm steps at the full budgets, 4 mid
    steps at (1.5R, G/4), then the tail at (1.25R, G/8). States sliced
    off by a shrink flag their read for exact host re-mapping and
    budget overflow triggers a same-shape retry pass, so an
    under-provisioned plan costs fallback/retry work, never
    correctness.

    The warm pool is max(pow2(4 x rows), pow2(2 x seed states)): the 4R
    floor covers the measured ~3.1 kmer-seed fan-out of production k=10
    graphs and, at throughput buffer sizes, meets the cfg.pool cap -- so
    the production shape is DATA-INDEPENDENT (every distinct dispatched
    shape is one more XLA compile of the fused program); the
    seed-state term is a grow-only ratchet that matters only for
    high-fan-out graphs (small k), where an extra compile beats
    mass-spilling rows to the host engine."""
    import os
    if narrow is None:
        narrow = os.environ.get("GRAMTOOLS_TPU_NARROW", "1") == "1"
    WARM, MID = 2, 4
    # slot-locked tail starts once states are ~unique: after LOCK_AFTER
    # steps the matched suffix is k + LOCK_AFTER bases long, so the
    # multi-state (flagged -> host) read fraction is ~n/4^(k+LOCK_AFTER)
    lock_after = int(os.environ.get("GRAMTOOLS_TPU_LOCK_AFTER", "14"))
    pool_warm = min(cfg.pool, max(_next_pow2(4 * num_reads, floor=64),
                                  _next_pow2(2 * n_seed_states, floor=64)
                                  if n_seed_states else 64))
    pool_mid = min(pool_warm, max(_round_up(3 * num_reads // 2, 64), 64))
    hits_mid = min(cfg.hits, max(cfg.hits // 4, 8))
    pool_tail = min(pool_mid, max(_round_up(5 * num_reads // 4, 64), 64))
    # tail hit budget: the newborn block's gathers are Theta(hits*B)
    # per step, so the divisor trades device time against overflow
    # retries (measured tail hits ~1k/step at 41k rows)
    tail_div = int(os.environ.get("GRAMTOOLS_TPU_TAIL_HITS_DIV", "8"))
    hits_tail = min(hits_mid, max(cfg.hits // tail_div, 8))
    # narrow-step wide budget: sized to the per-step newborn volume (the
    # only states that re-widen mid-tail); repeats/dense graphs past the
    # budget flag -> same-shape retry -> exact host re-map
    wide_w = min(pool_tail, max(hits_tail, 64)) if narrow else 0
    narrow_len = max(lock_after - WARM - MID, 0) if narrow else None
    plan = []
    remaining = steps
    segments = [(WARM, pool_warm, cfg.hits, 0, ""),
                (MID, pool_mid, hits_mid, 0, "")]
    if narrow and num_reads <= pool_tail:
        segments += [(narrow_len, pool_tail, hits_tail, wide_w, ""),
                     (None, num_reads, hits_tail,
                      min(num_reads, wide_w), "locked")]
    else:
        segments += [(None, pool_tail, hits_tail, wide_w or 0, "")]
    for length, pool, hits, nw, kind in segments:
        n = remaining if length is None else min(length, remaining)
        if n <= 0:
            continue
        if kind == "locked":
            entry = (n, pool, hits, nw, kind)
        elif nw:
            entry = (n, pool, hits, nw)
        else:
            entry = (n, pool, hits)
        if plan and plan[-1][1:] == entry[1:]:
            plan[-1] = (plan[-1][0] + n,) + entry[1:]
        else:
            plan.append(entry)
        remaining -= n
    return tuple(plan)


def make_log_search(di: DeviceIndex, cfg: LogConfig, num_reads: int,
                    phases=None, blocks=None, rank="dense"):
    def run(reads_T, carry):
        p = phases
        if p is None:
            p = auto_phases(reads_T.shape[0], num_reads, cfg)
        return _log_search_impl(di, reads_T, carry, tuple(p), num_reads,
                                blocks=blocks, rank=rank)
    return run


def empty_log_carry(num_reads: int, cfg: LogConfig):
    N = cfg.pool
    z = np.zeros
    return (
        np.full((N,), -1, np.int32), z((N,), np.int32), z((N,), np.int32),
        z((N,), np.int32),
        z((num_reads,), bool),
    )


def _filter_buffer_rows(buffer, kmer_index, k, stats):
    """Kmer-presence screen over both orientations of a read buffer.

    Returns (results_skeleton, rows, rows_mat): rows is the list of
    mappable (buffer_index, oriented_read) pairs; rows_mat is the
    stacked row matrix when the equal-length fast path applied (else
    None). Shared by LogBatchedEngine.scan_submit and the mesh engine
    (parallel/mesh.py)."""
    from ..common.seq import _COMPLEMENT_LUT, revcomp
    from .quasimap import ReadBatch, all_read_kmers_in_index

    results = [[] for _ in range(len(buffer))]
    if isinstance(buffer, ReadBatch):
        # matrix-backed buffer: no per-read Python objects anywhere
        nz = np.flatnonzero(~buffer.invalid)
        L0 = buffer.mat.shape[1]
        sizes = np.where(buffer.invalid, 0, L0).astype(np.int64)
    else:
        sizes = np.array([r.size for r in buffer], dtype=np.int64)
        nz = np.flatnonzero(sizes > 0)
    stats.all_reads_count += 2 * len(buffer)
    stats.skipped_reads_count += 2 * int(len(buffer) - nz.size)
    if nz.size == 0:
        return results, [], None
    matrix_filter = getattr(kmer_index, "batch_all_indexed_matrix", None)
    equal_len = (sizes[nz] == sizes[nz[0]]).all()
    rows_mat = None
    if equal_len and matrix_filter is not None and sizes[nz[0]] >= k:
        # equal-length fast path: one (2n, L) matrix, vectorised
        # revcomp + filter, row views into the matrix afterwards
        fwd = (buffer.mat[nz] if isinstance(buffer, ReadBatch)
               else np.stack([buffer[i] for i in nz]))
        native = None
        bitmap_fn = getattr(kmer_index, "_presence_bitmap", None)
        present = bitmap_fn() if bitmap_fn is not None else None
        if present is not None:
            from ..index.native import native_kmer_screen
            native = native_kmer_screen(fwd, k, present)
        if native is not None:
            # fused revcomp + rolling-code screen with early exit
            # (native/screen.cpp): ~8x the NumPy Horner slide on
            # throughput buffers; host submit time is on the e2e
            # critical path
            mat, passed = native
        else:
            mat = np.empty((2 * nz.size, fwd.shape[1]), dtype=np.uint8)
            mat[0::2] = fwd
            mat[1::2] = _COMPLEMENT_LUT[fwd[:, ::-1]]
            passed = matrix_filter(mat)
        owners = np.repeat(nz, 2)
        stats.missing_kmer_reads_count += int(np.count_nonzero(~passed))
        hit = np.flatnonzero(passed)
        rows = [(int(owners[j]), mat[j]) for j in hit]
        rows_mat = mat[hit]
    else:
        oriented_all = []
        owners = []
        for i in nz:
            read = buffer[i]
            oriented_all.append(read)
            oriented_all.append(revcomp(read))
            owners.extend((i, i))
        batch_filter = getattr(kmer_index, "batch_all_indexed", None)
        if batch_filter is not None:
            passed = batch_filter(oriented_all)
        else:
            passed = np.array([all_read_kmers_in_index(k, r, kmer_index)
                               for r in oriented_all])
        rows = []
        for j, (i, oriented) in enumerate(zip(owners, oriented_all)):
            if passed[j]:
                rows.append((int(i), oriented))
            else:
                stats.missing_kmer_reads_count += 1
    return results, rows, rows_mat


class PathReplayer:
    """Reconstructs (traversed, traversing) for final states from the
    genealogy log + the seed paths, replaying jump-table ops root->leaf
    (the host twin of the flat engine's device op loop)."""

    def __init__(self, jt, B: int):
        from .jump_table import OP_ENTER, OP_EXIT

        self._OP_EXIT, self._OP_ENTER = OP_EXIT, OP_ENTER
        self.kind = np.asarray(jt.ops_kind)
        self.site = np.asarray(jt.ops_site)
        self.allele = np.asarray(jt.ops_allele)
        self.B = B
        self._cache: dict = {}

    def replay(self, pref: int, log_parent: np.ndarray, log_event: np.ndarray,
               seed_paths) -> "tuple[tuple, tuple]":
        events: List[int] = []
        while pref >= 0:
            events.append(int(log_event[pref]))
            pref = int(log_parent[pref])
        trav, ing = seed_paths(-pref - 1)
        trav, ing = list(trav), list(ing)
        for event in reversed(events):
            ops = self._cache.get(event)
            if ops is None:
                li, b = divmod(event, self.B)
                ops = [(int(k), int(s), int(a)) for k, s, a in zip(
                    self.kind[li, b], self.site[li, b], self.allele[li, b])
                    if k != 0]
                self._cache[event] = ops
            for kind, site, allele in ops:
                if kind == self._OP_EXIT:
                    if ing:
                        ing.pop()
                    trav.append((site, allele))
                else:  # OP_ENTER
                    from ..prg.markers import ALLELE_UNKNOWN
                    ing.append((site, ALLELE_UNKNOWN))
        return tuple(trav), tuple(ing)


def replay_paths_vectorised(f_read_id, f_pref, log_parent, log_event,
                            s_trav, s_nt, s_ing, s_ni, jt, B):
    """Batch path reconstruction: chase all genealogy chains at once
    (one gather per depth level), then apply the jump-table ops of each
    chain root->leaf with masked writes. Returns per live state:
    (pool_index, trav (n,T,2), n_trav, ing (n,I,2), n_ing)."""
    from ..prg.markers import ALLELE_UNKNOWN
    from .jump_table import OP_ENTER, OP_EXIT

    sel = np.flatnonzero(f_read_id >= 0)
    n = sel.size
    kind2 = np.asarray(jt.ops_kind).reshape(-1, jt.max_ops)
    site2 = np.asarray(jt.ops_site).reshape(-1, jt.max_ops)
    allele2 = np.asarray(jt.ops_allele).reshape(-1, jt.max_ops)
    O = jt.max_ops
    if n == 0:
        return (sel, np.zeros((0, 1, 2), np.int64), np.zeros(0, np.int64),
                np.zeros((0, 1, 2), np.int64), np.zeros(0, np.int64))

    p = f_pref[sel].astype(np.int64)
    events = []
    guard = 0
    while (p >= 0).any():
        pc = np.clip(p, 0, max(log_event.size - 1, 0))
        events.append(np.where(p >= 0, log_event[pc], -1))
        p = np.where(p >= 0, log_parent[pc], p)
        guard += 1
        if guard > 1_000_000:
            raise RuntimeError("genealogy log cycle")
    seed_idx = (-p - 1).astype(np.int64)
    D = len(events)

    P0 = s_trav.shape[1] if s_trav.ndim == 3 else 0
    I0 = s_ing.shape[1] if s_ing.ndim == 3 else 0
    Tcap = max(P0 + D * O, 1)
    Icap = max(I0 + D * O, 1)
    trav = np.zeros((n, Tcap, 2), dtype=np.int64)
    ing = np.zeros((n, Icap, 2), dtype=np.int64)
    if P0:
        trav[:, :P0] = s_trav[seed_idx]
    if I0:
        ing[:, :I0] = s_ing[seed_idx]
    n_trav = s_nt[seed_idx].astype(np.int64)
    n_ing = s_ni[seed_idx].astype(np.int64)
    ar = np.arange(n)
    for d in range(D - 1, -1, -1):
        ev = events[d]
        valid = ev >= 0
        evc = np.clip(ev, 0, kind2.shape[0] - 1)
        for o in range(O):
            kind = np.where(valid, kind2[evc, o], 0)
            ex = kind == OP_EXIT
            if ex.any():
                n_ing = np.where(ex & (n_ing > 0), n_ing - 1, n_ing)
                rows = ar[ex]
                trav[rows, n_trav[rows], 0] = site2[evc, o][ex]
                trav[rows, n_trav[rows], 1] = allele2[evc, o][ex]
                n_trav = np.where(ex, n_trav + 1, n_trav)
            en = kind == OP_ENTER
            if en.any():
                rows = ar[en]
                ing[rows, n_ing[rows], 0] = site2[evc, o][en]
                ing[rows, n_ing[rows], 1] = ALLELE_UNKNOWN
                n_ing = np.where(en, n_ing + 1, n_ing)
    return sel, trav, n_trav, ing, n_ing


class LogBatchedEngine:
    """THE production mapping engine for quasimap_reads: search_buffer
    (packed scan + host replay, the oracle-comparison contract) plus the
    fused record pipeline (scan_submit/record_complete with device-side
    selection + coverage). Pass a Mesh to run data-parallel over chips
    (parallel.mesh.MeshLogEngine is that configuration)."""

    def __init__(self, idx: PrgIndex, kmer_size: int,
                 cfg: Optional[LogConfig] = None, mesh=None):
        import os

        from ..common.jax_setup import enable_compile_cache
        from .jump_table import build_jump_table

        enable_compile_cache()
        self.idx = idx
        self.kmer_size = kmer_size
        # data-parallel mesh: rows round-robin over the 'data' axis, the
        # index replicated, each shard running the identical phased scan
        # + fused record on its row slice (the multi-chip analogue of the
        # reference's OpenMP buffer loop, quasimap.cpp:90-117, with the
        # per-read seeded selection RNG keeping results shard-count
        # invariant). mesh=None = single chip (S=1, layout = identity).
        self.mesh = mesh
        self.S = 1 if mesh is None else int(np.prod(mesh.devices.shape))
        self._shard_cache: dict = {}
        self.jt = build_jump_table(idx)
        self.di = DeviceIndex.build(idx, self.jt)
        idx.graph.node_tables()  # pre-build for the batched coverage recorder
        if cfg is None:
            cfg = LogConfig(
                pool=int(os.environ.get("GRAMTOOLS_TPU_POOL", LogConfig.pool)),
                hits=int(os.environ.get("GRAMTOOLS_TPU_HITS", LogConfig.hits)))
        self.cfg = cfg
        # rank implementation for the hot occ gather: "dense" (int32
        # prefix-table rows) or "packed" (bit-packed blocks + popcount
        # rank, ops/rank.py -- 21x smaller index residency)
        self.rank = os.environ.get("GRAMTOOLS_TPU_RANK", "dense")
        self.blocks = None
        if self.rank == "packed":
            import dataclasses

            from ..ops.rank import build_packed_occ

            self.blocks = jnp.asarray(build_packed_occ(idx.fm))
            # the dense occ table is dead weight in packed mode: ship a
            # stub so it never reaches device HBM
            self.di = dataclasses.replace(
                self.di, occ=jnp.zeros((1, 4), jnp.int32))
        self.replayer = PathReplayer(self.jt, self.di.n_outcomes)
        self._site_meta = None
        self._last_kmer_index = None
        # device-side selection + coverage recording (record_jax.py):
        # the flagship path; GRAMTOOLS_TPU_DEVICE_RECORD=0 reverts to the
        # numpy recorder (coverage_fast.py)
        self.device_record = os.environ.get(
            "GRAMTOOLS_TPU_DEVICE_RECORD", "1") == "1"
        self.rt = None               # RecordTables, built lazily
        self.st = None               # resident SeedTables (record mode)
        self._st_for = None          # kmer index the SeedTables were built for
        self.cov_diff = None         # persistent device per-base diff array
        self.host_fallbacks = 0
        self.device_mapped = 0
        self.device_retried = 0
        # why rows left the device path (observability for tuning)
        import collections as _c
        self.fallback_reasons = _c.Counter()
        # below this many overflowed reads, exact host re-maps beat a
        # second full-budget device scan
        self.retry_min = int(os.environ.get("GRAMTOOLS_TPU_RETRY_MIN", "16"))
        # adaptive hit budget: dense graphs overflow the phased hit
        # budgets (every overflow costs a retry scan); when a buffer's
        # overflow rate exceeds 2% the budget doubles for later buffers
        # (one extra compile per step-up, then steady)
        self.hits_boost = 1
        self.max_hits_boost = int(os.environ.get(
            "GRAMTOOLS_TPU_MAX_HITS_BOOST", "8"))
        # opt-in per-phase wall timers (GRAMTOOLS_TPU_TIMERS=1): seconds
        # accumulated per pipeline stage, for bench.py's breakdown
        import collections
        self.timers = collections.defaultdict(float)
        self._timing = os.environ.get("GRAMTOOLS_TPU_TIMERS") == "1"
        # sticky shape ratchets: every dispatch reuses the LARGEST shape
        # seen so far (extra rows/states are padding), so steady state
        # recompiles zero times. Each distinct dispatched shape costs a
        # full XLA compile of the fused program; paying it once per
        # buffer would dominate e2e wall time.
        self._sticky_R = 0
        self._sticky_steps = 0
        self._sticky_seeds = 0       # warm-pool ratchet (high-fan-out only)
        # observability: one entry per distinct dispatched device shape
        # (== number of XLA compiles a cold cache would pay)
        self.dispatch_shapes = set()
        # run_summary(): first submit, first completion (with the shape
        # count then), last completion; buffers submitted and completed
        # so far, and how many were submitted by the first completion
        self._first_submit = None
        self._first_done = None
        self._last_done = None
        self._n_submitted = 0
        self._n_done = 0
        self._steady_after = None
        self._steady_reads = 0

    def _tick(self, key, t0):
        import time
        if self._timing:
            t1 = time.perf_counter()
            self.timers[key] += t1 - t0
            return t1
        return t0

    # ---- shard layout ----------------------------------------------------
    # Global row r lives in shard r % S at local column r // S
    # (round-robin keeps shards balanced for partial buffers); a device
    # column c = s*R + local therefore maps back to row local*S + s.
    # For S == 1 both maps are the identity.

    def _cols_of(self, rows_idx, R: int):
        rows_idx = np.asarray(rows_idx)
        if self.S == 1:
            return rows_idx
        return (rows_idx % self.S) * R + rows_idx // self.S

    def _rows_of_all_cols(self, R: int):
        cols = np.arange(self.S * R)
        if self.S == 1:
            return cols
        return (cols % R) * self.S + cols // R

    def _place_states(self, owner_rows: np.ndarray, pool: int):
        """Distribute states into per-shard pools (front-packed).

        Returns (slot (m,), keep (m,), spilled_rows): slot = shard*pool +
        per-shard rank; states ranked past the pool spill their row to
        the host engine. For S == 1 this is the sequential fill."""
        m = owner_rows.size
        shard = owner_rows % self.S
        order = np.argsort(shard, kind="stable")
        cnt = np.bincount(shard, minlength=self.S)
        start = np.zeros(self.S, np.int64)
        start[1:] = np.cumsum(cnt)[:-1]
        rank = np.empty(m, np.int64)
        rank[order] = np.arange(m) - start[shard[order]]
        keep = rank < pool
        slot = shard * pool + np.minimum(rank, pool - 1)
        spilled = np.unique(owner_rows[~keep])
        return slot, keep, spilled

    # ---- device dispatch (single-chip jit or shard_map) -------------------

    def _shard_specs(self):
        from jax.sharding import PartitionSpec as P
        return P, jax.tree_util.tree_map(lambda _: P(), self.di)

    def _blocks_arg(self):
        # shard_map needs a concrete array operand; a 1-element stub
        # stands in when packed rank is off (the body never reads it)
        return self.blocks if self.blocks is not None else jnp.zeros(
            (1,), jnp.int32)

    def _run_packed(self, reads_T, carry, phases, R):
        """Dispatch the scan+pack program; returns the device result."""
        if self.S == 1:
            return _log_search_packed(self.di, jnp.asarray(reads_T),
                                      jax.device_put(carry), phases, R,
                                      blocks=self.blocks, rank=self.rank)
        key = ("packed", phases, R)
        fn = self._shard_cache.get(key)
        if fn is None:
            P, di_specs = self._shard_specs()
            rank = self.rank
            has_blocks = self.blocks is not None

            def shard_fn(di, blocks, reads_T, carry):
                return _packed_body(
                    di, reads_T, carry, phases, R,
                    blocks=blocks if has_blocks else None, rank=rank)

            fn = jax.jit(shard_map(
                shard_fn, mesh=self.mesh,
                in_specs=(di_specs, P(), P(None, "data"), (P("data"),) * 5),
                out_specs=P("data"), check_vma=False))
            self._shard_cache[key] = fn
        return fn(self.di, self._blocks_arg(), jnp.asarray(reads_T),
                  jax.device_put(carry))

    def _run_record(self, reads_p, slot_sidx, slot_row, row_ok, row_first,
                    row_len, phases, R, trip_cap):
        """Dispatch the fused scan+select+record program; returns
        (packed result, new cov_diff)."""
        if self.S == 1:
            return _log_search_record(
                self.di, self.rt, self.st, jnp.asarray(reads_p),
                jnp.asarray(slot_sidx), jnp.asarray(slot_row),
                jnp.asarray(row_ok), jnp.asarray(row_first),
                jnp.asarray(row_len), self.cov_diff, phases, R, trip_cap,
                self.kmer_size, blocks=self.blocks, rank=self.rank)
        key = ("record", phases, R, trip_cap)
        fn = self._shard_cache.get(key)
        if fn is None:
            P, di_specs = self._shard_specs()
            rt_specs = jax.tree_util.tree_map(lambda _: P(), self.rt)
            st_specs = jax.tree_util.tree_map(lambda _: P(), self.st)
            rank = self.rank
            has_blocks = self.blocks is not None
            kmer_size = self.kmer_size

            def shard_fn(di, rt, st, blocks, reads_p, slot_sidx, slot_row,
                         row_ok, row_first, row_len, cov_diff):
                packed, cd = _record_body(
                    di, rt, st, reads_p, slot_sidx, slot_row,
                    row_ok, row_first, row_len, cov_diff[0], phases, R,
                    trip_cap, kmer_size,
                    blocks=blocks if has_blocks else None, rank=rank)
                return packed, cd[None, :]

            fn = jax.jit(shard_map(
                shard_fn, mesh=self.mesh,
                in_specs=(di_specs, rt_specs, st_specs, P(),
                          P(None, "data"), P("data"), P("data"),
                          P("data"), P("data"), P("data"), P("data", None)),
                out_specs=(P("data"), P("data", None)),
                check_vma=False), donate_argnums=(10,))
            self._shard_cache[key] = fn
        packed, self_cov = fn(
            self.di, self.rt, self.st, self._blocks_arg(),
            jnp.asarray(reads_p), jnp.asarray(slot_sidx),
            jnp.asarray(slot_row), jnp.asarray(row_ok),
            jnp.asarray(row_first), jnp.asarray(row_len), self.cov_diff)
        return packed, self_cov

    def _scan_rows(self, buffer, kmer_index, kmer_size, stats):
        """Kmer filter + seed + device scan. Returns (results_skeleton,
        rows, carry_np, log_parent, log_event, seed arrays, host_rows)."""
        return self.scan_complete(
            self.scan_submit(buffer, kmer_index, kmer_size, stats))

    def scan_submit(self, buffer, kmer_index, kmer_size, stats,
                    first_raws=None):
        """Host filter + seeding, then *async* device dispatch: returns a
        pending token for scan_complete without blocking, so the device
        scans this buffer while the host finishes the previous one
        (the driver pipelines buffers through submit/complete).

        With first_raws (per-read precomputed mt19937 first draws) and
        device_record on, the dispatched program is the FUSED
        scan+select+record (_log_search_record): selection and coverage
        happen on device and only flags + loci triples come home."""
        import time

        t0 = time.perf_counter()
        if self._first_submit is None:
            self._first_submit = t0
        self._n_submitted += 1
        k = kmer_size
        self._last_kmer_index = kmer_index
        results, rows, rows_mat = _filter_buffer_rows(buffer, kmer_index, k,
                                                      stats)
        if not rows:
            return (results, [], None, None, set(), None, None)

        t0 = self._tick("submit_filter", t0)

        n = len(rows)
        S = self.S
        self._sticky_R = max(self._sticky_R, _row_capacity(-(-n // S)))
        R = self._sticky_R                # rows per shard
        max_len = max(r.size for _, r in rows)
        self._sticky_steps = max(self._sticky_steps,
                                 _round_up(max(max_len - k, 0), 16))
        steps = self._sticky_steps
        reads_T = np.zeros((steps, S * R), dtype=np.uint8)
        cols = self._cols_of(np.arange(n), R)
        host_rows = set()

        seed_fn = getattr(kmer_index, "seed_batch", None)
        arr_index = (seed_fn is not None
                     and getattr(kmer_index, "trav", None) is not None)
        # record mode: fused scan+select+record with RESIDENT seed
        # tables -- the host ships only placed state indices, never the
        # path payloads (record_jax.SeedTables docstring)
        record_mode = (self.device_record and first_raws is not None
                       and arr_index)
        s_lo = s_hi = sidx = None
        seeds = None
        if arr_index:
            # vectorised seeding from the array-backed kmer index
            if rows_mat is not None:
                L = rows_mat.shape[1]
                last_kmers = rows_mat[:, L - k:]
                reads_T[: L - k, cols] = rows_mat[:, : L - k][:, ::-1].T
            else:
                last_kmers = np.zeros((n, k), dtype=np.uint8)
                for row, (i, read) in enumerate(rows):
                    last_kmers[row] = read[read.size - k:]
                    body = read[: read.size - k][::-1]
                    reads_T[: body.size, cols[row]] = body
            if record_mode:
                owner, sidx = kmer_index.seed_batch_indices(last_kmers)
            else:
                (owner, s_lo, s_hi, s_trav, s_nt, s_ing, s_ni,
                 sidx) = seed_fn(last_kmers)
                seeds = (s_trav, s_nt, s_ing, s_ni)
        else:
            if S > 1:
                raise TypeError(
                    "mesh mapping needs the array-backed kmer index "
                    "(index.kmer_index_vec.build_kmer_index_vectorised); "
                    "the dict oracle index has no seed_batch")
            owner_l: list = []
            lo_l: list = []
            hi_l: list = []
            tups: list = []
            for row, (i, read) in enumerate(rows):
                seed = read[read.size - k:].astype(np.uint8).tobytes()
                states = kmer_index.get(seed, [])
                if not states:
                    host_rows.add(row)
                    continue
                for s in states:
                    owner_l.append(row)
                    lo_l.append(s.lo)
                    hi_l.append(s.hi)
                    tups.append((tuple(s.traversed), tuple(s.traversing)))
                body = read[: read.size - k][::-1]
                reads_T[: body.size, cols[row]] = body
            owner = np.asarray(owner_l, dtype=np.int64)
            s_lo = np.asarray(lo_l, dtype=np.int64)
            s_hi = np.asarray(hi_l, dtype=np.int64)
            P0 = max((max(len(t), len(g)) for t, g in tups), default=0)
            P0 = max(P0, 1)
            m = owner.size
            s_trav = np.zeros((m, P0, 2), dtype=np.int32)
            s_ing = np.zeros((m, P0, 2), dtype=np.int32)
            s_nt = np.zeros(m, dtype=np.int32)
            s_ni = np.zeros(m, dtype=np.int32)
            for si, (t, g) in enumerate(tups):
                s_nt[si] = len(t)
                s_ni[si] = len(g)
                for pi, locus in enumerate(t):
                    s_trav[si, pi] = locus
                for pi, locus in enumerate(g):
                    s_ing[si, pi] = locus
            seeds = (s_trav, s_nt, s_ing, s_ni)

        t0 = self._tick("submit_seed", t0)
        n_states = owner.size
        if steps > 0 and n_states > 0:
            # the marker-hit budget is a GLOBAL per-step quota shared by
            # all of a shard's rows: scale it LINEARLY with the row
            # capacity (cfg.hits is per 4096 rows; the old R//8192
            # scaling under-budgeted 20k-read buffers 2x -> 10% of reads
            # overflowed and the adaptive boost recompiled mid-run)
            cfg_eff = LogConfig(
                pool=self.cfg.pool,
                hits=self.cfg.hits * max(1, R // 4096) * self.hits_boost)
            # the seed-state ratchet only grows the warm pool on
            # high-fan-out graphs; at production buffer sizes the 4R
            # floor meets the pool cap first, so the dispatched shape is
            # canonical from buffer one (auto_phases docstring)
            per_shard = (int(np.bincount(owner % S, minlength=S).max())
                         if S > 1 else n_states)
            self._sticky_seeds = max(self._sticky_seeds, per_shard)
            phases = auto_phases(steps, R, cfg_eff,
                                 n_seed_states=self._sticky_seeds)
            pool0 = phases[0][1]
            slot, keep, spilled = self._place_states(owner, pool0)
            host_rows.update(int(r) for r in spilled)
            placed = slot[keep]
            seeded = np.zeros(n, dtype=bool)
            seeded[owner[keep]] = True
            host_rows.update(int(r) for r in np.flatnonzero(~seeded))
            if record_mode:
                self._ensure_seed_tables(kmer_index)
                slot_sidx = np.full(S * pool0, -1, np.int32)
                slot_row = np.full(S * pool0, -1, np.int32)
                slot_sidx[placed] = sidx[keep].astype(np.int32)
                slot_row[placed] = (owner[keep] // S).astype(np.int32)
                reads_p = _pack_reads2(reads_T)
                t0 = self._tick("submit_pack", t0)
                device_out = self._dispatch_record(
                    rows, reads_p, slot_sidx, slot_row, host_rows,
                    first_raws, phases, R)
                self._tick("submit_dispatch", t0)
                return (results, rows, device_out, None, host_rows,
                        (slot_sidx, slot_row), reads_p)
            carry = (np.full(S * pool0, -1, np.int32),
                     np.zeros(S * pool0, np.int32),
                     np.zeros(S * pool0, np.int32),
                     np.zeros(S * pool0, np.int32),
                     np.zeros(S * R, bool))
            rid_c, lo_c, hi_c, pref_c = carry[0], carry[1], carry[2], carry[3]
            rid_c[placed] = (owner[keep] // S).astype(np.int32)
            lo_c[placed] = s_lo[keep]
            hi_c[placed] = s_hi[keep]
            # seed prefs reference the (replicated) seed list by ORIGINAL
            # index, independent of placement order
            pref_c[placed] = -(np.flatnonzero(keep).astype(np.int32) + 1)
            t0 = self._tick("submit_put", t0)
            self.dispatch_shapes.add(
                ("packed", phases, R, reads_T.shape,
                 tuple(a.shape for a in carry)))
            device_out = (self._run_packed(reads_T, carry, phases, R),
                          phases, R)
        else:
            # no extension steps / no seeds: everything via the exact
            # host path
            host_rows.update(range(n))
            carry = None
            device_out = None
        self._tick("submit_dispatch", t0)
        return (results, rows, device_out, seeds, host_rows, carry, reads_T)

    def _ensure_record_tables(self):
        if self.rt is None:
            from .record_jax import RecordTables
            self.rt = RecordTables.build(self.idx)
        if self.cov_diff is None:
            shape = ((self.rt.cov_size + 1,) if self.S == 1
                     else (self.S, self.rt.cov_size + 1))
            self.cov_diff = jax.device_put(np.zeros(shape, np.int32))

    def _ensure_seed_tables(self, kmer_index):
        """Upload the kmer index's seed-state payloads ONCE
        (record_jax.SeedTables); per buffer only placed indices ship."""
        if self.st is None or self._st_for is not kmer_index:
            from .record_jax import SeedTables
            self.st = SeedTables.build(kmer_index)
            self._st_for = kmer_index

    def _dispatch_record(self, rows, reads_p, slot_sidx, slot_row, host_rows,
                         first_raws, phases, R, row_map=None):
        """Dispatch the fused scan+record program for one (sub)buffer.

        row_map: optional original-row ids (retry pass); None = identity.
        Per-row arrays are laid out in shard-major column space
        (self._cols_of). Returns the "record"-tagged token entry."""
        self._ensure_record_tables()
        S = self.S
        nrows = len(rows) if row_map is None else row_map.size
        row_ok = np.ones(S * R, dtype=bool)
        if host_rows:
            row_ok[self._cols_of(np.fromiter(host_rows, dtype=np.int64,
                                             count=len(host_rows)), R)] = False
        row_first = np.zeros(S * R, dtype=np.uint32)
        row_len = np.zeros(S * R, dtype=np.int32)
        cols = self._cols_of(np.arange(nrows), R)
        first_arr = np.asarray(first_raws)
        if row_map is None:
            src = rows
        else:
            src = [rows[int(o)] for o in row_map]
        if src:
            owners = np.fromiter((i for i, _ in src), dtype=np.int64,
                                 count=len(src))
            lens = np.fromiter((r.size for _, r in src), dtype=np.int64,
                               count=len(src))
            row_first[cols] = first_arr[owners]
            row_len[cols] = lens
        trip_cap = 4 * R
        self.dispatch_shapes.add(
            ("record", phases, R, trip_cap, reads_p.shape))
        packed, self.cov_diff = self._run_record(
            reads_p, slot_sidx, slot_row, row_ok, row_first, row_len,
            phases, R, trip_cap)
        return ("record", packed, R, trip_cap, phases)

    def _empty_carry_np(self, nrows: int):
        """Global-space stand-in when nothing was dispatched."""
        z = np.zeros(0, np.int32)
        return (np.full(0, -1, np.int32), z, z, z,
                np.zeros(max(nrows, 1), dtype=bool))

    def scan_complete(self, token):
        """Blocks on a scan_submit token; returns (results_skeleton,
        rows, carry_np, log_parent, log_event, seed arrays, host_rows)
        with carry/overflow in GLOBAL row space."""
        import time

        results, rows, device_out, seeds, host_rows, carry, reads_T = token
        if device_out is not None:
            flat, phases, R = device_out
            t0 = time.perf_counter()
            # result tree packed on device -> ONE device->host transfer
            carry_np, log_parent, log_event = _unpack_result(
                jax.device_get(flat), phases, R, self.di.n_outcomes,
                n_shards=self.S)
            t0 = self._tick("complete_get", t0)
            carry_np, log_parent, log_event = self._retry_overflow(
                carry_np, log_parent, log_event, carry, reads_T, len(rows),
                phases, R, host_rows=host_rows)
            self._tick("complete_retry", t0)
        else:
            carry_np = self._empty_carry_np(len(rows))
            log_parent = log_event = np.empty(0, dtype=np.int32)
        return (results, rows, carry_np, log_parent, log_event, seeds,
                host_rows)

    def _globalise_init_rid(self, init_read_id):
        """Init-carry read ids are per-shard local: map to global rows."""
        if self.S == 1:
            return init_read_id
        pool0 = init_read_id.size // self.S
        shard = np.arange(init_read_id.size) // pool0
        return np.where(init_read_id >= 0,
                        init_read_id * self.S + shard, -1)

    def _relayout_retry(self, init_carry, ovf_rows, reads_T, nrows, phases,
                        R):
        """Build the retry pass's carry/read matrix: the overflowed rows
        re-numbered 0..n_ovf-1 and redistributed over shards, their pass-1
        seed states replayed from the init carry (same seed list / log
        references).

        The retry dispatches the SAME (phases, R) program as the main
        pass -- one compiled device program per run, no separate retry
        shape, no prewarm compile (a second canonical shape would double
        the cold-cache warmup). The budgets that overflowed pass 1 are
        shared global quotas: with only the overflowed rows live, the
        retry pass has the whole hit budget and pool to itself, so
        budget-contention overflow (the common class) recovers; rows
        whose own state count exceeds the shape fall back to the exact
        host path. Rows whose seed states spill the pool are dropped
        from the retried set (flag survives -> host re-map). Returns
        (carry2, reads_T2, phases, R, retried_rows) or None."""
        S = self.S
        pool0 = phases[0][1]
        ovf_rows = ovf_rows[:S * R]
        init_read_id, init_lo, init_hi, init_pref = init_carry[:4]
        init_rid_g = self._globalise_init_rid(init_read_id)
        for _ in range(2):
            row_map = np.full(nrows, -1, dtype=np.int32)
            row_map[ovf_rows] = np.arange(ovf_rows.size, dtype=np.int32)
            sel = np.flatnonzero(
                (init_rid_g >= 0)
                & np.isin(init_rid_g, ovf_rows, assume_unique=False))
            retry_rows = row_map[init_rid_g[sel]]
            slot, keep, spilled = self._place_states(retry_rows, pool0)
            if not spilled.size:
                break
            # rows whose seed states do not fit the pool must stay OUT of
            # the retried set (their overflow flag must survive the merge
            # -> exact host re-map): drop and re-number
            drop_mask = np.zeros(ovf_rows.size, dtype=bool)
            drop_mask[spilled] = True
            ovf_rows = ovf_rows[~drop_mask]
            if ovf_rows.size == 0:
                return None
        else:
            return None   # still spilling after one re-number: host path
        carry2 = (np.full(S * pool0, -1, np.int32),
                  np.zeros(S * pool0, np.int32),
                  np.zeros(S * pool0, np.int32),
                  np.zeros(S * pool0, np.int32),
                  np.zeros(S * R, dtype=bool))
        carry2[0][slot] = (retry_rows // S).astype(np.int32)
        carry2[1][slot] = init_lo[sel]
        carry2[2][slot] = init_hi[sel]
        carry2[3][slot] = init_pref[sel]     # same seed list / pass-1 log
        reads_T2 = np.zeros((reads_T.shape[0], S * R), dtype=reads_T.dtype)
        cols_src = self._cols_of(ovf_rows, reads_T.shape[1] // S)
        cols_dst = self._cols_of(np.arange(ovf_rows.size), R)
        reads_T2[:, cols_dst] = reads_T[:, cols_src]
        return carry2, reads_T2, phases, R, ovf_rows

    def _relayout_retry_record(self, slot_sidx, slot_row, ovf_rows, reads_p,
                               nrows, phases, R):
        """Record-path twin of _relayout_retry: rebuilds the slot->
        (seed state, row) maps and the packed read matrix with only the
        overflowed rows live, for a re-dispatch of the SAME (phases, R)
        program. Returns (slot_sidx2, slot_row2, reads_p2, retried_rows)
        or None."""
        S = self.S
        pool0 = phases[0][1]
        ovf_rows = ovf_rows[:S * R]
        shard_of = np.arange(slot_sidx.size) // pool0
        g_row = np.where(slot_sidx >= 0, slot_row * S + shard_of, -1)
        for _ in range(2):
            row_map = np.full(nrows, -1, dtype=np.int32)
            row_map[ovf_rows] = np.arange(ovf_rows.size, dtype=np.int32)
            sel = np.flatnonzero((slot_sidx >= 0)
                                 & np.isin(g_row, ovf_rows))
            retry_rows = row_map[g_row[sel]]
            slot, keep, spilled = self._place_states(retry_rows, pool0)
            if not spilled.size:
                break
            drop_mask = np.zeros(ovf_rows.size, dtype=bool)
            drop_mask[spilled] = True
            ovf_rows = ovf_rows[~drop_mask]
            if ovf_rows.size == 0:
                return None
        else:
            return None
        slot_sidx2 = np.full(S * pool0, -1, np.int32)
        slot_row2 = np.full(S * pool0, -1, np.int32)
        placed = slot[keep]
        slot_sidx2[placed] = slot_sidx[sel[keep]]
        slot_row2[placed] = (retry_rows[keep] // S).astype(np.int32)
        reads_p2 = np.zeros_like(reads_p)
        cols_src = self._cols_of(ovf_rows, reads_p.shape[1] // S)
        cols_dst = self._cols_of(np.arange(ovf_rows.size), R)
        reads_p2[:, cols_dst] = reads_p[:, cols_src]
        return slot_sidx2, slot_row2, reads_p2, ovf_rows

    def _retry_overflow(self, carry_np, log_parent, log_event, init_carry,
                        reads_T, nrows, phases, R, host_rows=()):
        """One full-budget device re-scan of reads the phased plan
        overflowed (budget spill or pool shrink), before any host
        fallback. The genealogy-log encoding makes the merge linear:
        pass-2 newborn prefs/log-parents shift by pass-1's log length;
        negative (seed) prefs reference the same seed list and need no
        change. Reads that overflow again keep their flag (-> exact host
        re-map). Worth one extra scan only when many reads overflowed
        (dense/repetitive graphs); a handful is cheaper on the host."""
        overflow = carry_np[4]
        # host-bound rows get re-mapped exactly anyway: never retry them
        # (their retry results would be merged AND the host would re-map)
        ovf_flags = overflow[:nrows].copy()
        for r in host_rows:
            ovf_flags[r] = False
        ovf_rows = np.flatnonzero(ovf_flags)
        if ovf_rows.size > max(0.02 * nrows, 8):
            self.hits_boost = min(self.hits_boost * 2, self.max_hits_boost)
        if ovf_rows.size < self.retry_min or reads_T.shape[0] == 0:
            return carry_np, log_parent, log_event
        import logging

        relayout = self._relayout_retry(init_carry, ovf_rows, reads_T, nrows,
                                        phases, R)
        if relayout is None:
            return carry_np, log_parent, log_event
        carry2, reads_T2, p2, R2, ovf_rows = relayout
        self.dispatch_shapes.add(("packed", p2, R2, reads_T2.shape,
                                  tuple(a.shape for a in carry2)))
        flat2 = self._run_packed(reads_T2, carry2, p2, R2)
        c2, lp2, le2 = _unpack_result(jax.device_get(flat2), p2, R2,
                                      self.di.n_outcomes, n_shards=self.S)
        lp2 = lp2.copy()
        L1 = log_parent.size
        lp2[lp2 >= 0] += L1

        f_rid, f_lo, f_hi, f_pref, _ = (a.copy() for a in carry_np[:5])
        # pass-1 states of retried reads are incomplete: drop them
        drop = (f_rid >= 0) & np.isin(f_rid, ovf_rows)
        f_rid[drop] = -1
        rid2_f, lo2_f, hi2_f, pref2_f, ovf2 = c2
        live2 = rid2_f >= 0
        pref2_m = pref2_f.copy()
        pref2_m[live2 & (pref2_m >= 0)] += L1
        rid2_m = np.where(live2, ovf_rows[np.clip(rid2_f, 0, ovf_rows.size - 1)],
                          -1).astype(f_rid.dtype)

        overflow = overflow.copy()
        overflow[ovf_rows] = ovf2[:ovf_rows.size]
        self.device_retried += int(ovf_rows.size)
        logging.getLogger("gramtools_tpu").debug(
            "device retry: %d reads, %d still overflowed",
            ovf_rows.size, int(ovf2[:ovf_rows.size].sum()))
        merged = (np.concatenate([f_rid, rid2_m]),
                  np.concatenate([f_lo, lo2_f]),
                  np.concatenate([f_hi, hi2_f]),
                  np.concatenate([f_pref, pref2_m]),
                  overflow)
        return (merged, np.concatenate([log_parent, lp2]),
                np.concatenate([log_event, le2]))

    def search_buffer(self, buffer, kmer_index, kmer_size, stats):
        from .search import (handle_allele_encapsulated_states,
                             search_read_backwards)

        k = kmer_size
        (results, rows, carry_np, log_parent, log_event, seeds,
         host_rows) = self._scan_rows(buffer, kmer_index, kmer_size, stats)
        if not rows:
            return results
        (f_read_id, f_lo, f_hi, f_pref, overflow) = carry_np
        s_trav, s_nt, s_ing, s_ni = seeds

        # group final pool states by read, replaying paths from the log
        def seed_paths(si):
            nt, ni = int(s_nt[si]), int(s_ni[si])
            return (tuple(map(tuple, s_trav[si, :nt].tolist())),
                    tuple(map(tuple, s_ing[si, :ni].tolist())))

        per_row_states: dict = {}
        order = np.argsort(f_read_id, kind="stable")
        for pi in order:
            r = int(f_read_id[pi])
            if r < 0:
                continue
            trav, ing = self.replayer.replay(int(f_pref[pi]), log_parent,
                                             log_event, seed_paths)
            state = SearchState(int(f_lo[pi]), int(f_hi[pi]), trav, ing)
            per_row_states.setdefault(r, []).append(state)

        for row, (i, read) in enumerate(rows):
            if row in host_rows or bool(overflow[row]):
                self.host_fallbacks += 1
                seed = read[read.size - k:].astype(np.uint8).tobytes()
                seed_states = kmer_index.get(seed, [])
                states = (search_read_backwards(read, seed_states, k, self.idx)
                          if seed_states else [])
            else:
                self.device_mapped += 1
                states = handle_allele_encapsulated_states(
                    per_row_states.get(row, []), self.idx)
            results[i].append((states, int(read.size)))
        return results

    def record_buffer(self, buffer, kmer_index, kmer_size, stats, coverage,
                      selection_seeds, first_raws):
        """Scan + vectorised selection/recording for a whole buffer.
        Hard cases (overflow, unseeded, LocusFinder edge features) re-map
        and record through the exact scalar path."""
        token = self.scan_submit(buffer, kmer_index, kmer_size, stats,
                                 first_raws=first_raws)
        self.record_complete(token, selection_seeds, first_raws, stats,
                             coverage, kmer_index, kmer_size)

    def flush_device_coverage(self):
        """Fold the device-resident per-base diff array into the graph's
        coverage (called once per run, after the last buffer)."""
        if self.cov_diff is None:
            return
        from .record_jax import finalise_cov_diff

        diff = jax.device_get(self.cov_diff)
        if diff.ndim == 2:          # mesh: one diff array per shard
            diff = diff.sum(axis=0)
        counts = finalise_cov_diff(diff)
        g = self.idx.graph
        if g.coverage.size:
            merged = g.coverage.astype(np.int64) + counts
            np.minimum(merged, np.iinfo(np.uint16).max, out=merged)
            g.coverage[:] = merged.astype(np.uint16)
        self.cov_diff = None

    def _record_complete_device(self, token, selection_seeds, first_raws,
                                stats, coverage, kmer_index, kmer_size):
        """Completion for the fused scan+record dispatch: fetch flags +
        triples, retry overflowed rows with a full-budget second pass,
        fold triples, host-record fallback rows exactly."""
        import time

        from .coverage import record_search_states
        from .coverage_fast import fold_loci_rows
        from .search import search_read_backwards

        (results, rows, device_out, _seeds, host_rows, slots, reads_p) = token
        slot_sidx, slot_row = slots
        _, packed, R, trip_cap, phases = device_out
        k = kmer_size if kmer_size is not None else self.kmer_size
        if kmer_index is None:
            kmer_index = self._last_kmer_index
        t0 = time.perf_counter()
        # a plain blocking copy: GPU dispatch is asynchronous, so the
        # device ran this buffer while the host submitted the next one
        # (a background fetch thread measured no faster, PERF.md)
        flat = jax.device_get(packed)
        t0 = self._tick("complete_get", t0)
        ovf, fallback, mapped, loci_rows = _unpack_record_result(
            flat, R, trip_cap, n_shards=self.S)
        nrows = len(rows)
        fold_loci_rows(coverage, loci_rows)
        t0 = self._tick("complete_fold", t0)
        from .record_jax import FB_NAMES
        for bit, name in FB_NAMES.items():
            n_bit = int(((fallback[:nrows] & bit) != 0).sum())
            if n_bit:
                self.fallback_reasons[f"record:{name}"] += n_bit

        # full-budget retry pass for rows the phased budgets overflowed.
        # Rows already bound for the exact host path must NOT be retried:
        # the retry dispatch records device-side, and the host loop below
        # re-maps host_rows regardless -- retrying them double-counts
        # their coverage (host_rows rows can carry an overflow flag when
        # part of their seed states were placed and the pool dropped
        # them).
        ovf_flags = ovf[:nrows].copy()
        for r in host_rows:
            ovf_flags[r] = False
        ovf_rows = np.flatnonzero(ovf_flags)
        if ovf_rows.size > max(0.02 * nrows, 8):
            self.hits_boost = min(self.hits_boost * 2, self.max_hits_boost)
        if (ovf_rows.size >= self.retry_min and reads_p.shape[0] > 0):
            relayout = self._relayout_retry_record(
                slot_sidx, slot_row, ovf_rows, reads_p, nrows, phases, R)
            if relayout is not None:
                slot_sidx2, slot_row2, reads_p2, ovf_rows = relayout
                dev2 = self._dispatch_record(
                    rows, reads_p2, slot_sidx2, slot_row2, set(),
                    first_raws, phases, R, row_map=ovf_rows)
                _, packed2, _, tc2, _ = dev2
                ovf2, fb2, mapped2, loci2 = _unpack_record_result(
                    jax.device_get(packed2), R, tc2, n_shards=self.S)
                if loci2.shape[0]:
                    loci2[:, 0] = ovf_rows[loci2[:, 0]]
                    fold_loci_rows(coverage, loci2)
                ovf[ovf_rows] = ovf2[:ovf_rows.size]
                fallback[ovf_rows] = fb2[:ovf_rows.size]
                mapped[ovf_rows] = mapped2[:ovf_rows.size]
                self.device_retried += int(ovf_rows.size)
        t0 = self._tick("complete_retry", t0)

        # exact host path for unseeded / still-overflowed / fallback rows;
        # device rows are tallied vectorised (a per-row Python loop over
        # throughput-mode buffers costs ~0.1s/buffer of pure iteration)
        host_mask = np.zeros(nrows, dtype=bool)
        for r in host_rows:
            host_mask[r] = True
        need_host = host_mask | ovf[:nrows] | (fallback[:nrows] != 0)
        for row in np.flatnonzero(need_host):
            i, read = rows[row]
            self.fallback_reasons[
                "unseeded" if host_mask[row] else
                "overflow" if ovf[row] else "record_flagged"] += 1
            self.host_fallbacks += 1
            seed = read[read.size - k:].astype(np.uint8).tobytes()
            seed_states = kmer_index.get(seed, [])
            states = (search_read_backwards(read, seed_states, k,
                                            self.idx)
                      if seed_states else [])
            if not states:
                stats.no_extension_reads_count += 1
                continue
            stats.exact_mapped_reads_count += 1
            record_search_states(coverage, states, int(read.size),
                                 self.idx, selection_seeds[i],
                                 int(first_raws[i]))
        dev_rows = ~need_host
        n_dev = int(dev_rows.sum())
        n_mapped = int((mapped[:nrows] & dev_rows).sum())
        self.device_mapped += n_dev
        stats.exact_mapped_reads_count += n_mapped
        stats.no_extension_reads_count += n_dev - n_mapped
        self._tick("complete_hostmap", t0)

    def record_complete(self, token, selection_seeds, first_raws, stats,
                        coverage, kmer_index=None, kmer_size=None):
        """Second half of the pipelined record path: blocks on the device
        scan of ``token`` (submitted by scan_submit) then runs vectorised
        selection + recording. kmer_index/kmer_size default to the
        engine's own (needed only for scalar fallback re-maps)."""
        self._record_complete(token, selection_seeds, first_raws, stats,
                              coverage, kmer_index, kmer_size)
        self._note_buffer_done(len(token[0]))

    def _note_buffer_done(self, n_reads: int):
        import time
        t = time.perf_counter()
        self._n_done += 1
        if self._first_done is None:
            self._first_done = (t, len(self.dispatch_shapes))
            self._steady_after = self._n_submitted
        elif self._n_done > self._steady_after:
            self._steady_reads += n_reads
        self._last_done = t

    def run_summary(self) -> dict:
        """Per-run observability for the genotype report: the first
        buffer's wall time (cold compiles included), the mapping rate
        over the later buffers, and how many new device shapes (=
        compiles) those later buffers dispatched (0 in steady state).

        The steady window runs from the first completion to the last
        and counts the reads of the buffers submitted after the first
        completion, so each counted read has its submit and its complete
        inside it. Pipelined (buffer 2 is submitted before buffer 1
        completes), the window also holds buffer 2's complete: the rate
        errs low by one buffer's completion."""
        out = {"device_mapped": self.device_mapped,
               "host_fallbacks": self.host_fallbacks,
               "device_retried": self.device_retried,
               "fallback_reasons": dict(self.fallback_reasons),
               "dispatch_shapes": len(self.dispatch_shapes)}
        if self._first_done is not None:
            t1, n_shapes = self._first_done
            out["first_buffer_seconds"] = t1 - self._first_submit
            out["steady_state_new_shapes"] = (len(self.dispatch_shapes)
                                              - n_shapes)
            if self._steady_reads:
                out["steady_reads_per_second"] = (
                    self._steady_reads / (self._last_done - t1))
        return out

    def _record_complete(self, token, selection_seeds, first_raws, stats,
                         coverage, kmer_index=None, kmer_size=None):
        from .coverage import record_search_states
        from .coverage_fast import SiteMeta, select_and_record
        from .search import search_read_backwards

        if (isinstance(token[2], tuple) and len(token[2]) == 5
                and token[2][0] == "record"):
            return self._record_complete_device(
                token, selection_seeds, first_raws, stats, coverage,
                kmer_index, kmer_size)
        if kmer_index is None:
            kmer_index = self._last_kmer_index
        k = self.kmer_size if kmer_size is None else kmer_size
        (results, rows, carry_np, log_parent, log_event, seeds,
         host_rows) = self.scan_complete(token)
        if not rows:
            return
        (f_read_id, f_lo, f_hi, f_pref, overflow) = carry_np
        s_trav, s_nt, s_ing, s_ni = seeds

        sel, trav, n_trav, ing, n_ing = replay_paths_vectorised(
            f_read_id, f_pref, log_parent, log_event,
            s_trav, s_nt, s_ing, s_ni, self.jt, self.di.n_outcomes)

        nrows = len(rows)
        # rows handled by the scalar path from the start
        scalar_rows = np.zeros(nrows, dtype=bool)
        for r in host_rows:
            scalar_rows[r] = True
        scalar_rows |= overflow[:nrows]

        st_row = f_read_id[sel].astype(np.int64)
        keep = (st_row < nrows) & ~scalar_rows[np.clip(st_row, 0, nrows - 1)]
        sel, st_row = sel[keep], st_row[keep]
        trav, n_trav = trav[keep], n_trav[keep]
        ing, n_ing = ing[keep], n_ing[keep]

        row_seed = np.array([selection_seeds[i] for i, _ in rows],
                            dtype=np.int64)
        row_first = np.array([int(first_raws[i]) for i, _ in rows],
                             dtype=np.int64)
        row_len = np.array([r.size for _, r in rows], dtype=np.int64)

        if self._site_meta is None:
            self._site_meta = SiteMeta(self.idx)
        vec_fallback = select_and_record(
            self.idx, coverage,
            st_row, f_lo[sel].astype(np.int64), f_hi[sel].astype(np.int64),
            trav, n_trav, ing, n_ing,
            row_seed, row_first, row_len, site_meta=self._site_meta)

        has_states = np.zeros(nrows, dtype=bool)
        has_states[st_row] = True

        # scalar path: pre-flagged rows re-map; vector-fallback rows reuse
        # their replayed states
        for row, (i, read) in enumerate(rows):
            if scalar_rows[row]:
                self.host_fallbacks += 1
                seed = read[read.size - k:].astype(np.uint8).tobytes()
                seed_states = kmer_index.get(seed, [])
                states = (search_read_backwards(read, seed_states, k, self.idx)
                          if seed_states else [])
                if not states:
                    stats.no_extension_reads_count += 1
                    continue
                stats.exact_mapped_reads_count += 1
                record_search_states(coverage, states, int(read.size),
                                     self.idx, selection_seeds[i],
                                     int(first_raws[i]))
                continue
            self.device_mapped += 1
            if not has_states[row]:
                stats.no_extension_reads_count += 1
                continue
            stats.exact_mapped_reads_count += 1
            if vec_fallback[row]:
                from .search import handle_allele_encapsulated_states
                mask = st_row == row
                states = [
                    SearchState(
                        int(f_lo[s]), int(f_hi[s]),
                        tuple(map(tuple, trav[j, :n_trav[j]].tolist())),
                        tuple(map(tuple, ing[j, :n_ing[j]].tolist())))
                    for j, s in zip(np.flatnonzero(mask), sel[mask])]
                states = handle_allele_encapsulated_states(states, self.idx)
                record_search_states(coverage, states, int(read.size),
                                     self.idx, selection_seeds[i],
                                     int(first_raws[i]))
