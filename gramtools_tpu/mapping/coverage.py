"""Coverage recording: per-base, allele-sum, grouped allele counts.

Semantics ported from libgramtools:
  * mapping-instance selection   src/genotype/quasimap/coverage/coverage_common.cpp
  * per-base recording           src/genotype/quasimap/coverage/allele_base.cpp
  * allele-sum                   src/genotype/quasimap/coverage/allele_sum.cpp
  * grouped counts               src/genotype/quasimap/coverage/grouped_allele_counts.cpp

The mutable coverage lives in dense arrays (the graph's flat per-base
array, per-site allele-sum lists); no atomics are needed because each
shard accumulates privately and shards merge by addition (psum across devices).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

from ..common.rng import RandomInclusiveInt
from ..prg.markers import site_id_to_index
from .search import PrgIndex, SearchState

Locus = Tuple[int, int]
UINT16_MAX = np.iinfo(np.uint16).max


@dataclass
class Coverage:
    """Parity: gram::Coverage (quasimap/coverage/types.hpp).

    The batched recorder (coverage_fast.py) appends per-buffer count
    arrays to the pending_* lists instead of updating the python
    structures; finalise() folds them in once per run (quasimap_reads
    calls it before returning)."""

    allele_sum: List[List[int]]
    grouped_counts: List[Dict[Tuple[int, ...], int]]
    # per-base coverage lives in graph.coverage (flat uint16)
    pending_sum: Optional[list] = None       # [(site, allele, count) arrays]
    pending_group: Optional[list] = None     # [(site, size, packed, count)]

    @classmethod
    def empty(cls, idx: PrgIndex) -> "Coverage":
        g = idx.graph
        allele_sum: List[List[int]] = [[] for _ in range(g.num_sites)]
        for entry, _ in g.bubbles:
            site_index = site_id_to_index(g.node(entry).site_id)
            allele_sum[site_index] = [0] * len(g.node(entry).edges)
        grouped: List[Dict[Tuple[int, ...], int]] = [{} for _ in range(g.num_sites)]
        return cls(allele_sum, grouped, [], [])

    def merge(self, other: "Coverage"):
        for mine, theirs in zip(self.allele_sum, other.allele_sum):
            for i, v in enumerate(theirs):
                mine[i] += v
        for mine_d, theirs_d in zip(self.grouped_counts, other.grouped_counts):
            for k, v in theirs_d.items():
                mine_d[k] = mine_d.get(k, 0) + v
        if other.pending_sum:
            self.pending_sum.extend(other.pending_sum)
        if other.pending_group:
            self.pending_group.extend(other.pending_group)

    def finalise(self):
        """Fold pending batch-count arrays into the python structures."""
        if self.pending_sum:
            site = np.concatenate([p[0] for p in self.pending_sum])
            allele = np.concatenate([p[1] for p in self.pending_sum])
            count = np.concatenate([p[2] for p in self.pending_sum])
            key = site * np.int64(1 << 20) + allele
            uniq, inv = np.unique(key, return_inverse=True)
            tot = np.bincount(inv, weights=count).astype(np.int64)
            for k, c in zip(uniq, tot):
                s, a = int(k >> 20), int(k & ((1 << 20) - 1))
                self.allele_sum[site_id_to_index(s)][a] += int(c)
            self.pending_sum.clear()
        if self.pending_group:
            site = np.concatenate([p[0] for p in self.pending_group])
            size = np.concatenate([p[1] for p in self.pending_group])
            packed = np.concatenate([p[2] for p in self.pending_group])
            count = np.concatenate([p[3] for p in self.pending_group])
            rows = np.stack([site, size, packed], axis=1)
            uniq, first, inv = np.unique(rows, axis=0, return_index=True,
                                         return_inverse=True)
            tot = np.bincount(inv.reshape(-1), weights=count).astype(np.int64)
            # insert in first-occurrence order: group-ID numbering in the
            # JSON dump then matches the scalar path's read order
            for gi in np.argsort(first, kind="stable"):
                s, sz, pk = uniq[gi]
                alleles = []
                pk = int(pk)
                for _ in range(int(sz)):
                    alleles.append((pk & ((1 << 20) - 1)) - 1)
                    pk >>= 20
                d = self.grouped_counts[site_id_to_index(int(s))]
                key = tuple(alleles)
                d[key] = d.get(key, 0) + int(tot[gi])
            self.pending_group.clear()


# --- locus finding (coverage_common.cpp:10-83) ------------------------------


class LocusFinder:
    def __init__(self, state: SearchState, idx: PrgIndex):
        self.state = state
        self.idx = idx
        self.base_sites: Set[int] = set()
        self.used_sites: Set[int] = set()
        self.unique_loci: Set[Locus] = set()
        self._check_site_uniqueness()
        self._assign_traversing_loci()
        self._assign_traversed_loci()

    def _check_site_uniqueness(self):
        all_loci = list(self.state.traversed) + list(self.state.traversing)
        sites = [l[0] for l in all_loci]
        if len(sites) != len(set(sites)):
            raise RuntimeError(
                "A site cannot have been traversed more than once by a read")

    def _assign_nested_locus(self, locus: Locus):
        par_map = self.idx.graph.par_map
        cur = locus
        while True:
            marker = cur[0]
            if marker in self.used_sites:
                break
            self.used_sites.add(marker)
            self.unique_loci.add(cur)
            if marker not in par_map:
                self.base_sites.add(marker)
                break
            cur = par_map[marker]

    def _assign_traversing_loci(self):
        if not self.state.traversing:
            return
        parent_seed = self.state.traversing[-1][0]
        g = self.idx.graph
        new_locus = None
        for i in range(self.state.lo, self.state.hi + 1):
            prg_pos = int(self.idx.fm.sa[i])
            allele_id = g.node(int(g.ra_node[prg_pos])).allele_id
            new_locus = (parent_seed, allele_id)
            self.unique_loci.add(new_locus)
        self._assign_nested_locus(new_locus)

    def _assign_traversed_loci(self):
        for locus in self.state.traversed:
            self._assign_nested_locus(locus)


# --- mapping instance selection (coverage_common.cpp:85-177) ----------------


@dataclass
class SelectedMapping:
    states: List[SearchState] = field(default_factory=list)
    loci: Set[Locus] = field(default_factory=set)


def select_mapping_instance(states: List[SearchState], idx: PrgIndex,
                            selection_seed: int,
                            first_raw: Optional[int] = None) -> SelectedMapping:
    """Uniform pick of one mapping instance: either a non-variant occurrence
    or one site-equivalence class. RNG parity with the reference's
    per-read mt19937 selection; `first_raw` is the optional precomputed
    first raw draw (common/rng.py fast path)."""
    # group path-bearing states by their set of base (level-1) sites
    usps: Dict[FrozenSet[int], Tuple[List[SearchState], Set[Locus]]] = {}
    nonvariant_count = 0
    for s in states:
        if s.has_path():
            finder = LocusFinder(s, idx)
            key = frozenset(finder.base_sites)
            entry = usps.setdefault(key, ([], set()))
            entry[0].append(s)
            entry[1].update(finder.unique_loci)
        else:
            nonvariant_count += s.hi - s.lo + 1

    if not usps:
        return SelectedMapping()

    total = nonvariant_count + len(usps)
    if first_raw is not None:
        from ..common.rng import generate_fast
        selected = generate_fast(selection_seed, first_raw, 1, total)
    else:
        selected = RandomInclusiveInt(selection_seed).generate(1, total)
    if selected <= nonvariant_count:
        return SelectedMapping()  # non-variant path: nothing recorded
    index = selected - nonvariant_count - 1
    # C++ std::map orders keys (std::set<Marker>) lexicographically
    ordered_keys = sorted(usps.keys(), key=lambda k: tuple(sorted(k)))
    chosen = usps[ordered_keys[index]]
    return SelectedMapping(states=chosen[0], loci=chosen[1])


# --- per-base recording (allele_base.cpp:109-296) ---------------------------


class Traverser:
    """Walks the graph from a mapping start point, consuming read bases
    (allele_base.cpp:137-219)."""

    def __init__(self, idx: PrgIndex, node_idx: int, offset: int,
                 traversed: Tuple[Locus, ...], read_size: int):
        self.g = idx.graph
        self.cur = node_idx
        self.start_pos = offset
        self.end_pos = 0
        self.traversed = traversed
        self.traversed_index = len(traversed)
        self.bases_remaining = read_size
        self.first = True

    def node(self):
        return self.g.node(self.cur)

    def next_node(self):
        if self.first:
            self.first = False
            self._update_coordinates()
            if not self.node().in_bubble():
                self._go_to_next_site()
            return self.cur if self.cur >= 0 else None
        if self.bases_remaining == 0:
            return None
        self._go_to_next_site()
        return self.cur if self.cur >= 0 else None

    def coordinates(self):
        return self.start_pos, self.end_pos

    def _go_to_next_site(self):
        self.start_pos = 0
        while len(self.node().edges) == 1:
            if self.bases_remaining <= 0:
                self.cur = -1
                return
            self.cur = self.node().edges[0]
            self._update_coordinates()
            if self.node().in_bubble():
                return  # avoids skipping nested-site exits
        self.traversed_index -= 1
        self._choose_allele()
        self._update_coordinates()

    def _choose_allele(self):
        site_id, allele_id = self.traversed[self.traversed_index]
        nxt = self.node().edges[allele_id]
        self.cur = nxt

    def _update_coordinates(self):
        node = self.node()
        self.end_pos = 0
        if node.seq_size > 0:
            self.end_pos = min(node.seq_size - 1,
                               self.start_pos + self.bases_remaining - 1)
            self.bases_remaining -= self.end_pos - self.start_pos + 1


def record_per_base(idx: PrgIndex, states: List[SearchState], read_size: int):
    """PbCovRecorder (allele_base.cpp:221-296): union of covered base
    ranges per node, then one saturating increment."""
    g = idx.graph
    ranges: Dict[int, Tuple[int, int]] = {}  # node -> (start, end) union

    def process_node(node_idx: int, start: int, end: int):
        if g.node(node_idx).seq_size == 0:
            return
        if node_idx in ranges:
            s0, e0 = ranges[node_idx]
            node_size = g.node(node_idx).seq_size
            if e0 - s0 != node_size - 1:  # not already full
                ranges[node_idx] = (min(s0, start), max(e0, end))
        else:
            ranges[node_idx] = (start, end)

    for ss in states:
        first = True
        for occurrence in range(ss.lo, ss.hi + 1):
            coordinate = int(idx.fm.sa[occurrence])
            t = Traverser(idx, int(g.ra_node[coordinate]),
                          int(g.ra_offset[coordinate]), ss.traversed, read_size)
            if first:
                first = False
                cur = t.next_node()
                while cur is not None:
                    s, e = t.coordinates()
                    process_node(cur, s, e)
                    cur = t.next_node()
            else:
                cur = t.next_node()
                if cur is not None:
                    s, e = t.coordinates()
                    process_node(cur, s, e)

    for node_idx, (start, end) in ranges.items():
        node = g.node(node_idx)
        if node.cov_start < 0:
            continue  # node outside any bubble: no coverage recorded
        sl = g.coverage[node.cov_start + start : node.cov_start + end + 1]
        np.add(sl, 1, out=sl, where=sl != UINT16_MAX)


# --- allele-sum + grouped (allele_sum.cpp:31-43, grouped_allele_counts.cpp:17-49)


def record_allele_sum(coverage: Coverage, loci: Set[Locus]):
    for site, allele in loci:
        coverage.allele_sum[site_id_to_index(site)][allele] += 1


def record_grouped_counts(coverage: Coverage, loci: Set[Locus]):
    per_site: Dict[int, Set[int]] = {}
    for site, allele in loci:
        per_site.setdefault(site, set()).add(allele)
    for site, alleles in per_site.items():
        key = tuple(sorted(alleles))
        d = coverage.grouped_counts[site_id_to_index(site)]
        d[key] = d.get(key, 0) + 1


# --- top-level per-read recording (coverage_common.cpp:179-197) -------------


def record_search_states(coverage: Coverage, states: List[SearchState],
                         read_length: int, idx: PrgIndex, selection_seed: int,
                         first_raw: Optional[int] = None):
    selected = select_mapping_instance(states, idx, selection_seed, first_raw)
    if not selected.states:
        return
    record_per_base(idx, selected.states, read_length)
    record_allele_sum(coverage, selected.loci)
    record_grouped_counts(coverage, selected.loci)


# --- dumps (JSON formats of the reference) ----------------------------------


def allele_base_non_nested(idx: PrgIndex) -> list:
    """Per-base coverage export, non-nested PRGs only
    (allele_base.cpp:10-38): empty list for nested graphs."""
    g = idx.graph
    if g.is_nested:
        return []
    out = [None] * g.num_sites
    for entry, _ in g.bubbles:
        site_index = site_id_to_index(g.node(entry).site_id)
        site_cov = []
        for allele_node in g.node(entry).edges:
            node = g.node(allele_node)
            if node.is_bubble_end() or not node.in_bubble():
                site_cov.append([])  # direct deletion allele
            else:
                site_cov.append([int(c) for c in g.node_coverage(allele_node)])
        out[site_index] = site_cov
    return out


def dump_all(coverage: Coverage, idx: PrgIndex, allele_sum_path, allele_base_path,
             grouped_path):
    with open(allele_sum_path, "w") as fh:
        for site in coverage.allele_sum:
            fh.write(" ".join(str(c) for c in site) + "\n")

    with open(allele_base_path, "w") as fh:
        json.dump({"allele_base_counts": allele_base_non_nested(idx)}, fh,
                  separators=(",", ":"))
        fh.write("\n")

    # group-ID assignment (grouped_allele_counts.cpp:51-67): the
    # reference numbers groups in hash-map iteration order, which is
    # arbitrary; here ids are assigned in SORTED group order so the
    # artifact is identical however recording interleaved device-folded
    # and host-fallback reads (docs/PARITY.md)
    all_groups = sorted({group for site in coverage.grouped_counts
                         for group in site})
    group_ids: Dict[Tuple[int, ...], int] = {
        g: i for i, g in enumerate(all_groups)}
    site_counts = [
        {str(group_ids[g]): c
         for g, c in sorted(site.items(), key=lambda kv: group_ids[kv[0]])}
        for site in coverage.grouped_counts
    ]
    allele_groups = {str(gid): list(group) for group, gid in group_ids.items()}
    with open(grouped_path, "w") as fh:
        json.dump(
            {"grouped_allele_counts": {
                "site_counts": site_counts,
                "allele_groups": allele_groups,
            }}, fh, separators=(",", ":"))
        fh.write("\n")
