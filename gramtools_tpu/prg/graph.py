"""Coverage graph: the PRG as a DAG with per-base coverage slots.

Re-designed from libgramtools' pointer graph (src/prg/coverage_graph.cpp)
as an index-based structure-of-arrays:

  * ``nodes``: a list of `CovNode` (sequence run, pos, site/allele IDs,
    edge index list, coverage array slice bounds)
  * one flat ``coverage`` uint16 array spanning all in-bubble bases --
    coverage recording becomes a segment-sum over flat indices, which is
    what the device reduction path consumes (no atomics)
  * ``bubbles``: (entry_node, exit_node) pairs ordered child-first
    (comparator parity: coverage_graph.cpp:381-389)
  * ``par_map``: site -> (parent site, parent haplogroup)
    (coverage_graph.cpp:195)
  * ``child_map``: inverse of par_map (make_data_structures.cpp:53-68)
  * ``target_map``: marker -> [(marker, direct_deletion_allele)] jump
    chains (coverage_graph.cpp:268-378)
  * ``random_access``: per PRG position -> (node index, offset within
    node) and the jump target locus (site/allele) of the marker
    preceding that position (coverage_graph.cpp:131-144, 268-311)

The builder walks marker *segments* (runs of sequence between markers)
instead of single characters, so graph construction is O(#markers) in
Python with numpy handling the sequence runs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..common.seq import decode_dna
from .linearise import PrgString
from .markers import ALLELE_UNKNOWN, FIRST_ALLELE

# marker_type enum parity (coverage_graph.hpp:125)
SEQ, SITE_ENTRY, ALLELE_END, SITE_END = 0, 1, 2, 3


@dataclass
class CovNode:
    """One graph node: a maximal sequence run or a site boundary."""

    idx: int
    pos: int
    site_id: int = 0
    allele_id: int = ALLELE_UNKNOWN
    is_boundary: bool = False
    seq: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=np.uint8))
    edges: List[int] = field(default_factory=list)
    cov_start: int = -1  # slice into the graph-wide flat coverage array
    # (cov_start + len(seq) = cov_end) only when in_bubble

    @property
    def seq_size(self) -> int:
        return int(self.seq.size)

    def has_sequence(self) -> bool:
        return self.seq.size > 0

    def in_bubble(self) -> bool:
        return self.allele_id != ALLELE_UNKNOWN and self.site_id != 0

    def is_bubble_start(self) -> bool:
        return len(self.edges) > 1 and self.seq.size == 0

    def is_bubble_end(self) -> bool:
        return len(self.edges) == 1 and self.seq.size == 0

    def seq_str(self) -> str:
        return decode_dna(self.seq)


class CoverageGraph:
    """DAG over `CovNode`s plus the auxiliary maps used by mapping/genotyping."""

    def __init__(self):
        self.nodes: List[CovNode] = []
        self.root: int = -1
        self.sink: int = -1
        self.bubbles: List[Tuple[int, int]] = []  # (entry, exit) child-first order
        self.par_map: Dict[int, Tuple[int, int]] = {}
        self.target_map: Dict[int, List[Tuple[int, int]]] = {}
        # random access (per PRG position)
        self.ra_node: np.ndarray = np.empty(0, dtype=np.int32)
        self.ra_offset: np.ndarray = np.empty(0, dtype=np.int32)
        self.ra_target_site: np.ndarray = np.empty(0, dtype=np.int32)
        self.ra_target_allele: np.ndarray = np.empty(0, dtype=np.int32)
        # flat per-base coverage over all in-bubble nodes
        self.coverage: np.ndarray = np.empty(0, dtype=np.uint16)
        self.is_nested: bool = False

    # -- convenience ---------------------------------------------------------

    @property
    def num_sites(self) -> int:
        return len(self.bubbles)

    def node(self, idx: int) -> CovNode:
        return self.nodes[idx]

    def child_map(self) -> Dict[int, Dict[int, List[int]]]:
        """site -> haplogroup -> [child sites] (make_data_structures.cpp:53-68).

        Iteration order of par_map entries follows insertion order
        (= site-entry order in the PRG), which is deterministic.
        """
        result: Dict[int, Dict[int, List[int]]] = {}
        for child, (parent, haplo) in self.par_map.items():
            result.setdefault(parent, {}).setdefault(haplo, []).append(child)
        return result

    def node_coverage(self, node_idx: int) -> np.ndarray:
        n = self.nodes[node_idx]
        if not n.in_bubble() or n.cov_start < 0:
            return np.empty(0, dtype=np.uint16)
        return self.coverage[n.cov_start : n.cov_start + n.seq_size]

    def node_tables(self) -> "NodeTables":
        """Flat numpy views of the node list for vectorised graph walks
        (built lazily, cached)."""
        if getattr(self, "_node_tables", None) is None:
            self._node_tables = NodeTables(self)
        return self._node_tables


class NodeTables:
    """Structure-of-arrays projection of CovNode fields + CSR edges."""

    def __init__(self, g: "CoverageGraph"):
        n = len(g.nodes)
        self.seq_len = np.array([nd.seq_size for nd in g.nodes], dtype=np.int32)
        self.cov_start = np.array([nd.cov_start for nd in g.nodes],
                                  dtype=np.int64)
        self.n_edges = np.array([len(nd.edges) for nd in g.nodes],
                                dtype=np.int32)
        self.edge_offset = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(self.n_edges, out=self.edge_offset[1:])
        self.edges = np.fromiter(
            (e for nd in g.nodes for e in nd.edges),
            dtype=np.int32, count=int(self.edge_offset[-1]))
        in_bubble = np.array([nd.in_bubble() for nd in g.nodes], dtype=bool)
        self.in_bubble = in_bubble
        self.site_id = np.array([nd.site_id for nd in g.nodes], dtype=np.int32)
        self.allele_id = np.array([nd.allele_id for nd in g.nodes],
                                  dtype=np.int32)


class _GraphBuilder:
    """Single pass over the linear PRG, marker-segment at a time.

    State machine parity: cov_Graph_Builder (coverage_graph.cpp:82-266).
    """

    def __init__(self, prg: PrgString):
        self.prg = prg.ints
        self.end_positions = prg.end_positions
        self.g = CoverageGraph()
        self._bubble_starts: Dict[int, int] = {}
        self._bubble_ends: Dict[int, int] = {}
        self._bubble_insert: List[Tuple[int, int]] = []
        self.build()

    # node helpers -----------------------------------------------------------

    def _new_node(self, pos, site_id=0, allele_id=ALLELE_UNKNOWN) -> int:
        idx = len(self.g.nodes)
        self.g.nodes.append(CovNode(idx=idx, pos=pos, site_id=site_id, allele_id=allele_id))
        return idx

    def _marker_types(self) -> np.ndarray:
        prg = self.prg
        types = np.zeros(prg.size, dtype=np.int8)  # SEQ
        markers = prg > 4
        odd = markers & (prg % 2 == 1)
        types[odd] = SITE_ENTRY
        even_pos = np.flatnonzero(markers & ~odd)
        for p in even_pos:
            m = int(prg[p])
            types[p] = SITE_END if self.end_positions[m] == p else ALLELE_END
        return types

    def build(self):
        g = self.g
        prg = self.prg
        n = prg.size
        types = self._marker_types()
        marker_positions = np.flatnonzero(types != SEQ)

        g.ra_node = np.full(n, -1, dtype=np.int32)
        g.ra_offset = np.zeros(n, dtype=np.int32)
        g.ra_target_site = np.zeros(n, dtype=np.int32)
        g.ra_target_allele = np.full(n, ALLELE_UNKNOWN, dtype=np.int32)

        # --- root (coverage_graph.cpp:97-103)
        root = self._new_node(pos=-1)
        g.root = root
        back_wire = root
        cur_pos = 0
        cur_node = self._new_node(pos=0)
        cur_locus: Tuple[int, int] = (0, ALLELE_UNKNOWN)
        first_allele = False

        def wire(target: int):
            # coverage_graph.cpp:260-266
            nonlocal back_wire, cur_node
            if g.nodes[cur_node].has_sequence():
                g.nodes[back_wire].edges.append(cur_node)
                g.nodes[cur_node].edges.append(target)
            else:
                g.nodes[back_wire].edges.append(target)

        def add_segment(lo: int, hi: int):
            # All sequence chars in prg[lo:hi] extend cur_node.
            nonlocal cur_pos
            if hi <= lo:
                return
            node = g.nodes[cur_node]
            seg = prg[lo:hi].astype(np.uint8)
            base_off = node.seq_size
            node.seq = np.concatenate([node.seq, seg]) if node.seq.size else seg
            # random access for these positions
            g.ra_node[lo:hi] = cur_node
            g.ra_offset[lo:hi] = base_off + np.arange(hi - lo, dtype=np.int32)
            cur_pos += hi - lo

        def reach_allele_end(m: int) -> int:
            # coverage_graph.cpp:238-258
            nonlocal first_allele
            site_id = m - 1
            assert cur_locus[0] == site_id, "allele end for unexpected site"
            site_exit = self._bubble_ends[site_id]
            wire(site_exit)
            if first_allele:
                g.nodes[site_exit].pos = cur_pos
                first_allele = False
            return site_exit

        seg_start = 0
        for pos in marker_positions:
            pos = int(pos)
            add_segment(seg_start, pos)
            seg_start = pos + 1
            m = int(prg[pos])
            t = int(types[pos])

            if t == SITE_ENTRY:
                # coverage_graph.cpp:174-197
                site_entry = self._new_node(cur_pos, m, ALLELE_UNKNOWN)
                g.nodes[site_entry].is_boundary = True
                wire(site_entry)
                cur_node = self._new_node(cur_pos, m, FIRST_ALLELE)
                first_allele = True
                back_wire = site_entry
                site_exit = self._new_node(cur_pos, m, ALLELE_UNKNOWN)
                g.nodes[site_exit].is_boundary = True
                self._bubble_insert.append((site_entry, site_exit))
                self._bubble_starts[m] = site_entry
                self._bubble_ends[m] = site_exit
                if cur_locus[0] != 0:
                    g.par_map[m] = cur_locus
                cur_locus = (m, FIRST_ALLELE)
            elif t == ALLELE_END:
                # coverage_graph.cpp:199-213
                site_id = m - 1
                reach_allele_end(m)
                allele_id = cur_locus[1] + 1
                cur_locus = (site_id, allele_id)
                site_entry = self._bubble_starts[site_id]
                back_wire = site_entry
                cur_pos = g.nodes[site_entry].pos
                cur_node = self._new_node(cur_pos, site_id, allele_id)
            else:  # SITE_END (coverage_graph.cpp:215-236)
                site_id = m - 1
                site_exit = reach_allele_end(m)
                if cur_locus[1] == FIRST_ALLELE:
                    raise ValueError(f"Site numbered {m} has only one allele")
                if site_id in g.par_map:
                    cur_locus = g.par_map[site_id]
                    if cur_locus[1] == FIRST_ALLELE:
                        first_allele = True
                else:
                    cur_locus = (0, ALLELE_UNKNOWN)
                back_wire = site_exit
                cur_pos = g.nodes[site_exit].pos
                cur_node = self._new_node(cur_pos, cur_locus[0], cur_locus[1])

            # random access for the marker position itself: points at
            # back_wire (boundary node) -- coverage_graph.cpp:131-144
            g.ra_node[pos] = back_wire
            g.ra_offset[pos] = max(g.nodes[back_wire].seq_size - 1, 0)

        add_segment(seg_start, n)

        # --- sink (coverage_graph.cpp:105-110)
        sink = self._new_node(cur_pos + 1)
        wire(sink)
        g.sink = sink

        self._finalise_bubbles()
        self._map_targets(types)
        self._allocate_coverage()
        g.is_nested = len(g.par_map) > 0

    def _finalise_bubbles(self):
        # bubble order: highest pos first; ties -> higher site ID first
        # (child bubble precedence) -- comparator coverage_graph.cpp:381-389.
        g = self.g
        order = sorted(
            self._bubble_insert,
            key=lambda pair: (-g.nodes[pair[0]].pos, -g.nodes[pair[0]].site_id),
        )
        g.bubbles = order

    def _map_targets(self, types: np.ndarray):
        """Adjacent-marker jump targets (coverage_graph.cpp:268-378)."""
        g = self.g
        prg = self.prg
        prev_t, prev_m = SEQ, 0
        cur_allele_id = ALLELE_UNKNOWN

        def add_exit_target(cur_m: int, tm: Tuple[int, int]):
            g.target_map.setdefault(cur_m, []).append(tm)

        for pos in range(prg.size):
            cur_m = int(prg[pos])
            cur_t = int(types[pos])
            if cur_t == SEQ:
                if prev_t != SEQ:
                    g.ra_target_site[pos] = prev_m
                    g.ra_target_allele[pos] = cur_allele_id
            elif cur_t == SITE_ENTRY:
                cur_allele_id = FIRST_ALLELE
                if prev_t != SEQ:
                    # make_site_entry_target (coverage_graph.cpp:313-328)
                    target = prev_m - 1 if prev_t == ALLELE_END else prev_m
                    g.target_map[cur_m] = [(target, ALLELE_UNKNOWN)]
            elif cur_t == SITE_END:
                if prev_t != SEQ:
                    # make_site_exit_target (coverage_graph.cpp:330-350)
                    if prev_t == SITE_ENTRY:
                        raise ValueError(
                            f"PRG consistency error: site number {cur_m} is empty"
                        )
                    if prev_t == SITE_END:
                        add_exit_target(cur_m, (prev_m, ALLELE_UNKNOWN))
                    else:  # ALLELE_END: direct deletion
                        add_exit_target(cur_m, (prev_m - 1, cur_allele_id))
                site_id = cur_m - 1
                cur_allele_id = (
                    g.par_map[site_id][1] if site_id in g.par_map else ALLELE_UNKNOWN
                )
            else:  # ALLELE_END
                if prev_t != SEQ:
                    # make_allele_end_target (coverage_graph.cpp:352-370)
                    if prev_t == SITE_ENTRY:
                        add_exit_target(cur_m, (prev_m, cur_allele_id))
                    elif prev_t == SITE_END:
                        add_exit_target(cur_m, (prev_m, ALLELE_UNKNOWN))
                    else:
                        add_exit_target(cur_m, (prev_m - 1, cur_allele_id))
                cur_allele_id += 1
            prev_m, prev_t = cur_m, cur_t

    def _allocate_coverage(self):
        g = self.g
        total = 0
        for node in g.nodes:
            if node.in_bubble() and node.has_sequence():
                node.cov_start = total
                total += node.seq_size
        g.coverage = np.zeros(total, dtype=np.uint16)


def build_cov_graph(prg: PrgString) -> CoverageGraph:
    return _GraphBuilder(prg).g
