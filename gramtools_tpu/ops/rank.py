"""Bit-packed BWT rank: popcount over interleaved blocks.

A compact replacement for the dense occ prefix table (index/fm.py) on
the hot LF-mapping gather, and the equivalent of the reference's
bit-packed rank_v bitmasks (libgramtools/src/prg/make_data_structures.cpp:113-163).

Layout -- one uint32[24] record (96 bytes) per 128 BWT symbols:

  words[0:4]   Occ checkpoint: #A,#C,#G,#T in bwt[0 : 128*blk]
  word[4]      marker checkpoint: #markers in bwt[0 : 128*blk]
  words[5:8]   reserved (0)
  words[8:24]  128 4-bit symbol codes, nibble j of word 8+w = code of
               bwt[128*blk + 8*w + j]; code 0 = sentinel/pad, 1-4 = DNA,
               5 = marker

rank(c, i) = ckpt[c] + popcount(nibble_eq(codes, c) & prefix_mask(i%128))

Why interleaved: a rank query needs the checkpoint AND the codes of one
block; packing them into a single 96-byte record means ONE gathered row
per query returns all four DNA ranks plus the marker rank -- the dense
table's row gather is also one row but stores 16 bytes/position, vs
0.75 bytes/position here (21x), which is what makes graphs larger than
one device's memory shardable (parallel/sharded_index.py).

The query is an XLA gather of the records followed by per-row XOR, mask
and popcount (``_count_channels_jnp``), which XLA fuses into one loop
on the GPU; a numpy twin is the test oracle.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

BLOCK = 128            # symbols per block
WORDS = 24             # uint32 words per record
CODE_WORDS = 16        # words[8:24] hold the 4-bit codes
MARKER_CODE = 5

_REP = np.uint32(0x11111111)   # one bit per nibble


# --------------------------------------------------------------------------
# construction
# --------------------------------------------------------------------------

def build_packed_occ(fm) -> np.ndarray:
    """Packs an index.fm.FMIndex's BWT into (nblocks, 24) uint32 records.

    nblocks = floor(n / 128) + 1 so a query at i = n (prefix of the whole
    BWT) still has a record; pad symbols get code 0 and count as nothing.
    """
    bwt = np.asarray(fm.bwt, dtype=np.int64)
    n = bwt.size
    nblocks = n // BLOCK + 1
    codes = np.zeros(nblocks * BLOCK, dtype=np.uint32)
    codes[:n] = np.where(bwt == 0, 0, np.where(bwt <= 4, bwt, MARKER_CODE))

    blocks = np.zeros((nblocks, WORDS), dtype=np.uint32)
    # checkpoints: counts before each block start
    for c in range(1, 5):
        hits = np.zeros(nblocks, dtype=np.uint32)
        np.add.at(hits, np.flatnonzero(bwt == c) // BLOCK, 1)
        blocks[1:, c - 1] = np.cumsum(hits)[:-1]
    mhits = np.zeros(nblocks, dtype=np.uint32)
    np.add.at(mhits, np.flatnonzero(bwt > 4) // BLOCK, 1)
    blocks[1:, 4] = np.cumsum(mhits)[:-1]
    # 4-bit code words
    nib = codes.reshape(nblocks, CODE_WORDS, 8)
    shifts = (4 * np.arange(8, dtype=np.uint32))[None, None, :]
    blocks[:, 8:] = (nib << shifts).sum(axis=2, dtype=np.uint32)
    return blocks


# --------------------------------------------------------------------------
# query twins: numpy oracle, jnp
# --------------------------------------------------------------------------

def _count_channels_np(rec: np.ndarray, off: np.ndarray) -> np.ndarray:
    """(N, 24) records + (N,) in-block offsets -> (N, 4) DNA ranks."""
    words = rec[:, 8:]                                   # (N, 16)
    j = np.arange(CODE_WORDS, dtype=np.int64)
    t = np.clip(off[:, None] - 8 * j, 0, 8)              # nibbles in prefix
    pmask = np.where(t >= 8, np.uint32(0xFFFFFFFF),
                     (np.uint32(1) << (4 * np.minimum(t, 7)).astype(np.uint32))
                     - 1)
    out = np.empty((rec.shape[0], 4), dtype=np.int32)
    for c in range(1, 5):
        x = words ^ (np.uint32(c) * _REP)
        y = ~x
        m = y & (y >> 1) & (y >> 2) & (y >> 3) & _REP
        cnt = _popcount_np(m & pmask).sum(axis=1)
        out[:, c - 1] = rec[:, c - 1].astype(np.int32) + cnt.astype(np.int32)
    return out


def _popcount_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x = x - ((x >> 1) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> 2) & np.uint32(0x33333333))
    x = (x + (x >> 4)) & np.uint32(0x0F0F0F0F)
    return (x * np.uint32(0x01010101)) >> 24


def packed_occ_rows_np(blocks: np.ndarray, rows: np.ndarray,
                       size: int) -> np.ndarray:
    """Numpy oracle: rank of the four DNA bases at each row (prefix
    length), bit-equal to fm.occ.T[rows]."""
    rows = np.clip(np.asarray(rows, dtype=np.int64), 0, size)
    rec = blocks[rows // BLOCK]
    return _count_channels_np(rec, rows % BLOCK)


def _count_channels_jnp(rec, off):
    words = rec[..., 8:]                                  # (..., 16)
    j = jnp.arange(CODE_WORDS, dtype=jnp.int32)
    t = jnp.clip(off[..., None] - 8 * j, 0, 8)
    pmask = jnp.where(t >= 8, jnp.uint32(0xFFFFFFFF),
                      (jnp.uint32(1)
                       << (4 * jnp.minimum(t, 7)).astype(jnp.uint32))
                      - jnp.uint32(1))
    rep = jnp.uint32(0x11111111)
    outs = []
    for c in range(1, 5):
        x = words ^ (jnp.uint32(c) * rep)
        y = ~x
        m = y & (y >> 1) & (y >> 2) & (y >> 3) & rep
        cnt = jnp.sum(jax.lax.population_count(m & pmask), axis=-1)
        outs.append(rec[..., c - 1].astype(jnp.int32) + cnt.astype(jnp.int32))
    return jnp.stack(outs, axis=-1)


def make_packed_occ_rows(blocks, size: int):
    """Returns occ_rows(rows) -> (..., 4) int32, a drop-in for the dense
    di.occ gather in search_jax_log._build_log_step.

    blocks: (nblocks, 24) uint32 device array. rows: any shape; values
    are clipped to [0, size] (size = the BWT length, the prefix of the
    whole BWT)."""

    def occ_rows(rows):
        shape = rows.shape
        r = jnp.clip(rows.reshape(-1), 0, size)
        rec = blocks[(r // BLOCK).astype(jnp.int32)]       # XLA gather
        off = (r % BLOCK).astype(jnp.int32)
        return _count_channels_jnp(rec, off).reshape(shape + (4,))

    return occ_rows
