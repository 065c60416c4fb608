"""How the MLA decode kernel cuts its work (``csrc/mla_decode_attention.cu``),
as plain functions: the kernel computes the same cut on the device from
``cache_len``, so the host never reads it; the CPU tests and the plain
split-and-merge emulation (``ref.mla_decode_attention_pieces``) call these.

Row ``b`` attends to ``n_b = min(cache_len[b], S - 1) + 1`` positions,
``ceil(n_b / TILE)`` tiles; a negative ``cache_len[b]`` is an empty row
(``n_b = 0``, no tile), as a rank's block of a cache sharded on its
sequence may be. The tiles of the whole batch, row
after row, are cut into ``n_pieces`` pieces at ``floor(p * T / n_pieces)``
(``T`` tiles in all), so no piece is more than one tile longer than
another. A piece may span rows: each (piece, row) overlap is a segment,
whose partial (m, l, acc) goes to slot ``piece + row`` -- unique, since
both indices grow along the sequence -- of ``n_pieces + B - 1`` slots.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence

TILE = 32               # cache positions per tile (kTile in the source)
HEADS_PER_BLOCK = 32    # heads a block takes (kHeads in the source)
MAX_PIECES = 1024       # kMaxPieces in the source


class Segment(NamedTuple):
    piece: int
    row: int
    start: int          # first position of the row in the segment
    end: int            # one past its last position
    slot: int           # piece + row: where its partial goes


def valid_len(cache_len: int, s: int) -> int:
    """Positions row attends to: 0..min(cache_len, S-1), none for a
    negative cache_len."""
    return 0 if cache_len < 0 else min(int(cache_len), s - 1) + 1


def tile_starts(cache_len: Sequence[int], s: int) -> List[int]:
    """Prefix sums of the rows' tile counts: row b's tiles are
    ``starts[b]..starts[b+1]-1`` of the batch's sequence."""
    starts = [0]
    for c in cache_len:
        starts.append(starts[-1] + math.ceil(valid_len(c, s) / TILE))
    return starts


def piece_start(p: int, total: int, n_pieces: int) -> int:
    return p * total // n_pieces


def piece_of(tile: int, total: int, n_pieces: int) -> int:
    """The piece that holds ``tile``: the largest p with
    ``piece_start(p) <= tile``."""
    return ((tile + 1) * n_pieces - 1) // total


def segments(cache_len: Sequence[int], s: int, n_pieces: int
             ) -> List[Segment]:
    """Every (piece, row) segment of the cut, in the order of the
    sequence. Pieces with no tile (more pieces than tiles) own none."""
    starts = tile_starts(cache_len, s)
    total = starts[-1]
    out = []
    for p in range(n_pieces):
        c0, c1 = piece_start(p, total, n_pieces), piece_start(p + 1, total,
                                                              n_pieces)
        for b in range(len(cache_len)):
            lo, hi = max(c0, starts[b]), min(c1, starts[b + 1])
            if lo < hi:
                n = valid_len(cache_len[b], s)
                t0 = (lo - starts[b]) * TILE
                out.append(Segment(p, b, t0, min(n, (hi - starts[b]) * TILE),
                                   p + b))
    return out


def row_pieces(starts: Sequence[int], b: int, n_pieces: int) -> range:
    """The pieces the merge pass reads for row ``b``: from the one that
    holds the row's first tile to the one that holds its last. Empty pieces
    inside that range wrote nothing and weigh 0."""
    total = starts[-1]
    return range(piece_of(starts[b], total, n_pieces),
                 piece_of(starts[b + 1] - 1, total, n_pieces) + 1)


def n_pieces_for(b: int, h: int, s: int, n_sm: int) -> int:
    """Pieces per launch, from shapes alone: one wave, a block per SM (a
    block's shared memory allows one), so ``n_sm`` blocks over the
    ``ceil(h / HEADS_PER_BLOCK)`` head groups of each piece; no more pieces
    than the most tiles the batch can hold; at most ``MAX_PIECES``."""
    groups = math.ceil(h / HEADS_PER_BLOCK)
    want = max(1, n_sm // groups)
    return max(1, min(MAX_PIECES, want, b * math.ceil(s / TILE)))


def partial_bytes(b: int, h: int, r: int, n_pieces: int) -> int:
    """Bytes of the partial (m, l, acc) buffers: ``n_pieces + b - 1``
    slots of (h, r) f32 accumulators and (h, 2) f32 (m, l)."""
    return 4 * (n_pieces + b - 1) * h * (r + 2)
