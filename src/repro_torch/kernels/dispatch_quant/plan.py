"""How the dispatch-quantize kernel (``csrc/dispatch_quant.cu``) is
launched, as a plain function of the shapes and addresses: the wrapper
calls :func:`launch_plan` before every launch and passes the plan to the
kernel, and the CPU tests read it without a card.

Three ways, by T (rows) against the card's SM count and by alignment:

- ``split``: T at most half the SMs. Each row is cut over a cluster of
  ``cluster`` blocks (a power of two, at most MAX_CLUSTER and n_sm // T,
  no more than the row has 16-byte groups): each block reduces its slice,
  the maxima meet through distributed shared memory, and each block
  quantizes its own slice. ``vec``: 16-byte loads (every row 16-byte
  aligned) and 4-byte code stores; otherwise one element a thread at a
  time.
- ``ring``: otherwise, where every row is 16-byte aligned with a whole
  number of 16-byte units, the codes' rows 4-byte aligned, and two rows fit
  in a block's shared memory. A persistent grid of blocks of ``warps``
  warps, four an SM (three for f32); a block takes its rows in turn, all
  its threads on one row, and keeps the next ``stages`` - 1 of them in
  flight in a ring of whole rows in shared memory, filled by TMA bulk
  copies.
- ``rows``: otherwise (an odd width, a misaligned pointer, rows too long
  for two stages). The same loop over rows without the ring, with plain
  element loads: the reduction reads the row from device memory and the
  quantization reads it again (from L2). Any D.
"""
from __future__ import annotations

from typing import NamedTuple

SMEM_LIMIT = 232_448          # shared memory one block may use
STATIC_SMEM = 64              # kStaticSmem: the ring kernel's own
SMEM_PER_SM = 233_472         # the SM's, of which each block reserves 1 KB
BAR_BYTES = 8                 # one mbarrier a ring stage
WARPS = 8                     # kMaxThreads / 32 in the source
# Ring: two rows a block (the one in hand and the next). More independent
# rows on an SM beat deeper rings in fewer blocks (measured on an H100,
# PERF.md).
STAGES = 2
# Blocks an SM for the ring and rows paths by the input's bytes a value
# (kRingBlocks in the source, whose launch bounds cap registers to fit).
BLOCKS_PER_SM = {2: 4, 4: 3}
# Blocks a row at most (kMaxCluster): a portable cluster. 16, a
# non-portable size, read no faster at T = 1 or 8 (measured on an H100,
# PERF.md).
MAX_CLUSTER = 8
SPLIT_WARPS = 4               # kSplitThreads / 32


class Plan(NamedTuple):
    kind: str          # "none", "split", "ring" or "rows"
    grid: int          # blocks
    warps: int         # warps a block
    stages: int        # rows of the ring a block (ring)
    cluster: int       # blocks a row (split)
    slice: int         # elements a block of a cluster takes (split)
    vec: bool          # 16-byte loads (split; ring always, rows never)
    smem: int          # dynamic shared memory bytes a block


def aligned(t: int, d: int, in_bytes: int, x_addr: int, q_addr: int,
            q_stride: int) -> bool:
    """Every row of x starts 16-byte aligned and has a whole number of
    16-byte units, and every row of codes starts 4-byte aligned."""
    return (x_addr % 16 == 0 and (d * in_bytes) % 16 == 0
            and q_addr % 4 == 0 and q_stride % 4 == 0)


def _pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def launch_plan(t: int, d: int, in_bytes: int, x_addr: int, q_addr: int,
                q_stride: int, n_sm: int) -> Plan:
    """The launch of a (t, d) input of ``in_bytes`` a value at ``x_addr``
    into rows of ``q_stride`` code bytes at ``q_addr``, on ``n_sm`` SMs."""
    if t == 0:
        return Plan("none", 0, 0, 0, 0, 0, False, 0)
    vec = aligned(t, d, in_bytes, x_addr, q_addr, q_stride)
    if 2 * t <= n_sm:
        unit = 16 // in_bytes if vec else 1           # elements a group
        groups = -(-d // unit)
        cluster = _pow2_floor(min(MAX_CLUSTER, n_sm // t, groups))
        piece = -(-groups // cluster) * unit
        return Plan("split", t * cluster, SPLIT_WARPS, 0, cluster, piece,
                    vec, 0)
    row = d * in_bytes + BAR_BYTES
    fit = (SMEM_LIMIT - STATIC_SMEM) // row
    if vec and fit >= STAGES:
        smem = STAGES * row
        per_sm = min(BLOCKS_PER_SM[in_bytes],
                     SMEM_PER_SM // (smem + STATIC_SMEM + 1024))
        return Plan("ring", min(n_sm * per_sm, t), WARPS, STAGES, 1, 0,
                    True, smem)
    return Plan("rows", min(n_sm * BLOCKS_PER_SM[in_bytes], t), WARPS, 0,
                1, 0, False, 0)

