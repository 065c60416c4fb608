"""The port's absorbed-MLA decode attention (plain PyTorch path, as the
wrapper runs it for a CPU tensor) against the JAX oracle ``ref.py`` and the
JAX Pallas kernel in interpret mode, on the same seeded numpy inputs.

Tolerance: rtol = atol = 3e-5, the repository's kernel-test tolerance
(float32 on both sides, a different summation order). The CUDA kernel
itself is held against the same plain version on the card by
``chip_smoke.py``; here its cut (``plan.py``), its split and merge and its
3xTF32 products are held, through plain emulations, against the plain
version and the JAX oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mla_attention.ops import mla_decode_attention as jax_kernel
from repro.kernels.mla_attention.ref import mla_decode_attention_ref as jax_ref
from repro_torch.kernels.mla_attention import ops, plan
from repro_torch.kernels.mla_attention.ref import (
    mla_decode_attention_3xtf32, mla_decode_attention_pieces,
    mla_decode_attention_ref, split_tf32, tf32_operand)

TOL = 3e-5
SCALE = 0.125


def _inputs(b, h, r, dr, s, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, r).astype(np.float32),
            rng.randn(b, h, dr).astype(np.float32),
            rng.randn(b, s, r + dr).astype(np.float32))


def _port(ql, qr, cache, cache_len):
    return ops.mla_decode_attention(
        torch.from_numpy(ql), torch.from_numpy(qr), torch.from_numpy(cache),
        torch.from_numpy(np.asarray(cache_len, np.int32)), SCALE).numpy()


# The shapes of tests/test_kernels.py's MLA sweep.
@pytest.mark.parametrize("b,h,r,dr,s", [(1, 4, 32, 16, 64), (2, 8, 64, 16, 256),
                                        (2, 16, 128, 64, 128)])
@pytest.mark.parametrize("valid_len", [1, 37, None])
def test_plain_matches_jax_ref_and_interpret_kernel(b, h, r, dr, s, valid_len):
    ql, qr, cache = _inputs(b, h, r, dr, s, seed=b * s + h)
    vl = s if valid_len is None else min(valid_len, s)
    valid = jnp.arange(s) < vl
    # JAX's shared `valid` of vl positions is cache_len = vl - 1 per row
    # (the port's rows attend to positions 0..cache_len inclusive).
    got = _port(ql, qr, cache, [vl - 1] * b)
    want_ref = np.asarray(jax_ref(jnp.asarray(ql), jnp.asarray(qr),
                                  jnp.asarray(cache), valid, SCALE, r))
    want_kernel = np.asarray(jax_kernel(jnp.asarray(ql), jnp.asarray(qr),
                                        jnp.asarray(cache), valid, SCALE, r))
    np.testing.assert_allclose(got, want_ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_kernel, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s,lens", [(64, [0, 5, 63, 64]),
                                    (256, [255, 0, 128, 1]),
                                    (100, [99, 100, 37, 50])])
def test_ragged_per_row_cache_len(s, lens):
    """Per-row lengths (which the Pallas kernel cannot take) against the
    JAX oracle and interpret kernel run row by row; a row at cache_len == S
    (a capacity-frozen slot) attends to the whole cache."""
    b, h, r, dr = len(lens), 8, 64, 16
    ql, qr, cache = _inputs(b, h, r, dr, s, seed=s)
    got = _port(ql, qr, cache, lens)
    for i, cl in enumerate(lens):
        valid = jnp.arange(s) <= min(cl, s - 1)
        args = (jnp.asarray(ql[i:i + 1]), jnp.asarray(qr[i:i + 1]),
                jnp.asarray(cache[i:i + 1]), valid, SCALE, r)
        np.testing.assert_allclose(got[i:i + 1], np.asarray(jax_ref(*args)),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got[i:i + 1], np.asarray(jax_kernel(*args)),
                                   rtol=TOL, atol=TOL)


def test_cpu_tensor_takes_plain_path_without_launch():
    ql, qr, cache = _inputs(2, 16, 128, 64, 96, seed=3)
    before = ops.LAUNCHES
    got = _port(ql, qr, cache, [10, 95])
    assert ops.LAUNCHES == before
    want = mla_decode_attention_ref(
        torch.from_numpy(ql), torch.from_numpy(qr), torch.from_numpy(cache),
        torch.tensor([10, 95], dtype=torch.int32), SCALE).numpy()
    np.testing.assert_array_equal(got, want)


class _Elsewhere(torch.Tensor):
    """A tensor whose metadata says it lives on an XPU, a device that is
    neither the CPU, CUDA nor meta; ops run on its shape alone."""

    @staticmethod
    def __new__(cls, t):
        return torch.Tensor._make_wrapper_subclass(
            cls, t.shape, strides=t.stride(), dtype=t.dtype,
            device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        """Runs ``func`` on meta stand-ins: shapes and strides only."""
        from torch.utils._pytree import tree_map

        def meta(t):
            return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                       device="meta") \
                if isinstance(t, cls) else t

        out = func(*tree_map(meta, args), **tree_map(meta, kwargs or {}))
        return tree_map(lambda t: cls(t) if isinstance(t, torch.Tensor)
                        else t, out)


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "len_dtype",
                                 "len_shape", "width", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q_lat = torch.zeros(2, 16, 32)
    q_rope = torch.zeros(2, 16, 16)
    cache = torch.zeros(2, 8, 48)
    cache_len = torch.zeros(2, dtype=torch.int32)
    if bad == "dtype":
        q_lat = q_lat.double()
    elif bad == "contiguous":
        cache = torch.zeros(2, 48, 8).transpose(1, 2)
    elif bad == "len_dtype":
        cache_len = cache_len.long()
    elif bad == "len_shape":
        cache_len = torch.zeros(3, dtype=torch.int32)
    elif bad == "width":
        cache = torch.zeros(2, 8, 40)
    else:  # a device other than the CPU, CUDA and meta has no path
        q_lat, q_rope, cache, cache_len = (
            _Elsewhere(t) for t in (q_lat, q_rope, cache, cache_len))
    with pytest.raises(ValueError):
        ops.mla_decode_attention(q_lat, q_rope, cache, cache_len, SCALE)


# The kernel's cut (plan.py): (S, cache_len per row, n_pieces).
SERVE_LENS = [971, 846, 916, 479, 1050, 994, 646, 296]   # the R1 serve's last step
PLANS = [
    (2048, SERVE_LENS, 33),                    # the served batch, one wave
    (2048, [0, 2047, 2048, 1024, 1, 31, 32, 2015], 33),   # edges: 0, S-1, S
    (1000, [999, 1000, 0, 500, 37, 128, 129, 777], 33),   # S off the tile
    (2048, [10] + [2047] * 7, 33),             # one short row, seven long
    (2048, [0] * 8, 33),                       # more pieces than tiles
    (64, [63], 5),                             # one row of two tiles
    (100, [99, 0, 64], 1),                     # one piece spans every row
]


@pytest.mark.parametrize("s,lens,n_pieces", PLANS)
def test_split_count(s, lens, n_pieces):
    """Every valid position of every row lies in exactly one segment, no
    piece is more than one tile longer than another, and each segment's
    slot is its own."""
    segs = plan.segments(lens, s, n_pieces)
    for row, cl in enumerate(lens):
        n = min(max(cl, 0), s - 1) + 1
        covered = sorted(t for sg in segs if sg.row == row
                         for t in range(sg.start, sg.end))
        assert covered == list(range(n)), row
    starts = plan.tile_starts(lens, s)
    total = starts[-1]
    sizes = [plan.piece_start(p + 1, total, n_pieces)
             - plan.piece_start(p, total, n_pieces) for p in range(n_pieces)]
    assert sum(sizes) == total
    assert max(sizes) - min(sizes) <= 1
    slots = [sg.slot for sg in segs]
    assert len(set(slots)) == len(slots)
    assert all(0 <= x < n_pieces + len(lens) - 1 for x in slots)
    for row in range(len(lens)):          # the merge pass reads the row's own
        touched = {sg.piece for sg in segs if sg.row == row}
        nonempty = {p for p in plan.row_pieces(starts, row, n_pieces)
                    if sizes[p] > 0}
        assert touched == nonempty, row


def test_short_row_beside_long_rows_is_balanced():
    """One short row among seven long ones: every piece holds 13 or 14
    tiles, where a cut of each row into the same number of pieces would
    give the long rows' pieces 64 times the short row's work."""
    lens = [10] + [2047] * 7
    segs = plan.segments(lens, 2048, 33)
    tiles = {}
    for sg in segs:
        tiles[sg.piece] = (tiles.get(sg.piece, 0)
                           - (-(sg.end - sg.start) // plan.TILE))
    assert len(tiles) == 33
    assert sum(tiles.values()) == 1 + 7 * 64
    assert set(tiles.values()) == {13, 14}


@pytest.mark.parametrize("b,h,s,n_sm,want", [
    (8, 128, 2048, 132, 33),     # R1 decode batch: a block per SM, one wave
    (8, 64, 2048, 132, 66),      # two head groups: twice the pieces
    (1, 16, 100_000, 132, 132),  # one head group
    (8, 128, 40, 132, 16),       # no more pieces than tiles can exist
    (1, 32, 1, 4000, 1),         # one tile in all
])
def test_piece_count(b, h, s, n_sm, want):
    assert plan.n_pieces_for(b, h, s, n_sm) == want


def test_partial_bytes_at_serve_lengths():
    """The partial (m, l, acc) the merge reads at the R1 serve's shape: 40
    slots, 10.5 MB, where 13 per-row splits took 27.3 MB."""
    n = plan.n_pieces_for(8, 128, 2048, 132)
    assert plan.partial_bytes(8, 128, 512, n) == 4 * 40 * 128 * 514


@pytest.mark.parametrize("s,lens,n_pieces", PLANS)
def test_split_and_merge_emulation(s, lens, n_pieces):
    """The kernel's split and merge in plain PyTorch against the plain
    version and the JAX oracle (row by row, per-row lengths), at 3e-5."""
    b, h, r, dr = len(lens), 8, 64, 16
    ql, qr, cache = _inputs(b, h, r, dr, s, seed=s + n_pieces)
    args = (torch.from_numpy(ql), torch.from_numpy(qr),
            torch.from_numpy(cache), torch.tensor(lens, dtype=torch.int32),
            SCALE)
    got = mla_decode_attention_pieces(*args, n_pieces).numpy()
    np.testing.assert_allclose(got, mla_decode_attention_ref(*args).numpy(),
                               rtol=TOL, atol=TOL)
    for i, cl in enumerate(lens):
        valid = jnp.arange(s) <= min(cl, s - 1)
        want = jax_ref(jnp.asarray(ql[i:i + 1]), jnp.asarray(qr[i:i + 1]),
                       jnp.asarray(cache[i:i + 1]), valid, SCALE, r)
        np.testing.assert_allclose(got[i:i + 1], np.asarray(want), rtol=TOL,
                                   atol=TOL)


def test_emulation_skips_an_empty_piece():
    """More pieces than tiles: the empty pieces inside a row's range wrote
    nothing (their slots hold NaN) and must weigh 0."""
    lens, s = [0, 40], 64                     # 1 + 2 tiles over 8 pieces
    starts = plan.tile_starts(lens, s)
    empty = [p for p in plan.row_pieces(starts, 1, 8)
             if plan.piece_start(p, 3, 8) == plan.piece_start(p + 1, 3, 8)]
    assert empty                               # the case has one to skip
    ql, qr, cache = _inputs(2, 8, 64, 16, s, seed=11)
    args = (torch.from_numpy(ql), torch.from_numpy(qr),
            torch.from_numpy(cache), torch.tensor(lens, dtype=torch.int32),
            SCALE)
    got = mla_decode_attention_pieces(*args, 8)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, mla_decode_attention_ref(*args),
                               rtol=TOL, atol=TOL)


def test_split_tf32_parts():
    """hi keeps 10 mantissa bits (rounded), lo is the exact rest, and the
    tensor core's view of lo keeps its top 19 bits."""
    x = torch.from_numpy(np.random.RandomState(5).randn(4096)
                         .astype(np.float32))
    hi, lo = split_tf32(x)
    assert torch.equal(hi + lo, x)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert (lo.abs() <= hi.abs() * 2.0 ** -11).all()
    assert ((tf32_operand(lo).view(torch.int32) & 0x1FFF) == 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_products_meet_the_kernel_tolerance(seed):
    """At the served widths (H=128, R=512, Dr=64) and a short S, both
    products in 3xTF32 stay within 3e-5 of the f32 plain version; one TF32
    pass (the control) does not."""
    b, h, r, dr, s = 2, 128, 512, 64, 48
    ql, qr, cache = _inputs(b, h, r, dr, s, seed=100 + seed)
    args = (torch.from_numpy(ql), torch.from_numpy(qr),
            torch.from_numpy(cache), torch.tensor([s - 1, 20], dtype=torch.int32),
            1.0 / 192 ** 0.5)
    want = mla_decode_attention_ref(*args)
    three = mla_decode_attention_3xtf32(*args, passes=3)
    one = mla_decode_attention_3xtf32(*args, passes=1)
    assert torch.allclose(three, want, rtol=TOL, atol=TOL)
    assert not torch.allclose(one, want, rtol=TOL, atol=TOL)
    assert (one - want).abs().max() > 10 * (three - want).abs().max()
