"""The dispatch-quantize kernel's design on the CPU: its rounding rule (a
product by the reciprocal of the scale, the IEEE quotient only next to a
half-integer; ``ref.codes_by_reciprocal``) bit for bit against the divided
codes of the plain version, on every bf16 value up to absmax, on f32
values planted at the rounding boundaries and on random bf16 rows; the
split and rows paths' division-free quotient (``ref.quotient_codes``);
and its launch plan
(``plan.py``) at the served shapes and at the shapes that take its other
paths. The codes themselves are held against JAX in
``test_torch_quant.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.dispatch_quant import plan
from repro_torch.kernels.dispatch_quant.ref import (
    BF16_EXPONENTS, NEAR_WINDOW, bf16_boundary_rows, codes_by_reciprocal,
    dispatch_quantize_ref, f32_boundary_rows, quotient_codes)

N_SM = 132                  # an H100 SXM
D = 7168                    # DeepSeek-R1's d_model


def _codes(x):
    return dispatch_quantize_ref(x)[0]


@pytest.mark.parametrize("exponent", BF16_EXPONENTS)
def test_reciprocal_rule_exact_on_every_bf16_value(exponent):
    """Every bf16 |x| <= absmax, for each of the 128 mantissas of absmax at
    this exponent (the subnormal binade, absmax across the 1e-8 clamp, [1,
    2) and the top binade), plus a row of zeros: the kernel's rule gives
    the divided code everywhere, and the quotient is taken rarely."""
    x = bf16_boundary_rows(1024, seed=exponent & 0xff, exponents=(exponent,))
    got, near = codes_by_reciprocal(x)
    ref = _codes(x)
    assert torch.equal(got, ref)
    assert near.float().mean().item() < 1e-3
    zeros = x[-1]
    assert not zeros.float().any() and not got[-1].any()


def test_bare_reciprocal_misses_bf16_codes():
    """The window is needed: without it the reciprocal's code differs from
    the quotient's for some bf16 values (so the exhaustive test above can
    catch a rule that skips the quotient)."""
    x = bf16_boundary_rows(D, exponents=(0, 127))
    bare, near = codes_by_reciprocal(x, window=0.0)
    assert not near.any()
    assert int((bare != _codes(x)).sum()) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reciprocal_rule_exact_on_planted_f32(seed):
    """f32 rows with a quarter of their values at (k + 1/2) * scale moved by
    0 to 3 ulp: equal codes, bit for bit; the planted values take the
    quotient, the others rarely do."""
    x = f32_boundary_rows(64, 1024, seed)
    got, near = codes_by_reciprocal(x)
    assert torch.equal(got, _codes(x))
    assert 0.2 < near.float().mean().item() < 0.3


def test_narrower_windows_miss_planted_f32():
    """The planted rows reach into the window: the bare reciprocal and a
    window of 2^-17 (a quarter of the kernel's) both give wrong codes."""
    x = f32_boundary_rows(64, 1024, 0)
    ref = _codes(x)
    for window in (0.0, NEAR_WINDOW / 4):
        assert int((codes_by_reciprocal(x, window)[0] != ref).sum()) > 0


def test_reciprocal_rule_exact_on_random_bf16_rows():
    """Random normal bf16 rows, as the dispatch buffers hold: the scale's
    own rounding leaves 0.3 % of their values within 2^-17 of a
    half-integer, and those take the quotient; every code equal."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(256, D, generator=gen).to(torch.bfloat16)
    got, near = codes_by_reciprocal(x)
    assert torch.equal(got, _codes(x))
    assert 1e-3 < near.float().mean().item() < 1e-2
    assert int((codes_by_reciprocal(x, window=0.0)[0] != _codes(x)).sum()) > 0


@pytest.mark.parametrize("rows", ["bf16", "f32", "random bf16"])
def test_quotient_codes_round_the_ieee_quotient(rows):
    """The split and rows paths' division-free code equals rint(x / scale)
    of the IEEE quotient for every value, near a half-integer or not (ties
    of the quotient at h included)."""
    if rows == "bf16":
        x = bf16_boundary_rows(D, exponents=(0, 127)).float()
    elif rows == "f32":
        x = f32_boundary_rows(64, 1024, 5)
    else:
        gen = torch.Generator().manual_seed(3)
        x = torch.randn(256, D, generator=gen).to(torch.bfloat16).float()
    scale = dispatch_quantize_ref(x)[1]
    inv = torch.tensor(1.0) / scale
    assert codes_by_reciprocal(x)[1].sum() > 100
    assert torch.equal(quotient_codes(x, scale, inv), torch.round(x / scale))


def test_boundary_rows_keep_their_absmax():
    """The planted values lie below the row's absmax, so the scale is the
    one they were planted against."""
    x = f32_boundary_rows(8, 256, 3)
    scale = dispatch_quantize_ref(x)[1]
    rng = np.random.RandomState(3)
    base = (rng.randn(8, 256) * 10.0 ** rng.uniform(-3, 3, (8, 1))).astype(
        np.float32)
    want = np.maximum(np.abs(base).max(1, keepdims=True), np.float32(1e-8))
    np.testing.assert_array_equal(scale.numpy(), want / np.float32(127.0))


def _plan(t, d=D, in_bytes=2, pack=True, x_off=0, q_off=0):
    width = d + 4 if pack else d
    return plan.launch_plan(t, d, in_bytes, 0x7f0000000000 + x_off,
                            0x7f1000000000 + q_off, width, N_SM)


@pytest.mark.parametrize("t", [2048, 12288])
def test_plan_served_buffers_run_one_wave(t):
    """The decode and prefill dispatch buffers (bf16, packed): the ring,
    four blocks of 8 warps on every SM (one wave), two rows of ring each."""
    p = _plan(t)
    assert p.kind == "ring" and p.vec
    assert (p.grid, p.warps, p.stages) == (4 * N_SM, 8, 2)
    assert p.smem == 2 * (2 * D + plan.BAR_BYTES)
    assert 4 * (p.smem + plan.STATIC_SMEM + 1024) <= plan.SMEM_PER_SM


def test_plan_f32_ring():
    """f32 rows twice as long: three blocks an SM; fewer rows than blocks,
    fewer blocks."""
    p = _plan(2048, in_bytes=4, pack=False)
    assert (p.kind, p.stages, p.grid) == ("ring", 2, 3 * N_SM)
    assert p.smem == 2 * (4 * D + plan.BAR_BYTES)
    assert _plan(100, in_bytes=4).grid == 100


@pytest.mark.parametrize("d,in_bytes,kind", [(8200, 2, "ring"),
                                              (20000, 4, "ring"),
                                              (29100, 4, "rows"),
                                              (131072, 2, "rows")])
def test_plan_ring_needs_two_stages(d, in_bytes, kind):
    """The ring takes rows of which two fit a block's shared memory (up to
    116,096 bytes); longer rows take the rows path."""
    p = _plan(200, d=d, in_bytes=in_bytes, pack=False)
    assert p.kind == kind
    if kind == "ring":
        assert p.stages == 2 and p.smem <= plan.SMEM_LIMIT - plan.STATIC_SMEM


@pytest.mark.parametrize("t,cluster", [(1, 8), (8, 8), (16, 8), (33, 4),
                                       (66, 2)])
def test_plan_small_t_splits_rows_over_a_cluster(t, cluster):
    """T at most half the SMs: each row over a cluster, slices of whole
    16-byte groups that cover the row with none empty."""
    p = _plan(t, pack=False)
    assert (p.kind, p.cluster, p.grid, p.vec) == ("split", cluster,
                                                  t * cluster, True)
    assert p.slice % 8 == 0
    starts = [rank * p.slice for rank in range(p.cluster)]
    assert all(s < D for s in starts) and starts[-1] + p.slice >= D


def test_plan_past_the_split_takes_the_ring():
    assert _plan(67).kind == "ring"


@pytest.mark.parametrize("t", [8, 512])
@pytest.mark.parametrize("case", ["odd width", "misaligned x", "f32 odd"])
def test_plan_plain_loads_where_a_bulk_copy_cannot(t, case):
    """An odd width or a misaligned pointer: element loads, in the cluster
    split at small T and in the persistent rows path past it."""
    kw = {"odd width": dict(d=1001), "misaligned x": dict(x_off=2),
          "f32 odd": dict(d=1026, in_bytes=4)}[case]
    p = _plan(t, **kw)
    assert not p.vec
    assert p.kind == ("split" if t == 8 else "rows")
    if p.kind == "split":
        assert p.cluster * p.slice >= kw.get("d", D)


def test_plan_has_no_width_limit():
    """Rows longer than two ring stages (the old kernel refused D > 58,104):
    the rows path, no shared memory."""
    p = _plan(160, d=131072)
    assert (p.kind, p.smem, p.grid) == ("rows", 0, 160)


def test_plan_no_rows_launches_nothing():
    p = _plan(0)
    assert p.kind == "none" and p.grid == 0
