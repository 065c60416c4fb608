"""The port's K-major INT8 weight layout on the CPU: every quantizer and
converter stores w_q as the .t() view of a contiguous (N, K) tensor with
JAX's values, the INT8 GEMM wrapper refuses any other layout on every
device, its padding rule picks exactly the products TMA cannot read as
they are, and products on converted JAX weights still equal JAX's. Inputs
come from numpy seeds and go to both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro_torch import quant
from repro_torch.convert import (quantized_linear_from_jax_numpy,
                                 quantized_tree_from_jax_numpy)
from repro_torch.kernels.int8_gemm import int8_matmul, ops
from repro_torch.kernels.int8_gemm.ref import int8_matmul_ref


def _assert_k_major(w: torch.Tensor) -> None:
    """(..., K, N) stored as the transpose of a contiguous (..., N, K)."""
    k = w.shape[-2]
    assert w.dtype == torch.int8
    assert w.transpose(-1, -2).is_contiguous()
    if w.shape[-1] > 1 and k > 1:
        assert tuple(w.stride()[-2:]) == (1, k), w.stride()


def _assert_codes_match(got: torch.Tensor, want) -> None:
    """Codes equal to JAX's, but for +-1 where XLA folds w/s into w*(1/s) at
    a rounding boundary (test_torch_quant.py's tolerance)."""
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1 and d.mean() < 1e-3


def _weights(k, n, seed):
    return (np.random.RandomState(seed).randn(k, n) * 0.05).astype(np.float32)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("k,n", [(8, 4), (64, 48), (2, 3)])
def test_row_major_weight_raises(device, k, n):
    """A row-major (K, N) w_q is refused on every device, naming the
    layout; its K-major twin passes the check (on meta, to the plain
    version, which traces its shape)."""
    xq = torch.zeros(2, k, dtype=torch.int8, device=device)
    xs = torch.zeros(2, 1, device=device)
    ws = torch.zeros(1, n, device=device)
    row_major = torch.zeros(k, n, dtype=torch.int8, device=device)
    with pytest.raises(ValueError, match="K-major"):
        int8_matmul(xq, row_major, xs, ws)
    k_major = torch.zeros(n, k, dtype=torch.int8, device=device).t()
    out = int8_matmul(xq, k_major, xs, ws)
    assert tuple(out.shape) == (2, n) and out.device.type == device


def test_sliced_k_major_weight_raises():
    """A K slice of a K-major weight (stride (1, 16) on a (12, 8) view) is
    not the transpose of a contiguous tensor: refused, not copied."""
    w = torch.zeros(8, 16, dtype=torch.int8).t()[2:14]
    with pytest.raises(ValueError, match="K-major"):
        int8_matmul(torch.zeros(2, 12, dtype=torch.int8), w,
                    torch.zeros(2, 1), torch.zeros(1, 8))


@pytest.mark.parametrize("k,n", [(128, 96), (7, 5), (1, 9), (33, 1)])
def test_quantize_weight_per_channel_is_k_major(k, n):
    w = _weights(k, n, k * n)
    q, s = quant.quantize_weight_per_channel(torch.from_numpy(w))
    jq, js = jquant.quantize_weight_per_channel(jnp.asarray(w))
    assert tuple(q.shape) == (k, n)
    _assert_k_major(q)
    _assert_codes_match(q, jq)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)


def test_k_major_copies_only_what_is_not():
    w = torch.arange(12, dtype=torch.int8).reshape(3, 4)
    km = quant.k_major(w)
    assert torch.equal(km, w)
    _assert_k_major(km)
    assert quant.k_major(km).data_ptr() == km.data_ptr()
    stacked = quant.k_major(torch.arange(24, dtype=torch.int8).reshape(2, 3, 4))
    _assert_k_major(stacked)
    _assert_k_major(stacked[1])


@pytest.mark.parametrize("pipeline", [{}, dict(equalize=False, block_clip=False,
                                               compensate=False)])
def test_calibrate_linear_is_k_major(pipeline):
    rng = np.random.RandomState(1)
    w = (rng.randn(96, 40) * 0.05).astype(np.float32)
    x = rng.randn(32, 96).astype(np.float32)
    ql = quant.calibrate_linear(torch.from_numpy(w), torch.from_numpy(x),
                                **pipeline)
    jql = jquant.calibrate_linear(jnp.asarray(w), jnp.asarray(x), **pipeline)
    _assert_k_major(ql.w_q)
    _assert_codes_match(ql.w_q, jql.w_q)


def test_quantize_param_tree_is_k_major():
    """Stacked (L, K, N) and plain (K, N) leaves: every layer's codes have
    stride (1, K), with JAX's values and scales."""
    rng = np.random.RandomState(2)
    tree = {"segments": {"dense": {"attn": {
                "wq_a": (rng.randn(3, 24, 40) * 0.05).astype(np.float32),
                "q_ln": rng.randn(3, 40).astype(np.float32)}}},
            "lm_head": (rng.randn(24, 56) * 0.05).astype(np.float32)}
    qt, stats = quant.quantize_param_tree(
        jax.tree.map(torch.from_numpy, tree))
    jqt, jstats = jquant.quantize_param_tree(jax.tree.map(jnp.asarray, tree))
    assert stats == jstats == {"quantized": 2, "kept": 1}
    for got, want in ((qt["lm_head"], jqt["lm_head"]),
                      (qt["segments"]["dense"]["attn"]["wq_a"],
                       jqt["segments"]["dense"]["attn"]["wq_a"])):
        _assert_k_major(got["__q__"])
        for layer in got["__q__"].reshape(-1, *got["__q__"].shape[-2:]):
            _assert_k_major(layer)
        _assert_codes_match(got["__q__"], want["__q__"])
        np.testing.assert_allclose(got["__scale__"].numpy(),
                                   np.asarray(want["__scale__"]), rtol=1e-6)


def test_converted_jax_codes_are_k_major():
    """convert's carry-across of a JAX QuantizedLinear and of a JAX
    quantized tree: the same codes, bit for bit, stored K-major."""
    rng = np.random.RandomState(3)
    w = (rng.randn(64, 48) * 0.05).astype(np.float32)
    x = rng.randn(16, 64).astype(np.float32)
    jql = jquant.calibrate_linear(jnp.asarray(w), jnp.asarray(x))
    ql = quantized_linear_from_jax_numpy(
        jax.tree.map(lambda a: None if a is None else np.asarray(a), jql,
                     is_leaf=lambda a: a is None), "cpu")
    _assert_k_major(ql.w_q)
    np.testing.assert_array_equal(ql.w_q.numpy(), np.asarray(jql.w_q))
    for got, want in ((ql.w_scale, jql.w_scale), (ql.eq, jql.eq),
                      (ql.bias_corr, jql.bias_corr)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    jqt, _ = jquant.quantize_param_tree(
        {"moe": {"w_up": jnp.asarray(rng.randn(2, 32, 24), jnp.float32)}})
    qt = quantized_tree_from_jax_numpy(jax.tree.map(np.asarray, jqt), "cpu")
    _assert_k_major(qt["moe"]["w_up"]["__q__"])
    np.testing.assert_array_equal(qt["moe"]["w_up"]["__q__"].numpy(),
                                  np.asarray(jqt["moe"]["w_up"]["__q__"]))
    assert qt["moe"]["w_up"]["__scale__"].is_contiguous()


@pytest.mark.parametrize("m,k,n", [(8, 64, 48), (40, 128, 24), (3, 96, 130)])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_quantized_matmul_on_converted_jax_linear(m, k, n, out_dtype):
    """quantized_matmul on a converted JAX QuantizedLinear (K-major codes)
    equals JAX's quantized_matmul, at test_torch_quant.py's tolerance; bf16
    output within bf16 rounding of it."""
    rng = np.random.RandomState(m + k + n)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    x = rng.randn(m, k).astype(np.float32)
    x[:, 3] *= 20.0
    jql = jquant.calibrate_linear(jnp.asarray(w), jnp.asarray(x))
    ql = quantized_linear_from_jax_numpy(
        jax.tree.map(lambda a: None if a is None else np.asarray(a), jql,
                     is_leaf=lambda a: a is None), "cpu")
    jout = np.asarray(jquant.quantized_matmul(jnp.asarray(x), jql))
    out = quant.quantized_matmul(torch.from_numpy(x), ql,
                                 out_dtype=getattr(torch, out_dtype))
    if out_dtype == "float32":
        np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(jout).max()))
    else:
        np.testing.assert_allclose(out.float().numpy(), jout, rtol=1e-2,
                                   atol=1e-2 * float(np.abs(jout).max()))


@pytest.mark.parametrize("k", [0, 16, 48, 72, 100, 128, 200, 896, 1536, 2048,
                               7168, 16384])
@pytest.mark.parametrize("x_off,w_off", [(0, 0), (1, 0), (0, 8), (16, 32),
                                         (15, 15), (512, 0)])
def test_padding_rule(k, x_off, w_off):
    """Pad exactly when K bytes are not a multiple of 16 or an operand
    base is not 16-byte aligned; R1's K values never pad at aligned bases."""
    base = 1 << 20
    want = k % 16 != 0 or x_off % 16 != 0 or w_off % 16 != 0
    assert ops.needs_padding(k, base + x_off, base + w_off) is want
    if k in (1536, 2048, 7168, 16384) and (x_off, w_off) == (0, 0):
        assert not want


@pytest.mark.parametrize("m,k,n", [(3, 100, 130), (1, 72, 5), (17, 200, 8)])
def test_padded_operands_give_the_same_product(m, k, n):
    """The padded copies are aligned, K-major, K rounded up to 16, zero in
    the pad, and their product equals the original's bit for bit."""
    rng = np.random.RandomState(k)
    x = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(np.ascontiguousarray(
        rng.randint(-127, 128, (n, k)).astype(np.int8))).t()
    xs = torch.from_numpy((rng.rand(m, 1) * 0.1).astype(np.float32))
    ws = torch.from_numpy((rng.rand(1, n) * 0.1).astype(np.float32))
    xp, wp = ops._padded(x, w)
    kp = -(-k // 16) * 16
    assert tuple(xp.shape) == (m, kp) and tuple(wp.shape) == (kp, n)
    assert xp.is_contiguous() and ops.is_k_major(wp)
    assert not ops.needs_padding(kp, xp.data_ptr(), wp.data_ptr())
    assert not xp[:, k:].any() and not wp[k:].any()
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(int8_matmul_ref(xp, wp, xs, ws, dt),
                           int8_matmul_ref(x, w, xs, ws, dt))
