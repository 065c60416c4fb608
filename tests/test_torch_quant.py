"""The port's INT8 pieces against the JAX package on the CPU: the
dispatch-quantize and INT8 GEMM wrappers (their plain versions here) against
the JAX oracles and Pallas kernels (interpret mode, as ``test_kernels.py``
runs them), the §4.5 calibration pipeline and ``quantized_matmul``, and the
mixed-precision policy over a whole model. Inputs come from numpy seeds and
go to both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke
from repro import quant as jquant
from repro.kernels.dispatch_quant.ops import dispatch_quantize as j_dq_pallas
from repro.kernels.dispatch_quant.ref import dispatch_quantize_ref as j_dq_ref
from repro.kernels.int8_gemm.ops import int8_matmul as j_mm_pallas
from repro.kernels.int8_gemm.ref import int8_matmul_ref as j_mm_ref
from repro.models import init_params as j_init_params
from repro_torch import quant
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import (param_tree, params_from_jax_numpy,
                                 quantized_linear_from_jax_numpy,
                                 quantized_tree_from_jax_numpy)
from repro_torch.kernels.dispatch_quant import dispatch_quantize
from repro_torch.kernels.int8_gemm import int8_matmul

# test_kernels.py's grids, plus ragged shapes (a row count that the Pallas
# wrapper's 256-row tile does not divide; a width that is not a multiple of
# 8; DeepSeek-R1's wkv_a, N=576, scaled down by 8; M, K and N that no tile
# of the CUDA kernel divides, K not a multiple of 16 and N not of 4).
DQ_SHAPES = [(8, 64), (64, 256), (128, 128), (32, 96), (300, 72), (37, 1001)]
MM_SHAPES = [(32, 64, 48), (128, 128, 128), (64, 256, 96), (16, 32, 128),
             (1, 896, 72), (17, 100, 130), (100, 200, 130)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _dq_input(t, d, dtype):
    x = (np.random.RandomState(t * 1000 + d).randn(t, d) * 5).astype(np.float32)
    x[t // 2] = 0.0                      # an empty capacity slot
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("t,d", DQ_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dispatch_quantize_matches_jax(t, d, dtype):
    """Codes equal except +-1 where XLA folds x/s into x*(1/s) at a rounding
    boundary, scales to 1e-6, the error bound |x - q s| <= s/2, and the
    packed tail bit-identical to jax.lax.bitcast_convert_type."""
    jx, tx = _dq_input(t, d, dtype)
    q, s = dispatch_quantize(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == (t, d) and tuple(s.shape) == (t, 1)
    for jq, js in (j_dq_ref(jx), j_dq_pallas(jx)):
        diff = np.abs(q.numpy().astype(np.int32) - np.asarray(jq, np.int32))
        assert diff.max() <= 1
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    err = np.abs(q.numpy() * s.numpy() - tx.float().numpy())
    assert (err <= s.numpy() * 0.5 + 1e-6).all()
    assert s[t // 2].item() == np.float32(1e-8) / np.float32(127.0)
    assert not q[t // 2].any()

    packed = dispatch_quantize(tx, pack=True)
    assert tuple(packed.shape) == (t, d + 4)
    assert torch.equal(packed[:, :d], q)
    tail = np.asarray(jax.lax.bitcast_convert_type(jnp.asarray(s.numpy()),
                                                   jnp.int8)).reshape(t, 4)
    np.testing.assert_array_equal(packed[:, d:].numpy(), tail)


@pytest.mark.parametrize("pack", [False, True])
def test_dispatch_quantize_takes_no_rows(pack):
    """T = 0, as an empty dispatch: empty results of the right shapes, as
    the JAX oracle gives."""
    jq, js = j_dq_ref(jnp.zeros((0, 16), jnp.float32))
    got = dispatch_quantize(torch.zeros(0, 16), pack=pack)
    if pack:
        assert got.dtype == torch.int8 and tuple(got.shape) == (0, 20)
    else:
        q, s = got
        assert tuple(q.shape) == jq.shape and tuple(s.shape) == js.shape
        assert q.dtype == torch.int8 and s.dtype == torch.float32


def test_dispatch_quantize_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dispatch_quantize(torch.zeros(4, 8, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        dispatch_quantize(torch.zeros(8, 4).t())


def _mm_inputs(m, k, n):
    rng = np.random.RandomState(m * k + n)
    xq = rng.randint(-127, 128, (m, k)).astype(np.int8)
    wq = rng.randint(-127, 128, (k, n)).astype(np.int8)
    xs = (rng.rand(m, 1) * 0.1).astype(np.float32)
    ws = (rng.rand(1, n) * 0.1).astype(np.float32)
    # The port stores INT8 weights K-major: w_q is the .t() view of a
    # contiguous (N, K) tensor, with JAX's (K, N) shape and values.
    twq = torch.from_numpy(np.ascontiguousarray(wq.T)).t()
    return (xq, wq, xs, ws), (torch.from_numpy(xq), twq, torch.from_numpy(xs),
                              torch.from_numpy(ws))


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_int8_matmul_matches_jax(m, k, n, dtype):
    """Against int8_matmul_ref and the Pallas kernel: f32 output to 1e-6,
    bf16 output to 1e-2 (test_kernels.py's tolerance)."""
    (jargs, targs) = _mm_inputs(m, k, n)
    jdt, tdt = DTYPES[dtype]
    out = int8_matmul(*targs, out_dtype=tdt)
    assert out.dtype == tdt and tuple(out.shape) == (m, n)
    rtol = 1e-6 if dtype == "float32" else 1e-2
    for ref in (j_mm_ref(*jargs, out_dtype=jdt),
                j_mm_pallas(*jargs, out_dtype=jdt)):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32), rtol=rtol)


def test_int8_matmul_rejects_what_the_kernel_does_not_take():
    _, (xq, wq, xs, ws) = _mm_inputs(4, 8, 4)
    with pytest.raises(ValueError, match="int8"):
        int8_matmul(xq.int(), wq, xs, ws)
    with pytest.raises(ValueError, match="w_scale"):
        int8_matmul(xq, wq, xs, ws.t())
    with pytest.raises(ValueError, match="out_dtype"):
        int8_matmul(xq, wq, xs, ws, out_dtype=torch.float16)


def test_wrappers_run_only_on_cpu_or_cuda():
    """A device other than the CPU, CUDA and meta (which traces shapes
    through the plain version) has no path."""
    with pytest.raises(ValueError, match="cpu or cuda"):
        dispatch_quantize(_Elsewhere(torch.zeros(2, 8)))
    xq = _Elsewhere(torch.zeros(2, 8, dtype=torch.int8))
    wq = _Elsewhere(torch.zeros(4, 8, dtype=torch.int8).t())   # K-major
    with pytest.raises(ValueError, match="cpu or cuda"):
        int8_matmul(xq, wq, _Elsewhere(torch.zeros(2, 1)),
                    _Elsewhere(torch.zeros(1, 4)))


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


@pytest.fixture(scope="module")
def calib():
    """test_quant.py's fixture shape: a (128, 96) weight and 64 calibration
    tokens with an activation outlier channel."""
    rng = np.random.RandomState(0)
    w = (rng.randn(128, 96) * 0.05).astype(np.float32)
    x = rng.randn(64, 128).astype(np.float32)
    x[:, 5] *= 30.0
    return w, x


PIPELINES = {
    "full": {},
    "no_compensation": dict(compensate=False),
    "equalize_only": dict(block_clip=False, compensate=False),
    "plain": dict(equalize=False, block_clip=False, compensate=False),
}


@pytest.mark.parametrize("pipeline", list(PIPELINES))
def test_calibrate_linear_matches_jax(calib, pipeline):
    w, x = calib
    kw = PIPELINES[pipeline]
    jql = jquant.calibrate_linear(jnp.asarray(w), jnp.asarray(x), **kw)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    ql = quant.calibrate_linear(tw, tx, **kw)
    if jql.eq is not None:
        np.testing.assert_allclose(ql.eq.numpy(), np.asarray(jql.eq), rtol=1e-6)
        w_eff = tw * ql.eq[:, None]
        x_eff = tx / ql.eq[None, :]
    else:
        assert ql.eq is None
        w_eff, x_eff = tw, tx
    if kw.get("block_clip", True):
        clips = quant.block_clip_search(w_eff, x_eff)
        jclips = jquant.block_clip_search(jnp.asarray(w_eff.numpy()),
                                          jnp.asarray(x_eff.numpy()))
        np.testing.assert_array_equal(clips.numpy(), np.asarray(jclips))
    dq = np.abs(ql.w_q.numpy().astype(np.int32) - np.asarray(jql.w_q, np.int32))
    assert dq.max() <= 1 and dq.mean() < 1e-3
    np.testing.assert_allclose(ql.w_scale.numpy(), np.asarray(jql.w_scale),
                               rtol=1e-6)
    if jql.bias_corr is not None:
        np.testing.assert_allclose(ql.bias_corr.numpy(),
                                   np.asarray(jql.bias_corr), atol=1e-5)
    else:
        assert ql.bias_corr is None
    out = quant.quantized_matmul(tx, ql)
    jout = jquant.quantized_matmul(jnp.asarray(x), jql)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jout).max()))


def test_quantized_matmul_on_jax_calibration(calib):
    """JAX's QuantizedLinear carried across runs the same product."""
    w, x = calib
    jql = jquant.calibrate_linear(jnp.asarray(w), jnp.asarray(x))
    ql = quantized_linear_from_jax_numpy(
        jax.tree.map(lambda a: None if a is None else np.asarray(a), jql,
                     is_leaf=lambda a: a is None), "cpu")
    for use_kernel in (False, True):
        out = quant.quantized_matmul(torch.from_numpy(x), ql,
                                     use_kernel=use_kernel)
        jout = jquant.quantized_matmul(jnp.asarray(x), jql,
                                       use_kernel=use_kernel)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(jout).max()))


def _rel_err(w, x, **kw):
    ref = x @ w
    out = quant.quantized_matmul(x, quant.calibrate_linear(w, x, **kw))
    return float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))


def test_port_equalization_suppresses_outliers(calib):
    w, x = (torch.from_numpy(a) for a in calib)
    plain = _rel_err(w, x, equalize=False, block_clip=False, compensate=False)
    eq = _rel_err(w, x, equalize=True, block_clip=False, compensate=False)
    assert eq < plain * 0.6, f"equalization should cut error: {plain} -> {eq}"


def test_port_full_pipeline_monotone(calib):
    w, x = (torch.from_numpy(a) for a in calib)
    plain = _rel_err(w, x, equalize=False, block_clip=False, compensate=False)
    full = _rel_err(w, x)
    assert full <= plain
    assert full < 0.02


def test_port_adaptive_scale_search_matches_jax(calib):
    w, x = calib
    s, errs = quant.adaptive_scale_search(torch.from_numpy(w),
                                          torch.from_numpy(x))
    js, jerrs = jquant.adaptive_scale_search(jnp.asarray(w), jnp.asarray(x))
    assert float(errs.min()) <= float(errs[3]) + 1e-6     # grid[3] == 1.0
    assert s == js
    np.testing.assert_allclose(errs.numpy(), np.asarray(jerrs), rtol=1e-3)


def test_port_mixed_precision_policy():
    for path in ("segments/moe/moe/w_gate", "segments/dense/attn/wq",
                 "segments/moe/attn/wkv_a", "segments/dense/attn/ln",
                 "segments/moe/moe/router", "segments/mamba/mamba/A_log",
                 "segments/mamba/mamba/conv_w", "embed", "lm_head",
                 "segments/moe/attn/kv_ln"):
        assert quant.should_quantize(path) == jquant.should_quantize(path)


@pytest.fixture(scope="module")
def r1_trees():
    cfg = smoke("deepseek-r1")
    tcfg = smoke_variant(get_config("deepseek-r1"))
    jp = jax.jit(j_init_params, static_argnums=(1,))(jax.random.PRNGKey(0), cfg)
    model = params_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jp, model


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _flat(sub, f"{path}/{k}").items()}
    return {path: tree}


def test_quantize_param_tree_matches_jax(r1_trees):
    """At smoke("deepseek-r1"): the port's tree in the JAX layout has JAX's
    paths and shapes, the policy quantizes the same paths with the same
    stats, and codes and scales agree (codes to +-1 at rounding
    boundaries)."""
    jp, model = r1_trees
    tree = param_tree(model)
    jflat = _flat(jax.tree.map(np.asarray, jp))
    flat = _flat(tree)
    assert sorted(flat) == sorted(jflat)
    for path, v in flat.items():
        assert tuple(v.shape) == jflat[path].shape, path
        np.testing.assert_array_equal(v.numpy(), jflat[path])

    qt, stats = quant.quantize_param_tree(tree)
    jqt, jstats = jquant.quantize_param_tree(jp)
    assert stats == jstats
    assert stats["quantized"] > 0 and stats["kept"] > 0
    jq = _flat(quantized_tree_from_jax_numpy(jax.tree.map(np.asarray, jqt),
                                             "cpu"))
    q = _flat(qt)
    assert sorted(q) == sorted(jq)
    for path, v in q.items():
        if path.endswith("/__q__"):
            d = (v.int() - jq[path].int()).abs()
            assert int(d.max()) <= 1 and float(d.float().mean()) < 1e-3, path
        elif path.endswith("/__scale__"):
            np.testing.assert_allclose(v.numpy(), jq[path].numpy(), rtol=1e-6)
        else:
            assert torch.equal(v, jq[path]), path
