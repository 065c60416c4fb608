"""The port's GQA attention (``repro_torch/models/attention.py``) against the
JAX package's ``repro/models/attention.py`` at smoke widths (float32), on
the same seeded numpy inputs and weights.

Configs: ``smoke("qwen3-8b")`` (qk-norm; 4 heads over 4 KV heads of 64,
sliding window 64) with its KV heads cut to 2 (G = 2 query heads a KV
head), and ``smoke("qwen2.5-3b")`` (QKV bias; 4 heads over 2 KV heads).
Norm gains and biases are drawn at random so that they matter.

Tolerance: rtol = atol = 2e-4 (the model tests'): attention outputs pass
float32 through the projections, a softmax and the output projection,
summed in another order than XLA's; the K/V entries written into the
caches pass one projection, norm and RoPE, whose angles at positions near
640 differ between XLA's and PyTorch's cos/sin by ~2e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.models import attention as j_attn
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import attention as t_attn

TOL = 2e-4


def _configs(arch):
    """(JAX config, port config) of the arch's smoke variant; qwen3's KV
    heads are cut to 2 so that its query heads are grouped."""
    cfg, tcfg = smoke(arch), smoke_variant(get_config(arch))
    if arch == "qwen3-8b":
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
        tcfg = dataclasses.replace(tcfg, num_kv_heads=2)
    return cfg, tcfg


def _layer(cfg, seed=0):
    """One JAX attention layer (numpy leaves), gains and biases random."""
    p = j_attn.init_attention_params(jax.random.PRNGKey(seed), cfg, 1,
                                     jnp.float32)
    p = {k: np.array(v[0]) for k, v in p.items()}
    rng = np.random.RandomState(seed + 100)
    for k in ("ln", "q_norm", "k_norm", "bq", "bk", "bv"):
        if k in p:
            p[k] = (1.0 if "norm" in k or k == "ln" else 0.0) + \
                0.3 * rng.randn(*p[k].shape).astype(np.float32)
    return p


def _port(tcfg, layer):
    a = t_attn.Attention(tcfg, torch.device("cpu"), torch.float32)
    names = dict(a.named_parameters())
    assert set(names) == set(layer)
    for k, prm in names.items():
        prm.data.copy_(torch.from_numpy(layer[k]))
    return a


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=["qwen3-8b", "qwen2.5-3b"])
def arch(request):
    cfg, tcfg = _configs(request.param)
    layer = _layer(cfg)
    return cfg, tcfg, layer, _port(tcfg, layer)


def test_weights_and_cache_layout_match_jax(arch):
    cfg, tcfg, layer, tl = arch
    assert cfg.qk_norm == ("q_norm" in layer) and cfg.qkv_bias == ("bq" in layer)
    for k, prm in tl.named_parameters():
        assert tuple(prm.shape) == layer[k].shape
    assert t_attn.KVCache._fields == j_attn.KVCache._fields
    for seq in (8, 64, 65, 300):
        assert t_attn.is_ring(tcfg, seq) == j_attn.is_ring(cfg, seq)
        jc = j_attn.make_cache(cfg, 3, 2, seq, jnp.float32)
        tc = t_attn.make_cache(tcfg, 3, 2, seq, torch.float32)
        assert tuple(tc.k.shape) == jc.k.shape == tuple(tc.v.shape)
        assert tc.capacity == jc.capacity
        assert tc.length.ndim == 0 and int(tc.length) == 0


@pytest.mark.parametrize("s,block_skip", [(40, False), (40, True),
                                          (100, False), (100, True),
                                          (640, False), (640, True)])
def test_attention_prefill(arch, monkeypatch, s, block_skip):
    """Below (40) and above (100, 640) the window of 64, masked (JAX's
    chunk divides s; the port's last chunk is ragged at 640) and
    block-skipped (REPRO_BLOCK_SKIP=1: the window applies at every s)."""
    cfg, tcfg, layer, tl = arch
    monkeypatch.setenv("REPRO_BLOCK_SKIP", "1" if block_skip else "0")
    b = 2 if s < 200 else 1
    x = np.random.RandomState(s).randn(b, s, cfg.d_model).astype(np.float32)
    # A fresh jit per call: REPRO_BLOCK_SKIP is read while tracing.
    jo, (jk, jv) = jax.jit(lambda p, x: j_attn.attention_prefill(p, x, cfg))(
        layer, jnp.asarray(x))
    to, (tk, tv) = t_attn.attention_prefill(tl, _t(x), tcfg)
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("window", [None, 24])
def test_flash_window_matches_jax(arch, monkeypatch, window):
    """The block-skipped loop without a window and with one narrower than
    a chunk, at s = 96 (JAX's chunk is the whole sequence)."""
    cfg, tcfg, layer, tl = arch
    cfg = dataclasses.replace(cfg, sliding_window=window)
    tcfg = dataclasses.replace(tcfg, sliding_window=window)
    monkeypatch.setenv("REPRO_BLOCK_SKIP", "1")
    x = np.random.RandomState(5).randn(2, 96, cfg.d_model).astype(np.float32)
    jo, _ = jax.jit(lambda p, x: j_attn.attention_prefill(p, x, cfg))(
        layer, jnp.asarray(x))
    to, _ = t_attn.attention_prefill(tl, _t(x), tcfg)
    _close(to, jo)


def test_attention_prefill_bidirectional(arch, monkeypatch):
    """The encoder mask (every position sees every other), which
    REPRO_BLOCK_SKIP does not change."""
    cfg, tcfg, layer, tl = arch
    cfg = dataclasses.replace(cfg, attention_kind="bidirectional")
    tcfg = dataclasses.replace(tcfg, attention_kind="bidirectional")
    x = np.random.RandomState(6).randn(2, 80, cfg.d_model).astype(np.float32)
    jo, _ = jax.jit(lambda p, x: j_attn.attention_prefill(p, x, cfg))(
        layer, jnp.asarray(x))
    for skip in ("0", "1"):
        monkeypatch.setenv("REPRO_BLOCK_SKIP", skip)
        to, _ = t_attn.attention_prefill(tl, _t(x), tcfg)
        _close(to, jo)


# (ring, cache_len): a scalar and per-request lengths; non-ring with a slot
# at capacity (its write is dropped), ring with lengths past the window.
DECODE_CASES = [(False, np.int32(9)), (False, np.array([5, 0, 23], np.int32)),
                (False, np.array([24, 3, 12], np.int32)),
                (True, np.int32(40)), (True, np.array([30, 5, 24], np.int32)),
                (True, np.array([23, 47, 0], np.int32))]


@pytest.mark.parametrize("ring,cache_len", DECODE_CASES)
def test_attention_decode(arch, ring, cache_len):
    cfg, tcfg, layer, tl = arch
    rng = np.random.RandomState(7)
    shape = (3, 24, cfg.num_kv_heads, cfg.head_dim)
    ck = rng.randn(*shape).astype(np.float32)
    cv = rng.randn(*shape).astype(np.float32)
    x = rng.randn(3, 1, cfg.d_model).astype(np.float32)
    jo, jk, jv = jax.jit(
        lambda p, x, k, v, c: j_attn.attention_decode(p, x, k, v, c, cfg,
                                                      ring))(
        layer, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(cache_len))
    tk, tv = _t(ck).clone(), _t(cv).clone()
    to, rk, rv = t_attn.attention_decode(tl, _t(x), tk, tv, _t(cache_len),
                                         tcfg, ring)
    assert rk is tk and rv is tv                     # written in place
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)
    # Only the written slots changed, bit for bit elsewhere.
    np.testing.assert_array_equal((tk.numpy() != ck).any((2, 3)),
                                  (np.asarray(jk) != ck).any((2, 3)))


@pytest.mark.parametrize("offset", [np.int32(4), np.array([0, 7, 21], np.int32)])
def test_attention_extend(arch, offset):
    """Scalar and per-request offsets; the third row's positions run past
    the cache (21..25 of 24) and those rows are dropped, as the JAX scatter
    drops them; queries at dropped positions still attend the whole
    cache."""
    cfg, tcfg, layer, tl = arch
    rng = np.random.RandomState(8)
    shape = (3, 24, cfg.num_kv_heads, cfg.head_dim)
    ck = rng.randn(*shape).astype(np.float32)
    cv = rng.randn(*shape).astype(np.float32)
    x = rng.randn(3, 5, cfg.d_model).astype(np.float32)
    jo, jk, jv = jax.jit(
        lambda p, x, k, v, o: j_attn.attention_extend(p, x, k, v, o, cfg))(
        layer, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(offset))
    to, tk, tv = t_attn.attention_extend(tl, _t(x), _t(ck).clone(),
                                         _t(cv).clone(), _t(offset), tcfg)
    _close(tk, jk)
    _close(tv, jv)
    _close(to, jo)


def test_decode_helpers_match_jax():
    cl = np.array([0, 3, 9, 12, 30], np.int32)
    for ring in (False, True):
        np.testing.assert_array_equal(
            t_attn.decode_valid_mask(_t(cl), 10, ring).numpy(),
            np.asarray(j_attn.decode_valid_mask(jnp.asarray(cl), 10, ring)))
        want = cl % 10 if ring else cl
        np.testing.assert_array_equal(
            t_attn.decode_slot(_t(cl), 10, ring).numpy(), want)
