"""The port's dense and GQA-MoE architectures against the JAX package at
their smoke variants (float32, 2 layers, the same weights through
``repro_torch.convert`` and the same seeded numpy inputs on both sides):
Qwen3-8B (qk-norm), Qwen2.5-3B (QKV bias), Granite-3-2B (tied embeddings),
Phi-3-medium, OLMoE-1B-7B (GQA + 64-expert MoE, cut to 4) and Kimi K2
(GQA + MoE with a dense lead layer and a shared expert).

Tolerances: logits and K/V caches rtol = atol = 2e-4 (float32 through a
few matmuls, softmax and norms, summed in another order than XLA's).
Greedy tokens, liveness and lengths must be identical, and frozen slots --
ring slots included -- must hold bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.models import model as j_model
from repro_torch.configs import get_config as port_get_config
from repro_torch.configs import smoke_variant as port_smoke
from repro_torch.convert import param_tree, params_from_jax_numpy
from repro_torch.models import model as t_model
from repro_torch.models.attention import KVCache

TOL = 2e-4
ARCHS = ("qwen3-8b", "qwen2.5-3b", "granite-3-2b", "phi3-medium-14b",
         "olmoe-1b-7b", "kimi-k2-1t-a32b")

J_PREFILL = jax.jit(j_model.prefill, static_argnums=(1, 3),
                    static_argnames=("cache_dtype",))
J_DECODE_STEP = jax.jit(j_model.decode_step, static_argnums=(1,))
J_DECODE_LOOP = jax.jit(j_model.decode_loop, static_argnums=(1, 5))
J_CONTINUE = jax.jit(j_model.prefill_continue, static_argnums=(1,))

_MODELS = {}


def _model(arch, **upd):
    """(JAX config, port config, JAX params, port params) of the arch's
    smoke variant with ``upd`` applied, built once per module."""
    key = (arch, tuple(sorted(upd.items())))
    if key not in _MODELS:
        cfg = dataclasses.replace(smoke(arch), **upd)
        tcfg = dataclasses.replace(port_smoke(port_get_config(arch)), **upd)
        jp = jax.jit(j_model.init_params, static_argnums=(1,))(
            jax.random.PRNGKey(0), cfg)
        tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        _MODELS[key] = (cfg, tcfg, jp, tp)
    return _MODELS[key]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _port_caches(jcaches):
    """JAX caches as the port's (KVCache per segment, copies)."""
    return {name: KVCache(*(_t(x).clone() for x in c))
            for name, c in jax.tree.map(np.asarray, jcaches).items()}


def _close_caches(tc, jc):
    assert set(tc) == set(jc)
    for name in jc:
        assert isinstance(tc[name], KVCache)
        _close(tc[name].k, jc[name].k)
        _close(tc[name].v, jc[name].v)
        np.testing.assert_array_equal(tc[name].length.numpy(),
                                      np.asarray(jc[name].length))


def _prefilled(cfg, jp, cap, s=10, b=3, seed=8):
    toks = np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, s)
                                               ).astype(np.int32)
    jl, jc = J_PREFILL(jp, cfg, {"tokens": jnp.asarray(toks)}, cap,
                       cache_dtype=jnp.float32)
    first = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    return toks, first, jc


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_params_and_cache_structure(arch):
    """Segment plan, the weight tree (``param_tree`` gives JAX's paths,
    shapes and values back, biases and qk-norm gains included; a tied head
    has no ``lm_head``) and the cache layout of ``make_caches``."""
    cfg, tcfg, jp, tp = _model(arch)
    assert [(s.name, s.kind, s.n_layers) for s in t_model.build_plan(tcfg)] \
        == [(s.name, s.kind, s.n_layers) for s in j_model.build_plan(cfg)]
    tree = param_tree(tp)
    flat_j = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {jax.tree_util.keystr(k): v.numpy() for k, v in
              jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert sorted(flat_t) == sorted(flat_j)
    for k, v in flat_t.items():
        np.testing.assert_array_equal(v, flat_j[k])
    assert ("lm_head" in tree) == (not tcfg.tie_embeddings)
    for cap in (24, 200):               # plain, and a ring of 64 slots
        jc = j_model.make_caches(cfg, 2, cap)
        tc = t_model.make_caches(tcfg, 2, cap, device="cpu")
        for name in jc:
            assert tuple(tc[name].k.shape) == jc[name].k.shape
            assert tc[name].k.dtype == torch.bfloat16
    assert t_model.cache_batch_axes(tcfg) == {
        name: KVCache(*ax) for name, ax in
        j_model.cache_batch_axes(cfg).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_step(arch):
    cfg, tcfg, jp, tp = _model(arch)
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 16)
                                            ).astype(np.int32)
    jl, jc = J_PREFILL(jp, cfg, {"tokens": jnp.asarray(toks)}, 24,
                       cache_dtype=jnp.float32)
    tl, tc = t_model.prefill(tp, tcfg, {"tokens": _t(toks)}, 24,
                             cache_dtype=torch.float32)
    _close(tl, jl)
    _close_caches(tc, jc)
    nxt = np.array([[3], [900]], np.int32)
    for cl in (np.int32(16), np.array([16, 9], np.int32)):
        jl2, jc2 = J_DECODE_STEP(jp, cfg, jnp.asarray(nxt), jc,
                                 jnp.asarray(cl))
        tl2, tc2 = t_model.decode_step(tp, tcfg, _t(nxt), _port_caches(jc),
                                       _t(cl))
        _close(tl2, jl2)
        _close_caches(tc2, jc2)


def _check_loop(cfg, tcfg, jp, tp, first, jc, cl, left, n):
    """decode_loop on both sides: identical liveness, emitted tokens where
    live, final tokens and lengths; caches within TOL. Returns the port's
    result."""
    jem, jlv, jtok, jcs, jcl = J_DECODE_LOOP(
        jp, cfg, jnp.asarray(first), jc, jnp.asarray(cl), n,
        steps_left=jnp.asarray(left))
    out = t_model.decode_loop(tp, tcfg, _t(first), _port_caches(jc), _t(cl),
                              n, steps_left=_t(left))
    tem, tlv, ttok, tcs, tcl = out
    np.testing.assert_array_equal(tlv.numpy(), np.asarray(jlv))
    np.testing.assert_array_equal(np.where(tlv.numpy(), tem.numpy(), -1),
                                  np.where(np.asarray(jlv), np.asarray(jem),
                                           -1))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tcl.numpy(), np.asarray(jcl))
    _close_caches(tcs, jcs)
    return out


def _assert_frozen_holds(tcfg, tp, first, jc, cl, left, n_short, n_long):
    """Slots whose budget ends within ``n_short`` steps hold bit for bit
    through the ``n_long - n_short`` steps after: the longer loop leaves
    their cache rows, tokens and lengths exactly as the shorter one."""
    short = t_model.decode_loop(tp, tcfg, _t(first), _port_caches(jc),
                                _t(cl), n_short, steps_left=_t(left))
    long_ = t_model.decode_loop(tp, tcfg, _t(first), _port_caches(jc),
                                _t(cl), n_long, steps_left=_t(left))
    done = _t(left) <= n_short
    assert done.any() and not done.all()
    for a, b in ((short[2], long_[2]), (short[4], long_[4])):
        assert torch.equal(a[done], b[done])
    for name in short[3]:
        for a, b in zip(short[3][name][:2], long_[3][name][:2]):
            assert torch.equal(a[:, done], b[:, done])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_loop_matches_jax_and_freezes(arch):
    """Per-slot done and capacity masks: slot 1 finishes early, slot 2
    reaches the capacity of 16 (its writes there are dropped)."""
    cfg, tcfg, jp, tp = _model(arch)
    _, first, jc = _prefilled(cfg, jp, 16)
    cl = np.array([10, 10, 14], np.int32)
    left = np.array([5, 2, 5], np.int32)
    _check_loop(cfg, tcfg, jp, tp, first, jc, cl, left, 5)
    _assert_frozen_holds(tcfg, tp, first, jc, cl, left, 2, 5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_loop_chunk_split_invariance(arch):
    _, tcfg, jp, tp = _model(arch)
    cfg = _model(arch)[0]
    _, first, jc = _prefilled(cfg, jp, 24)
    cl = np.full(3, 10, np.int32)
    em6, *_ = t_model.decode_loop(tp, tcfg, _t(first), _port_caches(jc),
                                  _t(cl), 6)
    em_a, _, tok, cs, length = t_model.decode_loop(
        tp, tcfg, _t(first), _port_caches(jc), _t(cl), 2)
    em_b, *_ = t_model.decode_loop(tp, tcfg, tok, cs, length, 4)
    np.testing.assert_array_equal(em6.numpy(),
                                  torch.cat([em_a, em_b], 1).numpy())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("offset", [np.int32(10), np.array([10, 6, 3], np.int32)])
def test_prefill_continue(arch, offset):
    cfg, tcfg, jp, tp = _model(arch)
    assert t_model.supports_prefill_continue(tcfg, 24) == \
        j_model.supports_prefill_continue(cfg, 24)
    assert t_model.supports_prefill_continue(tcfg, 200) == \
        j_model.supports_prefill_continue(cfg, 200) is False
    _, _, jc = _prefilled(cfg, jp, 24)
    toks = np.random.RandomState(9).randint(0, cfg.vocab_size, (3, 4)
                                            ).astype(np.int32)
    jl, jc2 = J_CONTINUE(jp, cfg, jnp.asarray(toks), jc, jnp.asarray(offset))
    tl, tc2 = t_model.prefill_continue(tp, tcfg, _t(toks), _port_caches(jc),
                                       _t(offset))
    _close(tl, jl)
    _close_caches(tc2, jc2)


# ---------------------------------------------------------------------------
# Sliding-window ring caches (granite, window 8)
# ---------------------------------------------------------------------------


def test_sliding_window_ring_decode():
    """tests/test_models.py's ring decode at granite with window 8: a
    prefill of 16 (> window) into a ring of 8 slots (the last 8 tokens,
    token p at slot p % 8), then decode_step through the ring, against
    JAX's prefill and steps."""
    cfg, tcfg, jp, tp = _model("granite-3-2b", sliding_window=8)
    toks = np.random.RandomState(5).randint(0, cfg.vocab_size, (1, 24)
                                            ).astype(np.int32)
    s = 16
    jl, jc = J_PREFILL(jp, cfg, {"tokens": jnp.asarray(toks[:, :s])}, 24,
                       cache_dtype=jnp.float32)
    tl, tc = t_model.prefill(tp, tcfg, {"tokens": _t(toks[:, :s])}, 24,
                             cache_dtype=torch.float32)
    assert tc["dense"].k.shape[2] == 8
    _close(tl, jl)
    _close_caches(tc, jc)
    assert t_model._cache_capacity(tcfg, tc) is None
    cl = np.int32(s)
    for i in range(24 - s - 1):
        tok = toks[:, s + i: s + i + 1]
        jl2, jc = J_DECODE_STEP(jp, cfg, jnp.asarray(tok), jc, jnp.asarray(cl))
        tl2, tc = t_model.decode_step(tp, tcfg, _t(tok), tc, _t(cl))
        _close(tl2, jl2)
        _close_caches(tc, jc)
        cl = cl + 1


def test_ring_decode_loop_freezes_slots_past_the_window():
    """decode_loop over a ring of 8 slots with per-slot lengths 12, 20 and
    9 (past the window): JAX's tokens and caches, no capacity bound, and
    the slot that finishes after 2 steps holds its ring slots bit for bit
    while the others wrap around."""
    cfg, tcfg, jp, tp = _model("granite-3-2b", sliding_window=8)
    _, first, jc = _prefilled(cfg, jp, 24, s=12)
    assert jc["dense"].k.shape[2] == 8
    cl = np.array([12, 20, 9], np.int32)
    left = np.array([6, 2, 6], np.int32)
    _check_loop(cfg, tcfg, jp, tp, first, jc, cl, left, 6)
    _assert_frozen_holds(tcfg, tp, first, jc, cl, left, 2, 6)


def test_plain_cache_of_window_capacity_decodes_as_a_ring():
    """A plain cache whose capacity equals the window is decoded into as a
    ring (JAX decides by shape), which is harmless; decode_loop then bounds
    nothing, as in JAX."""
    cfg, tcfg, jp, tp = _model("granite-3-2b", sliding_window=8)
    _, first, jc = _prefilled(cfg, jp, 8, s=6)
    cl = np.array([6, 6, 7], np.int32)
    left = np.array([4, 1, 4], np.int32)
    _check_loop(cfg, tcfg, jp, tp, first, jc, cl, left, 4)
