"""The port's model stack against the JAX package at ``smoke("deepseek-r1")``
(float32), with the same weights through ``repro_torch.convert`` and the
same seeded numpy inputs on both sides.

Tolerances: layer functions 1e-5; MLA, MoE and whole-model outputs
rtol = atol = 2e-4 (float32 through several matmuls, softmax and norms,
summed in another order than XLA's). Greedy tokens must be identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.configs import get_config as jax_get_config
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import mla as j_mla
from repro.models import model as j_model
from repro.models import moe as j_moe
from repro_torch.configs import get_config as port_get_config
from repro_torch.configs import list_configs as port_list_configs
from repro_torch.configs import smoke_variant as port_smoke
from repro_torch.convert import params_from_jax_numpy
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import mla as t_mla
from repro_torch.models import model as t_model
from repro_torch.models import moe as t_moe

TOL = 2e-4

# The JAX side runs under jit: one compiled program per call instead of
# eager op-by-op dispatch, which compiles every primitive separately.
J_MLA_PREFILL = jax.jit(j_mla.mla_prefill, static_argnums=(2,))
J_MLA_DECODE = jax.jit(j_mla.mla_decode, static_argnums=(4,))
J_MLA_EXTEND = jax.jit(j_mla.mla_extend, static_argnums=(4,))
J_PREFILL = jax.jit(j_model.prefill, static_argnums=(1, 3),
                    static_argnames=("cache_dtype",))
J_DECODE_STEP = jax.jit(j_model.decode_step, static_argnums=(1,))
J_DECODE_LOOP = jax.jit(j_model.decode_loop, static_argnums=(1, 5))
J_CONTINUE = jax.jit(j_model.prefill_continue, static_argnums=(1,))
J_ROUTE = jax.jit(j_moe.route, static_argnums=(2,))
J_MOE_REF = jax.jit(j_moe.moe_reference, static_argnums=(2,))
J_MOE_CAP = jax.jit(j_moe.moe_capacity, static_argnums=(2, 3))


@pytest.fixture(scope="module")
def r1():
    """One JAX init shared by the module, and its port twin."""
    cfg = smoke("deepseek-r1")
    tcfg = port_smoke(port_get_config("deepseek-r1"))
    jp = jax.jit(j_model.init_params, static_argnums=(1,))(
        jax.random.PRNGKey(0), cfg)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, tcfg, jp, tp


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _jax_caches_np(caches):
    return jax.tree.map(np.asarray, caches)


def _port_caches(jcaches):
    return {k: {"mla": _t(v["mla"]).clone(), "length": _t(v["length"]).clone()}
            for k, v in _jax_caches_np(jcaches).items()}


def test_config_copy_matches_jax():
    """Every config the port registers (all eleven of JAX's) is JAX's, and
    so is its smoke variant."""
    archs = port_list_configs()
    assert len(archs) == 11 and "zamba2-1.2b" in archs
    for arch in archs:
        assert dataclasses.asdict(port_get_config(arch)) == \
            dataclasses.asdict(jax_get_config(arch))
        assert dataclasses.asdict(port_smoke(port_get_config(arch))) == \
            dataclasses.asdict(smoke(arch))


def test_layers():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    pos = rng.randint(0, 300, (2, 5)).astype(np.int32)
    g = rng.randn(16).astype(np.float32)
    _close(t_layers.rms_norm(_t(x), _t(g)), j_layers.rms_norm(x, g), 1e-5)
    _close(t_layers.apply_rope(_t(x), _t(pos), 10000.0),
           j_layers.apply_rope(x, pos, 10000.0), 1e-5)
    w1, w2 = rng.randn(16, 24).astype(np.float32), rng.randn(16, 24).astype(np.float32)
    w3 = rng.randn(24, 16).astype(np.float32)
    _close(t_layers.swiglu(_t(x), _t(w1), _t(w2), _t(w3)),
           j_layers.swiglu(x, w1, w2, w3), 1e-4)


def test_attention_helpers():
    # The port's loops take a ragged last chunk, so its chunk never falls
    # below JAX's (which must divide s: 781 -> 1).
    for s in (7, 512, 640, 781, 1000, 2048):
        assert t_attn._pick_chunk(s) == min(s, 512)
        assert t_attn._pick_chunk(s) >= j_attn._pick_chunk(s)
    cl = np.array([0, 3, 9, 12], np.int32)
    for ring in (False, True):
        np.testing.assert_array_equal(
            t_attn.decode_valid_mask(_t(cl), 10, ring).numpy(),
            np.asarray(j_attn.decode_valid_mask(jnp.asarray(cl), 10, ring)))
    rng = np.random.RandomState(1)
    cache = rng.randn(4, 10, 6).astype(np.float32)
    new = rng.randn(4, 1, 6).astype(np.float32)
    for slot in (cl, np.int32(12), np.int32(4)):   # per-row drop / scalar clamp
        want = j_attn.update_cache(jnp.asarray(cache), jnp.asarray(new),
                                   jnp.asarray(slot))
        got = t_attn.update_cache(_t(cache).clone(), _t(new), _t(slot))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


@pytest.mark.parametrize("s,block_skip", [(12, False), (12, True),
                                          (640, False), (640, True),
                                          (781, False), (781, True)])
def test_mla_prefill(r1, monkeypatch, s, block_skip):
    cfg, tcfg, jp, tp = r1
    monkeypatch.setenv("REPRO_BLOCK_SKIP", "1" if block_skip else "0")
    jl = _layer(jp["segments"]["dense_lead"]["attn"], 0)
    tl = tp.segments["dense_lead"][0].attn
    b = 2 if s < 100 else 1
    x = np.random.RandomState(s).randn(b, s, cfg.d_model).astype(np.float32)
    jo, jlat = J_MLA_PREFILL(jl, jnp.asarray(x), cfg)
    to, tlat = t_mla.mla_prefill(tl, _t(x), tcfg)
    _close(to, jo)
    _close(tlat, jlat)


@pytest.mark.parametrize("per_row", [False, True])
def test_mla_decode(r1, per_row):
    cfg, tcfg, jp, tp = r1
    jl = _layer(jp["segments"]["moe"]["attn"], 0)
    tl = tp.segments["moe"][0].attn
    rng = np.random.RandomState(2)
    w = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    cache = rng.randn(3, 24, w).astype(np.float32)
    x = rng.randn(3, 1, cfg.d_model).astype(np.float32)
    cl = np.array([5, 0, 23], np.int32) if per_row else np.int32(9)
    jo, jc = J_MLA_DECODE(jl, jnp.asarray(x), jnp.asarray(cache),
                              jnp.asarray(cl), cfg)
    to, tc = t_mla.mla_decode(tl, _t(x), _t(cache).clone(), _t(cl), tcfg)
    _close(to, jo)
    _close(tc, jc)


@pytest.mark.parametrize("offset", [np.int32(4), np.array([0, 7, 21], np.int32)])
def test_mla_extend(r1, offset):
    """Scalar and per-request offsets; the third row's positions run past
    the cache and those rows are dropped, as the JAX scatter drops them."""
    cfg, tcfg, jp, tp = r1
    jl = _layer(jp["segments"]["dense_lead"]["attn"], 0)
    tl = tp.segments["dense_lead"][0].attn
    rng = np.random.RandomState(3)
    w = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    cache = rng.randn(3, 24, w).astype(np.float32)
    x = rng.randn(3, 5, cfg.d_model).astype(np.float32)
    jo, jc = J_MLA_EXTEND(jl, jnp.asarray(x), jnp.asarray(cache),
                              jnp.asarray(offset), cfg)
    to, tc = t_mla.mla_extend(tl, _t(x), _t(cache).clone(), _t(offset), tcfg)
    _close(tc, jc)
    # Queries at dropped positions still attend to the whole cache.
    _close(to, jo)


def test_route_and_moe(r1):
    cfg, tcfg, jp, tp = r1
    jl = _layer(jp["segments"]["moe"]["moe"], 0)
    tl = tp.segments["moe"][0].moe
    x = np.random.RandomState(4).randn(64, cfg.d_model).astype(np.float32)
    ji, jpr, jaux = J_ROUTE(jl["router"], jnp.asarray(x), cfg)
    ti, tpr, taux = t_moe.route(tl.router, _t(x), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tpr, jpr, 1e-5)
    _close(taux, jaux, 1e-5)
    jo, _ = J_MOE_REF(jl, jnp.asarray(x), cfg)
    to, _ = t_moe.moe_reference(tl, _t(x), tcfg)
    _close(to, jo)
    for cap in (None, 8):                 # cap 8 of 64x2/4 tokens drops many
        jo, jaux = J_MOE_CAP(jl, jnp.asarray(x), cfg, cap)
        to, taux = t_moe.moe_capacity(tl, _t(x), tcfg, cap)
        _close(to, jo)
        assert int(taux["dropped"]) == int(jaux["dropped"])
    assert int(taux["dropped"]) > 0


def test_route_breaks_ties_like_jax(r1):
    """Duplicated router columns give exactly equal probabilities; both
    sides must pick the lower expert index first."""
    cfg, tcfg, _, _ = r1
    rng = np.random.RandomState(5)
    col = rng.randn(cfg.d_model, 1).astype(np.float32)
    router = np.concatenate([col, col, 0.5 * col, col], axis=1)
    x = rng.randn(16, cfg.d_model).astype(np.float32)
    ji, jpr, _ = J_ROUTE(jnp.asarray(router), jnp.asarray(x), cfg)
    ti, tpr, _ = t_moe.route(_t(router), _t(x), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tpr, jpr, 1e-6)


def test_capacity_and_dispatch_indices(r1):
    cfg, tcfg, _, _ = r1
    for t in (1, 8, 64, 1000):
        assert t_moe.capacity_for(tcfg, t) == j_moe.capacity_for(cfg, t)
    top_i = np.random.RandomState(6).randint(0, 4, (32, 2)).astype(np.int32)
    js, jv = j_moe.dispatch_indices(jnp.asarray(top_i), 4, 12)
    ts, tv = t_moe.dispatch_indices(_t(top_i).long(), 4, 12)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_prefill_and_decode_step(r1):
    cfg, tcfg, jp, tp = r1
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 16)
                                            ).astype(np.int32)
    jl, jc = J_PREFILL(jp, cfg, {"tokens": jnp.asarray(toks)}, 24,
                             cache_dtype=jnp.float32)
    tl, tc = t_model.prefill(tp, tcfg, {"tokens": _t(toks)}, 24,
                             cache_dtype=torch.float32)
    _close(tl, jl)
    for name in jc:
        _close(tc[name]["mla"], jc[name]["mla"])
        assert int(tc[name]["length"]) == int(jc[name]["length"])
    nxt = np.array([[3], [900]], np.int32)
    for cl in (np.int32(16), np.array([16, 9], np.int32)):
        jl2, jc2 = J_DECODE_STEP(jp, cfg, jnp.asarray(nxt), jc,
                                       jnp.asarray(cl))
        tl2, tc2 = t_model.decode_step(tp, tcfg, _t(nxt), _port_caches(jc),
                                       _t(cl))
        _close(tl2, jl2)
        for name in jc2:
            _close(tc2[name]["mla"], jc2[name]["mla"])
            np.testing.assert_array_equal(tc2[name]["length"].numpy(),
                                          np.asarray(jc2[name]["length"]))


def _prefilled(cfg, tcfg, jp, tp, cap):
    rng = np.random.RandomState(8)
    toks = rng.randint(0, cfg.vocab_size, (3, 10)).astype(np.int32)
    jl, jc = J_PREFILL(jp, cfg, {"tokens": jnp.asarray(toks)}, cap,
                             cache_dtype=jnp.float32)
    first = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    return first, jc


def test_decode_loop_matches_jax_and_per_step(r1):
    """decode_loop with done/capacity masks against JAX, and token-identical
    to per-step decode_step with the same freezing rules."""
    cfg, tcfg, jp, tp = r1
    cap = 16
    first, jc = _prefilled(cfg, tcfg, jp, tp, cap)
    cl = np.array([10, 10, 14], np.int32)     # slot 2 hits capacity mid-loop
    left = np.array([5, 2, 5], np.int32)      # slot 1 finishes early
    jem, jlv, jtok, jcs, jcl = J_DECODE_LOOP(
        jp, cfg, jnp.asarray(first), jc, jnp.asarray(cl), 5,
        steps_left=jnp.asarray(left))
    tem, tlv, ttok, tcs, tcl = t_model.decode_loop(
        tp, tcfg, _t(first), _port_caches(jc), _t(cl), 5,
        steps_left=_t(left))
    np.testing.assert_array_equal(tlv.numpy(), np.asarray(jlv))
    np.testing.assert_array_equal(np.where(tlv.numpy(), tem.numpy(), -1),
                                  np.where(np.asarray(jlv), np.asarray(jem), -1))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tcl.numpy(), np.asarray(jcl))
    for name in jcs:
        _close(tcs[name]["mla"], jcs[name]["mla"])

    # Per-step reference in the port: live slots step, frozen ones hold.
    caches, tok, length = _port_caches(jc), _t(first), _t(cl)
    steps = _t(left)
    for j in range(5):
        live = (steps > 0) & (length < cap)
        logits, caches = t_model.decode_step(tp, tcfg, tok[:, None], caches,
                                             length)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        np.testing.assert_array_equal(live.numpy(), tlv[:, j].numpy())
        np.testing.assert_array_equal(nxt[live].numpy(), tem[live, j].numpy())
        tok = torch.where(live, nxt, tok)
        length = length + live.int()
        steps = steps - live.int()


def test_decode_loop_chunk_split_invariance(r1):
    cfg, tcfg, jp, tp = r1
    first, jc = _prefilled(cfg, tcfg, jp, tp, 24)
    cl = np.full(3, 10, np.int32)
    em6, *_ = t_model.decode_loop(tp, tcfg, _t(first), _port_caches(jc),
                                  _t(cl), 6)
    em_a, _, tok, cs, length = t_model.decode_loop(
        tp, tcfg, _t(first), _port_caches(jc), _t(cl), 2)
    em_b, *_ = t_model.decode_loop(tp, tcfg, tok, cs, length, 4)
    np.testing.assert_array_equal(em6.numpy(),
                                  torch.cat([em_a, em_b], 1).numpy())


@pytest.mark.parametrize("offset", [np.int32(10), np.array([10, 6, 3], np.int32)])
def test_prefill_continue(r1, offset):
    cfg, tcfg, jp, tp = r1
    assert t_model.supports_prefill_continue(tcfg, 24) == \
        j_model.supports_prefill_continue(cfg, 24)
    _, jc = _prefilled(cfg, tcfg, jp, tp, 24)
    toks = np.random.RandomState(9).randint(0, cfg.vocab_size, (3, 4)
                                            ).astype(np.int32)
    jl, jc2 = J_CONTINUE(jp, cfg, jnp.asarray(toks), jc,
                                       jnp.asarray(offset))
    tl, tc2 = t_model.prefill_continue(tp, tcfg, _t(toks), _port_caches(jc),
                                       _t(offset))
    _close(tl, jl)
    for name in jc2:
        _close(tc2[name]["mla"], jc2[name]["mla"])
        np.testing.assert_array_equal(tc2[name]["length"].numpy(),
                                      np.asarray(jc2[name]["length"]))


def test_cache_structure(r1):
    cfg, tcfg, _, _ = r1
    jc = j_model.make_caches(cfg, 2, 8)
    tc = t_model.make_caches(tcfg, 2, 8, device="cpu")
    assert set(tc) == set(jc)
    for name in jc:
        assert tuple(tc[name]["mla"].shape) == jc[name]["mla"].shape
        assert tc[name]["mla"].dtype == torch.bfloat16
    assert t_model.cache_batch_axes(tcfg) == j_model.cache_batch_axes(cfg)
    lens = torch.tensor([3, 4], dtype=torch.int32)
    for c in t_model._with_lengths(tcfg, tc, lens).values():
        assert c["length"] is lens


def test_other_families_name_their_slice(r1):
    """Every family builds the JAX package's segment plan: the frontends
    and the hybrid no longer name a slice of the port that is to come."""
    cfg, tcfg, _, _ = r1
    for change in (dict(attention_kind="bidirectional",
                        frontend="audio_frames"),
                   dict(ssm_state=16, attn_every=2),
                   dict(ssm_state=16, attn_every=2, num_layers=5),
                   dict(ssm_state=16, num_heads=0),
                   dict(frontend="vision_patches")):
        plan = t_model.build_plan(dataclasses.replace(tcfg, **change))
        assert [dataclasses.astuple(s) for s in plan] == \
            [dataclasses.astuple(s) for s in j_model.build_plan(
                dataclasses.replace(cfg, **change))]
    # Pure SSM configs: one Mamba segment.
    plan = t_model.build_plan(dataclasses.replace(tcfg, ssm_state=16,
                                                  num_heads=0))
    assert [(s.name, s.kind) for s in plan] == [("mamba", "mamba_tail")]


def test_init_params_shapes_match_jax(r1):
    """The port's own seeded init builds the same parameter tree (names,
    shapes, dtypes) as the JAX init it cannot share random numbers with."""
    cfg, tcfg, jp, _ = r1
    tp = t_model.init_params(tcfg, seed=1, device="cpu")
    jflat = {}
    for seg, layers in jp["segments"].items():
        for part, leaves in layers.items():
            for name, a in leaves.items():
                jflat[f"segments.{seg}.{part}.{name}"] = (a.shape[1:], a.dtype)
    tflat = {}
    for name, p in tp.named_parameters():
        if name.startswith("segments."):
            _, seg, idx, part, leaf = name.split(".")
            tflat[f"segments.{seg}.{part}.{leaf}"] = (tuple(p.shape),
                                                      str(p.dtype))
    assert set(tflat) == set(jflat)
    for k, (shape, dt) in jflat.items():
        assert tflat[k][0] == shape
        assert tflat[k][1] == f"torch.{np.dtype(dt).name}"
