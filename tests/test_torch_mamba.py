"""The port's Mamba2 stack against the JAX package at
``smoke("mamba2-780m")`` (float32), with the same weights through
``repro_torch.convert`` and the same seeded numpy inputs on both sides.

Tolerances: the Mamba block and whole-model outputs rtol = atol = 2e-4
(float32 through projections, the SSD scan, norms and the tied head,
summed in another order than XLA's), as for the MLA stack. Greedy tokens
must be identical, frozen slots bit-exact, and cache dtypes equal.

At prompt lengths the SSD chunk (32 here) does not divide, JAX halves the
chunk (to 1 for odd lengths) and the port takes a ragged last chunk; the
comparisons below include such lengths.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.configs import get_config as jax_get_config
from repro.models import mamba2 as j_mamba
from repro.models import model as j_model
from repro.serving import cache_ops as j_cache_ops
from repro_torch.configs import get_config as port_get_config
from repro_torch.configs import smoke_variant as port_smoke
from repro_torch.convert import param_tree, params_from_jax_numpy
from repro_torch.models import mamba2 as t_mamba
from repro_torch.models import model as t_model
from repro_torch.serving import cache_ops as t_cache_ops
from repro_torch.tree import tree_leaves, tree_map

TOL = 2e-4

J_MAMBA_PREFILL = jax.jit(j_mamba.mamba_prefill, static_argnums=(2,))
J_MAMBA_DECODE = jax.jit(j_mamba.mamba_decode, static_argnums=(4,))
J_PREFILL = jax.jit(j_model.prefill, static_argnums=(1, 3),
                    static_argnames=("cache_dtype",))
J_DECODE_STEP = jax.jit(j_model.decode_step, static_argnums=(1,))
J_DECODE_LOOP = jax.jit(j_model.decode_loop, static_argnums=(1, 5))


@pytest.fixture(scope="module")
def m2():
    """One JAX init shared by the module, and its port twin."""
    cfg = smoke("mamba2-780m")
    tcfg = port_smoke(port_get_config("mamba2-780m"))
    jp = jax.jit(j_model.init_params, static_argnums=(1,))(
        jax.random.PRNGKey(0), cfg)
    # Non-trivial dt_bias, A_log, D and conv bias (the init leaves them 0 or
    # 1), so the test sees every weight move the output.
    rng = np.random.RandomState(42)
    mp = dict(jp["segments"]["mamba"]["mamba"])
    for name in ("dt_bias", "A_log", "conv_b"):
        mp[name] = jnp.asarray(0.3 * rng.randn(*mp[name].shape), mp[name].dtype)
    mp["D"] = jnp.asarray(1 + 0.3 * rng.randn(*mp["D"].shape), jnp.float32)
    jp = {**jp, "segments": {"mamba": {"mamba": mp}}}
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, tcfg, jp, tp


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _port_state(jstate):
    """A JAX SSMState as the port's, with the same dtypes."""
    def conv(a):
        a = np.asarray(a)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return t_mamba.SSMState(_t(jstate.h), conv(jstate.conv),
                            _t(jstate.length))


def _port_caches(jcaches):
    return {k: _port_state(v) for k, v in jcaches.items()}


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def test_config_copy_matches_jax():
    assert dataclasses.asdict(port_get_config("mamba2-780m")) == \
        dataclasses.asdict(jax_get_config("mamba2-780m"))
    assert dataclasses.asdict(port_smoke(port_get_config("mamba2-780m"))) == \
        dataclasses.asdict(smoke("mamba2-780m"))


def test_tree_map_rebuilds_named_tuples():
    """The SSM state is a NamedTuple: tree_map must rebuild it (by field),
    and leaves come out in field order h, conv, length, as jax.tree does."""
    st = t_mamba.SSMState(torch.ones(2), torch.zeros(3), torch.tensor(4))
    out = tree_map(lambda a, b: a + b, {"m": st}, {"m": st})
    assert isinstance(out["m"], t_mamba.SSMState)
    assert out["m"].h.tolist() == [2.0, 2.0] and int(out["m"].length) == 8
    assert [tuple(x.shape) for x in tree_leaves({"m": st})] == [(2,), (3,), ()]
    jst = j_mamba.SSMState(np.ones(2), np.zeros(3), np.int32(4))
    assert [np.shape(x) for x in jax.tree.leaves({"m": jst})] == \
        [tuple(x.shape) for x in tree_leaves({"m": st})]


@pytest.mark.parametrize("s", [2, 12, 37, 64])
def test_mamba_prefill(m2, s):
    cfg, tcfg, jp, tp = m2
    jl = _layer(jp["segments"]["mamba"]["mamba"], 1)
    tl = tp.segments["mamba"][1].mamba
    b = 2
    x = np.random.RandomState(s).randn(b, s, cfg.d_model).astype(np.float32)
    jo, jh, jc = J_MAMBA_PREFILL(jl, jnp.asarray(x), cfg)
    to, th, tc = t_mamba.mamba_prefill(tl, _t(x), tcfg)
    _close(to, jo)
    _close(th, jh)
    _close(tc, jc)


def test_mamba_decode(m2):
    cfg, tcfg, jp, tp = m2
    jl = _layer(jp["segments"]["mamba"]["mamba"], 0)
    tl = tp.segments["mamba"][0].mamba
    rng = np.random.RandomState(2)
    din = cfg.d_model * cfg.ssm_expand
    x = rng.randn(3, 1, cfg.d_model).astype(np.float32)
    h = rng.randn(3, cfg.ssm_heads, cfg.ssm_head_dim,
                  cfg.ssm_state).astype(np.float32)
    conv = rng.randn(3, cfg.ssm_conv - 1, din + 2 * cfg.ssm_state
                     ).astype(np.float32)
    jo, jh, jc = J_MAMBA_DECODE(jl, jnp.asarray(x), jnp.asarray(h),
                                jnp.asarray(conv), cfg)
    to, th, tc = t_mamba.mamba_decode(tl, _t(x), _t(h), _t(conv), tcfg)
    _close(to, jo)
    _close(th, jh)
    _close(tc, jc)


def _prefilled(cfg, jp, s=37, b=3, seed=8):
    toks = np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, s)
                                               ).astype(np.int32)
    jl, jc = J_PREFILL(jp, cfg, {"tokens": jnp.asarray(toks)}, 48,
                       cache_dtype=jnp.float32)
    first = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    return toks, jl, jc, first


@pytest.mark.parametrize("s", [32, 37])
def test_prefill_and_decode_step(m2, s):
    cfg, tcfg, jp, tp = m2
    toks, jl, jc, first = _prefilled(cfg, jp, s=s, b=2)
    tl, tc = t_model.prefill(tp, tcfg, {"tokens": _t(toks)}, 48,
                             cache_dtype=torch.float32)
    _close(tl, jl)
    assert np.array_equal(tl[:, -1].argmax(-1).numpy(), first)
    st, jst = tc["mamba"], jc["mamba"]
    assert isinstance(st, t_mamba.SSMState)
    _close(st.h, jst.h)
    _close(st.conv, np.asarray(jst.conv, np.float32), 1e-2)   # bf16 storage
    assert [_dtype_name(x) for x in st] == \
        [str(np.asarray(x).dtype) for x in jst] == \
        ["float32", "bfloat16", "int32"]
    assert int(st.length) == int(jst.length) == s
    nxt = first[:, None]
    for cl in (np.int32(s), np.array([s, s], np.int32)):
        jl2, jc2 = J_DECODE_STEP(jp, cfg, jnp.asarray(nxt), jc,
                                 jnp.asarray(cl))
        tl2, tc2 = t_model.decode_step(tp, tcfg, _t(nxt), _port_caches(jc),
                                       _t(cl))
        _close(tl2, jl2)
        assert np.array_equal(tl2.argmax(-1).numpy(),
                              np.asarray(jnp.argmax(jl2, -1)))
        st2, jst2 = tc2["mamba"], jc2["mamba"]
        _close(st2.h, jst2.h)
        _close(st2.conv, jst2.conv)
        # An f32 model's first step turns the conv window f32, as in JAX.
        assert [_dtype_name(x) for x in st2] == \
            [str(np.asarray(x).dtype) for x in jst2] == \
            ["float32", "float32", "int32"]
        np.testing.assert_array_equal(st2.length.numpy(),
                                      np.asarray(jst2.length))


def test_bf16_model_keeps_a_bf16_conv_window(m2):
    """In a bfloat16 model the conv window stays bfloat16 through decode,
    and the decode engine's buffers have the dtypes decode produces (the
    JAX side checked by shape evaluation alone)."""
    cfg, tcfg, jp, _ = m2
    jcfg = dataclasses.replace(cfg, dtype="bfloat16")
    bcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    tp = t_model.init_params(bcfg, seed=0, device="cpu")
    toks = torch.tensor([[5, 9, 200, 7, 1]], dtype=torch.int32)
    _, tc = t_model.prefill(tp, bcfg, {"tokens": toks}, 16,
                            cache_dtype=torch.float32)
    _, tc2 = t_model.decode_step(tp, bcfg, toks[:, :1], tc, torch.tensor(5))
    jparams = jax.eval_shape(lambda k: j_model.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    _, jc = jax.eval_shape(
        lambda p, t: j_model.prefill(p, jcfg, {"tokens": t}, 16,
                                     cache_dtype=jnp.float32),
        jparams, jnp.zeros((1, 5), jnp.int32))
    _, jc2 = jax.eval_shape(
        lambda p, t, c: j_model.decode_step(p, jcfg, t, c, jnp.int32(5)),
        jparams, jnp.zeros((1, 1), jnp.int32), jc)
    for port, jax_ in ((tc, jc), (tc2, jc2)):
        assert [_dtype_name(x) for x in port["mamba"]] == \
            [str(x.dtype) for x in jax_["mamba"]]
    assert tc2["mamba"].conv.dtype == torch.bfloat16
    ready = t_model.decode_ready_caches(
        bcfg, t_model.make_caches(bcfg, 2, 16, torch.float32, "cpu"))
    jready = jax.eval_shape(
        lambda p: j_model.decode_ready_caches(
            p, jcfg, j_model.make_caches(jcfg, 2, 16, jnp.float32),
            jnp.zeros((2,), jnp.int32)), jparams)
    assert [_dtype_name(x) for x in ready["mamba"][:2]] == \
        [str(x.dtype) for x in jready["mamba"][:2]] == ["float32", "bfloat16"]


def test_decode_loop_matches_jax_and_freezes_slots(m2):
    """decode_loop with per-slot budgets against JAX; a slot with no budget
    holds its state bit-exactly, and one that finishes early holds the
    state of its last live step."""
    cfg, tcfg, jp, tp = m2
    _, _, jc, first = _prefilled(cfg, jp)
    cl = np.full(3, 37, np.int32)
    left = np.array([5, 2, 0], np.int32)
    jem, jlv, jtok, jcs, jcl = J_DECODE_LOOP(
        jp, cfg, jnp.asarray(first), jc, jnp.asarray(cl), 5,
        steps_left=jnp.asarray(left))
    start = _port_caches(jc)
    tem, tlv, ttok, tcs, tcl = t_model.decode_loop(
        tp, tcfg, _t(first), _port_caches(jc), _t(cl), 5,
        steps_left=_t(left))
    np.testing.assert_array_equal(tlv.numpy(), np.asarray(jlv))
    np.testing.assert_array_equal(np.where(tlv.numpy(), tem.numpy(), -1),
                                  np.where(np.asarray(jlv), np.asarray(jem), -1))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tcl.numpy(), np.asarray(jcl))
    st, jst = tcs["mamba"], jcs["mamba"]
    _close(st.h, jst.h)
    _close(st.conv, jst.conv)
    assert [_dtype_name(x) for x in st] == \
        [str(np.asarray(x).dtype) for x in jst]
    # Slot 2 never ran: bit-exact (its conv window exactly upcast).
    assert torch.equal(st.h[:, 2], start["mamba"].h[:, 2])
    assert torch.equal(st.conv[:, 2], start["mamba"].conv[:, 2].float())
    # Slot 1 holds what two steps left it with.
    _, _, _, two, _ = t_model.decode_loop(tp, tcfg, _t(first),
                                          _port_caches(jc), _t(cl), 2)
    assert torch.equal(st.h[:, 1], two["mamba"].h[:, 1])
    assert torch.equal(st.conv[:, 1], two["mamba"].conv[:, 1])


def test_decode_loop_chunk_split_invariance(m2):
    cfg, tcfg, jp, tp = m2
    _, _, jc, first = _prefilled(cfg, jp)
    cl = np.full(3, 37, np.int32)
    em6, *_ = t_model.decode_loop(tp, tcfg, _t(first), _port_caches(jc),
                                  _t(cl), 6)
    em_a, _, tok, cs, length = t_model.decode_loop(
        tp, tcfg, _t(first), _port_caches(jc), _t(cl), 2)
    em_b, *_ = t_model.decode_loop(tp, tcfg, tok, cs, length, 4)
    np.testing.assert_array_equal(em6.numpy(),
                                  torch.cat([em_a, em_b], 1).numpy())


def test_cache_structure(m2):
    cfg, tcfg, _, _ = m2
    jc = j_model.make_caches(cfg, 2, 8)
    tc = t_model.make_caches(tcfg, 2, 8, device="cpu")
    assert set(tc) == set(jc) == {"mamba"}
    assert [tuple(x.shape) for x in tc["mamba"]] == \
        [x.shape for x in jc["mamba"]]
    assert [_dtype_name(x) for x in tc["mamba"]] == \
        [str(x.dtype) for x in jc["mamba"]]
    axes, jaxes = t_model.cache_batch_axes(tcfg), j_model.cache_batch_axes(cfg)
    assert isinstance(axes["mamba"], t_mamba.SSMState)
    assert tuple(axes["mamba"]) == tuple(jaxes["mamba"]) == (1, 1, None)
    lens = torch.tensor([3, 4], dtype=torch.int32)
    assert t_model._with_lengths(tcfg, tc, lens)["mamba"].length is lens
    assert t_model._cache_capacity(tcfg, tc) is None
    assert j_model._cache_capacity(cfg, jc) is None
    assert t_model.supports_prefill_continue(tcfg, 24) is \
        j_model.supports_prefill_continue(cfg, 24) is False
    with pytest.raises(NotImplementedError):
        t_model.prefill_continue(None, tcfg, torch.zeros((1, 2), dtype=torch.int32),
                                 tc, 0)


def test_param_tree_round_trip(m2):
    """param_tree lays the port's weights out as the JAX tree (the mamba
    segment under ``segments.mamba.mamba``, the tied embedding)."""
    _, tcfg, jp, tp = m2
    tree = param_tree(tp)
    assert "lm_head" not in tree and "lm_head" not in jp
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jflat:
        node = tree
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("conv_dtype", ["float32", "bfloat16"])
def test_pack_request_bytes_equal_jax(m2, conv_dtype):
    """A request's SSM state serializes to JAX's bytes (h, then conv) and
    round-trips bit-exactly into another slot."""
    cfg, tcfg, _, _ = m2
    rng = np.random.RandomState(5)
    jc = j_model.make_caches(cfg, 3, 8)
    h = rng.randn(*jc["mamba"].h.shape).astype(np.float32)
    conv = jnp.asarray(rng.randn(*jc["mamba"].conv.shape), conv_dtype)
    jc = {"mamba": j_mamba.SSMState(jnp.asarray(h), conv, jnp.int32(7))}
    tc = _port_caches(jc)
    want = j_cache_ops.pack_request(cfg, j_cache_ops.slice_request(cfg, jc, 1))
    req = t_cache_ops.slice_request(tcfg, tc, 1)
    got = t_cache_ops.pack_request(tcfg, req)
    np.testing.assert_array_equal(got, want)
    back = t_cache_ops.unpack_request(
        tcfg, got, t_cache_ops.slice_request(tcfg, tc, 0))
    dst = tree_map(lambda x: torch.zeros_like(x), tc)
    t_cache_ops.insert_request(tcfg, dst, back, 2)
    assert torch.equal(dst["mamba"].h[:, 2], tc["mamba"].h[:, 1])
    assert torch.equal(dst["mamba"].conv[:, 2], tc["mamba"].conv[:, 1])
    assert t_cache_ops.seq_slice(tcfg, tc, 0, 4) == {} == \
        j_cache_ops.seq_slice(cfg, jc, 0, 4)


def test_init_params_shapes_match_jax(m2):
    cfg, tcfg, jp, _ = m2
    tp = t_model.init_params(tcfg, seed=1, device="cpu")
    jflat = {f"segments.mamba.mamba.{k}": (v.shape[1:], v.dtype)
             for k, v in jp["segments"]["mamba"]["mamba"].items()}
    tflat = {}
    for name, p in tp.named_parameters():
        if name.startswith("segments."):
            _, seg, _, part, leaf = name.split(".")
            tflat[f"segments.{seg}.{part}.{leaf}"] = (tuple(p.shape),
                                                      str(p.dtype))
    assert set(tflat) == set(jflat)
    for k, (shape, dt) in jflat.items():
        assert tflat[k][0] == shape
        assert tflat[k][1] == f"torch.{np.dtype(dt).name}"
    ml = tp.segments["mamba"][0].mamba
    assert not ml.conv_b.any() and not ml.dt_bias.any() and not ml.A_log.any()
    assert bool((ml.D == 1).all())
