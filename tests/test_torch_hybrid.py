"""The port's Zamba2 hybrid against the JAX package (float32, the same
weights through ``repro_torch.convert`` and the same seeded numpy inputs on
both sides), at ``smoke("zamba2-1.2b")`` -- one group of two Mamba layers
and the shared attention block, no tail -- and at a variant of it with five
layers: two groups, each followed by the *shared* block with its own K/V,
then a tail of one Mamba layer. Only the second catches a port that keeps
one K/V cache for the shared block, or that drops the tail.

Tolerances: logits, SSM states and K/V rtol = atol = 2e-4 (float32 through
projections, the SSD scan, attention, norms and the tied head, summed in
another order than XLA's), as for the MLA, Mamba2 and GQA stacks. A conv
window that prefill stores in bfloat16 (as JAX does, whatever the cache
dtype) is held within 1e-2, a bf16 ulp of the unit-scale window. Greedy
and MTP tokens, liveness and lengths must be identical, frozen slots bit
for bit, cache dtypes equal and ``pack_request`` bytes equal to JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.configs import get_config as jax_get_config
from repro.core import mtp as j_mtp
from repro.models import attention as j_attn
from repro.models import mamba2 as j_mamba
from repro.models import model as j_model
from repro.serving import cache_ops as j_cache_ops
from repro_torch.configs import get_config as port_get_config
from repro_torch.configs import smoke_variant as port_smoke
from repro_torch.convert import (mtp_from_jax_numpy, param_tree,
                                 params_from_jax_numpy)
from repro_torch.models import model as t_model
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba2 import SSMState
from repro_torch.serving import cache_ops as t_cache_ops
from repro_torch.tree import tree_leaves, tree_map

TOL = 2e-4
CONV_TOL = 1e-2
CAPACITY = 48

J_PREFILL = jax.jit(j_model.prefill, static_argnums=(1, 3),
                    static_argnames=("cache_dtype",))
J_DECODE_STEP = jax.jit(j_model.decode_step, static_argnums=(1,))
J_DECODE_LOOP = jax.jit(j_model.decode_loop, static_argnums=(1, 5))
J_FORWARD = jax.jit(j_model.forward, static_argnums=(1,))

#: the smoke variant (one group, no tail) and five layers (two groups of
#: two, then a tail of one)
VARIANTS = {"smoke": {}, "two_groups_and_tail": {"num_layers": 5}}


@pytest.fixture(scope="module", params=list(VARIANTS))
def zb(request):
    """One JAX init per variant and its port twin, with non-trivial
    dt_bias, A_log, D and conv bias (the init leaves them 0 or 1) and
    non-unit norm gains, so that every weight moves the output."""
    upd = VARIANTS[request.param]
    cfg = dataclasses.replace(smoke("zamba2-1.2b"), **upd)
    tcfg = dataclasses.replace(port_smoke(port_get_config("zamba2-1.2b")),
                               **upd)
    jp = jax.jit(j_model.init_params, static_argnums=(1,))(
        jax.random.PRNGKey(0), cfg)
    rng = np.random.RandomState(42)

    def perturb(path, a):
        name = path[-1].key
        if name in ("dt_bias", "A_log", "conv_b"):
            return jnp.asarray(0.3 * rng.randn(*a.shape), a.dtype)
        if name in ("D", "ln", "norm_gain"):
            return jnp.asarray(1 + 0.3 * rng.randn(*a.shape), a.dtype)
        return a

    jp = jax.tree_util.tree_map_with_path(perturb, jp)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, tcfg, jp, tp


def _t(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _port_tree(node):
    """A JAX cache tree as the port's (KVCache / SSMState / dicts of
    tensors, copies, the same dtypes)."""
    if isinstance(node, dict):
        return {k: _port_tree(v) for k, v in node.items()}
    if isinstance(node, j_attn.KVCache):
        return KVCache(*(_port_tree(x) for x in node))
    if isinstance(node, j_mamba.SSMState):
        return SSMState(*(_port_tree(x) for x in node))
    return _t(node)


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_caches(tc, jc):
    """Every cache leaf in JAX's order: shapes and dtypes equal, values
    close (a bf16 conv window within a bf16 ulp), lengths equal."""
    jleaves = jax.tree_util.tree_flatten_with_path(jc)[0]
    tleaves = tree_leaves(tc)
    assert len(tleaves) == len(jleaves)
    for (path, jl), tl in zip(jleaves, tleaves):
        name = jax.tree_util.keystr(path)
        assert tuple(tl.shape) == np.shape(jl), name
        assert _dtype_name(tl) == str(np.asarray(jl).dtype), name
        if "length" in name:
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl), name)
        else:
            _close(tl, jl, CONV_TOL if tl.dtype == torch.bfloat16 else TOL)


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, s)
                                               ).astype(np.int32)


def _prefilled(zb, s=37, b=3, capacity=CAPACITY, seed=8):
    cfg, tcfg, jp, tp = zb
    toks = _tokens(cfg, b, s, seed)
    jl, jc = J_PREFILL(jp, cfg, {"tokens": jnp.asarray(toks)}, capacity,
                       cache_dtype=jnp.float32)
    tl, tc = t_model.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                             capacity, cache_dtype=torch.float32)
    first = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    return toks, (jl, jc), (tl, tc), first


def test_config_copy_matches_jax():
    assert dataclasses.asdict(port_get_config("zamba2-1.2b")) == \
        dataclasses.asdict(jax_get_config("zamba2-1.2b"))
    assert dataclasses.asdict(port_smoke(port_get_config("zamba2-1.2b"))) \
        == dataclasses.asdict(smoke("zamba2-1.2b"))


def test_plan_and_cache_structure(zb):
    """The plan, every cache leaf's shape and dtype in JAX's order, the
    batch axes, the capacity (plain and ring) and the eligibility gates."""
    cfg, tcfg, _, tp = zb
    assert [dataclasses.astuple(s) for s in t_model.build_plan(tcfg)] == \
        [dataclasses.astuple(s) for s in j_model.build_plan(cfg)]
    for capacity in (CAPACITY, 96):              # 96 > window 64: a ring
        jc = j_model.make_caches(cfg, 2, capacity, jnp.float32)
        tc = t_model.make_caches(tcfg, 2, capacity, torch.float32, "cpu")
        assert [(tuple(x.shape), _dtype_name(x)) for x in tree_leaves(tc)] \
            == [(x.shape, str(x.dtype)) for x in jax.tree.leaves(jc)]
        assert t_model._cache_capacity(tcfg, tc) == \
            j_model._cache_capacity(cfg, jc)
    assert t_model._cache_capacity(tcfg, tc) is None           # the ring
    axes = t_model.cache_batch_axes(tcfg)
    assert axes["mamba_groups"]["ssm"] == {"h": 2, "conv": 2, "length": None}
    assert jax.tree.leaves(j_model.cache_batch_axes(cfg)) == \
        tree_leaves(axes)
    assert t_model.supports_prefill_continue(tcfg, CAPACITY) is \
        j_model.supports_prefill_continue(cfg, CAPACITY) is False
    with pytest.raises(NotImplementedError):
        t_model.prefill_continue(tp, tcfg, torch.zeros((1, 2),
                                                       dtype=torch.int32),
                                 tc, 0)
    lens = torch.tensor([3, 4], dtype=torch.int32)
    g = t_model._with_lengths(tcfg, tc, lens)["mamba_groups"]
    assert g["length"] is lens and g["ssm"]["length"] is lens
    assert g["shared_kv"].length is lens


@pytest.mark.parametrize("s", [32, 37])
def test_prefill_and_forward(zb, s):
    """Prefill logits and every cache leaf; ``forward``'s logits equal
    prefill's (one code path) and JAX's."""
    cfg, tcfg, jp, tp = zb
    toks, (jl, jc), (tl, tc), first = _prefilled(zb, s=s)
    _close(tl, jl)
    assert np.array_equal(tl[:, -1].argmax(-1).numpy(), first)
    _close_caches(tc, jc)
    # The group conv window is bf16 whatever the cache dtype, as in JAX.
    assert tc["mamba_groups"]["ssm"]["conv"].dtype == torch.bfloat16
    fl, aux = t_model.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    jfl, jaux = J_FORWARD(jp, cfg, {"tokens": jnp.asarray(toks)})
    assert torch.equal(fl, tl)
    _close(fl, jfl)
    assert float(aux["aux_loss"]) == float(jaux["aux_loss"]) == 0.0


def test_decode_step(zb):
    cfg, tcfg, jp, tp = zb
    s = 37
    _, (_, jc), _, first = _prefilled(zb, s=s)
    nxt = first[:, None]
    for cl in (np.int32(s), np.full(3, s, np.int32)):
        jl2, jc2 = J_DECODE_STEP(jp, cfg, jnp.asarray(nxt), jc,
                                 jnp.asarray(cl))
        tl2, tc2 = t_model.decode_step(tp, tcfg, _t(nxt), _port_tree(jc),
                                       _t(cl))
        _close(tl2, jl2)
        assert np.array_equal(tl2.argmax(-1).numpy(),
                              np.asarray(jnp.argmax(jl2, -1)))
        _close_caches(tc2, jc2)


def _assert_loop(tout, jout):
    tem, tlv, ttok, tcs, tcl = tout
    jem, jlv, jtok, jcs, jcl = jout
    np.testing.assert_array_equal(tlv.numpy(), np.asarray(jlv))
    np.testing.assert_array_equal(np.where(tlv.numpy(), tem.numpy(), -1),
                                  np.where(np.asarray(jlv), np.asarray(jem),
                                           -1))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tcl.numpy(), np.asarray(jcl))
    _close_caches(tcs, jcs)


def _slot(tcfg, tree, i):
    """Slot ``i`` of every batched leaf of a hybrid cache tree, in leaf
    order (SSM state on axis 2, K/V on axis 1)."""
    axes = []
    tree_map(lambda _, ax: axes.append(ax), tree,
             t_model.cache_batch_axes(tcfg))
    return [leaf.narrow(ax, i, 1) for leaf, ax in zip(tree_leaves(tree), axes)
            if ax is not None]


def test_decode_loop_matches_jax_and_freezes_slots(zb):
    """decode_loop with per-slot budgets against JAX; a slot with no budget
    holds its SSM state and K/V bit for bit (its conv window exactly
    upcast), and one that finishes early holds what its last live step
    left."""
    cfg, tcfg, jp, tp = zb
    _, (_, jc), _, first = _prefilled(zb)
    cl = np.full(3, 37, np.int32)
    left = np.array([5, 2, 0], np.int32)
    jout = J_DECODE_LOOP(jp, cfg, jnp.asarray(first), jc, jnp.asarray(cl), 5,
                         steps_left=jnp.asarray(left))
    start = _port_tree(jc)
    tout = t_model.decode_loop(tp, tcfg, _t(first), _port_tree(jc), _t(cl), 5,
                               steps_left=_t(left))
    _assert_loop(tout, jout)
    end = tout[3]
    for got, was in zip(_slot(tcfg, end, 2), _slot(tcfg, start, 2)):
        assert torch.equal(got, was.to(got.dtype))
    two = t_model.decode_loop(tp, tcfg, _t(first), _port_tree(jc), _t(cl),
                              2)[3]
    for got, want in zip(_slot(tcfg, end, 1), _slot(tcfg, two, 1)):
        assert torch.equal(got, want)


def test_decode_loop_chunk_split_invariance(zb):
    _, tcfg, _, tp = zb
    _, (_, jc), _, first = _prefilled(zb)
    cl = _t(np.full(3, 37, np.int32))
    em6 = t_model.decode_loop(tp, tcfg, _t(first), _port_tree(jc), cl, 6)[0]
    em_a, _, tok, cs, length = t_model.decode_loop(
        tp, tcfg, _t(first), _port_tree(jc), cl, 2)
    em_b = t_model.decode_loop(tp, tcfg, tok, cs, length, 4)[0]
    np.testing.assert_array_equal(em6.numpy(),
                                  torch.cat([em_a, em_b], 1).numpy())


def test_decode_loop_mtp_matches_jax(zb):
    """MTP over the SSM state (no rollback of a rejected draft's update, as
    in JAX): emitted tokens, acceptance, liveness, lengths and carried
    tokens identical to JAX's, with a per-slot budget, and the caches
    close."""
    cfg, tcfg, jp, tp = zb
    _, (_, jc), _, first = _prefilled(zb)
    jm = j_mtp.init_mtp_params(jax.random.PRNGKey(1), cfg)
    tm = mtp_from_jax_numpy(jax.tree.map(np.asarray, jm), tcfg, "cpu")
    from repro_torch.core import mtp as t_mtp
    jtok = jnp.asarray(first)
    jd = j_mtp.propose_draft(jp, jm, cfg, jtok)
    td = t_mtp.propose_draft(tp, tm, tcfg, _t(first))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert not t_mtp.can_fuse_verify(tcfg, CAPACITY)
    cl = np.full(3, 37, np.int32)
    left = np.array([8, 3, 0], np.int32)
    jout = j_model.decode_loop_mtp(jp, jm, cfg, jtok, jd, jc,
                                   jnp.asarray(cl), 4,
                                   steps_left=jnp.asarray(left),
                                   key=jax.random.PRNGKey(5))
    tout = t_model.decode_loop_mtp(tp, tm, tcfg, _t(first), td,
                                   _port_tree(jc), _t(cl), 4,
                                   steps_left=_t(left))
    jem, jacc, jlv = (np.asarray(x) for x in jout[:3])
    tem, tacc, tlv = (x.numpy() for x in tout[:3])
    np.testing.assert_array_equal(tlv, jlv)
    np.testing.assert_array_equal(tacc, jacc)
    np.testing.assert_array_equal(tem[..., 0][jlv], jem[..., 0][jlv])
    np.testing.assert_array_equal(tem[..., 1][jacc], jem[..., 1][jacc])
    for i in (3, 4, 6):
        np.testing.assert_array_equal(tout[i].numpy(), np.asarray(jout[i]))
    _close_caches(tout[5], jout[5])


def test_ring_prefill_and_decode(zb):
    """Capacity 96 past the smoke window of 64: the shared K/V is a ring of
    64 slots per group; prompts of 70 tokens fill it past the window, and
    decode wraps it further."""
    cfg, tcfg, jp, tp = zb
    toks, (jl, jc), (tl, tc), first = _prefilled(zb, s=70, b=2, capacity=96,
                                                 seed=3)
    assert tc["mamba_groups"]["shared_kv"].k.shape[2] == cfg.sliding_window
    _close(tl, jl)
    _close_caches(tc, jc)
    cl = np.full(2, 70, np.int32)
    left = np.array([4, 1], np.int32)
    jout = J_DECODE_LOOP(jp, cfg, jnp.asarray(first), jc, jnp.asarray(cl), 4,
                         steps_left=jnp.asarray(left))
    # Both sides decode from JAX's caches: a conv window each side rounded
    # to bf16 on its own may differ by an ulp, which decode would carry on.
    tout = t_model.decode_loop(tp, tcfg, _t(first), _port_tree(jc), _t(cl),
                               4, steps_left=_t(left))
    _assert_loop(tout, jout)


def test_param_tree_round_trip(zb):
    """param_tree lays the port's weights out as the JAX tree: the group
    layers stacked in JAX's order, the shared block on an axis of 1."""
    _, _, jp, tp = zb
    tree = param_tree(tp)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(tree_leaves(tree)) == len(jflat)
    for path, leaf in jflat:
        node = tree
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_pack_request_bytes_equal_jax(zb):
    """A request's hybrid cache serializes to JAX's bytes (shared K and V,
    then conv, then h, by sorted keys) and round-trips bit for bit into
    another slot; the token payload is empty on both sides."""
    cfg, tcfg, _, _ = zb
    _, (_, jc), _, _ = _prefilled(zb)
    tc = _port_tree(jc)
    want = j_cache_ops.pack_request(cfg, j_cache_ops.slice_request(cfg, jc, 1))
    req = t_cache_ops.slice_request(tcfg, tc, 1)
    got = t_cache_ops.pack_request(tcfg, req)
    np.testing.assert_array_equal(got, want)
    back = t_cache_ops.unpack_request(
        tcfg, got, t_cache_ops.slice_request(tcfg, tc, 0))
    dst = tree_map(lambda x: torch.zeros_like(x), tc)
    t_cache_ops.insert_request(tcfg, dst, back, 2)
    for a, b in zip(_slot(tcfg, dst, 2), _slot(tcfg, tc, 1)):
        assert torch.equal(a, b)
    assert t_cache_ops.seq_slice(tcfg, tc, 0, 4) == {} == \
        j_cache_ops.seq_slice(cfg, jc, 0, 4)
    assert t_cache_ops.payload_token_nbytes(tcfg, tc) == 0
