"""The port's serving stack on the dense and GQA-MoE architectures against
the JAX package, on the CPU: ``smoke("qwen3-8b")`` and
``smoke("granite-3-2b")`` served plain, through a two-engine decode pool
that migrates, with multi-turn EMS sessions, and with MTP per step and
fused; the sliding-window ring fallbacks; OLMoE through LEP at world size
1; and the INT8 policy over Qwen3's weight tree. Weights and draft heads
go to both sides through ``repro_torch.convert``.

Served tokens, the scheduler's virtual-clock trace records, its summary
and ``ems_stats()`` must be identical. Equality is not luck: the smallest
top-1/top-2 logit margin along the plain greedy paths is asserted to sit
above ten times the float32 logit tolerance of the model tests (2e-4;
the logits themselves agree to ~1e-5).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.core import mtp as j_mtp
from repro.core.lep import make_lep_moe_fn as j_make_lep_moe_fn
from repro.launch.mesh import make_debug_mesh
from repro.mempool import EMSService as JEMSService
from repro.mempool import MemoryPool as JMemoryPool
from repro.models import init_params as j_init_params
from repro.models import moe as j_moe
from repro.quant import int8 as jquant
from repro.serving import Request as JRequest
from repro.serving import ServingSystem as JServingSystem
from repro.serving.workload import multi_turn_sessions as j_sessions
from repro_torch import quant
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import (moe_from_jax_numpy, mtp_from_jax_numpy,
                                 param_tree, params_from_jax_numpy,
                                 quantized_tree_from_jax_numpy)
from repro_torch.core import lep
from repro_torch.mempool import EMSService, MemoryPool
from repro_torch.models import decode_step as t_decode_step
from repro_torch.models import prefill as t_prefill
from repro_torch.serving import Request, ServingSystem, cache_ops

LOGIT_TOL = 2e-4
CAPACITY = 48                 # below the smoke window of 64: no ring
SERVING_ARCHS = ("qwen3-8b", "granite-3-2b")

_MODELS = {}


def _model(arch):
    """(JAX cfg, port cfg, JAX params, port params, prompts, JAX fitted
    head, port fitted head), built once per module. The head is distilled
    by JAX on the served prompts, so that drafts are accepted."""
    if arch not in _MODELS:
        cfg, tcfg = smoke(arch), smoke_variant(get_config(arch))
        jp = jax.jit(j_init_params, static_argnums=(1,))(
            jax.random.PRNGKey(0), cfg)
        tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        rng = np.random.RandomState(11)
        prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, 12)]
                   for _ in range(5)]
        jm = j_mtp.init_mtp_params(jax.random.PRNGKey(1), cfg)
        jfit = j_mtp.fit_draft_head(jp, cfg, jm, jax.random.PRNGKey(2),
                                    prompts=np.asarray(prompts, np.int32),
                                    gen_len=16, steps=100)
        tfit = mtp_from_jax_numpy(jax.tree.map(np.asarray, jfit), tcfg, "cpu")
        _MODELS[arch] = (cfg, tcfg, jp, tp, prompts, jfit, tfit)
    return _MODELS[arch]


def _max_new(i):
    """Long and short requests alternate, so a two-engine pool drains
    unevenly and its rebalancer migrates a request."""
    return 6 if i % 2 == 0 else 2


def _min_margin(tcfg, tp, prompt, tokens):
    """Smallest top-1/top-2 logit gap along a greedy path."""
    logits, caches = t_prefill(tp, tcfg, {"tokens": torch.tensor([prompt])},
                               CAPACITY, cache_dtype=torch.float32)
    rows = [logits[0, -1]]
    for i, tok in enumerate(tokens[:-1]):
        lg, caches = t_decode_step(tp, tcfg, torch.tensor([[tok]]), caches,
                                   torch.tensor(len(prompt) + i))
        rows.append(lg[0])
    top2 = torch.stack(rows).topk(2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


SERVING_PATHS = {
    "plain": {},
    "migrating_pool": {"decode_engines": 2, "decode_rebalance_every": 1,
                       "decode_router": "least_loaded_slots"},
    "mtp_per_step": {"use_mtp": True},
    "mtp_fused": {"use_mtp": True, "mtp_fused": True, "decode_chunk": 4},
}


def _serve(arch, kw, port=True):
    """Serve the arch's prompts on the port (or on JAX) along one path.
    Returns (tokens by rid, the system)."""
    cfg, tcfg, jp, tp, prompts, jfit, tfit = _model(arch)
    system_cls, req_cls, params, c, head, extra = (
        (ServingSystem, Request, tp, tcfg, tfit, {"device": "cpu"}) if port
        else (JServingSystem, JRequest, jp, cfg, jfit, {}))
    if kw.get("use_mtp"):
        extra["mtp_params"] = head
    system = system_cls(params, c, n_prefill=2, decode_batch=2,
                        capacity=CAPACITY, **kw, **extra)
    res = system.serve([req_cls(i, list(p), _max_new(i))
                        for i, p in enumerate(prompts)])
    return {r.rid: r.tokens for r in res}, system


@pytest.mark.parametrize("path", list(SERVING_PATHS))
@pytest.mark.parametrize("arch", SERVING_ARCHS)
def test_serving_matches_jax(arch, path):
    """Each path emits JAX's tokens and writes JAX's trace records and SLO
    summary on the same requests and weights."""
    jres, js = _serve(arch, SERVING_PATHS[path], port=False)
    tres, ts = _serve(arch, SERVING_PATHS[path])
    assert tres == jres
    records = ts.scheduler.trace_records()
    assert records == js.scheduler.trace_records()
    assert repr(ts.scheduler.summary()) == repr(js.scheduler.summary())
    if path == "migrating_pool":
        assert ts.scheduler.summary()["migrations"] >= 1
    if path.startswith("mtp"):
        assert ts.decode.mtp_fused == (path == "mtp_fused")
        assert any(r["decode_iters"] < r["decode_tokens"] for r in records)
    if path == "plain":
        _, tcfg, _, tp, prompts, _, _ = _model(arch)
        margin = min(_min_margin(tcfg, tp, p, jres[i])
                     for i, p in enumerate(prompts))
        assert margin > 10 * LOGIT_TOL, margin


@pytest.mark.parametrize("arch", SERVING_ARCHS)
def test_serving_paths_token_identical(arch):
    """Every path serves the plain path's greedy tokens."""
    base = _serve(arch, {})[0]
    for path, kw in SERVING_PATHS.items():
        assert _serve(arch, kw)[0] == base, path


def _sessions(vocab):
    reqs = j_sessions(3, seed=13, vocab_size=vocab, session_rate_rps=200.0,
                      turns=3, turn_tokens_median=8, turn_tokens_max=10,
                      max_new_median=3, max_new_max=4)
    cap = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 8
    return reqs, cap


@pytest.mark.parametrize("arch", SERVING_ARCHS)
def test_ems_sessions_match_jax(arch):
    """Multi-turn sessions through a two-engine ``cache_affinity`` decode
    pool and two prefill engines sharing one EMS: tokens, reused and
    computed counts, trace records, summary and ``ems_stats()`` equal
    JAX's; later turns reuse K/V blocks and run their suffixes through
    chunked ``prefill_continue``."""
    cfg, tcfg, jp, tp, _, _, _ = _model(arch)
    reqs, cap = _sessions(cfg.vocab_size)
    assert cap <= cfg.sliding_window
    out = []
    for system_cls, ems_cls, pool_cls, req_cls, params, c, extra in (
            (JServingSystem, JEMSService, JMemoryPool, JRequest, jp, cfg, {}),
            (ServingSystem, EMSService, MemoryPool, Request, tp, tcfg,
             {"device": "cpu"})):
        ems = ems_cls(pool_cls(n_nodes=2), block_tokens=4, model_tag=c.name)
        system = system_cls(params, c, n_prefill=2, decode_batch=2,
                            capacity=cap, decode_engines=2,
                            decode_router="cache_affinity", context_cache=ems,
                            **extra)
        res = system.serve([req_cls(r.rid, list(r.prompt), r.max_new_tokens,
                                    arrival=r.arrival) for r in reqs],
                           open_loop=True)
        out.append(({r.rid: (r.tokens, r.reused_tokens, r.computed_tokens)
                     for r in res}, system.scheduler.trace_records(),
                    repr(system.scheduler.summary()), ems.ems_stats(),
                    sum(e.suffix_calls for e in system.prefills)))
    assert out[1] == out[0]
    assert any(reused > 0 for _, reused, _ in out[1][0].values())
    assert out[1][4] > 0


def test_ring_fallbacks_match_jax():
    """At a capacity above the smoke window (64) the caches are rings: the
    EMS suffix takes the per-token ``decode_step`` loop (no chunked
    ``prefill_continue``) and fused MTP falls back to the two-step verify
    with a warning, on both sides alike; tokens, trace, summary and
    ``ems_stats()`` equal JAX's, with decodes that wrap the ring. (Prompts
    stay within the window: both sides refuse to pack EMS blocks past a
    ring's slots.)"""
    cfg, tcfg, jp, tp, _, jfit, tfit = _model("granite-3-2b")
    rng = np.random.RandomState(3)
    shared = [int(t) for t in rng.randint(0, cfg.vocab_size, 48)]
    prompts = [shared + [int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in (6, 9, 4)]
    out = []
    for system_cls, ems_cls, pool_cls, req_cls, params, c, head, extra in (
            (JServingSystem, JEMSService, JMemoryPool, JRequest, jp, cfg,
             jfit, {}),
            (ServingSystem, EMSService, MemoryPool, Request, tp, tcfg, tfit,
             {"device": "cpu"})):
        ems = ems_cls(pool_cls(n_nodes=2), block_tokens=8, model_tag=c.name)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            system = system_cls(params, c, n_prefill=1, decode_batch=2,
                                capacity=96, use_mtp=True, mtp_params=head,
                                mtp_fused=True, decode_chunk=2,
                                context_cache=ems, **extra)
        assert any("fused MTP" in str(w.message) for w in caught)
        assert not system.decode.mtp_fused
        res = system.serve([req_cls(i, list(p), 12)
                            for i, p in enumerate(prompts)])
        out.append(({r.rid: (r.tokens, r.reused_tokens) for r in res},
                    system.scheduler.trace_records(),
                    repr(system.scheduler.summary()), ems.ems_stats()))
        assert system.prefills[0].suffix_calls == 0
    assert out[1] == out[0]
    assert any(reused > 0 for _, reused in out[1][0].values())


def test_kv_request_round_trip_is_bit_exact():
    """``pack_request``/``unpack_request`` over a ``KVCache`` (bf16 and
    f32) land a slot bit for bit, and ``pack_blocks`` rows equal
    ``pack_payload(seq_slice(...))`` K before V, as JAX ravels them."""
    _, tcfg, _, _, _, _, _ = _model("qwen3-8b")
    from repro_torch.models.model import make_caches
    for dtype in (torch.float32, torch.bfloat16):
        caches = make_caches(tcfg, 3, 16, dtype, "cpu")
        for c in caches.values():
            c.k.copy_(torch.randn(c.k.shape))
            c.v.copy_(torch.randn(c.v.shape))
        req = cache_ops.slice_request(tcfg, caches, 1)
        flat = cache_ops.pack_request(tcfg, req)
        back = cache_ops.unpack_request(
            tcfg, flat, cache_ops.slice_request(tcfg, caches, 0))
        dst = make_caches(tcfg, 3, 16, dtype, "cpu")
        cache_ops.insert_request(tcfg, dst, back, 2)
        for name, c in caches.items():
            for got, want in zip(dst[name][:2], c[:2]):
                assert torch.equal(got[:, 2].view(torch.uint8),
                                   want[:, 1].view(torch.uint8))
        with pytest.raises(ValueError):
            cache_ops.unpack_request(tcfg, flat[:-1], req)
        blocks = cache_ops.pack_blocks(tcfg, caches, 3, 4)
        for bi, row in enumerate(blocks):
            payload = cache_ops.seq_slice(tcfg, caches, bi * 4, 4)
            np.testing.assert_array_equal(row,
                                          cache_ops.pack_payload(payload))
        name = next(iter(caches))
        k_part = caches[name].k[:, :, 4:8].float().reshape(-1).numpy()
        np.testing.assert_array_equal(blocks[1][:k_part.size], k_part)
        assert cache_ops.payload_token_nbytes(tcfg, caches) == \
            3 * 2 * tcfg.num_layers * tcfg.num_kv_heads * tcfg.head_dim * 4


def test_kv_payload_bytes_match_jax():
    """The EMS block payload of a prefilled K/V cache is JAX's, float for
    float within the model tolerance, in JAX's leaf order."""
    from repro.serving import cache_ops as j_cache_ops
    from repro.models import prefill as j_prefill
    cfg, tcfg, jp, tp, prompts, _, _ = _model("granite-3-2b")
    toks = np.asarray([prompts[0]], np.int32)
    _, jc = j_prefill(jp, cfg, {"tokens": jnp.asarray(toks)}, 16,
                      cache_dtype=jnp.float32)
    _, tc = t_prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, 16,
                      cache_dtype=torch.float32)
    jrows = j_cache_ops.pack_blocks(cfg, jc, 3, 4)
    trows = cache_ops.pack_blocks(tcfg, tc, 3, 4)
    for a, b in zip(trows, jrows):
        np.testing.assert_allclose(a, b, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert cache_ops.payload_token_nbytes(tcfg, tc) == \
        j_cache_ops.payload_token_nbytes(cfg, jc)


# ---------------------------------------------------------------------------
# OLMoE through LEP at world size 1
# ---------------------------------------------------------------------------


def test_olmoe_plan_and_lep_layer_match_jax():
    """OLMoE's plan is ``[moe x L]`` (no dense lead, no shared expert);
    one MoE layer through LEP at world size 1 equals JAX LEP on a 1x1 mesh
    (to 1e-5 of its largest entry, the same dropped count)."""
    from repro_torch.models.model import build_plan
    cfg = dataclasses.replace(smoke("olmoe-1b-7b"), capacity_factor=8.0)
    tcfg = dataclasses.replace(smoke_variant(get_config("olmoe-1b-7b")),
                               capacity_factor=8.0)
    assert [(s.name, s.kind) for s in build_plan(tcfg)] == [("moe", "moe")]
    assert tcfg.num_shared_experts == 0 and tcfg.first_k_dense == 0
    jl = jax.tree.map(lambda a: a[0], j_moe.init_moe_params(
        jax.random.PRNGKey(0), cfg, 1, jnp.float32))
    tl = moe_from_jax_numpy(jax.tree.map(lambda a: np.asarray(a)[None], jl),
                            tcfg, 0, "cpu")
    assert not hasattr(tl, "shared_gate")
    x = np.random.RandomState(1).randn(24, cfg.d_model).astype(np.float32)
    mesh = make_debug_mesh(1, 1)
    jfn = j_make_lep_moe_fn(mesh, ("model",))
    with mesh:
        jout, jaux = jax.jit(lambda p, a: jfn(p, a, cfg))(jl, jnp.asarray(x))
    out, aux = lep.make_lep_moe_fn()(tl, torch.from_numpy(x), tcfg)
    jout = np.asarray(jout)
    assert float(np.abs(out.numpy() - jout).max() / np.abs(jout).max()) \
        <= 1e-5
    assert int(aux["dropped"]) == int(jaux["dropped"])


def test_olmoe_lep_serving_matches_jax():
    """``ServingSystem(moe_fn=LEP)`` on ``smoke("olmoe-1b-7b")``: JAX LEP's
    tokens, trace records and summary, with the dispatch-quantize wrapper
    called once per MoE call (2 layers a forward)."""
    cfg, tcfg = smoke("olmoe-1b-7b"), smoke_variant(get_config("olmoe-1b-7b"))
    jp = jax.jit(j_init_params, static_argnums=(1,))(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.RandomState(11)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in (12, 9, 12, 7)]
    mesh = make_debug_mesh(1, 1)
    jfn = j_make_lep_moe_fn(mesh, ("model",))
    with mesh:
        js = JServingSystem(jp, cfg, n_prefill=2, decode_batch=2,
                            capacity=CAPACITY, moe_fn=jfn)
        jres = {r.rid: r.tokens for r in js.serve(
            [JRequest(i, p, _max_new(i)) for i, p in enumerate(prompts)])}
    calls, quantized = [], []
    port_fn = lep.make_lep_moe_fn()
    real = lep.dispatch_quantize

    def counted(p, x, c):
        calls.append(x.shape[0])
        return port_fn(p, x, c)

    lep.dispatch_quantize = lambda *a, **k: quantized.append(1) or real(*a, **k)
    try:
        system = ServingSystem(tp, tcfg, n_prefill=2, decode_batch=2,
                               capacity=CAPACITY, device="cpu",
                               moe_fn=counted)
        res = {r.rid: r.tokens for r in system.serve(
            [Request(i, p, _max_new(i)) for i, p in enumerate(prompts)])}
    finally:
        lep.dispatch_quantize = real
    assert calls and len(quantized) == len(calls)
    assert len(calls) % tcfg.num_layers == 0
    assert res == jres
    assert system.scheduler.trace_records() == js.scheduler.trace_records()
    assert repr(system.scheduler.summary()) == repr(js.scheduler.summary())


# ---------------------------------------------------------------------------
# INT8 policy over a GQA tree
# ---------------------------------------------------------------------------


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _flat(sub, f"{path}/{k}").items()}
    return {path: tree}


def test_quantize_param_tree_qwen3_matches_jax():
    """At smoke("qwen3-8b"): the policy quantizes wq/wk/wv/wo and the MLP
    and keeps the norms, q_norm/k_norm and embeddings, with JAX's stats;
    codes agree to +-1 at rounding boundaries, scales to 1e-6."""
    cfg, tcfg, jp, tp, _, _, _ = _model("qwen3-8b")
    qt, stats = quant.quantize_param_tree(param_tree(tp))
    jqt, jstats = jquant.quantize_param_tree(jp)
    assert stats == jstats
    q = _flat(qt)
    jq = _flat(quantized_tree_from_jax_numpy(jax.tree.map(np.asarray, jqt),
                                             "cpu"))
    assert sorted(q) == sorted(jq)
    attn = "/segments/dense/attn"
    for name in ("wq", "wk", "wv", "wo"):
        assert f"{attn}/{name}/__q__" in q
    for name in ("q_norm", "k_norm", "ln"):
        assert f"{attn}/{name}" in q
    for path, v in q.items():
        if path.endswith("/__q__"):
            d = (v.int() - jq[path].int()).abs()
            assert int(d.max()) <= 1 and float(d.float().mean()) < 1e-3, path
        elif path.endswith("/__scale__"):
            np.testing.assert_allclose(v.numpy(), jq[path].numpy(), rtol=1e-6)
        else:
            assert torch.equal(v, jq[path]), path


def test_quantize_param_tree_keeps_qkv_bias():
    """Qwen2.5's biases stay high precision on both sides."""
    cfg, tcfg = smoke("qwen2.5-3b"), smoke_variant(get_config("qwen2.5-3b"))
    jp = jax.jit(j_init_params, static_argnums=(1,))(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    qt, stats = quant.quantize_param_tree(param_tree(tp))
    assert stats == jquant.quantize_param_tree(jp)[1]
    for name in ("bq", "bk", "bv"):
        assert isinstance(qt["segments"]["dense"]["attn"][name], torch.Tensor)
