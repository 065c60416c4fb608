"""The port's EMS context cache (``repro_torch/mempool/{context_cache,ems}.py``)
and the prefill engine's reuse path against the JAX package.

The cache service is numpy-only: its block keys (a sha256 chain over
``model_tag`` and the prompt) and its tier decisions (HBM/DRAM/SSD,
eviction, dedup, promote/demote bytes) must be identical, and so must the
digest of the multi-turn session soak of ``tests/test_ems.py``. Served
through ``ServingSystem`` at ``smoke("deepseek-r1")`` (weights shared
through ``repro_torch.convert``), EMS sessions must emit JAX's tokens and
write JAX's trace records, summary and ``ems_stats()``.
"""
import hashlib

import jax
import numpy as np
import pytest

import test_ems as j_ems_tests
from conftest import smoke
from repro.core import mtp as j_mtp
from repro.mempool import ContextCache as JContextCache
from repro.mempool import EMSService as JEMSService
from repro.mempool import MemoryPool as JMemoryPool
from repro.mempool.context_cache import _block_keys as j_block_keys
from repro.models import init_params as j_init_params
from repro.serving import Request as JRequest
from repro.serving import ServingSystem as JServingSystem
from repro.serving.workload import multi_turn_sessions as j_sessions
from repro_torch import mempool as port_mempool
from repro_torch import serving as port_serving
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import mtp_from_jax_numpy, params_from_jax_numpy
from repro_torch.mempool import ContextCache, EMSService, MemoryPool
from repro_torch.mempool.context_cache import _block_keys
from repro_torch.mempool.pool import HUGE_PAGE
from repro_torch.serving import Request, ServingSystem


@pytest.fixture(scope="module")
def r1():
    cfg = smoke("deepseek-r1")
    tcfg = smoke_variant(get_config("deepseek-r1"))
    jp = jax.jit(j_init_params, static_argnums=(1,))(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, tcfg, jp, tp


# ---------------------------------------------------------------------------
# The cache service alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", [4, 8, 128])
def test_block_keys_bit_identical(block):
    rng = np.random.RandomState(block)
    for n in (0, block - 1, block, 3 * block + 1, 300):
        toks = [int(t) for t in rng.randint(0, 129280, n)]
        for tag in ("deepseek-r1-smoke", "model"):
            assert _block_keys(toks, block, tag) == j_block_keys(toks, block,
                                                                 tag)
    # model_tag enters the chain: another tag, other keys
    toks = list(range(2 * block))
    assert _block_keys(toks, block, "a") != _block_keys(toks, block, "b")


def _payloads(tokens, block, scale):
    return [np.asarray(tokens[b * block:(b + 1) * block], np.float32) * scale
            for b in range(len(tokens) // block)]


def _drive(ems_cls, pool_cls):
    """A fixed script of stores, fetches, pins, drops and flushes over
    three engine tiers under HBM pressure (payloads of one huge page, a
    tier of four slabs), logging every return value."""
    ems = ems_cls(pool_cls(n_nodes=2, dram_per_node=8 * HUGE_PAGE),
                  block_tokens=4, model_tag="tiers",
                  hbm_capacity_bytes=4 * HUGE_PAGE)
    rng = np.random.RandomState(7)
    log = []
    prompts = [[int(t) for t in rng.randint(0, 50, 4 * rng.randint(1, 6))]
               for _ in range(12)]
    prompts += [p[:8] + [1, 2, 3, 4] for p in prompts[:4]]   # shared prefixes
    for i, p in enumerate(prompts):
        tag = f"prefill{i % 3}"
        big = [np.full(HUGE_PAGE // 4, v, np.float32) for v in
               np.asarray(_payloads(p, 4, 1.0))[:, 0]]
        matched, keys = ems.match_prefix(p)
        got = ems.fetch(keys, engine=tag)
        log.append(("fetch", i, matched, [float(g[0]) for g in got]))
        log.append(("store", i, ems.store(p, big, engine=tag)))
        if i % 4 == 3:
            ems.pin(f"decode{i % 2}", ems.block_keys(p))
            log.append(("residency", i, ems.engine_residency(
                f"decode{i % 2}", ems.block_keys(p))))
        if i == 9:
            ems.drop_engine("prefill0")
        if i == 13:
            log.append(("flush", ems.flush()))
        log.append(("probe", i, ems.probe_prefix(p)))
    # the last prompt again, on the tier that just stored it: HBM hits
    _, keys = ems.match_prefix(prompts[-1])
    log.append(("refetch", [float(g[0]) for g in ems.fetch(
        keys, engine=f"prefill{(len(prompts) - 1) % 3}")]))
    log.append(("stats", sorted(ems.ems_stats().items())))
    log.append(("pool", sorted(ems.pool.stats().items())))
    log.append(("transfer", ems.transfer.bytes_promoted,
                ems.transfer.bytes_demoted))
    return log


def test_ems_tier_decisions_identical():
    """The same script through the JAX and the port EMS: identical
    matches, fetched payloads, stores, residency, flushes, probes,
    ``ems_stats()``, pool stats and RDMA-plane books. The script does hit
    every tier: HBM and pool hits, evictions, demotions and promotions."""
    port = _drive(EMSService, MemoryPool)
    assert port == _drive(JEMSService, JMemoryPool)
    stats = dict(port[-3][1])
    for key in ("hbm_hits", "pool_hits", "hbm_evictions", "demote_blocks",
                "promote_blocks", "dedup_skipped"):
        assert stats[key] > 0, key


def test_context_cache_eviction_race_identical():
    """The base cache's graceful miss on a block evicted between match and
    fetch, on both sides."""
    outs = []
    for cc_cls, pool_cls in ((ContextCache, MemoryPool),
                             (JContextCache, JMemoryPool)):
        pool = pool_cls(n_nodes=2)
        cc = cc_cls(pool, block_tokens=4, model_tag="race")
        toks = list(range(8))
        cc.store(toks, _payloads(toks, 4, 1.0))
        matched, keys = cc.match_prefix(toks)
        j_ems_tests._purge(pool, keys[1])
        got = cc.fetch(keys)
        outs.append((matched, len(got), cc.fetch_misses,
                     [g.tolist() for g in got]))
    assert outs[0] == outs[1] and outs[0][1] == 1


def test_ems_session_soak_digest_equal(monkeypatch):
    """The EMS session soak of ``tests/test_ems.py`` (40 sessions of 3
    turns through a bare service on the virtual clock) digests identically
    with the JAX package's classes and with the port's, seed 17."""
    def digest(rows):
        h = hashlib.sha256()
        for row in rows:
            h.update(repr(row).encode())
        return h.hexdigest()

    rows, _, jax_ems = j_ems_tests._drive_sessions(
        j_ems_tests.SOAK_SESSIONS, 3, seed=17)
    jax_digest, jax_stats = digest(rows), jax_ems.ems_stats()
    monkeypatch.setattr(j_ems_tests, "EMSService", port_mempool.EMSService)
    monkeypatch.setattr(j_ems_tests, "MemoryPool", port_mempool.MemoryPool)
    monkeypatch.setattr(j_ems_tests, "multi_turn_sessions",
                        port_serving.multi_turn_sessions)
    rows, _, ems = j_ems_tests._drive_sessions(j_ems_tests.SOAK_SESSIONS, 3,
                                               seed=17)
    assert isinstance(ems, EMSService)
    assert digest(rows) == jax_digest
    assert ems.ems_stats() == jax_stats
    assert any(reuse > 0 for _, _, reuse, _ in rows)


# ---------------------------------------------------------------------------
# Served through ServingSystem
# ---------------------------------------------------------------------------


def _sessions(vocab):
    reqs = j_sessions(3, seed=13, vocab_size=vocab, session_rate_rps=200.0,
                      turns=3, turn_tokens_median=8, turn_tokens_max=10,
                      max_new_median=3, max_new_max=4)
    cap = max(len(r.prompt) + r.max_new_tokens for r in reqs) + 8
    return reqs, cap


def _serve_sessions(params, cfg, system_cls, ems_cls, pool_cls, req_cls,
                    hit_aware, device_kw, **kw):
    reqs, cap = _sessions(cfg.vocab_size)
    ems = ems_cls(pool_cls(n_nodes=2), block_tokens=4, model_tag=cfg.name)
    system = system_cls(params, cfg, n_prefill=2, decode_batch=2,
                        capacity=cap, decode_engines=2,
                        decode_router="cache_affinity", context_cache=ems,
                        hit_aware_admission=hit_aware or None, **device_kw,
                        **kw)
    results = system.serve([req_cls(r.rid, list(r.prompt), r.max_new_tokens,
                                    arrival=r.arrival) for r in reqs],
                           open_loop=True)
    return ({r.rid: (r.tokens, r.reused_tokens, r.computed_tokens)
             for r in results}, system, ems)


@pytest.mark.parametrize("hit_aware", [False, True])
def test_ems_sessions_match_jax(r1, hit_aware):
    """Multi-turn sessions through a two-engine ``cache_affinity`` decode
    pool and two prefill engines sharing one EMS: tokens, reused and
    computed counts, trace records, summary and ``ems_stats()`` equal
    JAX's; later turns reuse their grown prefix, and every suffix runs
    through chunked ``prefill_continue`` calls counted apart from the
    fresh path."""
    cfg, tcfg, jp, tp = r1
    jres, js, jems = _serve_sessions(jp, cfg, JServingSystem, JEMSService,
                                     JMemoryPool, JRequest, hit_aware, {})
    tres, ts, tems = _serve_sessions(tp, tcfg, ServingSystem, EMSService,
                                     MemoryPool, Request, hit_aware,
                                     {"device": "cpu"})
    assert tres == jres
    assert ts.scheduler.trace_records() == js.scheduler.trace_records()
    assert repr(ts.scheduler.summary()) == repr(js.scheduler.summary())
    assert tems.ems_stats() == jems.ems_stats()
    assert tems.promote_bytes == ts.pool.router.ems.transfer.bytes_promoted
    reqs, _ = _sessions(cfg.vocab_size)
    for q in reqs:
        _, reused, computed = tres[q.rid]
        assert reused + computed == len(q.prompt)
        assert reused % 4 == 0 and reused <= len(q.prompt) - 1
    assert any(tres[q.rid][1] > 0 for q in reqs if q.rid % 3)
    suffix = sum(e.suffix_calls for e in ts.prefills)
    assert suffix == sum(e.suffix_calls for e in js.prefills) > 0
    assert all(e.continue_calls == 0 for e in ts.prefills)
    if hit_aware:
        assert any(r["cached_tokens"] > 0
                   for r in ts.scheduler.trace_records())


def test_ems_reuse_bit_exact_and_deep_path(r1):
    """EMS reuse at any tier serves the tokens of a cache-less system: the
    engines' own HBM tier, then (device tiers dropped) blocks re-promoted
    from the pooled tier."""
    _, tcfg, _, tp = r1
    rng = np.random.RandomState(4)
    shared = [int(t) for t in rng.randint(0, tcfg.vocab_size, 12)]
    prompts = [shared + [int(t) for t in rng.randint(0, tcfg.vocab_size, 4)]
               for _ in range(3)]

    def serve(system, rid0=0):
        return sorted(system.serve(
            [Request(rid0 + i, list(p), 4) for i, p in enumerate(prompts)]),
            key=lambda r: r.rid)

    plain = serve(ServingSystem(tp, tcfg, n_prefill=1, decode_batch=3,
                                capacity=40, device="cpu"))
    ems = EMSService(MemoryPool(n_nodes=2), block_tokens=4,
                     model_tag=tcfg.name)
    system = ServingSystem(tp, tcfg, n_prefill=1, decode_batch=3, capacity=40,
                           context_cache=ems, device="cpu")
    warm = serve(system)
    assert any(r.reused_tokens > 0 for r in warm)
    assert [r.tokens for r in warm] == [r.tokens for r in plain]
    ems.flush()
    for tag in list(ems._hbm):
        ems.drop_engine(tag)
    deep = serve(system, rid0=10)
    assert ems.pool_hits > 0
    assert [r.tokens for r in deep] == [r.tokens for r in plain]
    # every suffix call had one width: the chunk clamped to the headroom
    assert system.prefills[0].suffix_widths == {40 - 12}


def test_ems_with_fused_mtp_matches_jax(r1):
    """``ServingSystem(use_mtp=True, mtp_fused=True,
    context_cache=EMSService(...))``: tokens, trace, summary and
    ``ems_stats()`` equal JAX's."""
    cfg, tcfg, jp, tp = r1
    jm = j_mtp.init_mtp_params(jax.random.PRNGKey(1), cfg)
    tm = mtp_from_jax_numpy(jax.tree.map(np.asarray, jm), tcfg, "cpu")
    rng = np.random.RandomState(6)
    shared = [int(t) for t in rng.randint(0, cfg.vocab_size, 16)]
    prompts = [shared + [int(t) for t in rng.randint(0, cfg.vocab_size, 5)]
               for _ in range(4)]
    out = []
    for system_cls, ems_cls, pool_cls, req_cls, params, c, head, kw in (
            (JServingSystem, JEMSService, JMemoryPool, JRequest, jp, cfg, jm,
             {}),
            (ServingSystem, EMSService, MemoryPool, Request, tp, tcfg, tm,
             {"device": "cpu"})):
        ems = ems_cls(pool_cls(n_nodes=2), block_tokens=8, model_tag=c.name)
        system = system_cls(params, c, n_prefill=1, decode_batch=2,
                            capacity=40, use_mtp=True, mtp_params=head,
                            mtp_fused=True, decode_chunk=4, context_cache=ems,
                            **kw)
        res = system.serve([req_cls(i, list(p), 5)
                            for i, p in enumerate(prompts)])
        out.append(({r.rid: (r.tokens, r.reused_tokens) for r in res},
                    system.scheduler.trace_records(),
                    repr(system.scheduler.summary()), ems.ems_stats()))
    assert out[1] == out[0]
    assert any(reused > 0 for _, reused in out[1][0].values())
