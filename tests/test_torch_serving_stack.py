"""The rest of the port's serving stack against the JAX package, at the
sizes of the JAX package's own tests (granite smoke, float32, weights
shared through ``repro_torch.convert``): the production workload soak with
preemption, brownout and a seeded fault plan; the decode-pool autoscaler
end to end; the joint prefill/decode autoscaler; the SLO classes (strict
priority, class-ordered degrade, the brownout ladder); the fault soak's
control-plane digest; and EMS model caching. On every path the emitted
tokens, the scheduler's trace records and its summary must equal JAX's.
"""
import hashlib

import jax
import numpy as np
import pytest

import test_fault_soak as fault_soak
from conftest import smoke
from repro import mempool as j_mempool
from repro import serving as js
from repro.models import init_params as j_init_params
from repro_torch import mempool as t_mempool
from repro_torch import serving as ts
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import params_from_jax_numpy

SIDES = {"jax": js, "port": ts}


@pytest.fixture(scope="module")
def granite():
    cfg = smoke("granite-3-2b")
    tcfg = smoke_variant(get_config("granite-3-2b"))
    jp = j_init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return {"jax": (jp, cfg, {}), "port": (tp, tcfg, {"device": "cpu"})}


def _system(granite, side, **kw):
    params, cfg, extra = granite[side]
    return SIDES[side].ServingSystem(params, cfg, **kw, **extra)


def _tokens(results):
    return {r.rid: (list(r.tokens), r.shed) for r in results}


def _assert_same(jax_run, port_run):
    """Tokens (and shed flags) by rid, trace records and summary equal."""
    (jsys, jres), (tsys, tres) = jax_run, port_run
    assert _tokens(tres) == _tokens(jres)
    assert tsys.scheduler.trace_records() == jsys.scheduler.trace_records()
    assert repr(tsys.scheduler.summary()) == repr(jsys.scheduler.summary())


def _serve_both(granite, make_reqs, system_kw, **serve_kw):
    runs = {}
    for side, mod in SIDES.items():
        system = _system(granite, side, **system_kw(mod))
        runs[side] = (system, system.serve(make_reqs(mod), **serve_kw))
    _assert_same(runs["jax"], runs["port"])
    return runs["port"][0]


# ---------------------------------------------------------------------------
# Workload soak through ServingSystem, with faults (test_workload_soak.py)
# ---------------------------------------------------------------------------


def _soak_run(granite, side):
    """``test_workload_soak``'s serve with faults, on one side: 24
    production requests (burst, 60 % interactive), two decode engines,
    preemption, brownout and a seeded fault plan plus one transfer
    timeout. Returns (the digest of that test, system, results)."""
    mod = SIDES[side]
    cfg = granite[side][1]
    reqs = mod.production_requests(24, seed=7, vocab_size=cfg.vocab_size,
                                   rate_rps=400.0, arrival_shape="burst",
                                   prompt_len_max=24, max_new_max=8,
                                   interactive_frac=0.6)
    plan = (mod.FaultPlan.random(3, n_engines=2, horizon_s=0.05)
            + mod.FaultPlan.parse('[{"kind": "transfer_timeout", '
                                  '"count": 1}]'))
    system = _system(granite, side, n_prefill=2, decode_batch=2, capacity=64,
                     decode_engines=2, tpot_budget_ms=9.0,
                     batch_tpot_budget_ms=40.0, preempt_batch=True,
                     brownout=True,
                     fault_injector=mod.FaultInjector(plan, seed=3))
    results = system.serve(list(reqs), open_loop=True)
    digest = hashlib.sha256()
    for r in sorted(results, key=lambda r: r.rid):
        digest.update(repr((r.rid, r.tokens, r.shed, r.slo_class)).encode())
    for tr in sorted(system.scheduler.traces.values(), key=lambda t: t.rid):
        digest.update(repr((tr.rid, tr.slo_class, tr.recoveries,
                            tr.preemptions, tr.shed,
                            round(tr.decode_end, 12))).encode())
    return digest.hexdigest(), system, results


def test_workload_soak_with_faults_matches_jax(granite):
    jd, jsys, jres = _soak_run(granite, "jax")
    td, tsys, tres = _soak_run(granite, "port")
    assert td == jd
    _assert_same((jsys, jres), (tsys, tres))
    s = tsys.scheduler.summary()
    assert s["completed"] + s["shed"] == 24
    assert sum(tr.recoveries for tr in tsys.scheduler.traces.values()) >= 1
    assert tsys.faults.crashes_fired >= 1


def test_crash_under_the_autoscaler_matches_jax(granite):
    """serve-faults' configuration (``chip_smoke.py``) at smoke width: two
    decode engines under the autoscaler, an engine crash mid-decode and a
    transfer timeout. The pool grows, loses engine 1, revives it for the
    replayed requests and shrinks at the tail, as in JAX."""
    def reqs(mod):
        rng = np.random.RandomState(4)
        return [mod.Request(i, list(rng.randint(0, 100, 12)), 8)
                for i in range(8)]

    plan = ('[{"kind": "engine_crash", "engine": 1, "at": 0.03}, '
            '{"kind": "transfer_timeout", "count": 1}]')
    system = _serve_both(
        granite, reqs,
        lambda mod: dict(n_prefill=1, decode_batch=2, capacity=64,
                         decode_engines=2, autoscale=True, min_engines=1,
                         max_engines=3, fault_injector=mod.FaultInjector(
                             mod.FaultPlan.parse(plan))))
    s = system.scheduler.summary()
    assert s["recoveries"] >= 1 and s["transfer_timeouts"] == 1
    assert [e["action"] for e in system.scheduler.scale_events] == [
        "grow", "fail", "grow", "shrink"]


# ---------------------------------------------------------------------------
# Decode-pool autoscaler end to end (test_autoscale.py)
# ---------------------------------------------------------------------------


def _burst(mod, n=10, max_new=8, seed=5):
    return mod.poisson_requests(n, 400.0, 10, max_new, 100, seed=seed)


def test_autoscale_burst_grows_tail_shrinks_matches_jax(granite):
    system = _serve_both(
        granite, _burst,
        lambda mod: dict(n_prefill=2, decode_batch=2, capacity=32,
                         decode_engines=1, autoscale=True, min_engines=1,
                         max_engines=3),
        open_loop=True)
    s = system.scheduler.summary()
    assert s["scale_grows"] >= 1 and s["scale_shrinks"] >= 1
    assert max(n for _, n in system.scheduler.engine_count_timeline) == 3


def test_autoscale_max_clamp_and_budget_cap_match_jax(granite):
    system = _serve_both(
        granite, lambda mod: _burst(mod, n=8, max_new=6, seed=7),
        lambda mod: dict(
            n_prefill=2, decode_batch=4, capacity=32, decode_engines=1,
            autoscale=True, min_engines=1, max_engines=2,
            tpot_budget_ms=6.0, admission="queue",
            scheduler_config=mod.SchedulerConfig(
                decode_cost=mod.DecodeCostModel(fixed_s=4e-3,
                                                per_req_s=1e-3))),
        open_loop=True)
    assert system.scheduler.gate.max_batch == 2
    assert max(n for _, n in system.scheduler.engine_count_timeline) == 2


def test_autoscale_second_wave_revives_parked_engines_matches_jax(granite):
    """Wave 2 revives the engines wave 1 parked, on both sides alike."""
    systems = {side: _system(granite, side, n_prefill=2, decode_batch=2,
                             capacity=32, decode_engines=1, autoscale=True,
                             min_engines=1, max_engines=3)
               for side in SIDES}
    for seed in (5, 6):
        runs = {side: (sys_, sys_.serve(_burst(SIDES[side], seed=seed),
                                        open_loop=True))
                for side, sys_ in systems.items()}
        _assert_same(runs["jax"], runs["port"])
        assert systems["port"].pool.n == systems["jax"].pool.n > 1
        assert systems["port"].pool.live_mask == systems["jax"].pool.live_mask
    assert systems["port"].scheduler.summary()["scale_grows"] >= 1


# ---------------------------------------------------------------------------
# Joint prefill/decode autoscaler (test_prefill_pool.py)
# ---------------------------------------------------------------------------


def _phase_skewed_burst(mod, vocab):
    rng = np.random.RandomState(3)
    reqs = [mod.Request(i, list(rng.randint(0, vocab, 48)), 2,
                        arrival=5e-4 * i) for i in range(8)]
    reqs += [mod.Request(100 + i, list(rng.randint(0, vocab, 6)), 24,
                         arrival=0.15 + 2e-4 * i) for i in range(8)]
    return reqs


def test_joint_autoscaler_see_saw_matches_jax(granite):
    vocab = granite["jax"][1].vocab_size
    system = _serve_both(
        granite, lambda mod: _phase_skewed_burst(mod, vocab),
        lambda mod: dict(prefill_engines=1, decode_batch=2, capacity=96,
                         decode_engines=2, joint_autoscale=True,
                         min_prefill=1, max_prefill=3, min_engines=1,
                         max_engines=3, ttft_budget_ms=2.0,
                         tpot_budget_ms=6.0, admission="queue"),
        open_loop=True)
    s = system.scheduler.summary()
    assert s["shifts_d2p"] >= 1 and s["shifts_p2d"] >= 1


# ---------------------------------------------------------------------------
# SLO classes (test_slo_classes.py)
# ---------------------------------------------------------------------------


def _mixed_requests(mod):
    rng = np.random.RandomState(11)
    reqs = [mod.Request(i, list(rng.randint(0, 100, 12)), 6,
                        arrival=5e-4 * i, slo_class="batch")
            for i in range(6)]
    reqs += [mod.Request(100 + i, list(rng.randint(0, 100, 12)), 4,
                         arrival=4e-3 + 2e-3 * i, slo_class="interactive")
             for i in range(3)]
    return reqs


def _equal_age_backlog(mod):
    rng = np.random.RandomState(5)
    return [mod.Request(i, list(rng.randint(0, 100, 12)), 6,
                        slo_class=("batch" if i % 2 == 0 else "interactive"))
            for i in range(8)]


def _interactive_pressure(mod):
    rng = np.random.RandomState(17)
    reqs = [mod.Request(i, list(rng.randint(0, 100, 12)), 6,
                        arrival=3e-4 * i, slo_class="interactive")
            for i in range(8)]
    reqs += [mod.Request(100 + i, list(rng.randint(0, 100, 12)), 4,
                         arrival=2e-3 + 2e-3 * i, slo_class="batch")
             for i in range(4)]
    return reqs


SLO_CASES = {
    "strict_priority": (_mixed_requests, dict(
        n_prefill=2, decode_batch=3, capacity=64, tpot_budget_ms=6.0,
        batch_tpot_budget_ms=30.0), True),
    "degrade_shed": (_equal_age_backlog, dict(
        n_prefill=1, decode_batch=2, capacity=32,
        degrade_shed_queue_s=1e-4), False),
    "brownout": (_interactive_pressure, dict(
        n_prefill=2, decode_batch=2, capacity=64, tpot_budget_ms=6.0,
        batch_tpot_budget_ms=30.0, brownout=True, brownout_patience=4),
        True),
}


@pytest.mark.parametrize("case", list(SLO_CASES))
def test_slo_classes_match_jax(granite, case):
    make, kw, open_loop = SLO_CASES[case]
    system = _serve_both(granite, make, lambda mod: kw, open_loop=open_loop)
    s = system.scheduler.summary()
    if case == "degrade_shed":
        assert s["shed"] >= 1
    elif case == "brownout":
        assert s["brownout_peak_level"] >= 1 and s["classes"]["batch"]["shed"]


# ---------------------------------------------------------------------------
# The fault soak's control plane (test_fault_soak.py) and model caching
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fault_soak_digest_matches_jax(monkeypatch, seed):
    """``test_fault_soak``'s plan run (crashes, stragglers, transfer faults,
    the autoscaler over a slot roster) gives the same event-log digest and
    crash count with the port's classes patched in."""
    want = fault_soak._run_plan(seed, fault_soak.ITERS_PER_PLAN)
    for name in ("DecodeCostModel", "FaultInjector", "FaultPlan",
                 "PoolAutoscaler", "DecodeSlotManager"):
        monkeypatch.setattr(fault_soak, name, getattr(ts, name))
    assert fault_soak._run_plan(seed, fault_soak.ITERS_PER_PLAN) == want


def _table2(mod):
    """``test_mempool``'s Table 2 sequence: simulated seconds and flags."""
    total = 671 * 10**9
    mc1 = mod.ModelCache(mod.MemoryPool(n_nodes=32))
    t_nocache = mc1.load_to_npu(mc1.register("dsr1", "v1", total),
                                n_instances=8)
    mc2 = mod.ModelCache(mod.MemoryPool(n_nodes=32, dram_per_node=1 << 38))
    meta = mc2.register("dsr1", "v1", total)
    t_fill = mc2.prefetch(meta)
    t_warm = mc2.load_to_npu(meta, n_instances=8)
    return (t_nocache, t_fill, t_warm, mc2.switch_model(meta),
            meta.n_blocks, meta.total_bytes, meta.block_key(3))


def _versioning(mod):
    mc = mod.ModelCache(mod.MemoryPool(n_nodes=4, dram_per_node=1 << 34))
    v1 = mc.register("m", "v1", 10 ** 9)
    v2 = mc.register("m", "v2", 10 ** 9)
    t = mc.prefetch(v1)
    flags = (mc.is_cached(v1), mc.is_cached(v2))
    return (t, flags, mc.switch_model(v2), mc.switch_model(v1),
            mc.is_cached(v2))


@pytest.mark.parametrize("case", [_table2, _versioning],
                         ids=["table2", "versioning"])
def test_model_cache_matches_jax(case):
    ours, theirs = case(t_mempool), case(j_mempool)
    assert ours == theirs
    if case is _table2:
        t_nocache, t_fill, t_warm, (t_switch, warm) = ours[:4]
        assert 200 < t_fill < 400 and t_warm / 8 < 10
        assert t_fill + t_warm < t_nocache / 3 and warm and t_switch < 10
    else:
        assert ours[1] == (True, False) and ours[2][1] is False
