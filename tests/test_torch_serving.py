"""The port's serving stack against the JAX package at
``smoke("deepseek-r1")`` (float32, shared weights through
``repro_torch.convert``): on every serving path, emitted tokens, the
scheduler's virtual-clock trace records and its summary must be identical.
Equality is not luck: the smallest
top-1/top-2 logit margin along every greedy path is asserted to sit far
above the float32 logit tolerance the model tests use (2e-4).
"""
import jax
import numpy as np
import pytest
import torch

import test_workload_soak as soak
from conftest import smoke
from repro.models import init_params as j_init_params
from repro.models.moe import moe_reference as j_moe_reference
from repro.serving import Request as JRequest
from repro.serving import ServingSystem as JServingSystem
from repro_torch import serving as port_serving
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import params_from_jax_numpy
from repro_torch.models import decode_step as t_decode_step
from repro_torch.models import prefill as t_prefill
from repro_torch.models.moe import moe_reference
from repro_torch.serving import Request, ServingSystem, cache_ops
from repro_torch.serving.engine import DecodeEngine

LOGIT_TOL = 2e-4
N_NEW = 6


@pytest.fixture(scope="module")
def r1():
    cfg = smoke("deepseek-r1")
    tcfg = smoke_variant(get_config("deepseek-r1"))
    jp = jax.jit(j_init_params, static_argnums=(1,))(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.RandomState(11)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in (12,) * 5]
    return cfg, tcfg, jp, tp, prompts


def _max_new(i):
    """Long and short requests alternate, so a two-engine pool drains
    unevenly and its rebalancer migrates a request."""
    return N_NEW if i % 2 == 0 else 2


def _serve_port(tp, tcfg, prompts, **kw):
    system = ServingSystem(tp, tcfg, n_prefill=2, decode_batch=2,
                           capacity=48, device="cpu", **kw)
    results = system.serve([Request(i, p, _max_new(i)) for i, p in
                            enumerate(prompts)])
    return {r.rid: r.tokens for r in results}, system


def _min_margin(tcfg, tp, prompt, tokens):
    """Smallest top-1/top-2 logit gap along a greedy path (the port's
    logits, which match JAX's to ~1e-5)."""
    logits, caches = t_prefill(tp, tcfg, {"tokens": torch.tensor([prompt])},
                               48, cache_dtype=torch.float32)
    rows = [logits[0, -1]]
    for i, tok in enumerate(tokens[:-1]):
        lg, caches = t_decode_step(tp, tcfg, torch.tensor([[tok]]), caches,
                                   torch.tensor(len(prompt) + i))
        rows.append(lg[0])
    top2 = torch.stack(rows).topk(2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


SERVING_PATHS = {
    "per_step": {},
    "chunked_continuous": {"decode_chunk": 4, "continuous_batching": True},
    # The paths below change how many tokens share a MoE call, and with it
    # which tokens ``moe_capacity`` drops; the dense oracle keeps them
    # comparable with the per-step path as well.
    "interleave": {"interleave": True, "moe": "reference"},
    "migrating_pool": {"decode_engines": 2, "decode_rebalance_every": 1,
                       "decode_router": "least_loaded_slots",
                       "moe": "reference"},
    "streamed": {"stream_handoff": True, "stream_chunk": 4,
                 "moe": "reference"},
    "chunked_prefill": {"prefill_chunk": 8, "moe": "reference"},
}
ORACLE_PATHS = [k for k, v in SERVING_PATHS.items() if "moe" in v]


def _system_kw(path, oracle):
    kw = dict(SERVING_PATHS[path])
    if kw.pop("moe", None):
        kw["moe_fn"] = oracle
    return kw


def _assert_path_taken(path, system):
    """The option under test really changed how the system served."""
    summary = system.scheduler.summary()
    if path == "interleave":
        assert system.decode.interleaved
    elif path == "migrating_pool":
        assert summary["migrations"] >= 1
    elif path == "streamed":
        assert summary["stream_chunks"] > summary["completed"]
    elif path == "chunked_prefill":
        assert all(p.continue_calls > 0 for p in system.prefills)


@pytest.mark.parametrize("path", list(SERVING_PATHS))
def test_serving_matches_jax(r1, path):
    """Every serving path (per-step and chunked decode, microbatch
    interleave, a two-engine pool with migration, the streamed handoff,
    chunked prefill) emits JAX's tokens and writes JAX's trace records and
    SLO summary, on the same requests and weights."""
    cfg, tcfg, jp, tp, prompts = r1
    js = JServingSystem(jp, cfg, n_prefill=2, decode_batch=2, capacity=48,
                        **_system_kw(path, j_moe_reference))
    jres = {r.rid: r.tokens for r in js.serve(
        [JRequest(i, p, _max_new(i)) for i, p in enumerate(prompts)])}
    tres, ts = _serve_port(tp, tcfg, prompts,
                           **_system_kw(path, moe_reference))
    _assert_path_taken(path, ts)
    assert tres == jres
    assert ts.scheduler.trace_records() == js.scheduler.trace_records()
    assert repr(ts.scheduler.summary()) == repr(js.scheduler.summary())
    if path == "per_step":
        margin = min(_min_margin(tcfg, tp, p, jres[i])
                     for i, p in enumerate(prompts))
        assert margin > 20 * LOGIT_TOL, margin


@pytest.mark.parametrize("path", ORACLE_PATHS)
def test_serving_paths_token_identical(r1, path):
    """Each path also emits the per-step path's tokens (the JAX package
    holds the same invariants in its own tests); the dense MoE oracle keeps
    the comparison exact."""
    _, tcfg, _, tp, prompts = r1
    base, _ = _serve_port(tp, tcfg, prompts, moe_fn=moe_reference)
    got, _ = _serve_port(tp, tcfg, prompts, **_system_kw(path, moe_reference))
    assert got == base


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_request_round_trip_is_bit_exact(r1, dtype):
    _, tcfg, _, _, _ = r1
    caches = {k: {"mla": torch.randn(v["mla"].shape).to(dtype),
                  "length": v["length"]}
              for k, v in port_serving.engine.model_mod.make_caches(
                  tcfg, 3, 16, dtype, "cpu").items()}
    req = cache_ops.slice_request(tcfg, caches, 1)
    flat = cache_ops.pack_request(tcfg, req)
    assert flat.dtype == np.uint8
    back = cache_ops.unpack_request(
        tcfg, flat, cache_ops.slice_request(tcfg, caches, 0))
    dst = {k: {"mla": torch.zeros_like(v["mla"]), "length": v["length"]}
           for k, v in caches.items()}
    cache_ops.insert_request(tcfg, dst, back, 2)
    for k in caches:
        assert torch.equal(dst[k]["mla"][:, 2].view(torch.uint8),
                           caches[k]["mla"][:, 1].view(torch.uint8))
    with pytest.raises(ValueError):
        cache_ops.unpack_request(tcfg, flat[:-1], req)


def test_migration_between_engines_keeps_decoding_identically(r1):
    """A slot exported mid-decode and imported into another engine's slot
    decodes exactly as it does when it stays put."""
    _, tcfg, _, tp, prompts = r1
    from repro_torch.serving.engine import PrefillEngine, RequestResult

    first, caches, _ = PrefillEngine(tp, tcfg, 48, device="cpu").run(
        Request(0, prompts[0], N_NEW))
    stay, src, dst = (DecodeEngine(tp, tcfg, 2, 48, device="cpu")
                      for _ in range(3))
    res_stay, res_moved = RequestResult(0, []), RequestResult(0, [])
    stay.add(0, caches, first, len(prompts[0]), res_stay, N_NEW)
    src.add(0, caches, first, len(prompts[0]), res_moved, N_NEW)
    stay.step()
    src.step()
    flat, cl, tok, drf = src.export_slot(0)
    dst.import_slot(1, flat, cl, tok, drf, 0, src.slot_mgr.get(0).payload)
    src.slot_mgr.release(0)
    while stay.active:
        stay.step()
    while dst.active:
        dst.step()
    assert len(res_stay.tokens) == N_NEW
    assert res_moved.tokens == res_stay.tokens


def test_workload_soak_digest_equal_between_schedulers(monkeypatch):
    """The digest ``test_workload_soak`` builds over the real scheduler
    control plane is identical for the JAX package's scheduler and the
    port's copy, on the same seeded production stream."""
    n = 2 * soak.CHUNK
    jax_digest, jax_totals = soak._soak_digest(n)
    for name in ("DecodeSlotManager", "Scheduler", "SchedulerConfig",
                 "production_requests"):
        monkeypatch.setattr(soak, name, getattr(port_serving, name))
    port_digest, port_totals = soak._soak_digest(n)
    assert port_digest == jax_digest
    assert port_totals == jax_totals
