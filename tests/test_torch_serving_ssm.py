"""The port's serving stack on Mamba2 against the JAX package at
``smoke("mamba2-780m")`` (float32, shared weights through
``repro_torch.convert``): on every serving path, emitted tokens, the
scheduler's virtual-clock trace records and its summary must be identical.
The KV handoff moves the whole SSM state, so the trace's transfer times
also hold the two caches' byte counts equal. Equality is not luck: the
model tests hold every logit to 2e-4 of JAX's, so two tokens can swap only
where the top-1/top-2 margin is below 4e-4; the smallest margin along every
greedy path is asserted to be at least twice that (it reads 2.8e-3 here,
the smoke model's tied head giving logits of unit scale).

Prompt lengths include ones the SSD chunk (32) does not divide, where JAX
falls to 1-row chunks and the port takes a ragged last chunk.
"""
import jax
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.models import init_params as j_init_params
from repro.serving import Request as JRequest
from repro.serving import ServingSystem as JServingSystem
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import params_from_jax_numpy
from repro_torch.models import decode_step as t_decode_step
from repro_torch.models import model as t_model
from repro_torch.models import prefill as t_prefill
from repro_torch.serving import Request, ServingSystem
from repro_torch.serving.engine import DecodeEngine, PrefillEngine, RequestResult

LOGIT_TOL = 2e-4
N_NEW = 6
CAPACITY = 64
PROMPT_LENS = (12, 37, 20, 45, 33)


@pytest.fixture(scope="module")
def m2():
    cfg = smoke("mamba2-780m")
    tcfg = smoke_variant(get_config("mamba2-780m"))
    jp = jax.jit(j_init_params, static_argnums=(1,))(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.RandomState(11)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in PROMPT_LENS]
    return cfg, tcfg, jp, tp, prompts


def _max_new(i):
    """Long and short requests alternate, so a two-engine pool drains
    unevenly and its rebalancer migrates a request."""
    return N_NEW if i % 2 == 0 else 2


SERVING_PATHS = {
    "per_step": {},
    "chunked_continuous": {"decode_chunk": 4, "continuous_batching": True},
    "interleave": {"interleave": True},
    "migrating_pool": {"decode_engines": 2, "decode_rebalance_every": 1,
                       "decode_router": "least_loaded_slots"},
    # SSM state cannot be streamed by token: both sides fall back to the
    # synchronous handoff.
    "streamed_prefill_pool": {"stream_handoff": True, "stream_chunk": 4},
}


def _serve_port(tp, tcfg, prompts, **kw):
    system = ServingSystem(tp, tcfg, n_prefill=2, decode_batch=2,
                           capacity=CAPACITY, device="cpu", **kw)
    results = system.serve([Request(i, p, _max_new(i)) for i, p in
                            enumerate(prompts)])
    return {r.rid: r.tokens for r in results}, system


def _assert_path_taken(path, system, widths):
    """The option under test really changed how the system served."""
    summary = system.scheduler.summary()
    if path == "chunked_continuous":
        assert max(widths) > 1
    elif path == "interleave":
        assert system.decode.interleaved
    elif path == "migrating_pool":
        assert summary["migrations"] >= 1
    elif path == "streamed_prefill_pool":
        assert system.scheduler.config.stream_handoff
        assert not system._streamable()
        assert summary.get("stream_chunks", 0) == 0
        assert len({r["prefill_instance"] for r in
                    system.scheduler.trace_records()}) == 2


def _min_margin(tcfg, tp, prompt, tokens):
    """Smallest top-1/top-2 logit gap along a greedy path (the port's
    logits, which match JAX's to ~1e-5)."""
    logits, caches = t_prefill(tp, tcfg, {"tokens": torch.tensor([prompt])},
                               CAPACITY, cache_dtype=torch.float32)
    rows = [logits[0, -1]]
    for i, tok in enumerate(tokens[:-1]):
        lg, caches = t_decode_step(tp, tcfg, torch.tensor([[tok]]), caches,
                                   torch.tensor(len(prompt) + i))
        rows.append(lg[0])
    top2 = torch.stack(rows).topk(2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


@pytest.mark.parametrize("path", list(SERVING_PATHS))
def test_serving_matches_jax(m2, monkeypatch, path):
    """Per-step and chunked continuous decode, microbatch interleave, a
    migrating two-engine decode pool, and a prefill pool asked to stream
    (which hands off synchronously for SSM state, as in JAX) emit JAX's
    tokens and write JAX's trace records and SLO summary."""
    cfg, tcfg, jp, tp, prompts = m2
    widths = []
    loop = t_model.decode_loop

    def counting_loop(*args, **kw):
        widths.append(args[5])
        return loop(*args, **kw)

    monkeypatch.setattr(t_model, "decode_loop", counting_loop)
    kw = SERVING_PATHS[path]
    js = JServingSystem(jp, cfg, n_prefill=2, decode_batch=2,
                        capacity=CAPACITY, **kw)
    jres = {r.rid: r.tokens for r in js.serve(
        [JRequest(i, p, _max_new(i)) for i, p in enumerate(prompts)])}
    tres, ts = _serve_port(tp, tcfg, prompts, **kw)
    _assert_path_taken(path, ts, widths or [1])
    assert tres == jres
    assert ts.scheduler.trace_records() == js.scheduler.trace_records()
    assert repr(ts.scheduler.summary()) == repr(js.scheduler.summary())
    if path == "per_step":
        margin = min(_min_margin(tcfg, tp, p, jres[i])
                     for i, p in enumerate(prompts))
        assert margin > 4 * LOGIT_TOL, margin


def test_decode_engine_caches_are_decode_ready(m2):
    """The decode engine holds the conv window in the dtype a step
    produces (f32 in this f32 model), so steps write the slots in place:
    the state tensors are the same objects after a step, with and without
    microbatch interleave."""
    _, tcfg, _, tp, prompts = m2
    first, caches, _ = PrefillEngine(tp, tcfg, CAPACITY, device="cpu").run(
        Request(0, prompts[1], N_NEW))
    assert caches["mamba"].conv.dtype == torch.bfloat16
    for interleave in (False, True):
        eng = DecodeEngine(tp, tcfg, 2, CAPACITY, interleave=interleave,
                           device="cpu")
        assert eng.interleaved == interleave
        st = eng.caches["mamba"]
        assert (st.h.dtype, st.conv.dtype) == (torch.float32, torch.float32)
        eng.add(1, caches, first, len(prompts[1]), RequestResult(0, []), N_NEW)
        eng.step()
        assert eng.caches["mamba"].h is st.h
        assert eng.caches["mamba"].conv is st.conv


def test_migration_between_engines_keeps_decoding_identically(m2):
    """A slot exported mid-decode and imported into another engine's slot
    decodes exactly as it does when it stays put."""
    _, tcfg, _, tp, prompts = m2
    first, caches, _ = PrefillEngine(tp, tcfg, CAPACITY, device="cpu").run(
        Request(0, prompts[3], N_NEW))
    stay, src, dst = (DecodeEngine(tp, tcfg, 2, CAPACITY, device="cpu")
                      for _ in range(3))
    res_stay, res_moved = RequestResult(0, []), RequestResult(0, [])
    stay.add(0, caches, first, len(prompts[3]), res_stay, N_NEW)
    src.add(0, caches, first, len(prompts[3]), res_moved, N_NEW)
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
