"""The port's serving stack on the Zamba2 hybrid against the JAX package at
``smoke("zamba2-1.2b")`` (float32, shared weights through
``repro_torch.convert``): on every serving path, emitted tokens, the
scheduler's virtual-clock trace records and its summary must be identical.
The KV handoff moves the whole group state (SSM state and the shared
block's K/V), so the trace's transfer times also hold the two caches' byte
counts equal. Equality is not luck: the model tests hold every logit to
2e-4 of JAX's, so two tokens can swap only where the top-1/top-2 margin is
below 4e-4; the smallest margin along every greedy path is asserted to be
at least four times that.

Also here: the decode engine's microbatch interleave falls back with JAX's
warning for a hybrid (whose SSM state has batch on axis 2), and the serve
CLI prints the JAX CLI's lines on ``zamba2-1.2b``.
"""
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.launch import serve as j_serve
from repro.mempool import ContextCache as JContextCache
from repro.mempool import MemoryPool as JMemoryPool
from repro.models import init_params as j_init_params
from repro.serving import Request as JRequest
from repro.serving import ServingSystem as JServingSystem
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import params_from_jax_numpy
from repro_torch.launch import serve as t_serve
from repro_torch.mempool import ContextCache, MemoryPool
from repro_torch.models import decode_step as t_decode_step
from repro_torch.models import model as t_model
from repro_torch.models import prefill as t_prefill
from repro_torch.serving import Request, ServingSystem

LOGIT_TOL = 2e-4
N_NEW = 5
CAPACITY = 48
PROMPT_LENS = (12, 37, 20, 33)


@pytest.fixture(scope="module")
def zb():
    cfg = smoke("zamba2-1.2b")
    tcfg = smoke_variant(get_config("zamba2-1.2b"))
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
    "migrating_pool": {"decode_engines": 2, "decode_rebalance_every": 1,
                       "decode_router": "least_loaded_slots"},
    # Group state cannot be streamed by token: both sides fall back to the
    # synchronous handoff.
    "streamed_prefill_pool": {"stream_handoff": True, "stream_chunk": 4},
}


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
def test_serving_matches_jax(zb, monkeypatch, path):
    """Per-step and chunked continuous decode, a migrating two-engine
    decode pool, and a prefill pool asked to stream (which hands off
    synchronously for a hybrid, as in JAX) emit JAX's tokens and write
    JAX's trace records and SLO summary."""
    cfg, tcfg, jp, tp, prompts = zb
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
    ts = ServingSystem(tp, tcfg, n_prefill=2, decode_batch=2,
                       capacity=CAPACITY, device="cpu", **kw)
    tres = {r.rid: r.tokens for r in ts.serve(
        [Request(i, p, _max_new(i)) for i, p in enumerate(prompts)])}
    summary = ts.scheduler.summary()
    if path == "chunked_continuous":
        assert max(widths) > 1
    elif path == "migrating_pool":
        assert summary["migrations"] >= 1
    elif path == "streamed_prefill_pool":
        assert ts.scheduler.config.stream_handoff and not ts._streamable()
        assert summary["stream_requests"] == 0
        assert summary.get("stream_chunks", 0) == 0
    assert tres == jres
    assert ts.scheduler.trace_records() == js.scheduler.trace_records()
    assert repr(summary) == repr(js.scheduler.summary())
    if path == "per_step":
        margin = min(_min_margin(tcfg, tp, p, jres[i])
                     for i, p in enumerate(prompts))
        assert margin > 4 * LOGIT_TOL, margin


def test_context_cache_reuses_nothing(zb):
    """A context cache beside a hybrid is never consulted, as in JAX: no
    request reuses a token, nothing is stored, and the tokens, trace and
    summary equal JAX's."""
    cfg, tcfg, jp, tp, prompts = zb
    shared = prompts[1][:16]
    reqs = [(i, shared + p, 3) for i, p in enumerate(prompts[:3])]
    jcc = JContextCache(JMemoryPool(n_nodes=2), block_tokens=8,
                        model_tag=cfg.name)
    js = JServingSystem(jp, cfg, n_prefill=2, decode_batch=2,
                        capacity=CAPACITY + 16, context_cache=jcc)
    jres = js.serve([JRequest(*r) for r in reqs])
    pool = MemoryPool(n_nodes=2)
    tcc = ContextCache(pool, block_tokens=8, model_tag=tcfg.name)
    ts = ServingSystem(tp, tcfg, n_prefill=2, decode_batch=2,
                       capacity=CAPACITY + 16, context_cache=tcc,
                       device="cpu")
    tres = ts.serve([Request(*r) for r in reqs])
    assert [r.reused_tokens for r in tres] == [0, 0, 0] == \
        [r.reused_tokens for r in jres]
    assert {r.rid: r.tokens for r in tres} == {r.rid: r.tokens for r in jres}
    assert ts.scheduler.trace_records() == js.scheduler.trace_records()
    assert repr(ts.scheduler.summary()) == repr(js.scheduler.summary())
    assert pool.stats()["dram_used"] == 0
    assert all(p.suffix_calls == 0 for p in ts.prefills)


def test_hybrid_interleave_falls_back_with_warning(zb):
    """Hybrid caches nest SSM state with batch on axis 2, which the
    microbatch split would mis-slice: interleave turns itself off with JAX's
    warning, on both sides, and the serve equals JAX's."""
    cfg, tcfg, jp, tp, _ = zb
    rng = np.random.RandomState(3)
    prompts = [list(rng.randint(0, cfg.vocab_size, 12)) for _ in range(2)]
    with pytest.warns(UserWarning, match="hybrid") as jw:
        js = JServingSystem(jp, cfg, n_prefill=1, decode_batch=2,
                            capacity=32, interleave=True)
    with pytest.warns(UserWarning, match="hybrid") as tw:
        ts = ServingSystem(tp, tcfg, n_prefill=1, decode_batch=2,
                           capacity=32, interleave=True, device="cpu")
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert not ts.decode.interleaved and not js.decode.interleaved
    jres = js.serve([JRequest(i, p, 3) for i, p in enumerate(prompts)])
    tres = ts.serve([Request(i, p, 3) for i, p in enumerate(prompts)])
    assert all(len(r.tokens) == 3 for r in tres)
    assert {r.rid: r.tokens for r in tres} == {r.rid: r.tokens for r in jres}


def _lines(text):
    """Printed lines without the wall-clock line (host timing)."""
    return [ln for ln in text.splitlines() if " wall (" not in ln]


def test_cli_prints_jax_lines(monkeypatch, capsys):
    """With the JAX CLI's weights carried across, the port's CLI prints the
    JAX CLI's lines on ``zamba2-1.2b`` (per-rid lines with nothing reused,
    SLO summary, decode pool, EMS and transfer lines, ``--trace`` JSON)."""
    argv = ["--arch", "zamba2-1.2b", "--n-requests", "4", "--prompt-len",
            "16", "--max-new", "4", "--decode-chunk", "4",
            "--decode-engines", "2", "--trace"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    j_serve.main()
    want = capsys.readouterr().out
    monkeypatch.undo()

    def same_params(cfg, seed=0, device=None):
        jp = j_init_params(jax.random.PRNGKey(seed), smoke("zamba2-1.2b"))
        return params_from_jax_numpy(jax.tree.map(np.asarray, jp), cfg, device)

    monkeypatch.setattr(t_serve, "init_params", same_params)
    t_serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _lines(got) == _lines(want)
    assert got.count("rid=") == 4 and got.count("reused=0") == 4
