"""Open-loop workload generation for the PDC serving system.

The paper evaluates serving under *open-loop* load: requests arrive on
their own clock and the scheduler must absorb bursts, not a closed loop
that feeds the next request only when the previous one finishes. This
module generates arrival-timed request streams for
``ServingSystem.serve(..., open_loop=True)``, which replays them on the
scheduler's virtual timeline so the TPOT admission gate (queue/shed) is
exercised under genuine queueing pressure.

Production suite: beyond the homogeneous :func:`poisson_requests` stream,
:func:`production_requests` draws heavy-tailed (lognormal, clipped)
prompt/output length mixtures under Poisson, bursty, or diurnal arrival
shapes with a per-class interactive/batch mix, and
:func:`multi_turn_sessions` generates multi-turn conversations whose
later turns re-enter with the grown prefix of everything said so far
(the EMS context-cache reuse pattern). Every generator is driven by a
single ``np.random.RandomState(seed)``, so identical arguments produce
bit-identical streams — the soak's determinism digest depends on it.
``start``/``rid_base`` let callers generate a long stream in independent
chunks (per-chunk seeds) without rid collisions or time overlap.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from repro_torch.serving.engine import Request

#: arrival-shape registry for production_requests
ARRIVAL_SHAPES = ("poisson", "burst", "diurnal")


def poisson_requests(n_requests: int, rate_rps: float, prompt_len: int,
                     max_new: int, vocab_size: int, *, seed: int,
                     shared_prefix: int = 0,
                     start: float = 0.0,
                     slo_class: str = "interactive",
                     rid_base: int = 0) -> List[Request]:
    """Homogeneous Poisson arrival stream: exponential inter-arrival gaps
    at ``rate_rps`` requests per (virtual) second.

    ``shared_prefix`` tokens are common across all prompts so the stream
    also exercises EMS context-cache reuse under load;
    ``shared_prefix == prompt_len`` makes every prompt identical — the
    fully-cached multi-turn re-entry stream the EMS benches replay.
    ``seed`` is a
    *required* keyword: every arrival gap and prompt token comes from one
    PRNG seeded with it, so the stream — and therefore the scheduler's
    virtual timeline and every SLO statistic derived from it — is exactly
    reproducible across runs (benches replay identical traces).
    ``slo_class`` stamps every request with an SLO tier; ``rid_base``
    offsets the request ids so independently generated streams can be
    merged without collisions.
    """
    if n_requests < 1:
        raise ValueError("n_requests must be positive")
    if rate_rps <= 0:
        raise ValueError("rate_rps must be positive")
    if prompt_len < 1:
        raise ValueError("prompt_len must be positive")
    if max_new < 1:
        raise ValueError("max_new must be positive")
    if not 0 <= shared_prefix <= prompt_len:
        raise ValueError("shared_prefix must be in [0, prompt_len]")
    rng = np.random.RandomState(seed)
    arrivals = start + np.cumsum(rng.exponential(1.0 / rate_rps, n_requests))
    prefix = list(rng.randint(0, vocab_size, shared_prefix))
    return [
        Request(rid_base + i,
                prefix + list(rng.randint(0, vocab_size,
                                          prompt_len - shared_prefix)),
                max_new, arrival=float(arrivals[i]), slo_class=slo_class)
        for i in range(n_requests)
    ]


def _lognormal_lengths(rng: np.random.RandomState, n: int, median: int,
                       sigma: float, max_len: int) -> np.ndarray:
    """Heavy-tailed integer lengths: lognormal with the given median and
    log-sigma, clipped to ``[1, max_len]`` (the tail mass lands on the
    clip, which is exactly how real serving truncates context)."""
    draws = rng.lognormal(mean=math.log(max(1, median)), sigma=sigma, size=n)
    return np.clip(np.rint(draws), 1, max_len).astype(int)


def _arrival_times(rng: np.random.RandomState, n: int, rate_rps: float,
                   shape: str, start: float, *, burst_every_s: float,
                   burst_len_s: float, burst_factor: float,
                   diurnal_period_s: float,
                   diurnal_amplitude: float) -> List[float]:
    """Arrival instants under one of the registered shapes.

    ``poisson`` is the homogeneous stream; ``burst`` multiplies the rate
    by ``burst_factor`` inside periodic windows (``burst_len_s`` out of
    every ``burst_every_s``); ``diurnal`` modulates the rate sinusoidally
    over ``diurnal_period_s`` (a compressed day). Non-homogeneous shapes
    draw each gap at the *local* rate — deterministic given the seed and
    exact enough for scheduler stress, which cares about the bursts, not
    the point-process fine print.
    """
    if shape not in ARRIVAL_SHAPES:
        raise ValueError(
            f"arrival shape must be one of {ARRIVAL_SHAPES}, got {shape!r}")
    t = start
    out: List[float] = []
    for _ in range(n):
        if shape == "poisson":
            local = rate_rps
        elif shape == "burst":
            in_burst = (t % burst_every_s) < burst_len_s
            local = rate_rps * (burst_factor if in_burst else 1.0)
        else:  # diurnal
            phase = 2.0 * math.pi * (t % diurnal_period_s) / diurnal_period_s
            local = rate_rps * (1.0 + diurnal_amplitude * math.sin(phase))
            local = max(local, 0.05 * rate_rps)
        t += float(rng.exponential(1.0 / local))
        out.append(t)
    return out


def production_requests(n_requests: int, *, seed: int, vocab_size: int,
                        rate_rps: float, arrival_shape: str = "poisson",
                        prompt_len_median: int = 32,
                        prompt_len_sigma: float = 0.6,
                        prompt_len_max: int = 256,
                        max_new_median: int = 8,
                        max_new_sigma: float = 0.7,
                        max_new_max: int = 64,
                        interactive_frac: float = 0.7,
                        burst_every_s: float = 1.0,
                        burst_len_s: float = 0.2,
                        burst_factor: float = 8.0,
                        diurnal_period_s: float = 10.0,
                        diurnal_amplitude: float = 0.8,
                        shared_prefix: int = 0,
                        start: float = 0.0,
                        rid_base: int = 0) -> List[Request]:
    """Production-shaped request stream: heavy-tailed lognormal prompt and
    output lengths, a per-request interactive/batch class mix
    (``interactive_frac`` is the Bernoulli probability of the interactive
    tier), and a configurable arrival shape (``poisson`` | ``burst`` |
    ``diurnal``). Seed-deterministic end to end; ``start``/``rid_base``
    support chunked generation of arbitrarily long streams.
    """
    if n_requests < 1:
        raise ValueError("n_requests must be positive")
    if rate_rps <= 0:
        raise ValueError("rate_rps must be positive")
    if not 0.0 <= interactive_frac <= 1.0:
        raise ValueError("interactive_frac must be in [0, 1]")
    if prompt_len_median < 1 or max_new_median < 1:
        raise ValueError("length medians must be positive")
    if not 0 <= shared_prefix <= prompt_len_max:
        raise ValueError("shared_prefix must be in [0, prompt_len_max]")
    rng = np.random.RandomState(seed)
    arrivals = _arrival_times(
        rng, n_requests, rate_rps, arrival_shape, start,
        burst_every_s=burst_every_s, burst_len_s=burst_len_s,
        burst_factor=burst_factor, diurnal_period_s=diurnal_period_s,
        diurnal_amplitude=diurnal_amplitude)
    prompt_lens = _lognormal_lengths(rng, n_requests, prompt_len_median,
                                     prompt_len_sigma, prompt_len_max)
    max_news = _lognormal_lengths(rng, n_requests, max_new_median,
                                  max_new_sigma, max_new_max)
    classes = np.where(rng.uniform(size=n_requests) < interactive_frac,
                       "interactive", "batch")
    prefix = list(rng.randint(0, vocab_size, shared_prefix))
    reqs = []
    for i in range(n_requests):
        plen = max(int(prompt_lens[i]), shared_prefix + 1) \
            if shared_prefix else int(prompt_lens[i])
        body = list(rng.randint(0, vocab_size, plen - shared_prefix))
        reqs.append(Request(rid_base + i, prefix + body, int(max_news[i]),
                            arrival=float(arrivals[i]),
                            slo_class=str(classes[i])))
    return reqs


def multi_turn_sessions(n_sessions: int, *, seed: int, vocab_size: int,
                        session_rate_rps: float, turns: int = 3,
                        turn_tokens_median: int = 12,
                        turn_tokens_sigma: float = 0.5,
                        turn_tokens_max: int = 64,
                        max_new_median: int = 6,
                        max_new_sigma: float = 0.5,
                        max_new_max: int = 32,
                        think_time_s: float = 0.02,
                        slo_class: str = "interactive",
                        start: float = 0.0,
                        rid_base: int = 0) -> List[Request]:
    """Multi-turn conversation sessions: each session starts on a Poisson
    clock at ``session_rate_rps``; turn ``t+1`` re-enters with the *grown
    prefix* of turn ``t``'s full context (its prompt plus a reply-sized
    continuation) followed by a fresh user utterance — the EMS
    context-cache reuse pattern, where only the new suffix needs prefill
    compute. Turn gaps are exponential around ``think_time_s`` plus the
    previous turn's reply budget on the virtual clock. Seed-deterministic;
    rids are dense from ``rid_base`` in (session, turn) order.
    """
    if n_sessions < 1:
        raise ValueError("n_sessions must be positive")
    if turns < 1:
        raise ValueError("turns must be positive")
    if session_rate_rps <= 0:
        raise ValueError("session_rate_rps must be positive")
    if think_time_s < 0:
        raise ValueError("think_time_s must be non-negative")
    rng = np.random.RandomState(seed)
    session_starts = start + np.cumsum(
        rng.exponential(1.0 / session_rate_rps, n_sessions))
    reqs: List[Request] = []
    rid = rid_base
    for s in range(n_sessions):
        t = float(session_starts[s])
        context: List[int] = []
        for _turn in range(turns):
            utter = int(_lognormal_lengths(rng, 1, turn_tokens_median,
                                           turn_tokens_sigma,
                                           turn_tokens_max)[0])
            max_new = int(_lognormal_lengths(rng, 1, max_new_median,
                                             max_new_sigma, max_new_max)[0])
            prompt = context + list(rng.randint(0, vocab_size, utter))
            reqs.append(Request(rid, prompt, max_new, arrival=t,
                                slo_class=slo_class))
            rid += 1
            # The next turn's context is this turn's full prompt plus a
            # reply-sized continuation (the assistant's turn): generation
            # happens at serve time, so the *shape* of the grown prefix is
            # what the workload models — prefix reuse hits on the prompt
            # part either way.
            context = prompt + list(rng.randint(0, vocab_size, max_new))
            t += max_new * 1e-3 + float(rng.exponential(max(think_time_s,
                                                            1e-6)))
    reqs.sort(key=lambda r: (r.arrival, r.rid))
    return reqs
