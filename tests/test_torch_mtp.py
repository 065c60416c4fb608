"""The port's MTP speculative decoding (``repro_torch/core/mtp.py``,
``models/model.py::decode_loop_mtp`` and the decode engine's MTP paths)
against the JAX package at ``smoke("deepseek-r1")`` (float32, weights and
draft heads shared through ``repro_torch.convert``).

Greedy tokens, acceptance, liveness and ``cache_len`` must be identical,
fused and unfused, including the freeze cases of
``tests/test_mtp_fastpath.py``; logits and latent caches agree within the
port's float32 tolerance (2e-4). ``sample_top_p`` draws from a JAX key on
one side and a ``torch.Generator`` on the other, so it is compared by the
set of tokens it can draw and its cutoff index, not by the token drawn.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.core import mtp as j_mtp
from repro.models import decode_step as j_decode_step
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.models.model import decode_loop_mtp as j_decode_loop_mtp
from repro.serving import Request as JRequest
from repro.serving import ServingSystem as JServingSystem
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import mtp_from_jax_numpy, params_from_jax_numpy
from repro_torch.core import mtp
from repro_torch.kernels.mla_attention import ops as mla_ops
from repro_torch.kernels.mla_attention import plan as mla_plan
from repro_torch.models import decode_loop_mtp, prefill
from repro_torch.serving import (DecodeCostModel, Request, SchedulerConfig,
                                 ServingSystem, cache_ops)

LOGIT_TOL = 2e-4
N_REQ, PLEN = 3, 12


@pytest.fixture(scope="module")
def r1():
    cfg = smoke("deepseek-r1")
    tcfg = smoke_variant(get_config("deepseek-r1"))
    jp = jax.jit(j_init_params, static_argnums=(1,))(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jm = j_mtp.init_mtp_params(jax.random.PRNGKey(1), cfg)
    rng = np.random.RandomState(11)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, 12)]
               for _ in range(5)]
    # A head distilled on the served prompts, so that drafts are accepted
    # (an untrained head accepts at chance level).
    jfit = j_mtp.fit_draft_head(jp, cfg, jm, jax.random.PRNGKey(2),
                                prompts=np.asarray(prompts, np.int32),
                                gen_len=16, steps=100)
    return dict(cfg=cfg, tcfg=tcfg, jp=jp, tp=tp, prompts=prompts,
                jm=jm, tm=_head(jm, tcfg), jfit=jfit, tfit=_head(jfit, tcfg))


def _head(jhead, tcfg):
    return mtp_from_jax_numpy(jax.tree.map(np.asarray, jhead), tcfg, "cpu")


def _prefill_both(r, n_req=N_REQ, plen=PLEN, capacity=40):
    """Prefill of the first ``plen`` tokens of the first ``n_req`` served
    prompts (those the fitted head was distilled on) on both sides."""
    prompts = np.asarray(r["prompts"][:n_req], np.int64)[:, :plen]
    jl, jc = j_prefill(r["jp"], r["cfg"], {"tokens": jnp.asarray(prompts,
                                                                  jnp.int32)},
                       capacity=capacity, cache_dtype=jnp.float32)
    tl, tc = prefill(r["tp"], r["tcfg"],
                     {"tokens": torch.from_numpy(prompts).int()}, capacity,
                     cache_dtype=torch.float32)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1], -1).int()
    assert np.array_equal(np.asarray(jtok), ttok.numpy())
    jcl = jnp.full((n_req,), plen, jnp.int32)
    tcl = torch.full((n_req,), plen, dtype=torch.int32)
    return (jtok, jc, jcl), (ttok, tc, tcl)


def _latents(caches):
    return np.concatenate([np.asarray(caches[k]["mla"]).ravel()
                           for k in sorted(caches)])


def _assert_loop_equal(jout, tout):
    """decode_loop_mtp results: emitted where meaningful, acceptance,
    liveness, lengths, carried tokens/drafts identical; latents close."""
    jem, jacc, jlv, jtok, jdrf, jc, jcl = (jout[0], jout[1], jout[2], jout[3],
                                           jout[4], jout[5], jout[6])
    tem, tacc, tlv, ttok, tdrf, tc, tcl = tout
    jlv, jacc, jem = np.asarray(jlv), np.asarray(jacc), np.asarray(jem)
    assert np.array_equal(tlv.numpy(), jlv)
    assert np.array_equal(tacc.numpy(), jacc)
    tem = tem.numpy()
    assert np.array_equal(tem[..., 0][jlv], jem[..., 0][jlv])
    assert np.array_equal(tem[..., 1][jacc], jem[..., 1][jacc])
    assert np.array_equal(tcl.numpy(), np.asarray(jcl))
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    assert np.array_equal(tdrf.numpy(), np.asarray(jdrf))
    np.testing.assert_allclose(_latents(tc), _latents(jc), rtol=0,
                               atol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# The draft head and one iteration
# ---------------------------------------------------------------------------


def test_draft_head_matches_jax(r1):
    cfg, tcfg = r1["cfg"], r1["tcfg"]
    tok = np.random.RandomState(3).randint(0, cfg.vocab_size, 16)
    hidden = r1["jp"]["embed"][tok]
    jl = j_mtp.draft_logits(r1["jp"], r1["jm"], cfg, hidden, jnp.asarray(tok))
    tl = mtp.draft_logits(r1["tp"], r1["tm"], tcfg, r1["tp"].embed[tok],
                          torch.from_numpy(tok))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_TOL)
    assert np.array_equal(
        mtp.propose_draft(r1["tp"], r1["tm"], tcfg,
                          torch.from_numpy(tok).int()).numpy(),
        np.asarray(j_mtp.propose_draft(r1["jp"], r1["jm"], cfg,
                                       jnp.asarray(tok, jnp.int32))))


@pytest.mark.parametrize("fused", [False, True])
def test_mtp_step_matches_jax(r1, fused):
    """One iteration: the verification logits (two decode steps or the
    fused two-token forward) within 2e-4, everything sampled identical."""
    (jtok, jc, jcl), (ttok, tc, tcl) = _prefill_both(r1)
    jd = j_mtp.propose_draft(r1["jp"], r1["jfit"], r1["cfg"], jtok)
    td = mtp.propose_draft(r1["tp"], r1["tfit"], r1["tcfg"], ttok)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    if fused:
        jl1, jl2, _ = j_mtp.verify_pair(r1["jp"], r1["cfg"], jtok, jd, jc, jcl)
        tl1, tl2, _ = mtp.verify_pair(r1["tp"], r1["tcfg"], ttok, td,
                                      {k: {**v, "mla": v["mla"].clone()}
                                       for k, v in tc.items()}, tcl)
        for a, b in ((tl1, jl1), (tl2, jl2)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=LOGIT_TOL)
    jout = j_mtp.mtp_step(r1["jp"], r1["jfit"], r1["cfg"], jtok, jd, jc, jcl,
                          jax.random.PRNGKey(0), fused_verify=fused)
    tout = mtp.mtp_step(r1["tp"], r1["tfit"], r1["tcfg"], ttok, td, tc, tcl,
                        fused_verify=fused)
    for i in (0, 1, 2, 3, 5):
        assert np.array_equal(tout[i].numpy(), np.asarray(jout[i])), i
    np.testing.assert_allclose(_latents(tout[4]), _latents(jout[4]), rtol=0,
                               atol=LOGIT_TOL)


def test_can_fuse_verify_gating():
    assert mtp.can_fuse_verify(smoke_variant(get_config("deepseek-r1")), 32)
    assert not mtp.can_fuse_verify(smoke_variant(get_config("mamba2-780m")),
                                   32)


# ---------------------------------------------------------------------------
# decode_loop_mtp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
def test_decode_loop_mtp_matches_jax(r1, fused):
    (jtok, jc, jcl), (ttok, tc, tcl) = _prefill_both(r1)
    jd = j_mtp.propose_draft(r1["jp"], r1["jfit"], r1["cfg"], jtok)
    td = mtp.propose_draft(r1["tp"], r1["tfit"], r1["tcfg"], ttok)
    jout = j_decode_loop_mtp(r1["jp"], r1["jfit"], r1["cfg"], jtok, jd, jc,
                             jcl, 5, key=jax.random.PRNGKey(5),
                             fused_verify=fused)
    tout = decode_loop_mtp(r1["tp"], r1["tfit"], r1["tcfg"], ttok, td, tc,
                           tcl, 5, fused_verify=fused)
    _assert_loop_equal(jout, tout)
    assert tout[1].any() and not tout[1].all()      # accepts and rejects


def _shared_noise(monkeypatch, b, v):
    """Both sides' ``sample_top_p`` draw the same uniform noise: the first
    of two seeded arrays for the base token, the second for the draft's
    verification, in every iteration (JAX traces a scanned iteration once,
    so its draws repeat per iteration; the port's are made to repeat the
    same way). Returns the draw counts (JAX's, the port's)."""
    rng = np.random.RandomState(7)
    noise = [rng.uniform(0.0, 1.0, (b, v)).astype(np.float32)
             for _ in range(2)]
    calls = [0, 0]

    def j_uniform(key, shape):
        calls[0] += 1
        return jnp.asarray(noise[(calls[0] - 1) % 2])

    def t_uniform(shape, generator, device):
        calls[1] += 1
        return torch.from_numpy(noise[(calls[1] - 1) % 2])

    monkeypatch.setattr(j_mtp.jax.random, "uniform", j_uniform)
    monkeypatch.setattr(mtp, "_uniform", t_uniform)
    return calls


@pytest.mark.parametrize("fused", [False, True])
def test_mtp_step_sampled_matches_jax(r1, fused, monkeypatch):
    """The sampled verify (``greedy=False``): given the same noise, the
    same tokens, acceptance and lengths as JAX's, and latents within 2e-4."""
    (jtok, jc, jcl), (ttok, tc, tcl) = _prefill_both(r1)
    jd = j_mtp.propose_draft(r1["jp"], r1["jfit"], r1["cfg"], jtok)
    td = mtp.propose_draft(r1["tp"], r1["tfit"], r1["tcfg"], ttok)
    calls = _shared_noise(monkeypatch, N_REQ, r1["cfg"].vocab_size)
    jout = j_mtp.mtp_step(r1["jp"], r1["jfit"], r1["cfg"], jtok, jd, jc, jcl,
                          jax.random.PRNGKey(0), greedy=False,
                          fused_verify=fused)
    tout = mtp.mtp_step(r1["tp"], r1["tfit"], r1["tcfg"], ttok, td, tc, tcl,
                        torch.Generator().manual_seed(0), greedy=False,
                        fused_verify=fused)
    assert calls == [2, 2]
    for i in (0, 1, 2, 3, 5):
        assert np.array_equal(tout[i].numpy(), np.asarray(jout[i])), i
    np.testing.assert_allclose(_latents(tout[4]), _latents(jout[4]), rtol=0,
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_decode_loop_mtp_sampled_matches_jax(r1, fused, monkeypatch):
    """``decode_loop_mtp(greedy=False)`` against JAX's with the same noise:
    emitted tokens, acceptance, liveness and lengths identical. The sampled
    stream leaves the greedy one, so the sampled branch is what ran."""
    (jtok, jc, jcl), (ttok, tc, tcl) = _prefill_both(r1)
    jd = j_mtp.propose_draft(r1["jp"], r1["jfit"], r1["cfg"], jtok)
    td = mtp.propose_draft(r1["tp"], r1["tfit"], r1["tcfg"], ttok)
    greedy = decode_loop_mtp(r1["tp"], r1["tfit"], r1["tcfg"], ttok, td,
                             {k: {**v, "mla": v["mla"].clone()}
                              for k, v in tc.items()}, tcl, 5,
                             fused_verify=fused)
    calls = _shared_noise(monkeypatch, N_REQ, r1["cfg"].vocab_size)
    jout = j_decode_loop_mtp(r1["jp"], r1["jfit"], r1["cfg"], jtok, jd, jc,
                             jcl, 5, key=jax.random.PRNGKey(5), greedy=False,
                             fused_verify=fused)
    tout = decode_loop_mtp(r1["tp"], r1["tfit"], r1["tcfg"], ttok, td, tc,
                           tcl, 5, generator=torch.Generator().manual_seed(5),
                           greedy=False, fused_verify=fused)
    assert calls[0] >= 2 and calls[1] == 2 * 5
    _assert_loop_equal(jout, tout)
    assert not torch.equal(tout[0][..., 0], greedy[0][..., 0])


def test_decode_loop_mtp_equals_per_step(r1):
    """n loop iterations == n sequential mtp_step calls: tokens, lengths
    and every latent bit-identical (the loop's saves and restores touch
    no live slot)."""
    _, (ttok, tc, tcl) = _prefill_both(r1)
    td = mtp.propose_draft(r1["tp"], r1["tfit"], r1["tcfg"], ttok)
    seq = {k: {**v, "mla": v["mla"].clone()} for k, v in tc.items()}
    tok, drf, cl, ems = ttok, td, tcl, []
    for _ in range(4):
        em, _, tok, drf, seq, cl = mtp.mtp_step(
            r1["tp"], r1["tfit"], r1["tcfg"], tok, drf, seq, cl)
        ems.append(em)
    em_l, _, lv, tok_l, _, loop, cl_l = decode_loop_mtp(
        r1["tp"], r1["tfit"], r1["tcfg"], ttok, td, tc, tcl, 4)
    assert lv.all()
    assert torch.equal(em_l, torch.stack(ems, 1))
    assert torch.equal(tok_l, tok) and torch.equal(cl_l, cl)
    for k in loop:
        assert torch.equal(loop[k]["mla"], seq[k]["mla"])


def test_decode_loop_mtp_accept_reject_divergence(r1):
    """Slot 0 starts with the oracle draft (a sure accept), slot 1 with a
    wrong one: lengths diverge within the batch, as in JAX."""
    (jtok, jc, jcl), (ttok, tc, tcl) = _prefill_both(r1, n_req=2)
    lg, _ = j_decode_step(r1["jp"], r1["cfg"], jtok[:, None], jc, jcl)
    oracle = np.asarray(jnp.argmax(lg, -1))
    d0 = np.asarray([oracle[0], (oracle[1] + 1) % r1["cfg"].vocab_size],
                    np.int32)
    jout = j_decode_loop_mtp(r1["jp"], r1["jm"], r1["cfg"], jtok,
                             jnp.asarray(d0), jc, jcl, 3,
                             key=jax.random.PRNGKey(3))
    tout = decode_loop_mtp(r1["tp"], r1["tm"], r1["tcfg"], ttok,
                           torch.from_numpy(d0), tc, tcl, 3)
    assert bool(tout[1][0, 0]) and not bool(tout[1][1, 0])
    _assert_loop_equal(jout, tout)
    assert int(tout[6][0]) >= PLEN + 4


def test_decode_loop_mtp_steps_left_freezes(r1):
    """A slot whose token budget drains mid-chunk freezes bit-exactly: its
    token, draft, length and cache rows equal a run of only its live
    iterations; every output equals JAX's."""
    (jtok, jc, jcl), (ttok, tc, tcl) = _prefill_both(r1, n_req=2)
    td = mtp.propose_draft(r1["tp"], r1["tfit"], r1["tcfg"], ttok)
    jd = j_mtp.propose_draft(r1["jp"], r1["jfit"], r1["cfg"], jtok)
    n = 4
    fresh = {k: {**v, "mla": v["mla"].clone()} for k, v in tc.items()}
    jout = j_decode_loop_mtp(r1["jp"], r1["jfit"], r1["cfg"], jtok, jd, jc,
                             jcl, n, key=jax.random.PRNGKey(4),
                             steps_left=jnp.asarray([2 * n, 2], jnp.int32))
    tout = decode_loop_mtp(r1["tp"], r1["tfit"], r1["tcfg"], ttok, td, tc,
                           tcl, n,
                           steps_left=torch.tensor([2 * n, 2],
                                                   dtype=torch.int32))
    _assert_loop_equal(jout, tout)
    lv = tout[2].numpy()
    k = int(lv[1].sum())
    assert k < n and lv[1, :k].all() and not lv[1, k:].any()
    short = decode_loop_mtp(r1["tp"], r1["tfit"], r1["tcfg"], ttok, td,
                            fresh, tcl, k)
    for i in (3, 4, 6):
        assert tout[i][1] == short[i][1], i
    sl_m = cache_ops.slice_request(r1["tcfg"], tout[5], 1)
    sl_k = cache_ops.slice_request(r1["tcfg"], short[5], 1)
    for key in sl_m:
        assert torch.equal(sl_m[key]["mla"], sl_k[key]["mla"])


@pytest.mark.parametrize("fused", [False, True])
def test_decode_loop_mtp_capacity_freeze(r1, fused):
    """Slots freeze instead of writing past the cache once both writes no
    longer fit (live iff cache_len + 2 <= capacity), as in JAX."""
    plen, cap = 10, 13
    (jtok, jc, jcl), (ttok, tc, tcl) = _prefill_both(r1, n_req=2, plen=plen,
                                                     capacity=cap)
    jd = j_mtp.propose_draft(r1["jp"], r1["jfit"], r1["cfg"], jtok)
    td = mtp.propose_draft(r1["tp"], r1["tfit"], r1["tcfg"], ttok)
    jout = j_decode_loop_mtp(r1["jp"], r1["jfit"], r1["cfg"], jtok, jd, jc,
                             jcl, 5, key=jax.random.PRNGKey(0),
                             fused_verify=fused)
    tout = decode_loop_mtp(r1["tp"], r1["tfit"], r1["tcfg"], ttok, td, tc,
                           tcl, 5, fused_verify=fused)
    _assert_loop_equal(jout, tout)
    lv, acc, cl_f = tout[2].numpy(), tout[1].numpy(), tout[6].numpy()
    assert (cl_f <= cap).all() and not lv[:, -1].any()
    for i in range(2):
        cl = plen
        for j in range(5):
            assert bool(lv[i, j]) == (cl + 2 <= cap)
            if lv[i, j]:
                cl += 1 + int(acc[i, j])


def test_mla_kernel_cut_stays_within_each_row(r1, monkeypatch):
    """Under MTP the rows' lengths diverge by accepted drafts and a
    rejected draft leaves a stale row at len+1. The kernel's cut
    (``mla_attention/plan.py``) for every call of an MTP loop covers
    exactly positions 0..cache_len[b] of each row -- the step's own write
    and the committed rows before it, never a row past it."""
    _, (ttok, tc, tcl) = _prefill_both(r1)
    td = mtp.propose_draft(r1["tp"], r1["tfit"], r1["tcfg"], ttok)
    seen = []
    real = mla_ops.mla_decode_attention

    def recording(q_lat, q_rope, cache, cache_len, scale, n_pieces=None):
        seen.append((cache_len.tolist(), cache.shape[1]))
        return real(q_lat, q_rope, cache, cache_len, scale, n_pieces)

    monkeypatch.setattr(mla_ops, "mla_decode_attention", recording)
    out = decode_loop_mtp(r1["tp"], r1["tfit"], r1["tcfg"], ttok, td, tc,
                          tcl, 5)
    layers = r1["tcfg"].num_layers
    assert len(seen) == 2 * 5 * layers          # two decode steps per iter
    assert len({tuple(lens) for lens, _ in seen}) > 2
    for lens, s in seen:
        for n_pieces in (1, 3, 33):
            covered = {}
            for seg in mla_plan.segments(lens, s, n_pieces):
                covered.setdefault(seg.row, []).append((seg.start, seg.end))
            for b, cl in enumerate(lens):
                spans = sorted(covered[b])
                assert spans[0][0] == 0 and spans[-1][1] == cl + 1
                assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))
    assert out[1].any()


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def _jax_kept(logits, temperature, top_p, monkeypatch):
    """The tokens JAX's ``sample_top_p`` can draw, one probe per token:
    uniform noise near 1 on the probed token (a Gumbel draw of ~+16) and 0
    elsewhere (~-3.8) makes it win iff the filter kept it."""
    v = logits.shape[-1]
    kept = np.zeros(logits.shape, bool)
    for j in range(v):
        u = np.zeros(logits.shape, np.float32)
        u[:, j] = np.nextafter(np.float32(1), np.float32(0))
        monkeypatch.setattr(j_mtp.jax.random, "uniform",
                            lambda key, shape, u=u: jnp.asarray(u))
        kept[:, j] = np.asarray(j_mtp.sample_top_p(
            jax.random.PRNGKey(0), jnp.asarray(logits), temperature,
            top_p)) == j
    monkeypatch.undo()
    return kept


def _port_kept(logits, temperature, top_p, monkeypatch):
    v = logits.shape[-1]
    kept = np.zeros(logits.shape, bool)
    for j in range(v):
        u = torch.zeros(logits.shape)
        u[:, j] = float(np.nextafter(np.float32(1), np.float32(0)))
        monkeypatch.setattr(mtp, "_uniform", lambda shape, g, d, u=u: u)
        kept[:, j] = mtp.sample_top_p(torch.from_numpy(logits), temperature,
                                      top_p).numpy() == j
    monkeypatch.undo()
    return kept


def _assert_kept_equal(logits, temperature, top_p, monkeypatch):
    kept = _port_kept(logits, temperature, top_p, monkeypatch)
    assert np.array_equal(kept, _jax_kept(logits, temperature, top_p,
                                          monkeypatch))
    _, cutoff = mtp.top_p_filter(torch.from_numpy(logits), temperature,
                                 top_p)
    assert np.array_equal(cutoff[:, 0].numpy(), kept.sum(-1) - 1)
    return kept


@pytest.mark.parametrize("top_p", [0.3, 0.9, 0.95, 1.5])
def test_sample_top_p_kept_set_matches_jax(top_p, monkeypatch):
    """The same tokens can be drawn, and the cutoff index is the kept count
    less one. (Logits of unit scale: the probe needs the kept tokens'
    scaled logits within ~20 of each other.)"""
    rng = np.random.RandomState(int(top_p * 100))
    logits = rng.randn(4, 48).astype(np.float32)
    kept = _assert_kept_equal(logits, 0.6, top_p, monkeypatch)
    assert kept.all() == (top_p > 1.0)
    assert (kept.sum(-1) >= 1).all()


def test_sample_top_p_clamp_cases_match_jax(monkeypatch):
    """The cutoff regressions of ``tests/test_mtp_fastpath.py``: at top_p >=
    1.0 the cutoff index clamps to V-1 and the whole vocabulary is kept; a
    top token whose mass alone exceeds top_p is still kept, alone."""
    logits = np.asarray([[10.0, 0.0, -1.0, -2.0], [0.1, 0.2, 0.3, 0.4]],
                        np.float32)
    for top_p in (1.0, 1.5):
        assert _assert_kept_equal(logits, 1.0, top_p, monkeypatch).all()
    peaked = np.asarray([[30.0, 0.0, 0.0, 0.0]], np.float32)
    kept = _assert_kept_equal(peaked, 1.0, 0.5, monkeypatch)
    assert kept.tolist() == [[True, False, False, False]]


def test_sample_top_p_draws_only_kept_tokens():
    """Real draws from a generator stay inside the kept set; a peaked row
    always draws its top token."""
    rng = np.random.RandomState(0)
    logits = torch.from_numpy((rng.randn(2, 32) * 2).astype(np.float32))
    filtered, _ = mtp.top_p_filter(logits, 0.6, 0.9)
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([mtp.sample_top_p(logits, 0.6, 0.9, gen)
                         for _ in range(64)])
    kept = filtered > -1e29
    assert all(bool(kept[i, draws[:, i]].all()) for i in range(2))
    assert (draws[:, 0] != draws[0, 0]).any() or kept[0].sum() == 1
    peaked = torch.tensor([[30.0, 0.0, 0.0, 0.0]])
    for seed in range(8):
        gen = torch.Generator().manual_seed(seed)
        assert int(mtp.sample_top_p(peaked, 1.0, 0.5, gen)[0]) == 0


# ---------------------------------------------------------------------------
# fit_draft_head
# ---------------------------------------------------------------------------


def test_fit_draft_head_matches_jax(r1):
    """A few Adam steps from the same head on the same prompts land on the
    same head: after 5 steps of lr 3e-3 every weight within 2e-4. Adam's
    first steps move each weight by about lr * sign(grad), so a sign that
    differed would show as ~6e-3; a weight whose gradient is near Adam's
    1e-8 floor moves by a fraction of lr that float noise sets (up to
    1.3e-4 on 3 of the 131072 ``mix`` weights here)."""
    prompts = np.asarray(r1["prompts"][:4], np.int32)[:, :8]
    jfit = j_mtp.fit_draft_head(r1["jp"], r1["cfg"], r1["jm"],
                                jax.random.PRNGKey(2), prompts=prompts,
                                gen_len=8, steps=5)
    tfit = mtp.fit_draft_head(r1["tp"], r1["tcfg"], r1["tm"],
                              prompts=prompts, gen_len=8, steps=5)
    for name in ("ln", "mix", "proj"):
        before = np.asarray(r1["jm"][name])
        after = getattr(tfit, name).numpy()
        assert not np.array_equal(after, before)
        np.testing.assert_allclose(after, np.asarray(jfit[name]), rtol=0,
                                   atol=2e-4, err_msg=name)
        # the port's head is new; the one it started from is unchanged
        assert np.array_equal(getattr(r1["tm"], name).numpy(), before)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

SERVING_PATHS = {
    "per_step": {},
    "chunked_continuous": {"decode_chunk": 4, "continuous_batching": True},
    "fused": {"decode_chunk": 4, "mtp_fused": True},
}


def _max_new(i):
    return 6 if i % 2 == 0 else 3


@pytest.mark.parametrize("path", list(SERVING_PATHS))
def test_serving_mtp_matches_jax(r1, path):
    """``ServingSystem(use_mtp=True)`` emits JAX's tokens and writes JAX's
    trace records and summary (the measured acceptance fed back into the
    cost model included) on every MTP path."""
    kw = SERVING_PATHS[path]
    prompts = r1["prompts"]
    js = JServingSystem(r1["jp"], r1["cfg"], n_prefill=2, decode_batch=2,
                        capacity=48, use_mtp=True, mtp_params=r1["jfit"], **kw)
    jres = {r.rid: r.tokens for r in js.serve(
        [JRequest(i, p, _max_new(i)) for i, p in enumerate(prompts)])}
    ts = ServingSystem(r1["tp"], r1["tcfg"], n_prefill=2, decode_batch=2,
                       capacity=48, use_mtp=True, mtp_params=r1["tfit"],
                       device="cpu", **kw)
    results = ts.serve([Request(i, p, _max_new(i))
                        for i, p in enumerate(prompts)])
    assert {r.rid: r.tokens for r in results} == jres
    records = ts.scheduler.trace_records()
    assert records == js.scheduler.trace_records()
    assert repr(ts.scheduler.summary()) == repr(js.scheduler.summary())
    assert ts.decode.use_mtp and ts.decode.mtp_fused == (path == "fused")
    # drafts were accepted: fewer iterations than decode tokens
    assert any(r["decode_iters"] < r["decode_tokens"] for r in records)
    assert ts.scheduler.cost.mtp_iter_factor == DecodeCostModel.MTP_ITER_FACTOR


def test_serving_mtp_tokens_equal_greedy(r1):
    """MTP serves exactly the base model's greedy tokens (the port's own
    non-MTP serve of the same requests)."""
    prompts = r1["prompts"]
    reqs = [Request(i, p, _max_new(i)) for i, p in enumerate(prompts)]
    base = ServingSystem(r1["tp"], r1["tcfg"], n_prefill=2, decode_batch=2,
                         capacity=48, device="cpu")
    want = {r.rid: r.tokens for r in base.serve(list(reqs))}
    for kw in SERVING_PATHS.values():
        ts = ServingSystem(r1["tp"], r1["tcfg"], n_prefill=2, decode_batch=2,
                           capacity=48, use_mtp=True, mtp_params=r1["tfit"],
                           device="cpu", **kw)
        assert {r.rid: r.tokens for r in ts.serve(list(reqs))} == want


def test_scheduler_use_mtp_is_baked_in(r1):
    system = ServingSystem(r1["tp"], r1["tcfg"], n_prefill=1, decode_batch=2,
                           capacity=24, use_mtp=True, mtp_params=r1["tm"],
                           device="cpu")
    assert system.scheduler.config.use_mtp
    with pytest.raises(ValueError, match="use_mtp"):
        system.reconfigure_scheduler(SchedulerConfig(use_mtp=False))
    system.reconfigure_scheduler(SchedulerConfig(use_mtp=True))
    plain = ServingSystem(r1["tp"], r1["tcfg"], n_prefill=1, decode_batch=2,
                          capacity=24, device="cpu",
                          scheduler_config=SchedulerConfig(use_mtp=True))
    assert plain.scheduler.config.use_mtp is False


def test_mtp_disables_interleave_and_fused_falls_back_on_ssm():
    """As in JAX: microbatch interleave stays off under MTP, and a fused
    verify on a cache prefill_continue cannot serve (Mamba2) warns and runs
    the two-forward verify."""
    from repro_torch.core import init_mtp_params
    from repro_torch.models import init_params
    from repro_torch.serving.engine import DecodeEngine

    tcfg = smoke_variant(get_config("deepseek-r1"))
    tp = init_params(tcfg, seed=0, device="cpu")
    head = init_mtp_params(tcfg, seed=1, device="cpu")
    with pytest.warns(UserWarning, match="not interleavable"):
        eng = DecodeEngine(tp, tcfg, 2, 16, use_mtp=True, mtp_params=head,
                           interleave=True, device="cpu")
    assert not eng.interleaved
    scfg = smoke_variant(get_config("mamba2-780m"))
    sp = init_params(scfg, seed=0, device="cpu")
    with pytest.warns(UserWarning, match="two-forward"):
        eng = DecodeEngine(sp, scfg, 2, 16, use_mtp=True,
                           mtp_params=init_mtp_params(scfg, device="cpu"),
                           mtp_fused=True, device="cpu")
    assert eng.use_mtp and not eng.mtp_fused
