"""The port's examples and dev smoke (``examples/torch_*.py``,
``scripts/torch_dev_smoke.py``) against the JAX package's calls that the
JAX examples make, on the CPU. Each port function gets the weights of the
JAX example's ``init_params`` keys (through ``repro_torch.convert``) and
the same inputs:

* the quickstart: the forward's shape and the greedy continuation equal,
  the INT8 linear's relative error within 1e-3 of JAX's;
* the PDC serve's ``main`` (its weights patched to JAX's): every
  request's tokens and reused tokens equal ``ServingSystem``'s;
* MTP's ``main``: step by step, tokens, iterations and each iteration's
  acceptance equal, and the fused loop's and greedy decoding's tokens
  equal to them;
* the training example's 3 steps: the losses within 1e-4 of JAX's
  ``train`` (its ``main``'s 300 steps and checkpoint run on the card);
* the dev smoke over every config."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke_variant
from repro.core import init_mtp_params as j_init_mtp
from repro.core.mtp import mtp_step as j_mtp_step
from repro.core.mtp import propose_draft as j_propose_draft
from repro.mempool import ContextCache as JContextCache
from repro.mempool import MemoryPool as JMemoryPool
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.quant import calibrate_linear as j_calibrate
from repro.quant import quantized_matmul as j_qmatmul
from repro.serving import ServingSystem as JServingSystem
from repro_torch.configs import get_config, list_configs, smoke_variant
from repro_torch.convert import mtp_from_jax_numpy, params_from_jax_numpy

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import load_entry  # noqa: E402

INT8_ERR_TOL = 1e-3      # |port's relative error - JAX's|
LOSS_RTOL = 1e-4         # the training loss after TRAIN_STEPS
TRAIN_STEPS = 3


QS = load_entry("examples/torch_quickstart.py")
PDC = load_entry("examples/torch_serve_pdc.py")
MTP = load_entry("examples/torch_mtp_speculative.py")
TRAIN = load_entry("examples/torch_train_moe_100m.py")
SMOKE = load_entry("scripts/torch_dev_smoke.py")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _both(arch, key):
    """(JAX's smoke config and weights from ``PRNGKey(key)``, the port's
    config and the same weights on the CPU)."""
    jcfg = j_smoke_variant(j_get_config(arch))
    jp = jax.jit(j_init_params, static_argnums=(1,))(
        jax.random.PRNGKey(key), jcfg)
    cfg = smoke_variant(get_config(arch))
    return jcfg, jp, cfg, params_from_jax_numpy(_np(jp), cfg, "cpu")


@pytest.fixture(scope="module")
def qwen3():
    return _both("qwen3-8b", 0)


def test_quickstart_matches_jax(qwen3):
    """The quickstart's dense and INT8 sections on JAX's weights and
    inputs (its keys 0, 1, 3 and 4)."""
    jcfg, jp, cfg, params = qwen3
    tokens = jax.random.randint(jax.random.PRNGKey(1), (QS.BATCH, QS.PROMPT),
                                0, jcfg.vocab_size)
    logits, _ = jax.eval_shape(lambda p, t: j_forward(p, jcfg,
                                                      {"tokens": t}),
                               jp, tokens)
    pl, caches = jax.jit(lambda p, t: j_prefill(
        p, jcfg, {"tokens": t}, capacity=QS.CAPACITY,
        cache_dtype=jnp.float32))(jp, tokens)
    step = jax.jit(lambda p, t, c, n: j_decode_step(p, jcfg, t, c, n))
    tok = jnp.argmax(pl[:, -1], -1)[:, None].astype(jnp.int32)
    want = [int(tok[0, 0])]
    cache_len = jnp.int32(QS.PROMPT)
    for _ in range(QS.STEPS):
        dl, caches = step(jp, tok, caches, cache_len)
        tok = jnp.argmax(dl, -1)[:, None].astype(jnp.int32)
        want.append(int(tok[0, 0]))
        cache_len = cache_len + 1
    shape, got = QS.greedy_continuation(params, cfg,
                                        torch.from_numpy(np.asarray(tokens)))
    assert shape == tuple(logits.shape)
    assert got == want

    w = jax.random.normal(jax.random.PRNGKey(3), (64, 32)) * 0.1
    x = jax.random.normal(jax.random.PRNGKey(4), (16, 64))
    ql = j_calibrate(w, x)
    want_err = float(jnp.linalg.norm(j_qmatmul(x, ql) - x @ w)
                     / jnp.linalg.norm(x @ w))
    err = QS.int8_linear(torch.from_numpy(np.asarray(w)),
                         torch.from_numpy(np.asarray(x)))
    assert abs(err - want_err) <= INT8_ERR_TOL, (err, want_err)


def test_serve_pdc_matches_jax(qwen3, monkeypatch):
    """The example's ``main`` on JAX's weights (its ``init_params``
    patched) against JAX's ``ServingSystem`` on the same requests: every
    request's tokens and reused tokens equal."""
    jcfg, jp, cfg, params = qwen3
    monkeypatch.setattr(PDC, "init_params", lambda *a, **k: params)
    pool = JMemoryPool(n_nodes=16)
    system = JServingSystem(jp, jcfg, n_prefill=2, decode_batch=3,
                            capacity=64, context_cache=JContextCache(
                                pool, block_tokens=8, model_tag=jcfg.name))
    results = system.serve(PDC.requests(cfg))
    got = PDC.main(["--device", "cpu"])
    assert got["tokens"] == {r.rid: list(r.tokens) for r in results}
    assert got["reused_tokens"] == sum(r.reused_tokens for r in results) > 0


def test_mtp_speculative_matches_jax(qwen3, monkeypatch):
    """The example's ``main`` on JAX's weights and draft head: MTP step by
    step as the JAX example runs it (tokens, iterations, each iteration's
    acceptance), and the port's fused loop and plain greedy decoding
    equal to those tokens."""
    jcfg, jp, cfg, params = qwen3
    jmtp = j_init_mtp(jax.random.PRNGKey(1), jcfg)
    monkeypatch.setattr(MTP, "init_params", lambda *a, **k: params)
    monkeypatch.setattr(MTP, "init_mtp_params", lambda *a, **k:
                        mtp_from_jax_numpy(_np(jmtp), cfg, "cpu"))
    prompt = list(np.random.RandomState(0).randint(0, jcfg.vocab_size, 20))
    pre = jax.jit(lambda p, t: j_prefill(p, jcfg, {"tokens": t},
                                         capacity=MTP.CAPACITY,
                                         cache_dtype=jnp.float32))
    logits, caches = pre(jp, jnp.asarray([prompt]))
    x = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    d = j_propose_draft(jp, jmtp, jcfg, x)
    cl = jnp.full((1,), len(prompt), jnp.int32)
    step = jax.jit(lambda p, m, x, d, c, n, k: j_mtp_step(
        p, m, jcfg, x, d, c, n, k, greedy=True))
    want, per_iter = [int(x[0])], []
    while len(want) < MTP.N_NEW:
        em, acc, x, d, caches, cl = step(jp, jmtp, x, d, caches, cl,
                                         jax.random.PRNGKey(2))
        want.append(int(em[0, 0]))
        per_iter.append(bool(acc[0]))
        if per_iter[-1] and len(want) < MTP.N_NEW:
            want.append(int(em[0, 1]))

    got = MTP.main(["--device", "cpu"])
    assert got["mtp"] == want[:MTP.N_NEW]
    assert (got["iterations"], got["accepted"], got["per_iteration"]) == (
        len(per_iter), sum(per_iter), per_iter)
    # JAX's example holds its fused loop and plain greedy decoding to the
    # step-by-step tokens; the port's must equal them too.
    assert got["fused"] == got["greedy"] == want[:MTP.N_NEW]


def test_train_moe_100m_matches_jax():
    """The example's training (``train_moe``) for TRAIN_STEPS steps on the
    110M MoE's weights from JAX's key 0: the first and last losses against
    JAX's ``train`` on the same corpus and optimizer (its ``main``, which
    also checkpoints, runs 300 steps on the card)."""
    import dataclasses

    from repro.data import make_batch_iter
    from repro.train import OptConfig, train

    cfg = TRAIN.moe_100m_config()
    jcfg = dataclasses.replace(j_get_config("olmoe-1b-7b"), **TRAIN.MOE_100M)
    jp = jax.jit(j_init_params, static_argnums=(1,))(jax.random.PRNGKey(0),
                                                     jcfg)
    params = params_from_jax_numpy(_np(jp), cfg, "cpu")
    _, want = train(jp, jcfg, make_batch_iter(
        jcfg.vocab_size, seq_len=TRAIN.SEQ, global_batch=TRAIN.BATCH,
        seed=0), TRAIN_STEPS, OptConfig(lr=TRAIN.LR, warmup_steps=TRAIN.WARMUP,
                                        total_steps=TRAIN_STEPS),
        log_every=20)
    _, got = TRAIN.train_moe(params, cfg, TRAIN_STEPS, device="cpu")
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], float(w["loss"]),
                                   rtol=LOSS_RTOL)


def test_dev_smoke_covers_every_config():
    rows = SMOKE.main(["--device", "cpu"])
    assert [r["name"] for r in rows] == [
        smoke_variant(get_config(n)).name for n in list_configs()]
    for row in rows:
        if get_config(row["name"][:-len("-smoke")]).supports_decode:
            assert row["prefill_err"] <= SMOKE.AGREE_TOL

