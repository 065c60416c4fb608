"""``forward`` and the two frontends of the port against the JAX package: every
arch of JAX's ``ASSIGNED_ARCHS`` and the paper's DeepSeek-R1 at their smoke
variants, plus Zamba2 at two groups and a tail (float32, the same weights
through ``repro_torch.convert`` and the same seeded numpy inputs: tokens,
InternVL2's patch-prefix embeddings, HuBERT's audio frames, as
``conftest.make_batch`` shapes them). This ports the forward and serve-step
tests of ``tests/test_arch_smoke.py``; its train step waits for the
training slice.

Tolerances: logits and the MoE aux loss rtol = atol = 2e-4, as for every
model test of the port (float32 through a few matmuls, attention or the
SSD scan, norms and the head, summed in another order than XLA's). Greedy
tokens must be identical. The serve CLI must print the JAX CLI's lines on
``internvl2-2b`` (which it serves on tokens alone) and fail on
``hubert-xlarge`` with the JAX CLI's exception.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.launch import serve as j_serve
from repro.models import model as j_model
from repro_torch.configs import get_config, list_configs, smoke_variant
from repro_torch.convert import params_from_jax_numpy
from repro_torch.launch import serve as t_serve
from repro_torch.models import model as t_model

TOL = 2e-4
B, S = 2, 24
#: (case, arch, config changes): the assigned archs, R1, and Zamba2 with two
#: groups and a tail
CASES = [(a, a, {}) for a in (*ASSIGNED_ARCHS, "deepseek-r1")] + [
    ("zamba2-1.2b-5layer", "zamba2-1.2b", {"num_layers": 5})]

J_FORWARD = jax.jit(j_model.forward, static_argnums=(1,))
J_PREFILL = jax.jit(j_model.prefill, static_argnums=(1, 3),
                    static_argnames=("cache_dtype",))
J_DECODE_STEP = jax.jit(j_model.decode_step, static_argnums=(1,))

_MODELS = {}


def _model(case):
    """(JAX config, port config, JAX params, port params), once a case."""
    if case not in _MODELS:
        _, arch, upd = next(c for c in CASES if c[0] == case)
        cfg = dataclasses.replace(smoke(arch), **upd)
        tcfg = dataclasses.replace(smoke_variant(get_config(arch)), **upd)
        jp = jax.jit(j_model.init_params, static_argnums=(1,))(
            jax.random.PRNGKey(0), cfg)
        tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        _MODELS[case] = (cfg, tcfg, jp, tp)
    return _MODELS[case]


def _batch(cfg, seed=0):
    """A ``make_batch``-shaped batch built with numpy: audio frames, or
    patch-prefix embeddings and tokens, or tokens; as numpy arrays."""
    rng = np.random.RandomState(seed)
    if cfg.frontend == "audio_frames":
        return {"frames": rng.randn(B, S, cfg.d_model).astype(np.float32)}
    batch = {}
    n_tok = S
    if cfg.frontend == "vision_patches":
        p = cfg.num_prefix_embeddings
        batch["prefix_emb"] = rng.randn(B, p, cfg.d_model).astype(np.float32)
        n_tok = S - p
    batch["tokens"] = rng.randint(0, cfg.vocab_size, (B, n_tok)
                                  ).astype(np.int32)
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_every_config_builds():
    """The port registers every config of the JAX package, each equal to
    JAX's, at full size and at its smoke variant."""
    assert list_configs() == jax_list_configs()
    for name in list_configs():
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jax_get_config(name))
        assert dataclasses.asdict(smoke_variant(get_config(name))) == \
            dataclasses.asdict(smoke(name))


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_forward_matches_jax(case):
    """Logits (B, S, V) -- a VLM's patch positions first -- and the aux
    loss."""
    cfg, tcfg, jp, tp = _model(case)
    jb, tb = _both(_batch(cfg))
    jl, jaux = J_FORWARD(jp, cfg, jb)
    tl, taux = t_model.forward(tp, tcfg, tb)
    assert tuple(tl.shape) == (B, S, cfg.vocab_size) == jl.shape
    assert bool(torch.isfinite(tl).all())
    _close(tl, jl)
    np.testing.assert_allclose(float(taux["aux_loss"]),
                               float(jaux["aux_loss"]), rtol=TOL, atol=TOL)
    if cfg.is_moe:
        assert float(taux["aux_loss"]) > 0


@pytest.mark.parametrize("case", [c[0] for c in CASES
                                  if get_config(c[1]).supports_decode])
def test_prefill_and_decode_step_match_jax(case):
    """The serve step of ``test_arch_smoke.py``: prefill (with the patch
    prefix for the VLM), then two greedy decode steps, logits and tokens
    against JAX's; prefill's logits equal ``forward``'s."""
    cfg, tcfg, jp, tp = _model(case)
    jb, tb = _both(_batch(cfg, seed=1))
    capacity = S + 4
    jl, jc = J_PREFILL(jp, cfg, jb, capacity, cache_dtype=jnp.float32)
    tl, tc = t_model.prefill(tp, tcfg, tb, capacity,
                             cache_dtype=torch.float32)
    _close(tl, jl)
    assert torch.equal(tl, t_model.forward(tp, tcfg, tb)[0])
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    assert np.array_equal(tl[:, -1].argmax(-1).numpy(), tok)
    for step in range(2):
        jl, jc = J_DECODE_STEP(jp, cfg, jnp.asarray(tok[:, None]), jc,
                               jnp.int32(S + step))
        tl, tc = t_model.decode_step(tp, tcfg, torch.from_numpy(tok[:, None]),
                                     tc, torch.tensor(S + step))
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        assert np.array_equal(tl.argmax(-1).numpy(), tok)


def test_embed_inputs():
    """Audio frames pass through in the model's dtype; a VLM prepends its
    patch embeddings only when the batch has them."""
    cfg, tcfg, jp, tp = _model("internvl2-2b")
    jb, tb = _both(_batch(cfg))
    _close(t_model.embed_inputs(tp, tcfg, tb),
           j_model.embed_inputs(jp, cfg, jb))
    no_prefix = {"tokens": tb["tokens"]}
    assert tuple(t_model.embed_inputs(tp, tcfg, no_prefix).shape) == \
        (B, S - cfg.num_prefix_embeddings, cfg.d_model)
    cfg, tcfg, jp, tp = _model("hubert-xlarge")
    jb, tb = _both(_batch(cfg))
    bf = dataclasses.replace(tcfg, dtype="bfloat16")
    assert t_model.embed_inputs(tp, bf, tb).dtype == torch.bfloat16
    _close(t_model.embed_inputs(tp, tcfg, tb),
           j_model.embed_inputs(jp, cfg, jb))


def _lines(text):
    """Printed lines without the wall-clock line (host timing)."""
    return [ln for ln in text.splitlines() if " wall (" not in ln]


def test_cli_serves_internvl2_as_jax_does(monkeypatch, capsys):
    """The JAX CLI serves the VLM on tokens alone (no patch prefix); given
    its weights, the port's CLI prints its lines."""
    argv = ["--arch", "internvl2-2b", "--n-requests", "3", "--max-new", "3",
            "--trace"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    j_serve.main()
    want = capsys.readouterr().out
    monkeypatch.undo()
    _, _, jp, _ = _model("internvl2-2b")

    def same_params(cfg, seed=0, device=None):
        return params_from_jax_numpy(jax.tree.map(np.asarray, jp), cfg,
                                     device)

    monkeypatch.setattr(t_serve, "init_params", same_params)
    t_serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _lines(got) == _lines(want)
    assert got.count("rid=") == 3


def test_cli_fails_on_hubert_as_jax_does(monkeypatch):
    """An encoder over audio frames has no tokens to embed: both CLIs fail
    on the first prefill with ``KeyError: 'frames'``."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "hubert-xlarge"])
    with pytest.raises(KeyError, match="frames"):
        j_serve.main()
    monkeypatch.undo()
    with pytest.raises(KeyError, match="frames"):
        t_serve.main(["--arch", "hubert-xlarge", "--device", "cpu"])
