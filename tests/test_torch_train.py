"""The port's training path against the JAX package's, on the CPU at
float32 smoke variants with shared weights (``repro_torch.convert``):
``lm_loss`` and its gradients for every family, the SSD scan's autograd
Function against ``jax.vjp`` of ``ssd_chunked``, AdamW and its schedule,
``microbatched_loss``, ``train``, the synthetic data and the train CLI.

Tolerances: the loss within 1e-5 relative; each gradient leaf within 2e-4
of that leaf's largest |g| (float32 sums in another order, through two to
five layers); AdamW within 1e-6 (three float32 steps of the same
arithmetic); ``train``'s loss history within 1e-4 relative.
"""
import copy
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.checkpoint import load_checkpoint as j_load_checkpoint
from repro.core.microbatch import microbatched_loss as j_microbatched_loss
from repro.data import make_batch_iter as j_make_batch_iter
from repro.models import init_params as j_init_params
from repro.models import lm_loss as j_lm_loss
from repro.models.mamba2 import ssd_chunked as j_ssd_chunked
from repro.train import OptConfig as JOptConfig
from repro.train import adamw_update as j_adamw_update
from repro.train import init_opt_state as j_init_opt_state
from repro.train import lr_at as j_lr_at
from repro.train import train as j_train
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import param_tree, params_from_jax_numpy
from repro_torch.core import microbatched_loss
from repro_torch.data import make_batch_iter
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import train as train_cli
from repro_torch.models import lm_loss
from repro_torch.tree import tree_leaves
from repro_torch.train import (OptConfig, adamw_update, init_opt_state,
                               lr_at, make_train_step, train, trainable)

LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4        # of each leaf's max |g|
ADAM_TOL = 1e-6
HISTORY_RTOL = 1e-4
SEQ = 40               # Mamba2 smoke chunks of 32: ragged in the port

LOSS_ARCHS = ("granite-3-2b", "olmoe-1b-7b", "deepseek-r1", "mamba2-780m",
              "zamba2-1.2b", "internvl2-2b", "hubert-xlarge")


def _shared(arch, seed=0):
    """(JAX config, port config, JAX params, port model) on the same
    weights."""
    cfg = smoke(arch)
    tcfg = smoke_variant(get_config(arch))
    jp = jax.jit(j_init_params, static_argnums=(1,))(
        jax.random.PRNGKey(seed), cfg)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, tcfg, jp, tp


def _np_batch(cfg, b=2, s=SEQ, seed=0):
    """A numpy batch for the config's modality (``prefix_emb`` for the
    VLM, audio ``frames`` for the encoder)."""
    rng = np.random.RandomState(seed)
    ints = lambda shape: rng.randint(0, cfg.vocab_size, shape).astype(  # noqa: E731
        np.int32)
    if cfg.frontend == "audio_frames":
        return {"frames": rng.standard_normal((b, s, cfg.d_model)).astype(
                    np.float32), "labels": ints((b, s))}
    batch = {}
    if cfg.frontend == "vision_patches":
        p = cfg.num_prefix_embeddings
        batch["prefix_emb"] = rng.standard_normal(
            (b, p, cfg.d_model)).astype(np.float32)
        s -= p
    batch["tokens"] = ints((b, s))
    batch["labels"] = ints((b, s))
    return batch


def _grad_tree(model, grads):
    """``grads`` (in ``model.parameters()`` order) in the JAX layout."""
    holder = copy.deepcopy(model)
    for p, g in zip(holder.parameters(), grads):
        p.data.copy_(g)
    return param_tree(holder)


def _port_value_and_grad(tp, tcfg, batch):
    with trainable(tp) as leaves:
        loss, metrics = lm_loss(tp, tcfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), metrics, grads


def _assert_grads_close(tree_t, tree_j, tol=GRAD_TOL):
    lt, lj = tree_leaves(tree_t), jax.tree.leaves(tree_j)
    assert len(lt) == len(lj)
    for i, (gt, gj) in enumerate(zip(lt, lj)):
        gj = np.asarray(gj)
        assert tuple(gt.shape) == gj.shape, i
        scale = max(float(np.abs(gj).max()), 1e-12)
        err = float(np.abs(gt.numpy() - gj).max())
        assert err <= tol * scale, (i, gt.shape, err, scale)


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_lm_loss_and_grads_match_jax(arch):
    """``lm_loss`` and the gradient of every weight equal
    ``jax.value_and_grad`` of JAX's (the VLM's prefix positions dropped,
    the MoE aux loss added; Mamba layers through the SSD Function)."""
    cfg, tcfg, jp, tp = _shared(arch)
    nb = _np_batch(cfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_lm_loss(p, cfg, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    loss, metrics, grads = _port_value_and_grad(
        tp, tcfg, {k: torch.from_numpy(v) for k, v in nb.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["nll"].detach()),
                               float(jm["nll"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["aux_loss"].detach()),
                               float(jm["aux_loss"]), rtol=LOSS_RTOL,
                               atol=1e-7)
    _assert_grads_close(_grad_tree(tp, grads), jg)
    assert not any(p.requires_grad for p in tp.parameters())


def _ssd_inputs(s, b=2, h=3, p=8, n=16, seed=0):
    rng = np.random.RandomState(seed)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return {"x": f32(b, s, h, p),
            "dt": rng.uniform(0.01, 0.3, (b, s, h)).astype(np.float32),
            "a_log": (0.5 * f32(h)), "bmat": f32(b, s, n),
            "cmat": f32(b, s, n), "g_y": f32(b, s, h, p),
            "g_h": f32(b, h, p, n)}


@pytest.mark.parametrize("s", [64, 45], ids=["S=2Q", "S-odd"])
def test_ssd_function_grads_match_jax(s):
    """The SSD Function's outputs and its gradients for x, dt, a_log, B
    and C, from upstream gradients of both ``y`` and ``h_final``, equal
    ``jax.vjp`` of JAX's ``ssd_chunked`` (at S = 45 JAX falls to a chunk
    of 1 and the port takes a ragged last chunk)."""
    chunk = 32
    v = _ssd_inputs(s)
    names = ("x", "dt", "a_log", "bmat", "cmat")
    (jy, jh), vjp = jax.vjp(lambda *a: j_ssd_chunked(*a, chunk),
                            *(jnp.asarray(v[k]) for k in names))
    jgrads = vjp((jnp.asarray(v["g_y"]), jnp.asarray(v["g_h"])))
    ins = [torch.from_numpy(v[k]).requires_grad_(True) for k in names]
    y, h = ssd_ops.ssd_scan_autograd(*ins, chunk)
    torch.autograd.backward((y, h), (torch.from_numpy(v["g_y"]),
                                     torch.from_numpy(v["g_h"])))
    for got, want in ((y, jy), (h, jh)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    for name, t, jg in zip(names, ins, jgrads):
        jg = np.asarray(jg)
        err = float(np.abs(t.grad.numpy() - jg).max())
        assert err <= 1e-5 * float(np.abs(jg).max()), (name, err)


def test_ssd_function_h_final_gradient_alone():
    """A loss on ``h_final`` alone (``y`` unused) still reaches every
    input, as the state handed to decode does in training."""
    v = _ssd_inputs(40)
    names = ("x", "dt", "a_log", "bmat", "cmat")
    _, vjp = jax.vjp(lambda *a: j_ssd_chunked(*a, 16)[1],
                     *(jnp.asarray(v[k]) for k in names))
    jgrads = vjp(jnp.asarray(v["g_h"]))
    ins = [torch.from_numpy(v[k]).requires_grad_(True) for k in names]
    _, h = ssd_ops.ssd_scan_autograd(*ins, 16)
    (h * torch.from_numpy(v["g_h"])).sum().backward()
    for name, t, jg in zip(names, ins, jgrads):
        jg = np.asarray(jg)
        err = float(np.abs(t.grad.numpy() - jg).max())
        assert err <= 1e-5 * max(float(np.abs(jg).max()), 1e-12), (name, err)


def test_ssd_function_empty_sequence():
    """At S = 0 the state is zero and no gradient flows (none is raised)."""
    ins = [torch.zeros(shape, requires_grad=True) for shape in
           ((1, 0, 2, 4), (1, 0, 2), (2,), (1, 0, 3), (1, 0, 3))]
    y, h = ssd_ops.ssd_scan_autograd(*ins, 4)
    assert y.shape == (1, 0, 2, 4) and not h.any()
    assert torch.autograd.grad(h.sum(), ins, allow_unused=True) == (None,) * 5


def test_raw_ssd_wrapper_refuses_an_input_that_requires_grad():
    """The raw wrapper's outputs carry no gradient, so it raises rather
    than drop one; under ``no_grad``, or through the Function, it runs."""
    v = _ssd_inputs(16)
    ins = [torch.from_numpy(v[k]) for k in ("x", "dt", "a_log", "bmat",
                                            "cmat")]
    ins[2].requires_grad_(True)
    with pytest.raises(RuntimeError, match="ssd_scan_autograd"):
        ssd_ops.ssd_scan(*ins, 16)
    with torch.no_grad():
        y0, _ = ssd_ops.ssd_scan(*ins, 16)
    y1, _ = ssd_ops.ssd_scan_autograd(*ins, 16)
    assert y1.grad_fn is not None
    assert torch.equal(y0, y1.detach())


def _tree_np(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.standard_normal((4, 6)).astype(np.float32),
            "b": rng.standard_normal((6,)).astype(np.float32),
            "s": rng.standard_normal((3, 4, 5)).astype(np.float32)}


def test_adamw_matches_jax_over_three_steps():
    """Three AdamW steps fed the same gradients (the second large enough
    to clip) leave equal parameters and moments, with JAX's grad norm
    (before the clip) and learning rate."""
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=5)
    params = _tree_np(0)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate = j_init_opt_state(jparams)
    tstate = init_opt_state(tparams, "cpu")
    for step in range(3):
        g = _tree_np(10 + step)
        if step == 1:
            g = {k: 100 * v for k, v in g.items()}
        jparams, jstate, jm = j_adamw_update(
            JOptConfig(**ocfg), jparams,
            {k: jnp.asarray(v) for k, v in g.items()}, jstate)
        tparams, tstate, tm = adamw_update(
            OptConfig(**ocfg), tparams,
            {k: torch.from_numpy(v) for k, v in g.items()}, tstate)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=ADAM_TOL)
        for ours, theirs in ((tparams, jparams), (tstate.mu, jstate.mu),
                             (tstate.nu, jstate.nu)):
            for k in params:
                np.testing.assert_allclose(ours[k].numpy(),
                                           np.asarray(theirs[k]),
                                           rtol=0, atol=ADAM_TOL)
    assert int(tstate.step) == int(jstate.step) == 3


def test_adamw_on_a_model_decays_as_jax_stacked_layers():
    """On a ``Model`` a layer's vectors (norm gains, Mamba's ``A_log``,
    ``D``, ``dt_bias``) decay as in JAX, whose ``init_params`` stacks them
    into matrices; ``final_norm`` does not. One step from the same
    weights and gradients leaves JAX's weights."""
    cfg, tcfg, jp, tp = _shared("zamba2-1.2b")
    rng = np.random.RandomState(3)
    grads = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), jp)
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=4)
    jnew, _, jm = j_adamw_update(JOptConfig(**ocfg), jp,
                                 jax.tree.map(jnp.asarray, grads),
                                 j_init_opt_state(jp))
    tgrads = list(params_from_jax_numpy(grads, tcfg, "cpu").parameters())
    tp, _, tm = adamw_update(OptConfig(**ocfg), tp, tgrads,
                             init_opt_state(tp, "cpu"))
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    for ours, theirs in zip(tree_leaves(param_tree(tp)),
                            jax.tree.leaves(jnew)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=0, atol=ADAM_TOL)


def test_adamw_reports_the_norm_before_the_clip():
    params = {"w": torch.ones((4, 4))}
    grads = {"w": torch.full((4, 4), 1e6)}
    _, _, m = adamw_update(OptConfig(grad_clip=1.0), params, grads,
                           init_opt_state(params, "cpu"))
    assert float(m["grad_norm"]) > 1e6


def test_lr_at_matches_jax():
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    for step in list(range(0, 12)) + [50, 99, 100, 150]:
        np.testing.assert_allclose(
            float(lr_at(OptConfig(**kw), step)),
            float(j_lr_at(JOptConfig(**kw), jnp.int32(step))), rtol=1e-6)


def test_microbatched_loss_matches_full():
    """The mean over two batch splits equals the full-batch loss, as
    ``tests/test_train.py`` checks for JAX, and JAX's own split loss."""
    cfg, tcfg, jp, tp = _shared("qwen3-8b")
    nb = next(make_batch_iter(cfg.vocab_size, 16, 4, seed=2))
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    full, _ = lm_loss(tp, tcfg, tb)
    mb, metrics = microbatched_loss(lambda p, b: lm_loss(p, tcfg, b), 2)(
        tp, tb)
    np.testing.assert_allclose(float(full), float(mb), rtol=1e-4)
    jmb, _ = j_microbatched_loss(lambda p, b: j_lm_loss(p, cfg, b), 2)(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    np.testing.assert_allclose(float(mb), float(jmb), rtol=LOSS_RTOL)
    assert set(metrics) == {"nll", "aux_loss"}


def test_train_history_matches_jax():
    """Three steps of ``train`` from the same weights on the same batches
    log JAX's losses, gradient norms and learning rates."""
    cfg, tcfg, jp, tp = _shared("granite-3-2b")
    with redirect_stdout(io.StringIO()) as jout:
        _, jhist = j_train(jp, cfg, j_make_batch_iter(cfg.vocab_size, 32, 4,
                                                      seed=1),
                           steps=3, log_every=1)
    with redirect_stdout(io.StringIO()) as tout:
        tp, thist = train(tp, tcfg, make_batch_iter(tcfg.vocab_size, 32, 4,
                                                    seed=1),
                          steps=3, log_every=1, device="cpu")
    assert [r["step"] for r in thist] == [r["step"] for r in jhist]
    assert set(thist[0]) == set(jhist[0])
    for t, j in zip(thist, jhist):
        for key in ("loss", "nll", "grad_norm", "lr"):
            np.testing.assert_allclose(t[key], j[key], rtol=HISTORY_RTOL)
    assert thist[-1]["loss"] < thist[0]["loss"]
    assert len(tout.getvalue().splitlines()) == len(
        jout.getvalue().splitlines()) == 3
    assert not any(p.requires_grad for p in tp.parameters())


@pytest.mark.parametrize("option", [{"remat": True}, {"n_micro": 2}],
                         ids=["remat", "n_micro=2"])
def test_train_step_options_match_the_plain_step(option):
    """``make_train_step`` with rematerialization (the loss recomputed in
    the backward) or two microbatches takes the plain step's step."""
    _, tcfg, _, _ = _shared("granite-3-2b")
    batch = {k: torch.from_numpy(v) for k, v in next(
        make_batch_iter(tcfg.vocab_size, 16, 4, seed=3)).items()}
    runs = []
    for kw in ({}, option):
        _, _, _, tp = _shared("granite-3-2b")
        step = make_train_step(tcfg, OptConfig(warmup_steps=1), **kw)
        tp, _, m = step(tp, init_opt_state(tp, "cpu"), batch)
        runs.append((m, [p.clone() for p in tp.parameters()]))
    (m0, p0), (m1, p1) = runs
    rtol = 1e-6 if "remat" in option else 1e-4
    for key in ("loss", "nll", "grad_norm"):
        np.testing.assert_allclose(float(m1[key]), float(m0[key]), rtol=rtol)
    for a, b in zip(p1, p0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("vocab,seq,batch,seed",
                         [(1000, 32, 4, 9), (50280, 64, 2, 0)])
def test_data_batches_bit_equal_to_jax(vocab, seq, batch, seed):
    ours = make_batch_iter(vocab, seq, batch, seed)
    theirs = j_make_batch_iter(vocab, seq, batch, seed)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_train_cli_on_cpu_writes_a_checkpoint_jax_reads(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --ckpt`` prints
    JAX's lines and writes a float32 checkpoint that JAX's
    ``load_checkpoint`` reads back bit for bit."""
    ck = str(tmp_path / "ck")
    out = io.StringIO()
    with redirect_stdout(out):
        train_cli.main(["--arch", "granite-3-2b", "--steps", "3", "--batch",
                        "2", "--seq", "16", "--device", "cpu", "--ckpt", ck])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("training granite-3-2b-smoke: ")
    assert [ln.split()[:2] for ln in lines[1:3]] == [["step", "0"],
                                                     ["step", "2"]]
    assert all(" loss=" in ln and " gnorm=" in ln for ln in lines[1:3])
    assert lines[-1] == f"checkpoint saved to {ck}"
    cfg = smoke("granite-3-2b")
    template = j_init_params(jax.random.PRNGKey(1), cfg)
    loaded, step = j_load_checkpoint(ck, template)
    assert step == 3
    assert any(not np.array_equal(np.asarray(a), np.asarray(b)) for a, b in
               zip(jax.tree.leaves(loaded), jax.tree.leaves(template)))
    from repro_torch.checkpoint import load_checkpoint
    model, _ = load_checkpoint(ck, smoke_variant(get_config("granite-3-2b")),
                               "cpu")
    for a, b in zip(jax.tree.leaves(loaded), tree_leaves(param_tree(model))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
