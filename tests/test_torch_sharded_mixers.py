"""The mixers over DTensors (``local_map`` entries of ``models/mla.py``,
``models/attention.py`` and ``models/mamba2.py``) against the JAX package's
functions, on the CPU: gloo ranks over a 1 x 2 and a 2 x 2 ``DeviceMesh``
(two subprocesses, their ranks forked, started together under
MIXERS_TIMEOUT_S), every weight, input and cache a DTensor placed by the
port's specs, the same seeded numpy values through JAX's functions in this
process while the ranks run (``torch_sharded_common.py`` holds the inputs,
the ranks' script and the wait; the dry run's sharded steps are held in
``test_torch_sharded_steps.py``, LEP against JAX's on four devices in
``test_torch_sharded_lep.py``).

* Decode over caches whose batch is sharded over ``data`` and sequence
  over ``model``: MLA (``mla_decode``, against the ``jnp`` branch of JAX's)
  and GQA (``attention_decode``, plain and ring), each with a row whose
  ``cache_len`` falls inside rank 0's block (the other blocks empty), a
  capacity-frozen row (``cache_len == S``) and, in the ring, rows past the
  window: output and cache within 1e-5 of their largest entry (float32).
* Head-local prefill: ``mla_prefill``, ``attention_prefill`` with K/V heads
  cut over ``model`` and with one K/V head, whole on every rank (1e-5).
* The head-local SSD scan (``mamba2._scan``) against ``ssd_chunked``, and
  the Mamba layer (its conv on each rank's channels) against
  ``mamba_prefill`` (1e-5).
* Training at 1 x 2: ``lm_loss`` and every weight's gradient, the weights
  placed by the training specs, on R1 (MLA, dense layers only), Qwen3 with
  one K/V head and Mamba2, against ``jax.value_and_grad``: the loss within
  1e-5, each gradient within 2e-4 of its leaf's largest (the tolerances of
  ``test_torch_train.py``).
* One whole ``make_train_step`` at 1 x 2 and 2 x 2 (``lm_loss``, the
  gradients placed as their parameters, ``adamw_update`` on each rank's
  blocks), moments placed as the parameters, on R1 (dense layers only),
  Qwen3, Qwen3 and Qwen2.5 (QKV bias) with one K/V head (which the model
  axis does not divide: each rank computes the K/V head of its query
  heads, and its bias) and Mamba2, against JAX's
  ``train.make_train_step`` (jitted on one device) on the same
  weights and batch: every parameter and both moments within 2e-4 of the
  leaf's largest, with no warmup (so the step moves every weight by more
  than that), and the global gradient norm within 1e-5.
* ``dtensor.linear`` with ``heads`` at 2 x 2 against x @ w.

In this process: the sharded step's gates (``sharded_step.compare``,
``compare_f64``, ``_worst``), the float64 path's plain versions, the
reductions' contiguous buffers, the MLA plain version's ``return_lse``
against a direct log-sum-exp, an empty row (o = 0, lse = -inf) included,
and the kernel's split-and-merge emulation with empty rows."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as j_attn
from repro.models import lm_loss as j_lm_loss
from repro.models import mamba2 as j_mamba
from repro.models import mla as j_mla
from repro.train.loop import make_train_step as j_make_train_step
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import init_opt_state as j_init_opt_state
from repro_torch.kernels.mla_attention.ref import (mla_decode_attention_pieces,
                                                   mla_decode_attention_ref)
from repro_torch.launch import dryrun
from repro_torch.launch import sharded_step as ss
from torch_sharded_common import (GRAD_TOL, LINEAR, LOSS_RTOL, MESHES, STEP,
                                  STEP_OPT, STEP_TOL, TRAIN, load_ranks,
                                  mixer_inputs, smoke, start_ranks, wait_all)
from torch_sharded_common import close as _close
from torch_sharded_common import flat as _flat

#: the ranks' deadline (both meshes, started together), 3.1 x
#: MIXERS_SETUP_S: the fixture's setup beside the other gloo and JAX files
#: under the tier-1 run's flags (as ``test_torch_sharded_lep.py`` measures
#: its own), the longer of two runs (97.4 s in the other). JAX's side, in
#: this process meanwhile, is the longer part (unloaded: the inputs 8 s,
#: then JAX 20 s; the ranks 11 s)
MIXERS_SETUP_S = 107.1
MIXERS_TIMEOUT_S = 330


@pytest.fixture(scope="module")
def inputs():
    """The seeded numpy inputs and weights of every case."""
    return mixer_inputs()


@pytest.fixture(scope="module")
def sides(inputs, tmp_path_factory):
    """Both meshes' ranks started together under MIXERS_TIMEOUT_S, and
    JAX's side computed while they run: (rank 0's gathered arrays by mesh,
    JAX's arrays)."""
    tmp = tmp_path_factory.mktemp("sharded_mixers")
    np.savez(tmp / "in.npz", **inputs)
    started = time.monotonic()
    procs = [start_ranks(name, shape, tmp, tmp / "in.npz", {
        "mixers": True, "grads": TRAIN if name == "1x2" else {},
        "steps": {case: (arch, fields) for case, (arch, fields, meshes)
                  in STEP.items() if name in meshes},
        "opt": STEP_OPT, "linear": LINEAR if name == "2x2" else {}})
        for name, shape in MESHES.items()]
    try:
        want = _jax_side(inputs)
    finally:
        wait_all(procs, MIXERS_TIMEOUT_S, started)
    return {name: load_ranks(tmp / f"{name}.npz")[0]
            for name in MESHES}, want


def _jax_side(inputs):
    """JAX's functions on the same arrays (one device: the partition does
    not change the function), each under ``jit`` (eager, op by op, takes
    five times as long), and JAX's ``make_train_step`` of each STEP case."""
    d = {k: jnp.asarray(v) for k, v in inputs.items()}
    w = lambda prefix: {k[len(prefix):]: v for k, v in d.items()  # noqa
                        if k.startswith(prefix)}
    out = {}
    r1, q4, q1, m2 = (smoke("deepseek-r1"), smoke("qwen3-8b"),
                      smoke("qwen3-8b", num_kv_heads=1),
                      smoke("mamba2-780m"))
    out["mla_decode"], out["mla_decode:cache"] = jax.jit(
        lambda p, x, c, n: j_mla.mla_decode(p, x, c, n, r1))(
        w("mla:"), d["mla_x1"], d["mla_cache"], d["lens"])
    out["mla_prefill"], out["mla_prefill:latent"] = jax.jit(
        lambda p, x: j_mla.mla_prefill(p, x, r1))(w("mla:"), d["mla_xs"])
    for kv, cfg in ((4, q4), (1, q1)):
        o, (k, v) = jax.jit(lambda p, x, cfg=cfg: j_attn.attention_prefill(
            p, x, cfg))(w(f"gqa{kv}:"), d["gqa_xs"])
        out[f"gqa{kv}_prefill"], out[f"gqa{kv}_prefill:k"] = o, k
        out[f"gqa{kv}_prefill:v"] = v
    for ring in (False, True):
        o, ck, cv = jax.jit(
            lambda p, x, k, v, n, ring=ring: j_attn.attention_decode(
                p, x, k, v, n, q4, ring))(
            w("gqa4:"), d["gqa_x1"], d["gqa_k"], d["gqa_v"],
            d["ring_lens" if ring else "lens"])
        out[f"gqa_decode{ring:d}"] = o
        out[f"gqa_decode{ring:d}:k"], out[f"gqa_decode{ring:d}:v"] = ck, cv
    out["ssd_y"], out["ssd_h"] = jax.jit(
        lambda *a: j_mamba.ssd_chunked(*a, m2.ssm_chunk))(
        d["ssd_x"], d["ssd_dt"], d["ssd_a"], d["ssd_b"], d["ssd_c"])
    (out["mamba_out"], out["mamba_h"], out["mamba_conv"]) = jax.jit(
        lambda p, x: j_mamba.mamba_prefill(p, x, m2))(w("mamba:"),
                                                      d["mamba_x"])
    for arch, fields in TRAIN.items():
        cfg = smoke(arch, **fields)
        params = _nest(w(f"p:{arch}:"))
        batch = {k: d[f"{arch}:{k}"] for k in ("tokens", "labels")}
        loss, g = jax.jit(jax.value_and_grad(
            lambda p, cfg=cfg, batch=batch: j_lm_loss(p, cfg, batch)[0]))(
            params)
        out[f"loss:{arch}"] = loss
        out.update({f"grad:{arch}:{k}": v for k, v in _flat(g).items()})
    for case, (arch, fields, _) in STEP.items():
        cfg = smoke(arch, **fields)
        params = _nest(w(f"step:{case}:p:"))
        batch = {k: d[f"step:{case}:{k}"] for k in ("tokens", "labels")}
        new, state, metrics = jax.jit(j_make_train_step(
            cfg, JOptConfig(**STEP_OPT)))(params, j_init_opt_state(params),
                                          batch)
        out[f"gnorm:{case}"] = metrics["grad_norm"]
        for name, tree in (("param", new), ("mu", state.mu),
                           ("nu", state.nu)):
            out.update({f"step:{case}:{name}:{k}": v
                        for k, v in _flat(tree).items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _nest(flat):
    """A flat dict of "a/b/c" keys as JAX's nested tree."""
    tree = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


CASES = ["mla_decode", "mla_decode:cache", "gqa_decode0", "gqa_decode0:k",
         "gqa_decode0:v", "gqa_decode1", "gqa_decode1:k", "gqa_decode1:v",
         "mla_prefill", "mla_prefill:latent", "gqa4_prefill", "gqa4_prefill:k",
         "gqa4_prefill:v", "gqa1_prefill", "gqa1_prefill:k", "gqa1_prefill:v",
         "ssd_y", "ssd_h", "mamba_out", "mamba_h", "mamba_conv"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_sharded_mixer_matches_jax(sides, mesh, case):
    ports, want = sides
    _close(ports[mesh][case], want[case])


@pytest.mark.parametrize("arch", list(TRAIN))
def test_sharded_train_gradients_match_jax(sides, arch):
    """``lm_loss`` over the training specs at 1 x 2 (FSDP over an axis of
    one rank, heads and columns over two): the loss and every leaf's
    gradient."""
    ports, jax_side = sides
    got = ports["1x2"]
    np.testing.assert_allclose(got[f"loss:{arch}"], jax_side[f"loss:{arch}"],
                               rtol=LOSS_RTOL)
    keys = sorted(k for k in jax_side if k.startswith(f"grad:{arch}:"))
    assert keys == sorted(k for k in got if k.startswith(f"grad:{arch}:"))
    for k in keys:
        _close(got[k], jax_side[k], GRAD_TOL)


@pytest.mark.parametrize("arch,mesh", [
    pytest.param(case, mesh, id=f"{case}-{mesh}") for mesh in MESHES
    for case, (*_, meshes) in STEP.items() if mesh in meshes])
def test_sharded_train_step_matches_jax(sides, arch, mesh):
    """One ``make_train_step`` over the training specs (FSDP over ``data``
    at 2 x 2): both AdamW moments after the step and every parameter,
    against JAX's ``make_train_step`` on the same weights and batch, and
    the metrics' global gradient norm. With no warmup the first step moves
    each weight by about lr x sign(g), 3e-4, so a step skipped, doubled or
    of the wrong sign is outside the tolerance; where the gradient is
    within the tolerance of 0 it may take either sign: the weights are
    held where the first moment (0.1 g) is clear of 0, as
    ``test_torch_lep2d.py`` holds them."""
    ports, want = sides
    got = ports[mesh]
    np.testing.assert_allclose(got[f"gnorm:{arch}"], want[f"gnorm:{arch}"],
                               rtol=LOSS_RTOL)
    keys = sorted(k for k in want if k.startswith(f"step:{arch}:"))
    assert keys and keys == sorted(k for k in got
                                   if k.startswith(f"step:{arch}:"))
    for k in keys:
        if ":param:" not in k:
            _close(got[k], want[k], STEP_TOL)
            continue
        mu = want[k.replace(":param:", ":mu:")]
        clear = np.abs(mu) > STEP_TOL * max(float(np.abs(mu).max()), 1e-30)
        assert clear.any() or not mu.any(), k
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k])[clear].max(initial=0.0))
        assert err <= STEP_TOL * scale, (k, err, scale)


@pytest.mark.parametrize("layout", list(LINEAR))
def test_sharded_linear_heads_matches_numpy(sides, inputs, layout):
    """``dtensor.linear`` with ``heads`` at 2 x 2 against x @ w: q whole;
    k and v as the K/V head repeated over the ranks that share it where
    the head path holds, else whole (never a partial sum or a part of a
    head)."""
    ports, _ = sides
    got, rep = ports["2x2"], LINEAR[layout][2]
    x = inputs["lin_x"]
    for n in "qkv":
        want = x @ inputs[f"lin_w{n}"]
        if n != "q":
            want = np.concatenate([want] * rep, axis=-1)
        _close(got[f"linear:{layout}:{n}"], want)


@pytest.mark.parametrize("chunk", [5, 64, 1 << 24])
def test_worst_in_chunks_equals_the_whole(monkeypatch, chunk):
    """``sharded_step._worst`` takes a leaf a chunk at a time (so that its
    float64 differences of train-r1's 0.93 B-element embedding fit the
    card beside the results): the same worst error and |want| there, of
    the leaf's largest, as over the whole leaf at once, with and without
    a mask, the first of tied elements, and (0, 0) over no element."""
    monkeypatch.setattr(ss, "_CHUNK", chunk)
    gen = torch.Generator().manual_seed(3)

    def whole(got, want, mask=None):
        diff = (got.double() - want.double()).abs()
        ref = want.double().abs()
        if mask is not None:
            diff, ref = diff[mask], ref[mask]
        if not diff.numel():
            return 0.0, 0.0
        scale = max(want.double().abs().max().item(), 1e-30)
        at = diff.flatten().argmax()
        return (diff.flatten()[at].item() / scale,
                ref.flatten()[at].item() / scale)

    for shape in [(7, 13), (1000,), (3, 5, 11)]:
        want = torch.randn(shape, generator=gen)
        got = want + 1e-3 * torch.randn(shape, generator=gen)
        tied = want.clone()
        tied.view(-1)[[3, 40 % tied.numel()]] += 1.0
        for mask in (None, torch.rand(shape, generator=gen) > 0.5,
                     torch.zeros(shape, dtype=torch.bool)):
            assert ss._worst(got, want, mask) == whole(got, want, mask)
            assert ss._worst(tied, want, mask) == whole(tied, want, mask)


@pytest.mark.parametrize("what", ["within", "leaf_past", "loss_past",
                                  "token"])
def test_compare_f64_gates_at_1e_9(what):
    """``sharded_step.compare_f64``: a moment off by 0.5 F64_TOL of its
    leaf's largest passes, by 2 F64_TOL fails and is named; a loss off by
    2 F64_TOL relative fails; a decode step whose one row's greedy token
    flips fails, whatever its logits' error."""
    gen = torch.Generator().manual_seed(0)
    if what == "token":
        want = {"logits": torch.randn(4, 32, generator=gen,
                                      dtype=torch.float64),
                "cache/x": torch.randn(2, 4, generator=gen,
                                       dtype=torch.float64)}
        got = {k: v.clone() for k, v in want.items()}
        top = want["logits"][2].argmax()
        got["logits"][2, top] = want["logits"][2].min()
        row = ss.compare_f64("decode", got, want)
        assert row["greedy_equal_by_row"] == [True, True, False, True], row
        assert not row["ok"]
        return
    want = {"loss": torch.tensor(2.0, dtype=torch.float64),
            "grad_norm": torch.tensor(1.0, dtype=torch.float64)}
    for part in ("param", "mu", "nu"):
        want[f"{part}/a"] = torch.randn(8, 4, generator=gen,
                                        dtype=torch.float64)
    got = {k: v.clone() for k, v in want.items()}
    if what == "loss_past":
        got["loss"] += 2 * ss.F64_TOL * 2.0
    else:
        off = 0.5 if what == "within" else 2.0
        got["mu/a"][1, 2] += off * ss.F64_TOL * want["mu/a"].abs().max()
    row = ss.compare_f64("train", got, want)
    if what == "within":
        assert row["ok"] and not row["over"], row
        return
    assert row["over"] == (["loss"] if what == "loss_past" else ["mu/a"])
    assert not row["ok"]


def test_float64_reaches_only_the_plain_versions():
    """The dispatch-quantize and MLA wrappers take float64 on the CPU (the
    plain versions, a float64 step's) and refuse it elsewhere, so float64
    reaches no kernel. A float64 row of float32 values packs the scale
    bytes its float32 row packs; its codes are ``round(x / scale)`` of that
    scale in float64."""
    from repro_torch.kernels.dispatch_quant import dispatch_quantize
    from repro_torch.kernels.mla_attention.ops import mla_decode_attention

    x = torch.randn(16, 40, generator=torch.Generator().manual_seed(1)) \
        * torch.logspace(-3, 3, 16)[:, None]
    packed32 = dispatch_quantize(x, pack=True)
    packed64 = dispatch_quantize(x.double(), pack=True)
    assert torch.equal(packed64[:, 40:], packed32[:, 40:])
    q, scale = dispatch_quantize(x.double())
    assert scale.dtype == torch.float32
    assert torch.equal(q, torch.round(x.double() / scale.double()).clamp(
        -127, 127).to(torch.int8))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dispatch_quantize(x.double().to("meta"))
    ql, qr, cache, lens, s = _lse_inputs([5, -1, 23, 24])
    o64 = mla_decode_attention(ql.double(), qr.double(), cache.double(),
                               lens, s)
    assert o64.dtype == torch.float64
    torch.testing.assert_close(o64.float(), mla_decode_attention(
        ql, qr, cache, lens, s), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="must be float32"):
        mla_decode_attention(ql.double().to("meta"), qr.double().to("meta"),
                             cache.double().to("meta"), lens.to("meta"), s)


@pytest.mark.parametrize("route", ["grad_sum", "all_reduce",
                                   "sum_replicated", "max_replicated"])
def test_reductions_hand_contiguous_buffers(monkeypatch, route):
    """NCCL reduces contiguous buffers only, where gloo takes any: the 2 x 2
    ``train-qwen3`` step over NCCL raised "Tensors must be contiguous" on
    a weight's gradient that reached a backward's all-reduce as a
    transposed view. Every all-reduce of ``core/parallel`` hands the
    collective a contiguous buffer, forward and backward."""
    from repro_torch.core import parallel as par

    seen = []
    monkeypatch.setattr(par.dist, "all_reduce", lambda t, op=None, group=None:
                        seen.append(t.is_contiguous()))
    group = object()                     # the collective is stubbed
    x = torch.randn(6, 4).t()            # a transposed view
    if route == "grad_sum":
        w = torch.zeros(4, 6, requires_grad=True)
        torch.autograd.grad(par.grad_sum(w, group), w, grad_outputs=x)
    else:
        getattr(par, route)(x, group)
    assert seen == [True]


@pytest.mark.parametrize("what", ["train_leaf", "decode_held_row",
                                  "decode_unheld_row", "f64_within",
                                  "f64_past"])
def test_compare_gates_at_fixed_tolerances(what):
    """``sharded_step.compare`` holds every quantity at its fixed
    tolerance, whatever the reference's disagreement with itself: a moment
    3e-4 of its leaf's largest off fails the train step (STEP_TOL 2e-4),
    and names the leaf; a decode step's logits row off by half the
    largest logit fails where the row is held and is only reported where
    it is not, its caches and written rows held on every row. Against a
    float64 truth, a moment that the unsharded step has 1e-3 of its
    largest off passes where the sharded one is off by 0.5 STEP_TOL more
    and fails at 1.5 STEP_TOL more."""
    gen = torch.Generator().manual_seed(0)
    if what.startswith("f64"):
        truth = {"loss": torch.tensor(2.0), "grad_norm": torch.tensor(1.0)}
        for part in ("param", "mu", "nu"):
            truth.update({f"{part}/a": torch.randn(8, 4, generator=gen),
                          f"{part}/b": torch.randn(16, generator=gen)})
        want = {k: v.clone() for k, v in truth.items()}
        scale = truth["mu/b"].abs().max()
        want["mu/b"][3] += 1e-3 * scale
        got = {k: v.clone() for k, v in want.items()}
        got["mu/b"][3] += (0.5 if what == "f64_within" else 1.5) \
            * ss.STEP_TOL * scale
        row = ss.compare("train", got, want, 0.02, truth=truth)
        assert row["f64"]["unsharded_max_err"]["mu"] > ss.STEP_TOL
        if what == "f64_within":
            assert row["ok"] and not row["over"], row
        else:
            assert row["over"] == ["mu_f64_excess"], row
            assert list(row["f64"]["leaves_over"]["mu"]) == ["mu/b"], row
            assert not row["ok"]
        return
    if what == "train_leaf":
        want = {"loss": torch.tensor(2.0), "grad_norm": torch.tensor(1.0)}
        for part in ("param", "mu", "nu"):
            want.update({f"{part}/a": torch.randn(8, 4, generator=gen),
                         f"{part}/b": torch.randn(16, generator=gen)})
        got = {k: v.clone() for k, v in want.items()}
        got["mu/b"][3] += 3e-4 * want["mu/b"].abs().max()
        row = ss.compare("train", got, want, 0.02)
        assert row["over"] == ["mu_max_err"], row
        assert list(row["leaves_over"]["mu"]) == ["mu/b"], row
        assert not row["ok"]
        return
    logits = torch.randn(4, 32, generator=gen)
    want = {"logits": logits, "cache/x": torch.randn(2, 4, generator=gen),
            "written/x": torch.randn(2, 4, generator=gen)}
    got = {k: v.clone() for k, v in want.items()}
    got["logits"][2] += 0.5 * logits.abs().max()
    rows = [0, 1, 2, 3] if what == "decode_held_row" else [0, 1, 3]
    row = ss.compare("decode", got, want, 0.02, rows)
    assert row["logits_err_by_row"][2] > 0.02
    assert row["ok"] == (what == "decode_unheld_row"), row
    got["cache/x"][1, 1] += 1.0
    assert ss.compare("decode", got, want, 0.02, [0])["over"] == \
        ["cache_max_err"]


def test_held_rows_of_the_decode_cases():
    """The rows whose logits the full-width decode cases hold at 2 x 2:
    ``decode-olmoe`` those whose cache (the new token's slot included)
    lies inside the first of two sequence blocks of 1024, so all but the
    capacity-frozen row; ``decode-r1`` and the prefill cases none of the
    bf16 step's (their float32 step holds every row); the train cases
    every row (None)."""
    held = {name: ss.held_rows(name, ss.case_shape(name), 2)
            for name in ss.CASES}
    assert held["decode-olmoe"] == [0, 1, 2, 3, 5, 6, 7]
    assert held["decode-r1"] == []
    assert all(held[n] == [] for n in ss.CASES if n.startswith("prefill"))
    assert all(held[n] is None for n in ss.CASES if n.startswith("train"))


class _Mesh:
    """A mesh's device type and shape, as far as the specs read them."""

    def __init__(self, device_type):
        self.device_type = device_type
        self.mesh_dim_names = ("data", "model")
        self.mesh = torch.zeros(1, 1)


@pytest.mark.parametrize("what", ["unsharded", "cpu_mesh", "cpu_weights"])
def test_build_step_on_cuda_raises_without_card(what):
    """A real step asked for ``cuda`` on a machine without a card raises
    (no fallback to the CPU), as does a mesh on another device than its
    weights'."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.configs.base import InputShape
    from repro_torch.models import init_params

    cfg = smoke_variant(get_config("qwen3-8b"))
    shape = InputShape("t", 16, 4, "train")
    if what == "unsharded":
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dryrun.build_step(cfg, shape, None, device="cuda")
    elif what == "cpu_mesh":
        with pytest.raises(ValueError, match="the weights live on cuda, "
                           "the mesh on cpu"):
            dryrun.build_step(cfg, shape, _Mesh("cpu"), device="cuda")
    else:
        params = init_params(cfg, device="cpu")
        with pytest.raises(ValueError, match="live on cpu, the mesh on "
                           "cuda"):
            dryrun.build_step(cfg, shape, _Mesh("cuda"), device="cpu",
                              params=params)


def _lse_inputs(lens, s=24, seed=0):
    rng = np.random.RandomState(seed)
    b, h, r, dr = len(lens), 4, 32, 8
    return (torch.from_numpy(rng.randn(b, h, r).astype(np.float32)),
            torch.from_numpy(rng.randn(b, h, dr).astype(np.float32)),
            torch.from_numpy(rng.randn(b, s, r + dr).astype(np.float32)),
            torch.tensor(lens, dtype=torch.int32), 0.2)


@pytest.mark.parametrize("lens", [[5, -1, 23, 24], [-3, -1, 0, 30]])
def test_plain_lse_matches_direct_logsumexp(lens):
    """``return_lse``: o bit-equal to the default call, lse the
    log-sum-exp of the row's scaled scores over positions
    0..min(cache_len, S-1) in float64; an empty row (negative bound) has
    o = 0 and lse = -inf."""
    ql, qr, cache, cl, scale = _lse_inputs(lens)
    o, lse = mla_decode_attention_ref(ql, qr, cache, cl, scale,
                                      return_lse=True)
    assert torch.equal(o, mla_decode_attention_ref(ql, qr, cache, cl, scale))
    r, s = ql.shape[-1], cache.shape[1]
    c64 = cache.double()
    for b, n in enumerate(lens):
        if n < 0:
            assert (o[b] == 0).all() and torch.isneginf(lse[b]).all()
            continue
        n = min(n, s - 1) + 1
        sc = (torch.einsum("hr,tr->ht", ql[b].double(), c64[b, :n, :r])
              + torch.einsum("he,te->ht", qr[b].double(), c64[b, :n, r:])
              ) * scale
        want = torch.logsumexp(sc, dim=-1)
        assert ((lse[b].double() - want).abs() / want.abs()).max() < 1e-6
        ref = torch.softmax(sc, -1) @ c64[b, :n, :r]
        assert (o[b].double() - ref).abs().max() < 1e-5


@pytest.mark.parametrize("n_pieces", [1, 3, 8])
def test_pieces_emulation_with_empty_rows(n_pieces):
    """The kernel's split and merge (``plan.py``) with empty rows: no tile
    and no segment for them, o = 0 and lse = -inf, and the other rows as
    the plain version gives them."""
    args = _lse_inputs([-1, 40, -7, 3], s=48, seed=2)
    got, lse = mla_decode_attention_pieces(*args, n_pieces, return_lse=True)
    want, want_lse = mla_decode_attention_ref(*args, return_lse=True)
    torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(want_lse))
    fin = torch.isfinite(want_lse)
    torch.testing.assert_close(lse[fin], want_lse[fin], rtol=1e-6, atol=0)
