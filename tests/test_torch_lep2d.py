"""The port's LEP over a 2 x 2 mesh (``make_lep_moe_fn(mesh=...)``) against
the JAX package's, on the CPU: four gloo ranks over a ``DeviceMesh``
against JAX on a forced 4-device mesh, on the same numpy weights and
tokens. Every mode of ``tests/test_multidevice.py``'s LEP test plus the
quantized token gather, at a token count that divides over the ranks and
one that needs padding, with each rank holding the whole experts and with
each holding only its own slots and F-shard (``keep_local_experts``); then
one sharded training step through LEP (the collectives' gradient rules)
against JAX's ``make_train_step``.

Tolerances: LEP outputs within 1e-5 of JAX's largest entry (float32, as
``test_torch_lep.py``), the dropped count equal, on every rank; the loss
within 1e-5 relative and, with an unquantized dispatch, each gradient
within 2e-4 of that leaf's largest |g| (``test_torch_train.py``'s
tolerances) and each updated weight within 2e-4 of that leaf's largest
|value| where its gradient is clear of 0; with INT8 dispatch the gradients
within 0.05 (a code may round the other way, see ``QUANT_GRAD_TOL``)."""
import json
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import smoke
from repro.models import init_params as j_init_params
from repro.models import moe as j_moe
from test_torch_lep import _kill_all, _start

LEP_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4           # of each leaf's largest |gradient|
PARAM_TOL = 2e-4          # of each leaf's largest |value|
TOKENS = (24, 13)         # 13 rows do not divide over 4 ranks
TIMEOUT_S = 200           # both subprocesses of a test together
N_DATA, N_MODEL = 2, 2

# test_multidevice.py's modes, the full mesh without redundancy, and the
# token gather with its second hop quantized.
MODES = {
    "model": {"ep_axes": ["model"]},
    "full": {"ep_axes": ["data", "model"]},
    "full_redundancy": {"ep_axes": ["data", "model"], "redundancy": 2},
    "ffn_weights": {"ep_axes": ["model"], "ffn_shard_axis": "data"},
    "ffn_tokens": {"ep_axes": ["model"], "ffn_shard_axis": "data",
                   "ffn_gather": "tokens"},
    "ffn_tokens_quantized": {"ep_axes": ["model"], "ffn_shard_axis": "data",
                             "ffn_gather": "tokens",
                             "quantize_gather": True},
    "naive": {"ep_axes": ["model"], "naive": True},
    "bf16_payload": {"ep_axes": ["model"], "quantize": False},
}

JAX_LEP = textwrap.dedent("""
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, smoke_variant
    from repro.core.lep import make_lep_moe_fn
    from repro.launch.mesh import make_debug_mesh
    d = np.load(sys.argv[1])
    modes = json.loads(sys.argv[2])
    cfg = dataclasses.replace(smoke_variant(get_config("olmoe-1b-7b")),
                              capacity_factor=8.0)
    p = {k[2:]: jnp.asarray(d[k]) for k in d.files if k.startswith("w:")}
    mesh = make_debug_mesh(%d, %d)
    out = {}
    for name, kw in modes.items():
        kw = dict(kw, ep_axes=tuple(kw["ep_axes"]))
        fn = make_lep_moe_fn(mesh, **kw)
        for t in %s:
            with mesh:
                o, aux = jax.jit(lambda pp, xx: fn(pp, xx, cfg))(
                    p, jnp.asarray(d[f"x{t}"]))
            out[f"{name}:{t}"] = np.asarray(o)
            out[f"{name}:{t}:dropped"] = np.asarray(aux["dropped"])
    np.savez(sys.argv[3], **out)
""" % (N_DATA, N_MODEL, TOKENS))

PORT_LEP = textwrap.dedent("""
    import copy, dataclasses, json, sys
    import numpy as np, torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.convert import moe_from_jax_numpy
    from repro_torch.core.lep import keep_local_experts, make_lep_moe_fn
    from repro_torch.launch.mesh import make_debug_mesh

    def run(rank, inp, modes, outp, init):
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=%d)
        torch.set_num_threads(1)
        mesh = make_debug_mesh(%d, %d)
        d = np.load(inp)
        cfg = dataclasses.replace(smoke_variant(get_config("olmoe-1b-7b")),
                                  capacity_factor=8.0)
        tree = {k[2:]: d[k][None] for k in d.files if k.startswith("w:")}
        p = moe_from_jax_numpy(tree, cfg, 0, "cpu")
        out = {}
        for name, kw in modes.items():
            kw = dict(kw, ep_axes=tuple(kw["ep_axes"]))
            fn = make_lep_moe_fn(mesh=mesh, **kw)
            local = copy.deepcopy(p)
            keep_local_experts(local, mesh=mesh, **kw)
            out[f"local:{name}:numel"] = np.asarray(sum(
                w.untyped_storage().nbytes() // w.element_size()
                for w in (local.w_gate, local.w_up, local.w_down)))
            for t in %s:
                for tag, w in (("", p), ("local:", local)):
                    o, aux = fn(w, torch.from_numpy(d[f"x{t}"]), cfg)
                    out[f"{tag}{name}:{t}"] = o.numpy()
                    out[f"{tag}{name}:{t}:dropped"] = np.asarray(
                        int(aux["dropped"]))
        np.savez(f"{outp}.rank{rank}.npz", **out)
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1], json.loads(sys.argv[2]),
                            sys.argv[3], sys.argv[4]), nprocs=%d)
""" % (N_DATA * N_MODEL, N_DATA, N_MODEL, TOKENS, N_DATA * N_MODEL))


def _x(t, d, seed):
    return np.random.RandomState(seed).randn(t, d).astype(np.float32)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _run_pair(tmp_path, jax_code, port_code, jax_args, port_args):
    """Run the JAX script on a forced 4-device mesh and the port's script
    (4 gloo ranks, ``file://`` rendezvous) side by side under one deadline;
    every process is killed on the way out."""
    (tmp_path / "jax_side.py").write_text(jax_code)
    (tmp_path / "port_side.py").write_text(port_code)
    deadline = time.monotonic() + TIMEOUT_S
    procs = [
        _start(tmp_path / "jax_side.py", jax_args,
               xla_devices=N_DATA * N_MODEL),
        _start(tmp_path / "port_side.py",
               port_args + [f"file://{tmp_path / 'gloo_init'}"]),
    ]
    try:
        for proc in procs:
            out, err = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert proc.returncode == 0, \
                f"stdout:\n{out}\nstderr:\n{err[-3000:]}"
    finally:
        _kill_all(procs)


@pytest.fixture(scope="module")
def lep_runs(tmp_path_factory):
    """Both sides run once: (JAX's arrays, each port rank's arrays, the
    experts' element count)."""
    tmp = tmp_path_factory.mktemp("lep2d")
    cfg = smoke("olmoe-1b-7b")
    jp = jax.tree.map(lambda a: np.asarray(a[0]), j_moe.init_moe_params(
        jax.random.PRNGKey(0), cfg, 1, jnp.float32))
    arrays = {f"w:{k}": v for k, v in jp.items()}
    for t in TOKENS:
        arrays[f"x{t}"] = _x(t, cfg.d_model, seed=t)
    np.savez(tmp / "in.npz", **arrays)
    modes = json.dumps(MODES)
    _run_pair(tmp, JAX_LEP, PORT_LEP,
              [str(tmp / "in.npz"), modes, str(tmp / "jax.npz")],
              [str(tmp / "in.npz"), modes, str(tmp / "port")])
    numel = sum(jp[k].size for k in ("w_gate", "w_up", "w_down"))
    return (np.load(tmp / "jax.npz"),
            [np.load(tmp / f"port.rank{r}.npz")
             for r in range(N_DATA * N_MODEL)], numel)


def test_lep_2x2_every_mode_matches_jax(lep_runs):
    """Four gloo ranks over a 2 x 2 ``DeviceMesh`` against JAX LEP over a
    forced 4-device mesh: every mode, 24 and 13 tokens. Every rank holds
    the whole output."""
    ref, ranks, _ = lep_runs
    whole = sorted(k for k in ranks[0].files if not k.startswith("local:"))
    assert whole == sorted(ref.files)
    assert len(ref.files) == 2 * len(MODES) * len(TOKENS)
    for key in ref.files:
        for got in ranks:
            if key.endswith(":dropped"):
                assert int(got[key]) == int(ref[key]) == 0, key
            else:
                assert got[key].shape == ref[key].shape, key
                assert _rel(got[key], ref[key]) <= LEP_RTOL, key


@pytest.mark.parametrize("mode", MODES)
def test_lep_2x2_local_experts_match_jax(lep_runs, mode):
    """Each rank holds only its expert slots and F-shard
    (``keep_local_experts``; the ZeRO-3 gather brings in the F-shards it
    lacks), counted by the storage it keeps alive: the same outputs as
    JAX's, on every rank."""
    ref, ranks, numel = lep_runs
    kw = MODES[mode]
    n_ep = N_DATA * N_MODEL if "data" in kw["ep_axes"] else N_MODEL
    n_shard = N_DATA if kw.get("ffn_shard_axis") else 1
    for got in ranks:
        assert int(got[f"local:{mode}:numel"]) * n_ep * n_shard \
            == numel * kw.get("redundancy", 1)
        for t in TOKENS:
            key = f"{mode}:{t}"
            assert int(got[f"local:{key}:dropped"]) == 0
            assert got[f"local:{key}"].shape == ref[key].shape
            assert _rel(got[f"local:{key}"], ref[key]) <= LEP_RTOL, key


# ---------------------------------------------------------------------------
# A sharded training step through LEP
# ---------------------------------------------------------------------------

BATCH, SEQ = 8, 16
# The dispatch payload: unquantized, and JAX's default early INT8.
PAYLOADS = (("bf16", False), ("int8", True))
# With INT8 dispatch a code may round the other way at a half-integer
# (XLA fuses the division into the whole jitted step), which moves a
# token's expert input by a whole step; its gradients are held at the
# quantized modes' tolerance against the exact MoE (test_torch_lep.py).
QUANT_GRAD_TOL = 0.05

JAX_TRAIN = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, smoke_variant
    from repro.core.lep import make_lep_moe_fn
    from repro.launch.mesh import make_debug_mesh
    from repro.models import init_params, lm_loss
    from repro.train import OptConfig, init_opt_state, make_train_step
    d = np.load(sys.argv[1])
    cfg = smoke_variant(get_config("olmoe-1b-7b"))
    params = init_params(jax.random.PRNGKey(0), cfg)
    mesh = make_debug_mesh(%d, %d)
    batch = {k: jnp.asarray(d[k]) for k in ("tokens", "labels")}
    out = {}
    for payload, quantize in %s:
        moe_fn = make_lep_moe_fn(mesh, ep_axes=("model",), quantize=quantize)
        step = make_train_step(cfg, OptConfig(total_steps=5, warmup_steps=1),
                               moe_fn)
        with mesh:
            grads = jax.jit(jax.grad(
                lambda pp: lm_loss(pp, cfg, batch, moe_fn)[0]))(params)
            p2, _, m = jax.jit(step)(params, init_opt_state(params), batch)
        out[payload + ":loss"] = np.asarray(m["loss"])
        out[payload + ":grad_norm"] = np.asarray(m["grad_norm"])
        for tag, tree in (("p", p2), ("g", grads)):
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                key = "/".join(k.key for k in path)
                out[f"{payload}:{tag}:{key}"] = np.asarray(leaf)
    np.savez(sys.argv[2], **out)
""" % (N_DATA, N_MODEL, PAYLOADS))

PORT_TRAIN = textwrap.dedent("""
    import copy, sys
    import numpy as np, torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.convert import param_tree, params_from_jax_numpy
    from repro_torch.core.lep import make_lep_moe_fn
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm_loss
    from repro_torch.train import (OptConfig, init_opt_state, make_train_step,
                                   trainable)

    def nest(flat):
        tree = {}
        for key, value in flat.items():
            *path, leaf = key.split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = value
        return tree

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, prefix + k + "/"))
            else:
                out[prefix + k] = v
        return out

    def run(rank, inp, outp, init):
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=%d)
        torch.set_num_threads(1)
        mesh = make_debug_mesh(%d, %d)
        d = np.load(inp)
        cfg = smoke_variant(get_config("olmoe-1b-7b"))
        start = params_from_jax_numpy(
            nest({k[2:]: d[k] for k in d.files if k.startswith("p:")}),
            cfg, "cpu")
        batch = {k: torch.from_numpy(d[k]) for k in ("tokens", "labels")}
        out = {}
        for payload, quantize in %s:
            moe_fn = make_lep_moe_fn(mesh=mesh, ep_axes=("model",),
                                     quantize=quantize)
            step = make_train_step(cfg, OptConfig(total_steps=5,
                                                  warmup_steps=1), moe_fn)
            model = copy.deepcopy(start)
            with trainable(model) as leaves:
                grads = torch.autograd.grad(
                    lm_loss(model, cfg, batch, moe_fn)[0], leaves,
                    allow_unused=True)
            holder = copy.deepcopy(model)
            for p, g in zip(holder.parameters(), grads):
                p.data.copy_(0 if g is None else g)
            model, _, m = step(model, init_opt_state(model, device="cpu"),
                               batch)
            out[payload + ":loss"] = m["loss"].numpy()
            out[payload + ":grad_norm"] = m["grad_norm"].numpy()
            for tag, tree in (("p", model), ("g", holder)):
                out.update({f"{payload}:{tag}:{k}": v.numpy()
                            for k, v in flat(param_tree(tree)).items()})
        np.savez(f"{outp}.rank{rank}.npz", **out)
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1], sys.argv[2], sys.argv[3]),
                 nprocs=%d)
""" % (N_DATA * N_MODEL, N_DATA, N_MODEL, PAYLOADS, N_DATA * N_MODEL))


def test_sharded_train_step_matches_jax(tmp_path):
    """One ``make_train_step`` step on the OLMoE smoke variant through LEP
    with ``ep_axes=("model",)`` over 2 x 2: the port's four ranks against
    JAX's jitted step on a forced 4-device mesh (JAX's
    ``test_sharded_train_step_runs``, held to numbers). Each rank ends with
    the whole updated model, equal to JAX's."""
    cfg = smoke("olmoe-1b-7b")
    params = jax.jit(j_init_params, static_argnums=(1,))(
        jax.random.PRNGKey(0), cfg)
    rng = np.random.RandomState(0)
    arrays = {"p:" + "/".join(k.key for k in path): np.asarray(leaf)
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  params)[0]}
    for k in ("tokens", "labels"):
        arrays[k] = rng.randint(0, cfg.vocab_size, (BATCH, SEQ)).astype(
            np.int32)
    np.savez(tmp_path / "in.npz", **arrays)
    _run_pair(tmp_path, JAX_TRAIN, PORT_TRAIN,
              [str(tmp_path / "in.npz"), str(tmp_path / "jax.npz")],
              [str(tmp_path / "in.npz"), str(tmp_path / "port")])
    ref = np.load(tmp_path / "jax.npz")
    leaves = [k[len("bf16:p:"):] for k in ref.files
              if k.startswith("bf16:p:")]
    assert len(leaves) == len(jax.tree.leaves(params))
    for r in range(N_DATA * N_MODEL):
        got = np.load(tmp_path / f"port.rank{r}.npz")
        assert sorted(got.files) == sorted(ref.files)
        for payload, quantized in PAYLOADS:
            loss = float(ref[payload + ":loss"])
            assert abs(float(got[payload + ":loss"]) - loss) \
                <= LOSS_RTOL * abs(loss)
            tol = QUANT_GRAD_TOL if quantized else GRAD_TOL
            for key in leaves:
                g_ref = ref[f"{payload}:g:{key}"]
                g_scale = max(float(np.abs(g_ref).max()), 1e-12)
                err = float(np.abs(got[f"{payload}:g:{key}"] - g_ref).max())
                assert err <= tol * g_scale, (r, payload, key, err, g_scale)
                if quantized:
                    continue
                # AdamW's first step moves each weight by about lr x
                # sign(g), so a gradient within the tolerance of 0 may take
                # either sign: the weights are held where it is clear of 0.
                clear = np.abs(g_ref) > GRAD_TOL * g_scale
                p_ref = ref[f"{payload}:p:{key}"]
                scale = float(np.abs(p_ref).max())
                err = float(np.abs(got[f"{payload}:p:{key}"] - p_ref)[
                    clear].max(initial=0.0))
                assert err <= PARAM_TOL * scale, (r, key, err, scale)
                assert clear.any() or not g_ref.any(), key
            np.testing.assert_allclose(float(got[payload + ":grad_norm"]),
                                       float(ref[payload + ":grad_norm"]),
                                       rtol=tol)


@pytest.mark.parametrize("kw", [dict(ffn_shard_axis="data"),
                                dict(ffn_gather="tokens"),
                                dict(quantize_gather=True)])
def test_two_d_modes_need_a_mesh(kw):
    """The 1-D API refuses the modes that shard over a mesh axis."""
    from repro_torch.core import lep
    with pytest.raises(ValueError, match="mesh="):
        lep.make_lep_moe_fn(**kw)


def test_local_experts_on_one_rank_copy_nothing_and_refuse_misuse():
    """At world size 1 ``keep_local_experts`` leaves every weight as it was
    (no copy); the MoE function refuses experts cut to another layout's
    share and, serving only, cut experts that require grad."""
    import torch

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core import lep
    from repro_torch.models.moe import MoE
    cfg = smoke_variant(get_config("olmoe-1b-7b"))
    moe = MoE(cfg, torch.device("cpu"), torch.float32,
              torch.Generator().manual_seed(0))
    before = [moe.w_gate, moe.w_up, moe.w_down]
    fn = lep.make_lep_moe_fn()
    x = torch.from_numpy(_x(8, cfg.d_model, seed=0))
    whole, _ = fn(moe, x, cfg)
    lep.keep_local_experts(moe)
    assert [moe.w_gate, moe.w_up, moe.w_down] == before
    assert moe.expert_share == (0, 1, 0, 1, 1)
    np.testing.assert_array_equal(fn(moe, x, cfg)[0].numpy(), whole.numpy())
    moe.w_gate.requires_grad_(True)
    with pytest.raises(ValueError, match="serve only"):
        fn(moe, x, cfg)
    moe.w_gate.requires_grad_(False)
    with pytest.raises(ValueError, match="keep_local_experts"):
        lep.make_lep_moe_fn(redundancy=2)(moe, x, cfg)
