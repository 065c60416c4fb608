"""What the sharded tests share: their seeded inputs, the port's gloo ranks
(``PORT_SIDE``, a script each test file starts as subprocesses of its own,
planned to run its part), and the wait that holds those processes to a
deadline, naming the one that overran or failed.

The three files and what each holds against what:

* ``test_torch_sharded_mixers.py``: the mixers, ``lm_loss``'s gradients and
  ``make_train_step`` over DTensors at 1 x 2 and 2 x 2, against JAX's
  functions in the worker;
* ``test_torch_sharded_steps.py``: the dry run's sharded steps
  (``launch/sharded_step.py``) at 2 x 2 against the same steps unsharded,
  in float64 and against the dry run's records, and the INT8 LEP train
  steps' choices gate and replay (no JAX);
* ``test_torch_sharded_lep.py``: LEP at 2 x 2 (redundancy, a shared expert,
  the OLMoE and R1 LEP train steps) and R1's hybrid prefill, against JAX on
  a forced 4-device mesh (``JAX_EXTRA``).

Under ``--dist loadfile`` each file runs on a worker of its own."""
import dataclasses
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke_variant
from repro.models import attention as j_attn
from repro.models import init_params as j_init_params
from repro.models import mamba2 as j_mamba
from repro.models import mla as j_mla
from repro.models import moe as j_moe
from repro_torch.launch import dryrun
from repro_torch.launch import sharded_step as ss
from test_torch_lep import _kill_all

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4          # of each leaf's largest |gradient|
STEP_TOL = 2e-4          # of each leaf's largest |value|
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
B, S = 4, 16             # decode: 2 rows and 8 positions a rank on 2 x 2
DECODE_LENS = [3, 16, 9, 12]      # 3: inside rank 0's block; 16: frozen
RING_LENS = [3, 20, 9, 40]        # past the ring's 16 slots
S_PREFILL, S_SSD = 24, 64
#: (arch, replaced fields) trained at 1 x 2
TRAIN = {"deepseek-r1": {"num_experts": 0},
         "qwen3-8b": {"num_kv_heads": 1}, "mamba2-780m": {}}
#: case -> (arch, replaced fields, meshes), taken one whole train step;
#: one K/V head over the model axis of 2 (Qwen2.5's with its QKV bias)
#: at 2 x 2 only
STEP = {"deepseek-r1": ("deepseek-r1", {"num_experts": 0}, list(MESHES)),
        "qwen3-8b": ("qwen3-8b", {}, list(MESHES)),
        "qwen3-8b-kv1": ("qwen3-8b", {"num_kv_heads": 1}, ["2x2"]),
        "qwen2.5-3b-kv1": ("qwen2.5-3b", {"num_kv_heads": 1}, ["2x2"]),
        "mamba2-780m": ("mamba2-780m", {}, list(MESHES))}
#: the optimizer of that step: no warmup, so the first step moves each
#: weight by about lr = 3e-4, above STEP_TOL of a leaf's largest value
STEP_OPT = {"warmup_steps": 1}
LEP_TOKENS = 24          # 6 rows a rank on 2 x 2
LEP_KW = {"ep_axes": ["data", "model"], "redundancy": 2}
#: the shared-expert LEP case: 24 rows of x a rank (its batch over
#: ``data``), experts 8 wide, so 3 x 8 weight elements a row are no more
#: than x's rows and the shared expert runs on the token split
LEP_SHARED_TOKENS, LEP_SHARED_FF = 48, 8
#: ``dtensor.linear`` over q/k/v weights (D x 16, D x 8, D x 8: one K/V
#: head of 8) asked for ``heads`` at 2 x 2, layout -> (x's spec, the
#: weights' spec, the ranks that share the K/V head): the K/V head over
#: the 2 ranks of ``model`` (x's rows over ``data``) takes the head path;
#: x's last dim cut too, or the weights' rows cut over ``data``, where the
#: head path does not hold, come out whole
LINEAR_D = 16
LINEAR = {"heads": (["data", None, None], [None, "model"], 2),
          "x_cut": ([None, None, "model"], [None, ["data", "model"]], 1),
          "w_rows": ([None, None, None], ["data", "model"], 1)}
#: the OLMoE + LEP train step held against JAX's on its forced 2 x 2 mesh:
#: no token dropped, the balance loss at its configured weight
OLMOE_JAX_FIELDS = {"capacity_factor": 8.0}
#: R1's, at the depth of ``train-r1``'s smoke step (a dense layer, then two
#: MoE layers: LEP leaves the first one's output on its token split, which
#: the second one's attention takes)
R1_LEP_FIELDS = {"num_layers": 3, "first_k_dense": 1, "capacity_factor": 8.0}
#: the LEP train steps, by name: (the model's key, its arch, its fields,
#: the sharded-step case whose batch it takes, the dispatch payload's
#: quantization). OLMoE: INT8 (the training plan's, as
#: ``test_multidevice.py`` runs it) and unquantized (float32 at smoke
#: width); R1 unquantized
LEP_STEPS = {"int8": ("olmoe", "olmoe-1b-7b", OLMOE_JAX_FIELDS, "train-olmoe",
                      True),
             "f32": ("olmoe", "olmoe-1b-7b", OLMOE_JAX_FIELDS, "train-olmoe",
                     False),
             "r1-f32": ("r1lep", "deepseek-r1", R1_LEP_FIELDS, "train-r1",
                        False)}
#: R1's prefill through the hybrid against JAX's: the prefill cases' smoke
#: fields (4 MLA layers, the last a MoE layer; no token dropped)
HYBRID_FIELDS = ss.CASES["prefill-r1-a2a"].smoke_fields
HYBRID_MODES = ("a2a", "rs")


def smoke(arch, **fields):
    return dataclasses.replace(j_smoke_variant(j_get_config(arch)), **fields)


def layer_weights(init, cfg, seed):
    """One layer's weights from JAX's initializer, unstacked, as numpy."""
    return {k: np.asarray(v[0]) for k, v in jax.jit(
        lambda key: init(key, cfg, 1, jnp.float32))(
        jax.random.PRNGKey(seed)).items()}


def flat(tree):
    return {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def params(cfg, seed):
    """JAX's ``init_params`` of ``cfg`` from ``seed``, flat, as numpy."""
    return flat(jax.jit(j_init_params, static_argnums=(1,))(
        jax.random.PRNGKey(seed), cfg))


def close(got, want, tol=TOL):
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max |err| {err:.3e} of the largest entry"


def seeded_arrays():
    """Every array the sharded tests draw from one ``RandomState(0)``, in
    the order they draw them (so each file takes the same values whichever
    of them it uses)."""
    rng = np.random.RandomState(0)
    r1, q4, m2 = (smoke("deepseek-r1"), smoke("qwen3-8b"),
                  smoke("mamba2-780m"))
    f = lambda *shape: rng.randn(*shape).astype(np.float32)  # noqa: E731
    width = r1.kv_lora_rank + r1.qk_rope_head_dim
    d = dict(mla_x1=f(B, 1, r1.d_model), mla_xs=f(B, S_PREFILL, r1.d_model),
             mla_cache=f(B, S, width), gqa_x1=f(B, 1, q4.d_model),
             gqa_xs=f(B, S_PREFILL, q4.d_model),
             gqa_k=f(B, S, q4.num_kv_heads, q4.head_dim),
             gqa_v=f(B, S, q4.num_kv_heads, q4.head_dim),
             lens=np.array(DECODE_LENS, np.int32),
             ring_lens=np.array(RING_LENS, np.int32),
             mamba_x=f(B, S_SSD, m2.d_model))
    h, pd, n = m2.ssm_heads, m2.ssm_head_dim, m2.ssm_state
    d.update(ssd_x=f(B, S_SSD, h, pd),
             ssd_dt=np.abs(f(B, S_SSD, h)) * 0.1,
             ssd_a=f(h) * 0.5, ssd_b=f(B, S_SSD, n), ssd_c=f(B, S_SSD, n))
    for arch, fields in TRAIN.items():
        cfg = smoke(arch, **fields)
        for k in ("tokens", "labels"):
            d[f"{arch}:{k}"] = rng.randint(0, cfg.vocab_size,
                                           (2, 16)).astype(np.int32)
    for case, (arch, fields, _) in STEP.items():
        cfg = smoke(arch, **fields)
        for k in ("tokens", "labels"):
            d[f"step:{case}:{k}"] = rng.randint(0, cfg.vocab_size,
                                                (2, 16)).astype(np.int32)
    d["lep_x"] = f(LEP_TOKENS, smoke("olmoe-1b-7b").d_model)
    r1moe = smoke("deepseek-r1", d_ff=LEP_SHARED_FF)
    d["lep_shared_x"] = f(LEP_SHARED_TOKENS, r1moe.d_model)
    d["lep_shared_cot"] = f(LEP_SHARED_TOKENS, r1moe.d_model)
    d.update(lin_x=f(B, S_PREFILL, LINEAR_D), lin_wq=f(LINEAR_D, 16),
             lin_wk=f(LINEAR_D, 8), lin_wv=f(LINEAR_D, 8))
    hyb = smoke("deepseek-r1", **HYBRID_FIELDS)
    shape = ss.case_shape("prefill-r1", smoke=True)
    d["hyb:tokens"] = rng.randint(0, hyb.vocab_size, (
        shape.global_batch, shape.seq_len)).astype(np.int32)
    return d


MIXER_ARRAYS = ("mla_x1", "mla_xs", "mla_cache", "gqa_x1", "gqa_xs", "gqa_k",
                "gqa_v", "lens", "ring_lens", "mamba_x", "ssd_x", "ssd_dt",
                "ssd_a", "ssd_b", "ssd_c", "lin_x", "lin_wq", "lin_wk",
                "lin_wv")


def mixer_inputs():
    """The mixers', gradients' and train steps' weights and inputs."""
    arrays = seeded_arrays()
    r1, q4, q1, m2 = (smoke("deepseek-r1"), smoke("qwen3-8b"),
                      smoke("qwen3-8b", num_kv_heads=1),
                      smoke("mamba2-780m"))
    d = {k: arrays[k] for k in MIXER_ARRAYS}
    for prefix, init, cfg, seed in (("mla", j_mla.init_mla_params, r1, 1),
                                    ("gqa4", j_attn.init_attention_params,
                                     q4, 2),
                                    ("gqa1", j_attn.init_attention_params,
                                     q1, 3),
                                    ("mamba", j_mamba.init_mamba_params, m2,
                                     4)):
        d.update({f"{prefix}:{k}": v
                  for k, v in layer_weights(init, cfg, seed).items()})
    for arch, fields in TRAIN.items():
        d.update({f"p:{arch}:{k}": v for k, v in params(
            smoke(arch, **fields), 0).items()})
        d.update({f"{arch}:{k}": arrays[f"{arch}:{k}"]
                  for k in ("tokens", "labels")})
    for case, (arch, fields, _) in STEP.items():
        d.update({f"step:{case}:p:{k}": v for k, v in params(
            smoke(arch, **fields), 1).items()})
        d.update({f"step:{case}:{k}": arrays[f"step:{case}:{k}"]
                  for k in ("tokens", "labels")})
    return d


def lep_inputs():
    """LEP's layers', its train steps' and the hybrid prefill's weights
    and inputs."""
    arrays = seeded_arrays()
    d = {k: arrays[k] for k in ("lep_x", "lep_shared_x", "lep_shared_cot",
                                "hyb:tokens")}
    olmoe = smoke("olmoe-1b-7b")
    d.update({f"lep:{k}": np.asarray(v[0]) for k, v in j_moe.init_moe_params(
        jax.random.PRNGKey(5), olmoe, 1, jnp.float32).items()})
    r1moe = smoke("deepseek-r1", d_ff=LEP_SHARED_FF)
    d.update({f"lep_shared:{k}": np.asarray(v[0]) for k, v in
              j_moe.init_moe_params(jax.random.PRNGKey(6), r1moe, 1,
                                    jnp.float32).items()})
    models = {m: (arch, fields, case)
              for m, arch, fields, case, _ in LEP_STEPS.values()}
    for seed, (m, (arch, fields, case)) in enumerate(models.items(), 2):
        d.update({f"{m}:p:{k}": v for k, v in params(
            smoke(arch, **fields), seed).items()})
        # the batch build_step draws for the case (seed 0: its inputs
        # from 1)
        batch = dryrun.step_inputs(ss.case_config(case, smoke=True),
                                   ss.case_shape(case, smoke=True), "cpu",
                                   seed=1)
        d.update({f"{m}:{k}": v.numpy() for k, v in batch.items()})
    d.update({f"hyb:p:{k}": v for k, v in params(
        smoke("deepseek-r1", **HYBRID_FIELDS), 3).items()})
    return d


# ---------------------------------------------------------------------------
# The processes and their deadline
# ---------------------------------------------------------------------------

#: the lines of a failed process's stderr that its error carries
TAIL_LINES = 40


def start(name, code_path, args, logs, xla_devices=None):
    """``python code_path args`` in a session of its own (so that it and the
    ranks it forks are killed together), its stderr into ``logs /
    <name>.err`` (a file, which no pipe left unread can stall), its stdout
    dropped; ``xla_devices`` forces that many host devices on XLA's CPU
    platform. The process carries its name and its log's path."""
    run_env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if xla_devices:
        run_env["XLA_FLAGS"] = \
            f"--xla_force_host_platform_device_count={xla_devices}"
    err = Path(logs) / f"{name}.err"
    with open(err, "w") as f:
        proc = subprocess.Popen([sys.executable, str(code_path), *args],
                                env=run_env, stdout=subprocess.DEVNULL,
                                stderr=f, start_new_session=True)
    proc.name, proc.err = name, err
    return proc


def tail(proc, lines=TAIL_LINES):
    text = Path(proc.err).read_text(errors="replace").splitlines()
    return "\n".join(text[-lines:])


def wait_all(procs, limit_s, started):
    """Wait for every process of ``procs`` (from :func:`start`) to end
    within ``limit_s`` seconds of ``started`` (``time.monotonic()``). One
    that overruns it or exits non-zero fails the wait with an error that
    names it and carries its stderr's last TAIL_LINES lines; every process
    left is killed on the way out."""
    try:
        for proc in procs:
            try:
                proc.wait(timeout=max(0.1, started + limit_s
                                      - time.monotonic()))
            except subprocess.TimeoutExpired:
                _kill_all(procs)
                raise AssertionError(
                    f"{proc.name} overran the deadline of {limit_s:g} s "
                    f"({time.monotonic() - started:.1f} s since the start); "
                    f"the tail of its stderr:\n{tail(proc)}") from None
            if proc.returncode:
                raise AssertionError(
                    f"{proc.name} exited with {proc.returncode} after "
                    f"{time.monotonic() - started:.1f} s; the tail of its "
                    f"stderr:\n{tail(proc)}")
    finally:
        _kill_all(procs)


def start_ranks(name, shape, tmp, inp, plan):
    """The port's gloo ranks over a ``shape`` mesh (``PORT_SIDE`` forking
    one rank each), on the arrays of ``inp``, planned as ``plan``; rank 0
    writes ``tmp / <name>.npz``."""
    import json

    script = Path(tmp) / "port_side.py"
    if not script.exists():
        script.write_text(PORT_SIDE)
    return start(name, script, [
        str(shape[0] * shape[1]), json.dumps(shape), str(inp),
        str(Path(tmp) / f"{name}.npz"), f"file://{Path(tmp) / f'gloo_{name}'}",
        json.dumps(plan)], tmp)


def load_ranks(path):
    """(Rank 0's arrays, its JSON rows) as ``PORT_SIDE`` saved them."""
    import json

    arrays = dict(np.load(path))
    return arrays, json.loads(str(arrays.pop("rows")))


PORT_SIDE = textwrap.dedent('''
    import contextlib, dataclasses, json, sys
    import numpy as np, torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.convert import param_tree, params_from_jax_numpy
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import (batch_pspecs, distribute,
                                             param_pspecs, param_shapes,
                                             shard_model)
    from repro_torch.models import attention, lm_loss, mamba2, mla
    from repro_torch.train import trainable
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptConfig, OptState

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

    def layer(module, cfg, mesh, part, weights):
        """A layer with JAX's weights, each placed by the serving spec of
        ``part`` (its segment's spec without the layer axis)."""
        specs = next(seg[part] for seg in param_pspecs(
            cfg, mesh, param_shapes(cfg))["segments"].values() if part in seg)
        for name, w in weights.items():
            setattr(module, name, torch.nn.Parameter(distribute(
                torch.from_numpy(w), mesh, specs[name][1:]),
                requires_grad=False))
        return module

    def run(rank, world, shape, inp, outp, init, plan):
        """The plan's parts, in this order: ``mixers`` and ``lep`` (LEP's
        layers) as the dry run traces a step; ``lep_steps`` and
        ``hybrid`` (steps on JAX's weights); ``real_steps`` (the sharded
        steps' rows, then rank 0 alone on a world of one). Rank 0 saves
        the arrays and the rows."""
        from torch.distributed.tensor.experimental import \\
            implicit_replication

        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world)
        torch.set_num_threads(1)
        mesh = make_debug_mesh(*shape)
        plan = json.loads(plan)
        d = np.load(inp) if inp else None
        out = {}
        with implicit_replication():     # as the dry run traces a step
            if plan.get("mixers"):
                out.update(mixers(mesh, d, plan))
            if plan.get("lep"):
                out.update(lep_layers(mesh, d, plan))
        out = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
               .detach().numpy() for k, v in out.items()}
        if plan.get("lep_steps"):
            out.update(jax_weight_steps(rank, mesh, d, plan))
        steps = real_steps(rank, mesh, plan) if plan.get("real_steps") \\
            else {}
        dist.destroy_process_group()
        if rank == 0:
            if plan.get("real_steps"):
                one_rank_and_records(steps, init)
            np.savez(outp, rows=np.array(json.dumps(steps)), **out)

    def real_steps(rank, mesh, plan):
        """Every case of ``launch/sharded_step.py`` at smoke width through
        ``dryrun.build_step`` on real tensors (the seeded weights placed
        one at a time), counted (collectives, hybrid layers), against the
        same step unsharded on rank 0 (and in float64 where the case
        says); an INT8 LEP train step's choices recorded, gated and
        replayed (``sharded_step.hold_choices``); then, with the plan's
        ``planted`` case, that step again with rank 1's token split rolled
        by one token (a partition fault), gated alike; then every case in
        float64 (:func:`f64_rows`)."""
        from repro_torch.core import hybrid_parallel
        from repro_torch.launch import sharded_step as ss

        rows = {}
        for name in ss.CASES:
            _, shape, step, args = ss.case_step(name, mesh, "cpu",
                                                smoke=True)
            calls = dict(hybrid_parallel.CALLS)
            int8 = ss.CASES[name].f32_payload
            with (ss.record_choices(ss.mesh_block(mesh)) if int8
                  else contextlib.nullcontext()) as rec:
                out, counts = ss.run_counted(step, args)
            calls = {k: n - calls[k] for k, n in hybrid_parallel.CALLS.items()}
            got = ss.step_results(shape.kind, out, keep=rank == 0)
            choices = ss.gather_choices(rec) if int8 else None
            if rank == 0:
                n_micro = ss.row_groups(name, mesh.size(0), mesh.size(1),
                                        smoke=True)
                want = ss.reference(name, "cpu", n_micro=n_micro, smoke=True)
                rows[name] = dict(ss.compare(shape.kind, got, want,
                                             plan["step_tol"]),
                                  counts=counts, hybrid_calls=calls)
                if int8:
                    rows[name].update(ss.hold_choices(
                        name, "cpu", got, choices, n_micro=n_micro,
                        smoke=True))
                if ss.CASES[name].f64:
                    row = ss.compare(shape.kind, got, want, plan["step_tol"],
                                     truth=ss.truth(name, "cpu", smoke=True,
                                                    n_micro=n_micro))
                    rows[name]["f64_gate"] = {k: row[k] for k in (
                        "ok", "over", "param_f64_excess", "mu_f64_excess",
                        "nu_f64_excess", "f64")}
        planted = {}
        if plan.get("planted"):
            name = plan["planted"]
            with rolled_token_split(rank):
                # built inside: the step binds the split as it is built
                _, shape, step, args = ss.case_step(name, mesh, "cpu",
                                                    smoke=True)
                with ss.record_choices(ss.mesh_block(mesh)) as rec:
                    out, _ = ss.run_counted(step, args)
            got = ss.step_results(shape.kind, out, keep=rank == 0)
            choices = ss.gather_choices(rec)
            if rank == 0:
                planted[name] = ss.hold_choices(
                    name, "cpu", got, choices, smoke=True,
                    n_micro=ss.row_groups(name, mesh.size(0), mesh.size(1),
                                          smoke=True))
        return {"rows": rows, "planted": planted,
                **f64_rows(rank, mesh, plan["step_tol"])}

    @contextlib.contextmanager
    def rolled_token_split(rank):
        """A partition fault, planted: inside the block, LEP's token split
        of a training step (``core/lep.py::_on_token_split``) rolls rank
        1's block of tokens by one, so that each of its tokens stands in
        its neighbour's place."""
        from torch.distributed.tensor import DTensor
        from repro_torch.core import lep

        split = lep._on_token_split

        def rolled(x, mesh):
            y = split(x, mesh)
            if y is x or rank != 1:
                return y
            loc = y.to_local()
            return DTensor.from_local(
                loc.flatten(0, 1).roll(1, 0).reshape(loc.shape), mesh,
                y.placements, shape=y.shape, stride=y.stride())

        lep._on_token_split = rolled
        try:
            yield
        finally:
            lep._on_token_split = split

    def jax_weight_steps(rank, mesh, d, plan):
        """The plan's LEP train steps on JAX's weights and the case's
        batch, with the balance loss weighted as configured, for JAX's
        ``make_train_step``; then R1's prefill through the hybrid on JAX's
        weights and tokens. Rank 0's arrays."""
        from repro_torch.launch import dryrun
        from repro_torch.launch import sharded_step as ss

        arrays = {}
        for payload, (model_key, arch, fields, case, quantize) in \\
                plan["lep_steps"].items():
            cfg = dataclasses.replace(smoke_variant(get_config(arch)),
                                      **fields)
            tree = nest({k[len(model_key) + 3:]: d[k] for k in d.files
                         if k.startswith(f"{model_key}:p:")})
            model = params_from_jax_numpy(tree, cfg, "cpu")
            step, args = dryrun.build_step(
                cfg, ss.case_shape(case, smoke=True), mesh,
                device="cpu", params=model, lep={"quantize": quantize},
                inputs={k: torch.from_numpy(d[f"{model_key}:{k}"])
                        for k in ("tokens", "labels")},
                opt_cfg=OptConfig(**plan["opt"]))
            got = ss.step_results("train", ss.run_counted(step, args)[0],
                                  keep=rank == 0)
            if rank == 0:
                names = [n for n, _ in model.named_parameters()]
                key = f"{model_key}:{payload}"
                for part in ("param", "mu", "nu"):
                    arrays.update({k: v.numpy() for k, v in as_tree(
                        [got[f"{part}/{n}"] for n in names], cfg, tree,
                        f"{key}:{part}").items()})
                arrays[f"{key}:gnorm"] = got["grad_norm"].numpy()
                arrays[f"{key}:loss"] = got["loss"].numpy()
        cfg = dataclasses.replace(smoke_variant(get_config("deepseek-r1")),
                                  **plan["hybrid_fields"])
        tree = nest({k[len("hyb:p:"):]: d[k] for k in d.files
                     if k.startswith("hyb:p:")})
        for mode in plan["hybrid_modes"]:
            step, args = dryrun.build_step(
                cfg, ss.case_shape("prefill-r1", smoke=True), mesh,
                torch.float32, device="cpu",
                params=params_from_jax_numpy(tree, cfg, "cpu"),
                inputs={"tokens": torch.from_numpy(d["hyb:tokens"])},
                lep={"quantize": False}, hybrid=mode)
            got = ss.step_results("prefill", ss.run_counted(step, args)[0],
                                  keep=rank == 0)
            arrays.update({f"hybrid:{mode}:{k}": v.numpy()
                           for k, v in got.items()})
        return arrays

    def f64_rows(rank, mesh, step_tol):
        """Every case in float64 over the mesh against the same step
        unsharded in float64 on rank 0 (``sharded_step.compare_f64``),
        both under ``NarrowOps`` (every rank's records joined); then
        train-mamba2 again with ``dtensor.rms_norm`` broken on rank 0 as
        ``broken_rms_norm`` breaks it, held by the float64 gate and by the
        fixed one (``compare``), with its own record."""
        import torch.distributed as dist
        from repro_torch.launch import sharded_step as ss

        rows, ops, want_m2 = {}, {}, None
        for name in ss.CASES:
            _, shape, step, args = ss.case_step(name, mesh, "cpu", smoke=True,
                                                dtype=torch.float64)
            with ss.NarrowOps() as audit:
                out, _ = ss.run_counted(step, args)
            got = ss.step_results(shape.kind, out, keep=rank == 0)
            joined = [None] * dist.get_world_size()
            dist.all_gather_object(joined, audit.ops)
            if rank == 0:
                # ``reference``, its step alone under the record
                _, _, ref, ref_args = ss.case_step(
                    name, None, "cpu", smoke=True, n_micro=mesh.size(0),
                    dtype=torch.float64)
                with ss.NarrowOps() as ref_audit:
                    out = ref(*ref_args)
                want = ss.step_results(shape.kind, out, to=None)
                rows[name] = ss.compare_f64(shape.kind, got, want)
                rows[name]["n_rows"] = shape.global_batch
                for rec in joined + [ref_audit.ops]:
                    for k, n in rec.items():
                        ops[k] = ops.get(k, 0) + n
                if name == "train-mamba2":
                    want_m2 = want
        broken = {}
        for how in ("perturb", "demote"):
            _, shape, step, args = ss.case_step("train-mamba2", mesh, "cpu",
                                                smoke=True,
                                                dtype=torch.float64)
            with broken_rms_norm(rank, how), ss.NarrowOps() as audit:
                out, _ = ss.run_counted(step, args)
            got = ss.step_results("train", out, keep=rank == 0)
            if rank == 0:
                broken[how] = {"f64": ss.compare_f64("train", got, want_m2),
                               "fixed": ss.compare("train", got, want_m2,
                                                   step_tol),
                               "audit": audit.ops}
        return {"f64": rows, "f64_audit": ops, "f64_broken": broken}

    @contextlib.contextmanager
    def broken_rms_norm(rank, how):
        """``dtensor.rms_norm`` (Mamba2's gated norm over its head-cut
        width) broken inside the block: "perturb" scales rank 0's partial
        sum of squares by 1 + 1e-7 before its all-reduce; "demote"
        computes the body in float32 again, as it did before it widened."""
        from repro_torch import dtensor as dt
        from repro_torch.core import parallel as par

        norm, reduce, widened = dt.rms_norm, par.all_reduce, dt.widened
        inside = []

        def rms_norm(*a, **k):
            inside.append(True)
            try:
                return norm(*a, **k)
            finally:
                inside.pop()

        def all_reduce(t, *a, **k):
            if inside and rank == 0 and t.shape[-1] == 1:
                t = t * (1 + 1e-7)
            return reduce(t, *a, **k)

        dt.rms_norm = rms_norm
        if how == "perturb":
            par.all_reduce = all_reduce
        else:
            dt.widened = lambda x: x.float() if inside else widened(x)
        try:
            yield
        finally:
            dt.rms_norm, par.all_reduce, dt.widened = norm, reduce, widened

    def one_rank_and_records(steps, init):
        """(Rank 0, its world of 4 gone.) ``decode-r1`` over a 1 x 1 mesh
        of one gloo rank, counted and against the unsharded step; then the
        dry run's records of every case on a fake 2 x 2 group and of
        ``decode-r1`` on a fake 1 x 1 one."""
        from repro_torch.core import parallel as par
        from repro_torch.launch import sharded_step as ss

        par._GROUPS.clear()
        dist.init_process_group("gloo", init_method=init + "_1x1", rank=0,
                                world_size=1)
        mesh = make_debug_mesh(1, 1)
        _, shape, step, args = ss.case_step("decode-r1", mesh, "cpu",
                                            smoke=True)
        out, counts = ss.run_counted(step, args)
        got = ss.step_results(shape.kind, out)
        steps["one_rank"] = dict(ss.compare(shape.kind, got, ss.reference(
            "decode-r1", "cpu", smoke=True), 1e-5), counts=counts)
        dist.destroy_process_group()
        par._GROUPS.clear()
        steps["records"] = ss.record_collectives(
            list(ss.CASES), {"data": 2, "model": 2}, smoke=True)
        steps["one_rank_record"] = ss.record_collectives(
            ["decode-r1"], {"data": 1, "model": 1}, smoke=True)["decode-r1"]

    def sharded(d, key, arch, fields, mesh):
        """(cfg, JAX's weights under ``key`` as a tree, as a Model placed
        by the training specs, the batch placed by its specs)."""
        cfg = dataclasses.replace(smoke_variant(get_config(arch)), **fields)
        tree = nest({k[len(key) + 3:]: d[k] for k in d.files
                     if k.startswith(f"{key}:p:")})
        model = params_from_jax_numpy(tree, cfg, "cpu")
        specs = param_pspecs(cfg, mesh, param_tree(model), train=True)
        model = shard_model(model, mesh, specs)
        raw = {k: torch.from_numpy(d[f"{key}:{k}"])
               for k in ("tokens", "labels")}
        bspec = batch_pspecs(cfg, mesh, raw)
        batch = {k: distribute(v, mesh, bspec[k]) for k, v in raw.items()}
        return cfg, tree, model, batch

    def as_tree(values, cfg, tree, prefix):
        """``values`` (one per parameter, in ``parameters()`` order) as
        JAX's flat tree, keyed under ``prefix``."""
        holder = params_from_jax_numpy(tree, cfg, "cpu")
        for w, v in zip(holder.parameters(), values):
            w.data.copy_(0 if v is None else (
                v.full_tensor() if hasattr(v, "full_tensor") else v))
        return {f"{prefix}:{k}": v
                for k, v in flat(param_tree(holder)).items()}

    def mixers(mesh, d, plan):
        """The mixers, ``lm_loss``'s gradients (the plan's ``grads``), one
        ``make_train_step`` of each of its ``steps`` and its ``linear``
        layouts, on JAX's weights and inputs."""
        train = plan["grads"]
        t = lambda k: torch.from_numpy(d[k])
        cpu = torch.device("cpu")
        out = {}

        def weights(prefix):
            return {k[len(prefix):]: d[k] for k in d.files
                    if k.startswith(prefix)}

        r1 = smoke_variant(get_config("deepseek-r1"))
        p = layer(mla.MLA(r1, cpu, torch.float32), r1, mesh, "attn",
                  weights("mla:"))
        rows = ("data", None, None)
        o, cache = mla.mla_decode(
            p, distribute(t("mla_x1"), mesh, rows),
            distribute(t("mla_cache"), mesh, ("data", "model", None)),
            distribute(t("lens"), mesh, ()), r1)
        out["mla_decode"], out["mla_decode:cache"] = o, cache
        out["mla_prefill"], out["mla_prefill:latent"] = mla.mla_prefill(
            p, distribute(t("mla_xs"), mesh, rows), r1)

        for kv in (4, 1):
            cfg = dataclasses.replace(
                smoke_variant(get_config("qwen3-8b")), num_kv_heads=kv)
            p = layer(attention.Attention(cfg, cpu, torch.float32), cfg,
                      mesh, "attn", weights(f"gqa{kv}:"))
            o, (k, v) = attention.attention_prefill(
                p, distribute(t("gqa_xs"), mesh, rows), cfg)
            out[f"gqa{kv}_prefill"], out[f"gqa{kv}_prefill:k"] = o, k
            out[f"gqa{kv}_prefill:v"] = v
            if kv != 4:
                continue
            for ring in (False, True):
                kvc = ("data", "model", None, None)
                o, ck, cv = attention.attention_decode(
                    p, distribute(t("gqa_x1"), mesh, rows),
                    distribute(t("gqa_k"), mesh, kvc),
                    distribute(t("gqa_v"), mesh, kvc),
                    distribute(t("ring_lens" if ring else "lens"), mesh, ()),
                    cfg, ring)
                out[f"gqa_decode{ring:d}"] = o
                out[f"gqa_decode{ring:d}:k"] = ck
                out[f"gqa_decode{ring:d}:v"] = cv

        from repro_torch import dtensor as dt
        spec = lambda e: tuple(tuple(a) if isinstance(a, list) else a  # noqa
                               for a in e)
        for layout, (x_spec, w_spec, _) in plan["linear"].items():
            ws = [distribute(t(f"lin_w{n}"), mesh, spec(w_spec))
                  for n in "qkv"]
            for n, y in zip("qkv", dt.linear(distribute(
                    t("lin_x"), mesh, spec(x_spec)), ws, heads=(None, 1, 1))):
                out[f"linear:{layout}:{n}"] = y

        m2 = smoke_variant(get_config("mamba2-780m"))
        ssd = [distribute(t(k), mesh, ()) for k in
               ("ssd_x", "ssd_dt", "ssd_a", "ssd_b", "ssd_c")]
        out["ssd_y"], out["ssd_h"] = mamba2._scan(*ssd, m2.ssm_chunk)
        p = layer(mamba2.Mamba(m2, cpu, torch.float32), m2, mesh, "mamba",
                  weights("mamba:"))
        (out["mamba_out"], out["mamba_h"],
         out["mamba_conv"]) = mamba2.mamba_prefill(
            p, distribute(t("mamba_x"), mesh, rows), m2)

        for arch, fields in train.items():
            cfg = dataclasses.replace(smoke_variant(get_config(arch)),
                                      **fields)
            model = params_from_jax_numpy(nest(weights(f"p:{arch}:")), cfg,
                                          "cpu")
            specs = param_pspecs(cfg, mesh, param_tree(model), train=True)
            model = shard_model(model, mesh, specs)
            raw = {k: t(f"{arch}:{k}") for k in ("tokens", "labels")}
            bspec = batch_pspecs(cfg, mesh, raw)
            batch = {k: distribute(v, mesh, bspec[k]) for k, v in raw.items()}
            with trainable(model) as leaves:
                loss = lm_loss(model, cfg, batch)[0]
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            out[f"loss:{arch}"] = loss
            names = [n for n, _ in model.named_parameters()]
            holder = params_from_jax_numpy(nest(weights(f"p:{arch}:")), cfg,
                                           "cpu")
            own = dict(holder.named_parameters())
            for n, g in zip(names, grads):
                own[n].data.copy_(0 if g is None else g.full_tensor())
            out.update({f"grad:{arch}:{k}": v
                        for k, v in flat(param_tree(holder)).items()})

        for case, (arch, fields) in plan["steps"].items():
            cfg, tree, model, batch = sharded(d, f"step:{case}", arch,
                                              fields, mesh)
            leaves = list(model.parameters())
            opt = OptState(distribute(torch.zeros((), dtype=torch.int32),
                                      mesh, ()),
                           *([torch.zeros_like(w, dtype=torch.float32)
                              for w in leaves] for _ in range(2)))
            model, opt, metrics = make_train_step(
                cfg, OptConfig(**plan["opt"]))(model, opt, batch)
            out[f"gnorm:{case}"] = metrics["grad_norm"]
            for name, values in (("param", model.parameters()),
                                 ("mu", opt.mu), ("nu", opt.nu)):
                out.update(as_tree(list(values), cfg, tree,
                                   f"step:{case}:{name}"))
        return out

    def lep_layers(mesh, d, plan):
        """LEP with the plan's ``lep`` keywords (redundancy) on OLMoE's
        layer, and on R1's layer with a shared expert ``shared_ff`` wide
        under ``jax.grad``'s counterpart (a seeded cotangent)."""
        from repro_torch.convert import moe_from_jax_numpy
        from repro_torch.core.lep import make_lep_moe_fn, pick_lep_plan

        t = lambda k: torch.from_numpy(d[k])
        out = {}
        cfg = dataclasses.replace(smoke_variant(get_config(
            "olmoe-1b-7b")), capacity_factor=8.0)
        moe = moe_from_jax_numpy({k[4:]: d[k][None] for k in d.files
                                  if k.startswith("lep:")}, cfg, 0, "cpu")
        for name in ("w_gate", "w_up", "w_down"):
            setattr(moe, name, torch.nn.Parameter(distribute(
                getattr(moe, name).detach(), mesh, ("model", None, None)),
                requires_grad=False))
        moe.router = torch.nn.Parameter(distribute(
            moe.router.detach(), mesh, ()), requires_grad=False)
        kw = dict(plan["lep"], ep_axes=tuple(plan["lep"]["ep_axes"]))
        fn = make_lep_moe_fn(mesh=mesh, **kw)
        o, aux = fn(moe, distribute(t("lep_x"), mesh, ("data", None)), cfg)
        out["lep"], out["lep:dropped"] = o, aux["dropped"]

        cfg = dataclasses.replace(smoke_variant(get_config(
            "deepseek-r1")), capacity_factor=8.0, d_ff=plan["shared_ff"])
        moe = moe_from_jax_numpy({k[11:]: d[k][None] for k in d.files
                                  if k.startswith("lep_shared:")}, cfg,
                                 0, "cpu")
        specs = next(seg["moe"] for seg in param_pspecs(
            cfg, mesh, param_shapes(cfg), train=True)["segments"].values()
            if "moe" in seg)
        for name, w in moe.named_parameters():
            setattr(moe, name, torch.nn.Parameter(distribute(
                w.detach(), mesh, specs[name][1:]), requires_grad=False))
        x = distribute(t("lep_shared_x"), mesh, ("data", None))
        x.requires_grad_(True)
        fn = make_lep_moe_fn(mesh=mesh, **pick_lep_plan(cfg, mesh))
        with trainable(moe) as leaves:
            o, _ = fn(moe, x, cfg)
            grads = torch.autograd.grad(
                (o * distribute(t("lep_shared_cot"), mesh,
                                ("data", None))).sum(), [x] + leaves,
                allow_unused=True)       # the block's norm gain
        out["lep_shared"], out["lep_shared:grad:x"] = o, grads[0]
        for (name, w), g in zip(moe.named_parameters(), grads[1:]):
            out[f"lep_shared:grad:{name}"] = torch.zeros(w.shape) \\
                if g is None else g
        return out

    if __name__ == "__main__":
        world, shape = int(sys.argv[1]), tuple(json.loads(sys.argv[2]))
        # forked: a spawned rank would import everything again
        mp.start_processes(run, args=(world, shape, *sys.argv[3:]),
                           nprocs=world, start_method="fork")
''')
