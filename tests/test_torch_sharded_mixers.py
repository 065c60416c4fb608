"""The mixers over DTensors (``local_map`` entries of ``models/mla.py``,
``models/attention.py`` and ``models/mamba2.py``) against the JAX package's
functions, on the CPU: gloo ranks over a 1 x 2 and a 2 x 2 ``DeviceMesh``
(two subprocesses, their ranks forked, started together under one
deadline), every weight, input and cache a DTensor placed by the port's
specs, the same seeded numpy values through JAX's functions in this
process (its LEP and train step in a third subprocess, JAX_EXTRA).

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
  ``train.make_train_step`` on the same
  weights and batch: every parameter and both moments within 2e-4 of the
  leaf's largest, with no warmup (so the step moves every weight by more
  than that), and the global gradient norm within 1e-5.
* LEP over a DTensor batch at 2 x 2 with ``redundancy=2`` on full-mesh EP,
  the experts placed over ``model`` (each rank receives the experts its
  slots lack: a permute), against JAX's LEP function on a forced 4-device
  mesh (a subprocess of its own): within 1e-5 of the largest entry, as
  ``test_torch_lep2d.py`` holds its modes.
* LEP's gradients at 2 x 2 on an R1 MoE layer with a shared expert whose
  weights are narrow enough (``d_ff`` = LEP_SHARED_FF) that it runs on
  the token split with its weights gathered whole, every weight placed by
  the training specs: the output (1e-5) and the gradients of x and every
  weight (2e-4 of each one's largest) of a seeded cotangent, against
  ``jax.value_and_grad`` through JAX's LEP function on four devices.
* The dry run's sharded steps (``launch/sharded_step.py``'s cases: train,
  prefill and decode) at 2 x 2 against the same steps unsharded and
  against the dry run's records, the train cases without an INT8 payload
  also against the same step in float64; R1's prefill step through
  the §4.3.1 hybrid in both o-proj modes (``REPRO_MLA_HYBRID``, LEP with
  an unquantized payload) against JAX's ``model.prefill`` under the same
  setting on its forced 4-device mesh (1e-5); and the LEP train steps of
  OLMoE and of R1 (a dense layer, then two MoE layers: LEP's output left
  on its token split into the second) against JAX's ``make_train_step``
  with JAX's LEP on that mesh.

In this process: the MLA plain version's ``return_lse`` against a direct
log-sum-exp, an empty row (o = 0, lse = -inf) included, and the kernel's
split-and-merge emulation with empty rows."""
import dataclasses
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke_variant
from repro.models import attention as j_attn
from repro.models import init_params as j_init_params
from repro.models import lm_loss as j_lm_loss
from repro.models import mamba2 as j_mamba
from repro.models import mla as j_mla
from repro.models import moe as j_moe
from repro_torch.kernels.mla_attention.ref import (mla_decode_attention_pieces,
                                                   mla_decode_attention_ref)
from repro_torch.launch import dryrun
from repro_torch.launch import sharded_step as ss
from test_torch_lep import _kill_all, _start

TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4          # of each leaf's largest |gradient|
TIMEOUT_S = 200
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
STEP_TOL = 2e-4          # of each leaf's largest |value|
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
#: the sharded steps of ``launch/sharded_step.py`` at smoke width, each
#: held against the same step unsharded (float32: decode at 1e-5) and its
#: collective bytes against the dry run's record
STEP_CASES = list(ss.CASES)
REAL_STEP_TOL = 1e-5
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
#: the INT8 step against JAX's: XLA's fused division rounds some codes the
#: other way (``test_torch_lep2d.py``), so the loss, the gradient norm and
#: the moments hold at the INT8 tolerance of that file's gradients
INT8_TOL = 0.05

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
        from torch.distributed.tensor.experimental import \
            implicit_replication

        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world)
        torch.set_num_threads(1)
        mesh = make_debug_mesh(*shape)
        plan = json.loads(plan)
        with implicit_replication():     # as the dry run traces a step
            cases(rank, mesh, inp, outp, plan)
        steps = {}
        if plan["real_steps"]:
            steps = real_steps(rank, mesh, inp, plan)
        dist.destroy_process_group()
        if plan["real_steps"] and rank == 0:
            one_rank_and_records(steps, init)
            arrays = steps.pop("arrays")
            np.savez(outp.replace(".npz", "_steps.npz"),
                     rows=np.array(json.dumps(steps)), **arrays)

    def real_steps(rank, mesh, inp, plan):
        """Every case of ``launch/sharded_step.py`` at smoke width through
        ``dryrun.build_step`` on real tensors (the seeded weights placed
        one at a time), counted (collectives, hybrid layers), against the
        same step unsharded on rank 0 (and in float64 where the case
        says); then the OLMoE + LEP train step on JAX's weights and the
        case's batch, with the balance loss weighted as configured, for
        JAX's ``make_train_step``; then R1's prefill through the hybrid
        on JAX's weights and tokens."""
        from repro_torch.core import hybrid_parallel
        from repro_torch.launch import sharded_step as ss

        rows = {}
        for name in ss.CASES:
            _, shape, step, args = ss.case_step(name, mesh, "cpu",
                                                smoke=True)
            calls = dict(hybrid_parallel.CALLS)
            out, counts = ss.run_counted(step, args)
            calls = {k: n - calls[k] for k, n in hybrid_parallel.CALLS.items()}
            got = ss.step_results(shape.kind, out, keep=rank == 0)
            if rank == 0:
                n_micro = ss.row_groups(name, mesh.size(0), mesh.size(1),
                                        smoke=True)
                want = ss.reference(name, "cpu", n_micro=n_micro, smoke=True)
                rows[name] = dict(ss.compare(shape.kind, got, want,
                                             plan["step_tol"]),
                                  counts=counts, hybrid_calls=calls)
                if ss.CASES[name].f64:
                    row = ss.compare(shape.kind, got, want, plan["step_tol"],
                                     truth=ss.truth(name, "cpu", smoke=True,
                                                    n_micro=n_micro))
                    rows[name]["f64_gate"] = {k: row[k] for k in (
                        "ok", "over", "param_f64_excess", "mu_f64_excess",
                        "nu_f64_excess", "f64")}
        f64 = f64_rows(rank, mesh, plan["step_tol"])
        from repro_torch.launch import dryrun
        from repro_torch.train.optimizer import OptConfig

        d = np.load(inp)
        arrays = {}
        for payload, (model_key, arch, fields, case, quantize) in \
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
        return {"rows": rows, "arrays": arrays, **f64}

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

    def cases(rank, mesh, inp, outp, plan):
        train = plan["grads"]
        d = np.load(inp)
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

        if plan["lep"]:
            from repro_torch.convert import moe_from_jax_numpy
            from repro_torch.core.lep import make_lep_moe_fn

            cfg = dataclasses.replace(smoke_variant(get_config(
                "olmoe-1b-7b")), capacity_factor=8.0)
            moe = moe_from_jax_numpy({k[4:]: d[k][None] for k in d.files
                                      if k.startswith("lep:")}, cfg, 0,
                                     "cpu")
            for name in ("w_gate", "w_up", "w_down"):
                setattr(moe, name, torch.nn.Parameter(distribute(
                    getattr(moe, name).detach(), mesh, ("model", None, None)),
                    requires_grad=False))
            moe.router = torch.nn.Parameter(distribute(
                moe.router.detach(), mesh, ()), requires_grad=False)
            kw = dict(plan["lep"], ep_axes=tuple(plan["lep"]["ep_axes"]))
            fn = make_lep_moe_fn(mesh=mesh, **kw)
            o, aux = fn(moe, distribute(t("lep_x"), mesh, ("data", None)),
                        cfg)
            out["lep"], out["lep:dropped"] = o, aux["dropped"]

            from repro_torch.core.lep import pick_lep_plan
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
                out[f"lep_shared:grad:{name}"] = torch.zeros(w.shape) \
                    if g is None else g

        got = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
               for k, v in out.items()}
        if rank == 0:
            np.savez(outp, **{k: v.detach().numpy() for k, v in got.items()})

    if __name__ == "__main__":
        world, shape = int(sys.argv[1]), tuple(json.loads(sys.argv[2]))
        # forked: a spawned rank would import everything again
        mp.start_processes(run, args=(world, shape, *sys.argv[3:]),
                           nprocs=world, start_method="fork")
''')

#: JAX's cases in a process of their own, started with the ranks: LEP over
#: a forced 4-device 2 x 2 mesh on the same weights and tokens as the
#: port's DTensor case, and JAX's ``make_train_step`` for each arch of STEP
#: (jitted on one device) on the weights and batch the ranks take
JAX_EXTRA = textwrap.dedent('''
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, smoke_variant
    from repro.core.lep import make_lep_moe_fn
    from repro.launch.mesh import make_debug_mesh
    from repro.train.loop import make_train_step
    from repro.train.optimizer import OptConfig, init_opt_state
    d = np.load(sys.argv[1])
    kw, steps, opt, shared_ff, lep_steps, hybrid = (
        json.loads(a) for a in sys.argv[2:8])
    out = {}

    def smoke(arch, **fields):
        return dataclasses.replace(smoke_variant(get_config(arch)), **fields)

    def nest(prefix):
        tree = {}
        for key in d.files:
            if key.startswith(prefix):
                *path, leaf = key[len(prefix):].split("/")
                node = tree
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = jnp.asarray(d[key])
        return tree

    def flat(tree, prefix=""):
        r = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                r.update(flat(v, prefix + k + "/"))
            else:
                r[prefix + k] = np.asarray(v)
        return r

    cfg = smoke("olmoe-1b-7b", capacity_factor=8.0)
    mesh = make_debug_mesh(2, 2)
    fn = make_lep_moe_fn(mesh, **dict(kw, ep_axes=tuple(kw["ep_axes"])))
    with mesh:
        o, aux = jax.jit(lambda pp, xx: fn(pp, xx, cfg))(
            nest("lep:"), jnp.asarray(d["lep_x"]))
    out["lep"], out["lep:dropped"] = np.asarray(o), np.asarray(aux["dropped"])
    from repro.core.lep import pick_lep_plan
    cfg = smoke("deepseek-r1", capacity_factor=8.0, d_ff=shared_ff)
    fn = make_lep_moe_fn(mesh, **pick_lep_plan(cfg, mesh))
    cot = jnp.asarray(d["lep_shared_cot"])
    with mesh:
        o = jax.jit(lambda pp, xx: fn(pp, xx, cfg)[0])(
            nest("lep_shared:"), jnp.asarray(d["lep_shared_x"]))
        gp, gx = jax.jit(jax.grad(lambda pp, xx: jnp.sum(
            fn(pp, xx, cfg)[0] * cot), argnums=(0, 1)))(
            nest("lep_shared:"), jnp.asarray(d["lep_shared_x"]))
    out["lep_shared"], out["lep_shared:grad:x"] = np.asarray(o), np.asarray(gx)
    out.update({f"lep_shared:grad:{k}": v for k, v in flat(gp).items()})
    for payload, (model_key, arch, fields, _, quantize) in lep_steps.items():
        cfg = smoke(arch, **fields)
        params = nest(f"{model_key}:p:")
        batch = {k: jnp.asarray(d[f"{model_key}:{k}"])
                 for k in ("tokens", "labels")}
        fn = make_lep_moe_fn(mesh, **pick_lep_plan(cfg, mesh),
                             quantize=quantize)
        with mesh:
            new, state, metrics = jax.jit(make_train_step(
                cfg, OptConfig(**opt), fn))(params, init_opt_state(params),
                                            batch)
        key = f"{model_key}:{payload}"
        out[f"{key}:gnorm"], out[f"{key}:loss"] = (
            np.asarray(metrics[k]) for k in ("grad_norm", "loss"))
        for name, tree in (("param", new), ("mu", state.mu),
                           ("nu", state.nu)):
            out.update({f"{key}:{name}:{k}": v
                        for k, v in flat(tree).items()})
    for case, (arch, fields) in steps.items():
        cfg = smoke(arch, **fields)
        params = nest(f"step:{case}:p:")
        batch = {k: jnp.asarray(d[f"step:{case}:{k}"])
                 for k in ("tokens", "labels")}
        new, state, metrics = jax.jit(make_train_step(
            cfg, OptConfig(**opt)))(params, init_opt_state(params), batch)
        out[f"gnorm:{case}"] = np.asarray(metrics["grad_norm"])
        for name, tree in (("param", new), ("mu", state.mu),
                           ("nu", state.nu)):
            out.update({f"step:{case}:{name}:{k}": v
                        for k, v in flat(tree).items()})
    # R1's prefill through the hybrid, LEP's serving plan unquantized,
    # inside the mesh (where model.prefill's hook enters the hybrid)
    import os
    from repro.core.parallel import mesh_context
    from repro.models import model as jmodel
    cfg = smoke("deepseek-r1", **hybrid["fields"])
    fn = make_lep_moe_fn(mesh, **pick_lep_plan(cfg, mesh, serving=True),
                         quantize=False)
    tokens = jnp.asarray(d["hyb:tokens"])
    for mode in hybrid["modes"]:
        os.environ["REPRO_MLA_HYBRID"] = mode
        with mesh_context(mesh):
            logits, caches = jax.jit(lambda p, t: jmodel.prefill(
                p, cfg, {"tokens": t}, capacity=t.shape[1], moe_fn=fn,
                cache_dtype=jnp.float32))(nest("hyb:p:"), tokens)
        out[f"hybrid:{mode}:logits"] = np.asarray(logits)
        out.update({f"hybrid:{mode}:cache/{k}": v
                    for k, v in flat(caches).items()})
    del os.environ["REPRO_MLA_HYBRID"]
    np.savez(sys.argv[8], **out)
''')


def _smoke(arch, **fields):
    return dataclasses.replace(j_smoke_variant(j_get_config(arch)), **fields)


def _layer(init, cfg, seed):
    """One layer's weights from JAX's initializer, unstacked, as numpy."""
    return {k: np.asarray(v[0]) for k, v in jax.jit(
        lambda key: init(key, cfg, 1, jnp.float32))(
        jax.random.PRNGKey(seed)).items()}


def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def inputs():
    """The seeded numpy inputs and weights of every case."""
    rng = np.random.RandomState(0)
    r1, q4, q1, m2 = (_smoke("deepseek-r1"), _smoke("qwen3-8b"),
                      _smoke("qwen3-8b", num_kv_heads=1),
                      _smoke("mamba2-780m"))
    f = lambda *shape: rng.randn(*shape).astype(np.float32)  # noqa: E731
    d = {f"mla:{k}": v for k, v in _layer(j_mla.init_mla_params, r1,
                                          1).items()}
    d.update({f"gqa4:{k}": v for k, v in _layer(
        j_attn.init_attention_params, q4, 2).items()})
    d.update({f"gqa1:{k}": v for k, v in _layer(
        j_attn.init_attention_params, q1, 3).items()})
    d.update({f"mamba:{k}": v for k, v in _layer(
        j_mamba.init_mamba_params, m2, 4).items()})
    width = r1.kv_lora_rank + r1.qk_rope_head_dim
    d.update(mla_x1=f(B, 1, r1.d_model), mla_xs=f(B, S_PREFILL, r1.d_model),
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
        cfg = _smoke(arch, **fields)
        params = jax.jit(j_init_params, static_argnums=(1,))(
            jax.random.PRNGKey(0), cfg)
        d.update({f"p:{arch}:{k}": v for k, v in _flat(params).items()})
        for k in ("tokens", "labels"):
            d[f"{arch}:{k}"] = rng.randint(0, cfg.vocab_size,
                                           (2, 16)).astype(np.int32)
    for case, (arch, fields, _) in STEP.items():
        cfg = _smoke(arch, **fields)
        params = jax.jit(j_init_params, static_argnums=(1,))(
            jax.random.PRNGKey(1), cfg)
        d.update({f"step:{case}:p:{k}": v for k, v in _flat(params).items()})
        for k in ("tokens", "labels"):
            d[f"step:{case}:{k}"] = rng.randint(0, cfg.vocab_size,
                                                (2, 16)).astype(np.int32)
    olmoe = _smoke("olmoe-1b-7b")
    d.update({f"lep:{k}": np.asarray(v[0]) for k, v in j_moe.init_moe_params(
        jax.random.PRNGKey(5), olmoe, 1, jnp.float32).items()})
    d["lep_x"] = f(LEP_TOKENS, olmoe.d_model)
    r1moe = _smoke("deepseek-r1", d_ff=LEP_SHARED_FF)
    d.update({f"lep_shared:{k}": np.asarray(v[0]) for k, v in
              j_moe.init_moe_params(jax.random.PRNGKey(6), r1moe, 1,
                                    jnp.float32).items()})
    d["lep_shared_x"] = f(LEP_SHARED_TOKENS, r1moe.d_model)
    d["lep_shared_cot"] = f(LEP_SHARED_TOKENS, r1moe.d_model)
    d.update(lin_x=f(B, S_PREFILL, LINEAR_D), lin_wq=f(LINEAR_D, 16),
             lin_wk=f(LINEAR_D, 8), lin_wv=f(LINEAR_D, 8))
    models = {m: (arch, fields, case)
              for m, arch, fields, case, _ in LEP_STEPS.values()}
    for seed, (m, (arch, fields, case)) in enumerate(models.items(), 2):
        cfg = _smoke(arch, **fields)
        params = jax.jit(j_init_params, static_argnums=(1,))(
            jax.random.PRNGKey(seed), cfg)
        d.update({f"{m}:p:{k}": v for k, v in _flat(params).items()})
        # the batch build_step draws for the case (seed 0: its inputs
        # from 1)
        batch = dryrun.step_inputs(ss.case_config(case, smoke=True),
                                   ss.case_shape(case, smoke=True), "cpu",
                                   seed=1)
        d.update({f"{m}:{k}": v.numpy() for k, v in batch.items()})
    hyb = _smoke("deepseek-r1", **HYBRID_FIELDS)
    params = jax.jit(j_init_params, static_argnums=(1,))(
        jax.random.PRNGKey(3), hyb)
    d.update({f"hyb:p:{k}": v for k, v in _flat(params).items()})
    shape = ss.case_shape("prefill-r1", smoke=True)
    d["hyb:tokens"] = rng.randint(0, hyb.vocab_size, (
        shape.global_batch, shape.seq_len)).astype(np.int32)
    return d


@pytest.fixture(scope="module")
def sides(inputs, tmp_path_factory):
    """Both meshes' ranks and JAX_EXTRA, started together under one
    deadline, and the rest of JAX's side computed while they run: (rank
    0's gathered arrays by mesh, JAX's arrays)."""
    import json

    tmp = tmp_path_factory.mktemp("sharded")
    np.savez(tmp / "in.npz", **inputs)
    (tmp / "port_side.py").write_text(PORT_SIDE)
    deadline = time.monotonic() + TIMEOUT_S
    (tmp / "jax_extra.py").write_text(JAX_EXTRA)
    procs = {name: _start(tmp / "port_side.py", [
        str(shape[0] * shape[1]), json.dumps(shape), str(tmp / "in.npz"),
        str(tmp / f"{name}.npz"), f"file://{tmp / f'gloo_{name}'}",
        json.dumps({"grads": TRAIN if name == "1x2" else {},
                    "steps": {case: (arch, fields) for case, (
                        arch, fields, meshes) in STEP.items()
                        if name in meshes},
                    "opt": STEP_OPT, "shared_ff": LEP_SHARED_FF,
                    "lep": LEP_KW if name == "2x2" else None,
                    "linear": LINEAR if name == "2x2" else {},
                    "real_steps": name == "2x2", "step_tol": REAL_STEP_TOL,
                    "lep_steps": LEP_STEPS,
                    "hybrid_fields": HYBRID_FIELDS,
                    "hybrid_modes": HYBRID_MODES})])
        for name, shape in MESHES.items()}
    procs["jax_extra"] = _start(tmp / "jax_extra.py", [
        str(tmp / "in.npz"), json.dumps(LEP_KW),
        json.dumps({case: step[:2] for case, step in STEP.items()}),
        json.dumps(STEP_OPT), json.dumps(LEP_SHARED_FF),
        json.dumps(LEP_STEPS),
        json.dumps({"fields": HYBRID_FIELDS, "modes": HYBRID_MODES}),
        str(tmp / "jax_extra.npz")],
        xla_devices=4)
    try:
        want = _jax_side(inputs)
        for proc in procs.values():
            _, stderr = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert proc.returncode == 0, stderr[-4000:]
    finally:
        _kill_all(list(procs.values()))
    want.update(np.load(tmp / "jax_extra.npz"))
    ports = {name: dict(np.load(tmp / f"{name}.npz")) for name in MESHES}
    steps = dict(np.load(tmp / "2x2_steps.npz"))
    ports["steps"] = json.loads(str(steps.pop("rows")))
    ports["2x2"].update(steps)
    return ports, want


def _jax_side(inputs):
    """JAX's functions on the same arrays (one device: the partition does
    not change the function), each under ``jit`` (eager, op by op, takes
    five times as long)."""
    d = {k: jnp.asarray(v) for k, v in inputs.items()}
    w = lambda prefix: {k[len(prefix):]: v for k, v in d.items()  # noqa
                        if k.startswith(prefix)}
    out = {}
    r1, q4, q1, m2 = (_smoke("deepseek-r1"), _smoke("qwen3-8b"),
                      _smoke("qwen3-8b", num_kv_heads=1),
                      _smoke("mamba2-780m"))
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
        cfg = _smoke(arch, **fields)
        params = jax.jit(j_init_params, static_argnums=(1,))(
            jax.random.PRNGKey(0), cfg)
        batch = {k: d[f"{arch}:{k}"] for k in ("tokens", "labels")}
        loss, g = jax.jit(jax.value_and_grad(
            lambda p, cfg=cfg, batch=batch: j_lm_loss(p, cfg, batch)[0]))(
            params)
        out[f"loss:{arch}"] = loss
        out.update({f"grad:{arch}:{k}": v for k, v in _flat(g).items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _close(got, want, tol=TOL):
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max |err| {err:.3e} of the largest entry"


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


def test_sharded_lep_redundancy_matches_jax(sides):
    """LEP with ``redundancy=2`` over a DTensor batch at 2 x 2, the experts
    placed over ``model`` and permuted to the slots: the output and the
    dropped count against JAX's LEP on four devices."""
    ports, want = sides
    got = ports["2x2"]
    _close(got["lep"], want["lep"])
    assert int(got["lep:dropped"]) == int(want["lep:dropped"])


def test_sharded_lep_shared_expert_gradients_match_jax(sides):
    """LEP at 2 x 2 on an R1 MoE layer whose shared expert runs on the
    token split: the output and the gradients of x and of every weight
    (the router, the routed and the shared experts) against JAX's LEP
    under ``jax.grad``."""
    ports, want = sides
    got = ports["2x2"]
    keys = sorted(k for k in want if k.startswith("lep_shared"))
    assert keys == sorted(k for k in got if k.startswith("lep_shared"))
    assert "lep_shared:grad:shared_gate" in keys
    _close(got["lep_shared"], want["lep_shared"])
    for k in keys:
        if ":grad:" in k:
            _close(got[k], want[k], GRAD_TOL)


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


@pytest.mark.parametrize("case", STEP_CASES)
def test_sharded_step_matches_unsharded(sides, case):
    """``dryrun.build_step`` on real tensors at 2 x 2 (every weight drawn
    from the seed and placed one at a time, caches and batch placed by
    the specs) against the same step on plain tensors, the MoE layers
    through the 1-D LEP at world size 1: a train step's loss and global
    gradient norm within 1e-5, each parameter and both moments within 2e-4
    of the leaf's largest; a decode step's logits and caches within 1e-5
    of the largest, greedy tokens equal where the top-2 margin is clear;
    a prefill's logits and caches likewise (``sharded_step.compare``)."""
    ports, _ = sides
    row = ports["steps"]["rows"][case]
    assert row["ok"], row
    if ss.CASES[case].kind != "train":
        assert row["greedy_checked"] > 0, row


@pytest.mark.parametrize("case", [c for c in STEP_CASES if ss.CASES[c].f64])
def test_train_steps_hold_against_float64(sides, case):
    """The train cases without an INT8 payload at 2 x 2 against the same
    step in float64 (``sharded_step.truth``: the float32 step's weights
    and batch widened, on the CPU): each parameter and both moments no
    further from it than the unsharded float32 step plus STEP_TOL of the
    leaf's largest value, the loss and gradient norm within 1e-5 of the
    unsharded step's."""
    ports, _ = sides
    row = ports["steps"]["rows"][case]["f64_gate"]
    assert row["ok"], row
    assert set(row["f64"]["sharded_max_err"]) == {"param", "mu", "nu"}


@pytest.mark.parametrize("case", STEP_CASES)
def test_sharded_step_float64_exact(sides, case):
    """Each case's step in float64 at 2 x 2 (``case_step(dtype=float64)``:
    the case's weights drawn as its own step draws them, then widened, as
    each is placed; caches and moments float64) against the same step
    unsharded in float64 over the data ranks' row groups, every gated
    quantity within ``F64_TOL`` = 1e-9 of its largest value: a train
    step's loss and gradient norm, every parameter and both moments; a
    prefill's or decode step's logits on every row (a decode row whose
    cache spans two sequence blocks included), every cache leaf and the
    rows it wrote, and its greedy tokens equal on every row."""
    ports, _ = sides
    row = ports["steps"]["f64"][case]
    assert row["ok"] and not row["over"], row
    assert row["worst_err"] <= ss.F64_TOL, row
    if ss.CASES[case].kind != "train":
        assert len(row["greedy_equal_by_row"]) == row["n_rows"], row
        assert len(row["logits_err_by_row"]) == row["n_rows"], row


#: what a float64 step may compute narrower than float64, by the port's
#: file and function, with the reason: the INT8 payload's per-row scale
#: is float32 bits in its tail (``src/repro/core/lep.py:176-178``)
F64_NARROW = {
    ("repro_torch/kernels/dispatch_quant/ref.py", "dispatch_quantize_ref"):
        "the row's scale rounded once to the payload's float32, its bytes "
        "packed into the tail",
    ("repro_torch/core/lep.py", "_unpack"):
        "the float32 scale read back from the payload's tail"}


def test_float64_steps_compute_in_float64(sides):
    """The eleven float64 steps, sharded (every rank) and unsharded, under
    ``sharded_step.NarrowOps``: no op gives a floating output narrower
    than float64 but those of ``F64_NARROW`` (float32, the INT8 payload's
    scale), which the cases with INT8 dispatch do run."""
    ports, _ = sides
    ops = ports["steps"]["f64_audit"]
    sites = {}
    for key in ops:
        where, func, _, dtype = key.split(" ")
        assert dtype == "float32", key
        sites[(where.rsplit(":", 1)[0], func)] = key
    assert set(sites) == set(F64_NARROW), sorted(ops)


@pytest.mark.parametrize("how", ["perturb", "demote"])
def test_float64_gate_sees_what_the_fixed_gate_cannot(sides, how):
    """train-mamba2 in float64 at 2 x 2 with ``dtensor.rms_norm`` broken
    (rank 0's partial sum of squares off by one part in 1e7, or the body
    computed in float32 again) fails ``F64_TOL`` against the float64
    unsharded step while it passes the fixed gate of ``compare``
    (STEP_TOL, LOSS_RTOL); the demoted body is in the step's
    ``NarrowOps`` record."""
    ports, _ = sides
    row = ports["steps"]["f64_broken"][how]
    assert not row["f64"]["ok"], row["f64"]
    assert ss.F64_TOL < row["f64"]["worst_err"] < ss.STEP_TOL, row["f64"]
    assert row["fixed"]["ok"], row["fixed"]
    in_norm = [k for k in row["audit"]
               if k.startswith("repro_torch/dtensor.py:")]
    assert bool(in_norm) == (how == "demote"), row["audit"]


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


@pytest.mark.parametrize("mode", HYBRID_MODES)
def test_sharded_hybrid_prefill_matches_jax(sides, mode):
    """R1's prefill step at smoke width (4 MLA layers, the last through
    LEP's serving plan with an unquantized payload) at 2 x 2 with every
    MLA layer through the §4.3.1 hybrid (``build_step(hybrid=mode)``),
    on JAX's weights and tokens, against JAX's ``model.prefill`` under
    ``REPRO_MLA_HYBRID`` = ``mode`` inside its forced 4-device mesh: the
    logits and every latent cache within 1e-5 of their largest."""
    ports, want = sides
    got = ports["2x2"]
    key = f"hybrid:{mode}:"
    _close(got[key + "logits"], want[key + "logits"])
    caches = sorted(k for k in got if k.startswith(key + "cache/"))
    assert caches and all(k.endswith("/mla") for k in caches), caches
    for k in caches:
        _close(got[k], want[k])


def test_hybrid_prefill_step_enters_the_hybrid(sides):
    """The hybrid prefill cases run ``mla_prefill_hybrid`` on each of the
    4 MLA layers of R1's cut with their o-proj mode, the plain one on
    none; a block that sets the mode but never enters the hybrid raises
    (``dryrun.hybrid_prefill``): a prefill that took the plain path is not
    taken for the hybrid's."""
    ports, _ = sides
    rows = ports["steps"]["rows"]
    assert rows["prefill-r1-a2a"]["hybrid_calls"] == {"a2a": 4, "rs": 0}
    assert rows["prefill-r1-rs"]["hybrid_calls"] == {"a2a": 0, "rs": 4}
    assert rows["prefill-r1"]["hybrid_calls"] == {"a2a": 0, "rs": 0}
    with pytest.raises(AssertionError, match="ran on 0 MLA layers, not 4"):
        with dryrun.hybrid_prefill("a2a", None, 4):
            pass


@pytest.mark.parametrize("case", STEP_CASES)
def test_sharded_step_collectives_equal_record(sides, case):
    """The collective bytes by kind (and their count) that
    ``CollectiveCounter`` sees on rank 0 of the executed 2 x 2 step equal
    the dry run's record of the same case on a fake 2 x 2 group
    (``dryrun._measure``), byte for byte."""
    ports, _ = sides
    counts = ports["steps"]["rows"][case]["counts"]
    assert counts == ports["steps"]["records"][case]
    assert counts["count"] > 0


def test_sharded_step_one_rank_counts_nothing(sides):
    """``decode-r1`` over a 1 x 1 mesh of one gloo rank: equal to the
    unsharded step, no collective counted, as the 1 x 1 record reads."""
    ports, _ = sides
    row = ports["steps"]["one_rank"]
    assert row["ok"], row
    assert not any(row["counts"].values())
    assert row["counts"] == ports["steps"]["one_rank_record"]


@pytest.mark.parametrize("payload", list(LEP_STEPS))
def test_sharded_olmoe_lep_train_step_matches_jax(sides, payload):
    """The OLMoE + LEP train step at 2 x 2 through ``build_step`` (JAX's
    weights, the training LEP plan, the balance loss at its configured
    weight) against JAX's ``make_train_step`` with JAX's LEP on a forced
    4-device 2 x 2 mesh, as ``test_multidevice.py`` runs it; and R1's
    (``r1-f32``: a dense layer, then two MoE layers, the output of the
    first left on LEP's token split into the second). Unquantized:
    the loss and the global gradient norm within 1e-5, every parameter
    within 2e-4 of the leaf's largest where the first moment is clear of
    0, both moments within 2e-4. INT8: the loss and gradient norm within
    INT8_TOL relative, the moments within INT8_TOL of each leaf's largest,
    the parameters (moved by about lr x sign(g)) within 2e-4 where the
    first moment is clear of INT8_TOL of its largest."""
    ports, want = sides
    got = ports["2x2"]
    model_key, *_, quantize = LEP_STEPS[payload]
    key = f"{model_key}:{payload}"
    tol, rtol = (INT8_TOL, INT8_TOL) if quantize else (STEP_TOL, LOSS_RTOL)
    for k in ("loss", "gnorm"):
        np.testing.assert_allclose(got[f"{key}:{k}"], want[f"{key}:{k}"],
                                   rtol=rtol)
    parts = tuple(f"{key}:{p}:" for p in ("param", "mu", "nu"))
    keys = sorted(k for k in want if k.startswith(parts))
    assert keys and keys == sorted(k for k in got if k.startswith(parts))
    for k in keys:
        if ":param:" not in k:
            _close(got[k], want[k], tol)
            continue
        mu = want[k.replace(":param:", ":mu:")]
        clear = np.abs(mu) > tol * max(float(np.abs(mu).max()), 1e-30)
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k])[clear].max(initial=0.0))
        assert err <= STEP_TOL * scale, (k, err, scale)


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
