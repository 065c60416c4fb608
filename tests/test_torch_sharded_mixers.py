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
  Qwen3 and Mamba2, against JAX's ``train.make_train_step`` on the same
  weights and batch: every parameter and both moments within 2e-4 of the
  leaf's largest, with no warmup (so the step moves every weight by more
  than that), and the global gradient norm within 1e-5.
* LEP over a DTensor batch at 2 x 2 with ``redundancy=2`` on full-mesh EP,
  the experts placed over ``model`` (each rank receives the experts its
  slots lack: a permute), against JAX's LEP function on a forced 4-device
  mesh (a subprocess of its own): within 1e-5 of the largest entry, as
  ``test_torch_lep2d.py`` holds its modes.

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
#: (arch, replaced fields) taken one whole train step at 1 x 2 and 2 x 2
STEP = {"deepseek-r1": {"num_experts": 0}, "qwen3-8b": {},
        "mamba2-780m": {}}
STEP_TOL = 2e-4          # of each leaf's largest |value|
#: the optimizer of that step: no warmup, so the first step moves each
#: weight by about lr = 3e-4, above STEP_TOL of a leaf's largest value
STEP_OPT = {"warmup_steps": 1}
LEP_TOKENS = 24          # 6 rows a rank on 2 x 2
LEP_KW = {"ep_axes": ["data", "model"], "redundancy": 2}

PORT_SIDE = textwrap.dedent('''
    import dataclasses, json, sys
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
        with implicit_replication():     # as the dry run traces a step
            cases(rank, mesh, inp, outp, json.loads(plan))
        dist.destroy_process_group()

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

        for arch, fields in plan["steps"].items():
            cfg, tree, model, batch = sharded(d, f"step:{arch}", arch,
                                              fields, mesh)
            leaves = list(model.parameters())
            opt = OptState(distribute(torch.zeros((), dtype=torch.int32),
                                      mesh, ()),
                           *([torch.zeros_like(w, dtype=torch.float32)
                              for w in leaves] for _ in range(2)))
            model, opt, metrics = make_train_step(
                cfg, OptConfig(**plan["opt"]))(model, opt, batch)
            out[f"gnorm:{arch}"] = metrics["grad_norm"]
            for name, values in (("param", model.parameters()),
                                 ("mu", opt.mu), ("nu", opt.nu)):
                out.update(as_tree(list(values), cfg, tree,
                                   f"step:{arch}:{name}"))

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
    kw, steps, opt = (json.loads(a) for a in sys.argv[2:5])
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
    for arch, fields in steps.items():
        cfg = smoke(arch, **fields)
        params = nest(f"step:{arch}:p:")
        batch = {k: jnp.asarray(d[f"step:{arch}:{k}"])
                 for k in ("tokens", "labels")}
        new, state, metrics = jax.jit(make_train_step(
            cfg, OptConfig(**opt)))(params, init_opt_state(params), batch)
        out[f"gnorm:{arch}"] = np.asarray(metrics["grad_norm"])
        for name, tree in (("param", new), ("mu", state.mu),
                           ("nu", state.nu)):
            out.update({f"step:{arch}:{name}:{k}": v
                        for k, v in flat(tree).items()})
    np.savez(sys.argv[5], **out)
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
    for arch, fields in STEP.items():
        cfg = _smoke(arch, **fields)
        params = jax.jit(j_init_params, static_argnums=(1,))(
            jax.random.PRNGKey(1), cfg)
        d.update({f"step:{arch}:p:{k}": v for k, v in _flat(params).items()})
        for k in ("tokens", "labels"):
            d[f"step:{arch}:{k}"] = rng.randint(0, cfg.vocab_size,
                                                (2, 16)).astype(np.int32)
    olmoe = _smoke("olmoe-1b-7b")
    d.update({f"lep:{k}": np.asarray(v[0]) for k, v in j_moe.init_moe_params(
        jax.random.PRNGKey(5), olmoe, 1, jnp.float32).items()})
    d["lep_x"] = f(LEP_TOKENS, olmoe.d_model)
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
        json.dumps({"grads": TRAIN if name == "1x2" else {}, "steps": STEP,
                    "opt": STEP_OPT,
                    "lep": LEP_KW if name == "2x2" else None})])
        for name, shape in MESHES.items()}
    procs["jax_extra"] = _start(tmp / "jax_extra.py", [
        str(tmp / "in.npz"), json.dumps(LEP_KW), json.dumps(STEP),
        json.dumps(STEP_OPT), str(tmp / "jax_extra.npz")], xla_devices=4)
    try:
        want = _jax_side(inputs)
        for proc in procs.values():
            _, stderr = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert proc.returncode == 0, stderr[-4000:]
    finally:
        _kill_all(list(procs.values()))
    want.update(np.load(tmp / "jax_extra.npz"))
    return {name: dict(np.load(tmp / f"{name}.npz")) for name in MESHES}, want


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


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(STEP))
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
