"""The port's dry run (``launch/dryrun.py``, ``launch/variants.py``,
``launch/collectives.py``) against the JAX package's, on the CPU.

JAX's ``dryrun.py`` and ``variants.py`` set ``XLA_FLAGS`` to 512 host
devices when imported, and the port's fake process group is global state,
so each side runs in subprocesses of its own (JAX's in two, its train
pairs apart), all started together under one deadline:

* the pure functions (``skip_reason``, ``analytic_flops``,
  ``train_memory_bytes``, ``model_flops``, ``input_specs``' shapes and
  dtypes) for all eleven configs x the four ``INPUT_SHAPES``, the INT8
  weight tree and its specs, and each variant's LEP keywords: equal;
* on a fake 2 x 4 group against JAX's ``build_step`` jitted with
  ``to_shardings`` on 8 host devices, at smoke width: rank 0's argument
  bytes equal to JAX's ``memory_analysis().argument_size_in_bytes``, and
  the LEP's all-to-all bytes equal to the all-to-all bytes of JAX's HLO
  (JAX's ``collective_bytes`` with the HLO's ``/*index=N*/`` comments
  taken out: its pattern skips a tuple-shaped collective whose type
  carries one, which is how LEP's all-to-alls of eight ranks print); the
  other kinds are printed beside JAX's;
* every pair's collective bytes at most NEAR_JAX times JAX's (index
  comments taken out), the decode pairs with expert redundancy within
  REDUNDANT_FACTOR, their experts moved by a permute (no all-gather as
  large as one expert's three matrices);
* ``adamw_update`` over DTensor gradients placed as their parameters
  issues no collective but the global norm's scalar all-reduces, at most
  one per mesh dimension;
* ``scripts/torch_dryrun_sites.py``'s sites sum to the counter's totals;
* by op, on smoke train pairs (Qwen3 with 2 K/V heads, which the model
  axis of 4 does not divide; R1; Mamba2): projections that read one input
  (GQA's q/k/v, SwiGLU's gate/up, MLA's ``wq_a``/``wkv_a`` and
  ``wk_b``/``wv_b``) reduce its gradient once in the backward, one
  all-reduce a layer where the columns are cut; a Mamba2 step issues no
  all-to-all and its norms no collective of DTensor's; Qwen3's K/V
  gather each rank's head, fewer bytes than the whole k and v that the
  step gathered when a cache took them (``fit_heads``);
* the collective counter sees a ``core/parallel.py`` all-to-all as well as
  a DTensor redistribution, with each op's output bytes, and counts each
  batch of point-to-point transfers as one permute;
* variants on the fake 2 x 4 group (INT8 weights, a scalar length, two
  microbatches, the hybrid prefill through ``local_map``, block skipping);
* one ``run_one`` per family on a fake 16 x 16 group returns ``ok`` (a
  MoE smoke variant with 16 experts, which divide over the model axis as
  the specs require).

In this process: the kernel wrappers' rule (a meta tensor takes the plain
version and keeps its shape; any other device but the CPU and CUDA
raises)."""
import json
import textwrap
import time

import pytest
import torch

from repro_torch.configs import INPUT_SHAPES, get_config, list_configs
from repro_torch.configs import smoke_variant
from repro_torch.kernels.dispatch_quant import dispatch_quantize
from repro_torch.kernels.int8_gemm import int8_matmul
from repro_torch.kernels.mla_attention import mla_decode_attention
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.launch import dryrun, roofline, variants
from repro_torch.launch.mesh import PRODUCTION_SHAPE
from repro_torch.launch.sharding import param_pspecs, param_shapes
from test_torch_lep import _kill_all, _start

CONFIGS = list_configs()
SHAPES = list(INPUT_SHAPES)
MOE_ARCHS = ("olmoe-1b-7b", "kimi-k2-1t-a32b", "deepseek-r1")
#: (arch, kind, batch, seq) on the fake 2 x 4 group, at smoke width
PAIRS = [("qwen3-8b", "decode", 8, 64), ("olmoe-1b-7b", "decode", 8, 64),
         ("deepseek-r1", "decode", 8, 64), ("mamba2-780m", "decode", 8, 64),
         ("qwen3-8b", "train", 8, 64), ("deepseek-r1", "train", 8, 64),
         ("olmoe-1b-7b", "train", 8, 64), ("mamba2-780m", "train", 8, 64)]
#: JAX compiles the last three train pairs in a process of its own, started
#: with the others: they take about as long as all else on JAX's side
JAX_PAIR_PARTS = (PAIRS[:5], PAIRS[5:])
#: every pair's collective bytes a rank at most this factor of JAX's (both
#: partition the same step; the port's collectives are its own where the
#: projections, the optimizer and LEP's redundancy issue them, DTensor's
#: elsewhere); before they were held to it they read 2.2-7.5x
NEAR_JAX = 2.0
#: the decode pairs with expert redundancy (4 experts x 2 over 8 ranks): the
#: experts move as a permute, each rank receiving its slot's expert, as XLA
#: partitions JAX's ``jnp.repeat``: total and permute bytes within this
#: factor of JAX's (the permute either way)
REDUNDANT = ("olmoe-1b-7b/decode", "deepseek-r1/decode")
REDUNDANT_FACTOR = 1.25
#: decode pairs (arch, batch, seq, replaced fields) of the attention's
#: collectives on the fake 2 x 4 group: R1 with 8 experts, one a rank (no
#: redundancy, so no expert gather of DTensor's stands beside the
#: attention's), Qwen3 without its window; 256 positions, so that a rank's
#: (B, H, S) scores are 4x its query heads (head_dim 64 and 48)
SCORE_PAIRS = [("deepseek-r1", 8, 256, {"num_experts": 8}),
               ("qwen3-8b", 8, 256, {"sliding_window": 0})]
#: the port's all-gather + all-reduce bytes within this factor of JAX's
#: (either way): both partition the same program, the port's attention
#: through local_map, but the two place the projections' reductions
#: differently (DTensor reduces a query's pending sum where XLA gathers
#: it), so the bytes are held to a factor, not equal (R1 0.87x, Qwen3
#: 0.81x); where DTensor partitioned the attention itself, R1's read 2.5x
#: JAX's, its largest all-gather a rank's scores
SCORE_FACTOR = 2.0
#: pairs whose HLO has no all-to-all but LEP's
LEP_PAIRS = ("olmoe-1b-7b/decode", "deepseek-r1/decode")
#: one arch per family, run_one at smoke width on a fake 16 x 16 group
FAMILIES = ("qwen3-8b", "olmoe-1b-7b", "deepseek-r1", "mamba2-780m",
            "zamba2-1.2b")
#: variants traced on the fake 2 x 4 group at R1's smoke width, each
#: through another path (INT8 weights, a scalar length, two microbatches,
#: the hybrid prefill's two forms through local_map, block skipping)
VARIANT_CASES = [("baseline", "decode"), ("int8_weights", "decode"),
                 ("aligned_decode", "decode"), ("microbatch2", "decode"),
                 ("baseline", "prefill"), ("hybrid_a2a", "prefill"),
                 ("hybrid_rs", "prefill"), ("block_skip", "prefill")]
TIMEOUT_S = 240
#: smoke train pairs traced op by op on the fake 2 x 4 group (rows of x a
#: rank: BATCH x SEQ over data's 2 ranks), by name: (arch, replaced fields)
OP_PAIRS = {"qwen3-kv2": ("qwen3-8b", {"num_kv_heads": 2}),
            "r1": ("deepseek-r1", {}), "mamba2": ("mamba2-780m", {}),
            "r1-3": ("deepseek-r1", {"num_layers": 3})}
OP_ROWS = 8 * 64 // 2
#: (pair, file, the projection's call, the input's width, the all-reduces
#: of its gradient in the backward: one a layer whose columns the model
#: axis cuts). Qwen3: both layers, attention and MLP; R1 (one dense layer
#: then one MoE layer, whose attention the specs replicate): q/k/v once
#: (wkv_a's columns are whole; its weight's gradient is summed over data,
#: not its input's), wk_b/wv_b once, SwiGLU once (the dense MLP: the MoE
#: layer's rows come on LEP's token split, where its shared expert runs
#: with its weights gathered whole).
SHARED_INPUTS = [
    ("qwen3-kv2", "models/attention.py", "dt.linear(x, (p.wq, p.wk, p.wv)",
     256, 2),
    ("qwen3-kv2", "models/layers.py", "dt.linear(x, (w_gate, w_up))", 256,
     2),
    ("r1", "models/mla.py", "dt.linear(x, (p.wq_a, p.wkv_a))", 256, 1),
    ("r1", "models/mla.py", "dt.linear(c_kv, (p.wk_b, p.wv_b))", 32, 1),
    ("r1", "models/layers.py", "dt.linear(x, (w_gate, w_up))", 256, 1)]
#: R1's smoke serve steps traced site by site on the fake 2 x 4 group
SERVE_KINDS = ("decode", "prefill")

JAX_SIDE = textwrap.dedent('''
    import json, os, re, sys
    from repro.launch import dryrun as D      # sets XLA_FLAGS first
    from repro.launch import variants as V
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs import INPUT_SHAPES, get_config
    from repro.configs import smoke_variant
    from repro.configs.base import InputShape
    from repro.core.parallel import set_current_mesh
    from repro.launch import hlo_analysis as hlo
    from repro.launch.mesh import make_production_mesh
    from repro.launch.sharding import param_pspecs, to_shardings
    from repro.models import init_params

    pairs, moe_archs, variants, score_pairs, configs = (
        json.loads(a) for a in sys.argv[1:6])
    out = {"pure": {}, "quant": {}, "lep": {}, "pairs": {}, "scores": {}}

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            r = {}
            for k, v in tree.items():
                r.update(flat(v, f"{prefix}/{k}"))
            return r
        return {prefix: tree}

    for name in configs:
        cfg = get_config(name)
        for sname, shape in INPUT_SHAPES.items():
            specs = D.input_specs(cfg, shape)
            out["pure"][f"{name}/{sname}"] = {
                "skip": D.skip_reason(cfg, shape),
                "flops": D.analytic_flops(cfg, shape),
                "train_mem": D.train_memory_bytes(cfg, shape, 12345.0, 256),
                "model_flops": hlo.model_flops(cfg, 1000, shape.kind),
                "inputs": {k: [list(v.shape), str(v.dtype)]
                           for k, v in specs.items()}}

    prod = make_production_mesh()
    shapes, real_eval_shape = {}, jax.eval_shape
    for name in configs:
        cfg = get_config(name)
        shapes[name] = jax.eval_shape(
            lambda k, cfg=cfg: init_params(k, cfg), jax.random.PRNGKey(0))
        p_spec = param_pspecs(cfg, prod, shapes[name])
        q = V.quantized_param_shapes(shapes[name])
        qs = V.quantized_param_specs(p_spec, shapes[name])
        out["quant"][name] = {
            k: [list(v.shape), str(v.dtype), [None if e is None else e
                                             for e in flat(qs)[k]]]
            for k, v in flat(q).items()}

    got = {}

    def capture(mesh, ep_axes, **kw):
        got.update(kw, ep_axes=list(ep_axes))

    V.make_lep_moe_fn = capture
    def cached(fn, *args):    # init_params by config; else the real one
        cfg = getattr(fn, "keywords", {}).get("cfg")
        return shapes[cfg.name] if cfg else real_eval_shape(fn, *args)

    V.jax.eval_shape = cached
    for name in moe_archs:
        for v in variants:
            got.clear()
            V.build_variant(get_config(name), INPUT_SHAPES["decode_32k"],
                            prod, v)
            out["lep"][f"{name}/{v}"] = dict(got)
    V.jax.eval_shape = real_eval_shape
    os.environ.pop("REPRO_BLOCK_SKIP", None)     # set by two variants
    os.environ.pop("REPRO_MLA_HYBRID", None)

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    set_current_mesh(mesh)
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "jax_reference", Path(D.__file__).parents[3] / "scripts"
        / "torch_dryrun_jax_reference.py")
    reference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reference)
    for arch, kind, b, s in pairs:
        cfg = smoke_variant(get_config(arch))
        with mesh:
            step, args, spec = D.build_step(cfg, InputShape("p", s, b, kind),
                                            mesh)
            c = jax.jit(step, in_shardings=to_shardings(mesh, spec)).lower(
                *args).compile()
        text = c.as_text()
        out["pairs"][f"{arch}/{kind}"] = {
            "argument_bytes": int(c.memory_analysis().argument_size_in_bytes),
            "collectives": hlo.collective_bytes(text),
            "collectives_untupled": hlo.collective_bytes(
                re.sub(r"/\\*index=\\d+\\*/", "", text))}
        if (arch, kind) == ("deepseek-r1", "train"):
            out["r1_train_sites"] = reference.sites_of(text)
    import dataclasses
    for arch, b, s, fields in score_pairs:
        cfg = dataclasses.replace(smoke_variant(get_config(arch)), **fields)
        with mesh:
            step, args, spec = D.build_step(
                cfg, InputShape("p", s, b, "decode"), mesh)
            c = jax.jit(step, in_shardings=to_shardings(mesh, spec)).lower(
                *args).compile()
        out["scores"][arch] = {
            "argument_bytes": int(c.memory_analysis().argument_size_in_bytes),
            "collectives": hlo.collective_bytes(
                re.sub(r"/\\*index=\\d+\\*/", "", c.as_text()))}
    print(json.dumps(out))
''')

PORT_SIDE = textwrap.dedent('''
    import dataclasses, json, os, sys
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.configs.base import InputShape
    from repro_torch.core import parallel as par
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.collectives import CollectiveCounter
    from repro_torch.launch.sharding import meta_dtensor

    pairs, families, VARIANT_CASES, score_pairs, OP_PAIRS = (
        json.loads(a) for a in sys.argv[1:6])
    out = {"pairs": {}, "run_one": {}, "scores": {}}
    mesh = D.fake_mesh({"data": 2, "model": 4})
    for arch, kind, b, s in pairs:
        cfg = smoke_variant(get_config(arch))
        r = D._measure(cfg, InputShape("p", s, b, kind), mesh)
        out["pairs"][f"{arch}/{kind}"] = {
            "argument_bytes": r["argument_bytes"], "collectives": r["coll"],
            "largest": r["coll_largest"],
            "expert_bytes": 3 * cfg.d_model * cfg.d_ff * 4}

    from repro_torch.train.optimizer import OptConfig, OptState, adamw_update
    params = D.sharded_model(smoke_variant(get_config("qwen3-8b")), mesh,
                             train=True)
    leaves = list(params.parameters())
    zeros = lambda: [torch.zeros_like(p, dtype=torch.float32)  # noqa
                     for p in leaves]
    opt = OptState(meta_dtensor((), torch.int32, mesh, ()), zeros(), zeros())
    with CollectiveCounter() as c:
        adamw_update(OptConfig(), params, zeros(), opt)
    out["adamw"] = [c.counts, c.largest, mesh.ndim]

    import importlib.util
    import repro_torch
    from pathlib import Path
    path = Path(repro_torch.__file__).parents[2] / "scripts" / \
        "torch_dryrun_sites.py"
    spec = importlib.util.spec_from_file_location("sites", path)
    sites_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sites_mod)
    sites, totals = sites_mod.measure_sites(
        smoke_variant(get_config("qwen3-8b")),
        InputShape("p", sites_mod.SEQ, sites_mod.BATCH, "decode"), mesh)
    out["sites"] = [sites, totals]
    out["ops"] = {}
    train = InputShape("p", sites_mod.SEQ, sites_mod.BATCH, "train")
    for name, (arch, fields) in OP_PAIRS.items():
        ops = []
        cfg = dataclasses.replace(smoke_variant(get_config(arch)), **fields)
        sites_mod.measure_sites(cfg, train, mesh, ops)
        out["ops"][name] = ops
    # The K/V taken whole (``fit_heads``), as a cache takes them.
    from repro_torch.models import attention as A
    real = A._project_qkv
    A._project_qkv = lambda p, x, cfg, pos, kv_out=True: real(
        p, x, cfg, pos)
    try:
        ops = []
        arch, fields = OP_PAIRS["qwen3-kv2"]
        sites_mod.measure_sites(dataclasses.replace(
            smoke_variant(get_config(arch)), **fields), train, mesh, ops)
        out["ops"]["qwen3-kv2 whole"] = ops
    finally:
        A._project_qkv = real
    for arch, b, s, fields in score_pairs:
        cfg = dataclasses.replace(smoke_variant(get_config(arch)), **fields)
        r = D._measure(cfg, InputShape("p", s, b, "decode"), mesh)
        out["scores"][arch] = {
            "argument_bytes": r["argument_bytes"], "collectives": r["coll"],
            "largest": r["coll_largest"],
            "scores_bytes": b // 2 * cfg.num_heads * s * 4}

    x = torch.empty(8, 16, device="meta")
    y = meta_dtensor((8, 16), torch.float32, mesh, ("model", None))
    with CollectiveCounter() as direct:
        par.all_to_all(x, par.axes_group(mesh, ("model",)))
    with CollectiveCounter() as redist:
        y.redistribute(mesh, (Replicate(), Shard(1)))
        y.redistribute(mesh, (Replicate(), Replicate()))
    out["direct"], out["redistribute"] = direct.counts, redist.counts
    # A gradient pending over both axes (a norm gain's, its rows cut over
    # data and model) placed as its replicated parameter.
    from torch.distributed.tensor import DTensor, Partial
    from repro_torch import dtensor as dt
    gain = meta_dtensor((256,), torch.float32, mesh, ())
    pending = DTensor.from_local(gain.to_local(), mesh,
                                 (Partial(), Partial()), run_check=False)
    with CollectiveCounter() as merged:
        dt.placed_like(pending, gain)
    with CollectiveCounter() as merged_fwd:
        dt.reduce_partial(pending)
    with CollectiveCounter() as apart:
        pending.redistribute(mesh, gain.placements)
    out["pending"] = [merged.counts, merged_fwd.counts, apart.counts]
    r1 = smoke_variant(get_config("deepseek-r1"))
    out["r1_serve"] = {}
    for kind in ("decode", "prefill"):
        ops = []
        sites_mod.measure_sites(r1, InputShape("p", 64, 8, kind), mesh, ops)
        out["r1_serve"][kind] = ops
    with CollectiveCounter() as permute:
        par.send_recv([(x, 1)], [(x[:2].clone(), 2)])
        par.send_recv([(x[:2], 1)], [(x.clone(), 3)])
    out["permute"] = permute.counts

    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import variants as V
    out["variants"] = {}
    r1 = smoke_variant(get_config("deepseek-r1"))
    for name, kind in VARIANT_CASES:
        with par.mesh_context(mesh), V._env(name):
            step, args = V.build_variant(r1, InputShape("p", 64, 8, kind),
                                         mesh, name)
            counter = D.StepCounter(args)
            with counter, implicit_replication():
                step(*args)
        out["variants"][f"{name}/{kind}"] = [
            sum(counter.used.values()), counter.counts["count"],
            [k for k in ("REPRO_BLOCK_SKIP", "REPRO_MLA_HYBRID")
             if k in os.environ]]

    mesh16 = D.fake_mesh({"data": 16, "model": 16})
    for arch in families:
        cfg = smoke_variant(get_config(arch))
        if cfg.is_moe:     # experts that divide over the model axis
            cfg = dataclasses.replace(cfg, num_experts=16)
        rec = D.run_one(arch, "decode_32k", save=False, verbose=False,
                        cfg=cfg, mesh=mesh16)
        out["run_one"][arch] = [rec["status"], rec.get("error"),
                                rec.get("mesh"), rec.get("n_devices")]
    print(json.dumps(out))
''')


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """The subprocesses (JAX's side in two, JAX_PAIR_PARTS, and the
    port's), started together; their JSON results, JAX's merged."""
    tmp = tmp_path_factory.mktemp("dryrun")
    (tmp / "jax_side.py").write_text(JAX_SIDE)
    (tmp / "port_side.py").write_text(PORT_SIDE)
    deadline = time.monotonic() + TIMEOUT_S
    first, rest = JAX_PAIR_PARTS
    procs = [_start(tmp / "jax_side.py",
                    [json.dumps(first), json.dumps(MOE_ARCHS),
                     json.dumps(variants.VARIANTS), json.dumps(SCORE_PAIRS),
                     json.dumps(CONFIGS)]),
             _start(tmp / "jax_side.py",
                    [json.dumps(rest)] + [json.dumps([])] * 4),
             _start(tmp / "port_side.py",
                    [json.dumps(PAIRS), json.dumps(FAMILIES),
                     json.dumps(VARIANT_CASES), json.dumps(SCORE_PAIRS),
                     json.dumps(OP_PAIRS)])]
    results = []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert proc.returncode == 0, stderr[-3000:]
            results.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        _kill_all(procs)
    results[0]["pairs"].update(results[1]["pairs"])
    results[0]["r1_train_sites"] = results[1]["r1_train_sites"]
    return {"jax": results[0], "port": results[2]}


@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("name", CONFIGS)
def test_pure_functions_equal_jax(sides, name, shape_name):
    """Exact: the skip, the analytic FLOPs, the train memory model, the
    model FLOPs and the input stand-ins' shapes and dtypes."""
    want = sides["jax"]["pure"][f"{name}/{shape_name}"]
    cfg, shape = get_config(name), INPUT_SHAPES[shape_name]
    assert dryrun.skip_reason(cfg, shape) == want["skip"]
    assert dryrun.analytic_flops(cfg, shape) == want["flops"]
    assert dryrun.train_memory_bytes(cfg, shape, 12345.0, 256) \
        == want["train_mem"]
    assert roofline.model_flops(cfg, 1000, shape.kind) == want["model_flops"]
    got = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
           for k, v in dryrun.input_specs(cfg, shape).items()}
    assert got == want["inputs"]
    assert all(v.device.type == "meta"
               for v in dryrun.input_specs(cfg, shape).values())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _jax_spec(entries):
    return [list(e) if isinstance(e, tuple) else e for e in entries]


@pytest.mark.parametrize("name", CONFIGS)
def test_quantized_weight_tree_equals_jax(sides, name):
    """Every leaf of the INT8 weight tree: shape, dtype and spec (on the
    16 x 16 production shape)."""
    cfg = get_config(name)
    tree = param_shapes(cfg)
    q = _flat(variants.quantized_param_shapes(tree))
    qs = _flat(variants.quantized_param_specs(
        param_pspecs(cfg, PRODUCTION_SHAPE, tree), tree))
    got = {k: [list(v.shape), str(v.dtype).replace("torch.", ""),
               _jax_spec(qs[k])] for k, v in q.items()}
    want = sides["jax"]["quant"][name]
    assert got == {k: [s, d, _jax_spec(e)] for k, (s, d, e) in want.items()}


@pytest.mark.parametrize("variant", variants.VARIANTS)
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_variant_lep_keywords_equal_jax(sides, name, variant):
    got = variants.lep_keywords(get_config(name), INPUT_SHAPES["decode_32k"],
                                PRODUCTION_SHAPE, variant)
    got["ep_axes"] = list(got["ep_axes"])
    assert got == sides["jax"]["lep"][f"{name}/{variant}"]


@pytest.mark.parametrize("pair", [f"{a}/{k}" for a, k, _, _ in PAIRS])
def test_argument_bytes_equal_jax(sides, pair):
    """Rank 0's argument bytes on the fake 2 x 4 group, byte for byte."""
    got, want = sides["port"]["pairs"][pair], sides["jax"]["pairs"][pair]
    print(pair, "port", got["collectives"], "jax", want["collectives"],
          "jax untupled", want["collectives_untupled"])
    assert got["argument_bytes"] == want["argument_bytes"]


def _total(coll):
    return sum(v for k, v in coll.items() if k != "count")


@pytest.mark.parametrize("pair", [f"{a}/{k}" for a, k, _, _ in PAIRS])
def test_step_collectives_near_jax(sides, pair):
    """Rank 0's collective bytes on the fake 2 x 4 group at most NEAR_JAX
    times JAX's, counted with the index comments taken out; the decode
    pairs with expert redundancy within REDUNDANT_FACTOR, their experts a
    permute within REDUNDANT_FACTOR of JAX's either way and no all-gather
    as large as one expert's three matrices (DTensor gathered every expert
    for the repeat before)."""
    got, want = sides["port"]["pairs"][pair], sides["jax"]["pairs"][pair]
    port, ref = _total(got["collectives"]), _total(
        want["collectives_untupled"])
    print(pair, "port", got["collectives"], "jax",
          want["collectives_untupled"], f"{port / ref:.2f}x")
    assert port <= NEAR_JAX * ref
    if pair in REDUNDANT:
        assert port <= REDUNDANT_FACTOR * ref
        permute = got["collectives"]["collective-permute"]
        jax_permute = want["collectives_untupled"]["collective-permute"]
        assert jax_permute / REDUNDANT_FACTOR <= permute \
            <= jax_permute * REDUNDANT_FACTOR
        assert got["largest"]["all-gather"] < got["expert_bytes"]


def test_adamw_issues_only_the_norms_scalar(sides):
    """``adamw_update`` over Qwen3's DTensor weights, gradients and moments
    placed alike on the fake 2 x 4 group: no collective but the global
    norm's all-reduce of one float32 scalar, at most one per mesh
    dimension."""
    counts, largest, ndim = sides["port"]["adamw"]
    assert 1 <= counts["count"] <= ndim
    assert largest["all-reduce"] == 4
    assert counts["all-reduce"] == 4 * counts["count"]
    assert _total(counts) == counts["all-reduce"]


def test_sites_sum_to_counter_totals(sides):
    """``scripts/torch_dryrun_sites.py`` on Qwen3's smoke decode at 2 x 4:
    its sites' bytes of each kind sum to the counter's total."""
    sites, totals = sides["port"]["sites"]
    assert _total(totals) > 0
    for kind in totals:
        if kind != "count":
            assert sum(by.get(kind, 0) for by in sites.values()) \
                == totals[kind], kind


def _line(rel: str, text: str) -> str:
    """``rel:N``, N the first line of ``src/repro_torch/rel`` holding
    ``text``."""
    import repro_torch
    from pathlib import Path

    lines = (Path(repro_torch.__file__).parent / rel).read_text() \
        .splitlines()
    return f"{rel}:{next(i + 1 for i, ln in enumerate(lines) if text in ln)}"


@pytest.mark.parametrize("pair,rel,text,width,layers", SHARED_INPUTS,
                         ids=[f"{p}:{t.split('(')[-1].rstrip(')')}"
                              for p, _, t, _, _ in SHARED_INPUTS])
def test_shared_input_gradient_reduced_once(sides, pair, rel, text, width,
                                            layers):
    """Projections that read one input sum their partial gradients of it
    on each rank and all-reduce it once in the backward (XLA's all-reduce
    reassociation): ``layers`` all-reduces of the input's gradient (rows x
    width float32) at the call, where one a projection made as many times
    that."""
    site = _line(rel, text)
    grads = [b for s, k, b in sides["port"]["ops"][pair]
             if k == "all-reduce" and "(backward)" in s and s.endswith(site)
             and b == OP_ROWS * width * 4]
    assert len(grads) == layers, (site, grads)


def test_mamba2_norms_issue_no_dtensor_collective(sides):
    """A Mamba2 train step (its gated norm over ``din``, cut by SSM heads):
    no all-to-all anywhere, and at the norms only the port's own
    collectives (a row's sum of squares all-reduced both ways, the gain's
    gradient summed): none that DTensor chose."""
    ops = sides["port"]["ops"]["mamba2"]
    norm = _line("models/layers.py", "return dt.rms_norm(x, gain, eps)")
    gated = _line("models/mamba2.py", "y = rms_norm(y * F.silu(widened(z))")
    assert sum(b for _, k, b in ops if k == "all-to-all") == 0
    at_norm = [s for s, _, _ in ops if s.endswith(norm) or gated in s]
    assert at_norm and all(s.startswith("core/parallel.py")
                           for s in at_norm), at_norm


def test_qwen3_kv_heads_gather_less_than_whole(sides):
    """Qwen3 with 2 K/V heads over a model axis of 4: each rank computes
    the K/V head of its query heads, from that head's weight columns
    gathered over the 2 ranks that share it, where the step gathered the
    whole k and v when a cache took them: its all-gather bytes fall by
    the whole k and v (2 layers x 2 x rows x 2 heads x 64 floats) less
    one head's columns of each (2 x 2 x 256 x 64 floats), and no op is
    issued at ``fit_heads`` of k or v."""
    ops = sides["port"]["ops"]
    new, old = (sum(b for _, k, b in ops[name] if k == "all-gather")
                for name in ("qwen3-kv2", "qwen3-kv2 whole"))
    whole, heads = 2 * 2 * OP_ROWS * 2 * 64 * 4, 2 * 2 * 256 * 64 * 4
    assert old - new == whole - heads > 0
    fit = [_line("models/attention.py", f"{t} = dt.fit_heads({t}, kv)")
           for t in "kv"]
    assert not [s for s, _, _ in ops["qwen3-kv2"]
                if any(s.endswith(f) for f in fit)]


@pytest.mark.parametrize("pair", LEP_PAIRS)
def test_lep_all_to_all_bytes_equal_jax(sides, pair):
    """LEP's dispatch and combine, where JAX's HLO has no other
    all-to-all: equal bytes. JAX's own count reads 0 there, since its
    pattern skips tuple-shaped collectives; counted with the index comments
    taken out, it finds LEP's."""
    got = sides["port"]["pairs"][pair]["collectives"]["all-to-all"]
    want = sides["jax"]["pairs"][pair]
    assert want["collectives"]["all-to-all"] == 0
    assert got > 0 and got == want["collectives_untupled"]["all-to-all"]


@pytest.mark.parametrize("arch", [a for a, *_ in SCORE_PAIRS])
def test_decode_attention_collectives_near_jax(sides, arch):
    """A decode step over caches whose sequence is sharded over ``model``:
    the argument bytes equal JAX's; all-gather + all-reduce within
    SCORE_FACTOR of JAX's (index comments taken out); and no all-gather of
    the port's is as large as a rank's (B, H, S) float32 scores, which
    DTensor gathered before the attention entered ``local_map`` (the
    softmax's statistics and partial outputs are all-reduced instead)."""
    got, want = sides["port"]["scores"][arch], sides["jax"]["scores"][arch]
    assert got["argument_bytes"] == want["argument_bytes"]
    kinds = ("all-gather", "all-reduce")
    port = sum(got["collectives"][k] for k in kinds)
    ref = sum(want["collectives"][k] for k in kinds)
    print(arch, "port", got["collectives"], "jax", want["collectives"])
    assert ref / SCORE_FACTOR <= port <= ref * SCORE_FACTOR
    assert got["largest"]["all-gather"] < got["scores_bytes"]


def test_counter_sees_direct_and_dtensor_collectives(sides):
    """A ``core/parallel.py`` all-to-all of (8, 16) f32 on the model group
    (512 output bytes), and a DTensor's Shard -> Shard move (an all-to-all)
    then Shard -> Replicate (an all-gather of 512 bytes)."""
    assert sides["port"]["direct"] == {
        "all-gather": 0, "all-reduce": 0, "reduce-scatter": 0,
        "all-to-all": 512, "collective-permute": 0, "count": 1}
    red = sides["port"]["redistribute"]
    assert red["all-to-all"] == 128 and red["all-gather"] == 512 \
        and red["count"] == 2


def test_counter_counts_each_permute_batch_apart(sides):
    """Two batches of ``core/parallel.send_recv``, each sending 512 bytes
    and receiving 128 or the other way round: each batch is one permute of
    its larger side, 1024 bytes in all (640 if the step's sends and
    receives were taken whole)."""
    assert sides["port"]["permute"] == {
        "all-gather": 0, "all-reduce": 0, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 1024, "count": 4}


def test_pending_sums_reduce_in_one_all_reduce(sides):
    """A gradient pending over both mesh axes (Partial, Partial) placed as
    its replicated parameter (``dtensor.placed_like``), or its sums taken
    (``reduce_partial``): one all-reduce over both axes, as XLA's
    reassociation merges them, where DTensor's own redistribution issues
    one per axis (two)."""
    merged, merged_fwd, apart = sides["port"]["pending"]
    one = {"all-gather": 0, "all-reduce": 1024, "reduce-scatter": 0,
           "all-to-all": 0, "collective-permute": 0, "count": 1}
    assert merged == merged_fwd == one
    assert apart == dict(one, **{"all-reduce": 2048, "count": 2})


def test_r1_lep_output_left_on_token_split(sides):
    """R1's smoke train step on the fake 2 x 4 group, a dense layer then
    two MoE layers: LEP leaves its output on its token split, as XLA
    leaves the output of JAX's ``shard_map`` on its ``tok_spec`` (JAX's
    HLO of R1's smoke train pair has no forward collective at
    ``repro/core/lep.py:248``, the ``shard_map``; its transpose there
    sums the split's gradient): nothing at LEP's output gather nor at its
    own split of the tokens (the rows arrive split), and the split of the
    residual stream gathers x's gradient once, at the first MoE layer (a
    data rank's rows x D float32), none at the second."""
    ops = sides["port"]["ops"]["r1-3"]
    gather = _line("core/lep.py", "par.gather_replicated(out, lay.tok_group)")
    run_split = _line("core/lep.py", "x_loc = par.split_replicated(")
    split = _line("core/lep.py", "lambda xb: (par.split_replicated(xb, group)")
    assert not [s for s, _, _ in ops
                if s.endswith(gather) or s.endswith(run_split)]
    assert [(k, b) for s, k, b in ops if s.endswith(split)] \
        == [("all-gather", OP_ROWS * 256 * 4)]
    assert [s for s, _, _ in ops if "core/lep.py" in s]
    jax_sites = sides["jax"]["r1_train_sites"]
    assert "repro/core/lep.py:235" in jax_sites      # the combine
    assert "repro/core/lep.py:248" not in jax_sites


@pytest.mark.parametrize("kind", SERVE_KINDS)
def test_r1_serve_pairs_keep_their_collectives(sides, kind):
    """R1's smoke decode and prefill pairs (8 rows of 64 on the fake 2 x 4
    group) keep LEP's output gather: one all-gather a MoE layer there, of
    a data rank's rows x D float32 (its 4 rows at decode, 4 x 64 at
    prefill), and nothing at the split of a train step's residual
    stream."""
    cfg = smoke_variant(get_config("deepseek-r1"))
    ops = sides["port"]["r1_serve"][kind]
    gather = _line("core/lep.py", "par.gather_replicated(out, lay.tok_group)")
    split = _line("core/lep.py", "lambda xb: (par.split_replicated(xb, group)")
    rows = 8 // 2 * (1 if kind == "decode" else 64)
    assert [(k, b) for s, k, b in ops if s.endswith(gather)] \
        == [("all-gather", rows * cfg.d_model * 4)] \
        * (cfg.num_layers - cfg.first_k_dense)
    assert not [s for s, _, _ in ops if s.endswith(split)]


@pytest.mark.parametrize("case", [f"{n}/{k}" for n, k in VARIANT_CASES])
def test_variant_traces_on_fake_group(sides, case):
    """Every case traces; a variant that keeps the weights and caches reads
    the baseline's argument bytes, INT8 weights fewer; the variant's
    environment is restored afterwards; the hybrid prefill enters its
    collectives (an a2a or reduce-scatter over the model axis)."""
    got = sides["port"]["variants"]
    args, count, env_left = got[case]
    name, kind = case.split("/")
    base_args, base_count, _ = got[f"baseline/{kind}"]
    assert env_left == []
    if name == "int8_weights":
        assert 0 < args < base_args
    else:
        assert args == base_args
    if name.startswith("hybrid"):
        assert count != base_count


@pytest.mark.parametrize("arch", FAMILIES)
def test_run_one_per_family_ok(sides, arch):
    status, error, mesh, n_dev = sides["port"]["run_one"][arch]
    assert status == "ok", error
    assert (mesh, n_dev) == ("16x16", 256)


def test_variant_registry_has_eighteen():
    assert len(variants.VARIANTS) == len(set(variants.VARIANTS)) == 18
    with pytest.raises(ValueError, match="unknown variant"):
        variants.build_variant(smoke_variant(get_config("qwen3-8b")),
                               INPUT_SHAPES["decode_32k"], PRODUCTION_SHAPE,
                               "nope")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


class _Elsewhere(torch.Tensor):
    """A tensor whose metadata says it lives on an XPU, a device that is
    neither the CPU, CUDA nor meta; ops run on its shape alone."""

    @staticmethod
    def __new__(cls, t):
        return torch.Tensor._make_wrapper_subclass(
            cls, t.shape, strides=t.stride(), dtype=t.dtype,
            device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        from torch.utils._pytree import tree_map

        def meta(t):
            return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                       device="meta") \
                if isinstance(t, cls) else t

        out = func(*tree_map(meta, args), **tree_map(meta, kwargs or {}))
        return tree_map(lambda t: cls(t) if isinstance(t, torch.Tensor)
                        else t, out)


WRAPPER_CASES = {
    "mla_decode_attention": (
        lambda: (_meta(2, 16, 32), _meta(2, 16, 16), _meta(2, 8, 48),
                 _meta(2, dtype=torch.int32)),
        lambda *a: mla_decode_attention(*a, 0.1), [(2, 16, 32)]),
    "dispatch_quantize": (
        lambda: (_meta(4, 8),),
        lambda x: dispatch_quantize(x, pack=False), [(4, 8), (4, 1)]),
    "int8_matmul": (
        lambda: (_meta(2, 8, dtype=torch.int8),
                 _meta(4, 8, dtype=torch.int8).t(), _meta(2, 1),
                 _meta(1, 4)),
        int8_matmul, [(2, 4)]),
    "ssd_scan": (
        lambda: (_meta(1, 8, 2, 4), _meta(1, 8, 2), _meta(2), _meta(1, 8, 3),
                 _meta(1, 8, 3)),
        lambda *a: ssd_scan(*a, chunk=4), [(1, 8, 2, 4), (1, 2, 4, 3)]),
}


@pytest.mark.parametrize("name", list(WRAPPER_CASES))
def test_wrappers_trace_meta_and_refuse_other_devices(name):
    """Meta takes the plain version (shapes only, no kernel, no count);
    a device other than the CPU and CUDA raises."""
    make, call, shapes = WRAPPER_CASES[name]
    out = call(*make())
    out = out if isinstance(out, tuple) else (out,)
    assert [tuple(o.shape) for o in out] == shapes
    assert all(o.device.type == "meta" for o in out)
    with pytest.raises(ValueError, match="cpu or cuda"):
        call(*(_Elsewhere(t) for t in make()))
