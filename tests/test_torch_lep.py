"""The port's LEP (``repro_torch.core.lep``) against the JAX package's on the
CPU: at world size 1 in process, at world size 2 over gloo against JAX on a
forced 2-device mesh, and served through ``ServingSystem`` with tokens and
virtual-clock trace equal to JAX's. Weights and inputs come from JAX's
initializer or numpy seeds and go to both sides as numpy arrays."""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.core.lep import make_lep_moe_fn as j_make_lep_moe_fn
from repro.launch.mesh import make_debug_mesh
from repro.models import init_params as j_init_params
from repro.models import moe as j_moe
from repro.serving import Request as JRequest
from repro.serving import ServingSystem as JServingSystem
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import moe_from_jax_numpy, params_from_jax_numpy
from repro_torch.core import lep
from repro_torch.kernels.dispatch_quant import ops as dq_ops
from repro_torch.models import decode_step as t_decode_step
from repro_torch.models import prefill as t_prefill
from repro_torch.models.moe import moe_reference
from repro_torch.serving import Request, ServingSystem

ROOT = Path(__file__).resolve().parents[1]
LEP_RTOL = 1e-5           # max |port - JAX| over max |JAX|, float32
# Early INT8 quantization against the exact dense MoE (test_multidevice.py).
QUANT_REL_TOL = 0.05

CASES = {
    "packed": {},
    "two_collectives": dict(pack_scales=False),
    "bf16_payload": dict(quantize=False),
    "naive": dict(naive=True),
    "redundancy": dict(redundancy=2),
    "dropping": dict(capacity_factor=0.25, capacity_align=1),
}


# DeepSeek-R1's smoke MoE (4 experts, top-2, one shared expert) and the
# same without the shared expert, both at capacity factor 8 (as
# test_multidevice.py runs LEP) so that only the "dropping" case drops.
ARCHS = {"r1": {}, "r1_routed_only": {"num_shared_experts": 0}}


@pytest.fixture(scope="module")
def moe_layers():
    layers = {}
    for name, upd in ARCHS.items():
        jcfg = dataclasses.replace(smoke("deepseek-r1"), capacity_factor=8.0,
                                   **upd)
        tcfg = dataclasses.replace(smoke_variant(get_config("deepseek-r1")),
                                   capacity_factor=8.0, **upd)
        jp = jax.tree.map(lambda a: a[0], j_moe.init_moe_params(
            jax.random.PRNGKey(0), jcfg, 1, jnp.float32))
        tp = moe_from_jax_numpy(jax.tree.map(lambda a: np.asarray(a)[None], jp),
                                tcfg, 0, "cpu")
        layers[name] = (jcfg, tcfg, jp, tp)
    return layers


def _x(t, d, seed=1):
    return np.random.RandomState(seed).randn(t, d).astype(np.float32)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_lep_world1_matches_jax(moe_layers, arch, case):
    """World size 1 (no collective) against JAX LEP on a 1x1 mesh: output
    to 1e-5 of its largest entry, the same dropped count, and within 0.05
    of the exact dense MoE when nothing is dropped."""
    jcfg, tcfg, jp, tp = moe_layers[arch]
    kw = CASES[case]
    x = _x(24, jcfg.d_model)
    mesh = make_debug_mesh(1, 1)
    jfn = j_make_lep_moe_fn(mesh, ("model",), **kw)
    with mesh:
        jout, jaux = jax.jit(lambda p, a: jfn(p, a, jcfg))(jp, jnp.asarray(x))
    jout = np.asarray(jout)
    out, aux = lep.make_lep_moe_fn(**kw)(tp, torch.from_numpy(x), tcfg)
    assert out.dtype == torch.float32 and tuple(out.shape) == x.shape
    assert _rel(out.numpy(), jout) <= LEP_RTOL
    assert int(aux["dropped"]) == int(jaux["dropped"])
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(jaux["aux_loss"]), rtol=1e-5)
    if case == "dropping":
        assert int(aux["dropped"]) > 0
        return
    assert int(aux["dropped"]) == 0
    ref, _ = moe_reference(tp, torch.from_numpy(x), tcfg)
    quantized = kw.get("quantize", True) and not kw.get("naive")
    assert _rel(out.numpy(), ref.numpy()) < (QUANT_REL_TOL if quantized
                                             else LEP_RTOL)


def test_lep_packed_scales_equal_two_collectives(moe_layers):
    """Carrying the scales in the payload tail changes nothing but the
    number of collectives: outputs bit-identical."""
    _, tcfg, _, tp = moe_layers["r1"]
    x = torch.from_numpy(_x(13, tcfg.d_model, seed=3))
    a, _ = lep.make_lep_moe_fn(pack_scales=True)(tp, x, tcfg)
    b, _ = lep.make_lep_moe_fn(pack_scales=False)(tp, x, tcfg)
    assert torch.equal(a, b)


def test_lep_quantizes_once_per_call(moe_layers, monkeypatch):
    """The dispatch buffer goes through the dispatch-quantize wrapper once
    per MoE call, and not at all without early quantization."""
    _, tcfg, _, tp = moe_layers["r1"]
    x = torch.from_numpy(_x(5, tcfg.d_model))
    calls = []
    real = dq_ops.dispatch_quantize
    monkeypatch.setattr(lep, "dispatch_quantize",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    lep.make_lep_moe_fn()(tp, x, tcfg)
    lep.make_lep_moe_fn(pack_scales=False)(tp, x, tcfg)
    lep.make_lep_moe_fn(quantize=False)(tp, x, tcfg)
    assert len(calls) == 2


def test_lep_capacity_and_plan_match_jax():
    from repro.core.lep import lep_capacity as j_cap
    for args in [(0, 2, 8, 1.0), (16, 1, 4, 1.0, 4), (3, 2, 4, 1.25, 1),
                 (5, 1, 7, 1.5, 1), (8, 8, 256, 1.25), (1019, 8, 256, 1.25)]:
        assert lep.lep_capacity(*args) == j_cap(*args)
    cfg = get_config("deepseek-r1")
    assert lep.pick_lep_plan(cfg, 1) == {"redundancy": 1}
    assert lep.pick_lep_plan(cfg, 4) == {"redundancy": 1}
    assert lep.pick_lep_plan(cfg, 512, serving=True) == {"redundancy": 2}
    # A 1-D world where the experts do not divide, and the 2-D modes
    # without a mesh, are refused: they need a mesh's axes.
    with pytest.raises(ValueError, match="mesh"):
        lep.pick_lep_plan(cfg, 3)
    with pytest.raises(ValueError, match="mesh="):
        lep.make_lep_moe_fn(ffn_shard_axis="data")
    with pytest.raises(ValueError, match="mesh="):
        lep.make_lep_moe_fn(quantize_gather=True)


# ---------------------------------------------------------------------------
# World size 2: gloo processes against a forced 2-device JAX mesh
# ---------------------------------------------------------------------------

WORLD2_CASES = {"packed": {}, "two_collectives": {"pack_scales": False},
                "bf16_payload": {"quantize": False}, "naive": {"naive": True}}
WORLD2_TOKENS = (24, 13)          # 13 rows do not divide over 2 ranks
WORLD2_TIMEOUT_S = 170            # both subprocesses together

JAX_WORLD2 = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, smoke_variant
    from repro.core.lep import make_lep_moe_fn
    from repro.launch.mesh import make_debug_mesh
    d = np.load(sys.argv[1])
    cases = json.loads(sys.argv[2])
    cfg = smoke_variant(get_config("deepseek-r1"))
    p = {k[2:]: jnp.asarray(d[k]) for k in d.files if k.startswith("w:")}
    mesh = make_debug_mesh(1, 2)
    out = {}
    for name, kw in cases.items():
        fn = make_lep_moe_fn(mesh, ("model",), **kw)
        for t in %s:
            with mesh:
                o, aux = jax.jit(lambda pp, xx: fn(pp, xx, cfg))(
                    p, jnp.asarray(d[f"x{t}"]))
            out[f"{name}:{t}"] = np.asarray(o)
            out[f"{name}:{t}:dropped"] = np.asarray(aux["dropped"])
    np.savez(sys.argv[3], **out)
""" % (WORLD2_TOKENS,))

PORT_WORLD2 = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.convert import moe_from_jax_numpy
    from repro_torch.core.lep import make_lep_moe_fn

    def run(rank, inp, cases, outp, init):
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=2)
        torch.set_num_threads(1)
        d = np.load(inp)
        cfg = smoke_variant(get_config("deepseek-r1"))
        tree = {k[2:]: d[k][None] for k in d.files if k.startswith("w:")}
        p = moe_from_jax_numpy(tree, cfg, 0, "cpu")
        out = {}
        for name, kw in cases.items():
            fn = make_lep_moe_fn(dist.group.WORLD, **kw)
            for t in %s:
                o, aux = fn(p, torch.from_numpy(d[f"x{t}"]), cfg)
                out[f"{name}:{t}"] = o.numpy()
                out[f"{name}:{t}:dropped"] = np.asarray(int(aux["dropped"]))
        np.savez(f"{outp}.rank{rank}.npz", **out)
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1], json.loads(sys.argv[2]),
                            sys.argv[3], sys.argv[4]), nprocs=2)
""" % (WORLD2_TOKENS,))


def _start(code_path, args, xla_devices=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if xla_devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={xla_devices}"
    # A session of its own, so that the process and the ranks it spawns can
    # be killed together.
    return subprocess.Popen([sys.executable, str(code_path), *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)


def _kill_all(procs):
    for proc in procs:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()


def test_lep_world2_gloo_matches_jax_two_devices(tmp_path):
    """Two gloo ranks (``all_to_all_single`` on the packed int8 payload and
    the combine) against JAX LEP over a forced 2-device CPU mesh, on the
    same weights and tokens, including a token count that needs padding."""
    cfg = smoke("deepseek-r1")
    jp = jax.tree.map(lambda a: np.asarray(a[0]), j_moe.init_moe_params(
        jax.random.PRNGKey(0), cfg, 1, jnp.float32))
    arrays = {f"w:{k}": v for k, v in jp.items()}
    for t in WORLD2_TOKENS:
        arrays[f"x{t}"] = _x(t, cfg.d_model, seed=t)
    np.savez(tmp_path / "in.npz", **arrays)
    cases = json.dumps(WORLD2_CASES)
    (tmp_path / "jax_world2.py").write_text(JAX_WORLD2)
    (tmp_path / "port_world2.py").write_text(PORT_WORLD2)
    deadline = time.monotonic() + WORLD2_TIMEOUT_S
    procs = [
        _start(tmp_path / "jax_world2.py",
             [str(tmp_path / "in.npz"), cases, str(tmp_path / "jax.npz")],
             xla_devices=2),
        _start(tmp_path / "port_world2.py",
             [str(tmp_path / "in.npz"), cases, str(tmp_path / "port"),
              f"file://{tmp_path / 'gloo_init'}"]),
    ]
    try:
        for proc in procs:
            out, err = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert proc.returncode == 0, \
                f"stdout:\n{out}\nstderr:\n{err[-3000:]}"
    finally:
        _kill_all(procs)
    ref = np.load(tmp_path / "jax.npz")
    ranks = [np.load(tmp_path / f"port.rank{r}.npz") for r in range(2)]
    assert sorted(ranks[0].files) == sorted(ref.files)
    for key in ref.files:
        for got in ranks:                 # every rank holds the whole output
            if key.endswith(":dropped"):
                assert int(got[key]) == int(ref[key]), key
            else:
                assert got[key].shape == ref[key].shape, key
                assert _rel(got[key], ref[key]) <= LEP_RTOL, key


# ---------------------------------------------------------------------------
# Served through ServingSystem
# ---------------------------------------------------------------------------

N_NEW = 6
LOGIT_TOL = 2e-4           # the model tests' float32 logit tolerance


@pytest.fixture(scope="module")
def r1():
    cfg = smoke("deepseek-r1")
    tcfg = smoke_variant(get_config("deepseek-r1"))
    jp = jax.jit(j_init_params, static_argnums=(1,))(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.RandomState(11)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in (12, 9, 12, 7, 12)]
    return cfg, tcfg, jp, tp, prompts


def _max_new(i):
    return N_NEW if i % 2 == 0 else 2


def _min_margin(tcfg, tp, prompt, tokens, moe_fn):
    """Smallest top-1/top-2 logit gap along a greedy path through the
    port's LEP."""
    logits, caches = t_prefill(tp, tcfg, {"tokens": torch.tensor([prompt])},
                               48, moe_fn, cache_dtype=torch.float32)
    rows = [logits[0, -1]]
    for i, tok in enumerate(tokens[:-1]):
        lg, caches = t_decode_step(tp, tcfg, torch.tensor([[tok]]), caches,
                                   torch.tensor(len(prompt) + i), moe_fn)
        rows.append(lg[0])
    top2 = torch.stack(rows).topk(2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


@pytest.mark.parametrize("path", ["per_step", "chunked_continuous"])
def test_lep_serving_matches_jax(r1, path):
    """``ServingSystem(moe_fn=LEP)`` emits JAX's tokens and writes JAX's
    trace records and SLO summary (early INT8 dispatch on both sides),
    with every greedy margin far above the logit tolerance."""
    cfg, tcfg, jp, tp, prompts = r1
    kw = {} if path == "per_step" else {"decode_chunk": 4,
                                        "continuous_batching": True}
    mesh = make_debug_mesh(1, 1)
    jfn = j_make_lep_moe_fn(mesh, ("model",))
    with mesh:
        js = JServingSystem(jp, cfg, n_prefill=2, decode_batch=2, capacity=48,
                            moe_fn=jfn, **kw)
        jres = {r.rid: r.tokens for r in js.serve(
            [JRequest(i, p, _max_new(i)) for i, p in enumerate(prompts)])}
    calls = []
    port_fn = lep.make_lep_moe_fn()

    def counted(p, x, c):
        calls.append(x.shape[0])
        return port_fn(p, x, c)

    system = ServingSystem(tp, tcfg, n_prefill=2, decode_batch=2, capacity=48,
                           device="cpu", moe_fn=counted, **kw)
    res = {r.rid: r.tokens for r in system.serve(
        [Request(i, p, _max_new(i)) for i, p in enumerate(prompts)])}
    assert calls, "the LEP moe_fn was never called"
    assert res == jres
    assert system.scheduler.trace_records() == js.scheduler.trace_records()
    assert repr(system.scheduler.summary()) == repr(js.scheduler.summary())
    if path == "per_step":
        for rid, prompt in enumerate(prompts):
            assert _min_margin(tcfg, tp, prompt, res[rid], port_fn) \
                > 20 * LOGIT_TOL
