"""The port's §4.3.1 hybrid MLA prefill (``core/hybrid_parallel.py``) and the
model hook that routes the prefill through it, against the JAX package's,
on the CPU: two gloo ranks over a 1 x 2 ``DeviceMesh`` against JAX on a
forced 2-device mesh, at DeepSeek-R1's smoke variant in float32, with the
same numpy weights.

Tolerances: the hybrid layer within 1e-4 of its largest entry against
JAX's hybrid and against the port's plain ``mla_prefill``
(``tests/test_multidevice.py``'s); the hooked prefill's logits within
5e-3 of the plain prefill's (the same test's) and within 2e-4 of JAX's
hooked logits (the model tests' logit tolerance); training through the
hook, ``lm_loss`` within 1e-5 and each weight's gradient within 2e-4 of
that leaf's largest |g| of ``jax.value_and_grad`` under JAX's hook and of
the port's plain prefill (``test_torch_train.py``'s tolerances)."""
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.models import init_params as j_init_params
from repro.models import mla as j_mla
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import params_from_jax_numpy
from repro_torch.core import hybrid_parallel, parallel
from repro_torch.models import prefill, prefill_continue
from test_torch_lep import _kill_all, _start

HYBRID_RTOL = 1e-4
HOOK_RTOL = 5e-3
LOGIT_RTOL = 2e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4           # of each leaf's largest |gradient|
SEQS = (32, 40)
MODES = ("a2a", "rs")
BATCH, CAPACITY = 2, 48
TIMEOUT_S = 150

JAX_SIDE = textwrap.dedent("""
    import os, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, smoke_variant
    from repro.core.hybrid_parallel import mla_prefill_hybrid
    from repro.core.parallel import set_current_mesh
    from repro.launch.mesh import make_debug_mesh
    from repro.models import init_params, lm_loss, prefill
    d = np.load(sys.argv[1])
    cfg = smoke_variant(get_config("deepseek-r1"))
    p = {k[2:]: jnp.asarray(d[k]) for k in d.files if k.startswith("w:")}
    mesh = make_debug_mesh(1, 2)
    out = {}
    for s in %s:
        x = jnp.asarray(d[f"x{s}"])
        for mode in %s:
            with mesh:
                o, lat = jax.jit(lambda pp, xx: mla_prefill_hybrid(
                    pp, xx, cfg, mesh, oproj_mode=mode))(p, x)
            out[f"{mode}:{s}"], out[f"{mode}:{s}:latent"] = o, lat
    params = init_params(jax.random.PRNGKey(0), cfg)
    set_current_mesh(mesh)
    for mode in %s:
        os.environ["REPRO_MLA_HYBRID"] = mode
        with mesh:
            lg, _ = jax.jit(lambda pp, b: prefill(
                pp, cfg, b, %d, cache_dtype=jnp.float32))(
                params, {"tokens": jnp.asarray(d["tokens"])})
        out[f"hook:{mode}"] = lg
        lbatch = {k: jnp.asarray(d[k]) for k in ("tokens", "labels")}
        with mesh:
            loss, g = jax.jit(jax.value_and_grad(
                lambda pp: lm_loss(pp, cfg, lbatch)[0]))(params)
        out[f"loss:{mode}"] = loss
        for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
            out[f"grad:{mode}:" + "/".join(k.key for k in path)] = leaf
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
""" % (SEQS, MODES, MODES, CAPACITY))

PORT_SIDE = textwrap.dedent("""
    import copy, os, sys
    import numpy as np, torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.convert import param_tree, params_from_jax_numpy
    from repro_torch.core.hybrid_parallel import mla_prefill_hybrid
    from repro_torch.core.parallel import mesh_context
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm_loss, prefill
    from repro_torch.models.mla import MLA, mla_prefill
    from repro_torch.train import trainable

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
                                world_size=2)
        torch.set_num_threads(1)
        mesh = make_debug_mesh(1, 2)
        d = np.load(inp)
        cfg = smoke_variant(get_config("deepseek-r1"))
        layer = MLA(cfg, torch.device("cpu"), torch.float32)
        for k in d.files:
            if k.startswith("w:"):
                getattr(layer, k[2:]).data.copy_(torch.from_numpy(d[k]))
        out = {}
        for s in %s:
            x = torch.from_numpy(d[f"x{s}"])
            out[f"plain:{s}"], out[f"plain:{s}:latent"] = mla_prefill(
                layer, x, cfg)
            for mode in %s:
                out[f"{mode}:{s}"], out[f"{mode}:{s}:latent"] = \\
                    mla_prefill_hybrid(layer, x, cfg, mesh, oproj_mode=mode)
        model = params_from_jax_numpy(
            nest({k[2:]: d[k] for k in d.files if k.startswith("p:")}),
            cfg, "cpu")
        batch = {"tokens": torch.from_numpy(d["tokens"])}
        out["hook:plain"], caches = prefill(model, cfg, batch, %d,
                                            cache_dtype=torch.float32)
        out["hook:plain:cache"] = caches["moe"]["mla"]
        with mesh_context(mesh):
            for mode in %s:
                os.environ["REPRO_MLA_HYBRID"] = mode
                out[f"hook:{mode}"], caches = prefill(
                    model, cfg, batch, %d, cache_dtype=torch.float32)
                out[f"hook:{mode}:cache"] = caches["moe"]["mla"]
        lbatch = {k: torch.from_numpy(d[k]) for k in ("tokens", "labels")}
        for mode in ("plain",) + %s:
            os.environ["REPRO_MLA_HYBRID"] = mode
            with mesh_context(mesh), trainable(model) as leaves:
                loss = lm_loss(model, cfg, lbatch)[0]
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            holder = copy.deepcopy(model)
            for w, g in zip(holder.parameters(), grads):
                w.data.copy_(0 if g is None else g)
            out[f"loss:{mode}"] = loss.detach()
            out.update({f"grad:{mode}:{k}": v
                        for k, v in flat(param_tree(holder)).items()})
        np.savez(f"{outp}.rank{rank}.npz",
                 **{k: v.numpy() for k, v in out.items()})
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1], sys.argv[2], sys.argv[3]), nprocs=2)
""" % (SEQS, MODES, CAPACITY, MODES, CAPACITY, MODES))


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both sides run once: (JAX's arrays, each port rank's arrays)."""
    tmp = tmp_path_factory.mktemp("hybrid")
    cfg = smoke("deepseek-r1")
    p = jax.tree.map(lambda a: np.asarray(a[0]), j_mla.init_mla_params(
        jax.random.PRNGKey(0), cfg, 1, np.float32))
    arrays = {f"w:{k}": v for k, v in p.items()}
    for s in SEQS:
        arrays[f"x{s}"] = np.random.RandomState(s).randn(
            BATCH, s, cfg.d_model).astype(np.float32)
    params = jax.jit(j_init_params, static_argnums=(1,))(
        jax.random.PRNGKey(0), cfg)
    arrays.update({"p:" + "/".join(k.key for k in path): np.asarray(leaf)
                   for path, leaf in jax.tree_util.tree_flatten_with_path(
                       params)[0]})
    rng = np.random.RandomState(1)
    for k in ("tokens", "labels"):
        arrays[k] = rng.randint(0, cfg.vocab_size, (BATCH, 32)).astype(
            np.int32)
    np.savez(tmp / "in.npz", **arrays)
    (tmp / "jax_side.py").write_text(JAX_SIDE)
    (tmp / "port_side.py").write_text(PORT_SIDE)
    deadline = time.monotonic() + TIMEOUT_S
    procs = [_start(tmp / "jax_side.py", [str(tmp / "in.npz"),
                                          str(tmp / "jax.npz")],
                    xla_devices=2),
             _start(tmp / "port_side.py", [str(tmp / "in.npz"),
                                           str(tmp / "port"),
                                           f"file://{tmp / 'gloo_init'}"])]
    try:
        for proc in procs:
            out, err = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert proc.returncode == 0, \
                f"stdout:\n{out}\nstderr:\n{err[-3000:]}"
    finally:
        _kill_all(procs)
    return (np.load(tmp / "jax.npz"),
            [np.load(tmp / f"port.rank{r}.npz") for r in range(2)])


@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("mode", MODES)
def test_hybrid_prefill_matches_jax_and_plain(results, mode, s):
    """Each rank's gathered output and latent cache against JAX's hybrid on
    a forced 1 x 2 mesh and against the port's plain ``mla_prefill``."""
    ref, ranks = results
    for got in ranks:
        for key in (f"{mode}:{s}", f"{mode}:{s}:latent"):
            assert got[key].shape == ref[key].shape, key
            assert _rel(got[key], ref[key]) <= HYBRID_RTOL, key
        assert _rel(got[f"{mode}:{s}"], got[f"plain:{s}"]) <= HYBRID_RTOL
        assert _rel(got[f"{mode}:{s}:latent"],
                    got[f"plain:{s}:latent"]) <= HYBRID_RTOL


@pytest.mark.parametrize("mode", MODES)
def test_hooked_prefill_matches_plain_and_jax(results, mode):
    """``REPRO_MLA_HYBRID`` with a current mesh: the model's prefill logits
    against the plain prefill and against JAX's hooked prefill, and the
    latent cache it writes against the plain one's."""
    ref, ranks = results
    for got in ranks:
        hooked = got[f"hook:{mode}"]
        assert _rel(hooked, got["hook:plain"]) <= HOOK_RTOL
        assert _rel(hooked, ref[f"hook:{mode}"]) <= LOGIT_RTOL
        assert _rel(got[f"hook:{mode}:cache"], got["hook:plain:cache"]) \
            <= HYBRID_RTOL


@pytest.mark.parametrize("mode", MODES)
def test_training_through_the_hook_matches_jax(results, mode):
    """``lm_loss`` and every weight's gradient with the hook on: each rank
    holds the one global gradient, equal to JAX's ``value_and_grad`` under
    its hook and to the port's plain prefill's (no rank's gradient is a
    multiple of it, nor covers only its own shard)."""
    ref, ranks = results
    leaves = [k[len(f"grad:{mode}:"):] for k in ref.files
              if k.startswith(f"grad:{mode}:")]
    assert leaves
    for got in ranks:
        for other, want in ((ref, mode), (got, "plain")):
            loss = float(other[f"loss:{want}"])
            assert abs(float(got[f"loss:{mode}"]) - loss) \
                <= LOSS_RTOL * abs(loss), want
            for key in leaves:
                g_ref = other[f"grad:{want}:{key}"]
                g_scale = max(float(np.abs(g_ref).max()), 1e-12)
                err = float(np.abs(got[f"grad:{mode}:{key}"] - g_ref).max())
                assert err <= GRAD_TOL * g_scale, (want, key, err, g_scale)


def test_hybrid_refuses_a_sequence_that_does_not_divide():
    """As JAX's ``shard_map`` does, S must divide over the axis."""
    cfg = smoke_variant(get_config("deepseek-r1"))
    from repro_torch.models.mla import MLA
    layer = MLA(cfg, torch.device("cpu"), torch.float32)
    with pytest.raises(ValueError, match="must divide"):
        hybrid_parallel.mla_prefill_hybrid(
            layer, torch.zeros(1, 31, cfg.d_model), cfg,
            {"data": 1, "model": 2})


def test_hook_routes_prefill_alone(monkeypatch):
    """The hook takes the MLA prefill of ``prefill`` (every layer) only when
    ``REPRO_MLA_HYBRID`` is a2a or rs and a mesh is current, and never a
    ``prefill_continue``."""
    cfg = smoke("deepseek-r1")
    tcfg = smoke_variant(get_config("deepseek-r1"))
    params = jax.jit(j_init_params, static_argnums=(1,))(
        jax.random.PRNGKey(0), cfg)
    model = params_from_jax_numpy(jax.tree.map(np.asarray, params), tcfg,
                                  "cpu")
    calls = []
    real = hybrid_parallel.mla_prefill_hybrid

    def spy(p, x, c, mesh, **kw):
        calls.append(kw["oproj_mode"])
        return real(p, x, c, {"data": 1, "model": 1}, **kw)

    monkeypatch.setattr(hybrid_parallel, "mla_prefill_hybrid", spy)
    monkeypatch.setattr(parallel, "axes_group", lambda mesh, axes: None)
    monkeypatch.setattr(parallel, "axis_index", lambda mesh, axes: 0)
    toks = {"tokens": torch.tensor([[3, 1, 4, 1, 5, 9]])}
    plain, _ = prefill(model, tcfg, toks, 16, cache_dtype=torch.float32)
    monkeypatch.setenv("REPRO_MLA_HYBRID", "rs")
    prefill(model, tcfg, toks, 16, cache_dtype=torch.float32)
    assert calls == []                      # no current mesh
    with parallel.mesh_context({"data": 1, "model": 1}):
        hooked, caches = prefill(model, tcfg, toks, 16,
                                 cache_dtype=torch.float32)
        assert calls == ["rs"] * tcfg.num_layers
        prefill_continue(model, tcfg, torch.tensor([[2, 6]]), caches,
                         torch.tensor(6))
        assert len(calls) == tcfg.num_layers
        monkeypatch.setenv("REPRO_MLA_HYBRID", "")
        prefill(model, tcfg, toks, 16, cache_dtype=torch.float32)
        assert len(calls) == tcfg.num_layers
    assert _rel(hooked.numpy(), plain.numpy()) <= HYBRID_RTOL
