"""LEP over a DTensor batch at 2 x 2 and the steps that run it on JAX's
weights, against JAX on a forced 4-device 2 x 2 mesh, on the CPU: gloo
ranks over a 2 x 2 ``DeviceMesh`` (one subprocess, its ranks forked) and
JAX's side (``JAX_EXTRA``, a subprocess of its own), started together
under LEP_TIMEOUT_S (``torch_sharded_common.py`` holds the inputs, the
ranks' script and the wait).

* LEP with ``redundancy=2`` on full-mesh EP, the experts placed over
  ``model`` (each rank receives the experts its slots lack: a permute),
  against JAX's LEP function: within 1e-5 of the largest entry, as
  ``test_torch_lep2d.py`` holds its modes.
* LEP's gradients on an R1 MoE layer with a shared expert whose weights
  are narrow enough (``d_ff`` = LEP_SHARED_FF) that it runs on the token
  split with its weights gathered whole, every weight placed by the
  training specs: the output (1e-5) and the gradients of x and every
  weight (2e-4 of each one's largest) of a seeded cotangent, against
  ``jax.value_and_grad`` through JAX's LEP function.
* R1's prefill step through the §4.3.1 hybrid in both o-proj modes
  (``REPRO_MLA_HYBRID``, LEP with an unquantized payload) against JAX's
  ``model.prefill`` under the same setting (1e-5).
* The LEP train steps of OLMoE (INT8 and unquantized payloads) and of R1
  (a dense layer, then two MoE layers: LEP's output left on its token
  split into the second) against JAX's ``make_train_step`` with JAX's
  LEP."""
import json
import textwrap
import time

import numpy as np
import pytest

from torch_sharded_common import (GRAD_TOL, HYBRID_FIELDS, HYBRID_MODES,
                                  LEP_KW, LEP_SHARED_FF, LEP_STEPS, LOSS_RTOL,
                                  STEP_OPT, STEP_TOL, lep_inputs, load_ranks,
                                  start, start_ranks, wait_all)
from torch_sharded_common import close as _close

#: the INT8 step against JAX's: XLA's fused division rounds some codes the
#: other way (``test_torch_lep2d.py``), so the loss, the gradient norm and
#: the moments hold at the INT8 tolerance of that file's gradients
INT8_TOL = 0.05
#: the ranks' and JAX_EXTRA's deadline, 3.4 x LEP_SETUP_S: the fixture's
#: setup (JAX's inputs, then both processes; JAX_EXTRA the longer) beside
#: the other gloo and JAX files under the tier-1 run's flags (``-n 6
#: --dist loadfile``; the three sharded files, test_torch_lep2d,
#: test_torch_dryrun, test_torch_hybrid_parallel, test_torch_lep and
#: test_multidevice; 8 CPU cores), the longer of two runs (64.4 s in the
#: other). Unloaded: the ranks 11 s, JAX_EXTRA 24 s (with XLA's threads cut
#: to one, 23-26 s: no shorter, so they are left as they are)
LEP_SETUP_S = 70.1

LEP_TIMEOUT_S = 240

#: JAX's side in a process of its own, started with the ranks, over a
#: forced 4-device 2 x 2 mesh on the weights and tokens the ranks take:
#: LEP with redundancy and with a shared expert, the LEP train steps, and
#: R1's prefill through the hybrid
JAX_EXTRA = textwrap.dedent('''
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, smoke_variant
    from repro.core.lep import make_lep_moe_fn
    from repro.launch.mesh import make_debug_mesh
    from repro.train.loop import make_train_step
    from repro.train.optimizer import OptConfig, init_opt_state
    d = np.load(sys.argv[1])
    kw, opt, shared_ff, lep_steps, hybrid = (
        json.loads(a) for a in sys.argv[2:7])
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
    np.savez(sys.argv[7], **out)
''')

@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """The 2 x 2 ranks and JAX_EXTRA started together under LEP_TIMEOUT_S:
    ({"2x2": rank 0's arrays}, JAX's arrays)."""
    tmp = tmp_path_factory.mktemp("sharded_lep")
    np.savez(tmp / "in.npz", **lep_inputs())
    (tmp / "jax_extra.py").write_text(JAX_EXTRA)
    started = time.monotonic()
    procs = [start_ranks("2x2", (2, 2), tmp, tmp / "in.npz", {
        "lep": LEP_KW, "shared_ff": LEP_SHARED_FF, "lep_steps": LEP_STEPS,
        "opt": STEP_OPT, "hybrid_fields": HYBRID_FIELDS,
        "hybrid_modes": HYBRID_MODES})]
    procs.append(start("jax_extra", tmp / "jax_extra.py", [
        str(tmp / "in.npz"), json.dumps(LEP_KW), json.dumps(STEP_OPT),
        json.dumps(LEP_SHARED_FF), json.dumps(LEP_STEPS),
        json.dumps({"fields": HYBRID_FIELDS, "modes": HYBRID_MODES}),
        str(tmp / "jax_extra.npz")], tmp, xla_devices=4))
    wait_all(procs, LEP_TIMEOUT_S, started)
    return ({"2x2": load_ranks(tmp / "2x2.npz")[0]},
            dict(np.load(tmp / "jax_extra.npz")))


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
