"""The port's plans over a mesh against the JAX package's, in pure Python
on the CPU: ``pick_lep_plan`` and the weight, cache and batch specs of
``launch/sharding.py`` for all eleven configs on the production shapes
(16 x 16, 2 x 16 x 16) and two debug shapes (2 x 2, 1 x 2), JAX's side on
an ``AbstractMesh``; DTensor placements; the mesh context; and the
roofline terms and the decode cost model given JAX's constants."""
import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.configs import list_configs as j_list_configs
from repro.core.lep import pick_lep_plan as j_pick_lep_plan
from repro.launch import hlo_analysis as j_hlo
from repro.launch import sharding as j_sharding
from repro.models import init_params as j_init_params
from repro.models import make_caches as j_make_caches
from repro.serving.scheduler import \
    decode_cost_from_roofline as j_decode_cost_from_roofline
from repro_torch.configs import get_config, list_configs
from repro_torch.core import parallel
from repro_torch.core.lep import pick_lep_plan
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import roofline, sharding
from repro_torch.models import make_caches
from repro_torch.serving.scheduler import decode_cost_from_roofline

CONFIGS = list_configs()
SHAPES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2},
          "1x2": {"data": 1, "model": 2}}
CACHE_SHAPES = ((32, 4096), (6, 1000))          # (batch, capacity)
BATCHES = (512, 48, 8, 3)


def _abstract(shape):
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _flat(tree, prefix=()):
    """Path -> leaf of a nested dict / NamedTuple tree of spec tuples."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(_flat(getattr(tree, k), prefix + (k,)))
        return out
    return {prefix: tree}


def _j_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(getattr(k, "key", getattr(k, "name", None)) for k in path):
            tuple(spec) for path, spec in leaves}


def test_the_port_builds_every_jax_config():
    assert CONFIGS == j_list_configs() and len(CONFIGS) == 11


@pytest.fixture(scope="module")
def shapes():
    """Each config's weight and cache shapes on both sides (no memory: JAX
    abstract arrays, the port's meta tensors)."""
    out = {}
    for name in CONFIGS:
        jcfg, tcfg = j_get_config(name), get_config(name)
        out[name] = {
            "jax": jax.eval_shape(lambda: j_init_params(
                jax.random.PRNGKey(0), jcfg)),
            "port": sharding.param_shapes(tcfg),
            "caches": [(jax.eval_shape(lambda b=b, c=c: j_make_caches(
                jcfg, b, c)), make_caches(tcfg, b, c, device="meta"))
                for b, c in CACHE_SHAPES]}
    return out


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", CONFIGS)
def test_lep_plan_and_param_specs_match_jax(shapes, name, shape):
    """``pick_lep_plan`` (serving and not) and every weight's spec (serving
    and training) equal JAX's, leaf by leaf in JAX's tree."""
    jcfg, tcfg = j_get_config(name), get_config(name)
    mesh = _abstract(SHAPES[shape])
    if tcfg.is_moe:
        for serving in (False, True):
            assert pick_lep_plan(tcfg, SHAPES[shape], serving) \
                == j_pick_lep_plan(jcfg, mesh, serving)
    for train in (False, True):
        want = _j_flat(j_sharding.param_pspecs(jcfg, mesh,
                                               shapes[name]["jax"], train))
        got = _flat(sharding.param_pspecs(tcfg, SHAPES[shape],
                                          shapes[name]["port"], train))
        assert got == want


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", CONFIGS)
def test_cache_and_batch_specs_match_jax(shapes, name, shape):
    jcfg, tcfg = j_get_config(name), get_config(name)
    mesh = _abstract(SHAPES[shape])
    for jc, tc in shapes[name]["caches"]:
        want = _j_flat(j_sharding.cache_pspecs(jcfg, mesh, jc))
        got = _flat(sharding.cache_pspecs(tcfg, SHAPES[shape], tc))
        assert got == want
    for b in BATCHES:
        batch = {"tokens": np.zeros((b, 16), np.int32),
                 "frames": np.zeros((b, 16, 4), np.float32)}
        want = {k: tuple(v) for k, v in j_sharding.batch_pspecs(
            jcfg, mesh, batch).items()}
        assert sharding.batch_pspecs(tcfg, SHAPES[shape], batch) == want


def test_kimi_takes_the_model_axis_plan():
    """Kimi K2's 384 experts divide neither way over 16 x 16, and
    replicated over data they would take ~126.8 GB a device: EP over model,
    the FFN over data."""
    cfg = get_config("kimi-k2-1t-a32b")
    plan = dict(ep_axes=("model",), redundancy=1, ffn_shard_axis="data")
    assert pick_lep_plan(cfg, mesh_mod.PRODUCTION_SHAPE, serving=True) == plan
    assert pick_lep_plan(cfg, mesh_mod.MULTI_POD_SHAPE) \
        == plan
    r1 = get_config("deepseek-r1")
    assert pick_lep_plan(r1, mesh_mod.PRODUCTION_SHAPE) == dict(
        ep_axes=("data", "model"), redundancy=1, ffn_shard_axis=None)


class _Mesh:
    """The names a spec needs of a mesh."""
    mesh_dim_names = ("data", "model")


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Mesh()
    assert sharding.to_placements(mesh, (None, "model", "data")) == (
        Shard(2), Shard(1))
    assert sharding.to_placements(mesh, ()) == (Replicate(), Replicate())
    assert sharding.to_placements(mesh, (("data", "model"), None)) == (
        Shard(0), Shard(0))
    with pytest.raises(ValueError, match="order"):
        sharding.to_placements(mesh, (("model", "data"),))
    with pytest.raises(ValueError, match="two dimensions"):
        sharding.to_placements(mesh, ("model", "model"))


def test_mesh_context_and_axes():
    shape = mesh_mod.MULTI_POD_SHAPE
    assert parallel.get_current_mesh() is None
    assert parallel.batch_axes() == () and parallel.all_axes() == ()
    with parallel.mesh_context(shape):
        assert parallel.get_current_mesh() is shape
        assert parallel.batch_axes() == ("pod", "data")
        assert parallel.all_axes() == ("pod", "data", "model")
        assert parallel.axis_size(shape, ("data", "model")) == 256
    assert parallel.get_current_mesh() is None
    assert parallel.batch_axes({"data": 2, "model": 2}) == ("data",)
    x = np.ones(3)
    assert parallel.constrain(x, "data") is x


COST = {"flops": 3.1e13, "bytes accessed": 7.4e11}
COLL = {"all-gather": 1e9, "all-reduce": 2.5e9, "reduce-scatter": 3e8,
        "all-to-all": 4e9, "collective-permute": 0, "count": 17}


@pytest.mark.parametrize("struct_bytes", [0.0, 2.2e11])
def test_roofline_terms_equal_jax_given_its_constants(struct_bytes):
    jax_rates = dict(peak_flops=j_hlo.PEAK_FLOPS, hbm_bw=j_hlo.HBM_BW,
                     link_bw=j_hlo.ICI_BW)
    cfg, jcfg = get_config("deepseek-r1"), j_get_config("deepseek-r1")
    mf = roofline.model_flops(cfg, 4096, "train")
    assert mf == j_hlo.model_flops(jcfg, 4096, "train")
    assert roofline.model_flops(cfg, 8, "decode") \
        == j_hlo.model_flops(jcfg, 8, "decode")
    got = roofline.roofline_terms(COST, COLL, 256, mf, struct_bytes,
                                  links=4, **jax_rates)
    want = j_hlo.roofline_terms(COST, COLL, 256, mf, struct_bytes,
                                ici_links=4)
    assert got.as_dict() == want.as_dict()
    h100 = roofline.roofline_terms(COST, COLL, 256, mf, struct_bytes)
    assert h100.compute_s == COST["flops"] / 989e12
    assert h100.collective_s == 7.8e9 / 450e9


def test_decode_cost_from_roofline_defaults_to_the_h100_rate():
    """The default bandwidth is the H100's HBM rate; given JAX's, the cost
    model equals JAX's."""
    rec = {"compute_s": 0.004, "memory_s": 0.012, "collective_s": 0.002}
    kv = 2.5e8
    port = lambda **kw: dataclasses.asdict(  # noqa: E731
        decode_cost_from_roofline(rec, kv, 0.5, **kw))
    jax_ = lambda **kw: dataclasses.asdict(  # noqa: E731
        j_decode_cost_from_roofline(rec, kv, 0.5, **kw))
    assert port(hbm_bw=819e9) == jax_(hbm_bw=819e9) == jax_()
    assert roofline.HBM_BW == 3.35e12
    assert port() == jax_(hbm_bw=roofline.HBM_BW) != jax_()
    assert decode_cost_from_roofline(None, kv, 1.0) \
        == decode_cost_from_roofline(rec, 0.0, 1.0)
