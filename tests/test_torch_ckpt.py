"""The port's checkpoints against the JAX package's file layout: float32
checkpoints cross between the two packages bit for bit in both
directions, a multi-shard round trip within the port (as
``tests/test_train.py`` holds JAX's), and bfloat16 leaves written as JAX
writes them (``<V2``) and read back by their bits, JAX's own files
included."""
import zipfile

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.checkpoint import load_checkpoint as j_load_checkpoint
from repro.checkpoint import save_checkpoint as j_save_checkpoint
from repro.models import init_params as j_init_params
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import param_tree, params_from_jax_numpy
from repro_torch.models import init_params
from repro_torch.tree import tree_leaves


def _bits(x):
    """The raw bits of a numpy array or tensor, for bit-equality."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def _assert_bit_equal(a_leaves, b_leaves):
    a_leaves, b_leaves = list(a_leaves), list(b_leaves)
    assert len(a_leaves) == len(b_leaves)
    for a, b in zip(a_leaves, b_leaves):
        a, b = _bits(a), _bits(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def olmoe():
    cfg = smoke("olmoe-1b-7b")
    tcfg = smoke_variant(get_config("olmoe-1b-7b"))
    jp = j_init_params(jax.random.PRNGKey(3), cfg)
    return cfg, tcfg, jp


def test_jax_float32_checkpoint_loads_bit_equal(olmoe, tmp_path):
    cfg, tcfg, jp = olmoe
    man = j_save_checkpoint(str(tmp_path), jp, 7, meta={"arch": cfg.name},
                            shard_bytes=1 << 20)
    assert len(man["shards"]) > 1
    model, step = load_checkpoint(str(tmp_path), tcfg, "cpu")
    assert step == 7
    _assert_bit_equal(tree_leaves(param_tree(model)), jax.tree.leaves(jp))


def test_port_float32_checkpoint_loads_bit_equal_in_jax(olmoe, tmp_path):
    cfg, tcfg, jp = olmoe
    model = init_params(tcfg, seed=5, device="cpu")
    man = save_checkpoint(str(tmp_path), model, 4, meta={"arch": cfg.name},
                          shard_bytes=1 << 20, device="cpu")
    assert len(man["shards"]) > 1
    loaded, step = j_load_checkpoint(str(tmp_path), jp)
    assert step == 4
    _assert_bit_equal(jax.tree.leaves(loaded),
                      tree_leaves(param_tree(model)))
    jman = j_save_checkpoint(str(tmp_path / "jax"), loaded, 4,
                             meta={"arch": cfg.name}, shard_bytes=1 << 20)
    assert jman == man                      # the same manifest, shard for shard


def test_checkpoint_roundtrip_multi_shard(olmoe, tmp_path):
    """The port's own round trip, as ``tests/test_train.py`` holds JAX's."""
    _, tcfg, jp = olmoe
    model = params_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    man = save_checkpoint(str(tmp_path), model, 7, meta={"arch": tcfg.name},
                          shard_bytes=1 << 20, device="cpu")
    assert len(man["shards"]) > 1
    back, step = load_checkpoint(str(tmp_path), tcfg, "cpu")
    assert step == 7
    _assert_bit_equal(tree_leaves(param_tree(back)),
                      tree_leaves(param_tree(model)))


def _bf16(arch):
    cfg = smoke(arch)
    tcfg = smoke_variant(get_config(arch))
    return (cfg.__class__(**{**cfg.__dict__, "dtype": "bfloat16"}),
            tcfg.__class__(**{**tcfg.__dict__, "dtype": "bfloat16"}))


@pytest.mark.parametrize("arch", ["mamba2-780m", "olmoe-1b-7b"])
def test_bf16_roundtrip_within_the_port(arch, tmp_path):
    """bfloat16 leaves (Mamba2's float32 ``A_log``/``D``/``dt_bias``
    beside them) come back bit for bit; each bfloat16 entry's npy header
    names ``<V2``, as JAX's numpy export does, and numpy with
    ``ml_dtypes`` reads the same values."""
    _, tcfg = _bf16(arch)
    model = init_params(tcfg, seed=1, device="cpu")
    man = save_checkpoint(str(tmp_path), model, 2, shard_bytes=1 << 20,
                          device="cpu")
    back, _ = load_checkpoint(str(tmp_path), tcfg, "cpu")
    leaves = tree_leaves(param_tree(model))
    _assert_bit_equal(tree_leaves(param_tree(back)), leaves)
    assert {t.dtype for t in leaves} >= {torch.bfloat16}
    stored = {}
    for fn in man["shards"]:
        with zipfile.ZipFile(tmp_path / fn) as zf:
            for name in zf.namelist():
                head = zf.read(name)[:128]
                stored[name[:-4]] = b"'descr': '<V2'" in head
        with np.load(tmp_path / fn) as z:
            for k in z.files:
                i = int(k.split("_")[1])
                if leaves[i].dtype == torch.bfloat16:
                    np.testing.assert_array_equal(
                        z[k].view(ml_dtypes.bfloat16).astype(np.float32),
                        leaves[i].float().numpy())
    assert stored == {f"leaf_{i:05d}": t.dtype == torch.bfloat16
                      for i, t in enumerate(leaves)}


def test_jax_written_bf16_checkpoint_read_by_its_bits(tmp_path):
    """A bfloat16 tree saved by JAX (raw ``<V2`` bytes) loads into the
    port bit for bit; JAX's own ``load_checkpoint`` cannot read it back
    (``jnp.asarray`` refuses a ``|V2`` array)."""
    cfg, tcfg = _bf16("granite-3-2b")
    jp = j_init_params(jax.random.PRNGKey(2), cfg)
    j_save_checkpoint(str(tmp_path), jp, 9)
    model, step = load_checkpoint(str(tmp_path), tcfg, "cpu")
    assert step == 9
    _assert_bit_equal(tree_leaves(param_tree(model)), jax.tree.leaves(jp))
    with pytest.raises(TypeError):
        j_load_checkpoint(str(tmp_path), jp)


def test_load_refuses_another_config(olmoe, tmp_path):
    cfg, _, jp = olmoe
    j_save_checkpoint(str(tmp_path), jp, 1)
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(str(tmp_path),
                        smoke_variant(get_config("granite-3-2b")), "cpu")
