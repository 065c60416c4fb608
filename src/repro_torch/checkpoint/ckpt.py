"""Sharded npz checkpointing with version metadata, in the JAX package's
file layout (``checkpoint/ckpt.py``), so either package reads what the
other wrote.

A checkpoint directory holds ``manifest.json`` (``step``, ``meta``,
``n_leaves``, ``shards``) and ``shard_{i:04d}.npz`` files of leaves
``leaf_{i:05d}``, numbered in the leaf order of ``jax.tree.flatten`` over
the ``init_params`` tree: :func:`repro_torch.convert.param_tree`'s layout
(dict keys sorted, each segment's layers stacked), a new shard begun once
one holds ``shard_bytes``.

A bfloat16 leaf is stored as JAX stores it, as raw 2-byte values under the
npy type ``<V2``, and read back by its bits (int16 viewed as
``torch.bfloat16``); no ``ml_dtypes`` is needed. (The JAX package's own
``load_checkpoint`` cannot read such a leaf: ``jnp.asarray`` refuses a
``|V2`` array, so JAX round-trips only float32 trees.)
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import param_tree, params_from_jax_numpy
from repro_torch.device import DeviceLike, check_on, resolve_device
from repro_torch.models.model import Model
from repro_torch.tree import tree_leaves, tree_map

#: the npy type JAX's numpy export gives a bfloat16 array
BF16_DESCR = "<V2"


def _host_array(leaf: torch.Tensor) -> Tuple[np.ndarray, Optional[str]]:
    """(the leaf's values on the host, the npy type to record when numpy
    has none of its own)."""
    t = leaf.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), BF16_DESCR
    return t.numpy(), None


def _write_npz(fn: str, shard: Dict[str, Tuple[np.ndarray, Optional[str]]]
               ) -> None:
    """``np.savez``'s archive (stored, zip64 entries ``<key>.npy``), with a
    bfloat16 leaf's header naming ``<V2``."""
    with zipfile.ZipFile(fn, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, descr) in shard.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if descr is None:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
                    continue
                header = np.lib.format.header_data_from_array_1_0(arr)
                header["descr"] = descr
                np.lib.format.write_array_header_1_0(f, header)
                f.write(arr.tobytes())


def save_checkpoint(path: str, params: Model, step: int,
                    meta: Optional[Dict] = None, shard_bytes: int = 1 << 28,
                    device: DeviceLike = None) -> Dict:
    """Write ``params`` (a ``Model`` on ``device``: CUDA unless the caller
    names another; raises when CUDA is absent or a weight lives elsewhere)
    to ``path``; returns the manifest."""
    dev = resolve_device(device)
    for p in params.parameters():
        check_on(dev, p, "a parameter")
    os.makedirs(path, exist_ok=True)
    leaves = tree_leaves(param_tree(params))
    manifest = {"step": step, "meta": meta or {}, "n_leaves": len(leaves),
                "shards": []}
    shard: Dict[str, Tuple[np.ndarray, Optional[str]]] = {}
    shard_size = 0

    def flush():
        nonlocal shard, shard_size
        if shard:
            fn = f"shard_{len(manifest['shards']):04d}.npz"
            _write_npz(os.path.join(path, fn), shard)
            manifest["shards"].append(fn)
            shard, shard_size = {}, 0

    for i, leaf in enumerate(leaves):
        arr, descr = _host_array(leaf)
        shard[f"leaf_{i:05d}"] = (arr, descr)
        shard_size += arr.nbytes
        if shard_size >= shard_bytes:
            flush()
    flush()
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


def _leaf_value(arr: np.ndarray) -> Any:
    """A stored leaf as :func:`params_from_jax_numpy` takes it: a 2-byte
    void (bfloat16 bits) as a ``torch.bfloat16`` tensor, else the array."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return arr


def load_checkpoint(path: str, cfg: ModelConfig, device: DeviceLike = None
                    ) -> Tuple[Model, int]:
    """(a ``Model`` of ``cfg`` on ``device`` holding the checkpoint's
    weights, each cast to the model's dtype for it; the step saved).
    ``device`` is CUDA unless the caller names another; raises when CUDA is
    absent, or when the checkpoint's leaves do not fit ``cfg``."""
    dev = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves: Dict[str, np.ndarray] = {}
    for fn in manifest["shards"]:
        with np.load(os.path.join(path, fn)) as z:
            leaves.update({k: z[k] for k in z.files})
    template = param_tree(Model(cfg, torch.device("meta")))
    n = len(tree_leaves(template))
    if manifest["n_leaves"] != n or len(leaves) != n:
        raise ValueError(f"{path} holds {manifest['n_leaves']} leaves "
                         f"({len(leaves)} stored); {cfg.name} has {n}")
    index = iter(range(n))
    tree = tree_map(lambda _: _leaf_value(leaves[f"leaf_{next(index):05d}"]),
                    template)
    return params_from_jax_numpy(tree, cfg, dev), manifest["step"]
