"""Structure-aware batch-axis ops over model cache trees.

Caches built by ``models.model.make_caches`` hold per segment an MLA latent
buffer (L, B, S, W) and a ``length`` leaf, a ``KVCache`` (k, v (L, B, S,
KV, hd), length), an ``SSMState`` (h, conv, length), or a hybrid group's
SSM state (batch on axis 2) beside its shared ``KVCache``; these helpers
slice/insert per-request rows for continuous batching and migration
(following ``cache_batch_axes``), and serialize per-token blocks of the
MLA or K/V buffers of dense and MoE segments for KV handoff. As in the JAX
package, no other segment has a token payload: SSM state is not sliceable
by token, and a hybrid's shared K/V is skipped with it. A K/V payload is
the pair ``(k, v)``, so its leaves ravel K before V, segment by segment,
as ``jax.tree.leaves`` ravels JAX's. Inserts write into the destination tensors
in place (the JAX package returns new buffers); slices return copies, so a
later in-place decode step never changes a slice already taken.
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import KVCache
from repro_torch.models.model import build_plan
from repro_torch.models.model import cache_batch_axes as _model_cache_batch_axes
from repro_torch.tree import array_bytes, array_nbytes, tree_leaves, tree_map


def cache_batch_axes(cfg: ModelConfig, caches: Dict[str, Any]) -> Dict[str, Any]:
    """Batch-axis index of every cache leaf (None = unbatched leaf, e.g.
    length scalars). Derived from cfg alone; ``caches`` is accepted for
    call-site symmetry."""
    del caches
    return _model_cache_batch_axes(cfg)


def slice_request(cfg: ModelConfig, caches, row: int):
    """Copy out one request's cache (batch dim kept = 1)."""
    axes = cache_batch_axes(cfg, caches)
    return tree_map(
        lambda leaf, ax: leaf if ax is None else
        leaf.narrow(ax, row, 1).clone(),
        caches, axes)


def insert_request(cfg: ModelConfig, caches, req_cache, row: int):
    """Write one request's cache (batch=1) into batch slot ``row`` in place;
    unbatched leaves of ``caches`` stay as they are."""
    axes = cache_batch_axes(cfg, caches)

    def put(dst, src, ax):
        if ax is not None:
            dst.narrow(ax, row, 1).copy_(src)
        return dst

    return tree_map(put, caches, req_cache, axes)


def _seq_start(start: int, length: int, cap: int) -> int:
    # dynamic_slice semantics: the start is clamped so the window fits.
    return min(max(start, 0), cap - length)


def seq_slice(cfg: ModelConfig, caches, start: int, length: int):
    """``length`` tokens of sequence state from offset ``start`` (a view of
    each MLA segment's buffer, or a ``(k, v)`` pair of views) -- the
    payload unit of chunked handoff."""
    def take(buf):
        return buf.narrow(2, _seq_start(start, length, buf.shape[2]), length)

    out = {}
    for seg in build_plan(cfg):
        if seg.kind not in ("dense", "moe"):
            continue
        c = caches[seg.name]
        out[seg.name] = (take(c["mla"]) if cfg.attention_kind == "mla"
                         else (take(c.k), take(c.v)))
    return out


def seq_insert(cfg: ModelConfig, caches, payload: Dict[str, Any], start: int):
    """Insert a seq_slice payload back at token offset ``start`` (in place)."""
    new = dict(caches)
    for seg in build_plan(cfg):
        if seg.name not in payload:
            continue
        c = caches[seg.name]
        pairs = ([(c["mla"], payload[seg.name])]
                 if cfg.attention_kind == "mla"
                 else list(zip((c.k, c.v), payload[seg.name])))
        for buf, pl in pairs:
            buf.narrow(2, _seq_start(start, pl.shape[2], buf.shape[2]),
                       pl.shape[2]).copy_(pl)
        new[seg.name] = (dict(c) if cfg.attention_kind == "mla"
                         else KVCache(c.k, c.v, c.length))
    return new


def pack_blocks(cfg: ModelConfig, caches, n_blocks: int,
                block: int) -> List[np.ndarray]:
    """Every block payload for tokens [0, n_blocks*block) in one slice and
    one copy to the host. Row ``bi`` is byte-identical to
    ``pack_payload(seq_slice(cfg, caches, bi*block, block))``."""
    if n_blocks <= 0:
        return []
    payload = seq_slice(cfg, caches, 0, n_blocks * block)
    rows = []
    for leaf in tree_leaves(payload):
        # leaf: (L, B, n_blocks*block, ...) -- bring the block index to the
        # front so row ``bi`` ravels like the single-block payload.
        l, b = leaf.shape[0], leaf.shape[1]
        x = leaf.reshape((l, b, n_blocks, block) + tuple(leaf.shape[3:]))
        rows.append(x.movedim(2, 0).float().reshape(n_blocks, -1))
    flat = torch.cat(rows, dim=1).cpu().numpy()
    return [flat[bi] for bi in range(n_blocks)]


def payload_token_nbytes(cfg: ModelConfig, caches) -> int:
    """Stored bytes per cached token: the size of a one-token
    :func:`seq_slice` payload as :func:`pack_payload` serializes it
    (float32 storage)."""
    payload = seq_slice(cfg, caches, 0, 1)
    return sum(leaf.numel() for leaf in tree_leaves(payload)) * 4


def fingerprint(payload: Any) -> int:
    """Order-stable CRC32 over every array leaf's raw bytes -- the
    integrity check the transfer engine verifies on delivery. Non-array
    leaves are skipped."""
    crc = 0
    for leaf in tree_leaves(payload):
        if hasattr(leaf, "dtype"):
            crc = zlib.crc32(array_bytes(leaf).tobytes(), crc)
    return crc


def pack_request(cfg: ModelConfig, req_slice) -> np.ndarray:
    """Serialize one request's cache slice (a :func:`slice_request` result)
    into a contiguous byte buffer -- the drain unit of cross-engine KV
    migration. Only batched leaves are packed. Bytes are *viewed*, not
    cast, so the round trip through :func:`unpack_request` is bit-exact for
    every dtype."""
    axes = cache_batch_axes(cfg, req_slice)
    parts: List[np.ndarray] = []
    tree_map(lambda leaf, ax: None if ax is None else
             parts.append(array_bytes(leaf)), req_slice, axes)
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)


def unpack_request(cfg: ModelConfig, flat: np.ndarray, template):
    """Inverse of :func:`pack_request`. ``template`` is a shape/dtype/device
    reference slice from the *destination* engine; its unbatched leaves
    pass through unchanged."""
    axes = cache_batch_axes(cfg, template)
    batched: List[Any] = []
    tree_map(lambda leaf, ax: None if ax is None else batched.append(leaf),
             template, axes)
    expected = sum(array_nbytes(leaf) for leaf in batched)
    if expected != flat.size:
        raise ValueError(
            f"migration payload of {flat.size} bytes does not match the "
            f"destination cache layout ({expected} bytes expected)")
    offset = [0]

    def _take(leaf, ax):
        if ax is None:
            return leaf
        n = leaf.numel() * leaf.element_size()
        raw = bytearray(flat[offset[0]:offset[0] + n].tobytes())
        offset[0] += n
        t = torch.frombuffer(raw, dtype=torch.uint8) if n else \
            torch.zeros(0, dtype=torch.uint8)
        return t.view(leaf.dtype).reshape(leaf.shape).to(leaf.device)

    return tree_map(_take, template, axes)


def pack_payload(payload: Dict[str, Any]) -> np.ndarray:
    """Flatten a seq_slice payload to one contiguous float32 buffer."""
    leaves = [leaf.float().reshape(-1).cpu().numpy()
              for leaf in tree_leaves(payload)]
    return np.concatenate(leaves) if leaves else np.zeros(0, np.float32)


def unpack_payload(flat: np.ndarray, template: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`pack_payload` against a seq_slice-shaped template
    (float32 tensors on the template's device)."""
    off = [0]

    def _take(leaf):
        n = leaf.numel()
        arr = np.asarray(flat[off[0]:off[0] + n], np.float32)
        off[0] += n
        return torch.from_numpy(arr.copy()).reshape(leaf.shape).to(leaf.device)

    return tree_map(_take, template)
