"""Plain walks over nested dict/list/tuple trees of tensors and arrays,
in the order ``jax.tree`` uses (dict keys sorted), so byte accounting and
serialization visit cache leaves in the same order as the JAX package."""
from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch


def tree_leaves(tree: Any) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over ``tree``'s structure; ``rest`` trees
    supply the matching subtree (possibly ``None``) at each leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest])
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, x, *[r[i] for r in rest])
                 for i, x in enumerate(tree)]
        # A NamedTuple (e.g. the SSM state) takes its fields positionally.
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return fn(tree, *rest)


def array_nbytes(x: Any) -> int:
    """Bytes held by a torch tensor or numpy array."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(x.size) * x.dtype.itemsize


def array_bytes(x: Any) -> np.ndarray:
    """The raw bytes of a tensor or array as a flat uint8 numpy array (any
    dtype, bf16 included; a CUDA tensor is copied to the host)."""
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)
