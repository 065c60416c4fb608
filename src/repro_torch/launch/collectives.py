"""Collective bytes of a step, counted as the step issues them: the port of
the collective half of the JAX package's ``launch/hlo_analysis.py``.

JAX reads its collectives out of the compiled per-device HLO text
(``collective_bytes``). PyTorch has no such program: a step traced over
DTensors issues its collectives as it runs. :class:`CollectiveCounter` is
a ``TorchDispatchMode`` that sees every one this rank issues, both those
that DTensor's sharding propagation inserts (the ``_c10d_functional`` ops
and ``_dtensor.shard_dim_alltoall``) and those that the port's parallel
paths call themselves through ``torch.distributed``
(``core/parallel.py``: ``all_to_all_single``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce``), and adds each one's output
bytes on this rank to its kind, as ``hlo_analysis.py`` sums the output
shapes of the HLO's collectives. A point-to-point transfer
(``core/parallel.send_recv``) counts as a collective permute: each batch
of sends and receives is one permute, whose bytes on a rank are the larger
of what the rank sends and what it receives in that batch, as a permute's
output (what XLA counts) is sent by one rank while another receives it.
A collective it cannot name raises, so none goes uncounted.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core import parallel
from repro_torch.launch.roofline import COLLECTIVE_OPS

#: operator name -> the kind of ``COLLECTIVE_OPS`` it counts under
KIND: Dict[str, str] = {}
for _kind, _names in {
        "all-gather": ("_c10d_functional::all_gather_into_tensor",
                       "_c10d_functional::all_gather_into_tensor_out",
                       "_c10d_functional::all_gather_into_tensor_coalesced",
                       "_c10d_functional_autograd::all_gather_into_tensor",
                       "c10d::_allgather_base_", "c10d::allgather_",
                       "c10d::allgather_into_tensor_coalesced_"),
        "all-reduce": ("_c10d_functional::all_reduce",
                       "_c10d_functional::all_reduce_",
                       "_c10d_functional::all_reduce_coalesced",
                       "_c10d_functional::all_reduce_coalesced_",
                       "c10d::allreduce_", "c10d::allreduce_coalesced_"),
        "reduce-scatter": (
            "_c10d_functional::reduce_scatter_tensor",
            "_c10d_functional::reduce_scatter_tensor_coalesced",
            "_c10d_functional_autograd::reduce_scatter_tensor",
            "c10d::_reduce_scatter_base_", "c10d::reduce_scatter_",
            "c10d::reduce_scatter_tensor_coalesced_"),
        "all-to-all": ("_c10d_functional::all_to_all_single",
                       "_c10d_functional_autograd::all_to_all_single",
                       "_dtensor::shard_dim_alltoall",
                       "c10d::alltoall_base_", "c10d::alltoall_"),
        "collective-permute": ("c10d::send", "c10d::recv_"),
}.items():
    for _name in _names:
        KIND[_name] = _kind

#: operators of the collective namespaces that move no data
_NO_DATA = ("_c10d_functional::wait_tensor",
            "_c10d_functional::_wrap_tensor_autograd", "c10d::barrier",
            "c10d::monitored_barrier_")
_NAMESPACES = ("c10d::", "_c10d_functional::", "_c10d_functional_autograd::",
               "_dtensor::")


def zero_counts() -> Dict[str, int]:
    """JAX's keys: every kind of ``COLLECTIVE_OPS`` and ``count``, at 0."""
    return {**{k: 0 for k in COLLECTIVE_OPS}, "count": 0}


def _nbytes(tensors: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tensors)
               if isinstance(t, torch.Tensor))


class CollectiveCounter(TorchDispatchMode):
    """Inside the block, ``counts`` holds the output bytes on this rank of
    every collective issued, by kind (``COLLECTIVE_OPS``), and their
    ``count``; ``largest`` the bytes of the largest single one of each
    kind. The functional ops' output is what they return; the
    ``c10d`` ops write their first argument. Ops on DTensors are left to
    DTensor, whose local ops (its collectives among them) come back here;
    the ops it runs on fake tensors to propagate shapes are not counted.
    Subclasses see every local op through :meth:`record`."""

    def __init__(self):
        super().__init__()
        self.counts = zero_counts()
        self.largest = {k: 0 for k in COLLECTIVE_OPS}
        # the permute bytes of the batches before the current one, the
        # current batch's number and its bytes sent and received
        self._permuted, self._batch = 0, None
        self._p2p = {"c10d::send": 0, "c10d::recv_": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or any(
                isinstance(t, FakeTensor) for t in tree_leaves(out)):
            return out
        name = func._schema.name
        if name.startswith(_NAMESPACES) and name not in _NO_DATA:
            if name not in KIND:
                raise NotImplementedError(f"uncounted collective {name}")
            kind = KIND[name]
            nbytes = _nbytes(args[0] if name.startswith("c10d::") else out)
            if name in self._p2p:
                if self._batch != parallel.p2p_batches:
                    self._batch = parallel.p2p_batches
                    self._permuted = self.counts[kind]
                    self._p2p = dict.fromkeys(self._p2p, 0)
                self._p2p[name] += nbytes
                self.counts[kind] = self._permuted + max(self._p2p.values())
            else:
                self.counts[kind] += nbytes
            self.largest[kind] = max(self.largest[kind], nbytes)
            self.counts["count"] += 1
        self.record(func, args, kwargs, out)
        return out

    def record(self, func, args, kwargs, out) -> None:
        """Called with every local op, collectives included."""
