"""Device meshes: the port of the JAX package's ``launch/mesh.py``.

The production layouts are given as shapes (axis name -> size): one pod of
16 x 16 ranks over ``("data", "model")``, the CloudMatrix384 supernode's
analogue, and two pods, 2 x 16 x 16 with a leading ``"pod"`` axis (the
paper's RDMA scale-out plane; TP and EP stay inside a pod). They feed
:func:`repro_torch.core.lep.pick_lep_plan` and the specs of
:mod:`repro_torch.launch.sharding`, which need no ranks.

:func:`make_debug_mesh` builds a real ``DeviceMesh`` over the default
process group, which the caller has initialised
(``torch.distributed.init_process_group``) with ``n_data * n_model`` ranks.
"""
from __future__ import annotations

from typing import Dict

PRODUCTION_SHAPE: Dict[str, int] = {"data": 16, "model": 16}
MULTI_POD_SHAPE: Dict[str, int] = {"pod": 2, "data": 16, "model": 16}


def make_debug_mesh(n_data: int = 2, n_model: int = 4,
                    device_type: str = "cpu"):
    """A ``("data", "model")`` mesh of ``n_data x n_model`` ranks, laid out
    rank-major: rank = data index x n_model + model index, the order in
    which JAX's ``P(("data", "model"))`` flattens the token axis."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))
