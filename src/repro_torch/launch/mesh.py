"""Mesh construction: the twin of ``repro/launch/mesh.py``.

Functions, not module-level constants: importing this module touches no
device and starts no process group.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group's ranks, its dims named by the ``MeshConfig``'s axes.
"""
from __future__ import annotations

from repro_torch.configs.base import MULTI_POD_MESH, SINGLE_POD_MESH, MeshConfig


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD_MESH if multi_pod else SINGLE_POD_MESH


def make_mesh_from_config(cfg: MeshConfig, device_type: str = "cuda"):
    """``init_device_mesh(device_type, cfg.shape, mesh_dim_names=cfg.axes)``
    over the default process group (the caller starts it: NCCL on the
    card, gloo for ``"cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(cfg.shape),
                            mesh_dim_names=tuple(cfg.axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh, 16 x 16 (data, model) or 2 x 16 x 16 (pod,
    data, model).  Raises unless the default process group has exactly
    that many ranks: it never builds a smaller mesh."""
    import torch.distributed as dist
    cfg = mesh_config(multi_pod=multi_pod)
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != cfg.num_devices:
        have = ("no process group" if world is None
                else f"a process group of {world} ranks")
        raise RuntimeError(
            f"the {'multi' if multi_pod else 'single'}-pod production mesh "
            f"{cfg.shape} needs a process group of {cfg.num_devices} ranks; "
            f"this process has {have}")
    return make_mesh_from_config(cfg, device_type)
