"""Production mesh shapes and builders.

Counterpart of ``repro.launch.mesh``.  The reference lays a pod of 256
chips out as a (16, 16) ``("data", "model")`` mesh, and two pods as
(2, 16, 16) ``("pod", "data", "model")`` (pure data parallelism across
pods); ``elastic_mesh`` builds the degraded (n / model, model) layout
left after losing hosts.  The shapes are pure functions here; a
``torch.distributed`` ``DeviceMesh`` of a shape is built only when the
initialised default process group has exactly that many ranks, and
otherwise the builders raise.
"""

from __future__ import annotations

import math

__all__ = ["production_mesh_shape", "elastic_mesh_shape",
           "make_production_mesh", "elastic_mesh", "sht_axis_names"]


def production_mesh_shape(*, multi_pod: bool = False) -> tuple:
    """``(shape, axis names)`` of the production mesh: one pod or two."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def elastic_mesh_shape(n_devices: int, *, model: int = 16) -> tuple:
    """``(shape, axis names)`` of the degraded mesh over ``n_devices``
    (a multiple of ``model``)."""
    if model < 1 or n_devices < model or n_devices % model:
        raise ValueError(f"an elastic mesh needs a positive multiple of "
                         f"model={model} devices, got {n_devices}")
    return (n_devices // model, model), ("data", "model")


def _device_mesh(shape: tuple, axes: tuple, device_type: str):
    """A ``DeviceMesh`` of ``shape`` over the default process group, which
    must hold exactly ``prod(shape)`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(
            f"a {shape} {axes} mesh needs an initialised default process "
            f"group of {need} ranks; "
            + (f"it has {have}" if have else "none is initialised"))
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production ``DeviceMesh`` (256 or 512 ranks)."""
    return _device_mesh(*production_mesh_shape(multi_pod=multi_pod),
                        device_type)


def elastic_mesh(n_devices: int, *, model: int = 16,
                 device_type: str = "cuda"):
    """The degraded-topology ``DeviceMesh`` over ``n_devices`` ranks."""
    return _device_mesh(*elastic_mesh_shape(n_devices, model=model),
                        device_type)


def sht_axis_names(mesh) -> tuple:
    """The SHT flattens every mesh axis into one process ring: the axis
    names of a ``DeviceMesh`` (``mesh_dim_names``) or of anything with
    ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return tuple(names)
