"""Production mesh construction: the port of ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
process group (the dry run starts its fake group first).  Each builds a
``torch.distributed`` ``DeviceMesh`` over the ranks of the initialised
default group, with JAX's axis names as ``mesh_dim_names``.

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; the ``pod`` axis
carries pure data parallelism.
"""

from __future__ import annotations

from typing import Optional


def _device_type(device) -> str:
    import torch

    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def _mesh(shape, names, device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no default process group: call "
                           "torch.distributed.init_process_group first")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the default "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(_device_type(device), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(data=16, model=16), or (pod=2, data=16, model=16) with
    ``multi_pod``, over the default group's 256 or 512 ranks (the dry
    run's fake group).  ``device``: the mesh's device type (default CUDA
    when a card is present, else the CPU)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(model_parallel: int = 1, device=None):
    """(data, model) over the default group's ranks: ``model_parallel``
    ranks a model replica, the rest data parallel."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("no default process group: call "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model-parallel "
                         f"groups of {model_parallel}")
    return _mesh((max(n // model_parallel, 1), model_parallel),
                 ("data", "model"), device)


def data_axes_of(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def mesh_shape(mesh) -> Optional[dict]:
    """``{axis name: size}`` (JAX's ``dict(zip(axis_names, shape))``)."""
    if mesh is None:
        return None
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
