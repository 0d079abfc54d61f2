"""Scenario-batch sharding over the processes of a device mesh.

Counterpart of ``diffopt_tpu/parallel/sharding.py``. The scaling axis is the
batch of problem instances: each process solves its shard of the batch
locally, and reductions (losses, gradients with respect to shared
parameters, the Schur coupling of ``parallel/schur.py``) run as collectives
over the mesh's process group.

PyTorch has no global array: where the JAX package places one array over the
mesh (``jax.device_put`` with a ``NamedSharding``), each process here holds
its own slice of the leading dimension, as a plain tensor, and the mesh is a
``torch.distributed`` ``DeviceMesh`` with one process per device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type(device=None) -> str:
    """The mesh's device type: ``device``'s where the caller names one (a string or a ``torch.device``), else
    the card's where there is one, else the host's."""
    if device is not None:
        return torch.device(device).type
    return "cuda" if torch.cuda.is_available() else "cpu"


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "batch", device=None) -> DeviceMesh:
    """A 1-D mesh over the first ``n_devices`` processes of the default
    process group (all of them by default), one process per device. Every
    process of the group calls it. ``device`` names the device type of the
    mesh (``"cpu"`` keeps it on the host where there is a card); by default
    the card where there is one."""
    world = _world_size()
    n = world if n_devices is None else n_devices
    if not 0 < n <= world:
        raise ValueError(f"n_devices={n} with {world} processes")
    if n == world:
        return init_device_mesh(_device_type(device), (n,), mesh_dim_names=(axis_name,))
    return DeviceMesh(_device_type(device), torch.arange(n), mesh_dim_names=(axis_name,))


def _tree_map(fn, tree):
    """``fn`` on every tensor of a dict / list / tuple / NamedTuple / port
    dataclass; other leaves (Python scalars) are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(
            tree, **{f.name: _tree_map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)}
        )
    return tree


def shard_leading(tree: Any, index: int, count: int) -> Any:
    """Slice ``index`` of ``count`` equal slices of the leading dimension of
    every tensor of ``tree``; 0-d tensors and scalar leaves are shared and
    kept whole. The leading dimension must divide evenly (pad with
    :func:`batch_pad` first)."""

    def cut(x):
        if x.ndim == 0:
            return x
        if x.shape[0] % count:
            raise ValueError(f"leading dimension {x.shape[0]} does not split over {count} processes")
        per = x.shape[0] // count
        return x[index * per : (index + 1) * per]

    return _tree_map(cut, tree)


def shard_batch(tree: Any, mesh: DeviceMesh, axis_name: str = "batch") -> Any:
    """This process's slice of the leading (batch) dimension of every tensor
    of ``tree``, split evenly over the mesh axis ``axis_name`` in rank order
    (:func:`shard_leading`)."""
    size = mesh.size(mesh.mesh_dim_names.index(axis_name))
    return shard_leading(tree, mesh.get_local_rank(axis_name), size)


def batch_pad(tree: Any, multiple: int) -> Any:
    """Pad the leading batch dim of every leaf up to a multiple (instances are
    padded by repeating the first element so padded solves stay well-posed)."""

    def pad(x):
        if x.ndim == 0:  # scalar leaves (shared params) have no batch dim
            return x
        rem = (-x.shape[0]) % multiple
        if rem == 0:
            return x
        return torch.cat([x, x[:1].expand(rem, *x.shape[1:])], dim=0)

    return _tree_map(pad, tree)
