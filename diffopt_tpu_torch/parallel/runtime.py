"""Multi-process runtime helpers.

Counterpart of ``diffopt_tpu/parallel/runtime.py``. Every process calls
:func:`initialize_multihost` once (one process per device), builds the same
mesh, and takes its shard of the scenario batch (:func:`scenario_sharding`):
data parallelism across hosts over the ``dcn`` axis, batch parallelism within
a host over the ``ici`` axis (:func:`hybrid_mesh`). The collectives are
``torch.distributed``'s: gloo for CPU tensors, NCCL for the card's. There is
no wire protocol of the package's own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .sharding import _device_type, _world_size, shard_leading


def default_backend() -> str:
    """gloo for CPU tensors and, where there is a card, NCCL for CUDA tensors."""
    return "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the default ``torch.distributed`` process group.

    The backend is :func:`default_backend`'s. Explicit arguments
    (``coordinator_address`` as ``host:port``, ``num_processes``,
    ``process_id``) are for clusters and tests; an
    explicitly requested multi-process init that fails raises. With no
    arguments the group is read from the environment a launcher such as
    ``torchrun`` sets (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); one process, or an environment that names no group, is
    a no-op, as is a group that is already initialized."""
    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_initialized():
        return
    backend = default_backend()
    if coordinator_address is None and num_processes is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return
        dist.init_process_group(backend, init_method="env://")
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("an explicit multi-process init needs coordinator_address, num_processes and process_id")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id
    )


def global_mesh(axis_names: Sequence[str] = ("batch",), shape=None, device=None) -> DeviceMesh:
    """A mesh over every process of the default group (all hosts); ``device``
    as for :func:`~.sharding.make_mesh`."""
    world = _world_size()
    shape = (world,) if shape is None else tuple(shape)
    return init_device_mesh(_device_type(device), shape, mesh_dim_names=tuple(axis_names))


def _local_world_size(world: int) -> int:
    """Processes on this host: ``LOCAL_WORLD_SIZE`` where a launcher set it, else one a card (one on a host
    without a card)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    return max(1, min(world, torch.cuda.device_count()))


def hybrid_mesh(
    dcn: Optional[int] = None,
    ici: Optional[int] = None,
    axis_names: Sequence[str] = ("dcn", "ici"),
    device=None,
) -> DeviceMesh:
    """Two-axis DCN x ICI mesh — the BASELINE layout ("DP over DCN across
    hosts, batch over ICI within a slice").

    Defaults: ``dcn`` the number of hosts (all processes over the processes
    of one host), ``ici`` the processes of one host, so collectives over the
    ``ici`` axis stay inside a host (NVLink between its cards) and only the
    ``dcn`` axis crosses the network. Ranks are laid out row-major, so each
    row of the mesh is ``ici`` consecutive ranks: the ranks of one host, as
    launchers number them.

    Shard a flat scenario batch over *both* axes with
    :func:`scenario_sharding`: the Schur coupling reduce is then one
    all-reduce over every process. ``device`` names the device type of the
    mesh, as for :func:`~.sharding.make_mesh`."""
    world = _world_size()
    if dcn is None:
        dcn = world // _local_world_size(world)
    if ici is None:
        if world % dcn:
            raise ValueError(f"{world} processes do not split over dcn={dcn}")
        ici = world // dcn
    if dcn * ici != world:
        raise ValueError(f"dcn*ici = {dcn}*{ici} != {world} processes")
    return init_device_mesh(_device_type(device), (dcn, ici), mesh_dim_names=tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class ScenarioSharding:
    """This process's place in the flat (row-major) rank order over every
    axis of a mesh: shard ``index`` of ``count``, and the process group over
    the whole mesh for the reductions (``schur``'s ``group``)."""

    index: int
    count: int
    group: object

    def shard(self, tree):
        """This process's slice of the leading (scenario) dimension of every
        tensor of ``tree`` (:func:`~.sharding.shard_leading`)."""
        return shard_leading(tree, self.index, self.count)


def scenario_sharding(mesh: DeviceMesh) -> ScenarioSharding:
    """The leading scenario / batch axis placed over every mesh axis (DCN x
    ICI jointly), trailing dims whole. Every process of the mesh calls it."""
    index = 0
    for dim, coord in enumerate(mesh.get_coordinate()):
        index = index * mesh.size(dim) + coord
    if mesh.size() == _world_size():
        group = dist.group.WORLD
    else:
        group = dist.new_group(mesh.mesh.flatten().tolist())
    return ScenarioSharding(index=index, count=mesh.size(), group=group)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Context manager: capture a ``torch.profiler`` trace of the enclosed
    block (host and, where there is a card, device activity) and write it to
    ``log_dir`` as a Chrome trace, one file a process (view it in Perfetto or
    ``chrome://tracing``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    rank = dist.get_rank() if dist.is_initialized() else 0
    prof.export_chrome_trace(os.path.join(log_dir, f"trace.rank{rank}.json"))
