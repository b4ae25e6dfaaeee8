"""The 2-D ``(data, model)`` mesh; counterpart of
``seed_story_tpu/parallel/mesh.py``.

  * ``data``: data parallelism; DDP, or ZeRO-3 / FSDP sharding of the
    parameters, gradients and AdamW moments (``parallel/sharding.py``);
  * ``model``: Megatron tensor parallelism of the LLaMA projections.

Two forms:
  * over the ranks of the initialized process group, a
    ``torch.distributed`` ``DeviceMesh`` named ``("data", "model")``
    (training, one process a rank);
  * over a list of devices in one process, a :class:`DeviceGrid` (the
    tensor-parallel decode, ``decode/tensor_parallel.py``); the list may
    name one device more than once.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from . import collectives

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """``devices[d][m]``: the device at data index d, model index m."""

    devices: List[List[torch.device]]

    @property
    def shape(self):
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: len(self.devices[0])}


def _sizes(data: Optional[int], model: int, n: int):
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} > {n} devices")
    return data, model


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None):
    """The canonical ``(data, model)`` mesh.

    With ``devices``: a :class:`DeviceGrid` over the first ``data * model``
    of them. Without: over the ranks of the process group, which must number
    exactly ``data * model`` (a mesh larger than the world is refused like
    the JAX ``data * model <= n`` check; a smaller one would leave ranks out
    of the step); ``data=None`` takes every rank not taken by ``model``.
    With no process group, a 1 x 1 mesh is None (the one-process trainer)."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        data, model = _sizes(data, model, len(devices))
        flat = devices[:data * model]
        return DeviceGrid([flat[i * model:(i + 1) * model] for i in range(data)])
    data, model = mesh_shape(data, model)
    if not collectives.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(collectives.device_type(), (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_shape(data: Optional[int] = None, model: int = 1):
    """(data, model) of the mesh over the world's ranks; refuses a mesh
    larger than the world (the JAX ``data * model <= n`` check) or one that
    leaves ranks out."""
    n = collectives.world_size()
    data, model = _sizes(data, model, n)
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} must span the world of {n} ranks")
    return data, model


def start_ranks(device, mesh_data: Optional[int] = None, mesh_model: int = 1) -> torch.device:
    """A training entry's start: the process group from the launcher's
    environment (torchrun, or COORDINATOR_ADDRESS / NUM_PROCESSES /
    PROCESS_ID; none in one process), the mesh's shape checked, and this
    rank's device (made current on a card). Ranks that share a data index
    across ``model`` read the same files (``collectives.set_data_shard``)."""
    collectives.initialize_multihost(device=device)
    data, model = mesh_shape(mesh_data, mesh_model)
    if model > 1:
        collectives.set_data_shard(collectives.rank() // model, data)
    device = collectives.local_device(device)
    if device.type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(device)
    return device
