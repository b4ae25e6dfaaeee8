"""Distributed primitives on ``torch.distributed``; counterpart of
``seed_story_tpu/parallel/collectives.py`` (the reference's dist_utils
surface).

  * inside a step: ``all_gather`` (tiled along dim 0, with a gradient)
    and ``concat_all_gather`` (no gradient, as ``torch.distributed``'s own
    gather), ``pmean``; ``global_mean`` takes a ratio's denominator over
    the data-parallel group of a running step, so that every rank's loss is
    its share of the global batch's loss;
  * on the host across processes: ``process_allgather`` / ``mean_metrics``;
  * ``initialize_multihost`` starts the process group from the launcher's
    environment.

Each is the identity when no process group is initialized, like the JAX
functions in a single process. ``group`` arguments take a process group,
or an axis name of the ``data_parallel`` context (``"data"``).
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

_STEP_GROUPS: Dict[str, object] = {}


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


_DATA_SHARD: Optional[tuple] = None


def set_data_shard(index: int, count: int) -> None:
    """Makes (index, count) the default data shard of this process: the
    training entries set (data index, data size) when ranks of one data
    index share their batches across the ``model`` axis."""
    global _DATA_SHARD
    _DATA_SHARD = (index, count)


def data_shard():
    """(index, count) of the files this process reads: what
    :func:`set_data_shard` set, else (rank, world size)."""
    return _DATA_SHARD if _DATA_SHARD is not None else (rank(), world_size())


@contextlib.contextmanager
def data_parallel(groups: Dict[str, object]):
    """Binds axis names (``"data"``, ``"model"``) to process groups for the
    duration of a step, as a ``shard_map`` binds its mesh axes."""
    saved = dict(_STEP_GROUPS)
    _STEP_GROUPS.update(groups)
    try:
        yield
    finally:
        _STEP_GROUPS.clear()
        _STEP_GROUPS.update(saved)


def resolve_group(group):
    """A process group from ``group``: a group, an axis name bound by
    :func:`data_parallel` (else the default group), or None. An axis name
    with no initialized process group is refused, as JAX refuses an unbound
    axis name."""
    if group is None or not isinstance(group, str):
        return group
    if not is_initialized():
        raise ValueError(f"axis name {group!r}: no process group is initialized "
                         "(torch.distributed.init_process_group)")
    return _STEP_GROUPS.get(group, dist.group.WORLD)


def bound_group(axis: str):
    """The process group bound to ``axis`` by a running step, else None."""
    return _STEP_GROUPS.get(axis)


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along dim 0; the gradient of a rank's rows is the
    sum over ranks of the gradient at those rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        out = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(out, x.contiguous(), group=group)
        return torch.cat(out, dim=0)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        r = dist.get_rank(ctx.group)
        b = g.shape[0] // dist.get_world_size(ctx.group)
        return g[r * b:(r + 1) * b], None


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """(b, ...) on each rank -> (world * b, ...) in rank order; identity
    when ``group`` is None."""
    group = resolve_group(group)
    if group is None:
        return x
    return _AllGather.apply(x, group)


def concat_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """``all_gather`` without a gradient (the reference's no-grad gather)."""
    group = resolve_group(group)
    if group is None:
        return x.detach()
    with torch.no_grad():
        out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, x.detach().contiguous(), group=group)
    return torch.cat(out, dim=0)


def gather_rows(local: torch.Tensor, rows: int, group) -> torch.Tensor:
    """The ranks' equal row blocks ``local`` of ``group`` joined along dim
    0 in rank order and cut to the first ``rows`` (a padded dim-0 shard made
    whole again); no gradient. A collective; int8 travels as int8."""
    out = local.new_empty((dist.get_world_size(group) * local.shape[0], *local.shape[1:]))
    dist.all_gather_into_tensor(out, local.contiguous(), group=group)
    return out[:rows]


def group_rank(group=None) -> int:
    """This process's rank in ``group`` (0 when it is None)."""
    group = resolve_group(group)
    return 0 if group is None else dist.get_rank(group)


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the ranks of ``group`` (no gradient path); identity when
    it is None."""
    group = resolve_group(group)
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out / dist.get_world_size(group)


def global_mean(numerator: torch.Tensor, denominator: torch.Tensor,
                floor: Optional[float] = None) -> torch.Tensor:
    """``numerator / denominator`` (the denominator clamped at ``floor``)
    where the denominator counts over the global batch: inside a step bound
    to a data-parallel group of n ranks, ``n * numerator / sum over ranks of
    denominator`` (no gradient through the sum), so that the mean of the
    ranks' values and of their gradients is the global batch's ratio, as
    the JAX step computes it over its sharded batch. Outside such a step, or
    with one rank, the plain ratio."""
    group = bound_group("data")
    if group is None or dist.get_world_size(group) == 1:
        return numerator / (denominator if floor is None else denominator.clamp_min(floor))
    total = denominator.detach().to(torch.float32).clone()
    dist.all_reduce(total, group=group)
    if floor is not None:
        total = total.clamp_min(floor)
    return numerator * dist.get_world_size(group) / total.to(denominator.dtype)


_DEVICE_TYPE: Optional[str] = None


def device_type() -> str:
    """The kind of device the ranks compute on ("cuda" or "cpu"): the one
    :func:`initialize_multihost` started the group for (gloo may join CUDA
    ranks, as two processes sharing one card do), else the backend's."""
    if _DEVICE_TYPE is not None:
        return _DEVICE_TYPE
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def default_backend(device) -> str:
    """``nccl`` for CUDA, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device="cuda",
                         backend: Optional[str] = None):
    """Starts the default process group for a multi-process run and returns
    (rank, world size). Arguments fall back to COORDINATOR_ADDRESS /
    NUM_PROCESSES / PROCESS_ID (the JAX launcher contract), then to
    torchrun's MASTER_ADDR:MASTER_PORT / WORLD_SIZE / RANK. Nothing to do
    in a single process (no address) or when the group is already up; any
    other failure raises: quietly going on as one process would desync a
    real multi-process launch instead of aborting it. ``backend`` None picks
    ``nccl`` for a CUDA ``device``, ``gloo`` for the CPU; the device's kind
    is kept for the meshes (:func:`device_type`)."""
    env = os.environ
    addr = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if addr is None and env.get("MASTER_ADDR"):
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if addr and not is_initialized():
        global _DEVICE_TYPE
        _DEVICE_TYPE = torch.device(device).type
        if num_processes is None:
            num_processes = int(env.get("NUM_PROCESSES", env.get("WORLD_SIZE", 1)))
        if process_id is None:
            process_id = int(env.get("PROCESS_ID", env.get("RANK", 0)))
        init = addr if "://" in addr else f"tcp://{addr}"
        dist.init_process_group(backend or default_backend(device), init_method=init,
                                world_size=num_processes, rank=process_id,
                                timeout=datetime.timedelta(minutes=30))
    return rank(), world_size()


def local_device(device="cuda") -> torch.device:
    """This process's device: for CUDA, the card of its local rank
    (LOCAL_RANK, else the rank) modulo the visible cards, so that two ranks
    may share one card; the device itself otherwise."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", rank()))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def process_allgather(x) -> torch.Tensor:
    """(world, ...) stack of every process's ``x`` (host-side: metrics,
    eval shards)."""
    t = torch.as_tensor(x)
    if not is_initialized():
        return t[None]
    out = [None] * world_size()
    dist.all_gather_object(out, t.cpu())
    return torch.stack(out)


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (``obj`` itself in one process)."""
    if not is_initialized() or world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def mean_metrics(metrics: Dict[str, float]) -> Dict[str, float]:
    """Cross-process mean of scalar metrics (the reference's all-gathered
    means, train_clm_sft.py:99-108)."""
    if not is_initialized() or world_size() == 1:
        return {k: float(v) for k, v in metrics.items()}
    keys = sorted(metrics)
    values = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64)
    gathered = process_allgather(values)
    return {k: float(v) for k, v in zip(keys, gathered.mean(dim=0))}


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward; identity gradient (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel product: whole on every rank, its
    gradient the sum of the ranks' partial gradients."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of the ranks' partial outputs of a
    row-parallel product."""
    return _ReduceFromGroup.apply(x, group)
