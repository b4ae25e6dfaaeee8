"""The training loop shared by the stage entry points; counterpart of
``seed_story_tpu/train/runner.py``.

Each stage supplies a model, a loss function and batches; the runner owns
the trainer, the host->device prefetch, metrics, the profiler window,
checkpoints, and resume with the data pipeline's position restored. Each
logged step's line in ``metrics.jsonl`` carries its seconds (forward and
backward, update) on the device's clock, and on a card its peak memory and
the launches of the flash kernels and of kernel C (the int8 GEMM of a
``quantize_base`` base); a last line carries the final checkpoint's host
copy and write seconds. The
dropout seed of step ``s`` is ``derive_seed(seed, s)``, so a resumed run
draws exactly the masks an uninterrupted one would.

In a process group (``parallel.collectives.initialize_multihost``) the
runner trains over the ``(mesh_data, mesh_model)`` mesh of the ranks with
the preset of ``TrainConfig.sharding_preset``; each rank reads its own
batches. Rank 0 writes ``metrics.jsonl`` and the checkpoints (gathered
whole); the loss metrics it logs are their means over the ranks
(``mean_metrics``), the seconds, peak memory and kernel launches its own.
Each rank profiles its own window (rank r > 0 into ``<output_dir>/rank<r>``).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
from torch import nn

from ..data.datapipes import ThreadedLoader
from ..models.llama import derive_seed
from ..ops.attention import flash_bwd, flash_fwd
from ..ops.int8_linear import int8_gemm_kernel
from ..parallel import collectives
from ..parallel.mesh import make_mesh
from .checkpoint import CheckpointManager
from .metrics import (MetricsWriter, Profiler, Throughput, device_mark, log, seconds_between,
                      setup_logging)
from .trainer import LossFn, TrainConfig, Trainer

# the flash kernels' and kernel C's launch counts, logged per step on a card
LAUNCH_COUNTS = ("flash_fwd_launches", "flash_bwd_dq_launches", "flash_bwd_dkv_launches",
                 "int8_gemm_launches")


def kernel_launch_counts():
    """The kernels' launch counts, in the order of ``LAUNCH_COUNTS``."""
    return (flash_fwd.launches, flash_bwd.dq_launches, flash_bwd.dkv_launches,
            int8_gemm_kernel.launches)


@dataclasses.dataclass
class RunnerArgs:
    output_dir: str = "output"
    max_steps: int = 6000
    save_steps: int = 1000
    log_steps: int = 10
    resume_from_checkpoint: Optional[str] = None
    seed: int = 42
    profile_start: int = -1
    profile_stop: int = -1
    mesh_data: Optional[int] = None
    mesh_model: int = 1


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Host arrays -> tensors on ``device``; to a card through pinned memory
    with asynchronous copies."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def _stacked(it: Iterator[Dict[str, np.ndarray]], n: int):
    """Groups of n consecutive batches stacked on a leading axis."""
    while True:
        group = list(itertools.islice(it, n))
        if len(group) < n:
            return
        yield {k: np.stack([g[k] for g in group]) for k in group[0]}


def run_training(args: RunnerArgs, train_cfg: TrainConfig, model: nn.Module, loss_fn: LossFn,
                 batch_iterator: Iterator[Dict[str, np.ndarray]],
                 trainable_mask: Optional[Dict[str, bool]] = None,
                 batch_transform: Optional[Callable] = None,
                 host_metrics_fn: Optional[Callable] = None,
                 config_record: Optional[Dict] = None, data_source=None) -> Trainer:
    """Trains ``model`` (filled, on the device it trains on) for
    ``args.max_steps`` optimizer steps and returns the trainer.
    ``data_source``: an object with ``state() -> dict`` / ``set_state(dict)``
    (e.g. ``JsonlStoryDataset``) whose position is checkpointed with the
    train state and restored on resume."""
    setup_logging()
    device = next(model.parameters()).device
    mesh = make_mesh(args.mesh_data, args.mesh_model)
    trainer = Trainer(model, loss_fn, train_cfg, trainable_mask, mesh=mesh)
    rank = collectives.rank()
    writer = MetricsWriter(args.output_dir, config=config_record) if rank == 0 else None
    profiler = Profiler(args.output_dir if rank == 0 else os.path.join(args.output_dir,
                                                                       f"rank{rank}"),
                        args.profile_start, args.profile_stop)
    ckpt = CheckpointManager(args.output_dir)
    log.info("device: %s; rank %d of %d; mesh %s (%s); %d trainable of %d local parameters",
             device, rank, collectives.world_size(),
             None if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.shape)),
             trainer.preset, sum(p.numel() for p in trainer.params.values()),
             sum(p.numel() for p in model.parameters()))

    start_step = 0
    if args.resume_from_checkpoint:
        restore_dir = args.resume_from_checkpoint
        mgr = ckpt if restore_dir == args.output_dir else CheckpointManager(restore_dir)
        _, data_state = mgr.restore(trainer)
        start_step = trainer.step_count
        if data_state is not None and data_source is not None:
            data_source.set_state(data_state)
            log.info("restored data order: %s", data_state)
        log.info("resumed from step %d", start_step)

    if train_cfg.grad_accum_steps > 1:
        batch_iterator = _stacked(iter(batch_iterator), train_cfg.grad_accum_steps)
    loader = ThreadedLoader(lambda it=batch_iterator: iter(it), prefetch=2,
                            device_put_fn=lambda batch: to_device(batch, device),
                            state_fn=data_source.state if data_source is not None else None)
    throughput = Throughput()
    on_card = device.type == "cuda"
    t_start = time.time()
    step = start_step
    batches = iter(loader)
    try:
        # the step test comes before the fetch, so the loader's position (saved
        # with the checkpoint) is that of the last batch trained on
        while step < args.max_steps:
            batch = next(batches, None)
            if batch is None:
                break
            if batch_transform is not None:
                batch = batch_transform(batch)
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
                launches = kernel_launch_counts()
            marks = [device_mark(device)]
            metrics = trainer.accumulate_grads(batch, derive_seed(args.seed, step))
            marks.append(device_mark(device))
            metrics.update(trainer.apply_updates())  # the two halves of trainer.step
            marks.append(device_mark(device))
            step += 1

            profiler.maybe_step(step)
            if step % args.log_steps == 0 or step == 1:
                host = collectives.mean_metrics({k: float(v) for k, v in metrics.items()})
                fwd_bwd_s, update_s = seconds_between(marks)
                host.update(step_seconds=fwd_bwd_s + update_s, fwd_bwd_seconds=fwd_bwd_s,
                            update_seconds=update_s)
                if on_card:
                    host["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
                    host.update({name: after - before for name, before, after
                                 in zip(LAUNCH_COUNTS, launches, kernel_launch_counts())})
                host.update(throughput.tick())
                if host_metrics_fn is not None:
                    host.update(host_metrics_fn(batch, metrics))
                if writer is not None:
                    writer.log(host, step)
                log.info("step %d/%d  loss %.4f  %s", step, args.max_steps,
                         host.get("loss", float("nan")),
                         "  ".join(f"{k} {v:.4g}" for k, v in host.items() if k != "loss"))
            if step % args.save_steps == 0:
                ckpt.save(step, trainer, data_state=loader.current_state)
                log.info("queued checkpoint @ step %d", step)
    finally:
        loader.close()
        profiler.close()
    t0 = time.perf_counter()
    saved = ckpt.save(step, trainer, data_state=loader.current_state)
    t1 = time.perf_counter()
    ckpt.wait()
    if writer is not None:
        if saved:
            writer.log({"checkpoint_copy_seconds": t1 - t0,
                        "checkpoint_write_seconds": time.perf_counter() - t1}, step)
        writer.close()
    log.info("done: %d steps in %.1fs", step - start_step, time.time() - t_start)
    return trainer
