"""Checkpoint / resume; counterpart of ``seed_story_tpu/train/checkpoint.py``.

A checkpoint is one directory per step, ``<dir>/<step>/``, holding
``params.pt`` (the model's whole state dict), ``opt_state.pt`` (the
trainer's whole moments and step) and ``meta.json`` (the step and each
rank's data pipeline position). Under a mesh the shards are gathered and
rank 0 writes (``Trainer.full_state``: FSDP's dim-0 shards, the
tensor-parallel slices, the vocabulary's among them, and a ``quantize_base``
base's int8 row slices over ``data``), so a run saved at one mesh resumes
at another, or in one process.
``save`` takes a consistent host copy of the state, then a
background thread writes it under ``<dir>/<step>.tmp`` and renames it when
whole, so only complete checkpoints carry a step's name; ``wait`` joins
that thread. The newest ``max_to_keep`` checkpoints are kept.

``load_params_partial`` is the reference's ``from_pretrained(strict=False)``:
the entries of a saved state dict overwrite matching entries of a target,
and the missing and unexpected names are reported. An int8 entry never
lands in a floating-point target, nor a floating-point entry in an int8
one: a ``quantize_base`` checkpoint's int8 weights load into a quantized
model, a float checkpoint into a float one (quantized afterwards).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..parallel import collectives
from .trainer import Trainer, to_host

log = logging.getLogger("seed_story_torch")

PARAMS, OPT_STATE, META = "params.pt", "opt_state.pt", "meta.json"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def steps(self) -> List[int]:
        """Steps with a complete checkpoint, oldest first."""
        return sorted(int(name) for name in os.listdir(self.directory) if name.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, trainer: Trainer, data_state: Optional[Dict] = None) -> bool:
        """Queues a checkpoint of ``trainer`` (model parameters, optimizer
        state, step) at ``step``; False when that step is already saved.
        In a process group every rank calls it: the state is gathered whole
        (``Trainer.full_state``) and rank 0 writes it, with every rank's
        ``data_state`` (``data_states``, in rank order, beside rank 0's)."""
        self.wait()
        if collectives.broadcast_object(step in self.steps()):  # rank 0's view of the disk
            return False
        params, opt_state = trainer.full_state()
        data_states = [data_state]
        if collectives.world_size() > 1:
            data_states = [None] * collectives.world_size()
            torch.distributed.all_gather_object(data_states, data_state)
        if collectives.rank() != 0:
            return True
        meta = {"step": step, "data_state": data_states[0]}
        if len(data_states) > 1:
            meta["data_states"] = data_states
        self._thread = threading.Thread(target=self._write, args=(step, params, opt_state, meta),
                                        name=f"checkpoint-{step}")
        self._thread.start()
        return True

    def _write(self, step, params, opt_state, meta):
        try:
            tmp = os.path.join(self.directory, f"{step}.tmp")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(params, os.path.join(tmp, PARAMS))
            torch.save(opt_state, os.path.join(tmp, OPT_STATE))
            with open(os.path.join(tmp, META), "w") as f:
                json.dump(meta, f)
            os.replace(tmp, os.path.join(self.directory, str(step)))
            for old in self.steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        except Exception as e:  # re-raised by wait() on the caller's thread
            self._error = e

    def wait(self) -> None:
        """Blocks until the queued checkpoint is on disk; raises its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from error

    def restore(self, trainer: Trainer, step: Optional[int] = None) -> Tuple[Optional[int],
                                                                             Optional[Dict]]:
        """Loads the checkpoint at ``step`` (default: the latest) into
        ``trainer`` and its model, whatever world size wrote it. Returns
        (step, data_state): this rank's saved position when the world size
        is the one that saved it, else rank 0's (a data pipeline sharded
        differently reads other files). (None, None) when there is no
        checkpoint."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        path = os.path.join(self.directory, str(step))
        trainer.load_full_state(
            torch.load(os.path.join(path, PARAMS), map_location="cpu", weights_only=True),
            torch.load(os.path.join(path, OPT_STATE), map_location="cpu", weights_only=True))
        with open(os.path.join(path, META)) as f:
            meta = json.load(f)
        states = meta.get("data_states") or [meta["data_state"]]
        if len(states) == collectives.world_size():
            return step, states[collectives.rank()]
        if meta["data_state"] is not None:
            log.warning("checkpoint of %d ranks restored at %d: every rank resumes rank 0's "
                        "data position", len(states), collectives.world_size())
        return step, meta["data_state"]


def save_params(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """A standalone parameter file (the handoff between stages)."""
    torch.save(to_host(state_dict), path)


def load_params_partial(path: str, target: Dict[str, torch.Tensor]
                        ) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """strict=False load: the entries of the state dict saved at ``path`` (a
    parameter file, or a checkpoint directory's ``params.pt``) overwrite the
    entries of ``target`` with the same name and shape, cast to the target's
    dtype and device. Returns (merged, missing, unexpected) and prints their
    counts, as the JAX ``load_params_partial`` does; an entry whose shape
    differs counts as missing, and so does one that is int8 where the target
    is floating point or the other way round (never cast: int8 values read as
    float weights, or float weights truncated to int8, are wrong without any
    error). A file that shares no entry with ``target`` raises ValueError."""
    merged, missing, unexpected = _merge(_read(path), target, path)
    _report(path, missing, unexpected)
    return merged, missing, unexpected


def _read(path: str) -> Dict[str, torch.Tensor]:
    if os.path.isdir(path):
        path = os.path.join(path, PARAMS)
    return torch.load(path, map_location="cpu", weights_only=True)


def _report(path: str, missing: List[str], unexpected: List[str]) -> None:
    print(f"partial load from {path}: missing keys: {len(missing)}, "
          f"unexpected keys: {len(unexpected)}", flush=True)


def _merge(loaded: Dict[str, torch.Tensor], target: Dict[str, torch.Tensor], path: str):
    if not any(k in target for k in loaded):
        # e.g. a released torch checkpoint: PEFT-wrapped names, other layouts
        raise ValueError(
            f"{path} shares no entry with the module ({len(loaded)} entries, such as "
            f"{next(iter(loaded), None)!r}); convert a released torch checkpoint first with "
            "python -m seed_story_torch.tools.convert_torch_weights")
    merged = dict(target)
    # the frozen sin-cos tables are computed by the modules, and a converted
    # file leaves them out (weights.py and the converter skip them alike)
    missing = [k for k in target if k not in loaded and not k.endswith("pos_embed")]
    unexpected = [k for k in loaded if k not in target]
    for k, v in loaded.items():
        if k not in target:
            continue
        if (tuple(v.shape) != tuple(target[k].shape)
                or (v.dtype == torch.int8) != (target[k].dtype == torch.int8)):
            missing.append(k)
            continue
        merged[k] = v.to(dtype=target[k].dtype, device=target[k].device)
    return merged, missing, unexpected


def load_checkpoint_(module: torch.nn.Module, path: Optional[str],
                     quantize: Optional[Callable[[torch.nn.Module], object]] = None
                     ) -> torch.nn.Module:
    """Fills ``module`` in place from the parameter file (or checkpoint
    directory) at ``path`` with ``load_params_partial``, and quantizes it
    with ``quantize`` (e.g. ``quantize_llama_``), in this order: the file's
    floating-point entries load into the float module, ``quantize`` converts
    it, then the file's int8 entries (and everything else, again) load into
    the quantized module. So a float checkpoint is quantized after it loads,
    as the JAX package converts a float tree with ``quantize_llama_params``,
    and a ``quantize_base`` run's int8 weights and scales load as they were
    saved. ``path`` None only quantizes.

    It prints one ``partial load`` line for the file: missing are the
    module's entries that neither pass filled (a scale the quantizer
    computed from a loaded float weight counts as filled), unexpected the
    file's entries that neither the float nor the quantized module has."""
    loaded = _read(path) if path else None
    if loaded is None:
        if quantize is not None:
            quantize(module)
        return module
    target = module.state_dict()
    merged, missing, unexpected = _merge(loaded, target, path)
    module.load_state_dict(merged)
    if quantize is not None:
        filled = set(target) - set(missing)
        quantize(module)
        quantized = module.state_dict()
        merged, missing2, unexpected2 = _merge(loaded, quantized, path)
        module.load_state_dict(merged)
        filled |= set(quantized) - set(missing2)
        missing = [k for k in missing2 if k not in filled and not (
            k not in target and k.rpartition(".")[0] + ".weight" in filled)]
        unexpected = [k for k in unexpected2 if k in unexpected]
    _report(path, missing, unexpected)
    return module
