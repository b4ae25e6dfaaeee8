"""Checkpoint / resume; counterpart of ``seed_story_tpu/train/checkpoint.py``.

A checkpoint is one directory per step, ``<dir>/<step>/``, holding
``params.pt`` (the model's state dict), ``opt_state.pt`` (the trainer's
moments and step) and ``meta.json`` (the step and the data pipeline's
position). ``save`` takes a consistent host copy of the state, then a
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

from .trainer import Trainer

log = logging.getLogger("seed_story_torch")

PARAMS, OPT_STATE, META = "params.pt", "opt_state.pt", "meta.json"


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


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
        state, step) at ``step``; False when that step is already saved."""
        self.wait()
        if step in self.steps():
            return False
        params = _to_host(trainer.model.state_dict())
        opt_state = _to_host(trainer.state_dict())
        meta = {"step": step, "data_state": data_state}
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
        ``trainer`` and its model. Returns (step, data_state), or (None, None)
        when there is no checkpoint."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        path = os.path.join(self.directory, str(step))
        trainer.model.load_state_dict(torch.load(os.path.join(path, PARAMS), map_location="cpu",
                                                 weights_only=True))
        trainer.load_state_dict(torch.load(os.path.join(path, OPT_STATE), map_location="cpu",
                                           weights_only=True))
        with open(os.path.join(path, META)) as f:
            meta = json.load(f)
        return step, meta["data_state"]


def save_params(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """A standalone parameter file (the handoff between stages)."""
    torch.save(_to_host(state_dict), path)


def load_params_partial(path: str, target: Dict[str, torch.Tensor]
                        ) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """strict=False load: the entries of the state dict saved at ``path`` (a
    parameter file, or a checkpoint directory's ``params.pt``) overwrite the
    entries of ``target`` with the same name and shape, cast to the target's
    dtype and device. Returns (merged, missing, unexpected); an entry whose
    shape differs counts as missing, and so does one that is int8 where the
    target is floating point or the other way round (never cast: int8 values
    read as float weights, or float weights truncated to int8, are wrong
    without any error)."""
    return _merge(_read(path), target, path)


def _read(path: str) -> Dict[str, torch.Tensor]:
    if os.path.isdir(path):
        path = os.path.join(path, PARAMS)
    return torch.load(path, map_location="cpu", weights_only=True)


def _merge(loaded: Dict[str, torch.Tensor], target: Dict[str, torch.Tensor], path: str):
    merged = dict(target)
    missing = [k for k in target if k not in loaded]
    unexpected = [k for k in loaded if k not in target]
    for k, v in loaded.items():
        if k not in target:
            continue
        if (tuple(v.shape) != tuple(target[k].shape)
                or (v.dtype == torch.int8) != (target[k].dtype == torch.int8)):
            missing.append(k)
            continue
        merged[k] = v.to(dtype=target[k].dtype, device=target[k].device)
    log.info("partial load from %s: missing keys: %d, unexpected keys: %d",
             path, len(missing), len(unexpected))
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
    saved. ``path`` None only quantizes."""
    loaded = _read(path) if path else None
    if loaded is not None:
        module.load_state_dict(_merge(loaded, module.state_dict(), path)[0])
    if quantize is not None:
        quantize(module)
        if loaded is not None:
            module.load_state_dict(_merge(loaded, module.state_dict(), path)[0])
    return module
