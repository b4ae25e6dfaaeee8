"""The trainer: the counterpart of ``seed_story_tpu/train/trainer.py``
(``TrainConfig`` and ``Trainer``) in PyTorch, on one device or over a
``(data, model)`` mesh of ranks.

The update, :meth:`Trainer.apply_updates`, is the JAX package's
``make_optimizer`` chain ``optax.chain(clip_by_global_norm, adamw)``
written out, so both packages take the same steps:

  * only the trainable parameters have gradients and optimizer state; the
    frozen ones are ``requires_grad_(False)``;
  * global-norm clipping scales by ``max / |g|`` only when ``|g| >= max``
    (no epsilon), and ``grad_norm`` is the norm before clipping (computed in
    f32 whatever the gradients' dtype);
  * AdamW with bias-corrected moments kept in the parameter dtype, weight
    decay on every trainable parameter, and the learning rate read at the
    optimizer count *before* it is incremented (step 0 under warmup has
    lr 0);
  * gradient accumulation averages the gradients of the microbatches
    stacked on a leading axis.

With a mesh (``parallel/mesh.py``) each rank trains on its rows of the
global batch, under ``cfg.sharding_preset`` (``parallel/sharding.py``):

  * ``dp``: replicated parameters; after the backward the gradients are
    averaged over ``data`` (DDP semantics), so every rank holds the
    gradient of the global batch's loss (the losses' masked means count
    their denominators over the global batch, ``collectives.global_mean``);
  * ``fsdp``: ``fully_shard`` per LLaMA decoder layer, per UNet block and
    per tower over ``data``: parameters, gradients and the AdamW moments are
    shards; so are a ``quantize_base`` base's int8 weights and scales,
    outside FSDP (``sharding.shard_int8_base_``);
  * ``fsdp_tp``: ``fsdp`` plus the column / row split over ``model`` of
    the LLaMA projections, of the LLaMA's vocabulary (``embed_tokens`` and
    ``lm_head``) and of any SDXL UNet in the model
    (``sharding.apply_tensor_parallel_``); frozen modules the loss closes
    over (stage 3's agent and VAE) stay whole on every rank, as the JAX
    ``Trainer`` replicates its ``loss_consts``.

The update acts on each rank's local shards in the same operation order;
``grad_norm`` stays the norm of the global gradient: each rank's f32 sum of
squares is all-reduced before the square root (a shard counted once).
LoRA dropout keys each row's mask by its row of the global batch
(``models/llama.py::lora_dropout``), so a sharded step is the one-process
step on the global batch. ``full_state`` / ``load_full_state`` move the
whole state dict, as a checkpoint holds it: FSDP's shards, the
tensor-parallel slices (``tp_splits``) and the int8 base's data-rank row
slices (``data_splits``) joined.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..parallel import collectives, sharding
from .scheduler import get_scheduler

LossFn = Callable[[Dict[str, torch.Tensor], int], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.05
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    lr_scheduler_type: str = "cosine"
    warmup_steps: int = 100
    training_steps: int = 6000
    min_lr_ratio: float = 0.05
    grad_accum_steps: int = 1
    sharding_preset: str = "fsdp"  # under a mesh: dp | fsdp | fsdp_tp


def _group(mesh, axis):
    return None if mesh is None else mesh[axis].get_group()


class Trainer:
    """Trains ``model`` with ``loss_fn(batch, dropout_seed) -> (loss,
    metrics)``. ``trainable_mask`` maps every parameter name of ``model`` to
    whether it trains (None: all train). ``step_count`` is the number of
    optimizer updates taken, the JAX ``TrainState.step``. ``mesh``: a
    ``(data, model)`` DeviceMesh from ``parallel.mesh.make_mesh`` (None:
    one device); the model is sharded in place under
    ``cfg.sharding_preset``, and ``loss_fn`` (which may close over it) runs
    on each rank's rows of the global batch."""

    def __init__(self, model: nn.Module, loss_fn: LossFn, cfg: TrainConfig,
                 trainable_mask: Optional[Dict[str, bool]] = None, mesh=None):
        self.model, self.loss_fn, self.cfg, self.mesh = model, loss_fn, cfg, mesh
        names = [name for name, _ in model.named_parameters()]
        if trainable_mask is None:
            trainable_mask = dict.fromkeys(names, True)
        if sorted(trainable_mask) != sorted(names):
            raise ValueError("trainable_mask must name every parameter of the model: "
                             f"{sorted(set(trainable_mask) ^ set(names))[:8]}")
        for name, p in model.named_parameters():
            p.requires_grad_(trainable_mask[name])
        self.preset = cfg.sharding_preset if mesh is not None else None
        self.data_group, self.model_group = _group(mesh, "data"), _group(mesh, "model")
        self.tp_splits: Dict[str, Tuple[int, int]] = {}
        self.data_splits: Dict[str, int] = {}
        whole = set()  # trainable parameters kept whole on every data rank
        if mesh is not None:
            if self.preset not in sharding.PRESETS:
                raise ValueError(f"unknown sharding preset {self.preset!r}")
            if self.preset == "fsdp_tp" and mesh["model"].size() > 1:
                self.tp_splits = sharding.apply_tensor_parallel_(model, self.model_group)
            if self.preset in ("fsdp", "fsdp_tp"):
                whole = sharding.apply_fsdp_(model, mesh["data"])
                self.data_splits = sharding.data_splits(model)
        self.params: Dict[str, nn.Parameter] = {
            name: p for name, p in model.named_parameters() if p.requires_grad}
        # the gradients averaged here over data: all under dp, the whole ones under fsdp
        whole_ids = {id(p) for p in whole}
        self._averaged = [p for p in self.params.values()
                          if self.preset == "dp" or id(p) in whole_ids]
        self.schedule = get_scheduler(cfg.lr_scheduler_type, cfg.learning_rate,
                                      cfg.warmup_steps, cfg.training_steps, cfg.min_lr_ratio)
        local = sharding.to_local
        self.mu = {n: torch.zeros_like(local(p)) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(local(p)) for n, p in self.params.items()}
        self.step_count = 0
        model.train()

    def _groups(self):
        return {} if self.mesh is None else {"data": self.data_group, "model": self.model_group}

    def step(self, batch: Dict[str, torch.Tensor], dropout_seed: int) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (leaves stacked (accum, ...) when
        ``grad_accum_steps > 1``). Returns the microbatch-mean ``loss`` and
        loss metrics, ``grad_norm`` and ``lr``, as 0-d tensors."""
        metrics = self.accumulate_grads(batch, dropout_seed)
        metrics.update(self.apply_updates())
        return metrics

    def accumulate_grads(self, batch, dropout_seed: int) -> Dict[str, torch.Tensor]:
        """Forward and backward over the microbatches; leaves the mean
        gradient in each trainable parameter's ``.grad`` (under ``dp``, the
        mean over the data ranks too). Every microbatch draws the same
        dropout masks, as the JAX step reuses its rng."""
        accum = self.cfg.grad_accum_steps
        micros = [batch] if accum == 1 else [{k: v[i] for k, v in batch.items()}
                                              for i in range(accum)]
        sums: Dict[str, torch.Tensor] = {}
        with collectives.data_parallel(self._groups()):
            for micro in micros:
                loss, metrics = self.loss_fn(micro, dropout_seed)
                loss.backward()
                for k, v in {"loss": loss, **metrics}.items():
                    sums[k] = sums.get(k, 0.0) + v.detach().float()
        if accum > 1:
            for p in self.params.values():
                if p.grad is not None:
                    p.grad.div_(accum)
        n_data = 1 if self.data_group is None else dist.get_world_size(self.data_group)
        if n_data > 1:
            for p in self._averaged:
                if p.grad is not None:  # summed in f32 (gloo has no AVG), rounded once
                    total = p.grad.float()
                    dist.all_reduce(total, group=self.data_group)
                    p.grad.copy_(total / n_data)
        return {k: v / accum for k, v in sums.items()}

    def _grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global gradient's norm from the local pieces: each
        parameter's f32 sum of squares is summed over the axes its piece is
        split along (FSDP's shards over ``data``, tensor-parallel slices
        over ``model``; a whole piece counted once), then all are added in
        parameter order."""
        squares = [g.float().square().sum() for g in grads.values()]
        if self.preset not in (None, "dp"):
            split = {}
            for i, (name, p) in enumerate(self.params.items()):
                axes = (sharding.is_dtensor(p), name in self.tp_splits)
                if any(axes):
                    split.setdefault(axes, []).append(i)
            groups = {(True, False): self.data_group, (False, True): self.model_group,
                      (True, True): None}  # None: every rank (data x model)
            for axes, idx in split.items():
                group = groups[axes]
                if group is not None and dist.get_world_size(group) == 1:
                    continue
                part = torch.stack([squares[i] for i in idx])
                dist.all_reduce(part, group=group)
                for j, i in enumerate(idx):
                    squares[i] = part[j]
        return torch.sqrt(sum(squares))

    @torch.no_grad()
    def apply_updates(self) -> Dict[str, torch.Tensor]:
        """Clip, AdamW, and clear the gradients; returns grad_norm and lr."""
        cfg = self.cfg
        local = sharding.to_local
        grads = {n: torch.zeros_like(local(p)) if p.grad is None else local(p.grad)
                 for n, p in self.params.items()}
        grad_norm = self._grad_norm(grads)
        keep = grad_norm < cfg.max_grad_norm
        lr = self.schedule(self.step_count)
        count = self.step_count + 1
        bc1, bc2 = 1.0 - cfg.adam_b1 ** count, 1.0 - cfg.adam_b2 ** count
        for name, param in self.params.items():
            p, g = local(param), grads[name]
            g = torch.where(keep, g, g / grad_norm.to(g.dtype) * cfg.max_grad_norm)
            mu, nu = self.mu[name], self.nu[name]
            mu.copy_((1.0 - cfg.adam_b1) * g + cfg.adam_b1 * mu)
            nu.copy_((1.0 - cfg.adam_b2) * g.square() + cfg.adam_b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.adam_eps)
            update = update + cfg.weight_decay * p
            p.copy_(p + (-lr) * update)
            param.grad = None
        self.step_count = count
        return {"grad_norm": grad_norm, "lr": torch.tensor(lr)}

    def state_dict(self) -> Dict:
        """Optimizer state and step of this rank (the parameters are the
        model's); local shards under a sharded preset."""
        return {"step": self.step_count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: Dict) -> None:
        if sorted(state["mu"]) != sorted(self.params):
            raise ValueError("optimizer state names differ from the trainable parameters: "
                             f"{sorted(set(state['mu']) ^ set(self.params))[:8]}")
        for name in self.params:
            self.mu[name].copy_(state["mu"][name])
            self.nu[name].copy_(state["nu"][name])
        self.step_count = int(state["step"])

    # -- whole state (checkpoints) ---------------------------------------

    def whole_tensor(self, local: torch.Tensor, name: str, like: torch.Tensor) -> torch.Tensor:
        """The whole tensor of which ``local`` is this rank's piece of the
        parameter ``name`` (``like``: the parameter), or of a tensor laid
        out as it is (a gradient, a moment). A collective under a mesh."""
        return sharding.full_tensor(local, like, self.tp_splits.get(name), self.model_group,
                                    self.data_splits.get(name), self.data_group)

    def _piece(self, full: torch.Tensor, name: str, like: torch.Tensor) -> torch.Tensor:
        return sharding.local_piece(full, like, self.tp_splits.get(name), self.model_group,
                                    self.data_splits.get(name), self.data_group)

    @torch.no_grad()
    def full_state(self) -> Tuple[Dict[str, torch.Tensor], Dict]:
        """(model state dict, optimizer state) whole, on the host: the
        shards of FSDP and of tensor parallelism joined. A collective under
        a mesh (every rank calls it); only a rank's own copy is returned."""
        if self.mesh is None:
            return to_host(self.model.state_dict()), to_host(self.state_dict())
        params = {}
        for name, t in self.model.state_dict().items():
            params[name] = self.whole_tensor(sharding.to_local(t), name, t).cpu()
        opt = {"step": self.step_count, "mu": {}, "nu": {}}
        for name, p in self.params.items():
            opt["mu"][name] = self.whole_tensor(self.mu[name], name, p).cpu()
            opt["nu"][name] = self.whole_tensor(self.nu[name], name, p).cpu()
        return params, opt

    @torch.no_grad()
    def load_full_state(self, params: Dict[str, torch.Tensor], opt: Dict) -> None:
        """Loads a whole state (as :meth:`full_state` returns it, from a
        run at any world size) into this rank's pieces."""
        if self.mesh is None:
            self.model.load_state_dict(params)
            self.load_state_dict(opt)
            return
        own = self.model.state_dict()
        if sorted(own) != sorted(params):
            raise ValueError("checkpoint names differ from the model's: "
                             f"{sorted(set(own) ^ set(params))[:8]}")
        for name, t in own.items():
            sharding.to_local(t).copy_(self._piece(params[name], name, t))
        local = {}
        for key in ("mu", "nu"):
            local[key] = {name: self._piece(opt[key][name], name, p)
                          for name, p in self.params.items()}
        self.load_state_dict({"step": opt["step"], **local})


def to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree
