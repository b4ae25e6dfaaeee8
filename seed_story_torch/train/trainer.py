"""One-device trainer: the counterpart of ``seed_story_tpu/train/trainer.py``
(``TrainConfig`` and ``Trainer``) in PyTorch.

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

DDP / FSDP across cards replace the JAX package's sharding presets in a
later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

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


class Trainer:
    """Trains ``model`` with ``loss_fn(batch, dropout_seed) -> (loss,
    metrics)``. ``trainable_mask`` maps every parameter name of ``model`` to
    whether it trains (None: all train). ``step_count`` is the number of
    optimizer updates taken, the JAX ``TrainState.step``."""

    def __init__(self, model: nn.Module, loss_fn: LossFn, cfg: TrainConfig,
                 trainable_mask: Optional[Dict[str, bool]] = None):
        self.model, self.loss_fn, self.cfg = model, loss_fn, cfg
        names = [name for name, _ in model.named_parameters()]
        if trainable_mask is None:
            trainable_mask = dict.fromkeys(names, True)
        if sorted(trainable_mask) != sorted(names):
            raise ValueError("trainable_mask must name every parameter of the model: "
                             f"{sorted(set(trainable_mask) ^ set(names))[:8]}")
        self.params: Dict[str, nn.Parameter] = {}
        for name, p in model.named_parameters():
            p.requires_grad_(trainable_mask[name])
            if trainable_mask[name]:
                self.params[name] = p
        self.schedule = get_scheduler(cfg.lr_scheduler_type, cfg.learning_rate,
                                      cfg.warmup_steps, cfg.training_steps, cfg.min_lr_ratio)
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.step_count = 0
        model.train()

    def step(self, batch: Dict[str, torch.Tensor], dropout_seed: int) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (leaves stacked (accum, ...) when
        ``grad_accum_steps > 1``). Returns the microbatch-mean ``loss`` and
        loss metrics, ``grad_norm`` and ``lr``, as 0-d tensors."""
        metrics = self.accumulate_grads(batch, dropout_seed)
        metrics.update(self.apply_updates())
        return metrics

    def accumulate_grads(self, batch, dropout_seed: int) -> Dict[str, torch.Tensor]:
        """Forward and backward over the microbatches; leaves the mean
        gradient in each trainable parameter's ``.grad``. Every microbatch
        draws the same dropout masks, as the JAX step reuses its rng."""
        accum = self.cfg.grad_accum_steps
        micros = [batch] if accum == 1 else [{k: v[i] for k, v in batch.items()}
                                              for i in range(accum)]
        sums: Dict[str, torch.Tensor] = {}
        for micro in micros:
            loss, metrics = self.loss_fn(micro, dropout_seed)
            loss.backward()
            for k, v in {"loss": loss, **metrics}.items():
                sums[k] = sums.get(k, 0.0) + v.detach().float()
        if accum > 1:
            for p in self.params.values():
                if p.grad is not None:
                    p.grad.div_(accum)
        return {k: v / accum for k, v in sums.items()}

    @torch.no_grad()
    def apply_updates(self) -> Dict[str, torch.Tensor]:
        """Clip, AdamW, and clear the gradients; returns grad_norm and lr."""
        cfg = self.cfg
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in self.params.items()}
        grad_norm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
        keep = grad_norm < cfg.max_grad_norm
        lr = self.schedule(self.step_count)
        count = self.step_count + 1
        bc1, bc2 = 1.0 - cfg.adam_b1 ** count, 1.0 - cfg.adam_b2 ** count
        for name, p in self.params.items():
            g = grads[name]
            g = torch.where(keep, g, g / grad_norm.to(g.dtype) * cfg.max_grad_norm)
            mu, nu = self.mu[name], self.nu[name]
            mu.copy_((1.0 - cfg.adam_b1) * g + cfg.adam_b1 * mu)
            nu.copy_((1.0 - cfg.adam_b2) * g.square() + cfg.adam_b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.adam_eps)
            update = update + cfg.weight_decay * p
            p.copy_(p + (-lr) * update)
            p.grad = None
        self.step_count = count
        return {"grad_norm": grad_norm, "lr": torch.tensor(lr)}

    def state_dict(self) -> Dict:
        """Optimizer state and step (the parameters are the model's)."""
        return {"step": self.step_count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: Dict) -> None:
        if sorted(state["mu"]) != sorted(self.params):
            raise ValueError("optimizer state names differ from the trainable parameters: "
                             f"{sorted(set(state['mu']) ^ set(self.params))[:8]}")
        for name in self.params:
            self.mu[name].copy_(state["mu"][name])
            self.nu[name].copy_(state["nu"][name])
        self.step_count = int(state["step"])
