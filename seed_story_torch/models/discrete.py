"""The discrete visual-tokenizer family of stage 1 in PyTorch; counterpart of
``seed_story_tpu/models/discrete.py``.

``DiscreteModelIdentity`` is the shipped pass-through
(``configs/discrete_model/discrete_identity.yaml``); ``DiscreteModelDistill``
projects, optionally vector-quantizes and projects back under a cosine
distillation loss; the three contrastive composites add a CLIP-style loss
against pooled text features. Parameter names follow the flax modules
(``encode_proj``, ``quantizer.codebook``, ``decode_proj``, ``image_head.proj``,
``logit_scale``).

Flax infers a Dense layer's input width from its first call; here each
module takes the width of the features it sees as ``embed_dim`` (and the
text features' as ``text_dim``), which the stage-1 entry sets from the
ViT's ``output_dim``.

The contrastive loss gathers its negatives across the data-parallel ranks
when ``axis_name`` names a process group, or the ``data`` axis of a running
step (``parallel.collectives``), as the JAX loss gathers over a mesh axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.dense import linear
from ..parallel.collectives import (all_gather, bound_group, concat_all_gather, group_rank,
                                    resolve_group)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + 1e-12)


def cosine_distill_loss(student: torch.Tensor, teacher: torch.Tensor) -> torch.Tensor:
    """1 - cos, averaged, in f32."""
    return (1.0 - (_normalize(student) * _normalize(teacher)).sum(-1)).mean()


def contrastive_loss(image_feats: torch.Tensor, text_feats: torch.Tensor,
                     logit_scale: torch.Tensor, axis_name=None) -> torch.Tensor:
    """CLIP-style InfoNCE: L2-normalized (B, D) features, the mean of both
    directions. With ``axis_name`` (a process group, or an axis name such as
    ``"data"``) the negative pool is every rank's batch, gathered without
    gradient (the reference's concat_all_gather), and the targets are the
    local diagonal offset by ``rank * B``; an axis name with no initialized
    process group is refused, as JAX refuses an unbound axis. Without it the
    pool is the batch: the local one, or inside a trainer step over several
    data ranks the global one, gathered with its gradient, so that the ranks'
    mean loss and gradient are those of the JAX loss on the global batch."""
    image_feats, text_feats = _normalize(image_feats), _normalize(text_feats)
    b = image_feats.shape[0]
    step_group = bound_group("data")
    if axis_name is not None:
        group = resolve_group(axis_name)
        all_image = concat_all_gather(image_feats, group)
        all_text = concat_all_gather(text_feats, group)
        offset = group_rank(group) * b
    elif step_group is not None and dist.get_world_size(step_group) > 1:
        all_image, all_text = all_gather(image_feats, step_group), all_gather(text_feats, step_group)
        offset = group_rank(step_group) * b
    else:
        all_image, all_text, offset = image_feats, text_feats, 0
    targets = torch.arange(b, device=image_feats.device) + offset
    logits_i2t = logit_scale * image_feats @ all_text.T
    logits_t2i = logit_scale * text_feats @ all_image.T
    return (F.cross_entropy(logits_i2t, targets) + F.cross_entropy(logits_t2i, targets)) / 2.0


@dataclasses.dataclass(frozen=True)
class DiscreteConfig:
    dim: int = 4096
    codebook_size: int = 8192
    commit_beta: float = 0.25
    dtype: torch.dtype = torch.float32


class DiscreteModelIdentity(nn.Module):
    """The shipped pass-through: encode == decode == x. It has no
    parameters; ``embed_dim`` is taken for the family's surface."""

    def __init__(self, embed_dim: Optional[int] = None):
        super().__init__()

    def forward(self, image_embeds, *args, **kwargs):
        return {"total_loss": torch.zeros((), device=image_embeds.device),
                "recon": image_embeds}

    def encode_image_embeds(self, image_embeds):
        return image_embeds


@contextlib.contextmanager
def _full_f32_products():
    """f32 products without TF32 inside (the distance product on a card):
    TF32 rounding flips near-tied codes against the f32 plain version."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


class VectorQuantizer(nn.Module):
    """Nearest-codebook assignment with the straight-through estimator, a
    commitment loss and a codebook loss. The distances are |x|^2 - 2 x c^T
    + |c|^2 in f32, the formula of the JAX module, so argmin picks the same
    code."""

    def __init__(self, codebook_size: int, dim: int):
        super().__init__()
        self.codebook = nn.Parameter(torch.empty(codebook_size, dim))

    def forward(self, x):
        """x (..., dim) -> (quant in x's dtype, codes (...), commit loss,
        codebook loss)."""
        codebook = self.codebook
        xf = x.float()
        with _full_f32_products():
            prod = xf @ codebook.T
        d = xf.square().sum(-1, keepdim=True) - 2 * prod + codebook.square().sum(-1)
        idx = torch.argmin(d, dim=-1)
        quant = codebook[idx]
        commit = (quant.detach() - xf).square().mean()
        codebook_loss = (quant - xf.detach()).square().mean()
        quant = xf + (quant - xf).detach()  # straight-through
        return quant.to(x.dtype), idx, commit, codebook_loss


class DiscreteModelDistill(nn.Module):
    """Project -> (optional VQ) -> project back; the loss is the cosine
    distillation of the reconstruction onto the input (+ the VQ terms)."""

    def __init__(self, cfg: DiscreteConfig = DiscreteConfig(), use_vq: bool = False,
                 embed_dim: int = 4096):
        super().__init__()
        self.cfg, self.use_vq = cfg, use_vq
        self.encode_proj = nn.Linear(embed_dim, cfg.dim)
        self.quantizer = VectorQuantizer(cfg.codebook_size, cfg.dim) if use_vq else None
        self.decode_proj = nn.Linear(cfg.dim, embed_dim)

    def forward(self, image_embeds):
        """Returns total_loss, distill_loss and recon, and with VQ also
        commit_loss, codebook_loss and codes (for :func:`code_usage`)."""
        c = self.cfg
        x = linear(self.encode_proj, image_embeds, c.dtype)
        metrics = {}
        if self.use_vq:
            x, idx, commit, codebook_loss = self.quantizer(x)
            metrics = {"commit_loss": commit, "codebook_loss": codebook_loss, "codes": idx}
        recon = linear(self.decode_proj, x, c.dtype)
        distill = cosine_distill_loss(recon, image_embeds)
        total = distill
        if self.use_vq:
            total = distill + c.commit_beta * metrics["commit_loss"] + metrics["codebook_loss"]
        return {"total_loss": total, "distill_loss": distill, "recon": recon, **metrics}

    def encode_image_embeds(self, image_embeds):
        x = linear(self.encode_proj, image_embeds, self.cfg.dtype)
        return self.quantizer(x)[0] if self.use_vq else x


class _ProjectPool(nn.Module):
    """Per-token projection, mean-pooled to one vector."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.proj = nn.Linear(in_dim, dim)

    def forward(self, x):
        return F.linear(x, self.proj.weight, self.proj.bias).mean(dim=1)


class DiscreteModelStageOneContrastive(nn.Module):
    """Image features against text features, each projected and pooled,
    under :func:`contrastive_loss` with a learned temperature."""

    def __init__(self, cfg: DiscreteConfig = DiscreteConfig(), temperature_init: float = 0.07,
                 embed_dim: int = 4096, text_dim: Optional[int] = None):
        super().__init__()
        self.temperature_init = temperature_init
        self.image_head = _ProjectPool(embed_dim, cfg.dim)
        self.text_head = _ProjectPool(text_dim or embed_dim, cfg.dim)
        self.logit_scale = nn.Parameter(torch.full((1,), math.log(1.0 / temperature_init)))

    def forward(self, image_embeds, text_embeds, axis_name=None):
        img = self.image_head(image_embeds)
        txt = self.text_head(text_embeds)
        scale = torch.exp(self.logit_scale[0].clamp(-10.0, 4.6052))  # <= 100
        loss = contrastive_loss(img, txt, scale, axis_name=axis_name)
        return {"total_loss": loss, "contrastive_loss": loss}


class DiscreteModelStageTwoContrastiveDistill(nn.Module):
    """Distillation plus the contrastive loss on the reconstruction."""

    def __init__(self, cfg: DiscreteConfig = DiscreteConfig(), use_vq: bool = True,
                 contrastive_scale: float = 1.0, embed_dim: int = 4096,
                 text_dim: Optional[int] = None):
        super().__init__()
        self.contrastive_scale = contrastive_scale
        self.distill = DiscreteModelDistill(cfg, use_vq, embed_dim)
        self.contrastive = DiscreteModelStageOneContrastive(cfg, embed_dim=embed_dim,
                                                            text_dim=text_dim)

    def forward(self, image_embeds, text_embeds, axis_name=None):
        distill = self.distill(image_embeds)
        contrast = self.contrastive(distill["recon"], text_embeds, axis_name=axis_name)
        total = distill["total_loss"] + self.contrastive_scale * contrast["total_loss"]
        return {**distill, **contrast, "total_loss": total}


class DiscreteModelDistillWithDoubleContrastive(nn.Module):
    """Distillation plus contrastive losses before and after quantization."""

    def __init__(self, cfg: DiscreteConfig = DiscreteConfig(), use_vq: bool = True,
                 contrastive_scale: float = 1.0, embed_dim: int = 4096,
                 text_dim: Optional[int] = None):
        super().__init__()
        self.contrastive_scale = contrastive_scale
        self.distill = DiscreteModelDistill(cfg, use_vq, embed_dim)
        self.contrastive_pre = DiscreteModelStageOneContrastive(cfg, embed_dim=embed_dim,
                                                                text_dim=text_dim)
        self.contrastive_post = DiscreteModelStageOneContrastive(cfg, embed_dim=embed_dim,
                                                                 text_dim=text_dim)

    def forward(self, image_embeds, text_embeds, axis_name=None):
        distill = self.distill(image_embeds)
        c_pre = self.contrastive_pre(image_embeds, text_embeds, axis_name=axis_name)
        c_post = self.contrastive_post(distill["recon"], text_embeds, axis_name=axis_name)
        total = distill["total_loss"] + self.contrastive_scale * (
            c_pre["total_loss"] + c_post["total_loss"])
        return {**distill, "contrastive_pre": c_pre["total_loss"],
                "contrastive_post": c_post["total_loss"], "total_loss": total}


# the reference's spellings (sic)
DiscreteModleIdentity = DiscreteModelIdentity
DiscreteModleOnlyDistill = DiscreteModelDistill
DiscreteModleStageOneContrastive = DiscreteModelStageOneContrastive
DiscreteModleStageTwoContrastiveDistill = DiscreteModelStageTwoContrastiveDistill
DiscreteModleDistillWithDoubleContrastive = DiscreteModelDistillWithDoubleContrastive


def code_usage(codes) -> int:
    """Unique codebook indices in a batch: the stage-1 ``code_usage``
    metric."""
    return int(torch.unique(torch.as_tensor(codes)).numel())
