"""ContinuousLVLM in PyTorch: ViT features scattered into the LLM's token
slots, and LLM hidden states regressed back to ViT features; counterpart of
``seed_story_tpu/models/agent.py``. ``forward`` is the training loss (CE +
cosine regression); the other methods are the generation surface.
``SEEDLLaMAAlignGeneration`` is the align-only variant: a frozen LLM whose
hidden states train the output resampler alone.
State-dict names follow the reference agent (``llm.*``, ``input_resampler.*``,
``output_resampler.*``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from ..parallel.collectives import global_mean
from .llama import KVCache, LlamaConfig, LlamaForCausalLM, cross_entropy_loss
from .resampler import Resampler


def _selected_first_perm(mask: torch.Tensor) -> torch.Tensor:
    """Permutation putting True entries first, preserving order."""
    return torch.argsort((~mask).to(torch.int8), stable=True)


def scatter_image_embeds(input_embeds, image_embeds_lm, ids_mask, embeds_mask):
    """input_embeds[ids_mask] = image_embeds_lm[embeds_mask].reshape(-1, D)
    with the JAX version's row order. input_embeds (B, S, D),
    image_embeds_lm (N, nq, D), ids_mask (B, S) bool, embeds_mask (N,) bool."""
    b, s, d = input_embeds.shape
    n, nq, _ = image_embeds_lm.shape
    src = image_embeds_lm[_selected_first_perm(embeds_mask)].reshape(n * nq, d)
    ordinal = (torch.cumsum(ids_mask.reshape(b * s).to(torch.int64), 0) - 1).clamp(0, n * nq - 1)
    gathered = src[ordinal].reshape(b, s, d).to(input_embeds.dtype)
    return torch.where(ids_mask[..., None], gathered, input_embeds)


def gather_image_hidden(hidden, ids_mask, embeds_mask, nq: int):
    """hidden[ids_mask].view(num_sel, nq, D) placed back on the (N, nq, D)
    image axis; unselected image rows are zero."""
    b, s, d = hidden.shape
    n = embeds_mask.shape[0]
    order = torch.argsort((~ids_mask.reshape(b * s)).to(torch.int8), stable=True)[: n * nq]
    blocks = hidden.reshape(b * s, d)[order].reshape(n, nq, d)
    out = torch.zeros((n, nq, d), dtype=hidden.dtype, device=hidden.device)
    out[_selected_first_perm(embeds_mask)] = blocks
    return torch.where(embeds_mask[:, None, None], out, 0.0)


def cosine_loss(rec, target, valid: Optional[torch.Tensor] = None):
    """Mean (1 - cos) over the tokens of valid images, in f32. The
    rsqrt(|x|^2 + 1e-12) normalization keeps gradients finite on the
    exactly-zero rows of unselected images."""
    rec, target = rec.float(), target.float()
    rec = rec * torch.rsqrt(rec.square().sum(-1, keepdim=True) + 1e-12)
    target = target * torch.rsqrt(target.square().sum(-1, keepdim=True) + 1e-12)
    per_token = 1.0 - (rec * target).sum(-1)  # (N, nq)
    if valid is None:
        return per_token.mean()
    w = valid.float()[:, None]
    return global_mean((per_token * w).sum(), w.sum() * per_token.shape[1], floor=1.0)


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    llm: LlamaConfig
    input_resampler_grid: int = 8  # 64 queries == num_img_in_tokens
    output_resampler_grid: int = 16  # 256 queries == ViT n_queries
    num_img_out_tokens: int = 64  # gen slots per image in the sequence
    resampler_heads: int = 32
    vit_dim: int = 4096
    lm_loss_scale: float = 1.0
    rec_loss_scale: float = 1.0

    @property
    def num_img_in_tokens(self) -> int:
        return self.input_resampler_grid ** 2

    @property
    def num_vit_tokens(self) -> int:
        return self.output_resampler_grid ** 2

    @staticmethod
    def tiny(**kw) -> "AgentConfig":
        base = dict(llm=LlamaConfig.tiny(dtype=torch.float32), input_resampler_grid=2,
                    output_resampler_grid=3, num_img_out_tokens=9, resampler_heads=4,
                    vit_dim=128)
        base.update(kw)
        return AgentConfig(**base)


class _GenerationSurface(nn.Module):
    """What ``decode/generate.py`` calls besides ``embed_with_images``, on an
    agent with ``llm`` and ``output_resampler``."""

    def llm_step(self, inputs_embeds, cache: KVCache, seq_lengths=None, logits_indices=None):
        """Appends a right-padded (B, P) block to ``cache``; ``seq_lengths``
        (B,) host ints are the rows' true lengths (None: P each) and
        ``logits_indices`` (B,) the position of each row's logits."""
        return self.llm(inputs_embeds=inputs_embeds, cache=cache, seq_lengths=seq_lengths,
                        logits_indices=logits_indices)

    def embed_tokens(self, input_ids):
        return self.llm.embed(input_ids)

    def resample_output(self, hidden_blocks):
        """(N, num_img_out_tokens, D) hidden states -> (N, 256, vit_dim)."""
        return self.output_resampler(hidden_blocks)


class ContinuousLVLM(_GenerationSurface):
    def __init__(self, cfg: AgentConfig):
        super().__init__()
        self.cfg = cfg
        d, dt, pd = cfg.llm.hidden_size, cfg.llm.dtype, cfg.llm.param_dtype
        self.llm = LlamaForCausalLM(cfg.llm)
        self.input_resampler = Resampler(
            grid_size=cfg.input_resampler_grid, embed_dim=d, num_heads=cfg.resampler_heads,
            kv_dim=cfg.vit_dim if cfg.vit_dim != d else None, dtype=dt, param_dtype=pd)
        self.output_resampler = Resampler(
            grid_size=cfg.output_resampler_grid, embed_dim=cfg.vit_dim,
            num_heads=cfg.resampler_heads, kv_dim=d if d != cfg.vit_dim else None,
            dtype=dt, param_dtype=pd)

    def forward(self, input_ids, attention_mask, labels, image_embeds, embeds_gen_mask,
                embeds_cmp_mask, ids_gen_mask, ids_cmp_mask,
                dropout_seed: Optional[int] = None):
        """The stage-2 losses. input_ids / attention_mask / labels /
        ids_*_mask: (B, S); image_embeds: (N, n_vit_tokens, vit_dim) on the
        flattened image axis; embeds_*_mask: (N,). ``dropout_seed`` turns on
        LoRA dropout in training mode. Returns {"total_loss", "lm_loss",
        "rec_loss", "recon_image_embeds"}."""
        cfg = self.cfg
        inputs_embeds = self.embed_with_images(input_ids, image_embeds, ids_cmp_mask,
                                               embeds_cmp_mask)
        if cfg.llm.ce_chunk_size:  # no (B, S, V) logits
            hidden = self.llm.hidden_states(inputs_embeds=inputs_embeds,
                                            attention_mask=attention_mask,
                                            dropout_seed=dropout_seed)
            lm_loss = self.llm.chunked_loss(hidden, labels)
        else:
            out = self.llm(inputs_embeds=inputs_embeds, attention_mask=attention_mask,
                           dropout_seed=dropout_seed)
            lm_loss = cross_entropy_loss(out["logits"], labels, vocab=self.llm.vocab_shard())
            hidden = out["hidden_states"]
        gen_blocks = gather_image_hidden(hidden, ids_gen_mask, embeds_gen_mask,
                                         cfg.num_img_out_tokens)
        recon = self.output_resampler(gen_blocks)
        rec_loss = cosine_loss(recon, image_embeds, valid=embeds_gen_mask)
        total = cfg.lm_loss_scale * lm_loss + cfg.rec_loss_scale * rec_loss
        return {"total_loss": total, "lm_loss": lm_loss, "rec_loss": rec_loss,
                "recon_image_embeds": recon}

    def embed_with_images(self, input_ids, image_embeds, ids_cmp_mask, embeds_cmp_mask):
        """Prefill embeddings with the resampled image features scattered in."""
        return scatter_image_embeds(self.llm.embed(input_ids), self.input_resampler(image_embeds),
                                    ids_cmp_mask, embeds_cmp_mask)



class SEEDLLaMAAlignGeneration(_GenerationSurface):
    """The align-only agent: a frozen LLM whose hidden states are detached
    (computed without a graph) and the output resampler trained on the
    cosine reconstruction loss alone; no CE, no input resampler (captions
    enter as text). Its generation surface is ``ContinuousLVLM``'s with
    images ignored, so ``decode/generate.py`` drives it unchanged. Train it
    under :func:`align_trainable_mask`."""

    def __init__(self, cfg: AgentConfig):
        super().__init__()
        self.cfg = cfg
        d, dt, pd = cfg.llm.hidden_size, cfg.llm.dtype, cfg.llm.param_dtype
        self.llm = LlamaForCausalLM(cfg.llm)
        self.output_resampler = Resampler(
            grid_size=cfg.output_resampler_grid, embed_dim=cfg.vit_dim,
            num_heads=cfg.resampler_heads, kv_dim=d if d != cfg.vit_dim else None,
            dtype=dt, param_dtype=pd)

    def forward(self, input_ids, attention_mask, labels, image_embeds, embeds_gen_mask,
                embeds_cmp_mask, ids_gen_mask, ids_cmp_mask,
                dropout_seed: Optional[int] = None):
        """The cosine loss of the resampled gen-slot hidden states against
        ``image_embeds``; ``labels``, ``embeds_cmp_mask`` and ``ids_cmp_mask``
        are taken for the reference's signature and unused. Returns
        {"total_loss", "rec_loss", "recon_image_embeds"}."""
        del labels, embeds_cmp_mask, ids_cmp_mask
        with torch.no_grad():  # the frozen LLM: detached hidden states
            hidden = self.llm.hidden_states(inputs_embeds=self.llm.embed(input_ids),
                                            attention_mask=attention_mask,
                                            dropout_seed=dropout_seed)
        gen_blocks = gather_image_hidden(hidden, ids_gen_mask, embeds_gen_mask,
                                         self.cfg.num_img_out_tokens)
        recon = self.output_resampler(gen_blocks)
        rec_loss = cosine_loss(recon, image_embeds, valid=embeds_gen_mask)
        return {"total_loss": rec_loss, "rec_loss": rec_loss, "recon_image_embeds": recon}

    def embed_with_images(self, input_ids, image_embeds, ids_cmp_mask, embeds_cmp_mask):
        """The prompt's token embeddings; the images are ignored."""
        return self.llm.embed(input_ids)


def align_trainable_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> trainable: the output resampler only."""
    return {name: name.startswith("output_resampler.") for name, _ in model.named_parameters()}
