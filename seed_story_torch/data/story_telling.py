"""Long-story and text-to-image sample decoding and batching; the port's own
copy of what it uses of ``seed_story_tpu/data/story_telling.py``. Ragged
image counts are a static ``max_images`` axis with validity masks:

  text layout   cap0 <img>[64x<img_k>]</img> [INST] cap1 <img>...</img>
                ... [INST] cap_{t+1} <img>[gen tokens]</img>
  labels        -100 on bos/instruction/image-token spans; response text
                + eos supervised
  ids_cmp_mask  True on the slots of every context image
  ids_gen_mask  True on the slots of the single target image
  embeds_*_mask per-image flags aligned with the images axis

With an SDXL image transform (stage 3) a sample also carries the target
image as ``sd_images`` (float32 CHW) and its SDXL micro-conditioning
``time_ids`` (int32, 6).
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .tokenizer import BOI_TOKEN, EOI_TOKEN, image_comprehension_string

IGNORE_INDEX = -100


@dataclasses.dataclass
class StoryDecodeConfig:
    max_length: int = 1280
    max_images: int = 10  # static image axis per sample
    num_img_in_tokens: int = 64
    num_img_out_tokens: int = 64
    instruction_prompt: str = "{instruction}"
    system_message: str = ""
    min_resolution: int = 128
    min_aspect_ratio: float = 0.2
    image_size: int = 448  # of the zero images when there is no transform


def calculate_new_dimensions(height: int, width: int, target_size: int):
    """Shorter-side resize arithmetic of the reference data pipeline."""
    if height < width:
        return target_size, int(width * (target_size / height))
    return int(height * (target_size / width)), target_size


def sdxl_micro_conditioning(height: int, width: int, target_size: int) -> np.ndarray:
    """SDXL time_ids = (orig_h, orig_w, crop_y, crop_x, target, target). As
    in the reference, the (height, width) pair comes back unpacked as (width,
    height), so a landscape image's crop offset lands in the y slot."""
    target_width, target_height = calculate_new_dimensions(height, width, target_size)
    y1 = max(0, int(round((target_height - target_size) / 2.0)))
    x1 = max(0, int(round((target_width - target_size) / 2.0)))
    return np.array([height, width, y1, x1, target_size, target_size], np.int32)


def _encode_spans(tokenizer, instruction: str, response: str, system_message: str):
    input_ids: List[int] = []
    labels: List[int] = []
    if system_message:
        if not system_message.endswith("\n"):
            system_message += "\n"
        ids = tokenizer.encode(system_message, add_special_tokens=False)
        input_ids += ids
        labels += [IGNORE_INDEX] * len(ids)
    ids = tokenizer.encode(instruction, add_special_tokens=False)
    input_ids += ids
    labels += [IGNORE_INDEX] * len(ids)
    ids = tokenizer.encode(response, add_special_tokens=False)
    input_ids += ids
    labels += list(ids)
    input_ids = [tokenizer.bos_token_id] + input_ids + [tokenizer.eos_token_id]
    labels = [IGNORE_INDEX] + labels + [tokenizer.eos_token_id]
    return input_ids, labels


def _finalize_sample(tokenizer, input_ids: List[int], labels: List[int],
                     cfg: StoryDecodeConfig, num_cmp_images: int):
    """Pads to max_length and builds the two mask families; None if the
    sample does not fit (it is dropped)."""
    if len(input_ids) >= cfg.max_length:
        return None
    pad = cfg.max_length - len(input_ids)
    attention_mask = np.array([1] * len(input_ids) + [0] * pad, np.int32)
    input_ids = np.array(input_ids + [tokenizer.pad_token_id] * pad, np.int32)
    labels = np.array(labels + [IGNORE_INDEX] * pad, np.int32)

    boi_id = tokenizer.encode(BOI_TOKEN, add_special_tokens=False)[0]
    eoi_id = tokenizer.encode(EOI_TOKEN, add_special_tokens=False)[0]
    boi_idx = np.where(input_ids == boi_id)[0]
    eoi_idx = np.where(input_ids == eoi_id)[0]

    ids_cmp_mask = np.zeros(cfg.max_length, bool)
    ids_gen_mask = np.zeros(cfg.max_length, bool)
    for i in range(num_cmp_images):
        ids_cmp_mask[boi_idx[i] + 1: eoi_idx[i]] = True
    ids_gen_mask[boi_idx[-1] + 1: eoi_idx[-1]] = True
    labels[boi_idx[-1] + 1: eoi_idx[-1] + 1] = IGNORE_INDEX
    return input_ids, attention_mask, labels, ids_cmp_mask, ids_gen_mask


def decode_long_story_sample(value: Dict[str, Any], *, image_dir: str, tokenizer,
                             cfg: StoryDecodeConfig,
                             image_transform: Optional[Callable] = None,
                             sd_image_transform: Optional[Callable] = None,
                             rng: Optional[random.Random] = None,
                             ) -> Optional[Dict[str, np.ndarray]]:
    """One jsonl record {'images': [...], 'captions': [...]} -> sample dict:
    ``randint(0, story_len - 2)`` context images, the next one the target
    (also through ``sd_image_transform`` when given). None on any decode or
    filter failure."""
    if "images" not in value or "captions" not in value:
        return None
    rng = rng or random
    story_len = len(value["images"])
    if story_len < 2:
        return None
    num_image_given = rng.randint(0, story_len - 2)

    from PIL import Image

    try:
        pil_images = []
        for rel in value["images"][: num_image_given + 2]:  # only the images used
            img = Image.open(os.path.join(image_dir, rel))  # lazy: reads the header
            pil_images.append(img)
            width, height = img.size

        aspect_ratio = height / width
        if height < cfg.min_resolution or width < cfg.min_resolution:
            return None
        if aspect_ratio < cfg.min_aspect_ratio or aspect_ratio > 1 / cfg.min_aspect_ratio:
            return None

        extra: Dict[str, np.ndarray] = {}
        if sd_image_transform is not None:  # the target, the last image opened
            sd_tensor = sd_image_transform(pil_images[num_image_given + 1])
            extra["time_ids"] = sdxl_micro_conditioning(height, width, sd_tensor.shape[-2])
            extra["sd_images"] = sd_tensor.astype(np.float32)

        if image_transform is not None:
            images = [image_transform(im) for im in pil_images]
        else:
            images = [np.zeros((3, cfg.image_size, cfg.image_size), np.float32)] * len(pil_images)
    except Exception:
        return None

    captions = value["captions"]
    cmp_tokens = image_comprehension_string(cfg.num_img_in_tokens)
    gen_tokens = image_comprehension_string(cfg.num_img_out_tokens)
    instruction = cfg.instruction_prompt.format_map({"instruction": captions[0] + cmp_tokens})
    for i in range(num_image_given):
        instruction += "[INST]" + captions[i + 1] + cmp_tokens
    response = "[INST]" + captions[num_image_given + 1] + gen_tokens

    input_ids, labels = _encode_spans(tokenizer, instruction, response, cfg.system_message)
    fin = _finalize_sample(tokenizer, input_ids, labels, cfg, num_cmp_images=num_image_given + 1)
    if fin is None:
        return None
    input_ids, attention_mask, labels, ids_cmp_mask, ids_gen_mask = fin

    embeds_cmp_mask = np.zeros(cfg.max_images, bool)
    embeds_gen_mask = np.zeros(cfg.max_images, bool)
    embeds_cmp_mask[: num_image_given + 1] = True
    embeds_gen_mask[num_image_given + 1] = True
    if len(images) > cfg.max_images:
        raise ValueError(f"{len(images)} images exceed max_images={cfg.max_images}")
    padded = np.zeros((cfg.max_images, *images[0].shape), np.float32)
    padded[: len(images)] = np.stack(images)

    return {
        "input_ids": input_ids,
        "attention_mask": attention_mask,
        "labels": labels,
        "ids_cmp_mask": ids_cmp_mask,
        "ids_gen_mask": ids_gen_mask,
        "embeds_cmp_mask": embeds_cmp_mask,
        "embeds_gen_mask": embeds_gen_mask,
        "images": padded,
        "num_images": np.int32(num_image_given + 2),
        **extra,
    }


def decode_t2i_sample(value: Dict[str, Any], *, image_dir: str, tokenizer,
                      cfg: StoryDecodeConfig, image_transform: Optional[Callable] = None,
                      sd_image_transform: Optional[Callable] = None,
                      instruction_prompt: str = "[INST] {instruction} [/INST]\n",
                      ) -> Optional[Dict[str, np.ndarray]]:
    """One text-to-image record {'image': ..., 'caption': ...} -> sample
    dict: the caption as the instruction, the image as the one generated
    target (never context), on image slot 0. None on any decode or filter
    failure."""
    if "image" not in value or "caption" not in value:
        return None
    from PIL import Image

    try:
        img = Image.open(os.path.join(image_dir, value["image"]))  # lazy: reads the header
        width, height = img.size
        aspect_ratio = height / width
        if height < cfg.min_resolution or width < cfg.min_resolution:
            return None
        if aspect_ratio < cfg.min_aspect_ratio or aspect_ratio > 1 / cfg.min_aspect_ratio:
            return None
        extra: Dict[str, np.ndarray] = {}
        if sd_image_transform is not None:
            sd_tensor = sd_image_transform(img)
            extra["time_ids"] = sdxl_micro_conditioning(height, width, sd_tensor.shape[-2])
            extra["sd_images"] = sd_tensor.astype(np.float32)
        if image_transform is not None:
            image = image_transform(img)
        else:
            image = np.zeros((3, cfg.image_size, cfg.image_size), np.float32)
    except Exception:
        return None

    gen_tokens = image_comprehension_string(cfg.num_img_out_tokens)
    instruction = instruction_prompt.format_map({"instruction": value["caption"]})
    input_ids, labels = _encode_spans(tokenizer, instruction, gen_tokens, cfg.system_message)
    fin = _finalize_sample(tokenizer, input_ids, labels, cfg, num_cmp_images=0)
    if fin is None:
        return None
    input_ids, attention_mask, labels, ids_cmp_mask, ids_gen_mask = fin
    embeds_gen_mask = np.zeros(cfg.max_images, bool)
    embeds_gen_mask[0] = True
    images = np.zeros((cfg.max_images, *image.shape), np.float32)
    images[0] = image
    return {
        "input_ids": input_ids,
        "attention_mask": attention_mask,
        "labels": labels,
        "ids_cmp_mask": ids_cmp_mask,
        "ids_gen_mask": ids_gen_mask,
        "embeds_cmp_mask": np.zeros(cfg.max_images, bool),
        "embeds_gen_mask": embeds_gen_mask,
        "images": images,
        "num_images": np.int32(1),
        **extra,
    }


def collate(batch: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stacks samples; every key is already of static shape."""
    if not batch:
        raise ValueError("empty batch")
    return {k: np.stack([b[k] for b in batch], axis=0) for k in batch[0]}


def flatten_images(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """(B, max_images, ...) images and masks -> (B * max_images, ...), the
    agent's flattened image axis."""
    out = dict(batch)
    b, m = batch["images"].shape[:2]
    out["images"] = batch["images"].reshape(b * m, *batch["images"].shape[2:])
    out["embeds_cmp_mask"] = batch["embeds_cmp_mask"].reshape(b * m)
    out["embeds_gen_mask"] = batch["embeds_gen_mask"].reshape(b * m)
    return out
