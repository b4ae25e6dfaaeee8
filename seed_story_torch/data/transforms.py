"""Host-side image transforms (PIL + numpy); the port's own copy of
``seed_story_tpu/data/transforms.py``. 'clip' (CLIP mean/std), 'clipa'
(ImageNet mean/std) and 'sd' ([-1, 1]), each with keep_ratio
(resize the shorter side, centre crop) or a stretch. Outputs are CHW float32
numpy arrays. PIL is imported where an image is transformed, so the module
imports without it."""

from __future__ import annotations

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class ImageTransform:
    """Callable: PIL.Image -> float32 CHW numpy array."""

    def __init__(self, type: str = "clip", keep_ratio: bool = True, image_size: int = 224):
        if type not in ("clip", "clipa", "sd"):
            raise ValueError(f"unknown transform type {type!r}")
        self.type = type
        self.keep_ratio = keep_ratio
        self.image_size = image_size

    def __call__(self, img) -> np.ndarray:
        from PIL import Image

        # bilinear for 'clip', bicubic for 'sd', as torchvision's transforms
        resample = Image.BICUBIC if self.type == "sd" else Image.BILINEAR
        size = self.image_size
        img = img.convert("RGB")
        if self.keep_ratio:
            w, h = img.size
            if w <= h:
                new_w, new_h = size, max(1, round(h * size / w))
            else:
                new_w, new_h = max(1, round(w * size / h)), size
            img = img.resize((new_w, new_h), resample)
            left, top = (new_w - size) // 2, (new_h - size) // 2
            img = img.crop((left, top, left + size, top + size))
        else:
            img = img.resize((size, size), resample)
        x = np.asarray(img, np.float32) / 255.0  # HWC
        if self.type == "clip":
            x = (x - CLIP_MEAN) / CLIP_STD
        elif self.type == "clipa":
            x = (x - IMAGENET_MEAN) / IMAGENET_STD
        else:
            x = x * 2.0 - 1.0
        return np.transpose(x, (2, 0, 1))


def get_transform(type: str = "clip", keep_ratio: bool = True,
                  image_size: int = 224) -> ImageTransform:
    return ImageTransform(type=type, keep_ratio=keep_ratio, image_size=image_size)
