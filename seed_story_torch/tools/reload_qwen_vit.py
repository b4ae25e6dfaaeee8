"""Extract the visual tower from a Qwen-VL-Chat checkpoint; counterpart of
``seed_story_tpu/tools/reload_qwen_vit.py`` with the same flags.

It takes the ``transformer.visual.*`` subtree of the full Qwen-VL-Chat
state dict (or an already-extracted ``qwen_vit_G.pt``), checks it against
the state dict of the port's ``VisionTransformerWithAttnPool`` (whose
names are Qwen's own, so no conversion is needed) and writes it with
``train/checkpoint.py::save_params``; ``--torch_output`` also writes the
raw subtree, as the JAX tool does. ``--layers`` sets the tower's depth for
the check.

    python -m seed_story_torch.tools.reload_qwen_vit \\
        --qwen_checkpoint qwen.pt --output vit.pt [--torch_output qwen_vit_G.pt]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "transformer.visual."


def visual_subtree(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The ``transformer.visual.*`` entries without the prefix, or ``sd``
    itself when it has none (an already-extracted tower)."""
    visual = {k[len(PREFIX):]: v for k, v in sd.items() if k.startswith(PREFIX)}
    return visual or dict(sd)


def check_against_vit(visual: Dict[str, torch.Tensor], vit_cfg
                      ) -> Tuple[List[str], List[str], List[str]]:
    """(missing, unexpected, shape-mismatched) names of ``visual`` against
    the port's ViT built on the meta device from ``vit_cfg``."""
    from ..models.vit import VisionTransformerWithAttnPool

    with torch.device("meta"):
        target = VisionTransformerWithAttnPool(vit_cfg).state_dict()
    missing = [k for k in target if k not in visual]
    unexpected = [k for k in visual if k not in target]
    mismatched = [k for k in target if k in visual
                  and tuple(visual[k].shape) != tuple(target[k].shape)]
    return missing, unexpected, mismatched


def main(argv=None, vit_cfg=None):
    """``vit_cfg``: the tower to check against (default: ViT-bigG at
    ``--layers``)."""
    p = argparse.ArgumentParser()
    p.add_argument("--qwen_checkpoint", required=True,
                   help="Qwen-VL-Chat pytorch checkpoint (.pt/.bin)")
    p.add_argument("--output", required=True, help="parameter file to write")
    p.add_argument("--torch_output", default=None,
                   help="optionally also write the torch-format qwen_vit_G.pt")
    p.add_argument("--layers", type=int, default=48)
    a = p.parse_args(argv)

    from ..models.vit import ViTConfig
    from ..train.checkpoint import save_params

    sd = torch.load(a.qwen_checkpoint, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    visual = visual_subtree(sd)
    if a.torch_output:
        torch.save(visual, a.torch_output)
    cfg: Optional[ViTConfig] = vit_cfg
    if cfg is None:
        cfg = ViTConfig()
    cfg = dataclasses.replace(cfg, layers=a.layers)
    missing, unexpected, mismatched = check_against_vit(visual, cfg)
    print(f"missing keys: {len(missing)}, unexpected keys: {len(unexpected)}, "
          f"shape mismatches: {len(mismatched)}")
    save_params(a.output, visual)
    print(f"saved to {a.output}")
    return missing, unexpected, mismatched


if __name__ == "__main__":
    main()
