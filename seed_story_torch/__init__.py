"""seed_story_torch: the PyTorch / CUDA port of seed_story_tpu for one
NVIDIA H100. Same layers and names as the JAX package:

  ops/        attention (plain + the CUDA flash forward), RoPE, sincos, GroupNorm
  csrc/       hand-written CUDA kernels, built with nvcc at first use
  models/     ViT-bigG, LLaMA (+LoRA, KV cache), agents, resamplers, discrete
              tokenizers, IP adapters, sdxl/
  decode/     greedy generation with the image-token automaton
  pipelines/  story generation, SDXL and IP-Adapter sampling
  train/      the three training stages' entry points, trainer and runner
  inference/  build_stack: the story stack from configs and weights
  weights.py  JAX parameter trees -> state dicts; seeded random init
"""
