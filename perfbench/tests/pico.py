"""Pico sizes of the benchmark's configurations for CPU tests, and a helper
that runs a cell through ``run.run`` on the CPU (the program's plain kernels,
no look for a card)."""

from __future__ import annotations

import time

import torch

from perfbench import run as bench_run

AGENT = {"config": {"vocab_size": 32066, "padded_vocab_size": 32128, "hidden_size": 64,
                    "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
                    "num_key_value_heads": 4, "max_position_embeddings": 1024,
                    "vit": {"image_size": 56, "patch_size": 14, "width": 32, "layers": 2,
                            "heads": 4, "mlp_ratio": 2.0, "n_queries": 16, "output_dim": 64,
                            "ln_eps": 1e-6},
                    "agent": {"input_resampler_grid": 2, "output_resampler_grid": 4,
                              "num_img_out_tokens": 16, "resampler_heads": 4, "vit_dim": 64}},
         "traffic": {"image_size": 56, "new_tokens": 60, "force_boi_at": 36, "warmup_new_tokens": 40,
                     "warmup_boi_at": 8}}

DETOK = {"config": {"block_out_channels": [32, 64, 64], "transformer_layers_per_block": [1, 1, 2],
                    "attention_head_dim": [2, 4, 4], "cross_attention_dim": 64,
                    "addition_time_embed_dim": 8,
                    "projection_class_embeddings_input_dim": 8 * 6 + 32, "norm_num_groups": 8,
                    "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 4,
                            "block_out_channels": [16, 32], "layers_per_block": 1,
                            "norm_num_groups": 8, "scaling_factor": 0.13025},
                    "resampler": {"dim": 32, "depth": 1, "heads": 2, "queries": 8,
                                  "embedding_dim": 64, "output1_dim": 32, "output2_dim": 32}},
         "traffic": {"feature_tokens": 16, "feature_dim": 64, "height": 64, "width": 64,
                     "steps": 4}}

PICO = {"agent_story_b4": AGENT, "detok_1024_b4": DETOK}


def run_cell(name: str, seed: int, seconds: float = 0.1, control: bool = False) -> dict:
    args = bench_run.parse(["--workload", name, "--seed", str(seed), "--seconds", str(seconds),
                            "--trace", "0", "--control", str(int(control))])
    return bench_run.run(args, device=torch.device("cpu"), t_start=time.perf_counter(),
                         overrides=PICO[name])
