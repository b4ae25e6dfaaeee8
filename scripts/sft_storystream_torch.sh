#!/usr/bin/env bash
# Stage-2 SFT on StoryStream with the PyTorch port on 8 CUDA cards (the flags
# of scripts/sft_storystream.sh: lr 1e-4, bf16, 6000 steps, warmup 100, cosine
# min-ratio 0.05; ZeRO-2 == the fsdp preset). The --pretrained_* files come
# from the released checkpoints through
#   python -m seed_story_torch.tools.convert_torch_weights --family qwen_vit \
#     --input pretrained/visual_tokenizer/qwen_vit_G.pt --output pretrained/visual_tokenizer/qwen_vit_G_torch.pt
#   python -m seed_story_torch.tools.convert_torch_weights --family agent \
#     --input pretrained/seed_story/agent_seedx/pytorch_model.bin --output pretrained/seed_story/agent_seedx_torch.pt
set -e
exec torchrun --nproc_per_node 8 -m seed_story_torch.train.train_clm_sft \
  --image_transform configs/processer/qwen_448_transform.yaml \
  --tokenizer configs/tokenizer/clm_llama_tokenizer.yaml \
  --visual_encoder configs/visual_tokenizer/qwen_vitg_448.yaml \
  --llm_model configs/clm_models/llama2chat7b_lora.yaml \
  --agent_model configs/clm_models/agent_7b_seedx_pretrained.yaml \
  --train_dataset configs/data/george_sft.yaml \
  --pretrained_vit_path pretrained/visual_tokenizer/qwen_vit_G_torch.pt \
  --pretrained_agent_path pretrained/seed_story/agent_seedx_torch.pt \
  --output_dir output/sft_storystream \
  --learning_rate 1e-4 --max_steps 6000 --warmup_steps 100 \
  --min_lr_ratio 0.05 --save_steps 1000 --mesh_data 8 --sharding fsdp "$@"
