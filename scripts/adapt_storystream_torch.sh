#!/usr/bin/env bash
# Stage-3 de-tokenizer adaptation with the PyTorch port on 8 CUDA cards (the
# flags of scripts/adapt_storystream.sh: lr 1e-4, 1600 steps, grad-accum 4,
# warmup 500, 1024px SDXL). The --pretrained_* files come from the released
# checkpoints through python -m seed_story_torch.tools.convert_torch_weights
# (--family qwen_vit, agent, detokenizer and sdxl_vae; the agent is the
# stage-2 SFT one).
set -e
exec torchrun --nproc_per_node 8 -m seed_story_torch.train.train_sdxl_img2img_llm \
  --image_transform configs/processer/qwen_448_transform.yaml \
  --sd_image_transform configs/processer/sd_transform_1024.yaml \
  --tokenizer configs/tokenizer/clm_llama_tokenizer.yaml \
  --visual_encoder configs/visual_tokenizer/qwen_vitg_448.yaml \
  --llm_model configs/clm_models/llama2chat7b_lora.yaml \
  --agent_model configs/clm_models/agent_7b_sft.yaml \
  --adapter configs/detokenizer/detokenizer_sdxl_qwen_vit_pretrained.yaml \
  --vae configs/detokenizer/sdxl_vae.yaml \
  --train_dataset configs/data/george_sdxl.yaml \
  --pretrained_vit_path pretrained/visual_tokenizer/qwen_vit_G_torch.pt \
  --pretrained_agent_path pretrained/seed_story/george_sft_torch.pt \
  --pretrained_adapter_path pretrained/detokenizer/detokenizer_pretrained_torch.pt \
  --pretrained_vae_path pretrained/sdxl/vae_torch.pt \
  --output_dir output/adapt_storystream \
  --learning_rate 1e-4 --max_steps 1600 --warmup_steps 500 \
  --gradient_accumulation_steps 4 --save_steps 400 --mesh_data 8 --sharding fsdp "$@"
