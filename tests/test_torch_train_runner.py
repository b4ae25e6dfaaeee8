"""The port's training runner on the CPU at pico size: resume replays an
uninterrupted run bit for bit (LoRA dropout on, data position restored),
the checkpoint manager keeps whole checkpoints only, ``load_params_partial``
reports what it could not load and never casts int8 entries to float or
float entries to int8, ``load_checkpoint_`` refuses a file that shares no
entry with the module (a released layout not yet converted) and prints its
counts, and the stage-2 (also with a ``quantize_base`` YAML
and int8 or float ``--pretrained_agent_path`` files) and stage-3 entry points
(``seed_story_torch.train.train_clm_sft.main``,
``seed_story_torch.train.train_sdxl_img2img_llm.main``) run from YAML
configs and jsonl + jpg data on disk and resume."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from seed_story_torch.inference.common import fill_module
from seed_story_torch.models.agent import AgentConfig, ContinuousLVLM
from seed_story_torch.models.llama import LlamaConfig, LlamaForCausalLM, quantize_llama_
from seed_story_torch.train.checkpoint import (CheckpointManager, load_checkpoint_,
                                               load_params_partial, save_params)
from seed_story_torch.train.runner import RunnerArgs, run_training
from seed_story_torch.train.stage2 import make_stage2_loss_fn
from seed_story_torch.train.trainer import TrainConfig, Trainer
from test_torch_train import tiny_batch


class CountingSource:
    """Endless batches with a position: batch i is made from seed i."""

    def __init__(self):
        self.position = 0

    def state(self):
        return {"position": self.position}

    def set_state(self, state):
        self.position = int(state["position"])

    def __iter__(self):
        while True:
            batch = tiny_batch(bs=1, seed=self.position)
            self.position += 1
            yield batch


def _pico_agent():
    cfg = AgentConfig.tiny(llm=LlamaConfig.tiny(dtype=torch.float32, num_hidden_layers=1,
                                                lora_rank=2, lora_dropout=0.2))
    return fill_module(ContinuousLVLM, cfg, "cpu", seed=0)


def _run(out_dir, max_steps, resume=False):
    agent, source = _pico_agent(), CountingSource()
    args = RunnerArgs(output_dir=str(out_dir), max_steps=max_steps, save_steps=100, log_steps=1,
                      resume_from_checkpoint=str(out_dir) if resume else None, seed=3)
    trainer = run_training(args, TrainConfig(learning_rate=1e-3, warmup_steps=1,
                                             training_steps=4),
                           agent, make_stage2_loss_fn(agent), source, data_source=source)
    return trainer, source


def test_resume_replays_an_uninterrupted_run_bitwise(tmp_path):
    straight, _ = _run(tmp_path / "straight", 4)
    _run(tmp_path / "resumed", 2)
    resumed, source = _run(tmp_path / "resumed", 4, resume=True)
    assert straight.step_count == resumed.step_count == 4
    for (name, a), b in zip(straight.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    for name in straight.mu:
        assert torch.equal(straight.mu[name], resumed.mu[name]), name
        assert torch.equal(straight.nu[name], resumed.nu[name]), name
    assert CheckpointManager(str(tmp_path / "resumed")).steps() == [2, 4]
    with open(tmp_path / "resumed" / "4" / "meta.json") as f:
        assert json.load(f) == {"step": 4, "data_state": {"position": 4}}
    lines = [json.loads(line) for line in
             (tmp_path / "resumed" / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines if "loss" in m] == [1, 2, 3, 4]
    assert all(m["step_seconds"] == m["fwd_bwd_seconds"] + m["update_seconds"] > 0
               for m in lines if "loss" in m)
    assert [m["step"] for m in lines if "checkpoint_write_seconds" in m] == [2, 4]


def test_checkpoint_manager_keeps_the_newest_whole_checkpoints(tmp_path):
    agent = _pico_agent()
    trainer = Trainer(agent, make_stage2_loss_fn(agent), TrainConfig())
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        trainer.step_count = step
        assert mgr.save(step, trainer, data_state={"at": step})
    assert not mgr.save(3, trainer)  # already saved
    mgr.wait()
    assert mgr.steps() == [2, 3] and sorted(os.listdir(tmp_path)) == ["2", "3"]
    trainer.step_count = 0
    assert mgr.restore(trainer, step=2) == (2, {"at": 2})
    assert trainer.step_count == 2
    assert CheckpointManager(str(tmp_path / "empty")).restore(trainer) == (None, None)


def test_load_params_partial_reports_missing_and_unexpected(tmp_path):
    target = {"a": torch.zeros(2, 3), "b": torch.zeros(4), "c": torch.zeros(5, dtype=torch.bfloat16)}
    saved = {"a": torch.ones(2, 3), "b": torch.ones(3), "c": torch.ones(5), "extra": torch.ones(1)}
    save_params(str(tmp_path / "p.pt"), saved)
    merged, missing, unexpected = load_params_partial(str(tmp_path / "p.pt"), target)
    assert sorted(missing) == ["b"] and unexpected == ["extra"]  # a shape mismatch is missing
    assert torch.equal(merged["a"], torch.ones(2, 3)) and torch.equal(merged["b"], torch.zeros(4))
    assert merged["c"].dtype == torch.bfloat16 and torch.equal(merged["c"].float(), torch.ones(5))


def test_load_params_partial_never_crosses_int8_and_float(tmp_path):
    """An int8 entry saved by a quantize_base run is not cast into a float
    target (its integers would read as weights), nor a float entry into an
    int8 target (truncated to integers): both count as missing and leave the
    target's value. ``load_checkpoint_`` loads the float entries before its
    quantizer runs and the int8 ones after."""
    target = {"w_float": torch.zeros(2, 3), "w_int8": torch.zeros(2, 3, dtype=torch.int8),
              "b": torch.zeros(3)}
    saved = {"w_float": torch.full((2, 3), 7, dtype=torch.int8),
             "w_int8": torch.full((2, 3), 0.75), "b": torch.ones(3)}
    save_params(str(tmp_path / "p.pt"), saved)
    merged, missing, unexpected = load_params_partial(str(tmp_path / "p.pt"), target)
    assert sorted(missing) == ["w_float", "w_int8"] and unexpected == []
    assert torch.equal(merged["w_float"], target["w_float"])
    assert torch.equal(merged["w_int8"], target["w_int8"]) and torch.equal(merged["b"], saved["b"])

    def float_agent(seed):
        return fill_module(ContinuousLVLM, _pico_agent().cfg, "cpu", seed=seed)

    quantized = quantize_llama_(float_agent(4))
    save_params(str(tmp_path / "int8.pt"), quantized.state_dict())
    save_params(str(tmp_path / "f32.pt"), float_agent(4).state_dict())
    for path in ("int8.pt", "f32.pt"):  # either gives the int8 agent's bytes
        got = load_checkpoint_(float_agent(0), str(tmp_path / path), quantize_llama_)
        for key, value in quantized.state_dict().items():
            assert torch.equal(got.state_dict()[key], value), (path, key)


@pytest.mark.parametrize("quantize", [None, quantize_llama_])
def test_load_checkpoint_refuses_a_released_layout_and_reports_counts(tmp_path, capsys,
                                                                       quantize):
    """A PEFT-prefixed file (a released checkpoint not yet converted) shares no
    entry with the module: ``load_checkpoint_`` raises, naming the converter,
    and changes nothing. A partial file prints its missing and unexpected
    counts once, as the JAX ``load_params_partial`` does; with a quantizer, a
    projection whose float weight was not in the file misses its scale too."""
    def llm(seed):
        return fill_module(LlamaForCausalLM, LlamaConfig.tiny(
            dtype=torch.float32, num_hidden_layers=1, lora_rank=2), "cpu", seed=seed)

    target, source = llm(0), llm(1)
    before = {k: v.clone() for k, v in target.state_dict().items()}
    save_params(str(tmp_path / "peft.pt"), {f"base_model.model.{k}": v
                                            for k, v in source.state_dict().items()})
    with pytest.raises(ValueError, match="seed_story_torch.tools.convert_torch_weights"):
        load_checkpoint_(target, str(tmp_path / "peft.pt"), quantize)
    for k, v in target.state_dict().items():
        assert torch.equal(v, before[k]), k

    partial = dict(source.state_dict())
    del partial["model.norm.weight"], partial["model.layers.0.self_attn.q_proj.weight"]
    partial["extra.weight"] = torch.ones(2)
    path = str(tmp_path / "partial.pt")
    save_params(path, partial)
    capsys.readouterr()
    load_checkpoint_(target, path, quantize)
    missing = 2 if quantize is None else 3  # q_proj.weight_scale: from a random weight
    assert capsys.readouterr().out == (f"partial load from {path}: missing keys: {missing}, "
                                       "unexpected keys: 1\n")
    assert torch.equal(target.state_dict()["model.layers.0.mlp.up_proj.lora_A.weight"],
                       source.state_dict()["model.layers.0.mlp.up_proj.lora_A.weight"])


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """``tests/test_train_entries.py::workspace``, stage-2 and stage-3 parts:
    pico YAML configs and three 4-image stories of jpgs and jsonl."""
    root = tmp_path_factory.mktemp("ws")
    img_dir = root / "images"
    img_dir.mkdir()
    records = []
    for s in range(3):
        names = []
        for i in range(4):
            name = f"s{s}_{i}.jpg"
            Image.new("RGB", (256, 256), (s * 50, i * 60, 120)).save(img_dir / name)
            names.append(name)
        records.append({"images": names,
                        "captions": [f"story {s} scene {i} with a happy dog" for i in range(4)]})
    (root / "data").mkdir()
    with open(root / "data" / "train.jsonl", "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    cfg = root / "configs"
    cfg.mkdir()
    f32 = ("dtype:\n  _target_: seed_story_tpu.utils.config.resolve_target\n"
           "  path: jax.numpy.float32\n")
    (cfg / "tokenizer.yaml").write_text("_target_: seed_story_tpu.data.tokenizer.TinyTokenizer\n")
    (cfg / "transform.yaml").write_text(
        "_target_: seed_story_tpu.data.transforms.get_transform\n"
        "type: clip\nimage_size: 28\nkeep_ratio: False\n")
    (cfg / "vit.yaml").write_text(
        "_target_: seed_story_tpu.models.vit.ViTConfig\n"
        "image_size: 28\npatch_size: 14\nwidth: 32\nlayers: 1\nheads: 2\n"
        "mlp_ratio: 2.0\nn_queries: 9\noutput_dim: 64\n" + f32)
    (cfg / "llm.yaml").write_text(
        "_target_: seed_story_tpu.models.llama.LlamaConfig\n"
        "vocab_size: 32066\nhidden_size: 64\nintermediate_size: 128\n"
        "num_hidden_layers: 1\nnum_attention_heads: 2\nlora_rank: 2\n"
        "remat: true\nscan_layers: true\nce_chunk_size: 32\n" + f32)
    (cfg / "llm_int8.yaml").write_text(  # the one-chip recipe's switches at pico size
        "_target_: seed_story_tpu.models.llama.LlamaConfig\n"
        "vocab_size: 32066\nhidden_size: 64\nintermediate_size: 128\n"
        "num_hidden_layers: 1\nnum_attention_heads: 2\nlora_rank: 2\n"
        "remat: true\nscan_layers: true\nce_chunk_size: 32\nquantize_base: true\n" + f32)
    (cfg / "agent.yaml").write_text(
        "_target_: seed_story_tpu.models.agent.AgentConfig\n"
        "input_resampler_grid: 2\noutput_resampler_grid: 3\n"
        "num_img_out_tokens: 4\nresampler_heads: 2\nvit_dim: 64\n")
    (cfg / "sd_transform.yaml").write_text(
        "_target_: seed_story_tpu.data.transforms.get_transform\n"
        "type: sd\nimage_size: 32\nkeep_ratio: True\n")
    (cfg / "adapter.yaml").write_text(
        "_target_: seed_story_tpu.models.sdxl.adapter.SDXLAdapterConfig\n"
        "resampler_dim: 32\nresampler_depth: 1\nresampler_heads: 2\n"
        "resampler_queries: 4\nembedding_dim: 64\noutput1_dim: 32\noutput2_dim: 64\n"
        "unet:\n"
        "  _target_: seed_story_tpu.models.sdxl.unet.SDXLUNetConfig\n"
        "  block_out_channels: [16, 32, 32]\n  transformer_layers_per_block: [1, 1, 1]\n"
        "  attention_head_dim: 8\n  cross_attention_dim: 32\n"
        "  addition_time_embed_dim: 8\n  projection_class_embeddings_input_dim: 112\n"
        "  pooled_projection_dim: 64\n  norm_num_groups: 8\n"
        + "".join("  " + line + "\n" for line in f32.splitlines()))
    (cfg / "vae.yaml").write_text(
        "_target_: seed_story_tpu.models.sdxl.vae.VAEConfig\n"
        "block_out_channels: [16, 32, 32, 32]\nnorm_num_groups: 8\n" + f32)
    (cfg / "data.yaml").write_text(
        "_target_: seed_story_tpu.data.builders.build_multi_datapipes\n"
        "_recursive_: False\n"
        "datapipes:\n"
        "  - _target_: seed_story_tpu.data.builders.build_long_story_datapipe\n"
        f"    data_dir: {root}/data\n"
        f"    image_dir: {root}/images\n"
        "    max_length: 128\n    batch_size: 2\n"
        "    instruction_prompt: \"{instruction}\"\n"
        "    min_aspect_ratio: 0.2\n    min_resolution: 64\n"
        "    num_img_in_tokens: 4\n    num_img_out_tokens: 4\n"
        "    cycle_count: 50\n    story_len: 4\n"
        "sample_weights:\n  - 1.0\n")
    # stage 1: text-to-image records over the same jpgs, a VQ tokenizer
    (root / "t2i").mkdir()
    with open(root / "t2i" / "train.jsonl", "w") as f:
        for s in range(3):
            for i in range(4):
                f.write(json.dumps({"image": f"s{s}_{i}.jpg",
                                    "caption": f"a happy dog in scene {i} of story {s}"}) + "\n")
    (cfg / "t2i.yaml").write_text(
        "_target_: seed_story_tpu.data.builders.build_t2i_datapipe\n"
        f"data_dir: {root}/t2i\nimage_dir: {root}/images\n"
        "max_length: 64\nbatch_size: 3\nmin_aspect_ratio: 0.2\nmin_resolution: 64\n"
        "num_img_out_tokens: 4\ncycle_count: 50\n")
    (cfg / "discrete.yaml").write_text(
        "_target_: seed_story_tpu.models.discrete.DiscreteModelDistill\n"
        "use_vq: true\n"
        "cfg:\n  _target_: seed_story_tpu.models.discrete.DiscreteConfig\n"
        "  dim: 32\n  codebook_size: 16\n")
    return root


def test_stage2_entry_runs_from_yaml_and_resumes(workspace):
    from seed_story_torch.train.train_clm_sft import main

    cfg, out = workspace / "configs", workspace / "out_sft"
    argv = ["--image_transform", str(cfg / "transform.yaml"),
            "--tokenizer", str(cfg / "tokenizer.yaml"),
            "--visual_encoder", str(cfg / "vit.yaml"),
            "--llm_model", str(cfg / "llm.yaml"),
            "--agent_model", str(cfg / "agent.yaml"),
            "--train_dataset", str(cfg / "data.yaml"),
            "--output_dir", str(out), "--learning_rate", "1e-3", "--max_steps", "3",
            "--save_steps", "2", "--log_steps", "1", "--warmup_steps", "1", "--sharding", "fsdp",
            "--profile_start", "1", "--profile_stop", "2"]
    if not torch.cuda.is_available():  # no CPU continuation without being asked
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    trainer = main(argv, device="cpu")
    assert trainer.step_count == 3
    assert trainer.model.cfg.llm.remat and trainer.model.cfg.llm.ce_chunk_size == 32
    assert (out / "2").is_dir() and (out / "3").is_dir()
    assert (out / "profile_trace.json").exists() and (out / "profile_kernels.txt").exists()
    logged = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    losses = [m["loss"] for m in logged if "loss" in m]
    assert len(losses) == 3 and np.isfinite(losses).all()
    with open(out / "3" / "meta.json") as f:
        assert json.load(f)["data_state"] is not None  # the datapipe position travels along

    trainer = main(argv + ["--resume_from_checkpoint", str(out), "--max_steps", "4"],
                   device="cpu")
    assert trainer.step_count == 4 and (out / "4").is_dir()


def test_stage2_entry_trains_a_quantize_base_agent(workspace):
    """``train_clm_sft`` on a quantize_base YAML: the filled agent's seven
    projections become int8 in place, the optimizer holds no int8 weight or
    scale, they are bit for bit unchanged after training while LoRA moves,
    and ``--pretrained_agent_path`` loads an int8 checkpoint (the run's own
    parameters) after the quantization and a float one before it."""
    from seed_story_torch.train.train_clm_sft import main

    cfg = workspace / "configs"
    argv = ["--image_transform", str(cfg / "transform.yaml"),
            "--tokenizer", str(cfg / "tokenizer.yaml"),
            "--visual_encoder", str(cfg / "vit.yaml"),
            "--llm_model", str(cfg / "llm_int8.yaml"),
            "--agent_model", str(cfg / "agent.yaml"),
            "--train_dataset", str(cfg / "data.yaml"), "--learning_rate", "1e-3",
            "--max_steps", "2", "--save_steps", "100", "--log_steps", "1", "--warmup_steps", "1"]
    trainer = main(argv + ["--output_dir", str(workspace / "out_q")], device="cpu")
    agent = trainer.model
    assert agent.cfg.llm.quantize_base and trainer.step_count == 2
    fresh = quantize_llama_(fill_module(ContinuousLVLM, agent.cfg, "cpu", seed=42))
    int8 = {k for k, v in agent.state_dict().items()
            if v.dtype == torch.int8 or k.endswith("weight_scale")}
    assert len(int8) == 2 * 7 * agent.cfg.llm.num_hidden_layers
    assert not int8 & set(trainer.params)
    after = agent.state_dict()
    for key in int8:
        assert torch.equal(after[key], fresh.state_dict()[key]), key
    lora_b = "llm.model.layers.0.self_attn.q_proj.lora_B.weight"
    assert not torch.equal(after[lora_b], fresh.state_dict()[lora_b])

    save_params(str(workspace / "agent_int8.pt"), after)
    other = fill_module(ContinuousLVLM, dataclasses.replace(
        agent.cfg, llm=dataclasses.replace(agent.cfg.llm, quantize_base=False)), "cpu", seed=9)
    save_params(str(workspace / "agent_f32.pt"), other.state_dict())
    want_f32 = quantize_llama_(other).state_dict()
    for path, want in (("agent_int8.pt", after), ("agent_f32.pt", want_f32)):
        got = main(argv + ["--output_dir", str(workspace / f"out_{path}"), "--max_steps", "1",
                           "--pretrained_agent_path", str(workspace / path)],
                   device="cpu").model.state_dict()
        for key in int8:
            assert torch.equal(got[key], want[key]), (path, key)


def _stage1_argv(workspace, discrete="discrete.yaml", out="out_discrete"):
    cfg = workspace / "configs"
    return ["--image_transform", str(cfg / "transform.yaml"),
            "--tokenizer", str(cfg / "tokenizer.yaml"),
            "--visual_encoder", str(cfg / "vit.yaml"),
            "--discrete_model", str(cfg / discrete),
            "--train_dataset", str(cfg / "t2i.yaml"),
            "--output_dir", str(workspace / out), "--learning_rate", "1e-3", "--max_steps", "3",
            "--save_steps", "2", "--log_steps", "1", "--warmup_steps", "1"]


def test_stage1_entry_runs_from_yaml_and_resumes(workspace):
    """``train.main`` on t2i records: a VQ ``DiscreteModelDistill`` over the
    frozen pico ViT's features, its loss metrics logged, resumed to step 4;
    the ViT unchanged."""
    from seed_story_torch.train.train import main

    out = workspace / "out_discrete"
    argv = _stage1_argv(workspace)
    if not torch.cuda.is_available():  # no CPU continuation without being asked
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    trainer = main(argv, device="cpu")
    model = trainer.model
    assert trainer.step_count == 3 and model.use_vq and model.encode_proj.in_features == 64
    assert sorted(trainer.params) == sorted(name for name, _ in model.named_parameters())
    logged = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    steps = [m for m in logged if "loss" in m]
    assert len(steps) == 3
    for key in ("loss", "distill_loss", "commit_loss", "codebook_loss"):
        assert all(np.isfinite(m[key]) for m in steps), key
    assert not any("codes" in m or "code_usage" in m for m in steps)  # as the JAX entry
    with open(out / "3" / "meta.json") as f:
        assert json.load(f)["data_state"] is not None
    trainer = main(argv + ["--resume_from_checkpoint", str(out), "--max_steps", "4"],
                   device="cpu")
    assert trainer.step_count == 4 and (out / "4").is_dir()


def test_stage1_entry_refuses_a_mesh_and_a_model_without_parameters(workspace):
    """``--mesh_data 2`` on a world of one process: a mesh larger than the
    world, refused as the JAX ``make_mesh`` refuses it; the shipped
    ``discrete_identity.yaml`` (no parameters) with a KeyError, the kind of
    error the JAX entry raises on its empty parameter tree."""
    from seed_story_torch.train.train import main
    from seed_story_tpu.train.train import main as jax_main

    with pytest.raises(ValueError, match="mesh 2x1 > 1 devices"):
        main(_stage1_argv(workspace) + ["--mesh_data", "2"], device="cpu")
    shipped = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs", "discrete_model", "discrete_identity.yaml")
    argv = _stage1_argv(workspace, out="out_identity")
    argv[argv.index("--discrete_model") + 1] = shipped
    with pytest.raises(KeyError, match="params"):
        main(argv, device="cpu")
    with pytest.raises(KeyError, match="params"):
        jax_main(argv)
    assert not (workspace / "out_identity").exists()


def test_stage3_entry_runs_from_yaml_and_resumes(workspace):
    from seed_story_torch.train.train_sdxl_img2img_llm import main

    cfg, out = workspace / "configs", workspace / "out_sdxl"
    argv = ["--image_transform", str(cfg / "transform.yaml"),
            "--sd_image_transform", str(cfg / "sd_transform.yaml"),
            "--tokenizer", str(cfg / "tokenizer.yaml"),
            "--visual_encoder", str(cfg / "vit.yaml"),
            "--llm_model", str(cfg / "llm.yaml"),
            "--agent_model", str(cfg / "agent.yaml"),
            "--adapter", str(cfg / "adapter.yaml"),
            "--vae", str(cfg / "vae.yaml"),
            "--train_dataset", str(cfg / "data.yaml"),
            "--output_dir", str(out), "--max_steps", "2", "--save_steps", "2",
            "--log_steps", "1", "--warmup_steps", "1", "--gradient_accumulation_steps", "1",
            "--sharding", "dp"]
    # meshes larger than the world of one process, refused as the JAX make_mesh refuses them
    for mesh, match in ((["--mesh_data", "2"], "mesh 2x1 > 1 devices"),
                        (["--mesh_model", "2"], "1 devices not divisible by model=2")):
        with pytest.raises(ValueError, match=match):
            main(argv + mesh, device="cpu")
    if not torch.cuda.is_available():  # no CPU continuation without being asked
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    trainer = main(argv, device="cpu")
    assert trainer.step_count == 2 and (out / "2").is_dir()
    trained = sorted(trainer.params)
    assert trained and all(n.startswith("resampler.") or n.split(".")[-2] in ("to_k", "to_v")
                           for n in trained)
    assert any(".attn1.to_k." in n for n in trained) and any(".attn2.to_v." in n for n in trained)
    logged = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    losses = [m["mse_loss"] for m in logged if "mse_loss" in m]
    assert len(losses) == 2 and np.isfinite(losses).all()
    with open(out / "2" / "meta.json") as f:
        assert json.load(f)["data_state"] is not None

    trainer = main(argv + ["--resume_from_checkpoint", str(out), "--max_steps", "4"],
                   device="cpu")
    assert trainer.step_count == 4 and (out / "4").is_dir()
