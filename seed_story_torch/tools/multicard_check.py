"""The parallel layer across the cards of one host: five checks, each held
to its one-card counterpart run in the same call on card 0.

    python3 -m seed_story_torch.tools.multicard_check [--checks a b c d e]

Run it from the repository root: it reuses ``chip_smoke.py``'s batches,
step helpers and phases. Its meshes take four cards; with fewer it
raises. ``--checks`` runs some of the checks (default all). The ranks are
processes of its own, one a card over NCCL (rank r on card r); the
one-card runs take place in this process once the ranks are done.

  (a) stage 2 at (data 2, model 2) ``fsdp_tp`` (the vocabulary split over
      ``model``) and at (4, 1) ``fsdp``: LLaMA-2-7B width with
      ``chip_smoke.PARALLEL_LAYERS`` of 32 layers and the frozen ViT-bigG
      (the smoke's world_of_one models, LoRA dropout on), 2 steps on a
      global batch of 4 samples; then at full depth (32 layers) with
      ``quantize_base`` at (4, 1) ``fsdp``, the int8 base held over
      ``data``, and again in the whole-weight layout
      (``chip_smoke.whole_weight_layout``) for its peak memory;
  (b) stage 3 at (2, 2) ``fsdp_tp`` and (4, 1) ``fsdp``, and at (4, 1)
      ``fsdp`` with the FSDP units of before the UNet's blocks were units
      (the UNet one unit), for its peak memory against the blocks':
      ``scripts/adapt_storystream.sh``'s models at full width and depth
      (ViT-bigG, LLaMA-2-7B + LoRA, SDXL VAE, the SDXLAdapter), 2 steps on
      4 targets of 1024x1024; the one-card run takes them as 2
      accumulated microbatches of 2, each with its rows of the step's draws.
      The (2, 2) state is saved whole, then restored at one rank, bit-equal
      to what was saved;
  (c) ``--decode_tp 4`` over cards 0-3 (``chip_smoke.phase_tp_decode``):
      the int8 agent and cache, 64 greedy tokens with EOS banned, under the
      tie rule against tp = 1, with ms/token of both;
  (d) ``--detok_devices 3``: the agent on card 0, a de-tokenizer replica on
      each of cards 1-3 (``chip_smoke.phase_lockstep``, then
      ``phase_serving`` with those replicas): 4 stories, texts equal and
      images within 2/255 of the inline run, the serve wall against the
      inline wall;
  (e) the stage-2 CLI under ``torchrun --nproc_per_node 4``:
      ``train_clm_sft`` on ``llama2chat7b_lora_onechip.yaml`` cut to
      E_LAYERS layers (``quantize_base``) and george_sft-shaped data the
      check writes (``write_sft_workspace``), 2 steps at (2, 2)
      ``fsdp_tp`` saved, resumed under ``torchrun`` at (4, 1) ``fsdp`` for
      a third step; that step's loss within 5e-3 (relative) of an
      uninterrupted (2, 2) run's third, and the saved state restored by
      four ranks at (4, 1) bit-equal to the files.

Limits of (a) and (b) (``chip_smoke.compare_sharded``): losses within 5e-3
and grad norms within 1e-2 of the one-card run's, the first step's gradient
cosine >= 0.999, trained parameters within 2.5 x lr a step, frozen ones
bit-equal; at (2, 2) a rank holds at most 60% of the UNet's parameter
bytes; with the int8 base over 4 data ranks, at most 30% of its bytes.
s/step and peak GiB a rank are printed. Each check prints one JSON line
(``{"check": ...}``); any failure raises, so the process exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

WORLD = 4
MESHES = {"a22": ("stage2", "fsdp_tp", (2, 2)), "a41": ("stage2", "fsdp", (4, 1)),
          "a41_int8": ("stage2_int8", "fsdp", (4, 1)),
          "a41_int8_whole_weights": ("stage2_int8", "fsdp", (4, 1)),
          "b22": ("stage3", "fsdp_tp", (2, 2)), "b41": ("stage3", "fsdp", (4, 1)),
          "b41_one_unet_unit": ("stage3", "fsdp", (4, 1))}
CHECK_OF = {"stage2": "a", "stage2_int8": "a", "stage3": "b"}
CHECKS = ("a", "b", "c", "d", "e")
STEPS = 2
STAGE2_LR = 1e-3
E_LAYERS = 8  # of llama2chat7b_lora_onechip.yaml's 32
E_BATCH = {(2, 2): 2, (4, 1): 1}  # a data rank's samples: a global batch of 4 at both meshes


def _smoke():
    import chip_smoke

    return chip_smoke


@dataclasses.dataclass
class Models:
    """What the checks build: configurations and seeded global batches,
    and the device kind and process-group backend of the ranks (a smaller
    ``Models`` rehearses the checks on the CPU over gloo)."""

    device_type: str = "cuda"
    backend: str = "nccl"

    def vit_cfg(self):
        from ..models.vit import ViTConfig

        return ViTConfig(param_dtype=torch.bfloat16)  # configs/visual_tokenizer/qwen_vitg_448.yaml

    def stage2_agent_cfg(self):
        return _smoke().parallel_agent_cfg(_smoke().PARALLEL_LAYERS)

    def stage2_int8_agent_cfg(self):
        return _smoke().parallel_agent_cfg(32)  # the base quantized once filled

    def sft_configs(self, root: str) -> dict:
        """The flags of check (e)'s ``train_clm_sft``, but the data set:
        the YAMLs of ``scripts/sft_storystream_torch.sh`` with the one-card
        recipe's LLaMA (``quantize_base``) cut to E_LAYERS layers, written
        under ``root``, and the tiny tokenizer (the LLaMA tokenizer's assets
        are not in the repository); the jpgs' side."""
        with open("configs/clm_models/llama2chat7b_lora_onechip.yaml") as f:
            llm = f.read()
        if "num_hidden_layers: 32\n" not in llm:
            raise ValueError("llama2chat7b_lora_onechip.yaml no longer has 32 layers")
        path = os.path.join(root, "llm.yaml")
        with open(path, "w") as f:
            f.write(llm.replace("num_hidden_layers: 32\n", f"num_hidden_layers: {E_LAYERS}\n"))
        return {"image_transform": "configs/processer/qwen_448_transform.yaml",
                "tokenizer": "configs/tokenizer/tiny_tokenizer.yaml",
                "visual_encoder": "configs/visual_tokenizer/qwen_vitg_448.yaml",
                "llm_model": path, "agent_model": "configs/clm_models/agent_7b_sft.yaml",
                "image_size": 448}

    def stage3_agent_cfg(self):
        from ..models.agent import AgentConfig
        from ..models.llama import LlamaConfig

        # configs/clm_models/llama2chat7b_lora.yaml, agent_7b_sft.yaml
        return AgentConfig(llm=LlamaConfig(lora_rank=16, lora_alpha=32.0, lora_dropout=0.05,
                                           param_dtype=torch.bfloat16))

    def adapter_cfg(self):
        from ..models.sdxl.adapter import SDXLAdapterConfig

        return SDXLAdapterConfig()  # detokenizer_sdxl_qwen_vit_pretrained.yaml

    def vae_cfg(self):
        from ..models.sdxl.vae import VAEConfig

        return VAEConfig()

    def stage2_batch(self, agent_cfg) -> dict:
        """4 samples: the smoke's stage-2 batch at two seeds."""
        parts = [_smoke().train_batch(agent_cfg, seed=s) for s in (0, 1)]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def stage3_batch(self, agent_cfg) -> dict:
        """4 samples with their 1024x1024 targets: the smoke's stage-3
        batch at two seeds' stage-2 batches."""
        smoke = _smoke()
        batch = self.stage2_batch(agent_cfg)
        b = batch["input_ids"].shape[0]
        rng = np.random.RandomState(3)
        batch["sd_images"] = rng.uniform(-1.0, 1.0, (b, 3, smoke.SD_SIZE, smoke.SD_SIZE)).astype(
            np.float32)
        batch["time_ids"] = np.array([[smoke.SD_SIZE, smoke.SD_SIZE, 0, 0, smoke.SD_SIZE,
                                       smoke.SD_SIZE]] * b, np.int32)
        return batch


def _fill(cls, cfg, device, seed, frozen=False):
    from ..inference.common import fill_module

    module = fill_module(cls, cfg, device, seed=seed)
    return module.eval().requires_grad_(False) if frozen else module


def _decoder_layer_units():
    """The FSDP units before the UNet's blocks were units: the LLaMA's
    decoder layers only (the adapter's UNet then one unit as a whole)."""
    from ..models.llama import LlamaDecoderLayer, LlamaForCausalLM, LlamaModel

    return (LlamaDecoderLayer,), (LlamaModel, LlamaForCausalLM)


def stage2_run(models: Models, vit, batch, mesh, preset, device, int8: bool = False) -> dict:
    """``chip_smoke.sharded_steps`` of stage 2 (the agent from seed 1;
    ``int8``: at ``stage2_int8_agent_cfg``, its base quantized in place)."""
    from ..inference.common import quantize_agent_
    from ..models.agent import ContinuousLVLM
    from ..train.stage2 import make_stage2_loss_fn

    smoke = _smoke()
    cfg = models.stage2_int8_agent_cfg() if int8 else models.stage2_agent_cfg()
    agent = _fill(ContinuousLVLM, cfg, device, seed=1)
    if int8:
        quantize_agent_(agent, base=True, kv=False)
    out = smoke.sharded_steps(agent, make_stage2_loss_fn(agent, vit), smoke.stage2_mask(agent),
                              batch, mesh, preset, STEPS, STAGE2_LR)
    del agent
    smoke.free_memory()
    return out


def rows_of_the_step_draw(accum: int):
    """A stage-3 ``draw`` for a one-process step of ``accum`` accumulated
    microbatches: microbatch k of each step gets rows [k b, (k + 1) b) of
    the seeded draw at the global shape, as rank k of a data-parallel step
    does."""
    from ..models.sdxl.schedulers import DDPMScheduler
    from ..train.stage3 import seeded_draw

    sch, calls = DDPMScheduler(), itertools.count()

    def draw(seed, latent_shape, device):
        k, b = next(calls) % accum, latent_shape[0]
        draws = seeded_draw(sch, seed, (b * accum, *latent_shape[1:]), device)
        return tuple(t[k * b:(k + 1) * b] for t in draws)

    return draw


def _rank_worker(rank: int, world: int, port: int, out: str, models: Models, names: list):
    """One rank: the sharded runs of (a) and (b) named in ``names``, in the
    order of MESHES."""
    from ..models.agent import ContinuousLVLM
    from ..models.sdxl.vae import AutoencoderKL
    from ..models.vit import VisionTransformerWithAttnPool
    from ..parallel import collectives, sharding
    from ..parallel.mesh import make_mesh

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1 if models.device_type == "cpu" else torch.get_num_threads())
    collectives.initialize_multihost(device=models.device_type, backend=models.backend)
    device = collectives.local_device(models.device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    smoke = _smoke()
    vit = _fill(VisionTransformerWithAttnPool, models.vit_cfg(), device, seed=0, frozen=True)
    results, frozen3 = {}, None
    for name in names:
        stage, preset, (data, model) = MESHES[name]
        mesh = make_mesh(data, model)
        index = rank // model
        if stage.startswith("stage2"):
            batch = smoke.local_rows(models.stage2_batch(models.stage2_agent_cfg()), index, data)
            layout = (smoke.whole_weight_layout() if name.endswith("_whole_weights")
                      else contextlib.nullcontext())
            with layout:
                run = stage2_run(models, vit, batch, mesh, preset, device,
                                 int8=stage == "stage2_int8")
        else:
            agent_cfg = models.stage3_agent_cfg()
            if frozen3 is None:
                frozen3 = (vit, _fill(ContinuousLVLM, agent_cfg, device, seed=1, frozen=True),
                           _fill(AutoencoderKL, models.vae_cfg(), device, seed=2, frozen=True))
            batch = smoke.local_rows(models.stage3_batch(agent_cfg), index, data)
            units = (mock.patch.object(sharding, "_unit_types", _decoder_layer_units)
                     if name == "b41_one_unet_unit" else contextlib.nullcontext())
            with units:
                run = smoke.stage3_steps(models.adapter_cfg(), frozen3, batch, mesh, preset,
                                         STEPS, save_to=os.path.join(out, "ckpt")
                                         if name == "b22" else None, device=device)
        keep = ("loss", "grad_norm", "seconds", "peak_gib", "launches", "int8_gemm_launches",
                "unet_bytes", "vocab_bytes", "int8_bytes")
        results[name] = run if rank == 0 else {k: run[k] for k in keep}
    results["forbidden"] = smoke.forbidden_imports()
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_ranks(models: Models, world: int, out: str, names=tuple(MESHES),
              timeout: float = 900.0) -> list:
    """Spawns ``world`` ranks of ``_rank_worker`` over the runs ``names``
    and returns their results."""
    return spawn(_rank_worker, world, (out, models, list(names)), out, timeout)


def spawn(worker, world: int, args: tuple, out: str, timeout: float) -> list:
    """``worker(rank, world, port, *args)`` in ``world`` processes; returns
    what each saved to ``<out>/rank<r>.pt``."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.start_processes(worker, args=(world, free_port(), *args), nprocs=world,
                             join=False, start_method="spawn")
    while not ctx.join(timeout=5):
        if time.perf_counter() - t0 > timeout:
            for proc in ctx.processes:
                proc.terminate()
            raise TimeoutError(f"the {world} ranks did not finish in {timeout} s")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def references(models: Models, device, stages=("stage2", "stage2_int8", "stage3")) -> dict:
    """The one-card runs of ``stages`` on the global batches."""
    from ..models.agent import ContinuousLVLM
    from ..models.sdxl.vae import AutoencoderKL
    from ..models.vit import VisionTransformerWithAttnPool

    smoke = _smoke()
    vit = _fill(VisionTransformerWithAttnPool, models.vit_cfg(), device, seed=0, frozen=True)
    refs = {}
    batch = models.stage2_batch(models.stage2_agent_cfg())
    for stage in ("stage2", "stage2_int8"):
        if stage in stages:
            refs[stage] = stage2_run(models, vit, batch, None, None, device,
                                     int8=stage == "stage2_int8")
    if "stage3" not in stages:
        del vit
        smoke.free_memory()
        return refs
    agent_cfg = models.stage3_agent_cfg()
    frozen = (vit, _fill(ContinuousLVLM, agent_cfg, device, seed=1, frozen=True),
              _fill(AutoencoderKL, models.vae_cfg(), device, seed=2, frozen=True))
    batch = models.stage3_batch(agent_cfg)
    accum = 2
    stacked = {k: np.stack([smoke.local_rows(batch, i, accum)[k] for i in range(accum)])
               for k in batch}
    refs["stage3"] = smoke.stage3_steps(models.adapter_cfg(), frozen, stacked, None, None, STEPS,
                                        accum=accum, draw=rows_of_the_step_draw(accum),
                                        device=device)
    del frozen, vit
    smoke.free_memory()
    return refs


def restored_at_one_rank(models: Models, ckpt_dir: str, device) -> dict:
    """The (2, 2) checkpoint restored into a one-process stage-3 trainer:
    its whole state against the saved files, bitwise."""
    from ..models.sdxl.adapter import SDXLAdapter, adapter_trainable_mask
    from ..train.checkpoint import OPT_STATE, PARAMS, CheckpointManager
    from ..train.trainer import TrainConfig, Trainer

    adapter = _fill(SDXLAdapter, models.adapter_cfg(), device, seed=4)
    trainer = Trainer(adapter, lambda batch, seed: None, TrainConfig(),
                      trainable_mask=adapter_trainable_mask(adapter))
    mgr = CheckpointManager(ckpt_dir)
    step, _ = mgr.restore(trainer)
    path = os.path.join(ckpt_dir, str(step))
    saved = torch.load(os.path.join(path, PARAMS), map_location="cpu", weights_only=True)
    opt = torch.load(os.path.join(path, OPT_STATE), map_location="cpu", weights_only=True)
    params, moments = trainer.full_state()
    differ = [k for k in saved if not torch.equal(saved[k], params[k])]
    differ += [f"{key}.{k}" for key in ("mu", "nu") for k in opt[key]
               if not torch.equal(opt[key][k], moments[key][k])]
    out = {"step": step, "entries": len(saved), "differ": differ,
           "step_count": trainer.step_count}
    del trainer, adapter
    _smoke().free_memory()
    return out


def _share(run: dict, kind: str):
    held, whole = run[f"{kind}_bytes"]
    return held / whole if whole else None


def check_ab(ranks: list, refs: dict, label: str, names=tuple(MESHES)) -> list:
    """(a)'s and (b)'s JSON lines for the runs ``names``; raises on a
    failure."""
    smoke = _smoke()
    lines, failures = {}, [f for r in ranks for f in r["forbidden"]]
    for name in names:
        stage, preset, mesh = MESHES[name]
        run, ref = ranks[0][name], refs[stage]
        lr = STAGE2_LR if stage.startswith("stage2") else smoke.STAGE3_RANK_LR
        failures += smoke.compare_sharded(run, ref, f"multicard {name} {preset} {mesh}", label, lr)
        lines[name] = {
            "check": CHECK_OF[stage], "run": name, "preset": preset,
            "mesh": list(mesh), "loss": run["loss"], "loss_one_card": ref["loss"],
            "grad_norm": run["grad_norm"], "grad_norm_one_card": ref["grad_norm"],
            "grad_cosine": smoke.cosine(run["grads"], ref["grads"]),
            "s_per_step": [r[name]["seconds"][-1] for r in ranks],
            "s_per_step_one_card": ref["seconds"][-1],
            "peak_gib": [max(r[name]["peak_gib"]) for r in ranks],
            "peak_gib_one_card": max(ref["peak_gib"]),
            **{f"{kind}_bytes_share": [_share(r[name], kind) for r in ranks]
               for kind in ("unet", "vocab", "int8") if run[f"{kind}_bytes"][1]},
            "flash_launches_rank0": run["launches"],
            "int8_gemm_launches_rank0": run["int8_gemm_launches"], "shapes": run["shapes"]}
    if "b22" in lines and not max(lines["b22"]["unet_bytes_share"]) <= 0.6:
        failures.append(f"b22: a rank holds {lines['b22']['unet_bytes_share']} of the UNet's "
                        "parameter bytes")
    if "a22" in lines and not max(lines["a22"]["vocab_bytes_share"]) <= 0.3:
        failures.append(f"a22: a rank holds {lines['a22']['vocab_bytes_share']} of the "
                        "vocabulary tables' bytes")
    if "a41_int8" in lines and not max(lines["a41_int8"]["int8_bytes_share"]) <= 0.3:
        failures.append(f"a41_int8: a rank holds {lines['a41_int8']['int8_bytes_share']} of the "
                        "int8 base's bytes")
    for line in lines.values():
        print(json.dumps(line), flush=True)
    if failures:
        raise AssertionError(f"multicard (a) / (b) failed: {failures}")
    return list(lines.values())


# -- (e): the stage-2 CLI under torchrun --------------------------------------


def write_sft_workspace(models: Models, root: str) -> dict:
    """Check (e)'s inputs under ``root``: ``models.sft_configs``, and a
    george_sft-shaped data set (``configs/data/george_sft.yaml``: 1280
    tokens, 64 image tokens each way) of one two-image story repeated (jpgs
    of ``image_size``), so that every sample is the same and a global batch
    of E_BATCH's 4 samples means the same at either mesh; one data YAML for
    each mesh's samples a data rank. Returns the flags' paths, and
    ``data_22`` / ``data_41``."""
    from PIL import Image

    paths = models.sft_configs(root)
    size = paths.pop("image_size")
    for sub in ("images", "data"):
        os.makedirs(os.path.join(root, sub))
    rng = np.random.RandomState(8)
    for i in range(2):
        pixels = (rng.rand(size, size, 3) * 255).astype(np.uint8)
        Image.fromarray(pixels).save(os.path.join(root, "images", f"{i}.jpg"))
    story = {"images": ["0.jpg", "1.jpg"],
             "captions": ["george finds a red kite in the park.",
                          "george and his dog fly the kite over the hill."]}
    for part in range(WORLD):  # a file for each data rank
        with open(os.path.join(root, "data", f"part{part}.jsonl"), "w") as f:
            f.write((json.dumps(story) + "\n") * 16)
    with open("configs/data/george_sft.yaml") as f:
        data = f.read()
    for old, new in (("data_dir: data/json/george_train10", f"data_dir: {root}/data"),
                     ("image_dir: data/image/george_full", f"image_dir: {root}/images")):
        if old not in data:
            raise ValueError(f"configs/data/george_sft.yaml no longer holds {old!r}")
        data = data.replace(old, new)
    for mesh, per_rank in E_BATCH.items():
        paths[f"data_{mesh[0]}{mesh[1]}"] = os.path.join(root, f"data_{mesh[0]}{mesh[1]}.yaml")
        with open(paths[f"data_{mesh[0]}{mesh[1]}"], "w") as f:
            f.write(data.replace("batch_size: 30", f"batch_size: {per_rank}"))
    return paths


def torchrun(argv: list, log_path: str, timeout: float = 600.0) -> None:
    """``torchrun --nproc_per_node WORLD -m seed_story_torch.train.train_clm_sft
    argv`` from the repository root (its output in ``log_path``); raises
    with the output's tail when it fails."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(WORLD),
           "--master_addr", "localhost", "--master_port", str(free_port()),
           "-m", "seed_story_torch.train.train_clm_sft", *argv]
    with open(log_path, "w") as log:
        res = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT, timeout=timeout)
    if res.returncode:
        with open(log_path) as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"torchrun exited {res.returncode}: {' '.join(cmd)}\n{tail}")


def _logged(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return {m["step"]: m for m in map(json.loads, f) if "loss" in m}


def _restore_worker(rank: int, world: int, port: int, out: str, paths: dict, ckpt: str,
                    device_type: str, backend: str):
    """One of four ranks: the agent of check (e)'s YAMLs at (4, 1) ``fsdp``,
    restored from ``ckpt``; rank 0 holds the whole state it gathers against
    the files, bit for bit."""
    from ..inference.common import quantize_agent_
    from ..models.agent import ContinuousLVLM
    from ..models.llama import lora_trainable_mask
    from ..parallel import collectives
    from ..parallel.mesh import make_mesh
    from ..train.checkpoint import OPT_STATE, PARAMS, CheckpointManager
    from ..train.train_clm_sft import port_config
    from ..train.trainer import TrainConfig, Trainer
    from ..utils.config import load_config

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    collectives.initialize_multihost(device=device_type, backend=backend)
    device = collectives.local_device(device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    llm_raw = dict(load_config(paths["llm_model"]))
    llm_raw.pop("quantize_base")
    agent_cfg = port_config(load_config(paths["agent_model"]), llm=port_config(llm_raw))
    agent = quantize_agent_(_fill(ContinuousLVLM, agent_cfg, device, seed=7), base=True, kv=False)
    mask = lora_trainable_mask(agent)  # the entry's trainable set
    mask.update({k: True for k in mask if k.startswith(("input_resampler.", "output_resampler."))})
    trainer = Trainer(agent, lambda batch, seed: None, TrainConfig(sharding_preset="fsdp"),
                      trainable_mask=mask, mesh=make_mesh(WORLD, 1))
    step, _ = CheckpointManager(ckpt).restore(trainer)
    params, moments = trainer.full_state()
    result = {"step": step, "step_count": trainer.step_count,
              "int8_rows": {n: tuple(p.shape) for n, p in agent.named_parameters()
                            if p.dtype == torch.int8}}
    if rank == 0:
        path = os.path.join(ckpt, str(step))
        saved = torch.load(os.path.join(path, PARAMS), map_location="cpu", weights_only=True)
        opt = torch.load(os.path.join(path, OPT_STATE), map_location="cpu", weights_only=True)
        result["entries"] = len(saved)
        result["differ"] = [k for k in saved if not torch.equal(saved[k], params[k])]
        result["differ"] += [f"{key}.{k}" for key in ("mu", "nu") for k in opt[key]
                             if not torch.equal(opt[key][k], moments[key][k])]
        result["whole_int8_rows"] = {k: tuple(v.shape) for k, v in saved.items()
                                     if v.dtype == torch.int8}
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def check_e(models: Models, root: str, label: str, launch=torchrun) -> dict:
    """Check (e) in ``root``; ``launch(argv, log_path)`` runs the CLI on
    WORLD ranks (``torchrun``). Prints its JSON line; raises on a
    failure."""
    paths = write_sft_workspace(models, root)
    common = ["--image_transform", paths["image_transform"], "--tokenizer", paths["tokenizer"],
              "--visual_encoder", paths["visual_encoder"], "--llm_model", paths["llm_model"],
              "--agent_model", paths["agent_model"], "--learning_rate", "1e-3",
              # constant: the cosine schedule's length is --max_steps, which
              # the interrupted run sets to 2
              "--lr_scheduler_type", "constant", "--warmup_steps", "0", "--log_steps", "1",
              "--save_steps", "1000"]
    at22 = ["--train_dataset", paths["data_22"], "--mesh_data", "2", "--mesh_model", "2",
            "--sharding", "fsdp_tp"]
    saved, straight, resumed = (os.path.join(root, d) for d in ("saved", "straight", "resumed"))
    seconds = {}
    for name, argv in (
            ("saved", common + at22 + ["--max_steps", "2", "--save_steps", "2",
                                       "--output_dir", saved]),
            ("straight", common + at22 + ["--max_steps", "3", "--output_dir", straight]),
            ("resumed", common + ["--train_dataset", paths["data_41"], "--mesh_data", "4",
                                  "--sharding", "fsdp", "--max_steps", "3",
                                  "--resume_from_checkpoint", saved, "--output_dir", resumed])):
        t0 = time.perf_counter()
        launch(argv, os.path.join(root, f"{name}.log"))
        seconds[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = spawn(_restore_worker, WORLD, (root, paths, saved, models.device_type,
                                              models.backend), root, 600.0)
    seconds["restored"] = time.perf_counter() - t0
    logged = {name: _logged(d) for name, d in (("saved", saved), ("straight", straight),
                                                ("resumed", resumed))}
    a, b = logged["resumed"].get(3), logged["straight"].get(3)
    r0 = restored[0]
    line = {"check": "e", "launch": f"torchrun --nproc_per_node {WORLD}",
            "llm": f"llama2chat7b_lora_onechip.yaml at {E_LAYERS} layers",
            "losses_saved": [logged["saved"][s]["loss"] for s in sorted(logged["saved"])],
            "losses_straight": [logged["straight"][s]["loss"] for s in sorted(logged["straight"])],
            "step3_resumed_41": a and a["loss"], "step3_straight_22": b and b["loss"],
            "s_per_step_resumed_41": a and a["step_seconds"],
            "s_per_step_straight_22": b and b["step_seconds"],
            "peak_gib_resumed_41": a and a.get("peak_gib"),
            "peak_gib_straight_22": b and b.get("peak_gib"),
            "int8_gemm_launches_step3": a and a.get("int8_gemm_launches"),
            "restored_41": {"step": r0["step"], "entries": r0["entries"],
                            "differ": r0["differ"][:8]},
            "int8_rows_a_rank_of_whole": sorted({(r0["int8_rows"][k][0], v[0])
                                                 for k, v in r0["whole_int8_rows"].items()}),
            "seconds": {k: round(v, 1) for k, v in seconds.items()}}
    print(json.dumps(line), flush=True)
    failures = []
    if a is None or b is None or not abs(a["loss"] - b["loss"]) <= 5e-3 * abs(b["loss"]):
        failures.append(f"step 3 resumed at (4, 1) {a and a['loss']} against (2, 2) "
                        f"{b and b['loss']}")
    if r0["differ"] or r0["step"] != 2 or any(r["step_count"] != 2 for r in restored):
        failures.append(f"restored at (4, 1): step {r0['step']}, differ {r0['differ'][:8]}")
    if any(4 * r0["int8_rows"][k][0] < v[0] or 4 * (r0["int8_rows"][k][0] - 1) >= v[0]
           for k, v in r0["whole_int8_rows"].items()):
        failures.append("restored at (4, 1): an int8 weight is not held as a quarter of its rows")
    if failures:
        raise AssertionError(f"multicard (e) failed: {failures}")
    return line


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checks", nargs="+", choices=CHECKS, default=list(CHECKS))
    checks = parser.parse_args(argv).checks
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < WORLD:
        raise SystemExit(f"multicard_check: the meshes take {WORLD} CUDA cards, found {found}")
    smoke = _smoke()
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip().splitlines()
    label = " + ".join(cards)
    world = WORLD
    print(f"multicard_check: {world} cards: {cards}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; checks {checks}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(smoke.KERNELS)) as pool:  # one nvcc per source, all at once
        list(pool.map(lambda kernel: kernel[1].build(), smoke.KERNELS))
    print(f"kernel builds: {time.perf_counter() - t0:.1f} s", flush=True)
    models = Models()
    names = [n for n, (stage, _, _) in MESHES.items() if CHECK_OF[stage] in checks]
    if names:
        with tempfile.TemporaryDirectory() as out:
            t1 = time.perf_counter()
            ranks = run_ranks(models, world, out, names)
            print(f"multicard ranks: {time.perf_counter() - t1:.1f} s", flush=True)
            t1 = time.perf_counter()
            refs = references(models, torch.device("cuda", 0),
                              {MESHES[n][0] for n in names})
            check_ab(ranks, refs, label, names)
            if "b22" in names:
                restored = restored_at_one_rank(models, os.path.join(out, "ckpt"),
                                                torch.device("cuda", 0))
                print(json.dumps({"check": "b", "run": "b22 checkpoint restored at one rank",
                                  **restored}), flush=True)
                if restored["differ"] or restored["step_count"] != STEPS:
                    raise AssertionError(f"the (2, 2) checkpoint restored at one rank: {restored}")
            print(f"multicard one-card runs: {time.perf_counter() - t1:.1f} s", flush=True)
        del ranks, refs
        smoke.free_memory()
    if "c" in checks or "d" in checks:
        t1 = time.perf_counter()
        stack = smoke.build_stack(
            models.vit_cfg(), models.stage3_agent_cfg(), smoke.SDXLAdapterConfig(
                unet=smoke.SDXLUNetConfig(param_dtype=torch.bfloat16)),
            smoke.VAEConfig(param_dtype=torch.bfloat16), seed=0, device="cuda",
            max_new_tokens=smoke.MAX_NEW, num_inference_steps=smoke.EULER_STEPS,
            image_size=1024, force_boi_at=smoke.FORCE_BOI_AT, eos_token_id=-1)
        smoke.quantize_agent_(stack.agent, base=True, kv=True)
        print(f"multicard stack: {time.perf_counter() - t1:.1f} s", flush=True)
        devices = [f"cuda:{i}" for i in range(world)]
        if "c" in checks:
            tp_launches = smoke.phase_tp_decode(label, stack, degrees=(world,), devices=devices)
            print(json.dumps({"check": "c", "decode_tp": world, "devices": devices,
                              "launches": dict(tp_launches)}), flush=True)
        if "d" in checks:
            _, lockstep_stats, segments = smoke.phase_lockstep(label, stack)
            _, serving = smoke.phase_serving(label, stack, segments,
                                             lockstep_stats["lockstep"]["wall_s"],
                                             devices=devices[1:])
            print(json.dumps({"check": "d", "detok_devices": devices[1:], **serving}),
                  flush=True)
        del stack
        smoke.free_memory()
    if "e" in checks:
        t1 = time.perf_counter()
        with tempfile.TemporaryDirectory() as root:
            check_e(models, root, label)
        print(f"multicard (e): {time.perf_counter() - t1:.1f} s", flush=True)
    print(f"multicard_check: all checks passed in {time.perf_counter() - t0:.1f} s [{label}]",
          flush=True)


if __name__ == "__main__":
    main()
