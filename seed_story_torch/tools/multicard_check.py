"""The parallel layer across the cards of one host: four checks, each held
to its one-card counterpart run in the same call on card 0.

    python3 -m seed_story_torch.tools.multicard_check

Run it from the repository root: it reuses ``chip_smoke.py``'s batches,
step helpers and phases. Its meshes take four cards; with fewer it
raises. The ranks are processes of its own, one
a card over NCCL (rank r on card r); the one-card runs take place in this
process once the ranks are done.

  (a) stage 2 at (data 2, model 2) ``fsdp_tp`` and at (4, 1) ``fsdp``:
      LLaMA-2-7B width with ``chip_smoke.PARALLEL_LAYERS`` of 32 layers and
      the frozen ViT-bigG (the smoke's world_of_one models, LoRA dropout
      on), 2 steps on a global batch of 4 samples;
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
      inline wall.

Limits of (a) and (b) (``chip_smoke.compare_sharded``): losses within 5e-3
and grad norms within 1e-2 of the one-card run's, the first step's gradient
cosine >= 0.999, trained parameters within 2.5 x lr a step, frozen ones
bit-equal; at (2, 2) a rank holds at most 60% of the UNet's parameter
bytes. s/step and peak GiB a rank are printed. Each check prints one JSON line
(``{"check": ...}``); any failure raises, so the process exits non-zero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import socket
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

WORLD = 4
MESHES = {"a22": ("stage2", "fsdp_tp", (2, 2)), "a41": ("stage2", "fsdp", (4, 1)),
          "b22": ("stage3", "fsdp_tp", (2, 2)), "b41": ("stage3", "fsdp", (4, 1)),
          "b41_one_unet_unit": ("stage3", "fsdp", (4, 1))}
STEPS = 2
STAGE2_LR = 1e-3


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


def stage2_run(models: Models, vit, batch, mesh, preset, device) -> dict:
    """``chip_smoke.sharded_steps`` of stage 2 (the agent from seed 1)."""
    from ..models.agent import ContinuousLVLM
    from ..train.stage2 import make_stage2_loss_fn

    smoke = _smoke()
    agent = _fill(ContinuousLVLM, models.stage2_agent_cfg(), device, seed=1)
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


def _rank_worker(rank: int, world: int, port: int, out: str, models: Models):
    """One rank: (a)'s and (b)'s sharded runs, in the order of MESHES."""
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
    for name, (stage, preset, (data, model)) in MESHES.items():
        mesh = make_mesh(data, model)
        index = rank // model
        if stage == "stage2":
            batch = smoke.local_rows(models.stage2_batch(models.stage2_agent_cfg()), index, data)
            run = stage2_run(models, vit, batch, mesh, preset, device)
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
        keep = ("loss", "grad_norm", "seconds", "peak_gib", "launches", "unet_bytes")
        results[name] = run if rank == 0 else {k: run[k] for k in keep}
    results["forbidden"] = smoke.forbidden_imports()
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def run_ranks(models: Models, world: int, out: str, timeout: float = 480.0) -> list:
    """Spawns ``world`` ranks of ``_rank_worker`` and returns their results."""
    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    ctx = mp.start_processes(_rank_worker, args=(world, port, out, models), nprocs=world,
                             join=False, start_method="spawn")
    while not ctx.join(timeout=5):
        if time.perf_counter() - t0 > timeout:
            for proc in ctx.processes:
                proc.terminate()
            raise TimeoutError(f"the {world} ranks did not finish in {timeout} s")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def references(models: Models, device) -> dict:
    """(a)'s and (b)'s one-card runs on the global batches, then the (2, 2)
    stage-3 state restored at one rank."""
    from ..models.agent import ContinuousLVLM
    from ..models.sdxl.vae import AutoencoderKL
    from ..models.vit import VisionTransformerWithAttnPool

    smoke = _smoke()
    vit = _fill(VisionTransformerWithAttnPool, models.vit_cfg(), device, seed=0, frozen=True)
    refs = {"stage2": stage2_run(models, vit, models.stage2_batch(models.stage2_agent_cfg()),
                                 None, None, device)}
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


def check_ab(ranks: list, refs: dict, label: str) -> list:
    """(a)'s and (b)'s JSON lines; raises on a failure."""
    smoke = _smoke()
    lines, failures = [], [f for r in ranks for f in r["forbidden"]]
    for name, (stage, preset, mesh) in MESHES.items():
        run, ref = ranks[0][name], refs[stage]
        lr = STAGE2_LR if stage == "stage2" else smoke.STAGE3_RANK_LR
        failures += smoke.compare_sharded(run, ref, f"multicard {name} {preset} {mesh}", label, lr)
        lines.append({
            "check": "a" if stage == "stage2" else "b", "run": name, "preset": preset,
            "mesh": list(mesh), "loss": run["loss"], "loss_one_card": ref["loss"],
            "grad_norm": run["grad_norm"], "grad_norm_one_card": ref["grad_norm"],
            "grad_cosine": smoke.cosine(run["grads"], ref["grads"]),
            "s_per_step": [r[name]["seconds"][-1] for r in ranks],
            "s_per_step_one_card": ref["seconds"][-1],
            "peak_gib": [max(r[name]["peak_gib"]) for r in ranks],
            "peak_gib_one_card": max(ref["peak_gib"]),
            "unet_bytes_share": ([r[name]["unet_bytes"][0] / r[name]["unet_bytes"][1]
                                  for r in ranks] if stage == "stage3" else None),
            "flash_launches_rank0": run["launches"], "shapes": run["shapes"]})
    shares = lines[list(MESHES).index("b22")]["unet_bytes_share"]
    if not max(shares) <= 0.6:
        failures.append(f"b22: a rank holds {max(shares)} of the UNet's parameter bytes")
    for line in lines:
        print(json.dumps(line), flush=True)
    if failures:
        raise AssertionError(f"multicard (a) / (b) failed: {failures}")
    return lines


def main():
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
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(smoke.KERNELS)) as pool:  # one nvcc per source, all at once
        list(pool.map(lambda kernel: kernel[1].build(), smoke.KERNELS))
    print(f"kernel builds: {time.perf_counter() - t0:.1f} s", flush=True)
    models = Models()
    with tempfile.TemporaryDirectory() as out:
        t1 = time.perf_counter()
        ranks = run_ranks(models, world, out)
        print(f"multicard ranks: {time.perf_counter() - t1:.1f} s", flush=True)
        t1 = time.perf_counter()
        refs = references(models, torch.device("cuda", 0))
        check_ab(ranks, refs, label)
        restored = restored_at_one_rank(models, os.path.join(out, "ckpt"),
                                        torch.device("cuda", 0))
        print(json.dumps({"check": "b", "run": "b22 checkpoint restored at one rank",
                          **restored}), flush=True)
        if restored["differ"] or restored["step_count"] != STEPS:
            raise AssertionError(f"the (2, 2) checkpoint restored at one rank: {restored}")
        print(f"multicard one-card runs: {time.perf_counter() - t1:.1f} s", flush=True)
    del ranks, refs
    smoke.free_memory()
    t1 = time.perf_counter()
    stack = smoke.build_stack(
        models.vit_cfg(), models.stage3_agent_cfg(), smoke.SDXLAdapterConfig(
            unet=smoke.SDXLUNetConfig(param_dtype=torch.bfloat16)),
        smoke.VAEConfig(param_dtype=torch.bfloat16), seed=0, device="cuda",
        max_new_tokens=smoke.MAX_NEW, num_inference_steps=smoke.EULER_STEPS, image_size=1024,
        force_boi_at=smoke.FORCE_BOI_AT, eos_token_id=-1)
    smoke.quantize_agent_(stack.agent, base=True, kv=True)
    print(f"multicard stack: {time.perf_counter() - t1:.1f} s", flush=True)
    devices = [f"cuda:{i}" for i in range(world)]
    tp_launches = smoke.phase_tp_decode(label, stack, degrees=(world,), devices=devices)
    print(json.dumps({"check": "c", "decode_tp": world, "devices": devices,
                      "launches": dict(tp_launches)}), flush=True)
    _, lockstep_stats, segments = smoke.phase_lockstep(label, stack)
    _, serving = smoke.phase_serving(label, stack, segments, lockstep_stats["lockstep"]["wall_s"],
                                     devices=devices[1:])
    print(json.dumps({"check": "d", "detok_devices": devices[1:], **serving}), flush=True)
    print(f"multicard_check: all checks passed in {time.perf_counter() - t0:.1f} s [{label}]",
          flush=True)


if __name__ == "__main__":
    main()
