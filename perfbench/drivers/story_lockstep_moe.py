"""Lockstep story decoding with a mixture-of-experts LLM: the agent of
``story_lockstep.py`` with K-EXAONE-236B-A23B in place of the LLaMA (one
card's share of an expert-parallel deployment: its held experts of each
layer; windowed and global GQA layers), through the same
``StoryGenerationPipeline.run_batch`` / ``generate_batch`` / ``_spec_loop``,
int8 weights (experts included) and the int8 KV cache. A request, the rate,
the warm-up and the traced rounds are ``story_lockstep.py``'s.

The check, once the window has closed and the program is freed, on one
request drawn from the seed and the segments ``story_lockstep.py`` checks,
teacher-forced against the plain float32 reference
(``reference/kexaone.py``, the projections and the experts put through the
int8 grid as the program quantizes them), built one layer at a time from the
seeded weights: ``logit_gap``, ``feat_rel``, ``vit_rel`` and
``prompt_mismatch`` as there, and

- ``route_mismatch``: the share of (position, expert layer) pairs of the
  checked segments whose 8 chosen experts differ from the reference's. The
  program's choices are those of the pass that committed each position
  (the prefill for the prompt, the verify pass that kept it for a served
  token), kept by the benchmark's hooks on the routers as device tensors and
  read after the window. With random weights many pairs sit near a tie
  between the 8th and 9th scores, and the program's h parts from the
  reference's through bf16 activations and the int8 KV cache over the
  layers, so a sound run flips a share of them; its limit lies between the
  sound runs' readings and the control's, like the other numbers'.

With ``--control 1`` the control stands in the program's place: the
reference one grid below the configuration's precision (int4 projections and
int4 experts, every other weight matrix int8), teacher-forced over the same
prompts and served tokens; its first choices, its features, its ViT features
and its routers' choices go through the same comparison.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
from typing import Dict

import numpy as np
import torch
from torch import nn

from perfbench import harness, roofline, roofline_moe, traffic, weights
from perfbench.drivers import story_lockstep
from perfbench.reference import agent as ref
from perfbench.reference import kexaone as kx
from perfbench.reference.common import f32_math, fake_quantize_
from seed_story_torch.data.tokenizer import TinyTokenizer
from seed_story_torch.decode.generate import GenerateConfig, StoryGenerator
from seed_story_torch.inference.common import quantize_agent_
from seed_story_torch.models.agent import AgentConfig, ContinuousLVLM
from seed_story_torch.models.llama import LlamaAttention, LlamaConfig, LoRADense
from seed_story_torch.models.moe import MoE, MoEConfig, RoutedExperts
from seed_story_torch.models.vit import ViTConfig, VisionTransformerWithAttnPool
from seed_story_torch.pipelines.story_generation import (StoryGenerationPipeline,
                                                         StoryPipelineConfig)

# the limits, from the readings in PERF.md ("Output checks")
LIMITS = {"logit_gap": 1.5, "feat_rel": 0.12, "vit_rel": 0.014, "prompt_mismatch": 0,
          "route_mismatch": 0.5}


def reference_config(c: dict) -> dict:
    """The sizes the reference, the FLOP count and the bounds read."""
    n = c["num_hidden_layers"]
    dep = c["deployment"]
    keys = ("vocab_size", "padded_vocab_size", "hidden_size", "intermediate_size",
            "num_attention_heads", "num_key_value_heads", "head_dim", "rms_norm_eps",
            "first_k_dense_replace", "moe_intermediate_size", "num_shared_experts",
            "num_experts_per_tok", "routed_scaling_factor", "agent", "dtype")
    out = {k: c[k] for k in keys}
    out.update(num_hidden_layers=n, sliding_windows=list(c["sliding_windows"][:n]),
               rope_theta=c["rope_parameters"]["rope_theta"], lora_rank=c["lora"]["r"],
               lora_alpha=c["lora"]["alpha"], router_experts=dep["published_num_experts"],
               held_experts=c["num_experts"], first_held_expert=dep["first_held_expert"])
    return out


def program_config(c: dict, dtype) -> LlamaConfig:
    rc = reference_config(c)
    n = rc["num_hidden_layers"]
    if [t == "dense" for t in c["mlp_layer_types"][:n]] != [
            i < c["first_k_dense_replace"] for i in range(n)]:
        raise ValueError("mlp_layer_types and first_k_dense_replace disagree")
    return LlamaConfig(
        vocab_size=c["vocab_size"], padded_vocab_size=c["padded_vocab_size"],
        hidden_size=c["hidden_size"], intermediate_size=c["intermediate_size"],
        num_hidden_layers=n, num_attention_heads=c["num_attention_heads"],
        num_key_value_heads=c["num_key_value_heads"], head_size=c["head_dim"],
        max_position_embeddings=c["max_position_embeddings"], rms_norm_eps=c["rms_norm_eps"],
        rope_theta=rc["rope_theta"], lora_rank=c["lora"]["r"], lora_alpha=c["lora"]["alpha"],
        lora_dropout=c["lora"]["dropout"], sliding_windows=tuple(rc["sliding_windows"]),
        nope_global=True, qk_norm=True, post_norms=True,
        first_k_dense_replace=c["first_k_dense_replace"],
        moe=MoEConfig(num_experts=rc["router_experts"],
                      experts_per_token=c["num_experts_per_tok"],
                      intermediate_size=c["moe_intermediate_size"],
                      num_shared_experts=c["num_shared_experts"],
                      routed_scaling_factor=c["routed_scaling_factor"],
                      held=(rc["first_held_expert"], c["num_experts"])),
        dtype=dtype, param_dtype=dtype)


@torch.no_grad()
def fill_named_(params: Dict[str, torch.Tensor], spec: Dict[str, tuple], seed: int,
                device) -> None:
    """The values ``weights.fill_`` gives the parameters ``params`` (name ->
    tensor) when it fills a set with the names and shapes of ``spec``: the
    same stream, drawn up to the last of them, each taking its slice."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    chunk, buf, pos, left = -1, None, 0, len(params)
    for name in sorted(spec):
        size = math.prod(spec[name])
        if name in params:
            p = params[name]
            if tuple(p.shape) != tuple(spec[name]):
                raise RuntimeError(f"{name}: {tuple(p.shape)} is not {spec[name]}")
            mean, std = weights.leaf_scale(name, tuple(spec[name]))
            flat, done = p.view(-1), 0
            while done < size:
                c, off = divmod(pos + done, weights.CHUNK)
                while chunk < c:
                    buf = torch.randn(weights.CHUNK, generator=gen, device=device,
                                      dtype=torch.float32)
                    chunk += 1
                take = min(weights.CHUNK - off, size - done)
                flat[done:done + take].copy_((buf[off:off + take] * std + mean).to(torch.bfloat16))
                done += take
            left -= 1
            if not left:
                return
        pos += size
    raise RuntimeError(f"{left} parameter(s) not in the spec")


def is_expert_weight(name: str) -> bool:
    parts = name.split(".")
    return len(parts) >= 2 and parts[-2] == "experts"


def program_routes(calls: list, row: int, prompt: int, served: int) -> list:
    """The program's chosen experts at positions 0 .. prompt + served - 2 of
    a round's row, one (positions, top_k) tensor an expert layer: the
    prefill's for the prompt, then each verify pass's for the positions it
    committed (up to the next pass's start; the last pass up to the segment's
    end)."""
    prefill, passes = calls[0], calls[1:]
    out = [[idx.view(prefill["b"], prefill["s"], -1)[row, :prompt]]
           for idx in prefill["routes"]]
    for i, call in enumerate(passes):
        end = passes[i + 1]["starts"][row] if i + 1 < len(passes) else prompt + served - 1
        kept = end - call["starts"][row]
        if kept > 0:
            for layer, idx in enumerate(call["routes"]):
                out[layer].append(idx.view(call["b"], call["s"], -1)[row, :kept])
    return [torch.cat(o) for o in out]


class Cell(story_lockstep.Cell):
    def __init__(self, ctx: harness.Context):  # story_lockstep.Cell's, with this LLM
        self.ctx = ctx
        c, t, dev = ctx.config, ctx.cell["traffic"], ctx.device
        self.t = t
        dt = story_lockstep.DTYPES[c["dtype"]]
        v, a = c["vit"], c["agent"]
        vit_cfg = ViTConfig(image_size=v["image_size"], patch_size=v["patch_size"],
                            width=v["width"], layers=v["layers"], heads=v["heads"],
                            mlp_ratio=v["mlp_ratio"], n_queries=v["n_queries"],
                            output_dim=v["output_dim"], ln_eps=v["ln_eps"], dtype=dt,
                            param_dtype=dt)
        agent_cfg = AgentConfig(llm=program_config(c, dt),
                                input_resampler_grid=a["input_resampler_grid"],
                                output_resampler_grid=a["output_resampler_grid"],
                                num_img_out_tokens=a["num_img_out_tokens"],
                                resampler_heads=a["resampler_heads"], vit_dim=a["vit_dim"])
        with torch.device(dev):
            self.vit = VisionTransformerWithAttnPool(vit_cfg)
            self.agent = ContinuousLVLM(agent_cfg)
        self.vit.to(dev)
        self.agent.to(dev)
        vit_params, agent_params = weights.named_params(self.vit), weights.named_params(self.agent)
        self.spec = (weights.spec(vit_params), weights.spec(agent_params))
        weights.fill_(vit_params, harness.derive(t["content_seed"], "vit"), dev)
        weights.fill_(agent_params, harness.derive(t["content_seed"], "agent"), dev)
        del vit_params, agent_params
        self.vit.eval().requires_grad_(False)
        self.agent.eval().requires_grad_(False)
        if c["quantize_base"] or c["quantize_kv"]:
            quantize_agent_(self.agent, base=c["quantize_base"], kv=c["quantize_kv"])
        self.gen = StoryGenerator(self.agent, GenerateConfig(
            max_new_tokens=t["new_tokens"], num_img_gen_tokens=a["num_img_out_tokens"],
            eos_token_id=-1, cache_capacity=c["max_position_embeddings"],
            force_boi_at=t["force_boi_at"], speculate_k=t["speculate_k"], return_cache=False))
        vit = self.vit

        @torch.inference_mode()
        def visual_encode(pixels):
            return vit(torch.as_tensor(np.asarray(pixels, np.float32), device=dev))

        self.pipe = StoryGenerationPipeline(TinyTokenizer(), self.gen, visual_encode, None,
                                            StoryPipelineConfig(
                                                story_len=t["story_len"], window_size=t["window"],
                                                num_img_in_tokens=a["input_resampler_grid"] ** 2))
        self.requests = []  # per request: its rounds, the routers' choices, the ViT's output
        self._calls = []  # the LLM calls of the running round, with their routers' choices
        generate_batch = self.gen.generate_batch

        def recorded(stories, seed=0):
            self._calls = []
            outs = generate_batch(stories, seed)
            self.requests[-1]["rounds"].append(
                [(np.asarray(s["input_ids"]).copy(), np.asarray(o["generate_ids"]).copy(),
                  o["img_gen_feat"]) for s, o in zip(stories, outs)])
            self.requests[-1].setdefault("calls", []).append(self._calls)
            return outs

        self.gen.generate_batch = recorded

        def llm_call(mod, args, kwargs):
            x = kwargs["inputs_embeds"]
            self._calls.append({"starts": list(kwargs["cache"].length), "b": x.shape[0],
                                "s": x.shape[1], "routes": []})

        def routed(mod, args, out):  # the chosen experts stay on the device until the check
            self._calls[-1]["routes"].append(out[1])

        self.agent.llm.register_forward_pre_hook(llm_call, with_kwargs=True)
        for layer in self.agent.llm.model.layers:
            if isinstance(layer.mlp, MoE):
                layer.mlp.gate.register_forward_hook(routed)
        self.starts = traffic.story_starts(t)
        self.tracer = None
        full = self.gen.cfg
        self.gen.cfg = dataclasses.replace(
            full, max_new_tokens=t["warmup_new_tokens"], force_boi_at=t["warmup_boi_at"])
        self._run_rounds(1)
        self.gen.cfg = full
        self.requests.clear()
        self.vit.register_forward_hook(
            lambda m, args, out: self.requests[-1]["vit"].append(out.detach().clone()))

    # --- the traced run ---

    def instrument(self, tracer: harness.Tracer):
        self.tracer = tracer
        k = self.t["speculate_k"]

        def llm_call(args, kwargs):
            x, cache = kwargs["inputs_embeds"], kwargs["cache"]
            b, s = x.shape[:2]
            lens = kwargs.get("seq_lengths") or [s] * b
            meta = {"b": b, "s": s, "starts": list(cache.length), "lens": [int(n) for n in lens],
                    "logits_rows": b if kwargs.get("logits_indices") is not None else b * s}
            return ("llm.verify" if s <= k + 1 else "llm.prefill"), meta

        tracer.span(self.agent.llm, llm_call)
        tracer.span(self.vit, lambda a, kw: ("vit", {"n": a[0].shape[0]}))
        for name in ("input_resampler", "output_resampler"):
            tracer.span(getattr(self.agent, name),
                        lambda a, kw, name=name: (name, {"n": a[0].shape[0], "l": a[0].shape[1]}))

        def expert_call(mod, args, kwargs):
            h, order, offsets, top_k = args
            return {"offsets": offsets, "order": order, "top_k": top_k,
                    "grouped": bool(kwargs["grouped"] and h.is_cuda and mod.quantized),
                    "d": mod.down_proj.shape[1], "i": mod.width}

        def int8_rows(mod, args, kwargs):
            if not mod.quantized:
                return None
            x = args[0]
            n, kk = mod.weight.shape
            return {"m": x.numel() // x.shape[-1], "n": n, "k": kk}

        def decode_shapes(mod, args, kwargs):
            cache, x = kwargs.get("cache"), args[0]
            if cache is None or x.shape[1] > 8:
                return None
            hd = mod.cfg.head_dim
            return {"b": x.shape[0], "s": x.shape[1], "hq": mod.q_proj.weight.shape[0] // hd,
                    "hkv": mod.k_proj.weight.shape[0] // hd, "d": hd, "window": mod.window,
                    "starts": list(cache.length), "bytes": 1 if cache.quantized else 2}

        for m in self.agent.llm.modules():
            if isinstance(m, MoE):
                tracer.span(m, lambda a, kw: ("moe.verify", None) if a[0].shape[1] <= k + 1
                            else None)
            elif isinstance(m, RoutedExperts):
                tracer.record(m, "experts", expert_call)
            elif isinstance(m, LoRADense):
                tracer.record(m, "int8_linear", int8_rows)
            elif isinstance(m, LlamaAttention):
                tracer.record(m, "decode_attn", decode_shapes)

    def flops(self, trace: harness.Trace) -> float:
        c = reference_config(self.ctx.config)
        total = 0.0
        for name in ("llm.prefill", "llm.verify"):
            for _, m in trace.spans.get(name, []):
                total += roofline_moe.kexaone_forward_flops(c, zip(m["starts"], m["lens"]),
                                                            m["logits_rows"])
        calls = trace.records.get("experts", [])
        if calls:
            local = torch.stack([r["offsets"][-1] for r in calls]).sum().item()
            total += local * roofline_moe.expert_pair_flops(c)
        total += sum(roofline.vit_forward_flops(self.ctx.config["vit"], m["n"])
                     for _, m in trace.spans.get("vit", []))
        a = c["agent"]
        for name, (queries, dim, kv) in {
                "input_resampler": (a["input_resampler_grid"] ** 2, c["hidden_size"],
                                    a["vit_dim"]),
                "output_resampler": (a["output_resampler_grid"] ** 2, a["vit_dim"],
                                     c["hidden_size"])}.items():
            total += sum(roofline.resampler_flops(queries, m["l"], dim, kv, m["n"])
                         for _, m in trace.spans.get(name, []))
        return total

    # --- the check ---

    def _served(self, group, name, p):
        """The configuration's grid: its int8 projections and experts, all
        else as served."""
        return 127 if (group == "agent" and self.ctx.config["quantize_base"]
                       and (ref.is_projection_weight(name) or is_expert_weight(name))) else None

    def _lower(self, group, name, p):
        """The control's grid: int4 projections and experts, every other
        weight matrix int8."""
        if p.dim() < 2:
            return None
        return 7 if group == "agent" and (ref.is_projection_weight(name)
                                           or is_expert_weight(name)) else 127

    def _grid_(self, params: dict, group: str, levels) -> None:
        for name, p in params.items():
            lv = levels(group, name, p)
            if lv:  # per output channel (of each expert)
                fake_quantize_(p.data.view(-1, p.shape[-1]), lv)

    def _vit(self, levels, pixels):
        dev = self.ctx.device
        with torch.device(dev):
            vit = ref.ViT(self.ctx.config["vit"])
        vit.to(dev)
        params = weights.named_params(vit)
        if weights.spec(params) != self.spec[0]:
            raise RuntimeError("the reference ViT's parameters differ from the program's")
        weights.fill_(params, harness.derive(self.t["content_seed"], "vit"), dev)
        self._grid_(params, "vit", levels)
        out = vit(pixels)
        del vit, params
        gc.collect()
        return out

    def _llm(self, levels, segments):
        """The reference teacher-forced over each (ids, cmp, images, served)
        of ``segments``, a layer at a time: per segment its logits at the
        served positions, previous tokens, features and chosen experts per
        expert layer."""
        c, dev = reference_config(self.ctx.config), self.ctx.device
        seed = harness.derive(self.t["content_seed"], "agent")
        with torch.device("meta"):
            whole = kx.Agent(c, nn.ModuleList(kx.Layer(c, i)
                                              for i in range(c["num_hidden_layers"])))
        spec = weights.spec(weights.named_params(whole))
        if spec != self.spec[1]:
            raise RuntimeError("the reference's parameters differ from the program's")
        del whole
        with torch.device(dev):
            agent = kx.Agent(c, nn.ModuleList())
        agent.to(dev)  # buffers made from numpy start on the host
        params = weights.named_params(agent)
        fill_named_(params, spec, seed, dev)
        self._grid_(params, "agent", levels)
        xs, prevs = [], []
        for ids, cmp, images, served in segments:
            x = self._prompt_embeds(agent, ids, cmp, images)
            tok = agent.llm.model.embed_tokens.weight[torch.as_tensor(served[:-1], device=dev)]
            xs.append(torch.cat([x, tok[None]], dim=1))
            prevs.append([int(ids[-1])] + [int(t) for t in served[:-1]])
        routes = [[] for _ in segments]
        for i in range(c["num_hidden_layers"]):
            with torch.device(dev):
                layer = kx.Layer(c, i)
            prefix = f"llm.model.layers.{i}."
            params = {prefix + n: p for n, p in layer.named_parameters()}
            fill_named_(params, spec, seed, dev)
            self._grid_(params, "agent", levels)
            for j, x in enumerate(xs):
                xs[j], chosen = layer(x)
                if chosen is not None:
                    routes[j].append(chosen)
            del layer, params
        out = []
        for (ids, _, _, served), x, prev, route in zip(segments, xs, prevs, routes):
            hidden = agent.llm.model.norm(x)[0]
            p = len(ids)
            logits = agent.llm.logits(hidden[p - 1:p - 1 + len(served)])
            out.append({"logits": logits, "prev": prev, "routes": route,
                        "feat": self._features(agent, hidden, ids, served)})
        del agent, xs
        gc.collect()
        return out

    @staticmethod
    def _prompt_embeds(agent, ids, cmp, images):
        dev = images.device
        x = agent.llm.model.embed_tokens.weight[torch.as_tensor(ids, device=dev)]
        feats = agent.input_resampler(images).reshape(-1, x.shape[-1])
        slots = torch.as_tensor(np.flatnonzero(cmp), device=dev)
        x[slots] = feats[:len(slots)]
        return x[None]

    def _control_answer(self, ids, seg: dict) -> dict:
        """The control's answer for a segment from its reference pass: its
        first choices, features and routers' choices."""
        k_img = self.ctx.config["agent"]["num_img_out_tokens"]
        picks = ref.choice_scores(seg["logits"], seg["prev"], k_img)[0].argmax(dim=-1)
        return {"ids": ids, "picks": picks.cpu().numpy(), "feat": seg["feat"],
                "routes": seg["routes"]}

    def _readings(self, ids, answer: dict, seg: dict) -> dict:
        """One checked segment's numbers: the answer against the reference's
        pass over the re-derived prompt ``ids``."""
        a = answer
        mismatch = (max(len(ids), len(a["ids"])) if len(a["ids"]) != len(ids)
                    else int((a["ids"] != ids).sum()))
        flips = pairs = 0
        for got, want in zip(a["routes"], seg["routes"]):
            n = min(len(got), len(want))
            flips += int((got[:n].sort(-1).values != want[:n].sort(-1).values).any(-1).sum())
            pairs += n
        return {"logit_gap": float(self._gaps(seg["logits"], seg["prev"], a["picks"]).max()),
                "feat_rel": float((a["feat"] - seg["feat"]).norm() / seg["feat"].norm()),
                "prompt_mismatch": mismatch, "flips": flips, "pairs": pairs}

    @torch.no_grad()
    def check(self) -> dict:
        req = self._free_program()
        rounds, dev = req["rounds"], self.ctx.device
        checked = self._checked(rounds)
        pixels = torch.as_tensor(np.concatenate([p for p, _ in self.starts]), device=dev)
        with f32_math():
            vit_ref = self._vit(self._served, pixels)
            if self.ctx.control:
                vit_ans = self._vit(self._lower, pixels)
                inputs = [self._segment_inputs(rounds, vit_ans[:, None], r, row)
                          for r, row in checked]
                answers = [self._control_answer(x[0], seg)
                           for x, seg in zip(inputs, self._llm(self._lower, inputs))]
            else:
                vit_ans = torch.cat(req["vit"]).float()
                answers = []
                for r, row in checked:
                    ids, served, feat = rounds[r][row]
                    answers.append({"ids": ids, "picks": served, "feat": feat.float(),
                                    "routes": program_routes(req["calls"][r], row, len(ids),
                                                             len(served))})
            vit_rel = max(float((vit_ans[i] - vit_ref[i]).norm() / vit_ref[i].norm())
                          for i in range(len(self.starts)))
            segments = [self._segment_inputs(rounds, vit_ref[:, None], r, row)
                        for r, row in checked]
            served_ref = self._llm(self._served, segments)
            readings = [self._readings(x[0], a, seg)
                        for x, a, seg in zip(segments, answers, served_ref)]
        worst = {k: max(r[k] for r in readings) for k in ("logit_gap", "feat_rel")}
        total = {k: sum(r[k] for r in readings) for k in ("prompt_mismatch", "flips", "pairs")}
        print(f"routes: {total['flips']} of {total['pairs']} (position, expert layer) pairs "
              f"flipped", file=sys.stderr, flush=True)
        numbers = {"logit_gap": worst["logit_gap"], "feat_rel": worst["feat_rel"],
                   "vit_rel": vit_rel, "prompt_mismatch": float(total["prompt_mismatch"]),
                   "route_mismatch": total["flips"] / max(1, total["pairs"])}
        return {k: harness.check(v, LIMITS[k]) for k, v in numbers.items()}
