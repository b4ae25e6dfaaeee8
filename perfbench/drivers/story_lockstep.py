"""Lockstep story decoding: B stories advance together through
``StoryGenerationPipeline.run_batch`` (one ``StoryGenerator.generate_batch``
a round: a batched prefill of each story's window, then speculative verify
passes over the int8 agent and its int8 KV cache), the regressed image
features fed back into each story's window, no de-tokenizer.

One request is a fixed amount of work from fresh starts: a new ``run_batch``
over the same B start images and captions, run for the traffic's
``rounds`` rounds (the first encodes the start images with the ViT; later
rounds prefill the longer windows that the earlier segments left). Every
request is the same work. The rate is the tokens generated over all rows of
the window's whole requests over their time. How many verify passes a
segment takes depends on the text the model produces (prompt-lookup drafts
are accepted where the text repeats), and at a near tie a story's row in the
batch flips a token; so the weights and the stories are drawn from the
traffic's ``content_seed``, and ``--seed`` draws which segments the check
takes. The traced run profiles the traffic's ``traced_rounds`` of each
request (the last: the longest windows): a whole request's trace holds some
five million events and takes minutes to read.

The check, once the window has closed and the program is freed, on one
request drawn from the seed: every story's segment of its last round (the
longest prompts) and one segment of each earlier round drawn from the seed.
The plain float32 reference (``reference/agent.py``, the seven projections
put through the int8 grid as the program quantizes them) re-derives each
checked segment's prompt from the captions and the texts served before it,
runs the LLM teacher-forced over prompt and served tokens, and reads

- ``logit_gap``: the widest gap by which a served (not forced) token's
  score lies below the reference's best at its position, in units of that
  position's logit spread (standard deviation over the vocabulary);
- ``feat_rel``: the served segment's regressed image features against the
  output resampler on the reference's hidden states, relative (L2);
- ``vit_rel``: the ViT features of the start images against the reference
  ViT's, relative (L2), the worst story;
- ``prompt_mismatch``: prompt ids that differ from the re-derived ones.

With ``--control 1`` the control stands in the program's place: the
reference one grid below the configuration's precision (int4 projections,
every other weight matrix int8), run teacher-forced over the same prompts
and served tokens; its first choice at each position, its regressed
features and its ViT features go through the same comparison.
"""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from perfbench import harness, roofline, traffic, weights
from perfbench.reference import agent as ref
from perfbench.reference.common import f32_math, fake_quantize_
from seed_story_torch.data.tokenizer import TinyTokenizer
from seed_story_torch.decode.generate import GenerateConfig, StoryGenerator
from seed_story_torch.inference.common import quantize_agent_
from seed_story_torch.models.agent import AgentConfig, ContinuousLVLM
from seed_story_torch.models.llama import LlamaAttention, LlamaConfig, LoRADense
from seed_story_torch.models.vit import ViTConfig, VisionTransformerWithAttnPool
from seed_story_torch.pipelines.story_generation import (StoryGenerationPipeline,
                                                         StoryPipelineConfig)

# the limits, from the readings in PERF.md ("Output checks")
LIMITS = {"logit_gap": 0.6, "feat_rel": 0.12, "vit_rel": 0.014, "prompt_mismatch": 0}

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def llm_config(c: dict) -> dict:
    """The LLM's keys as the reference and the FLOP count read them."""
    keys = ("vocab_size", "padded_vocab_size", "hidden_size", "intermediate_size",
            "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
            "max_position_embeddings", "rms_norm_eps", "rope_theta")
    out = {k: c[k] for k in keys}
    out.update(lora_rank=c["lora"]["r"], lora_alpha=c["lora"]["alpha"], agent=c["agent"])
    return out


class Cell:
    def __init__(self, ctx: harness.Context):
        self.ctx = ctx
        c, t, dev = ctx.config, ctx.cell["traffic"], ctx.device
        self.t = t
        dt = DTYPES[c["dtype"]]
        v, a = c["vit"], c["agent"]
        vit_cfg = ViTConfig(image_size=v["image_size"], patch_size=v["patch_size"],
                            width=v["width"], layers=v["layers"], heads=v["heads"],
                            mlp_ratio=v["mlp_ratio"], n_queries=v["n_queries"],
                            output_dim=v["output_dim"], ln_eps=v["ln_eps"], dtype=dt,
                            param_dtype=dt)
        llm_cfg = LlamaConfig(
            vocab_size=c["vocab_size"], padded_vocab_size=c["padded_vocab_size"],
            hidden_size=c["hidden_size"], intermediate_size=c["intermediate_size"],
            num_hidden_layers=c["num_hidden_layers"], num_attention_heads=c["num_attention_heads"],
            num_key_value_heads=c["num_key_value_heads"],
            max_position_embeddings=c["max_position_embeddings"], rms_norm_eps=c["rms_norm_eps"],
            rope_theta=c["rope_theta"], lora_rank=c["lora"]["r"], lora_alpha=c["lora"]["alpha"],
            lora_dropout=c["lora"]["dropout"], dtype=dt, param_dtype=dt)
        agent_cfg = AgentConfig(llm=llm_cfg, input_resampler_grid=a["input_resampler_grid"],
                                output_resampler_grid=a["output_resampler_grid"],
                                num_img_out_tokens=a["num_img_out_tokens"],
                                resampler_heads=a["resampler_heads"], vit_dim=a["vit_dim"])
        with torch.device(dev):
            self.vit = VisionTransformerWithAttnPool(vit_cfg)
            self.agent = ContinuousLVLM(agent_cfg)
        self.vit.to(dev)  # buffers made from numpy start on the host
        self.agent.to(dev)
        self.vit_params = weights.named_params(self.vit)
        self.agent_params = weights.named_params(self.agent)
        self.spec = (weights.spec(self.vit_params), weights.spec(self.agent_params))
        weights.fill_(self.vit_params, harness.derive(t["content_seed"], "vit"), dev)
        weights.fill_(self.agent_params, harness.derive(t["content_seed"], "agent"), dev)
        del self.vit_params, self.agent_params
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
        self.requests = []  # per request: its rounds and what the ViT returned
        generate_batch = self.gen.generate_batch

        def recorded(stories, seed=0):
            outs = generate_batch(stories, seed)
            self.requests[-1]["rounds"].append(
                [(np.asarray(s["input_ids"]).copy(), np.asarray(o["generate_ids"]).copy(),
                  o["img_gen_feat"]) for s, o in zip(stories, outs)])
            return outs

        self.gen.generate_batch = recorded
        self.starts = traffic.story_starts(t)
        self.tracer = None
        # warm-up: one round of the same stories cut to a short segment that
        # still reaches the image (ViT, prefill, verify passes, image chain,
        # output resampler)
        full = self.gen.cfg
        self.gen.cfg = dataclasses.replace(full, max_new_tokens=t["warmup_new_tokens"],
                                           force_boi_at=t["warmup_boi_at"])
        self._run_rounds(1)
        self.gen.cfg = full
        self.requests.clear()
        self.vit.register_forward_hook(
            lambda m, args, out: self.requests[-1]["vit"].append(out.detach().clone()))

    def _run_rounds(self, n: int) -> list:
        """A fresh ``run_batch`` over the start stories for ``n`` rounds; in
        the traced run the profiler runs over the traffic's
        ``traced_rounds`` only."""
        self.requests.append({"rounds": [], "vit": []})
        stories = self.pipe.run_batch(self.starts)
        segments = []
        for k in range(n):
            if self.tracer is not None:
                if k in self.t["traced_rounds"]:
                    self.tracer.resume()
                else:
                    self.tracer.pause()
            segments.append(next(stories))
        stories.close()
        return segments

    # --- the window ---

    def request(self, i: int) -> dict:
        segments = [s for round_ in self._run_rounds(self.t["rounds"]) for s in round_]
        return {"units": sum(len(g) for r in self.requests[-1]["rounds"] for _, g, _ in r),
                "answers": len(segments),
                "failed": sum(s is None or s.image_features is None for s in segments)}

    def end_to_end(self, name: str, done) -> float:
        if name == "story_tokens_per_s":
            return sum(r.units for r in done) / harness.window_seconds(done)
        raise KeyError(name)

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
                    "hkv": mod.k_proj.weight.shape[0] // hd, "d": hd,
                    "starts": list(cache.length), "bytes": 1 if cache.quantized else 2}

        for m in self.agent.llm.modules():
            if isinstance(m, LoRADense):
                tracer.record(m, "int8_linear", int8_rows)
            elif isinstance(m, LlamaAttention):
                tracer.record(m, "decode_attn", decode_shapes)

    def counters(self) -> dict:
        rounds = [r for q in self.requests for k, r in enumerate(q["rounds"])
                  if k in self.t["traced_rounds"]]
        return {"decode_tokens": sum(len(g) - 1 for r in rounds for _, g, _ in r),
                "rows": len(rounds[0]) if rounds else 0}

    def flops(self, trace: harness.Trace) -> float:
        c = llm_config(self.ctx.config)
        total = 0.0
        for name in ("llm.prefill", "llm.verify"):
            for _, m in trace.spans.get(name, []):
                total += roofline.llama_forward_flops(c, zip(m["starts"], m["lens"]),
                                                      m["logits_rows"])
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

    def _free_program(self) -> dict:
        """Frees the program; returns the checked request, drawn from the seed."""
        requests = self.requests
        for name in ("pipe", "gen", "agent", "vit", "requests"):
            setattr(self, name, None)
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        return requests[harness.derive(self.ctx.seed, "request") % len(requests)]

    def _checked(self, rounds) -> list:
        """(round, row) of every segment of the last round and of one segment
        of each earlier round drawn from the seed."""
        last, rows = len(rounds) - 1, len(rounds[0])
        return ([(last, r) for r in range(rows)]
                + [(k, harness.derive(self.ctx.seed, "checked", k) % rows) for k in range(last)])

    def _served(self, group, name, p):
        """The configuration's grid: its int8 projections, all else as served."""
        return 127 if (group == "agent" and self.ctx.config["quantize_base"]
                       and ref.is_projection_weight(name)) else None

    def _lower(self, group, name, p):
        """The control's grid: int4 projections, every other weight matrix int8."""
        if p.dim() < 2:
            return None
        return 7 if group == "agent" and ref.is_projection_weight(name) else 127

    def _reference(self, levels):
        """The reference ViT and agent on the device, filled from the seed,
        each weight matrix put through the grid ``levels`` names for it
        (None: as served)."""
        c, dev = llm_config(self.ctx.config), self.ctx.device
        with torch.device(dev):
            vit, agent = ref.ViT(self.ctx.config["vit"]), ref.Agent(c)
        vit.to(dev)
        agent.to(dev)
        pv, pa = weights.named_params(vit), weights.named_params(agent)
        if (weights.spec(pv), weights.spec(pa)) != self.spec:
            raise RuntimeError("the reference's parameters differ from the program's")
        weights.fill_(pv, harness.derive(self.t["content_seed"], "vit"), dev)
        weights.fill_(pa, harness.derive(self.t["content_seed"], "agent"), dev)
        for group, params in (("vit", pv), ("agent", pa)):
            for name, p in params.items():
                lv = levels(group, name, p)
                if lv:
                    fake_quantize_(p.data, lv)
        return vit, agent

    def _segment_inputs(self, rounds, vit_feats, r, row):
        """The checked segment's prompt (re-derived), images and served tokens."""
        t, a = self.t, self.ctx.config["agent"]
        caption = self.starts[row][1]
        texts = [ref.clean_text(rounds[k][row][1]) for k in range(r)]
        ids, cmp = ref.prompt_ids(caption, texts, a["input_resampler_grid"] ** 2, t["window"])
        images = [vit_feats[row]] + [rounds[k][row][2].float() for k in range(r)]
        images = torch.cat(images[-t["window"]:])
        return ids, cmp, images, rounds[r][row][1]

    def _teacher_forced(self, agent, ids, cmp, images, served):
        """(hidden states, logits at the served positions, previous tokens)."""
        dev = images.device
        x = agent.prompt_embeds(ids, cmp, images)
        tok = agent.llm.model.embed_tokens.weight[torch.as_tensor(served[:-1], device=dev)]
        hidden = agent.llm.hidden(torch.cat([x, tok[None]], dim=1))[0]
        p = len(ids)
        logits = agent.llm.logits(hidden[p - 1:p - 1 + len(served)])
        return hidden, logits, [int(ids[-1])] + [int(x) for x in served[:-1]]

    def _features(self, agent, hidden, ids, served):
        """The output resampler on the hidden states of the segment's image
        tokens."""
        k_img = self.ctx.config["agent"]["num_img_out_tokens"]
        eoi = len(ids) + int(np.flatnonzero(served == ref.EOI_ID)[-1])
        return agent.output_resampler(hidden[eoi - k_img:eoi][None])

    def _gaps(self, logits, prev, picks):
        """Per position: the gap of ``picks`` below the best score, over the
        logit spread; forced positions excluded."""
        n_gen = self.ctx.config["agent"]["num_img_out_tokens"]
        s, forced = ref.choice_scores(logits, prev, n_gen)
        if self.t["force_boi_at"] < len(forced):
            forced[self.t["force_boi_at"]] = True
        tok = torch.as_tensor(np.asarray(picks), device=s.device)
        gap = s.max(dim=-1).values - s.gather(1, tok[:, None])[:, 0]
        spread = logits[:, :self.ctx.config["vocab_size"]].std(dim=-1)
        return torch.where(forced, 0.0, gap / spread)

    def _control_answers(self, rounds, checked, pixels) -> dict:
        """What the control answers in the program's place: its ViT features,
        and for each checked segment the re-derived prompt, its first choice
        at every position of the served tokens and its regressed features."""
        k_img = self.ctx.config["agent"]["num_img_out_tokens"]
        vit, agent = self._reference(self._lower)
        vit_low = vit(pixels)
        segments = []
        for r, row in checked:
            ids, cmp, images, toks = self._segment_inputs(rounds, vit_low[:, None], r, row)
            hidden, logits, prev = self._teacher_forced(agent, ids, cmp, images, toks)
            picks = ref.choice_scores(logits, prev, k_img)[0].argmax(dim=-1).cpu().numpy()
            segments.append({"ids": ids, "picks": picks,
                             "feat": self._features(agent, hidden, ids, toks)})
        del vit, agent
        gc.collect()
        return {"vit": vit_low, "segments": segments}

    @torch.no_grad()
    def check(self) -> dict:
        req = self._free_program()
        rounds, dev = req["rounds"], self.ctx.device
        checked = self._checked(rounds)
        pixels = torch.as_tensor(np.concatenate([p for p, _ in self.starts]), device=dev)
        with f32_math():
            if self.ctx.control:
                answers = self._control_answers(rounds, checked, pixels)
            else:
                answers = {"vit": torch.cat(req["vit"]).float(),
                           "segments": [{"ids": rounds[r][row][0], "picks": rounds[r][row][1],
                                         "feat": rounds[r][row][2].float()}
                                        for r, row in checked]}
            vit, agent = self._reference(self._served)
            vit_ref = vit(pixels)
            vit_rel = max(float((answers["vit"][i] - vit_ref[i]).norm() / vit_ref[i].norm())
                          for i in range(len(self.starts)))
            gap, feat_rel, mismatch = 0.0, 0.0, 0
            for (r, row), a in zip(checked, answers["segments"]):
                ids, cmp, images, toks = self._segment_inputs(rounds, vit_ref[:, None], r, row)
                mismatch += (max(len(ids), len(a["ids"])) if len(a["ids"]) != len(ids)
                             else int((a["ids"] != ids).sum()))
                hidden, logits, prev = self._teacher_forced(agent, ids, cmp, images, toks)
                gap = max(gap, float(self._gaps(logits, prev, a["picks"]).max()))
                feat_ref = self._features(agent, hidden, ids, toks)
                feat_rel = max(feat_rel, float((a["feat"] - feat_ref).norm() / feat_ref.norm()))
            del vit, agent
        return {"logit_gap": harness.check(gap, LIMITS["logit_gap"]),
                "feat_rel": harness.check(feat_rel, LIMITS["feat_rel"]),
                "vit_rel": harness.check(vit_rel, LIMITS["vit_rel"]),
                "prompt_mismatch": harness.check(float(mismatch), LIMITS["prompt_mismatch"])}
