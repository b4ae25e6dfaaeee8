"""Batched de-tokenizing: each request is one ``SDXLImagePipeline.generate``
call that turns a batch of image-feature sets into uint8 images (the
ResamplerXLV2 conditioning, the SDXL UNet over the uncond / cond pair of
every image in one batch at each Euler step, the VAE decode).

The rate is the images of the window's whole calls over their time.

The check, once the window has closed and the program is freed, on one call
drawn from the seed (all its images). Forward hooks kept, in every run, a
copy of what the program's resampler returned, of the UNet's input and output
at every step and of the VAE decoder's output (the pixels before clipping).
The plain float32 reference (``reference/sdxl.py``) then reads

- ``encode_rel``: the program's prompt and pooled embeds against the
  reference resampler's, relative (L2), the worse of the positive and the
  negative batch;
- ``latent_rel``: at the sampled steps (step 0, the start, and two drawn
  from the seed), the UNet input the program built against the one the
  reference builds, rounded alike to bfloat16: the initial noise drawn from
  the call's seed, then the Euler updates with guidance from the program's
  own UNet outputs, in float32;
- ``eps_rel``: at the same steps, the program's UNet output against the
  reference UNet on the reference's latents and conditioning, relative (L2);
- ``pixel_rel``: the program's pixels before clipping against the reference
  VAE decoder on the reference's final latents, relative (L2);
- ``uint8_mismatch``: served image bytes that differ from the program's
  own pixels clipped and converted (the answer as produced).

With ``--control 1`` the control stands in the program's place: the
reference computed one precision below the configuration's bfloat16, every
product in float8 e4m3 (weights per output channel, inputs per call), its
Euler chain kept in bfloat16 on the program's guided UNet outputs. Its
embeds, its UNet inputs and outputs at the sampled steps, its pixels and
their bytes go through the same comparison.
"""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from perfbench import harness, traffic, weights
from perfbench.reference import sdxl as ref
from perfbench.reference.common import compute_in_fp8_, f32_math
from seed_story_torch.models.sdxl.adapter import SDXLAdapter, SDXLAdapterConfig
from seed_story_torch.models.sdxl.unet import CrossAttention, SDXLUNetConfig
from seed_story_torch.models.sdxl.vae import AutoencoderKL, VAEConfig
from seed_story_torch.pipelines.sdxl_pipeline import SDXLImagePipeline, SDXLSampleConfig

# the limits, from the readings in PERF.md ("Output checks")
LIMITS = {"encode_rel": 0.03, "latent_rel": 5e-4, "eps_rel": 0.05, "pixel_rel": 0.035,
          "uint8_mismatch": 0}

VAE_PREFIXES = ("decoder.", "post_quant_conv.")


def head_size(c: dict) -> int:
    """SDXL's unet/config.json gives heads per level (attention_head_dim);
    every level's heads are 64 wide."""
    return c["block_out_channels"][0] // c["attention_head_dim"][0]


class Cell:
    def __init__(self, ctx: harness.Context):
        self.ctx = ctx
        c, t, dev = ctx.config, ctx.cell["traffic"], ctx.device
        self.t = t
        self.adapter, self.vae = self._program(dev)
        self.spec = (weights.spec(weights.named_params(self.adapter)),
                     weights.spec(weights.named_params(self.vae, VAE_PREFIXES)))
        self.cfg = SDXLSampleConfig(height=t["height"], width=t["width"],
                                    num_inference_steps=t["steps"],
                                    guidance_scale=t["guidance"],
                                    latent_channels=c["in_channels"],
                                    vae_scale=2 ** (len(c["vae"]["block_out_channels"]) - 1))
        self.pipe = SDXLImagePipeline(self.adapter, self.vae, cfg=self.cfg)
        self.neg = traffic.negatives(t, ctx.seed, dev)
        # warm-up: a two-step call of other features at the window's shapes
        warm = SDXLImagePipeline(self.adapter, self.vae,
                                 cfg=dataclasses.replace(self.cfg, num_inference_steps=2))
        feats, noise = traffic.feature_sets(t, harness.derive(ctx.seed, "warmup"), 0, dev)
        warm.generate(feats, self.neg, generator=torch.Generator(device=dev).manual_seed(noise))
        self.calls = []  # per call: what the hooks kept and what it returned
        self._hook()

    def _program(self, dev):
        c = self.ctx.config
        r, v = c["resampler"], c["vae"]
        unet = SDXLUNetConfig(
            in_channels=c["in_channels"], out_channels=c["out_channels"],
            block_out_channels=tuple(c["block_out_channels"]),
            down_block_types=tuple(c["down_block_types"]),
            up_block_types=tuple(c["up_block_types"]), layers_per_block=c["layers_per_block"],
            transformer_layers_per_block=tuple(c["transformer_layers_per_block"]),
            attention_head_dim=head_size(c), cross_attention_dim=c["cross_attention_dim"],
            addition_embed_type=c["addition_embed_type"],
            addition_time_embed_dim=c["addition_time_embed_dim"],
            projection_class_embeddings_input_dim=c["projection_class_embeddings_input_dim"],
            pooled_projection_dim=r["output2_dim"], norm_num_groups=c["norm_num_groups"],
            dtype=torch.bfloat16, param_dtype=torch.bfloat16)
        acfg = SDXLAdapterConfig(unet=unet, resampler_dim=r["dim"], resampler_depth=r["depth"],
                                 resampler_heads=r["heads"], resampler_queries=r["queries"],
                                 embedding_dim=r["embedding_dim"], output1_dim=r["output1_dim"],
                                 output2_dim=r["output2_dim"])
        vcfg = VAEConfig(in_channels=v["in_channels"], latent_channels=v["latent_channels"],
                         block_out_channels=tuple(v["block_out_channels"]),
                         layers_per_block=v["layers_per_block"],
                         norm_num_groups=v["norm_num_groups"],
                         scaling_factor=v["scaling_factor"], dtype=torch.bfloat16,
                         param_dtype=torch.bfloat16)
        with torch.device(dev):
            adapter, vae = SDXLAdapter(acfg), AutoencoderKL(vcfg)
        weights.fill_(weights.named_params(adapter), harness.derive(self.ctx.seed, "adapter"), dev)
        weights.fill_(weights.named_params(vae, VAE_PREFIXES),
                      harness.derive(self.ctx.seed, "vae"), dev)
        adapter.eval().requires_grad_(False)
        vae.eval().requires_grad_(False)
        if dev.type == "cuda":
            adapter.to(memory_format=torch.channels_last)
            vae.to(memory_format=torch.channels_last)
        return adapter, vae

    def _hook(self):
        def keep(kind):
            def hook(mod, args, out):
                call = self.calls[-1]
                if kind == "unet":
                    call["unet_in"].append(args[0].detach().clone())
                    call["eps"].append(out.detach().clone())
                elif kind == "resampler":
                    call["encode"].append(tuple(o.detach().clone() for o in out))
                else:
                    call["pixels"] = out.detach().clone()
            return hook

        self.adapter.unet.register_forward_hook(keep("unet"))
        self.adapter.resampler.register_forward_hook(keep("resampler"))
        self.vae.decoder.register_forward_hook(keep("vae"))

    # --- the window ---

    def request(self, i: int) -> dict:
        feats, noise = traffic.feature_sets(self.t, self.ctx.seed, i, self.ctx.device)
        self.calls.append({"feats": feats, "noise": noise, "unet_in": [], "eps": [],
                           "encode": []})
        gen = torch.Generator(device=self.ctx.device).manual_seed(noise)
        images = self.pipe.generate(feats, self.neg, generator=gen)
        self.calls[-1]["images"] = images
        return {"units": len(images), "answers": len(images)}

    def end_to_end(self, name: str, done) -> float:
        if name == "images_per_min":
            return 60.0 * sum(r.units for r in done) / harness.window_seconds(done)
        raise KeyError(name)

    # --- the traced run ---

    def instrument(self, tracer: harness.Tracer):
        tracer.span(self.adapter.unet, lambda a, kw: ("unet", {"b": a[0].shape[0]}))
        tracer.span(self.adapter.resampler, lambda a, kw: ("resampler", {"b": a[0].shape[0]}))
        tracer.span(self.vae.decoder, lambda a, kw: ("vae_decode", {"b": a[0].shape[0]}))

        def attn_shapes(mod, args, kwargs):
            x = args[0]
            ctx = args[1] if len(args) > 1 and args[1] is not None else kwargs.get("context")
            lk = x.shape[1] if ctx is None else ctx.shape[1]
            heads = mod.to_q.weight.shape[0] // mod.dim_head
            return {"b": x.shape[0], "lq": x.shape[1], "lk": lk, "h": heads, "d": mod.dim_head}

        for m in self.adapter.unet.modules():
            if isinstance(m, CrossAttention):
                tracer.record(m, "flash_fwd", attn_shapes)

    def counters(self) -> dict:
        return {"calls": len(self.calls)}

    def flops(self, trace: harness.Trace) -> float:
        """The UNet, the VAE decoder and the resampler, counted from shapes on
        the meta device by torch's FLOP counter over the reference modules."""
        from torch.utils.flop_counter import FlopCounterMode

        c, t = self.ctx.config, self.t
        h, w = t["height"] // self.cfg.vae_scale, t["width"] // self.cfg.vae_scale
        per = {}
        with torch.device("meta"):
            unet, vae = ref.UNet(dict(c, attention_head_size=head_size(c))), ref.VAE(c["vae"])
            res = ref.ResamplerXLV2(c["resampler"])
            for name, fn in (
                    ("unet", lambda b: unet(torch.empty(b, h, w, c["in_channels"]),
                                            torch.empty(b), torch.empty(b, c["resampler"]["queries"],
                                                                        c["cross_attention_dim"]),
                                            torch.empty(b, c["resampler"]["output2_dim"]),
                                            torch.empty(b, 6))),
                    ("vae_decode", lambda b: vae.decode(torch.empty(b, h, w, c["in_channels"]))),
                    ("resampler", lambda b: res(torch.empty(b, t["feature_tokens"],
                                                            t["feature_dim"])))):
                for _, m in trace.spans.get(name, []):
                    if (name, m["b"]) not in per:
                        with FlopCounterMode(display=False) as fc:
                            fn(m["b"])
                        per[(name, m["b"])] = fc.get_total_flops()
        return float(sum(per[(name, m["b"])] for name in ("unet", "vae_decode", "resampler")
                         for _, m in trace.spans.get(name, [])))

    # --- the check ---

    def _reference(self):
        c, dev = self.ctx.config, self.ctx.device
        with torch.device(dev):
            adapter = ref.Adapter(dict(c, attention_head_size=head_size(c)))
            vae = ref.VAE(c["vae"])
        pa, pv = weights.named_params(adapter), weights.named_params(vae)
        if (weights.spec(pa), weights.spec(pv)) != self.spec:
            raise RuntimeError("the reference's parameters differ from the program's")
        weights.fill_(pa, harness.derive(self.ctx.seed, "adapter"), dev)
        weights.fill_(pv, harness.derive(self.ctx.seed, "vae"), dev)
        return adapter, vae

    def _chain(self, call, steps, dtype=torch.float32):
        """The latents from the call's noise seed through the Euler updates
        on the program's guided UNet outputs, kept in ``dtype``: the UNet
        input at ``steps`` and the final latents."""
        t, dev = self.t, self.ctx.device
        ts, sigmas = ref.euler_schedule(t["steps"], self.ctx.config["scheduler"])
        b = t["images_per_call"]
        shape = (b, t["height"] // self.cfg.vae_scale, t["width"] // self.cfg.vae_scale,
                 self.ctx.config["in_channels"])
        gen = torch.Generator(device=dev).manual_seed(call["noise"])
        lat = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        lat = (lat * float((sigmas.max() ** 2 + 1.0) ** 0.5)).to(dtype).float()
        inputs = {}
        sig = torch.as_tensor(sigmas, device=dev)
        for i in range(t["steps"]):
            if i in steps:
                inputs[i] = lat / (sig[i] ** 2 + 1.0) ** 0.5
            eps = call["eps"][i].float()
            lat = ref.euler_step(lat, eps[:b], eps[b:], t["guidance"], sig[i],
                                 sig[i + 1]).to(dtype).float()
        return ts, inputs, lat

    @staticmethod
    def _bytes(pixels):
        """Pixels in [-1, 1] as the served uint8 image bytes."""
        return ((np.clip(pixels.float().cpu().numpy(), -1, 1) + 1) * 127.5).astype(np.uint8)

    def _control_answers(self, call, steps, ts, time_ids) -> dict:
        """What the control answers in the program's place: its embeds, the
        UNet input of its bfloat16 chain and its UNet output there, its
        pixels from that chain's final latents, and their bytes."""
        b = self.t["images_per_call"]
        adapter, vae = self._reference()
        compute_in_fp8_(adapter)
        compute_in_fp8_(vae)
        encode = [adapter.resampler(x.float()) for x in (call["feats"], self.neg)]
        (pos, pos_pool), (neg, neg_pool) = encode
        ctx, pooled = torch.cat([neg, pos]), torch.cat([neg_pool, pos_pool])
        _, inputs, final = self._chain(call, steps, torch.bfloat16)
        eps = {}
        for i in steps:
            t_i = torch.full((2 * b,), float(ts[i]), device=self.ctx.device)
            eps[i] = adapter.unet(torch.cat([inputs[i], inputs[i]]), t_i, ctx, pooled, time_ids)
        del adapter
        pixels = vae.decode(final)
        del vae
        gc.collect()
        return {"encode": encode, "unet_in": inputs, "eps": eps, "pixels": pixels,
                "images": self._bytes(pixels)}

    @torch.no_grad()
    def check(self) -> dict:
        t, dev, seed = self.t, self.ctx.device, self.ctx.seed
        call = self.calls[harness.derive(seed, "checked") % len(self.calls)]
        self.calls = None
        for name in ("pipe", "adapter", "vae"):
            setattr(self, name, None)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        steps = sorted({0, *[1 + harness.derive(seed, "step", j) % (t["steps"] - 1)
                             for j in range(2)]})
        b = t["images_per_call"]
        time_ids = torch.tensor([[t["height"], t["width"], 0, 0, t["height"], t["width"]]],
                                dtype=torch.float32, device=dev).expand(2 * b, -1)
        with f32_math():
            ts, inputs, final = self._chain(call, steps)
            if self.ctx.control:
                answers = self._control_answers(call, steps, ts, time_ids)
            else:
                answers = {"encode": call["encode"],
                           "unet_in": {i: call["unet_in"][i][:b] for i in steps},
                           "eps": {i: call["eps"][i] for i in steps},
                           "pixels": call["pixels"], "images": call["images"]}
            adapter, vae = self._reference()
            (pos, pos_pool), (neg, neg_pool) = (adapter.resampler(x.float())
                                                for x in (call["feats"], self.neg))
            encode_rel = 0.0
            for (p, q), (rp, rq) in zip(answers["encode"], ((pos, pos_pool), (neg, neg_pool))):
                got = torch.cat([p.float().flatten(), q.float().flatten()])
                want = torch.cat([rp.flatten(), rq.flatten()])
                encode_rel = max(encode_rel, float((got - want).norm() / want.norm()))
            ctx, pooled = torch.cat([neg, pos]), torch.cat([neg_pool, pos_pool])
            latent_rel = eps_rel = 0.0
            for i in steps:
                x = inputs[i].to(torch.bfloat16).float()
                got_in = answers["unet_in"][i].float()
                latent_rel = max(latent_rel, float((got_in - x).norm() / x.norm()))
                t_i = torch.full((2 * b,), float(ts[i]), device=dev)
                want = adapter.unet(torch.cat([inputs[i], inputs[i]]), t_i, ctx, pooled, time_ids)
                got = answers["eps"][i].float()
                eps_rel = max(eps_rel, float((got - want).norm() / want.norm()))
            del adapter
            pixels = vae.decode(final)
            pixel_rel = float((answers["pixels"].float() - pixels).norm() / pixels.norm())
            mismatch = int((self._bytes(answers["pixels"]) != answers["images"]).sum())
            del vae
        return {"encode_rel": harness.check(encode_rel, LIMITS["encode_rel"]),
                "latent_rel": harness.check(latent_rel, LIMITS["latent_rel"]),
                "eps_rel": harness.check(eps_rel, LIMITS["eps_rel"]),
                "pixel_rel": harness.check(pixel_rel, LIMITS["pixel_rel"]),
                "uint8_mismatch": harness.check(float(mismatch), LIMITS["uint8_mismatch"])}
