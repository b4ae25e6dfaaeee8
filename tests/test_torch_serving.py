"""The port's pipelined serving (``pipelines/serving.py``) and its two
inference CLIs, on the CPU at a tiny size.

Serving, the counterparts of ``tests/test_serving.py`` with CPU
``torch.device``s as replicas: segments served through the pool equal the
inline ``run_batch`` ones (texts and images bit for bit) and come out in
per-story order; a replica that raises fails over once, and raises to the
caller when the next one raises too; the server refuses an inline
de-tokenizer; ``split_devices``' bounds.

CLIs: ``gen_george`` (sequential, ``--sink`` with speculation,
``--batch_stories 2``) and ``vis_george_sink`` on a pico workspace (val
jsonl, jpgs, model YAMLs whose ``_target_``s name the JAX package and are
mapped through the port's config loader). Their ``text.txt`` / ``token.txt``
must equal the port's own ``run`` / ``run_sink`` / ``run_batch`` /
visualization texts on the same seeded weights (the JAX CLIs on these
weights take minutes, which the test budget has not). With ``--sdxl_int8``
both CLIs match the port's pipelines on a quantized adapter, image bytes
included; the four ``--*_ckpt`` flags on ``save_params`` files of a stack
with other seeds give that stack's texts and images, and an int8
``quantize_base`` agent checkpoint loads its int8 bytes and scales as saved.
``--detok_devices`` on one device and ``--decode_tp`` > 1 are refused.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from seed_story_torch.decode.generate import GenerateConfig, StoryGenerator
from seed_story_torch.inference import gen_george, vis_george_sink
from seed_story_torch.inference.common import build_stack_from_yaml, fill_module
from seed_story_torch.models.agent import AgentConfig, ContinuousLVLM
from seed_story_torch.pipelines.serving import (DetokenizerPool, PipelinedStoryServer,
                                                pipelined_segments, split_devices)
from seed_story_torch.pipelines.story_generation import (StoryGenerationPipeline,
                                                         StoryPipelineConfig)
from seed_story_torch.pipelines.story_visualization import (StoryVisualizationPipeline,
                                                            VisPipelineConfig)
from seed_story_torch.train.checkpoint import save_params
from seed_story_tpu.data.tokenizer import TinyTokenizer

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def agent():
    return fill_module(ContinuousLVLM, AgentConfig.tiny(), "cpu", seed=7).eval()


def _pipeline(agent, detokenize=None):
    acfg = agent.cfg

    def visual_encode(pixels):
        rng = np.random.RandomState(int(abs(float(np.asarray(pixels).mean())) * 100) % 1000)
        return torch.from_numpy(rng.randn(1, acfg.num_vit_tokens, acfg.vit_dim)
                                .astype(np.float32))

    gen = StoryGenerator(agent, GenerateConfig(
        max_new_tokens=32, num_img_gen_tokens=acfg.num_img_out_tokens, cache_capacity=512,
        return_cache=False, force_boi_at=12))
    return StoryGenerationPipeline(TinyTokenizer(), gen, visual_encode, detokenize,
                                   StoryPipelineConfig(story_len=5, window_size=3,
                                                       num_img_in_tokens=acfg.num_img_in_tokens))


def _image_of(feats) -> np.ndarray:
    """A deterministic "image" of the features, so both paths compare bit for bit."""
    return torch.tanh(feats[0, :2, :3]).numpy()


SEEDS = [(np.zeros((1, 3, 8, 8), np.float32), "a brave squirrel found a map"),
         (np.full((1, 3, 8, 8), 0.25, np.float32), "george visited the museum")]


def test_pipelined_serving_matches_inline(agent):
    with torch.inference_mode():
        ref = [[] for _ in SEEDS]
        for round_segments in _pipeline(agent, _image_of).run_batch(SEEDS):
            for i, seg in enumerate(round_segments):
                if seg is not None:
                    ref[i].append(seg)

        used = []

        def make_detok(device):
            replica = len(used)
            used.append([])

            def detok(feats):
                used[replica].append(feats.device)
                return _image_of(feats)
            return detok

        _, detok_devs = split_devices(1, [CPU] * 4)
        server = PipelinedStoryServer(_pipeline(agent), DetokenizerPool(make_detok, detok_devs))
        order = list(server.serve_stream(SEEDS))
        served = server.serve(SEEDS)
        server.pool.shutdown()

    stories = [[seg for i, seg in order if i == r] for r in range(len(SEEDS))]
    assert [[(s.index, s.text) for s in story] for story in served] == [
        [(s.index, s.text) for s in story] for story in stories]
    n_images = 0
    for want, got in zip(ref, stories):
        assert [s.index for s in got] == [s.index for s in want] == sorted(s.index for s in got)
        assert [s.text for s in got] == [s.text for s in want]
        for w, g in zip(want, got):
            assert (w.image is None) == (g.image is None)
            if w.image is not None:
                np.testing.assert_array_equal(g.image, w.image)
                n_images += 1
    assert n_images >= 4
    assert sum(server.pool.calls) == 2 * n_images
    assert sum(len(u) > 0 for u in used) >= 2  # round-robin spread the work
    stats = server.stats()
    assert stats["detok_replicas"] == 3 and stats["decode_s"] > 0


def test_pipelined_segments_keep_the_story_order(agent):
    pipe = _pipeline(agent)
    with torch.inference_mode():
        want = [s.index for s in pipe.run(*SEEDS[0])]
        pool = DetokenizerPool(lambda device: _image_of, [CPU, CPU])
        got = list(pipelined_segments(pipe.run(*SEEDS[0]), pool))
        pool.shutdown()
    assert [s.index for s in got] == want
    assert all(s.image is not None for s in got if s.image_features is not None)


def test_detok_pool_failover():
    """A replica that raises fails over to its neighbour once; when the
    neighbour raises too, the caller gets the error."""
    devices = [CPU] * 3
    armed = {"first": True}

    def make_detok(device):
        idx = len(made)
        made.append(idx)

        def detok(feats):
            if idx == 0 and armed.pop("first", False):
                raise RuntimeError("transient failure")
            if feats.sum() < 0:
                raise RuntimeError("bad input")
            return float(feats.sum())
        return detok

    made = []
    pool = DetokenizerPool(make_detok, devices)
    try:
        feats = torch.ones(2, 2)
        assert [pool.submit(feats).result() for _ in range(4)] == [4.0] * 4
        assert pool.failures == 1 and sum(pool.calls) == 4
        with pytest.raises(RuntimeError, match="bad input"):
            pool.submit(-feats).result()
        assert pool.failures == 3 and sum(pool.calls) == 4
    finally:
        pool.shutdown()


def test_detok_pool_counts_hold_under_concurrent_submits():
    """Many threads submitting at once with a short switch interval: every
    request runs once and no count is lost."""
    import sys
    import threading

    pool = DetokenizerPool(lambda device: lambda feats: float(feats.sum()), [CPU] * 3)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        results = []

        def client():
            futures = [pool.submit(torch.ones(3)) for _ in range(50)]
            results.extend(f.result(timeout=60) for f in futures)

        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        pool.shutdown()
    assert results == [3.0] * 400
    assert sum(pool.calls) == 400 and pool.failures == 0
    assert all(n > 0 for n in pool.calls)


def test_pipelined_server_rejects_inline_detok(agent):
    pool = DetokenizerPool(lambda d: _image_of, [CPU])
    try:
        with pytest.raises(ValueError, match="detokenize=None"):
            PipelinedStoryServer(_pipeline(agent, _image_of), pool)
    finally:
        pool.shutdown()


def test_split_devices_bounds():
    devices = [CPU] * 8
    with pytest.raises(ValueError):
        split_devices(0, devices)
    with pytest.raises(ValueError):
        split_devices(8, devices)
    a, b = split_devices(3, devices)
    assert len(a) == 3 and len(b) == 5
    if not torch.cuda.is_available():  # the default is every visible CUDA device
        with pytest.raises(ValueError):
            split_devices(1)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The pico workspace of tests/test_inference_cli.py."""
    root = tmp_path_factory.mktemp("cli")
    img_dir = root / "images"
    img_dir.mkdir()
    records = []
    for s in range(2):
        name = f"s{s}_0.jpg"
        Image.new("RGB", (256, 256), (s * 90, 60, 120)).save(img_dir / name)
        records.append({"images": [name], "captions": [f"story {s} begins with a happy dog"]})
    with open(root / "val.jsonl", "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    with open(root / "vis.jsonl", "w") as f:
        f.write(json.dumps({"images": ["s0_0.jpg"],
                            "captions": [f"scene {i} of the dog story" for i in range(4)]}) + "\n")

    cfg = root / "configs"
    cfg.mkdir()
    f32 = ("dtype:\n  _target_: seed_story_tpu.utils.config.resolve_target\n"
           "  path: jax.numpy.float32\n")
    files = {
        "tokenizer.yaml": "_target_: seed_story_tpu.data.tokenizer.TinyTokenizer\n",
        "transform.yaml": ("_target_: seed_story_tpu.data.transforms.get_transform\n"
                           "type: clip\nimage_size: 28\nkeep_ratio: False\n"),
        "vit.yaml": ("_target_: seed_story_tpu.models.vit.ViTConfig\n"
                     "image_size: 28\npatch_size: 14\nwidth: 32\nlayers: 1\nheads: 2\n"
                     "mlp_ratio: 2.0\nn_queries: 9\noutput_dim: 64\n" + f32),
        "llm.yaml": ("_target_: seed_story_tpu.models.llama.LlamaConfig\n"
                     "vocab_size: 32066\nhidden_size: 64\nintermediate_size: 128\n"
                     "num_hidden_layers: 1\nnum_attention_heads: 2\nlora_rank: 2\n" + f32),
        "llm_int8.yaml": ("_target_: seed_story_tpu.models.llama.LlamaConfig\n"
                          "vocab_size: 32066\nhidden_size: 64\nintermediate_size: 128\n"
                          "num_hidden_layers: 1\nnum_attention_heads: 2\nlora_rank: 2\n"
                          "quantize_base: true\n" + f32),
        "agent.yaml": ("_target_: seed_story_tpu.models.agent.AgentConfig\n"
                       "input_resampler_grid: 2\noutput_resampler_grid: 3\n"
                       "num_img_out_tokens: 4\nresampler_heads: 2\nvit_dim: 64\n"),
        "adapter.yaml": (
            "_target_: seed_story_tpu.models.sdxl.adapter.SDXLAdapterConfig\n"
            "resampler_dim: 32\nresampler_depth: 1\nresampler_heads: 2\n"
            "resampler_queries: 4\nembedding_dim: 64\noutput1_dim: 32\noutput2_dim: 64\n"
            "unet:\n"
            "  _target_: seed_story_tpu.models.sdxl.unet.SDXLUNetConfig\n"
            "  block_out_channels: [16, 32, 32]\n"
            "  transformer_layers_per_block: [1, 1, 1]\n"
            "  attention_head_dim: 8\n  cross_attention_dim: 32\n"
            "  addition_time_embed_dim: 8\n  projection_class_embeddings_input_dim: 112\n"
            "  pooled_projection_dim: 64\n  norm_num_groups: 8\n"
            "  dtype:\n    _target_: seed_story_tpu.utils.config.resolve_target\n"
            "    path: jax.numpy.float32\n"),
        "vae.yaml": ("_target_: seed_story_tpu.models.sdxl.vae.VAEConfig\n"
                     "block_out_channels: [16, 32, 32, 32]\nnorm_num_groups: 8\n" + f32),
    }
    for name, text in files.items():
        (cfg / name).write_text(text)
    return root


STACK_ARGS = ("tokenizer", "transform", "vit", "llm", "agent")
SIZES = dict(max_new_tokens=24, num_inference_steps=2, image_size=32, force_boi_at=8)


def _argv(ws, save_dir, jsonl="val.jsonl", story_len=3):
    cfg = ws / "configs"
    return ["--tokenizer", str(cfg / "tokenizer.yaml"),
            "--image_transform", str(cfg / "transform.yaml"),
            "--visual_encoder", str(cfg / "vit.yaml"), "--llm_model", str(cfg / "llm.yaml"),
            "--agent_model", str(cfg / "agent.yaml"), "--adapter", str(cfg / "adapter.yaml"),
            "--vae_config", str(cfg / "vae.yaml"), "--val_jsonl", str(ws / jsonl),
            "--image_root", str(ws / "images"), "--save_dir", str(save_dir),
            "--story_len", str(story_len), "--window_size", "2",
            "--max_new_tokens", str(SIZES["max_new_tokens"]),
            "--num_inference_steps", str(SIZES["num_inference_steps"]),
            "--image_size", str(SIZES["image_size"]),
            "--force_boi_at", str(SIZES["force_boi_at"])]


def _stack(ws, **kw):
    cfg = ws / "configs"
    return build_stack_from_yaml(*(str(cfg / f"{n}.yaml") for n in STACK_ARGS),
                                 adapter_cfg_path=str(cfg / "adapter.yaml"),
                                 vae_cfg_path=str(cfg / "vae.yaml"), device="cpu", **SIZES, **kw)


def _seed(ws, stack, j, jsonl="val.jsonl"):
    with open(ws / jsonl) as f:
        d = [json.loads(line) for line in f][j]
    image = Image.open(ws / "images" / d["images"][0]).convert("RGB")
    return stack.image_transform(image)[None], d["captions"]


def _story_files(folder):
    files = sorted(os.listdir(folder))
    with open(os.path.join(folder, "text.txt")) as f:
        texts = f.read().splitlines()
    with open(os.path.join(folder, "token.txt")) as f:
        tokens = f.read().splitlines()
    return files, texts, tokens


def _expect(folder, segments):
    files, texts, tokens = _story_files(folder)
    assert texts == [s.text for s in segments]
    assert tokens == [f"context token: (1, {s.context_tokens})" for s in segments]
    frames = [f"{s.index:02d}.jpg" for s in segments if s.image is not None]
    assert frames and set(frames + [f"ori_{f}" for f in frames]
                          + ["000start_image.jpg"]) <= set(files)


def _story_cfg(stack, story_len=3):
    return StoryPipelineConfig(story_len=story_len, window_size=2,
                               num_img_in_tokens=stack.num_img_in_tokens)


@pytest.mark.parametrize("flow", ["sequential", "sink"])
def test_gen_george_cli_one_story(ws, tmp_path, flow):
    extra = ["--max_stories", "1"] + (["--sink", "--speculate_k", "4"] if flow == "sink" else [])
    gen_george.main(_argv(ws, tmp_path / "out") + extra, device="cpu")
    kw = dict(sink=True, speculate_k=4, cache_capacity=None) if flow == "sink" else {}
    if flow == "sink":  # the CLI's sink capacity rule at these sizes
        need = 80 + 2 * (24 + 70) + 24 + 4 + 1 + 28 * 3
        kw["cache_capacity"] = -(-need // 128) * 128
    stack = _stack(ws, **kw)
    pipe = StoryGenerationPipeline(stack.tokenizer, stack.generator, stack.visual_encode,
                                   stack.detokenize, _story_cfg(stack))
    pixels, captions = _seed(ws, stack, 0)
    run = pipe.run_sink if flow == "sink" else pipe.run
    _expect(str(tmp_path / "out" / "val_0"), list(run(pixels, captions[0])))


def test_gen_george_cli_batch_stories(ws, tmp_path):
    gen_george.main(_argv(ws, tmp_path / "out") + ["--max_stories", "2", "--batch_stories", "2"],
                    device="cpu")
    stack = _stack(ws, batch_stories=2)
    pipe = StoryGenerationPipeline(stack.tokenizer, stack.generator, stack.visual_encode,
                                   stack.detokenize, _story_cfg(stack))
    seeds = [_seed(ws, stack, j) for j in range(2)]
    rounds = list(pipe.run_batch([(px, caps[0]) for px, caps in seeds]))
    for j in range(2):
        _expect(str(tmp_path / "out" / f"val_{j}"), [r[j] for r in rounds if r[j] is not None])


def test_vis_george_sink_cli(ws, tmp_path):
    vis_george_sink.main(_argv(ws, tmp_path / "out", "vis.jsonl", story_len=4)
                         + ["--max_stories", "1"], device="cpu")
    stack = _stack(ws, sink=True)
    pipe = StoryVisualizationPipeline(
        stack.tokenizer, stack.generator, stack.visual_encode, stack.detokenize,
        VisPipelineConfig(story_len=4, window_size=2, num_img_in_tokens=stack.num_img_in_tokens))
    pixels, captions = _seed(ws, stack, 0, "vis.jsonl")
    segments = list(pipe.run(pixels, captions[0], captions[1:]))
    assert len(segments) == 3  # the window of 2 evicts the oldest image once
    _expect(str(tmp_path / "out" / "val_0"), segments)


@pytest.mark.parametrize("main", [gen_george.main, vis_george_sink.main])
@pytest.mark.parametrize("flag,match", [
    (["--detok_devices", "1"], "must not share a device"),
    (["--decode_tp", "2"], "mesh 1x2 > 1 devices"),
])
def test_cli_refuses_what_is_not_ported(ws, tmp_path, main, flag, match):
    """On one device (here the CPU) --detok_devices is refused, as the JAX
    CLIs refuse a replica on the decode chip, and so is --decode_tp 2: a
    1 x 2 mesh larger than the visible devices, as the JAX make_mesh
    refuses it. Both before anything is written."""
    with pytest.raises(SystemExit, match=match):
        main(_argv(ws, tmp_path / "out") + flag, device="cpu")
    assert not (tmp_path / "out").exists()


def _expect_images(folder, segments):
    """The CLI's ``ori_XX.jpg`` frames are the segments' images, JPEG-coded
    the same way."""
    for seg in segments:
        if seg.image is None:
            continue
        buf = os.path.join(folder, f"want_{seg.index:02d}.jpg")
        Image.fromarray(seg.image).save(buf)
        got = np.asarray(Image.open(os.path.join(folder, f"ori_{seg.index:02d}.jpg")))
        assert np.array_equal(got, np.asarray(Image.open(buf))), seg.index
        os.remove(buf)


def _flow(name, ws, stack):
    """The pipeline run a CLI makes for the first story, on ``stack``."""
    if name == "gen_george":
        pipe = StoryGenerationPipeline(stack.tokenizer, stack.generator, stack.visual_encode,
                                       stack.detokenize, _story_cfg(stack))
        pixels, captions = _seed(ws, stack, 0)
        return list(pipe.run(pixels, captions[0]))
    pipe = StoryVisualizationPipeline(
        stack.tokenizer, stack.generator, stack.visual_encode, stack.detokenize,
        VisPipelineConfig(story_len=4, window_size=2, num_img_in_tokens=stack.num_img_in_tokens))
    pixels, captions = _seed(ws, stack, 0, "vis.jsonl")
    return list(pipe.run(pixels, captions[0], captions[1:]))


CLIS = {"gen_george": (gen_george.main, "val.jsonl", 3, {}),
        "vis_george_sink": (vis_george_sink.main, "vis.jsonl", 4, dict(sink=True))}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_sdxl_int8(ws, tmp_path, name):
    """--sdxl_int8: the CLI's texts and frames equal the port's pipeline on a
    stack whose adapter's UNet is quantized in place (the conditioning MLPs
    and conv_in / conv_out float); its images differ from the float UNet's."""
    main, jsonl, story_len, kw = CLIS[name]
    main(_argv(ws, tmp_path / "out", jsonl, story_len) + ["--max_stories", "1", "--sdxl_int8"],
         device="cpu")
    stack = _stack(ws, sdxl_int8=True, **kw)
    unet = stack.image_pipe.adapter.unet
    assert stack.image_pipe.adapter.cfg.unet.quantize
    assert unet.mid_block.attentions[0].proj_in.weight.dtype == torch.int8
    assert unet.conv_in.weight.dtype == unet.time_embedding.linear_1.weight.dtype == torch.float32
    segments = _flow(name, ws, stack)
    folder = str(tmp_path / "out" / "val_0")
    _expect(folder, segments)
    _expect_images(folder, segments)
    floats = _flow(name, ws, _stack(ws, **kw))
    assert [s.text for s in floats] == [s.text for s in segments]  # the agent is the same
    assert any(not np.array_equal(a.image, b.image) for a, b in zip(floats, segments)
               if a.image is not None)


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_checkpoint_flags(ws, tmp_path, name):
    """--vit_ckpt, --agent_ckpt, --adapter_ckpt and --vae_ckpt on
    ``save_params`` files of a stack with other seeds: the CLI's texts and
    frames are that stack's, not those of the seeded default."""
    main, jsonl, story_len, kw = CLIS[name]
    source = _stack(ws, seed=5, **kw)
    parts = {"vit": source.vit, "agent": source.agent, "adapter": source.image_pipe.adapter,
             "vae": source.image_pipe.vae}
    flags = []
    for part, module in parts.items():
        save_params(str(tmp_path / f"{part}.pt"), module.state_dict())
        flags += [f"--{part}_ckpt", str(tmp_path / f"{part}.pt")]
    main(_argv(ws, tmp_path / "out", jsonl, story_len) + ["--max_stories", "1"] + flags,
         device="cpu")
    segments = _flow(name, ws, source)
    folder = str(tmp_path / "out" / "val_0")
    _expect(folder, segments)
    _expect_images(folder, segments)
    default = _flow(name, ws, _stack(ws, **kw))
    assert any(not np.array_equal(a.image, b.image) for a, b in zip(default, segments)
               if a.image is not None)


def test_int8_agent_checkpoint_loads_its_bytes(ws, tmp_path):
    """A quantize_base agent's save_params file through --agent_ckpt (a
    LLaMA YAML with quantize_base): the stack's int8 weights and scales are
    the saved ones bit for bit, not float-cast integers, and the CLI decodes
    that agent's texts. A float checkpoint of the same agent loads before
    the quantization and gives the same bytes."""
    cfg = ws / "configs"
    llm = str(cfg / "llm_int8.yaml")

    def stack(**kw):
        return build_stack_from_yaml(str(cfg / "tokenizer.yaml"), str(cfg / "transform.yaml"),
                                     str(cfg / "vit.yaml"), llm, str(cfg / "agent.yaml"),
                                     device="cpu", **SIZES, **kw)

    saved = stack(seed=5).agent.state_dict()
    assert saved["llm.model.layers.0.self_attn.q_proj.weight"].dtype == torch.int8
    save_params(str(tmp_path / "agent_int8.pt"), saved)
    target = stack(agent_ckpt=str(tmp_path / "agent_int8.pt"))
    loaded = target.agent.state_dict()
    assert sorted(loaded) == sorted(saved)
    for key, value in saved.items():
        assert loaded[key].dtype == value.dtype and torch.equal(loaded[key], value), key
    assert not torch.equal(stack().agent.state_dict()["llm.lm_head.weight"],
                           saved["llm.lm_head.weight"])  # the default seed differs

    float_source = _stack(ws, seed=5, quantize_base=True)  # the same agent, quantized
    float_agent = build_stack_from_yaml(
        *(str(cfg / f"{n}.yaml") for n in STACK_ARGS), device="cpu", seed=5,
        **SIZES).agent  # float
    save_params(str(tmp_path / "agent_f32.pt"), float_agent.state_dict())
    again = stack(agent_ckpt=str(tmp_path / "agent_f32.pt")).agent.state_dict()
    for key, value in float_source.agent.state_dict().items():
        assert torch.equal(again[key], value), key

    argv = [a if a != str(cfg / "llm.yaml") else llm for a in _argv(ws, tmp_path / "out")]
    gen_george.main(argv + ["--max_stories", "1", "--no_images", "--agent_ckpt",
                            str(tmp_path / "agent_int8.pt")], device="cpu")
    pipe = StoryGenerationPipeline(target.tokenizer, target.generator, target.visual_encode,
                                   None, _story_cfg(target))
    pixels, captions = _seed(ws, target, 0)
    _, texts, _ = _story_files(str(tmp_path / "out" / "val_0"))
    assert texts == [seg.text for seg in pipe.run(pixels, captions[0])]
