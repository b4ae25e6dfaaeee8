"""The port's own copies of the JAX package's framework-free data modules
(``seed_story_torch/data``, ``seed_story_torch/utils/config.py``) against
the originals, on a pico jsonl + jpg workspace; and the ``_target_``
mapping that lets the port read the unchanged ``configs/`` YAMLs."""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
from PIL import Image

from seed_story_torch.data import builders as port_builders
from seed_story_torch.data import datapipes as port_datapipes
from seed_story_torch.data import story_telling as port_story
from seed_story_torch.data import tokenizer as port_tok
from seed_story_torch.data import transforms as port_transforms
from seed_story_torch.utils import config as port_config
from seed_story_tpu.data import builders as ref_builders
from seed_story_tpu.data import story_telling as ref_story
from seed_story_tpu.data import tokenizer as ref_tok
from seed_story_tpu.data import transforms as ref_transforms

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Three stories of 5 jpgs each (one too small to pass the filter) and
    their captions in two jsonl shards."""
    root = tmp_path_factory.mktemp("data_ws")
    (root / "images").mkdir()
    (root / "data").mkdir()
    rng = np.random.RandomState(0)
    for shard in range(2):
        with open(root / "data" / f"part{shard}.jsonl", "w") as f:
            for s in range(3):
                names = []
                for i in range(5):
                    name = f"p{shard}_s{s}_{i}.jpg"
                    side = 40 if (shard, s) == (1, 2) else 96 + 16 * i
                    pixels = rng.randint(0, 256, size=(side, side + 8 * s, 3)).astype(np.uint8)
                    Image.fromarray(pixels).save(root / "images" / name)
                    names.append(name)
                f.write(json.dumps({"images": names, "captions": [
                    f"shard {shard} story {s} scene {i}: the dog's walk, part {i}!"
                    for i in range(5)]}) + "\n")
            f.write("not json\n")
    return root


def _pipe_kwargs(root, **more):
    kwargs = dict(data_dir=str(root / "data"), image_dir=str(root / "images"), story_len=5,
                  max_length=200, batch_size=2, min_resolution=64, min_aspect_ratio=0.2,
                  num_img_in_tokens=4, num_img_out_tokens=4, cycle_count=3, seed=7)
    return {**kwargs, **more}


def _assert_same_batches(got, want):
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("text", [
    "george the monkey went to the park",
    "[INST] a caption <img><img_00000><img_00063></img> [/INST] don't stop!",
    "",
])
def test_tiny_tokenizer_matches_the_jax_package(text):
    port, ref = port_tok.TinyTokenizer(), ref_tok.TinyTokenizer()
    for special in (False, True):
        ids = port.encode(text, add_special_tokens=special)
        assert ids == ref.encode(text, add_special_tokens=special)
        for skip in (False, True):
            assert port.decode(ids, skip_special_tokens=skip) == ref.decode(
                ids, skip_special_tokens=skip)
    assert len(port) == len(ref)


def test_token_constants_match_the_jax_package():
    for name in ("BOI_TOKEN", "EOI_TOKEN", "IMG_TOKEN", "LLAMA_VOCAB_SIZE", "NUM_IMG_TOKENS",
                 "MULTIMODAL_VOCAB_SIZE", "BOI_TOKEN_ID", "EOI_TOKEN_ID", "FIRST_IMG_TOKEN_ID"):
        assert getattr(port_tok, name) == getattr(ref_tok, name), name
    assert port_tok.special_tokens() == ref_tok.special_tokens()
    for n in (4, 64):
        assert port_tok.image_comprehension_string(n) == ref_tok.image_comprehension_string(n)


@pytest.mark.parametrize("kind,keep_ratio", [("clip", False), ("clip", True), ("clipa", True),
                                             ("sd", True), ("sd", False)])
def test_image_transform_matches_the_jax_package(kind, keep_ratio):
    pixels = np.random.RandomState(1).randint(0, 256, size=(50, 70, 3)).astype(np.uint8)
    img = Image.fromarray(pixels)
    got = port_transforms.get_transform(kind, keep_ratio, 28)(img)
    want = ref_transforms.get_transform(kind, keep_ratio, 28)(img)
    assert got.dtype == want.dtype and got.shape == want.shape == (3, 28, 28)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("keep_ratio", [False, True])
def test_long_story_datapipe_matches_the_jax_package(workspace, keep_ratio):
    """The long-story datapipe with the ViT's transform gives the same
    batches, in the same order, as the JAX package's."""
    def batches(builders, tok, transforms, n=6):
        pipe = builders.build_long_story_datapipe(
            tokenizer=tok.TinyTokenizer(),
            image_transform=transforms.get_transform("clip", keep_ratio, 28),
            **_pipe_kwargs(workspace))
        it = iter(pipe)
        return [next(it) for _ in range(n)]

    _assert_same_batches(batches(port_builders, port_tok, port_transforms),
                         batches(ref_builders, ref_tok, ref_transforms))


@pytest.mark.parametrize("height,width,target", [(480, 640, 64), (640, 480, 64),
                                                  (300, 300, 1024), (97, 131, 1024)])
def test_sdxl_micro_conditioning_matches_the_jax_package(height, width, target):
    got = port_story.sdxl_micro_conditioning(height, width, target)
    want = ref_story.sdxl_micro_conditioning(height, width, target)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert port_story.calculate_new_dimensions(height, width, target) == (
        ref_story.calculate_new_dimensions(height, width, target))


def _sd_batches(builders, tok, transforms, n, **kwargs):
    pipe = builders.build_long_story_datapipe(
        tokenizer=tok.TinyTokenizer(), image_transform=transforms.get_transform("clip", False, 28),
        sd_image_transform=transforms.get_transform("sd", True, 64), **kwargs)
    it = iter(pipe)
    return [next(it) for _ in range(n)]


def test_sd_image_transform_flows_like_the_jax_package(workspace, tmp_path):
    """Stage 3's targets: the long-story datapipe with the SDXL transform
    gives the JAX package's ``sd_images`` bit for bit and its ``time_ids``,
    on the shared workspace and on a 640x480 story, whose row carries the
    reference's swapped crop (the offset in the y slot)."""
    got = _sd_batches(port_builders, port_tok, port_transforms, 4, **_pipe_kwargs(workspace))
    _assert_same_batches(got, _sd_batches(ref_builders, ref_tok, ref_transforms, 4,
                                          **_pipe_kwargs(workspace)))
    assert got[0]["sd_images"].shape == (2, 3, 64, 64) and got[0]["time_ids"].shape == (2, 6)
    assert got[0]["sd_images"].dtype == np.float32 and got[0]["time_ids"].dtype == np.int32

    (tmp_path / "images").mkdir()
    (tmp_path / "data").mkdir()
    names = [f"s0_{i}.jpg" for i in range(4)]
    for i, name in enumerate(names):
        Image.new("RGB", (640, 480), (10 * i, 60, 120)).save(tmp_path / "images" / name)
    with open(tmp_path / "data" / "train.jsonl", "w") as f:
        f.write(json.dumps({"images": names,
                            "captions": [f"scene {i} with a dog" for i in range(4)]}) + "\n")
    kwargs = _pipe_kwargs(tmp_path, story_len=4, cycle_count=4)
    got = _sd_batches(port_builders, port_tok, port_transforms, 1, **kwargs)
    _assert_same_batches(got, _sd_batches(ref_builders, ref_tok, ref_transforms, 1, **kwargs))
    np.testing.assert_array_equal(got[0]["time_ids"], [[480, 640, 10, 0, 64, 64]] * 2)
    flat = port_story.flatten_images(got[0])
    assert flat["sd_images"] is got[0]["sd_images"] and flat["time_ids"] is got[0]["time_ids"]


def test_collate_and_flatten_images_match_the_jax_package(workspace):
    pipe = port_builders.build_long_story_datapipe(
        tokenizer=port_tok.TinyTokenizer(), **_pipe_kwargs(workspace, batch_size=None))
    it = iter(pipe)
    samples = [next(it) for _ in range(3)]
    got = port_story.collate(samples)
    _assert_same_batches([got], [ref_story.collate(samples)])
    flat = port_story.flatten_images(got)
    _assert_same_batches([flat], [ref_story.flatten_images(got)])
    assert flat["images"].shape == (3 * 5, 3, 448, 448)


def test_multi_datapipe_resumes_where_it_stopped(workspace):
    """``build_multi_datapipes`` from a data YAML, through the port's
    ``instantiate``: the JAX package's batches, and a restored state
    continues the stream exactly."""
    cfg = {"_target_": "seed_story_tpu.data.builders.build_multi_datapipes",
           "_recursive_": False, "sample_weights": [1.0, 2.0],
           "datapipes": [{"_target_": "seed_story_tpu.data.builders.build_long_story_datapipe",
                          **_pipe_kwargs(workspace)},
                         {"_target_": "seed_story_tpu.data.builders.build_long_story_datapipe",
                          **_pipe_kwargs(workspace, seed=8)}]}
    pipe = port_config.instantiate(cfg, tokenizer=port_tok.TinyTokenizer())
    assert isinstance(pipe, port_builders.MultiStoryDataPipe)
    it = iter(pipe)
    first = [next(it) for _ in range(3)]
    state = pipe.state()
    rest = [next(it) for _ in range(3)]

    ref = ref_builders.build_multi_datapipes(
        [ref_builders.build_long_story_datapipe(tokenizer=ref_tok.TinyTokenizer(),
                                                **_pipe_kwargs(workspace, seed=s))
         for s in (7, 8)], sample_weights=[1.0, 2.0])
    ref_it = iter(ref)
    _assert_same_batches(first + rest, [next(ref_it) for _ in range(6)])

    again = port_config.instantiate(cfg, tokenizer=port_tok.TinyTokenizer())
    again.set_state(json.loads(json.dumps(state)))
    again_it = iter(again)
    _assert_same_batches([next(again_it) for _ in range(3)], rest)


def test_threaded_loader_carries_the_state_of_each_batch():
    counter = {"n": 0}

    def produce():
        for i in range(5):
            counter["n"] = i + 1
            yield {"x": np.full(2, i)}

    loader = port_datapipes.ThreadedLoader(produce, prefetch=2,
                                           device_put_fn=lambda b: {"x": b["x"] * 10},
                                           state_fn=lambda: dict(counter))
    seen = []
    for batch in loader:
        seen.append((int(batch["x"][0]), loader.current_state["n"]))
    assert seen == [(10 * i, i + 1) for i in range(5)]


@pytest.mark.parametrize("target,want", [
    ("seed_story_tpu.data.tokenizer.TinyTokenizer", port_tok.TinyTokenizer),
    ("seed_story_tpu.data.transforms.get_transform", port_transforms.get_transform),
    ("seed_story_tpu.data.builders.build_long_story_datapipe",
     port_builders.build_long_story_datapipe),
    ("seed_story_tpu.data.builders.build_multi_datapipes", port_builders.build_multi_datapipes),
    ("seed_story_tpu.data.tokenizer.load_llama_tokenizer", port_tok.load_llama_tokenizer),
    ("seed_story_tpu.utils.config.resolve_target", port_config.resolve_target),
    ("seed_story_tpu.data.datapipes.ThreadedLoader", port_datapipes.ThreadedLoader),
    ("seed_story_tpu.data.story_telling.flatten_images", port_story.flatten_images),
    ("numpy.float32", np.float32),
])
def test_targets_resolve_to_the_port(target, want):
    assert port_config.resolve_target(target) is want


@pytest.mark.parametrize("target", [
    "seed_story_tpu.parallel.mesh.MeshConfig",
    "seed_story_tpu.models.vit.ViTConfig",
    "seed_story_tpu.ops.attention.mha",
])
def test_other_jax_package_targets_are_refused(target):
    with pytest.raises(ValueError, match="names the JAX package"):
        port_config.resolve_target(target)
    with pytest.raises(ValueError, match="names the JAX package"):
        port_config.instantiate({"_target_": target})


@pytest.mark.parametrize("path", ["configs/tokenizer/tiny_tokenizer.yaml",
                                  "configs/processer/qwen_448_transform.yaml",
                                  "configs/processer/sd_transform_1024.yaml"])
def test_shipped_yamls_instantiate_the_port(path):
    obj = port_config.instantiate(port_config.load_config(str(REPO / path)))
    assert type(obj).__module__.startswith("seed_story_torch.data.")


@pytest.fixture(scope="module")
def t2i_workspace(workspace, tmp_path_factory):
    """Text-to-image records over the workspace's jpgs (the 40 px ones fail
    the filter), a record without a caption, and one naming a missing file."""
    root = tmp_path_factory.mktemp("t2i_ws")
    names = sorted(p.name for p in (workspace / "images").iterdir())
    with open(root / "t2i.jsonl", "w") as f:
        for i, name in enumerate(names):
            f.write(json.dumps({"image": name, "caption": f"picture {i}: a dog's day!"}) + "\n")
        f.write(json.dumps({"image": names[0]}) + "\n")
        f.write(json.dumps({"image": "missing.jpg", "caption": "nothing"}) + "\n")
    return root


@pytest.mark.parametrize("with_sd", [False, True])
def test_t2i_datapipe_matches_the_jax_package(workspace, t2i_workspace, with_sd):
    """``build_t2i_datapipe`` (``decode_t2i_sample``) gives the same batches
    in the same order as the JAX package's, with and without the SDXL
    transform."""
    def batches(builders, tok, transforms, n=5):
        pipe = builders.build_t2i_datapipe(
            data_dir=str(t2i_workspace), image_dir=str(workspace / "images"),
            tokenizer=tok.TinyTokenizer(), max_length=48, batch_size=3, min_resolution=64,
            image_transform=transforms.get_transform("clip", True, 28),
            sd_image_transform=transforms.get_transform("sd", True, 32) if with_sd else None,
            num_img_out_tokens=4, cycle_count=2, seed=3)
        it = iter(pipe)
        return [next(it) for _ in range(n)]

    got = batches(port_builders, port_tok, port_transforms)
    _assert_same_batches(got, batches(ref_builders, ref_tok, ref_transforms))
    assert got[0]["images"].shape == (3, 1, 3, 28, 28) and got[0]["embeds_gen_mask"][:, 0].all()
    assert ("sd_images" in got[0]) == with_sd


def test_tar_readers_match_the_jax_package(tmp_path):
    """``list_tar_files`` (recursive or not) and ``iter_tar_members`` over
    two good shards and a corrupt one: the same members, the corrupt shard
    skipped with a warning; ``list_jsonl_files``'s ``recursive``."""
    import tarfile

    from seed_story_tpu.data import datapipes as ref_datapipes

    (tmp_path / "sub").mkdir()
    for i, where in enumerate((tmp_path, tmp_path / "sub")):
        member = tmp_path / f"m{i}.json"
        member.write_text(json.dumps({"i": i}))
        with tarfile.open(where / f"shard{i}.tar", "w") as tar:
            tar.add(member, arcname=f"sample{i}/m.json")
        (where / f"rec{i}.jsonl").write_text("{}\n")
    (tmp_path / "bad.tar").write_bytes(b"not a tar archive at all" * 40)
    for recursive in (True, False):
        want = ref_datapipes.list_tar_files(str(tmp_path), recursive)
        assert port_datapipes.list_tar_files(str(tmp_path), recursive) == want
        assert (port_datapipes.list_jsonl_files(str(tmp_path), recursive)
                == ref_datapipes.list_jsonl_files(str(tmp_path), recursive))
    shards = port_datapipes.list_tar_files([str(tmp_path)])
    assert len(shards) == 3
    with pytest.warns(UserWarning, match="corrupted tarfile"):
        got = list(port_datapipes.iter_tar_members(shards))
    with pytest.warns(UserWarning):
        want = list(ref_datapipes.iter_tar_members(shards))
    assert got == want and len(got) == 2
    assert json.loads(got[0][1]) in ({"i": 0}, {"i": 1})


def test_sample_multiplexer_matches_the_jax_package():
    from seed_story_tpu.data import datapipes as ref_datapipes

    pipes = [range(0, 5), range(100, 103), range(200, 220)]
    for weights in (None, [0.2, 0.3, 0.5]):
        got = list(port_datapipes.sample_multiplexer(pipes, weights, seed=4))
        assert got == list(ref_datapipes.sample_multiplexer(pipes, weights, seed=4))
        assert sorted(got) == sorted(x for p in pipes for x in p)


def test_bert_tokenizer_matches_the_jax_package(tmp_path):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "dog", "runs", "in", "the",
             "park", "##s", ",", "."]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    port, ref = port_tok.bert_tokenizer(str(tmp_path)), ref_tok.bert_tokenizer(str(tmp_path))
    assert port.bos_token == ref.bos_token == "[DEC]"
    assert port.truncation_side == ref.truncation_side == "right"
    text = "A dog runs in the parks, a cat."
    assert port(text)["input_ids"] == ref(text)["input_ids"]
    assert port.convert_tokens_to_ids("[DEC]") == ref.convert_tokens_to_ids("[DEC]") == len(vocab)


def test_every_reference_alias_resolves_to_the_ports_counterpart():
    """Each key of the JAX package's ``TARGET_ALIASES`` resolves in the port
    to the port's object of the same dotted path under ``seed_story_torch``
    as the JAX object it resolves to there; a JAX dtype to the torch one."""
    import importlib

    import torch

    from seed_story_tpu.utils import config as ref_config

    assert sorted(port_config.TARGET_ALIASES) == sorted(ref_config.TARGET_ALIASES)
    for key, jax_path in ref_config.TARGET_ALIASES.items():
        jax_obj = ref_config.resolve_target(key)
        module, _, name = jax_path.replace("seed_story_tpu.", "seed_story_torch.").rpartition(".")
        want = getattr(importlib.import_module(module), name)
        got = port_config.resolve_target(key)
        assert got is want and got.__name__ == jax_obj.__name__, key
        assert got.__module__.startswith("seed_story_torch."), key
    assert port_config.resolve_target("jax.numpy.bfloat16") is torch.bfloat16


def test_shipped_discrete_yaml_and_discrete_targets_instantiate_the_port():
    from seed_story_torch.models import discrete as port_discrete

    obj = port_config.instantiate(port_config.load_config(
        str(REPO / "configs/discrete_model/discrete_identity.yaml")))
    assert type(obj) is port_discrete.DiscreteModelIdentity
    model = port_config.instantiate({
        "_target_": "seed_story_tpu.models.discrete.DiscreteModelDistill", "use_vq": True,
        "cfg": {"_target_": "seed_story_tpu.models.discrete.DiscreteConfig", "dim": 8,
                "codebook_size": 4,
                "dtype": {"_target_": "seed_story_tpu.utils.config.resolve_target",
                          "path": "jax.numpy.float32"}}}, embed_dim=12)
    assert type(model) is port_discrete.DiscreteModelDistill
    assert model.quantizer.codebook.shape == (4, 8) and model.encode_proj.in_features == 12
    assert port_config.resolve_target("src.models.discrete_models.DiscreteModleIdentity") is (
        port_discrete.DiscreteModelIdentity)
