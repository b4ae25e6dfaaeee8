"""The port's framework-free copies against their JAX-package originals:
``data/spm.py`` (and the tokenizer's ``.model``-only fallback),
``data/native_loader.py``, ``eval/*``, ``tools/storystream.py`` and
``tools/reload_qwen_vit.py``. Inputs are made from seeds with numpy; the
GPT protocols run on one fake client whose recorded calls are compared."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from seed_story_torch.data import native_loader as port_native
from seed_story_torch.data import spm as port_spm
from seed_story_tpu.data import native_loader as jax_native
from seed_story_tpu.data import spm as jax_spm

CONTROLS = [("<unk>", 0.0, jax_spm.UNKNOWN), ("<s>", 0.0, jax_spm.CONTROL),
            ("</s>", 0.0, jax_spm.CONTROL)]
BYTES = [(f"<0x{b:02X}>", 0.0, jax_spm.BYTE) for b in range(256)]
TEXTS = ["hello story", "  the  monkey climbs a tree  ", "naïve café — ünïcödé",
         "George<img>x</img> waved", ""]


def _pieces(seed, n=60):
    rng = np.random.RandomState(seed)
    words = ["▁hello", "▁story", "▁the", "▁monkey", "▁climb", "s", "▁a", "▁tree",
             "▁George", "▁wav", "ed", "he", "ll", "o", "▁t", "r", "e"]
    pieces = [(w, float(-rng.rand() * 5), jax_spm.NORMAL) for w in words]
    for i in range(n - len(words)):
        chars = "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), rng.randint(1, 4)))
        pieces.append(("▁" + chars if i % 2 else chars, float(-rng.rand() * 8),
                       jax_spm.NORMAL))
    seen, out = set(), []
    for p in pieces:
        if p[0] not in seen:
            seen.add(p[0])
            out.append(p)
    return out


@pytest.mark.parametrize("model_type,byte_fallback", [
    (jax_spm.BPE, True), (jax_spm.UNIGRAM, True), (jax_spm.UNIGRAM, False)])
def test_spm_matches_the_jax_copy(tmp_path, model_type, byte_fallback):
    blob = jax_spm.build_sentencepiece_model(
        CONTROLS + (BYTES if byte_fallback else []) + _pieces(model_type),
        model_type=model_type, byte_fallback=byte_fallback)
    assert port_spm.build_sentencepiece_model(
        CONTROLS + (BYTES if byte_fallback else []) + _pieces(model_type),
        model_type=model_type, byte_fallback=byte_fallback) == blob
    path = tmp_path / "tokenizer.model"
    path.write_bytes(blob)
    ours, ref = port_spm.SentencePieceTokenizer(str(path)), jax_spm.SentencePieceTokenizer(str(path))
    from seed_story_tpu.data.tokenizer import special_tokens

    assert ours.add_tokens(special_tokens()) == ref.add_tokens(special_tokens())
    assert len(ours) == len(ref)
    for text in TEXTS:
        for special in (True, False):
            ids = ours.encode(text, add_special_tokens=special)
            assert ids == ref.encode(text, add_special_tokens=special), text
            assert ours.decode(ids) == ref.decode(ids)
            assert ours.decode(ids, skip_special_tokens=True) == ref.decode(
                ids, skip_special_tokens=True)
            assert ours.convert_ids_to_tokens(ids) == ref.convert_ids_to_tokens(ids)


def test_tokenizer_falls_back_to_the_ports_spm_on_a_model_only_asset(tmp_path):
    """A directory with only ``tokenizer.model``: the slow HF tokenizer
    raises its sentencepiece ImportError here, and both packages land on
    their pure-Python tokenizer with the canonical 32000 + 66 layout."""
    from seed_story_torch.data.tokenizer import load_llama_tokenizer
    from seed_story_tpu.data.tokenizer import LLAMA_VOCAB_SIZE
    from seed_story_tpu.data.tokenizer import load_llama_tokenizer as jax_load

    filler = [(f"▁w{i:05d}", -float(i) / 1000.0, jax_spm.NORMAL)
              for i in range(LLAMA_VOCAB_SIZE - len(CONTROLS) - len(BYTES))]
    (tmp_path / "tokenizer.model").write_bytes(jax_spm.build_sentencepiece_model(
        CONTROLS + BYTES + filler, model_type=jax_spm.BPE, byte_fallback=True,
        remove_extra_whitespaces=False))
    ours, ref = load_llama_tokenizer(str(tmp_path)), jax_load(str(tmp_path))
    assert isinstance(ours, port_spm.SentencePieceTokenizer)
    assert len(ours) == len(ref) == 32066
    text = "<img><img_00000><img_00063></img> w00012w00007 ünï"
    assert ours.encode(text) == ref.encode(text)
    assert ours.convert_tokens_to_ids("<img_00063>") == 32065
    with pytest.raises(ImportError):  # no .model file: the ImportError stands
        load_llama_tokenizer(str(tmp_path / "absent"))


@pytest.fixture(scope="module")
def jpgs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpgs")
    rng = np.random.RandomState(0)
    paths = []
    for i, (w, h) in enumerate([(320, 240), (150, 250), (96, 96)]):
        arr = rng.randint(0, 255, (h, w, 3), np.uint8)
        arr = np.asarray(Image.fromarray(arr).resize((w, h), Image.BILINEAR))
        path = str(d / f"img{i}.jpg")
        Image.fromarray(arr).save(path, quality=95)
        paths.append(path)
    return paths


@pytest.mark.parametrize("mode,keep_ratio", [("clip", False), ("clip", True), ("sd", True)])
def test_native_loader_matches_the_jax_loader(jpgs, tmp_path, mode, keep_ratio):
    """The same library (or, without libjpeg, the same PIL path) gives the
    same bits through either package's loader."""
    assert port_native.native_available() == jax_native.native_available()
    ours = port_native.NativeImageTransform(mode, keep_ratio=keep_ratio, image_size=64)
    ref = jax_native.NativeImageTransform(mode, keep_ratio=keep_ratio, image_size=64)
    for path in jpgs:
        np.testing.assert_array_equal(ours(path), ref(path))
        np.testing.assert_array_equal(ours(Image.open(path)), ref(Image.open(path)))
    png = Image.new("RGB", (70, 50), (10, 200, 30))  # no file: the Python transform
    np.testing.assert_array_equal(ours(png), ref(png))
    if port_native.native_available():
        bad = str(tmp_path / "missing.jpg")
        got = port_native.load_batch(jpgs + [bad], 32, mode, keep_ratio, nthreads=2)
        want = jax_native.load_batch(jpgs + [bad], 32, mode, keep_ratio, nthreads=2)
        assert got[1].tolist() == want[1].tolist() == [True, True, True, False]
        np.testing.assert_array_equal(got[0][:3], want[0][:3])  # a failed slot is not written
        np.testing.assert_array_equal(got[2][:3], want[2][:3])


def _fake_client(reply):
    class Completions:
        def __init__(self):
            self.calls = []

        def create(self, **kw):
            self.calls.append(kw)
            msg = type("M", (), {"content": reply})()
            choice = type("Ch", (), {"message": msg})()
            return type("R", (), {"choices": [choice]})()

    client = type("Client", (), {})()
    client.chat = type("Chat", (), {})()
    client.chat.completions = Completions()
    return client


def _story_folders(root):
    rng = np.random.RandomState(3)
    for v in range(2):
        d = root / f"val_{v}"
        d.mkdir()
        (d / "text.txt").write_text("\n".join(f"[INST]sentence {i} of story {v}"
                                              for i in range(6)))
        for j in range(1, 6):
            Image.fromarray(rng.randint(0, 255, (16, 16, 3), np.uint8)).save(d / f"ori_0{j}.jpg")


def test_gpt_evals_match_the_jax_protocols(tmp_path):
    from seed_story_torch.eval import gpt_comparative_eval as ours_cmp
    from seed_story_torch.eval import gpt_score_eval as ours_score
    from seed_story_tpu.eval import gpt_comparative_eval as ref_cmp
    from seed_story_tpu.eval import gpt_score_eval as ref_score

    _story_folders(tmp_path)
    for reply in ("Consistent style. [[8]]", "no verdict at all"):
        a, b = _fake_client(reply), _fake_client(reply)
        (tmp_path / "a").mkdir(exist_ok=True)
        (tmp_path / "b").mkdir(exist_ok=True)
        got = ours_score.evaluate_folder(str(tmp_path), client=a, out_dir=str(tmp_path / "a"))
        want = ref_score.evaluate_folder(str(tmp_path), client=b, out_dir=str(tmp_path / "b"))
        assert got == want
        assert a.chat.completions.calls == b.chat.completions.calls
        for name in ("style", "engaging", "coherence"):
            assert ((tmp_path / "a" / f"result_{name}.txt").read_text()
                    == (tmp_path / "b" / f"result_{name}.txt").read_text())
    stories = ours_score.read_story_folders(str(tmp_path), n_folders=2)
    assert stories == ref_score.read_story_folders(str(tmp_path), n_folders=2)
    for reply in ("A is better [[A]]", "tie [[C]]", "garbage"):
        a, b = _fake_client(reply), _fake_client(reply)
        assert (ours_cmp.compare(stories, stories[::-1], client=a)
                == ref_cmp.compare(stories, stories[::-1], client=b))
        assert a.chat.completions.calls == b.chat.completions.calls
    assert ours_score.find_number_in_string("x [[7]] y") == 7


def test_storystream_matches_the_jax_tools(tmp_path):
    from seed_story_torch.tools import storystream as ours
    from seed_story_tpu.tools import storystream as ref

    captions = tmp_path / "captions.jsonl"
    with open(captions, "w") as f:
        for i in range(5):
            f.write(json.dumps({"image": f"frame_{i:03d}.jpg",
                                "caption": f"a monkey does thing {i}"}) + "\n")
    reply = "frame_000.jpg->George starts the day.\nframe_001.jpg->George finds a kite."
    a, b = _fake_client(reply), _fake_client(reply)
    for mod, client, name in ((ours, a, "a.jsonl"), (ref, b, "b.jsonl")):
        assert mod.build_stories_v1(str(captions), str(tmp_path / name), client=client,
                                    story_len=3, subtitles=["SUB 1", "SUB 2"]) == 2
    assert a.chat.completions.calls == b.chat.completions.calls
    assert (tmp_path / "a.jsonl").read_text() == (tmp_path / "b.jsonl").read_text()

    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.RandomState(4)
    for i in range(12):
        Image.fromarray(rng.randint(0, 255, (8, 8, 3), np.uint8)).save(frames / f"k{i}.jpg")
    reply = "x {{k0.jpg->one@@k1.jpg->two@@k10.jpg->three}} y"
    a, b = _fake_client(reply), _fake_client(reply)
    assert (ours.build_stories(str(frames), str(tmp_path / "v2a.jsonl"), client=a, batch=4)
            == ref.build_stories(str(frames), str(tmp_path / "v2b.jsonl"), client=b, batch=4)
            == 1)
    assert a.chat.completions.calls == b.chat.completions.calls
    assert (tmp_path / "v2a.jsonl").read_text() == (tmp_path / "v2b.jsonl").read_text()
    assert ours.find_jpg_files(str(frames)) == ref.find_jpg_files(str(frames))

    entries = [{"images": [f"f{i}.jpg" for i in range(30)],
                "captions": [f"c{i}" for i in range(30)]},
               {"images": ["x.jpg"], "captions": []}]
    assert ours.split_entries(entries, 10) == ref.split_entries(entries, 10)
    src = tmp_path / "in.jsonl"
    src.write_text(json.dumps(entries[0]) + "\n")
    assert ours.chunk_files(str(src), str(tmp_path / "c1.jsonl"), 10) == ref.chunk_files(
        str(src), str(tmp_path / "c2.jsonl"), 10) == 3
    assert (tmp_path / "c1.jsonl").read_text() == (tmp_path / "c2.jsonl").read_text()
    for text in ("p {{a.jpg->one@@b.jpg->two}} t", "no grammar"):
        assert ours.convert_to_jsonl(text) == ref.convert_to_jsonl(text)


def test_reload_qwen_vit_output_runs_like_the_jax_conversion(tmp_path):
    """A Qwen-VL-layout checkpoint (the ``transformer.visual.*`` subtree
    beside other entries) goes through the port's tool into a tiny port ViT,
    and through ``convert_qwen_vit`` into the JAX ViT: same features."""
    import jax.numpy as jnp

    from seed_story_torch.models.vit import ViTConfig, VisionTransformerWithAttnPool
    from seed_story_torch.tools import reload_qwen_vit
    from seed_story_tpu.models.vit import ViTConfig as JViTConfig
    from seed_story_tpu.models.vit import VisionTransformerWithAttnPool as JViT
    from seed_story_tpu.tools.convert_torch_weights import convert_qwen_vit

    cfg = ViTConfig.tiny(dtype=torch.float32)
    rng = np.random.RandomState(7)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in VisionTransformerWithAttnPool(cfg).state_dict().items()}
    visual = {k: torch.from_numpy((rng.randn(*s) * 0.05).astype(np.float32))
              for k, s in shapes.items()}
    full = {f"transformer.visual.{k}": v for k, v in visual.items()}
    full["transformer.wte.weight"] = torch.zeros(4, 4)
    torch.save(full, tmp_path / "qwen.pt")
    out, raw = tmp_path / "vit.pt", tmp_path / "qwen_vit_G.pt"
    missing, unexpected, mismatched = reload_qwen_vit.main(
        ["--qwen_checkpoint", str(tmp_path / "qwen.pt"), "--output", str(out),
         "--torch_output", str(raw), "--layers", str(cfg.layers)], vit_cfg=cfg)
    assert not missing and not unexpected and not mismatched
    assert sorted(torch.load(raw, weights_only=True)) == sorted(visual)
    # an already-extracted tower goes through unchanged
    reload_qwen_vit.main(["--qwen_checkpoint", str(raw), "--output", str(tmp_path / "v2.pt"),
                          "--layers", str(cfg.layers)], vit_cfg=cfg)
    vit = VisionTransformerWithAttnPool(cfg)
    vit.load_state_dict(torch.load(out, weights_only=True))
    for k, v in torch.load(tmp_path / "v2.pt", weights_only=True).items():
        torch.testing.assert_close(v, visual[k], rtol=0, atol=0)

    params, jmissing, junexpected = convert_qwen_vit(
        {k: v.numpy() for k, v in visual.items()}, layers=cfg.layers)
    assert not jmissing and not junexpected
    jcfg = JViTConfig.tiny(dtype=jnp.float32)
    pixels = rng.randn(2, 3, cfg.image_size, cfg.image_size).astype(np.float32)
    want = np.asarray(JViT(jcfg).apply({"params": params}, jnp.asarray(pixels)))
    with torch.no_grad():
        got = vit(torch.from_numpy(pixels)).numpy()
    # the tolerance of tests/test_torch_vit_agent.py's ViT parity
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
