"""Each driver against the plain reference at a pico size on the CPU (the
program's plain kernels): sound runs come out correct, and a run whose timed
path is broken underneath (a served token or an image altered where it is
produced, the UNet's output scaled at every step) comes out not correct, and
so does a run with the control, the reference one precision below the
configuration's, in the program's place."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench.tests.pico import run_cell
from seed_story_torch.decode.generate import StoryGenerator
from seed_story_torch.models.sdxl.unet import UNet2DConditionModel
from seed_story_torch.pipelines.sdxl_pipeline import SDXLImagePipeline

SEEDS = (2147483901, 3000000017)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["agent_story_b4", "detok_1024_b4"])
def test_a_sound_run_is_correct(cell, seed):
    out = run_cell(cell, seed, seconds=1.0 if cell == "agent_story_b4" else 0.1)
    assert out["result"]["correct"], out["checks"]
    assert out["result"]["attempted"] >= 4 and out["result"]["failed"] == 0


def test_a_served_token_altered_where_it_is_produced_fails(monkeypatch):
    spec_loop = StoryGenerator._spec_loop

    def altered(self, *args, **kwargs):
        rows = spec_loop(self, *args, **kwargs)
        for ids in rows:
            ids[3] = 100 + (int(ids[3]) + 7) % 31000
        return rows

    monkeypatch.setattr(StoryGenerator, "_spec_loop", altered)
    out = run_cell("agent_story_b4", SEEDS[0])
    assert not out["result"]["correct"]
    assert not out["checks"]["logit_gap"]["ok"]


def test_an_image_altered_where_it_is_produced_fails(monkeypatch):
    generate = SDXLImagePipeline.generate

    def altered(self, *args, **kwargs):
        images = generate(self, *args, **kwargs)
        images[0, 0, 0, 0] ^= np.uint8(0x40)
        return images

    monkeypatch.setattr(SDXLImagePipeline, "generate", altered)
    out = run_cell("detok_1024_b4", SEEDS[0])
    assert not out["result"]["correct"]
    assert not out["checks"]["uint8_mismatch"]["ok"]


def test_a_unet_output_altered_at_every_step_fails(monkeypatch):
    forward = UNet2DConditionModel.forward

    def altered(self, *args, **kwargs):
        return forward(self, *args, **kwargs) * 1.2

    monkeypatch.setattr(UNet2DConditionModel, "forward", altered)
    out = run_cell("detok_1024_b4", SEEDS[1])
    assert not out["result"]["correct"]
    assert not out["checks"]["eps_rel"]["ok"]


@pytest.mark.parametrize("cell", ["agent_story_b4", "detok_1024_b4"])
def test_the_control_fails_a_compared_number(cell):
    out = run_cell(cell, SEEDS[0], seconds=1.0 if cell == "agent_story_b4" else 0.1,
                   control=True)
    assert not out["result"]["correct"], out["checks"]
    assert not all(c["ok"] for c in out["checks"].values())
