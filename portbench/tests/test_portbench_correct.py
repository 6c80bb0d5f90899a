"""`correct` fails where it must: the rest of a run, the look for a card
skipped (small cells on the CPU), with the timed path broken underneath, and
with the control, the reference in bfloat16, put in the program's place."""

from __future__ import annotations

import pytest
import torch

import primestereomatch_torch.app as app_mod
from portbench import run
from portbench.reference import gif as ref_gif
from portbench.tests.tiny import tiny_root

FORWARD = app_mod.stereo_gif_forward


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def one_run(root, name, seed=2**31 + 11):
    return run.run_cell(name, seed, 0.6, False, device="cpu", root=root,
                        log=lambda *a, **k: None)


def stale():
    """Every frame gets the first frame's disparities: a step that returns
    its state unchanged."""
    first = {}

    def forward(l_img, r_img, cfg, **kw):
        if "out" not in first:
            first["out"] = FORWARD(l_img, r_img, cfg, **kw)
        return first["out"]
    return forward


def half_batch(l_img, r_img, cfg, **kw):
    """The right view left out of the batch of two views."""
    ld, rd = FORWARD(l_img, r_img, cfg, **kw)
    return ld, torch.zeros_like(rd)


def altered(l_img, r_img, cfg, **kw):
    """Each answer altered where it is produced: the left view's disparities
    one level off."""
    ld, rd = FORWARD(l_img, r_img, cfg, **kw)
    return ld + 1, rd


def control_bf16(l_img, r_img, cfg, **kw):
    """The reference, computed in bfloat16, in the program's place."""
    gif = {k: getattr(cfg, k) for k in ("max_dis", "alpha", "border_cost", "gif_radius",
                                        "gif_eps", "subsample", "med_sz", "wmf_sigma")}
    u8 = [torch.round(t * 255).to(torch.uint8) for t in (l_img, r_img)]
    out = ref_gif.disparities(*u8, gif, torch.bfloat16)
    return out[0], out[1]


@pytest.mark.parametrize("name", ["tiny_2k.max", "tiny_vga.max"])
def test_a_sound_run_is_correct(tiny, name):
    out = one_run(tiny, name)
    assert out["correct"] and out["failed"] == 0
    assert all(c["value"] == 0 for c in out["checks"].values())


FAULTS = {"state_unchanged": stale, "half_batch": lambda: half_batch,
          "answer_altered": lambda: altered, "control_bf16": lambda: control_bf16}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", ["tiny_2k.max", "tiny_vga.max"])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, name, fault):
    monkeypatch.setattr(app_mod, "stereo_gif_forward", FAULTS[fault]())
    out = one_run(tiny, name)
    assert not out["correct"] and out["failed"] > 0
    assert out["checks"]["disp_mismatch"]["value"] > out["checks"]["disp_mismatch"]["limit"]


def test_a_rectifier_that_skips_its_remap_is_not_correct(tiny, monkeypatch):
    """The calibrated cell's crops taken from the raw frames unrectified."""
    rectify = app_mod.StereoMatchApp._rectify

    def unrectified(self, l_raw, r_raw):
        if self._rectifier is None:
            rectify(self, l_raw, r_raw)
        x0, y0, x1, y1 = self._rectifier.crop
        return (l_raw[y0:y1, x0:x1].contiguous(), r_raw[y0:y1, x0:x1].contiguous())

    monkeypatch.setattr(app_mod.StereoMatchApp, "_rectify", unrectified)
    out = one_run(tiny, "tiny_vga.max")
    assert not out["correct"]
    assert out["checks"]["crop_mismatch"]["value"] > out["checks"]["crop_mismatch"]["limit"]
