"""The plain reference against the program's plain path, on the CPU, at small
crops of both configurations: the port with device="cpu" runs the plain
PyTorch versions of its kernels, which its own tests hold to the kernels."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench.reference import calib as ref_calib
from portbench.reference import gif as ref_gif
from portbench.tests.tiny import ROOT
from portbench.traffic import scene

CONFIGS = ("gif_zed2k", "gif_zedvga_cal")


def config(name: str) -> dict:
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def layered_pair(H: int, W: int, D: int, seed: int):
    """A uint8 scene pair of disparities inside [2, D - 4]."""
    spec = {"regions": 6, "disp_range": f"2-{D - 4}", "side_px": f"8-{min(H, W) // 2}"}
    (left, right), _ = scene.scene_pairs(H, W, 1, spec, seed, torch.device("cpu"))[0]
    return scene.to_u8(left), scene.to_u8(right)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("shape", [(48, 320), (61, 203)])
def test_disparities_equal_the_ports_plain_path(name, shape):
    from primestereomatch_torch.app import U8_TO_F32
    from primestereomatch_torch.config import GIFConfig
    from primestereomatch_torch.models import stereo_gif_forward

    gif = config(name)["gif"]
    left, right = layered_pair(*shape, min(gif["max_dis"], 64), seed=11)
    got = ref_gif.disparities(left, right, gif)
    pcfg = GIFConfig(**{k: v for k, v in gif.items()})
    ld, rd = stereo_gif_forward(left.float() * U8_TO_F32, right.float() * U8_TO_F32, pcfg,
                                device="cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, *shape)
    assert torch.equal(got[0], ld) and torch.equal(got[1], rd)


@pytest.mark.parametrize("img_size, calib_size", [((672, 376), (1280, 720)),
                                                  ((1280, 720), None)])
def test_rectification_equals_the_ports(img_size, calib_size):
    from primestereomatch_torch.calib import Rectifier, load_stereo_calibration

    cdir = ROOT / config("gif_zedvga_cal")["calib_dir"]
    port = Rectifier(load_stereo_calibration(str(cdir / "intrinsics.yml"),
                                             str(cdir / "extrinsics.yml")),
                     img_size, calib_size=calib_size, device="cpu")
    rect = ref_calib.rectification(ref_calib.load_calibration(cdir), img_size, calib_size)
    assert rect["crop"] == port.crop
    for key in ("R1", "R2", "P1", "P2", "Q"):
        np.testing.assert_array_equal(rect[key], getattr(port.rect, key))
    np.testing.assert_array_equal(rect["maps"][0], port.map_l.numpy())
    np.testing.assert_array_equal(rect["maps"][1], port.map_r.numpy())
    rng = np.random.default_rng(5)
    raw = [rng.integers(0, 256, (img_size[1], img_size[0], 3), dtype=np.uint8) for _ in range(2)]
    got = [ref_calib.remap_crop(torch.from_numpy(r), m, rect["crop"])
           for r, m in zip(raw, rect["maps"])]
    want = port(*raw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_the_shipped_calibration_is_the_repositorys():
    cdir = ROOT / config("gif_zedvga_cal")["calib_dir"]
    for f in ("intrinsics.yml", "extrinsics.yml"):
        assert (cdir / f).read_bytes() == (ROOT / "data" / f).read_bytes()


@pytest.mark.parametrize("name", CONFIGS)
def test_bf16_control_reads_otherwise(name):
    """The control, the reference in bfloat16, differs from float32 in far
    more values than the configuration's limit allows."""
    cfg = config(name)
    gif = dict(cfg["gif"], max_dis=min(cfg["gif"]["max_dis"], 64))
    left, right = layered_pair(64, 256, gif["max_dis"], seed=3)
    f32 = ref_gif.disparities(left, right, gif)
    bf16 = ref_gif.disparities(left, right, gif, torch.bfloat16)
    assert float((f32 != bf16).float().mean()) > cfg["correct"]["disp_mismatch"]
