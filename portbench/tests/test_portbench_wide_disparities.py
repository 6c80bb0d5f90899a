"""Disparities past 255: the reference hands back the smallest unsigned type
that holds [0, D - 1] (`reference.disparity_dtype`), uint8 up to D = 256 and
uint16 above, and `run.compare` judges values as integers whatever their
types. Up to D = 256 the reference's maps are the uint8 ones they were; at
D = 272 they are the oracle's (tests/oracle_sgbm.py) where a uint8 map would
wrap; a STEREO_SGBM configuration past 256 disparities is added as new files
and judged on the CPU."""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

import tests.oracle_sgbm as oracle
from portbench import reference, run
from portbench.reference import gif as ref_gif
from portbench.reference import sgbm as ref_sgbm
from portbench.tests.test_portbench_algorithms import untouched
from portbench.tests.test_portbench_reference import config
from portbench.tests.tiny import tiny_root
from portbench.traffic import scene

WIDE = 272                     # past 256: a multiple of 16, as OpenCV rounds ndisp
WIDE_SCENE = {"regions": 8, "disp_range": "257-270", "side_px": "12-48"}


def sgbm_block(D: int) -> dict:
    """`sgbm_zed2k`'s parameters at D disparities."""
    return dict(config("sgbm_zed2k")["sgbm"], num_disparities=D)


def pair(H: int, W: int, spec: dict, seed: int):
    (left, right), _ = scene.scene_pairs(H, W, 1, spec, seed, torch.device("cpu"))[0]
    return scene.to_u8(left), scene.to_u8(right)


@pytest.mark.parametrize("D, expected", [(1, torch.uint8), (256, torch.uint8),
                                         (257, torch.uint16), (2048, torch.uint16),
                                         (65536, torch.uint16)])
def test_the_disparity_type_is_the_smallest_that_holds_the_range(D, expected):
    assert reference.disparity_dtype(D) == expected


@pytest.mark.parametrize("D", [0, 65537])
def test_a_range_no_unsigned_type_holds_raises(D):
    with pytest.raises(ValueError, match=str(D)):
        reference.disparity_dtype(D)


@pytest.mark.parametrize("D, seed", [(16, 3), (256, 4)])
def test_sgbm_up_to_256_disparities_is_the_uint8_display_it_was(D, seed):
    """`sgbm_zed2k`'s block at D: uint8, equal to clamp(d16 // 16, 0, D - 1)
    as uint8, the cast the reference made before it took uint16."""
    H, W = 24, D + 64
    left, right = pair(H, W, {"regions": 6, "disp_range": f"2-{D - 4}",
                              "side_px": "8-20"}, seed)
    block = sgbm_block(D)
    got = ref_sgbm.disparities(left, right, block)
    d16 = ref_sgbm.disparity16(left, right, block).to(torch.int32)
    want = (d16 // 16).clamp(0, D - 1).to(torch.uint8)
    assert got.dtype == torch.uint8 and got.shape == (2, H, W)
    assert torch.equal(got[0], want) and not got[1].any()
    assert len(torch.unique(want)) > 3


@pytest.mark.parametrize("name", ["gif_zed2k", "gif_zedvga_cal"])
def test_gif_holds_its_disparities_in_uint8_and_refuses_more_than_256(name):
    gif = dict(config(name)["gif"], max_dis=16)
    left, right = pair(32, 96, {"regions": 4, "disp_range": "2-12", "side_px": "8-16"}, 5)
    assert ref_gif.disparities(left, right, gif).dtype == torch.uint8
    with pytest.raises(ValueError, match="257"):
        ref_gif.disparities(left, right, dict(gif, max_dis=257))


@pytest.fixture(scope="module")
def wide():
    """A 16x340 scene at disparities 257-270 and the reference's maps of it
    at D = 272, beside the oracle's disparities x 16."""
    left, right = pair(16, 340, WIDE_SCENE, 0)
    b = sgbm_block(WIDE)
    got = ref_sgbm.disparities(left, right, b)
    lf, rf = (oracle.sobel_xclip(v.numpy(), b["pre_filter_cap"]) for v in (left, right))
    C = oracle.block_cost(oracle.bt_cost(lf, rf, WIDE), b["block_size"])
    S = oracle.aggregate(C, b["p1"], b["p2"], ref_sgbm.MODE_DIRECTIONS[b["mode"]])
    d = oracle.select_disparity(S, b["uniqueness_ratio"], b["disp12_max_diff"],
                                b["min_disparity"])
    d16 = oracle.filter_speckles(d, b["speckle_window_size"], 16 * b["speckle_range"],
                                 (b["min_disparity"] - 1) * 16)
    return got, d16


def test_sgbm_past_256_disparities_is_the_oracles_in_uint16(wide):
    got, d16 = wide
    want = np.clip(np.maximum(d16.astype(np.int32), 0) // 16, 0, WIDE - 1)
    assert got.dtype == torch.uint16 and got.shape == (2, *d16.shape)
    np.testing.assert_array_equal(got[0].numpy().astype(np.int32), want)
    assert not got[1].numpy().any()
    # disparities past 255, several of them: a uint8 map would wrap these
    assert len(np.unique(want[want >= 256])) > 3


def test_compare_judges_values_whatever_their_type(wide):
    disp = wide[0].numpy()
    limits = {"disp_mismatch": 0.0}
    wrapped = disp.astype(np.uint8)
    past = float((disp >= 256).mean())
    assert past > 0.05
    assert run.compare(limits, {"disp": wrapped}, {"disp": disp}) == {"disp_mismatch": past}
    assert run.compare(limits, {"disp": disp.copy()}, {"disp": disp}) == {"disp_mismatch": 0.0}
    low = np.minimum(disp, 255)
    assert run.compare(limits, {"disp": low.astype(np.uint8)},
                       {"disp": low.astype(np.uint16)}) == {"disp_mismatch": 0.0}
    assert run.compare(limits, {"disp": disp[:, 1:]}, {"disp": disp}) == {"disp_mismatch": 1.0}


def add_wide_config(root):
    """Files only: `sgbm_zed2k` at D = 272 on 16x340 frames and its closed-loop
    cell of scenes at 257-270 px; BENCHMARK.json gains the cell."""
    cfg = dict(config("sgbm_zed2k"), name="tiny_sgbm_wide", sgbm=sgbm_block(WIDE))
    cfg["camera"] = dict(cfg["camera"], eye_size=[340, 16])
    (root / "portbench" / "configs" / "tiny_sgbm_wide.json").write_text(json.dumps(cfg))
    work = {"name": "tiny_sgbm_wide.max", "config": "tiny_sgbm_wide", "traffic": "max",
            "chips": 1, "loop": "closed", "pool": 2, "scene": WIDE_SCENE,
            "why": "a small cell past 256 disparities for the CPU tests"}
    (root / "portbench" / "workloads" / f"{work['name']}.json").write_text(json.dumps(work))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({k: work[k] for k in ("name", "config", "traffic", "chips", "why")})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_an_sgbm_configuration_past_256_disparities_is_added_as_files(tmp_path):
    """The configuration and its cell as new files: the harness loads the
    cell, makes its pool and judges it by the reference in uint16, with no
    file of the benchmark edited. The app side is not run: the port cannot
    build STEREO_SGBM past 256 disparities yet (its app makes a GIF
    configuration of the range, which holds at most 256)."""
    root = add_wide_config(tiny_root(tmp_path))
    untouched(root)
    cell = run.load_cell("tiny_sgbm_wide.max", root)
    dev = torch.device("cpu")
    pool = run.make_pool(cell, 2**31 + 29, dev)
    assert len(pool) == 2 and pool[0].shape == (2, 16, 340, 3)
    refs = run.reference_outputs(cell, pool, [0, 1], dev)
    for out in refs.values():
        assert out["crops"] is None
        assert out["disp"].dtype == np.uint16 and out["disp"].shape == (2, 16, 340)
        assert (out["disp"][0] >= 256).any() and out["disp"][0].max() < WIDE
    # the judge: the reference's own maps pass, their uint8 wrap does not
    left, right = scene.eyes(pool[1])

    def result(disp):
        return types.SimpleNamespace(l_disp=disp[0], r_disp=disp[1], left_bgr=left,
                                     right_bgr=right)

    disp = refs[1]["disp"]
    sound = run.judge(cell, pool, {0: result(disp)}, [1], dev)
    assert sound == {"worst": {"disp_mismatch": 0.0}, "wrong": 0}
    wrapped = run.judge(cell, pool, {0: result(disp.astype(np.uint8))}, [1], dev)
    assert wrapped["wrong"] == 1
    assert wrapped["worst"]["disp_mismatch"] == float((disp >= 256).mean())
