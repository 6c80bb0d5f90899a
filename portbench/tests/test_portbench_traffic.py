"""The traffic: seeded scenes, the cells' pools, and the two sources."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from portbench import run
from portbench.traffic import scene, sources
from portbench.tests.tiny import ROOT, tiny_root

CPU = torch.device("cpu")
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("name", ["tiny_2k.max", "tiny_vga.max"])
def test_a_seed_reproduces_its_frames(tiny, name):
    cell = run.load_cell(name, tiny)
    a, b = (run.make_pool(cell, 2**31 + 7, CPU) for _ in range(2))
    c = run.make_pool(cell, 2**31 + 8, CPU)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))
    assert all(x.dtype == np.uint8 for x in a)


@pytest.mark.parametrize("name", CELLS)
def test_pool_and_scene_come_from_the_cells_file(name):
    cell = run.load_cell(name)
    work, cfg = cell["workload"], cell["config"]
    assert work["name"] == name and work["chips"] == 1
    # a pool of the file's size at a small frame of the configuration's kind
    small = dict(cfg, camera=dict(cfg["camera"], eye_size=[64, 40]))
    spec = dict(work, pool=2)
    rect = run.rectification(cell)
    calib = None
    if rect is not None:
        from portbench.reference import calib as ref_calib

        calib = ref_calib.load_calibration(ROOT / cfg["calib_dir"])
        rect = ref_calib.rectification(calib, (64, 40), cfg["calib_size"])
    pool = scene.make_pool(small, spec, 5, CPU, rect, calib)
    assert len(pool) == 2
    want = (40, 128, 3) if cfg["camera"]["side_by_side"] else (2, 40, 64, 3)
    assert pool[0].shape == want


@pytest.mark.parametrize("name", CELLS)
def test_every_seed_gets_the_same_disparities_and_sides(name):
    work = run.load_cell(name)["workload"]
    sc = work["scene"]
    n = work["pool"] * sc["regions"]
    lo, hi = scene._span(sc["disp_range"])
    draws = []
    for seed in (1, 2**33 + 1):
        g = scene.generator(seed, CPU)
        draws.append(scene._spread(lo, hi, n, g, CPU))
    assert not torch.equal(draws[0], draws[1])
    want = np.rint(np.linspace(lo, hi, n)).astype(np.int64)
    assert all(np.array_equal(np.sort(d.numpy()), want) for d in draws)


def test_layers_paint_back_to_front():
    (_, _), d = scene.scene_pairs(40, 60, 1, {"regions": 5, "disp_range": "3-30",
                                              "side_px": "20-40"}, 9, CPU)[0]
    assert int(d.min()) == 3 and int(d.max()) <= 30
    assert int(d.max()) == 30          # the nearest layer is painted last


def test_the_right_view_is_the_left_one_shifted():
    (left, right), d = scene.scene_pairs(30, 80, 1, {"regions": 3, "disp_range": "4-20",
                                                     "side_px": "10-20"}, 4, CPU)[0]
    y, x = np.nonzero((np.arange(80)[None, :] + d.numpy()) < 80)
    src = x + d.numpy()[y, x]
    assert torch.equal(right[y, x], left[y, src])


def test_the_paced_source_hands_frames_at_their_due_times():
    pool = [np.zeros((2, 4, 4, 3), np.uint8) for _ in range(3)]
    rate = 200.0
    t0 = time.perf_counter() + 0.02
    src = sources.PacedSource(pool, t0, t0 + 0.1, rate)
    frames = list(src)
    assert len(frames) == 20 and src.index == [k % 3 for k in range(20)]
    assert src.due == [t0 + k / rate for k in range(20)]
    assert all(h >= d for h, d in zip(src.handed, src.due))
    # every call before its due time blocked until then, and says so
    assert len(src.blocked) >= 10
    for s, e in src.blocked:
        assert e >= s and any(abs(e - d) < 0.05 and e >= d for d in src.due)


def test_the_closed_source_hands_frames_until_its_window_ends():
    pool = [np.full((4, 8, 3), i, np.uint8) for i in range(2)]
    src = sources.ClosedSource(pool, t_end=time.perf_counter() + 0.05)
    n = 0
    for left, right in src:
        assert left.shape == right.shape == (4, 4, 3)
        n += 1
    assert n == len(src.index) > 100 and src.blocked == []
    assert src.due == src.handed
    assert len(list(sources.ClosedSource(pool, limit=3))) == 3


def test_blocked_time_is_counted_inside_each_frames_latency():
    src = sources.PacedSource([None], 0.0, 1.0, 10.0)
    src.due = [0.0, 0.1, 0.2]
    src.blocked = [(0.02, 0.1), (0.13, 0.2)]
    got = run.blocked_ms(src, [0.105, 0.21, 0.25])
    assert np.allclose(got, [80.0, 70.0, 0.0])
