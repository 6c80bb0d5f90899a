"""The STEREO_SGBM configuration's readers and bounds, and its cell's harness
path on the CPU: each reader of `sgbm_zed2k.max` on a hand-made window gives
the value worked out by hand, and None where its kernels, spans, counter or
frames are absent; `bounds_sgbm` equals `chip_smoke.py` at the 2K and Teddy
shapes; a small SGBM cell runs correct against the real plain reference."""

from __future__ import annotations

import json
import sys

import pytest
import torch

from portbench import bounds_sgbm, run, trace
from portbench.tests.test_portbench_algorithms import CELL, add_config, one_run
from portbench.tests.tiny import ROOT, tiny_root

SGBM_METRICS = ("k6_roofline_pct", "k7_roofline_pct", "k8_roofline_pct", "k9_roofline_pct",
                "speckle_sweeps_per_frame", "sgbm_dispatch_ms", "compute_host_ms")
# (H, W, D): the 2K frame and Middlebury Teddy
SHAPES = [(1242, 2208, 256), (375, 450, 64)]


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.mark.parametrize("H, W, D", SHAPES)
def test_bounds_equal_chip_smokes(smoke, H, W, D):
    lf = torch.empty(H, W, 3, dtype=torch.int32)
    cost = torch.empty(H, W, D, dtype=torch.int16)
    labels = torch.empty(H, W, dtype=torch.int32)
    assert bounds_sgbm.frame_k6_ms(H, W, D, 5) == smoke.bound_bt_cost(lf, cost)[0]
    assert bounds_sgbm.frame_k7_ms(H, W, D, 5, "hh") == smoke.bound_scan(cost, 8)[0]
    assert bounds_sgbm.frame_k7_ms(H, W, D, 5, "sgbm") == smoke.bound_scan(cost, 5)[0]
    assert bounds_sgbm.frame_k8_ms(H, W, D) == smoke.bound_select((H, W, D))[0]
    assert bounds_sgbm.sweep_ms(H, W) == smoke.bound_sweep(labels)[0]
    assert bounds_sgbm.INT32_OPS_PER_S == smoke.INT32_OPS_PER_S
    # the window cost is int32 where the block's bound passes int16's range
    wide = torch.empty(H, W, D, dtype=torch.int32)
    assert bounds_sgbm.frame_k7_ms(H, W, D, 11, "3way") == smoke.bound_scan(wide, 3)[0]


def _window(frames=2, device=(), program=(), counts=None, config=None):
    H, W, D = 12, 20, 16
    return trace.Window(frames=frames, window_s=1e-3, lo_us=0.0, hi_us=1000.0,
                        device=list(device), host=[], geometry={"H": H, "W": W, "D": D},
                        port_kernels=(), k3_outputs=[], source_blocked_ms=[],
                        config=config or {"algorithm": "STEREO_SGBM",
                                          "sgbm": {"block_size": 5, "mode": "hh"}},
                        program=list(program), counts=counts)


# two frames of an SGBM window: each kernel's device rows (us), the program's
# spans (us) and the counter's change
DEVICE = [("void bt_cost_kernel<short, 32>(int const*)", 0.0, 30.0),
          ("void sgm_scan_kernel<short, unsigned short, 8>(short const*)", 30.0, 130.0),
          ("void sgm_scan_kernel<short, unsigned short, 8>(short const*)", 130.0, 150.0),
          ("void select_kernel<2, 8, 8, 32>(void const*)", 150.0, 160.0),
          ("speckle_rows_kernel(int const*)", 160.0, 161.0),
          ("speckle_cols_kernel(int const*)", 161.0, 163.0),
          ("Memcpy HtoD (Pageable -> Device)", 200.0, 240.0)] * 2
PROGRAM = [("psm.stream.read", 0.0, 1.0), ("psm.compute.upload", 1.0, 4.0),
           ("psm.sgbm.forward", 4.0, 24.0), ("psm.sgbm.cost", 5.0, 6.0),
           ("psm.compute.fetch", 24.0, 26.0),
           ("psm.stream.read", 30.0, 31.0), ("psm.compute.upload", 31.0, 33.0),
           ("psm.sgbm.forward", 33.0, 63.0), ("psm.sgbm.speckle", 40.0, 60.0),
           ("psm.compute.fetch", 63.0, 66.0)]
COUNTS = {"frames": 0, "ready_at_wait": 0, "speckle_sweeps": 10}


def test_the_sgbm_readers_read_a_hand_made_window():
    H, W, D = 12, 20, 16
    w = _window(device=DEVICE, program=PROGRAM, counts=COUNTS)
    k6 = bounds_sgbm.frame_k6_ms(H, W, D, 5)
    k7 = bounds_sgbm.frame_k7_ms(H, W, D, 5, "hh")
    k8 = bounds_sgbm.frame_k8_ms(H, W, D)
    want = {"k6_roofline_pct": 100 * k6 * 2 / (2 * 30e-3),
            "k7_roofline_pct": 100 * k7 * 2 / (2 * 120e-3),
            "k8_roofline_pct": 100 * k8 * 2 / (2 * 10e-3),
            "k9_roofline_pct": 100 * bounds_sgbm.sweep_ms(H, W) * 10 / (2 * 3e-3),
            "speckle_sweeps_per_frame": 5.0,
            "sgbm_dispatch_ms": (20 + 30) / 2e3,
            "compute_host_ms": (3 + 2 + 2 + 3) / 2e3}
    for name in SGBM_METRICS:
        assert run.load_metric(name).read(w) == pytest.approx(want[name]), name


@pytest.mark.parametrize("missing", ["kernels", "spans", "counter", "frames", "gif"])
def test_the_sgbm_readers_read_none_without_their_rows(missing):
    """A reader reads None where what it reads is absent: the program of a
    parent commit without the spans or the counter, a window with no frame,
    a GIF window."""
    kw = {"device": DEVICE, "program": PROGRAM, "counts": COUNTS}
    if missing == "kernels":
        kw["device"] = [r for r in DEVICE if r[0].startswith("Memcpy")]
        gone = SGBM_METRICS[:4]
    elif missing == "spans":
        kw["program"] = []
        gone = ("sgbm_dispatch_ms", "compute_host_ms")
    elif missing == "counter":
        kw["counts"] = {"frames": 0, "ready_at_wait": 0}
        gone = ("k9_roofline_pct", "speckle_sweeps_per_frame")
    elif missing == "frames":
        kw["frames"] = 0
        gone = tuple(n for n in SGBM_METRICS if n != "k9_roofline_pct")
    else:
        kw = {"counts": {"frames": 2, "ready_at_wait": 2, "speckle_sweeps": 0},
              "config": run.load_cell("gif_zed2k.max")["config"]}
        gone = SGBM_METRICS
    w = _window(**kw)
    for name in SGBM_METRICS:
        value = run.load_metric(name).read(w)
        assert (value is None) == (name in gone), name


def test_the_cell_reports_the_sgbm_metrics_and_fps():
    cell = run.load_cell("sgbm_zed2k.max")
    assert cell["config"]["algorithm"] == "STEREO_SGBM"
    assert [m["name"] for m in cell["per_layer"]] == list(SGBM_METRICS)
    assert {m["name"] for m in cell["end_to_end"]} == {"fps", "frame_p50_ms", "setup_s"}
    assert cell["workload"]["scene"] == run.load_cell("gif_zed2k.max")["workload"]["scene"]


@pytest.fixture(scope="module")
def real_root(tmp_path_factory):
    """The small SGBM cell judged by the real reference/sgbm.py (add_config
    writes no stand-in), its per-layer metrics the SGBM configuration's."""
    root = add_config(tiny_root(tmp_path_factory.mktemp("sgbm_real")), reference=None)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in SGBM_METRICS:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("trace_on", [False, True], ids=["untraced", "traced"])
def test_a_small_sgbm_cell_runs_correct_against_the_plain_reference(real_root, trace_on):
    assert (real_root / "portbench" / "reference" / "sgbm.py").read_bytes() == (
        ROOT / "portbench" / "reference" / "sgbm.py").read_bytes()
    out = one_run(real_root, trace_on)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert all(c["value"] == 0 for c in out["checks"].values())
    if trace_on:
        # the CPU has no device rows: the rooflines read nothing there
        got = out["metrics"]
        assert {"speckle_sweeps_per_frame", "sgbm_dispatch_ms", "compute_host_ms"} <= set(got)
        assert not set(SGBM_METRICS[:4]) & set(got)
        assert got["speckle_sweeps_per_frame"]["value"] >= 2
        assert got["sgbm_dispatch_ms"]["value"] > 0 and got["compute_host_ms"]["value"] > 0
