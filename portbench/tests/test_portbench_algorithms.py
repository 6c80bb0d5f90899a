"""A configuration's `algorithm` decides what the harness builds, judges and
traces: a STEREO_SGBM configuration, its cell and a metric reader, added as
files to a copy of the benchmark, run through the same harness on the CPU
(small frames), judged by the reference module its name gives (the copy's
own `reference/sgbm.py`, or one a test writes in its place)."""

from __future__ import annotations

import dataclasses
import json
import re

import pytest

from portbench import run
from portbench.tests.tiny import ROOT, tiny_root

CELL = "tiny_sgbm_vga.max"
ZEROS = '''
import torch


def disparities(left_u8, right_u8, block, dtype=torch.float32):
    return torch.zeros((2, *left_u8.shape[:2]), dtype=torch.uint8, device=left_u8.device)
'''
# reads the configuration and the program's Rectifier rows: one a frame
READER = '''
def read(w):
    if "sgbm" not in w.config or not w.frames:
        return None
    return len([r for r in w.program if r[0] == "psm.rectify"]) / w.frames
'''


def sgbm_block(**over) -> dict:
    from primestereomatch_torch.config import SGBMConfig

    return {**dataclasses.asdict(SGBMConfig(num_disparities=16)), **over}


def add_config(root, algorithm="STEREO_SGBM", key="sgbm", block=None, reference=None):
    """Files only: a configuration of `algorithm` on the calibrated tiny
    frames, its closed-loop cell, a reference module written over the copy's
    `reference/<key>.py` (None: the copy's own, where it has one) and a
    metric reader; BENCHMARK.json gains the cell and the metric."""
    base = json.loads((root / "portbench" / "configs" / "tiny_vga.json").read_text())
    cfg = {k: v for k, v in base.items() if k != "gif"}
    cfg.update(name="tiny_sgbm_vga", algorithm=algorithm, **{key: block or sgbm_block()})
    (root / "portbench" / "configs" / "tiny_sgbm_vga.json").write_text(json.dumps(cfg))
    work = json.loads((root / "portbench" / "workloads" / "tiny_vga.max.json").read_text())
    work.update(name=CELL, config="tiny_sgbm_vga")
    (root / "portbench" / "workloads" / f"{CELL}.json").write_text(json.dumps(work))
    if reference is not None:
        (root / "portbench" / "reference" / f"{key}.py").write_text(reference)
    (root / "portbench" / "metrics" / "rectify_rows_per_frame.py").write_text(READER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({k: work[k] for k in ("name", "config", "traffic", "chips", "why")})
    for m in bench["end_to_end"]:   # the cell reports every end-to-end metric
        if "workloads" in m:
            m["workloads"].append(CELL)
    bench["per_layer"].append({"name": "rectify_rows_per_frame", "unit": "rows", "better": "lower",
                               "source": "program_span", "layer": "Rectifier",
                               "moves": "frame_p50_ms", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def one_run(root, trace, logged=None):
    def log(*args, **kw):
        if logged is not None:
            logged.append(" ".join(map(str, args)))
    return run.run_cell(CELL, 2**31 + 23, 0.6, trace, device="cpu", root=root, log=log)


@pytest.fixture(scope="module")
def sgbm_root(tmp_path_factory):
    return add_config(tiny_root(tmp_path_factory.mktemp("sgbm")), reference=None)


def untouched(root):
    """Every file of the benchmark's `portbench/` is in `root`, byte for byte."""
    for path in (ROOT / "portbench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            copy = root / path.relative_to(ROOT)
            assert copy.read_bytes() == path.read_bytes(), path


def test_the_configuration_is_added_without_editing_a_file(sgbm_root):
    untouched(sgbm_root)


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_an_sgbm_cell_added_as_files_runs_correct(sgbm_root, trace):
    logged = []
    out = one_run(sgbm_root, trace, logged)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert "app config SGBMConfig(" in "\n".join(logged)
    if trace:
        assert out["metrics"] == {"rectify_rows_per_frame": {"value": 1.0, "unit": "rows"}}
    else:
        assert {"frame_p50_ms", "frame_p95_ms", "setup_s", "fps"} <= set(out["metrics"])


def test_the_named_reference_module_judges_the_frames(tmp_path):
    """A reference of the same name that reads zeros everywhere: the same
    app's frames are not correct."""
    root = add_config(tiny_root(tmp_path), reference=ZEROS)
    out = one_run(root, False)
    assert not out["correct"] and out["failed"] > 0
    assert out["checks"]["disp_mismatch"]["value"] > out["checks"]["disp_mismatch"]["limit"]


def test_an_algorithm_without_a_reference_fails_before_the_pool(tmp_path, monkeypatch):
    root = add_config(tiny_root(tmp_path), algorithm="STEREO_BM", key="bm", reference=None)

    def no_pool(*args, **kw):
        raise AssertionError("the pool was made")

    monkeypatch.setattr(run, "make_pool", no_pool)
    missing = re.escape(str(root / "portbench" / "reference" / "bm.py"))
    with pytest.raises(FileNotFoundError, match=missing):
        run.load_cell(CELL, root)
    with pytest.raises(FileNotFoundError, match=missing):
        one_run(root, False)


def test_a_configuration_without_its_algorithms_block_fails(tmp_path):
    root = add_config(tiny_root(tmp_path), key="gif_params")
    with pytest.raises(KeyError, match="'sgbm'"):
        run.load_cell(CELL, root)


@pytest.mark.parametrize("over", [{"mode": "sgbm"}, {"uniqueness_ratio": 5}, {"p2": 0},
                                  {"window": 3}], ids=["mode", "uniqueness", "p2", "unknown"])
def test_an_sgbm_block_the_app_would_not_run_raises(tmp_path, over):
    root = add_config(tiny_root(tmp_path), block=sgbm_block(**over))
    cell = run.load_cell(CELL, root)
    with pytest.raises(RuntimeError, match=f"sgbm_cfg runs .*'{next(iter(over))}'"):
        run.build_app(cell, "cpu")


def test_the_app_runs_the_sgbm_block_it_was_built_from(sgbm_root):
    app = run.build_app(run.load_cell(CELL, sgbm_root), "cpu")
    assert app.cfg.alg == "STEREO_SGBM" and app.cfg.max_dis == 16
    assert dataclasses.asdict(app.sgbm_cfg) == sgbm_block()
