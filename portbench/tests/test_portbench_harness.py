"""The harness: cells, configurations and metrics found by name, the rules
BENCHMARK.json keeps, what the measuring process loads, and no run without
a card. Cards are decided inside tests, never at import."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import run, trace
from portbench.tests.tiny import ROOT, tiny_root

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def python(*args, cwd=ROOT, env=None, timeout=300):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env={**os.environ, **(env or {})})


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_and_its_configuration_are_found_by_name(name):
    cell = run.load_cell(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert {k: cell["workload"][k] for k in entry} == entry
    cfg = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert cfg["file"] == f"portbench/configs/{entry['config']}.json"
    assert cell["config"]["name"] == cfg["name"] and cell["config"]["source"] == cfg["source"]
    assert cell["config"]["reduced"] == cfg["reduced"]
    assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
    assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_has_its_reader(name):
    assert callable(run.load_metric(name).read)


def test_a_cell_a_configuration_and_a_metric_added_as_files_are_picked_up(tmp_path):
    root = tiny_root(tmp_path)
    (root / "portbench" / "metrics" / "frames_traced.py").write_text(
        "def read(w):\n    return float(w.frames)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                               "source": "device_trace", "layer": "app layer", "moves": "fps",
                               "workloads": ["tiny_2k.max"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = run.load_cell("tiny_2k.max", root)
    assert cell["config"]["name"] == "tiny_2k"
    assert "frames_traced" in [m["name"] for m in cell["per_layer"]]
    out = run.run_cell("tiny_2k.max", 3, 0.5, True, device="cpu", root=root,
                       log=lambda *a, **k: None)
    assert out["metrics"]["frames_traced"]["value"] == out["attempted"] > 0


def test_benchmark_json_keeps_the_rules():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        names.append(c["name"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
        # every cell that reports it reports what it moves
        for cell in m.get("workloads", CELLS):
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    for w in BENCH["workloads"]:
        assert w["config"] in names and w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        names.append(w["name"])
        names.append(w["traffic"])
    names += list(e2e) + METRICS
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)
    # a full check of 24 cells fits in 43200 seconds: 14 runs a cell, each
    # run_seconds + 60, 180 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_the_port_kernel_names_are_read_from_its_sources():
    names = trace.port_kernel_names(ROOT / "primestereomatch_torch")
    for n in ("cvc_lowmaps_kernel", "lowmaps_kernel", "upsample_wta_staged_kernel",
              "joint_wmf_kernel", "wmf_weights_kernel"):
        assert n in names
    pat = trace.kernel_pattern(["lowmaps_kernel"])
    assert pat.search("void lowmaps_kernel<5>(float const*)")
    assert not pat.search("void cvc_lowmaps_kernel<5>(float const*)")


def test_union_and_idle_gaps():
    import numpy as np

    iv = np.array([[0.0, 2.0], [1.0, 3.0], [5.0, 6.0], [5.5, 5.7]])
    assert trace.union_us(iv) == 4.0
    assert trace.idle_gaps(iv, -1.0, 8.0).tolist() == [[-1.0, 0.0], [3.0, 5.0], [6.0, 8.0]]


CHECK_IMPORTS = """
import sys
from portbench import run, trace, bounds, readings
from portbench.traffic import scene, sources
from portbench.reference import gif, calib
for name in {metrics!r}:
    run.load_metric(name)
import primestereomatch_torch.app
print(" ".join(sorted({{m.partition(".")[0] for m in sys.modules}})))
"""


def test_nothing_the_benchmark_loads_is_jax_or_the_jax_package():
    out = python("-c", CHECK_IMPORTS.format(metrics=METRICS))
    assert out.returncode == 0, out.stderr
    top = set(out.stdout.split())
    assert "primestereomatch_torch" in top and "portbench" in top
    assert not top & {"jax", "jaxlib", "flax", "primestereomatch_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    modules = sorted(f"portbench.reference.{p.stem}"
                     for p in (ROOT / "portbench" / "reference").glob("*.py")
                     if p.stem != "__init__")
    assert "portbench.reference.gif" in modules
    out = python("-c", f"import sys, portbench.bounds; import {', '.join(modules)}; "
                       "print(' '.join(sorted({m.partition('.')[0] for m in sys.modules})))")
    assert out.returncode == 0, out.stderr
    assert not set(out.stdout.split()) & {"primestereomatch_torch", "primestereomatch_tpu",
                                          "jax", "jaxlib"}


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = python("-m", "portbench", "--workload", CELLS[0], "--seed", "2147483659",
                 "--seconds", "1", "--trace", "0", env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_a_run_with_only_the_benchmarks_files_exits_nonzero(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {"PYTHONPATH": "", "PYTHONSAFEPATH": ""}
    out = python("-m", "portbench", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                 "--trace", "0", cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_a_run_keeps_its_bytecode_inside_its_checkout(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {"PYTHONPATH": "", "PYTHONSAFEPATH": "", "PYTHONDONTWRITEBYTECODE": "1"}
    python("-m", "portbench", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
           "--trace", "0", cwd=tmp_path, env=env)
    cached = list((tmp_path / "build" / "pycache").rglob("*.pyc"))
    assert any("numpy" in p.parts for p in cached)
    assert any(p.name.startswith("run.") and "portbench" in p.parts for p in cached)
    assert not list((tmp_path / "portbench").rglob("*.pyc"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_runs_correct_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = python("-m", "portbench", "--workload", name, "--seed", "2147483701",
                 "--seconds", "2", "--trace", "0", timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
