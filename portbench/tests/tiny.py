"""A copy of the benchmark with small cells of both configurations, for the
CPU tests: the harness finds them by name like any other cell."""

from __future__ import annotations

import json
import pathlib
import shutil

ROOT = pathlib.Path(__file__).resolve().parents[2]
# small frames of both configurations: the 2K one at D = 16, the calibrated
# ZED-VGA one at a sixteenth of its area (the calibration rescaled to it)
TINY = {
    "tiny_2k": ("gif_zed2k", {"eye_size": [96, 64], "max_dis": 16}),
    "tiny_vga": ("gif_zedvga_cal", {"eye_size": [168, 94], "max_dis": 16}),
}
SCENE = {"regions": 4, "disp_range": "2-12", "side_px": "8-30"}


def tiny_root(tmp: pathlib.Path, loops=(("max", {"loop": "closed"}),)) -> pathlib.Path:
    """A checkout in `tmp` holding BENCHMARK.json and portbench/ with the
    cells `<tiny config>.<loop>` added; every metric lists them."""
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = []
    for tiny, (base, over) in TINY.items():
        cfg = json.loads((ROOT / "portbench" / "configs" / f"{base}.json").read_text())
        cfg["name"] = tiny
        cfg["camera"]["eye_size"] = over["eye_size"]
        cfg["gif"]["max_dis"] = over["max_dis"]
        (tmp / "portbench" / "configs" / f"{tiny}.json").write_text(json.dumps(cfg))
        for loop, params in loops:
            name = f"{tiny}.{loop}"
            names.append(name)
            work = {"name": name, "config": tiny, "traffic": loop, "chips": 1, **params,
                    "pool": 3, "scene": SCENE, "why": "a small cell for the CPU tests"}
            (tmp / "portbench" / "workloads" / f"{name}.json").write_text(json.dumps(work))
            bench["workloads"].append({k: work[k] for k in
                                       ("name", "config", "traffic", "chips", "why")})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += names
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp
