#!/usr/bin/env python3
"""Time the SGM scan kernel's two designs (K7, csrc/sgbm_scan.cu) on one NVIDIA card.

    python3 tune_scan.py [rule] [OLDER_SGBM_SCAN_CU]

The table: Teddy 375x450, the calibrated ZED-VGA crop 274x530, the HD720
crop 526x1016 and 2K 2208x1242, each at D = 64 and 256; `rule`: widths
1280, 1600, 1920 and 2208 (720, 900, 1080 and 1242 rows) at D = 136, 160,
192, 224 and 256, where the sweeps' rule (`sgbm_scan.takes_sweeps`) draws
its line. On random int16 costs up to SGBMConfig's cost bound with its P1
and P2, MODE_HH: prints the route `sgbm_aggregate_partials` takes and the
sweeps' plan (strips, their width, warps a block, columns a warp, blocks
an SM and whether the card holds every block of the cooperative launch),
holds each design's two uint16 partials to the plain S through their sum
(in the table also each to its plain group; in `rule` to the path
families' int32 S, itself held to the plain S by the tests), and prints
CUDA-event times, in turns (each design once in order, then once in the
reverse order), beside the bound (chip_smoke.bound_scan) and the bytes
moved per (pixel, d); in the table the int32 S (the path families' kernel)
too. Beside the shipped sweeps: the same source with other warps a block
and columns a warp (SWEEP_WARPS, SWEEP_COLS; `SWEEP_SHAPES` below) and,
with OLDER_SGBM_SCAN_CU (another copy of csrc/sgbm_scan.cu with the same
C entries, such as an earlier commit's), that build's sweeps. Prints the
build's time and each build's ptxas use first.

Needs one CUDA card and nvcc, like chip_smoke.py; writes only the sources
of the other shapes, under build/tune_scan/.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from primestereomatch_torch import kernels as K
from primestereomatch_torch.kernels import _build, sgbm_scan

TABLE = [(name, H, W, D) for name, (H, W) in {
    "teddy": (375, 450), "zedvga": (274, 530), "hd720": (526, 1016), "2k": (1242, 2208)}.items()
         for D in (64, 256)]
RULE = [(f"{W}", H, W, D) for H, W in ((720, 1280), (900, 1600), (1080, 1920), (1242, 2208))
        for D in (136, 160, 192, 224, 256)]
COST_BOUND, P1, P2, ND = 9450, 600, 2400, 8
# (SWEEP_WARPS, SWEEP_COLS) of the other sweeps builds: at 2K 17 warps of 2
# columns and 9 of 4 against the shipped 12 of 3 (18 x 2, like 12 x 3, takes
# strips of 36 columns: W = 2376)
SWEEP_SHAPES = ((18, 2), (12, 4))


def ptxas_use(log: str) -> list[str]:
    """Registers, spills and stack of each instance of the kernel."""
    lines = log.splitlines()
    out = []
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and "sgm_scan_kernel" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
            used = next((x.split(":", 1)[-1].strip() for x in lines[i:i + 6] if "Used" in x), "")
            spill = next((x.strip() for x in lines[i:i + 6] if "spill" in x), "")
            out.append(f"{name}: {used}; {spill}")
    return out


def shape_source(warps: int, cols: int) -> pathlib.Path:
    """csrc/sgbm_scan.cu with SWEEP_WARPS and SWEEP_COLS set, under build/."""
    text = (_build.CSRC / "sgbm_scan.cu").read_text()
    for name, value in (("SWEEP_WARPS", warps), ("SWEEP_COLS", cols)):
        line = next(ln for ln in text.splitlines() if ln.startswith(f"constexpr int {name} = "))
        text = text.replace(line, f"constexpr int {name} = {value};")
    path = _build.build_dir().parent / "tune_scan" / f"sgbm_scan_w{warps}c{cols}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


class Sweeps:
    """The sweeps' entry and plan of one build of a sgbm_scan.cu, with edge
    slots of its own (as `sgbm_scan._sweeps`, which runs the shipped one)."""

    def __init__(self, tag: str, source: pathlib.Path):
        self.tag = tag
        self.fn = _build.build_variants("sgbm_sweep", {tag: []}, str(source))[tag]
        self.plan_fn = _build.build_variants("sgbm_sweep_plan", {tag: []}, str(source))[tag]
        self.log = _build.BUILD_LOGS.get(f"sgbm_sweep {tag}", "")
        self.slots, self.seq = None, 0

    def plan(self, cost: torch.Tensor) -> sgbm_scan.Plan | None:
        out = (ctypes.c_longlong * len(sgbm_scan.Plan._fields))()
        rc = self.plan_fn(cost.shape[1], cost.shape[2], out)
        if rc == sgbm_scan._REFUSED:
            return None
        _build.check(f"sgbm_sweep_plan {self.tag}", rc)
        return sgbm_scan.Plan(*out)

    def __call__(self, cost, p1, p2, nd, parts) -> None:
        H, W, D = cost.shape
        pl = self.plan(cost)
        if self.slots is None or self.slots.numel() < pl.edge_bytes:
            self.slots = torch.zeros(pl.edge_bytes, dtype=torch.uint8, device=cost.device)
        top, bottom = sgbm_scan._SWEEP_BITS[nd]
        rc = self.fn(cost.data_ptr(), parts[0].data_ptr(), top, parts[1].data_ptr(), bottom,
                     H, W, D, p1, p2, (ctypes.c_longlong * len(pl))(*pl),
                     self.slots.data_ptr(), self.seq,
                     torch.cuda.current_stream(cost.device).cuda_stream)
        _build.check(f"sgbm_sweep {self.tag}", rc)
        self.seq += H + 1


def main() -> int:
    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("tune_scan: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    args = sys.argv[1:]
    rule = args[:1] == ["rule"]
    older = args[1:2] if rule else args[:1]
    sources = {f"sweeps {w}x{c}": shape_source(w, c) for w, c in SWEEP_SHAPES}
    if older:
        sources["older sweeps"] = pathlib.Path(older[0])
    print(f"build: {_build.build(('sgbm_scan',)):.1f} s", flush=True)
    for line in ptxas_use(_build.BUILD_LOGS.get("sgbm_scan", "")):
        print(f"  ptxas {line}", flush=True)
    with ThreadPoolExecutor(len(sources)) as pool:
        others = list(pool.map(lambda kv: Sweeps(*kv), sources.items()))
    for other in others:
        for line in ptxas_use(other.log):
            print(f"  ptxas ({other.tag}) {line}", flush=True)
    rng = np.random.default_rng(23)
    for name, H, W, D in RULE if rule else TABLE:
        cost = torch.as_tensor(rng.integers(0, COST_BOUND + 1, (H, W, D), dtype=np.int16),
                               device=dev)
        bound_ms, bound_by = cs.bound_scan(cost, ND)
        route = sgbm_scan.route(cost, ND, COST_BOUND, P1, P2)
        fits = sgbm_scan.SWEEPS_MIN_D <= D <= sgbm_scan.SWEEPS_MAX_D
        pl = sgbm_scan.plan(cost) if fits else None
        text = (f"plan {pl._asdict()}, the card holds all {2 * pl.strips} blocks: "
                f"{pl.blocks_per_sm * pl.sms >= 2 * pl.strips}" if pl is not None else
                "the card cannot hold both sweeps' blocks" if fits else "no sweeps at this D")
        print(f"{name} (H,W,D)=({H},{W},{D}): route {route} (W * (D - 64) = {W * (D - 64)}); "
              f"{text}", flush=True)
        S = (K.sgbm_aggregate if rule else K.sgbm_aggregate_plain)(cost, P1, P2, ND)
        designs = {"paths": sgbm_scan._paths}
        if pl is not None:
            designs["sweeps"] = sgbm_scan._sweeps
        for other in others if fits else ():
            opl = other.plan(cost)
            print(f"  {other.tag}: plan {opl._asdict() if opl else 'refused'}", flush=True)
            if opl is not None:
                designs[other.tag] = other
        runs = {}
        for tag, fn in designs.items():
            out = tuple(torch.empty(cost.shape, dtype=torch.uint16, device=dev) for _ in range(2))
            fn(cost, P1, P2, ND, out)
            n_diff = [int((sum(q.int() for q in out) != S).sum())]
            if not rule:
                plain = sgbm_scan.sum_groups_plain(cost, P1, P2, sgbm_scan.partial_groups(
                    ND, COST_BOUND, P2, cost.dtype, "paths" if tag == "paths" else "sweeps"))
                n_diff += [int((a != b).sum()) for a, b in zip(out, plain)]
                del plain
            if any(n_diff):
                raise AssertionError(f"{tag} differs at {name} D={D}: {n_diff}")
            runs[tag] = lambda fn=fn, out=out: fn(cost, P1, P2, ND, out)
        if not rule:
            if not torch.equal(K.sgbm_aggregate(cost, P1, P2, ND), S):
                raise AssertionError(f"the int32 S differs from the plain S at {name} D={D}")
            runs["int32 S"] = lambda: K.sgbm_aggregate(cost, P1, P2, ND)
        del S
        order = list(runs) + list(runs)[::-1]
        times = {tag: [] for tag in runs}
        for tag in order:
            times[tag].append(cs.cuda_ms(runs[tag], iters=20, warmup=3))
        for tag, ms in times.items():
            bpv = sgbm_scan.bytes_per_value(
                ND, 2, "int32" if tag == "int32 S" else "paths" if tag == "paths" else "sweeps")
            print(f"  {tag}: {' / '.join(f'{m:.4f}' for m in ms)} ms, bound "
                  f"{bound_ms:.5f} ms ({bound_by}), {bound_ms / min(ms):.1%} of bound, "
                  f"{bpv} B per (pixel, d), {cost.numel() * bpv / min(ms) / 1e9:.3f} TB/s",
                  flush=True)
        del cost, runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
