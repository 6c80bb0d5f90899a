"""The readings that the limits of `correct` are set from, on one card.

    python -m portbench.readings --workload <cell> --seeds 1,2,3 --seconds 3 \
        [--control-seeds 1,2,3] [--out build/readings.json]

For each seed of `--seeds`, one run of the cell as the benchmark makes it
(a short window), in this one process: the program's numbers, the lower
readings. For each seed of `--control-seeds`, the controls, each compared
with the float32 reference by the same numbers on that seed's pool, the
upper readings:
  * `bf16`: the reference itself computed in bfloat16, the precision below
    the configuration's float32, put in the program's place;
  * `u8_cost`: the program with its own lower-precision path switched on
    (`GIFConfig(cvc_dtype="u8")`, the uint8 cost), through the same window.
One JSON line per reading on standard output, and all of them in `--out`.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from portbench import run


def control_bf16(name: str, seed: int, dev) -> dict:
    import torch

    cell = run.load_cell(name)
    limits = cell["config"]["correct"]
    pool = run.make_pool(cell, seed, dev)
    wanted = range(min(3, len(pool)))
    f32 = run.reference_outputs(cell, pool, wanted, dev)
    bf16 = run.reference_outputs(cell, pool, wanted, dev, torch.bfloat16)
    worst = {k: 0.0 for k in limits}
    for i in wanted:
        shares = run.compare(limits, bf16[i], f32[i])
        worst = {k: max(worst[k], shares[k]) for k in limits}
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("portbench.readings: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in seeds:
        r = run.run_cell(args.workload, seed, args.seconds, False)
        emit({"reading": "program", "seed": seed, "correct": r["correct"],
              "checks": r["checks"], "metrics": r["metrics"]})
    for seed in controls:
        emit({"reading": "bf16", "seed": seed, "numbers": control_bf16(args.workload, seed, dev)})
        r = run.run_cell(args.workload, seed, args.seconds, False,
                         overrides={"cvc_dtype": "u8"})
        emit({"reading": "u8_cost", "seed": seed, "correct": r["correct"],
              "checks": r["checks"]})
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
