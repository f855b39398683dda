#!/usr/bin/env python3
"""Readings of a cell's compared numbers over many seeds in one process:
the lower and upper readings that its limits are set from.

    python3 perfbench/tools/readings.py --workload <cell | config:traffic> \
        --seeds 1,2,3 --mode <mode> [--frames N] \
        [--route fused|staged|xla]

The modes are the cell's traffic kind's (`perfbench/kinds/<kind>.py`:
`MODES`, `readings`; a mode the kind lacks raises):

- `program`: the program at the cell's own size, as a run drives it (a
  frames cell renders `--frames` frames of its closed loop and the check
  samples them; a train cell takes its first steps), against the
  reference;
- `control`: the reference computed in the nearest precision below the
  configuration's tower in the program's place (`reference.pointnerf.
  control_precision`: TF32 for a float32 tower, float8 e4m3 for bfloat16);
- `program_tf32` (train cells): the program with PyTorch's TF32 matmuls
  switched on, its own path one precision below a float32 tower;
- `half_batch` (train cells): the reference with half of each batch left
  out and the mean taken over the rest, in the program's place;

and the tool's own `run`: a whole run of the harness (`--seconds`,
`--trace`), for a configuration and mix that no cell pairs yet.

`--route` renders a frames cell's configuration on another chunk route
of the program (the fused chunk, the staged selection and tower, or the
XLA candidate stages) to hold the routes against the reference. One JSON
line a seed; runs on the card, or with `--cpu` at the CPU tests' tiny
sizes.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

ROUTES = {"fused": {"chunk_mode": "fused", "knn_mode": "xla"},
          "staged": {"chunk_mode": "fused", "knn_mode": "xla"},
          "xla": {"chunk_mode": "xla", "knn_mode": "xla"}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--route", choices=tuple(ROUTES))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from perfbench.core import harness

    if args.cpu:
        from perfbench.tests.tiny import tiny_spec
        spec, dev = tiny_spec(args.workload), torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("readings: no CUDA device", file=sys.stderr)
            return 3
        spec = (harness.load_pair(*args.workload.split(":"))
                if ":" in args.workload else harness.load(args.workload))
        dev = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if args.route:
        spec.config["query"].update(ROUTES[args.route])
        spec.config["agg"]["fused_decode2"] = args.route == "staged"
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.mode == "run":
            line = harness.run(spec, seed, args.seconds, bool(args.trace),
                               dev, t0)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "route": args.route, "line": line}),
                  flush=True)
            continue
        got = harness.kind(spec.traffic["kind"]).readings(
            spec, seed, dev, args.mode, args.frames)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "mode": args.mode, "route": args.route,
                          "readings": got,
                          "seconds": time.perf_counter() - t0}), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
