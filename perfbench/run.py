#!/usr/bin/env python3
"""The benchmark of pointnerf2studio_torch: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Makes the cell's inputs from the seed
(the cloud, the tower's weights on the card, the poses or train views),
builds the program on them, warms up the cell's own shapes, runs the
closed loop for `--seconds`, checks what the timed path produced against
the plain reference (`perfbench/reference/`), and prints as its last line
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer metrics from a
torch.profiler trace of the first `trace_seconds` of the window),
`device`, with `--trace 1` a `breakdown`, and last `checks` (each
compared number with its limit, also the last lines on standard error).
The card's name, power limit and clocks go to earlier lines.

Exits non-zero and prints no result without a CUDA card (it never falls
back to the CPU), with fewer cards than the cell asks for, or if JAX or
the JAX package is loaded in the process once the window has closed.
The program's kernels build under the checkout's `build/kernels/` on a
cell's first run; later runs load them.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# every cache torch, its C++ extensions or Triton might write stays
# inside the checkout, at fixed paths (the port's own kernels build into
# its fixed `build/kernels/`; a kernel a later change adds takes these)
for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "perfbench_cache" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from perfbench.core import device as devmod, harness

    spec = harness.load(args.workload)
    need = int(spec.cell["chips"])
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < need:
        print(f"perfbench: {args.workload} needs {need} cards, "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(devmod.smi_lines(0), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}; workload {args.workload} seed "
          f"{args.seed} seconds {args.seconds} trace {args.trace}",
          flush=True)

    line = harness.run(spec, args.seed, args.seconds, bool(args.trace), dev,
                       T_START)
    found = devmod.forbidden_modules()
    if found:
        print(f"perfbench: the process loaded {found} (JAX or the JAX "
              f"package); no result", file=sys.stderr)
        return 4
    line["device"] = {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0),
                      "count": need, **line["device"]}
    print(devmod.smi_lines(0), flush=True)
    checks = line.pop("checks")
    line["checks"] = checks
    sys.stderr.write("\n".join(harness.check_lines(checks)) + "\n")
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
