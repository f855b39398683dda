"""Traffic kinds: how a cell drives the program, one module each.

A traffic file's `"kind"` names its module, `perfbench/kinds/<kind>.py`,
which `perfbench/core/harness.py::kind` imports. A new kind is a new
module beside the others with its configuration, traffic, limits, tiny
and metric files; no file that is there changes. A kind module has:

- `run(spec, seed, seconds, trace, device, t_start, clock=..., hooks=None)
  -> dict`: one run of a cell (set-up, the window, the check), returning
  the run's record (below). `hooks={"program": f}` calls `f(cell)` once
  the program is built and before anything runs on it, so that a test
  can plant a fault in the timed path.
- `CHECKS`: the names of the numbers the kind compares; the cell's
  `limits/<cell>.json` names exactly these.
- `MODES` and `readings(spec, seed, device, mode, frames) -> dict`: the
  compared numbers of one seed in each mode that `tools/readings.py`
  offers for the kind (`program`: the program as a run drives it,
  against the reference; `control`: the reference at
  `reference.pointnerf.control_precision` in the program's place; a kind
  may add its own faults). A mode not in `MODES` raises, naming the mode
  and the kind. `frames` is the number of frames a frames kind renders in
  `program` mode; other kinds ignore it.
- `TINY_TRAFFIC`: the traffic settings that `perfbench/tests/tiny.py`
  overrides for the CPU tests' tiny size (the configuration's own cut is
  `perfbench/tiny/<config>.json`).

The record, which the metric readers read (`perfbench/metrics/`):

- `setup_s`, `attempted`, `failed`, `memory_peak_bytes`, `checks` (each
  of `CHECKS` by name), with `--trace 1` `trace` (`core/device.py::
  summarise`, with `program_launches`) and `work` (the kind's counted
  work, which its own per-layer readers read);
- `loop`, what the window timed, which the end-to-end readers read:
  `"steps"` with `steps`, `rays` (rays over all steps) and `window_s`;
  or `"frames"` with `frames`, `pixels` (a frame's), `frame_s` (each
  frame's seconds) and `window_s`. A record with no `loop` reports
  `setup_s` alone;
- `kind` and `spec`, which `harness.run` adds.
"""
