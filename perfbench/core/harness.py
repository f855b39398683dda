"""One run of one cell, found by name in `BENCHMARK.json`.

Everything that belongs to one configuration, traffic mix, metric or cell
sits in a file of its own, found by the name there:

- `configs/<config>.json` (the configuration's `file`): the scene, the
  query, tower and train settings, the camera;
- `traffic/<traffic>.json`: the mix, read by the traffic kind its "kind"
  names, `kinds/<kind>.py` (a function `run`);
- `metrics/<metric>.py`: a reader `read(r) -> float | None` of one
  metric from the run's record `r` (a reader that finds nothing to read
  returns None, and the metric is left out of the line);
- `limits/<cell>.json`: each compared number's limit, one for each
  number the cell's kind compares and no other (a run raises otherwise).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Spec:
    name: str
    cell: dict
    config: dict
    traffic: dict
    limits: Optional[Dict[str, float]]
    end_to_end: List[dict]
    per_layer: List[dict]


def load(name: str, root: Path = ROOT) -> Spec:
    """The cell `name` of `<root>/BENCHMARK.json` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    pb = root / "perfbench"
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Spec(
        name=name, cell=cell,
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((pb / "traffic" / f"{cell['traffic']}.json")
                           .read_text()),
        limits=json.loads((pb / "limits" / f"{name}.json").read_text()),
        end_to_end=e2e, per_layer=per_layer)


def load_pair(config: str, traffic: str, root: Path = ROOT) -> Spec:
    """A configuration under a traffic mix that no cell pairs yet (for
    the tools' readings): the files by name, every metric of
    `BENCHMARK.json` (a reader of another kind's metric reads nothing),
    no limits (`limits` None: its runs print their numbers and are never
    correct)."""
    pb = root / "perfbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return Spec(
        name=f"{config}:{traffic}", cell={"config": config,
                                          "traffic": traffic, "chips": 1},
        config=json.loads((pb / "configs" / f"{config}.json").read_text()),
        traffic=json.loads((pb / "traffic" / f"{traffic}.json").read_text()),
        limits=None, end_to_end=bench["end_to_end"],
        per_layer=bench["per_layer"])


def reader(metric: str, root: Path = ROOT):
    """The `read` function of `perfbench/metrics/<metric>.py` (names may
    hold dots, so the file is loaded by its path)."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    s = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def kind(name: str):
    return importlib.import_module(f"perfbench.kinds.{name}")


def run(spec: Spec, seed: int, seconds: float, trace: bool, device,
        t_start: float, clock=time.perf_counter, hooks=None,
        root: Path = ROOT) -> dict:
    """Drive one run and assemble its result line (without printing)."""
    k = spec.traffic["kind"]
    r = kind(k).run(spec, seed, seconds, trace, device, t_start,
                    clock=clock, hooks=hooks)
    r["kind"] = k
    r["spec"] = spec
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        v = reader(m["name"], root)(r)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    limits = spec.limits
    if limits is not None and set(limits) != set(r["checks"]):
        raise KeyError(
            f"limits/{spec.name}.json names {sorted(limits)}; the cell "
            f"compares {sorted(r['checks'])}")
    checks = {name: {"value": value,
                     "limit": None if limits is None else limits[name]}
              for name, value in r["checks"].items()}
    correct = (limits is not None and r["failed"] == 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    line = {"correct": correct, "attempted": int(r["attempted"]),
            "failed": int(r["failed"]), "metrics": metrics,
            "device": {"memory_peak_bytes": int(r["memory_peak_bytes"])}}
    if trace and "trace" in r:
        t = r["trace"]
        line["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["checks"] = checks
    return line


def check_lines(checks: dict) -> List[str]:
    """Each compared number beside its limit, one line each."""
    return [f"check {n}: {c['value']!r} (limit {c['limit']!r})"
            for n, c in checks.items()]
