"""What a run hands to the metric readers, and how readers are found.

Every metric of ``BENCHMARK.json`` has a reader in ``perfbench/metrics/``:
the file named after the metric, or after the part of its name before the
first dot (``k1_roofline.tput`` -> ``k1_roofline.py``).  A reader module
declares ``LAYER``, ``UNIT``, ``SOURCE`` and ``MOVES`` (the end-to-end
metric each suffix moves, "" for an end-to-end metric itself) and defines
``read(run, name) -> float | None``.  A reader that finds nothing to read
returns None, and the metric is left out of the line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Any, Dict, List, Optional

PERFBENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent


@dataclasses.dataclass
class RunData:
    cell: str
    kind: str                       # serve | train
    config: dict
    mix: dict
    work: Any
    t0: float
    t1: float
    setup_s: float
    records: List[dict] = dataclasses.field(default_factory=list)
    requests: List[dict] = dataclasses.field(default_factory=list)
    spans: List[dict] = dataclasses.field(default_factory=list)
    #: the traced sub-window: reduce_profile's dict plus "window_s",
    #: "records", "prefills", "decodes" (serving) or "steps" (training)
    trace: Optional[dict] = None
    memory_peak_bytes: int = 0
    n_slots: int = 0
    block_size: int = 0
    blocks_per_seq: int = 0
    #: training: per-step (t_end, tokens) of steps finished in the window
    steps: List[tuple] = dataclasses.field(default_factory=list)
    window_peak_bytes: int = 0


def load_json(path: pathlib.Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_file(name: str) -> dict:
    return load_json(PERFBENCH / "traffic" / f"{name}.json")


def generator(kind: str):
    """The traffic generator of mix kind ``kind``: the module
    ``perfbench/traffic/<kind>.py``.  It declares ``HARNESS``, the cell
    that drives it: ``serve_open`` (defines ``schedule(mix, vocab, seed,
    seconds, block)``, a list of ``traffic.Item``), ``serve_closed``
    (``Sessions(mix, vocab, seed)``) or ``train`` (``batch(mix, vocab,
    seed, step)``)."""
    return _load(PERFBENCH / "traffic" / f"{kind}.py",
                 f"perfbench_traffic_{kind}")


def limits_file(cell: str) -> dict:
    return load_json(PERFBENCH / "limits" / f"{cell}.json")


def reader(name: str):
    """The reader module of metric ``name``."""
    for stem in (name, name.split(".")[0]):
        path = PERFBENCH / "metrics" / f"{stem}.py"
        if path.exists():
            return _load(path, f"perfbench_metric_{stem.replace('.', '_')}")
    raise KeyError(f"no reader for metric {name!r}")


def _load(path: pathlib.Path, name: str):
    if not path.exists():
        raise KeyError(f"no file {path.name!r} in {path.parent}")
    spec = importlib.util.spec_from_file_location(name.replace("-", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metric entries a run of ``cell`` reports: its end-to-end
    metrics untraced, its per-layer metrics traced."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def read_metrics(bench: dict, data: RunData, trace: bool) -> Dict[str, dict]:
    out = {}
    for m in cell_metrics(bench, data.cell, trace):
        value = reader(m["name"]).read(data, m["name"])
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


#: how a request that counts as missing ended
MISSING = ("failed", "timeout", "rejected", "cancelled")


def ttft_samples(run: RunData) -> List[Optional[float]]:
    """Each window request's due time to its first token (open loop); None
    for one that failed or never gave a token."""
    out = []
    for r in run.requests:
        if r["measured"]:
            ok = r["stamps"] and r["reason"] not in MISSING
            out.append(r["stamps"][0] - r["due"] if ok else None)
    return out
