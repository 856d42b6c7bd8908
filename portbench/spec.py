"""What the harness runs, found by name.

BENCHMARK.json (at the root of the checkout) names the cells, the
configurations and the metrics.  Everything that belongs to one of them
sits in a file of its own under the benchmark's folder, found by the
name alone: configs/<config>.json, traffic/<traffic>.json and
metrics/<metric>.py (a module with `read(ctx)`, which returns the
metric's value or None where it finds nothing to read).  A later cell,
mix or metric is a new file and a new entry; no code changes.

A configuration file holds the `preset` and may hold `options`: a list
of minigraph's switches applied on top of it, among `-c`,
`--gwfa-device` and `--seed-device` (options.py reads it).  The frozen
reference and pyref take `-c`, which changes the output; the other two
move the port's work to the card and leave its output as it is, so the
references take neither.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent


def names(folder: Path, suffix: str) -> List[str]:
    """The names of the files of one kind in `folder`."""
    return sorted(p.name[: -len(suffix)] for p in folder.glob("*" + suffix))


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_reader(path: Path) -> Callable[[dict], Optional[float]]:
    """A per-layer metric's `read` from its file (the name holds dots,
    so it is loaded by path, not imported)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable[[dict], Optional[float]]]


class Spec:
    """BENCHMARK.json and the benchmark's folder.  `root` holds
    configs/, traffic/ and metrics/; `bench` is the BENCHMARK.json."""

    def __init__(self, root: Path = HERE, bench: Optional[Path] = None):
        self.root = Path(root)
        self.bench_path = Path(bench) if bench else \
            self.root.parent / "BENCHMARK.json"
        self.bench = load_json(self.bench_path)

    def configs(self) -> List[str]:
        return names(self.root / "configs", ".json")

    def traffics(self) -> List[str]:
        return names(self.root / "traffic", ".json")

    def metrics(self) -> List[str]:
        return names(self.root / "metrics", ".py")

    def cell(self, workload: str) -> Cell:
        wl = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in wl:
            raise KeyError(f"no workload {workload!r} in "
                           f"{self.bench_path.name}: {sorted(wl)}")
        w = wl[workload]

        def applies(m):
            return workload in m.get("workloads", [workload])
        e2e = [m for m in self.bench["end_to_end"] if applies(m)]
        moved = {m["name"] for m in e2e}
        per_layer = [m for m in self.bench["per_layer"]
                     if applies(m) and m["moves"] in moved]
        return Cell(
            name=workload, chips=int(w["chips"]),
            config_name=w["config"],
            config=load_json(self.root / "configs" / f"{w['config']}.json"),
            traffic_name=w["traffic"],
            traffic=load_json(self.root / "traffic" / f"{w['traffic']}.json"),
            end_to_end=e2e, per_layer=per_layer,
            readers={m["name"]: load_reader(
                self.root / "metrics" / f"{m['name']}.py")
                for m in per_layer})
