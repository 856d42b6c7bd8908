"""Shared fixtures of the benchmark's CPU tests: a tiny copy of the
benchmark (its configurations and mixes cut to a 400 kb graph and a
few dozen queries a file), found by name like the real one."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
PB = ROOT / "portbench"

# the front's one small bucket on the CPU: its plain chain takes seconds
# a batch at 2 kb, minutes at 32 kb
CPU_FRONT = {"buckets": ((2048, 16),)}


def tiny_copy(dest: Path) -> Path:
    """configs/, traffic/, metrics/ and a BENCHMARK.json of two tiny
    cells (t.lr, t.asm) in `dest`; returns the BENCHMARK.json."""
    (dest / "configs").mkdir(parents=True)
    (dest / "traffic").mkdir()
    shutil.copytree(PB / "metrics", dest / "metrics")
    for name, tiny in (("lr-bubble20m", "tiny-lr"),
                       ("asm-bubble20m", "tiny-asm")):
        cfg = json.loads((PB / "configs" / f"{name}.json").read_text())
        cfg.update(name=tiny, graph_bp=400_000, threads=2)
        # denser sites, so that the tiny graph holds every kind
        cfg["graph"]["sites_per_mb"] = 50.0
        (dest / "configs" / f"{tiny}.json").write_text(json.dumps(cfg))
    tr = json.loads((PB / "traffic" / "pb15k.json").read_text())
    tr.update(reads_per_file=40, pool_files=2)
    tr["length"] = {"mean": 1400, "sigma": 0.2, "min": 800, "max": 1900}
    (dest / "traffic" / "short.json").write_text(json.dumps(tr))
    tr = json.loads((PB / "traffic" / "hap-contigs.json").read_text())
    tr["pool_files"] = 2
    tr["length"] = {"mean": 1500, "sigma": 0.3, "min": 800, "max": 1900,
                    "mu_shift": -0.045, "long_every": 50,
                    "long_len": 20_000}
    (dest / "traffic" / "ctg.json").write_text(json.dumps(tr))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [
        {"name": "tiny-lr", "file": "configs/tiny-lr.json"},
        {"name": "tiny-asm", "file": "configs/tiny-asm.json"}]
    bench["workloads"] = [
        {"name": "t.lr", "config": "tiny-lr", "traffic": "short",
         "chips": 1, "why": "tiny lr"},
        {"name": "t.asm", "config": "tiny-asm", "traffic": "ctg",
         "chips": 1, "why": "tiny asm"}]
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["t.lr", "t.asm"]
    path = dest / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture(scope="session")
def tiny_spec(tmp_path_factory):
    from portbench.spec import Spec
    root = tmp_path_factory.mktemp("tinybench")
    return Spec(root, tiny_copy(root))


@pytest.fixture
def card():
    """Skips the test where no CUDA device is present (decided here, when
    the test runs, never when the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
