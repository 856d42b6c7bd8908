"""The port's native stage profiler (minigraph_tpu_torch/tools/profmap.py)
against the JAX package's tools/profmap.py, each in a process of its
own (the native library reads MGT_PROF once), on a 200 kb bubble graph
and 150 simulated reads from tools/synth.py: the same five lines with
only their numbers free, the deterministic counters equal (tail slots
4-7, gchain 6-7, gwfa 3-4), and the wall times > 0 for every stage
that ran.  Importing the port's profmap leaves MGT_PROF unset, and its
main raises when the library already reads the profilers as off."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from minigraph_tpu_torch.tools import profmap
from minigraph_tpu_torch.tools.synth import (make_reference, simulate_reads,
                                             write_bubble_rgfa, write_fasta)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NUM = re.compile(r"-?\d+(\.\d+)?")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("profmap")
    ref = make_reference(200_000, seed=141)
    hap = write_bubble_rgfa(ref, 142, str(d / "g.gfa"), seg_len=20_000)
    write_fasta(str(d / "r.fa"),
                simulate_reads([hap, ref], 150, seed=143, mean_len=3000,
                               min_len=500, max_len=8000))
    return str(d / "g.gfa"), str(d / "r.fa")


def python(args):
    """A fresh interpreter without MGT_PROF."""
    env = {k: v for k, v in os.environ.items() if k != "MGT_PROF"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable] + args, cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def fields(line):
    """{name: value} of one profile line's 'name value' pairs."""
    body = line.split(":", 1)[1]
    return {m.group(1).strip(): float(m.group(2)) for m in
            re.finditer(r"([a-z_ -]+?) (-?\d+(?:\.\d+)?)", body)}


COUNTERS = {"tail": ["rescue calls", "anchors", "iters",
                     "first-pass anchors"],
            "gchain": ["shortk calls", "gwfa calls"],
            "gwfa": ["steps", "peak"]}


@pytest.mark.parametrize("opts", [["-x", "lr"], ["-c", "-n", "2"]],
                         ids=["lr", "cigar_reps"])
def test_profmap_matches_jax(inputs, opts):
    want = python(["-m", "minigraph_tpu.tools.profmap", *inputs, *opts])
    got = python(["-m", "minigraph_tpu_torch.tools.profmap", *inputs, *opts])
    want, got = want.splitlines(), got.splitlines()
    assert len(got) == len(want) == 5
    assert [NUM.sub("#", ln) for ln in got] == \
        [NUM.sub("#", ln) for ln in want]
    assert got[0].startswith("== 150 reads")
    prof = {ln.split()[0]: fields(ln) for ln in got[1:]}
    jprof = {ln.split()[0]: fields(ln) for ln in want[1:]}
    for name, keys in COUNTERS.items():
        assert [prof[name][k] for k in keys] == \
            [jprof[name][k] for k in keys], name
    b, t, gc, gw = prof["batch"], prof["tail"], prof["gchain"], prof["gwfa"]
    assert t["first-pass anchors"] > 0 and t["rescue calls"] > 0
    assert gc["gwfa calls"] > 0 and gw["steps"] > 0
    for v in (b["collect"], b["map_tail"], b["format"], t["lchain"],
              t["rescue"], t["gchain_full"], gc["dp"], gc["gen"],
              gw["extend"]):
        assert v > 0
    assert (b["cigar"] > 1) == ("-c" in opts)


def test_import_leaves_environment():
    out = python(["-c", "import os\n"
                  "import minigraph_tpu_torch.tools.profmap\n"
                  "print(os.environ.get('MGT_PROF'))"])
    assert out == "None\n"


def test_main_raises_when_profilers_off(inputs):
    """A library that read MGT_PROF before main set it dumps zeros:
    main refuses to print them."""
    out = python(["-c", "import sys\n"
                  "from minigraph_tpu_torch.utils.native import get_lib\n"
                  "from minigraph_tpu_torch.tools import profmap\n"
                  "assert get_lib().mgt_tail_prof_on() == 0\n"
                  "try:\n"
                  "    profmap.main(sys.argv[1:])\n"
                  "except RuntimeError as e:\n"
                  "    print('raised:', e)\n", *inputs])
    assert out.startswith("raised: profmap: the native library reads its "
                          "profilers as off")
    assert out.count("\n") == 1


def test_usage(capsys):
    assert profmap.main(["g.gfa"]) == 1
    assert "Usage:" in capsys.readouterr().err
