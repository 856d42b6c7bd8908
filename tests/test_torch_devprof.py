"""tools/devprof.py on the CPU: the stage table of the device front's
step (collect, chain, backtrack, pack, the whole step) on a tiny bucket
of a 100 kb synthetic graph (tools/synth.py), timed with the host clock.
The card's run is chip_smoke.py phase 12 (e)."""
import contextlib
import io

import torch

from minigraph_tpu_torch.tools import devprof

torch.set_num_threads(1)


def test_devprof_cpu_smoke():
    argv = ["--device", "cpu", "--bucket", "512x4", "--n", "4", "--reps",
            "1", "--ref-len", "100000", "--window", "64"]
    r = devprof.profile(devprof.parse_args(argv))
    assert r["n_live"] == 4 and r["n_a_max"] > 0
    assert r["sure"] + r["collect_ovf"] + r["chain_unsure"] == 4
    assert set(r["stages"]) == {"collect", "chain", "backtrack", "pack",
                                "step"}
    assert all(s["ms"] > 0 and s["mb"] > 0 for s in r["stages"].values())
    table = devprof.report(r)
    assert "bucket 512x4" in table and "[devprof] step" in table
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert devprof.main(argv) == 0
    assert out.getvalue().count("[devprof]") == len(table.splitlines())
