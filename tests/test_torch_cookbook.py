"""The pangenome cookbook chain through the port, stage by stage against
the JAX package (tests/test_cookbook61.py's workflow at a small size):
a 300 kb reference (FASTA as the graph) and four make_haplotype
samples, each one sequence; -cxggs builds the graph from all four, then
-cxasm --call of the reference and every sample on that graph, `paste`,
mgutils merge -s and merge2vcf -r 0.  Each stage's bytes equal the JAX
package's; the port's merge and merge2vcf on the JAX package's BEDs give
the JAX tools' bytes.  The port maps with --device none (graph
generation maps on the host, as the JAX package does).  Tolerance:
exact equality."""
import contextlib
import io

import pytest
import torch

from minigraph_tpu import cli as jax_cli
from minigraph_tpu.tools import mgutils as jax_mgutils
from minigraph_tpu_torch import cli
from minigraph_tpu_torch.tools import mgutils
from minigraph_tpu_torch.tools.synth import (make_haplotype, make_reference,
                                             write_fasta)

torch.set_num_threads(1)

N_HAPS = 4
SAMPLES = ["ref"] + [f"hap{h}" for h in range(N_HAPS)]


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    assert rc == 0, err.getvalue()
    return out.getvalue()


def paste(beds):
    rows = [b.splitlines() for b in beds]
    assert len({len(r) for r in rows}) == 1, "bubble row counts differ"
    return "\n".join("\t".join(p) for p in zip(*rows)) + "\n"


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Both packages' stages: {"jax": {...}, "port": {...}}."""
    d = tmp_path_factory.mktemp("cookbook")
    ref = make_reference(300_000, seed=71)
    write_fasta(str(d / "ref.fa"), [("chr6", ref)])
    for h in range(N_HAPS):
        write_fasta(str(d / f"hap{h}.fa"),
                    [(f"h{h}#chr6", make_haplotype(ref, seed=7100 + h,
                                                   sv_per_mb=30.0))])
    (d / "samples.txt").write_text("\n".join(SAMPLES) + "\n")
    res = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "none"])):
        r = res[name] = {}
        haps = [str(d / f"hap{h}.fa") for h in range(N_HAPS)]
        r["gfa"] = run(main, ["-t1", "-cxggs"] + extra + [str(d / "ref.fa")]
                       + haps)
        gfa = d / f"graph_{name}.gfa"
        gfa.write_text(r["gfa"])
        r["beds"] = [run(main, ["-t1", "-cxasm", "--call"] + extra
                         + [str(gfa), str(d / f"{s}.fa")]) for s in SAMPLES]
        pasted = d / f"pasted_{name}.bed"
        pasted.write_text(paste(r["beds"]))
        r["pasted"] = str(pasted)
    res["samples"] = str(d / "samples.txt")
    res["dir"] = d
    return res


def merge_chain(m1, pasted, samples, d, tag):
    """mgutils merge -s then merge2vcf -r 0 through module m1."""
    out = io.StringIO()
    assert m1.cmd_merge(["-s", samples, pasted], out=out) == 0
    merged = d / f"merged_{tag}.bed"
    merged.write_text(out.getvalue())
    vcf = io.StringIO()
    assert m1.cmd_merge2vcf(["-r", "0", str(merged)], out=vcf) == 0
    return out.getvalue(), vcf.getvalue()


def test_graph_matches_jax(chain):
    got, want = chain["port"]["gfa"], chain["jax"]["gfa"]
    assert got == want
    n_seg = sum(ln.startswith("S\t") for ln in got.splitlines())
    assert n_seg > 30


@pytest.mark.parametrize("i", range(len(SAMPLES)))
def test_call_matches_jax(chain, i):
    got, want = chain["port"]["beds"][i], chain["jax"]["beds"][i]
    assert got == want and got.count("\n") >= 20


@pytest.mark.parametrize("beds", ["port", "jax"])
def test_merge_vcf_matches_jax(chain, beds):
    """The port's merge and merge2vcf on one package's pasted BEDs equal
    the JAX tools' on the JAX package's; the VCF has one body line a
    bubble and the samples in order."""
    d = chain["dir"]
    want = merge_chain(jax_mgutils, chain["jax"]["pasted"], chain["samples"],
                       d, "jax")
    got = merge_chain(mgutils, chain[beds]["pasted"], chain["samples"], d,
                      f"port_{beds}")
    assert got == want
    merged, vcf = got
    n_bub = chain["jax"]["beds"][0].count("\n")
    assert sum(not ln.startswith("#") for ln in merged.splitlines()) == n_bub
    body = [ln for ln in vcf.splitlines() if not ln.startswith("#")]
    assert len(body) == n_bub
    head = [ln for ln in vcf.splitlines() if ln.startswith("#CHROM")][0]
    assert head.split("\t")[9:] == SAMPLES
    # some bubble has more than one allele among the samples
    assert any(ln.split("\t")[4] != "." for ln in body)
