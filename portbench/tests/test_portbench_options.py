"""A configuration's `options` (portbench/options.py): the same objects
as the preset alone where there are none, a closed vocabulary, and at a
tiny size on the CPU a -c cell held byte for byte (cg:Z and ds:Z) to
both references, a check that fails when one cg:Z is altered, the
reference's host finish for reads its native batch gives up, and
--gwfa-device and --seed-device handed to the port as cli.py hands
them on."""
from __future__ import annotations

import json
import re
from dataclasses import asdict

import pytest

from conftest import CPU_FRONT, PB, tiny_copy
from portbench import check, indep
from portbench.harness import run_cell
from portbench.options import Options, map_options, of_config, parse
from portbench.spec import Spec

SEED = 2**31 + 81
CONFIGS = ("lr-bubble20m", "asm-bubble20m", "lr-chr1")
CELLS = {"t.lrc": ["-c"], "t.lrdev": ["--gwfa-device", "--seed-device"]}


@pytest.fixture(scope="module")
def opt_spec(tmp_path_factory):
    """The tiny benchmark with two more cells on tiny-lr's graph and mix:
    t.lrc at -c, t.lrdev with both device pools."""
    root = tmp_path_factory.mktemp("optbench")
    bench_path = tiny_copy(root)
    bench = json.loads(bench_path.read_text())
    for wl, switches in CELLS.items():
        cfg = json.loads((root / "configs" / "tiny-lr.json").read_text())
        name = "tiny-lr" + wl[len("t.lr"):]
        cfg.update(name=name, options=switches)
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name,
                                 "file": f"configs/{name}.json"})
        bench["workloads"].append({"name": wl, "config": name,
                                   "traffic": "short", "chips": 1,
                                   "why": "tiny lr with options"})
    bench_path.write_text(json.dumps(bench))
    return Spec(root, bench_path)


def _config(name):
    return json.loads((PB / "configs" / f"{name}.json").read_text())


def _engines():
    """(name, options module, its opt_set's arguments after io and mo,
    the function that builds its options at a preset and switches)."""
    from minigraph_tpu_torch import options as port
    from portbench.pyref import options as pyref
    from portbench.ref import mapper as ref_mapper
    from portbench.ref import options as ref
    return [
        ("port", port, (), lambda p, s: map_options(port, p, s)),
        ("ref", ref, (), ref_mapper.map_options),
        ("pyref", pyref, (pyref.GGOptions(),), indep._options)]


@pytest.mark.parametrize("name", CONFIGS)
def test_no_options_builds_the_preset_alone(name):
    cfg = _config(name)
    assert "options" not in cfg
    opts = of_config(cfg)
    assert opts == Options() and opts.output == ()
    for engine, mod, extra, build in _engines():
        io_, mo = mod.IndexOptions(), mod.MapOptions()
        assert mod.opt_set(cfg["preset"], io_, mo, *extra) == 0
        io2, mo2 = build(cfg["preset"], opts.output)
        assert (asdict(io2), asdict(mo2)) == (asdict(io_), asdict(mo)), \
            engine


def test_cigar_sets_the_flag_in_every_engine():
    for engine, mod, _, build in _engines():
        _, mo = build("lr", parse(["-c"]).output)
        _, plain = build("lr", ())
        assert mo.flag == plain.flag | mod.MG_M_CIGAR, engine


@pytest.mark.parametrize("bad,named", [
    (["-c", "--frag"], "--frag"), (["-x", "asm"], "-x"),
    (["--gwfa_device"], "--gwfa_device"), ("-c", "-c")])
def test_unknown_switch_is_refused(bad, named):
    with pytest.raises(ValueError) as e:
        parse(bad)
    assert repr(named) in str(e.value)
    with pytest.raises(ValueError):
        of_config({"preset": "lr", "options": bad})


def test_references_take_only_output_switches():
    from portbench.ref.mapper import map_options as ref_options
    with pytest.raises(ValueError, match="--gwfa-device"):
        ref_options("lr", ["--gwfa-device"])
    opts = parse(["--gwfa-device", "--seed-device", "-c"])
    assert opts == Options(cigar=True, gwfa_device=True, seed_device=True)
    assert opts.output == ("-c",)


def _capture_texts(monkeypatch):
    """The port's GAF text of every file the window completed, and what
    the sample held to pyref came to."""
    texts, sample = [], []
    real_cmp, real_sample = check.compare_file, indep.check_sample

    def cmp(got, want):
        texts.append(got)
        return real_cmp(got, want)

    def chk(*a, **kw):
        sample.append(real_sample(*a, **kw))
        return sample[-1]
    monkeypatch.setattr(check, "compare_file", cmp)
    monkeypatch.setattr(indep, "check_sample", chk)
    return texts, sample


def test_cigar_cell_tiny_cpu(opt_spec, monkeypatch):
    texts, sample = _capture_texts(monkeypatch)
    res = run_cell(opt_spec.cell("t.lrc"), SEED, 1.0, False, device="cpu",
                   front_kw=CPU_FRONT)
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"]["reads_unjudged"]["value"] == 0
    lines = [ln for t in texts for ln in t.splitlines()]
    mapped = [ln for ln in lines if ln.split("\t")[5] != "*"]
    assert mapped and all("\tcg:Z:" in ln and "\tds:Z:" in ln
                          for ln in mapped)
    # pyref mapped the sample at -c in time and agreed
    (differ, late, _), = sample
    assert differ == 0 and late < 48


def test_altered_cigar_is_not_correct(opt_spec, monkeypatch):
    """One cg:Z altered where the port's native tail writes it."""
    from minigraph_tpu_torch.mapping import mapper
    real = mapper.map_batch_native

    def broken(*args, **kw):
        res = real(*args, **kw)
        k = next(k for k, v in sorted(res.items()) if v and "cg:Z:" in v)
        res[k] = re.sub(r"cg:Z:(\d+)",
                        lambda m: f"cg:Z:{int(m.group(1)) + 1}", res[k],
                        count=1)
        return res
    monkeypatch.setattr(mapper, "map_batch_native", broken)
    res = run_cell(opt_spec.cell("t.lrc"), SEED, 1.0, False, device="cpu",
                   front_kw=CPU_FRONT)
    assert res["correct"] is False
    assert res["checks"]["gaf_reads_differ"]["value"] > 0


def test_device_switches_reach_the_port(opt_spec, monkeypatch):
    """--gwfa-device: a pool on the run's device in every map_reads
    call; --seed-device: SEED_DEVICE on, on the run's device, during the
    calls (cli.py: the pools follow --device), restored afterwards.  The
    per-read path sketches a query the front does not take: a front of
    one 1 kb bucket leaves it the longer reads, and a lower min_len
    lets them take the sweep."""
    import torch
    from minigraph_tpu_torch.align.gwfa_device import DeviceGwfaPool
    from minigraph_tpu_torch.mapping import mapper
    monkeypatch.setitem(mapper.SEED_DEVICE, "min_len", 1000)
    before = dict(mapper.SEED_DEVICE)
    calls, sweeps = [], []
    real_map, real_sweep = mapper.map_reads, mapper.collect_minimizers_device

    def map_reads(*a, **kw):
        calls.append((kw.get("gwfa_pool"), dict(mapper.SEED_DEVICE)))
        return real_map(*a, **kw)

    def sweep(gi, qlens, seqs, device, mesh=None):
        sweeps.append((len(qlens), device))
        return real_sweep(gi, qlens, seqs, device, mesh)
    monkeypatch.setattr(mapper, "map_reads", map_reads)
    monkeypatch.setattr(mapper, "collect_minimizers_device", sweep)
    res = run_cell(opt_spec.cell("t.lrdev"), SEED, 1.0, False,
                   device="cpu", front_kw={"buckets": ((1024, 16),)})
    assert res["correct"] is True
    assert len(calls) >= 2          # the warm-up and the window
    pools = {id(p) for p, _ in calls}
    assert len(pools) == 1
    pool = calls[0][0]
    assert isinstance(pool, DeviceGwfaPool)
    assert pool.device == torch.device("cpu") and pool.n_jobs > 0
    assert all(sd == dict(before, on=True, device="cpu")
               for _, sd in calls)
    assert sweeps and all(d == "cpu" for _, d in sweeps)
    assert mapper.SEED_DEVICE == before


def test_no_options_hand_no_pool(tiny_spec, monkeypatch):
    from minigraph_tpu_torch.mapping import mapper
    before = dict(mapper.SEED_DEVICE)
    seen = []
    real = mapper.map_reads

    def map_reads(*a, **kw):
        seen.append((kw.get("gwfa_pool"), dict(mapper.SEED_DEVICE)))
        return real(*a, **kw)
    monkeypatch.setattr(mapper, "map_reads", map_reads)
    res = run_cell(tiny_spec.cell("t.lr"), SEED, 0.5, False, device="cpu",
                   front_kw=CPU_FRONT)
    assert res["correct"] is True
    assert seen and all(p is None and sd == before for p, sd in seen)


def _ref_and_file(opt_spec, tmp_path):
    from portbench.inputs import make_inputs
    from portbench.ref.mapper import Reference
    cell = opt_spec.cell("t.lrc")
    inp = make_inputs(cell.config, cell.traffic, SEED, tmp_path)
    return Reference(inp.gfa, "lr", 2, ("-c",)), inp.files[0]


@pytest.mark.parametrize("walk", ["native", "python"])
def test_host_finish_matches_the_batch(opt_spec, tmp_path, monkeypatch,
                                       walk):
    """The finish, run on every read, writes the batch's bytes: with the
    native anchor walk, and with the Python walk and its WFA (the route
    of a chain with a gap over the native budget)."""
    from portbench.ref import cigar, finish
    from portbench.ref.mapper import read_fasta
    ref, path = _ref_and_file(opt_spec, tmp_path)
    want = ref.map_file(path)
    assert all(t is not None for _, t in want)
    assert sum("cg:Z:" in t for _, t in want) > 0
    if walk == "python":
        monkeypatch.setattr(cigar, "_gchain_cigar_native",
                            lambda *a: False)
    for (name, text), (_, seq) in zip(want, read_fasta(path)):
        assert finish.finish_read(ref.gi, ref.opt, name, seq) == text, name


def test_bailed_reads_are_finished(opt_spec, tmp_path, monkeypatch):
    """Reads the native batch gives up at -c are mapped again by the host
    finish: the reference judges every read, with the same bytes."""
    from portbench.ref import mapper as ref_mapper
    ref, path = _ref_and_file(opt_spec, tmp_path)
    want = ref.map_file(path)
    real = ref_mapper.map_batch_native

    def bails(*a, **kw):
        return {k: (None if k % 3 == 0 else v)
                for k, v in real(*a, **kw).items()}
    monkeypatch.setattr(ref_mapper, "map_batch_native", bails)
    assert ref.map_file(path) == want
    assert ref.n_finished == (len(want) + 2) // 3
