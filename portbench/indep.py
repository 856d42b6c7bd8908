"""The independent check: a sample of a run's queries held to `pyref`.

`pyref` is minigraph in pure Python (the JAX package's host modules,
frozen, with no native library), so it shares no code with what the
port runs.  It is far too slow to map every query of a window (about a
second a 15 kb read), so after the window the harness draws a sample of
the queries the window mapped, from the run's seed, maps each with
`pyref` in worker processes, and holds the port's GAF text for that
query to it byte for byte.

The index is `pyref`'s too: the graph's minimizers sketched in Python,
in parallel, once per graph and preset, and kept at a fixed path in the
checkout (`build/portbench/pyref/`), like a compile cache; the graph is
the same for every seed of a configuration.  pyref maps with the preset
and the configuration's switches that change the output (`-c`:
options.py); none of them changes the index, so the cache, keyed by
the graph, k and w, holds for them too.
"""
from __future__ import annotations

import copy
import hashlib
import io
import multiprocessing as mp
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .options import map_options

CACHE = Path(__file__).resolve().parents[1] / "build" / "portbench" / "pyref"

_W: dict = {}     # a worker's graph, index and options
# the seconds the sample may take; a query pyref has not mapped by then
# (one in several hundred 15 kb reads takes it over a minute) is not judged
SECONDS = 45.0


def stop_tracker() -> None:
    """End the process that multiprocessing starts to track semaphores,
    and wait for it, once every pool is gone: a run leaves no process
    behind."""
    import gc
    from multiprocessing import resource_tracker
    gc.collect()
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()


def _cache_file(gfa: str, k: int, w: int) -> Path:
    h = hashlib.sha1(Path(gfa).read_bytes()).hexdigest()[:20]
    return CACHE / f"sketch-{h}-k{k}-w{w}.npz"


def _sketch_one(args):
    from .pyref.index.sketch import sketch
    seq, w, k, rid = args
    return sketch(seq, w, k, rid)


def _options(preset: str, switches: Sequence[str] = ()):
    """pyref's (IndexOptions, MapOptions) at `preset` and `switches`."""
    from .pyref import options
    return map_options(options, preset, switches, options.GGOptions())


def sketch_graph(gfa: str, preset: str, n_procs: int) -> Path:
    """The graph's minimizers (every segment, sketched by pyref), from the
    cache or made with `n_procs` worker processes and cached."""
    from .pyref.graph.gfa_io import read_gfa
    io_, _ = _options(preset)
    path = _cache_file(gfa, io_.k, io_.w)
    if path.exists():
        return path
    g = read_gfa(gfa)
    live = [(s.seq.upper(), io_.w, io_.k, i) for i, s in enumerate(g.seg)
            if s.seq is not None and s.len > 0]
    with mp.get_context("spawn").Pool(n_procs) as pool:
        res = pool.map(_sketch_one, live, chunksize=1)
        pool.close()
        pool.join()
    lens = np.array([len(x) for x, _ in res], dtype=np.int64)
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".tmp{os.getpid()}.npz")
    np.savez(tmp, lens=lens, x=np.concatenate([x for x, _ in res]),
             y=np.concatenate([y for _, y in res]))
    os.replace(tmp, path)
    return path


def _init(gfa: str, preset: str, sketches: str, rescue: bool,
          tmp: str, switches: Sequence[str] = ()) -> None:
    """A worker: the graph, the index from the cached sketches, the
    options as the preset and `switches` set them, the rescue on or
    off; its query file in `tmp`."""
    from .pyref.graph.gfa_io import read_gfa
    from .pyref.index import midx, sketch as sk
    from .pyref.mapping import mapper
    io_, mo = _options(preset, switches)
    with np.load(sketches) as z:      # each z[key] reads the whole array
        x, y, lens = z["x"], z["y"], z["lens"]
    ends = np.cumsum(lens)
    per = [(x[e - n: e], y[e - n: e])
           for n, e in zip(lens.tolist(), ends.tolist())]
    sk.sketch_many = lambda *a, **kw: per
    mapper.RESCUE = rescue
    g = read_gfa(gfa)
    gi = midx.build_index(g, io_.k, io_.w, mo)
    _W.update(gi=gi, opt=mo, fa=os.path.join(tmp, f"q{os.getpid()}.fa"))


def _map_one(q: Tuple[str, str]) -> Tuple[str, str]:
    from .pyref.mapping.mapper import _map_file_frag
    name, seq = q
    with open(_W["fa"], "w") as fh:
        fh.write(f">{name}\n{seq}\n")
    out = io.StringIO()
    _map_file_frag(_W["gi"], [_W["fa"]], copy.copy(_W["opt"]), out, None,
                   None, 1, None, None)
    return name, out.getvalue()


def map_queries(gfa: str, preset: str, queries: List[Tuple[str, str]],
                n_procs: int, rescue: bool = True,
                seconds: float = SECONDS,
                options: Sequence[str] = ()) -> Dict[str, str]:
    """{name: pyref's GAF text} of each (name, sequence), mapped one at a
    time in `n_procs` spawned processes, the longest first, at `preset`
    and `options` (the switches that change the output); a query still
    unmapped `seconds` after the workers start is left out."""
    sketches = str(sketch_graph(gfa, preset, n_procs))
    todo = sorted(queries, key=lambda q: -len(q[1]))
    got: Dict[str, str] = {}
    t_end = time.monotonic() + seconds
    with tempfile.TemporaryDirectory(prefix="pyref-") as tmp, \
            mp.get_context("spawn").Pool(
                min(n_procs, max(1, len(todo))), initializer=_init,
                initargs=(gfa, preset, sketches, rescue, tmp,
                          tuple(options))) as pool:
        it = pool.imap_unordered(_map_one, todo)
        try:
            for _ in todo:
                name, text = it.next(
                    timeout=max(0.01, t_end - time.monotonic()))
                got[name] = text
        except mp.TimeoutError:
            pass
        pool.terminate()
        pool.join()
    return got


def draw_sample(seed: int, passes: List[int], counts: List[int], n: int
                ) -> List[Tuple[int, int]]:
    """`n` (pass, query) pairs, uniform over every query of every pass
    (the pass's pool file has counts[file] queries), from the seed."""
    from .inputs import sub_seed
    sizes = np.array([counts[k] for k in passes], dtype=np.int64)
    total = int(sizes.sum())
    pick = np.sort(np.random.default_rng(sub_seed(seed, 9)).choice(
        total, size=min(n, total), replace=False))
    ends = np.cumsum(sizes)
    at = np.searchsorted(ends, pick, side="right")
    return [(int(p), int(i - (ends[p] - sizes[p]))) for p, i in
            zip(at.tolist(), pick.tolist())]


def check_sample(gfa: str, preset: str, sample: List[Tuple[int, int]],
                 pass_text: List[str], pass_recs: List[list],
                 n_procs: int, rescue: bool = True,
                 seconds: float = SECONDS, options: Sequence[str] = ()
                 ) -> Tuple[int, int, Optional[str]]:
    """(sampled queries whose GAF text differs from pyref's, those pyref
    did not map in time, the first that differs).  pass_text[p] is pass
    p's GAF output and pass_recs[p] its queries [(name, sequence)];
    pyref maps at `preset` and `options`."""
    from .check import group_by_read
    want = map_queries(gfa, preset, sorted({pass_recs[p][i] for p, i
                                            in sample}), n_procs, rescue,
                       seconds, options)
    differ, late, first = 0, 0, None
    by_pass: Dict[int, Dict[str, str]] = {}
    for p, i in sample:
        name = pass_recs[p][i][0]
        if name not in want:
            late += 1
            continue
        if p not in by_pass:
            have: Dict[str, str] = {}
            for qn, text in group_by_read(pass_text[p]):
                have[qn] = have.get(qn, "") + text
            by_pass[p] = have
        if by_pass[p].get(name, "") != want[name]:
            differ += 1
            first = first or name
    return differ, late, first
