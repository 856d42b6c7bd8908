"""The reference's entry point: map FASTA files on the host."""
from __future__ import annotations

import copy
from typing import Dict, Iterable, List

from .finish import finish_read
from .gfa_io import read_gfa
from .midx import build_index
from .options import MG_M_CIGAR, IndexOptions, MapOptions, opt_set
from .tail import map_batch_native

# the command-line switches the reference takes, and the flag each sets:
# those that change what minigraph writes (the harness's options.py
# hands the reference only these)
SWITCHES = {"-c": MG_M_CIGAR}


def read_fasta(path: str) -> List[tuple]:
    """(name, sequence) records of a FASTA file (wrapped or not); the
    name is the header's first word, as minigraph reads it."""
    recs, name, parts = [], None, []
    with open(path, "r", encoding="latin-1") as fh:
        for line in fh:
            if line.startswith(">"):
                if name is not None:
                    recs.append((name, "".join(parts)))
                head = line[1:].split()
                name, parts = (head[0] if head else ""), []
            else:
                parts.append(line.strip())
    if name is not None:
        recs.append((name, "".join(parts)))
    return recs


def map_options(preset: str, switches: Iterable[str] = ()):
    """(IndexOptions, MapOptions) as `-x <preset>` and then `switches`
    set them."""
    io_, mo = IndexOptions(), MapOptions()
    if opt_set(preset, io_, mo) < 0:
        raise ValueError(f"unknown preset {preset!r}")
    for s in switches:
        if s not in SWITCHES:
            raise ValueError(f"the reference takes no option {s!r}")
        mo.flag |= SWITCHES[s]
    return io_, mo


class Reference:
    """The graph indexed once at `preset` and `options` (minigraph's
    switches that change the output: -c); `map_file` maps one file.
    At -c a read whose native batch bailed (a gap over the native WFA
    budget) is mapped again by the host finish (finish.py), as the port
    maps it again on its per-read path; `n_finished` counts them."""

    def __init__(self, gfa_path: str, preset: str, n_threads: int = 8,
                 options: Iterable[str] = ()):
        io_, mo = map_options(preset, options)
        self.opt = copy.copy(mo)
        self.gi = build_index(read_gfa(gfa_path), io_.k, io_.w, self.opt)
        self.n_threads = n_threads
        self.n_finished = 0

    def map_file(self, path: str, rescue: bool = True
                 ) -> List[tuple]:
        """[(name, GAF text or None where the engines bailed)] in file
        order."""
        recs = read_fasta(path)
        res = map_batch_native(
            self.gi, self.opt, [(i, nm, sq) for i, (nm, sq) in
                                enumerate(recs)], self.n_threads, rescue)
        if self.opt.flag & MG_M_CIGAR:
            for i, (nm, sq) in enumerate(recs):
                if res[i] is None:
                    res[i] = finish_read(self.gi, self.opt, nm, sq, rescue)
                    self.n_finished += 1
        return [(nm, res[i]) for i, (nm, _) in enumerate(recs)]


def map_files(gfa_path: str, preset: str, paths: List[str],
              n_threads: int = 8, rescue: bool = True,
              options: Iterable[str] = ()) -> Dict[str, List[tuple]]:
    ref = Reference(gfa_path, preset, n_threads, options)
    return {p: ref.map_file(p, rescue) for p in paths}
