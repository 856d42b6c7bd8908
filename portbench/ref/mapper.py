"""The reference's entry point: map FASTA files on the host."""
from __future__ import annotations

import copy
from typing import Dict, List

from .gfa_io import read_gfa
from .midx import build_index
from .options import IndexOptions, MapOptions, opt_set
from .tail import map_batch_native


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


class Reference:
    """The graph indexed once at `preset`; `map_file` maps one file."""

    def __init__(self, gfa_path: str, preset: str, n_threads: int = 8):
        io_, mo = IndexOptions(), MapOptions()
        if opt_set(preset, io_, mo) < 0:
            raise ValueError(f"unknown preset {preset!r}")
        self.opt = copy.copy(mo)
        self.gi = build_index(read_gfa(gfa_path), io_.k, io_.w, self.opt)
        self.n_threads = n_threads

    def map_file(self, path: str, rescue: bool = True
                 ) -> List[tuple]:
        """[(name, GAF text or None where the engines bailed)] in file
        order."""
        recs = read_fasta(path)
        res = map_batch_native(
            self.gi, self.opt, [(i, nm, sq) for i, (nm, sq) in
                                enumerate(recs)], self.n_threads, rescue)
        return [(nm, res[i]) for i, (nm, _) in enumerate(recs)]


def map_files(gfa_path: str, preset: str, paths: List[str],
              n_threads: int = 8, rescue: bool = True
              ) -> Dict[str, List[tuple]]:
    ref = Reference(gfa_path, preset, n_threads)
    return {p: ref.map_file(p, rescue) for p in paths}
