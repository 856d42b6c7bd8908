"""The comparison that decides `correct`.

Every read of every file that the window completed is held to the
frozen reference's GAF text for that read, byte for byte: the port's
guarantee is minigraph's output whichever side (host or device) maps a
read.  A read counts as differing when its records differ, are missing
or are extra, or stand out of order.  A read the reference's engines
could not map (they bailed) cannot be judged and is counted apart.  A
sample of the queries is held, the same way, to the independent engine
(indep.py): `sample_reads_differ`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# limits of the numbers compared (PERF.md gives the readings behind them)
LIMITS = {"gaf_reads_differ": 0, "reads_unjudged": 0,
          "sample_reads_differ": 0}


def group_by_read(text: str) -> List[Tuple[str, str]]:
    """(qname, its lines) for each run of lines of one read, in order."""
    out: List[Tuple[str, str]] = []
    for line in text.splitlines(keepends=True):
        name = line.split("\t", 1)[0]
        if out and out[-1][0] == name:
            out[-1] = (name, out[-1][1] + line)
        else:
            out.append((name, line))
    return out


def compare_file(got: str, ref: List[Tuple[str, Optional[str]]]
                 ) -> Tuple[int, int]:
    """(reads that differ, reads the reference could not judge) of one
    mapped file against the reference's [(qname, text or None)]."""
    skip = {n for n, t in ref if t is None}
    want = [(n, t) for n, t in ref if t]
    if not skip and got == "".join(t for _, t in want):
        return 0, 0
    seen = [(n, t) for n, t in group_by_read(got) if n not in skip]
    if seen == want:
        return 0, len(skip)
    exp = dict(want)
    have: Dict[str, str] = {}
    for n, t in seen:
        have[n] = have.get(n, "") + t
    bad = {n for n in set(exp) | set(have) if exp.get(n) != have.get(n)}
    if not bad:         # the same records in another order
        bad = {a for (a, _), (b, _) in zip(seen, want) if a != b}
    return len(bad), len(skip)


def check_lines(vals: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit"}} of the numbers compared."""
    return {k: {"value": vals[k], "limit": LIMITS[k]} for k in LIMITS}


def correct(vals: Dict[str, float]) -> bool:
    return all(vals[k] <= LIMITS[k] for k in LIMITS)
