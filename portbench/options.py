"""A configuration's `options`: minigraph's command-line switches on top
of its `preset`.

A configuration file may hold `"options": ["-c", ...]`.  The vocabulary
is closed to three switches, each applied as the port's command line
(`cli.py`) and `mapping/mapper.py` `map_files` apply it:

- `-c` (base-level alignment, `cg:Z` and `ds:Z` on every record) sets
  MG_M_CIGAR on the MapOptions.  It changes what minigraph writes, so
  the frozen reference and pyref map with it too.
- `--gwfa-device` builds the GWFA bridge pool (`DeviceGwfaPool`) in
  set-up on the run's device and hands it to every `map_reads` call:
  every read then maps on the per-read path, bridging on the pool.
- `--seed-device` sets the port's `mapper.SEED_DEVICE` in set-up, and
  the run restores it when it ends: a long query on the per-read path
  is sketched on the run's device.

The last two move work to the card and leave the output as it is (the
port's guarantee), so the references take neither: `Options.output`
is what they are handed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Tuple

SWITCHES = ("-c", "--gwfa-device", "--seed-device")


@dataclass(frozen=True)
class Options:
    cigar: bool = False
    gwfa_device: bool = False
    seed_device: bool = False

    @property
    def output(self) -> Tuple[str, ...]:
        """The switches that change the output: the references' share."""
        return ("-c",) if self.cigar else ()


def parse(switches: Iterable[str]) -> Options:
    """The switches of a configuration's `options` list; any other entry
    raises ValueError naming it."""
    if isinstance(switches, str):
        raise ValueError(f"options must be a list of switches, not "
                         f"{switches!r}")
    given = list(switches)
    for s in given:
        if s not in SWITCHES:
            raise ValueError(f"unknown option {s!r}: a configuration's "
                             f"options are among {list(SWITCHES)}")
    return Options(cigar="-c" in given, gwfa_device="--gwfa-device" in given,
                   seed_device="--seed-device" in given)


def of_config(cfg: dict) -> Options:
    return parse(cfg.get("options", []))


def map_options(mod, preset: str, switches: Iterable[str] = (), *extra):
    """(IndexOptions, MapOptions) of the options module `mod` (the
    port's or pyref's) as `-x <preset>` and then `switches` set them;
    `extra` goes to `mod.opt_set` after the two (pyref's GGOptions)."""
    io_, mo = mod.IndexOptions(), mod.MapOptions()
    if mod.opt_set(preset, io_, mo, *extra) < 0:
        raise ValueError(f"unknown preset {preset!r}")
    if parse(switches).cigar:
        mo.flag |= mod.MG_M_CIGAR
    return io_, mo
