"""Device front tables: the host time of the cuckoo walk and its slot
hashes inside DeviceFront(...) (the program's span setup.front.cuckoo,
inside setup.front.tables), in seconds.  None where the program has no
such span."""


def read(ctx):
    ms = ctx["stats_before"].get("span_ms", {}).get("setup.front.cuckoo")
    return None if ms is None else ms / 1000.0
