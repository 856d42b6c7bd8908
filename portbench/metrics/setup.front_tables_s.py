"""Device front tables: the host time of the cuckoo build inside
DeviceFront(...) (the program's span setup.front.tables), in seconds.
None where the program has no such span."""


def read(ctx):
    ms = ctx["stats_before"].get("span_ms", {}).get("setup.front.tables")
    return None if ms is None else ms / 1000.0
