"""Native tail: the host clock around each native batch call over the
window (stats["tail_ms"]), per Mbp of query mapped."""


def read(ctx):
    ms = ctx["stats_after"].get("tail_ms", 0.0) \
        - ctx["stats_before"].get("tail_ms", 0.0)
    if ctx["bp"] <= 0 or ms <= 0:
        return None
    return ms / (ctx["bp"] / 1e6)
