"""Device front: the stage timer's milliseconds (CUDA events between the
stages' marks, summed over sketch, collect, chain, backtrack and pack)
over the window, per 1000 reads the front kept on the device."""


def read(ctx):
    s0, s1 = ctx["stats_before"], ctx["stats_after"]
    ms = sum(s1.get("stage_ms", {}).values()) \
        - sum(s0.get("stage_ms", {}).values())
    n = s1.get("n_device", 0) - s0.get("n_device", 0)
    if n <= 0:
        return None
    return ms / (n / 1000.0)
