"""Kernels: the device time of every kernel in the traced window
(torch.profiler), per Mbp of query mapped."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["kernel_s"] <= 0 or ctx["bp"] <= 0:
        return None
    return tr["kernel_s"] * 1e3 / (ctx["bp"] / 1e6)
