"""File loop: the share of the window's reads that the split sent to the
device (n_share_dev over n_share_dev + n_share_host)."""


def read(ctx):
    s0, s1 = ctx["stats_before"], ctx["stats_after"]
    dev = s1.get("n_share_dev", 0) - s0.get("n_share_dev", 0)
    host = s1.get("n_share_host", 0) - s0.get("n_share_host", 0)
    if dev + host == 0:
        return None
    return 100.0 * dev / (dev + host)
