"""Device front: the share of the front's bucket batches in the window
that ran from its CUDA graphs (the program's counter n_step_replays) of
those it ran on the card (n_step_replays + n_step_eager).  None where
the program has no such counters or ran no bucket batch on the card in
the window."""


def read(ctx):
    s0, s1 = ctx["stats_before"], ctx["stats_after"]
    if "n_step_replays" not in s1 or "n_step_eager" not in s1:
        return None
    rep = s1["n_step_replays"] - s0.get("n_step_replays", 0)
    n = rep + s1["n_step_eager"] - s0.get("n_step_eager", 0)
    if n <= 0:
        return None
    return 100.0 * rep / n
