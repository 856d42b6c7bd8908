"""Device front: the host time of the front's submit (the program's span
front.submit: encoding the reads, the upload, the stages' dispatch) over
the window, per 1000 reads of the device share.  None where the program
has no such span."""

SPAN = "front.submit"


def read(ctx):
    s0, s1 = ctx["stats_before"], ctx["stats_after"]
    n = s1.get("n_share_dev", 0) - s0.get("n_share_dev", 0)
    if SPAN not in s1.get("span_ms", {}) or n <= 0:
        return None
    ms = s1["span_ms"][SPAN] - s0.get("span_ms", {}).get(SPAN, 0.0)
    return ms / (n / 1000.0)
