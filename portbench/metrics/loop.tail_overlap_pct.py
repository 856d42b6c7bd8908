"""File loop: the share of the device share's native tail time (the
program's span tail.device_share) that ran while the front's newest
batch was still on the card (the program's counter tail_dev_overlap_ms),
over the window.  None where the program has no such counter."""


def read(ctx):
    s0, s1 = ctx["stats_before"], ctx["stats_after"]
    ms = s1.get("span_ms", {}).get("tail.device_share", 0.0) \
        - s0.get("span_ms", {}).get("tail.device_share", 0.0)
    if "tail_dev_overlap_ms" not in s1 or ms <= 0:
        return None
    return 100.0 * (s1["tail_dev_overlap_ms"]
                    - s0.get("tail_dev_overlap_ms", 0.0)) / ms
