"""File loop: the share of the front's submit time (the program's span
front.submit) during which the file loop's tail worker ran a native tail
call (the program's counter submit_tail_overlap_ms), over the window.
None where the program has no such counter."""


def read(ctx):
    s0, s1 = ctx["stats_before"], ctx["stats_after"]
    ms = s1.get("span_ms", {}).get("front.submit", 0.0) \
        - s0.get("span_ms", {}).get("front.submit", 0.0)
    if "submit_tail_overlap_ms" not in s1 or ms <= 0:
        return None
    return 100.0 * (s1["submit_tail_overlap_ms"]
                    - s0.get("submit_tail_overlap_ms", 0.0)) / ms
