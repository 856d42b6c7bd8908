"""Device front: the bytes the hash join's collect moves, at the
tensors' stored width, over the collect stage's CUDA-event time, as a
share of one H100's 3.35 TB/s (NVIDIA's data sheet, SXM, 700 W).

    bytes = 8 x (probed x 2 x slot_words + anchor_slots x 6)

Every table and plane is an int64 tensor (8 bytes a word).  A probed
minimizer slot reads both of its table slots, each slot_words words
(tag and pay, and tag_hi for wide keys); an anchor slot reads its
p_rid and p_sel entries and writes its four anchor planes (axh, axl,
ayh, ayl).  The counts are the program's counters (collect_probed,
collect_anchor_slots, table_slot_words), padded slots included, as the
gathers read them.  The time is the window's delta of
stats["stage_ms"]["collect"]: stream time between the stage's marks,
host gaps between its launches included; and the bytes leave out the
collect's other work (query compaction, band expansion, the sort).  So
the share is a lower bound.  None where the program has no such
counters."""

PEAK_BYTES_PER_S = 3.35e12


def read(ctx):
    s0, s1 = ctx["stats_before"], ctx["stats_after"]
    if "collect_probed" not in s1:
        return None

    def delta(key):
        return s1.get(key, 0) - s0.get(key, 0)

    ms = s1.get("stage_ms", {}).get("collect", 0.0) \
        - s0.get("stage_ms", {}).get("collect", 0.0)
    words = delta("collect_probed") * 2 * s1.get("table_slot_words", 0) \
        + delta("collect_anchor_slots") * 6
    if ms <= 0 or words <= 0:
        return None
    return 100.0 * 8 * words / (ms / 1e3) / PEAK_BYTES_PER_S
