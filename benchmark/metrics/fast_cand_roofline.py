"""The fast_cand kernel's share of its roofline in the traced runner call:
the least time of its work at those frames (yardstick.work.cand_work)
over its device time, in percent."""


def read(t):
    return t.roofline_pct("fast_cand", "fast_candidates_kernel")
