"""The klt_level kernel's share of its roofline in the traced runner call:
the least time of its four levels' work at those inputs
(yardstick.work.level_work) over their device time, in percent."""


def read(t):
    return t.roofline_pct("klt_level", "track_level_kernel")
