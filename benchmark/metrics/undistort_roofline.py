"""The undistortion kernel's share of its roofline in the traced runner
call: the least time of its work, each distinct raw frame a step is given
read once and its undistorted copy written once
(yardstick.undistort_work), over its device time, in percent."""


def read(t):
    return t.roofline_pct("undistort", "undistort_remap_kernel")
