"""Share of a step call's untraced wall time (the measured window's) with
no device activity, in percent."""


def read(t):
    return t.idle_share_pct()
