"""Device busy time per batch-32 step call of the offline cell, in ms, from
the traced runner call."""


def read(t):
    return t.busy_per_call_ms()
