"""Device busy time per ba_windows call, in ms, from the traced calls."""


def read(t):
    return t.busy_per_call_ms()
