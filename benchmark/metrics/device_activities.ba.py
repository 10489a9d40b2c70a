"""Device activities (kernels, copies, sets) per ba_windows call."""


def read(t):
    return t.activities_per_call()
