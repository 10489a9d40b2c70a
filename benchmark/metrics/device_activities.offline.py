"""Device activities (kernels, copies, sets) per batch-32 step call of the
offline cell."""


def read(t):
    return t.activities_per_call()
