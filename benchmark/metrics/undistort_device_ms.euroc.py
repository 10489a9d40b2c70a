"""Device time of the undistortion kernel (``csrc/undistort.cu``, one
launch a step call for its source and target frames) per step call of the
traced runner call, in ms; None where the trace holds no launch of it."""


def read(t):
    sec, n = t.kernel_s("undistort_remap_kernel")
    if not n or not t.calls:
        return None
    return 1e3 * sec / t.calls
