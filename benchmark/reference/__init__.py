"""The plain reference that decides a run's ``correct``.

Frozen copies of the port's plain PyTorch paths (each Hopper kernel's
oracle and the torch code around it, taken at the commit that added the
benchmark), stripped of the kernels, the graph cache and the mesh. The
reference imports nothing of the program, so a later change to the
program cannot move the yardstick it is held to. It runs eagerly, in
blocks of lanes, after a run's measured window has closed.

``vo.step`` and ``vo.sequence`` follow ``pipeline/vo.py`` and the host
half of ``runners.run_vo_sequence``; ``ba.windows`` follows
``pipeline/ba.py::ba_windows``. With ``lowp=True`` they compute the
control: every matmul and einsum in TF32, the nearest precision below
the configurations' float32 with TF32 off (the port's setting).
"""
