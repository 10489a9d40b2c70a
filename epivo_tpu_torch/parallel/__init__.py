"""Multi-device layer and whole-trajectory solvers (port of
``epivo_tpu/parallel``): the (win, hyp) device mesh over
``torch.distributed`` ranks (``mesh``), the window-sharded BA step and the
hypothesis-sharded RANSAC (``dist``), multi-process launch and per-host
window blocks (``multihost``), and the global BA polish with its
constraint-sharded path (``global_ba``)."""
