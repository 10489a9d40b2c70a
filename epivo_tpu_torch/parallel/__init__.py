"""Whole-trajectory solvers (port of ``epivo_tpu/parallel``): the global BA
polish on one device. The multi-device layer (the reference's ``mesh``,
``dist`` and ``multihost``) is not ported yet (ROADMAP A14b)."""
