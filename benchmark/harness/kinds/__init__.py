"""One driver per kind of traffic, named by a traffic file's ``kind``.

A kind is a module of this package whose name does not start with ``_``
(``_``-prefixed modules are helpers the kinds share). It defines:

- ``Driver``, built from a cell's configuration and traffic, a seed and a
  device, with ``setup()`` (frames or windows from the seed, the warm-up
  of every shape the traffic uses), ``window(seconds)`` (the measured
  stretch), ``traced()`` (a short profiled stretch), ``check()`` and
  ``control()`` (the readings of the timed path's outputs, and of the
  reference computed in the lower precision, against the reference);
- ``REHEARSAL``: the traffic's overrides for the CPU rehearsal at the tiny
  camera (``benchmark/tests/_tiny.py``);
- ``CONTROL``: the traffic's overrides for the control test on the card
  (``benchmark/tests/test_bench_control.py``);
- ``FAULT_TARGET``: the name of the port function that the rehearsal's
  faults wrap (``"vo_step_batched"`` in ``pipeline.vo`` or
  ``"ba_windows"`` in ``pipeline.ba``).

The three constants are test fixtures: the drivers and the benchmark's
runs do not read them, only ``benchmark/tests`` does. So a new kind
enters as a new module, found by name like every other file of the
benchmark, and no existing file changes. The fault targets a test knows
are listed in ``benchmark/tests/_tiny.py``'s ``FAULT_TARGETS``; a kind
with a new target needs its faults written there and in
``test_bench_rehearsal.py``.
"""
