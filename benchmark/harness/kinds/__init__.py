"""One driver per kind of traffic, named by a traffic file's ``kind``.

A driver is built from a cell's configuration and traffic, a seed and a
device, and has ``setup()`` (frames or windows from the seed, the warm-up
of every shape the traffic uses), ``window(seconds)`` (the measured
stretch), ``traced()`` (a short profiled stretch), ``check()`` and
``control()`` (the readings of the timed path's outputs, and of the
reference computed in the lower precision, against the reference).
"""
