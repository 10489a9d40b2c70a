"""The general harness: one driver per kind of traffic (``kinds/``), the
trace reader, the statistics and the comparison with the reference."""
