"""The per-layer metrics, one module a metric name in ``BENCHMARK.json``:
each gives ``read(ctx) -> float or None`` (None: nothing to read in this
cell, and the metric is left out of the line). ``ctx`` is the traced
run's context (``portbench.run.traced``): the device operations, the
host and wall ms a tick, and the cell's sizes with ``net``, the Q-net's
layer table (``roofline.net_of``)."""
