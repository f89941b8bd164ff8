"""Parallelism helpers: `sharding.axis_size` (the data mesh's axis
size, read by the distributed join runtime)."""
