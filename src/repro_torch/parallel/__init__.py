"""Parallelism helpers: `sharding.axis_size` (the data mesh's axis
size, read by the distributed join runtime) and `compress` (int8
gradient compression: the fake-quant of the train step and the int8
all-reduce over a data mesh)."""
