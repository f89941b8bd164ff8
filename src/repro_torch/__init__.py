"""PyTorch/CUDA port of the predicate-transfer engine in `repro`.

Mirrors `repro`'s layout (`core/`, `kernels/`, `relational/`, `tpch/`,
and for the LM layer's serving path `configs/`, `models/`, `launch/`)
module for module; the reference package is what it is held against.
Entry points run on a CUDA device unless the caller passes
`device="cpu"` (`get_engine`, `get_join_engine`, `make_strategy`,
`launch.serve --device`) or `ExecConfig(torch_device="cpu")`. Imports
`torch`, never `jax`, and nothing of `repro`.
"""
