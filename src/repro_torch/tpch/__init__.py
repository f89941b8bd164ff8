"""TPC-H: schema-faithful generator + the 20 join queries as plan IR."""

from repro_torch.tpch.gen import generate, date, TABLES
from repro_torch.tpch.queries import QUERIES, build_query

__all__ = ["generate", "date", "TABLES", "QUERIES", "build_query"]
