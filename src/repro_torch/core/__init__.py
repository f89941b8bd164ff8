"""Predicate-transfer core: Bloom filters, engines, strategies."""
