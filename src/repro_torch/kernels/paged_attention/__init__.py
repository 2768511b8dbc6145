"""Paged decode attention over the global KV page pool (replaces the Pallas K2)."""
