"""Ragged dense-cache decode attention (replaces the Pallas K1)."""
