"""Causal GQA flash attention for the teacher-forced loss (replaces the
Pallas K3)."""
