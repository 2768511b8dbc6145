"""Causal GQA flash attention for the teacher-forced loss and the prompt
pass (replaces the Pallas K3)."""
