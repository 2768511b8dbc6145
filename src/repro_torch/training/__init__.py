"""Training on PyTorch: the synthetic data stream, AdamW, checkpoints and
the train loop (ports of ``repro.training``'s single-device modules)."""
