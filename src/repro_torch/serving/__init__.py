"""Disaggregated serving on PyTorch: the control plane, the fabric and
page allocator (copies), and the prefill/decode engines and cluster (ports)."""
