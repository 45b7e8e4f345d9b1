"""Mamba2 SSD chunk scan (prefill) as one CUDA kernel."""
