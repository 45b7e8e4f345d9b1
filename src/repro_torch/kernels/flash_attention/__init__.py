"""Flash-attention forward (prefill) as one CUDA kernel."""
