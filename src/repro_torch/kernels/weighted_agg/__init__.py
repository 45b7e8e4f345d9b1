"""Weighted aggregation (eq. 3 / eq. 2) as one CUDA kernel."""
