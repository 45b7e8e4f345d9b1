"""qwen2-0.5b [dense] — GQA kv=2, QKV bias, tied embeddings.

[arXiv:2407.10671] Qwen2.  Twin of ``repro/configs/qwen2_0_5b.py``.
"""
from repro_torch.configs.base import (DENSE, AttentionConfig, ModelConfig,
                                      register)

CONFIG = register(ModelConfig(
    arch_id="qwen2-0.5b",
    family=DENSE,
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    attention=AttentionConfig(rope_theta=1_000_000.0, qkv_bias=True),
    tie_embeddings=True,
    source="arXiv:2407.10671",
))
