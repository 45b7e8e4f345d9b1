"""mamba2-780m [ssm] — pure Mamba2 (SSD), attention-free.

[arXiv:2405.21060] Transformers are SSMs (state-space duality).  Twin of
``repro/configs/mamba2_780m.py``: d_model 1536, expand 2 -> d_inner 3072,
head_dim P = 64 -> 48 SSD heads, one B/C group, d_state N = 128, d_conv
4, chunk 128, 48 layers, vocab 50280 (gpt-neox tokenizer, padded), tied
embeddings: 780,148,992 parameters.
"""
from repro_torch.configs.base import SSM, ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    arch_id="mamba2-780m",
    family=SSM,
    num_layers=48,
    d_model=1536,
    num_heads=1,              # unused by SSD blocks
    num_kv_heads=1,
    d_ff=0,                   # attention-free, no separate MLP
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=128),
    tie_embeddings=True,
    source="arXiv:2405.21060",
))
