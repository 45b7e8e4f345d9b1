"""Model configurations of the LM stack: twin of ``repro/configs/base.py``.

Every architecture is a frozen :class:`ModelConfig`; ``reduced()`` gives
the CPU-smoke variant of the same family (≤2 layers, d_model ≤256,
≤4 experts, vocab ≤512), field for field the reference's.  ``MoEConfig``
and ``SSMConfig`` are carried as data only: the port's models raise on
them until the MoE and Mamba2 slices (ROADMAP Queue 1 #13).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

# block kinds: a model is a (possibly periodic) sequence of blocks
ATTN_GLOBAL = "attn_global"      # full causal attention
ATTN_LOCAL = "attn_local"        # sliding-window attention
MAMBA = "mamba"                  # Mamba2 SSD block
BLOCK_KINDS = (ATTN_GLOBAL, ATTN_LOCAL, MAMBA)

# families (drive model construction and input specs)
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
ENCDEC = "encdec"
VLM = "vlm"
CNN = "cnn"
FAMILIES = (DENSE, MOE, SSM, HYBRID, ENCDEC, VLM, CNN)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (data only in the port)."""
    num_experts: int = 8
    top_k: int = 2
    expert_d_ff: int = 14336
    capacity_factor: float = 1.25
    group_size: int = 4096
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2
    moe_period: int = 1
    dispatch_mode: str = "scan"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration (data only in the port)."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 128
    a_init_range: Tuple[float, float] = (1.0, 16.0)
    dt_limit: Tuple[float, float] = (0.0, float("inf"))


@dataclass(frozen=True)
class AttentionConfig:
    """Attention flavour knobs shared by all attention blocks."""
    sliding_window: int = 0           # 0 = full attention
    pattern: Tuple[str, ...] = ()     # block kinds repeated over the layers
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    attn_logit_softcap: float = 0.0   # 0 = disabled
    query_pre_attn_scalar: float = 0.0  # 0 -> 1/sqrt(head_dim)


@dataclass(frozen=True)
class ModelConfig:
    """Full architecture description for one model."""
    arch_id: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    enc_layers: int = 0
    enc_seq_divisor: int = 4
    num_patches: int = 0
    vision_embed_dim: int = 0
    final_logit_softcap: float = 0.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    mlp_gated: bool = True
    use_post_norms: bool = False
    dtype: str = "bfloat16"
    # the reference stacks periods for lax.scan; the port loops over
    # layers either way, and reads this only to lay out converted params
    scan_layers: bool = True
    remat: bool = True
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else \
            self.d_model // self.num_heads

    @property
    def block_pattern(self) -> Tuple[str, ...]:
        """Block kinds of one period (repeated to num_layers)."""
        if self.family in (SSM,):
            return (MAMBA,)
        if self.attention.pattern:
            return self.attention.pattern
        if self.attention.sliding_window > 0:
            return (ATTN_LOCAL,)
        return (ATTN_GLOBAL,)

    @property
    def blocks(self) -> Tuple[str, ...]:
        """Block kind of every layer (length num_layers)."""
        pat = self.block_pattern
        reps = -(-self.num_layers // len(pat))
        return (pat * reps)[: self.num_layers]

    @property
    def param_count(self) -> int:
        return count_params(self)

    def reduced(self) -> "ModelConfig":
        """CPU-smoke variant of the same family, as the reference's."""
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4)
        head_dim = max(d_model // num_heads, 16)
        num_kv_heads = max(1, min(self.num_kv_heads, num_heads))
        if self.num_kv_heads < self.num_heads:
            num_kv_heads = max(1, num_heads // 2)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=min(4, self.moe.num_experts),
                top_k=min(2, self.moe.top_k), expert_d_ff=128, group_size=64)
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(
                self.ssm, d_state=32, head_dim=32, chunk_size=32)
        pat = self.attention.pattern
        attention = dataclasses.replace(
            self.attention,
            sliding_window=min(self.attention.sliding_window, 64)
            if self.attention.sliding_window else 0,
            pattern=pat[: 2] if pat else (),
        )
        n_layers = min(self.num_layers, 2 if len(self.block_pattern) <= 2
                       else len(self.block_pattern))
        if n_layers > 2:
            n_layers = 2
        return dataclasses.replace(
            self,
            num_layers=n_layers,
            enc_layers=min(self.enc_layers, 2),
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv_heads,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_patches=min(self.num_patches, 16) if self.num_patches else 0,
            vision_embed_dim=min(self.vision_embed_dim, 64)
            if self.vision_embed_dim else 0,
            attention=attention,
            moe=moe,
            ssm=ssm,
            scan_layers=False,
            remat=False,
        )


# ---------------------------------------------------------------------------
# Parameter counting (analytic)
# ---------------------------------------------------------------------------
def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.resolved_head_dim
    q = cfg.d_model * cfg.num_heads * hd
    kv = 2 * cfg.d_model * cfg.num_kv_heads * hd
    o = cfg.num_heads * hd * cfg.d_model
    bias = (cfg.num_heads * hd + 2 * cfg.num_kv_heads * hd) \
        if cfg.attention.qkv_bias else 0
    return q + kv + o + bias


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    return (3 if cfg.mlp_gated else 2) * cfg.d_model * d_ff


def _mamba_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    in_proj = cfg.d_model * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
    conv = conv_dim * s.d_conv + conv_dim
    return in_proj + conv + nh * 3 + d_in + d_in * cfg.d_model


def _moe_params(cfg: ModelConfig) -> int:
    m = cfg.moe
    return cfg.d_model * m.num_experts \
        + m.num_experts * 3 * cfg.d_model * m.expert_d_ff


def count_params(cfg: ModelConfig) -> int:
    """Analytic parameter count, as the reference's ``count_params``."""
    if cfg.family == CNN:
        raise ValueError("CNN params counted by the model itself")
    total = cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.d_model
    if cfg.num_patches:
        total += cfg.vision_embed_dim * cfg.d_model + cfg.d_model
    for kind in cfg.blocks:
        if kind == MAMBA:
            total += cfg.d_model + _mamba_params(cfg)
            continue
        p = 2 * cfg.d_model
        if cfg.use_post_norms:
            p += 2 * cfg.d_model
        p += _attn_params(cfg)
        p += _moe_params(cfg) if cfg.moe is not None \
            else _mlp_params(cfg, cfg.d_ff)
        total += p
    if cfg.enc_layers:
        total += cfg.enc_layers * (2 * cfg.d_model + _attn_params(cfg)
                                   + _mlp_params(cfg, cfg.d_ff))
        total += cfg.num_layers * (_attn_params(cfg) + cfg.d_model)
    return total + cfg.d_model


@dataclass(frozen=True)
class FederatedConfig:
    """The paper's algorithm knobs (Section III), field for field the
    reference's.  The mesh (``MeshConfig``) comes with the multi-device
    planes (ROADMAP Queue 1 #14)."""
    num_clients: int = 100
    algorithm: str = "csmaafl"        # "sfl" | "afl_baseline" | "csmaafl" | "afl_alpha"
    gamma: float = 0.4                # eq. (11) constant
    mu_momentum: float = 0.9          # moving average for mu_ji
    local_steps: int = 1              # K local SGD steps per upload
    lr: float = 0.01                  # eta (paper: 0.01)
    local_batch_size: int = 5         # paper: 5
    # heterogeneity simulation: client compute time ~ LogUniform[tau, a*tau]
    tau: float = 1.0
    hetero_a: float = 4.0
    tau_upload: float = 0.2
    tau_download: float = 0.2
    # adaptive local iterations for extreme clients (Section III-C policy)
    adaptive_local_iters: bool = True
    min_local_steps: int = 1
    max_local_steps: int = 8
    seed: int = 0
    # server optimizer for cluster mode ("sgd" = pure paper; adam = beyond-paper)
    server_opt: str = "none"
    # micro-batches per fused step (K=1 path): grads accumulated in f32
    # per micro-batch
    grad_accum: int = 1
    # the reference stores inter-layer carries sequence-sharded over its
    # 'model' mesh axis; on one device there is no such axis, and the
    # port accepts the field and does nothing with it
    seq_parallel_carries: bool = True


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, ModelConfig] = {}

# config modules of the port, imported on first lookup
_ARCH_MODULES = ("qwen2_0_5b",)


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.arch_id in _REGISTRY:
        raise ValueError(f"duplicate arch_id {cfg.arch_id}")
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def _load_all() -> None:
    import importlib
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str) -> ModelConfig:
    _load_all()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; the port has "
                       f"{sorted(_REGISTRY)} (other architectures come with "
                       f"ROADMAP Queue 1 #13)")
    return _REGISTRY[arch_id]


def all_arch_ids() -> Sequence[str]:
    _load_all()
    return sorted(_REGISTRY)
