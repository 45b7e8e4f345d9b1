"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block: twin of
``repro/models/mamba2.py``.

The chunked SSD algorithm (intra-chunk quadratic term, inter-chunk
recurrence over chunk states), the O(1) one-token decode recurrence, the
depthwise causal conv1d and the gated RMSNorm of the Mamba2 block.
Shapes follow the paper: X (B,L,H,P), dt (B,L,H), A (H,) negative, B/C
(B,L,G,N) with G groups broadcast over H heads.  Parameters keep the
reference's names, shapes and dtypes.

**One SSD route.**  Every full-sequence SSD of the port goes through
``kernels.ssd_scan.ops.ssd``: the CUDA kernel on the card, the plain
``ssd_chunked`` below on the CPU.  The reference's ``use_kernel`` switch
has no counterpart: no reference caller sets it, so keeping it would
put the plain op on the card's serving path.  ``ssd_chunked`` is the
kernel's plain version and the backward that ``ops.ssd`` recomputes.

``mamba2_forward`` given a ``cache`` also writes the block's conv and SSM
states there, in place, from the same pass (the reference recomputes them
with a second projection, conv and SSD); ``mamba2_decode`` writes both
caches in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------
def mamba2_init(gen: torch.Generator, cfg: ModelConfig, *,
                dtype=torch.float32) -> Params:
    """Random parameters on ``gen``'s device."""
    s = cfg.ssm
    d, d_in, nh = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    dev = gen.device
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    lo, hi = s.a_init_range

    def uniform(n, a, b):
        return a + (b - a) * torch.rand(n, generator=gen, device=dev)

    a = uniform(nh, lo, hi)
    # dt bias via inverse softplus of dt ~ LogU[1e-3, 1e-1]
    dt = torch.exp(uniform(nh, math.log(1e-3), math.log(1e-1)))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    return {
        # order: [z (d_in), x (d_in), B (G*N), C (G*N), dt (nh)]
        "in_proj": dense_init(gen, d, 2 * d_in + 2 * s.n_groups * s.d_state
                              + nh, dtype=dtype),
        "conv_w": (torch.randn(s.d_conv, conv_dim, generator=gen,
                               device=dev) * 0.1).to(dtype),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=dev),
        "A_log": torch.log(a),
        "D": torch.ones(nh, dtype=torch.float32, device=dev),
        "dt_bias": dt_bias,
        "norm_scale": torch.zeros(d_in, dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, d_in, d, dtype=dtype),
    }


# ---------------------------------------------------------------------------
# SSD chunked algorithm (the kernel's plain version)
# ---------------------------------------------------------------------------
def _segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{k=j+1..i} x[..., k] (lower-triangular);
    -inf above the diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, *, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD over a full sequence.

    x  (Bt, L, H, P)   inputs (already conv'd + activated)
    dt (Bt, L, H)      positive step sizes
    A  (H,)            negative decay rates
    B  (Bt, L, G, N)   input projections  (G groups)
    C  (Bt, L, G, N)   output projections
    Returns (y (Bt,L,H,P), final_state (Bt,H,P,N)), both f32.  The
    reference's ``lax.scan`` over chunk states is a loop over chunks.
    """
    Bt, L, H, P = x.shape
    G, N = B.shape[-2], B.shape[-1]
    nc = L // chunk
    assert nc * chunk == L, f"L={L} not divisible by chunk={chunk}"
    rep = H // G

    # fold dt into x (dt * x) and keep dA = dt * A for decays (f32)
    xf = x.float()
    dtf = dt.float()
    dA = dtf * A.float()[None, None, :]                  # (Bt,L,H) negative

    xc = (xf * dtf[..., None]).reshape(Bt, nc, chunk, H, P)
    dAc = dA.reshape(Bt, nc, chunk, H)
    Bh = B.float().reshape(Bt, nc, chunk, G, N).repeat_interleave(rep, -2)
    Ch = C.float().reshape(Bt, nc, chunk, G, N).repeat_interleave(rep, -2)

    # intra-chunk (quadratic within the chunk)
    Lmat = torch.exp(_segsum(dAc.permute(0, 1, 3, 2)))   # (Bt,nc,H,Q,Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)  # (Bt,nc,H,Q,Q)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", scores * Lmat, xc)

    # chunk states: S_c = sum_k decay_to_end(k) * B_k (x) x_k
    dA_cum = torch.cumsum(dAc, dim=2)                    # (Bt,nc,Q,H)
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchpn",
                          decay_to_end, Bh, xc)          # (Bt,nc,H,P,N)

    # inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])         # (Bt,nc,H)
    s = (torch.zeros(Bt, H, P, N, dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    before = []                                          # state before chunk
    for c in range(nc):
        before.append(s)
        s = states[:, c] + chunk_decay[:, c, :, None, None] * s
    states_before = torch.stack(before, dim=1)           # (Bt,nc,H,P,N)

    # inter-chunk output: y += C_q * decay_from_start(q) * S_{c-1}
    decay_from_start = torch.exp(dA_cum)                 # (Bt,nc,Q,H)
    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp",
                           Ch, states_before, decay_from_start)
    y = (y_intra + y_inter).reshape(Bt, L, H, P)
    return y, s


def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor,
                    dt_t: torch.Tensor, A: torch.Tensor, B_t: torch.Tensor,
                    C_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD recurrence.
    state (Bt,H,P,N); x_t (Bt,H,P); dt_t (Bt,H); B_t/C_t (Bt,G,N).
    h <- exp(dt*A) h + (dt*x) (x) B ; y = C·h.  Returns (y in x_t's dtype,
    new_state f32)."""
    rep = x_t.shape[1] // B_t.shape[1]
    Bh = B_t.float().repeat_interleave(rep, dim=1)      # (Bt,H,N)
    Ch = C_t.float().repeat_interleave(rep, dim=1)
    dA = torch.exp(dt_t.float() * A[None, :])            # (Bt,H)
    xdt = x_t.float() * dt_t[..., None]
    new_state = (dA[..., None, None] * state.float()
                 + torch.einsum("bhp,bhn->bhpn", xdt, Bh))
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x_t.dtype), new_state


# ---------------------------------------------------------------------------
# Conv1d (depthwise causal; plain torch, as the reference's is plain XLA)
# ---------------------------------------------------------------------------
def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                  ) -> torch.Tensor:
    """x (B,L,C); w (K,C) depthwise; causal (left) padding."""
    K, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + L, :] * w[i][None, None, :] for i in range(K))
    return out + b[None, None, :]


def conv1d_decode_step(conv_state: torch.Tensor, x_t: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv_state (B,K-1,C) = previous inputs; x_t (B,C).  Returns (y,
    the new conv state)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # (B,K,C)
    y = torch.einsum("bkc,kc->bc", window, w) + b
    return y, window[:, 1:, :]


# ---------------------------------------------------------------------------
# Full Mamba2 block
# ---------------------------------------------------------------------------
def _split_in_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """(z, x, B, C, dt) views of the input projection."""
    s = cfg.ssm
    d_in, gn = cfg.d_inner, s.n_groups * s.d_state
    return torch.split(zxbcdt, [d_in, d_in, gn, gn, cfg.ssm_heads], dim=-1)


def _gated_rmsnorm(scale: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Mamba2's norm: RMSNorm(x * silu(z)) * (1+scale)."""
    dt = x.dtype
    x = x.float() * F.silu(z.float())
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale)).to(dt)


def mamba2_forward(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                   cache: Optional[Params] = None) -> torch.Tensor:
    """Full-sequence Mamba2 block.  x: (B, L, d_model) -> (B, L, d_model).

    With ``cache`` (``init_mamba_cache``'s), the block's states after the
    sequence are written there in place, from this same pass: the conv
    state is the last d_conv − 1 pre-activation conv inputs (zeros in
    front when L is shorter), the SSM state the scan's final state, which
    the kernel emits beside y."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    s = cfg.ssm
    B_, L, _ = x.shape
    d_in, nh = cfg.d_inner, cfg.ssm_heads
    gn = s.n_groups * s.d_state
    z, xi, Bm, Cm, dt = _split_in_proj(cfg, x @ params["in_proj"])
    xBC = torch.cat([xi, Bm, Cm], dim=-1)
    if cache is not None:
        keep = s.d_conv - 1
        tail = xBC[:, -keep:, :] if keep else xBC[:, :0, :]
        if tail.shape[1] < keep:
            cache["conv"].zero_()
        cache["conv"][:, keep - tail.shape[1]:].copy_(tail)
    xBC = F.silu(causal_conv1d(xBC, params["conv_w"], params["conv_b"]))
    xi, Bm, Cm = torch.split(xBC, [d_in, gn, gn], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xh = xi.reshape(B_, L, nh, s.head_dim)
    Bh = Bm.reshape(B_, L, s.n_groups, s.d_state)
    Ch = Cm.reshape(B_, L, s.n_groups, s.d_state)
    # pad L to a chunk multiple: zero dt leaves the state as it was
    pad = (-L) % s.chunk_size
    if pad:
        xh, Bh, Ch = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xh, Bh, Ch))
        dt = F.pad(dt, (0, 0, 0, pad))
    y, state = ssd_ops.ssd(xh, dt, A, Bh, Ch, s.chunk_size)
    if cache is not None:
        cache["ssm"].copy_(state)
    y = y[:, :L] + xh[:, :L].float() * params["D"][None, None, :, None]
    y = y.reshape(B_, L, d_in).to(x.dtype)
    y = _gated_rmsnorm(params["norm_scale"], y, z, cfg.norm_eps)
    return y @ params["out_proj"]


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device=None) -> Params:
    s = cfg.ssm
    conv_dim = cfg.d_inner + 2 * s.n_groups * s.d_state
    return {
        "conv": torch.zeros(batch, s.d_conv - 1, conv_dim, dtype=dtype,
                            device=device),
        "ssm": torch.zeros(batch, cfg.ssm_heads, s.head_dim, s.d_state,
                           dtype=torch.float32, device=device),
    }


def mamba2_decode(params: Params, x: torch.Tensor, cache: Params,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One-token decode.  x: (B, 1, d_model).  Returns (out (B, 1,
    d_model), cache) with the conv and SSM caches written in place."""
    s = cfg.ssm
    B_ = x.shape[0]
    d_in, nh = cfg.d_inner, cfg.ssm_heads
    gn = s.n_groups * s.d_state
    z, xi, Bm, Cm, dt = _split_in_proj(cfg, x[:, 0] @ params["in_proj"])
    xBC = torch.cat([xi, Bm, Cm], dim=-1)
    y_conv, new_conv = conv1d_decode_step(
        cache["conv"].to(xBC.dtype), xBC, params["conv_w"],
        params["conv_b"])
    cache["conv"].copy_(new_conv)
    xi, Bm, Cm = torch.split(F.silu(y_conv), [d_in, gn, gn], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xh = xi.reshape(B_, nh, s.head_dim)
    y, new_ssm = ssd_decode_step(cache["ssm"], xh, dt, A,
                                 Bm.reshape(B_, s.n_groups, s.d_state),
                                 Cm.reshape(B_, s.n_groups, s.d_state))
    cache["ssm"].copy_(new_ssm)
    y = y + xh.float() * params["D"][None, :, None]
    y = y.reshape(B_, d_in).to(x.dtype)
    y = _gated_rmsnorm(params["norm_scale"], y, z, cfg.norm_eps)
    return (y @ params["out_proj"])[:, None, :], cache
