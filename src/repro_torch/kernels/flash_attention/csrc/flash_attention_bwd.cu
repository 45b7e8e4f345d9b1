// Flash-attention backward for Hopper (sm_90a): the two kernels of the
// flash VJP, dQ and dK/dV, for causal (or full) attention with optional
// sliding window, GQA and logit softcap.
//
//   raw_ij = scale * (q_i . k_j)          (scaled AFTER the product)
//   s_ij   = cap*tanh(raw_ij/cap)          (or raw_ij without a cap)
//   jac_ij = 1 - (s_ij/cap)^2              (or 1)
//   p_ij   = exp(s_ij - lse_i)             0 where masked
//   dp_ij  = dout_i . v_j
//   ds_ij  = p_ij * (dp_ij - delta_i) * jac_ij
//   dq_i   = scale * sum_j ds_ij k_j
//   dk_j   = scale * sum_{h in group, i} ds_ij q_i
//   dv_j   =         sum_{h in group, i} p_ij dout_i
//
// masked where j >= Sk, i >= Sq, j > i (causal) or i - j >= window.
// delta_i = rowsum(dout_i * out_i) comes from the caller (one plain
// reduction), as the reference computes it outside its kernels.
//
// Replaces the TPU kernel flash_attention_bwd of
// src/repro/kernels/flash_attention/flash_attention.py: its dQ
// pallas_call (body _fa_bwd_dq_kernel) and its dK/dV pallas_call (body
// _fa_bwd_dkv_kernel).  The numerics are those kernels': p is recomputed
// from the forward's log-sum-exp (no S^2 residuals), the raw product is
// scaled after the dot as in _p_block, the softcap jacobian is applied
// analytically, and the causal/window tile skip is the reference's
// (it only drops exact zeros).  The grids are not carried over: the TPU
// walks the kv blocks (dQ) or the q blocks (dK/dV) as a sequential grid
// axis with f32 accumulators in VMEM scratch; here
//   * dQ: one thread block owns a (b, h, query tile) and loops over the
//     kv tiles itself, dQ accumulating in registers;
//   * dK/dV: one thread block owns a (b, kv head g, kv tile) and loops
//     over the query tiles and over the H/Hkv query heads of the group,
//     dK and dV accumulating in registers.  The group sum stays inside
//     the block: no atomics, no second pass, so dK and dV are
//     deterministic (two launches give the same bits).
//
// Bound.  At the training shape (S = 512, D = 64) each kernel does a few
// causal products of ~2*S*S*D/2 flops per (b, h) against ~S*D*4 bytes
// per tensor: ~100 flop/byte, bound by arithmetic.  This first version
// computes in f32 on the CUDA cores (67 TFLOP/s), not on the tensor
// cores (mma.sync / wgmma, TMA and pipelining are later work).  What the
// design does about it, as in the forward kernel beside it:
//   * register blocking: 4*T threads as (T/4) x 16 for a T x T tile; a
//     thread holds a 4 x T/16 block of the tile's products and a
//     4 x D/16 block of its accumulator, so each shared-memory load
//     feeds two or more FMAs;
//   * operands are staged in shared memory in f32 (converted from bf16
//     on load), transposed where a float4 read of 4 rows is wanted, with
//     padded row strides against bank conflicts;
//   * tiles wholly above the causal diagonal, or wholly before the
//     window, are skipped;
//   * the ragged tail is masked in place (nothing padded or copied);
//     out-of-range rows are staged as zeros;
//   * every tensor is read and written through strides (last dimension
//     contiguous), so the model's (B, S, H, D) layout needs no copy and
//     each gradient takes its input's layout.
// Tiles: T = 64 up to D = 128, T = 32 at D = 256 (shared memory stays
// under 227 KB; above 48 KB the launcher opts in).
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// never synchronises, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;                 // (B, H, Sq) contiguous
  const float* delta;               // (B, H, Sq) contiguous
  void* dq;
  void* dk;
  void* dv;
  int H, Hkv, Sq, Sk;
  // element strides: [batch, head, seq]; the last dimension is contiguous
  int64_t qs[3], ks[3], vs[3], os[3], dqs[3], dks[3], dvs[3];
  float scale, cap;
  int causal, window;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
__host__ __device__ constexpr int tile() { return D <= 128 ? 64 : 32; }

// p and the scaled ds of one (query i, key j) pair; the reference's
// _p_block followed by its ds line, scale folded into ds.
__device__ __forceinline__ void p_ds(const Args& a, int qi, int kj, float s,
                                     float dp, float lse, float delta,
                                     float* p, float* ds) {
  const float raw = s * a.scale;
  float sc = raw, jac = 1.f;
  if (a.cap > 0.f) {
    sc = a.cap * tanhf(raw / a.cap);
    const float t = sc / a.cap;
    jac = 1.f - t * t;
  }
  bool keep = qi < a.Sq && kj < a.Sk;
  if (a.causal) keep = keep && qi >= kj;
  if (a.window > 0) keep = keep && (qi - kj) < a.window;
  const float pv = keep ? expf(sc - lse) : 0.f;
  *p = pv;
  *ds = pv * (dp - delta) * jac * a.scale;
}

// the reference's tile-level skip: a kv tile wholly after the query
// tile's last row (causal), or wholly before its first row's window
__device__ __forceinline__ bool skip_tile(const Args& a, int q0, int k0,
                                          int T) {
  if (a.causal && k0 > q0 + T - 1) return true;
  if (a.window > 0 && k0 + T - 1 < q0 - a.window + 1) return true;
  return false;
}

// ---------------------------------------------------------------------------
// dQ: one block per (b, h, T-row query tile), looping over kv tiles
// ---------------------------------------------------------------------------
template <int D>
__host__ __device__ constexpr int dq_smem_floats() {
  constexpr int T = tile<D>();
  return 2 * D * (T + 4) + 2 * D * (T + 1) + T * (T + 1);
}

template <typename T_, int D>
__global__ void __launch_bounds__(4 * tile<D>())
flash_bwd_dq_kernel(const Args a) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int T = tile<D>();
  constexpr int NT = 4 * T;         // (T/4) row groups x 16 lanes
  constexpr int KJ = T / 16;        // keys per thread
  constexpr int C = D / 16;         // dq columns per thread
  constexpr int QS = T + 4;         // q^T / dout^T row stride (float4)
  constexpr int KS = T + 1;         // K^T / V^T row stride
  constexpr int PS = T + 1;         // dS row stride
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qT = smem;                 // [D][QS]
  float* oT = qT + D * QS;          // [D][QS]  dout^T
  float* kT = oT + D * QS;          // [D][KS]
  float* vT = kT + D * KS;          // [D][KS]
  float* dsS = vT + D * KS;         // [T][PS]  scale * dS

  const int tid = threadIdx.x;
  const int tx = tid & 15;          // key / column group
  const int ty = tid >> 4;          // query rows 4ty .. 4ty+3
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h * a.Hkv / a.H;   // the reference's head -> kv-head map
  const int q0 = blockIdx.x * T;

  const T_* q = static_cast<const T_*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T_* o = static_cast<const T_*>(a.dout) + b * a.os[0] + h * a.os[1];
  const T_* k = static_cast<const T_*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const T_* v = static_cast<const T_*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  const int64_t row = ((int64_t)b * a.H + h) * a.Sq;

  for (int idx = tid; idx < T * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int qi = q0 + r;
    float qx = 0.f, ox = 0.f;
    if (qi < a.Sq) {
      qx = to_f32(q[qi * a.qs[2] + d]);
      ox = to_f32(o[qi * a.os[2] + d]);
    }
    qT[d * QS + r] = qx;
    oT[d * QS + r] = ox;
  }
  float lse[4], dlt[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    lse[i] = qi < a.Sq ? a.lse[row + qi] : 0.f;
    dlt[i] = qi < a.Sq ? a.delta[row + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const int nk = (a.Sk + T - 1) / T;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * T;
    if (a.causal && k0 > q0 + T - 1) break;
    if (skip_tile(a, q0, k0, T)) continue;

    __syncthreads();                // previous tile's readers are done
    for (int idx = tid; idx < T * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      const int kj = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kj < a.Sk) {
        kx = to_f32(k[kj * a.ks[2] + d]);
        vx = to_f32(v[kj * a.vs[2] + d]);
      }
      kT[d * KS + r] = kx;
      vT[d * KS + r] = vx;
    }
    __syncthreads();

    // S = q K^T and dP = dout V^T for rows 4ty+i, keys tx + 16j
    float s[4][KJ], dp[4][KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&qT[d * QS + 4 * ty]);
      const float4 ov = *reinterpret_cast<const float4*>(&oT[d * QS + 4 * ty]);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      const float orow[4] = {ov.x, ov.y, ov.z, ov.w};
      float kk[KJ], vv[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        kk[j] = kT[d * KS + tx + 16 * j];
        vv[j] = vT[d * KS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = fmaf(qr[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(orow[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        float p, ds;
        p_ds(a, q0 + 4 * ty + i, k0 + tx + 16 * j, s[i][j], dp[i][j],
             lse[i], dlt[i], &p, &ds);
        dsS[(4 * ty + i) * PS + tx + 16 * j] = ds;
      }
    __syncthreads();

    // dq += (scale dS) K for rows 4ty+i, columns tx + 16c
#pragma unroll 4
    for (int j = 0; j < T; ++j) {
      float dsv[4], kc[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dsS[(4 * ty + i) * PS + j];
#pragma unroll
      for (int c = 0; c < C; ++c) kc[c] = kT[(tx + 16 * c) * KS + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(dsv[i], kc[c], acc[i][c]);
    }
  }

  T_* dq = static_cast<T_*>(a.dq) + b * a.dqs[0] + h * a.dqs[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < C; ++c)
      from_f32(&dq[qi * a.dqs[2] + tx + 16 * c], acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (b, kv head g, T-row kv tile), looping over query
// tiles and the H/Hkv heads of the group
// ---------------------------------------------------------------------------
template <int D>
__host__ __device__ constexpr int dkv_smem_floats() {
  constexpr int T = tile<D>();
  return 2 * D * (T + 4) + 2 * D * (T + 1) + 2 * T * (T + 1) + 2 * T;
}

template <typename T_, int D>
__global__ void __launch_bounds__(4 * tile<D>())
flash_bwd_dkv_kernel(const Args a) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int T = tile<D>();
  constexpr int NT = 4 * T;         // (T/4) key groups x 16 lanes
  constexpr int QJ = T / 16;        // queries per thread
  constexpr int C = D / 16;         // dk/dv columns per thread
  constexpr int KS = T + 4;         // K^T / V^T row stride (float4)
  constexpr int QS = T + 1;         // q^T / dout^T row stride
  constexpr int PS = T + 1;         // P^T / dS^T row stride
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* kT = smem;                 // [D][KS]
  float* vT = kT + D * KS;          // [D][KS]
  float* qT = vT + D * KS;          // [D][QS]
  float* oT = qT + D * QS;          // [D][QS]  dout^T
  float* pS = oT + D * QS;          // [T keys][PS]  P^T
  float* dsS = pS + T * PS;         // [T keys][PS]  scale * dS^T
  float* lseS = dsS + T * PS;       // [T]
  float* dltS = lseS + T;           // [T]

  const int tid = threadIdx.x;
  const int tx = tid & 15;          // query / column group
  const int ty = tid >> 4;          // keys 4ty .. 4ty+3
  const int b = blockIdx.z;
  const int g = blockIdx.y;
  const int rep = a.H / a.Hkv;
  const int k0 = blockIdx.x * T;

  const T_* k = static_cast<const T_*>(a.k) + b * a.ks[0] + g * a.ks[1];
  const T_* v = static_cast<const T_*>(a.v) + b * a.vs[0] + g * a.vs[1];
  for (int idx = tid; idx < T * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int kj = k0 + r;
    float kx = 0.f, vx = 0.f;
    if (kj < a.Sk) {
      kx = to_f32(k[kj * a.ks[2] + d]);
      vx = to_f32(v[kj * a.vs[2] + d]);
    }
    kT[d * KS + r] = kx;
    vT[d * KS + r] = vx;
  }

  float dk[4][C], dv[4][C];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < C; ++c) dk[j][c] = dv[j][c] = 0.f;

  const int nq = (a.Sq + T - 1) / T;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * T;
    if (skip_tile(a, q0, k0, T)) continue;
    for (int r = 0; r < rep; ++r) {
      const int h = g * rep + r;
      const T_* q = static_cast<const T_*>(a.q) + b * a.qs[0] + h * a.qs[1];
      const T_* o =
          static_cast<const T_*>(a.dout) + b * a.os[0] + h * a.os[1];
      const int64_t row = ((int64_t)b * a.H + h) * a.Sq;

      __syncthreads();              // previous head's readers are done
      for (int idx = tid; idx < T * D; idx += NT) {
        const int i = idx / D, d = idx % D;
        const int qi = q0 + i;
        float qx = 0.f, ox = 0.f;
        if (qi < a.Sq) {
          qx = to_f32(q[qi * a.qs[2] + d]);
          ox = to_f32(o[qi * a.os[2] + d]);
        }
        qT[d * QS + i] = qx;
        oT[d * QS + i] = ox;
      }
      for (int i = tid; i < T; i += NT) {
        const int qi = q0 + i;
        lseS[i] = qi < a.Sq ? a.lse[row + qi] : 0.f;
        dltS[i] = qi < a.Sq ? a.delta[row + qi] : 0.f;
      }
      __syncthreads();

      // S^T = K q^T and dP^T = V dout^T for keys 4ty+jj, queries tx + 16i
      float s[4][QJ], dp[4][QJ];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < QJ; ++i) s[jj][i] = dp[jj][i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 kv4 =
            *reinterpret_cast<const float4*>(&kT[d * KS + 4 * ty]);
        const float4 vv4 =
            *reinterpret_cast<const float4*>(&vT[d * KS + 4 * ty]);
        const float kr[4] = {kv4.x, kv4.y, kv4.z, kv4.w};
        const float vr[4] = {vv4.x, vv4.y, vv4.z, vv4.w};
        float qq[QJ], oo[QJ];
#pragma unroll
        for (int i = 0; i < QJ; ++i) {
          qq[i] = qT[d * QS + tx + 16 * i];
          oo[i] = oT[d * QS + tx + 16 * i];
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int i = 0; i < QJ; ++i) {
            s[jj][i] = fmaf(qq[i], kr[jj], s[jj][i]);
            dp[jj][i] = fmaf(oo[i], vr[jj], dp[jj][i]);
          }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < QJ; ++i) {
          const int il = tx + 16 * i;
          float p, ds;
          p_ds(a, q0 + il, k0 + 4 * ty + jj, s[jj][i], dp[jj][i], lseS[il],
               dltS[il], &p, &ds);
          pS[(4 * ty + jj) * PS + il] = p;
          dsS[(4 * ty + jj) * PS + il] = ds;
        }
      __syncthreads();

      // dv += P^T dout and dk += (scale dS)^T q for keys 4ty+jj,
      // columns tx + 16c
#pragma unroll 4
      for (int i = 0; i < T; ++i) {
        float pv[4], dsv[4], oc[C], qc[C];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          pv[jj] = pS[(4 * ty + jj) * PS + i];
          dsv[jj] = dsS[(4 * ty + jj) * PS + i];
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          oc[c] = oT[(tx + 16 * c) * QS + i];
          qc[c] = qT[(tx + 16 * c) * QS + i];
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            dv[jj][c] = fmaf(pv[jj], oc[c], dv[jj][c]);
            dk[jj][c] = fmaf(dsv[jj], qc[c], dk[jj][c]);
          }
      }
    }
  }

  T_* dkp = static_cast<T_*>(a.dk) + b * a.dks[0] + g * a.dks[1];
  T_* dvp = static_cast<T_*>(a.dv) + b * a.dvs[0] + g * a.dvs[1];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int kj = k0 + 4 * ty + jj;
    if (kj >= a.Sk) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      from_f32(&dkp[kj * a.dks[2] + tx + 16 * c], dk[jj][c]);
      from_f32(&dvp[kj * a.dvs[2] + tx + 16 * c], dv[jj][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <typename T_, int D>
int launch_dq(const Args& a, int B, cudaStream_t stream) {
  constexpr int T = tile<D>();
  constexpr int bytes = dq_smem_floats<D>() * sizeof(float);
  // above 48 KB only after opting in; once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T_, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.Sq + T - 1) / T, a.H, B);
  flash_bwd_dq_kernel<T_, D><<<grid, 4 * T, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T_, int D>
int launch_dkv(const Args& a, int B, cudaStream_t stream) {
  constexpr int T = tile<D>();
  constexpr int bytes = dkv_smem_floats<D>() * sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T_, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.Sk + T - 1) / T, a.Hkv, B);
  flash_bwd_dkv_kernel<T_, D><<<grid, 4 * T, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDq, typename T_>
int dispatch_d(int D, const Args& a, int B, cudaStream_t s) {
  switch (D) {
    case 16: return kDq ? launch_dq<T_, 16>(a, B, s) : launch_dkv<T_, 16>(a, B, s);
    case 32: return kDq ? launch_dq<T_, 32>(a, B, s) : launch_dkv<T_, 32>(a, B, s);
    case 64: return kDq ? launch_dq<T_, 64>(a, B, s) : launch_dkv<T_, 64>(a, B, s);
    case 128: return kDq ? launch_dq<T_, 128>(a, B, s) : launch_dkv<T_, 128>(a, B, s);
    case 256: return kDq ? launch_dq<T_, 256>(a, B, s) : launch_dkv<T_, 256>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kDq>
int launch(int dtype, int D, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* delta, void* dq,
           void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk,
           const long long* strides, float scale, float cap, int causal,
           int window, void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.H = H; a.Hkv = Hkv; a.Sq = Sq; a.Sk = Sk;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
    a.dqs[i] = strides[12 + i];
    a.dks[i] = strides[15 + i];
    a.dvs[i] = strides[18 + i];
  }
  a.scale = scale; a.cap = cap; a.causal = causal; a.window = window;
  // an empty grid is no launch (dq of Sq = 0, dk/dv of Sk = 0)
  if (B == 0 || (kDq ? (Sq == 0 || H == 0) : (Sk == 0 || Hkv == 0)))
    return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<kDq, float>(D, a, B, s);
  if (dtype == 1) return dispatch_d<kDq, __nv_bfloat16>(D, a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  strides: 21 element strides, [batch,
// head, seq] of q, k, v, dout, dq, dk and dv in that order.  lse and
// delta are (B, H, Sq) contiguous f32.  Head dims: 16, 32, 64, 128, 256.
// The dQ launch writes dq only; the dK/dV launch writes dk and dv only.
extern "C" int flash_attention_bwd_dq_launch(
    int dtype, int D, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, void* dq,
    int B, int H, int Hkv, int Sq, int Sk, const long long* strides,
    float scale, float cap, int causal, int window, void* stream) {
  return launch<true>(dtype, D, q, k, v, dout, lse, delta, dq, nullptr,
                      nullptr, B, H, Hkv, Sq, Sk, strides, scale, cap,
                      causal, window, stream);
}

extern "C" int flash_attention_bwd_dkv_launch(
    int dtype, int D, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, void* dk,
    void* dv, int B, int H, int Hkv, int Sq, int Sk,
    const long long* strides, float scale, float cap, int causal,
    int window, void* stream) {
  return launch<false>(dtype, D, q, k, v, dout, lse, delta, nullptr, dk, dv,
                       B, H, Hkv, Sq, Sk, strides, scale, cap, causal, window,
                       stream);
}
