// Flash-attention forward for Hopper (sm_90a): causal (or full) attention
// with an online softmax, optional sliding window, GQA and logit softcap.
//
//   out[b,i,h,:] = sum_j softmax_j(s_ij) v[b,j,g(h),:]      g(h) = h*Hkv/H
//   s_ij = cap*tanh((scale*q_i).k_j / cap)   (or without the cap)
//   masked where j >= Sk, j > i (causal) or i - j >= window (window > 0)
//   lse[b,h,i] = m_i + log(l_i)
//
// Replaces the TPU kernel flash_attention_fwd (body _fa_kernel) in
// src/repro/kernels/flash_attention/flash_attention.py.  What it computes
// is that kernel's, numerics included: q is scaled in f32 before the
// product, masked logits are -2e38 (not -inf), m_safe and corr guard rows
// whose logits are all masked so far, l is clamped to 1e-30, and such a
// row's lse is 0 + log(l).  Its grid is not carried over: the TPU walks
// the kv blocks as a sequential grid axis with the (m, l, acc) state in
// VMEM scratch; here one thread block owns a (b, h, 64-row query tile)
// and loops over 64-row key/value tiles itself, with that state in
// registers.
//
// Bound.  Per (b, h) the causal product costs ~2*S*S*D flops against
// ~4*S*D bytes of q, k, v and out, so at the serving shapes (S = 512,
// D = 64) it is ~100 flop/byte: bound by arithmetic, not by memory.
// This first version does the arithmetic in f32 on the CUDA cores (peak
// 67 TFLOP/s), not on the tensor cores (mma.sync / wgmma, TMA and
// pipelining are later work), so its floor is the f32 rate.  What the
// design does about it:
//   * register blocking: 256 threads as 16 x 16; each thread holds a 4 x 4
//     block of logits (4 query rows x 4 keys) and a 4 x D/16 block of the
//     output accumulator, so each shared-memory load feeds 2 FMAs (QK^T)
//     or more (PV) instead of one;
//   * q (scaled, f32), K^T and V tiles are staged in shared memory once
//     per block / per kv tile, converted from bf16 on load; row strides
//     are padded so the transposing stores and the column reads avoid
//     bank conflicts;
//   * row max and row sum of the online softmax are butterfly shuffles
//     within the 16 lanes that share a query row group: no shared memory,
//     and every lane ends with the same value;
//   * kv tiles wholly above the causal diagonal, or wholly before the
//     window, are skipped, so a causal pass does about half the work;
//   * the ragged tail is masked in place: nothing is padded or copied,
//     and out-of-range K/V rows are staged as zeros so 0 * garbage never
//     reaches the accumulator;
//   * q, k, v and out are read and written through strides (last
//     dimension contiguous), so the model's (B, S, H, D) layout needs no
//     transposed copy.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// never synchronises, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // keys per kv tile
constexpr int kThreads = 256;       // 16 x 16
constexpr int kQT = kBQ + 4;        // q^T row stride (float4 reads)
constexpr int kKT = kBK + 1;        // K^T row stride (conflict-free stores)
constexpr int kPS = kBK + 1;        // P row stride
constexpr float kNegInf = -2.0e38f; // the reference's masked logit

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;                       // (B, H, Sq) contiguous
  int H, Hkv, Sq, Sk;
  // element strides: [batch, head, seq]; the last dimension is contiguous
  int64_t qs[3], ks[3], vs[3], os[3];
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
constexpr int smem_floats() {
  return D * kQT + D * kKT + kBK * D + kBQ * kPS;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Args a) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int C = D / 16;         // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qT = smem;                 // [D][kQT]  scale * q, transposed
  float* kT = qT + D * kQT;         // [D][kKT]  K tile, transposed
  float* vS = kT + D * kKT;         // [kBK][D]  V tile
  float* pS = vS + kBK * D;         // [kBQ][kPS] probabilities

  const int tid = threadIdx.x;
  const int tx = tid & 15;          // key / column group
  const int ty = tid >> 4;          // query row group: rows 4ty .. 4ty+3
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h * a.Hkv / a.H;   // the reference's head -> kv-head map
  const int q0 = blockIdx.x * kBQ;

  const T* q = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[1];

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int qi = q0 + r;
    float x = 0.f;
    if (qi < a.Sq) x = to_f32(q[qi * a.qs[2] + d]) * a.scale;
    qT[d * kQT + r] = x;
  }

  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const int q_last = q0 + kBQ - 1;
  const int nk = (a.Sk + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    // tile-level skip, as the reference's: no tile wholly after the last
    // query row (causal) or wholly before the first row's window
    if (a.causal && k0 > q_last) break;
    if (a.window > 0 && k0 + kBK - 1 < q0 - a.window + 1) continue;

    __syncthreads();                // previous tile's readers are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const int kj = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kj < a.Sk) {
        kx = to_f32(k[kj * a.ks[2] + d]);
        vx = to_f32(v[kj * a.vs[2] + d]);
      }
      kT[d * kKT + r] = kx;
      vS[r * D + d] = vx;
    }
    __syncthreads();

    // S = (scale q) K^T for rows 4ty+i, keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&qT[d * kQT + 4 * ty]);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kT[d * kKT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qr[i], kv[j], s[i][j]);
    }

    // softcap, mask, online softmax
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      bool ok[4];
      float mb = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j];
        if (a.cap > 0.f) x = a.cap * tanhf(x / a.cap);
        bool keep = kj < a.Sk;
        if (a.causal) keep = keep && qi >= kj;
        if (a.window > 0) keep = keep && (qi - kj) < a.window;
        ok[j] = keep;
        s[i][j] = keep ? x : kNegInf;
        mb = fmaxf(mb, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      const float m_new = fmaxf(m[i], mb);
      const float m_safe = m_new == kNegInf ? 0.f : m_new;
      const float corr = m[i] == kNegInf ? 0.f : expf(m[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_safe) : 0.f;
        pS[(4 * ty + i) * kPS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P V for rows 4ty+i, columns tx + 16c
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[4], vv[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = pS[(4 * ty + i) * kPS + j];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = vS[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

  T* out = static_cast<T*>(a.out) + b * a.os[0] + h * a.os[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= a.Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c)
      from_f32(&out[qi * a.os[2] + tx + 16 * c], acc[i][c] / li);
    if (tx == 0) {
      const float mi = m[i] == kNegInf ? 0.f : m[i];
      a.lse[((int64_t)b * a.H + h) * a.Sq + qi] = mi + logf(li);
    }
  }
}

template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * sizeof(float);
  // above 48 KB only after opting in; once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const Args& a, int B, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, B, stream);
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    case 256: return launch<T, 256>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  strides: 12 element strides, [batch,
// head, seq] of q, k, v and out in that order.  Head dims: 16, 32, 64,
// 128, 256.
extern "C" int flash_attention_fwd_launch(
    int dtype, int D, const void* q, const void* k, const void* v, void* out,
    float* lse, int B, int H, int Hkv, int Sq, int Sk,
    const long long* strides, float scale, float cap, int causal, int window,
    void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.out = out; a.lse = lse;
  a.H = H; a.Hkv = Hkv; a.Sq = Sq; a.Sk = Sk;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.scale = scale; a.cap = cap; a.causal = causal; a.window = window;
  if (Sq == 0 || B == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(D, a, B, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(D, a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
