// Mamba2 SSD chunk scan for Hopper (sm_90a): y and the final state of
//
//   h_t = exp(dt_t * A) h_{t-1} + (dt_t x_t) (x) B_t,   y_t = C_t . h_t
//
// per (batch, head), computed chunk by chunk (chunk length Q).  Per chunk:
//   cum   = cumsum(dt * A)                                       (Q,)
//   y     = ((C B^T) o Lmat)(dt x) + exp(cum) o (C state^T)     (Q, P)
//           Lmat[q,k] = exp(cum[q] - cum[k]) where q >= k, else 0
//   state = exp(cum[Q-1]) state
//           + sum_q exp(cum[Q-1] - cum[q]) (dt x)[q] (x) B[q]   (P, N)
// starting from a zero state; y and the final state come out in f32.
// B and C are per group, read through the head -> group map h*G/H.
//
// Replaces the TPU kernel ssd_scan_fwd (body _ssd_kernel) in
// src/repro/kernels/ssd_scan/ssd_scan.py.  What it computes is that
// kernel's: the same cumsum-difference decays, the decay matrix selected
// (not multiplied) by the causal mask, so exp of the positive differences
// above the diagonal never meets a product, the inter-chunk term scaled by
// exp(cum) after the C state^T product, and dt x scaled by the decay to
// the chunk's end before the state update's product.  Its grid is not
// carried over: the TPU walks the chunks as a sequential grid axis with
// the (P, N) state in VMEM scratch and transposes its inputs to
// (Bt, H, L, .) first; here one thread block owns one (b, h), loops over
// the chunks itself with the state in shared memory, and reads the
// model's (Bt, L, H, P) and (Bt, L, G, N) tensors through their strides.
//
// Bound.  Per (b, h, chunk) the products cost about 2Q^2 N (C B^T) +
// 2Q^2 P (the causal half of the intra product) + 4QPN (inter output and
// state update) flops against 4Q(P + 2N/H) bytes, so at mamba2-780m's
// prefill shape (Q = 128, P = 64, N = 128) it is ~1000 flop/byte: bound
// by arithmetic.  This first version does the arithmetic in f32 on the
// CUDA cores (peak 67 TFLOP/s), not on the tensor cores (wgmma, TMA and a
// per-group C B^T shared by the heads of a group are later work).  What
// the design does about it:
//   * register blocking: 256 threads as 16 x 16; a thread holds a 4 x 8
//     block of scores (4 query rows x 8 keys), a 4 x P/16 block of y and a
//     4 x N/16 block of the state update, so each shared-memory load feeds
//     several FMAs;
//   * the chunk's dt x (Q x P), B^T (N x Q) and a 64-row tile of C^T are
//     staged in shared memory once, converted from bf16 on load; the
//     Q x Q score matrix is never whole: it is built 64 query rows at a
//     time (only the key columns at or below the tile's last row), each
//     tile consumed at once by the y products;
//   * the state lives in shared memory across the whole chunk loop (N x
//     (P+1), transposed so y's inter product reads it along P), and each
//     thread updates only the entries it owns, after the chunk's y tiles
//     have read the old state;
//   * cumsum, exp(cum) and the decays to the chunk's end are one warp's
//     shuffle scan per chunk;
//   * row strides are padded (+1, or +4 where rows are read as float4) so
//     the transposing stores and the column reads avoid bank conflicts.
// Shared memory at Q = 128, P = 64, N = 128: 201,984 bytes (opt-in above
// 48 KB), so one block of 8 warps per SM.  Occupancy: the prefill shape
// (Bt = 4, H = 48) is 192 blocks on 132 SMs, 1.45 waves; the server's
// one-row prefill is 48 blocks, a third of the card.  No atomics: every
// output element is written by one thread, in a fixed order, so two
// launches on the same inputs give the same bits.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// never synchronises, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 16 x 16
constexpr int kTileQ = 64;          // query rows per score tile
constexpr int kMaxQ = 128;          // keys per thread: 8 x 16

struct Args {
  const void* x;                    // (Bt, L, H, P)
  const float* dt;                  // (Bt, L, H)
  const float* A;                   // (H,) contiguous
  const void* B;                    // (Bt, L, G, N)
  const void* C;                    // (Bt, L, G, N)
  float* y;                         // (Bt, L, H, P)
  float* state;                     // (Bt, H, P, N) contiguous
  int L, H, G, Q;
  // element strides [batch, seq, head or group]; the last dimension of
  // x, B, C and y is contiguous
  int64_t xs[3], ds[3], bs[3], cs[3], ys[3];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// shared-memory layout, in floats; every float4-read array starts at a
// multiple of 4 floats
struct Smem {
  int tq, ct, x, bt, st, m, dt, cum, w, e, total;
  __host__ __device__ Smem(int Q, int P, int N) {
    tq = Q < kTileQ ? Q : kTileQ;
    ct = 0;                         // C^T tile   [N][tq + 4]
    x = ct + N * (tq + 4);          // dt x       [Q][P]
    bt = x + Q * P;                 // B^T        [N][Q + 1]
    st = bt + N * (Q + 1);          // state^T    [N][P + 1]
    m = st + N * (P + 1);           // scores     [tq][Q + 1]
    dt = m + tq * (Q + 1);          // dt         [Q]
    cum = dt + Q;                   // cumsum(dt A)
    w = cum + Q;                    // exp(cum[Q-1] - cum)
    e = w + Q;                      // exp(cum)
    total = e + Q;
  }
};

// warp 0: cum = cumsum(dt * A) over the chunk, then the decays
__device__ void chunk_decays(const float* s_dt, float A, int Q, int lane,
                             float* s_cum, float* s_w, float* s_e) {
  const int E = (Q + 31) / 32;      // elements per lane, at most 4
  float v[4];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = lane * E + e;
    const float d = (e < E && i < Q) ? s_dt[i] * A : 0.f;
    run += d;
    v[e] = run;
  }
  float tot = run;                  // inclusive scan of the lane totals
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += t;
  }
  const float prefix = tot - run;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = lane * E + e;
    if (e < E && i < Q) s_cum[i] = prefix + v[e];
  }
  __syncwarp();
  const float last = s_cum[Q - 1];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = lane * E + e;
    if (e < E && i < Q) {
      s_w[i] = expf(last - s_cum[i]);
      s_e[i] = expf(s_cum[i]);
    }
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const Args a) {
  static_assert(P % 16 == 0 && P <= 64, "P must be a multiple of 16, <= 64");
  static_assert(N % 16 == 0 && N <= 128, "N must be a multiple of 16, <= 128");
  constexpr int CP = P / 16;        // y columns per thread
  constexpr int CN = N / 16;        // state columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Q = a.Q;
  const Smem lay(Q, P, N);
  const int TQ = lay.tq;
  const int ldc = TQ + 4, ldb = Q + 1, lds = P + 1, ldm = Q + 1;
  float* sCt = smem + lay.ct;
  float* sX = smem + lay.x;
  float* sBt = smem + lay.bt;
  float* sSt = smem + lay.st;
  float* sM = smem + lay.m;
  float* sDt = smem + lay.dt;
  float* sCum = smem + lay.cum;
  float* sW = smem + lay.w;
  float* sE = smem + lay.e;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h * a.G / a.H;      // the reference's head -> group map
  const float A = a.A[h];

  const T* x = static_cast<const T*>(a.x) + b * a.xs[0] + h * a.xs[2];
  const float* dt = a.dt + b * a.ds[0] + h * a.ds[2];
  const T* Bm = static_cast<const T*>(a.B) + b * a.bs[0] + g * a.bs[2];
  const T* Cm = static_cast<const T*>(a.C) + b * a.cs[0] + g * a.cs[2];
  float* y = a.y + b * a.ys[0] + h * a.ys[2];

  for (int i = tid; i < N * lds; i += kThreads) sSt[i] = 0.f;

  const int nc = a.L / Q;
  for (int c = 0; c < nc; ++c) {
    const int64_t l0 = static_cast<int64_t>(c) * Q;
    __syncthreads();                // the previous chunk is done with smem
    for (int i = tid; i < Q; i += kThreads) sDt[i] = dt[(l0 + i) * a.ds[1]];
    __syncthreads();
    if (tid < 32) chunk_decays(sDt, A, Q, tid, sCum, sW, sE);
    for (int i = tid; i < Q * P; i += kThreads) {
      const int k = i / P, p = i % P;
      sX[i] = to_f32(x[(l0 + k) * a.xs[1] + p]) * sDt[k];
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int k = i / N, n = i % N;
      sBt[n * ldb + k] = to_f32(Bm[(l0 + k) * a.bs[1] + n]);
    }

    // y, one tile of TQ query rows at a time
    for (int r0 = 0; r0 < Q; r0 += TQ) {
      const int jn = (r0 + TQ) / 16;  // key columns of 16: keys < r0 + TQ
      for (int i = tid; i < TQ * N; i += kThreads) {
        const int q = i / N, n = i % N;
        sCt[n * ldc + q] = to_f32(Cm[(l0 + r0 + q) * a.cs[1] + n]);
      }
      __syncthreads();
      const bool rows = 4 * ty < TQ;  // rows r0 + 4ty .. r0 + 4ty + 3

      // scores C B^T for those rows and keys tx + 16j, masked and decayed
      if (rows) {
        float s[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 cv =
              *reinterpret_cast<const float4*>(&sCt[n * ldc + 4 * ty]);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          float bv[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            bv[j] = j < jn ? sBt[n * ldb + tx + 16 * j] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) s[i][j] = fmaf(cr[i], bv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = r0 + 4 * ty + i;
          const float cq = sCum[q];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j >= jn) continue;
            const int k = tx + 16 * j;
            // select, never multiply by a mask: above the diagonal the
            // exponent is positive and may overflow
            sM[(4 * ty + i) * ldm + k] =
                k <= q ? s[i][j] * expf(cq - sCum[k]) : 0.f;
          }
        }
      }
      __syncthreads();

      // y = scores (dt x) + exp(cum) (C state^T), columns tx + 16cc
      if (rows) {
        float acc[4][CP], inter[4][CP];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int cc = 0; cc < CP; ++cc) acc[i][cc] = inter[i][cc] = 0.f;
        const int kmax = r0 + TQ;
#pragma unroll 4
        for (int k = 0; k < kmax; ++k) {
          float pr[4], xv[CP];
#pragma unroll
          for (int i = 0; i < 4; ++i) pr[i] = sM[(4 * ty + i) * ldm + k];
#pragma unroll
          for (int cc = 0; cc < CP; ++cc) xv[cc] = sX[k * P + tx + 16 * cc];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int cc = 0; cc < CP; ++cc)
              acc[i][cc] = fmaf(pr[i], xv[cc], acc[i][cc]);
        }
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 cv =
              *reinterpret_cast<const float4*>(&sCt[n * ldc + 4 * ty]);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          float sv[CP];
#pragma unroll
          for (int cc = 0; cc < CP; ++cc) sv[cc] = sSt[n * lds + tx + 16 * cc];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int cc = 0; cc < CP; ++cc)
              inter[i][cc] = fmaf(cr[i], sv[cc], inter[i][cc]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = r0 + 4 * ty + i;
          const float eq = sE[q];
          float* yr = y + (l0 + q) * a.ys[1];
#pragma unroll
          for (int cc = 0; cc < CP; ++cc)
            yr[tx + 16 * cc] = acc[i][cc] + inter[i][cc] * eq;
        }
      }
      __syncthreads();              // the tile's C and scores are consumed
    }

    // state = exp(cum[Q-1]) state + sum_k w[k] (dt x)[k] (x) B[k], rows
    // p = 4ty + i, columns n = tx + 16j; every y tile has read the old
    // state, and each thread rewrites only its own entries
    if (4 * ty < P) {
      float upd[4][CN];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) upd[i][j] = 0.f;
#pragma unroll 4
      for (int k = 0; k < Q; ++k) {
        const float4 xv = *reinterpret_cast<const float4*>(&sX[k * P + 4 * ty]);
        const float wk = sW[k];
        const float xr[4] = {xv.x * wk, xv.y * wk, xv.z * wk, xv.w * wk};
        float bv[CN];
#pragma unroll
        for (int j = 0; j < CN; ++j) bv[j] = sBt[(tx + 16 * j) * ldb + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) upd[i][j] = fmaf(xr[i], bv[j], upd[i][j]);
      }
      const float decay = expf(sCum[Q - 1]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          float* sv = &sSt[(tx + 16 * j) * lds + 4 * ty + i];
          *sv = decay * *sv + upd[i][j];
        }
    }
  }

  __syncthreads();
  float* out = a.state + (static_cast<int64_t>(b) * a.H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    out[i] = sSt[n * lds + p];
  }
}

template <typename T, int P, int N>
int launch(const Args& a, int Bt, cudaStream_t stream) {
  const int bytes = Smem(a.Q, P, N).total * static_cast<int>(sizeof(float));
  // above 48 KB only after opting in; once per instantiation, at the
  // largest chunk (Q = 128), which every smaller chunk fits under
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_scan_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem(kMaxQ, P, N).total * static_cast<int>(sizeof(float)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(a.H, Bt);
  ssd_scan_kernel<T, P, N><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int dispatch_n(int N, const Args& a, int Bt, cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, P, 16>(a, Bt, s);
    case 32: return launch<T, P, 32>(a, Bt, s);
    case 64: return launch<T, P, 64>(a, Bt, s);
    case 128: return launch<T, P, 128>(a, Bt, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_p(int P, int N, const Args& a, int Bt, cudaStream_t s) {
  switch (P) {
    case 32: return dispatch_n<T, 32>(N, a, Bt, s);
    case 64: return dispatch_n<T, 64>(N, a, Bt, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype of x, B and C: 0 float32, 1 bfloat16 (dt and A are float32).
// strides: 15 element strides, [batch, seq, head or group] of x, dt, B, C
// and y in that order.  Chunks Q: 16, 32, 64, 128 (L a multiple of Q);
// P: 32, 64; N: 16, 32, 64, 128; G divides H.
extern "C" int ssd_scan_fwd_launch(
    int dtype, int P, int N, int Q, const void* x, const float* dt,
    const float* A, const void* B, const void* C, float* y, float* state,
    int Bt, int L, int H, int G, const long long* strides, void* stream) {
  if (Q != 16 && Q != 32 && Q != 64 && Q != kMaxQ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (G <= 0 || H % G != 0 || L % Q != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Bt == 0 || H == 0) return 0;
  Args a;
  a.x = x; a.dt = dt; a.A = A; a.B = B; a.C = C; a.y = y; a.state = state;
  a.L = L; a.H = H; a.G = G; a.Q = Q;
  for (int i = 0; i < 3; ++i) {
    a.xs[i] = strides[i];
    a.ds[i] = strides[3 + i];
    a.bs[i] = strides[6 + i];
    a.cs[i] = strides[9 + i];
    a.ys[i] = strides[12 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_p<float>(P, N, a, Bt, s);
  if (dtype == 1) return dispatch_p<__nv_bfloat16>(P, N, a, Bt, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
