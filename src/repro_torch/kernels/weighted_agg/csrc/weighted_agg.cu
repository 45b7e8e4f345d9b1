// Weighted aggregation over a flat parameter buffer, for Hopper (sm_90a).
//
//   out[e] = coefs[0] * g[e] + sum_{c < C} coefs[c + 1] * rows[r(c)][e]
//   r(c)   = cids ? cids[c] : c
//
// With C = 1 and coefs = [beta, 1 - beta] this is the paper's eq. (3)
// blend of the global model with one uploaded client model; with C = M it
// is the FedAvg round, eq. (2).
//
// Replaces the TPU kernel weighted_agg_flat2d (bodies _blend_kernel_2d and
// _agg_kernel_2d) in src/repro/kernels/weighted_agg/weighted_agg.py, and
// the 1-D weighted_agg_flat (_agg_kernel) in the same file: both layouts
// are this one kernel here.
//
// Bound: device-memory bytes.  Each element costs 2(C+1) flops against
// (C+2) loads and stores of 4 (f32) or 2 (bf16) bytes, far below the
// ~20 flop/byte an H100 needs before arithmetic could matter.  So the
// design only has to move each byte once, at full rate:
//   * one grid-stride pass; every input element is read once and every
//     output element written once (no zero padding to tiles, no staging
//     copy of gathered rows: with `cids` the kernel reads fleet rows in
//     place);
//   * 16-byte loads and stores per thread (float4, or 8 bf16) when the
//     pointers and the row stride allow it, neighbouring threads on
//     neighbouring addresses; the client loop is unrolled so several
//     rows' loads are in flight at once;
//   * the ragged end of n is a masked scalar tail, not padding;
//   * coefficients are a device array, so a blend needs no host sync,
//     and C is a runtime argument (no padding of C to a power of two).
// Accumulation is f32 (fmaf, clients in order c = 0..C-1); bf16 storage
// converts only through the cuda_bf16 intrinsics, rounding to nearest
// even as the reference's astype does.
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// never synchronises, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// The grid covers the buffer with one chunk per thread and the hardware's
// block scheduler balances the last wave.  Capping the grid at one
// resident wave (8 blocks of 256 per SM) and striding the rest ran the
// FedAvg round (C = 100, n = 1,663,370) 17% slower on an H100 (PERF.md,
// "Launch configuration").  The grid-stride loop keeps any n correct.
constexpr int64_t kMaxBlocks = 0x7fffffff;

// -- loads and stores of V consecutive elements as f32 ---------------------
template <typename T, int V>
struct Access;

template <>
struct Access<float, 1> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    p[0] = v[0];
  }
};

template <>
struct Access<__nv_bfloat16, 1> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* v) {
    v[0] = __bfloat162float(p[0]);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* v) {
    p[0] = __float2bfloat16(v[0]);
  }
};

template <>
struct Access<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Access<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = x;
  }
};

template <typename T>
struct VecWidth;
template <>
struct VecWidth<float> {
  static constexpr int value = 4;
};
template <>
struct VecWidth<__nv_bfloat16> {
  static constexpr int value = 8;
};

// row of client c; an out-of-range cid traps rather than reading memory
// that does not belong to the fleet buffer
template <typename T>
__device__ __forceinline__ const T* client_row(const T* rows,
                                               int64_t row_stride,
                                               int64_t num_rows,
                                               const int32_t* cids, int c) {
  const int64_t r = cids ? static_cast<int64_t>(__ldg(cids + c))
                         : static_cast<int64_t>(c);
  if (r < 0 || r >= num_rows) __trap();
  return rows + r * row_stride;
}

// out[e .. e+V) for one V-wide chunk starting at element e
template <typename T, int V>
__device__ __forceinline__ void mac_chunk(const T* __restrict__ g,
                                          const T* __restrict__ rows,
                                          int64_t row_stride,
                                          int64_t num_rows,
                                          const int32_t* __restrict__ cids,
                                          int C,
                                          const float* __restrict__ coefs,
                                          T* __restrict__ out, int64_t e) {
  float acc[V];
  float w[V];
  Access<T, V>::load(g + e, acc);
  const float c0 = __ldg(coefs);
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] *= c0;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const T* r = client_row(rows, row_stride, num_rows, cids, c);
    const float k = __ldg(coefs + c + 1);
    Access<T, V>::load(r + e, w);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = fmaf(k, w[i], acc[i]);
  }
  Access<T, V>::store(out + e, acc);
}

template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
    weighted_agg_kernel(const T* __restrict__ g, const T* __restrict__ rows,
                        int64_t row_stride, int64_t num_rows,
                        const int32_t* __restrict__ cids, int C,
                        const float* __restrict__ coefs, T* __restrict__ out,
                        int64_t n) {
  constexpr int V = kVector ? VecWidth<T>::value : 1;
  const int64_t nvec = n / V;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = tid; v < nvec; v += step) {
    mac_chunk<T, V>(g, rows, row_stride, num_rows, cids, C, coefs, out,
                    v * V);
  }
  if (kVector) {
    // masked scalar tail: the last n mod V elements
    const int64_t e = nvec * V + tid;
    if (e < n) {
      mac_chunk<T, 1>(g, rows, row_stride, num_rows, cids, C, coefs, out,
                      e);
    }
  }
}

template <typename T>
void launch(const void* g, const void* rows, int64_t row_stride,
            int64_t num_rows, const void* cids, int C, const void* coefs,
            void* out, int64_t n, bool vectorized, cudaStream_t stream) {
  const int64_t work = vectorized ? n / VecWidth<T>::value + 1 : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const T* gp = static_cast<const T*>(g);
  const T* rp = static_cast<const T*>(rows);
  const int32_t* cp = static_cast<const int32_t*>(cids);
  const float* kp = static_cast<const float*>(coefs);
  T* op = static_cast<T*>(out);
  if (vectorized) {
    weighted_agg_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        gp, rp, row_stride, num_rows, cp, C, kp, op, n);
  } else {
    weighted_agg_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        gp, rp, row_stride, num_rows, cp, C, kp, op, n);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `cids` may be NULL (rows 0..C-1).
// `vectorized` asks for 16-byte accesses; the caller sets it only when g,
// out, rows and rows' stride in bytes are all multiples of 16.
extern "C" int weighted_agg_launch(int dtype, const void* g, const void* rows,
                                   long long row_stride, long long num_rows,
                                   const void* cids, int C, const void* coefs,
                                   void* out, long long n, int vectorized,
                                   void* stream) {
  if (n <= 0) return 0;
  if (C < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(g, rows, row_stride, num_rows, cids, C, coefs, out, n,
                  vectorized != 0, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(g, rows, row_stride, num_rows, cids, C, coefs, out,
                          n, vectorized != 0, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
