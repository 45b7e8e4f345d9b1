// Flash-attention backward for Hopper (sm_90a): the kernels of the flash
// VJP, dQ and dK/dV (with a group-sum pass for GQA), for causal (or full)
// attention with optional sliding window, GQA and logit softcap.
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
// analytically, and the causal/window tile skip is the reference's (it
// only drops exact zeros).  The grids are not carried over: the TPU walks
// the kv tiles (dQ) or the q tiles (dK/dV) as a sequential grid axis with
// f32 accumulators in VMEM scratch, and sums each GQA group inside one
// grid step; here
//   * dQ: one thread block owns a (b, h, query tile) and loops over the
//     kv tiles itself, 32 keys a step, dQ accumulating in registers;
//   * dK/dV: one thread block owns a (b, query head h, kv tile) and loops
//     over the query tiles, 32 queries a step, dK_h and dV_h accumulating
//     in registers.
//     With H > Hkv each block writes its head's f32 partials to a scratch
//     (B, H, Sk, D) that the wrapper allocates, and a second kernel sums
//     each group's H/Hkv partials in the fixed order r = 0..rep-1 and
//     writes dk and dv; with H == Hkv the block writes dk and dv itself.
// No atomics: two launches give the same bits.
//
// Bound.  At the training shape (B = 8, S = 512, H = 14, Hkv = 2, D = 64)
// each kernel does three (dQ) or four (dK/dV) causal products of
// ~B*H*D*S^2 flops against a few MB of tensors: bound by arithmetic.  The
// reference holds the gradients to f32 within 2e-5*(1+max|ref|), which
// one TF32 pass (10-bit mantissa) misses by ~30x.  What the design does:
//   * products on the tensor cores in 3xTF32 (mma.sync m16n8k8, f32
//     accumulation): each f32 operand x is split into hi = tf32(x) and
//     lo = tf32(x - hi), and a.b = al.bh + ah.bl + ah.bh (al.bl dropped),
//     which keeps f32 accuracy at 3 TF32 passes (495/3 TFLOP/s against 67
//     on the CUDA cores).  An operand read from bf16 is exact in TF32
//     (lo = 0), so Q.K^T and dO.V^T in bf16 take one pass and the products
//     with p or ds two;
//   * a warp owns 16 rows (queries in dQ, keys in dK/dV) and keeps its
//     S/dP tile in mma accumulator fragments; p and ds are formed there
//     and fed straight back as the A operand of the next product (the
//     summed index permuted within each 8-wide step, and the B operand
//     read in the same permuted order), so they never touch shared memory;
//   * head-split dK/dV grid: at the training shape 896 blocks of 4 warps
//     (not 128 of 8 with each block walking its group's 7 heads);
//   * occupancy: the walked tile is 32 rows, which halves the S/dP
//     accumulators and the staged tiles, so up to D = 64 three blocks
//     (12 warps) fit an SM in both kernels;
//   * heaviest blocks first: the linear block index issues the causal
//     diagonal's longest walks first (dQ: the last query tile, dK/dV: the
//     first kv tile, of every (b, h)), which shortens the tail;
//   * cp.async double buffering: the next kv tile (dQ) or query tile with
//     its lse and delta rows (dK/dV) is in flight during the current
//     tile's math; tiles are staged in the storage dtype with rows padded
//     by 16 bytes, so every fragment read is free of bank conflicts;
//   * f32 sums across tiles: the tensor cores add into their f32
//     accumulator without IEEE rounding (the error leans one way), so a
//     chain over the whole walk (3 * S/8 mma steps) drifts with S; each
//     walked tile's dq, dk, dv products are summed in fresh fragments and
//     added to the running sums with f32 adds, so only 3 * 32/8 steps
//     chain;
//   * the ragged tail is masked in place (zero-filled copies, nothing
//     padded in memory); every tensor is read and written through strides
//     (16-byte aligned rows; the wrapper copies anything else), so the
//     model's (B, S, H, D) layout needs no copy and each gradient takes
//     its input's layout.
// Tiles: a block owns T = 64 rows up to D = 128 (T = 32 at D = 256) and
// walks the other axis 32 rows at a time; a warp accumulates at most 64
// columns (D = 128: 8 warps, D = 256: 8 warps, each (row group, column
// group) pair recomputing its row group's S/dP).
// Shared memory per block at D = 64, f32: 69,632 bytes (dQ), 70,144
// (dK/dV).
//
// Plain C interface (loaded with ctypes); launches on the caller's stream,
// never synchronises, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  float* part;                      // (2, B, H, Sk, D) f32 when H > Hkv
  int B, H, Hkv, Sq, Sk;
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

// tile rows, accumulator columns per warp, warps, staged row stride
template <int D>
__host__ __device__ constexpr int tile() { return D <= 128 ? 64 : 32; }
template <int D>
__host__ __device__ constexpr int acc_cols() { return D < 64 ? D : 64; }
template <int D>
__host__ __device__ constexpr int n_warps() {
  return (tile<D>() / 16) * (D / acc_cols<D>());
}
// rows of the tile a block walks: 32, so three blocks fit an SM up to
// D = 64
constexpr int kWalk = 32;
template <int D>
__host__ __device__ constexpr int min_blocks() { return D <= 64 ? 3 : 1; }
template <typename T_, int D>
__host__ __device__ constexpr int srow() {
  return D + 16 / static_cast<int>(sizeof(T_));
}

// ---------------------------------------------------------------------------
// cp.async, TF32 split and the m16n8k8 product
// ---------------------------------------------------------------------------
// 16 bytes global -> shared; zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// round to the nearest TF32 value, ties away from zero: cvt.rna.tf32.f32
// for finite x in two integer operations (on sm_90a the cvt compiles to a
// longer compare-and-select sequence)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo up to what TF32 drops of lo; kExact: x came from bf16, so it
// is a TF32 value and lo = 0
template <bool kExact>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (kExact) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
  }
}

// c (16x8) += a (16x8, row) . b (8x8, col), TF32 in, f32 accumulate.
// Fragments (g = lane/4, t = lane%4): a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4); b0 (k t, n g), b1 (k t+4, n g); c0 (g, 2t), c1 (g, 2t+1),
// c2 (g+8, 2t), c3 (g+8, 2t+1).
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: the two small cross terms first, then hi.hi; an exact operand
// has no lo, so its cross term is skipped
template <bool kAExact, bool kBExact>
__device__ __forceinline__ void mma3(float* c, const uint32_t* ah,
                                     const uint32_t* al, const uint32_t* bh,
                                     const uint32_t* bl) {
  if (!kAExact) mma(c, al, bh);
  if (!kBExact) mma(c, ah, bl);
  mma(c, ah, bh);
}

// A fragment of rows m0.., columns k0.. of a row-major staged tile X
template <bool kExact, typename T_>
__device__ __forceinline__ void frag_a(const T_* X, int sr, int m0, int k0,
                                       int g, int t, uint32_t* hi,
                                       uint32_t* lo) {
  const T_* p = X + (m0 + g) * sr + k0 + t;
  split<kExact>(to_f32(p[0]), hi[0], lo[0]);
  split<kExact>(to_f32(p[8 * sr]), hi[1], lo[1]);
  split<kExact>(to_f32(p[4]), hi[2], lo[2]);
  split<kExact>(to_f32(p[8 * sr + 4]), hi[3], lo[3]);
}

// B fragment with B[k][n] = Y[n0 + n][k0 + k] (Y's rows are the n index)
template <bool kExact, typename T_>
__device__ __forceinline__ void frag_b_rows_n(const T_* Y, int sr, int n0,
                                              int k0, int g, int t,
                                              uint32_t* hi, uint32_t* lo) {
  const T_* p = Y + (n0 + g) * sr + k0 + t;
  split<kExact>(to_f32(p[0]), hi[0], lo[0]);
  split<kExact>(to_f32(p[4]), hi[1], lo[1]);
}

// B fragment with B[k][n] = Y[k0 + perm(k)][n0 + n], perm(t) = 2t and
// perm(t+4) = 2t+1: the order in which an accumulator fragment holds its
// columns, so that fragment serves as the A operand as it stands
template <bool kExact, typename T_>
__device__ __forceinline__ void frag_b_rows_k(const T_* Y, int sr, int k0,
                                              int n0, int g, int t,
                                              uint32_t* hi, uint32_t* lo) {
  const T_* p = Y + (k0 + 2 * t) * sr + n0 + g;
  split<kExact>(to_f32(p[0]), hi[0], lo[0]);
  split<kExact>(to_f32(p[sr]), hi[1], lo[1]);
}

// an accumulator fragment (16 rows x 8 columns) as an A fragment over its
// columns in frag_b_rows_k's order
__device__ __forceinline__ void frag_a_acc(const float* c, uint32_t* hi,
                                           uint32_t* lo) {
  split<false>(c[0], hi[0], lo[0]);
  split<false>(c[2], hi[1], lo[1]);
  split<false>(c[1], hi[2], lo[2]);
  split<false>(c[3], hi[3], lo[3]);
}

// T rows from row r0 of a strided (n, D) matrix into a staged [T][SR]
// tile; rows at or past n are zeros
template <typename T_, int D, int T, int SR, int NT>
__device__ __forceinline__ void load_tile(T_* dst, const T_* src, int64_t rs,
                                          int r0, int n) {
  constexpr int E = 16 / static_cast<int>(sizeof(T_));
  constexpr int CPR = D / E;        // 16-byte copies per row
  for (int i = threadIdx.x; i < T * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * E;
    const bool in = r0 + r < n;
    cp16(dst + r * SR + c, in ? src + (r0 + r) * rs + c : src, in);
  }
}

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
// tile's last row (causal), or wholly before its first row's window.
// Monotone in both tile indices, so the tiles kept form one range.
__device__ __forceinline__ bool skip_tile(const Args& a, int q0, int k0,
                                          int tq, int tk) {
  if (a.causal && k0 > q0 + tq - 1) return true;
  if (a.window > 0 && k0 + tk - 1 < q0 - a.window + 1) return true;
  return false;
}

// ---------------------------------------------------------------------------
// dQ: one block per (b, h, T-row query tile), looping over kv tiles
// ---------------------------------------------------------------------------
template <typename T_, int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  // Q, dout; K and V double-buffered
  return (2 * tile<D>() + 4 * kWalk) * srow<T_, D>() *
         static_cast<int>(sizeof(T_));
}

template <typename T_, int D>
__global__ void __launch_bounds__(32 * n_warps<D>(), min_blocks<D>())
flash_bwd_dq_kernel(const Args a) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr bool kX = std::is_same<T_, __nv_bfloat16>::value;
  constexpr int T = tile<D>();
  constexpr int DW = acc_cols<D>();
  constexpr int RG = T / 16;        // row groups of 16 queries
  constexpr int NT = 32 * n_warps<D>();
  constexpr int SR = srow<T_, D>();
  constexpr int TI = kWalk;       // keys a step
  constexpr int NJ = TI / 8;        // 8-key column tiles of S
  constexpr int NC = DW / 8;        // 8-wide column tiles of a warp's dq
  extern __shared__ float4 smem4[];
  T_* Qs = reinterpret_cast<T_*>(smem4);    // [T][SR]
  T_* Os = Qs + T * SR;                     // [T][SR] dout
  T_* Ks = Os + T * SR;                     // [2][TI][SR]
  T_* Vs = Ks + 2 * TI * SR;                // [2][TI][SR]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp % RG);          // the warp's query rows
  const int c0 = DW * (warp / RG);          // and dq columns
  // heaviest first: under causal masking the last query tile of every
  // (b, h) walks the most kv tiles, so those blocks lead
  const int nq = (a.Sq + T - 1) / T;
  const int BH = a.B * a.H;
  const int rank = blockIdx.x / BH, bhi = blockIdx.x % BH;
  const int h = bhi % a.H, b = bhi / a.H;
  const int hk = h * a.Hkv / a.H;   // the reference's head -> kv-head map
  const int q0 = (a.causal ? nq - 1 - rank : rank) * T;

  const T_* q = static_cast<const T_*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T_* o = static_cast<const T_*>(a.dout) + b * a.os[0] + h * a.os[1];
  const T_* k = static_cast<const T_*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const T_* v = static_cast<const T_*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  const int64_t row = ((int64_t)b * a.H + h) * a.Sq;
  const int qa = q0 + r0 + g, qb = qa + 8;  // this thread's two rows
  const float lse_a = qa < a.Sq ? a.lse[row + qa] : 0.f;
  const float lse_b = qb < a.Sq ? a.lse[row + qb] : 0.f;
  const float dlt_a = qa < a.Sq ? a.delta[row + qa] : 0.f;
  const float dlt_b = qb < a.Sq ? a.delta[row + qb] : 0.f;

  const int nk = (a.Sk + TI - 1) / TI;
  int lo = 0, hi = nk - 1;
  while (lo <= hi && skip_tile(a, q0, lo * TI, T, TI)) ++lo;
  while (hi >= lo && skip_tile(a, q0, hi * TI, T, TI)) --hi;

  load_tile<T_, D, T, SR, NT>(Qs, q, a.qs[2], q0, a.Sq);
  load_tile<T_, D, T, SR, NT>(Os, o, a.os[2], q0, a.Sq);
  if (lo <= hi) {
    load_tile<T_, D, TI, SR, NT>(Ks, k, a.ks[2], lo * TI, a.Sk);
    load_tile<T_, D, TI, SR, NT>(Vs, v, a.vs[2], lo * TI, a.Sk);
  }
  cp_commit();

  float acc[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = lo; kt <= hi; ++kt) {
    const int st = (kt - lo) & 1;
    if (kt < hi) {                  // the next tile flies during this one
      load_tile<T_, D, TI, SR, NT>(Ks + (st ^ 1) * TI * SR, k, a.ks[2],
                                   (kt + 1) * TI, a.Sk);
      load_tile<T_, D, TI, SR, NT>(Vs + (st ^ 1) * TI * SR, v, a.vs[2],
                                   (kt + 1) * TI, a.Sk);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const T_* Kt = Ks + st * TI * SR;
    const T_* Vt = Vs + st * TI * SR;
    const int k0 = kt * TI;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows, all TI keys
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < D; kk += 8) {
      uint32_t qh[4], ql[4], oh[4], ol[4];
      frag_a<kX>(Qs, SR, r0, kk, g, t, qh, ql);
      frag_a<kX>(Os, SR, r0, kk, g, t, oh, ol);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t bh[2], bl[2];
        frag_b_rows_n<kX>(Kt, SR, 8 * j, kk, g, t, bh, bl);
        mma3<kX, kX>(s[j], qh, ql, bh, bl);
        frag_b_rows_n<kX>(Vt, SR, 8 * j, kk, g, t, bh, bl);
        mma3<kX, kX>(dp[j], oh, ol, bh, bl);
      }
    }
    // s <- scale * dS, in place
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p;
        p_ds(a, e < 2 ? qa : qb, k0 + 8 * j + 2 * t + (e & 1), s[j][e],
             dp[j][e], e < 2 ? lse_a : lse_b, e < 2 ? dlt_a : dlt_b, &p,
             &s[j][e]);
      }
    // dq += (scale dS) K over the tile's keys: the tile's product is
    // summed in a fresh fragment and added to dq with an f32 add
    uint32_t ah[NJ][4], al[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) frag_a_acc(s[j], ah[j], al[j]);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      float tile_sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t bh[2], bl[2];
        frag_b_rows_k<kX>(Kt, SR, 8 * j, c0 + 8 * n, g, t, bh, bl);
        mma3<false, kX>(tile_sum, ah[j], al[j], bh, bl);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += tile_sum[e];
    }
    __syncthreads();                // this stage is refilled next
  }
  cp_wait<0>();

  T_* dq = static_cast<T_*>(a.dq) + b * a.dqs[0] + h * a.dqs[1];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = e < 2 ? qa : qb;
      if (qi < a.Sq)
        from_f32(&dq[qi * a.dqs[2] + c0 + 8 * n + 2 * t + (e & 1)],
                 acc[n][e]);
    }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (b, query head h, T-row kv tile), looping over the
// query tiles; the head's dK_h and dV_h go to the f32 partials (H > Hkv)
// or straight to dk and dv (H == Hkv)
// ---------------------------------------------------------------------------
template <typename T_, int D>
__host__ __device__ constexpr int dkv_smem_bytes() {
  // K, V; Q and dout double-buffered; lse and delta rows double-buffered
  return (2 * tile<D>() + 4 * kWalk) * srow<T_, D>() *
             static_cast<int>(sizeof(T_)) +
         4 * kWalk * static_cast<int>(sizeof(float));
}

template <typename T_, int D>
__global__ void __launch_bounds__(32 * n_warps<D>(), min_blocks<D>())
flash_bwd_dkv_kernel(const Args a) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr bool kX = std::is_same<T_, __nv_bfloat16>::value;
  constexpr int T = tile<D>();
  constexpr int DW = acc_cols<D>();
  constexpr int RG = T / 16;        // row groups of 16 keys
  constexpr int NT = 32 * n_warps<D>();
  constexpr int SR = srow<T_, D>();
  constexpr int TI = kWalk;       // queries a step
  constexpr int NJ = TI / 8;        // 8-query column tiles of S^T
  constexpr int NC = DW / 8;        // 8-wide column tiles of dk, dv
  extern __shared__ float4 smem4[];
  T_* Ks = reinterpret_cast<T_*>(smem4);    // [T][SR]
  T_* Vs = Ks + T * SR;                     // [T][SR]
  T_* Qs = Vs + T * SR;                     // [2][TI][SR]
  T_* Os = Qs + 2 * TI * SR;                // [2][TI][SR] dout
  float* lseS = reinterpret_cast<float*>(Os + 2 * TI * SR);  // [2][TI]
  float* dltS = lseS + 2 * TI;                               // [2][TI]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp % RG);          // the warp's keys
  const int c0 = DW * (warp / RG);          // and dk/dv columns
  // heaviest first: under causal masking the first kv tile of every
  // (b, h) walks the most query tiles, so those blocks lead
  const int BH = a.B * a.H;
  const int rank = blockIdx.x / BH, bhi = blockIdx.x % BH;
  const int h = bhi % a.H, b = bhi / a.H;
  const int rep = a.H / a.Hkv;
  const int hk = h / rep;           // = h * Hkv / H, the reference's map
  const int k0 = rank * T;

  const T_* q = static_cast<const T_*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T_* o = static_cast<const T_*>(a.dout) + b * a.os[0] + h * a.os[1];
  const T_* k = static_cast<const T_*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const T_* v = static_cast<const T_*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  const float* lse = a.lse + ((int64_t)b * a.H + h) * a.Sq;
  const float* dlt = a.delta + ((int64_t)b * a.H + h) * a.Sq;
  const int ka = k0 + r0 + g, kb = ka + 8;  // this thread's two keys

  const int nq = (a.Sq + TI - 1) / TI;
  int lo = 0, hi = nq - 1;
  while (lo <= hi && skip_tile(a, lo * TI, k0, TI, T)) ++lo;
  while (hi >= lo && skip_tile(a, hi * TI, k0, TI, T)) --hi;

  // the query tile qt (rows, lse, delta) into stage st
  auto load_q = [&](int qt, int st) {
    const int q0 = qt * TI;
    load_tile<T_, D, TI, SR, NT>(Qs + st * TI * SR, q, a.qs[2], q0, a.Sq);
    load_tile<T_, D, TI, SR, NT>(Os + st * TI * SR, o, a.os[2], q0, a.Sq);
    for (int i = threadIdx.x; i < TI; i += NT) {
      const bool in = q0 + i < a.Sq;
      cp4(lseS + st * TI + i, in ? lse + q0 + i : lse, in);
      cp4(dltS + st * TI + i, in ? dlt + q0 + i : dlt, in);
    }
  };
  load_tile<T_, D, T, SR, NT>(Ks, k, a.ks[2], k0, a.Sk);
  load_tile<T_, D, T, SR, NT>(Vs, v, a.vs[2], k0, a.Sk);
  if (lo <= hi) load_q(lo, 0);
  cp_commit();

  float dk[NC][4], dv[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int qt = lo; qt <= hi; ++qt) {
    const int st = (qt - lo) & 1;
    if (qt < hi) load_q(qt + 1, st ^ 1);    // in flight during this tile
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const T_* Qt = Qs + st * TI * SR;
    const T_* Ot = Os + st * TI * SR;
    const float* lt = lseS + st * TI;
    const float* dt = dltS + st * TI;
    const int q0 = qt * TI;

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys, all TI queries
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < D; kk += 8) {
      uint32_t kh[4], kl[4], vh[4], vl[4];
      frag_a<kX>(Ks, SR, r0, kk, g, t, kh, kl);
      frag_a<kX>(Vs, SR, r0, kk, g, t, vh, vl);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t bh[2], bl[2];
        frag_b_rows_n<kX>(Qt, SR, 8 * j, kk, g, t, bh, bl);
        mma3<kX, kX>(s[j], kh, kl, bh, bl);
        frag_b_rows_n<kX>(Ot, SR, 8 * j, kk, g, t, bh, bl);
        mma3<kX, kX>(dp[j], vh, vl, bh, bl);
      }
    }
    // s <- P^T, dp <- scale * dS^T, in place
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = 8 * j + 2 * t + (e & 1);
        p_ds(a, q0 + il, e < 2 ? ka : kb, s[j][e], dp[j][e], lt[il], dt[il],
             &s[j][e], &dp[j][e]);
      }
    // dv += P^T dO and dk += (scale dS)^T Q over the tile's queries: the
    // tile's products are summed in fresh fragments and added with f32
    // adds, half of the columns at a time (registers)
    constexpr int NH = NC >= 4 ? NC / 2 : NC;
#pragma unroll
    for (int n0 = 0; n0 < NC; n0 += NH) {
      float sv[NH][4], sk[NH][4];
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sv[n][e] = sk[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t ph[4], pl[4], dh[4], dl[4];
        frag_a_acc(s[j], ph, pl);
        frag_a_acc(dp[j], dh, dl);
#pragma unroll
        for (int n = 0; n < NH; ++n) {
          uint32_t bh[2], bl[2];
          frag_b_rows_k<kX>(Ot, SR, 8 * j, c0 + 8 * (n0 + n), g, t, bh, bl);
          mma3<false, kX>(sv[n], ph, pl, bh, bl);
          frag_b_rows_k<kX>(Qt, SR, 8 * j, c0 + 8 * (n0 + n), g, t, bh, bl);
          mma3<false, kX>(sk[n], dh, dl, bh, bl);
        }
      }
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv[n0 + n][e] += sv[n][e];
          dk[n0 + n][e] += sk[n][e];
        }
    }
    __syncthreads();                // this stage is refilled next
  }
  cp_wait<0>();

  if (rep > 1) {                    // the head's f32 partials
    const int64_t per = (int64_t)a.B * a.H * a.Sk * D;
    float* pk = a.part + ((int64_t)b * a.H + h) * a.Sk * D;
    float* pv = pk + per;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = e < 2 ? ka : kb;
        if (kj < a.Sk) {
          const int64_t i = (int64_t)kj * D + c0 + 8 * n + 2 * t + (e & 1);
          pk[i] = dk[n][e];
          pv[i] = dv[n][e];
        }
      }
  } else {
    T_* dkp = static_cast<T_*>(a.dk) + b * a.dks[0] + hk * a.dks[1];
    T_* dvp = static_cast<T_*>(a.dv) + b * a.dvs[0] + hk * a.dvs[1];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = e < 2 ? ka : kb;
        const int col = c0 + 8 * n + 2 * t + (e & 1);
        if (kj < a.Sk) {
          from_f32(&dkp[kj * a.dks[2] + col], dk[n][e]);
          from_f32(&dvp[kj * a.dvs[2] + col], dv[n][e]);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// group sum: dk/dv[b, g] = sum_{r = 0..rep-1} partial[b, g*rep + r], in
// that order, in f32, rounded once to the output dtype
// ---------------------------------------------------------------------------
struct SumArgs {
  const float* part;                // (2, B, H, Sk, D) f32 contiguous
  void* dk;
  void* dv;
  int B, H, Hkv, Sk, D;
  int64_t dks[3], dvs[3];
};

template <typename T_>
__global__ void __launch_bounds__(256)
flash_bwd_dkv_group_sum_kernel(const SumArgs a) {
  const int rep = a.H / a.Hkv;
  const int D4 = a.D / 4;
  const int64_t n4 = (int64_t)a.B * a.Hkv * a.Sk * D4;   // float4s a tensor
  const int64_t per = (int64_t)a.B * a.H * a.Sk * a.D;
  const int64_t head = (int64_t)a.Sk * a.D;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < 2 * n4; i += (int64_t)gridDim.x * blockDim.x) {
    const int which = i >= n4;      // 0: dk, 1: dv
    int64_t r = which ? i - n4 : i;
    const int d = static_cast<int>(r % D4) * 4;
    r /= D4;
    const int s = static_cast<int>(r % a.Sk);
    r /= a.Sk;
    const int gk = static_cast<int>(r % a.Hkv);
    const int b = static_cast<int>(r / a.Hkv);
    const float* src = a.part + which * per +
                       (((int64_t)b * a.H + gk * rep) * a.Sk + s) * a.D + d;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int m = 1; m < rep; ++m) {
      const float4 x = *reinterpret_cast<const float4*>(src + m * head);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    // (selected element by element: an indexed parameter array would be
    // copied to local memory)
    T_* out = static_cast<T_*>(which ? a.dv : a.dk) +
              b * (which ? a.dvs[0] : a.dks[0]) +
              gk * (which ? a.dvs[1] : a.dks[1]) +
              s * (which ? a.dvs[2] : a.dks[2]) + d;
    from_f32(out, acc.x);
    from_f32(out + 1, acc.y);
    from_f32(out + 2, acc.z);
    from_f32(out + 3, acc.w);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
// above 48 KB only after opting in, and the whole carveout as shared
// memory so that three blocks fit an SM (D <= 64); once per instantiation
template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T_, int D>
int launch_dq(const Args& a, cudaStream_t stream) {
  constexpr int bytes = dq_smem_bytes<T_, D>();
  static const cudaError_t attr = opt_in(flash_bwd_dq_kernel<T_, D>, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int64_t blocks =
      (int64_t)((a.Sq + tile<D>() - 1) / tile<D>()) * a.H * a.B;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dq_kernel<T_, D>
      <<<static_cast<unsigned>(blocks), 32 * n_warps<D>(), bytes, stream>>>(
          a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T_, int D>
int launch_dkv(const Args& a, cudaStream_t stream) {
  constexpr int bytes = dkv_smem_bytes<T_, D>();
  static const cudaError_t attr = opt_in(flash_bwd_dkv_kernel<T_, D>, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int64_t blocks =
      (int64_t)((a.Sk + tile<D>() - 1) / tile<D>()) * a.H * a.B;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dkv_kernel<T_, D>
      <<<static_cast<unsigned>(blocks), 32 * n_warps<D>(), bytes, stream>>>(
          a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDq, typename T_>
int dispatch_d(int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 16: return kDq ? launch_dq<T_, 16>(a, s) : launch_dkv<T_, 16>(a, s);
    case 32: return kDq ? launch_dq<T_, 32>(a, s) : launch_dkv<T_, 32>(a, s);
    case 64: return kDq ? launch_dq<T_, 64>(a, s) : launch_dkv<T_, 64>(a, s);
    case 128: return kDq ? launch_dq<T_, 128>(a, s) : launch_dkv<T_, 128>(a, s);
    case 256: return kDq ? launch_dq<T_, 256>(a, s) : launch_dkv<T_, 256>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kDq>
int launch(int dtype, int D, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* delta, void* dq,
           void* dk, void* dv, float* part, int B, int H, int Hkv, int Sq,
           int Sk, const long long* strides, float scale, float cap,
           int causal, int window, void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dq = dq; a.dk = dk; a.dv = dv; a.part = part;
  a.B = B; a.H = H; a.Hkv = Hkv; a.Sq = Sq; a.Sk = Sk;
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
  if (B == 0 || H == 0 || (kDq ? Sq == 0 : Sk == 0)) return 0;
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  // dK/dV of a GQA group needs the partials' scratch
  if (!kDq && H > Hkv && part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<kDq, float>(D, a, s);
  if (dtype == 1) return dispatch_d<kDq, __nv_bfloat16>(D, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  strides: 21 element strides, [batch,
// head, seq] of q, k, v, dout, dq, dk and dv in that order, each a
// multiple of 16 bytes for q, k, v and dout, whose data must be 16-byte
// aligned.  lse and delta are (B, H, Sq) contiguous f32.  Head dims: 16,
// 32, 64, 128, 256.  The dQ launch writes dq only.
extern "C" int flash_attention_bwd_dq_launch(
    int dtype, int D, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, void* dq,
    int B, int H, int Hkv, int Sq, int Sk, const long long* strides,
    float scale, float cap, int causal, int window, void* stream) {
  return launch<true>(dtype, D, q, k, v, dout, lse, delta, dq, nullptr,
                      nullptr, nullptr, B, H, Hkv, Sq, Sk, strides, scale,
                      cap, causal, window, stream);
}

// The dK/dV launch: with H == Hkv it writes dk and dv (part unused, may
// be null); with H > Hkv it writes only part, a 16-byte aligned f32
// (2, B, H, Sk, D) contiguous scratch (dk partials, then dv partials), and
// flash_attention_bwd_group_sum_launch then writes dk and dv.
extern "C" int flash_attention_bwd_dkv_launch(
    int dtype, int D, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, void* dk,
    void* dv, float* part, int B, int H, int Hkv, int Sq, int Sk,
    const long long* strides, float scale, float cap, int causal,
    int window, void* stream) {
  return launch<false>(dtype, D, q, k, v, dout, lse, delta, nullptr, dk, dv,
                       part, B, H, Hkv, Sq, Sk, strides, scale, cap, causal,
                       window, stream);
}

// dk, dv (B, Hkv, Sk, D) from the partials of the dK/dV launch; strides:
// 6 element strides, [batch, head, seq] of dk then dv.
extern "C" int flash_attention_bwd_group_sum_launch(
    int dtype, int D, const float* part, void* dk, void* dv, int B, int H,
    int Hkv, int Sk, const long long* strides, void* stream) {
  if (B == 0 || Hkv == 0 || Sk == 0) return 0;
  if (D % 4 != 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  SumArgs a;
  a.part = part; a.dk = dk; a.dv = dv;
  a.B = B; a.H = H; a.Hkv = Hkv; a.Sk = Sk; a.D = D;
  for (int i = 0; i < 3; ++i) {
    a.dks[i] = strides[i];
    a.dvs[i] = strides[3 + i];
  }
  const int64_t n = 2 * (int64_t)B * Hkv * Sk * (D / 4);
  const int64_t blocks64 = (n + 255) / 256;
  const unsigned blocks =
      static_cast<unsigned>(blocks64 < 65535 * 16 ? blocks64 : 65535 * 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    flash_bwd_dkv_group_sum_kernel<float><<<blocks, 256, 0, s>>>(a);
  else if (dtype == 1)
    flash_bwd_dkv_group_sum_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
