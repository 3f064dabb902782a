// K6's backward: dq, dk and dv of causal GQA flash attention, for Hopper
// (sm_90a).
//
// It replaces no TPU kernel: `repro` trains through its pure-JAX attention
// (blocked_attention under jax.checkpoint) and its Pallas kernel has no
// backward.  It replaces the port's plain recompute,
// repro_torch/kernels/flash_attention/ref.py::flash_attention_grads, and
// computes what that computes: the gradient of flash_attention_plain
// (ref.py) at q, k, v for the output gradient dout, with its masks (keys at
// or past kv_len; causal at q_offset; the sliding window).  With s the
// scaled, masked scores, m the row max, p = exp(s - m), l = max(sum p,
// 1e-30) and p~ = p rounded to the input type (as the forward rounds it),
//
//   dp = dO V^T,   delta = sum_j p~ dp / l,   ds = p (dp - delta) / l,
//   dq = scale ds K,   dk = scale ds^T Q,   dv = (p / l)^T dO.
//
// q, dout (B, Sq, H, D) and k, v (B, Skv, Hkv, D) are read in place through
// their strides (the head dim contiguous); dq, dk, dv are contiguous and of
// the input type; query head h reads KV head h / G.  fp32 or bf16; D in
// {16, 32, 64, 128}.  Only q, k and v are saved by the forward, so the
// backward recomputes the scores.
//
// Design: two launches on the caller's stream, no atomics and no zeroed
// state, so two calls give the same bits.
//   1. dQ (flash_bwd_dq_*): one block per (64-row query tile, head, batch),
//      the tiles with the most keys first.  Pass 1 walks the key tiles the
//      tile's rows can see (ref.key_range) with an online softmax: the row
//      max m, the row sum l and delta (rescaled as m grows, so no saved
//      output is needed), and writes m, 1 / l and delta, fp32 (3, B, H,
//      Sq), to a workspace.  Pass 2 walks the same tiles again and adds
//      dq += ds K over them in order.
//   2. dK and dV (flash_bwd_dkv_*): one block per (64-key tile, KV head,
//      batch).  It walks the G query heads of its group, then the query
//      tiles that see its keys (the same (query tile, key tile) pairs as
//      launch 1), in that fixed order, reading m, l and delta of their rows:
//      dv += (p / l)^T dO, dk += ds^T Q, both sums fp32 in registers,
//      written once.
// Tiles wholly masked (causally, past kv_len, or below the window) are not
// visited; a warp's tile that no mask touches skips the mask tests.  The
// window is a template flag, compiled out without one.  bf16 runs every
// product on the tensor cores (mma.sync m16n8k16, fp32 accumulate; each
// warp owns 16 rows, or 16 keys in launch 2), every operand read with
// ldmatrix from row-major tiles in shared memory (padded 16 bytes a row),
// the walked tiles (and launch 2's m, 1 / l, delta) in a ring of kStages
// stages filled by cp.async; p = 2^(s c2 - m c2) with c2 = scale log2 e,
// one FFMA and one ex2 an element; p / l and ds are rounded to bf16 as
// the A operands of their products.  fp32 runs scalar FMAs (no TF32), 256
// threads as 16 row groups x 16 column groups, each thread 4 rows x 4
// columns of a score tile and 4 rows x D/16 columns of its sums, expf; each
// tile's (or step's) sum is formed apart and then added, which keeps the
// fp32 chains short (a dK of G = 8 heads summed in one chain of 1,200
// terms was 1.2e-6 of its max off the tiles' emulation).  A row with no
// visible key gets no gradient and adds none (the forward gives it a zero
// output).
//
// Work: 9 products of 2 D flops per (row, key) pair of a visited tile
// (launch 1: S and dP twice, dQ; launch 2: S, dP, dV, dK) against
// FlashAttention-2's 5, the price of saving no output or logsumexp in the
// forward.  Bound, one H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), B = 4,
// S = 4096, H = 32, Hkv = 4, D = 64, bf16, causal: 5 products x 1.4e11
// FLOPs of the unmasked pairs -> 0.70 ms, operations (235 MB of traffic:
// 0.07 ms).  What limits it (tools/k6_bwd_variants.py, PERF.md): the two
// launches took 6.56 ms there (launch 1 3.38, its first pass 1.63 of it;
// launch 2 3.18), about 11% of the bound, at three blocks of 168
// registers an SM; dropping the walked tiles' copies saves 18%, and
// before the exponentials went to ex2 in the log2 domain (one FFMA) they
// cost a quarter.  wgmma, TMA and a producer warp are the next steps.
//
// The kernel allocates nothing and does not synchronise; it returns
// cudaGetLastError() after each launch.  The Python wrapper
// (repro_torch/kernels/flash_attention/cuda.py::flash_attention_bwd_cuda)
// checks devices, types, shapes and strides, allocates dq, dk, dv and the
// workspace, and raises on a nonzero return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kT = 64;                  // query rows and keys per tile
constexpr int kBf16Threads = 128;       // four warps of 16 rows (or keys)
constexpr int kStages = 2;              // bf16: the ring of walked tiles
constexpr int kF32Threads = 256;        // 16 row groups x 16 column groups
constexpr int kF32St = kT + 1;          // fp32 transposed tiles [D][kT + 1]
constexpr int kXSt = kT + 2;            // fp32 p / ds tiles [walked][kT + 2]
constexpr unsigned kFull = 0xffffffffu;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* stats;               // m, 1 / l, delta: three planes of (B, H, Sq);
                              // bf16 keeps m in the exponent's units (m scale log2 e)
  int64_t qsb, qss, qsh;      // strides (elements): batch, position, head
  int64_t ksb, kss, ksh;
  int64_t vsb, vss, vsh;
  int64_t osb, oss, osh;      // dout
  int B, Sq, Skv, H, Hkv, G;
  int q_offset, kv_len, causal;
  int window;                 // > 0: key j is visible to position p iff p - j < window
  int vec;                    // every row start 16-byte aligned: 16-byte loads
  float scale;
};

template <bool W>
__device__ __forceinline__ bool visible(const BwdArgs& a, int64_t pos, int64_t key) {
  return key < a.kv_len && (!a.causal || key <= pos) && (!W || pos - key < a.window);
}

// Every (row, key) of rows [r0, r0 + nr) (positions q_offset + row) and
// keys [k0, k0 + nk) visible: the tile needs no mask.
template <bool W>
__device__ __forceinline__ bool tile_visible(const BwdArgs& a, int64_t r0, int nr, int64_t k0,
                                             int nk) {
  const int64_t p0 = a.q_offset + r0;
  return k0 + nk <= a.kv_len && (!a.causal || k0 + nk - 1 <= p0) &&
         (!W || p0 + nr - 1 - k0 < a.window);
}

// The query rows [i0, i1) of launch 1's tile and the key tiles [t_lo, t_hi)
// they can see (ref.key_range, in tiles).
template <bool W>
__device__ __forceinline__ void key_tiles(const BwdArgs& a, int64_t i0, int& t_lo, int& t_hi) {
  const int64_t i1 = i0 + kT < a.Sq ? i0 + kT : a.Sq;
  int64_t hi = a.kv_len;
  if (a.causal && a.q_offset + i1 < hi) hi = a.q_offset + i1;
  int64_t lo = 0;
  if (W && a.q_offset + i0 - a.window + 1 > 0) lo = a.q_offset + i0 - a.window + 1;
  t_lo = static_cast<int>(lo / kT);
  t_hi = hi > lo ? static_cast<int>((hi + kT - 1) / kT) : t_lo;
}

// The query tiles [qt_lo, qt_hi) whose rows see some key of the tile at j0:
// the same (query tile, key tile) pairs as `key_tiles`.
template <bool W>
__device__ __forceinline__ void query_tiles(const BwdArgs& a, int64_t j0, int& qt_lo,
                                            int& qt_hi) {
  qt_lo = qt_hi = 0;
  if (j0 >= a.kv_len) return;
  int64_t i_min = 0;
  if (a.causal && j0 - a.q_offset > 0) i_min = j0 - a.q_offset;
  int64_t i_max = a.Sq;
  if (W && j0 + kT - 1 + a.window - a.q_offset < i_max)
    i_max = j0 + kT - 1 + a.window - a.q_offset;
  if (i_max <= i_min) return;
  qt_lo = static_cast<int>(i_min / kT);
  qt_hi = static_cast<int>((i_max + kT - 1) / kT);
}

// 2^x (bf16's exponentials: one FFMA and ex2 an element, as the
// forward's bf16 prefill).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---- bf16: mma.sync on row-major tiles in shared memory ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
// 4 bytes global -> shared (zero-filled where !valid).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (16x8, fp32) += a (16x16 bf16, row-major) * b (16x8 bf16, col-major);
// lane (g = lane / 4, t = lane % 4) holds d at rows g, g + 8 and columns
// 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 64 rows of D bf16 into a tile of row stride D + 8: row r from src + (r0 +
// r) * stride where r0 + r < n, else zeros.  cp.async where `vec`.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int64_t stride, int64_t r0, int64_t n, bool vec) {
  constexpr int ROW = D + 8, CH = D / 8;
  if (vec) {
#pragma unroll
    for (int e0 = 0; e0 < kT * CH; e0 += kBf16Threads) {
      const int e = e0 + threadIdx.x, r = e / CH, c = e % CH;
      const bool ok = r0 + r < n;
      cp_async16(smem_addr(dst + r * ROW + c * 8), ok ? src + (r0 + r) * stride + c * 8 : src,
                 ok);
    }
  } else {
    for (int e = threadIdx.x; e < kT * D; e += kBf16Threads) {
      const int r = e / D, d = e % D;
      dst[r * ROW + d] = r0 + r < n ? src[(r0 + r) * stride + d] : __float2bfloat16(0.0f);
    }
  }
}

// acc (16 rows x 8 NT columns) += A B^T over the head dim: A the warp's 16
// rows at `A`, B the 8 NT rows at `Bm`, both [row][D + 8].  acc[nt][e]:
// row g + 8 (e / 2), column 8 nt + 2 t + e % 2.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const __nv_bfloat16* A,
                                        const __nv_bfloat16* Bm) {
  constexpr int ROW = D + 8;
  const int lane = threadIdx.x & 31;
  const uint32_t a_base = smem_addr(A), b_base = smem_addr(Bm);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t af[4];
    ldsm_x4(af, a_base + 2 * ((lane & 15) * ROW + ks * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      // matrices: rows 16 np + 0..7 | 8..15, head dims 16 ks + 0..7 | 8..15
      uint32_t bf[4];
      ldsm_x4(bf, b_base + 2 * ((np * 16 + (lane >> 4) * 8 + (lane & 7)) * ROW + ks * 16 +
                                ((lane >> 3) & 1) * 8));
      mma_bf16_16816(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16_16816(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// x (16 x 8 NT, accumulator layout) rounded to bf16 as A fragments of
// NT / 2 k-steps.
template <int NT>
__device__ __forceinline__ void pack_a(uint32_t (&pa)[NT / 2][4], const float (&x)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    pa[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    pa[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    pa[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// acc (16 rows x D) += P Y: P packed A fragments (16 x 16 KS), Y the 16 KS
// rows at `Y`, [row][D + 8].  acc[dt][e]: row g + 8 (e / 2), column 8 dt +
// 2 t + e % 2.
template <int D, int KS>
__device__ __forceinline__ void mma_py(float (&acc)[D / 8][4], const uint32_t (&pa)[KS][4],
                                       const __nv_bfloat16* Y) {
  constexpr int ROW = D + 8;
  const int lane = threadIdx.x & 31;
  const uint32_t y_base = smem_addr(Y);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      // matrices: rows 16 kk + 0..7 | 8..15, head dims 16 dp + 0..7 | 8..15
      uint32_t vb[4];
      ldsm_x4_trans(vb, y_base + 2 * ((kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ROW +
                                      (2 * dp + (lane >> 4)) * 8));
      mma_bf16_16816(acc[2 * dp], pa[kk], vb[0], vb[1]);
      mma_bf16_16816(acc[2 * dp + 1], pa[kk], vb[2], vb[3]);
    }
}

template <int D>
constexpr size_t bf16_smem_bytes(bool dkv) {
  // the block's two tiles, kStages stages of the walked two and, for
  // launch 2, of the walked rows' m, 1 / l and delta
  return (2 + 2 * kStages) * sizeof(__nv_bfloat16) * kT * (D + 8) +
         (dkv ? kStages * 3 * kT * sizeof(float) : 0);
}

// Launch 1, bf16.  Warp w owns rows i0 + 16 w .. + 15.
template <int D, bool W>
__global__ void __launch_bounds__(kBf16Threads)
flash_bwd_dq_bf16(const BwdArgs a) {
  using T = __nv_bfloat16;
  constexpr int ROW = D + 8, TILE = kT * ROW, NT = kT / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char dsmem[];
  T* Qs = reinterpret_cast<T*>(dsmem);
  T* Os = Qs + TILE;
  T* ring = Os + TILE;                  // kStages stages of (K, V)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int nq = (a.Sq + kT - 1) / kT;
  const int64_t i0 = static_cast<int64_t>(nq - 1 - static_cast<int>(blockIdx.x)) * kT;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int kvh = h / a.G;
  const T* q = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* dO = static_cast<const T*>(a.dout) + b * a.osb + h * a.osh;
  const T* k = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* v = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh;
  int t_lo, t_hi;
  key_tiles<W>(a, i0, t_lo, t_hi);

  const auto load_kv = [&](int t, int st) {
    T* Ks = ring + st * 2 * TILE;
    load_tile<D>(Ks, k, a.kss, static_cast<int64_t>(t) * kT, a.Skv, a.vec);
    load_tile<D>(Ks + TILE, v, a.vss, static_cast<int64_t>(t) * kT, a.Skv, a.vec);
  };
  load_tile<D>(Qs, q, a.qss, i0, a.Sq, a.vec);
  load_tile<D>(Os, dO, a.oss, i0, a.Sq, a.vec);

  const int64_t wr0 = i0 + warp * 16;   // the warp's first row
  const int64_t pos[2] = {a.q_offset + wr0 + g, a.q_offset + wr0 + g + 8};
  const T* Qw = Qs + warp * 16 * ROW;
  const T* Ow = Os + warp * 16 * ROW;

  // The tile's scores (scaled; masked to -inf) and dP.
  const auto scores = [&](int t, const T* Ks, float (&s)[NT][4], float (&dp)[NT][4]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
    mma_abt<D, NT>(s, Qw, Ks);
    mma_abt<D, NT>(dp, Ow, Ks + TILE);
    const int64_t k0 = static_cast<int64_t>(t) * kT;
    const bool full = tile_visible<W>(a, wr0, 16, k0, kT);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t key = k0 + nt * 8 + 2 * t4 + (e & 1);
        if (!full && !visible<W>(a, pos[e >> 1], key)) s[nt][e] = -CUDART_INF_F;
      }
  };
  // The exponent of p: s c2 - m c2, c2 = scale log2(e), m the raw row max
  // (-m c2 taken as 0 for a row with no key so far: its scores are all
  // -inf and give p = 0).
  const float c2 = a.scale * kLog2e;

  // Pass 1: m, l and delta online.  l and delta are per-lane partial sums
  // (the rescale is the row's own), reduced over the row's four lanes after.
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f}, du[2] = {0.0f, 0.0f};
  float mneg[2] = {0.0f, 0.0f};         // -m c2
  // The ring: tiles t_lo .. t_lo + kStages - 2 in flight before the walk,
  // then tile t + kStages - 1 issued as tile t is used.
  const auto walk_start = [&]() {
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) {
      if (t_lo + j < t_hi) load_kv(t_lo + j, j);
      cp_async_commit();
    }
  };
  const auto walk_next = [&](int t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                    // tile t landed; the stage of t - 1 is free
    if (t + kStages - 1 < t_hi) load_kv(t + kStages - 1, (t - t_lo + kStages - 1) % kStages);
    cp_async_commit();
    return ring + ((t - t_lo) % kStages) * 2 * TILE;
  };
  walk_start();
  for (int t = t_lo; t < t_hi; ++t) {
    const T* Ks = walk_next(t);
    float s[NT][4], dp[NT][4];
    scores(t, Ks, s, dp);
    float tmax[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) tmax[e >> 1] = fmaxf(tmax[e >> 1], s[nt][e]);
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      tmax[hr] = fmaxf(tmax[hr], __shfl_xor_sync(kFull, tmax[hr], 1));
      tmax[hr] = fmaxf(tmax[hr], __shfl_xor_sync(kFull, tmax[hr], 2));
      const float m_new = fmaxf(m[hr], tmax[hr]);
      corr[hr] = m_new == -CUDART_INF_F ? 1.0f : exp2_approx((m[hr] - m_new) * c2);
      m[hr] = m_new;
      mneg[hr] = m_new == -CUDART_INF_F ? 0.0f : -m_new * c2;
    }
    float ls[2] = {0.0f, 0.0f}, ds[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const float p = exp2_approx(fmaf(s[nt][e], c2, mneg[hr]));
        ls[hr] += p;
        ds[hr] = fmaf(round_bf16(p), dp[nt][e], ds[hr]);
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] = fmaf(l[hr], corr[hr], ls[hr]);
      du[hr] = fmaf(du[hr], corr[hr], ds[hr]);
    }
  }
  float inv_l[2], delta[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(kFull, l[hr], 1);
    l[hr] += __shfl_xor_sync(kFull, l[hr], 2);
    du[hr] += __shfl_xor_sync(kFull, du[hr], 1);
    du[hr] += __shfl_xor_sync(kFull, du[hr], 2);
    l[hr] = fmaxf(l[hr], 1e-30f);
    inv_l[hr] = 1.0f / l[hr];
    delta[hr] = du[hr] / l[hr];
    const int64_t i = wr0 + g + 8 * hr;
    if (t4 == 0 && i < a.Sq) {
      const int64_t plane = static_cast<int64_t>(a.B) * a.H * a.Sq;
      const int64_t at = (b * a.H + h) * a.Sq + i;
      a.stats[at] = -mneg[hr];          // m c2: launch 2's exponents
      a.stats[plane + at] = inv_l[hr];
      a.stats[2 * plane + at] = delta[hr];
    }
  }

  // Pass 2: dq += ds K over the same tiles, in order.
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;
  cp_async_wait_all();
  __syncthreads();                      // every warp is done with the ring
  walk_start();
  for (int t = t_lo; t < t_hi; ++t) {
    const T* Ks = walk_next(t);
    float s[NT][4], dp[NT][4];
    scores(t, Ks, s, dp);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const float p = exp2_approx(fmaf(s[nt][e], c2, mneg[hr]));   // masked: 0
        s[nt][e] = p * (dp[nt][e] - delta[hr]) * inv_l[hr];
      }
    uint32_t pa[NT / 2][4];
    pack_a<NT>(pa, s);
    mma_py<D, NT / 2>(acc, pa, Ks);
  }
  cp_async_wait_all();

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int64_t i = wr0 + g + 8 * hr;
    if (i >= a.Sq) continue;
    T* row = dq + ((b * a.Sq + i) * a.H + h) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(row + dt * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[dt][2 * hr] * a.scale, acc[dt][2 * hr + 1] * a.scale);
  }
}

// Launch 2, bf16.  Warp w owns keys j0 + 16 w .. + 15; the products run
// over chunks of QC = 32 of a staged query tile's rows, which keeps dk, dv
// and the chunk's scores in registers (168 at D = 64: three blocks an SM;
// chunks of 64 took 236 and ran 7% slower at train_4k, one H100).
template <int D, bool W>
__global__ void __launch_bounds__(kBf16Threads)
flash_bwd_dkv_bf16(const BwdArgs a) {
  using T = __nv_bfloat16;
  constexpr int ROW = D + 8, TILE = kT * ROW, DT = D / 8;
  constexpr int QC = 32, NC = QC / 8;
  extern __shared__ __align__(16) unsigned char dsmem[];
  T* Ks = reinterpret_cast<T*>(dsmem);
  T* Vs = Ks + TILE;
  T* ring = Vs + TILE;                  // kStages stages of (Q, dO)
  float* stat_ring = reinterpret_cast<float*>(ring + 2 * kStages * TILE);   // of [3][kT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kT;
  const int kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh;
  int qt_lo, qt_hi;
  query_tiles<W>(a, j0, qt_lo, qt_hi);
  const int nqt = qt_hi - qt_lo;
  const int steps = nqt * a.G;          // (head in group, query tile), head outer
  const int64_t plane = static_cast<int64_t>(a.B) * a.H * a.Sq;
  const float c2 = a.scale * kLog2e;    // p = 2^(s c2 - m c2), m c2 from launch 1

  const auto load_q = [&](int step, int st) {
    const int h = kvh * a.G + step / nqt;
    const int64_t i0 = static_cast<int64_t>(qt_lo + step % nqt) * kT;
    T* Qt = ring + st * 2 * TILE;
    load_tile<D>(Qt, static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh, a.qss, i0, a.Sq,
                 a.vec);
    load_tile<D>(Qt + TILE, static_cast<const T*>(a.dout) + b * a.osb + h * a.osh, a.oss, i0,
                 a.Sq, a.vec);
    float* S = stat_ring + st * 3 * kT;
    for (int e = tid; e < 3 * kT; e += kBf16Threads) {
      const int64_t i = i0 + e % kT;
      const bool ok = i < a.Sq;
      cp_async4(smem_addr(S + e), a.stats + (e / kT) * plane + (b * a.H + h) * a.Sq + (ok ? i : 0),
                ok);
    }
  };
  load_tile<D>(Ks, kb, a.kss, j0, a.Skv, a.vec);
  load_tile<D>(Vs, vb, a.vss, j0, a.Skv, a.vec);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {   // the ring, as launch 1's
    if (j < steps) load_q(j, j);
    cp_async_commit();
  }

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.0f;
  const int64_t key0 = j0 + warp * 16;  // the warp's first key
  const int64_t keys[2] = {key0 + g, key0 + g + 8};
  const T* Kw = Ks + warp * 16 * ROW;
  const T* Vw = Vs + warp * 16 * ROW;

  for (int step = 0; step < steps; ++step) {
    const int st = step % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();                    // step's tiles landed; the last stage is free
    if (step + kStages - 1 < steps) load_q(step + kStages - 1, (step + kStages - 1) % kStages);
    cp_async_commit();
    const T* Qt = ring + st * 2 * TILE;
    const T* Ot = Qt + TILE;
    const float* S = stat_ring + st * 3 * kT;
    const int64_t i0 = static_cast<int64_t>(qt_lo + step % nqt) * kT;
#pragma unroll
    for (int c0 = 0; c0 < kT; c0 += QC) {
      float s[NC][4], dp[NC][4];
#pragma unroll
      for (int nt = 0; nt < NC; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
      mma_abt<D, NC>(s, Kw, Qt + c0 * ROW);     // s^T: the warp's keys x QC queries
      mma_abt<D, NC>(dp, Vw, Ot + c0 * ROW);
      const bool full = i0 + c0 + QC <= a.Sq && tile_visible<W>(a, i0 + c0, QC, key0, 16);
#pragma unroll
      for (int nt = 0; nt < NC; ++nt) {
        const int col = c0 + nt * 8 + 2 * t4;     // the lane's two queries
        const float2 mq = *reinterpret_cast<const float2*>(S + col);
        const float2 il = *reinterpret_cast<const float2*>(S + kT + col);
        const float2 dl = *reinterpret_cast<const float2*>(S + 2 * kT + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t i = i0 + col + (e & 1);
          const bool ok = full || (i < a.Sq && visible<W>(a, a.q_offset + i, keys[e >> 1]));
          const float ile = e & 1 ? il.y : il.x;
          const float p = ok ? exp2_approx(fmaf(s[nt][e], c2, -(e & 1 ? mq.y : mq.x))) : 0.0f;
          s[nt][e] = p * ile;                                    // p / l
          dp[nt][e] = p * (dp[nt][e] - (e & 1 ? dl.y : dl.x)) * ile;   // ds
        }
      }
      uint32_t pa[NC / 2][4];
      pack_a<NC>(pa, s);
      mma_py<D, NC / 2>(dv, pa, Ot + c0 * ROW);
      pack_a<NC>(pa, dp);
      mma_py<D, NC / 2>(dk, pa, Qt + c0 * ROW);
    }
  }
  cp_async_wait_all();

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int64_t j = keys[hr];
    if (j >= a.Skv) continue;
    const int64_t at = ((b * a.Skv + j) * a.Hkv + kvh) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + at + dt * 8 + 2 * t4) =
          __floats2bfloat162_rn(dk[dt][2 * hr] * a.scale, dk[dt][2 * hr + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + at + dt * 8 + 2 * t4) =
          __floats2bfloat162_rn(dv[dt][2 * hr], dv[dt][2 * hr + 1]);
    }
  }
}

// ---- fp32: scalar FMAs on transposed tiles ----

// 64 rows of D floats into a transposed tile Xt [D][kF32St]: row r from
// src + (r0 + r) * stride where r0 + r < n, else zeros.
template <int D>
__device__ __forceinline__ void load_tile_t(float* dst, const float* src, int64_t stride,
                                            int64_t r0, int64_t n, bool vec) {
  if (vec) {
    constexpr int CH = D / 4;
    for (int e = threadIdx.x; e < kT * CH; e += kF32Threads) {
      const int r = e / CH, c = e % CH;
      const float4 x = r0 + r < n ? *reinterpret_cast<const float4*>(src + (r0 + r) * stride + c * 4)
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      dst[(4 * c) * kF32St + r] = x.x;
      dst[(4 * c + 1) * kF32St + r] = x.y;
      dst[(4 * c + 2) * kF32St + r] = x.z;
      dst[(4 * c + 3) * kF32St + r] = x.w;
    }
  } else {
    for (int e = threadIdx.x; e < kT * D; e += kF32Threads) {
      const int r = e / D, d = e % D;
      dst[d * kF32St + r] = r0 + r < n ? src[(r0 + r) * stride + d] : 0.0f;
    }
  }
}

// s[mm][jj] += sum_d A[d][rg + 16 mm] B[d][cg + 16 jj] (transposed tiles).
template <int D>
__device__ __forceinline__ void f32_abt(float (&s)[4][4], const float* A, const float* Bm,
                                        int rg, int cg) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      x[u] = A[d * kF32St + rg + 16 * u];
      y[u] = Bm[d * kF32St + cg + 16 * u];
    }
#pragma unroll
    for (int mm = 0; mm < 4; ++mm)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[mm][jj] = fmaf(x[mm], y[jj], s[mm][jj]);
  }
}

// acc[mm][c] += sum_w X[w][rg + 16 mm] Y[cg + 16 c][w]: X [kT][kXSt], Y a
// transposed tile.
template <int D>
__device__ __forceinline__ void f32_xy(float (&acc)[4][D / 16], const float* X, const float* Y,
                                       int rg, int cg) {
#pragma unroll 4
  for (int w = 0; w < kT; ++w) {
    float x[4], y[D / 16];
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) x[mm] = X[w * kXSt + rg + 16 * mm];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) y[c] = Y[(cg + 16 * c) * kF32St + w];
#pragma unroll
    for (int mm = 0; mm < 4; ++mm)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[mm][c] = fmaf(x[mm], y[c], acc[mm][c]);
  }
}

// acc += the sum of f32_xy, formed apart from acc.
template <int D>
__device__ __forceinline__ void add_xy(float (&acc)[4][D / 16], const float* X, const float* Y,
                                       int rg, int cg) {
  float part[4][D / 16];
#pragma unroll
  for (int mm = 0; mm < 4; ++mm)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) part[mm][c] = 0.0f;
  f32_xy<D>(part, X, Y, rg, cg);
#pragma unroll
  for (int mm = 0; mm < 4; ++mm)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[mm][c] += part[mm][c];
}

template <int D>
constexpr size_t f32_smem_bytes(bool dkv) {
  // four transposed tiles, one (launch 1) or two (launch 2) p / ds tiles,
  // and for launch 2 the walked rows' m, 1 / l and delta
  return sizeof(float) * (4 * D * kF32St + (dkv ? 2 : 1) * kT * kXSt + (dkv ? 3 * kT : 0));
}

// Launch 1, fp32.  Thread (rg, cg) = (tid / 16, tid % 16) owns rows rg +
// 16 mm and, of a key tile, keys cg + 16 jj; of dq, columns cg + 16 c.
template <int D, bool W>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dq_f32(const BwdArgs a) {
  constexpr int DPT = D / 16;
  extern __shared__ __align__(16) unsigned char dsmem[];
  float* Qt = reinterpret_cast<float*>(dsmem);
  float* Ot = Qt + D * kF32St;
  float* Kt = Ot + D * kF32St;
  float* Vt = Kt + D * kF32St;
  float* Xs = Vt + D * kF32St;

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int nq = (a.Sq + kT - 1) / kT;
  const int64_t i0 = static_cast<int64_t>(nq - 1 - static_cast<int>(blockIdx.x)) * kT;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int kvh = h / a.G;
  const float* k = static_cast<const float*>(a.k) + b * a.ksb + kvh * a.ksh;
  const float* v = static_cast<const float*>(a.v) + b * a.vsb + kvh * a.vsh;
  int t_lo, t_hi;
  key_tiles<W>(a, i0, t_lo, t_hi);
  load_tile_t<D>(Qt, static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh, a.qss, i0, a.Sq,
                 a.vec);
  load_tile_t<D>(Ot, static_cast<const float*>(a.dout) + b * a.osb + h * a.osh, a.oss, i0,
                 a.Sq, a.vec);

  // The tile's scores (scaled; masked to -inf) and dP; the tile is staged.
  const auto scores = [&](int t, float (&s)[4][4], float (&dp)[4][4]) {
    __syncthreads();                    // the last tile is used
    load_tile_t<D>(Kt, k, a.kss, static_cast<int64_t>(t) * kT, a.Skv, a.vec);
    load_tile_t<D>(Vt, v, a.vss, static_cast<int64_t>(t) * kT, a.Skv, a.vec);
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < 4; ++mm)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[mm][jj] = dp[mm][jj] = 0.0f;
    f32_abt<D>(s, Qt, Kt, rg, cg);
    f32_abt<D>(dp, Ot, Vt, rg, cg);
    const int64_t k0 = static_cast<int64_t>(t) * kT;
    const bool full = tile_visible<W>(a, i0, kT, k0, kT);
#pragma unroll
    for (int mm = 0; mm < 4; ++mm)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int64_t pos = a.q_offset + i0 + rg + 16 * mm, key = k0 + cg + 16 * jj;
        s[mm][jj] = full || visible<W>(a, pos, key) ? s[mm][jj] * a.scale : -CUDART_INF_F;
      }
  };

  float m[4], l[4], du[4];
#pragma unroll
  for (int mm = 0; mm < 4; ++mm) {
    m[mm] = -CUDART_INF_F;
    l[mm] = du[mm] = 0.0f;
  }
  for (int t = t_lo; t < t_hi; ++t) {
    float s[4][4], dp[4][4];
    scores(t, s, dp);
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) {
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) tmax = fmaxf(tmax, s[mm][jj]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, off));
      const float m_new = fmaxf(m[mm], tmax);
      const float corr = m_new == -CUDART_INF_F ? 1.0f : expf(m[mm] - m_new);
      m[mm] = m_new;
      float ls = 0.0f, ds = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = m_new == -CUDART_INF_F ? 0.0f : expf(s[mm][jj] - m_new);
        ls += p;
        ds = fmaf(p, dp[mm][jj], ds);
      }
      l[mm] = fmaf(l[mm], corr, ls);
      du[mm] = fmaf(du[mm], corr, ds);
    }
  }
  float inv_l[4], delta[4];
  const int64_t plane = static_cast<int64_t>(a.B) * a.H * a.Sq;
#pragma unroll
  for (int mm = 0; mm < 4; ++mm) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      l[mm] += __shfl_xor_sync(kFull, l[mm], off);
      du[mm] += __shfl_xor_sync(kFull, du[mm], off);
    }
    l[mm] = fmaxf(l[mm], 1e-30f);
    inv_l[mm] = 1.0f / l[mm];
    delta[mm] = du[mm] / l[mm];
    const int64_t i = i0 + rg + 16 * mm;
    if (cg == 0 && i < a.Sq) {
      const int64_t at = (b * a.H + h) * a.Sq + i;
      a.stats[at] = m[mm];
      a.stats[plane + at] = inv_l[mm];
      a.stats[2 * plane + at] = delta[mm];
    }
  }

  float acc[4][DPT];
#pragma unroll
  for (int mm = 0; mm < 4; ++mm)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[mm][c] = 0.0f;
  for (int t = t_lo; t < t_hi; ++t) {
    float s[4][4], dp[4][4];
    scores(t, s, dp);
#pragma unroll
    for (int mm = 0; mm < 4; ++mm)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = s[mm][jj] == -CUDART_INF_F ? 0.0f : expf(s[mm][jj] - m[mm]);
        Xs[(cg + 16 * jj) * kXSt + rg + 16 * mm] = p * (dp[mm][jj] - delta[mm]) * inv_l[mm];
      }
    __syncthreads();                    // every row's ds is in Xs
    add_xy<D>(acc, Xs, Kt, rg, cg);     // the tile's sum apart, then added
  }

  float* dq = static_cast<float*>(a.dq);
#pragma unroll
  for (int mm = 0; mm < 4; ++mm) {
    const int64_t i = i0 + rg + 16 * mm;
    if (i >= a.Sq) continue;
    float* row = dq + ((b * a.Sq + i) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) row[cg + 16 * c] = acc[mm][c] * a.scale;
  }
}

// Launch 2, fp32.  Thread (rg, cg) owns keys rg + 16 mm and, of a query
// tile, queries cg + 16 jj; of dk and dv, columns cg + 16 c.
template <int D, bool W>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dkv_f32(const BwdArgs a) {
  constexpr int DPT = D / 16;
  extern __shared__ __align__(16) unsigned char dsmem[];
  float* Kt = reinterpret_cast<float*>(dsmem);
  float* Vt = Kt + D * kF32St;
  float* Qt = Vt + D * kF32St;
  float* Ot = Qt + D * kF32St;
  float* Ps = Ot + D * kF32St;          // p / l
  float* Ds = Ps + kT * kXSt;           // ds
  float* S = Ds + kT * kXSt;            // the walked rows' m, 1 / l, delta

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kT;
  const int kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  int qt_lo, qt_hi;
  query_tiles<W>(a, j0, qt_lo, qt_hi);
  const int nqt = qt_hi - qt_lo;
  const int steps = nqt * a.G;
  const int64_t plane = static_cast<int64_t>(a.B) * a.H * a.Sq;
  load_tile_t<D>(Kt, static_cast<const float*>(a.k) + b * a.ksb + kvh * a.ksh, a.kss, j0,
                 a.Skv, a.vec);
  load_tile_t<D>(Vt, static_cast<const float*>(a.v) + b * a.vsb + kvh * a.vsh, a.vss, j0,
                 a.Skv, a.vec);

  float dk[4][DPT], dv[4][DPT];
#pragma unroll
  for (int mm = 0; mm < 4; ++mm)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dk[mm][c] = dv[mm][c] = 0.0f;

  for (int step = 0; step < steps; ++step) {
    const int h = kvh * a.G + step / nqt;
    const int64_t i0 = static_cast<int64_t>(qt_lo + step % nqt) * kT;
    __syncthreads();                    // the last step's tiles are used
    load_tile_t<D>(Qt, static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh, a.qss, i0,
                   a.Sq, a.vec);
    load_tile_t<D>(Ot, static_cast<const float*>(a.dout) + b * a.osb + h * a.osh, a.oss, i0,
                   a.Sq, a.vec);
    if (tid < kT) {
      const int64_t i = i0 + tid, at = (b * a.H + h) * a.Sq + i;
      const bool ok = i < a.Sq;
      S[tid] = ok ? a.stats[at] : 0.0f;
      S[kT + tid] = ok ? a.stats[plane + at] : 0.0f;
      S[2 * kT + tid] = ok ? a.stats[2 * plane + at] : 0.0f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int mm = 0; mm < 4; ++mm)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[mm][jj] = dp[mm][jj] = 0.0f;
    f32_abt<D>(s, Kt, Qt, rg, cg);      // s^T: keys x queries
    f32_abt<D>(dp, Vt, Ot, rg, cg);
    const bool full = i0 + kT <= a.Sq && tile_visible<W>(a, i0, kT, j0, kT);
#pragma unroll
    for (int mm = 0; mm < 4; ++mm)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = cg + 16 * jj;
        const int64_t i = i0 + col, key = j0 + rg + 16 * mm;
        const bool ok = full || (i < a.Sq && visible<W>(a, a.q_offset + i, key));
        const float p = ok ? expf(s[mm][jj] * a.scale - S[col]) : 0.0f;
        Ps[col * kXSt + rg + 16 * mm] = p * S[kT + col];
        Ds[col * kXSt + rg + 16 * mm] = p * (dp[mm][jj] - S[2 * kT + col]) * S[kT + col];
      }
    __syncthreads();                    // every key's p / l and ds are staged
    // each step's sums apart, then added (shorter fp32 chains)
    add_xy<D>(dv, Ps, Ot, rg, cg);
    add_xy<D>(dk, Ds, Qt, rg, cg);
  }

  float* dkp = static_cast<float*>(a.dk);
  float* dvp = static_cast<float*>(a.dv);
#pragma unroll
  for (int mm = 0; mm < 4; ++mm) {
    const int64_t j = j0 + rg + 16 * mm;
    if (j >= a.Skv) continue;
    const int64_t at = ((b * a.Skv + j) * a.Hkv + kvh) * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      dkp[at + cg + 16 * c] = dk[mm][c] * a.scale;
      dvp[at + cg + 16 * c] = dv[mm][c];
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t bytes, dim3 grid, int threads, const BwdArgs& a,
           cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Launch 1 then launch 2, on one stream: launch 2 reads launch 1's m, l
// and delta.
template <typename T, int D, bool W>
int launch_dim(const BwdArgs& a, cudaStream_t stream) {
  const dim3 g1(static_cast<unsigned>((a.Sq + kT - 1) / kT), a.H, a.B);
  const dim3 g2(static_cast<unsigned>((a.Skv + kT - 1) / kT), a.Hkv, a.B);
  int rc;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    rc = launch(flash_bwd_dq_bf16<D, W>, bf16_smem_bytes<D>(false), g1, kBf16Threads, a, stream);
    if (rc != 0) return rc;
    rc = launch(flash_bwd_dkv_bf16<D, W>, bf16_smem_bytes<D>(true), g2, kBf16Threads, a, stream);
  } else {
    rc = launch(flash_bwd_dq_f32<D, W>, f32_smem_bytes<D>(false), g1, kF32Threads, a, stream);
    if (rc != 0) return rc;
    rc = launch(flash_bwd_dkv_f32<D, W>, f32_smem_bytes<D>(true), g2, kF32Threads, a, stream);
  }
  return rc;
}

template <typename T, bool W>
int launch_window(const BwdArgs& a, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_dim<T, 16, W>(a, stream);
    case 32: return launch_dim<T, 32, W>(a, stream);
    case 64: return launch_dim<T, 64, W>(a, stream);
    case 128: return launch_dim<T, 128, W>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_type(const BwdArgs& a, int D, cudaStream_t stream) {
  return a.window > 0 ? launch_window<T, true>(a, D, stream)
                      : launch_window<T, false>(a, D, stream);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  Strides in elements; the head dim is
// contiguous in q, k, v and dout.  dq (B, Sq, H, D) and dk, dv (B, Skv,
// Hkv, D) are contiguous and written whole; stats is a workspace of 3 * B *
// H * Sq floats (m, 1 / l, delta), written by the first launch and read by
// the second.  window > 0 is the sliding window; 0 is none.  Sq, Skv, B and
// Hkv are at least 1.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
    void* dv, void* stats, int dtype, int B, int Sq, int Skv, int H, int Hkv, int D,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb, long long oss, long long osh,
    int q_offset, int kv_len, int causal, int window, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || H % Hkv != 0 || stats == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.stats = static_cast<float*>(stats);
  a.qsb = qsb; a.qss = qss; a.qsh = qsh;
  a.ksb = ksb; a.kss = kss; a.ksh = ksh;
  a.vsb = vsb; a.vss = vss; a.vsh = vsh;
  a.osb = osb; a.oss = oss; a.osh = osh;
  a.B = B;
  a.Sq = Sq;
  a.Skv = Skv;
  a.H = H;
  a.Hkv = Hkv;
  a.G = H / Hkv;
  a.q_offset = q_offset;
  a.kv_len = kv_len;
  a.causal = causal;
  a.window = window > 0 ? window : 0;
  a.scale = scale;
  // 16-byte loads need every row start 16-byte aligned: the base pointers
  // and every stride a multiple of 16 bytes (D always is).
  const long long vec = dtype == 0 ? 4 : 8;
  const long long strides[12] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
  a.vec = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16 == 0;
  for (long long st : strides) a.vec = a.vec && st % vec == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_type<float>(a, D, s);
  if (dtype == 1) return launch_type<__nv_bfloat16>(a, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
