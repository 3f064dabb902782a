// K6's backward: dq, dk and dv of causal GQA flash attention, for Hopper
// (sm_90a).
//
// It replaces no TPU kernel: `repro` trains through its pure-JAX attention
// (blocked_attention under jax.checkpoint) and its Pallas kernel has no
// backward.  It replaces the port's plain recompute,
// repro_torch/kernels/flash_attention/ref.py::flash_attention_grads, and
// computes what that computes: the gradient of flash_attention_plain
// (ref.py) at q, k, v for the output gradient dout, with its masks (keys at
// or past kv_len; causal at q_offset; the sliding window).
//
// q, dout (B, Sq, H, D) and k, v (B, Skv, Hkv, D) are read in place through
// their strides (the head dim contiguous); dq, dk, dv are contiguous and of
// the input type; query head h reads KV head h / G.  fp32 or bf16; D in
// {16, 32, 64, 128}.
//
// Two routes, each two launches on the caller's stream, no atomics and no
// zeroed state, so two calls give the same bits.  Tiles wholly masked
// (causally, past kv_len, or below the window) are not visited; a tile
// that no mask touches skips the mask tests.  The window is a template
// flag, compiled out without one.  A row with no visible key gets no
// gradient and adds none (the forward gives it a zero output).
//
// bf16 at D = 64 and 128 (flash_bwd_*_wg): the forward saved its output O
// and each row's logsumexp lse2 (log2 units; flash_attention.cu's LSE
// flag), so nothing is recomputed.  With c2 = scale log2 e, P = 2^(s c2 -
// lse2) = p / l in one FFMA and ex2, and delta = dO . O, as FlashAttention-2
// and SDPA's backward form it.
//   1. dQ (flash_bwd_dq_wg): 256 threads a block of 128 flattened rows rho
//      = i G + g of one (batch, KV head), as the forward's prefill, so the
//      group's heads share each K / V tile; each warpgroup owns 64 rows.  A
//      prologue forms delta of the block's rows (fp32) and writes it to the
//      workspace for launch 2.  Per key tile: S = Q K^T and dP = dO V^T by
//      wgmma m64n64k16 from shared memory, P on the accumulator fragments,
//      dS = P (dP - delta) rounded to bf16 as the register A operand, dQ +=
//      dS K by wgmma with K MN-major; dQ is summed in fp32 registers and
//      written once.
//   2. dK and dV (flash_bwd_dkv_ws): a block of 128 keys of one (batch, KV
//      head), two consumer warpgroups of 64 keys each and one producer
//      warp.  The producer copies K and V once and each step's Q and dO
//      tiles with TMA (cp.async.bulk.tensor, the 128-byte swizzle done by
//      the copy) and the rows' lse and delta with its 32 lanes, into a ring
//      of two stages; full and empty mbarriers a stage stand in for block
//      barriers, so the warpgroups run apart.  Each warpgroup walks the G
//      query heads of the group, then the query tiles that see its keys,
//      in that fixed order: S^T = K Q^T and dP^T = V dO^T by wgmma, P^T and
//      dS^T in registers as A operands, dV += P^T dO and dK += dS^T Q by
//      wgmma with dO and Q MN-major.  At D = 128, and for views whose
//      strides TMA does not take, flash_bwd_dkv_wg: one warpgroup a block
//      of 64 keys, two blocks an SM, its tiles copied by its own threads
//      (cp.async) between block barriers, the same walk.
//   Each warpgroup commits S and dP as two groups and forms P while dP's
//   products run (and, in launch 2 at D = 64, dS while dV's run).
// 3 products a visited pair in launch 1 and 4 in launch 2: 7, against
// FlashAttention-2's 5.  Every tile sits in shared memory in wgmma's
// 128-byte-swizzled layout, filled by cp.async 16-byte copies straight
// from the strided views.
//
// fp32, and bf16 at D = 16 and 32 (flash_bwd_*_bf16, flash_bwd_*_f32): only
// q, k and v are saved, so the scores are recomputed.  With s the scaled,
// masked scores, m the row max, p = exp(s - m), l = max(sum p, 1e-30) and p~
// = p rounded to the input type (as the forward rounds it),
//
//   dp = dO V^T,   delta = sum_j p~ dp / l,   ds = p (dp - delta) / l,
//   dq = scale ds K,   dk = scale ds^T Q,   dv = (p / l)^T dO.
//
//   1. dQ: one block per (64-row query tile, head, batch), the tiles with
//      the most keys first.  Pass 1 walks the key tiles the tile's rows can
//      see (ref.key_range) with an online softmax: the row max m, the row
//      sum l and delta (rescaled as m grows), written with 1 / l to a
//      workspace, fp32 (3, B, H, Sq).  Pass 2 walks the same tiles again and
//      adds dq += ds K over them in order.
//   2. dK and dV: one block per (64-key tile, KV head, batch), walking the G
//      query heads of its group, then the query tiles that see its keys
//      (the same pairs as launch 1), in that fixed order: dv += (p / l)^T
//      dO, dk += ds^T Q, both sums fp32 in registers, written once.
// bf16 runs every product on mma.sync m16n8k16 (fp32 accumulate; each warp
// owns 16 rows, or 16 keys in launch 2), operands read with ldmatrix from
// row-major tiles padded 16 bytes a row, in a ring of kStages stages; p / l
// and ds are rounded to bf16 as the A operands of their products.  fp32
// runs scalar FMAs (no TF32), 256 threads as 16 row groups x 16 column
// groups, expf; each tile's (or step's) sum is formed apart and then added,
// which keeps the fp32 chains short (a dK of G = 8 heads summed in one
// chain of 1,200 terms was 1.2e-6 of its max off the tiles' emulation).
// 9 products a visited pair.
//
// Bound, one H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), B = 4, S = 4096,
// H = 32, Hkv = 4, D = 64, bf16, causal: 5 products x 1.4e11 FLOPs of the
// unmasked pairs -> 0.70 ms, operations; the wgmma route's 7 products 0.97
// ms.  What limits it (tools/k6_bwd_variants.py, one H100 80GB HBM3 at
// 700 W, PERF.md): the two launches take ~3.0 ms there (launch 1 ~1.16,
// launch 2 ~1.81), a quarter of the 5-product bound; launch 1 without its
// copies 0.89 ms, without its exponentials 1.10; launch 2's producer warp
// took 13% off the cp.async version (whose copies held 0.74 of its 2.12
// ms).  Holding the stationary operands (Q, dO; K, V) in registers as
// wgmma A fragments gave wrong sums in a first try and was dropped.
//
// The kernel allocates nothing and does not synchronise; it returns
// cudaGetLastError() after each launch.  The Python wrapper
// (repro_torch/kernels/flash_attention/cuda.py::flash_attention_bwd_cuda)
// checks devices, types, shapes and strides, allocates dq, dk, dv and the
// workspace, and raises on a nonzero return.

#include <cuda.h>
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
  const void* out;            // bf16 at D >= 64: the forward's output (contiguous)
  const float* lse;           // ... and its rows' logsumexp, log2 units, (B, H, Sq)
  void* dq;
  void* dk;
  void* dv;
  float* stats;               // m, 1 / l, delta: three planes of (B, H, Sq);
                              // bf16 keeps m in the exponent's units (m scale log2 e);
                              // bf16 at D >= 64: delta alone, one plane
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

// ---- bf16 at D = 64, 128: wgmma on 128-byte-swizzled tiles, the
// forward's logsumexp and output saved ----

// Launch 1's warpgroups a block (each owns 64 rows; they share each
// walked K / V tile) and, at D = 64, its blocks an SM (the register cap:
// two blocks of 128 registers spill 140 bytes and ran 16% faster than one
// of 178, tools/k6_bwd_variants.py).
constexpr int kDqGroups = 2;
constexpr int kDqMinBlocks = 2;
// At D = 64, launch 2 with a producer warp (flash_bwd_dkv_ws) where TMA
// takes every view: 13% faster at train_4k than flash_bwd_dkv_wg, whose
// one warpgroup a block copies its own tiles between block barriers (and
// which two warpgroups a block, in lockstep, did not beat).  D = 128 and
// views TMA does not take run flash_bwd_dkv_wg.
constexpr bool kDkvProducer = true;
constexpr int kWgStages = 2;            // the ring of walked tiles

// wgmma (sm_90a), as the forward's bf16 prefill (flash_attention.cu): the
// descriptor of a 128-byte-swizzled tile (CUTLASS cute/arch/mma_sm90_desc.hpp):
// start address >> 4 in bits 0-13, the leading byte offset >> 4 in bits
// 16-29, the stride byte offset >> 4 in bits 32-45, layout type 1
// (SWIZZLE_128B) in bits 62-63.  Rows of 64 bf16 (128 bytes), 16-byte chunk
// c of row r at chunk c ^ (r % 8) inside a 1024-byte-aligned 8-row group:
//   K-major (rows m or n, the 16-deep k-step along a row): start at the
//     k-step's first chunk (+32 bytes a step), SBO = 1024, LBO unused;
//   MN-major (rows k, n along a row): start at the k-step's first row
//     (+2048 bytes a step of 16 rows), SBO = 1024, LBO = the next 64
//     columns of n.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32 | 1ull << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Registers an asynchronous wgmma writes: not read before the wgmma_wait
// that completes the write, no copy kept from before it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
// A fragments an asynchronous wgmma reads: held live, unchanged, up to the
// wgmma_wait that retires it.
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}
// Generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define WG_D32                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_OUT32(d)                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),       \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),     \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31])

// d (64 x 64, fp32; d = a b, or d += a b with `accumulate`) for a and b
// K-major in shared memory.  Thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 (+ 8) as mma.sync's m16n8 accumulator, once
// per 8 columns: d[4 j + e] is row + 8 (e / 2), column 8 j + 2 (t % 4) + e % 2.
__device__ __forceinline__ void wgmma_ss_64x64(float (&d)[32], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 64, fp32) += a b for a from registers (mma.sync's m16n8k16 A
// fragment of the thread's 16 rows) and b MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_64x64_mn(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
#undef WG_D32
#undef WG_OUT32

// Element offset of 16-byte chunk c of row r in a swizzled tile of `rows`
// rows: 64-column blocks one after another, rows of 128 bytes.
__device__ __forceinline__ int sw_at(int rows, int r, int c) {
  return (c >> 3) * rows * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

// ROWS rows of D bf16 into a swizzled tile by THREADS threads: row r from
// src + off(r), zeros where off(r) < 0.  One cp.async per chunk where `vec`
// (the caller commits and waits), else element by element.
template <int D, int ROWS, int THREADS, typename Off>
__device__ __forceinline__ void load_sw(bool vec, __nv_bfloat16* dst, const __nv_bfloat16* src,
                                        Off off) {
  constexpr int CH = D / 8;
  static_assert(ROWS * CH % THREADS == 0, "whole rounds of chunks");
  if (vec) {
#pragma unroll
    for (int e0 = 0; e0 < ROWS * CH; e0 += THREADS) {
      const int e = e0 + threadIdx.x, r = e / CH, c = e % CH;
      const int64_t o = off(r);
      cp_async16(smem_addr(dst + sw_at(ROWS, r, c)), o >= 0 ? src + o + c * 8 : src, o >= 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const int64_t o = off(r);
      dst[sw_at(ROWS, r, d / 8) + d % 8] = o >= 0 ? src[o + d] : __float2bfloat16(0.0f);
    }
  }
}

// d (64 x 64) = A B^T over the head dim: A the warpgroup's 64 rows of a
// tile of A_ROWS rows at a_addr, B the kT rows at b_addr, both K-major in
// shared memory; k-step ks reads chunks 2 ks, 2 ks + 1 of every row, in
// 64-column block ks / 4.
template <int D, int A_ROWS>
__device__ __forceinline__ void product_abt(float (&d)[32], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss_64x64(d, sw128_desc(a_addr + (ks >> 2) * A_ROWS * 128 + (ks & 3) * 32, 16, 1024),
                   sw128_desc(b_addr + (ks >> 2) * kT * 128 + (ks & 3) * 32, 16, 1024), ks > 0);
}

template <int D>
constexpr size_t wg_smem_bytes(bool dkv) {
  // launch 1: Q and dO (64 kDqGroups rows), kWgStages stages of K and V
  // (kT rows), the rows' lse and delta; launch 2: K and V (kT keys),
  // kWgStages stages of Q, dO and their rows' lse and delta; 1024 bytes to
  // align the tiles
  return sizeof(__nv_bfloat16) * D * (2 * (dkv ? kT : 64 * kDqGroups) + 2 * kWgStages * kT) +
         sizeof(float) * 2 * (dkv ? kWgStages * kT : 64 * kDqGroups) + 1024;
}

// Launch 1, bf16 at D = 64, 128: dQ.  A block of WGS warpgroups owns 64 WGS
// flattened rows rho = i G + g of one (batch, KV head), as the forward's
// prefill; warpgroup wg owns rows 64 wg .. + 63, warp w rows 16 w .. + 15.  Prologue: each row's
// delta = dO . O (fp32; two threads a row) into shared memory and the
// workspace, its lse beside it.  Per key tile: S = Q K^T and dP = dO V^T
// (wgmma, both K-major), P = 2^(S c2 - lse2), dS = P (dP - delta) rounded
// to bf16 as A fragments, dQ += dS K (wgmma, K MN-major).
template <int D, bool W, int WGS, int MINB>
__global__ void __launch_bounds__(128 * WGS, MINB)
flash_bwd_dq_wg(const BwdArgs a) {
  using T = __nv_bfloat16;
  constexpr int R = 64 * WGS, THREADS = 128 * WGS, NS = kWgStages, KTILE = kT * D;
  constexpr int NT = kT / 8, DT = D / 8;
  static_assert(D % 64 == 0, "wgmma tiles are 64-column blocks");
  extern __shared__ __align__(16) unsigned char dsmem[];
  unsigned char* base = dsmem + ((1024 - (smem_addr(dsmem) & 1023)) & 1023);
  T* Qs = reinterpret_cast<T*>(base);
  T* Os = Qs + R * D;
  T* ring = Os + R * D;                 // stage s: K at 2 s KTILE, V after it
  float* lse_s = reinterpret_cast<float*>(ring + 2 * NS * KTILE);
  float* delta_s = lse_s + R;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2;
  const int kvh = blockIdx.x % a.Hkv;
  // row tiles with the most key tiles first
  const int64_t tile = gridDim.x / a.Hkv - 1 - blockIdx.x / a.Hkv;
  const int64_t b = blockIdx.y;
  const int64_t rows = static_cast<int64_t>(a.Sq) * a.G;
  const int64_t rho0 = tile * R;
  // offset of flattened row r's (position, head) in a (B, Sq, H, D) view
  const auto row_off = [&](int r, int64_t sb, int64_t ss, int64_t sh) -> int64_t {
    const int64_t rho = rho0 + r;
    if (rho >= rows) return -1;
    return b * sb + (rho / a.G) * ss + (static_cast<int64_t>(kvh) * a.G + rho % a.G) * sh;
  };
  load_sw<D, R, THREADS>(a.vec, Qs, static_cast<const T*>(a.q),
                         [&](int r) { return row_off(r, a.qsb, a.qss, a.qsh); });
  load_sw<D, R, THREADS>(a.vec, Os, static_cast<const T*>(a.dout),
                         [&](int r) { return row_off(r, a.osb, a.oss, a.osh); });
  cp_async_commit();

  // The key tiles [j0, nkv): from the tile of the first row's first
  // visible key to the last row's causal end (the forward's prefill).
  int kv_end = a.kv_len;
  if (a.causal) {
    const int64_t last_row = rows - 1 < rho0 + R - 1 ? rows - 1 : rho0 + R - 1;
    const int causal_end = a.q_offset + static_cast<int>(last_row / a.G) + 1;
    if (causal_end < kv_end) kv_end = causal_end;
  }
  const int nkv = kv_end > 0 ? (kv_end - 1) / kT + 1 : 0;
  int j0 = 0;
  if constexpr (W) {
    const int64_t first = a.q_offset + rho0 / a.G - a.window + 1;
    if (first > 0) j0 = static_cast<int>(first / kT);
  }
  const T* kbase = static_cast<const T*>(a.k) + b * a.ksb + static_cast<int64_t>(kvh) * a.ksh;
  const T* vbase = static_cast<const T*>(a.v) + b * a.vsb + static_cast<int64_t>(kvh) * a.vsh;
  const auto load_kv = [&](int j) {
    const int64_t k0 = static_cast<int64_t>(j) * kT;
    T* Ks = ring + (j % NS) * 2 * KTILE;
    load_sw<D, kT, THREADS>(a.vec, Ks, kbase, [&](int r) -> int64_t {
      return k0 + r < a.Skv ? (k0 + r) * a.kss : -1;
    });
    load_sw<D, kT, THREADS>(a.vec, Ks + KTILE, vbase, [&](int r) -> int64_t {
      return k0 + r < a.Skv ? (k0 + r) * a.vss : -1;
    });
  };
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {
    if (j0 + j < nkv) load_kv(j0 + j);
    cp_async_commit();
  }

  cp_async_wait<NS - 1>();              // Q and dO have landed (this thread's part)
  __syncthreads();                      // ... every thread's
  {
    // delta of row r = tid / 2, half the head dim a thread: dO from its
    // tile, O (contiguous, from the forward) from device memory
    const int r = tid >> 1, half = tid & 1;
    const int64_t rho = rho0 + r;
    const int64_t i = rho / a.G, h = static_cast<int64_t>(kvh) * a.G + rho % a.G;
    float d = 0.0f, l2 = 0.0f;
    if (rho < rows) {
      const T* orow = static_cast<const T*>(a.out) + ((b * a.Sq + i) * a.H + h) * D;
#pragma unroll
      for (int cc = 0; cc < D / 16; ++cc) {
        const int c = half * (D / 16) + cc;
        const uint4 x = *reinterpret_cast<const uint4*>(orow + c * 8);
        const uint4 y = *reinterpret_cast<const uint4*>(Os + sw_at(R, r, c));
        const __nv_bfloat162* xo = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yo = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 fo = __bfloat1622float2(xo[u]), fd = __bfloat1622float2(yo[u]);
          d = fmaf(fo.x, fd.x, d);
          d = fmaf(fo.y, fd.y, d);
        }
      }
      l2 = a.lse[(b * a.H + h) * a.Sq + i];
    }
    d += __shfl_xor_sync(kFull, d, 1);
    if (half == 0) {
      delta_s[r] = d;                   // padded rows: 0 (their dS is 0)
      lse_s[r] = l2;
      if (rho < rows) a.stats[(b * a.H + h) * a.Sq + i] = d;   // for launch 2
    }
  }
  __syncthreads();

  const int wr0 = warp * 16;            // this warp's first row in the block
  const float lse2[2] = {lse_s[wr0 + g], lse_s[wr0 + g + 8]};
  const float dl[2] = {delta_s[wr0 + g], delta_s[wr0 + g + 8]};
  const int qpos[2] = {a.q_offset + static_cast<int>((rho0 + wr0 + g) / a.G),
                       a.q_offset + static_cast<int>((rho0 + wr0 + g + 8) / a.G)};
  // the warp's first row, the warpgroup's first and last rows: a tile
  // wholly above the warpgroup's rows or below their windows is skipped
  const int wpos_lo = a.q_offset + static_cast<int>((rho0 + wr0) / a.G);
  const int upos_lo = a.q_offset + static_cast<int>((rho0 + wg * 64) / a.G);
  const int upos_hi = a.q_offset + static_cast<int>((rho0 + wg * 64 + 63) / a.G);
  const float c2 = a.scale * kLog2e;    // P = 2^(s c2 - lse2)
  const uint32_t q_addr = smem_addr(Qs) + wg * 64 * 128, o_addr = smem_addr(Os) + wg * 64 * 128;

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;

  for (int j = j0; j < nkv; ++j) {
    cp_async_wait<NS - 2>();            // tile j has landed (this thread's part)
    fence_proxy_async();
    __syncthreads();                    // ... every thread's; tile j - 1 is used
    if (j + NS - 1 < nkv) load_kv(j + NS - 1);
    cp_async_commit();

    const int k0 = j * kT;
    if (a.causal && k0 > upos_hi) continue;
    if (W && k0 + kT - 1 < upos_lo - a.window + 1) continue;
    const T* Ks = ring + (j % NS) * 2 * KTILE;
    const uint32_t ks_addr = smem_addr(Ks), vs_addr = smem_addr(Ks + KTILE);

    // S = Q K^T, then dP = dO V^T, each its own group: P is formed while
    // dP's products run.
    float s[NT][4], dp[NT][4];
    wgmma_fence();
    product_abt<D, R>(reinterpret_cast<float(&)[32]>(s), q_addr, ks_addr);
    wgmma_commit();
    product_abt<D, R>(reinterpret_cast<float(&)[32]>(dp), o_addr, vs_addr);
    wgmma_commit();
    wgmma_wait<1>();                    // S has landed
    reg_fence(reinterpret_cast<float(&)[NT * 4]>(s));

    // s[nt][e]: row wr0 + g + 8 (e / 2), key k0 + 8 nt + 2 t4 + e % 2.  Only
    // a tile that crosses kv_len, one of the warp's diagonals or the lower
    // edge of a window is masked.
    if (k0 + kT > a.kv_len || (a.causal && k0 + kT - 1 > wpos_lo) ||
        (W && k0 <= upos_hi - a.window)) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + nt * 8 + 2 * t4 + (e & 1);
          if (kp >= a.kv_len || (a.causal && kp > qpos[e >> 1]) ||
              (W && qpos[e >> 1] - kp >= a.window))
            s[nt][e] = -CUDART_INF_F;
        }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)   // P; masked: 0
        s[nt][e] = exp2_approx(fmaf(s[nt][e], c2, -lse2[e >> 1]));
    wgmma_wait<0>();                    // dP has landed
    reg_fence(reinterpret_cast<float(&)[NT * 4]>(dp));
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = s[nt][e] * (dp[nt][e] - dl[e >> 1]);
      pa[nt / 2][(nt & 1) * 2] = pack_bf16(x[0], x[1]);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(x[2], x[3]);
    }
    // dQ += dS K: k-step kk is keys 16 kk .. + 15 (rows of K), and 64-column
    // block n of dQ reads K's block n.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
#pragma unroll
      for (int n = 0; n < D / 64; ++n)
        wgmma_rs_64x64_mn(reinterpret_cast<float(&)[32]>(acc[8 * n]), pa[kk],
                          sw128_desc(ks_addr + n * kT * 128 + kk * 16 * 128, kT * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(reinterpret_cast<float(&)[DT * 4]>(acc));
    reg_fence(pa);
  }
  cp_async_wait_all();

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int64_t rho = rho0 + wr0 + g + 8 * hr;
    if (rho >= rows) continue;
    const int64_t h = static_cast<int64_t>(kvh) * a.G + rho % a.G;
    T* row = dq + ((b * a.Sq + rho / a.G) * a.H + h) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(row + dt * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[dt][2 * hr] * a.scale, acc[dt][2 * hr + 1] * a.scale);
  }
}

// Launch 2, bf16 at D = 64, 128: dK and dV.  A block of one warpgroup owns
// 64 keys of one (batch, KV head) (warp w keys 16 w .. + 15), K and V in
// shared memory.  It walks the G query heads of the group, then the query
// tiles that see its keys, in that order (the pairs and the order of the
// mma.sync route's launch 2).  Per tile: S^T = K
// Q^T and dP^T = V dO^T (wgmma, K-major), P^T = 2^(S^T c2 - lse2) and dS^T =
// P^T (dP^T - delta) in registers as A fragments, dV += P^T dO and dK +=
// dS^T Q (wgmma, dO and Q MN-major).  Q, dO and the rows' lse and delta come
// through a ring of kWgStages stages filled by cp.async.
template <int D, bool W>
__global__ void __launch_bounds__(128, 1)
flash_bwd_dkv_wg(const BwdArgs a) {
  using T = __nv_bfloat16;
  constexpr int R = kT, THREADS = 128, NS = kWgStages, QTILE = kT * D;
  constexpr int NT = kT / 8, DT = D / 8;
  static_assert(D % 64 == 0, "wgmma tiles are 64-column blocks");
  extern __shared__ __align__(16) unsigned char dsmem[];
  unsigned char* base = dsmem + ((1024 - (smem_addr(dsmem) & 1023)) & 1023);
  T* Ks = reinterpret_cast<T*>(base);
  T* Vs = Ks + R * D;
  T* ring = Vs + R * D;                 // stage s: Q at 2 s QTILE, dO after it
  float* stat_ring = reinterpret_cast<float*>(ring + 2 * NS * QTILE);   // stage s: [2][kT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * R;
  const int kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  int lo, hi;                           // the query tiles that see the block's keys
  query_tiles<W>(a, j0, lo, hi);
  const int nqt = hi - lo;
  const int steps = nqt * a.G;          // (head in group, query tile), head outer
  const float c2 = a.scale * kLog2e;    // P = 2^(s c2 - lse2)

  const auto load_q = [&](int step, int st) {
    const int64_t h = static_cast<int64_t>(kvh) * a.G + step / nqt;
    const int64_t i0 = static_cast<int64_t>(lo + step % nqt) * kT;
    T* Qt = ring + st * 2 * QTILE;
    load_sw<D, kT, THREADS>(a.vec, Qt, static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh,
                            [&](int r) -> int64_t { return i0 + r < a.Sq ? (i0 + r) * a.qss : -1; });
    load_sw<D, kT, THREADS>(a.vec, Qt + QTILE,
                            static_cast<const T*>(a.dout) + b * a.osb + h * a.osh,
                            [&](int r) -> int64_t { return i0 + r < a.Sq ? (i0 + r) * a.oss : -1; });
    if (tid < 2 * kT) {                 // the rows' lse, then their delta
      const int64_t i = i0 + tid % kT;
      const bool ok = i < a.Sq;
      const float* src = (tid < kT ? a.lse : a.stats) + (b * a.H + h) * a.Sq + (ok ? i : 0);
      cp_async4(smem_addr(stat_ring + st * 2 * kT + tid), src, ok);
    }
  };
  load_sw<D, R, THREADS>(a.vec, Ks, static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh,
                         [&](int r) -> int64_t { return j0 + r < a.Skv ? (j0 + r) * a.kss : -1; });
  load_sw<D, R, THREADS>(a.vec, Vs, static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh,
                         [&](int r) -> int64_t { return j0 + r < a.Skv ? (j0 + r) * a.vss : -1; });
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {    // K and V ride with the first stage
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
  const uint32_t k_addr = smem_addr(Ks), v_addr = smem_addr(Vs);
  // D = 128 forms dS^T before dV's products, not while they run: P^T and
  // dS^T together with dK and dV would not fit in the registers
  constexpr bool kOverlap = D == 64;

  for (int step = 0; step < steps; ++step) {
    const int st = step % NS;
    cp_async_wait<NS - 2>();            // step's tiles have landed (this thread's part)
    fence_proxy_async();
    __syncthreads();                    // ... every thread's; the last stage is free
    if (step + NS - 1 < steps) load_q(step + NS - 1, (step + NS - 1) % NS);
    cp_async_commit();
    const int64_t i0 = static_cast<int64_t>(lo + step % nqt) * kT;
    const T* Qt = ring + st * 2 * QTILE;
    const uint32_t q_addr = smem_addr(Qt), o_addr = smem_addr(Qt + QTILE);
    const float* S = stat_ring + st * 2 * kT;   // the tile's lse, then its delta

    // S^T = K Q^T, then dP^T = V dO^T, each its own group: the block's 64
    // keys x the tile's 64 queries.  P^T is formed while dP^T's products
    // run, and at D = 64 dS^T while dV's run.
    float s[NT][4], dp[NT][4];
    wgmma_fence();
    product_abt<D, R>(reinterpret_cast<float(&)[32]>(s), k_addr, q_addr);
    wgmma_commit();
    product_abt<D, R>(reinterpret_cast<float(&)[32]>(dp), v_addr, o_addr);
    wgmma_commit();
    wgmma_wait<1>();                    // S^T has landed
    reg_fence(reinterpret_cast<float(&)[NT * 4]>(s));

    // s[nt][e]: key keys[e / 2], query i0 + 8 nt + 2 t4 + e % 2.  Only a
    // tile whose queries do not all see the warp's keys (or run past Sq)
    // is masked.
    if (!(i0 + kT <= a.Sq && tile_visible<W>(a, i0, kT, key0, 16))) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t i = i0 + nt * 8 + 2 * t4 + (e & 1);
          if (i >= a.Sq || !visible<W>(a, a.q_offset + i, keys[e >> 1])) s[nt][e] = -CUDART_INF_F;
        }
    }
    uint32_t pp[NT / 2][4], pd[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 ls = *reinterpret_cast<const float2*>(S + nt * 8 + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e)   // P^T; masked: 0
        s[nt][e] = exp2_approx(fmaf(s[nt][e], c2, -(e & 1 ? ls.y : ls.x)));
      pp[nt / 2][(nt & 1) * 2] = pack_bf16(s[nt][0], s[nt][1]);
      pp[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(s[nt][2], s[nt][3]);
    }
    // dS^T = P^T (dP^T - delta), rounded into pd
    const auto form_ds = [&]() {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 dl = *reinterpret_cast<const float2*>(S + kT + nt * 8 + 2 * t4);
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] = s[nt][e] * (dp[nt][e] - (e & 1 ? dl.y : dl.x));
        pd[nt / 2][(nt & 1) * 2] = pack_bf16(y[0], y[1]);
        pd[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(y[2], y[3]);
      }
    };
    if constexpr (!kOverlap) {
      wgmma_wait<0>();                  // dP^T has landed
      reg_fence(reinterpret_cast<float(&)[NT * 4]>(dp));
      form_ds();
    }
    // dV += P^T dO: k-step kk is queries 16 kk .. + 15 (rows of dO), and
    // 64-column block n reads dO's block n.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
#pragma unroll
      for (int n = 0; n < D / 64; ++n)
        wgmma_rs_64x64_mn(reinterpret_cast<float(&)[32]>(dv[8 * n]), pp[kk],
                          sw128_desc(o_addr + n * kT * 128 + kk * 16 * 128, kT * 128, 1024));
    if constexpr (kOverlap) {
      wgmma_commit();
      wgmma_wait<1>();                  // dP^T has landed; dV may not
      reg_fence(reinterpret_cast<float(&)[NT * 4]>(dp));
      form_ds();
      wgmma_fence();
    }
    // dK += dS^T Q, as dV
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
#pragma unroll
      for (int n = 0; n < D / 64; ++n)
        wgmma_rs_64x64_mn(reinterpret_cast<float(&)[32]>(dk[8 * n]), pd[kk],
                          sw128_desc(q_addr + n * kT * 128 + kk * 16 * 128, kT * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(reinterpret_cast<float(&)[DT * 4]>(dv));
    reg_fence(reinterpret_cast<float(&)[DT * 4]>(dk));
    reg_fence(pp);
    reg_fence(pd);
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

// ---- launch 2 with a producer warp: TMA copies and mbarriers ----

// The four bf16 views as TMA tensor maps: (D, S, heads, B), innermost
// first, boxes of 64 columns x 64 rows in wgmma's 128-byte swizzle.
struct TmaMaps {
  CUtensorMap q, dout, k, v;
};

constexpr int kWsGroups = 2;            // consumer warpgroups a block, 64 keys each
constexpr int kWsThreads = 128 * kWsGroups + 32;   // and one producer warp
constexpr int kWsStages = 2;            // the ring of (Q, dO, lse, delta)

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}
// One arrival, and `bytes` more to come from TMA copies.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// Until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}
// A 64 x 64 box of the 4-D map at (column c0, row c1, head c2, batch c3)
// into shared memory at dst, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

template <int D>
constexpr size_t ws_smem_bytes() {
  // K and V (64 kWsGroups keys), kWsStages stages of Q, dO (kT rows) and
  // their rows' lse and delta, the barriers; 1024 bytes to align
  return sizeof(__nv_bfloat16) * D * (2 * 64 * kWsGroups + 2 * kWsStages * kT) +
         sizeof(float) * 2 * kWsStages * kT + sizeof(uint64_t) * (2 * kWsStages + 1) + 1024;
}

// Launch 2 with a producer warp (bf16 at D = 64, 128, every view's strides
// 16-byte multiples): kWsGroups consumer warpgroups of 64 keys each share
// every Q / dO tile.  The producer warp's first lane copies K, V and each
// step's Q and dO tiles with TMA (the swizzle done by the copy), its 32
// lanes the rows' lse and delta; full and empty mbarriers a stage replace
// the block barrier, so the warpgroups run apart.  Each consumer
// warpgroup computes as flash_bwd_dkv_wg, over the block's query tiles,
// multiplying those that see its own keys.
template <int D, bool W>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dkv_ws(const BwdArgs a, const __grid_constant__ TmaMaps maps) {
  using T = __nv_bfloat16;
  constexpr int R = 64 * kWsGroups, NS = kWsStages, QTILE = kT * D;
  constexpr int NT = kT / 8, DT = D / 8;
  static_assert(D % 64 == 0, "wgmma tiles are 64-column blocks");
  extern __shared__ __align__(16) unsigned char dsmem[];
  unsigned char* base = dsmem + ((1024 - (smem_addr(dsmem) & 1023)) & 1023);
  T* Ks = reinterpret_cast<T*>(base);
  T* Vs = Ks + R * D;
  T* ring = Vs + R * D;                 // stage s: Q at 2 s QTILE, dO after it
  float* stat_ring = reinterpret_cast<float*>(ring + 2 * NS * QTILE);   // stage s: [2][kT]
  uint64_t* full = reinterpret_cast<uint64_t*>(stat_ring + NS * 2 * kT);
  uint64_t* empty = full + NS;
  uint64_t* kv_bar = empty + NS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;             // kWsGroups: the producer warp
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * R;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  // the query tiles of each warpgroup's keys, and the block's (their span)
  int lo = 0, hi = 0, my_lo = 0, my_hi = 0;
#pragma unroll
  for (int u = 0; u < kWsGroups; ++u) {
    int l, h;
    query_tiles<W>(a, j0 + u * kT, l, h);
    if (u == wg) my_lo = l, my_hi = h;
    if (h > l) {
      lo = hi > lo && lo < l ? lo : l;
      hi = hi > h ? hi : h;
    }
  }
  const int nqt = hi - lo;
  const int steps = nqt * a.G;          // (head in group, query tile), head outer

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 33);          // the first lane's copies and the 32 lanes' rows
      mbar_init(empty + s, 128 * kWsGroups);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kWsGroups) {                // the producer warp
    if (lane == 0) {
      mbar_arrive_tx(kv_bar, 2 * R * D * sizeof(T));
      for (int half = 0; half < R / kT; ++half)
        for (int n = 0; n < D / 64; ++n) {
          const int off = n * R * 64 + half * kT * 64;
          tma_load(Ks + off, &maps.k, n * 64, static_cast<int>(j0) + half * kT, kvh, b, kv_bar);
          tma_load(Vs + off, &maps.v, n * 64, static_cast<int>(j0) + half * kT, kvh, b, kv_bar);
        }
    }
    for (int step = 0; step < steps; ++step) {
      const int st = step % NS;
      if (step >= NS) mbar_wait(empty + st, (step / NS - 1) & 1);
      const int h = kvh * a.G + step / nqt;
      const int i0 = (lo + step % nqt) * kT;
      T* Qt = ring + st * 2 * QTILE;
      if (lane == 0) {
        mbar_arrive_tx(full + st, 2 * QTILE * sizeof(T));
        for (int n = 0; n < D / 64; ++n) {
          tma_load(Qt + n * kT * 64, &maps.q, n * 64, i0, h, b, full + st);
          tma_load(Qt + QTILE + n * kT * 64, &maps.dout, n * 64, i0, h, b, full + st);
        }
      }
      float* S = stat_ring + st * 2 * kT;   // the rows' lse, then their delta
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = lane + 32 * u;
        const int64_t i = i0 + e % kT;
        const float* src = e < kT ? a.lse : a.stats;
        S[e] = i < a.Sq ? src[(static_cast<int64_t>(b) * a.H + h) * a.Sq + i] : 0.0f;
      }
      mbar_arrive(full + st);
    }
    return;
  }

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.0f;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t key0 = j0 + warp * 16;  // the warp's first key
  const int64_t keys[2] = {key0 + g, key0 + g + 8};
  const uint32_t k_addr = smem_addr(Ks) + wg * 64 * 128, v_addr = smem_addr(Vs) + wg * 64 * 128;
  const float c2 = a.scale * kLog2e;    // P = 2^(s c2 - lse2)
  constexpr bool kOverlap = D == 64;    // as flash_bwd_dkv_wg
  mbar_wait(kv_bar, 0);

  for (int step = 0; step < steps; ++step) {
    const int st = step % NS;
    mbar_wait(full + st, (step / NS) & 1);
    const int qt = lo + step % nqt;
    if (qt >= my_lo && qt < my_hi) {
      const int64_t i0 = static_cast<int64_t>(qt) * kT;
      const T* Qt = ring + st * 2 * QTILE;
      const uint32_t q_addr = smem_addr(Qt), o_addr = smem_addr(Qt + QTILE);
      const float* S = stat_ring + st * 2 * kT;
      float s[NT][4], dp[NT][4];
      wgmma_fence();
      product_abt<D, R>(reinterpret_cast<float(&)[32]>(s), k_addr, q_addr);
      wgmma_commit();
      product_abt<D, R>(reinterpret_cast<float(&)[32]>(dp), v_addr, o_addr);
      wgmma_commit();
      wgmma_wait<1>();                  // S^T has landed
      reg_fence(reinterpret_cast<float(&)[NT * 4]>(s));
      if (!(i0 + kT <= a.Sq && tile_visible<W>(a, i0, kT, key0, 16))) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int64_t i = i0 + nt * 8 + 2 * t4 + (e & 1);
            if (i >= a.Sq || !visible<W>(a, a.q_offset + i, keys[e >> 1])) s[nt][e] = -CUDART_INF_F;
          }
      }
      uint32_t pp[NT / 2][4], pd[NT / 2][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 ls = *reinterpret_cast<const float2*>(S + nt * 8 + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e)     // P^T; masked: 0
          s[nt][e] = exp2_approx(fmaf(s[nt][e], c2, -(e & 1 ? ls.y : ls.x)));
        pp[nt / 2][(nt & 1) * 2] = pack_bf16(s[nt][0], s[nt][1]);
        pp[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(s[nt][2], s[nt][3]);
      }
      const auto form_ds = [&]() {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 dl = *reinterpret_cast<const float2*>(S + kT + nt * 8 + 2 * t4);
          float y[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) y[e] = s[nt][e] * (dp[nt][e] - (e & 1 ? dl.y : dl.x));
          pd[nt / 2][(nt & 1) * 2] = pack_bf16(y[0], y[1]);
          pd[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(y[2], y[3]);
        }
      };
      if constexpr (!kOverlap) {
        wgmma_wait<0>();
        reg_fence(reinterpret_cast<float(&)[NT * 4]>(dp));
        form_ds();
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
#pragma unroll
        for (int n = 0; n < D / 64; ++n)
          wgmma_rs_64x64_mn(reinterpret_cast<float(&)[32]>(dv[8 * n]), pp[kk],
                            sw128_desc(o_addr + n * kT * 128 + kk * 16 * 128, kT * 128, 1024));
      if constexpr (kOverlap) {
        wgmma_commit();
        wgmma_wait<1>();                // dP^T has landed; dV may not
        reg_fence(reinterpret_cast<float(&)[NT * 4]>(dp));
        form_ds();
        wgmma_fence();
      }
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk)
#pragma unroll
        for (int n = 0; n < D / 64; ++n)
          wgmma_rs_64x64_mn(reinterpret_cast<float(&)[32]>(dk[8 * n]), pd[kk],
                            sw128_desc(q_addr + n * kT * 128 + kk * 16 * 128, kT * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(reinterpret_cast<float(&)[DT * 4]>(dv));
      reg_fence(reinterpret_cast<float(&)[DT * 4]>(dk));
      reg_fence(pp);
      reg_fence(pd);
    }
    mbar_arrive(empty + st);            // the stage's tiles are used
  }

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int64_t j = keys[hr];
    if (j >= a.Skv) continue;
    const int64_t at = ((static_cast<int64_t>(b) * a.Skv + j) * a.Hkv + kvh) * D;
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

// cuTensorMapEncodeTiled through the runtime's driver entry point (no
// link against the driver library); null where the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static bool asked = false;
  if (!asked) {
    asked = true;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The TMA map of a (B, S, heads, D) bf16 view with element strides sb, ss,
// sh: false where TMA does not take it (a stride not a positive multiple of
// 16 bytes, or no encoder).
bool encode_view(CUtensorMap* map, const void* base, int D, int S, int heads, int B,
                 int64_t sb, int64_t ss, int64_t sh) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0) return false;
  const int64_t element_strides[3] = {sb, ss, sh};
  for (int64_t st : element_strides)
    if (st <= 0 || st % 8 != 0) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(kT), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
// and delta (bf16 at D >= 64: its delta).
template <typename T, int D, bool W>
int launch_dim(const BwdArgs& a, cudaStream_t stream) {
  const dim3 g1(static_cast<unsigned>((a.Sq + kT - 1) / kT), a.H, a.B);
  const dim3 g2(static_cast<unsigned>((a.Skv + kT - 1) / kT), a.Hkv, a.B);
  int rc;
  if constexpr (std::is_same<T, __nv_bfloat16>::value && D >= 64) {
    constexpr int R1 = 64 * kDqGroups;
    const int64_t tiles = (static_cast<int64_t>(a.Sq) * a.G + R1 - 1) / R1;
    if (tiles * a.Hkv > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 w1(static_cast<unsigned>(tiles * a.Hkv), a.B);
    rc = launch(flash_bwd_dq_wg<D, W, kDqGroups, D == 64 ? kDqMinBlocks : 1>,
                wg_smem_bytes<D>(false), w1, 2 * R1, a, stream);
    if (rc != 0) return rc;
    if constexpr (D == 64 && kDkvProducer) {
      // launch 2 with a producer warp where TMA takes every view
      TmaMaps maps;
      if (encode_view(&maps.q, a.q, D, a.Sq, a.H, a.B, a.qsb, a.qss, a.qsh) &&
          encode_view(&maps.dout, a.dout, D, a.Sq, a.H, a.B, a.osb, a.oss, a.osh) &&
          encode_view(&maps.k, a.k, D, a.Skv, a.Hkv, a.B, a.ksb, a.kss, a.ksh) &&
          encode_view(&maps.v, a.v, D, a.Skv, a.Hkv, a.B, a.vsb, a.vss, a.vsh)) {
        const auto kernel = flash_bwd_dkv_ws<D, W>;
        constexpr size_t bytes = ws_smem_bytes<D>();
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
        if (err != cudaSuccess) return static_cast<int>(err);
        const dim3 w2(static_cast<unsigned>((a.Skv + 64 * kWsGroups - 1) / (64 * kWsGroups)),
                      a.Hkv, a.B);
        kernel<<<w2, kWsThreads, bytes, stream>>>(a, maps);
        return static_cast<int>(cudaGetLastError());
      }
    }
    rc = launch(flash_bwd_dkv_wg<D, W>, wg_smem_bytes<D>(true), g2, 128, a, stream);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
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
// the second.  bf16 at D = 64 and 128 takes the forward's out (contiguous
// (B, Sq, H, D), 16-byte aligned) and lse (B * H * Sq floats, log2 units),
// and B * H * Sq floats of stats (delta); every other call takes neither.
// window > 0 is the sliding window; 0 is none.  Sq, Skv, B and Hkv are at
// least 1.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* out,
    const void* lse, void* dq, void* dk, void* dv, void* stats, int dtype, int B, int Sq,
    int Skv, int H, int Hkv, int D,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb, long long oss, long long osh,
    int q_offset, int kv_len, int causal, int window, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || H % Hkv != 0 || stats == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // the saved statistics' route, and no other, takes out and lse
  const bool saved = dtype == 1 && D >= 64;
  if (saved != (out != nullptr) || saved != (lse != nullptr) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.out = out;
  a.lse = static_cast<const float*>(lse);
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
