// K6: causal GQA flash attention with an online softmax, for Hopper (sm_90a).
//
// K6 replaces repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (_flash_kernel, the pallas_call at kernel.py:123), and runs every attention
// call of the port's transformer, prefill and KV-cache decode alike:
//
//   s[i, j] = (q[b, i, h, :] . k[b, j, h / G, :]) * scale        (fp32)
//   s[i, j] = -1e30  where j >= kv_len, or (causal) j > q_offset + i, or
//                    (window w > 0) q_offset + i - j >= w
//   o[b, i, h, :] = sum_j softmax_j(s)[i, j] * v[b, j, h / G, :]
//
// q (B, Sq, H, D), k and v (B, Skv, Hkv, D), read in place through their
// strides (the head dim contiguous), H = G * Hkv; o (B, Sq, H, D)
// contiguous.  fp32 or bf16; D in {16, 32, 64, 128}.  The scores, the running
// max m, the running sum l and the accumulator are fp32; p is rounded to the
// input type before the PV product, as kernel.py:61-64 casts it, while l
// sums the unrounded p.  The output is acc / max(l, 1e-30) in the input type.
//
// Design.  The Pallas grid (B*Hkv*G, nQ, nK) carries m, l and acc across its
// sequential KV axis.  Here the rows of a block are the flattened
// (position, head-in-group) pairs rho = i * G + g of one (batch, KV head),
// so all G query heads of a KV head share every K and V tile staged in
// shared memory: for tinyllama (G = 8) K and V are read once per group, not
// once per head.  KV tiles hold 64 keys; tiles wholly past kv_len or above
// the causal diagonal of a block's last row are not visited
// (kernel.py:67-73), nor, with a sliding window w, tiles wholly below
// the window of a block's first row (keys < q_offset + first row / G - w
// + 1: a decode at position 524,287 with w = 4096 reads 64 tiles, not
// 8,192); keys past Skv in the last tile are zero-filled and masked.  The
// window is `repro`'s sliding-window mask (repro/models/transformer.py:
// 180-183); the Pallas kernel has none.  Three routes, chosen at launch from the shape and type:
//   * decode (Sq * G <= 16; flash_attention_kernel_decode): split-KV in one
//     launch.  The grid is (n_split, Hkv, B): the wrapper cuts the key tiles
//     below kv_end into n_split contiguous runs (about one block per SM,
//     at least one tile a run), and each block owns all Sq * G rows of its
//     (batch, KV head), padded to R = 8 or 16, over its run.  K and V tiles
//     stay in the input type in a ring of 2-3 stages filled by 16-byte
//     cp.async copies, so the run's next tiles are in flight while tile j's
//     products run.  bf16 runs the products on the tensor cores (mma.sync
//     m16n8k16, 16 rows): warp w owns keys 16 w..16 w + 15 of every tile
//     with its own online softmax, and the four warps' states merge in
//     warp order at the end of the run.  fp32 runs scalar FMAs (S: thread
//     = 1 key x R/2 rows; softmax and P V: 128 / R lanes a row).  Masked
//     scores are -inf here, and a row with no valid key in a run leaves it
//     as an empty partial (m = -inf, l = 0, acc = 0).  Each block writes
//     its partial (m, l, acc) per row to an fp32 workspace; after a barrier
//     one thread fences and takes a ticket on the (batch, KV head)'s
//     counter; the last block merges the n_split partials in split order,
//     16 a round (loaded together, folded into a running max with weight
//     exp(m_s - M), 0 for an empty one), so the output does not depend on
//     which block finished last, writes o and resets the counter.
//     n_split = 1 writes o directly;
//   * fp32 prefill: 128 threads, R = 64, scalar fp32 FMAs (the tensor cores
//     would round fp32 inputs to TF32), each thread 4 rows x 8 keys and
//     4 rows x D/8 columns, p passed through shared memory to PV;
//   * bf16 prefill (flash_attention_kernel_bf16): 256 threads, R = 128 rows,
//     warp w owning rows 16 w..16 w + 15, on the tensor cores (bf16 in, fp32
//     accumulate).  K and V stay bf16 and row-major in a ring of 2-4 stages
//     filled by cp.async 16-byte copies straight from the strided views, so
//     the copies of the next tiles run while tile j's products do.  The
//     online softmax runs on the accumulator fragments in the log2 domain
//     (ex2 of s * scale * log2 e - m2 in one FMA), masking only a tile that
//     crosses kv_len or a diagonal (to -inf: for a row with a valid key,
//     which tile 0 holds, p and m are what -1e30 gives); P, rounded to
//     bf16, is re-packed in
//     registers as the A operand of PV.  Row tiles with the most KV tiles
//     launch first.  D = 64 and 128 run the products on wgmma m64n64k16,
//     each of the block's two warpgroups owning 64 rows: S from Q and K in
//     shared memory (K-major, 128-byte swizzle), O += P V with P from
//     registers and V from shared memory (MN-major).  D = 16 and 32 run
//     mma.sync m16n8k16 with ldmatrix fragments (a 16-byte row pad keeps
//     them off shared-memory bank conflicts).  Under autograd (the wrapper
//     passes `lse`) a bf16 call at D = 64 or 128 takes this route whatever
//     its rows, with the template flag LSE: each row also writes its
//     logsumexp in log2 units, m2 + log2(max(l, 1e-30)), which K6's
//     backward (flash_attention_bwd.cu) reads in place of a recompute.
//     Without the flag the store is compiled out: every serve route is
//     the kernel it was.
// In the scalar routes a group of neighbouring lanes shares each row, and
// the row's max and sum are warp shuffles.  Views whose strides are not
// multiples of 16 bytes are staged element by element (`vec` = 0).
//
// Bound, one H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), D = 64, H = 32,
// Hkv = 4, bf16, counting q, k, v read once and o written once, and the
// 4*D flops of each unmasked (query, key) pair:
//   prefill B=4, S=512:      4.30 GFLOP, 18,874,368 B -> 5.6 us, bytes;
//   long prefill B=1, 4096: 68.7 GFLOP, 37.7 MB       -> 69 us, operations;
//   decode B=4, kv_len 575:  K and V 2.36 MB            -> 0.70 us, bytes;
//   long decode B=1, 4096:   K and V 4.19 MB            -> 1.25 us, bytes.
// What limits each route.  The bf16 prefill reaches about 280 TFLOP/s at the
// long prefill, 28% of the bound: each warpgroup runs its products,
// softmax and tile wait in turn (nothing overlaps within it), every tile
// ends in a block barrier on the cp.async copies, and the ring moves
// 0.55 GB from L2 into shared memory there (tools/k6_variants.py: removing
// the copies or the softmax each saves about a fifth of the time, the
// exponentials alone 4%).  A
// TMA producer warp with mbarriers, and ping-pong between the warpgroups,
// are the next steps.  Decode is a few microseconds of latency at these
// sizes: a launch, one or two tiles' copies at about the card's rate,
// then the ticket and the last block's merge (tools/k6_variants.py: at
// the long decode the merge is about a third of the time, the products
// nothing measurable); its times are in PERF.md.  The fp32 prefill is
// bound by the scalar FMA rate.
//
// The kernel allocates nothing and does not synchronise: it launches on the
// caller's stream and returns cudaGetLastError().  The Python wrapper
// (repro_torch/kernels/flash_attention/cuda.py) checks devices, types,
// shapes and strides before the launch, picks n_split, passes the decode
// route's workspace and its stream's zeroed counters, and raises on a
// nonzero return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 64;                 // keys per KV tile
constexpr float kNegInf = -1e30f;       // kernel.py:25 NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t qsb, qss, qsh;      // q strides (elements): batch, position, head
  int64_t ksb, kss, ksh;      // k strides
  int64_t vsb, vss, vsh;      // v strides
  int Sq, Skv, H, G;
  int q_offset, kv_len, causal;
  int window;                 // > 0: key j is visible to position p iff p - j < window
  int vec;                    // every row start 16-byte aligned: 16-byte loads
  float scale;
  // decode route: key tiles per split, the partials' workspace and one
  // ticket counter per (batch, KV head), zero between calls
  int tiles_per_split;
  float* ws;
  int* counters;
  // the bf16 prefill with LSE: each row's logsumexp of the scaled scores
  // in log2 units, fp32 (B, H, Sq), for the backward
  float* lse;
};

// Stage ROWS rows of D elements into shared memory as floats: row r of
// tensor t (t < NT) starts at src[t] + off(t, r), or is absent (off < 0,
// read as zeros; absence is per row); put(t, r, d, x) stores element d.  With `vec`, each thread
// issues up to 4 16-byte loads per tensor before it stores any of them, so
// a tile's loads are in flight together; otherwise one element at a time.
template <typename T, int D, int ROWS, int NT, typename Off, typename Put>
__device__ __forceinline__ void stage(bool vec, const T* const (&src)[NT],
                                      Off off, Put put) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = D / VEC;             // 16-byte chunks per row
  constexpr int TOTAL = ROWS * CH;
  constexpr int PER = (TOTAL + kThreads - 1) / kThreads;
  constexpr int GRP = PER < 4 ? PER : 4;
  if (vec) {
    for (int g0 = 0; g0 < PER; g0 += GRP) {
      uint4 buf[NT][GRP];
#pragma unroll
      for (int c = 0; c < GRP; ++c) {
        const int e = threadIdx.x + (g0 + c) * kThreads;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int64_t o = e < TOTAL ? off(t, e / CH) : -1;
          buf[t][c] = o >= 0 ? *reinterpret_cast<const uint4*>(src[t] + o + (e % CH) * VEC)
                             : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int c = 0; c < GRP; ++c) {
        const int e = threadIdx.x + (g0 + c) * kThreads;
        if (e >= TOTAL) continue;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const T* x = reinterpret_cast<const T*>(&buf[t][c]);
#pragma unroll
          for (int u = 0; u < VEC; ++u) put(t, e / CH, (e % CH) * VEC + u, to_f(x[u]));
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * D; e += kThreads) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int64_t o = off(t, e / D);
        put(t, e / D, e % D, o >= 0 ? to_f(src[t][o + e % D]) : 0.0f);
      }
    }
  }
}

// Shared memory of one block, in floats: Qs [D][R+1], Ks [D][kBK+1],
// Vs [kBK][D], Ps [kBK][R + 32/NCG] (the pads keep the transposed stores
// and the reads on distinct banks).
template <int D, int R, int NCG>
constexpr int smem_floats() {
  return D * (R + 1) + D * (kBK + 1) + kBK * D + kBK * (R + 32 / NCG);
}

template <typename T, int D, int TM, int NRG, int NCG, bool W>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Args a) {
  static_assert(NRG * NCG == kThreads, "one thread per (row group, column group)");
  static_assert(NCG <= 32 && (NCG & (NCG - 1)) == 0, "a row group within a warp");
  static_assert(D % NCG == 0 && kBK % NCG == 0, "columns split evenly");
  constexpr int R = TM * NRG;           // query rows per block
  constexpr int TN = kBK / NCG;         // keys per thread in the score tile
  constexpr int DPT = D / NCG;          // acc columns per thread
  constexpr int QST = R + 1;
  constexpr int KST = kBK + 1;
  constexpr int PST = R + 32 / NCG;

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + D * QST;
  float* Vs = Ks + D * KST;
  float* Ps = Vs + kBK * D;

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  T* __restrict__ o = static_cast<T*>(a.o);

  const int tid = threadIdx.x;
  const int rg = tid / NCG;
  const int cg = tid % NCG;
  const int kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t rows = static_cast<int64_t>(a.Sq) * a.G;
  const int64_t rho0 = static_cast<int64_t>(blockIdx.x) * R;

  // Stage the block's query rows, transposed: Qs[d][r].
  {
    const T* const src[1] = {q};
    stage<T, D, R, 1>(
        a.vec, src,
        [&](int, int r) -> int64_t {
          const int64_t rho = rho0 + r;
          if (rho >= rows) return -1;
          const int64_t h = static_cast<int64_t>(kvh) * a.G + rho % a.G;
          return b * a.qsb + (rho / a.G) * a.qss + h * a.qsh;
        },
        [&](int, int r, int d, float x) { Qs[d * QST + r] = x; });
  }

  // Key-aligned positions of this thread's rows.
  int64_t qpos[TM];
#pragma unroll
  for (int mm = 0; mm < TM; ++mm)
    qpos[mm] = a.q_offset + (rho0 + rg + NRG * mm) / a.G;

  // Keys this block needs: below kv_len and, causally, at or below the
  // position of its last real row.
  int64_t kv_end = a.kv_len;
  if (a.causal) {
    const int64_t last_row = rows - 1 < rho0 + R - 1 ? rows - 1 : rho0 + R - 1;
    const int64_t causal_end = a.q_offset + last_row / a.G + 1;
    if (causal_end < kv_end) kv_end = causal_end;
  }

  // ... and, with a window, at or past the first tile the window of its
  // first row reaches.
  int64_t kv_begin = 0;
  if constexpr (W) {
    const int64_t first = a.q_offset + rho0 / a.G - a.window + 1;
    if (first > 0) kv_begin = first / kBK * kBK;
  }

  float m[TM], l[TM], acc[TM][DPT];
#pragma unroll
  for (int mm = 0; mm < TM; ++mm) {
    m[mm] = kNegInf;
    l[mm] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[mm][c] = 0.0f;
  }

  const T* const kv[2] = {k + b * a.ksb + static_cast<int64_t>(kvh) * a.ksh,
                          v + b * a.vsb + static_cast<int64_t>(kvh) * a.vsh};
  for (int64_t k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();                    // the last tile's Ks/Vs/Ps are read
    stage<T, D, kBK, 2>(
        a.vec, kv,
        [&](int t, int j) -> int64_t {
          return k0 + j < a.Skv ? (k0 + j) * (t == 0 ? a.kss : a.vss) : -1;
        },
        [&](int t, int j, int d, float x) {
          if (t == 0) Ks[d * KST + j] = x; else Vs[j * D + d] = x;
        });
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int mm = 0; mm < TM; ++mm)
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) s[mm][jj] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[TM], kk[TN];
#pragma unroll
      for (int mm = 0; mm < TM; ++mm) qa[mm] = Qs[d * QST + rg + NRG * mm];
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) kk[jj] = Ks[d * KST + cg + NCG * jj];
#pragma unroll
      for (int mm = 0; mm < TM; ++mm)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) s[mm][jj] = fmaf(qa[mm], kk[jj], s[mm][jj]);
    }

#pragma unroll
    for (int mm = 0; mm < TM; ++mm) {
      float mt = kNegInf;
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) {
        const int64_t kp = k0 + cg + NCG * jj;
        const bool valid = kp < a.kv_len && (!a.causal || kp <= qpos[mm]) &&
                           (!W || qpos[mm] - kp < a.window);
        s[mm][jj] = valid ? s[mm][jj] * a.scale : kNegInf;
        mt = fmaxf(mt, s[mm][jj]);
      }
#pragma unroll
      for (int off = NCG / 2; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
      const float m_new = fmaxf(m[mm], mt);
      const float corr = expf(m[mm] - m_new);
      m[mm] = m_new;
      float ls = 0.0f;
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) {
        const float p = expf(s[mm][jj] - m_new);
        ls += p;
        Ps[(cg + NCG * jj) * PST + rg + NRG * mm] = to_f(from_f<T>(p));
      }
      // l stays a per-thread partial sum (corr is the row's own), reduced
      // over the row's NCG lanes at the end.
      l[mm] = l[mm] * corr + ls;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[mm][c] *= corr;
    }
    __syncthreads();                    // every row's p is in Ps

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pa[TM], vv[DPT];
#pragma unroll
      for (int mm = 0; mm < TM; ++mm) pa[mm] = Ps[j * PST + rg + NRG * mm];
#pragma unroll
      for (int c = 0; c < DPT; ++c) vv[c] = Vs[j * D + cg + NCG * c];
#pragma unroll
      for (int mm = 0; mm < TM; ++mm)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[mm][c] = fmaf(pa[mm], vv[c], acc[mm][c]);
    }
  }

#pragma unroll
  for (int mm = 0; mm < TM; ++mm) {
    float lt = l[mm];
#pragma unroll
    for (int off = NCG / 2; off > 0; off >>= 1)
      lt += __shfl_xor_sync(kFull, lt, off);
    const int64_t rho = rho0 + rg + NRG * mm;
    if (rho >= rows) continue;
    const int64_t i = rho / a.G;
    const int64_t h = static_cast<int64_t>(kvh) * a.G + rho % a.G;
    T* orow = o + ((b * a.Sq + i) * a.H + h) * D;
    const float den = fmaxf(lt, 1e-30f);
#pragma unroll
    for (int c = 0; c < DPT; ++c) orow[cg + NCG * c] = from_f<T>(acc[mm][c] / den);
  }
}

// d (16x8, fp32) += a (16x16 bf16, row-major) * b (16x8 bf16, col-major),
// one warp: lane (g = lane / 4, t = lane % 4) holds a = rows g and g + 8 at
// columns 2t, 2t + 1 and 8 + 2t, 9 + 2t; b = rows 2t, 2t + 1 and 8 + 2t,
// 9 + 2t at column g; d = rows g, g + 8 at columns 2t, 2t + 1.
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without a register round trip; with !valid the
// 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives in r[i] row l / 4, columns 2 (l % 4), +1 of matrix i
// (.trans: rows 2 (l % 4), +1 at column l / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- decode route: split-KV flash decoding in one launch ----

constexpr int kDecodeRows = 16;         // Sq * G at most, the decode route
constexpr int kMaxSplits = 256;         // n_split at most
constexpr int kSST = kBK + 4;           // row stride of the score tile (floats)
constexpr int kMergeBatch = 16;         // partials a merging thread loads at once

// Shared memory of a decode block: the K/V ring first (NS stages, K tile
// then V tile, rows of D elements in the input type padded by 16 bytes,
// which puts the 16-byte row reads of 8 neighbouring keys, and ldmatrix's
// 8 rows, on distinct banks), then for fp32 Qs [D][R] (transposed) and Ss
// [R][kSST] (scores, then p), for bf16 Qh [16][ROW] (the A operand).
template <typename T, int D>
struct DecodeLayout {
  static constexpr int VEC = 16 / sizeof(T);        // elements per 16 bytes
  static constexpr int ROW = D + VEC;               // K/V row, elements
  static constexpr int TILE = kBK * ROW;            // one K or V tile
  static constexpr int STAGE_BYTES = 2 * TILE * static_cast<int>(sizeof(T));
  static constexpr int NS = STAGE_BYTES <= 20 * 1024 ? 3 : 2;   // ring stages
};

template <typename T, int D, int R>
constexpr size_t decode_smem_bytes() {
  using L = DecodeLayout<T, D>;
  if constexpr (std::is_same<T, __nv_bfloat16>::value)   // Qh [16][ROW], bf16
    return static_cast<size_t>(L::NS) * L::STAGE_BYTES + sizeof(T) * 16 * L::ROW;
  else
    return static_cast<size_t>(L::NS) * L::STAGE_BYTES + sizeof(float) * (D * R + R * kSST);
}

// N elements of T from shared memory aligned to min(16, N * sizeof(T))
// bytes into registers.
template <typename T, int N>
__device__ __forceinline__ void lds_vec(T (&dst)[N], const T* src) {
  constexpr int BYTES = N * static_cast<int>(sizeof(T));
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else if constexpr (BYTES == 4) {
    *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
  } else {
    dst[0] = src[0];
  }
}

// One (split, KV head, batch) block of the decode route; see the header.
// R = 8 or 16 padded rows; rows >= Sq * G are masked and never written.
// fp32 runs its products as scalar FMAs (exact fp32); bf16 on the tensor
// cores (mma.sync m16n8k16, bf16 in, fp32 accumulate; 16 rows), each warp
// owning 16 of a tile's 64 keys with its own online softmax, the four
// warps' states merged in warp order at the end of the run.
template <typename T, int D, int R, bool W>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel_decode(const Args a) {
  using L = DecodeLayout<T, D>;
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int VEC = L::VEC, CH = D / VEC, ROW = L::ROW, NS = L::NS;
  constexpr int RPT = R / 2;            // scalar S: rows per thread (one key each)
  constexpr int LPR = kThreads / R;     // softmax, P V, epilogue: lanes per row
  constexpr int KPL = kBK / LPR;        // scalar softmax: keys per lane
  constexpr int DPT = D / LPR;          // P V, epilogue: output columns per lane
  static_assert(R == 8 || R == 16, "8 or 16 padded rows");
  static_assert(RPT % 4 == 0 && KPL % 4 == 0 && DPT >= 1, "float4 rows and keys");
  static_assert(kBK * CH % kThreads == 0, "whole copy rounds");

  extern __shared__ __align__(16) unsigned char dsmem[];
  __shared__ int last_block;
  T* ring = reinterpret_cast<T*>(dsmem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int split = blockIdx.x, kvh = blockIdx.y, Hkv = gridDim.y;
  const int64_t b = blockIdx.z;
  const int rows = a.Sq * a.G;

  // This split's key tiles: tiles below kv_end (kv_len and, causally, the
  // last row's position + 1) and, with a window, from the tile that holds
  // the first row's first visible key (q_offset - window + 1), cut into
  // runs of tiles_per_split: this split's is the split-th.
  int kv_end = a.kv_len;
  if (a.causal && a.q_offset + a.Sq < kv_end) kv_end = a.q_offset + a.Sq;
  const int ntiles = kv_end > 0 ? (kv_end - 1) / kBK + 1 : 0;
  const int t_lo = W && a.q_offset - a.window + 1 > 0
                       ? (a.q_offset - a.window + 1) / kBK : 0;
  const int t0 = t_lo + split * a.tiles_per_split;
  const int t1 = t0 + a.tiles_per_split < ntiles ? t0 + a.tiles_per_split : ntiles;

  const T* qbase = static_cast<const T*>(a.q);
  const auto q_off = [&](int r) -> int64_t {   // row r's q, or -1 past rows
    if (r >= rows) return -1;
    const int64_t h = static_cast<int64_t>(kvh) * a.G + r % a.G;
    return b * a.qsb + static_cast<int64_t>(r / a.G) * a.qss + h * a.qsh;
  };
  const T* kbase = static_cast<const T*>(a.k) + b * a.ksb + static_cast<int64_t>(kvh) * a.ksh;
  const T* vbase = static_cast<const T*>(a.v) + b * a.vsb + static_cast<int64_t>(kvh) * a.vsh;
  const auto load_tile = [&](int t) {
    T* Ks = ring + (t % NS) * 2 * L::TILE;
    T* Vs = Ks + L::TILE;
    const int k0 = t * kBK;
    if (a.vec) {
#pragma unroll
      for (int e0 = 0; e0 < kBK * CH; e0 += kThreads) {
        const int r = (e0 + tid) / CH, c = (e0 + tid) % CH;
        const bool ok = k0 + r < a.Skv;
        const int64_t key = k0 + r;
        cp_async16(smem_addr(Ks + r * ROW + c * VEC), ok ? kbase + key * a.kss + c * VEC : kbase, ok);
        cp_async16(smem_addr(Vs + r * ROW + c * VEC), ok ? vbase + key * a.vss + c * VEC : vbase, ok);
      }
    } else {
      for (int e = tid; e < kBK * D; e += kThreads) {
        const int r = e / D, d = e % D;
        const bool ok = k0 + r < a.Skv;
        const int64_t key = k0 + r;
        Ks[r * ROW + d] = ok ? kbase[key * a.kss + d] : from_f<T>(0.0f);
        Vs[r * ROW + d] = ok ? vbase[key * a.vss + d] : from_f<T>(0.0f);
      }
    }
  };

  // bf16: Q as the mma A operand, Qh [16][ROW] (zeros past rows), copied
  // with the first tile.
  T* Qh = reinterpret_cast<T*>(dsmem + NS * L::STAGE_BYTES);
  if constexpr (kMma) {
    if (t0 >= t1) {
    } else if (a.vec) {
      for (int e = tid; e < 16 * CH; e += kThreads) {
        const int r = e / CH, c = e % CH;
        const int64_t off = q_off(r);
        cp_async16(smem_addr(Qh + r * ROW + c * VEC), off >= 0 ? qbase + off + c * VEC : qbase,
                   off >= 0);
      }
    } else {
      for (int e = tid; e < 16 * D; e += kThreads) {
        const int r = e / D, d = e % D;
        const int64_t off = q_off(r);
        Qh[r * ROW + d] = off >= 0 ? qbase[off + d] : from_f<T>(0.0f);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {
    if (t0 + j < t1) load_tile(t0 + j);
    cp_async_commit();
  }

  // The epilogue's thread (row, lane in row) holds m, l and DPT columns of
  // acc of its row after the run.
  const int row = tid / LPR, lane_r = tid % LPR;
  const bool pv_rows = warp * (32 / LPR) < rows;       // warp-uniform
  float m = -CUDART_INF_F, l = 0.0f, acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.0f;

  if constexpr (kMma) {
    constexpr int KSTEPS = D / 16;      // k-steps of Q K^T over the head dim
    constexpr int DT = D / 8;           // head-dim n-tiles of the output
    constexpr int CA = D + 4;           // row stride of the warps' acc (floats)
    static_assert(sizeof(float) * (2 * 64 + 64 * CA) <= NS * L::STAGE_BYTES,
                  "the warps' states fit in the ring");
    const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    // lane rows g and g + 8: their positions, and whether they are real
    const bool real[2] = {g < rows, g + 8 < rows};
    const int qpos[2] = {a.q_offset + g / a.G, a.q_offset + (g + 8) / a.G};
    uint32_t qa[KSTEPS][4];
    float mw[2] = {-CUDART_INF_F, -CUDART_INF_F}, lw[2] = {0.0f, 0.0f};
    float accw[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) accw[dt][e] = 0.0f;

    for (int t = t0; t < t1; ++t) {
      cp_async_wait<NS - 2>();          // tile t (and Q) landed, this thread's part
      __syncthreads();                  // ... every thread's; tile t - 1 is used
      if (t + NS - 1 < t1) load_tile(t + NS - 1);
      cp_async_commit();
      if (t == t0) {
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          ldsm_x4(qa[ks], smem_addr(Qh + (lane & 15) * ROW + ks * 16 + (lane >> 4) * 8));
      }
      const T* Ks = ring + (t % NS) * 2 * L::TILE;
      const uint32_t ks_addr = smem_addr(Ks), vs_addr = smem_addr(Ks + L::TILE);
      const int kw = warp * 16;         // this warp's keys in the tile

      // s[nt][e]: row g + 8 (e / 2), key t * 64 + kw + 8 nt + 2 t4 + e % 2
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        // matrices: keys kw + 0..7 | 8..15, head dims 16 ks + 0..7 | 8..15
        uint32_t kb[4];
        ldsm_x4(kb, ks_addr + 2 * ((kw + (lane >> 4) * 8 + (lane & 7)) * ROW + ks * 16 +
                                   ((lane >> 3) & 1) * 8));
        mma_bf16_16816(s[0], qa[ks], kb[0], kb[1]);
        mma_bf16_16816(s[1], qa[ks], kb[2], kb[3]);
      }
      float smax[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = t * kBK + kw + nt * 8 + 2 * t4 + (e & 1);
          const int hr = e >> 1;
          const bool valid = real[hr] && kp < a.kv_len && (!a.causal || kp <= qpos[hr]) &&
                             (!W || qpos[hr] - kp < a.window);
          s[nt][e] = valid ? s[nt][e] * a.scale : -CUDART_INF_F;
          smax[hr] = fmaxf(smax[hr], s[nt][e]);
        }
      float corr[2], ls[2] = {0.0f, 0.0f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        smax[hr] = fmaxf(smax[hr], __shfl_xor_sync(kFull, smax[hr], 1));
        smax[hr] = fmaxf(smax[hr], __shfl_xor_sync(kFull, smax[hr], 2));
        // a row with no valid key among the warp's 16 adds nothing
        const float m_new = smax[hr] == -CUDART_INF_F ? mw[hr] : fmaxf(mw[hr], smax[hr]);
        corr[hr] = smax[hr] == -CUDART_INF_F ? 1.0f : expf(mw[hr] - m_new);
        mw[hr] = m_new;
      }
      uint32_t pa[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = s[nt][e] == -CUDART_INF_F ? 0.0f : expf(s[nt][e] - mw[e >> 1]);
          ls[e >> 1] += p[e];
        }
        pa[nt * 2] = pack_bf16(p[0], p[1]);       // rounded to bf16 for P V
        pa[nt * 2 + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) lw[hr] = lw[hr] * corr[hr] + ls[hr];
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) accw[dt][e] *= corr[e >> 1];
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        // matrices: keys kw + 0..7 | 8..15, head dims 16 dp + 0..7 | 8..15
        uint32_t vb[4];
        ldsm_x4_trans(vb, vs_addr + 2 * ((kw + ((lane >> 3) & 1) * 8 + (lane & 7)) * ROW +
                                         (2 * dp + (lane >> 4)) * 8));
        mma_bf16_16816(accw[2 * dp], pa, vb[0], vb[1]);
        mma_bf16_16816(accw[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();                    // the ring is free: the warps' states
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      lw[hr] += __shfl_xor_sync(kFull, lw[hr], 1);
      lw[hr] += __shfl_xor_sync(kFull, lw[hr], 2);
    }
    float* Cm = reinterpret_cast<float*>(dsmem);   // [warp][16] m
    float* Cl = Cm + 64;                            // [warp][16] l
    float* Ca = Cl + 64;                            // [warp][16][CA] acc
    if (t4 == 0) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        Cm[warp * 16 + g + 8 * hr] = mw[hr];
        Cl[warp * 16 + g + 8 * hr] = lw[hr];
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        Ca[(warp * 16 + g + 8 * (e >> 1)) * CA + dt * 8 + 2 * t4 + (e & 1)] = accw[dt][e];
    __syncthreads();
    // The run's state of row `row`: the warps' in warp order, weight
    // exp(m_w - max m), 0 for a warp that saw no valid key of the row.
#pragma unroll
    for (int w = 0; w < 4; ++w) m = fmaxf(m, Cm[w * 16 + row]);
    if (m != -CUDART_INF_F) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float mw_ = Cm[w * 16 + row];
        const float wt = mw_ == -CUDART_INF_F ? 0.0f : expf(mw_ - m);
        l = fmaf(wt, Cl[w * 16 + row], l);
#pragma unroll
        for (int c = 0; c < DPT; ++c)
          acc[c] = fmaf(wt, Ca[(w * 16 + row) * CA + lane_r * DPT + c], acc[c]);
      }
    }
  } else {
    // fp32: Q staged transposed, Qs [D][R]; S: thread (key, row half);
    // softmax and P V: thread (row, lane in row).
    float* Qs = reinterpret_cast<float*>(dsmem + NS * L::STAGE_BYTES);
    float* Ss = Qs + D * R;
    if (t0 < t1) {
      const T* const src[1] = {qbase};
      stage<T, D, R, 1>(
          a.vec, src, [&](int, int r) { return q_off(r); },
          [&](int, int r, int d, float x) { Qs[d * R + r] = x; });
    }
    const int key = tid % kBK, rh = tid / kBK;
    const bool s_rows = rh * RPT < rows;               // warp-uniform

    for (int t = t0; t < t1; ++t) {
      cp_async_wait<NS - 2>();          // tile t has landed (this thread's part)
      __syncthreads();                  // ... every thread's; tile t - 1 is used
      if (t + NS - 1 < t1) load_tile(t + NS - 1);
      cp_async_commit();
      const T* Ks = ring + (t % NS) * 2 * L::TILE;
      const T* Vs = Ks + L::TILE;
      const int k0 = t * kBK;

      if (s_rows) {
        float s[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) s[i] = 0.0f;
        const T* krow = Ks + key * ROW;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const uint4 raw = *reinterpret_cast<const uint4*>(krow + c * VEC);
          const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int u = 0; u < VEC; ++u) {
            const float kf = to_f(x[u]);
            const float* qd = Qs + (c * VEC + u) * R + rh * RPT;
#pragma unroll
            for (int i = 0; i < RPT; i += 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(qd + i);
              s[i] = fmaf(q4.x, kf, s[i]);
              s[i + 1] = fmaf(q4.y, kf, s[i + 1]);
              s[i + 2] = fmaf(q4.z, kf, s[i + 2]);
              s[i + 3] = fmaf(q4.w, kf, s[i + 3]);
            }
          }
        }
        const int kp = k0 + key;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = rh * RPT + i;
          const int pos = a.q_offset + r / a.G;
          const bool valid = r < rows && kp < a.kv_len && (!a.causal || kp <= pos) &&
                             (!W || pos - kp < a.window);
          Ss[r * kSST + key] = valid ? s[i] * a.scale : -CUDART_INF_F;
        }
      }
      __syncthreads();                  // the tile's scores are in Ss

      float corr = 1.0f;
      if (pv_rows) {
        float* srow = Ss + row * kSST + lane_r * KPL;
        alignas(16) float sv[KPL];
#pragma unroll
        for (int i = 0; i < KPL; i += 4)
          *reinterpret_cast<float4*>(sv + i) = *reinterpret_cast<const float4*>(srow + i);
        float mt = -CUDART_INF_F;
#pragma unroll
        for (int i = 0; i < KPL; ++i) mt = fmaxf(mt, sv[i]);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
        if (mt == -CUDART_INF_F) {
          // no valid key of this tile for the row: it adds nothing
#pragma unroll
          for (int i = 0; i < KPL; ++i) sv[i] = 0.0f;
        } else {
          const float m_new = fmaxf(m, mt);
          corr = expf(m - m_new);       // 0 while m is -inf (acc and l are 0)
          m = m_new;
          float ls = 0.0f;
#pragma unroll
          for (int i = 0; i < KPL; ++i) {
            const float p = expf(sv[i] - m_new);
            ls += p;
            sv[i] = to_f(from_f<T>(p)); // p rounded to the input type for P V
          }
          // l stays a per-lane partial sum (corr is the row's own), reduced
          // over the row's LPR lanes after the run.
          l = l * corr + ls;
        }
#pragma unroll
        for (int i = 0; i < KPL; i += 4)
          *reinterpret_cast<float4*>(srow + i) = *reinterpret_cast<const float4*>(sv + i);
      }
      __syncthreads();                  // every row's p is in Ss

      if (pv_rows) {
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[c] *= corr;
        const float* prow = Ss + row * kSST;
        const T* vcol = Vs + lane_r * DPT;
#pragma unroll 4
        for (int j = 0; j < kBK; j += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(prow + j);
          const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            alignas(16) T vv[DPT];
            lds_vec(vv, vcol + (j + jj) * ROW);
#pragma unroll
            for (int c = 0; c < DPT; ++c) acc[c] = fmaf(pj[jj], to_f(vv[c]), acc[c]);
          }
        }
      }
    }
    cp_async_wait<0>();
    if (pv_rows) {
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1) l += __shfl_xor_sync(kFull, l, off);
    }
  }

  const bool own_row = pv_rows && row < rows;
  T* __restrict__ o = static_cast<T*>(a.o);
  const auto out_row = [&](int r) {
    const int64_t h = static_cast<int64_t>(kvh) * a.G + r % a.G;
    return o + ((b * a.Sq + r / a.G) * a.H + h) * D;
  };
  if (gridDim.x == 1) {                 // one split: no merge
    if (own_row) {
      T* orow = out_row(row) + lane_r * DPT;
      const float den = fmaxf(l, 1e-30f);
#pragma unroll
      for (int c = 0; c < DPT; ++c) orow[c] = from_f<T>(acc[c] / den);
    }
    return;
  }

  // The partial of this split: acc rows in the first region of the
  // workspace, (m, l) pairs after all of them.
  const int n_split = gridDim.x;
  const int64_t bh = b * Hkv + kvh;
  const int64_t ml_off = static_cast<int64_t>(gridDim.z) * Hkv * n_split * rows * D;
  float2* ws_ml = reinterpret_cast<float2*>(a.ws + ml_off);
  if (own_row) {
    const int64_t pr = (bh * n_split + split) * rows + row;
    float* pa = a.ws + pr * D + lane_r * DPT;
#pragma unroll
    for (int c = 0; c < DPT; ++c) pa[c] = acc[c];
    if (lane_r == 0) ws_ml[pr] = make_float2(m, l);
  }
  // The block's partial is visible device-wide before its ticket: the
  // barrier orders the block's writes before thread 0's fence, which
  // orders them before the atomic (CUTLASS's semaphore does the same).
  // The last block's thread 0 fences again after its ticket, and the
  // barrier orders the block's reads of the partials after that.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const int ticket = atomicAdd(a.counters + bh, 1);
    last_block = ticket == n_split - 1;
    if (last_block) {
      a.counters[bh] = 0;               // every block has its ticket: reset
      __threadfence();
    }
  }
  __syncthreads();
  if (!last_block) return;

  // The last block merges the n_split partials in split order, thread
  // (row, 4 columns) by thread, kMergeBatch splits a round: the round's
  // (m, l) pairs and acc columns are loaded together, then folded into the
  // running (M, L, A) with weights exp(m_s - M): 0 for an empty split
  // (m_s = -inf), which thus never enters the max either.  A row with no
  // valid key anywhere keeps L = 0 and A = 0: o = 0.
  constexpr int C4 = D / 4;
  const float4* ws4 = reinterpret_cast<const float4*>(a.ws);
  for (int e = tid; e < rows * C4; e += kThreads) {
    const int r = e / C4, c4 = e % C4;
    const float4* src = ws4 + (bh * n_split * rows + r) * C4 + c4;
    const float2* msrc = ws_ml + bh * n_split * rows + r;
    float M = -CUDART_INF_F, L = 0.0f;
    float4 A = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s0 = 0; s0 < n_split; s0 += kMergeBatch) {
      float2 ml[kMergeBatch];
      float4 x[kMergeBatch];
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        const int s = s0 + j < n_split ? s0 + j : n_split - 1;
        ml[j] = __ldcg(msrc + static_cast<int64_t>(s) * rows);
        x[j] = __ldcg(src + static_cast<int64_t>(s) * rows * C4);
        if (s0 + j >= n_split) ml[j].x = -CUDART_INF_F;
      }
      float Mb = M;
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) Mb = fmaxf(Mb, ml[j].x);
      if (Mb == -CUDART_INF_F) continue;  // no valid key so far
      const float c = expf(M - Mb);       // 0 while M is -inf
      A.x *= c; A.y *= c; A.z *= c; A.w *= c;
      L *= c;
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        const float w = ml[j].x == -CUDART_INF_F ? 0.0f : expf(ml[j].x - Mb);
        A.x = fmaf(w, x[j].x, A.x);
        A.y = fmaf(w, x[j].y, A.y);
        A.z = fmaf(w, x[j].z, A.z);
        A.w = fmaf(w, x[j].w, A.w);
        L = fmaf(w, ml[j].y, L);
      }
      M = Mb;
    }
    const float den = fmaxf(L, 1e-30f);
    T* orow = out_row(r) + c4 * 4;
    orow[0] = from_f<T>(A.x / den);
    orow[1] = from_f<T>(A.y / den);
    orow[2] = from_f<T>(A.z / den);
    orow[3] = from_f<T>(A.w / den);
  }
}

constexpr int kPThreads = 256;          // bf16 prefill: 8 warps of 16 rows
constexpr int kPRows = 128;             // query rows per bf16 prefill block
constexpr float kLog2e = 1.4426950408889634f;

// Copy ROWS rows of D bf16 into shared memory: row r reads src + off(r)
// (zeros where off(r) < 0) and lands at dst + at(r, c) for its 16-byte
// chunk c.  With `vec` one cp.async per chunk (the caller commits and
// waits); otherwise element by element, synchronously.
template <int D, int ROWS, typename Off, typename At>
__device__ __forceinline__ void load_rows(bool vec, __nv_bfloat16* dst,
                                          const __nv_bfloat16* src, Off off, At at) {
  constexpr int CH = D / 8;
  if (vec) {
#pragma unroll
    for (int e0 = 0; e0 < ROWS * CH; e0 += kPThreads) {
      const int e = e0 + threadIdx.x;
      if (ROWS * CH % kPThreads != 0 && e >= ROWS * CH) break;
      const int r = e / CH, c = e % CH;
      const int64_t o = off(r);
      cp_async16(smem_addr(dst + at(r, c)), o >= 0 ? src + o + c * 8 : src, o >= 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * D; e += kPThreads) {
      const int r = e / D, d = e % D;
      const int64_t o = off(r);
      dst[at(r, d / 8) + d % 8] = o >= 0 ? src[o + d] : __float2bfloat16(0.0f);
    }
  }
}

// wgmma (sm_90a): a 64-row warpgroup product, operands in shared memory
// named by 64-bit descriptors.  The descriptor of a 128-byte-swizzled tile
// (CUTLASS cute/arch/mma_sm90_desc.hpp): start address >> 4 in bits 0-13,
// the leading byte offset >> 4 in bits 16-29, the stride byte offset >> 4
// in bits 32-45, layout type 1 (SWIZZLE_128B) in bits 62-63.  In the
// canonical layouts (cute/atom/mma_traits_sm90_gmma.hpp), with rows of 64
// bf16 (128 bytes) whose 16-byte chunk c of row r sits at chunk c ^ (r % 8)
// inside a 1024-byte-aligned 8-row group:
//   K-major (A = Q, B = K; rows m or n, the 16-deep k-step along a row):
//     start at the k-step's first chunk (+32 bytes a step), SBO = 1024
//     (the next 8 rows), LBO unused (1);
//   MN-major (B = V; rows k, n along a row): start at the k-step's first
//     row (+2048 bytes a step of 16 rows), SBO = 1024 (the next 8 rows of
//     k), LBO = the next 64 columns of n (unused at n = 64).
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
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Registers that an asynchronous wgmma writes: the compiler must neither
// read them before the wgmma_wait that completes the write nor keep a copy
// from before it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
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

// Shared memory of the bf16 prefill: Qs (kPRows rows), then NS stages of
// Ks and Vs (kBK rows each), all rows of D bf16 as they sit in device
// memory (V too: row-major).  The mma.sync route pads each row by 16
// bytes, which puts the 8 rows of an ldmatrix phase on distinct banks.
// The wgmma route keeps each tile in wgmma's 128-byte-swizzled layout:
// 64-column blocks of the tile one after another, rows of 128 bytes, chunk
// c of row r at chunk c ^ (r % 8); the buffer starts 1024-byte aligned.
template <int D, bool WG>
struct Bf16Layout {
  static constexpr int ROW = WG ? D : D + 8;       // elements per row
  static constexpr int TILE = kBK * ROW;           // one K or V tile
  static constexpr int Q = kPRows * ROW;
  // element offset of 16-byte chunk c of row r in a tile of `rows` rows
  __device__ static __forceinline__ int at(int rows, int r, int c) {
    if constexpr (WG)
      return (c >> 3) * rows * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
    else
      return r * ROW + c * 8;
  }
};

template <int D, int NS, bool WG>
constexpr size_t bf16_smem_bytes() {
  using L = Bf16Layout<D, WG>;
  return sizeof(__nv_bfloat16) * (L::Q + NS * 2 * L::TILE) + (WG ? 1024 : 0);
}

// The bf16 prefill on the tensor cores, bf16 in, fp32 accumulate.  A block
// of 8 warps owns 128 flattened rows; warp w owns rows 16 w..16 w + 15.
// K/V tiles of 64 keys come through a ring of NS stages filled by cp.async
// straight from the strided views, tile j + NS - 1 in flight while tile j is
// used.  Per tile each warp forms its 16 x 64 block of S, runs the online
// softmax on the accumulator fragments in the log2 domain (masking only a
// tile that crosses kv_len or a diagonal), re-packs P, rounded to bf16, in
// registers as the A operand of PV, and adds P V.  The products:
//   WG = false: mma.sync m16n8k16, Q's A fragments loaded once by
//     ldmatrix.x4, K's B fragments by ldmatrix.x4, V's by ldmatrix.x4.trans;
//   WG = true (D = 64, 128): wgmma m64n64k16, each of the two warpgroups
//     owning 64 rows: S from Q and K in shared memory (K-major), P V with P
//     from registers and V in shared memory (MN-major).
// LSE: also write each row's logsumexp (log2 units) to a.lse.
template <int D, int NS, int MINB, bool WG, bool W, bool LSE = false>
__global__ void __launch_bounds__(kPThreads, MINB)
flash_attention_kernel_bf16(const Args a) {
  using T = __nv_bfloat16;
  using L = Bf16Layout<D, WG>;
  constexpr int R = kPRows;
  constexpr int KSTEPS = D / 16;        // k-steps of QK^T over the head dim
  constexpr int NT = kBK / 8;           // key n-tiles of S
  constexpr int DT = D / 8;             // head-dim n-tiles of the output
  static_assert(NS >= 2 && DT % 2 == 0, "ring of 2+ stages; D/8 even");
  static_assert(!WG || D % 64 == 0, "wgmma tiles are 64-column blocks");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw;
  if constexpr (WG) base += (1024 - (smem_addr(smem_raw) & 1023)) & 1023;
  T* Qs = reinterpret_cast<T*>(base);
  T* KVs = Qs + L::Q;                   // stage s: K at 2 s TILE, V after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int Hkv = a.H / a.G;
  const int kvh = blockIdx.x % Hkv;
  // Row tiles with the most KV tiles first: the causal triangle's long
  // rows do not form the tail of the grid.
  const int64_t tile = gridDim.x / Hkv - 1 - blockIdx.x / Hkv;
  const int64_t b = blockIdx.y;
  const int64_t rows = static_cast<int64_t>(a.Sq) * a.G;
  const int64_t rho0 = tile * R;

  load_rows<D, R>(
      a.vec, Qs, static_cast<const T*>(a.q),
      [&](int r) -> int64_t {
        const int64_t rho = rho0 + r;
        if (rho >= rows) return -1;
        const int64_t h = static_cast<int64_t>(kvh) * a.G + rho % a.G;
        return b * a.qsb + (rho / a.G) * a.qss + h * a.qsh;
      },
      [](int r, int c) { return L::at(R, r, c); });
  cp_async_commit();

  // Positions, keys and tile counts fit an int: the wrapper bounds Skv
  // and q_offset + Sq by INT_MAX.
  int kv_end = a.kv_len;
  if (a.causal) {
    const int64_t last_row = rows - 1 < rho0 + R - 1 ? rows - 1 : rho0 + R - 1;
    const int causal_end = a.q_offset + static_cast<int>(last_row / a.G) + 1;
    if (causal_end < kv_end) kv_end = causal_end;
  }
  const int nkv = kv_end > 0 ? (kv_end - 1) / kBK + 1 : 0;
  // With a window, the first tile the window of the block's first row
  // reaches; the ring starts there.
  int j0 = 0;
  if constexpr (W) {
    const int64_t first = a.q_offset + rho0 / a.G - a.window + 1;
    if (first > 0) j0 = static_cast<int>(first / kBK);
  }

  const T* kbase = static_cast<const T*>(a.k) + b * a.ksb + static_cast<int64_t>(kvh) * a.ksh;
  const T* vbase = static_cast<const T*>(a.v) + b * a.vsb + static_cast<int64_t>(kvh) * a.vsh;
  const auto load_kv = [&](int j) {
    const int k0 = j * kBK;
    T* Ks = KVs + (j % NS) * 2 * L::TILE;
    const auto at = [](int r, int c) { return L::at(kBK, r, c); };
    load_rows<D, kBK>(a.vec, Ks, kbase,
                      [&](int r) -> int64_t { return k0 + r < a.Skv ? (k0 + r) * a.kss : -1; }, at);
    load_rows<D, kBK>(a.vec, Ks + L::TILE, vbase,
                      [&](int r) -> int64_t { return k0 + r < a.Skv ? (k0 + r) * a.vss : -1; }, at);
  };
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {
    if (j0 + j < nkv) load_kv(j0 + j);
    cp_async_commit();
  }

  cp_async_wait<NS - 1>();              // Q has landed (the KV groups may not)
  if constexpr (WG) fence_proxy_async();
  __syncthreads();
  const int wr0 = warp * 16;            // this warp's first row in the block
  uint32_t qa[WG ? 1 : KSTEPS][4];
  if constexpr (!WG) {
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
      ldsm_x4(qa[ks], smem_addr(Qs + (wr0 + (lane & 15)) * L::ROW + ks * 16 + (lane >> 4) * 8));
  }

  // Positions of this lane's rows, of the warp's first row and of the
  // first and last rows of the warp (mma.sync) or warpgroup (wgmma), which
  // skips a tile wholly above its rows or wholly below their windows.
  const int qpos[2] = {a.q_offset + static_cast<int>((rho0 + wr0 + g) / a.G),
                       a.q_offset + static_cast<int>((rho0 + wr0 + g + 8) / a.G)};
  const int wpos_lo = a.q_offset + static_cast<int>((rho0 + wr0) / a.G);
  const int wpos_hi = a.q_offset + static_cast<int>(
      (rho0 + (WG ? (warp >> 2) * 64 + 63 : wr0 + 15)) / a.G);
  const int upos_lo = a.q_offset + static_cast<int>(
      (rho0 + (WG ? (warp >> 2) * 64 : wr0)) / a.G);
  const float c2 = a.scale * kLog2e;    // s * c2 is the score in log2 units

  float m2[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;

  for (int j = j0; j < nkv; ++j) {
    cp_async_wait<NS - 2>();            // tile j has landed (this thread's part)
    if constexpr (WG) fence_proxy_async();
    __syncthreads();                    // ... every thread's; tile j - 1 is used
    if (j + NS - 1 < nkv) load_kv(j + NS - 1);
    cp_async_commit();

    const int k0 = j * kBK;
    if (a.causal && k0 > wpos_hi) continue;
    if (W && k0 + kBK - 1 < upos_lo - a.window + 1) continue;
    const T* Ks = KVs + (j % NS) * 2 * L::TILE;
    const uint32_t ks_addr = smem_addr(Ks), vs_addr = smem_addr(Ks + L::TILE);

    float s[NT][4];
    if constexpr (WG) {
      // S = Q K^T: k-step ks reads chunks 2 ks, 2 ks + 1 of every row, in
      // 64-column block ks / 4.
      const uint32_t q_addr = smem_addr(Qs) + (warp >> 2) * 64 * 128;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        wgmma_ss_64x64(reinterpret_cast<float(&)[32]>(s),
                       sw128_desc(q_addr + (ks >> 2) * R * 128 + (ks & 3) * 32, 16, 1024),
                       sw128_desc(ks_addr + (ks >> 2) * kBK * 128 + (ks & 3) * 32, 16, 1024),
                       ks > 0);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(reinterpret_cast<float(&)[NT * 4]>(s));
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          // matrices: keys 16 np + 0..7 | + 8..15, head dims 16 ks + 0..7 | 8..15
          uint32_t kb[4];
          ldsm_x4(kb, ks_addr + 2 * ((np * 16 + (lane >> 4) * 8 + (lane & 7)) * L::ROW +
                                     ks * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16_16816(s[2 * np], qa[ks], kb[0], kb[1]);
          mma_bf16_16816(s[2 * np + 1], qa[ks], kb[2], kb[3]);
        }
    }

    // s[nt][e]: row wr0 + g + 8 (e / 2), key k0 + 8 nt + 2 t + e % 2.  Only
    // a tile that crosses kv_len, one of the warp's diagonals or the lower
    // edge of a window is masked.
    if (k0 + kBK > a.kv_len || (a.causal && k0 + kBK - 1 > wpos_lo) ||
        (W && k0 <= wpos_hi - a.window)) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + nt * 8 + 2 * t + (e & 1);
          if (kp >= a.kv_len || (a.causal && kp > qpos[e >> 1]) ||
              (W && qpos[e >> 1] - kp >= a.window))
            s[nt][e] = -CUDART_INF_F;
        }
    }
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[nt][e]);
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(kFull, mt[hr], 1));
      mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(kFull, mt[hr], 2));
      const float m_new = fmaxf(m2[hr], mt[hr] * c2);
      corr[hr] = exp2_approx(m2[hr] - m_new);
      m2[hr] = m_new;
    }
    float ls[2] = {0.0f, 0.0f};
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2_approx(fmaf(s[nt][e], c2, -m2[e >> 1]));
        ls[e >> 1] += p[e];
      }
      pa[nt / 2][(nt & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * corr[hr] + ls[hr];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] *= corr[e >> 1];
    if constexpr (WG) {
      // O += P V: k-step kk is keys 16 kk..16 kk + 15 (rows of V), and
      // 64-column block n of the output reads V's block n.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int n = 0; n < D / 64; ++n)
          wgmma_rs_64x64_mn(reinterpret_cast<float(&)[32]>(acc[8 * n]), pa[kk],
                            sw128_desc(vs_addr + n * kBK * 128 + kk * 16 * 128,
                                       kBK * 128, 1024));
      wgmma_commit();
      wgmma_wait0();
      reg_fence(reinterpret_cast<float(&)[DT * 4]>(acc));
    } else {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          // matrices: keys 16 kk + 0..7 | 8..15, head dims 16 dp + 0..7 | 8..15
          uint32_t vb[4];
          ldsm_x4_trans(vb, vs_addr + 2 * ((kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * L::ROW +
                                           (2 * dp + (lane >> 4)) * 8));
          mma_bf16_16816(acc[2 * dp], pa[kk], vb[0], vb[1]);
          mma_bf16_16816(acc[2 * dp + 1], pa[kk], vb[2], vb[3]);
        }
    }
  }

  T* __restrict__ o = static_cast<T*>(a.o);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    const int64_t rho = rho0 + wr0 + g + 8 * hr;
    if (rho >= rows) continue;
    const int64_t h = static_cast<int64_t>(kvh) * a.G + rho % a.G;
    T* orow = o + ((b * a.Sq + rho / a.G) * a.H + h) * D;
    const float den = fmaxf(lt, 1e-30f);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      __nv_bfloat162 v = __floats2bfloat162_rn(acc[dt][2 * hr] / den,
                                               acc[dt][2 * hr + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * t) = v;
    }
    if constexpr (LSE) {
      if (t == 0) a.lse[(b * a.H + h) * a.Sq + rho / a.G] = m2[hr] + log2f(den);
    }
  }
}

template <typename Kernel>
int launch_grid(Kernel kernel, size_t bytes, int R, const Args& a, int B, int Hkv,
                cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t rows = static_cast<int64_t>(a.Sq) * a.G;
  const dim3 grid(static_cast<unsigned>((rows + R - 1) / R), Hkv, B);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int TM, int NRG, int NCG, bool W>
int launch_shape(const Args& a, int B, int Hkv, cudaStream_t stream) {
  return launch_grid(flash_attention_kernel<T, D, TM, NRG, NCG, W>,
                     sizeof(float) * smem_floats<D, TM * NRG, NCG>(), TM * NRG, a, B,
                     Hkv, stream);
}

// The bf16 prefill's grid: x runs over (row tile, KV head), KV head
// fastest, y over the batch.  D = 64 and 128 take wgmma, D = 16 and 32
// mma.sync; LSE (D >= 64 only) writes the rows' logsumexp.
template <int D, bool W, bool LSE = false>
int launch_bf16(const Args& a, int B, int Hkv, cudaStream_t stream) {
  constexpr bool WG = D >= 64;
  constexpr int NS = D == 64 ? 4 : D < 64 ? 3 : 2;   // ring stages
  constexpr int MINB = D <= 64 ? 2 : 1; // blocks per SM the registers allow
  const auto kernel = flash_attention_kernel_bf16<D, NS, MINB, WG, W, LSE>;
  constexpr size_t bytes = bf16_smem_bytes<D, NS, WG>();
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t tiles = (static_cast<int64_t>(a.Sq) * a.G + kPRows - 1) / kPRows;
  if (tiles * Hkv > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles * Hkv), B);
  kernel<<<grid, kPThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The decode route's grid: (n_split, Hkv, B).  fp32 pads to R = 8 rows
// where Sq * G <= 8 (its scalar products use every thread), else 16; bf16
// always to 16 (the rows of an mma tile).
template <typename T, int D, int R, bool W>
int launch_decode(const Args& a, int B, int Hkv, int n_split, cudaStream_t stream) {
  const auto kernel = flash_attention_kernel_decode<T, D, R, W>;
  constexpr size_t bytes = decode_smem_bytes<T, D, R>();
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(n_split), Hkv, B);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Decode (at most 16 rows) on the split-KV route; a bf16 prefill on the
// tensor cores; an fp32 prefill on the 64-row scalar shape (fp32 products
// are exact only outside the tensor cores).
template <typename T, int D, bool W>
int launch_dim(const Args& a, int B, int Hkv, int n_split, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int64_t rows = static_cast<int64_t>(a.Sq) * a.G;
  if constexpr (!kBf16) {
    if (rows <= 8) return launch_decode<T, D, 8, W>(a, B, Hkv, n_split, stream);
  }
  if (rows <= kDecodeRows) return launch_decode<T, D, 16, W>(a, B, Hkv, n_split, stream);
  if constexpr (kBf16)
    return launch_bf16<D, W>(a, B, Hkv, stream);
  else
    return launch_shape<T, D, 4, 16, 8, W>(a, B, Hkv, stream);
}

template <typename T, bool W>
int launch_window(const Args& a, int B, int Hkv, int D, int n_split, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_dim<T, 16, W>(a, B, Hkv, n_split, stream);
    case 32: return launch_dim<T, 32, W>(a, B, Hkv, n_split, stream);
    case 64: return launch_dim<T, 64, W>(a, B, Hkv, n_split, stream);
    case 128: return launch_dim<T, 128, W>(a, B, Hkv, n_split, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The window is a template flag: without one, every route compiles to
// the kernel it was before the window, with no test of it in its loops.
template <typename T>
int launch_type(const Args& a, int B, int Hkv, int D, int n_split, cudaStream_t stream) {
  return a.window > 0 ? launch_window<T, true>(a, B, Hkv, D, n_split, stream)
                      : launch_window<T, false>(a, B, Hkv, D, n_split, stream);
}

// Under autograd: the bf16 prefill with LSE at D = 64 or 128, whatever
// the rows (a decode-shaped call too).
template <bool W>
int launch_lse(const Args& a, int B, int Hkv, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_bf16<64, W, true>(a, B, Hkv, stream);
    case 128: return launch_bf16<128, W, true>(a, B, Hkv, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  Strides in elements; the head dim is
// contiguous in q, k and v, and o is contiguous (B, Sq, H, D).  Calls with
// Sq * (H / Hkv) <= 16 take the decode route in n_split blocks per (batch,
// KV head); with n_split > 1 they need ws (B * Hkv * n_split * Sq * H / Hkv
// * (D + 2) floats, 16-byte aligned) and counters (B * Hkv ints, zero; the
// kernel leaves them zero), which no other call may use at the same time.
// Other calls ignore n_split, ws and counters.  window > 0 is the sliding
// window (key j visible to position p iff p - j < window); 0 is none.
// With lse (B * H * Sq floats; bf16 at D = 64 or 128 only) every call takes
// the bf16 prefill and writes each row's logsumexp there in log2 units.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Skv, int H, int Hkv, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, int q_offset, int kv_len, int causal,
    int window, float scale, void* ws, void* counters, int n_split, void* lse,
    void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.qsb = qsb; a.qss = qss; a.qsh = qsh;
  a.ksb = ksb; a.kss = kss; a.ksh = ksh;
  a.vsb = vsb; a.vss = vss; a.vsh = vsh;
  a.Sq = Sq;
  a.Skv = Skv;
  a.H = H;
  a.G = H / Hkv;
  a.q_offset = q_offset;
  a.kv_len = kv_len;
  a.causal = causal;
  a.window = window > 0 ? window : 0;
  a.scale = scale;
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.lse = static_cast<float*>(lse);
  a.tiles_per_split = 0;
  if (lse == nullptr && static_cast<long long>(Sq) * a.G <= kDecodeRows) {
    if (n_split < 1 || n_split > kMaxSplits ||
        (n_split > 1 && (ws == nullptr || counters == nullptr ||
                         reinterpret_cast<uintptr_t>(ws) % 16 != 0)))
      return static_cast<int>(cudaErrorInvalidValue);
    // the kernel's tiles [t_lo, ntiles): below kv_end and, with a window,
    // from the first row's first visible key; cut into n_split runs
    long long kv_end = kv_len;
    if (causal && static_cast<long long>(q_offset) + Sq < kv_end) kv_end = q_offset + Sq;
    const long long ntiles = kv_end > 0 ? (kv_end - 1) / kBK + 1 : 0;
    const long long first = static_cast<long long>(q_offset) - a.window + 1;
    const long long t_lo = a.window > 0 && first > 0 ? first / kBK : 0;
    const long long n = ntiles > t_lo ? ntiles - t_lo : 0;
    a.tiles_per_split = n > 0 ? static_cast<int>((n + n_split - 1) / n_split) : 1;
  }
  // 16-byte loads need every row start 16-byte aligned: the base pointers
  // and every stride a multiple of 16 bytes (D always is).
  const long long vec = dtype == 0 ? 4 : 8;
  const long long strides[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  a.vec = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  for (long long st : strides) a.vec = a.vec && st % vec == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lse != nullptr) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    return a.window > 0 ? launch_lse<true>(a, B, Hkv, D, s) : launch_lse<false>(a, B, Hkv, D, s);
  }
  if (dtype == 0) return launch_type<float>(a, B, Hkv, D, n_split, s);
  if (dtype == 1) return launch_type<__nv_bfloat16>(a, B, Hkv, D, n_split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
