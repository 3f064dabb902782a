// K6: causal GQA flash attention with an online softmax, for Hopper (sm_90a).
//
// K6 replaces repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (_flash_kernel, the pallas_call at kernel.py:123), and runs every attention
// call of the port's transformer, prefill and KV-cache decode alike:
//
//   s[i, j] = (q[b, i, h, :] . k[b, j, h / G, :]) * scale        (fp32)
//   s[i, j] = -1e30  where j >= kv_len, or (causal) j > q_offset + i
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
// sequential KV axis.  Here one block of 128 threads owns one (batch, KV
// head, tile of R query rows) and walks the KV tiles itself.  The rows of a
// tile are the flattened (position, head-in-group) pairs rho = i * G + g,
// so all G query heads of a KV head share every K and V tile that is staged
// in shared memory: for tinyllama (G = 8) K and V are read once per group,
// not once per head.  Tiles are staged with 16-byte loads, all of a
// thread's issued before any is stored, where every row start is 16-byte
// aligned (element by element otherwise).  KV tiles of 64 keys wholly past
// kv_len or above the causal diagonal of the block's last row are not
// visited (kernel.py:67-73); keys past Skv in the last tile are loaded as
// zeros and masked.  Three paths, chosen at launch from the shape and type:
//   * decode (Sq * G <= 16): R = 8 rows (the G heads of one position),
//     scalar fp32 FMAs, each thread 1 row x 4 keys of S and 1 row x D/16
//     columns of acc, so a one-row query does not fill a 64-row tile;
//   * bf16 prefill: R = 64, on the tensor cores (mma.sync m16n8k16, bf16
//     in, fp32 accumulate): each warp owns 16 rows, keeps its Q rows as A
//     fragments, and re-packs P (rounded to bf16) in registers as the A
//     operand of PV; the softmax runs on the fragments;
//   * fp32 prefill: R = 64, scalar fp32 FMAs (the tensor cores would round
//     fp32 inputs to TF32), each thread 4 rows x 8 keys and 4 rows x D/8
//     columns, p passed through shared memory to the PV product.
// In the scalar paths a group of NCG neighbouring lanes shares each row,
// and the row's max and sum are warp shuffles.
//
// Bound, one H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), D = 64, H = 32,
// Hkv = 4, bf16, counting q, k, v read once and o written once, and the
// 4*D flops of each unmasked (query, key) pair:
//   prefill B=4, S=512:      4.30 GFLOP, 18,874,368 B -> 5.6 us, bytes;
//   long prefill B=1, 4096: 68.7 GFLOP, 37.7 MB       -> 69 us, operations;
//   decode B=4, kv_len 576:  K and V 1.18 MB           -> 0.35 us, far below
//                                                          a launch (~2 us).
// mma.sync reaches a fraction of the card's bf16 rate (wgmma alone reaches
// all of it), and this kernel neither pipelines its tile loads nor skips
// the masked half of a diagonal tile, so the long prefill sits well above
// its bound; wgmma with TMA-staged tiles is the later step.  Decode runs
// B*Hkv blocks (16 for the serve batch), each walking its KV tiles in turn:
// latency-bound, and split-KV is later work.
//
// The kernel allocates nothing and does not synchronise: it launches on the
// caller's stream and returns cudaGetLastError().  The Python wrapper
// (repro_torch/kernels/flash_attention/cuda.py) checks devices, types,
// shapes and strides before the launch and raises on a nonzero return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
  int vec;                    // every row start 16-byte aligned: 16-byte loads
  float scale;
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

template <typename T, int D, int TM, int NRG, int NCG>
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
  for (int64_t k0 = 0; k0 < kv_end; k0 += kBK) {
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
        const bool valid = kp < a.kv_len && (!a.causal || kp <= qpos[mm]);
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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Shared memory of the tensor-core kernel, in bf16 elements: Qs [64][D+8],
// Ks [kBK][D+8] (row-major, as the QK^T B operand reads them) and Vt
// [D][kBK+8] (V transposed, as the PV B operand reads it); the pads of 16
// bytes put the 8 rows of a fragment load on distinct banks.
template <int D>
constexpr int mma_smem_elems() {
  return 64 * (D + 8) + kBK * (D + 8) + D * (kBK + 8);
}

// The bf16 prefill on the tensor cores (mma.sync m16n8k16), the same
// contraction as flash_attention_kernel: each of the 4 warps owns 16 of the
// block's 64 rows, holds its Q rows as A fragments for the whole sweep, and
// per KV tile forms S (16 x 64) with 32 mma, the online softmax on the
// fragments (a row's 4 lanes reduce by shuffles), and P, rounded to bf16,
// is re-packed in registers as the A operand of PV (the S fragment of keys
// 16j..16j+15 is the A fragment of k-step j).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel_mma(const Args a) {
  using T = __nv_bfloat16;
  constexpr int R = 64;
  constexpr int ST = D + 8;
  constexpr int VST = kBK + 8;
  constexpr int KSTEPS = D / 16;        // k-steps of QK^T over the head dim
  constexpr int NT = kBK / 8;           // key n-tiles of S
  constexpr int DT = D / 8;             // head-dim n-tiles of the output

  extern __shared__ float smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + R * ST;
  T* Vt = Ks + kBK * ST;

  const T* __restrict__ q = static_cast<const T*>(a.q);
  T* __restrict__ o = static_cast<T*>(a.o);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;   // this lane's rows: r0, r0 + 8
  const int kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t rows = static_cast<int64_t>(a.Sq) * a.G;
  const int64_t rho0 = static_cast<int64_t>(blockIdx.x) * R;

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
        [&](int, int r, int d, float x) { Qs[r * ST + d] = __float2bfloat16(x); });
  }
  __syncthreads();
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    qa[ks][0] = ld32(Qs + r0 * ST + ks * 16 + 2 * t);
    qa[ks][1] = ld32(Qs + (r0 + 8) * ST + ks * 16 + 2 * t);
    qa[ks][2] = ld32(Qs + r0 * ST + ks * 16 + 8 + 2 * t);
    qa[ks][3] = ld32(Qs + (r0 + 8) * ST + ks * 16 + 8 + 2 * t);
  }

  const int64_t qpos[2] = {a.q_offset + (rho0 + r0) / a.G,
                           a.q_offset + (rho0 + r0 + 8) / a.G};
  int64_t kv_end = a.kv_len;
  if (a.causal) {
    const int64_t last_row = rows - 1 < rho0 + R - 1 ? rows - 1 : rho0 + R - 1;
    const int64_t causal_end = a.q_offset + last_row / a.G + 1;
    if (causal_end < kv_end) kv_end = causal_end;
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;

  const T* const kv[2] = {static_cast<const T*>(a.k) + b * a.ksb + static_cast<int64_t>(kvh) * a.ksh,
                          static_cast<const T*>(a.v) + b * a.vsb + static_cast<int64_t>(kvh) * a.vsh};
  for (int64_t k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();                    // the last tile's Ks/Vt are read
    stage<T, D, kBK, 2>(
        a.vec, kv,
        [&](int u, int j) -> int64_t {
          return k0 + j < a.Skv ? (k0 + j) * (u == 0 ? a.kss : a.vss) : -1;
        },
        [&](int u, int j, int d, float x) {
          if (u == 0) Ks[j * ST + d] = __float2bfloat16(x);
          else Vt[d * VST + j] = __float2bfloat16(x);
        });
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        mma_bf16_16816(s[nt], qa[ks], ld32(Ks + (nt * 8 + g) * ST + ks * 16 + 2 * t),
                       ld32(Ks + (nt * 8 + g) * ST + ks * 16 + 8 + 2 * t));
    }

    // s[nt][e]: row r0 + 8 * (e / 2), key k0 + 8 * nt + 2t + e % 2.
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t kp = k0 + nt * 8 + 2 * t + (e & 1);
        const bool valid = kp < a.kv_len && (!a.causal || kp <= qpos[e >> 1]);
        s[nt][e] = valid ? s[nt][e] * a.scale : kNegInf;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[nt][e]);
      }
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(kFull, mt[hr], 1));
      mt[hr] = fmaxf(mt[hr], __shfl_xor_sync(kFull, mt[hr], 2));
      const float m_new = fmaxf(m[hr], mt[hr]);
      corr[hr] = expf(m[hr] - m_new);
      m[hr] = m_new;
    }
    float ls[2] = {0.0f, 0.0f};
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(s[nt][e] - m[e >> 1]);
        ls[e >> 1] += p[e];
      }
      pa[nt / 2][(nt & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * corr[hr] + ls[hr];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] *= corr[e >> 1];
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j)
        mma_bf16_16816(acc[dt], pa[j], ld32(Vt + (dt * 8 + g) * VST + j * 16 + 2 * t),
                       ld32(Vt + (dt * 8 + g) * VST + j * 16 + 8 + 2 * t));
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    const int64_t rho = rho0 + r0 + 8 * hr;
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

template <typename T, int D, int TM, int NRG, int NCG>
int launch_shape(const Args& a, int B, int Hkv, cudaStream_t stream) {
  return launch_grid(flash_attention_kernel<T, D, TM, NRG, NCG>,
                     sizeof(float) * smem_floats<D, TM * NRG, NCG>(), TM * NRG, a, B,
                     Hkv, stream);
}

// Decode (at most 16 rows) on the 8-row scalar shape; a bf16 prefill on the
// tensor cores; an fp32 prefill on the 64-row scalar shape (fp32 products
// are exact only outside the tensor cores).
template <typename T, int D>
int launch_dim(const Args& a, int B, int Hkv, cudaStream_t stream) {
  if (static_cast<int64_t>(a.Sq) * a.G <= 16)
    return launch_shape<T, D, 1, 8, 16>(a, B, Hkv, stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_grid(flash_attention_kernel_mma<D>,
                       sizeof(__nv_bfloat16) * mma_smem_elems<D>(), 64, a, B, Hkv,
                       stream);
  else
    return launch_shape<T, D, 4, 16, 8>(a, B, Hkv, stream);
}

template <typename T>
int launch_type(const Args& a, int B, int Hkv, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_dim<T, 16>(a, B, Hkv, stream);
    case 32: return launch_dim<T, 32>(a, B, Hkv, stream);
    case 64: return launch_dim<T, 64>(a, B, Hkv, stream);
    case 128: return launch_dim<T, 128>(a, B, Hkv, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  Strides in elements; the head dim is
// contiguous in q, k and v, and o is contiguous (B, Sq, H, D).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Skv, int H, int Hkv, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, int q_offset, int kv_len, int causal,
    float scale, void* stream) {
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
  a.scale = scale;
  // 16-byte loads need every row start 16-byte aligned: the base pointers
  // and every stride a multiple of 16 bytes (D always is).
  const long long vec = dtype == 0 ? 4 : 8;
  const long long strides[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  a.vec = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  for (long long st : strides) a.vec = a.vec && st % vec == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_type<float>(a, B, Hkv, D, s);
  if (dtype == 1) return launch_type<__nv_bfloat16>(a, B, Hkv, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
