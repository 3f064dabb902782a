// K5: embedding bag (gather table rows, weight them, sum each bag) for Hopper
// (sm_90a).
//
// K5 replaces repro/kernels/embedding_bag/kernel.py::embedding_bag_pallas
// (_bag_kernel, the pallas_call at kernel.py:61).  In the port it carries
// both table lookups of SASRec (the user's item sequence, weight sqrt(d),
// and the scored candidates, weight 1: bags of one row each) and the sum
// and mean modes of models/recsys/embedding.py:
//
//   out[b, :] = sum_{i : seg[i] == b} w[i] * table[idx[i], :]
//
// table (V, d) fp32 or bf16, row-major; idx, seg (nnz,) int32, seg sorted
// ascending with values in [0, n_bags); w (nnz,) of the table's type; out
// (n_bags, d) of the table's type.  Each product w[i] * table[idx[i], c] is
// taken in fp32 and added in fp32, in nnz order, with no fused multiply-add
// (__fmul_rn, __fadd_rn), into a sum that starts at 0 and is rounded to the
// table's type once: what the plain version (kernels/embedding_bag/ref.py)
// computes, so a bag of one is bit-equal to w * table[idx].  An empty bag
// is a row of zeros, as the plain version's segment sum gives it (the
// Pallas kernel leaves such rows unwritten).
//
// Design: one warp per bag.  The Pallas kernel walks the nnz entries in
// order on one core, with the indices prefetched ahead of the grid and the
// output row kept resident while its segment lasts.  Here the bags run in
// parallel, so each warp finds where its bag starts in the sorted segments:
// a 32-way search (each lane probes one of 32 evenly spaced positions,
// __ballot_sync counts those below the bag; four rounds for 10^6 entries)
// instead of an offsets array, so the contract stays repro's.  The warp then
// reads its bag's entries 32 at a time (idx, seg, w: coalesced), stops at
// the first entry of another bag, and hands each entry in turn to all 32
// lanes with __shfl_sync.  The lanes stride over the row's d columns, VEC
// elements each (VEC = 4, 2 or 1, the widest that divides d and the
// pointers' alignment: d = 50 gives VEC = 2, so a 200-byte row is one 8-byte
// load on each of 25 lanes; 16-byte loads would misread odd rows), and
// keep 4 such chunks each, 32 * 4 * VEC columns a pass; wider rows walk the
// bag again for each further pass.
//
// Bound: device-memory bytes.  A launch must read idx, seg and w once
// (nnz * (4 + 4 + elsize) bytes), nnz table rows (nnz * d * elsize) and
// write the output (n_bags * d * elsize): for SASRec's retrieval lookup
// (10^6 bags of one, d = 50, fp32) 412 MB, 0.123 ms at 3.35 TB/s.  The
// arithmetic is one multiply and add per element, far below the card's
// rate.  A bag of one costs its warp the search's dependent loads before
// the row's, so bags of one are bound by each warp's memory latency rather
// than by bandwidth; several bags per warp, a persistent grid and wider
// loads are later work.
//
// Offsets are int64 (idx * d passes 2^31 for tables of 10^9 rows).  Indices
// must lie in [0, V): the kernel does not check them.  The kernel allocates
// nothing and does not synchronise: it launches on the caller's stream and
// returns cudaGetLastError().  The Python wrapper
// (repro_torch/kernels/embedding_bag/cuda.py) checks devices, types, shapes
// and contiguity before the launch and raises on a nonzero return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // warps (bags) per block
constexpr int kThreads = 32 * kWarps;
constexpr int kChunks = 4;              // VEC-wide column chunks per lane
constexpr unsigned kFull = 0xffffffffu;

// Elements: fp32 as float, bf16 as its raw 16 bits.
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(uint16_t x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ uint16_t from_f<uint16_t>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// The first position p in [0, nnz) with seg[p] >= b (nnz if none), in every
// lane.  The answer stays in [lo, hi]; each round 32 probes cut the range
// to one step.  Whatever seg holds, every probe stays inside [0, nnz).
__device__ __forceinline__ int64_t lower_bound_warp(
    const int32_t* __restrict__ seg, int64_t nnz, int32_t b, int lane) {
  int64_t lo = 0, hi = nnz;
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + (lane + 1) * step - 1;
    const bool below = p < hi && __ldg(seg + p) < b;
    const int c = __popc(__ballot_sync(kFull, below));
    const int64_t last = lo + (c + 1) * step - 1;  // lane c's probe
    lo += c * step;
    hi = last < hi ? last : hi;
  }
  const int64_t p = lo + lane;
  const bool below = p < hi && __ldg(seg + p) < b;
  return lo + __popc(__ballot_sync(kFull, below));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table,
                     const int32_t* __restrict__ idx,
                     const int32_t* __restrict__ seg,
                     const T* __restrict__ wgt, T* __restrict__ out,
                     int64_t nnz, int64_t n_bags, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= n_bags) return;              // a whole warp leaves together
  const int32_t bag = static_cast<int32_t>(b);
  const int64_t lo = lower_bound_warp(seg, nnz, bag, lane);
  T* orow = out + b * d;
  constexpr int kCols = 32 * VEC * kChunks;   // columns a pass

  for (int c0 = 0; c0 < d; c0 += kCols) {
    float acc[kChunks][VEC];
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[j][e] = 0.0f;

    for (int64_t k0 = lo;; k0 += 32) {
      // The bag's entries are a prefix of these 32 (segments are sorted).
      const int64_t k = k0 + lane;
      const bool mine = k < nnz && __ldg(seg + k) == bag;
      int32_t ik = 0;
      float wk = 0.0f;
      if (mine) {
        ik = __ldg(idx + k);
        wk = to_f(wgt[k]);
      }
      const int n = __popc(__ballot_sync(kFull, mine));
      for (int t = 0; t < n; ++t) {
        const int32_t it = __shfl_sync(kFull, ik, t);
        const float wt = __shfl_sync(kFull, wk, t);
        const T* row = table + static_cast<int64_t>(it) * d;
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          const int c = c0 + (j * 32 + lane) * VEC;
          if (c < d) {
            const Pack<T, VEC> x = *reinterpret_cast<const Pack<T, VEC>*>(row + c);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[j][e] = __fadd_rn(acc[j][e], __fmul_rn(wt, to_f(x.v[e])));
          }
        }
      }
      if (n < 32) break;
    }

#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = c0 + (j * 32 + lane) * VEC;
      if (c < d) {
        Pack<T, VEC> y;
#pragma unroll
        for (int e = 0; e < VEC; ++e) y.v[e] = from_f<T>(acc[j][e]);
        *reinterpret_cast<Pack<T, VEC>*>(orow + c) = y;
      }
    }
  }
}

template <typename T, int VEC>
int launch(const void* table, const void* idx, const void* seg,
           const void* wgt, void* out, int64_t nnz, int64_t n_bags, int d,
           cudaStream_t stream) {
  const int64_t blocks = (n_bags + kWarps - 1) / kWarps;
  embedding_bag_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(seg), static_cast<const T*>(wgt),
      static_cast<T*>(out), nnz, n_bags, d);
  return static_cast<int>(cudaGetLastError());
}

// The widest VEC that divides d and keeps every row start of the table and
// of the output aligned to VEC elements.
template <typename T>
int launch_type(const void* table, const void* idx, const void* seg,
                const void* wgt, void* out, int64_t nnz, int64_t n_bags,
                int d, cudaStream_t stream) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(table) |
                         reinterpret_cast<uintptr_t>(out);
  if (d % 4 == 0 && base % (4 * sizeof(T)) == 0)
    return launch<T, 4>(table, idx, seg, wgt, out, nnz, n_bags, d, stream);
  if (d % 2 == 0 && base % (2 * sizeof(T)) == 0)
    return launch<T, 2>(table, idx, seg, wgt, out, nnz, n_bags, d, stream);
  return launch<T, 1>(table, idx, seg, wgt, out, nnz, n_bags, d, stream);
}

}  // namespace

// table (V, d), idx/seg (nnz,) int32, wgt (nnz,), out (n_bags, d); dtype 0
// is fp32, 1 bf16 (table, wgt and out alike).
extern "C" int embedding_bag_fwd(const void* table, const void* idx,
                                 const void* seg, const void* wgt, void* out,
                                 int dtype, long long nnz, long long n_bags,
                                 int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_type<float>(table, idx, seg, wgt, out, nnz, n_bags, d, s);
  if (dtype == 1)
    return launch_type<uint16_t>(table, idx, seg, wgt, out, nnz, n_bags, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
