// K3 and K4: the connection table of FM refinement for Hopper (sm_90a).
//
// K4 replaces repro/kernels/segment_sum/kernel.py::segment_sum_batched_pallas
// (_segsum_batched_kernel), the table every sweep of the sharded refinement
// builds in one launch; K3 replaces segment_sum_pallas (_segsum_kernel), the
// single-problem form, and is the G = 1 launch of the same __global__:
//
//   out[g, i, q] = sum_k wts[g, i, k] * (labels[g, cols[g, i, k]] == q)
//
// labels (G, m) int32, cols (G, B, w) int32, wts (G, B, w) fp32, out
// (G, B, nparts) fp32, all row-major.  Labels outside [0, nparts) add
// nothing; pad slots carry weight 0.
//
// Design: one warp per row (g, i).  Lane t loads slot k0 + t of the row
// (cols and wts of a row are contiguous, so the warp's loads coalesce) and
// gathers its label; __shfl_sync then hands every slot, in order k = 0..w-1,
// to all 32 lanes.  Lane t owns the parts q = p0 + 32*j + t (j < PPL) and
// adds the slot's weight where the label is one of them.  So each part's
// sum is taken over the slots in order, as the plain version
// (kernels/segment_sum/ref.py) and repro's slot loop take it: results are
// bitwise equal, with no atomics and no zeroing pass.  The warp then writes
// its row of nparts floats, 32 neighbouring parts per store.  nparts above
// 32*PPL (256 parts) is walked in chunks of 32*PPL parts, each a pass over
// the row's slots.
//
// Bound: device-memory bytes.  A launch reads cols and wts once (8*G*B*w
// bytes), gathers G*B*w labels (each shard's label row, 4*m bytes, stays in
// the 50 MB L2 across its rows), and writes 4*G*B*nparts bytes of table.
// The arithmetic is one compare and add per slot and lane, far below the
// card's rate, but the broadcast loop costs w shuffles per row, which at
// small w and nparts makes it instruction-bound rather than byte-bound; that
// is the price of the fixed summation order.
//
// Offsets are int64 (g*m and (g*B + i)*w pass 2^31 at scale).  The kernel
// allocates nothing and does not synchronise: it launches on the caller's
// stream and returns cudaGetLastError().  The Python wrapper
// (repro_torch/kernels/segment_sum/cuda.py) checks devices, types, shapes
// and contiguity before the launch and raises on a nonzero return.  Column
// ids must lie in [0, m): the kernel does not check them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // warps (rows) per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

template <int PPL>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const int32_t* __restrict__ labels,
                   const int32_t* __restrict__ cols,
                   const float* __restrict__ wts, float* __restrict__ out,
                   int64_t rows, int64_t B, int w, int64_t m, int nparts) {
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;                // a whole warp leaves together
  const int64_t g = r / B;
  const int32_t* lab = labels + g * m;
  const int64_t base = r * w;
  float* orow = out + r * nparts;

  for (int p0 = 0; p0 < nparts; p0 += 32 * PPL) {
    float acc[PPL];
#pragma unroll
    for (int j = 0; j < PPL; ++j) acc[j] = 0.0f;
    for (int k0 = 0; k0 < w; k0 += 32) {
      const int k = k0 + lane;
      int32_t l = -1;
      float v = 0.0f;
      if (k < w) {
        l = __ldg(lab + __ldcs(cols + base + k));
        v = __ldcs(wts + base + k);
      }
      const int nk = min(32, w - k0);
      for (int t = 0; t < nk; ++t) {
        const int32_t lt = __shfl_sync(kFull, l, t);
        const float vt = __shfl_sync(kFull, v, t);
        const int q = lt - p0;
        if (q >= 0 && (q & 31) == lane) {
          const int jq = q >> 5;
#pragma unroll
          for (int j = 0; j < PPL; ++j)
            if (j == jq) acc[j] += vt;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < PPL; ++j) {
      const int q = p0 + 32 * j + lane;
      if (q < nparts) orow[q] = acc[j];
    }
  }
}

template <int PPL>
void launch_ppl(const void* labels, const void* cols, const void* wts, void* out,
                long long rows, long long B, int w, long long m, int nparts,
                cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  segment_sum_kernel<PPL><<<static_cast<unsigned int>(blocks), kThreads, 0,
                            stream>>>(
      static_cast<const int32_t*>(labels), static_cast<const int32_t*>(cols),
      static_cast<const float*>(wts), static_cast<float*>(out),
      static_cast<int64_t>(rows), static_cast<int64_t>(B), w,
      static_cast<int64_t>(m), nparts);
}

// Parts per lane: the fewest registers that hold a row of nparts, at most 8
// (256 parts); wider rows are walked in chunks of 256 parts.
int launch(const void* labels, const void* cols, const void* wts, void* out,
           int G, long long B, int w, long long m, int nparts, void* stream) {
  const long long rows = static_cast<long long>(G) * B;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nparts <= 32)
    launch_ppl<1>(labels, cols, wts, out, rows, B, w, m, nparts, s);
  else if (nparts <= 64)
    launch_ppl<2>(labels, cols, wts, out, rows, B, w, m, nparts, s);
  else if (nparts <= 128)
    launch_ppl<4>(labels, cols, wts, out, rows, B, w, m, nparts, s);
  else
    launch_ppl<8>(labels, cols, wts, out, rows, B, w, m, nparts, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3: labels (m,), cols/wts (B, w), out (B, nparts).
extern "C" int segment_sum_f32(const void* labels, const void* cols,
                               const void* wts, void* out, long long B, int w,
                               long long m, int nparts, void* stream) {
  return launch(labels, cols, wts, out, 1, B, w, m, nparts, stream);
}

// K4: labels (G, m), cols/wts (G, B, w), out (G, B, nparts).
extern "C" int segment_sum_batched_f32(const void* labels, const void* cols,
                                       const void* wts, void* out, int G,
                                       long long B, int w, long long m,
                                       int nparts, void* stream) {
  return launch(labels, cols, wts, out, G, B, w, m, nparts, stream);
}
