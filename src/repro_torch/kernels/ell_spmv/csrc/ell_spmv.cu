// K1 and K2: ELL sparse matvecs for Hopper (sm_90a), transposed-ELL layout.
//
// K1 replaces repro/kernels/ell_spmv/kernel.py::ell_spmv_pallas, the Pallas
// TPU kernel, as the matvec of every packed Lanczos step in repro_torch:
//
//   y[i] = sum_k vals_t[k, i] * x[cols_t[k, i]]        (k < w, i < n)
//
// K2 (below K1) replaces repro/kernels/ell_spmv/kernel.py::
// ell_spmv_batched_pallas: B independent operators with per-problem column
// ids, the inverse-iteration level operators and every BatchedAMG level.
//
// cols_t (w, n) int32 and vals_t (w, n) fp32 or bf16 are row-major, so slot k
// of 32 neighbouring rows is one contiguous line: one thread per row, and a
// warp's loads of one slot coalesce.  Pad slots point at row i with value 0.
// Accumulation is fp32; y has x's type.  Rows past n (a ragged last block)
// are masked by i < n, so n need not be a multiple of the block size.
//
// Bound: device-memory bytes.  A call streams 8*n*w bytes of cols and fp32
// vals once, writes 4*n bytes of y, and gathers x.  x (4*n bytes) is read
// through the read-only path (__ldg) and stays L2-resident for n up to about
// 12M (50 MB of L2), so the gather costs L2 traffic, not device-memory
// traffic; the two slabs are read with the streaming hint (__ldcs) so they
// do not push x out of L2.  At 2 flops per 8 bytes the arithmetic is far
// below the card's rate.  The design is therefore coalesced streaming of the
// two slabs and nothing else: no shared-memory tiling, no tensor cores.
//
// The kernel allocates nothing and does not synchronise: it launches on the
// caller's stream and returns cudaGetLastError().  The Python wrapper
// (repro_torch/kernels/ell_spmv/cuda.py) checks devices, types, shapes and
// contiguity before the launch and raises on a nonzero return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_slab(const float* p, int64_t off) {
  return __ldcs(p + off);
}

__device__ __forceinline__ float load_slab(const __nv_bfloat16* p, int64_t off) {
  const unsigned short bits = __ldcs(reinterpret_cast<const unsigned short*>(p) + off);
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

__device__ __forceinline__ float load_x(const float* x, int32_t c) {
  return __ldg(x + c);
}

__device__ __forceinline__ float load_x(const __nv_bfloat16* x, int32_t c) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(x) + c);
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

__device__ __forceinline__ void store_y(float* y, int64_t i, float acc) {
  y[i] = acc;
}

__device__ __forceinline__ void store_y(__nv_bfloat16* y, int64_t i, float acc) {
  y[i] = __float2bfloat16(acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const int32_t* __restrict__ cols_t, const T* __restrict__ vals_t,
                const T* __restrict__ x, T* __restrict__ y, int64_t n, int w) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
#pragma unroll 4
  for (int k = 0; k < w; ++k) {
    const int64_t off = static_cast<int64_t>(k) * n + i;
    const int32_t c = __ldcs(cols_t + off);
    acc = fmaf(load_slab(vals_t, off), load_x(x, c), acc);
  }
  store_y(y, i, acc);
}

// K2: B independent matvecs, cols_t/vals_t (B, w, n), x and y (B, n):
//
//   y[b, i] = sum_k vals_t[b, k, i] * x[b, cols_t[b, k, i]]
//
// The same design as K1 on a 2-D grid: blockIdx.y is the problem b, so
// slot k of neighbouring rows of one problem is still one contiguous line,
// and problem b's slabs start at b*w*n, its x and y at b*n (int64 offsets,
// so B*w*n may pass 2^31).  The bound
// is the same: 8*B*n*w bytes of slabs streamed once (__ldcs) plus x and y,
// with x[b, :] gathered through the read-only path (__ldg) from L2.  The
// small BatchedAMG coarse levels (n down to 32) are launch-bound.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_spmv_batched_kernel(const int32_t* __restrict__ cols_t,
                        const T* __restrict__ vals_t, const T* __restrict__ x,
                        T* __restrict__ y, int64_t n, int w) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t b = blockIdx.y;
  const int64_t slab = b * w * n;
  const T* xb = x + b * n;
  float acc = 0.0f;
#pragma unroll 4
  for (int k = 0; k < w; ++k) {
    const int64_t off = slab + static_cast<int64_t>(k) * n + i;
    const int32_t c = __ldcs(cols_t + off);
    acc = fmaf(load_slab(vals_t, off), load_x(xb, c), acc);
  }
  store_y(y, b * n + i, acc);
}

template <typename T>
int launch(const void* cols_t, const void* vals_t, const void* x, void* y,
           long long n, int w, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  ell_spmv_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols_t), static_cast<const T*>(vals_t),
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<int64_t>(n), w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_batched(const void* cols_t, const void* vals_t, const void* x,
                   void* y, int batch, long long n, int w, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>(batch));
  ell_spmv_batched_kernel<T><<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols_t), static_cast<const T*>(vals_t),
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<int64_t>(n), w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ell_spmv_f32(const void* cols_t, const void* vals_t, const void* x,
                            void* y, long long n, int w, void* stream) {
  return launch<float>(cols_t, vals_t, x, y, n, w, stream);
}

extern "C" int ell_spmv_bf16(const void* cols_t, const void* vals_t, const void* x,
                             void* y, long long n, int w, void* stream) {
  return launch<__nv_bfloat16>(cols_t, vals_t, x, y, n, w, stream);
}

extern "C" int ell_spmv_batched_f32(const void* cols_t, const void* vals_t,
                                    const void* x, void* y, int batch,
                                    long long n, int w, void* stream) {
  return launch_batched<float>(cols_t, vals_t, x, y, batch, n, w, stream);
}

extern "C" int ell_spmv_batched_bf16(const void* cols_t, const void* vals_t,
                                     const void* x, void* y, int batch,
                                     long long n, int w, void* stream) {
  return launch_batched<__nv_bfloat16>(cols_t, vals_t, x, y, batch, n, w, stream);
}
