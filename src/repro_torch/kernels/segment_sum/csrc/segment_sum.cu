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
// Bound: device-memory bytes.  A launch reads cols and wts once (8*G*B*w
// bytes), gathers G*B*w labels (each shard's label row stays in the 50 MB
// L2 across its rows) and writes the table, 4*G*B*nparts bytes: at the
// sweep's shape (G = 64, B = 1463, w = 26, nparts = 64) 44.3 MB, 13.2 us at
// 3.35 TB/s.  The arithmetic is one compare and add per slot.  Tensor
// cores have no use here: no operand is reused, and the one-hot product
// they would take is almost all zeros.
//
// Design: a block of kThreads threads takes a tile of R consecutive rows
// of the flattened (G*B) row axis (a tile may cross a shard boundary, so
// each row finds its shard, r / B, once).  cols/wts and out are row-major,
// so a tile is one contiguous slab in each.
//  1. Stage: the tile's cols and wts (R*w words each) go to shared memory
//     by 16-byte cp.async copies; the unaligned head and tail by single
//     words (a view may start anywhere: a staged copy is shifted so that
//     it shares its source's place in a 16-byte line).  The table is
//     zeroed while the copies fly.
//  2. Gather: all threads gather the tile's R*w labels, kUnroll
//     independent loads each in flight, over the staged cols.
//  3. Sum: one thread per row walks its slots k = 0..w-1 in order (kBatch
//     loaded at a time) and adds each weight into its row of the shared
//     table (R rows, an odd stride > chunk, so neighbouring rows that
//     share a label use different banks).  Each part's sum is taken over
//     the slots in order, as the plain version (kernels/segment_sum/
//     ref.py) and repro's slot loop take it: the results are bitwise
//     equal, with no atomics.
//  4. Write: the block copies the table to out, each entry once, 16-byte
//     stores where the tile's slab is aligned.
// R is the largest power of two <= kRows that leaves kFill tiles per SM,
// and at most kSlab / w: K4 at the sweep's 93,632 rows takes 64-row tiles
// (1,463 blocks of 30.5 KB, seven an SM), K3 at 1,463 rows 2-row ones.
// nparts above kChunk is walked in chunks of kChunk parts, each a pass
// over the staged labels; rows wider than kSlab slots take one row a
// tile, staged kSlab slots at a time.  Shared memory: up to 66,336 bytes
// a block (the attribute is set once per device).
//
// Measured (tools/segsum_ab.py, parent and this kernel in turns on one
// H100 80GB HBM3 at 700 W; profiler device us; K4 main from RCB labels,
// (64, 1320, 26, 88320, 64)): K4 main 46.6 -> 20.5 (bound 11.9,
// index_add_ 27-29), K3 bench (16384 rows, w 27, 128 parts) 15.1 -> 8.1
// (bound 3.6, index_add_ 5.9), K3 root (1320 rows of main) 2.6 -> 3.9,
// K4 tiny (3 x 40 rows) 1.6 -> 3.5.  What holds it back (the same
// tool's ablations): a block takes one tile and runs its steps one after
// another, so copies, gathers, sums and stores overlap only across the
// SM's blocks; without the sum main takes 18.1, and the gather (2.2 M
// scattered label reads, a 32-byte sector each) costs more (PERF.md).  At
// a few rows a tile the chain is the whole time: copies, gather, w
// dependent table updates by the row's thread, store.  16-deep gathers,
// 128- or 32-row tiles and 64 or 256 threads a block measured slower.
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

constexpr int kThreads = 128;  // threads per block
constexpr int kRows = 64;      // most rows per tile
constexpr int kChunk = 128;    // most parts per pass over the staged labels
constexpr int kSlab = 4096;    // most slots staged per tile (each array)
constexpr int kFill = 4;       // tiles per SM the grid aims at
constexpr int kUnroll = 8;     // label gathers in flight per thread
constexpr int kBatch = 8;      // slots a sum thread loads at a time
constexpr int kDevices = 64;   // devices whose set-up is remembered

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// The table's row stride: odd, above the widest chunk.
__host__ __device__ constexpr int stride_of(int nparts) {
  return ((nparts < kChunk ? nparts : kChunk) + 1) | 1;
}

// Dynamic shared memory in words: the table, the rows' label offsets
// (int64), then the staged cols and wts, each with 4 words of slack for
// the shift that aligns it with its source.
__host__ __device__ constexpr int smem_words(int R, int S, int kc) {
  return round4(R * S) + round4(2 * R) + 2 * (round4(R * kc) + 4);
}

// The most a launch takes: R * kc <= kSlab.
constexpr int kMaxSmemWords =
    smem_words(kRows, stride_of(kChunk), kSlab / kRows);

struct Args {
  const int32_t* labels;
  const int32_t* cols;
  const float* wts;
  float* out;
  int64_t rows, B, m;
  int w, nparts;
  int R;   // rows per tile
  int kc;  // slots staged at a time: w, or kSlab (then R = 1)
};

// Words of ``p`` past its 16-byte boundary.
__device__ __forceinline__ int misalign(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Where the staged copy of src starts in its 16-byte aligned area.
template <class T>
__device__ __forceinline__ T* staged_at(uint32_t* area, const T* src) {
  return reinterpret_cast<T*>(area + misalign(src));
}

// s[0, n) = src[0, n): cp.async for the 16-byte aligned body, single words
// for the head and tail.  Completes at the next cp.async wait.
template <class T>
__device__ __forceinline__ void stage(T* s, const T* src, int n) {
  const int head = min((4 - misalign(src)) & 3, n);
  const int nvec = (n - head) >> 2;
  for (int j = threadIdx.x; j < head; j += kThreads) s[j] = src[j];
  for (int v = threadIdx.x; v < nvec; v += kThreads)
    cp_async16(s + head + 4 * v, src + head + 4 * v);
  for (int j = head + 4 * nvec + threadIdx.x; j < n; j += kThreads)
    s[j] = src[j];
}

// lab[e] = labels[goff[e / kn] + lab[e]] for e in [0, n): row e / kn of
// the tile reads its own shard's labels.
__device__ __forceinline__ void gather(int32_t* lab, const int64_t* goff,
                       const int32_t* __restrict__ labels, int n, int kn) {
  const int dr = kThreads / kn, dk = kThreads - dr * kn;
  int row = threadIdx.x / kn, k = threadIdx.x - row * kn;
  for (int e0 = threadIdx.x; e0 < n; e0 += kThreads * kUnroll) {
    int32_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= n) break;
      v[u] = __ldg(labels + goff[row] + lab[e]);
      k += dk;
      row += dr;
      if (k >= kn) {
        k -= kn;
        ++row;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kThreads;
      if (e < n) lab[e] = v[u];
    }
  }
}

// dst[e] = tab[(e / cw) * S + e % cw] for e in [0, n): the tile's rows are
// contiguous in out (cw == nparts).
__device__ __forceinline__ void store_tile(float* dst, const float* tab, int S, int n,
                           int cw) {
  const int head = min((4 - misalign(dst)) & 3, n);
  const int nvec = (n - head) >> 2;
  for (int e = threadIdx.x; e < head; e += kThreads)
    dst[e] = tab[(e / cw) * S + e % cw];
  const int dr = 4 * kThreads / cw, dq = 4 * kThreads - dr * cw;
  const int e1 = head + 4 * threadIdx.x;
  int row = e1 / cw, q = e1 - row * cw;
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    float x[4];
    int rr = row, qq = q;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = tab[rr * S + qq];
      if (++qq == cw) {
        qq = 0;
        ++rr;
      }
    }
    *reinterpret_cast<float4*>(dst + head + 4 * v) =
        make_float4(x[0], x[1], x[2], x[3]);
    q += dq;
    row += dr;
    if (q >= cw) {
      q -= cw;
      ++row;
    }
  }
  for (int e = head + 4 * nvec + threadIdx.x; e < n; e += kThreads)
    dst[e] = tab[(e / cw) * S + e % cw];
}

// dst[row * nparts + q] = tab[row * S + q], row < nr, q < cw: one chunk of
// parts (cw < nparts), rows apart in out.
__device__ __forceinline__ void store_rows(float* dst, int64_t nparts, const float* tab,
                           int S, int nr, int cw) {
  const int dr = kThreads / cw, dq = kThreads - dr * cw;
  int row = threadIdx.x / cw, q = threadIdx.x - row * cw;
  for (int e = threadIdx.x; e < nr * cw; e += kThreads) {
    dst[row * nparts + q] = tab[row * S + q];
    q += dq;
    row += dr;
    if (q >= cw) {
      q -= cw;
      ++row;
    }
  }
}

// The sum of row t: thread t adds the weight of each slot k = 0..kn-1, in
// order, whose label lies in [p0, p0 + cw) into its row of the table, so
// each part's sum is taken in slot order.  The slots come in batches of
// kBatch independent loads.
__device__ __forceinline__ void sum_row(float* row, const int32_t* l,
                                        const float* v, int kn, int p0,
                                        int cw) {
  for (int k0 = 0; k0 < kn; k0 += kBatch) {
    int32_t lk[kBatch];
    float vk[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      lk[i] = k0 + i < kn ? l[k0 + i] : -1;
      vk[i] = k0 + i < kn ? v[k0 + i] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const unsigned q =
          static_cast<unsigned>(lk[i]) - static_cast<unsigned>(p0);
      if (q < static_cast<unsigned>(cw)) row[q] += vk[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * a.R;
  const int nr = static_cast<int>(a.rows - r0 < a.R ? a.rows - r0 : a.R);
  const int S = stride_of(a.nparts);
  float* tab = reinterpret_cast<float*>(smem);
  int64_t* goff = reinterpret_cast<int64_t*>(smem + round4(a.R * S));
  uint32_t* area_c = smem + round4(a.R * S) + round4(2 * a.R);
  uint32_t* area_w = area_c + round4(a.R * a.kc) + 4;

  const bool whole = a.kc == a.w;  // every slot staged once per tile
  for (int p0 = 0; p0 < a.nparts; p0 += kChunk) {
    const int cw = min(kChunk, a.nparts - p0);
    for (int k0 = 0; k0 < a.w; k0 += a.kc) {
      const int kn = min(a.kc, a.w - k0);
      const int n = nr * kn;
      // whole rows (kn == w) or one row (nr == 1): a contiguous slab
      const int64_t off = r0 * a.w + k0;
      int32_t* lab = staged_at(area_c, a.cols + off);
      float* wt = staged_at(area_w, a.wts + off);
      const bool load = p0 == 0 || !whole;
      if (load) {
        stage(lab, a.cols + off, n);
        stage(wt, a.wts + off, n);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
      if (p0 == 0 && k0 == 0) {  // each row's shard, while the copies fly
        for (int t = tid; t < nr; t += kThreads)
          goff[t] = (r0 + t) / a.B * a.m;
      }
      if (k0 == 0) {
        float4* t4 = reinterpret_cast<float4*>(tab);
        for (int j = tid; j < round4(nr * S) / 4; j += kThreads)
          t4[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      if (load) {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
        gather(lab, goff, a.labels, n, kn);
      }
      __syncthreads();
      if (tid < nr)
        sum_row(tab + tid * S, lab + tid * kn, wt + tid * kn, kn, p0, cw);
      __syncthreads();
    }
    if (cw == a.nparts)
      store_tile(a.out + r0 * a.nparts, tab, S, nr * cw, cw);
    else
      store_rows(a.out + r0 * a.nparts + p0, a.nparts, tab, S, nr, cw);
    __syncthreads();
  }
}

int launch(const void* labels, const void* cols, const void* wts, void* out,
           int G, long long B, int w, long long m, int nparts, void* stream) {
  if (G <= 0 || B <= 0 || w <= 0 || nparts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // SM count and the shared-memory attribute, once per device
  static int sms_of[kDevices];
  int sms = dev < kDevices ? sms_of[dev] : 0;
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(segment_sum_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               4 * kMaxSmemWords);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kDevices) sms_of[dev] = sms;
  }
  Args a{static_cast<const int32_t*>(labels), static_cast<const int32_t*>(cols),
         static_cast<const float*>(wts), static_cast<float*>(out),
         static_cast<int64_t>(G) * B, B, m, w, nparts, kRows, w};
  while (a.R > 1 && (a.rows + a.R - 1) / a.R < static_cast<int64_t>(kFill) * sms)
    a.R >>= 1;
  if (w > kSlab) {
    a.R = 1;
    a.kc = kSlab;
  } else if (a.R > kSlab / w) {
    a.R = kSlab / w;
  }
  const int64_t tiles = (a.rows + a.R - 1) / a.R;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4 * static_cast<size_t>(
      smem_words(a.R, stride_of(nparts), a.kc));
  segment_sum_kernel<<<static_cast<unsigned>(tiles), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
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
