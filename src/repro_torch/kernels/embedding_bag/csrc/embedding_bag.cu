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
// Bound: device-memory bytes.  A launch must read idx, seg and w once
// (nnz * (4 + 4 + elsize) bytes), each distinct table row once and write
// the output (n_bags * d * elsize): for SASRec's retrieval lookup (10^6
// bags of one, d = 50, fp32) 412 MB, 0.123 ms at 3.35 TB/s.  The
// arithmetic is one multiply and add per element, far below the card's
// rate.  A random 200-byte row touches 7 or 8 sectors of 32 bytes (224-256
// bytes), so even a kernel that moves nothing else sits ~1.1-1.2x above
// that bound at retrieval.
//
// What held the first design back: one warp per bag, which found its
// bag's start by a 32-way ballot search over seg (four dependent loads at
// 10^6 entries), then loaded its entries (one more) and only then the row
// (one more).  A bag of one cost its warp ~6 dependent round trips to
// device memory to move 200 bytes, with 7 of 32 lanes idle at d = 50:
// latency-bound at 3.2x the bound (0.39 ms at retrieval).
//
// Measured (tools/bag_ab.py, the first design and this one in turns on one
// H100 80GB HBM3 at 700 W; profiler device ms, fp32 / bf16): retrieval
// 0.393 -> 0.171 / 0.379 -> 0.102, serve_bulk's 409,600 bags of one 0.158
// -> 0.042 / 0.158 -> 0.030, serve_p99's 25,600 0.0101 -> 0.0055; 65,536
// bags of 1-64 rows 0.110 -> 0.105-0.114 / 0.132 -> 0.112.  A block-wide
// design (tiles of 256 entries in shared memory, their rows staged by
// cp.async) was as fast on bags of one but 1.3x slower on bags of several
// rows: its steps were separated by barriers and its 47 KB of shared
// memory held an SM to four blocks (PERF.md, section 6).
//
// Design: tiles of entries, no search.  The Pallas kernel walks the nnz
// entries in order on one core, the indices prefetched as scalars and the
// output row kept resident while its segment lasts.  Here each warp takes
// a tile of 32 consecutive entries [t0, t0 + 32), one a lane, and works
// alone: no shared memory and no block barrier, so an SM keeps as many
// tiles in flight as its registers allow.
//  1. Load: the tile's seg, idx and w (coalesced), with seg[t0 - 1] and
//     seg[t0 + 32] beside them: one round trip, held in registers.
//  2. Heads: entry p is the head of its bag when p = 0 or seg[p] !=
//     seg[p - 1]; one ballot finds them.  A bag belongs to the tile that
//     holds its head, so a tile skips the entries of a bag that began in
//     an earlier one.  A second ballot marks the heads that follow empty
//     bags (seg[p] > seg[p - 1] + 1, or seg[0] > 0).
//  3. Zeros: the owner of such a head writes the empty bags' rows
//     (seg[p - 1] + 1 .. seg[p] - 1, or 0 .. seg[0] - 1), and the tile that
//     holds the last entry writes seg[nnz - 1] + 1 .. n_bags - 1 (with
//     nnz = 0 one warp writes every row), spread over the lanes.
//  4. Sums.  Where every entry of the tile is a bag of one (SASRec's
//     lookups), the work items (entry, chunk of VEC columns), chunks
//     fastest, go round the lanes, each lane loading kOnes items' rows at
//     once before it weights and stores them.  Elsewhere the warp walks
//     its bags one after another, a lane a chunk: kAhead entries' rows
//     loaded together, then added in nnz order, each entry's idx and w
//     shuffled from the lane that holds it.  A bag that runs past the tile
//     reads on in windows of 32 entries (one coalesced load each, issued
//     before the rows of the window in hand) until its seg changes.
// VEC is the widest of 4, 2, 1 that divides d and the table's and out's
// alignment (d = 50 gives 2: a 200-byte row starts 16-byte aligned only
// at even row ids).  Every row of out is written by exactly one warp,
// chunk for chunk, so the result does not depend on the order in which
// warps run.
//
// Offsets are int64 (idx * d passes 2^31 for tables of 10^9 rows).  Indices
// must lie in [0, V): the kernel does not check them; entries whose seg
// lies outside [0, n_bags) write nothing.  The kernel allocates nothing and
// does not synchronise: it launches on the caller's stream and returns
// cudaGetLastError().  The Python wrapper
// (repro_torch/kernels/embedding_bag/cuda.py) checks devices, types, shapes
// and contiguity before the launch and raises on a nonzero return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // threads per block (a tile a warp)
constexpr int kTile = 32;       // entries a tile: one a lane
constexpr int kMinBlocks = 8;   // __launch_bounds__'s blocks per SM
constexpr int kOnes = 4;        // bags of one: items a lane loads together
constexpr int kAhead = 4;       // entries whose rows a walk loads together
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads % 32 == 0 && kTile == 32, "a tile is a warp's lanes");

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

template <typename T>
struct Args {
  const T* table;
  const int32_t* idx;
  const int32_t* seg;
  const T* wgt;
  T* out;
  int64_t nnz, n_bags;
  int d;
};

// Entry base + lane's seg, idx and w (zeros past nnz).
template <typename T>
__device__ __forceinline__ void load_entry(const Args<T>& a, int64_t base,
                                           int lane, int32_t& s, int32_t& i,
                                           float& w) {
  const int64_t p = base + lane;
  s = 0;
  i = 0;
  w = 0.0f;
  if (p < a.nnz) {
    s = __ldg(a.seg + p);
    i = __ldg(a.idx + p);
    w = to_f(a.wgt[p]);
  }
}

// out[bag, col .. col + VEC) = acc rounded to T, for a bag in [0, n_bags).
template <typename T, int VEC>
__device__ __forceinline__ void store_row(const Args<T>& a, int32_t bag,
                                          int col, const float (&acc)[VEC]) {
  if (bag < 0 || bag >= a.n_bags) return;
  Pack<T, VEC> y;
#pragma unroll
  for (int v = 0; v < VEC; ++v) y.v[v] = from_f<T>(acc[v]);
  *reinterpret_cast<Pack<T, VEC>*>(a.out + static_cast<int64_t>(bag) * a.d +
                                   col) = y;
}

// out rows [lo, hi) set to zero by the warp's lanes, VEC at a time.
template <typename T, int VEC>
__device__ __forceinline__ void zero_rows(const Args<T>& a, int64_t lo,
                                          int64_t hi, int lane) {
  lo = lo > 0 ? lo : 0;
  hi = hi < a.n_bags ? hi : a.n_bags;
  const int64_t packs = (hi - lo) * (a.d / VEC);
  T* base = a.out + lo * a.d;
  Pack<T, VEC> z;
#pragma unroll
  for (int v = 0; v < VEC; ++v) z.v[v] = from_f<T>(0.0f);
#pragma unroll 1
  for (int64_t q = lane; q < packs; q += 32)
    *reinterpret_cast<Pack<T, VEC>*>(base + q * VEC) = z;
}

// Every entry of the tile a bag of one: items (entry j, chunk c), c
// fastest, item q on lane q % 32, kOnes of a lane's loaded at once, then
// weighted and stored.  (s, i, w) is the lane's entry; n the tile's count.
template <typename T, int VEC>
__device__ __forceinline__ void walk_ones(const Args<T>& a, int n, int32_t s,
                                          int32_t i, float w, int lane) {
  const int nch = a.d / VEC;
  const int items = n * nch;
  int j = lane / nch, c = lane % nch;
  const int dj = 32 / nch, dc = 32 % nch;
#pragma unroll 1
  for (int q0 = 0; q0 < items; q0 += 32 * kOnes) {
    int jg[kOnes], cg[kOnes];
    Pack<T, VEC> x[kOnes];
#pragma unroll
    for (int g = 0; g < kOnes; ++g) {
      jg[g] = j;
      cg[g] = c;
      const int32_t row = __shfl_sync(kFull, i, j < 32 ? j : 31);
      if (j < n)
        x[g] = *reinterpret_cast<const Pack<T, VEC>*>(
            a.table + static_cast<int64_t>(row) * a.d + c * VEC);
      c += dc;
      j += dj;
      if (c >= nch) {
        c -= nch;
        ++j;
      }
    }
#pragma unroll
    for (int g = 0; g < kOnes; ++g) {
      const int src = jg[g] < 32 ? jg[g] : 31;
      const float wj = __shfl_sync(kFull, w, src);
      const int32_t bag = __shfl_sync(kFull, s, src);
      if (jg[g] < n) {
        float acc[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[v] = __fadd_rn(0.0f, __fmul_rn(wj, to_f(x[g].v[v])));
        store_row<T, VEC>(a, bag, cg[g] * VEC, acc);
      }
    }
  }
}

// The bag `bag`, whose head is lane h's entry of the tile at t0 ((s, i, w)
// the lane's entry): a lane a chunk (passes of 32 chunks), the bag's
// entries added in nnz order, the rows of kAhead entries loaded together.
// Past the tile the entries come in windows of 32, one load each, issued
// before the rows of the window in hand, until the bag's seg ends.
template <typename T, int VEC>
__device__ __forceinline__ void walk_bag(const Args<T>& a, int64_t t0,
                                         int32_t s, int32_t i, float w, int h,
                                         int32_t bag, int lane) {
  const int nch = a.d / VEC;
#pragma unroll 1
  for (int c0 = 0; c0 < nch; c0 += 32) {
    const int c = c0 + lane;
    const bool on = c < nch;
    const T* col = a.table + c * VEC;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
    int64_t base = t0;
    int32_t ws = s, wi = i;
    float ww = w;
    int p = h;
#pragma unroll 1
    for (;;) {
      // The bag's entries in this window: [p, q); past it, the next window.
      const unsigned stop = __ballot_sync(
          kFull, lane >= p && (base + lane >= a.nnz || ws != bag));
      const int q = stop != 0 ? __ffs(stop) - 1 : 32;
      const bool more = stop == 0 && base + 32 < a.nnz;
      int32_t ns = 0, ni = 0;
      float nw = 0.0f;
      if (more) load_entry(a, base + 32, lane, ns, ni, nw);
#pragma unroll 1
      for (; p < q; p += kAhead) {
        Pack<T, VEC> x[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int32_t row = __shfl_sync(kFull, wi, p + u < 32 ? p + u : 31);
          if (on && p + u < q)
            x[u] = *reinterpret_cast<const Pack<T, VEC>*>(
                col + static_cast<int64_t>(row) * a.d);
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const float wu = __shfl_sync(kFull, ww, p + u < 32 ? p + u : 31);
          if (on && p + u < q)
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              acc[v] = __fadd_rn(acc[v], __fmul_rn(wu, to_f(x[u].v[v])));
        }
      }
      if (!more) break;
      base += 32;
      ws = ns;
      wi = ni;
      ww = nw;
      p = 0;
    }
    if (on) store_row<T, VEC>(a, bag, c * VEC, acc);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
embedding_bag_kernel(const __grid_constant__ Args<T> a) {
  const int lane = threadIdx.x & 31;
  const int64_t t0 =
      (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kTile;
  if (t0 > a.nnz || (t0 == a.nnz && t0 > 0)) return;   // the whole warp
  const int64_t rest = a.nnz - t0;
  const int n = static_cast<int>(rest < kTile ? rest : kTile);
  const int64_t t1 = t0 + n;

  // 1. The tile's entries, and the seg before and after it.
  int32_t s, i;
  float w;
  load_entry(a, t0, lane, s, i, w);
  int32_t prev = __shfl_up_sync(kFull, s, 1);
  if (lane == 0) prev = t0 > 0 ? __ldg(a.seg + t0 - 1) : 0;
  const int32_t after = t1 < a.nnz ? __ldg(a.seg + t1) : 0;

  // 2. Heads, and the heads that follow empty bags.
  const bool first = t0 + lane == 0;
  const bool head = lane < n && (first || s != prev);
  const bool gap = head && (first ? s > 0
                                  : static_cast<int64_t>(s) >
                                        static_cast<int64_t>(prev) + 1);
  const unsigned heads = __ballot_sync(kFull, head);
  const unsigned gaps = __ballot_sync(kFull, gap);

  // 3. Zero rows: the empty bags before each gap head, and after the last
  // entry (every bag when nnz = 0).
#pragma unroll 1
  for (unsigned m = gaps; m != 0; m &= m - 1) {
    const int p = __ffs(m) - 1;
    const int32_t sp = __shfl_sync(kFull, s, p);
    const int32_t pp = __shfl_sync(kFull, prev, p);
    zero_rows<T, VEC>(a, t0 + p == 0 ? 0 : static_cast<int64_t>(pp) + 1, sp,
                      lane);
  }
  const int32_t last = __shfl_sync(kFull, s, n > 0 ? n - 1 : 0);
  if (t1 == a.nnz)
    zero_rows<T, VEC>(a, n > 0 ? static_cast<int64_t>(last) + 1 : 0,
                      a.n_bags, lane);

  // 4. The owned bags: every one a single entry, or walked one by one.
  const bool open = n > 0 && t1 < a.nnz && after == last;
  const unsigned all = n == 32 ? kFull : (1u << n) - 1u;
  if (heads == all && !open) {
    walk_ones<T, VEC>(a, n, s, i, w, lane);
  } else {
#pragma unroll 1
    for (unsigned m = heads; m != 0; m &= m - 1) {
      const int h = __ffs(m) - 1;
      walk_bag<T, VEC>(a, t0, s, i, w, h, __shfl_sync(kFull, s, h), lane);
    }
  }
}

template <typename T, int VEC>
int launch(const Args<T>& a, cudaStream_t stream) {
  const int64_t tiles = a.nnz > 0 ? (a.nnz + kTile - 1) / kTile : 1;
  const int64_t grid = (tiles + kWarps - 1) / kWarps;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  embedding_bag_kernel<T, VEC>
      <<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The widest VEC that divides d and keeps every row start of the table and
// of the output aligned to VEC elements.
template <typename T>
int launch_type(const void* table, const void* idx, const void* seg,
                const void* wgt, void* out, int64_t nnz, int64_t n_bags,
                int d, cudaStream_t stream) {
  if (nnz < 0 || n_bags <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<T> a{static_cast<const T*>(table),
                  static_cast<const int32_t*>(idx),
                  static_cast<const int32_t*>(seg),
                  static_cast<const T*>(wgt),
                  static_cast<T*>(out),
                  nnz,
                  n_bags,
                  d};
  const uintptr_t base = reinterpret_cast<uintptr_t>(table) |
                         reinterpret_cast<uintptr_t>(out);
  if (d % 4 == 0 && base % (4 * sizeof(T)) == 0)
    return launch<T, 4>(a, stream);
  if (d % 2 == 0 && base % (2 * sizeof(T)) == 0)
    return launch<T, 2>(a, stream);
  return launch<T, 1>(a, stream);
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
