// K5: embedding bag (gather table rows, weight them, sum each bag) for Hopper
// (sm_90a).
//
// K5 replaces repro/kernels/embedding_bag/kernel.py::embedding_bag_pallas
// (_bag_kernel, the pallas_call at kernel.py:61).  In the port it carries
// both table lookups of SASRec (the user's item sequence, weight sqrt(d),
// and the scored candidates, weight 1: bags of one row each), the LM's token
// lookups, the sum and mean modes of models/recsys/embedding.py, and every
// lookup's backward: K5 on the transposed bag (entries sorted by table row,
// each table row a bag, the output's gradient as the table):
//
//   out[b, :] = sum_{i : seg[i] == b} w[i] * table[idx[i], :]
//
// table (V, d) fp32 or bf16, row-major; idx, seg (nnz,) int32, seg sorted
// ascending with values in [0, n_bags); w (nnz,) of the table's type; out
// (n_bags, d) of the table's type.  Each product w[i] * table[idx[i], c] is
// taken in fp32 and added in fp32 with no fused multiply-add (__fmul_rn,
// __fadd_rn), every sum starting at 0, and the bag's sum is rounded to the
// table's type once.  An empty bag is a row of zeros, as the plain
// version's segment sum gives it (the Pallas kernel leaves such rows
// unwritten).
//
// The two orders.  A bag of at most R = kRun entries is added in nnz order:
// what the plain version (kernels/embedding_bag/ref.py::embedding_bag_ref)
// computes, so a bag of one is bit-equal to w * table[idx].  A longer bag
// is cut into runs of R consecutive entries counted from its first entry
// (the last run holds the rest); each run is added in nnz order into an
// fp32 partial, the partials of each group of G = kGroup runs in run order,
// and the groups' sums in group order.  The order depends only on the bag's
// own entries, never on where the bag lies in the arrays, so a row of a
// vocab-parallel rank's transposed bag gets the bits of the same row of the
// whole table's.  ref.py::embedding_bag_runs_ref is the plain version of
// both orders (a bag of at most R entries is one run of one group: the same
// sum).
//
// Bound: device-memory bytes.  A launch must read idx, seg and w once
// (nnz * (4 + 4 + elsize) bytes), each distinct table row once and write
// the output (n_bags * d * elsize): for SASRec's retrieval lookup (10^6
// bags of one, d = 50, fp32) 412 MB, 0.123 ms at 3.35 TB/s; for the
// backward at train_batch's pos_items (3,276,800 entries into 1,000,448
// rows, fp32, every entry a distinct row of the output's gradient) 894.8
// MB, 0.267 ms.  The arithmetic is one multiply and add per element, far
// below the card's rate.  A random 200-byte row touches 7 or 8 sectors of
// 32 bytes (224-256 bytes), so even a kernel that moves nothing else sits
// ~1.1-1.2x above that bound.
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
// at even row ids).  Every row of out is written by exactly one warp (or
// one combine block), chunk for chunk, so the result does not depend on
// the order in which warps run.  No sum uses an atomic.
//
// Long bags.  One warp walking a bag holds kAhead rows in flight, about
// 0.6 us a round trip, so a bag of n entries takes ~n / kAhead round trips
// whatever the card's width.  The transposed bag of a Zipf(1.2) lookup
// puts 586,654 of pos_items' 3,276,800 entries into table row 1, and a
// vocab-parallel rank's transposed bag ~96% of its entries into its row 0
// (every foreign id, at weight 0): the first design walked row 1 on one
// warp in 78.65 ms against embedding_dense_backward's 8.08 (one H100 80GB
// HBM3 at 700 W).  So a call may split long bags (`split`, the
// backward's choice) into two launches on the caller's stream:
//  a. The tile kernel as above, each tile also loading seg[t0 + lane + R]
//     in its first round trip: a head whose seg is still there R entries
//     on starts a long bag.  The tile adds that bag's run 0 into its
//     partial and writes no row of it.  Before the tiles (so that the
//     long runs start first), one warp a window of R entries
//     [jR, (j + 1)R): when the bag at jR began
//     earlier, the warp finds its head (a 32-way search of seg, ~5 round
//     trips), and where one of the bag's runs starts in the window, adds
//     that run (kAhead rows in flight) into its partial.  A window
//     holds at most one run start after a run 0 and at most one run 0, so
//     the partials sit at fixed slots: 2j and 2j + 1.  The window that
//     holds a long bag's last run records the bag's head and run count.
//  b. The combine, one block a window whose record names a bag: each warp
//     adds whole groups' partials in run order, then warp 0 the groups'
//     sums in order, and stores the bag's row.
// Without `split` the tile that owns a long bag walks it alone in the same
// order (runs, then groups), one launch: the forward's bags are short, and
// the split's second launch and window warps would land on every lookup
// (5.5 us at serve_p99's 25,600 bags of one).  R = 256 and G = 32, by
// measurement at pos_items and at
// the slice of the vocab-parallel rank (below): R = 128 made more partials
// for the combine (0.648 / 0.796 ms against 0.630 / 0.595), R = 512 longer
// runs (0.677 / 0.540), G = 8 a longer serial step (0.645 / 0.666, PR 32
// call 2).  A run walks kAhead = 4 rows ahead, as the tiles do: 8 and 16
// spilled and were slower (0.560 and 0.758 ms for the first kernel
// against 0.500, calls 2-3).  The windows' warps come before the tiles'
// in the grid: 7% faster than after (call 3).  The workspace (2 * ceil(nnz
// / R) partial rows of d fp32 and 2 * ceil(nnz / R) int64 records, 5.2 MB
// at pos_items) is the wrapper's.
//
// Measured (device ms by the profiler, every kernel of a call; one NVIDIA
// H100 80GB HBM3 at 700 W; tools/bag_ab.py against the parent in turns,
// PR 32 calls 5 and 8): the backward at pos_items 0.529-0.539 (the first
// kernel ~0.50, the combine ~0.04) against the one-warp walk's 77.9-78.9,
// embedding_dense_backward's 7.97 and the bound's 0.267; at the slice
// (500,224 rows, 3,160,889 of the 3,276,800 entries in row 0) 0.580-0.589
// (the combine ~0.20: one block adds the row's 12,348 partials) against
// 410-416.  The forward's cases within 3% of the parent's but pooled
// bags in bf16, 5-7% slower (see the bound, below).
//
// Offsets are int64 (idx * d passes 2^31 for tables of 10^9 rows).  Indices
// must lie in [0, V): the kernel does not check them; entries whose seg
// lies outside [0, n_bags) write nothing.  The kernel allocates nothing and
// does not synchronise: it launches on the caller's stream and returns
// cudaGetLastError().  The Python wrapper
// (repro_torch/kernels/embedding_bag/cuda.py) checks devices, types, shapes
// and contiguity before the launch, allocates the split's workspace, and
// raises on a nonzero return.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // threads per block (a tile a warp)
constexpr int kTile = 32;       // entries a tile: one a lane
constexpr int kMinBlocks = 8;   // __launch_bounds__'s blocks per SM
constexpr int kOnes = 4;        // bags of one: items a lane loads together
constexpr int kAhead = 4;       // entries whose rows a walk loads together
constexpr int kRun = 256;       // R: entries a run of a long bag
constexpr int kGroup = 32;      // G: runs a group of the combine
constexpr int kCombThreads = 256;   // threads a combine block
constexpr int kCombAhead = 16;  // partials a combine warp loads together
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads % 32 == 0 && kTile == 32, "a tile is a warp's lanes");
static_assert(kRun % kTile == 0 && kRun >= 128, "R: a multiple of 32, >= 128");

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
  float* part;     // split: partials (2 * nwin, d), else null
  int64_t* rec;    // split: heads [0, nwin) and run counts [nwin, 2 nwin)
  int64_t nnz, n_bags, nwin;
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

// The fp32 partial at workspace row `slot`, columns col .. col + VEC.
template <typename T, int VEC>
__device__ __forceinline__ Pack<float, VEC>* slot_at(const Args<T>& a,
                                                     int64_t slot, int col) {
  return reinterpret_cast<Pack<float, VEC>*>(a.part + slot * a.d + col);
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

// A walk over one bag's entries: the window of 32 entries at `base` in
// registers (lane l holds entry base + l: its seg s, idx i and weight w),
// the next entry to add at lane p (32: past the window).
struct Walk {
  int64_t base;
  int32_t s, i;
  float w;
  int p;
};

// Adds the bag's entries from the walk's place into acc (the lane's chunk c
// of VEC columns), in nnz order, at most `cap` of them, the rows of AHEAD
// entries loaded together; moves the walk past them and returns how many
// it added (0: the bag had ended).  Where the bag runs on past the window,
// the next window's entries are loaded before the rows of this one.
template <typename T, int VEC, int AHEAD>
__device__ __forceinline__ int add_run(const Args<T>& a, Walk& k,
                                       int32_t bag, int cap, int c,
                                       float (&acc)[VEC], int lane) {
  const bool on = c < a.d / VEC;
  const T* col = a.table + c * VEC;
  int added = 0;
#pragma unroll 1
  for (;;) {
    // The bag's entries in this window: [k.p, q), cut at the cap.
    const unsigned stop = __ballot_sync(
        kFull, lane >= k.p && (k.base + lane >= a.nnz || k.s != bag));
    int q = stop != 0 ? __ffs(stop) - 1 : 32;
    if (q - k.p > cap - added) q = k.p + cap - added;
    const bool more = q == 32 && k.base + 32 < a.nnz;
    int32_t ns = 0, ni = 0;
    float nw = 0.0f;
    if (more) load_entry(a, k.base + 32, lane, ns, ni, nw);
#pragma unroll 1
    for (int p = k.p; p < q; p += AHEAD) {
      Pack<T, VEC> x[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int32_t row = __shfl_sync(kFull, k.i, p + u < 32 ? p + u : 31);
        if (on && p + u < q)
          x[u] = *reinterpret_cast<const Pack<T, VEC>*>(
              col + static_cast<int64_t>(row) * a.d);
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const float wu = __shfl_sync(kFull, k.w, p + u < 32 ? p + u : 31);
        if (on && p + u < q)
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[v] = __fadd_rn(acc[v], __fmul_rn(wu, to_f(x[u].v[v])));
      }
    }
    added += q - k.p;
    if (!more) {
      k.p = q;
      return added;
    }
    k.base += 32;
    k.s = ns;
    k.i = ni;
    k.w = nw;
    k.p = 0;
    if (added == cap) return added;
  }
}

// A bag whose run 0 (acc, the lane's chunk c) filled kRun entries, walked
// on by this warp alone: each later run added from 0 in nnz order, the
// runs of a group added in run order, the groups in order, as the split
// launch's combine adds them; acc becomes the bag's sum.  A run is folded
// into its group as the next one starts (an empty one at the bag's end
// adds 0: no sum from 0 is -0, so x + 0 = x), so a bag of exactly kRun
// entries keeps run 0's bits.  The group's and the bag's sums are
// volatile, which lets the one launch fit its bound of 56 registers at
// VEC 2 with no spill (PR 32 call 5); as plain values inlined it took 64
// (call 2), and not inlined its call spilled (call 3).
template <typename T, int VEC>
__device__ __forceinline__ void walk_long(const Args<T>& a, Walk& k,
                                          int32_t bag, int c,
                                          float (&acc)[VEC], int lane) {
  volatile float grp[VEC], tot[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) grp[v] = tot[v] = 0.0f;
#pragma unroll 1
  for (int r = 1;; ++r) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float g = __fadd_rn(grp[v], acc[v]);       // run r - 1 into its group
      if (r % kGroup == 0) {                     // run r starts a group
        tot[v] = __fadd_rn(tot[v], g);
        g = 0.0f;
      }
      grp[v] = g;
      acc[v] = 0.0f;
    }
    if (add_run<T, VEC, kAhead>(a, k, bag, kRun, c, acc, lane) < kRun) break;
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v)
    acc[v] = __fadd_rn(tot[v], __fadd_rn(grp[v], acc[v]));
}

// The bag `bag`, whose head is lane h's entry of the tile at t0 ((s, i, w)
// the lane's entry), summed and stored: a lane a chunk (passes of 32
// chunks).  A bag of at most kRun entries is its run 0 (nnz order); a
// longer one goes on in runs (walk_long), except where LONG is false: in a
// split launch, which walks no bag longer than kRun here.
template <typename T, int VEC, bool LONG>
__device__ __forceinline__ void walk_bag(const Args<T>& a, int64_t t0,
                                         int32_t s, int32_t i, float w, int h,
                                         int32_t bag, int lane) {
  const int nch = a.d / VEC;
#pragma unroll 1
  for (int c0 = 0; c0 < nch; c0 += 32) {
    const int c = c0 + lane;
    Walk k{t0, s, i, w, h};
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
    if constexpr (LONG) {
      if (add_run<T, VEC, kAhead>(a, k, bag, kRun, c, acc, lane) == kRun)
        walk_long<T, VEC>(a, k, bag, c, acc, lane);
    } else {
      add_run<T, VEC, kAhead>(a, k, bag, kRun, c, acc, lane);
    }
    if (c < nch) store_row<T, VEC>(a, bag, c * VEC, acc);
  }
}

// One run of a long bag (split launch): its at most kRun entries from the
// walk `start`, added in nnz order into the partial at `slot`.
template <typename T, int VEC>
__device__ __forceinline__ void run_to_slot(const Args<T>& a,
                                            const Walk& start, int32_t bag,
                                            int64_t slot, int lane) {
  const int nch = a.d / VEC;
#pragma unroll 1
  for (int c0 = 0; c0 < nch; c0 += 32) {
    const int c = c0 + lane;
    Walk k = start;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
    add_run<T, VEC, kAhead>(a, k, bag, kRun, c, acc, lane);
    if (c < nch) {
      Pack<float, VEC> y;
#pragma unroll
      for (int v = 0; v < VEC; ++v) y.v[v] = acc[v];
      *slot_at<T, VEC>(a, slot, c * VEC) = y;
    }
  }
}

// The head of the bag `bag` that holds entry s0 and began before it: the
// least p with seg[p] >= bag, by a 32-way search (a load a lane a step).
template <typename T>
__device__ __forceinline__ int64_t bag_head(const Args<T>& a, int32_t bag,
                                            int64_t s0, int lane) {
  int64_t lo = 0, hi = s0;   // the head lies in [lo, hi]
#pragma unroll 1
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t q = lo + lane * step;
    const unsigned ge = __ballot_sync(kFull, q >= hi || __ldg(a.seg + q) >= bag);
    if (ge == 0) {
      lo += 31 * step + 1;
      continue;
    }
    const int f = __ffs(ge) - 1;
    if (f == 0) break;                           // seg[lo] >= bag
    hi = lo + f * step < hi ? lo + f * step : hi;
    lo += (f - 1) * step + 1;
  }
  return lo;
}

// Window j of a split launch, entries [jR, (j + 1)R): the run after run 0
// of a long bag that starts in it, if one does, added into slot 2j; the
// record rec[j] = the bag's head and rec[nwin + j] = its runs where that
// run is the bag's last, else rec[j] = -1.
template <typename T, int VEC>
__device__ __forceinline__ void window_run(const Args<T>& a, int64_t j,
                                           int lane) {
  const int64_t s0 = j * kRun;
  int64_t head = -1, runs = 0;
  if (j > 0) {
    const int32_t bag = __ldg(a.seg + s0);
    if (__ldg(a.seg + s0 - 1) == bag) {
      const int64_t h = bag_head(a, bag, s0, lane);
      const int64_t r = (s0 - h + kRun - 1) / kRun;
      const int64_t s1 = h + r * kRun;          // in [s0, s0 + R)
      const bool starts = s1 < a.nnz && __ldg(a.seg + s1) == bag;
      const bool on = s1 + kRun < a.nnz && __ldg(a.seg + s1 + kRun) == bag;
      if (starts) {
        Walk k;
        k.base = s1;
        k.p = 0;
        load_entry(a, s1, lane, k.s, k.i, k.w);
        run_to_slot<T, VEC>(a, k, bag, 2 * j, lane);
        if (!on) {
          head = h;
          runs = r + 1;
        }
      }
    }
  }
  if (lane == 0) {
    a.rec[j] = head;
    a.rec[a.nwin + j] = runs;
  }
}

// The one launch at VEC 1-2 is held to one block an SM more than
// kMinBlocks (56 registers at VEC 2, as PR 20's kernel took unasked): let
// go to 62 registers and 8 blocks it lost 4-5% on the lookups (PR 32 call
// 5).  The bound itself costs pooled bags in bf16 ~5%: PR 20's loop under
// it read so too, and without it the parent's time (calls 8-9).
template <typename T, int VEC, bool SPLIT>
__global__ void __launch_bounds__(kThreads, SPLIT || VEC == 4
                                                ? kMinBlocks
                                                : kMinBlocks + 1)
embedding_bag_kernel(const __grid_constant__ Args<T> a) {
  const int lane = threadIdx.x & 31;
  int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps +
                 (threadIdx.x >> 5);
  if (SPLIT) {   // the windows' warps, then the tiles' (the long runs first)
    const int64_t win_warps = (a.nwin + kWarps - 1) / kWarps * kWarps;
    if (warp < win_warps) {
      if (warp < a.nwin) window_run<T, VEC>(a, warp, lane);
      return;
    }
    warp -= win_warps;
  }
  const int64_t t0 = warp * kTile;
  if (t0 > a.nnz || (t0 == a.nnz && t0 > 0)) return;   // the whole warp
  const int64_t rest = a.nnz - t0;
  const int n = static_cast<int>(rest < kTile ? rest : kTile);
  const int64_t t1 = t0 + n;

  // 1. The tile's entries, and the seg before and after it (split: and
  // R entries on).
  int32_t s, i;
  float w;
  load_entry(a, t0, lane, s, i, w);
  int32_t prev = __shfl_up_sync(kFull, s, 1);
  if (lane == 0) prev = t0 > 0 ? __ldg(a.seg + t0 - 1) : 0;
  const int32_t after = t1 < a.nnz ? __ldg(a.seg + t1) : 0;
  const bool reach = SPLIT && t0 + lane + kRun < a.nnz;
  const int32_t far = reach ? __ldg(a.seg + t0 + lane + kRun) : 0;

  // 2. Heads, the heads that follow empty bags, and (split) those of long
  // bags.
  const bool first = t0 + lane == 0;
  const bool head = lane < n && (first || s != prev);
  const bool gap = head && (first ? s > 0
                                  : static_cast<int64_t>(s) >
                                        static_cast<int64_t>(prev) + 1);
  const unsigned heads = __ballot_sync(kFull, head);
  const unsigned gaps = __ballot_sync(kFull, gap);
  const unsigned longs = SPLIT ? __ballot_sync(kFull, head && reach &&
                                                          far == s)
                               : 0u;

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

  // 4. The owned bags: every one a single entry, or walked one by one (a
  // long bag of a split launch: its run 0 into its partial).
  const bool open = n > 0 && t1 < a.nnz && after == last;
  const unsigned all = n == 32 ? kFull : (1u << n) - 1u;
  if (heads == all && !open) {
    walk_ones<T, VEC>(a, n, s, i, w, lane);
  } else {
#pragma unroll 1
    for (unsigned m = heads; m != 0; m &= m - 1) {
      const int h = __ffs(m) - 1;
      const int32_t bag = __shfl_sync(kFull, s, h);
      if (SPLIT && (longs >> h & 1u))
        run_to_slot<T, VEC>(a, Walk{t0, s, i, w, h}, bag,
                            2 * ((t0 + h) / kRun) + 1, lane);
      else
        walk_bag<T, VEC, !SPLIT>(a, t0, s, i, w, h, bag, lane);
    }
  }
}

// acc += the partials of runs r0, r0 + dr, ... (< r1) of the long bag whose
// run 0 lies in window jh, in that order, kCombAhead loaded together.  Run
// r's partial is at slot 2 (jh + r) + (r == 0).
template <typename T, int VEC>
__device__ __forceinline__ void add_slots(const Args<T>& a, int64_t jh,
                                          int64_t r0, int64_t r1, int64_t dr,
                                          int c, bool on, float (&acc)[VEC]) {
#pragma unroll 1
  for (int64_t r = r0; r < r1; r += kCombAhead * dr) {
    Pack<float, VEC> x[kCombAhead];
#pragma unroll
    for (int u = 0; u < kCombAhead; ++u) {
      const int64_t ru = r + u * dr;
      if (on && ru < r1)
        x[u] = *slot_at<T, VEC>(a, 2 * (jh + ru) + (ru == 0), c * VEC);
    }
#pragma unroll
    for (int u = 0; u < kCombAhead; ++u)
      if (on && r + u * dr < r1)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = __fadd_rn(acc[v], x[u].v[v]);
  }
}

// The combine of a split launch: block j sums the long bag whose last run
// started in window j (rec[j] its head, rec[nwin + j] its runs, -1: none).
// Each warp adds whole groups of kGroup runs in run order and leaves each
// group's sum in the slot of its first run; after a barrier warp 0 adds the
// groups' sums in order and stores the row.
template <typename T, int VEC>
__global__ void __launch_bounds__(kCombThreads)
embedding_bag_combine(const __grid_constant__ Args<T> a) {
  const int64_t h = a.rec[blockIdx.x];
  if (h < 0) return;   // the whole block
  const int64_t runs = a.rec[a.nwin + blockIdx.x];
  const int32_t bag = __ldg(a.seg + h);
  const int64_t jh = h / kRun;
  const int64_t groups = (runs + kGroup - 1) / kGroup;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nch = a.d / VEC;
#pragma unroll 1
  for (int c0 = 0; c0 < nch; c0 += 32) {
    const int c = c0 + lane;
    const bool on = c < nch;
#pragma unroll 1
    for (int64_t g = warp; g < groups; g += kCombThreads / 32) {
      const int64_t r0 = g * kGroup;
      const int64_t r1 = r0 + kGroup < runs ? r0 + kGroup : runs;
      float acc[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
      add_slots<T, VEC>(a, jh, r0, r1, 1, c, on, acc);
      if (on) {
        Pack<float, VEC> y;
#pragma unroll
        for (int v = 0; v < VEC; ++v) y.v[v] = acc[v];
        *slot_at<T, VEC>(a, 2 * (jh + r0) + (r0 == 0), c * VEC) = y;
      }
    }
    __syncthreads();
    if (warp == 0) {
      float acc[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
      add_slots<T, VEC>(a, jh, 0, runs, kGroup, c, on, acc);
      if (on) store_row<T, VEC>(a, bag, c * VEC, acc);
    }
  }
}

template <typename T, int VEC>
int launch(const Args<T>& a, cudaStream_t stream) {
  const int64_t tiles = a.nnz > 0 ? (a.nnz + kTile - 1) / kTile : 1;
  int64_t grid = (tiles + kWarps - 1) / kWarps;
  if (a.part == nullptr) {
    if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    embedding_bag_kernel<T, VEC, false>
        <<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  grid += (a.nwin + kWarps - 1) / kWarps;
  if (grid > 0x7fffffff || a.nwin > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  embedding_bag_kernel<T, VEC, true>
      <<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(a);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || a.nwin == 0) return static_cast<int>(rc);
  embedding_bag_combine<T, VEC>
      <<<static_cast<unsigned>(a.nwin), kCombThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The widest VEC that divides d and keeps every row start of the table and
// of the output aligned to VEC elements.
template <typename T>
int launch_type(const void* table, const void* idx, const void* seg,
                const void* wgt, void* out, void* part, void* rec,
                int64_t slots, int64_t nnz, int64_t n_bags, int d,
                cudaStream_t stream) {
  if (nnz < 0 || n_bags <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nwin = (nnz + kRun - 1) / kRun;
  if ((part == nullptr) != (rec == nullptr) ||
      (part != nullptr && slots != nwin))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<T> a{static_cast<const T*>(table),
                  static_cast<const int32_t*>(idx),
                  static_cast<const int32_t*>(seg),
                  static_cast<const T*>(wgt),
                  static_cast<T*>(out),
                  static_cast<float*>(part),
                  static_cast<int64_t*>(rec),
                  nnz,
                  n_bags,
                  part != nullptr ? nwin : 0,
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
// is fp32, 1 bf16 (table, wgt and out alike).  part and rec null: one
// launch; else the split launch, with part (2 * slots, d) fp32 and rec
// (2 * slots,) int64 for slots = ceil(nnz / kRun) windows.
extern "C" int embedding_bag_fwd(const void* table, const void* idx,
                                    const void* seg, const void* wgt,
                                    void* out, void* part, void* rec,
                                    long long slots, int dtype, long long nnz,
                                    long long n_bags, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_type<float>(table, idx, seg, wgt, out, part, rec, slots,
                              nnz, n_bags, d, s);
  if (dtype == 1)
    return launch_type<uint16_t>(table, idx, seg, wgt, out, part, rec, slots,
                                 nnz, n_bags, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
