// intron_stats: per-intron depth statistics of all three intron subsets in
// one launch.
//
// Replaces two TPU kernels of the JAX package, as its _hist_jit
// (irfinder_tpu/ops/finalize_stats.py) composes them once per subset:
//   * irfinder_tpu/ops/gather.py:gather_window (read the clipped depth at
//     every included intron base, through a VMEM window plus a band patch),
//   * irfinder_tpu/ops/scatter.py:hist_scatter_pallas (per-intron depth
//     histogram, hist[local * CAP + depth] += 1, pre-binned by tile),
// and the per-run sums, the row cumsum and the percentile count around them.
// The plain PyTorch composition it must equal bit for bit is
// irfinder_tpu_torch/ops/finalize_stats.py:all_stats_plain.
//
// Every intron has a row in subset "both" (the int32-wrapping sum of the two
// depth planes) and, when its strand is 0 or 1, a row in its strand subset
// ("A" or "B": one plane, plane_a ^ strand).  A work item covers at most
// `chunk` consecutive included bases of one intron; a host-built item table
// (ops/finalize_stats.py:build_items) gives each item its intron, its first
// run, its row slots, its bases' count and the intron's nearest-rank targets.
// A block reads each base's word from both planes once and feeds both rows:
// two int64 sum sets (sum, nonzero count, first- and last-window sums over
// the intron-local windows [0, w) and [n - w, n), w = min(edge, n)) and two
// cap-bin int32 histograms of the clipped depth in shared memory.  Then a
// block scan over the touched bins [0, top) gives
// pk[k] = #(bins whose inclusive prefix is < ridx[k] + 1), the nearest-rank
// percentile bin; bins past `top` add cap - top when the intron's total is
// below the target.  Output: one int64 row (sum, nnz, fw, lw, pk25, pk50,
// pk75) per row slot.
//
// An intron longer than `chunk` bases is split.  Its items add their sums
// (int64 atomicAdd), their top bins (atomicMax) and their nonzero bins
// (atomicAdd) into zeroed scratch that the caller allocates, indexed by the
// intron's compact split id; the item that takes the last ticket (after a
// __threadfence) copies the merged histogram into its shared memory and
// writes the rows.  Integer atomics make the result exact in any order.
//
// What bounds it on an H100: device-memory reads of the two depth planes at
// the included bases, 8 bytes per base, and, as short introns make it, the
// instructions spent per base and per item.  Its design against that:
//   * each lane reads 8 consecutive bases per step, two 16-byte loads per
//     plane issued before any use: with 8 blocks of 128 threads per SM that
//     is 64 KB in flight per SM, more than the ~20 KB Little's law asks of
//     3.35 TB/s at ~0.6 us.  A run's ragged head and tail are read as whole
//     aligned 8-word groups and masked, so the depth rows must start
//     16-byte aligned and be readable to a multiple of 8 words (the wrapper
//     checks; ops/step.py:finalize_device pads the row stride to 8 words);
//   * one pass for all subsets: "both" and the strand row read the same
//     words once;
//   * work per run, not per base: depth is piecewise constant along the
//     genome, so a warp's 256 consecutive bases fall into few runs of equal
//     depth in both planes; the lane holding a run's first base adds, for
//     both rows, the run's length to its histogram bin (one shared
//     atomicAdd), value x length to the sum, and its overlap with the edge
//     windows to their sums;
//   * the percentile scan covers [0, top), not all cap bins (one warp scans
//     alone when top <= 32, the usual case), and a block zeroes only those
//     bins before its next item;
//   * a block fetches its next item's record while it runs the current one;
//   * persistent blocks stride over the items in genomic order, so blocks
//     at work at one time read neighbouring introns and the bases that
//     overlapping introns share come from L2 (config A: 17.0M intron bases
//     over 13.5M distinct ones).
//
// The kernel allocates nothing; the caller owns every buffer and the stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 8;  // per SM: 64 registers a thread at most
constexpr int kPerLane = 8;    // consecutive bases a lane reads per step: 2 int4 per plane
constexpr int kSpan = 32 * kPerLane;  // consecutive bases a warp reads per step
constexpr unsigned kFull = 0xffffffffu;

// Item record: kItemWords int32 words, the layout of
// ops/finalize_stats.py:ITEM_FIELDS.
constexpr int kItemWords = 16;
enum ItemField : int {
  kIntron = 0,  // intron id == its row slot in subset "both"
  kRun,         // first run of the item (index into runs_start/runs_len)
  kOff,         // offset of the item's first base inside that run
  kLoc0,        // intron-local index of the item's first base
  kCount,       // bases in the item
  kSplit,       // compact split id, or -1 for an intron that is one item
  kSlotS,       // row slot of the strand subset, or -1
  kStrand,      // 0 or 1 when kSlotS >= 0
  kN,           // the intron's included bases
  kRidx0, kRidx1, kRidx2,  // nearest-rank target indices
  kSegStart,    // MBS start of the item's first segment
  kSegLen,      // bases of the item's first segment
};

// the 8 sums of an item's two rows, in the split scratch's order
enum Sum : int { kSumB = 0, kFwB, kLwB, kSumS, kFwS, kLwS, kNzB, kNzS };
// the split scratch's int32 words per split intron
enum SplitMeta : int { kTopB = 0, kTopS, kTicket };

// A lane's share of one row's sums over the item; the window sums go
// straight to shared memory (only runs that touch an intron edge add to
// them).
struct Acc {
  long long s = 0;
  int nz = 0, top = 0;
};

__device__ __forceinline__ int clamp_bin(int v, int cap) {
  return v < 0 ? 0 : (v > cap - 1 ? cap - 1 : v);
}

// v[j] for a runtime j, by selects: an indexed register array would go to
// local memory.
__device__ __forceinline__ int pick(const int v[kPerLane], int j) {
  int x = v[0];
#pragma unroll
  for (int k = 1; k < kPerLane; ++k) x = j == k ? v[k] : x;
  return x;
}

__device__ __forceinline__ long long warp_sum64(long long x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
  return x;
}

// One warp step: base j of lane l is base kPerLane * l + j of a stretch of
// kSpan consecutive bases; x[j] and y[j] are its words in plane 0 and plane
// 1, bit j of ok is set when it lies in the run segment being read, loc is
// the intron-local index of the lane's base 0.  Depth is piecewise constant
// along the genome, so the stretch falls into few runs of equal (x, y) (a
// boundary is a change of x, of y or of ok).  The lane holding a run's first
// base accounts for the whole run at once, for both rows: "both" reads
// x + y (int32, wrapping), the strand row x or y (sy).  Per row: one shared
// atomicAdd of the run's length to the histogram, its sum and nonzero count
// to the row's Acc, and its overlap with the windows [0, w) and [n - w, n)
// to win.  All 32 lanes must call it; has_s is block-uniform.
__device__ __forceinline__ void add_runs(
    int32_t* hb, int32_t* hs, unsigned long long (*win)[2], const int x[kPerLane],
    const int y[kPerLane], unsigned ok, long long loc, long long n, long long w,
    int cap, bool sy, bool has_s, int lane, Acc& b, Acc& s) {
  const int px = __shfl_up_sync(kFull, x[kPerLane - 1], 1);
  const int py = __shfl_up_sync(kFull, y[kPerLane - 1], 1);
  const unsigned pok = (__shfl_up_sync(kFull, ok, 1) >> (kPerLane - 1)) & 1u;
  unsigned diff = (x[0] != px || y[0] != py) ? 1u : 0u;
#pragma unroll
  for (int j = 1; j < kPerLane; ++j)
    diff |= (x[j] != x[j - 1] || y[j] != y[j - 1]) ? 1u << j : 0u;
  const unsigned okm = (1u << kPerLane) - 1u;
  const unsigned prev_ok = ((ok << 1) | (lane ? pok : 0u)) & okm;
  const unsigned bnd = (ok ^ prev_ok) | (ok & diff);
  // the first boundary in a later lane ends this lane's last run
  const unsigned later = __ballot_sync(kFull, bnd != 0) & ~((2u << lane) - 1u);
  const int nl = later ? __ffs(later) - 1 : 0;
  const int nfirst = __shfl_sync(kFull, bnd ? __ffs(bnd) - 1 : 0, nl);
  const int end = later ? kPerLane * nl + nfirst : kSpan;
  unsigned m = bnd & ok;  // the runs this lane starts
  while (m) {
    const int j = __ffs(m) - 1;
    m &= m - 1;
    const unsigned above = bnd & ~((2u << j) - 1u);
    const int len = (above ? kPerLane * lane + __ffs(above) - 1 : end) - (kPerLane * lane + j);
    const int xj = pick(x, j), yj = pick(y, j);
    const long long a = loc + j, e = a + len;  // the run's intron-local bases [a, e)
    const long long fw = a < w ? (e < w ? e : w) - a : 0;
    const long long lw = e > n - w ? e - (a > n - w ? a : n - w) : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h && !has_s) break;
      // the strand-summed plane wraps in int32, as the plain version's add
      const int v = h ? (sy ? yj : xj)
                      : static_cast<int>(static_cast<unsigned>(xj) + static_cast<unsigned>(yj));
      Acc& acc = h ? s : b;
      const int bin = clamp_bin(v, cap);
      atomicAdd(&(h ? hs : hb)[bin], len);
      acc.top = max(acc.top, bin + 1);
      acc.s += static_cast<long long>(v) * len;
      acc.nz += v != 0 ? len : 0;
      if (fw) atomicAdd(&win[h][0], static_cast<unsigned long long>(v * fw));
      if (lw) atomicAdd(&win[h][1], static_cast<unsigned long long>(v * lw));
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) intron_stats_kernel(
    const int32_t* __restrict__ plane0, const int32_t* __restrict__ plane1,
    int plane_a, const int32_t* __restrict__ items, int64_t n_items,
    const int32_t* __restrict__ runs_start, const int32_t* __restrict__ runs_len,
    const int32_t* __restrict__ split_items, long long* split_sums,
    int32_t* split_hist, int32_t* split_meta, int32_t cap, int64_t edge,
    int64_t* __restrict__ out) {
  extern __shared__ int32_t hist[];  // [0, cap): "both"; [cap, 2 cap): strand row
  __shared__ unsigned long long win[2][2];  // (fw, lw) of each row
  __shared__ long long red[2][kWarps];
  __shared__ int redi[4][kWarps];
  __shared__ int wsum[2][kWarps];
  __shared__ int pkc[2][3];
  __shared__ int last;
  __shared__ int4 srec[kItemWords / 4];  // the current item's record

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int4* items4 = reinterpret_cast<const int4*>(items);
  int32_t* hb = hist;
  int32_t* hs = hist + cap;
  for (int i = tid; i < 2 * cap; i += kThreads) hist[i] = 0;
  if (tid < 4) win[tid >> 1][tid & 1] = 0;
  if (tid < kItemWords / 4 && blockIdx.x < n_items)
    srec[tid] = __ldg(items4 + blockIdx.x * (kItemWords / 4) + tid);
  __syncthreads();

  for (int64_t it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int4 q0 = srec[0], q1 = srec[1], q2 = srec[2], q3 = srec[3];
    // the next item's record, in flight while this item runs; stored to
    // srec just before the item's last barrier
    const int64_t it_next = it + gridDim.x;
    int4 next = make_int4(0, 0, 0, 0);
    if (tid < kItemWords / 4 && it_next < n_items)
      next = __ldg(items4 + it_next * (kItemWords / 4) + tid);
    const int rec[kItemWords] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w,
                                 q2.x, q2.y, q2.z, q2.w, q3.x, q3.y, q3.z, q3.w};
    const long long n = rec[kN];
    const long long w = n < edge ? n : edge;
    const bool has_s = rec[kSlotS] >= 0;
    const int strand = has_s ? (plane_a ^ rec[kStrand]) : 0;
    Acc b, s;

    // ---- stream the item's bases, run segment by run segment ----------
    long long done = 0;
    long long seg_s = rec[kSegStart];
    long long seg_n = rec[kSegLen];
    int64_t r = rec[kRun];
    const long long count = rec[kCount];
    while (done < count) {  // block-uniform
      const long long e = seg_s + seg_n;
      const long long lbase = rec[kLoc0] + done - seg_s;  // loc of MBS position p: lbase + p
      const long long g1 = (e + kPerLane - 1) / kPerLane;
      for (long long g0 = seg_s / kPerLane; g0 < g1; g0 += kThreads) {
        const long long g = g0 + tid;  // this lane's bases [8 g, 8 g + 8)
        int4 x0 = make_int4(0, 0, 0, 0), x1 = x0, y0 = x0, y1 = x0;
        if (g < g1) {
          const int4* a0 = reinterpret_cast<const int4*>(plane0) + 2 * g;
          const int4* a1 = reinterpret_cast<const int4*>(plane1) + 2 * g;
          x0 = __ldg(a0);
          x1 = __ldg(a0 + 1);
          y0 = __ldg(a1);
          y1 = __ldg(a1 + 1);
        }
        const long long p = kPerLane * g;
        const int lo = static_cast<int>(seg_s > p ? seg_s - p : 0);
        const int hi = static_cast<int>(e - p < kPerLane ? e - p : kPerLane);
        const unsigned ok = g < g1 ? ((1u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
        const int px[kPerLane] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const int py[kPerLane] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
        add_runs(hb, hs, win, px, py, ok, lbase + p, n, w, cap, strand != 0, has_s, lane, b, s);
      }
      done += seg_n;
      if (done < count) {
        ++r;
        seg_s = runs_start[r];
        const long long len = runs_len[r];
        seg_n = len < count - done ? len : count - done;
      }
    }

    // ---- block totals ---------------------------------------------------
    {
      const long long sb = warp_sum64(b.s);
      const long long ss = warp_sum64(s.s);
      const int nzb = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(b.nz)));
      const int nzs = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(s.nz)));
      const int tb = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(b.top)));
      const int ts = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(s.top)));
      if (lane == 0) {
        red[0][warp] = sb;
        red[1][warp] = ss;
        redi[0][warp] = nzb;
        redi[1][warp] = nzs;
        redi[2][warp] = tb;
        redi[3][warp] = ts;
      }
      if (tid < 6) pkc[tid / 3][tid % 3] = 0;
    }
    __syncthreads();
    int top[2] = {0, 0};
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      top[0] = max(top[0], redi[2][k]);
      top[1] = max(top[1], redi[3][k]);
    }
    if (!has_s) top[1] = 0;
    // sum c (the Sum order) of this block's item, for threads that need one
    auto block_sum = [&](int c) -> long long {
      if (c == kFwB || c == kLwB || c == kFwS || c == kLwS) {
        const int row = c >= kSumS ? 1 : 0;
        return static_cast<long long>(win[row][c - (row ? kFwS : kFwB)]);
      }
      long long t = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k)
        t += c == kSumB ? red[0][k] : c == kSumS ? red[1][k] : redi[c == kNzB ? 0 : 1][k];
      return t;
    };

    // ---- a split intron: merge into the scratch; the last item finishes --
    const int sp = rec[kSplit];
    long long* sums = nullptr;
    if (sp >= 0) {
      sums = split_sums + static_cast<int64_t>(sp) * 8;
      int32_t* sm = split_meta + static_cast<int64_t>(sp) * 4;
      int32_t* sh = split_hist + static_cast<int64_t>(sp) * 2 * cap;
      if (tid < 8)
        atomicAdd(reinterpret_cast<unsigned long long*>(sums + tid),
                  static_cast<unsigned long long>(block_sum(tid)));
      if (tid == 8) atomicMax(sm + kTopB, top[0]);
      if (tid == 9) atomicMax(sm + kTopS, top[1]);
      for (int i = tid; i < top[0]; i += kThreads)
        if (hb[i]) atomicAdd(sh + i, hb[i]);
      for (int i = tid; i < top[1]; i += kThreads)
        if (hs[i]) atomicAdd(sh + cap + i, hs[i]);
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        last = atomicAdd(sm + kTicket, 1) == split_items[sp] - 1;
        if (last) __threadfence();
      }
      __syncthreads();
      if (!last) {
        for (int i = tid; i < top[0]; i += kThreads) hb[i] = 0;
        for (int i = tid; i < top[1]; i += kThreads) hs[i] = 0;
        if (tid < 4) win[tid >> 1][tid & 1] = 0;
        if (tid < kItemWords / 4 && it_next < n_items) srec[tid] = next;
        __syncthreads();
        continue;
      }
      top[0] = __ldcg(sm + kTopB);
      top[1] = __ldcg(sm + kTopS);
      for (int i = tid; i < top[0]; i += kThreads) hb[i] = __ldcg(sh + i);
      for (int i = tid; i < top[1]; i += kThreads) hs[i] = __ldcg(sh + cap + i);
      __syncthreads();
    }

    // ---- percentile bins over [0, top) of each histogram -----------------
    const long long tgt[3] = {rec[kRidx0] + 1LL, rec[kRidx1] + 1LL, rec[kRidx2] + 1LL};
    int pk[2][3];
    if (top[0] <= 32 && top[1] <= 32) {
      // few touched bins (the usual case): warp 0 scans alone, no barrier
      if (warp == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int32_t* hh = h ? hs : hb;
          int t = lane < top[h] ? hh[lane] : 0;
          if (lane < top[h]) hh[lane] = 0;
          for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(kFull, t, o);
            if (lane >= o) t += y;
          }
#pragma unroll
          for (int k = 0; k < 3; ++k)
            pk[h][k] = __popc(__ballot_sync(kFull, lane < top[h] && t < tgt[k]));
        }
      }
    } else {
      // block scan: thread tid owns the bins [lo, hi)
      int incl[2], own[2], lo[2], hi[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int32_t* hh = h ? hs : hb;
        const int per = (top[h] + kThreads - 1) / kThreads;
        lo[h] = min(tid * per, top[h]);
        hi[h] = min(lo[h] + per, top[h]);
        int t = 0;
        for (int i = lo[h]; i < hi[h]; ++i) t += hh[i];
        own[h] = t;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, t, o);
          if (lane >= o) t += y;
        }
        incl[h] = t;
        if (lane == 31) wsum[h][warp] = t;
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int32_t* hh = h ? hs : hb;
        int run = incl[h] - own[h];
        for (int k = 0; k < warp; ++k) run += wsum[h][k];
        unsigned c0 = 0, c1 = 0, c2 = 0;
        for (int i = lo[h]; i < hi[h]; ++i) {
          run += hh[i];
          c0 += run < tgt[0];
          c1 += run < tgt[1];
          c2 += run < tgt[2];
        }
        c0 = __reduce_add_sync(kFull, c0);
        c1 = __reduce_add_sync(kFull, c1);
        c2 = __reduce_add_sync(kFull, c2);
        if (lane == 0 && top[h] > 0) {
          atomicAdd(&pkc[h][0], static_cast<int>(c0));
          atomicAdd(&pkc[h][1], static_cast<int>(c1));
          atomicAdd(&pkc[h][2], static_cast<int>(c2));
        }
      }
      __syncthreads();
      for (int i = tid; i < top[0]; i += kThreads) hb[i] = 0;
      for (int i = tid; i < top[1]; i += kThreads) hs[i] = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < 3; ++k) pk[h][k] = pkc[h][k];
    }

    // ---- rows (warp 0), then the next item's record and a barrier -------
    if (tid < 14 && (tid < 7 || has_s)) {
      const int h = tid < 7 ? 0 : 1;
      const int c = tid - 7 * h;
      long long v;
      if (c < 4) {
        // (sum, nnz, fw, lw) of row h
        const int i = c == 0 ? kSumB : c == 1 ? kNzB : c == 2 ? kFwB : kLwB;
        const int k = h ? (i == kNzB ? kNzS : i + kSumS) : i;
        v = sums ? __ldcg(sums + k) : block_sum(k);
      } else {
        // bins past top hold the intron's total: below the target they count
        const int k = c - 4;
        const long long t = k == 0 ? tgt[0] : k == 1 ? tgt[1] : tgt[2];
        const int p = h ? (k == 0 ? pk[1][0] : k == 1 ? pk[1][1] : pk[1][2])
                        : (k == 0 ? pk[0][0] : k == 1 ? pk[0][1] : pk[0][2]);
        v = p + (n < t ? cap - (h ? top[1] : top[0]) : 0);
      }
      const int64_t slot = h ? rec[kSlotS] : rec[kIntron];
      out[slot * 7 + c] = v;
      if (c == 2 || c == 3) win[h][c - 2] = 0;  // read by this thread only
    }
    if (tid < kItemWords / 4 && it_next < n_items) srec[tid] = next;
    __syncthreads();
  }
}

}  // namespace

// The largest cap the kernel launches with on the current device: its two
// histograms' dynamic shared memory may take what the per-block default of
// 48 KB leaves beside the static arrays above.  The kernel does not opt in
// to more: at the default cap of 2,048 bins it takes 16 KB.
extern "C" int intron_stats_max_cap(int32_t* cap) {
  int dev = 0, per_block = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&per_block, cudaDevAttrMaxSharedMemoryPerBlock, dev);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, intron_stats_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  size_t dyn = static_cast<size_t>(per_block) - a.sharedSizeBytes;
  if (static_cast<size_t>(a.maxDynamicSharedSizeBytes) < dyn)
    dyn = a.maxDynamicSharedSizeBytes;
  *cap = static_cast<int32_t>(dyn / (2 * sizeof(int32_t)));
  return 0;
}

// Blocks the launch uses: as many as fit on every SM at once (persistent
// blocks; block b runs items b, b + grid, ...), never more than the items.
extern "C" int intron_stats_grid(int32_t cap, int64_t n_items, int32_t* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(intron_stats_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, intron_stats_kernel, kThreads,
        static_cast<size_t>(2) * cap * sizeof(int32_t));
  if (e != cudaSuccess) return static_cast<int>(e);
  int64_t g = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<int32_t>(g < n_items ? g : n_items);
  return 0;
}

extern "C" int intron_stats_launch(
    const void* plane0, const void* plane1, int32_t plane_a, const void* items,
    int64_t n_items, const void* runs_start, const void* runs_len,
    const void* split_items, void* split_sums, void* split_hist, void* split_meta,
    int32_t cap, int64_t edge, int32_t grid, void* out, void* stream) {
  if (n_items <= 0 || grid <= 0) return 0;  // nothing to launch
  const size_t smem = static_cast<size_t>(2) * cap * sizeof(int32_t);
  intron_stats_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(plane0), static_cast<const int32_t*>(plane1),
      plane_a, static_cast<const int32_t*>(items), n_items,
      static_cast<const int32_t*>(runs_start), static_cast<const int32_t*>(runs_len),
      static_cast<const int32_t*>(split_items), static_cast<long long*>(split_sums),
      static_cast<int32_t*>(split_hist), static_cast<int32_t*>(split_meta), cap, edge,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
