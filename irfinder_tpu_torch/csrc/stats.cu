// intron_stats: per-intron depth statistics of one intron subset, one pass.
//
// Replaces two TPU kernels of the JAX package, as its _hist_jit
// (irfinder_tpu/ops/finalize_stats.py) composes them:
//   * irfinder_tpu/ops/gather.py:gather_window (read the clipped depth at
//     every included intron base, through a VMEM window plus a band patch),
//   * irfinder_tpu/ops/scatter.py:hist_scatter_pallas (per-intron depth
//     histogram, hist[local * CAP + depth] += 1, pre-binned by tile),
// and the per-run sums, the row cumsum and the percentile count around them.
// The plain PyTorch composition it must equal bit for bit is
// irfinder_tpu_torch/ops/finalize_stats.py:intron_stats_plain.
//
// One CTA of 256 threads per subset intron.  The threads walk the intron's
// runs in genomic order and read each run's depth words coalesced (for the
// strand-summed subset both planes, added in registers: no (mbs,) temporary).
// Each thread accumulates, as int64, the depth sum, the nonzero count and the
// sums over the intron-local windows [0, w) and [n - w, n), w = min(edge, n),
// and adds each base to a cap-bin int32 histogram in shared memory
// (8 KB at cap 2048).  A warp adds equal bins once, with the count of lanes
// that share it (__match_any_sync), so long runs of equal depth do not
// serialise on one shared address.  Then: a block reduction of the four sums,
// a block scan of the histogram, and pk[k] = #(bins whose inclusive prefix is
// < ridx[k] + 1), the nearest-rank percentile bin.  ridx comes from the host:
// no float ceil on the card.  Output: one int64 row
// (sum, nnz, fw, lw, pk25, pk50, pk75) per intron.
//
// What bounds it on an H100: device-memory reads of the depth plane(s), one
// (two for "both") 4-byte word per included base.  At the chr21-scale config
// (7,200 introns, 17.0M included bases) "both" reads 34.0M words and "A" and
// "B" 17.0M together: ~51M words, ~204 MB, ~61 us at 3.35 TB/s.  The kernel
// does no other global traffic but the tiny run table and one 56-byte row per
// intron.  Introns are uneven
// (tens of bases to ~100 kb): one CTA per intron leaves the long ones on a
// few SMs at the tail; splitting them across CTAs is later work.
//
// The kernel allocates nothing; the caller owns every buffer and the stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// The depth the subset reads at MBS position i: plane 0, plane 1, or (sel 2)
// their int32 sum, wrapping as the plain version's int32 add does.
__device__ __forceinline__ int32_t depth_at(const int32_t* __restrict__ p0,
                                            const int32_t* __restrict__ p1,
                                            int sel, int64_t i) {
  if (sel == 0) return p0[i];
  if (sel == 1) return p1[i];
  return static_cast<int32_t>(static_cast<uint32_t>(p0[i]) +
                              static_cast<uint32_t>(p1[i]));
}

__device__ __forceinline__ long long warp_sum(long long x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
  return x;
}

__global__ void __launch_bounds__(kThreads) intron_stats_kernel(
    const int32_t* __restrict__ plane0, const int32_t* __restrict__ plane1,
    int sel, const int64_t* __restrict__ run_off,
    const int32_t* __restrict__ runs_start, const int32_t* __restrict__ runs_len,
    const int64_t* __restrict__ n_bases, const int64_t* __restrict__ ridx,
    int64_t n_sub, int32_t cap, int64_t edge, int64_t* __restrict__ out) {
  extern __shared__ int32_t hist[];  // cap bins
  __shared__ long long red[4][kWarps];
  __shared__ int32_t wscan[kWarps];
  __shared__ int32_t pk[3];

  const int64_t i = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int b = tid; b < cap; b += kThreads) hist[b] = 0;
  if (tid < 3) pk[tid] = 0;
  __syncthreads();

  const int64_t n = n_bases[i];
  const int64_t w = n < edge ? n : edge;
  long long s = 0, nz = 0, fw = 0, lw = 0;
  int64_t b0 = 0;  // intron-local offset of the current run's first base
  const int64_t r_end = run_off[i + 1];
  for (int64_t r = run_off[i]; r < r_end; ++r) {
    const int64_t start = runs_start[r];
    const int64_t len = runs_len[r];
    // the trip count is the same for every thread of the block, so each
    // warp reaches the warp-wide intrinsics below converged
    for (int64_t t0 = 0; t0 < len; t0 += kThreads) {
      const int64_t t = t0 + tid;
      const bool ok = t < len;
      int32_t v = 0;
      if (ok) {
        v = depth_at(plane0, plane1, sel, start + t);
        const int64_t loc = b0 + t;
        s += v;
        nz += (v != 0);
        if (loc < w) fw += v;
        if (loc >= n - w) lw += v;
      }
      const int32_t bin = v < 0 ? 0 : (v > cap - 1 ? cap - 1 : v);
      const unsigned act = __ballot_sync(kFull, ok);
      if (ok) {
        const unsigned peers = __match_any_sync(act, bin);
        if (lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
      }
    }
    b0 += len;
  }

  s = warp_sum(s);
  nz = warp_sum(nz);
  fw = warp_sum(fw);
  lw = warp_sum(lw);
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = nz;
    red[2][warp] = fw;
    red[3][warp] = lw;
  }
  __syncthreads();  // also publishes the finished histogram

  // block scan: thread tid owns bins [lo, hi), consecutive
  const int per = (cap + kThreads - 1) / kThreads;
  const int lo = tid * per < cap ? tid * per : cap;
  const int hi = lo + per < cap ? lo + per : cap;
  int32_t tot = 0;
  for (int b = lo; b < hi; ++b) tot += hist[b];
  int32_t incl = tot;  // inclusive warp scan of the per-thread totals
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wscan[warp] = incl;
  __syncthreads();
  int32_t run = incl - tot;  // bases in bins before lo
  for (int k = 0; k < warp; ++k) run += wscan[k];
  const int64_t tgt0 = ridx[i] + 1;
  const int64_t tgt1 = ridx[n_sub + i] + 1;
  const int64_t tgt2 = ridx[2 * n_sub + i] + 1;
  int c0 = 0, c1 = 0, c2 = 0;
  for (int b = lo; b < hi; ++b) {
    run += hist[b];
    c0 += run < tgt0;
    c1 += run < tgt1;
    c2 += run < tgt2;
  }
  for (int o = 16; o > 0; o >>= 1) {
    c0 += __shfl_down_sync(kFull, c0, o);
    c1 += __shfl_down_sync(kFull, c1, o);
    c2 += __shfl_down_sync(kFull, c2, o);
  }
  if (lane == 0) {
    atomicAdd(&pk[0], c0);
    atomicAdd(&pk[1], c1);
    atomicAdd(&pk[2], c2);
  }
  __syncthreads();

  if (tid == 0) {
    long long tot4[4] = {0, 0, 0, 0};
    for (int k = 0; k < kWarps; ++k)
      for (int c = 0; c < 4; ++c) tot4[c] += red[c][k];
    int64_t* row = out + i * 7;
    for (int c = 0; c < 4; ++c) row[c] = tot4[c];
    for (int k = 0; k < 3; ++k) row[4 + k] = pk[k];
  }
}

}  // namespace

// The largest cap the kernel launches with on the current device: the
// histogram's dynamic shared memory may take what the per-block limit (48 KB
// without opting in to more) leaves beside the static arrays above.
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
  *cap = static_cast<int32_t>(dyn / sizeof(int32_t));
  return 0;
}

extern "C" int intron_stats_launch(
    const void* plane0, const void* plane1, int32_t sel, const void* run_off,
    const void* runs_start, const void* runs_len, const void* n_bases,
    const void* ridx, int64_t n_sub, int32_t cap, int64_t edge, void* out,
    void* stream) {
  if (n_sub <= 0) return 0;  // an empty subset launches nothing
  const size_t smem = static_cast<size_t>(cap) * sizeof(int32_t);
  intron_stats_kernel<<<static_cast<unsigned>(n_sub), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(plane0), static_cast<const int32_t*>(plane1),
      sel, static_cast<const int64_t*>(run_off),
      static_cast<const int32_t*>(runs_start),
      static_cast<const int32_t*>(runs_len),
      static_cast<const int64_t*>(n_bases), static_cast<const int64_t*>(ridx),
      n_sub, cap, edge, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
