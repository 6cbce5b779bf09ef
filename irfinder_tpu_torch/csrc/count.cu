// count_blocks: the fused per-batch coverage + SpansPoint counter update.
//
// Replaces two TPU kernels of the JAX package:
//   * irfinder_tpu/ops/pallas_rank.py:block_ranks_pallas (MBS ranks of both
//     block edges and the SpansPoint rank-range diff), and
//   * irfinder_tpu/ops/scatter.py:scatter_add_pallas (the +1/-1 depth-diff
//     scatter into the flat counter array).
// The plain PyTorch composition it must equal bit for bit is
// irfinder_tpu_torch/ops/step.py:count_blocks_plain (ops/rank.py block_ranks
// followed by ops/scatter.py scatter_add).
//
// One thread per aligned block lane:
//   lo/hi  = measured-base-space rank of blk_start / blk_end, by binary search
//            over the sorted int64 (chrom << 32) + start span keys;
//   plo    = #points < (chrom, start + OH), phi = #points <= (chrom, end - OH),
//            by binary search over the sorted int64 point keys;
//   then 2 atomicAdds into the depth-diff section and 2 into the spans-diff
//   section of cnt.  Integer atomics are exact in any order, so cnt is
//   identical to the plain version whatever the schedule.
//
// What bounds it on an H100: dependent global loads in the binary searches
// (~13 steps over the 6.4k-span / 51 KB key table and ~14 over the
// 12.8k-point / 102 KB table at chr21 scale; both stay resident in the 50 MB
// L2), plus 4 scattered 4-byte atomics per block into a ~108 MB counter
// array that does not fit L2.  The design keeps every lane independent (no
// shared memory, no cross-block reduction) and lets L2 serve the searches;
// staging the keys in shared memory or a cooperative search is later work.
//
// The kernel allocates nothing; the caller owns every buffer and the stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// (chrom, coord) -> one int64 key whose order is the lexicographic order, for
// any coord in int32 range (coord may be negative: end - OH near 0).  Built
// by multiplication, never by OR, so negative coords borrow correctly.
__device__ __forceinline__ int64_t make_key(int32_t chrom, int32_t coord) {
  return static_cast<int64_t>(chrom) * (int64_t(1) << 32) +
         static_cast<int64_t>(coord);
}

// #keys < q (lower bound) over sorted keys[0, n).
__device__ __forceinline__ int64_t rank_left(const int64_t* __restrict__ keys,
                                             int64_t n, int64_t q) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// #keys <= q (upper bound) over sorted keys[0, n).
__device__ __forceinline__ int64_t rank_right(const int64_t* __restrict__ keys,
                                              int64_t n, int64_t q) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) <= q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

struct RefTables {
  const int64_t* uspan_key;   // (U+1,) sorted, last row the sentinel
  const int32_t* uspan_len;   // (U+1,)
  const int32_t* uspan_off;   // (U+1,) sentinel row holds the real mbs
  int64_t n_uspan;            // U+1
  const int32_t* chrom_base;  // (n_chroms,) MBS offset of each chrom's first span
  int64_t n_chroms;
  const int64_t* point_key;   // (P+1,) sorted, last row the sentinel
  int64_t n_point;            // P+1
};

// Number of measured bases on `chrom` strictly before `pos` (chrom >= 0).
// Same cases as ops/device_ref.py:mbs_rank: inside or after a span of the same
// chrom -> that span's offset + clipped distance; otherwise the chrom's base
// offset, or the real mbs for a chrom id past the table.
__device__ __forceinline__ int64_t mbs_rank(const RefTables& t, int32_t chrom,
                                            int32_t pos) {
  const int64_t q = make_key(chrom, pos);
  const int64_t j = rank_right(t.uspan_key, t.n_uspan, q) - 1;
  if (j >= 0) {
    const int64_t kj = __ldg(t.uspan_key + j);
    if ((kj >> 32) == chrom) {
      int64_t within = static_cast<int64_t>(pos) - (kj - make_key(chrom, 0));
      const int64_t len = __ldg(t.uspan_len + j);
      within = within < 0 ? 0 : (within > len ? len : within);
      return static_cast<int64_t>(__ldg(t.uspan_off + j)) + within;
    }
  }
  if (chrom < t.n_chroms) return __ldg(t.chrom_base + chrom);
  return __ldg(t.uspan_off + (t.n_uspan - 1));
}

__global__ void count_blocks_kernel(
    const int32_t* __restrict__ blk_chrom, const int32_t* __restrict__ blk_start,
    const int32_t* __restrict__ blk_end, const int32_t* __restrict__ blk_strand,
    int64_t n_blocks, RefTables t, int32_t overhang, int32_t* __restrict__ cnt,
    int64_t off_dd, int64_t w_dd, int64_t off_p, int64_t w_p) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_blocks; i += stride) {
    const int32_t c = blk_chrom[i];
    // Pad lanes (chrom < 0): the reference adds +1 and -1 at the same trash
    // slot (rank mbs on the depth row, slot P on the spans row), which nets to
    // zero, so skipping the lane leaves cnt identical.
    if (c < 0) continue;
    const int32_t s = blk_start[i];
    const int32_t e = blk_end[i];
    const int64_t strand = blk_strand[i];

    const int64_t dd = off_dd + strand * w_dd;
    atomicAdd(cnt + dd + mbs_rank(t, c, s), 1);
    atomicAdd(cnt + dd + mbs_rank(t, c, e), -1);

    // int32 arithmetic as in the reference step (wraps the same way)
    const int32_t qs = static_cast<int32_t>(static_cast<uint32_t>(s) + static_cast<uint32_t>(overhang));
    const int32_t qe = static_cast<int32_t>(static_cast<uint32_t>(e) - static_cast<uint32_t>(overhang));
    const int32_t len = static_cast<int32_t>(static_cast<uint32_t>(e) - static_cast<uint32_t>(s));
    // A block shorter than 2*OH goes to trash slot P twice (+1, -1): net zero,
    // so it is skipped here as well.
    if (len < 2 * overhang) continue;
    const int64_t pb = off_p + strand * w_p;
    atomicAdd(cnt + pb + rank_left(t.point_key, t.n_point, make_key(c, qs)), 1);
    atomicAdd(cnt + pb + rank_right(t.point_key, t.n_point, make_key(c, qe)), -1);
  }
}

}  // namespace

extern "C" int count_blocks_launch(
    const void* blk_chrom, const void* blk_start, const void* blk_end,
    const void* blk_strand, int64_t n_blocks,
    const void* uspan_key, const void* uspan_len, const void* uspan_off,
    int64_t n_uspan, const void* chrom_base, int64_t n_chroms,
    const void* point_key, int64_t n_point, int32_t overhang, void* cnt,
    int64_t off_dd, int64_t w_dd, int64_t off_p, int64_t w_p, void* stream) {
  RefTables t;
  t.uspan_key = static_cast<const int64_t*>(uspan_key);
  t.uspan_len = static_cast<const int32_t*>(uspan_len);
  t.uspan_off = static_cast<const int32_t*>(uspan_off);
  t.n_uspan = n_uspan;
  t.chrom_base = static_cast<const int32_t*>(chrom_base);
  t.n_chroms = n_chroms;
  t.point_key = static_cast<const int64_t*>(point_key);
  t.n_point = n_point;
  const int threads = 256;
  int64_t blocks = (n_blocks + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;  // grid-stride loop covers the rest
  if (blocks < 1) blocks = 1;
  count_blocks_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(blk_chrom), static_cast<const int32_t*>(blk_start),
      static_cast<const int32_t*>(blk_end), static_cast<const int32_t*>(blk_strand),
      n_blocks, t, overhang, static_cast<int32_t*>(cnt), off_dd, w_dd, off_p, w_p);
  return static_cast<int>(cudaGetLastError());
}
