// count_step: the device work of one batch's counting step in one launch.
//
// Replaces two TPU kernels of the JAX package:
//   * irfinder_tpu/ops/pallas_rank.py:block_ranks_pallas (MBS ranks of both
//     block edges and the SpansPoint rank-range diff), and
//   * irfinder_tpu/ops/scatter.py:scatter_add_pallas (the +1/-1 depth-diff
//     scatter into the flat counter array),
// and folds in the fragment tallies the JAX step leaves to plain XLA ops
// (irfinder_tpu/ops/step.py: FragmentsInChr, FragmentsInROI, the fragment
// total).  The plain PyTorch composition it must equal bit for bit is
// irfinder_tpu_torch/ops/step.py:count_step_plain.
//
// Block lanes (one per aligned block):
//   lo/hi  = measured-base-space rank of blk_start / blk_end: the last span
//            whose key is <= (chrom, pos), then its (len, off) record;
//   plo    = #points < (chrom, start + OH), phi = #points <= (chrom, end - OH);
//   then +1/-1 at lo/hi in the depth-diff section of cnt and at plo/phi in
//   the spans-diff section.  A pair whose two slots are equal adds +1 and -1
//   to one word: it is skipped, as are pad lanes (chrom < 0) and blocks
//   shorter than 2*OH, which the plain version sends to one trash slot twice.
// Fragment lanes (one per fragment row):
//   chr[rid] += 1 (rid = frag_refid in [0, n_refids), else the trash slot
//   n_refids), one add per distinct rid in the warp (__match_any_sync); the
//   ROI rows' overlap counts per strand (0 and 1; any other strand counts in
//   neither), one ballot per row and strand; the fragment total
//   (frag_refid >= 0), one warp reduction.  The warps add into the block's
//   tallies in shared memory, and the block adds each nonzero tally to
//   global memory once: with one reference sequence every fragment of a
//   batch tallies into one chr word, and one add per warp on it (1,024 a
//   batch) serialises in L2.
// Integer adds commute, so cnt and chr equal the plain version's in any
// order of the adds.
//
// What bounds it on an H100.  One batch is ~98k block lanes: one wave of one
// lane per thread, so the time is one lane's chain of dependent loads plus
// the instructions of ~100 lanes per SM, then the drain of the adds.  The
// ranks of a lane come from a static B+-tree per key table
// (ops/device_ref.py:search_tree, nodes of 16 int64 keys = one 128-byte
// line):
//   * one level of each tree, the deepest of at most kStageKeys keys, is
//     staged in shared memory once per block (one block per SM, grid = SM
//     count, lanes strided over the blocks warp by warp) and binary-searched
//     there with a fixed number of halvings: no global load;
//   * each level below it is one node: four 8-byte loads of the sector
//     maxima (keys 3, 7, 11, 15: one line, one trip to L2), then the sector's
//     first three keys (an L1 hit).  Config A's tables (6.4k spans, 12.8k
//     points) stage their level 1, so a search reads one line from L2; a
//     whole-genome table stages level 2 and reads two;
//   * a lane searches twice, ub(start) over the spans and lb(start + OH)
//     over the points, the two in lockstep so that the loads of a level
//     issue together; ub(end) and ub(end - OH) walk on from those ranks over
//     level 0 (two keys, an L1 hit: a block is short beside the gaps between
//     keys), and only a walk that the two keys leave undecided searches in
//     full.  On the card this was faster than four searches in lockstep:
//     the searches' instructions and leaf lines were most of the time;
//   * a span's (len, off) is one 8-byte record, loaded beside the span's key;
//   * the adds are fire-and-forget (red), their results never read.
// What it does not fix: the shared-memory halvings (~10 per search in
// config A) are still the most instructions, and the adds go to a counter
// array (108 MB in config A) far larger than L2, so most miss it.
//
// The kernel allocates nothing; the caller owns every buffer and the stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFan = 16;              // keys per node: ops/device_ref.py FANOUT, checked at launch
constexpr int kThreads = 768;         // one block per SM covers ~100k lanes
constexpr int kMaxBelow = 8;          // tree levels below the staged one
constexpr int64_t kStageKeys = 1280;  // staged keys per tree: 10 KB

// (chrom, coord) -> one int64 key whose order is the lexicographic order, for
// any coord in int32 range (coord may be negative: end - OH near 0).  Built
// by multiplication, never by OR, so negative coords borrow correctly.
__device__ __forceinline__ int64_t make_key(int32_t chrom, int32_t coord) {
  return static_cast<int64_t>(chrom) * (int64_t(1) << 32) +
         static_cast<int64_t>(coord);
}

// 1 if key k lies before query q: k < q for a lower bound, k <= q for an
// upper bound.
__device__ __forceinline__ int32_t before(int64_t k, int64_t q, bool right) {
  return right ? (k <= q) : (k < q);
}

__device__ __forceinline__ void red_add(int32_t* p, int32_t v) {
  asm volatile("red.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// One search tree as the kernel reads it.
struct Tree {
  const int64_t* keys;           // all levels, root first
  int64_t staged_off;            // the staged level: offset in keys and size
  int32_t staged_n;
  int32_t n_below;               // levels below it; the last is level 0
  int64_t n0;                    // keys in level 0
  int64_t below_off[kMaxBelow];  // their offsets in keys
};

struct Args {
  const int32_t* blk_chrom; const int32_t* blk_start;
  const int32_t* blk_end; const int32_t* blk_strand;
  int64_t n_blocks;
  const int32_t* frag_chrom; const int32_t* frag_refid;
  const int32_t* frag_start; const int32_t* frag_end;
  const int32_t* frag_strand;
  int64_t n_frags;
  Tree span, point;
  const int2* uspan_rec;         // (U+1) x (len, off); [U].off is mbs
  int64_t n_uspan;
  const int32_t* chrom_base;     // (n_chroms,) MBS offset of each chrom's first span
  int64_t n_chroms;
  const int32_t* roi_chrom; const int32_t* roi_start; const int32_t* roi_end;
  int32_t n_roi;                 // R, the sentinel row excluded
  int32_t overhang;
  int32_t* cnt;
  int64_t off_dd, w_dd, off_p, w_p, off_roi, off_nf;
  int32_t* chr;
  int32_t n_refids;
};

// One search of a block lane: its query, its side, and its rank so far.
struct Search {
  int64_t q;
  bool right;
  int32_t rank;
};

// One node step of the searches that run (U0: the span search s[0], U1: the
// point search s[1]) at the level `lvl` of their trees: each rank becomes the
// rank among that level's keys.  All loads of a step issue before any use.
template <bool U0, bool U1>
__device__ __forceinline__ void node_step(const int64_t* const (&lvl)[2], Search (&s)[2]) {
  constexpr bool use[2] = {U0, U1};
  int64_t m[2][kFan / 4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!use[i]) continue;
    const int64_t* b = lvl[i] + s[i].rank * kFan;
#pragma unroll
    for (int t = 0; t < kFan / 4; ++t) m[i][t] = __ldg(b + 4 * t + 3);
  }
  int64_t k[2][3];
  int32_t sec[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!use[i]) continue;
    sec[i] = 0;
#pragma unroll
    for (int t = 0; t < kFan / 4; ++t) sec[i] += before(m[i][t], s[i].q, s[i].right);
    const int64_t* f = lvl[i] + s[i].rank * kFan + 4 * sec[i];
    const longlong2 k01 = __ldg(reinterpret_cast<const longlong2*>(f));
    k[i][0] = k01.x;
    k[i][1] = k01.y;
    k[i][2] = __ldg(f + 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!use[i]) continue;
    s[i].rank = s[i].rank * kFan + 4 * sec[i] + before(k[i][0], s[i].q, s[i].right) +
                before(k[i][1], s[i].q, s[i].right) + before(k[i][2], s[i].q, s[i].right);
  }
}

__device__ __forceinline__ const int64_t* below_level(const Tree& t, int l) {
  return t.keys + t.below_off[l];
}

// The measured bases on `chrom` (>= 0) strictly before `pos`, from the last
// span whose key is <= (chrom, pos): its key kj and record rec (`found`
// false when there is none) (ops/device_ref.py:mbs_rank): inside or after a
// span of the same chrom -> that span's offset + clipped distance; otherwise
// `base`, the chrom's base offset, or mbs past the chrom table.
__device__ __forceinline__ int64_t mbs_from(int64_t kj, int2 rec, bool found,
                                           int32_t chrom, int32_t pos, int64_t base) {
  if (found && (kj >> 32) == chrom) {
    int64_t within = static_cast<int64_t>(pos) - (kj - make_key(chrom, 0));
    within = within < 0 ? 0 : (within > rec.x ? rec.x : within);
    return static_cast<int64_t>(rec.y) + within;
  }
  return base;
}

struct BlockLane { int32_t c, s, e, st; };
struct FragLane { int32_t c, rid, s, e, st; };

__device__ __forceinline__ BlockLane load_block(const Args& a, int64_t i) {
  if (i >= a.n_blocks) return {-1, 0, 0, 0};
  return {a.blk_chrom[i], a.blk_start[i], a.blk_end[i], a.blk_strand[i]};
}

__device__ __forceinline__ FragLane load_frag(const Args& a, int64_t f) {
  if (f >= a.n_frags) return {-1, -1, 0, 0, -1};
  return {a.frag_chrom[f], a.frag_refid[f], a.frag_start[f], a.frag_end[f], a.frag_strand[f]};
}

// The ranks of the searches that run (U0: s[0] over the span tree, U1: s[1]
// over the point tree), in lockstep: the staged levels by a fixed number of
// halvings, then one node per level below, the deeper tree alone first.
template <bool U0, bool U1>
__device__ __forceinline__ void tree_rank(const Args& a, const int64_t* const (&staged)[2],
                                          Search (&s)[2]) {
  constexpr bool use[2] = {U0, U1};
  int32_t lo[2] = {0, 0};
  int32_t n[2] = {U0 ? a.span.staged_n : 1, U1 ? a.point.staged_n : 1};
  while (n[0] > 1 || n[1] > 1) {  // the same count in every thread
    // branch-free: a tree done halving (h = 0) reads its current key again
    int32_t h[2];
    int64_t k[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      h[i] = n[i] >> 1;
      if (use[i]) k[i] = staged[i][lo[i] + (h[i] > 0 ? h[i] - 1 : 0)];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (use[i]) lo[i] += before(k[i], s[i].q, s[i].right) ? h[i] : 0;
      n[i] -= h[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (use[i]) s[i].rank = lo[i] + before(staged[i][lo[i]], s[i].q, s[i].right);

  const int32_t b0 = U0 ? a.span.n_below : 0, b1 = U1 ? a.point.n_below : 0;
  const int32_t both = b0 < b1 ? b0 : b1;
  const int64_t* lvl[2];
  for (int32_t l = 0; l < b0 - both; ++l) {
    lvl[0] = below_level(a.span, l);
    node_step<true, false>(lvl, s);
  }
  for (int32_t l = 0; l < b1 - both; ++l) {
    lvl[1] = below_level(a.point, l);
    node_step<false, true>(lvl, s);
  }
  for (int32_t l = 0; l < both; ++l) {
    lvl[0] = below_level(a.span, b0 - both + l);
    lvl[1] = below_level(a.point, b1 - both + l);
    node_step<true, true>(lvl, s);
  }
}

__device__ __forceinline__ const int64_t* level0(const Tree& t) {
  return t.keys + (t.n_below ? t.below_off[t.n_below - 1] : t.staged_off);
}

// The rank of `q` among the level-0 keys of `t`, walked on from `from`, the
// rank of a query no greater than q: the two keys there decide it unless
// both lie before q.  Returns -1 when undecided.
__device__ __forceinline__ int32_t walk(const Tree& t, int32_t from, int64_t q, bool right) {
  const int64_t* k = level0(t);
  const int64_t k0 = __ldg(k + from);
  const int64_t k1 = __ldg(k + (from + 1 < t.n0 ? from + 1 : from));  // [n0 - 1] is INT64_MAX
  if (before(k1, q, right)) return -1;
  return from + before(k0, q, right);
}

__device__ void block_lane(const Args& a, const int64_t* const (&staged)[2], BlockLane l) {
  const int32_t c = l.c;
  // int32 arithmetic as in the reference step (wraps the same way)
  const int32_t qs = static_cast<int32_t>(static_cast<uint32_t>(l.s) + static_cast<uint32_t>(a.overhang));
  const int32_t qe = static_cast<int32_t>(static_cast<uint32_t>(l.e) - static_cast<uint32_t>(a.overhang));
  const int32_t len = static_cast<int32_t>(static_cast<uint32_t>(l.e) - static_cast<uint32_t>(l.s));
  const bool points = len >= 2 * a.overhang;

  // the chrom's base rank, for an edge outside every span of its chrom
  int64_t base;
  if (c < a.n_chroms) base = __ldg(a.chrom_base + c);
  else base = __ldg(&a.uspan_rec[a.n_uspan - 1].y);

  // two searches in lockstep: ub(start) over the span keys, lb(start + OH)
  // over the point keys
  Search s[2] = {{make_key(c, l.s), true, 0}, {make_key(c, qs), false, 0}};
  tree_rank<true, true>(a, staged, s);
  // the other two ranks walk on from them: ub(end) >= ub(start) for
  // end >= start, and ub(end - OH) >= lb(start + OH) for end - OH >=
  // start + OH; an undecided walk, or a pair out of order, searches in full
  Search t[2] = {{make_key(c, l.e), true, 0}, {make_key(c, qe), true, 0}};
  int32_t hi = t[0].q >= s[0].q ? walk(a.span, s[0].rank, t[0].q, true) : -1;
  int32_t phi = !points ? s[1].rank
                : t[1].q >= s[1].q ? walk(a.point, s[1].rank, t[1].q, true) : -1;
  if (hi < 0 && phi < 0) tree_rank<true, true>(a, staged, t);
  else if (hi < 0) tree_rank<true, false>(a, staged, t);
  else if (phi < 0) tree_rank<false, true>(a, staged, t);
  if (hi < 0) hi = t[0].rank;
  if (phi < 0) phi = t[1].rank;

  // the span before each edge: its key (in the leaf line just read) and its
  // record, both edges' loads in flight together
  const int64_t* span0 = level0(a.span);
  const int32_t j0 = s[0].rank - 1, j1 = hi - 1;
  const int64_t k0 = __ldg(span0 + (j0 < 0 ? 0 : j0));
  const int64_t k1 = __ldg(span0 + (j1 < 0 ? 0 : j1));
  const int2 r0 = __ldg(a.uspan_rec + (j0 < 0 ? 0 : j0));
  const int2 r1 = __ldg(a.uspan_rec + (j1 < 0 ? 0 : j1));
  const int64_t lo_rank = mbs_from(k0, r0, j0 >= 0, c, l.s, base);
  const int64_t hi_rank = mbs_from(k1, r1, j1 >= 0, c, l.e, base);

  const int64_t strand = l.st;
  if (lo_rank != hi_rank) {
    int32_t* dd = a.cnt + a.off_dd + strand * a.w_dd;
    red_add(dd + lo_rank, 1);
    red_add(dd + hi_rank, -1);
  }
  if (points && s[1].rank != phi) {
    int32_t* pb = a.cnt + a.off_p + strand * a.w_p;
    red_add(pb + s[1].rank, 1);
    red_add(pb + phi, -1);
  }
}

// The block's fragment tallies in shared memory: the first kTallyChr chr
// slots, the first kTallyRoi ROI rows of each strand, and the admitted
// fragments.  Slots past them go to global memory a warp at a time.
constexpr int kTallyChr = 256;
constexpr int kTallyRoi = 64;
constexpr int kTally = kTallyChr + 2 * kTallyRoi + 1;

__device__ __forceinline__ void tally_add(int32_t* tally, int t, bool shared, int32_t* global,
                                          int32_t v) {
  if (shared) atomicAdd(tally + t, v);
  else red_add(global, v);
}

// One warp's 32 fragment rows (lanes past n_frags hold `valid` false).
__device__ void frag_warp(const Args& a, FragLane f, bool valid, int32_t* tally) {
  const unsigned lane = threadIdx.x & 31;
  // FragmentsInChr: one add per distinct slot in the warp
  const int32_t slot = !valid ? -1
                       : (f.rid >= 0 && f.rid < a.n_refids) ? f.rid : a.n_refids;
  const unsigned peers = __match_any_sync(0xffffffffu, slot);
  if (slot >= 0 && lane == static_cast<unsigned>(__ffs(peers) - 1))
    tally_add(tally, slot, slot < kTallyChr, a.chr + slot, __popc(peers));
  // FragmentsInROI: one ballot per row and strand
  for (int32_t r = 0; r < a.n_roi; ++r) {
    const bool ov = valid && f.c == __ldg(a.roi_chrom + r) && __ldg(a.roi_start + r) < f.e &&
                    f.s < __ldg(a.roi_end + r);
    const unsigned b0 = __ballot_sync(0xffffffffu, ov && f.st == 0);
    const unsigned b1 = __ballot_sync(0xffffffffu, ov && f.st == 1);
    if (lane == 0 && b0)
      tally_add(tally, kTallyChr + r, r < kTallyRoi, a.cnt + a.off_roi + r, __popc(b0));
    if (lane == 0 && b1)
      tally_add(tally, kTallyChr + kTallyRoi + r, r < kTallyRoi,
                a.cnt + a.off_roi + a.n_roi + 1 + r, __popc(b1));
  }
  // the fragment total
  const int32_t admitted = __reduce_add_sync(0xffffffffu, valid && f.rid >= 0);
  if (lane == 0 && admitted) atomicAdd(tally + kTally - 1, admitted);
}

__global__ void __launch_bounds__(kThreads, 1) count_step_kernel(const Args a) {
  extern __shared__ longlong2 staged[];  // 16-byte aligned
  __shared__ int32_t tally[kTally];
  const int32_t ns = a.span.staged_n, np = a.point.staged_n;
  const int64_t* const levels[2] = {reinterpret_cast<const int64_t*>(staged),
                                    reinterpret_cast<const int64_t*>(staged) + ns};

  // lanes go to the blocks a warp at a time, so the real lanes at the front
  // of a batch spread over every SM
  const int64_t warp = static_cast<int64_t>(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  const int64_t first = warp * 32 + (threadIdx.x & 31);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;

  // the first lanes' columns are in flight while the tree levels are staged
  BlockLane bl = load_block(a, first);
  FragLane fl = load_frag(a, first);
  for (int32_t w = threadIdx.x; w < (ns + np) / 2; w += blockDim.x) {
    const bool is_span = w < ns / 2;
    const longlong2* src = reinterpret_cast<const longlong2*>(
        is_span ? a.span.keys + a.span.staged_off : a.point.keys + a.point.staged_off);
    staged[w] = __ldg(src + (is_span ? w : w - ns / 2));
  }
  for (int t = threadIdx.x; t < kTally; t += blockDim.x) tally[t] = 0;
  __syncthreads();

  // the fragments first: on the card this order measured faster than the
  // block lanes first
  for (int64_t w0 = warp * 32; w0 < a.n_frags; w0 += stride) {  // whole warps
    const FragLane cur = fl;
    fl = load_frag(a, first + (w0 - warp * 32) + stride);
    frag_warp(a, cur, w0 + (threadIdx.x & 31) < a.n_frags, tally);
  }
  for (int64_t i = first; i < a.n_blocks; i += stride) {
    const BlockLane cur = bl;
    bl = load_block(a, i + stride);
    if (cur.c >= 0) block_lane(a, levels, cur);
  }

  // the block's tallies: one add per nonzero slot
  __syncthreads();
  for (int t = threadIdx.x; t < kTally; t += blockDim.x) {
    const int32_t v = tally[t];
    if (v == 0) continue;
    if (t < kTallyChr) red_add(a.chr + t, v);
    else if (t < kTallyChr + kTallyRoi) red_add(a.cnt + a.off_roi + (t - kTallyChr), v);
    else if (t < kTally - 1) red_add(a.cnt + a.off_roi + a.n_roi + 1 + (t - kTallyChr - kTallyRoi), v);
    else red_add(a.cnt + a.off_nf, v);
  }
}

// The tree as the kernel reads it: the deepest level of at most kStageKeys
// keys is staged.  `sizes` are the keys per level, root first.
int make_tree(const void* keys, const int64_t* sizes, int32_t n_levels, Tree* t) {
  if (n_levels < 1 || sizes[0] > kStageKeys) return -1;
  int32_t staged = 0;
  while (staged + 1 < n_levels && sizes[staged + 1] <= kStageKeys) ++staged;
  if (n_levels - 1 - staged > kMaxBelow) return -1;
  t->keys = static_cast<const int64_t*>(keys);
  int64_t off = 0;
  for (int32_t l = 0; l < n_levels; ++l) {
    if (sizes[l] <= 0 || sizes[l] % kFan || sizes[l] > INT32_MAX) return -1;
    if (l == staged) {
      t->staged_off = off;
      t->staged_n = static_cast<int32_t>(sizes[l]);
    } else if (l > staged) {
      t->below_off[l - staged - 1] = off;
    }
    off += sizes[l];
  }
  t->n_below = n_levels - 1 - staged;
  t->n0 = sizes[n_levels - 1];
  return 0;
}

}  // namespace

// 0, or a cudaError_t; -1 for trees the kernel does not take: built with
// another fan-out than kFan, or of level sizes it cannot stage or descend.
extern "C" int count_step_launch(
    int32_t fanout,
    const void* blk_chrom, const void* blk_start, const void* blk_end,
    const void* blk_strand, int64_t n_blocks,
    const void* frag_chrom, const void* frag_refid, const void* frag_start,
    const void* frag_end, const void* frag_strand, int64_t n_frags,
    const void* span_tree, const int64_t* span_sizes, int32_t span_levels,
    const void* point_tree, const int64_t* point_sizes, int32_t point_levels,
    const void* uspan_rec, int64_t n_uspan, const void* chrom_base, int64_t n_chroms,
    const void* roi_chrom, const void* roi_start, const void* roi_end, int32_t n_roi,
    int32_t overhang, void* cnt, int64_t off_dd, int64_t w_dd, int64_t off_p,
    int64_t w_p, int64_t off_roi, int64_t off_nf, void* chr, int32_t n_refids,
    void* stream) {
  Args a;
  if (fanout != kFan || make_tree(span_tree, span_sizes, span_levels, &a.span) ||
      make_tree(point_tree, point_sizes, point_levels, &a.point))
    return -1;
  a.blk_chrom = static_cast<const int32_t*>(blk_chrom);
  a.blk_start = static_cast<const int32_t*>(blk_start);
  a.blk_end = static_cast<const int32_t*>(blk_end);
  a.blk_strand = static_cast<const int32_t*>(blk_strand);
  a.n_blocks = n_blocks;
  a.frag_chrom = static_cast<const int32_t*>(frag_chrom);
  a.frag_refid = static_cast<const int32_t*>(frag_refid);
  a.frag_start = static_cast<const int32_t*>(frag_start);
  a.frag_end = static_cast<const int32_t*>(frag_end);
  a.frag_strand = static_cast<const int32_t*>(frag_strand);
  a.n_frags = n_frags;
  a.uspan_rec = static_cast<const int2*>(uspan_rec);
  a.n_uspan = n_uspan;
  a.chrom_base = static_cast<const int32_t*>(chrom_base);
  a.n_chroms = n_chroms;
  a.roi_chrom = static_cast<const int32_t*>(roi_chrom);
  a.roi_start = static_cast<const int32_t*>(roi_start);
  a.roi_end = static_cast<const int32_t*>(roi_end);
  a.n_roi = n_roi;
  a.overhang = overhang;
  a.cnt = static_cast<int32_t*>(cnt);
  a.off_dd = off_dd;
  a.w_dd = w_dd;
  a.off_p = off_p;
  a.w_p = w_p;
  a.off_roi = off_roi;
  a.off_nf = off_nf;
  a.chr = static_cast<int32_t*>(chr);
  a.n_refids = n_refids;

  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t shared = sizeof(int64_t) * (a.span.staged_n + a.point.staged_n);
  count_step_kernel<<<sms, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
