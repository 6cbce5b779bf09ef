// Scalar single-thread conformance counter (SURVEY.md §7.2 step 2).
//
// A deliberately straightforward C++ reimplementation of the counting
// semantics over packed batches — the measured stand-in for the reference's
// single-thread C++ counter (BASELINE.md: the mounted reference snapshot is a
// tombstone and publishes no numbers, so the >10x throughput target is graded
// against this binary).  Must agree bit-exactly with the NumPy oracle and the
// device engine (tests/test_oracle_native.py).
//
// Takes the same sentinel-free reference tables the ref compiler emits
// (irfinder_tpu/refio/compile.py) via a flat C ABI; counters mirror
// irfinder_tpu/ops/step.py including the diff-array depth representation.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Table2 {  // (chrom, coord) sorted lexicographically
  const int32_t* chrom;
  const int32_t* coord;
  int64_t n;
  // first index with key >= (c, p)
  int64_t lower(int32_t c, int32_t p) const {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
      int64_t m = (lo + hi) >> 1;
      if (chrom[m] < c || (chrom[m] == c && coord[m] < p)) lo = m + 1;
      else hi = m;
    }
    return lo;
  }
  int64_t upper(int32_t c, int32_t p) const {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
      int64_t m = (lo + hi) >> 1;
      if (chrom[m] < c || (chrom[m] == c && coord[m] <= p)) lo = m + 1;
      else hi = m;
    }
    return lo;
  }
};

struct Oracle {
  // reference tables (borrowed pointers; Python keeps them alive)
  Table2 uspan;               // (chrom, start)
  const int32_t* uspan_len;
  const int64_t* uspan_off;
  const int64_t* chrom_base;  // per-chrom first MBS offset
  int32_t n_chroms;
  int64_t mbs_size;
  Table2 bstart, bend, point;
  const int32_t* pair_chrom;
  const int32_t* pair_start;
  const int32_t* pair_end;
  int64_t n_pairs;
  const int32_t* roi_chrom;
  const int32_t* roi_start;
  const int32_t* roi_end;
  int64_t n_rois;
  int32_t spans_overhang;
  int64_t n_refids;

  // counters (trash slot at the end of each axis, like ops/step.py)
  std::vector<int32_t> ddiff;      // (2, mbs+1)
  std::vector<int32_t> start_cnt;  // (2, S+1)
  std::vector<int32_t> end_cnt;    // (2, E+1)
  std::vector<int32_t> exact_cnt;  // (2, X+1)
  std::vector<int32_t> sdiff;      // (2, P+1)
  std::vector<int32_t> roi_cnt;    // (2, R)
  std::vector<int32_t> chr_frag;   // (n_refids+1,)
  int64_t n_frags = 0;

  int64_t mbs_rank(int32_t c, int32_t p) const {
    if (c < 0) return mbs_size;
    int64_t j = uspan.upper(c, p) - 1;
    if (j >= 0 && uspan.chrom[j] == c) {
      int32_t w = std::min(std::max(p - uspan.coord[j], 0), uspan_len[j]);
      return uspan_off[j] + w;
    }
    return (c < n_chroms) ? chrom_base[c] : mbs_size;
  }

  int64_t pair_lookup(int32_t c, int32_t s, int32_t e) const {
    int64_t lo = 0, hi = n_pairs;
    while (lo < hi) {
      int64_t m = (lo + hi) >> 1;
      bool lt = pair_chrom[m] < c ||
                (pair_chrom[m] == c &&
                 (pair_start[m] < s || (pair_start[m] == s && pair_end[m] < e)));
      if (lt) lo = m + 1;
      else hi = m;
    }
    if (lo < n_pairs && pair_chrom[lo] == c && pair_start[lo] == s &&
        pair_end[lo] == e)
      return lo;
    return n_pairs;  // trash
  }
};

}  // namespace

extern "C" {

void* orc_create(
    const int32_t* uspan_chrom, const int32_t* uspan_start,
    const int32_t* uspan_len, const int64_t* uspan_off,
    const int64_t* chrom_base, int64_t n_uspans, int32_t n_chroms,
    int64_t mbs_size,
    const int32_t* bstart_chrom, const int32_t* bstart_coord, int64_t n_bstart,
    const int32_t* bend_chrom, const int32_t* bend_coord, int64_t n_bend,
    const int32_t* pair_chrom, const int32_t* pair_start,
    const int32_t* pair_end, int64_t n_pairs,
    const int32_t* point_chrom, const int32_t* point_coord, int64_t n_points,
    const int32_t* roi_chrom, const int32_t* roi_start, const int32_t* roi_end,
    int64_t n_rois, int32_t spans_overhang, int64_t n_refids) {
  auto* o = new Oracle();
  o->uspan = {uspan_chrom, uspan_start, n_uspans};
  o->uspan_len = uspan_len;
  o->uspan_off = uspan_off;
  o->chrom_base = chrom_base;
  o->n_chroms = n_chroms;
  o->mbs_size = mbs_size;
  o->bstart = {bstart_chrom, bstart_coord, n_bstart};
  o->bend = {bend_chrom, bend_coord, n_bend};
  o->point = {point_chrom, point_coord, n_points};
  o->pair_chrom = pair_chrom;
  o->pair_start = pair_start;
  o->pair_end = pair_end;
  o->n_pairs = n_pairs;
  o->roi_chrom = roi_chrom;
  o->roi_start = roi_start;
  o->roi_end = roi_end;
  o->n_rois = n_rois;
  o->spans_overhang = spans_overhang;
  o->n_refids = n_refids;
  o->ddiff.assign(2 * (mbs_size + 1), 0);
  o->start_cnt.assign(2 * (n_bstart + 1), 0);
  o->end_cnt.assign(2 * (n_bend + 1), 0);
  o->exact_cnt.assign(2 * (n_pairs + 1), 0);
  o->sdiff.assign(2 * (n_points + 1), 0);
  o->roi_cnt.assign(2 * (n_rois ? n_rois : 1), 0);
  o->chr_frag.assign(n_refids + 1, 0);
  return o;
}

void orc_count_batch(
    void* h,
    const int32_t* blk_chrom, const int32_t* blk_start, const int32_t* blk_end,
    const int32_t* blk_strand, int64_t n_blocks,
    const int32_t* gap_chrom, const int32_t* gap_start, const int32_t* gap_end,
    const int32_t* gap_strand, int64_t n_gaps,
    const int32_t* frag_chrom, const int32_t* frag_refid,
    const int32_t* frag_start, const int32_t* frag_end,
    const int32_t* frag_strand, int64_t n_frags) {
  auto* o = static_cast<Oracle*>(h);
  const int64_t mbs1 = o->mbs_size + 1;
  for (int64_t i = 0; i < n_blocks; i++) {
    int32_t c = blk_chrom[i];
    if (c < 0) continue;
    int32_t st = blk_strand[i];
    int64_t lo = o->mbs_rank(c, blk_start[i]);
    int64_t hi = o->mbs_rank(c, blk_end[i]);
    o->ddiff[st * mbs1 + lo]++;
    o->ddiff[st * mbs1 + hi]--;
    // spans-point
    if (blk_end[i] - blk_start[i] >= 2 * o->spans_overhang) {
      int64_t plo = o->point.lower(c, blk_start[i] + o->spans_overhang);
      int64_t phi = o->point.upper(c, blk_end[i] - o->spans_overhang);
      o->sdiff[st * (o->point.n + 1) + plo]++;
      o->sdiff[st * (o->point.n + 1) + phi]--;
    }
  }
  for (int64_t i = 0; i < n_gaps; i++) {
    int32_t c = gap_chrom[i];
    if (c < 0) continue;
    int32_t st = gap_strand[i];
    int64_t j = o->bstart.lower(c, gap_start[i]);
    if (j < o->bstart.n && o->bstart.chrom[j] == c &&
        o->bstart.coord[j] == gap_start[i])
      o->start_cnt[st * (o->bstart.n + 1) + j]++;
    j = o->bend.lower(c, gap_end[i]);
    if (j < o->bend.n && o->bend.chrom[j] == c && o->bend.coord[j] == gap_end[i])
      o->end_cnt[st * (o->bend.n + 1) + j]++;
    j = o->pair_lookup(c, gap_start[i], gap_end[i]);
    if (j < o->n_pairs) o->exact_cnt[st * (o->n_pairs + 1) + j]++;
  }
  for (int64_t i = 0; i < n_frags; i++) {
    int32_t rid = frag_refid[i];
    if (rid < 0) continue;
    o->n_frags++;
    o->chr_frag[(rid < o->n_refids) ? rid : o->n_refids]++;
    int32_t c = frag_chrom[i];
    if (c < 0) continue;
    int32_t st = frag_strand[i];
    for (int64_t r = 0; r < o->n_rois; r++) {  // scalar walk like the reference
      if (o->roi_chrom[r] == c && o->roi_start[r] < frag_end[i] &&
          frag_start[i] < o->roi_end[r])
        o->roi_cnt[st * o->n_rois + r]++;
    }
  }
}

// Finalize into caller-allocated buffers (cumsum of diff arrays, trash
// dropped) — mirrors ops/step.py finalize_device.
void orc_finalize(void* h, int32_t* depth, int32_t* start_cnt,
                  int32_t* end_cnt, int32_t* exact_cnt, int32_t* span_hits,
                  int32_t* roi_cnt, int32_t* chr_frag, int64_t* n_frags) {
  auto* o = static_cast<Oracle*>(h);
  for (int s = 0; s < 2; s++) {
    int64_t acc = 0;
    const int32_t* d = o->ddiff.data() + s * (o->mbs_size + 1);
    for (int64_t i = 0; i < o->mbs_size; i++) {
      acc += d[i];
      depth[s * o->mbs_size + i] = (int32_t)acc;
    }
    acc = 0;
    const int32_t* sp = o->sdiff.data() + s * (o->point.n + 1);
    for (int64_t i = 0; i < o->point.n; i++) {
      acc += sp[i];
      span_hits[s * o->point.n + i] = (int32_t)acc;
    }
    memcpy(start_cnt + s * o->bstart.n,
           o->start_cnt.data() + s * (o->bstart.n + 1),
           o->bstart.n * sizeof(int32_t));
    memcpy(end_cnt + s * o->bend.n, o->end_cnt.data() + s * (o->bend.n + 1),
           o->bend.n * sizeof(int32_t));
    memcpy(exact_cnt + s * o->n_pairs,
           o->exact_cnt.data() + s * (o->n_pairs + 1),
           o->n_pairs * sizeof(int32_t));
    if (o->n_rois)
      memcpy(roi_cnt + s * o->n_rois, o->roi_cnt.data() + s * o->n_rois,
             o->n_rois * sizeof(int32_t));
  }
  memcpy(chr_frag, o->chr_frag.data(), o->n_refids * sizeof(int32_t));
  *n_frags = o->n_frags;
}

void orc_close(void* h) { delete static_cast<Oracle*>(h); }

}  // extern "C"
