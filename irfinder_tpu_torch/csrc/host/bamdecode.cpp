// Native BAM decoder: BGZF -> records -> fragments -> packed columnar batches.
//
// TPU-host equivalent of the reference's BAM2blocks stage (SURVEY.md §2 rows
// 7-8, historical src/irfinder/BAM2blocks.cpp [R] — the mounted snapshot is a
// tombstone, behavior reconstructed; the Python decoder
// irfinder_tpu_torch/io/bampy.py is the executable conformance spec and
// tests/test_torch_bamdecode.py asserts bit-identical batch streams).
//
// Design (SURVEY.md §7.3 item 3 — decode must not bottleneck the device).
// Only what has to be sequential runs on the caller's thread (the ordering
// thread); a pool of n_threads workers takes the rest:
//   * the file is mmap'd; a pre-scan walks BGZF headers only (18 bytes per
//     ~64KiB block) collecting (offset, csize, isize) per block; a pipe is
//     read member by member by a reader thread into a compressed ring;
//   * inflate (pool): workers inflate blocks independently (BGZF blocks are
//     self-contained raw-deflate members; Inflater below) into a ring of
//     group buffers of kGroupBlocks consecutive blocks each, so a record
//     that straddles blocks of a group lies there whole;
//   * framing (ordering thread): walk the inflated stream's block_size chain
//     in order; a chunk is the records that end in one group, found in place
//     (a record begun in an earlier group is copied whole, the only bytes
//     copied);
//   * parsing (pool): the same workers take chunks in whatever order they
//     become ready, apply the admission filter and walk CIGARs into aligned
//     blocks + splice gaps, into flat arrays local to the chunk — nothing is
//     allocated per read; a read name stays a pointer into the chunk;
//   * pairing and emission (ordering thread, record order): mates by
//     read-name adjacency, then fixed-capacity columnar batches (the
//     PackedBatch layout of irfinder_tpu_torch/io/batch.py).
// Batches, counts, errors and resume tokens are those of a decoder that parses
// record by record on one thread.
//
// C ABI only (no pybind11 in this image); Python binds via ctypes
// (irfinder_tpu_torch/native/bamdecode.py). Batch pointers stay valid until
// the next bd_next_batch() call on the same handle.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <poll.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
inline void copy8(uint8_t* d, const uint8_t* s) { memcpy(d, s, 8); }

// ---- raw DEFLATE (RFC 1951) --------------------------------------------------
// A BGZF member is one raw-deflate stream of at most 64 KiB, inflated whole
// into a buffer of known size, so no streaming state is kept: a 64-bit bit
// buffer refilled a word at a time, canonical Huffman tables read with one
// lookup (11 bits for literal/length codes, 8 for distance codes, subtables
// for longer codes) whose entries hold a symbol's base value and its extra
// bits, up to three literals a refill, and matches copied a word at a time.
// Near either end of the buffers a careful loop checks every step.  Every
// table entry a stream can reach is filled; a malformed or truncated stream
// returns -1 and never reads or writes out of bounds.
class Inflater {
 public:
  Inflater() {
    uint8_t lens[288];
    std::fill(lens, lens + 144, 8);
    std::fill(lens + 144, lens + 256, 9);
    std::fill(lens + 256, lens + 280, 7);
    std::fill(lens + 280, lens + 288, 8);
    build(fixed_lit_, kLitBits, lens, 288, lit_sym);
    std::fill(lens, lens + 32, 5);
    build(fixed_dist_, kDistBits, lens, 32, dist_sym);
  }

  // Inflates in[0..in_n) into out[0..cap); returns the bytes written, or -1.
  int64_t run(const uint8_t* in, uint32_t in_n, uint8_t* out, uint32_t cap) {
    const uint8_t* ip = in;
    const uint8_t* const ie = in + in_n;
    uint8_t* op = out;
    uint8_t* const oe = out + cap;
    uint64_t bb = 0;    // bit buffer, next bit lowest
    uint32_t bl = 0;    // valid bits in bb
    uint32_t over = 0;  // zero bytes fed in past the end of the input
    // A refill leaves bl >= 56: enough for a whole length/distance pair (15 +
    // 5 + 15 + 13 bits).  The word refill may leave further stream bits above
    // bl; the next refill ORs in the same bits again.
#define IRF_REFILL_WORD()       \
  do {                          \
    bb |= load64(ip) << bl;     \
    ip += (63 - bl) >> 3;       \
    bl |= 56;                   \
  } while (0)
#define IRF_REFILL()                       \
  do {                                     \
    if (ie - ip >= 8) {                    \
      IRF_REFILL_WORD();                   \
    } else {                               \
      while (bl <= 56) {                   \
        if (ip < ie) {                     \
          bb |= (uint64_t)*ip++ << bl;     \
        } else if (++over > 8) {           \
          return -1;                       \
        }                                  \
        bl += 8;                           \
      }                                    \
    }                                      \
  } while (0)
    // one symbol of `table` into e, its codeword and extra bits consumed;
    // `val` is the entry's value plus the extra bits
#define IRF_DECODE(table, tbits)                                    \
  do {                                                              \
    e = table[bb & ((1u << (tbits)) - 1)];                          \
    if (kind(e) == kSub) {                                          \
      bb >>= (tbits);                                               \
      bl -= (tbits);                                                \
      e = table[value(e) + (bb & ((1u << extra(e)) - 1))];          \
    }                                                               \
    const uint64_t saved = bb;                                      \
    bb >>= bits(e);                                                 \
    bl -= bits(e);                                                  \
    val = value(e) + (uint32_t)((saved >> (bits(e) - extra(e))) &   \
                                ((1u << extra(e)) - 1));            \
  } while (0)
    // the literal of entry e, room assured
#define IRF_PUT_LITERAL()  \
  do {                     \
    bb >>= bits(e);        \
    bl -= bits(e);         \
    *op++ = (uint8_t)value(e); \
  } while (0)
    uint32_t e, val;
    bool last = false;
    while (!last) {
      IRF_REFILL();
      last = bb & 1;
      const uint32_t type = (bb >> 1) & 3;
      bb >>= 3;
      bl -= 3;
      const uint32_t *lt = fixed_lit_, *dt = fixed_dist_;
      if (type == 0) {  // stored: the whole bytes still buffered go back
        bb >>= bl & 7;
        bl -= bl & 7;
        if (over * 8 > bl) return -1;
        ip -= bl / 8 - over;
        bb = 0;
        bl = over = 0;
        if (ie - ip < 4) return -1;
        const uint32_t len = ip[0] | (uint32_t)ip[1] << 8;
        const uint32_t nlen = ip[2] | (uint32_t)ip[3] << 8;
        ip += 4;
        if (len != (~nlen & 0xFFFF) || len > (size_t)(ie - ip) ||
            len > (size_t)(oe - op))
          return -1;
        memcpy(op, ip, len);
        op += len;
        ip += len;
        continue;
      }
      if (type == 3) return -1;
      if (type == 2) {
        if (!read_tables(ip, ie, bb, bl, over)) return -1;
        lt = lit_;
        dt = dist_;
      }
      while (true) {
        if (ie - ip >= 16 && oe - op >= kFastRoom) {
          // fast: per step at most two word refills, three main-table
          // literals (each at most kLitBits) or two and a length code with
          // its extra bits, then a distance after a refill if need be.  The
          // next step's first entry is looked up before the copy.
          IRF_REFILL_WORD();
          e = lt[bb & ((1u << kLitBits) - 1)];
          do {
            if (kind(e) & kLitFlag) {
              IRF_PUT_LITERAL();
              e = lt[bb & ((1u << kLitBits) - 1)];
              if (kind(e) & kLitFlag) {
                IRF_PUT_LITERAL();
                e = lt[bb & ((1u << kLitBits) - 1)];
                if (kind(e) & kLitFlag) {
                  IRF_PUT_LITERAL();
                  IRF_REFILL_WORD();
                  e = lt[bb & ((1u << kLitBits) - 1)];
                  continue;
                }
              }
            }
            if (kind(e) & kRareFlag) {
              if (kind(e) == kSub) {
                bb >>= kLitBits;
                bl -= kLitBits;
                e = lt[value(e) + (bb & ((1u << extra(e)) - 1))];
                if (kind(e) & kLitFlag) {
                  IRF_PUT_LITERAL();
                  IRF_REFILL_WORD();
                  e = lt[bb & ((1u << kLitBits) - 1)];
                  continue;
                }
              }
              if (kind(e) & kRareFlag) {
                if (kind(e) != kEob) return -1;
                bb >>= bits(e);
                bl -= bits(e);
                goto block_done;
              }
            }
            const uint64_t saved = bb;
            bb >>= bits(e);
            bl -= bits(e);
            const uint32_t len = value(e) + (uint32_t)((saved >> (bits(e) - extra(e))) &
                                                       ((1u << extra(e)) - 1));
            if (bl < 15 + 13) IRF_REFILL_WORD();
            IRF_DECODE(dt, kDistBits);
            if ((kind(e) & kRareFlag) || val > (size_t)(op - out)) return -1;
            IRF_REFILL_WORD();
            e = lt[bb & ((1u << kLitBits) - 1)];
            // copy a word at a time, the first five unconditionally: the
            // room checked for the step takes the overrun past a short match
            const uint8_t* src = op - val;
            uint8_t* d = op;
            op += len;
            if (val >= 8) {  // every word read lies before its write
              copy8(d, src);
              copy8(d + 8, src + 8);
              copy8(d + 16, src + 16);
              copy8(d + 24, src + 24);
              copy8(d + 32, src + 32);
              for (d += 40, src += 40; d < op; d += 8, src += 8) copy8(d, src);
            } else if (val == 1) {
              const uint64_t w = 0x0101010101010101ull * d[-1];
              for (int k = 0; k < 5; k++) memcpy(d + 8 * k, &w, 8);
              for (d += 40; d < op; d += 8) memcpy(d, &w, 8);
            } else {
              d[0] = src[0];
              d[1] = src[1];
              d[2] = src[2];
              for (d += 3, src += 3; d < op;) *d++ = *src++;
            }
          } while (ie - ip >= 16 && oe - op >= kFastRoom);
          continue;
        }
        // careful: near the end of the input or of the output
        IRF_REFILL();
        IRF_DECODE(lt, kLitBits);
        if (kind(e) & kLitFlag) {
          if (op == oe) return -1;
          *op++ = (uint8_t)val;
          continue;
        }
        if (kind(e) != kLen) {
          if (kind(e) == kEob) break;
          return -1;
        }
        const uint32_t len = val;
        IRF_DECODE(dt, kDistBits);
        if (kind(e) != kLen || val > (size_t)(op - out) || len > (size_t)(oe - op))
          return -1;
        const uint8_t* src = op - val;
        for (uint32_t k = 0; k < len; k++) op[k] = src[k];
        op += len;
      }
    block_done:;
    }
    if (over * 8 > bl) return -1;  // the stream ended inside its last code
    return op - out;
  }

 private:
  // A table entry: value << 16 | kind << 12 | extra << 8 | bits.  `bits`
  // counts the codeword's bits (its tail's, in a subtable) and the extra
  // bits after it; `extra` is the extra bits after a length or distance
  // code, or a subtable's index bits.
  // kinds: flag 8 a literal, flag 4 what is rare: a subtable,
  // the end of the block, an invalid codeword; kLen a length or a distance
  enum : uint32_t {
    kLen = 0, kBad = 4, kEob = 5, kSub = 6, kLit = 8,
    kRareFlag = 4, kLitFlag = 8,
  };
  static constexpr int kLitBits = 11, kDistBits = 8, kPreBits = 7;
  // output room for a fast step: literals, a longest match and a word
  // copy's overrun
  static constexpr ptrdiff_t kFastRoom = 3 + 258 + 8;
  static constexpr uint32_t entry(uint32_t value, uint32_t kind, uint32_t extra) {
    return value << 16 | kind << 12 | extra << 8 | extra;
  }
  static uint32_t bits(uint32_t e) { return e & 0xFF; }
  static uint32_t extra(uint32_t e) { return (e >> 8) & 0xF; }
  static uint32_t kind(uint32_t e) { return (e >> 12) & 0xF; }
  static uint32_t value(uint32_t e) { return e >> 16; }

  static uint32_t lit_sym(int s) {
    static const uint16_t kBase[29] = {3,  4,  5,  6,  7,  8,  9,   10,  11,  13,
                                       15, 17, 19, 23, 27, 31, 35,  43,  51,  59,
                                       67, 83, 99, 115, 131, 163, 195, 227, 258};
    static const uint8_t kExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                       2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
    if (s < 256) return entry(s, kLit, 0);
    if (s == 256) return entry(0, kEob, 0);
    if (s < 286) return entry(kBase[s - 257], kLen, kExtra[s - 257]);
    return entry(0, kBad, 0);
  }
  static uint32_t dist_sym(int s) {
    static const uint16_t kBase[30] = {
        1,   2,   3,   4,   5,    7,    9,    13,   17,   25,   33,    49,    65,    97,    129,
        193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
    if (s < 30) return entry(kBase[s], kLen, s < 4 ? 0 : s / 2 - 1);
    return entry(0, kBad, 0);
  }
  static uint32_t pre_sym(int s) { return entry(s, kLit, 0); }

  // A dynamic block's code lengths, then its tables into lit_ and dist_.
  bool read_tables(const uint8_t*& ip, const uint8_t* ie, uint64_t& bb,
                   uint32_t& bl, uint32_t& over) {
    uint32_t e, val;
    const uint32_t hlit = (bb & 31) + 257, hdist = ((bb >> 5) & 31) + 1,
                   hclen = ((bb >> 10) & 15) + 4;
    bb >>= 14;
    bl -= 14;
    if (hlit > 286 || hdist > 30) return false;
    static const uint8_t kOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                       11, 4,  12, 3, 13, 2, 14, 1, 15};
    uint8_t pre[19] = {0};
    for (uint32_t i = 0; i < hclen; i++) {
      if (bl < 3) IRF_REFILL();
      pre[kOrder[i]] = bb & 7;
      bb >>= 3;
      bl -= 3;
    }
    if (build(pre_, kPreBits, pre, 19, pre_sym) != 0) return false;
    uint8_t lens[286 + 30];
    const uint32_t n = hlit + hdist;
    for (uint32_t i = 0; i < n;) {
      IRF_REFILL();
      IRF_DECODE(pre_, kPreBits);
      if (kind(e) == kBad) return false;
      if (val < 16) {
        lens[i++] = (uint8_t)val;
        continue;
      }
      uint32_t rep;
      uint8_t fill = 0;
      if (val == 16) {
        if (i == 0) return false;
        fill = lens[i - 1];
        rep = 3 + (bb & 3);
        bb >>= 2;
        bl -= 2;
      } else if (val == 17) {
        rep = 3 + (bb & 7);
        bb >>= 3;
        bl -= 3;
      } else {
        rep = 11 + (bb & 127);
        bb >>= 7;
        bl -= 7;
      }
      if (rep > n - i) return false;
      std::fill(lens + i, lens + i + rep, fill);
      i += rep;
    }
    if (lens[256] == 0) return false;
    // as zlib: an incomplete code only where it has at most one codeword
    int left = build(lit_, kLitBits, lens, hlit, lit_sym);
    if (left < 0 || (left > 0 && max_len_ > 1)) return false;
    left = build(dist_, kDistBits, lens + hlit, hdist, dist_sym);
    return left == 0 || (left > 0 && max_len_ <= 1);
  }
#undef IRF_REFILL_WORD
#undef IRF_REFILL
#undef IRF_DECODE
#undef IRF_PUT_LITERAL

  // Fills `table` for the code lengths lens[0..n): 1 << tbits entries, then
  // the subtables.  Returns -1 for an over-subscribed code, else the count of
  // codewords it leaves unused (0: complete; their entries read kBad).
  template <typename Sym>
  int build(uint32_t* table, int tbits, const uint8_t* lens, int n, Sym sym) {
    int count[16] = {0}, offs[16];
    for (int s = 0; s < n; s++) count[lens[s]]++;
    count[0] = 0;
    int left = 1;
    max_len_ = 0;
    for (int l = 1; l < 16; l++) {
      left = 2 * left - count[l];
      if (left < 0) return -1;
      if (count[l]) max_len_ = l;
    }
    uint16_t sorted[288];
    offs[1] = 0;
    for (int l = 1; l < 15; l++) offs[l + 1] = offs[l] + count[l];
    for (int s = 0; s < n; s++)
      if (lens[s]) sorted[offs[lens[s]]++] = (uint16_t)s;
    const uint32_t bad = entry(0, kBad, 0);
    if (left) std::fill(table, table + (1 << tbits), bad);
    const int sub_bits = max_len_ > tbits ? max_len_ - tbits : 0;
    uint32_t next_sub = 1u << tbits;
    uint32_t sub = 0, sub_pre = ~0u;  // the subtable being filled, its prefix
    uint32_t rev = 0;  // the codeword, bit-reversed (streams are LSB first)
    for (int l = 1, k = 0; l <= max_len_; l++) {
      for (int c = 0; c < count[l]; c++, k++) {
        const uint32_t e = sym(sorted[k]);
        if (l <= tbits) {
          for (uint32_t i = rev; i < (1u << tbits); i += 1u << l) table[i] = e + l;
        } else {
          // canonical order keeps the codewords of one prefix together
          const uint32_t pre = rev & ((1u << tbits) - 1);
          if (pre != sub_pre) {
            sub = next_sub;
            sub_pre = pre;
            next_sub += 1u << sub_bits;
            table[pre] = entry(sub, kSub, sub_bits) - sub_bits + tbits;
            if (left) std::fill(table + sub, table + next_sub, bad);
          }
          for (uint32_t i = rev >> tbits; i < (1u << sub_bits); i += 1u << (l - tbits))
            table[sub + i] = e + (l - tbits);
        }
        // the next codeword: increment the bit-reversed l-bit number
        const uint32_t flip = rev ^ ((1u << l) - 1);
        if (!flip) break;
        const uint32_t bit = 1u << (31 - __builtin_clz(flip));
        rev = (rev & (bit - 1)) | bit;
      }
    }
    return left;
  }

  uint32_t lit_[(1 << kLitBits) + 286 * 16];
  uint32_t dist_[(1 << kDistBits) + 30 * 128];
  uint32_t pre_[1 << kPreBits];
  uint32_t fixed_lit_[1 << kLitBits];
  uint32_t fixed_dist_[1 << kDistBits];
  int max_len_ = 0;
};

// ---- counting semantics DEFAULTS (mirror irfinder_tpu_torch/semantics.py's
// defaults; the runtime values are INJECTED per-handle via bd_open_ex so a
// semantics override — golden pinning, env hook — never needs a rebuild) ----
constexpr int32_t kFlagDropMask = 0x4 | 0x100 | 0x800;
constexpr int32_t kMinMapq = 5;
constexpr int32_t kMinGapAsJunction = 0;

struct BlockDesc {
  uint64_t offset;  // file offset of the gzip member
  uint32_t csize;   // compressed payload size (raw deflate bytes)
  uint32_t isize;   // inflated size
  uint32_t data_off;  // offset of deflate data within the member
};

// Inflated blocks live in groups: kGroupBlocks consecutive blocks (by index
// in the stream) inflated side by side into one group buffer, so that a
// record straddling blocks of a group lies there whole and is parsed in
// place.  kGroups group buffers form a ring; a group's buffer is reused once
// the chunk of its records has been emitted.  A chunk is the records that
// end in one group; one that began in an earlier group is copied whole.
constexpr int kGroupBlocks = 8;
constexpr int kGroups = 16;
constexpr int kSlots = kGroupBlocks * kGroups;  // blocks in the ring
constexpr size_t kBlockCap = 1 << 16;            // a BGZF block's isize bound
constexpr size_t kGroupBytes = kGroupBlocks * kBlockCap;

struct Slot {
  uint32_t len = 0;
  bool bad = false;                 // the member did not inflate to its isize
  std::atomic<int64_t> block{-1};  // which block index currently occupies it
};

// Streaming (pipe) mode: compressed-member ring fed by a reader thread.
// 256 members x <=64KiB compressed bounds memory at ~16MiB worst case.
constexpr int kCSlots = 256;

struct StreamBlock {
  std::vector<uint8_t> raw;  // full BGZF member bytes
  uint32_t csize = 0, isize = 0, data_off = 0;
  uint32_t goff = 0;  // offset of the inflated block in its group buffer
};

// Bounded spin: yield briefly, then sleep — the pipe reader must not starve
// a slow consumer on a small host.
inline void backoff(int& spins) {
  if (++spins < 64) {
    std::this_thread::yield();
  } else {
    std::this_thread::sleep_for(std::chrono::microseconds(100));
  }
}

inline int32_t rd_i32(const uint8_t* p) {
  int32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint16_t rd_u16(const uint8_t* p) {
  uint16_t v;
  memcpy(&v, p, 2);
  return v;
}

// One admitted record of a parsed chunk.
struct Rec {
  int64_t end;        // logical offset just past the record (resume offset)
  const char* name;   // read name, in the chunk's bytes
  uint32_t name_len;
  uint32_t idx;       // index among the chunk's records (reads_total)
  int32_t ref_id;
  int32_t strand;       // fragment-strand contribution
  uint32_t blk0, nblk;  // (start, end) pairs in Chunk::blk
  uint32_t gap0, ngap;  // (start, end) pairs in Chunk::gap
  // the name equals the previous admitted record's in the chunk (-1 for the
  // chunk's first: its predecessor lies in an earlier chunk)
  int32_t same_prev;
};

enum ChunkEnd { kMore = 0, kEof = 1, kFail = 2 };

// rec_off: an offset into the group buffer, or with kInSide into `side`
constexpr uint32_t kInSide = 1u << 31;

struct Chunk {
  // framing (ordering thread), before the chunk is published
  std::vector<uint8_t> side;      // records that began before the group
  std::vector<uint32_t> rec_off;  // each record's start
  const uint8_t* gdata = nullptr;  // the group buffer
  int64_t gbase = 0;               // logical offset of gdata[0]
  int64_t side_base = 0;           // logical offset of side[0]
  int64_t end_pos = 0;             // logical offset past the last record
  uint32_t n_rec = 0;
  int end = kMore;  // what follows the chunk's records
  std::string err;  // the error a kFail chunk ends with
  // parsing (a pool worker), before `parsed`
  std::vector<Rec> recs;          // the admitted records, in order
  std::vector<int32_t> blk, gap;  // (start, end) pairs
  std::atomic<bool> parsed{false};
};

// A read as pairing and emission see it: in a parsed chunk, or owned.
struct ReadView {
  const char* name = nullptr;
  uint32_t name_len = 0;
  int32_t ref_id = 0;
  int32_t strand = 0;
  const int32_t* blk = nullptr;  // nblk (start, end) pairs
  const int32_t* gap = nullptr;  // ngap (start, end) pairs
  uint32_t nblk = 0, ngap = 0;
};

// A read that outlives its chunk: the pending mate when its chunk is
// retired, or a read restored from a resume token.
struct OwnedRead {
  std::string name;
  int32_t ref_id = 0, strand = 0;
  std::vector<int32_t> blk, gap;

  void assign(const ReadView& r) {
    name.assign(r.name, r.name_len);
    ref_id = r.ref_id;
    strand = r.strand;
    blk.assign(r.blk, r.blk + 2 * r.nblk);
    gap.assign(r.gap, r.gap + 2 * r.ngap);
  }
  ReadView view() const {
    ReadView v;
    v.name = name.data();
    v.name_len = (uint32_t)name.size();
    v.ref_id = ref_id;
    v.strand = strand;
    v.blk = blk.data();
    v.gap = gap.data();
    v.nblk = (uint32_t)(blk.size() / 2);
    v.ngap = (uint32_t)(gap.size() / 2);
    return v;
  }
};

// One fragment: one read, or two mates.
struct Frag {
  ReadView r[2];
  int n = 0;
};

struct BatchBuf {
  std::vector<int32_t> blk_chrom, blk_start, blk_end, blk_strand;
  std::vector<int32_t> gap_chrom, gap_start, gap_end, gap_strand;
  std::vector<int32_t> frag_chrom, frag_refid, frag_start, frag_end, frag_strand;
  std::vector<int32_t> frag_nblk;  // blocks emitted for this frag row (wire v3
                                   // derives frag spans on device from blocks)
  int64_t n_blocks = 0, n_gaps = 0, n_frags = 0, n_reads = 0;
  int64_t cap_blocks = 0, cap_gaps = 0, cap_frags = 0;

  void init(int64_t cap, int64_t bpf, int64_t gpf) {
    cap_frags = cap;
    // io/batch.py BLOCKS_PER_FRAG / GAPS_PER_FRAG (or the LONGREAD_*
    // geometry via bd_open_ex2), floored at MIN_CAP_UNITS so one fragment
    // (even a long-read spliced alignment) always fits
    cap_blocks = std::max<int64_t>(cap * bpf, 4096);
    cap_gaps = std::max<int64_t>(cap * gpf, 4096);
    blk_chrom.assign(cap_blocks, -1);
    blk_start.assign(cap_blocks, 0);
    blk_end.assign(cap_blocks, 0);
    blk_strand.assign(cap_blocks, 0);
    gap_chrom.assign(cap_gaps, -1);
    gap_start.assign(cap_gaps, 0);
    gap_end.assign(cap_gaps, 0);
    gap_strand.assign(cap_gaps, 0);
    frag_chrom.assign(cap_frags, -1);
    frag_refid.assign(cap_frags, -1);
    frag_start.assign(cap_frags, 0);
    frag_end.assign(cap_frags, 0);
    frag_strand.assign(cap_frags, 0);
    frag_nblk.assign(cap_frags, 0);
    n_blocks = n_gaps = n_frags = n_reads = 0;
  }
  void reset() {
    std::fill(blk_chrom.begin(), blk_chrom.begin() + n_blocks, -1);
    std::fill(gap_chrom.begin(), gap_chrom.begin() + n_gaps, -1);
    std::fill(frag_chrom.begin(), frag_chrom.begin() + n_frags, -1);
    std::fill(frag_refid.begin(), frag_refid.begin() + n_frags, -1);
    std::fill(frag_nblk.begin(), frag_nblk.begin() + n_frags, 0);
    n_blocks = n_gaps = n_frags = n_reads = 0;
  }
  bool would_overflow(int64_t nb, int64_t ng, int64_t nf) const {
    return n_blocks + nb > cap_blocks || n_gaps + ng > cap_gaps ||
           n_frags + nf > cap_frags;
  }
};

struct Stats {
  int64_t reads_total = 0, reads_admitted = 0, fragments = 0, pairs = 0,
          singles = 0, blocks_inflated = 0;
  // nanoseconds the ordering thread waited on the pool (an inflated block
  // or a parsed chunk)
  int64_t pool_wait_ns = 0;
};

class Decoder {
 public:
  std::string error;

  bool open(const char* path, int64_t cap_frags, int n_threads,
            int32_t drop_mask, int32_t min_mapq, int32_t min_gap,
            const uint8_t* token, int64_t token_len,
            int64_t blocks_per_frag = 3, int64_t gaps_per_frag = 1) {
    drop_mask_ = drop_mask;
    min_mapq_ = min_mapq;
    min_gap_ = min_gap;
    fd_ = ::open(path, O_RDONLY);
    if (fd_ < 0) return fail("cannot open file");
    struct stat st;
    if (fstat(fd_, &st) != 0) return fail("fstat failed");
    fsize_ = st.st_size;
    map_ = static_cast<const uint8_t*>(
        mmap(nullptr, fsize_, PROT_READ, MAP_PRIVATE, fd_, 0));
    if (map_ == MAP_FAILED) return fail("mmap failed");
    if (!scan_blocks()) return false;
    gbuf_.reset(new uint8_t[kGroups * kGroupBytes]);  // left unfilled
    cur_.init(cap_frags, blocks_per_frag, gaps_per_frag);
    // header parse runs in synchronous mode (ensure() inflates inline while
    // workers_ is empty) so a resume can reposition the pipeline BEFORE any
    // worker starts racing ahead of the target block
    if (!parse_header()) return false;
    if (token && token_len > 0) {
      if (!restore_token(token, token_len)) return false;
    }
    start_framing();
    n_threads = std::max(1, n_threads);
    next_block_ = next_consume_;
    consumed_.store(next_consume_ / kGroupBlocks * kGroupBlocks);
    stop_.store(false);
    for (int i = 0; i < n_threads; i++)
      workers_.emplace_back([this] { worker(); });
    return true;
  }

  // Streaming (pipe/fd) mode (SURVEY.md §3.2 FIFO chain — the reference's
  // counter reads the aligner's SAM/BAM stream directly; this is the TPU
  // build's equivalent so FastQ --stream rides the SAME multithreaded
  // inflate/parse pipeline as the file path): a reader thread pulls BGZF
  // members off the fd into a bounded compressed ring; the worker pool
  // inflates from the ring.  No mmap, no pre-scan, memory O(kCSlots*64KiB).
  // Resume tokens are emitted (format-shared) but cannot reposition a pipe.
  bool open_fd(int fd, int64_t cap_frags, int n_threads, int32_t drop_mask,
               int32_t min_mapq, int32_t min_gap, int64_t blocks_per_frag,
               int64_t gaps_per_frag, int tee_fd) {
    drop_mask_ = drop_mask;
    min_mapq_ = min_mapq;
    min_gap_ = min_gap;
    streaming_ = true;
    fd_ = dup(fd);  // own our copy; caller's fd lifecycle stays theirs
    if (fd_ < 0) return fail("cannot dup stream fd");
    tee_fd_ = tee_fd;
    gbuf_.reset(new uint8_t[kGroups * kGroupBytes]);  // left unfilled
    cur_.init(cap_frags, blocks_per_frag, gaps_per_frag);
    stop_.store(false);
    next_block_ = 0;
    consumed_.store(0);
    reader_ = std::thread([this] { reader(); });
    n_threads = std::max(1, n_threads);
    for (int i = 0; i < n_threads; i++)
      workers_.emplace_back([this] { worker(); });
    if (!parse_header()) return false;
    start_framing();
    return true;
  }

  std::vector<uint8_t> token() const { return make_token(); }

  ~Decoder() {
    {
      std::lock_guard<std::mutex> lk(m_);
      stop_.store(true);
    }
    work_cv_.notify_all();
    if (reader_.joinable()) reader_.join();
    for (auto& t : workers_) t.join();
    if (map_ && map_ != MAP_FAILED) munmap(const_cast<uint8_t*>(map_), fsize_);
    if (fd_ >= 0) ::close(fd_);
  }

  void set_lut(const int32_t* lut, int64_t n) { lut_.assign(lut, lut + n); }

  int n_refs() const { return (int)ref_names_.size(); }
  const std::string& ref_name(int i) const { return ref_names_[i]; }
  int64_t ref_len(int i) const { return ref_lens_[i]; }

  // Returns 1 when a batch is produced (view valid until next call), 0 at
  // clean EOF with an empty batch, <0 on error.
  int next_batch(BatchBuf** out) {
    cur_.reset();
    while (true) {
      if (have_pending_flush_) {
        // fragment carried over because the previous batch was full
        have_pending_flush_ = false;
        emit_fragment(carry_);
        carry_.n = 0;
      }
      ReadView rd;
      int same = -1;
      int r = next_admitted_read(&rd, &same);
      if (r < 0) return -1;
      if (r == 0) {  // EOF: flush pending mate + finish
        if (pending_valid_) {
          Frag frag;
          frag.r[frag.n++] = pending_;
          pending_valid_ = false;
          stats_.fragments++;
          stats_.singles++;
          if (!try_emit(frag)) {  // full: carry to next batch
            *out = &cur_;
            return 1;
          }
        }
        *out = &cur_;
        return cur_.n_frags > 0 ? 1 : 0;
      }
      // name-adjacency pairing (bampy FragmentAssembler semantics): a valid
      // pending_ is always the previous admitted read, whose name the pool
      // compared already unless it lies in an earlier chunk
      Frag frag;
      if (pending_valid_ &&
          (same >= 0 ? same == 1
                     : pending_.name_len == rd.name_len &&
                           memcmp(pending_.name, rd.name, rd.name_len) == 0)) {
        frag.r[frag.n++] = pending_;
        frag.r[frag.n++] = rd;
        pending_valid_ = false;
        stats_.fragments++;
        stats_.pairs++;
      } else {
        if (pending_valid_) {
          frag.r[frag.n++] = pending_;
          stats_.fragments++;
          stats_.singles++;
        }
        pending_ = rd;
        pending_valid_ = true;
        pending_owned_ = false;
      }
      if (frag.n && !try_emit(frag)) {
        *out = &cur_;
        return 1;
      }
    }
  }

  const Stats& stats() const { return stats_; }
  int64_t pool_records() const {
    return pool_records_.load(std::memory_order_relaxed);
  }

 private:
  bool fail(const char* msg) {
    error = msg;
    return false;
  }

  // ---- BGZF layer ---------------------------------------------------------
  bool scan_blocks() {
    uint64_t off = 0;
    while (off + 18 <= (uint64_t)fsize_) {
      const uint8_t* p = map_ + off;
      if (p[0] != 0x1f || p[1] != 0x8b || p[2] != 8 || !(p[3] & 4))
        return fail("not a BGZF block (bad gzip magic)");
      uint16_t xlen;
      memcpy(&xlen, p + 10, 2);
      uint32_t bsize = 0;
      uint32_t xo = 12;
      bool found = false;
      while (xo + 4 <= 12u + xlen) {
        uint8_t si1 = p[xo], si2 = p[xo + 1];
        uint16_t slen;
        memcpy(&slen, p + xo + 2, 2);
        if (si1 == 66 && si2 == 67 && slen == 2) {
          uint16_t b;
          memcpy(&b, p + xo + 4, 2);
          bsize = (uint32_t)b + 1;
          found = true;
        }
        xo += 4 + slen;
      }
      if (!found) return fail("BGZF BC subfield missing");
      uint32_t data_off = 12 + xlen;
      if (off + bsize > (uint64_t)fsize_) return fail("truncated BGZF block");
      uint32_t csize = bsize - data_off - 8;
      uint32_t isize;
      memcpy(&isize, map_ + off + bsize - 4, 4);
      if (isize > (1u << 16)) return fail("BGZF block isize > 64KiB");
      blocks_.push_back({off, csize, isize, data_off});
      goff_.push_back(goff_.size() % kGroupBlocks == 0
                          ? 0
                          : goff_.back() + blocks_[blocks_.size() - 2].isize);
      off += bsize;
    }
    if (off != (uint64_t)fsize_ && fsize_ != 0)
      return fail("trailing garbage after last BGZF block");
    return true;
  }

  // ---- the pool -----------------------------------------------------------
  // Each worker takes a parse task (the oldest framed chunk) before an
  // inflate task (the next block whose slot the framer has freed), and
  // sleeps on work_cv_ while there is neither.  Scheduling state is guarded
  // by m_; results are published through Slot::block and Chunk::parsed, and
  // every finished task wakes the ordering thread (done_cv_).
  void worker() {
    Inflater inf;
    std::unique_lock<std::mutex> lk(m_);
    while (!stop_.load(std::memory_order_relaxed)) {
      if (parse_next_ < framed_seq_) {
        Chunk& c = chunks_[parse_next_++ % kGroups];
        if (work_left()) work_cv_.notify_one();
        lk.unlock();
        parse_chunk(c);
        c.parsed.store(true, std::memory_order_release);
      } else if (inflate_ready(next_block_)) {
        int64_t i = next_block_++;
        if (work_left()) work_cv_.notify_one();
        lk.unlock();
        inflate_block(inf, i);
      } else {
        work_cv_.wait(lk);
        continue;
      }
      lk.lock();
      done_cv_.notify_one();
    }
  }

  bool work_left() const {
    return parse_next_ < framed_seq_ || inflate_ready(next_block_);
  }

  // Block i may be inflated: its slot is free and (pipe) its member is read.
  bool inflate_ready(int64_t i) const {
    if (consumed_.load(std::memory_order_acquire) < i - kSlots + 1)
      return false;
    return streaming_ ? scanned_.load(std::memory_order_acquire) > i
                      : i < (int64_t)blocks_.size();
  }

  void inflate_block(Inflater& inf, int64_t i) {
    Slot& s = slots_[i % kSlots];
    const uint8_t* src;
    uint32_t csize, isize;
    if (streaming_) {
      const StreamBlock& b = sblocks_[i % kCSlots];
      src = b.raw.data() + b.data_off;
      csize = b.csize;
      isize = b.isize;
    } else {
      const BlockDesc& b = blocks_[i];
      src = map_ + b.offset + b.data_off;
      csize = b.csize;
      isize = b.isize;
    }
    // bounded by the block's own size: the group's next block lies after it
    int64_t got = inf.run(src, csize, block_data(i), isize);
    s.bad = got != (int64_t)isize;
    s.len = isize;
    s.block.store(i, std::memory_order_release);
  }

  // Parse task: the admission filter, then each admitted record's CIGAR
  // walked into blocks and gaps, into the chunk's own arrays.
  void parse_chunk(Chunk& c) {
    c.recs.clear();
    c.blk.clear();
    c.gap.clear();
    const uint8_t* prev_name = nullptr;
    uint32_t prev_len = 0;
    for (uint32_t r = 0; r < c.n_rec; r++) {
      const uint32_t off = c.rec_off[r];
      const bool in_side = off & kInSide;
      const uint8_t* p = in_side ? c.side.data() + (off & ~kInSide) : c.gdata + off;
      const uint32_t block_size = (uint32_t)rd_i32(p);
      const int32_t ref_id = rd_i32(p + 4);
      const int32_t posn = rd_i32(p + 8);
      const uint8_t l_read_name = p[12];
      const uint8_t mapq = p[13];
      const uint16_t n_cigar = rd_u16(p + 16);
      const uint16_t flag = rd_u16(p + 18);
      if ((flag & drop_mask_) || mapq < min_mapq_ || ref_id < 0 ||
          n_cigar == 0)
        continue;
      if (l_read_name == 0 || 32u + l_read_name + 4u * n_cigar > block_size) {
        // the name or the CIGAR would run past the record: stop the stream
        // at this record
        c.n_rec = r;
        c.end = kFail;
        c.err = "corrupt BAM record (read name or CIGAR past block_size)";
        break;
      }
      Rec x;
      x.idx = r;
      x.end = (in_side ? c.side_base : c.gbase) + (off & ~kInSide) + 4 + block_size;
      x.name = (const char*)p + 36;
      x.name_len = l_read_name - 1u;
      x.same_prev = !prev_name ? -1
                               : prev_len == x.name_len &&
                                     memcmp(prev_name, p + 36, prev_len) == 0;
      prev_name = p + 36;
      prev_len = x.name_len;
      x.ref_id = ref_id;
      x.blk0 = (uint32_t)(c.blk.size() / 2);
      x.gap0 = (uint32_t)(c.gap.size() / 2);
      const uint8_t* cig = p + 36 + l_read_name;
      int32_t cur = posn, blk_start = posn;
      bool open_block = false;
      for (int k = 0; k < n_cigar; k++) {
        uint32_t cg = rd_u32(cig + 4 * k);
        uint32_t op = cg & 0xF, ln = cg >> 4;
        bool is_gap = (op == 3);                                     // N
        bool consumes = (op == 0 || op == 2 || op == 7 || op == 8);  // M D = X
        if (is_gap && (int32_t)ln >= min_gap_) {
          if (open_block) {
            c.blk.push_back(blk_start);
            c.blk.push_back(cur);
            open_block = false;
          }
          c.gap.push_back(cur);
          c.gap.push_back(cur + (int32_t)ln);
          cur += ln;
          blk_start = cur;
        } else if (consumes) {
          if (!open_block) {
            blk_start = cur;
            open_block = true;
          }
          cur += ln;
        }
      }
      if (open_block) {
        c.blk.push_back(blk_start);
        c.blk.push_back(cur);
      }
      x.nblk = (uint32_t)(c.blk.size() / 2) - x.blk0;
      x.ngap = (uint32_t)(c.gap.size() / 2) - x.gap0;
      int read_rev = (flag & 0x10) ? 1 : 0;
      x.strand = (!(flag & 0x1) || (flag & 0x40)) ? read_rev : 1 - read_rev;
      c.recs.push_back(x);
    }
    pool_records_.fetch_add(c.n_rec, std::memory_order_relaxed);
  }

  // Waits on the pool until ready() holds; the time counts in pool_wait_ns.
  template <typename F>
  void await(F ready) {
    if (ready()) return;
    const auto t0 = std::chrono::steady_clock::now();
    bool now = false;
    for (int spins = 0; spins < 64 && !now; spins++) {
      std::this_thread::yield();
      now = ready();
    }
    if (!now) {
      std::unique_lock<std::mutex> lk(m_);
      done_cv_.wait(lk, ready);
    }
    stats_.pool_wait_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(
                               std::chrono::steady_clock::now() - t0)
                               .count();
  }

  // ---- streaming reader ----------------------------------------------------
  // Fill `n` bytes from fd_ (poll-loop so destruction can interrupt a wait on
  // a silent producer).  Returns n, 0 on clean EOF at a member boundary
  // (got==0), -1 on error / short read.
  int64_t read_full(uint8_t* dst, int64_t n) {
    int64_t got = 0;
    while (got < n) {
      if (stop_.load(std::memory_order_relaxed)) return -1;
      struct pollfd p {fd_, POLLIN, 0};
      int pr = poll(&p, 1, 200);
      if (pr < 0) return -1;
      if (pr == 0) continue;  // timeout: re-check stop_
      ssize_t r = ::read(fd_, dst + got, (size_t)(n - got));
      if (r < 0) return -1;
      if (r == 0) return got == 0 ? 0 : -1;  // EOF
      if (tee_fd_ >= 0) {
        // pass-through spool (--keep-bam --stream): a failed write must
        // FAIL the run — a silently truncated Unsorted.bam is corrupt
        // output the user has no signal about (disk full, closed sink)
        int64_t w = 0;
        while (w < r) {
          ssize_t ww = ::write(tee_fd_, dst + got + w, (size_t)(r - w));
          if (ww <= 0) {
            tee_fd_ = -1;
            tee_failed_.store(true, std::memory_order_release);
            return -1;
          }
          w += ww;
        }
      }
      got += r;
    }
    return got;
  }

  // One BGZF member -> ring slot.  1 = ok, 0 = clean EOF, -1 = corrupt.
  int read_member(StreamBlock& sb) {
    sb.raw.resize(1 << 16);
    int64_t r = read_full(sb.raw.data(), 12);
    if (r <= 0) return (int)r;
    const uint8_t* p = sb.raw.data();
    if (p[0] != 0x1f || p[1] != 0x8b || p[2] != 8 || !(p[3] & 4)) return -1;
    uint16_t xlen;
    memcpy(&xlen, p + 10, 2);
    // a valid BGZF member is <= 64KiB total; a corrupt xlen claiming more
    // would otherwise overflow the fixed ring buffer below
    if (12u + xlen + 8u > sb.raw.size()) return -1;
    if (read_full(sb.raw.data() + 12, xlen) != xlen) return -1;
    uint32_t bsize = 0, xo = 12;
    while (xo + 4 <= 12u + xlen) {
      uint8_t si1 = p[xo], si2 = p[xo + 1];
      uint16_t slen;
      memcpy(&slen, p + xo + 2, 2);
      if (si1 == 66 && si2 == 67 && slen == 2) {
        uint16_t b;
        memcpy(&b, p + xo + 4, 2);
        bsize = (uint32_t)b + 1;
      }
      xo += 4 + slen;
    }
    if (bsize == 0 || bsize > (1u << 16) || bsize < 12u + xlen + 8u) return -1;
    sb.data_off = 12 + xlen;
    int64_t rest = (int64_t)bsize - sb.data_off;
    if (read_full(sb.raw.data() + sb.data_off, rest) != rest) return -1;
    sb.csize = bsize - sb.data_off - 8;
    memcpy(&sb.isize, sb.raw.data() + bsize - 4, 4);
    if (sb.isize > (1u << 16)) return -1;
    return 1;
  }

  void reader() {
    int64_t i = 0;
    uint32_t goff = 0, prev_isize = 0;
    while (!stop_.load(std::memory_order_relaxed)) {
      StreamBlock& sb = sblocks_[i % kCSlots];
      // wait until the framer has taken member i-kCSlots
      int spins = 0;
      while (consumed_.load(std::memory_order_acquire) < i - kCSlots + 1) {
        if (stop_.load(std::memory_order_relaxed)) return;
        backoff(spins);
      }
      int rc = read_member(sb);
      if (rc <= 0) {
        if (rc < 0) stream_bad_.store(true, std::memory_order_release);
        stream_eof_.store(true, std::memory_order_release);
        { std::lock_guard<std::mutex> lk(m_); }
        done_cv_.notify_one();
        return;
      }
      goff = i % kGroupBlocks == 0 ? 0 : goff + prev_isize;
      sb.goff = goff;
      prev_isize = sb.isize;
      scanned_.store(i + 1, std::memory_order_release);
      { std::lock_guard<std::mutex> lk(m_); }
      work_cv_.notify_one();
      i++;
    }
  }

  // ---- blocks in order (ordering thread) -----------------------------------
  // Block i can be taken: inflated, past the end of the stream, or (file,
  // before the workers start) inflated inline.
  bool block_ready(int64_t i) const {
    if (streaming_) {
      if (slots_[i % kSlots].block.load(std::memory_order_acquire) == i)
        return true;
      return stream_eof_.load(std::memory_order_acquire) &&
             scanned_.load(std::memory_order_acquire) <= i;
    }
    return i >= (int64_t)blocks_.size() || workers_.empty() ||
           slots_[i % kSlots].block.load(std::memory_order_acquire) == i;
  }

  // Block i, once block_ready(i): 1 with its payload, 0 past the last block,
  // -1 with the error in *why.
  int block_at(int64_t i, const uint8_t** p, uint32_t* len, const char** why) {
    if (streaming_) {
      if (slots_[i % kSlots].block.load(std::memory_order_acquire) != i) {
        if (!stream_bad_.load(std::memory_order_acquire)) return 0;
        *why = tee_failed_.load(std::memory_order_acquire)
                   ? "tee write failed (--keep-bam sink: disk full?)"
                   : "corrupt BGZF member in stream";
        return -1;
      }
    } else if (i >= (int64_t)blocks_.size()) {
      return 0;
    }
    if (workers_.empty()) {
      *p = inflate_sync(i, len);
    } else {
      const Slot& s = slots_[i % kSlots];
      *p = s.bad ? nullptr : block_data(i);
      *len = s.len;
    }
    if (!*p) {
      *why = "corrupt BGZF block";
      return -1;
    }
    return 1;
  }

  // Block i's bytes: at its offset in its group's buffer.
  uint8_t* block_data(int64_t i) {
    const uint32_t goff = streaming_ ? sblocks_[i % kCSlots].goff : goff_[i];
    return gbuf_.get() + (i / kGroupBlocks) % kGroups * kGroupBytes + goff;
  }

  // The groups before the one holding block `upto` are free again: their
  // buffers (and their members' ring slots) may be refilled.
  void release(int64_t upto) {
    const int64_t free = upto / kGroupBlocks * kGroupBlocks;
    if (free <= consumed_.load(std::memory_order_relaxed)) return;
    consumed_.store(free, std::memory_order_release);
    if (workers_.empty()) return;
    { std::lock_guard<std::mutex> lk(m_); }
    work_cv_.notify_one();
  }

  // ---- rolling logical byte stream (header and resume) --------------------
  // ensure(n): at least n bytes available at buf_[pos_..]; false at EOF.
  // While workers_ is empty (header parse / resume repositioning) blocks are
  // inflated inline; afterwards they come from the worker slot ring.
  bool ensure(size_t n) {
    while (buf_.size() - pos_ < n) {
      const int64_t i = next_consume_;
      await([&] { return block_ready(i); });
      const uint8_t* p = nullptr;
      uint32_t len = 0;
      const char* why = nullptr;
      int rc = block_at(i, &p, &len, &why);
      if (rc <= 0) {
        if (rc < 0) error = why;
        return false;
      }
      if (pos_ > 0 && pos_ == buf_.size()) {
        buf_.clear();
        pos_ = 0;
      } else if (pos_ > (1 << 20)) {  // compact occasionally
        buf_.erase(buf_.begin(), buf_.begin() + pos_);
        pos_ = 0;
      }
      buf_.insert(buf_.end(), p, p + len);
      appended_ += len;
      stats_.blocks_inflated++;
      release(++next_consume_);
    }
    return true;
  }

  // Synchronous single-block inflate (header parse / resume, pre-workers).
  const uint8_t* inflate_sync(int64_t i, uint32_t* len) {
    const BlockDesc& b = blocks_[i];
    sync_buf_.resize(1 << 16);
    Inflater inf;
    int64_t got = inf.run(map_ + b.offset + b.data_off, b.csize,
                          sync_buf_.data(), (uint32_t)sync_buf_.size());
    if (got != (int64_t)b.isize) return nullptr;
    *len = b.isize;
    return sync_buf_.data();
  }

  // ---- resume token: (logical offset, pairing/carry state, stats) ---------
  // Format (little-endian): magic 'IRT1' u32 | tell u64 | stats i64[5] |
  // has_pending u8 | n_carry u8 | ParsedRead*  where ParsedRead =
  // name_len u32 | name | ref_id i32 | strand i32 | nb u32 | (s,e) i32 pairs
  // | ng u32 | (s,e) i32 pairs.  Shared byte-for-byte with the Python
  // decoder (io/bampy.py), so checkpoints are decoder-portable.
  static void put_read(std::vector<uint8_t>& out, const ReadView& r) {
    auto put = [&out](const void* p, size_t n) {
      const uint8_t* b = (const uint8_t*)p;
      out.insert(out.end(), b, b + n);
    };
    put(&r.name_len, 4);
    put(r.name, r.name_len);
    put(&r.ref_id, 4);
    put(&r.strand, 4);
    put(&r.nblk, 4);
    put(r.blk, 8 * (size_t)r.nblk);
    put(&r.ngap, 4);
    put(r.gap, 8 * (size_t)r.ngap);
  }

  std::vector<uint8_t> make_token() const {
    std::vector<uint8_t> out;
    auto put = [&out](const void* p, size_t n) {
      const uint8_t* b = (const uint8_t*)p;
      out.insert(out.end(), b, b + n);
    };
    uint32_t magic = 0x31545249;  // 'IRT1'
    put(&magic, 4);
    put(&tell_, 8);
    int64_t st[5] = {stats_.reads_total, stats_.reads_admitted,
                     stats_.fragments, stats_.pairs, stats_.singles};
    put(st, 40);
    uint8_t hp = pending_valid_ ? 1 : 0;
    uint8_t nc = have_pending_flush_ ? (uint8_t)carry_.n : 0;
    put(&hp, 1);
    put(&nc, 1);
    if (hp) put_read(out, pending_);
    for (uint8_t i = 0; i < nc; i++) put_read(out, carry_.r[i]);
    return out;
  }

  bool restore_token(const uint8_t* tok, int64_t len) {
    int64_t off = 0;
    auto get = [&](void* p, size_t n) -> bool {
      if (off + (int64_t)n > len) return false;
      memcpy(p, tok + off, n);
      off += n;
      return true;
    };
    auto get_pairs = [&](std::vector<int32_t>* v) -> bool {
      uint32_t n;
      if (!get(&n, 4) || off + 8 * (int64_t)n > len) return false;
      v->resize(2 * (size_t)n);
      return get(v->data(), 8 * (size_t)n);
    };
    auto get_read = [&](OwnedRead* r) -> bool {
      uint32_t nl;
      if (!get(&nl, 4) || off + nl > len) return false;
      r->name.assign((const char*)tok + off, nl);
      off += nl;
      return get(&r->ref_id, 4) && get(&r->strand, 4) && get_pairs(&r->blk) &&
             get_pairs(&r->gap);
    };
    uint32_t magic;
    int64_t target, st[5];
    uint8_t hp, nc;
    if (!get(&magic, 4) || magic != 0x31545249)
      return fail("bad resume token (magic)");
    if (!get(&target, 8) || !get(st, 40) || !get(&hp, 1) || !get(&nc, 1))
      return fail("bad resume token (truncated)");
    if (hp && !get_read(&pending_own_)) return fail("bad resume token (pending)");
    pending_valid_ = hp != 0;
    pending_owned_ = true;
    pending_ = pending_own_.view();
    if (nc > 2) return fail("bad resume token (carry)");
    carry_.n = 0;
    for (uint8_t i = 0; i < nc; i++) {
      if (!get_read(&carry_own_[i])) return fail("bad resume token (carry)");
      carry_.r[carry_.n++] = carry_own_[i].view();
    }
    have_pending_flush_ = nc > 0;
    stats_.reads_total = st[0];
    stats_.reads_admitted = st[1];
    stats_.fragments = st[2];
    stats_.pairs = st[3];
    stats_.singles = st[4];
    // reposition: find the block containing `target` by cumulative isize
    // (no inflation), reset the rolling buffer there — resume cost is
    // O(#blocks) header arithmetic, independent of position in the BAM
    int64_t cum = 0;
    size_t b = 0;
    while (b < blocks_.size() && cum + blocks_[b].isize <= target)
      cum += blocks_[b++].isize;
    if (b >= blocks_.size() && target != cum)
      return fail("resume offset beyond end of BAM");
    buf_.clear();
    pos_ = 0;
    next_consume_ = (int64_t)b;
    appended_ = cum;
    int64_t intra = target - cum;
    if (intra > 0) {
      if (!ensure((size_t)intra)) return fail("resume offset inside missing block");
      pos_ = (size_t)intra;
    }
    return true;
  }

  template <typename T>
  T get() {
    T v;
    memcpy(&v, buf_.data() + pos_, sizeof(T));
    pos_ += sizeof(T);
    return v;
  }

  bool parse_header() {
    if (!ensure(8)) return fail("truncated BAM header");
    if (memcmp(buf_.data() + pos_, "BAM\x01", 4) != 0)
      return fail("missing BAM magic");
    pos_ += 4;
    int32_t l_text = get<int32_t>();
    if (!ensure(l_text + 4)) return fail("truncated BAM header text");
    pos_ += l_text;
    int32_t n_ref = get<int32_t>();
    for (int i = 0; i < n_ref; i++) {
      if (!ensure(4)) return fail("truncated BAM ref list");
      int32_t l_name = get<int32_t>();
      if (!ensure((size_t)l_name + 4)) return fail("truncated BAM ref name");
      ref_names_.emplace_back((const char*)buf_.data() + pos_, l_name - 1);
      pos_ += l_name;
      ref_lens_.push_back(get<int32_t>());
    }
    return true;
  }

  // ---- framing (ordering thread) -------------------------------------------
  // The bytes after the header (or the resume offset) lead the first chunk.
  void start_framing() {
    lead_.assign(buf_.begin() + pos_, buf_.end());
    lead_base_ = tell_ = appended_ - (int64_t)(buf_.size() - pos_);
    std::vector<uint8_t>().swap(buf_);
    pos_ = 0;
    std::lock_guard<std::mutex> lk(m_);
    framed_seq_ = parse_next_ = emit_seq_ = next_consume_ / kGroupBlocks;
  }

  // Frames the records that end in group framed_seq_: first those in `side`
  // (the bytes carried over: a record begun in an earlier group, completed
  // from this group's buffer, or after the header whole records too), then
  // those in place in the group buffer, taking the group's blocks in order;
  // true once the chunk is published.  Without `wait` it returns false
  // where it needs a block that is not inflated yet.  A block is taken only
  // when the record being framed needs its bytes, so an error surfaces after
  // the same records as in a record-by-record parse.
  bool frame_more(bool wait) {
    Chunk& c = chunks_[framed_seq_ % kGroups];
    if (!filling_) {
      c.side.swap(lead_);
      c.side_base = c.end_pos = lead_base_;
      c.gdata = gbuf_.get() + framed_seq_ % kGroups * kGroupBytes;
      c.rec_off.clear();
      c.parsed.store(false, std::memory_order_relaxed);
      sfo_ = fo_ = gend_ = 0;
      group_taken_ = false;
      filling_ = true;
    }
    while (true) {
      while (c.side.size() - sfo_ >= 4) {
        int32_t block_size = rd_i32(c.side.data() + sfo_);
        if (block_size < 32)
          return publish(c, kFail, "corrupt BAM record (block_size < 32)");
        if (c.side.size() - sfo_ - 4 < (size_t)block_size) break;
        c.rec_off.push_back(kInSide | (uint32_t)sfo_);
        sfo_ += 4 + (size_t)block_size;
        c.end_pos = c.side_base + (int64_t)sfo_;
      }
      const bool straddling = c.side.size() > sfo_;
      if (!straddling) {
        while (gend_ - fo_ >= 4) {
          // the walk is a chain of dependent loads through bytes another
          // core inflated: fetch ahead of it
          __builtin_prefetch(c.gdata + fo_ + 8192);
          int32_t block_size = rd_i32(c.gdata + fo_);
          if (block_size < 32)
            return publish(c, kFail, "corrupt BAM record (block_size < 32)");
          if (gend_ - fo_ - 4 < (size_t)block_size) break;
          c.rec_off.push_back((uint32_t)fo_);
          fo_ += 4 + (size_t)block_size;
          c.end_pos = c.gbase + (int64_t)fo_;
        }
      }
      // more bytes: the group's next block
      const int64_t i = next_consume_;
      if (group_taken_ && i % kGroupBlocks == 0) return publish(c, kMore, "");
      if (!block_ready(i)) {
        if (!wait) return false;
        await([&] { return block_ready(i); });
      }
      const uint8_t* p = nullptr;
      uint32_t len = 0;
      const char* why = nullptr;
      int rc = block_at(i, &p, &len, &why);
      if (rc < 0) return publish(c, kFail, why);
      if (rc == 0) {
        // 1-3 trailing bytes end the stream cleanly, as in bampy
        const size_t partial = straddling ? c.side.size() - sfo_ : gend_ - fo_;
        if (partial >= 4) return publish(c, kFail, "truncated BAM record");
        return publish(c, kEof, "");
      }
      if (!group_taken_) {  // the group's first block taken: place its buffer
        const size_t goff = p - c.gdata;
        c.gbase = appended_ - (int64_t)goff;
        fo_ = gend_ = goff;
        group_taken_ = true;
      }
      block_starts_.push_back(appended_);
      appended_ += len;
      gend_ += len;
      next_consume_++;
      if (straddling) {
        // carry the begun record on with this block's bytes: its header
        // first, then the rest as far as this block holds it
        size_t have = c.side.size() - sfo_;
        size_t want = have < 4 ? 4 : 4 + (size_t)rd_i32(c.side.data() + sfo_);
        while (have < want && fo_ < gend_) {
          const size_t t = std::min(want - have, gend_ - fo_);
          c.side.insert(c.side.end(), c.gdata + fo_, c.gdata + fo_ + t);
          fo_ += t;
          have += t;
          if (have == 4 && want == 4) {
            const int32_t block_size = rd_i32(c.side.data() + sfo_);
            if (block_size < 32) break;  // refused above, on the next pass
            want = 4 + (size_t)block_size;
          }
        }
      }
    }
  }

  // Hands the chunk to the pool; a record begun and not ended in its group
  // leads the next chunk.
  bool publish(Chunk& c, int end, const char* why) {
    c.n_rec = (uint32_t)c.rec_off.size();
    c.end = end;
    c.err = why;
    if (c.side.size() > sfo_) {
      if (sfo_ == 0) {
        lead_.swap(c.side);
      } else {
        lead_.assign(c.side.begin() + sfo_, c.side.end());
        c.side.resize(sfo_);
      }
    } else {
      lead_.assign(c.gdata + fo_, c.gdata + gend_);
    }
    lead_base_ = c.end_pos;
    filling_ = false;
    framing_done_ = end != kMore;
    {
      std::lock_guard<std::mutex> lk(m_);
      framed_seq_++;
    }
    work_cv_.notify_one();
    return true;
  }

  bool framer_has_room() const {
    return !framing_done_ && framed_seq_ < emit_seq_ + kGroups;
  }

  // The chunk emit_seq_, parsed.  Frames ahead first, as far as free chunk
  // slots and inflated blocks allow, so the pool has chunks to parse.
  Chunk* await_chunk() {
    Chunk& c = chunks_[emit_seq_ % kGroups];
    while (true) {
      while (framer_has_room() && frame_more(false)) {
      }
      if (emit_seq_ == framed_seq_) {  // still being filled: finish it
        frame_more(true);
        continue;
      }
      if (c.parsed.load(std::memory_order_acquire)) return &c;
      await([&] {
        return c.parsed.load(std::memory_order_acquire) ||
               (framer_has_room() && block_ready(next_consume_));
      });
    }
  }

  // ---- pairing and emission (ordering thread) ------------------------------
  // 1 = the next admitted read in *out (with *same: its name equals the
  // previous admitted read's, or -1 where unknown), 0 = end of stream, -1 =
  // error.  The counts, the offset and the blocks inflated move as a
  // record-by-record parse would have moved them on reaching this read.
  int next_admitted_read(ReadView* out, int* same) {
    while (true) {
      if (!cc_) {
        cc_ = await_chunk();
        ai_ = 0;
        rec_done_ = 0;
      }
      Chunk& c = *cc_;
      if (ai_ < c.recs.size()) {
        const Rec& x = c.recs[ai_++];
        stats_.reads_total += x.idx + 1 - rec_done_;
        rec_done_ = x.idx + 1;
        stats_.reads_admitted++;
        tell_ = x.end;
        while (!block_starts_.empty() && block_starts_.front() < tell_) {
          block_starts_.pop_front();
          stats_.blocks_inflated++;
        }
        out->name = x.name;
        out->name_len = x.name_len;
        out->ref_id = x.ref_id;
        out->strand = x.strand;
        out->blk = c.blk.data() + 2 * (size_t)x.blk0;
        out->nblk = x.nblk;
        out->gap = c.gap.data() + 2 * (size_t)x.gap0;
        out->ngap = x.ngap;
        *same = x.same_prev;
        return 1;
      }
      stats_.reads_total += c.n_rec - rec_done_;
      rec_done_ = c.n_rec;
      tell_ = c.end_pos;
      if (c.end != kMore) {  // the last chunk stays current: the end repeats
        stats_.blocks_inflated += (int64_t)block_starts_.size();
        block_starts_.clear();
        if (c.end == kEof) return 0;
        error = c.err;
        return -1;
      }
      // retire the chunk; a pending mate in it is copied out first
      if (pending_valid_ && !pending_owned_) {
        pending_own_.assign(pending_);
        pending_ = pending_own_.view();
        pending_owned_ = true;
      }
      cc_ = nullptr;
      release(++emit_seq_ * kGroupBlocks);
    }
  }

  // Returns false when the current batch was full: the fragment is stashed
  // and the caller must return the (now complete) batch.
  bool try_emit(Frag& frag) {
    int64_t nb = 0, ng = 0;
    // group mates by ref_id in first-seen order (bampy dict semantics)
    int nf = (frag.n == 2 && frag.r[0].ref_id != frag.r[1].ref_id) ? 2 : 1;
    for (int k = 0; k < frag.n; k++) {
      nb += frag.r[k].nblk;
      ng += frag.r[k].ngap;
    }
    if (cur_.would_overflow(nb, ng, nf)) {
      if (cur_.n_frags == 0) {
        // an empty batch cannot hold this fragment: corrupt/absurd CIGAR.
        // Drop it (do NOT write past the fixed buffers) and surface an error.
        error = "fragment exceeds batch capacity (corrupt CIGAR?)";
        frag.n = 0;
        return true;
      }
      carry_ = frag;
      have_pending_flush_ = true;
      return false;
    }
    emit_fragment(frag);
    return true;
  }

  void emit_fragment(const Frag& frag) {
    // first-seen-order refid groups (<=2 mates)
    int32_t rids[2];
    int n_groups = 0;
    for (int k = 0; k < frag.n; k++) {
      bool seen = false;
      for (int g = 0; g < n_groups; g++) seen |= (rids[g] == frag.r[k].ref_id);
      if (!seen) rids[n_groups++] = frag.r[k].ref_id;
    }
    for (int g = 0; g < n_groups; g++) {
      int32_t rid = rids[g];
      int32_t chrom =
          (rid >= 0 && rid < (int32_t)lut_.size()) ? lut_[rid] : -1;
      int32_t strand = -1;
      int64_t span_lo = -1, span_hi = -1;
      int32_t nblk = 0;
      for (int k = 0; k < frag.n; k++) {
        const ReadView& r = frag.r[k];
        if (r.ref_id != rid) continue;
        if (strand < 0) strand = r.strand;
        for (uint32_t b = 0; b < r.nblk; b++) {
          const int32_t s = r.blk[2 * b], e = r.blk[2 * b + 1];
          nblk++;
          int64_t i = cur_.n_blocks++;
          cur_.blk_chrom[i] = chrom;
          cur_.blk_start[i] = s;
          cur_.blk_end[i] = e;
          cur_.blk_strand[i] = strand;
          span_lo = span_lo < 0 ? s : std::min(span_lo, (int64_t)s);
          span_hi = std::max(span_hi, (int64_t)e);
        }
        for (uint32_t q = 0; q < r.ngap; q++) {
          int64_t i = cur_.n_gaps++;
          cur_.gap_chrom[i] = chrom;
          cur_.gap_start[i] = r.gap[2 * q];
          cur_.gap_end[i] = r.gap[2 * q + 1];
          cur_.gap_strand[i] = strand;
        }
      }
      int64_t i = cur_.n_frags++;
      cur_.frag_chrom[i] = chrom;
      cur_.frag_refid[i] = rid;
      cur_.frag_start[i] = span_lo < 0 ? 0 : (int32_t)span_lo;
      cur_.frag_end[i] = span_hi < 0 ? 0 : (int32_t)span_hi;
      cur_.frag_strand[i] = strand < 0 ? 0 : strand;
      cur_.frag_nblk[i] = nblk;
    }
    cur_.n_reads += frag.n;
  }

  int fd_ = -1;
  int64_t fsize_ = 0;
  const uint8_t* map_ = nullptr;
  std::vector<BlockDesc> blocks_;
  Slot slots_[kSlots];
  std::vector<std::thread> workers_;
  std::atomic<int64_t> consumed_{0};  // blocks the framer has taken
  std::atomic<bool> stop_{false};
  int64_t next_consume_ = 0;          // the next block the framer takes

  // pool scheduling, guarded by m_
  std::mutex m_;
  std::condition_variable work_cv_;  // workers: a task may be ready
  std::condition_variable done_cv_;  // ordering thread: a task finished
  int64_t next_block_ = 0;           // the next block to inflate
  uint64_t parse_next_ = 0;          // the next chunk to parse
  uint64_t framed_seq_ = 0;          // chunks published (written under m_)
  std::atomic<int64_t> pool_records_{0};

  // streaming mode state
  bool streaming_ = false;
  int tee_fd_ = -1;
  std::thread reader_;
  StreamBlock sblocks_[kCSlots];
  std::atomic<int64_t> scanned_{0};
  std::atomic<bool> stream_eof_{false};
  std::atomic<bool> stream_bad_{false};
  std::atomic<bool> tee_failed_{false};

  // header and resume: the rolling buffer
  std::vector<uint8_t> buf_;
  std::vector<uint8_t> sync_buf_;
  size_t pos_ = 0;
  int64_t appended_ = 0;  // total inflated bytes ever taken in
  int32_t drop_mask_ = kFlagDropMask;
  int32_t min_mapq_ = kMinMapq;
  int32_t min_gap_ = kMinGapAsJunction;
  std::vector<std::string> ref_names_;
  std::vector<int64_t> ref_lens_;
  std::vector<int32_t> lut_;

  // framing; chunks_[g % kGroups] frames, parses and emits group g's records
  Chunk chunks_[kGroups];
  std::unique_ptr<uint8_t[]> gbuf_;  // the group buffers
  std::vector<uint32_t> goff_;  // file: each block's offset in its group
  std::vector<uint8_t> lead_;   // bytes carried to the next chunk's side
  int64_t lead_base_ = 0;
  // the chunk being filled: its next unframed bytes in side and in the group
  // buffer, and the end of the group buffer's bytes taken so far
  size_t sfo_ = 0, fo_ = 0, gend_ = 0;
  bool group_taken_ = false;  // a block of its group has been taken
  bool filling_ = false;
  bool framing_done_ = false;
  // logical starts of the blocks the framer has taken and the emitter has
  // not yet reached (blocks_inflated counts a block once a read needs it)
  std::deque<int64_t> block_starts_;

  // emission
  uint64_t emit_seq_ = 0;  // the group whose chunk is being emitted
  Chunk* cc_ = nullptr;
  size_t ai_ = 0;          // its next admitted record
  uint32_t rec_done_ = 0;  // its records counted in reads_total
  int64_t tell_ = 0;       // logical offset just past the last read taken
  ReadView pending_;
  bool pending_valid_ = false;
  bool pending_owned_ = false;  // pending_ views pending_own_
  OwnedRead pending_own_;
  Frag carry_;
  OwnedRead carry_own_[2];
  bool have_pending_flush_ = false;

  BatchBuf cur_;
  Stats stats_;
};

}  // namespace

// ---- C ABI -----------------------------------------------------------------
extern "C" {

typedef struct {
  int32_t *blk_chrom, *blk_start, *blk_end, *blk_strand;
  int32_t *gap_chrom, *gap_start, *gap_end, *gap_strand;
  int32_t *frag_chrom, *frag_refid, *frag_start, *frag_end, *frag_strand;
  int32_t *frag_nblk;
  int64_t n_blocks, n_gaps, n_frags, n_reads;
  int64_t cap_blocks, cap_gaps, cap_frags;
} BdBatchView;

// bd_open_ex2: bd_open_ex plus explicit batch geometry (blocks/gaps column
// capacity as multiples of cap_frags — io/batch.py BLOCKS_PER_FRAG or the
// LONGREAD_* geometry for many-block single-end alignments)
void* bd_open_ex2(const char* path, int64_t cap_frags, int n_threads,
                  int32_t flag_drop_mask, int32_t min_mapq, int32_t min_gap,
                  const uint8_t* token, int64_t token_len,
                  int64_t blocks_per_frag, int64_t gaps_per_frag) {
  auto* d = new Decoder();
  if (!d->open(path, cap_frags, n_threads, flag_drop_mask, min_mapq, min_gap,
               token, token_len, blocks_per_frag, gaps_per_frag)) {
    // keep handle so the error is retrievable; caller must bd_close
  }
  return d;
}

void* bd_open_ex(const char* path, int64_t cap_frags, int n_threads,
                 int32_t flag_drop_mask, int32_t min_mapq, int32_t min_gap,
                 const uint8_t* token, int64_t token_len) {
  return bd_open_ex2(path, cap_frags, n_threads, flag_drop_mask, min_mapq,
                     min_gap, token, token_len, 3, 1);
}

void* bd_open(const char* path, int64_t cap_frags, int n_threads) {
  return bd_open_ex(path, cap_frags, n_threads, kFlagDropMask, kMinMapq,
                    kMinGapAsJunction, nullptr, 0);
}

// Streaming (pipe) mode: count straight off an fd carrying a BGZF BAM stream
// (the aligner's stdout in FastQ --stream).  The fd is dup()ed — the caller
// keeps ownership of its descriptor.  tee_fd >= 0 spools the raw stream
// (--keep-bam) as it is read.  Resume is not supported on pipes.
void* bd_open_fd(int fd, int64_t cap_frags, int n_threads,
                 int32_t flag_drop_mask, int32_t min_mapq, int32_t min_gap,
                 int64_t blocks_per_frag, int64_t gaps_per_frag, int tee_fd) {
  auto* d = new Decoder();
  if (!d->open_fd(fd, cap_frags, n_threads, flag_drop_mask, min_mapq, min_gap,
                  blocks_per_frag, gaps_per_frag, tee_fd)) {
    // keep handle so the error is retrievable; caller must bd_close
  }
  return d;
}

// Serialize the resume token for the CURRENT position (call between
// bd_next_batch calls).  Returns bytes written, or the required size when
// buflen is too small; pass buflen=0 to size the buffer.
int64_t bd_token(void* h, uint8_t* buf, int64_t buflen) {
  auto tok = static_cast<Decoder*>(h)->token();
  if ((int64_t)tok.size() <= buflen && buf) memcpy(buf, tok.data(), tok.size());
  return (int64_t)tok.size();
}

const char* bd_error(void* h) { return static_cast<Decoder*>(h)->error.c_str(); }

int bd_n_refs(void* h) { return static_cast<Decoder*>(h)->n_refs(); }

int bd_ref_name(void* h, int i, char* buf, int buflen) {
  const std::string& s = static_cast<Decoder*>(h)->ref_name(i);
  int n = (int)s.size();
  if (n + 1 > buflen) return -1;
  memcpy(buf, s.c_str(), n + 1);
  return n;
}

int64_t bd_ref_len(void* h, int i) {
  return static_cast<Decoder*>(h)->ref_len(i);
}

void bd_set_chrom_lut(void* h, const int32_t* lut, int64_t n) {
  static_cast<Decoder*>(h)->set_lut(lut, n);
}

int bd_next_batch(void* h, BdBatchView* out) {
  auto* d = static_cast<Decoder*>(h);
  if (!d->error.empty()) return -1;
  BatchBuf* b = nullptr;
  int rc = d->next_batch(&b);
  if (rc <= 0) return rc;
  out->blk_chrom = b->blk_chrom.data();
  out->blk_start = b->blk_start.data();
  out->blk_end = b->blk_end.data();
  out->blk_strand = b->blk_strand.data();
  out->gap_chrom = b->gap_chrom.data();
  out->gap_start = b->gap_start.data();
  out->gap_end = b->gap_end.data();
  out->gap_strand = b->gap_strand.data();
  out->frag_chrom = b->frag_chrom.data();
  out->frag_refid = b->frag_refid.data();
  out->frag_start = b->frag_start.data();
  out->frag_end = b->frag_end.data();
  out->frag_strand = b->frag_strand.data();
  out->frag_nblk = b->frag_nblk.data();
  out->n_blocks = b->n_blocks;
  out->n_gaps = b->n_gaps;
  out->n_frags = b->n_frags;
  out->n_reads = b->n_reads;
  out->cap_blocks = b->cap_blocks;
  out->cap_gaps = b->cap_gaps;
  out->cap_frags = b->cap_frags;
  return 1;
}

// reads_total, reads_admitted, fragments, pairs, singles, blocks_inflated,
// pool_records (records parsed by pool workers), pool_wait_ns (the ordering
// thread's waits on the pool)
void bd_stats(void* h, int64_t* out8) {
  const auto* d = static_cast<Decoder*>(h);
  const Stats& s = d->stats();
  out8[0] = s.reads_total;
  out8[1] = s.reads_admitted;
  out8[2] = s.fragments;
  out8[3] = s.pairs;
  out8[4] = s.singles;
  out8[5] = s.blocks_inflated;
  out8[6] = d->pool_records();
  out8[7] = s.pool_wait_ns;
}

// Semantics constants baked into this binary, for drift checks from Python.
void bd_semantics(int32_t* out3) {
  out3[0] = kFlagDropMask;
  out3[1] = kMinMapq;
  out3[2] = kMinGapAsJunction;
}

void bd_close(void* h) { delete static_cast<Decoder*>(h); }

}  // extern "C"

#ifdef BAMDECODE_MAIN
// Smoke driver for sanitizer builds (tests/test_torch_bamdecode.py):
// bamdecode FILE.bam|- [threads] decodes a file, or with "-" a BGZF stream
// on stdin through the pipe path, and prints a checksum of every batch
// column and the counts.
int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s file.bam|- [threads]\n", argv[0]);
    return 2;
  }
  int threads = argc > 2 ? atoi(argv[2]) : 4;
  void* h = (argv[1][0] == '-' && argv[1][1] == 0)
                ? bd_open_fd(0, 1 << 12, threads, kFlagDropMask, kMinMapq,
                             kMinGapAsJunction, 3, 1, -1)
                : bd_open(argv[1], 1 << 12, threads);
  if (bd_error(h)[0]) {
    fprintf(stderr, "open error: %s\n", bd_error(h));
    bd_close(h);
    return 1;
  }
  int n = bd_n_refs(h);
  std::vector<int32_t> lut(n);
  for (int i = 0; i < n; i++) lut[i] = i;
  bd_set_chrom_lut(h, lut.data(), n);
  uint64_t sum = 0;
  int64_t batches = 0;
  BdBatchView v;
  int rc;
  while ((rc = bd_next_batch(h, &v)) == 1) {
    batches++;
    for (int64_t i = 0; i < v.n_blocks; i++)
      sum = sum * 1315423911u + v.blk_chrom[i] + v.blk_start[i] + v.blk_end[i];
    for (int64_t i = 0; i < v.n_gaps; i++)
      sum = sum * 1315423911u + v.gap_start[i] + v.gap_end[i];
    for (int64_t i = 0; i < v.n_frags; i++)
      sum = sum * 1315423911u + v.frag_refid[i] + v.frag_strand[i];
    uint8_t tok[4096];
    int64_t tn = bd_token(h, tok, sizeof(tok));
    for (int64_t i = 0; i < tn && tn <= (int64_t)sizeof(tok); i++)
      sum = sum * 31u + tok[i];
  }
  if (rc < 0) {
    fprintf(stderr, "decode error: %s\n", bd_error(h));
    bd_close(h);
    return 1;
  }
  int64_t st[8];
  bd_stats(h, st);
  printf("batches=%lld checksum=%llu total=%lld admitted=%lld frags=%lld "
         "pool_records=%lld\n",
         (long long)batches, (unsigned long long)sum, (long long)st[0],
         (long long)st[1], (long long)st[2], (long long)st[6]);
  bd_close(h);
  return 0;
}
#endif
