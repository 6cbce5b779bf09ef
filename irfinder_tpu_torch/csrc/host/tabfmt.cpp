// tabfmt: bulk tab-separated table emission (C ABI, ctypes-bound).
//
// TPU-native equivalent of the reference's C++ iostream output writers
// (SURVEY.md §2 row 16, historical src/irfinder/ReadBlockProcessor output
// paths [R]): the engine finalizes counters into COLUMN ARRAYS, and this
// routine renders a whole table in one GIL-released call — the per-line
// Python f-string loop in irfinder_tpu/format.py (kept as the formatting
// SPEC and fallback; byte-parity is suite-tested) costs ~1-7 us/row and
// dominated the multi-sample finalize drain (config D) and the whole-genome
// junction table (config C).
//
// Column kinds:
//   0  int64  column  (custom itoa — %lld snprintf is ~20x slower)
//   1  double column, C printf "%g" (snprintf: glibc's correctly-rounded
//      dtoa is exactly what Python's f"{v:g}" produces for finite doubles;
//      the parity test fuzzes this); a NaN is "nan" whatever its sign bit,
//      as Python writes it (printf writes "-nan" for the NaN that x86
//      arithmetic makes, e.g. inf / inf)
//   2  string-pool column: int32 per-row index into the column's own pool
//      given as (blob, offsets[n_pool+1]) — covers chrom/name/strand/warning
//      columns
//
// A table renders in n_chunks contiguous row chunks: chunk 0 on the calling
// thread, each other chunk on a thread of its own, each into its own buffer;
// the chunks are then joined into one buffer.  A cell renders the same way
// in every chunk, so the bytes do not depend on the chunk count.
//
// Cells are tab-separated, rows newline-terminated.  Returns a malloc'd
// buffer (caller frees with tf_free).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// unsigned 64-bit itoa into p; returns chars written
inline int u64toa(uint64_t v, char* p) {
    char tmp[20];
    int n = 0;
    do {
        tmp[n++] = static_cast<char>('0' + (v % 10));
        v /= 10;
    } while (v);
    for (int i = 0; i < n; ++i) p[i] = tmp[n - 1 - i];
    return n;
}

inline int i64toa(int64_t v, char* p) {
    if (v < 0) {
        *p = '-';
        return 1 + u64toa(static_cast<uint64_t>(-(v + 1)) + 1u, p + 1);
    }
    return u64toa(static_cast<uint64_t>(v), p);
}

struct Table {
    int32_t n_cols;
    const int32_t* col_types;
    const void* const* col_ptrs;
    const char* const* pool_blobs;
    const int64_t* const* pool_offs;
    const int64_t* pool_ns;
    int64_t per_row;  // capacity bound of one row
};

// One chunk's rows [r0, r1) rendered into a buffer of its own.
struct Chunk {
    int64_t r0 = 0, r1 = 0;
    char* buf = nullptr;
    int64_t len = 0;
    bool ok = false;
};

void render(const Table& t, Chunk& ch) {
    char* buf = static_cast<char*>(
        malloc(static_cast<size_t>(t.per_row * (ch.r1 - ch.r0) + 16)));
    if (!buf) return;
    char* p = buf;
    for (int64_t r = ch.r0; r < ch.r1; ++r) {
        for (int32_t c = 0; c < t.n_cols; ++c) {
            switch (t.col_types[c]) {
                case 0:
                    p += i64toa(static_cast<const int64_t*>(t.col_ptrs[c])[r], p);
                    break;
                case 1: {
                    double v = static_cast<const double*>(t.col_ptrs[c])[r];
                    if (std::isnan(v)) {
                        memcpy(p, "nan", 3);
                        p += 3;
                    } else {
                        p += snprintf(p, 32, "%g", v);
                    }
                    break;
                }
                case 2: {
                    int32_t idx = static_cast<const int32_t*>(t.col_ptrs[c])[r];
                    if (idx < 0 || idx >= t.pool_ns[c]) {
                        free(buf);
                        return;
                    }
                    const int64_t* off = t.pool_offs[c];
                    int64_t o0 = off[idx], o1 = off[idx + 1];
                    memcpy(p, t.pool_blobs[c] + o0, static_cast<size_t>(o1 - o0));
                    p += o1 - o0;
                    break;
                }
            }
            *p++ = (c + 1 == t.n_cols) ? '\n' : '\t';
        }
    }
    ch.buf = buf;
    ch.len = p - buf;
    ch.ok = true;
}

}  // namespace

extern "C" {

// Render a table.  col_types[n_cols], col_ptrs[n_cols] (int64_t* / double* /
// int32_t* per type).  For a string column c, pool_blobs[c]/pool_offs[c]
// describe its pool of pool_ns[c] strings (pool_offs[c] has pool_ns[c]+1
// entries; index i spans [pool_offs[c][i], pool_offs[c][i+1])); the three
// are not read for other columns.  n_chunks (clamped to [1, n_rows]) row
// chunks render at once.  out_len receives the byte length.  Returns nullptr
// on allocation failure or an out-of-range pool index in any chunk.
char* tf_format(
    int64_t n_rows, int32_t n_cols, const int32_t* col_types,
    const void* const* col_ptrs, const char* const* pool_blobs,
    const int64_t* const* pool_offs, const int64_t* pool_ns,
    int32_t n_chunks, int64_t* out_len) {
    // capacity bound: widest cell per column
    int64_t per_row = 0;
    for (int32_t c = 0; c < n_cols; ++c) {
        switch (col_types[c]) {
            case 0: per_row += 21; break;        // -9.2e18 worst case
            case 1: per_row += 32; break;        // %g worst (incl. inf/nan)
            case 2: {
                int64_t max_str = 0;
                for (int64_t i = 0; i < pool_ns[c]; ++i) {
                    int64_t w = pool_offs[c][i + 1] - pool_offs[c][i];
                    if (w > max_str) max_str = w;
                }
                per_row += max_str;
                break;
            }
            default: return nullptr;
        }
        per_row += 1;  // separator / newline
    }
    const Table t{n_cols, col_types, col_ptrs, pool_blobs, pool_offs, pool_ns, per_row};

    int64_t k = n_chunks;
    if (k > n_rows) k = n_rows;
    if (k < 1) k = 1;
    std::vector<Chunk> chunks(static_cast<size_t>(k));
    for (int64_t i = 0; i < k; ++i) {
        chunks[i].r0 = n_rows * i / k;
        chunks[i].r1 = n_rows * (i + 1) / k;
    }
    // chunks 1..k-1 on threads of their own; a chunk whose thread cannot
    // start renders on the calling thread there and then
    std::vector<std::thread> threads;
    for (int64_t i = 1; i < k; ++i) {
        try {
            threads.emplace_back(render, std::cref(t), std::ref(chunks[i]));
        } catch (...) {
            render(t, chunks[i]);
        }
    }
    render(t, chunks[0]);
    for (std::thread& th : threads) th.join();

    bool ok = true;
    int64_t total = 0;
    for (const Chunk& ch : chunks) {
        ok = ok && ch.ok;
        total += ch.len;
    }
    char* out = nullptr;
    if (ok) {
        // chunk 0's buffer grows to hold the whole table (no copy of its rows)
        out = (k == 1) ? chunks[0].buf
                       : static_cast<char*>(realloc(chunks[0].buf, static_cast<size_t>(total + 16)));
        if (out) {
            chunks[0].buf = nullptr;
            char* p = out + chunks[0].len;
            for (int64_t i = 1; i < k; ++i) {
                memcpy(p, chunks[i].buf, static_cast<size_t>(chunks[i].len));
                p += chunks[i].len;
            }
            *out_len = total;
        }
    }
    for (Chunk& ch : chunks) free(ch.buf);
    return out;
}

void tf_free(char* p) { free(p); }

}  // extern "C"
