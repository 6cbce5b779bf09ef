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
//      the parity test fuzzes this)
//   2  string-pool column: int32 per-row index into a shared pool given as
//      (blob, offsets[n_pool+1]) — covers chrom/name/strand/warning columns
//
// Cells are tab-separated, rows newline-terminated.  Returns a malloc'd
// buffer (caller frees with tf_free).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

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

}  // namespace

extern "C" {

// Render a table.  col_types[n_cols], col_ptrs[n_cols] (int64_t* / double* /
// int32_t* per type).  pool_blob/pool_off describe the shared string pool
// (pool_off has n_pool+1 entries; pool index i spans
// [pool_off[i], pool_off[i+1])).  out_len receives the byte length.
// Returns nullptr on allocation failure or an out-of-range pool index.
char* tf_format(
    int64_t n_rows, int32_t n_cols, const int32_t* col_types,
    const void* const* col_ptrs, const char* pool_blob,
    const int64_t* pool_off, int64_t n_pool, int64_t* out_len) {
    // capacity bound: widest cell per column
    int64_t per_row = 0;
    int64_t max_str = 0;
    for (int64_t i = 0; i < n_pool; ++i) {
        int64_t w = pool_off[i + 1] - pool_off[i];
        if (w > max_str) max_str = w;
    }
    for (int32_t c = 0; c < n_cols; ++c) {
        switch (col_types[c]) {
            case 0: per_row += 21; break;        // -9.2e18 worst case
            case 1: per_row += 32; break;        // %g worst (incl. inf/nan)
            case 2: per_row += max_str; break;
            default: return nullptr;
        }
        per_row += 1;  // separator / newline
    }
    int64_t cap = per_row * n_rows + 16;
    char* buf = static_cast<char*>(malloc(static_cast<size_t>(cap)));
    if (!buf) return nullptr;
    char* p = buf;
    for (int64_t r = 0; r < n_rows; ++r) {
        for (int32_t c = 0; c < n_cols; ++c) {
            switch (col_types[c]) {
                case 0:
                    p += i64toa(static_cast<const int64_t*>(col_ptrs[c])[r], p);
                    break;
                case 1:
                    p += snprintf(
                        p, 32, "%g",
                        static_cast<const double*>(col_ptrs[c])[r]);
                    break;
                case 2: {
                    int32_t idx = static_cast<const int32_t*>(col_ptrs[c])[r];
                    if (idx < 0 || idx >= n_pool) {
                        free(buf);
                        return nullptr;
                    }
                    int64_t o0 = pool_off[idx], o1 = pool_off[idx + 1];
                    memcpy(p, pool_blob + o0, static_cast<size_t>(o1 - o0));
                    p += o1 - o0;
                    break;
                }
            }
            *p++ = (c + 1 == n_cols) ? '\n' : '\t';
        }
    }
    *out_len = p - buf;
    return buf;
}

void tf_free(char* p) { free(p); }

}  // extern "C"
