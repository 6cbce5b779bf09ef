// Audic–Claverie exact test, native implementation (SURVEY.md §2 row 18;
// historical src/winflat/winflat.c [R] — snapshot is a tombstone, math
// reconstructed from Audic & Claverie, Genome Res 1997).  The pure-Python
// irfinder_tpu/winflat.py is the conformance spec; tests assert agreement to
// 1e-12.  Batch API so the differential path makes ONE ctypes call for all
// introns instead of one Python loop iteration each.

#include <cmath>
#include <cstdint>

namespace {

double log_p_y_given_x(double x, double y, double r) {
  return y * std::log(r) + std::lgamma(x + y + 1.0) - std::lgamma(x + 1.0) -
         std::lgamma(y + 1.0) - (x + y + 1.0) * std::log1p(r);
}

void tail_p(int64_t x, int64_t y, double nx, double ny, double* p_le,
            double* p_ge) {
  double r = ny / nx;
  double acc = 0.0;
  for (int64_t k = 0; k <= y; k++) acc += std::exp(log_p_y_given_x(x, k, r));
  double le = acc < 1.0 ? acc : 1.0;
  double point = std::exp(log_p_y_given_x(x, y, r));
  double ge = 1.0 - le + point;
  *p_le = le;
  *p_ge = ge < 1.0 ? ge : 1.0;
}

}  // namespace

extern "C" {

double wf_log_p(int64_t x, int64_t y, double r) {
  return log_p_y_given_x((double)x, (double)y, r);
}

void wf_tail_p(int64_t x, int64_t y, double nx, double ny, double* p_le,
               double* p_ge) {
  tail_p(x, y, nx, ny, p_le, p_ge);
}

double wf_pvalue(int64_t x, int64_t y, double nx, double ny) {
  double le, ge;
  tail_p(x, y, nx, ny, &le, &ge);
  double p = 2.0 * (le < ge ? le : ge);
  return p < 1.0 ? p : 1.0;
}

// Vectorized two-sided p-values: one call for the whole intron table.
void wf_pvalues(const int64_t* x, const int64_t* y, const double* nx,
                const double* ny, double* out, int64_t n) {
  for (int64_t i = 0; i < n; i++)
    out[i] = wf_pvalue(x[i], y[i], nx[i], ny[i]);
}

}  // extern "C"
