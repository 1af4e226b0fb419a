// Kraft, Burrows & Nousek (1991) posterior median and 68% minimal (HPD)
// interval of a source with N total counts over a known background B, one
// thread an (N, B), float64 throughout.
//
// It replaces no Pallas kernel: the JAX package computes these quantities
// with XLA's elementwise bisections (mind_the_gaps_tpu/stats.py,
// kraft_posterior_median and kraft_hpd_interval), and the port's plain
// version (stats.py) runs the same bisections as eager PyTorch operations,
// about 43,000 launches for a table of 16 counts x 5,000 bins.  This kernel
// runs the same bisections with the same numbers of steps, brackets and
// tests, each thread holding its own in registers, in one launch.
//
// The posterior at x >= 0 is f(x) = e^-(x+B) (x+B)^N / (N! Q(N+1, B)), with
// Q the regularized upper incomplete gamma function, and
//     log f(x) = -(x+B) + N log(max(x+B, 1e-300)) - lgamma(N+1) - log Q(N+1, B)
//     CDF(x)   = 1 - Q(N+1, x+B) / Q(N+1, B)
// (N log(x+B) taken as 0 at N = 0).  For a whole N, Q(N+1, y) is the
// Poisson probability of at most N counts at mean y, a finite sum of
// N + 1 terms, each the last times y / n.
//
//   median: 70 bisection steps of CDF(x) - 1/2 on [0, upper];
//   interval: 60 bisection steps of the density level log_lam on
//     [log f(mode) - 60, log f(mode)], mode = max(N - B, 0); at each level
//     the ends a <= mode <= b solve log f(x) = log_lam by 70-step
//     bisections on [0, mode] and [mode, upper], a = 0 where
//     log f(0) >= log_lam, and the level rises while the mass
//     CDF(b) - CDF(a) is at least cl.
//
// What bounds it: float64 operations.  Each thread evaluates log f 8,540
// times (61 levels x 2 ends x 70 steps), one float64 log each, and Q 192
// times (an exp and N + 1 terms each); its bytes are
// 8 in and 24 out.  The design gives those operations to the card's float64
// pipes: one thread an (N, B) with no shared memory or barrier, the two
// ends' bisections interleaved in one loop (two independent log chains a
// thread, so a scheduler has twice the independent work to issue), every
// bracket in registers, and the terms that do not depend on x (Q(N+1, B),
// lgamma(N+1), the mode, log f at 0 and at the mode) taken once a thread.
// The sums of log f are rounded as the plain version rounds them (no
// fused multiply-add), so the two differ by the log's, exp's and lgamma's
// last bits and the order of Q's terms.
//
// Without nvcc (__CUDACC__ undefined) the per-element routines are plain
// C++, so a host harness can hold them against the plain version.

#include <cfloat>
#include <cmath>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define KT_DEV __device__ __forceinline__
#else
#define KT_DEV inline
#endif

namespace kraft {

constexpr int kInnerIters = 70;      // steps of each end's bisection and of the median's
constexpr double kLevelDepth = 60.0;  // the level bracket's depth below the mode's log density
constexpr double kTiny = 1e-300;     // the floor of x + B under the log
constexpr double kDirect = 700.0;    // e^-y is a normal float64 up to here
constexpr int kThreads = 128;

#ifdef __CUDACC__
KT_DEV double mul(double a, double b) { return __dmul_rn(a, b); }
KT_DEV double add(double a, double b) { return __dadd_rn(a, b); }
KT_DEV double sub(double a, double b) { return __dsub_rn(a, b); }
#else
KT_DEV double mul(double a, double b) { return a * b; }
KT_DEV double add(double a, double b) { return a + b; }
KT_DEV double sub(double a, double b) { return a - b; }
#endif

// Q(N + 1, y) for a whole N >= 0: e^-y sum_{n <= N} y^n / n!.  Where e^-y
// is a normal number (y <= 700) the terms are summed from n = 0, each the
// last times y / n, so Q carries a few roundings a term; beyond, the
// terms rise to n0 = min(N, floor(y)) and fall after it, and the sum is
// e^(log term n0) times the terms' ratios to it, each at most 1, summed
// outward.  Either loop stops where a term underflows to 0.  Q(., 0) = 1,
// Q(., inf) = 0, NaN for y < 0 or NaN (gammaincc's conventions).
KT_DEV double poisson_q(double N, double y) {
  if (!(y >= 0.0)) return NAN;
  if (y == 0.0) return 1.0;
  if (y > DBL_MAX) return 0.0;
  if (y <= kDirect) {
    double term = exp(-y);
    double sum = term;
    for (double n = 1.0; n <= N && term > 0.0; n += 1.0) {
      term = term * y / n;
      sum += term;
    }
    return sum;
  }
  const double n0 = fmin(N, floor(y));
  const double log_peak = -y + n0 * log(y) - lgamma(n0 + 1.0);
  double sum = 1.0;
  double r = 1.0;
  for (double n = n0; n > 0.0 && r > 0.0; n -= 1.0) {  // terms n0 - 1 down to 0
    r = r * n / y;
    sum += r;
  }
  r = 1.0;
  for (double n = n0 + 1.0; n <= N && r > 0.0; n += 1.0) {  // terms n0 + 1 up to N
    r = r * y / n;
    sum += r;
  }
  return exp(log_peak) * sum;
}

struct Posterior {
  double N, B, qB, log_norm, log_qB;

  KT_DEV Posterior(double n, double b) : N(n), B(b) {
    qB = poisson_q(N, B);
    log_norm = lgamma(N + 1.0);
    log_qB = log(qB);
  }

  KT_DEV double cdf(double x) const { return 1.0 - poisson_q(N, x + B) / qB; }

  KT_DEV double log_pdf(double x) const {
    const double t = x + B;
    const double log_term = N > 0.0 ? mul(N, log(t < kTiny ? kTiny : t)) : 0.0;  // NaN passes the floor
    return sub(sub(add(-t, log_term), log_norm), log_qB);
  }
};

// The median: 70 bisection steps of CDF(x) - 1/2 on [0, upper].
KT_DEV double median(const Posterior& p, double upper) {
  double lo = 0.0, hi = upper;
  for (int k = 0; k < kInnerIters; ++k) {
    const double mid = 0.5 * (lo + hi);
    const bool below = p.cdf(mid) - 0.5 < 0.0;
    lo = below ? mid : lo;
    hi = below ? hi : mid;
  }
  return 0.5 * (lo + hi);
}

// The ends (a, b) at the density level log_lam, and the mass between them.
KT_DEV double interval_mass(const Posterior& p, double mode, double upper, double log_p0, double log_lam,
                            double* a, double* b) {
  double alo = 0.0, ahi = mode;   // log f rises on [0, mode]
  double blo = mode, bhi = upper;  // and falls on [mode, upper]
  for (int k = 0; k < kInnerIters; ++k) {
    const double am = 0.5 * (alo + ahi);
    const double bm = 0.5 * (blo + bhi);
    const bool a_below = sub(p.log_pdf(am), log_lam) < 0.0;
    const bool b_below = -sub(p.log_pdf(bm), log_lam) < 0.0;
    alo = a_below ? am : alo;
    ahi = a_below ? ahi : am;
    blo = b_below ? bm : blo;
    bhi = b_below ? bhi : bm;
  }
  *a = log_p0 >= log_lam ? 0.0 : 0.5 * (alo + ahi);
  *b = 0.5 * (blo + bhi);
  return p.cdf(*b) - p.cdf(*a);
}

// The minimal interval of mass cl: 60 bisection steps of the level.
KT_DEV void hpd_interval(const Posterior& p, double upper, double cl, int level_iters, double* a, double* b) {
  const double d = p.N - p.B;
  const double m = d < 0.0 ? 0.0 : d;  // the mode; NaN passes, as in clamp
  const double log_pmax = p.log_pdf(m);
  const double log_p0 = p.log_pdf(0.0);
  double lo = log_pmax - kLevelDepth, hi = log_pmax;
  for (int k = 0; k < level_iters; ++k) {
    const double mid = 0.5 * (lo + hi);
    const bool too_small = interval_mass(p, m, upper, log_p0, mid, a, b) < cl;  // the level is too high
    lo = too_small ? lo : mid;
    hi = too_small ? mid : hi;
  }
  interval_mass(p, m, upper, log_p0, 0.5 * (lo + hi), a, b);
}

// A count the finite sum can take: a whole number >= 0.
KT_DEV bool whole_count(double N) { return N >= 0.0 && N <= DBL_MAX && N == floor(N); }

// Element i of a (rows, cols) grid: N = counts[i], or the row if counts is
// null; B = background[col].  NaN for a count that is not whole.
KT_DEV void element(long long i, const double* counts, const double* background, long long cols, double upper,
                    double cl, int level_iters, double* med, double* lo, double* hi) {
  const long long row = i / cols;
  const double N = counts ? counts[i] : (double)row;
  const double B = background[i - row * cols];
  if (!whole_count(N)) {
    if (med) med[i] = NAN;
    if (lo) lo[i] = hi[i] = NAN;
    return;
  }
  const Posterior p(N, B);
  if (med) med[i] = median(p, upper);
  if (lo) {
    double a, b;
    hpd_interval(p, upper, cl, level_iters, &a, &b);
    lo[i] = a;
    hi[i] = b;
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(kThreads) tables_kernel(const double* __restrict__ counts,
                                                          const double* __restrict__ background, long long n,
                                                          long long cols, double upper, double cl, int level_iters,
                                                          double* __restrict__ med, double* __restrict__ lo,
                                                          double* __restrict__ hi) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) element(i, counts, background, cols, upper, cl, level_iters, med, lo, hi);
}
#endif

}  // namespace kraft

#ifdef __CUDACC__
// C entry point.  A (rows, cols) grid of float64 device arrays: `counts`
// holds N at each element (rows * cols of them) or is null, and then N is
// the row; `background` holds B for each column.  `median` (or null)
// receives the medians, `lo` and `hi` (both or neither) the interval's
// ends, each rows * cols contiguous.  Returns 0, -2 for bad arguments, or
// the cudaError_t of the launch.
extern "C" int kraft_tables_f64(const void* counts, const void* background, long long rows, long long cols,
                                double upper, double cl, int level_iters, void* median, void* lo, void* hi,
                                void* stream) {
  if (rows <= 0 || cols <= 0 || level_iters < 0 || (lo == nullptr) != (hi == nullptr) ||
      (median == nullptr && lo == nullptr) || background == nullptr)
    return -2;
  const long long n = rows * cols;
  const long long blocks = (n + kraft::kThreads - 1) / kraft::kThreads;
  if (n / cols != rows || blocks > 2147483647LL) return -2;
  kraft::tables_kernel<<<(unsigned)blocks, kraft::kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)counts, (const double*)background, n, cols, upper, cl, level_iters, (double*)median,
      (double*)lo, (double*)hi);
  return static_cast<int>(cudaGetLastError());
}
#endif
