// Batched celerite GP log-likelihood for Hopper (sm_90a), float and double.
//
// Replaces the Pallas TPU kernel `pallas_log_likelihood`
// (mind_the_gaps_tpu/ops/pallas_celerite.py): its packed-symmetric body
// `_make_kernel_sym`, and with the template flag DENSE (the entry's
// `dense_s` argument) its dense-S body `_make_kernel`, which keeps S as the
// full R x R.  For B parameter draws over one sorted time grid it returns
//
//     out[b] = log N(y_b | mean[b], K(theta_b) + diag_b + extra_diag[b])
//
// with the local-phase celerite recursion of solver/batched.py:
//
//     M   = S + D_prev W W^T                 (packed symmetric, R(R+1)/2)
//     S   = P M P^T,  P = blockdiag(exp(-c dt), exp(-c dt) Rot(d dt))
//     D   = A_n - u^T S u,   W = (v - S u) / D
//     f   = P (f + W_prev z_prev),   z = r_n - u^T f
//     logdet += log|D|,  quad += z^2 / D      (Kahan-compensated)
//
// and -inf when any pivot D is not positive (or is NaN).
//
// Design.  One thread per likelihood, a sequential loop over time, the
// whole state (S, W, f, D, z, two Kahan pairs, the ok flag) in registers;
// the celerite widths JR (real terms) and JC (complex pairs) are template
// parameters, so every loop over R = JR + 2 JC is unrolled and every array
// index is a constant.  Propagators are computed in the step from dt (no
// (N, R, B) tables).  Data is batch-last: y and diag are (N, cols) with
// cols = 1 (shared), G (grouped: thread b reads column b / repeats) or B
// (per element), so the threads of a warp read neighbouring addresses.
//
// What bounds it on this card: latency.  Each step is a dependent chain of
// about R^2/2 multiply-adds, a division and a log; nothing is reused
// between threads, and at the observed-fit batch (16 likelihoods) the
// whole launch is one partial warp on one SM, at the bootstrap batch
// (513 x 6) about 25 blocks of 128 threads on 132 SMs.  The design does
// nothing about that yet beyond loading each step's data one step ahead.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC (no --use_fast_math: approximate exp/sin/cos/div and
// flushed denormals would break the float32 accuracy contract).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

template <int R>
__device__ __forceinline__ constexpr int pidx(int i, int j) {
  // packed upper-triangle index of (min(i,j), max(i,j))
  return i <= j ? i * R - (i * (i - 1)) / 2 + (j - i) : j * R - (j * (j - 1)) / 2 + (i - j);
}

// index of S(i, j): packed symmetric, or row-major R x R when DENSE
template <int R, bool DENSE>
__device__ __forceinline__ constexpr int sidx(int i, int j) {
  return DENSE ? i * R + j : pidx<R>(i, j);
}

template <typename T>
__device__ __forceinline__ T dev_exp(T x);
template <>
__device__ __forceinline__ float dev_exp<float>(float x) { return expf(x); }
template <>
__device__ __forceinline__ double dev_exp<double>(double x) { return exp(x); }

template <typename T>
__device__ __forceinline__ void dev_sincos(T x, T* s, T* c);
template <>
__device__ __forceinline__ void dev_sincos<float>(float x, float* s, float* c) { sincosf(x, s, c); }
template <>
__device__ __forceinline__ void dev_sincos<double>(double x, double* s, double* c) { sincos(x, s, c); }

template <typename T>
__device__ __forceinline__ T dev_log(T x);
template <>
__device__ __forceinline__ float dev_log<float>(float x) { return logf(x); }
template <>
__device__ __forceinline__ double dev_log<double>(double x) { return log(x); }

template <typename T>
__device__ __forceinline__ T neg_inf();
template <>
__device__ __forceinline__ float neg_inf<float>() { return __int_as_float(0xff800000); }
template <>
__device__ __forceinline__ double neg_inf<double>() {
  return __longlong_as_double(0xfff0000000000000LL);
}

// Row i of P applied to a vector given by the functor x(k):
// real row i < JR:          er[i] x(i)
// complex pair first row a: cs x(a) - sn x(a+1)
// complex pair second row:  sn x(a) + cs x(a+1)
template <typename T, int JR, typename F>
__device__ __forceinline__ T prop_row(int i, const T* er, const T* cs, const T* sn, F x) {
  if (i < JR) return er[i] * x(i);
  const int k = (i - JR) >> 1;
  const int a = JR + 2 * k;
  if (((i - JR) & 1) == 0) return cs[k] * x(a) - sn[k] * x(a + 1);
  return sn[k] * x(a) + cs[k] * x(a + 1);
}

template <typename T, int JR, int JC, bool DENSE>
__global__ void __launch_bounds__(kThreads)
celerite_loglike_kernel(const T* __restrict__ dt, const T* __restrict__ y, int y_cols,
                        const T* __restrict__ diag, int d_cols,
                        const T* __restrict__ ar, const T* __restrict__ cr,
                        const T* __restrict__ ac, const T* __restrict__ bc,
                        const T* __restrict__ cc, const T* __restrict__ dc,
                        const T* __restrict__ mean, const T* __restrict__ extra_diag,
                        int B, int N, int repeats, T* __restrict__ out) {
  constexpr int R = JR + 2 * JC;
  constexpr int NS = DENSE ? R * R : R * (R + 1) / 2;
  constexpr int JRs = JR > 0 ? JR : 1;
  constexpr int JCs = JC > 0 ? JC : 1;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  // ---- per-element constants --------------------------------------- //
  T crv[JRs], ccv[JCs], dcv[JCs];
  T u[R], v[R];
  T k0 = extra_diag ? extra_diag[b] : T(0);
#pragma unroll
  for (int j = 0; j < JR; ++j) {
    const T a = ar[b * JR + j];
    crv[j] = cr[b * JR + j];
    u[j] = a;
    v[j] = T(1);
    k0 += a;
  }
#pragma unroll
  for (int k = 0; k < JC; ++k) {
    const T a = ac[b * JC + k];
    ccv[k] = cc[b * JC + k];
    dcv[k] = dc[b * JC + k];
    u[JR + 2 * k] = a;
    u[JR + 2 * k + 1] = bc[b * JC + k];
    v[JR + 2 * k] = T(1);
    v[JR + 2 * k + 1] = T(0);
    k0 += a;
  }
  const T m = mean ? mean[b] : T(0);
  const long long ycol = (y_cols == 1) ? 0 : b / repeats;
  const long long dcol = (d_cols == 1) ? 0 : b / repeats;

  // ---- step 0 ------------------------------------------------------ //
  T S[NS];
#pragma unroll
  for (int q = 0; q < NS; ++q) S[q] = T(0);
  T f[R];
  T W[R];
  const T r0 = y[ycol] - m;
  const T A0 = diag[dcol] + k0;
  T D = A0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    W[i] = v[i] / A0;
    f[i] = T(0);
  }
  T z = r0;
  T logdet = dev_log<T>(fabs(A0)), lc = T(0);
  T quad = r0 * r0 / A0, qc = T(0);
  bool ok = A0 > T(0);

  // data of the next step, loaded one step ahead
  T h_nx = T(0), y_nx = T(0), d_nx = T(0);
  if (N > 1) {
    h_nx = dt[1];
    y_nx = y[(long long)y_cols + ycol];
    d_nx = diag[(long long)d_cols + dcol];
  }

  for (int n = 1; n < N; ++n) {
    const T h = h_nx;
    const T rn = y_nx - m;
    const T An = d_nx + k0;
    if (n + 1 < N) {
      h_nx = dt[n + 1];
      y_nx = y[(long long)(n + 1) * y_cols + ycol];
      d_nx = diag[(long long)(n + 1) * d_cols + dcol];
    }

    T er[JRs], cs[JCs], sn[JCs];
#pragma unroll
    for (int j = 0; j < JR; ++j) er[j] = dev_exp<T>(-crv[j] * h);
#pragma unroll
    for (int k = 0; k < JC; ++k) {
      const T e = dev_exp<T>(-ccv[k] * h);
      T s, c;
      dev_sincos<T>(dcv[k] * h, &s, &c);
      cs[k] = e * c;
      sn[k] = e * s;
    }

    // M = S + D W W^T (upper triangle, or all of it when DENSE)
    T Mp[NS];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = DENSE ? 0 : i; j < R; ++j)
        Mp[sidx<R, DENSE>(i, j)] = S[sidx<R, DENSE>(i, j)] + D * W[i] * W[j];
    }
    // Tm = P M (full R x R)
    T Tm[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int c = 0; c < R; ++c)
        Tm[i][c] = prop_row<T, JR>(i, er, cs, sn, [&](int k) { return Mp[sidx<R, DENSE>(k, c)]; });
    }
    // S = Tm P^T, upper triangle only (all of it when DENSE)
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int c = DENSE ? 0 : i; c < R; ++c)
        S[sidx<R, DENSE>(i, c)] = prop_row<T, JR>(c, er, cs, sn, [&](int k) { return Tm[i][k]; });
    }

    T Su[R];
    T uSu = T(0);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      T acc = S[sidx<R, DENSE>(i, 0)] * u[0];
#pragma unroll
      for (int j = 1; j < R; ++j) acc += S[sidx<R, DENSE>(i, j)] * u[j];
      Su[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) uSu += Su[i] * u[i];
    const T Dn = An - uSu;
    const T Dinv = T(1) / Dn;

    // f = P (f + W_prev z_prev)
    T g[R];
#pragma unroll
    for (int i = 0; i < R; ++i) g[i] = f[i] + W[i] * z;
    T uf = T(0);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      f[i] = prop_row<T, JR>(i, er, cs, sn, [&](int k) { return g[k]; });
      uf += u[i] * f[i];
    }
    z = rn - uf;
#pragma unroll
    for (int i = 0; i < R; ++i) W[i] = (v[i] - Su[i]) * Dinv;
    D = Dn;

    // Kahan-compensated sums
    const T x1 = dev_log<T>(fabs(Dn)) - lc;
    const T t1 = logdet + x1;
    lc = (t1 - logdet) - x1;
    logdet = t1;
    const T x2 = z * z * Dinv - qc;
    const T t2 = quad + x2;
    qc = (t2 - quad) - x2;
    quad = t2;
    ok = ok && (Dn > T(0));
  }

  const T ll = T(-0.5) * (quad + logdet + T(double(N) * 1.8378770664093453));  // N log(2 pi)
  out[b] = ok ? ll : neg_inf<T>();
}

template <typename T, int JR, int JC, bool DENSE>
int launch(const T* dt, const T* y, int y_cols, const T* diag, int d_cols, const T* ar,
           const T* cr, const T* ac, const T* bc, const T* cc, const T* dc, const T* mean,
           const T* extra_diag, int B, int N, int repeats, T* out, cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  celerite_loglike_kernel<T, JR, JC, DENSE><<<blocks, kThreads, 0, stream>>>(
      dt, y, y_cols, diag, d_cols, ar, cr, ac, bc, cc, dc, mean, extra_diag, B, N, repeats, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int Jr, int Jc, int dense_s, const T* dt, const T* y, int y_cols, const T* diag,
             int d_cols, const T* ar, const T* cr, const T* ac, const T* bc, const T* cc, const T* dc,
             const T* mean, const T* extra_diag, int B, int N, int repeats, T* out,
             cudaStream_t stream) {
  if (B <= 0 || N <= 0 || repeats <= 0) return -2;
#define CELERITE_CASE(JR_, JC_)                                                              \
  if (Jr == JR_ && Jc == JC_)                                                                \
    return dense_s ? launch<T, JR_, JC_, true>(dt, y, y_cols, diag, d_cols, ar, cr, ac, bc, cc, \
                                               dc, mean, extra_diag, B, N, repeats, out, stream) \
                   : launch<T, JR_, JC_, false>(dt, y, y_cols, diag, d_cols, ar, cr, ac, bc, cc,\
                                                dc, mean, extra_diag, B, N, repeats, out, stream);
  // every (Jr, Jc) with 1 <= Jr + 2 Jc <= 6
  CELERITE_CASE(1, 0) CELERITE_CASE(2, 0) CELERITE_CASE(3, 0)
  CELERITE_CASE(4, 0) CELERITE_CASE(5, 0) CELERITE_CASE(6, 0)
  CELERITE_CASE(0, 1) CELERITE_CASE(1, 1) CELERITE_CASE(2, 1)
  CELERITE_CASE(3, 1) CELERITE_CASE(4, 1)
  CELERITE_CASE(0, 2) CELERITE_CASE(1, 2) CELERITE_CASE(2, 2)
  CELERITE_CASE(0, 3)
#undef CELERITE_CASE
  return -1;  // unsupported (Jr, Jc)
}

}  // namespace

// C entry points.  Pointers are device pointers; mean and extra_diag may be
// null; dense_s != 0 selects the dense-S body.  Returns 0 on success, -1
// for an unsupported (Jr, Jc), -2 for a bad size, otherwise the cudaError_t
// of the launch.
extern "C" int celerite_loglike_f32(int Jr, int Jc, int dense_s, const void* dt, const void* y,
                                    int y_cols, const void* diag, int d_cols, const void* ar, const void* cr,
                                    const void* ac, const void* bc, const void* cc,
                                    const void* dc, const void* mean, const void* extra_diag,
                                    int B, int N, int repeats, void* out, void* stream) {
  using T = float;
  return dispatch<T>(Jr, Jc, dense_s, (const T*)dt, (const T*)y, y_cols, (const T*)diag, d_cols,
                     (const T*)ar, (const T*)cr, (const T*)ac, (const T*)bc, (const T*)cc,
                     (const T*)dc, (const T*)mean, (const T*)extra_diag, B, N, repeats, (T*)out,
                     (cudaStream_t)stream);
}

extern "C" int celerite_loglike_f64(int Jr, int Jc, int dense_s, const void* dt, const void* y,
                                    int y_cols, const void* diag, int d_cols, const void* ar, const void* cr,
                                    const void* ac, const void* bc, const void* cc,
                                    const void* dc, const void* mean, const void* extra_diag,
                                    int B, int N, int repeats, void* out, void* stream) {
  using T = double;
  return dispatch<T>(Jr, Jc, dense_s, (const T*)dt, (const T*)y, y_cols, (const T*)diag, d_cols,
                     (const T*)ar, (const T*)cr, (const T*)ac, (const T*)bc, (const T*)cc,
                     (const T*)dc, (const T*)mean, (const T*)extra_diag, B, N, repeats, (T*)out,
                     (cudaStream_t)stream);
}
