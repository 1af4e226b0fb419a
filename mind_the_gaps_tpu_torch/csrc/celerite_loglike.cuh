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
//
// and the sums of log|D_n| and z_n^2 / D_n taken chunk by chunk: the 32
// terms of a chunk of 32 steps are summed as a pairwise tree of
// neighbours, ((x0 + x1) + (x2 + x3)) + ..., and the chunk sums are added
// with Kahan compensation.  The plain version (solver/batched.py) sums in
// the same order.  Any pivot D that is not positive (or NaN) gives -inf.
//
// What bounds it on this card: at small batches the latency of the chain,
// at large ones instruction issue.  Each step is a dependent chain of about
// R^2/2 multiply-adds and one reciprocal beside ~30 operations that do not
// depend on the state (exp, sincos, log, a division).  Three layouts, L
// lanes a likelihood, each run 32 steps (a chunk) at a time:
//
// L = 32 or 8, a team (one warp a block of 32 / L teams), for small batches,
// where a thread a likelihood leaves most of the card's schedulers empty and
// the chain's latency sets the time.  It takes off the chain everything that
// does not depend on the state:
//   A. the team copies the chunk's dt, y and diag into shared memory one
//      chunk ahead (cp.async, double-buffered), and computes each step's
//      propagators exp(-c dt), exp(-c dt) cos / sin(d dt) and data
//      r_n = y_n - mean, A_n = diag_n + k0, 32 / L steps per lane;
//   B. one chain lane runs the S / D / W and f / z recursions (interleaved,
//      `chain_step`) over the 32 steps: multiply-adds and one reciprocal a
//      step, no load from device memory and no transcendental; it writes
//      D_n, z_n;
//   C. the team takes log|D_n| and z_n^2 / D_n of the chunk in parallel and
//      sums them as the tree above (each lane its own steps in shared
//      memory, then across lanes by shuffles), then Kahan-adds the chunk sum.
// L = 32 is for the smallest batches; L = 8 keeps the warps few enough to
// issue while phases A and C stay short (4 steps a lane).
//
// L = 1, a thread a likelihood (`lane_kernel`, kLaneBlock threads a block),
// for large batches, where the teams' chain phase issues with 1 lane in L
// working.  Every lane works: in one loop body with no branch around it,
// the thread computes step k+1's propagators and data (they do not depend
// on the state) beside step k's `chain_step`, so the scheduler overlaps
// their latency with the chain's; then it adds log|D_n| and z_n^2 / D_n to
// a stack of five partial sums that builds the chunk's pairwise tree
// exactly, and Kahan-adds the chunk sum.  The block stages the chunk's dt
// (and y and diag when they are one shared column) in shared memory as the
// teams do; grouped and per-element columns are read from the batch-last
// arrays, neighbouring threads on neighbouring words.  The three layouts run
// the same operations in the same order and give the same bits.
//
// The wrapper (ops/celerite.py, `team_size`) picks L from the likelihoods an
// SM, at crossovers measured on an H100 (PERF.md section 6): 32 up to
// WARP_TEAM_MAX_PER_SM, 1 from LANE_LAYOUT_MIN_PER_SM, 8 between.  Up to
// ~128 likelihoods an SM, one thread a likelihood puts at most one warp on
// each scheduler, whose chain latency nothing hides: 1.7-2.7 ms (float32,
// R = 3, N = 5000) whatever the batch, so below ~100 an SM the teams are
// faster; at ~496 an SM it is 3.2x faster than L = 8.  The dense-S and
// runtime-R bodies keep the team layouts.

// The celerite widths JR (real terms) and JC (complex pairs) are template
// parameters up to R = JR + 2 JC = 8 for the pairs of
// CELERITE_STATIC_PAIRS, so every loop over R is unrolled and the state
// lives in registers.  Any
// other (Jr, Jc) runs the runtime-R body (JR = JC = kRuntime, L = 32): its
// state (S as the full R x R) lives in shared memory, and the whole warp
// runs the chain, each lane taking entries of each product.
//
// Data is batch-last: y and diag are (N, cols) with cols = 1 (shared),
// G (grouped: likelihood b reads column b / repeats) or B (per element).
// L = 1 exists for the packed body at the compile-time widths.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC (no --use_fast_math: approximate exp/sin/cos/div and
// flushed denormals would break the float32 accuracy contract).

#pragma once

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <math.h>

namespace celerite {

constexpr int kChunk = 32;     // steps a team handles per round
constexpr int kRuntime = -1;   // JR = JC = kRuntime: the runtime-R body
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory a launch gets without opting in

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

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ void dev_sincos(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void dev_sincos(double x, double* s, double* c) { sincos(x, s, c); }
__device__ __forceinline__ float dev_log(float x) { return logf(x); }
__device__ __forceinline__ double dev_log(double x) { return log(x); }

template <typename T>
__device__ __forceinline__ T neg_inf() {
  return sizeof(T) == 4 ? T(__int_as_float(0xff800000)) : T(__longlong_as_double(0xfff0000000000000LL));
}

template <typename T>
__device__ __forceinline__ void kahan_add(T& s, T& c, T x) {
  const T yk = x - c;
  const T tk = s + yk;
  c = (tk - s) - yk;
  s = tk;
}

// Row i of P applied to a vector given by the functor x(k):
// real row i < jr:          er[i] x(i)
// complex pair first row a: cs x(a) - sn x(a+1)
// complex pair second row:  sn x(a) + cs x(a+1)
template <typename T, typename F>
__device__ __forceinline__ T prop_row(int i, int jr, const T* er, const T* cs, const T* sn, F x) {
  if (i < jr) return er[i] * x(i);
  const int k = (i - jr) >> 1;
  const int a = jr + 2 * k;
  if (((i - jr) & 1) == 0) return cs[k] * x(a) - sn[k] * x(a + 1);
  return sn[k] * x(a) + cs[k] * x(a + 1);
}

// One step of the chain at the compile-time widths (phase B's body, and
// the L = 1 layout's): from the state S, W, f, D = D_{n-1}, z = z_{n-1} and
// step n's propagators (er, cs, sn), A_n and r_n, the state of step n; D and
// z become D_n and z_n.  S is packed symmetric, or R x R when DENSE.
template <typename T, int JR, int JC, bool DENSE>
__device__ __forceinline__ void chain_step(T* S, T* W, T* f, const T* u, T& D, T& z, const T* er,
                                           const T* cs, const T* sn, T A, T r) {
  constexpr int R_ = JR + 2 * JC;
  constexpr int NS = DENSE ? R_ * R_ : R_ * (R_ + 1) / 2;
  // M = S + D W W^T (upper triangle, or all of it when DENSE)
  T Mp[NS];
#pragma unroll
  for (int i = 0; i < R_; ++i) {
#pragma unroll
    for (int j = DENSE ? 0 : i; j < R_; ++j)
      Mp[sidx<R_, DENSE>(i, j)] = S[sidx<R_, DENSE>(i, j)] + D * W[i] * W[j];
  }
  // Tm = P M (full R x R); S = Tm P^T (upper triangle unless DENSE)
  T Tm[R_][R_];
#pragma unroll
  for (int i = 0; i < R_; ++i) {
#pragma unroll
    for (int col = 0; col < R_; ++col)
      Tm[i][col] = prop_row(i, JR, er, cs, sn, [&](int q) { return Mp[sidx<R_, DENSE>(q, col)]; });
  }
#pragma unroll
  for (int i = 0; i < R_; ++i) {
#pragma unroll
    for (int col = DENSE ? 0 : i; col < R_; ++col)
      S[sidx<R_, DENSE>(i, col)] = prop_row(col, JR, er, cs, sn, [&](int q) { return Tm[i][q]; });
  }
  T Su[R_];
  T uSu = T(0);
#pragma unroll
  for (int i = 0; i < R_; ++i) {
    T acc = S[sidx<R_, DENSE>(i, 0)] * u[0];
#pragma unroll
    for (int j = 1; j < R_; ++j) acc += S[sidx<R_, DENSE>(i, j)] * u[j];
    Su[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < R_; ++i) uSu += Su[i] * u[i];
  const T Dn = A - uSu;
  const T Dinv = T(1) / Dn;
  // f = P (f + W_prev z_prev), z = r - u^T f
  T g[R_];
#pragma unroll
  for (int i = 0; i < R_; ++i) g[i] = f[i] + W[i] * z;
  T uf = T(0);
#pragma unroll
  for (int i = 0; i < R_; ++i) {
    f[i] = prop_row(i, JR, er, cs, sn, [&](int q) { return g[q]; });
    uf += u[i] * f[i];
  }
  z = r - uf;
#pragma unroll
  for (int i = 0; i < R_; ++i) {
    const T vi = (i < JR || ((i - JR) & 1) == 0) ? T(1) : T(0);
    W[i] = (vi - Su[i]) * Dinv;
  }
  D = Dn;
}

// Shared memory of one block: `lpb` likelihoods (teams), R propagator rows.
// Every per-step array is [.. ][step][team] so that the teams' lanes read
// neighbouring words.
template <typename T>
struct Smem {
  T* dt;   // [2][kChunk]          raw dt, double-buffered
  T* y;    // [2][kChunk][lpb]     raw y
  T* dg;   // [2][kChunk][lpb]     raw diag
  T* prop; // [R][kChunk][lpb]     er (real rows), then cs, sn per pair
  T* r;    // [kChunk][lpb]        y - mean
  T* A;    // [kChunk][lpb]        diag + k0
  T* D;    // [kChunk][lpb]        pivots
  T* z;    // [kChunk][lpb]        innovations
  T* st;   // runtime-R chain state, 2 R^2 + 6 R (team 0 only; lpb = 1)

  __device__ Smem(unsigned char* raw, int R, int lpb) {
    T* p = reinterpret_cast<T*>(raw);
    dt = p; p += 2 * kChunk;
    y = p; p += 2 * kChunk * lpb;
    dg = p; p += 2 * kChunk * lpb;
    prop = p; p += R * kChunk * lpb;
    r = p; p += kChunk * lpb;
    A = p; p += kChunk * lpb;
    D = p; p += kChunk * lpb;
    z = p; p += kChunk * lpb;
    st = p;
  }
};

inline size_t smem_bytes(size_t item, int R, int lpb, bool runtime) {
  return item * (2 * kChunk + 4 * kChunk * lpb + (size_t)(R + 4) * kChunk * lpb +
                 (runtime ? 2 * R * R + 6 * R : 0));
}

// The runtime-R chain over `cnt` steps of the chunk, run by the whole warp:
// each product of the step is spread over the lanes entry by entry, with a
// __syncwarp between products; the dot products are summed in full by
// every lane in one order, so D and z are the same in every lane.  State in
// shared memory: S (R x R), Tm (R x R), W, f, g, Su, u, v.
template <typename T>
__device__ void chain_runtime(const Smem<T>& sm, int cnt, int jr, int jc, int lane, T& D, T& z) {
  const int R = jr + 2 * jc, RR = R * R;
  T* S = sm.st;
  T* Tm = S + RR;
  T* W = Tm + RR;
  T* f = W + R;
  T* g = f + R;
  T* Su = g + R;
  const T* u = Su + R;
  const T* v = u + R;
  for (int k = 0; k < cnt; ++k) {
    const T* er = sm.prop + k;  // row q at er[q * kChunk] (lpb = 1)
    auto P = [&](int i, auto x) -> T {
      if (i < jr) return er[i * kChunk] * x(i);
      const int q = (i - jr) >> 1, a = jr + 2 * q;
      const T c = er[a * kChunk], s = er[(a + 1) * kChunk];
      return ((i - jr) & 1) == 0 ? c * x(a) - s * x(a + 1) : s * x(a) + c * x(a + 1);
    };
    for (int e = lane; e < RR; e += 32) S[e] += D * W[e / R] * W[e % R];
    __syncwarp();
    for (int e = lane; e < RR; e += 32) {
      const int i = e / R, c = e % R;
      Tm[e] = P(i, [&](int q) { return S[q * R + c]; });
    }
    __syncwarp();
    for (int e = lane; e < RR; e += 32) {
      const int i = e / R, c = e % R;
      S[e] = P(c, [&](int q) { return Tm[i * R + q]; });
    }
    __syncwarp();
    for (int i = lane; i < R; i += 32) {
      T acc = S[i * R] * u[0];
      for (int j = 1; j < R; ++j) acc += S[i * R + j] * u[j];
      Su[i] = acc;
      g[i] = f[i] + W[i] * z;
    }
    __syncwarp();
    T uSu = T(0);
    for (int i = 0; i < R; ++i) uSu += Su[i] * u[i];
    const T Dn = sm.A[k] - uSu;
    const T Dinv = T(1) / Dn;
    for (int i = lane; i < R; i += 32) f[i] = P(i, [&](int q) { return g[q]; });
    __syncwarp();
    T uf = T(0);
    for (int i = 0; i < R; ++i) uf += u[i] * f[i];
    z = sm.r[k] - uf;
    for (int i = lane; i < R; i += 32) W[i] = (v[i] - Su[i]) * Dinv;
    D = Dn;
    if (lane == 0) {
      sm.D[k] = Dn;
      sm.z[k] = z;
    }
    __syncwarp();
  }
}

// The team layouts.  L, the team size (32 or 8; 32 for the runtime-R
// body), is the template argument LT of the packed bodies, and for the
// dense-S and runtime-R bodies (LT = 0, which no path launches) the argument
// L_arg, so that they are compiled once for every layout.  L = 1 is
// `lane_kernel` below.
template <typename T, int JR, int JC, bool DENSE, int LT>
__global__ void __launch_bounds__(32)
loglike_kernel(const T* __restrict__ dt, const T* __restrict__ y, int y_cols,
               const T* __restrict__ diag, int d_cols, const T* __restrict__ ar,
               const T* __restrict__ cr, const T* __restrict__ ac, const T* __restrict__ bc,
               const T* __restrict__ cc, const T* __restrict__ dc, const T* __restrict__ mean,
               const T* __restrict__ extra_diag, int B, int N, int repeats, int jr_rt, int jc_rt,
               int L_arg, T* __restrict__ out) {
  constexpr bool kStatic = JR >= 0;
  const int L = LT ? LT : L_arg;
  const int LPB = 32 / L;    // likelihoods (teams) per block of one warp
  const int E = kChunk / L;  // steps per lane in phases A and C
  constexpr int JRs = JR > 0 ? JR : 1;
  constexpr int JCs = JC > 0 ? JC : 1;
  const int jr = kStatic ? JR : jr_rt;
  const int jc = kStatic ? JC : jc_rt;
  const int R = jr + 2 * jc;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> sm(smem_raw, R, LPB);
  const int lane = threadIdx.x;
  const int team = lane / L;  // team in the block
  const int tl = lane % L;    // lane in the team
  const int b_raw = blockIdx.x * LPB + team;
  const int b = b_raw < B ? b_raw : B - 1;   // idle lanes shadow the last likelihood

  T k0 = extra_diag ? extra_diag[b] : T(0);
  for (int j = 0; j < jr; ++j) k0 += ar[b * jr + j];
  for (int q = 0; q < jc; ++q) k0 += ac[b * jc + q];
  const T m = mean ? mean[b] : T(0);
  const long long ycol = (y_cols == 1) ? 0 : b / repeats;
  const long long dcol = (d_cols == 1) ? 0 : b / repeats;

  // ---- raw data of chunk c into buffer c & 1 (cp.async) ---------------- //
  auto prefetch = [&](int c) {
    const int buf = c & 1, n0 = c * kChunk;
    const int n = n0 + lane;
    if (n < N) __pipeline_memcpy_async(sm.dt + buf * kChunk + lane, dt + n, sizeof(T));
    for (int e = 0; e < E; ++e) {
      const int k = tl * E + e, nk = n0 + k;
      if (nk < N) {
        const int s = (buf * kChunk + k) * LPB + team;
        __pipeline_memcpy_async(sm.y + s, y + nk * (long long)y_cols + ycol, sizeof(T));
        __pipeline_memcpy_async(sm.dg + s, diag + nk * (long long)d_cols + dcol, sizeof(T));
      }
    }
    __pipeline_commit();
  };

  // per-likelihood constants of the propagators (static widths)
  T crv[JRs], ccv[JCs], dcv[JCs];
  if constexpr (kStatic) {
#pragma unroll
    for (int j = 0; j < JR; ++j) crv[j] = cr[b * JR + j];
#pragma unroll
    for (int q = 0; q < JC; ++q) {
      ccv[q] = cc[b * JC + q];
      dcv[q] = dc[b * JC + q];
    }
  }

  // ---- chain state ----------------------------------------------------- //
  constexpr int Rs = kStatic ? JR + 2 * JC : 1;
  constexpr int NS = DENSE ? Rs * Rs : Rs * (Rs + 1) / 2;
  T S[NS], W[Rs], f[Rs], u[Rs];
  T D = T(0), z = T(0);
  if constexpr (kStatic) {
#pragma unroll
    for (int q = 0; q < NS; ++q) S[q] = T(0);
#pragma unroll
    for (int i = 0; i < Rs; ++i) W[i] = f[i] = T(0);
#pragma unroll
    for (int j = 0; j < JR; ++j) u[j] = ar[b * JR + j];
#pragma unroll
    for (int q = 0; q < JC; ++q) {
      u[JR + 2 * q] = ac[b * JC + q];
      u[JR + 2 * q + 1] = bc[b * JC + q];
    }
  } else if (lane == 0) {  // S, Tm, W, f, g, Su zero; then u, v
    for (int i = 0; i < 2 * R * R + 4 * R; ++i) sm.st[i] = T(0);
    T* uv = sm.st + 2 * R * R + 4 * R;
    for (int j = 0; j < jr; ++j) {
      uv[j] = ar[b * jr + j];
      uv[R + j] = T(1);
    }
    for (int q = 0; q < jc; ++q) {
      uv[jr + 2 * q] = ac[b * jc + q];
      uv[jr + 2 * q + 1] = bc[b * jc + q];
      uv[R + jr + 2 * q] = T(1);
      uv[R + jr + 2 * q + 1] = T(0);
    }
  }

  T logdet = T(0), lc = T(0), quad = T(0), qc = T(0);
  bool ok = true;
  const int chunks = (N + kChunk - 1) / kChunk;
  prefetch(0);
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1, n0 = c * kChunk;
    const int cnt = N - n0 < kChunk ? N - n0 : kChunk;
    if (c + 1 < chunks) {
      prefetch(c + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncwarp();

    // ---- A. propagators and data of the chunk ------------------------- //
    for (int e = 0; e < E; ++e) {
      const int k = tl * E + e;
      if (k < cnt) {
        const int s = k * LPB + team;
        const T h = sm.dt[buf * kChunk + k];  // dt[0] = 0: P = I at step 0
        sm.r[s] = sm.y[buf * kChunk * LPB + s] - m;
        sm.A[s] = sm.dg[buf * kChunk * LPB + s] + k0;
        if constexpr (kStatic) {
#pragma unroll
          for (int j = 0; j < JR; ++j) sm.prop[j * kChunk * LPB + s] = dev_exp(-crv[j] * h);
#pragma unroll
          for (int q = 0; q < JC; ++q) {
            const T ex = dev_exp(-ccv[q] * h);
            T sn, cs;
            dev_sincos(dcv[q] * h, &sn, &cs);
            sm.prop[(JR + 2 * q) * kChunk * LPB + s] = ex * cs;
            sm.prop[(JR + 2 * q + 1) * kChunk * LPB + s] = ex * sn;
          }
        } else {
          for (int j = 0; j < jr; ++j) sm.prop[j * kChunk + k] = dev_exp(-cr[b * jr + j] * h);
          for (int q = 0; q < jc; ++q) {
            const T ex = dev_exp(-cc[b * jc + q] * h);
            T sn, cs;
            dev_sincos(dc[b * jc + q] * h, &sn, &cs);
            sm.prop[(jr + 2 * q) * kChunk + k] = ex * cs;
            sm.prop[(jr + 2 * q + 1) * kChunk + k] = ex * sn;
          }
        }
      }
    }
    __syncwarp();

    // ---- B. the chain ------------------------------------------------- //
    if constexpr (kStatic) {
      if (tl == 0) {
        for (int k = 0; k < cnt; ++k) {
          const int s = k * LPB + team;
          T er[JRs], cs[JCs], sn[JCs];
#pragma unroll
          for (int j = 0; j < JR; ++j) er[j] = sm.prop[j * kChunk * LPB + s];
#pragma unroll
          for (int q = 0; q < JC; ++q) {
            cs[q] = sm.prop[(JR + 2 * q) * kChunk * LPB + s];
            sn[q] = sm.prop[(JR + 2 * q + 1) * kChunk * LPB + s];
          }
          chain_step<T, JR, JC, DENSE>(S, W, f, u, D, z, er, cs, sn, sm.A[s], sm.r[s]);
          sm.D[s] = D;
          sm.z[s] = z;
        }
      }
    } else {
      chain_runtime<T>(sm, cnt, jr, jc, lane, D, z);
    }
    __syncwarp();

    // ---- C. the chunk's terms, summed as a tree, then Kahan ----------- //
    // the lane's E terms overwrite its D_k, z_k (zero past the end) ...
    for (int e = 0; e < E; ++e) {
      const int k = tl * E + e, s = k * LPB + team;
      T xl = T(0), xq = T(0);
      if (k < cnt) {
        const T Dk = sm.D[s], zk = sm.z[s];
        xl = dev_log(fabs(Dk));
        xq = zk * zk / Dk;
        ok = ok && (Dk > T(0));
      }
      sm.D[s] = xl;
      sm.z[s] = xq;
    }
    // ... then summed pairwise in place, neighbours first, and across the
    // team's lanes by shuffles: the same tree for every L
    for (int w = 1; w < E; w <<= 1) {
      for (int e = 0; e < E; e += 2 * w) {
        const int s = (tl * E + e) * LPB + team, s2 = s + w * LPB;
        sm.D[s] += sm.D[s2];
        sm.z[s] += sm.z[s2];
      }
    }
    T sum_l = sm.D[tl * E * LPB + team], sum_q = sm.z[tl * E * LPB + team];
    for (int off = 1; off < L; off <<= 1) {
      sum_l += __shfl_xor_sync(kFull, sum_l, off);
      sum_q += __shfl_xor_sync(kFull, sum_q, off);
    }
    kahan_add(logdet, lc, sum_l);
    kahan_add(quad, qc, sum_q);
    __syncwarp();
  }

  for (int off = 1; off < L; off <<= 1) ok = __shfl_xor_sync(kFull, int(ok), off) && ok;
  if (tl == 0 && b_raw < B) {
    const T ll = T(-0.5) * (quad + logdet + T(double(N) * 1.8378770664093453));  // N log(2 pi)
    out[b_raw] = ok ? ll : neg_inf<T>();
  }
}

template <typename T, int JR, int JC, bool DENSE, int LT>
int launch(const T* dt, const T* y, int y_cols, const T* diag, int d_cols, const T* ar, const T* cr,
           const T* ac, const T* bc, const T* cc, const T* dc, const T* mean, const T* extra_diag,
           int B, int N, int repeats, int jr, int jc, int L, T* out, cudaStream_t stream) {
  const int LPB = 32 / L;
  const size_t smem = smem_bytes(sizeof(T), jr + 2 * jc, LPB, JR < 0);
  auto kernel = loglike_kernel<T, JR, JC, DENSE, LT>;
  if (smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + LPB - 1) / LPB;
  kernel<<<blocks, 32, smem, stream>>>(dt, y, y_cols, diag, d_cols, ar, cr, ac, bc, cc, dc, mean,
                                       extra_diag, B, N, repeats, jr, jc, L, out);
  return static_cast<int>(cudaGetLastError());
}

// Threads a block of the L = 1 layout (whole warps, at least kChunk); 64
// and 128 measured the same on an H100 (PERF.md section 6).
constexpr int kLaneBlock = 128;

// The L = 1 layout of the packed body at the compile-time widths: thread b
// of the grid serves likelihood b, its state and sums in registers.
template <typename T, int JR, int JC>
__global__ void __launch_bounds__(kLaneBlock)
lane_kernel(const T* __restrict__ dt, const T* __restrict__ y, int y_cols, const T* __restrict__ diag,
            int d_cols, const T* __restrict__ ar, const T* __restrict__ cr, const T* __restrict__ ac,
            const T* __restrict__ bc, const T* __restrict__ cc, const T* __restrict__ dc,
            const T* __restrict__ mean, const T* __restrict__ extra_diag, int B, int N, int repeats,
            T* __restrict__ out) {
  constexpr int R = JR + 2 * JC;
  constexpr int NS = R * (R + 1) / 2;
  constexpr int JRs = JR > 0 ? JR : 1;
  constexpr int JCs = JC > 0 ? JC : 1;
  __shared__ T sdt[2][kChunk], sy[2][kChunk], sdg[2][kChunk];  // a chunk of the shared columns, double-buffered

  const int tid = threadIdx.x;
  const int b_raw = blockIdx.x * kLaneBlock + tid;
  const int b = b_raw < B ? b_raw : B - 1;  // idle threads shadow the last likelihood
  const bool y_shared = y_cols == 1, d_shared = d_cols == 1;
  const T* ycol = y + (y_shared ? 0 : b / repeats);  // step n at ycol[n * y_cols]
  const T* dcol = diag + (d_shared ? 0 : b / repeats);

  T k0 = extra_diag ? extra_diag[b] : T(0);
#pragma unroll
  for (int j = 0; j < JR; ++j) k0 += ar[b * JR + j];
#pragma unroll
  for (int q = 0; q < JC; ++q) k0 += ac[b * JC + q];
  const T m = mean ? mean[b] : T(0);

  T crv[JRs], ccv[JCs], dcv[JCs];
  T S[NS], W[R], f[R], u[R];
#pragma unroll
  for (int j = 0; j < JR; ++j) {
    crv[j] = cr[b * JR + j];
    u[j] = ar[b * JR + j];
  }
#pragma unroll
  for (int q = 0; q < JC; ++q) {
    ccv[q] = cc[b * JC + q];
    dcv[q] = dc[b * JC + q];
    u[JR + 2 * q] = ac[b * JC + q];
    u[JR + 2 * q + 1] = bc[b * JC + q];
  }
#pragma unroll
  for (int q = 0; q < NS; ++q) S[q] = T(0);
#pragma unroll
  for (int i = 0; i < R; ++i) W[i] = f[i] = T(0);

  // ---- raw shared data of chunk c into buffer c & 1 (cp.async) -------- //
  auto prefetch = [&](int c) {
    const int buf = c & 1, n = c * kChunk + tid;
    if (tid < kChunk && n < N) {
      __pipeline_memcpy_async(&sdt[buf][tid], dt + n, sizeof(T));
      if (y_shared) __pipeline_memcpy_async(&sy[buf][tid], y + n, sizeof(T));
      if (d_shared) __pipeline_memcpy_async(&sdg[buf][tid], diag + n, sizeof(T));
    }
    __pipeline_commit();
  };

  // ---- what step n needs that does not depend on the state ------------- //
  struct Inputs {
    T er[JRs], cs[JCs], sn[JCs], A, r;
  };
  auto inputs = [&](int buf, int k, long long n, Inputs& x) {
    const T h = sdt[buf][k];  // dt[0] = 0: P = I at step 0
    x.r = (y_shared ? sy[buf][k] : ycol[n * y_cols]) - m;
    x.A = (d_shared ? sdg[buf][k] : dcol[n * d_cols]) + k0;
#pragma unroll
    for (int j = 0; j < JR; ++j) x.er[j] = dev_exp(-crv[j] * h);
#pragma unroll
    for (int q = 0; q < JC; ++q) {
      const T ex = dev_exp(-ccv[q] * h);
      T sn, cs;
      dev_sincos(dcv[q] * h, &sn, &cs);
      x.cs[q] = ex * cs;
      x.sn[q] = ex * sn;
    }
  };

  // ---- the sums: the chunk's pairwise tree as a stack, Kahan across ---- //
  T logdet = T(0), lc = T(0), quad = T(0), qc = T(0);
  T lv[5] = {}, qv[5] = {};  // lv[l]: the sum of the last complete 2^l terms not yet merged
  auto add_term = [&](int k, T xl, T xq) {  // term k (0..31) of the chunk
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      if (((k >> l) & 1) == 0) {
        lv[l] = xl;
        qv[l] = xq;
        return;
      }
      xl = lv[l] + xl;
      xq = qv[l] + xq;
    }
    kahan_add(logdet, lc, xl);  // k = 31: the chunk's sums
    kahan_add(quad, qc, xq);
  };

  T D = T(0), z = T(0);
  bool ok = true;
  const int chunks = (N + kChunk - 1) / kChunk;
  prefetch(0);
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1, n0 = c * kChunk;
    const int cnt = N - n0 < kChunk ? N - n0 : kChunk;
    if (c + 1 < chunks) {
      prefetch(c + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    Inputs cur;
    inputs(buf, 0, n0, cur);
    for (int k = 0; k < cnt; ++k) {
      // one step ahead of the chain, without a branch (the last step's are computed twice), so the
      // scheduler can interleave them with the chain
      const int k1 = k + 1 < cnt ? k + 1 : k;
      Inputs next;
      inputs(buf, k1, n0 + k1, next);
      chain_step<T, JR, JC, false>(S, W, f, u, D, z, cur.er, cur.cs, cur.sn, cur.A, cur.r);
      add_term(k, dev_log(fabs(D)), z * z / D);
      ok = ok && (D > T(0));
      cur = next;
    }
    for (int k = cnt; k < kChunk; ++k) add_term(k, T(0), T(0));  // zero past the end
    __syncthreads();  // the buffer is refilled two chunks on
  }
  if (b_raw < B) {
    const T ll = T(-0.5) * (quad + logdet + T(double(N) * 1.8378770664093453));  // N log(2 pi)
    out[b_raw] = ok ? ll : neg_inf<T>();
  }
}

template <typename T, int JR, int JC>
int launch_lanes(const T* dt, const T* y, int y_cols, const T* diag, int d_cols, const T* ar, const T* cr,
                 const T* ac, const T* bc, const T* cc, const T* dc, const T* mean, const T* extra_diag, int B,
                 int N, int repeats, T* out, cudaStream_t stream) {
  const int blocks = (B + kLaneBlock - 1) / kLaneBlock;
  lane_kernel<T, JR, JC><<<blocks, kLaneBlock, 0, stream>>>(dt, y, y_cols, diag, d_cols, ar, cr, ac, bc, cc, dc,
                                                            mean, extra_diag, B, N, repeats, out);
  return static_cast<int>(cudaGetLastError());
}

// The (Jr, Jc) pairs with a compile-time body: every 1 <= R <= 6, and at
// R = 7, 8 the DRW / Lorentzian sums (1, 3), (0, 4), (2, 3).  Keep in step
// with STATIC_WIDTHS in ops/celerite.py.
#define CELERITE_STATIC_PAIRS(X)                                                            \
  X(1, 0) X(2, 0) X(3, 0) X(4, 0) X(5, 0) X(6, 0) X(0, 1) X(1, 1) X(2, 1) X(3, 1) X(4, 1) \
  X(0, 2) X(1, 2) X(2, 2) X(0, 3) X(1, 3) X(0, 4) X(2, 3)

// team = 32, 8 or 1 lanes per likelihood (32 only for the runtime-R body,
// 1 only for the packed body); dense_s selects the dense-S body.  Returns 0,
// -1 for a (team, body) that does not exist, -2 for a bad size, or the
// cudaError_t of the launch.
template <typename T>
int dispatch(int Jr, int Jc, int dense_s, int team, const T* dt, const T* y, int y_cols,
             const T* diag, int d_cols, const T* ar, const T* cr, const T* ac, const T* bc,
             const T* cc, const T* dc, const T* mean, const T* extra_diag, int B, int N,
             int repeats, T* out, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || repeats <= 0 || Jr < 0 || Jc < 0 || Jr + 2 * Jc < 1) return -2;
  if (team != 1 && team != 8 && team != 32) return -1;
#define CELERITE_DATA dt, y, y_cols, diag, d_cols, ar, cr, ac, bc, cc, dc, mean, extra_diag, B, N, repeats
#define CELERITE_ARGS CELERITE_DATA, Jr, Jc, team, out, stream
#define CELERITE_CASE(JR_, JC_)                                                       \
  if (Jr == JR_ && Jc == JC_) {                                                       \
    if (team == 1) return dense_s ? -1 : launch_lanes<T, JR_, JC_>(CELERITE_DATA, out, stream); \
    if (dense_s) return launch<T, JR_, JC_, true, 0>(CELERITE_ARGS);                  \
    if (team == 32) return launch<T, JR_, JC_, false, 32>(CELERITE_ARGS);             \
    return launch<T, JR_, JC_, false, 8>(CELERITE_ARGS);                              \
  }
  CELERITE_STATIC_PAIRS(CELERITE_CASE)
#undef CELERITE_CASE
  if (team != 32) return -1;
  return launch<T, kRuntime, kRuntime, false, 0>(CELERITE_ARGS);
#undef CELERITE_ARGS
#undef CELERITE_DATA
}

}  // namespace celerite
