// Celerite GP log-likelihood and its exact gradient for Hopper (sm_90a).
//
// The port of `jax.value_and_grad` over the fused factor-and-solve scan of
// mind_the_gaps_tpu/solver/semiseparable.py::log_likelihood (:141-187, with
// build_matrices :67-107): the MAP objective of GPModelling.fit.  No
// Pallas kernel computes this; XLA derives the adjoint by transposing the
// scan.  Here it is written out, as in Foreman-Mackey, "Scalable
// backpropagation for Gaussian Processes using celerite" (arXiv
// 1801.10156).  For B parameter draws it returns
//
//     ll[b] = log N(y_b | mean[b], K(theta_b) + diag + extra_diag[b])
//
// and the gradient of ll[b] with respect to the six coefficient vectors,
// extra_diag[b] and the residual r_b = y_b - mean[b] (N values).  A draw
// whose K is not positive definite gets -inf and a gradient of zeros.
//
// Forward (global-phase form, P diagonal): with tc = t - t[0], dt_n =
// t_n - t_{n-1} (dt_0 = 0),
//   real term j:     U = a_j, V = 1, P = exp(-c_j dt)
//   complex term q:  V = (cos, sin)(d_q tc), P = exp(-c_q dt) (twice),
//                    U = (a cos + b sin, a sin - b cos)
//   A_n = diag_n + extra + sum a_j + sum a_q
//   n = 0:  S = 0, f = 0, D = A_0, W = V_0 / D, z = r_0
//   n > 0:  S = (P P^T) o (S + D W W^T),  f = P o (f + W z)
//           s = S U,  D = A - U.s,  W = (V - s) / D,  z = r - U.f
//   ll = -(sum z^2 / D + sum log D + N log 2 pi) / 2
// The two sums are taken chunk by chunk as the forward kernel
// (celerite_loglike.cuh) and its plain version (solver/batched.py::
// chunk_sums) take them: a pairwise tree over each chunk of 32 steps, Kahan
// across chunks.  The adjoint of a sum is the identity on each term, so only
// the value depends on that order.
//
// Adjoint, from n = N-1 down to 0, carrying the adjoints of the step's
// outputs (G = the symmetric adjoint of S, fb, Wb, Db, zb):
//   zb += -z / D,  Db += -(1/D - z^2/D^2) / 2,  dll/dr_n = zb
//   from z:  Ub = -zb f,  fb += -zb U
//   from W:  Vb = Wb / D,  sb = -Wb / D,  Db += -Wb.W / D
//   from D:  Ab = Db,  Ub += -Db s,  sb += -Db U
//   from s:  G += (sb U^T + U sb^T) / 2,  Ub += S sb
//   n > 0, with M = S' + D' W' W'^T and g = f' + W' z' (primes: step n-1):
//   from f:  Pb = fb o g,  gb = P o fb
//   from S:  Pb_k += 2 sum_j G_kj M_kj P_j,  Mb = (P P^T) o G
//   to n-1:  G = Mb,  Db = W'^T Mb W',  Wb = 2 D' Mb W' + gb z',
//            zb = gb.W',  fb = gb
// and the step's Ub, Vb, Pb, Ab are chained into the coefficients: a real
// term's a takes Ub and c takes -dt P Pb; a complex pair's a and b take Ub
// rotated by (cos, sin), c takes -dt P (Pb1 + Pb2), d takes tc times the
// phase adjoint (U1 Ub2 - U2 Ub1 + cos Vb2 - sin Vb1); Ab feeds every a_j,
// every a_q and extra_diag.  The first step is the general one with S = f =
// 0: its S and f adjoints are dropped.
//
// Layout and what bounds it: one thread per likelihood (the MAP fit has
// B = 1).  The forward pass writes each step's D, z, W, f, P, V and packed
// S (2 + 4R + R(R+1)/2 words) to a workspace the wrapper allocates; a
// second pass sums the value's terms chunk by chunk; the adjoint pass reads
// the records back in reverse, prefetching a few steps ahead.  Both
// passes are chains of N dependent steps, so the kernel is bound by the
// latency of one step's multiply-adds and reciprocal, not by bytes or
// throughput.  Templated on R = Jr + 2 Jc for R <= 8 (state in registers);
// any larger R takes the runtime-R body, whose state lives in a scratch
// area.  double only: the MAP objective is float64 in both packages, and
// a float instantiation waits for a path that needs it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC (celerite_grad_f64.cu).  The per-likelihood routine is
// plain C++ (CG_DEV), so it also compiles for the host.

#pragma once

#include <math.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define CG_DEV __device__ __forceinline__
#else
#define CG_DEV inline
#endif

namespace celerite_grad {

constexpr int kChunk = 32;   // steps per chunk of the value's sums
constexpr int kMaxStatic = 8;  // R with a compile-time body
constexpr int kPrefetch = 4;   // steps the adjoint pass prefetches ahead

CG_DEV int packed(int i, int j, int R) {
  // index of (min(i, j), max(i, j)) in the packed upper triangle
  return i <= j ? i * R - (i * (i - 1)) / 2 + (j - i) : j * R - (j * (j - 1)) / 2 + (i - j);
}

CG_DEV int record_words(int R) { return 2 + 4 * R + R * (R + 1) / 2; }
CG_DEV int scratch_words(int R) { return 2 * (R * (R + 1) / 2) + 18 * R; }

CG_DEV double neg_inf() {
#if defined(__CUDA_ARCH__)
  return __longlong_as_double(0xfff0000000000000LL);
#else
  return -HUGE_VAL;
#endif
}

CG_DEV void kahan_add(double& s, double& c, double x) {
  const double yk = x - c;
  const double tk = s + yk;
  c = (tk - s) - yk;
  s = tk;
}

CG_DEV void prefetch_l1(const void* p) {
#if defined(__CUDA_ARCH__)
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
#else
  (void)p;
#endif
}

// The inputs of one likelihood.  Coefficient pointers are this draw's rows;
// y points at its residual series (shared or its own row).
struct Inputs {
  int jr, jc, N;
  const double* tc;    // (N,) t - t[0]
  const double* dt;    // (N,) t_n - t_{n-1}, dt[0] = 0
  const double* y;     // (N,)
  const double* diag;  // (N,)
  const double *ar, *cr, *ac, *bc, *cc, *dc;
  double mean, extra;
};

// The outputs of one likelihood (gradients of ll).
struct Outputs {
  double* ll;
  double *g_ar, *g_cr, *g_ac, *g_bc, *g_cc, *g_dc;
  double* g_extra;
  double* g_r;  // (N,)
};

// RT > 0: R = RT, the state in registers (every loop over R unrolls, so
// each array index is a constant).  RT == 0: R from jr, jc at run time,
// the state in `scratch` (scratch_words(R) doubles).
template <int RT>
CG_DEV void loglike_and_grad(const Inputs& in, double* ws, double* scratch, const Outputs& out) {
  const int jr = in.jr, jc = in.jc, N = in.N;
  const int R = RT > 0 ? RT : jr + 2 * jc;
  const int NS = R * (R + 1) / 2;
  const int REC = record_words(R);
  constexpr int RS = RT > 0 ? RT : 1;
  constexpr int NSS = RS * (RS + 1) / 2;

  // per-column constants: real j: (ca, cc) = (a, c); a complex pair's two
  // columns: ca = (a, b), cc = (c, c), cd = (d, d)
  double r_ca[RS], r_cc[RS], r_cd[RS];
  double r_S[NSS], r_W[RS], r_f[RS], r_U[RS], r_V[RS], r_P[RS], r_s[RS];
  double* sc = scratch;
  auto take = [&](double* reg, int n) {
    if (RT > 0) return reg;
    double* p = sc;
    sc += n;
    return p;
  };
  double* ca = take(r_ca, R);
  double* ccol = take(r_cc, R);
  double* cd = take(r_cd, R);
  double* S = take(r_S, NS);
  double* W = take(r_W, R);
  double* f = take(r_f, R);
  double* U = take(r_U, R);
  double* V = take(r_V, R);
  double* P = take(r_P, R);
  double* s = take(r_s, R);

  double k0 = in.extra;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < jr) {
      ca[i] = in.ar[i];
      ccol[i] = in.cr[i];
      cd[i] = 0.0;
      k0 += in.ar[i];
    } else {
      const int q = (i - jr) >> 1;
      const bool first = ((i - jr) & 1) == 0;
      ca[i] = first ? in.ac[q] : in.bc[q];
      ccol[i] = in.cc[q];
      cd[i] = in.dc[q];
      if (first) k0 += in.ac[q];
    }
  }

  // the step's columns U, V, P from the coefficients, tc and dt
  auto columns = [&](double tcn, double h) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < jr) {
        P[i] = exp(-ccol[i] * h);
        V[i] = 1.0;
        U[i] = ca[i];
      } else if (((i - jr) & 1) == 0 && i + 1 < R) {
        double sn, cs;
        sincos(cd[i] * tcn, &sn, &cs);
        const double e = exp(-ccol[i] * h);
        P[i] = e;
        P[i + 1] = e;
        V[i] = cs;
        V[i + 1] = sn;
        U[i] = ca[i] * cs + ca[i + 1] * sn;
        U[i + 1] = ca[i] * sn - ca[i + 1] * cs;
      }
    }
  };

  // ---- forward: the recursion, one record a step ------------------------ //
  double D = 0.0, z = 0.0;
  for (int n = 0; n < N; ++n) {
    columns(in.tc[n], in.dt[n]);
    const double An = in.diag[n] + k0;
    const double rn = in.y[n] - in.mean;
    if (n == 0) {
#pragma unroll
      for (int e = 0; e < NS; ++e) S[e] = 0.0;
      D = An;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        f[i] = 0.0;
        W[i] = V[i] / D;
      }
      z = rn;
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = i; j < R; ++j) {
          const int e = packed(i, j, R);
          S[e] = (P[i] * P[j]) * (S[e] + D * (W[i] * W[j]));
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) f[i] = P[i] * (f[i] + W[i] * z);
      double uSu = 0.0, uf = 0.0;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        double acc = 0.0;
#pragma unroll
        for (int j = 0; j < R; ++j) acc += S[packed(i, j, R)] * U[j];
        s[i] = acc;
        uSu += U[i] * acc;
        uf += U[i] * f[i];
      }
      D = An - uSu;
      const double Dinv = 1.0 / D;
#pragma unroll
      for (int i = 0; i < R; ++i) W[i] = (V[i] - s[i]) * Dinv;
      z = rn - uf;
    }
    double* rec = ws + (long long)n * REC;
    rec[0] = D;
    rec[1] = z;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      rec[2 + i] = W[i];
      rec[2 + R + i] = f[i];
      rec[2 + 2 * R + i] = P[i];
      rec[2 + 3 * R + i] = V[i];
    }
#pragma unroll
    for (int e = 0; e < NS; ++e) rec[2 + 4 * R + e] = S[e];
  }

  // ---- the value: chunked sums of log D and z^2 / D --------------------- //
  double logdet = 0.0, lcomp = 0.0, quad = 0.0, qcomp = 0.0;
  bool ok = true;
  for (int n0 = 0; n0 < N; n0 += kChunk) {
    double xl[kChunk], xq[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      xl[k] = 0.0;
      xq[k] = 0.0;
      if (n0 + k < N) {
        const double* rec = ws + (long long)(n0 + k) * REC;
        const double Dk = rec[0], zk = rec[1];
        ok = ok && (Dk > 0.0);
        xl[k] = log(fabs(Dk));
        xq[k] = zk * zk / Dk;
      }
    }
#pragma unroll
    for (int w = 1; w < kChunk; w <<= 1) {
#pragma unroll
      for (int k = 0; k < kChunk; k += 2 * w) {
        xl[k] += xl[k + w];
        xq[k] += xq[k + w];
      }
    }
    kahan_add(logdet, lcomp, xl[0]);
    kahan_add(quad, qcomp, xq[0]);
  }

  if (!ok) {
    *out.ll = neg_inf();
    for (int j = 0; j < jr; ++j) out.g_ar[j] = out.g_cr[j] = 0.0;
    for (int q = 0; q < jc; ++q) out.g_ac[q] = out.g_bc[q] = out.g_cc[q] = out.g_dc[q] = 0.0;
    *out.g_extra = 0.0;
    for (int n = 0; n < N; ++n) out.g_r[n] = 0.0;
    return;
  }
  *out.ll = -0.5 * (quad + logdet + double(N) * 1.8378770664093453);  // N log(2 pi)

  // ---- adjoint ----------------------------------------------------------- //
  double r_G[NSS], r_fb[RS], r_Wb[RS], r_Ub[RS], r_Vb[RS], r_sb[RS], r_Pb[RS], r_gb[RS];
  double r_accU[RS], r_accP[RS];
  double* G = take(r_G, NS);
  double* fb = take(r_fb, R);
  double* Wb = take(r_Wb, R);
  double* Ub = take(r_Ub, R);
  double* Vb = take(r_Vb, R);
  double* sb = take(r_sb, R);
  double* Pb = take(r_Pb, R);
  double* gb = take(r_gb, R);
  double* accU = take(r_accU, R);
  double* accP = take(r_accP, R);
#pragma unroll
  for (int e = 0; e < NS; ++e) G[e] = 0.0;
#pragma unroll
  for (int i = 0; i < R; ++i) fb[i] = Wb[i] = accU[i] = accP[i] = 0.0;
  double Db = 0.0, zb = 0.0, Asum = 0.0;

  for (int n = N - 1; n >= 0; --n) {
    if (n >= kPrefetch) {
      const char* p = reinterpret_cast<const char*>(ws + (long long)(n - kPrefetch) * REC);
      for (int off = 0; off < REC * 8; off += 128) prefetch_l1(p + off);
      prefetch_l1(p + REC * 8 - 1);
    }
    const double* rec = ws + (long long)n * REC;
    const double Dn = rec[0], zn = rec[1];
    const double* Wn = rec + 2;
    const double* fn = rec + 2 + R;
    const double* Pn = rec + 2 + 2 * R;
    const double* Vn = rec + 2 + 3 * R;
    const double* Sn = rec + 2 + 4 * R;
    const double Dinv = 1.0 / Dn;
    const double h = in.dt[n], tcn = in.tc[n];

    // U from the stored V (a real column's U is a)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < jr) {
        U[i] = ca[i];
      } else if (((i - jr) & 1) == 0 && i + 1 < R) {
        U[i] = ca[i] * Vn[i] + ca[i + 1] * Vn[i + 1];
        U[i + 1] = ca[i] * Vn[i + 1] - ca[i + 1] * Vn[i];
      }
    }

    // the terms of the value
    zb += -zn * Dinv;
    Db += -0.5 * (Dinv - zn * zn * Dinv * Dinv);
    out.g_r[n] = zb;

    // z = r - U.f;  W = (V - s) / D;  D = A - U.s
    double WbW = 0.0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      double acc = 0.0;
#pragma unroll
      for (int j = 0; j < R; ++j) acc += Sn[packed(i, j, R)] * U[j];
      s[i] = acc;
      Ub[i] = -zb * fn[i];
      fb[i] += -zb * U[i];
      WbW += Wb[i] * Wn[i];
    }
    Db += -WbW * Dinv;
    const double Ab = Db;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      Ub[i] += -Db * s[i];
      Vb[i] = Wb[i] * Dinv;
      sb[i] = -Vb[i] - Db * U[i];
    }
    // s = S U
#pragma unroll
    for (int i = 0; i < R; ++i) {
      double acc = 0.0;
#pragma unroll
      for (int j = 0; j < R; ++j) acc += Sn[packed(i, j, R)] * sb[j];
      Ub[i] += acc;
#pragma unroll
      for (int j = i; j < R; ++j) G[packed(i, j, R)] += 0.5 * (sb[i] * U[j] + U[i] * sb[j]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) Pb[i] = 0.0;
    double Db_prev = 0.0, zb_prev = 0.0;
    if (n > 0) {
      const double* prv = rec - REC;
      const double Dp = prv[0], zp = prv[1];
      const double* Wp = prv + 2;
      const double* fp = prv + 2 + R;
      const double* Sp = prv + 2 + 4 * R;
      // f = P o g, g = f' + W' z'
#pragma unroll
      for (int i = 0; i < R; ++i) {
        Pb[i] = fb[i] * (fp[i] + Wp[i] * zp);
        gb[i] = Pn[i] * fb[i];
        zb_prev += gb[i] * Wp[i];
      }
      // S = (P P^T) o M, M = S' + D' W' W'^T; G becomes Mb in place
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = i; j < R; ++j) {
          const int e = packed(i, j, R);
          const double GM = G[e] * (Sp[e] + Dp * (Wp[i] * Wp[j]));
          Pb[i] += 2.0 * GM * Pn[j];
          if (j != i) Pb[j] += 2.0 * GM * Pn[i];
          G[e] = (Pn[i] * Pn[j]) * G[e];
        }
      }
      // adjoints of step n-1's outputs
#pragma unroll
      for (int i = 0; i < R; ++i) {
        double acc = 0.0;
#pragma unroll
        for (int j = 0; j < R; ++j) acc += G[packed(i, j, R)] * Wp[j];
        Db_prev += Wp[i] * acc;
        Wb[i] = 2.0 * Dp * acc + gb[i] * zp;
        fb[i] = gb[i];
      }
    }

    // chain the step's Ub, Vb, Pb and Ab into the coefficients
    Asum += Ab;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i < jr) {
        accU[i] += Ub[i];
        accP[i] += Pb[i] * (-h * Pn[i]);
      } else if (((i - jr) & 1) == 0 && i + 1 < R) {
        const double cs = Vn[i], sn = Vn[i + 1];
        accU[i] += Ub[i] * cs + Ub[i + 1] * sn;
        accU[i + 1] += Ub[i] * sn - Ub[i + 1] * cs;
        accP[i] += (Pb[i] + Pb[i + 1]) * (-h * Pn[i]);
        accP[i + 1] += tcn * (U[i] * Ub[i + 1] - U[i + 1] * Ub[i] + cs * Vb[i + 1] - sn * Vb[i]);
      }
    }
    Db = Db_prev;
    zb = zb_prev;
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < jr) {
      out.g_ar[i] = accU[i] + Asum;
      out.g_cr[i] = accP[i];
    } else if (((i - jr) & 1) == 0 && i + 1 < R) {
      const int q = (i - jr) >> 1;
      out.g_ac[q] = accU[i] + Asum;
      out.g_bc[q] = accU[i + 1];
      out.g_cc[q] = accP[i];
      out.g_dc[q] = accP[i + 1];
    }
  }
  *out.g_extra = Asum;
}

}  // namespace celerite_grad
