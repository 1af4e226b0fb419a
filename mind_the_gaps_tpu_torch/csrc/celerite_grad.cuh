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
// What bounds it on this card: latency.  Both passes are chains of N
// dependent steps (the MAP fit has B = 1, N = 5000), each step about 2R + 9
// dependent multiply-adds forward (with one reciprocal) and 3R + 5 back.
// Everything else a step needs does not depend on the chain: the loads, the
// propagators' exp and sincos, the value's logs and sums, the record traffic
// and, on the way back, U, s = S U, S sb, the decay factors' 2 G o M P and
// the chaining into the coefficients.  So the design keeps the chain lane
// doing the chain alone, and gives the rest to other warps.  One block of
// three warps serves one likelihood (grid = B blocks):
//   warp 0, lane 0, the chain lane: the S / D / W and f / z recursion
//     forward (fwd_step) and the G / Db / Wb / zb / fb recursion back
//     (adj_step), reading its step's operands from shared memory one step
//     ahead into registers and writing each step's outputs to shared memory;
//   warp 1, the prep warp, a chunk of 32 steps ahead of the chain:
//     forward, loads tc, dt, y, diag (coalesced, one step a lane; plain
//     loads, since the same lane computes on them at once) and computes U,
//     V, P, A_n, r_n (columns); back, copies the chunk's records (and the
//     one of the step before it) from the workspace into shared memory,
//     coalesced, recomputes U, V, P and takes 1 / D, -z / D and the value's
//     Db term;
//   warp 2, the post warp, a chunk behind the chain: forward, writes the
//     chunk's records to the workspace (coalesced) and sums log|D| and
//     z^2 / D (one step a lane, a shuffle tree in the pairwise order, Kahan
//     across chunks: the value equals the forward kernel's to f64 rounding);
//     back, computes each step's Ub, Vb, Pb, Ab from the chain lane's
//     outputs and the staged records (adj_post) and chains them into
//     per-lane partial sums, and writes dll/dr = zb, coalesced.
// The warps hand chunks over through a ring of shared-memory buffers (two a
// kind forward; back, three stages of records and columns and two of chain
// outputs) with one block barrier a chunk: a chunk is filled before the
// chain lane reaches it and drained after it leaves, and the barrier costs
// the chain about one step in 32.  The chain lane's step loops are unrolled
// four steps (kChainUnroll), so that a step's stores and the next step's
// loads overlap the following steps' chain (the fastest of 1, 2 and 4 at R
// = 1, 3 and 7 on an H100).  At the end the post warp reduces its
// lanes' partial sums by shuffles in a fixed order: no atomics, so two
// launches on the same inputs give the same bits.  A record holds D, z, W,
// f and the packed S (2 + 2R + R(R+1)/2 words); the prep warp recomputes P
// and V on the way back from tc, dt and the coefficients rather than store
// them (the same function of the same inputs, so the same bits).  At N =
// 5000, R = 3 the workspace is 560 KB, in the 50 MB L2.
//
// Templated on R = Jr + 2 Jc for R <= 8 (the chain's state in registers);
// any larger R takes the runtime-R body: the coefficients, the chain's state
// and the post warp's per-lane work arrays ([7R][32]) live in shared memory.
// The chunk buffers grow as R^2 and fill the 227 KB a block can have at R =
// 14; from there (layout()) they move to a global scratch area of the
// block's own, which the same code reads and writes (it stays in the L2;
// __syncthreads orders global as well as shared memory within a block), and
// from R = 90 the aux area follows them.  So every R runs, the larger ones
// slower.  double only: the MAP objective is float64 in both
// packages.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC (celerite_grad_f64.cu).  The per-step routines (columns,
// fwd_step, adj_step, adj_post) are plain C++ (CG_DEV), so they also
// compile for the host, where a harness can run them in sequence against
// the plain version.

#pragma once

#include <math.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define CG_DEV __device__ __forceinline__
#define CG_HD __host__ __device__ inline
#else
#define CG_DEV inline
#define CG_HD inline
#endif

namespace celerite_grad {

constexpr int kChunk = 32;     // steps a chunk: the pipeline's and the value's sums'
constexpr int kMaxStatic = 8;  // R with a compile-time body

CG_HD int packed(int i, int j, int R) {
  // index of (min(i, j), max(i, j)) in the packed upper triangle
  return i <= j ? i * R - (i * (i - 1)) / 2 + (j - i) : j * R - (j * (j - 1)) / 2 + (i - j);
}

// A record of one step: D, z, W (R), f (R), packed S (R(R+1)/2).  The
// chain lane's adjoint outputs use the same layout: zb, Db, Wb, fb, G.
CG_HD int record_words(int R) { return 2 + 2 * R + R * (R + 1) / 2; }
constexpr int kW = 2;  // offset of W (Wb); f (fb) at 2 + R, S (G) at 2 + 2R

// A strided view: element i at p[i * st] (st = 1 for a register array).
struct CVec {
  const double* p;
  int st;
  CG_DEV double operator[](int i) const { return p[i * st]; }
};

struct Vec {
  double* p;
  int st;
  CG_DEV double& operator[](int i) const { return p[i * st]; }
};

// The per-column constants of one likelihood: real j: (ca, cc) = (a, c); a
// complex pair's two columns: ca = (a, b), cc = (c, c), cd = (d, d).  A
// compile-time R keeps them in registers; the runtime-R body points them at
// a table of 3R words that the block shares.
template <int RT>
struct Coeffs {
  int jr, R;
  double ca[RT], cc[RT], cd[RT];
  double k0;  // extra_diag + sum a_j + sum a_q
};

template <>
struct Coeffs<0> {
  int jr, R;
  double *ca, *cc, *cd;
  double k0;
};

// k0 always; the columns' constants when `fill` (the runtime-R body fills
// its shared table from one thread).
template <int RT>
CG_DEV void load_coeffs(Coeffs<RT>& c, int jr, int jc, const double* ar, const double* cr, const double* ac,
                        const double* bc, const double* cc, const double* dc, double extra, bool fill = true) {
  const int R = RT > 0 ? RT : jr + 2 * jc;
  c.jr = jr;
  c.R = R;
  c.k0 = extra;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < jr) {
      if (fill) {
        c.ca[i] = ar[i];
        c.cc[i] = cr[i];
        c.cd[i] = 0.0;
      }
      c.k0 += ar[i];
    } else {
      const int q = (i - jr) >> 1;
      const bool first = ((i - jr) & 1) == 0;
      if (fill) {
        c.ca[i] = first ? ac[q] : bc[q];
        c.cc[i] = cc[q];
        c.cd[i] = dc[q];
      }
      if (first) c.k0 += ac[q];
    }
  }
}

// A step's columns U, V, P from the coefficients, tc and dt; column i at
// U[i * st].
template <int RT>
CG_DEV void columns(const Coeffs<RT>& c, double tcn, double h, double* U, double* V, double* P, int st) {
  const int R = RT > 0 ? RT : c.R;
  const int jr = c.jr;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < jr) {
      P[i * st] = exp(-c.cc[i] * h);
      V[i * st] = 1.0;
      U[i * st] = c.ca[i];
    } else if (((i - jr) & 1) == 0 && i + 1 < R) {
      double sn, cs;
      sincos(c.cd[i] * tcn, &sn, &cs);
      const double e = exp(-c.cc[i] * h);
      P[i * st] = e;
      P[(i + 1) * st] = e;
      V[i * st] = cs;
      V[(i + 1) * st] = sn;
      U[i * st] = c.ca[i] * cs + c.ca[i + 1] * sn;
      U[(i + 1) * st] = c.ca[i] * sn - c.ca[i + 1] * cs;
    }
  }
}

// One forward step of the chain: the state S (NS), W, f and D, z from step
// n-1 to step n (first: n = 0); `s` is scratch (R).  Writes the step's
// record, field k at out[k * os].
template <int RT>
CG_DEV void fwd_step(int Rrt, bool first, CVec U, CVec V, CVec P, double A, double r, double* S, double* W,
                     double* f, double* s, double& D, double& z, double* out, int os) {
  const int R = RT > 0 ? RT : Rrt;
  const int NS = R * (R + 1) / 2;
  if (first) {
#pragma unroll
    for (int e = 0; e < NS; ++e) S[e] = 0.0;
    D = A;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      f[i] = 0.0;
      W[i] = V[i] / D;
    }
    z = r;
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
    D = A - uSu;
    const double Dinv = 1.0 / D;
#pragma unroll
    for (int i = 0; i < R; ++i) W[i] = (V[i] - s[i]) * Dinv;
    z = r - uf;
  }
  out[0] = D;
  out[os] = z;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    out[(kW + i) * os] = W[i];
    out[(kW + R + i) * os] = f[i];
  }
#pragma unroll
  for (int e = 0; e < NS; ++e) out[(kW + 2 * R + e) * os] = S[e];
}

// The step's constants of the adjoint that depend on its record alone.
struct AdjConst {
  double Dinv, cz, cD;  // 1 / D, -z / D, -(1/D - z^2/D^2) / 2
};

CG_DEV AdjConst adj_const(double D, double z) {
  AdjConst k;
  k.Dinv = 1.0 / D;
  k.cz = -z * k.Dinv;
  k.cD = -0.5 * (k.Dinv - z * z * k.Dinv * k.Dinv);
  return k;
}

// One adjoint step of the chain at step n: W, U, P and the constants are
// step n's, Wp, Dp, zp step n-1's (used when has_prev).  The state G (NS),
// fb, Wb, Db, zb holds the adjoints of step n's outputs on entry and of
// step n-1's on exit; sb, gb are scratch (R).  Writes what adj_post needs,
// field k at out[k * os]: zb, Db (= Ab), Wb (as it came in), fb (after the
// z term), G (before the decay).
template <int RT>
CG_DEV void adj_step(int Rrt, bool has_prev, CVec W, CVec U, CVec P, AdjConst k, CVec Wp, double Dp, double zp,
                     double* G, double* fb, double* Wb, double* sb, double* gb, double& Db, double& zb, double* out,
                     int os) {
  const int R = RT > 0 ? RT : Rrt;
  zb += k.cz;
  Db += k.cD;
  out[0] = zb;
  double WbW = 0.0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    fb[i] += -zb * U[i];
    WbW += Wb[i] * W[i];
  }
  Db += -WbW * k.Dinv;
  out[os] = Db;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    out[(kW + i) * os] = Wb[i];
    out[(kW + R + i) * os] = fb[i];
    sb[i] = -(Wb[i] * k.Dinv) - Db * U[i];
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = i; j < R; ++j) {
      const int e = packed(i, j, R);
      G[e] += 0.5 * (sb[i] * U[j] + U[i] * sb[j]);
      out[(kW + 2 * R + e) * os] = G[e];
    }
  }
  if (has_prev) {
    double zb_prev = 0.0, Db_prev = 0.0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      gb[i] = P[i] * fb[i];
      zb_prev += gb[i] * Wp[i];
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = i; j < R; ++j) {
        const int e = packed(i, j, R);
        G[e] = (P[i] * P[j]) * G[e];
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      double acc = 0.0;
#pragma unroll
      for (int j = 0; j < R; ++j) acc += G[packed(i, j, R)] * Wp[j];
      Db_prev += Wp[i] * acc;
      Wb[i] = 2.0 * Dp * acc + gb[i] * zp;
      fb[i] = gb[i];
    }
    Db = Db_prev;
    zb = zb_prev;
  }
}

// The off-chain part of adjoint step n: from the chain lane's outputs `ch`
// (stride os), step n's record `rec` and step n-1's `prv` (stride rs; prv
// used when has_prev), and step n's columns, the step's Ub, Vb, Pb and Ab,
// added into the partial sums accU, accP (R) and Asum.  The work arrays s,
// sb, Ub, Vb, Pb are registers for a compile-time R, else the 5R words
// tmp[k * ts].
template <int RT>
CG_DEV void adj_post(const Coeffs<RT>& c, bool has_prev, const double* rec, const double* prv, int rs, CVec U,
                     CVec V, CVec P, double Dinv, double tcn, double h, const double* ch, int os, Vec accU,
                     Vec accP, double& Asum, double* tmp, int ts) {
  const int R = RT > 0 ? RT : c.R;
  const int jr = c.jr;
  double reg[RT > 0 ? 5 * RT : 1];
  double* w = RT > 0 ? reg : tmp;
  const int wt = RT > 0 ? 1 : ts;
  const Vec s{w, wt}, sb{w + R * wt, wt}, Ub{w + 2 * R * wt, wt}, Vb{w + 3 * R * wt, wt}, Pb{w + 4 * R * wt, wt};
  const double zb = ch[0], Db = ch[os];
  const double* S = rec + (kW + 2 * R) * rs;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < R; ++j) acc += S[packed(i, j, R) * rs] * U[j];
    s[i] = acc;
    Ub[i] = -zb * rec[(kW + R + i) * rs];
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    Ub[i] += -Db * s[i];
    Vb[i] = ch[(kW + i) * os] * Dinv;
    sb[i] = -Vb[i] - Db * U[i];
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < R; ++j) acc += S[packed(i, j, R) * rs] * sb[j];
    Ub[i] += acc;
    Pb[i] = 0.0;
  }
  if (has_prev) {
    const double Dp = prv[0], zp = prv[rs];
    const double* Sp = prv + (kW + 2 * R) * rs;
#pragma unroll
    for (int i = 0; i < R; ++i)
      Pb[i] = ch[(kW + R + i) * os] * (prv[(kW + R + i) * rs] + prv[(kW + i) * rs] * zp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = i; j < R; ++j) {
        const int e = packed(i, j, R);
        const double GM = ch[(kW + 2 * R + e) * os] * (Sp[e * rs] + Dp * (prv[(kW + i) * rs] * prv[(kW + j) * rs]));
        Pb[i] += 2.0 * GM * P[j];
        if (j != i) Pb[j] += 2.0 * GM * P[i];
      }
    }
  }
  Asum += Db;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < jr) {
      accU[i] += Ub[i];
      accP[i] += Pb[i] * (-h * P[i]);
    } else if (((i - jr) & 1) == 0 && i + 1 < R) {
      const double cs = V[i], sn = V[i + 1];
      accU[i] += Ub[i] * cs + Ub[i + 1] * sn;
      accU[i + 1] += Ub[i] * sn - Ub[i + 1] * cs;
      accP[i] += (Pb[i] + Pb[i + 1]) * (-h * P[i]);
      accP[i + 1] += tcn * (U[i] * Ub[i + 1] - U[i + 1] * Ub[i] + cs * Vb[i + 1] - sn * Vb[i]);
    }
  }
}

// ---- a block's buffers (in doubles) ------------------------------------ //
// The chunk buffers: forward, operands [2][3R + 2][32] (U, P, V, A, r) and
// chain outputs [2][REC][32]; back, stages [3][(32 + 1) x REC records + 32 x
// (3R + 5) columns (U, P, V, 1 / D, -z / D, the Db term, tc, dt)] and chain
// outputs [2][REC][32]; the two passes share the space.  The runtime-R body's
// aux area: the coefficient table [3R], the chain state (S, W, f, s, G, fb,
// Wb, sb, gb) and the post warp's work arrays [7R][32] (adj_post's five,
// then accU, accP).
CG_HD int fwd_op_words(int R) { return kChunk * (3 * R + 2); }
CG_HD int stage_words(int R) { return (kChunk + 1) * record_words(R) + kChunk * (3 * R + 5); }
CG_HD int out_words(int R) { return kChunk * record_words(R); }
CG_HD int buf_words(int R) {
  const int fwd = 2 * fwd_op_words(R) + 2 * out_words(R);
  const int adj = 3 * stage_words(R) + 2 * out_words(R);
  return fwd > adj ? fwd : adj;
}
CG_HD int state_words(int R) { return R * (R + 1) + 7 * R; }
CG_HD int lane_words(int R) { return 7 * R; }
CG_HD int aux_words(int R) { return R > kMaxStatic ? 3 * R + state_words(R) + kChunk * lane_words(R) : 0; }

// Where a block's areas live, given the shared memory a block may have
// (cap, in doubles): place 0, the aux area and the chunk buffers in shared
// memory; 1, the buffers in the global scratch; 2, both there.  smem and
// scratch are the words of each (scratch a block).  A compile-time body
// keeps its buffers in shared memory (at most 93 KB, at R = 8).
struct Layout {
  int place;
  long long smem, scratch;
};

CG_HD Layout layout(int R, long long cap) {
  const long long aux = aux_words(R), buf = buf_words(R);
  if (R <= kMaxStatic || aux + buf <= cap) return {0, aux + buf, 0};
  if (aux <= cap) return {1, aux, buf};
  return {2, 0, aux + buf};
}

}  // namespace celerite_grad
