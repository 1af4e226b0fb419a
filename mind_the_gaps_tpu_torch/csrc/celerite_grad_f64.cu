// The CUDA kernel of the celerite log-likelihood and its gradient: one block
// of three warps a likelihood, a chain lane and two helper warps handing
// 32-step chunks to each other through shared memory, or, at an R whose
// buffers do not fit there, through a global scratch area of the block's own
// (celerite_grad.cuh holds the per-step routines, the layout and the design
// note).

#include "celerite_grad.cuh"

namespace celerite_grad {

constexpr int kThreads = 96;  // warp 0: the chain lane; warp 1: prep; warp 2: post
constexpr int kChainWarp = 0, kPrepWarp = 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory a launch gets without opting in
constexpr int kStaticSmem = 256;            // bytes of the opt-in limit left for the kernel's static s_ok
// steps of the chain lane's loops unrolled together (static R), so that a
// step's stores and the next operands' loads overlap the next step's chain
constexpr int kChainUnroll = 4;

__device__ __forceinline__ void kahan_add(double& s, double& c, double x) {
  const double yk = x - c;
  const double tk = s + yk;
  c = (tk - s) - yk;
  s = tk;
}

// The sum of v over the warp's lanes in a fixed order (neighbours first),
// the same bits in every lane.
__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 1; off < 32; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The chain lane's operands of forward step k (static R): U, V, P, A_n, r_n
// from the prep warp's buffer (field-major, 32 steps).
template <int RT>
struct FwdOperands {
  double u[RT], v[RT], p[RT], A, r;
  __device__ __forceinline__ void load(const double* o, int k) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      u[i] = o[i * kChunk + k];
      p[i] = o[(RT + i) * kChunk + k];
      v[i] = o[(2 * RT + i) * kChunk + k];
    }
    A = o[3 * RT * kChunk + k];
    r = o[(3 * RT + 1) * kChunk + k];
  }
};

// The chain lane's operands of adjoint step k (static R): its W, U, P and
// constants, and step k-1's W, D, z, from a stage (records [REC][33],
// entry k + 1 for step k; columns [3R + 5][32]).
template <int RT>
struct AdjOperands {
  double w[RT], u[RT], p[RT], wp[RT], Dp, zp;
  AdjConst k;
  __device__ __forceinline__ void load(const double* rec, const double* col, int j) {
    constexpr int E = kChunk + 1;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      w[i] = rec[(kW + i) * E + j + 1];
      u[i] = col[i * kChunk + j];
      p[i] = col[(RT + i) * kChunk + j];
      wp[i] = rec[(kW + i) * E + j];
    }
    k.Dinv = col[3 * RT * kChunk + j];
    k.cz = col[(3 * RT + 1) * kChunk + j];
    k.cD = col[(3 * RT + 2) * kChunk + j];
    Dp = rec[j];
    zp = rec[E + j];
  }
};

// PLACE is layout()'s placement, a template argument so that a buffer in
// shared memory is addressed as such (a pointer that may be either takes
// generic loads, which cost the kernel 16-21% at R = 1 to 10 on an H100).
template <int RT, int PLACE>
__global__ void __launch_bounds__(kThreads, 1)
grad_kernel(int jr, int jc, const double* __restrict__ tc, const double* __restrict__ dt,
            const double* __restrict__ y, int y_rows, const double* __restrict__ diag,
            const double* __restrict__ ar, const double* __restrict__ cr, const double* __restrict__ ac,
            const double* __restrict__ bc, const double* __restrict__ cc, const double* __restrict__ dc,
            const double* __restrict__ mean, const double* __restrict__ extra_diag, int N, double* ws_all,
            double* __restrict__ ll, double* __restrict__ g_ar, double* __restrict__ g_cr,
            double* __restrict__ g_ac, double* __restrict__ g_bc, double* __restrict__ g_cc,
            double* __restrict__ g_dc, double* __restrict__ g_extra, double* __restrict__ g_r_all,
            double* scratch) {
  extern __shared__ __align__(16) double sm[];
  __shared__ int s_ok;
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = RT > 0 ? RT : jr + 2 * jc;
  const int NS = R * (R + 1) / 2, REC = record_words(R);
  constexpr int RC = RT > 0 ? RT : 1;  // the chain lane's register arrays
  const int C = (N + kChunk - 1) / kChunk;
  double* ws = ws_all + (long long)b * N * REC;  // written and read back here: plain loads
  const double* yb = y + (y_rows == 1 ? 0 : (long long)b * N);
  double* g_r = g_r_all + (long long)b * N;
  // the aux area (runtime R) and the chunk buffers, in shared memory or in
  // the block's part of the global scratch (layout())
  const int AUX = aux_words(R), BUF = buf_words(R);
  double* gs = scratch + (long long)b * (PLACE == 0 ? 0 : PLACE == 1 ? BUF : AUX + BUF);
  double* aux = PLACE < 2 ? sm : gs;
  double* buf = PLACE == 0 ? sm + AUX : PLACE == 1 ? gs : gs + AUX;
  double* st = aux + 3 * R;                      // the runtime-R chain state
  double* lw = st + state_words(R) + lane;       // the post lane's work arrays, stride 32
  Coeffs<RT> cf;
  if constexpr (RT == 0) {
    cf.ca = aux;
    cf.cc = aux + R;
    cf.cd = aux + 2 * R;
  }
  load_coeffs<RT>(cf, jr, jc, ar + b * jr, cr + b * jr, ac + b * jc, bc + b * jc, cc + b * jc, dc + b * jc,
                  extra_diag ? extra_diag[b] : 0.0, RT > 0 || threadIdx.x == 0);
  const double m = mean ? mean[b] : 0.0;

  const int FOP = fwd_op_words(R), OUT = out_words(R), STG = stage_words(R);
  double* fop = buf;             // forward operands [2][FOP]: U, P, V, A, r (field-major, 32 steps)
  double* fout = buf + 2 * FOP;  // forward chain outputs [2][OUT]: the records (field-major)
  double* stage = buf;           // adjoint stages [3][STG]
  double* aout = buf + 3 * STG;  // adjoint chain outputs [2][OUT]

  // the chain lane's state: registers, or shared memory for the runtime-R body
  double r_S[RC * (RC + 1) / 2], r_W[RC], r_f[RC], r_s[RC];
  double r_G[RC * (RC + 1) / 2], r_fb[RC], r_Wb[RC], r_sb[RC], r_gb[RC];
  double* S = RT > 0 ? r_S : st;
  double* W = RT > 0 ? r_W : st + NS;
  double* f = RT > 0 ? r_f : st + NS + R;
  double* s = RT > 0 ? r_s : st + NS + 2 * R;
  double* G = RT > 0 ? r_G : st + NS + 3 * R;
  double* fb = RT > 0 ? r_fb : st + 2 * NS + 3 * R;
  double* Wb = RT > 0 ? r_Wb : st + 2 * NS + 4 * R;
  double* sb = RT > 0 ? r_sb : st + 2 * NS + 5 * R;
  double* gb = RT > 0 ? r_gb : st + 2 * NS + 6 * R;

  // ---- forward --------------------------------------------------------- //
  // prep: chunk c's operands into fop[c & 1], one step a lane
  auto fwd_prep = [&](int c) {
    const int n = c * kChunk + lane;
    if (n < N) {
      double* o = fop + (c & 1) * FOP;
      columns<RT>(cf, tc[n], dt[n], o + lane, o + 2 * R * kChunk + lane, o + R * kChunk + lane, kChunk);
      o[3 * R * kChunk + lane] = diag[n] + cf.k0;
      o[(3 * R + 1) * kChunk + lane] = yb[n] - m;
    }
  };

  // the chain lane over chunk c: operands from fop[c & 1], records to fout[c & 1]
  double D = 0.0, z = 0.0;
  auto fwd_chain = [&](int c) {
    const double* o = fop + (c & 1) * FOP;
    double* out = fout + (c & 1) * OUT;
    const int n0 = c * kChunk, cnt = N - n0 < kChunk ? N - n0 : kChunk;
    if constexpr (RT > 0) {
      // the step's operands in registers, the next step's loaded before the step runs
      FwdOperands<RT> cur, nxt;
      cur.load(o, 0);
#pragma unroll (kChainUnroll)
      for (int k = 0; k < cnt; ++k) {
        nxt.load(o, k + 1 < cnt ? k + 1 : k);
        fwd_step<RT>(RT, n0 + k == 0, CVec{cur.u, 1}, CVec{cur.v, 1}, CVec{cur.p, 1}, cur.A, cur.r, S, W, f, s, D,
                     z, out + k, kChunk);
        cur = nxt;
      }
    } else {
      for (int k = 0; k < cnt; ++k)
        fwd_step<RT>(R, n0 + k == 0, CVec{o + k, kChunk}, CVec{o + 2 * R * kChunk + k, kChunk},
                     CVec{o + R * kChunk + k, kChunk}, o[3 * R * kChunk + k], o[(3 * R + 1) * kChunk + k], S, W, f,
                     s, D, z, out + k, kChunk);
    }
  };

  // post: chunk c's records to the workspace (coalesced) and its value terms
  double logdet = 0.0, lcomp = 0.0, quad = 0.0, qcomp = 0.0;
  bool ok = true;
  auto fwd_post = [&](int c) {
    const double* out = fout + (c & 1) * OUT;
    const int n0 = c * kChunk, cnt = N - n0 < kChunk ? N - n0 : kChunk;
    double* dst = ws + (long long)n0 * REC;
    for (int w = lane; w < cnt * REC; w += 32) {
      const int e = w / REC;
      dst[w] = out[(w - e * REC) * kChunk + e];
    }
    double xl = 0.0, xq = 0.0;
    if (lane < cnt) {
      const double Dk = out[lane], zk = out[kChunk + lane];
      ok = ok && (Dk > 0.0);
      xl = log(fabs(Dk));
      xq = zk * zk / Dk;
    }
    kahan_add(logdet, lcomp, warp_sum(xl));
    kahan_add(quad, qcomp, warp_sum(xq));
  };

  if constexpr (RT == 0) __syncthreads();  // the coefficient table
  if (warp == kPrepWarp) fwd_prep(0);
  __syncthreads();
  for (int c = 0; c <= C; ++c) {
    if (warp == kChainWarp) {
      if (lane == 0 && c < C) fwd_chain(c);
    } else if (warp == kPrepWarp) {
      if (c + 1 < C) fwd_prep(c + 1);
    } else if (c > 0) {
      fwd_post(c - 1);
    }
    __syncthreads();
  }
  if (warp == 2) {
    ok = __all_sync(kFull, ok);
    if (lane == 0) {
      s_ok = ok;
      ll[b] = ok ? -0.5 * (quad + logdet + double(N) * 1.8378770664093453)  // N log(2 pi)
                 : __longlong_as_double(0xfff0000000000000LL);
    }
  }
  __syncthreads();
  if (!s_ok) {  // not positive definite: -inf (above) and a zero gradient
    for (int n = threadIdx.x; n < N; n += kThreads) g_r[n] = 0.0;
    if (threadIdx.x == 0) {
      for (int j = 0; j < jr; ++j) g_ar[b * jr + j] = g_cr[b * jr + j] = 0.0;
      for (int q = 0; q < jc; ++q)
        g_ac[b * jc + q] = g_bc[b * jc + q] = g_cc[b * jc + q] = g_dc[b * jc + q] = 0.0;
      g_extra[b] = 0.0;
    }
    return;
  }

  // ---- adjoint ----------------------------------------------------------- //
  // A stage holds the records of steps n0 - 1 .. n0 + 31 ([REC][33], entry
  // j = step n0 - 1 + j) and the columns and constants of steps n0 .. n0 + 31
  // ([3R + 5][32]: U, P, V, 1 / D, -z / D, the Db term, tc, dt).
  constexpr int E = kChunk + 1;
  auto adj_prep = [&](int q, int slot) {
    double* rec = stage + slot * STG;
    double* col = rec + E * REC;
    const int n0 = q * kChunk, cnt = N - n0 < kChunk ? N - n0 : kChunk;
    const int j0 = q > 0 ? 0 : 1;  // step n0 - 1 exists for q > 0
    const double* src = ws + (long long)(n0 - 1 + j0) * REC;
    for (int w = lane; w < (cnt + 1 - j0) * REC; w += 32) {
      const int e = w / REC;
      rec[(w - e * REC) * E + j0 + e] = src[w];
    }
    __syncwarp();
    if (lane < cnt) {
      const int n = n0 + lane;
      const double tcn = tc[n], h = dt[n];
      columns<RT>(cf, tcn, h, col + lane, col + 2 * R * kChunk + lane, col + R * kChunk + lane, kChunk);
      const AdjConst k = adj_const(rec[lane + 1], rec[E + lane + 1]);
      col[3 * R * kChunk + lane] = k.Dinv;
      col[(3 * R + 1) * kChunk + lane] = k.cz;
      col[(3 * R + 2) * kChunk + lane] = k.cD;
      col[(3 * R + 3) * kChunk + lane] = tcn;
      col[(3 * R + 4) * kChunk + lane] = h;
    }
  };

  // the chain lane over chunk q, last step first
  double Db = 0.0, zb = 0.0;
  auto adj_chain = [&](int q, const double* rec, double* out) {
    const double* col = rec + E * REC;
    const int n0 = q * kChunk, cnt = N - n0 < kChunk ? N - n0 : kChunk;
    if constexpr (RT > 0) {
      // the step's operands in registers, the next step's loaded before the step runs
      AdjOperands<RT> cur, nxt;
      cur.load(rec, col, cnt - 1);
#pragma unroll (kChainUnroll)
      for (int k = cnt - 1; k >= 0; --k) {
        nxt.load(rec, col, k > 0 ? k - 1 : k);
        adj_step<RT>(RT, n0 + k > 0, CVec{cur.w, 1}, CVec{cur.u, 1}, CVec{cur.p, 1}, cur.k, CVec{cur.wp, 1}, cur.Dp,
                     cur.zp, G, fb, Wb, sb, gb, Db, zb, out + k, kChunk);
        cur = nxt;
      }
    } else {
      for (int k = cnt - 1; k >= 0; --k) {
        const AdjConst ck{col[3 * R * kChunk + k], col[(3 * R + 1) * kChunk + k], col[(3 * R + 2) * kChunk + k]};
        adj_step<RT>(R, n0 + k > 0, CVec{rec + kW * E + k + 1, E}, CVec{col + k, kChunk},
                     CVec{col + R * kChunk + k, kChunk}, ck, CVec{rec + kW * E + k, E}, rec[k], rec[E + k], G, fb,
                     Wb, sb, gb, Db, zb, out + k, kChunk);
      }
    }
  };

  // post: each step's Ub, Vb, Pb, Ab into the lane's partial sums; dll/dr
  // (registers for a compile-time R, else the lane's work arrays)
  double r_accU[RC], r_accP[RC], Asum = 0.0;
  double* accU = RT > 0 ? r_accU : lw + 5 * R * kChunk;
  double* accP = RT > 0 ? r_accP : lw + 6 * R * kChunk;
  constexpr int ast = RT > 0 ? 1 : kChunk;
  if (warp == 2) {
#pragma unroll
    for (int i = 0; i < R; ++i) accU[i * ast] = accP[i * ast] = 0.0;
  }
  auto adj_post_chunk = [&](int q, const double* rec, const double* out) {
    const double* col = rec + E * REC;
    const int n0 = q * kChunk, cnt = N - n0 < kChunk ? N - n0 : kChunk;
    if (lane < cnt) {
      const int k = lane, n = n0 + k;
      adj_post<RT>(cf, n > 0, rec + k + 1, rec + k, E, CVec{col + k, kChunk}, CVec{col + 2 * R * kChunk + k, kChunk},
                   CVec{col + R * kChunk + k, kChunk}, col[3 * R * kChunk + k], col[(3 * R + 3) * kChunk + k],
                   col[(3 * R + 4) * kChunk + k], out + k, kChunk, Vec{accU, ast}, Vec{accP, ast}, Asum, lw,
                   kChunk);
      g_r[n] = out[k];
    }
  };

  if (warp == kChainWarp && lane == 0) {
#pragma unroll
    for (int e = 0; e < NS; ++e) G[e] = 0.0;
#pragma unroll
    for (int i = 0; i < R; ++i) fb[i] = Wb[i] = 0.0;
  }
  if (warp == kPrepWarp) adj_prep(C - 1, 0);
  __syncthreads();
  for (int i = 0; i <= C; ++i) {
    const int q = C - 1 - i;  // the chunk the chain lane runs
    if (warp == kChainWarp) {
      if (lane == 0 && q >= 0) adj_chain(q, stage + (i % 3) * STG, aout + (i & 1) * OUT);
    } else if (warp == kPrepWarp) {
      if (q > 0) adj_prep(q - 1, (i + 1) % 3);
    } else if (i > 0) {
      adj_post_chunk(q + 1, stage + ((i - 1) % 3) * STG, aout + ((i - 1) & 1) * OUT);
    }
    __syncthreads();
  }

  // the post warp's partial sums, reduced in a fixed order
  if (warp == 2) {
    const double A = warp_sum(Asum);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const double u = warp_sum(accU[i * ast]), p = warp_sum(accP[i * ast]);
      if (lane != 0) continue;
      if (i < jr) {
        g_ar[b * jr + i] = u + A;
        g_cr[b * jr + i] = p;
      } else {
        const int q = (i - jr) >> 1;
        if (((i - jr) & 1) == 0) {
          g_ac[b * jc + q] = u + A;
          g_cc[b * jc + q] = p;
        } else {
          g_bc[b * jc + q] = u;
          g_dc[b * jc + q] = p;
        }
      }
    }
    if (lane == 0) g_extra[b] = A;
  }
}

template <int RT, int PLACE>
int launch(int Jr, int Jc, const double* tc, const double* dt, const double* y, int y_rows, const double* diag,
           const double* ar, const double* cr, const double* ac, const double* bc, const double* cc, const double* dc,
           const double* mean, const double* extra_diag, int B, int N, double* ws, double* ll, double* g_ar,
           double* g_cr, double* g_ac, double* g_bc, double* g_cc, double* g_dc, double* g_extra, double* g_r,
           const Layout& lay, double* scratch, cudaStream_t stream) {
  const size_t smem = sizeof(double) * lay.smem;
  auto kernel = grad_kernel<RT, PLACE>;
  if (smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, kThreads, smem, stream>>>(Jr, Jc, tc, dt, y, y_rows, diag, ar, cr, ac, bc, cc, dc, mean, extra_diag, N,
                                        ws, ll, g_ar, g_cr, g_ac, g_bc, g_cc, g_dc, g_extra, g_r, scratch);
  return static_cast<int>(cudaGetLastError());
}

// The layout of a block at this R on the current device.
int device_layout(int R, Layout& lay) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  lay = layout(R, (optin - kStaticSmem) / (long long)sizeof(double));
  return 0;
}

}  // namespace celerite_grad

// The float64 words of the global scratch a launch of B likelihoods at R =
// Jr + 2 Jc needs on the current device (0: none), or -2 for a bad size, or
// minus the cudaError_t of the device query.
extern "C" long long celerite_grad_f64_scratch_words(int Jr, int Jc, int B) {
  using namespace celerite_grad;
  const int R = Jr + 2 * Jc;
  if (B <= 0 || Jr < 0 || Jc < 0 || R < 1) return -2;
  Layout lay;
  const int err = device_layout(R, lay);
  if (err != 0) return -(long long)err;
  return lay.scratch * B;
}

// C entry point.  Pointers are device pointers to float64 data: tc, dt and
// diag (N,); y (N,) shared (y_rows = 1) or (B, N) per element (y_rows = B);
// coefficients (B, Jr) / (B, Jc) row-major; mean and extra_diag (B,) or
// null; ws B * N * (2 + 2R + R(R+1)/2) doubles; scratch the words that
// celerite_grad_f64_scratch_words gives (null when it gives 0); outputs ll
// (B,), the coefficient gradients in the coefficients' shapes, g_extra (B,)
// and g_r (B, N).  Any R = Jr + 2 Jc >= 1.
// Returns 0, -2 for a bad size or a missing scratch, or the cudaError_t of
// the device query or the launch.
extern "C" int celerite_grad_f64(int Jr, int Jc, const void* tc, const void* dt, const void* y, int y_rows,
                                 const void* diag, const void* ar, const void* cr, const void* ac,
                                 const void* bc, const void* cc, const void* dc, const void* mean,
                                 const void* extra_diag, int B, int N, void* ws, void* scratch, void* ll,
                                 void* g_ar, void* g_cr, void* g_ac, void* g_bc, void* g_cc, void* g_dc,
                                 void* g_extra, void* g_r, void* stream) {
  using namespace celerite_grad;
  using T = double;
  const int R = Jr + 2 * Jc;
  if (B <= 0 || N <= 0 || Jr < 0 || Jc < 0 || R < 1 || (y_rows != 1 && y_rows != B)) return -2;
  Layout lay;
  const int err = device_layout(R, lay);
  if (err != 0) return err;
  if (lay.scratch > 0 && scratch == nullptr) return -2;
#define CELERITE_GRAD_ARGS                                                                             \
  Jr, Jc, (const T*)tc, (const T*)dt, (const T*)y, y_rows, (const T*)diag, (const T*)ar, (const T*)cr, \
      (const T*)ac, (const T*)bc, (const T*)cc, (const T*)dc, (const T*)mean, (const T*)extra_diag, B, \
      N, (T*)ws, (T*)ll, (T*)g_ar, (T*)g_cr, (T*)g_ac, (T*)g_bc, (T*)g_cc, (T*)g_dc, (T*)g_extra,      \
      (T*)g_r, lay, (T*)scratch, (cudaStream_t)stream
  switch (R) {
    case 1: return launch<1, 0>(CELERITE_GRAD_ARGS);
    case 2: return launch<2, 0>(CELERITE_GRAD_ARGS);
    case 3: return launch<3, 0>(CELERITE_GRAD_ARGS);
    case 4: return launch<4, 0>(CELERITE_GRAD_ARGS);
    case 5: return launch<5, 0>(CELERITE_GRAD_ARGS);
    case 6: return launch<6, 0>(CELERITE_GRAD_ARGS);
    case 7: return launch<7, 0>(CELERITE_GRAD_ARGS);
    case 8: return launch<8, 0>(CELERITE_GRAD_ARGS);
    default:
      return lay.place == 0   ? launch<0, 0>(CELERITE_GRAD_ARGS)
             : lay.place == 1 ? launch<0, 1>(CELERITE_GRAD_ARGS)
                              : launch<0, 2>(CELERITE_GRAD_ARGS);
  }
#undef CELERITE_GRAD_ARGS
  static_assert(kMaxStatic == 8, "the switch above instantiates R = 1..kMaxStatic");
}
