// The CUDA kernel of the celerite log-likelihood and its gradient
// (celerite_grad.cuh holds the per-likelihood routine and its design note):
// one thread per likelihood, blocks of kThreads.

#include "celerite_grad.cuh"

namespace celerite_grad {

constexpr int kThreads = 32;

template <int RT>
__global__ void __launch_bounds__(kThreads)
grad_kernel(int jr, int jc, const double* __restrict__ tc, const double* __restrict__ dt,
            const double* __restrict__ y, int y_rows, const double* __restrict__ diag,
            const double* __restrict__ ar, const double* __restrict__ cr, const double* __restrict__ ac,
            const double* __restrict__ bc, const double* __restrict__ cc, const double* __restrict__ dc,
            const double* __restrict__ mean, const double* __restrict__ extra_diag, int B, int N,
            double* __restrict__ ws, double* __restrict__ scratch, double* __restrict__ ll,
            double* __restrict__ g_ar, double* __restrict__ g_cr, double* __restrict__ g_ac,
            double* __restrict__ g_bc, double* __restrict__ g_cc, double* __restrict__ g_dc,
            double* __restrict__ g_extra, double* __restrict__ g_r) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const int R = jr + 2 * jc;
  Inputs in;
  in.jr = jr;
  in.jc = jc;
  in.N = N;
  in.tc = tc;
  in.dt = dt;
  in.y = y + (y_rows == 1 ? 0 : (long long)b * N);
  in.diag = diag;
  in.ar = ar + b * jr;
  in.cr = cr + b * jr;
  in.ac = ac + b * jc;
  in.bc = bc + b * jc;
  in.cc = cc + b * jc;
  in.dc = dc + b * jc;
  in.mean = mean ? mean[b] : 0.0;
  in.extra = extra_diag ? extra_diag[b] : 0.0;
  Outputs out;
  out.ll = ll + b;
  out.g_ar = g_ar + b * jr;
  out.g_cr = g_cr + b * jr;
  out.g_ac = g_ac + b * jc;
  out.g_bc = g_bc + b * jc;
  out.g_cc = g_cc + b * jc;
  out.g_dc = g_dc + b * jc;
  out.g_extra = g_extra + b;
  out.g_r = g_r + (long long)b * N;
  loglike_and_grad<RT>(in, ws + (long long)b * N * record_words(R),
                       RT > 0 ? nullptr : scratch + (long long)b * scratch_words(R), out);
}

}  // namespace celerite_grad

// C entry point.  Pointers are device pointers to float64 data: tc, dt and
// diag (N,); y (N,) shared (y_rows = 1) or (B, N) per element (y_rows = B);
// coefficients (B, Jr) / (B, Jc) row-major; mean and extra_diag (B,) or
// null; ws B * N * (2 + 4R + R(R+1)/2) doubles; scratch B * (R(R+1) + 18R)
// doubles when R > 8 (else unused); outputs ll (B,), the coefficient
// gradients in the coefficients' shapes, g_extra (B,) and g_r (B, N).
// Returns 0, -2 for a bad size, or the cudaError_t of the launch.
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
  const int blocks = (B + kThreads - 1) / kThreads;
#define CELERITE_GRAD_ARGS                                                                             \
  Jr, Jc, (const T*)tc, (const T*)dt, (const T*)y, y_rows, (const T*)diag, (const T*)ar, (const T*)cr, \
      (const T*)ac, (const T*)bc, (const T*)cc, (const T*)dc, (const T*)mean, (const T*)extra_diag, B, \
      N, (T*)ws, (T*)scratch, (T*)ll, (T*)g_ar, (T*)g_cr, (T*)g_ac, (T*)g_bc, (T*)g_cc, (T*)g_dc,      \
      (T*)g_extra, (T*)g_r
  cudaStream_t st = (cudaStream_t)stream;
  switch (R) {
    case 1: grad_kernel<1><<<blocks, kThreads, 0, st>>>(CELERITE_GRAD_ARGS); break;
    case 2: grad_kernel<2><<<blocks, kThreads, 0, st>>>(CELERITE_GRAD_ARGS); break;
    case 3: grad_kernel<3><<<blocks, kThreads, 0, st>>>(CELERITE_GRAD_ARGS); break;
    case 4: grad_kernel<4><<<blocks, kThreads, 0, st>>>(CELERITE_GRAD_ARGS); break;
    case 5: grad_kernel<5><<<blocks, kThreads, 0, st>>>(CELERITE_GRAD_ARGS); break;
    case 6: grad_kernel<6><<<blocks, kThreads, 0, st>>>(CELERITE_GRAD_ARGS); break;
    case 7: grad_kernel<7><<<blocks, kThreads, 0, st>>>(CELERITE_GRAD_ARGS); break;
    case 8: grad_kernel<8><<<blocks, kThreads, 0, st>>>(CELERITE_GRAD_ARGS); break;
    default: grad_kernel<0><<<blocks, kThreads, 0, st>>>(CELERITE_GRAD_ARGS); break;
  }
#undef CELERITE_GRAD_ARGS
  static_assert(kMaxStatic == 8, "the switch above instantiates R = 1..kMaxStatic");
  return static_cast<int>(cudaGetLastError());
}
