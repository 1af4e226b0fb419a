// The double instantiations of the batched celerite log-likelihood kernel
// (celerite_loglike.cuh holds the kernel and its design note).  One source
// per dtype, so that the two build in parallel.

#include "celerite_loglike.cuh"

// C entry point.  Pointers are device pointers; mean and extra_diag may be
// null; dense_s != 0 selects the dense-S body; team is 32, 8 or 1 lanes per
// likelihood (32 only for the runtime-R body, 1 only for the packed body at
// the compile-time widths).  Returns 0 on success, -1 for a (team, body)
// that does not exist, -2 for a bad size, otherwise the cudaError_t of the
// launch.
extern "C" int celerite_loglike_f64(int Jr, int Jc, int dense_s, int team, const void* dt,
                                    const void* y, int y_cols, const void* diag, int d_cols,
                                    const void* ar, const void* cr, const void* ac, const void* bc,
                                    const void* cc, const void* dc, const void* mean,
                                    const void* extra_diag, int B, int N, int repeats, void* out,
                                    void* stream) {
  using T = double;
  return celerite::dispatch<T>(Jr, Jc, dense_s, team, (const T*)dt, (const T*)y, y_cols,
                               (const T*)diag, d_cols, (const T*)ar, (const T*)cr, (const T*)ac,
                               (const T*)bc, (const T*)cc, (const T*)dc, (const T*)mean,
                               (const T*)extra_diag, B, N, repeats, (T*)out, (cudaStream_t)stream);
}
