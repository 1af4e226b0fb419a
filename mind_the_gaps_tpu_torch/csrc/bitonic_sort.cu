// Batched stable bitonic sort for Hopper (sm_90a): the key/value sort and the
// fused E13 rank-order remap, float keys (and double keys for the sort).
//
// Replaces the Pallas TPU kernels of mind_the_gaps_tpu/ops/pallas_sort.py:
// `_sort_t` with its VMEM-resident body `_make_kernel` and its two-level HBM
// body `_make_hbm_kernel`, and `bitonic_remap_t` with `_make_hbm_remap_kernel`.
// For B independent rows of length m it computes
//
//     sort_kv:    keys_out[b] = keys[b] sorted ascending,
//                 vals_out[b, i] = vals[b, p_b(i)]  (p_b: the sorting permutation)
//     rank_remap: perm[b] = argsort(-adj[b]),  x_out[b, perm[b, i]] = draws[b, i]
//
// and each result equals the STABLE sort bit for bit.  The network orders the
// pairs (key, original index) lexicographically: real elements before padding,
// non-NaN keys before NaN keys, keys by plain `<` (so -0.0 and +0.0 tie and
// break on the index), then the index.  Every pair is distinct, so the order
// is total and any correct sorting network gives the stable result.
//
// Design.
// - Rows of any length m are padded to n = the next power of two; padding
//   carries indices >= m, so it sorts after every real element and the first
//   m positions of a sorted row hold the real ones.
// - Tile tier (n <= kMaxTile): one CTA per row sorts the whole row in dynamic
//   shared memory (key + int32 index: 8 B an element for float, 12 for
//   double, 128 KB / 192 KB at the largest tile) and writes the outputs.
// - Two-level tier (n > kMaxTile): the same tile kernel sorts each
//   kMaxTile-element chunk (directions alternate by the global index, so the
//   chunks form bitonic runs) into global scratch; then every merge level
//   k > kMaxTile runs its strides >= kMaxTile as elementwise
//   compare-exchange passes over device memory, one launch each, and its
//   strides < kMaxTile in shared memory in one launch of the tile kernel.
//   At n = 65536: 1 + (1 + 1) + (2 + 1) = 6 passes over the data.
// - The payload never travels through the network: only the index does.
//   The last launch gathers values (sort_kv) or scatters the draws to their
//   ranks (rank_remap) through the index.  The TPU kernel ran a second
//   key/value sort for the remap because a scatter is slow there; on this
//   card a scatter within a row is one pass over it (the row stays in L2).
//
// What bounds it on this card: shared-memory bandwidth and the barrier after
// each of the log2(n)(log2(n)+1)/2 stages; at the two-level sizes, also the
// global passes (8 or 12 B an element read and written per pass).  The
// design keeps all stages with strides below the tile in shared memory and
// does nothing yet about bank conflicts, warp-level stages in registers, or
// keeping a 65536-element row resident across a thread-block cluster.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxTile = 16384;   // elements one CTA holds in shared memory
constexpr int kMaxThreads = 1024;
constexpr int kPassThreads = 256;

enum Source { kKeys = 0, kNegatedKeys = 1, kScratch = 2 };
enum Dest { kToScratch = 0, kSortKv = 1, kRemap = 2 };

// true when (ka, ia) sorts strictly before (kb, ib)
template <typename K>
__device__ __forceinline__ bool before(K ka, int ia, K kb, int ib, int m) {
  if (ia >= m || ib >= m) return ia < ib;  // padding last, by index
  const bool na = isnan(ka), nb = isnan(kb);
  if (na || nb) return na == nb ? ia < ib : nb;
  if (ka < kb) return true;
  if (kb < ka) return false;
  return ia < ib;
}

// Compare-exchange of positions lo < hi so that (lo, hi) ends in the order
// `up` (ascending) or against it.
template <typename K>
__device__ __forceinline__ void exchange(K* keys, int* idx, long long lo, long long hi, bool up, int m) {
  const K ka = keys[lo], kb = keys[hi];
  const int ia = idx[lo], ib = idx[hi];
  const bool swap = up ? before(kb, ib, ka, ia, m) : before(ka, ia, kb, ib, m);
  if (swap) {
    keys[lo] = kb;
    keys[hi] = ka;
    idx[lo] = ib;
    idx[hi] = ia;
  }
}

// position of the q-th pair of a stride-j stage: q with a zero bit inserted at j
__device__ __forceinline__ long long pair_lo(long long q, long long j) {
  return ((q & ~(j - 1)) << 1) | (q & (j - 1));
}

// One CTA per tile of `tile` elements of a padded row of length n.
// merge_k == 0: run every level 2..tile (a full sort of the tile in the
// network's global directions); merge_k > 0: run strides tile/2..1 of merge
// level merge_k.  The source is the input keys (padded here) or the scratch;
// the destination is the scratch or, on the last launch, the outputs.
template <typename K>
__global__ void tile_kernel(int source, const K* __restrict__ keys_in, K* scratch_keys,
                            int* scratch_idx, int m, int n, int tile, int merge_k, int dest,
                            K* __restrict__ keys_out, const K* __restrict__ vals,
                            K* __restrict__ vals_out, int64_t* __restrict__ perm_out,
                            const K* __restrict__ draws, K* __restrict__ x_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* skey = reinterpret_cast<K*>(smem_raw);
  int* sidx = reinterpret_cast<int*>(skey + tile);

  const int tiles_per_row = n / tile;
  const long long b = blockIdx.x / tiles_per_row;
  const int base = (blockIdx.x % tiles_per_row) * tile;  // first index of the tile in its row
  const long long row_in = b * m, row_pad = b * n;

  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int gi = base + i;
    if (source == kScratch) {
      skey[i] = scratch_keys[row_pad + gi];
      sidx[i] = scratch_idx[row_pad + gi];
    } else {
      const K x = gi < m ? keys_in[row_in + gi] : K(0);
      skey[i] = source == kNegatedKeys ? -x : x;
      sidx[i] = gi;
    }
  }

  const int half = tile >> 1;
  const int k_first = merge_k ? merge_k : 2;
  const int k_last = merge_k ? merge_k : tile;
  for (int k = k_first; k <= k_last; k <<= 1) {
    for (int j = (merge_k ? tile : k) >> 1; j > 0; j >>= 1) {
      __syncthreads();
      for (int q = threadIdx.x; q < half; q += blockDim.x) {
        const int lo = static_cast<int>(pair_lo(q, j));
        exchange(skey, sidx, lo, lo + j, ((base + lo) & k) == 0, m);
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int gi = base + i;
    if (dest == kToScratch) {
      scratch_keys[row_pad + gi] = skey[i];
      scratch_idx[row_pad + gi] = sidx[i];
    } else if (gi < m) {  // padding sorts last: positions < m hold real elements
      const int src = sidx[i];
      if (dest == kSortKv) {
        keys_out[row_in + gi] = skey[i];
        vals_out[row_in + gi] = vals[row_in + src];
      } else {
        perm_out[row_in + gi] = src;
        x_out[row_in + src] = draws[row_in + gi];
      }
    }
  }
}

// One stride-j compare-exchange stage of merge level k over every row of the
// scratch, one thread per pair.
template <typename K>
__global__ void pass_kernel(K* keys, int* idx, int m, int n, int k, int j, long long pairs) {
  const long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (p >= pairs) return;
  const long long half = n >> 1;
  const long long row = (p / half) * n;
  const long long lo = pair_lo(p % half, j);
  exchange(keys + row, idx + row, lo, lo + j, (lo & k) == 0, m);
}

template <typename K>
int launch_tile(int source, const K* keys_in, K* sk, int* si, int B, int m, int n, int tile,
                int merge_k, int dest, K* keys_out, const K* vals, K* vals_out, int64_t* perm_out,
                const K* draws, K* x_out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(tile) * (sizeof(K) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(tile_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = tile / 2;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  const long long blocks = static_cast<long long>(B) * (n / tile);
  tile_kernel<K><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      source, keys_in, sk, si, m, n, tile, merge_k, dest, keys_out, vals, vals_out, perm_out, draws,
      x_out);
  return static_cast<int>(cudaGetLastError());
}

int padded_length(int m) {
  int n = 1;
  while (n < m) n <<= 1;
  return n;
}

// The whole sort of B rows: one launch in the tile tier; in the two-level
// tier the chunk sorts, then per merge level its global passes and its
// shared-memory tail, the last of which writes the outputs.
template <typename K>
int sort_rows(int source, const K* keys_in, int B, int m, int dest, K* keys_out, const K* vals,
              K* vals_out, int64_t* perm_out, const K* draws, K* x_out, K* scratch_keys,
              int* scratch_idx, cudaStream_t stream) {
  if (B <= 0 || m <= 0 || m > (1 << 29)) return -2;
  const int n = padded_length(m);
  const int tile = n < kMaxTile ? n : kMaxTile;
  if (n == tile)
    return launch_tile<K>(source, keys_in, nullptr, nullptr, B, m, n, tile, 0, dest, keys_out, vals,
                          vals_out, perm_out, draws, x_out, stream);
  if (scratch_keys == nullptr || scratch_idx == nullptr) return -3;
  int rc = launch_tile<K>(source, keys_in, scratch_keys, scratch_idx, B, m, n, tile, 0, kToScratch,
                          nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, stream);
  if (rc) return rc;
  const long long pairs = static_cast<long long>(B) * (n / 2);
  const unsigned pass_blocks = static_cast<unsigned>((pairs + kPassThreads - 1) / kPassThreads);
  for (int k = 2 * tile; k <= n; k <<= 1) {
    for (int j = k >> 1; j >= tile; j >>= 1) {
      pass_kernel<K><<<pass_blocks, kPassThreads, 0, stream>>>(scratch_keys, scratch_idx, m, n, k, j,
                                                               pairs);
      rc = static_cast<int>(cudaGetLastError());
      if (rc) return rc;
    }
    const bool last = k == n;
    rc = launch_tile<K>(kScratch, nullptr, scratch_keys, scratch_idx, B, m, n, tile, k,
                        last ? dest : kToScratch, keys_out, vals, vals_out, perm_out, draws, x_out,
                        stream);
    if (rc) return rc;
  }
  return 0;
}

}  // namespace

// C entry points.  Pointers are device pointers to contiguous row-major
// (B, m) arrays; the scratch arrays are (B, n) with n the next power of two
// >= m, needed (non-null) only when n > bitonic_tile_elems().  Returns 0 on
// success, -2 for a bad size, -3 for missing scratch, otherwise the
// cudaError_t of a launch.

extern "C" int bitonic_tile_elems() { return kMaxTile; }

extern "C" int bitonic_sort_kv_f32(const void* keys, const void* vals, void* keys_out,
                                   void* vals_out, void* scratch_keys, void* scratch_idx, int B,
                                   int m, void* stream) {
  using K = float;
  return sort_rows<K>(kKeys, (const K*)keys, B, m, kSortKv, (K*)keys_out, (const K*)vals,
                      (K*)vals_out, nullptr, nullptr, nullptr, (K*)scratch_keys, (int*)scratch_idx,
                      (cudaStream_t)stream);
}

extern "C" int bitonic_sort_kv_f64(const void* keys, const void* vals, void* keys_out,
                                   void* vals_out, void* scratch_keys, void* scratch_idx, int B,
                                   int m, void* stream) {
  using K = double;
  return sort_rows<K>(kKeys, (const K*)keys, B, m, kSortKv, (K*)keys_out, (const K*)vals,
                      (K*)vals_out, nullptr, nullptr, nullptr, (K*)scratch_keys, (int*)scratch_idx,
                      (cudaStream_t)stream);
}

extern "C" int bitonic_rank_remap_f32(const void* adj, const void* draws, void* perm_out,
                                      void* x_out, void* scratch_keys, void* scratch_idx, int B,
                                      int m, void* stream) {
  using K = float;
  return sort_rows<K>(kNegatedKeys, (const K*)adj, B, m, kRemap, nullptr, nullptr, nullptr,
                      (int64_t*)perm_out, (const K*)draws, (K*)x_out, (K*)scratch_keys,
                      (int*)scratch_idx, (cudaStream_t)stream);
}
