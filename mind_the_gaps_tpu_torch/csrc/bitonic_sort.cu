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
// is total and any correct sorting network gives the stable result.  Each
// element is encoded once, on load, as an unsigned integer whose order is
// that order: the key's bits mapped to an ordered integer (NaN -> all ones,
// -0.0 -> +0.0), then (index << 1 | key was -0.0).  Padding is all ones with
// its index >= m.  Float keys give one 64-bit word, double keys a 64-bit
// word and a 32-bit one.
//
// Design.  A row of m is padded (on chip: padding is never read or written)
// to n = the next power of two >= max(m, 32 kE).  A CTA holds a tile of up
// to 16384 elements, kE in the registers of each thread (kE = 16 for float
// keys, 1024 threads; kE = 32 for double keys, 512 threads, so that their
// 12-byte elements fit the 128-register cap).  A thread's slot s, lane l
// and warp w give the element's q = w << kLB | l << log2(kE) | s, with
// kLB = log2(32 kE), and a layout maps q to its position p in the tile:
//   LO: p = q                 (position bits below kLB in registers/lanes)
//   HI: p = q rotated left by kLB within the tile's L = log2(tile) bits
//       (position bits kLB..L-1 in registers and lanes)
// A compare-exchange stage of stride 2^b runs in registers when b is a slot
// bit of the layout and by __shfl_xor_sync when it is a lane bit: no shared
// memory and no barrier.  Each merge level k > 2^kLB switches LO -> HI ->
// LO through shared memory (two barriers a switch, XOR-swizzled so that
// neither layout has bank conflicts) and runs all its stages of bits
// kLB..L-1 in HI and the lower ones in LO.  As every element is distinct,
// one integer comparison decides each exchange.
// - Tile tier (n <= 16384): one CTA a row.
// - Cluster tier (16384 < n <= 131072): a thread-block cluster of
//   n / 16384 CTAs (2, 4 or 8) holds the row.  A stage whose stride crosses
//   CTAs compares each element with the partner CTA's element at the same
//   shared-memory address, read 16 bytes a lane through distributed shared
//   memory (map_shared_rank), two cluster barriers a stage; the row never
//   leaves the chip.
// - Two-level tier (longer rows): the same kernel sorts 16384-element
//   chunks into a device-memory scratch, elementwise passes run the strides
//   >= 16384, and the kernel runs each merge level's smaller strides.
// Inputs are read once (keys, and for the remap the draws), the outputs
// written once; the payload never travels through the network, only the
// index: the last pass gathers values (sort_kv) or scatters the draws to
// their ranks (rank_remap).
//
// What bounds it on this card: instruction issue on the integer pipe (the
// ~n log2(n)^2 / 4 compare-exchanges, each a 64-bit comparison and two or
// four selects, a third of them with two shuffles), with one CTA an SM;
// then the shared-memory switches, the cross-CTA stages and the scattered
// writes of the remap.  Device memory is touched only by the inputs and
// outputs, and a 4-CTA cluster needs four SMs of one GPC, so at (128,
// 65536) the 128 clusters run in about five waves.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC (no --use_fast_math).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// Tile geometry by key type: a thread holds kE elements (16 float, 32
// double, so that the 12-byte double elements get the 128-register cap of
// 512 threads); a CTA holds up to kMaxTile = 16384 (128 KB float, 192 KB
// double); the LO layout covers kLB = log2(32 kE) position bits; rows are
// padded to at least one warp's 32 kE elements.
template <typename K>
struct Geom {
  static constexpr int kLogE = sizeof(K) == 4 ? 4 : 5;
  static constexpr int kE = 1 << kLogE;
  static constexpr int kLB = kLogE + 5;
  static constexpr int kMinTile = 32 * kE;
  static constexpr int kThreads = 16384 / kE;
  static constexpr unsigned kAll = kE == 32 ? 0xffffffffu : (1u << kE) - 1;
};
constexpr int kMaxTile = 16384;
constexpr int kMaxCluster = 8;      // CTAs a row may span on chip
constexpr int kPassThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory a launch gets without opting in
constexpr unsigned kFull = 0xffffffffu;

enum Source { kKeys = 0, kNegatedKeys = 1, kScratch = 2 };
enum Dest { kToScratch = 0, kSortKv = 1, kRemap = 2 };

// ---- the encoded element ------------------------------------------------ //
template <typename K>
struct Elem;

template <>
struct Elem<float> {  // (ordered key << 32) | (index << 1) | negzero
  uint64_t v;
  static constexpr int kBytes = 8;
  __device__ static Elem make(float x, uint32_t g) {
    uint32_t o = 0xffffffffu, nz = 0;
    if (!isnan(x)) {
      nz = (x == 0.0f && signbit(x)) ? 1u : 0u;
      const uint32_t bits = __float_as_uint(x == 0.0f ? 0.0f : x);
      o = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
    }
    return Elem{(uint64_t(o) << 32) | (uint64_t(g) << 1) | nz};
  }
  __device__ static Elem pad(uint32_t g) { return Elem{(uint64_t(0xffffffffu) << 32) | (uint64_t(g) << 1)}; }
  __device__ bool operator<(const Elem& b) const { return v < b.v; }
  __device__ uint32_t index() const { return uint32_t(v) >> 1; }
  __device__ float key() const {
    const uint32_t o = uint32_t(v >> 32);
    if (o == 0xffffffffu) return __uint_as_float(0x7fc00000u);
    const float x = __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
    return (v & 1) ? -0.0f : x;
  }
  __device__ Elem shfl_xor(int mask) const { return Elem{__shfl_xor_sync(kFull, v, mask)}; }
  __device__ static Elem ld(const uint64_t* k, const uint32_t*, long long a) { return Elem{k[a]}; }
  __device__ void st(uint64_t* k, uint32_t*, long long a) const { k[a] = v; }
  // the elements at addresses 2v and 2v + 1, as one 16-byte access
  __device__ static void ld2(const uint64_t* k, const uint32_t*, int v, Elem& a, Elem& b) {
    const ulonglong2 w = reinterpret_cast<const ulonglong2*>(k)[v];
    a.v = w.x;
    b.v = w.y;
  }
  __device__ static void st2(uint64_t* k, uint32_t*, int v, const Elem& a, const Elem& b) {
    reinterpret_cast<ulonglong2*>(k)[v] = make_ulonglong2(a.v, b.v);
  }
};

template <>
struct Elem<double> {  // ordered key; (index << 1) | negzero
  uint64_t k;
  uint32_t i;
  static constexpr int kBytes = 12;
  __device__ static Elem make(double x, uint32_t g) {
    uint64_t o = ~0ull;
    uint32_t nz = 0;
    if (!isnan(x)) {
      nz = (x == 0.0 && signbit(x)) ? 1u : 0u;
      const uint64_t bits = uint64_t(__double_as_longlong(x == 0.0 ? 0.0 : x));
      o = (bits >> 63) ? ~bits : (bits | (1ull << 63));
    }
    return Elem{o, (g << 1) | nz};
  }
  __device__ static Elem pad(uint32_t g) { return Elem{~0ull, g << 1}; }
  // (k, i) < (b.k, b.i) as 96-bit integers: the borrow out of their
  // difference, three subtractions with carry and no branch (the C++
  // `k < b.k || (k == b.k && i < b.i)` compiled to branches, 1.6x slower)
  __device__ bool operator<(const Elem& b) const {
    unsigned r;
    asm("{\n\t.reg .u32 t;\n\t"
        "sub.cc.u32 t, %1, %4;\n\t"
        "subc.cc.u32 t, %2, %5;\n\t"
        "subc.cc.u32 t, %3, %6;\n\t"
        "subc.u32 %0, 0, 0;\n\t}"
        : "=r"(r)
        : "r"(i), "r"(uint32_t(k)), "r"(uint32_t(k >> 32)), "r"(b.i), "r"(uint32_t(b.k)), "r"(uint32_t(b.k >> 32)));
    return r != 0;
  }
  __device__ uint32_t index() const { return i >> 1; }
  __device__ double key() const {
    if (k == ~0ull) return __longlong_as_double(0x7ff8000000000000ll);
    const double x = __longlong_as_double(
        static_cast<long long>((k >> 63) ? (k & ~(1ull << 63)) : ~k));
    return (i & 1) ? -0.0 : x;
  }
  __device__ Elem shfl_xor(int mask) const {
    return Elem{__shfl_xor_sync(kFull, k, mask), __shfl_xor_sync(kFull, i, mask)};
  }
  __device__ static Elem ld(const uint64_t* kp, const uint32_t* ip, long long a) { return Elem{kp[a], ip[a]}; }
  __device__ void st(uint64_t* kp, uint32_t* ip, long long a) const {
    kp[a] = k;
    ip[a] = i;
  }
  __device__ static void ld2(const uint64_t* kp, const uint32_t* ip, int v, Elem& a, Elem& b) {
    const ulonglong2 w = reinterpret_cast<const ulonglong2*>(kp)[v];
    const uint2 u = reinterpret_cast<const uint2*>(ip)[v];
    a = Elem{w.x, u.x};
    b = Elem{w.y, u.y};
  }
  __device__ static void st2(uint64_t* kp, uint32_t* ip, int v, const Elem& a, const Elem& b) {
    reinterpret_cast<ulonglong2*>(kp)[v] = make_ulonglong2(a.k, b.k);
    reinterpret_cast<uint2*>(ip)[v] = make_uint2(a.i, b.i);
  }
};

// ---- layouts and stages ------------------------------------------------- //
// shared-memory address of tile position p: the low 5 bits XOR-ed with
// higher bits so that the LO and HI accesses of a warp hit 32 distinct
// banks (kLB = 9: bits 5-9 and 9-13; kLB = 10: bits 5-9)
template <int LB>
__device__ __forceinline__ int swz(int p) {
  return LB == 9 ? p ^ (((p >> 5) ^ (p >> 9)) & 31) : p ^ ((p >> 5) & 31);
}

template <int LB>
__device__ __forceinline__ int tile_pos(int q, bool hi, int L) {
  return hi ? ((q << LB) | (q >> (L - LB))) & ((1 << L) - 1) : q;
}

// bit s set where slot s sorts ascending in merge level 2^K: bit K of the
// element's position in the row (rank * tile + p) is 0
template <typename G>
__device__ __forceinline__ unsigned up_mask(int K, int L, bool hi, int rank, int qbase) {
  if (K >= L) return ((rank >> (K - L)) & 1) ? 0u : G::kAll;
  const int qb = hi ? (K + L - G::kLB) % L : K;
  unsigned mk = 0;
#pragma unroll
  for (int s = 0; s < G::kE; ++s) mk |= (((qbase | s) >> qb) & 1) ? 0u : (1u << s);
  return mk;
}

// Register stage on slot bit C.  Every element is distinct, so "b before
// a" is the negation of "a before b" and one comparison decides a swap.
// `up` holds one direction bit a slot, or a bool for every slot.
template <int C, typename El, int E, typename Up>
__device__ __forceinline__ void reg_stage(El (&x)[E], Up up) {
#pragma unroll
  for (int s = 0; s < E; ++s) {
    if (s & (1 << C)) continue;
    const int h = s | (1 << C);
    const El a = x[s], b = x[h];
    bool u;
    if constexpr (sizeof(Up) == 1) u = up; else u = (up >> s) & 1;
    const bool sw = (b < a) == u;
    x[s] = sw ? b : a;
    x[h] = sw ? a : b;
  }
}

template <typename El, int E, typename Up>
__device__ __forceinline__ void reg_stage_c(El (&x)[E], int c, Up up) {
  switch (c) {
    case 0: reg_stage<0>(x, up); return;
    case 1: reg_stage<1>(x, up); return;
    case 2: reg_stage<2>(x, up); return;
    case 3: reg_stage<3>(x, up); return;
    default: if constexpr (E > 16) reg_stage<4>(x, up); return;
  }
}

// the stage whose partner differs in bit c of q.  The direction (bit K of
// the position) varies by slot only in the first merge levels of the LO
// layout and in the first ones that use the HI layout; a shuffle stage
// (c >= kLogE) always sees one direction for every slot, since its partner
// bit lies below K and every position bit above the slot bits is a lane,
// warp or CTA bit.
template <typename G, typename El, int E>
__device__ __forceinline__ void stage(El (&x)[E], int c, unsigned up, int lane) {
  if (c < G::kLogE) {
    if (up == 0u || up == G::kAll) reg_stage_c(x, c, up != 0u); else reg_stage_c(x, c, up);
    return;
  }
  const int mask = 1 << (c - G::kLogE);
  const bool keep_min = ((lane & mask) == 0) == (up != 0u);
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const El o = x[s].shfl_xor(mask);
    x[s] = ((o < x[s]) == keep_min) ? o : x[s];
  }
}

template <typename G, typename El, int E>
__device__ __forceinline__ void regs_to_smem(const El (&x)[E], uint64_t* sk, uint32_t* si, int qbase, bool hi,
                                             int L) {
#pragma unroll
  for (int s = 0; s < E; ++s) x[s].st(sk, si, swz<G::kLB>(tile_pos<G::kLB>(qbase | s, hi, L)));
}

template <typename G, typename El, int E>
__device__ __forceinline__ void smem_to_regs(El (&x)[E], const uint64_t* sk, const uint32_t* si, int qbase,
                                             bool hi, int L) {
#pragma unroll
  for (int s = 0; s < E; ++s) x[s] = El::ld(sk, si, swz<G::kLB>(tile_pos<G::kLB>(qbase | s, hi, L)));
}

// One CTA per tile of a padded row of length n, launched in clusters of
// `cluster` CTAs (1: no cross-CTA stage).  merge_k == 0: run every merge
// level 2..(cluster > 1 ? n : tile); merge_k > 0: the strides < tile of
// merge level merge_k.  The source is the input keys (encoded here) or the
// scratch; the destination the scratch or, on the last launch, the outputs.
template <typename K>
__global__ void __launch_bounds__(Geom<K>::kThreads, 1)
sort_kernel(int source, const K* __restrict__ keys_in, uint64_t* scr_k, uint32_t* scr_i, int m, int n,
            int merge_k, int cluster, int dest, K* __restrict__ keys_out, const K* __restrict__ vals,
            K* __restrict__ vals_out, int64_t* __restrict__ perm_out, const K* __restrict__ draws,
            K* __restrict__ x_out) {
  using El = Elem<K>;
  using G = Geom<K>;
  constexpr int E = G::kE, LB = G::kLB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int T = blockDim.x, tile = T * E;
  const int L = 31 - __clz(tile);
  uint64_t* sk = reinterpret_cast<uint64_t*>(smem_raw);
  uint32_t* si = reinterpret_cast<uint32_t*>(sk + tile);
  const int tiles_per_row = n / tile;
  const long long row = blockIdx.x / tiles_per_row;
  const int rank = blockIdx.x % tiles_per_row;
  const int base = rank * tile;  // first position of the tile in its row
  const long long row_in = row * m, row_pad = row * n;
  const int lane = threadIdx.x & 31;
  const int qbase = ((threadIdx.x >> 5) << LB) | (lane << G::kLogE);

  // ---- load (coalesced), encode, then into registers (LO) --------------- //
  for (int i = threadIdx.x; i < tile; i += T) {
    const int g = base + i;
    El e;
    if (source == kScratch) {
      e = El::ld(scr_k, scr_i, row_pad + g);
    } else if (g < m) {
      const K x = keys_in[row_in + g];
      e = El::make(source == kNegatedKeys ? -x : x, g);
    } else {
      e = El::pad(g);
    }
    e.st(sk, si, swz<LB>(i));
  }
  __syncthreads();
  El x[E];
  smem_to_regs<G>(x, sk, si, qbase, false, L);

  const int k_first = merge_k ? merge_k : 2;
  const int k_last = merge_k ? merge_k : (cluster > 1 ? n : tile);
  for (int k = k_first; k <= k_last; k <<= 1) {
    const int K_ = 31 - __clz(k);
    const unsigned up_lo = up_mask<G>(K_, L, false, rank, qbase);
    int b = K_ - 1;
    bool in_smem = false;  // the tile is in shared memory, not in registers
    // strides across CTAs: each element against the partner CTA's element
    // at the same address, read 16 bytes a lane through distributed shared
    // memory (the direction is the same for every element: K > L)
    if (cluster > 1 && b >= L) {
      cg::cluster_group cl = cg::this_cluster();
      __syncthreads();
      regs_to_smem<G>(x, sk, si, qbase, false, L);
      for (; b >= L; --b) {
        cl.sync();  // every CTA's tile is in its shared memory
        const int bit = 1 << (b - L);
        const uint64_t* pk = cl.map_shared_rank(sk, rank ^ bit);
        const uint32_t* pi = cl.map_shared_rank(si, rank ^ bit);
        const bool keep_min = ((rank & bit) == 0) == (up_lo != 0u);
#pragma unroll
        for (int j = 0; j < E / 2; ++j) {
          El o0, o1;
          El::ld2(pk, pi, threadIdx.x + j * T, o0, o1);
          El::ld2(sk, si, threadIdx.x + j * T, x[2 * j], x[2 * j + 1]);
          x[2 * j] = ((o0 < x[2 * j]) == keep_min) ? o0 : x[2 * j];
          x[2 * j + 1] = ((o1 < x[2 * j + 1]) == keep_min) ? o1 : x[2 * j + 1];
        }
        cl.sync();  // every read of this stage is done
#pragma unroll
        for (int j = 0; j < E / 2; ++j) El::st2(sk, si, threadIdx.x + j * T, x[2 * j], x[2 * j + 1]);
      }
      __syncthreads();
      in_smem = true;
    }
    if (b >= L) b = L - 1;  // two-level tier: the passes ran these strides
    // strides 2^LB .. 2^(L-1) in the HI layout
    if (b >= LB) {
      if (!in_smem) {
        __syncthreads();
        regs_to_smem<G>(x, sk, si, qbase, false, L);
        __syncthreads();
      }
      smem_to_regs<G>(x, sk, si, qbase, true, L);
      const unsigned up_hi = up_mask<G>(K_, L, true, rank, qbase);
      for (; b >= LB; --b) stage<G>(x, b - LB, up_hi, lane);
      __syncthreads();
      regs_to_smem<G>(x, sk, si, qbase, true, L);
      __syncthreads();
      smem_to_regs<G>(x, sk, si, qbase, false, L);
    } else if (in_smem) {
      smem_to_regs<G>(x, sk, si, qbase, false, L);
    }
    for (; b >= 0; --b) stage<G>(x, b, up_lo, lane);
  }

  // ---- outputs (coalesced through shared memory) ----------------------- //
  __syncthreads();
  regs_to_smem<G>(x, sk, si, qbase, false, L);
  __syncthreads();
  for (int i = threadIdx.x; i < tile; i += T) {
    const int g = base + i;
    const El e = El::ld(sk, si, swz<LB>(i));
    if (dest == kToScratch) {
      e.st(scr_k, scr_i, row_pad + g);
    } else if (g < m) {  // padding sorts last: positions < m hold real elements
      const uint32_t src = e.index();
      if (dest == kSortKv) {
        keys_out[row_in + g] = e.key();
        vals_out[row_in + g] = vals[row_in + src];
      } else {
        perm_out[row_in + g] = src;
        x_out[row_in + src] = draws[row_in + g];
      }
    }
  }
}

// One stride-j compare-exchange stage of merge level k over every row of the
// scratch, one thread per pair (two-level tier).
template <typename K>
__global__ void pass_kernel(uint64_t* sk, uint32_t* si, int n, int k, int j, long long pairs) {
  using El = Elem<K>;
  const long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (p >= pairs) return;
  const long long half = n >> 1;
  const long long row = (p / half) * n;
  const long long q = p % half;
  const long long lo = ((q & ~(long long)(j - 1)) << 1) | (q & (j - 1));
  const El a = El::ld(sk, si, row + lo), b = El::ld(sk, si, row + lo + j);
  if ((lo & k) == 0 ? (b < a) : (a < b)) {
    b.st(sk, si, row + lo);
    a.st(sk, si, row + lo + j);
  }
}

template <typename K>
int padded_length(int m) {
  int n = Geom<K>::kMinTile;
  while (n < m) n <<= 1;
  return n;
}

template <typename K>
int launch_sort(int cluster, int source, const K* keys_in, uint64_t* sk, uint32_t* si, int B, int m, int n,
                int merge_k, int dest, K* keys_out, const K* vals, K* vals_out, int64_t* perm_out,
                const K* draws, K* x_out, cudaStream_t stream) {
  const int tile = n < kMaxTile ? n : kMaxTile;
  const size_t smem = static_cast<size_t>(tile) * Elem<K>::kBytes;
  cudaError_t err = cudaSuccess;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(sort_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(B) * (n / tile))), block(tile / Geom<K>::kE);
  if (cluster == 1) {
    sort_kernel<K><<<grid, block, smem, stream>>>(source, keys_in, sk, si, m, n, merge_k, cluster, dest, keys_out,
                                                  vals, vals_out, perm_out, draws, x_out);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sort_kernel<K>, source, keys_in, sk, si, m, n, merge_k, cluster, dest,
                           keys_out, vals, vals_out, perm_out, draws, x_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The whole sort of B rows: one launch in the tile and cluster tiers; in
// the two-level tier the chunk sorts, then per merge level its passes and
// its in-CTA tail, the last of which writes the outputs.
template <typename K>
int sort_rows(int source, const K* keys_in, int B, int m, int dest, K* keys_out, const K* vals,
              K* vals_out, int64_t* perm_out, const K* draws, K* x_out, uint64_t* scratch_k,
              uint32_t* scratch_i, cudaStream_t stream) {
  if (B <= 0 || m <= 0 || m > (1 << 29)) return -2;
  const int n = padded_length<K>(m);
  if (n <= kMaxTile * kMaxCluster) {
    const int cluster = n <= kMaxTile ? 1 : n / kMaxTile;
    return launch_sort<K>(cluster, source, keys_in, nullptr, nullptr, B, m, n, 0, dest, keys_out, vals,
                          vals_out, perm_out, draws, x_out, stream);
  }
  if (scratch_k == nullptr || (sizeof(K) == 8 && scratch_i == nullptr)) return -3;
  int rc = launch_sort<K>(1, source, keys_in, scratch_k, scratch_i, B, m, n, 0, kToScratch, nullptr,
                          nullptr, nullptr, nullptr, nullptr, nullptr, stream);
  if (rc) return rc;
  const long long pairs = static_cast<long long>(B) * (n / 2);
  const unsigned pass_blocks = static_cast<unsigned>((pairs + kPassThreads - 1) / kPassThreads);
  for (int k = 2 * kMaxTile; k <= n; k <<= 1) {
    for (int j = k >> 1; j >= kMaxTile; j >>= 1) {
      pass_kernel<K><<<pass_blocks, kPassThreads, 0, stream>>>(scratch_k, scratch_i, n, k, j, pairs);
      rc = static_cast<int>(cudaGetLastError());
      if (rc) return rc;
    }
    rc = launch_sort<K>(1, kScratch, nullptr, scratch_k, scratch_i, B, m, n, k, k == n ? dest : kToScratch,
                        keys_out, vals, vals_out, perm_out, draws, x_out, stream);
    if (rc) return rc;
  }
  return 0;
}

}  // namespace

// C entry points.  Pointers are device pointers to contiguous row-major
// (B, m) arrays; the scratch arrays are (B, n) with n the padded length
// (int64 keys, and int32 indices for double keys), needed (non-null) only
// in the two-level tier (n > kMaxTile * kMaxCluster).  Returns 0 on success,
// -2 for a bad size, -3 for missing scratch, otherwise the cudaError_t of a
// launch (a refused cluster launch included).

extern "C" int bitonic_sort_kv_f32(const void* keys, const void* vals, void* keys_out,
                                   void* vals_out, void* scratch_k, void* scratch_i, int B,
                                   int m, void* stream) {
  using K = float;
  return sort_rows<K>(kKeys, (const K*)keys, B, m, kSortKv, (K*)keys_out, (const K*)vals,
                      (K*)vals_out, nullptr, nullptr, nullptr, (uint64_t*)scratch_k,
                      (uint32_t*)scratch_i, (cudaStream_t)stream);
}

extern "C" int bitonic_sort_kv_f64(const void* keys, const void* vals, void* keys_out,
                                   void* vals_out, void* scratch_k, void* scratch_i, int B,
                                   int m, void* stream) {
  using K = double;
  return sort_rows<K>(kKeys, (const K*)keys, B, m, kSortKv, (K*)keys_out, (const K*)vals,
                      (K*)vals_out, nullptr, nullptr, nullptr, (uint64_t*)scratch_k,
                      (uint32_t*)scratch_i, (cudaStream_t)stream);
}

extern "C" int bitonic_rank_remap_f32(const void* adj, const void* draws, void* perm_out,
                                      void* x_out, void* scratch_k, void* scratch_i, int B,
                                      int m, void* stream) {
  using K = float;
  return sort_rows<K>(kNegatedKeys, (const K*)adj, B, m, kRemap, nullptr, nullptr, nullptr,
                      (int64_t*)perm_out, (const K*)draws, (K*)x_out, (uint64_t*)scratch_k,
                      (uint32_t*)scratch_i, (cudaStream_t)stream);
}
