// The TM's learning pass over its active rows, for NVIDIA Hopper
// (sm_90a): two entry points, one before the step's decisions and one
// after them.
//
// Stands for the row part of the JAX package's _learn and the fill of
// _grow (bithtm_tpu/models/temporal_memory.py:501-643, :350-498 and the
// fill half of _select_and_fill, :221-347): the gathers of the active
// rows, the count decode, the stale-slot cleanup, the new-segment reset,
// the permanence update and death, the fill of the free slots and the
// scatters of the rows back, which XLA fuses into a few passes over
// gathered copies of the rows. The TPU package has no Pallas kernel for
// them. Plain PyTorch versions: bithtm_tpu_torch/models/
// temporal_memory.py (row_counts_ref, learn_rows_ref).
//
// The active rows. Row r = a*G + g of stream b is segment g of the a-th
// active column: K slots of the (B, Ct, G*K) tables syn (int32, -1
// free), perm (float32) and act (the packed activity the last table pass
// wrote, act_bytes a value), at column cols[b, a] ("table" mode), or at
// column a of tables of gathered rows, Ct = A, where cols is null ("rows"
// mode: a column shard's rows, exchanged across ranks).
//
// row_counts, per active row: the potential and connected counts, the
// exact decode of the sum of its packed activity (seg_counts), and its
// live count, the slots with syn >= 0 and not perm < 0 (live after the
// stale cleanup), which segment allocation ranks by. Read only.
//
// learn_rows, per active row, in place, in this order:
//   1. stale slots (perm < 0) become (-1, -1.0)
//   2. rows of a new segment (fresh) become empty
//   3. perm += (learn && syn >= 0) * (act ? inc : -dec), a float32 add of
//      delta or of +-0.0 (0 * delta), on every row, as the JAX step adds
//      it; then live slots with perm < 0 die: (-1, -1.0)
//   4. growing row l = lpos[b, r] (-1: none) takes chosen[l, free_rank[k]]
//      into free slot k where free_rank[k] < n_chosen[l], at
//      permanence perm_init; counts[0] and counts[1] (zeroed by
//      grow_select) gain min(free, n_chosen) and max(n_chosen - free, 0)
//   5. syn and perm are stored where they changed; the (B, R, K) mask of
//      the slots grown only where wrote is not null.
//
// Bound: bytes. Each active row's slots read once (4 + 4 + act_bytes a
// slot), syn and perm written where they change, the lists read once;
// at the bench (B=256, A=41, G=4, K=64: 2.69 M slots) about 24 MB,
// 0.007-0.014 ms at the H100's 3.35 TB/s, by how many slots change.
// row_counts reads the same rows and writes three (B, R) int32 counts.
//
// Design. A warp takes a row: lane i holds slots i, i+32, ..., and loads
// a round of 32-slot chunks of all three tables (two up to K = 64, else
// four) before it uses any, so that a row up to K = 128 is one round of
// loads; a warp loads the first rounds of its two rows together. A
// ballot over each chunk ranks the free slots; the fill's cells come
// from the row's list entry, read once, one a lane and passed to the
// slot by a shuffle (path "shfl", kk <= 32 chosen cells a row), or read
// by each grown slot ("load").
// The row's list position comes from grow_select (lpos), so the pass
// needs no search. learn_rows runs a block of 8 warps on 16 rows of a
// stream: one thread a row first reads where the row lies, its flags,
// its list place and its chosen count into shared memory, so that a
// warp's two rows then cost one round of loads (their slots, and their
// cells beside them); the counts meet in shared memory (one atomic a
// block and count). One row a warp took 1.1-1.2x the time, four the same
// (scripts/grow_variants.py --kernel learn_rows, PERF.md).
// row_counts strides over the rows, a warp a row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kChunks = 4;  // row_counts: 32-slot chunks loaded at once
constexpr int kRows = 2;  // learn_rows: rows a warp, loaded together
constexpr int kRowsPerBlock = kRows * kWarps;
constexpr long long kMaxBlocks = 1 << 20;

// Where the active rows lie: row r of stream b at column cols[b, r / G]
// of a (B, Ct, G*K) table, or at column r / G where cols is null.
struct Rows {
  const int* cols;
  int Ct, A, G, K;

  __device__ __forceinline__ long long slot(int b, int r) const {
    const int a = r / G, g = r - a * G;
    const int col = cols ? __ldg(cols + (long long)b * A + a) : a;
    return (((long long)b * Ct + col) * G + g) * K;
  }
};

// The packed activity value i: its integer (0, 1 or 1 + scale), or
// whether it is not 0 (the bits below the sign, so -0.0 reads as 0).
template <int ELEM>
__device__ __forceinline__ int act_value(const void* act, long long i) {
  if constexpr (ELEM == 1) {
    return __ldg(static_cast<const uint8_t*>(act) + i);
  } else if constexpr (ELEM == 2) {
    const unsigned h = __ldg(static_cast<const unsigned short*>(act) + i);
    return static_cast<int>(__uint_as_float(h << 16));
  } else {
    return static_cast<int>(__ldg(static_cast<const float*>(act) + i));
  }
}

template <int ELEM>
__device__ __forceinline__ bool act_set(const void* act, long long i) {
  if constexpr (ELEM == 1) {
    return __ldg(static_cast<const uint8_t*>(act) + i) != 0;
  } else if constexpr (ELEM == 2) {
    return (__ldg(static_cast<const unsigned short*>(act) + i) & 0x7fffu) !=
           0;
  } else {
    return (__ldg(static_cast<const unsigned*>(act) + i) & 0x7fffffffu) != 0;
  }
}

template <int ELEM>
__global__ void __launch_bounds__(kWarps * 32) row_counts_kernel(
    const int* __restrict__ syn, const float* __restrict__ perm,
    const void* __restrict__ act, Rows rows, int* __restrict__ potential,
    int* __restrict__ connected, int* __restrict__ live, long long n_rows,
    int R, int scale) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long q = warp; q < n_rows; q += warps) {
    const int b = (int)(q / R), r = (int)(q - (long long)b * R);
    const long long base = rows.slot(b, r);
    int sum = 0, n_live = 0;
    for (int k0 = 0; k0 < rows.K; k0 += 32 * kChunks) {
      int s[kChunks], v[kChunks];
      float p[kChunks];
#pragma unroll
      for (int u = 0; u < kChunks; ++u) {
        const int k = k0 + 32 * u + lane;
        const bool in = k < rows.K;
        s[u] = in ? __ldg(syn + base + k) : -1;
        p[u] = in ? __ldg(perm + base + k) : -1.0f;
        v[u] = in ? act_value<ELEM>(act, base + k) : 0;
      }
#pragma unroll
      for (int u = 0; u < kChunks; ++u) {
        sum += v[u];
        n_live += s[u] >= 0 && !(p[u] < 0.0f);
      }
    }
    sum = static_cast<int>(__reduce_add_sync(kFull, (unsigned)sum));
    n_live = static_cast<int>(__reduce_add_sync(kFull, (unsigned)n_live));
    if (lane == 0) {
      const int conn = sum / scale;
      potential[q] = sum - scale * conn;
      connected[q] = conn;
      live[q] = n_live;
    }
  }
}

// One round of a row: its slots [k0, k0 + 32 * kC), lane i holding slots
// k0 + i, k0 + 32 + i, ...: syn, perm and whether the activity is set.
template <int ELEM, int kC>
struct Round {
  int s[kC];
  float p[kC];
  bool a[kC];

  __device__ __forceinline__ void load(const int* syn, const float* perm,
                                       const void* act, long long base,
                                       int k0, int K, int lane) {
#pragma unroll
    for (int u = 0; u < kC; ++u) {
      const int k = k0 + 32 * u + lane;
      const bool in = k < K;
      s[u] = in ? syn[base + k] : 0;
      p[u] = in ? perm[base + k] : 0.0f;
      a[u] = in && act_set<ELEM>(act, base + k);
    }
  }
};

// What a row's rounds share: where it lies, its flags, its chosen cells
// (n of them; with kShfl lane i holds cell i) and the free slots ranked
// so far.
struct RowPass {
  long long base, q;
  bool learn, empty;
  int n, cell_l, ranked;
  const int* cells;
};

// The update, death and fill of one round of a row, stored in place.
template <int ELEM, int kC, bool kShfl, bool kMask>
__device__ __forceinline__ void pass_round(
    int* syn, float* perm, uint8_t* wrote, const Round<ELEM, kC>& x,
    RowPass& row, int k0, int K, float inc, float dec, float perm_init,
    int lane, unsigned below) {
#pragma unroll
  for (int u = 0; u < kC; ++u) {
    const int k = k0 + 32 * u + lane;
    const bool in = k < K;
    int s1 = x.s[u];
    float p1 = x.p[u];
    if (p1 < 0.0f || row.empty) {  // stale, or a new segment's row
      s1 = -1;
      p1 = -1.0f;
    }
    const bool live = s1 >= 0;
    const float delta = x.a[u] ? inc : -dec;
    p1 = __fadd_rn(p1, __fmul_rn(row.learn && live ? 1.0f : 0.0f, delta));
    if (live && p1 < 0.0f) {  // death
      s1 = -1;
      p1 = -1.0f;
    }
    const bool free = in && s1 < 0;
    const unsigned ballot = __ballot_sync(kFull, free);
    const int fr = row.ranked + __popc(ballot & below);
    row.ranked += __popc(ballot);
    const int cell = kShfl ? __shfl_sync(kFull, row.cell_l, fr & 31) : 0;
    const bool grow = free && fr < row.n;
    if (grow) {
      s1 = kShfl ? cell : __ldg(row.cells + fr);
      p1 = perm_init;
    }
    if (in) {
      if (s1 != x.s[u]) syn[row.base + k] = s1;
      if (__float_as_uint(p1) != __float_as_uint(x.p[u]))
        perm[row.base + k] = p1;
      if constexpr (kMask) wrote[row.q * K + k] = grow;
    }
  }
}

template <int ELEM, int kC, bool kShfl, bool kMask>
__global__ void __launch_bounds__(kWarps * 32) learn_rows_kernel(
    int* __restrict__ syn, float* __restrict__ perm,
    const void* __restrict__ act, Rows rows,
    const uint8_t* __restrict__ learn, const uint8_t* __restrict__ fresh,
    const int* __restrict__ lpos, const int* __restrict__ chosen,
    const int* __restrict__ n_chosen, int* __restrict__ counts,
    uint8_t* __restrict__ wrote, int B, int R, int L, int kk, float inc,
    float dec, float perm_init, int groups) {
  // the block's rows: where each lies, its flags (bit 0 learning, bit 1 a
  // new segment's), its list place and its chosen count, read by one
  // thread a row before any row is
  __shared__ long long s_base[kRowsPerBlock];
  __shared__ int s_l[kRowsPerBlock], s_n[kRowsPerBlock];
  __shared__ int s_flags[kRowsPerBlock];
  __shared__ int sums[2];
  const int b = blockIdx.x / groups;
  const int group = blockIdx.x - b * groups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = group * kRowsPerBlock;
  const int n_rows = min(kRowsPerBlock, R - row0);
  const unsigned below = (1u << lane) - 1u;
  const int K = rows.K;
  if (threadIdx.x < 2) sums[threadIdx.x] = 0;
  if (threadIdx.x < n_rows) {
    const int j = threadIdx.x;
    const long long q = (long long)b * R + row0 + j;
    const int l = __ldg(lpos + q);
    s_base[j] = rows.slot(b, row0 + j);
    s_flags[j] = (__ldg(learn + q) != 0) | (__ldg(fresh + q) != 0) << 1;
    s_l[j] = l;
    s_n[j] = l >= 0 ? __ldg(n_chosen + (long long)b * L + l) : 0;
  }
  __syncthreads();

  // a warp's rows j = warp + h * kWarps: the first round of each (and
  // its cells) loaded before any is used, later rounds row by row
  int grown = 0, over = 0;  // lane 0's sums over the warp's rows
  Round<ELEM, kC> x[kRows];
  int cell_l[kRows];
#pragma unroll
  for (int h = 0; h < kRows; ++h) {
    const int j = warp + h * kWarps;
    if (j < n_rows) {
      const int l = s_l[j];
      const int* cells = chosen + ((long long)b * L + (l >= 0 ? l : 0)) * kk;
      cell_l[h] = kShfl && s_n[j] > 0 && lane < kk ? __ldg(cells + lane) : 0;
      x[h].load(syn, perm, act, s_base[j], 0, K, lane);
    }
  }
#pragma unroll
  for (int h = 0; h < kRows; ++h) {
    const int j = warp + h * kWarps;
    if (j < n_rows) {
      const int l = s_l[j];
      RowPass r;
      r.q = (long long)b * R + row0 + j;
      r.base = s_base[j];
      r.learn = s_flags[j] & 1;
      r.empty = s_flags[j] & 2;
      r.n = s_n[j];
      r.ranked = 0;
      r.cells = chosen + ((long long)b * L + (l >= 0 ? l : 0)) * kk;
      r.cell_l = cell_l[h];
      pass_round<ELEM, kC, kShfl, kMask>(syn, perm, wrote, x[h], r, 0, K,
                                         inc, dec, perm_init, lane, below);
      for (int k0 = 32 * kC; k0 < K; k0 += 32 * kC) {
        Round<ELEM, kC> y;
        y.load(syn, perm, act, r.base, k0, K, lane);
        pass_round<ELEM, kC, kShfl, kMask>(syn, perm, wrote, y, r, k0, K,
                                           inc, dec, perm_init, lane,
                                           below);
      }
      if (lane == 0 && l >= 0) {
        grown += min(r.ranked, r.n);
        over += max(r.n - r.ranked, 0);
      }
    }
  }
  if (lane == 0 && (grown | over)) {
    atomicAdd(&sums[0], grown);
    atomicAdd(&sums[1], over);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (sums[0]) atomicAdd(counts + b, sums[0]);
    if (sums[1]) atomicAdd(counts + B + b, sums[1]);
  }
}

template <int ELEM, int kC, bool kShfl, bool kMask>
int launch_learn(int* syn, float* perm, const void* act, Rows rows,
                 const uint8_t* learn, const uint8_t* fresh, const int* lpos,
                 const int* chosen, const int* n_chosen, int* counts,
                 uint8_t* wrote, int B, int R, int L, int kk, float inc,
                 float dec, float perm_init, cudaStream_t stream) {
  const int groups = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long blocks = (long long)B * groups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  learn_rows_kernel<ELEM, kC, kShfl, kMask>
      <<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
          syn, perm, act, rows, learn, fresh, lpos, chosen, n_chosen, counts,
          wrote, B, R, L, kk, inc, dec, perm_init, groups);
  return (int)cudaGetLastError();
}

bool bad_rows(int B, int Ct, int A, int G, int K, const int* cols) {
  return B < 0 || A < 0 || G < 1 || K < 1 || Ct < 1 ||
         (!cols && Ct != A);
}

}  // namespace

// syn (B, Ct, G*K) int32, perm float32 and act (act_bytes a value: 1 u8,
// 2 bf16, 4 float32) tables; cols (B, A) int32, the active columns, or
// null for tables of gathered rows (Ct = A) -> potential, connected and
// live (B, A*G) int32, decoded with scale > K. Launches on the given
// stream of the given device, allocates nothing and returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int row_counts(const int* syn, const float* perm, const void* act,
                          const int* cols, int* potential, int* connected,
                          int* live, int B, int Ct, int A, int G, int K,
                          int scale, int act_bytes, int device,
                          void* stream) {
  if (bad_rows(B, Ct, A, G, K, cols) || scale <= K)
    return (int)cudaErrorInvalidValue;
  const long long n_rows = (long long)B * A * G;
  if (n_rows == 0) return 0;
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows rows{cols, Ct, A, G, K};
  long long blocks = (n_rows + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return bithtm::with_bytes(act_bytes, [&](auto bytes) {
    row_counts_kernel<decltype(bytes)::value>
        <<<(unsigned)blocks, kWarps * 32, 0, s>>>(
            syn, perm, act, rows, potential, connected, live, n_rows, A * G,
            scale);
    return (int)cudaGetLastError();
  });
}

// syn (B, Ct, G*K) int32 and perm float32, updated in place, and act (as
// row_counts); cols as row_counts'; learn and fresh (B, R) bool, R = A*G,
// the learning rows and the new segments' rows; lpos (B, R) int32, each
// row's place in the growing-row list or -1; chosen (B, L, kk) int32
// cells and n_chosen (B, L) int32, the selection; counts (4, B) int32,
// rows 0 and 1 zero on entry (grow_select); wrote (B, R, K) bool, the
// slots grown, or null. Launches on the given stream of the given device,
// allocates nothing and returns cudaGetLastError() after the launch (0 =
// success).
extern "C" int learn_rows(int* syn, float* perm, const void* act,
                          const int* cols, const void* learn,
                          const void* fresh, const int* lpos,
                          const int* chosen, const int* n_chosen,
                          int* counts, void* wrote, int B, int Ct, int A,
                          int G, int K, int L, int kk, float inc, float dec,
                          float perm_init, int act_bytes, int device,
                          void* stream) {
  if (bad_rows(B, Ct, A, G, K, cols) || L < 0 || kk < 1)
    return (int)cudaErrorInvalidValue;
  const int R = A * G;
  if ((long long)B * R == 0) return 0;
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows rows{cols, Ct, A, G, K};
  const uint8_t* lf = static_cast<const uint8_t*>(learn);
  const uint8_t* fr = static_cast<const uint8_t*>(fresh);
  uint8_t* w = static_cast<uint8_t*>(wrote);
  // rounds of 64 slots up to K = 64, else of 128
  return bithtm::with_bytes(act_bytes, [&](auto bytes) {
    return bithtm::with_bool(K <= 64, [&](auto narrow) {
      return bithtm::with_bool(kk <= 32, [&](auto shfl) {
        return bithtm::with_bool(w != nullptr, [&](auto mask) {
          return launch_learn<decltype(bytes)::value,
                              decltype(narrow)::value ? 2 : 4,
                              decltype(shfl)::value, decltype(mask)::value>(
              syn, perm, act, rows, lf, fr, lpos, chosen, n_chosen, counts,
              w, B, R, L, kk, inc, dec, perm_init, s);
        });
      });
    });
  });
}
