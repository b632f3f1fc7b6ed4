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
// Design. Two paths, chosen from the shapes (ops/kernels.py
// `_learn_loads`).
// "v16" (u8 activity, K a multiple of 8: every shipped configuration): a
// warp takes a column, whose G rows lie side by side, G*K slots of each
// table (at the bench 1 KB of syn, 1 KB of perm and 256 B of activity).
// Lane i takes slots 8i..8i+7 of each round of 256, which lie in one row:
// two 16-byte loads of syn, two of perm and one 8-byte load of the
// activity, where the earlier schedule took six scalar loads a row. A
// free slot's rank in its row is the lane's exclusive count of free
// slots within the row (one scan over the warp, the row's first lane's
// subtracted, plus the row's count carried from the round before) and
// the popcount of the lane's free slots before it. The fill's cells come
// from the row's list entry: read one a lane and passed to the slots by
// shuffles up to kk = 32 ("shfl"; the first growing row's read with the
// slots), else read by each grown slot ("load"). No block prologue: the
// blocks of 4 warps are persistent, about one wave, and each warp walks a
// run of (stream, column) pairs, reading each column's index, flags and
// list places itself (read a column ahead, they cost registers and
// measured slower: PERF.md); its counts meet in one atomic a count and
// stream it walked. A 16-byte vector is stored only where one of its
// slots changed or grew; the mask, where asked for, for every slot.
// "scalar" (K = 125 and 127 at G = 2 in the fuzz geometries, the bf16
// and f32 activity): a warp takes a row: lane i holds slots i, i+32, ...,
// and loads a round of 32-slot chunks of all three tables (two up to K =
// 64, else four); a ballot over each chunk ranks the free slots; a block
// of 8 warps takes 16 rows of a stream behind a prologue that reads where
// each row lies, its flags, its list place and its chosen count into
// shared memory, so that a warp's two rows cost one round of loads.
// What held the scalar schedule at the bench (PERF.md): its loads, 79%
// of its time, in three dependent rounds (column, list place, slots) a
// block of 16 rows, 2.7 waves of blocks.
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

// ---- learn_rows, path "v16" (u8 activity, K a multiple of 8): a warp a
// column. The G rows of a column lie side by side, G*K slots of each
// table, so lane i takes slots 8i..8i+7 of each round of 256 (two 16-byte
// loads of syn, two of perm, one 8-byte load of the activity), all in one
// row. A free slot's rank in its row is its lane's exclusive count within
// the row (a scan over the warp, its row's first lane subtracted, plus
// the row's count in the rounds before) and the popcount of the lane's
// free slots before it.

constexpr int kColWarps = 4;
// at most 128 registers a thread (four blocks an SM at the cap)
constexpr int kColMinBlocks = 4;

// A column's header, read a column ahead: where its slots lie (base) and,
// lane g for row g, its flags (bit 0 learning, bit 1 a new segment's) and
// its list place.
struct ColHead {
  long long base;
  int flags, l;
};

__device__ __forceinline__ ColHead col_head(
    const int* cols, const uint8_t* learn, const uint8_t* fresh,
    const int* lpos, long long q, int b, int a, int Ct, int G, int K,
    int lane) {
  ColHead h;
  const int col = cols ? __ldg(cols + q) : a;
  h.base = ((long long)b * Ct + col) * G * K;
  h.flags = 0;
  h.l = -1;
  if (lane < G) {
    const long long r = q * G + lane;
    h.flags = (__ldg(learn + r) != 0) | (__ldg(fresh + r) != 0) << 1;
    h.l = __ldg(lpos + r);
  }
  return h;
}

// Eight slots of a lane: syn, perm and the activity bytes, updated in
// place.
struct Slots8 {
  int4 s[2];
  float4 p[2];
  uint2 a;

  // the slots from at where in, else empty (never stored)
  __device__ __forceinline__ void load_if(bool in, const int* syn,
                                          const float* perm,
                                          const uint8_t* act, long long at) {
    if (!in) {
      s[0] = s[1] = make_int4(-1, -1, -1, -1);
      p[0] = p[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      a = make_uint2(0u, 0u);
      return;
    }
    s[0] = *reinterpret_cast<const int4*>(syn + at);
    s[1] = *reinterpret_cast<const int4*>(syn + at + 4);
    p[0] = *reinterpret_cast<const float4*>(perm + at);
    p[1] = *reinterpret_cast<const float4*>(perm + at + 4);
    a = __ldg(reinterpret_cast<const uint2*>(act + at));
  }
  __device__ __forceinline__ int& syn_at(int j) {
    return reinterpret_cast<int*>(s)[j];
  }
  __device__ __forceinline__ float& perm_at(int j) {
    return reinterpret_cast<float*>(p)[j];
  }
  __device__ __forceinline__ bool act_at(int j) const {
    return ((j < 4 ? a.x : a.y) >> (8 * (j & 3))) & 0xffu;
  }
};

// Persistent blocks of kColWarps warps, about one wave; warp w takes the
// (stream, column) pairs [w * chunk, (w + 1) * chunk), q = b * A + a.
template <bool kShfl, bool kMask>
__global__ void __launch_bounds__(kColWarps * 32, kColMinBlocks)
    learn_rows_kernel_v16(
        int* __restrict__ syn, float* __restrict__ perm,
        const uint8_t* __restrict__ act, const int* __restrict__ cols,
        int Ct, int A, int G, int K, const uint8_t* __restrict__ learn,
        const uint8_t* __restrict__ fresh, const int* __restrict__ lpos,
        const int* __restrict__ chosen, const int* __restrict__ n_chosen,
        int* __restrict__ counts, uint8_t* __restrict__ wrote, int B, int L,
        int kk, float inc, float dec, float perm_init, long long n_pairs,
        long long chunk) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long q0 = warp * chunk;
  const long long q1 = min(q0 + chunk, n_pairs);
  if (q0 >= q1) return;
  const int J = G * K;
  // (b, a) of q, and of the next column's header (nb, na): stepped, not
  // divided
  int b = (int)(q0 / A), a = (int)(q0 - (long long)b * A);
  int nb = b, na = a;
  int grown = 0, over = 0;  // this lane's sums for stream b
  ColHead h = col_head(cols, learn, fresh, lpos, q0, b, a, Ct, G, K, lane);
  for (long long q = q0; q < q1; ++q) {
    if (++na == A) {
      na = 0;
      ++nb;
    }
    if (q > q0 && ++a == A) {  // the warp's sums for stream b, then b + 1
      a = 0;
      grown = __reduce_add_sync(kFull, grown);
      over = __reduce_add_sync(kFull, over);
      if (lane == 0) {
        if (grown) atomicAdd(counts + b, grown);
        if (over) atomicAdd(counts + B + b, over);
      }
      grown = over = 0;
      ++b;
    }
    // this column's first round and its rows' chosen counts and first
    // cells, then the next column's header, before any of them is used
    Slots8 x;
    x.load_if(8 * lane < J, syn, perm, act, h.base + 8 * lane);
    const int n_row =
        h.l >= 0 ? __ldg(n_chosen + (long long)b * L + h.l) : 0;
    const unsigned grows = __ballot_sync(kFull, h.l >= 0);
    int cell0 = 0;
    if (kShfl && grows) {
      const int l0 = __shfl_sync(kFull, h.l, __ffs(grows) - 1);
      if (lane < kk)
        cell0 = __ldg(chosen + ((long long)b * L + l0) * kk + lane);
    }
    const ColHead cur = h;
    int carry = 0, carry_row = -1;
    for (int k0 = 0; k0 < J; k0 += 256) {
      const int k = k0 + 8 * lane;
      const bool in = k < J;
      if (k0 > 0) x.load_if(in, syn, perm, act, cur.base + k);
      const int g = in ? k / K : 0;
      const int fl = __shfl_sync(kFull, cur.flags, g);
      const int nr = __shfl_sync(kFull, n_row, g);
      const int lr = __shfl_sync(kFull, cur.l, g);
      const bool row_learn = fl & 1, row_empty = fl & 2;
      // the update and death in place; which slots changed and are free
      unsigned fmask = 0, schg = 0, pchg = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int& s = x.syn_at(j);
        float& pv = x.perm_at(j);
        const int s0 = s;
        const unsigned p0 = __float_as_uint(pv);
        if (pv < 0.0f || row_empty) {  // stale, or a new segment's row
          s = -1;
          pv = -1.0f;
        }
        const bool live = s >= 0;
        const float delta = x.act_at(j) ? inc : -dec;
        pv = __fadd_rn(pv,
                       __fmul_rn(row_learn && live ? 1.0f : 0.0f, delta));
        if (live && pv < 0.0f) {  // death
          s = -1;
          pv = -1.0f;
        }
        schg |= (unsigned)(s != s0) << j;
        pchg |= (unsigned)(__float_as_uint(pv) != p0) << j;
        fmask |= (unsigned)(in && s < 0) << j;
      }
      // the lane's free slots' first rank in its row
      const int cnt = __popc(fmask);
      int incl = cnt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      const int excl = incl - cnt;
      const int start = g * K > k0 ? (g * K - k0) >> 3 : 0;
      const int rank0 = excl - __shfl_sync(kFull, excl, start) +
                        (g == carry_row ? carry : 0);
      // the round's last lane carries its row's count into the next round
      const int last = min(31, ((J - k0) >> 3) - 1);
      carry = __shfl_sync(kFull, rank0 + cnt, last);
      carry_row = __shfl_sync(kFull, g, last);
      if (in && lr >= 0 && k + 8 == (g + 1) * K) {  // the row's last lane
        grown += min(rank0 + cnt, nr);
        over += max(nr - (rank0 + cnt), 0);
      }
      // the fill: free slot j of rank fr < n takes chosen[l, fr]
      unsigned gmask = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int fr = rank0 + __popc(fmask & ((1u << j) - 1u));
        gmask |= (unsigned)(((fmask >> j) & 1u) && fr < nr) << j;
      }
      if constexpr (kShfl) {
        // a growing row at a time (the first's cells read ahead): its
        // cells one a lane, passed to the slots by shuffles
        for (unsigned rows = grows; rows; rows &= rows - 1) {
          const int gg = __ffs(rows) - 1;
          if (!__any_sync(kFull, gmask && g == gg)) continue;
          int cg = cell0;
          if (gg != __ffs(grows) - 1) {
            const int lg = __shfl_sync(kFull, cur.l, gg);
            cg = lane < kk
                     ? __ldg(chosen + ((long long)b * L + lg) * kk + lane)
                     : 0;
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int fr = rank0 + __popc(fmask & ((1u << j) - 1u));
            const int c = __shfl_sync(kFull, cg, fr & 31);
            if (g == gg && ((gmask >> j) & 1u)) {
              x.syn_at(j) = c;
              x.perm_at(j) = perm_init;
            }
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if ((gmask >> j) & 1u) {
            const int fr = rank0 + __popc(fmask & ((1u << j) - 1u));
            x.syn_at(j) = __ldg(chosen + ((long long)b * L + lr) * kk + fr);
            x.perm_at(j) = perm_init;
          }
      }
      // a 16-byte vector stored where one of its slots changed or grew
      schg |= gmask;
      pchg |= gmask;
      if (in) {
        const long long at = cur.base + k;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          if ((schg >> (4 * v)) & 0xfu)
            *reinterpret_cast<int4*>(syn + at + 4 * v) = x.s[v];
          if ((pchg >> (4 * v)) & 0xfu)
            *reinterpret_cast<float4*>(perm + at + 4 * v) = x.p[v];
        }
        if constexpr (kMask) {
          uint2 m;
          m.x = (gmask & 1u) | (gmask & 2u) << 7 | (gmask & 4u) << 14 |
                (gmask & 8u) << 21;
          m.y = (gmask >> 4 & 1u) | (gmask >> 4 & 2u) << 7 |
                (gmask >> 4 & 4u) << 14 | (gmask >> 4 & 8u) << 21;
          *reinterpret_cast<uint2*>(wrote + q * J + k) = m;
        }
      }
    }
    // the next column's header, read after this one's work (read before
    // it, it cost registers and measured slower: PERF.md)
    if (q + 1 < q1)
      h = col_head(cols, learn, fresh, lpos, q + 1, nb, na, Ct, G, K, lane);
  }
  grown = __reduce_add_sync(kFull, grown);
  over = __reduce_add_sync(kFull, over);
  if (lane == 0) {
    if (grown) atomicAdd(counts + b, grown);
    if (over) atomicAdd(counts + B + b, over);
  }
}

template <bool kShfl, bool kMask>
int launch_learn_v16(int* syn, float* perm, const uint8_t* act,
                     const int* cols, int Ct, int A, int G, int K,
                     const uint8_t* learn, const uint8_t* fresh,
                     const int* lpos, const int* chosen, const int* n_chosen,
                     int* counts, uint8_t* wrote, int B, int L, int kk,
                     float inc, float dec, float perm_init,
                     cudaStream_t stream) {
  auto kernel = learn_rows_kernel_v16<kShfl, kMask>;
  constexpr int threads = kColWarps * 32;
  int per_sm = 0;
  if (int err = bithtm::resident_blocks(kernel, threads, 0, &per_sm))
    return err;
  const long long n_pairs = (long long)B * A;
  const long long slots =
      (long long)kColWarps * (per_sm > 0 ? per_sm : 1) * bithtm::sm_count();
  const long long chunk = (n_pairs + slots - 1) / (slots > 0 ? slots : 1);
  const long long warps = (n_pairs + chunk - 1) / chunk;
  const long long blocks = (warps + kColWarps - 1) / kColWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      syn, perm, act, cols, Ct, A, G, K, learn, fresh, lpos, chosen,
      n_chosen, counts, wrote, B, L, kk, inc, dec, perm_init, n_pairs, chunk);
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
// slots grown, or null; vec: the path "v16" (act_bytes 1, K a multiple of
// 8; syn and perm 16-byte and act 8-byte aligned), else "scalar".
// Launches on the given stream of the given device,
// allocates nothing and returns cudaGetLastError() after the launch (0 =
// success).
extern "C" int learn_rows(int* syn, float* perm, const void* act,
                          const int* cols, const void* learn,
                          const void* fresh, const int* lpos,
                          const int* chosen, const int* n_chosen,
                          int* counts, void* wrote, int B, int Ct, int A,
                          int G, int K, int L, int kk, float inc, float dec,
                          float perm_init, int act_bytes, int vec,
                          int device, void* stream) {
  if (bad_rows(B, Ct, A, G, K, cols) || L < 0 || kk < 1 ||
      (vec && (act_bytes != 1 || K % 8)))
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
  if (vec)
    return bithtm::with_bool(kk <= 32, [&](auto shfl) {
      return bithtm::with_bool(w != nullptr, [&](auto mask) {
        return launch_learn_v16<decltype(shfl)::value,
                                decltype(mask)::value>(
            syn, perm, static_cast<const uint8_t*>(act), cols, Ct, A, G, K,
            lf, fr, lpos, chosen, n_chosen, counts, w, B, L, kk, inc, dec,
            perm_init, s);
      });
    });
  // path "scalar": rounds of 64 slots up to K = 64, else of 128
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
