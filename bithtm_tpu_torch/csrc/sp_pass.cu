// Spatial pooler Hebbian update and connected re-pack, for NVIDIA Hopper
// (sm_90a): two entry points.
//
//   sp_update_pack <- sp_update_pack_tpu
//                     (bithtm_tpu/ops/pallas_kernels.py:598, body
//                     _sp_kernel :549): every row of the table, the
//                     fused form that no step dispatches
//   sp_rows        <- the learning half of the JAX step's sp_step
//                     (bithtm_tpu/models/spatial_pooler.py:81-126), its
//                     sparse-row form, which has no Pallas kernel: the A
//                     active rows only, the step's update
// Plain PyTorch versions: bithtm_tpu_torch/models/spatial_pooler.py
// (sp_update_pack_ref, sp_rows_ref).
//
// sp_update_pack. Per stream b, column c and input lane i of the
// (C, I_pad) permanence table, with act = (c is one of the stream's A
// active columns):
//   int16 units:  p = clip(perm + act * delta[i], -32000, 32000)
//   float32:      p = perm + act * delta[i]
//   perm[b, c, i] = p          (every row, in place)
//   bit j of pack[b, c, w] = (p at lane j*S + w) >= threshold,
// S = I_pad / 8: the strided pack of ops/overlap.py pack_input. The int16
// arithmetic is widened to int32, as in the TPU kernel.
//
// Bound: bytes. The function needs the permanences read once, the rows
// it changes written and the packed table written: at B=256, C=2048,
// I_pad=1024, A=41 that is 1.16 GB in int16 and 2.26 GB in float32,
// about 0.35 ms and 0.67 ms at the H100's 3.35 TB/s. The TPU kernel (and
// this one's first design) wrote every row back, 2.21 GB and 4.36 GB.
//
// Design. Each block marks its stream's active columns in a C-bit
// shared-memory bitmap and stages the stream's delta row (4 * I_pad
// bytes) beside it, once. Then each thread takes 8 neighbouring packed
// bytes of one row: it loads the 8 strided slices of 8 permanences (16
// bytes each as int16, 32 as float32) in one go, so that all of them are
// in flight together, updates them with the deltas from shared memory,
// and stores a 16-byte vector back only where one of its bits changed.
// Every vector of an active row changes where its delta is not 0; in an
// inactive row a vector changes only where the clip moves a value past
// +-32000 or p + 0 * d changes a bit (-0.0 becomes +0.0). Writing exactly
// the changed vectors keeps the table bit-equal to writing every row,
// while the writes fall to the A active rows (as the table pass writes a
// permanence back only where it is punished). The 8 packed bytes go out
// as one 8-byte store. The grid is (runs of packed bytes, B).
//
// Two more paths, chosen by the wrapper from the shapes (ops/kernels.py):
//   - past 4 * I_pad + 4 * ceil(C/32) > 232,448 bytes of shared memory
//     (GMEM): the delta row is read from global memory through the
//     read-only cache instead of being staged, and the active-column
//     bitmap is built by a pass before (a block a stream) into a global
//     scratch, so the kernel holds no shared memory;
//   - past 65,535 streams (FOLD): the stream is folded into grid x,
//     (groups blocks x B), where the grid's y extent would not hold it.
//
// sp_rows. Per stream b and each of its A active columns c =
// cols[b, a], with x the stream's (I,) bool input and the delta of lane
// i: d_on where x[i], d_off where not (delta = x * (inc + dec) - dec,
// which the wrapper evaluates as the plain version does), 0 on the
// padding lanes i >= I:
//   int16 units:  perm[b, c, i] = clip(perm[b, c, i] + d, -32000, 32000)
//   float32:      perm[b, c, i] = perm[b, c, i] + d   (one rounding)
//   pack[b, c, :] = the strided pack of perm[b, c, :] >= threshold,
// in place; every other row of both tables keeps its bits (-0.0 and
// values past the rail included). A column that appears twice in a
// stream's list is updated once, as the scatter of the JAX step writes
// the same row twice with the same value.
//
// Bound: bytes. The A active rows read and written once and their packed
// rows written: B*A*(2*I_pad*size + I_pad/8) bytes plus the inputs, at
// B=256, C=2048, I_pad=1024, A=41 in int16 about 44.3 MB, 0.0132 ms at
// 3.35 TB/s; at 16384 x 64 (B=64, A=328) about 88.7 MB, 0.026 ms.
//
// Design (an earlier one held each thread's 8 slices of a row in registers,
// 115 to 174 a thread, 16 rows a block). The work is cut into units: 128
// packed bytes of one row, its 8 slices of 128 lanes (the whole row where
// I_pad = 1024), a stream's units in tile-major order. A block takes a run
// of one stream's units: about kFillBlocks blocks over the launch, or runs
// of at most kRunUnits units where that makes more (a stream a block at the
// bench's 256 streams, seven at 16K's 64); the grid is (runs, B), or with
// FOLD the streams folded into grid x. Each warp first starts its first
// units' copies, then the block stages the input of its run's tiles once,
// packed in the strided layout, and marks its stream's columns once in a
// C-bit bitmap in shared memory: every entry sets its column's bit, and a
// column whose bit was already set is marked repeated. A unit updates its
// row unless its column is out of range, or repeated and held by an earlier
// entry of the list (the warp checks those entries): so each row is written
// once, by the first entry that lists it, in every block that holds a tile
// of it. Each warp streams its units through its own stages of a ring in
// shared memory: one lane starts a unit's TMA bulk copy (the row in one
// copy, or its 8 slices), completion on the stage's mbarrier, kStages units
// ahead, so the bytes in flight are the ring's and not registers. A lane
// updates 4 lanes of each slice from the stage with the deltas the staged
// input's bits select, stores them back to the table as a vector, and writes
// its 4 packed bytes as one 4-byte store (a TMA bulk store of the updated
// stage measured no faster). Past kBitmapCols columns the bitmap is not kept
// and every unit checks the entries before its own. No atomics outside the
// bitmaps. What holds it: the row stores (a third of the time at 16K) and
// reads of scattered 2 KB rows at about half the card's rate.

#include <climits>
#include <type_traits>

#include "active_bitmap.cuh"
#include "launch.cuh"

namespace {

using bithtm::kThreads;

constexpr int kVec = 8;                  // packed bytes a thread
constexpr int kGroupsPerBlock = 2048;    // runs of kVec packed bytes

struct Int16Units {
  using T = int16_t;
  using D = int;
  int threshold;
  __device__ __forceinline__ T update(T p, D d, bool act, bool* conn) const {
    int v = static_cast<int>(p) + (act ? d : 0);
    v = min(max(v, -32000), 32000);
    *conn = v >= threshold;
    return static_cast<T>(v);
  }
  // sp_rows: p + d, clipped
  __device__ __forceinline__ T add(T p, D d, bool* conn) const {
    int v = min(max(static_cast<int>(p) + d, -32000), 32000);
    *conn = v >= threshold;
    return static_cast<T>(v);
  }
};

struct Float32 {
  using T = float;
  using D = float;
  float threshold;
  __device__ __forceinline__ T update(T p, D d, bool act, bool* conn) const {
    const float v = __fadd_rn(p, __fmul_rn(act ? 1.0f : 0.0f, d));
    *conn = v >= threshold;
    return v;
  }
  // sp_rows: p + d, rounded once
  __device__ __forceinline__ T add(T p, D d, bool* conn) const {
    const float v = __fadd_rn(p, d);
    *conn = v >= threshold;
    return v;
  }
};

// 8 consecutive lanes of type T: one 16-byte vector for int16, two for
// float32.
template <typename T>
struct Lanes {
  static constexpr int kVectors = sizeof(T) * kVec / 16;
  int4 v[kVectors];
  // RO: p lies in global memory that no thread writes (read-only cache)
  template <bool RO = false>
  __device__ __forceinline__ void load(const T* p) {
    const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
    for (int k = 0; k < kVectors; ++k) v[k] = RO ? __ldg(q + k) : q[k];
  }
  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int k = 0; k < kVectors; ++k) reinterpret_cast<int4*>(p)[k] = v[k];
  }
  // Stores the vectors whose bits differ from `old`'s.
  __device__ __forceinline__ void store_changed(T* p, const Lanes& old) const {
#pragma unroll
    for (int k = 0; k < kVectors; ++k) {
      const int4 a = v[k], o = old.v[k];
      if ((a.x ^ o.x) | (a.y ^ o.y) | (a.z ^ o.z) | (a.w ^ o.w))
        reinterpret_cast<int4*>(p)[k] = a;
    }
  }
  __device__ __forceinline__ T& operator[](int e) {
    return reinterpret_cast<T*>(v)[e];
  }
};

// Words of a stream's active-column bitmap.
__host__ __device__ __forceinline__ int column_words(int C) {
  return (C + 31) >> 5;
}

// The GMEM path's first pass: stream blockIdx.x's active-column bitmap
// (column_words(C) words) at bms + b * column_words(C).
__global__ void __launch_bounds__(kThreads) build_column_bitmaps_kernel(
    uint32_t* __restrict__ bms, const int* __restrict__ cols, int C, int A) {
  const size_t b = blockIdx.x;
  uint32_t* active = bms + b * column_words(C);
  for (int i = threadIdx.x; i < column_words(C); i += blockDim.x)
    active[i] = 0u;
  __syncthreads();
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const int c = cols[b * A + a];
    if (c >= 0 && c < C) atomicOr(&active[c >> 5], 1u << (c & 31));
  }
}

template <class Op, bool GMEM, bool FOLD>
__global__ void __launch_bounds__(kThreads) sp_update_pack_kernel(
    typename Op::T* __restrict__ perm,
    const typename Op::D* __restrict__ delta, const int* __restrict__ cols,
    const uint32_t* __restrict__ col_bms, uint8_t* __restrict__ pack, int C,
    int I_pad, int A, int blocks_per_stream, Op op) {
  using T = typename Op::T;
  using D = typename Op::D;
  // the delta row (I_pad * 4 bytes, a multiple of 16), then the bitmap
  extern __shared__ int4 smem[];
  const size_t b = FOLD ? blockIdx.x / blocks_per_stream : blockIdx.y;
  const int bx = FOLD ? blockIdx.x - (int)(b * blocks_per_stream)
                      : (int)blockIdx.x;
  const D* dl;
  const uint32_t* active;
  if constexpr (GMEM) {
    dl = delta + b * I_pad;
    active = col_bms + b * column_words(C);
  } else {
    D* dl_s = reinterpret_cast<D*>(smem);
    uint32_t* active_s = reinterpret_cast<uint32_t*>(dl_s + I_pad);
    const int4* src = reinterpret_cast<const int4*>(delta + b * I_pad);
    for (int i = threadIdx.x; i < I_pad / 4; i += blockDim.x) smem[i] = src[i];
    for (int i = threadIdx.x; i < column_words(C); i += blockDim.x)
      active_s[i] = 0u;
    __syncthreads();
    for (int a = threadIdx.x; a < A; a += blockDim.x) {
      const int c = cols[b * A + a];
      if (c >= 0 && c < C) atomicOr(&active_s[c >> 5], 1u << (c & 31));
    }
    __syncthreads();
    dl = dl_s;
    active = active_s;
  }

  const int S = I_pad >> 3;
  const int row_groups = S / kVec;
  const long long n_groups = (long long)C * row_groups;
  const long long g0 = (long long)bx * kGroupsPerBlock;
  const long long g1 = min(g0 + kGroupsPerBlock, n_groups);
  for (long long g = g0 + threadIdx.x; g < g1; g += blockDim.x) {
    const int c = static_cast<int>(g / row_groups);
    const int w0 = static_cast<int>(g - (long long)c * row_groups) * kVec;
    const uint32_t word = GMEM ? __ldg(active + (c >> 5)) : active[c >> 5];
    const bool act = (word >> (c & 31)) & 1u;
    T* row = perm + (b * C + c) * I_pad;
    Lanes<T> p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j].load(row + j * S + w0);
    uint8_t byte[kVec] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      Lanes<D> d;
      d.template load<GMEM>(dl + j * S + w0);
      Lanes<T> q;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        bool conn;
        q[e] = op.update(p[j][e], d[e], act, &conn);
        byte[e] |= static_cast<uint8_t>(conn) << j;
      }
      q.store_changed(row + j * S + w0, p[j]);
    }
    uint2 out;
    out.x = byte[0] | byte[1] << 8 | byte[2] << 16 | (uint32_t)byte[3] << 24;
    out.y = byte[4] | byte[5] << 8 | byte[6] << 16 | (uint32_t)byte[7] << 24;
    *reinterpret_cast<uint2*>(pack + (b * C + c) * S + w0) = out;
  }
}

template <class Op, bool GMEM, bool FOLD>
int launch(void* perm, const void* delta, const int* cols, uint32_t* col_bms,
           uint8_t* pack, int B, int C, int I_pad, int A, Op op,
           cudaStream_t stream) {
  auto kernel = sp_update_pack_kernel<Op, GMEM, FOLD>;
  size_t smem = 0;
  if constexpr (GMEM) {
    if (B > 0)
      build_column_bitmaps_kernel<<<B, kThreads, 0, stream>>>(col_bms, cols,
                                                              C, A);
    if (int err = (int)cudaGetLastError()) return err;
  } else {
    smem = (size_t)I_pad * 4 + (size_t)column_words(C) * 4;
    if (smem > bithtm::kMaxShared) return (int)cudaErrorInvalidValue;
    if (int err = bithtm::allow_shared(
            kernel, smem > 48 * 1024 ? bithtm::kMaxShared : smem))
      return err;
  }
  const long long n_groups = (long long)C * (I_pad / 8 / kVec);
  const int per_stream =
      (int)((n_groups + kGroupsPerBlock - 1) / kGroupsPerBlock);
  const dim3 grid = FOLD ? dim3((unsigned)((size_t)per_stream * B), 1)
                         : dim3(per_stream, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<typename Op::T*>(perm),
      static_cast<const typename Op::D*>(delta), cols, col_bms, pack, C,
      I_pad, A, per_stream, op);
  return (int)cudaGetLastError();
}

template <class Op>
int dispatch(void* perm, const void* delta, const int* cols,
             uint32_t* col_bms, uint8_t* pack, int B, int C, int I_pad, int A,
             int fold, Op op, cudaStream_t s) {
  return bithtm::with_bool(col_bms != nullptr, [&](auto gmem) {
    return bithtm::with_bool(fold != 0, [&](auto folded) {
      return launch<Op, decltype(gmem)::value, decltype(folded)::value>(
          perm, delta, cols, col_bms, pack, B, C, I_pad, A, op, s);
    });
  });
}

// ---- sp_rows

constexpr unsigned kAll = 0xffffffffu;
constexpr int kRowWarps = kThreads / 32;  // 8 warps a block
// a unit: 128 packed bytes of one row, its 8 slices of 128 lanes (the
// whole row where S = 128), 4 packed bytes a lane
constexpr int kUnitBytes = 128;
constexpr int kUnitLanes = 8 * kUnitBytes;
// a block's ring of units in shared memory, its stages split among its
// warps: 4 a warp in int16 (2 KB a unit), 2 in float32 (4 KB)
constexpr int kRingBytes = 64 * 1024;
// the blocks a launch aims at (two on each of the H100's 132 SMs), and
// the units a run of a stream holds at most where that makes more runs
constexpr int kFillBlocks = 264;
constexpr int kRunUnits = 48;
// the packed input a block stages: a run's units span at most this many
// tiles
constexpr int kXsTiles = kRunUnits + 1;
// the first-claim bitmaps in shared memory up to this many columns; past
// it each unit checks its column against the entries before it
constexpr int kBitmapCols = 65536;

// A stream's units, tile-major (unit u: tile u / A of entry u % A), split
// into runs of `per` units, `per_stream` runs a stream: about kFillBlocks
// blocks over the streams, or runs of at most kRunUnits units where that
// makes more.
struct RowGrid {
  int tiles, per, per_stream;
  __host__ __device__ RowGrid(int S, int A, int B) {
    tiles = S / kUnitBytes;
    const long long units = (long long)A * tiles;
    long long runs = B > 0 ? kFillBlocks / B : 1;
    const long long by_units = (units + kRunUnits - 1) / kRunUnits;
    runs = runs > by_units ? runs : by_units;
    runs = runs < 1 ? 1 : runs > units ? units : runs;
    const long long p = (units + runs - 1) / runs;
    per = (int)p;
    per_stream = (int)((units + p - 1) / p);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// The bulk copy of `bytes` (a multiple of 16) from global src to shared
// dst, its completion counted on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// 4 lanes of type T: 8 bytes of int16, 16 of float32.
template <typename T>
struct Quad {
  using V = typename std::conditional<sizeof(T) == 2, uint2, uint4>::type;
  V v;
  __device__ __forceinline__ T& operator[](int e) {
    return reinterpret_cast<T*>(&v)[e];
  }
};

template <class Op, bool FOLD, bool BITMAP>
__global__ void __launch_bounds__(kThreads) sp_rows_kernel(
    typename Op::T* __restrict__ perm, uint8_t* __restrict__ pack,
    const uint8_t* __restrict__ bits, const int* __restrict__ cols, int C,
    int I, int I_pad, int A, typename Op::D d_on, typename Op::D d_off,
    Op op) {
  using T = typename Op::T;
  using D = typename Op::D;
  constexpr int kStages = kRingBytes / (kRowWarps * kUnitLanes * sizeof(T));
  // the ring, the staged input, the bitmaps (seen, then repeated)
  extern __shared__ __align__(128) uint8_t rows_buf[];
  __shared__ uint64_t full[kRowWarps * kStages];
  const int S = I_pad >> 3;
  const RowGrid grid(S, A, FOLD ? 0 : (int)gridDim.y);
  const size_t b = FOLD ? blockIdx.x / grid.per_stream : blockIdx.y;
  const int run = FOLD ? blockIdx.x - (int)(b * grid.per_stream)
                       : (int)blockIdx.x;
  const int u0 = run * grid.per;
  const int u1 = min(A * grid.tiles, u0 + grid.per);
  const int t_lo = u0 / A;
  const int n_xs = ((u1 - 1) / A - t_lo + 1) * kUnitBytes;
  T* ring = reinterpret_cast<T*>(rows_buf);
  uint8_t* xs = rows_buf + kRingBytes;
  uint32_t* seen = reinterpret_cast<uint32_t*>(
      xs + kXsTiles * kUnitBytes);
  uint32_t* repeated = seen + ((C + 31) >> 5);
  const int* cb = cols + b * A;
  const uint8_t* xb = bits + b * I;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the unit's tile and column (-1: an entry out of range)
  auto unit_col = [&](int u, int* tile) -> int {
    const int t = u / A, r = u - t * A;
    *tile = t;
    const int c = __ldg(cb + r);
    return c >= 0 && c < C ? c : -1;
  };
  // the warp's k-th unit (u0 + warp + k * kRowWarps) into its stage
  // k % kStages, where its entry is in range: one bulk copy of the row
  // where it is one tile, else one a slice
  const int n_mine = u0 + warp < u1 ? (u1 - u0 - warp - 1) / kRowWarps + 1
                                    : 0;
  auto fetch = [&](int k) {
    int t;
    const int c = unit_col(u0 + warp + k * kRowWarps, &t);
    if (c < 0 || lane != 0) return;
    const int s = k % kStages;
    T* dst = ring + (warp * kStages + s) * kUnitLanes;
    const T* src = perm + ((size_t)b * C + c) * I_pad + t * kUnitBytes;
    uint64_t* bar = full + warp * kStages + s;
    bar_expect(bar, kUnitLanes * sizeof(T));
    if (S == kUnitBytes) {
      bulk_load(dst, src, kUnitLanes * sizeof(T), bar);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bulk_load(dst + j * kUnitBytes, src + (size_t)j * S,
                  kUnitBytes * sizeof(T), bar);
    }
  };
  // each warp's stages, and its first units' copies in flight before the
  // block stages its input and marks its columns (a unit whose row an
  // earlier entry holds loads it too, and drops it)
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(full + warp * kStages + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  for (int k = 0; k < kStages && k < n_mine; ++k) fetch(k);

  if constexpr (BITMAP) {
    for (int i = threadIdx.x; i < 2 * ((C + 31) >> 5); i += kThreads)
      seen[i] = 0u;
  }
  // the input of the run's tiles, packed as the table is: bit j of byte w
  // is input j * S + w
  for (int w = threadIdx.x; w < n_xs; w += kThreads) {
    const int at = t_lo * kUnitBytes + w;
    unsigned byte = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long i = (long long)j * S + at;
      if (i < I) byte |= (xb[i] != 0 ? 1u : 0u) << j;
    }
    xs[w] = static_cast<uint8_t>(byte);
  }
  __syncthreads();
  if constexpr (BITMAP) {
    // every entry of the stream marks its column; a column marked twice
    // is repeated
    for (int a = threadIdx.x; a < A; a += kThreads) {
      const int c = __ldg(cb + a);
      if (c >= 0 && c < C) {
        const uint32_t bit = 1u << (c & 31);
        if (atomicOr(seen + (c >> 5), bit) & bit)
          atomicOr(repeated + (c >> 5), bit);
      }
    }
    __syncthreads();
  }
  // whether entry r's unit updates column c's row: c is not repeated, or
  // no earlier entry lists it. Every lane of the warp calls it.
  auto owns = [&](int r, int c) -> bool {
    if (BITMAP && !((repeated[c >> 5] >> (c & 31)) & 1u)) return true;
    bool earlier = false;
    for (int e = lane; e < r; e += 32) earlier |= __ldg(cb + e) == c;
    return !__any_sync(kAll, earlier);
  };

  uint32_t phase = 0;  // bit s: the parity stage s waits for
  for (int k = 0; k < n_mine; ++k) {
    const int s = k % kStages;
    const int u = u0 + warp + k * kRowWarps;
    int t;
    const int c = unit_col(u, &t);
    if (c >= 0) {
      bar_wait(full + warp * kStages + s, (phase >> s) & 1u);
      phase ^= 1u << s;
    }
    if (c >= 0 && owns(u - t * A, c)) {
      const T* st = ring + (warp * kStages + s) * kUnitLanes;
      const int w = 4 * lane;  // the lane's packed bytes in the tile
      const uint32_t x = *reinterpret_cast<const uint32_t*>(
          xs + (t - t_lo) * kUnitBytes + w);
      T* row = perm + ((size_t)b * C + c) * I_pad + t * kUnitBytes + w;
      uint32_t packed = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        Quad<T> q;
        q.v = *reinterpret_cast<const typename Quad<T>::V*>(
            st + j * kUnitBytes + w);
        const int lane0 = j * S + t * kUnitBytes + w;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const D d = lane0 + e >= I ? D(0)
                      : ((x >> (8 * e + j)) & 1u) ? d_on : d_off;
          bool conn;
          q[e] = op.add(q[e], d, &conn);
          packed |= static_cast<uint32_t>(conn) << (8 * e + j);
        }
        *reinterpret_cast<typename Quad<T>::V*>(row + (size_t)j * S) = q.v;
      }
      *reinterpret_cast<uint32_t*>(pack + ((size_t)b * C + c) * S +
                                   t * kUnitBytes + w) = packed;
    }
    __syncwarp();  // every lane is done with the stage
    if (k + kStages < n_mine) fetch(k + kStages);
  }
}

// The dynamic shared memory of sp_rows_kernel: the ring, the staged input
// and, on the bitmap path, two bitmaps of C bits.
inline size_t rows_smem(int C, bool bitmap) {
  return kRingBytes + kXsTiles * kUnitBytes +
         (bitmap ? 8 * (size_t)((C + 31) >> 5) : 0);
}

template <class Op>
int launch_rows(void* perm, uint8_t* pack, const uint8_t* bits,
                const int* cols, int B, int C, int I, int I_pad, int A,
                typename Op::D d_on, typename Op::D d_off, int fold, Op op,
                cudaStream_t stream) {
  const RowGrid g(I_pad / 8, A, fold ? 0 : B);
  auto* p = static_cast<typename Op::T*>(perm);
  const bool bitmap = C <= kBitmapCols;
  const size_t smem = rows_smem(C, bitmap);
  return bithtm::with_bool(fold != 0, [&](auto folded) {
    return bithtm::with_bool(bitmap, [&](auto bm) {
      constexpr bool kFold = decltype(folded)::value;
      auto kernel = sp_rows_kernel<Op, kFold, decltype(bm)::value>;
      if (int err = bithtm::allow_shared(kernel, smem)) return err;
      dim3 grid(g.per_stream, B);
      if constexpr (kFold) {
        const long long blocks = (long long)g.per_stream * B;
        if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
        grid = dim3((unsigned)blocks, 1);
      }
      kernel<<<grid, kThreads, smem, stream>>>(p, pack, bits, cols, C, I,
                                               I_pad, A, d_on, d_off, op);
      return (int)cudaGetLastError();
    });
  });
}

}  // namespace

// perm (B, C, I_pad) int16 (quantized) or float32, updated in place;
// delta (B, I_pad) int32 (quantized) or float32; cols (B, A) int32;
// pack (B, C, I_pad / 8) u8. I_pad is a multiple of 1024 and every
// pointer 16-byte aligned. col_bitmaps: null to stage the delta row and
// the active-column bitmap in shared memory (4 * I_pad + ceil(C / 32) * 4
// <= 232,448 bytes), else a scratch of B * ceil(C / 32) words that
// receives the streams' active-column bitmaps first (the GMEM path);
// fold != 0 puts the streams in grid x (B > 65,535). Launches on the
// given stream of the given device, allocates nothing and returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int sp_update_pack(void* perm, const void* delta, const int* cols,
                              uint32_t* col_bitmaps, uint8_t* pack, int B,
                              int C, int I_pad, int A, int quantized,
                              float threshold_f, int threshold_i, int fold,
                              int device, void* stream) {
  if (I_pad % 1024 != 0) return (int)cudaErrorInvalidValue;
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantized)
    return dispatch(perm, delta, cols, col_bitmaps, pack, B, C, I_pad, A,
                    fold, Int16Units{threshold_i}, s);
  return dispatch(perm, delta, cols, col_bitmaps, pack, B, C, I_pad, A, fold,
                  Float32{threshold_f}, s);
}

// perm (B, C, I_pad) int16 (quantized) or float32 and pack (B, C, I_pad /
// 8) u8, both updated in place at the active rows only; bits (B, I) bool
// (one byte each, 0 or 1), I <= I_pad; cols (B, A) int32, ids outside
// [0, C) skipped. d_on / d_off: the delta of an active / inactive input
// lane (int32 units where quantized, else float32), 0 on the padding
// lanes. I_pad is a multiple of 1024, perm and pack 16-byte aligned.
// fold != 0 puts the streams in grid x (B > 65,535). Launches on the
// given stream of the given device, allocates nothing and returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int sp_rows(void* perm, uint8_t* pack, const uint8_t* bits,
                       const int* cols, int B, int C, int I, int I_pad, int A,
                       int quantized, float on_f, float off_f,
                       float threshold_f, int on_i, int off_i,
                       int threshold_i, int fold, int device, void* stream) {
  if (B < 0 || C < 0 || A < 0 || I < 0 || I_pad <= 0 || I_pad % 1024 != 0 ||
      I > I_pad || (!fold && B > 65535) ||
      reinterpret_cast<uintptr_t>(perm) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(pack) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0 || C == 0) return 0;
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantized)
    return launch_rows(perm, pack, bits, cols, B, C, I, I_pad, A, on_i,
                       off_i, fold, Int16Units{threshold_i}, s);
  return launch_rows(perm, pack, bits, cols, B, C, I, I_pad, A, on_f, off_f,
                     fold, Float32{threshold_f}, s);
}
