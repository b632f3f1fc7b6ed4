// The spatial pooler's column selection of a step: boost, global top-A
// inhibition and the duty-cycle EMA, for NVIDIA Hopper (sm_90a).
//
// Stands for the JAX package's boost, k_winners and duty_cycle_update
// (bithtm_tpu/ops/regularization.py:20, :37, :28), which XLA fuses around
// a top_k. The TPU package has no Pallas kernel for them. Plain PyTorch
// version: bithtm_tpu_torch/ops/regularization.py (sp_select_ref: a float64
// exp, a stable descending sort of every column, a scatter for the mask
// and a float64 round-to-odd emulation of one FMA, some 35 launches).
//
// Per stream b, from the (C,) int32 overlaps ov and float32 duty cycles:
//   factor  = (float) exp((double) (scale * duty)),  scale = f32(-(i / d))
//   boosted = factor * (float) ov
//   cols    = the A largest boosted values, ties to the lower column, in
//             the order a stable descending sort gives (value down, then
//             column up); mask = those A columns
//   duty'   = fmaf(duty, momentum, mask ? 1 - momentum : 0), one rounding
// Both products, the float64 exp and the FMA round as the plain version's
// ops on the card round them (each product alone, never contracted), so
// every output is equal to the plain version's bit for bit.
//
// Bound: bytes. The overlaps and duty cycles read once, boosted and duty'
// written once (4 bytes a column each), the mask (1 byte a column) and the
// columns: 8.6 MB at the bench's B=256, C=2048 (0.0026 ms at the H100's
// 3.35 TB/s) and 17 MB at 16K x 64, B=64 (0.0051 ms). The float64 exps
// (some 30 operations a column) are far below the card's float64 rate.
//
// A column's pair (key, ~column), its key an order-preserving uint32 of
// its value (-0.0 keyed as +0.0), is distinct and orders the columns as
// the stable sort does, so the winners are the columns whose pair is at or
// above the A-th largest pair, the threshold (A = C: every column). It is
// found by an MSB-first radix select over the keys: 8-bit passes, each a
// 256-bin histogram (one shared atomic a key; adding once a distinct bin
// of a warp, found by __match_any_sync, measured slower) and a scan for
// the bin that holds the A-th key. The select stops where the bin wins whole (the threshold is the
// bin's lowest key), or where it holds few enough keys to rank: their
// pairs are gathered and the k-th largest is the threshold. Past four
// passes (more equal keys than that) it is the pair of the k-th lowest
// column among them. The winners' pairs are then listed in column order by
// a scan, and a winner's place in the output is
//   - up to kRankMax winners, the number of pairs above it (A^2 compares,
//     spread over the threads);
//   - past it, its place after a stable LSD radix sort of the list by key,
//     descending: at most four 8-bit passes over the A pairs (a pass whose
//     digit every key shares is skipped), each a per-warp histogram, one
//     scan, and a scatter in which the lanes of a warp that share a digit
//     take consecutive places (found by 9 ballots). The list starts in column
//     order and every pass is stable, so equal keys stay in column order.
//     The two lists live in shared memory up to kListBytes; past it in a
//     (B, 2A) global scratch, and a cluster of kSortBlocks blocks takes a
//     stream: the first selects and lists the winners, then each block
//     sorts a run of the list, the blocks' bin totals met in distributed
//     shared memory, one cluster barrier a pass.
// Two grids, chosen from the shapes:
//   - a warp a stream, up to kWarpsMax streams a block, where A <=
//     kWarpList and C <= kWarpCols (a block a stream leaves most of its
//     threads idle there): a lane holds the keys of columns lane,
//     lane + 32, ... in registers, the histograms are the warp's own and
//     no block barrier is taken; the winners are listed by ballots;
//   - a block a stream (the streams in grid x: any B): 256 threads up to
//     2,048 columns, else 1,024. Each thread owns a run of contiguous
//     columns: kKeys of them, their keys held in registers, read with
//     16-byte loads where C is a multiple of 4; past 16,384 columns every
//     1,024th column, its keys read again from the boosted values. Past
//     8,192 columns at up to kSplitStreams streams (16K's 64 leave half
//     the SMs idle), a cluster of two blocks a stream, 8 columns a
//     thread. What holds it back: the passes' block barriers, and the
//     count of places, A^2 compares, at 16K.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <algorithm>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 256;
constexpr int kMaxThreads = 1024;
constexpr unsigned kAll = 0xffffffffu;
// a warp a stream up to kWarpCols columns (kWarpKeys a lane) and
// kWarpList winners; up to kWarpsMax streams a block
constexpr int kWarpCols = 128;
constexpr int kWarpKeys = kWarpCols / 32;
constexpr int kWarpList = 64;
constexpr int kWarpsMax = 8;
// the winners' places by counting the pairs above each, up to kRankMax
// winners; past it by the LSD radix sort
constexpr int kRankMax = 512;
// the sort's two lists in shared memory while they take at most this
// many bytes (16 A); past it in global memory, sorted by a cluster of
// kSortBlocks blocks a stream
constexpr size_t kListBytes = 160 * 1024;
constexpr int kSortBlocks = 8;
// a cluster of kSplitBlocks blocks a stream, each with kKeys = 8 columns a
// thread, where C passes one block's 8,192 and the streams leave SMs idle
// (at most kSplitStreams) and the winners are placed by counting
constexpr int kSplitBlocks = 2;
constexpr int kSplitStreams = 132;

// Larger value, larger key; -0.0 keys as +0.0 (the sort finds them equal).
__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u << 1) == 0) u = 0;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float boost_one(int ov, float duty, float scale) {
  const float factor = (float)exp((double)__fmul_rn(scale, duty));
  return __fmul_rn(factor, (float)ov);
}

// The (key, ~column) pair of a column: distinct, and ordered as the
// stable descending sort orders the columns (value down, column up).
__device__ __forceinline__ unsigned long long pair_of(uint32_t key, int c) {
  return ((unsigned long long)key << 32) | (uint32_t)~c;
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

__device__ __forceinline__ unsigned long long shfl64(unsigned long long v,
                                                     int src) {
  const uint32_t lo = __shfl_sync(kAll, (uint32_t)v, src);
  const uint32_t hi = __shfl_sync(kAll, (uint32_t)(v >> 32), src);
  return ((unsigned long long)hi << 32) | lo;
}

// The lanes of the warp with `in` whose 8-bit `bin` equals this lane's
// (0 for a lane without `in`): one ballot a bit. Every lane of the warp
// calls it.
__device__ __forceinline__ unsigned peers_of(bool in, uint32_t bin) {
  unsigned peers = __ballot_sync(kAll, in);
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    const bool set = (bin >> bit) & 1u;
    const unsigned lanes = __ballot_sync(kAll, set);
    peers &= set ? lanes : ~lanes;
  }
  return in ? peers : 0u;
}

// In the histogram h, plus h2 where it is not null (every lane of a warp
// calls it): the bin that holds the k-th largest key (bins from the top, 8
// a lane), the rank k within it and its count, in every lane.
__device__ __forceinline__ int3 warp_find_bin(const int* h, const int* h2,
                                              int k) {
  const int lane = threadIdx.x & 31;
  int c[8], sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int bin = kBins - 1 - (8 * lane + j);
    c[j] = h[bin] + (h2 ? h2[bin] : 0);
    sum += c[j];
  }
  int inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(kAll, inc, o);
    if (lane >= o) inc += x;
  }
  int above = inc - sum;
  const bool mine = above < k && inc >= k;
  int3 r = make_int3(0, 0, 0);
  if (mine) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (above < k && above + c[j] >= k)
        r = make_int3(kBins - 1 - (8 * lane + j), k - above, c[j]);
      above += c[j];
    }
  }
  const int src = __ffs(__ballot_sync(kAll, mine)) - 1;
  return make_int3(__shfl_sync(kAll, r.x, src), __shfl_sync(kAll, r.y, src),
                   __shfl_sync(kAll, r.z, src));
}

struct Shared {
  int hist[2][kBins];
  unsigned long long cand[kMaxThreads];  // the bin's (key, ~column) pairs
  int warp_sums[kMaxThreads / 32];
  unsigned long long threshold;  // the A-th largest pair
  int sel[3];
  int n_cand;
  int n_list;                // kSplit: the first block's winners
  uint32_t key_and, key_or;  // over the winners' keys
  int eq_total;              // the block's keys equal to the prefix
  int bin_total[kBins];      // the sort's bin counts of the block
};

// A place in *counter's list for each lane of the warp with `take`, one
// atomic a warp; every lane of the warp calls it.
__device__ __forceinline__ int warp_append(bool take, int* counter) {
  const unsigned ballot = __ballot_sync(kAll, take);
  if (!ballot) return -1;
  const int lane = threadIdx.x & 31, leader = __ffs(ballot) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(ballot));
  base = __shfl_sync(kAll, base, leader);
  return take ? base + __popc(ballot & lanes_below()) : -1;
}

// The exclusive prefix sum of each thread's v, in thread order. Every
// thread calls it; it begins and ends with a block barrier.
__device__ int block_scan(int v, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(kAll, inc, o);
    if (lane >= o) inc += x;
  }
  __syncthreads();
  if (lane == 31) sh.warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? sh.warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kAll, s, o);
      if (lane >= o) s += x;
    }
    if (lane < warps) sh.warp_sums[lane] = s;
  }
  __syncthreads();
  return (warp ? sh.warp_sums[warp - 1] : 0) + inc - v;
}

// A barrier over the cluster's kCluster blocks (memory at cluster scope),
// or the block's.
template <int kCluster>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (kCluster > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// The n pairs at src (in column order) sorted stably by key, descending:
// LSD radix passes over the key's bytes, skipping the bytes where `diff`
// (the bits in which the keys differ) is 0. The kCluster blocks of a
// cluster take a run of the pairs each, and each warp of a block a run of
// whole 32-pair slots of it; counts holds a 256-bin histogram a warp, and
// a pass meets the blocks' bin totals in distributed shared memory. src
// and dst may lie in shared memory (kCluster = 1) or global memory. Every
// thread of the cluster calls it; returns the list that holds the result
// (src or dst).
template <int kCluster>
__device__ unsigned long long* lsd_sort(unsigned long long* src,
                                        unsigned long long* dst, int n,
                                        uint32_t diff, int* counts,
                                        Shared& sh) {
  constexpr int kBatch = 4;  // slots whose pairs are loaded together
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int rank = kCluster > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int per = (n + kCluster - 1) / kCluster;
  const int b_lo = min(n, rank * per), b_hi = min(n, b_lo + per);
  const int chunk = (b_hi - b_lo + 32 * warps - 1) / (32 * warps) * 32;
  const int lo = min(b_hi, b_lo + warp * chunk), hi = min(b_hi, lo + chunk);
  int* cnt = counts + warp * kBins;
  for (int shift = 0; shift < 32; shift += 8) {
    if (((diff >> shift) & 0xFFu) == 0) continue;
    const int key_shift = 32 + shift;
    for (int i = lane; i < kBins; i += 32) cnt[i] = 0;
    __syncwarp();
    // the warp's histogram
    for (int base = lo; base < hi; base += 32 * kBatch) {
      unsigned long long v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + 32 * u + lane;
        v[u] = i < hi ? src[i] : 0ull;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (base + 32 * u + lane < hi)
          atomicAdd(cnt + 255 - (int)((v[u] >> key_shift) & 0xFFu), 1);
      }
    }
    // the block's bin totals, then each (bin, warp) entry's first place:
    // the bins before it over the cluster, the bin in the blocks before
    // this one, and in the warps before this one
    __syncthreads();
    const int bin = threadIdx.x;
    if (bin < kBins) {
      int total = 0;
      for (int w = 0; w < warps; ++w) total += counts[w * kBins + bin];
      sh.bin_total[bin] = total;
    }
    cluster_sync<kCluster>();
    int total = 0, before = 0;
    if (bin < kBins) {
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        int v;
        if constexpr (kCluster > 1) {
          v = cg::this_cluster().map_shared_rank(sh.bin_total, r)[bin];
        } else {
          v = sh.bin_total[bin];
        }
        total += v;
        if (r < rank) before += v;
      }
    }
    int run = block_scan(bin < kBins ? total : 0, sh) + before;
    if (bin < kBins) {
      for (int w = 0; w < warps; ++w) {
        const int c = counts[w * kBins + bin];
        counts[w * kBins + bin] = run;
        run += c;
      }
    }
    __syncthreads();
    // the scatter: lanes with one digit take consecutive places, in lane
    // order, after the warp's earlier slots
    for (int base = lo; base < hi; base += 32 * kBatch) {
      unsigned long long v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + 32 * u + lane;
        v[u] = i < hi ? src[i] : 0ull;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool in = base + 32 * u + lane < hi;
        const uint32_t b = 255 - (uint32_t)((v[u] >> key_shift) & 0xFFu);
        const unsigned peers = peers_of(in, b);
        if (in) dst[cnt[b] + __popc(peers & lanes_below())] = v[u];
        __syncwarp();
        if (in && lane == __ffs(peers) - 1) cnt[b] += __popc(peers);
        __syncwarp();
      }
    }
    cluster_sync<kCluster>();  // dst whole, the totals read
    unsigned long long* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

// f(i) for each of a thread's n columns: unrolled over kKeys where the
// keys sit in registers (kKeys > 0), a loop over n otherwise.
template <int kKeys, class F>
__device__ __forceinline__ void for_keys(int n, F&& f) {
  if constexpr (kKeys > 0) {
#pragma unroll
    for (int i = 0; i < kKeys; ++i) f(i);
  } else {
    for (int i = 0; i < n; ++i) f(i);
  }
}

struct Select {
  const int* ov;
  const float* duty;
  float* boosted;
  int* cols;
  uint8_t* mask;
  float* duty_out;
  unsigned long long* list;  // a (B, 2A) global scratch, or null
  int C, A;
  float scale, momentum, one_minus;
};

// A block a stream, or a cluster of kCluster blocks a stream: with kSplit
// the blocks take a run of kThreads * kKeys columns each and select
// together (their histograms and candidates met in distributed shared
// memory), each block listing the winners in both blocks' lists and
// placing every other one; without it
// the first block selects and lists the winners and the blocks then sort
// the list together (the lists in global memory). kThreads a block;
// kKeys: the columns a thread, keys in registers (0: any run, keys read
// again from `boosted`); kVec: 16-byte loads and stores (C % 4 == 0).
template <int kThreads, int kKeys, bool kVec, int kCluster, bool kSplit>
__global__ void __launch_bounds__(kThreads) sp_select_kernel(const Select p) {
  // the winners' list (and the sort's second list) where they are not in
  // global memory, then the sort's histograms
  extern __shared__ unsigned long long dyn[];
  __shared__ Shared sh;
  const int* __restrict__ ov = p.ov;
  const float* __restrict__ duty = p.duty;
  float* boosted = p.boosted;
  uint8_t* __restrict__ mask = p.mask;
  float* __restrict__ duty_out = p.duty_out;
  const int C = p.C, A = p.A;
  const float scale = p.scale, momentum = p.momentum,
              one_minus = p.one_minus;
  const int n = kKeys > 0 ? kKeys : (C + kThreads - 1) / kThreads;
  const int rank = kCluster > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int c0 = (kSplit ? rank * kThreads * n : 0) + threadIdx.x * n;
  const size_t stream = blockIdx.x / kCluster;
  // the other block's copy of a shared variable (kSplit)
  auto peer = [&](auto* ptr) {
    return cg::this_cluster().map_shared_rank(ptr, rank ^ 1);
  };
  const size_t row = stream * C;
  const bool lsd = A > kRankMax;
  unsigned long long* list =
      p.list ? p.list + stream * 2 * A : dyn;
  int* counts = reinterpret_cast<int*>(
      p.list ? dyn : dyn + (lsd ? 2 * A : A));
  uint32_t key[kKeys > 0 ? kKeys : 1];
  // a thread's i-th column: a run of kKeys where the keys sit in
  // registers, else every kThreads-th (coalesced)
  auto col = [&](int i) -> int {
    if constexpr (kKeys > 0) {
      return c0 + i;
    } else {
      return (int)threadIdx.x + i * kThreads;
    }
  };

  // every block with kSplit, else the first block of a cluster
  if (kSplit || rank == 0) {
    for (int i = threadIdx.x; i < 2 * kBins; i += kThreads)
      (&sh.hist[0][0])[i] = 0;
    if (threadIdx.x == 0) {
      sh.n_cand = 0;
      sh.threshold = 0;  // A = C: every pair
      sh.key_and = ~0u;
      sh.key_or = 0;
    }

    // the boost, the boosted values written and keyed
    if constexpr (kKeys > 0 && kVec) {
#pragma unroll
      for (int i = 0; i < kKeys; i += 4) {
        const int c = c0 + i;
        if (c < C) {
          const int4 o = __ldg(reinterpret_cast<const int4*>(ov + row + c));
          const float4 d =
              __ldg(reinterpret_cast<const float4*>(duty + row + c));
          const float4 v =
              make_float4(boost_one(o.x, d.x, scale),
                          boost_one(o.y, d.y, scale),
                          boost_one(o.z, d.z, scale),
                          boost_one(o.w, d.w, scale));
          *reinterpret_cast<float4*>(boosted + row + c) = v;
          key[i] = order_key(v.x);
          key[i + 1] = order_key(v.y);
          key[i + 2] = order_key(v.z);
          key[i + 3] = order_key(v.w);
        }
      }
    } else {
      for_keys<kKeys>(n, [&](int i) {
        const int c = col(i);
        if (c < C) {
          const float v = boost_one(__ldg(ov + row + c), __ldg(duty + row + c),
                                    scale);
          boosted[row + c] = v;
          if constexpr (kKeys > 0) key[i] = order_key(v);
        }
      });
    }
    // column c's key, past the registers (the thread's own columns before
    // the next barrier, any column after it)
    auto key_of = [&](int c) -> uint32_t {
      return order_key(boosted[row + c]);
    };
    // the key of the thread's i-th column
    auto key_at = [&](int i) -> uint32_t {
      if constexpr (kKeys > 0) {
        return key[i];
      } else {
        return key_of(col(i));
      }
    };
    cluster_sync<kSplit ? kCluster : 1>();  // histograms, counters zero

    // the radix select of the A-th largest pair, the threshold: the keys
    // with (key & pmask) == prefix hold it, as the k-th largest of theirs
    if (A > 0 && A < C) {
      uint32_t prefix = 0, pmask = 0;
      int k = A;
      for (int pass = 0; pass < 4; ++pass) {
        const int shift = 24 - 8 * pass;
        int* h = sh.hist[pass & 1];
        for_keys<kKeys>(n, [&](int i) {
          if (col(i) < C) {
            const uint32_t kk = key_at(i);
            if ((kk & pmask) == prefix)
              atomicAdd(h + ((kk >> shift) & 0xFFu), 1);
          }
        });
        cluster_sync<kSplit ? kCluster : 1>();
        if (threadIdx.x < 32) {
          const int3 s = warp_find_bin(h, kSplit ? peer(h) : nullptr, k);
          int* other = sh.hist[(pass + 1) & 1];
          for (int j = threadIdx.x; j < kBins; j += 32) other[j] = 0;
          if (threadIdx.x == 0) {
            sh.sel[0] = s.x;
            sh.sel[1] = s.y;
            sh.sel[2] = s.z;
          }
        }
        __syncthreads();
        prefix |= (uint32_t)sh.sel[0] << shift;
        pmask |= 0xFFu << shift;
        k = sh.sel[1];
        const int count = sh.sel[2];
        if (count == k) {
          // the whole bin wins: every key from its lowest up
          if (threadIdx.x == 0)
            sh.threshold = (unsigned long long)prefix << 32;
          break;
        }
        if (count <= kThreads) {
          // few enough to rank: the bin's pairs, the k-th largest of them
          for_keys<kKeys>(n, [&](int i) {
            const int c = col(i);
            const uint32_t kk = c < C ? key_at(i) : 0u;
            const bool in = c < C && (kk & pmask) == prefix;
            const int at = warp_append(in, &sh.n_cand);
            if (in) sh.cand[at] = pair_of(kk, c);
          });
          cluster_sync<kSplit ? kCluster : 1>();
          const int own = kSplit ? sh.n_cand : count;
          if ((int)threadIdx.x < own) {
            const unsigned long long pair = sh.cand[threadIdx.x];
            int r = 0;
            for (int j = 0; j < own; ++j) r += sh.cand[j] > pair;
            if constexpr (kSplit) {
              const Shared* o = peer(&sh);
              for (int j = 0; j < o->n_cand; ++j) r += o->cand[j] > pair;
            }
            if (r == k - 1) {
              sh.threshold = pair;
              if constexpr (kSplit) peer(&sh)->threshold = pair;
            }
          }
          break;
        }
        if (pass == 3) {
          // more than a block of equal keys: the k-th lowest column of them
          if constexpr (kKeys > 0) {
            int n_eq = 0;
            for_keys<kKeys>(n, [&](int i) {
              n_eq += c0 + i < C && key_at(i) == prefix;
            });
            int seen = block_scan(n_eq, sh);
            if constexpr (kSplit) {
              // after the first block's equal keys
              if (threadIdx.x == 0)
                sh.eq_total = sh.warp_sums[kThreads / 32 - 1];
              cluster_sync<kCluster>();
              if (rank) seen += peer(&sh)->eq_total;
            }
            if (seen < k && seen + n_eq >= k) {
              for_keys<kKeys>(n, [&](int i) {
                if (c0 + i < C && key_at(i) == prefix && ++seen == k) {
                  sh.threshold = pair_of(prefix, c0 + i);
                  if constexpr (kSplit) peer(&sh)->threshold = sh.threshold;
                }
              });
            }
          } else {
            // the columns in order, kThreads at a time
            int seen = 0;
            for (int i = 0; i < n; ++i) {
              const int c = col(i);
              const int eq = c < C && key_at(i) == prefix;
              const int before = block_scan(eq, sh);
              if (eq && seen + before + 1 == k)
                sh.threshold = pair_of(prefix, c);
              seen += sh.warp_sums[kThreads / 32 - 1];
            }
          }
        }
      }
    }
    cluster_sync<kSplit ? kCluster : 1>();  // the threshold is set

    // the winners (their pairs at or above the threshold): the list (in
    // column order for the sort), the mask and duty'
    const unsigned long long threshold = sh.threshold;
    // the winners' keys' AND and OR, for the sort's passes
    auto keys_seen = [&](uint32_t k_and, uint32_t k_or) {
      k_and = __reduce_and_sync(kAll, k_and);
      k_or = __reduce_or_sync(kAll, k_or);
      if ((threadIdx.x & 31) == 0) {
        atomicAnd(&sh.key_and, k_and);
        atomicOr(&sh.key_or, k_or);
      }
    };
    if constexpr (kKeys == 0) {
      // a warp a run of whole 32-column slots: a ballot a slot, the runs'
      // counts scanned, coalesced writes
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      const int chunk = (C + kThreads - 1) / kThreads * 32;
      const int lo = min(C, warp * chunk), hi = min(C, lo + chunk);
      auto won = [&](int c) -> bool {
        return A > 0 && c < hi && pair_of(key_of(c), c) >= threshold;
      };
      int mine = 0;
      uint32_t k_and = ~0u, k_or = 0u;
      for (int base = lo; base < hi; base += 32) {
        const int c = base + lane;
        const bool w = won(c);
        mine += __popc(__ballot_sync(kAll, w));
        if (w) {
          k_and &= key_of(c);
          k_or |= key_of(c);
        }
      }
      if (lsd) keys_seen(k_and, k_or);
      int at = __shfl_sync(kAll, block_scan(lane == 0 ? mine : 0, sh), 0);
      for (int base = lo; base < hi; base += 32) {
        const int c = base + lane;
        const bool w = won(c);
        const unsigned ballot = __ballot_sync(kAll, w);
        if (w)
          list[at + __popc(ballot & lanes_below())] = pair_of(key_of(c), c);
        at += __popc(ballot);
        if (c < hi) {
          mask[row + c] = w;
          duty_out[row + c] =
              __fmaf_rn(__ldg(duty + row + c), momentum, w ? one_minus : 0.0f);
        }
      }
    } else {
      auto won = [&](int i) -> bool {
        return A > 0 && c0 + i < C && pair_of(key[i], c0 + i) >= threshold;
      };
      // the list in column order: a thread's run after the runs before
      // it (with kSplit the second block's after the first's, in both
      // blocks' lists)
      int n_won = 0;
      uint32_t k_and = ~0u, k_or = 0u;
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        if (won(i)) {
          ++n_won;
          k_and &= key[i];
          k_or |= key[i];
        }
      }
      if (lsd) keys_seen(k_and, k_or);
      int at = block_scan(n_won, sh);
      unsigned long long* peer_list = nullptr;
      if constexpr (kSplit) {
        if (threadIdx.x == 0) sh.n_list = sh.warp_sums[kThreads / 32 - 1];
        cluster_sync<kCluster>();
        if (rank) at += peer(&sh)->n_list;
        peer_list = peer(list);
      }
      auto append = [&](bool w, int i) {
        if (w) {
          const unsigned long long pair = pair_of(key[i], c0 + i);
          list[at] = pair;
          if constexpr (kSplit) peer_list[at] = pair;
          ++at;
        }
      };
      if constexpr (kVec) {
#pragma unroll
        for (int i = 0; i < kKeys; i += 4) {
          const int c = c0 + i;
          const bool w0 = won(i), w1 = won(i + 1), w2 = won(i + 2),
                     w3 = won(i + 3);
          append(w0, i);
          append(w1, i + 1);
          append(w2, i + 2);
          append(w3, i + 3);
          if (c < C) {
            const float4 d =
                __ldg(reinterpret_cast<const float4*>(duty + row + c));
            *reinterpret_cast<float4*>(duty_out + row + c) = make_float4(
                __fmaf_rn(d.x, momentum, w0 ? one_minus : 0.0f),
                __fmaf_rn(d.y, momentum, w1 ? one_minus : 0.0f),
                __fmaf_rn(d.z, momentum, w2 ? one_minus : 0.0f),
                __fmaf_rn(d.w, momentum, w3 ? one_minus : 0.0f));
            *reinterpret_cast<uchar4*>(mask + row + c) =
                make_uchar4(w0, w1, w2, w3);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kKeys; ++i) {
          const int c = c0 + i;
          const bool w = won(i);
          append(w, i);
          if (c < C) {
            mask[row + c] = w;
            duty_out[row + c] = __fmaf_rn(__ldg(duty + row + c), momentum,
                                          w ? one_minus : 0.0f);
          }
        }
      }
    }
    cluster_sync<kSplit ? kCluster : 1>();  // the list is whole
  }

  int* out = p.cols + stream * A;
  if (lsd) {
    uint32_t diff;
    if constexpr (kCluster > 1) {
      cg::this_cluster().sync();  // the first block's list
      const Shared* first = cg::this_cluster().map_shared_rank(&sh, 0);
      diff = first->key_and ^ first->key_or;
      cg::this_cluster().sync();  // read before it may leave
    } else {
      diff = sh.key_and ^ sh.key_or;
    }
    const unsigned long long* sorted =
        lsd_sort<kCluster>(list, list + A, A, diff, counts, sh);
    const int per = (A + kCluster - 1) / kCluster;
    for (int i = rank * per + threadIdx.x; i < min(A, (rank + 1) * per);
         i += kThreads)
      out[i] = (int)~(uint32_t)sorted[i];
    return;
  }
  // a winner's place: the pairs above it, counted by `parts` threads a
  // winner (in `place`, the pairs' buffer, free now); with kSplit each
  // block places every other winner
  int* place = reinterpret_cast<int*>(sh.cand);
  const int step = kSplit ? kCluster : 1, first = kSplit ? rank : 0;
  const int m = A > first ? (A - first + step - 1) / step : 0;
  const int parts = m > 0 && m <= kThreads ? kThreads / m : 1;
  if (parts > 1) {
    if ((int)threadIdx.x < m) place[threadIdx.x] = 0;
    __syncthreads();
    const int k = threadIdx.x / parts, part = threadIdx.x % parts;
    if (k < m) {
      const unsigned long long pair = list[first + k * step];
      int r = 0;
#pragma unroll 4
      for (int j = part; j < A; j += parts) r += list[j] > pair;
      atomicAdd(place + k, r);
    }
    __syncthreads();
    if ((int)threadIdx.x < m)
      out[place[threadIdx.x]] =
          (int)~(uint32_t)list[first + threadIdx.x * step];
    return;
  }
  for (int k = threadIdx.x; k < m; k += kThreads) {
    const unsigned long long pair = list[first + k * step];
    int r = 0;
#pragma unroll 4
    for (int j = 0; j < A; ++j) r += list[j] > pair;
    out[r] = (int)~(uint32_t)pair;
  }
}

// A warp's own histogram, candidates and winners' list.
struct WarpShared {
  int hist[kBins];
  unsigned long long cand[32];
  unsigned long long list[kWarpList];
};

// A warp a stream: stream blockIdx.x * warps + warp, up to B. Lane l
// holds the keys of columns l, l + 32, ..., so a slot of 32 columns is one
// coalesced load and one ballot; no block barrier.
__global__ void __launch_bounds__(kWarpsMax * 32)
    sp_select_warp_kernel(const Select p, int B) {
  __shared__ WarpShared shared[kWarpsMax];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  WarpShared& w = shared[warp];
  const int C = p.C, A = p.A;
  const size_t row = (size_t)b * C;
  uint32_t key[kWarpKeys];
  float dty[kWarpKeys];
#pragma unroll
  for (int i = 0; i < kWarpKeys; ++i) {
    const int c = 32 * i + lane;
    key[i] = 0;
    dty[i] = 0.0f;
    if (c < C) {
      dty[i] = __ldg(p.duty + row + c);
      const float v = boost_one(__ldg(p.ov + row + c), dty[i], p.scale);
      p.boosted[row + c] = v;
      key[i] = order_key(v);
    }
  }

  unsigned long long threshold = 0;  // A = C: every pair
  if (A > 0 && A < C) {
    uint32_t prefix = 0, pmask = 0;
    int k = A;
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      for (int j = lane; j < kBins; j += 32) w.hist[j] = 0;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kWarpKeys; ++i) {
        if (32 * i + lane < C && (key[i] & pmask) == prefix)
          atomicAdd(w.hist + ((key[i] >> shift) & 0xFFu), 1);
      }
      __syncwarp();
      const int3 s = warp_find_bin(w.hist, nullptr, k);
      prefix |= (uint32_t)s.x << shift;
      pmask |= 0xFFu << shift;
      k = s.y;
      if (s.z == k) {
        threshold = (unsigned long long)prefix << 32;
        break;
      }
      if (s.z <= 32) {
        // the bin's pairs, one a lane: the k-th largest of them
        int at = 0;
#pragma unroll
        for (int i = 0; i < kWarpKeys; ++i) {
          if (32 * i < C) {
            const int c = 32 * i + lane;
            const bool in = c < C && (key[i] & pmask) == prefix;
            const unsigned ballot = __ballot_sync(kAll, in);
            if (in) w.cand[at + __popc(ballot & lanes_below())] =
                pair_of(key[i], c);
            at += __popc(ballot);
          }
        }
        __syncwarp();
        unsigned long long pair = 0;
        int r = -1;
        if (lane < s.z) {
          pair = w.cand[lane];
          r = 0;
          for (int j = 0; j < s.z; ++j) r += w.cand[j] > pair;
        }
        threshold = shfl64(pair, __ffs(__ballot_sync(kAll, r == k - 1)) - 1);
        break;
      }
      if (pass == 3) {
        // more than 32 equal keys: the k-th lowest column of them
        int seen = 0;
#pragma unroll
        for (int i = 0; i < kWarpKeys; ++i) {
          if (32 * i < C) {
            const unsigned eq = __ballot_sync(
                kAll, 32 * i + lane < C && key[i] == prefix);
            if (seen < k && seen + __popc(eq) >= k) {
              unsigned e = eq;  // its (k - seen)-th lane
              for (int t = seen + 1; t < k; ++t) e &= e - 1;
              threshold = pair_of(prefix, 32 * i + __ffs(e) - 1);
            }
            seen += __popc(eq);
          }
        }
      }
    }
  }

  // the winners in column order, the mask and duty'
  int at = 0;
#pragma unroll
  for (int i = 0; i < kWarpKeys; ++i) {
    if (32 * i < C) {
      const int c = 32 * i + lane;
      const bool won = A > 0 && c < C && pair_of(key[i], c) >= threshold;
      const unsigned ballot = __ballot_sync(kAll, won);
      if (won) w.list[at + __popc(ballot & lanes_below())] = pair_of(key[i], c);
      at += __popc(ballot);
      if (c < C) {
        p.mask[row + c] = won;
        p.duty_out[row + c] =
            __fmaf_rn(dty[i], p.momentum, won ? p.one_minus : 0.0f);
      }
    }
  }
  __syncwarp();
  // a winner's place: the pairs above it
  int* out = p.cols + (size_t)b * A;
  for (int i = lane; i < A; i += 32) {
    const unsigned long long pair = w.list[i];
    int r = 0;
    for (int j = 0; j < A; ++j) r += w.list[j] > pair;
    out[r] = (int)~(uint32_t)pair;
  }
}

// A block a stream; with `split` a cluster of kSplitBlocks blocks a
// stream that select together; where the lists are in global memory
// (p.list) a cluster of kSortBlocks blocks a stream that sort together.
template <int kThreads, int kKeys, bool kSplit = false>
int launch(const Select& p, int B, size_t smem, cudaStream_t s) {
  return bithtm::with_bool(kKeys > 0 && p.C % 4 == 0, [&](auto vec) {
    return bithtm::with_bool(p.list != nullptr, [&](auto clustered) {
      constexpr int kCluster = kSplit ? kSplitBlocks
                               : decltype(clustered)::value ? kSortBlocks
                                                            : 1;
      auto kernel = sp_select_kernel<kThreads, kKeys, decltype(vec)::value,
                                     kCluster, kSplit>;
      // past 48 KB with the static Shared: allowed at least 48 KB + 1
      if (smem + sizeof(Shared) > 48 * 1024)
        if (int err = bithtm::allow_shared(
                kernel, std::max(smem, (size_t)48 * 1024 + 1)))
          return err;
      if constexpr (kCluster == 1) {
        kernel<<<B, kThreads, smem, s>>>(p);
        return (int)cudaGetLastError();
      } else {
        cudaLaunchConfig_t config = {};
        config.gridDim = dim3((unsigned)B * kCluster);
        config.blockDim = dim3(kThreads);
        config.dynamicSmemBytes = smem;
        config.stream = s;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = kCluster;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        config.attrs = attr;
        config.numAttrs = 1;
        if (int err = (int)cudaLaunchKernelEx(&config, kernel, p)) return err;
        return (int)cudaGetLastError();
      }
    });
  });
}

}  // namespace

// ov (B, C) int32 and duty (B, C) float32, 16-byte aligned; outputs
// boosted (B, C) float32 and duty_out (B, C) float32, 16-byte aligned,
// cols (B, A) int32 and mask (B, C) bool (0 or 1). list: a (B, 2A) int64
// scratch for the winners' pairs, or null to keep them in shared memory
// (refused where the sort's two lists pass kListBytes). 0 <= A <= C.
// scale = f32(-(intensity / density)), momentum and one_minus =
// f32(1 - momentum). The grid from the shapes: a warp a stream where
// A <= 64 and C <= 128, else a block a stream (ops/kernels.py
// _select_path).
// Launches on the given stream of the given device, allocates nothing and
// returns cudaGetLastError() after the launch (0 = success).
extern "C" int sp_select(const int* ov, const float* duty, float* boosted,
                         int* cols, void* mask, float* duty_out,
                         unsigned long long* list, int B, int C, int A,
                         float scale, float momentum, float one_minus,
                         int device, void* stream) {
  if (B < 0 || C < 0 || A < 0 || A > C ||
      reinterpret_cast<uintptr_t>(ov) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(duty) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(boosted) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(duty_out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return 0;
  const bool warp = A <= kWarpList && C <= kWarpCols;
  const int threads = C <= 256 * 8 ? 256 : kMaxThreads;
  const bool lsd = A > kRankMax;
  const size_t counts = lsd ? sizeof(int) * kBins * (threads / 32) : 0;
  const size_t lists = list ? 0 : (lsd ? 16 : 8) * (size_t)A;
  const size_t smem = lists + counts;
  const Select p{ov, duty, boosted, cols, static_cast<uint8_t*>(mask),
                 duty_out, list, C, A, scale, momentum, one_minus};
  if (!warp && ((!list && lsd && lists > kListBytes) ||
                smem + sizeof(Shared) > bithtm::kMaxShared))
    return (int)cudaErrorInvalidValue;
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (warp) {
    // at least two blocks an SM where the streams allow
    const int fill = 2 * std::max(1, bithtm::sm_count());
    const int warps = std::min(kWarpsMax, std::max(1, B / fill));
    sp_select_warp_kernel<<<(B + warps - 1) / warps, 32 * warps, 0, s>>>(p,
                                                                         B);
    return (int)cudaGetLastError();
  }
  if (C <= 256 * 8) return launch<256, 8>(p, B, smem, s);
  if (C <= kMaxThreads * 8) return launch<kMaxThreads, 8>(p, B, smem, s);
  if (C <= kSplitBlocks * kMaxThreads * 8 && B <= kSplitStreams && !lsd)
    return launch<kMaxThreads, 8, true>(p, B, smem, s);
  if (C <= kMaxThreads * 16) return launch<kMaxThreads, 16>(p, B, smem, s);
  return launch<kMaxThreads, 0>(p, B, smem, s);
}
