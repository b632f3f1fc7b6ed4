// Per-segment count decode of the packed activity, for NVIDIA Hopper
// (sm_90a).
//
// Stands for the JAX package's seg_counts_packed
// (bithtm_tpu/ops/active_set.py:588), an s8 matrix product against the
// segment matrix and an exact decode, which XLA fuses after the table
// pass. The TPU package has no Pallas kernel for it. Plain PyTorch
// version: bithtm_tpu_torch/ops/active_set.py (seg_counts_packed_ref),
// which widens the whole activity to int32 before it sums.
//
// Per segment s of the (B, C, G*K) packed activity (v = act + scale*conn,
// 0, 1 or 1 + scale, as the table kernels write it: u8 up to K=125, bf16
// at 126-127, float32 above; ops/active_set.py act_scale, act_dtype):
//   r = sum of the segment's K values
//   connected[s] = r / scale,  potential[s] = r - scale * connected[s]
// in int32 (B, C, G). Both counts are at most K < scale, so the decode is
// exact; the scale need not be a power of two (act_scale(64) = 65), so the
// division is an integer one. bf16 and float32 values are exact small
// integers and are converted before they are summed.
//
// Bound: bytes. The activity is read once and the two counts written
// once: at the bench's B=256, C=2048, G=4, K=64 that is 134 MB + 2 x 8.4
// MB, about 0.045 ms at the H100's 3.35 TB/s; at 16K x 64, B=64, twice
// that (268 MB + 2 x 16.8 MB, about 0.090 ms). The sums are a few integer
// operations a byte.
//
// Design. A segment's K values are read in chunks: 16-byte vectors where
// the segment's bytes are a multiple of 16 (every segment then starts
// aligned, since the wrapper requires a 16-byte aligned table), else the
// aligned 4-byte words that hold it, with its neighbours' bytes masked off
// at both ends (so K=125 u8 or K=127 bf16 reads words, not single values;
// the table's last word lies in the page of its last byte, so a read past
// the table's end never faults). L lanes take a segment, L the power of
// two that covers its chunks (at most 32), so a warp reads 32 / L
// neighbouring segments as one contiguous run (at K=64 u8: four lanes a
// segment, 512 bytes a warp load). A u8 chunk is summed four bytes at a
// time with __dp4a against 0x01010101. Each warp takes kUnroll runs and,
// where a segment has no more chunks than lanes (kOne), issues all their
// loads before it sums, so that kUnroll chunks a thread are in flight (2
// took less time on the H100 than 4 or 8). A segment's partial sums meet
// in log2(L) __shfl_xor_sync steps and its first lane decodes and stores
// both counts. The grid strides over the segments, so B has no limit.
//
// The flags form (seg_cell given) stands also for the thresholds and
// prediction_words (bithtm_tpu/ops/active_set.py:108) and pack_bits
// of the matching flags (:85), which the step ran as torch ops after the
// decode: potential >= theta_m gives bit g of the column's matching word,
// and a matching segment with connected >= theta_a sets its owner cell's
// bit in the prediction words. The segments' first lanes read the owners
// with the activity. Where a column's G segments (a power of two) share
// a warp run (K=64 u8: 4 lanes a segment, 8 segments a run, two columns
// at G=4) the iterations are the count kernel's and the column's bits
// meet by log2(G) shuffles, with nothing between the loads and the
// stores but the sums, the shuffles and a product for the stream of a
// column's prediction words (none at one word a column: a 64-bit
// division there was an eighth of the kernel's time at the bench, and
// words 0 and 1 shuffled side by side took an eighth off at 16K x 64);
// elsewhere (G=3, or G past the run at large K) a warp takes whole
// columns an iteration, each segment's matching bit and predicted cell
// meet in shared memory and one lane a column ORs them into its words.
// The flags form writes no counts: its bound is the activity and seg_cell
// read once and the (B, C) + (B, W, C) words written once.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;
constexpr long long kMaxBlocks = 1 << 22;
// a warp's segments of a flags iteration: max(slots, G), G <= 32
constexpr int kFlagSlots = 32 * kUnroll;

// The sum of the values of one 32-bit word of ELEM-byte values.
template <int ELEM>
__device__ __forceinline__ int word_sum(unsigned w) {
  if constexpr (ELEM == 1) {
    return static_cast<int>(__dp4a(w, 0x01010101u, 0u));
  } else if constexpr (ELEM == 2) {  // two bf16: the high half of a float
    return static_cast<int>(__uint_as_float(w << 16)) +
           static_cast<int>(__uint_as_float(w & 0xffff0000u));
  } else {
    return static_cast<int>(__uint_as_float(w));
  }
}

// A segment of the activity read as 16-byte vectors (kVec: its bytes are
// a multiple of 16) or as the 4-byte words that hold it, the bytes of its
// neighbours masked off at both ends.
template <int ELEM, bool kVec>
struct Segment {
  using Chunk = typename std::conditional<kVec, uint4, unsigned>::type;
  long long bytes0, bytes1;  // the segment's bytes [bytes0, bytes1)
  long long start, end;      // its chunks [start, end)

  __device__ __forceinline__ Segment(long long seg, int seg_bytes)
      : bytes0(seg * seg_bytes), bytes1(bytes0 + seg_bytes),
        start(bytes0 / (kVec ? 16 : 4)),
        end(kVec ? bytes1 / 16 : (bytes1 + 3) / 4) {}
  __device__ __forceinline__ bool has(int k) const { return start + k < end; }
  __device__ __forceinline__ Chunk load(const uint8_t* v, int k) const {
    return __ldg(reinterpret_cast<const Chunk*>(v) + start + k);
  }
  __device__ __forceinline__ int sum(Chunk c, int k) const {
    if constexpr (kVec) {
      return word_sum<ELEM>(c.x) + word_sum<ELEM>(c.y) + word_sum<ELEM>(c.z) +
             word_sum<ELEM>(c.w);
    } else {
      const long long b = 4 * (start + k);
      const long long lo = bytes0 - b, hi = bytes1 - b;  // kept: [lo, hi)
      unsigned mask = 0xffffffffu;
      if (lo > 0) mask &= 0xffffffffu << (8 * lo);        // lo in 1..3
      if (hi < 4) mask &= 0xffffffffu >> (8 * (4 - hi));  // hi in 1..3
      return word_sum<ELEM>(c & mask);
    }
  }
};

// The sums of the kUnroll segments seg[u] of the calling lanes, over the
// L = 2^lanes_log2 lanes of each (lane sub of them), reduced across those
// lanes (every lane of the warp calls it; a segment >= nseg sums 0).
template <int ELEM, bool kVec, bool kOne>
__device__ __forceinline__ void segment_sums(const uint8_t* v,
                                             const long long (&seg)[kUnroll],
                                             long long nseg, int seg_bytes,
                                             int sub, int L,
                                             int (&acc)[kUnroll]) {
  using Seg = Segment<ELEM, kVec>;
  if constexpr (kOne) {  // a chunk a lane at most: every load first
    typename Seg::Chunk c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const Seg s(seg[u], seg_bytes);
      c[u] = seg[u] < nseg && s.has(sub) ? s.load(v, sub)
                                         : typename Seg::Chunk{};
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      acc[u] = Seg(seg[u], seg_bytes).sum(c[u], sub);
  } else {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc[u] = 0;
      const Seg s(seg[u], seg_bytes);
      if (seg[u] < nseg)
        for (int k = sub; s.has(k); k += L) acc[u] += s.sum(s.load(v, k), k);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    for (int o = L / 2; o > 0; o /= 2)
      acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
}

template <int ELEM, bool kVec, bool kOne>
__global__ void __launch_bounds__(kThreads) seg_counts_kernel(
    const uint8_t* __restrict__ v, int* __restrict__ potential,
    int* __restrict__ connected, long long nseg, int seg_bytes,
    int lanes_log2, int scale) {
  const int L = 1 << lanes_log2;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (L - 1);
  const int per_warp = 32 >> lanes_log2;   // segments a warp run
  const long long warp =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * kThreads) >> 5;
  const long long run = (long long)per_warp * kUnroll;
  // base is the same for every lane of the warp, so every lane takes the
  // loop and the shuffles together
  for (long long base = warp * run; base < nseg; base += warps * run) {
    long long seg[kUnroll];
    int acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      seg[u] = base + (long long)u * per_warp + (lane >> lanes_log2);
    segment_sums<ELEM, kVec, kOne>(v, seg, nseg, seg_bytes, sub, L, acc);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (sub == 0 && seg[u] < nseg) {
        const int conn = acc[u] / scale;
        potential[seg[u]] = acc[u] - scale * conn;
        connected[seg[u]] = conn;
      }
    }
  }
}

// The flags form where a column's G segments (a power of two) lie in one
// run of a warp (G <= 32 / L): the iterations are the count kernel's, and
// the column's bits meet by log2(G) shuffles across its segments' lanes
// (L apart); the column's first lane stores its words.
template <int ELEM, bool kVec, bool kOne>
__global__ void __launch_bounds__(kThreads) seg_flags_shfl_kernel(
    const uint8_t* __restrict__ v, const int* __restrict__ seg_cell,
    int* __restrict__ matching_word, int* __restrict__ prediction,
    long long nseg, int C, double inv_c, int g_log2, int D, int W,
    int seg_bytes, int lanes_log2, int scale, int theta_m, int theta_a) {
  const int L = 1 << lanes_log2, G = 1 << g_log2;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (L - 1);
  const int g = (lane >> lanes_log2) & (G - 1);  // runs start a column
  const int per_warp = 32 >> lanes_log2;
  const long long warp =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * kThreads) >> 5;
  const long long run = (long long)per_warp * kUnroll;
  for (long long base = warp * run; base < nseg; base += warps * run) {
    long long seg[kUnroll];
    int acc[kUnroll], cell[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      seg[u] = base + (long long)u * per_warp + (lane >> lanes_log2);
      cell[u] = sub == 0 && seg[u] < nseg ? __ldg(seg_cell + seg[u]) : -1;
    }
    segment_sums<ELEM, kVec, kOne>(v, seg, nseg, seg_bytes, sub, L, acc);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int conn = acc[u] / scale;
      const int pot = acc[u] - scale * conn;
      const bool in = sub == 0 && seg[u] < nseg;
      const bool match = pot >= theta_m;
      const bool active = match && conn >= theta_a && cell[u] >= 0 &&
                          cell[u] < D;
      unsigned word = match ? 1u << g : 0u;
      for (int o = L; o < L << g_log2; o <<= 1)
        word |= __shfl_xor_sync(0xffffffffu, word, o);
      const bool lead = in && g == 0;
      const long long col = seg[u] >> g_log2;
      if (lead) matching_word[col] = static_cast<int>(word);
      if (prediction) {
        // word w of column c of stream b lies at (b W + w) C + c: with one
        // word a column that is the column's own index, else b comes from
        // a product with 1/C, corrected by one step
        long long at = col;
        if (W > 1) {
          long long b = static_cast<long long>(static_cast<double>(col) *
                                               inv_c);
          long long c = col - b * C;
          if (c < 0) {
            --b;
            c += C;
          } else if (c >= C) {
            ++b;
            c -= C;
          }
          at = b * W * C + c;
        }
        // words 0 and 1 (up to 64 cells a column) with their shuffles
        // side by side, the rest one by one
        const unsigned hit = active ? 1u << (cell[u] & 31) : 0u;
        const int word_of = cell[u] >> 5;
        unsigned b0 = word_of == 0 ? hit : 0u;
        unsigned b1 = word_of == 1 ? hit : 0u;
        for (int o = L; o < L << g_log2; o <<= 1) {
          b0 |= __shfl_xor_sync(0xffffffffu, b0, o);
          b1 |= __shfl_xor_sync(0xffffffffu, b1, o);
        }
        if (lead) {
          prediction[at] = static_cast<int>(b0);
          if (W > 1) prediction[at + C] = static_cast<int>(b1);
        }
        for (int w = 2; w < W; ++w) {
          unsigned bits = word_of == w ? hit : 0u;
          for (int o = L; o < L << g_log2; o <<= 1)
            bits |= __shfl_xor_sync(0xffffffffu, bits, o);
          if (lead) prediction[at + (long long)w * C] = static_cast<int>(bits);
        }
      }
    }
  }
}

// The flags form for any other G: a warp takes whole columns an
// iteration (n_cols = max(1, slots / G) of the slots = per_warp * kUnroll
// segments a round of segment_sums, in as many rounds as their G
// segments need). Each segment's first lane decodes its counts and
// leaves its matching bit and its predicted cell (or -1) in the warp's
// shared memory; then lane j ORs column j's G entries into its
// matching word and W prediction words (coalesced over the columns).
template <int ELEM, bool kVec, bool kOne>
__global__ void __launch_bounds__(kThreads) seg_flags_kernel(
    const uint8_t* __restrict__ v, const int* __restrict__ seg_cell,
    int* __restrict__ matching_word, int* __restrict__ prediction,
    long long n_cols, int C, int G, int D, int W, int seg_bytes,
    int lanes_log2, int scale, int theta_m, int theta_a) {
  __shared__ int2 flags[kThreads / 32][kFlagSlots];
  const int L = 1 << lanes_log2;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (L - 1);
  const int per_warp = 32 >> lanes_log2;
  const int slots = per_warp * kUnroll;
  const int cols_it = G <= slots ? slots / G : 1;
  const int segs_it = cols_it * G;
  const long long nseg = n_cols * G;
  int2* mine = flags[threadIdx.x >> 5];
  const long long warp =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * kThreads) >> 5;
  for (long long col0 = warp * cols_it; col0 < n_cols;
       col0 += warps * cols_it) {
    const long long seg0 = col0 * G;
    for (int i0 = 0; i0 < segs_it; i0 += slots) {
      long long seg[kUnroll];
      int acc[kUnroll], cell[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * per_warp + (lane >> lanes_log2);
        seg[u] = i < segs_it ? seg0 + i : nseg;
        // the owner, in flight with the activity's loads
        cell[u] = sub == 0 && seg[u] < nseg ? __ldg(seg_cell + seg[u]) : -1;
      }
      segment_sums<ELEM, kVec, kOne>(v, seg, nseg, seg_bytes, sub, L, acc);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (sub == 0 && seg[u] < nseg) {
          const int conn = acc[u] / scale;
          const int pot = acc[u] - scale * conn;
          const bool match = pot >= theta_m;
          mine[seg[u] - seg0] = make_int2(
              match, match && conn >= theta_a && cell[u] >= 0 && cell[u] < D
                         ? cell[u]
                         : -1);
        }
      }
    }
    __syncwarp();
    const long long col = col0 + lane;
    if (lane < cols_it && col < n_cols) {
      const int2* f = mine + lane * G;
      unsigned word = 0;
      for (int g = 0; g < G; ++g) word |= (unsigned)f[g].x << g;
      matching_word[col] = static_cast<int>(word);
      if (prediction) {
        const long long b = col / C, c = col - b * C;
        for (int w = 0; w < W; ++w) {
          unsigned bits = 0;
          for (int g = 0; g < G; ++g) {
            const int cell = f[g].y;
            if (cell >= 0 && (cell >> 5) == w) bits |= 1u << (cell & 31);
          }
          prediction[(b * W + w) * C + c] = static_cast<int>(bits);
        }
      }
    }
    __syncwarp();
  }
}

// The lanes a segment (log2): the power of two that covers its chunks,
// at most 32; the most chunks a segment spans are ceil((3 + seg_bytes) /
// 4) words where it starts three bytes into one.
template <bool kVec>
int chunks_of(int seg_bytes) {
  return kVec ? seg_bytes / 16 : (seg_bytes + 6) / 4;
}

int lanes_log2_of(int chunks) {
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < chunks && lanes_log2 < 5) ++lanes_log2;
  return lanes_log2;
}

template <int ELEM, bool kVec>
int launch(const uint8_t* v, int* potential, int* connected, long long nseg,
           int seg_bytes, int scale, cudaStream_t stream) {
  const int chunks = chunks_of<kVec>(seg_bytes);
  const int lanes_log2 = lanes_log2_of(chunks);
  const long long run = (long long)(32 >> lanes_log2) * kUnroll;
  const long long per_block = run * (kThreads / 32);
  long long blocks = (nseg + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (chunks <= (1 << lanes_log2))
    seg_counts_kernel<ELEM, kVec, true><<<(unsigned)blocks, kThreads, 0,
                                           stream>>>(
        v, potential, connected, nseg, seg_bytes, lanes_log2, scale);
  else
    seg_counts_kernel<ELEM, kVec, false><<<(unsigned)blocks, kThreads, 0,
                                            stream>>>(
        v, potential, connected, nseg, seg_bytes, lanes_log2, scale);
  return (int)cudaGetLastError();
}

template <int ELEM, bool kVec>
int launch_flags(const uint8_t* v, const int* seg_cell, int* matching_word,
                 int* prediction, long long n_cols, int C, int G, int D,
                 int seg_bytes, int scale, int theta_m, int theta_a,
                 cudaStream_t stream) {
  const int chunks = chunks_of<kVec>(seg_bytes);
  const int lanes_log2 = lanes_log2_of(chunks);
  const int W = (D + 31) / 32;
  const bool one = chunks <= (1 << lanes_log2);
  if ((G & (G - 1)) == 0 && G <= (32 >> lanes_log2)) {
    // a column's segments in one run: the count kernel's iterations
    int g_log2 = 0;
    while ((1 << g_log2) < G) ++g_log2;
    const long long nseg = n_cols * G;
    const long long per_block =
        (long long)(32 >> lanes_log2) * kUnroll * (kThreads / 32);
    long long blocks = (nseg + per_block - 1) / per_block;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    if (one)
      seg_flags_shfl_kernel<ELEM, kVec, true>
          <<<(unsigned)blocks, kThreads, 0, stream>>>(
              v, seg_cell, matching_word, prediction, nseg, C, 1.0 / C,
              g_log2, D, W, seg_bytes, lanes_log2, scale, theta_m, theta_a);
    else
      seg_flags_shfl_kernel<ELEM, kVec, false>
          <<<(unsigned)blocks, kThreads, 0, stream>>>(
              v, seg_cell, matching_word, prediction, nseg, C, 1.0 / C,
              g_log2, D, W, seg_bytes, lanes_log2, scale, theta_m, theta_a);
    return (int)cudaGetLastError();
  }
  const int slots = (32 >> lanes_log2) * kUnroll;
  const long long cols_it = G <= slots ? slots / G : 1;
  const long long per_block = cols_it * (kThreads / 32);
  long long blocks = (n_cols + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (one)
    seg_flags_kernel<ELEM, kVec, true><<<(unsigned)blocks, kThreads, 0,
                                          stream>>>(
        v, seg_cell, matching_word, prediction, n_cols, C, G, D, W,
        seg_bytes, lanes_log2, scale, theta_m, theta_a);
  else
    seg_flags_kernel<ELEM, kVec, false><<<(unsigned)blocks, kThreads, 0,
                                           stream>>>(
        v, seg_cell, matching_word, prediction, n_cols, C, G, D, W,
        seg_bytes, lanes_log2, scale, theta_m, theta_a);
  return (int)cudaGetLastError();
}

}  // namespace

// v (B, C, G*K) packed activity of act_bytes bytes a value (1: u8, 2:
// bf16, 4: float32), 16-byte aligned -> potential and connected (B, C, G)
// int32, decoded with scale > K. The flags form, where seg_cell (B, C, G)
// int32 (the segments' owner cells, D = none) is not null, writes no
// counts (potential and connected null) but matching_word (B, C) int32,
// bit g where potential >= theta_m (G <= 32), and, where prediction is
// not null, the (B, ceil(D/32), C) int32 prediction words, bit d of word
// w where a matching segment of the column with connected >= theta_a is
// owned by cell 32 w + d. Launches on the given
// stream of the given device, allocates nothing and returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int seg_counts(const void* v, int* potential, int* connected,
                          const int* seg_cell, int* matching_word,
                          int* prediction, int B, int C, int G, int K,
                          int scale, int act_bytes, int D, int theta_m,
                          int theta_a, int device, void* stream) {
  const bool flags = seg_cell != nullptr;
  if (B < 0 || C < 0 || G < 0 || K < 1 || scale <= K ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0 ||
      (flags ? G > 32 || D < 1 || !matching_word || potential || connected
             : !potential || !connected))
    return (int)cudaErrorInvalidValue;
  const long long nseg = (long long)B * C * G;
  if (nseg == 0) return 0;
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* p = static_cast<const uint8_t*>(v);
  return bithtm::with_bytes(act_bytes, [&](auto bytes) {
    constexpr int ELEM = decltype(bytes)::value;
    const int seg_bytes = K * ELEM;
    return bithtm::with_bool(seg_bytes % 16 == 0, [&](auto vec) {
      constexpr bool kVec = decltype(vec)::value;
      if (flags)
        return launch_flags<ELEM, kVec>(p, seg_cell, matching_word,
                                        prediction, (long long)B * C, C, G,
                                        D, seg_bytes, scale, theta_m,
                                        theta_a, s);
      return launch<ELEM, kVec>(p, potential, connected, nseg, seg_bytes,
                                scale, s);
    });
  });
}
