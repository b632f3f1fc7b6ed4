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

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;
constexpr long long kMaxBlocks = 1 << 22;

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

template <int ELEM, bool kVec, bool kOne>
__global__ void __launch_bounds__(kThreads) seg_counts_kernel(
    const uint8_t* __restrict__ v, int* __restrict__ potential,
    int* __restrict__ connected, long long nseg, int seg_bytes,
    int lanes_log2, int scale) {
  using Seg = Segment<ELEM, kVec>;
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
    for (int u = 0; u < kUnroll; ++u) {
      for (int o = L / 2; o > 0; o /= 2)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
      if (sub == 0 && seg[u] < nseg) {
        const int conn = acc[u] / scale;
        potential[seg[u]] = acc[u] - scale * conn;
        connected[seg[u]] = conn;
      }
    }
  }
}

template <int ELEM, bool kVec>
int launch(const uint8_t* v, int* potential, int* connected, long long nseg,
           int seg_bytes, int scale, cudaStream_t stream) {
  // the most chunks a segment spans: ceil((3 + seg_bytes) / 4) words
  // where it starts three bytes into one
  const int chunks = kVec ? seg_bytes / 16 : (seg_bytes + 6) / 4;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < chunks && lanes_log2 < 5) ++lanes_log2;
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

}  // namespace

// v (B, C, G*K) packed activity of act_bytes bytes a value (1: u8, 2:
// bf16, 4: float32), 16-byte aligned -> potential and connected (B, C, G)
// int32, decoded with scale > K. Launches on the given stream of the given
// device, allocates nothing and returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int seg_counts(const void* v, int* potential, int* connected,
                          int B, int C, int G, int K, int scale,
                          int act_bytes, int device, void* stream) {
  if (B < 0 || C < 0 || G < 0 || K < 1 || scale <= K ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
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
    return seg_bytes % 16 == 0
               ? launch<ELEM, true>(p, potential, connected, nseg, seg_bytes,
                                    scale, s)
               : launch<ELEM, false>(p, potential, connected, nseg,
                                     seg_bytes, scale, s);
  });
}
