// Bit pack of bool rows into 32-bit words, for NVIDIA Hopper (sm_90a).
//
// Stands for the JAX package's pack_bits (bithtm_tpu/ops/active_set.py:85),
// a uint32 multiply-and-sum against the bit weights that XLA fuses into
// one pass. The TPU package has no Pallas kernel for it. Plain PyTorch
// version: bithtm_tpu_torch/ops/active_set.py (pack_bits_ref), which pads
// the rows to whole words and widens every bool to int64 before it sums
// (torch has no uint32 sum).
//
// Per row of D bools (a contiguous (rows, D) bool tensor):
//   out[row, w] = sum over d in [32 w, min(32 w + 32, D)) of
//                 (mask[row, d] != 0) << (d - 32 w)
// as int32 carrying the 32 bits, W = ceil(D / 32) words a row, zeros past
// D. The temporal memory packs its active and winner cells (B, A, D) and
// its per-segment matching flags (B, C, G) this way every step.
//
// Bound: bytes. Each bool is read once and each word written once: the
// bench's (256, 2048, 4) matching flags are 2.1 MB in and 2.1 MB out,
// about 1.3 us at the H100's 3.35 TB/s (the plain version's int64
// intermediate was 134 MB).
//
// Design. Path "ballot" (D a multiple of 32: every word is 32 whole
// bytes, the rows need not be told apart): a warp takes 32 words at a
// time; for each, lane i reads byte i (one 32-byte sector a warp load, 32
// loads in flight a lane) and __ballot_sync gives the word, which lane j
// keeps for word j, so the warp stores 32 words with one coalesced store.
// Elsewhere, one thread a word reads its bytes as vectors of V bytes, V
// the larger of 8 and 4 that divides D (each row then starts V-byte
// aligned), else byte by byte ("v8", "v4", "v1"); __vcmpne4 turns four
// bytes into four 0/1 flags, which one multiply gathers into a nibble.
// The vectors measured faster than bytes at every main-path shape they
// take (PERF.md, scripts/wrapper_ab.py --part pack). Neighbouring threads take neighbouring words, so a warp's loads
// are one contiguous run. Both grids stride, so the size has no limit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

__global__ void __launch_bounds__(kThreads) pack_ballot_kernel(
    const uint8_t* __restrict__ mask, int* __restrict__ out,
    long long n_words) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * kThreads) >> 5;
  for (long long tile = warp * 32; tile < n_words; tile += warps * 32) {
    unsigned mine = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const long long w = tile + j;
      const uint8_t v = w < n_words ? __ldg(mask + w * 32 + lane) : 0;
      const unsigned word = __ballot_sync(kFull, v != 0);
      if (lane == j) mine = word;
    }
    if (tile + lane < n_words) out[tile + lane] = static_cast<int>(mine);
  }
}

// Four bytes -> a nibble: bit k set where byte k is not 0.
__device__ __forceinline__ unsigned nibble(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}

template <int V>
__device__ __forceinline__ unsigned chunk_bits(const uint8_t* p) {
  if constexpr (V == 8) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    return nibble(x.x) | nibble(x.y) << 4;
  } else if constexpr (V == 4) {
    return nibble(__ldg(reinterpret_cast<const unsigned*>(p)));
  } else {
    return __ldg(p) != 0;
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads) pack_vec_kernel(
    const uint8_t* __restrict__ mask, int* __restrict__ out, long long rows,
    int D, int W) {
  const long long n_words = rows * W;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
       t < n_words; t += (long long)gridDim.x * kThreads) {
    const long long r = t / W;
    const int w = (int)(t - r * W);
    const int n = min(32, D - 32 * w);  // a multiple of V
    const uint8_t* p = mask + r * D + 32 * w;
    unsigned word = 0;
    for (int c = 0; c < n; c += V) word |= chunk_bits<V>(p + c) << c;
    out[t] = static_cast<int>(word);
  }
}

long long grid(long long items) {
  const long long blocks = (items + kThreads - 1) / kThreads;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

template <int V>
int launch_vec(const uint8_t* mask, int* out, long long rows, int D, int W,
               cudaStream_t stream) {
  pack_vec_kernel<V><<<(unsigned)grid(rows * W), kThreads, 0, stream>>>(
      mask, out, rows, D, W);
  return (int)cudaGetLastError();
}

}  // namespace

// mask (rows, D) bool, contiguous and aligned to the vector the path
// reads (8 or 4 bytes where D is a multiple of it) -> out (rows, W)
// int32 words, W = ceil(D / 32). Launches on the given stream of the
// given device, allocates nothing and returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int pack_bits(const void* mask, int* out, long long rows, int D,
                         int device, void* stream) {
  if (rows < 0 || D < 0) return (int)cudaErrorInvalidValue;
  const int W = (D + 31) / 32;
  if (rows * W == 0) return 0;
  const int vec = D % 32 == 0 ? 32 : D % 8 == 0 ? 8 : D % 4 == 0 ? 4 : 1;
  if (reinterpret_cast<uintptr_t>(mask) % (vec == 32 ? 1 : vec) != 0)
    return (int)cudaErrorInvalidValue;
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  switch (vec) {
    case 32: {
      const long long n_words = rows * W;
      pack_ballot_kernel<<<(unsigned)grid(n_words), kThreads, 0, s>>>(
          m, out, n_words);
      return (int)cudaGetLastError();
    }
    case 8: return launch_vec<8>(m, out, rows, D, W, s);
    case 4: return launch_vec<4>(m, out, rows, D, W, s);
  }
  return launch_vec<1>(m, out, rows, D, W, s);
}
