// Spatial pooler overlap: AND of the packed connections with the packed
// input, popcount and row sum, for NVIDIA Hopper (sm_90a).
//
// Stands for the JAX package's overlaps (bithtm_tpu/ops/overlap.py:85),
// which XLA fuses into one pass: population_count(connected & x) and a
// row sum. The TPU package has no Pallas kernel for it. Plain PyTorch
// version: bithtm_tpu_torch/ops/overlap.py (overlaps_ref), which packs
// the input and runs a SWAR popcount of int64 words in some twenty passes.
//
// Per stream b and column c of the (B, C, S) u8 connected table, with x the
// stream's input packed as ops/overlap.py pack_input packs it (bit j of
// byte w holds input j*S + w, 0 past I):
//   out[b, c] = sum over w of popc(connected[b, c, w] & x[w])
// S is a multiple of 128 bytes (input_words), so a row is a whole number
// of 16-byte vectors. Any C: a column shard's table holds its rows only.
//
// Bound: bytes. The table is read once (B*C*S bytes: 67 MB at the bench's
// B=256, C=2048, S=128; 134 MB at 16K x 64, B=64), the (B, I) bool input
// once and the (B, C) int32 counts written once: about 0.021 ms and 0.041
// ms at the H100's 3.35 TB/s. A popcount and an AND a word are far below
// any peak rate.
//
// Design. The block packs its stream's input itself (the strided pack,
// ragged tail included) into shared memory, up to kTile bytes of x at a
// time, so no packed input goes through device memory and the packing's
// small launches are gone. Eight lanes take a row, one 16-byte vector
// each, so a warp reads four rows of 128 contiguous bytes; each thread
// takes kRowsPerThread rows kRowsPerPass apart and issues all their loads
// before it counts, so that four vectors a thread are in flight; a tile's
// first vectors are loaded before the block packs x, so that the table's
// loads and the packing overlap. A row's eight partial counts meet in
// three __shfl_xor_sync steps and its first lane stores the count. A
// row wider than 128 bytes walks its vectors eight at a time; an x wider
// than kTile bytes is staged a tile at a time.
// The grid is (row blocks, B), or with FOLD (past 65,535 streams, the
// grid's y extent) the streams folded into grid x.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                             // lanes a row
constexpr int kRowsPerPass = kThreads / kLanes;       // 32
constexpr int kRowsPerThread = 4;
constexpr int kRowsPerBlock = kRowsPerPass * kRowsPerThread;  // 128
constexpr int kTile = 4096;   // bytes of packed input staged at a time

__device__ __forceinline__ int popc_and(uint4 a, uint4 b) {
  return __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) +
         __popc(a.w & b.w);
}

template <bool kFold>
__global__ void __launch_bounds__(kThreads) sp_overlap_kernel(
    const uint4* __restrict__ connected, const uint8_t* __restrict__ bits,
    int* __restrict__ out, int C, int S, int I, int blocks_per_stream) {
  __shared__ __align__(16) uint8_t xs[kTile];
  const int b = kFold ? blockIdx.x / blocks_per_stream : blockIdx.y;
  const int rb = kFold ? blockIdx.x - b * blocks_per_stream : blockIdx.x;
  const int lane = threadIdx.x % kLanes;
  const int row0 = rb * kRowsPerBlock + threadIdx.x / kLanes;
  const size_t vecs = S / 16;                         // vectors a row
  const uint4* table = connected + (size_t)b * C * vecs;
  const uint8_t* xb = bits + (size_t)b * I;

  // the kRowsPerThread rows' 16-byte vectors at vector index col
  auto load_rows = [&](uint4* c, size_t col) {
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int r = row0 + k * kRowsPerPass;
      c[k] = r < C ? __ldg(table + (size_t)r * vecs + col)
                   : make_uint4(0, 0, 0, 0);
    }
  };
  int acc[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) acc[k] = 0;
  for (int t0 = 0; t0 < S; t0 += kTile) {
    // tn is a multiple of 128, so nv is a multiple of kLanes: every lane
    // takes as many vectors, the first before the block packs x, so that
    // the table's loads are in flight while it does
    const int tn = min(kTile, S - t0);
    const int nv = tn / 16;
    uint4 c[kRowsPerThread];
    load_rows(c, (size_t)(t0 / 16) + lane);
    if (t0) __syncthreads();            // the last tile is counted
    for (int w = threadIdx.x; w < tn; w += kThreads) {
      unsigned byte = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long i = (long long)j * S + t0 + w;
        if (i < I) byte |= (xb[i] != 0 ? 1u : 0u) << j;
      }
      xs[w] = static_cast<uint8_t>(byte);
    }
    __syncthreads();
    for (int v = lane;;) {
      const uint4 x = reinterpret_cast<const uint4*>(xs)[v];
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) acc[k] += popc_and(c[k], x);
      v += kLanes;
      if (v >= nv) break;
      load_rows(c, (size_t)(t0 / 16) + v);
    }
  }
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    int v = acc[k];
#pragma unroll
    for (int o = kLanes / 2; o > 0; o /= 2)
      v += __shfl_xor_sync(0xffffffffu, v, o);
    const int r = row0 + k * kRowsPerPass;
    if (lane == 0 && r < C) out[(size_t)b * C + r] = v;
  }
}

}  // namespace

// connected (B, C, S) u8, 16-byte aligned, S a multiple of 128; bits (B, I)
// bool (one byte each, 0 or 1) with S = input_words(I); out (B, C) int32.
// fold: the streams in grid x (past 65,535 streams). Launches on the given
// stream of the given device, allocates nothing and returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int sp_overlap(const uint8_t* connected, const uint8_t* bits,
                          int* out, int B, int C, int S, int I, int fold,
                          int device, void* stream) {
  if (B < 0 || C < 0 || S < 128 || S % 128 != 0 || I < 0 ||
      (long long)I > 8LL * S || (!fold && B > 65535) ||
      reinterpret_cast<uintptr_t>(connected) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return 0;
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_stream = (C + kRowsPerBlock - 1) / kRowsPerBlock;
  const uint4* table = reinterpret_cast<const uint4*>(connected);
  if (fold) {
    const long long blocks = (long long)per_stream * B;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    sp_overlap_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        table, bits, out, C, S, I, per_stream);
  } else {
    sp_overlap_kernel<false><<<dim3(per_stream, B), kThreads, 0, s>>>(
        table, bits, out, C, S, I, per_stream);
  }
  return (int)cudaGetLastError();
}
