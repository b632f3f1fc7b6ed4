// Small-table lookup of the index-keyed growth selection, for NVIDIA
// Hopper (sm_90a).
//
// Replaces small_table_take_tpu (bithtm_tpu/ops/pallas_kernels.py:885,
// body _small_take_kernel :872): the decode list index -> candidate cell
// of the growth keys above 2^16 cells (bithtm_tpu/ops/active_set.py
// take_small_table). Plain PyTorch version:
// bithtm_tpu_torch/ops/active_set.py (take_small_table_ref).
//
// Per stream b and key i of its n keys, with k = keys[b, i] & mask:
//   out[b, i] = table[b, k]   if 0 <= k < Wc, else 0
// The growth step passes its sorted keys, the mask of their index bits
// and its candidate list as it is (a strided view: rows table_stride
// words apart), and takes the cells in place of the keys (out == keys),
// so the decode is one launch and allocates nothing (mask = -1 takes the
// keys as they are). A sentinel key decodes to an index >= Wc whenever Wc
// is not a power of two, so no index is trusted: the kernel never reads
// outside [0, Wc).
//
// Design. The TPU kernel rode the table as (Wc/128, 128) sublane rows and
// did one lane gather per 128-wide chunk, because Mosaic has no general
// gather. Here a block takes kKeysPerBlock keys of one stream: each
// thread first loads all its keys (16-byte int4 loads where the keys and
// the output are aligned and n % 4 == 0), then the block stages the
// stream's table in dynamic shared memory while those loads are in
// flight, and each key costs one shared-memory load. A thread stores
// only the keys it loaded, after loading them, so out may be keys. A
// table wider than a block may stage (kMaxShared bytes, 58,112 words) is
// read through the read-only cache instead. The grid is one-dimensional,
// B x ceil(n / kKeysPerBlock) blocks, so B has no limit of its own.
//
// Bound: bytes, 8 a key (4 in, 4 out) plus the table. At the 16K tuned
// caps (B=64, L=336, kk=32, Wc=384: 384 blocks) that is 5.6 MB, 1.7 us at
// the H100's 3.35 TB/s; at the auto caps (L=824, Wc=768: 832 blocks)
// 13.7 MB, 4.1 us. Both grids fit the card in one wave, so the time is
// the launch and one round of first loads. What bounds a call is the
// host: the wrapper's checks and the ctypes call take longer than the
// kernel, so the device waits on the next launch. The wrapper therefore
// checks both tensors in one pass, allocates nothing when it decodes in
// place, and passes the device index and the raw current stream straight
// through (launch.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKeysPerBlock = 2048;

// The table word at k = key & mask, 0 outside [0, Wc).
template <bool kStaged>
__device__ __forceinline__ int decode(const int* tab, int key, int mask,
                                      int Wc) {
  const unsigned k = static_cast<unsigned>(key & mask);
  if (k >= static_cast<unsigned>(Wc)) return 0;
  return kStaged ? tab[k] : __ldg(tab + k);
}

// keys and out may be one buffer: no __restrict__ on either
template <bool kStaged, int VEC>
__global__ void __launch_bounds__(kThreads) small_take_kernel(
    const int* __restrict__ table, int table_stride, const int* keys,
    int* out, int Wc, int n, int mask, int blocks_per_stream) {
  extern __shared__ int staged[];
  using V = typename std::conditional<VEC == 4, int4, int>::type;
  constexpr int kPer = kKeysPerBlock / (kThreads * VEC);
  const int b = blockIdx.x / blocks_per_stream;
  const int s0 = (blockIdx.x - b * blocks_per_stream) * kKeysPerBlock;
  const int* row = table + (size_t)b * table_stride;
  const int* kb = keys + (size_t)b * n;
  int* ob = out + (size_t)b * n;

  V k[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int s = s0 + (threadIdx.x + j * kThreads) * VEC;
    if (s < n) k[j] = *reinterpret_cast<const V*>(kb + s);
  }
  if constexpr (kStaged) {
    for (int i = threadIdx.x; i < Wc; i += kThreads) staged[i] = row[i];
    __syncthreads();
  }
  const int* tab = kStaged ? staged : row;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int s = s0 + (threadIdx.x + j * kThreads) * VEC;
    if (s >= n) continue;
    if constexpr (VEC == 4) {
      *reinterpret_cast<int4*>(ob + s) = make_int4(
          decode<kStaged>(tab, k[j].x, mask, Wc),
          decode<kStaged>(tab, k[j].y, mask, Wc),
          decode<kStaged>(tab, k[j].z, mask, Wc),
          decode<kStaged>(tab, k[j].w, mask, Wc));
    } else {
      ob[s] = decode<kStaged>(tab, k[j], mask, Wc);
    }
  }
}

template <bool kStaged, int VEC>
int launch(const int* table, int table_stride, const int* keys, int* out,
           int B, int Wc, int n, int mask, cudaStream_t stream) {
  auto kernel = small_take_kernel<kStaged, VEC>;
  const size_t smem = kStaged ? (size_t)Wc * sizeof(int) : 0;
  // opt in to the most a block may take, so that a launch from another
  // host thread never finds the kernel's limit below its own table
  if (int err = bithtm::allow_shared(
          kernel, smem > 48 * 1024 ? bithtm::kMaxShared : smem))
    return err;
  const int per_stream = (n + kKeysPerBlock - 1) / kKeysPerBlock;
  const long long blocks = (long long)per_stream * B;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      table, table_stride, keys, out, Wc, n, mask, per_stream);
  return (int)cudaGetLastError();
}

}  // namespace

// table (B, Wc) int32 with Wc >= 1, its rows table_stride >= Wc words
// apart (unit stride within a row); keys (B, n) int32 -> out (B, n) int32
// (out may be keys), decoding keys[b, i] & mask. Launches on the given
// stream of the given device, allocates nothing and returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int small_table_take(const int* table, int table_stride,
                                const int* keys, int* out, int B, int Wc,
                                int n, int mask, int device, void* stream) {
  if (B < 0 || Wc < 1 || n < 0 || (B > 1 && table_stride < Wc))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return 0;
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool staged = (size_t)Wc * sizeof(int) <= bithtm::kMaxShared;
  const bool aligned = n % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (staged)
    return aligned ? launch<true, 4>(table, table_stride, keys, out, B, Wc, n,
                                     mask, s)
                   : launch<true, 1>(table, table_stride, keys, out, B, Wc, n,
                                     mask, s);
  return aligned ? launch<false, 4>(table, table_stride, keys, out, B, Wc, n,
                                      mask, s)
                 : launch<false, 1>(table, table_stride, keys, out, B, Wc, n,
                                      mask, s);
}
