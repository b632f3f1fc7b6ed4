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
// Design. A block takes a stream (the streams in grid x: any B). Each thread
// owns a run of contiguous columns: kKeys of them, their keys held in
// registers, read with 16-byte loads where C is a multiple of 4; past 16,384
// columns a run of any length, its keys read again from the boosted values
// the thread wrote. A column's pair (key, ~column), its key an
// order-preserving uint32 of its value (-0.0 keyed as +0.0), is distinct and
// orders the columns as the stable sort does, so the winners are the columns
// whose pair is at or above the A-th largest pair, the threshold. The block
// finds it by an MSB-first radix select over the keys: 8-bit passes, each a
// 256-bin histogram in shared memory and one warp's scan for the bin that
// holds the A-th key. It stops where the bin wins whole (the threshold is
// the bin's lowest key), or where it holds no more keys than the block has
// threads: their pairs are gathered and ranked, the k-th largest is the
// threshold. Past four passes (more than a block of equal keys) it is the
// pair of the k-th lowest column among them, by a block scan. Each thread
// then writes its columns' mask and duty' and appends its winners' pairs to
// a list of A (one atomic a warp), in shared memory, or in a global scratch
// where A pairs do not fit; a winner's place in the output is the number of
// pairs above it, counted by up to kThreads / A threads each. What holds it
// back: the passes' block barriers and, at 16K, a batch of 64 blocks on 132
// SMs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kBins = 256;
constexpr int kMaxThreads = 1024;

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

struct Shared {
  int hist[2][kBins];
  unsigned long long cand[kMaxThreads];  // the bin's (key, ~column) pairs
  int warp_sums[kMaxThreads / 32];
  unsigned long long threshold;  // the A-th largest pair
  int sel[3];
  int n_cand, n_list;
};

// The (key, ~column) pair of a column: distinct, and ordered as the
// stable descending sort orders the columns (value down, column up).
__device__ __forceinline__ unsigned long long pair_of(uint32_t key, int c) {
  return ((unsigned long long)key << 32) | (uint32_t)~c;
}

// A place in *counter's list for each lane of the warp with `take`, one
// atomic a warp; every lane of the warp calls it.
__device__ __forceinline__ int warp_append(bool take, int* counter) {
  const unsigned ballot = __ballot_sync(0xffffffffu, take);
  if (!ballot) return -1;
  const int lane = threadIdx.x & 31, leader = __ffs(ballot) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(ballot));
  base = __shfl_sync(0xffffffffu, base, leader);
  return take ? base + __popc(ballot & ((1u << lane) - 1u)) : -1;
}

// The exclusive prefix sum of each thread's v, in thread order. Every
// thread calls it.
__device__ int block_scan(int v, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += x;
  }
  if (lane == 31) sh.warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? sh.warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += x;
    }
    if (lane < warps) sh.warp_sums[lane] = s;
  }
  __syncthreads();
  return (warp ? sh.warp_sums[warp - 1] : 0) + inc - v;
}

// Warp 0: in the histogram h, the bin that holds the k-th largest key
// (bins from the top, 8 a lane), into sel: the bin, the rank k within it
// and its count; the other histogram zeroed for the next pass.
__device__ __forceinline__ void find_bin(const int* h, int* other, int k,
                                         int* sel) {
  const int lane = threadIdx.x & 31;
  int c[8], sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = h[kBins - 1 - (8 * lane + j)];
    sum += c[j];
    other[8 * lane + j] = 0;
  }
  int inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += x;
  }
  int above = inc - sum;
  if (above < k && inc >= k) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (above < k && above + c[j] >= k) {
        sel[0] = kBins - 1 - (8 * lane + j);
        sel[1] = k - above;
        sel[2] = c[j];
      }
      above += c[j];
    }
  }
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
  unsigned long long* list;  // a global scratch, or null: shared memory
  int C, A;
  float scale, momentum, one_minus;
};

// kThreads a block; kKeys: the columns a thread, keys in registers (0: any
// run, keys read again from `boosted`); kVec: 16-byte loads and stores
// (C % 4 == 0).
template <int kThreads, int kKeys, bool kVec>
__global__ void __launch_bounds__(kThreads) sp_select_kernel(const Select p) {
  extern __shared__ unsigned long long list_shared[];
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
  const int c0 = threadIdx.x * n;
  const size_t row = (size_t)blockIdx.x * C;
  unsigned long long* list =
      p.list ? p.list + (size_t)blockIdx.x * A : list_shared;
  uint32_t key[kKeys > 0 ? kKeys : 1];

  for (int i = threadIdx.x; i < 2 * kBins; i += kThreads)
    (&sh.hist[0][0])[i] = 0;
  if (threadIdx.x == 0) sh.n_cand = sh.n_list = 0;

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
            make_float4(boost_one(o.x, d.x, scale), boost_one(o.y, d.y, scale),
                        boost_one(o.z, d.z, scale), boost_one(o.w, d.w, scale));
        *reinterpret_cast<float4*>(boosted + row + c) = v;
        key[i] = order_key(v.x);
        key[i + 1] = order_key(v.y);
        key[i + 2] = order_key(v.z);
        key[i + 3] = order_key(v.w);
      }
    }
  } else {
    for_keys<kKeys>(n, [&](int i) {
      const int c = c0 + i;
      if (c < C) {
        const float v = boost_one(__ldg(ov + row + c), __ldg(duty + row + c),
                                  scale);
        boosted[row + c] = v;
        if constexpr (kKeys > 0) key[i] = order_key(v);
      }
    });
  }
  // a column's key (the thread's own columns only: it wrote them)
  auto key_at = [&](int i) -> uint32_t {
    if constexpr (kKeys > 0) {
      return key[i];
    } else {
      return order_key(boosted[row + c0 + i]);
    }
  };
  __syncthreads();  // the histograms and counters are zero

  // the radix select of the A-th largest pair, the threshold: the keys
  // with (key & pmask) == prefix hold it, as the k-th largest of theirs
  if (A > 0) {
    uint32_t prefix = 0, pmask = 0;
    int k = A;
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      int* h = sh.hist[pass & 1];
      for_keys<kKeys>(n, [&](int i) {
        if (c0 + i < C) {
          const uint32_t kk = key_at(i);
          if ((kk & pmask) == prefix)
            atomicAdd(h + ((kk >> shift) & 0xFFu), 1);
        }
      });
      __syncthreads();
      if (threadIdx.x < 32) find_bin(h, sh.hist[(pass + 1) & 1], k, sh.sel);
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
          const int c = c0 + i;
          const uint32_t kk = c < C ? key_at(i) : 0u;
          const bool in = c < C && (kk & pmask) == prefix;
          const int at = warp_append(in, &sh.n_cand);
          if (in) sh.cand[at] = pair_of(kk, c);
        });
        __syncthreads();
        if ((int)threadIdx.x < count) {
          const unsigned long long pair = sh.cand[threadIdx.x];
          int r = 0;
          for (int j = 0; j < count; ++j) r += sh.cand[j] > pair;
          if (r == k - 1) sh.threshold = pair;
        }
        break;
      }
      if (pass == 3) {
        // more than a block of equal keys: the k-th lowest column of them
        int n_eq = 0;
        for_keys<kKeys>(n, [&](int i) {
          n_eq += c0 + i < C && key_at(i) == prefix;
        });
        int seen = block_scan(n_eq, sh);
        if (seen < k && seen + n_eq >= k) {
          for_keys<kKeys>(n, [&](int i) {
            if (c0 + i < C && key_at(i) == prefix && ++seen == k)
              sh.threshold = pair_of(prefix, c0 + i);
          });
        }
      }
    }
  }
  __syncthreads();  // the threshold is set

  // the winners (their pairs at or above the threshold): the mask, duty'
  // and the list, in any order
  const unsigned long long threshold = sh.threshold;
  // the winners' places, counted in `place` (the pairs' buffer, free
  // now) where A <= kThreads: `parts` threads a winner
  int* place = reinterpret_cast<int*>(sh.cand);
  const int parts = A > 0 && A <= kThreads ? kThreads / A : 1;
  if (parts > 1 && (int)threadIdx.x < A) place[threadIdx.x] = 0;
  auto wins = [&](int i, bool valid) -> bool {
    const bool w = valid && A > 0 && pair_of(key_at(i), c0 + i) >= threshold;
    const int at = warp_append(w, &sh.n_list);
    if (w) list[at] = pair_of(key_at(i), c0 + i);
    return w;
  };
  if constexpr (kKeys > 0 && kVec) {
#pragma unroll
    for (int i = 0; i < kKeys; i += 4) {
      const int c = c0 + i;
      const bool valid = c < C;
      const bool w0 = wins(i, valid), w1 = wins(i + 1, valid),
                 w2 = wins(i + 2, valid), w3 = wins(i + 3, valid);
      if (valid) {
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
    for_keys<kKeys>(n, [&](int i) {
      const int c = c0 + i;
      const bool w = wins(i, c < C);
      if (c < C) {
        mask[row + c] = w;
        duty_out[row + c] =
            __fmaf_rn(__ldg(duty + row + c), momentum, w ? one_minus : 0.0f);
      }
    });
  }
  __syncthreads();  // the list is whole

  // a winner's place: the pairs above it
  int* out = p.cols + (size_t)blockIdx.x * A;
  if (parts > 1) {
    const int i = threadIdx.x / parts, part = threadIdx.x % parts;
    if (i < A) {
      const unsigned long long pair = list[i];
      int r = 0;
      for (int j = part; j < A; j += parts) r += list[j] > pair;
      atomicAdd(place + i, r);
    }
    __syncthreads();
    if ((int)threadIdx.x < A)
      out[place[threadIdx.x]] = (int)~(uint32_t)list[threadIdx.x];
    return;
  }
  for (int i = threadIdx.x; i < A; i += kThreads) {
    const unsigned long long pair = list[i];
    int r = 0;
    for (int j = 0; j < A; ++j) r += list[j] > pair;
    out[r] = (int)~(uint32_t)pair;
  }
}

template <int kThreads, int kKeys>
int launch(const Select& p, int B, size_t smem, cudaStream_t s) {
  return bithtm::with_bool(kKeys > 0 && p.C % 4 == 0, [&](auto vec) {
    auto kernel = sp_select_kernel<kThreads, kKeys, decltype(vec)::value>;
    if (int err = bithtm::allow_shared(kernel, smem)) return err;
    kernel<<<B, kThreads, smem, s>>>(p);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// ov (B, C) int32 and duty (B, C) float32, 16-byte aligned; outputs
// boosted (B, C) float32 and duty_out (B, C) float32, 16-byte aligned,
// cols (B, A) int32 and mask (B, C) bool (0 or 1). list: a (B, A) int64
// scratch for the winners' pairs, or null to keep them in shared memory
// (8 A bytes; refused past what a block may hold). 0 <= A <= C. scale =
// f32(-(intensity / density)), momentum and one_minus = f32(1 - momentum).
// Launches on the given stream of the given device, allocates nothing and
// returns cudaGetLastError() after the launch (0 = success).
extern "C" int sp_select(const int* ov, const float* duty, float* boosted,
                         int* cols, void* mask, float* duty_out,
                         unsigned long long* list, int B, int C, int A,
                         float scale, float momentum, float one_minus,
                         int device, void* stream) {
  const size_t smem = list ? 0 : 8 * (size_t)A;
  if (B < 0 || C < 0 || A < 0 || A > C ||
      smem + sizeof(Shared) > bithtm::kMaxShared ||
      reinterpret_cast<uintptr_t>(ov) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(duty) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(boosted) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(duty_out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return 0;
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Select p{ov, duty, boosted, cols, static_cast<uint8_t*>(mask),
                 duty_out, list, C, A, scale, momentum, one_minus};
  if (C <= 256 * 8) return launch<256, 8>(p, B, smem, s);
  if (C <= kMaxThreads * 8) return launch<kMaxThreads, 8>(p, B, smem, s);
  if (C <= kMaxThreads * 16) return launch<kMaxThreads, 16>(p, B, smem, s);
  return launch<kMaxThreads, 0>(p, B, smem, s);
}
