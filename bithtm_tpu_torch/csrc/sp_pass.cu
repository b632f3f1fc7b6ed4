// Spatial pooler Hebbian update and connected re-pack, for NVIDIA Hopper
// (sm_90a).
//
// Replaces sp_update_pack_tpu (bithtm_tpu/ops/pallas_kernels.py:598, body
// _sp_kernel :549). Plain PyTorch version:
// bithtm_tpu_torch/models/spatial_pooler.py (sp_update_pack_ref).
//
// Per stream b, column c and input lane i of the (C, I_pad) permanence
// table, with act = (c is one of the stream's A active columns):
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
};

// 8 consecutive lanes of type T: one 16-byte vector for int16, two for
// float32.
template <typename T>
struct Lanes {
  static constexpr int kVectors = sizeof(T) * kVec / 16;
  int4 v[kVectors];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int k = 0; k < kVectors; ++k)
      v[k] = reinterpret_cast<const int4*>(p)[k];
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

template <class Op>
__global__ void __launch_bounds__(kThreads) sp_update_pack_kernel(
    typename Op::T* __restrict__ perm,
    const typename Op::D* __restrict__ delta, const int* __restrict__ cols,
    uint8_t* __restrict__ pack, int C, int I_pad, int A, Op op) {
  using T = typename Op::T;
  using D = typename Op::D;
  // the delta row (I_pad * 4 bytes, a multiple of 16), then the bitmap
  extern __shared__ int4 smem[];
  D* dl = reinterpret_cast<D*>(smem);
  uint32_t* active = reinterpret_cast<uint32_t*>(dl + I_pad);
  const int b = blockIdx.y;
  const int4* src = reinterpret_cast<const int4*>(delta + (size_t)b * I_pad);
  for (int i = threadIdx.x; i < I_pad / 4; i += blockDim.x) smem[i] = src[i];
  for (int i = threadIdx.x; i < (C + 31) >> 5; i += blockDim.x)
    active[i] = 0u;
  __syncthreads();
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const int c = cols[(size_t)b * A + a];
    if (c >= 0 && c < C) atomicOr(&active[c >> 5], 1u << (c & 31));
  }
  __syncthreads();

  const int S = I_pad >> 3;
  const int row_groups = S / kVec;
  const long long n_groups = (long long)C * row_groups;
  const long long g0 = (long long)blockIdx.x * kGroupsPerBlock;
  const long long g1 = min(g0 + kGroupsPerBlock, n_groups);
  for (long long g = g0 + threadIdx.x; g < g1; g += blockDim.x) {
    const int c = static_cast<int>(g / row_groups);
    const int w0 = static_cast<int>(g - (long long)c * row_groups) * kVec;
    const bool act = (active[c >> 5] >> (c & 31)) & 1u;
    T* row = perm + ((size_t)b * C + c) * I_pad;
    Lanes<T> p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j].load(row + j * S + w0);
    uint8_t byte[kVec] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      Lanes<D> d;
      d.load(dl + j * S + w0);
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
    *reinterpret_cast<uint2*>(pack + ((size_t)b * C + c) * S + w0) = out;
  }
}

template <class Op>
int launch(void* perm, const void* delta, const int* cols, uint8_t* pack,
           int B, int C, int I_pad, int A, Op op, int device,
           cudaStream_t stream) {
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  const size_t smem = (size_t)I_pad * 4 + ((size_t)C + 31) / 32 * 4;
  if (smem > bithtm::kMaxShared) return (int)cudaErrorInvalidValue;
  auto kernel = sp_update_pack_kernel<Op>;
  if (int err = bithtm::allow_shared(
          kernel, smem > 48 * 1024 ? bithtm::kMaxShared : smem))
    return err;
  const long long n_groups = (long long)C * (I_pad / 8 / kVec);
  dim3 grid((unsigned)((n_groups + kGroupsPerBlock - 1) / kGroupsPerBlock),
            B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<typename Op::T*>(perm),
      static_cast<const typename Op::D*>(delta), cols, pack, C, I_pad, A, op);
  return (int)cudaGetLastError();
}

}  // namespace

// perm (B, C, I_pad) int16 (quantized) or float32, updated in place;
// delta (B, I_pad) int32 (quantized) or float32; cols (B, A) int32;
// pack (B, C, I_pad / 8) u8. I_pad is a multiple of 1024, every pointer
// 16-byte aligned, B <= 65535 and 4 * I_pad + ceil(C / 32) * 4 <=
// 232,448 bytes (the delta row and the column bitmap in shared memory).
// Launches on the given stream of the given device, allocates nothing and
// returns cudaGetLastError() after the launch (0 = success).
extern "C" int sp_update_pack(void* perm, const void* delta, const int* cols,
                              uint8_t* pack, int B, int C, int I_pad, int A,
                              int quantized, float threshold_f,
                              int threshold_i, int device, void* stream) {
  if (I_pad % 1024 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantized)
    return launch(perm, delta, cols, pack, B, C, I_pad, A,
                  Int16Units{threshold_i}, device, s);
  return launch(perm, delta, cols, pack, B, C, I_pad, A,
                Float32{threshold_f}, device, s);
}
