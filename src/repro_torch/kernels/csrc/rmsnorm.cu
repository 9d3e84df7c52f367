// RMSNorm over the last dim: out = x * rsqrt(mean(x^2) + eps) * (1 + w),
// computed in fp32 and stored in x's dtype.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py (rmsnorm/_kernel).
// Bound on the H100: bytes (x read once, out written once, 3 flops per
// element); at the 4 rows of a decode step, launch latency. One warp per
// row, up to kRows rows per block (a 500-row prompt runs 63 blocks, a
// 4-row decode step one block of 4 warps). Each lane loads its share of
// the row and of w in 16-byte pieces into registers, the sum of squares is
// reduced with warp shuffles alone (no shared memory, no __syncthreads),
// and the scale is applied to the row still in registers, so x is read
// once. A row of D = 2048 bf16 is 8 pieces per lane.
//
// Rows whose D is not a multiple of the 16-byte piece, pointers that are
// not aligned to it, and rows longer than the register buckets hold take
// the scalar variant: the same warp per row, one element per lane at a
// time, the row read a second time (from L1) for the scale.
#include <cstdint>

#include "common.cuh"

using namespace hydra;

namespace {

constexpr int kRows = 8;     // rows (warps) per block

// n values of T from one aligned piece of n * sizeof(T) bytes, in fp32
template <typename T, int n> struct Piece;
template <> struct Piece<float, 4> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) { v = *reinterpret_cast<const float4*>(p); }
  __device__ __forceinline__ float get(int i) const {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};
template <> struct Piece<float, 8> {
  float4 v[2];
  __device__ __forceinline__ void load(const float* p) {
    v[0] = *reinterpret_cast<const float4*>(p);
    v[1] = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ float get(int i) const {
    const float4& h = v[i >> 2];
    const int j = i & 3;
    return j == 0 ? h.x : j == 1 ? h.y : j == 2 ? h.z : h.w;
  }
};
template <> struct Piece<__nv_bfloat16, 4> {
  uint2 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ float get(int i) const {
    const uint32_t u = (i >> 1) ? v.y : v.x;
    return __uint_as_float((i & 1) ? (u & 0xffff0000u) : (u << 16));
  }
};
template <> struct Piece<__nv_bfloat16, 8> {
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ float get(int i) const {
    const int k = i >> 1;
    const uint32_t u = k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
    return __uint_as_float((i & 1) ? (u & 0xffff0000u) : (u << 16));
  }
};

template <typename T, int n>
__device__ __forceinline__ void store_piece(T* p, const float (&o)[n]);
template <>
__device__ __forceinline__ void store_piece<float, 4>(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
template <>
__device__ __forceinline__ void store_piece<__nv_bfloat16, 8>(__nv_bfloat16* p,
                                                           const float (&o)[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

// Row in registers: lane l holds pieces l, l + 32, ..., up to kNV of them
// (D <= 32 * kNV * V, D a multiple of V, x / w / out aligned to a piece).
template <typename TX, typename TW, int kNV>
__global__ void __launch_bounds__(32 * kRows)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TX* __restrict__ out, long long rows, int D, float eps) {
  constexpr int V = 16 / sizeof(TX);   // elements per 16-byte piece of x
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const TX* xr = x + row * D;
  Piece<TX, V> xv[kNV];
  Piece<TW, V> wv[kNV];
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    const int i = (lane + 32 * k) * V;
    if (i < D) {
      xv[k].load(xr + i);
      wv[k].load(w + i);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    if ((lane + 32 * k) * V < D) {
#pragma unroll
      for (int j = 0; j < V; ++j) ss = fmaf(xv[k].get(j), xv[k].get(j), ss);
    }
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
  TX* orow = out + row * D;
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    const int i = (lane + 32 * k) * V;
    if (i < D) {
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = xv[k].get(j) * inv * (1.0f + wv[k].get(j));
      store_piece<TX, V>(orow + i, o);
    }
  }
}

// Any D and alignment: one element per lane at a time, two reads of the row.
template <typename TX, typename TW>
__global__ void __launch_bounds__(32 * kRows)
rmsnorm_scalar_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                      TX* __restrict__ out, long long rows, int D, float eps) {
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const TX* xr = x + row * D;
  float ss = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float v = to_f(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
  TX* orow = out + row * D;
  for (int i = lane; i < D; i += 32) {
    orow[i] = from_f<TX>(to_f(xr[i]) * inv * (1.0f + to_f(w[i])));
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* out, long long rows, int D, float eps,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TX);
  const int per_block = rows < kRows ? static_cast<int>(rows) : kRows;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks)), block(32 * per_block);
  const auto ua = [](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const bool vec = D % V == 0 && ua(x, 16) && ua(out, 16) &&
                   ua(w, V * sizeof(TW) < 16 ? V * sizeof(TW) : 16);
  const int nv = (D + 32 * V - 1) / (32 * V);   // pieces per lane
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* op = static_cast<TX*>(out);
  if (vec && nv <= 2) {
    rmsnorm_kernel<TX, TW, 2><<<grid, block, 0, stream>>>(xp, wp, op, rows, D, eps);
  } else if (vec && nv <= 4) {
    rmsnorm_kernel<TX, TW, 4><<<grid, block, 0, stream>>>(xp, wp, op, rows, D, eps);
  } else if (vec && nv <= 8) {
    rmsnorm_kernel<TX, TW, 8><<<grid, block, 0, stream>>>(xp, wp, op, rows, D, eps);
  } else if (vec && nv <= 12) {
    rmsnorm_kernel<TX, TW, 12><<<grid, block, 0, stream>>>(xp, wp, op, rows, D, eps);
  } else if (vec && nv <= 16) {
    rmsnorm_kernel<TX, TW, 16><<<grid, block, 0, stream>>>(xp, wp, op, rows, D, eps);
  } else {
    rmsnorm_scalar_kernel<TX, TW><<<grid, block, 0, stream>>>(xp, wp, op, rows, D, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hydra_rmsnorm(const void* x, const void* w, void* out,
                             long long rows, int D, float eps, int x_dtype,
                             int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  if (D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == kF32 && w_dtype == kF32) return launch<float, float>(x, w, out, rows, D, eps, s);
  if (x_dtype == kF32 && w_dtype == kBF16) {
    return launch<float, __nv_bfloat16>(x, w, out, rows, D, eps, s);
  }
  if (x_dtype == kBF16 && w_dtype == kF32) {
    return launch<__nv_bfloat16, float>(x, w, out, rows, D, eps, s);
  }
  if (x_dtype == kBF16 && w_dtype == kBF16) {
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, D, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
