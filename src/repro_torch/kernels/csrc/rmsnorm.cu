// RMSNorm over the last dim: out = x * rsqrt(mean(x^2) + eps) * (1 + w),
// computed in fp32 and stored in x's dtype.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py (rmsnorm/_kernel).
// Bound on the H100: bytes. Each element of x is read twice (the second
// read hits L1/L2: a 2048-wide bf16 row is 4 KB) and written once, with
// 3 flops per element. One block per row reduces the sum of squares with
// warp shuffles and a 32-slot shared-memory pass, so no row ever round
// trips through device memory between the reduction and the scale.
#include "common.cuh"

using namespace hydra;

namespace {

constexpr int kThreads = 256;

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TX* __restrict__ out, int D, float eps) {
  const long long row = blockIdx.x;
  const TX* xr = x + row * D;
  TX* orow = out + row * D;

  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = to_f(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);

  __shared__ float part[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) part[0] = t;
  }
  __syncthreads();

  const float inv = rsqrtf(part[0] / static_cast<float>(D) + eps);
  for (int i = threadIdx.x; i < D; i += kThreads) {
    orow[i] = from_f<TX>(to_f(xr[i]) * inv * (1.0f + to_f(w[i])));
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* out, long long rows, int D,
            float eps, cudaStream_t stream) {
  rmsnorm_kernel<TX, TW><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(out), D, eps);
}

}  // namespace

extern "C" int hydra_rmsnorm(const void* x, const void* w, void* out,
                             long long rows, int D, float eps, int x_dtype,
                             int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  if (rows > 0x7fffffffLL || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == kF32 && w_dtype == kF32) {
    launch<float, float>(x, w, out, rows, D, eps, s);
  } else if (x_dtype == kF32 && w_dtype == kBF16) {
    launch<float, __nv_bfloat16>(x, w, out, rows, D, eps, s);
  } else if (x_dtype == kBF16 && w_dtype == kF32) {
    launch<__nv_bfloat16, float>(x, w, out, rows, D, eps, s);
  } else if (x_dtype == kBF16 && w_dtype == kBF16) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, D, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
