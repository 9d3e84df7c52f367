// The Mamba2 mixer's D skip and gated RMSNorm, per row and B/C group, in
// one launch a layer of every prefill and decode step:
//   g   = (y + D[head] x) * SiLU(z)
//   out = g * rsqrt(mean over the group's channels of g^2 + eps) * (1 + w)
//         rounded once to y's dtype
// with D, D x and y + D x rounded to y's dtype as the plain version's
// eager ops round them, the rest in fp32, and each of the G groups'
// d_inner / G channels normalised on their own (Zamba2's RMSNormGated;
// one group is Mamba2's).
//
// Replaces no TPU kernel: the JAX package's _gated_norm
// (src/repro/models/ssm.py:55) and its D skip are jnp, which XLA fuses on
// the TPU; eager PyTorch ran them as ~16 launches over fp32 copies of y
// and z. Bound on the H100: bytes (y, x, z read once, out written once).
// One CTA per (row, group) holds the group's channels in registers, each
// thread NV 16-byte pieces (y, x and z loaded before any is used), reduces
// the sum of squares with warp shuffles and one shared-memory step, and
// scales the values still in registers. x and z are column slices of the
// conv and in_proj outputs, read through their row strides.
//
// Groups wider than the register buckets hold, and rows whose width,
// head size, strides or pointers do not hold whole aligned pieces, take
// the scalar variant: one channel a thread at a time, the row's values
// read a second time (from L2) for the scale.
#include <cstdint>

#include "common.cuh"
#include "pieces.cuh"

using namespace hydra;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kScalarThreads = 256;

struct GateArgs {
  const void* y;   // (rows, din) of T, row stride y_rs, channel stride 1
  const void* x;   // (rows, din) of T, row stride x_rs
  const void* z;   // (rows, din) of T, row stride z_rs
  const void* D;   // (H,)
  const void* w;   // (din,) contiguous
  void* out;       // (rows, din) of T, contiguous
  long long y_rs, x_rs, z_rs;
  int din, P, groups;  // P = din / H channels a head
  int D_dtype;
  float eps;
};

// y + D x with the plain version's rounding points: the product, then
// the sum, each rounded to T (PyTorch's eager ops in the model dtype)
template <typename T>
__device__ __forceinline__ float skip(float y, float d, float x) {
  return round_to<T>(__fadd_rn(y, round_to<T>(__fmul_rn(d, x))));
}

// the sum of v over the block, in every thread (blockDim.x a multiple of 32)
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[32];
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) part[warp] = v;
  __syncthreads();
  float t = 0.0f;
  for (int i = 0; i < nwarps; ++i) t += part[i];
  return t;
}

template <typename T, typename TW, int V, int NV>
__global__ void __launch_bounds__(kMaxThreads) mamba_gate_kernel(const GateArgs a) {
  const long long row = blockIdx.x / a.groups;
  const int W = a.din / a.groups;
  const int base = (blockIdx.x % a.groups) * W;  // the group's first channel
  const T* y = static_cast<const T*>(a.y) + row * a.y_rs + base;
  const T* x = static_cast<const T*>(a.x) + row * a.x_rs + base;
  const T* z = static_cast<const T*>(a.z) + row * a.z_rs + base;

  Raw<T, V> ry[NV], rx[NV], rz[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = (threadIdx.x + k * blockDim.x) * V;
    if (i < W) {
      ry[k] = load_raw<T, V>(y + i);
      rx[k] = load_raw<T, V>(x + i);
      rz[k] = load_raw<T, V>(z + i);
    }
  }
  float g[NV][V];
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = (threadIdx.x + k * blockDim.x) * V;
    if (i < W) {
      // a piece lies in one head: P is a multiple of V on this path
      const float d = round_to<T>(load_any(a.D, a.D_dtype, (base + i) / a.P));
      float yv[V], xv[V], zv[V];
      unpack<T, V>(ry[k], yv);
      unpack<T, V>(rx[k], xv);
      unpack<T, V>(rz[k], zv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        g[k][j] = skip<T>(yv[j], d, xv[j]) * silu(zv[j]);
        ss = fmaf(g[k][j], g[k][j], ss);
      }
    }
  }
  const float inv = rsqrtf(block_sum(ss) / static_cast<float>(W) + a.eps);
  const TW* w = static_cast<const TW*>(a.w) + base;
  T* out = static_cast<T*>(a.out) + row * a.din + base;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = (threadIdx.x + k * blockDim.x) * V;
    if (i < W) {
      float wv[V], o[V];
      load_vals<TW, V>(w + i, wv);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = g[k][j] * inv * (1.0f + wv[j]);
      store_vals<T, V>(out + i, o);
    }
  }
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kScalarThreads) mamba_gate_scalar_kernel(const GateArgs a) {
  const long long row = blockIdx.x / a.groups;
  const int W = a.din / a.groups;
  const int base = (blockIdx.x % a.groups) * W;
  const T* y = static_cast<const T*>(a.y) + row * a.y_rs;
  const T* x = static_cast<const T*>(a.x) + row * a.x_rs;
  const T* z = static_cast<const T*>(a.z) + row * a.z_rs;
  const auto gated = [&](int c) {
    const float d = round_to<T>(load_any(a.D, a.D_dtype, c / a.P));
    return skip<T>(to_f(y[c]), d, to_f(x[c])) * silu(to_f(z[c]));
  };
  float ss = 0.0f;
  for (int c = base + threadIdx.x; c < base + W; c += blockDim.x) {
    const float v = gated(c);
    ss = fmaf(v, v, ss);
  }
  const float inv = rsqrtf(block_sum(ss) / static_cast<float>(W) + a.eps);
  const TW* w = static_cast<const TW*>(a.w);
  T* out = static_cast<T*>(a.out) + row * a.din;
  for (int c = base + threadIdx.x; c < base + W; c += blockDim.x) {
    out[c] = from_f<T>(gated(c) * inv * (1.0f + to_f(w[c])));
  }
}

template <typename T, typename TW>
int launch(const GateArgs& a, long long rows, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const auto aligned = [](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const int W = a.din / a.groups;
  const int wbytes = V * sizeof(TW) < 16 ? V * sizeof(TW) : 16;
  const bool vec = W % V == 0 && a.P % V == 0 && a.y_rs % V == 0 && a.x_rs % V == 0 &&
                   a.z_rs % V == 0 && aligned(a.y, 16) && aligned(a.x, 16) &&
                   aligned(a.z, 16) && aligned(a.out, 16) && aligned(a.w, wbytes);
  const long long blocks = rows * a.groups;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int pieces = W / V;
  const auto threads = [&](int nv) { return ((pieces + nv - 1) / nv + 31) / 32 * 32; };
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec && threads(1) <= 256) {
    mamba_gate_kernel<T, TW, V, 1><<<grid, threads(1), 0, stream>>>(a);
  } else if (vec && threads(2) <= 256) {
    mamba_gate_kernel<T, TW, V, 2><<<grid, threads(2), 0, stream>>>(a);
  } else if (vec && threads(4) <= kMaxThreads) {
    mamba_gate_kernel<T, TW, V, 4><<<grid, threads(4), 0, stream>>>(a);
  } else {
    mamba_gate_scalar_kernel<T, TW><<<grid, kScalarThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hydra_mamba_gate(const void* y, const void* x, const void* z, const void* D,
                                const void* w, void* out, long long y_rs, long long x_rs,
                                long long z_rs, long long rows, int din, int H, int groups,
                                float eps, int dtype, int w_dtype, int D_dtype, void* stream) {
  if (rows <= 0) return 0;
  if (din <= 0 || H <= 0 || groups <= 0 || din % groups != 0 || din % H != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GateArgs a{y, x, z, D, w, out, y_rs, x_rs, z_rs, din, din / H, groups, D_dtype, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && w_dtype == kF32) return launch<float, float>(a, rows, s);
  if (dtype == kF32 && w_dtype == kBF16) return launch<float, __nv_bfloat16>(a, rows, s);
  if (dtype == kBF16 && w_dtype == kF32) return launch<__nv_bfloat16, float>(a, rows, s);
  if (dtype == kBF16 && w_dtype == kBF16) {
    return launch<__nv_bfloat16, __nv_bfloat16>(a, rows, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
