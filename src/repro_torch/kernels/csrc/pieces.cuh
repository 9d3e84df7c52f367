// A thread's piece of a row: V consecutive values of T, loaded and stored
// in one 16-byte access where V * sizeof(T) is 16 (the caller guarantees
// the alignment), one value at a time where V is 1. Used by the Mamba2
// mixer's elementwise kernels (mamba_conv.cu, mamba_gate.cu).
#pragma once

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace hydra {

// V values of T as one load brings them: a uint4 for a 16-byte piece
template <typename T, int V>
using Raw = typename std::conditional<V == 1, T, uint4>::type;

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* p) {
  static_assert(V == 1 || V * sizeof(T) == 16, "a piece is 16 bytes or one value");
  return *reinterpret_cast<const Raw<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const Raw<T, V>& r, float (&o)[V]) {
  if constexpr (V == 1) {
    o[0] = to_f(r);
  } else if constexpr (std::is_same<T, float>::value) {
    o[0] = __uint_as_float(r.x);
    o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z);
    o[3] = __uint_as_float(r.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
}

// V values of T at p in fp32, in as few aligned loads as V * sizeof(T)
// allows (the caller guarantees p's alignment to min(16, V * sizeof(T)))
template <typename T, int V>
__device__ __forceinline__ void load_vals(const T* p, float (&o)[V]) {
  if constexpr (std::is_same<T, float>::value && V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      o[4 * q] = t.x;
      o[4 * q + 1] = t.y;
      o[4 * q + 2] = t.z;
      o[4 * q + 3] = t.w;
    }
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value && V % 8 == 0) {
#pragma unroll
    for (int q = 0; q < V / 8; ++q) {
      float f[8];
      unpack<T, 8>(reinterpret_cast<const uint4*>(p)[q], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[8 * q + j] = f[j];
    }
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value && V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const uint2 t = reinterpret_cast<const uint2*>(p)[q];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
      const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
      o[4 * q] = a.x;
      o[4 * q + 1] = a.y;
      o[4 * q + 2] = b.x;
      o[4 * q + 3] = b.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = to_f(p[j]);
  }
}

// V fp32 values rounded once to T (round to nearest even) and stored at p
template <typename T, int V>
__device__ __forceinline__ void store_vals(T* p, const float (&o)[V]) {
  if constexpr (V == 1) {
    *p = from_f<T>(o[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(V == 4, "a 16-byte piece of fp32 is 4 values");
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
    static_assert(V == 8, "a 16-byte piece of bf16 is 8 values");
    uint4 u;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// word q (0-3) of a 16-byte bf16 piece as a bf16x2 pair
__device__ __forceinline__ __nv_bfloat162 pair(const uint4& r, int q) {
  const uint32_t u = q == 0 ? r.x : q == 1 ? r.y : q == 2 ? r.z : r.w;
  __nv_bfloat162 h;
  memcpy(&h, &u, sizeof(h));
  return h;
}

// one value of a small parameter (a bias, a per-head scalar) of either
// dtype, chosen at run time: a uniform branch, off the bandwidth path
__device__ __forceinline__ float load_any(const void* p, int dtype, long long i) {
  return dtype == kF32 ? static_cast<const float*>(p)[i]
                       : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// v * sigmoid(v) as PyTorch's eager SiLU computes it in fp32 (accurate
// exp, IEEE divide), so a result rounded to bf16 rounds as the plain
// version's does: over a deep model, one-ulp flips compound into logits
// that no longer track the plain path's
__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

}  // namespace hydra
