// Backward of RMSNorm (rmsnorm.cu): given dy, x and w, with
// r = rsqrt(mean(x^2) + eps) recomputed per row and g = dy * (1 + w),
//   dx = r * (g - x * r^2 * mean(g * x))      in x's dtype,
//   dw = sum over rows of dy * x * r           in w's dtype,
// all arithmetic in fp32.
//
// The Pallas TPU kernel repro/kernels/rmsnorm.py has no backward: the
// reference differentiates its jnp oracle (jax.value_and_grad in
// repro/models/programs.py). This is the port's counterpart of that
// gradient; its yardstick is autograd through kernels/ref.py:rmsnorm_ref.
//
// Bound on the H100: bytes (dy and x read, dx written, w read once; about
// 10 flops per element). Three launches, no float atomics, so two calls
// give the same bits:
//  1. rmsnorm_bwd_kernel, one warp per row (up to 8 rows per block, as the
//     forward): the row's sums of x^2 and g*x by warp shuffles, then dx;
//     the row's r goes to a workspace. 16-byte pieces where D is a
//     multiple of the piece and x, dy, dx are aligned to it; otherwise one
//     element per lane (odd widths). The row is read twice, the second
//     time from L1/L2; no register buckets, so every width takes one path.
//  2. rmsnorm_dw_partial_kernel: one thread per column and a fixed chunk
//     of rows per block row of the grid, writing fp32 partial column sums
//     to the workspace (the chunking depends on the shape alone).
//  3. rmsnorm_dw_final_kernel: one thread per column sums the partials in
//     chunk order and stores dw.
#include <cstdint>

#include "common.cuh"

using namespace hydra;

namespace {

constexpr int kRows = 8;          // rows (warps) per block of pass 1
constexpr int kColThreads = 256;  // columns per block of passes 2 and 3
constexpr int kTargetBlocks = 264;  // pass 2's grid: about 2 blocks per SM

template <typename T> struct Store16;
template <> struct Store16<float> {
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Store16<__nv_bfloat16> {
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 u;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <typename TX, typename TW, bool kVec>
__global__ void __launch_bounds__(32 * kRows)
rmsnorm_bwd_kernel(const TX* __restrict__ dy, const TX* __restrict__ x,
                   const TW* __restrict__ w, TX* __restrict__ dx,
                   float* __restrict__ rs, long long rows, int D, float eps) {
  constexpr int V = Vec16<TX>::N;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const TX* xr = x + row * D;
  const TX* dyr = dy + row * D;
  float ss = 0.f, sgx = 0.f;
  if (kVec) {
    for (int i = lane * V; i < D; i += 32 * V) {
      float xv[V], dv[V];
      Vec16<TX>::load(xr + i, xv);
      Vec16<TX>::load(dyr + i, dv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ss = fmaf(xv[j], xv[j], ss);
        sgx = fmaf(dv[j] * (1.0f + to_f(w[i + j])), xv[j], sgx);
      }
    }
  } else {
    for (int i = lane; i < D; i += 32) {
      const float xv = to_f(xr[i]);
      ss = fmaf(xv, xv, ss);
      sgx = fmaf(to_f(dyr[i]) * (1.0f + to_f(w[i])), xv, sgx);
    }
  }
  ss = warp_sum(ss);
  sgx = warp_sum(sgx);
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);
  const float c = r * r * (sgx / static_cast<float>(D));   // dx = r (g - x c)
  TX* dxr = dx + row * D;
  if (kVec) {
    for (int i = lane * V; i < D; i += 32 * V) {
      float xv[V], dv[V], o[V];
      Vec16<TX>::load(xr + i, xv);
      Vec16<TX>::load(dyr + i, dv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        o[j] = r * (dv[j] * (1.0f + to_f(w[i + j])) - xv[j] * c);
      }
      Store16<TX>::store(dxr + i, o);
    }
  } else {
    for (int i = lane; i < D; i += 32) {
      const float g = to_f(dyr[i]) * (1.0f + to_f(w[i]));
      dxr[i] = from_f<TX>(r * (g - to_f(xr[i]) * c));
    }
  }
  if (lane == 0) rs[row] = r;
}

// part[chunk][c] = sum over the chunk's rows of dy * x * r, in row order
template <typename TX>
__global__ void __launch_bounds__(kColThreads)
rmsnorm_dw_partial_kernel(const TX* __restrict__ dy, const TX* __restrict__ x,
                          const float* __restrict__ rs, float* __restrict__ part,
                          long long rows, int D, long long rows_per_chunk) {
  const int c = blockIdx.x * kColThreads + threadIdx.x;
  if (c >= D) return;
  const long long r0 = blockIdx.y * rows_per_chunk;
  const long long r1 = min(rows, r0 + rows_per_chunk);
  float acc = 0.f;
  for (long long row = r0; row < r1; ++row) {
    acc = fmaf(to_f(dy[row * D + c]) * to_f(x[row * D + c]), rs[row], acc);
  }
  part[static_cast<long long>(blockIdx.y) * D + c] = acc;
}

template <typename TW>
__global__ void __launch_bounds__(kColThreads)
rmsnorm_dw_final_kernel(const float* __restrict__ part, TW* __restrict__ dw,
                        int chunks, int D) {
  const int c = blockIdx.x * kColThreads + threadIdx.x;
  if (c >= D) return;
  float acc = 0.f;
  for (int k = 0; k < chunks; ++k) acc += part[static_cast<long long>(k) * D + c];
  dw[c] = from_f<TW>(acc);
}

template <typename TX, typename TW>
int launch(const void* dy, const void* x, const void* w, void* dx, void* dw,
           float* ws, long long rows, int D, float eps, cudaStream_t stream) {
  constexpr int V = Vec16<TX>::N;
  const int per_block = rows < kRows ? static_cast<int>(rows) : kRows;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto ua = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = D % V == 0 && ua(x) && ua(dy) && ua(dx);
  const TX* dyp = static_cast<const TX*>(dy);
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* dxp = static_cast<TX*>(dx);
  float* rs = ws;
  float* part = ws + rows;
  if (vec) {
    rmsnorm_bwd_kernel<TX, TW, true><<<static_cast<unsigned>(blocks), 32 * per_block, 0,
                                       stream>>>(dyp, xp, wp, dxp, rs, rows, D, eps);
  } else {
    rmsnorm_bwd_kernel<TX, TW, false><<<static_cast<unsigned>(blocks), 32 * per_block, 0,
                                        stream>>>(dyp, xp, wp, dxp, rs, rows, D, eps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // pass 2's chunking: a function of (rows, D) alone, so the sums' order
  // (and the bits of dw) never change between calls
  const int col_blocks = (D + kColThreads - 1) / kColThreads;
  long long chunks = kTargetBlocks / col_blocks;
  chunks = chunks < 1 ? 1 : chunks > rows ? rows : chunks;
  const long long rows_per_chunk = (rows + chunks - 1) / chunks;
  chunks = (rows + rows_per_chunk - 1) / rows_per_chunk;
  rmsnorm_dw_partial_kernel<TX><<<dim3(col_blocks, static_cast<unsigned>(chunks)),
                                  kColThreads, 0, stream>>>(dyp, xp, rs, part, rows, D,
                                                            rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_dw_final_kernel<TW><<<col_blocks, kColThreads, 0, stream>>>(
      part, static_cast<TW*>(dw), static_cast<int>(chunks), D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The fp32 workspace holds rows + min(rows, 264) * D floats: each row's r,
// then pass 2's partial column sums.
extern "C" long long hydra_rmsnorm_bwd_workspace(long long rows, int D) {
  return rows + (rows < kTargetBlocks ? rows : kTargetBlocks) * static_cast<long long>(D);
}

extern "C" int hydra_rmsnorm_bwd(const void* dy, const void* x, const void* w, void* dx,
                                 void* dw, void* ws, long long rows, int D, float eps,
                                 int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(ws);
  if (D <= 0 || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaMemsetAsync(dw, 0, D * (w_dtype == kF32 ? 4 : 2), s));
  if (x_dtype == kF32 && w_dtype == kF32) {
    return launch<float, float>(dy, x, w, dx, dw, f, rows, D, eps, s);
  }
  if (x_dtype == kF32 && w_dtype == kBF16) {
    return launch<float, __nv_bfloat16>(dy, x, w, dx, dw, f, rows, D, eps, s);
  }
  if (x_dtype == kBF16 && w_dtype == kF32) {
    return launch<__nv_bfloat16, float>(dy, x, w, dx, dw, f, rows, D, eps, s);
  }
  if (x_dtype == kBF16 && w_dtype == kBF16) {
    return launch<__nv_bfloat16, __nv_bfloat16>(dy, x, w, dx, dw, f, rows, D, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
