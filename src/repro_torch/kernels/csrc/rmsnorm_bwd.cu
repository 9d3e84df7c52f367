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
// Bound on the H100: bytes (dy and x read, dx written, w read once and dw
// written; about 12 flops per element). So the design reads dy and x from
// device memory once, for dx and dw both, in one kernel:
//  1. rmsnorm_bwd_rows_kernel: block k owns a fixed chunk of rows, fixed by
//     (rows, D) alone. Its 256 threads lie across the row (thread t holds
//     the 16-byte pieces t, t + 256, ... of every row, so a row of 2,048
//     bf16 is one piece a thread and one of 8,192 is four); it loads up to
//     four rows at once into registers, takes each row's sums of x^2 and
//     g*x by warp shuffles and one exchange between the 8 warps in shared
//     memory, writes dx, and adds dy * x * r to the thread's own columns of
//     the chunk's dw sum in registers (rows in order). It ends by writing
//     that sum as the block's fp32 partial row. A thread across the row,
//     not a warp per row (as the forward has): a lane of a warp per row would
//     carry D / 32 column sums (64 at d 2048, 256 at d 8192) beside the row
//     itself; a thread across the row carries D / 256, so the row and the
//     sums fit registers at every width up to 8,192 bf16.
//     Widths that are not whole pieces, unaligned pointers and rows wider
//     than four pieces a thread take its scalar variant: one row at a
//     time, an element a thread, the row read a second time from L1/L2
//     for dx, the dw sums in shared memory (each column one thread's).
//  2. rmsnorm_dw_final_kernel: 32 warps a block of 32 columns: warp w sums
//     the partials of blocks w, w + 32, ... in order, then the 32 sums are
//     added in warp order, and dw is stored.
// Two launches, no float atomics, and every sum in an order fixed by the
// shape, so two calls give the same bits.
#include <cstdint>

#include "common.cuh"

using namespace hydra;

namespace {

constexpr int kThreads = 256;      // threads across a row, per block
constexpr int kWarps = kThreads / 32;
constexpr int kFinalWarps = 32;    // warps splitting a column's partials
constexpr int kTargetBlocks = 264; // about 2 blocks per SM
constexpr int kMaxPieces = 4;      // 16-byte pieces a thread holds of a row

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

// Sums (a[i], b[i]) over the block for each of N rows: warp shuffles, then
// the 8 warps' values through shared memory `red` (double-buffered by the
// caller, so one __syncthreads a batch suffices), added in warp order.
template <int N>
__device__ __forceinline__ void block_sum2(float (&a)[N], float (&b)[N],
                                           float (*red)[kWarps][2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a[i] = warp_sum(a[i]);
    b[i] = warp_sum(b[i]);
    if (lane == 0) {
      red[i][warp][0] = a[i];
      red[i][warp][1] = b[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sa += red[i][w][0];
      sb += red[i][w][1];
    }
    a[i] = sa;
    b[i] = sb;
  }
}

// NP pieces a thread, RB rows a batch
template <typename TX, typename TW, int NP, int RB>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_rows_kernel(const TX* __restrict__ dy, const TX* __restrict__ x,
                        const TW* __restrict__ w, TX* __restrict__ dx,
                        float* __restrict__ part, long long rows, int D,
                        long long rows_per_block, float eps) {
  constexpr int V = Vec16<TX>::N;
  __shared__ float red[2][RB][kWarps][2];
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  const int t = threadIdx.x;
  // this thread's columns: pieces c = (p * 256 + t) * V, where c < D
  float w1[NP][V], acc[NP][V];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int c = (p * kThreads + t) * V;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      w1[p][j] = c < D ? 1.0f + to_f(w[c + j]) : 0.f;
      acc[p][j] = 0.f;
    }
  }
  const float inv_d = 1.0f / static_cast<float>(D);
  int buf = 0;
  for (long long row = r0; row < r1; row += RB, buf ^= 1) {
    float xv[RB][NP][V], dv[RB][NP][V], ss[RB], sgx[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int c = (p * kThreads + t) * V;
        if (row + i < r1 && c < D) {
          Vec16<TX>::load(x + (row + i) * D + c, xv[i][p]);
          Vec16<TX>::load(dy + (row + i) * D + c, dv[i][p]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) xv[i][p][j] = dv[i][p][j] = 0.f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      ss[i] = sgx[i] = 0.f;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          ss[i] = fmaf(xv[i][p][j], xv[i][p][j], ss[i]);
          sgx[i] = fmaf(dv[i][p][j] * w1[p][j], xv[i][p][j], sgx[i]);
        }
      }
    }
    block_sum2<RB>(ss, sgx, red[buf]);
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      if (row + i >= r1) break;
      const float r = rsqrtf(ss[i] * inv_d + eps);
      const float cc = r * r * (sgx[i] * inv_d);   // dx = r (g - x cc)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int c = (p * kThreads + t) * V;
        if (c >= D) continue;
        float o[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          o[j] = r * (dv[i][p][j] * w1[p][j] - xv[i][p][j] * cc);
          acc[p][j] = fmaf(dv[i][p][j] * xv[i][p][j], r, acc[p][j]);
        }
        Store16<TX>::store(dx + (row + i) * D + c, o);
      }
    }
  }
  float* out = part + static_cast<long long>(blockIdx.x) * D;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int c = (p * kThreads + t) * V;
    if (c < D) Store16<float>::store(out + c, acc[p]);
    if (V == 8 && c < D) Store16<float>::store(out + c + 4, acc[p] + 4);
  }
}

// The scalar variant: a row at a time, an element a thread; the dw sums in
// shared memory (D floats, column c held by thread c % 256 alone).
template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_scalar_kernel(const TX* __restrict__ dy, const TX* __restrict__ x,
                          const TW* __restrict__ w, TX* __restrict__ dx,
                          float* __restrict__ part, long long rows, int D,
                          long long rows_per_block, float eps) {
  extern __shared__ float dws[];
  __shared__ float red[2][1][kWarps][2];
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  const int t = threadIdx.x;
  for (int c = t; c < D; c += kThreads) dws[c] = 0.f;
  const float inv_d = 1.0f / static_cast<float>(D);
  int buf = 0;
  for (long long row = r0; row < r1; ++row, buf ^= 1) {
    const TX* xr = x + row * D;
    const TX* dyr = dy + row * D;
    float ss[1] = {0.f}, sgx[1] = {0.f};
    for (int c = t; c < D; c += kThreads) {
      const float xv = to_f(xr[c]);
      ss[0] = fmaf(xv, xv, ss[0]);
      sgx[0] = fmaf(to_f(dyr[c]) * (1.0f + to_f(w[c])), xv, sgx[0]);
    }
    block_sum2<1>(ss, sgx, red[buf]);
    const float r = rsqrtf(ss[0] * inv_d + eps);
    const float cc = r * r * (sgx[0] * inv_d);
    TX* dxr = dx + row * D;
    for (int c = t; c < D; c += kThreads) {
      const float xv = to_f(xr[c]), dv = to_f(dyr[c]);
      dxr[c] = from_f<TX>(r * (dv * (1.0f + to_f(w[c])) - xv * cc));
      dws[c] = fmaf(dv * xv, r, dws[c]);
    }
  }
  float* out = part + static_cast<long long>(blockIdx.x) * D;
  for (int c = t; c < D; c += kThreads) out[c] = dws[c];
}

// dw[c] = the sum of the blocks' partials part[k][c]: warp w of a block of
// 32 columns sums k = w, w + 32, w + 64, ... in order, then warp 0 adds the
// 32 warps' sums in warp order. The order is the shape's, so are the bits.
// A thread a column would be one chain of up to 264 dependent loads and
// adds on 8 blocks: latency, at the training rows slower than the rows.
template <typename TW>
__global__ void __launch_bounds__(32 * kFinalWarps)
rmsnorm_dw_final_kernel(const float* __restrict__ part, TW* __restrict__ dw,
                        int blocks, int D) {
  __shared__ float sums[kFinalWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < D) {
#pragma unroll 4
    for (int k = warp; k < blocks; k += kFinalWarps) {
      acc += part[static_cast<long long>(k) * D + c];
    }
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < D) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kFinalWarps; ++w) t += sums[w][lane];
    dw[c] = from_f<TW>(t);
  }
}

// the row chunking: a function of (rows, D) alone, so the sums' order (and
// the bits of dw) never change between calls
long long rows_per_block(long long rows) {
  const long long blocks = rows < kTargetBlocks ? rows : kTargetBlocks;
  return (rows + blocks - 1) / blocks;
}

template <typename TX, typename TW, int NP>
void launch_rows(const TX* dy, const TX* x, const TW* w, TX* dx, float* part,
                 long long rows, int D, long long rpb, unsigned blocks, float eps,
                 cudaStream_t s) {
  constexpr int RB = NP == 1 ? 4 : NP == 2 ? 2 : 1;
  rmsnorm_bwd_rows_kernel<TX, TW, NP, RB><<<blocks, kThreads, 0, s>>>(dy, x, w, dx, part,
                                                                     rows, D, rpb, eps);
}

template <typename TX, typename TW>
int launch(const void* dy, const void* x, const void* w, void* dx, void* dw,
           float* part, long long rows, int D, float eps, cudaStream_t stream) {
  constexpr int V = Vec16<TX>::N;
  const long long rpb = rows_per_block(rows);
  const long long blocks = (rows + rpb - 1) / rpb;
  const auto ua = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int pieces = (D / V + kThreads - 1) / kThreads;
  const bool vec = D % V == 0 && ua(x) && ua(dy) && ua(dx) && pieces <= kMaxPieces;
  const TX* dyp = static_cast<const TX*>(dy);
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* dxp = static_cast<TX*>(dx);
  const unsigned nb = static_cast<unsigned>(blocks);
  if (vec) {
    switch (pieces) {
      case 1: launch_rows<TX, TW, 1>(dyp, xp, wp, dxp, part, rows, D, rpb, nb, eps, stream); break;
      case 2: launch_rows<TX, TW, 2>(dyp, xp, wp, dxp, part, rows, D, rpb, nb, eps, stream); break;
      case 3: launch_rows<TX, TW, 3>(dyp, xp, wp, dxp, part, rows, D, rpb, nb, eps, stream); break;
      default: launch_rows<TX, TW, 4>(dyp, xp, wp, dxp, part, rows, D, rpb, nb, eps, stream); break;
    }
  } else {
    const int smem = D * 4;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(rmsnorm_bwd_scalar_kernel<TX, TW>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    rmsnorm_bwd_scalar_kernel<TX, TW><<<nb, kThreads, smem, stream>>>(dyp, xp, wp, dxp, part,
                                                                      rows, D, rpb, eps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_dw_final_kernel<TW><<<(D + 31) / 32, 32 * kFinalWarps, 0, stream>>>(
      part, static_cast<TW*>(dw), nb, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The fp32 workspace holds blocks * D floats, blocks = ceil(rows / rows per
// block): each block's partial column sums of dw.
extern "C" long long hydra_rmsnorm_bwd_workspace(long long rows, int D) {
  if (rows <= 0) return 0;
  const long long rpb = rows_per_block(rows);
  return (rows + rpb - 1) / rpb * static_cast<long long>(D);
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
