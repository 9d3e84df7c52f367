// The Mamba2 mixer's causal depthwise conv with its bias and SiLU, and the
// SSD scan's dt and A, in one launch a layer of every prefill:
//   xbc[b, s, c] = SiLU(sum_i w[i, c] x[b, s - (k-1) + i, c] + bias[c])
//                  (rows before 0 read as zeros; w and bias rounded to x's
//                  dtype, each product and partial sum too, as the plain
//                  version's eager ops round them; SiLU in fp32 as
//                  PyTorch computes it): bit for bit the plain version
//   dt[b, s, h]  = softplus(dt_in[b, s, h] + dt_bias[h]) in fp32, x past
//                  PyTorch's threshold of 20 taken as it is
//   A[h]         = -exp(A_log[h]) in fp32
//
// Replaces no TPU kernel: the JAX package's _causal_conv
// (src/repro/models/ssm.py:38) is jnp, which XLA fuses on the TPU; eager
// PyTorch ran it as ~18 launches over full-size temporaries (the padded
// copy, k products, k - 1 sums, the bias, the SiLU, then dt's and A's).
// Bound on the H100: bytes. x and dt_in are column slices of the in_proj
// output, read through their row stride (no copy, no padded tensor); xbc
// and dt are written once. Each thread owns one 16-byte piece of channels
// (8 bf16) and walks a run of kRun rows with the k - 1 rows before it in
// registers: each input element is read from device memory once, the
// k - 1 rows before a run a second time, from L2, by the run's own
// thread. The run is short and all its rows are loaded before
// the first is used, so a 2,500-token prompt puts ~2,800 blocks of loads
// in flight, four resident on an SM: longer runs over fewer threads left
// the card waiting on load latency. The last column of blocks computes
// dt over the same run of rows (and A, once).
//
// Rows whose channel count, strides or pointers do not hold whole aligned
// pieces take the same kernel with one channel a thread.
#include <cstdint>

#include "common.cuh"
#include "pieces.cuh"

using namespace hydra;

namespace {

constexpr int kThreads = 128;  // threads (pieces of channels) per block
constexpr int kRun = 8;        // rows a thread walks
constexpr int kMinBlocks = 4;  // resident blocks an SM is built for (<= 128 registers)
constexpr int kMaxK = 8;       // conv widths the kernel is built for

struct ConvArgs {
  const void* x;        // (B, S, C) of dtype T, channel stride 1
  const void* dt;       // (B, S, H), channel stride 1
  const void* w;        // (k, C) contiguous
  const void* bias;     // (C,)
  const void* dt_bias;  // (H,)
  const void* A_log;    // (H,)
  void* out;            // (B, S, C) of T, contiguous
  float* dt_out;        // (B, S, H) contiguous
  float* A_out;         // (H,)
  long long x_sb, x_ss, dt_sb, dt_ss;  // batch and row strides (elements)
  int S, C, H;
  int dt_dtype, w_dtype, bias_dtype, dt_bias_dtype, A_log_dtype;
};

__device__ void dt_and_A(const ConvArgs& a, int b, int s0, int s1) {
  const int n = (s1 - s0) * a.H;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int s = s0 + i / a.H, h = i % a.H;
    const float v = load_any(a.dt, a.dt_dtype, b * a.dt_sb + s * a.dt_ss + h) +
                    load_any(a.dt_bias, a.dt_bias_dtype, h);
    a.dt_out[(static_cast<long long>(b) * a.S + s) * a.H + h] =
        v > 20.0f ? v : log1pf(expf(v));
  }
  if (blockIdx.y == 0 && b == 0) {
    for (int h = threadIdx.x; h < a.H; h += blockDim.x) {
      a.A_out[h] = -expf(load_any(a.A_log, a.A_log_dtype, h));
    }
  }
}

template <typename T, int V, int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks) mamba_conv_kernel(const ConvArgs a) {
  const int b = blockIdx.z;
  const int s0 = blockIdx.y * kRun;
  const int s1 = min(a.S, s0 + kRun);
  if (blockIdx.x == gridDim.x - 1) {
    dt_and_A(a, b, s0, s1);
    return;
  }
  const int c = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (c >= a.C) return;
  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + c;
  T* out = static_cast<T*>(a.out) + static_cast<long long>(b) * a.S * a.C + c;

  float w[K][V], bias[V];
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      w[i][j] = round_to<T>(load_any(a.w, a.w_dtype, static_cast<long long>(i) * a.C + c + j));
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) bias[j] = round_to<T>(load_any(a.bias, a.bias_dtype, c + j));

  // the run's rows and the k - 1 before it (zeros before row 0), all
  // loaded before any is used; row s0 + u reads the window raw[u .. u+K-1]
  Raw<T, V> raw[K - 1 + kRun];
#pragma unroll
  for (int u = 0; u < K - 1 + kRun; ++u) {
    const int s = s0 - (K - 1) + u;
    if (s < 0) {
      raw[u] = Raw<T, V>{};
    } else if (s < s1) {
      raw[u] = load_raw<T, V>(x + s * a.x_ss);
    }
  }
  // The plain version's rounding points: each product and each partial
  // sum (in tap order, then the bias) rounded to T, as PyTorch's eager
  // ops round them, never fused into a multiply-add; SiLU in fp32 as
  // PyTorch computes it, rounded once. A 16-byte bf16 piece runs them two
  // lanes an instruction (the _rn bf16x2 multiply and add round the exact
  // result once, as the fp32 op and its rounding do).
  constexpr bool kPacked = std::is_same<T, __nv_bfloat16>::value && V == 8;
  constexpr int kPairs = kPacked ? V / 2 : 1;
  __nv_bfloat162 w2[K][kPairs], b2[kPairs];
  if constexpr (kPacked) {
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
#pragma unroll
      for (int i = 0; i < K; ++i) w2[i][q] = __floats2bfloat162_rn(w[i][2 * q], w[i][2 * q + 1]);
      b2[q] = __floats2bfloat162_rn(bias[2 * q], bias[2 * q + 1]);
    }
  }
#pragma unroll
  for (int u = 0; u < kRun; ++u) {
    if (s0 + u < s1) {
      float o[V];
      if constexpr (kPacked) {
#pragma unroll
        for (int q = 0; q < kPairs; ++q) {
          __nv_bfloat162 acc = __hmul2_rn(w2[0][q], pair(raw[u], q));
#pragma unroll
          for (int i = 1; i < K; ++i) {
            acc = __hadd2_rn(acc, __hmul2_rn(w2[i][q], pair(raw[u + i], q)));
          }
          const float2 f = __bfloat1622float2(__hadd2_rn(acc, b2[q]));
          o[2 * q] = silu(f.x);
          o[2 * q + 1] = silu(f.y);
        }
      } else {
        float acc[V];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = 0.0f;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          float in[V];
          unpack<T, V>(raw[u + i], in);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            acc[j] = round_to<T>(__fadd_rn(acc[j], round_to<T>(__fmul_rn(w[i][j], in[j]))));
          }
        }
#pragma unroll
        for (int j = 0; j < V; ++j) o[j] = silu(round_to<T>(__fadd_rn(acc[j], bias[j])));
      }
      store_vals<T, V>(out + static_cast<long long>(s0 + u) * a.C, o);
    }
  }
}

template <typename T, int V, int K>
int launch_k(const ConvArgs& a, int B, cudaStream_t stream) {
  const int pieces = (a.C + V - 1) / V;
  const dim3 grid((pieces + kThreads - 1) / kThreads + 1, (a.S + kRun - 1) / kRun, B);
  mamba_conv_kernel<T, V, K><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_v(const ConvArgs& a, int B, int k, cudaStream_t stream) {
  switch (k) {
    case 1: return launch_k<T, V, 1>(a, B, stream);
    case 2: return launch_k<T, V, 2>(a, B, stream);
    case 3: return launch_k<T, V, 3>(a, B, stream);
    case 4: return launch_k<T, V, 4>(a, B, stream);
    case 5: return launch_k<T, V, 5>(a, B, stream);
    case 6: return launch_k<T, V, 6>(a, B, stream);
    case 7: return launch_k<T, V, 7>(a, B, stream);
    case 8: return launch_k<T, V, 8>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(const ConvArgs& a, int B, int k, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = a.C % V == 0 && a.x_sb % V == 0 && a.x_ss % V == 0 && aligned(a.x) &&
                   aligned(a.out);
  return vec ? launch_v<T, V>(a, B, k, stream) : launch_v<T, 1>(a, B, k, stream);
}

}  // namespace

extern "C" int hydra_mamba_conv(const void* x, const void* dt, const void* w, const void* bias,
                                const void* dt_bias, const void* A_log, void* out, void* dt_out,
                                void* A_out, long long x_sb, long long x_ss, long long dt_sb,
                                long long dt_ss, int B, int S, int C, int H, int k, int x_dtype,
                                int dt_dtype, int w_dtype, int bias_dtype, int dt_bias_dtype,
                                int A_log_dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (C <= 0 || H <= 0 || k < 1 || k > kMaxK || B > 65535 || (S + kRun - 1) / kRun > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ConvArgs a{x, dt, w, bias, dt_bias, A_log, out, static_cast<float*>(dt_out),
                   static_cast<float*>(A_out), x_sb, x_ss, dt_sb, dt_ss, S, C, H,
                   dt_dtype, w_dtype, bias_dtype, dt_bias_dtype, A_log_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32) return launch<float>(a, B, k, s);
  if (x_dtype == kBF16) return launch<__nv_bfloat16>(a, B, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
