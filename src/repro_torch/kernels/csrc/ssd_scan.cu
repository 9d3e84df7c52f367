// Mamba2 SSD chunked scan (state-space duality) with the final state.
// x (B,S,H,P) and the single-group Bm/Cm (B,S,N), all in one dtype, and dt
// (B,S,H) fp32 are read in place through their strides (the last dim is
// unit stride: on the serving path x, Bm and Cm are column slices of one
// projection); A (H,) fp32; y (B,S,H,P) in x's dtype; optional init and
// final states (B,H,P,N) fp32, contiguous.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (ssd_scan/
// _kernel). The TPU kernel walks a sequential grid axis over the chunks
// with the (P, N) state in VMEM scratch. Hopper blocks run in parallel and
// carry nothing between them, so here one block per (head, batch row) loops
// over the chunks in order and keeps the state in shared memory. Per chunk:
//   a_cs = cumsum(dt * A)
//   y    = ((C B^T) o tril(exp(a_cs[l] - a_cs[s]))) (dt x)
//          + (C state^T) exp(a_cs)
//   state <- state exp(a_cs[-1]) + (dt x)^T (B exp(a_cs[-1] - a_cs))
// Positions past S read as dt = x = B = C = 0, which is the reference's
// dt=0 padding: decay 1 and no contribution, so the state stays exact.
//
// A chunk is the configured length (256 when serving). Its B and C in fp32
// would not fit in a block's 227 KB for N = 128, so the (l, s) products
// are tiled 64 x 64 inside the chunk, while a_cs is taken over the whole
// chunk first, as the reference does. The cumsum accumulates in fp64 and
// rounds each element to fp32 once, as the plain version does; fp32 sums
// in another order move y past the fp32 check at a chunk of 256. The mask
// is applied before exp: a_cs[l] - a_cs[s] is positive above the diagonal
// and never reaches expf.
//
// Bound on the H100: bytes at serving shapes (x and y dominate; the
// chunked products are ~1 GFLOP for a 500-token zamba2 layer). This first
// version does every product with scalar fp32 FMAs on CUDA cores, runs
// only B x H blocks (80 for zamba2, 48 for mamba2, of 132 SMs), recomputes
// C B^T for every head although it does not depend on the head, and reads
// each chunk's B and x twice (once for y, once for the state update).
// Those are the starting points of a faster version.
#include "common.cuh"

using namespace hydra;

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;                  // l rows and s columns of one tile
constexpr int kGStep = kThreads / kT;   // G rows per pass
constexpr int kGRows = kT / kGStep;     // G entries per thread

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* init;    // null: start from zeros
  void* y;
  float* final_state;   // null: not wanted
  int S, H, N, chunk;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  long long y_sb, y_ss, y_sh;
};

template <typename T, int P>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(SsdArgs a) {
  constexpr int kRowStep = kThreads / P;  // y rows per pass
  constexpr int kRows = kT / kRowStep;    // y rows per thread
  static_assert(kThreads % P == 0 && kT % kRowStep == 0, "P");
  extern __shared__ float smem[];
  const int S = a.S, N = a.N, NP = a.N + 1, chunk = a.chunk;
  float* st = smem;                 // (P, N+1) running state
  float* Cs = st + P * NP;          // (kT, N+1) C rows of the l tile
  float* Bs = Cs + kT * NP;         // (kT, N+1) B rows of the s tile
  float* Xs = Bs + kT * NP;         // (kT, P)   dt x of the s tile
  float* G = Xs + kT * P;           // (kT, kT+1) masked, decayed C B^T
  float* dts = G + kT * (kT + 1);   // (chunk)
  float* acs = dts + chunk;         // (chunk) cumsum of dt * A

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh;
  const float* dt = a.dt + b * a.dt_sb + h * a.dt_sh;
  const T* Bm = static_cast<const T*>(a.Bm) + b * a.b_sb;
  const T* Cm = static_cast<const T*>(a.Cm) + b * a.c_sb;
  T* y = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh;
  const float A = a.A[h];
  const long long state_off = (static_cast<long long>(b) * a.H + h) * P * N;

  for (int e = tid; e < P * N; e += kThreads) {
    st[(e / N) * NP + e % N] = a.init ? a.init[state_off + e] : 0.f;
  }

  const int p = tid % P;   // the y column this thread owns
  const int r0 = tid / P;  // its y rows: r0 + k * kRowStep
  const int gj = tid % kT; // the G column it owns
  const int gi0 = tid / kT;

  // B rows of an s tile (scaled by `decay` of their position when given)
  // and dt x rows of the same tile
  auto load_s_tile = [&](long long c0, int s0, bool decayed) {
    for (int e = tid; e < kT * N; e += kThreads) {
      const int j = e / N, n = e % N;
      const int s = s0 + j;
      const long long pos = c0 + s;
      float v = 0.f;
      if (s < chunk && pos < S) {
        v = to_f(Bm[pos * a.b_ss + n]);
        if (decayed) v = __fmul_rn(v, expf(acs[chunk - 1] - acs[s]));
      }
      Bs[j * NP + n] = v;
    }
    for (int e = tid; e < kT * P; e += kThreads) {
      const int j = e / P, pp = e % P;
      const int s = s0 + j;
      const long long pos = c0 + s;
      Xs[j * P + pp] = (s < chunk && pos < S)
          ? __fmul_rn(dts[s], to_f(x[pos * a.x_ss + pp])) : 0.f;
    }
  };

  for (long long c0 = 0; c0 < S; c0 += chunk) {
    __syncthreads();  // the previous chunk is done with dts, acs and st
    for (int l = tid; l < chunk; l += kThreads) {
      const long long pos = c0 + l;
      dts[l] = pos < S ? dt[pos * a.dt_ss] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      double run = 0.0;
      for (int l = 0; l < chunk; ++l) {
        run += static_cast<double>(__fmul_rn(dts[l], A));
        acs[l] = static_cast<float>(run);
      }
    }

    for (int l0 = 0; l0 < chunk; l0 += kT) {
      __syncthreads();  // acs is written; Cs of the last tile is consumed
      for (int e = tid; e < kT * N; e += kThreads) {
        const int i = e / N, n = e % N;
        const int l = l0 + i;
        const long long pos = c0 + l;
        Cs[i * NP + n] = (l < chunk && pos < S) ? to_f(Cm[pos * a.c_ss + n]) : 0.f;
      }
      float yd[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) yd[k] = 0.f;

      for (int s0 = 0; s0 <= l0; s0 += kT) {
        __syncthreads();  // Bs, Xs and G are free
        load_s_tile(c0, s0, false);
        __syncthreads();
        // G[i][j] = (C B^T)[l][s] * exp(a_cs[l] - a_cs[s]) for s <= l, else 0
        float g[kGRows];
#pragma unroll
        for (int k = 0; k < kGRows; ++k) g[k] = 0.f;
        for (int n = 0; n < N; ++n) {
          const float bv = Bs[gj * NP + n];
#pragma unroll
          for (int k = 0; k < kGRows; ++k) {
            g[k] = fmaf(Cs[(gi0 + k * kGStep) * NP + n], bv, g[k]);
          }
        }
        const int s = s0 + gj;
#pragma unroll
        for (int k = 0; k < kGRows; ++k) {
          const int i = gi0 + k * kGStep;
          const int l = l0 + i;
          const bool on = s <= l && l < chunk;
          G[i * (kT + 1) + gj] = on ? __fmul_rn(g[k], expf(acs[l] - acs[s])) : 0.f;
        }
        __syncthreads();
        // y_diag += G (dt x)
        for (int j = 0; j < kT; ++j) {
          const float xv = Xs[j * P + p];
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            yd[k] = fmaf(G[(r0 + k * kRowStep) * (kT + 1) + j], xv, yd[k]);
          }
        }
      }

      // y_off = (C state^T) exp(a_cs), from the state entering this chunk
      float off[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) off[k] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float sv = st[p * NP + n];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          off[k] = fmaf(Cs[(r0 + k * kRowStep) * NP + n], sv, off[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int l = l0 + r0 + k * kRowStep;
        const long long pos = c0 + l;
        if (l < chunk && pos < S) {
          const float v = __fadd_rn(yd[k], __fmul_rn(off[k], expf(acs[l])));
          y[pos * a.y_ss + p] = from_f<T>(v);
        }
      }
    }

    // state <- state exp(a_cs[-1]) + (dt x)^T (B exp(a_cs[-1] - a_cs))
    __syncthreads();  // every y_off read of st is done
    const float decay = expf(acs[chunk - 1]);
    for (int e = tid; e < P * N; e += kThreads) {
      float& v = st[(e / N) * NP + e % N];
      v = __fmul_rn(v, decay);
    }
    for (int s0 = 0; s0 < chunk; s0 += kT) {
      __syncthreads();
      load_s_tile(c0, s0, true);
      __syncthreads();
      const int js = min(kT, chunk - s0);
      for (int e = tid; e < P * N; e += kThreads) {
        const int pp = e / N, n = e % N;
        float acc = 0.f;
        for (int j = 0; j < js; ++j) acc = fmaf(Xs[j * P + pp], Bs[j * NP + n], acc);
        st[pp * NP + n] += acc;
      }
    }
  }

  if (a.final_state) {
    __syncthreads();
    for (int e = tid; e < P * N; e += kThreads) {
      a.final_state[state_off + e] = st[(e / N) * NP + e % N];
    }
  }
}

template <typename T, int P>
int launch(const SsdArgs& a, int B, size_t smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T, P><<<dim3(a.H, B), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_p(int P, const SsdArgs& a, int B, size_t smem, cudaStream_t s) {
  switch (P) {
    case 8: return launch<T, 8>(a, B, smem, s);
    case 16: return launch<T, 16>(a, B, smem, s);
    case 32: return launch<T, 32>(a, B, smem, s);
    case 64: return launch<T, 64>(a, B, smem, s);
    case 128: return launch<T, 128>(a, B, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of one block, in bytes (kernels/ssd_scan.py's
// smem_bytes() is the same sum).
long long smem_bytes(int P, int N, int chunk) {
  return 4LL * (static_cast<long long>(P) * (N + 1) + 2LL * kT * (N + 1) +
                static_cast<long long>(kT) * P + kT * (kT + 1) + 2LL * chunk);
}

}  // namespace

// Strides are in elements. init / final_state may be null.
extern "C" int hydra_ssd_scan(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* init, void* y, void* final_state, int B,
    int S, int H, int P, int N, int chunk, long long x_sb, long long x_ss,
    long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long y_sb, long long y_ss, long long y_sh, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S < 0 || N <= 0 || chunk <= 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = smem_bytes(P, N, chunk);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  SsdArgs a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
            Bm, Cm, static_cast<const float*>(init), y,
            static_cast<float*>(final_state), S, H, N, chunk,
            x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss,
            y_sb, y_ss, y_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_p<float>(P, a, B, static_cast<size_t>(smem), s);
  if (dtype == kBF16) {
    return dispatch_p<__nv_bfloat16>(P, a, B, static_cast<size_t>(smem), s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
