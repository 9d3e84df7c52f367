// Flash-decode: one query token per row against a (partially filled) KV
// cache. q (B,Hq,hd); k/v caches (B,S,Hkv,hd) read through their strides;
// lengths (B,) int32 in device memory; out (B,Hq,hd).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention/_kernel). The TPU kernel prefetches the lengths as
// scalars and walks KV blocks in a sequential grid; here one block serves
// the `group` query heads that share one KV head (grid (B, Hkv)), reads its
// row's length from device memory (no host sync), and loops only over the
// keys the row can see, [max(0, length - window), min(length, S)). Its four
// warps split those keys and merge their (m, l, acc) in shared memory.
//
// Bound on the H100: bytes. Each visible K/V row is read once for all
// `group` heads of its KV head (the GQA reuse), at 2*group flops per
// element, far below the card's flops-per-byte balance. This first version
// leaves most SMs idle at serving batch sizes (B*Hkv blocks); splitting
// the KV axis across blocks with a combine pass is the next step.
//
// Edges reproduced from the reference oracle (repro/kernels/ref.py):
// `length > S` attends all S keys while the window mask uses the unclamped
// length; a row with no visible key (length == 0, or a window past S)
// returns the uniform mean of V over all S rows, which is what a softmax
// over all -1e30 logits gives.
#include "common.cuh"

using namespace hydra;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kGMax = 16;  // query heads per KV head served by one block

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ o, int S, int group, long long q_sb,
              long long q_sh, Strides ks, Strides vs, long long o_sb,
              long long o_sh, float scale, long long window) {
  constexpr int DPL = (HD + 31) / 32;
  constexpr int VN = Vec16<T>::N;
  __shared__ float Qs[kGMax][HD];
  __shared__ float Ms[kWarps][kGMax];
  __shared__ float Ls[kWarps][kGMax];
  __shared__ float As[kWarps][kGMax][HD];

  const int b = blockIdx.x;
  const int hk = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const long long length = lengths[b];
  long long lo = 0;
  long long hi = min(length, static_cast<long long>(S));
  if (window > 0) lo = max(0LL, length - window);
  const bool uniform = lo >= hi;
  if (uniform) {
    lo = 0;
    hi = S;
  }

  const float sc = round_to<T>(scale);
  for (int e = tid; e < group * HD; e += kThreads) {
    const int g = e / HD, d = e % HD;
    const int h = hk * group + g;
    Qs[g][d] = round_to<T>(to_f(q[b * q_sb + h * q_sh + d]) * sc);
  }
  __syncthreads();

  float m[kGMax], l[kGMax], acc[kGMax][DPL];
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  for (long long k0 = lo + warp * 32; k0 < hi; k0 += kThreads) {
    const long long kpos = k0 + lane;
    const bool valid = kpos < hi;

    // scores: lane j holds key k0 + j against every head of the group
    float s[kGMax];
#pragma unroll
    for (int g = 0; g < kGMax; ++g) s[g] = 0.f;
    if (valid && !uniform) {
      const T* krow = kb + kpos * ks.s;
#pragma unroll 2
      for (int d0 = 0; d0 < HD; d0 += VN) {
        float kd[VN];
        Vec16<T>::load(krow + d0, kd);
#pragma unroll
        for (int u = 0; u < VN; ++u) {
#pragma unroll
          for (int g = 0; g < kGMax; ++g) {
            if (g < group) s[g] = fmaf(Qs[g][d0 + u], kd[u], s[g]);
          }
        }
      }
    }

    float p[kGMax];
#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      if (g < group) {
        const float sg = valid ? s[g] : kNegInf;
        const float m_new = fmaxf(m[g], warp_max(sg));
        p[g] = expf(sg - m_new);
        const float alpha = expf(m[g] - m_new);
        l[g] = alpha * l[g] + warp_sum(p[g]);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
        m[g] = m_new;
      }
    }

    // PV: lane owns head dims lane, lane+32, ...; p of key j comes from lane j
    const int nkeys = static_cast<int>(min(32LL, hi - k0));
    for (int j = 0; j < nkeys; ++j) {
      const T* vrow = vb + (k0 + j) * vs.s;
      float vd[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        vd[i] = d < HD ? to_f(vrow[d]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kGMax; ++g) {
        if (g < group) {
          const float pj = __shfl_sync(kFullMask, p[g], j);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[g][i] = fmaf(pj, vd[i], acc[g][i]);
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    if (g < group) {
      if (lane == 0) {
        Ms[warp][g] = m[g];
        Ls[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < HD) As[warp][g][d] = acc[g][i];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < group * HD; e += kThreads) {
    const int g = e / HD, d = e % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, Ms[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(Ms[w][g] - mx);
      lsum = fmaf(Ls[w][g], f, lsum);
      a = fmaf(As[w][g][d], f, a);
    }
    const int h = hk * group + g;
    o[b * o_sb + h * o_sh + d] = from_f<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, const int* lengths,
            void* o, int B, int S, int Hkv, int group, long long q_sb,
            long long q_sh, Strides ks, Strides vs, long long o_sb,
            long long o_sh, float scale, long long window,
            cudaStream_t stream) {
  const dim3 grid(B, Hkv);
  decode_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), S, group, q_sb,
      q_sh, ks, vs, o_sb, o_sh, scale, window);
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const int* lengths, void* o, int B, int S, int Hkv, int group,
                long long q_sb, long long q_sh, Strides ks, Strides vs,
                long long o_sb, long long o_sh, float scale, long long window,
                cudaStream_t s) {
  switch (hd) {
    case 8: launch<T, 8>(q, k, v, lengths, o, B, S, Hkv, group, q_sb, q_sh, ks, vs, o_sb, o_sh, scale, window, s); break;
    case 16: launch<T, 16>(q, k, v, lengths, o, B, S, Hkv, group, q_sb, q_sh, ks, vs, o_sb, o_sh, scale, window, s); break;
    case 32: launch<T, 32>(q, k, v, lengths, o, B, S, Hkv, group, q_sb, q_sh, ks, vs, o_sb, o_sh, scale, window, s); break;
    case 64: launch<T, 64>(q, k, v, lengths, o, B, S, Hkv, group, q_sb, q_sh, ks, vs, o_sb, o_sh, scale, window, s); break;
    case 128: launch<T, 128>(q, k, v, lengths, o, B, S, Hkv, group, q_sb, q_sh, ks, vs, o_sb, o_sh, scale, window, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window <= 0 means no window. Strides are in elements.
extern "C" int hydra_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    int B, int S, int Hq, int Hkv, int hd, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_sh,
    float scale, long long window, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kGMax || Hkv > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = Hq / Hkv;
  if (dtype == kF32) {
    return dispatch_hd<float>(hd, q, k, v, lens, o, B, S, Hkv, group, q_sb,
                              q_sh, ks, vs, o_sb, o_sh, scale, window, s);
  }
  if (dtype == kBF16) {
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, lens, o, B, S, Hkv, group,
                                      q_sb, q_sh, ks, vs, o_sb, o_sh, scale,
                                      window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
