// Forward flash attention for prefill: GQA, causal mask, optional sliding
// window, fp32 online softmax. q (B,S,Hq,hd), k/v (B,S,Hkv,hd) read in
// place through their strides (hd contiguous); out (B,S,Hq,hd).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention/_kernel). The TPU kernel walks a sequential grid over
// every KV block with the running (m, l, acc) in VMEM scratch; here the KV
// loop runs inside one block per (query tile, head, batch row), since
// Hopper blocks run in parallel and carry nothing between them.
//
// Bound on the H100: operations at long S, bytes at short S (at S=500,
// hd=128 the causal QK^T and PV products are ~0.5 GFLOP per layer against
// ~1.5 MB moved). This first version does the products with scalar fp32
// FMAs on CUDA cores, far below the tensor-core rate; what its design does
// about the bound is to skip every KV tile that lies wholly above the
// causal diagonal or wholly before the window, and to keep each K/V tile
// in shared memory where all 16 query rows of the block reuse it.
//
// Semantics kept from the reference: q*scale is rounded to q's dtype, the
// masks fill -1e30 (so a tile that is masked for a row is wiped by the
// first valid key's rescale), and the result is acc / max(l, 1e-30).
#include "common.cuh"

using namespace hydra;

namespace {

constexpr int kBQ = 16;                // query rows per block
constexpr int kBK = 32;                // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBQ / kWarps;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int group,
                 Strides qs, Strides ks, Strides vs, Strides os, float scale,
                 int causal, long long window) {
  constexpr int DPL = (HD + 31) / 32;  // head dims per lane in the PV product
  __shared__ float Qs[kBQ][HD];
  __shared__ float Ks[kBK][HD + 1];    // +1: lane j reads row j conflict-free
  __shared__ float Vs[kBK][HD];

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  const float sc = round_to<T>(scale);
  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int pos = q0 + r;
    Qs[r][d] = pos < S ? round_to<T>(to_f(qb[pos * qs.s + d]) * sc) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  // keys this query tile can see: none past its last row when causal, none
  // at or before q0 - window for its first row when windowed
  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_hi = causal ? q_last + 1 : S;
  long long kv_lo = 0;
  if (window > 0) kv_lo = max(0LL, static_cast<long long>(q0) - window + 1);
  const int k_start = static_cast<int>(min(kv_lo, static_cast<long long>(kv_hi)) / kBK) * kBK;

  for (int k0 = k_start; k0 < kv_hi; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed; Qs is written
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int j = e / HD, d = e % HD;
      const int pos = k0 + j;
      const bool in = pos < S;
      Ks[j][d] = in ? to_f(kb[pos * ks.s + d]) : 0.f;
      Vs[j][d] = in ? to_f(vb[pos * vs.s + d]) : 0.f;
    }
    __syncthreads();

    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      const int qpos = q0 + row;
      if (qpos >= S) continue;  // uniform across the warp
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s = fmaf(Qs[row][d], Ks[lane][d], s);
      bool valid = kpos < S;
      if (causal) valid = valid && kpos <= qpos;
      if (window > 0) {
        valid = valid && static_cast<long long>(kpos) >
                             static_cast<long long>(qpos) - window;
      }
      s = valid ? s : kNegInf;

      const float m_new = fmaxf(m[r], warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
#pragma unroll 4
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(kFullMask, p, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < HD) acc[r][i] = fmaf(pj, Vs[j][d], acc[r][i]);
        }
      }
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qpos = q0 + warp * kRowsPerWarp + r;
    if (qpos >= S) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    T* orow = o + b * os.b + qpos * os.s + h * os.h;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) orow[d] = from_f<T>(acc[r][i] * inv);
    }
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* o, int B, int S,
            int Hq, int group, Strides qs, Strides ks, Strides vs, Strides os,
            float scale, int causal, long long window, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, group, qs, ks, vs, os,
      scale, causal, window);
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                int B, int S, int Hq, int group, Strides qs, Strides ks,
                Strides vs, Strides os, float scale, int causal,
                long long window, cudaStream_t stream) {
  switch (hd) {
    case 8: launch<T, 8>(q, k, v, o, B, S, Hq, group, qs, ks, vs, os, scale, causal, window, stream); break;
    case 16: launch<T, 16>(q, k, v, o, B, S, Hq, group, qs, ks, vs, os, scale, causal, window, stream); break;
    case 32: launch<T, 32>(q, k, v, o, B, S, Hq, group, qs, ks, vs, os, scale, causal, window, stream); break;
    case 64: launch<T, 64>(q, k, v, o, B, S, Hq, group, qs, ks, vs, os, scale, causal, window, stream); break;
    case 80: launch<T, 80>(q, k, v, o, B, S, Hq, group, qs, ks, vs, os, scale, causal, window, stream); break;
    case 128: launch<T, 128>(q, k, v, o, B, S, Hq, group, qs, ks, vs, os, scale, causal, window, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window <= 0 means no window. Strides are in elements.
extern "C" int hydra_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int S, int Hq,
    int Hkv, int hd, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, int causal, long long window, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = Hq / Hkv;
  if (dtype == kF32) {
    return dispatch_hd<float>(hd, q, k, v, o, B, S, Hq, group, qs, ks, vs, os,
                              scale, causal, window, s);
  }
  if (dtype == kBF16) {
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, S, Hq, group, qs, ks,
                                      vs, os, scale, causal, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
