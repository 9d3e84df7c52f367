// Backward of the prefill flash attention (flash_attention.cu), FA2 style:
// given q, k, v, the forward's output o and its per-row log-sum-exp lse,
// and dO, it returns dq, dk, dv in q's dtype. Layouts as the forward:
// q, o, dO, dq (B,S,Hq,hd); k, v, dk, dv (B,S,Hkv,hd), all read and
// written through their strides (hd contiguous); lse and the row sums
// delta fp32 (B,Hq,S). The mask is the forward's and the oracle's:
// causal kpos <= qpos, window kpos > qpos - window (window <= 0: none).
//
// The Pallas TPU kernel repro/kernels/flash_attention.py has no backward:
// the reference differentiates its jnp oracle (jax.value_and_grad in
// repro/models/programs.py). This is the port's counterpart of that
// gradient; its yardstick is autograd through
// kernels/ref.py:flash_attention_ref. With qs = round(q * scale) (the
// reference's rounding point) and s = qs k^T:
//   P  = exp(s - lse), 0 where masked     dV = P^T dO   (P rounded to bf16)
//   dP = dO V^T, D = rowsum(dO o O)       dS = P (dP - D)
//   dQ = scale * dS K                     dK = dS^T qs
// Bound on the H100: operations at long S (2.5x the forward's matrix
// work), bytes at short S. Three launches, deterministic (no atomics:
// every output element is summed by one thread in a fixed order):
//  1. dq kernel, one CTA per (query tile, q head, batch row): first the
//     tile's D = rowsum(dO o O), written for pass 2, then a loop over the
//     KV tiles the queries can see (the forward's causal/window skip).
//  2. dkv kernel, one CTA per (KV tile, q head, batch row): a loop over
//     the query tiles that can see the KV tile (causal: the tiles at or
//     after it; a window: up to key + window), writing that q head's
//     share of dK and dV as fp32 partials.
//  3. reduce kernel, one thread per element of dK and dV: the partials of
//     the KV head's group summed in head order, cast to the output dtype.
// A first design looped over the group inside one CTA per KV head (GQA's
// sum in registers): at qwen's training shape that is 32 CTAs, and on the
// H100 the pass took 0.14 of the backward's 0.17 ms (chip_smoke.py); a
// CTA per q head gives 8x
// the CTAs for one extra read and write of the fp32 partials.
// bf16 runs passes 1 and 2 on the tensor cores with mma.sync m16n8k16 (fp32
// accumulate) fed by ldmatrix, as ssd_scan.cu does: a warp owns 16 rows
// (queries in pass 1, keys in pass 2); the S and dP accumulators become
// the A operands of the next products in registers (P and dS rounded to
// bf16). Tiles arrive by cp.async (16-byte aligned bases and row strides,
// as the forward's TMA needs), rows past S zero-filled. For hd 256 the
// accumulators would not fit a thread's registers, so two warps share a
// 16-row slab, each computing the slab's S and dP in full and keeping half
// of hd's columns of the output. fp32 runs scalar FMA kernels of the same
// plan (tensor cores on fp32 are TF32, which misses the fp32 tolerance).
// Head dims 16, 32, 64, 80, 128 and 256.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

using namespace hydra;

namespace {

using bf16 = __nv_bfloat16;

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;   // (B, Hq, S)
  float* delta;       // (B, Hq, S), written by pass 1
  void *dq, *dk, *dv;
  float* part;        // (2, B, S, Hq, hd): pass 2's dK and dV per q head
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int B, S, Hq, group;
  float scale;
  int causal;
  long long window;   // <= 0: none
};

__device__ __forceinline__ bool visible(const BwdArgs& a, int qpos, int kpos) {
  bool ok = qpos < a.S && kpos < a.S;
  if (a.causal) ok = ok && kpos <= qpos;
  if (a.window > 0) {
    ok = ok && static_cast<long long>(kpos) > static_cast<long long>(qpos) - a.window;
  }
  return ok;
}

// First key tile (of width bk) and the end of the keys a query tile
// [q0, q_last] can see.
__device__ __forceinline__ void key_range(const BwdArgs& a, int q0, int q_last, int bk,
                                          int& start, int& hi) {
  hi = a.causal ? q_last + 1 : a.S;
  long long lo = 0;
  if (a.window > 0) lo = max(0LL, static_cast<long long>(q0) - a.window + 1);
  start = static_cast<int>(min(lo, static_cast<long long>(hi)) / bk) * bk;
}

// First query tile (of width bq) and the end of the queries that can see
// some key of a KV tile [k0, k_last].
__device__ __forceinline__ void query_range(const BwdArgs& a, int k0, int k_last, int bq,
                                            int& start, int& hi) {
  const int lo = a.causal ? k0 : 0;
  hi = a.S;
  if (a.window > 0) {
    hi = static_cast<int>(min(static_cast<long long>(a.S), k_last + a.window));
  }
  start = (lo / bq) * bq;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync kernels
// ---------------------------------------------------------------------------
template <int HD>
struct BTile {
  static constexpr int HS = HD > 128 ? 2 : 1;   // warps sharing a 16-row slab
  static constexpr int HDP = HD / HS;           // output columns per warp
  static constexpr int P = HD + 8;              // smem pitch (bf16): ldmatrix
                                                // rows off each other's banks
  static constexpr int kWarps = 4 * HS;
  static constexpr int kThreads = 32 * kWarps;
  static_assert(HD % 16 == 0 && HDP % 16 == 0, "head dim must be a multiple of 16");
};

// rows [s0, s0 + nrows) of a (S, hd) slice at base (row stride ld) into
// shared memory (pitch P), by 16-byte cp.async; rows >= S zero. The caller
// waits.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base, long long ld, int s0,
                                          int nrows, int S) {
  constexpr int per = HD / 8;
  for (int e = threadIdx.x; e < nrows * per; e += blockDim.x) {
    const int r = e / per, c = (e - r * per) * 8;
    bf16* d = dst + r * BTile<HD>::P + c;
    if (s0 + r < S) {
      cp_async16(d, base + static_cast<long long>(s0 + r) * ld + c);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  }
}

// q * scale rounded to bf16 in place, as the forward and the oracle do
template <int HD>
__device__ __forceinline__ void scale_rows(bf16* tile, int nrows, float scale) {
  const float2 sc = __bfloat1622float2(__float2bfloat162_rn(round_to<bf16>(scale)));
  for (int e = threadIdx.x; e < nrows * (HD / 2); e += blockDim.x) {
    const int r = e / (HD / 2), c = (e - r * (HD / 2)) * 2;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(tile + r * BTile<HD>::P + c);
    const float2 f = __bfloat1622float2(*p);
    *p = __floats2bfloat162_rn(f.x * sc.x, f.y * sc.y);
  }
}

// acc(16 x 32) += A(16 rows of a at row a0, all HD) * B(32 rows of b, all HD)^T,
// for two products at once (a/b and a2/b2 share the fragment addresses)
template <int HD>
__device__ __forceinline__ void mma_rows_x_rows(float (&acc)[4][4], float (&acc2)[4][4],
                                                const bf16* a, const bf16* b,
                                                const bf16* a2, const bf16* b2, int a0,
                                                int lane) {
  constexpr int P = BTile<HD>::P;
  const int arow = (a0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 8;
  const int brow = ((lane & 7) + (lane >> 4) * 8) * P + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    uint32_t af[4], af2[4];
    ldsm_x4(af, smem_addr(a + arow + kk));
    ldsm_x4(af2, smem_addr(a2 + arow + kk));
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      uint32_t bf[4], bf2[4];
      ldsm_x4(bf, smem_addr(b + brow + jp * 16 * P + kk));
      ldsm_x4(bf2, smem_addr(b2 + brow + jp * 16 * P + kk));
      mma_bf16_16816(acc[2 * jp], af, bf[0], bf[1]);
      mma_bf16_16816(acc[2 * jp + 1], af, bf[2], bf[3]);
      mma_bf16_16816(acc2[2 * jp], af2, bf2[0], bf2[1]);
      mma_bf16_16816(acc2[2 * jp + 1], af2, bf2[2], bf2[3]);
    }
  }
}

// the accumulator layout of a 16 x 32 tile as bf16 A fragments of its two
// 16-column blocks
__device__ __forceinline__ void to_a_frags(const float (&acc)[4][4], uint32_t (&a)[2][4]) {
#pragma unroll
  for (int kb = 0; kb < 2; ++kb) {
    a[kb][0] = pack_bf16(acc[2 * kb][0], acc[2 * kb][1]);
    a[kb][1] = pack_bf16(acc[2 * kb][2], acc[2 * kb][3]);
    a[kb][2] = pack_bf16(acc[2 * kb + 1][0], acc[2 * kb + 1][1]);
    a[kb][3] = pack_bf16(acc[2 * kb + 1][2], acc[2 * kb + 1][3]);
  }
}

// out(16 x HDP) += A(16 x 32, fragments) * b[32 rows][col0, col0 + HDP)
template <int HD>
__device__ __forceinline__ void mma_frags_x_rows(float (&out)[BTile<HD>::HDP / 8][4],
                                                 const uint32_t (&a)[2][4], const bf16* b,
                                                 int col0, int lane) {
  constexpr int P = BTile<HD>::P;
  const int brow = ((lane & 7) + ((lane >> 3) & 1) * 8) * P + col0 + (lane >> 4) * 8;
#pragma unroll
  for (int kb = 0; kb < 2; ++kb) {
#pragma unroll
    for (int jp = 0; jp < BTile<HD>::HDP / 16; ++jp) {
      uint32_t bf[4];
      ldsm_x4_t(bf, smem_addr(b + brow + kb * 16 * P + jp * 16));
      mma_bf16_16816(out[2 * jp], a[kb], bf[0], bf[1]);
      mma_bf16_16816(out[2 * jp + 1], a[kb], bf[2], bf[3]);
    }
  }
}

constexpr int kBQ1 = 64;   // pass 1: query rows per CTA (16 per warp slab)
constexpr int kBK1 = 32;   // pass 1: keys per step
constexpr int kBK2 = 64;   // pass 2: keys per CTA (16 per warp slab)
constexpr int kBQ2 = 32;   // pass 2: queries per step

template <int HD>
constexpr int dq_smem() { return (2 * kBQ1 + 2 * kBK1) * BTile<HD>::P * 2 + 2 * kBQ1 * 4; }
template <int HD>
constexpr int dkv_smem() { return (2 * kBK2 + 2 * kBQ2) * BTile<HD>::P * 2 + 2 * kBQ2 * 4; }

template <int HD>
__global__ void __launch_bounds__(BTile<HD>::kThreads)
flash_bwd_dq_kernel(const BwdArgs a) {
  using Tl = BTile<HD>;
  constexpr int P = Tl::P, HDP = Tl::HDP;
  extern __shared__ __align__(16) unsigned char dq_smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(dq_smem_raw);
  bf16* dOs = Qs + kBQ1 * P;
  bf16* Ks = dOs + kBQ1 * P;
  bf16* Vs = Ks + kBK1 * P;
  float* lse_s = reinterpret_cast<float*>(Vs + kBK1 * P);
  float* dlt_s = lse_s + kBQ1;

  const int q0 = blockIdx.x * kBQ1, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slab = warp & 3, hs = warp >> 2;
  const int S = a.S;
  const long long row_bh = (static_cast<long long>(b) * a.Hq + h) * S;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* ob = static_cast<const bf16*>(a.o) + b * a.os.b + h * a.os.h;
  const bf16* dob = static_cast<const bf16*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + hk * a.vs.h;

  load_rows<HD>(Qs, qb, a.qs.s, q0, kBQ1, S);
  load_rows<HD>(dOs, dob, a.dos.s, q0, kBQ1, S);
  // D = rowsum(dO o O) of the tile's rows (O and dO from global), and lse
  for (int r = warp; r < kBQ1; r += Tl::kWarps) {
    const int qpos = q0 + r;
    float d = 0.f, l = 0.f;
    if (qpos < S) {
      const bf16* orow = ob + qpos * a.os.s;
      const bf16* drow = dob + qpos * a.dos.s;
      for (int c = lane; c < HD; c += 32) d = fmaf(to_f(orow[c]), to_f(drow[c]), d);
      d = warp_sum(d);
      l = a.lse[row_bh + qpos];
      if (lane == 0) a.delta[row_bh + qpos] = d;
    }
    if (lane == 0) {
      dlt_s[r] = d;
      lse_s[r] = l;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  scale_rows<HD>(Qs, kBQ1, a.scale);

  float acc[HDP / 8][4];
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int k_start, kv_hi;
  key_range(a, q0, min(q0 + kBQ1, S) - 1, kBK1, k_start, kv_hi);
  for (int k0 = k_start; k0 < kv_hi; k0 += kBK1) {
    __syncthreads();     // the previous K/V tile is consumed; Qs is scaled
    load_rows<HD>(Ks, kb, a.ks.s, k0, kBK1, S);
    load_rows<HD>(Vs, vb, a.vs.s, k0, kBK1, S);
    cp_async_wait_all();
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    mma_rows_x_rows<HD>(s, dp, Qs, Ks, dOs, Vs, slab * 16, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = slab * 16 + g + (e >> 1) * 8;
        const int kpos = k0 + j * 8 + 2 * t + (e & 1);
        float ds = 0.f;
        if (visible(a, q0 + r, kpos)) {
          ds = expf(s[j][e] - lse_s[r]) * (dp[j][e] - dlt_s[r]);
        }
        s[j][e] = ds;
      }
    }
    uint32_t da[2][4];
    to_a_frags(s, da);
    mma_frags_x_rows<HD>(acc, da, Ks, hs * HDP, lane);
  }

  bf16* dqb = static_cast<bf16*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qpos = q0 + slab * 16 + g + rr * 8;
    if (qpos >= S) continue;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dqb + qpos * a.dqs.s + hs * HDP + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * rr] * a.scale, acc[j][2 * rr + 1] * a.scale);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(BTile<HD>::kThreads)
flash_bwd_dkv_kernel(const BwdArgs a) {
  using Tl = BTile<HD>;
  constexpr int P = Tl::P, HDP = Tl::HDP;
  extern __shared__ __align__(16) unsigned char dkv_smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(dkv_smem_raw);
  bf16* Vs = Ks + kBK2 * P;
  bf16* Qs = Vs + kBK2 * P;
  bf16* dOs = Qs + kBQ2 * P;
  float* lse_s = reinterpret_cast<float*>(dOs + kBQ2 * P);
  float* dlt_s = lse_s + kBQ2;

  const int k0 = blockIdx.x * kBK2, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slab = warp & 3, hs = warp >> 2;
  const int S = a.S;

  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + hk * a.vs.h;
  load_rows<HD>(Ks, kb, a.ks.s, k0, kBK2, S);
  load_rows<HD>(Vs, vb, a.vs.s, k0, kBK2, S);
  cp_async_wait_all();

  float dk[HDP / 8][4], dv[HDP / 8][4];
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }

  int q_start, q_hi;
  query_range(a, k0, min(k0 + kBK2, S) - 1, kBQ2, q_start, q_hi);
  const long long row_bh = (static_cast<long long>(b) * a.Hq + h) * S;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* dob = static_cast<const bf16*>(a.dout) + b * a.dos.b + h * a.dos.h;
  for (int q0 = q_start; q0 < q_hi; q0 += kBQ2) {
    __syncthreads();   // the previous query tile is consumed
    load_rows<HD>(Qs, qb, a.qs.s, q0, kBQ2, S);
    load_rows<HD>(dOs, dob, a.dos.s, q0, kBQ2, S);
    for (int r = threadIdx.x; r < kBQ2; r += blockDim.x) {
      const bool in = q0 + r < S;
      lse_s[r] = in ? a.lse[row_bh + q0 + r] : 0.f;
      dlt_s[r] = in ? a.delta[row_bh + q0 + r] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    scale_rows<HD>(Qs, kBQ2, a.scale);
    __syncthreads();

    // S^T = K qs^T and dP^T = V dO^T for the warp's 16 keys x 32 queries
    float s[4][4] = {}, dp[4][4] = {};
    mma_rows_x_rows<HD>(s, dp, Ks, Qs, Vs, dOs, slab * 16, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + slab * 16 + g + (e >> 1) * 8;
        const int qi = j * 8 + 2 * t + (e & 1);
        float p = 0.f, ds = 0.f;
        if (visible(a, q0 + qi, kpos)) {
          p = expf(s[j][e] - lse_s[qi]);
          ds = p * (dp[j][e] - dlt_s[qi]);
        }
        s[j][e] = p;
        dp[j][e] = ds;
      }
    }
    uint32_t pa[2][4], da[2][4];
    to_a_frags(s, pa);
    to_a_frags(dp, da);
    mma_frags_x_rows<HD>(dv, pa, dOs, hs * HDP, lane);   // dV += P^T dO
    mma_frags_x_rows<HD>(dk, da, Qs, hs * HDP, lane);    // dK += dS^T qs
  }

  const long long half = static_cast<long long>(a.B) * S * a.Hq * HD;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int kpos = k0 + slab * 16 + g + rr * 8;
    if (kpos >= S) continue;
    float* pk = a.part + ((static_cast<long long>(b) * S + kpos) * a.Hq + h) * HD;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = hs * HDP + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(pk + col) = make_float2(dk[j][2 * rr], dk[j][2 * rr + 1]);
      *reinterpret_cast<float2*>(pk + half + col) =
          make_float2(dv[j][2 * rr], dv[j][2 * rr + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: scalar kernels of the same plan
// ---------------------------------------------------------------------------
constexpr int kSQ = 16;      // pass 1: query rows per CTA (4 per warp)
constexpr int kSK = 32;      // pass 1: keys per step (one per lane)
constexpr int kSKV = 16;     // pass 2: keys per CTA (4 per warp)
constexpr int kSQ2 = 32;     // pass 2: queries per step (one per lane)
constexpr int kSWarps = 4;
constexpr int kSPer = 4;     // rows per warp

template <int HD>
constexpr int scalar_smem() {   // two (16, HD) tiles and two (32, HD + 1)
  return (2 * 16 * HD + 2 * 32 * (HD + 1) + 2 * 32) * 4;
}

template <int HD>
__global__ void __launch_bounds__(32 * kSWarps)
flash_bwd_dq_scalar_kernel(const BwdArgs a) {
  constexpr int DPL = (HD + 31) / 32;
  extern __shared__ float dqs_smem[];
  float(*Qs)[HD] = reinterpret_cast<float(*)[HD]>(dqs_smem);
  float(*dOs)[HD] = reinterpret_cast<float(*)[HD]>(dqs_smem + kSQ * HD);
  float(*Ks)[HD + 1] = reinterpret_cast<float(*)[HD + 1]>(dqs_smem + 2 * kSQ * HD);
  float(*Vs)[HD + 1] =
      reinterpret_cast<float(*)[HD + 1]>(dqs_smem + 2 * kSQ * HD + kSK * (HD + 1));

  const int q0 = blockIdx.x * kSQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int S = a.S;
  const long long row_bh = (static_cast<long long>(b) * a.Hq + h) * S;
  const float* qb = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* ob = static_cast<const float*>(a.o) + b * a.os.b + h * a.os.h;
  const float* dob = static_cast<const float*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vs.b + hk * a.vs.h;

  for (int e = tid; e < kSQ * HD; e += blockDim.x) {
    const int r = e / HD, d = e % HD, pos = q0 + r;
    Qs[r][d] = pos < S ? qb[pos * a.qs.s + d] * a.scale : 0.f;
    dOs[r][d] = pos < S ? dob[pos * a.dos.s + d] : 0.f;
  }
  __syncthreads();
  float dlt[kSPer], lse[kSPer], acc[kSPer][DPL];
#pragma unroll
  for (int r = 0; r < kSPer; ++r) {
    const int row = warp * kSPer + r, qpos = q0 + row;
    float d = 0.f;
    if (qpos < S) {
      for (int c = lane; c < HD; c += 32) d = fmaf(ob[qpos * a.os.s + c], dOs[row][c], d);
      d = warp_sum(d);
      if (lane == 0) a.delta[row_bh + qpos] = d;
    }
    dlt[r] = d;
    lse[r] = qpos < S ? a.lse[row_bh + qpos] : 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  int k_start, kv_hi;
  key_range(a, q0, min(q0 + kSQ, S) - 1, kSK, k_start, kv_hi);
  for (int k0 = k_start; k0 < kv_hi; k0 += kSK) {
    __syncthreads();
    for (int e = tid; e < kSK * HD; e += blockDim.x) {
      const int j = e / HD, d = e % HD, pos = k0 + j;
      Ks[j][d] = pos < S ? kb[pos * a.ks.s + d] : 0.f;
      Vs[j][d] = pos < S ? vb[pos * a.vs.s + d] : 0.f;
    }
    __syncthreads();
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kSPer; ++r) {
      const int row = warp * kSPer + r, qpos = q0 + row;
      if (qpos >= S) continue;   // uniform across the warp
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < HD; ++d) {
        s = fmaf(Qs[row][d], Ks[lane][d], s);
        dp = fmaf(dOs[row][d], Vs[lane][d], dp);
      }
      const float ds = visible(a, qpos, kpos) ? expf(s - lse[r]) * (dp - dlt[r]) : 0.f;
      for (int j = 0; j < kSK; ++j) {
        const float dsj = __shfl_sync(kFullMask, ds, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < HD) acc[r][i] = fmaf(dsj, Ks[j][d], acc[r][i]);
        }
      }
    }
  }
  float* dqb = static_cast<float*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int r = 0; r < kSPer; ++r) {
    const int qpos = q0 + warp * kSPer + r;
    if (qpos >= S) continue;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) dqb[qpos * a.dqs.s + d] = acc[r][i] * a.scale;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(32 * kSWarps)
flash_bwd_dkv_scalar_kernel(const BwdArgs a) {
  constexpr int DPL = (HD + 31) / 32;
  extern __shared__ float dkvs_smem[];
  float(*Ks)[HD] = reinterpret_cast<float(*)[HD]>(dkvs_smem);
  float(*Vs)[HD] = reinterpret_cast<float(*)[HD]>(dkvs_smem + kSKV * HD);
  float(*Qs)[HD + 1] = reinterpret_cast<float(*)[HD + 1]>(dkvs_smem + 2 * kSKV * HD);
  float(*dOs)[HD + 1] =
      reinterpret_cast<float(*)[HD + 1]>(dkvs_smem + 2 * kSKV * HD + kSQ2 * (HD + 1));
  float* lse_s = dkvs_smem + 2 * kSKV * HD + 2 * kSQ2 * (HD + 1);
  float* dlt_s = lse_s + kSQ2;

  const int k0 = blockIdx.x * kSKV, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int S = a.S;
  const float* kb = static_cast<const float*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vs.b + hk * a.vs.h;
  for (int e = tid; e < kSKV * HD; e += blockDim.x) {
    const int j = e / HD, d = e % HD, pos = k0 + j;
    Ks[j][d] = pos < S ? kb[pos * a.ks.s + d] : 0.f;
    Vs[j][d] = pos < S ? vb[pos * a.vs.s + d] : 0.f;
  }
  float dk[kSPer][DPL], dv[kSPer][DPL];
#pragma unroll
  for (int r = 0; r < kSPer; ++r) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) dk[r][i] = dv[r][i] = 0.f;
  }

  int q_start, q_hi;
  query_range(a, k0, min(k0 + kSKV, S) - 1, kSQ2, q_start, q_hi);
  const long long row_bh = (static_cast<long long>(b) * a.Hq + h) * S;
  const float* qb = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* dob = static_cast<const float*>(a.dout) + b * a.dos.b + h * a.dos.h;
  for (int q0 = q_start; q0 < q_hi; q0 += kSQ2) {
    __syncthreads();
    for (int e = tid; e < kSQ2 * HD; e += blockDim.x) {
      const int r = e / HD, d = e % HD, pos = q0 + r;
      Qs[r][d] = pos < S ? qb[pos * a.qs.s + d] * a.scale : 0.f;
      dOs[r][d] = pos < S ? dob[pos * a.dos.s + d] : 0.f;
    }
    for (int r = tid; r < kSQ2; r += blockDim.x) {
      const bool in = q0 + r < S;
      lse_s[r] = in ? a.lse[row_bh + q0 + r] : 0.f;
      dlt_s[r] = in ? a.delta[row_bh + q0 + r] : 0.f;
    }
    __syncthreads();
    const int qpos = q0 + lane;
#pragma unroll
    for (int r = 0; r < kSPer; ++r) {
      const int kr = warp * kSPer + r, kpos = k0 + kr;
      if (kpos >= S) continue;   // uniform across the warp
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < HD; ++d) {
        s = fmaf(Qs[lane][d], Ks[kr][d], s);
        dp = fmaf(dOs[lane][d], Vs[kr][d], dp);
      }
      float p = 0.f, ds = 0.f;
      if (visible(a, qpos, kpos)) {
        p = expf(s - lse_s[lane]);
        ds = p * (dp - dlt_s[lane]);
      }
      for (int j = 0; j < kSQ2; ++j) {
        const float pj = __shfl_sync(kFullMask, p, j);
        const float dsj = __shfl_sync(kFullMask, ds, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < HD) {
            dv[r][i] = fmaf(pj, dOs[j][d], dv[r][i]);
            dk[r][i] = fmaf(dsj, Qs[j][d], dk[r][i]);
          }
        }
      }
    }
  }
  const long long half = static_cast<long long>(a.B) * S * a.Hq * HD;
#pragma unroll
  for (int r = 0; r < kSPer; ++r) {
    const int kpos = k0 + warp * kSPer + r;
    if (kpos >= S) continue;
    float* pk = a.part + ((static_cast<long long>(b) * S + kpos) * a.Hq + h) * HD;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) {
        pk[d] = dk[r][i];
        pk[half + d] = dv[r][i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pass 3: dK and dV, the group's per-head partials summed in head order
// ---------------------------------------------------------------------------
constexpr int kReduceThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
flash_bwd_reduce_kernel(const BwdArgs a, int Hkv, int hd) {
  const long long total = static_cast<long long>(a.B) * a.S * Hkv * hd;
  const long long i = static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (i >= total) return;
  const int d = static_cast<int>(i % hd);
  long long rest = i / hd;
  const int hk = static_cast<int>(rest % Hkv);
  rest /= Hkv;
  const int s = static_cast<int>(rest % a.S);
  const int b = static_cast<int>(rest / a.S);
  const long long half = static_cast<long long>(a.B) * a.S * a.Hq * hd;
  const float* p = a.part + ((static_cast<long long>(b) * a.S + s) * a.Hq +
                             static_cast<long long>(hk) * a.group) * hd + d;
  float sk = 0.f, sv = 0.f;
  for (int g = 0; g < a.group; ++g) {
    sk += p[g * hd];
    sv += p[half + g * hd];
  }
  static_cast<T*>(a.dk)[b * a.dks.b + s * a.dks.s + hk * a.dks.h + d] = from_f<T>(sk);
  static_cast<T*>(a.dv)[b * a.dvs.b + s * a.dvs.s + hk * a.dvs.h + d] = from_f<T>(sv);
}

template <typename T>
int launch_reduce(const BwdArgs& a, int Hkv, int hd, cudaStream_t s) {
  const long long total = static_cast<long long>(a.B) * a.S * Hkv * hd;
  const long long blocks = (total + kReduceThreads - 1) / kReduceThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_reduce_kernel<T><<<static_cast<unsigned>(blocks), kReduceThreads, 0, s>>>(a, Hkv, hd);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int HD>
int launch_bf16(const BwdArgs& a, int B, int Hkv, cudaStream_t s) {
  using Tl = BTile<HD>;
  static const int attr = set_smem(flash_bwd_dq_kernel<HD>, dq_smem<HD>()) |
                          set_smem(flash_bwd_dkv_kernel<HD>, dkv_smem<HD>());
  if (attr != 0) return attr;
  flash_bwd_dq_kernel<HD><<<dim3((a.S + kBQ1 - 1) / kBQ1, a.Hq, B), Tl::kThreads,
                            dq_smem<HD>(), s>>>(a);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  flash_bwd_dkv_kernel<HD><<<dim3((a.S + kBK2 - 1) / kBK2, a.Hq, B), Tl::kThreads,
                             dkv_smem<HD>(), s>>>(a);
  const int err2 = static_cast<int>(cudaGetLastError());
  if (err2 != 0) return err2;
  return launch_reduce<bf16>(a, Hkv, HD, s);
}

template <int HD>
int launch_f32(const BwdArgs& a, int B, int Hkv, cudaStream_t s) {
  static const int attr = set_smem(flash_bwd_dq_scalar_kernel<HD>, scalar_smem<HD>()) |
                          set_smem(flash_bwd_dkv_scalar_kernel<HD>, scalar_smem<HD>());
  if (attr != 0) return attr;
  flash_bwd_dq_scalar_kernel<HD><<<dim3((a.S + kSQ - 1) / kSQ, a.Hq, B), 32 * kSWarps,
                                   scalar_smem<HD>(), s>>>(a);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  flash_bwd_dkv_scalar_kernel<HD><<<dim3((a.S + kSKV - 1) / kSKV, a.Hq, B), 32 * kSWarps,
                                    scalar_smem<HD>(), s>>>(a);
  const int err2 = static_cast<int>(cudaGetLastError());
  if (err2 != 0) return err2;
  return launch_reduce<float>(a, Hkv, HD, s);
}

}  // namespace

// st: 24 element strides, (b, s, h) of q, k, v, o, dout, dq, dk, dv in that
// order. lse: the forward's (B, Hq, S) fp32; delta: (B, Hq, S) fp32 scratch;
// part: (2, B, S, Hq, hd) fp32 scratch. window <= 0 means no window.
extern "C" int hydra_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* delta, void* part, void* dq, void* dk,
                                         void* dv, int B,
                                         int S, int Hq, int Hkv, int hd, const long long* st,
                                         float scale, int causal, long long window,
                                         int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || Hkv > 65535 || B > 65535 ||
      (dtype != kF32 && dtype != kBF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
            dq, dk, dv, static_cast<float*>(part),
            {st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
            {st[9], st[10], st[11]}, {st[12], st[13], st[14]}, {st[15], st[16], st[17]},
            {st[18], st[19], st[20]}, {st[21], st[22], st[23]},
            B, S, Hq, Hq / Hkv, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HYDRA_FLASH_BWD_HD(D)                                                  \
  case D:                                                                      \
    return dtype == kBF16 ? launch_bf16<D>(a, B, Hkv, s) : launch_f32<D>(a, B, Hkv, s);
  switch (hd) {
    HYDRA_FLASH_BWD_HD(16)
    HYDRA_FLASH_BWD_HD(32)
    HYDRA_FLASH_BWD_HD(64)
    HYDRA_FLASH_BWD_HD(80)
    HYDRA_FLASH_BWD_HD(128)
    HYDRA_FLASH_BWD_HD(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HYDRA_FLASH_BWD_HD
}
