// Backward of the prefill flash attention (flash_attention.cu): given q, k,
// v, the forward's output o and its per-row log-sum-exp lse, and dO, it
// returns dq, dk, dv in q's dtype. Layouts as the forward: q, o, dO, dq
// (B,S,Hq,hd); k, v, dk, dv (B,S,Hkv,hd), all read and written through
// their strides (hd contiguous); lse and the row sums delta fp32 (B,Hq,S).
// The mask is the forward's and the oracle's: causal kpos <= qpos, window
// kpos > qpos - window (window <= 0: none).
//
// The Pallas TPU kernel repro/kernels/flash_attention.py has no backward:
// the reference differentiates its jnp oracle (jax.value_and_grad in
// repro/models/programs.py). This is the port's counterpart of that
// gradient; its yardstick is autograd through
// kernels/ref.py:flash_attention_ref. With qs = round(q * scale) (the
// reference's rounding point) and s = qs k^T:
//   P  = exp(s - lse), 0 where masked     dV = P^T dO   (P rounded to bf16)
//   dP = dO V^T, D = rowsum(dO o O)       dS = P (dP - D)  (rounded to bf16)
//   dQ = scale * dS K                     dK = dS^T qs
//
// Bound on the H100: five 64x64xhd products per visible tile pair (S and
// dP are recomputed in both passes), so operations at long S; at the
// training path's S = 128 the bytes (q, o, dO, dq at B*S*Hq*hd each; k,
// v, dk, dv at B*S*Hkv*hd) and, above all, latency: each CTA walks 1-16
// tiles with one consumer warpgroup, so the elementwise work between the
// products (exp, mask, dS) runs at one warp a sub-partition.
//
// bf16 runs two launches on the tensor cores, built like the forward's
// flash_wgmma_kernel: one consumer warpgroup issuing wgmma, one producer
// warp keeping tiles in flight through TMA into a 2-stage mbarrier ring,
// the tiles in tma.cuh's swizzled panels (so one smem tile is a K-major
// operand of S or dP and an MN-major operand of a dQ, dK or dV product;
// nothing is transposed). Every product is one of the forward's two forms:
//   S = qs K^T, dP = dO V^T, S^T = K qs^T, dP^T = V dO^T   wgmma_ss_n64
//   dQ += dS K, dV += P^T dO, dK += dS^T qs                 wgmma_rs<hd>
// with P, dS (and their transposes) turned from the fp32 accumulators into
// bf16 A fragments in registers, as the forward does for P.
//  1. flash_bwd_dq_wgmma_kernel, one CTA per (64-query tile, q head, batch
//     row), the last query tiles (which see the most keys) first: D =
//     rowsum(dO o O) for its rows, O from global memory and dO from its
//     swizzled tile (written for pass 2); q scaled and rounded in shared
//     memory and stored back by TMA as qs (a bf16 (B,S,Hq,hd) workspace
//     pass 2 reads, so it never rescales); then the K/V tiles from
//     key_range (the forward's causal/window skip): S and dP issued as two
//     wgmma groups, P's exp computed while dP runs, dS, then dQ += dS K.
//     dQ leaves registers once, scaled. A tile on the mask's edge tests
//     each element against its row's key range [klo, khi): two compares,
//     not visible()'s causal, window and length tests.
//  2. flash_bwd_dkv_wgmma_kernel, one CTA per (64-key tile, q head, batch
//     row), launched in thread block clusters of `group` CTAs along the q
//     heads, so a cluster holds one KV head's whole group. K and V are
//     loaded once; qs, dO (TMA) and each query's lse and D (the producer
//     warp's lanes) stream through the ring over the query tiles from
//     query_range. S^T and dP^T, then dV += P^T dO and dK += dS^T qs, all
//     in registers. The GQA sum: each CTA stages its head's fp32 dK, dV in
//     its own shared memory, the cluster synchronises, and CTA r sums rows
//     [r*64/group, (r+1)*64/group) over the cluster's CTAs through
//     distributed shared memory (mapa + ld.shared::cluster, every load of a
//     batch issued before its sums) in rank order, which is head order, and
//     stores them in bf16. A group of one stores from registers. No fp32
//     partials go to device memory and no third launch sums them (a
//     (2,B,S,Hq,hd) fp32 buffer, written and read back, would be 33.6 MB
//     at qwen's shape). Deterministic: every output element is one
//     thread's sum in a fixed order; there are no atomics. A group above
//     8, the portable cluster size, is refused (no config has one).
//     What bounds it at qwen's training shape: 242 registers (dK and dV
//     128, S^T and dP^T 64) allow one CTA a SM, clusters of 8 fit 120 of
//     the 132 SMs, so 256 CTAs take three waves; and a CTA spends about
//     half its time in the cluster's sum (DSMEM moves its 56 KB of remote
//     fp32, and two cluster barriers).
// hd 256 would need 256 accumulator registers a thread for dK and dV, so
// both passes split its columns between two CTAs (kSplit), each computing
// S and dP in full and keeping 128 columns of the output: double the CTAs,
// which also fills the card at gemma3-1b's B = 1, 4-head shape (128 CTAs a
// pass, not 64). TMA fills zeros past S and past hd; hd 80 takes the
// forward's 32-byte swizzle. fp32 keeps scalar FMA kernels of the earlier
// plan (tensor cores on fp32 are TF32, which misses the fp32 tolerance): dq, a
// dk/dv pass per q head into fp32 partials, and the group's sum in a third
// launch. Head dims 16, 32, 64, 80, 128 and 256.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "tma.cuh"

using namespace hydra;

namespace {

using bf16 = __nv_bfloat16;

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;   // (B, Hq, S)
  float* delta;       // (B, Hq, S), written by pass 1
  void *dq, *dk, *dv;
  float* part;        // fp32: (2, B, S, Hq, hd), pass 2's dK and dV per q head
  void* qsc;          // bf16: (B, S, Hq, hd) contiguous, qs written by pass 1
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
// bf16: wgmma + TMA kernels
// ---------------------------------------------------------------------------
constexpr int kConsumers = 128;                 // one warpgroup
constexpr int kBwdThreads = kConsumers + 32;    // + one producer warp
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct BwdPlan {
  using Tl = SwTile<HD>;
  static constexpr int kSplit = HD > 128 ? 2 : 1;  // CTAs sharing a tile's hd columns
  static constexpr int HDC = HD / kSplit;          // output columns per CTA
  static constexpr int kColOff = (HDC / Tl::kPanelElems) * Tl::kPanelBytes;
  static constexpr int kStages = 2;
  // pass 1: Q, dO, then the K/V ring; + 1024 to align the swizzle atoms
  static constexpr int kDqSmem = (2 + 2 * kStages) * Tl::kBytes + 1024;
  // pass 2: K, V, then the qs/dO ring, whose bytes the cluster's fp32 dK/dV
  // staging (64 rows x HDC, pitch HDC + 8: conflict-free float2 stores)
  // reuses after the loop
  static constexpr int kPitch = HDC + 8;
  static constexpr int kStageBytes = 2 * kTile * kPitch * 4;
  static constexpr int kRingBytes = 2 * kStages * Tl::kBytes;
  static constexpr int kDkvSmem =
      2 * Tl::kBytes + (kRingBytes > kStageBytes ? kRingBytes : kStageBytes) + 1024;
  static_assert(HDC % Tl::kPanelElems == 0, "a CTA's columns are whole panels");
  static_assert(kDqSmem <= kSmemMax && kDkvSmem <= kSmemMax, "shared memory");
};

// The (64 x 64) fp32 accumulator of an ss product as bf16 A fragments of
// four 16-column k-steps (the forward's P packing).
__device__ __forceinline__ void to_a_frags(const float (&acc)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
  }
}

// acc (64 x 64) = A(64 x hd) * B(64 x hd)^T, both K-major tiles
template <int HD>
__device__ __forceinline__ void issue_ss(float (&acc)[32], uint32_t a_s, uint32_t b_s) {
  using Tl = SwTile<HD>;
#pragma unroll
  for (int kk = 0; kk < Tl::HDP / 16; ++kk) {
    wgmma_ss_n64(acc, desc_sw<Tl::kLayout>(a_s + Tl::kstep(kk), 16, 8 * Tl::kSw),
                 desc_sw<Tl::kLayout>(b_s + Tl::kstep(kk), 16, 8 * Tl::kSw), kk > 0);
  }
}

// acc (64 x HDC) += A(64 x 64, fragments) * B(64 rows x HDC columns from
// byte offset col_off), B read MN-major
template <int HD>
__device__ __forceinline__ void issue_rs(float (&acc)[BwdPlan<HD>::HDC / 2],
                                         const uint32_t (&a)[4][4], uint32_t b_s) {
  using Tl = SwTile<HD>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs<BwdPlan<HD>::HDC>(
        acc, a[kk], desc_sw<Tl::kLayout>(b_s + kk * 16 * Tl::kSw, Tl::kPanelBytes, 8 * Tl::kSw));
  }
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_qs, const BwdArgs a) {
  using Pl = BwdPlan<HD>;
  using Tl = SwTile<HD>;
  constexpr int NQ = Pl::HDC / 2;     // dQ accumulator registers per thread
  constexpr int kStages = Pl::kStages;
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // q/dO, full[], empty[]
  __shared__ float lse_s[kTile], dlt_s[kTile];
  extern __shared__ unsigned char dq_smem_raw[];
  const uint32_t raw = smem_addr(dq_smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = dq_smem_raw + (base - raw);
  const uint32_t q_s = base, do_s = base + Tl::kBytes;
  auto k_s = [&](int s) { return base + (2 + 2 * s) * Tl::kBytes; };
  auto v_s = [&](int s) { return base + (3 + 2 * s) * Tl::kBytes; };
  const uint32_t bar_q = smem_addr(&bars[0]);
  auto bar_full = [&](int s) { return smem_addr(&bars[1 + s]); };
  auto bar_empty = [&](int s) { return smem_addr(&bars[1 + kStages + s]); };

  const int S = a.S;
  const int half = blockIdx.x % Pl::kSplit;
  // the last query tiles see the most keys under a causal mask: they start
  // first, so the short ones fill in behind them
  const int q0 = (gridDim.x / Pl::kSplit - 1 - blockIdx.x / Pl::kSplit) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  const int tid = threadIdx.x;
  const int q_last = min(q0 + kTile, S) - 1;
  int k_start, kv_hi;
  key_range(a, q0, q_last, kTile, k_start, kv_hi);
  const int n_tiles = (kv_hi - k_start + kTile - 1) / kTile;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), kConsumers / 32);   // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: one lane issues every TMA load ----
    if (tid == kConsumers) {
      mbar_expect_tx(bar_q, 2 * Tl::kBytes);
      tma_load_5d(q_s, &tm_q, bar_q, 0, q0, 0, h, b);
      tma_load_5d(do_s, &tm_do, bar_q, 0, q0, 0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(bar_empty(s), ((i / kStages) - 1) & 1);
        const int k0 = k_start + i * kTile;
        mbar_expect_tx(bar_full(s), 2 * Tl::kBytes);
        tma_load_5d(k_s(s), &tm_k, bar_full(s), 0, k0, 0, hk, b);
        tma_load_5d(v_s(s), &tm_v, bar_full(s), 0, k0, 0, hk, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup ----
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);     // rows r0 and r0 + 8 of the tile
  const int cq = (lane & 3) * 2;              // column pair in each 8-block
  const long long row_bh = (static_cast<long long>(b) * a.Hq + h) * S;

  // D = rowsum(dO o O) of the tile's rows: O from global memory (two
  // threads a row, every load issued before the wait for the tiles), dO
  // from its tile in shared memory, read through the TMA swizzle: the
  // 16-byte chunk ch of row r of a panel sits at chunk ch ^ ((r >> sh) &
  // mask), the address bits 7.. that the kSw-byte swizzle folds in
  constexpr int kHalfRow = HD / 2;            // elements per thread
  const int d_r = tid >> 1, d_qpos = q0 + d_r;
  uint4 o_raw[kHalfRow / 8];
  if (d_qpos < S) {
    const bf16* orow = static_cast<const bf16*>(a.o) + b * a.os.b + h * a.os.h +
                       d_qpos * a.os.s + (tid & 1) * kHalfRow;
#pragma unroll
    for (int c = 0; c < kHalfRow / 8; ++c) {
      o_raw[c] = *reinterpret_cast<const uint4*>(orow + c * 8);
    }
  }
  mbar_wait(bar_q, 0);
  {
    constexpr int kMask = Tl::kSw / 16 - 1, kShift = Tl::kSw == 128 ? 0 : Tl::kSw == 64 ? 1 : 2;
    float d = 0.f;
    if (d_qpos < S) {
      const int x = (d_r >> kShift) & kMask;
#pragma unroll
      for (int c = 0; c < kHalfRow / 8; ++c) {
        const int col = (tid & 1) * kHalfRow + c * 8;
        const int p = col / Tl::kPanelElems, ch = (col % Tl::kPanelElems) / 8;
        const uint4 dr = *reinterpret_cast<const uint4*>(
            gbase + Tl::kBytes + p * Tl::kPanelBytes + d_r * Tl::kSw + (ch ^ x) * 16);
        const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&o_raw[c]);
        const __nv_bfloat162* dh = reinterpret_cast<const __nv_bfloat162*>(&dr);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(oh[e]), df = __bfloat1622float2(dh[e]);
          d = fmaf(of.x, df.x, d);
          d = fmaf(of.y, df.y, d);
        }
      }
    }
    d += __shfl_xor_sync(kFullMask, d, 1);
    if ((tid & 1) == 0) {
      dlt_s[d_r] = d;
      lse_s[d_r] = d_qpos < S ? a.lse[row_bh + d_qpos] : 0.f;
      if (d_qpos < S && half == 0) a.delta[row_bh + d_qpos] = d;
    }
  }

  // q * scale, rounded to bf16 as the reference does, rewritten in place
  // (elementwise, so the swizzle does not matter), then stored as qs
  {
    const __nv_bfloat162 sc2 = __float2bfloat162_rn(round_to<bf16>(a.scale));
    const float2 s = __bfloat1622float2(sc2);
    __nv_bfloat162* qv = reinterpret_cast<__nv_bfloat162*>(gbase);
    for (int i = tid; i < Tl::kBytes / 4; i += kConsumers) {
      const float2 f = __bfloat1622float2(qv[i]);
      qv[i] = __floats2bfloat162_rn(f.x * s.x, f.y * s.y);
    }
    fence_proxy_async();
    named_barrier_sync(kConsumers);           // also publishes lse_s, dlt_s
  }
  if (tid == 0 && half == 0) {
    tma_store_5d(&tm_qs, q_s, 0, q0, 0, h, b);
    bulk_commit();
  }
  const float lse_r[2] = {lse_s[r0] * kLog2e, lse_s[r0 + 8] * kLog2e};  // log2 units
  const float dlt_r[2] = {dlt_s[r0], dlt_s[r0 + 8]};
  // the keys each of the thread's two rows sees: [klo, khi), visible()'s
  // mask as a range, so an edge tile costs two compares an element
  int klo[2], khi[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qpos = q0 + r0 + rr * 8;
    klo[rr] = a.window > 0 ? static_cast<int>(max(0LL, qpos - a.window + 1)) : 0;
    khi[rr] = qpos >= S ? 0 : a.causal ? qpos + 1 : S;
  }

  float dq[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) dq[i] = 0.f;
  float sc[32], dp[32];
  uint32_t da[4][4];
  const bool row_edge = q0 + kTile > S;
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int k0 = k_start + i * kTile;
    mbar_wait(bar_full(st), (i / kStages) & 1);
    wgmma_fence();
    issue_ss<HD>(sc, q_s, k_s(st));           // S = qs K^T
    wgmma_commit();
    issue_ss<HD>(dp, do_s, v_s(st));          // dP = dO V^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);
    // P = exp(S - lse) where visible (computed while dP runs)
    const bool edge = row_edge || k0 + kTile > S ||
                      (a.causal && k0 + kTile - 1 > q0) ||
                      (a.window > 0 && static_cast<long long>(k0) <= q_last - a.window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1, kpos = k0 + j * 8 + cq + (e & 1);
        const float p = exp2f(fmaf(sc[j * 4 + e], kLog2e, -lse_r[rr]));
        sc[j * 4 + e] = (!edge || (kpos >= klo[rr] && kpos < khi[rr])) ? p : 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS = P (dP - D), as bf16 A fragments
#pragma unroll
    for (int e = 0; e < 32; ++e) dp[e] = sc[e] * (dp[e] - dlt_r[(e >> 1) & 1]);
    to_a_frags(dp, da);
    fence_regs(da);
    wgmma_fence();
    issue_rs<HD>(dq, da, k_s(st) + half * Pl::kColOff);   // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty(st));
  }

  bf16* dqb = static_cast<bf16*>(a.dq) + b * a.dqs.b + h * a.dqs.h + half * Pl::HDC;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qpos = q0 + r0 + rr * 8;
    if (qpos >= S) continue;
#pragma unroll
    for (int j = 0; j < NQ / 4; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dqb + qpos * a.dqs.s + j * 8 + cq) =
          __floats2bfloat162_rn(dq[j * 4 + 2 * rr] * a.scale, dq[j * 4 + 2 * rr + 1] * a.scale);
    }
  }
  if (tid == 0 && half == 0) bulk_wait_all();   // qs written before pass 2 reads it
}

// Two CTAs a SM up to hd 64 (168 registers; at 5 warps a CTA, 10 warps on 4
// sub-partitions need <= 168): granite-moe's (8,128,16,64) / KV 8 then runs
// its 256 CTAs in one wave, not two. From hd 80 up, dK and dV alone take
// HD registers a thread, and one CTA a SM holds them without spilling.
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, HD <= 64 ? 2 : 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_qs,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const BwdArgs a) {
  using Pl = BwdPlan<HD>;
  using Tl = SwTile<HD>;
  constexpr int HDC = Pl::HDC;
  constexpr int NC = HDC / 2;          // dK and dV accumulator registers per thread
  constexpr int kStages = Pl::kStages;
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // k/v, full[], empty[]
  __shared__ __align__(16) float lse_s[kStages][kTile];
  __shared__ __align__(16) float dlt_s[kStages][kTile];
  extern __shared__ unsigned char dkv_smem_raw[];
  const uint32_t raw = smem_addr(dkv_smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = dkv_smem_raw + (base - raw);
  const uint32_t k_s = base, v_s = base + Tl::kBytes;
  auto q_s = [&](int s) { return base + (2 + 2 * s) * Tl::kBytes; };
  auto do_s = [&](int s) { return base + (3 + 2 * s) * Tl::kBytes; };
  float* stg = reinterpret_cast<float*>(gbase + 2 * Tl::kBytes);  // [2][64][kPitch]
  const uint32_t bar_kv = smem_addr(&bars[0]);
  auto bar_full = [&](int s) { return smem_addr(&bars[1 + s]); };
  auto bar_empty = [&](int s) { return smem_addr(&bars[1 + kStages + s]); };

  const int S = a.S;
  // grid (Hq, B, key tiles x kSplit), clusters along x: the launch order
  // walks the heads, then the rows, then the key tiles, so every early key
  // tile (under a causal mask the one most queries see) is under way
  // before a late one, and a last partial wave holds the light CTAs
  const int half = blockIdx.z % Pl::kSplit;
  const int k0 = (blockIdx.z / Pl::kSplit) * kTile;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / a.group;
  const int tid = threadIdx.x;
  const int k_last = min(k0 + kTile, S) - 1;
  int q_start, q_hi;
  query_range(a, k0, k_last, kTile, q_start, q_hi);
  const int n_tiles = (q_hi - q_start + kTile - 1) / kTile;
  const long long row_bh = (static_cast<long long>(b) * a.Hq + h) * S;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 2);                  // TMA bytes + the lanes' lse/D
      mbar_init(bar_empty(s), kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: lane 0 issues the TMA loads, every lane copies
    // the query tile's lse and D into the stage ----
    const int lane = tid & 31;
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * Tl::kBytes);
      tma_load_5d(k_s, &tm_k, bar_kv, 0, k0, 0, hk, b);
      tma_load_5d(v_s, &tm_v, bar_kv, 0, k0, 0, hk, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(bar_empty(s), ((i / kStages) - 1) & 1);
      const int q0 = q_start + i * kTile;
      if (lane == 0) {
        mbar_expect_tx(bar_full(s), 2 * Tl::kBytes);
        tma_load_5d(q_s(s), &tm_qs, bar_full(s), 0, q0, 0, h, b);
        tma_load_5d(do_s(s), &tm_do, bar_full(s), 0, q0, 0, h, b);
      }
      for (int r = lane; r < kTile; r += 32) {
        const bool in = q0 + r < S;
        lse_s[s][r] = in ? a.lse[row_bh + q0 + r] * kLog2e : 0.f;   // log2 units
        dlt_s[s][r] = in ? a.delta[row_bh + q0 + r] : 0.f;
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_full(s));
    }
  } else {
    // ---- consumer warpgroup ----
    const int warp = tid >> 5, lane = tid & 31;
    const int r0 = warp * 16 + (lane >> 2);   // key rows r0 and r0 + 8 of the tile
    const int cq = (lane & 3) * 2;            // query column pair in each 8-block
    float dk[NC], dv[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) dk[i] = dv[i] = 0.f;
    float st[32], dpt[32];
    uint32_t pa[4][4], da[4][4];
    const bool key_edge = k0 + kTile > S;
    // the queries each of the thread's two key rows is seen by: [qlo, qhi)
    int qlo[2], qhi[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int kpos = k0 + r0 + rr * 8;
      qlo[rr] = a.causal ? kpos : 0;
      qhi[rr] = kpos >= S ? 0
                : a.window > 0 ? static_cast<int>(min(static_cast<long long>(S), kpos + a.window))
                               : S;
    }
    mbar_wait(bar_kv, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int q0 = q_start + i * kTile;
      mbar_wait(bar_full(s), (i / kStages) & 1);
      wgmma_fence();
      issue_ss<HD>(st, k_s, q_s(s));          // S^T = K qs^T
      wgmma_commit();
      issue_ss<HD>(dpt, v_s, do_s(s));        // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);
      // P^T = exp(S^T - lse[query]) where visible (while dP^T runs)
      const bool edge = key_edge || q0 + kTile > S ||
                        (a.causal && k0 + kTile - 1 > q0) ||
                        (a.window > 0 &&
                         static_cast<long long>(k0) <= static_cast<long long>(q0) + kTile - 1 -
                                                           a.window);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(&lse_s[s][j * 8 + cq]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = e >> 1, qpos = q0 + j * 8 + cq + (e & 1);
          const float p = exp2f(fmaf(st[j * 4 + e], kLog2e, -((e & 1) ? l2.y : l2.x)));
          st[j * 4 + e] = (!edge || (qpos >= qlo[rr] && qpos < qhi[rr])) ? p : 0.f;
        }
      }
      wgmma_wait<0>();
      fence_regs(dpt);
      // dS^T = P^T (dP^T - D[query])
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(&dlt_s[s][j * 8 + cq]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dpt[j * 4 + e] = st[j * 4 + e] * (dpt[j * 4 + e] - ((e & 1) ? d2.y : d2.x));
        }
      }
      to_a_frags(st, pa);
      to_a_frags(dpt, da);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
      issue_rs<HD>(dv, pa, do_s(s) + half * Pl::kColOff);   // dV += P^T dO
      issue_rs<HD>(dk, da, q_s(s) + half * Pl::kColOff);    // dK += dS^T qs
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty(s));
    }
    if (a.group == 1) {
      // the head is its KV head's whole group: dK, dV straight to global
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int kpos = k0 + r0 + rr * 8;
        if (kpos >= S) continue;
        bf16* rk = static_cast<bf16*>(a.dk) + b * a.dks.b + kpos * a.dks.s + hk * a.dks.h +
                   half * HDC;
        bf16* rv = static_cast<bf16*>(a.dv) + b * a.dvs.b + kpos * a.dvs.s + hk * a.dvs.h +
                   half * HDC;
#pragma unroll
        for (int j = 0; j < NC / 4; ++j) {
          *reinterpret_cast<uint32_t*>(rk + j * 8 + cq) =
              pack_bf16(dk[j * 4 + 2 * rr], dk[j * 4 + 2 * rr + 1]);
          *reinterpret_cast<uint32_t*>(rv + j * 8 + cq) =
              pack_bf16(dv[j * 4 + 2 * rr], dv[j * 4 + 2 * rr + 1]);
        }
      }
      return;
    }
    // this head's dK and dV, fp32, into the staging tile (the ring's bytes:
    // every load into the ring has been consumed)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float* rk = stg + (r0 + rr * 8) * Pl::kPitch;
      float* rv = rk + kTile * Pl::kPitch;
#pragma unroll
      for (int j = 0; j < NC / 4; ++j) {
        *reinterpret_cast<float2*>(rk + j * 8 + cq) =
            make_float2(dk[j * 4 + 2 * rr], dk[j * 4 + 2 * rr + 1]);
        *reinterpret_cast<float2*>(rv + j * 8 + cq) =
            make_float2(dv[j * 4 + 2 * rr], dv[j * 4 + 2 * rr + 1]);
      }
    }
  }

  // ---- the group's sum, across the cluster (every thread of every CTA
  // takes part in both cluster barriers) ----
  if (a.group == 1) return;
  cluster_sync();
  if (tid < kConsumers) {
    const int G = a.group;
    const uint32_t rank = cluster_rank();     // = h % G: rank order is head order
    const int rows = (kTile + G - 1) / G;
    const int rlo = static_cast<int>(rank) * rows;
    const int rhi = min(kTile, rlo + rows);
    constexpr int C4 = HDC / 4;
    const int per = (rhi > rlo ? rhi - rlo : 0) * C4;
    const uint32_t stg_addr = smem_addr(stg);
    // kBatch outputs a thread at a time, each the sum of G float4s read
    // through the cluster: all of a batch's loads are issued before any
    // sum (distributed shared memory is latency bound), then each output
    // is summed in rank order
    constexpr int kBatch = 2, kMaxG = 8;       // 64 registers: dK's and dV's, freed
    for (int e0 = tid; e0 < 2 * per; e0 += kBatch * kConsumers) {
      float4 t[kBatch][kMaxG];
      uint32_t off[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kConsumers;
        const int m = e >= per;                 // 0: dK, 1: dV
        const int rem = e - m * per;
        off[u] = static_cast<uint32_t>(
            ((m * kTile + rlo + rem / C4) * Pl::kPitch + (rem % C4) * 4) * 4);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (e < 2 * per && g < G) {
            t[u][g] = g == static_cast<int>(rank)
                          ? *reinterpret_cast<const float4*>(
                                reinterpret_cast<const unsigned char*>(stg) + off[u])
                          : ld_cluster_f4(map_rank(stg_addr + off[u], g));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kConsumers;
        if (e >= 2 * per) break;
        const int m = e >= per;
        const int rem = e - m * per;
        const int kpos = k0 + rlo + rem / C4;
        if (kpos >= S) continue;
        float4 acc = t[u][0];
#pragma unroll
        for (int g = 1; g < kMaxG; ++g) {
          if (g < G) {
            acc.x += t[u][g].x;
            acc.y += t[u][g].y;
            acc.z += t[u][g].z;
            acc.w += t[u][g].w;
          }
        }
        const Strides& os = m ? a.dvs : a.dks;
        bf16* dst = static_cast<bf16*>(m ? a.dv : a.dk) + b * os.b + kpos * os.s +
                    hk * os.h + half * HDC + (rem % C4) * 4;
        uint2 w;
        w.x = pack_bf16(acc.x, acc.y);
        w.y = pack_bf16(acc.z, acc.w);
        *reinterpret_cast<uint2*>(dst) = w;
      }
    }
  }
  cluster_sync();                              // no CTA leaves while another reads it
}

// ---------------------------------------------------------------------------
// fp32: scalar FMA kernels (dq, then dK/dV per q head into fp32 partials,
// then the group's sum)
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
  using Pl = BwdPlan<HD>;
  if (a.group > 8) return static_cast<int>(cudaErrorInvalidValue);  // portable cluster
  const long long hd = HD;
  const Strides qss{static_cast<long long>(a.S) * a.Hq * hd, a.Hq * hd, hd};
  CUtensorMap mq, mk, mv, mdo, mqs;
  if (!make_map<HD>(&mq, a.q, B, a.S, a.Hq, a.qs) ||
      !make_map<HD>(&mk, a.k, B, a.S, Hkv, a.ks) ||
      !make_map<HD>(&mv, a.v, B, a.S, Hkv, a.vs) ||
      !make_map<HD>(&mdo, a.dout, B, a.S, a.Hq, a.dos) ||
      !make_map<HD>(&mqs, a.qsc, B, a.S, a.Hq, qss)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const int attr = set_smem(flash_bwd_dq_wgmma_kernel<HD>, Pl::kDqSmem) |
                          set_smem(flash_bwd_dkv_wgmma_kernel<HD>, Pl::kDkvSmem);
  if (attr != 0) return attr;
  const dim3 grid(((a.S + kTile - 1) / kTile) * Pl::kSplit, a.Hq, B);
  flash_bwd_dq_wgmma_kernel<HD><<<grid, kBwdThreads, Pl::kDqSmem, s>>>(mq, mdo, mk, mv, mqs, a);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  // pass 2 in clusters of `group` CTAs along the q heads: one KV head's group
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hq, B, grid.x);
  cfg.blockDim = dim3(kBwdThreads, 1, 1);
  cfg.dynamicSmemBytes = Pl::kDkvSmem;
  cfg.stream = s;
  cudaLaunchAttribute cl[1];
  cl[0].id = cudaLaunchAttributeClusterDimension;
  cl[0].val.clusterDim.x = static_cast<unsigned>(a.group);
  cl[0].val.clusterDim.y = 1;
  cl[0].val.clusterDim.z = 1;
  cfg.attrs = cl;
  cfg.numAttrs = 1;
  const cudaError_t e2 =
      cudaLaunchKernelEx(&cfg, flash_bwd_dkv_wgmma_kernel<HD>, mqs, mdo, mk, mv, a);
  if (e2 != cudaSuccess) return static_cast<int>(e2);
  return static_cast<int>(cudaGetLastError());
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
// ws: the workspace of hydra_flash_attention_bwd_workspace's size, fp32
// (2, B, S, Hq, hd) partials for fp32, a bf16 (B, S, Hq, hd) qs for bf16.
// window <= 0 means no window. bf16 refuses a group (Hq / Hkv) above 8.
extern "C" int hydra_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* delta, void* ws, void* dq, void* dk,
                                         void* dv, int B,
                                         int S, int Hq, int Hkv, int hd, const long long* st,
                                         float scale, int causal, long long window,
                                         int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || Hkv > 65535 || B > 65535 ||
      (dtype != kF32 && dtype != kBF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool f32 = dtype == kF32;
  BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
            dq, dk, dv, f32 ? static_cast<float*>(ws) : nullptr, f32 ? nullptr : ws,
            {st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
            {st[9], st[10], st[11]}, {st[12], st[13], st[14]}, {st[15], st[16], st[17]},
            {st[18], st[19], st[20]}, {st[21], st[22], st[23]},
            B, S, Hq, Hq / Hkv, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HYDRA_FLASH_BWD_HD(D)                                                  \
  case D:                                                                      \
    return f32 ? launch_f32<D>(a, B, Hkv, s) : launch_bf16<D>(a, B, Hkv, s);
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

namespace {

// How many CTAs of each bf16 pass the card holds at once, for head dim hd
// and a GQA group: *dq the dq pass's CTAs a SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), *dkv_clusters the dk/dv
// pass's clusters of `group` CTAs (cudaOccupancyMaxActiveClusters). The
// waves of a launch follow from its CTAs.

template <int HD>
int occupancy(int group, int* dq, int* dkv_clusters) {
  using Pl = BwdPlan<HD>;
  const int attr = set_smem(flash_bwd_dq_wgmma_kernel<HD>, Pl::kDqSmem) |
                   set_smem(flash_bwd_dkv_wgmma_kernel<HD>, Pl::kDkvSmem);
  if (attr != 0) return attr;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      dq, flash_bwd_dq_wgmma_kernel<HD>, kBwdThreads, Pl::kDqSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(group), 1, 1);
  cfg.blockDim = dim3(kBwdThreads, 1, 1);
  cfg.dynamicSmemBytes = Pl::kDkvSmem;
  cudaLaunchAttribute cl[1];
  cl[0].id = cudaLaunchAttributeClusterDimension;
  cl[0].val.clusterDim.x = static_cast<unsigned>(group);
  cl[0].val.clusterDim.y = 1;
  cl[0].val.clusterDim.z = 1;
  cfg.attrs = cl;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(dkv_clusters, flash_bwd_dkv_wgmma_kernel<HD>, &cfg);
  return static_cast<int>(e);
}

}  // namespace

extern "C" int hydra_flash_attention_bwd_occupancy(int hd, int group, int* dq,
                                                    int* dkv_clusters) {
  if (group < 1 || group > 8) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return occupancy<16>(group, dq, dkv_clusters);
    case 32: return occupancy<32>(group, dq, dkv_clusters);
    case 64: return occupancy<64>(group, dq, dkv_clusters);
    case 80: return occupancy<80>(group, dq, dkv_clusters);
    case 128: return occupancy<128>(group, dq, dkv_clusters);
    case 256: return occupancy<256>(group, dq, dkv_clusters);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Bytes of the workspace hydra_flash_attention_bwd takes: fp32 (dtype 0)
// the (2, B, S, Hq, hd) fp32 partials of dK and dV, bf16 (dtype 1) qs, a
// (B, S, Hq, hd) bf16 tensor.
extern "C" long long hydra_flash_attention_bwd_workspace(int B, int S, int Hq, int hd,
                                                          int dtype) {
  const long long n = static_cast<long long>(B) * S * Hq * hd;
  return dtype == kF32 ? 2 * n * 4 : n * 2;
}
