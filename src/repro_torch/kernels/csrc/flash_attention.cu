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
// Bound on the H100: operations at long S, bytes at short S; at serving
// prompt lengths (S = 500, 128 CTAs of 64 rows) what limits it is latency
// and occupancy: each CTA walks at most 8 KV tiles.
//
// bf16 (the serving path) runs flash_wgmma_kernel, built for Hopper:
//  - one consumer warpgroup (128 threads) multiplies on the tensor cores
//    with wgmma: S = Q K^T as m64n64k16 with both operands in shared
//    memory, O += P V as m64n{hd}k16 with P in registers (bf16, the
//    reference's rounding point) and V as the transposed (MN-major) operand;
//  - one producer warp keeps K/V tiles (64 keys) in flight through TMA into
//    a ring of 2-4 stages (as many as shared memory holds) with mbarrier
//    completion. Each tensor map is 5-D over the (B,S,H,hd) tensor through
//    its strides, with hd cut into panels of the widest swizzle that
//    divides a row (128 bytes for hd 64/128/256; 64 bytes for hd 224, whose
//    448-byte rows are seven 64-byte panels; 32 bytes for hd 80, whose
//    160-byte rows fit no 128-byte panel), so one layout and one
//    descriptor form serve every head dim and no transposed copy is made.
//    TMA fills zeros past S and past hd, which pads hd 8 to wgmma's depth
//    of 16.
//  - the consumer pipelines inside the warpgroup: S_{i+1} = Q K_{i+1}^T is
//    issued before O += P_i V_i, and the softmax of tile i+1 runs while
//    the tensor cores finish P_i V_i.
//  - tiles above the causal diagonal or before the window are never
//    visited; only diagonal, window-edge and ragged tiles are masked.
// fp32 stays on flash_fwd_kernel, scalar FMAs on the CUDA cores: wgmma on
// fp32 would be TF32, which breaks the fp32 2e-5 tolerance. bf16 tensors
// whose layout TMA cannot address (a base or a stride not a multiple of 16
// bytes) are refused.
//
// Semantics kept from the reference: q*scale is rounded to q's dtype, the
// masks fill -1e30 (so a tile that is masked for a row is wiped by the
// first valid key's rescale), and the result is acc / max(l, 1e-30).
//
// Both kernels optionally write each row's log-sum-exp of the scaled
// scores, m + log(max(l, 1e-30)), as fp32 (B, Hq, S): the training
// path's backward (flash_attention_bwd.cu) recomputes P from it. The
// serving path passes a null pointer and writes nothing more.
#include "common.cuh"
#include "hopper.cuh"
#include "tma.cuh"

using namespace hydra;

namespace {

// ---------------------------------------------------------------------------
// scalar kernel (fp32)
// ---------------------------------------------------------------------------
constexpr int kBQ = 16;                // query rows per block
constexpr int kBK = 32;                // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBQ / kWarps;

template <int HD>
constexpr int scalar_smem_bytes() {    // Qs, Ks (+1 column), Vs as fp32
  return (kBQ * HD + kBK * (HD + 1) + kBK * HD) * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int group,
                 Strides qs, Strides ks, Strides vs, Strides os, float scale,
                 int causal, long long window, float* __restrict__ lse) {
  constexpr int DPL = (HD + 31) / 32;  // head dims per lane in the PV product
  extern __shared__ float scalar_smem[];
  float(*Qs)[HD] = reinterpret_cast<float(*)[HD]>(scalar_smem);
  // +1: lane j reads row j conflict-free
  float(*Ks)[HD + 1] = reinterpret_cast<float(*)[HD + 1]>(scalar_smem + kBQ * HD);
  float(*Vs)[HD] =
      reinterpret_cast<float(*)[HD]>(scalar_smem + kBQ * HD + kBK * (HD + 1));

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
    if (lse != nullptr && lane == 0) {
      lse[(static_cast<long long>(b) * gridDim.y + h) * S + qpos] =
          m[r] + logf(fmaxf(l[r], 1e-30f));
    }
    T* orow = o + b * os.b + qpos * os.s + h * os.h;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) orow[d] = from_f<T>(acc[r][i] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma + TMA kernel (bf16)
// ---------------------------------------------------------------------------
constexpr int kConsumers = 128;        // one warpgroup
constexpr int kFlashThreads = kConsumers + 32;   // + one producer warp

// The tile layout is tma.cuh's SwTile; the forward adds its K/V ring depth:
// as many stages as fit, up to 4.
template <int HD>
struct WgTile : SwTile<HD> {
  using Base = SwTile<HD>;
  static constexpr int kStages0 = (kSmemMax - 2048 - Base::kBytes) / (2 * Base::kBytes);
  static constexpr int kStages = kStages0 > 4 ? 4 : kStages0;
  static constexpr int kSmem = (1 + 2 * kStages) * Base::kBytes + 1024;  // + align
  static_assert(kStages >= 2, "the K/V ring needs two stages");
};

struct FlashArgs {
  __nv_bfloat16* o;
  Strides os;
  int S, group;
  float scale;
  int causal;
  long long window;
  float* lse;        // (B, Hq, S) or null
};

template <int HD>
__global__ void __launch_bounds__(kFlashThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, FlashArgs args) {
  using Tl = WgTile<HD>;
  constexpr int HDP = Tl::HDP;
  constexpr int NO = HDP / 2;          // O accumulator registers per thread
  constexpr int kStages = Tl::kStages;
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // q, full[], empty[]
  extern __shared__ unsigned char wg_smem_raw[];
  const uint32_t raw = smem_addr(wg_smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms align
  unsigned char* gbase = wg_smem_raw + (base - raw);
  const uint32_t q_s = base;
  auto k_s = [&](int s) { return base + (1 + s) * Tl::kBytes; };
  auto v_s = [&](int s) { return base + (1 + kStages + s) * Tl::kBytes; };
  const uint32_t bar_q = smem_addr(&bars[0]);
  auto bar_full = [&](int s) { return smem_addr(&bars[1 + s]); };
  auto bar_empty = [&](int s) { return smem_addr(&bars[1 + kStages + s]); };

  const int S = args.S;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / args.group;
  const int tid = threadIdx.x;

  const int q_last = min(q0 + kTile, S) - 1;
  const int kv_hi = args.causal ? q_last + 1 : S;
  long long kv_lo = 0;
  if (args.window > 0) kv_lo = max(0LL, static_cast<long long>(q0) - args.window + 1);
  const int k_start =
      static_cast<int>(min(kv_lo, static_cast<long long>(kv_hi)) / kTile) * kTile;
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
      mbar_expect_tx(bar_q, Tl::kBytes);
      tma_load_5d(q_s, &tm_q, bar_q, 0, q0, 0, h, b);
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
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);     // rows r0 and r0 + 8 of the tile
  const int cq = (lane & 3) * 2;              // column pair in each 8-block

  // q * scale, rounded to bf16 as the reference does, rewritten in place
  // (elementwise, so the swizzle does not matter)
  mbar_wait(bar_q, 0);
  {
    const __nv_bfloat162 sc2 = __float2bfloat162_rn(round_to<__nv_bfloat16>(args.scale));
    __nv_bfloat162* qv = reinterpret_cast<__nv_bfloat162*>(gbase);
    for (int i = tid; i < Tl::kBytes / 4; i += kConsumers) {
      const float2 f = __bfloat1622float2(qv[i]);
      const float2 s = __bfloat1622float2(sc2);
      qv[i] = __floats2bfloat162_rn(f.x * s.x, f.y * s.y);
    }
    fence_proxy_async();
    named_barrier_sync(kConsumers);
  }

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float sc[32];

  // S = (q*scale) K^T for the tile in stage s: 64 x 64, fp32
  auto issue_qk = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      wgmma_ss_n64(sc, desc_sw<Tl::kLayout>(q_s + Tl::kstep(kk), 16, 8 * Tl::kSw),
                   desc_sw<Tl::kLayout>(k_s(s) + Tl::kstep(kk), 16, 8 * Tl::kSw),
                   kk > 0);
    }
  };
  // mask, then the online softmax of this thread's two rows (a row's 64
  // scores lie in the quad of lanes that share lane >> 2): sc becomes the
  // tile's probabilities against the new running max, alpha the factor
  // that rescales what O holds so far
  auto softmax = [&](int k0) {
    const bool edge = k0 + kTile > S ||
                      (args.causal && k0 + kTile - 1 > q0) ||
                      (args.window > 0 &&
                       static_cast<long long>(k0) <= q_last - args.window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = q0 + r0 + (e >> 1) * 8;
          const int kpos = k0 + j * 8 + cq + (e & 1);
          bool valid = kpos < S;
          if (args.causal) valid = valid && kpos <= qpos;
          if (args.window > 0) {
            valid = valid && static_cast<long long>(kpos) >
                                 static_cast<long long>(qpos) - args.window;
          }
          if (!valid) sc[j * 4 + e] = kNegInf;
        }
      }
    }
    constexpr float kLog2e = 1.4426950408889634f;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = m[rr];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx = fmaxf(mx, fmaxf(sc[j * 4 + 2 * rr], sc[j * 4 + 2 * rr + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
      alpha[rr] = exp2f((m[rr] - mx) * kLog2e);
      m[rr] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f((sc[j * 4 + 2 * rr + c] - mx) * kLog2e);
          sc[j * 4 + 2 * rr + c] = p;
          sum += p;
        }
      }
      l[rr] = l[rr] * alpha[rr] + sum;   // this thread's share; quad-summed at the end
    }
  };

  mbar_wait(bar_full(0), 0);
  wgmma_fence();
  issue_qk(0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(k_start);

  // P_i (bf16, the reference's rounding point) as wgmma A fragments, after
  // O is rescaled to the new running max: the accumulator layout of S is
  // the register layout of A, 16 keys per step
  uint32_t pa[4][4];
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      o[j * 4 + 0] *= alpha[0];
      o[j * 4 + 1] *= alpha[0];
      o[j * 4 + 2] *= alpha[1];
      o[j * 4 + 3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        __nv_bfloat162 t = __floats2bfloat162_rn(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        pa[kk][r] = *reinterpret_cast<uint32_t*>(&t);
      }
    }
    fence_regs(o);
    fence_regs(sc);
    wgmma_fence();
  };
  // O += P_i V_i. V (keys x hd) is the MN-major B operand: 16 keys = two
  // 8-row groups of 8 * kSw bytes, hd panels kPanelBytes apart
  auto issue_pv = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<HDP>(o, pa[kk], desc_sw<Tl::kLayout>(v_s(s) + kk * 16 * Tl::kSw,
                                                    Tl::kPanelBytes, 8 * Tl::kSw));
    }
    wgmma_commit();
  };
  auto retire = [&](int s) {         // P_i V_i is done: K_i, V_i consumed
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty(s));
  };

  // Software pipeline inside the warpgroup: S_{i+1} = Q K_{i+1}^T is issued
  // before P_i V_i, and the softmax of tile i+1 runs while the tensor cores
  // finish P_i V_i. The last tile is peeled off, so that no branch sits
  // between a wgmma and its wait.
  for (int i = 0; i + 1 < n_tiles; ++i) {
    rescale_and_pack();
    mbar_wait(bar_full((i + 1) % kStages), ((i + 1) / kStages) & 1);
    issue_qk((i + 1) % kStages);
    wgmma_commit();
    issue_pv(i % kStages);
    wgmma_wait<1>();                 // S_{i+1} is in; P_i V_i may run on
    fence_regs(sc);
    softmax(k_start + (i + 1) * kTile);
    retire(i % kStages);
  }
  rescale_and_pack();
  issue_pv((n_tiles - 1) % kStages);
  retire((n_tiles - 1) % kStages);

  // epilogue: acc / max(l, 1e-30), written as bf16 pairs
  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float t = l[rr];
    t += __shfl_xor_sync(kFullMask, t, 1);
    t += __shfl_xor_sync(kFullMask, t, 2);
    inv[rr] = 1.0f / fmaxf(t, 1e-30f);
    const int qpos = q0 + r0 + rr * 8;
    if (args.lse != nullptr && (lane & 3) == 0 && qpos < S) {
      args.lse[(static_cast<long long>(b) * gridDim.y + h) * S + qpos] =
          m[rr] + logf(fmaxf(t, 1e-30f));
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qpos = q0 + r0 + rr * 8;
    if (qpos >= S) continue;
    __nv_bfloat16* orow = args.o + b * args.os.b + qpos * args.os.s + h * args.os.h;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int col = j * 8 + cq;
      if (col < HD) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            o[j * 4 + 2 * rr] * inv[rr], o[j * 4 + 2 * rr + 1] * inv[rr]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int Hq, int Hkv, int group, Strides qs, Strides ks,
                 Strides vs, Strides os, float scale, int causal,
                 long long window, float* lse, cudaStream_t stream) {
  using Tl = WgTile<HD>;
  CUtensorMap mq, mk, mv;
  if (!make_map<HD>(&mq, q, B, S, Hq, qs) ||
      !make_map<HD>(&mk, k, B, S, Hkv, ks) ||
      !make_map<HD>(&mv, v, B, S, Hkv, vs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tl::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((S + kTile - 1) / kTile, Hq, B);
  const FlashArgs args{static_cast<__nv_bfloat16*>(o), os, S, group, scale,
                       causal, window, lse};
  flash_wgmma_kernel<HD><<<grid, kFlashThreads, Tl::kSmem, stream>>>(mq, mk, mv, args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_scalar(const void* q, const void* k, const void* v, void* o, int B,
                  int S, int Hq, int group, Strides qs, Strides ks, Strides vs,
                  Strides os, float scale, int causal, long long window,
                  float* lse, cudaStream_t stream) {
  constexpr int smem = scalar_smem_bytes<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, group, qs, ks, vs, os,
      scale, causal, window, lse);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(int dtype, bool tma, const void* q, const void* k, const void* v,
           void* o, int B, int S, int Hq, int Hkv, int group, Strides qs,
           Strides ks, Strides vs, Strides os, float scale, int causal,
           long long window, float* lse, cudaStream_t s) {
  if (dtype == kBF16) {
    if (!tma) return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma<HD>(q, k, v, o, B, S, Hq, Hkv, group, qs, ks, vs, os,
                            scale, causal, window, lse, s);
  }
  return launch_scalar<float, HD>(q, k, v, o, B, S, Hq, group, qs, ks, vs, os,
                                  scale, causal, window, lse, s);
}

}  // namespace

// window <= 0 means no window. Strides are in elements. lse: fp32
// (B, Hq, S) log-sum-exp of each row's scaled scores, or null.
extern "C" int hydra_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int S, int Hq,
    int Hkv, int hd, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, int causal, long long window, int dtype,
    void* lse, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || B > 65535 ||
      (dtype != kF32 && dtype != kBF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  const bool tma = tma_ok(q, qs) && tma_ok(k, ks) && tma_ok(v, vs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = Hq / Hkv;
#define HYDRA_FLASH_HD(D)                                                       \
  case D:                                                                       \
    return launch<D>(dtype, tma, q, k, v, o, B, S, Hq, Hkv, group, qs, ks, vs, \
                     os, scale, causal, window, static_cast<float*>(lse), s);
  switch (hd) {
    HYDRA_FLASH_HD(8)
    HYDRA_FLASH_HD(16)
    HYDRA_FLASH_HD(32)
    HYDRA_FLASH_HD(64)
    HYDRA_FLASH_HD(80)
    HYDRA_FLASH_HD(128)
    HYDRA_FLASH_HD(224)
    HYDRA_FLASH_HD(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HYDRA_FLASH_HD
}
