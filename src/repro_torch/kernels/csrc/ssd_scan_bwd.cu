// Backward of the Mamba2 SSD chunked scan (csrc/ssd_scan.cu): from the
// forward's inputs x (B,S,H,P), dt (B,S,H) fp32, A (H,) fp32, Bm/Cm (B,S,N)
// (x, Bm, Cm in one dtype, read through their strides), the cotangent dy
// (B,S,H,P) in x's dtype and optionally the final state's (B,H,P,N) fp32,
// it writes dx, dB, dC in x's dtype, ddt and dA in fp32, and optionally
// the initial state's gradient (B,H,P,N) fp32. It reads what the forward
// saved: a_cs (B, chunks, H, chunk) and the state entering each chunk
// (B, chunks, H, P, N), both fp32.
//
// What it replaces: no Pallas backward exists. The JAX package trains by
// jax.value_and_grad through its jnp oracle (repro/kernels/ref.py
// ssd_scan_ref), so this replaces that gradient, not a TPU kernel. The math
// per chunk, with a = dt A, a_cs its in-chunk cumsum, dtx = dt x, L[l,s] =
// exp(a_cs[l] - a_cs[s]) for s <= l (masked before exp: never factored
// through exp(-a_cs)), prev the state entering the chunk and G the
// cotangent of the state leaving it:
//   G_c      = G_{c+1} exp(a_cs_c[-1]) + U_c,  U_c = sum_l exp(a_cs[l]) dy[l]^T C[l]
//   dW[l,s]  = <dy[l], dtx[s]>,  dCB = L o dW,  E = (C B^T) o dCB
//   d dtx[s] = sum_{l>=s} (C B^T)[l,s] L[l,s] dy[l] + exp(a_cs[-1]-a_cs[s]) G B[s]
//   dB[s]   += sum_h sum_l dCB[l,s] C[l] + exp(a_cs[-1]-a_cs[s]) dtx[s]^T G
//   dC[l]   += sum_h sum_s dCB[l,s] B[s] + exp(a_cs[l]) dy[l]^T prev
//   d a_cs   = rowsum E + <dy, Y_off> - colsum E - r, with r[s] = <dtx[s],
//              exp(a_cs[-1]-a_cs[s]) G B[s]>, and at the chunk's last row
//              + sum_s r[s] + exp(a_cs[-1]) <G, prev>
//   d a      = reverse cumsum of d a_cs (fp64, rounded once, as the forward's
//              cumsum); ddt = A d a + <x, d dtx>; dx = dt d dtx; dA = sum dt d a.
// Positions past S read as zeros and never enter a mask, which is the
// reference's dt = 0 padding, so a ragged last chunk has the exact gradient.
// No atomics: every sum runs in a fixed order, so two calls are bit-equal.
//
// What bounds it on the H100: at the training shapes (8 x 128, one chunk of
// 128, H 80 / 48) the inputs and outputs move 33-43 MB, about 0.01 ms at
// 3.35 TB/s, and the products over the visible (l, s) pairs are about 5
// GFLOP, 0.005 ms at the bf16 tensor-core rate (twice that with the hi + lo
// splits below). Both are small against what a CTA's few 64 x 64 tiles cost
// in latency: loads, barriers, and the per-element mask and exp.
//
// bf16 (the training path) runs on the tensor cores: mma.sync m16n8k16 (bf16
// in, fp32 accumulate) fed by ldmatrix, as the forward's passes.
//   bwd_mma_kernel, one CTA of 8 warps per (row, chunk, head), in clusters
//     of up to 8 heads of one (row, chunk): the s tiles in order, and for
//     each the l tiles on or below the diagonal, so every (l, s) tile pair
//     is visited once. A pair computes C B^T (exact operands) and dW =
//     dt[s] <dy[l], x[s]> (exact operands, dt on the output column) once,
//     builds dCB and M = (C B^T) o L from them, and feeds both sides: the
//     l side dC_h[l] += dCB B (kept in registers while consecutive pairs
//     share the l tile, else parked), the s side d dtx += M^T dy and dB_h +=
//     dCB^T C (registers over the s tile's pairs). E is never formed: rowsum
//     E + <dy, Y_off> = <C[l], dC_h[l]> and colsum E + r = <B[s], dB_h[s]>
//     are read off the finished tiles.
//     A finished dB_h or dC_h tile is summed over the cluster's heads in rank
//     order through distributed shared memory, so device memory holds one
//     partial per cluster (B, H / cluster, S, N) instead of one per head.
//     Then, in the same CTA, d a_cs, its fp64 reverse cumsum, ddt and the
//     fp64 partial dA. Its six per-position arrays (a_cs, dt, the row and
//     column parts, r, <x, d dtx>) sit in shared memory, or, for a chunk
//     too long for that (past 5,120 positions at P 128 / N 128), in a
//     workspace (kLong), so it takes every chunk the forward takes.
//   bwd_mma_state_kernel, per (row, chunk, head), U_c on the tensor cores;
//   bwd_grec_kernel, the reverse recurrence over the chunks (G_{c+1}, d init);
//   bwd_reduce_kernel, the clusters' partial dB, dC summed in order, dA.
// No work on a zero state: with one chunk and no final-state cotangent G is
// zero, so neither U_c nor the recurrence runs and no G product is made;
// U_0 runs only for an init state's gradient; the chunk-0 products with the
// entering state run only with an init state. So the training shapes
// launch two kernels. Accuracy: x, B, C and dy are exact bf16 operands; each
// fp32 operand (dCB, M, G, prev, exp(a_cs) dy) is split into bf16 hi + lo
// and takes two products, about 16 significant bits.
//
// fp32 keeps the first design, seven kernels of scalar fp32 FMAs (mma.sync
// on fp32 operands is TF32, which cannot meet the fp32 check of 2e-5):
//   bwd_cb_kernel      C B^T per lower-triangular 64 x 64 tile, once per (row, chunk)
//   bwd_dstate_kernel  U_c per (row, chunk, head)
//   bwd_grec_kernel    the reverse recurrence (shared with bf16)
//   bwd_s_kernel       per (s tile, chunk, head, row): d dtx, dx, <x, d dtx>, the
//                      head's partial dB, colsum E and r for its 64 positions
//   bwd_l_kernel       per (l tile, chunk, head, row): the head's partial dC and
//                      rowsum E + <dy, Y_off> for its 64 positions
//   bwd_combine_kernel per (row, chunk, head): d a_cs, the fp64 reverse cumsum
//                      (d a written over the row part it has read), ddt and
//                      the partial dA (fp64)
//   bwd_reduce_kernel  dB and dC summed over the heads, dA over rows and chunks
// A 16 x 16 thread grid computes each product, a thread a 4 x k register
// tile from shared memory.
#include "common.cuh"
#include "hopper.cuh"

using namespace hydra;

namespace {

constexpr int kT = 64;           // l rows and s columns of one tile
constexpr int kTP = kT + 1;      // pitch of a 64 x 64 fp32 tile in shared memory
constexpr int kThreads = 256;    // a 16 x 16 grid: thread (ty, tx) owns rows
                                 // ty + 16 a and columns tx + 16 b of a product
constexpr int kCombThreads = 128;

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const void* dy;
  const float* dfinal;   // null: the final state's cotangent is 0
  const float* acs;      // (B, nc, H, chunk) saved a_cs
  const float* st;       // (B, nc, H, P, N) saved states entering each chunk
  float* cb;             // fp32: (B, nc, ntri, 64, 64) C B^T tiles
  float* g;              // (B, nc, H, P, N) U_c, then G_{c+1}
  float* dbp;            // (B, nparts, S, nw) partial dB: per head (fp32), per
  float* dcp;            //   cluster of heads (bf16); partial dC the same
  float* pos;            // fp32: (4, B, nc, H, chunk) rowpart, colpart, r, <x, d dtx>;
                         // bf16: (B, nc, H, 6, nlt 64) a_cs, dt and those four
                         // for a chunk too long for shared memory, else null
  float* pend;           // bf16: (B, nc, H, nlt - 1, 64 NB) parked dC tiles, or null
  double* dap;           // (B, nc, H) partial dA
  void* dx;              // (B, S, H, P) contiguous, x's dtype
  float* ddt;            // (B, S, H) contiguous
  float* dA;             // (H,)
  void* dB;              // (B, S, N) contiguous, x's dtype
  void* dC;
  float* dinit;          // null: not wanted (and no init state was given)
  int Bsz, S, H, P, N, chunk, nc, nlt, ntri;
  int nparts, nw;        // partial dB / dC: parts summed, row width (floats)
  int hc;                // bf16: heads per cluster
  int x_vec, bc_vec, dy_vec;   // bf16: rows may be copied as 16-byte pieces
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss;
  long long dy_sb, dy_ss, dy_sh;
};

enum Pos { kRow = 0, kCol = 1, kR = 2, kDdtx = 3 };

__device__ __forceinline__ long long row_of(const BwdArgs& a, int b, int c, int h) {
  return (static_cast<long long>(b) * a.nc + c) * a.H + h;
}

__device__ __forceinline__ float* pos_of(const BwdArgs& a, int k, long long row) {
  return a.pos + (static_cast<long long>(k) * a.Bsz * a.nc * a.H + row) * a.chunk;
}

__device__ __forceinline__ int chunk_len(const BwdArgs& a, int c) {
  const long long c0 = static_cast<long long>(c) * a.chunk;
  return static_cast<int>(min(static_cast<long long>(a.chunk), a.S - c0));
}

// acc[i][j] += sum_k A(ty + 16 i, k) B(k, tx + 16 j) over k < K, with both
// operands in shared memory at A[row * ai + k * ak] and B[k * bk + col * bj].
// A warp's 32 threads read two A addresses (broadcast) and 16 consecutive
// B columns; B's pitch is odd where its columns are strided.
template <int RI, int RJ>
__device__ __forceinline__ void smem_product(float (&acc)[RI][RJ], const float* A, int ai,
                                             int ak, const float* B, int bk, int bj, int K) {
  const int i0 = threadIdx.x >> 4, j0 = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RI], bv[RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) av[i] = A[(i0 + 16 * i) * ai + k * ak];
#pragma unroll
    for (int j = 0; j < RJ; ++j) bv[j] = B[k * bk + (j0 + 16 * j) * bj];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < RJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// Rows [0, 64) of a chunk tile into shared memory as fp32 (row pitch
// `pitch`): row r is src + r * ld, times scale[r * sstride] when `scale` is
// given. Its first `ncols` columns are copied; columns up to `width` and
// rows >= nrows are zero.
__device__ void load_tile(float* dst, int pitch, const float* src, long long ld, int nrows,
                          int ncols, int width, const float* scale, long long sstride) {
  for (int e = threadIdx.x; e < kT * width; e += kThreads) {
    const int r = e / width, c = e - r * width;
    float v = 0.f;
    if (r < nrows && c < ncols) {
      v = src[r * ld + c];
      if (scale) v = __fmul_rn(scale[r * sstride], v);
    }
    dst[r * pitch + c] = v;
  }
}

// A (P, N) fp32 state into shared memory, rows padded to PP and columns to
// NB with zeros (row pitch NB + 1).
template <int PP, int NB>
__device__ void load_state(float* dst, const float* src, int P, int N) {
  for (int e = threadIdx.x; e < PP * NB; e += kThreads) {
    const int p = e / NB, n = e - p * NB;
    dst[p * (NB + 1) + n] = (p < P && n < N) ? src[p * N + n] : 0.f;
  }
}

// Sum over the 16 threads of a row of the thread grid (lanes differing in
// their low four bits), in a fixed order; every lane gets the sum.
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// ---------------------------------------------------------------------------
template <int NB>
__global__ void __launch_bounds__(kThreads) bwd_cb_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  int st = tile, lt = 0;
  while (st > lt) {
    st -= lt + 1;
    ++lt;
  }
  const long long c0 = static_cast<long long>(c) * a.chunk;
  const int Lc = chunk_len(a, c), l0 = lt * kT, s0 = st * kT;
  if (l0 >= Lc) return;
  constexpr int np = NB + 1;
  float* Cs = smem;
  float* Bs = Cs + kT * np;
  load_tile(Cs, np, static_cast<const float*>(a.Cm) + b * a.c_sb + (c0 + l0) * a.c_ss, a.c_ss,
            Lc - l0, a.N, NB, nullptr, 0);
  load_tile(Bs, np, static_cast<const float*>(a.Bm) + b * a.b_sb + (c0 + s0) * a.b_ss, a.b_ss,
            Lc - s0, a.N, NB, nullptr, 0);
  __syncthreads();
  float acc[4][4] = {};
  smem_product(acc, Cs, np, 1, Bs, 1, np, NB);
  float* out = a.cb + ((static_cast<long long>(b) * a.nc + c) * a.ntri + tile) * kT * kT;
  const int i0 = threadIdx.x >> 4, j0 = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(i0 + 16 * i) * kT + j0 + 16 * j] = acc[i][j];
  }
}

// U_c[p][n] = sum_l exp(a_cs[l]) dy[l][p] C[l][n], written to a.g.
template <int PP, int NB>
__global__ void __launch_bounds__(kThreads) bwd_dstate_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  constexpr int pp = PP + 1, np = NB + 1;
  const int c = blockIdx.x / a.H, h = blockIdx.x - c * a.H, b = blockIdx.y;
  const long long c0 = static_cast<long long>(c) * a.chunk;
  const int Lc = chunk_len(a, c);
  const long long row = row_of(a, b, c, h);
  float* Dy = smem;              // (64, pp)  exp(a_cs[l]) dy of an l tile
  float* Cs = Dy + kT * pp;      // (64, np)  C of the l tile
  float* ea = Cs + kT * np;      // (chunk)   exp(a_cs)
  for (int l = threadIdx.x; l < Lc; l += kThreads) ea[l] = expf(a.acs[row * a.chunk + l]);
  const float* dy = static_cast<const float*>(a.dy) + b * a.dy_sb + h * a.dy_sh + c0 * a.dy_ss;
  const float* Cm = static_cast<const float*>(a.Cm) + b * a.c_sb + c0 * a.c_ss;
  float acc[PP / 16][NB / 16] = {};
  for (int l0 = 0; l0 < Lc; l0 += kT) {
    __syncthreads();  // ea is written; the last tiles are consumed
    load_tile(Dy, pp, dy + l0 * a.dy_ss, a.dy_ss, Lc - l0, a.P, PP, ea + l0, 1);
    load_tile(Cs, np, Cm + l0 * a.c_ss, a.c_ss, Lc - l0, a.N, NB,
              nullptr, 0);
    __syncthreads();
    smem_product(acc, Dy, 1, pp, Cs, np, 1, kT);
  }
  float* out = a.g + row * a.P * a.N;
  const int i0 = threadIdx.x >> 4, j0 = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < PP / 16; ++i) {
#pragma unroll
    for (int j = 0; j < NB / 16; ++j) {
      const int p = i0 + 16 * i, n = j0 + 16 * j;
      if (p < a.P && n < a.N) out[p * a.N + n] = acc[i][j];
    }
  }
}

// One thread per state element (p, n) of one (row, head) walks the chunks
// backwards: g[c] <- cur (= G_{c+1}), cur <- cur exp(a_cs_c[-1]) + U_c.
// U_0 is read only for d init_state (the bf16 route computes it only then).
__global__ void __launch_bounds__(kThreads) bwd_grec_kernel(BwdArgs a) {
  const int PN = a.P * a.N;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * a.H + h;
  float cur = a.dfinal ? a.dfinal[bh * PN + e] : 0.f;
  for (int c = a.nc - 1; c >= 0; --c) {
    const long long row = row_of(a, b, c, h);
    float* gp = a.g + row * PN + e;
    if (c == 0 && !a.dinit) {
      *gp = cur;
      return;
    }
    const float d = expf(a.acs[row * a.chunk + chunk_len(a, c) - 1]);
    const float u = *gp;
    *gp = cur;
    cur = fmaf(cur, d, u);
  }
  a.dinit[bh * PN + e] = cur;
}

// The gradients indexed by s for the 64 positions of s tile blockIdx.x.
template <int PP, int NB>
__global__ void __launch_bounds__(kThreads) bwd_s_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  constexpr int pp = PP + 1, np = NB + 1, RP = PP / 16, RN = NB / 16;
  const int st = blockIdx.x, c = blockIdx.y / a.H, h = blockIdx.y - c * a.H, b = blockIdx.z;
  const long long c0 = static_cast<long long>(c) * a.chunk;
  const int Lc = chunk_len(a, c), s0 = st * kT;
  if (s0 >= Lc) return;
  const long long row = row_of(a, b, c, h);
  const int tid = threadIdx.x, i0 = tid >> 4, j0 = tid & 15;
  float* Xs = smem;                // (64, pp)  dt x of the s tile
  float* acs = Xs + kT * pp;       // (chunk)
  float* dts = acs + a.chunk;      // (64)      dt of the s tile
  float* colE = dts + kT;          // (64)
  float* rr = colE + kT;           // (64)
  float* U = rr + kT;              // the union: G and B, or the l tiles'
  float* G = U;                    // (PP, np)  G_{c+1}
  float* Bs = G + PP * np;         // (64, np)  B of the s tile
  float* Cl = U;                   // (64, np)  C of an l tile
  float* Dy = Cl + kT * np;        // (64, pp)  dy of the l tile
  float* Wt = Dy + kT * pp;        // (64, kTP) (C B^T) o L, then dCB = L o dW;
                                   //           rows l, columns s
  float* Red = Wt + kT * kTP;      // (16, 64)  column partials of E

  const float* dt = a.dt + b * a.dt_sb + h * a.dt_sh + c0 * a.dt_ss;
  for (int l = tid; l < Lc; l += kThreads) acs[l] = a.acs[row * a.chunk + l];
  if (tid < kT) {
    dts[tid] = s0 + tid < Lc ? dt[(s0 + tid) * a.dt_ss] : 0.f;
    colE[tid] = 0.f;
  }
  load_state<PP, NB>(G, a.g + row * a.P * a.N, a.P, a.N);
  load_tile(Bs, np, static_cast<const float*>(a.Bm) + b * a.b_sb + (c0 + s0) * a.b_ss, a.b_ss,
            Lc - s0, a.N, NB, nullptr, 0);
  __syncthreads();    // dts is written
  load_tile(Xs, pp, static_cast<const float*>(a.x) + b * a.x_sb + h * a.x_sh + (c0 + s0) * a.x_ss,
            a.x_ss, Lc - s0, a.P, PP, dts, 1);
  __syncthreads();

  // the chunk-state terms: d dtx = ds G B[s], dB_h = ds dtx[s]^T G, r
  float ds[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + i0 + 16 * i;
    ds[i] = s < Lc ? expf(acs[Lc - 1] - acs[s]) : 0.f;
  }
  float dd[4][RP] = {}, dbh[4][RN] = {};
  smem_product(dd, Bs, np, 1, G, 1, np, NB);
  smem_product(dbh, Xs, pp, 1, G, np, 1, PP);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float r = 0.f;
#pragma unroll
    for (int j = 0; j < RP; ++j) {
      dd[i][j] *= ds[i];
      r = fmaf(Xs[(i0 + 16 * i) * pp + j0 + 16 * j], dd[i][j], r);
    }
#pragma unroll
    for (int j = 0; j < RN; ++j) dbh[i][j] *= ds[i];
    r = row_sum16(r);
    if (j0 == 0) rr[i0 + 16 * i] = r;
  }

  // the l tiles on or below the diagonal
  for (int lt = st; lt * kT < Lc; ++lt) {
    const int l0 = lt * kT;
    __syncthreads();  // G, or the last l tile, is consumed
    load_tile(Cl, np, static_cast<const float*>(a.Cm) + b * a.c_sb + (c0 + l0) * a.c_ss, a.c_ss,
              Lc - l0, a.N, NB, nullptr, 0);
    load_tile(Dy, pp,
              static_cast<const float*>(a.dy) + b * a.dy_sb + h * a.dy_sh + (c0 + l0) * a.dy_ss,
              a.dy_ss, Lc - l0, a.P, PP, nullptr, 0);
    __syncthreads();
    float t[4][4] = {};   // dW[l][s] = <dy[l], dtx[s]>, then dCB
    smem_product(t, Dy, pp, 1, Xs, 1, pp, PP);
    const float* cbt =
        a.cb + ((static_cast<long long>(b) * a.nc + c) * a.ntri + lt * (lt + 1) / 2 + st) * kT * kT;
    float colp[4] = {};   // this thread's 4 rows of E = (C B^T) o dCB, per column
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = i0 + 16 * i, s = j0 + 16 * j;
        const bool on = s0 + s <= l0 + l && l0 + l < Lc;
        const float Lm = on ? expf(acs[l0 + l] - acs[s0 + s]) : 0.f;
        const float cbv = on ? cbt[l * kT + s] : 0.f;
        t[i][j] *= Lm;
        Wt[l * kTP + s] = cbv * Lm;
        colp[j] = fmaf(cbv, t[i][j], colp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) Red[i0 * kT + j0 + 16 * j] = colp[j];
    __syncthreads();
    if (tid < kT) {
      float v = colE[tid];
      for (int r = 0; r < 16; ++r) v += Red[r * kT + tid];
      colE[tid] = v;
    }
    smem_product(dd, Wt, 1, kTP, Dy, pp, 1, kT);     // d dtx[s] += sum_l M[l][s] dy[l]
    __syncthreads();      // M is consumed
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) Wt[(i0 + 16 * i) * kTP + j0 + 16 * j] = t[i][j];
    }
    __syncthreads();
    smem_product(dbh, Wt, 1, kTP, Cl, np, 1, kT);    // dB_h[s] += sum_l dCB[l][s] C[l]
  }
  __syncthreads();    // colE is complete

  const float* x = static_cast<const float*>(a.x) + b * a.x_sb + h * a.x_sh + c0 * a.x_ss;
  float* dx = static_cast<float*>(a.dx) + ((static_cast<long long>(b) * a.S + c0) * a.H + h) * a.P;
  float* dbp = a.dbp + ((static_cast<long long>(b) * a.H + h) * a.S + c0) * a.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + i0 + 16 * i;
    const bool in = s < Lc;
    float xd = 0.f;
#pragma unroll
    for (int j = 0; j < RP; ++j) {
      const int p = j0 + 16 * j;
      if (in && p < a.P) {
        xd = fmaf(to_f(x[s * a.x_ss + p]), dd[i][j], xd);
        dx[static_cast<long long>(s) * a.H * a.P + p] = dts[s - s0] * dd[i][j];
      }
    }
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = j0 + 16 * j;
      if (in && n < a.N) dbp[static_cast<long long>(s) * a.N + n] = dbh[i][j];
    }
    xd = row_sum16(xd);
    if (in && j0 == 0) {
      const float r = rr[s - s0];
      pos_of(a, kCol, row)[s] = -(colE[s - s0] + r);
      pos_of(a, kR, row)[s] = r;
      pos_of(a, kDdtx, row)[s] = xd;
    }
  }
}

// The gradients indexed by l for the 64 positions of l tile blockIdx.x.
template <int PP, int NB>
__global__ void __launch_bounds__(kThreads) bwd_l_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  constexpr int pp = PP + 1, np = NB + 1, RN = NB / 16;
  const int lt = blockIdx.x, c = blockIdx.y / a.H, h = blockIdx.y - c * a.H, b = blockIdx.z;
  const long long c0 = static_cast<long long>(c) * a.chunk;
  const int Lc = chunk_len(a, c), l0 = lt * kT;
  if (l0 >= Lc) return;
  const long long row = row_of(a, b, c, h);
  const int tid = threadIdx.x, i0 = tid >> 4, j0 = tid & 15;
  float* Dy = smem;                // (64, pp)  dy of the l tile
  float* acs = Dy + kT * pp;       // (chunk)
  float* U = acs + a.chunk;        // the union: prev and C, or the s tile's
  float* Pv = U;                   // (PP, np)  the state entering the chunk
  float* Cl = Pv + PP * np;        // (64, np)  C of the l tile
  float* Bs = U;                   // (64, np)  B of an s tile
  float* Xs = Bs + kT * np;        // (64, pp)  dt x of the s tile
  float* Dt = Xs + kT * pp;        // (64, kTP) dCB, rows l, columns s

  for (int l = tid; l < Lc; l += kThreads) acs[l] = a.acs[row * a.chunk + l];
  load_state<PP, NB>(Pv, a.st + row * a.P * a.N, a.P, a.N);
  load_tile(Cl, np, static_cast<const float*>(a.Cm) + b * a.c_sb + (c0 + l0) * a.c_ss, a.c_ss,
            Lc - l0, a.N, NB, nullptr, 0);
  load_tile(Dy, pp,
            static_cast<const float*>(a.dy) + b * a.dy_sb + h * a.dy_sh + (c0 + l0) * a.dy_ss,
            a.dy_ss, Lc - l0, a.P, PP, nullptr, 0);
  __syncthreads();

  // the state term: dC_h[l] = exp(a_cs[l]) dy[l]^T prev, and <dy, Y_off>
  float dch[4][RN] = {};
  smem_product(dch, Dy, pp, 1, Pv, np, 1, PP);
  float part[4];   // this thread's share of rowsum E + <dy, Y_off>
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + i0 + 16 * i;
    const float ea = l < Lc ? expf(acs[l]) : 0.f;
    float yo = 0.f;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      dch[i][j] *= ea;
      yo = fmaf(Cl[(i0 + 16 * i) * np + j0 + 16 * j], dch[i][j], yo);
    }
    part[i] = yo;
  }

  const float* dt = a.dt + b * a.dt_sb + h * a.dt_sh + c0 * a.dt_ss;
  for (int st = 0; st <= lt; ++st) {
    const int s0 = st * kT;
    __syncthreads();  // prev, or the last s tile, is consumed
    load_tile(Bs, np, static_cast<const float*>(a.Bm) + b * a.b_sb + (c0 + s0) * a.b_ss, a.b_ss,
              Lc - s0, a.N, NB, nullptr, 0);
    load_tile(Xs, pp,
              static_cast<const float*>(a.x) + b * a.x_sb + h * a.x_sh + (c0 + s0) * a.x_ss,
              a.x_ss, Lc - s0, a.P, PP, dt + s0 * a.dt_ss, a.dt_ss);
    __syncthreads();
    float t[4][4] = {};
    smem_product(t, Dy, pp, 1, Xs, 1, pp, PP);
    const float* cbt =
        a.cb + ((static_cast<long long>(b) * a.nc + c) * a.ntri + lt * (lt + 1) / 2 + st) * kT * kT;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = i0 + 16 * i, s = j0 + 16 * j;
        const bool on = s0 + s <= l0 + l && l0 + l < Lc;
        const float Lm = on ? expf(acs[l0 + l] - acs[s0 + s]) : 0.f;
        const float cbv = on ? cbt[l * kT + s] : 0.f;
        const float dcb = Lm * t[i][j];
        Dt[l * kTP + s] = dcb;
        part[i] = fmaf(cbv, dcb, part[i]);
      }
    }
    __syncthreads();
    smem_product(dch, Dt, kTP, 1, Bs, np, 1, kT);    // dC_h[l] += sum_s dCB[l][s] B[s]
  }

  float* dcp = a.dcp + ((static_cast<long long>(b) * a.H + h) * a.S + c0) * a.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + i0 + 16 * i;
    const bool in = l < Lc;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = j0 + 16 * j;
      if (in && n < a.N) dcp[static_cast<long long>(l) * a.N + n] = dch[i][j];
    }
    const float v = row_sum16(part[i]);
    if (in && j0 == 0) pos_of(a, kRow, row)[l] = v;
  }
}

// Block sum of v over NT threads in a fixed order; every thread gets it.
// `red` holds NT / 32 doubles.
template <int NT>
__device__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  __syncthreads();    // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  return s;
}

// d a_cs, d a (an fp64 reverse cumsum rounded once per element), ddt and
// the partial dA of one (row, chunk, head).
__global__ void __launch_bounds__(kCombThreads) bwd_combine_kernel(BwdArgs a) {
  extern __shared__ double dsm[];
  __shared__ double red[kCombThreads / 32];
  const int c = blockIdx.x / a.H, h = blockIdx.x - c * a.H, b = blockIdx.y;
  const long long c0 = static_cast<long long>(c) * a.chunk;
  const int Lc = chunk_len(a, c);
  const long long row = row_of(a, b, c, h);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double* dacs = dsm;                       // (chunk), reversed
  float* da = pos_of(a, kRow, row);          // (chunk) d a, over the row part once
  const float* rowp = da;                    // it is read into dacs
  const float* colp = pos_of(a, kCol, row);
  const float* rp = pos_of(a, kR, row);
  const float* ddtx = pos_of(a, kDdtx, row);

  // the last row's extra terms: sum_s r[s] + exp(a_cs[-1]) <G_{c+1}, prev>
  double sr = 0.0, sg = 0.0;
  for (int l = tid; l < Lc; l += kCombThreads) sr += rp[l];
  const int PN = a.P * a.N;
  const float* g = a.g + row * PN;
  const float* pv = a.st + row * PN;
  for (int e = tid; e < PN; e += kCombThreads) {
    sg += static_cast<double>(g[e]) * static_cast<double>(pv[e]);
  }
  sr = block_sum<kCombThreads>(sr, red);
  sg = block_sum<kCombThreads>(sg, red);
  const float alast = a.acs[row * a.chunk + Lc - 1];
  const double last = sr + static_cast<double>(expf(alast)) * sg;
  // dacs in reversed order: dacs[j] = d a_cs[Lc - 1 - j]
  for (int j = tid; j < Lc; j += kCombThreads) {
    const int l = Lc - 1 - j;
    double v = static_cast<double>(rowp[l] + colp[l]);
    if (j == 0) v += last;
    dacs[j] = v;
  }
  __syncthreads();
  // an inclusive fp64 scan of the reversed dacs: each thread a contiguous
  // run, the runs scanned across the warp with shuffles and across the warps
  // in shared memory
  const int per = (Lc + kCombThreads - 1) / kCombThreads;
  const int beg = min(Lc, tid * per), end = min(Lc, beg + per);
  double run = 0.0;
  for (int j = beg; j < end; ++j) run += dacs[j];
  double inc = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(kFullMask, inc, o);
    if (lane >= o) inc += v;
  }
  double off = __shfl_up_sync(kFullMask, inc, 1);
  if (lane == 0) off = 0.0;
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  for (int w = 0; w < warp; ++w) off += red[w];
  for (int j = beg; j < end; ++j) {
    off += dacs[j];
    da[Lc - 1 - j] = static_cast<float>(off);
  }
  __syncthreads();
  const float A = a.A[h];
  const float* dt = a.dt + b * a.dt_sb + h * a.dt_sh + c0 * a.dt_ss;
  float* ddt = a.ddt + (static_cast<long long>(b) * a.S + c0) * a.H + h;
  double pa = 0.0;
  for (int l = tid; l < Lc; l += kCombThreads) {
    const float d = da[l];
    ddt[static_cast<long long>(l) * a.H] = __fadd_rn(__fmul_rn(A, d), ddtx[l]);
    pa += static_cast<double>(dt[l * a.dt_ss]) * static_cast<double>(d);
  }
  pa = block_sum<kCombThreads>(pa, red);
  if (tid == 0) a.dap[row] = pa;
}

// dB, dC: the partials (per head, or per cluster of heads) summed in order;
// the blocks past the B S N elements sum dA's partials over (row, chunk) in
// order.
template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_reduce_kernel(BwdArgs a, int nblk) {
  if (static_cast<int>(blockIdx.x) >= nblk) {
    const int h = (blockIdx.x - nblk) * kThreads + threadIdx.x;
    if (h >= a.H) return;
    double s = 0.0;
    for (int bc = 0; bc < a.Bsz * a.nc; ++bc) s += a.dap[static_cast<long long>(bc) * a.H + h];
    a.dA[h] = static_cast<float>(s);
    return;
  }
  const long long SN = static_cast<long long>(a.S) * a.N, SW = static_cast<long long>(a.S) * a.nw;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= a.Bsz * SN) return;
  const long long b = e / SN, rem = e - b * SN, s = rem / a.N, n = rem - s * a.N;
  const float* pb = a.dbp + b * a.nparts * SW + s * a.nw + n;
  const float* pc = a.dcp + b * a.nparts * SW + s * a.nw + n;
  float sb = 0.f, sc = 0.f;
  for (int q = 0; q < a.nparts; ++q) {
    sb += pb[q * SW];
    sc += pc[q * SW];
  }
  static_cast<T*>(a.dB)[e] = from_f<T>(sb);
  static_cast<T*>(a.dC)[e] = from_f<T>(sc);
}

// ===========================================================================
// bf16: the tensor-core route
// ===========================================================================
using bf16 = __nv_bfloat16;

constexpr int kTc = 256;          // threads of a tensor-core CTA: 8 warps; warp w owns
                                  // rows 16 (w & 3) of a 64-row tile and column half
                                  // w >> 2 of each product
constexpr int kHp = kT + 8;       // pitch (bf16) of the 64 x 64 hi / lo tiles
constexpr int kMaxCluster = 8;    // the portable cluster size
template <int V> struct IntC { static constexpr int value = V; };

template <int PP, int NB>
struct Tc {
  static constexpr int xp = PP + 8;        // bf16 pitches that keep the ldmatrix
  static constexpr int np = NB + 8;        // rows off each other's banks
  static constexpr int sp = NB + 8;        // fp32 pitch of the staging tile
  static constexpr int U = (PP + NB) / 16; // 16-column units of the s side, [P | N]
  static constexpr int UH = (U + 1) / 2;   // units of column half 0 (half 1: the rest)
  static constexpr int PU = PP / 16;       // units 0 .. PU - 1 are P's
  static constexpr int DC = NB / 16;       // n8 tiles of a warp's dC columns (NB / 2)
  // the s-side units of column half H: [UB, UE)
  template <int H> static constexpr int UB = H ? UH : 0;
  template <int H> static constexpr int UE = H ? U : UH;
  static_assert(4 * kT * kHp * 2 >= kT * sp * 4, "the staging tile fits in the hi/lo tiles");
  static_assert(2 * kT * (xp + np) * 2 >= kT * sp * 4, "and in the tile operands");
};

// Rows [0, 64) of a bf16 tile into shared memory (row pitch `pitch`): row r
// is src + r * ld. Its first `ncols` columns are copied, columns up to `w`
// (a multiple of 8) and rows >= nrows are zero. With `vec` the copies are
// 16-byte cp.async (src and ld 16-byte aligned, ncols a multiple of 8) and
// the caller commits and waits.
__device__ __forceinline__ void tile_to_smem(bf16* dst, int pitch, const bf16* src,
                                             long long ld, int nrows, int ncols, int w,
                                             bool vec) {
  if (vec) {
    const int per = w >> 3;
    for (int e = threadIdx.x; e < kT * per; e += blockDim.x) {
      const int r = e / per, c = (e - r * per) << 3;
      bf16* d = dst + r * pitch + c;
      if (r < nrows && c < ncols) {
        cp_async16(d, src + r * ld + c);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      }
    }
  } else {
    for (int e = threadIdx.x; e < kT * w; e += blockDim.x) {
      const int r = e / w, c = e - r * w;
      dst[r * pitch + c] = (r < nrows && c < ncols) ? src[r * ld + c] : __float2bfloat16(0.f);
    }
  }
}

// ldmatrix row addresses of this lane for the four fragment kinds, from a
// row-major bf16 tile T with row pitch `pitch`:
//   a_rows: A(m, k) = T[m][k] (ldsm_x4)      a_cols: A(m, k) = T[k][m] (ldsm_x4_t)
//   b_rows: B(k, n) = T[n][k] (ldsm_x4)      b_cols: B(k, n) = T[k][n] (ldsm_x4_t)
// A is one 16 x 16 fragment at (m0, k0); B two n8 tiles at (k0, n0): registers
// 0-1 for columns n0 .. n0 + 7, 2-3 for n0 + 8 .. n0 + 15.
__device__ __forceinline__ uint32_t a_rows(const bf16* T, int pitch, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  return smem_addr(T + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + k0 + (lane >> 4) * 8);
}
__device__ __forceinline__ uint32_t a_cols(const bf16* T, int pitch, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  return smem_addr(T + (k0 + (lane & 7) + (lane >> 4) * 8) * pitch + m0 + ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ uint32_t b_rows(const bf16* T, int pitch, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  return smem_addr(T + (n0 + (lane & 7) + (lane >> 4) * 8) * pitch + k0 + ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ uint32_t b_cols(const bf16* T, int pitch, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  return smem_addr(T + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + n0 + (lane >> 4) * 8);
}

// One B fragment (k0 .. k0 + 15, one n8 tile at n0) of an fp32 matrix in
// device memory, element (k, n) at m[k * ks + n * ns] and zero where k >=
// kmax or n >= nmax, split into bf16 hi + lo. For the products with G and
// the state entering a chunk, which run only across chunk boundaries.
__device__ __forceinline__ void bfrag_split(const float* m, int ks, int ns, int k0, int n0,
                                            int kmax, int nmax, uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
  const int lane = threadIdx.x & 31, n = n0 + (lane >> 2), k = k0 + 2 * (lane & 3);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k + (i & 1) + (i >> 1) * 8;
    v[i] = (kk < kmax && n < nmax) ? m[kk * ks + n * ns] : 0.f;
  }
  split_bf16x2(v[0], v[1], hi[0], lo[0]);
  split_bf16x2(v[2], v[3], hi[1], lo[1]);
}

__device__ __forceinline__ void mma2(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t b0, uint32_t b1) {
  mma_bf16_16816(d, ah, b0, b1);
  mma_bf16_16816(d, al, b0, b1);
}

// Sum over the four lanes of a quad (lanes differing in their low two bits).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFullMask, v, 1);
  return v + __shfl_xor_sync(kFullMask, v, 2);
}

// The whole backward of one (row, chunk, head) but the recurrence and the
// sums across CTAs; grid (H, chunks, B) in clusters of a.hc heads.
template <int PP, int NB, bool kLong>
__global__ void __launch_bounds__(kTc, 2) bwd_mma_kernel(BwdArgs a) {
  using K = Tc<PP, NB>;
  extern __shared__ __align__(16) unsigned char mma_smem_buf[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const long long c0 = static_cast<long long>(c) * a.chunk;
  const int Lc = chunk_len(a, c), nlt = (Lc + kT - 1) / kT, L = a.nlt * kT;
  const long long row = row_of(a, b, c, h);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp & 3, ch = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * rg;                       // this warp's first row of a tile
  bf16* Xs = reinterpret_cast<bf16*>(mma_smem_buf);   // (64, xp) x of the s tile
  bf16* Dy = Xs + kT * K::xp;                         // (64, xp) dy of the l tile
  bf16* Bs = Dy + kT * K::xp;                         // (64, np) B of the s tile
  bf16* Cl = Bs + kT * K::np;                         // (64, np) C of the l tile
  bf16* Wdh = Cl + kT * K::np;  // (64, kHp) dCB = L o dW, hi and lo; rows l, columns s
  bf16* Wdl = Wdh + kT * kHp;
  bf16* Wmh = Wdl + kT * kHp;   // (64, kHp) M = (C B^T) o L, hi and lo
  bf16* Wml = Wmh + kT * kHp;
  float* stg = reinterpret_cast<float*>(Wdh);  // (64, sp) a finished dB or dC tile
                                               // for the cluster's sum: W's union
  float* stg2 = reinterpret_cast<float*>(Xs);  // (64, sp) the last dB tile, over the
                                               // last s and l tiles' operands
  // six per-position arrays here or, for a chunk too long for them
  // (kLong), in the row's slice of a.pos
  float* const tail = reinterpret_cast<float*>(Wml + kT * kHp);
  float* acs = kLong ? a.pos + row * 6 * L : tail;  // (L) a_cs
  float* dts = acs + L;           // (L) dt
  float* rowp = dts + L;          // (L) <C[l], dC_h[l]> = rowsum E + <dy, Y_off>
  float* colp = rowp + L;         // (L) <B[s], dB_h[s]> = colsum E + r
  float* rr = colp + L;           // (L) r
  float* ddx = rr + L;            // (L) <x, d dtx>
  float* red_y = kLong ? tail : ddx + L;   // (2, 64) <C, dC_h>, per column half
  float* red_x = red_y + 2 * kT;  // (2, 64) r, then <x, d dtx>, per column half
  float* red_b = red_x + 2 * kT;  // (2, 64) <B, dB_h>, per column half
  double* red64 = reinterpret_cast<double*>(red_b + 2 * kT);   // (3, kTc / 32)

  const bf16* xh = static_cast<const bf16*>(a.x) + b * a.x_sb + h * a.x_sh + c0 * a.x_ss;
  const bf16* dyh = static_cast<const bf16*>(a.dy) + b * a.dy_sb + h * a.dy_sh + c0 * a.dy_ss;
  const bf16* Bc = static_cast<const bf16*>(a.Bm) + b * a.b_sb + c0 * a.b_ss;
  const bf16* Cc = static_cast<const bf16*>(a.Cm) + b * a.c_sb + c0 * a.c_ss;
  // Tile loads are issued as soon as their buffers are free and waited for
  // (land) just before their first use: the first s and l tiles while a_cs
  // is read, the next ones during the cluster's sums.
  int loaded_l = -1;        // the l tile in (or on its way to) Dy and Cl
  bool inflight = false;
  auto load_s = [&](int st) {
    const int s0 = st * kT;
    tile_to_smem(Xs, K::xp, xh + s0 * a.x_ss, a.x_ss, Lc - s0, a.P, PP, a.x_vec);
    tile_to_smem(Bs, K::np, Bc + s0 * a.b_ss, a.b_ss, Lc - s0, a.N, NB, a.bc_vec);
    inflight = true;
  };
  auto load_l = [&](int lt) {
    const int l0 = lt * kT;
    tile_to_smem(Dy, K::xp, dyh + l0 * a.dy_ss, a.dy_ss, Lc - l0, a.P, PP, a.dy_vec);
    tile_to_smem(Cl, K::np, Cc + l0 * a.c_ss, a.c_ss, Lc - l0, a.N, NB, a.bc_vec);
    loaded_l = lt;
    inflight = true;
  };
  auto land = [&]() {
    if (inflight) {
      cp_async_wait_all();
      __syncthreads();
      inflight = false;
    }
  };
  load_s(0);
  load_l(0);
  cp_async_commit();
  const float* dt = a.dt + b * a.dt_sb + h * a.dt_sh + c0 * a.dt_ss;
  for (int i = tid; i < L; i += kTc) {
    const bool in = i < Lc;
    acs[i] = in ? a.acs[row * a.chunk + i] : 0.f;
    dts[i] = in ? dt[i * a.dt_ss] : 0.f;
    rowp[i] = colp[i] = rr[i] = ddx[i] = 0.f;
  }
  // G (the cotangent of the state leaving the chunk) is zero in the last
  // chunk without a final-state cotangent, the state entering chunk 0 without
  // an init state: their products are skipped, not multiplied by zeros
  const bool has_g = c + 1 < a.nc || a.dfinal != nullptr;
  const bool has_prev = c > 0 || a.dinit != nullptr;
  const float* G = a.g + row * a.P * a.N;
  const float* prev = a.st + row * a.P * a.N;
  double gp = 0.0;   // <G, prev>
  if (has_g && has_prev) {
    for (int e = tid; e < a.P * a.N; e += kTc) {
      gp += static_cast<double>(G[e]) * static_cast<double>(prev[e]);
    }
    gp = block_sum<kTc>(gp, red64);
  }

  const int hc = a.hc, grp = h / hc, rank = h - grp * hc;   // rank order is head order
  const long long part = ((static_cast<long long>(b) * a.nparts + grp) * a.S + c0) * a.nw;
  float* pend = a.pend ? a.pend + row * (a.nlt - 1) * kT * NB : nullptr;

  // The cluster's sum of the staging tiles (rows [0, rows)) in rank order
  // into dst (row pitch a.nw): CTA `rank` sums its share of the float4s,
  // four ranks' loads in flight at a time. The first arrive releases the
  // staging writes (no global store is pending then: a release waits for
  // those); the closing one is relaxed, as it only says that this CTA's
  // reads have returned, and lets the others go on; staging_free() waits for
  // it before this CTA writes its staging tile (or the hi / lo tiles) again.
  bool arrived = false;
  auto staging_free = [&]() {
    if (arrived) {
      cluster_wait();
      arrived = false;
    }
  };
  // With dst2, a second staging tile (stg2) is summed into dst2 as well.
  auto cluster_sum = [&](float* dst, int rows, float* dst2) {
    cluster_arrive();
    cluster_wait();                 // every CTA's staging tile is written
    constexpr int C4 = NB / 4;
    const int tile = rows * C4, total = dst2 ? 2 * tile : tile;
    const int per = (total + hc - 1) / hc;
    const int lo = rank * per, hi = min(total, lo + per);
    for (int e = lo + tid; e < hi; e += kTc) {
      const bool second = e >= tile;
      const int et = second ? e - tile : e, r = et / C4, c4 = et - r * C4;
      if (4 * c4 >= a.nw) continue;
      const uint32_t base = smem_addr(second ? stg2 : stg);
      const uint32_t off = static_cast<uint32_t>((r * K::sp + 4 * c4) * 4);
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
      for (int q0 = 0; q0 < hc; q0 += 4) {
        float4 v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q0 + q < hc) v[q] = ld_cluster_f4(map_rank(base + off, q0 + q));
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q0 + q < hc) {
            s.x += v[q].x;
            s.y += v[q].y;
            s.z += v[q].z;
            s.w += v[q].w;
          }
        }
      }
      *reinterpret_cast<float4*>((second ? dst2 : dst) + static_cast<long long>(r) * a.nw +
                                 4 * c4) = s;
    }
    cluster_arrive_relaxed();
    arrived = true;
  };

  float acc[K::UH][2][4];   // s side: this warp's units of [d dtx | dB_h], rows s
  float dc[K::DC][4];       // l side: dC_h of l tile dc_lt, this warp's columns
  int dc_lt = -1;
  const int dcn0 = ch * (NB / 2);                          // its first dC column
  // Runs f with this warp's column half as a compile-time constant, so that
  // the loops over its s-side units unroll with their P / N split known.
  auto by_half = [&](auto f) {
    if (ch) {
      f(IntC<1>());
    } else {
      f(IntC<0>());
    }
  };

  for (int st = 0; st < nlt; ++st) {
    const int s0 = st * kT;
    land();                   // Xs and Bs of s tile st
#pragma unroll
    for (int ui = 0; ui < K::UH; ++ui) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[ui][j][q] = 0.f;
      }
    }

    if (has_g) {
      // the chunk-state terms: d dtx[s] = ds[s] sum_n B[s][n] G[p][n], dB_h[s] =
      // ds[s] dt[s] sum_p x[s][p] G[p][n], and r[s] = dt[s] <x[s], d dtx[s]>,
      // which is <B[s], dB_h[s]> of these terms alone
      by_half([&](auto half) {
        constexpr int UB = K::template UB<decltype(half)::value>;
        constexpr int UE = K::template UE<decltype(half)::value>;
#pragma unroll
        for (int ui = 0; ui < UE - UB; ++ui) {
          const int u = UB + ui;
          if (u < K::PU) {
#pragma unroll 1
            for (int k0 = 0; k0 < NB; k0 += 16) {
              uint32_t af[4];
              ldsm_x4(af, a_rows(Bs, K::np, r0, k0));
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                uint32_t hi[2], lo[2];
                bfrag_split(G, 1, a.N, k0, 16 * u + 8 * j, a.N, a.P, hi, lo);
                mma_bf16_16816(acc[ui][j], af, hi[0], hi[1]);
                mma_bf16_16816(acc[ui][j], af, lo[0], lo[1]);
              }
            }
          } else {
            const int n0 = 16 * (u - K::PU);
#pragma unroll 1
            for (int k0 = 0; k0 < PP; k0 += 16) {
              uint32_t af[4];
              ldsm_x4(af, a_rows(Xs, K::xp, r0, k0));
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                uint32_t hi[2], lo[2];
                bfrag_split(G, a.N, 1, k0, n0 + 8 * j, a.P, a.N, hi, lo);
                mma_bf16_16816(acc[ui][j], af, hi[0], hi[1]);
                mma_bf16_16816(acc[ui][j], af, lo[0], lo[1]);
              }
            }
          }
        }
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int ss = r0 + g + 8 * h2, s = s0 + ss;
          const float ds = s < Lc ? expf(acs[Lc - 1] - acs[s]) : 0.f;
          const float dsdt = __fmul_rn(ds, dts[s]);
          float rp = 0.f;
#pragma unroll
          for (int ui = 0; ui < UE - UB; ++ui) {
            const int u = UB + ui;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float& v = acc[ui][j][2 * h2 + e];
                if (u < K::PU) {
                  v = __fmul_rn(v, ds);
                } else {
                  v = __fmul_rn(v, dsdt);
                  const int n = 16 * (u - K::PU) + 8 * j + 2 * t + e;
                  rp = fmaf(__bfloat162float(Bs[ss * K::np + n]), v, rp);
                }
              }
            }
          }
          rp = quad_sum(rp);
          if (t == 0) red_x[ch * kT + ss] = rp;
        }
      });
      __syncthreads();
      if (tid < kT) rr[s0 + tid] = red_x[tid] + red_x[kT + tid];
    }

    for (int lt = st; lt < nlt; ++lt) {
      const int l0 = lt * kT;
      const bool diag = lt == st;
      if (loaded_l != lt) load_l(lt);
      land();
      // the l side's accumulator: l tile lt's, carried in registers while
      // consecutive pairs share it, else parked in `pend` (this thread's own
      // elements, so no barrier)
      if (dc_lt != lt) {
        if (dc_lt >= 0) {
          float* slot = pend + (dc_lt - 1) * kT * NB;
#pragma unroll
          for (int j = 0; j < K::DC; ++j) {
#pragma unroll
            for (int q = 0; q < 4; ++q) slot[(j * 4 + q) * kTc + tid] = dc[j][q];
          }
        }
        if (st > 0) {
          const float* slot = pend + (lt - 1) * kT * NB;
#pragma unroll
          for (int j = 0; j < K::DC; ++j) {
#pragma unroll
            for (int q = 0; q < 4; ++q) dc[j][q] = slot[(j * 4 + q) * kTc + tid];
          }
        } else {
#pragma unroll
          for (int j = 0; j < K::DC; ++j) {
#pragma unroll
            for (int q = 0; q < 4; ++q) dc[j][q] = 0.f;
          }
          if (has_prev) {
            // the entering state's term: dC_h[l] = exp(a_cs[l]) dy[l]^T prev
#pragma unroll 1
            for (int k0 = 0; k0 < PP; k0 += 16) {
              uint32_t af[4];
              ldsm_x4(af, a_rows(Dy, K::xp, r0, k0));
#pragma unroll
              for (int j = 0; j < K::DC; ++j) {
                uint32_t hi[2], lo[2];
                bfrag_split(prev, a.N, 1, k0, dcn0 + 8 * j, a.P, a.N, hi, lo);
                mma_bf16_16816(dc[j], af, hi[0], hi[1]);
                mma_bf16_16816(dc[j], af, lo[0], lo[1]);
              }
            }
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int l = l0 + r0 + g + 8 * h2;
              const float ea = l < Lc ? expf(acs[l]) : 0.f;
#pragma unroll
              for (int j = 0; j < K::DC; ++j) {
                dc[j][2 * h2] = __fmul_rn(dc[j][2 * h2], ea);
                dc[j][2 * h2 + 1] = __fmul_rn(dc[j][2 * h2 + 1], ea);
              }
            }
          }
        }
        dc_lt = lt;
      }

      // C B^T and dW = dt[s] <dy[l], x[s]> of this warp's rows and columns, in
      // two halves of 16 columns; then dCB and M per element. E = (C B^T) o dCB
      // is not formed: its row and column sums are read off the finished dC_h
      // and dB_h tiles, rowsum E[l] = <C[l], sum_s dCB[l][s] B[s]> and colsum
      // E[s] = <B[s], sum_l dCB[l][s] C[l]>
      staging_free();
#pragma unroll 1
      for (int hh = 0; hh < 2; ++hh) {
        const int sc0 = 32 * ch + 16 * hh;    // the half's first column in the tile
        float cbv[2][4] = {}, dwv[2][4] = {};
        if (!(diag && sc0 > r0 + 15)) {       // else above the diagonal: all masked
          for (int k0 = 0; k0 < NB; k0 += 16) {
            uint32_t af[4], bf[4];
            ldsm_x4(af, a_rows(Cl, K::np, r0, k0));
            ldsm_x4(bf, b_rows(Bs, K::np, sc0, k0));
            mma_bf16_16816(cbv[0], af, bf[0], bf[1]);
            mma_bf16_16816(cbv[1], af, bf[2], bf[3]);
          }
#pragma unroll
          for (int k0 = 0; k0 < PP; k0 += 16) {
            uint32_t af[4], bf[4];
            ldsm_x4(af, a_rows(Dy, K::xp, r0, k0));
            ldsm_x4(bf, b_rows(Xs, K::xp, sc0, k0));
            mma_bf16_16816(dwv[0], af, bf[0], bf[1]);
            mma_bf16_16816(dwv[1], af, bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int ll = r0 + g + 8 * h2, l = l0 + ll;
            const int sc = sc0 + 8 * j + 2 * t;
            float dcb[2], m[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int s = s0 + sc + e, q = 2 * h2 + e;
              // masked before exp: above the diagonal a_cs[l] - a_cs[s] > 0.
              // __expf: its error, about |arg| 2^-24 relative, is far below
              // the hi + lo split's 2^-16 where the weight matters
              const float Lv = (s <= l && l < Lc) ? __expf(acs[l] - acs[s]) : 0.f;
              dcb[e] = __fmul_rn(Lv, __fmul_rn(dwv[j][q], dts[s]));
              m[e] = __fmul_rn(cbv[j][q], Lv);
            }
            uint32_t hi, lo;
            split_bf16x2(dcb[0], dcb[1], hi, lo);
            *reinterpret_cast<uint32_t*>(Wdh + ll * kHp + sc) = hi;
            *reinterpret_cast<uint32_t*>(Wdl + ll * kHp + sc) = lo;
            split_bf16x2(m[0], m[1], hi, lo);
            *reinterpret_cast<uint32_t*>(Wmh + ll * kHp + sc) = hi;
            *reinterpret_cast<uint32_t*>(Wml + ll * kHp + sc) = lo;
          }
        }
      }
      __syncthreads();    // W is written

      // l side: dC_h[l] += sum_s dCB[l][s] B[s] (on the diagonal only s <= l)
      for (int k0 = 0; k0 <= (diag ? r0 : kT - 16); k0 += 16) {
        uint32_t ah[4], al[4];
        ldsm_x4(ah, a_rows(Wdh, kHp, r0, k0));
        ldsm_x4(al, a_rows(Wdl, kHp, r0, k0));
#pragma unroll
        for (int u = 0; u < K::DC / 2; ++u) {
          uint32_t bf[4];
          ldsm_x4_t(bf, b_cols(Bs, K::np, dcn0 + 16 * u, k0));
          mma2(dc[2 * u], ah, al, bf[0], bf[1]);
          mma2(dc[2 * u + 1], ah, al, bf[2], bf[3]);
        }
      }
      // s side: d dtx[s] += sum_l M[l][s] dy[l], dB_h[s] += sum_l dCB[l][s] C[l]
      // (on the diagonal only l >= s)
      by_half([&](auto half) {
        constexpr int UB = K::template UB<decltype(half)::value>;
        constexpr int UE = K::template UE<decltype(half)::value>;
        for (int k0 = diag ? r0 : 0; k0 < kT; k0 += 16) {
          uint32_t mh[4], ml[4], dh[4], dl[4];
          if constexpr (UB < K::PU) {
            ldsm_x4_t(mh, a_cols(Wmh, kHp, r0, k0));
            ldsm_x4_t(ml, a_cols(Wml, kHp, r0, k0));
          }
          if constexpr (UE > K::PU) {
            ldsm_x4_t(dh, a_cols(Wdh, kHp, r0, k0));
            ldsm_x4_t(dl, a_cols(Wdl, kHp, r0, k0));
          }
#pragma unroll
          for (int ui = 0; ui < UE - UB; ++ui) {
            const int u = UB + ui;
            uint32_t bf[4];
            if (u < K::PU) {
              ldsm_x4_t(bf, b_cols(Dy, K::xp, 16 * u, k0));
              mma2(acc[ui][0], mh, ml, bf[0], bf[1]);
              mma2(acc[ui][1], mh, ml, bf[2], bf[3]);
            } else {
              ldsm_x4_t(bf, b_cols(Cl, K::np, 16 * (u - K::PU), k0));
              mma2(acc[ui][0], dh, dl, bf[0], bf[1]);
              mma2(acc[ui][1], dh, dl, bf[2], bf[3]);
            }
          }
        }
      });
      if (diag) {         // dC_h of l tile lt is complete: <C[l], dC_h[l]>
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int ll = r0 + g + 8 * h2;
          float yo = 0.f;
#pragma unroll
          for (int j = 0; j < K::DC; ++j) {
            const __nv_bfloat162 cv =
                *reinterpret_cast<const __nv_bfloat162*>(Cl + ll * K::np + dcn0 + 8 * j + 2 * t);
            yo = fmaf(__bfloat162float(cv.x), dc[j][2 * h2], yo);
            yo = fmaf(__bfloat162float(cv.y), dc[j][2 * h2 + 1], yo);
          }
          yo = quad_sum(yo);
          if (t == 0) red_y[ch * kT + ll] = yo;
        }
      }
      __syncthreads();    // W, Dy and Cl are consumed

      if (diag) {         // l tile lt is complete: the cluster sums its dC_h
#pragma unroll
        for (int j = 0; j < K::DC; ++j) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            *reinterpret_cast<float2*>(stg + (r0 + g + 8 * h2) * K::sp + dcn0 + 8 * j + 2 * t) =
                make_float2(dc[j][2 * h2], dc[j][2 * h2 + 1]);
          }
        }
        if (lt + 1 < nlt) {   // else summed with the last dB tile
          load_l(lt + 1);     // Dy and Cl are consumed
          cluster_sum(a.dcp + part + static_cast<long long>(l0) * a.nw, min(kT, Lc - l0),
                      nullptr);
          if (tid < kT) rowp[l0 + tid] = red_y[tid] + red_y[kT + tid];
        }
        dc_lt = -1;
      }
    }

    // s tile st is complete: <x, d dtx>, the cluster's dB (the last one with
    // the last dC, over the tile operands), dx = dt d dtx
    const bool last = st + 1 == nlt;
    float* stg_b = last ? stg2 : stg;
    staging_free();
    bf16* dx = static_cast<bf16*>(a.dx) + ((static_cast<long long>(b) * a.S + c0) * a.H + h) * a.P;
    by_half([&](auto half) {
      constexpr int UB = K::template UB<decltype(half)::value>;
      constexpr int UE = K::template UE<decltype(half)::value>;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {   // <x[s], d dtx[s]> and <B[s], dB_h[s]>
        const int ss = r0 + g + 8 * h2;
        float xd = 0.f, bd = 0.f;
#pragma unroll
        for (int ui = 0; ui < UE - UB; ++ui) {
          const int u = UB + ui;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float v0 = acc[ui][j][2 * h2], v1 = acc[ui][j][2 * h2 + 1];
            if (u < K::PU) {
              const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
                  Xs + ss * K::xp + 16 * u + 8 * j + 2 * t);
              xd = fmaf(__bfloat162float(xv.x), v0, xd);
              xd = fmaf(__bfloat162float(xv.y), v1, xd);
            } else {
              const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(
                  Bs + ss * K::np + 16 * (u - K::PU) + 8 * j + 2 * t);
              bd = fmaf(__bfloat162float(bv.x), v0, bd);
              bd = fmaf(__bfloat162float(bv.y), v1, bd);
            }
          }
        }
        xd = quad_sum(xd);
        bd = quad_sum(bd);
        if (t == 0) {
          red_x[ch * kT + ss] = xd;
          red_b[ch * kT + ss] = bd;
        }
      }
    });
    __syncthreads();          // Xs and Bs are consumed (Dy and Cl already were)
    if (!last) {              // the next s tile streams in during the sum
      load_s(st + 1);
      if (loaded_l != st + 1) load_l(st + 1);
    }
    by_half([&](auto half) {   // the head's dB tile into the staging tile
      constexpr int UB = K::template UB<decltype(half)::value>;
      constexpr int UE = K::template UE<decltype(half)::value>;
#pragma unroll
      for (int ui = 0; ui < UE - UB; ++ui) {
        const int u = UB + ui;
        if (u < K::PU) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            *reinterpret_cast<float2*>(stg_b + (r0 + g + 8 * h2) * K::sp + 16 * (u - K::PU) +
                                       8 * j + 2 * t) =
                make_float2(acc[ui][j][2 * h2], acc[ui][j][2 * h2 + 1]);
          }
        }
      }
    });
    float* db_part = a.dbp + part + static_cast<long long>(s0) * a.nw;
    if (last) {               // stg: the last dC tile (staged at its diagonal pair)
      cluster_sum(a.dcp + part + static_cast<long long>(s0) * a.nw, min(kT, Lc - s0), db_part);
    } else {
      cluster_sum(db_part, min(kT, Lc - s0), nullptr);
    }
    if (tid < kT) {
      ddx[s0 + tid] = red_x[tid] + red_x[kT + tid];
      colp[s0 + tid] = red_b[tid] + red_b[kT + tid];
      if (last) rowp[s0 + tid] = red_y[tid] + red_y[kT + tid];
    }
    by_half([&](auto half) {   // dx = dt d dtx, after the sum's release
      constexpr int UB = K::template UB<decltype(half)::value>;
      constexpr int UE = K::template UE<decltype(half)::value>;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int s = s0 + r0 + g + 8 * h2;
#pragma unroll
        for (int ui = 0; ui < UE - UB; ++ui) {
          const int u = UB + ui;
          if (u >= K::PU) break;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int p = 16 * u + 8 * j + 2 * t;
            if (s < Lc && p < a.P) {
              *reinterpret_cast<__nv_bfloat162*>(dx + static_cast<long long>(s) * a.H * a.P + p) =
                  __floats2bfloat162_rn(__fmul_rn(dts[s], acc[ui][j][2 * h2]),
                                        __fmul_rn(dts[s], acc[ui][j][2 * h2 + 1]));
            }
          }
        }
      }
    });
  }
  staging_free();         // no CTA leaves while another reads its staging tile
  __syncthreads();

  // d a_cs = <C[l], dC_h[l]> - <B[l], dB_h[l]>, and at the chunk's last row
  // + sum_s r[s] + exp(a_cs[-1]) <G, prev>; its reverse cumsum d a in fp64,
  // rounded once: each thread a run of positions from the chunk's end, the
  // runs scanned across the warp with shuffles and across the warps in shared
  // memory, sum r summed beside them; then ddt and the fp64 partial dA
  constexpr int kW = kTc / 32;
  const int per = (Lc + kTc - 1) / kTc;
  const int beg = min(Lc, tid * per), end = min(Lc, beg + per);   // j = Lc - 1 - l
  double run = 0.0, rsum = 0.0;
  for (int j = beg; j < end; ++j) {
    const int l = Lc - 1 - j;
    run += static_cast<double>(rowp[l] - colp[l]);
    rsum += static_cast<double>(rr[l]);
  }
  double inc = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(kFullMask, inc, o);
    if (lane >= o) inc += v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) rsum += __shfl_xor_sync(kFullMask, rsum, o);
  double off = __shfl_up_sync(kFullMask, inc, 1);
  if (lane == 0) off = 0.0;
  if (lane == 31) red64[warp] = inc;
  if (lane == 0) red64[kW + warp] = rsum;
  __syncthreads();
  double sr = 0.0;
  for (int w = 0; w < kW; ++w) sr += red64[kW + w];
  for (int w = 0; w < warp; ++w) off += red64[w];
  off += sr + (has_g && has_prev ? static_cast<double>(expf(acs[Lc - 1])) * gp : 0.0);
  const float A = a.A[h];
  float* ddt = a.ddt + (static_cast<long long>(b) * a.S + c0) * a.H + h;
  double pa = 0.0;
  for (int j = beg; j < end; ++j) {
    const int l = Lc - 1 - j;
    off += static_cast<double>(rowp[l] - colp[l]);
    const float d = static_cast<float>(off);
    ddt[static_cast<long long>(l) * a.H] = __fadd_rn(__fmul_rn(A, d), ddx[l]);
    pa += static_cast<double>(dts[l]) * static_cast<double>(d);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) pa += __shfl_xor_sync(kFullMask, pa, o);
  if (lane == 0) red64[2 * kW + warp] = pa;
  __syncthreads();
  if (tid == 0) {
    double sa = 0.0;
    for (int w = 0; w < kW; ++w) sa += red64[2 * kW + w];
    a.dap[row] = sa;
  }
}

// U_c[p][n] = sum_l exp(a_cs[l]) dy[l][p] C[l][n] of one (row, chunk, head)
// on the tensor cores, written to a.g; chunk 0 only for d init_state. Warp
// w: p tiles (w & 3) + 4 i, column half w >> 2.
template <int PP, int NB>
__global__ void __launch_bounds__(kTc) bwd_mma_state_kernel(BwdArgs a) {
  using K = Tc<PP, NB>;
  constexpr int kMW = (PP / 16 + 3) / 4;
  extern __shared__ __align__(16) unsigned char state_smem_buf[];
  const int h = blockIdx.x, c = blockIdx.y + (a.dinit ? 0 : 1), b = blockIdx.z;
  const long long c0 = static_cast<long long>(c) * a.chunk;
  const int Lc = chunk_len(a, c);
  const long long row = row_of(a, b, c, h);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp & 3, ch = warp >> 2, dcn0 = ch * (NB / 2);
  bf16* Dh = reinterpret_cast<bf16*>(state_smem_buf);   // (64, xp) exp(a_cs) dy, hi
  bf16* Dl = Dh + kT * K::xp;                            //           and lo
  bf16* Cs = Dl + kT * K::xp;                            // (64, np) C
  const bf16* dyh = static_cast<const bf16*>(a.dy) + b * a.dy_sb + h * a.dy_sh + c0 * a.dy_ss;
  const bf16* Cc = static_cast<const bf16*>(a.Cm) + b * a.c_sb + c0 * a.c_ss;
  const float* acs = a.acs + row * a.chunk;
  float acc[kMW][K::DC][4] = {};
  for (int l0 = 0; l0 < Lc; l0 += kT) {
    __syncthreads();      // the last tile is consumed
    tile_to_smem(Cs, K::np, Cc + l0 * a.c_ss, a.c_ss, Lc - l0, a.N, NB, a.bc_vec);
    for (int e = tid; e < kT * (PP / 2); e += kTc) {
      const int r = e / (PP / 2), p = 2 * (e - r * (PP / 2));
      float v0 = 0.f, v1 = 0.f;
      if (r < Lc - l0 && p < a.P) {
        const float ea = expf(acs[l0 + r]);
        const bf16* d = dyh + (l0 + r) * a.dy_ss + p;
        v0 = __fmul_rn(ea, __bfloat162float(d[0]));
        v1 = __fmul_rn(ea, __bfloat162float(d[1]));
      }
      uint32_t hi, lo;
      split_bf16x2(v0, v1, hi, lo);
      *reinterpret_cast<uint32_t*>(Dh + r * K::xp + p) = hi;
      *reinterpret_cast<uint32_t*>(Dl + r * K::xp + p) = lo;
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < kT; k0 += 16) {
#pragma unroll
      for (int mi = 0; mi < kMW; ++mi) {
        const int mt = rg + 4 * mi;
        if (mt >= PP / 16) break;
        uint32_t ah[4], al[4];   // A = (exp(a_cs) dy)^T: rows p, depth l
        ldsm_x4_t(ah, a_cols(Dh, K::xp, 16 * mt, k0));
        ldsm_x4_t(al, a_cols(Dl, K::xp, 16 * mt, k0));
#pragma unroll
        for (int u = 0; u < K::DC / 2; ++u) {
          uint32_t bf[4];
          ldsm_x4_t(bf, b_cols(Cs, K::np, dcn0 + 16 * u, k0));
          mma2(acc[mi][2 * u], ah, al, bf[0], bf[1]);
          mma2(acc[mi][2 * u + 1], ah, al, bf[2], bf[3]);
        }
      }
    }
  }
  float* out = a.g + row * a.P * a.N;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kMW; ++mi) {
    const int mt = rg + 4 * mi;
    if (mt >= PP / 16) break;
#pragma unroll
    for (int j = 0; j < K::DC; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = 16 * mt + g + 8 * (q >> 1), n = dcn0 + 8 * j + 2 * t + (q & 1);
        if (p < a.P && n < a.N) out[p * a.N + n] = acc[mi][j][q];
      }
    }
  }
}

// Dynamic shared memory of the kernels, in bytes (kernels/ssd_scan.py's
// bwd_smem_bytes is the same sum).
struct BwdSmem {
  size_t cb, dstate, s, l, combine;   // fp32
  size_t mma, mma_long, mma_state;    // bf16; mma_long: the per-position
                                      // arrays in a.pos (kLong)
};
BwdSmem bwd_smem(int PP, int NB, int chunk) {
  const size_t pp = PP + 1, np = NB + 1, t = kT;
  const size_t g = PP * np;
  const size_t s_state = g + t * np, s_tiles = t * np + t * pp + t * kTP + 16 * t;
  const size_t l_state = g + t * np, l_tiles = t * np + t * pp + t * kTP;
  const size_t L = (chunk + kT - 1) / kT * kT, xp = PP + 8, bp = NB + 8;
  BwdSmem m;
  m.cb = 4 * (2 * t * np);
  m.dstate = 4 * (t * pp + t * np + chunk);
  m.s = 4 * (t * pp + chunk + 3 * t + (s_state > s_tiles ? s_state : s_tiles));
  m.l = 4 * (t * pp + chunk + (l_state > l_tiles ? l_state : l_tiles));
  m.combine = static_cast<size_t>(chunk) * sizeof(double);
  m.mma_long = 2 * (2 * t * xp + 2 * t * bp + 4 * t * kHp) + 4 * (6 * t) + 8 * 3 * (kTc / 32);
  m.mma = m.mma_long + 4 * 6 * L;
  m.mma_state = 2 * (2 * t * xp + t * bp);
  return m;
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

#define HYDRA_CHECK(expr)                    \
  do {                                       \
    const int e_ = (expr);                   \
    if (e_ != 0) return e_;                  \
  } while (0)

template <typename T>
int launch_reduce(const BwdArgs& a, cudaStream_t s) {
  const long long elems = static_cast<long long>(a.Bsz) * a.S * a.N;
  const int nblk = static_cast<int>((elems + kThreads - 1) / kThreads);
  bwd_reduce_kernel<T><<<nblk + (a.H + kThreads - 1) / kThreads, kThreads, 0, s>>>(a, nblk);
  return static_cast<int>(cudaGetLastError());
}

template <int PP, int NB>
int launch_f32(const BwdArgs& a, cudaStream_t s) {
  const BwdSmem m = bwd_smem(PP, NB, a.chunk);
  if (m.s > 232448 || m.l > 232448 || m.dstate > 232448 || m.cb > 232448 ||
      m.combine > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HYDRA_CHECK(allow_smem(bwd_combine_kernel, m.combine));
  HYDRA_CHECK(allow_smem(bwd_cb_kernel<NB>, m.cb));
  HYDRA_CHECK(allow_smem(bwd_dstate_kernel<PP, NB>, m.dstate));
  HYDRA_CHECK(allow_smem(bwd_s_kernel<PP, NB>, m.s));
  HYDRA_CHECK(allow_smem(bwd_l_kernel<PP, NB>, m.l));
  const int B = a.Bsz, nch = a.nc * a.H;
  bwd_cb_kernel<NB><<<dim3(a.ntri, a.nc, B), kThreads, m.cb, s>>>(a);
  HYDRA_CHECK(static_cast<int>(cudaGetLastError()));
  bwd_dstate_kernel<PP, NB><<<dim3(nch, B), kThreads, m.dstate, s>>>(a);
  HYDRA_CHECK(static_cast<int>(cudaGetLastError()));
  bwd_grec_kernel<<<dim3((a.P * a.N + kThreads - 1) / kThreads, a.H, B), kThreads, 0, s>>>(a);
  HYDRA_CHECK(static_cast<int>(cudaGetLastError()));
  bwd_s_kernel<PP, NB><<<dim3(a.nlt, nch, B), kThreads, m.s, s>>>(a);
  HYDRA_CHECK(static_cast<int>(cudaGetLastError()));
  bwd_l_kernel<PP, NB><<<dim3(a.nlt, nch, B), kThreads, m.l, s>>>(a);
  HYDRA_CHECK(static_cast<int>(cudaGetLastError()));
  bwd_combine_kernel<<<dim3(nch, B), kCombThreads, m.combine, s>>>(a);
  HYDRA_CHECK(static_cast<int>(cudaGetLastError()));
  return launch_reduce<float>(a, s);
}

// bf16: U_c where needed, the recurrence where needed, the fused pass in
// clusters of a.hc heads, the reduction. The fused pass keeps its
// per-position arrays in a.pos exactly when they do not fit beside its
// tiles.
template <int PP, int NB>
int launch_bf16(const BwdArgs& a, cudaStream_t s) {
  const BwdSmem m = bwd_smem(PP, NB, a.chunk);
  const bool long_chunk = m.mma > 232448;
  const size_t mma = long_chunk ? m.mma_long : m.mma;
  if (mma > 232448 || m.mma_state > 232448 || a.hc < 1 || a.hc > kMaxCluster ||
      a.H % a.hc != 0 || a.nparts * a.hc != a.H || (a.nlt >= 3 && !a.pend) ||
      long_chunk != (a.pos != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto mma_kernel =
      long_chunk ? bwd_mma_kernel<PP, NB, true> : bwd_mma_kernel<PP, NB, false>;
  HYDRA_CHECK(allow_smem(mma_kernel, mma));
  HYDRA_CHECK(allow_smem(bwd_mma_state_kernel<PP, NB>, m.mma_state));
  const int B = a.Bsz, c_lo = a.dinit ? 0 : 1;
  if (a.nc > c_lo) {
    bwd_mma_state_kernel<PP, NB><<<dim3(a.H, a.nc - c_lo, B), kTc, m.mma_state, s>>>(a);
    HYDRA_CHECK(static_cast<int>(cudaGetLastError()));
  }
  if (a.nc > 1 || a.dinit || a.dfinal) {
    bwd_grec_kernel<<<dim3((a.P * a.N + kThreads - 1) / kThreads, a.H, B), kThreads, 0, s>>>(a);
    HYDRA_CHECK(static_cast<int>(cudaGetLastError()));
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.H, a.nc, B);
  cfg.blockDim = dim3(kTc, 1, 1);
  cfg.dynamicSmemBytes = mma;
  cfg.stream = s;
  cudaLaunchAttribute cl[1];
  cl[0].id = cudaLaunchAttributeClusterDimension;
  cl[0].val.clusterDim.x = static_cast<unsigned>(a.hc);
  cl[0].val.clusterDim.y = 1;
  cl[0].val.clusterDim.z = 1;
  cfg.attrs = cl;
  cfg.numAttrs = 1;
  HYDRA_CHECK(static_cast<int>(cudaLaunchKernelEx(&cfg, mma_kernel, a)));
  HYDRA_CHECK(static_cast<int>(cudaGetLastError()));
  return launch_reduce<bf16>(a, s);
}

template <int PP>
int dispatch_n(const BwdArgs& a, bool f32, cudaStream_t s) {
  if (f32) return a.N <= 64 ? launch_f32<PP, 64>(a, s) : launch_f32<PP, 128>(a, s);
  return a.N <= 64 ? launch_bf16<PP, 64>(a, s) : launch_bf16<PP, 128>(a, s);
}

int dispatch_p(const BwdArgs& a, bool f32, cudaStream_t s) {
  switch (a.P) {
    case 8:
    case 16: return dispatch_n<16>(a, f32, s);
    case 32: return dispatch_n<32>(a, f32, s);
    case 64: return dispatch_n<64>(a, f32, s);
    case 128: return dispatch_n<128>(a, f32, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Strides are in elements; dy is read through its strides, the gradients
// are written contiguous. dfinal and dinit may be null (dinit is given
// exactly when the forward had an init state). The saved a_cs and states and
// the workspaces are laid out by kernels/ssd_scan.py's BwdPlan for this
// (B, S, H, P, N), chunk and dtype (the chunk cut to S, as the forward that
// saved them ran it). fp32: ws_cb (B, nc, ntri, 64, 64), ws_g (B, nc, H, P,
// N), ws_dbp and ws_dcp (B, H, S, N), ws_pos (4, B, nc, H, chunk) fp32,
// ws_dap (B, nc, H) fp64; `cluster` is ignored. bf16: ws_g as fp32 where the
// recurrence runs (more than one chunk, an init state or dfinal), else
// null; ws_dbp and ws_dcp (B, H / cluster, S, N rounded up to 4); ws_pend
// (B, nc, H, nlt - 1, 64 NB) with NB = 64 or 128 where a chunk has three
// or more 64-row tiles, else null; ws_dap; `cluster` (1-8, dividing H)
// heads per cluster; ws_pos (B, nc, H, 6, nlt 64) fp32 where the chunk is too
// long for the fused pass to keep its per-position arrays in shared memory,
// else null. N <= 128.
extern "C" int hydra_ssd_scan_bwd(
    const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
    const void* dy, const void* dfinal, const void* acs, const void* st, void* ws_cb,
    void* ws_g, void* ws_dbp, void* ws_dcp, void* ws_pos, void* ws_pend, void* ws_dap,
    void* dx, void* ddt, void* dA, void* dB, void* dC, void* dinit, int B, int S, int H,
    int P, int N, int chunk, int cluster, long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, long long dy_sb, long long dy_ss, long long dy_sh,
    int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0 || N > 128 || chunk <= 0 || chunk > S || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != kF32 && dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  const bool f32 = dtype == kF32;
  BwdArgs a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bm = Bm;
  a.Cm = Cm;
  a.dy = dy;
  a.dfinal = static_cast<const float*>(dfinal);
  a.acs = static_cast<const float*>(acs);
  a.st = static_cast<const float*>(st);
  a.cb = static_cast<float*>(ws_cb);
  a.g = static_cast<float*>(ws_g);
  a.dbp = static_cast<float*>(ws_dbp);
  a.dcp = static_cast<float*>(ws_dcp);
  a.pos = static_cast<float*>(ws_pos);
  a.pend = static_cast<float*>(ws_pend);
  a.dap = static_cast<double*>(ws_dap);
  a.dx = dx;
  a.ddt = static_cast<float*>(ddt);
  a.dA = static_cast<float*>(dA);
  a.dB = dB;
  a.dC = dC;
  a.dinit = static_cast<float*>(dinit);
  a.Bsz = B;
  a.S = S;
  a.H = H;
  a.P = P;
  a.N = N;
  a.chunk = chunk;
  a.nc = (S + chunk - 1) / chunk;
  a.nlt = (chunk + kT - 1) / kT;
  a.ntri = a.nlt * (a.nlt + 1) / 2;
  a.hc = f32 ? 1 : cluster;
  a.nparts = f32 ? H : (cluster > 0 ? H / cluster : 0);
  a.nw = f32 ? N : (N + 3) / 4 * 4;
  a.x_sb = x_sb;
  a.x_ss = x_ss;
  a.x_sh = x_sh;
  a.dt_sb = dt_sb;
  a.dt_ss = dt_ss;
  a.dt_sh = dt_sh;
  a.b_sb = b_sb;
  a.b_ss = b_ss;
  a.c_sb = c_sb;
  a.c_ss = c_ss;
  a.dy_sb = dy_sb;
  a.dy_ss = dy_ss;
  a.dy_sh = dy_sh;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  a.x_vec = aligned(x) && x_sb % 8 == 0 && x_ss % 8 == 0 && x_sh % 8 == 0;
  a.bc_vec = aligned(Bm) && aligned(Cm) && N % 8 == 0 && b_sb % 8 == 0 && b_ss % 8 == 0 &&
             c_sb % 8 == 0 && c_ss % 8 == 0;
  a.dy_vec = aligned(dy) && dy_sb % 8 == 0 && dy_ss % 8 == 0 && dy_sh % 8 == 0;
  if (f32 && (static_cast<long long>(a.nc) * H > 65535 || a.ntri > 65535)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!f32 && a.nc > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_p(a, f32, static_cast<cudaStream_t>(stream));
}
