// Backward of the Mamba2 SSD chunked scan (csrc/ssd_scan.cu): from the
// forward's inputs x (B,S,H,P), dt (B,S,H) fp32, A (H,) fp32, Bm/Cm (B,S,N)
// (x, Bm, Cm in one dtype, read through their strides), the cotangent dy
// (B,S,H,P) in x's dtype and optionally the final state's (B,H,P,N) fp32,
// it writes dx, dB, dC in x's dtype, ddt and dA in fp32, and optionally
// the initial state's gradient (B,H,P,N) fp32. It reads what the forward
// saved: a_cs (B, chunks, H, chunk) and the state entering each chunk
// (B, chunks, H, P, N), both fp32.
//
// No Pallas backward exists: the JAX package trains by jax.value_and_grad
// through its jnp oracle (repro/kernels/ref.py ssd_scan_ref), so this
// replaces that gradient, not a TPU kernel. The math per chunk, with a =
// dt A, a_cs its in-chunk cumsum, dtx = dt x, L[l,s] = exp(a_cs[l] -
// a_cs[s]) for s <= l (masked before exp: never factored through exp(-a_cs)),
// prev the state entering the chunk and G the cotangent of the state
// leaving it:
//   G_c      = G_{c+1} exp(a_cs_c[-1]) + sum_l exp(a_cs[l]) dy[l]^T C[l]
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
//
// Seven kernels, one call (the wrapper counts it once):
//   bwd_cb_kernel      C B^T per lower-triangular 64 x 64 tile, once per (row, chunk)
//   bwd_dstate_kernel  U_c = sum_l exp(a_cs[l]) dy[l]^T C[l] per (row, chunk, head)
//   bwd_grec_kernel    the reverse recurrence over the chunks: G_{c+1} per chunk
//                      (overwriting U_c) and d init_state = G_0
//   bwd_s_kernel       per (s tile, chunk, head, row): d dtx, dx, <x, d dtx>, the
//                      head's partial dB, colsum E and r for its 64 positions
//   bwd_l_kernel       per (l tile, chunk, head, row): the head's partial dC and
//                      rowsum E + <dy, Y_off> for its 64 positions
//   bwd_combine_kernel per (row, chunk, head): d a_cs, the fp64 reverse cumsum,
//                      ddt and the partial dA (fp64)
//   bwd_reduce_kernel  dB and dC summed over the heads, dA over rows and chunks
// The per-head partials and their reductions replace atomics: every sum runs
// in a fixed order, so two calls are bit-equal.
//
// Bound on the H100: at the training shapes the inputs and outputs move
// 33-43 MB (about 0.01 ms), while the tile products are 5-9 GFLOP of fp32
// FMAs. This first design computes every product with scalar fp32 FMAs from
// shared memory (a 16 x 16 thread grid, each thread a 4 x k register tile),
// for both dtypes: it is bound by those FMAs and the shared-memory loads that
// feed them, not by the tensor cores, and by how many CTAs an SM holds. So
// the s and l kernels keep in a union what their loops do not read (the
// (P, N) state and the tile it multiplies) and share one 64 x 64 tile for
// (C B^T) o L and dCB: at the training shapes 2-3 CTAs fit an SM. Every
// operand and sum stays fp32, so the bf16 path needs no hi + lo split; the
// bf16 forward's saved states carry its split's ~16 bits.
#include "common.cuh"

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
  float* cb;             // (B, nc, ntri, 64, 64) C B^T tiles
  float* g;              // (B, nc, H, P, N) U_c, then G_{c+1}
  float* dbp;            // (B, H, S, N) per-head partial dB
  float* dcp;            // (B, H, S, N) per-head partial dC
  float* pos;            // (4, B, nc, H, chunk) rowpart, colpart, r, <x, d dtx>
  double* dap;           // (B, nc, H) partial dA
  void* dx;              // (B, S, H, P) contiguous, x's dtype
  float* ddt;            // (B, S, H) contiguous
  float* dA;             // (H,)
  void* dB;              // (B, S, N) contiguous, x's dtype
  void* dC;
  float* dinit;          // null: not wanted
  int Bsz, S, H, P, N, chunk, nc, nlt, ntri;
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
template <typename T>
__device__ void load_tile(float* dst, int pitch, const T* src, long long ld, int nrows,
                          int ncols, int width, const float* scale, long long sstride) {
  for (int e = threadIdx.x; e < kT * width; e += kThreads) {
    const int r = e / width, c = e - r * width;
    float v = 0.f;
    if (r < nrows && c < ncols) {
      v = to_f(src[r * ld + c]);
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
template <typename T, int NB>
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
  load_tile(Cs, np, static_cast<const T*>(a.Cm) + b * a.c_sb + (c0 + l0) * a.c_ss, a.c_ss,
            Lc - l0, a.N, NB, static_cast<const float*>(nullptr), 0);
  load_tile(Bs, np, static_cast<const T*>(a.Bm) + b * a.b_sb + (c0 + s0) * a.b_ss, a.b_ss,
            Lc - s0, a.N, NB, static_cast<const float*>(nullptr), 0);
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
template <typename T, int PP, int NB>
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
  const T* dy = static_cast<const T*>(a.dy) + b * a.dy_sb + h * a.dy_sh + c0 * a.dy_ss;
  const T* Cm = static_cast<const T*>(a.Cm) + b * a.c_sb + c0 * a.c_ss;
  float acc[PP / 16][NB / 16] = {};
  for (int l0 = 0; l0 < Lc; l0 += kT) {
    __syncthreads();  // ea is written; the last tiles are consumed
    load_tile(Dy, pp, dy + l0 * a.dy_ss, a.dy_ss, Lc - l0, a.P, PP, ea + l0, 1);
    load_tile(Cs, np, Cm + l0 * a.c_ss, a.c_ss, Lc - l0, a.N, NB,
              static_cast<const float*>(nullptr), 0);
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
__global__ void __launch_bounds__(kThreads) bwd_grec_kernel(BwdArgs a) {
  const int PN = a.P * a.N;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * a.H + h;
  float cur = a.dfinal ? a.dfinal[bh * PN + e] : 0.f;
  for (int c = a.nc - 1; c >= 0; --c) {
    const long long row = row_of(a, b, c, h);
    const float d = expf(a.acs[row * a.chunk + chunk_len(a, c) - 1]);
    float* gp = a.g + row * PN + e;
    const float u = *gp;
    *gp = cur;
    cur = fmaf(cur, d, u);
  }
  if (a.dinit) a.dinit[bh * PN + e] = cur;
}

// The gradients indexed by s for the 64 positions of s tile blockIdx.x.
template <typename T, int PP, int NB>
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
  load_tile(Bs, np, static_cast<const T*>(a.Bm) + b * a.b_sb + (c0 + s0) * a.b_ss, a.b_ss,
            Lc - s0, a.N, NB, static_cast<const float*>(nullptr), 0);
  __syncthreads();    // dts is written
  load_tile(Xs, pp, static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh + (c0 + s0) * a.x_ss,
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
    load_tile(Cl, np, static_cast<const T*>(a.Cm) + b * a.c_sb + (c0 + l0) * a.c_ss, a.c_ss,
              Lc - l0, a.N, NB, static_cast<const float*>(nullptr), 0);
    load_tile(Dy, pp,
              static_cast<const T*>(a.dy) + b * a.dy_sb + h * a.dy_sh + (c0 + l0) * a.dy_ss,
              a.dy_ss, Lc - l0, a.P, PP, static_cast<const float*>(nullptr), 0);
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

  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh + c0 * a.x_ss;
  T* dx = static_cast<T*>(a.dx) + ((static_cast<long long>(b) * a.S + c0) * a.H + h) * a.P;
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
        dx[static_cast<long long>(s) * a.H * a.P + p] = from_f<T>(dts[s - s0] * dd[i][j]);
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
template <typename T, int PP, int NB>
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
  load_tile(Cl, np, static_cast<const T*>(a.Cm) + b * a.c_sb + (c0 + l0) * a.c_ss, a.c_ss,
            Lc - l0, a.N, NB, static_cast<const float*>(nullptr), 0);
  load_tile(Dy, pp,
            static_cast<const T*>(a.dy) + b * a.dy_sb + h * a.dy_sh + (c0 + l0) * a.dy_ss,
            a.dy_ss, Lc - l0, a.P, PP, static_cast<const float*>(nullptr), 0);
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
    load_tile(Bs, np, static_cast<const T*>(a.Bm) + b * a.b_sb + (c0 + s0) * a.b_ss, a.b_ss,
              Lc - s0, a.N, NB, static_cast<const float*>(nullptr), 0);
    load_tile(Xs, pp,
              static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh + (c0 + s0) * a.x_ss,
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

// Block sum of v over kCombThreads threads in a fixed order; every thread
// gets it. `red` holds kCombThreads / 32 doubles.
__device__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  __syncthreads();    // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < kCombThreads / 32; ++w) s += red[w];
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
  double* dacs = dsm;                                           // (chunk), reversed
  float* da = reinterpret_cast<float*>(dacs + a.chunk);         // (chunk)
  const float* rowp = pos_of(a, kRow, row);
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
  sr = block_sum(sr, red);
  sg = block_sum(sg, red);
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
  pa = block_sum(pa, red);
  if (tid == 0) a.dap[row] = pa;
}

// dB, dC: the per-head partials summed in head order; the blocks past the
// B S N elements sum dA's partials over (row, chunk) in order.
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
  const long long SN = static_cast<long long>(a.S) * a.N;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= a.Bsz * SN) return;
  const long long b = e / SN, rem = e - b * SN;
  const float* pb = a.dbp + b * a.H * SN + rem;
  const float* pc = a.dcp + b * a.H * SN + rem;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < a.H; ++h) {
    sb += pb[h * SN];
    sc += pc[h * SN];
  }
  static_cast<T*>(a.dB)[e] = from_f<T>(sb);
  static_cast<T*>(a.dC)[e] = from_f<T>(sc);
}

// Dynamic shared memory of the tiled kernels, in bytes (kernels/ssd_scan.py's
// bwd_smem_bytes is the same sum).
struct BwdSmem {
  size_t cb, dstate, s, l;
};
BwdSmem bwd_smem(int PP, int NB, int chunk) {
  const size_t pp = PP + 1, np = NB + 1, t = kT;
  const size_t g = PP * np;
  const size_t s_state = g + t * np, s_tiles = t * np + t * pp + t * kTP + 16 * t;
  const size_t l_state = g + t * np, l_tiles = t * np + t * pp + t * kTP;
  BwdSmem m;
  m.cb = 4 * (2 * t * np);
  m.dstate = 4 * (t * pp + t * np + chunk);
  m.s = 4 * (t * pp + chunk + 3 * t + (s_state > s_tiles ? s_state : s_tiles));
  m.l = 4 * (t * pp + chunk + (l_state > l_tiles ? l_state : l_tiles));
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

template <typename T, int PP, int NB>
int launch(const BwdArgs& a, cudaStream_t s) {
  const BwdSmem m = bwd_smem(PP, NB, a.chunk);
  if (m.s > 232448 || m.l > 232448 || m.dstate > 232448 || m.cb > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HYDRA_CHECK(allow_smem(bwd_cb_kernel<T, NB>, m.cb));
  HYDRA_CHECK(allow_smem(bwd_dstate_kernel<T, PP, NB>, m.dstate));
  HYDRA_CHECK(allow_smem(bwd_s_kernel<T, PP, NB>, m.s));
  HYDRA_CHECK(allow_smem(bwd_l_kernel<T, PP, NB>, m.l));
  const int B = a.Bsz, nch = a.nc * a.H;
  bwd_cb_kernel<T, NB><<<dim3(a.ntri, a.nc, B), kThreads, m.cb, s>>>(a);
  HYDRA_CHECK(static_cast<int>(cudaGetLastError()));
  bwd_dstate_kernel<T, PP, NB><<<dim3(nch, B), kThreads, m.dstate, s>>>(a);
  HYDRA_CHECK(static_cast<int>(cudaGetLastError()));
  bwd_grec_kernel<<<dim3((a.P * a.N + kThreads - 1) / kThreads, a.H, B), kThreads, 0, s>>>(a);
  HYDRA_CHECK(static_cast<int>(cudaGetLastError()));
  bwd_s_kernel<T, PP, NB><<<dim3(a.nlt, nch, B), kThreads, m.s, s>>>(a);
  HYDRA_CHECK(static_cast<int>(cudaGetLastError()));
  bwd_l_kernel<T, PP, NB><<<dim3(a.nlt, nch, B), kThreads, m.l, s>>>(a);
  HYDRA_CHECK(static_cast<int>(cudaGetLastError()));
  const size_t comb = static_cast<size_t>(a.chunk) * (sizeof(double) + sizeof(float));
  bwd_combine_kernel<<<dim3(nch, B), kCombThreads, comb, s>>>(a);
  HYDRA_CHECK(static_cast<int>(cudaGetLastError()));
  const long long elems = static_cast<long long>(B) * a.S * a.N;
  const int nblk = static_cast<int>((elems + kThreads - 1) / kThreads);
  bwd_reduce_kernel<T><<<nblk + (a.H + kThreads - 1) / kThreads, kThreads, 0, s>>>(a, nblk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int PP>
int dispatch_n(const BwdArgs& a, cudaStream_t s) {
  return a.N <= 64 ? launch<T, PP, 64>(a, s) : launch<T, PP, 128>(a, s);
}

template <typename T>
int dispatch_p(const BwdArgs& a, cudaStream_t s) {
  switch (a.P) {
    case 8:
    case 16: return dispatch_n<T, 16>(a, s);
    case 32: return dispatch_n<T, 32>(a, s);
    case 64: return dispatch_n<T, 64>(a, s);
    case 128: return dispatch_n<T, 128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Strides are in elements; dy is read through its strides, the gradients
// are written contiguous. dfinal and dinit may be null. The saved a_cs and
// states and the workspaces are laid out by kernels/ssd_scan.py's ScanPlan
// for this (B, S, H, P, N) and chunk (the chunk cut to S, as the forward
// that saved them ran it): ws_cb (B, nc, ntri, 64, 64), ws_g (B, nc, H, P, N),
// ws_dbp and ws_dcp (B, H, S, N), ws_pos (4, B, nc, H, chunk) fp32, and
// ws_dap (B, nc, H) fp64. N <= 128.
extern "C" int hydra_ssd_scan_bwd(
    const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
    const void* dy, const void* dfinal, const void* acs, const void* st, void* ws_cb,
    void* ws_g, void* ws_dbp, void* ws_dcp, void* ws_pos, void* ws_dap, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* dinit, int B, int S, int H, int P, int N, int chunk,
    long long x_sb, long long x_ss, long long x_sh, long long dt_sb, long long dt_ss,
    long long dt_sh, long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long dy_sb, long long dy_ss, long long dy_sh, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0 || N > 128 || chunk <= 0 || chunk > S || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  if (static_cast<long long>(a.nc) * H > 65535 || a.ntri > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_p<float>(a, s);
  if (dtype == kBF16) return dispatch_p<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
