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
// carry nothing between them. Per chunk, with a_cs = cumsum(dt * A):
//   y     = ((C B^T) o tril(exp(a_cs[l] - a_cs[s]))) (dt x)
//           + (C prev^T) exp(a_cs)
//   S_c   = (dt x)^T (B exp(a_cs[-1] - a_cs))
//   state = prev exp(a_cs[-1]) + S_c   (prev: the state entering the chunk)
// Positions past S read as dt = x = B = C = 0, which is the reference's
// dt=0 padding: decay 1 and no contribution, so the state stays exact.
// The cumsum accumulates in fp64 and rounds each element to fp32 once, as
// the plain version does; fp32 sums in another order move y past the fp32
// check at a chunk of 256. The mask is applied before exp: a_cs[l] -
// a_cs[s] is positive above the diagonal and never reaches expf.
//
// bf16 (the serving path) runs three kernels, the chunked algorithm of
// arXiv:2405.21060 section 7, on the tensor cores:
//   A  ssd_chunk_kernel, grid (chunk, C B^T tile or (head, 64 state
//      columns), row): C B^T of each lower-triangular 64 x 64 tile of the
//      chunk, once per (row, chunk) since it does not depend on the head;
//      and per head a_cs (a parallel fp64 scan) and the chunk state S_c,
//      its x and B tiles double-buffered by cp.async.
//   B  ssd_state_kernel, grid (P*N / 1024, head, row): the recurrence over
//      the chunks in order; it overwrites each S_c with the state entering
//      chunk c and writes the final state.
//   C  ssd_out_kernel, grid (row x head x chunk, 64-row l tile, the last
//      tile first so the longest CTAs start first): y of one l tile,
//      (C prev^T) exp(a_cs[l]) first, then G' x summed over the s tiles
//      <= l, the C B^T values and x tiles of tile s + 1 loading while tile
//      s is used. Below the diagonal tile the decay factors through the
//      tile's first row, so G' needs no exp per element there.
// The products are mma.sync m16n8k16 (bf16 in, fp32 accumulate) fed by
// ldmatrix, each k step's fragments loaded before its products. mma.sync
// and not wgmma: every product here is a 64-row tile with a depth of
// 64-256, a few MFLOP per CTA, so the kernels are bound by latency, not by
// the tensor-core rate; mma.sync's per-warp register fragments let each
// thread build its operand of the diagonal product (C B^T times the decay
// mask times dt, split below) in registers straight from the fp32 C B^T
// tile, and take any P and N padded to 16 with zeros in shared memory,
// without wgmma's swizzled layouts.
// Accuracy: the reference keeps every operand in fp32; x, B and C are bf16
// and exact as operands. Each fp32 operand (G' = (C B^T) o L o dt, the
// fp32 state entering the chunk, dt exp(a_cs[-1] - a_cs) B) is split into
// bf16 hi + lo and takes two products: about 16 significant bits.
// Workspaces (fp32, from the wrapper, laid out by kernels/ssd_scan.py's
// ScanPlan): C B^T tiles (B, chunks, tiles, 64, 64), a_cs (B, chunks, H,
// chunk), states (B, chunks, H, P, N).
//
// fp32 keeps the first design, ssd_scan_kernel: one block per (head,
// row) walks the chunks in order with the state in shared memory, every
// product a scalar fp32 FMA. wgmma and mma.sync on fp32 operands are TF32,
// which cannot meet the fp32 check of 2e-5.
#include "common.cuh"
#include "hopper.cuh"

using namespace hydra;

namespace {

constexpr int kT = 64;   // l rows and s columns of one tile

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

// ---------------------------------------------------------------------------
// bf16: the chunk-parallel tensor-core kernels
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kTC = 128;              // threads of a tensor-core CTA: 4 warps
constexpr int kWarps = kTC / 32;      // each owns 16 rows of a 64-row tile
constexpr int kNB = 64;               // state columns (n) of one pass-A CTA
constexpr int kStateThreads = 256;    // pass B

struct SsdWork {
  float* cb;    // (B, nc, ntri, kT, kT) C B^T tiles, row-major (l, s)
  float* acs;   // (B, nc, H, chunk) a_cs
  float* st;    // (B, nc, H, P, N) S_c, then the state entering chunk c
  int nc;       // chunks
  int nlt;      // 64-row tiles per chunk
  int ntri;     // lower-triangular tiles per chunk: nlt (nlt + 1) / 2
  int npad;     // N rounded up to 16
  int nnb;      // kNB-column blocks of the state
  int x_vec;    // x rows may be copied as 16-byte pieces
  int bc_vec;   // Bm and Cm rows too
};

// Rows [0, kT) of a bf16 tile into shared memory (row pitch `pitch`): row r
// is src + r * ld. Its first `ncols` columns are copied, columns up to `w`
// (a multiple of 8) and rows >= nrows are zero. With `vec` the copies are
// 16-byte cp.async (src and ld 16-byte aligned, ncols a multiple of 8) and
// the caller commits and waits.
__device__ __forceinline__ void tile_to_smem(bf16* dst, int pitch, const bf16* src,
                                             long long ld, int nrows, int ncols,
                                             int w, bool vec) {
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
      dst[r * pitch + c] =
          (r < nrows && c < ncols) ? src[r * ld + c] : __float2bfloat16(0.f);
    }
  }
}

// Pass A, C B^T part: tile `tri` = lt (lt + 1) / 2 + st of chunk c, the
// product of C rows [64 lt, +64) and B rows [64 st, +64) over N.
__device__ void cb_tile(const SsdArgs& a, const SsdWork& w, int b, int c,
                        long long c0, int Lc, int tri, unsigned char* smem) {
  const int tile = tri;
  int lt = 0;
  while (tri > lt) {
    tri -= lt + 1;
    ++lt;
  }
  const int l0 = lt * kT, s0 = tri * kT;
  if (l0 >= Lc) return;                 // past the last chunk's rows
  const int pitch = w.npad + 8;
  bf16* Cs = reinterpret_cast<bf16*>(smem);
  bf16* Bs = Cs + kT * pitch;
  tile_to_smem(Cs, pitch,
               static_cast<const bf16*>(a.Cm) + b * a.c_sb + (c0 + l0) * a.c_ss,
               a.c_ss, Lc - l0, a.N, w.npad, w.bc_vec);
  tile_to_smem(Bs, pitch,
               static_cast<const bf16*>(a.Bm) + b * a.b_sb + (c0 + s0) * a.b_ss,
               a.b_ss, Lc - s0, a.N, w.npad, w.bc_vec);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[8][4] = {};
  for (int k0 = 0; k0 < w.npad; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, smem_addr(Cs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch +
                          k0 + (lane >> 4) * 8));
    uint32_t bf[4][4];   // the k step's B fragments first, then the products
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      ldsm_x4(bf[jp], smem_addr(Bs + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * pitch + k0 +
                                ((lane >> 3) & 1) * 8));
    }
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      mma_bf16_16816(acc[2 * jp], af, bf[jp][0], bf[jp][1]);
      mma_bf16_16816(acc[2 * jp + 1], af, bf[jp][2], bf[jp][3]);
    }
  }
  float* out = w.cb + ((static_cast<long long>(b) * w.nc + c) * w.ntri + tile) * kT * kT;
  const int r = warp * 16 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(out + r * kT + j * 8 + col) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + (r + 8) * kT + j * 8 + col) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// Pass A, head part: a_cs of chunk c for head h (written by the n block 0
// CTA) and columns [n0, n0 + kNB) of its chunk state
// S_c[p][n] = sum_s x[s][p] (dt[s] exp(a_cs[-1] - a_cs[s]) B[s][n]).
// The x and B rows of s tile 0 are in flight while a_cs is scanned, and
// those of tile st + 1 while tile st is multiplied.
template <int P>
__device__ void chunk_state(const SsdArgs& a, const SsdWork& w, int b, int c,
                            long long c0, int Lc, int hn, unsigned char* smem) {
  constexpr int PP = P < 16 ? 16 : P;   // rows of p, padded to an m16 tile
  constexpr int xp = PP + 8;            // pitches (in bf16) that keep the
  constexpr int wp = kNB + 8;           // ldmatrix rows off each other's banks
  constexpr int kMT = PP / 16;
  constexpr int kMW = (kMT + kWarps - 1) / kWarps;  // m tiles per warp
  const int h = hn / w.nnb, nb = hn - h * w.nnb;
  const int n0 = nb * kNB, nw = min(kNB, w.npad - n0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  bf16* Xs = reinterpret_cast<bf16*>(smem);   // 2 x (kT, xp)  x of s tiles
  bf16* Bs = Xs + 2 * kT * xp;                 // 2 x (kT, wp)  B of s tiles
  bf16* Wh = Bs + 2 * kT * wp;                 // (kT, wp)  W = dt decay B,
  bf16* Wl = Wh + kT * wp;                     //           hi and lo
  float* acs = reinterpret_cast<float*>(Wl + kT * wp);  // (chunk)
  float* fac = acs + a.chunk;                            // (chunk)
  double* part = reinterpret_cast<double*>(fac + a.chunk);  // (kWarps)

  const bf16* x = static_cast<const bf16*>(a.x) + b * a.x_sb + h * a.x_sh + c0 * a.x_ss;
  const bf16* Bm = static_cast<const bf16*>(a.Bm) + b * a.b_sb + c0 * a.b_ss + n0;
  auto load_tile = [&](int st) {
    const int s0 = st * kT, buf = st & 1;
    tile_to_smem(Xs + buf * kT * xp, xp, x + s0 * a.x_ss, a.x_ss, Lc - s0, P, PP, w.x_vec);
    tile_to_smem(Bs + buf * kT * wp, wp, Bm + s0 * a.b_ss, a.b_ss, Lc - s0, a.N - n0, nw,
                 w.bc_vec);
    cp_async_commit();
  };
  load_tile(0);

  const float A = a.A[h];
  const float* dt = a.dt + b * a.dt_sb + h * a.dt_sh + c0 * a.dt_ss;
  for (int s = tid; s < Lc; s += kTC) {
    const float d = dt[s * a.dt_ss];
    fac[s] = d;
    acs[s] = __fmul_rn(d, A);
  }
  __syncthreads();
  // a_cs: an inclusive fp64 scan. Each thread sums a contiguous run, the
  // runs are scanned across the warp with shuffles and across the warps in
  // shared memory, and each element is rounded to fp32 once.
  const int per = (Lc + kTC - 1) / kTC;
  const int beg = min(Lc, tid * per), end = min(Lc, beg + per);
  double run = 0.0;
  for (int s = beg; s < end; ++s) run += static_cast<double>(acs[s]);
  double inc = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(kFullMask, inc, o);
    if (lane >= o) inc += v;
  }
  double off = __shfl_up_sync(kFullMask, inc, 1);
  if (lane == 0) off = 0.0;
  if (lane == 31) part[warp] = inc;
  __syncthreads();
  double base = 0.0;
  for (int k = 0; k < warp; ++k) base += part[k];
  off += base;
  for (int s = beg; s < end; ++s) {
    off += static_cast<double>(acs[s]);
    acs[s] = static_cast<float>(off);
  }
  __syncthreads();
  const long long row = (static_cast<long long>(b) * w.nc + c) * a.H + h;
  const float alast = acs[Lc - 1];
  for (int s = tid; s < Lc; s += kTC) {
    if (nb == 0) w.acs[row * a.chunk + s] = acs[s];
    fac[s] = __fmul_rn(fac[s], expf(alast - acs[s]));
  }

  const int ntiles = (Lc + kT - 1) / kT;
  float acc[kMW][8][4] = {};
  for (int st = 0; st < ntiles; ++st) {
    if (st + 1 < ntiles) {
      load_tile(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile st is in; fac is written; W is free
    const bf16* X = Xs + (st & 1) * kT * xp;
    const bf16* Bt = Bs + (st & 1) * kT * wp;
    const int n = 2 * lane;     // lane's column pair, rows warp, warp + 4, ...
    if (n < nw) {
      constexpr int kR = kT / kWarps;
      float2 bv[kR];
      float f[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) {   // all loads first, then the math
        const int r = warp + i * kWarps, s = st * kT + r;
        bv[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Bt + r * wp + n));
        f[i] = s < Lc ? fac[s] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int r = warp + i * kWarps;
        uint32_t hi, lo;
        split_bf16x2(__fmul_rn(f[i], bv[i].x), __fmul_rn(f[i], bv[i].y), hi, lo);
        *reinterpret_cast<uint32_t*>(Wh + r * wp + n) = hi;
        *reinterpret_cast<uint32_t*>(Wl + r * wp + n) = lo;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < kT; k0 += 16) {
#pragma unroll
      for (int mi = 0; mi < kMW; ++mi) {
        const int mt = warp + mi * kWarps;
        if (mt >= kMT) break;
        uint32_t af[4];   // A = x^T: rows p, depth s
        ldsm_x4_t(af, smem_addr(X + (k0 + (lane & 7) + (lane >> 4) * 8) * xp + mt * 16 +
                                ((lane >> 3) & 1) * 8));
        uint32_t bh[4][4], bl[4][4];   // fragments first, then the products
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (jp * 16 >= nw) break;
          const int roff = (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * wp + jp * 16 +
                           (lane >> 4) * 8;
          ldsm_x4_t(bh[jp], smem_addr(Wh + roff));
          ldsm_x4_t(bl[jp], smem_addr(Wl + roff));
        }
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (jp * 16 >= nw) break;
          mma_bf16_16816(acc[mi][2 * jp], af, bh[jp][0], bh[jp][1]);
          mma_bf16_16816(acc[mi][2 * jp + 1], af, bh[jp][2], bh[jp][3]);
        }
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (jp * 16 >= nw) break;
          mma_bf16_16816(acc[mi][2 * jp], af, bl[jp][0], bl[jp][1]);
          mma_bf16_16816(acc[mi][2 * jp + 1], af, bl[jp][2], bl[jp][3]);
        }
      }
    }
    __syncthreads();  // X, Bt and W are consumed before they are refilled
  }

  float* out = w.st + row * P * a.N;
  const int g = lane >> 2, col = 2 * (lane & 3);
#pragma unroll
  for (int mi = 0; mi < kMW; ++mi) {
    const int mt = warp + mi * kWarps;
    if (mt >= kMT) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = mt * 16 + g + (q >> 1) * 8;
        const int n = n0 + j * 8 + col + (q & 1);
        if (p < P && n < a.N) out[p * a.N + n] = acc[mi][j][q];
      }
    }
  }
}

template <int P>
__global__ void __launch_bounds__(kTC) ssd_chunk_kernel(SsdArgs a, SsdWork w) {
  extern __shared__ __align__(16) unsigned char chunk_smem[];
  const int c = blockIdx.x, b = blockIdx.z;
  const long long c0 = static_cast<long long>(c) * a.chunk;
  const int Lc = static_cast<int>(min(static_cast<long long>(a.chunk), a.S - c0));
  if (static_cast<int>(blockIdx.y) < w.ntri) {
    cb_tile(a, w, b, c, c0, Lc, blockIdx.y, chunk_smem);
  } else {
    chunk_state<P>(a, w, b, c, c0, Lc, blockIdx.y - w.ntri, chunk_smem);
  }
}

// Pass B: one thread per four state elements (p, n..n+3) of one (row,
// head) walks the chunks in order: st[c] <- cur, cur <- cur exp(a_cs[c][-1])
// + S_c. P is a multiple of 8, so P * N is a multiple of 4.
__global__ void __launch_bounds__(kStateThreads) ssd_state_kernel(SsdArgs a, SsdWork w,
                                                                  int P) {
  const int PN4 = P * a.N / 4;
  const int e = blockIdx.x * kStateThreads + threadIdx.x;
  if (e >= PN4) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * a.H + h;
  float4 cur = a.init ? reinterpret_cast<const float4*>(a.init)[bh * PN4 + e]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < w.nc; ++c) {
    const long long row = (static_cast<long long>(b) * w.nc + c) * a.H + h;
    const int Lc = static_cast<int>(
        min(static_cast<long long>(a.chunk), a.S - static_cast<long long>(c) * a.chunk));
    const float d = expf(w.acs[row * a.chunk + Lc - 1]);
    float4* sp = reinterpret_cast<float4*>(w.st) + row * PN4 + e;
    const float4 sc = *sp;
    *sp = cur;
    cur = make_float4(__fadd_rn(__fmul_rn(cur.x, d), sc.x), __fadd_rn(__fmul_rn(cur.y, d), sc.y),
                      __fadd_rn(__fmul_rn(cur.z, d), sc.z), __fadd_rn(__fmul_rn(cur.w, d), sc.w));
  }
  if (a.final_state) reinterpret_cast<float4*>(a.final_state)[bh * PN4 + e] = cur;
}

// Pass C: y rows [64 lt, +64) of chunk c for one (head, row).
template <int P>
__global__ void __launch_bounds__(kTC) ssd_out_kernel(SsdArgs a, SsdWork w) {
  constexpr int PP = P < 16 ? 16 : P;
  constexpr int xp = PP + 8;
  constexpr int kNT = PP / 8;           // n8 tiles of y's columns
  extern __shared__ __align__(16) unsigned char out_smem[];
  // grid (B H chunks, l tiles), the last l tile (the most s tiles) first,
  // so the longest CTAs start in the first wave
  const int bh = blockIdx.x / w.nc, c = blockIdx.x - bh * w.nc;
  const int h = bh % a.H, b = bh / a.H, lt = w.nlt - 1 - blockIdx.y;
  const long long c0 = static_cast<long long>(c) * a.chunk;
  const int Lc = static_cast<int>(min(static_cast<long long>(a.chunk), a.S - c0));
  const int l0 = lt * kT;
  if (l0 >= Lc) return;
  const int lend = min(Lc, l0 + kT);    // positions [0, lend) are read
  const int cp = w.npad + 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  bf16* Cs = reinterpret_cast<bf16*>(out_smem);  // (kT, cp)  C of the l tile
  bf16* Ph = Cs + kT * cp;                        // (PP, cp)  prev, hi
  bf16* Pl = Ph + PP * cp;                        // (PP, cp)  prev, lo
  bf16* Xs = Pl + PP * cp;                        // 2 x (kT, xp)  x tiles
  float* acs = reinterpret_cast<float*>(Xs + 2 * kT * xp);  // (nlt kT)
  float* dts = acs + w.nlt * kT;                             // (nlt kT)

  const bf16* x = static_cast<const bf16*>(a.x) + b * a.x_sb + h * a.x_sh + c0 * a.x_ss;
  tile_to_smem(Cs, cp, static_cast<const bf16*>(a.Cm) + b * a.c_sb + (c0 + l0) * a.c_ss,
               a.c_ss, Lc - l0, a.N, w.npad, w.bc_vec);
  tile_to_smem(Xs, xp, x, a.x_ss, Lc, P, PP, w.x_vec);
  cp_async_commit();
  // this thread's 16 C B^T values of an s tile: rows ra, rb of the tile,
  // columns 16 kk + 2t (+1, +8, +9); tile st + 1's are loaded while tile
  // st is used, tile 0's now
  const int g = lane >> 2, t = lane & 3;
  const int ra = (warp * 16 + g) * kT, rb = ra + 8 * kT;
  const float* cbc = w.cb + ((static_cast<long long>(b) * w.nc + c) * w.ntri +
                             lt * (lt + 1) / 2) * kT * kT;
  float2 q[4][4];
  auto load_cb = [&](int st) {
    const float* cbt = cbc + st * kT * kT;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int sc = kk * 16 + 2 * t;
      q[kk][0] = __ldg(reinterpret_cast<const float2*>(cbt + ra + sc));
      q[kk][1] = __ldg(reinterpret_cast<const float2*>(cbt + rb + sc));
      q[kk][2] = __ldg(reinterpret_cast<const float2*>(cbt + ra + sc + 8));
      q[kk][3] = __ldg(reinterpret_cast<const float2*>(cbt + rb + sc + 8));
    }
  };
  load_cb(0);
  const long long row = (static_cast<long long>(b) * w.nc + c) * a.H + h;
  const float* dt = a.dt + b * a.dt_sb + h * a.dt_sh + c0 * a.dt_ss;
  for (int s = tid; s < lend; s += kTC) {
    acs[s] = w.acs[row * a.chunk + s];
    dts[s] = dt[s * a.dt_ss];
  }
  // the state entering the chunk, as bf16 hi + lo, zero past P and N; the
  // loads go out eight pairs at a time, so their latencies overlap
  const float* prev = w.st + row * P * a.N;
  const int hn = w.npad >> 1, pairs = PP * hn;
  for (int e0 = 0; e0 < pairs; e0 += 8 * kTC) {
    float v[8][2];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = e0 + k * kTC + tid;
      const int p = e / hn, n = (e - p * hn) * 2;
      const bool in = e < pairs && p < P;
      v[k][0] = in && n < a.N ? prev[p * a.N + n] : 0.f;
      v[k][1] = in && n + 1 < a.N ? prev[p * a.N + n + 1] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = e0 + k * kTC + tid;
      if (e >= pairs) break;
      const int p = e / hn, n = (e - p * hn) * 2;
      uint32_t hi, lo;
      split_bf16x2(v[k][0], v[k][1], hi, lo);
      *reinterpret_cast<uint32_t*>(Ph + p * cp + n) = hi;
      *reinterpret_cast<uint32_t*>(Pl + p * cp + n) = lo;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // Below the diagonal (s < l0 <= l) the decay factors through row l0:
  // exp(a_cs[l] - a_cs[s]) = exp(a_cs[l] - a_cs[l0]) exp(a_cs[l0] - a_cs[s]),
  // both factors <= 1 (a_cs falls), so G' = u[l] (C B^T)[l][s] v[s] with
  // v[s] = exp(a_cs[l0] - a_cs[s]) dt[s], kept in dts[s] for s < l0.
  for (int s = tid; s < l0; s += kTC) dts[s] = __fmul_rn(__expf(acs[l0] - acs[s]), dts[s]);
  __syncthreads();

  const int la = l0 + warp * 16 + g, lb = la + 8;   // this thread's rows
  // y_off = (C prev^T) exp(a_cs[l])
  float acc[kNT][4] = {};
  for (int k0 = 0; k0 < w.npad; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, smem_addr(Cs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * cp + k0 +
                          (lane >> 4) * 8));
#pragma unroll
    for (int j0 = 0; j0 < kNT; j0 += 8) {   // up to 4 column pairs at a time:
      uint32_t bh[4][4], bl[4][4];          // fragments first, then products
#pragma unroll
      for (int jp = 0; jp < 4 && j0 + 2 * jp < kNT; ++jp) {
        const int roff = ((j0 + 2 * jp) * 8 + (lane & 7) + (lane >> 4) * 8) * cp + k0 +
                         ((lane >> 3) & 1) * 8;
        ldsm_x4(bh[jp], smem_addr(Ph + roff));
        ldsm_x4(bl[jp], smem_addr(Pl + roff));
      }
#pragma unroll
      for (int jp = 0; jp < 4 && j0 + 2 * jp < kNT; ++jp) {
        mma_bf16_16816(acc[j0 + 2 * jp], af, bh[jp][0], bh[jp][1]);
        mma_bf16_16816(acc[j0 + 2 * jp + 1], af, bh[jp][2], bh[jp][3]);
      }
#pragma unroll
      for (int jp = 0; jp < 4 && j0 + 2 * jp < kNT; ++jp) {
        mma_bf16_16816(acc[j0 + 2 * jp], af, bl[jp][0], bl[jp][1]);
        mma_bf16_16816(acc[j0 + 2 * jp + 1], af, bl[jp][2], bl[jp][3]);
      }
    }
  }
  const bool a_on = la < lend, b_on = lb < lend;
  const float acs_a = a_on ? acs[la] : 0.f, acs_b = b_on ? acs[lb] : 0.f;
  const float ea = a_on ? expf(acs_a) : 0.f;
  const float eb = b_on ? expf(acs_b) : 0.f;
  const float ua = a_on ? __expf(acs_a - acs[l0]) : 0.f;
  const float ub = b_on ? __expf(acs_b - acs[l0]) : 0.f;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    acc[j][0] = __fmul_rn(acc[j][0], ea);
    acc[j][1] = __fmul_rn(acc[j][1], ea);
    acc[j][2] = __fmul_rn(acc[j][2], eb);
    acc[j][3] = __fmul_rn(acc[j][3], eb);
  }

  // y_diag = sum over s tiles <= lt of G' x, G' = (C B^T) o L o dt as hi + lo
  for (int st = 0; st <= lt; ++st) {
    if (st < lt) {      // the next x tile streams in while this one is used
      const int s1 = (st + 1) * kT;
      tile_to_smem(Xs + ((st + 1) & 1) * kT * xp, xp, x + s1 * a.x_ss, a.x_ss, Lc - s1, P,
                   PP, w.x_vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* X = Xs + (st & 1) * kT * xp;
    const bool diag = st == lt;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (diag && kk > warp) break;  // s > l on all of this warp's rows
      uint32_t bx[kNT / 2][4];   // x fragments, loaded while G' is built
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        ldsm_x4_t(bx[jp], smem_addr(X + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * xp +
                                    jp * 16 + (lane >> 4) * 8));
      }
      // the chunk positions of this thread's columns: s, s+1, s+8, s+9
      const int s = st * kT + kk * 16 + 2 * t;
      const float acs_s[4] = {acs[s], acs[s + 1], acs[s + 8], acs[s + 9]};
      const float dt_s[4] = {dts[s], dts[s + 1], dts[s + 8], dts[s + 9]};
      // G' = (C B^T) exp(a_cs[l] - a_cs[s]) dt[s], 0 above the diagonal
      // (masked before exp) and on rows past the chunk; below the diagonal
      // tile, u[l] (C B^T) v[s]. __expf: its error, about |arg| 2^-24
      // relative, is far below the hi + lo split's 2^-16 where the weight
      // is not negligible.
      auto gv = [&](float v, bool row_on, float acs_l, float u, int l, int k) {
        if (!diag) return __fmul_rn(__fmul_rn(v, dt_s[k]), u);
        const bool on = row_on && s + (k & 1) + (k >> 1) * 8 <= l;
        return on ? __fmul_rn(__fmul_rn(v, __expf(acs_l - acs_s[k])), dt_s[k]) : 0.f;
      };
      uint32_t ah[4], al[4];
      split_bf16x2(gv(q[kk][0].x, a_on, acs_a, ua, la, 0),
                   gv(q[kk][0].y, a_on, acs_a, ua, la, 1), ah[0], al[0]);
      split_bf16x2(gv(q[kk][1].x, b_on, acs_b, ub, lb, 0),
                   gv(q[kk][1].y, b_on, acs_b, ub, lb, 1), ah[1], al[1]);
      split_bf16x2(gv(q[kk][2].x, a_on, acs_a, ua, la, 2),
                   gv(q[kk][2].y, a_on, acs_a, ua, la, 3), ah[2], al[2]);
      split_bf16x2(gv(q[kk][3].x, b_on, acs_b, ub, lb, 2),
                   gv(q[kk][3].y, b_on, acs_b, ub, lb, 3), ah[3], al[3]);
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        mma_bf16_16816(acc[2 * jp], ah, bx[jp][0], bx[jp][1]);
        mma_bf16_16816(acc[2 * jp + 1], ah, bx[jp][2], bx[jp][3]);
      }
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        mma_bf16_16816(acc[2 * jp], al, bx[jp][0], bx[jp][1]);
        mma_bf16_16816(acc[2 * jp + 1], al, bx[jp][2], bx[jp][3]);
      }
    }
    if (st < lt) load_cb(st + 1);
    __syncthreads();    // this x buffer is consumed before it is refilled
  }

  bf16* y = static_cast<bf16*>(a.y) + b * a.y_sb + h * a.y_sh;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int p = j * 8 + 2 * t;
    if (p >= P) continue;
    if (la < lend) {
      *reinterpret_cast<__nv_bfloat162*>(y + (c0 + la) * a.y_ss + p) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    }
    if (lb < lend) {
      *reinterpret_cast<__nv_bfloat162*>(y + (c0 + lb) * a.y_ss + p) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
    }
  }
}

// Dynamic shared memory of the two tensor-core kernels, in bytes
// (kernels/ssd_scan.py's ScanPlan.smem() is the same sum).
size_t chunk_smem_bytes(int PP, int npad, int chunk) {
  const size_t cb = 2ull * kT * (npad + 8) * 2;
  const size_t state = 4ull * kT * (PP + 8) + 8ull * kT * (kNB + 8) +
                       8ull * chunk + 8ull * kWarps;
  return cb > state ? cb : state;
}
size_t out_smem_bytes(int PP, int npad, int nlt) {
  return 2ull * (kT + 2ull * PP) * (npad + 8) + 4ull * kT * (PP + 8) + 8ull * nlt * kT;
}

template <int P>
int launch_bf16(const SsdArgs& a, const SsdWork& w, int B, cudaStream_t s) {
  constexpr int PP = P < 16 ? 16 : P;
  const size_t smem_a = chunk_smem_bytes(PP, w.npad, a.chunk);
  const size_t smem_c = out_smem_bytes(PP, w.npad, w.nlt);
  if (smem_a > 232448 || smem_c > 232448) return static_cast<int>(cudaErrorInvalidValue);
  if (w.nc > 0) {
    cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<P>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem_a));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(ssd_out_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_c));
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_chunk_kernel<P><<<dim3(w.nc, w.ntri + a.H * w.nnb, B), kTC, smem_a, s>>>(a, w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_state_kernel<<<dim3((P * a.N / 4 + kStateThreads - 1) / kStateThreads, a.H, B),
                     kStateThreads, 0, s>>>(a, w, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || w.nc == 0) return static_cast<int>(err);
  ssd_out_kernel<P><<<dim3(B * a.H * w.nc, w.nlt), kTC, smem_c, s>>>(a, w);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_bf16(int P, const SsdArgs& a, const SsdWork& w, int B, cudaStream_t s) {
  switch (P) {
    case 8: return launch_bf16<8>(a, w, B, s);
    case 16: return launch_bf16<16>(a, w, B, s);
    case 32: return launch_bf16<32>(a, w, B, s);
    case 64: return launch_bf16<64>(a, w, B, s);
    case 128: return launch_bf16<128>(a, w, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// fp32: the first design
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kGStep = kThreads / kT;   // G rows per pass
constexpr int kGRows = kT / kGStep;     // G entries per thread


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

// Strides are in elements. init / final_state may be null. bf16 takes the
// three fp32 workspaces ws_cb, ws_acs, ws_st sized by kernels/ssd_scan.py's
// ScanPlan for this (B, S, H, P, N, chunk); fp32 takes none. For bf16 the
// wrapper passes the chunk as min(chunk, S), which the reference's dt=0
// padding makes the same scan.
extern "C" int hydra_ssd_scan(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* init, void* y, void* final_state,
    void* ws_cb, void* ws_acs, void* ws_st, int B,
    int S, int H, int P, int N, int chunk, long long x_sb, long long x_ss,
    long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long y_sb, long long y_ss, long long y_sh, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S < 0 || N <= 0 || chunk <= 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SsdArgs a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
            Bm, Cm, static_cast<const float*>(init), y,
            static_cast<float*>(final_state), S, H, N, chunk,
            x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss,
            y_sb, y_ss, y_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    const long long smem = smem_bytes(P, N, chunk);
    if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
    return dispatch_p<float>(P, a, B, static_cast<size_t>(smem), s);
  }
  if (dtype != kBF16 || (S > 0 && (!ws_cb || !ws_acs || !ws_st))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SsdWork w;
  w.cb = static_cast<float*>(ws_cb);
  w.acs = static_cast<float*>(ws_acs);
  w.st = static_cast<float*>(ws_st);
  w.nc = (S + chunk - 1) / chunk;
  w.nlt = (chunk + kT - 1) / kT;
  w.ntri = w.nlt * (w.nlt + 1) / 2;
  w.npad = (N + 15) / 16 * 16;
  w.nnb = (w.npad + kNB - 1) / kNB;
  if (w.ntri + static_cast<long long>(H) * w.nnb > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  w.x_vec = aligned(x) && x_sb % 8 == 0 && x_ss % 8 == 0 && x_sh % 8 == 0;
  w.bc_vec = aligned(Bm) && aligned(Cm) && N % 8 == 0 && b_sb % 8 == 0 &&
             b_ss % 8 == 0 && c_sb % 8 == 0 && c_ss % 8 == 0;
  return dispatch_bf16(P, a, w, B, s);
}
