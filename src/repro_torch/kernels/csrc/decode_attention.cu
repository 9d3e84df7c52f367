// Flash-decode: one query token per row against a (partially filled) KV
// cache. q (B,Hq,hd); k/v caches (B,S,Hkv,hd) read through their strides;
// lengths (B,) int32 in device memory; out (B,Hq,hd).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention/_kernel). The TPU kernel prefetches the lengths as
// scalars and walks KV blocks in a sequential grid; here the KV axis is
// split across CTAs (split-KV) and a last pass merges the splits.
//
// Bound on the H100: bytes. Each visible K/V row is read once for all
// `group` query heads of its KV head (the GQA reuse), at 2*group flops per
// element, far below the card's flops-per-byte balance. At serving batch
// sizes one CTA per (row, KV head) leaves most SMs idle and walks its keys
// one dependent load after another, so the cache axis is split across
// CTAs: the two passes below run a (splits, Hkv, B) grid, one chunk of
// `chunk` cache rows per CTA. splits = ceil(S / chunk) follows from the
// cache length alone (the wrapper's split_plan), so the host never reads
// `lengths` and nothing syncs. Each CTA reads its row's length on the
// device and intersects its chunk with the visible keys
// [max(0, length - window), min(length, S)); an empty intersection writes
// a neutral partial and exits. Otherwise the whole chunk's K (or V) rows
// are issued at once as 16-byte cp.async copies into shared memory, so the
// chunk pays its memory latency once.
//  - decode_scores_kernel: the group's scores against the chunk in fp32,
//    and the chunk's softmax statistics (m, l), to an fp32 workspace.
//  - decode_pv_kernel: merges every split's (m, l) into the row's max and
//    sum, rounds the chunk's probabilities to q's dtype (the reference's
//    rounding point: it casts the normalised softmax before P V, and
//    over 36 bf16 layers a kernel that kept fp32 probabilities drifted
//    from the plain path by more than the logits check allows), and sums
//    P V in fp32.
//  - decode_combine_kernel, grid (Hq, B): the splits' P V summed, in q's
//    dtype.
// The P V pass's per-head accumulators are sized to the group through a
// template parameter (1, 2, 4, 8 or 16).
//
// Edges reproduced from the reference oracle (repro/kernels/ref.py):
// `length > S` attends all S keys while the window mask uses the unclamped
// length; a row with no visible key (length == 0, or a window past S)
// returns the uniform mean of V over all S rows, which is what a softmax
// over all -1e30 logits gives: such a row splits over all of [0, S) with
// scores 0.
#include "common.cuh"
#include "hopper.cuh"

using namespace hydra;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// The part of split `split`'s chunk that row b can see: [a, a + n). A row
// with no visible key takes all of [0, S) with scores 0 (`uniform`).
struct ChunkView {
  long long a;
  int n;
  bool uniform;
};

__device__ __forceinline__ ChunkView chunk_view(const int* lengths, int b, int S,
                                                int chunk, int split,
                                                long long window) {
  const long long length = lengths[b];
  long long lo = 0;
  long long hi = min(length, static_cast<long long>(S));
  if (window > 0) lo = max(0LL, length - window);
  const bool uniform = lo >= hi;
  if (uniform) {
    lo = 0;
    hi = S;
  }
  const long long c0 = static_cast<long long>(split) * chunk;
  const long long a = max(lo, c0);
  return {a, static_cast<int>(max(0LL, min(hi, c0 + chunk) - a)), uniform};
}

// Pass 1: scores of the chunk's visible keys against the group's heads,
// and the chunk's softmax statistics (m = max score, l = sum exp(s - m)).
// One thread per (head, key) takes the whole dot product: K rows sit in
// shared memory 16 bytes apart from a row's end, so the 16-byte loads of
// neighbouring keys fall in different banks; q*scale is broadcast.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const int* __restrict__ lengths, float* __restrict__ ws_s,
                     float* __restrict__ ws_m, float* __restrict__ ws_l, int S,
                     int Hq, int group, int chunk, int splits, long long q_sb,
                     long long q_sh, Strides ks, float scale, long long window) {
  constexpr int kVec = 16 / sizeof(T);        // elements per 16-byte copy
  constexpr int kPieces = HD / kVec;          // 16-byte copies per row
  constexpr int kPitch = HD + kVec;           // padded K row, in elements
  extern __shared__ __align__(16) unsigned char scores_smem[];
  T* Ks = reinterpret_cast<T*>(scores_smem);
  float* Qs = reinterpret_cast<float*>(Ks + chunk * kPitch);  // (group, HD)
  float* Ss = Qs + group * HD;                                  // (group, chunk)

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const ChunkView cv = chunk_view(lengths, b, S, chunk, split, window);
  const int n = cv.n;
  // statistics of (head h, split) at (b * Hq + h) * splits + split; the
  // scores of (head h, key j) at (b * Hq + h) * splits * chunk + j
  const long long head0 = static_cast<long long>(b) * Hq + hk * group;

  if (n == 0) {
    if (tid < group) {
      ws_m[(head0 + tid) * splits + split] = kNegInf;
      ws_l[(head0 + tid) * splits + split] = 0.f;
    }
    return;
  }
  float* sc = ws_s + head0 * splits * chunk + cv.a;   // row of head 0
  const long long s_stride = static_cast<long long>(splits) * chunk;
  if (cv.uniform) {                                   // every score is 0
    for (int e = tid; e < group * n; e += kThreads) {
      sc[(e / n) * s_stride + e % n] = 0.f;
    }
    if (tid < group) {
      ws_m[(head0 + tid) * splits + split] = 0.f;
      ws_l[(head0 + tid) * splits + split] = static_cast<float>(n);
    }
    return;
  }

  // the chunk's K rows, all in flight at once
  const T* kb = k + b * ks.b + hk * ks.h + cv.a * ks.s;
  for (int i = tid; i < n * kPieces; i += kThreads) {
    const int r = i / kPieces, c = (i % kPieces) * kVec;
    cp_async16(Ks + r * kPitch + c, kb + r * ks.s + c);
  }
  // q * scale rounded to q's dtype, while the copies fly
  const float qsc = round_to<T>(scale);
  for (int e = tid; e < group * HD; e += kThreads) {
    const int h = hk * group + e / HD;
    Qs[e] = round_to<T>(to_f(q[b * q_sb + h * q_sh + e % HD]) * qsc);
  }
  cp_async_wait_all();
  __syncthreads();

  for (int e = tid; e < group * n; e += kThreads) {
    const int g = e / n, j = e % n;
    const T* kr = Ks + j * kPitch;
    const float* qg = Qs + g * HD;
    float s = 0.f;
#pragma unroll 4
    for (int d0 = 0; d0 < HD; d0 += kVec) {
      float kd[kVec];
      Vec16<T>::load(kr + d0, kd);
#pragma unroll
      for (int u = 0; u < kVec; ++u) s = fmaf(qg[d0 + u], kd[u], s);
    }
    Ss[g * chunk + j] = s;
  }
  __syncthreads();

  for (int g = warp; g < group; g += kWarps) {
    const float* row = Ss + g * chunk;
    float mx = kNegInf;
    for (int j = lane; j < n; j += 32) {
      mx = fmaxf(mx, row[j]);
      sc[g * s_stride + j] = row[j];
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) sum += expf(row[j] - mx);
    sum = warp_sum(sum);
    if (lane == 0) {
      ws_m[(head0 + g) * splits + split] = mx;
      ws_l[(head0 + g) * splits + split] = sum;
    }
  }
}

// Pass 2: the softmax probabilities of the chunk's keys, normalised by the
// row's global max and sum (merged from every split's statistics) and
// rounded to q's dtype as the reference rounds them, times V, in fp32.
// A thread owns one column of V (two for hd 256) for every head of the
// group, so each V element is read from shared memory once; G >= group
// sizes its accumulators.
template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
decode_pv_kernel(const T* __restrict__ v, const int* __restrict__ lengths,
                 const float* __restrict__ ws_s, const float* __restrict__ ws_m,
                 const float* __restrict__ ws_l, float* __restrict__ ws_acc,
                 int S, int Hq, int group, int chunk, int splits, Strides vs,
                 long long window) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPieces = HD / kVec;
  extern __shared__ __align__(16) unsigned char pv_smem[];
  T* Vs = reinterpret_cast<T*>(pv_smem);
  float* Ps = reinterpret_cast<float*>(Vs + chunk * HD);   // (group, chunk)

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const ChunkView cv = chunk_view(lengths, b, S, chunk, split, window);
  const int n = cv.n;
  const long long head0 = static_cast<long long>(b) * Hq + hk * group;

  if (n == 0) {
    for (int e = tid; e < group * HD; e += kThreads) {
      ws_acc[((head0 + e / HD) * splits + split) * HD + e % HD] = 0.f;
    }
    return;
  }
  const T* vb = v + b * vs.b + hk * vs.h + cv.a * vs.s;
  for (int i = tid; i < n * kPieces; i += kThreads) {
    const int r = i / kPieces, c = (i % kPieces) * kVec;
    cp_async16(Vs + r * HD + c, vb + r * vs.s + c);
  }

  // per head: the row's max M and sum L over all splits, then
  // p = round(exp(s - M) / L) for this chunk's keys
  const long long s_stride = static_cast<long long>(splits) * chunk;
  for (int g = warp; g < group; g += kWarps) {
    const float* m = ws_m + (head0 + g) * splits;
    const float* l = ws_l + (head0 + g) * splits;
    float mx = kNegInf;
    for (int i = lane; i < splits; i += 32) mx = fmaxf(mx, m[i]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < splits; i += 32) sum = fmaf(l[i], expf(m[i] - mx), sum);
    const float inv = 1.0f / warp_sum(sum);
    const float* row = ws_s + (head0 + g) * s_stride + cv.a;
    for (int j = lane; j < n; j += 32) {
      Ps[g * chunk + j] = round_to<T>(expf(row[j] - mx) * inv);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  for (int d = tid; d < HD; d += kThreads) {
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const float vd = to_f(Vs[j * HD + d]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g < group) acc[g] = fmaf(Ps[g * chunk + j], vd, acc[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < group) ws_acc[((head0 + g) * splits + split) * HD + d] = acc[g];
    }
  }
}

// Pass 3: the splits' P V summed, in q's dtype.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ ws_acc, T* __restrict__ o,
                      int Hq, int hd, int splits, long long o_sb,
                      long long o_sh) {
  const int h = blockIdx.x, b = blockIdx.y;
  const float* acc = ws_acc + (static_cast<long long>(b) * Hq + h) * splits * hd;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float sum = 0.f;
#pragma unroll 8
    for (int i = 0; i < splits; ++i) sum += acc[i * hd + d];
    o[b * o_sb + h * o_sh + d] = from_f<T>(sum);
  }
}

struct DecodeArgs {
  const void *q, *k, *v;
  const int* lengths;
  float *ws_s, *ws_m, *ws_l, *ws_acc;
  void* o;
  int B, S, Hq, Hkv, group, chunk, splits;
  long long q_sb, q_sh, o_sb, o_sh;
  Strides ks, vs;
  float scale;
  long long window;
};

// Opts a kernel into more than 48 KB of dynamic shared memory, once per
// size it has not been granted yet.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int& granted) {
  if (bytes <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) granted = bytes;
  return err;
}

template <typename T, int HD, int G>
int launch(const DecodeArgs& a, cudaStream_t stream) {
  static int granted_scores = 48 * 1024, granted_pv = 48 * 1024;
  // each pass holds one chunk of K (padded rows) or V rows, and (group,
  // chunk) floats; the first also q*scale
  const int esize = static_cast<int>(sizeof(T));
  const int smem_scores = a.chunk * (HD + 16 / esize) * esize + a.group * HD * 4 +
                          a.group * a.chunk * 4;
  const int smem = a.chunk * HD * esize + a.group * a.chunk * 4;
  cudaError_t err = allow_smem(decode_scores_kernel<T, HD>, smem_scores, granted_scores);
  if (err == cudaSuccess) err = allow_smem(decode_pv_kernel<T, HD, G>, smem, granted_pv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.splits, a.Hkv, a.B);
  decode_scores_kernel<T, HD><<<grid, kThreads, smem_scores, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), a.lengths,
      a.ws_s, a.ws_m, a.ws_l, a.S, a.Hq, a.group, a.chunk, a.splits, a.q_sb,
      a.q_sh, a.ks, a.scale, a.window);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  decode_pv_kernel<T, HD, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.v), a.lengths, a.ws_s, a.ws_m, a.ws_l, a.ws_acc,
      a.S, a.Hq, a.group, a.chunk, a.splits, a.vs, a.window);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int threads = HD >= kThreads ? kThreads : ((HD + 31) / 32) * 32;
  decode_combine_kernel<T><<<dim3(a.Hq, a.B), threads, 0, stream>>>(
      a.ws_acc, static_cast<T*>(a.o), a.Hq, HD, a.splits, a.o_sb, a.o_sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int dispatch_group(const DecodeArgs& a, cudaStream_t s) {
  if (a.group <= 1) return launch<T, HD, 1>(a, s);
  if (a.group <= 2) return launch<T, HD, 2>(a, s);
  if (a.group <= 4) return launch<T, HD, 4>(a, s);
  if (a.group <= 8) return launch<T, HD, 8>(a, s);
  return launch<T, HD, 16>(a, s);
}

template <typename T>
int dispatch_hd(int hd, const DecodeArgs& a, cudaStream_t s) {
  switch (hd) {
    case 8: return dispatch_group<T, 8>(a, s);
    case 16: return dispatch_group<T, 16>(a, s);
    case 32: return dispatch_group<T, 32>(a, s);
    case 64: return dispatch_group<T, 64>(a, s);
    case 80: return dispatch_group<T, 80>(a, s);
    case 128: return dispatch_group<T, 128>(a, s);
    case 224: return dispatch_group<T, 224>(a, s);
    case 256: return dispatch_group<T, 256>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window <= 0 means no window. Strides are in elements. ws is one fp32
// workspace of B * Hq * splits * (chunk + 2 + hd) floats, splits =
// ceil(S / chunk) (kernels/decode_attention.py, split_plan): the scores
// (B, Hq, splits * chunk), then m and l (B, Hq, splits), then P V (B, Hq,
// splits, hd).
extern "C" int hydra_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    void* ws, int B, int S, int Hq, int Hkv, int hd, int chunk, int splits,
    long long q_sb, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh, float scale, long long window, int dtype,
    void* stream) {
  if (B <= 0) return 0;
  if (S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 16 || Hkv > 65535 ||
      B > 65535 || chunk <= 0 || splits != (S + chunk - 1) / chunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long parts = static_cast<long long>(B) * Hq * splits;
  float* w = static_cast<float*>(ws);
  const DecodeArgs a{q, k, v, static_cast<const int*>(lengths),
                     w, w + parts * chunk, w + parts * (chunk + 1),
                     w + parts * (chunk + 2), o, B, S, Hq, Hkv, Hq / Hkv,
                     chunk, splits, q_sb, q_sh, o_sb, o_sh,
                     Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh},
                     scale, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_hd<float>(hd, a, s);
  if (dtype == kBF16) return dispatch_hd<__nv_bfloat16>(hd, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
