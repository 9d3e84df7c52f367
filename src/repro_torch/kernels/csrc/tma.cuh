// The swizzled shared-memory tile of the attention kernels and the TMA
// tensor maps that fill it, shared by flash_attention.cu (forward) and
// flash_attention_bwd.cu (backward).
//
// A tile (64 rows x hd, bf16) sits in shared memory as hd / (kSw / 2)
// panels of 64 rows x kSw bytes, swizzled over kSw bytes: the widest of
// 128, 64 and 32 that divides a row (hd 80's 160-byte rows take 32). One
// layout serves as a K-major wgmma operand (rows x hd, for Q K^T) and as an
// MN-major one (hd as N, for P V), so no transposed copy is ever made.
#pragma once

#include <cstdint>

#include <cuda.h>  // CUtensorMap (types only: libcuda is not linked)

#include "common.cuh"

namespace hydra {

constexpr int kTile = 64;              // query rows and keys per tile
constexpr int kSmemMax = 232448;       // a block's shared memory on the H100

template <int HD>
struct SwTile {
  static constexpr int HDP = HD < 16 ? 16 : HD;  // depth padded to k16
  static constexpr int kSw = (2 * HDP) % 128 == 0 ? 128 : (2 * HDP) % 64 == 0 ? 64 : 32;
  static constexpr int kLayout = kSw == 128 ? 1 : kSw == 64 ? 2 : 3;  // wgmma
  static constexpr int kPanelElems = kSw / 2;
  static constexpr int kPanels = HDP / kPanelElems;
  static constexpr int kPanelBytes = kTile * kSw;
  static constexpr int kBytes = kPanels * kPanelBytes;     // one tile
  static_assert(HDP % 16 == 0, "head dim must pad to a multiple of 16");
  // byte offset of k-step kk (16 elements of hd) in a K-major tile
  __host__ __device__ static constexpr int kstep(int kk) {
    return (kk * 16 / kPanelElems) * kPanelBytes + (kk * 16 % kPanelElems) * 2;
  }
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time with
// cudaGetDriverEntryPoint(ByVersion), so the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// A (B, S, H, hd) bf16 tensor as 5-D (column in a panel, s, panel, h, b),
// box (kSw / 2, 64, panels, 1, 1), kSw-byte swizzle: one load (or store)
// moves a 64-row tile as its panels of 64 rows x kSw bytes. TMA fills
// zeros past S and past hd on a load and skips them on a store.
template <int HD>
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
              const Strides& st) {
  using Tl = SwTile<HD>;
  constexpr int pe = Tl::kPanelElems;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(HD < pe ? HD : pe),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(Tl::kPanels),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(st.s) * 2, Tl::kSw,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[5] = {pe, kTile, Tl::kPanels, 1, 1};
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             Tl::kSw == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
             : Tl::kSw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool tma_ok(const void* p, const Strides& st) {   // 16-byte base and strides
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.s % 8 == 0 &&
         st.h % 8 == 0 && st.b % 8 == 0;
}

}  // namespace hydra
