// Shared pieces of the paged attention kernels (paged_attention.cu,
// paged_prefill.cu): dtype conversion, warp reductions, the K/V page-tile
// loader and the launch dispatch over (q dtype, page format, head dim).
//
// Layout contract, identical to accelerate_tpu/ops/paged_attention.py:
//   q, out   [N, S, Hq, D]        f32 or bf16, contiguous; D 16, 32, 64 or 128
//   pages    [NP, page, Hkv, D]   f32, bf16, int8 or fp8-e4m3, contiguous (one layer)
//   scales   [NP, Hkv]            f32 dequantization scales (ones for native pages):
//                                 a page's value is its code times its scale
//   tables   [N, P]               int32 block tables, dead slots hold page 0
//   lengths  [N]                  int32, query i of lane n sits at lengths[n] + i
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace atpu {

// DEFAULT_MASK_VALUE of accelerate_tpu/ops/flash_attention.py: a finite mask,
// so a row whose page holds no visible key never produces exp(-inf + inf).
constexpr float kMaskValue = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
// quantized page codes (exact in f32): int8, and fp8-e4m3 (the dequant arm
// of the TPU kernels, accelerate_tpu/ops/paged_attention.py:291 and :511)
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 fma4(float s, float4 v, float4 acc) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
  return acc;
}

// Write VEC consecutive page elements, converted to f32 and multiplied by the
// dequantization scale, to shared memory (dst is 16-byte aligned).
template <typename KT>
__device__ __forceinline__ void store_vec(float* dst, const uint4& raw, float scale) {
  constexpr int VEC = 16 / sizeof(KT);
  const KT* vals = reinterpret_cast<const KT*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; i += 4) {
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(to_f32(vals[i]) * scale, to_f32(vals[i + 1]) * scale,
                    to_f32(vals[i + 2]) * scale, to_f32(vals[i + 3]) * scale);
  }
}

// Load the K and V tiles of one (page, kv-head) into shared memory as f32:
// row r of K at k_s + r * k_stride, row r of V at v_s + r * D.  Every thread
// keeps BATCH 16-byte loads of each tile in flight before it converts and
// stores, so one page costs a few memory round trips, not one per row.
template <typename KT, int D, int NT>
__device__ __forceinline__ void load_kv_tiles(float* k_s, int k_stride, float* v_s,
                                              const KT* __restrict__ gk,
                                              const KT* __restrict__ gv, size_t row_stride,
                                              int page, float k_scale, float v_scale) {
  constexpr int VEC = 16 / sizeof(KT);
  constexpr int VPR = D / VEC;  // 16-byte vectors per row
  constexpr int BATCH = 8;
  const int total = page * VPR;
  for (int e0 = threadIdx.x; e0 < total; e0 += BATCH * NT) {
    uint4 rk[BATCH], rv[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int e = e0 + b * NT;
      if (e < total) {
        const size_t off = (size_t)(e / VPR) * row_stride + (e % VPR) * VEC;
        rk[b] = __ldg(reinterpret_cast<const uint4*>(gk + off));
        rv[b] = __ldg(reinterpret_cast<const uint4*>(gv + off));
      }
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int e = e0 + b * NT;
      if (e < total) {
        const int r = e / VPR, c = (e % VPR) * VEC;
        store_vec<KT>(k_s + r * k_stride + c, rk[b], k_scale);
        store_vec<KT>(v_s + r * D + c, rv[b], v_scale);
      }
    }
  }
}

// Raise the dynamic shared-memory ceiling of `kernel` to `bytes` when the
// launch needs more than the default 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace atpu

// The page formats, by the wrappers' codes (ops/paged_attention.py
// _PAGE_FORMATS): 0 f32, 1 bf16, 2 int8, 3 fp8-e4m3.
#define ATPU_PAGE_CASES(kv_fmt, QT, D, LAUNCH)                                      \
  if (kv_fmt == 0) return LAUNCH(QT, float, D);                                     \
  if (kv_fmt == 1) return LAUNCH(QT, __nv_bfloat16, D);                             \
  if (kv_fmt == 2) return LAUNCH(QT, int8_t, D);                                    \
  if (kv_fmt == 3) return LAUNCH(QT, __nv_fp8_e4m3, D);

#define ATPU_HEAD_DIM_CASE(q_bf16, kv_fmt, d, D, LAUNCH)                            \
  if (d == D) {                                                                     \
    if (q_bf16) {                                                                   \
      ATPU_PAGE_CASES(kv_fmt, __nv_bfloat16, D, LAUNCH)                             \
    } else {                                                                        \
      ATPU_PAGE_CASES(kv_fmt, float, D, LAUNCH)                                     \
    }                                                                               \
    return static_cast<int>(cudaErrorInvalidValue);                                 \
  }

// Expand LAUNCH(QT, KT, D) for the (q dtype, page format, head dim) of a
// call; returns cudaErrorInvalidValue for a combination it does not take.
#define ATPU_DISPATCH(q_bf16, kv_fmt, d, LAUNCH)                                    \
  do {                                                                              \
    ATPU_HEAD_DIM_CASE(q_bf16, kv_fmt, d, 128, LAUNCH)                              \
    ATPU_HEAD_DIM_CASE(q_bf16, kv_fmt, d, 64, LAUNCH)                               \
    ATPU_HEAD_DIM_CASE(q_bf16, kv_fmt, d, 32, LAUNCH)                               \
    ATPU_HEAD_DIM_CASE(q_bf16, kv_fmt, d, 16, LAUNCH)                               \
    return static_cast<int>(cudaErrorInvalidValue);                                 \
  } while (0)
