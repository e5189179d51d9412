// Shared pieces of the dense flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the tile geometry, dtype helpers, the BSHD row loader, the
// CUDA-core tile product and the launch dispatch over (dtype, head dim).
// The CUDA-core pieces serve the f32 arms of K3, K4 and K5; their bf16 arms
// are tensor-core kernels built from flash_wgmma.cuh on the same folded-row
// geometry.
//
// Layout contract, the public layout of accelerate_tpu/ops/flash_attention.py
// (BSHD at the function boundary; the GQA fold happens inside the kernels):
//   q, out, dout    [B, Sq, Hq, D]   f32 or bf16, contiguous
//   k, v            [B, Sk, Hkv, D]  same dtype, contiguous
//   lse, delta      [B, Hq, Sq]      f32 (no lane broadcast on the card)
//   segment ids     [B, seg_stride]  int32 or null; query i has id seg[b, i]
//   kv segment ids  [B, kseg_stride] int32 or null; key j has id kseg[b, j],
//                                    seg[b, j] when null (one tensor for both:
//                                    a ring attention chunk's keys carry ids
//                                    of their own)
//   out_f32                          bf16 inputs only: out, dq, dk and dv are
//                                    written in f32 (a ring attention pair's,
//                                    summed across pairs before one rounding)
//
// Tiles.  A CTA of 256 threads works on a tile of kRows = 64 folded rows and
// kKeys = 64 keys.  Folded row r holds query q0 + r / rep of query head
// h * rep + r % rep: the rep query heads that share kv-head h are stacked
// query-major, so a q-block covers one contiguous query span (its causal
// frontier is the span's last query) and one K/V tile serves every head of
// the group.  A group of more than 64 heads (MQA with many query heads) is
// cut into `parts` equal parts of at most 64 heads; a q-block then holds
// one part, and rep above reads as the heads of a part.  The threads form
// a 16 x 16 grid (ty = tid / 16, tx = tid % 16);
// in a row-by-key product a thread owns rows ty + 16 i and keys tx + 16 j
// (i, j < 4), in a row-by-column product rows ty + 16 i and the float4
// column groups tx + 16 c.  The 16 threads of one ty sit in one half-warp,
// so a row's softmax statistics reduce with four shuffles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace atpu {

// DEFAULT_MASK_VALUE of accelerate_tpu/ops/flash_attention.py:33: a finite
// mask, so a row with no visible key in a tile never computes -inf + inf.
constexpr float kFlashMask = -0.7f * FLT_MAX;

constexpr int kFlashThreads = 256;
constexpr int kRows = 64;   // folded (query, head) rows per tile
constexpr int kKeys = 64;   // keys per tile
constexpr int kPStride = kKeys + 16;  // row stride of a rows x keys tile: the
                                      // two rows a warp writes land on
                                      // different banks

struct FlashShape {
  int sq, sk, hq, hkv;
  int group;  // query heads per kv head
  int parts;  // parts of a group, each of at most kRows heads
  int rep;    // query heads of a part: group / parts
  int block_q, seg_stride, causal;
  const int* kseg;  // the keys' segment ids: the kv tensor, else the queries'
  int kseg_stride;
  int out_f32;      // the tensor-core arms write their outputs in f32, not bf16
};

__device__ __forceinline__ float flash_f32(float x) { return x; }
__device__ __forceinline__ float flash_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T flash_from(float x);
template <> __device__ __forceinline__ float flash_from<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 flash_from<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the kernels' casts of p and ds to the operand
// dtype before a product (flash_attention.py:163, :303, :342, :346)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return flash_f32(flash_from<T>(x));
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 fma4(float s, float4 v, float4 acc) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
  return acc;
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// Folded-row bookkeeping of one q-block (of one part of a GQA group).
struct FoldedRows {
  int q0, rep, rows, sq, hq, head0;
  // query of row r, clamped into the sequence: a ragged last block's spare
  // rows compute like its last query and are never stored
  __device__ __forceinline__ int query(int r) const {
    const int qi = q0 + r / rep;
    return qi < sq ? qi : sq - 1;
  }
  __device__ __forceinline__ bool valid(int r) const { return r < rows && q0 + r / rep < sq; }
  __device__ __forceinline__ int head(int r) const { return head0 + r % rep; }
  // element offset of row r in a [B, Sq, Hq, D] tensor, or -1 (zero fill)
  __device__ __forceinline__ long long offset(int b, int r, int d) const {
    if (!valid(r)) return -1;
    return ((long long)(b * sq + q0 + r / rep) * hq + head(r)) * d;
  }
  // index of row r in a [B, Hq, Sq] statistic
  __device__ __forceinline__ long long stat(int b, int r) const {
    return ((long long)b * hq + head(r)) * sq + query(r);
  }
};

// The rows of q-block qb, part `part` of kv-head h's group.
__device__ __forceinline__ FoldedRows folded_rows(const FlashShape& sh, int qb, int part, int h) {
  return FoldedRows{qb * sh.block_q, sh.rep, sh.block_q * sh.rep, sh.sq, sh.hq,
                    h * sh.group + part * sh.rep};
}

// k-tiles q-block qb of part `part` walks: up to its causal frontier (0 for
// a q-block past the sequence)
__device__ __forceinline__ int q_block_tiles(const FlashShape& sh, int qb, int part, int h) {
  const FoldedRows fr = folded_rows(sh, qb, part, h);
  if (fr.q0 >= sh.sq) return 0;
  const int n_kb = (sh.sk + kKeys - 1) / kKeys;
  return sh.causal ? min(n_kb, (min(fr.q0 + sh.block_q, sh.sq) - 1) / kKeys + 1) : n_kb;
}

// element offset of key j of kv-head h in a [B, Sk, Hkv, D] tensor, or -1
// (zero fill) past the sequence
__device__ __forceinline__ long long kv_offset(int b, int j, int h, const FlashShape& sh, int d) {
  return j < sh.sk ? ((long long)(b * sh.sk + j) * sh.hkv + h) * d : -1;
}

// Copy `nrows` rows of D elements into a f32 shared tile with row stride
// `stride`; row r comes from src + row_offset(r) (an element offset), or is
// zero-filled where row_offset returns -1.  16-byte loads; every thread
// keeps up to four of them in flight before it converts and stores.
template <typename T, int D, typename RowOffset>
__device__ __forceinline__ void load_rows(float* dst, int stride, const T* __restrict__ src,
                                          int nrows, RowOffset row_offset) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;  // 16-byte vectors per row
  constexpr int BATCH = 4;
  const int total = nrows * VPR;
  for (int e0 = threadIdx.x; e0 < total; e0 += BATCH * kFlashThreads) {
    uint4 raw[BATCH];
    bool live[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = e0 + u * kFlashThreads;
      live[u] = false;
      if (e < total) {
        const long long off = row_offset(e / VPR);
        if (off >= 0) {
          raw[u] = __ldg(reinterpret_cast<const uint4*>(src + off + (e % VPR) * VEC));
          live[u] = true;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = e0 + u * kFlashThreads;
      if (e < total) {
        float* d = dst + (e / VPR) * stride + (e % VPR) * VEC;
        const T* vals = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
        for (int i = 0; i < VEC; i += 4) {
          *reinterpret_cast<float4*>(d + i) =
              live[u] ? make_float4(flash_f32(vals[i]), flash_f32(vals[i + 1]),
                                    flash_f32(vals[i + 2]), flash_f32(vals[i + 3]))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
  }
}

// s[i][j] += <a row ty + 16 i, b row tx + 16 j> over N columns; a and b
// are f32 shared tiles with row strides SA and SB, each 4 more than a
// multiple of 32 (16-byte reads of 16 different b rows then fall on
// distinct banks, two wavefronts per warp).
template <int N, int SA, int SB>
__device__ __forceinline__ void tile_dot_cols(float (&s)[4][4], const float* a, const float* b,
                                              int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < N; c += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * SA + c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * SB + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc = s[i][j];
        acc = fmaf(av[i].x, bv[j].x, acc);
        acc = fmaf(av[i].y, bv[j].y, acc);
        acc = fmaf(av[i].z, bv[j].z, acc);
        acc = fmaf(av[i].w, bv[j].w, acc);
        s[i][j] = acc;
      }
  }
}

// tile_dot_cols over all D columns of two tiles of row stride D + 4.
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a, const float* b,
                                         int ty, int tx) {
  tile_dot_cols<D, D + 4, D + 4>(s, a, b, ty, tx);
}

// Raise the dynamic shared-memory ceiling of `kernel` to `bytes`.
template <typename K>
cudaError_t flash_allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Host-side geometry shared by the three launches.
inline FlashShape flash_shape(int sq, int sk, int hq, int hkv, int seg_stride, int causal,
                              const int* seg, const int* kseg, int kseg_stride) {
  FlashShape sh;
  sh.sq = sq;
  sh.sk = sk;
  sh.hq = hq;
  sh.hkv = hkv;
  sh.group = hq / hkv;
  sh.parts = 1;
  while (sh.group / sh.parts > kRows || sh.group % sh.parts) ++sh.parts;
  sh.rep = sh.group / sh.parts;
  sh.block_q = kRows / sh.rep;
  if (sh.block_q > sq) sh.block_q = sq;
  sh.seg_stride = seg_stride;
  sh.causal = causal;
  sh.kseg = kseg ? kseg : seg;
  sh.kseg_stride = kseg ? kseg_stride : seg_stride;
  sh.out_f32 = 0;
  return sh;
}

inline bool flash_shape_ok(int b, int sq, int sk, int hq, int hkv) {
  return b > 0 && sq > 0 && sk > 0 && hkv > 0 && hq % hkv == 0;
}

}  // namespace atpu

// Expand LAUNCH(T, D) for the (dtype, head dim) of a call; returns
// cudaErrorInvalidValue for a combination the kernels do not take.  Each
// launcher picks its arm from T: bf16 K3, K4 and K5 launch their tensor-core
// kernels, everything else the CUDA-core ones.
#define ATPU_FLASH_HEAD_DIM(bf16, d, D, LAUNCH) \
  if (d == D) return bf16 ? LAUNCH(__nv_bfloat16, D) : LAUNCH(float, D);
#define ATPU_FLASH_DISPATCH(bf16, d, LAUNCH)                            \
  do {                                                                  \
    ATPU_FLASH_HEAD_DIM(bf16, d, 128, LAUNCH)                           \
    ATPU_FLASH_HEAD_DIM(bf16, d, 64, LAUNCH)                            \
    ATPU_FLASH_HEAD_DIM(bf16, d, 256, LAUNCH)                           \
    ATPU_FLASH_HEAD_DIM(bf16, d, 96, LAUNCH)                            \
    ATPU_FLASH_HEAD_DIM(bf16, d, 80, LAUNCH)                            \
    ATPU_FLASH_HEAD_DIM(bf16, d, 32, LAUNCH)                            \
    ATPU_FLASH_HEAD_DIM(bf16, d, 16, LAUNCH)                            \
    return static_cast<int>(cudaErrorInvalidValue);                     \
  } while (0)
