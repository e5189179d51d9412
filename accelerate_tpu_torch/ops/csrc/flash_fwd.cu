// K3 - flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel _fwd_kernel of accelerate_tpu/ops/flash_attention.py
// (defined at :84, launched by _flash_fwd_bhsd at :212): causal or full
// attention over BSHD tensors with the GQA group folded into the rows,
// segment-id masking composed with the causal mask, an online softmax whose
// output is the attention result and the row logsumexp that the backward
// kernels (flash_bwd.cu) recompute probabilities from.
//
// What it computes, as the TPU kernel does.  Scores are f32 products of the
// input-dtype operands, multiplied by `scale`; a masked score becomes
// DEFAULT_MASK_VALUE (finite); the running max m, denominator l and
// accumulator stay f32; p is rounded to v's dtype before PV (:163) while l
// sums the unrounded p; the output is acc / l with l == 0 taken as 1
// (:171), and lse = m + log(l).  A q-block skips every k-tile that starts
// past its last query (the rule of :106-108).
//
// What bounds it on an H100.  4 * D flops per visible (query head, key)
// pair: at the training shape (B 2, S 2048, 32 heads, D 128, causal) that is
// 6.9e10 flops, 0.070 ms at the 989 TFLOP/s bf16 tensor-core rate, against
// 134 MB of q/k/v/out, 0.040 ms at 3.35 TB/s: the operations bound it.
//
// What the design does about it.  One CTA per (batch, kv-head, q-block of 64
// folded rows, and part of the group where a group holds more than 64
// heads); it walks the k-tiles up to its causal frontier, so no CTA
// reads or multiplies a tile that lies wholly above the diagonal, and each K
// and V tile it loads serves all 64 rows (every head of the GQA group).
// Both products are register-tiled on the CUDA cores (4 x 4 scores and
// 4 rows x D/16 columns of the accumulator per thread, operands from f32
// shared tiles); the softmax statistics never leave registers.  This first
// version leaves the tensor cores idle, so it runs far from the bound:
// mma/wgmma on bf16 tiles and TMA loads are the work of a later change.
#include "flash_common.cuh"

namespace atpu {

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ seg, T* __restrict__ out, float* __restrict__ lse,
                 FlashShape sh, float scale) {
  constexpr int QS = D + 4;     // row stride of the q and k tiles
  constexpr int CPT = D / 64;   // float4 column groups per thread
  const int qb = blockIdx.x / sh.parts, part = blockIdx.x % sh.parts;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  extern __shared__ float4 flash_smem[];
  float* q_s = reinterpret_cast<float*>(flash_smem);  // kRows x QS
  float* k_s = q_s + kRows * QS;                      // kKeys x QS
  float* v_s = k_s + kKeys * QS;                      // kKeys x D
  float* p_s = v_s + kKeys * D;                       // kRows x kPStride

  const FoldedRows fr = folded_rows(sh, qb, part, h);
  load_rows<T, D>(q_s, QS, q, kRows, [&](int r) { return fr.offset(b, r, D); });

  int qi[4], segq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qi[i] = fr.query(ty + 16 * i);
    segq[i] = seg ? seg[(long long)b * sh.seg_stride + qi[i]] : 0;
  }
  float m[4], l[4];
  float4 acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int q_last = min(fr.q0 + sh.block_q, sh.sq) - 1;
  int n_kb = (sh.sk + kKeys - 1) / kKeys;
  if (sh.causal) n_kb = min(n_kb, q_last / kKeys + 1);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kKeys;
    auto kv_row = [&](int r) { return kv_offset(b, k0 + r, h, sh, D); };
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D>(k_s, QS, k, kKeys, kv_row);
    load_rows<T, D>(v_s, D, v, kKeys, kv_row);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_dot<D>(s, q_s, k_s, ty, tx);

    int key[4], segk[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      key[j] = k0 + tx + 16 * j;
      segk[j] = (seg && key[j] < sh.sk) ? seg[(long long)b * sh.seg_stride + key[j]] : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x[4];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = s[i][j] * scale;
        if (key[j] >= sh.sk) {
          x[j] = -INFINITY;  // past the sequence: not a key at all
        } else if ((sh.causal && key[j] > qi[i]) || (seg && segk[j] != segq[i])) {
          x[j] = kFlashMask;
        }
        mx = fmaxf(mx, x[j]);
      }
      const float m_next = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
      float* prow = p_s + (ty + 16 * i) * kPStride;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(x[j] - m_next);
        sum += p;
        prow[tx + 16 * j] = round_to<T>(p);
      }
      const float alpha = expf(m[i] - m_next);
      l[i] = alpha * l[i] + half_warp_sum(sum);
      m[i] = m_next;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] = scale4(acc[i][c], alpha);
    }
    __syncthreads();

    // acc += p . V: rows ty + 16 i, float4 columns tx + 16 c
#pragma unroll 4
    for (int kk = 0; kk < kKeys; ++kk) {
      float4 vv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        vv[c] = *reinterpret_cast<const float4*>(v_s + kk * D + (tx + 16 * c) * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty + 16 * i) * kPStride + kk];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fma4(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const long long off = fr.offset(b, r, D);
    if (off < 0) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      T* o = out + off + (tx + 16 * c) * 4;
      o[0] = flash_from<T>(acc[i][c].x * inv);
      o[1] = flash_from<T>(acc[i][c].y * inv);
      o[2] = flash_from<T>(acc[i][c].z * inv);
      o[3] = flash_from<T>(acc[i][c].w * inv);
    }
    if (tx == 0) lse[fr.stat(b, r)] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const int* seg, void* out,
               float* lse, int b, const FlashShape& sh, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kRows * (D + 4) + (size_t)kKeys * (D + 4) +
                                       (size_t)kKeys * D + (size_t)kRows * kPStride);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = flash_allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qb = (sh.sq + sh.block_q - 1) / sh.block_q;
  kernel<<<dim3(n_qb * sh.parts, sh.hkv, b), kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg,
      static_cast<T*>(out), lse, sh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace atpu

#define ATPU_LAUNCH_FWD(T, D) \
  atpu::launch_fwd<T, D>(q, k, v, seg, out, lse, b, sh, scale, static_cast<cudaStream_t>(stream))

extern "C" int atpu_flash_fwd(const void* q, const void* k, const void* v, const int* seg,
                              void* out, float* lse, int b, int sq, int sk, int hq, int hkv,
                              int d, int seg_stride, int causal, int bf16, float scale,
                              void* stream) {
  if (!atpu::flash_shape_ok(b, sq, sk, hq, hkv)) return static_cast<int>(cudaErrorInvalidValue);
  const atpu::FlashShape sh = atpu::flash_shape(sq, sk, hq, hkv, seg_stride, causal);
  ATPU_FLASH_DISPATCH(bf16, d, ATPU_LAUNCH_FWD);
}

extern "C" const char* atpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
