// K4 and K5 - flash-attention backward for Hopper (sm_90a): dQ, and dK/dV.
//
// Replace the TPU kernels _dq_kernel and _dkv_kernel of
// accelerate_tpu/ops/flash_attention.py (defined at :278 and :312, launched
// by _flash_bwd_bhsd at :408 and :422).  Both recompute the probabilities
// of a (q-block, k-tile) pair from the forward's saved logsumexp instead of
// storing them, exactly as the TPU kernels do:
//   s  = (q . k) * scale, masked to DEFAULT_MASK_VALUE
//   p  = exp(s - lse)                       (normalized probabilities)
//   dp = dO . v
//   ds = p * (dp - delta) * scale           (delta = rowsum(dO * O), :366)
//   dq += ds . K        (ds rounded to k's dtype first, :303)
//   dk += ds^T . q      (ds rounded to q's dtype, :342)
//   dv += p^T . dO      (p rounded to dO's dtype, :346)
// The two passes split the reductions the way the TPU grid does (dq over
// k-tiles, dk/dv over q-blocks), so neither needs atomics: every output
// element is summed by one thread in a fixed order and the results are the
// same bits from run to run.
//
// What bounds them on an H100.  Per visible (query head, key) pair K4 does
// 6 * D flops (scores, dp, dq) and K5 8 * D (scores, dp, dk, dv): at the
// training shape (B 2, S 2048, 32 heads, D 128, causal) 0.104 ms and
// 0.139 ms at the 989 TFLOP/s bf16 tensor-core rate, against ~0.06 ms of
// bytes each; the operations bound both.
//
// What the design does about it.  K4: one CTA per (batch, kv-head, q-block of
// 64 folded rows, group part), walking the k-tiles up to its causal
// frontier with q, dO, lse and delta resident.  K5: one CTA per (batch,
// kv-head, k-tile of 64 keys) with K, V and the dk/dv accumulators
// resident, walking the q-blocks (and each one's group parts) from the
// first one that can see the tile; a q-block's rows hold the query heads of
// the GQA group, so dk and dv accumulate unexpanded over the group as at
// :331-348.  All products are register-tiled on the CUDA cores
// from f32 shared tiles; tensor cores and TMA are a later change's work.
#include "flash_common.cuh"

namespace atpu {

// What a thread knows of its four rows ty + 16 i.
struct RowStats {
  int qi[4], segq[4];
  float lse[4], delta[4];
  bool valid[4];
};

// Turn a thread's 4 x 4 (row, key) block of scores s and dO.v products dp
// into p (in s) and ds (in dp); invalid rows get p = ds = 0.
__device__ __forceinline__ void probs_and_ds(float (&s)[4][4], float (&dp)[4][4],
                                             const RowStats& rs, int k0, int tx, const int* seg,
                                             int b, const FlashShape& sh, float scale) {
  int key[4], segk[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    key[j] = k0 + tx + 16 * j;
    segk[j] = (seg && key[j] < sh.sk) ? seg[(long long)b * sh.seg_stride + key[j]] : 0;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = s[i][j] * scale;
      if (key[j] >= sh.sk) {
        x = -INFINITY;
      } else if ((sh.causal && key[j] > rs.qi[i]) || (seg && segk[j] != rs.segq[i])) {
        x = kFlashMask;
      }
      const float p = rs.valid[i] ? expf(x - rs.lse[i]) : 0.f;
      s[i][j] = p;                                        // s now holds p
      dp[i][j] = p * (dp[i][j] - rs.delta[i]) * scale;    // dp now holds ds
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ seg,
                T* __restrict__ dq, FlashShape sh, float scale) {
  constexpr int QS = D + 4;
  constexpr int CPT = D / 64;
  const int qb = blockIdx.x / sh.parts, part = blockIdx.x % sh.parts;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  extern __shared__ float4 flash_smem[];
  float* q_s = reinterpret_cast<float*>(flash_smem);  // kRows x QS
  float* do_s = q_s + kRows * QS;                     // kRows x QS
  float* k_s = do_s + kRows * QS;                     // kKeys x QS
  float* v_s = k_s + kKeys * QS;                      // kKeys x QS
  float* ds_s = v_s + kKeys * QS;                     // kRows x kPStride

  const FoldedRows fr = folded_rows(sh, qb, part, h);
  auto q_row = [&](int r) { return fr.offset(b, r, D); };
  load_rows<T, D>(q_s, QS, q, kRows, q_row);
  load_rows<T, D>(do_s, QS, dout, kRows, q_row);

  RowStats rs;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    rs.qi[i] = fr.query(r);
    rs.segq[i] = seg ? seg[(long long)b * sh.seg_stride + rs.qi[i]] : 0;
    rs.valid[i] = fr.valid(r);
    rs.lse[i] = rs.valid[i] ? lse[fr.stat(b, r)] : 0.f;
    rs.delta[i] = rs.valid[i] ? delta[fr.stat(b, r)] : 0.f;
  }
  float4 acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int q_last = min(fr.q0 + sh.block_q, sh.sq) - 1;
  int n_kb = (sh.sk + kKeys - 1) / kKeys;
  if (sh.causal) n_kb = min(n_kb, q_last / kKeys + 1);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kKeys;
    auto kv_row = [&](int r) { return kv_offset(b, k0 + r, h, sh, D); };
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D>(k_s, QS, k, kKeys, kv_row);
    load_rows<T, D>(v_s, QS, v, kKeys, kv_row);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot<D>(s, q_s, k_s, ty, tx);
    tile_dot<D>(dp, do_s, v_s, ty, tx);
    probs_and_ds(s, dp, rs, k0, tx, seg, b, sh, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ds_s[(ty + 16 * i) * kPStride + tx + 16 * j] = round_to<T>(dp[i][j]);
    __syncthreads();

    // dq += ds . K: rows ty + 16 i, float4 columns tx + 16 c
#pragma unroll 4
    for (int kk = 0; kk < kKeys; ++kk) {
      float4 kv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        kv[c] = *reinterpret_cast<const float4*>(k_s + kk * QS + (tx + 16 * c) * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = ds_s[(ty + 16 * i) * kPStride + kk];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fma4(d, kv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long off = fr.offset(b, ty + 16 * i, D);
    if (off < 0) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      T* o = dq + off + (tx + 16 * c) * 4;
      o[0] = flash_from<T>(acc[i][c].x);
      o[1] = flash_from<T>(acc[i][c].y);
      o[2] = flash_from<T>(acc[i][c].z);
      o[3] = flash_from<T>(acc[i][c].w);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, const int* __restrict__ seg,
                 T* __restrict__ dk, T* __restrict__ dv, FlashShape sh, float scale) {
  constexpr int QS = D + 4;
  constexpr int CPT = D / 64;
  const int kb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = kb * kKeys;

  extern __shared__ float4 flash_smem[];
  float* k_s = reinterpret_cast<float*>(flash_smem);  // kKeys x QS
  float* v_s = k_s + kKeys * QS;                      // kKeys x QS
  float* q_s = v_s + kKeys * QS;                      // kRows x QS
  float* do_s = q_s + kRows * QS;                     // kRows x QS
  float* p_s = do_s + kRows * QS;                     // kRows x kPStride
  float* ds_s = p_s + kRows * kPStride;               // kRows x kPStride

  auto kv_row = [&](int r) { return kv_offset(b, k0 + r, h, sh, D); };
  load_rows<T, D>(k_s, QS, k, kKeys, kv_row);
  load_rows<T, D>(v_s, QS, v, kKeys, kv_row);

  float4 dk_acc[4][CPT], dv_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dk_acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      dv_acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  // queries before k0 see no key of this tile: start at the q-block holding
  // k0; every part of the group of each q-block, in a fixed order
  const int n_qb = (sh.sq + sh.block_q - 1) / sh.block_q;
  const int qb0 = sh.causal ? min(k0 / sh.block_q, n_qb) : 0;
  for (int it = qb0 * sh.parts; it < n_qb * sh.parts; ++it) {
    const FoldedRows fr = folded_rows(sh, it / sh.parts, it % sh.parts, h);
    auto q_row = [&](int r) { return fr.offset(b, r, D); };
    __syncthreads();  // the previous q-block's readers are done
    load_rows<T, D>(q_s, QS, q, kRows, q_row);
    load_rows<T, D>(do_s, QS, dout, kRows, q_row);
    RowStats rs;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      rs.qi[i] = fr.query(r);
      rs.segq[i] = seg ? seg[(long long)b * sh.seg_stride + rs.qi[i]] : 0;
      rs.valid[i] = fr.valid(r);
      rs.lse[i] = rs.valid[i] ? lse[fr.stat(b, r)] : 0.f;
      rs.delta[i] = rs.valid[i] ? delta[fr.stat(b, r)] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot<D>(s, q_s, k_s, ty, tx);
    tile_dot<D>(dp, do_s, v_s, ty, tx);
    probs_and_ds(s, dp, rs, k0, tx, seg, b, sh, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p_s[(ty + 16 * i) * kPStride + tx + 16 * j] = round_to<T>(s[i][j]);
        ds_s[(ty + 16 * i) * kPStride + tx + 16 * j] = round_to<T>(dp[i][j]);
      }
    __syncthreads();

    // dv += p^T . dO and dk += ds^T . q: keys ty + 16 i, float4 columns tx + 16 c
#pragma unroll 2
    for (int r = 0; r < kRows; ++r) {
      float4 dov[CPT], qv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        dov[c] = *reinterpret_cast<const float4*>(do_s + r * QS + (tx + 16 * c) * 4);
        qv[c] = *reinterpret_cast<const float4*>(q_s + r * QS + (tx + 16 * c) * 4);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[r * kPStride + ty + 16 * i];
        const float d = ds_s[r * kPStride + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          dv_acc[i][c] = fma4(p, dov[c], dv_acc[i][c]);
          dk_acc[i][c] = fma4(d, qv[c], dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long off = kv_offset(b, k0 + ty + 16 * i, h, sh, D);
    if (off < 0) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      T* ok = dk + off + (tx + 16 * c) * 4;
      T* ov = dv + off + (tx + 16 * c) * 4;
      ok[0] = flash_from<T>(dk_acc[i][c].x);
      ok[1] = flash_from<T>(dk_acc[i][c].y);
      ok[2] = flash_from<T>(dk_acc[i][c].z);
      ok[3] = flash_from<T>(dk_acc[i][c].w);
      ov[0] = flash_from<T>(dv_acc[i][c].x);
      ov[1] = flash_from<T>(dv_acc[i][c].y);
      ov[2] = flash_from<T>(dv_acc[i][c].z);
      ov[3] = flash_from<T>(dv_acc[i][c].w);
    }
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, const int* seg, void* dq, int b, const FlashShape& sh,
              float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)kRows * (D + 4) +
                                       2 * (size_t)kKeys * (D + 4) + (size_t)kRows * kPStride);
  auto kernel = flash_dq_kernel<T, D>;
  cudaError_t err = flash_allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qb = (sh.sq + sh.block_q - 1) / sh.block_q;
  kernel<<<dim3(n_qb * sh.parts, sh.hkv, b), kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, seg, static_cast<T*>(dq), sh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* seg, void* dk, void* dv, int b,
               const FlashShape& sh, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)kKeys * (D + 4) +
                                       2 * (size_t)kRows * (D + 4) +
                                       2 * (size_t)kRows * kPStride);
  auto kernel = flash_dkv_kernel<T, D>;
  cudaError_t err = flash_allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kb = (sh.sk + kKeys - 1) / kKeys;
  kernel<<<dim3(n_kb, sh.hkv, b), kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, seg, static_cast<T*>(dk), static_cast<T*>(dv),
      sh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace atpu

#define ATPU_LAUNCH_DQ(T, D)                                                          \
  atpu::launch_dq<T, D>(q, k, v, dout, lse, delta, seg, dq, b, sh, scale,              \
                        static_cast<cudaStream_t>(stream))
#define ATPU_LAUNCH_DKV(T, D)                                                         \
  atpu::launch_dkv<T, D>(q, k, v, dout, lse, delta, seg, dk, dv, b, sh, scale,         \
                         static_cast<cudaStream_t>(stream))

extern "C" int atpu_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, const int* seg, void* dq,
                             int b, int sq, int sk, int hq, int hkv, int d, int seg_stride,
                             int causal, int bf16, float scale, void* stream) {
  if (!atpu::flash_shape_ok(b, sq, sk, hq, hkv)) return static_cast<int>(cudaErrorInvalidValue);
  const atpu::FlashShape sh = atpu::flash_shape(sq, sk, hq, hkv, seg_stride, causal);
  ATPU_FLASH_DISPATCH(bf16, d, ATPU_LAUNCH_DQ);
}

extern "C" int atpu_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, const int* seg, void* dk,
                              void* dv, int b, int sq, int sk, int hq, int hkv, int d,
                              int seg_stride, int causal, int bf16, float scale, void* stream) {
  if (!atpu::flash_shape_ok(b, sq, sk, hq, hkv)) return static_cast<int>(cudaErrorInvalidValue);
  const atpu::FlashShape sh = atpu::flash_shape(sq, sk, hq, hkv, seg_stride, causal);
  ATPU_FLASH_DISPATCH(bf16, d, ATPU_LAUNCH_DKV);
}

extern "C" const char* atpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
