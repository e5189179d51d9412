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
// 134 MB of q/k/v/out, 0.040 ms at 3.35 TB/s: the tensor cores bound it.
//
// Both arms give each (batch, kv-head, q-block of 64 folded rows, and part
// of the group where a group holds more than 64 heads) a walk over the
// k-tiles of 64 keys up to the causal frontier, so no q-block reads or
// multiplies a tile that lies wholly above the diagonal, and each K and V
// tile serves all 64 rows (every head of the GQA group).  The f32 arm runs
// one CTA per q-block, the bf16 arm two consecutive q-blocks per CTA.
//
// bf16 arm (flash_fwd_wgmma_kernel): the tensor cores.  A CTA holds two
// consumer warpgroups, each owning one q-block of 64 folded rows (wgmma's
// M), and one producer warp.  Q, K and V sit in shared memory as bf16 tiles
// in the 128-byte swizzle that wgmma reads (flash_wgmma.cuh).  S = Q.K^T is
// a wgmma with both operands from shared memory; the online softmax runs on
// the S accumulator in registers (each thread holds 2 rows x 16 keys, a
// row's statistics reduce over the 4 threads of a quad), and P, rounded to
// bf16 in place, is the register A operand of O += P.V, with V read
// MN-major as it is stored.  The producer streams K/V tiles through a ring
// of three stages with TMA (one box per 64-column panel over the [B, Sk,
// Hkv, D] tensor, so a ragged last tile reads zeros, never the next batch's
// keys), signalling mbarriers; each warpgroup waits on a stage's "full"
// barrier and releases it on its "empty" one, so the two warpgroups run
// out of step and one's softmax overlaps the other's products.  The
// producer first loads each warpgroup's Q once, by TMA too: one box per
// panel that is the folded q-block itself (rep heads x block_q queries of
// the [B, Sq, Hq, D] tensor, zeros past Sq).  When rep does not divide 64
// the tile's spare rows are never written; a row of S and O depends on its
// own Q row only, and a spare row is never stored.  Masks are evaluated
// only on the tiles that need them; an unmasked tile takes
// exp(s * scale - m) as one fused multiply-add and one exp2.  Head dims
// below and between whole panels (16, 32, 80, 96) run on tiles padded to
// whole 64-column panels (flash_wgmma.cuh: TMA lands the columns past D as
// zeros, the epilogue stores D); D 256 runs one consumer warpgroup a CTA
// (128 O accumulators a thread: two warpgroups would spill) over four
// panels, P.V as two N-128 products.  Left for later: overlapping a
// warpgroup's own softmax with its next S product, and persistent CTAs.
//
// f32 arm (flash_fwd_kernel): the CUDA cores, so that f32 inputs keep f32
// products (TF32 keeps ~3 decimal digits).  256 threads; both products are
// register-tiled (4 x 4 scores and 4 rows x D/16 columns of the accumulator
// per thread, operands from f32 shared tiles; at D 16, 32, 80 and 96 the
// last column group lies past D on some threads, which neither read nor
// store it); the softmax statistics never leave registers.
#include <type_traits>

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace atpu {

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ seg, T* __restrict__ out, float* __restrict__ lse,
                 FlashShape sh, float scale) {
  constexpr int QS = D + 4;     // row stride of the q and k tiles
  constexpr int CPT = (D / 4 + 15) / 16;  // float4 column groups per thread
  const int qb = blockIdx.x / sh.parts, part = blockIdx.x % sh.parts;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // column group tx + 16 c lies inside D (always, unless D / 4 is no
  // multiple of 16: D 16, 32, 80, 96)
  auto in_d = [&](int c) { return (D / 4) % 16 == 0 || tx + 16 * c < D / 4; };

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
      segk[j] = (seg && key[j] < sh.sk) ? sh.kseg[(long long)b * sh.kseg_stride + key[j]] : 0;
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
        vv[c] = in_d(c) ? *reinterpret_cast<const float4*>(v_s + kk * D + (tx + 16 * c) * 4)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
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
      if (!in_d(c)) continue;
      T* o = out + off + (tx + 16 * c) * 4;
      o[0] = flash_from<T>(acc[i][c].x * inv);
      o[1] = flash_from<T>(acc[i][c].y * inv);
      o[2] = flash_from<T>(acc[i][c].z * inv);
      o[3] = flash_from<T>(acc[i][c].w * inv);
    }
    if (tx == 0) lse[fr.stat(b, r)] = m[i] + logf(l_safe);
  }
}

// Consumer warpgroups of a CTA, one q-block each: two, or one at D 256,
// where 128 accumulators of O beside S and P would spill under the 224
// registers a thread of a 288-thread CTA may have, while a lone warpgroup
// may take 255.  K/V stages in the ring: three (at D 256 one Q tile and
// three stages of 32 KB tiles are 224 KB, within the SM's 227).
template <int D> __host__ __device__ constexpr int fwd_groups() { return D > 128 ? 1 : 2; }
constexpr int kFwdStages = 3;
// the consumer warpgroups, then one producer warp that issues the TMA loads
template <int D> __host__ __device__ constexpr int fwd_threads() {
  return fwd_groups<D>() * kWarpgroup + 32;
}

// Shared memory of the bf16 arm: one Q tile per warpgroup, the K/V stages,
// the ring's full/empty barriers and one barrier per Q tile, after a pad
// that lets the kernel align its tiles to the swizzle's 1024 bytes.
template <int D> constexpr size_t fwd_wgmma_smem() {
  return kSwizzleAlign + (fwd_groups<D>() + 2 * kFwdStages) * (size_t)tile_bytes<D>() +
         (2 * kFwdStages + fwd_groups<D>()) * sizeof(uint64_t);
}

template <int D>
__global__ void __launch_bounds__(fwd_threads<D>(), 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ seg,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ lse, FlashShape sh,
                       float scale) {
  constexpr int TB = tile_bytes<D>();
  constexpr int kFwdGroups = fwd_groups<D>();
  constexpr float kLog2e = 1.4426950408889634f;
  const int pair = blockIdx.x / sh.parts, part = blockIdx.x % sh.parts;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / kWarpgroup, t = tid % kWarpgroup;

  extern __shared__ unsigned char flash_tc_smem[];
  const uint32_t base = (smem_u32(flash_tc_smem) + kSwizzleAlign - 1) & ~(kSwizzleAlign - 1u);
  auto k_s = [&](int st) { return base + TB * (kFwdGroups + 2 * st); };
  auto v_s = [&](int st) { return base + TB * (kFwdGroups + 2 * st + 1); };
  const uint32_t full0 = base + TB * (kFwdGroups + 2 * kFwdStages);  // K/V of a stage landed
  const uint32_t empty0 = full0 + 8 * kFwdStages;  // both warpgroups are done with a stage
  const uint32_t q_full0 = empty0 + 8 * kFwdStages;  // a warpgroup's Q tile landed
  auto full = [&](int st) { return full0 + 8 * st; };
  auto empty = [&](int st) { return empty0 + 8 * st; };
  auto q_full = [&](int i) { return q_full0 + 8 * i; };

  // warpgroup wg owns q-block qb; the CTA streams the K/V tiles of the
  // longer walk of its two q-blocks
  int n_kb = 0;
#pragma unroll
  for (int i = 0; i < kFwdGroups; ++i)
    n_kb = max(n_kb, q_block_tiles(sh, kFwdGroups * pair + i, part, h));

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kFwdStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kFwdGroups);
    }
#pragma unroll
    for (int i = 0; i < kFwdGroups; ++i) mbar_init(q_full(i), 1);
    mbar_init_fence();
  }
  __syncthreads();  // the last CTA-wide barrier: the roles part here

  if (wg == kFwdGroups) {
    // producer: one thread loads each warpgroup's Q tile (none for a
    // q-block past the sequence, whose warpgroup walks no tile), then keeps
    // up to kFwdStages K/V tiles in flight
    if (t != 0) return;
#pragma unroll
    for (int i = 0; i < kFwdGroups; ++i) {
      const int qb = kFwdGroups * pair + i;
      if (q_block_tiles(sh, qb, part, h) == 0) continue;
      const FoldedRows fr = folded_rows(sh, qb, part, h);
      mbar_arrive_expect_tx(q_full(i), tile_panels<D>() * fr.rows * 128);
#pragma unroll
      for (int p = 0; p < tile_panels<D>(); ++p)
        tma_load_4d(base + TB * i + p * kPanelBytes, &tm_q, q_full(i), p * kPanelCols, fr.head0,
                    fr.q0, b);
    }
    for (int kb = 0; kb < n_kb; ++kb) {
      const int st = kb % kFwdStages, round = kb / kFwdStages;
      if (round > 0) mbar_wait(empty(st), (round - 1) & 1);
      mbar_arrive_expect_tx(full(st), 2 * TB);
#pragma unroll
      for (int p = 0; p < tile_panels<D>(); ++p) {
        tma_load_4d(k_s(st) + p * kPanelBytes, &tm_k, full(st), p * kPanelCols, h, kb * kKeys, b);
        tma_load_4d(v_s(st) + p * kPanelBytes, &tm_v, full(st), p * kPanelCols, h, kb * kKeys, b);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows 16 w + g + 8 e (e = 0, 1) of q-block qb
  const int w = t / 32, g = (t % 32) / 4, c2 = 2 * (t % 4);
  const int qb = kFwdGroups * pair + wg;
  const FoldedRows fr = folded_rows(sh, qb, part, h);
  const int my_kb = q_block_tiles(sh, qb, part, h);
  const uint32_t q_s = base + TB * wg;

  int qi[2], segq[2];
  float m[2], l[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    qi[e] = fr.query(16 * w + g + 8 * e);
    segq[e] = seg ? seg[(long long)b * sh.seg_stride + qi[e]] : 0;
    m[e] = -INFINITY;
    l[e] = 0.f;
  }
  float o[tile_cols<D>() / 2], s[32];
#pragma unroll
  for (int i = 0; i < tile_cols<D>() / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  const float scale_log2 = scale * kLog2e;

  if (my_kb > 0) mbar_wait(q_full(wg), 0);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int st = kb % kFwdStages, k0 = kb * kKeys;
    mbar_wait(full(st), (kb / kFwdStages) & 1);
    if (kb < my_kb) {
      wgmma_fence();
      mma_rows_by_rows<D>(s, q_s, k_s(st));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // s[4i + 2e + j] is (row 16 w + g + 8 e, key k0 + 8 i + c2 + j)
      const bool masked = seg || k0 + kKeys > sh.sk || (sh.causal && k0 + kKeys - 1 > fr.q0);
      float mx[2] = {-INFINITY, -INFINITY};
      if (masked) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int key = k0 + 8 * i + c2 + j;
            const int segk = (seg && key < sh.sk) ? sh.kseg[(long long)b * sh.kseg_stride + key] : 0;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x = s[4 * i + 2 * e + j] * scale;
              if (key >= sh.sk) {
                x = -INFINITY;  // past the sequence: not a key at all
              } else if ((sh.causal && key > qi[e]) || (seg && segk != segq[e])) {
                x = kFlashMask;
              }
              s[4 * i + 2 * e + j] = x;
              mx[e] = fmaxf(mx[e], x);
            }
          }
      } else {
        // no mask: the max of the scaled scores (scale may be negative)
#pragma unroll
        for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i] * scale);
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
        const float m_next = fmaxf(m[e], mx[e]);
        alpha[e] = ex2_approx((m[e] - m_next) * kLog2e);
        m[e] = m_next;
      }
      uint32_t pk[16];
      if (masked) {
        // s holds the masked scores; exp(x - m) with x = -inf or a mask
        // value taken as written (the scaled form would overflow)
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int e = i % 2;  // registers 2i, 2i + 1 share row 16 w + g + 8 e
          const float p0 = ex2_approx((s[2 * i] - m[e]) * kLog2e);
          const float p1 = ex2_approx((s[2 * i + 1] - m[e]) * kLog2e);
          sum[e] += p0 + p1;
          pk[i] = pack_bf16(p0, p1);
        }
      } else {
        // exp(s * scale - m) as one fused multiply-add and one exp2
        const float mb[2] = {m[0] * kLog2e, m[1] * kLog2e};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int e = i % 2;
          const float p0 = ex2_approx(fmaf(s[2 * i], scale_log2, -mb[e]));
          const float p1 = ex2_approx(fmaf(s[2 * i + 1], scale_log2, -mb[e]));
          sum[e] += p0 + p1;
          pk[i] = pack_bf16(p0, p1);  // p rounded to v's dtype (:163); l sums the unrounded p
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], 1);
        sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], 2);
        l[e] = alpha[e] * l[e] + sum[e];
      }
#pragma unroll
      for (int i = 0; i < tile_cols<D>() / 2; ++i) o[i] *= alpha[(i / 2) % 2];

      wgmma_fence();
      mma_probs_by_tile<D>(o, pk, v_s(st));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    // the warpgroup's products that read stage st are complete
    if (t == 0) mbar_arrive(empty(st));
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = 16 * w + g + 8 * e;
    const long long off = fr.offset(b, r, D);
    if (off < 0) continue;
    const float l_safe = l[e] == 0.f ? 1.f : l[e];
    const float inv = 1.f / l_safe;
    if (sh.out_f32) {
      float* out32 = reinterpret_cast<float*>(out);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<float2*>(out32 + off + 8 * i + c2) =
            make_float2(o[4 * i + 2 * e] * inv, o[4 * i + 2 * e + 1] * inv);
    } else {
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(out + off + 8 * i + c2) =
            __floats2bfloat162_rn(o[4 * i + 2 * e] * inv, o[4 * i + 2 * e + 1] * inv);
    }
    if (c2 == 0) lse[fr.stat(b, r)] = m[e] + logf(l_safe);
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const int* seg, void* out,
               float* lse, int b, const FlashShape& sh, float scale, cudaStream_t stream) {
  const int n_qb = (sh.sq + sh.block_q - 1) / sh.block_q;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    CUtensorMap tm_q, tm_k, tm_v;
    cudaError_t err = make_panel_tensor_map(&tm_q, q, b, sh.sq, sh.hq, D, sh.rep, sh.block_q);
    if (err == cudaSuccess) err = make_panel_tensor_map(&tm_k, k, b, sh.sk, sh.hkv, D, 1, kKeys);
    if (err == cudaSuccess) err = make_panel_tensor_map(&tm_v, v, b, sh.sk, sh.hkv, D, 1, kKeys);
    const size_t smem = fwd_wgmma_smem<D>();
    auto kernel = flash_fwd_wgmma_kernel<D>;
    if (err == cudaSuccess) err = flash_allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n_qb + fwd_groups<D>() - 1) / fwd_groups<D>() * sh.parts, sh.hkv, b);
    kernel<<<grid, fwd_threads<D>(), smem, stream>>>(tm_q, tm_k, tm_v, seg, static_cast<T*>(out), lse,
                                                sh, scale);
  } else {
    const size_t smem = sizeof(float) * ((size_t)kRows * (D + 4) + (size_t)kKeys * (D + 4) +
                                         (size_t)kKeys * D + (size_t)kRows * kPStride);
    auto kernel = flash_fwd_kernel<T, D>;
    cudaError_t err = flash_allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(n_qb * sh.parts, sh.hkv, b), kFlashThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg,
        static_cast<T*>(out), lse, sh, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace atpu

#define ATPU_LAUNCH_FWD(T, D) \
  atpu::launch_fwd<T, D>(q, k, v, seg, out, lse, b, sh, scale, static_cast<cudaStream_t>(stream))

extern "C" int atpu_flash_fwd(const void* q, const void* k, const void* v, const int* seg,
                              const int* kseg, void* out, float* lse, int b, int sq, int sk,
                              int hq, int hkv, int d, int seg_stride, int kseg_stride,
                              int causal, int bf16, int out_f32, float scale, void* stream) {
  if (!atpu::flash_shape_ok(b, sq, sk, hq, hkv)) return static_cast<int>(cudaErrorInvalidValue);
  atpu::FlashShape sh = atpu::flash_shape(sq, sk, hq, hkv, seg_stride, causal, seg, kseg,
                                          kseg_stride);
  sh.out_f32 = out_f32;
  ATPU_FLASH_DISPATCH(bf16, d, ATPU_LAUNCH_FWD);
}

extern "C" const char* atpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
