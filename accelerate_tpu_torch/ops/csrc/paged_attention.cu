// K1 - paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel _paged_attn_kernel of
// accelerate_tpu/ops/paged_attention.py (defined at :252, launched by
// paged_attention at :448): decode (S = 1) and short verify spans over KV
// pages read in place through per-lane block tables.
//
// What it computes.  Query i of lane n sits at position lengths[n] + i and
// sees keys j <= lengths[n] + i; the new positions' K/V are already in the
// pool.  The rep = Hq / Hkv query heads sharing a KV head fold into rows,
// group-major as on the TPU (:415-420): row r is head h * rep + r / S, query
// r % S.  QK^T and PV run in f32 from the page dtype, q is scaled by
// D^-0.5 before the product (:294), masked logits take DEFAULT_MASK_VALUE,
// and the softmax is the online (flash) one in f32 over the lane's pages.
//
// What bounds it on an H100.  One decode step reads every live K/V byte of
// every lane once and does 4 * D flops per (row, key) - about 2 flops per
// byte for bf16 pages, far below the ~295 flop/byte at which the tensor
// cores would become the limit.  The bound is bytes: live K/V bytes at
// 3.35 TB/s.
//
// What the design does about it.  One CTA per (lane, kv-head) walks only the
// lane's live pages, p < (lengths[n] + S - 1) / page + 1 (:285-287); table
// slots past that hold the null page or a previous owner's id and are never
// read.  Each page's K and V tile is loaded into shared memory once per
// (lane, kv-head) with 16-byte loads, several in flight per thread, and
// dequantized by its per-(page, head) scale (ones for native pages, as the
// TPU wrapper feeds them, :410-413), so every folded GQA row reuses the same
// tile instead of re-reading the page.  Arithmetic stays on the CUDA cores:
// at ~2 flops per byte they are not the limit.  Not done yet: cp.async/TMA
// double buffering of the next page behind the current one, and a split of
// long lanes across CTAs (flash-decoding) when lanes x heads < 132 SMs.
#include "paged_common.cuh"

namespace atpu {

constexpr int kDecodeThreads = 128;
constexpr int kDecodeMaxRows = 32;  // rep * S folded rows one CTA holds

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ pages_k,
                    const KT* __restrict__ pages_v, const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales, const int* __restrict__ tables,
                    const int* __restrict__ lengths, QT* __restrict__ out, int s_len,
                    int hq, int hkv, int page, int num_p, float scale) {
  constexpr int NT = kDecodeThreads;
  constexpr int KS = D + 4;      // padded K row: conflict-free float4 reads across rows
  constexpr int CG = D / 4;      // float4 column groups of a row
  constexpr int NRG = NT / CG;   // row groups of the PV phase
  constexpr int MAXK = kDecodeMaxRows / NRG;

  const int h = blockIdx.x;
  const int n = blockIdx.y;
  const int rep = hq / hkv;
  const int gs = rep * s_len;

  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // page x KS
  float* v_s = k_s + page * KS;                   // page x D
  float* q_s = v_s + page * D;                    // gs x D
  float* p_s = q_s + gs * D;                      // gs x page: logits, then probabilities
  float* m_s = p_s + gs * page;                   // gs running max
  float* l_s = m_s + gs;                          // gs running denominator
  float* a_s = l_s + gs;                          // gs rescale factor of this page

  const int length = lengths[n];
  for (int e = threadIdx.x; e < gs * D; e += NT) {
    const int r = e / D, c = e % D;
    const int head = h * rep + r / s_len, qi = r % s_len;
    q_s[e] = to_f32(q[((size_t)(n * s_len + qi) * hq + head) * D + c]) * scale;
  }
  for (int r = threadIdx.x; r < gs; r += NT) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  const int c4 = threadIdx.x % CG, rg = threadIdx.x / CG;
  float4 acc[MAXK];
#pragma unroll
  for (int k = 0; k < MAXK; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);

  int live = (length + s_len - 1) / page + 1;
  if (live > num_p) live = num_p;
  const size_t row_stride = (size_t)hkv * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int p = 0; p < live; ++p) {
    const int pid = tables[n * num_p + p];
    const size_t base = ((size_t)pid * page * hkv + h) * D;
    __syncthreads();  // the previous page's readers are done with the tiles
    load_kv_tiles<KT, D, NT>(k_s, KS, v_s, pages_k + base, pages_v + base, row_stride, page,
                             k_scales[pid * hkv + h], v_scales[pid * hkv + h]);
    __syncthreads();

    // logits: one thread per key, every folded row
    for (int j = threadIdx.x; j < page; j += NT) {
      const float4* kr = reinterpret_cast<const float4*>(k_s + j * KS);
      const int pos = p * page + j;
      for (int r = 0; r < gs; ++r) {
        const float4* qr = reinterpret_cast<const float4*>(q_s + r * D);
        float dot = 0.f;
#pragma unroll 8
        for (int c = 0; c < CG; ++c) dot += dot4(qr[c], kr[c]);
        p_s[r * page + j] = (pos <= length + r % s_len) ? dot : kMaskValue;
      }
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < gs; r += NT / 32) {
      float* pr = p_s + r * page;
      float mx = -INFINITY;
      for (int j = lane; j < page; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_next = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < page; j += 32) {
        const float e = expf(pr[j] - m_next);
        pr[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_next);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_next;
      }
    }
    __syncthreads();

    // PV: each thread owns a float4 column group of rows rg, rg + NRG, ...
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      const int r = rg + NRG * k;
      if (r < gs) {
        const float alpha = a_s[r];
        float4 a = make_float4(acc[k].x * alpha, acc[k].y * alpha, acc[k].z * alpha,
                               acc[k].w * alpha);
        const float* pr = p_s + r * page;
        for (int j = 0; j < page; ++j)
          a = fma4(pr[j], reinterpret_cast<const float4*>(v_s + j * D)[c4], a);
        acc[k] = a;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < MAXK; ++k) {
    const int r = rg + NRG * k;
    if (r < gs) {
      const float l = l_s[r];
      const float inv = 1.f / (l == 0.f ? 1.f : l);
      const int head = h * rep + r / s_len, qi = r % s_len;
      QT* o = out + ((size_t)(n * s_len + qi) * hq + head) * D + c4 * 4;
      o[0] = from_f32<QT>(acc[k].x * inv);
      o[1] = from_f32<QT>(acc[k].y * inv);
      o[2] = from_f32<QT>(acc[k].z * inv);
      o[3] = from_f32<QT>(acc[k].w * inv);
    }
  }
}

template <typename QT, typename KT, int D>
int launch_decode(const void* q, const void* pages_k, const void* pages_v,
                  const float* k_scales, const float* v_scales, const int* tables,
                  const int* lengths, void* out, int n, int s, int hq, int hkv, int page,
                  int num_p, float scale, cudaStream_t stream) {
  const int gs = (hq / hkv) * s;
  if (gs > kDecodeMaxRows || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * ((size_t)page * (D + 4) + (size_t)page * D + (size_t)gs * D +
                       (size_t)gs * page + 3 * (size_t)gs);
  auto kernel = paged_decode_kernel<QT, KT, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(hkv, n), kDecodeThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(pages_k),
      static_cast<const KT*>(pages_v), k_scales, v_scales, tables, lengths,
      static_cast<QT*>(out), s, hq, hkv, page, num_p, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace atpu

#define ATPU_LAUNCH_DECODE(QT, KT, D)                                                   \
  atpu::launch_decode<QT, KT, D>(q, pages_k, pages_v, k_scales, v_scales, tables,       \
                                 lengths, out, n, s, hq, hkv, page, num_p, scale,        \
                                 static_cast<cudaStream_t>(stream))

extern "C" int atpu_paged_decode(const void* q, const void* pages_k, const void* pages_v,
                                 const float* k_scales, const float* v_scales,
                                 const int* tables, const int* lengths, void* out, int n,
                                 int s, int hq, int hkv, int d, int page, int num_p,
                                 int q_bf16, int kv_bf16, float scale, void* stream) {
  ATPU_DISPATCH(q_bf16, kv_bf16, d, ATPU_LAUNCH_DECODE);
}

extern "C" const char* atpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
