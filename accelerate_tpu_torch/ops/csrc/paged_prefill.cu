// K2 - paged chunked-prefill flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel _paged_prefill_kernel of
// accelerate_tpu/ops/paged_attention.py (defined at :479, launched by
// paged_flash_prefill at :633): a prefill chunk's queries attend over the
// lane's KV pages in place - prior pages and the chunk's own, already
// inserted, in one uniform causal page walk.
//
// What it computes.  Query i of lane n sits at position lengths[n] + i (the
// chunk base) and sees keys j <= lengths[n] + i.  The rep query heads of a
// KV head fold into rows query-major (row r: query qb * block_q + r / rep,
// head h * rep + r % rep), so one q-block covers one contiguous query span
// and its page walk can stop at that span's causal frontier,
// p * page <= lengths[n] + last query of the block (:507).  QK^T and PV run
// in f32 from the page dtype with q scaled by D^-0.5 before the product
// (:514); masked logits take DEFAULT_MASK_VALUE; online softmax in f32.
//
// What bounds it on an H100.  A chunk of S queries over L prior keys does
// 4 * D * Hq * (S * L + S * (S + 1) / 2) flops and moves the chunk's q/out
// plus the live K/V pages: for a 512-token chunk at base 0 (Llama-2-7B
// widths) about 2.2 GFLOP against 17 MB, i.e. ~128 flops per byte, below
// the ~295 flop/byte ridge, so bytes bound it at the tensor-core rate; with
// thousands of prior keys the flops dominate.  The bound reported beside
// the kernel's time is the larger of the two.
//
// What the design does about it.  One CTA per (lane, kv-head, q-block of up
// to 64 folded rows): each K/V page tile is loaded into shared memory once
// per q-block and reused by all 64 rows, the walk skips pages past the
// block's causal frontier, and dead table slots are never read.  Logits and
// PV are register-tiled on the CUDA cores (8 rows per thread sharing one K
// row or one V column group).  This first version leaves the tensor cores
// idle: wgmma on bf16 tiles, TMA loads and a pipelined page ring are the
// work of a later change, and its time beside the bound says how much that
// is worth.
#include "paged_common.cuh"

namespace atpu {

constexpr int kPrefillThreads = 256;
constexpr int kPrefillRows = 64;  // folded rows (block_q * rep) per CTA

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kPrefillThreads)
paged_prefill_kernel(const QT* __restrict__ q, const KT* __restrict__ pages_k,
                     const KT* __restrict__ pages_v, const float* __restrict__ k_scales,
                     const float* __restrict__ v_scales, const int* __restrict__ tables,
                     const int* __restrict__ lengths, QT* __restrict__ out, int s_len, int hq,
                     int hkv, int page, int num_p, int block_q, float scale) {
  constexpr int NT = kPrefillThreads;
  constexpr int ROWS = kPrefillRows;
  constexpr int NW = NT / 32;
  constexpr int KS = D + 4;      // padded K row: conflict-free float4 reads across rows
  constexpr int CG = D / 4;      // float4 column groups of a row
  constexpr int NRG = NT / CG;   // row groups of the PV phase
  constexpr int PVK = ROWS / NRG;
  constexpr int QKK = ROWS / NW;

  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int n = blockIdx.z;
  const int rep = hq / hkv;
  const int rows = block_q * rep;
  const int q0 = qb * block_q;

  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // page x KS
  float* v_s = k_s + page * KS;                   // page x D
  float* q_s = v_s + page * D;                    // ROWS x D
  float* p_s = q_s + ROWS * D;                    // ROWS x page: logits, then probabilities
  float* m_s = p_s + ROWS * page;                 // ROWS running max
  float* l_s = m_s + ROWS;                        // ROWS running denominator
  float* a_s = l_s + ROWS;                        // ROWS rescale factor of this page

  const int length = lengths[n];
  // query of row r, clamped into the chunk: rows past the chunk's end (a
  // ragged last q-block) compute like its last query and are never stored
  auto query_of = [&](int r) {
    const int qi = q0 + r / rep;
    return qi < s_len ? qi : s_len - 1;
  };
  for (int e = threadIdx.x; e < ROWS * D; e += NT) {
    const int r = e / D, c = e % D;
    float v = 0.f;
    if (r < rows) {
      const int head = h * rep + r % rep;
      v = to_f32(q[((size_t)(n * s_len + query_of(r)) * hq + head) * D + c]) * scale;
    }
    q_s[e] = v;
  }
  for (int r = threadIdx.x; r < ROWS; r += NT) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  const int c4 = threadIdx.x % CG, rg = threadIdx.x / CG;
  float4 acc[PVK];
#pragma unroll
  for (int k = 0; k < PVK; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int q_last = (q0 + block_q < s_len ? q0 + block_q : s_len) - 1;
  const int frontier = length + q_last;  // last key any row of this block sees
  const size_t row_stride = (size_t)hkv * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int p = 0; p < num_p && p * page <= frontier; ++p) {
    const int pid = tables[n * num_p + p];
    const size_t base = ((size_t)pid * page * hkv + h) * D;
    __syncthreads();  // the previous page's readers are done with the tiles
    load_kv_tiles<KT, D, NT>(k_s, KS, v_s, pages_k + base, pages_v + base, row_stride, page,
                             k_scales[pid * hkv + h], v_scales[pid * hkv + h]);
    __syncthreads();

    // logits: lane -> key, warp -> rows warp, warp + NW, ...
    for (int jc = 0; jc < page; jc += 32) {
      const int j = jc + lane;
      if (j < page) {
        const float4* kr = reinterpret_cast<const float4*>(k_s + j * KS);
        float sc[QKK];
#pragma unroll
        for (int k = 0; k < QKK; ++k) sc[k] = 0.f;
#pragma unroll 4
        for (int c = 0; c < CG; ++c) {
          const float4 kv = kr[c];
#pragma unroll
          for (int k = 0; k < QKK; ++k)
            sc[k] += dot4(reinterpret_cast<const float4*>(q_s + (warp + NW * k) * D)[c], kv);
        }
        const int pos = p * page + j;
#pragma unroll
        for (int k = 0; k < QKK; ++k) {
          const int r = warp + NW * k;
          p_s[r * page + j] = (pos <= length + query_of(r)) ? sc[k] : kMaskValue;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < rows; r += NW) {
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
    for (int k = 0; k < PVK; ++k) {
      const int r = rg + NRG * k;
      if (r < rows) {
        const float alpha = a_s[r];
        acc[k] = make_float4(acc[k].x * alpha, acc[k].y * alpha, acc[k].z * alpha,
                             acc[k].w * alpha);
      }
    }
    for (int j = 0; j < page; ++j) {
      const float4 vv = reinterpret_cast<const float4*>(v_s + j * D)[c4];
#pragma unroll
      for (int k = 0; k < PVK; ++k) {
        const int r = rg + NRG * k;
        if (r < rows) acc[k] = fma4(p_s[r * page + j], vv, acc[k]);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < PVK; ++k) {
    const int r = rg + NRG * k;
    const int qi = q0 + r / rep;
    if (r < rows && qi < s_len) {
      const float l = l_s[r];
      const float inv = 1.f / (l == 0.f ? 1.f : l);
      const int head = h * rep + r % rep;
      QT* o = out + ((size_t)(n * s_len + qi) * hq + head) * D + c4 * 4;
      o[0] = from_f32<QT>(acc[k].x * inv);
      o[1] = from_f32<QT>(acc[k].y * inv);
      o[2] = from_f32<QT>(acc[k].z * inv);
      o[3] = from_f32<QT>(acc[k].w * inv);
    }
  }
}

template <typename QT, typename KT, int D>
int launch_prefill(const void* q, const void* pages_k, const void* pages_v,
                   const float* k_scales, const float* v_scales, const int* tables,
                   const int* lengths, void* out, int n, int s, int hq, int hkv, int page,
                   int num_p, float scale, cudaStream_t stream) {
  if (hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rep = hq / hkv;
  if (rep > kPrefillRows) return static_cast<int>(cudaErrorInvalidValue);
  int block_q = kPrefillRows / rep;
  if (block_q > s) block_q = s;
  const int n_qb = (s + block_q - 1) / block_q;
  const size_t smem =
      sizeof(float) * ((size_t)page * (D + 4) + (size_t)page * D + (size_t)kPrefillRows * D +
                       (size_t)kPrefillRows * page + 3 * (size_t)kPrefillRows);
  auto kernel = paged_prefill_kernel<QT, KT, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_qb, hkv, n), kPrefillThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(pages_k),
      static_cast<const KT*>(pages_v), k_scales, v_scales, tables, lengths,
      static_cast<QT*>(out), s, hq, hkv, page, num_p, block_q, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace atpu

#define ATPU_LAUNCH_PREFILL(QT, KT, D)                                                  \
  atpu::launch_prefill<QT, KT, D>(q, pages_k, pages_v, k_scales, v_scales, tables,      \
                                  lengths, out, n, s, hq, hkv, page, num_p, scale,       \
                                  static_cast<cudaStream_t>(stream))

extern "C" int atpu_paged_prefill(const void* q, const void* pages_k, const void* pages_v,
                                  const float* k_scales, const float* v_scales,
                                  const int* tables, const int* lengths, void* out, int n,
                                  int s, int hq, int hkv, int d, int page, int num_p,
                                  int q_bf16, int kv_bf16, float scale, void* stream) {
  ATPU_DISPATCH(q_bf16, kv_bf16, d, ATPU_LAUNCH_PREFILL);
}

extern "C" const char* atpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
