// K2 - paged chunked-prefill flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel _paged_prefill_kernel of
// accelerate_tpu/ops/paged_attention.py (defined at :479, launched by
// paged_flash_prefill at :633): a prefill chunk's queries attend over the
// lane's KV pages in place - prior pages and the chunk's own, already
// inserted, in one uniform causal page walk.
//
// What it computes.  Query i of lane n sits at position lengths[n] + i (the
// chunk base) and sees keys j <= lengths[n] + i.  The query heads of a KV
// head split into gsplit groups of rep heads (gsplit = 1 unless the GQA
// group exceeds a q-block's 64 folded rows: prefill_group_split), and a
// group's heads fold into rows query-major (row r of group hg: query
// qb * block_q + r / rep, head hg * rep + r % rep; its KV head is
// hg / gsplit), so one q-block covers one contiguous query span
// and its page walk can stop at that span's causal frontier,
// p * page <= lengths[n] + last query of the block (:507).  Masked logits
// take DEFAULT_MASK_VALUE; the online softmax keeps its running max,
// denominator and accumulator in f32.
//
// What bounds it on an H100.  A chunk of S queries over L prior keys does
// 4 * D * Hq * (S * L + S * (S + 1) / 2) flops and moves the chunk's q/out
// plus the live K/V pages: for a 512-token chunk at base 0 (Llama-2-7B
// widths) about 2.2 GFLOP against 17 MB, i.e. ~128 flops per byte, below
// the ~295 flop/byte ridge, so bytes bound it at the tensor-core rate; with
// thousands of prior keys the flops dominate.  The bound reported beside
// the kernel's time is the larger of the two.
//
// Two arms, chosen by the caller from the dtypes and the page size before
// the launch (accelerate_tpu_torch/ops/paged_attention.py prefill_design;
// the entry point refuses a tensor-core launch it cannot run).  Both give
// each (lane, kv-head, q-block of up to 64 folded rows) one walk over the
// keys up to the block's causal frontier: pages past it are never read, and
// each K/V tile serves all the block's rows (every head of the GQA group).
//
// bf16 q over bf16, int8 or fp8-e4m3 pages, D 64, 80, 96, 128 or 256, a
// page of 8, 16 or 32 keys or a multiple of 64 (paged_prefill_wgmma_kernel):
// the tensor cores, K3's design
// (flash_fwd.cu, flash_wgmma.cuh) over the page pool.  One consumer
// warpgroup owns the q-block (wgmma's M) and one producer warp feeds it by
// TMA: the folded q-block is one box per 64-column panel of the [N, S, Hq,
// D] tensor (zeros past the chunk), and the K/V tiles of 64 keys stream
// through a ring of two stages straight from the pages, read through the
// block table by the producer.  The pool [NP, page, Hkv, D] is a 4D tensor
// like a BSHD one, so a tile is one box of 64 keys of one page (page >= 64)
// or 64 / page boxes of whole pages (page < 64), each landing at its rows
// of the swizzled tile (a box of 8 rows or more keeps the swizzle's
// 1024-byte period).  A table slot whose page lies past the frontier is
// never read: its box is aimed past the pool's last page, so TMA lands
// zeros there, never a stale or NaN page; its keys are masked anyway, and
// zero K and V keep them finite through the products.  The producer's
// lanes also stage each key's page scales beside the tile.  S = Q.K^T is a
// wgmma from shared memory, times scale and the key's k-scale after the
// product (the TPU kernel scales q first, :514; the two agree up to
// rounding, and a negative scale is exact either way); the online softmax
// runs on the accumulator in registers, masked keys taking
// DEFAULT_MASK_VALUE; P, times the key's v-scale and rounded to bf16 in
// registers (the TPU kernel keeps P in f32, :538; l sums the unrounded p),
// is the A operand of O += P.V with V read MN-major.  Operands are bf16
// with f32 accumulation; the output is O / l with l == 0 taken as 1.  One
// q-block per CTA and two CTAs per SM (82 KB of shared memory each at
// D 128): a 128-token chunk of 32 heads is only 64 q-blocks, and two
// q-blocks per CTA would leave most of the 132 SMs idle.
//
// Quantized pages on the tensor cores (the dequant arm, :511).  wgmma takes
// no int8 or e4m3 B operand against a bf16 A, so the TMA lands each K/V
// tile as its 1-byte codes, unswizzled (a box of whole D-byte rows), and
// the consumer warpgroup converts it into the bf16 swizzled tiles that
// wgmma reads: each key's codes times its page's scale, rounded once to
// bf16 - the TPU kernel's dequantized tile k.astype(f32) * scale cast to
// q's dtype for the product (:512-516), and the plain version's rounding.
// (Keeping exact codes and applying the v-scale to P instead would round
// P * scale to bf16 at every key, one more rounding than the reference
// has where one key dominates a row.)
// The codes' stages hold half the bytes of a bf16 stage, so the two
// converted tiles keep the CTA at the native arm's 82 KB.
//
// Head dims.  D 80 and 96 run on two-panel (128-column) tiles: the tensor
// maps keep the true D, so TMA lands the columns past D as zeros (and the
// converted tiles of codes zero theirs once), Q.K^T sums D / 16 depth steps,
// P.V accumulates 128 columns and the epilogue stores D.  D 256 runs four
// panels, P.V as two N-128 products, one CTA an SM (160 KB of tiles, 128
// accumulators a thread).
//
// Every other call (f32 or mixed dtypes, f32 q over quantized pages, other
// page sizes, D 16 and 32: paged_prefill_kernel): the CUDA cores, in f32
// from the page dtype (quantized codes times their scale) with q
// scaled by D^-0.5 before the product (:514), as the TPU kernel computes.
// Each page tile is loaded into f32 shared memory once per q-block (at D
// 256 a page of more than 64 keys in tiles of half a page or less, whose
// f32 tiles fit the SM); logits and PV are register-tiled (8 rows per
// thread sharing one K row or one V column group; at D 80 and 96 the column
// groups do not divide the 256 threads, and the spare ones take no row).
#include "flash_wgmma.cuh"
#include "paged_common.cuh"

namespace atpu {

constexpr int kPrefillThreads = 256;
constexpr int kPrefillRows = 64;  // folded rows (block_q * rep) per CTA

// The groups a KV head's query heads split into: the fewest that divide its
// GQA group and leave at most kPrefillRows heads a group.  Each group is a
// q-block of its own over the same KV head's pages.
inline int prefill_group_split(int group) {
  int g = (group + kPrefillRows - 1) / kPrefillRows;
  while (group % g) ++g;
  return g;
}

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kPrefillThreads)
paged_prefill_kernel(const QT* __restrict__ q, const KT* __restrict__ pages_k,
                     const KT* __restrict__ pages_v, const float* __restrict__ k_scales,
                     const float* __restrict__ v_scales, const int* __restrict__ tables,
                     const int* __restrict__ lengths, QT* __restrict__ out, int s_len, int hq,
                     int hkv, int gsplit, int page, int tile, int num_p, int block_q,
                     float scale) {
  constexpr int NT = kPrefillThreads;
  constexpr int ROWS = kPrefillRows;
  constexpr int NW = NT / 32;
  constexpr int KS = D + 4;      // padded K row: conflict-free float4 reads across rows
  constexpr int CG = D / 4;      // float4 column groups of a row
  // row groups of the PV phase; where CG does not divide the threads (D 80,
  // 96) the spare threads take no row
  constexpr int NRG = NT / CG;
  constexpr int PVK = (ROWS + NRG - 1) / NRG;
  constexpr int QKK = ROWS / NW;

  const int qb = blockIdx.x;
  const int hg = blockIdx.y;  // query-head group of KV head h
  const int h = hg / gsplit;
  const int n = blockIdx.z;
  const int rep = hq / (hkv * gsplit);
  const int rows = block_q * rep;
  const int q0 = qb * block_q;

  // a key tile is `tile` keys of one page: the whole page, or (D 256 with
  // pages of more than 64 keys, whose f32 tiles would not fit) a part of it
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // tile x KS
  float* v_s = k_s + tile * KS;                   // tile x D
  float* q_s = v_s + tile * D;                    // ROWS x D
  float* p_s = q_s + ROWS * D;                    // ROWS x tile: logits, then probabilities
  float* m_s = p_s + ROWS * tile;                 // ROWS running max
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
      const int head = hg * rep + r % rep;
      v = to_f32(q[((size_t)(n * s_len + query_of(r)) * hq + head) * D + c]) * scale;
    }
    q_s[e] = v;
  }
  for (int r = threadIdx.x; r < ROWS; r += NT) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  const int c4 = threadIdx.x % CG, rg = threadIdx.x / CG;
  const bool pv_thread = NT % CG == 0 || rg < NRG;
  float4 acc[PVK];
#pragma unroll
  for (int k = 0; k < PVK; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int q_last = (q0 + block_q < s_len ? q0 + block_q : s_len) - 1;
  const int frontier = length + q_last;  // last key any row of this block sees
  const size_t row_stride = (size_t)hkv * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int kt = 0; kt < num_p * page && kt <= frontier; kt += tile) {
    const int p = kt / page;
    const int pid = tables[n * num_p + p];
    const size_t base = (((size_t)pid * page + kt % page) * hkv + h) * D;
    __syncthreads();  // the previous tile's readers are done with the tiles
    load_kv_tiles<KT, D, NT>(k_s, KS, v_s, pages_k + base, pages_v + base, row_stride, tile,
                             k_scales[pid * hkv + h], v_scales[pid * hkv + h]);
    __syncthreads();

    // logits: lane -> key, warp -> rows warp, warp + NW, ...
    for (int jc = 0; jc < tile; jc += 32) {
      const int j = jc + lane;
      if (j < tile) {
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
        const int pos = kt + j;
#pragma unroll
        for (int k = 0; k < QKK; ++k) {
          const int r = warp + NW * k;
          p_s[r * tile + j] = (pos <= length + query_of(r)) ? sc[k] : kMaskValue;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < rows; r += NW) {
      float* pr = p_s + r * tile;
      float mx = -INFINITY;
      for (int j = lane; j < tile; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_next = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < tile; j += 32) {
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
    if (pv_thread) {
#pragma unroll
      for (int k = 0; k < PVK; ++k) {
        const int r = rg + NRG * k;
        if (r < rows) {
          const float alpha = a_s[r];
          acc[k] = make_float4(acc[k].x * alpha, acc[k].y * alpha, acc[k].z * alpha,
                               acc[k].w * alpha);
        }
      }
      for (int j = 0; j < tile; ++j) {
        const float4 vv = reinterpret_cast<const float4*>(v_s + j * D)[c4];
#pragma unroll
        for (int k = 0; k < PVK; ++k) {
          const int r = rg + NRG * k;
          if (r < rows) acc[k] = fma4(p_s[r * tile + j], vv, acc[k]);
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < PVK; ++k) {
    const int r = rg + NRG * k;
    const int qi = q0 + r / rep;
    if (pv_thread && r < rows && qi < s_len) {
      const float l = l_s[r];
      const float inv = 1.f / (l == 0.f ? 1.f : l);
      const int head = hg * rep + r % rep;
      QT* o = out + ((size_t)(n * s_len + qi) * hq + head) * D + c4 * 4;
      o[0] = from_f32<QT>(acc[k].x * inv);
      o[1] = from_f32<QT>(acc[k].y * inv);
      o[2] = from_f32<QT>(acc[k].z * inv);
      o[3] = from_f32<QT>(acc[k].w * inv);
    }
  }
}

// Shared memory of the CUDA-core arm for key tiles of `tile` keys.
template <int D> size_t prefill_smem(int tile) {
  return sizeof(float) * ((size_t)tile * (D + 4) + (size_t)tile * D + (size_t)kPrefillRows * D +
                          (size_t)kPrefillRows * tile + 3 * (size_t)kPrefillRows);
}
constexpr size_t kMaxCtaSmem = 227 * 1024;  // a CTA's share of an H100 SM

template <typename QT, typename KT, int D>
int launch_prefill(const void* q, const void* pages_k, const void* pages_v,
                   const float* k_scales, const float* v_scales, const int* tables,
                   const int* lengths, void* out, int n, int s, int hq, int hkv, int page,
                   int num_p, float scale, cudaStream_t stream) {
  if (hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int gsplit = prefill_group_split(hq / hkv);
  const int rep = hq / hkv / gsplit;
  int block_q = kPrefillRows / rep;
  if (block_q > s) block_q = s;
  const int n_qb = (s + block_q - 1) / block_q;
  // a whole page a key tile, halved while its f32 tiles overflow the SM
  // (D 256 over pages of 128 keys: tiles of 64)
  int tile = page;
  while (prefill_smem<D>(tile) > kMaxCtaSmem && tile % 2 == 0) tile /= 2;
  const size_t smem = prefill_smem<D>(tile);
  auto kernel = paged_prefill_kernel<QT, KT, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_qb, hkv * gsplit, n), kPrefillThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(pages_k),
      static_cast<const KT*>(pages_v), k_scales, v_scales, tables, lengths,
      static_cast<QT*>(out), s, hq, hkv, gsplit, page, tile, num_p, block_q, scale);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kPrefillKeys = 64;     // keys of a K/V tile of the tensor-core arm
constexpr int kPrefillStages = 2;    // K/V stages in the ring
// one consumer warpgroup, then one producer warp that issues the TMA loads
constexpr int kPrefillTcThreads = kWarpgroup + 32;

// Page sizes whose 64-key tiles the tensor-core arm reads as whole boxes.
inline bool prefill_wgmma_page_ok(int page) {
  return page % kPrefillKeys == 0 || page == 8 || page == 16 || page == 32;
}

// Shared memory of the tensor-core arm, after a pad that lets the kernel
// align its tiles to the swizzle's 1024 bytes: the Q tile; for bf16 pages
// the K/V stages; for 1-byte pages the converted K and V tiles, then the
// stages of codes; each stage's per-key k- and v-scales; the ring's
// full/empty barriers and the Q barrier.
template <int D, typename KT> constexpr size_t prefill_wgmma_smem() {
  constexpr size_t tiles =
      sizeof(KT) == 2 ? (1 + 2 * kPrefillStages) * (size_t)tile_bytes<D>()
                      : 3 * (size_t)tile_bytes<D>() + kPrefillStages * 2 * (size_t)kPrefillKeys * D;
  return kSwizzleAlign + tiles + kPrefillStages * 2 * kPrefillKeys * sizeof(float) +
         (2 * kPrefillStages + 1) * sizeof(uint64_t);
}

// The consumer warpgroup's own barrier (named barrier 1; the producer warp
// takes no part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kWarpgroup) : "memory");
}

// Eight 1-byte codes (one 8-byte word) times their scale, as eight bf16
// packed in a uint4 (the codes convert exactly; the product rounds once).
__device__ __forceinline__ uint4 codes_to_bf16(uint2 w, float scale, int8_t) {
  uint32_t out[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t word = i < 2 ? w.x : w.y;
    const int sh = 16 * (i % 2);
    out[i] = pack_bf16(static_cast<float>(static_cast<int8_t>(word >> sh)) * scale,
                       static_cast<float>(static_cast<int8_t>(word >> (sh + 8))) * scale);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}
__device__ __forceinline__ uint4 codes_to_bf16(uint2 w, float scale, __nv_fp8_e4m3) {
  uint32_t out[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t word = i < 2 ? w.x : w.y;
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>((word >> (16 * (i % 2))) & 0xffffu), __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    out[i] = pack_bf16(f.x * scale, f.y * scale);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// The consumer warpgroup converts a stage of codes (NK rows of D bytes),
// each key's times its scale, into a bf16 tile in the swizzled panel
// layout (flash_wgmma.cuh): 16-byte chunk c of row r of panel p at
// p * kPanelBytes + r * 128 + ((c ^ (r % 8)) * 16).  It writes the D / 8
// chunks of a row only: at D 80 and 96 the last panel's chunks past D are
// zeroed once (zero_tile_pad) and never written again.
template <int D, typename KT>
__device__ __forceinline__ void convert_tile(uint32_t dst, const unsigned char* codes,
                                             const float* key_scales, int tid) {
  constexpr int CHUNKS = kPrefillKeys * D / 8;  // 8 codes -> one 16-byte bf16 chunk
#pragma unroll 4
  for (int e = tid; e < CHUNKS; e += kWarpgroup) {
    const int r = e / (D / 8), c = e % (D / 8);
    const uint4 v = codes_to_bf16(*reinterpret_cast<const uint2*>(codes + r * D + c * 8),
                                  key_scales[r], KT());
    const uint32_t at = dst + (c / 8) * kPanelBytes + r * 128 + (((c % 8) ^ (r % 8)) * 16);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(at), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
  }
}

// Zero the chunks past D of every row of a converted tile (D 80, 96).
template <int D>
__device__ __forceinline__ void zero_tile_pad(uint32_t dst, int tid) {
  constexpr int PAD = tile_cols<D>() / 8 - D / 8;  // 16-byte chunks past D a row
  if constexpr (PAD > 0) {
    for (int e = tid; e < kPrefillKeys * PAD; e += kWarpgroup) {
      const int r = e / PAD, c = D / 8 + e % PAD;
      const uint32_t at = dst + (c / 8) * kPanelBytes + r * 128 + (((c % 8) ^ (r % 8)) * 16);
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" :: "r"(at), "r"(0) : "memory");
    }
  }
}

// Two CTAs an SM; at D 256 one (its 160 KB of tiles, 128 accumulators a thread).
template <int D, typename KT>
__global__ void __launch_bounds__(kPrefillTcThreads, D > 128 ? 1 : 2)
paged_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const float* __restrict__ k_scales, const float* __restrict__ v_scales,
                           const int* __restrict__ tables, const int* __restrict__ lengths,
                           __nv_bfloat16* __restrict__ out, int s_len, int hq, int hkv,
                           int gsplit, int page, int num_pages, int num_p, int block_q,
                           float scale) {
  constexpr bool kCodes = sizeof(KT) == 1;     // quantized pages: TMA lands codes
  constexpr int TB = tile_bytes<D>();
  constexpr int NK = kPrefillKeys;
  constexpr int SB = kCodes ? NK * D : TB;     // bytes of one K or V stage
  constexpr float kLog2e = 1.4426950408889634f;
  // hg: the query-head group, of KV head h
  const int qb = blockIdx.x, hg = blockIdx.y, h = hg / gsplit, n = blockIdx.z;
  const int rep = hq / (hkv * gsplit), rows = block_q * rep, q0 = qb * block_q;
  const int tid = threadIdx.x;

  extern __shared__ unsigned char prefill_tc_smem[];
  const uint32_t smem0 = smem_u32(prefill_tc_smem);
  const uint32_t base = (smem0 + kSwizzleAlign - 1) & ~(kSwizzleAlign - 1u);
  const uint32_t q_s = base;
  // bf16 pages: the stages are the wgmma tiles; codes: two converted tiles,
  // then the stages
  const uint32_t kc_s = base + TB, vc_s = base + 2 * TB;
  const uint32_t stages = base + (kCodes ? 3 * TB : TB);
  auto k_s = [&](int st) { return stages + SB * (2 * st); };
  auto v_s = [&](int st) { return stages + SB * (2 * st + 1); };
  const uint32_t scales_at = stages + 2 * kPrefillStages * SB;
  // per stage: the k-scale of each of the tile's keys, then the v-scale
  float* scales = reinterpret_cast<float*>(prefill_tc_smem + (scales_at - smem0));
  auto ks_s = [&](int st) { return scales + st * 2 * NK; };
  auto vs_s = [&](int st) { return scales + st * 2 * NK + NK; };
  const uint32_t full0 = scales_at + kPrefillStages * 2 * NK * sizeof(float);
  auto full = [&](int st) { return full0 + 8 * st; };    // a stage's K/V and scales landed
  auto empty = [&](int st) { return full0 + 8 * (kPrefillStages + st); };  // the stage was read
  const uint32_t q_full = full0 + 8 * 2 * kPrefillStages;                   // Q landed

  const int length = lengths[n];
  // the last key any row of this block sees; tiles of keys 0 .. frontier
  const int frontier = length + min(q0 + block_q, s_len) - 1;
  const int n_kt = frontier / NK + 1;
  // a page is read iff its slot exists and its first key is visible to some row
  auto live = [&](int p) { return p < num_p && p * page <= frontier; };

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kPrefillStages; ++st) {
      mbar_init(full(st), 1 + 32);  // the producer's expect_tx, then each lane's scales
      mbar_init(empty(st), 1);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();  // the last CTA-wide barrier: the roles part here

  if (tid >= kWarpgroup) {
    // producer warp: lane 0 loads Q once, then every lane keeps up to
    // kPrefillStages K/V tiles in flight (lane 0 the TMA boxes, each lane
    // the scales of two keys)
    const int lane = tid - kWarpgroup;
    const int box_keys = min(page, NK);
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, tile_panels<D>() * rows * 128);
#pragma unroll
      for (int p = 0; p < tile_panels<D>(); ++p)
        tma_load_4d(q_s + p * kPanelBytes, &tm_q, q_full, p * kPanelCols, hg * rep, q0, n);
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % kPrefillStages, round = kt / kPrefillStages;
      if (round > 0) mbar_wait(empty(st), (round - 1) & 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(full(st), 2 * SB);
        for (int i = 0; i < NK / box_keys; ++i) {
          const int key0 = kt * NK + i * box_keys, p = key0 / page;
          // past the frontier (or the table): a box past the last page, zeros
          const int pid = live(p) ? tables[n * num_p + p] : num_pages;
          if constexpr (kCodes) {
            const uint32_t dst = i * box_keys * D;
            tma_load_4d(k_s(st) + dst, &tm_k, full(st), 0, h, key0 % page, pid);
            tma_load_4d(v_s(st) + dst, &tm_v, full(st), 0, h, key0 % page, pid);
          } else {
#pragma unroll
            for (int c = 0; c < tile_panels<D>(); ++c) {
              const uint32_t dst = c * kPanelBytes + i * box_keys * 128;
              tma_load_4d(k_s(st) + dst, &tm_k, full(st), c * kPanelCols, h, key0 % page, pid);
              tma_load_4d(v_s(st) + dst, &tm_v, full(st), c * kPanelCols, h, key0 % page, pid);
            }
          }
        }
      }
#pragma unroll
      for (int j = lane; j < NK; j += 32) {
        const int p = (kt * NK + j) / page;
        const bool on = live(p);
        const long long at = on ? (long long)tables[n * num_p + p] * hkv + h : 0;
        // a dead slot's keys are masked: scales of one keep 0 * scale finite
        ks_s(st)[j] = on ? k_scales[at] : 1.f;
        vs_s(st)[j] = on ? v_scales[at] : 1.f;
      }
      mbar_arrive(full(st));
    }
    return;
  }

  // consumer warpgroup: rows 16 w + g + 8 e (e = 0, 1) of the q-block
  const int w = tid / 32, g = (tid % 32) / 4, c2 = 2 * (tid % 4);
  int last[2];  // the last key row e sees
  float m[2], l[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = 16 * w + g + 8 * e;
    last[e] = length + min(q0 + r / rep, s_len - 1);
    m[e] = -INFINITY;
    l[e] = 0.f;
  }
  float o[tile_cols<D>() / 2], s[32];
#pragma unroll
  for (int i = 0; i < tile_cols<D>() / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  if constexpr (kCodes) {
    // the first tile's convert fences these stores for wgmma and syncs
    zero_tile_pad<D>(kc_s, tid);
    zero_tile_pad<D>(vc_s, tid);
  }

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kPrefillStages, k0 = kt * NK;
    mbar_wait(full(st), (kt / kPrefillStages) & 1);
    uint32_t kt_s = k_s(st), vt_s = v_s(st);
    if constexpr (kCodes) {
      // every consumer's products of the last tile are complete (each
      // thread waited on its wgmma), so the converted tiles may be rewritten
      consumers_sync();
      convert_tile<D, KT>(kc_s, prefill_tc_smem + (k_s(st) - smem0), ks_s(st), tid);
      convert_tile<D, KT>(vc_s, prefill_tc_smem + (v_s(st) - smem0), vs_s(st), tid);
      fence_proxy_async();  // the generic-proxy stores, seen by wgmma's async proxy
      consumers_sync();
      kt_s = kc_s;
      vt_s = vc_s;
    }
    wgmma_fence();
    mma_rows_by_rows<D>(s, q_s, kt_s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // s[4i + 2e + j] is (row 16 w + g + 8 e, key k0 + 8 i + c2 + j); a key
    // past a row's position is masked (only a tile past the block's first
    // query can hold one)
    const bool masked = k0 + NK - 1 > length + q0;
    // bf16 pages: the key's k-scale after Q.K^T and its v-scale on P; codes:
    // the scales are already in the converted tiles
    const float* ks = ks_s(st);
    const float* vs = vs_s(st);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kl = 8 * i + c2 + j;
        const float ksc = kCodes ? scale : ks[kl] * scale;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[4 * i + 2 * e + j] * ksc;
          if (masked && k0 + kl > last[e]) x = kMaskValue;
          s[4 * i + 2 * e + j] = x;
          mx[e] = fmaxf(mx[e], x);
        }
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
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int e = i % 2;                   // registers 2i, 2i + 1 share row 16 w + g + 8 e
      const int kl = 8 * (i / 2) + c2;       // ... and keys kl, kl + 1
      const float p0 = ex2_approx((s[2 * i] - m[e]) * kLog2e);
      const float p1 = ex2_approx((s[2 * i + 1] - m[e]) * kLog2e);
      sum[e] += p0 + p1;
      pk[i] = kCodes ? pack_bf16(p0, p1) : pack_bf16(p0 * vs[kl], p1 * vs[kl + 1]);
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
    mma_probs_by_tile<D>(o, pk, vt_s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    // the warpgroup's products (and its reads of the scales, which fed
    // them) that used stage st are complete
    if (tid == 0) mbar_arrive(empty(st));
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = 16 * w + g + 8 * e, qi = q0 + r / rep;
    if (r >= rows || qi >= s_len) continue;
    const float inv = 1.f / (l[e] == 0.f ? 1.f : l[e]);
    __nv_bfloat16* o_row = out + ((size_t)(n * s_len + qi) * hq + hg * rep + r % rep) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * i + c2) =
          __floats2bfloat162_rn(o[4 * i + 2 * e] * inv, o[4 * i + 2 * e + 1] * inv);
  }
}

template <int D, typename KT>
int launch_prefill_wgmma(const void* q, const void* pages_k, const void* pages_v,
                         const float* k_scales, const float* v_scales, const int* tables,
                         const int* lengths, void* out, int n, int s, int hq, int hkv, int page,
                         int num_pages, int num_p, float scale, cudaStream_t stream) {
  const int gsplit = prefill_group_split(hq / hkv);
  const int rep = hq / hkv / gsplit;
  int block_q = kPrefillRows / rep;
  if (block_q > s) block_q = s;
  CUtensorMap tm_q, tm_k, tm_v;
  const int box_keys = page < kPrefillKeys ? page : kPrefillKeys;
  cudaError_t err = make_panel_tensor_map(&tm_q, q, n, s, hq, D, rep, block_q);
  if constexpr (sizeof(KT) == 2) {
    if (err == cudaSuccess)
      err = make_panel_tensor_map(&tm_k, pages_k, num_pages, page, hkv, D, 1, box_keys);
    if (err == cudaSuccess)
      err = make_panel_tensor_map(&tm_v, pages_v, num_pages, page, hkv, D, 1, box_keys);
  } else {
    if (err == cudaSuccess)
      err = make_byte_tensor_map(&tm_k, pages_k, num_pages, page, hkv, D, box_keys);
    if (err == cudaSuccess)
      err = make_byte_tensor_map(&tm_v, pages_v, num_pages, page, hkv, D, box_keys);
  }
  const size_t smem = prefill_wgmma_smem<D, KT>();
  auto kernel = paged_prefill_wgmma_kernel<D, KT>;
  if (err == cudaSuccess) err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qb = (s + block_q - 1) / block_q;
  kernel<<<dim3(n_qb, hkv * gsplit, n), kPrefillTcThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, k_scales, v_scales, tables, lengths, static_cast<__nv_bfloat16*>(out), s,
      hq, hkv, gsplit, page, num_pages, num_p, block_q, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace atpu

#define ATPU_LAUNCH_PREFILL(QT, KT, D)                                                  \
  atpu::launch_prefill<QT, KT, D>(q, pages_k, pages_v, k_scales, v_scales, tables,      \
                                  lengths, out, n, s, hq, hkv, page, num_p, scale,       \
                                  static_cast<cudaStream_t>(stream))
#define ATPU_LAUNCH_PREFILL_WGMMA(D, KT)                                                  \
  atpu::launch_prefill_wgmma<D, KT>(q, pages_k, pages_v, k_scales, v_scales, tables,      \
                                    lengths, out, n, s, hq, hkv, page, num_pages, num_p,   \
                                    scale, static_cast<cudaStream_t>(stream))

// The tensor-core arms: bf16, int8 and fp8-e4m3 pages, at D 64, 80, 96, 128
// and 256.
#define ATPU_WGMMA_PAGES(D)                                                              \
  if (kv_fmt == 1) return ATPU_LAUNCH_PREFILL_WGMMA(D, __nv_bfloat16);                   \
  if (kv_fmt == 2) return ATPU_LAUNCH_PREFILL_WGMMA(D, int8_t);                          \
  if (kv_fmt == 3) return ATPU_LAUNCH_PREFILL_WGMMA(D, __nv_fp8_e4m3);

// tensor_cores = 1 asks for the tensor-core arm, which takes bf16 q over
// bf16, int8 or fp8-e4m3 pages, D 64, 80, 96, 128 or 256, any GQA group
// and a page that prefill_wgmma_page_ok accepts; the entry point refuses
// anything else rather than run another arm.  kv_fmt: 0 f32, 1 bf16, 2 int8,
// 3 fp8-e4m3.
extern "C" int atpu_paged_prefill(const void* q, const void* pages_k, const void* pages_v,
                                  const float* k_scales, const float* v_scales,
                                  const int* tables, const int* lengths, void* out, int n,
                                  int s, int hq, int hkv, int d, int page, int num_pages,
                                  int num_p, int q_bf16, int kv_fmt, int tensor_cores,
                                  float scale, void* stream) {
  if (tensor_cores) {
    if (!q_bf16 || !atpu::prefill_wgmma_page_ok(page) || hq % hkv != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if (d == 128) {
      ATPU_WGMMA_PAGES(128)
    } else if (d == 64) {
      ATPU_WGMMA_PAGES(64)
    } else if (d == 256) {
      ATPU_WGMMA_PAGES(256)
    } else if (d == 96) {
      ATPU_WGMMA_PAGES(96)
    } else if (d == 80) {
      ATPU_WGMMA_PAGES(80)
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ATPU_DISPATCH(q_bf16, kv_fmt, d, ATPU_LAUNCH_PREFILL);
}

extern "C" const char* atpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
