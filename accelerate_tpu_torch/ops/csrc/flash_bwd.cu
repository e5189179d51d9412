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
// bytes each; the tensor cores bound both.
//
// K4: each (batch, kv-head, q-block of 64 folded rows, group part) walks the
// k-tiles up to its causal frontier with Q, dO, lse and delta resident and
// the dQ accumulator in registers.  The f32 arm runs one CTA per q-block,
// the bf16 arm two consecutive q-blocks per CTA.
//   bf16 arm (flash_dq_wgmma_kernel): the tensor cores, K3's arrangement
//   with the dQ algebra.  A CTA holds two consumer warpgroups, each owning
//   one q-block (wgmma's M), and one producer warp that loads each
//   warpgroup's Q and dO once by TMA (one box per panel that is the folded
//   q-block itself, zeros past Sq) and then streams the K/V tiles through a
//   ring of three stages.  Per k-tile S = Q.K^T and dP = dO.V^T are wgmma
//   products from shared memory; p = exp(S * scale - lse) and ds are formed
//   in registers (a thread holds 2 rows x 16 keys, its rows' lse and delta
//   read once), and dS, rounded to bf16 in place, is the register A operand
//   of dQ += dS.K with the same K tile read MN-major, as K3 reads V for
//   P.V: no transposed copy of K.  A warpgroup whose causal walk is shorter
//   than its partner's keeps releasing the stages it does not use.  When
//   rep does not divide 64 the tiles' spare rows are never written: a row
//   of dQ reads only its own Q and dO rows, and a spare row is never stored.
//   At D 256 the CTA holds one consumer warpgroup and two stages (128 dQ
//   accumulators beside S and dP need most of a thread's 255 registers).
//   f32 arm (flash_dq_kernel): 256 threads on the CUDA cores, every product
//   register-tiled from f32 shared tiles, so that f32 inputs keep f32
//   products (TF32 keeps ~3 decimal digits); at D 256 K and V stream in two
//   column chunks of 128.
//
// K5: each (batch, kv-head, k-tile of 64 keys) keeps K, V and the dk/dv
// accumulators resident and walks the q-blocks (and each one's group parts)
// from the first one that can see the tile; a q-block's rows hold the query
// heads of the GQA group, so dk and dv accumulate unexpanded over the group
// as at :331-348.  The f32 arm runs one CTA per k-tile, the bf16 arm two
// consecutive k-tiles per CTA.
//   bf16 arm (flash_dkv_wgmma_kernel): the tensor cores, FlashAttention-3's
//   arrangement.  A CTA holds two consumer warpgroups, each owning one k-tile
//   of 64 keys, and a producer warpgroup (setmaxnreg hands its registers to
//   the consumers).  The keys are wgmma's M, so S^T = K.Q^T and dP^T =
//   V.dO^T come out with a thread holding 2 keys x 16 rows, and P^T and
//   dS^T, rounded to bf16 in place, are exactly the register A operands of
//   dV += P^T.dO and dK += dS^T.Q, with dO and Q read MN-major as they are
//   stored.  K and V stay in swizzled bf16 shared tiles, which the
//   producer loads once by TMA (one box of 64 keys per panel, zeros past
//   Sk), and the f32 dK/dV accumulators stay in registers across the whole
//   walk.  The producer's first warp then streams the q-blocks through a
//   ring of three stages: Q and
//   dO by TMA, one box per panel that is the folded q-block itself (rep
//   heads x block_q queries of the [B, Sq, Hq, D] tensor, zeros past Sq),
//   and each row's lse, delta, query and segment id stored by its lanes;
//   full/empty mbarriers let the two warpgroups run out of step.  Left for
//   later: a fused backward (dQ from the same CTA), persistent CTAs.  At
//   D 256 a warpgroup cannot hold a k-tile's dK and dV (256 accumulators a
//   thread): both warpgroups take the same k-tile, each computes its S^T
//   and dP^T and accumulates dK/dV for 128 of the 256 columns (two stages).
//   f32 arm (flash_dkv_kernel): 256 threads on the CUDA cores, as K4's, so
//   that f32 inputs keep f32 products; at D 256 Q and dO stream in four
//   column chunks of 64.
//   Head dims that fill no whole 64-column panel (16, 32, 80, 96) run on
//   zero-padded panels in the bf16 arms (flash_wgmma.cuh) and mask their
//   last column group in the f32 arms.
#include <type_traits>

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

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
    segk[j] = (seg && key[j] < sh.sk) ? sh.kseg[(long long)b * sh.kseg_stride + key[j]] : 0;
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

// The f32 arms keep f32 tiles of row stride D + 4 in shared memory: 66.5 KB
// per 64 rows at D 256, so K4's four such tiles and K5's would overflow the
// SM's 227 KB.  At D 256 the tiles that stream (K4's K and V, K5's Q and
// dO) are held a column chunk at a time (K4 two of 128 columns, K5 four of
// 64), the products summed over the chunks; below, a chunk is all of D.
template <int D> __host__ __device__ constexpr int dq_chunk() { return D > 128 ? 128 : D; }
template <int D> __host__ __device__ constexpr int dkv_chunk() { return D > 128 ? 64 : D; }

// Float4 column groups per thread (tx + 16 c), and whether group tx + 16 c
// lies inside D (always, unless D / 4 is no multiple of 16: D 16, 32, 80, 96).
template <int D> __host__ __device__ constexpr int col_groups() { return (D / 4 + 15) / 16; }
template <int D> __device__ __forceinline__ bool in_d(int tx, int c) {
  return (D / 4) % 16 == 0 || tx + 16 * c < D / 4;
}

// Element offset of row r's column chunk starting at c0, or -1 (zero fill).
template <typename RowOffset>
__device__ __forceinline__ auto chunk_rows(RowOffset row_offset, int c0) {
  return [=](int r) {
    const long long off = row_offset(r);
    return off < 0 ? off : off + c0;
  };
}

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ seg,
                T* __restrict__ dq, FlashShape sh, float scale) {
  constexpr int QS = D + 4;
  constexpr int CPT = col_groups<D>();
  constexpr int DC = dq_chunk<D>(), NCH = D / DC;  // K/V column chunks
  constexpr int KS = DC + 4;
  constexpr int CPC = NCH == 1 ? CPT : DC / 64;     // a thread's column groups of a chunk
  const int qb = blockIdx.x / sh.parts, part = blockIdx.x % sh.parts;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  extern __shared__ float4 flash_smem[];
  float* q_s = reinterpret_cast<float*>(flash_smem);  // kRows x QS
  float* do_s = q_s + kRows * QS;                     // kRows x QS
  float* k_s = do_s + kRows * QS;                     // kKeys x KS: a chunk of K
  float* v_s = k_s + kKeys * KS;                      // kKeys x KS: a chunk of V
  float* ds_s = v_s + kKeys * KS;                     // kRows x kPStride

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
    auto load_kv = [&](int ch) {
      __syncthreads();  // the previous tile's (or chunk's) readers are done
      load_rows<T, DC>(k_s, KS, k, kKeys, chunk_rows(kv_row, ch * DC));
      load_rows<T, DC>(v_s, KS, v, kKeys, chunk_rows(kv_row, ch * DC));
      __syncthreads();
    };

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      load_kv(ch);
      tile_dot_cols<DC, QS, KS>(s, q_s + ch * DC, k_s, ty, tx);
      tile_dot_cols<DC, QS, KS>(dp, do_s + ch * DC, v_s, ty, tx);
    }
    probs_and_ds(s, dp, rs, k0, tx, seg, b, sh, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ds_s[(ty + 16 * i) * kPStride + tx + 16 * j] = round_to<T>(dp[i][j]);
    __syncthreads();

    // dq += ds . K: rows ty + 16 i, float4 columns tx + 16 c, a chunk at a
    // time, the resident last chunk first
#pragma unroll
    for (int ch = NCH - 1; ch >= 0; --ch) {
      if (ch != NCH - 1) load_kv(ch);
#pragma unroll 4
      for (int kk = 0; kk < kKeys; ++kk) {
        float4 kv[CPC];
#pragma unroll
        for (int c = 0; c < CPC; ++c)
          kv[c] = in_d<D>(tx, c) ? *reinterpret_cast<const float4*>(k_s + kk * KS + (tx + 16 * c) * 4)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float d = ds_s[(ty + 16 * i) * kPStride + kk];
#pragma unroll
          for (int c = 0; c < CPC; ++c)
            acc[i][ch * CPC + c] = fma4(d, kv[c], acc[i][ch * CPC + c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long off = fr.offset(b, ty + 16 * i, D);
    if (off < 0) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      if (!in_d<D>(tx, c)) continue;
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
  constexpr int CPT = col_groups<D>();
  constexpr int DC = dkv_chunk<D>(), NCH = D / DC;  // Q/dO column chunks
  constexpr int RS = DC + 4;
  constexpr int CPC = NCH == 1 ? CPT : DC / 64;      // a thread's column groups of a chunk
  const int kb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = kb * kKeys;

  extern __shared__ float4 flash_smem[];
  float* k_s = reinterpret_cast<float*>(flash_smem);  // kKeys x QS
  float* v_s = k_s + kKeys * QS;                      // kKeys x QS
  float* q_s = v_s + kKeys * QS;                      // kRows x RS: a chunk of Q
  float* do_s = q_s + kRows * RS;                     // kRows x RS: a chunk of dO
  float* p_s = do_s + kRows * RS;                     // kRows x kPStride
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
    auto load_q = [&](int ch) {
      __syncthreads();  // the previous q-block's (or chunk's) readers are done
      load_rows<T, DC>(q_s, RS, q, kRows, chunk_rows(q_row, ch * DC));
      load_rows<T, DC>(do_s, RS, dout, kRows, chunk_rows(q_row, ch * DC));
      __syncthreads();
    };
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

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      load_q(ch);
      tile_dot_cols<DC, RS, QS>(s, q_s, k_s + ch * DC, ty, tx);
      tile_dot_cols<DC, RS, QS>(dp, do_s, v_s + ch * DC, ty, tx);
    }
    probs_and_ds(s, dp, rs, k0, tx, seg, b, sh, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p_s[(ty + 16 * i) * kPStride + tx + 16 * j] = round_to<T>(s[i][j]);
        ds_s[(ty + 16 * i) * kPStride + tx + 16 * j] = round_to<T>(dp[i][j]);
      }
    __syncthreads();

    // dv += p^T . dO and dk += ds^T . q: keys ty + 16 i, float4 columns
    // tx + 16 c, a chunk at a time, the resident last chunk first
#pragma unroll
    for (int ch = NCH - 1; ch >= 0; --ch) {
      if (ch != NCH - 1) load_q(ch);
#pragma unroll 2
      for (int r = 0; r < kRows; ++r) {
        float4 dov[CPC], qv[CPC];
#pragma unroll
        for (int c = 0; c < CPC; ++c) {
          const bool in = in_d<D>(tx, c);
          const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
          dov[c] = in ? *reinterpret_cast<const float4*>(do_s + r * RS + (tx + 16 * c) * 4) : zero;
          qv[c] = in ? *reinterpret_cast<const float4*>(q_s + r * RS + (tx + 16 * c) * 4) : zero;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = p_s[r * kPStride + ty + 16 * i];
          const float d = ds_s[r * kPStride + ty + 16 * i];
#pragma unroll
          for (int c = 0; c < CPC; ++c) {
            dv_acc[i][ch * CPC + c] = fma4(p, dov[c], dv_acc[i][ch * CPC + c]);
            dk_acc[i][ch * CPC + c] = fma4(d, qv[c], dk_acc[i][ch * CPC + c]);
          }
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
      if (!in_d<D>(tx, c)) continue;
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

constexpr int kDkvGroups = 2;  // consumer warpgroups of a CTA, one k-tile each
// the consumer warpgroups, then a producer warpgroup whose first warp
// issues the TMA loads and fills in each q-block's statistics
constexpr int kDkvThreads = (kDkvGroups + 1) * kWarpgroup;
constexpr int kDkvConsumerRegs = 240, kDkvProducerRegs = 24;
static_assert(kDkvGroups * kWarpgroup * kDkvConsumerRegs + kWarpgroup * kDkvProducerRegs <= 65536,
              "the register file");
// At D 256 a warpgroup cannot hold a k-tile's dK and dV (256 f32
// accumulators a thread, past the 255 registers a thread may have): the two
// warpgroups then share one k-tile and split its columns, each computing
// the tile's S^T and dP^T and accumulating dK/dV for its 128 columns.
template <int D> __host__ __device__ constexpr bool dkv_split() { return D > 128; }
// K/V tiles the CTA holds (one pair a k-tile), its Q/dO stages (three, or
// two at D 256: 32 KB tiles), and the columns of dK/dV a warpgroup owns.
template <int D> __host__ __device__ constexpr int dkv_tiles() {
  return dkv_split<D>() ? 1 : kDkvGroups;
}
template <int D> __host__ __device__ constexpr int dkv_stages() { return D > 128 ? 2 : 3; }
template <int D> __host__ __device__ constexpr int dkv_cols() {
  return dkv_split<D>() ? tile_cols<D>() / kDkvGroups : tile_cols<D>();
}

// Shared memory of the bf16 arm of K5: the K and V tiles, the Q/dO stages,
// each stage's per-row statistics, the ring's full/empty barriers, one
// barrier per K/V pair, and a pad to align the tiles to the swizzle's 1024
// bytes.
template <int D> constexpr size_t dkv_wgmma_smem() {
  return kSwizzleAlign + (2 * dkv_tiles<D>() + 2 * dkv_stages<D>()) * (size_t)tile_bytes<D>() +
         dkv_stages<D>() * 4 * (size_t)kRows * sizeof(float) +
         (2 * dkv_stages<D>() + dkv_tiles<D>()) * sizeof(uint64_t);
}

template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const int* __restrict__ seg, __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, FlashShape sh, float scale) {
  constexpr int TB = tile_bytes<D>();
  constexpr bool kSplit = dkv_split<D>();
  constexpr int KVT = dkv_tiles<D>(), kDkvStages = dkv_stages<D>(), NC = dkv_cols<D>();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / kWarpgroup, t = tid % kWarpgroup;

  extern __shared__ unsigned char flash_tc_smem[];
  const uint32_t base = (smem_u32(flash_tc_smem) + kSwizzleAlign - 1) & ~(kSwizzleAlign - 1u);
  auto q_s = [&](int st) { return base + TB * (2 * KVT + 2 * st); };
  auto do_s = [&](int st) { return base + TB * (2 * KVT + 2 * st + 1); };
  // per stage and folded row: lse, delta, query and its segment id (a row
  // past the sequence holds zeros: its Q and dO rows are zero, so its s is
  // 0, its p at most 1 and its dp and ds 0, and it adds nothing to dK or dV)
  const uint32_t stats_u32 = base + TB * (2 * KVT + 2 * kDkvStages);
  float* stats = reinterpret_cast<float*>(flash_tc_smem + (stats_u32 - smem_u32(flash_tc_smem)));
  auto stat = [&](int st, int which) { return stats + (st * 4 + which) * kRows; };
  const uint32_t full0 = stats_u32 + kDkvStages * 4 * kRows * sizeof(float);
  auto full = [&](int st) { return full0 + 8 * st; };  // a stage's Q, dO and statistics landed
  auto empty = [&](int st) { return full0 + 8 * (kDkvStages + st); };  // both groups are done
  auto kv_full = [&](int i) { return full0 + 8 * (2 * kDkvStages + i); };  // K/V pair i landed
  // K/V pair i's k-tile (split: the one tile of both warpgroups)
  auto tile_k0 = [&](int i) { return (KVT * blockIdx.x + (kSplit ? 0 : i)) * kKeys; };

  // queries before a tile's first key see none of it: each warpgroup starts
  // at the q-block holding its k0 (the CTA at its first warpgroup's); every
  // part of the group of each q-block, in a fixed order
  const int n_qb = (sh.sq + sh.block_q - 1) / sh.block_q;
  const int n_it = n_qb * sh.parts;
  auto first = [&](int kt0) { return (sh.causal ? min(kt0 / sh.block_q, n_qb) : 0) * sh.parts; };
  const int it0 = first(tile_k0(0));
  const int rows = sh.rep * sh.block_q;  // folded rows a q-block's box fills

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kDkvStages; ++st) {
      mbar_init(full(st), 1 + 32);  // the producer's expect_tx, then each lane's statistics
      mbar_init(empty(st), kDkvGroups);
    }
#pragma unroll
    for (int i = 0; i < KVT; ++i) mbar_init(kv_full(i), 1);
    mbar_init_fence();
  }
  if (rows < kRows && wg < kDkvGroups) {
    // the box of a q-block fills `rows` rows of a tile; the rest stay zero
    constexpr int P = tile_panels<D>();
    const int chunks = (kRows - rows) * 8;
    const int total = kDkvStages * 2 * P * chunks;
    for (int e = tid; e < total; e += kDkvGroups * kWarpgroup) {
      const int tile = e / chunks / P, p = e / chunks % P;
      const int c = e % chunks;
      const uint32_t addr = base + TB * (2 * KVT + tile) + p * kPanelBytes +
                            (rows + c / 8) * 128 + (c % 8) * 16;
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" :: "r"(addr), "r"(0) : "memory");
    }
    fence_proxy_async();
  }
  __syncthreads();  // the last CTA-wide barrier: the roles part here

  if (wg == kDkvGroups) {
    regs_dealloc<kDkvProducerRegs>();
    if (t >= 32) return;
    if (t == 0) {
      // each K/V pair's tiles (none for a k-tile past the keys, whose
      // warpgroup walks no q-block)
#pragma unroll
      for (int i = 0; i < KVT; ++i) {
        if (tile_k0(i) >= sh.sk) continue;
        mbar_arrive_expect_tx(kv_full(i), 2 * TB);
#pragma unroll
        for (int p = 0; p < tile_panels<D>(); ++p) {
          const int col = p * kPanelCols;
          tma_load_4d(base + TB * i + p * kPanelBytes, &tm_k, kv_full(i), col, h, tile_k0(i), b);
          tma_load_4d(base + TB * (KVT + i) + p * kPanelBytes, &tm_v, kv_full(i), col, h,
                      tile_k0(i), b);
        }
      }
    }
    for (int it = it0; it < n_it; ++it) {
      const int st = (it - it0) % kDkvStages, round = (it - it0) / kDkvStages;
      if (round > 0) mbar_wait(empty(st), (round - 1) & 1);
      const FoldedRows fr = folded_rows(sh, it / sh.parts, it % sh.parts, h);
      if (t == 0) {
        mbar_arrive_expect_tx(full(st), 2 * tile_panels<D>() * rows * 128);
#pragma unroll
        for (int p = 0; p < tile_panels<D>(); ++p) {
          const int col = p * kPanelCols;
          tma_load_4d(q_s(st) + p * kPanelBytes, &tm_q, full(st), col, fr.head0, fr.q0, b);
          tma_load_4d(do_s(st) + p * kPanelBytes, &tm_do, full(st), col, fr.head0, fr.q0, b);
        }
      }
#pragma unroll
      for (int r = t; r < kRows; r += 32) {
        const bool valid = fr.valid(r);
        const int qi = fr.query(r);
        stat(st, 0)[r] = valid ? lse[fr.stat(b, r)] : 0.f;
        stat(st, 1)[r] = valid ? delta[fr.stat(b, r)] : 0.f;
        reinterpret_cast<int*>(stat(st, 2))[r] = qi;
        reinterpret_cast<int*>(stat(st, 3))[r] = seg ? seg[(long long)b * sh.seg_stride + qi] : 0;
      }
      mbar_arrive(full(st));
    }
    return;
  }

  regs_alloc<kDkvConsumerRegs>();
  const int w = t / 32, g = (t % 32) / 4, c2 = 2 * (t % 4);
  const int kv = kSplit ? 0 : wg;                    // this warpgroup's K/V pair
  const int k0 = tile_k0(kv);                        // ... and k-tile
  const int my_it0 = k0 < sh.sk ? first(k0) : n_it;  // a k-tile past the keys does nothing
  const uint32_t k_s = base + TB * kv, v_s = base + TB * (KVT + kv);
  // the first of the NC dK/dV columns this warpgroup owns, and its panel offset
  const int col0 = kSplit ? wg * NC : 0;
  const uint32_t col_off = (col0 / kPanelCols) * kPanelBytes;

  // the thread's keys k0 + 16 w + g + 8 e (e = 0, 1): rows of S^T and dK/dV
  int key[2], segk[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    key[e] = k0 + 16 * w + g + 8 * e;
    segk[e] = (seg && key[e] < sh.sk) ? sh.kseg[(long long)b * sh.kseg_stride + key[e]] : 0;
  }
  float dk_acc[NC / 2], dv_acc[NC / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  if (k0 < sh.sk) mbar_wait(kv_full(kv), 0);

  for (int it = it0; it < n_it; ++it) {
    const int st = (it - it0) % kDkvStages;
    mbar_wait(full(st), ((it - it0) / kDkvStages) & 1);
    if (it >= my_it0) {
      wgmma_fence();
      mma_rows_by_rows<D>(s, k_s, q_s(st));    // S^T = K . Q^T
      mma_rows_by_rows<D>(dp, v_s, do_s(st));  // dP^T = V . dO^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // s[4i + 2e + j] is (key[e], folded row 8 i + c2 + j); p and ds
      // replace s and dp, rounded to bf16 and packed as the next products'
      // A operands
      const int q0 = (it / sh.parts) * sh.block_q;
      const bool masked = seg || k0 + kKeys > sh.sk || (sh.causal && k0 + kKeys - 1 > q0);
      const float* ls = stat(st, 0);
      const float* dl = stat(st, 1);
      const int* qs = reinterpret_cast<const int*>(stat(st, 2));
      const int* sgs = reinterpret_cast<const int*>(stat(st, 3));
      uint32_t pp[16], pd[16];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = 8 * i + c2 + j, idx = 4 * i + 2 * e + j;
            float x = s[idx] * scale;
            if (masked) {
              if (key[e] >= sh.sk) {
                x = -INFINITY;
              } else if ((sh.causal && key[e] > qs[n]) || (seg && segk[e] != sgs[n])) {
                x = kFlashMask;
              }
            }
            const float p = __expf(x - ls[n]);
            s[idx] = p;
            dp[idx] = p * (dp[idx] - dl[n]) * scale;
          }
          // p rounded to dO's dtype (:346), ds to q's (:342)
          pp[2 * i + e] = pack_bf16(s[4 * i + 2 * e], s[4 * i + 2 * e + 1]);
          pd[2 * i + e] = pack_bf16(dp[4 * i + 2 * e], dp[4 * i + 2 * e + 1]);
        }

      wgmma_fence();
      mma_probs_by_panels<NC>(dv_acc, pp, do_s(st) + col_off);  // dV += P^T . dO
      mma_probs_by_panels<NC>(dk_acc, pd, q_s(st) + col_off);   // dK += dS^T . Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    // the warpgroup's products that read stage st are complete
    if (t == 0) mbar_arrive(empty(st));
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const long long off = kv_offset(b, key[e], h, sh, D) + col0;
    if (off < col0) continue;
    if (sh.out_f32) {
      float* dk32 = reinterpret_cast<float*>(dk);
      float* dv32 = reinterpret_cast<float*>(dv);
#pragma unroll
      for (int i = 0; i < (kSplit ? NC : D) / 8; ++i) {
        *reinterpret_cast<float2*>(dk32 + off + 8 * i + c2) =
            make_float2(dk_acc[4 * i + 2 * e], dk_acc[4 * i + 2 * e + 1]);
        *reinterpret_cast<float2*>(dv32 + off + 8 * i + c2) =
            make_float2(dv_acc[4 * i + 2 * e], dv_acc[4 * i + 2 * e + 1]);
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < (kSplit ? NC : D) / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * i + c2) =
          __floats2bfloat162_rn(dk_acc[4 * i + 2 * e], dk_acc[4 * i + 2 * e + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * i + c2) =
          __floats2bfloat162_rn(dv_acc[4 * i + 2 * e], dv_acc[4 * i + 2 * e + 1]);
    }
  }
}

// Consumer warpgroups of a CTA, one q-block each, and K/V stages in the
// ring: two and three, or one and two at D 256 (32 KB tiles, and 128 dQ
// accumulators a thread beside S and dP: a lone consumer warpgroup may take
// all 255 registers a thread can have).
template <int D> __host__ __device__ constexpr int dq_groups() { return D > 128 ? 1 : 2; }
template <int D> __host__ __device__ constexpr int dq_stages() { return D > 128 ? 2 : 3; }
// the consumer warpgroups, then one producer warp that issues the TMA loads
template <int D> __host__ __device__ constexpr int dq_threads() {
  return dq_groups<D>() * kWarpgroup + 32;
}

// Shared memory of the bf16 arm of K4: each warpgroup's Q and dO tiles, the
// K/V stages, the ring's full/empty barriers and one barrier per
// warpgroup's Q/dO, after a pad that lets the kernel align its tiles to the
// swizzle's 1024 bytes.
template <int D> constexpr size_t dq_wgmma_smem() {
  return kSwizzleAlign + (2 * dq_groups<D>() + 2 * dq_stages<D>()) * (size_t)tile_bytes<D>() +
         (2 * dq_stages<D>() + dq_groups<D>()) * sizeof(uint64_t);
}

template <int D>
__global__ void __launch_bounds__(dq_threads<D>(), 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                      const float* __restrict__ delta, const int* __restrict__ seg,
                      __nv_bfloat16* __restrict__ dq, FlashShape sh, float scale) {
  constexpr int TB = tile_bytes<D>();
  constexpr int kDqGroups = dq_groups<D>(), kDqStages = dq_stages<D>();
  constexpr float kLog2e = 1.4426950408889634f;
  const int pair = blockIdx.x / sh.parts, part = blockIdx.x % sh.parts;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / kWarpgroup, t = tid % kWarpgroup;

  extern __shared__ unsigned char flash_tc_smem[];
  const uint32_t base = (smem_u32(flash_tc_smem) + kSwizzleAlign - 1) & ~(kSwizzleAlign - 1u);
  auto q_s = [&](int i) { return base + TB * i; };
  auto do_s = [&](int i) { return base + TB * (kDqGroups + i); };
  auto k_s = [&](int st) { return base + TB * (2 * kDqGroups + 2 * st); };
  auto v_s = [&](int st) { return base + TB * (2 * kDqGroups + 2 * st + 1); };
  const uint32_t full0 = base + TB * (2 * kDqGroups + 2 * kDqStages);  // K/V of a stage landed
  const uint32_t empty0 = full0 + 8 * kDqStages;    // both warpgroups are done with a stage
  const uint32_t q_full0 = empty0 + 8 * kDqStages;  // a warpgroup's Q and dO landed
  auto full = [&](int st) { return full0 + 8 * st; };
  auto empty = [&](int st) { return empty0 + 8 * st; };
  auto q_full = [&](int i) { return q_full0 + 8 * i; };

  // warpgroup wg owns q-block qb; the CTA streams the K/V tiles of the
  // longer walk of its two q-blocks
  int n_kb = 0;
#pragma unroll
  for (int i = 0; i < kDqGroups; ++i)
    n_kb = max(n_kb, q_block_tiles(sh, kDqGroups * pair + i, part, h));

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kDqStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kDqGroups);
    }
#pragma unroll
    for (int i = 0; i < kDqGroups; ++i) mbar_init(q_full(i), 1);
    mbar_init_fence();
  }
  __syncthreads();  // the last CTA-wide barrier: the roles part here

  if (wg == kDqGroups) {
    // producer: one thread loads each warpgroup's Q and dO tiles (none for
    // a q-block past the sequence, whose warpgroup walks no tile), then
    // keeps up to kDqStages K/V tiles in flight
    if (t != 0) return;
#pragma unroll
    for (int i = 0; i < kDqGroups; ++i) {
      const int qb = kDqGroups * pair + i;
      if (q_block_tiles(sh, qb, part, h) == 0) continue;
      const FoldedRows fr = folded_rows(sh, qb, part, h);
      mbar_arrive_expect_tx(q_full(i), 2 * tile_panels<D>() * fr.rows * 128);
#pragma unroll
      for (int p = 0; p < tile_panels<D>(); ++p) {
        const int col = p * kPanelCols;
        tma_load_4d(q_s(i) + p * kPanelBytes, &tm_q, q_full(i), col, fr.head0, fr.q0, b);
        tma_load_4d(do_s(i) + p * kPanelBytes, &tm_do, q_full(i), col, fr.head0, fr.q0, b);
      }
    }
    for (int kb = 0; kb < n_kb; ++kb) {
      const int st = kb % kDqStages, round = kb / kDqStages;
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

  // consumer warpgroup wg: rows 16 w + g + 8 e (e = 0, 1) of q-block qb,
  // the same rows for the whole walk, so their statistics live in registers
  const int w = t / 32, g = (t % 32) / 4, c2 = 2 * (t % 4);
  const int qb = kDqGroups * pair + wg;
  const FoldedRows fr = folded_rows(sh, qb, part, h);
  const int my_kb = q_block_tiles(sh, qb, part, h);

  int qi[2], segq[2];
  float lse2[2], dl[2];  // lse in log2 units, delta; 0 for a row that is never stored
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = 16 * w + g + 8 * e;
    const bool valid = fr.valid(r);
    qi[e] = fr.query(r);
    segq[e] = seg ? seg[(long long)b * sh.seg_stride + qi[e]] : 0;
    lse2[e] = valid ? lse[fr.stat(b, r)] * kLog2e : 0.f;
    dl[e] = valid ? delta[fr.stat(b, r)] : 0.f;
  }
  float acc[tile_cols<D>() / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < tile_cols<D>() / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  const float scale_log2 = scale * kLog2e;

  if (my_kb > 0) mbar_wait(q_full(wg), 0);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int st = kb % kDqStages, k0 = kb * kKeys;
    mbar_wait(full(st), (kb / kDqStages) & 1);
    if (kb < my_kb) {
      wgmma_fence();
      mma_rows_by_rows<D>(s, q_s(wg), k_s(st));    // S = Q . K^T
      mma_rows_by_rows<D>(dp, do_s(wg), v_s(st));  // dP = dO . V^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // s[4i + 2e + j] is (row 16 w + g + 8 e, key k0 + 8 i + c2 + j); p
      // from the saved lse, then ds, which replaces s, rounded to k's
      // dtype (:303) and packed as the A operand of dS . K
      const bool masked = seg || k0 + kKeys > sh.sk || (sh.causal && k0 + kKeys - 1 > fr.q0);
      uint32_t pk[16];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int idx = 4 * i + 2 * e + j;
            float p;
            if (masked) {
              const int key = k0 + 8 * i + c2 + j;
              const int segk = (seg && key < sh.sk) ? sh.kseg[(long long)b * sh.kseg_stride + key] : 0;
              float x = s[idx] * scale;
              if (key >= sh.sk) {
                x = -INFINITY;  // past the sequence: not a key at all
              } else if ((sh.causal && key > qi[e]) || (seg && segk != segq[e])) {
                x = kFlashMask;
              }
              p = ex2_approx(fmaf(x, kLog2e, -lse2[e]));
            } else {
              p = ex2_approx(fmaf(s[idx], scale_log2, -lse2[e]));
            }
            s[idx] = p * (dp[idx] - dl[e]) * scale;
          }
          pk[2 * i + e] = pack_bf16(s[4 * i + 2 * e], s[4 * i + 2 * e + 1]);
        }

      // dQ += dS . K, the same K tile read MN-major (the depth is its keys)
      wgmma_fence();
      mma_probs_by_tile<D>(acc, pk, k_s(st));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    // the warpgroup's products that read stage st are complete
    if (t == 0) mbar_arrive(empty(st));
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const long long off = fr.offset(b, 16 * w + g + 8 * e, D);
    if (off < 0) continue;
    if (sh.out_f32) {
      float* dq32 = reinterpret_cast<float*>(dq);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<float2*>(dq32 + off + 8 * i + c2) =
            make_float2(acc[4 * i + 2 * e], acc[4 * i + 2 * e + 1]);
      continue;
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dq + off + 8 * i + c2) =
          __floats2bfloat162_rn(acc[4 * i + 2 * e], acc[4 * i + 2 * e + 1]);
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, const int* seg, void* dq, int b, const FlashShape& sh,
              float scale, cudaStream_t stream) {
  const int n_qb = (sh.sq + sh.block_q - 1) / sh.block_q;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    CUtensorMap tm_q, tm_do, tm_k, tm_v;
    cudaError_t err = make_panel_tensor_map(&tm_q, q, b, sh.sq, sh.hq, D, sh.rep, sh.block_q);
    if (err == cudaSuccess)
      err = make_panel_tensor_map(&tm_do, dout, b, sh.sq, sh.hq, D, sh.rep, sh.block_q);
    if (err == cudaSuccess) err = make_panel_tensor_map(&tm_k, k, b, sh.sk, sh.hkv, D, 1, kKeys);
    if (err == cudaSuccess) err = make_panel_tensor_map(&tm_v, v, b, sh.sk, sh.hkv, D, 1, kKeys);
    const size_t smem = dq_wgmma_smem<D>();
    auto kernel = flash_dq_wgmma_kernel<D>;
    if (err == cudaSuccess) err = flash_allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n_qb + dq_groups<D>() - 1) / dq_groups<D>() * sh.parts, sh.hkv, b);
    kernel<<<grid, dq_threads<D>(), smem, stream>>>(tm_q, tm_do, tm_k, tm_v, lse, delta, seg,
                                               static_cast<T*>(dq), sh, scale);
  } else {
    const size_t smem = sizeof(float) * (2 * (size_t)kRows * (D + 4) +
                                         2 * (size_t)kKeys * (dq_chunk<D>() + 4) +
                                         (size_t)kRows * kPStride);
    auto kernel = flash_dq_kernel<T, D>;
    cudaError_t err = flash_allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(n_qb * sh.parts, sh.hkv, b), kFlashThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, seg, static_cast<T*>(dq), sh, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* seg, void* dk, void* dv, int b,
               const FlashShape& sh, float scale, cudaStream_t stream) {
  const int n_kb = (sh.sk + kKeys - 1) / kKeys;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    CUtensorMap tm_q, tm_do, tm_k, tm_v;
    cudaError_t err = make_panel_tensor_map(&tm_q, q, b, sh.sq, sh.hq, D, sh.rep, sh.block_q);
    if (err == cudaSuccess)
      err = make_panel_tensor_map(&tm_do, dout, b, sh.sq, sh.hq, D, sh.rep, sh.block_q);
    if (err == cudaSuccess) err = make_panel_tensor_map(&tm_k, k, b, sh.sk, sh.hkv, D, 1, kKeys);
    if (err == cudaSuccess) err = make_panel_tensor_map(&tm_v, v, b, sh.sk, sh.hkv, D, 1, kKeys);
    const size_t smem = dkv_wgmma_smem<D>();
    auto kernel = flash_dkv_wgmma_kernel<D>;
    if (err == cudaSuccess) err = flash_allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n_kb + dkv_tiles<D>() - 1) / dkv_tiles<D>(), sh.hkv, b);
    kernel<<<grid, kDkvThreads, smem, stream>>>(tm_q, tm_do, tm_k, tm_v, lse, delta, seg,
                                                static_cast<T*>(dk), static_cast<T*>(dv), sh,
                                                scale);
  } else {
    const size_t smem = sizeof(float) * (2 * (size_t)kKeys * (D + 4) +
                                         2 * (size_t)kRows * (dkv_chunk<D>() + 4) +
                                         2 * (size_t)kRows * kPStride);
    auto kernel = flash_dkv_kernel<T, D>;
    cudaError_t err = flash_allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(n_kb, sh.hkv, b), kFlashThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, seg, static_cast<T*>(dk), static_cast<T*>(dv),
        sh, scale);
  }
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
                             const float* lse, const float* delta, const int* seg,
                             const int* kseg, void* dq, int b, int sq, int sk, int hq, int hkv,
                             int d, int seg_stride, int kseg_stride, int causal, int bf16,
                             int out_f32, float scale, void* stream) {
  if (!atpu::flash_shape_ok(b, sq, sk, hq, hkv)) return static_cast<int>(cudaErrorInvalidValue);
  atpu::FlashShape sh = atpu::flash_shape(sq, sk, hq, hkv, seg_stride, causal, seg, kseg,
                                          kseg_stride);
  sh.out_f32 = out_f32;
  ATPU_FLASH_DISPATCH(bf16, d, ATPU_LAUNCH_DQ);
}

extern "C" int atpu_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, const int* seg,
                              const int* kseg, void* dk, void* dv, int b, int sq, int sk, int hq,
                              int hkv, int d, int seg_stride, int kseg_stride, int causal,
                              int bf16, int out_f32, float scale, void* stream) {
  if (!atpu::flash_shape_ok(b, sq, sk, hq, hkv)) return static_cast<int>(cudaErrorInvalidValue);
  atpu::FlashShape sh = atpu::flash_shape(sq, sk, hq, hkv, seg_stride, causal, seg, kseg,
                                          kseg_stride);
  sh.out_f32 = out_f32;
  ATPU_FLASH_DISPATCH(bf16, d, ATPU_LAUNCH_DKV);
}

extern "C" const char* atpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
