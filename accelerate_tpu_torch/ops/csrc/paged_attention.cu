// K1 - paged decode attention for Hopper (sm_90a), split across CTAs.
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
// r % S, any number of rows.  Q.K^T and P.V run in f32 from the page dtype, q
// is scaled by D^-0.5 before the product (:294), masked logits take the
// finite DEFAULT_MASK_VALUE, the softmax is the online one in f32, and the
// output is acc / l with l == 0 taken as 1.  The tree-mask arm (:300-315),
// for speculative tree verification, swaps the causal rule for token-tree
// visibility: the S queries are tree nodes at slots lengths[n] + i, and
// node i sees every key j < lengths[n] plus the tree nodes whose bits are
// set in its uint32 ancestor word (bit j: node j, S <= 32).  The words are
// data - a device array of S words, null for the causal arm - so one build
// serves every topology.  Pages are f32, bf16 or - the
// dequant arm (:291) - int8 or fp8-e4m3 codes with one f32 scale per (page,
// kv-head): the k-scale multiplies a key's logit after the product and the
// v-scale its probability before P.V, which equals scaling the page first.
//
// What bounds it on an H100.  A decode step reads every live K/V byte of
// every lane once and does 4 * D flops per (row, key): about 2 flops per
// byte for bf16 pages at one row, 8 at a GQA group of four, below the ~20
// flop/byte at which the CUDA cores' f32 rate would become the limit.  The
// bound is bytes: live K/V bytes at 3.35 TB/s.  So the design is about
// moving bytes, in four parts.
//
// 1. The KV walk is split across CTAs (flash-decoding).  The grid is
//    (kv-head, lane, split); split z walks the pages [z * pps, (z + 1) *
//    pps) of the lane's table.  pps comes from the host (paged_attention.py
//    decode_split_plan) from the table width, lanes, kv heads and SM count,
//    never from the lengths, so planning never syncs the card; at the
//    serving path's shapes it is one page.  A split that starts past the
//    lane's live pages, (lengths[n] + S - 1) / page + 1 (:285-287), exits
//    before it reads anything; slots past them hold the null page or a
//    previous owner's id and are never read.  A lane whose live pages fit
//    one split writes its output directly.  Otherwise each split writes its
//    partial (m, l, acc) in f32 to scratch the wrapper allocates, and the
//    last of the lane's working splits to arrive (a per-(lane, kv-head)
//    counter) merges the partials in split order and sets the counter back
//    to zero: one launch per call, no atomics on the output, bit-for-bit
//    repeatable.
// 2. Tiles stay in the page dtype.  K and V sit in shared memory as stored
//    (bf16 stays bf16) and are converted to f32 in registers at use: a
//    bf16 stage of 32 keys at D 128 is 17 KB, the CTA 54 KB at one row,
//    so four CTAs share an SM.
// 3. Keys are in flight while others are computed.  A split's keys stream
//    through a ring of three stages of 32 keys, each filled by 16-byte
//    cp.async copies straight from the pages (any page size: each key row
//    is found through the table, its page id read a tile ahead), so two
//    stages are in flight while the third is computed; only the keys up to
//    lengths[n] + S - 1 are copied.
// 4. Rows come in blocks of four (kDecodeRows), one CTA per block: the
//    grid's first dimension is (kv-head, row block).  Each lane keeps a
//    row's accumulator in registers (4 x D / 32 values), so four CTAs share
//    an SM; a call of more folded rows (a GQA group of 8 verifying 4 drafts
//    is 40) walks its keys once per block, the blocks' CTAs side by side,
//    rather than hold every row in one CTA and spill or lose occupancy
//    (wider CTAs were slower at every row count tried, PERF.md §6).  Rows
//    are independent, so the blocking changes no bit of the output.
// 5. Quantized pages ride
//    the same ring: a page row is D bytes instead of 2D, copied by the same
//    16-byte cp.async, and its codes are converted to f32 in registers at
//    use (int8 by a sign-extending convert, e4m3 through cvt.rn.f16x2.e4m3x2;
//    both exact); the scales are staged per key beside the tile.  The bytes
//    a step reads halve against bf16.
// 6. Every thread works at one row.  Each of the four warps takes 8 of a
//    stage's 32 keys: for Q.K^T four lanes share a key, each summing a
//    quarter of D, and for P.V the 32 lanes split D, so a warp keeps its
//    own running (m, l, acc) over its keys.  At the end of the split the
//    four warps' states merge through shared memory, in warp order.  The
//    products stay on the CUDA cores in f32: the bound is bytes, and the
//    TPU kernel computes in f32.
//
// 7. Head dims 16 to 256 (16, 32, 64, 80, 96, 128, 256).  A key row is D
//    elements, 16-byte chunks of it copied by the threads that a whole
//    number of rows' chunks keeps busy (at D 80 and 96 the chunks do not
//    divide the 128 threads: the spare ones copy nothing).  Q.K^T's pieces
//    split over a key's four lanes unevenly where they must (D 80: ten bf16
//    pieces, five int8); P.V's columns run in contiguous vectors a lane
//    where D / 32 is a power of two, else interleaved (column lane + 32 c,
//    those past D masked).  At D 256 a stage of f32 rows is 65 KB and the
//    CTA 205 KB: one CTA an SM for f32 pages, two for bf16.
//
// What limits it (PERF.md §6): each CTA's walk is latency-bound, a tile of
// 32 keys waiting microseconds for its copies, so the bytes in flight per
// SM (the ring times the CTAs that fit) set the rate.  On an H100 a deeper
// ring, 64-key stages, whole-row bulk copies (cp.async.bulk) and, as a
// timing experiment, tiles read as if the pool were head-major were none
// of them faster at the serving shapes.
#include "paged_common.cuh"

namespace atpu {

constexpr int kDecodeThreads = 128;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kDecodeTileKeys = 32;  // keys per ring stage: 8 per warp
constexpr int kDecodeWarpKeys = kDecodeTileKeys / kDecodeWarps;
constexpr int kDecodeKeyLanes = 32 / kDecodeWarpKeys;  // lanes summing one key's Q.K
constexpr int kDecodeStages = 3;
constexpr int kDecodeRows = 4;  // folded rows one CTA holds: a row block
constexpr int kDecodeMaxSplits = 64;

// A compile-time tag for the mask arm of K1's softmax (causal or tree).
template <bool B>
struct Arm {
  static constexpr bool value = B;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Unpack one 32-bit word of page elements to f32 (every conversion is exact).
template <typename T> struct Words;
template <> struct Words<float> {
  static constexpr int kPerWord = 1;
  __device__ static void unpack(unsigned w, float* o) { o[0] = __uint_as_float(w); }
};
template <> struct Words<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  __device__ static void unpack(unsigned w, float* o) {
    o[0] = __uint_as_float(w << 16);
    o[1] = __uint_as_float(w & 0xffff0000u);
  }
};
template <> struct Words<int8_t> {
  static constexpr int kPerWord = 4;
  __device__ static void unpack(unsigned w, float* o) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = static_cast<float>(static_cast<int8_t>(w >> (8 * i)));
  }
};
template <> struct Words<__nv_fp8_e4m3> {
  static constexpr int kPerWord = 4;
  __device__ static void unpack(unsigned w, float* o) {
    const __half2_raw lo = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), __NV_E4M3);
    const __half2_raw hi = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3);
    const float2 a = __half22float2(__half2(lo)), b = __half22float2(__half2(hi));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
};

// N consecutive page elements from shared memory, as f32 (one 4-, 8- or
// 16-byte load, p aligned to its width; fewer than 4 bytes one by one).
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&o)[N]) {
  if constexpr (N * sizeof(T) < 4) {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = to_f32(p[i]);
  } else {
    constexpr int W = N / Words<T>::kPerWord;
    unsigned w[W];
    if constexpr (W > 4) {  // f32 at D 256: two or more 16-byte loads
#pragma unroll
      for (int i = 0; i < W / 4; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[i];
        w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
      }
    } else if constexpr (W == 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (W == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const unsigned*>(p);
    }
#pragma unroll
    for (int i = 0; i < W; ++i) Words<T>::unpack(w[i], o + i * Words<T>::kPerWord);
  }
}

// Shared-memory layout of one CTA, in bytes, for gs <= kDecodeRows folded rows.
template <typename KT, int D>
struct DecodeSmem {
  static constexpr int kRow = D * (int)sizeof(KT) + 16;  // padded key row: no bank conflicts
  static constexpr int kStage = 2 * kDecodeTileKeys * kRow;  // K tile, then V tile
  // after the walk the ring holds the merge's rows [gs][D] and (m, l)
  // [splits][gs][2]: at small D or 1-byte pages the ring is sized for them
  static constexpr int kMerge =
      (int)sizeof(float) * (kDecodeRows * D + 2 * kDecodeMaxSplits * kDecodeRows);
  static constexpr int kRing =
      kDecodeStages * kStage > kMerge ? kDecodeStages * kStage : kMerge;
  static __host__ __device__ size_t bytes(int gs) {
    return (size_t)kRing + sizeof(float) * ((size_t)kDecodeStages * 2 * kDecodeTileKeys +
                                            (size_t)gs * D + 2 * kDecodeWarps * (size_t)gs +
                                            2 * (size_t)gs);
  }
};

// One CTA: split z of (kv-head h, row block rb, lane n), four CTAs an SM.
template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kDecodeThreads, 4)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ pages_k,
                    const KT* __restrict__ pages_v, const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales, const int* __restrict__ tables,
                    const int* __restrict__ lengths, QT* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ counters,
                    const unsigned* __restrict__ tree_words, int s_len, int hq,
                    int hkv, int page, int num_p, int pps, int nsplit, float scale) {
  using L = DecodeSmem<KT, D>;
  constexpr int NT = kDecodeThreads, TK = kDecodeTileKeys, WK = kDecodeWarpKeys;
  constexpr int EPC = 16 / sizeof(KT);   // page elements per 16-byte chunk
  constexpr int CPR = D / EPC;           // chunks per key row (a row is >= 16 bytes)
  constexpr int KL = kDecodeKeyLanes;
  // Q.K^T: each of a key's KL lanes sums the pieces t, t + KL, ... of PE
  // elements (a 16-byte chunk, or a quarter of a short row); where the
  // pieces do not split evenly over the KL lanes (D 80 and 96 over bf16 or
  // 1-byte pages: 10, 5 or 6 pieces) the last round takes only the first
  // lanes, and no lane reads past its key's row
  constexpr int PE = EPC < D / KL ? EPC : D / KL;
  constexpr int NPC = D / PE;                  // pieces of a key row
  constexpr int PPL = (NPC + KL - 1) / KL;     // pieces per lane, the last maybe absent
  // P.V: the 32 lanes split D.  A power-of-two share runs in contiguous
  // runs of VPL columns (one vector load; D 16: half the lanes); D 80 and
  // 96 (2.5 and 3 columns a lane) interleave: column lane + 32 c, the
  // columns past D (D 80: c = 2 on lanes 16-31) masked
  constexpr int VPL = D >= 32 ? (D + 31) / 32 : 1;
  constexpr bool kStrided = D >= 32 && (D % 32 != 0 || (VPL & (VPL - 1)) != 0);
  // threads that copy: each owns one chunk column of RPT key rows, RSTEP
  // rows apart (at D 80 and 96 the chunks of a row do not divide the 128
  // threads: the spare threads copy nothing, the last round of rows is short)
  constexpr int RSTEP = NT / CPR < TK ? NT / CPR : TK;
  constexpr int COPIERS = RSTEP * CPR;
  static_assert(RSTEP >= 1 && PE % 4 == 0 && D % PE == 0 && D % 16 == 0, "tile shape");

  const int gs_all = (hq / hkv) * s_len;  // folded rows of the kv head
  const int nrb = (gs_all + kDecodeRows - 1) / kDecodeRows;
  // one row block (decode at rep <= 4) takes no division: the divisions cost
  // 2-4 % of a short CTA's time (PERF.md §6)
  const int h = nrb == 1 ? (int)blockIdx.x : blockIdx.x / nrb;
  const int rb = nrb == 1 ? 0 : blockIdx.x % nrb, n = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rep = hq / hkv;
  const int r0 = rb * kDecodeRows;                      // the block's first row
  const int gs = min(kDecodeRows, gs_all - r0);         // the last block is ragged
  const int rows_per_block = min(kDecodeRows, gs_all);  // the partials' row stride
  const int length = lengths[n];
  const int live = min((length + s_len - 1) / page + 1, num_p);
  if (z * pps >= live) return;  // a split past the lane's live pages reads nothing
  const int nsl = (live + pps - 1) / pps;  // the lane's working splits
  const int k0 = z * pps * page;
  const int k1 = min(k0 + pps * page, min(length + s_len, live * page));
  const int ntiles = (k1 - k0 + TK - 1) / TK;

  extern __shared__ float4 smem4[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4);
  float* sc = reinterpret_cast<float*>(ring + L::kRing);  // [stage][k | v][TK] page scales
  float* q_s = sc + kDecodeStages * 2 * TK;               // [gs][D] scaled q
  float* mw = q_s + gs * D;                               // [warp][gs] running max
  float* lw = mw + kDecodeWarps * gs;                     // [warp][gs] denominator
  float* row_m = lw + kDecodeWarps * gs;                  // [gs] the CTA's max
  float* row_l = row_m + gs;                              // [gs] the CTA's denominator
  __shared__ int is_last;

  // Copying a tile of the split into a stage (nothing past k1): each of the
  // COPIERS threads owns one 16-byte column of RPT key rows, RSTEP rows
  // apart.  The rows' page ids are read from the table a tile ahead of
  // their copies, so no copy waits on a table read.
  constexpr int RPT = (TK + RSTEP - 1) / RSTEP;
  const int col = tid % CPR, row0 = tid / CPR;
  const bool copier = COPIERS == NT || tid < COPIERS;  // all threads for rows >= 64 bytes
  const bool scaled = k_scales != nullptr;  // no scales: native pages, ones
  // a row of the stage: always, unless the rows do not divide into RSTEP runs
  auto in_tile = [&](int row) { return TK % RSTEP == 0 || row < TK; };
  auto fetch = [&](int tile, int (&ids)[RPT]) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = row0 + i * RSTEP, key = k0 + tile * TK + row;
      ids[i] = copier && in_tile(row) && key < k1
                   ? __ldg(tables + (size_t)n * num_p + key / page) : 0;
    }
  };
  auto issue = [&](int tile, int st, const int (&ids)[RPT]) {
    unsigned char* kdst = ring + st * L::kStage;
    unsigned char* vdst = kdst + TK * L::kRow;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = row0 + i * RSTEP, key = k0 + tile * TK + row;
      if (copier && in_tile(row) && key < k1) {
        const size_t off = (((size_t)ids[i] * page + key % page) * hkv + h) * D + col * EPC;
        cp_async16(kdst + row * L::kRow + col * 16, pages_k + off);
        cp_async16(vdst + row * L::kRow + col * 16, pages_v + off);
        if (scaled && col == 0) {
          sc[st * 2 * TK + row] = __ldg(k_scales + (size_t)ids[i] * hkv + h);
          sc[st * 2 * TK + TK + row] = __ldg(v_scales + (size_t)ids[i] * hkv + h);
        }
      }
    }
    cp_async_commit();
  };

  {  // the first tiles' page ids and q, every load in flight before their use
    int ids[kDecodeStages - 1][RPT];
#pragma unroll
    for (int st = 0; st < kDecodeStages - 1; ++st) fetch(st, ids[st]);
    constexpr int QPT = (kDecodeRows * D + NT - 1) / NT;
    float qv[QPT];
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int e = tid + i * NT, r = r0 + e / D, c = e % D;
      const int head = h * rep + r / s_len, qi = r % s_len;
      qv[i] = e < gs * D ? to_f32(q[((size_t)(n * s_len + qi) * hq + head) * D + c]) : 0.f;
    }
#pragma unroll
    for (int st = 0; st < kDecodeStages - 1; ++st) issue(st, st, ids[st]);
#pragma unroll
    for (int i = 0; i < QPT; ++i)
      if (tid + i * NT < gs * D) q_s[tid + i * NT] = qv[i] * scale;
  }
  int ids[RPT];
  fetch(kDecodeStages - 1, ids);

  // lane = t * WK + g: key g of the warp's WK, share t of its pieces
  const int g = lane % WK, t = lane / WK;
  const bool pv_lane = D >= 32 || lane < D;  // every lane from D 32 up
  float m_reg = -INFINITY, l_reg = 0.f;  // row `lane`'s running max and denominator
  float acc[kDecodeRows][VPL];
#pragma unroll
  for (int r = 0; r < kDecodeRows; ++r)
#pragma unroll
    for (int c = 0; c < VPL; ++c) acc[r][c] = 0.f;

  const int qi0 = r0 == 0 ? 0 : r0 % s_len;  // the query of the block's first row
  // The tree-mask arm: row r of the block is node (r0 + r) % S of its head,
  // so its ancestor word follows the query, not the row; each row's word is
  // loaded once into shared memory (the first tile's barrier publishes it).
  const bool tree = tree_words != nullptr;
  __shared__ unsigned row_word[kDecodeRows];
  if (tree && tid < gs) row_word[tid] = __ldg(tree_words + (r0 + tid) % s_len);
  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<kDecodeStages - 2>();
    __syncthreads();  // the tile has landed; the stage refilled below is consumed
    issue(tile + kDecodeStages - 1, (tile + kDecodeStages - 1) % kDecodeStages, ids);
    fetch(tile + kDecodeStages, ids);  // lands while this tile is computed

    const int st = tile % kDecodeStages;
    const int mine = min(TK, k1 - k0 - tile * TK) - warp * WK;  // this warp's keys
    if (mine <= 0) continue;
    const int jl = warp * WK + g;
    const bool valid = g < mine;
    const int pos = k0 + tile * TK + jl;
    const unsigned char* krow = ring + st * L::kStage + jl * L::kRow;
    const unsigned char* vtile = ring + st * L::kStage + TK * L::kRow;

    // Q.K^T: the KL lanes of a key sum interleaved shares of its pieces
    float s[kDecodeRows];
#pragma unroll
    for (int r = 0; r < kDecodeRows; ++r) s[r] = 0.f;
    if (valid) {
#pragma unroll
      for (int ci = 0; ci < PPL; ++ci) {
        const int c = t + KL * ci;
        if (NPC % KL != 0 && c >= NPC) break;  // the short last round
        float kf[PE];
        load_f32<KT, PE>(reinterpret_cast<const KT*>(krow) + c * PE, kf);
#pragma unroll
        for (int r = 0; r < kDecodeRows; ++r) {
          if (r < gs) {
            const float4* qp = reinterpret_cast<const float4*>(q_s + r * D + c * PE);
#pragma unroll
            for (int v = 0; v < PE / 4; ++v) {
              const float4 qq = qp[v];
              s[r] = fmaf(qq.x, kf[4 * v], s[r]);
              s[r] = fmaf(qq.y, kf[4 * v + 1], s[r]);
              s[r] = fmaf(qq.z, kf[4 * v + 2], s[r]);
              s[r] = fmaf(qq.w, kf[4 * v + 3], s[r]);
            }
          }
        }
      }
    }
    const float k_scale = scaled ? sc[st * 2 * TK + jl] : 1.f;
    const float v_scale = scaled ? sc[st * 2 * TK + TK + jl] : 1.f;

    // the warp's online softmax over its keys, row by row.  The mask: the
    // causal arm's key pos is visible to query qi iff pos <= length + qi;
    // the tree arm's iff it is history (pos < length) or tree node j = pos -
    // length whose bit j the row's word sets (keys past length + S are never
    // walked, and a word has no bit past S - 1).  The arm is a grid-uniform
    // branch around the whole row loop, so the causal arm runs the code it
    // ran before the tree arm existed.
    auto softmax = [&](auto arm) {
      constexpr bool kTree = decltype(arm)::value;
      int qi = qi0;
#pragma unroll
      for (int r = 0; r < kDecodeRows; ++r) {
        if (r < gs) {
          float x = s[r];
#pragma unroll
          for (int o = WK; o < 32; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
          bool seen;
          if constexpr (kTree) {
            const unsigned node = static_cast<unsigned>(pos - length);
            seen = pos < length || (node < 32u && ((row_word[r] >> node) & 1u));
          } else {
            seen = pos <= length + qi;
          }
          x = !valid ? -INFINITY : (seen ? x * k_scale : kMaskValue);
          float mx = x;
#pragma unroll
          for (int o = 1; o < WK; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_old = __shfl_sync(0xffffffffu, m_reg, r);
          const float l_old = __shfl_sync(0xffffffffu, l_reg, r);
          const float m_new = fmaxf(m_old, mx);
          const float p = valid ? expf(x - m_new) : 0.f;
          float sum = p;
#pragma unroll
          for (int o = 1; o < WK; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
          const float alpha = expf(m_old - m_new);
          if (lane == r) {
            m_reg = m_new;
            l_reg = alpha * l_old + sum;
          }
#pragma unroll
          for (int c = 0; c < VPL; ++c) acc[r][c] *= alpha;
          s[r] = p * v_scale;
          if (++qi == s_len) qi = 0;
        }
      }
    };
    if (tree) {
      softmax(Arm<true>{});
    } else {
      softmax(Arm<false>{});
    }

    // P.V: the 32 lanes split D (at D 16 the first 16 lanes, a column
    // each); key jj's probabilities come from lane jj
    const int nk = min(mine, WK);
#pragma unroll
    for (int jj = 0; jj < WK; ++jj) {
      if (jj < nk) {
        float vf[VPL];
        const KT* vrow = reinterpret_cast<const KT*>(vtile + (warp * WK + jj) * L::kRow);
        if constexpr (kStrided) {
#pragma unroll
          for (int c = 0; c < VPL; ++c)
            vf[c] = lane + 32 * c < D ? to_f32(vrow[lane + 32 * c]) : 0.f;
        } else if (pv_lane) {
          load_f32<KT, VPL>(vrow + lane * VPL, vf);
        } else {
#pragma unroll
          for (int c = 0; c < VPL; ++c) vf[c] = 0.f;
        }
#pragma unroll
        for (int r = 0; r < kDecodeRows; ++r) {
          if (r < gs) {
            const float p = __shfl_sync(0xffffffffu, s[r], jj);
#pragma unroll
            for (int c = 0; c < VPL; ++c) acc[r][c] = fmaf(p, vf[c], acc[r][c]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups can be left; the ring becomes the merge's

  // merge the four warps' states, in warp order
  if (lane < gs) {
    mw[warp * gs + lane] = m_reg;
    lw[warp * gs + lane] = l_reg;
  }
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [gs][D]
#pragma unroll
  for (int r = 0; r < kDecodeRows; ++r) {
    if (r < gs) {
      float m = mw[r];
      for (int w = 1; w < kDecodeWarps; ++w) m = fmaxf(m, mw[w * gs + r]);
      const float wt = expf(mw[warp * gs + r] - m);  // 0 for a warp that saw no key
#pragma unroll
      for (int c = 0; c < VPL; ++c) acc[r][c] *= wt;
    }
  }
  if (tid < gs) {
    float m = mw[tid];
    for (int w = 1; w < kDecodeWarps; ++w) m = fmaxf(m, mw[w * gs + tid]);
    float l = 0.f;
    for (int w = 0; w < kDecodeWarps; ++w) l += expf(mw[w * gs + tid] - m) * lw[w * gs + tid];
    row_m[tid] = m;
    row_l[tid] = l;
  }
  for (int w = 0; w < kDecodeWarps; ++w) {
    if (warp == w && pv_lane) {
#pragma unroll
      for (int r = 0; r < kDecodeRows; ++r) {
        if (r < gs) {
#pragma unroll
          for (int c = 0; c < VPL; ++c) {
            const int column = kStrided ? lane + 32 * c : lane * VPL + c;
            if (kStrided && column >= D) continue;
            float* dst = red + r * D + column;
            *dst = (w == 0 ? 0.f : *dst) + acc[r][c];
          }
        }
      }
    }
    __syncthreads();
  }

  auto store = [&](int e, float v, float l) {
    const int r = r0 + e / D, c = e % D;
    const int head = h * rep + r / s_len, qi = r % s_len;
    out[((size_t)(n * s_len + qi) * hq + head) * D + c] = from_f32<QT>(v / (l == 0.f ? 1.f : l));
  };
  if (nsl == 1) {  // the lane's only split: no partials, no counter
    for (int e = tid; e < gs * D; e += NT) store(e, red[e], row_l[e / D]);
    return;
  }

  // partials: acc [n][h][rb][split][gs][D], then (m, l) [n][h][rb][split][gs][2],
  // each (lane, kv-head, row block) at a stride of rows_per_block rows
  const size_t lane_head = ((size_t)n * hkv + h) * nrb + rb;
  const size_t acc_total = (size_t)gridDim.y * gridDim.x * nsplit * rows_per_block * D;
  float* p_acc = part + (lane_head * nsplit) * rows_per_block * D;
  float* p_ml = part + acc_total + (lane_head * nsplit) * rows_per_block * 2;
  for (int e = tid; e < gs * D; e += NT) p_acc[(size_t)z * gs * D + e] = red[e];
  if (tid < gs) {
    p_ml[((size_t)z * gs + tid) * 2] = row_m[tid];
    p_ml[((size_t)z * gs + tid) * 2 + 1] = row_l[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + lane_head, 1) == nsl - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last split to arrive merges all of them, in split order; every
  // partial is read in one parallel sweep, not split after split
  float* ml = red + gs * D;  // [split][gs] (m, l); m becomes the split's weight
  for (int e = tid; e < nsl * gs * 2; e += NT) ml[e] = __ldcg(p_ml + e);
  __syncthreads();
  if (tid < gs) {
    float m = -INFINITY;
    for (int i = 0; i < nsl; ++i) m = fmaxf(m, ml[(i * gs + tid) * 2]);
    float l = 0.f;
    for (int i = 0; i < nsl; ++i) {
      float* mi = ml + (i * gs + tid) * 2;
      mi[0] = expf(mi[0] - m);
      l = fmaf(mi[0], mi[1], l);
    }
    row_l[tid] = l;
  }
  __syncthreads();
  for (int e = tid; e < gs * D; e += NT) {
    const int r = e / D;
    float a = 0.f;
#pragma unroll 8
    for (int i = 0; i < nsl; ++i)
      a = fmaf(ml[(i * gs + r) * 2], __ldcg(p_acc + (size_t)i * gs * D + e), a);
    store(e, a, row_l[r]);
  }
  if (tid == 0) counters[lane_head] = 0;  // every working split has arrived
}

template <typename QT, typename KT, int D>
int launch_decode(const void* q, const void* pages_k, const void* pages_v,
                  const float* k_scales, const float* v_scales, const int* tables,
                  const int* lengths, void* out, float* part, int* counters,
                  const unsigned* tree_words, int n, int s, int hq, int hkv, int page,
                  int num_p, int pps, int nsplit, float scale, cudaStream_t stream) {
  if (hq % hkv != 0 || s < 1 || (tree_words && s > 32))
    return static_cast<int>(cudaErrorInvalidValue);
  // the split plan must tile the table: nsplit runs of pps pages, the last one ragged
  if (pps < 1 || nsplit < 1 || nsplit > kDecodeMaxSplits ||
      nsplit != (num_p + pps - 1) / pps || (nsplit > 1 && (!part || !counters)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int gs = (hq / hkv) * s;
  const int nrb = (gs + kDecodeRows - 1) / kDecodeRows;
  const size_t smem = DecodeSmem<KT, D>::bytes(gs < kDecodeRows ? gs : kDecodeRows);
  auto kernel = paged_decode_kernel<QT, KT, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(hkv * nrb, n, nsplit), kDecodeThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(pages_k),
      static_cast<const KT*>(pages_v), k_scales, v_scales, tables, lengths,
      static_cast<QT*>(out), part, counters, tree_words, s, hq, hkv, page, num_p, pps, nsplit,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace atpu

#define ATPU_LAUNCH_DECODE(QT, KT, D)                                                      \
  atpu::launch_decode<QT, KT, D>(q, pages_k, pages_v, k_scales, v_scales, tables, lengths, \
                                 out, part, counters, tree_words, n, s, hq, hkv, page,     \
                                 num_p, pps, nsplit, scale, static_cast<cudaStream_t>(stream))

// k_scales and v_scales: [NP, Hkv] f32, or both null for native pages (ones).
// With gs = (hq / hkv) * s folded rows in nrb = ceil(gs / 4) blocks of four
// rows (the last one ragged) - part: f32 scratch of n * hkv * nrb * nsplit *
// min(4, gs) * (d + 2) floats and counters: n * hkv * nrb int32 zeros, both
// needed only when nsplit > 1; the counters are zero again when the kernel
// ends.  tree_words: null for the causal arm, or s <= 32 uint32 ancestor
// words, bit j of word i set iff tree node i sees node j (the tree-mask
// arm).  kv_fmt: 0 f32, 1 bf16, 2 int8, 3 fp8-e4m3.
extern "C" int atpu_paged_decode(const void* q, const void* pages_k, const void* pages_v,
                                 const float* k_scales, const float* v_scales,
                                 const int* tables, const int* lengths, void* out, float* part,
                                 int* counters, const unsigned* tree_words, int n, int s,
                                 int hq, int hkv, int d, int page,
                                 int num_p, int pps, int nsplit, int q_bf16,
                                 int kv_fmt, float scale, void* stream) {
  ATPU_DISPATCH(q_bf16, kv_fmt, d, ATPU_LAUNCH_DECODE);
}

extern "C" const char* atpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
