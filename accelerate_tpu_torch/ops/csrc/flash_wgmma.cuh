// Hopper tensor-core pieces of the bf16 attention kernels (flash_fwd.cu,
// flash_bwd.cu and paged_prefill.cu): TMA tile loads into 128-byte-swizzled
// shared tiles, the mbarriers that pace a ring of such tiles, the wgmma
// matrix descriptors that read them, and the warpgroup matrix-multiply
// wrappers.  Compiled for sm_90a only: wgmma and setmaxnreg do not exist on
// plain sm_90.
//
// Shared tiles.  A tile of 64 rows x D bf16 columns is stored as
// tile_panels<D>() = ceil(D / 64) panels of 64 rows x 64 columns, 128 bytes
// a row, each panel 1024-byte aligned.  In a panel the 16-byte chunk c of row r sits at byte
// r * 128 + ((c ^ (r % 8)) * 16): the layout that TMA's SWIZZLE_128B writes
// and that a wgmma descriptor of layout type 1 (128-byte swizzle) reads.
// Eight consecutive rows then spread one column chunk over all 32 banks.
//
// A tile is read two ways:
//   K-major  (the product's depth runs along the row: Q, K and V as
//            operands of Q.K^T, K.Q^T and V.dO^T): a 16-column step of the
//            depth moves the start address 32 bytes inside the panel, and
//            the next panel is the next 64 columns; 8-row groups lie
//            1024 bytes apart (SBO).
//   MN-major (the depth runs down the rows: V of P.V, dO of P^T.dO, Q of
//            dS^T.Q): a 16-row step moves the start 16 * 128 bytes, 8-row
//            groups lie 1024 bytes apart (SBO) and the panels, which hold
//            the product's N columns 64 at a time, lie kPanelBytes apart
//            (LBO).
//
// Fragments.  A warpgroup's m64nN f32 accumulator gives thread t of warp
// w = t / 32, with g = (t % 32) / 4 and c = 2 * (t % 4), the values
//   d[4i + 0], d[4i + 1] at row 16w + g,     columns 8i + c, 8i + c + 1
//   d[4i + 2], d[4i + 3] at row 16w + g + 8, the same columns,
// and an m64k16 bf16 A operand in registers takes the same (row, column)
// places, so accumulator registers d[2i], d[2i + 1] rounded to bf16 and
// packed are exactly register i of the A operand for depth columns
// 16 (i / 4) .. 16 (i / 4) + 15 (FlashAttention-3's P-from-registers move).
#pragma once

#include <cuda.h>  // CUtensorMap and its encoder's declaration only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace atpu {

constexpr int kWarpgroup = 128;
constexpr int kPanelCols = 64;              // bf16 columns of a panel (128 bytes)
constexpr int kPanelBytes = 64 * 128;       // one panel of a 64-row tile
constexpr int kSwizzleAlign = 1024;         // the 128-byte swizzle repeats every 8 rows

// Panels of a 64 x D bf16 tile: D rounded up to whole 64-column panels.  A
// head dim that fills no whole panel (16, 32, 80, 96) keeps its true D in
// the tensor maps (make_panel_tensor_map), so TMA lands the columns past D
// as zeros: Q.K^T sums D / 16 depth steps, and P.V accumulates the padded
// columns, which the epilogues never store.
template <int D> __host__ __device__ constexpr int tile_panels() {
  return (D + kPanelCols - 1) / kPanelCols;
}
// Columns of a tile (64, 128 or 256) and its bytes.
template <int D> __host__ __device__ constexpr int tile_cols() {
  return tile_panels<D>() * kPanelCols;
}
template <int D> __host__ __device__ constexpr int tile_bytes() {
  return tile_panels<D>() * kPanelBytes;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A thread's plain stores to shared memory go through the generic proxy,
// while TMA and wgmma use the async proxy: each thread fences its stores
// before the barrier after which they are read that way.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbarriers (shared-memory barriers that count arrivals and, for TMA, the
// bytes still to land).  A wait names the parity of the phase it waits to
// see completed: round r of a ring stage waits for parity r & 1.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// TMA: copy the box at coordinates (column, head, position, batch) of a
// 4D tensor map (make_panel_tensor_map) into shared memory at dst,
// completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* tmap, uint32_t bar, int col,
                                            int head, int pos, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(tmap)), "r"(col), "r"(head), "r"(pos),
         "r"(batch), "r"(bar)
      : "memory");
}

// Hand registers from the producer warpgroup to the consumers (every warp
// of a warpgroup executes it).
template <int N> __device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N> __device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Matrix descriptors (layout type 1, 128-byte swizzle): start address,
// leading-dimension byte offset (LBO) and stride byte offset (SBO), each in
// 16-byte units.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (static_cast<uint64_t>(1) << 62);
}
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return wgmma_desc(addr, 16, 1024);  // LBO is not read for a swizzled K-major operand
}
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return wgmma_desc(addr, kPanelBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
template <int R> __device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64]: A and B from shared memory, both
// K-major.  acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x N] (+)= A[64 x 16] . B[16 x N]: A from registers, B from shared
// memory MN-major (N = 64, 128).  acc = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int acc);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// s[64 x 64] = A . B^T over D columns: A and B 64-row tiles at shared
// addresses a and b, both read K-major (Q.K^T, K.Q^T, V.dO^T).
template <int D>
__device__ __forceinline__ void mma_rows_by_rows(float (&s)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
    wgmma_ss(s, desc_k_major(a + off), desc_k_major(b + off), kk > 0);
  }
}

// acc[64 x N] += P . B over 64 depth rows: P the 64 x 64 accumulator of an
// earlier product, rounded to bf16 and packed (pk[i] from its registers 2i
// and 2i + 1); B the N = 64 or 128 columns (one or two panels) of a 64-row
// tile from shared address b, read MN-major (P.V, P^T.dO, dS^T.Q).
template <int N>
__device__ __forceinline__ void mma_probs_by_panels(float (&acc)[N / 2],
                                                    const uint32_t (&pk)[16], uint32_t b) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t a[4] = {pk[4 * j], pk[4 * j + 1], pk[4 * j + 2], pk[4 * j + 3]};
    wgmma_rs<N>(acc, a, desc_mn_major(b + j * 16 * 128), 1);
  }
}

// acc[64 x tile_cols<D>] += P . B over a whole 64 x D tile.  A tile of four
// panels (D 256) takes two N-128 products, panels 0-1 into acc[0 .. 63] and
// panels 2-3 into acc[64 .. 127]: the fragment layout of one N-256 product,
// whose columns 8 i + c sit in acc[4 i ...] for i up to 31.
template <int D>
__device__ __forceinline__ void mma_probs_by_tile(float (&acc)[tile_cols<D>() / 2],
                                                  const uint32_t (&pk)[16], uint32_t b) {
  constexpr int N = tile_cols<D>();
  if constexpr (N <= 128) {
    mma_probs_by_panels<N>(acc, pk, b);
  } else {
    static_assert(N == 256, "tiles of at most four panels");
    mma_probs_by_panels<128>(*reinterpret_cast<float(*)[64]>(&acc[0]), pk, b);
    mma_probs_by_panels<128>(*reinterpret_cast<float(*)[64]>(&acc[64]), pk,
                             b + 2 * kPanelBytes);
  }
}

// Host: the tensor-map encoder (cuTensorMapEncodeTiled), looked up once through the CUDA
// runtime, so the library links nothing beyond cudart.
using TiledEncode = decltype(&cuTensorMapEncodeTiled);
inline cudaError_t tiled_encoder(TiledEncode* out) {
  static TiledEncode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<TiledEncode>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

// Host: a 4D tensor map over a contiguous bf16 [B, S, H, D] tensor (BSHD)
// whose box is one swizzled panel of 64 columns of `heads` heads x `rows`
// sequence positions, heads fastest (columns past D, in the last panel of a
// D that is no multiple of 64, land as zeros): for K and V a box of 1 head x 64 keys,
// for Q and dO a folded q-block (rep heads x block_q queries, query-major
// as the kernels fold them).  A box never crosses from one batch into the
// next, and positions past S land as zeros.  The KV page pool [NP, page,
// Hkv, D] is the same shape with pages for batches: a box of 1 head x
// min(page, 64) keys of one page (a box wholly past the last page lands as
// zeros).
inline cudaError_t make_panel_tensor_map(CUtensorMap* map, const void* ptr, int b, int s, int h,
                                         int d, int heads, int rows) {
  TiledEncode encode;
  const cudaError_t err = tiled_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)d * 2 * h,
                                 (cuuint64_t)d * 2 * h * s};
  const cuuint32_t box[4] = {kPanelCols, (cuuint32_t)heads, (cuuint32_t)rows, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Host: a 4D tensor map over a contiguous 1-byte [B, S, H, D] tensor (the
// quantized page pool [NP, page, Hkv, D]) whose box is whole rows of D
// bytes of one head x `rows` positions, unswizzled: row r of a box lands at
// byte r * D.  As above, a box wholly past the last page lands as zeros.
inline cudaError_t make_byte_tensor_map(CUtensorMap* map, const void* ptr, int b, int s, int h,
                                        int d, int rows) {
  TiledEncode encode;
  const cudaError_t err = tiled_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d, (cuuint64_t)d * h, (cuuint64_t)d * h * s};
  const cuuint32_t box[4] = {(cuuint32_t)d, 1, (cuuint32_t)rows, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(ptr), dims,
                            strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace atpu
