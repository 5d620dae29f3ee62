// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_bwd_dkv.cu, flash_bwd_dq.cu) for sm_90a.
//
// Layout. Every tensor is read in the public [B, T, H, D] layout through
// its batch, time and head strides (in elements); the last dimension must
// be contiguous and every row 16-byte aligned. lse and di are f32 [B, H, T],
// contiguous. Outputs are written contiguous [B, T, H, D].
//
// Products. All four kinds of product run on the tensor cores through
// mma.sync.m16n8k16 (bf16 in, f32 accumulate). A block has four warps;
// each warp owns 16 rows of the block's tile. Fragment layouts
// (PTX ISA, "Matrix Fragments for mma.m16n8k16 with floating point type"),
// with g = lane / 4 and c = lane % 4:
//   A (16 x 16, row major): reg0 = (row g,   cols 2c, 2c+1)
//                           reg1 = (row g+8, cols 2c, 2c+1)
//                           reg2 = (row g,   cols 2c+8, 2c+9)
//                           reg3 = (row g+8, cols 2c+8, 2c+9)
//   B (16 x 8, k by n):     reg0 = (k 2c, 2c+1,   col g)
//                           reg1 = (k 2c+8, 2c+9, col g)
//   C (16 x 8, f32):        c0, c1 = (row g,   cols 2c, 2c+1)
//                           c2, c3 = (row g+8, cols 2c, 2c+1)
// The C fragments of two neighbouring 8-column tiles are, once rounded
// to bf16, exactly the A fragment of one 16-deep step. That is how P (and
// dS) go from one product into the next without touching shared memory.
//
// Fragments come from shared memory through ldmatrix (four 8x8 matrices
// a warp-wide instruction, transposed where the product wants a column).
// Shared memory rows are padded by 8 bf16 (16 bytes), so the eight rows
// of each 8x8 matrix fall in distinct banks. Tiles move from global to
// shared memory with cp.async, double-buffered where a loop walks them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;
typedef long long i64;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Row pitch in shared memory, in bf16 elements.
template <int D>
struct Pitch {
  static constexpr int value = D + kPad;
};

// d += a * b on the tensor cores, f32 accumulate; b is (b0, b1).
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory, one row address per lane
// (lanes 8i .. 8i+7 give matrix i's rows); with .trans each is
// transposed on the way.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 16) of a
// row-major tile in shared memory.
template <int PITCH>
__device__ __forceinline__ void ld_a_frag(uint32_t (&a)[4], const bf16* tile,
                                          int r0, int c0, int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * PITCH + c0 + (lane >> 4) * 8);
}

// B fragments of X^T for two neighbouring 8-wide n tiles, where X is a
// row-major tile in shared memory: the product's n index is X's row
// (n0 .. n0 + 15), its k index X's column (k0 .. k0 + 15). b[0..1] is the
// n tile at n0, b[2..3] the one at n0 + 8. Used for Q K^T, dO V^T and
// their transposes.
template <int PITCH>
__device__ __forceinline__ void ld_b_frag_t(uint32_t (&b)[4], const bf16* tile,
                                            int n0, int k0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * PITCH + k0 +
                 ((lane >> 3) & 1) * 8);
}

// B fragments of X itself for two neighbouring n tiles: k index is X's
// row (k0 .. k0 + 15), n index X's column (n0 .. n0 + 15), loaded
// transposed. Used for P V, P^T dO, dS K and dS^T Q.
template <int PITCH>
__device__ __forceinline__ void ld_b_frag(uint32_t (&b)[4], const bf16* tile,
                                          int k0, int n0, int lane) {
  ldsm_x4_t(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * PITCH + n0 +
                   (lane >> 4) * 8);
}

// 16 bytes global -> shared without passing through registers; `valid`
// false writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Start copying ROWS rows of D bf16 from global memory (row stride
// `stride` elements) into a padded shared tile; rows at or past `valid`
// become zero. The copy lands after cp_async_wait and __syncthreads.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile_async(bf16* tile, const bf16* src,
                                                i64 stride, int valid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int PITCH = Pitch<D>::value;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i - r * kChunks;
    const bool ok = r < valid;
    cp_async16(tile + r * PITCH + ch * 8, src + (ok ? r * stride : 0) + ch * 8, ok);
  }
}

// Copy ROWS f32 of a contiguous row (lse or di) into shared memory,
// times `mul`; entries at or past `valid` are 0.
template <int ROWS>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int valid, float mul) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads) dst[i] = i < valid ? src[i] * mul : 0.f;
}

// Max and sum over the four lanes that share a row of a C fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Whether query `row` may attend to key `col`.
__device__ __forceinline__ bool visible(int row, int col, int T, int causal) {
  return row < T && col < T && (!causal || col <= row);
}

}  // namespace flash
