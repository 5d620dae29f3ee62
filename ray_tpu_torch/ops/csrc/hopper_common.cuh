// Hopper pieces shared by the three flash-attention kernels, forward
// (flash_fwd.cu), dK/dV (flash_bwd_dkv.cu) and dQ (flash_bwd_dq.cu),
// sm_90a only: TMA tensor maps and loads, mbarriers, wgmma and its
// shared-memory descriptors, setmaxnreg.
//
// Tensor maps. cuTensorMapEncodeTiled lives in libcuda. It is looked up
// through the runtime's cudaGetDriverEntryPoint(ByVersion), so the
// kernels' shared libraries need no -lcuda link flag; <cuda.h> is
// included for its types only. A map is encoded per call on the host
// (pointers change every layer) and passed to the kernel by value as a
// __grid_constant__ const CUtensorMap.
//
// Tiles in shared memory. Every bf16 tile is loaded by TMA with the
// 128-byte swizzle: a box is 64 columns (128 bytes) wide and R rows tall,
// row r at byte r * 128, its eight 16-byte chunks permuted by XOR with
// r % 8. A D = 128 tile is two such boxes, columns 0-63 then 64-127, each
// R * 128 bytes. Every box starts 1024-byte aligned, so the swizzle
// pattern (address bits 4-6 XOR bits 7-9) is the same one wgmma reads.
//
// wgmma descriptors (PTX ISA, "Matrix Descriptor Format"): bits 0-13
// start address >> 4, 16-29 leading byte offset (LBO) >> 4, 32-45 stride
// byte offset (SBO) >> 4, 49-51 base offset (0: boxes are 1024-aligned),
// 62-63 layout (1 = 128-byte swizzle).
//   K-major operand (the k16 slice is 32 contiguous bytes of each row):
//     SBO = 1024, the step from one 8-row group to the next; LBO unused.
//     The k-th 16-column step starts at box (k / 4) + (k % 4) * 32 bytes.
//   MN-major operand (the transpose bit; rows of the tile are k, its 64
//     columns of a box are n): SBO = 1024, the step from k rows 0-7 to
//     8-15; LBO = the box size in bytes, the step from n 0-63 to n 64-127.
//     The k-th 16-row step starts at box 0 + k * 16 * 128 bytes.
//
// Fragments of wgmma.m64nNk16 (PTX ISA, "Register Fragments and Shared
// Memory Matrix Layouts" for wgmma), for thread t of the warpgroup with
// warp w = t / 32, g = (t % 32) / 4 and c = t % 4:
//   accumulator D (64 x N, f32), N / 2 registers d[i]:
//     d[i] = (row 16w + g + 8 * ((i / 2) % 2), col 8 * (i / 4) + 2c + i % 2)
//   A from registers (64 x 16, bf16), four 32-bit registers a[j], each
//   two bf16 (lower column in the low half):
//     a[0] = (row 16w + g,     cols 2c, 2c+1)
//     a[1] = (row 16w + g + 8, cols 2c, 2c+1)
//     a[2] = (row 16w + g,     cols 2c+8, 2c+9)
//     a[3] = (row 16w + g + 8, cols 2c+8, 2c+9)
// So the accumulator's columns 16k .. 16k+15 (its 8-column groups 2k and
// 2k+1, registers d[8k .. 8k+7]) rounded to bf16 are exactly the A
// fragment of the k-th 16-deep step: a[0] = (d[8k], d[8k+1]),
// a[1] = (d[8k+2], d[8k+3]), a[2] = (d[8k+4], d[8k+5]),
// a[3] = (d[8k+6], d[8k+7]) (acc_to_a below). That is how P and dS go from
// one product into the next without touching shared memory. Per warp
// these are mma.sync.m16n8k16's C and A fragment layouts, stacked over
// the warpgroup's four warps.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hopper {

typedef __nv_bfloat16 bf16;
typedef long long i64;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBoxCols = 64;       // bf16 columns of one swizzled box
constexpr int kRowBytes = 128;     // bytes of one row of a box

// ---- host: tensor maps ---------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once per process.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// Map of a bf16 [B, T, H, D] tensor read through its (batch, time, head)
// strides in elements, for boxes of `rows` time steps by 64 columns of
// one (b, h), 128-byte swizzle. Coordinates are (d, t, h, b); rows at or
// past T are filled with zeros. Returns false if the map cannot be encoded.
inline bool encode_bthd(CUtensorMap* map, const void* ptr, int B, int T, int H, int D,
                        const i64* strides, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t bytes[3] = {(cuuint64_t)strides[1] * 2, (cuuint64_t)strides[2] * 2,
                               (cuuint64_t)strides[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBoxCols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, bytes,
            box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Map of a contiguous f32 vector of n elements for boxes of `box`
// elements, no swizzle; elements past n are filled with zeros.
inline bool encode_f32_vector(CUtensorMap* map, const void* ptr, i64 n, int box) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t bytes[1] = {(cuuint64_t)n * 4};  // not read for rank 1
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t step[1] = {1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims, bytes,
            boxes, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Streaming multiprocessors of the current device, read once per process.
inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 1;
  }();
  return n;
}

// ---- device: shared memory, mbarriers, TMA --------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to 1024 bytes (the launch asks for
// 1 KB more than the layout needs).
__device__ __forceinline__ uint8_t* smem_aligned(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}

// Makes the barriers' initialisation visible to the async (TMA) proxy.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// Arrive, and add `bytes` to the transactions this phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A fresh barrier
// is in phase 0, so waiting on parity 1 returns at once: that is how a
// producer's first wait on an empty slot passes. There is no time-out: a
// 64-bit clock read inlined at every wait costs the consumers enough
// registers that ptxas serialises every wgmma and spills, so a wrong
// parity hangs the launch.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  while (!mbar_try_wait(a, parity)) {
  }
}

// TMA: one box of `map` at coordinates (c0, c1, c2, c3) into shared
// memory at dst; its bytes count against `bar`'s transactions.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA: one box of a 1-D `map` starting at element c0.
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// The D / 64 boxes of one tile of `rows` time steps starting at t0.
template <int D>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst, const CUtensorMap* map,
                                              uint64_t* bar, int rows, int t0, int h, int b) {
#pragma unroll
  for (int i = 0; i < D / kBoxCols; ++i)
    tma_load_4d(dst + i * rows * kRowBytes, map, bar, i * kBoxCols, t0, h, b);
}

// Named barrier `id` (1-15; 0 is __syncthreads) of `threads` threads:
// bar_sync waits for all of them, bar_arrive counts in without waiting.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---- device: persistent work ------------------------------------------

// The tiles one block of a persistent grid works on, in order. The block
// takes the units blockIdx.x, blockIdx.x + gridDim.x, ... of
// n_pairs * n_bh: unit u is the (b, h) u / n_pairs and its pair of tiles
// r, then n - 1 - r, with r = u % n_pairs (the middle tile of an odd n is
// a unit alone). Under a causal mask the tiles of one (b, h) weigh
// a + b i for their index i, so a pair weighs the same whatever r and
// every block gets the same work; neighbouring blocks work on
// neighbouring (b, h), so the tiles they share come from L2.
struct PairWork {
  int n, n_pairs, n_units, u, half;
  __device__ PairWork(int n_tiles, int n_bh)
      : n(n_tiles), n_pairs((n_tiles + 1) / 2), n_units(n_pairs * n_bh), u(blockIdx.x),
        half(0) {}
  __device__ bool valid() const { return u < n_units; }
  __device__ int bh() const { return u / n_pairs; }
  __device__ int tile() const {
    const int r = u % n_pairs;
    return half ? n - 1 - r : r;
  }
  __device__ void next() {
    const int r = u % n_pairs;
    if (!half && r != n - 1 - r) {
      half = 1;
    } else {
      half = 0;
      u += gridDim.x;
    }
  }
};

// Blocks of a persistent grid over n tiles of each of n_bh (b, h): one an
// SM at most.
inline int pair_grid(int n, int n_bh) {
  const int units = (n + 1) / 2 * n_bh;
  return units < sm_count() ? units : sm_count();
}

// ---- device: wgmma --------------------------------------------------------

__device__ __forceinline__ uint64_t make_desc(const uint8_t* smem, uint32_t lbo, uint32_t sbo) {
  const uint64_t a = smem_u32(smem);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Descriptor of a K-major operand (LBO unused) whose first row is at
// `tile`, or of an MN-major one whose boxes are `rows` tall.
__device__ __forceinline__ uint64_t desc_k_major(const uint8_t* tile) {
  return make_desc(tile, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn_major(const uint8_t* tile, int rows) {
  return make_desc(tile, rows * kRowBytes, 1024);
}

// Byte offset of the k-th 16-deep step: K-major in a tile whose boxes are
// `rows` tall, or MN-major.
__host__ __device__ constexpr int k_major_step(int rows, int k) {
  return (k >> 2) * rows * kRowBytes + (k & 3) * 32;
}
__host__ __device__ constexpr int mn_major_step(int k) { return k * 16 * kRowBytes; }

// The descriptor `bytes` further on (the start address field is bits 0-13).
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, int bytes) {
  return desc + (uint64_t)(bytes >> 4);
}

// The same value, opaque to the compiler. Taken once per loop iteration,
// it keeps the per-step descriptors derived from it (desc_at) from being
// hoisted out of the loop, where they would hold two registers each for
// the whole loop.
__device__ __forceinline__ uint64_t opaque(uint64_t desc) {
  asm volatile("" : "+l"(desc));
  return desc;
}

// Orders register and shared-memory writes before the wgmmas that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Compiler fences: the registers are taken as read and rewritten here, so
// no use of an accumulator moves above the wgmma_wait before it, and no
// A-fragment register is reused while a wgmma may still read it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// Registers per thread for the warpgroup from here on (a multiple of 8 in
// [24, 256]); every warp of the warpgroup executes it.
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// d (+)= A B, m64n64k16, A and B both K-major in shared memory
// (descriptors); accumulate iff `accumulate`.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (+)= A B, m64n128k16, A and B both K-major in shared memory
// (descriptors); accumulate iff `accumulate`.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A B, m64n64k16, A from registers (the k16 fragment a), B
// MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A B, m64n128k16, A from registers (the k16 fragment a), B
// MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---- device: fragments and small arithmetic -------------------------------

// Two f32 rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An m64nNk16 accumulator (N = 16 K) rounded to bf16, as the A fragments
// of K 16-deep steps (see the layouts above).
template <int K>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[K][4], const float (&d)[8 * K]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[k][j] = pack_bf16(d[8 * k + 2 * j], d[8 * k + 2 * j + 1]);
}

// 2^x by the special function unit (ex2.approx, flushing denormals):
// about 2 ulp, and 2^-inf = 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Max and sum over the four threads (c = 0..3) that share an accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace hopper
