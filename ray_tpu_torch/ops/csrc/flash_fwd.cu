// K1 - flash attention forward for sm_90a.
//
// Replaces: the Pallas TPU kernel that ray_tpu/ops/attention.py:105-120
// calls, jax/experimental/pallas/ops/tpu/flash_attention.py
// _flash_attention_impl (:589), pl.pallas_call at :758, body
// _flash_attention_kernel_single_batch (:342).
//
// Computes, for each (batch, head): S = scale * Q K^T in f32, masked
// causally and at the ragged end of T; P = softmax(S) by the online
// (running max, running sum) method; O = P V with P rounded to bf16 before
// the product and the sum kept in f32, as the Pallas kernel does (:471).
// Writes O (bf16, [B, T, H, D]) and lse = max + log(sum) (f32, [B, H, T]),
// which the two backward kernels use to rebuild P.
//
// Bound on the H100: at the GPT-2-125M shape (B 16, H 6, T 1024, D 128,
// causal) the two products are 25.8 GFLOP over the lower triangle (26 us
// at 989 TFLOP/s) against 101 MB of q, k, v and o (30 us at 3.35 TB/s):
// about 256 FLOP per byte, just under the card's ~295 ridge, so the
// bytes bound it by a little. Either way the work is the tensor cores'
// and the design keeps them fed.
//
// Design: one block of four warps per (b, h, 64-row Q tile); the Q tile
// stays in registers as mma A fragments, and a loop inside the block walks
// the K/V tiles (64 rows) up to the diagonal, so tiles above it are never
// loaded. K/V tiles are double-buffered in shared memory: cp.async brings
// the next one in while the tensor cores work on this one. Fragments come
// from shared memory by ldmatrix. S, P and the O accumulator never leave
// registers. Blocks are issued heaviest (last Q tile) first to even out
// the causal triangle. mma.sync on the tensor cores, not yet wgmma/TMA.

#include "flash_common.cuh"

namespace flash {

constexpr int kFwdM = 64;  // Q rows per block
constexpr int kFwdN = 64;  // K/V rows per inner step

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o,
           float* __restrict__ lse, int T, int H,
           i64 qsb, i64 qst, i64 qsh, i64 ksb, i64 kst, i64 ksh,
           i64 vsb, i64 vst, i64 vsh, float scale_log2, int causal) {
  constexpr int P = Pitch<D>::value;
  constexpr int KS = D / 16;      // 16-deep steps over D
  constexpr int NT = kFwdN / 8;   // 8-wide column tiles of S
  constexpr int DT = D / 8;       // 8-wide column tiles of O
  constexpr int TILE = kFwdN * P; // elements of one K or V tile

  static_assert(kFwdM == kFwdN, "the Q tile borrows a K buffer");
  extern __shared__ uint4 smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // two buffers
  bf16* sV = sK + 2 * TILE;                      // two buffers
  // Q is read once, into registers, so it borrows the second K buffer
  // (at 68 KB a block, three blocks fit on an SM)
  bf16* sQ = sK + TILE;

  const int m_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int m0 = m_tile * kFwdM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;

  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;
  const int n_end = causal ? min(T, m0 + kFwdM) : T;
  const int n_tiles = (n_end + kFwdN - 1) / kFwdN;

  load_tile_async<kFwdM, D>(sQ, q + b * qsb + h * qsh + m0 * qst, qst, T - m0);
  load_tile_async<kFwdN, D>(sK, kb, kst, T);
  load_tile_async<kFwdN, D>(sV, vb, vst, T);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) ld_a_frag<P>(qf[ks], sQ, warp * 16, ks * 16, lane);
  __syncthreads();  // sQ is free for the next K tile

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};  // this lane's share; summed over the quad at the end
  const int row[2] = {m0 + warp * 16 + g, m0 + warp * 16 + g + 8};

  for (int j = 0; j < n_tiles; ++j) {
    // start the next K/V tile into the other buffer, then wait for this one
    if (j + 1 < n_tiles) {
      const int n1 = (j + 1) * kFwdN;
      load_tile_async<kFwdN, D>(sK + ((j + 1) & 1) * TILE, kb + n1 * kst, kst, T - n1);
      load_tile_async<kFwdN, D>(sV + ((j + 1) & 1) * TILE, vb + n1 * vst, vst, T - n1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + (j & 1) * TILE;
    const bf16* cV = sV + (j & 1) * TILE;
    const int n0 = j * kFwdN;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bf[4];
        ld_b_frag_t<P>(bf, cK, nt * 8, ks * 16, lane);
        mma_16816(s[nt], qf[ks], bf[0], bf[1]);
        mma_16816(s[nt + 1], qf[ks], bf[2], bf[3]);
      }

    // scale into log2 units and mask
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + 2 * c + (e & 1);
        s[nt][e] = visible(row[e >> 1], col, T, causal) ? s[nt][e] * scale_log2 : -INFINITY;
      }

    // online softmax: new running max, rescale, exponentiate
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = row_max[r];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = quad_max(mx);
      // a row with nothing visible yet keeps max -inf; exponentiate
      // against 0 there so that exp2(-inf - m) is 0 and never NaN
      const float m_use = mx == -INFINITY ? 0.f : mx;
      const float alpha = exp2f(row_max[r] - m_use);
      row_max[r] = mx;
      float part = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][2 * r] = exp2f(s[nt][2 * r] - m_use);
        s[nt][2 * r + 1] = exp2f(s[nt][2 * r + 1] - m_use);
        part += s[nt][2 * r] + s[nt][2 * r + 1];
      }
      row_sum[r] = row_sum[r] * alpha + part;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][2 * r] *= alpha;
        acc[dt][2 * r + 1] *= alpha;
      }
    }

    // O += P V, P rounded to bf16
#pragma unroll
    for (int ks = 0; ks < kFwdN / 16; ++ks) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bf[4];
        ld_b_frag<P>(bf, cV, ks * 16, dt * 8, lane);
        mma_16816(acc[dt], pa, bf[0], bf[1]);
        mma_16816(acc[dt + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // normalise and write O and lse
  const i64 o_st = (i64)H * D;
  bf16* ob = o + (i64)b * T * o_st + (i64)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(row_sum[r]);
    if (row[r] >= T) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    bf16* orow = ob + row[r] * o_st;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * c) =
          pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    if (c == 0) lse[((i64)b * H + h) * T + row[r]] = (row_max[r] + log2f(l)) * kLn2;
  }
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                       int B, int T, int H, const i64* qs, const i64* ks, const i64* vs,
                       float scale, int causal, cudaStream_t stream) {
  constexpr int P = Pitch<D>::value;
  const int smem = 4 * kFwdN * P * (int)sizeof(bf16);
  // once per D and process, on the device current at the first launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((T + kFwdM - 1) / kFwdM, H, B);
  fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
      T, H, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace flash

// q, k, v: bf16 [B, T, H, D] with strides (batch, time, head) in elements
// and a contiguous last dimension; o: bf16 [B, T, H, D] contiguous;
// lse: f32 [B, H, T] contiguous. Returns the launch's cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int B, int T, int H, int D,
                         long long qsb, long long qst, long long qsh,
                         long long ksb, long long kst, long long ksh,
                         long long vsb, long long vst, long long vsh,
                         float scale, int causal, void* stream) {
  const long long qs[3] = {qsb, qst, qsh}, ks[3] = {ksb, kst, ksh}, vs[3] = {vsb, vst, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return flash::launch_fwd<128>(q, k, v, o, lse, B, T, H, qs, ks, vs, scale, causal, st);
  if (D == 64) return flash::launch_fwd<64>(q, k, v, o, lse, B, T, H, qs, ks, vs, scale, causal, st);
  return cudaErrorInvalidValue;
}
