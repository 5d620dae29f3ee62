// K3 - flash attention backward, dQ, for sm_90a.
//
// Replaces: jax/experimental/pallas/ops/tpu/flash_attention.py
// _flash_attention_bwd_dq (:1287), pl.pallas_call at :1456, body
// _flash_attention_dq_kernel (:1146), reached from
// ray_tpu/ops/attention.py:105-120. The Pallas kernel also writes dS,
// which only a bias input needs; the repository never passes one, so
// this kernel does not.
//
// Computes, for each (batch, head): P = exp(scale * Q K^T - lse) rebuilt
// from the forward's lse, dP = dO V^T, dS = P * (dP - di) with
// di = rowsum(O * dO) (computed outside, as the JAX backward does at
// :273-275), and dQ = scale * dS K, with dS rounded to bf16 before the
// product and every sum in f32.
//
// Bound on the H100: compute, narrowly. At the GPT-2-125M shape the three
// products are 38.7 GFLOP over the lower triangle (39 us at 989 TFLOP/s)
// against 127 MB of q, k, v, dO, lse, di and dQ (38 us at 3.35 TB/s).
//
// Design: one block of four warps per (b, h, 64-row Q tile), which owns
// its dQ rows outright, so no atomics and the result is deterministic. A
// loop inside the block walks the K/V tiles up to the diagonal, double-
// buffered in shared memory (cp.async brings the next while this one is
// used). Q, dO, lse and di of the tile stay in shared memory; fragments
// come by ldmatrix; S, P, dP, dS and the dQ accumulator stay in
// registers. Heaviest tiles are issued first.

#include "flash_common.cuh"

namespace flash {

constexpr int kDqM = 64;  // Q rows per block
constexpr int kDqN = 64;  // K/V rows per inner step

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ di,
          bf16* __restrict__ dq, int T, int H,
          i64 qsb, i64 qst, i64 qsh, i64 ksb, i64 kst, i64 ksh,
          i64 vsb, i64 vst, i64 vsh, i64 dsb, i64 dst, i64 dsh,
          float scale, int causal) {
  constexpr int P = Pitch<D>::value;
  constexpr int KS = D / 16;
  constexpr int NT = kDqN / 8;
  constexpr int DT = D / 8;
  const float scale_log2 = scale * kLog2e;

  constexpr int TILE = kDqN * P;  // elements of one K or V tile

  extern __shared__ uint4 smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + kDqM * P;
  bf16* sK = sDO + kDqM * P;      // two buffers
  bf16* sV = sK + 2 * TILE;       // two buffers
  float* sLse = reinterpret_cast<float*>(sV + 2 * TILE);  // in log2 units
  float* sDi = sLse + kDqM;

  const int m_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int m0 = m_tile * kDqM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const i64 bh = (i64)b * H + h;

  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;
  const int n_end = causal ? min(T, m0 + kDqM) : T;
  const int n_tiles = (n_end + kDqN - 1) / kDqN;
  load_tile_async<kDqM, D>(sQ, q + b * qsb + h * qsh + m0 * qst, qst, T - m0);
  load_tile_async<kDqM, D>(sDO, dout + b * dsb + h * dsh + m0 * dst, dst, T - m0);
  load_tile_async<kDqN, D>(sK, kb, kst, T);
  load_tile_async<kDqN, D>(sV, vb, vst, T);
  cp_async_commit();
  load_vec<kDqM>(sLse, lse + bh * T + m0, T - m0, kLog2e);
  load_vec<kDqM>(sDi, di + bh * T + m0, T - m0, 1.f);

  const int lr[2] = {warp * 16 + g, warp * 16 + g + 8};  // rows within the tile
  const int row[2] = {m0 + lr[0], m0 + lr[1]};

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const int n1 = (j + 1) * kDqN;
      load_tile_async<kDqN, D>(sK + ((j + 1) & 1) * TILE, kb + n1 * kst, kst, T - n1);
      load_tile_async<kDqN, D>(sV + ((j + 1) & 1) * TILE, vb + n1 * vst, vst, T - n1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + (j & 1) * TILE;
    const bf16* cV = sV + (j & 1) * TILE;
    const int n0 = j * kDqN;

    // S = Q K^T and dP = dO V^T
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], da[4];
      ld_a_frag<P>(qa, sQ, warp * 16, ks * 16, lane);
      ld_a_frag<P>(da, sDO, warp * 16, ks * 16, lane);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bf[4];
        ld_b_frag_t<P>(bf, cK, nt * 8, ks * 16, lane);
        mma_16816(s[nt], qa, bf[0], bf[1]);
        mma_16816(s[nt + 1], qa, bf[2], bf[3]);
        ld_b_frag_t<P>(bf, cV, nt * 8, ks * 16, lane);
        mma_16816(dp[nt], da, bf[0], bf[1]);
        mma_16816(dp[nt + 1], da, bf[2], bf[3]);
      }
    }

    // P = exp(S - lse), dS = P (dP - di); masked entries are 0
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = n0 + nt * 8 + 2 * c + (e & 1);
        const float p = visible(row[r], col, T, causal)
                            ? exp2f(s[nt][e] * scale_log2 - sLse[lr[r]]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - sDi[lr[r]]);
      }

    // dQ += dS K, dS rounded to bf16
#pragma unroll
    for (int ks = 0; ks < kDqN / 16; ++ks) {
      uint32_t da[4];
      da[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      da[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      da[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      da[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bf[4];
        ld_b_frag<P>(bf, cK, ks * 16, dt * 8, lane);
        mma_16816(acc[dt], da, bf[0], bf[1]);
        mma_16816(acc[dt + 1], da, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  const i64 o_st = (i64)H * D;
  bf16* ob = dq + (i64)b * T * o_st + (i64)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
    bf16* orow = ob + row[r] * o_st;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * c) =
          pack_bf16(acc[dt][2 * r] * scale, acc[dt][2 * r + 1] * scale);
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* di, void* dq, int B, int T, int H,
                      const i64* qs, const i64* ks, const i64* vs, const i64* ds,
                      float scale, int causal, cudaStream_t stream) {
  constexpr int P = Pitch<D>::value;
  const int smem = (2 * kDqM + 4 * kDqN) * P * (int)sizeof(bf16) + 2 * kDqM * (int)sizeof(float);
  // once per D and process, on the device current at the first launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((T + kDqM - 1) / kDqM, H, B);
  dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dq), T, H,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], ds[0], ds[1], ds[2],
      scale, causal);
  return cudaGetLastError();
}

}  // namespace flash

// q, k, v, dout: bf16 [B, T, H, D], strided as in flash_fwd; lse, di: f32
// [B, H, T] contiguous; dq: bf16 [B, T, H, D] contiguous.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* di, void* dq,
                            int B, int T, int H, int D,
                            long long qsb, long long qst, long long qsh,
                            long long ksb, long long kst, long long ksh,
                            long long vsb, long long vst, long long vsh,
                            long long dsb, long long dst, long long dsh,
                            float scale, int causal, void* stream) {
  const long long qs[3] = {qsb, qst, qsh}, ks[3] = {ksb, kst, ksh};
  const long long vs[3] = {vsb, vst, vsh}, ds[3] = {dsb, dst, dsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return flash::launch_dq<128>(q, k, v, dout, lse, di, dq, B, T, H, qs, ks, vs, ds, scale, causal, st);
  if (D == 64)
    return flash::launch_dq<64>(q, k, v, dout, lse, di, dq, B, T, H, qs, ks, vs, ds, scale, causal, st);
  return cudaErrorInvalidValue;
}
