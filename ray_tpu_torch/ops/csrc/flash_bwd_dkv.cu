// K2 - flash attention backward, dK and dV, for sm_90a.
//
// Replaces: jax/experimental/pallas/ops/tpu/flash_attention.py
// _flash_attention_bwd_dkv (:941), pl.pallas_call at :1121, body
// _flash_attention_dkv_kernel (:796), reached from
// ray_tpu/ops/attention.py:105-120.
//
// Computes, for each (batch, head), in the transposed orientation (rows
// are keys): P^T = exp(scale * K Q^T - lse) rebuilt from the forward's
// lse; dV = P^T dO; dP^T = V dO^T; dS^T = P^T * (dP^T - di) with
// di = rowsum(O * dO) computed outside; dK = scale * dS^T Q. P and dS are
// rounded to bf16 before their products, every sum is f32.
//
// Bound on the H100: compute. At the GPT-2-125M shape the four products
// are 51.5 GFLOP over the lower triangle (52 us at 989 TFLOP/s) against
// 152 MB of q, k, v, dO, lse, di, dK and dV (45 us at 3.35 TB/s).
//
// Design: one block of four warps per (b, h, 64-row K/V tile), which owns
// its dK and dV rows outright: no atomics, deterministic. The K/V tile
// stays in shared memory; a loop inside the block walks the 32-row Q
// tiles from the diagonal to the end of T (causal), double-buffering Q
// and dO (cp.async brings the next tile while this one is used) and
// prefetching lse and di through registers. Fragments come by ldmatrix.
// Both accumulators (2 x 64 f32 a lane at D = 128) stay in registers,
// which is why the Q step is 32 rows and not 64: it keeps S^T and dP^T
// to 16 registers each. Blocks are issued heaviest (first K tile) first.

#include "flash_common.cuh"

namespace flash {

constexpr int kDkvM = 64;  // K/V rows per block
constexpr int kDkvN = 32;  // Q rows per inner step

template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ di,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H,
           i64 qsb, i64 qst, i64 qsh, i64 ksb, i64 kst, i64 ksh,
           i64 vsb, i64 vst, i64 vsh, i64 dsb, i64 dst, i64 dsh,
           float scale, int causal) {
  constexpr int P = Pitch<D>::value;
  constexpr int KS = D / 16;
  constexpr int NT = kDkvN / 8;
  constexpr int DT = D / 8;
  const float scale_log2 = scale * kLog2e;

  constexpr int QTILE = kDkvN * P;  // elements of one Q or dO tile

  extern __shared__ uint4 smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kDkvM * P;
  bf16* sQ = sV + kDkvM * P;       // two buffers
  bf16* sDO = sQ + 2 * QTILE;      // two buffers
  float* sLse = reinterpret_cast<float*>(sDO + 2 * QTILE);  // two buffers, log2 units
  float* sDi = sLse + 2 * kDkvN;   // two buffers

  const int n0 = blockIdx.x * kDkvM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const i64 bh = (i64)b * H + h;

  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* db = dout + b * dsb + h * dsh;
  // causal: queries before n0 see none of these keys
  const int m_begin = causal ? n0 : 0;
  load_tile_async<kDkvM, D>(sK, k + b * ksb + h * ksh + n0 * kst, kst, T - n0);
  load_tile_async<kDkvM, D>(sV, v + b * vsb + h * vsh + n0 * vst, vst, T - n0);
  load_tile_async<kDkvN, D>(sQ, qb + m_begin * qst, qst, T - m_begin);
  load_tile_async<kDkvN, D>(sDO, db + m_begin * dst, dst, T - m_begin);
  cp_async_commit();
  load_vec<kDkvN>(sLse, lse + bh * T + m_begin, T - m_begin, kLog2e);
  load_vec<kDkvN>(sDi, di + bh * T + m_begin, T - m_begin, 1.f);

  const int key[2] = {n0 + warp * 16 + g, n0 + warp * 16 + g + 8};

  float acc_dk[DT][4], acc_dv[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[dt][e] = acc_dv[dt][e] = 0.f;

  int j = 0;
  for (int m0 = m_begin; m0 < T; m0 += kDkvN, ++j) {
    // start the next Q/dO tile into the other buffers; its lse/di go
    // through one register per thread and land after this tile's work
    const int m1 = m0 + kDkvN;
    const bool more = m1 < T;
    float next_stat = 0.f;
    if (more) {
      const int nb = (j + 1) & 1;
      load_tile_async<kDkvN, D>(sQ + nb * QTILE, qb + m1 * qst, qst, T - m1);
      load_tile_async<kDkvN, D>(sDO + nb * QTILE, db + m1 * dst, dst, T - m1);
      cp_async_commit();
      if (tid < kDkvN)
        next_stat = m1 + tid < T ? lse[bh * T + m1 + tid] * kLog2e : 0.f;
      else if (tid < 2 * kDkvN)
        next_stat = m1 + tid - kDkvN < T ? di[bh * T + m1 + tid - kDkvN] : 0.f;
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cQ = sQ + (j & 1) * QTILE;
    const bf16* cDO = sDO + (j & 1) * QTILE;
    const float* cL = sLse + (j & 1) * kDkvN;
    const float* cD = sDi + (j & 1) * kDkvN;

    // S^T = K Q^T and dP^T = V dO^T, rows are keys
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4], va[4];
      ld_a_frag<P>(ka, sK, warp * 16, ks * 16, lane);
      ld_a_frag<P>(va, sV, warp * 16, ks * 16, lane);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bf[4];
        ld_b_frag_t<P>(bf, cQ, nt * 8, ks * 16, lane);
        mma_16816(st[nt], ka, bf[0], bf[1]);
        mma_16816(st[nt + 1], ka, bf[2], bf[3]);
        ld_b_frag_t<P>(bf, cDO, nt * 8, ks * 16, lane);
        mma_16816(dpt[nt], va, bf[0], bf[1]);
        mma_16816(dpt[nt + 1], va, bf[2], bf[3]);
      }
    }

    // P^T = exp(S^T - lse[q]) and dS^T = P^T (dP^T - di[q]); masked are 0
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + 2 * c + (e & 1);
        const float p = visible(m0 + qi, key[e >> 1], T, causal)
                            ? exp2f(st[nt][e] * scale_log2 - cL[qi]) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - cD[qi]);
      }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16
#pragma unroll
    for (int ks = 0; ks < kDkvN / 16; ++ks) {
      uint32_t pa[4], sa[4];
      pa[0] = pack_bf16(st[2 * ks][0], st[2 * ks][1]);
      pa[1] = pack_bf16(st[2 * ks][2], st[2 * ks][3]);
      pa[2] = pack_bf16(st[2 * ks + 1][0], st[2 * ks + 1][1]);
      pa[3] = pack_bf16(st[2 * ks + 1][2], st[2 * ks + 1][3]);
      sa[0] = pack_bf16(dpt[2 * ks][0], dpt[2 * ks][1]);
      sa[1] = pack_bf16(dpt[2 * ks][2], dpt[2 * ks][3]);
      sa[2] = pack_bf16(dpt[2 * ks + 1][0], dpt[2 * ks + 1][1]);
      sa[3] = pack_bf16(dpt[2 * ks + 1][2], dpt[2 * ks + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bf[4];
        ld_b_frag<P>(bf, cDO, ks * 16, dt * 8, lane);
        mma_16816(acc_dv[dt], pa, bf[0], bf[1]);
        mma_16816(acc_dv[dt + 1], pa, bf[2], bf[3]);
        ld_b_frag<P>(bf, cQ, ks * 16, dt * 8, lane);
        mma_16816(acc_dk[dt], sa, bf[0], bf[1]);
        mma_16816(acc_dk[dt + 1], sa, bf[2], bf[3]);
      }
    }
    if (more && tid < 2 * kDkvN) {
      const int nb = (j + 1) & 1;
      if (tid < kDkvN) sLse[nb * kDkvN + tid] = next_stat;
      else sDi[nb * kDkvN + tid - kDkvN] = next_stat;
    }
    __syncthreads();  // this tile's buffers are free, the next one's stats are in
  }

  const i64 o_st = (i64)H * D;
  const i64 base = (i64)b * T * o_st + (i64)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= T) continue;
    bf16* krow = dk + base + key[r] * o_st;
    bf16* vrow = dv + base + key[r] * o_st;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(krow + dt * 8 + 2 * c) =
          pack_bf16(acc_dk[dt][2 * r] * scale, acc_dk[dt][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + dt * 8 + 2 * c) =
          pack_bf16(acc_dv[dt][2 * r], acc_dv[dt][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* di, void* dk, void* dv,
                       int B, int T, int H, const i64* qs, const i64* ks, const i64* vs,
                       const i64* ds, float scale, int causal, cudaStream_t stream) {
  constexpr int P = Pitch<D>::value;
  const int smem = (2 * kDkvM + 4 * kDkvN) * P * (int)sizeof(bf16) + 4 * kDkvN * (int)sizeof(float);
  // once per D and process, on the device current at the first launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((T + kDkvM - 1) / kDkvM, H, B);
  dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, H,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], ds[0], ds[1], ds[2],
      scale, causal);
  return cudaGetLastError();
}

}  // namespace flash

// q, k, v, dout: bf16 [B, T, H, D], strided as in flash_fwd; lse, di: f32
// [B, H, T] contiguous; dk, dv: bf16 [B, T, H, D] contiguous.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* di, void* dk, void* dv,
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
    return flash::launch_dkv<128>(q, k, v, dout, lse, di, dk, dv, B, T, H, qs, ks, vs, ds,
                                  scale, causal, st);
  if (D == 64)
    return flash::launch_dkv<64>(q, k, v, dout, lse, di, dk, dv, B, T, H, qs, ks, vs, ds,
                                 scale, causal, st);
  return cudaErrorInvalidValue;
}
