// K2 - flash attention backward, dK and dV, for sm_90a (Hopper: TMA,
// wgmma, warp specialisation).
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
// Design (FlashAttention-3's shape, without atomics): a persistent grid
// of at most one block of three warpgroups per SM, each block walking its
// 128-row K/V tiles (PairWork: pairs of a heavy and a light K/V tile of
// one (b, h), so that every block gets the same causal work). A block
// owns the dK and dV rows of its K/V tile outright, so the result is
// deterministic. Warpgroup 0 is the producer: one of its threads loads
// each K/V tile pair into one of two buffers and streams the 64-row Q and
// dO tiles and their lse and di slices through a three-stage ring, all by
// TMA; a slot's "full" mbarrier waits for the TMA bytes, its "empty" one
// for the eight consumer warps, and the next K/V tile's loads run while
// the consumers finish and store this one. Warpgroups 1 and 2 are
// consumers with 240 registers each, 64 key rows each, and keep their dK
// and dV accumulators (2 x D / 2 f32 a thread) in registers for the whole
// walk over Q. For each Q tile: S^T = K Q^T and dP^T = V dO^T by wgmma
// from shared memory (Q and dO K-major); P^T = exp2(S^T scale log2 e -
// lse log2 e) and dS^T = P^T (dP^T - di) in registers; dV += P^T dO and
// dK += dS^T Q by wgmma with P^T and dS^T rounded to bf16 as register A
// operands and dO and Q read MN-major from the same swizzled tiles. The
// four products go to the tensor cores as four wgmma groups, so P^T is
// computed while dP^T is in flight and dS^T while dV is. dK is scaled
// once, at the end. Causal: Q tiles start at the K/V tile's diagonal, a
// warpgroup skips the tiles wholly above its keys, and only the tiles
// across the diagonal or the ragged end of T are masked. Neighbouring
// blocks work on neighbouring (b, h), so the Q and dO tiles they read
// come from L2.

#include "hopper_common.cuh"

namespace flash {

using namespace hopper;

constexpr int kDkvM = 128;  // K/V rows per tile (64 per consumer warpgroup)
constexpr int kDkvN = 64;   // Q rows per tile
constexpr int kDkvStages = 3;
constexpr int kDkvThreads = 384;

template <int D>
struct DkvLayout {
  static constexpr int kKV = kDkvM * D * 2;   // bytes of the K (or V) tile
  static constexpr int kQ = kDkvN * D * 2;    // bytes of one Q (or dO) tile
  static constexpr int kK = 0;                // two K/V buffers: K, then V
  static constexpr int kQs = 4 * kKV;                       // kDkvStages Q tiles
  static constexpr int kDOs = kQs + kDkvStages * kQ;        // kDkvStages dO tiles
  static constexpr int kLse = kDOs + kDkvStages * kQ;       // f32 [stages][kDkvN]
  static constexpr int kDi = kLse + kDkvStages * kDkvN * 4;
  static constexpr int kBars = kDi + kDkvStages * kDkvN * 4;
  // kv_full[2], kv_empty[2], then full and empty per stage
  static constexpr int kBytes = kBars + (4 + 2 * kDkvStages) * 8;
};

template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
           const __grid_constant__ CUtensorMap tlse, const __grid_constant__ CUtensorMap tdi,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H, int n_bh, float scale,
           int causal) {
  using L = DkvLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_aligned(smem_raw);
  float* sLse = reinterpret_cast<float*>(smem + L::kLse);
  float* sDi = reinterpret_cast<float*>(smem + L::kDi);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* kv_full = bars;
  uint64_t* kv_empty = bars + 2;
  uint64_t* full = bars + 4;
  uint64_t* empty = full + kDkvStages;
  const int wg = threadIdx.x / 128;
  // K/V tiles, walked in pairs heaviest (first) first (PairWork)
  const int n_n = (T + kDkvM - 1) / kDkvM;
  auto q_begin = [&](int n0) { return causal ? n0 : 0; };  // queries before n0 see none of these keys
  auto q_tiles = [&](int n0) { return (T - q_begin(n0) + kDkvN - 1) / kDkvN; };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&kv_full[i], 1);
      mbar_init(&kv_empty[i], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load. K/V tiles go to two
    // buffers in turn and Q/dO tiles through the ring, counted over all of
    // the block's K/V tiles, so the next K/V tile's loads start while the
    // consumers still work on this one ----
    setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    int g = 0;  // Q/dO tiles loaded so far
    int it = 0;
    for (PairWork w(n_n, n_bh); w.valid(); w.next(), ++it) {
      const int bh = w.bh(), b = bh / H, h = bh - b * H, n0 = w.tile() * kDkvM;
      const int kb = it & 1;
      uint8_t* sK = smem + L::kK + kb * 2 * L::kKV;
      mbar_wait(&kv_empty[kb], ((it >> 1) & 1) ^ 1);
      mbar_arrive_expect_tx(&kv_full[kb], 2 * L::kKV);
      tma_load_tile<D>(sK, &tk, &kv_full[kb], kDkvM, n0, h, b);
      tma_load_tile<D>(sK + L::kKV, &tv, &kv_full[kb], kDkvM, n0, h, b);
      const int n_q = q_tiles(n0);
      for (int i = 0; i < n_q; ++i, ++g) {
        const int s = g % kDkvStages;
        const int m0 = q_begin(n0) + i * kDkvN;
        mbar_wait(&empty[s], ((g / kDkvStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::kQ + 2 * kDkvN * 4);
        tma_load_tile<D>(smem + L::kQs + s * L::kQ, &tq, &full[s], kDkvN, m0, h, b);
        tma_load_tile<D>(smem + L::kDOs + s * L::kQ, &tdo, &full[s], kDkvN, m0, h, b);
        // lse and di of the tile's rows, from the flat [B * H * T] vectors:
        // rows past T read the next (b, h)'s values or zeros, and are masked
        tma_load_1d(sLse + s * kDkvN, &tlse, &full[s], bh * T + m0);
        tma_load_1d(sDi + s * kDkvN, &tdi, &full[s], bh * T + m0);
      }
    }
    return;
  }

  // ---- consumers: 64 key rows each ----
  setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g8 = lane >> 2, c = lane & 3;
  const float scale_log2 = scale * kLog2e;
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  float acc_dk[D / 2], acc_dv[D / 2];
  int g = 0;  // Q/dO tiles consumed so far
  int it = 0;
  for (PairWork w(n_n, n_bh); w.valid(); w.next(), ++it) {
    const int bh = w.bh(), b = bh / H, h = bh - b * H, n0 = w.tile() * kDkvM;
    const int kb = it & 1;
    const int wg_key0 = n0 + cw * 64;
    const int key[2] = {wg_key0 + warp * 16 + g8, wg_key0 + warp * 16 + g8 + 8};
    const int n_q = q_tiles(n0);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
    const uint8_t* sK = smem + L::kK + kb * 2 * L::kKV;
    const uint64_t desc_k = desc_k_major(sK + cw * 64 * kRowBytes);
    const uint64_t desc_v = desc_k_major(sK + L::kKV + cw * 64 * kRowBytes);
    mbar_wait(&kv_full[kb], (it >> 1) & 1);
    for (int i = 0; i < n_q; ++i, ++g) {
      const int s = g % kDkvStages;
      const int m0 = q_begin(n0) + i * kDkvN;
      mbar_wait(&full[s], (g / kDkvStages) & 1);
      // causal: a tile wholly above this warpgroup's keys adds nothing
      if (!(causal && m0 + kDkvN - 1 < wg_key0)) {
        const uint8_t* sQ = smem + L::kQs + s * L::kQ;
        const uint8_t* sDO = smem + L::kDOs + s * L::kQ;
        const uint64_t kd = opaque(desc_k), vd = opaque(desc_v);
        const uint64_t dq = opaque(desc_k_major(sQ)), ddo = opaque(desc_k_major(sDO));

        // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 queries, as two
        // wgmma groups: P^T is computed while dP^T is still in flight
        float st[kDkvN / 2], dpt[kDkvN / 2];
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          wgmma_ss_n64(st, desc_at(kd, k_major_step(kDkvM, k)),
                       desc_at(dq, k_major_step(kDkvN, k)), k > 0);
        wgmma_commit();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          wgmma_ss_n64(dpt, desc_at(vd, k_major_step(kDkvM, k)),
                       desc_at(ddo, k_major_step(kDkvN, k)), k > 0);
        wgmma_commit();
        wgmma_wait<1>();
        reg_fence(st);

        // P^T = exp2(S^T scale log2 e - lse log2 e), 0 where masked (every
        // column past T among them)
        const float* cL = sLse + s * kDkvN;
        const float* cD = sDi + s * kDkvN;
        const bool mask = m0 + kDkvN > T || (causal && m0 < wg_key0 + 64);
#pragma unroll
        for (int q8 = 0; q8 < kDkvN / 8; ++q8) {
          const float2 l2 = *reinterpret_cast<const float2*>(cL + 8 * q8 + 2 * c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = 4 * q8 + e;
            const int q = m0 + 8 * q8 + 2 * c + (e & 1);
            float p = fast_exp2(fmaf(st[idx], scale_log2, -kLog2e * ((e & 1) ? l2.y : l2.x)));
            if (mask && (q >= T || (causal && key[e >> 1] > q))) p = 0.f;
            st[idx] = p;
          }
        }

        // dV += P^T dO (P^T rounded to bf16, dO MN-major) while dS^T is made
        uint32_t pa[kDkvN / 16][4], sa[kDkvN / 16][4];
        acc_to_a<kDkvN / 16>(pa, st);
        const uint64_t dq_t = opaque(desc_mn_major(sQ, kDkvN));
        const uint64_t ddo_t = opaque(desc_mn_major(sDO, kDkvN));
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kDkvN / 16; ++k) {
          if constexpr (D == 128)
            wgmma_rs_n128(acc_dv, pa[k], desc_at(ddo_t, mn_major_step(k)));
          else
            wgmma_rs_n64(acc_dv, pa[k], desc_at(ddo_t, mn_major_step(k)));
        }
        wgmma_commit();
        wgmma_wait<1>();  // dP^T is done, dV may still run
        reg_fence(dpt);

        // dS^T = P^T (dP^T - di)
#pragma unroll
        for (int q8 = 0; q8 < kDkvN / 8; ++q8) {
          const float2 d2 = *reinterpret_cast<const float2*>(cD + 8 * q8 + 2 * c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = 4 * q8 + e;
            dpt[idx] = st[idx] * (dpt[idx] - ((e & 1) ? d2.y : d2.x));
          }
        }

        // dK += dS^T Q (dS^T rounded to bf16, Q MN-major)
        acc_to_a<kDkvN / 16>(sa, dpt);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kDkvN / 16; ++k) {
          if constexpr (D == 128)
            wgmma_rs_n128(acc_dk, sa[k], desc_at(dq_t, mn_major_step(k)));
          else
            wgmma_rs_n64(acc_dk, sa[k], desc_at(dq_t, mn_major_step(k)));
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(acc_dv);
        reg_fence(acc_dk);
        reg_fence(pa);
        reg_fence(sa);
      }
      release(&empty[s]);
    }
    release(&kv_empty[kb]);

    // write dK (scaled) and dV; key rows past T are never stored
    const i64 o_st = (i64)H * D;
    const i64 base = (i64)b * T * o_st + (i64)h * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (key[r] >= T) continue;
      bf16* krow = dk + base + key[r] * o_st;
      bf16* vrow = dv + base + key[r] * o_st;
#pragma unroll
      for (int i = 0; i < D / 2; i += 4) {
        const int k = i + 2 * r;
        const int col = 8 * (i >> 2) + 2 * c;
        *reinterpret_cast<uint32_t*>(krow + col) =
            pack_bf16(acc_dk[k] * scale, acc_dk[k + 1] * scale);
        *reinterpret_cast<uint32_t*>(vrow + col) = pack_bf16(acc_dv[k], acc_dv[k + 1]);
      }
    }
  }
}

// static: internal linkage keeps the function-local static below private
// to this library (as a template's it would otherwise be one symbol per
// process, shared with any other build of this file loaded beside it)
template <int D>
static cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* di, void* dk, void* dv,
                       int B, int T, int H, const i64* qs, const i64* ks, const i64* vs,
                       const i64* ds, float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tlse, tdi;
  if (!encode_bthd(&tq, q, B, T, H, D, qs, kDkvN) || !encode_bthd(&tk, k, B, T, H, D, ks, kDkvM) ||
      !encode_bthd(&tv, v, B, T, H, D, vs, kDkvM) || !encode_bthd(&tdo, dout, B, T, H, D, ds, kDkvN) ||
      !encode_f32_vector(&tlse, lse, (i64)B * H * T, kDkvN) ||
      !encode_f32_vector(&tdi, di, (i64)B * H * T, kDkvN))
    return cudaErrorInvalidValue;
  const int smem = DkvLayout<D>::kBytes + 1024;  // + room to align to 1024
  // once per D and process, on the device current at the first launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  dkv_kernel<D><<<pair_grid((T + kDkvM - 1) / kDkvM, B * H), kDkvThreads, smem, stream>>>(
      tq, tk, tv, tdo, tlse, tdi, static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, H, B * H,
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
