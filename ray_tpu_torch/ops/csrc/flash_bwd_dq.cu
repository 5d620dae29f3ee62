// K3 - flash attention backward, dQ, for sm_90a (Hopper: TMA, wgmma,
// warp specialisation).
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
// Design (the forward's shape, turned to dQ): a persistent grid of at
// most one block of three warpgroups per SM, each block walking its
// 128-row Q tiles (PairWork: pairs of a heavy and a light Q tile of one
// (b, h), so that every block gets the same causal work). A block owns
// the dQ rows of its Q tile outright: no atomics, and the result is
// deterministic. Warpgroup 0 is the producer: one of its threads loads
// each Q tile, its dO tile and their lse and di slices into one of
// kDqQBufs buffers, and streams the 64-row K and V tiles through a ring
// of kDqStages slots, all by TMA; K and V have "full" mbarriers of their
// own (S = Q K^T starts before V lands) and share an "empty" one that the
// eight consumer warps arrive on once dQ += dS K has read K. The last dP
// of a Q tile frees its buffer. Warpgroups 1 and 2 are
// consumers with 240 registers each, 64 query rows each, and keep their
// dQ accumulator (D / 2 f32 a thread) in registers for the whole walk
// over K/V. For each K/V tile: S = Q K^T and dP = dO V^T by wgmma from
// shared memory (both operands K-major) as two groups, so that P =
// exp2(S scale log2 e - lse log2 e) is computed while dP is in flight;
// dS = P (dP - di) in registers; dQ += dS K by wgmma with dS rounded to
// bf16 as the register A operand and K read MN-major from the same
// swizzled tile that S read K-major. That product stays in flight while
// the next tile's S and dP are issued. dQ is scaled once, at the end, and
// stored straight from registers (a quad of threads writes 16 contiguous
// bytes of a row): a Q tile is stored once per walk over its K/V tiles,
// and a staging tile for a TMA store would take the shared memory of the
// ring. Causal: K/V tiles above the diagonal are never loaded, the
// warpgroup of the upper 64 rows skips the tile wholly above them, and
// only the tiles across the diagonal or the ragged end of T are masked.
// Neighbouring blocks work on neighbouring (b, h), so the K/V tiles they
// read come from L2.

#include "hopper_common.cuh"

namespace flash {

using namespace hopper;

constexpr int kDqM = 128;   // Q rows per tile (64 per consumer warpgroup)
constexpr int kDqN = 64;    // K/V rows per tile
constexpr int kDqStages = 2;   // K/V ring
constexpr int kDqQBufs = 2;    // Q/dO/lse/di buffers
constexpr int kDqThreads = 384;

template <int D>
struct DqLayout {
  static constexpr int kQTile = kDqM * D * 2;  // bytes of one Q (or dO) tile
  static constexpr int kKV = kDqN * D * 2;     // bytes of one K (or V) tile
  static constexpr int kQ = 0;                              // kDqQBufs Q tiles
  static constexpr int kDO = kDqQBufs * kQTile;             // kDqQBufs dO tiles
  static constexpr int kK = 2 * kDqQBufs * kQTile;          // kDqStages K tiles
  static constexpr int kV = kK + kDqStages * kKV;           // kDqStages V tiles
  static constexpr int kLse = kV + kDqStages * kKV;         // f32 [kDqQBufs][kDqM]
  static constexpr int kDi = kLse + kDqQBufs * kDqM * 4;    // f32 [kDqQBufs][kDqM]
  static constexpr int kBars = kDi + kDqQBufs * kDqM * 4;
  // q_full, q_empty per Q buffer, then k_full, v_full, kv_empty per stage
  static constexpr int kBytes = kBars + (2 * kDqQBufs + 3 * kDqStages) * 8;
  static_assert(kBytes + 1024 <= 232448, "more shared memory than a block has");
};

// acc = A B^T (64 x 64 for one warpgroup) started on the tensor cores as
// one wgmma group; A (Q or dO, 128-row boxes) and B (K or V, 64-row boxes)
// both K-major.
template <int D>
__device__ __forceinline__ void dq_scores(float (&acc)[kDqN / 2], uint64_t da, uint64_t db) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    wgmma_ss_n64(acc, desc_at(da, k_major_step(kDqM, k)), desc_at(db, k_major_step(kDqN, k)),
                 k > 0);
  wgmma_commit();
}

// dQ += dS K started as one wgmma group: dS from registers, K MN-major.
template <int D>
__device__ __forceinline__ void dq_update(float (&acc)[D / 2], const uint32_t (&sa)[kDqN / 16][4],
                                          uint64_t dk) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < kDqN / 16; ++k) {
    if constexpr (D == 128)
      wgmma_rs_n128(acc, sa[k], desc_at(dk, mn_major_step(k)));
    else
      wgmma_rs_n64(acc, sa[k], desc_at(dk, mn_major_step(k)));
  }
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
          const __grid_constant__ CUtensorMap tlse, const __grid_constant__ CUtensorMap tdi,
          bf16* __restrict__ dq, int T, int H, int n_bh, float scale, int causal) {
  using L = DqLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_aligned(smem_raw);
  float* sLse = reinterpret_cast<float*>(smem + L::kLse);
  float* sDi = reinterpret_cast<float*>(smem + L::kDi);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + kDqQBufs;
  uint64_t* k_full = bars + 2 * kDqQBufs;
  uint64_t* v_full = k_full + kDqStages;
  uint64_t* kv_empty = v_full + kDqStages;
  const int wg = threadIdx.x / 128;
  // Q tiles, walked in pairs heaviest (last) first (PairWork)
  const int n_m = (T + kDqM - 1) / kDqM;
  auto kv_tiles = [&](int m0) {  // K/V tiles a Q tile at m0 reads
    return ((causal ? min(T, m0 + kDqM) : T) + kDqN - 1) / kDqN;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kDqQBufs; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load. Q tiles go to
    // their buffers in turn and K/V tiles through the ring, counted over
    // all of the block's Q tiles, so the next Q tile's loads start while
    // the consumers still work on this one ----
    setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    int g = 0;  // K/V tiles loaded so far
    int qi = 0;
    for (PairWork w(n_m, n_bh); w.valid(); w.next(), ++qi) {
      const int bh = w.bh(), b = bh / H, h = bh - b * H, m0 = (n_m - 1 - w.tile()) * kDqM;
      const int qs = qi % kDqQBufs;
      mbar_wait(&q_empty[qs], ((qi / kDqQBufs) & 1) ^ 1);
      mbar_arrive_expect_tx(&q_full[qs], 2 * L::kQTile + 2 * kDqM * 4);
      tma_load_tile<D>(smem + L::kQ + qs * L::kQTile, &tq, &q_full[qs], kDqM, m0, h, b);
      tma_load_tile<D>(smem + L::kDO + qs * L::kQTile, &tdo, &q_full[qs], kDqM, m0, h, b);
      // lse and di of the tile's rows, from the flat [B * H * T] vectors:
      // rows past T read the next (b, h)'s values or zeros, and are never
      // stored
      tma_load_1d(sLse + qs * kDqM, &tlse, &q_full[qs], bh * T + m0);
      tma_load_1d(sDi + qs * kDqM, &tdi, &q_full[qs], bh * T + m0);
      const int n_tiles = kv_tiles(m0);
      for (int j = 0; j < n_tiles; ++j, ++g) {
        const int s = g % kDqStages;
        mbar_wait(&kv_empty[s], ((g / kDqStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&k_full[s], L::kKV);
        tma_load_tile<D>(smem + L::kK + s * L::kKV, &tk, &k_full[s], kDqN, j * kDqN, h, b);
        mbar_arrive_expect_tx(&v_full[s], L::kKV);
        tma_load_tile<D>(smem + L::kV + s * L::kKV, &tv, &v_full[s], kDqN, j * kDqN, h, b);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each ----
  setmaxnreg_inc<240>();
  const int cw = wg - 1;                       // consumer index, 0 or 1
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g8 = lane >> 2, c = lane & 3;
  const float scale_log2 = scale * kLog2e;
  auto parity = [](int g) { return (uint32_t)((g / kDqStages) & 1); };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  float acc[D / 2];
  float sc[kDqN / 2];            // S, then P, of the K/V tile
  float dp[kDqN / 2];            // dP, then dS
  uint32_t sa[kDqN / 16][4];     // dS rounded to bf16, the A operand of dS K
  int g = 0;  // K/V tiles consumed so far
  int qi = 0;
  for (PairWork w(n_m, n_bh); w.valid(); w.next(), ++qi) {
    const int bh = w.bh(), b = bh / H, h = bh - b * H, m0 = (n_m - 1 - w.tile()) * kDqM;
    const int n_tiles = kv_tiles(m0);
    const int qs = qi % kDqQBufs;
    const int wg_row0 = m0 + cw * 64;
    // causal: the tiles after these lie wholly above this warpgroup's rows
    const int n_mine = causal ? min(n_tiles, (wg_row0 + 64 + kDqN - 1) / kDqN) : n_tiles;
    const int lr[2] = {cw * 64 + warp * 16 + g8, cw * 64 + warp * 16 + g8 + 8};
    const int row[2] = {m0 + lr[0], m0 + lr[1]};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint64_t desc_q = desc_k_major(smem + L::kQ + qs * L::kQTile + cw * 64 * kRowBytes);
    const uint64_t desc_do = desc_k_major(smem + L::kDO + qs * L::kQTile + cw * 64 * kRowBytes);
    mbar_wait(&q_full[qs], (qi / kDqQBufs) & 1);
    float lse_l2[2], di[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse_l2[r] = sLse[qs * kDqM + lr[r]] * kLog2e;
      di[r] = sDi[qs * kDqM + lr[r]];
    }

    for (int j = 0; j < n_mine; ++j) {
      const int gj = g + j, s = gj % kDqStages;
      const uint8_t* sK = smem + L::kK + s * L::kKV;
      const uint8_t* sV = smem + L::kV + s * L::kKV;
      // S = Q K^T and dP = dO V^T as two groups, behind dQ += dS K of the
      // previous tile
      mbar_wait(&k_full[s], parity(gj));
      dq_scores<D>(sc, opaque(desc_q), opaque(desc_k_major(sK)));
      mbar_wait(&v_full[s], parity(gj));
      dq_scores<D>(dp, opaque(desc_do), opaque(desc_k_major(sV)));
      if (j > 0) {
        wgmma_wait<2>();  // the previous tile's dS K is done: its K slot is free
        reg_fence(acc);
        reg_fence(sa);
        release(&kv_empty[(gj - 1) % kDqStages]);
      }
      wgmma_wait<1>();  // S is done, dP may still run
      reg_fence(sc);

      // P = exp2(S scale log2 e - lse log2 e), 0 where masked (every key
      // past T among them)
      const int n0 = j * kDqN;
      const bool mask = n0 + kDqN > T || (causal && n0 + kDqN - 1 > wg_row0);
#pragma unroll
      for (int i = 0; i < kDqN / 2; ++i) {
        const int r = (i >> 1) & 1;
        const int col = n0 + 8 * (i >> 2) + 2 * c + (i & 1);
        float p = fast_exp2(fmaf(sc[i], scale_log2, -lse_l2[r]));
        if (mask && (col >= T || (causal && col > row[r]))) p = 0.f;
        sc[i] = p;
      }
      wgmma_wait<0>();
      reg_fence(dp);
      // the last tile's dP has read Q and dO: their buffer may be refilled
      if (j == n_mine - 1) release(&q_empty[qs]);

      // dS = P (dP - di), then dQ += dS K (dS rounded to bf16, K MN-major)
#pragma unroll
      for (int i = 0; i < kDqN / 2; ++i) dp[i] = sc[i] * (dp[i] - di[(i >> 1) & 1]);
      acc_to_a<kDqN / 16>(sa, dp);
      dq_update<D>(acc, sa, opaque(desc_mn_major(sK, kDqN)));
    }
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(sa);
    release(&kv_empty[(g + n_mine - 1) % kDqStages]);

    // write dQ (scaled); rows past T are never stored
    const i64 o_st = (i64)H * D;
    bf16* ob = dq + (i64)b * T * o_st + (i64)h * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= T) continue;
      bf16* orow = ob + row[r] * o_st;
#pragma unroll
      for (int i = 0; i < D / 2; i += 4) {
        const int k = i + 2 * r;
        *reinterpret_cast<uint32_t*>(orow + 8 * (i >> 2) + 2 * c) =
            pack_bf16(acc[k] * scale, acc[k + 1] * scale);
      }
    }
    // the tiles this warpgroup skips: released once they have landed, so
    // that these arrivals count toward their own phase of the slot's
    // barrier and not toward the phase of the tile before them there,
    // which the other warpgroup may still be reading
    for (int j = n_mine; j < n_tiles; ++j) {
      mbar_wait(&k_full[(g + j) % kDqStages], parity(g + j));
      release(&kv_empty[(g + j) % kDqStages]);
    }
    g += n_tiles;
  }
}

// static: internal linkage keeps the function-local static below private
// to this library (as a template's it would otherwise be one symbol per
// process, shared with any other build of this file loaded beside it)
template <int D>
static cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* di, void* dq, int B, int T, int H,
                             const i64* qs, const i64* ks, const i64* vs, const i64* ds,
                             float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tlse, tdi;
  if (!encode_bthd(&tq, q, B, T, H, D, qs, kDqM) || !encode_bthd(&tk, k, B, T, H, D, ks, kDqN) ||
      !encode_bthd(&tv, v, B, T, H, D, vs, kDqN) || !encode_bthd(&tdo, dout, B, T, H, D, ds, kDqM) ||
      !encode_f32_vector(&tlse, lse, (i64)B * H * T, kDqM) ||
      !encode_f32_vector(&tdi, di, (i64)B * H * T, kDqM))
    return cudaErrorInvalidValue;
  const int smem = DqLayout<D>::kBytes + 1024;  // + room to align to 1024
  // once per D and process, on the device current at the first launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  dq_kernel<D><<<pair_grid((T + kDqM - 1) / kDqM, B * H), kDqThreads, smem, stream>>>(
      tq, tk, tv, tdo, tlse, tdi, static_cast<bf16*>(dq), T, H, B * H, scale, causal);
  return cudaGetLastError();
}

}  // namespace flash

// q, k, v, dout: bf16 [B, T, H, D], strided as in flash_fwd; lse, di: f32
// [B, H, T] contiguous; dq: bf16 [B, T, H, D] contiguous. Returns the
// launch's cudaError_t (cudaErrorInvalidValue where a tensor map cannot be
// encoded or D is not 64 or 128).
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
    return flash::launch_dq<128>(q, k, v, dout, lse, di, dq, B, T, H, qs, ks, vs, ds, scale,
                                 causal, st);
  if (D == 64)
    return flash::launch_dq<64>(q, k, v, dout, lse, di, dq, B, T, H, qs, ks, vs, ds, scale,
                                causal, st);
  return cudaErrorInvalidValue;
}
