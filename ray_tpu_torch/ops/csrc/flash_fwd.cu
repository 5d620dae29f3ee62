// K1 - flash attention forward for sm_90a (Hopper: TMA, wgmma, warp
// specialisation).
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
// Design (FlashAttention-3's shape): a persistent grid of at most one
// block of three warpgroups per SM, each block walking its 128-row Q
// tiles (PairWork: pairs of a heavy and a light Q tile of one (b, h), so
// that every block gets the same causal work). Warpgroup 0 is the
// producer: after setmaxnreg.dec one of its threads loads each Q tile
// into one of two buffers and streams the 128-row K and V tiles through a
// two-stage ring by TMA, each slot with a "full" mbarrier (the TMA bytes
// have landed) and an "empty" one (both consumers are done with it); K
// and V have slots of their own, so S = Q K^T starts before V lands and a
// K slot is refilled while P V still reads V, and the next Q tile's loads
// run while the consumers finish and store this one. Warpgroups 1 and 2
// are consumers with 240 registers each, 64 query rows each: S = Q K^T by
// wgmma from shared memory (both operands K-major), the online softmax in
// registers on the accumulator layout in log2 units, then O += P V by
// wgmma with P as the register A operand (rounded to bf16) and V read
// MN-major from the same swizzled tile. Each S = Q K^T goes to the tensor
// cores together with the previous tile's O += P V, and the softmax of S
// runs while that P V is in flight; the two consumers take turns to issue
// their products (named barriers), so one's softmax also overlaps the
// other's products. K/V tiles above the diagonal are never loaded and
// only the tiles that hold the diagonal or the ragged end of T are
// masked. Neighbouring blocks work on neighbouring (b, h), so the K/V
// tiles they read come from L2.

#include "hopper_common.cuh"

namespace flash {

using namespace hopper;

constexpr int kFwdM = 128;   // Q rows per tile (64 per consumer warpgroup)
constexpr int kFwdN = 128;   // K/V rows per tile
constexpr int kFwdStages = 2;
constexpr int kFwdThreads = 384;

template <int D>
struct FwdLayout {
  static constexpr int kTile = kFwdN * D * 2;  // bytes of one 128-row tile
  static constexpr int kQ = 0;                              // two Q tiles
  static constexpr int kK = 2 * kTile;                      // kFwdStages tiles
  static constexpr int kV = kK + kFwdStages * kTile;        // kFwdStages tiles
  static constexpr int kBars = kV + kFwdStages * kTile;
  // q_full[2], q_empty[2], then k_full, v_full, k_empty, v_empty per stage
  static constexpr int kBytes = kBars + (4 + 4 * kFwdStages) * 8;
};

// S = Q K^T (raw scores, 64 x 128 for one warpgroup) started on the
// tensor cores as one wgmma group; both operands K-major.
template <int D>
__device__ __forceinline__ void fwd_scores(float (&sc)[kFwdN / 2], uint64_t dq, uint64_t dk) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    wgmma_ss_n128(sc, desc_at(dq, k_major_step(kFwdM, k)), desc_at(dk, k_major_step(kFwdN, k)),
                  k > 0);
  wgmma_commit();
}

// O += P V started as one wgmma group: P from registers, V MN-major.
template <int D>
__device__ __forceinline__ void fwd_pv(float (&acc)[D / 2], const uint32_t (&pa)[kFwdN / 16][4],
                                       uint64_t dv) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < kFwdN / 16; ++k) {
    if constexpr (D == 128)
      wgmma_rs_n128(acc, pa[k], desc_at(dv, mn_major_step(k)));
    else
      wgmma_rs_n64(acc, pa[k], desc_at(dv, mn_major_step(k)));
  }
  wgmma_commit();
}

// One online-softmax step on the scores of the K/V tile at n0, in log2
// units: masks the tile if it holds the diagonal or the ragged end of T,
// updates the running max and sum, turns sc into P (f32) and gives each
// row's rescale factor for O.
__device__ __forceinline__ void fwd_softmax(float (&sc)[kFwdN / 2], float (&row_max)[2],
                                            float (&row_sum)[2], float (&alpha)[2],
                                            float scale_log2, int n0, const int (&row)[2], int c,
                                            int T, int causal, int wg_row0) {
  if (n0 + kFwdN > T || (causal && n0 + kFwdN - 1 > wg_row0)) {
#pragma unroll
    for (int i = 0; i < kFwdN / 2; ++i) {
      const int col = n0 + 8 * (i >> 2) + 2 * c + (i & 1);
      if (col >= T || (causal && col > row[(i >> 1) & 1])) sc[i] = -INFINITY;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kFwdN / 2; ++i)
      if (((i >> 1) & 1) == r) mx = fmaxf(mx, sc[i]);
    mx = fmaxf(row_max[r], quad_max(mx) * scale_log2);
    // a row with nothing visible yet keeps max -inf; exponentiate
    // against 0 there so that exp2(-inf - m) is 0 and never NaN
    const float m_use = mx == -INFINITY ? 0.f : mx;
    alpha[r] = fast_exp2(row_max[r] - m_use);
    row_max[r] = mx;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < kFwdN / 2; ++i)
      if (((i >> 1) & 1) == r) {
        sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -m_use));
        part += sc[i];
      }
    row_sum[r] = row_sum[r] * alpha[r] + part;
  }
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
           float* __restrict__ lse, int T, int H, int n_bh, float scale_log2, int causal) {
  using L = FwdLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_aligned(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 2;
  uint64_t* k_full = bars + 4;
  uint64_t* v_full = k_full + kFwdStages;
  uint64_t* k_empty = v_full + kFwdStages;
  uint64_t* v_empty = k_empty + kFwdStages;
  const int wg = threadIdx.x / 128;
  // Q tiles, walked in pairs heaviest (last) first (PairWork)
  const int n_m = (T + kFwdM - 1) / kFwdM;
  auto kv_tiles = [&](int m0) {  // K/V tiles a Q tile at m0 reads
    return ((causal ? min(T, m0 + kFwdM) : T) + kFwdN - 1) / kFwdN;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);
      mbar_init(&v_empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load. Q tiles go to two
    // buffers in turn and K/V tiles through the ring, counted over all of
    // the block's Q tiles, so the next Q tile's loads start while the
    // consumers still work on this one ----
    setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    int g = 0;  // K/V tiles loaded so far
    int qi = 0;
    for (PairWork w(n_m, n_bh); w.valid(); w.next(), ++qi) {
      const int bh = w.bh(), b = bh / H, h = bh - b * H, m0 = (n_m - 1 - w.tile()) * kFwdM;
      const int qs = qi & 1;
      mbar_wait(&q_empty[qs], ((qi >> 1) & 1) ^ 1);
      mbar_arrive_expect_tx(&q_full[qs], L::kTile);
      tma_load_tile<D>(smem + L::kQ + qs * L::kTile, &tq, &q_full[qs], kFwdM, m0, h, b);
      const int n_tiles = kv_tiles(m0);
      for (int j = 0; j < n_tiles; ++j, ++g) {
        const int s = g % kFwdStages;
        const uint32_t parity = ((g / kFwdStages) & 1) ^ 1;
        mbar_wait(&k_empty[s], parity);
        mbar_arrive_expect_tx(&k_full[s], L::kTile);
        tma_load_tile<D>(smem + L::kK + s * L::kTile, &tk, &k_full[s], kFwdN, j * kFwdN, h, b);
        mbar_wait(&v_empty[s], parity);
        mbar_arrive_expect_tx(&v_full[s], L::kTile);
        tma_load_tile<D>(smem + L::kV + s * L::kTile, &tv, &v_full[s], kFwdN, j * kFwdN, h, b);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each ----
  setmaxnreg_inc<240>();
  const int cw = wg - 1;                       // consumer index, 0 or 1
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g8 = lane >> 2, c = lane & 3;

  auto kv_tile = [&](int base, int g) { return smem + base + (g % kFwdStages) * L::kTile; };
  auto parity = [](int g) { return (uint32_t)((g / kFwdStages) & 1); };
  auto release = [&](uint64_t* empty) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty);
  };
  // The two consumers take turns to issue their wgmma groups (named
  // barriers 1 and 2), so one's softmax runs while the other's products
  // are on the tensor cores. Consumer 0 goes first; consumer 1 gives no
  // turn after its last issue, so no arrival is left over.
  auto my_turn = [&] { bar_sync(1 + cw, 256); };
  auto your_turn = [&](bool last) {
    if (!(last && cw == 1)) bar_arrive(2 - cw, 256);
  };
  if (cw == 1) bar_arrive(1, 256);

  float acc[D / 2];
  float row_max[2], row_sum[2], alpha[2];
  float sc[kFwdN / 2];          // S, then P, of the newest K/V tile
  uint32_t pa[kFwdN / 16][4];   // P rounded to bf16, the A operand of P V
  int g = 0;  // K/V tiles consumed so far
  int qi = 0;
  for (PairWork w(n_m, n_bh); w.valid(); ++qi) {
    const int bh = w.bh(), b = bh / H, h = bh - b * H, m0 = (n_m - 1 - w.tile()) * kFwdM;
    w.next();
    const bool last = !w.valid();  // the block's last Q tile
    const int n_tiles = kv_tiles(m0);
    const int qs = qi & 1;
    const int wg_row0 = m0 + cw * 64;
    const int row[2] = {wg_row0 + warp * 16 + g8, wg_row0 + warp * 16 + g8 + 8};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    row_max[0] = row_max[1] = -INFINITY;  // log2 units (scaled)
    row_sum[0] = row_sum[1] = 0.f;  // this thread's share; summed over the quad at the end
    const uint64_t desc_q = desc_k_major(smem + L::kQ + qs * L::kTile + cw * 64 * kRowBytes);

    // Tile 0: S, softmax, P. Then for each later tile j, S_j = Q K_j^T
    // and O += P_{j-1} V_{j-1} go to the tensor cores together, and the
    // softmax of S_j runs while P V is in flight; O is rescaled once P V
    // is done.
    mbar_wait(&q_full[qs], (qi >> 1) & 1);
    my_turn();
    mbar_wait(&k_full[g % kFwdStages], parity(g));
    fwd_scores<D>(sc, opaque(desc_q), opaque(desc_k_major(kv_tile(L::kK, g))));
    your_turn(false);
    wgmma_wait<0>();
    reg_fence(sc);
    release(&k_empty[g % kFwdStages]);
    fwd_softmax(sc, row_max, row_sum, alpha, scale_log2, 0, row, c, T, causal, wg_row0);
    acc_to_a<kFwdN / 16>(pa, sc);
    for (int j = 1; j < n_tiles; ++j) {
      const int gj = g + j;
      my_turn();
      mbar_wait(&k_full[gj % kFwdStages], parity(gj));
      fwd_scores<D>(sc, opaque(desc_q), opaque(desc_k_major(kv_tile(L::kK, gj))));
      mbar_wait(&v_full[(gj - 1) % kFwdStages], parity(gj - 1));
      fwd_pv<D>(acc, pa, opaque(desc_mn_major(kv_tile(L::kV, gj - 1), kFwdN)));
      your_turn(false);
      wgmma_wait<1>();  // S_j is done, P V may still run
      reg_fence(sc);
      release(&k_empty[gj % kFwdStages]);
      fwd_softmax(sc, row_max, row_sum, alpha, scale_log2, j * kFwdN, row, c, T, causal, wg_row0);
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(pa);
      release(&v_empty[(gj - 1) % kFwdStages]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      acc_to_a<kFwdN / 16>(pa, sc);
    }
    g += n_tiles;
    my_turn();
    mbar_wait(&v_full[(g - 1) % kFwdStages], parity(g - 1));
    fwd_pv<D>(acc, pa, opaque(desc_mn_major(kv_tile(L::kV, g - 1), kFwdN)));
    your_turn(last);
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(pa);
    release(&v_empty[(g - 1) % kFwdStages]);
    release(&q_empty[qs]);

    // normalise and write O and lse; rows past T are never stored
    const i64 o_st = (i64)H * D;
    bf16* ob = o + (i64)b * T * o_st + (i64)h * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = quad_sum(row_sum[r]);
      if (row[r] >= T) continue;
      const float inv = l > 0.f ? 1.f / l : 0.f;
      bf16* orow = ob + row[r] * o_st;
#pragma unroll
      for (int i = 0; i < D / 2; i += 4) {
        const int k = i + 2 * r;
        *reinterpret_cast<uint32_t*>(orow + 8 * (i >> 2) + 2 * c) =
            pack_bf16(acc[k] * inv, acc[k + 1] * inv);
      }
      if (c == 0) lse[(i64)bh * T + row[r]] = (row_max[r] + log2f(l)) * kLn2;
    }
  }
}

// static: internal linkage keeps the function-local static below private
// to this library (as a template's it would otherwise be one symbol per
// process, shared with any other build of this file loaded beside it)
template <int D>
static cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                       int B, int T, int H, const i64* qs, const i64* ks, const i64* vs,
                       float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode_bthd(&tq, q, B, T, H, D, qs, kFwdM) || !encode_bthd(&tk, k, B, T, H, D, ks, kFwdN) ||
      !encode_bthd(&tv, v, B, T, H, D, vs, kFwdN))
    return cudaErrorInvalidValue;
  const int smem = FwdLayout<D>::kBytes + 1024;  // + room to align to 1024
  // once per D and process, on the device current at the first launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  fwd_kernel<D><<<pair_grid((T + kFwdM - 1) / kFwdM, B * H), kFwdThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), T, H, B * H, scale * kLog2e,
      causal);
  return cudaGetLastError();
}

}  // namespace flash

// q, k, v: bf16 [B, T, H, D] with strides (batch, time, head) in elements,
// a contiguous last dimension and 16-byte aligned rows; o: bf16
// [B, T, H, D] contiguous; lse: f32 [B, H, T] contiguous. Returns the
// launch's cudaError_t (cudaErrorInvalidValue where a tensor map cannot be
// encoded or D is not 64 or 128).
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
