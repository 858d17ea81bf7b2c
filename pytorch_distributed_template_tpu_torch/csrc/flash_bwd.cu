// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Two kernels, the backward of csrc/flash_fwd.cu (B1):
// - B3 `flash_bwd_dq` replaces `_bwd_dq_kernel` of
//   pytorch_distributed_template_tpu/ops/flash.py (launched by
//   `_bwd_pallas_3d`): dQ, and delta.
// - B2 `flash_bwd_dkv` replaces `_bwd_dkv_kernel` (same file): dK and dV.
// Both recompute the probability tile from the forward's logsumexp,
//   P = exp(q k^T * scale - lse),  dP = dO v^T,  dS = P * (dP - delta) * scale,
// and accumulate dV += P^T dO, dK += dS^T q (B2) or dQ += dS k (B3) in f32.
// delta = rowsum(dO * out) - g_lse (g_lse, the lse cotangent, when the
// caller used lse; the TPU version leaves delta to XLA) is computed by B3
// for its own query rows, in f32 from the forward's `out`, and written to a
// [B, H, T] f32 buffer that B2 reads. So the launch order is fixed: B3,
// then B2 on the same stream. Masking is B1's: keys past T, by causality
// and by the band q - k < window; masked entries give P = 0 exactly.
//
// What differs from the TPU kernels, and why:
// - The TPU walks its grid in order and carries the dK/dV (or dQ) sums in
//   VMEM scratch across the streamed axis. Here one item owns a tile of
//   keys (B2) or queries (B3) and loops over the streamed tiles itself,
//   only over those the causal or band mask leaves visible.
// - GQA: B2's item owns (batch, kv head, key tile) and loops over the query
//   heads of its kv head, so dK/dV come out at the stored kv-head width,
//   summed over the group inside the item: no atomics, no head expansion.
//   When the items are fewer than the SMs and uneven (causal, no band), the
//   wrapper splits each item's heads over `splits` items (ops/flash.py
//   bwd_splits), which write f32 partial sums that a
//   second small launch adds in a fixed order: the result is the same
//   whatever order the blocks run in. B3's item owns (batch, query head,
//   query tile) and reads its kv head h / groups.
// - Ragged T is masked in the kernel: keys and queries past T load as zero
//   (TMA fills them) and are never written, so nothing is padded.
// - Layout is the public one: q, k, v, dO, out and the gradients
//   [B, T, heads, D], lse, g_lse and delta [B, H, T] f32.
//
// What bounds it: at the training shapes (T 512-1024, D 64) the backward
// does ~T/4 FLOPs per byte it must move, near or above the card's ~295
// FLOP/byte ridge; at T 2048 and D 128 the arithmetic bounds it. Two arms,
// one per input type:
// - bf16 (every main path): B1's skeleton. Blocks of 384 threads, one per
//   SM, take the items longest first in a zig-zag over the blocks.
//   Warpgroup 0 is the producer (one warp issues TMA loads from 4-D tensor
//   maps over [B, T, heads, D], boxes one swizzle atom wide, and gives its
//   registers away with setmaxnreg); warpgroups 1 and 2 are consumers of
//   64 of the item's 128 rows each. Every buffer completes and goes back to
//   the producer through mbarriers of its own.
//   B3: per item Q, dO and O by TMA and the lse rows by cp.async (once),
//   then the item's K and V tiles of 64 keys into a ring. delta of a
//   thread's two rows comes from the dO and O tiles in shared memory and
//   stays in registers with their lse. Per tile, S = Q K^T and dP = dO V^T
//   (wgmma, both operands K-major from shared memory), then P and dS in
//   registers, then dQ += dS K (wgmma, dS from registers as the A operand,
//   K the MN-major B operand). Tile i's S and dP are issued before tile
//   i - 1's dS K, so that tile i's softmax runs on the CUDA cores while
//   dS K runs on the tensor cores.
//   B2: per item K and V (once), then (64-query tile, query head) pairs of
//   the item's heads into a ring: Q, dO by TMA, and lse and delta rows by
//   cp.async, all completing on one mbarrier. Per pair, S^T = K Q^T and
//   dP^T = V dO^T (wgmma from shared memory), P^T and dS^T in registers,
//   then dV += P^T dO and dK += dS^T Q (wgmma, A from registers; dO and Q
//   read MN-major, so one shared tile is the K-major operand of one product
//   and the MN-major operand of the next). dK and dV stay in registers for
//   the whole item, which leaves none to overlap one pair's S^T with the
//   previous pair's products as B3 does (tried: ptxas then serialises the
//   wgmma at D 64 and it ran slower; issuing dV before dS^T is computed
//   spilled at D 128 and gained nothing at D 64), so each consumer runs
//   its pairs in turn and the two consumers overlap.
//   Probabilities use B1's ex2.approx.ftz rounding; the mask is computed
//   only on tiles that a consumer does not see whole, and a consumer only
//   hands back the tiles it sees nothing of (the diagonal's far side): its
//   tiles with products are one contiguous run, walked by loops whose
//   bounds ptxas knows to be warp-uniform, since ptxas serialises wgmma
//   under a branch that may diverge.
// - f32: the same arithmetic in f32 on the CUDA cores from shared-memory
//   tiles, so float32 parity runs keep full f32 products; its B3 also
//   computes delta.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_bwd.so flash_bwd.cu -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// visible(query row, key col): B1's mask
__device__ __forceinline__ bool visible(int qpos, int kpos, int t_len,
                                        int causal, int window) {
  return qpos < t_len && kpos < t_len && (!causal || kpos <= qpos) &&
         (window <= 0 || qpos - kpos < window);
}

// ---------------------------------------------------------------------------
// bf16: TMA, mbarriers, wgmma
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BI = 128;       // rows an item owns: queries (B3), keys (B2)
constexpr int BT = 64;        // rows of a streamed tile: keys (B3), queries
constexpr int RW = 64;        // rows of one consumer
constexpr int THREADS = 384;  // producer warpgroup + two consumers
constexpr int NS = BT / 2;    // score accumulator registers per thread

// setmaxnreg budgets (producer, consumers). The block starts with 168
// registers a thread (launch bounds 384 x 1); a consumer's setmaxnreg.inc
// waits until the producer's .dec has freed enough of them, forever if
// the budgets ask for more than the block holds.
template <int P, int C>
struct Regs {
  static_assert(128 * P + 256 * C <= 168 * THREADS, "budgets overcommit");
  static constexpr int PRODUCER = P, CONSUMER = C;
};
// the producer warps also issue cp.async
using DqRegs = Regs<56, 224>;
using DkvRegs = Regs<56, 224>;

template <int D>
struct Cfg {
  static_assert(D == 32 || D == 64 || D == 128, "D in {32, 64, 128}");
  static constexpr int ATOM = D < 64 ? D : 64;  // columns per TMA box
  static constexpr int SW = ATOM * 2;           // swizzle span, bytes
  static constexpr int BOXES = D / ATOM;
  static constexpr uint32_t ITEM_BYTES = BI * D * 2;  // one [BI][D] tile
  static constexpr uint32_t TILE_BYTES = BT * D * 2;  // one [BT][D] tile
  // B3: Q, dO, O and the lse rows of an item (two buffers below D 128, so
  // that the next item's land early) and a ring of (K, V) tiles
  static constexpr int DQ_QBUF = D == 128 ? 1 : 2;
  static constexpr int DQ_STAGES = 4;
  static constexpr size_t DQ_SMEM =
      1024 + DQ_QBUF * (3 * (size_t)ITEM_BYTES + BI * sizeof(float)) +
      DQ_STAGES * 2 * (size_t)TILE_BYTES + 256;
  // B2: K and V of an item (two buffers below D 128) and a ring of (Q, dO,
  // lse, delta) tiles
  static constexpr int KVBUF = D == 128 ? 1 : 2;
  static constexpr int DKV_STAGES = D == 128 ? 3 : 4;
  static constexpr size_t DKV_SMEM =
      1024 + KVBUF * 2 * (size_t)ITEM_BYTES +
      DKV_STAGES * (2 * (size_t)TILE_BYTES + 2 * BT * sizeof(float)) + 256;
  static_assert(DQ_SMEM <= 232448 && DKV_SMEM <= 232448, "227 KB a block");
};

struct Band {
  int t_len, causal, window;
};

// some (query, key) of queries [qs, qs + 64) x keys [ks, ks + 64) visible
__device__ __forceinline__ bool any_visible(int qs, int ks, const Band& m) {
  return qs < m.t_len && ks < m.t_len && (!m.causal || ks <= qs + 63) &&
         (m.window <= 0 || qs - (ks + 63) < m.window);
}

// every (query, key) of that square visible
__device__ __forceinline__ bool all_visible(int qs, int ks, const Band& m) {
  return qs + 63 < m.t_len && ks + 63 < m.t_len &&
         (!m.causal || ks + 63 <= qs) &&
         (m.window <= 0 || qs + 63 - ks < m.window);
}

// acc = A B^T for one consumer's 64 rows: A, its rows of an item buffer
// (BOXES x [BI][ATOM]), B a streamed tile (BOXES x [BT][ATOM]); both
// K-major, D / 16 k-steps of m64n64k16
template <int D>
__device__ __forceinline__ void issue_abt(float (&acc)[NS], const bf16* a,
                                          const bf16* b) {
  constexpr int ATOM = Cfg<D>::ATOM;
  constexpr int SW = Cfg<D>::SW;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int x = kk / (ATOM / 16);           // box of this k-step
    const int off = (kk % (ATOM / 16)) * 16;  // columns into the box
    wgmma_ss<BT, 0>(acc, desc_k_major<SW>(a + x * BI * ATOM + off),
                    desc_k_major<SW>(b + x * BT * ATOM + off), kk > 0);
  }
}

// acc += A B: A from registers (BT / 16 k16 slices), B a streamed tile
// [BT][D] read MN-major
template <int D>
__device__ __forceinline__ void issue_ab(float (&acc)[D / 2],
                                         const uint32_t (&a)[BT / 16][4],
                                         const bf16* b) {
  constexpr int ATOM = Cfg<D>::ATOM;
  constexpr int SW = Cfg<D>::SW;
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
    wgmma_rs<D, 1>(acc, a[kk],
                   desc_mn_major<SW>(b + kk * 16 * ATOM, BT * ATOM * 2), 1);
}

// an accumulator as bf16 A fragments: n8 tiles 2 kk, 2 kk + 1 make k16
// slice kk
__device__ __forceinline__ void pack(uint32_t (&pa)[BT / 16][4],
                                     const float (&sc)[NS]) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(a[i]);
}

// rowsum(dO * O) over this thread's quarter (D / 4 columns from tg D / 4)
// of row r of an item's dO and O tiles in shared memory (BOXES x [BI][ATOM]
// each, in the TMA's swizzle: 16-byte chunk c of row r lies at chunk
// c ^ (r % 8) in 128-byte atoms, c ^ (r / 2 % 4) in 64-byte ones). Rows
// past T were loaded as zeros and give 0.
template <int D>
__device__ __forceinline__ float dot_quarter(const bf16* gs, const bf16* os,
                                             int r, int tg) {
  constexpr int ATOM = Cfg<D>::ATOM;
  const int swz = Cfg<D>::SW == 128 ? (r & 7) : ((r >> 1) & 3);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    const int col = tg * (D / 4) + 8 * i;
    const int off = (col / ATOM) * BI * ATOM + r * ATOM +
                    (((col % ATOM) / 8) ^ swz) * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(gs + off);
    const uint4 o = *reinterpret_cast<const uint4*>(os + off);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fa = __bfloat1622float2(a2[e]);
      const float2 fo = __bfloat1622float2(o2[e]);
      s = fmaf(fa.x, fo.x, s);
      s = fmaf(fa.y, fo.y, s);
    }
  }
  return s;
}

// the sum of a quad's four values
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// this thread's consumer (0 or 1), as a value ptxas knows to be the same
// across the warp (a shuffle from lane 0, as CUTLASS does): loops whose
// trip counts depend on it are then no divergent paths, around which
// ptxas would serialise the wgmma
__device__ __forceinline__ int consumer_index() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0) - 1;
}

// [lo, hi): the run of tiles 0 .. n - 1 for which live(i) holds (it holds
// on one contiguous run, possibly empty)
template <class F>
__device__ __forceinline__ void live_range(int n, const F& live, int& lo,
                                           int& hi) {
  lo = 0;
  while (lo < n && !live(lo)) ++lo;
  hi = n;
  while (hi > lo && !live(hi - 1)) --hi;
}

// the n-th item of this block: rounds alternate direction over the blocks
// (a zig-zag), so that with items numbered longest first the sums even out
__device__ __forceinline__ int item_of(int n) {
  const int g = (n & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  return n * (int)gridDim.x + g;
}

// One B3 item: a 128-row query tile of one (batch, head), and the band of
// 64-key tiles it reads. Item w is query tile w / (B H) from the end
// (causal: the longest first) or the start, of head w % (B H).
struct DqWork {
  int b, h, kvh, bh, q0, k_lo, n_tiles;

  __device__ __forceinline__ DqWork(int w, int q_tiles, int batch_heads,
                                    int heads, int kv_heads, int t_len,
                                    int causal, int window) {
    const int qt = w / batch_heads;
    bh = w % batch_heads;
    b = bh / heads;
    h = bh % heads;
    kvh = h / (heads / kv_heads);
    q0 = (causal ? q_tiles - 1 - qt : qt) * BI;
    k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    k_lo = (k_lo / BT) * BT;
    const int k_hi = causal ? min(t_len, q0 + BI) : t_len;
    n_tiles = (k_hi - k_lo + BT - 1) / BT;
  }
};

// B3: dQ and delta. Persistent: at most one block per SM, each walking its
// items (item_of); the producer runs ahead across items.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap g_map,
                       const __grid_constant__ CUtensorMap o_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const float* __restrict__ lse,
                       const float* __restrict__ g_lse,
                       float* __restrict__ delta, bf16* __restrict__ dq,
                       int batch_heads, int t_len, int heads, int kv_heads,
                       int causal, int window, float scale) {
  using C = Cfg<D>;
  constexpr int ATOM = C::ATOM;
  constexpr int NO = D / 2;  // dQ accumulator registers per thread
  constexpr int STAGES = C::DQ_STAGES;
  constexpr int QBUF = C::DQ_QBUF;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(base);  // QBUF x BOXES x [BI][ATOM]
  bf16* g_s = q_s + QBUF * BI * D;            // dO, as Q
  bf16* o_s = g_s + QBUF * BI * D;            // O, as Q
  bf16* k_s = o_s + QBUF * BI * D;            // STAGES x BOXES x [BT][ATOM]
  bf16* v_s = k_s + STAGES * BT * D;
  float* l_s = reinterpret_cast<float*>(v_s + STAGES * BT * D);  // [QBUF][BI]
  uint64_t* bars = reinterpret_cast<uint64_t*>(l_s + QBUF * BI);
  uint64_t* q_full = bars;                 // [QBUF] Q, dO, O and lse
  uint64_t* q_empty = q_full + QBUF;       // [QBUF]
  uint64_t* kv_full = q_empty + QBUF;      // [STAGES] K and V
  uint64_t* kv_empty = kv_full + STAGES;   // [STAGES]

  const int q_tiles = (t_len + BI - 1) / BI;
  const int items = q_tiles * batch_heads;

  if (threadIdx.x == 0) {
    for (int x = 0; x < QBUF; ++x) {
      // the TMA's arrival and the 32 cp.async arrivals of the producer warp
      mbar_init(&q_full[x], 1 + 32);
      mbar_init(&q_empty[x], 2 * 128);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warp: per item Q, dO and O by TMA (lane 0) and the lse
    // rows by cp.async, then (lane 0) its (K, V) tiles ----
    setmaxnreg_dec<DqRegs::PRODUCER>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int it = 0;  // tiles loaded before this item: stage it % STAGES
      for (int n = 0;; ++n) {
        const int w = item_of(n);
        if (w >= items) break;
        const DqWork wk(w, q_tiles, batch_heads, heads, kv_heads, t_len,
                        causal, window);
        const int qb = n % QBUF;
        mbar_wait(&q_empty[qb], ((n / QBUF) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&q_full[qb], 3 * C::ITEM_BYTES);
          for (int x = 0; x < C::BOXES; ++x) {
            const int o = qb * BI * D + x * BI * ATOM;
            tma_load_4d(q_s + o, &q_map, &q_full[qb], x * ATOM, wk.h, wk.q0,
                        wk.b);
            tma_load_4d(g_s + o, &g_map, &q_full[qb], x * ATOM, wk.h, wk.q0,
                        wk.b);
            tma_load_4d(o_s + o, &o_map, &q_full[qb], x * ATOM, wk.h, wk.q0,
                        wk.b);
          }
        }
        // rows past T read row T - 1: their results are never stored
        const float* lrow = lse + (size_t)wk.bh * t_len;
#pragma unroll
        for (int e = lane; e < BI; e += 32)
          cp_async_4(&l_s[qb * BI + e], lrow + min(wk.q0 + e, t_len - 1));
        cp_async_mbar_arrive(&q_full[qb]);
        if (lane == 0) {
          for (int i = 0; i < wk.n_tiles; ++i) {
            const int j = it + i, s = j % STAGES;
            mbar_wait(&kv_empty[s], ((j / STAGES) & 1) ^ 1);
            mbar_expect_tx(&kv_full[s], 2 * C::TILE_BYTES);
            for (int x = 0; x < C::BOXES; ++x) {
              tma_load_4d(k_s + s * BT * D + x * BT * ATOM, &k_map,
                          &kv_full[s], x * ATOM, wk.kvh, wk.k_lo + i * BT,
                          wk.b);
              tma_load_4d(v_s + s * BT * D + x * BT * ATOM, &v_map,
                          &kv_full[s], x * ATOM, wk.kvh, wk.k_lo + i * BT,
                          wk.b);
            }
          }
        }
        it += wk.n_tiles;
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    setmaxnreg_inc<DqRegs::CONSUMER>();
    const int cw = consumer_index();
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int tg = lane & 3;
    const Band band{t_len, causal, window};
    const float scale2 = scale * LOG2E;
    const size_t q_row = (size_t)heads * D;
    int it = 0;  // tiles consumed so far
    for (int n = 0;; ++n) {
      const int w = item_of(n);
      if (w >= items) break;
      const DqWork wk(w, q_tiles, batch_heads, heads, kv_heads, t_len,
                      causal, window);
      const int qb = n % QBUF;
      const int rbase = wk.q0 + cw * RW;
      const int lr0 = cw * RW + warp * 16 + (lane >> 2);  // rows in the item
      const int lr1 = lr0 + 8;
      const int r0 = wk.q0 + lr0, r1 = wk.q0 + lr1;
      const bf16* q_wg = q_s + qb * BI * D + cw * RW * ATOM;
      const bf16* g_wg = g_s + qb * BI * D + cw * RW * ATOM;
      mbar_wait(&q_full[qb], (n / QBUF) & 1);

      // delta and lse of rows r0, r1
      const float s0 = quad_sum(
          dot_quarter<D>(g_s + qb * BI * D, o_s + qb * BI * D, lr0, tg));
      const float s1 = quad_sum(
          dot_quarter<D>(g_s + qb * BI * D, o_s + qb * BI * D, lr1, tg));
      const size_t row = (size_t)wk.bh * t_len;
      const float d0 = s0 - (g_lse && r0 < t_len ? g_lse[row + r0] : 0.f);
      const float d1 = s1 - (g_lse && r1 < t_len ? g_lse[row + r1] : 0.f);
      if (tg == 0) {
        if (r0 < t_len) delta[row + r0] = d0;
        if (r1 < t_len) delta[row + r1] = d1;
      }
      const float l0 = l_s[qb * BI + lr0] * LOG2E;
      const float l1 = l_s[qb * BI + lr1] * LOG2E;

      float dqa[NO];
      zero(dqa);
      float sc[NS], dp[NS];
      uint32_t dsa[BT / 16][4];
      // dS = P (dP - delta) scale, P = exp2(S scale log2e - lse log2e), in
      // place in dp, for the tile at key k0
      const auto dscores = [&](int k0) {
        if (all_visible(rbase, k0, band)) {
#pragma unroll
          for (int e = 0; e < NS; ++e) {
            const bool top = (e & 2) == 0;
            const float p = ex2_approx(fmaf(sc[e], scale2, -(top ? l0 : l1)));
            dp[e] = p * (dp[e] - (top ? d0 : d1)) * scale;
          }
        } else {
#pragma unroll
          for (int e = 0; e < NS; ++e) {
            const bool top = (e & 2) == 0;
            const int col = k0 + (e >> 2) * 8 + tg * 2 + (e & 1);
            const float p =
                visible(top ? r0 : r1, col, t_len, causal, window)
                    ? ex2_approx(fmaf(sc[e], scale2, -(top ? l0 : l1)))
                    : 0.f;
            dp[e] = p * (dp[e] - (top ? d0 : d1)) * scale;
          }
        }
      };
      // a tile this consumer sees nothing of: only handed back (after it
      // has landed, so that the release counts in this round)
      const auto skip = [&](int i) {
        const int j = it + i, s = j % STAGES;
        mbar_wait(&kv_full[s], (j / STAGES) & 1);
        mbar_arrive(&kv_empty[s]);
      };
      int lo, hi;  // the tiles this consumer's rows see something of
      live_range(wk.n_tiles, [&](int i) {
        return any_visible(rbase, wk.k_lo + i * BT, band);
      }, lo, hi);

      for (int i = 0; i < lo; ++i) skip(i);
      if (lo == hi) mbar_arrive(&q_empty[qb]);
      if (lo < hi) {
        // tile lo: its S and dP alone
        {
          const int j = it + lo, s = j % STAGES;
          mbar_wait(&kv_full[s], (j / STAGES) & 1);
          wgmma_fence();
          issue_abt<D>(sc, q_wg, k_s + s * BT * D);
          issue_abt<D>(dp, g_wg, v_s + s * BT * D);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          fence_regs(dp);
          if (lo + 1 == hi) mbar_arrive(&q_empty[qb]);
          dscores(wk.k_lo + lo * BT);
          pack(dsa, dp);
        }
        // tile i: S_i and dP_i issued, then dS_{i-1} K_{i-1}; dS_i on the
        // CUDA cores while dS_{i-1} K_{i-1} runs; then K_{i-1} and V_{i-1}
        // go back to the producer
        for (int i = lo + 1; i < hi; ++i) {
          const int sp = (it + i - 1) % STAGES;
          const int j = it + i, s = j % STAGES;
          mbar_wait(&kv_full[s], (j / STAGES) & 1);
          wgmma_fence();
          issue_abt<D>(sc, q_wg, k_s + s * BT * D);
          issue_abt<D>(dp, g_wg, v_s + s * BT * D);
          wgmma_commit();
          issue_ab<D>(dqa, dsa, k_s + sp * BT * D);
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(sc);
          fence_regs(dp);
          if (i + 1 == hi) mbar_arrive(&q_empty[qb]);
          dscores(wk.k_lo + i * BT);
          wgmma_wait<0>();
          fence_regs(dqa);
          fence_frags(dsa);
          mbar_arrive(&kv_empty[sp]);
          pack(dsa, dp);
        }
        // the last live tile's dS K
        const int s = (it + hi - 1) % STAGES;
        wgmma_fence();
        issue_ab<D>(dqa, dsa, k_s + s * BT * D);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dqa);
        fence_frags(dsa);
        mbar_arrive(&kv_empty[s]);
      }
      for (int i = hi; i < wk.n_tiles; ++i) skip(i);
      it += wk.n_tiles;

      bf16* dqb = dq + (size_t)wk.b * t_len * q_row + (size_t)wk.h * D;
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn) {
        const int c = jn * 8 + tg * 2;
        if (r0 < t_len)
          *reinterpret_cast<uint32_t*>(dqb + (size_t)r0 * q_row + c) =
              pack_bf16(dqa[4 * jn], dqa[4 * jn + 1]);
        if (r1 < t_len)
          *reinterpret_cast<uint32_t*>(dqb + (size_t)r1 * q_row + c) =
              pack_bf16(dqa[4 * jn + 2], dqa[4 * jn + 3]);
      }
    }
  }
}

// One B2 item: a 128-key tile of one (batch, kv head) and the query heads
// [h_lo, h_lo + n_heads) of its group (all of them unless the group is
// split), with the 64-query tiles [q_lo, q_lo + 64 n_qt) the mask leaves
// visible. Item w is key tile w / (B KVH splits) from the start (causal:
// the longest first). Its (head, query tile) pairs run query tile major:
// pair i is head h_lo + i % n_heads, query tile i / n_heads, so that the
// pairs a consumer sees something of are one contiguous run.
struct DkvWork {
  int b, kvh, k0, split, h_lo, n_heads, q_lo, n_qt, n_pairs;

  __device__ __forceinline__ DkvWork(int w, int batch_kv, int kv_heads,
                                     int groups, int splits, int t_len,
                                     int causal, int window) {
    const int per = batch_kv * splits;
    const int rem = w % per;
    k0 = (w / per) * BI;
    split = rem % splits;
    b = (rem / splits) / kv_heads;
    kvh = (rem / splits) % kv_heads;
    h_lo = kvh * groups + split * groups / splits;
    n_heads = kvh * groups + (split + 1) * groups / splits - h_lo;
    q_lo = causal ? (k0 / BT) * BT : 0;
    const int k_last = min(k0 + BI, t_len) - 1;
    const int q_hi = window > 0 ? min(t_len, k_last + window) : t_len;
    n_qt = (q_hi - q_lo + BT - 1) / BT;
    n_pairs = n_heads * n_qt;
  }
};

// B2: dK and dV (or, split, their f32 partial sums). Persistent, as B3.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap g_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        float* __restrict__ part, int batch, int t_len,
                        int heads, int kv_heads, int splits, int causal,
                        int window, float scale) {
  using C = Cfg<D>;
  constexpr int ATOM = C::ATOM;
  constexpr int NO = D / 2;  // dK / dV accumulator registers per thread
  constexpr int STAGES = C::DKV_STAGES;
  constexpr int KVBUF = C::KVBUF;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  bf16* k_s = reinterpret_cast<bf16*>(base);  // KVBUF x BOXES x [BI][ATOM]
  bf16* v_s = k_s + KVBUF * BI * D;
  bf16* q_s = v_s + KVBUF * BI * D;           // STAGES x BOXES x [BT][ATOM]
  bf16* g_s = q_s + STAGES * BT * D;          // dO, as Q
  float* lse_s = reinterpret_cast<float*>(g_s + STAGES * BT * D);  // [S][BT]
  float* dl_s = lse_s + STAGES * BT;                               // delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(dl_s + STAGES * BT);
  uint64_t* kv_full = bars;                 // [KVBUF] K and V
  uint64_t* kv_empty = kv_full + KVBUF;     // [KVBUF]
  uint64_t* st_full = kv_empty + KVBUF;     // [STAGES] Q, dO, lse, delta
  uint64_t* st_empty = st_full + STAGES;    // [STAGES]

  const int k_tiles = (t_len + BI - 1) / BI;
  const int batch_kv = batch * kv_heads;
  const int groups = heads / kv_heads;
  const int items = k_tiles * batch_kv * splits;

  if (threadIdx.x == 0) {
    for (int x = 0; x < KVBUF; ++x) {
      mbar_init(&kv_full[x], 1);
      mbar_init(&kv_empty[x], 2 * 128);
    }
    for (int s = 0; s < STAGES; ++s) {
      // the TMA's arrival and the 32 cp.async arrivals of the producer warp
      mbar_init(&st_full[s], 1 + 32);
      mbar_init(&st_empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warp: per item K and V, then its (head, query tile)
    // pairs: Q and dO by TMA (lane 0), lse and delta rows by cp.async ----
    setmaxnreg_dec<DkvRegs::PRODUCER>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int it = 0;  // pairs loaded before this item: stage it % STAGES
      for (int n = 0;; ++n) {
        const int w = item_of(n);
        if (w >= items) break;
        const DkvWork wk(w, batch_kv, kv_heads, groups, splits, t_len,
                         causal, window);
        const int kb = n % KVBUF;
        if (lane == 0) {
          mbar_wait(&kv_empty[kb], ((n / KVBUF) & 1) ^ 1);
          mbar_expect_tx(&kv_full[kb], 2 * C::ITEM_BYTES);
          for (int x = 0; x < C::BOXES; ++x) {
            tma_load_4d(k_s + kb * BI * D + x * BI * ATOM, &k_map,
                        &kv_full[kb], x * ATOM, wk.kvh, wk.k0, wk.b);
            tma_load_4d(v_s + kb * BI * D + x * BI * ATOM, &v_map,
                        &kv_full[kb], x * ATOM, wk.kvh, wk.k0, wk.b);
          }
        }
        for (int i = 0; i < wk.n_pairs; ++i) {
          const int h = wk.h_lo + i % wk.n_heads;
          const int q0 = wk.q_lo + (i / wk.n_heads) * BT;
          const int j = it + i, s = j % STAGES;
          mbar_wait(&st_empty[s], ((j / STAGES) & 1) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(&st_full[s], 2 * C::TILE_BYTES);
            for (int x = 0; x < C::BOXES; ++x) {
              tma_load_4d(q_s + s * BT * D + x * BT * ATOM, &q_map,
                          &st_full[s], x * ATOM, h, q0, wk.b);
              tma_load_4d(g_s + s * BT * D + x * BT * ATOM, &g_map,
                          &st_full[s], x * ATOM, h, q0, wk.b);
            }
          }
          // rows past T read row T - 1: the consumers mask those queries
          const size_t row = ((size_t)wk.b * heads + h) * t_len;
#pragma unroll
          for (int e = lane; e < BT; e += 32) {
            const int tq = min(q0 + e, t_len - 1);
            cp_async_4(&lse_s[s * BT + e], lse + row + tq);
            cp_async_4(&dl_s[s * BT + e], delta + row + tq);
          }
          cp_async_mbar_arrive(&st_full[s]);
        }
        it += wk.n_pairs;
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    setmaxnreg_inc<DkvRegs::CONSUMER>();
    const int cw = consumer_index();
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int tg = lane & 3;
    const Band band{t_len, causal, window};
    const float scale2 = scale * LOG2E;
    const size_t kv_row = (size_t)kv_heads * D;
    int it = 0;  // pairs consumed so far
    for (int n = 0;; ++n) {
      const int w = item_of(n);
      if (w >= items) break;
      const DkvWork wk(w, batch_kv, kv_heads, groups, splits, t_len, causal,
                       window);
      const int kb = n % KVBUF;
      const int kbase = wk.k0 + cw * RW;
      const int kr0 = kbase + warp * 16 + (lane >> 2);  // this thread's keys
      const int kr1 = kr0 + 8;
      const bf16* k_wg = k_s + kb * BI * D + cw * RW * ATOM;
      const bf16* v_wg = v_s + kb * BI * D + cw * RW * ATOM;
      float dka[NO], dva[NO];
      zero(dka);
      zero(dva);
      float sc[NS], dp[NS];
      uint32_t pa[BT / 16][4], dsa[BT / 16][4];
      mbar_wait(&kv_full[kb], (n / KVBUF) & 1);

      // P^T of one pair, in place in sc (0 where masked)
      const auto probs = [&](int s, int q0) {
        const float* ls = lse_s + s * BT;
        if (all_visible(q0, kbase, band)) {
#pragma unroll
          for (int e = 0; e < NS; ++e) {
            const int c = (e >> 2) * 8 + tg * 2 + (e & 1);
            sc[e] = ex2_approx(fmaf(sc[e], scale2, -ls[c] * LOG2E));
          }
        } else {
#pragma unroll
          for (int e = 0; e < NS; ++e) {
            const int c = (e >> 2) * 8 + tg * 2 + (e & 1);
            sc[e] = visible(q0 + c, (e & 2) ? kr1 : kr0, t_len, causal,
                            window)
                        ? ex2_approx(fmaf(sc[e], scale2, -ls[c] * LOG2E))
                        : 0.f;
          }
        }
      };
      // a pair this consumer sees nothing of: only handed back (after it
      // has landed, so that the release counts in this round)
      const auto skip = [&](int i) {
        const int j = it + i, s = j % STAGES;
        mbar_wait(&st_full[s], (j / STAGES) & 1);
        mbar_arrive(&st_empty[s]);
      };
      int lo, hi;  // the query tiles, then pairs, these keys are seen from
      live_range(wk.n_qt, [&](int q) {
        return any_visible(wk.q_lo + q * BT, kbase, band);
      }, lo, hi);
      lo *= wk.n_heads;
      hi *= wk.n_heads;

      for (int i = 0; i < lo; ++i) skip(i);
      // pair i: S^T and dP^T, P^T and dS^T in registers, then dV += P^T dO
      // and dK += dS^T Q
      for (int i = lo; i < hi; ++i) {
        const int j = it + i, s = j % STAGES;
        const bf16* qs = q_s + s * BT * D;
        const bf16* gs = g_s + s * BT * D;
        mbar_wait(&st_full[s], (j / STAGES) & 1);
        wgmma_fence();
        issue_abt<D>(sc, k_wg, qs);
        issue_abt<D>(dp, v_wg, gs);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        probs(s, wk.q_lo + (i / wk.n_heads) * BT);
        pack(pa, sc);
        const float* ds = dl_s + s * BT;
#pragma unroll
        for (int e = 0; e < NS; ++e)
          dp[e] = sc[e] * (dp[e] - ds[(e >> 2) * 8 + tg * 2 + (e & 1)]) *
                  scale;
        pack(dsa, dp);
        wgmma_fence();
        issue_ab<D>(dva, pa, gs);
        issue_ab<D>(dka, dsa, qs);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dka);
        fence_regs(dva);
        fence_frags(pa);
        fence_frags(dsa);
        mbar_arrive(&st_empty[s]);
      }
      for (int i = hi; i < wk.n_pairs; ++i) skip(i);
      mbar_arrive(&kv_empty[kb]);
      it += wk.n_pairs;

      const size_t kv_off = (size_t)wk.b * t_len * kv_row + (size_t)wk.kvh * D;
      if (splits == 1) {
#pragma unroll
        for (int jn = 0; jn < D / 8; ++jn) {
          const int c = jn * 8 + tg * 2;
          if (kr0 < t_len) {
            const size_t o = kv_off + (size_t)kr0 * kv_row + c;
            *reinterpret_cast<uint32_t*>(dk + o) =
                pack_bf16(dka[4 * jn], dka[4 * jn + 1]);
            *reinterpret_cast<uint32_t*>(dv + o) =
                pack_bf16(dva[4 * jn], dva[4 * jn + 1]);
          }
          if (kr1 < t_len) {
            const size_t o = kv_off + (size_t)kr1 * kv_row + c;
            *reinterpret_cast<uint32_t*>(dk + o) =
                pack_bf16(dka[4 * jn + 2], dka[4 * jn + 3]);
            *reinterpret_cast<uint32_t*>(dv + o) =
                pack_bf16(dva[4 * jn + 2], dva[4 * jn + 3]);
          }
        }
      } else {
        // partial sums: part [2][splits][B][T][KVH][D] f32 (dK, then dV)
        const size_t n_all = (size_t)batch * t_len * kv_row;
        float* pk = part + (size_t)wk.split * n_all + kv_off;
        float* pv = pk + (size_t)splits * n_all;
#pragma unroll
        for (int jn = 0; jn < D / 8; ++jn) {
          const int c = jn * 8 + tg * 2;
          if (kr0 < t_len) {
            const size_t o = (size_t)kr0 * kv_row + c;
            *reinterpret_cast<float2*>(pk + o) =
                make_float2(dka[4 * jn], dka[4 * jn + 1]);
            *reinterpret_cast<float2*>(pv + o) =
                make_float2(dva[4 * jn], dva[4 * jn + 1]);
          }
          if (kr1 < t_len) {
            const size_t o = (size_t)kr1 * kv_row + c;
            *reinterpret_cast<float2*>(pk + o) =
                make_float2(dka[4 * jn + 2], dka[4 * jn + 3]);
            *reinterpret_cast<float2*>(pv + o) =
                make_float2(dva[4 * jn + 2], dva[4 * jn + 3]);
          }
        }
      }
    }
  }
}

// dK, dV = the split partial sums added in split order (n = B T KVH D, a
// multiple of 4)
__global__ void __launch_bounds__(256)
    flash_bwd_dkv_sum(const float* __restrict__ part, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, size_t n, int splits) {
  const size_t n4 = n / 4;
  const float4* p4 = reinterpret_cast<const float4*>(part);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 a = p4[i], b = p4[splits * n4 + i];
    for (int s = 1; s < splits; ++s) {
      const float4 x = p4[s * n4 + i], y = p4[(splits + s) * n4 + i];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
      b.x += y.x;
      b.y += y.y;
      b.z += y.z;
      b.w += y.w;
    }
    __nv_bfloat162* k2 = reinterpret_cast<__nv_bfloat162*>(dk) + 2 * i;
    __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(dv) + 2 * i;
    k2[0] = __floats2bfloat162_rn(a.x, a.y);
    k2[1] = __floats2bfloat162_rn(a.z, a.w);
    v2[0] = __floats2bfloat162_rn(b.x, b.y);
    v2[1] = __floats2bfloat162_rn(b.z, b.w);
  }
}

// a 4-D map over [B, T, heads, D] bf16 with boxes of `rows` tokens x one
// swizzle atom of D
template <int D>
bool tile_map(CUtensorMap* map, const void* p, int batch, int t_len,
              int heads, int rows) {
  using C = Cfg<D>;
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)heads, (uint64_t)t_len,
                            (uint64_t)batch};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)heads * D * 2,
                               (uint64_t)t_len * heads * D * 2};
  const uint32_t box[4] = {(uint32_t)C::ATOM, 1u, (uint32_t)rows, 1u};
  return encode_map(map, p, 4, dims, strides, box, C::SW);
}

// the current device's SM count, read once per device and process
cudaError_t sm_count(int* sms) {
  constexpr int MAX_DEVICES = 64;
  static int cached[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES)
    return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                  device);
  if (cached[device] == 0 &&
      (err = cudaDeviceGetAttribute(&cached[device],
                                    cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  *sms = cached[device];
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* go, const void* out, const float* lse,
                      const float* g_lse, float* delta, void* dq, int batch,
                      int t_len, int heads, int kv_heads, int causal,
                      int window, float scale, cudaStream_t stream) {
  CUtensorMap q_map, g_map, o_map, k_map, v_map;
  if (!tile_map<D>(&q_map, q, batch, t_len, heads, BI) ||
      !tile_map<D>(&g_map, go, batch, t_len, heads, BI) ||
      !tile_map<D>(&o_map, out, batch, t_len, heads, BI) ||
      !tile_map<D>(&k_map, k, batch, t_len, kv_heads, BT) ||
      !tile_map<D>(&v_map, v, batch, t_len, kv_heads, BT))
    return cudaErrorInvalidValue;
  const size_t smem = Cfg<D>::DQ_SMEM;
  // once per process, as B4 does
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int items = ((t_len + BI - 1) / BI) * batch * heads;
  flash_bwd_dq_wgmma<D><<<min(items, sms), THREADS, smem, stream>>>(
      q_map, g_map, o_map, k_map, v_map, lse, g_lse, delta,
      static_cast<bf16*>(dq), batch * heads, t_len, heads, kv_heads, causal,
      window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* go, const float* lse, const float* delta,
                       void* dk, void* dv, float* part, int batch, int t_len,
                       int heads, int kv_heads, int splits, int causal,
                       int window, float scale, cudaStream_t stream) {
  if (splits < 1 || splits > heads / kv_heads ||
      (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap q_map, g_map, k_map, v_map;
  if (!tile_map<D>(&q_map, q, batch, t_len, heads, BT) ||
      !tile_map<D>(&g_map, go, batch, t_len, heads, BT) ||
      !tile_map<D>(&k_map, k, batch, t_len, kv_heads, BI) ||
      !tile_map<D>(&v_map, v, batch, t_len, kv_heads, BI))
    return cudaErrorInvalidValue;
  const size_t smem = Cfg<D>::DKV_SMEM;
  // once per process, as B4 does
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int items = ((t_len + BI - 1) / BI) * batch * kv_heads * splits;
  flash_bwd_dkv_wgmma<D><<<min(items, sms), THREADS, smem, stream>>>(
      q_map, g_map, k_map, v_map, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), part, batch, t_len, heads, kv_heads, splits,
      causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = (size_t)batch * t_len * kv_heads * D;
  const size_t blocks = (n / 4 + 255) / 256;
  flash_bwd_dkv_sum<<<(int)(blocks < (size_t)sms * 8 ? blocks : sms * 8),
                      256, 0, stream>>>(part, static_cast<bf16*>(dk),
                                        static_cast<bf16*>(dv), n, splits);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int BM = 32;        // rows a block owns
constexpr int BN = 32;        // rows of a streamed tile
constexpr int THREADS = 256;  // 8 threads per owned row in the sums
constexpr int SS = BN + 1;    // padded row stride of the P / dS tiles
static_assert(THREADS == 8 * BM, "8 threads per owned row");

template <int D>
struct Layout {
  static constexpr int QS = D + 1;  // padded row stride of the tiles
  static constexpr size_t bytes =
      ((size_t)(2 * BM + 2 * BN) * QS + 2 * (size_t)BM * SS + 2 * BN) *
      sizeof(float);
};

// rows [r0, r0 + n) of a [T, heads * D] tensor into smem (zero past T)
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          size_t row, int r0, int n,
                                          int t_len, int tid) {
  constexpr int QS = Layout<D>::QS;
  for (int i = tid; i < n * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int t = r0 + r;
    dst[r * QS + c] = t < t_len ? src[(size_t)t * row + c] : 0.f;
  }
}

// B2, f32: dK, dV of one (batch, kv head, key tile)
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_f32(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ go,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv,
                      int t_len, int heads, int kv_heads, int causal,
                      int window, float scale) {
  constexpr int QS = Layout<D>::QS;
  constexpr int CPT = D / 8;  // output columns per thread

  extern __shared__ float smem_f[];
  float* k_s = smem_f;              // [BM][QS]
  float* v_s = k_s + BM * QS;       // [BM][QS]
  float* q_s = v_s + BM * QS;       // [BN][QS]
  float* g_s = q_s + BN * QS;       // [BN][QS]
  float* p_s = g_s + BN * QS;       // [BM][SS]  P^T
  float* ds_s = p_s + BM * SS;      // [BM][SS]  dS^T
  float* lse_s = ds_s + BM * SS;    // [BN]
  float* dl_s = lse_s + BN;         // [BN]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BM;
  const int b = blockIdx.y / kv_heads;
  const int kvh = blockIdx.y % kv_heads;
  const int groups = heads / kv_heads;
  const size_t q_row = (size_t)heads * D;
  const size_t kv_row = (size_t)kv_heads * D;
  const size_t kv_off = (size_t)b * t_len * kv_row + (size_t)kvh * D;

  load_rows<D>(k_s, k + kv_off, kv_row, k0, BM, t_len, tid);
  load_rows<D>(v_s, v + kv_off, kv_row, k0, BM, t_len, tid);

  const int ar = tid / 8;   // the key row this thread sums
  const int ac = tid % 8;   // its columns: ac + 8 j
  float dka[CPT], dva[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) dka[j] = dva[j] = 0.f;

  const int k_last = min(k0 + BM, t_len) - 1;
  const int q_lo = causal ? (k0 / BN) * BN : 0;
  const int q_hi = window > 0 ? min(t_len, k_last + window) : t_len;

  for (int hh = 0; hh < groups; ++hh) {
    const int h = kvh * groups + hh;
    const size_t q_off = (size_t)b * t_len * q_row + (size_t)h * D;
    const float* lrow = lse + ((size_t)b * heads + h) * t_len;
    const float* drow = delta + ((size_t)b * heads + h) * t_len;
    for (int q0 = q_lo; q0 < q_hi; q0 += BN) {
      __syncthreads();
      load_rows<D>(q_s, q + q_off, q_row, q0, BN, t_len, tid);
      load_rows<D>(g_s, go + q_off, q_row, q0, BN, t_len, tid);
      for (int i = tid; i < BN; i += THREADS) {
        const int t = q0 + i;
        lse_s[i] = t < t_len ? lrow[t] : 0.f;
        dl_s[i] = t < t_len ? drow[t] : 0.f;
      }
      __syncthreads();
      // P^T and dS^T: one (key, query) entry per pass, a warp on one key
      for (int e = tid; e < BM * BN; e += THREADS) {
        const int kr = e / BN, qc = e % BN;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          s = fmaf(k_s[kr * QS + d], q_s[qc * QS + d], s);
          dp = fmaf(v_s[kr * QS + d], g_s[qc * QS + d], dp);
        }
        const float p = visible(q0 + qc, k0 + kr, t_len, causal, window)
                            ? expf(s * scale - lse_s[qc])
                            : 0.f;
        p_s[kr * SS + qc] = p;
        ds_s[kr * SS + qc] = p * (dp - dl_s[qc]) * scale;
      }
      __syncthreads();
#pragma unroll 4
      for (int qc = 0; qc < BN; ++qc) {
        const float p = p_s[ar * SS + qc];
        const float ds = ds_s[ar * SS + qc];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          dva[j] = fmaf(p, g_s[qc * QS + ac + 8 * j], dva[j]);
          dka[j] = fmaf(ds, q_s[qc * QS + ac + 8 * j], dka[j]);
        }
      }
    }
  }
  const int t = k0 + ar;
  if (t < t_len) {
    float* dkr = dk + kv_off + (size_t)t * kv_row;
    float* dvr = dv + kv_off + (size_t)t * kv_row;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      dkr[ac + 8 * j] = dka[j];
      dvr[ac + 8 * j] = dva[j];
    }
  }
}

// B3, f32: dQ and delta of one (batch, query head, query tile)
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_f32(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ go,
                     const float* __restrict__ out,
                     const float* __restrict__ lse,
                     const float* __restrict__ g_lse,
                     float* __restrict__ delta, float* __restrict__ dq,
                     int t_len, int heads, int kv_heads, int causal,
                     int window, float scale) {
  constexpr int QS = Layout<D>::QS;
  constexpr int CPT = D / 8;

  extern __shared__ float smem_f[];
  float* q_s = smem_f;              // [BM][QS]
  float* g_s = q_s + BM * QS;       // [BM][QS]
  float* k_s = g_s + BM * QS;       // [BN][QS]
  float* v_s = k_s + BN * QS;       // [BN][QS]
  float* ds_s = v_s + BN * QS;      // [BM][SS]  dS
  float* lse_s = ds_s + BM * SS;    // [BM]
  float* dl_s = lse_s + BM;         // [BM]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int kvh = h / (heads / kv_heads);
  const size_t q_row = (size_t)heads * D;
  const size_t kv_row = (size_t)kv_heads * D;
  const size_t q_off = (size_t)b * t_len * q_row + (size_t)h * D;
  const size_t kv_off = (size_t)b * t_len * kv_row + (size_t)kvh * D;

  load_rows<D>(q_s, q + q_off, q_row, q0, BM, t_len, tid);
  load_rows<D>(g_s, go + q_off, q_row, q0, BM, t_len, tid);
  // delta = rowsum(dO * O) - g_lse of the block's rows, 8 threads a row
  {
    const int r = tid / 8, c0 = tid % 8;
    const int t = q0 + r;
    float sum = 0.f;
    if (t < t_len) {
      const float* gr = go + q_off + (size_t)t * q_row;
      const float* orow = out + q_off + (size_t)t * q_row;
      for (int c = c0; c < D; c += 8) sum = fmaf(gr[c], orow[c], sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    if (c0 == 0) {
      const size_t i = (size_t)bh * t_len + t;
      float dl = 0.f;
      if (t < t_len) {
        dl = sum - (g_lse ? g_lse[i] : 0.f);
        delta[i] = dl;
      }
      dl_s[r] = dl;
      lse_s[r] = t < t_len ? lse[i] : 0.f;
    }
  }

  const int ar = tid / 8;
  const int ac = tid % 8;
  float dqa[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) dqa[j] = 0.f;

  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  k_lo = (k_lo / BN) * BN;
  const int k_hi = causal ? min(t_len, q0 + BM) : t_len;

  for (int k0 = k_lo; k0 < k_hi; k0 += BN) {
    __syncthreads();
    load_rows<D>(k_s, k + kv_off, kv_row, k0, BN, t_len, tid);
    load_rows<D>(v_s, v + kv_off, kv_row, k0, BN, t_len, tid);
    __syncthreads();
    // dS: one (query, key) entry per pass, a warp on one query
    for (int e = tid; e < BM * BN; e += THREADS) {
      const int qr = e / BN, kc = e % BN;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s = fmaf(q_s[qr * QS + d], k_s[kc * QS + d], s);
        dp = fmaf(g_s[qr * QS + d], v_s[kc * QS + d], dp);
      }
      const float p = visible(q0 + qr, k0 + kc, t_len, causal, window)
                          ? expf(s * scale - lse_s[qr])
                          : 0.f;
      ds_s[qr * SS + kc] = p * (dp - dl_s[qr]) * scale;
    }
    __syncthreads();
#pragma unroll 4
    for (int kc = 0; kc < BN; ++kc) {
      const float ds = ds_s[ar * SS + kc];
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        dqa[j] = fmaf(ds, k_s[kc * QS + ac + 8 * j], dqa[j]);
    }
  }
  const int t = q0 + ar;
  if (t < t_len) {
    float* dqr = dq + q_off + (size_t)t * q_row;
#pragma unroll
    for (int j = 0; j < CPT; ++j) dqr[ac + 8 * j] = dqa[j];
  }
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* go, const float* lse, const float* delta,
                       void* dk, void* dv, int batch, int t_len, int heads,
                       int kv_heads, int causal, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + BM - 1) / BM, batch * kv_heads);
  flash_bwd_dkv_f32<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(go), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), t_len, heads,
      kv_heads, causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* go, const void* out, const float* lse,
                      const float* g_lse, float* delta, void* dq, int batch,
                      int t_len, int heads, int kv_heads, int causal,
                      int window, float scale, cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + BM - 1) / BM, batch * heads);
  flash_bwd_dq_f32<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(go),
      static_cast<const float*>(out), lse, g_lse, delta,
      static_cast<float*>(dq), t_len, heads, kv_heads, causal, window,
      scale);
  return cudaGetLastError();
}

}  // namespace f32

// the arm's launcher for head dim `d`
#define PDT_DISPATCH_D(CALL)        \
  switch (d) {                      \
    case 32:                        \
      return CALL(32);              \
    case 64:                        \
      return CALL(64);              \
    case 128:                       \
      return CALL(128);             \
    default:                        \
      return cudaErrorInvalidValue; \
  }
#define PDT_DKV_CALL_tc(D)                                                   \
  tc::launch_dkv<D>(q, k, v, go, lse, delta, dk, dv, part, batch, t_len,     \
                    heads, kv_heads, splits, causal, window, scale, s)
#define PDT_DKV_CALL_f32(D)                                                  \
  f32::launch_dkv<D>(q, k, v, go, lse, delta, dk, dv, batch, t_len, heads,   \
                     kv_heads, causal, window, scale, s)
#define PDT_DQ_CALL_tc(D)                                                    \
  tc::launch_dq<D>(q, k, v, go, out, lse, g_lse, delta, dq, batch, t_len,    \
                   heads, kv_heads, causal, window, scale, s)
#define PDT_DQ_CALL_f32(D)                                                   \
  f32::launch_dq<D>(q, k, v, go, out, lse, g_lse, delta, dq, batch, t_len,   \
                    heads, kv_heads, causal, window, scale, s)

cudaError_t dkv_tc(int d, const void* q, const void* k, const void* v,
                   const void* go, const float* lse, const float* delta,
                   void* dk, void* dv, float* part, int batch, int t_len,
                   int heads, int kv_heads, int splits, int causal,
                   int window, float scale, cudaStream_t s) {
  PDT_DISPATCH_D(PDT_DKV_CALL_tc)
}

cudaError_t dkv_f32(int d, const void* q, const void* k, const void* v,
                    const void* go, const float* lse, const float* delta,
                    void* dk, void* dv, int batch, int t_len, int heads,
                    int kv_heads, int causal, int window, float scale,
                    cudaStream_t s) {
  PDT_DISPATCH_D(PDT_DKV_CALL_f32)
}

cudaError_t dq_tc(int d, const void* q, const void* k, const void* v,
                  const void* go, const void* out, const float* lse,
                  const float* g_lse, float* delta, void* dq, int batch,
                  int t_len, int heads, int kv_heads, int causal, int window,
                  float scale, cudaStream_t s) {
  PDT_DISPATCH_D(PDT_DQ_CALL_tc)
}

cudaError_t dq_f32(int d, const void* q, const void* k, const void* v,
                   const void* go, const void* out, const float* lse,
                   const float* g_lse, float* delta, void* dq, int batch,
                   int t_len, int heads, int kv_heads, int causal, int window,
                   float scale, cudaStream_t s) {
  PDT_DISPATCH_D(PDT_DQ_CALL_f32)
}

bool bad_shape(int batch, int t_len, int heads, int kv_heads, int window) {
  return batch <= 0 || t_len <= 0 || heads <= 0 || kv_heads <= 0 ||
         heads % kv_heads != 0 || window < 0;
}

}  // namespace

extern "C" {

// B3, launched first: dQ and delta. dtype: 0 = float32 (CUDA cores), 1 =
// bfloat16 (Hopper; every tensor 16-byte aligned). q, go, out, dq
// [B, T, H, D]; k, v [B, T, KVH, D]; lse, g_lse (nullable), delta (written)
// [B, H, T] f32. Returns the cudaError_t of the launch (0 on success).
// Launches on `stream`, allocates nothing, does not sync.
int pdt_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* go, const void* out, const float* lse,
                     const float* g_lse, float* delta, void* dq, int batch,
                     int t_len, int heads, int kv_heads, int head_dim,
                     int dtype, int causal, int window, float scale,
                     void* stream) {
  if (bad_shape(batch, t_len, heads, kv_heads, window))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dq_f32(head_dim, q, k, v, go, out, lse, g_lse, delta, dq,
                       batch, t_len, heads, kv_heads, causal, window, scale,
                       s);
  if (dtype == 1)
    return (int)dq_tc(head_dim, q, k, v, go, out, lse, g_lse, delta, dq,
                      batch, t_len, heads, kv_heads, causal, window, scale,
                      s);
  return (int)cudaErrorInvalidValue;
}

// B2, after B3 (reads its delta): dK and dV [B, T, KVH, D]. bf16 only:
// `splits` > 1 shares each item's query heads among that many items, which
// write f32 partials to `part` ([2, splits, B, T, KVH, D]) that a second
// launch adds in split order; the f32 arm takes splits = 1.
int pdt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* go, const float* lse, const float* delta,
                      void* dk, void* dv, float* part, int batch, int t_len,
                      int heads, int kv_heads, int head_dim, int dtype,
                      int causal, int window, int splits, float scale,
                      void* stream) {
  if (bad_shape(batch, t_len, heads, kv_heads, window))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && splits == 1)
    return (int)dkv_f32(head_dim, q, k, v, go, lse, delta, dk, dv, batch,
                        t_len, heads, kv_heads, causal, window, scale, s);
  if (dtype == 1)
    return (int)dkv_tc(head_dim, q, k, v, go, lse, delta, dk, dv, part,
                       batch, t_len, heads, kv_heads, splits, causal, window,
                       scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* pdt_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
