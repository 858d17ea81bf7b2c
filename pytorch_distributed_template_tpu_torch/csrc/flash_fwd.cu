// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// pytorch_distributed_template_tpu/ops/flash.py (launched by
// `_flash_fwd_3d`). It computes the same function: softmax(q k^T * d^-1/2)
// v per (batch, head), with the online-softmax state (m, l, acc) in f32,
// keys masked by causality, by the sliding band q - k < window and by the
// sequence end, and it also writes the logsumexp row per query
// (lse = m + log(max(l, 1e-30)), NEG_INF = -1e30, so a row that sees no
// key gives out = 0 and a finite lse instead of NaN).
//
// What differs from the TPU kernel, and why:
// - The TPU walks its grid in order and carries (m, l, acc) in VMEM
//   scratch across the KV grid axis. Here a block owns one query tile of
//   one (batch, head) at a time and walks its KV tiles in a loop, from the
//   band start max(0, q0 - window + 1) to the diagonal (causal) or the
//   end, so tiles outside the band are never read at all.
// - The TPU pads T to the block size and masks `t_valid`; here the loads
//   fill rows past T with zeros and the kernel masks keys at or past T
//   (a zero key scores 0, not -inf) and stores no query row past T.
// - GQA reads K/V at their stored width: kv head = h / (H / KVH). The
//   head expansion (`jnp.repeat`) of the JAX model never exists.
// - q, k, v and out keep the public [B, T, heads, D] layout; lse is
//   [B, H, T] f32.
//
// What bounds it: at the serving shapes (T >= 1024, D 128) attention does
// ~T/2 FLOPs per byte of K/V, far above the card's ~295 FLOP/byte ridge, so
// the bound is the tensor cores' rate; at the training shapes (T 512-1024,
// D 64) the bytes of q, k, v and out come close. Two kernels, one per
// input type:
// - bf16 (every main path): warp-specialised and persistent. Blocks of 384
//   threads, one per SM, take the (query tile, head) items longest first,
//   in a zig-zag over the blocks that evens out their loads. Warpgroup 0 is
//   the producer: one thread issues TMA loads, and the warpgroup gives its
//   registers away with setmaxnreg. It loads each item's 128-row Q tile
//   (two buffers below D 128, so that the next item's Q lands early) and
//   K and V tiles of 128 keys into rings of shared-memory stages (3 at D
//   128, 4 below), from 4-D tensor maps over [B, T, heads, D] (boxes one
//   swizzle atom wide: 128-byte swizzle for D 64 and 128, the latter as two
//   boxes, 64-byte swizzle for D 32). Every buffer completes and goes back
//   to the producer through mbarriers of its own. Warpgroups 1 and 2 are
//   consumers of 64 rows each. A consumer issues, with wgmma, tile i's
//   scores S = Q K^T from shared memory (K in its stored layout is the
//   K-major B operand) together with tile i - 1's O += P V (P from
//   registers: the score accumulator rounded to bf16 pairs is the A
//   fragment; V is an MN-major B operand), so that tile i's softmax runs
//   on the CUDA cores while the tensor cores run P V. K is released once
//   the scores have retired, V once P V has. Below D 128 the two consumers
//   also take turns on the tensor cores (named barriers), so that one's
//   softmax overlaps the other's products; at D 128 the turns cost more
//   than they gain. The softmax scales each score, subtracts the row max
//   and takes one ex2.approx.ftz on the special-function unit: exp2f's
//   rounding without its handling of subnormal results, so that the
//   probabilities round as the paged kernel's do. The mask is computed
//   only on tiles that cross the diagonal, the band's lower edge or T;
//   interior tiles take none. Each K/V tile is read from device memory
//   once per query tile and shared by both consumers. Built with
//   -DPDT_FWD_PROFILE, the kernel also counts its cycles by phase
//   (tools/flash_fwd_phases.py reads them).
// - f32: the same arithmetic in f32 on the CUDA cores from shared-memory
//   tiles (register-blocked 2x4 score and 4x(D/16) output micro-tiles),
//   so float32 parity runs keep full f32 products.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_fwd.so flash_fwd.cu -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// bf16: TMA, mbarriers, wgmma
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BQ = 128;       // query rows per block: 64 per consumer
constexpr int BK = 128;       // keys per K/V tile
constexpr int THREADS = 384;  // producer warpgroup + two consumers
constexpr int TURN = 1;       // named barriers TURN, TURN + 1: see Turns
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static_assert(D == 32 || D == 64 || D == 128, "D in {32, 64, 128}");
  static constexpr int ATOM = D < 64 ? D : 64;  // columns per TMA box
  static constexpr int SW = ATOM * 2;           // swizzle span, bytes
  static constexpr int BOXES = D / ATOM;
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t KV_BYTES = BK * D * 2;
  // Q buffers and K/V ring depth within 227 KB: at D 128 one Q buffer and
  // three stages, below two Q buffers (the next item's Q lands early) and
  // four stages
  static constexpr int QBUF = D == 128 ? 1 : 2;
  static constexpr int STAGES = D == 128 ? 3 : 4;
  // The consumers take turns on the tensor cores below D 128, where a
  // tile's products are short against its softmax; at D 128 turns cost
  // more than they overlap (measured on the card, PERF.md).
  static constexpr bool PINGPONG = D < 128;
  // Q buffers | K stages | V stages | mbarriers, after 1024-byte alignment
  static constexpr size_t SMEM = 1024 + QBUF * (size_t)Q_BYTES +
                                 2 * STAGES * (size_t)KV_BYTES + 256;
};

#ifdef PDT_FWD_PROFILE
// Cycles by phase, summed over the blocks (tools/flash_fwd_phases.py):
// consumer thread 0 of each consumer warpgroup (slots 0-5) and the producer
// thread (6: waiting for a free buffer, 7: the rest).
__device__ unsigned long long g_prof[8];
#define PROF_DECL              \
  unsigned prof_t = clock();   \
  unsigned prof_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define PROF(slot)                   \
  do {                               \
    const unsigned now_ = clock();   \
    prof_acc[slot] += now_ - prof_t; \
    prof_t = now_;                   \
  } while (0)
#define PROF_FLUSH(lead, lo, hi)                                  \
  if (lead)                                                       \
    for (int i_ = lo; i_ < hi; ++i_)                              \
      atomicAdd(&g_prof[i_], (unsigned long long)prof_acc[i_]);
#else
#define PROF_DECL
#define PROF(slot)
#define PROF_FLUSH(lead, lo, hi)
#endif

// One work item: a 128-row query tile of one (batch, head), and the band of
// key tiles it reads. Items are numbered longest first: item w is query
// tile w / (B H) from the end (causal) or the start, of head w % (B H).
// Block g of G takes in round r the item r G + g (r even) or r G + G - 1 -
// g (r odd), so that the sums of the items' lengths even out.
struct Work {
  int b, h, kvh, bh, q0, k_lo, n_tiles;

  __device__ __forceinline__ Work(int w, int q_tiles, int batch_heads,
                                  int heads, int kv_heads, int t_len,
                                  int causal, int window) {
    const int qt = w / batch_heads;
    bh = w % batch_heads;
    b = bh / heads;
    h = bh % heads;
    kvh = h / (heads / kv_heads);
    q0 = (causal ? q_tiles - 1 - qt : qt) * BQ;
    k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    k_lo = (k_lo / BK) * BK;
    const int k_hi = causal ? min(t_len, q0 + BQ) : t_len;
    n_tiles = (k_hi - k_lo + BK - 1) / BK;
  }
};

// this thread's two query rows (r0, r1 = r0 + 8) and its consumer's first
// row (base)
struct Rows {
  int base, r0, r1, tg;
};

struct Mask {
  int t_len, causal, window;
  float scale2;  // d^-1/2 log2(e): scores go to the log2 domain
};

// S = Q K^T for one consumer's 64 rows and a tile of BK keys: D / 16
// k-steps of m64n128k16, both operands K-major from shared memory
template <int D>
__device__ __forceinline__ void issue_scores(float (&sc)[BK / 2],
                                             const bf16* q_wg,
                                             const bf16* ks) {
  constexpr int ATOM = Cfg<D>::ATOM;
  constexpr int SW = Cfg<D>::SW;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int x = kk / (ATOM / 16);           // box of this k-step
    const int off = (kk % (ATOM / 16)) * 16;  // columns into the box
    wgmma_ss<BK, 0>(sc, desc_k_major<SW>(q_wg + x * BQ * ATOM + off),
                    desc_k_major<SW>(ks + x * BK * ATOM + off), kk > 0);
  }
}

// O += P V for one consumer: P from registers, V [keys][D] the MN-major B
// operand
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         uint32_t (&pa)[BK / 16][4],
                                         const bf16* vs) {
  constexpr int ATOM = Cfg<D>::ATOM;
  constexpr int SW = Cfg<D>::SW;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<D, 1>(o, pa[kk],
                   desc_mn_major<SW>(vs + kk * 16 * ATOM, BK * ATOM * 2), 1);
}

// the probabilities as bf16 A fragments: n8 tiles 2 kk, 2 kk + 1 of the
// score accumulator make key slice kk
__device__ __forceinline__ void pack_probs(uint32_t (&pa)[BK / 16][4],
                                           const float (&sc)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// The online softmax state of a thread's two rows: running max m (log2
// domain), this thread's share of the running sum l, and c, the factor that
// rescales the output accumulated before the last tile.
struct Softmax {
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, c0 = 1.f, c1 = 1.f;

  // scores of the tile at key k0 -> probabilities, in place. The mask is
  // computed only when the tile crosses T, the diagonal or the band's
  // lower edge for these 64 rows; interior tiles take none.
  __device__ __forceinline__ void tile(float (&sc)[BK / 2], int k0,
                                       const Rows& rw, const Mask& mk) {
    constexpr int NS = BK / 2;
    const bool interior =
        k0 + BK <= mk.t_len && (!mk.causal || k0 + BK - 1 <= rw.base) &&
        (mk.window <= 0 || rw.base + 63 - k0 < mk.window);
    float mx0 = NEG_INF, mx1 = NEG_INF;
    if (interior) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        sc[j] *= mk.scale2;
        if ((j & 2) == 0)
          mx0 = fmaxf(mx0, sc[j]);
        else
          mx1 = fmaxf(mx1, sc[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int row = (j & 2) ? rw.r1 : rw.r0;
        const int col = k0 + (j >> 2) * 8 + rw.tg * 2 + (j & 1);
        const bool ok = col < mk.t_len && (!mk.causal || col <= row) &&
                        (mk.window <= 0 || row - col < mk.window);
        sc[j] = ok ? sc[j] * mk.scale2 : NEG_INF;
        if ((j & 2) == 0)
          mx0 = fmaxf(mx0, sc[j]);
        else
          mx1 = fmaxf(mx1, sc[j]);
      }
    }
    // the four threads of a quad hold one row between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    c0 = ex2_approx(m0 - mn0);
    c1 = ex2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
    if (interior) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float p = ex2_approx(sc[j] - ((j & 2) ? mn1 : mn0));
        sc[j] = p;
        if ((j & 2) == 0)
          sum0 += p;
        else
          sum1 += p;
      }
    } else {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        // masked scores are exactly NEG_INF and give exactly 0 (a row that
        // has seen no key yet has m = NEG_INF too)
        const float x = sc[j];
        const float p =
            x > 0.5f * NEG_INF ? ex2_approx(x - ((j & 2) ? mn1 : mn0)) : 0.f;
        sc[j] = p;
        if ((j & 2) == 0)
          sum0 += p;
        else
          sum1 += p;
      }
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
  }
};

// The consumers' turns on the tensor cores (ping-pong, when ON): consumer
// c issues after a sync on named barrier TURN + c, which the other
// consumer's hand-over (an arrive once it has issued its own products)
// completes, so one consumer's softmax runs while the other's products do.
// Consumer 0 goes first.
template <bool ON>
struct Turns {
  int cw;
  __device__ __forceinline__ explicit Turns(int c) : cw(c) {
    if (ON && cw == 1) named_bar_arrive(TURN, 256);
  }
  __device__ __forceinline__ void begin() const {
    if (ON) named_bar_sync(TURN + cw, 256);
  }
  __device__ __forceinline__ void end(bool hand_over = true) const {
    if (ON && hand_over) named_bar_arrive(TURN + 1 - cw, 256);
  }
};

// Persistent: G blocks, at most one per SM, each walking its items (see
// Work). The producer runs ahead across items, so the next item's Q and
// first K/V tiles load while the consumers finish the current one.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    bf16* __restrict__ out, float* __restrict__ lse,
                    int batch_heads, int t_len, int heads, int kv_heads,
                    int causal, int window, float scale) {
  using C = Cfg<D>;
  constexpr int ATOM = C::ATOM;
  constexpr int NS = BK / 2;  // score accumulator registers per thread
  constexpr int NO = D / 2;   // output accumulator registers per thread
  constexpr int STAGES = C::STAGES;
  constexpr int QBUF = C::QBUF;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(base);  // QBUF x BOXES x [BQ][ATOM]
  bf16* k_s = q_s + QBUF * BQ * D;            // STAGES x BOXES x [BK][ATOM]
  bf16* v_s = k_s + STAGES * BK * D;
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + STAGES * BK * D);
  uint64_t* q_full = bars;               // [QBUF]
  uint64_t* q_empty = q_full + QBUF;     // [QBUF]
  uint64_t* k_full = q_empty + QBUF;     // [STAGES]
  uint64_t* v_full = k_full + STAGES;    // [STAGES]
  uint64_t* k_empty = v_full + STAGES;   // [STAGES]
  uint64_t* v_empty = k_empty + STAGES;  // [STAGES]

  const int q_tiles = (t_len + BQ - 1) / BQ;
  const int items = q_tiles * batch_heads;
  // this block's n-th item (see Work)
  const auto item_of = [](int n) {
    const int g = (n & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    return n * (int)gridDim.x + g;
  };

  if (threadIdx.x == 0) {
    for (int x = 0; x < QBUF; ++x) {
      mbar_init(&q_full[x], 1);
      mbar_init(&q_empty[x], 2 * 128);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 2 * 128);
      mbar_init(&v_empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: per item Q, then K0, (K1, V0), (K2, V1), ...,
    // V(n-1), the order in which the consumers use them ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      PROF_DECL
      int it = 0;  // K/V tiles loaded before this item: stage it % STAGES
      for (int n = 0;; ++n) {
        const int w = item_of(n);
        if (w >= items) break;
        const Work wk(w, q_tiles, batch_heads, heads, kv_heads, t_len,
                      causal, window);
        const int qb = n % QBUF;
        PROF(7);
        mbar_wait(&q_empty[qb], ((n / QBUF) & 1) ^ 1);
        PROF(6);
        mbar_expect_tx(&q_full[qb], C::Q_BYTES);
        bf16* qs = q_s + qb * BQ * D;
        for (int x = 0; x < C::BOXES; ++x)
          tma_load_4d(qs + x * BQ * ATOM, &q_map, &q_full[qb], x * ATOM,
                      wk.h, wk.q0, wk.b);
        for (int i = 0; i <= wk.n_tiles; ++i) {
          if (i < wk.n_tiles) {
            const int j = it + i, s = j % STAGES;
            PROF(7);
            mbar_wait(&k_empty[s], ((j / STAGES) & 1) ^ 1);
            PROF(6);
            mbar_expect_tx(&k_full[s], C::KV_BYTES);
            for (int x = 0; x < C::BOXES; ++x)
              tma_load_4d(k_s + s * BK * D + x * BK * ATOM, &k_map,
                          &k_full[s], x * ATOM, wk.kvh, wk.k_lo + i * BK,
                          wk.b);
          }
          if (i > 0) {
            const int j = it + i - 1, s = j % STAGES;
            PROF(7);
            mbar_wait(&v_empty[s], ((j / STAGES) & 1) ^ 1);
            PROF(6);
            mbar_expect_tx(&v_full[s], C::KV_BYTES);
            for (int x = 0; x < C::BOXES; ++x)
              tma_load_4d(v_s + s * BK * D + x * BK * ATOM, &v_map,
                          &v_full[s], x * ATOM, wk.kvh,
                          wk.k_lo + (i - 1) * BK, wk.b);
          }
        }
        it += wk.n_tiles;
      }
      PROF(7);
      PROF_FLUSH(true, 6, 8)
    }
  } else {
    // ---- consumers: 64 query rows each. Tile i's scores are issued
    // together with tile i - 1's P V, so that the softmax of tile i runs
    // on the CUDA cores while P V runs on the tensor cores. K is released
    // once the scores have retired, V once P V has ----
    setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1;  // consumer 0 or 1
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int tg = lane & 3;
    const Mask mask{t_len, causal, window, scale * LOG2E};
    const size_t q_row = (size_t)heads * D;
    const Turns<C::PINGPONG> turns(cw);
    PROF_DECL
    int it = 0;  // K/V tiles consumed so far
    for (int n = 0;; ++n) {
      const int w = item_of(n);
      if (w >= items) break;
      const Work wk(w, q_tiles, batch_heads, heads, kv_heads, t_len, causal,
                    window);
      const int qb = n % QBUF;
      Rows rows;
      rows.base = wk.q0 + cw * 64;
      rows.r0 = rows.base + warp * 16 + (lane >> 2);  // this thread's rows
      rows.r1 = rows.r0 + 8;
      rows.tg = tg;
      const bf16* q_wg = q_s + qb * BQ * D + cw * 64 * ATOM;

      float o[NO];
#pragma unroll
      for (int j = 0; j < NO; ++j) o[j] = 0.f;
      float sc[NS];
      uint32_t pa[BK / 16][4];
      Softmax sm;
      mbar_wait(&q_full[qb], (n / QBUF) & 1);

      // tile 0: its scores alone
      {
        const int s = it % STAGES;
        mbar_wait(&k_full[s], (it / STAGES) & 1);
        PROF(0);
        turns.begin();
        wgmma_fence();
        issue_scores<D>(sc, q_wg, k_s + s * BK * D);
        wgmma_commit();
        turns.end();
        PROF(1);
        wgmma_wait<0>();
        fence_regs(sc);
        PROF(2);
        mbar_arrive(&k_empty[s]);
        if (wk.n_tiles == 1) mbar_arrive(&q_empty[qb]);
        sm.tile(sc, wk.k_lo, rows, mask);
        pack_probs(pa, sc);
        PROF(3);
      }
      for (int i = 1; i < wk.n_tiles; ++i) {
        const int sp = it % STAGES;  // the previous tile's stage
        const uint32_t php = (it / STAGES) & 1;
        ++it;
        const int s = it % STAGES;
        mbar_wait(&k_full[s], (it / STAGES) & 1);
        PROF(0);
        turns.begin();
        wgmma_fence();
        issue_scores<D>(sc, q_wg, k_s + s * BK * D);
        wgmma_commit();
        mbar_wait(&v_full[sp], php);
        issue_pv<D>(o, pa, v_s + sp * BK * D);
        wgmma_commit();
        turns.end();
        PROF(1);
        wgmma_wait<1>();  // the scores
        fence_regs(sc);
        PROF(2);
        mbar_arrive(&k_empty[s]);
        if (i + 1 == wk.n_tiles) mbar_arrive(&q_empty[qb]);
        sm.tile(sc, wk.k_lo + i * BK, rows, mask);
        PROF(3);
        wgmma_wait<0>();  // P V
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
        PROF(4);
        mbar_arrive(&v_empty[sp]);
#pragma unroll
        for (int j = 0; j < NO; ++j) o[j] *= (j & 2) ? sm.c1 : sm.c0;
        pack_probs(pa, sc);
        PROF(3);
      }
      // the last tile's P V
      {
        const int s = it % STAGES;
        mbar_wait(&v_full[s], (it / STAGES) & 1);
        ++it;
        PROF(0);
        turns.begin();
        wgmma_fence();
        issue_pv<D>(o, pa, v_s + s * BK * D);
        wgmma_commit();
        // consumer 1's very last hand-over would have no taker
        turns.end(cw == 0 || item_of(n + 1) < items);
        PROF(1);
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
        PROF(4);
        mbar_arrive(&v_empty[s]);
      }

      float l0 = sm.l0, l1 = sm.l1;
      const int r0 = rows.r0, r1 = rows.r1;
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
      const float inv0 = 1.f / lc0, inv1 = 1.f / lc1;
      bf16* ob = out + (size_t)wk.b * t_len * q_row + (size_t)wk.h * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = j * 8 + tg * 2;
        if (r0 < t_len)
          *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * q_row + c) =
              pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        if (r1 < t_len)
          *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * q_row + c) =
              pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
      if (tg == 0) {
        float* lrow = lse + (size_t)wk.bh * t_len;
        if (r0 < t_len) lrow[r0] = sm.m0 * LN2 + logf(lc0);
        if (r1 < t_len) lrow[r1] = sm.m1 * LN2 + logf(lc1);
      }
      PROF(5);
    }
    PROF_FLUSH(t == 0, 0, 6)
  }
}

// a 4-D map over [B, T, heads, D] bf16 with boxes of `rows` tokens x one
// swizzle atom of D
template <int D>
bool qkv_map(CUtensorMap* map, const void* p, int batch, int t_len,
             int heads, int rows) {
  using C = Cfg<D>;
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)heads, (uint64_t)t_len,
                            (uint64_t)batch};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)heads * D * 2,
                               (uint64_t)t_len * heads * D * 2};
  const uint32_t box[4] = {(uint32_t)C::ATOM, 1u, (uint32_t)rows, 1u};
  return encode_map(map, p, 4, dims, strides, box, C::SW);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int batch, int t_len, int heads, int kv_heads,
                   int causal, int window, float scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!qkv_map<D>(&q_map, q, batch, t_len, heads, BQ) ||
      !qkv_map<D>(&k_map, k, batch, t_len, kv_heads, BK) ||
      !qkv_map<D>(&v_map, v, batch, t_len, kv_heads, BK))
    return cudaErrorInvalidValue;
  const size_t smem = Cfg<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  const int items = ((t_len + BQ - 1) / BQ) * batch * heads;
  flash_fwd_wgmma<D><<<min(items, sms), THREADS, smem, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(out), lse, batch * heads,
      t_len, heads, kv_heads, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per shared-memory tile
constexpr int THREADS = 256;

template <int D>
struct Layout {
  static constexpr int QS = D + 1;   // padded row stride of Q/K tiles
  static constexpr int SS = BK + 1;  // padded row stride of the score tile
  static constexpr size_t floats =
      (size_t)BQ * QS + (size_t)BK * QS + (size_t)BK * D + (size_t)BQ * SS +
      3 * BQ;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, int t_len, int heads,
                  int kv_heads, int causal, int window, float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int QS = Layout<D>::QS;
  constexpr int SS = Layout<D>::SS;
  constexpr int CPT = D / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* q_s = smem;               // [BQ][QS]  q * scale
  float* k_s = q_s + BQ * QS;      // [BK][QS]
  float* v_s = k_s + BK * QS;      // [BK][D]
  float* s_s = v_s + BK * D;       // [BQ][SS]  scores, then probabilities
  float* m_s = s_s + BQ * SS;      // [BQ] running max
  float* l_s = m_s + BQ;           // [BQ] running sum
  float* c_s = l_s + BQ;           // [BQ] this tile's rescale factor

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int kvh = h / (heads / kv_heads);
  const size_t q_row = (size_t)heads * D;     // token stride of q / out
  const size_t kv_row = (size_t)kv_heads * D; // token stride of k / v
  const float* qb = q + (size_t)b * t_len * q_row + (size_t)h * D;
  const float* kb = k + (size_t)b * t_len * kv_row + (size_t)kvh * D;
  const float* vb = v + (size_t)b * t_len * kv_row + (size_t)kvh * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int t = q0 + r;
    q_s[r * QS + c] = t < t_len ? qb[(size_t)t * q_row + c] * scale : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // score micro-tile: rows sr, sr+1; columns sc .. sc+3
  const int sr = (tid / 8) * 2;
  const int sc = (tid % 8) * 4;
  // softmax: four threads per row, BK/4 columns each
  const int pr = tid / 4;
  const int pc = (tid % 4) * (BK / 4);
  const int p_pos = q0 + pr;
  // output micro-tile: rows ar .. ar+3; columns ac + 16 j
  const int ar = (tid / 16) * 4;
  const int ac = tid % 16;

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  k_lo = (k_lo / BK) * BK;
  const int k_hi = causal ? min(t_len, q0 + BQ) : t_len;

  __syncthreads();
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int t = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (t < t_len) {
        kx = kb[(size_t)t * kv_row + c];
        vx = vb[(size_t)t * kv_row + c];
      }
      k_s[r * QS + c] = kx;
      v_s[r * D + c] = vx;
    }
    __syncthreads();

    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float a0 = q_s[sr * QS + d];
      const float a1 = q_s[(sr + 1) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kk = k_s[(sc + j) * QS + d];
        s[0][j] = fmaf(a0, kk, s[0][j]);
        s[1][j] = fmaf(a1, kk, s[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s_s[(sr + i) * SS + sc + j] = s[i][j];
    __syncthreads();

    {
      const float m_old = m_s[pr];
      float sv[BK / 4];
      bool ok[BK / 4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        const int kpos = k0 + pc + j;
        ok[j] = kpos < t_len && (!causal || kpos <= p_pos) &&
                (window <= 0 || p_pos - kpos < window);
        sv[j] = ok[j] ? s_s[pr * SS + pc + j] : NEG_INF;
        mx = fmaxf(mx, sv[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        const float p = ok[j] ? expf(sv[j] - m_new) : 0.f;
        s_s[pr * SS + pc + j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if ((tid & 3) == 0) {
        const float corr = expf(m_old - m_new);
        m_s[pr] = m_new;
        l_s[pr] = l_s[pr] * corr + sum;
        c_s[pr] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ar + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(ar + i) * SS + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float vv = v_s[kk * D + ac + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ar + i;
    const int t = q0 + r;
    if (t >= t_len) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    float* orow = out + ((size_t)b * t_len + t) * q_row + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < CPT; ++j) orow[ac + 16 * j] = acc[i][j] / l;
    if (ac == 0) lse[(size_t)bh * t_len + t] = m_s[r] + logf(l);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int batch, int t_len, int heads, int kv_heads,
                   int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + BQ - 1) / BQ, batch * heads);
  flash_fwd_f32<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, t_len,
      heads, kv_heads, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace f32

// launch_tc / launch_f32: the family's launcher for head dim `d`
#define PDT_LAUNCH_FAMILY(NS)                                             \
  cudaError_t launch_##NS(int d, const void* q, const void* k,              \
                          const void* v, void* out, float* lse, int batch,  \
                          int t_len, int heads, int kv_heads, int causal,   \
                          int window, float scale, cudaStream_t s) {        \
    switch (d) {                                                             \
      case 32:                                                               \
        return NS::launch<32>(q, k, v, out, lse, batch, t_len, heads,       \
                              kv_heads, causal, window, scale, s);           \
      case 64:                                                               \
        return NS::launch<64>(q, k, v, out, lse, batch, t_len, heads,       \
                              kv_heads, causal, window, scale, s);           \
      case 128:                                                              \
        return NS::launch<128>(q, k, v, out, lse, batch, t_len, heads,      \
                               kv_heads, causal, window, scale, s);          \
      default:                                                               \
        return cudaErrorInvalidValue;                                        \
    }                                                                        \
  }

PDT_LAUNCH_FAMILY(tc)
PDT_LAUNCH_FAMILY(f32)
#undef PDT_LAUNCH_FAMILY

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; q, k, v and
// out 16-byte aligned). Returns the cudaError_t of the launch (0 on
// success). Launches on `stream`, allocates nothing, does not sync.
int pdt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  float* lse, int batch, int t_len, int heads, int kv_heads,
                  int head_dim, int dtype, int causal, int window,
                  float scale, void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || kv_heads <= 0 ||
      heads % kv_heads != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_f32(head_dim, q, k, v, out, lse, batch, t_len, heads,
                           kv_heads, causal, window, scale, s);
  if (dtype == 1)
    return (int)launch_tc(head_dim, q, k, v, out, lse, batch, t_len, heads,
                          kv_heads, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* pdt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef PDT_FWD_PROFILE
// copies the cycles by phase summed since the last call to host[8] (see
// tc::g_prof) and zeroes them
int pdt_flash_fwd_profile(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, tc::g_prof, sizeof(tc::g_prof));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(tc::g_prof, zero, sizeof(zero));
}
#endif

}  // extern "C"
