// Paged attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_paged_kernel` of
// pytorch_distributed_template_tpu/ops/flash.py (launched by
// `paged_attention`). It computes the same function: attention of a
// [B, T, Hq, D] query window (RoPE already applied) over the KV block pool
// [P, bt, KVH, D], row b's logical block j living in pool page
// tables[b, j] (-1 = unallocated). Query lane i of row b sits at the
// row-local position row_starts[b] + i and is valid iff i >= pad_lens[b].
// - flat tables: key position j*bt + o, visible iff k_pos <= q_pos;
// - ring tables (window > 0): the table is a ring over the row's newest
//   blocks, j_log = jq - (jq - j) mod NB with jq = q_pos // bt, k_pos =
//   j_log*bt + o, visible iff 0 <= k_pos <= q_pos and q_pos - k_pos <
//   window;
// - int8 pools: key o of a page is worth its int8 row times its f32 scale
//   ([P, bt, KVH], one per token x kv head);
// - GQA: query head h reads kv head h / (Hq / KVH).
// Softmax state (m, l, acc) is f32 with NEG_INF = -1e30 and l clamped at
// 1e-30; masked keys contribute exactly 0, so a lane that sees no key at
// all (a pad lane) gives 0.
//
// What differs from the TPU kernel, and why:
// - The TPU grid is (B, Hq, NB) with the page axis sequential and the
//   softmax state carried in VMEM scratch from one grid step to the next.
//   Here a block owns (row b, kv head g, a tile of query lanes) and walks
//   the row's table itself in a loop; nothing crosses blocks.
// - The TPU fetches one page per query head. Here each page of kv head g
//   is read into shared memory once per block and serves every query head
//   of g (Hq/KVH of them: 4 for Mistral) and every lane of the tile: a
//   block's rows are (lane x query head of g).
// - The table, row start and pad length are read by the block itself
//   (the TPU prefetches them as scalars). Pages that no lane of the tile
//   can see (past the last query in flat mode, out of the band in ring
//   mode) and -1 slots are never read.
// - The TPU pads the query window to PAGED_MIN_Q = 8 lanes (a Mosaic
//   tiling artefact); here ragged T is masked in the kernel.
//
// What bounds it: at decode (T = 1) the work is ~1 FLOP per byte of K/V,
// far below the card's ~295 FLOP/byte ridge, so the bound is the bytes of
// the visible pages; a 512-lane prefill chunk over a full 4096-token band
// does ~T FLOPs per K/V byte and is bound by the arithmetic. Three arms,
// chosen by the wrapper from (query dtype, bt, rows per kv head)
// (ops/flash.py::paged_arm):
// - wgmma (bf16, bt 16/32, more than 16 rows per kv head: prefill chunks
//   and admission feeds): B1's pipeline (flash_fwd.cu) with paged keys.
//   Persistent blocks of 384 threads, at most one per SM, take (lane tile,
//   row, kv head, split) items longest first. Warp 0 of the producer
//   warpgroup reads the row's table 32 slots at a time (ballot), keeps the
//   visible pages, and issues TMA boxes (4-D maps over the pools
//   [P, bt, KVH, D], one 128-byte swizzle atom of D x one kv head x bt
//   tokens x one page; two per page at D 128) for tiles of 64 keys (2
//   pages at bt 32, 4 at bt 16) into a ring of stages, K and V on
//   mbarriers of their own. Two consumer warpgroups own 64 query rows
//   each (Q copied to shared memory by the consumer) and issue, with
//   wgmma, tile i's scores together with tile i - 1's P V, so that tile
//   i's softmax runs while P V does. The softmax is B1's (scale, subtract
//   the running max, ex2.approx.ftz; P rounded to bf16 for P V, l summed
//   from the f32 P), masked only on tiles that some query of the block
//   cannot see whole (the producer decides per tile; the mask computes
//   each row's key positions per page, since the same ring slot can be
//   two logical blocks for two lanes of one tile). int8 pools: the
//   producer TMAs the int8 bytes and the page's scales (cp.async), the
//   other three producer warps widen the bytes to bf16 in the swizzled
//   operand layout (exact up to +-127), and the scales are folded: k_scale
//   multiplies its key's score column and v_scale its key's column of P
//   before P is rounded (a per-key factor comes out of both products;
//   the keys are never rounded after scaling, so one rounding fewer than
//   dequantizing as they land, and 64 products per row instead of 2 D).
// - decode (bf16, bt 16/32, at most 16 rows per kv head): one block of a
//   producer warp and four consumer warps per (lane tile, kv head, row,
//   split). The producer walks the split's slots as above and keeps 128
//   tokens of pages in flight by TMA (4 stages at bt 32, 8 at bt 16);
//   each consumer warp takes every fourth page and runs its 16 rows on
//   mma.sync m16n8k16 (the same softmax), and the four partial states are
//   merged in shared memory at the end. int8 pages land at half the bytes
//   and each warp widens its page to bf16 before the products.
// - CUDA cores (f32 queries, 8-token pages; no main path): 32 rows per
//   block, one key per thread lane, f32 throughout, pages read with
//   16-byte loads and dequantized as they land.
// Built with -DPDT_DEC_NOLOAD (no page read) or -DPDT_DEC_NOCOMPUTE (no
// products), the decode arm times its parts (tools/paged_decode_parts.py);
// the outputs of those builds are garbage.
// Small grids split each row's slots over `splits` blocks or items
// (flash-decoding): each writes its partial (acc, m, l) to a workspace the
// wrapper allocates, and a second kernel merges them in a fixed order.
// The pools' tensor maps are cached by (address, shape, type): the pools
// live as long as the engine, so a decode call encodes nothing.
// Later work: a TMA store epilogue, the next item's first scores issued
// before the current item's stores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpaged_attn.so paged_attn.cu -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = 8;
// query rows (lane x query head of the kv head) one block serves
constexpr int ROWS = WARPS * ROWS_PER_WARP;
constexpr unsigned FULL = 0xffffffffu;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// floor division and non-negative remainder (Python's // and %)
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && (a < 0) != (b < 0)) ? q - 1 : q;
}
__device__ __forceinline__ int posmod(int a, int b) {
  const int r = a % b;
  return r < 0 ? r + b : r;
}

// Can any query of the tile (valid positions q_lo..q_hi) see a key of
// table slot j? Flat tables: the slot starts at or before q_hi. Ring
// tables: the logical block the slot maps to intersects the band; when the
// tile spans fewer than NB blocks (`ring_skip`) that block takes its
// extreme values at the tile's first and last lane, so both are checked.
__device__ __forceinline__ bool slot_visible(int j, int q_lo, int q_hi,
                                             int bt, int nb, int window,
                                             bool ring_skip) {
  if (window <= 0) return j * bt <= q_hi;
  if (!ring_skip) return true;
  const int lo = max(0, q_lo - window + 1);
  bool hit = false;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int jq = floordiv(e ? q_hi : q_lo, bt);
    const int k0 = (jq - posmod(jq - j, nb)) * bt;
    hit = hit || (k0 + bt - 1 >= lo && k0 <= q_hi);
  }
  return hit;
}

// The key position of offset o of table slot j, seen from q_pos.
__device__ __forceinline__ int key_pos(int j, int o, int q_pos, int bt,
                                       int nb, bool ring) {
  if (!ring) return j * bt + o;
  const int jq = floordiv(q_pos, bt);
  return (jq - posmod(jq - j, nb)) * bt + o;
}

__device__ __forceinline__ bool key_visible(int k_pos, int q_pos,
                                            int window) {
  return k_pos >= 0 && k_pos <= q_pos &&
         (window <= 0 || q_pos - k_pos < window);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Grid (ceil(T / lanes) * splits, KVH, B); THREADS threads. Shared memory:
// q_s [ROWS][D] (pre-scaled f32), k_s [BT][D + 1] (padded: thread `lane`
// reads row `lane`, conflict-free), v_s [BT][D]. With splits > 1 block x
// walks table slots [split*per, (split+1)*per) of tile x / splits and
// writes unnormalised partials to part [B, T, Hq, splits, D + 2] (acc,
// then m and l) instead of out.
template <typename QT, typename KT, int D, int BT>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                  const KT* __restrict__ vp, const float* __restrict__ ks,
                  const float* __restrict__ vs,
                  const int* __restrict__ tables,
                  const int* __restrict__ starts,
                  const int* __restrict__ pads, QT* __restrict__ out,
                  float* __restrict__ part, int t_len, int heads,
                  int kv_heads, int nb, int lanes, int splits, int window,
                  float scale) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  constexpr int CPL = D / 32;            // output dims per thread
  constexpr int VEC = 16 / sizeof(KT);   // elements per 16-byte load
  constexpr int VPR = D / VEC;           // vector loads per page row
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + ROWS * D;
  float* v_s = k_s + BT * (D + 1);

  const int b = blockIdx.z;
  const int g = blockIdx.y;
  const int split = blockIdx.x % splits;
  const int lane0 = (blockIdx.x / splits) * lanes;
  const int per = (nb + splits - 1) / splits;
  const int j_end = min(nb, (split + 1) * per);
  const int group = heads / kv_heads;
  const int rows = lanes * group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int start = starts[b];
  const int pad = pads[b];

  // query tile: row r = (lane lane0 + r / group, head g*group + r % group)
  for (int idx = tid; idx < ROWS * D; idx += THREADS) {
    const int r = idx / D;
    const int d = idx % D;
    const int i = lane0 + r / group;
    float val = 0.f;
    if (r < rows && i < t_len) {
      const int h = g * group + r % group;
      val = to_f(q[((size_t)(b * t_len + i) * heads + h) * D + d]) * scale;
    }
    q_s[idx] = val;
  }

  // rows spread evenly over the warps (a decode block has only
  // Hq/KVH rows: one per warp for Mistral, not all on warp 0)
  const int per_warp = (rows + WARPS - 1) / WARPS;     // <= ROWS_PER_WARP
  const int row0 = warp * per_warp;
  const int nrows = min(per_warp, rows - row0);        // may be <= 0
  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], acc[ROWS_PER_WARP][CPL];
  int qpos[ROWS_PER_WARP];
  bool valid[ROWS_PER_WARP];
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int i = lane0 + (row0 + rr) / group;
    valid[rr] = rr < nrows && i < t_len && i >= pad;
    qpos[rr] = start + i;
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[rr][c] = 0.f;
  }

  // the tile's valid lanes, for skipping pages no lane can see
  const int first = max(lane0, pad);
  const int last = min(lane0 + lanes, t_len) - 1;
  const int q_lo = start + first;
  const int q_hi = start + last;
  const bool ring = window > 0;
  // with a tile spanning fewer than NB blocks, the logical block a slot
  // maps to takes its extreme values at the tile's first and last lane
  const bool ring_skip =
      ring && floordiv(q_hi, BT) - floordiv(q_lo, BT) < nb;

  for (int j = split * per; first <= last && j < j_end; ++j) {
    const int page = tables[(size_t)b * nb + j];
    if (page < 0 ||
        !slot_visible(j, q_lo, q_hi, BT, nb, window, ring_skip))
      continue;
    __syncthreads();   // the previous page's reads are done
    for (int idx = tid; idx < BT * VPR; idx += THREADS) {
      const int o = idx / VPR;
      const int c = (idx % VPR) * VEC;
      const size_t row = ((size_t)page * BT + o) * kv_heads + g;
      const uint4 kr = *reinterpret_cast<const uint4*>(kp + row * D + c);
      const uint4 vr = *reinterpret_cast<const uint4*>(vp + row * D + c);
      const KT* ke = reinterpret_cast<const KT*>(&kr);
      const KT* ve = reinterpret_cast<const KT*>(&vr);
      float ksc = 1.f, vsc = 1.f;
      if (QUANT) {
        ksc = ks[row];
        vsc = vs[row];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        k_s[o * (D + 1) + c + e] = to_f(ke[e]) * ksc;
        v_s[o * D + c + e] = to_f(ve[e]) * vsc;
      }
    }
    __syncthreads();
    if (nrows <= 0) continue;

    // scores: thread `lane` scores key `lane` of the page for every row
    float s[ROWS_PER_WARP];
#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) s[rr] = 0.f;
    if (lane < BT) {
      const float* krow = k_s + lane * (D + 1);
      const float* qrow = q_s + row0 * D;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kv = krow[d];
#pragma unroll
        for (int rr = 0; rr < ROWS_PER_WARP; ++rr)
          if (rr < nrows) s[rr] += qrow[rr * D + d] * kv;
      }
    }

#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      if (rr >= nrows) break;
      const int qp = qpos[rr];
      const bool ok = lane < BT && valid[rr] &&
                      key_visible(key_pos(j, lane, qp, BT, nb, ring), qp,
                                  window);
      const float sv = ok ? s[rr] : NEG_INF;
      const float m_new = fmaxf(m[rr], warp_max(sv));
      const float p = ok ? expf(sv - m_new) : 0.f;
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + warp_sum(p);
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[rr][c] *= corr;
#pragma unroll 4
      for (int o = 0; o < BT; ++o) {
        const float po = __shfl_sync(FULL, p, o);
#pragma unroll
        for (int c = 0; c < CPL; ++c)
          acc[rr][c] += po * v_s[o * D + lane + 32 * c];
      }
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    if (rr >= nrows) break;
    const int r = row0 + rr;
    const int i = lane0 + r / group;
    if (i >= t_len) continue;
    const int h = g * group + r % group;
    const size_t row = (size_t)(b * t_len + i) * heads + h;
    if (splits > 1) {
      float* prow = part + (row * splits + split) * (D + 2);
#pragma unroll
      for (int c = 0; c < CPL; ++c) prow[lane + 32 * c] = acc[rr][c];
      if (lane == 0) {
        prow[D] = m[rr];
        prow[D + 1] = l[rr];
      }
      continue;
    }
    const float lsafe = fmaxf(l[rr], 1e-30f);
    QT* orow = out + row * D;
#pragma unroll
    for (int c = 0; c < CPL; ++c) store(orow + lane + 32 * c, acc[rr][c] / lsafe);
  }
}

// Merge the per-split partials of one query row (one warp per row of
// [B*T*Hq]): m = max m_s, l = sum l_s e^(m_s - m), acc likewise, out =
// acc / max(l, 1e-30). A split that saw no key (m_s = NEG_INF) adds 0.
template <typename QT, int D>
__global__ void __launch_bounds__(32)
paged_combine_kernel(const float* __restrict__ part, QT* __restrict__ out,
                     int splits) {
  constexpr int CPL = D / 32;
  const int lane = threadIdx.x;
  const size_t row = blockIdx.x;
  const float* prow = part + row * splits * (D + 2);
  float m = NEG_INF;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, prow[s * (D + 2) + D]);
  float l = 0.f, acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* ps = prow + s * (D + 2);
    const float w = expf(ps[D] - m);
    l += ps[D + 1] * w;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] += ps[lane + 32 * c] * w;
  }
  const float lsafe = fmaxf(l, 1e-30f);
  QT* orow = out + row * D;
#pragma unroll
  for (int c = 0; c < CPL; ++c) store(orow + lane + 32 * c, acc[c] / lsafe);
}



// ---------------------------------------------------------------------------
// Hopper arms (bf16 queries, 16- or 32-token pages): pages arrive by TMA
// into rings of shared-memory stages, completion on mbarriers.
// ---------------------------------------------------------------------------
namespace hp {

using namespace hopper;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int ATOM = 64;          // bf16 columns per 128-byte swizzle atom
constexpr int NO_KEY = 1 << 29;   // key base of an empty tile position

// Element offset of (row r, column c < ATOM) in a [rows][ATOM] bf16 atom
// laid out as a TMA box with the 128-byte swizzle writes it (16-byte
// chunks XORed with row % 8; the atom starts 1024-byte aligned).
__device__ __forceinline__ int swz(int r, int c) {
  return r * ATOM + ((((c >> 3) ^ (r & 7)) << 3) | (c & 7));
}

// four int8 (the bytes of w) to two bf16 pairs, exactly: each byte, its
// sign bit flipped, becomes the low mantissa byte of 2^23 (a float of
// 2^23 + 128 + x), one subtraction leaves x, and since x's float has no bits
// below the bf16's 16, its upper half is its bf16 (no I2F, no rounding)
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | k)) -
        8388736.f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632),
                    __byte_perm(f[2], f[3], 0x7632));
}

// `rows` int8 rows [rows][D] (a TMA box without swizzle) to bf16 atoms of
// `atom_rows` rows in the swizzled operand layout; threads tid of n
template <int D>
__device__ __forceinline__ void widen_rows(bf16* dst, int atom_rows,
                                           const int8_t* src, int rows,
                                           int tid, int n) {
  constexpr int CH = D / 8;  // 8-byte chunks per row
  for (int idx = tid; idx < rows * CH; idx += n) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const uint2 raw = *reinterpret_cast<const uint2*>(src + r * D + c);
    const uint2 lo = widen4(raw.x), hi = widen4(raw.y);
    *reinterpret_cast<uint4*>(dst + (c / ATOM) * atom_rows * ATOM +
                              swz(r, c % ATOM)) =
        make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}

__device__ __forceinline__ int ring_block(int j, int jq, int nb) {
  return jq - posmod(jq - j, nb);
}

// the key position of offset 0 of table slot j, seen from a query in
// block jq; NO_KEY (never visible) for an empty position (j < 0)
__device__ __forceinline__ int key_base(int j, int jq, int bt, int nb,
                                        bool ring) {
  if (j < 0) return NO_KEY;
  return (ring ? ring_block(j, jq, nb) : j) * bt;
}

// every key of slot j visible from every query position q_lo .. q_hi
__device__ __forceinline__ bool slot_whole(int j, int q_lo, int q_hi,
                                           int bt, int nb, int window) {
  if (window <= 0) return j * bt + bt - 1 <= q_lo;
  const int jl = ring_block(j, floordiv(q_lo, bt), nb);
  if (jl != ring_block(j, floordiv(q_hi, bt), nb)) return false;
  const int k0 = jl * bt;
  return k0 >= 0 && k0 + bt - 1 <= q_lo && q_hi - k0 < window;
}

// key k visible from position qp (qp = -1 for a row that sees nothing)
__device__ __forceinline__ bool sees(int k, int qp, int window) {
  return k >= 0 && k <= qp && (window <= 0 || qp - k < window);
}

// One unit of work: query lanes lane0 .. lane0 + lanes - 1 of row b at kv
// head g, over table slots [j0, j1) (split `split` of `splits`); q_lo,
// q_hi: the positions of its first and last valid lane (any: it has one)
struct Unit {
  int b, g, split, lane0, j0, j1, start, pad, q_lo, q_hi;
  bool any, ring_skip;

  __device__ __forceinline__ Unit(int b_, int g_, int lt, int split_,
                                  int splits, int lanes, int t_len, int nb,
                                  int bt, int window, const int* starts,
                                  const int* pads)
      : b(b_), g(g_), split(split_), lane0(lt * lanes) {
    const int per = (nb + splits - 1) / splits;
    j0 = split * per;
    j1 = min(nb, j0 + per);
    start = starts[b];
    pad = pads[b];
    const int first = max(lane0, pad);
    const int last = min(lane0 + lanes, t_len) - 1;
    any = first <= last;
    q_lo = start + first;
    q_hi = start + last;
    ring_skip = window > 0 && floordiv(q_hi, bt) - floordiv(q_lo, bt) < nb;
  }
};

// Calls emit(j, page) for every slot of u's range that holds a page some
// query of u can see, in slot order. The 32 lanes of a warp call it
// together (32 slots per table read, one ballot) and all get each call.
template <typename F>
__device__ __forceinline__ void scan_slots(const Unit& u,
                                           const int* __restrict__ tables,
                                           int nb, int bt, int window,
                                           int lane, F&& emit) {
  if (!u.any) return;
  for (int jb = u.j0; jb < u.j1; jb += 32) {
    const int j = jb + lane;
    const int page = j < u.j1 ? tables[(size_t)u.b * nb + j] : -1;
    const bool vis = page >= 0 && slot_visible(j, u.q_lo, u.q_hi, bt, nb,
                                               window, u.ring_skip);
    unsigned m = __ballot_sync(FULL, vis);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      emit(jb + src, __shfl_sync(FULL, page, src));
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma arm
// ---------------------------------------------------------------------------

constexpr int BK = 64;          // keys per K/V tile
constexpr int WG_THREADS = 384; // producer warpgroup + two consumers
constexpr int CONVERTERS = 96;  // producer warps 1-3 (int8 pools)

// What a tile holds: the table slot of each page position (-1 where the
// tile has no page), whether it is the item's last and whether every query
// of the block sees all its keys (no mask), and the keys' scales (int8)
struct TileMeta {
  int slot[4];
  int last, whole, pad_[2];
  float ks[BK];
  float vs[BK];
};

template <typename KT, int D, int BT>
struct Wg {
  static constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  static constexpr int PAGES = BK / BT;
  static constexpr int BOXES = D / ATOM;
  // K/V stages within 227 KB: int8 pools also hold the raw bytes
  static constexpr int STAGES = QUANT ? 3 : 5;
  static constexpr size_t Q_BYTES = 128 * D * 2;
  static constexpr size_t TILE = BK * D * 2;         // one bf16 K or V tile
  static constexpr size_t RAW = QUANT ? BK * D : 0;  // its int8 bytes
  // Q | K stages | V stages | raw K | raw V | meta | raw meta | barriers
  static constexpr size_t SMEM =
      1024 + Q_BYTES + 2 * STAGES * (TILE + RAW) +
      (QUANT ? 2 : 1) * STAGES * sizeof(TileMeta) + 6 * STAGES * 8;
};

// The online softmax state of a thread's two rows (B1's): running max m
// (log2 domain), this thread's share of the running sum l, and c, the
// factor that rescales the output accumulated before the last tile.
struct Soft {
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, c0 = 1.f, c1 = 1.f;
};

// The scores of one tile (m64n64 accumulator: sc[4 j + e] is row r0 or, e
// & 2, r1 = r0 + 8, key 8 j + 2 tg + (e & 1)) -> probabilities, in place.
// qp: the rows' positions (-1: sees nothing), jq: their blocks.
template <int BT, bool QUANT>
__device__ __forceinline__ void tile_probs(float (&sc)[BK / 2],
                                           const TileMeta& mt, Soft& sm,
                                           const int (&qp)[2],
                                           const int (&jq)[2], int tg,
                                           int nb, int window,
                                           float scale2) {
  constexpr int NS = BK / 2;
  constexpr int PAGES = BK / BT;
  float mx0 = NEG_INF, mx1 = NEG_INF;
  const bool whole = mt.whole != 0;
  if (whole) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float x = sc[j] * scale2;
      if (QUANT) x *= mt.ks[(j >> 2) * 8 + tg * 2 + (j & 1)];
      sc[j] = x;
      if ((j & 2) == 0)
        mx0 = fmaxf(mx0, x);
      else
        mx1 = fmaxf(mx1, x);
    }
  } else {
    int kb0[PAGES], kb1[PAGES];
#pragma unroll
    for (int p = 0; p < PAGES; ++p) {
      const int slot = mt.slot[p];
      kb0[p] = key_base(slot, jq[0], BT, nb, window > 0);
      kb1[p] = key_base(slot, jq[1], BT, nb, window > 0);
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int col = (j >> 2) * 8 + tg * 2 + (j & 1);
      const int p = ((j >> 2) * 8) / BT;
      const int o = col - p * BT;
      const bool hi = (j & 2) != 0;
      const bool ok = sees((hi ? kb1[p] : kb0[p]) + o, hi ? qp[1] : qp[0],
                           window);
      float x = sc[j] * scale2;
      if (QUANT) x *= mt.ks[col];
      x = ok ? x : NEG_INF;
      sc[j] = x;
      if (!hi)
        mx0 = fmaxf(mx0, x);
      else
        mx1 = fmaxf(mx1, x);
    }
  }
  // the four threads of a quad hold one row between them
  mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
  const float mn0 = fmaxf(sm.m0, mx0), mn1 = fmaxf(sm.m1, mx1);
  sm.c0 = ex2_approx(sm.m0 - mn0);
  sm.c1 = ex2_approx(sm.m1 - mn1);
  sm.m0 = mn0;
  sm.m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const float x = sc[j];
    const float mn = (j & 2) ? mn1 : mn0;
    // masked scores are exactly NEG_INF and give exactly 0 (a row that
    // has seen no key yet has m = NEG_INF too)
    const float p = whole || x > 0.5f * NEG_INF ? ex2_approx(x - mn) : 0.f;
    sc[j] = p;
    if ((j & 2) == 0)
      sum0 += p;
    else
      sum1 += p;
  }
  sm.l0 = sm.l0 * sm.c0 + sum0;
  sm.l1 = sm.l1 * sm.c1 + sum1;
}

// the probabilities as bf16 A fragments of P V (n8 tiles 2 kk, 2 kk + 1 of
// the score accumulator make key slice kk); int8: times v_scale first
template <bool QUANT>
__device__ __forceinline__ void pack_probs(uint32_t (&pa)[BK / 16][4],
                                           const float (&sc)[BK / 2],
                                           const TileMeta& mt, int tg) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * kk + 2 * e;
      float a = sc[j], b = sc[j + 1];
      if (QUANT) {
        const int col = (j >> 2) * 8 + tg * 2;
        a *= mt.vs[col];
        b *= mt.vs[col + 1];
      }
      pa[kk][e] = pack_bf16(a, b);
    }
  }
}

// S = Q K^T for one consumer's 64 rows and a tile of BK keys: D / 16
// k-steps of m64n64k16, both operands K-major from shared memory
template <int D>
__device__ __forceinline__ void issue_scores(float (&sc)[BK / 2],
                                             const bf16* q_c,
                                             const bf16* ks) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int x = kk / (ATOM / 16);           // atom of this k-step
    const int off = (kk % (ATOM / 16)) * 16;  // columns into the atom
    wgmma_ss<BK, 0>(sc, desc_k_major<128>(q_c + x * 64 * ATOM + off),
                    desc_k_major<128>(ks + x * BK * ATOM + off), kk > 0);
  }
}

// O += P V: P from registers, V [keys][D] the MN-major B operand
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         uint32_t (&pa)[BK / 16][4],
                                         const bf16* vs) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<D, 1>(o, pa[kk],
                   desc_mn_major<128>(vs + kk * 16 * ATOM, BK * ATOM * 2), 1);
}

// Persistent: at most one block per SM, each walking its items. Item w is
// lane tile lane_tiles - 1 - w / (B KVH splits) (the latest lanes, which
// see the most keys of a flat table, first) of (row, kv head, split) w %
// (B KVH splits); block x of G takes in round r the item r G + x (r even)
// or r G + G - 1 - x (r odd). The producer runs ahead across items.
template <typename KT, int D, int BT>
__global__ void __launch_bounds__(WG_THREADS, 1)
    paged_attn_wgmma(const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const bf16* __restrict__ q, const float* __restrict__ ks,
                     const float* __restrict__ vs,
                     const int* __restrict__ tables,
                     const int* __restrict__ starts,
                     const int* __restrict__ pads, bf16* __restrict__ out,
                     float* __restrict__ part, int batch, int t_len,
                     int heads, int kv_heads, int nb, int lanes, int splits,
                     int window, float scale) {
  using C = Wg<KT, D, BT>;
  constexpr bool QUANT = C::QUANT;
  constexpr int S = C::STAGES;
  constexpr int PAGES = C::PAGES;
  constexpr int NO = D / 2;  // output accumulator registers per thread

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(base);  // 2 x D/64 atoms of [64][64]
  bf16* k_s = q_s + 128 * D;                  // S x D/64 atoms of [BK][64]
  bf16* v_s = k_s + S * BK * D;
  int8_t* rk_s = reinterpret_cast<int8_t*>(v_s + S * BK * D);  // S x [BK][D]
  int8_t* rv_s = rk_s + S * C::RAW;
  TileMeta* meta = reinterpret_cast<TileMeta*>(rv_s + S * C::RAW);
  TileMeta* rmeta = meta + S;  // int8: the producer's, copied on widening
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(meta + (QUANT ? 2 : 1) * S);
  uint64_t* k_full = bars;
  uint64_t* v_full = k_full + S;
  uint64_t* k_empty = v_full + S;
  uint64_t* v_empty = k_empty + S;
  uint64_t* r_full = v_empty + S;   // int8: raw bytes and scales landed
  uint64_t* r_empty = r_full + S;   // int8: raw stage widened

  const int group = heads / kv_heads;
  const int live_rows = lanes * group;
  const int lane_tiles = (t_len + lanes - 1) / lanes;
  const int per_tile = batch * kv_heads * splits;
  const int items = lane_tiles * per_tile;
  const auto item_of = [](int n) {
    const int x = (n & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    return n * (int)gridDim.x + x;
  };
  const auto unit_of = [&](int w) {
    const int lt = lane_tiles - 1 - w / per_tile;
    int r = w % per_tile;
    const int sp = r % splits;
    r /= splits;
    return Unit(r / kv_heads, r % kv_heads, lt, sp, splits, lanes, t_len,
                nb, BT, window, starts, pads);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&k_full[s], QUANT ? CONVERTERS : 1);
      mbar_init(&v_full[s], QUANT ? CONVERTERS : 1);
      mbar_init(&k_empty[s], 256);
      mbar_init(&v_empty[s], 256);
      if (QUANT) {
        mbar_init(&r_full[s], 1 + 32);
        mbar_init(&r_empty[s], CONVERTERS);
      }
    }
    mbar_fence_init();
  }
  // zero the stages and the metadata: a tile of fewer than PAGES pages
  // leaves positions that P V multiplies by exactly 0, so they must hold
  // finite values
  {
    uint4* z = reinterpret_cast<uint4*>(k_s);
    const int n16 = static_cast<int>(
        (reinterpret_cast<unsigned char*>(bars) -
         reinterpret_cast<unsigned char*>(k_s)) / 16);
    for (int i = threadIdx.x; i < n16; i += WG_THREADS)
      z[i] = make_uint4(0, 0, 0, 0);
    fence_proxy_async();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x < 128) {
    setmaxnreg_dec<72>();
    if (warp == 0) {
      // ---- producer: the visible pages of each item, PAGES to a tile.
      // Lane p holds page position p of the tile being filled (cur) and of
      // the full tile held back until it is known whether more follow ----
      int it = 0;
      for (int n = 0;; ++n) {
        const int w = item_of(n);
        if (w >= items) break;
        const Unit u = unit_of(w);
        const auto issue = [&](int slot, int page, int cnt, bool last) {
          const int s = it % S;
          const uint32_t ph = ((it / S) & 1) ^ 1;
          ++it;
          const bool whole =
              cnt == PAGES && u.pad <= u.lane0 &&
              __all_sync(FULL, lane >= cnt || slot_whole(slot, u.q_lo,
                                                         u.q_hi, BT, nb,
                                                         window));
          TileMeta& mt = QUANT ? rmeta[s] : meta[s];
          if (QUANT) {
            mbar_wait(&r_empty[s], ph);
          } else {
            mbar_wait(&k_empty[s], ph);
          }
          if (lane < PAGES) mt.slot[lane] = lane < cnt ? slot : -1;
          if (lane == 0) {
            mt.last = last;
            mt.whole = whole;
          }
          if (QUANT) {
#pragma unroll
            for (int c = lane; c < BK; c += 32) {
              const int p = c / BT;
              const int pg = __shfl_sync(FULL, page, p);
              if (p < cnt) {
                const size_t src =
                    ((size_t)pg * BT + c % BT) * kv_heads + u.g;
                cp_async_4(&mt.ks[c], ks + src);
                cp_async_4(&mt.vs[c], vs + src);
              }
            }
            __syncwarp();
            if (lane == 0) mbar_expect_tx(&r_full[s], 2u * cnt * BT * D);
            __syncwarp();
            if (lane < cnt) {
              tma_load_4d(rk_s + s * C::RAW + lane * BT * D, &k_map,
                          &r_full[s], 0, u.g, 0, page);
              tma_load_4d(rv_s + s * C::RAW + lane * BT * D, &v_map,
                          &r_full[s], 0, u.g, 0, page);
            }
            cp_async_mbar_arrive(&r_full[s]);
          } else {
            __syncwarp();
            if (lane == 0) mbar_expect_tx(&k_full[s], 2u * cnt * BT * D);
            __syncwarp();
            if (lane < cnt) {
#pragma unroll
              for (int x = 0; x < C::BOXES; ++x)
                tma_load_4d(k_s + s * BK * D + x * BK * ATOM +
                                lane * BT * ATOM,
                            &k_map, &k_full[s], x * ATOM, u.g, 0, page);
            }
            mbar_wait(&v_empty[s], ph);
            if (lane == 0) mbar_expect_tx(&v_full[s], 2u * cnt * BT * D);
            __syncwarp();
            if (lane < cnt) {
#pragma unroll
              for (int x = 0; x < C::BOXES; ++x)
                tma_load_4d(v_s + s * BK * D + x * BK * ATOM +
                                lane * BT * ATOM,
                            &v_map, &v_full[s], x * ATOM, u.g, 0, page);
            }
          }
        };
        int cur_slot = -1, cur_page = -1, held_slot = -1, held_page = -1;
        int cur_n = 0;
        bool held = false;
        scan_slots(u, tables, nb, BT, window, lane, [&](int j, int page) {
          if (lane == cur_n) {
            cur_slot = j;
            cur_page = page;
          }
          if (++cur_n == PAGES) {
            if (held) issue(held_slot, held_page, PAGES, false);
            held_slot = cur_slot;
            held_page = cur_page;
            held = true;
            cur_n = 0;
          }
        });
        if (cur_n > 0) {
          if (held) issue(held_slot, held_page, PAGES, false);
          issue(cur_slot, cur_page, cur_n, true);
        } else if (held) {
          issue(held_slot, held_page, PAGES, true);
        } else {
          issue(-1, -1, 0, true);  // nothing visible: one empty tile
        }
      }
    } else if (QUANT) {
      // ---- int8 pools: warps 1-3 widen each raw stage into the bf16
      // stage once the consumers have released it, and copy the tile's
      // metadata with it ----
      const int c = threadIdx.x - 32;
      int it = 0;
      for (int n = 0;; ++n) {
        if (item_of(n) >= items) break;
        for (bool last = false; !last; ++it) {
          const int s = it % S;
          const uint32_t ph = (it / S) & 1;
          mbar_wait(&r_full[s], ph);
          mbar_wait(&k_empty[s], ph ^ 1);
          mbar_wait(&v_empty[s], ph ^ 1);
          widen_rows<D>(k_s + s * BK * D, BK, rk_s + s * C::RAW, BK, c,
                        CONVERTERS);
          widen_rows<D>(v_s + s * BK * D, BK, rv_s + s * C::RAW, BK, c,
                        CONVERTERS);
          const int* src = reinterpret_cast<const int*>(&rmeta[s]);
          int* dst = reinterpret_cast<int*>(&meta[s]);
          for (int i = c; i < (int)(sizeof(TileMeta) / 4); i += CONVERTERS)
            dst[i] = src[i];
          last = rmeta[s].last != 0;
          fence_proxy_async();
          mbar_arrive(&k_full[s]);
          mbar_arrive(&v_full[s]);
          mbar_arrive(&r_empty[s]);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each. Tile i's scores are issued
    // together with tile i - 1's P V, so that the softmax of tile i runs
    // on the CUDA cores while P V runs on the tensor cores ----
    setmaxnreg_inc<216>();
    const int cw = threadIdx.x / 128 - 1;  // consumer 0 or 1
    const int t = threadIdx.x % 128;
    const int wq = t / 32, ln = t % 32, tg = ln & 3;
    bf16* q_c = q_s + cw * 64 * D;
    const float scale2 = scale * LOG2E;
    int it = 0;
    for (int n = 0;; ++n) {
      const int w = item_of(n);
      if (w >= items) break;
      const Unit u = unit_of(w);
      // this consumer's 64 query rows (zero past T and past the group's
      // rows) into shared memory, in the swizzled K-major layout
      for (int idx = t; idx < 64 * (D / 8); idx += 128) {
        const int rr = idx / (D / 8), c = (idx % (D / 8)) * 8;
        const int r = cw * 64 + rr;
        const int i = u.lane0 + r / group;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (r < live_rows && i < t_len)
          val = *reinterpret_cast<const uint4*>(
              q + ((size_t)(u.b * t_len + i) * heads + u.g * group +
                   r % group) * D + c);
        *reinterpret_cast<uint4*>(q_c + (c / ATOM) * 64 * ATOM +
                                  swz(rr, c % ATOM)) = val;
      }
      fence_proxy_async();
      named_bar_sync(1 + cw, 128);
      // this thread's rows r0, r1 = r0 + 8
      int qp[2], jq[2], row[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = cw * 64 + wq * 16 + ln / 4 + 8 * e;
        const int i = u.lane0 + r / group;
        const bool live = r < live_rows && i < t_len;
        row[e] = live ? (u.b * t_len + i) * heads + u.g * group + r % group
                      : -1;
        qp[e] = live && i >= u.pad ? u.start + i : -1;
        jq[e] = floordiv(max(qp[e], 0), BT);
      }

      float o[NO];
#pragma unroll
      for (int j = 0; j < NO; ++j) o[j] = 0.f;
      float sc[BK / 2];
      uint32_t pa[BK / 16][4];
      Soft sm;

      // tile 0: its scores alone
      int s = it % S;
      mbar_wait(&k_full[s], (it / S) & 1);
      bool last = meta[s].last != 0;
      wgmma_fence();
      issue_scores<D>(sc, q_c, k_s + s * BK * D);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      tile_probs<BT, QUANT>(sc, meta[s], sm, qp, jq, tg, nb, window, scale2);
      pack_probs<QUANT>(pa, sc, meta[s], tg);
      mbar_arrive(&k_empty[s]);
      while (!last) {
        const int sp = s;  // the previous tile's stage
        const uint32_t php = (it / S) & 1;
        ++it;
        s = it % S;
        mbar_wait(&k_full[s], (it / S) & 1);
        last = meta[s].last != 0;
        wgmma_fence();
        issue_scores<D>(sc, q_c, k_s + s * BK * D);
        wgmma_commit();
        mbar_wait(&v_full[sp], php);
        issue_pv<D>(o, pa, v_s + sp * BK * D);
        wgmma_commit();
        wgmma_wait<1>();  // the scores
        fence_regs(sc);
        tile_probs<BT, QUANT>(sc, meta[s], sm, qp, jq, tg, nb, window,
                              scale2);
        wgmma_wait<0>();  // P V
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
        mbar_arrive(&v_empty[sp]);
#pragma unroll
        for (int j = 0; j < NO; ++j) o[j] *= (j & 2) ? sm.c1 : sm.c0;
        pack_probs<QUANT>(pa, sc, meta[s], tg);
        mbar_arrive(&k_empty[s]);
      }
      // the last tile's P V
      mbar_wait(&v_full[s], (it / S) & 1);
      ++it;
      wgmma_fence();
      issue_pv<D>(o, pa, v_s + s * BK * D);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
      mbar_arrive(&v_empty[s]);

      // stores: the output rows, or the split's unnormalised partials in
      // the natural-log domain of the combine
      float l[2] = {sm.l0, sm.l1};
      const float m[2] = {sm.m0, sm.m1};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        l[e] += __shfl_xor_sync(FULL, l[e], 1);
        l[e] += __shfl_xor_sync(FULL, l[e], 2);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (row[e] < 0) continue;
        if (splits > 1) {
          float* prow = part + ((size_t)row[e] * splits + u.split) * (D + 2);
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            prow[j * 8 + tg * 2] = o[4 * j + 2 * e];
            prow[j * 8 + tg * 2 + 1] = o[4 * j + 2 * e + 1];
          }
          if (tg == 0) {
            prow[D] = m[e] * LN2;
            prow[D + 1] = l[e];
          }
          continue;
        }
        const float inv = 1.f / fmaxf(l[e], 1e-30f);
        bf16* orow = out + (size_t)row[e] * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + j * 8 + tg * 2) =
              pack_bf16(o[4 * j + 2 * e] * inv, o[4 * j + 2 * e + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// decode arm
// ---------------------------------------------------------------------------

constexpr int DEC_WARPS = 4;                     // consumer warps
constexpr int DEC_THREADS = 32 * (DEC_WARPS + 1);
constexpr int DEC_ROWS = 16;                     // one m16 tile of rows

// one page stage: its table slot (-1: the end of the pages) and, int8
// pools, its keys' scales
struct PageMeta {
  int slot, pad_[3];
  float ks[32];
  float vs[32];
};

template <typename KT, int D, int BT>
struct Dec {
  static constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  static constexpr int BOXES = D / ATOM;
  // 128 tokens of pages in flight, one page per consumer warp at bt 32:
  // on the card, more stages (one block per SM) or fewer warps with more
  // stages each were slower at the decode shapes
  static constexpr int STAGES = 128 / BT;
  static constexpr size_t BF16 = BT * D * 2;           // one operand, bf16
  static constexpr size_t RAW = BT * D * sizeof(KT);   // as it lands
  static constexpr size_t PRIV = QUANT ? DEC_WARPS * 2 * BF16 : 0;
  static constexpr size_t RING = STAGES * 2 * RAW + PRIV;
  static constexpr size_t MERGE = DEC_WARPS * DEC_ROWS * (D + 2) * 4;
  static constexpr size_t REGION = RING > MERGE ? RING : MERGE;
  // stages (then int8: each warp's widened page) or, at the end, the
  // merge | meta | barriers
  static constexpr size_t SMEM =
      1024 + REGION + STAGES * sizeof(PageMeta) + 2 * STAGES * 8;
};

namespace mma_sync {

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices; lanes 8 i .. 8 i + 7 give the rows of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

}  // namespace mma_sync

// Grid (lane tiles x splits, KVH, B), DEC_THREADS threads: warp 0 the
// producer, warps 1-4 consumers. Block x takes lane tile x / splits and the
// slots of split x % splits.
template <typename KT, int D, int BT>
__global__ void __launch_bounds__(DEC_THREADS, 2)
    paged_attn_decode(const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const bf16* __restrict__ q,
                      const float* __restrict__ ks,
                      const float* __restrict__ vs,
                      const int* __restrict__ tables,
                      const int* __restrict__ starts,
                      const int* __restrict__ pads, bf16* __restrict__ out,
                      float* __restrict__ part, int t_len, int heads,
                      int kv_heads, int nb, int lanes, int splits,
                      int window, float scale) {
  using C = Dec<KT, D, BT>;
  using namespace mma_sync;
  constexpr bool QUANT = C::QUANT;
  constexpr int S = C::STAGES;
  constexpr int KSTEPS = D / 16;
  constexpr int NT_S = BT / 8;   // n8 tiles of scores per page
  constexpr int NT_O = D / 8;    // n8 tiles of the output

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  bf16* priv = reinterpret_cast<bf16*>(base + S * 2 * C::RAW);
  PageMeta* meta = reinterpret_cast<PageMeta*>(base + C::REGION);
  uint64_t* full = reinterpret_cast<uint64_t*>(meta + S);
  uint64_t* empty = full + S;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], QUANT ? 1 + 32 : 1);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const Unit u(blockIdx.z, blockIdx.y, blockIdx.x / splits,
               blockIdx.x % splits, splits, lanes, t_len, nb, BT, window,
               starts, pads);
  const int group = heads / kv_heads;
  const int live_rows = lanes * group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == 0) {
    // ---- producer: one visible page per stage, then one end mark per
    // consumer warp ----
    int it = 0;
    const auto stage = [&](int slot, int page) {
      const int s = it % S;
      mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
      ++it;
      unsigned char* sb = base + s * 2 * C::RAW;
      PageMeta& mt = meta[s];
      if (QUANT && slot >= 0 && lane < BT) {
        const size_t src = ((size_t)page * BT + lane) * kv_heads + u.g;
        cp_async_4(&mt.ks[lane], ks + src);
        cp_async_4(&mt.vs[lane], vs + src);
      }
      if (lane == 0) {
        mt.slot = slot;
#ifdef PDT_DEC_NOLOAD  // timing builds only: no page is read
        mbar_expect_tx(&full[s], 0u);
        if (false) {
#else
        mbar_expect_tx(&full[s], slot >= 0 ? 2 * (uint32_t)C::RAW : 0u);
        if (slot >= 0) {
#endif
          if (QUANT) {
            tma_load_4d(sb, &k_map, &full[s], 0, u.g, 0, page);
            tma_load_4d(sb + C::RAW, &v_map, &full[s], 0, u.g, 0, page);
          } else {
#pragma unroll
            for (int x = 0; x < C::BOXES; ++x) {
              tma_load_4d(sb + x * BT * ATOM * 2, &k_map, &full[s],
                          x * ATOM, u.g, 0, page);
              tma_load_4d(sb + C::RAW + x * BT * ATOM * 2, &v_map, &full[s],
                          x * ATOM, u.g, 0, page);
            }
          }
        }
      }
      if (QUANT) cp_async_mbar_arrive(&full[s]);
    };
    scan_slots(u, tables, nb, BT, window, lane, stage);
    for (int w = 0; w < DEC_WARPS; ++w) stage(-1, -1);
    return;
  }

  // ---- consumer warp w: pages w, w + 4, ... of the split, its 16 rows
  // on mma.sync ----
  const int w = warp - 1;
  const int gq = lane >> 2, tg = lane & 3;
  int qp[2], jq[2];
  bool live[2];
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = gq + 8 * e;
    const int i = u.lane0 + r / group;
    live[e] = r < live_rows && i < t_len;
    qp[e] = live[e] && i >= u.pad ? u.start + i : -1;
    jq[e] = floordiv(max(qp[e], 0), BT);
  }
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rs = e & 1;
      const int r = gq + 8 * rs;
      const int c = kk * 16 + tg * 2 + (e >> 1) * 8;
      qf[kk][e] = live[rs]
          ? *reinterpret_cast<const uint32_t*>(
                q + ((size_t)(u.b * t_len + u.lane0 + r / group) * heads +
                     u.g * group + r % group) * D + c)
          : 0u;
    }
  }
  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float scale2 = scale * LOG2E;
  const bool ring = window > 0;

  for (int i = w;; i += DEC_WARPS) {
    const int s = i % S;
    mbar_wait(&full[s], (i / S) & 1);
    const PageMeta& mt = meta[s];
    const int slot = mt.slot;
    if (slot < 0) break;
#ifdef PDT_DEC_NOCOMPUTE  // timing builds only: pages are not used
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    continue;
#endif
    const unsigned char* sb = base + s * 2 * C::RAW;
    const bf16* kb = reinterpret_cast<const bf16*>(sb);
    const bf16* vb = reinterpret_cast<const bf16*>(sb + C::RAW);
    float ksc[NT_S][2], vsc[NT_S][2];
    if constexpr (QUANT) {
      // widen the page into this warp's own bf16 buffers, keep the
      // scales of this thread's key columns, release the stage
      bf16* pk = priv + w * 2 * BT * D;
      bf16* pv = pk + BT * D;
      __syncwarp();
      widen_rows<D>(pk, BT, reinterpret_cast<const int8_t*>(sb), BT, lane,
                    32);
      widen_rows<D>(pv, BT, reinterpret_cast<const int8_t*>(sb + C::RAW),
                    BT, lane, 32);
#pragma unroll
      for (int jn = 0; jn < NT_S; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ksc[jn][e] = mt.ks[jn * 8 + tg * 2 + e];
          vsc[jn][e] = mt.vs[jn * 8 + tg * 2 + e];
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      kb = pk;
      vb = pv;
    }

    // S = Q K^T: this warp's 16 rows x the page's BT keys
    float sc[NT_S][4];
#pragma unroll
    for (int jn = 0; jn < NT_S; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[jn][e] = 0.f;
    // K fragments of two n8 tiles per ldmatrix.x4: matrices (keys 16 jp
    // + 0..7 | 8..15) x (columns 16 kk + 0..7 | 8..15)
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const bf16* ka = kb + (kk / 4) * BT * ATOM;
#pragma unroll
      for (int jp = 0; jp < NT_S / 2; ++jp) {
        const int n = jp * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int ch = (kk % 4) * 2 + ((lane >> 3) & 1);
        uint32_t b[4];
        ldmatrix_x4(b, ka + n * ATOM + ((ch ^ (n & 7)) << 3));
        mma(sc[2 * jp], qf[kk], b[0], b[1]);
        mma(sc[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }

    // mask, the softmax (B1's rounding), the running state
    int kbase[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) kbase[e] = key_base(slot, jq[e], BT, nb, ring);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int jn = 0; jn < NT_S; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rs = e >> 1;
        const int col = jn * 8 + tg * 2 + (e & 1);
        float x = sc[jn][e] * scale2;
        if (QUANT) x *= ksc[jn][e & 1];
        x = sees(kbase[rs] + col, qp[rs], window) ? x : NEG_INF;
        sc[jn][e] = x;
        mx[rs] = fmaxf(mx[rs], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
      mx[rs] = fmaxf(mx[rs], __shfl_xor_sync(FULL, mx[rs], 1));
      mx[rs] = fmaxf(mx[rs], __shfl_xor_sync(FULL, mx[rs], 2));
      const float mn = fmaxf(m[rs], mx[rs]);
      corr[rs] = ex2_approx(m[rs] - mn);
      m[rs] = mn;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int jn = 0; jn < NT_S; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rs = e >> 1;
        const float x = sc[jn][e];
        const float p = x > 0.5f * NEG_INF ? ex2_approx(x - m[rs]) : 0.f;
        sc[jn][e] = p;
        sum[rs] += p;
      }
    }
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) l[rs] = l[rs] * corr[rs] + sum[rs];
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: the score accumulators of n-tiles 2 kk, 2 kk + 1 are the A
    // fragment of key step kk; V fragments by ldmatrix from the swizzled
    // page
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jn = 2 * kk + h;
        float v0 = sc[jn][0], v1 = sc[jn][1], v2 = sc[jn][2], v3 = sc[jn][3];
        if (QUANT) {
          v0 *= vsc[jn][0];
          v1 *= vsc[jn][1];
          v2 *= vsc[jn][0];
          v3 *= vsc[jn][1];
        }
        a[2 * h] = pack_bf16(v0, v1);
        a[2 * h + 1] = pack_bf16(v2, v3);
      }
      // V fragments of two output n8 tiles per ldmatrix.x4.trans:
      // matrices (keys 16 kk + 0..7 | 8..15) x (tile 2 np | 2 np + 1)
      const int r = kk * 16 + (lane & 15);
#pragma unroll
      for (int np = 0; np < NT_O / 2; ++np) {
        const int n = 2 * np + (lane >> 4);
        uint32_t b[4];
        ldmatrix_x4_trans(b, vb + (n / 8) * BT * ATOM + r * ATOM +
                                 (((n & 7) ^ (r & 7)) << 3));
        mma(o[2 * np], a, b[0], b[1]);
        mma(o[2 * np + 1], a, b[2], b[3]);
      }
    }
    if (!QUANT) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  // merge the four warps' states: every stage is consumed, so the ring
  // holds the merge buffer [warp][row][D + 2] (acc, m, l)
  named_bar_sync(1, 32 * DEC_WARPS);
  float* mo = reinterpret_cast<float*>(base);
#pragma unroll
  for (int rs = 0; rs < 2; ++rs) {
    l[rs] += __shfl_xor_sync(FULL, l[rs], 1);
    l[rs] += __shfl_xor_sync(FULL, l[rs], 2);
    float* mr = mo + (w * DEC_ROWS + gq + 8 * rs) * (D + 2);
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      mr[n * 8 + tg * 2] = o[n][2 * rs];
      mr[n * 8 + tg * 2 + 1] = o[n][2 * rs + 1];
    }
    if (tg == 0) {
      mr[D] = m[rs];
      mr[D + 1] = l[rs];
    }
  }
  named_bar_sync(1, 32 * DEC_WARPS);
  for (int idx = threadIdx.x - 32; idx < DEC_ROWS * D;
       idx += 32 * DEC_WARPS) {
    const int r = idx / D, c = idx % D;
    const int i = u.lane0 + r / group;
    if (r >= live_rows || i >= t_len) continue;
    float mm = NEG_INF;
#pragma unroll
    for (int ww = 0; ww < DEC_WARPS; ++ww)
      mm = fmaxf(mm, mo[(ww * DEC_ROWS + r) * (D + 2) + D]);
    float acc = 0.f, ll = 0.f;
#pragma unroll
    for (int ww = 0; ww < DEC_WARPS; ++ww) {
      const float* mr = mo + (ww * DEC_ROWS + r) * (D + 2);
      const float f = exp2f(mr[D] - mm);
      acc += mr[c] * f;
      ll += mr[D + 1] * f;
    }
    const size_t row =
        (size_t)(u.b * t_len + i) * heads + u.g * group + r % group;
    if (splits > 1) {
      float* prow = part + (row * splits + u.split) * (D + 2);
      prow[c] = acc;
      if (c == 0) {
        prow[D] = mm * LN2;
        prow[D + 1] = ll;
      }
    } else {
      out[row * D + c] = __float2bfloat16(acc / fmaxf(ll, 1e-30f));
    }
  }
}

}  // namespace hp

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* tables;
  const int* starts;
  const int* pads;
  void* out;
  float* part;
  int batch, t_len, heads, kv_heads, nb, pages, splits, window;
  float scale;
};

// the arms, as pdt_paged_attn's `arm` names them
enum Arm { CUDA_CORES = 0, DECODE = 1, WGMMA = 2 };

// Query lanes one block (or wgmma item) serves: its rows over the Hq/KVH
// query heads of its kv head (0: the group is wider than the arm's rows)
int lanes_per_block(int arm, int group) {
  const int rows = arm == WGMMA ? 128 : arm == DECODE ? hp::DEC_ROWS : ROWS;
  return rows / group;
}

// A 4-D tensor map over a pool [P, bt, KVH, D] (bf16: boxes of one
// 128-byte swizzle atom of D x 1 kv head x bt tokens x 1 page; int8: a
// whole row of D bytes, unswizzled). The pools live as long as the engine,
// so maps are kept by (address, shape, type): a call encodes none once its
// pools have been seen.
bool pool_map(CUtensorMap* map, const void* pool, int pages, int bt,
              int kv_heads, int d, bool int8) {
  struct Entry {
    const void* pool;
    int pages, bt, kv_heads, d;
    bool int8;
    CUtensorMap map;
  };
  constexpr int CAP = 512;  // two pools per layer of a deep model, twice
  static Entry cache[CAP];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.pool == pool && e.pages == pages && e.bt == bt &&
        e.kv_heads == kv_heads && e.d == d && e.int8 == int8) {
      *map = e.map;
      return true;
    }
  }
  const uint64_t es = int8 ? 1 : 2;
  const uint64_t dims[4] = {(uint64_t)d, (uint64_t)kv_heads, (uint64_t)bt,
                            (uint64_t)pages};
  const uint64_t strides[3] = {d * es, kv_heads * d * es,
                               (uint64_t)bt * kv_heads * d * es};
  const uint32_t box[4] = {int8 ? (uint32_t)d : (uint32_t)hp::ATOM, 1u,
                           (uint32_t)bt, 1u};
  if (!hopper::encode_map(map, pool, 4, dims, strides, box, int8 ? 0 : 128,
                          int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16))
    return false;
  cache[next] = Entry{pool, pages, bt, kv_heads, d, int8, *map};
  next = (next + 1) % CAP;
  used = used < CAP ? used + 1 : CAP;
  return true;
}

template <typename KT, int D, int BT>
cudaError_t launch_hopper(const Args& a, int arm, cudaStream_t stream) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  CUtensorMap km, vm;
  if (!pool_map(&km, a.k, a.pages, BT, a.kv_heads, D, QUANT) ||
      !pool_map(&vm, a.v, a.pages, BT, a.kv_heads, D, QUANT))
    return cudaErrorInvalidValue;
  const int lanes = lanes_per_block(arm, a.heads / a.kv_heads);
  const int lane_tiles = (a.t_len + lanes - 1) / lanes;
  const bf16* q = static_cast<const bf16*>(a.q);
  bf16* out = static_cast<bf16*>(a.out);
  if (arm == WGMMA) {
    constexpr size_t smem = hp::Wg<KT, D, BT>::SMEM;
    auto kernel = hp::paged_attn_wgmma<KT, D, BT>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
    const int items = lane_tiles * a.batch * a.kv_heads * a.splits;
    kernel<<<min(items, sms), hp::WG_THREADS, smem, stream>>>(
        km, vm, q, a.ks, a.vs, a.tables, a.starts, a.pads, out, a.part,
        a.batch, a.t_len, a.heads, a.kv_heads, a.nb, lanes, a.splits,
        a.window, a.scale);
  } else {
    constexpr size_t smem = hp::Dec<KT, D, BT>::SMEM;
    auto kernel = hp::paged_attn_decode<KT, D, BT>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
    const dim3 grid(lane_tiles * a.splits, a.kv_heads, a.batch);
    kernel<<<grid, hp::DEC_THREADS, smem, stream>>>(
        km, vm, q, a.ks, a.vs, a.tables, a.starts, a.pads, out, a.part,
        a.t_len, a.heads, a.kv_heads, a.nb, lanes, a.splits, a.window,
        a.scale);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  paged_combine_kernel<bf16, D><<<a.batch * a.t_len * a.heads, 32, 0,
                                  stream>>>(a.part, out, a.splits);
  return cudaGetLastError();
}

template <typename QT, typename KT, int D, int BT>
cudaError_t launch(const Args& a, int arm, cudaStream_t stream) {
  if constexpr (std::is_same<QT, bf16>::value && BT % 16 == 0) {
    if (arm != CUDA_CORES) return launch_hopper<KT, D, BT>(a, arm, stream);
  }
  if (arm != CUDA_CORES) return cudaErrorInvalidValue;
  const int lanes = lanes_per_block(CUDA_CORES, a.heads / a.kv_heads);
  const dim3 grid((a.t_len + lanes - 1) / lanes * a.splits, a.kv_heads,
                  a.batch);
  const size_t smem = sizeof(float) * (ROWS * D + BT * (D + 1) + BT * D);
  auto kernel = paged_attn_kernel<QT, KT, D, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), a.ks, a.vs, a.tables, a.starts, a.pads,
      static_cast<QT*>(a.out), a.part, a.t_len, a.heads, a.kv_heads, a.nb,
      lanes, a.splits, a.window, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  paged_combine_kernel<QT, D><<<a.batch * a.t_len * a.heads, 32, 0,
                                stream>>>(a.part, static_cast<QT*>(a.out),
                                          a.splits);
  return cudaGetLastError();
}

template <typename QT, typename KT, int D>
cudaError_t by_block(int bt, const Args& a, int arm, cudaStream_t s) {
  switch (bt) {
    case 8: return launch<QT, KT, D, 8>(a, arm, s);
    case 16: return launch<QT, KT, D, 16>(a, arm, s);
    case 32: return launch<QT, KT, D, 32>(a, arm, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT, typename KT>
cudaError_t by_shape(int d, int bt, const Args& a, int arm, cudaStream_t s) {
  switch (d) {
    case 64: return by_block<QT, KT, 64>(bt, a, arm, s);
    case 128: return by_block<QT, KT, 128>(bt, a, arm, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q_dtype: 0 = float32, 1 = bfloat16 (q and out). kv_dtype: the pools'
// type, 0 = float32 or 1 = bfloat16 (equal to q_dtype), or 2 = int8 with
// f32 scale leaves k_scale/v_scale. Pools [pool_pages, block_tokens,
// kv_heads, head_dim] must start 16-byte aligned. arm: 0 = CUDA cores, 1 =
// decode, 2 = wgmma (1 and 2: bf16 queries, block_tokens 16 or 32 only).
// splits > 1 splits each row's table over that many blocks or items and
// needs the f32 workspace `part` of B*T*Hq*splits*(head_dim + 2) floats.
// Returns the cudaError_t of the launches (0 on success). Launches on
// `stream`, allocates nothing, does not sync.
int pdt_paged_attn(const void* q, const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* tables, const int* row_starts,
                   const int* pad_lens, void* out, float* part, int batch,
                   int t_len, int heads, int kv_heads, int head_dim, int nb,
                   int block_tokens, int pool_pages, int q_dtype,
                   int kv_dtype, int window, int splits, int arm,
                   float scale, void* stream) {
  if (batch <= 0 || t_len <= 0 || nb <= 0 || heads <= 0 || kv_heads <= 0 ||
      pool_pages <= 0 || heads % kv_heads != 0 || window < 0 ||
      arm < CUDA_CORES || arm > WGMMA ||
      lanes_per_block(arm, heads / kv_heads) < 1 || splits < 1 ||
      splits > nb || (splits > 1 && part == nullptr) ||
      (arm != CUDA_CORES && (q_dtype != 1 || block_tokens % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const Args a{q,      k_pool,   v_pool,   k_scale, v_scale,   tables,
               row_starts, pad_lens, out,  part,    batch,     t_len,
               heads,  kv_heads, nb,       pool_pages, splits, window,
               scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 2) {
    if (k_scale == nullptr || v_scale == nullptr)
      return (int)cudaErrorInvalidValue;
    if (q_dtype == 0)
      return (int)by_shape<float, int8_t>(head_dim, block_tokens, a, arm, s);
    if (q_dtype == 1)
      return (int)by_shape<bf16, int8_t>(head_dim, block_tokens, a, arm, s);
    return (int)cudaErrorInvalidValue;
  }
  if (kv_dtype != q_dtype) return (int)cudaErrorInvalidValue;
  if (q_dtype == 0)
    return (int)by_shape<float, float>(head_dim, block_tokens, a, arm, s);
  if (q_dtype == 1)
    return (int)by_shape<bf16, bf16>(head_dim, block_tokens, a, arm, s);
  return (int)cudaErrorInvalidValue;
}

// Query lanes per block of an arm (ops/flash.py::paged_lanes computes the
// same; the card tests hold the two together).
int pdt_paged_lanes(int arm, int group) {
  return lanes_per_block(arm, group);
}

const char* pdt_paged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
