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
// - int8 pools: each fetched row is multiplied by its f32 scale
//   ([P, bt, KVH], one per token x kv head) as it lands in shared memory
//   (the dequant epilogue of the TPU kernel);
// - GQA: query head h reads kv head h / (Hq / KVH).
// Softmax state (m, l, acc) is f32 with NEG_INF = -1e30 and l clamped at
// 1e-30; masked keys contribute exactly 0, so a lane that sees no key at
// all (a pad lane) gives 0.
//
// What differs from the TPU kernel, and why:
// - The TPU grid is (B, Hq, NB) with the page axis sequential and the
//   softmax state carried in VMEM scratch from one grid step to the next.
//   Here one block owns (row b, kv head g, a tile of query lanes) and walks
//   the row's table itself in a loop; nothing crosses blocks.
// - The TPU fetches one page per query head. Here each page of kv head g
//   is read into shared memory once per block and serves every query head
//   of g (Hq/KVH of them: 4 for Mistral) and every lane of the tile.
// - The table, row start and pad length are read by the block itself
//   (the TPU prefetches them as scalars). Pages that no lane of the tile
//   can see (past the last query in flat mode, out of the band in ring
//   mode) are skipped whole, and -1 lanes are never read.
// - The TPU pads the query window to PAGED_MIN_Q = 8 lanes (a Mosaic
//   tiling artefact); here ragged T is masked in the kernel.
//
// What bounds it: at decode (T = 1) the work is ~1 FLOP per byte of K/V,
// far below the card's ~295 FLOP/byte ridge, so the bound is the bytes of
// the visible pages; a 512-lane prefill chunk over a full 4096-token band
// does ~T FLOPs per K/V byte and is bound by the arithmetic. What the
// design does about it:
// - Two arms. bf16 queries with 16- or 32-token pages (the serving path)
//   run S = Q K^T and P V on the tensor cores (mma.sync m16n8k16, f32
//   accumulation, P rounded to bf16 as in B1), 64 query rows per block;
//   f32 queries and 8-token pages run on the CUDA cores in f32 (one key
//   per thread lane against queries broadcast from shared memory, 32 rows
//   per block). Measured on the card, the tensor-core arm is also the
//   faster one at decode, where its per-page work is a few mma instead of
//   a serial dot product per lane.
// - Pages are read with 16-byte vector loads, once per block, and serve
//   every query head of the kv head.
// - A decode launch has only B x KVH blocks, each walking ~130 pages one
//   after the other, so when the grid is small the pages of each row are
//   split over `splits` blocks (flash-decoding): each writes its partial
//   (m, l, acc) to a workspace the wrapper allocates, and a second kernel
//   merges them.
// Later work: cp.async/TMA double buffering of pages and wgmma.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpaged_attn.so paged_attn.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <type_traits>

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
// bf16 queries, bt >= 16: tensor cores (mma.sync m16n8k16), the shape of
// B1's tensor-core kernel (csrc/flash_fwd.cu) over pages. Each of the four
// warps owns 16 query rows (lane x query head of the kv head); Q stays in
// registers as A fragments, the page's K/V land in shared memory as bf16
// (int8 pages are dequantized on the way in), S = Q K^T and P V run on the
// tensor cores with f32 accumulation, P rounded to bf16 as in B1.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int ROWS_TC = 64;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const bf16* row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename KT, int D, int BT>
__global__ void __launch_bounds__(THREADS)
paged_attn_tc(const bf16* __restrict__ q, const KT* __restrict__ kp,
              const KT* __restrict__ vp, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ tables,
              const int* __restrict__ starts, const int* __restrict__ pads,
              bf16* __restrict__ out, float* __restrict__ part, int t_len,
              int heads, int kv_heads, int nb, int lanes, int splits,
              int window, float scale) {
  static_assert(BT % 16 == 0, "the P.V k-step takes 16 keys");
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  constexpr int RS = D + 8;         // smem row stride: 16 B aligned rows,
                                    // conflict-free fragment reads
  constexpr int KSTEPS = D / 16;
  constexpr int NT_S = BT / 8;
  constexpr int NT_O = D / 8;
  constexpr int VEC = 16 / sizeof(KT);
  constexpr int VPR = D / VEC;
  __shared__ __align__(16) bf16 k_s[BT * RS];
  __shared__ __align__(16) bf16 v_s[BT * RS];

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int split = blockIdx.x % splits;
  const int lane0 = (blockIdx.x / splits) * lanes;
  const int per = (nb + splits - 1) / splits;
  const int j_end = min(nb, (split + 1) * per);
  const int group = heads / kv_heads;
  const int rows = lanes * group;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tg = lane & 3;  // mma group, thread in group
  const int start = starts[b];
  const int pad = pads[b];

  // this thread's two query rows r0, r1 (row r = lane r / group, head
  // kvh*group + r % group)
  int qp[2], head[2], qi[2];
  bool live[2], valid[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = warp * 16 + gq + 8 * e;
    qi[e] = lane0 + r / group;
    head[e] = kvh * group + r % group;
    live[e] = r < rows && qi[e] < t_len;
    valid[e] = live[e] && qi[e] >= pad;
    qp[e] = start + qi[e];
  }
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rsel = e & 1;
      const int c = kk * 16 + tg * 2 + (e >> 1) * 8;
      qf[kk][e] = live[rsel]
          ? *reinterpret_cast<const uint32_t*>(
                q + ((size_t)(b * t_len + qi[rsel]) * heads + head[rsel]) *
                        D + c)
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

  const int first = max(lane0, pad);
  const int last = min(lane0 + lanes, t_len) - 1;
  const int q_lo = start + first;
  const int q_hi = start + last;
  const bool ring = window > 0;
  const bool ring_skip =
      ring && floordiv(q_hi, BT) - floordiv(q_lo, BT) < nb;

  for (int j = split * per; first <= last && j < j_end; ++j) {
    const int page = tables[(size_t)b * nb + j];
    if (page < 0 ||
        !slot_visible(j, q_lo, q_hi, BT, nb, window, ring_skip))
      continue;
    __syncthreads();   // the previous page has been read by every warp
    for (int idx = tid; idx < BT * VPR; idx += THREADS) {
      const int r = idx / VPR, c = (idx % VPR) * VEC;
      const size_t src = ((size_t)page * BT + r) * kv_heads + kvh;
      const uint4 kx = *reinterpret_cast<const uint4*>(kp + src * D + c);
      const uint4 vx = *reinterpret_cast<const uint4*>(vp + src * D + c);
      if (QUANT) {
        // 16 int8 -> 16 bf16 (two 16-byte stores), times the row's scale
        const int8_t* ke = reinterpret_cast<const int8_t*>(&kx);
        const int8_t* ve = reinterpret_cast<const int8_t*>(&vx);
        const float ksc = ks[src], vsc = vs[src];
        uint32_t kw[8], vw[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          kw[e] = pack(ke[2 * e] * ksc, ke[2 * e + 1] * ksc);
          vw[e] = pack(ve[2 * e] * vsc, ve[2 * e + 1] * vsc);
        }
        uint4* kd = reinterpret_cast<uint4*>(k_s + r * RS + c);
        uint4* vd = reinterpret_cast<uint4*>(v_s + r * RS + c);
        kd[0] = make_uint4(kw[0], kw[1], kw[2], kw[3]);
        kd[1] = make_uint4(kw[4], kw[5], kw[6], kw[7]);
        vd[0] = make_uint4(vw[0], vw[1], vw[2], vw[3]);
        vd[1] = make_uint4(vw[4], vw[5], vw[6], vw[7]);
      } else {
        *reinterpret_cast<uint4*>(k_s + r * RS + c) = kx;
        *reinterpret_cast<uint4*>(v_s + r * RS + c) = vx;
      }
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BT keys
    float s[NT_S][4];
#pragma unroll
    for (int jn = 0; jn < NT_S; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int jn = 0; jn < NT_S; ++jn) {
        const bf16* kr = k_s + (jn * 8 + gq) * RS + kk * 16 + tg * 2;
        mma(s[jn], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
            *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // mask, scale to the log2 domain, the tile's row max
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int jn = 0; jn < NT_S; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rs = e >> 1;
        const int kpos = key_pos(j, jn * 8 + tg * 2 + (e & 1), qp[rs], BT,
                                 nb, ring);
        const bool ok = valid[rs] && key_visible(kpos, qp[rs], window);
        const float x = ok ? s[jn][e] * scale2 : NEG_INF;
        s[jn][e] = x;
        mx[rs] = fmaxf(mx[rs], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
      // the four threads of a group hold one row between them
      mx[rs] = fmaxf(mx[rs], __shfl_xor_sync(FULL, mx[rs], 1));
      mx[rs] = fmaxf(mx[rs], __shfl_xor_sync(FULL, mx[rs], 2));
      const float mn = fmaxf(m[rs], mx[rs]);
      corr[rs] = exp2f(m[rs] - mn);
      m[rs] = mn;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int jn = 0; jn < NT_S; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rs = e >> 1;
        const float x = s[jn][e];
        // masked scores are exactly NEG_INF and give exactly 0
        const float pv = x > 0.5f * NEG_INF ? exp2f(x - m[rs]) : 0.f;
        s[jn][e] = pv;
        sum[rs] += pv;
      }
    }
    l[0] = l[0] * corr[0] + sum[0];
    l[1] = l[1] * corr[1] + sum[1];
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: the score accumulators of n-tiles 2kk, 2kk+1 are the A
    // fragment of key step kk
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* vrow = v_s + (kk * 16 + (lane & 15)) * RS;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + n * 8);
        mma(o[n], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int rs = 0; rs < 2; ++rs) {
    l[rs] += __shfl_xor_sync(FULL, l[rs], 1);
    l[rs] += __shfl_xor_sync(FULL, l[rs], 2);
  }
#pragma unroll
  for (int rs = 0; rs < 2; ++rs) {
    if (!live[rs]) continue;
    const size_t row = (size_t)(b * t_len + qi[rs]) * heads + head[rs];
    if (splits > 1) {
      // unnormalised partials in the natural-log domain of the combine
      float* prow = part + (row * splits + split) * (D + 2);
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        prow[n * 8 + tg * 2] = o[n][2 * rs];
        prow[n * 8 + tg * 2 + 1] = o[n][2 * rs + 1];
      }
      if (tg == 0) {
        prow[D] = m[rs] * LN2;
        prow[D + 1] = l[rs];
      }
      continue;
    }
    const float inv = 1.f / fmaxf(l[rs], 1e-30f);
    bf16* orow = out + row * D;
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + tg * 2) =
          pack(o[n][2 * rs] * inv, o[n][2 * rs + 1] * inv);
  }
}

}  // namespace tc

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
  int batch, t_len, heads, kv_heads, nb, splits, window;
  float scale;
};

// Query lanes one block serves: 64 rows on the tensor-core arm, 32 on the
// CUDA cores, over the Hq/KVH query heads of its kv head.
int lanes_per_block(bool tensor_cores, int group) {
  return (tensor_cores ? tc::ROWS_TC : ROWS) / group;
}

template <typename QT, typename KT, int D, int BT>
cudaError_t launch(const Args& a, bool tensor_cores, cudaStream_t stream) {
  const int lanes = lanes_per_block(tensor_cores, a.heads / a.kv_heads);
  const dim3 grid((a.t_len + lanes - 1) / lanes * a.splits, a.kv_heads,
                  a.batch);
  cudaError_t err = cudaSuccess;
  if constexpr (std::is_same<QT, bf16>::value && BT % 16 == 0) {
    if (tensor_cores) {
      tc::paged_attn_tc<KT, D, BT><<<grid, THREADS, 0, stream>>>(
          static_cast<const bf16*>(a.q), static_cast<const KT*>(a.k),
          static_cast<const KT*>(a.v), a.ks, a.vs, a.tables, a.starts,
          a.pads, static_cast<bf16*>(a.out), a.part, a.t_len, a.heads,
          a.kv_heads, a.nb, lanes, a.splits, a.window, a.scale);
    }
  }
  if (!tensor_cores) {
    const size_t smem = sizeof(float) * (ROWS * D + BT * (D + 1) + BT * D);
    auto kernel = paged_attn_kernel<QT, KT, D, BT>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const QT*>(a.q), static_cast<const KT*>(a.k),
        static_cast<const KT*>(a.v), a.ks, a.vs, a.tables, a.starts,
        a.pads, static_cast<QT*>(a.out), a.part, a.t_len, a.heads,
        a.kv_heads, a.nb, lanes, a.splits, a.window, a.scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  paged_combine_kernel<QT, D><<<a.batch * a.t_len * a.heads, 32, 0,
                                stream>>>(a.part, static_cast<QT*>(a.out),
                                          a.splits);
  return cudaGetLastError();
}

template <typename QT, typename KT, int D>
cudaError_t by_block(int bt, const Args& a, bool tc, cudaStream_t s) {
  switch (bt) {
    case 8: return launch<QT, KT, D, 8>(a, tc, s);
    case 16: return launch<QT, KT, D, 16>(a, tc, s);
    case 32: return launch<QT, KT, D, 32>(a, tc, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT, typename KT>
cudaError_t by_shape(int d, int bt, const Args& a, bool tc,
                     cudaStream_t s) {
  switch (d) {
    case 64: return by_block<QT, KT, 64>(bt, a, tc, s);
    case 128: return by_block<QT, KT, 128>(bt, a, tc, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q_dtype: 0 = float32, 1 = bfloat16 (q and out). kv_dtype: the pools'
// type, 0 = float32 or 1 = bfloat16 (equal to q_dtype), or 2 = int8 with
// f32 scale leaves k_scale/v_scale. Pools must start 16-byte aligned.
// tensor_cores: 1 runs the mma.sync arm (bf16 queries, block_tokens 16 or
// 32 only), 0 the CUDA-core arm. splits > 1 splits each row's table over
// that many blocks and needs the f32 workspace `part` of
// B*T*Hq*splits*(head_dim + 2) floats. Returns the cudaError_t of the
// launches (0 on success). Launches on `stream`, allocates nothing, does
// not sync.
int pdt_paged_attn(const void* q, const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* tables, const int* row_starts,
                   const int* pad_lens, void* out, float* part, int batch,
                   int t_len, int heads, int kv_heads, int head_dim, int nb,
                   int block_tokens, int q_dtype, int kv_dtype, int window,
                   int splits, int tensor_cores, float scale, void* stream) {
  if (batch <= 0 || t_len <= 0 || nb <= 0 || heads <= 0 || kv_heads <= 0 ||
      heads % kv_heads != 0 || heads / kv_heads > ROWS || window < 0 ||
      splits < 1 || splits > nb || (splits > 1 && part == nullptr) ||
      (tensor_cores && (q_dtype != 1 || block_tokens % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const bool use_tc = tensor_cores != 0;
  const Args a{q,      k_pool,   v_pool, k_scale, v_scale, tables,
               row_starts, pad_lens, out, part,  batch,   t_len,
               heads,  kv_heads, nb,     splits,  window,  scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 2) {
    if (k_scale == nullptr || v_scale == nullptr)
      return (int)cudaErrorInvalidValue;
    if (q_dtype == 0)
      return (int)by_shape<float, int8_t>(head_dim, block_tokens, a, use_tc, s);
    if (q_dtype == 1)
      return (int)by_shape<bf16, int8_t>(head_dim, block_tokens, a, use_tc, s);
    return (int)cudaErrorInvalidValue;
  }
  if (kv_dtype != q_dtype) return (int)cudaErrorInvalidValue;
  if (q_dtype == 0)
    return (int)by_shape<float, float>(head_dim, block_tokens, a, use_tc, s);
  if (q_dtype == 1)
    return (int)by_shape<bf16, bf16>(head_dim, block_tokens, a, use_tc, s);
  return (int)cudaErrorInvalidValue;
}

// Query lanes per block of the chosen arm (the wrapper sizes the split
// workspace from the grid this implies).
int pdt_paged_lanes(int tensor_cores, int group) {
  return lanes_per_block(tensor_cores != 0, group);
}

const char* pdt_paged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
