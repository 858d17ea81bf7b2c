// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Two kernels, the backward of csrc/flash_fwd.cu (B1):
// - B2 `flash_bwd_dkv` replaces the Pallas TPU kernel `_bwd_dkv_kernel` of
//   pytorch_distributed_template_tpu/ops/flash.py (launched by
//   `_bwd_pallas_3d`): dK and dV.
// - B3 `flash_bwd_dq` replaces `_bwd_dq_kernel` (same file): dQ.
// Both recompute the probability tile from the forward's logsumexp,
//   P = exp(q k^T * scale - lse),  dP = dO v^T,  dS = P * (dP - delta) * scale,
// and accumulate dV += P^T dO, dK += dS^T q (B2) or dQ += dS k (B3) in f32.
// `delta` = rowsum(dO * out) (minus the lse cotangent when the caller used
// lse) is computed by the caller, as the TPU version leaves it to XLA.
// Masking is B1's: keys past T, by causality and by the band q - k < window;
// masked entries give P = 0 exactly.
//
// What differs from the TPU kernels, and why:
// - The TPU walks its grid in order and carries the dK/dV (or dQ) sums in
//   VMEM scratch across the streamed axis. Here one block owns one tile of
//   keys (B2) or queries (B3) and loops over the streamed tiles itself,
//   only over those the causal or band mask leaves visible.
// - GQA: B2's block owns (batch, kv head, key tile) and loops over the
//   `groups` query heads of its kv head, so dK/dV come out at the stored
//   kv-head width, summed over the group inside the block: no atomics, no
//   head expansion, deterministic results. B3's block owns (batch, query
//   head, query tile) and reads its kv head h / groups.
// - Ragged T is masked in the kernel: keys and queries past T read as zero
//   and are never written, so nothing is padded.
// - Layout is the public one: q, k, v, dO and the gradients [B, T, heads, D],
//   lse and delta [B, H, T] f32.
//
// What bounds it: at the training shapes (T = 1024, D = 64) the backward
// does ~T/2 FLOPs per byte it must move, far above the card's ~295 FLOP/byte
// ridge: the arithmetic bounds it. Two arms, one per input type:
// - bf16: every product runs on the tensor cores with warp-level mma.sync
//   m16n8k16 (bf16 in, f32 accumulate). Each of four warps owns 16 rows of
//   the block's tile; the score and dP accumulators are reused in registers
//   as the A fragments of P^T dO / dS^T q (B2) or dS k (B3), rounded to bf16,
//   and the transposed B operands come from row-major shared memory through
//   ldmatrix.trans. Tiles are loaded synchronously (no cp.async/TMA
//   pipeline) and there is no wgmma: later work.
// - f32: the same arithmetic in f32 on the CUDA cores from shared-memory
//   tiles, so float32 parity runs keep full f32 products.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_bwd.so flash_bwd.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// visible(query row, key col): B1's mask
__device__ __forceinline__ bool visible(int qpos, int kpos, int t_len,
                                        int causal, int window) {
  return qpos < t_len && kpos < t_len && (!causal || kpos <= qpos) &&
         (window <= 0 || qpos - kpos < window);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BM = 64;        // rows a block owns: keys (B2) or queries (B3)
constexpr int WARPS = 4;      // 16 rows each
constexpr int THREADS = WARPS * 32;

using bf16 = __nv_bfloat16;

template <int D>
struct Tile {
  static constexpr int BN = D == 128 ? 32 : 64;  // rows of a streamed tile
  static constexpr int RS = D + 8;  // smem row stride: 16 B aligned rows,
                                    // conflict-free fragment reads
  static constexpr size_t bytes =
      (size_t)(2 * BM + 2 * BN) * RS * sizeof(bf16) + 2 * BN * sizeof(float);
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two 8x8 b16 matrices from shared memory, transposed: lanes 0-7 give the
// row addresses of the first, lanes 8-15 of the second
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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of a 16 x 16 row-major tile at `base` (row stride rs)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* base,
                                       int rs, int g, int tg) {
  const bf16* p0 = base + g * rs + tg * 2;
  const bf16* p1 = p0 + 8 * rs;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

// the A fragment of key step kk from two 16 x 8 accumulator n-tiles
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float* lo,
                                         const float* hi) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

// rows [r0, r0 + n) of a [T, heads * D] tensor into smem (zero past T)
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t row, int r0, int n,
                                          int t_len, int tid) {
  constexpr int VECS = D / 8;
  constexpr int RS = Tile<D>::RS;
  for (int i = tid; i < n * VECS; i += THREADS) {
    const int r = i / VECS, c = (i % VECS) * 8;
    const int t = r0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (t < t_len)
      x = *reinterpret_cast<const uint4*>(src + (size_t)t * row + c);
    *reinterpret_cast<uint4*>(dst + r * RS + c) = x;
  }
}

// B2: dK, dV of one (batch, kv head, key tile)
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ go,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int t_len, int heads,
                     int kv_heads, int causal, int window, float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int BN = Tile<D>::BN;   // queries per streamed tile
  constexpr int RS = Tile<D>::RS;
  constexpr int KSTEPS = D / 16;    // k-steps over the head dim
  constexpr int NT_S = BN / 8;      // n-tiles of a score tile (queries)
  constexpr int NT_O = D / 8;       // n-tiles of dK / dV

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [BM][RS]
  bf16* v_s = k_s + BM * RS;                  // [BM][RS]
  bf16* q_s = v_s + BM * RS;                  // [BN][RS]
  bf16* g_s = q_s + BN * RS;                  // [BN][RS]  dO
  float* lse_s = reinterpret_cast<float*>(g_s + BN * RS);  // [BN] log2 dom.
  float* dl_s = lse_s + BN;                                 // [BN] delta

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tg = lane & 3;  // mma group and thread-in-group
  const int k0 = blockIdx.x * BM;
  const int b = blockIdx.y / kv_heads;
  const int kvh = blockIdx.y % kv_heads;
  const int groups = heads / kv_heads;
  const size_t q_row = (size_t)heads * D;
  const size_t kv_row = (size_t)kv_heads * D;
  const size_t kv_off = (size_t)b * t_len * kv_row + (size_t)kvh * D;

  load_rows<D>(k_s, k + kv_off, kv_row, k0, BM, t_len, tid);
  load_rows<D>(v_s, v + kv_off, kv_row, k0, BM, t_len, tid);

  float dka[NT_O][4], dva[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int kr0 = k0 + warp * 16 + g;  // this thread's two key rows
  const int kr1 = kr0 + 8;
  const float scale2 = scale * LOG2E;
  // the queries that can see a key of this tile
  const int k_last = min(k0 + BM, t_len) - 1;
  const int q_lo = causal ? (k0 / BN) * BN : 0;
  const int q_hi = window > 0 ? min(t_len, k_last + window) : t_len;
  const bf16* kw = k_s + warp * 16 * RS;
  const bf16* vw = v_s + warp * 16 * RS;

  for (int hh = 0; hh < groups; ++hh) {
    const int h = kvh * groups + hh;
    const size_t q_off = (size_t)b * t_len * q_row + (size_t)h * D;
    const float* lrow = lse + ((size_t)b * heads + h) * t_len;
    const float* drow = delta + ((size_t)b * heads + h) * t_len;
    for (int q0 = q_lo; q0 < q_hi; q0 += BN) {
      __syncthreads();  // the previous tiles have been read by every warp
      load_rows<D>(q_s, q + q_off, q_row, q0, BN, t_len, tid);
      load_rows<D>(g_s, go + q_off, q_row, q0, BN, t_len, tid);
      for (int i = tid; i < BN; i += THREADS) {
        const int t = q0 + i;
        lse_s[i] = t < t_len ? lrow[t] * LOG2E : 0.f;
        dl_s[i] = t < t_len ? drow[t] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T for this warp's 16 keys x BN queries
      float s[NT_S][4];
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t a[4];
        load_a(a, kw + kk * 16, RS, g, tg);
#pragma unroll
        for (int j = 0; j < NT_S; ++j) {
          const bf16* qr = q_s + (j * 8 + g) * RS + kk * 16 + tg * 2;
          mma(s[j], a, ld32(qr), ld32(qr + 8));
        }
      }
      // P^T = exp(S^T * scale - lse), 0 where masked
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = e < 2 ? kr0 : kr1;
          const int c = j * 8 + tg * 2 + (e & 1);
          s[j][e] = visible(q0 + c, kpos, t_len, causal, window)
                        ? exp2f(s[j][e] * scale2 - lse_s[c])
                        : 0.f;
        }
      }
      // dV += P^T dO (P rounded to bf16)
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
        const bf16* grow = g_s + (kk * 16 + (lane & 15)) * RS;
#pragma unroll
        for (int n = 0; n < NT_O; ++n) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, grow + n * 8);
          mma(dva[n], a, b0, b1);
        }
      }
      // dP^T = V dO^T
      float dp[NT_S][4];
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t a[4];
        load_a(a, vw + kk * 16, RS, g, tg);
#pragma unroll
        for (int j = 0; j < NT_S; ++j) {
          const bf16* gr = g_s + (j * 8 + g) * RS + kk * 16 + tg * 2;
          mma(dp[j], a, ld32(gr), ld32(gr + 8));
        }
      }
      // dS^T = P^T (dP^T - delta) * scale
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + tg * 2 + (e & 1);
          dp[j][e] = s[j][e] * (dp[j][e] - dl_s[c]) * scale;
        }
      // dK += dS^T Q (dS rounded to bf16)
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
        const bf16* qrow = q_s + (kk * 16 + (lane & 15)) * RS;
#pragma unroll
        for (int n = 0; n < NT_O; ++n) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, qrow + n * 8);
          mma(dka[n], a, b0, b1);
        }
      }
    }
  }

  bf16* dkb = dk + kv_off;
  bf16* dvb = dv + kv_off;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int c = n * 8 + tg * 2;
    if (kr0 < t_len) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)kr0 * kv_row + c) =
          pack(dka[n][0], dka[n][1]);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)kr0 * kv_row + c) =
          pack(dva[n][0], dva[n][1]);
    }
    if (kr1 < t_len) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)kr1 * kv_row + c) =
          pack(dka[n][2], dka[n][3]);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)kr1 * kv_row + c) =
          pack(dva[n][2], dva[n][3]);
    }
  }
}

// B3: dQ of one (batch, query head, query tile)
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ go,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int t_len, int heads, int kv_heads, int causal,
                    int window, float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int BN = Tile<D>::BN;   // keys per streamed tile
  constexpr int RS = Tile<D>::RS;
  constexpr int KSTEPS = D / 16;
  constexpr int NT_S = BN / 8;      // n-tiles of a score tile (keys)
  constexpr int NT_O = D / 8;       // n-tiles of dQ

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [BM][RS]
  bf16* g_s = q_s + BM * RS;                  // [BM][RS]  dO
  bf16* k_s = g_s + BM * RS;                  // [BN][RS]
  bf16* v_s = k_s + BN * RS;                  // [BN][RS]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tg = lane & 3;
  // causal: the longest rows first, so the last blocks to start are short
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * BM;
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

  const int r0 = q0 + warp * 16 + g;  // this thread's two query rows
  const int r1 = r0 + 8;
  const float* lrow = lse + (size_t)bh * t_len;
  const float* drow = delta + (size_t)bh * t_len;
  const float l0 = r0 < t_len ? lrow[r0] * LOG2E : 0.f;
  const float l1 = r1 < t_len ? lrow[r1] * LOG2E : 0.f;
  const float d0 = r0 < t_len ? drow[r0] : 0.f;
  const float d1 = r1 < t_len ? drow[r1] : 0.f;
  const float scale2 = scale * LOG2E;

  float dqa[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  k_lo = (k_lo / BN) * BN;
  const int k_hi = causal ? min(t_len, q0 + BM) : t_len;
  const bf16* qw = q_s + warp * 16 * RS;
  const bf16* gw = g_s + warp * 16 * RS;

  for (int k0 = k_lo; k0 < k_hi; k0 += BN) {
    __syncthreads();
    load_rows<D>(k_s, k + kv_off, kv_row, k0, BN, t_len, tid);
    load_rows<D>(v_s, v + kv_off, kv_row, k0, BN, t_len, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 queries x BN keys
    float s[NT_S][4], dp[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t aq[4], ag[4];
      load_a(aq, qw + kk * 16, RS, g, tg);
      load_a(ag, gw + kk * 16, RS, g, tg);
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        const bf16* kr = k_s + (j * 8 + g) * RS + kk * 16 + tg * 2;
        const bf16* vr = v_s + (j * 8 + g) * RS + kk * 16 + tg * 2;
        mma(s[j], aq, ld32(kr), ld32(kr + 8));
        mma(dp[j], ag, ld32(vr), ld32(vr + 8));
      }
    }
    // dS = P (dP - delta) * scale, P = exp(S * scale - lse), 0 where masked
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool top = e < 2;
        const int qpos = top ? r0 : r1;
        const int kpos = k0 + j * 8 + tg * 2 + (e & 1);
        const float p = visible(qpos, kpos, t_len, causal, window)
                            ? exp2f(s[j][e] * scale2 - (top ? l0 : l1))
                            : 0.f;
        dp[j][e] = p * (dp[j][e] - (top ? d0 : d1)) * scale;
      }
    }
    // dQ += dS K (dS rounded to bf16)
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
      const bf16* krow = k_s + (kk * 16 + (lane & 15)) * RS;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, krow + n * 8);
        mma(dqa[n], a, b0, b1);
      }
    }
  }

  bf16* dqb = dq + q_off;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int c = n * 8 + tg * 2;
    if (r0 < t_len)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)r0 * q_row + c) =
          pack(dqa[n][0], dqa[n][1]);
    if (r1 < t_len)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)r1 * q_row + c) =
          pack(dqa[n][2], dqa[n][3]);
  }
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* go, const float* lse, const float* delta,
                       void* dk, void* dv, int batch, int t_len, int heads,
                       int kv_heads, int causal, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem = Tile<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + BM - 1) / BM, batch * kv_heads);
  flash_bwd_dkv_tc<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(go), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), t_len, heads, kv_heads,
      causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* go, const float* lse, const float* delta,
                      void* dq, int batch, int t_len, int heads,
                      int kv_heads, int causal, int window, float scale,
                      cudaStream_t stream) {
  const size_t smem = Tile<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + BM - 1) / BM, batch * heads);
  flash_bwd_dq_tc<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(go), lse, delta,
      static_cast<bf16*>(dq), t_len, heads, kv_heads, causal, window, scale);
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

// B3, f32: dQ of one (batch, query head, query tile)
template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_f32(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ go,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq, int t_len, int heads,
                     int kv_heads, int causal, int window, float scale) {
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
  for (int i = tid; i < BM; i += THREADS) {
    const int t = q0 + i;
    lse_s[i] = t < t_len ? lse[(size_t)bh * t_len + t] : 0.f;
    dl_s[i] = t < t_len ? delta[(size_t)bh * t_len + t] : 0.f;
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
                      const void* go, const float* lse, const float* delta,
                      void* dq, int batch, int t_len, int heads,
                      int kv_heads, int causal, int window, float scale,
                      cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + BM - 1) / BM, batch * heads);
  flash_bwd_dq_f32<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(go), lse,
      delta, static_cast<float*>(dq), t_len, heads, kv_heads, causal, window,
      scale);
  return cudaGetLastError();
}

}  // namespace f32

// dkv_<arm> / dq_<arm>: the arm's launcher for head dim `d`
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
#define PDT_DKV_CALL_tc(D)                                                \
  tc::launch_dkv<D>(q, k, v, go, lse, delta, dk, dv, batch, t_len, heads,   \
                    kv_heads, causal, window, scale, s)
#define PDT_DKV_CALL_f32(D)                                                 \
  f32::launch_dkv<D>(q, k, v, go, lse, delta, dk, dv, batch, t_len, heads,  \
                     kv_heads, causal, window, scale, s)
#define PDT_DQ_CALL_tc(D)                                                   \
  tc::launch_dq<D>(q, k, v, go, lse, delta, dq, batch, t_len, heads,        \
                   kv_heads, causal, window, scale, s)
#define PDT_DQ_CALL_f32(D)                                                  \
  f32::launch_dq<D>(q, k, v, go, lse, delta, dq, batch, t_len, heads,       \
                    kv_heads, causal, window, scale, s)

cudaError_t dkv_tc(int d, const void* q, const void* k, const void* v,
                   const void* go, const float* lse, const float* delta,
                   void* dk, void* dv, int batch, int t_len, int heads,
                   int kv_heads, int causal, int window, float scale,
                   cudaStream_t s) {
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
                  const void* go, const float* lse, const float* delta,
                  void* dq, int batch, int t_len, int heads, int kv_heads,
                  int causal, int window, float scale, cudaStream_t s) {
  PDT_DISPATCH_D(PDT_DQ_CALL_tc)
}

cudaError_t dq_f32(int d, const void* q, const void* k, const void* v,
                   const void* go, const float* lse, const float* delta,
                   void* dq, int batch, int t_len, int heads, int kv_heads,
                   int causal, int window, float scale, cudaStream_t s) {
  PDT_DISPATCH_D(PDT_DQ_CALL_f32)
}

bool bad_shape(int batch, int t_len, int heads, int kv_heads, int window) {
  return batch <= 0 || t_len <= 0 || heads <= 0 || kv_heads <= 0 ||
         heads % kv_heads != 0 || window < 0;
}

}  // namespace

extern "C" {

// B2. dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; every
// tensor 16-byte aligned). q, go [B, T, H, D]; k, v, dk, dv [B, T, KVH, D];
// lse, delta [B, H, T] f32. Returns the cudaError_t of the launch (0 on
// success). Launches on `stream`, allocates nothing, does not sync.
int pdt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* go, const float* lse, const float* delta,
                      void* dk, void* dv, int batch, int t_len, int heads,
                      int kv_heads, int head_dim, int dtype, int causal,
                      int window, float scale, void* stream) {
  if (bad_shape(batch, t_len, heads, kv_heads, window))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dkv_f32(head_dim, q, k, v, go, lse, delta, dk, dv, batch,
                        t_len, heads, kv_heads, causal, window, scale, s);
  if (dtype == 1)
    return (int)dkv_tc(head_dim, q, k, v, go, lse, delta, dk, dv, batch,
                       t_len, heads, kv_heads, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// B3. Same conventions; dq [B, T, H, D].
int pdt_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* go, const float* lse, const float* delta,
                     void* dq, int batch, int t_len, int heads, int kv_heads,
                     int head_dim, int dtype, int causal, int window,
                     float scale, void* stream) {
  if (bad_shape(batch, t_len, heads, kv_heads, window))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dq_f32(head_dim, q, k, v, go, lse, delta, dq, batch, t_len,
                       heads, kv_heads, causal, window, scale, s);
  if (dtype == 1)
    return (int)dq_tc(head_dim, q, k, v, go, lse, delta, dq, batch, t_len,
                      heads, kv_heads, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* pdt_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
