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
//   scratch across the KV grid axis. Here one block owns one query tile
//   of one (batch, head) and walks its KV tiles in a loop, from the band
//   start max(0, q0 - window + 1) to the diagonal (causal) or the end, so
//   tiles outside the band are never read at all.
// - The TPU pads T to the block size and masks `t_valid`; here keys and
//   queries at or past T are masked in the kernel, so nothing is padded
//   or copied.
// - GQA reads K/V at their stored width: kv head = h / (H / KVH). The
//   head expansion (`jnp.repeat`) of the JAX model never exists.
// - q, k, v and out keep the public [B, T, heads, D] layout; lse is
//   [B, H, T] f32.
//
// What bounds it: attention at the serving shapes (T >= 1024, D = 128) does
// ~T/2 FLOPs per byte of K/V, far above the card's ~295 FLOP/byte ridge, so
// the bound is the arithmetic. Two kernels, one per input type:
// - bf16 (the serving path): the products run on the tensor cores with
//   warp-level mma.sync m16n8k16 (bf16 in, f32 accumulate). Each of four
//   warps owns 16 query rows; Q stays in registers as A fragments, the
//   score accumulators are reused in registers as the A fragments of P
//   (rounded to bf16) for P.V, and V's B fragments come from row-major
//   shared memory through ldmatrix.trans. Loads are synchronous (no
//   cp.async/TMA pipeline) and there is no wgmma: later work.
// - f32: the same arithmetic in f32 on the CUDA cores from shared-memory
//   tiles (register-blocked 2x4 score and 4x(D/16) output micro-tiles),
//   so float32 parity runs keep full f32 products.
// The K/V tiles are read from device memory once per query tile.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_fwd.so flash_fwd.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BQ = 64;        // query rows per block: 16 per warp
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

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

// two consecutive bf16 of row `t` (0 past the sequence end)
__device__ __forceinline__ uint32_t load_pair(const bf16* base, int t,
                                              int t_len, size_t row,
                                              int col) {
  if (t >= t_len) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (size_t)t * row + col);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int t_len, int heads,
                 int kv_heads, int causal, int window, float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int RS = D + 8;         // smem row stride: 16 B aligned rows,
                                    // conflict-free fragment reads
  constexpr int KSTEPS = D / 16;    // k-steps of Q.K^T
  constexpr int NT_S = BK / 8;      // n-tiles of a score tile
  constexpr int NT_O = D / 8;       // n-tiles of the output
  constexpr int VECS = D / 8;       // 16-byte vectors per K/V row

  __shared__ __align__(16) bf16 k_s[BK * RS];
  __shared__ __align__(16) bf16 v_s[BK * RS];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tg = lane & 3;  // mma group and thread-in-group
  // causal: the longest rows first, so the last blocks to start are short
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * BQ;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int kvh = h / (heads / kv_heads);
  const size_t q_row = (size_t)heads * D;
  const size_t kv_row = (size_t)kv_heads * D;
  const bf16* qb = q + (size_t)b * t_len * q_row + (size_t)h * D;
  const bf16* kb = k + (size_t)b * t_len * kv_row + (size_t)kvh * D;
  const bf16* vb = v + (size_t)b * t_len * kv_row + (size_t)kvh * D;

  const int r0 = q0 + warp * 16 + g;  // this thread's two query rows
  const int r1 = r0 + 8;

  uint32_t qf[KSTEPS][4];  // A fragments of this warp's 16 x D query rows
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + tg * 2;
    qf[kk][0] = load_pair(qb, r0, t_len, q_row, c);
    qf[kk][1] = load_pair(qb, r1, t_len, q_row, c);
    qf[kk][2] = load_pair(qb, r0, t_len, q_row, c + 8);
    qf[kk][3] = load_pair(qb, r1, t_len, q_row, c + 8);
  }

  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // running max (log2 domain) and this thread's share of the running sum
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const float scale2 = scale * LOG2E;

  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  k_lo = (k_lo / BK) * BK;
  const int k_hi = causal ? min(t_len, q0 + BQ) : t_len;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile has been read by every warp
    for (int i = tid; i < BK * VECS; i += THREADS) {
      const int r = i / VECS, c = (i % VECS) * 8;
      const int t = k0 + r;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (t < t_len) {
        kx = *reinterpret_cast<const uint4*>(kb + (size_t)t * kv_row + c);
        vx = *reinterpret_cast<const uint4*>(vb + (size_t)t * kv_row + c);
      }
      *reinterpret_cast<uint4*>(k_s + r * RS + c) = kx;
      *reinterpret_cast<uint4*>(v_s + r * RS + c) = vx;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BK keys
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        const bf16* kr = k_s + (j * 8 + g) * RS + kk * 16 + tg * 2;
        mma(s[j], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
            *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // mask, scale to the log2 domain, tile row max
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = k0 + j * 8 + tg * 2 + (e & 1);
        const bool ok = col < t_len && (!causal || col <= row) &&
                        (window <= 0 || row - col < window);
        const float x = ok ? s[j][e] * scale2 : NEG_INF;
        s[j][e] = x;
        if (e < 2)
          mx0 = fmaxf(mx0, x);
        else
          mx1 = fmaxf(mx1, x);
      }
    }
    // the four threads of a group hold one row between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        // masked scores are exactly NEG_INF and give exactly 0
        const float p = x > 0.5f * NEG_INF ? exp2f(x - (e < 2 ? mn0 : mn1))
                                           : 0.f;
        s[j][e] = p;
        if (e < 2)
          sum0 += p;
        else
          sum1 += p;
      }
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }

    // O += P V: the score accumulators of n-tiles 2kk, 2kk+1 are the A
    // fragment of key step kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
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

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / lc0, inv1 = 1.f / lc1;
  bf16* ob = out + (size_t)b * t_len * q_row + (size_t)h * D;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int c = n * 8 + tg * 2;
    if (r0 < t_len)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * q_row + c) =
          pack(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < t_len)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * q_row + c) =
          pack(o[n][2] * inv1, o[n][3] * inv1);
  }
  if (tg == 0) {
    float* lrow = lse + (size_t)bh * t_len;
    if (r0 < t_len) lrow[r0] = m0 * LN2 + logf(lc0);
    if (r1 < t_len) lrow[r1] = m1 * LN2 + logf(lc1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int batch, int t_len, int heads, int kv_heads,
                   int causal, int window, float scale, cudaStream_t stream) {
  const dim3 grid((t_len + BQ - 1) / BQ, batch * heads);
  flash_fwd_tc<D><<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, t_len,
      heads, kv_heads, causal, window, scale);
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

}  // extern "C"
