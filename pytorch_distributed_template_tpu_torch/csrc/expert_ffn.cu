// Expert FFN for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_ffn_kernel` of
// scripts/debug_moe_pallas_ffn.py (launched by `pallas_expert_ffn`). It
// computes the same function, the expert FFN of the MoE layer's "gelu" arm
// (pytorch_distributed_template_tpu/models/moe.py):
//
//   out[e] = gelu_tanh(x[e] . wi[e] + bi[e]) . wo[e] + bo[e]
//
// for x [E, C, D], wi [E, D, F], wo [E, F, D], optional bi [E, F] and
// bo [E, D] (no biases is the TPU kernel's own contract), out [E, C, D].
// Products accumulate in f32; the bias, the tanh-gelu and the output bias
// are f32; the hidden is rounded to the input type once, after the gelu,
// before the second product (as the TPU kernel does) and the result once
// to the output type.
//
// What bounds it: at the MoE main path's shape (E 8, C 5120, D 512, F 1024)
// the function does 4 E C D F = 86 GFLOP on 101 MB, ~850 FLOP per byte, so
// the card's bound is the arithmetic (0.087 ms at 989 TFLOP/s).
//
// Design (bf16): two launches of one hand-written grouped GEMM, each with a
// fused epilogue,
//   1. hidden[e] = bf16(gelu_tanh(x[e] . wi[e] + bi[e]))  into [E, C, F],
//   2. out[e]    = bf16(hidden[e] . wo[e] + bo[e]),
// where the TPU kernel keeps the [C, F] hidden on chip. Why the hidden goes
// through device memory here: the TPU holds a whole expert's weights in
// VMEM and a 512-row block's [512, D] accumulator beside them. On Hopper a
// [BM, D] f32 accumulator big enough to stop the weights being re-read
// does not fit a block's registers (128 rows x 512 = 256 KB, the whole
// register file), and shrinking the row tile to fit (as the first version
// did: 32 rows at D 512, 16 at D 768) makes every tile re-read its
// expert's weights from L2: 2.7 GB at the main shape, 6 GB at the probe's.
// The hidden's round trip costs 2 x 84 MB at the main shape, ~0.05 ms at
// 3.35 TB/s, far less.
//
// The GEMM, C[e] (M x N) = A[e] (M x K, K contiguous) . B[e] (K x N, N
// contiguous), in 128 x 128 output tiles of one expert each, walked by
// persistent blocks (one per SM):
// - a producer warpgroup (one thread issues TMA loads; the warpgroup gives
//   its registers away with setmaxnreg) and two consumer warpgroups of 64
//   rows each;
// - a ring of 4 shared-memory stages of 64-deep k-steps, loaded by TMA from
//   3-D tensor maps (inner, rows, expert), so that no tile crosses an
//   expert and ragged edges (C, or F and D not multiples of the tile) load
//   as zeros; completion and release through mbarriers;
// - wgmma m64n128k16 from shared memory: A K-major, B (wi and wo are both
//   N-contiguous) MN-major, 128-byte swizzle; one k-step's products stay in
//   flight while the next is issued, and a stage goes back to the producer
//   once the products reading it have retired;
// - the epilogue adds the bias in f32 (and the tanh-gelu for the hidden),
//   rounds once to bf16 and stores rows below C and columns below N only.
//
// f32: the fused arithmetic on the CUDA cores (16-row tiles, 16-column
// hidden chunks, the hidden in shared memory), for the card-vs-CPU parity
// runs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libexpert_ffn.so expert_ffn.cu -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int D_MAX = 1024;
constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2 / pi)

__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v * (1.f + tanhf(GELU_C * (v + 0.044715f * v * v * v)));
}

// ---------------------------------------------------------------------------
// bf16: grouped GEMM with TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;          // rows per tile: 64 per consumer
constexpr int BN = 128;          // output columns per tile
constexpr int BK = 64;           // k per stage: one 128-byte atom of A
constexpr int STAGES = 4;
constexpr int GTHREADS = 384;    // producer warpgroup + two consumers
constexpr uint32_t A_BYTES = BM * BK * 2;  // [BM][64]
constexpr uint32_t B_BYTES = BK * BN * 2;  // two boxes of [64 k][64 n]
constexpr size_t SMEM = 1024 + STAGES * (size_t)(A_BYTES + B_BYTES) + 64;

enum Epilogue { GELU_HIDDEN = 0, BIAS_OUT = 1 };

// Persistent: block g takes output tiles g, g + G, ... (G blocks, at most
// one per SM), numbered n-tile fastest, then row tile, then expert, so
// neighbouring blocks share an x (or hidden) row tile and every tile of an
// expert reads the same weights from L2. The producer runs ahead across
// tiles: the next tile's first k-steps load during this tile's epilogue.
template <int EPI>
__global__ void __launch_bounds__(GTHREADS, 1)
    grouped_gemm(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map,
                 const bf16* __restrict__ bias, bf16* __restrict__ c,
                 int experts, int m, int n, int k) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  bf16* a_s = reinterpret_cast<bf16*>(base);  // STAGES x [BM][BK]
  bf16* b_s = a_s + STAGES * BM * BK;         // STAGES x 2 x [BK][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + STAGES * BK * BN);
  uint64_t* empty = full + STAGES;

  const int n_tiles = (n + BN - 1) / BN;
  const int m_tiles = (m + BM - 1) / BM;
  const int tiles = n_tiles * m_tiles * experts;
  const int k_steps = (k + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;  // k-steps loaded so far: stage it % STAGES
      for (int w = blockIdx.x; w < tiles; w += gridDim.x) {
        const int n0 = (w % n_tiles) * BN;
        const int m0 = (w / n_tiles % m_tiles) * BM;
        const int e = w / (n_tiles * m_tiles);
        for (int i = 0; i < k_steps; ++i, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], A_BYTES + B_BYTES);
          bf16* bs = b_s + s * BK * BN;
          tma_load_3d(a_s + s * BM * BK, &a_map, &full[s], i * BK, m0, e);
          tma_load_3d(bs, &b_map, &full[s], n0, i * BK, e);
          tma_load_3d(bs + BK * 64, &b_map, &full[s], n0 + 64, i * BK, e);
        }
      }
    }
  } else {
    // ---- consumers: 64 rows x 128 columns each ----
    setmaxnreg_inc<232>();
    const int cw = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    int it = 0;  // k-steps consumed so far
    for (int w = blockIdx.x; w < tiles; w += gridDim.x) {
      const int n0 = (w % n_tiles) * BN;
      const int m0 = (w / n_tiles % m_tiles) * BM;
      const int e = w / (n_tiles * m_tiles);
      float acc[BN / 2];
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;

      for (int i = 0; i < k_steps; ++i, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const bf16* as = a_s + s * BM * BK + cw * 64 * BK;
        const bf16* bs = b_s + s * BK * BN;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss<BN, 1>(acc, desc_k_major<128>(as + kk * 16),
                          desc_mn_major<128>(bs + kk * 16 * 64,
                                             BK * 64 * 2),
                          1);
        wgmma_commit();
        // the previous k-step's products have retired: release its stage
        wgmma_wait<1>();
        fence_regs(acc);
        if (i > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(it - 1) % STAGES]);

      // epilogue: f32 bias (+ gelu), one rounding to bf16, ragged edges cut
      const int row0 = m0 + cw * 64 + warp * 16 + (lane >> 2);
      const bf16* be = bias == nullptr ? nullptr : bias + (size_t)e * n;
      bf16* ce = c + (size_t)e * m * n;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + j * 8 + (lane & 3) * 2;  // n even: col + 1 too
        if (col >= n) continue;
        float b0 = 0.f, b1 = 0.f;
        if (be != nullptr) {
          b0 = __bfloat162float(be[col]);
          b1 = __bfloat162float(be[col + 1]);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + 8 * half;
          if (row >= m) continue;
          float v0 = acc[4 * j + 2 * half] + b0;
          float v1 = acc[4 * j + 2 * half + 1] + b1;
          if (EPI == GELU_HIDDEN) {
            v0 = gelu_tanh(v0);
            v1 = gelu_tanh(v1);
          }
          *reinterpret_cast<uint32_t*>(ce + (size_t)row * n + col) =
              pack_bf16(v0, v1);
        }
      }
    }
  }
}

// a 3-D map over [experts, rows, inner] bf16 with boxes of
// [box_rows][64] (one 128-byte atom of the inner dimension)
bool map_3d(CUtensorMap* map, const void* p, int experts, int rows,
            int inner, int box_rows) {
  const uint64_t dims[3] = {(uint64_t)inner, (uint64_t)rows,
                            (uint64_t)experts};
  const uint64_t strides[2] = {(uint64_t)inner * 2,
                               (uint64_t)rows * inner * 2};
  const uint32_t box[3] = {64u, (uint32_t)box_rows, 1u};
  return encode_map(map, p, 3, dims, strides, box, 128);
}

template <int EPI>
cudaError_t gemm(const CUtensorMap& a_map, const CUtensorMap& b_map,
                 const void* bias, void* c, int experts, int m, int n, int k,
                 cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      grouped_gemm<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  const int tiles = ((n + BN - 1) / BN) * ((m + BM - 1) / BM) * experts;
  grouped_gemm<EPI><<<min(tiles, sms), GTHREADS, SMEM, stream>>>(
      a_map, b_map, static_cast<const bf16*>(bias), static_cast<bf16*>(c),
      experts, m, n, k);
  return cudaGetLastError();
}

cudaError_t launch(const void* x, const void* wi, const void* wo,
                   const void* bi, const void* bo, void* hidden, void* out,
                   int experts, int cap, int d, int f, cudaStream_t stream) {
  CUtensorMap x_map, wi_map, h_map, wo_map;
  if (!map_3d(&x_map, x, experts, cap, d, BM) ||
      !map_3d(&wi_map, wi, experts, d, f, BK) ||
      !map_3d(&h_map, hidden, experts, cap, f, BM) ||
      !map_3d(&wo_map, wo, experts, f, d, BK))
    return cudaErrorInvalidValue;
  cudaError_t err = gemm<GELU_HIDDEN>(x_map, wi_map, bi, hidden, experts,
                                      cap, f, d, stream);
  if (err != cudaSuccess) return err;
  return gemm<BIAS_OUT>(h_map, wo_map, bo, out, experts, cap, d, f, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int BM = 16;                 // capacity rows per block
constexpr int BF = 16;                 // hidden columns per chunk
constexpr int CPT = D_MAX / THREADS;   // output columns per thread
static_assert(BM * BF == THREADS, "one hidden value per thread");

size_t smem_bytes(int d) {
  return ((size_t)BM * d + (size_t)BF * d + (size_t)BM * BF) * sizeof(float);
}

__global__ void __launch_bounds__(THREADS)
    expert_ffn_f32(const float* __restrict__ x, const float* __restrict__ wi,
                   const float* __restrict__ wo, const float* __restrict__ bi,
                   const float* __restrict__ bo, float* __restrict__ out,
                   int cap, int d, int f) {
  extern __shared__ float smf[];
  float* x_s = smf;                  // [BM][d]
  float* w_s = x_s + BM * d;         // wi chunk [d][BF] / wo chunk [BF][d]
  float* h_s = w_s + BF * d;         // [BM][BF]

  const int tid = threadIdx.x;
  const int e = blockIdx.y;
  const int c0 = blockIdx.x * BM;
  const float* xe = x + (size_t)e * cap * d;
  const float* wie = wi + (size_t)e * d * f;
  const float* woe = wo + (size_t)e * f * d;
  const float* bie = bi == nullptr ? nullptr : bi + (size_t)e * f;
  const float* boe = bo == nullptr ? nullptr : bo + (size_t)e * d;

  for (int i = tid; i < BM * d; i += THREADS) {
    const int r = i / d, c = i % d;
    x_s[i] = c0 + r < cap ? xe[(size_t)(c0 + r) * d + c] : 0.f;
  }
  float acc[BM][CPT];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int q = 0; q < CPT; ++q) acc[r][q] = 0.f;

  const int hr = tid / BF, hc = tid % BF;  // this thread's hidden value
  for (int f0 = 0; f0 < f; f0 += BF) {
    __syncthreads();
    for (int i = tid; i < d * BF; i += THREADS) {
      const int r = i / BF, c = i % BF;
      w_s[i] = f0 + c < f ? wie[(size_t)r * f + f0 + c] : 0.f;
    }
    __syncthreads();
    {
      float s = 0.f;
      for (int k = 0; k < d; ++k) s = fmaf(x_s[hr * d + k], w_s[k * BF + hc], s);
      if (bie != nullptr && f0 + hc < f) s += bie[f0 + hc];
      h_s[hr * BF + hc] = gelu_tanh(s);
    }
    __syncthreads();
    for (int i = tid; i < BF * d; i += THREADS) {
      const int r = i / d, c = i % d;
      w_s[i] = f0 + r < f ? woe[(size_t)(f0 + r) * d + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BF; ++j) {
      float wv[CPT];
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int col = tid + q * THREADS;
        wv[q] = col < d ? w_s[j * d + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float hv = h_s[r * BF + j];
#pragma unroll
        for (int q = 0; q < CPT; ++q) acc[r][q] = fmaf(hv, wv[q], acc[r][q]);
      }
    }
  }

  float* oe = out + (size_t)e * cap * d;
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int col = tid + q * THREADS;
    if (col >= d) continue;
    const float b = boe == nullptr ? 0.f : boe[col];
#pragma unroll
    for (int r = 0; r < BM; ++r)
      if (c0 + r < cap) oe[(size_t)(c0 + r) * d + col] = acc[r][q] + b;
  }
}

cudaError_t launch(const void* x, const void* wi, const void* wo,
                   const void* bi, const void* bo, void* out, int experts,
                   int cap, int d, int f, cudaStream_t stream) {
  if (d > D_MAX) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      expert_ffn_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((cap + BM - 1) / BM, experts);
  expert_ffn_f32<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wi),
      static_cast<const float*>(wo), static_cast<const float*>(bi),
      static_cast<const float*>(bo), static_cast<float*>(out), cap, d, f);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; x, wi, wo
// and hidden 16-byte aligned). bi / bo may be null. `hidden` is the bf16
// arm's [E, C, F] scratch for the hidden (the caller allocates it; the f32
// arm ignores it). D and F multiples of 16, D <= 1024. Returns the
// cudaError_t of the first launch that fails (0 on success). Launches on
// `stream`, allocates nothing, does not sync.
int pdt_expert_ffn(const void* x, const void* wi, const void* wo,
                   const void* bi, const void* bo, void* hidden, void* out,
                   int experts, int cap, int d, int f, int dtype,
                   void* stream) {
  if (experts <= 0 || cap <= 0 || d <= 0 || f <= 0 || d % 16 != 0 ||
      f % 16 != 0 || d > D_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)f32::launch(x, wi, wo, bi, bo, out, experts, cap, d, f, s);
  if (dtype == 1 && hidden != nullptr)
    return (int)tc::launch(x, wi, wo, bi, bo, hidden, out, experts, cap, d,
                           f, s);
  return (int)cudaErrorInvalidValue;
}

// capacity rows per block (per tile) of the kernel for (d, dtype); 0 if
// not taken
int pdt_expert_ffn_rows(int d, int dtype) {
  if (d <= 0 || d % 16 != 0 || d > D_MAX) return 0;
  return dtype == 1 ? tc::BM : f32::BM;
}

const char* pdt_expert_ffn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
