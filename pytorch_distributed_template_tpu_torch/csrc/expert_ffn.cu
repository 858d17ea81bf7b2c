// Fused expert FFN for Hopper (sm_90a), plain C interface for ctypes.
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
// are f32; the hidden is rounded to the input type before the second
// product (as the TPU kernel does) and the result once to the output type.
//
// The point of the kernel: the [C, F] hidden never goes to device memory.
// A block owns one (expert, tile of BM capacity rows) and walks the hidden
// dimension F in chunks of BF columns. For each chunk it computes the
// [BM, BF] hidden slice into shared memory (bf16) and adds its product with
// the matching BF rows of wo into the block's [BM, D] output accumulator.
//
// What differs from the TPU kernel, and why:
// - The TPU keeps a whole [D, F] and [F, D] weight pair of one expert in
//   VMEM and runs a 512-row capacity block against it. No Hopper block can
//   hold that (227 KB of shared memory), so the weights stream through
//   shared memory chunk by chunk, once per block, and are re-read from L2
//   by every capacity tile of the expert.
// - The output accumulator [BM, D] f32 lives in registers. At BM = 64 it
//   would be 128 KB at D = 512 and 192 KB at D = 768, more than a block's
//   register file. So the capacity tile shrinks as D grows: BM = 64 for
//   D <= 256, 32 for D <= 512, 16 for D <= 1024, which keeps the
//   accumulator at 64 f32 registers per thread (8 warps, each owning an
//   interleaved set of the output's n8 column tiles). The cost is weight
//   traffic from L2: each expert's weights are read C / BM times.
// - The capacity dimension need not divide BM: rows past C load as zeros
//   and are not stored.
// - wi's chunk and wo's chunk share one shared-memory buffer, in turn.
//
// What bounds it: at the MoE main path's shape (E 8, C 5120, D 512, F 1024)
// the function does 4 E C D F = 86 GFLOP on 101 MB, ~850 FLOP per byte, so
// the card's bound is the arithmetic (0.087 ms at 989 TFLOP/s). Two
// kernels, one per input type:
// - bf16: both products on the tensor cores with warp-level mma.sync
//   m16n8k16 (bf16 in, f32 accumulate); A fragments through ldmatrix, B
//   fragments from row-major shared memory through ldmatrix.trans. Tile
//   loads are synchronous 16-byte copies (no cp.async/TMA pipeline, no
//   wgmma): later work.
// - f32: the same arithmetic on the CUDA cores (16-row tiles, 16-column
//   hidden chunks), for the card-vs-CPU parity runs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libexpert_ffn.so expert_ffn.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int D_MAX = 1024;
constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2 / pi)

__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v * (1.f + tanhf(GELU_C * (v + 0.044715f * v * v * v)));
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------
namespace tc {

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

__device__ __forceinline__ uint32_t smem_addr(const bf16* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A fragment of a 16 x 16 tile of a row-major [m][k] array: lane l gives
// the address of row (l & 15), column 8 (l >> 4)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// B fragment (k16 x n8) of a row-major [k][n] array: lanes 0-15 give the
// addresses of rows k0 .. k0 + 15 at column n0
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const bf16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_addr(row)));
}

// B fragments of two neighbouring n8 tiles (n0, n0 + 8): lane l gives the
// address of row k0 + (l & 15), column n0 + 8 (l >> 4); r[0], r[1] belong to
// the first tile, r[2], r[3] to the second
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// MT: m16 tiles of capacity rows per block (BM = 16 MT); NTW: n8 tiles of
// the output per warp (D <= 64 NTW); BF: hidden columns per chunk.
template <int MT, int NTW, int BF>
struct Cfg {
  static constexpr int BM = 16 * MT;
  static constexpr int H_TILES = MT * (BF / 8);  // m16n8 tiles of a chunk
  static constexpr int TPW = H_TILES / WARPS;    // of them per warp
  static constexpr int HS = BF + 8;              // row stride of h
  static constexpr int WIS = BF + 8;             // row stride of wi's chunk
  static_assert(H_TILES % WARPS == 0, "hidden tiles must split over warps");
  static_assert(NTW % 2 == 0, "output tiles go in pairs");
  static_assert(BF % 16 == 0, "a chunk is whole k16 steps");

  // Row strides of D + 8 (and BF + 8) elements: rows start 16-byte aligned,
  // and with D a multiple of 16 consecutive rows fall 16 bytes apart modulo
  // 128, so ldmatrix's eight row reads hit distinct banks.
  __host__ __device__ static size_t w_elems(int d) {
    const size_t wi = (size_t)d * WIS;
    const size_t wo = (size_t)BF * (d + 8);
    return wi > wo ? wi : wo;
  }
  static size_t smem_bytes(int d) {
    return ((size_t)BM * (d + 8) + w_elems(d) + (size_t)BM * HS) *
           sizeof(bf16);
  }
};

template <int MT, int NTW, int BF>
__global__ void __launch_bounds__(THREADS)
    expert_ffn_tc(const bf16* __restrict__ x, const bf16* __restrict__ wi,
                  const bf16* __restrict__ wo, const bf16* __restrict__ bi,
                  const bf16* __restrict__ bo, bf16* __restrict__ out,
                  int cap, int d, int f) {
  using C = Cfg<MT, NTW, BF>;
  constexpr int BM = C::BM;
  constexpr int HS = C::HS;
  constexpr int WIS = C::WIS;
  constexpr int BV = BF / 8;  // 16-byte vectors per row of wi's chunk

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int xs = d + 8;   // row stride of the x tile
  const int wos = d + 8;  // row stride of wo's chunk
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);  // [BM][xs]
  bf16* w_s = x_s + (size_t)BM * xs;  // wi chunk [d][WIS] / wo chunk [BF][wos]
  bf16* h_s = w_s + C::w_elems(d);    // [BM][HS]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tg = lane & 3;  // mma group and thread-in-group
  const int e = blockIdx.y;
  const int c0 = blockIdx.x * BM;
  const bf16* xe = x + (size_t)e * cap * d;
  const bf16* wie = wi + (size_t)e * d * f;
  const bf16* woe = wo + (size_t)e * f * d;
  const bf16* bie = bi == nullptr ? nullptr : bi + (size_t)e * f;
  const bf16* boe = bo == nullptr ? nullptr : bo + (size_t)e * d;
  const int dv = d / 8;           // 16-byte vectors per row of x / wo
  const int n_tiles = d / 8;      // n8 tiles of the output
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // the x tile, once; rows past the capacity are zeros
  for (int i = tid; i < BM * dv; i += THREADS) {
    const int r = i / dv, c = (i % dv) * 8;
    uint4 v = zero;
    if (c0 + r < cap)
      v = *reinterpret_cast<const uint4*>(xe + (size_t)(c0 + r) * d + c);
    *reinterpret_cast<uint4*>(x_s + r * xs + c) = v;
  }

  float acc[MT][NTW][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;

  for (int f0 = 0; f0 < f; f0 += BF) {
    __syncthreads();  // x_s written; the last chunk's products are done
    // wi[:, f0 : f0 + BF] (columns past F are zeros)
    for (int i = tid; i < d * BV; i += THREADS) {
      const int r = i / BV, c = (i % BV) * 8;
      uint4 v = zero;
      if (f0 + c < f)
        v = *reinterpret_cast<const uint4*>(wie + (size_t)r * f + f0 + c);
      *reinterpret_cast<uint4*>(w_s + r * WIS + c) = v;
    }
    __syncthreads();

    // h = gelu(x . wi + bi) for this chunk, into shared memory as bf16
#pragma unroll
    for (int i = 0; i < C::TPW; ++i) {
      const int t = warp + WARPS * i;
      const int mt = t / (BF / 8), nt = t % (BF / 8);
      float hacc[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* arow = x_s + (mt * 16 + (lane & 15)) * xs + (lane >> 4) * 8;
      const bf16* brow = w_s + (lane & 15) * WIS + nt * 8;
      for (int kk = 0; kk < d / 16; ++kk) {
        uint32_t a[4], b0, b1;
        ldmatrix_x4(a, arow + kk * 16);
        ldmatrix_x2_trans(b0, b1, brow + kk * 16 * WIS);
        mma(hacc, a, b0, b1);
      }
      const int col = nt * 8 + tg * 2;  // column within the chunk
      float blo = 0.f, bhi = 0.f;
      if (bie != nullptr && f0 + col < f) {
        blo = __bfloat162float(bie[f0 + col]);
        bhi = __bfloat162float(bie[f0 + col + 1]);
      }
      const int r0 = mt * 16 + g;
      *reinterpret_cast<uint32_t*>(h_s + r0 * HS + col) =
          pack(gelu_tanh(hacc[0] + blo), gelu_tanh(hacc[1] + bhi));
      *reinterpret_cast<uint32_t*>(h_s + (r0 + 8) * HS + col) =
          pack(gelu_tanh(hacc[2] + blo), gelu_tanh(hacc[3] + bhi));
    }
    __syncthreads();  // h written; every warp is done with wi's chunk

    // wo[f0 : f0 + BF, :] (rows past F are zeros)
    for (int i = tid; i < BF * dv; i += THREADS) {
      const int r = i / dv, c = (i % dv) * 8;
      uint4 v = zero;
      if (f0 + r < f)
        v = *reinterpret_cast<const uint4*>(woe + (size_t)(f0 + r) * d + c);
      *reinterpret_cast<uint4*>(w_s + r * wos + c) = v;
    }
    __syncthreads();

    // acc += h . wo[f0 : f0 + BF, :]; this warp's output column tiles are
    // the pairs (2 pp, 2 pp + 1) with pp = p WARPS + warp
#pragma unroll
    for (int kk = 0; kk < BF / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ldmatrix_x4(a[m], h_s + (m * 16 + (lane & 15)) * HS + kk * 16 +
                              (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < NTW / 2; ++p) {
        const int pp = p * WARPS + warp;
        if (2 * pp < n_tiles) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, w_s + (kk * 16 + (lane & 15)) * wos + pp * 16 +
                                   (lane >> 4) * 8);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma(acc[m][2 * p], a[m], b[0], b[1]);
            mma(acc[m][2 * p + 1], a[m], b[2], b[3]);
          }
        }
      }
    }
  }

  // out = acc + bo, rows below the capacity only
  bf16* oe = out + (size_t)e * cap * d;
#pragma unroll
  for (int p = 0; p < NTW / 2; ++p) {
    const int pp = p * WARPS + warp;
    if (2 * pp >= n_tiles) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = (2 * pp + half) * 8 + tg * 2;
      float blo = 0.f, bhi = 0.f;
      if (boe != nullptr) {
        blo = __bfloat162float(boe[col]);
        bhi = __bfloat162float(boe[col + 1]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int n = 2 * p + half;
        const int r0 = c0 + m * 16 + g;
        if (r0 < cap)
          *reinterpret_cast<uint32_t*>(oe + (size_t)r0 * d + col) =
              pack(acc[m][n][0] + blo, acc[m][n][1] + bhi);
        if (r0 + 8 < cap)
          *reinterpret_cast<uint32_t*>(oe + (size_t)(r0 + 8) * d + col) =
              pack(acc[m][n][2] + blo, acc[m][n][3] + bhi);
      }
    }
  }
}

template <int MT, int NTW, int BF>
cudaError_t launch(const void* x, const void* wi, const void* wo,
                   const void* bi, const void* bo, void* out, int experts,
                   int cap, int d, int f, cudaStream_t stream) {
  using C = Cfg<MT, NTW, BF>;
  const size_t smem = C::smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      expert_ffn_tc<MT, NTW, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((cap + C::BM - 1) / C::BM, experts);
  expert_ffn_tc<MT, NTW, BF><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wi),
      static_cast<const bf16*>(wo), static_cast<const bf16*>(bi),
      static_cast<const bf16*>(bo), static_cast<bf16*>(out), cap, d, f);
  return cudaGetLastError();
}

// the capacity rows per block at model width d (0: d not taken)
int rows(int d) {
  if (d <= 256) return Cfg<4, 4, 32>::BM;
  if (d <= 512) return Cfg<2, 8, 32>::BM;
  if (d <= D_MAX) return Cfg<1, 16, 64>::BM;
  return 0;
}

cudaError_t launch_for(int d, const void* x, const void* wi, const void* wo,
                       const void* bi, const void* bo, void* out, int experts,
                       int cap, int f, cudaStream_t s) {
  if (d <= 256) return launch<4, 4, 32>(x, wi, wo, bi, bo, out, experts, cap,
                                        d, f, s);
  if (d <= 512) return launch<2, 8, 32>(x, wi, wo, bi, bo, out, experts, cap,
                                        d, f, s);
  if (d <= D_MAX) return launch<1, 16, 64>(x, wi, wo, bi, bo, out, experts,
                                           cap, d, f, s);
  return cudaErrorInvalidValue;
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
// and out 16-byte aligned). bi / bo may be null. D and F multiples of 16,
// D <= 1024. Returns the cudaError_t of the launch (0 on success).
// Launches on `stream`, allocates nothing, does not sync.
int pdt_expert_ffn(const void* x, const void* wi, const void* wo,
                   const void* bi, const void* bo, void* out, int experts,
                   int cap, int d, int f, int dtype, void* stream) {
  if (experts <= 0 || cap <= 0 || d <= 0 || f <= 0 || d % 16 != 0 ||
      f % 16 != 0 || d > D_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)f32::launch(x, wi, wo, bi, bo, out, experts, cap, d, f, s);
  if (dtype == 1)
    return (int)tc::launch_for(d, x, wi, wo, bi, bo, out, experts, cap, f, s);
  return (int)cudaErrorInvalidValue;
}

// capacity rows per block of the kernel for (d, dtype); 0 if not taken
int pdt_expert_ffn_rows(int d, int dtype) {
  if (d <= 0 || d % 16 != 0 || d > D_MAX) return 0;
  return dtype == 1 ? tc::rows(d) : f32::BM;
}

const char* pdt_expert_ffn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
