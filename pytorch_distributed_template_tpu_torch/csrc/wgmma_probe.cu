// One-tile probes of the wgmma operand layouts that flash_fwd.cu and
// expert_ffn.cu use, for the on-card tests: C [64][N] f32 = A [64][K] .
// B [K][N], both bf16, through the same TMA boxes, shared-memory
// descriptors and instruction wrappers (hopper.cuh) as the kernels, so a
// wrong descriptor shows up here, on one tile, against torch.matmul.
//
// Probes (N, K, swizzle bytes, B layout, A source):
//   0: 128, 128, 128, K-major,  shared     scores at D 128 (two K atoms)
//   1: 128,  64, 128, K-major,  shared     scores at D 64
//   2: 128,  32,  64, K-major,  shared     scores at D 32
//   3: 128,  64, 128, MN-major, shared     expert FFN k-step (two N atoms)
//   4: 128, 128, 128, MN-major, registers  P.V at D 128
//   5:  64, 128, 128, MN-major, registers  P.V at D 64
//   6:  32, 128,  64, MN-major, registers  P.V at D 32
// A is given as [64][K]; B as [N][K] when K-major, [K][N] when MN-major.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libwgmma_probe.so wgmma_probe.cu -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

template <int N, int K>
constexpr size_t probe_smem() {
  return 1024 + (size_t)64 * K * 2 + (size_t)K * N * 2 + 64;
}

template <int N, int K, int SW, int B_MN, int RS>
__global__ void __launch_bounds__(128)
    wgmma_probe(const __grid_constant__ CUtensorMap a_map,
                const __grid_constant__ CUtensorMap b_map,
                const bf16* __restrict__ a, float* __restrict__ c) {
  constexpr int ATOM = SW / 2;  // bf16 columns per swizzle atom
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  bf16* a_s = reinterpret_cast<bf16*>(base);  // K / ATOM boxes [64][ATOM]
  bf16* b_s = a_s + 64 * K;                   // boxes of B
  uint64_t* bar = reinterpret_cast<uint64_t*>(b_s + K * N);
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32, tg = lane & 3;

  if (t == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
    mbar_expect_tx(bar, (RS ? 0u : 64u * K * 2) + (uint32_t)K * N * 2);
    if (!RS)
      for (int x = 0; x < K / ATOM; ++x)
        tma_load_2d(a_s + x * 64 * ATOM, &a_map, bar, x * ATOM, 0);
    if (B_MN)
      for (int x = 0; x < N / ATOM; ++x)
        tma_load_2d(b_s + x * K * ATOM, &b_map, bar, x * ATOM, 0);
    else
      for (int x = 0; x < K / ATOM; ++x)
        tma_load_2d(b_s + x * N * ATOM, &b_map, bar, x * ATOM, 0);
  }
  __syncthreads();
  mbar_wait(bar, 0);

  const int r0 = warp * 16 + (lane >> 2);
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  uint32_t af[K / 16][4];
  if constexpr (RS) {
    // A fragments straight from device memory in the RS layout
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      const bf16* p = a + (size_t)r0 * K + kk * 16 + tg * 2;
      af[kk][0] = *reinterpret_cast<const uint32_t*>(p);
      af[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * K);
      af[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      af[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * K + 8);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const int x = kk / (ATOM / 16);
    const int off = (kk % (ATOM / 16)) * 16;
    const uint64_t db =
        B_MN ? desc_mn_major<SW>(b_s + kk * 16 * ATOM, K * ATOM * 2)
             : desc_k_major<SW>(b_s + x * N * ATOM + off);
    if constexpr (RS)
      wgmma_rs<N, B_MN>(d, af[kk], db, 1);
    else
      wgmma_ss<N, B_MN>(d, desc_k_major<SW>(a_s + x * 64 * ATOM + off), db,
                        1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  if constexpr (RS) {
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) fence_regs(af[kk]);
  }

#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = j * 8 + tg * 2;
    c[r0 * N + col] = d[4 * j];
    c[r0 * N + col + 1] = d[4 * j + 1];
    c[(r0 + 8) * N + col] = d[4 * j + 2];
    c[(r0 + 8) * N + col + 1] = d[4 * j + 3];
  }
}

// a 2-D map over a row-major [rows][cols] bf16 array, boxes of
// [rows][SW / 2]
bool map_2d(CUtensorMap* map, const void* p, int rows, int cols, int sw) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {(uint32_t)sw / 2, (uint32_t)rows};
  return encode_map(map, p, 2, dims, strides, box, sw);
}

template <int N, int K, int SW, int B_MN, int RS>
cudaError_t run(const void* a, const void* b, float* c, cudaStream_t s) {
  CUtensorMap a_map, b_map;
  if (!map_2d(&a_map, a, 64, K, SW) ||
      !(B_MN ? map_2d(&b_map, b, K, N, SW) : map_2d(&b_map, b, N, K, SW)))
    return cudaErrorInvalidValue;
  constexpr size_t smem = probe_smem<N, K>();
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_probe<N, K, SW, B_MN, RS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  wgmma_probe<N, K, SW, B_MN, RS><<<1, 128, smem, s>>>(
      a_map, b_map, static_cast<const bf16*>(a), c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// probe `id` (see the table above) on `stream`; a and b 16-byte aligned.
// Returns the cudaError_t of the launch.
int pdt_wgmma_probe(int id, const void* a, const void* b, float* c,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (id) {
    case 0: return (int)run<128, 128, 128, 0, 0>(a, b, c, s);
    case 1: return (int)run<128, 64, 128, 0, 0>(a, b, c, s);
    case 2: return (int)run<128, 32, 64, 0, 0>(a, b, c, s);
    case 3: return (int)run<128, 64, 128, 1, 0>(a, b, c, s);
    case 4: return (int)run<128, 128, 128, 1, 1>(a, b, c, s);
    case 5: return (int)run<64, 128, 128, 1, 1>(a, b, c, s);
    case 6: return (int)run<32, 128, 64, 1, 1>(a, b, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* pdt_wgmma_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
