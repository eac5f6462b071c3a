// One warpgroup, TMA-loaded 128-byte-swizzled tiles, one wgmma of each form
// the port uses: SS (both operands K-major in shared memory) and RS (A in
// registers, B MN-major in shared memory, descriptor strides passed in).
// Driven by tools/sm90_probe.py; a first chip call for a new wgmma kernel.
#include "../src/repro_torch/kernels/csrc/sm90.cuh"

using namespace sm90;

// D[64x64] = A[64x64] . B[64x64]^T, A and B row-major (K contiguous).
__global__ void probe_ss(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tb, float* out) {
  extern __shared__ uint8_t raw[];
  const uint32_t sa = (smem_u32(raw) + 1023u) & ~1023u;
  const uint32_t sb = sa + 64 * 128;
  const uint32_t bar = sb + 64 * 128;
  if (threadIdx.x == 0) { mbar_init(bar, 1); fence_barrier_init(); }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, 2 * 64 * 128);
    tma_load_4d(sa, &ta, bar, 0, 0, 0, 0);
    tma_load_4d(sb, &tb, bar, 0, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  float d[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n64(d, desc_sw128(sa + 32 * kk, 16, 1024), desc_sw128(sb + 32 * kk, 16, 1024), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = 16 * warp + g + 8 * ((i >> 1) & 1), col = 8 * (i / 4) + 2 * t + (i & 1);
    out[row * 64 + col] = d[i];
  }
}

// D[64x128] = P[64x64] . V[64x128]; P from registers, V rows = keys (MN-major).
__global__ void probe_rs(const __nv_bfloat16* p, const __grid_constant__ CUtensorMap tv,
                         float* out, int lbo, int sbo) {
  extern __shared__ uint8_t raw[];
  const uint32_t sv = (smem_u32(raw) + 1023u) & ~1023u;
  const uint32_t bar = sv + 2 * 64 * 128;
  if (threadIdx.x == 0) { mbar_init(bar, 1); fence_barrier_init(); }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, 2 * 64 * 128);
    tma_load_4d(sv, &tv, bar, 0, 0, 0, 0);
    tma_load_4d(sv + 64 * 128, &tv, bar, 64, 0, 0, 0);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  uint32_t a[16];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 16 * warp + g + 8 * (r & 1), col = 16 * kk + 2 * t + 8 * (r >> 1);
      a[4 * kk + r] = pack_bf16(__bfloat162float(p[row * 64 + col]),
                                __bfloat162float(p[row * 64 + col + 1]));
    }
  mbar_wait(bar, 0);
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_n128(d, &a[4 * kk], desc_sw128(sv + kk * 16 * 128, lbo, sbo), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int row = 16 * warp + g + 8 * ((i >> 1) & 1), col = 8 * (i / 4) + 2 * t + (i & 1);
    out[row * 128 + col] = d[i];
  }
}

extern "C" int run_ss(const void* a, const void* b, float* out) {
  CUtensorMap ta, tb;
  int r = encode_bf16_4d(&ta, a, 64, 1, 64, 1, 64, 64, 64 * 64, 64);
  if (r) return 10000 + r;
  r = encode_bf16_4d(&tb, b, 64, 1, 64, 1, 64, 64, 64 * 64, 64);
  if (r) return 10000 + r;
  cudaFuncSetAttribute(probe_ss, cudaFuncAttributeMaxDynamicSharedMemorySize, 20000);
  probe_ss<<<1, 128, 20000>>>(ta, tb, out);
  cudaError_t e = cudaGetLastError();
  if (e) return e;
  return cudaDeviceSynchronize();
}

extern "C" int run_rs(const void* p, const void* v, float* out, int lbo, int sbo) {
  CUtensorMap tv;
  int r = encode_bf16_4d(&tv, v, 128, 1, 64, 1, 128, 128, 64 * 128, 64);
  if (r) return 10000 + r;
  cudaFuncSetAttribute(probe_rs, cudaFuncAttributeMaxDynamicSharedMemorySize, 20000);
  probe_rs<<<1, 128, 20000>>>(static_cast<const __nv_bfloat16*>(p), tv, out, lbo, sbo);
  cudaError_t e = cudaGetLastError();
  if (e) return e;
  return cudaDeviceSynchronize();
}
