// Griffin RG-LRU scan for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/rglru.py::_kernel (Pallas; grid
// (B, feature block, time chunk) with the time axis run in order and the
// state h carried in VMEM scratch across time chunks).
//
// Computes, per batch row b and feature lane d, with the gates fused:
//   log a_t = -c softplus(a_log[d]) sigmoid(gate_a_t)
//   a_t     = exp(log a_t)
//   beta_t  = sqrt(max(1 - exp(2 log a_t), 1e-12))
//   h_t     = a_t h_{t-1} + beta_t sigmoid(gate_x_t) x_t,   h_{-1} = h0 or 0
//   y_t     = h_t
// Inputs: x, gate_a, gate_x [B,S,D] in one dtype, float or bf16 (computed in
// fp32), a_log [D] fp32, h0 [B,D] fp32 or null. Outputs:
// y [B,S,D] in x's dtype, rounded once, and h_final [B,D] fp32.
//
// What bounds it on an H100: bytes. x, gate_a and gate_x are read once and
// y written once (67 MB at [1,2048,4096] bf16, 0.020 ms at 3.35 TB/s); the
// arithmetic is a few tens of FLOP per lane and step, far below the
// ~295 FLOP/byte ridge. Design (simple and right first):
//   * the time axis is sequential and CUDA blocks run in no order, so the
//     time loop lives inside the thread: thread (b, d) walks all S steps
//     with h in a register. Blocks of NT = 128 lanes along d, so each time
//     row is read and written coalesced; ragged D is masked (d >= D exits);
//   * softplus(a_log[d]) is hoisted out of the loop;
//   * the loads do not depend on h, so time is unrolled by U = 16 and the
//     next U rows are loaded into registers before the current rows' chain
//     of FMAs runs: several rows of loads stay in flight while h advances;
//   * accurate expf/log1pf/sqrtf (no fast math), fp32 throughout.
// Known cost: only B*D threads (4096 at the recurrentgemma-9b prefill shape,
// 32 CTAs on 132 SMs), each walking S dependent steps; splitting time
// across CTAs (a chunk-local pass, then a carry pass) is later work.
//
// Entry point: rglru_fwd (plain C, loaded with ctypes). It launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;   // feature lanes per CTA
constexpr int U = 16;     // time rows per unrolled block

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// log(1 + exp(v)) without overflow, as jax.nn.softplus computes it
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

template <typename T>
__global__ void __launch_bounds__(NT) rglru_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ a_log,
    const T* __restrict__ ga, const T* __restrict__ gx,
    const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hT,
    int S, int D, long long x_sb, long long x_ss, long long ga_sb,
    long long ga_ss, long long gx_sb, long long gx_ss, long long y_sb,
    long long y_ss, float c) {
  const int d = blockIdx.x * NT + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const T* xp = x + b * x_sb + d;
  const T* ap = ga + b * ga_sb + d;
  const T* gp = gx + b * gx_sb + d;
  T* yp = y + b * y_sb + d;
  const float k = -c * softplus(a_log[d]);
  float h = h0 != nullptr ? h0[static_cast<long long>(b) * D + d] : 0.f;

  float xr[U], ar[U], gr[U];   // the block of rows in flight, as loaded
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in = u < S;
    xr[u] = in ? to_f(xp[u * x_ss]) : 0.f;
    ar[u] = in ? to_f(ap[u * ga_ss]) : 0.f;
    gr[u] = in ? to_f(gp[u * gx_ss]) : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float log_a = k * sigmoid(ar[u]);
      av[u] = expf(log_a);
      const float beta = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f));
      bv[u] = beta * sigmoid(gr[u]) * xr[u];
    }
    // issue the next block's loads before this block's chain runs
    const int t1 = t0 + U;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = t1 + u < S;
      const long long t = t1 + u;
      xr[u] = in ? to_f(xp[t * x_ss]) : 0.f;
      ar[u] = in ? to_f(ap[t * ga_ss]) : 0.f;
      gr[u] = in ? to_f(gp[t * gx_ss]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        h = av[u] * h + bv[u];
        yp[static_cast<long long>(t0 + u) * y_ss] = from_f<T>(h);
      }
    }
  }
  hT[static_cast<long long>(b) * D + d] = h;
}

template <typename T>
cudaError_t launch(const void* x, const void* a_log, const void* ga,
                   const void* gx, const void* h0, void* y, void* hT, int B,
                   int S, int D, const long long* s, float c,
                   cudaStream_t stream) {
  dim3 grid((D + NT - 1) / NT, B);
  rglru_fwd_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a_log),
      static_cast<const T*>(ga), static_cast<const T*>(gx),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(hT), S, D, s[0], s[1], s[2], s[3], s[4], s[5],
      s[6], s[7], c);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, gate_a, gate_x and y): 0 = float32, 1 = bfloat16. a_log,
// h0 and h_final are float32 and contiguous; h0 may be null. Strides are in
// elements (batch, time); the last dimension has a unit stride.
extern "C" int rglru_fwd(
    const void* x, const void* a_log, const void* gate_a, const void* gate_x,
    const void* h0, void* y, void* hT, int dtype, int B, int S, int D,
    long long x_sb, long long x_ss, long long ga_sb, long long ga_ss,
    long long gx_sb, long long gx_ss, long long y_sb, long long y_ss,
    float c, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[8] = {x_sb, x_ss, ga_sb, ga_ss, gx_sb, gx_ss, y_sb, y_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, a_log, gate_a, gate_x, h0, y, hT, B, S, D, st, c, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, a_log, gate_a, gate_x, h0, y, hT, B, S, D,
                                st, c, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
