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
// ~295 FLOP/byte ridge.
//
// Design: the recurrence is linear, so a chunk of steps composes into one
// pair (A = prod a_t, h = the chunk's state from h = 0), and time splits
// across CTAs exactly. The time axis is cut into chunks of Tc steps (the
// wrapper's Tc = 32 gives B * ceil(D/128) * ceil(S/Tc) = 2048 CTAs of 128
// lanes at [1,2048,4096], some 15 per SM). One kernel,
// rglru_fwd_kernel, one pass with a decoupled look-back:
//   1. a CTA takes a ticket (atomicAdd), which names its (chunk, b, lane
//      block) in chunk order; it computes its chunk's gates once, keeps
//      (a_t, b_t) in shared memory (Tc x 128 x 8 bytes) and runs the chunk
//      from h = 0 to its carry (A, h);
//   2. the first chunk starts from h0 (or 0); every other publishes its
//      carry under a flag, then walks back over the chunks before it, 32
//      flags at a time, folding their carries until it meets one whose
//      state after it is published, and then publishes its own state after
//      it. Every chunk it waits on holds a smaller ticket, so it already
//      runs and the wait cannot deadlock;
//   3. it reruns the chunk from that state out of shared memory and writes
//      y; the last chunk writes h_final.
// x and the gates are read once and the gates computed once. One thread per
// (b, lane, chunk) keeps its h in a register; blocks of 128 lanes along d,
// so a time row is read and written coalesced; ragged D is masked;
// softplus(a_log[d]) is hoisted out of the loop; time is unrolled by U with
// the next U rows' loads issued before the current rows' gates and chain
// run; accurate expf/log1pf/sqrtf (no fast math), fp32 throughout. The
// scratch (zeroed ticket and flags, carries, states after each chunk; about
// 3.2 MB at the served shape) comes from the wrapper. Known cost: a chunk
// waits on the chunks before it, so the last ones start their rerun only
// once the states have propagated, and the flags are polled from L2.
//
// Entry point: rglru_fwd (plain C, loaded with ctypes). It launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;        // feature lanes per CTA
constexpr int U = 8;           // time rows per unrolled block
constexpr int MIN_CTAS = 8;    // resident CTAs per SM the registers allow
constexpr int MAX_TC = 64;     // most steps per chunk (shared memory)

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

struct Rows {
  long long x_ss, ga_ss, gx_ss, y_ss;   // time strides, in elements
};

// log a_t and b_t of one step, the reference's formulas op for op
__device__ __forceinline__ void gate(float k, float xa, float ga, float gx, float& a, float& bx) {
  const float log_a = k * sigmoid(ga);
  a = expf(log_a);
  const float beta = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f));
  bx = beta * sigmoid(gx) * xa;
}

// Flags of a (b, chunk, lane block): 0 nothing yet, 1 the chunk's own carry
// (prod a, h from 0) is published, 2 the state after the chunk is.
constexpr int AGGREGATE = 1, INCLUSIVE = 2;

// Every thread's global writes are visible before thread 0 raises the flag.
__device__ __forceinline__ void publish(int* flag, int value) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicExch(flag, value);
}

// The time-split scan: one CTA per (b, 128-lane block, chunk of Tc steps),
// taken in ticket order, so every chunk a CTA waits on belongs to a CTA
// that already runs.
template <typename T>
__global__ void __launch_bounds__(NT, MIN_CTAS)
rglru_fwd_kernel(const T* __restrict__ x, const float* __restrict__ a_log,
                 const T* __restrict__ ga, const T* __restrict__ gx,
                 const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hT,
                 float2* __restrict__ agg, float* __restrict__ incl, int* flags, int* ticket,
                 int B, int S, int D, int Tc, long long x_sb, long long ga_sb,
                 long long gx_sb, long long y_sb, Rows st, float c) {
  extern __shared__ float2 sab[];   // [Tc][NT]: (a_t, b_t) of the chunk
  __shared__ int s_work, s_count, s_done;
  const int tid = threadIdx.x;
  if (tid == 0) s_work = atomicAdd(ticket, 1);
  __syncthreads();
  const int lanes = (D + NT - 1) / NT;
  const int chunks = (S + Tc - 1) / Tc;
  const int ch = s_work / (B * lanes);
  const int b = (s_work / lanes) % B;
  const int lb = s_work % lanes;
  const int d = lb * NT + tid;
  const bool on = d < D;
  const int t0 = ch * Tc, n = min(S, t0 + Tc) - t0;

  // 1. the chunk's gates into shared memory, and its carry from h = 0
  float A = 1.f, h = 0.f;
  if (on) {
    const float k = -c * softplus(a_log[d]);
    const T* xp = x + b * x_sb + d + t0 * st.x_ss;
    const T* ap = ga + b * ga_sb + d + t0 * st.ga_ss;
    const T* gp = gx + b * gx_sb + d + t0 * st.gx_ss;
    float xr[U], ar[U], gr[U];   // the block of rows in flight, as loaded
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = u < n;
      xr[u] = in ? to_f(xp[u * st.x_ss]) : 0.f;
      ar[u] = in ? to_f(ap[u * st.ga_ss]) : 0.f;
      gr[u] = in ? to_f(gp[u * st.gx_ss]) : 0.f;
    }
    for (int tb = 0; tb < n; tb += U) {
      float av[U], bv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) gate(k, xr[u], ar[u], gr[u], av[u], bv[u]);
      // issue the next block's loads before this block's chain runs
      xp += U * st.x_ss;
      ap += U * st.ga_ss;
      gp += U * st.gx_ss;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool in = tb + U + u < n;
        xr[u] = in ? to_f(xp[u * st.x_ss]) : 0.f;
        ar[u] = in ? to_f(ap[u * st.ga_ss]) : 0.f;
        gr[u] = in ? to_f(gp[u * st.gx_ss]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (tb + u < n) {
          sab[(tb + u) * NT + tid] = make_float2(av[u], bv[u]);
          h = av[u] * h + bv[u];
          A *= av[u];
        }
      }
    }
  }

  // 2. the state entering the chunk: h0 for the first; else look back over
  //    the chunks before it, folding their carries until one whose state
  //    after it is published
  const long long row = static_cast<long long>(b) * chunks;   // + chunk
  int* fl = flags + row * lanes + lb;                           // + chunk * lanes
  float h_in = (h0 != nullptr && on) ? h0[static_cast<long long>(b) * D + d] : 0.f;
  if (ch > 0) {
    if (on) agg[(row + ch) * D + d] = make_float2(A, h);
    publish(fl + ch * lanes, AGGREGATE);
    float P = 1.f, Hh = 0.f;    // h_in = P (state after chunk j) + Hh
    int j = ch - 1;
    while (true) {
      if (tid < 32) {           // flags of chunks j, j-1, ..., j-31
        const int jj = j - tid;
        int f = INCLUSIVE;      // before the first chunk: h0, as good as published
        if (jj >= 0) f = *reinterpret_cast<volatile int*>(fl + jj * lanes);
        const unsigned inc = __ballot_sync(0xffffffffu, f == INCLUSIVE);
        const unsigned none = __ballot_sync(0xffffffffu, f == 0);
        const int first_inc = inc ? __ffs(inc) - 1 : 32;
        const int first_none = none ? __ffs(none) - 1 : 32;
        if (tid == 0) {
          s_done = first_inc < first_none;
          s_count = min(first_inc, first_none);   // carries to fold before it
        }
      }
      __syncthreads();
      const int cnt = s_count, done = s_done;
      __threadfence();
      if (on) {
        for (int i = 0; i < cnt; ++i) {
          const float2 ah = __ldcg(agg + (row + j - i) * D + d);
          Hh = P * ah.y + Hh;
          P *= ah.x;
        }
        if (done) {
          const float after = j - cnt >= 0 ? __ldcg(incl + (row + j - cnt) * D + d) : h_in;
          h_in = P * after + Hh;
        }
      }
      j -= cnt;
      __syncthreads();          // s_count and s_done are read
      if (done) break;
      if (cnt == 0) __nanosleep(64);
    }
  }
  if (ch + 1 < chunks) {
    if (on) incl[(row + ch) * D + d] = A * h_in + h;
    publish(fl + ch * lanes, INCLUSIVE);
  }

  // 3. rerun the chunk from h_in out of shared memory, writing y
  if (!on) return;
  h = h_in;
  T* yp = y + b * y_sb + d + t0 * st.y_ss;
  for (int t = 0; t < n; ++t) {
    const float2 ab = sab[t * NT + tid];
    h = ab.x * h + ab.y;
    yp[t * st.y_ss] = from_f<T>(h);
  }
  if (ch + 1 == chunks) hT[static_cast<long long>(b) * D + d] = h;
}

template <typename T>
cudaError_t launch(const void* x, const void* a_log, const void* ga, const void* gx,
                   const void* h0, void* y, void* hT, int* sync, float* carries, int B, int S,
                   int D, int Tc, const long long* s, float c, cudaStream_t stream) {
  const long long chunks = (S + Tc - 1) / Tc;
  const long long ctas = B * ((D + NT - 1) / NT) * chunks;
  // the shared-memory opt-in for the largest chunk, once per device
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(rglru_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_TC * NT * static_cast<int>(sizeof(float2)));
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  float2* agg = reinterpret_cast<float2*>(carries);
  float* incl = carries + 2 * B * chunks * D;
  const Rows st{s[1], s[3], s[5], s[7]};
  const int smem = Tc * NT * static_cast<int>(sizeof(float2));
  rglru_fwd_kernel<T><<<static_cast<unsigned>(ctas), NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a_log), static_cast<const T*>(ga),
      static_cast<const T*>(gx), static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(hT), agg, incl, sync + 1, sync, B, S, D, Tc, s[0], s[2], s[4], s[6],
      st, c);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, gate_a, gate_x and y): 0 = float32, 1 = bfloat16. a_log,
// h0 and h_final are float32 and contiguous; h0 may be null. Strides are in
// elements (batch, time); the last dimension has a unit stride. Time is cut
// into chunks of T steps (1 .. 64). Scratch from the caller: `sync` holds
// 1 + B * ceil(D/128) * ceil(S/T) ints, zeroed (the ticket, then the
// flags); `carries` holds 3 * B * ceil(S/T) * D floats, on 8 bytes.
extern "C" int rglru_fwd(
    const void* x, const void* a_log, const void* gate_a, const void* gate_x,
    const void* h0, void* y, void* hT, void* sync, void* carries, int dtype, int B,
    int S, int D, int T, long long x_sb, long long x_ss, long long ga_sb, long long ga_ss,
    long long gx_sb, long long gx_ss, long long y_sb, long long y_ss,
    float c, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || T <= 0 || T > MAX_TC)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ctas = B * ((D + NT - 1) / NT) * static_cast<long long>((S + T - 1) / T);
  if (ctas >= (1LL << 31) || sync == nullptr || carries == nullptr ||
      reinterpret_cast<uintptr_t>(carries) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[8] = {x_sb, x_ss, ga_sb, ga_ss, gx_sb, gx_ss, y_sb, y_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, a_log, gate_a, gate_x, h0, y, hT, static_cast<int*>(sync),
                        static_cast<float*>(carries), B, S, D, T, st, c, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, a_log, gate_a, gate_x, h0, y, hT, static_cast<int*>(sync),
                                static_cast<float*>(carries), B, S, D, T, st, c, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
