// Flash-attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (Pallas; grid (B, H, q-blocks, kv-blocks) with the kv dimension run in
// order and the online-softmax state in VMEM scratch).
//
// Computes softmax(q.k^T * scale) . v with an fp32 online softmax:
//   q [B,Sq,H,hd], k/v [B,Sk,Kh,hd] -> o [B,Sq,H,hd] in q's dtype;
//   GQA (kv head h / (H/Kh)); queries right-aligned in the keys
//   (q_off = Sk - Sq); causal and sliding-window masks; tanh softcap.
//   Masked scores take the finite NEG = -1e30 of the TPU kernel, so a row
//   that one tile masks completely gets exp(NEG - NEG) = 1 there and is
//   wiped by the next tile's alpha = 0, exactly as in the reference.
//   Keys past Sk (the ragged edge of the last tile) contribute nothing.
//
// What bounds it on an H100: at long prefill the work is compute,
// 4*B*H*Sq*Sk*hd FLOP (about half of it under the causal mask) against the
// bytes of q, k, v and o read or written once, far above the card's
// ~295 FLOP/byte ridge. The tensor cores (wgmma/mma.sync) would be the way
// to that rate; this first kernel is the simple correct design instead:
//   * one CTA of 256 threads per (b, h, 64-query tile); a loop over kv
//     tiles inside the CTA replaces the sequential kv grid dimension;
//   * the q tile stays in shared memory for the whole loop, k and v tiles
//     are staged there per step, converted to fp32 on load; strides are
//     passed in, so the [B,S,H,hd] layout is read without transposes;
//   * scores and p.v are fp32 FMA loops out of shared memory (float4 reads,
//     rows padded against bank conflicts); m and l live in registers of the
//     four threads that own a row, acc in registers of the output threads;
//   * kv tiles that the causal/window mask rules out for the whole q tile
//     are never visited, and q tiles run latest-first so the long causal
//     rows start early.
// Known cost: FMA instead of tensor cores, and shared-memory load
// bandwidth in the score loop. Moving to mma/wgmma is later work.
//
// Entry point: flash_attention_fwd (plain C, loaded with ctypes). It
// launches on the given stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int BQ = 64;    // queries per CTA
constexpr int NT = 256;   // threads per CTA

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

template <int HD>
struct Cfg {
  static constexpr int BK = HD >= 128 ? 32 : 64;  // keys per tile
  static constexpr int QS = HD + 4;   // row stride (floats) of the q and k tiles
  static constexpr int VS = HD;       // row stride of the v tile
  static constexpr int SS = BK + 4;   // row stride of the score tile
  // score phase: 16 x 16 threads, rows sy + 16*i, columns sx + 16*j
  static constexpr int S_ROWS = BQ / 16;
  static constexpr int S_COLS = BK / 16;
  // output phase: TXD threads across dims (4 each per float4 chunk), TYR across rows
  static constexpr int TXD = HD / 4 < 16 ? HD / 4 : 16;
  static constexpr int TYR = NT / TXD;
  static constexpr int RM = BQ / TYR;          // rows per thread
  static constexpr int JD = HD / (4 * TXD);    // float4 chunks per thread
  static constexpr int SMEM_FLOATS = BQ * QS + BK * QS + BK * VS + BQ * SS + 2 * BQ;
  static_assert(NT % TXD == 0 && BQ % TYR == 0 && HD % (4 * TXD) == 0, "layout");
  static_assert(BK % 4 == 0, "softmax phase splits a row over 4 threads");
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int Sq, int Sk, int G,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 int64_t o_sb, int64_t o_ss, int64_t o_sh,
                 int causal, int window, float softcap, float scale) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK;
  extern __shared__ float4 smem_f4[];
  float* sQ = reinterpret_cast<float*>(smem_f4);   // [BQ][QS]
  float* sK = sQ + BQ * C::QS;                      // [BK][QS]
  float* sV = sK + BK * C::QS;                      // [BK][VS]
  float* sS = sV + BK * C::VS;                      // [BQ][SS] scores, then p
  float* sAlpha = sS + BQ * C::SS;                  // [BQ]
  float* sL = sAlpha + BQ;                          // [BQ]

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;        // latest q tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;
  const int q_off = Sk - Sq;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + (h / G) * k_sh;
  const T* vb = v + b * v_sb + (h / G) * v_sh;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    const int qi = q0 + r;
    sQ[r * C::QS + d] = qi < Sq ? to_f(qb[qi * q_ss + d]) : 0.f;
  }

  // kv tiles that some query of this tile can see
  const int q_first = q_off + q0;
  const int q_last = q_off + min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  // softmax phase: 4 threads per row, columns ssub + 4*j
  const int srow = tid >> 2, ssub = tid & 3;
  const int qpos = q_off + q0 + srow;
  float m_run = NEG, l_run = 0.f;
  // score phase
  const int sx = tid & 15, sy = tid >> 4;
  // output phase
  const int tx = tid % C::TXD, ty = tid / C::TXD;
  float acc[C::RM][C::JD][4];
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::JD; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();   // q tile written / previous tile's readers done
    for (int i = tid; i < BK * HD; i += NT) {
      const int c = i / HD, d = i % HD;
      const int kj = k0 + c;
      const bool ok = kj < Sk;
      sK[c * C::QS + d] = ok ? to_f(kb[kj * k_ss + d]) : 0.f;
      sV[c * C::VS + d] = ok ? to_f(vb[kj * v_ss + d]) : 0.f;
    }
    __syncthreads();

    // raw scores q.k over the tile
    {
      float s[C::S_ROWS][C::S_COLS];
#pragma unroll
      for (int i = 0; i < C::S_ROWS; ++i)
#pragma unroll
        for (int j = 0; j < C::S_COLS; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        float4 qv[C::S_ROWS], kv[C::S_COLS];
#pragma unroll
        for (int i = 0; i < C::S_ROWS; ++i)
          qv[i] = *reinterpret_cast<const float4*>(&sQ[(sy + 16 * i) * C::QS + d]);
#pragma unroll
        for (int j = 0; j < C::S_COLS; ++j)
          kv[j] = *reinterpret_cast<const float4*>(&sK[(sx + 16 * j) * C::QS + d]);
#pragma unroll
        for (int i = 0; i < C::S_ROWS; ++i)
#pragma unroll
          for (int j = 0; j < C::S_COLS; ++j) {
            float a = s[i][j];
            a = fmaf(qv[i].x, kv[j].x, a);
            a = fmaf(qv[i].y, kv[j].y, a);
            a = fmaf(qv[i].z, kv[j].z, a);
            a = fmaf(qv[i].w, kv[j].w, a);
            s[i][j] = a;
          }
      }
#pragma unroll
      for (int i = 0; i < C::S_ROWS; ++i)
#pragma unroll
        for (int j = 0; j < C::S_COLS; ++j)
          sS[(sy + 16 * i) * C::SS + sx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // online softmax over the tile; scores become p in place
    {
      float* row = sS + srow * C::SS;
      float x[BK / 4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        const int kpos = k0 + ssub + 4 * j;
        float t = row[ssub + 4 * j] * scale;
        if (softcap > 0.f) t = tanhf(t / softcap) * softcap;
        bool keep = kpos < Sk;
        if (causal) keep = keep && qpos >= kpos;
        if (window > 0) keep = keep && (qpos - kpos) < window;
        t = keep ? t : NEG;
        x[j] = t;
        mx = fmaxf(mx, t);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        const int kpos = k0 + ssub + 4 * j;
        const float p = kpos < Sk ? expf(x[j] - m_new) : 0.f;
        row[ssub + 4 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (ssub == 0) sAlpha[srow] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p . v
#pragma unroll
    for (int i = 0; i < C::RM; ++i) {
      const float a = sAlpha[ty + C::TYR * i];
#pragma unroll
      for (int j = 0; j < C::JD; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[C::RM];
#pragma unroll
      for (int i = 0; i < C::RM; ++i) p[i] = sS[(ty + C::TYR * i) * C::SS + c];
#pragma unroll
      for (int j = 0; j < C::JD; ++j) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&sV[c * C::VS + 4 * tx + 4 * C::TXD * j]);
#pragma unroll
        for (int i = 0; i < C::RM; ++i) {
          acc[i][j][0] = fmaf(p[i], vv.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(p[i], vv.y, acc[i][j][1]);
          acc[i][j][2] = fmaf(p[i], vv.z, acc[i][j][2]);
          acc[i][j][3] = fmaf(p[i], vv.w, acc[i][j][3]);
        }
      }
    }
  }

  if (ssub == 0) sL[srow] = l_run;
  __syncthreads();
  T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < C::RM; ++i) {
    const int r = ty + C::TYR * i;
    const int qi = q0 + r;
    if (qi >= Sq) continue;
    const float denom = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < C::JD; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ob[qi * o_ss + 4 * tx + 4 * C::TXD * j + e] = from_f<T>(acc[i][j][e] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int G,
                   const long long* st, int causal, int window,
                   float softcap, float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  const int smem = C::SMEM_FLOATS * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, G,
      st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11],
      causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Sk, int H, int G, const long long* st,
                        int causal, int window, float softcap, float scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, G, st, causal, window, softcap, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, G, st, causal, window, softcap, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, G, st, causal, window, softcap, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, G, st, causal, window, softcap, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, Sq, Sk, H, G, st, causal, window, softcap, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// dimension of every tensor must have stride 1.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int dtype, int B, int Sq, int Sk, int H, int Kh, int hd,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float softcap, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk < Sq || H <= 0 || Kh <= 0 || H % Kh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  const int G = H / Kh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_hd<float>(hd, q, k, v, o, B, Sq, Sk, H, G, st, causal, window, softcap, scale, s);
  else if (dtype == 1)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Sk, H, G, st, causal, window, softcap, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
