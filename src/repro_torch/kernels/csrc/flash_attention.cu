// Flash attention for Hopper (sm_90a), plain CUDA C++: two forward kernels
// and two backward routes.
//
// The forward replaces the TPU kernel
// src/repro/kernels/flash_attention.py::_kernel (Pallas; grid (B, H,
// q-blocks, kv-blocks) with the kv dimension run in order and the
// online-softmax state in VMEM scratch). Given an lse pointer, either
// forward also writes each row's log-sum-exp m + log(max(l, 1e-30))
// ([B,Sq,H] fp32, as the reference's ops.py::_fwd_blocked_lse) for the
// backward; the served path passes none and runs an instantiation without
// that store.
//
// The backward replaces the reference's XLA-level custom_vjp
// ops.py::_flash_bwd (no Pallas kernel): dq, dk and dv from q, k, v, o,
// do and the saved lse, s and p computed again from q and k. What bounds
// it: 5 products of 2 hd FLOP per visible query-key pair and head, compute
// far above the ridge, so the bf16 tensor cores' 989 TFLOP/s (times
// against the bound in PERF.md). Both routes compute s, p and ds in fp32,
// use no atomics (the dk/dv and the dq kernels each compute s and p, seven
// products' work for five, so every sum has one order) and skip the tiles
// the mask rules out.
//   * Tensor cores (entry flash_attention_bwd_tc; bf16 at head dims 64,
//     128, 192, 256): a delta kernel writes rowsum(do o) and lse log2(e) as
//     [B,H,Sq] scratch, so a tile's 64 values of one head are one bulk
//     copy. flash_bwd_dkdv_tc_kernel: one CTA per (kv head x head split,
//     key tile, b) of a TMA producer warpgroup and two wgmma consumer
//     warpgroups; k and v load once, q, do, lse and delta stream through a
//     two-stage ring; S^T = K.Q^T and dP^T = V.dO^T from shared memory,
//     P^T and dS^T in registers with the queries along the accumulator's
//     columns, rounded to bf16 as the register A operands of dV += P^T.dO
//     and dK += dS^T.Q. At head dim 64/128 each consumer owns 64 of 128
//     keys and holds dk and dv; at 192 (MLA) and 256 dk and dv of 64 keys
//     do not fit one warpgroup's registers, so both consumers share a
//     64-key tile: one computes P^T and holds dv and hands P^T (1 - t^2)
//     scale through shared memory to the other, which forms dS^T and holds
//     dk. At 192, dV += P^T.dO and dQ += dS.K are the forward's
//     m64n192k16 form over three 64-wide column chunks. At GQA/MQA a group's heads are split across
//     CTAs (the second grid dimension; one CTA per key tile would leave 64
//     CTAs at Kh = 1) whose fp32 partials flash_bwd_reduce_kernel sums in
//     split order. flash_bwd_dq_tc_kernel: the forward's shape, one CTA per
//     (head, 128-query tile, b), q and do loaded once, k/v through the
//     ring, dQ += dS.K by wgmma. Both put the tiles with the most work
//     first over every head.
//   * FMA (entry flash_attention_bwd; fp32, and bf16 at head dims 16/32),
//     the first, simple design: the delta kernel, flash_bwd_dkdv_kernel
//     (one CTA per (b, kv head, key tile): dk and dv summed in registers
//     over the G query heads of the group and the query tiles the mask lets
//     see the tile) and flash_bwd_dq_kernel (one CTA per (b, head, query
//     tile)), fp32 FMA loops from shared memory.
//
// Both compute softmax(q.k^T * scale) . v with an fp32 online softmax:
//   q [B,Sq,H,hd], k/v [B,Sk,Kh,hd] -> o [B,Sq,H,hd] in q's dtype;
//   GQA (kv head h / (H/Kh)); queries right-aligned in the keys
//   (q_off = Sk - Sq); causal and sliding-window masks; tanh softcap.
//   Only the masks read q_off: without one, Sq may exceed Sk (q_off < 0, a
//   cross-attention over a shorter encoder output), and every key is
//   visible to every query; the TMA boxes start at q0, never at q_off.
//   Masked scores take the finite NEG = -1e30 of the TPU kernel, so a row
//   that one tile masks completely gets exp(NEG - NEG) = 1 there and is
//   wiped by the next tile's alpha = 0, exactly as in the reference.
//   Keys past Sk (the ragged edge of the last tile) contribute nothing;
//   l is clamped at 1e-30 before the division.
//
// What bounds it on an H100: at long prefill the work is compute,
// 4*B*H*Sq*Sk*hd FLOP (about half of it under the causal mask) against the
// bytes of q, k, v and o read or written once, far above the card's
// ~295 FLOP/byte ridge, so the bf16 tensor cores (989 TFLOP/s) set the
// bound.
//
// flash_fwd_tc_kernel (bf16, head dims 64/128/192/256; entry
// flash_attention_fwd_tc) does both products on the tensor cores:
//   * one CTA of three warpgroups per (b, h, 128-query tile): warpgroup 0
//     is the producer (one thread issues TMA loads, setmaxnreg gives its
//     registers away), warpgroups 1 and 2 are consumers of 64 query rows
//     each, with 240 registers per thread;
//   * the q tile is loaded once; k and v tiles of BK keys (128 at head dim
//     64/128, 64 at 192/256) come through a two-stage ring in shared memory,
//     each stage with full (k, v) and empty mbarriers, so the next tile's
//     loads overlap this tile's products;
//   * S = q.k^T is wgmma m64nBKk16 with both operands in shared memory,
//     summed in fp32 registers; scale, softcap and (only on tiles that
//     the diagonal, the window edge or the ragged Sk edge cut) the masks
//     are applied in registers; row max and row sum are reduced over the
//     four lanes that hold a row, by shuffles, with no shared-memory
//     round trip and no block-wide barrier in the kv loop;
//   * P is rounded to bf16 in registers and O += P.v is wgmma with P as
//     the register A operand and v read MN-major from shared memory
//     (l sums the fp32 p). That moves an output by about 2e-3 relative
//     to the plain version's fp32 P, inside the bf16 limits; holding P as
//     two bf16 terms cut that 25-fold for 35% more time and changed the
//     served model's checks little (PERF.md);
//   * the epilogue divides by max(l, 1e-30), rounds once to bf16 and
//     stores the rows below Sq.
// Inputs come in through TMA tensor maps over the [B,S,H,hd] view, so the
// base must be 16-byte aligned and every stride a multiple of 16 bytes.
//
// flash_fwd_kernel (fp32 at every head dim, bf16 at head dims 16/32;
// entry flash_attention_fwd) is the first, simple design: fp32 FMA loops
// out of shared memory, one CTA of 256 threads per (b, h, 64-query tile),
// k and v converted to fp32 on load. On the tensor cores fp32 would run as
// TF32 (about three decimal digits), so fp32 stays here.
//
// In both, kv tiles that the causal/window mask rules out for the whole q
// tile are never visited, and q tiles run latest-first so the long causal
// rows start early.
//
// Entry points: plain C, loaded with ctypes. They launch on the given
// stream, allocate nothing, do not synchronise, and return
// cudaGetLastError() after the launch (flash_attention_fwd_tc and
// flash_attention_bwd_tc return 10000 + the CUresult when a tensor map
// cannot be encoded).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

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
                 float* __restrict__ lse, int Sq, int Sk, int G,
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

  if (ssub == 0) {
    sL[srow] = l_run;
    // log-sum-exp of the row, as the reference's m + log(max(l, 1e-30))
    if (lse != nullptr && q0 + srow < Sq)
      lse[(static_cast<int64_t>(b) * Sq + q0 + srow) * gridDim.y + h] =
          m_run + logf(fmaxf(l_run, 1e-30f));
  }
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
                   float* lse, int B, int Sq, int Sk, int H, int G,
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
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, G,
      st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11],
      causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int Sq, int Sk, int H, int G, const long long* st,
                        int causal, int window, float softcap, float scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, Sq, Sk, H, G, st, causal, window, softcap, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, Sq, Sk, H, G, st, causal, window, softcap, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, Sq, Sk, H, G, st, causal, window, softcap, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, Sq, Sk, H, G, st, causal, window, softcap, scale, stream);
    case 192: return launch<T, 192>(q, k, v, o, lse, B, Sq, Sk, H, G, st, causal, window, softcap, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, lse, B, Sq, Sk, H, G, st, causal, window, softcap, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 128;          // queries per CTA: 64 per consumer warpgroup
constexpr int NT = 384;          // producer warpgroup + two consumer warpgroups
constexpr int STAGES = 2;        // k/v ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
struct Cfg {
  // keys per tile: at head dim 192 a 128-key ring would take the q tile's
  // 48 KiB plus 4 x 48 KiB, over the 227 KiB a block may have
  static constexpr int BK = HD >= 192 ? 64 : 128;
  static constexpr int CHUNKS = HD / 64;            // 64-wide columns of a row
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;      // one k or one v tile
  static constexpr int TILE_BYTES = Q_BYTES + 2 * STAGES * KV_BYTES;
  // barriers: q, full_k[STAGES], full_v[STAGES], empty[STAGES]
  static constexpr int SMEM = 1024 + TILE_BYTES + 8 * (1 + 3 * STAGES);
  static_assert(TILE_BYTES <= 227 * 1024 - 2048, "q plus the ring must fit");
};

template <int N> struct Wgmma;
template <> struct Wgmma<32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    sm90::wgmma_ss_n32(d, a, b, acc);
  }
};
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    sm90::wgmma_ss_n64(d, a, b, acc);
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t* a, uint64_t b) {
    sm90::wgmma_rs_n64(d, a, b, 1);
  }
};
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    sm90::wgmma_ss_n128(d, a, b, acc);
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t* a, uint64_t b) {
    sm90::wgmma_rs_n128(d, a, b, 1);
  }
};
template <> struct Wgmma<192> {
  static __device__ __forceinline__ void rs(float (&d)[96], const uint32_t* a, uint64_t b) {
    sm90::wgmma_rs_n192(d, a, b, 1);
  }
};
template <> struct Wgmma<256> {
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t* a, uint64_t b) {
    sm90::wgmma_rs_n256(d, a, b, 1);
  }
};

// LSE: also write each row's log-sum-exp (training); the served forward is
// the instantiation without it, so serving runs the same code as before.
template <int HD, bool LSE>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int Sq, int Sk, int G,
                    int64_t o_sb, int64_t o_ss, int64_t o_sh,
                    int causal, int window, float softcap, float scale) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms need 1024-byte alignment
  const uint32_t sQ = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;                // stage s at + s * KV_BYTES
  const uint32_t sV = sK + STAGES * C::KV_BYTES;
  const uint32_t bar_q = sV + STAGES * C::KV_BYTES;
  const uint32_t full_k = bar_q + 8;                  // + 8 s
  const uint32_t full_v = full_k + 8 * STAGES;
  const uint32_t empty = full_v + 8 * STAGES;

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;          // latest q tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;
  const int q_off = Sk - Sq;

  // kv tiles that some query of this tile can see
  const int q_first = q_off + q0;
  const int q_last = q_off + min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  if (tid == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full_k + 8 * s, 1);
      sm90::mbar_init(full_v + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, 2 * 128);   // every consumer thread
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    sm90::setmaxnreg_dec<24>();
    if (tid == 0) {
      const int kvh = h / G;
      sm90::mbar_arrive_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::CHUNKS; ++c)
        sm90::tma_load_4d(sQ + c * BQ * 128, &tm_q, bar_q, 64 * c, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const uint32_t phase = (it / STAGES) & 1;
        const int k0 = k_begin + it * BK;
        sm90::mbar_wait(empty + 8 * s, phase ^ 1);
        sm90::mbar_arrive_expect_tx(full_k + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c)
          sm90::tma_load_4d(sK + s * C::KV_BYTES + c * BK * 128, &tm_k, full_k + 8 * s,
                            64 * c, kvh, k0, b);
        sm90::mbar_arrive_expect_tx(full_v + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c)
          sm90::tma_load_4d(sV + s * C::KV_BYTES + c * BK * 128, &tm_v, full_v + 8 * s,
                            64 * c, kvh, k0, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    sm90::setmaxnreg_inc<240>();
    const int cw = tid / 128 - 1;
    const int warp = (tid / 32) % 4;
    const int lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int row0 = 64 * cw + 16 * warp + g;     // this thread's rows: row0, row0 + 8
    const int qpos0 = q_off + q0 + row0;
    const int wg_qlo = q_off + q0 + 64 * cw;      // the warpgroup's query positions
    const int wg_qhi = wg_qlo + 63;
    const float sl2 = scale * LOG2E;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};   // log2 domain; l per thread

    const uint32_t q_rows = sQ + cw * 64 * 128;
    sm90::mbar_wait(bar_q, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      const uint32_t phase = (it / STAGES) & 1;
      const int k0 = k_begin + it * BK;
      const uint32_t k_tile = sK + s * C::KV_BYTES;
      const uint32_t v_tile = sV + s * C::KV_BYTES;

      // S = q . k^T over this tile, fp32 in registers
      float sc[BK / 2];
      sm90::mbar_wait(full_k + 8 * s, phase);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk / 4, w = kk % 4;
        const uint64_t da = sm90::desc_sw128(q_rows + c * BQ * 128 + 32 * w, 16, 1024);
        const uint64_t db = sm90::desc_sw128(k_tile + c * BK * 128 + 32 * w, 16, 1024);
        Wgmma<BK>::ss(sc, da, db, kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      // scores in the log2 domain: x = s * scale * log2(e), or the softcap's
      if (softcap > 0.f) {
        const float inv_cap = 1.f / softcap;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          sc[i] = tanhf(sc[i] * scale * inv_cap) * softcap * LOG2E;
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] *= sl2;
      }
      // masks only where the tile crosses the diagonal, the window's edge or Sk
      const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > wg_qlo) ||
                          (window > 0 && wg_qhi - k0 >= window);
      if (masked) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int kpos = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
          const int qpos = qpos0 + 8 * ((i >> 1) & 1);
          bool keep = kpos < Sk;
          if (causal) keep = keep && qpos >= kpos;
          if (window > 0) keep = keep && (qpos - kpos) < window;
          sc[i] = keep ? sc[i] : NEG;
        }
      }
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        alpha[r] = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        float p = exp2f(sc[i] - m_run[r]);
        if (masked && k0 + 8 * (i / 4) + 2 * t4 + (i & 1) >= Sk) p = 0.f;
        l_run[r] += p;
        sc[i] = p;
      }
      uint32_t pf[BK / 4];                        // P in bf16, the A operand of P.v
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) pf[i] = sm90::pack_bf16(sc[2 * i], sc[2 * i + 1]);

      sm90::fence_regs(acc);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P . v
      sm90::mbar_wait(full_v + 8 * s, phase);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = sm90::desc_sw128(v_tile + kk * 16 * 128, BK * 128, 1024);
        Wgmma<HD>::rs(acc, &pf[4 * kk], db);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::mbar_arrive(empty + 8 * s);
    }

    // epilogue: o = acc / max(l, 1e-30), one rounding to bf16
    __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int qi = q0 + row0 + 8 * r;
      if (qi >= Sq) continue;
      const float den = fmaxf(l, 1e-30f);
      // log-sum-exp of the row in natural units: m_run is in log2 units
      if (LSE && t4 == 0)
        lse[(static_cast<int64_t>(b) * Sq + qi) * gridDim.y + h] =
            (m_run[r] + log2f(den)) * LN2;
      __nv_bfloat16* orow = ob + qi * o_ss + 2 * t4;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
    }
  }
}

template <int HD, bool LSE>
cudaError_t launch_as(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                      void* o, float* lse, int B, int Sq, int Sk, int H, int G,
                      long long o_sb, long long o_ss, long long o_sh, int causal,
                      int window, float softcap, float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  // the shared-memory opt-in, once per instantiation and device
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_tc_kernel<HD, LSE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_tc_kernel<HD, LSE><<<grid, NT, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, G, o_sb, o_ss, o_sh,
      causal, window, softcap, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   void* o, float* lse, int B, int Sq, int Sk, int H, int G, long long o_sb,
                   long long o_ss, long long o_sh, int causal, int window, float softcap,
                   float scale, cudaStream_t stream) {
  return lse != nullptr
             ? launch_as<HD, true>(tq, tk, tv, o, lse, B, Sq, Sk, H, G, o_sb, o_ss, o_sh,
                                   causal, window, softcap, scale, stream)
             : launch_as<HD, false>(tq, tk, tv, o, lse, B, Sq, Sk, H, G, o_sb, o_ss, o_sh,
                                    causal, window, softcap, scale, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Backward (fp32 FMA): delta, dk/dv and dq kernels
// ---------------------------------------------------------------------------

namespace bwd {

constexpr int NT = 256;   // threads per CTA

// The dynamic shared-memory opt-in of `kernel`, made once per device for
// each `done` array (a static of the calling launcher, one per
// instantiation), not on every call.
template <typename K>
cudaError_t opt_in_smem(K kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

// delta[b, i, h] = sum_d do[b, i, h, d] * o[b, i, h, d] in fp32: one warp
// per row. TR (the tensor-core route) runs the rows over [B, H, Sqp]
// instead and also writes lse2 = lse * log2(e) there, so one head's values
// for a tile of queries are contiguous; rows i >= Sq of the padding get 0.
template <typename T, bool TR>
__global__ void __launch_bounds__(NT)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       const float* __restrict__ lse, float* __restrict__ delta,
                       float* __restrict__ lse2, int B, int Sq, int Sqp, int H, int hd,
                       int64_t o_sb, int64_t o_ss, int64_t o_sh,
                       int64_t d_sb, int64_t d_ss, int64_t d_sh) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (NT / 32) + threadIdx.x / 32;
  if (row >= static_cast<int64_t>(B) * (TR ? Sqp : Sq) * H) return;
  const int lane = threadIdx.x % 32;
  int b, i, h;
  if (TR) {
    i = static_cast<int>(row % Sqp);
    h = static_cast<int>((row / Sqp) % H);
    b = static_cast<int>(row / (static_cast<int64_t>(H) * Sqp));
    if (i >= Sq) {
      if (lane == 0) delta[row] = lse2[row] = 0.f;
      return;
    }
  } else {
    h = static_cast<int>(row % H);
    i = static_cast<int>((row / H) % Sq);
    b = static_cast<int>(row / (static_cast<int64_t>(H) * Sq));
  }
  const T* orow = o + b * o_sb + i * o_ss + h * o_sh;
  const T* drow = dout + b * d_sb + i * d_ss + h * d_sh;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f(drow[d]), to_f(orow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    delta[row] = acc;
    if (TR) lse2[row] = lse[(static_cast<int64_t>(b) * Sq + i) * H + h] * tc::LOG2E;
  }
}

template <int HD>
struct Cfg {
  static constexpr int BQ = HD >= 128 ? 32 : 64;   // query rows of a tile
  static constexpr int BK = HD >= 256 ? 32 : 64;   // key rows of a tile
  static constexpr int RS = HD + 4;                // row stride (floats) of q, do, k, v tiles
  static constexpr int PS = BK + 4;                // row stride of the p and ds tiles
  // score phase: 16 x 16 threads, query rows sy + 16*i, key columns sx + 16*j
  static constexpr int S_ROWS = BQ / 16;
  static constexpr int S_COLS = BK / 16;
  // accumulation phase: TXD threads across dims (a float4 each), TYR across rows
  static constexpr int TXD = HD / 4 < 16 ? HD / 4 : 16;
  static constexpr int TYR = NT / TXD;
  static constexpr int JD = HD / (4 * TXD);        // float4 chunks per thread
  static constexpr int RM_K = BK / TYR;            // key rows per thread (dk, dv)
  static constexpr int RM_Q = BQ / TYR;            // query rows per thread (dq)
  static constexpr int SMEM_FLOATS = 2 * BQ * RS + 2 * BK * RS + 2 * BQ * PS + 2 * BQ;
  static_assert(BK % TYR == 0 && BQ % TYR == 0 && HD % (4 * TXD) == 0, "layout");
  static_assert(SMEM_FLOATS * 4 <= 227 * 1024, "shared memory");
};

struct Args {
  int Sq, Sk, G, causal, window;
  float softcap, scale;
  // element strides (b, s, h) of q, k, v, do, dq, dk, dv
  int64_t q[3], k[3], v[3], d[3], dq[3], dk[3], dv[3];
};

// Load rows [r0, r0 + R) of a [S, HD] slice with row stride ss into a
// shared-memory tile of row stride RS as fp32; rows past S are zero.
template <typename T, int HD, int R, int RS>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int64_t ss, int r0, int S) {
  for (int e = threadIdx.x; e < R * HD; e += NT) {
    const int r = e / HD, c = e % HD;
    dst[r * RS + c] = r0 + r < S ? to_f(src[(r0 + r) * ss + c]) : 0.f;
  }
}

// For the query rows sy + 16*i and key columns sx + 16*j of a tile: the
// scores s = q.k^T and dp = do.v^T, then p = exp(s' - lse) with s' the
// scaled (and soft-capped) score, masked, and ds = p (dp - delta)
// (1 - t^2 under the softcap) scale. Writes p to sP and ds to sDS.
template <int HD>
__device__ __forceinline__ void scores_and_ds(const float* sQ, const float* sDO,
                                              const float* sK, const float* sV,
                                              const float* sLse, const float* sDelta,
                                              float* sP, float* sDS, int q0, int k0,
                                              const Args& a) {
  using C = Cfg<HD>;
  const int sx = threadIdx.x & 15, sy = threadIdx.x >> 4;
  float s[C::S_ROWS][C::S_COLS], dp[C::S_ROWS][C::S_COLS];
#pragma unroll
  for (int i = 0; i < C::S_ROWS; ++i)
#pragma unroll
    for (int j = 0; j < C::S_COLS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 qv[C::S_ROWS], dv[C::S_ROWS], kv[C::S_COLS], vv[C::S_COLS];
#pragma unroll
    for (int i = 0; i < C::S_ROWS; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(&sQ[(sy + 16 * i) * C::RS + d]);
      dv[i] = *reinterpret_cast<const float4*>(&sDO[(sy + 16 * i) * C::RS + d]);
    }
#pragma unroll
    for (int j = 0; j < C::S_COLS; ++j) {
      kv[j] = *reinterpret_cast<const float4*>(&sK[(sx + 16 * j) * C::RS + d]);
      vv[j] = *reinterpret_cast<const float4*>(&sV[(sx + 16 * j) * C::RS + d]);
    }
#pragma unroll
    for (int i = 0; i < C::S_ROWS; ++i)
#pragma unroll
      for (int j = 0; j < C::S_COLS; ++j) {
        float x = s[i][j], y = dp[i][j];
        x = fmaf(qv[i].x, kv[j].x, x);
        x = fmaf(qv[i].y, kv[j].y, x);
        x = fmaf(qv[i].z, kv[j].z, x);
        x = fmaf(qv[i].w, kv[j].w, x);
        y = fmaf(dv[i].x, vv[j].x, y);
        y = fmaf(dv[i].y, vv[j].y, y);
        y = fmaf(dv[i].z, vv[j].z, y);
        y = fmaf(dv[i].w, vv[j].w, y);
        s[i][j] = x;
        dp[i][j] = y;
      }
  }
  const int q_off = a.Sk - a.Sq;
#pragma unroll
  for (int i = 0; i < C::S_ROWS; ++i) {
    const int r = sy + 16 * i;
    const int qpos = q_off + q0 + r;
    const float lse = sLse[r], delta = sDelta[r];
#pragma unroll
    for (int j = 0; j < C::S_COLS; ++j) {
      const int c = sx + 16 * j;
      const int kpos = k0 + c;
      bool keep = q0 + r < a.Sq && kpos < a.Sk;
      if (a.causal) keep = keep && qpos >= kpos;
      if (a.window > 0) keep = keep && (qpos - kpos) < a.window;
      float x = s[i][j] * a.scale, t = 0.f;
      if (a.softcap > 0.f) {
        t = tanhf(x / a.softcap);
        x = t * a.softcap;
      }
      const float p = keep ? expf(x - lse) : 0.f;
      float ds = p * (dp[i][j] - delta);
      if (a.softcap > 0.f) ds *= 1.f - t * t;
      sP[r * C::PS + c] = p;
      sDS[r * C::PS + c] = ds * a.scale;
    }
  }
}

// One CTA per (key tile, kv head, batch): dk and dv of BK keys, summed in
// fp32 registers over the G query heads of the group and over every query
// tile that the mask lets see the key tile; written once, no atomics.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, const Args a) {
  using C = Cfg<HD>;
  extern __shared__ float4 smem_f4[];
  float* sQ = reinterpret_cast<float*>(smem_f4);   // [BQ][RS]
  float* sDO = sQ + C::BQ * C::RS;                  // [BQ][RS]
  float* sK = sDO + C::BQ * C::RS;                  // [BK][RS]
  float* sV = sK + C::BK * C::RS;                   // [BK][RS]
  float* sP = sV + C::BK * C::RS;                   // [BQ][PS]
  float* sDS = sP + C::BQ * C::PS;                  // [BQ][PS]
  float* sLse = sDS + C::BQ * C::PS;                // [BQ]
  float* sDelta = sLse + C::BQ;                     // [BQ]

  const int tid = threadIdx.x;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * C::BK;
  const int k_last = min(k0 + C::BK, a.Sk) - 1;
  const int q_off = a.Sk - a.Sq;
  const int H = gridDim.y * a.G;

  load_rows<T, HD, C::BK, C::RS>(sK, k + b * a.k[0] + kvh * a.k[2], a.k[1], k0, a.Sk);
  load_rows<T, HD, C::BK, C::RS>(sV, v + b * a.v[0] + kvh * a.v[2], a.v[1], k0, a.Sk);

  // query rows that some key of this tile is visible to
  const int q_lo = a.causal ? max(0, k0 - q_off) : 0;
  const int q_hi = a.window > 0 ? min(a.Sq, k_last - q_off + a.window) : a.Sq;

  const int tx = tid % C::TXD, ty = tid / C::TXD;
  float acc_k[C::RM_K][C::JD][4], acc_v[C::RM_K][C::JD][4];
#pragma unroll
  for (int i = 0; i < C::RM_K; ++i)
#pragma unroll
    for (int j = 0; j < C::JD; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[i][j][e] = acc_v[i][j][e] = 0.f;

  for (int g = 0; g < a.G; ++g) {
    const int h = kvh * a.G + g;
    const T* qb = q + b * a.q[0] + h * a.q[2];
    const T* db = dout + b * a.d[0] + h * a.d[2];
    for (int q0 = (q_lo / C::BQ) * C::BQ; q0 < q_hi; q0 += C::BQ) {
      __syncthreads();   // the previous tile's readers are done
      load_rows<T, HD, C::BQ, C::RS>(sQ, qb, a.q[1], q0, a.Sq);
      load_rows<T, HD, C::BQ, C::RS>(sDO, db, a.d[1], q0, a.Sq);
      for (int r = tid; r < C::BQ; r += NT) {
        const bool in = q0 + r < a.Sq;
        const int64_t at = (static_cast<int64_t>(b) * a.Sq + q0 + r) * H + h;
        sLse[r] = in ? lse[at] : 0.f;
        sDelta[r] = in ? delta[at] : 0.f;
      }
      __syncthreads();
      scores_and_ds<HD>(sQ, sDO, sK, sV, sLse, sDelta, sP, sDS, q0, k0, a);
      __syncthreads();
      // dv += p^T . do, dk += ds^T . q
#pragma unroll 2
      for (int r = 0; r < C::BQ; ++r) {
        float p[C::RM_K], ds[C::RM_K];
#pragma unroll
        for (int i = 0; i < C::RM_K; ++i) {
          p[i] = sP[r * C::PS + ty + C::TYR * i];
          ds[i] = sDS[r * C::PS + ty + C::TYR * i];
        }
#pragma unroll
        for (int j = 0; j < C::JD; ++j) {
          const float4 dov = *reinterpret_cast<const float4*>(&sDO[r * C::RS + 4 * tx + 4 * C::TXD * j]);
          const float4 qv = *reinterpret_cast<const float4*>(&sQ[r * C::RS + 4 * tx + 4 * C::TXD * j]);
#pragma unroll
          for (int i = 0; i < C::RM_K; ++i) {
            acc_v[i][j][0] = fmaf(p[i], dov.x, acc_v[i][j][0]);
            acc_v[i][j][1] = fmaf(p[i], dov.y, acc_v[i][j][1]);
            acc_v[i][j][2] = fmaf(p[i], dov.z, acc_v[i][j][2]);
            acc_v[i][j][3] = fmaf(p[i], dov.w, acc_v[i][j][3]);
            acc_k[i][j][0] = fmaf(ds[i], qv.x, acc_k[i][j][0]);
            acc_k[i][j][1] = fmaf(ds[i], qv.y, acc_k[i][j][1]);
            acc_k[i][j][2] = fmaf(ds[i], qv.z, acc_k[i][j][2]);
            acc_k[i][j][3] = fmaf(ds[i], qv.w, acc_k[i][j][3]);
          }
        }
      }
    }
  }

  T* dkb = dk + b * a.dk[0] + kvh * a.dk[2];
  T* dvb = dv + b * a.dv[0] + kvh * a.dv[2];
#pragma unroll
  for (int i = 0; i < C::RM_K; ++i) {
    const int kj = k0 + ty + C::TYR * i;
    if (kj >= a.Sk) continue;
#pragma unroll
    for (int j = 0; j < C::JD; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 4 * C::TXD * j + e;
        dkb[kj * a.dk[1] + d] = from_f<T>(acc_k[i][j][e]);
        dvb[kj * a.dv[1] + d] = from_f<T>(acc_v[i][j][e]);
      }
  }
}

// One CTA per (query tile, head, batch): dq of BQ rows, summed in fp32
// registers over the key tiles the mask lets the tile see; scores and ds
// are recomputed here rather than summed into dq by atomics in the dk/dv
// kernel, so every sum has one order.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, const Args a) {
  using C = Cfg<HD>;
  extern __shared__ float4 smem_f4[];
  float* sQ = reinterpret_cast<float*>(smem_f4);
  float* sDO = sQ + C::BQ * C::RS;
  float* sK = sDO + C::BQ * C::RS;
  float* sV = sK + C::BK * C::RS;
  float* sP = sV + C::BK * C::RS;
  float* sDS = sP + C::BQ * C::PS;
  float* sLse = sDS + C::BQ * C::PS;
  float* sDelta = sLse + C::BQ;

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;        // latest q tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y;
  const int kvh = h / a.G;
  const int q0 = qt * C::BQ;
  const int q_off = a.Sk - a.Sq;

  load_rows<T, HD, C::BQ, C::RS>(sQ, q + b * a.q[0] + h * a.q[2], a.q[1], q0, a.Sq);
  load_rows<T, HD, C::BQ, C::RS>(sDO, dout + b * a.d[0] + h * a.d[2], a.d[1], q0, a.Sq);
  for (int r = tid; r < C::BQ; r += NT) {
    const bool in = q0 + r < a.Sq;
    const int64_t at = (static_cast<int64_t>(b) * a.Sq + q0 + r) * H + h;
    sLse[r] = in ? lse[at] : 0.f;
    sDelta[r] = in ? delta[at] : 0.f;
  }

  // key tiles that some query of this tile can see
  const int q_first = q_off + q0;
  const int q_last = q_off + min(q0 + C::BQ, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  int k_begin = a.window > 0 ? max(0, q_first - a.window + 1) : 0;
  k_begin = (k_begin / C::BK) * C::BK;

  const T* kb = k + b * a.k[0] + kvh * a.k[2];
  const T* vb = v + b * a.v[0] + kvh * a.v[2];
  const int tx = tid % C::TXD, ty = tid / C::TXD;
  float acc[C::RM_Q][C::JD][4];
#pragma unroll
  for (int i = 0; i < C::RM_Q; ++i)
#pragma unroll
    for (int j = 0; j < C::JD; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += C::BK) {
    __syncthreads();   // q tile written / the previous tile's readers done
    load_rows<T, HD, C::BK, C::RS>(sK, kb, a.k[1], k0, a.Sk);
    load_rows<T, HD, C::BK, C::RS>(sV, vb, a.v[1], k0, a.Sk);
    __syncthreads();
    scores_and_ds<HD>(sQ, sDO, sK, sV, sLse, sDelta, sP, sDS, q0, k0, a);
    __syncthreads();
    // dq += ds . k
#pragma unroll 2
    for (int c = 0; c < C::BK; ++c) {
      float ds[C::RM_Q];
#pragma unroll
      for (int i = 0; i < C::RM_Q; ++i) ds[i] = sDS[(ty + C::TYR * i) * C::PS + c];
#pragma unroll
      for (int j = 0; j < C::JD; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(&sK[c * C::RS + 4 * tx + 4 * C::TXD * j]);
#pragma unroll
        for (int i = 0; i < C::RM_Q; ++i) {
          acc[i][j][0] = fmaf(ds[i], kv.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(ds[i], kv.y, acc[i][j][1]);
          acc[i][j][2] = fmaf(ds[i], kv.z, acc[i][j][2]);
          acc[i][j][3] = fmaf(ds[i], kv.w, acc[i][j][3]);
        }
      }
    }
  }

  T* dqb = dq + b * a.dq[0] + h * a.dq[2];
#pragma unroll
  for (int i = 0; i < C::RM_Q; ++i) {
    const int qi = q0 + ty + C::TYR * i;
    if (qi >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < C::JD; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dqb[qi * a.dq[1] + 4 * tx + 4 * C::TXD * j + e] = from_f<T>(acc[i][j][e]);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv,
                   int B, int H, int Kh, const Args& a, cudaStream_t stream) {
  using C = Cfg<HD>;
  const int smem = C::SMEM_FLOATS * static_cast<int>(sizeof(float));
  static bool set_kv[64] = {}, set_q[64] = {};
  cudaError_t err = opt_in_smem(flash_bwd_dkdv_kernel<T, HD>, smem, set_kv);
  if (err != cudaSuccess) return err;
  err = opt_in_smem(flash_bwd_dq_kernel<T, HD>, smem, set_q);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  dim3 grid_kv((a.Sk + C::BK - 1) / C::BK, Kh, B);
  flash_bwd_dkdv_kernel<T, HD><<<grid_kv, NT, smem, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_q((a.Sq + C::BQ - 1) / C::BQ, H, B);
  flash_bwd_dq_kernel<T, HD><<<grid_q, NT, smem, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dq), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(int hd, const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta, void* dq, void* dk,
                void* dv, int B, int H, int Kh, const long long* st, const Args& a,
                cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * a.Sq * H;
  const int blocks = static_cast<int>((rows + NT / 32 - 1) / (NT / 32));
  flash_bwd_delta_kernel<T, false><<<blocks, NT, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), nullptr, delta, nullptr, B,
      a.Sq, a.Sq, H, hd, st[9], st[10], st[11], st[12], st[13], st[14]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Kh, a, stream);
    case 32: return launch<T, 32>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Kh, a, stream);
    case 64: return launch<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Kh, a, stream);
    case 128: return launch<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Kh, a, stream);
    case 192: return launch<T, 192>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Kh, a, stream);
    case 256: return launch<T, 256>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Kh, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// Backward on the tensor cores (bf16): dk/dv, dq and the split reduction
// ---------------------------------------------------------------------------

namespace tcb {

constexpr int NT = 384;        // producer warpgroup + two consumer warpgroups
constexpr int STAGES = 2;      // ring depth
constexpr int BQ = 64;         // queries per ring tile of the dk/dv kernel
constexpr int BQ_DQ = 128;     // queries per dq CTA: 64 per consumer warpgroup
using tc::LOG2E;
using tc::Wgmma;

struct Args {
  int B, Sq, Sk, H, G, Sqp, n_split, causal, window;
  float softcap, scale;
};

// dq's key tile; k and v come in boxes of this many rows in both kernels
template <int HD> struct QCfg {
  static constexpr int BK = HD == 256 ? 32 : 64;
  static constexpr int Q_BYTES = BQ_DQ * HD * 2;     // one of q, do
  static constexpr int KV_BYTES = BK * HD * 2;       // one of k, v
  static constexpr int RING = 2 * Q_BYTES;           // stage s: k at + 2 s KV_BYTES, v after
  static constexpr int BARS = RING + STAGES * 2 * KV_BYTES;
  // barriers: q and do, full[STAGES], empty[STAGES]
  static constexpr int SMEM = 1024 + BARS + 8 * (1 + 2 * STAGES);
  static_assert(SMEM <= 227 * 1024, "q, do and the ring must fit");
};

template <int HD> struct KvCfg {
  // head dims 192 and 256: both consumers share one 64-key tile (one holds
  // dv, the other dk); else each owns 64 of the CTA's 128 keys and holds
  // both. At 192 holding both would take 2 x 96 accumulators a thread
  // beside S^T and dP^T (32 each), over the 240 registers a consumer gets
  static constexpr bool SHARED = HD >= 192;
  static constexpr int BK = SHARED ? 64 : 128;
  static constexpr int BOX = QCfg<HD>::BK;           // rows per k/v box
  static constexpr int KV_BYTES = BK * HD * 2;       // one of k, v
  static constexpr int Q_BYTES = BQ * HD * 2;        // one of q, do
  static constexpr int RING = 2 * KV_BYTES;          // stage s: q at + 2 s Q_BYTES, do after
  static constexpr int LD = RING + STAGES * 2 * Q_BYTES;   // stage s: lse2[BQ], delta[BQ]
  static constexpr int PX = LD + STAGES * 2 * BQ * 4;      // SHARED: p (1 - t^2) scale
  static constexpr int BARS = PX + (SHARED ? 32 * 128 * 4 : 0);   // 32 floats a thread
  // barriers: k and v, full[STAGES], empty[STAGES]
  static constexpr int SMEM = 1024 + BARS + 8 * (1 + 2 * STAGES);
  static_assert(SMEM <= 227 * 1024, "k, v, the ring and p must fit");
  static_assert(BK % BOX == 0, "k/v boxes tile the key tile");
};

__device__ __forceinline__ bool visible(int qpos, int kpos, const Args& a) {
  bool keep = !a.causal || qpos >= kpos;
  if (a.window > 0) keep = keep && (qpos - kpos) < a.window;
  return keep;
}

// From a raw score s: p = exp2(x - lse2) with x the scaled (soft-capped)
// score in log2 units (0 where `keep` is false), and the factor f of
// ds = p (dp - delta) f: the scale, times 1 - t^2 under the softcap.
__device__ __forceinline__ void p_and_f(float s, float lse2, bool keep, float sl2,
                                        const Args& a, float& p, float& f) {
  float x;
  f = a.scale;
  if (a.softcap > 0.f) {
    const float t = tanhf(s * a.scale / a.softcap);
    x = t * a.softcap * LOG2E;
    f *= 1.f - t * t;
  } else {
    x = s * sl2;
  }
  p = keep ? exp2f(x - lse2) : 0.f;
}

__device__ __forceinline__ uint64_t kmaj(uint32_t addr) { return sm90::desc_sw128(addr, 16, 1024); }

// Rows `key`, key + 8 of a 64 x HD accumulator (this thread's columns
// 8j + 2 t4, +1) to bf16 `out` (row stride ss) or, with a head split, to
// the fp32 partials `part` (row stride ps). Keys past Sk are not stored.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2], __nv_bfloat16* out,
                                           int64_t ss, float* part, int64_t ps, int key,
                                           int Sk, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = key + 8 * r;
    if (kj >= Sk) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      const float x = acc[4 * j + 2 * r], y = acc[4 * j + 2 * r + 1];
      if (part != nullptr)
        *reinterpret_cast<float2*>(part + kj * ps + col) = make_float2(x, y);
      else
        *reinterpret_cast<__nv_bfloat162*>(out + kj * ss + col) = __floats2bfloat162_rn(x, y);
    }
  }
}

// One CTA per (kv head x head split, key tile, b), the key tiles that see
// the most queries (the first, under a causal mask) launched first over
// every head, so the light ones fill the tail: dk and dv of the tile's
// keys, summed over the split's heads of the group (in order) and over the
// query tiles the mask lets see a key of the tile. k and v are loaded once;
// q, do and their lse2 and delta stream through the ring in tiles of 64
// queries. Per tile: S^T = K.Q^T and dP^T = V.dO^T by wgmma (both operands
// K-major), P^T = exp2(S^T scale log2e - lse2), dS^T = P^T (dP^T - delta)
// (1 - t^2) scale in registers, the queries along the accumulator's
// columns; P^T and dS^T rounded to bf16 are the register A operands of
// dV += P^T.dO and dK += dS^T.Q (do and q MN-major).
template <int HD>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse2, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                         float* __restrict__ part, int64_t dk_sb, int64_t dk_ss,
                         int64_t dk_sh, int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
                         const Args a) {
  using C = KvCfg<HD>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms need 1024-byte alignment
  uint8_t* sm = smem_raw + ((1024u - (sm90::smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sK = sm90::smem_u32(sm);
  const uint32_t sV = sK + C::KV_BYTES;
  const uint32_t ring = sK + C::RING;                  // q of stage s at + 2 s Q_BYTES
  const float* sLD = reinterpret_cast<const float*>(sm + C::LD);
  float* sPX = reinterpret_cast<float*>(sm + C::PX);
  const uint32_t bar_kv = sK + C::BARS;
  const uint32_t full = bar_kv + 8;                    // + 8 s
  const uint32_t empty = full + 8 * STAGES;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.y * BK;
  const int kvh = blockIdx.x / a.n_split, split = blockIdx.x % a.n_split;
  const int b = blockIdx.z;
  const int q_off = a.Sk - a.Sq;
  const int gs = a.G / a.n_split;                      // heads this CTA sums
  const int h_first = kvh * a.G + split * gs;
  // query tiles that some key of this tile is visible to
  const int k_last = min(k0 + BK, a.Sk) - 1;
  const int q_lo = a.causal ? max(0, k0 - q_off) : 0;
  const int q_hi = a.window > 0 ? min(a.Sq, k_last - q_off + a.window) : a.Sq;
  const int q_first = (q_lo / BQ) * BQ;
  const int nqt = q_hi > q_first ? (q_hi - q_first + BQ - 1) / BQ : 0;

  if (tid == 0) {
    sm90::mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, 2 * 128);   // every consumer thread
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread loads k, v and keeps the ring full ----
    sm90::setmaxnreg_dec<24>();
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(bar_kv, 2 * C::KV_BYTES);
#pragma unroll
      for (int c = 0; c < HD / 64; ++c)
#pragma unroll
        for (int j = 0; j < BK / C::BOX; ++j) {
          const uint32_t at = c * BK * 128 + j * C::BOX * 128;
          sm90::tma_load_4d(sK + at, &tm_k, bar_kv, 64 * c, kvh, k0 + j * C::BOX, b);
          sm90::tma_load_4d(sV + at, &tm_v, bar_kv, 64 * c, kvh, k0 + j * C::BOX, b);
        }
      int it = 0;
      for (int gi = 0; gi < gs; ++gi) {
        const int h = h_first + gi;
        const int64_t row = (static_cast<int64_t>(b) * a.H + h) * a.Sqp;
        for (int tq = 0; tq < nqt; ++tq, ++it) {
          const int s = it % STAGES;
          const uint32_t phase = (it / STAGES) & 1;
          const int q0 = q_first + tq * BQ;
          const uint32_t q_tile = ring + s * 2 * C::Q_BYTES;
          sm90::mbar_wait(empty + 8 * s, phase ^ 1);
          sm90::mbar_arrive_expect_tx(full + 8 * s, 2 * C::Q_BYTES + 2 * BQ * 4);
#pragma unroll
          for (int c = 0; c < HD / 64; ++c) {
            sm90::tma_load_4d(q_tile + c * BQ * 128, &tm_q, full + 8 * s, 64 * c, h, q0, b);
            sm90::tma_load_4d(q_tile + C::Q_BYTES + c * BQ * 128, &tm_do, full + 8 * s,
                              64 * c, h, q0, b);
          }
          const uint32_t ld = sm90::smem_u32(sLD + s * 2 * BQ);
          sm90::bulk_load(ld, lse2 + row + q0, BQ * 4, full + 8 * s);
          sm90::bulk_load(ld + BQ * 4, delta + row + q0, BQ * 4, full + 8 * s);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  sm90::setmaxnreg_inc<240>();
  const int cw = tid / 128 - 1, t = tid % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, t4 = lane % 4;
  const int kc0 = C::SHARED ? k0 : k0 + 64 * cw;       // this warpgroup's 64 keys
  const int key = kc0 + 16 * warp + g;                 // this thread's keys: key, key + 8
  const float sl2 = a.scale * LOG2E;
  // with a head split: this (split, b, kv head)'s fp32 partials of dk and
  // dv at key 0, rows of Kh * HD floats
  const int Kh = a.H / a.G;
  const int64_t prow = static_cast<int64_t>(Kh) * HD;
  float* pk = part == nullptr ? nullptr
      : part + ((static_cast<int64_t>(split) * a.B + b) * a.Sk * Kh + kvh) * HD;
  float* pv = part == nullptr ? nullptr
      : pk + static_cast<int64_t>(a.n_split) * a.B * a.Sk * prow;

  sm90::mbar_wait(bar_kv, 0);

  if constexpr (!C::SHARED) {
    const uint32_t rows = cw * 64 * 128;               // the warpgroup's k, v rows
    float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    int it = 0;
    for (int gi = 0; gi < gs; ++gi) {
      for (int tq = 0; tq < nqt; ++tq, ++it) {
        const int s = it % STAGES;
        const uint32_t phase = (it / STAGES) & 1;
        const int q0 = q_first + tq * BQ;
        const int qp0 = q_off + q0;                  // the tile's first query position
        const uint32_t q_tile = ring + s * 2 * C::Q_BYTES;
        const uint32_t do_tile = q_tile + C::Q_BYTES;
        const bool skip = kc0 >= a.Sk || (a.causal && qp0 + BQ - 1 < kc0) ||
                          (a.window > 0 && qp0 - (kc0 + 63) >= a.window);
        sm90::mbar_wait(full + 8 * s, phase);
        if (!skip) {
          float sc[32], dp[32];
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            const int c = kk / 4, w = kk % 4;
            Wgmma<64>::ss(sc, kmaj(sK + rows + c * BK * 128 + 32 * w),
                          kmaj(q_tile + c * BQ * 128 + 32 * w), kk > 0);
          }
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            const int c = kk / 4, w = kk % 4;
            Wgmma<64>::ss(dp, kmaj(sV + rows + c * BK * 128 + 32 * w),
                          kmaj(do_tile + c * BQ * 128 + 32 * w), kk > 0);
          }
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(sc);
          sm90::fence_regs(dp);
          // masks only where the tile crosses Sq, the diagonal or the window's edge
          const bool masked = q0 + BQ > a.Sq || (a.causal && qp0 < kc0 + 63) ||
                              (a.window > 0 && qp0 + BQ - 1 - kc0 >= a.window);
          const float* L = sLD + s * 2 * BQ;
          const float* D = L + BQ;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 8 * j + 2 * t4;
            const float2 l2 = *reinterpret_cast<const float2*>(L + col);
            const float2 d2 = *reinterpret_cast<const float2*>(D + col);
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * j + 2 * r + e;
                const bool keep = !masked ||
                    (q0 + col + e < a.Sq && visible(qp0 + col + e, key + 8 * r, a));
                float p, f;
                p_and_f(sc[i], e ? l2.y : l2.x, keep, sl2, a, p, f);
                dp[i] = p * (dp[i] - (e ? d2.y : d2.x)) * f;
                sc[i] = p;
              }
          }
          uint32_t pp[16], pd[16];                  // P^T, dS^T in bf16: A operands
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            pp[i] = sm90::pack_bf16(sc[2 * i], sc[2 * i + 1]);
            pd[i] = sm90::pack_bf16(dp[2 * i], dp[2 * i + 1]);
          }
          sm90::fence_regs(acc_v);
          sm90::fence_regs(acc_k);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            Wgmma<HD>::rs(acc_v, &pp[4 * kk],
                          sm90::desc_sw128(do_tile + kk * 16 * 128, BQ * 128, 1024));
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            Wgmma<HD>::rs(acc_k, &pd[4 * kk],
                          sm90::desc_sw128(q_tile + kk * 16 * 128, BQ * 128, 1024));
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(acc_v);
          sm90::fence_regs(acc_k);
        }
        sm90::mbar_arrive(empty + 8 * s);
      }
    }
    store_rows<HD>(acc_k, dk + b * dk_sb + kvh * dk_sh, dk_ss, pk, prow, key, a.Sk, t4);
    store_rows<HD>(acc_v, dv + b * dv_sb + kvh * dv_sh, dv_ss, pv, prow, key, a.Sk, t4);
  } else {
    // head dims 192 and 256: warpgroup 0 computes S^T and P^T and holds dV; it hands
    // P^T (1 - t^2) scale to warpgroup 1 through shared memory in fragment
    // order (named barrier 1: written; 2: read), which computes dP^T, forms
    // dS^T and holds dK
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    int it = 0, n = 0;
    for (int gi = 0; gi < gs; ++gi) {
      for (int tq = 0; tq < nqt; ++tq, ++it) {
        const int s = it % STAGES;
        const uint32_t phase = (it / STAGES) & 1;
        const int q0 = q_first + tq * BQ;
        const int qp0 = q_off + q0;
        const uint32_t q_tile = ring + s * 2 * C::Q_BYTES;
        const uint32_t do_tile = q_tile + C::Q_BYTES;
        const bool skip = (a.causal && qp0 + BQ - 1 < kc0) ||
                          (a.window > 0 && qp0 - (kc0 + 63) >= a.window);
        sm90::mbar_wait(full + 8 * s, phase);
        if (!skip) {
          float sc[32];
          const uint32_t a_rows = cw == 0 ? sK : sV;      // S^T = K.Q^T; dP^T = V.dO^T
          const uint32_t b_tile = cw == 0 ? q_tile : do_tile;
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            const int c = kk / 4, w = kk % 4;
            Wgmma<64>::ss(sc, kmaj(a_rows + c * BK * 128 + 32 * w),
                          kmaj(b_tile + c * BQ * 128 + 32 * w), kk > 0);
          }
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(sc);
          const float* L = sLD + s * 2 * BQ;
          uint32_t pa[16];                                // P^T or dS^T in bf16
          if (cw == 0) {
            const bool masked = q0 + BQ > a.Sq || (a.causal && qp0 < kc0 + 63) ||
                                (a.window > 0 && qp0 + BQ - 1 - kc0 >= a.window);
            if (n > 0) sm90::named_sync<2>(256);          // the last P^T is read
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int col = 8 * j + 2 * t4;
              const float2 l2 = *reinterpret_cast<const float2*>(L + col);
#pragma unroll
              for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int i = 4 * j + 2 * r + e;
                  const bool keep = !masked ||
                      (q0 + col + e < a.Sq && visible(qp0 + col + e, key + 8 * r, a));
                  float p, f;
                  p_and_f(sc[i], e ? l2.y : l2.x, keep, sl2, a, p, f);
                  sPX[i * 128 + t] = p * f;
                  sc[i] = p;
                }
            }
            sm90::named_arrive<1>(256);
          } else {
            const float* D = L + BQ;
            sm90::named_sync<1>(256);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float2 d2 = *reinterpret_cast<const float2*>(D + 8 * j + 2 * t4);
#pragma unroll
              for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int i = 4 * j + 2 * r + e;
                  sc[i] = sPX[i * 128 + t] * (sc[i] - (e ? d2.y : d2.x));
                }
            }
            sm90::named_arrive<2>(256);
          }
#pragma unroll
          for (int i = 0; i < 16; ++i) pa[i] = sm90::pack_bf16(sc[2 * i], sc[2 * i + 1]);
          // dV += P^T.dO (warpgroup 0); dK += dS^T.Q (warpgroup 1)
          const uint32_t b_mn = cw == 0 ? do_tile : q_tile;
          sm90::fence_regs(acc);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            Wgmma<HD>::rs(acc, &pa[4 * kk],
                          sm90::desc_sw128(b_mn + kk * 16 * 128, BQ * 128, 1024));
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(acc);
          ++n;
        }
        sm90::mbar_arrive(empty + 8 * s);
      }
    }
    if (cw == 0 && n > 0) sm90::named_sync<2>(256);      // warpgroup 1's last read
    if (cw == 0)
      store_rows<HD>(acc, dv + b * dv_sb + kvh * dv_sh, dv_ss, pv, prow, key, a.Sk, t4);
    else
      store_rows<HD>(acc, dk + b * dk_sb + kvh * dk_sh, dk_ss, pk, prow, key, a.Sk, t4);
  }
}

// dk and dv from the head splits' fp32 partials [2][n_split][B*Sk*Kh*HD]
// (dk's, then dv's), summed in split order, in bf16: four values a thread,
// blockIdx.y picks dk (0) or dv (1).
__global__ void __launch_bounds__(256)
flash_bwd_reduce_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int n_split, int64_t n, int hd,
                        int Kh, int Sk, int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
                        int64_t dv_sb, int64_t dv_ss, int64_t dv_sh) {
  const int64_t idx = (static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (idx >= n) return;
  const int y = blockIdx.y;
  const float* p = part + y * n_split * n + idx;
  float4 acc = *reinterpret_cast<const float4*>(p);
  for (int sp = 1; sp < n_split; ++sp) {
    const float4 x = *reinterpret_cast<const float4*>(p + sp * n);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const int d = static_cast<int>(idx % hd);
  int64_t r = idx / hd;
  const int kh = static_cast<int>(r % Kh);
  r /= Kh;
  const int s = static_cast<int>(r % Sk);
  const int b = static_cast<int>(r / Sk);
  __nv_bfloat16* out = y == 0 ? dk + b * dk_sb + s * dk_ss + kh * dk_sh + d
                              : dv + b * dv_sb + s * dv_ss + kh * dv_sh + d;
  reinterpret_cast<__nv_bfloat162*>(out)[0] = __floats2bfloat162_rn(acc.x, acc.y);
  reinterpret_cast<__nv_bfloat162*>(out)[1] = __floats2bfloat162_rn(acc.z, acc.w);
}

// One CTA per (head, 128-query tile, b), the latest query tiles (the most
// keys, under a causal mask) launched first over every head: q and do are
// loaded once, k and v tiles of BK keys stream through the ring. Per tile:
// S = Q.K^T and dP = dO.V^T by wgmma (both K-major), dS in registers,
// rounded to bf16 as the register A operand of dQ += dS.K (k MN-major).
// No atomics: scores and p are computed here again, so dq has one order.
template <int HD>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ lse2, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int64_t dq_sb, int64_t dq_ss,
                       int64_t dq_sh, const Args a) {
  using C = QCfg<HD>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (sm90::smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sQ = sm90::smem_u32(sm);
  const uint32_t sDO = sQ + C::Q_BYTES;
  const uint32_t ring = sQ + C::RING;                   // k of stage s at + 2 s KV_BYTES
  const uint32_t bar_q = sQ + C::BARS;
  const uint32_t full = bar_q + 8;
  const uint32_t empty = full + 8 * STAGES;

  const int tid = threadIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;           // latest q tiles first
  const int h = blockIdx.x, b = blockIdx.z;
  const int kvh = h / a.G;
  const int q0 = qt * BQ_DQ;
  const int q_off = a.Sk - a.Sq;
  // key tiles that some query of this tile can see
  const int q_first = q_off + q0;
  const int q_last = q_off + min(q0 + BQ_DQ, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  int k_begin = a.window > 0 ? max(0, q_first - a.window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  if (tid == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, 2 * 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    sm90::setmaxnreg_dec<24>();
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(bar_q, 2 * C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < HD / 64; ++c)
#pragma unroll
        for (int j = 0; j < BQ_DQ / BQ; ++j) {
          const uint32_t at = c * BQ_DQ * 128 + j * BQ * 128;
          sm90::tma_load_4d(sQ + at, &tm_q, bar_q, 64 * c, h, q0 + j * BQ, b);
          sm90::tma_load_4d(sDO + at, &tm_do, bar_q, 64 * c, h, q0 + j * BQ, b);
        }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const uint32_t phase = (it / STAGES) & 1;
        const int k0 = k_begin + it * BK;
        const uint32_t k_tile = ring + s * 2 * C::KV_BYTES;
        sm90::mbar_wait(empty + 8 * s, phase ^ 1);
        sm90::mbar_arrive_expect_tx(full + 8 * s, 2 * C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < HD / 64; ++c) {
          sm90::tma_load_4d(k_tile + c * BK * 128, &tm_k, full + 8 * s, 64 * c, kvh, k0, b);
          sm90::tma_load_4d(k_tile + C::KV_BYTES + c * BK * 128, &tm_v, full + 8 * s, 64 * c,
                            kvh, k0, b);
        }
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<240>();
  const int cw = tid / 128 - 1;
  const int warp = (tid / 32) % 4, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int row0 = 64 * cw + 16 * warp + g;            // this thread's rows: row0, row0 + 8
  const int qpos0 = q_off + q0 + row0;
  const int wg_q = q0 + 64 * cw;                       // the warpgroup's first query
  const int wg_qlo = q_off + wg_q, wg_qhi = wg_qlo + 63;
  const float sl2 = a.scale * LOG2E;
  const int64_t at = (static_cast<int64_t>(b) * a.H + h) * a.Sqp + q0 + row0;   // < Sqp
  const float l2[2] = {lse2[at], lse2[at + 8]};
  const float dl[2] = {delta[at], delta[at + 8]};
  const uint32_t q_rows = sQ + cw * 64 * 128, do_rows = sDO + cw * 64 * 128;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  sm90::mbar_wait(bar_q, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t phase = (it / STAGES) & 1;
    const int k0 = k_begin + it * BK;
    const uint32_t k_tile = ring + s * 2 * C::KV_BYTES;
    const uint32_t v_tile = k_tile + C::KV_BYTES;
    const bool skip = wg_q >= a.Sq || (a.causal && k0 > wg_qhi) ||
                      (a.window > 0 && wg_qlo - (k0 + BK - 1) >= a.window);
    sm90::mbar_wait(full + 8 * s, phase);
    if (!skip) {
      float sc[BK / 2], dp[BK / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk / 4, w = kk % 4;
        Wgmma<BK>::ss(sc, kmaj(q_rows + c * BQ_DQ * 128 + 32 * w),
                      kmaj(k_tile + c * BK * 128 + 32 * w), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk / 4, w = kk % 4;
        Wgmma<BK>::ss(dp, kmaj(do_rows + c * BQ_DQ * 128 + 32 * w),
                      kmaj(v_tile + c * BK * 128 + 32 * w), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);
      // masks only where the tile crosses Sk, the diagonal or the window's edge
      const bool masked = k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > wg_qlo) ||
                          (a.window > 0 && wg_qhi - k0 >= a.window);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        const int kpos = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
        const bool keep = !masked || (kpos < a.Sk && visible(qpos0 + 8 * r, kpos, a));
        float p, f;
        p_and_f(sc[i], l2[r], keep, sl2, a, p, f);
        dp[i] = p * (dp[i] - dl[r]) * f;
      }
      uint32_t pd[BK / 4];                              // dS in bf16: the A operand
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) pd[i] = sm90::pack_bf16(dp[2 * i], dp[2 * i + 1]);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<HD>::rs(acc, &pd[4 * kk], sm90::desc_sw128(k_tile + kk * 16 * 128, BK * 128, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
    }
    sm90::mbar_arrive(empty + 8 * s);
  }

  __nv_bfloat16* qb = dq + b * dq_sb + h * dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + 8 * r;
    if (qi >= a.Sq) continue;
    __nv_bfloat16* orow = qb + qi * dq_ss + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

template <int HD>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const CUtensorMap& tdo, const float* lse2, const float* delta, float* part,
                   void* dq, void* dk, void* dv, const long long* st, const Args& a,
                   cudaStream_t stream) {
  static bool set_kv[64] = {}, set_q[64] = {};
  cudaError_t err = bwd::opt_in_smem(flash_bwd_dkdv_tc_kernel<HD>, KvCfg<HD>::SMEM, set_kv);
  if (err != cudaSuccess) return err;
  err = bwd::opt_in_smem(flash_bwd_dq_tc_kernel<HD>, QCfg<HD>::SMEM, set_q);
  if (err != cudaSuccess) return err;
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  const int Kh = a.H / a.G;
  dim3 grid_kv(Kh * a.n_split, (a.Sk + KvCfg<HD>::BK - 1) / KvCfg<HD>::BK, a.B);
  flash_bwd_dkdv_tc_kernel<HD><<<grid_kv, NT, KvCfg<HD>::SMEM, stream>>>(
      tq, tk, tv, tdo, lse2, delta, dkp, dvp, part, st[18], st[19], st[20], st[21], st[22],
      st[23], a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (part != nullptr) {
    const int64_t n = static_cast<int64_t>(a.B) * a.Sk * Kh * HD;
    dim3 grid_r(static_cast<unsigned>((n / 4 + 255) / 256), 2);
    flash_bwd_reduce_kernel<<<grid_r, 256, 0, stream>>>(
        part, dkp, dvp, a.n_split, n, HD, Kh, a.Sk, st[18], st[19], st[20], st[21], st[22],
        st[23]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dim3 grid_q(a.H, (a.Sq + BQ_DQ - 1) / BQ_DQ, a.B);
  flash_bwd_dq_tc_kernel<HD><<<grid_q, NT, QCfg<HD>::SMEM, stream>>>(
      tq, tk, tv, tdo, lse2, delta, static_cast<__nv_bfloat16*>(dq), st[15], st[16], st[17],
      a);
  return cudaGetLastError();
}

}  // namespace tcb

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// dimension of every tensor must have stride 1.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B, int Sq, int Sk, int H, int Kh, int hd,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float softcap, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Kh <= 0 || H % Kh != 0 ||
      (Sk < Sq && (causal || window > 0)))   // masks right-align the queries
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  const int G = H / Kh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_hd<float>(hd, q, k, v, o, static_cast<float*>(lse), B, Sq, Sk, H, G, st, causal, window, softcap, scale, s);
  else if (dtype == 1)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, static_cast<float*>(lse), B, Sq, Sk, H, G, st, causal, window, softcap, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// bf16 only, head dim 64, 128, 192 or 256. Strides are in elements; the last
// dimension of every tensor must have stride 1, q, k and v must start on
// 16 bytes and their other strides be multiples of 8 elements (TMA).
extern "C" int flash_attention_fwd_tc(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int Sq, int Sk, int H, int Kh, int hd,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float softcap, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Kh <= 0 || H % Kh != 0 ||
      (Sk < Sq && (causal || window > 0)))   // masks right-align the queries
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd != 64 && hd != 128 && hd != 192 && hd != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bk = hd >= 192 ? 64 : 128;             // tc::Cfg<hd>::BK
  CUtensorMap tq, tk, tv;
  int res = sm90::encode_bf16_4d(&tq, q, hd, H, Sq, B, q_sh, q_ss, q_sb, tc::BQ);
  if (res == 0) res = sm90::encode_bf16_4d(&tk, k, hd, Kh, Sk, B, k_sh, k_ss, k_sb, bk);
  if (res == 0) res = sm90::encode_bf16_4d(&tv, v, hd, Kh, Sk, B, v_sh, v_ss, v_sb, bk);
  if (res != 0) return 10000 + res;
  const int G = H / Kh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 64: err = tc::launch<64>(tq, tk, tv, o, static_cast<float*>(lse), B, Sq, Sk, H, G, o_sb, o_ss, o_sh, causal, window, softcap, scale, s); break;
    case 128: err = tc::launch<128>(tq, tk, tv, o, static_cast<float*>(lse), B, Sq, Sk, H, G, o_sb, o_ss, o_sh, causal, window, softcap, scale, s); break;
    case 192: err = tc::launch<192>(tq, tk, tv, o, static_cast<float*>(lse), B, Sq, Sk, H, G, o_sb, o_ss, o_sh, causal, window, softcap, scale, s); break;
    default: err = tc::launch<256>(tq, tk, tv, o, static_cast<float*>(lse), B, Sq, Sk, H, G, o_sb, o_ss, o_sh, causal, window, softcap, scale, s); break;
  }
  return static_cast<int>(err);
}

// dtype: 0 = float32, 1 = bfloat16, shared by q, k, v, o, do and the
// gradients dq, dk, dv; lse [B,Sq,H] fp32 from the forward, contiguous;
// delta [B,Sq,H] fp32 scratch. st: 24 element strides (b, s, h) of q, k, v,
// o, do, dq, dk, dv in that order; the last dimension of each has stride 1.
// Launches the delta, dk/dv and dq kernels in order on the stream.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* delta, void* dq, void* dk, void* dv,
    int dtype, int B, int Sq, int Sk, int H, int Kh, int hd, const long long* st,
    int causal, int window, float softcap, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Kh <= 0 || H % Kh != 0 ||
      (Sk < Sq && (causal || window > 0)))   // masks right-align the queries
    return static_cast<int>(cudaErrorInvalidValue);
  bwd::Args a;
  a.Sq = Sq;
  a.Sk = Sk;
  a.G = H / Kh;
  a.causal = causal;
  a.window = window;
  a.softcap = softcap;
  a.scale = scale;
  int64_t* dst[7] = {a.q, a.k, a.v, a.d, a.dq, a.dk, a.dv};
  const int src[7] = {0, 1, 2, 4, 5, 6, 7};    // o (3) feeds only delta
  for (int t = 0; t < 7; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = st[3 * src[t] + i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t err;
  if (dtype == 0)
    err = bwd::run<float>(hd, q, k, v, o, dout, l, dl, dq, dk, dv, B, H, Kh, st, a, s);
  else if (dtype == 1)
    err = bwd::run<__nv_bfloat16>(hd, q, k, v, o, dout, l, dl, dq, dk, dv, B, H, Kh, st, a, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The tensor-core backward: bf16 only, head dim 64, 128, 192 or 256. st: the 24
// element strides (b, s, h) of q, k, v, o, do, dq, dk, dv as
// flash_attention_bwd's; q, k, v and do are read by TMA, so each must start
// on 16 bytes with strides that are multiples of 8 elements. lse [B,Sq,H]
// fp32 contiguous; scratch [2][B][H][Sqp] fp32 with Sqp = Sq rounded up to
// 128 (lse * log2(e), then delta); part [2][n_split][B][Sk][Kh][hd] fp32
// when n_split > 1 (n_split divides H / Kh), else null. Launches the delta,
// dk/dv, (split reduction) and dq kernels in order on the stream; returns
// 10000 + the CUresult when a tensor map cannot be encoded.
extern "C" int flash_attention_bwd_tc(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* scratch, void* part, void* dq, void* dk, void* dv,
    int B, int Sq, int Sk, int H, int Kh, int hd, int n_split, const long long* st,
    int causal, int window, float softcap, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Kh <= 0 || H % Kh != 0 ||
      (Sk < Sq && (causal || window > 0)))   // masks right-align the queries
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd != 64 && hd != 128 && hd != 192 && hd != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Kh;
  if (n_split <= 0 || G % n_split != 0 || (n_split > 1) != (part != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int box = hd == 256 ? 32 : 64;                 // rows of a k/v box
  CUtensorMap tq, tk, tv, tdo;
  int res = sm90::encode_bf16_4d(&tq, q, hd, H, Sq, B, st[2], st[1], st[0], tcb::BQ);
  if (res == 0) res = sm90::encode_bf16_4d(&tk, k, hd, Kh, Sk, B, st[5], st[4], st[3], box);
  if (res == 0) res = sm90::encode_bf16_4d(&tv, v, hd, Kh, Sk, B, st[8], st[7], st[6], box);
  if (res == 0)
    res = sm90::encode_bf16_4d(&tdo, dout, hd, H, Sq, B, st[14], st[13], st[12], tcb::BQ);
  if (res != 0) return 10000 + res;
  tcb::Args a;
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.G = G;
  a.Sqp = (Sq + tcb::BQ_DQ - 1) / tcb::BQ_DQ * tcb::BQ_DQ;
  a.n_split = n_split;
  a.causal = causal;
  a.window = window;
  a.softcap = softcap;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse2 = static_cast<float*>(scratch);
  float* delta = lse2 + static_cast<int64_t>(B) * H * a.Sqp;
  const int64_t rows = static_cast<int64_t>(B) * H * a.Sqp;
  const int blocks = static_cast<int>((rows + bwd::NT / 32 - 1) / (bwd::NT / 32));
  bwd::flash_bwd_delta_kernel<__nv_bfloat16, true><<<blocks, bwd::NT, 0, s>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), delta, lse2, B, Sq, a.Sqp, H, hd, st[9], st[10],
      st[11], st[12], st[13], st[14]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  float* pf = static_cast<float*>(part);
  switch (hd) {
    case 64: err = tcb::launch<64>(tq, tk, tv, tdo, lse2, delta, pf, dq, dk, dv, st, a, s); break;
    case 128: err = tcb::launch<128>(tq, tk, tv, tdo, lse2, delta, pf, dq, dk, dv, st, a, s); break;
    case 192: err = tcb::launch<192>(tq, tk, tv, tdo, lse2, delta, pf, dq, dk, dv, st, a, s); break;
    default: err = tcb::launch<256>(tq, tk, tv, tdo, lse2, delta, pf, dq, dk, dv, st, a, s); break;
  }
  return static_cast<int>(err);
}
