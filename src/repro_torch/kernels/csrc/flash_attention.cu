// Flash-attention forward for Hopper (sm_90a), plain CUDA C++: two kernels.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (Pallas; grid (B, H, q-blocks, kv-blocks) with the kv dimension run in
// order and the online-softmax state in VMEM scratch).
//
// Both compute softmax(q.k^T * scale) . v with an fp32 online softmax:
//   q [B,Sq,H,hd], k/v [B,Sk,Kh,hd] -> o [B,Sq,H,hd] in q's dtype;
//   GQA (kv head h / (H/Kh)); queries right-aligned in the keys
//   (q_off = Sk - Sq); causal and sliding-window masks; tanh softcap.
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
// flash_fwd_tc_kernel (bf16, head dims 64/128/256; entry
// flash_attention_fwd_tc) does both products on the tensor cores:
//   * one CTA of three warpgroups per (b, h, 128-query tile): warpgroup 0
//     is the producer (one thread issues TMA loads, setmaxnreg gives its
//     registers away), warpgroups 1 and 2 are consumers of 64 query rows
//     each, with 240 registers per thread;
//   * the q tile is loaded once; k and v tiles of BK keys (128 at head dim
//     64/128, 64 at 256) come through a two-stage ring in shared memory,
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
// cudaGetLastError() after the launch (flash_attention_fwd_tc returns
// 10000 + the CUresult when a tensor map cannot be encoded).

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


// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 128;          // queries per CTA: 64 per consumer warpgroup
constexpr int NT = 384;          // producer warpgroup + two consumer warpgroups
constexpr int STAGES = 2;        // k/v ring depth
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int BK = HD == 256 ? 64 : 128;   // keys per tile
  static constexpr int CHUNKS = HD / 64;            // 64-wide columns of a row
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;      // one k or one v tile
  static constexpr int TILE_BYTES = Q_BYTES + 2 * STAGES * KV_BYTES;
  // barriers: q, full_k[STAGES], full_v[STAGES], empty[STAGES]
  static constexpr int SMEM = 1024 + TILE_BYTES + 8 * (1 + 3 * STAGES);
  static_assert(TILE_BYTES <= 227 * 1024 - 2048, "q plus the ring must fit");
};

template <int N> struct Wgmma;
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
template <> struct Wgmma<256> {
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t* a, uint64_t b) {
    sm90::wgmma_rs_n256(d, a, b, 1);
  }
};

template <int HD>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ o, int Sq, int Sk, int G,
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
      __nv_bfloat16* orow = ob + qi * o_ss + 2 * t4;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
    }
  }
}

template <int HD>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   void* o, int B, int Sq, int Sk, int H, int G, long long o_sb,
                   long long o_ss, long long o_sh, int causal, int window, float softcap,
                   float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  // the shared-memory opt-in, once per instantiation and device
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_tc_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_tc_kernel<HD><<<grid, NT, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Sk, G, o_sb, o_ss, o_sh,
      causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace tc

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

// bf16 only, head dim 64, 128 or 256. Strides are in elements; the last
// dimension of every tensor must have stride 1, q, k and v must start on
// 16 bytes and their other strides be multiples of 8 elements (TMA).
extern "C" int flash_attention_fwd_tc(
    const void* q, const void* k, const void* v, void* o,
    int B, int Sq, int Sk, int H, int Kh, int hd,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float softcap, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk < Sq || H <= 0 || Kh <= 0 || H % Kh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd != 64 && hd != 128 && hd != 256) return static_cast<int>(cudaErrorInvalidValue);
  const int bk = hd == 256 ? 64 : 128;
  CUtensorMap tq, tk, tv;
  int res = sm90::encode_bf16_4d(&tq, q, hd, H, Sq, B, q_sh, q_ss, q_sb, tc::BQ);
  if (res == 0) res = sm90::encode_bf16_4d(&tk, k, hd, Kh, Sk, B, k_sh, k_ss, k_sb, bk);
  if (res == 0) res = sm90::encode_bf16_4d(&tv, v, hd, Kh, Sk, B, v_sh, v_ss, v_sb, bk);
  if (res != 0) return 10000 + res;
  const int G = H / Kh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 64: err = tc::launch<64>(tq, tk, tv, o, B, Sq, Sk, H, G, o_sb, o_ss, o_sh, causal, window, softcap, scale, s); break;
    case 128: err = tc::launch<128>(tq, tk, tv, o, B, Sq, Sk, H, G, o_sb, o_ss, o_sh, causal, window, softcap, scale, s); break;
    default: err = tc::launch<256>(tq, tk, tv, o, B, Sq, Sk, H, G, o_sb, o_ss, o_sh, causal, window, softcap, scale, s); break;
  }
  return static_cast<int>(err);
}
