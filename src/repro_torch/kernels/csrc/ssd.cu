// Mamba-2 chunked SSD scan for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py::_kernel (Pallas; grid
// (b, head, chunk) with the chunk axis run in order and the [P,N] state in
// VMEM scratch), plus the D skip that the reference adds outside it.
//
// Computes, per (b, head h), with group g = h / (H/G), the recurrence
//   h_t = exp(-exp(A_log[h]) dt_t) h_{t-1} + dt_t x_t B_t^T,  y_t = h_t C_t
// blocked into chunks of Q rows. Within a chunk, with La the in-chunk
// prefix sum of -exp(A_log) dt:
//   y_i = sum_{j<=i} (C_i.B_j) exp(clip(La_i - La_j, -60, 0)) dt_j x_j   (intra)
//       + exp(La_i) C_i . h_in                                          (inter)
//       + D x_i                                                         (skip)
//   h_out = exp(La_last) h_in + sum_j exp(La_last - La_j) dt_j x_j B_j^T
// Inputs: x [b,S,H,P] and B, C [b,S,G,N] in float or bf16 (read in their
// dtype, computed in fp32), dt [b,S,H] fp32, A_log and D [H] fp32, h0
// [b,H,P,N] fp32 or null. Outputs: y [b,S,H,P] in x's dtype, rounded once
// after the D add, and h_final [b,H,P,N] fp32. (The reference's blocked
// path rounds y once too; its Pallas path rounds y to bf16 before the D
// add, so the two differ by at most one bf16 ulp.)
//
// What bounds it on an H100: the least arithmetic the function needs, that
// of the plain recurrence (about 4NP FLOP per row and head; a chunk of Q
// rows adds about Q(N+P)), is some 117 FLOP per byte moved at the
// mamba2-2.7b prefill shape (P=64, N=128), below the card's ~295 ridge, so
// bytes set the bound. This first kernel is the simple correct design, not
// the tensor core one:
//   * the chunk axis is sequential, and CUDA blocks run in no order, so one
//     CTA owns one (b, h, 32-wide block of P) and loops over the chunks
//     itself. Rows p of the state evolve independently (h[p,:] and y[:,p]
//     need only x[:,p]), so the P split is exact; it doubles the CTAs at
//     P=64 (160 for 80 heads on 132 SMs) at the cost of computing C.B^T
//     once per block;
//   * the chunk is Q=64 rows, not the caller's 256: at N=128 an fp32 [256,N]
//     tile of B alone is 128 KB. The function is the same for any Q (the
//     reference itself drops Q to gcd(S, 256)). B, C, x^T, the state rows
//     and the [Q,Q] decay-masked score tile live in dynamic shared memory,
//     111 KB at P-block 32, N=128, so two CTAs fit on an SM;
//   * a ragged tail (S % Q != 0) is masked, never padded in memory: rows
//     past S read as dt = 0, x = 0, B = C = 0, so they change neither the
//     state nor any real row, and only real rows are written;
//   * groups are indexed directly (h / (H/G)), without a per-head copy;
//   * the state rows a thread updates stay in its registers across chunks
//     and are mirrored into shared memory for the inter-chunk term;
//   * the products are fp32 FMA loops out of shared memory (float4 reads,
//     rows padded against bank conflicts). Known cost: no tensor cores, and
//     the score tile computes its masked upper half. wgmma/TMA are later work.
//
// Entry point: ssd_scan_fwd (plain C, loaded with ctypes). It launches on
// the given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;      // rows per chunk
constexpr int NT = 256;    // threads per CTA
constexpr int QS = Q + 4;  // row stride (floats) of the score tile and x^T

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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int PB, int N>
struct Cfg {
  static constexpr int NS = N + 4;            // row stride of B, C and the state
  // y phase: TX threads across the P block, TY across rows
  static constexpr int TX = PB < 16 ? PB : 16;
  static constexpr int TY = NT / TX;
  static constexpr int RY = Q / TY;           // rows per thread
  static constexpr int CX = PB / TX;          // columns per thread
  // state phase: items of (row p, four n); a thread's items share n
  static constexpr int N4 = N / 4;
  static constexpr int PSTEP = NT / N4;       // row step between a thread's items
  static constexpr int HS = (PB * N4 + NT - 1) / NT;   // items per thread
  static constexpr int SMEM_FLOATS = 2 * Q * NS + PB * NS + PB * QS + Q * QS + 4 * Q;
  static_assert(N % 4 == 0 && NT % N4 == 0, "state layout");
  static_assert(NT % TX == 0 && Q % TY == 0 && PB % TX == 0, "y layout");
  static_assert(Q == 64, "the prefix sum gives each lane of one warp two rows");
};

template <typename T, int PB, int N>
__global__ void __launch_bounds__(NT)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A_log, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ Dv,
               const float* __restrict__ h0, T* __restrict__ y,
               float* __restrict__ hT, int S, int H, int rep, int P,
               int64_t x_sb, int64_t x_ss, int64_t x_sh,
               int64_t dt_sb, int64_t dt_ss, int64_t dt_sh,
               int64_t B_sb, int64_t B_ss, int64_t B_sg,
               int64_t C_sb, int64_t C_ss, int64_t C_sg,
               int64_t y_sb, int64_t y_ss, int64_t y_sh) {
  using Cf = Cfg<PB, N>;
  constexpr int NS = Cf::NS;
  extern __shared__ float4 smem_f4[];
  float* sB = reinterpret_cast<float*>(smem_f4);   // [Q][NS]
  float* sC = sB + Q * NS;                          // [Q][NS]
  float* sH = sC + Q * NS;                          // [PB][NS] state entering the chunk
  float* sXT = sH + PB * NS;                        // [PB][QS] x^T
  float* sG = sXT + PB * QS;                        // [Q][QS] masked, decayed scores * dt_j
  float* sDt = sG + Q * QS;                         // [Q]
  float* sLa = sDt + Q;                             // [Q] in-chunk prefix of A*dt
  float* sE = sLa + Q;                              // [Q] exp(La_i)
  float* sW = sE + Q;                               // [Q] exp(La_last - La_j) * dt_j

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float A = -expf(A_log[h]);
  const float Dh = Dv != nullptr ? Dv[h] : 0.f;

  const T* xb = x + b * x_sb + h * x_sh + p0;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const T* Bb = Bm + b * B_sb + (h / rep) * B_sg;
  const T* Cb = Cm + b * C_sb + (h / rep) * C_sg;
  T* yb = y + b * y_sb + h * y_sh + p0;
  const int64_t h_off = (static_cast<int64_t>(b) * H + h) * P * N + static_cast<int64_t>(p0) * N;

  // this thread's state items: rows prow + PSTEP*k, columns 4*n4 .. 4*n4+3
  const int n4 = tid % Cf::N4;
  const int prow = tid / Cf::N4;
  float hr[Cf::HS][4];
#pragma unroll
  for (int k = 0; k < Cf::HS; ++k) {
    const int p = prow + Cf::PSTEP * k;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hr[k][e] = (h0 != nullptr && p < PB) ? h0[h_off + p * N + 4 * n4 + e] : 0.f;
      if (p < PB) sH[p * NS + 4 * n4 + e] = hr[k][e];
    }
  }

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int rows = min(Q, S - c0);
    __syncthreads();   // the previous chunk's readers are done

    for (int i = tid; i < Q * N; i += NT) {
      const int r = i / N, n = i % N;
      const bool ok = r < rows;
      sB[r * NS + n] = ok ? to_f(Bb[(c0 + r) * B_ss + n]) : 0.f;
      sC[r * NS + n] = ok ? to_f(Cb[(c0 + r) * C_ss + n]) : 0.f;
    }
    for (int i = tid; i < Q * PB; i += NT) {
      const int r = i / PB, p = i % PB;
      sXT[p * QS + r] = r < rows ? to_f(xb[(c0 + r) * x_ss + p]) : 0.f;
    }
    if (tid < 32) {   // one warp: dt, the prefix sum La, and its exponentials
      const int j0 = 2 * tid, j1 = j0 + 1;
      const float d0 = j0 < rows ? dtb[(c0 + j0) * dt_ss] : 0.f;
      const float d1 = j1 < rows ? dtb[(c0 + j1) * dt_ss] : 0.f;
      const float l0 = A * d0, l1 = A * d1;
      float s = l0 + l1;   // inclusive scan of the lanes' pair sums
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, s, o);
        if (tid >= o) s += t;
      }
      float before = __shfl_up_sync(0xffffffffu, s, 1);
      if (tid == 0) before = 0.f;
      const float La0 = before + l0;
      const float La1 = La0 + l1;
      const float last = __shfl_sync(0xffffffffu, La1, 31);
      sDt[j0] = d0;
      sDt[j1] = d1;
      sLa[j0] = La0;
      sLa[j1] = La1;
      sE[j0] = expf(La0);
      sE[j1] = expf(La1);
      sW[j0] = expf(last - La0) * d0;
      sW[j1] = expf(last - La1) * d1;
    }
    __syncthreads();

    // scores: sG[i][j] = (C_i . B_j) exp(clip(La_i - La_j, -60, 0)) dt_j, j <= i
    {
      const int sx = tid & 15, sy = tid >> 4;
      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          cv[a] = *reinterpret_cast<const float4*>(&sC[(sy + 16 * a) * NS + n]);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          bv[c] = *reinterpret_cast<const float4*>(&sB[(sx + 16 * c) * NS + n]);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[a][c] = dot4(cv[a], bv[c], s[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = sy + 16 * a, j = sx + 16 * c;
          float v = 0.f;
          if (j <= i)
            v = s[a][c] * expf(fminf(fmaxf(sLa[i] - sLa[j], -60.f), 0.f)) * sDt[j];
          sG[i * QS + j] = v;
        }
    }
    __syncthreads();

    // y = intra (G . x) + exp(La_i) C_i . h_in + D x, rounded once
    {
      const int tx = tid % Cf::TX, ty = tid / Cf::TX;
      float acc[Cf::RY][Cf::CX], inter[Cf::RY][Cf::CX];
#pragma unroll
      for (int a = 0; a < Cf::RY; ++a)
#pragma unroll
        for (int c = 0; c < Cf::CX; ++c) acc[a][c] = inter[a][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < Q; j += 4) {
        float4 gv[Cf::RY], xv[Cf::CX];
#pragma unroll
        for (int a = 0; a < Cf::RY; ++a)
          gv[a] = *reinterpret_cast<const float4*>(&sG[(ty + Cf::TY * a) * QS + j]);
#pragma unroll
        for (int c = 0; c < Cf::CX; ++c)
          xv[c] = *reinterpret_cast<const float4*>(&sXT[(tx + Cf::TX * c) * QS + j]);
#pragma unroll
        for (int a = 0; a < Cf::RY; ++a)
#pragma unroll
          for (int c = 0; c < Cf::CX; ++c) acc[a][c] = dot4(gv[a], xv[c], acc[a][c]);
      }
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        float4 cv[Cf::RY], hv[Cf::CX];
#pragma unroll
        for (int a = 0; a < Cf::RY; ++a)
          cv[a] = *reinterpret_cast<const float4*>(&sC[(ty + Cf::TY * a) * NS + n]);
#pragma unroll
        for (int c = 0; c < Cf::CX; ++c)
          hv[c] = *reinterpret_cast<const float4*>(&sH[(tx + Cf::TX * c) * NS + n]);
#pragma unroll
        for (int a = 0; a < Cf::RY; ++a)
#pragma unroll
          for (int c = 0; c < Cf::CX; ++c) inter[a][c] = dot4(cv[a], hv[c], inter[a][c]);
      }
#pragma unroll
      for (int a = 0; a < Cf::RY; ++a) {
        const int i = ty + Cf::TY * a;
        if (i >= rows) continue;
#pragma unroll
        for (int c = 0; c < Cf::CX; ++c) {
          const int p = tx + Cf::TX * c;
          const float v = acc[a][c] + sE[i] * inter[a][c] + Dh * sXT[p * QS + i];
          yb[(c0 + i) * y_ss + p] = from_f<T>(v);
        }
      }
    }

    // state: h = exp(La_last) h_in + sum_j (x_j w_j) B_j
    {
      float st[Cf::HS][4];
#pragma unroll
      for (int k = 0; k < Cf::HS; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[k][e] = 0.f;
#pragma unroll 4
      for (int j = 0; j < Q; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(&sB[j * NS + 4 * n4]);
        const float w = sW[j];
#pragma unroll
        for (int k = 0; k < Cf::HS; ++k) {
          const int p = prow + Cf::PSTEP * k;
          if (p >= PB) continue;
          const float xw = sXT[p * QS + j] * w;
          st[k][0] = fmaf(xw, bv.x, st[k][0]);
          st[k][1] = fmaf(xw, bv.y, st[k][1]);
          st[k][2] = fmaf(xw, bv.z, st[k][2]);
          st[k][3] = fmaf(xw, bv.w, st[k][3]);
        }
      }
      const float decay = expf(sLa[Q - 1]);
      __syncthreads();   // every reader of h_in (the y phase) is done
#pragma unroll
      for (int k = 0; k < Cf::HS; ++k) {
        const int p = prow + Cf::PSTEP * k;
        if (p >= PB) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hr[k][e] = fmaf(decay, hr[k][e], st[k][e]);
          sH[p * NS + 4 * n4 + e] = hr[k][e];
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < Cf::HS; ++k) {
    const int p = prow + Cf::PSTEP * k;
    if (p >= PB) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) hT[h_off + p * N + 4 * n4 + e] = hr[k][e];
  }
}

struct Args {
  const void *x, *dt, *A_log, *B, *C, *D, *h0;
  void *y, *hT;
  int b, S, H, G, P;
  const long long* st;   // x, dt, B, C, y strides: 3 each
};

template <typename T, int PB, int N>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using Cf = Cfg<PB, N>;
  const int smem = Cf::SMEM_FLOATS * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<T, PB, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.P / PB, a.H, a.b);
  const long long* s = a.st;
  ssd_fwd_kernel<T, PB, N><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A_log), static_cast<const T*>(a.B),
      static_cast<const T*>(a.C), static_cast<const float*>(a.D),
      static_cast<const float*>(a.h0), static_cast<T*>(a.y),
      static_cast<float*>(a.hT), a.S, a.H, a.H / a.G, a.P,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
      s[9], s[10], s[11], s[12], s[13], s[14]);
  return cudaGetLastError();
}

template <typename T, int PB>
cudaError_t dispatch_n(int N, const Args& a, cudaStream_t stream) {
  switch (N) {
    case 8: return launch<T, PB, 8>(a, stream);
    case 16: return launch<T, PB, 16>(a, stream);
    case 128: return launch<T, PB, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_p(int N, const Args& a, cudaStream_t stream) {
  switch (a.P) {
    case 8: return dispatch_n<T, 8>(N, a, stream);
    case 16: return dispatch_n<T, 16>(N, a, stream);
    case 32:
    case 64: return dispatch_n<T, 32>(N, a, stream);   // P-blocks of 32
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16. dt, A_log, D, h0 and
// h_final are float32; D and h0 may be null. Strides are in elements; x, B
// and C must have a unit stride in their last dimension, h0 and h_final are
// contiguous [b,H,P,N].
extern "C" int ssd_scan_fwd(
    const void* x, const void* dt, const void* A_log, const void* B,
    const void* C, const void* D, const void* h0, void* y, void* hT,
    int dtype, int b, int S, int H, int G, int P, int N,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long B_sb, long long B_ss, long long B_sg,
    long long C_sb, long long C_ss, long long C_sg,
    long long y_sb, long long y_ss, long long y_sh, void* stream) {
  if (b <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[15] = {x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
                            B_sb, B_ss, B_sg, C_sb, C_ss, C_sg,
                            y_sb, y_ss, y_sh};
  const Args a{x, dt, A_log, B, C, D, h0, y, hT, b, S, H, G, P, st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_p<float>(N, a, s);
  else if (dtype == 1)
    err = dispatch_p<__nv_bfloat16>(N, a, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
