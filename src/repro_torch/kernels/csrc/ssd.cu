// Mamba-2 chunked SSD scan for Hopper (sm_90a), plain CUDA C++: two designs.
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
// Inputs: x [b,S,H,P] and B, C [b,S,G,N] in float or bf16, dt [b,S,H] fp32,
// A_log and D [H] fp32, h0 [b,H,P,N] fp32 or null. Outputs: y [b,S,H,P] in
// x's dtype, rounded once after the D add, and h_final [b,H,P,N] fp32.
// (The reference's blocked path rounds y once too; its Pallas path rounds y
// to bf16 before the D add, so the two differ by at most one bf16 ulp.) The
// function is the same for any Q; a ragged tail (S % Q != 0) is masked,
// never padded in memory: rows past S read as dt = 0, x = B = C = 0, so
// they change neither the state nor any real row, and only real rows are
// written. Groups are indexed directly (h / (H/G)), without a per-head copy.
//
// What bounds it on an H100: the least arithmetic the function needs, that
// of the plain recurrence (about 4NP FLOP per row and head), is some 117
// FLOP per byte moved at the mamba2-2.7b prefill shape (P=64, N=128),
// below the card's ~295 ridge, so bytes set the bound: 46 MB at S=2048.
//
// Tensor-core design (bf16, P in {16, 32, 64}, N in {16, 128}; entry
// ssd_scan_fwd_tc): the chunk-parallel form of the state-space dual in two
// kernels on one stream, Q = 128 rows per chunk:
//   1. ssd_fwd_state_kernel, one CTA of two warpgroups per (b, h, 64-wide
//      block of N): warpgroup w takes chunks 2r + w. For its chunk, warp 0
//      computes La by a warp scan in fp32 and the weights w_j =
//      exp(La_last - La_j) dt_j (and, in the first block of N, the output
//      kernel's La, dt and decay factors into the scratch), x and B come in
//      by TMA, and S_c = (w o x)^T . B is a wgmma m64n64k16 with (w o x)^T
//      rounded to bf16 as the register A operand, built a k-step ahead, and
//      B read MN-major. The two warpgroups' products run at once; only
//      h_in[c+1] = exp(La_last) h_in[c] + S_c, in fp32, passes from one to
//      the other through shared memory under named barriers. Each writes
//      h_in[c] in bf16 (through shared memory, in 16-byte rows) to the
//      scratch and the last chunk's h to h_final. The next chunk's TMA
//      loads go out as soon as a product is done.
//   2. ssd_fwd_out_kernel, one CTA of two warpgroups (64 rows each) per
//      (b, h, chunk): C, B, x, h_in[c] by TMA and the chunk's La, dt and
//      decay factors by a bulk copy, on one mbarrier; acc = C . h_in^T and
//      the first block of scores C . B^T as SS wgmmas, acc scaled by
//      exp(La_i) per row; then for each 64-column block at or left of the
//      diagonal (blocks wholly above it are skipped) the decay mask and dt_j
//      applied in registers (the block left of the diagonal factors its
//      decay through row 63 into exp(La_i - La_63) exp(La_63 - La_j), both
//      at most 1, so it takes no exponential per element and only the
//      floor exp(-60) from the clip), the block rounded to bf16 as the
//      register A operand of acc += G . x (x read MN-major); y = acc + D x,
//      rounded once, out through the warpgroup's own rows of C in 16-byte
//      rows.
//   A tile narrower than 64 values (P or N of 16 or 32) is a 64-wide TMA box
//   whose columns past the tensor read as zeros.
//   Why not three passes (chunk states to an fp32 scratch, a sequential
//   pass over it, then the outputs): on the H100 that form moved 84 MB of
//   fp32 chunk states through device memory at the served shape and took
//   0.138 ms (PERF.md); here the states stay in registers and shared
//   memory, and only h_in (bf16, 21 MB) goes through the scratch.
//   Known costs: both kernels are bound by latency, not by bytes or
//   operations (PERF.md): the state kernel walks its chunks in order (16 at
//   S=2048) with 160 CTAs for 132 SMs, and an output CTA loads, multiplies
//   and stores in turn; x is read by both blocks of N and again by the
//   outputs, and C and B once per head from L2; (w o x), the masked score
//   blocks and h_in are rounded to bf16 for the tensor cores (about 2e-3
//   relative L2 on y at the served shape).
//
// FMA design (fp32 at every size, the tensor cores would round it to
// TF32; bf16 at P or N = 8; entry ssd_scan_fwd): ssd_fwd_kernel, one CTA
// per (b, h, 32-wide block of P) loops over chunks of 64 rows itself and
// carries its rows of the state in fp32 registers; B, C, x^T, the state
// rows and the [64,64] decay-masked score tile in shared memory; the
// products as fp32 FMA loops (the masked half of the score tile computed).
//
// Entry points: plain C, loaded with ctypes. They launch on the given
// stream, allocate nothing, do not synchronise, and return
// cudaGetLastError() after the launches (ssd_scan_fwd_tc returns 10000 +
// the CUresult when a tensor map cannot be encoded).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

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

// ---------------------------------------------------------------------------
// Tensor-core design (bf16)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int Q = 128;                // rows per chunk
constexpr int TILE = Q * 128;         // bytes of a 64-wide bf16 column block of Q rows
constexpr int H_TILE = 64 * 128;      // bytes of a 64-wide column block of h_in (64 rows)
constexpr float EXP_M60 = 8.75651076e-27f;   // exp(-60), the decay's floor
constexpr int AUX = 3 * 4 * Q;        // bytes of a chunk's La, dt and decay factors

template <int N>
struct Cfg {
  static constexpr int NB = (N + 63) / 64;   // 64-wide column blocks of a row of B, C, h_in
  static constexpr int NK = N / 16;          // k-steps of a product over n
  // state kernel, per warpgroup: x and one 64-wide column block of B, h_in
  // of its chunk in bf16 on its way out, the chunk's weights w [Q] and
  // exp(La_last), a barrier; h passed between the warpgroups
  static constexpr int ST_STAGE = 2 * TILE + H_TILE;
  static constexpr int ST_W = Q + 4;
  static constexpr int ST_HX = 32 * 128 * 4;
  static constexpr int ST_SMEM = 1024 + 2 * ST_STAGE + ST_HX + 16 + 2 * 4 * ST_W;
  // output kernel: C, B (NB blocks each), x, h_in (NB blocks); the chunk's
  // La, dt and off-diagonal decay factors [Q] each (AUX bytes); barrier
  static constexpr int OUT_TILES = (2 * NB + 1) * TILE + NB * H_TILE;
  static constexpr int OUT_SMEM = 1024 + OUT_TILES + AUX + 16;
  static_assert(N % 16 == 0 && N <= 128, "N");
  static_assert(2 * (OUT_SMEM + 1024) <= 228 * 1024, "two output CTAs per SM");
  static_assert(2 * (ST_SMEM + 1024) <= 228 * 1024, "two state CTAs per SM");
};

// The byte offset of element (row, col) in a tile of 128-byte rows loaded by
// TMA with the 128-byte swizzle (16-byte chunks XORed with row % 8).
__device__ __forceinline__ int swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ (row & 7))) << 4) + ((col & 7) << 1);
}

__device__ __forceinline__ float tile_at(const uint8_t* tile, int row, int col) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(tile + swz(row, col)));
}

// One lane's four rows (4 lane .. 4 lane + 3) of a chunk's dt, 0 past `rows`.
__device__ __forceinline__ void load_dt(const float* dtc, int64_t dt_ss, int rows, int lane,
                                        float (&d)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = 4 * lane + k;
    d[k] = r < rows ? dtc[r * dt_ss] : 0.f;
  }
}

// One warp: La, the inclusive prefix of A dt over the chunk, for the rows of
// load_dt.
__device__ __forceinline__ void chunk_prefix(const float (&d)[4], float A, int lane,
                                             float (&La)[4]) {
  float l[4], tot = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    l[k] = A * d[k];
    tot += l[k];
  }
  float s = tot;   // inclusive scan of the lanes' sums
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += t;
  }
  float before = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) before = 0.f;
  La[0] = before + l[0];
#pragma unroll
  for (int k = 1; k < 4; ++k) La[k] = La[k - 1] + l[k];
}

// 1. Chunk states and the state pass: one CTA of two warpgroups per (b, h,
//    64-wide block of N). Warpgroup w takes chunks c = 2r + w: warp 0 of it
//    computes the chunk's La by a warp scan and its weights
//    w_j = exp(La_last - La_j) dt_j into shared memory (and, in the first
//    block of N, the output kernel's La, dt and decay factors into the
//    scratch), thread 0 brings x and B in by TMA, and the warpgroup runs
//    S_c = (w o x)^T . B by wgmma. The two products run at once; only the
//    recurrence h = exp(La_last) h + S_c passes from one warpgroup to the
//    other, through shared memory under named barriers, and each writes
//    h_in[c] in bf16 after it has passed h on. As soon as a product is done
//    its stage takes the TMA loads of the warpgroup's next chunk, and the dt
//    of the one after is loaded while this one runs.
template <int N>
__global__ void __launch_bounds__(256, 2)
ssd_fwd_state_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_b, const float* __restrict__ dt,
                     const float* __restrict__ A_log, const float* __restrict__ h0,
                     __nv_bfloat16* __restrict__ h_in, float* __restrict__ aux,
                     float* __restrict__ hT, int S, int H, int rep, int P, int64_t dt_sb,
                     int64_t dt_ss, int64_t dt_sh) {
  using Cf = Cfg<N>;
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms need 1024-byte alignment
  uint8_t* sm = smem_raw + ((1024u - (sm90::smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = sm90::smem_u32(sm);
  float* sHx = reinterpret_cast<float*>(sm + 2 * Cf::ST_STAGE);   // [32][128]: h passed on
  const uint32_t full = base + 2 * Cf::ST_STAGE + Cf::ST_HX;      // + 8 w
  float* sW = reinterpret_cast<float*>(sm + 2 * Cf::ST_STAGE + Cf::ST_HX + 16);   // [2][ST_W]

  const int tid = threadIdx.x;
  const int wg = tid / 128, t = tid % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, t4 = lane % 4;
  const int nb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = (S + Q - 1) / Q;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const uint32_t stage = base + wg * Cf::ST_STAGE;
  const uint32_t bar = full + 8 * wg;
  float* w = sW + wg * Cf::ST_W;
  const float A = -expf(A_log[h]);
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  auto dt_of = [&](int c, float (&d)[4]) {   // zeros past the last chunk
    load_dt(dtb + static_cast<int64_t>(c) * Q * dt_ss, dt_ss, min(Q, S - c * Q), lane, d);
  };
  // named barriers: 1 + wg within a warpgroup, 3 + wg for h handed to it
  auto wg_sync = [&]() {
    if (wg == 0) sm90::named_sync<1>(128); else sm90::named_sync<2>(128);
  };
  auto issue = [&](int c) {
    sm90::mbar_arrive_expect_tx(bar, 2 * TILE);
    sm90::tma_load_4d(stage, &tm_x, bar, 0, h, c * Q, b);
    sm90::tma_load_4d(stage + TILE, &tm_b, bar, 64 * nb, h / rep, c * Q, b);
  };

  if (tid == 0) {
    sm90::mbar_init(full, 1);
    sm90::mbar_init(full + 8, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (t == 0 && wg < nc) issue(wg);
  float d[4], dn[4];
  if (warp == 0) {
    dt_of(wg, d);
    dt_of(wg + 2, dn);
  }

  // this thread's state entries: rows p0, p0 + 8; columns n0 + 8 (i/4) + 2 t4 + (i&1)
  const int p0 = 16 * warp + g;
  const int n0 = 64 * nb;

  for (int c = wg, r = 0; c < nc; c += 2, ++r) {
    if (warp == 0) {
      float La[4];
      chunk_prefix(d, A, lane, La);
      const float last = __shfl_sync(0xffffffffu, La[3], 31);
#pragma unroll
      for (int k = 0; k < 4; ++k) w[4 * lane + k] = expf(last - La[k]) * d[k];
      if (lane == 0) w[Q] = expf(last);
      if (nb == 0) {   // the output kernel's La, dt and decay factors of the chunk
        const float mid = __shfl_sync(0xffffffffu, La[3], 15);   // La of row 63
        float4 e;
        e.x = lane < 16 ? expf(mid - La[0]) : expf(La[0] - mid);
        e.y = lane < 16 ? expf(mid - La[1]) : expf(La[1] - mid);
        e.z = lane < 16 ? expf(mid - La[2]) : expf(La[2] - mid);
        e.w = lane < 16 ? expf(mid - La[3]) : expf(La[3] - mid);
        float4* ax = reinterpret_cast<float4*>(aux + (bh * nc + c) * (AUX / 4));
        ax[lane] = make_float4(La[0], La[1], La[2], La[3]);
        ax[Q / 4 + lane] = make_float4(d[0], d[1], d[2], d[3]);
        ax[Q / 2 + lane] = e;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] = dn[k];
      dt_of(c + 4, dn);
    }
    wg_sync();   // the weights are set
    sm90::mbar_wait(bar, r & 1);

    // (w o x)^T as the register A operand (rows p, k = the chunk's rows j),
    // built a k-step at a time into two alternating sets of registers while
    // the previous k-step's product runs
    const uint8_t* xt = sm + wg * Cf::ST_STAGE;
    const float dec = w[Q];
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    uint32_t a[2][4];
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p0 + 8 * (q & 1), j = 16 * kk + 2 * t4 + 8 * (q >> 1);
        a[kk & 1][q] = sm90::pack_bf16(w[j] * tile_at(xt, j, p), w[j + 1] * tile_at(xt, j + 1, p));
      }
      if (kk >= 2) sm90::wgmma_wait<1>();   // the product that read a[kk & 1] is done
      sm90::wgmma_fence();
      // B [j, n] is MN-major
      sm90::wgmma_rs_n64(acc, a[kk & 1], sm90::desc_sw128(stage + TILE + kk * 16 * 128, TILE, 1024), 1);
      sm90::wgmma_commit();
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    wg_sync();   // stage and weights are read
    if (t == 0 && c + 2 < nc) issue(c + 2);

    // h entering the chunk comes from the other warpgroup (h0 for chunk 0);
    // it is kept in bf16 for h_in[c], then h = exp(La_last) h + S_c is
    // passed on
    float hr[32];
    if (c > 0) {
      if (wg == 0) sm90::named_sync<3>(256); else sm90::named_sync<4>(256);
#pragma unroll
      for (int i = 0; i < 32; ++i) hr[i] = sHx[i * 128 + t];
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int p = p0 + 8 * ((i >> 1) & 1), n = n0 + 8 * (i / 4) + 2 * t4 + (i & 1);
        hr[i] = (h0 != nullptr && p < P && n < N) ? h0[(bh * P + p) * N + n] : 0.f;
      }
    }
    uint8_t* hb = sm + wg * Cf::ST_STAGE + 2 * TILE;   // [64][64] bf16, swizzled
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int p = p0 + 8 * ((i >> 1) & 1), n = 8 * (i / 4) + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(hb + swz(p, n)) = __floats2bfloat162_rn(hr[i], hr[i + 1]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) hr[i] = fmaf(dec, hr[i], acc[i]);
    if (c + 1 < nc) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sHx[i * 128 + t] = hr[i];
      if (wg == 0) sm90::named_arrive<4>(256); else sm90::named_arrive<3>(256);
    }
    // h_in[c] out in rows of 16 bytes, after h is passed on
    wg_sync();
    __nv_bfloat16* hc = h_in + (bh * nc + c) * P * N + n0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = t + 128 * m, p = k / 8, n = 8 * (k % 8);
      if (p < P && n0 + n < N)
        *reinterpret_cast<uint4*>(hc + p * N + n) = *reinterpret_cast<const uint4*>(hb + swz(p, n));
    }
    if (c + 1 == nc) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int p = p0 + 8 * ((i >> 1) & 1), n = n0 + 8 * (i / 4) + 2 * t4;
        if (p < P && n < N)
          *reinterpret_cast<float2*>(hT + (bh * P + p) * N + n) = make_float2(hr[i], hr[i + 1]);
      }
    }
  }
}

// 2. Outputs, one CTA of two warpgroups (64 rows each) per (b, h, chunk):
//    y = exp(La_i) C_i . h_in + sum_{j<=i} G_ij x_j + D x_i. The decay of the
//    block left of the diagonal (rows 64..127, columns 0..63) factors
//    through row 63 into exp(La_i - La_63) exp(La_63 - La_j), both at most
//    1, so it needs no exponential per element; the diagonal blocks take
//    exp(clip(La_i - La_j, -60, 0)) per element, skipped where a warp's
//    rows all lie above the column.
template <int N>
__global__ void __launch_bounds__(256, 2)
ssd_fwd_out_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_c,
                   const __grid_constant__ CUtensorMap tm_h, const float* __restrict__ aux,
                   const float* __restrict__ Dv, __nv_bfloat16* __restrict__ y, int S, int H,
                   int rep, int P, int64_t y_sb, int64_t y_ss, int64_t y_sh) {
  using Cf = Cfg<N>;
  constexpr int NB = Cf::NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (sm90::smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sC = sm90::smem_u32(sm);
  const uint32_t sB = sC + NB * TILE;
  const uint32_t sX = sB + NB * TILE;
  const uint32_t sH = sX + TILE;
  const uint32_t sAux = sH + NB * H_TILE;
  const uint32_t bar = sAux + AUX;
  const uint8_t* xtile = sm + 2 * NB * TILE;
  const float* sLa = reinterpret_cast<const float*>(sm + Cf::OUT_TILES);
  const float* sDt = sLa + Q;
  // rows j < 64: exp(La_63 - La_j); rows i >= 64: exp(La_i - La_63)
  const float* sE = sDt + Q;

  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int rows = min(Q, S - c * Q);

  if (tid == 0) {
    sm90::mbar_init(bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    const int grp = h / rep;
    const int bhc = (b * H + h) * nc + c;
    sm90::mbar_arrive_expect_tx(bar, Cf::OUT_TILES + AUX);
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      sm90::tma_load_4d(sC + cb * TILE, &tm_c, bar, 64 * cb, grp, c * Q, b);
      sm90::tma_load_4d(sB + cb * TILE, &tm_b, bar, 64 * cb, grp, c * Q, b);
      sm90::tma_load_4d(sH + cb * H_TILE, &tm_h, bar, 64 * cb, 0, 0, bhc);
    }
    sm90::tma_load_4d(sX, &tm_x, bar, 0, h, c * Q, b);
    sm90::bulk_load(sAux, aux + static_cast<int64_t>(bhc) * (AUX / 4), AUX, bar);
  }
  sm90::mbar_wait(bar, 0);

  const int wg = tid / 128;                   // rows 64 wg .. 64 wg + 63
  const int warp = (tid / 32) % 4, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int r0 = 64 * wg + 16 * warp + g;     // this thread's rows: r0, r0 + 8
  const int rmax = 64 * wg + 16 * warp + 15;  // the warp's last row
  const uint32_t c_rows = sC + wg * 64 * 128;
  const float La0 = sLa[r0], La1 = sLa[r0 + 8];

  // inter (acc = C . h_in^T) and the scores of the first block, together
  float acc[32], sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = sc[i] = 0.f;
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Cf::NK; ++kk) {
    const int cb = kk / 4, w = kk % 4;
    const uint64_t da = sm90::desc_sw128(c_rows + cb * TILE + 32 * w, 16, 1024);
    sm90::wgmma_ss_n64(acc, da, sm90::desc_sw128(sH + cb * H_TILE + 32 * w, 16, 1024), 1);
    sm90::wgmma_ss_n64(sc, da, sm90::desc_sw128(sB + cb * TILE + 32 * w, 16, 1024), 1);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  sm90::fence_regs(sc);
  const float e0 = expf(La0), e1 = expf(La1);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] *= ((i >> 1) & 1) ? e1 : e0;

  // intra: the 64-column blocks at or left of the diagonal
  for (int jb = 0; jb <= wg; ++jb) {
    if (jb > 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Cf::NK; ++kk) {
        const int cb = kk / 4, w = kk % 4;
        sm90::wgmma_ss_n64(sc, sm90::desc_sw128(c_rows + cb * TILE + 32 * w, 16, 1024),
                           sm90::desc_sw128(sB + cb * TILE + jb * 64 * 128 + 32 * w, 16, 1024),
                           1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
    }
    // G_ij = (C_i . B_j) exp(clip(La_i - La_j, -60, 0)) dt_j for j <= i
    if (jb == wg) {   // the diagonal block
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = 64 * jb + 8 * (i / 4) + 2 * t4 + (i & 1);
        const bool hi = (i >> 1) & 1;
        const int r = r0 + 8 * hi;
        const float lr = hi ? La1 : La0;
        float v = 0.f;
        if (64 * jb + 8 * (i / 4) <= rmax && j <= r)   // the first test is warp-uniform
          v = sc[i] * expf(fminf(fmaxf(lr - sLa[j], -60.f), 0.f)) * sDt[j];
        sc[i] = v;
      }
    } else {          // rows 64..127, columns 0..63
      const float f0 = sE[r0], f1 = sE[r0 + 8];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = 8 * (i / 4) + 2 * t4 + (i & 1);
        const float fr = ((i >> 1) & 1) ? f1 : f0;
        sc[i] *= fminf(fmaxf(fr * sE[j], EXP_M60), 1.f) * sDt[j];
      }
    }
    uint32_t pf[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) pf[i] = sm90::pack_bf16(sc[2 * i], sc[2 * i + 1]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // x [j, p] is MN-major
      sm90::wgmma_rs_n64(acc, &pf[4 * kk],
                         sm90::desc_sw128(sX + jb * 64 * 128 + kk * 16 * 128, TILE, 1024), 1);
    sm90::wgmma_commit();
    if (jb < wg) {
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
    }
  }

  // y = acc + D x, one rounding to bf16, rows below S and columns below P;
  // D x is read while the last product runs
  const float Dh = Dv != nullptr ? Dv[h] : 0.f;
  float dx[32];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    dx[i] = Dh * tile_at(xtile, r0 + 8 * ((i >> 1) & 1), 8 * (i / 4) + 2 * t4 + (i & 1));
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  // through the warpgroup's own rows of C, which no product reads any more,
  // out in rows of 16 bytes
  uint8_t* yt = sm + wg * 64 * 128;   // [64][64] bf16, swizzled
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = 16 * warp + g + 8 * ((i >> 1) & 1), p = 8 * (i / 4) + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(yt + swz(r, p)) =
        __floats2bfloat162_rn(acc[i] + dx[i], acc[i + 1] + dx[i + 1]);
  }
  if (wg == 0) sm90::named_sync<1>(128); else sm90::named_sync<2>(128);
  const int t = tid % 128;
  __nv_bfloat16* yb = y + b * y_sb + h * y_sh + (static_cast<int64_t>(c) * Q + 64 * wg) * y_ss;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int k = t + 128 * m, r = k / 8, p = 8 * (k % 8);
    if (64 * wg + r < rows && p < P)
      *reinterpret_cast<uint4*>(yb + r * y_ss + p) = *reinterpret_cast<const uint4*>(yt + swz(r, p));
  }
}

// the shared-memory opt-in, once per kernel and device
template <typename K>
cudaError_t opt_in(K kernel, int smem, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int N>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tb, const CUtensorMap& tcm,
                   const CUtensorMap& th, const float* dt, const float* A_log,
                   const float* Dv, const float* h0, __nv_bfloat16* y, float* hT,
                   __nv_bfloat16* h_in, float* aux, int b, int S, int H, int G, int P,
                   const long long* st, cudaStream_t stream) {
  using Cf = Cfg<N>;
  static bool state_set[64] = {}, out_set[64] = {};
  cudaError_t err = opt_in(ssd_fwd_state_kernel<N>, Cf::ST_SMEM, state_set);
  if (err == cudaSuccess) err = opt_in(ssd_fwd_out_kernel<N>, Cf::OUT_SMEM, out_set);
  if (err != cudaSuccess) return err;
  const int rep = H / G;
  ssd_fwd_state_kernel<N><<<dim3(Cf::NB, H, b), 256, Cf::ST_SMEM, stream>>>(
      tx, tb, dt, A_log, h0, h_in, aux, hT, S, H, rep, P, st[0], st[1], st[2]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_fwd_out_kernel<N><<<dim3((S + Q - 1) / Q, H, b), 256, Cf::OUT_SMEM, stream>>>(
      tx, tb, tcm, th, aux, Dv, y, S, H, rep, P, st[3], st[4], st[5]);
  return cudaGetLastError();
}

}  // namespace tc

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

// bf16 only, P in {16, 32, 64}, N in {16, 128}. dt, A_log, D, h0 and
// h_final are float32; D and h0 may be null; h0 and h_final are contiguous
// [b,H,P,N]. Strides are in elements; x, B and C must have a unit stride in
// their last dimension, start on 16 bytes and have their other strides in
// multiples of 8 elements (TMA); so must y, which is written in 16-byte rows.
// `scratch` (on 16 bytes) holds b * H * ceil(S/128) chunks' entering states
// (P * N bf16 values each), then their La, dt and decay factors (3 * 128
// floats each).
extern "C" int ssd_scan_fwd_tc(
    const void* x, const void* dt, const void* A_log, const void* B, const void* C,
    const void* D, const void* h0, void* y, void* hT, void* scratch,
    int b, int S, int H, int G, int P, int N,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long B_sb, long long B_ss, long long B_sg,
    long long C_sb, long long C_ss, long long C_sg,
    long long y_sb, long long y_ss, long long y_sh, void* stream) {
  if (b <= 0 || b > 65535 || S <= 0 || H <= 0 || H > 65535 || G <= 0 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((P != 16 && P != 32 && P != 64) || (N != 16 && N != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nc = (S + tc::Q - 1) / tc::Q;
  if (static_cast<long long>(b) * H * nc >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  __nv_bfloat16* h_in = static_cast<__nv_bfloat16*>(scratch);
  float* aux = reinterpret_cast<float*>(h_in + static_cast<long long>(b) * H * nc * P * N);
  CUtensorMap tx, tb, tcm, th;
  int res = sm90::encode_bf16_4d(&tx, x, P, H, S, b, x_sh, x_ss, x_sb, tc::Q);
  if (res == 0) res = sm90::encode_bf16_4d(&tb, B, N, G, S, b, B_sg, B_ss, B_sb, tc::Q);
  if (res == 0) res = sm90::encode_bf16_4d(&tcm, C, N, G, S, b, C_sg, C_ss, C_sb, tc::Q);
  // h_in [b*H*nc, P, N], read as 64-row boxes (rows past P are zeros)
  if (res == 0)
    res = sm90::encode_bf16_4d(&th, h_in, N, 1, P, b * H * nc, static_cast<long long>(P) * N,
                               N, static_cast<long long>(P) * N, 64);
  if (res != 0) return 10000 + res;
  const long long st[6] = {dt_sb, dt_ss, dt_sh, y_sb, y_ss, y_sh};
  const float* dtp = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(A_log);
  const float* Dp = static_cast<const float*>(D);
  const float* h0p = static_cast<const float*>(h0);
  __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(y);
  float* hTp = static_cast<float*>(hT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (N == 128)
    err = tc::launch<128>(tx, tb, tcm, th, dtp, al, Dp, h0p, yp, hTp, h_in, aux, b, S, H, G,
                          P, st, s);
  else
    err = tc::launch<16>(tx, tb, tcm, th, dtp, al, Dp, h0p, yp, hTp, h_in, aux, b, S, H, G,
                         P, st, s);
  return static_cast<int>(err);
}
