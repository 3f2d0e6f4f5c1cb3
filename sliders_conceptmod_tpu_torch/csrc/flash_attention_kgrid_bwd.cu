// K-grid flash-attention backward for Hopper (sm_90a): bidirectional (no
// mask), fp32 math, gradients in the input dtype, head dims 64..512
// (multiples of 64). The backward of K4a (flash_attention_kgrid.cu).
//
// K4b kgrid_bwd_dq_kernel replaces the TPU kernel
//   sliders_conceptmod_tpu/ops/flash_attention_kgrid.py::_bwd_dq_kernel
// (launched by _vjp_bwd): dQ = scale * sum_k dS K, accumulated over the key
// axis, with
//   P  = exp(scale * Q K^T - lse)     (recomputed from K4a's fp32 lse)
//   dP = dO V^T,  dS = P o (dP - delta),  delta = rowsum(dO o O).
// The JAX package computes delta with an XLA reduction outside its kernels
// (and stores it lane-replicated [BH, Sq, 128]); here K4b computes it in its
// prologue from the staged dO rows and writes it as fp32 [B*H, Sq] for K4c,
// as K2 does for K3.
//
// K4c kgrid_bwd_dkv_kernel replaces ::_bwd_dkv_kernel (launched by
// _vjp_bwd): per key tile, dV = sum_q P^T dO and dK = scale * sum_q dS^T Q,
// accumulated over the query axis. Query rows past Sq contribute nothing:
// their P is forced to 0, as the TPU kernel's row mask does.
//
// The TPU grids are (bh, q block, k block) with k sequential for dQ and
// (bh, k block, q block) with q sequential for dK/dV; the carry lives in
// VMEM scratch. On the card blocks run in parallel and in no order, so the
// sequential axis becomes a loop inside the block over 32-row tiles of the
// streamed operand (keys for K4b, queries for K4c), staged in shared memory,
// with the accumulators in registers. K4c may also split its query range
// across blocks (grid z) when the (key tile, batch*head) grid is too small
// for the 132 SMs (at Sk = 77 and 8 heads it is 24 blocks): each split
// writes fp32 partial dK/dV, and kgrid_dkv_merge_kernel sums them in split
// order. No float atomics: two runs give the same bits.
//
// Both: keys past Sk and query rows past Sq are staged as zeros and their P
// is selected to exactly 0 (never exp of a -1e30 score), so padding adds
// nothing and makes no NaN. Layout BSHD [B, S, H, D] with arbitrary batch /
// seq / head strides (in elements) and unit stride over D for every tensor,
// so autograd's dO (a slice of the padded output's gradient) goes in without
// a copy. dtypes float32 and bfloat16.
//
// What bounds it on the H100: K4b does 6*BH*Sq*Sk*D flops and K4c
// 8*BH*Sq*Sk*D against a few MB of q, k, v, o, dO, lse, delta and the
// gradients; at SD1.5's d-160 attentions (padded to 192; 256 or 64 tokens
// against 256, 64 or 77 keys) that is a few microseconds at the bf16
// tensor-core rate (989 TFLOP/s) and about as long at the memory rate.
// These first kernels do NOT reach it: like K1-K4a they keep fp32 math on
// the CUDA cores (67 TFLOP/s peak), and at these small shapes the grid is a
// fraction of the SMs. Design, for correctness first:
//   * 256 threads; each block owns R rows (q rows for K4b, key rows for
//     K4c) and TPR threads share a row: TPR = 8, R = 32 for D <= 256, and
//     TPR = 16, R = 16 above, so that the accumulators (D/TPR floats each,
//     at most 32; K4c keeps two) stay in registers and the staged tiles fit
//     the 227 KB of shared memory at D = 512 (about 200 KB);
//   * within a 32-row streamed tile, thread (r, c) takes rows c + TPR*j, so
//     the TPR lanes of a row reduce nothing but delta (shuffles) and write
//     their P / dS columns to shared memory, which only the row's own warp
//     reads back (a __syncwarp orders the two);
//   * tiles are staged as fp32 with rows padded by 4 floats (float4 reads
//     of 8 consecutive rows land on distinct banks), in 16-byte chunks with
//     up to 8 loads in flight per thread when every row starts 16-byte
//     aligned, element by element otherwise (as K4a stages);
//   * q is staged pre-scaled, as K4a stages it, so the recomputed scores
//     are K4a's to the bit: dQ multiplies by scale at the end, dK takes the
//     scaled q directly.
// Tensor cores (wgmma) with TMA-fed tiles are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int BS = 32;  // rows of the streamed operand per tile
constexpr int MERGE_THREADS = 128;
constexpr int MAX_SPLITS = 64;

template <int D>
struct Cfg {
  static constexpr int TPR = D <= 256 ? 8 : 16;  // threads per owned row
  static constexpr int R = NTHREADS / TPR;       // owned rows per block
  static constexpr int NJ = BS / TPR;            // streamed rows per thread per tile
  static constexpr int NG = D / (4 * TPR);       // float4 accumulator groups per thread
  static constexpr int RS = D + 4;               // padded row stride of the staged tiles
  static constexpr int PS = BS + TPR;            // row stride of the P / dS tiles
  // K4b: sQ, sdO [R][RS]; sK, sV [BS][RS]; sS [R][PS]
  static constexpr size_t dq_bytes = ((size_t)(2 * R + 2 * BS) * RS + (size_t)R * PS) * sizeof(float);
  // K4c: sK, sV [R][RS]; sQ, sdO [BS][RS]; sP, sS [R][PS]; sL, sD [BS]
  static constexpr size_t dkv_bytes =
      ((size_t)(2 * R + 2 * BS) * RS + 2 * (size_t)R * PS + 2 * (size_t)BS) * sizeof(float);
  static_assert(NG * 4 * TPR == D, "the head dim must split evenly over a row's threads");
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One 16-byte chunk of T (4 fp32 or 8 bf16), as fp32 times `mul`, into
// shared memory at `out` (16-byte aligned). A bf16 is the top half of an fp32.
template <typename T>
__device__ __forceinline__ void store_chunk(const uint4& raw, float* out, float mul);
template <>
__device__ __forceinline__ void store_chunk<float>(const uint4& raw, float* out, float mul) {
  *reinterpret_cast<float4*>(out) = make_float4(__uint_as_float(raw.x) * mul, __uint_as_float(raw.y) * mul,
                                                __uint_as_float(raw.z) * mul, __uint_as_float(raw.w) * mul);
}
template <>
__device__ __forceinline__ void store_chunk<__nv_bfloat16>(const uint4& raw, float* out, float mul) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    *reinterpret_cast<float4*>(out + 4 * h) = make_float4(
        __uint_as_float(w[2 * h] << 16) * mul, __uint_as_float(w[2 * h] & 0xffff0000u) * mul,
        __uint_as_float(w[2 * h + 1] << 16) * mul, __uint_as_float(w[2 * h + 1] & 0xffff0000u) * mul);
  }
}

// Stages rows [row0, row0 + ROWS) of one (batch, head) slice (row i at
// src + i * rs, D contiguous elements) into shared memory as fp32 times
// `mul`, row i - row0 at dst + (i - row0) * (D + 4); rows at or past `limit`
// become zeros. With `vec` (every row start 16-byte aligned) each thread
// moves 16-byte chunks, up to 8 loads in flight before it stores any;
// otherwise one element at a time.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, long long rs, int row0, int limit,
                                           float* __restrict__ dst, float mul, bool vec) {
  constexpr int DS = D + 4;
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int E = 16 / sizeof(T);  // elements per chunk
    constexpr int PER_ROW = D / E;
    constexpr int TOTAL = ROWS * PER_ROW;
    constexpr int N = (TOTAL + NTHREADS - 1) / NTHREADS;  // chunks per thread, the last round partial
    constexpr int BATCH = N < 8 ? N : 8;
#pragma unroll
    for (int b0 = 0; b0 < N; b0 += BATCH) {
      uint4 raw[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int idx = tid + (b0 + i) * NTHREADS;
        const int row = row0 + idx / PER_ROW;
        raw[i] = (b0 + i < N && idx < TOTAL && row < limit)
                     ? __ldg(reinterpret_cast<const uint4*>(src + row * rs + (idx % PER_ROW) * E))
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int idx = tid + (b0 + i) * NTHREADS;
        if (b0 + i < N && idx < TOTAL) store_chunk<T>(raw[i], dst + (idx / PER_ROW) * DS + (idx % PER_ROW) * E, mul);
      }
    }
    return;
  }
  for (int idx = tid; idx < ROWS * D; idx += NTHREADS) {
    const int rr = idx / D;
    const int d = idx - rr * D;
    const int row = row0 + rr;
    dst[rr * DS + d] = row < limit ? to_f32<T>(src[row * rs + d]) * mul : 0.f;
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float (&acc)[4], float a, const float4& x) {
  acc[0] = fmaf(a, x.x, acc[0]);
  acc[1] = fmaf(a, x.y, acc[1]);
  acc[2] = fmaf(a, x.z, acc[2]);
  acc[3] = fmaf(a, x.w, acc[3]);
}

// (batch, seq, head) element strides of the six tensors a kernel touches
struct Strides {
  long long t[6][3];
};

// K4b: dQ for one (R-row q tile, batch*head); also writes delta for its rows.
// Strides: q, k, v, o, dO, dQ.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) kgrid_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ o,
    const T* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ delta, T* __restrict__ dq, int H,
    int Sq, int Sk, Strides st, float scale, bool vec) {
  using C = Cfg<D>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem;                // [R][RS], pre-scaled
  float* sdO = sQ + C::R * C::RS;  // [R][RS]
  float* sK = sdO + C::R * C::RS;  // [BS][RS]
  float* sV = sK + BS * C::RS;     // [BS][RS]
  float* sS = sV + BS * C::RS;     // [R][PS]: dS

  const int tid = threadIdx.x;
  const int r = tid / C::TPR;  // q row within the tile
  const int c = tid % C::TPR;  // key columns c + TPR*j; output float4 groups c + TPR*g
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * C::R;
  const int qi = q0 + r;
  const bool row_ok = qi < Sq;

  const T* qb = q + b * st.t[0][0] + h * st.t[0][2];
  const T* kb = k + b * st.t[1][0] + h * st.t[1][2];
  const T* vb = v + b * st.t[2][0] + h * st.t[2][2];
  const T* ob = o + b * st.t[3][0] + h * st.t[3][2];
  const T* gb = dout + b * st.t[4][0] + h * st.t[4][2];

  stage_rows<T, D, C::R>(qb, st.t[0][1], q0, Sq, sQ, scale, vec);
  stage_rows<T, D, C::R>(gb, st.t[4][1], q0, Sq, sdO, 1.f, vec);
  __syncthreads();

  // delta = rowsum(dO o O): the row's TPR lanes split the head dim
  float delta_r = 0.f;
  if (row_ok) {
    const T* orow = ob + (long long)qi * st.t[3][1];
    for (int d = c; d < D; d += C::TPR) delta_r = fmaf(sdO[r * C::RS + d], to_f32<T>(orow[d]), delta_r);
  }
#pragma unroll
  for (int off = 1; off < C::TPR; off <<= 1) delta_r += __shfl_xor_sync(0xffffffffu, delta_r, off);
  if (row_ok && c == 0) delta[(long long)bh * Sq + qi] = delta_r;
  const float lse_r = row_ok ? lse[(long long)bh * Sq + qi] : 0.f;

  float acc[C::NG][4];
#pragma unroll
  for (int g = 0; g < C::NG; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;

  const int num_k = (Sk + BS - 1) / BS;
  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * BS;
    __syncthreads();  // the previous tile's reads of sK / sV / sS are done
    // ragged tail: K and V rows past Sk are zeros
    stage_rows<T, D, BS>(kb, st.t[1][1], k0, Sk, sK, 1.f, vec);
    stage_rows<T, D, BS>(vb, st.t[2][1], k0, Sk, sV, 1.f, vec);
    __syncthreads();

    // scores and dP of this thread's row against its NJ keys (c + TPR*j)
    float s[C::NJ], dp[C::NJ];
#pragma unroll
    for (int j = 0; j < C::NJ; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < D; d4 += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(&sQ[r * C::RS + d4]);
      const float4 gv = *reinterpret_cast<const float4*>(&sdO[r * C::RS + d4]);
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) {
        const int key = c + C::TPR * j;
        s[j] = dot4(qv, *reinterpret_cast<const float4*>(&sK[key * C::RS + d4]), s[j]);
        dp[j] = dot4(gv, *reinterpret_cast<const float4*>(&sV[key * C::RS + d4]), dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < C::NJ; ++j) {
      const int key = c + C::TPR * j;
      // masked keys and padded rows: P is an exact 0
      const float p = row_ok && k0 + key < Sk ? expf(s[j] - lse_r) : 0.f;
      sS[r * C::PS + key] = p * (dp[j] - delta_r);
    }
    __syncwarp();  // the row's dS is written (its TPR lanes are in this warp)

    const int ncols = min(BS, Sk - k0);
    for (int cc = 0; cc < ncols; ++cc) {
      const float ds = sS[r * C::PS + cc];
#pragma unroll
      for (int g = 0; g < C::NG; ++g)
        axpy4(acc[g], ds, *reinterpret_cast<const float4*>(&sK[cc * C::RS + (c + C::TPR * g) * 4]));
    }
  }

  if (row_ok) {
    T* row = dq + b * st.t[5][0] + h * st.t[5][2] + (long long)qi * st.t[5][1];
#pragma unroll
    for (int g = 0; g < C::NG; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) row[(c + C::TPR * g) * 4 + e] = from_f32<T>(scale * acc[g][e]);
    }
  }
}

// K4c: dK and dV for one (R-row key tile, batch*head, q split). Strides: q,
// k, v, dO, dK, dV. With one split the block writes dK / dV; with several it
// writes fp32 partials [split][B*H][Sk][D] (zeros for a split with no q
// rows) for kgrid_dkv_merge_kernel.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) kgrid_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ part_dk, float* __restrict__ part_dv, int H, int Sq, int Sk, int tiles_per_split,
    Strides st, float scale, bool vec) {
  using C = Cfg<D>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sK = smem;                // [R][RS]
  float* sV = sK + C::R * C::RS;   // [R][RS]
  float* sQ = sV + C::R * C::RS;   // [BS][RS], pre-scaled
  float* sdO = sQ + BS * C::RS;    // [BS][RS]
  float* sP = sdO + BS * C::RS;    // [R][PS]: P^T
  float* sS = sP + C::R * C::PS;   // [R][PS]: dS^T
  float* sL = sS + C::R * C::PS;   // [BS] lse
  float* sD = sL + BS;             // [BS] delta

  const int tid = threadIdx.x;
  const int kr = tid / C::TPR;  // key row within the tile
  const int c = tid % C::TPR;   // q rows c + TPR*j; output float4 groups c + TPR*g
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * C::R;
  const int split = blockIdx.z;
  const int num_q = (Sq + BS - 1) / BS;
  const int qt_begin = split * tiles_per_split;
  const int qt_end = min(num_q, qt_begin + tiles_per_split);

  const T* qb = q + b * st.t[0][0] + h * st.t[0][2];
  const T* kb = k + b * st.t[1][0] + h * st.t[1][2];
  const T* vb = v + b * st.t[2][0] + h * st.t[2][2];
  const T* gb = dout + b * st.t[3][0] + h * st.t[3][2];
  const float* lse_b = lse + (long long)bh * Sq;
  const float* delta_b = delta + (long long)bh * Sq;

  stage_rows<T, D, C::R>(kb, st.t[1][1], k0, Sk, sK, 1.f, vec);
  stage_rows<T, D, C::R>(vb, st.t[2][1], k0, Sk, sV, 1.f, vec);

  float acc_k[C::NG][4], acc_v[C::NG][4];
#pragma unroll
  for (int g = 0; g < C::NG; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[g][e] = acc_v[g][e] = 0.f;
  }

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int i0 = qt * BS;
    __syncthreads();  // the previous tile's reads are done (and sK / sV are staged)
    stage_rows<T, D, BS>(qb, st.t[0][1], i0, Sq, sQ, scale, vec);
    stage_rows<T, D, BS>(gb, st.t[3][1], i0, Sq, sdO, 1.f, vec);
    for (int i = tid; i < BS; i += NTHREADS) {
      const bool ok = i0 + i < Sq;
      sL[i] = ok ? lse_b[i0 + i] : 0.f;
      sD[i] = ok ? delta_b[i0 + i] : 0.f;
    }
    __syncthreads();

    float s[C::NJ], dp[C::NJ];
#pragma unroll
    for (int j = 0; j < C::NJ; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < D; d4 += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(&sK[kr * C::RS + d4]);
      const float4 vv = *reinterpret_cast<const float4*>(&sV[kr * C::RS + d4]);
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) {
        const int i = c + C::TPR * j;
        s[j] = dot4(kv, *reinterpret_cast<const float4*>(&sQ[i * C::RS + d4]), s[j]);    // (scale q_i) . k
        dp[j] = dot4(vv, *reinterpret_cast<const float4*>(&sdO[i * C::RS + d4]), dp[j]);  // dO_i . v
      }
    }
#pragma unroll
    for (int j = 0; j < C::NJ; ++j) {
      const int i = c + C::TPR * j;
      // padded query rows would contaminate dK / dV: their P is an exact 0
      const float p = i0 + i < Sq ? expf(s[j] - sL[i]) : 0.f;
      sP[kr * C::PS + i] = p;
      sS[kr * C::PS + i] = p * (dp[j] - sD[i]);
    }
    __syncwarp();  // the key row's P / dS are written (its TPR lanes are in this warp)

    const int nrows = min(BS, Sq - i0);
    for (int i = 0; i < nrows; ++i) {
      const float p = sP[kr * C::PS + i];
      const float ds = sS[kr * C::PS + i];
#pragma unroll
      for (int g = 0; g < C::NG; ++g) {
        const int col = (c + C::TPR * g) * 4;
        axpy4(acc_v[g], p, *reinterpret_cast<const float4*>(&sdO[i * C::RS + col]));
        axpy4(acc_k[g], ds, *reinterpret_cast<const float4*>(&sQ[i * C::RS + col]));
      }
    }
  }

  const int key = k0 + kr;
  if (key >= Sk) return;
  if (gridDim.z == 1) {
    T* krow = dk + b * st.t[4][0] + h * st.t[4][2] + (long long)key * st.t[4][1];
    T* vrow = dv + b * st.t[5][0] + h * st.t[5][2] + (long long)key * st.t[5][1];
#pragma unroll
    for (int g = 0; g < C::NG; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        krow[(c + C::TPR * g) * 4 + e] = from_f32<T>(acc_k[g][e]);
        vrow[(c + C::TPR * g) * 4 + e] = from_f32<T>(acc_v[g][e]);
      }
    }
    return;
  }
  const long long row = ((long long)split * gridDim.y + bh) * Sk + key;
#pragma unroll
  for (int g = 0; g < C::NG; ++g) {
    const int col = (c + C::TPR * g) * 4;
    *reinterpret_cast<float4*>(&part_dk[row * D + col]) = make_float4(acc_k[g][0], acc_k[g][1], acc_k[g][2], acc_k[g][3]);
    *reinterpret_cast<float4*>(&part_dv[row * D + col]) = make_float4(acc_v[g][0], acc_v[g][1], acc_v[g][2], acc_v[g][3]);
  }
}

// One block per (key row, batch*head): dK / dV = the splits' partials summed
// in split order.
template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS) kgrid_dkv_merge_kernel(
    const float* __restrict__ part_dk, const float* __restrict__ part_dv, T* __restrict__ dk, T* __restrict__ dv,
    int H, int Sk, int D, int splits, Strides st) {
  const int key = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const long long plane = (long long)gridDim.y * Sk;  // rows per split
  const long long row = (long long)bh * Sk + key;
  T* krow = dk + b * st.t[4][0] + h * st.t[4][2] + (long long)key * st.t[4][1];
  T* vrow = dv + b * st.t[5][0] + h * st.t[5][2] + (long long)key * st.t[5][1];
  for (int col = threadIdx.x; col < D; col += MERGE_THREADS) {
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < splits; ++s) {
      sk += part_dk[(s * plane + row) * D + col];
      sv += part_dv[(s * plane + row) * D + col];
    }
    krow[col] = from_f32<T>(sk);
    vrow[col] = from_f32<T>(sv);
  }
}

Strides unpack(const long long* s) {
  Strides st;
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 3; ++j) st.t[i][j] = s[3 * i + j];
  return st;
}

// 16-byte staging when every staged tensor's rows start 16-byte aligned:
// aligned bases and batch/seq/head strides in whole 16-byte chunks. `which`
// lists the staged tensors' indices into the 6 pointers / stride triples.
template <typename T>
bool rows_aligned(const void* const* ptrs, const long long* st, const int* which, int n) {
  constexpr long long E = 16 / sizeof(T);
  bool vec = true;
  for (int w = 0; w < n; ++w) {
    const int i = which[w];
    vec = vec && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
    for (int j = 0; j < 3; ++j) vec = vec && st[3 * i + j] % E == 0;
  }
  return vec;
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
              float* delta, void* dq, int B, int H, int Sq, int Sk, const long long* strides, float scale,
              cudaStream_t stream) {
  auto kernel = kgrid_bwd_dq_kernel<T, D>;
  const size_t smem = Cfg<D>::dq_bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const void* ptrs[6] = {q, k, v, o, dout, dq};
  const int staged[4] = {0, 1, 2, 4};  // q, k, v, dO
  const bool vec = rows_aligned<T>(ptrs, strides, staged, 4);
  dim3 grid((Sq + Cfg<D>::R - 1) / Cfg<D>::R, B * H);
  kernel<<<grid, NTHREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<const T*>(o),
                                           static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), H, Sq, Sk,
                                           unpack(strides), scale, vec);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, float* part_dk, float* part_dv, int B, int H, int Sq, int Sk, int splits,
               const long long* strides, float scale, cudaStream_t stream) {
  auto kernel = kgrid_bwd_dkv_kernel<T, D>;
  const size_t smem = Cfg<D>::dkv_bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const void* ptrs[6] = {q, k, v, dout, dk, dv};
  const int staged[4] = {0, 1, 2, 3};  // q, k, v, dO
  const bool vec = rows_aligned<T>(ptrs, strides, staged, 4);
  const int num_q = (Sq + BS - 1) / BS;
  const int tiles_per_split = (num_q + splits - 1) / splits;
  const Strides st = unpack(strides);
  dim3 grid((Sk + Cfg<D>::R - 1) / Cfg<D>::R, B * H, splits);
  kernel<<<grid, NTHREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
                                           static_cast<T*>(dk), static_cast<T*>(dv), part_dk, part_dv, H, Sq, Sk,
                                           tiles_per_split, st, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  dim3 mgrid(Sk, B * H);
  kgrid_dkv_merge_kernel<T><<<mgrid, MERGE_THREADS, 0, stream>>>(part_dk, part_dv, static_cast<T*>(dk),
                                                                 static_cast<T*>(dv), H, Sk, D, splits, st);
  return (int)cudaGetLastError();
}

#define KGRID_HEAD_DIM_CASES(X) X(64) X(128) X(192) X(256) X(320) X(384) X(448) X(512)

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
                float* delta, void* dq, int B, int H, int Sq, int Sk, int D, const long long* strides, float scale,
                cudaStream_t s) {
  switch (D) {
#define CASE(DD) \
  case DD: return launch_dq<T, DD>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Sk, strides, scale, s);
    KGRID_HEAD_DIM_CASES(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
                 void* dk, void* dv, float* pdk, float* pdv, int B, int H, int Sq, int Sk, int D, int splits,
                 const long long* strides, float scale, cudaStream_t s) {
  switch (D) {
#define CASE(DD)                                                                                                  \
  case DD:                                                                                                        \
    return launch_dkv<T, DD>(q, k, v, dout, lse, delta, dk, dv, pdk, pdv, B, H, Sq, Sk, splits, strides, scale, \
                             s);
    KGRID_HEAD_DIM_CASES(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

bool shape_ok(int B, int H, int Sq, int Sk) { return B > 0 && H > 0 && Sq > 0 && Sk > 0 && B * H <= 65535; }

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = float32, 1 = bfloat16.
// Each returns the cudaError_t of its launches (0 = launched), or
// cudaErrorInvalidValue for a head dim / dtype / shape / split count it does
// not take.
//
// K4b. strides: 18 element strides, (batch, seq, head) for q, k, v, o, dO,
// dQ in turn. lse [B*H, Sq] fp32 in (as K4a wrote it); delta [B*H, Sq] fp32
// out.
extern "C" int flash_attention_kgrid_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                            const void* dout, const float* lse, float* delta, void* dq, int dtype,
                                            int B, int H, int Sq, int Sk, int D, const long long* strides,
                                            float scale, void* stream) {
  if (!shape_ok(B, H, Sq, Sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dq<float>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Sk, D, strides, scale, s);
  if (dtype == 1)
    return dispatch_dq<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Sk, D, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}

// K4c. strides: 18 element strides, (batch, seq, head) for q, k, v, dO, dK,
// dV in turn. lse and delta [B*H, Sq] fp32 in (delta as K4b wrote it, on the
// same stream). splits > 1 needs part_dk / part_dv [splits, B*H, Sk, D],
// fp32 and contiguous; with splits == 1 they are unused.
extern "C" int flash_attention_kgrid_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                             const float* lse, const float* delta, void* dk, void* dv,
                                             float* part_dk, float* part_dv, int dtype, int B, int H, int Sq,
                                             int Sk, int D, int splits, const long long* strides, float scale,
                                             void* stream) {
  if (!shape_ok(B, H, Sq, Sk) || splits < 1 || splits > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  if (splits > 1 && (part_dk == nullptr || part_dv == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, part_dk, part_dv, B, H, Sq, Sk, D, splits, strides,
                               scale, s);
  if (dtype == 1)
    return dispatch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, part_dk, part_dv, B, H, Sq, Sk, D, splits,
                                       strides, scale, s);
  return (int)cudaErrorInvalidValue;
}
