// K-grid flash-attention backward for Hopper (sm_90a): bidirectional (no
// mask), gradients in the input dtype, head dims 64..512 (multiples of 64).
// The backward of K4a (flash_attention_kgrid.cu).
//
// K4b replaces the TPU kernel
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
// K4c replaces ::_bwd_dkv_kernel (launched by _vjp_bwd): per key tile,
// dV = sum_q P^T dO and dK = scale * sum_q dS^T Q, accumulated over the
// query axis. Query rows past Sq contribute nothing: their P is forced to 0,
// as the TPU kernel's row mask does.
//
// The TPU grids are (bh, q block, k block) with k sequential for dQ and
// (bh, k block, q block) with q sequential for dK/dV; the carry lives in
// VMEM scratch. On the card blocks run in parallel and in no order, so the
// sequential axis becomes a loop inside the block over 32-row tiles of the
// streamed operand (keys for K4b, queries for K4c), with the accumulators in
// registers. Where the grid is small for the 132 SMs the loop's range is
// split across blocks (grid z): each split writes fp32 partials, and a merge
// kernel sums them in split order. No float atomics: two runs give the same
// bits, as train/checkpoint.py's bit-identical resume needs.
//
// Both: keys past Sk and query rows past Sq are loaded as zeros and their P
// is selected to exactly 0 (never exp of a -1e30 score), so padding adds
// nothing and makes no NaN. Layout BSHD [B, S, H, D] with arbitrary batch /
// seq / head strides (in elements) and unit stride over D for every tensor,
// so autograd's dO (a slice of the padded output's gradient) goes in without
// a copy.
//
// What bounds them on the H100: K4b does 6*BH*Sq*Sk*D flops and K4c
// 8*BH*Sq*Sk*D against a few MB of q, k, v, o, dO, lse, delta and the
// gradients moved once; at SD1.5's d-160 attentions (padded to 192; 256, 64
// or 16 tokens against as many keys or 77) the bytes bound them (3.35 TB/s:
// 1.2 us at 256^2 with 8 heads), and a call is a few microseconds of work
// spread over a grid of a few dozen blocks.
//
// By dtype:
//
// bfloat16: kgrid_bwd_dq_tc_kernel (K4b) and kgrid_bwd_dkv_tc_kernel (K4c),
// on the tensor cores (mma.sync m16n8k16, bf16 operands, fp32
// accumulators): thin kernels over the bodies K2 and K3 run
// (flash_attention_bwd.cu), hopper_tc.cuh's bwd_dq_tc and bwd_dkv_tc, at the
// block shapes of TcCfg below, which take head dims up to 512. Design:
//   * a block owns 16-row slabs of the non-streamed axis (K4b: q rows, K4c:
//     keys): 4 slabs (64 rows) at D <= 128, 2 (32 rows) above; the resident
//     tiles (K4b: Q, dO; K4c: K, V) stay in shared memory, and 32-row tiles
//     of the streamed operand (K4b: K, V; K4c: Q, dO, lse, delta) pass
//     through a 2-stage cp.async ring, rows XOR-swizzled by swz<D>;
//   * the gradient accumulators of a 16-row slab are 16 x D fp32 (K4c keeps
//     two), too many registers above D 128. So CS warps share a slab (CS 1
//     at D <= 128, 2 at D 192/256, 4 above): each computes the slab's S and
//     dP over the whole head dim (repeated products, no synchronisation)
//     and owns D / CS of the gradient columns (96 at D 192; at most 128);
//   * per tile: K4b S = Q K^T, P = exp(scale S - lse) (scale applied to S in
//     fp32, as K2 does; an exact 0 for keys past the split's end), dP = dO
//     V^T, dS = P o (dP - delta), dQ += dS K; K4c S^T = K Q^T, P^T (0 on
//     padded query rows), dV += P^T dO, dP^T = V dO^T, dS^T, dK += dS^T Q.
//     P and dS are rounded to bf16 straight from the accumulator layout as
//     the A operand of the next product; delta = rowsum(dO o O) in fp32 in
//     K4b's prologue (a quad of threads per row, O in 16-byte loads);
//   * K4b splits its key range and K4c its query range in 32-row units when
//     the grid is under two waves of the 132 SMs
//     (ops/flash_attention_kgrid.py::pick_k4b_splits, pick_dkv_splits):
//     SD1.5's 256^2 with 8 heads runs 128 blocks of 2 splits instead of 64.
//     K4b's unscaled partials are summed in split order, then scaled, by
//     kgrid_dq_merge_kernel; K4c's (dK already scaled) by
//     kgrid_dkv_merge_kernel (hopper_tc.cuh's dq_merge and dkv_merge, as K2's
//     and K3's merges run them). Only split 0 writes delta.
//   Shared memory: K4b 32-192 KB, K4c 32.5-192.5 KB (D 64-512; 72 / 72.5
//   KB at D 192). ptxas, registers at D 64 / 128 / 192 / 256 / 320 / 384 /
//   448 / 512: K4b 126 / 174 / 168 / 221 / 177 / 179 / 255 / 247, K4c 168 /
//   241 / 243 / 255 / 253 / 251 / 255 / 252, the merges 32-34. No spills but
//   at K4b's D 448 (40 bytes), a head dim no path differentiates.
//   cp.async moves 16-byte chunks: the wrappers make one contiguous copy of
//   a bf16 tensor whose rows do not start on 16 bytes, and these entry
//   points return cudaErrorInvalidValue for one that reaches them anyway.
//
// float32 keeps the first (SIMT) kernels kgrid_bwd_dq_kernel and
// kgrid_bwd_dkv_kernel, unchanged: fp32 math on the CUDA cores, because TF32
// tensor cores would break the fp32 bound of 1e-4 against the plain version.
// 256 threads; each block owns R rows (q rows for K4b, key rows for K4c) and
// TPR threads share a row: TPR = 8, R = 32 for D <= 256, and TPR = 16, R =
// 16 above, so that the accumulators stay in registers; 32-row streamed
// tiles staged as fp32 with rows padded by 4 floats, P and dS through shared
// memory; q staged pre-scaled, as K4a's SIMT kernel stages it. Only K4c
// splits (its query range, in 32-row tiles).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tc.cuh"

namespace {

using hopper::Strides;
using hopper::unpack;

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

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// One 16-byte chunk of T (4 fp32), as fp32 times `mul`, into shared memory at
// `out` (16-byte aligned).
template <typename T>
__device__ __forceinline__ void store_chunk(const uint4& raw, float* out, float mul);
template <>
__device__ __forceinline__ void store_chunk<float>(const uint4& raw, float* out, float mul) {
  *reinterpret_cast<float4*>(out) = make_float4(__uint_as_float(raw.x) * mul, __uint_as_float(raw.y) * mul,
                                                __uint_as_float(raw.z) * mul, __uint_as_float(raw.w) * mul);
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


// ---------------------------------------------------------------------------
// K4b / K4c for bfloat16: the tensor-core loops of hopper_tc.cuh (bwd_dq_tc,
// bwd_dkv_tc) at this file's block shapes, under kernel names of their own
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

// Four 16-row slabs a block at D <= 128, two above; 1 / 2 / 4 warps share a
// slab at D <= 128 / 192-256 / 320-512; 32-row streamed tiles, which are also
// the unit of both splits.
template <int D>
using TcCfg = BwdCfg<D, D <= 128 ? 4 : 2, D <= 128 ? 1 : D <= 256 ? 2 : 4, 32, 32>;

template <int D>
__global__ void __launch_bounds__(TcCfg<D>::THREADS) kgrid_bwd_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, float* __restrict__ part_dq, int H, int Sq, int Sk,
    int splits, Strides st, float scale) {
  bwd_dq_tc<TcCfg<D>>(q, k, v, o, dout, lse, delta, dq, part_dq, H, Sq, Sk, splits, st, scale);
}

template <int D>
__global__ void kgrid_dq_merge_kernel(const float* __restrict__ part_dq, __nv_bfloat16* __restrict__ dq, int BH, int H,
                                      int Sq, int splits, Strides st, float scale) {
  dq_merge<D>(part_dq, dq, BH, H, Sq, splits, st, scale);
}

template <int D>
__global__ void __launch_bounds__(TcCfg<D>::THREADS) kgrid_bwd_dkv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, float* __restrict__ part_dk,
    float* __restrict__ part_dv, int H, int Sq, int Sk, int splits, Strides st, float scale) {
  bwd_dkv_tc<TcCfg<D>>(q, k, v, dout, lse, delta, dk, dv, part_dk, part_dv, H, Sq, Sk, splits, st, scale);
}

template <int D>
__global__ void kgrid_dkv_merge_kernel(const float* __restrict__ part_dk, const float* __restrict__ part_dv,
                                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int BH, int H,
                                       int Sk, int splits, Strides st) {
  dkv_merge<D>(part_dk, part_dv, dk, dv, BH, H, Sk, splits, st);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
              float* delta, void* dq, float* part_dq, int B, int H, int Sq, int Sk, int splits, const long long* s,
              float scale, cudaStream_t stream) {
  static uint64_t smem_set = 0;
  return launch_bwd_dq<TcCfg<D>>(kgrid_bwd_dq_tc_kernel<D>, kgrid_dq_merge_kernel<D>, smem_set, q, k, v, o, dout,
                                 lse, delta, dq, part_dq, B, H, Sq, Sk, splits, s, scale, stream);
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, float* part_dk, float* part_dv, int B, int H, int Sq, int Sk, int splits,
               const long long* s, float scale, cudaStream_t stream) {
  static uint64_t smem_set = 0;
  return launch_bwd_dkv<TcCfg<D>>(kgrid_bwd_dkv_tc_kernel<D>, kgrid_dkv_merge_kernel<D>, smem_set, q, k, v, dout,
                                  lse, delta, dk, dv, part_dk, part_dv, B, H, Sq, Sk, splits, s, scale, stream);
}

}  // namespace tc

#define KGRID_HEAD_DIM_CASES(X) X(64) X(128) X(192) X(256) X(320) X(384) X(448) X(512)

// fp32: the SIMT kernel (one split); bf16: the tensor-core kernel
int dispatch_dq(int dtype, const void* q, const void* k, const void* v, const void* o, const void* dout,
                const float* lse, float* delta, void* dq, float* part_dq, int B, int H, int Sq, int Sk, int D,
                int splits, const long long* strides, float scale, cudaStream_t s) {
  switch (D) {
#define CASE(DD)                                                                                               \
  case DD:                                                                                                     \
    return dtype == 0 ? launch_dq<float, DD>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Sk, strides, scale, s) \
                      : tc::launch_dq<DD>(q, k, v, o, dout, lse, delta, dq, part_dq, B, H, Sq, Sk, splits,      \
                                          strides, scale, s);
    KGRID_HEAD_DIM_CASES(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_dkv(int dtype, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 const float* delta, void* dk, void* dv, float* pdk, float* pdv, int B, int H, int Sq, int Sk, int D,
                 int splits, const long long* strides, float scale, cudaStream_t s) {
  switch (D) {
#define CASE(DD)                                                                                                   \
  case DD:                                                                                                         \
    return dtype == 0 ? launch_dkv<float, DD>(q, k, v, dout, lse, delta, dk, dv, pdk, pdv, B, H, Sq, Sk, splits, \
                                              strides, scale, s)                                                   \
                      : tc::launch_dkv<DD>(q, k, v, dout, lse, delta, dk, dv, pdk, pdv, B, H, Sq, Sk, splits,      \
                                           strides, scale, s);
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
// out. bfloat16 runs the tensor-core kernel over `splits` ranges of the key
// axis (fp32 partials part_dq [splits, B*H, Sq, D], then the merge; unused
// when splits is 1); float32 runs the SIMT kernel, which does not split.
extern "C" int flash_attention_kgrid_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                            const void* dout, const float* lse, float* delta, void* dq,
                                            float* part_dq, int dtype, int B, int H, int Sq, int Sk, int D,
                                            int splits, const long long* strides, float scale, void* stream) {
  if (!shape_ok(B, H, Sq, Sk) || splits < 1 || splits > MAX_SPLITS || (dtype == 0 && splits != 1) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return dispatch_dq(dtype, q, k, v, o, dout, lse, delta, dq, part_dq, B, H, Sq, Sk, D, splits, strides, scale,
                     static_cast<cudaStream_t>(stream));
}

// K4c. strides: 18 element strides, (batch, seq, head) for q, k, v, dO, dK,
// dV in turn. lse and delta [B*H, Sq] fp32 in (delta as K4b wrote it, on the
// same stream). splits > 1 needs part_dk / part_dv [splits, B*H, Sk, D],
// fp32 and contiguous; with splits == 1 they are unused. Both dtypes split
// the query range in 32-row units.
extern "C" int flash_attention_kgrid_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                             const float* lse, const float* delta, void* dk, void* dv,
                                             float* part_dk, float* part_dv, int dtype, int B, int H, int Sq,
                                             int Sk, int D, int splits, const long long* strides, float scale,
                                             void* stream) {
  if (!shape_ok(B, H, Sq, Sk) || splits < 1 || splits > MAX_SPLITS || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (part_dk == nullptr || part_dv == nullptr)) return (int)cudaErrorInvalidValue;
  return dispatch_dkv(dtype, q, k, v, dout, lse, delta, dk, dv, part_dk, part_dv, B, H, Sq, Sk, D, splits, strides,
                      scale, static_cast<cudaStream_t>(stream));
}
