// Flash-attention backward for Hopper (sm_90a): two kernels, bidirectional
// (no mask), gradients in the input dtype.
//
// K2 replaces the TPU kernel
//   sliders_conceptmod_tpu/ops/flash_attention.py::_bwd_dq_kernel
// (launched by _vjp_bwd): dQ = scale * sum_k dS K, with
//   P  = exp(scale * Q K^T - lse)     (recomputed from K1's saved fp32 lse)
//   dP = dO V^T,  dS = P o (dP - delta),  delta = rowsum(dO o O).
// The JAX package computes delta with an XLA reduction outside its kernels;
// here it is fused into K2's prologue (the q tile's dO rows are staged
// anyway) and written out as fp32 [B*H, Sq] for K3.
//
// K3 replaces
//   sliders_conceptmod_tpu/ops/flash_attention.py::_bwd_dkv_kernel
// (launched by _vjp_bwd): per key tile, dV = sum_q P^T dO and
// dK = scale * sum_q dS^T Q. Query rows past Sq contribute nothing (their P
// is forced to an exact 0, as the TPU kernel's row mask does).
//
// Both: layout BSHD [B, S, H, D] with arbitrary batch / seq / head strides
// (in elements) and unit stride over D for every tensor, so autograd's dO
// and the UNet's q/k/v views go in without copies. D is 64 or 128; outputs
// are written with their own strides. K2 does 6*BH*Sq*Sk*D flops and K3
// 8*BH*Sq*Sk*D (at the unpadded D) against q, k, v, o, dO, lse, delta and
// the gradients moved once: the bf16 tensor-core rate (989 TFLOP/s) bounds
// them at the training paths' self-attentions of 1024 and 4096 tokens, the
// bytes (3.35 TB/s) at the 77-key cross-attentions and at 256 tokens.
//
// By dtype:
//
// The bf16 kernels' bodies (bwd_dq_tc, bwd_dkv_tc and their merges dq_merge,
// dkv_merge) live in hopper_tc.cuh, where K4b/K4c (flash_attention_kgrid_bwd.cu)
// run them at other block shapes; the kernels here are thin wrappers that fix
// this file's shapes (DqCfg, DkvCfg) and names.
//
// K2, bfloat16: flash_bwd_dq_tc_kernel, on the tensor cores (mma.sync
// m16n8k16, bf16 operands, fp32 accumulators); the mirror image of K3's
// loop. Design:
//   * one block of 4 warps per (batch*head, 64-row q tile, split of the key
//     range); warp w owns q rows 16w..16w+15 and keeps their dQ (16 x D
//     fp32) in registers for the whole loop;
//   * Q and dO of the tile stay in shared memory; a prologue computes
//     delta = rowsum(dO o O) in fp32 (a quad of threads per row, O read
//     from device memory in 16-byte chunks) and writes it [B*H, Sq] for K3;
//   * 64-key tiles of K and V stream through a 2-stage cp.async ring; per
//     tile three products: S = Q K^T; P = exp(scale S - lse) (an exact 0 for
//     keys past Sk); dP = dO V^T; dS = P o (dP - delta), rounded to bf16
//     straight from the accumulator layout as the A operand of dQ += dS K
//     (K as B through ldmatrix.trans). Q and dO are re-read as A fragments
//     with ldmatrix per tile (K3's keys_by_q with the roles of the two tiles
//     swapped). Shared memory: 48 KB at D 64, 96 KB at D 128;
//   * a grid of q tiles under two waves of the 132 SMs (SDXL's 1024^2 with 10
//     heads gives 160 blocks) splits the key range in 64-key units
//     (ops/flash_attention.py::pick_k2_splits, K3's rule); each split writes
//     unscaled fp32 partials and flash_dq_merge_kernel sums them in split
//     order, then scales and casts. No float atomics. Only split 0 writes
//     delta.
//   What bounds it: 6*BH*Sq*Sk*D flops at the bf16 tensor-core rate at the
//   self-attentions of 1024 and 4096 tokens; the bytes at the 77-key
//   crosses and 256 tokens. ptxas: 160 registers at D 64, 232 at D 128, the
//   merge 32; no spills.
//   Measured (bench_attention.py, device time, NVIDIA H100 80GB HBM3,
//   700.00 W): SDXL's 1024^2 (10 heads, 2 splits) 0.027 ms, 149 TFLOP/s,
//   15 % of the bound, 0.78x SDPA's whole backward (the first SIMT kernel:
//   0.486 ms); SD1.5's 4096^2 (8 heads of 40 run at 64) 0.224 ms, 15 % of
//   the bound at D 40, 1.09x; SD2.1's 4096^2 0.156 ms, 22 %; the other
//   shapes 10-26 % of the bound and 0.11-1.01x SDPA's whole backward
//   (PERF.md, section 6).
//
// K3, bfloat16: flash_bwd_dkv_tc_kernel, on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, fp32 accumulators). Design:
//   * one block of 4 warps per (batch*head, 64-key tile, split of the query
//     range); warp w owns keys 16w..16w+15 and keeps their dK and dV
//     accumulators (16 x D fp32) in registers for the whole loop;
//   * K and V of the tile stay in shared memory; q tiles of Q, dO, lse and
//     delta (64 rows at D 64, 32 at D 128, so that dK, dV, P and dP fit in
//     the registers) stream through a 2-stage cp.async ring: the copy of
//     tile i+1 overlaps the products of tile i;
//   * per q tile, four products in this order: S^T = K Q^T;
//     P^T = exp(scale S^T - lse) (0 on padded query rows); dV += P^T dO;
//     dP^T = V dO^T; dS^T = P^T o (dP^T - delta); dK += dS^T Q. P^T and dS^T
//     are rounded to bf16 as A operands straight from the m16n8k16
//     accumulator layout, which is the A-fragment layout of the next
//     product, with no trip through shared memory; Q and dO are read as B
//     with ldmatrix (plain for the [q][d] "col" operand of K Q^T and V dO^T,
//     .trans for the [k][n] operand of P^T dO and dS^T Q);
//   * shared-memory rows are bf16 with their 16-byte chunks XOR-swizzled by
//     (row & 7): ldmatrix's eight rows and cp.async's writes hit distinct
//     banks. Shared memory per block: K + V 64 x D, 2 stages of Q + dO
//     (BQ x D) + lse + delta: 49 KB at D 64, 64.5 KB at D 128. ptxas: 198
//     registers at D 64, 241 at D 128, the merge 34; no spills;
//   * a grid of key tiles under two waves of the 132 SMs (Sk = 77 gives two
//     tiles per head) splits the query range across blocks
//     (ops/flash_attention.py::pick_k3_splits, K4c's rule); each split
//     writes fp32 partials and flash_dkv_merge_kernel sums them in split
//     order. No float atomics: two runs give the same bits, as
//     train/checkpoint.py's bit-identical resume needs.
//   Measured (bench_attention.py, device time, NVIDIA H100 80GB HBM3,
//   700.00 W): SDXL's 1024^2 (10 heads, 2 splits) 0.042 ms, 128 TFLOP/s,
//   13 % of the bound, 1.22x SDPA's whole backward; SD1.5's 4096^2 (8 heads
//   of 40 run at 64) 0.305 ms, 14 % of the bound at D 40, 1.45x; SD2.1's
//   4096^2 17 %, 1.31x; the other shapes 4-12 % of the bound, and the Sk =
//   77 ones (1-16 splits) 0.15-0.89x SDPA's whole backward (PERF.md,
//   section 6).
//
// Both tensor-core kernels read rows with 16-byte loads (cp.async, K2's O):
// the wrapper makes one contiguous copy of a bf16 tensor whose rows fail the
// check, and these entry points return cudaErrorInvalidValue for one that
// reaches them anyway.
//
// float32 keeps the first SIMT kernels of K2 and K3, unchanged: fp32 math on
// the CUDA cores (67 TFLOP/s peak), one block of 128 threads per
// (batch*head, 64-row tile), thread t owning row t/2 and the even or odd
// rows of each streamed tile, tiles staged as fp32 with rows padded by 4
// floats, P and dS through shared memory. fp32 stays there because TF32
// tensor cores would break the fp32 bound of 1e-4 against the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tc.cuh"

namespace {

constexpr int BQ = 64;         // q rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int NTHREADS = 128;  // 2 threads per owned row
constexpr int NJ = 32;         // streamed rows per thread per tile (64 / 2)

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

using hopper::Strides;
using hopper::unpack;

template <int D>
struct Smem {
  static constexpr int RS = D + 4;   // row stride of the q / dO / k / v tiles
  static constexpr int PS = 64 + 2;  // row stride of the P and dS tiles
  // K2: sQ, sdO [BQ][RS]; sK, sV [BK][RS]; sS [BQ][PS]
  static constexpr size_t dq_bytes = ((size_t)(2 * BQ + 2 * BK) * RS + (size_t)BQ * PS) * sizeof(float);
  // K3: sK, sV [BK][RS]; sQ, sdO [BQ][RS]; sP, sS [BK][PS]; sL, sD [BQ]
  static constexpr size_t dkv_bytes =
      ((size_t)(2 * BK + 2 * BQ) * RS + 2 * (size_t)BK * PS + 2 * (size_t)BQ) * sizeof(float);
};

// Stage rows [r0, r0 + 64) of a BSHD slice (base already offset to its batch
// and head) as fp32; rows at or past n are zeros.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src, long long row_stride, int r0,
                                           int n) {
  constexpr int RS = Smem<D>::RS;
  for (int idx = threadIdx.x; idx < 64 * D; idx += NTHREADS) {
    const int rr = idx / D;
    const int d = idx - rr * D;
    const int row = r0 + rr;
    dst[rr * RS + d] = row < n ? to_f32<T>(src[(long long)row * row_stride + d]) : 0.f;
  }
}

// acc[j] += dot(a_row, B[2j + half]) over D, a_row and B rows in shared memory
template <int D>
__device__ __forceinline__ void row_dots(float (&acc)[NJ], const float* a_row, const float* B, int half) {
  constexpr int RS = Smem<D>::RS;
#pragma unroll 4
  for (int d4 = 0; d4 < D; d4 += 4) {
    const float4 a = *reinterpret_cast<const float4*>(&a_row[d4]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(&B[(2 * j + half) * RS + d4]);
      acc[j] = fmaf(a.x, bv.x, acc[j]);
      acc[j] = fmaf(a.y, bv.y, acc[j]);
      acc[j] = fmaf(a.z, bv.z, acc[j]);
      acc[j] = fmaf(a.w, bv.w, acc[j]);
    }
  }
}

// K2: dQ for one (batch*head, 64-row q tile); also writes delta for its rows.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ o,
    const T* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ delta, T* __restrict__ dq, int H,
    int Sq, int Sk, Strides st, float scale) {
  using S = Smem<D>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem;               // [BQ][RS]
  float* sdO = sQ + BQ * S::RS;   // [BQ][RS]
  float* sK = sdO + BQ * S::RS;   // [BK][RS]
  float* sV = sK + BK * S::RS;    // [BK][RS]
  float* sS = sV + BK * S::RS;    // [BQ][PS]: P, then dS

  const int tid = threadIdx.x;
  const int r = tid >> 1;    // q row within the tile
  const int half = tid & 1;  // even / odd keys; interleaved output column groups
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + r;
  const bool row_ok = qi < Sq;

  const T* qb = q + b * st.t[0][0] + h * st.t[0][2];
  const T* kb = k + b * st.t[1][0] + h * st.t[1][2];
  const T* vb = v + b * st.t[2][0] + h * st.t[2][2];
  const T* ob = o + b * st.t[3][0] + h * st.t[3][2];
  const T* gb = dout + b * st.t[4][0] + h * st.t[4][2];

  stage_rows<T, D>(sQ, qb, st.t[0][1], q0, Sq);
  stage_rows<T, D>(sdO, gb, st.t[4][1], q0, Sq);
  __syncthreads();

  // delta = rowsum(dO o O): the row's two threads split the head dim
  float delta_r = 0.f;
  if (row_ok) {
    const T* orow = ob + (long long)qi * st.t[3][1];
    for (int d = half; d < D; d += 2) delta_r = fmaf(sdO[r * S::RS + d], to_f32<T>(orow[d]), delta_r);
  }
  delta_r += __shfl_xor_sync(0xffffffffu, delta_r, 1);
  const float lse_r = row_ok ? lse[(long long)bh * Sq + qi] : 0.f;
  if (row_ok && half == 0) delta[(long long)bh * Sq + qi] = delta_r;

  constexpr int NG = D / 8;  // float4 output groups per thread
  float acc[NG * 4];
#pragma unroll
  for (int e = 0; e < NG * 4; ++e) acc[e] = 0.f;

  const int num_k = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of sK / sV / sS are done
    stage_rows<T, D>(sK, kb, st.t[1][1], k0, Sk);
    stage_rows<T, D>(sV, vb, st.t[2][1], k0, Sk);
    __syncthreads();

    float s[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = 0.f;
    row_dots<D>(s, &sQ[r * S::RS], sK, half);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = 2 * j + half;
      const bool ok = row_ok && k0 + c < Sk;  // masked keys: P is an exact 0
      sS[r * S::PS + c] = ok ? expf(scale * s[j] - lse_r) : 0.f;
      s[j] = 0.f;
    }
    row_dots<D>(s, &sdO[r * S::RS], sV, half);  // dP = dO . v
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = 2 * j + half;
      sS[r * S::PS + c] = sS[r * S::PS + c] * (s[j] - delta_r);
    }
    __syncthreads();  // the row partner's dS columns are written

    const int ncols = min(BK, Sk - k0);
    for (int c = 0; c < ncols; ++c) {
      const float ds = sS[r * S::PS + c];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 kv = *reinterpret_cast<const float4*>(&sK[c * S::RS + (2 * g + half) * 4]);
        acc[4 * g + 0] = fmaf(ds, kv.x, acc[4 * g + 0]);
        acc[4 * g + 1] = fmaf(ds, kv.y, acc[4 * g + 1]);
        acc[4 * g + 2] = fmaf(ds, kv.z, acc[4 * g + 2]);
        acc[4 * g + 3] = fmaf(ds, kv.w, acc[4 * g + 3]);
      }
    }
  }

  if (row_ok) {
    T* row = dq + b * st.t[5][0] + h * st.t[5][2] + (long long)qi * st.t[5][1];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) row[(2 * g + half) * 4 + e] = from_f32<T>(scale * acc[4 * g + e]);
    }
  }
}

// K3: dK and dV for one (batch*head, 64-row key tile).
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
    int Sq, int Sk, Strides st, float scale) {
  using S = Smem<D>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sK = smem;               // [BK][RS]
  float* sV = sK + BK * S::RS;    // [BK][RS]
  float* sQ = sV + BK * S::RS;    // [BQ][RS]
  float* sdO = sQ + BQ * S::RS;   // [BQ][RS]
  float* sP = sdO + BQ * S::RS;   // [BK][PS]: P^T
  float* sS = sP + BK * S::PS;    // [BK][PS]: dS^T
  float* sL = sS + BK * S::PS;    // [BQ] lse
  float* sD = sL + BQ;            // [BQ] delta

  const int tid = threadIdx.x;
  const int c = tid >> 1;    // key row within the tile
  const int half = tid & 1;  // even / odd q rows; interleaved output column groups
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * BK;

  const T* qb = q + b * st.t[0][0] + h * st.t[0][2];
  const T* kb = k + b * st.t[1][0] + h * st.t[1][2];
  const T* vb = v + b * st.t[2][0] + h * st.t[2][2];
  const T* gb = dout + b * st.t[3][0] + h * st.t[3][2];
  const float* lse_b = lse + (long long)bh * Sq;
  const float* delta_b = delta + (long long)bh * Sq;

  stage_rows<T, D>(sK, kb, st.t[1][1], k0, Sk);
  stage_rows<T, D>(sV, vb, st.t[2][1], k0, Sk);

  constexpr int NG = D / 8;
  float acc_k[NG * 4];
  float acc_v[NG * 4];
#pragma unroll
  for (int e = 0; e < NG * 4; ++e) {
    acc_k[e] = 0.f;
    acc_v[e] = 0.f;
  }

  const int num_q = (Sq + BQ - 1) / BQ;
  for (int qt = 0; qt < num_q; ++qt) {
    const int i0 = qt * BQ;
    __syncthreads();  // the previous tile's reads are done (and sK / sV are staged)
    stage_rows<T, D>(sQ, qb, st.t[0][1], i0, Sq);
    stage_rows<T, D>(sdO, gb, st.t[3][1], i0, Sq);
    for (int i = tid; i < BQ; i += NTHREADS) {
      const bool ok = i0 + i < Sq;
      sL[i] = ok ? lse_b[i0 + i] : 0.f;
      sD[i] = ok ? delta_b[i0 + i] : 0.f;
    }
    __syncthreads();

    float s[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = 0.f;
    row_dots<D>(s, &sK[c * S::RS], sQ, half);  // q_i . k_c
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int i = 2 * j + half;
      // padded query rows would contaminate dK / dV: their P is 0
      sP[c * S::PS + i] = i0 + i < Sq ? expf(scale * s[j] - sL[i]) : 0.f;
      s[j] = 0.f;
    }
    row_dots<D>(s, &sV[c * S::RS], sdO, half);  // dP = dO_i . v_c
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int i = 2 * j + half;
      sS[c * S::PS + i] = sP[c * S::PS + i] * (s[j] - sD[i]);
    }
    __syncthreads();  // the row partner's P / dS columns are written

    const int nrows = min(BQ, Sq - i0);
    for (int i = 0; i < nrows; ++i) {
      const float p = sP[c * S::PS + i];
      const float ds = sS[c * S::PS + i];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int col = (2 * g + half) * 4;
        const float4 gv = *reinterpret_cast<const float4*>(&sdO[i * S::RS + col]);
        const float4 qv = *reinterpret_cast<const float4*>(&sQ[i * S::RS + col]);
        acc_v[4 * g + 0] = fmaf(p, gv.x, acc_v[4 * g + 0]);
        acc_v[4 * g + 1] = fmaf(p, gv.y, acc_v[4 * g + 1]);
        acc_v[4 * g + 2] = fmaf(p, gv.z, acc_v[4 * g + 2]);
        acc_v[4 * g + 3] = fmaf(p, gv.w, acc_v[4 * g + 3]);
        acc_k[4 * g + 0] = fmaf(ds, qv.x, acc_k[4 * g + 0]);
        acc_k[4 * g + 1] = fmaf(ds, qv.y, acc_k[4 * g + 1]);
        acc_k[4 * g + 2] = fmaf(ds, qv.z, acc_k[4 * g + 2]);
        acc_k[4 * g + 3] = fmaf(ds, qv.w, acc_k[4 * g + 3]);
      }
    }
  }

  const int key = k0 + c;
  if (key < Sk) {
    T* krow = dk + b * st.t[4][0] + h * st.t[4][2] + (long long)key * st.t[4][1];
    T* vrow = dv + b * st.t[5][0] + h * st.t[5][2] + (long long)key * st.t[5][1];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        krow[(2 * g + half) * 4 + e] = from_f32<T>(scale * acc_k[4 * g + e]);
        vrow[(2 * g + half) * 4 + e] = from_f32<T>(acc_v[4 * g + e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K2 and K3 for bfloat16: the tensor-core loops of hopper_tc.cuh (bwd_dq_tc,
// bwd_dkv_tc) at this file's block shapes, under kernel names of their own
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

// K2: four warps per 64-row q tile, 64-key tiles, the key range split in
// 64-key units
template <int D>
using DqCfg = BwdCfg<D, 4, 1, 64, 64>;
// K3: four warps per 64-key tile; q tiles of 64 rows at D 64 and 32 at D 128
// (which keeps dK, dV in registers); the query range split in 64-row units
template <int D>
using DkvCfg = BwdCfg<D, 4, 1, D == 64 ? 64 : 32, 64>;

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::THREADS) flash_bwd_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, float* __restrict__ part_dq, int H, int Sq, int Sk,
    int splits, Strides st, float scale) {
  bwd_dq_tc<DqCfg<D>>(q, k, v, o, dout, lse, delta, dq, part_dq, H, Sq, Sk, splits, st, scale);
}

template <int D>
__global__ void flash_dq_merge_kernel(const float* __restrict__ part_dq, __nv_bfloat16* __restrict__ dq, int BH, int H,
                                      int Sq, int splits, Strides st, float scale) {
  dq_merge<D>(part_dq, dq, BH, H, Sq, splits, st, scale);
}

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::THREADS) flash_bwd_dkv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, float* __restrict__ part_dk,
    float* __restrict__ part_dv, int H, int Sq, int Sk, int splits, Strides st, float scale) {
  bwd_dkv_tc<DkvCfg<D>>(q, k, v, dout, lse, delta, dk, dv, part_dk, part_dv, H, Sq, Sk, splits, st, scale);
}

template <int D>
__global__ void flash_dkv_merge_kernel(const float* __restrict__ part_dk, const float* __restrict__ part_dv,
                                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int BH, int H,
                                       int Sk, int splits, Strides st) {
  dkv_merge<D>(part_dk, part_dv, dk, dv, BH, H, Sk, splits, st);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
              float* delta, void* dq, float* part_dq, int B, int H, int Sq, int Sk, int splits, const long long* s,
              float scale, cudaStream_t stream) {
  static uint64_t smem_set = 0;
  return launch_bwd_dq<DqCfg<D>>(flash_bwd_dq_tc_kernel<D>, flash_dq_merge_kernel<D>, smem_set, q, k, v, o, dout, lse,
                                 delta, dq, part_dq, B, H, Sq, Sk, splits, s, scale, stream);
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, float* part_dk, float* part_dv, int B, int H, int Sq, int Sk, int splits,
               const long long* s, float scale, cudaStream_t stream) {
  static uint64_t smem_set = 0;
  return launch_bwd_dkv<DkvCfg<D>>(flash_bwd_dkv_tc_kernel<D>, flash_dkv_merge_kernel<D>, smem_set, q, k, v, dout,
                                   lse, delta, dk, dv, part_dk, part_dv, B, H, Sq, Sk, splits, s, scale, stream);
}

}  // namespace tc

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
              float* delta, void* dq, int B, int H, int Sq, int Sk, const long long* strides, float scale,
              cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<float, D>;
  const int smem = (int)Smem<D>::dq_bytes;
  static uint64_t smem_set = 0;
  cudaError_t err = hopper::allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, NTHREADS, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                           static_cast<const float*>(v), static_cast<const float*>(o),
                                           static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), H,
                                           Sq, Sk, unpack(strides), scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int B, int H, int Sq, int Sk, const long long* strides, float scale,
               cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<float, D>;
  const int smem = (int)Smem<D>::dkv_bytes;
  static uint64_t smem_set = 0;
  cudaError_t err = hopper::allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sk + BK - 1) / BK, B * H);
  kernel<<<grid, NTHREADS, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                           static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
                                           static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Sk,
                                           unpack(strides), scale);
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int H, int Sq, int Sk) { return B > 0 && H > 0 && Sq > 0 && Sk > 0 && B * H <= 65535; }

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = float32, 1 = bfloat16.
// Each returns the cudaError_t of its launch (0 = launched), or
// cudaErrorInvalidValue for a head dim / dtype / shape it does not take.
//
// K2. strides: 18 element strides, (batch, seq, head) for q, k, v, o, dO, dQ
// in turn. lse [B*H, Sq] fp32 in; delta [B*H, Sq] fp32 out. bfloat16 runs
// the tensor-core kernel over `splits` ranges of the key axis (fp32 partials
// part_dq [splits, B*H, Sq, D], then the merge; unused when splits is 1);
// float32 runs the SIMT kernel, which does not split.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                      const float* lse, float* delta, void* dq, float* part_dq, int dtype, int B,
                                      int H, int Sq, int Sk, int D, int splits, const long long* strides, float scale,
                                      void* stream) {
  if (!shape_ok(B, H, Sq, Sk) || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && splits == 1 && D == 64)
    return launch_dq<64>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Sk, strides, scale, s);
  if (dtype == 0 && splits == 1 && D == 128)
    return launch_dq<128>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Sk, strides, scale, s);
  if (dtype == 1 && D == 64)
    return tc::launch_dq<64>(q, k, v, o, dout, lse, delta, dq, part_dq, B, H, Sq, Sk, splits, strides, scale, s);
  if (dtype == 1 && D == 128)
    return tc::launch_dq<128>(q, k, v, o, dout, lse, delta, dq, part_dq, B, H, Sq, Sk, splits, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}

// K3. strides: 18 element strides, (batch, seq, head) for q, k, v, dO, dK, dV
// in turn. lse and delta [B*H, Sq] fp32 in (delta as K2 wrote it). bfloat16
// runs the tensor-core kernel over `splits` ranges of the query axis (fp32
// partials part_dk / part_dv [splits, B*H, Sk, D], then the merge; unused
// when splits is 1); float32 runs the SIMT kernel, which does not split.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                       const float* lse, const float* delta, void* dk, void* dv, float* part_dk,
                                       float* part_dv, int dtype, int B, int H, int Sq, int Sk, int D, int splits,
                                       const long long* strides, float scale, void* stream) {
  if (!shape_ok(B, H, Sq, Sk) || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && splits == 1 && D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, strides, scale, s);
  if (dtype == 0 && splits == 1 && D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, strides, scale, s);
  if (dtype == 1 && D == 64)
    return tc::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, part_dk, part_dv, B, H, Sq, Sk, splits, strides,
                              scale, s);
  if (dtype == 1 && D == 128)
    return tc::launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, part_dk, part_dv, B, H, Sq, Sk, splits, strides,
                               scale, s);
  return (int)cudaErrorInvalidValue;
}
