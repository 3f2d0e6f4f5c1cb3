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
// sequential axis becomes a loop inside the block over tiles of the streamed
// operand (keys for K4b, queries for K4c), with the accumulators in
// registers. Where the grid is small for the 132 SMs the loop's range is
// split across blocks (grid z) in 32-row units: each split writes fp32
// partials, and a merge kernel sums them in split order. No float atomics:
// two runs give the same bits, as train/checkpoint.py's bit-identical resume
// needs.
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
// or 16 tokens against as many keys or 77) the bytes bound them in bf16
// (3.35 TB/s: 1.2 us at 256^2 with 8 heads) and the flops in fp32 (at the
// 3xTF32 rate, 494.7 / 3 TFLOP/s: 3.1 and 4.1 us), and a call is a few
// microseconds of work spread over a grid of a few dozen blocks.
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
//
// float32: kgrid_bwd_dq_tf32_kernel (K4b) and kgrid_bwd_dkv_tf32_kernel (K4c)
// (null-text inversion editing, every precision: float32 SD1.5 config), the
// same bodies, splits and merges with fp32 tiles and every product on the
// tensor cores in fp32 accuracy, as fp32 K2 and K3 run them
// (flash_attention_bwd.cu): mma.sync m16n8k8 TF32 issued three times over
// operands split into TF32 halves, into a fresh fp32 sum per 8-deep k step
// that is added to the accumulator on the CUDA cores (mma_tf32x3), which
// holds 1e-4 * max(1, |ref|) with one key and large logits. They replace
// the first SIMT kernels (fp32 math on the CUDA cores, 3-6 % of the bound).
// Design:
//   * fp32 rows are twice bf16's, so shared memory (232,448 bytes a block)
//     decides the block: 32 owned rows (two slabs) up to D 256 and 16 above
//     (ops/flash_attention_kgrid.py::bwd_rows_per_block), 32-row streamed
//     tiles up to D 192 and 16-row ones above, both in the 32-row split
//     units of bf16 (pick_k4b_splits, pick_dkv_splits: the same rules over
//     the fp32 blocks; SD1.5's 256^2 splits both 2 ways). Shared memory
//     (TcDqCfg32, TcDkvCfg32; K4c 0.25-0.5 KB more): 48 / 96 / 144 / 128 /
//     120 / 144 / 168 / 192 KB at D 64 / 128 / ... / 512;
//   * the warps sharing a slab are the register knob: each computes the
//     slab's S and dP over the whole head dim and owns DC = D / CS of the
//     gradient columns; 64 columns a warp keep K4c's dK and dV in
//     registers at every D. At D 192, the path's, the counts are the
//     fastest of those timed there on an H100: K4b two warps (96 columns;
//     three were slower), K4c four (48 columns; three, six and eight were
//     slower, and two spilled); 16-row streamed tiles were slower than 32
//     at every count (twice the barriers, half the independent products a
//     k step);
//   * ptxas, registers at D 64 / 128 / 192 / 256 / 320 / 384 / 448 / 512:
//     K4b 143 / 190 / 189 / 155 / 138 / 136 / 144 / 155, K4c 184 / 185 /
//     179 / 188 / 168 / 168 / 184 / 188, the merges 32-34; no spills.
//   Measured (bench_attention.py --sections fp32, device time, NVIDIA H100
//   80GB HBM3, 700.00 W), SD1.5's 256^2 with 8 heads of 160 run at 192: K4b
//   0.045 ms and K4c 0.054 ms, 6.8 and 7.5 % of the bound (the SIMT
//   kernels: 0.098 and 0.070), the pair 0.76x SDPA's fp32 whole backward
//   (PERF.md, section 6). What holds them back: the grid is 128 blocks (64
//   q or key tiles x 2 splits), one a SM (144 KB), so an SM runs 4 (K4b) or
//   8 (K4c) warps, each a chain of dependent ldmatrix, TF32 splits and HMMA
//   with little to hide its latency, and a slab's warps each recompute its
//   S and dP.
//
// Every kernel here reads rows with 16-byte loads (cp.async, K4b's O): the
// wrappers make one contiguous copy of a tensor whose rows do not start on
// 16 bytes, and these entry points return cudaErrorInvalidValue for one that
// reaches them anyway.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_tc.cuh"

namespace {

using hopper::Strides;

constexpr int MAX_SPLITS = 64;

// ---------------------------------------------------------------------------
// K4b / K4c: the tensor-core loops of hopper_tc.cuh (bwd_dq_tc, bwd_dkv_tc)
// at this file's block shapes, under kernel names of their own: bf16
// (m16n8k16) and fp32 (3xTF32 m16n8k8)
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

// bf16: four 16-row slabs a block at D <= 128, two above; 1 / 2 / 4 warps
// share a slab at D <= 128 / 192-256 / 320-512; 32-row streamed tiles, which
// are also the unit of both splits.
template <int D>
using TcCfg = BwdCfg<D, D <= 128 ? 4 : 2, D <= 128 ? 1 : D <= 256 ? 2 : 4, 32, 32>;
// fp32 (see the header): two slabs (32 rows) at D <= 256, one above; D / 64
// warps share a slab (64 gradient columns each), but at D 192 two in K4b (96
// columns) and four in K4c (48), the fastest counts measured there; 32-row
// streamed tiles up to D 192, 16 above; both split in 32-row units, as bf16.
template <int D>
using TcDqCfg32 = BwdCfg<D, D <= 256 ? 2 : 1, D == 192 ? 2 : D / 64, D <= 192 ? 32 : 16, 32, float>;
template <int D>
using TcDkvCfg32 = BwdCfg<D, D <= 256 ? 2 : 1, D == 192 ? 4 : D / 64, D <= 192 ? 32 : 16, 32, float>;

template <int D>
__global__ void __launch_bounds__(TcCfg<D>::THREADS) kgrid_bwd_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, float* __restrict__ part_dq, int H, int Sq, int Sk,
    int splits, Strides st, float scale) {
  bwd_dq_tc<TcCfg<D>>(q, k, v, o, dout, lse, delta, dq, part_dq, H, Sq, Sk, splits, st, scale);
}

template <int D>
__global__ void __launch_bounds__(TcDqCfg32<D>::THREADS) kgrid_bwd_dq_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, float* __restrict__ dq, float* __restrict__ part_dq, int H, int Sq, int Sk, int splits,
    Strides st, float scale) {
  bwd_dq_tc<TcDqCfg32<D>>(q, k, v, o, dout, lse, delta, dq, part_dq, H, Sq, Sk, splits, st, scale);
}

template <int D, typename T>
__global__ void kgrid_dq_merge_kernel(const float* __restrict__ part_dq, T* __restrict__ dq, int BH, int H, int Sq,
                                      int splits, Strides st, float scale) {
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
__global__ void __launch_bounds__(TcDkvCfg32<D>::THREADS) kgrid_bwd_dkv_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ part_dk, float* __restrict__ part_dv, int H,
    int Sq, int Sk, int splits, Strides st, float scale) {
  bwd_dkv_tc<TcDkvCfg32<D>>(q, k, v, dout, lse, delta, dk, dv, part_dk, part_dv, H, Sq, Sk, splits, st, scale);
}

template <int D, typename T>
__global__ void kgrid_dkv_merge_kernel(const float* __restrict__ part_dk, const float* __restrict__ part_dv,
                                       T* __restrict__ dk, T* __restrict__ dv, int BH, int H, int Sk, int splits,
                                       Strides st) {
  dkv_merge<D>(part_dk, part_dv, dk, dv, BH, H, Sk, splits, st);
}

// K4b for element type T (fp32 or bf16) and head dim D
template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
              float* delta, void* dq, float* part_dq, int B, int H, int Sq, int Sk, int splits, const long long* s,
              float scale, cudaStream_t stream) {
  static uint64_t smem_set = 0;
  if constexpr (std::is_same<T, float>::value)
    return launch_bwd_dq<TcDqCfg32<D>>(kgrid_bwd_dq_tf32_kernel<D>, kgrid_dq_merge_kernel<D, float>, smem_set, q, k, v,
                                     o, dout, lse, delta, dq, part_dq, B, H, Sq, Sk, splits, s, scale, stream);
  else
    return launch_bwd_dq<TcCfg<D>>(kgrid_bwd_dq_tc_kernel<D>, kgrid_dq_merge_kernel<D, __nv_bfloat16>, smem_set, q,
                                   k, v, o, dout, lse, delta, dq, part_dq, B, H, Sq, Sk, splits, s, scale, stream);
}

// K4c for element type T (fp32 or bf16) and head dim D
template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, float* part_dk, float* part_dv, int B, int H, int Sq, int Sk, int splits,
               const long long* s, float scale, cudaStream_t stream) {
  static uint64_t smem_set = 0;
  if constexpr (std::is_same<T, float>::value)
    return launch_bwd_dkv<TcDkvCfg32<D>>(kgrid_bwd_dkv_tf32_kernel<D>, kgrid_dkv_merge_kernel<D, float>, smem_set, q, k,
                                      v, dout, lse, delta, dk, dv, part_dk, part_dv, B, H, Sq, Sk, splits, s, scale,
                                      stream);
  else
    return launch_bwd_dkv<TcCfg<D>>(kgrid_bwd_dkv_tc_kernel<D>, kgrid_dkv_merge_kernel<D, __nv_bfloat16>, smem_set,
                                    q, k, v, dout, lse, delta, dk, dv, part_dk, part_dv, B, H, Sq, Sk, splits, s,
                                    scale, stream);
}

}  // namespace tc

#define KGRID_HEAD_DIM_CASES(X) X(64) X(128) X(192) X(256) X(320) X(384) X(448) X(512)

// dtype 0: the fp32 (3xTF32) kernels; 1: the bf16 ones
int dispatch_dq(int dtype, const void* q, const void* k, const void* v, const void* o, const void* dout,
                const float* lse, float* delta, void* dq, float* part_dq, int B, int H, int Sq, int Sk, int D,
                int splits, const long long* strides, float scale, cudaStream_t s) {
  switch (D) {
#define CASE(DD)                                                                                                    \
  case DD:                                                                                                          \
    return dtype == 0 ? tc::launch_dq<float, DD>(q, k, v, o, dout, lse, delta, dq, part_dq, B, H, Sq, Sk, splits, \
                                                 strides, scale, s)                                                 \
                      : tc::launch_dq<__nv_bfloat16, DD>(q, k, v, o, dout, lse, delta, dq, part_dq, B, H, Sq, Sk,  \
                                                         splits, strides, scale, s);
    KGRID_HEAD_DIM_CASES(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_dkv(int dtype, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 const float* delta, void* dk, void* dv, float* pdk, float* pdv, int B, int H, int Sq, int Sk, int D,
                 int splits, const long long* strides, float scale, cudaStream_t s) {
  switch (D) {
#define CASE(DD)                                                                                                    \
  case DD:                                                                                                          \
    return dtype == 0 ? tc::launch_dkv<float, DD>(q, k, v, dout, lse, delta, dk, dv, pdk, pdv, B, H, Sq, Sk,      \
                                                  splits, strides, scale, s)                                        \
                      : tc::launch_dkv<__nv_bfloat16, DD>(q, k, v, dout, lse, delta, dk, dv, pdk, pdv, B, H, Sq,   \
                                                          Sk, splits, strides, scale, s);
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
// out. Both dtypes run the tensor-core kernel over `splits` ranges of the key
// axis (fp32 partials part_dq [splits, B*H, Sq, D], then the merge; unused
// when splits is 1).
extern "C" int flash_attention_kgrid_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                            const void* dout, const float* lse, float* delta, void* dq,
                                            float* part_dq, int dtype, int B, int H, int Sq, int Sk, int D,
                                            int splits, const long long* strides, float scale, void* stream) {
  if (!shape_ok(B, H, Sq, Sk) || splits < 1 || splits > MAX_SPLITS || (dtype != 0 && dtype != 1))
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
