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
// the gradients moved once: the bf16 tensor-core rate (989 TFLOP/s), and in
// fp32 the rate of fp32-accurate products on the tensor cores (3 TF32 passes:
// 494.7 / 3 = 164.9 TFLOP/s), bound them at the paths' self-attentions of
// 1024 and 4096 tokens, the bytes (3.35 TB/s) at the 77-key
// cross-attentions and at 256 tokens.
//
// By dtype:
//
// The kernels' bodies (bwd_dq_tc, bwd_dkv_tc and their merges dq_merge,
// dkv_merge) live in hopper_tc.cuh, over a block shape and element type,
// where K4b/K4c (flash_attention_kgrid_bwd.cu) run them in bf16 at other
// block shapes; the kernels here are thin wrappers that fix this file's
// shapes (DqCfg, DkvCfg; fp32 DqCfg32, DkvCfg32) and names.
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
// K2 and K3, float32: flash_bwd_dq_tf32_kernel and flash_bwd_dkv_tf32_kernel
// (null-text inversion editing, every precision: float32 config), the same
// bodies, blocks, rings, split rules and merges with fp32 tiles, every
// product on the tensor cores in fp32 accuracy. They replace the first SIMT
// kernels (fp32 math on the CUDA cores, 1-3 % of the bound). Design:
//   * each product is mma.sync m16n8k8 TF32 issued three times over
//     operands split into TF32 halves, x = big + small (tf32_split: x rounded
//     to nearest, then the exact residual rounded again): small*big +
//     big*small + big*big into a fresh fp32 sum per 8-deep k step, added to
//     the accumulator on the CUDA cores (mma_tf32x3). One TF32 pass keeps
//     about 2^-11 of a product and misses the fp32 bound of
//     1e-4 * max(1, |ref|) (tests/test_torch_tf32x3.py); three keep about
//     2^-21. The fresh sum per step matters as much: summed straight into
//     the accumulator, the tensor cores' truncated sums grew with the k loop
//     and missed the bound with one key and large logits
//     (tests/test_torch_cuda.py::test_fp32_k2_k3_on_ragged_lengths);
//   * tiles are fp32 rows in 16-byte chunks of 4 floats, XOR-swizzled by
//     (row & 7) as the bf16 ones, through the same 2-stage cp.async ring.
//     The non-transposed ldmatrix moves 32-bit words as b16 pairs, so it
//     gives the TF32 A fragment and the B fragments of S = Q K^T and dP =
//     dO V^T as it gives bf16's (keys_by_q_tf32). ldmatrix has no 32-bit
//     transpose: the B operand of dQ += dS K (K3: dV += P^T dO, dK += dS^T
//     Q) is read one float per lane, on 32 distinct banks under the
//     swizzle, and that product takes its k steps in a permuted order (k = t
//     is key 2t, k = t + 4 key 2t + 1) in which the accumulator layout of dS
//     is the A fragment, with no shuffle (keys_by_d_tf32);
//   * streamed tiles of 64 rows at D 64 and 16 at D 128: shared memory K2
//     96 KB and K3 97 KB at D 64, 96 and 96.3 KB at D 128, two blocks an SM.
//   ptxas: K2 187 registers at D 64, 168 at D 128, no spills; K3 255 at both,
//   8 and 104 bytes spilled.
//   What bounds them: 6 and 8 * BH*Sq*Sk*D flops at the 3xTF32 rate at the
//   self-attentions; but the SASS holds about 14 other instructions for
//   each HMMA (3696 and 240 in K2 at D 64: the B operands' splits, the
//   per-step sums, addresses, exp), each warp splitting the streamed tile
//   again, so the kernels are issue-bound well under that rate.
//   Measured (bench_attention.py --sections fp32, device time, NVIDIA H100
//   80GB HBM3, 700.00 W), SD1.5's null-text inner step, rows 1, 8 heads:
//   4096^2 (d 40 run at 64) K2 1.34 ms and K3 1.58-1.59 ms, 15 and 16 % of
//   the bound at d 40 (the SIMT kernels: 3.59 and 4.36 ms), the pair 1.16x
//   SDPA's fp32 backward (efficient backend); 1024^2 (d 80 run at 128)
//   0.255 and 0.32 ms (0.65, 0.66), 1.95x; 4096x77 (16 query splits in K3)
//   0.048 and 0.057 ms (0.107, 1.53), 0.11x; 1024x77 0.031 and 0.112 ms
//   (0.082, 0.644), 0.52x. One inner step's K2+K3: 53.6 -> 16 ms of device
//   time (PERF.md, section 6).
//
// Every kernel here reads rows with 16-byte loads (cp.async, K2's O): the
// wrapper makes one contiguous copy of a tensor whose rows fail the check,
// and these entry points return cudaErrorInvalidValue for one that reaches
// them anyway.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tc.cuh"

namespace {

using hopper::Strides;

// ---------------------------------------------------------------------------
// K2 and K3: the tensor-core loops of hopper_tc.cuh (bwd_dq_tc, bwd_dkv_tc)
// at this file's block shapes, under kernel names of their own: bf16
// (m16n8k16) and fp32 (3xTF32 m16n8k8)
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

// bf16 K2: four warps per 64-row q tile, 64-key tiles, the key range split in
// 64-key units
template <int D>
using DqCfg = BwdCfg<D, 4, 1, 64, 64>;
// bf16 K3: four warps per 64-key tile; q tiles of 64 rows at D 64 and 32 at
// D 128 (which keeps dK, dV in registers); the query range split in 64-row
// units
template <int D>
using DkvCfg = BwdCfg<D, 4, 1, D == 64 ? 64 : 32, 64>;
// fp32 K2 and K3: the same blocks and split units; streamed tiles of 64 rows
// at D 64 and 16 at D 128, where fp32 rows of 512 bytes would otherwise keep
// a block's shared memory above half the SM's
template <int D>
using DqCfg32 = BwdCfg<D, 4, 1, D == 64 ? 64 : 16, 64, float>;
template <int D>
using DkvCfg32 = BwdCfg<D, 4, 1, D == 64 ? 64 : 16, 64, float>;

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::THREADS) flash_bwd_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, float* __restrict__ part_dq, int H, int Sq, int Sk,
    int splits, Strides st, float scale) {
  bwd_dq_tc<DqCfg<D>>(q, k, v, o, dout, lse, delta, dq, part_dq, H, Sq, Sk, splits, st, scale);
}

template <int D>
__global__ void __launch_bounds__(DqCfg32<D>::THREADS) flash_bwd_dq_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, float* __restrict__ dq, float* __restrict__ part_dq, int H, int Sq, int Sk, int splits,
    Strides st, float scale) {
  bwd_dq_tc<DqCfg32<D>>(q, k, v, o, dout, lse, delta, dq, part_dq, H, Sq, Sk, splits, st, scale);
}

template <int D, typename T>
__global__ void flash_dq_merge_kernel(const float* __restrict__ part_dq, T* __restrict__ dq, int BH, int H, int Sq,
                                      int splits, Strides st, float scale) {
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
__global__ void __launch_bounds__(DkvCfg32<D>::THREADS) flash_bwd_dkv_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ part_dk, float* __restrict__ part_dv, int H,
    int Sq, int Sk, int splits, Strides st, float scale) {
  bwd_dkv_tc<DkvCfg32<D>>(q, k, v, dout, lse, delta, dk, dv, part_dk, part_dv, H, Sq, Sk, splits, st, scale);
}

template <int D, typename T>
__global__ void flash_dkv_merge_kernel(const float* __restrict__ part_dk, const float* __restrict__ part_dv,
                                       T* __restrict__ dk, T* __restrict__ dv, int BH, int H, int Sk, int splits,
                                       Strides st) {
  dkv_merge<D>(part_dk, part_dv, dk, dv, BH, H, Sk, splits, st);
}

// K2 for element type T (fp32 or bf16) and head dim D
template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
              float* delta, void* dq, float* part_dq, int B, int H, int Sq, int Sk, int splits, const long long* s,
              float scale, cudaStream_t stream) {
  static uint64_t smem_set = 0;
  if constexpr (std::is_same<T, float>::value)
    return launch_bwd_dq<DqCfg32<D>>(flash_bwd_dq_tf32_kernel<D>, flash_dq_merge_kernel<D, float>, smem_set, q, k, v,
                                     o, dout, lse, delta, dq, part_dq, B, H, Sq, Sk, splits, s, scale, stream);
  else
    return launch_bwd_dq<DqCfg<D>>(flash_bwd_dq_tc_kernel<D>, flash_dq_merge_kernel<D, __nv_bfloat16>, smem_set, q,
                                   k, v, o, dout, lse, delta, dq, part_dq, B, H, Sq, Sk, splits, s, scale, stream);
}

// K3 for element type T (fp32 or bf16) and head dim D
template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, float* part_dk, float* part_dv, int B, int H, int Sq, int Sk, int splits,
               const long long* s, float scale, cudaStream_t stream) {
  static uint64_t smem_set = 0;
  if constexpr (std::is_same<T, float>::value)
    return launch_bwd_dkv<DkvCfg32<D>>(flash_bwd_dkv_tf32_kernel<D>, flash_dkv_merge_kernel<D, float>, smem_set, q, k,
                                       v, dout, lse, delta, dk, dv, part_dk, part_dv, B, H, Sq, Sk, splits, s, scale,
                                       stream);
  else
    return launch_bwd_dkv<DkvCfg<D>>(flash_bwd_dkv_tc_kernel<D>, flash_dkv_merge_kernel<D, __nv_bfloat16>, smem_set,
                                     q, k, v, dout, lse, delta, dk, dv, part_dk, part_dv, B, H, Sq, Sk, splits, s,
                                     scale, stream);
}

}  // namespace tc

bool shape_ok(int B, int H, int Sq, int Sk) { return B > 0 && H > 0 && Sq > 0 && Sk > 0 && B * H <= 65535; }

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = float32, 1 = bfloat16.
// Each returns the cudaError_t of its launch (0 = launched), or
// cudaErrorInvalidValue for a head dim / dtype / shape it does not take.
//
// K2. strides: 18 element strides, (batch, seq, head) for q, k, v, o, dO, dQ
// in turn. lse [B*H, Sq] fp32 in; delta [B*H, Sq] fp32 out. Both dtypes run
// the tensor-core kernel over `splits` ranges of the key axis (fp32 partials
// part_dq [splits, B*H, Sq, D], then the merge; unused when splits is 1).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                      const float* lse, float* delta, void* dq, float* part_dq, int dtype, int B,
                                      int H, int Sq, int Sk, int D, int splits, const long long* strides, float scale,
                                      void* stream) {
  if (!shape_ok(B, H, Sq, Sk) || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return tc::launch_dq<float, 64>(q, k, v, o, dout, lse, delta, dq, part_dq, B, H, Sq, Sk, splits, strides, scale,
                                    s);
  if (dtype == 0 && D == 128)
    return tc::launch_dq<float, 128>(q, k, v, o, dout, lse, delta, dq, part_dq, B, H, Sq, Sk, splits, strides, scale,
                                     s);
  if (dtype == 1 && D == 64)
    return tc::launch_dq<__nv_bfloat16, 64>(q, k, v, o, dout, lse, delta, dq, part_dq, B, H, Sq, Sk, splits, strides,
                                            scale, s);
  if (dtype == 1 && D == 128)
    return tc::launch_dq<__nv_bfloat16, 128>(q, k, v, o, dout, lse, delta, dq, part_dq, B, H, Sq, Sk, splits, strides,
                                             scale, s);
  return (int)cudaErrorInvalidValue;
}

// K3. strides: 18 element strides, (batch, seq, head) for q, k, v, dO, dK, dV
// in turn. lse and delta [B*H, Sq] fp32 in (delta as K2 wrote it). Both
// dtypes run the tensor-core kernel over `splits` ranges of the query axis
// (fp32 partials part_dk / part_dv [splits, B*H, Sk, D], then the merge;
// unused when splits is 1).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                       const float* lse, const float* delta, void* dk, void* dv, float* part_dk,
                                       float* part_dv, int dtype, int B, int H, int Sq, int Sk, int D, int splits,
                                       const long long* strides, float scale, void* stream) {
  if (!shape_ok(B, H, Sq, Sk) || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return tc::launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, part_dk, part_dv, B, H, Sq, Sk, splits,
                                     strides, scale, s);
  if (dtype == 0 && D == 128)
    return tc::launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, part_dk, part_dv, B, H, Sq, Sk, splits,
                                      strides, scale, s);
  if (dtype == 1 && D == 64)
    return tc::launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv, part_dk, part_dv, B, H, Sq, Sk, splits,
                                             strides, scale, s);
  if (dtype == 1 && D == 128)
    return tc::launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv, part_dk, part_dv, B, H, Sq, Sk,
                                              splits, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}
