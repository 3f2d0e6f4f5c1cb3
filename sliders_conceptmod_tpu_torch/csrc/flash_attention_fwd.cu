// Flash-attention forward for Hopper (sm_90a): O = softmax(scale * Q K^T) V
// and the row logsumexp, bidirectional (no mask). Kernel K1.
//
// Replaces the TPU kernel sliders_conceptmod_tpu/ops/flash_attention.py::
// _fwd_kernel (launched by _flash_fwd_impl). It computes the same function:
// an online (max, sum, acc) carry over K tiles with fp32 statistics, keys
// past Sk masked to NEG_INF = -1e30 before the max (so exp() of a masked
// score is an exact 0), output cast back to the input dtype, and
// lse = m + log(l) stored as fp32 [B*H, Sq] (K2 and K3 read it; the TPU's
// lane-replicated [..., 128] lse layout was a tiling workaround and is not
// carried over).
//
// Layout: BSHD [B, S, H, D] with arbitrary batch/seq/head strides (in
// elements) and unit stride over D, so the caller needs no fold or pad copy.
// D is 64 or 128 (the dispatch zero-pads other head dims up to a multiple of
// 64). The entry point dispatches by dtype:
//
// * bfloat16 -> flash_fwd_tc_kernel, on the tensor cores. What bounds it on
//   the H100 (4*B*H*Sq*Sk*D flops at the unpadded D against Q, K, V and O
//   moved once): the bf16 tensor-core rate (989 TFLOP/s) at every path
//   self-attention of 1024 or 4096 tokens; the bytes (3.35 TB/s) at the
//   77-key cross-attentions and at 256 tokens, where a call is a few
//   microseconds. Design:
//     - one block of two consumer warpgroups (256 threads) per (batch*head,
//       128-row q tile); warpgroup w owns q rows 64w..64w+63;
//     - S = Q K^T with wgmma.mma_async m64n128k16, Q and K read from shared
//       memory (K stored [keys, d] is K-major for B); the scale is applied
//       to S in fp32 after the product (q is never rounded after scaling);
//     - the online softmax stays in registers (base 2: x = s * scale *
//       log2(e)); a row's max and sum reduce over the four threads of a
//       quad with __shfl_xor; P is rounded to bf16 in the accumulator's own
//       layout, which is the register A-fragment layout of the next product;
//     - O += P V with wgmma m64n64k16, A = P from registers, B = V from
//       shared memory with the transpose flag (V stored [keys, d] is
//       MN-major), one product per 64-column half of the head dim;
//     - Q and a 2-stage ring of 128-key K/V tiles are filled by TMA
//       (cp.async.bulk.tensor, 4-D maps over (D, S, H, B) encoded per call
//       from the tensor's strides), completion on mbarriers, with the
//       128-byte swizzle the wgmma descriptors read: each tile is stored as
//       64-column sub-tiles of 128-byte rows. One thread issues the copy of
//       tile j+2 once both warpgroups are done with tile j, so a tile's copy
//       overlaps the previous tile's products;
//     - ragged Sq and Sk: TMA zero-fills the box past the tensor's end;
//       padded key columns are set to -1e30 before the max, padded q rows
//       are never stored;
//     - shared memory per block: Q 128 x D + 2 stages x (K + V) 128 x D, bf16:
//       80 KB at D 64, 160 KB at D 128 (plus 1 KB to align the base to the
//       swizzle's 1024 bytes). ptxas: 127 registers at D 64 (capped at 128
//       by __launch_bounds__ so that two blocks share an SM and one block's
//       softmax overlaps the other's products), 173 at D 128; no spills.
//   Measured (bench_attention.py, device time, NVIDIA H100 80GB HBM3,
//   700.00 W): serving's 4096^2 (2 rows, 10 heads) 0.208 ms, 412 TFLOP/s,
//   42 % of the bound, 1.10x SDPA's forward; its 1024^2 29 %, its 77-key
//   crosses 29-36 %; SD1.5's and SD2.1's 4096^2 26 %; the training paths'
//   1024- and 256-token shapes 7-16 %. 0.89-1.30x SDPA's forward at every
//   path shape (PERF.md, section 6).
//   TMA needs 16-byte-aligned base addresses and strides. The wrapper
//   (ops/flash_attention.py) makes one contiguous copy of a bf16 tensor
//   that fails the check; this entry point returns cudaErrorInvalidValue
//   for one that reaches it anyway.
//
// * float32 -> flash_fwd_tf32_kernel (null-text inversion editing, every
//   `precision: float32` config), on the tensor cores in fp32 accuracy; it
//   replaced the first (SIMT) kernel, fp32 math on the CUDA cores at 5 % of
//   the bound at 4096^2. What bounds it: 4*B*H*Sq*Sk*D flops at the rate of
//   fp32-accurate products on the tensor cores, three TF32 passes each
//   (494.7 / 3 = 164.9 TFLOP/s), at the edit path's self-attentions (4096^2
//   at d 40 -> 64, 1024^2 at d 80 -> 128); the bytes at the 77-key crosses.
//   One TF32 pass keeps about 2^-11 of a product and misses the fp32 bound
//   of 1e-4 * max(1, |ref|) (tests/test_torch_fwd_tf32x3.py); three keep
//   about 2^-21. Design (hopper_tc.cuh: FwdCfg, fwd_tf32):
//     - one block per (batch*head, 128-row q tile, split of the key range):
//       at D 64 four warps of two 16-row m-tiles each, so every K and V
//       fragment a warp reads feeds two products; at D 128 eight warps of
//       one. A warp keeps its rows' scores and O (fp32) in registers; every
//       product is mma.sync m16n8k8 TF32 issued three times over operands
//       split into TF32 halves (x = big + small; small*big + big*small +
//       big*big into a fresh sum per 8-deep k step, added on the CUDA cores);
//     - each operand is split once, by the block, not by every warp that
//       reads it (what held PR 22's backward kernels to 15 % of their
//       bound: the instructions around each product): Q, times
//       scale * log2(e), before the key loop; each K and V tile as it comes
//       in, into big and small shared tiles whose TF32 words the warps read
//       with ldmatrix. V is stored transposed with its keys permuted within
//       each 8, so that P's accumulator layout is the A fragment of O += P V
//       and V's B fragments come by the non-transposed ldmatrix;
//     - K and V tiles of 16 keys are prefetched into registers one tile
//       ahead with 16-byte loads, split and stored between two barriers; the
//       online softmax in base 2 with fp32 statistics;
//     - where the q tiles leave SMs idle (fewer than 132 blocks: two share an
//       SM at D 64; 1024^2 with 8 heads gives 64) the key range splits
//       across blocks in 32-key units (ops/flash_attention.py::
//       pick_k1_splits); each split writes unnormalised fp32 partials and
//       flash_fwd_merge_kernel (K4a's merge, fwd_merge) combines them;
//     - shared memory: Q + K + V^T, big and small, 80 KB at D 64, 160 KB at
//       D 128.
//   Measured (bench_attention.py, device time, NVIDIA H100 80GB HBM3,
//   700.00 W): SD1.5's 4096^2 (8 heads of 40 run at 64) 0.709 ms, 18 % of
//   the bound, 0.54x SDPA's fp32 forward (the SIMT kernel: 2.64-2.66 ms);
//   1024^2 (80 run at 128, 5 splits) 0.151-0.153 ms, 11 %, 1.71-1.74x; the
//   77-key crosses 0.019-0.022 ms. Splitting per warp instead measured
//   1.05-1.10x slower at the self-attentions (bench_attention.py --sections
//   variants). Shared memory, not the
//   tensor cores, bounds it: each product reads its B fragment, pre-split
//   twice over, from shared memory (PERF.md, section 6).
//   16-byte loads need 16-byte-aligned rows: the wrapper copies a tensor
//   that fails the check once (_aligned), and this entry point returns
//   cudaErrorInvalidValue for one that reaches it anyway.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tc.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), TMA-fed
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int BM = 128;        // q rows per block: 64 per consumer warpgroup
constexpr int BN = 128;        // keys per K/V tile
constexpr int NTHREADS = 256;  // two warpgroups
constexpr int STAGES = 2;      // K/V ring depth

// Shared memory of one block, byte offsets from a 1024-aligned base. A tile
// of R rows x D columns is stored as D/64 sub-tiles of R rows x 128 bytes,
// each in the 128-byte-swizzled layout TMA writes and wgmma reads.
template <int D>
struct Layout {
  static constexpr int NSUB = D / 64;
  static constexpr int Q_SUB = BM * 128;
  static constexpr int KV_SUB = BN * 128;
  static constexpr int Q_BYTES = NSUB * Q_SUB;
  static constexpr int KV_BYTES = NSUB * KV_SUB;  // one K (or V) tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;  // bar_q, full[0], full[1]
  static constexpr int BYTES = BAR_OFF + 64 + 1024;          // + slack to align the base
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 2 : 1) flash_fwd_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int Sq,
    int Sk, long long o_sb, long long o_ss, long long o_sh, float scale_log2) {
  using L = Layout<D>;
  constexpr int NSUB = L::NSUB;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + L::K_OFF, sV = base + L::V_OFF;
  const uint32_t bar_q = base + L::BAR_OFF;  // full[st] at bar_q + 8 * (1 + st)

  const int tid = threadIdx.x;
  const int wg = tid >> 7;          // consumer warpgroup
  const int warp = (tid >> 5) & 3;  // warp of the warpgroup: 16 q rows each
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // a thread holds rows g, g + 8 and columns 2t, 2t + 1 of each 8-column chunk
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BM;
  const int num_k = (Sk + BN - 1) / BN;

  auto load_kv = [&](int tile, int st) {
    const uint32_t bar = bar_q + 8 * (1 + st);
    mbar_expect_tx(bar, 2 * L::KV_BYTES);
#pragma unroll
    for (int s = 0; s < NSUB; ++s) {
      tma_load(sK + st * L::KV_BYTES + s * L::KV_SUB, &tm_k, bar, 64 * s, tile * BN, h, b);
      tma_load(sV + st * L::KV_BYTES + s * L::KV_SUB, &tm_v, bar, 64 * s, tile * BN, h, b);
    }
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q + 8, 1);
    mbar_init(bar_q + 16, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
    for (int s = 0; s < NSUB; ++s) tma_load(sQ + s * L::Q_SUB, &tm_q, bar_q, 64 * s, q0, h, b);
    for (int st = 0; st < STAGES && st < num_k; ++st) load_kv(st, st);
  }

  float acc[NSUB][32];
#pragma unroll
  for (int s = 0; s < NSUB; ++s)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[s][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};  // running max of x = score * scale * log2(e), rows g and g + 8
  float l_r[2] = {0.f, 0.f};          // this thread's part of the running sum (quad-reduced at the end)
  const uint32_t q_rows = sQ + wg * 64 * 128;  // this warpgroup's 64 rows of each Q sub-tile

  mbar_wait(bar_q, 0);
  for (int kt = 0; kt < num_k; ++kt) {
    const int st = kt & 1;
    mbar_wait(bar_q + 8 * (1 + st), (kt >> 1) & 1);
    const uint32_t k_tile = sK + st * L::KV_BYTES;
    const uint32_t v_tile = sV + st * L::KV_BYTES;

    // S = Q K^T over D in steps of 16 (32 bytes inside a 128-byte swizzled row)
    float s_acc[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_m64n128k16_ss(s_acc, sw128_desc(q_rows + (kk >> 2) * L::Q_SUB + off, 16, 1024),
                          sw128_desc(k_tile + (kk >> 2) * L::KV_SUB + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s_acc);

    // online softmax: chunk c holds keys 8c + 2t (+1) of rows g (e = 0, 1) and g + 8 (e = 2, 3)
    const int k0 = kt * BN;
    const bool ragged = k0 + BN > Sk;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int c = 0; c < 16; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s_acc[4 * c + e] * scale_log2;
        if (ragged && k0 + 8 * c + 2 * t + (e & 1) >= Sk) x = NEG_INF;
        s_acc[4 * c + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= corr[r];
    }
    uint32_t pf[BN / 16][4];  // P in bf16: the A fragments of O += P V, one per 16 keys
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s_acc[4 * c + e] - m_r[e >> 1]);
        l_r[e >> 1] += p[e];
      }
      pf[c >> 1][2 * (c & 1) + 0] = pack_bf16(p[0], p[1]);
      pf[c >> 1][2 * (c & 1) + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int s = 0; s < NSUB; ++s)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[s][e] *= corr[(e >> 1) & 1];

    // O += P V: V's 16-key steps are 2048 bytes apart in each 64-column sub-tile
#pragma unroll
    for (int s = 0; s < NSUB; ++s) reg_fence(acc[s]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int s = 0; s < NSUB; ++s)
        wgmma_m64n64k16_rs(acc[s], pf[kk], sw128_desc(v_tile + s * L::KV_SUB + kk * 2048, 1024, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int s = 0; s < NSUB; ++s) reg_fence(acc[s]);

    __syncthreads();  // both warpgroups are done with this stage
    if (tid == 0 && kt + STAGES < num_k) load_kv(kt + STAGES, st);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  const int row0 = q0 + wg * 64 + warp * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= Sq) continue;
    const float inv = 1.f / l_r[r];
    __nv_bfloat16* orow = o + b * o_sb + h * o_sh + (long long)qi * o_ss;
#pragma unroll
    for (int s = 0; s < NSUB; ++s)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 * s + 8 * c + 2 * t) =
            __floats2bfloat162_rn(acc[s][4 * c + 2 * r] * inv, acc[s][4 * c + 2 * r + 1] * inv);
    if (t == 0) lse[(long long)bh * Sq + qi] = (m_r[r] + log2f(l_r[r])) * LN2;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Sq, int Sk,
           const long long* st, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!bshd_map(&mq, q, B, Sq, H, D, st[0], st[1], st[2], BM) ||
      !bshd_map(&mk, k, B, Sk, H, D, st[3], st[4], st[5], BN) ||
      !bshd_map(&mv, v, B, Sk, H, D, st[6], st[7], st[8], BN))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_tc_kernel<D>;
  constexpr int smem = Layout<D>::BYTES;
  static uint64_t smem_set = 0;
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BM - 1) / BM, B * H);
  kernel<<<grid, NTHREADS, smem, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, H, Sq, Sk, st[9],
                                           st[10], st[11], scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: tensor cores (3xTF32 mma.sync), operands split once per block
// ---------------------------------------------------------------------------
namespace tf32 {

using namespace hopper;

// 128 q rows a block: at D 64 four warps of two 16-row m-tiles each (every
// K and V fragment a warp reads feeds two products), at D 128 eight warps of
// one; 16-key tiles (with 32-key tiles the D-64 kernel spilled 112 bytes);
// 32-key split units; operands split once per block
template <int D>
using Cfg = FwdCfg<D, D == 64 ? 4 : 8, 1, 16, 32, D == 64 ? 2 : 1, true>;

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS) flash_fwd_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, float* __restrict__ part_acc, float* __restrict__ part_m, float* __restrict__ part_l,
    int H, int Sq, int Sk, Strides st, float scale_log2) {
  fwd_tf32<Cfg<D>>(q, k, v, o, lse, part_acc, part_m, part_l, H, Sq, Sk, st, scale_log2);
}

__global__ void __launch_bounds__(FWD_MERGE_THREADS) flash_fwd_merge_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_m, const float* __restrict__ part_l,
    float* __restrict__ o, float* __restrict__ lse, int H, int Sq, int D, int splits, long long o_sb, long long o_ss,
    long long o_sh) {
  fwd_merge<float>(part_acc, part_m, part_l, o, lse, H, Sq, D, splits, o_sb, o_ss, o_sh);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, float* part_acc, float* part_m,
           float* part_l, int B, int H, int Sq, int Sk, int splits, const long long* st, float scale,
           cudaStream_t stream) {
  static uint64_t smem_set = 0;
  return launch_fwd_tf32<Cfg<D>>(flash_fwd_tf32_kernel<D>, flash_fwd_merge_kernel, smem_set, q, k, v, o, lse,
                                 part_acc, part_m, part_l, B, H, Sq, Sk, splits, st, scale, stream);
}

}  // namespace tf32

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 = float32 (the 3xTF32
// kernel, its key range split `splits` ways), 1 = bfloat16 (the wgmma
// kernel, splits 1). strides: 12 element strides, (batch, seq, head) for q,
// k, v, o in turn. splits > 1 needs part_acc [splits, B*H, Sq, D] and
// part_m / part_l [splits, B*H, Sq], fp32 and contiguous. Returns the
// cudaError_t of the launches (0 = launched), or cudaErrorInvalidValue for a
// head dim / dtype / shape / split count it does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse, float* part_acc,
                                   float* part_m, float* part_l, int dtype, int B, int H, int Sq, int Sk, int D,
                                   int splits, const long long* strides, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return tf32::launch<64>(q, k, v, o, lse, part_acc, part_m, part_l, B, H, Sq, Sk, splits, strides, scale, s);
  if (dtype == 0 && D == 128)
    return tf32::launch<128>(q, k, v, o, lse, part_acc, part_m, part_l, B, H, Sq, Sk, splits, strides, scale, s);
  if (splits != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && D == 64) return tc::launch<64>(q, k, v, o, lse, B, H, Sq, Sk, strides, scale, s);
  if (dtype == 1 && D == 128) return tc::launch<128>(q, k, v, o, lse, B, H, Sq, Sk, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}
