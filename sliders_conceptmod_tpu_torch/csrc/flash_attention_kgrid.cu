// K-grid flash-attention forward for Hopper (sm_90a): O = softmax(scale * Q K^T) V
// and the row logsumexp, bidirectional (no mask), for head dims 64..512
// (multiples of 64). Kernel K4a.
//
// Replaces the TPU kernel sliders_conceptmod_tpu/ops/flash_attention_kgrid.py::
// _fwd_kernel (launched by _flash_fwd_impl). The TPU kernel runs on a
// (batch*head, q block, k block) grid whose k axis is sequential: the running
// (m, l, acc) live in VMEM scratch across the k steps of one (bh, q) cell, so
// K/V stream block by block and the sequence length is unbounded. On the card
// blocks run in parallel and in no order, so the k axis becomes
//   * a loop inside the block over K/V tiles (the TPU's sequential k steps),
//     carrying (m, l, acc) in registers, and
//   * a split of the key range across blocks (grid z): each split writes its
//     unnormalised fp32 (acc, m, l), and kgrid_merge_kernel combines them:
//       m* = max m_s, l* = sum l_s e^(m_s - m*),
//       O = sum acc_s e^(m_s - m*) / l*, lse = m* + log l*.
//     With one split the block normalises and writes O and lse itself.
// A split whose key range is empty (or wholly past Sk) keeps m = NEG_INF,
// l = 0, acc = 0 and so contributes exactly 0 to the merge: m* is the max of
// at least one split with real keys, and exp(-1e30 - m*) is an exact 0.
// Keys past Sk are masked to NEG_INF = -1e30 (exp gives an exact 0) and their
// K/V rows are zeros, as in K1 and the TPU kernel. lse is stored fp32
// [B*H, Sq] (the TPU's lane-replicated [..., 128] layout was a tiling
// workaround and is not carried over).
//
// Layout: BSHD [B, S, H, D] with arbitrary batch/seq/head strides (in
// elements) and unit stride over D. O in the input dtype.
//
// What bounds it on the H100: at the VAE mid-block's shapes (one head,
// D = 512, Sq = Sk = 4096 or 16384) the work is 4*B*Sq*Sk*D flops against
// tens of MB of Q/K/V/O: far above the ~295 flop/byte ridge, so the bound is
// the tensor-core rate (989 TFLOP/s bf16); at SD1.5's d-160 (run at 192)
// attentions of 256 and 64 tokens a call is a few microseconds and the bytes
// and the launch bound it. The entry point dispatches by dtype:
//
// * bfloat16 -> kgrid_fwd_tc_kernel, on the tensor cores: K1's design
//   (csrc/flash_attention_fwd.cu) widened to D = 512. Design:
//     - one block per (batch*head, 64-row q tile, split of the key range),
//       with ceil(D / 256) consumer warpgroups: one up to D 256, two above.
//       Each warpgroup owns the O columns of ceil(D / 64 / warpgroups)
//       64-column sub-tiles (at D 512: 256 columns, 128 fp32 accumulator
//       registers a thread; the whole 64 x 512 tile would need 256);
//     - each warpgroup computes S = Q K^T over the full D itself with
//       wgmma m64nBNk16 from shared memory (K stored [keys, d] is K-major for
//       B): at D 512 the two warpgroups repeat S, 1.5x the products of one
//       pass, and need no synchronisation between them; the scale is
//       applied to S in fp32 after the product;
//     - the online softmax stays in registers (base 2, quad shuffles); P is
//       rounded to bf16 in the accumulator's own layout, the register A
//       operand of O += P V: wgmma m64n64k16 per 64-column sub-tile of the
//       warpgroup's slice, V read from shared memory with the transpose flag;
//     - Q and a 2-stage ring of K/V tiles are filled by TMA (4-D maps over
//       (D, S, H, B) encoded per call from the tensor's strides, the
//       128-byte swizzle the wgmma descriptors read, completion on
//       mbarriers); one thread issues the copy of tile j+2 once every
//       warpgroup is done with tile j. Tiles of 64 keys up to D 256 and of
//       32 keys above, so that Q and the ring fit: D 512 takes Q 64 KB +
//       2 x (K + V) 64 KB = 192 KB, D 192 takes 24 + 96 KB;
//     - the key range splits in 64-key units
//       (ops/flash_attention_kgrid.py::pick_splits for bfloat16), which
//       both tile sizes divide; ragged Sq and Sk: TMA zero-fills the box
//       past the tensor's end, keys past the split's end get -1e30 before
//       the max, padded q rows are never stored.
//   TMA needs 16-byte-aligned bases and strides: the wrapper makes one
//   contiguous copy of a bf16 tensor that fails the check, and this entry
//   point returns cudaErrorInvalidValue for one that reaches it anyway.
//   ptxas: 90-186 registers (170 at D 512, 159 at D 192); no spills.
//   Measured (bench_attention.py, device time, NVIDIA H100 80GB HBM3,
//   700.00 W): the decode's 16384^2 at D 512 (2 splits) 2.81 ms, 196
//   TFLOP/s, 20 % of the bound, 0.62x SDPA's forward (the first SIMT
//   kernel: 41.8 ms); the encoder's 4096^2 at rows 4 0.78 ms, 18 %; SD1.5's
//   d-160 shapes 4.5-12 us, 2-19 % of their (bytes) bound, 0.6-1.3x SDPA's
//   forward (PERF.md, section 6).
//
// * float32 -> kgrid_fwd_tf32_kernel (null-text inversion editing at SD1.5's
//   d 160 -> 192, the fp32 VAEs' mid-blocks at d 512), on the tensor cores in
//   fp32 accuracy: K1's fp32 body (hopper_tc.cuh: FwdCfg, fwd_tf32, its
//   header in flash_attention_fwd.cu) at 32 q rows per block and every D of
//   this kernel. It replaced the first (SIMT) kernel, fp32 math on the CUDA
//   cores (5 % of the bound at d 192, 7-8 % at d 512). What bounds it: the
//   products at 164.9 TFLOP/s (three TF32 passes, 494.7 / 3) at the VAE's
//   4096^2 and 16384^2; the bytes and the launch at SD1.5's 256- and
//   64-token calls. Design:
//     - one block of two 16-row slabs per (batch*head, 32-row q tile, split
//       of the key range); above D 64 two (D 128) or four warps share a
//       slab, each owning D / 2 or D / 4 of the head-dim columns of Q, K, V
//       and O: its partial scores over its columns are summed across the
//       slab's warps through shared memory in a fixed order, so every warp
//       holds the same scores, and its O (16 x D/4 fp32 at D 512) stays in
//       registers; no product is repeated;
//     - Q, K and V^T stay fp32 in shared memory and every warp splits the
//       operands it reads into TF32 halves (PR 22's scheme): with two to
//       four warps sharing a tile, splitting once per block measured
//       1.09-1.12x slower at d 192 and 1.24-1.26x at d 512
//       (bench_attention.py --sections variants), its big and small tiles
//       doubling the shared-memory traffic that bounds the kernel;
//     - tiles of 16 keys, 8 above D 320, so that the registers hold the
//       next tile's prefetch;
//     - the key range splits in the same 32-key units as before
//       (ops/flash_attention_kgrid.py::pick_splits for float32), merged by
//       kgrid_merge_kernel.
//   Measured (bench_attention.py, device time, NVIDIA H100 80GB HBM3,
//   700.00 W): SD3's 1024px decode (16384^2, d 512) 21.3 ms, 16 % of the
//   bound, 1.55-1.56x SDPA's fp32 forward (the SIMT kernel: 44.6 ms); the
//   edit's VAE 4096^2 1.42 ms, 1.27-1.28x; SD1.5's 256^2 at d 192 (2
//   splits) 0.0246 ms, 0.71x (PERF.md, section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tc.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// One block per (q row, batch*head): merges the splits' partials into O and
// lse (hopper_tc.cuh: fwd_merge), for both dtypes.
template <typename T>
__global__ void __launch_bounds__(hopper::FWD_MERGE_THREADS) kgrid_merge_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_m, const float* __restrict__ part_l,
    T* __restrict__ o, float* __restrict__ lse, int H, int Sq, int D, int splits, long long o_sb,
    long long o_ss, long long o_sh) {
  hopper::fwd_merge<T>(part_acc, part_m, part_l, o, lse, H, Sq, D, splits, o_sb, o_ss, o_sh);
}

// ---------------------------------------------------------------------------
// float32: tensor cores (3xTF32 mma.sync), each warp splits the operands it reads
// ---------------------------------------------------------------------------
namespace tf32 {

using namespace hopper;

// 32 q rows (two 16-row slabs); 1, 2 or 4 warps a slab (four from D 192:
// faster, and no spill there); 16-key tiles, 8 above D 320 (registers; and
// what fits shared memory split once per block); the key range split in
// 32-key units (the first kernel's); each warp splits the operands it reads
// (faster here than splitting once per block: PERF.md)
template <int D>
using Cfg = FwdCfg<D, 2, (D <= 64 ? 1 : D <= 128 ? 2 : 4), (D <= 320 ? 16 : 8), 32, 1, false>;

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS) kgrid_fwd_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, float* __restrict__ part_acc, float* __restrict__ part_m, float* __restrict__ part_l,
    int H, int Sq, int Sk, Strides st, float scale_log2) {
  fwd_tf32<Cfg<D>>(q, k, v, o, lse, part_acc, part_m, part_l, H, Sq, Sk, st, scale_log2);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, float* part_acc, float* part_m,
           float* part_l, int B, int H, int Sq, int Sk, int splits, const long long* st, float scale,
           cudaStream_t stream) {
  static uint64_t smem_set = 0;
  return launch_fwd_tf32<Cfg<D>>(kgrid_fwd_tf32_kernel<D>, kgrid_merge_kernel<float>, smem_set, q, k, v, o, lse,
                                 part_acc, part_m, part_l, B, H, Sq, Sk, splits, st, scale, stream);
}

int launch_d(const void* q, const void* k, const void* v, void* o, float* lse, float* pa, float* pm, float* pl, int B,
             int H, int Sq, int Sk, int D, int splits, const long long* st, float scale, cudaStream_t s) {
  switch (D) {
    case 64: return launch<64>(q, k, v, o, lse, pa, pm, pl, B, H, Sq, Sk, splits, st, scale, s);
    case 128: return launch<128>(q, k, v, o, lse, pa, pm, pl, B, H, Sq, Sk, splits, st, scale, s);
    case 192: return launch<192>(q, k, v, o, lse, pa, pm, pl, B, H, Sq, Sk, splits, st, scale, s);
    case 256: return launch<256>(q, k, v, o, lse, pa, pm, pl, B, H, Sq, Sk, splits, st, scale, s);
    case 320: return launch<320>(q, k, v, o, lse, pa, pm, pl, B, H, Sq, Sk, splits, st, scale, s);
    case 384: return launch<384>(q, k, v, o, lse, pa, pm, pl, B, H, Sq, Sk, splits, st, scale, s);
    case 448: return launch<448>(q, k, v, o, lse, pa, pm, pl, B, H, Sq, Sk, splits, st, scale, s);
    case 512: return launch<512>(q, k, v, o, lse, pa, pm, pl, B, H, Sq, Sk, splits, st, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tf32

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), TMA-fed
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int BM = 64;          // q rows per block: one wgmma M, shared by the consumer warpgroups
constexpr int SPLIT_KEYS = 64;  // the key range splits in whole 64-key units

// Shared memory of one block, byte offsets from a 1024-aligned base. A tile
// of R rows x D columns is stored as D/64 sub-tiles of R rows x 128 bytes,
// each in the 128-byte-swizzled layout TMA writes and wgmma reads.
template <int D>
struct Layout {
  static constexpr int NSUB = D / 64;                    // 64-column sub-tiles of a row
  static constexpr int NWG = D > 256 ? 2 : 1;            // consumer warpgroups
  static constexpr int WG_SUB = (NSUB + NWG - 1) / NWG;  // O sub-tiles per warpgroup (the last may own fewer)
  static constexpr int BN = D > 256 ? 32 : 64;           // keys per K/V tile
  static constexpr int THREADS = 128 * NWG;
  static constexpr int Q_SUB = BM * 128;
  static constexpr int KV_SUB = BN * 128;
  static constexpr int Q_BYTES = NSUB * Q_SUB;
  static constexpr int KV_BYTES = NSUB * KV_SUB;  // one K (or V) tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + 2 * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + 2 * KV_BYTES;  // bar_q, full[0], full[1]
  static constexpr int BYTES = BAR_OFF + 64 + 1024;     // + slack to align the base
};

// K4a for bf16: one (batch*head, 64-row q tile, split of the key range).
template <int D>
__global__ void __launch_bounds__(Layout<D>::THREADS, 1) kgrid_fwd_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    float* __restrict__ part_acc, float* __restrict__ part_m, float* __restrict__ part_l, int H, int Sq, int Sk,
    long long o_sb, long long o_ss, long long o_sh, float scale_log2) {
  using L = Layout<D>;
  constexpr int BN = L::BN;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + L::K_OFF, sV = base + L::V_OFF;
  const uint32_t bar_q = base + L::BAR_OFF;  // full[st] at bar_q + 8 * (1 + st)

  const int tid = threadIdx.x;
  const int wg = tid >> 7;          // consumer warpgroup: O sub-tiles sub0 .. sub0 + WG_SUB - 1
  const int warp = (tid >> 5) & 3;  // warp of the warpgroup: 16 q rows each
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // a thread holds rows g, g + 8 and columns 2t, 2t + 1 of each 8-column chunk
  const int sub0 = wg * L::WG_SUB;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BM;
  const int splits = gridDim.z;
  const int split = blockIdx.z;
  const int per = ((Sk + SPLIT_KEYS - 1) / SPLIT_KEYS + splits - 1) / splits * SPLIT_KEYS;
  const int lo = min(Sk, split * per);
  const int hi = min(Sk, lo + per);
  const int num_k = (hi - lo + BN - 1) / BN;

  auto load_kv = [&](int tile, int st) {
    const uint32_t bar = bar_q + 8 * (1 + st);
    mbar_expect_tx(bar, 2 * L::KV_BYTES);
#pragma unroll
    for (int s = 0; s < L::NSUB; ++s) {
      tma_load(sK + st * L::KV_BYTES + s * L::KV_SUB, &tm_k, bar, 64 * s, lo + tile * BN, h, b);
      tma_load(sV + st * L::KV_BYTES + s * L::KV_SUB, &tm_v, bar, 64 * s, lo + tile * BN, h, b);
    }
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q + 8, 1);
    mbar_init(bar_q + 16, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && num_k > 0) {  // an empty split loads nothing
    mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
    for (int s = 0; s < L::NSUB; ++s) tma_load(sQ + s * L::Q_SUB, &tm_q, bar_q, 64 * s, q0, h, b);
    for (int st = 0; st < 2 && st < num_k; ++st) load_kv(st, st);
  }

  float acc[L::WG_SUB][32];
#pragma unroll
  for (int s = 0; s < L::WG_SUB; ++s)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[s][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};  // running max of x = score * scale * log2(e), rows g and g + 8
  float l_r[2] = {0.f, 0.f};          // this thread's part of the running sum (quad-reduced at the end)

  if (num_k > 0) mbar_wait(bar_q, 0);
  for (int kt = 0; kt < num_k; ++kt) {
    const int st = kt & 1;
    mbar_wait(bar_q + 8 * (1 + st), (kt >> 1) & 1);
    const uint32_t k_tile = sK + st * L::KV_BYTES;
    const uint32_t v_tile = sV + st * L::KV_BYTES;

    // S = Q K^T over the full D in steps of 16 (32 bytes inside a 128-byte swizzled row)
    float s_acc[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      const uint64_t da = sw128_desc(sQ + (kk >> 2) * L::Q_SUB + off, 16, 1024);
      const uint64_t db = sw128_desc(k_tile + (kk >> 2) * L::KV_SUB + off, 16, 1024);
      if constexpr (BN == 64)
        wgmma_m64n64k16_ss(s_acc, da, db, kk > 0);
      else
        wgmma_m64n32k16_ss(s_acc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s_acc);

    // online softmax: chunk c holds keys 8c + 2t (+1) of rows g (e = 0, 1) and g + 8 (e = 2, 3)
    const int k0 = lo + kt * BN;
    const bool ragged = k0 + BN > hi;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s_acc[4 * c + e] * scale_log2;
        if (ragged && k0 + 8 * c + 2 * t + (e & 1) >= hi) x = NEG_INF;
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
    for (int c = 0; c < BN / 8; ++c) {
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
    for (int s = 0; s < L::WG_SUB; ++s)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[s][e] *= corr[(e >> 1) & 1];

    // O += P V on this warpgroup's sub-tiles: V's 16-key steps are 2048
    // bytes apart in each 64-column sub-tile
#pragma unroll
    for (int s = 0; s < L::WG_SUB; ++s) reg_fence(acc[s]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int s = 0; s < L::WG_SUB; ++s)
        if (sub0 + s < L::NSUB)
          wgmma_m64n64k16_rs(acc[s], pf[kk], sw128_desc(v_tile + (sub0 + s) * L::KV_SUB + kk * 2048, 1024, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int s = 0; s < L::WG_SUB; ++s) reg_fence(acc[s]);

    __syncthreads();  // every warpgroup is done with this stage
    if (tid == 0 && kt + 2 < num_k) load_kv(kt + 2, st);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  const int row0 = q0 + warp * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= Sq) continue;
    if (splits == 1) {
      const float inv = 1.f / l_r[r];
      __nv_bfloat16* orow = o + b * o_sb + h * o_sh + (long long)qi * o_ss;
#pragma unroll
      for (int s = 0; s < L::WG_SUB; ++s) {
        if (sub0 + s >= L::NSUB) continue;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          *reinterpret_cast<__nv_bfloat162*>(orow + 64 * (sub0 + s) + 8 * c + 2 * t) =
              __floats2bfloat162_rn(acc[s][4 * c + 2 * r] * inv, acc[s][4 * c + 2 * r + 1] * inv);
      }
      if (wg == 0 && t == 0) lse[(long long)bh * Sq + qi] = (m_r[r] + log2f(l_r[r])) * LN2;
    } else {
      // the unnormalised partials, [split][B*H][Sq](, D); m in natural-log units for the merge
      const long long row = ((long long)split * gridDim.y + bh) * Sq + qi;
      float* prow = part_acc + row * D;
#pragma unroll
      for (int s = 0; s < L::WG_SUB; ++s) {
        if (sub0 + s >= L::NSUB) continue;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          *reinterpret_cast<float2*>(prow + 64 * (sub0 + s) + 8 * c + 2 * t) =
              make_float2(acc[s][4 * c + 2 * r], acc[s][4 * c + 2 * r + 1]);
      }
      if (wg == 0 && t == 0) {
        part_m[row] = m_r[r] == NEG_INF ? NEG_INF : m_r[r] * LN2;
        part_l[row] = l_r[r];
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, float* part_acc, float* part_m,
           float* part_l, int B, int H, int Sq, int Sk, int splits, const long long* st, float scale,
           cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap mq, mk, mv;
  if (!bshd_map(&mq, q, B, Sq, H, D, st[0], st[1], st[2], BM) ||
      !bshd_map(&mk, k, B, Sk, H, D, st[3], st[4], st[5], L::BN) ||
      !bshd_map(&mv, v, B, Sk, H, D, st[6], st[7], st[8], L::BN))
    return (int)cudaErrorInvalidValue;
  auto kernel = kgrid_fwd_tc_kernel<D>;
  static uint64_t smem_set = 0;
  cudaError_t err = allow_smem(kernel, L::BYTES, smem_set);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BM - 1) / BM, B * H, splits);
  kernel<<<grid, L::THREADS, L::BYTES, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, part_acc, part_m,
                                                 part_l, H, Sq, Sk, st[9], st[10], st[11], scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  dim3 mgrid(Sq, B * H);
  kgrid_merge_kernel<__nv_bfloat16><<<mgrid, FWD_MERGE_THREADS, 0, stream>>>(
      part_acc, part_m, part_l, static_cast<__nv_bfloat16*>(o), lse, H, Sq, D, splits, st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

int launch_d(const void* q, const void* k, const void* v, void* o, float* lse, float* pa, float* pm, float* pl, int B,
             int H, int Sq, int Sk, int D, int splits, const long long* st, float scale, cudaStream_t s) {
  switch (D) {
    case 64: return launch<64>(q, k, v, o, lse, pa, pm, pl, B, H, Sq, Sk, splits, st, scale, s);
    case 128: return launch<128>(q, k, v, o, lse, pa, pm, pl, B, H, Sq, Sk, splits, st, scale, s);
    case 192: return launch<192>(q, k, v, o, lse, pa, pm, pl, B, H, Sq, Sk, splits, st, scale, s);
    case 256: return launch<256>(q, k, v, o, lse, pa, pm, pl, B, H, Sq, Sk, splits, st, scale, s);
    case 320: return launch<320>(q, k, v, o, lse, pa, pm, pl, B, H, Sq, Sk, splits, st, scale, s);
    case 384: return launch<384>(q, k, v, o, lse, pa, pm, pl, B, H, Sq, Sk, splits, st, scale, s);
    case 448: return launch<448>(q, k, v, o, lse, pa, pm, pl, B, H, Sq, Sk, splits, st, scale, s);
    case 512: return launch<512>(q, k, v, o, lse, pa, pm, pl, B, H, Sq, Sk, splits, st, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 = float32 (the 3xTF32
// kernel, the key range split in 32-key units), 1 = bfloat16 (the wgmma
// kernel, split in 64-key units).
// strides: 12 element strides, (batch, seq, head) for q, k, v, o in turn.
// splits > 1 needs part_acc [splits, B*H, Sq, D] and part_m / part_l
// [splits, B*H, Sq], fp32 and contiguous; with splits == 1 they are unused.
// Returns the cudaError_t of the launches (0 = launched), or
// cudaErrorInvalidValue for a head dim / dtype / shape / split count it does
// not take.
extern "C" int flash_attention_kgrid_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                                         float* part_acc, float* part_m, float* part_l, int dtype, int B, int H,
                                         int Sq, int Sk, int D, int splits, const long long* strides, float scale,
                                         void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B * H > 65535 || splits < 1 || splits > hopper::FWD_MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (part_acc == nullptr || part_m == nullptr || part_l == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tf32::launch_d(q, k, v, o, lse, part_acc, part_m, part_l, B, H, Sq, Sk, D, splits, strides, scale, s);
  if (dtype == 1)
    return tc::launch_d(q, k, v, o, lse, part_acc, part_m, part_l, B, H, Sq, Sk, D, splits, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}
