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
// * float32 -> flash_fwd_kernel, the first (SIMT) kernel, unchanged: fp32
//   math on the CUDA cores (67 TFLOP/s peak), one block per (batch*head,
//   64-row q tile), thread pairs per q row, K/V staged in shared memory as
//   fp32 (rows padded by 4 floats), P through shared memory. fp32 inputs
//   stay there because TF32 tensor cores would round the operands to 10
//   mantissa bits and break the fp32 bound of 1e-4 against the plain
//   version; on the path only the card-vs-CPU parity runs and a user's
//   `precision: fp32` take it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tc.cuh"

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per K/V tile
constexpr int NTHREADS = 128;  // 2 threads per q row
constexpr float NEG_INF = -1e30f;

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

template <int D>
struct Smem {
  static constexpr int QS = D + 4;   // padded row stride of sQ and sK
  static constexpr int VS = D;       // sV row stride
  static constexpr int PS = BK + 2;  // sP row stride
  static constexpr size_t floats = (size_t)BQ * QS + (size_t)BK * QS + (size_t)BK * VS + (size_t)BQ * PS;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    float* __restrict__ lse, int H, int Sq, int Sk, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale) {
  using S = Smem<D>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem;                 // [BQ][QS], pre-scaled
  float* sK = sQ + BQ * S::QS;      // [BK][QS]
  float* sV = sK + BK * S::QS;      // [BK][VS]
  float* sP = sV + BK * S::VS;      // [BQ][PS]

  const int tid = threadIdx.x;
  const int r = tid >> 1;    // q row within the tile
  const int half = tid & 1;  // even / odd key columns; interleaved output groups
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  // stage the (scaled) q tile; rows past Sq are zeros and never stored
  for (int idx = tid; idx < BQ * D; idx += NTHREADS) {
    const int rr = idx / D;
    const int d = idx - rr * D;
    const int qi = q0 + rr;
    sQ[rr * S::QS + d] = qi < Sq ? to_f32<T>(qb[(long long)qi * q_ss + d]) * scale : 0.f;
  }

  constexpr int NJ = BK / 2;  // score columns per thread
  constexpr int NG = D / 8;   // float4 output groups per thread
  float acc[NG * 4];
#pragma unroll
  for (int e = 0; e < NG * 4; ++e) acc[e] = 0.f;
  float m_i = NEG_INF;
  float l_i = 0.f;

  const int num_k = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's P*V reads are done (and sQ is staged)
    for (int idx = tid; idx < BK * D; idx += NTHREADS) {
      const int c = idx / D;
      const int d = idx - c * D;
      const int key = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (key < Sk) {  // ragged tail: zero K and V so masked columns add exact zeros
        kv = to_f32<T>(kb[(long long)key * k_ss + d]);
        vv = to_f32<T>(vb[(long long)key * v_ss + d]);
      }
      sK[c * S::QS + d] = kv;
      sV[c * S::VS + d] = vv;
    }
    __syncthreads();

    // scores for this thread's row and its 32 key columns (2j + half)
    float s[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < D; d4 += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(&sQ[r * S::QS + d4]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(&sK[(2 * j + half) * S::QS + d4]);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    // online softmax carry, shared by the thread pair of this row
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (k0 + 2 * j + half >= Sk) s[j] = NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float corr = expf(m_i - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float p = expf(s[j] - m_new);
      rs += p;
      sP[r * S::PS + 2 * j + half] = p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l_i = l_i * corr + rs;
    m_i = m_new;
#pragma unroll
    for (int e = 0; e < NG * 4; ++e) acc[e] *= corr;
    __syncthreads();  // the whole P row is written

    const int ncols = min(BK, Sk - k0);  // masked columns have p == 0 exactly
    for (int c = 0; c < ncols; ++c) {
      const float p = sP[r * S::PS + c];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(&sV[c * S::VS + (2 * g + half) * 4]);
        acc[4 * g + 0] = fmaf(p, vv.x, acc[4 * g + 0]);
        acc[4 * g + 1] = fmaf(p, vv.y, acc[4 * g + 1]);
        acc[4 * g + 2] = fmaf(p, vv.z, acc[4 * g + 2]);
        acc[4 * g + 3] = fmaf(p, vv.w, acc[4 * g + 3]);
      }
    }
  }

  const int qi = q0 + r;
  if (qi < Sq) {
    T* orow = o + b * o_sb + h * o_sh + (long long)qi * o_ss;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[(2 * g + half) * 4 + e] = from_f32<T>(acc[4 * g + e] / l_i);
    }
    if (half == 0) lse[(long long)bh * Sq + qi] = m_i + logf(l_i);
  }
}

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Sq,
           int Sk, const long long* st, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), lse, H,
      Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 = float32 (the SIMT
// kernel), 1 = bfloat16 (the tensor-core kernel).
// strides: 12 element strides, (batch, seq, head) for q, k, v, o in turn.
// Returns the cudaError_t of the launch (0 = launched), or
// cudaErrorInvalidValue for a head dim / dtype / shape it does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int dtype,
                                   int B, int H, int Sq, int Sk, int D, const long long* strides, float scale,
                                   void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B * H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch<float, 64>(q, k, v, o, lse, B, H, Sq, Sk, strides, scale, s);
  if (dtype == 0 && D == 128) return launch<float, 128>(q, k, v, o, lse, B, H, Sq, Sk, strides, scale, s);
  if (dtype == 1 && D == 64) return tc::launch<64>(q, k, v, o, lse, B, H, Sq, Sk, strides, scale, s);
  if (dtype == 1 && D == 128) return tc::launch<128>(q, k, v, o, lse, B, H, Sq, Sk, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}