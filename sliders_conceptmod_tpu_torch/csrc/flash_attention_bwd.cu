// Flash-attention backward for Hopper (sm_90a): two kernels, bidirectional
// (no mask), fp32 math, gradients in the input dtype.
//
// K2 flash_bwd_dq_kernel replaces the TPU kernel
//   sliders_conceptmod_tpu/ops/flash_attention.py::_bwd_dq_kernel
// (launched by _vjp_bwd): dQ = scale * sum_k dS K, with
//   P  = exp(scale * Q K^T - lse)     (recomputed from K1's saved fp32 lse)
//   dP = dO V^T,  dS = P o (dP - delta),  delta = rowsum(dO o O).
// The JAX package computes delta with an XLA reduction outside its kernels;
// here it is fused into K2's prologue (the q tile's dO rows are staged
// anyway) and written out as fp32 [B*H, Sq] for K3.
//
// K3 flash_bwd_dkv_kernel replaces
//   sliders_conceptmod_tpu/ops/flash_attention.py::_bwd_dkv_kernel
// (launched by _vjp_bwd): per K tile, dV = sum_q P^T dO and
// dK = scale * sum_q dS^T Q. Query rows past Sq contribute nothing (their P
// is forced to 0, as the TPU kernel's row mask does).
//
// Both: keys past Sk get P = 0 exactly (the TPU kernel masks their scores
// to -1e30 before exp). Layout BSHD [B, S, H, D] with arbitrary batch / seq
// / head strides (in elements) and unit stride over D for every tensor, so
// autograd's dO and the UNet's q/k/v views go in without copies. D is 64 or
// 128; dtypes float32 and bfloat16; outputs are written with their own
// strides.
//
// What bounds it on the H100: K2 does 6*BH*Sq*Sk*D flops and K3
// 8*BH*Sq*Sk*D against a few MB of q, k, v, o, dO, lse, delta and the
// gradients, so at the UNet's training shapes (D = 64, 1024 or 256 tokens)
// the bound is the bf16 tensor-core rate (989 TFLOP/s). These first kernels
// do NOT reach it: like K1 they keep the TPU kernels' fp32 math on the CUDA
// cores (67 TFLOP/s peak). Design, for correctness first:
//   * one block of 128 threads per (batch*head, 64-row tile) - a q tile for
//     K2, a key tile for K3 - whose loop over the other operand's 64-row
//     tiles replaces the TPU grid's sequential axis;
//   * thread t owns row t/2 of its tile and, of each streamed tile, the even
//     or odd rows (t & 1), so the two threads of a row share nothing but a
//     __shfl_xor for delta;
//   * the streamed tiles are staged in shared memory as fp32 with rows
//     padded by 4 floats (float4 reads of 8 rows hit distinct banks); P and
//     dS go through shared memory with row stride 64 + 2 (conflict-free for
//     the per-thread write and the row-broadcast read);
//   * P is written to shared memory as soon as it is computed and read back
//     by the same thread for dS, so only one 32-wide score array is live.
// Tensor cores (wgmma) with TMA-fed tiles are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// (batch, seq, head) element strides of the six tensors a kernel touches
struct Strides {
  long long t[6][3];
};

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

Strides unpack(const long long* s) {
  Strides st;
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 3; ++j) st.t[i][j] = s[3 * i + j];
  return st;
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
              float* delta, void* dq, int B, int H, int Sq, int Sk, const long long* strides, float scale,
              cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  const size_t smem = Smem<D>::dq_bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, NTHREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<const T*>(o),
                                           static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), H, Sq, Sk,
                                           unpack(strides), scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, int B, int H, int Sq, int Sk, const long long* strides, float scale,
               cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  const size_t smem = Smem<D>::dkv_bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sk + BK - 1) / BK, B * H);
  kernel<<<grid, NTHREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
                                           static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk, unpack(strides),
                                           scale);
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int H, int Sq, int Sk) { return B > 0 && H > 0 && Sq > 0 && Sk > 0 && B * H <= 65535; }

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = float32, 1 = bfloat16.
// Each returns the cudaError_t of its launch (0 = launched), or
// cudaErrorInvalidValue for a head dim / dtype / shape it does not take.
//
// K2. strides: 18 element strides, (batch, seq, head) for q, k, v, o, dO, dQ
// in turn. lse [B*H, Sq] fp32 in; delta [B*H, Sq] fp32 out.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                      const float* lse, float* delta, void* dq, int dtype, int B, int H, int Sq,
                                      int Sk, int D, const long long* strides, float scale, void* stream) {
  if (!shape_ok(B, H, Sq, Sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dq<float, 64>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Sk, strides, scale, s);
  if (dtype == 0 && D == 128)
    return launch_dq<float, 128>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Sk, strides, scale, s);
  if (dtype == 1 && D == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Sk, strides, scale, s);
  if (dtype == 1 && D == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Sk, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}

// K3. strides: 18 element strides, (batch, seq, head) for q, k, v, dO, dK, dV
// in turn. lse and delta [B*H, Sq] fp32 in (delta as K2 wrote it).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                       const float* lse, const float* delta, void* dk, void* dv, int dtype, int B,
                                       int H, int Sq, int Sk, int D, const long long* strides, float scale,
                                       void* stream) {
  if (!shape_ok(B, H, Sq, Sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, strides, scale, s);
  if (dtype == 0 && D == 128)
    return launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, strides, scale, s);
  if (dtype == 1 && D == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, strides, scale, s);
  if (dtype == 1 && D == 128)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}
