// Building blocks of the port's tensor-core kernels for Hopper (sm_90a),
// shared by K1 (flash_attention_fwd.cu), K2/K3 (flash_attention_bwd.cu), K4a
// (flash_attention_kgrid.cu) and K4b/K4c (flash_attention_kgrid_bwd.cu):
//   * TMA tile loads completing on shared-memory mbarriers, and the per-call
//     encode of a 4-D BSHD tensor map (cuTensorMapEncodeTiled through
//     cudaGetDriverEntryPoint, so no library links -lcuda);
//   * wgmma: 128-byte-swizzle shared-memory descriptors and the m64nNk16
//     products the forward kernels issue;
//   * mma.sync m16n8k16 (bf16) and m16n8k8 (TF32, issued three times per
//     fp32 product: tf32_split, mma_tf32x3), ldmatrix and cp.async for the
//     backward kernels, and the backward kernels themselves: the
//     shared-memory layout of a block (BwdLayout), the swizzled row loads
//     (load_rows), the two products in bf16 (keys_by_q, keys_by_d) and in
//     fp32 (keys_by_q_tf32, keys_by_d_tf32), the bodies of K2/K4b
//     (bwd_dq_tc) and K3/K4c (bwd_dkv_tc) over a block shape and element
//     type (BwdCfg), their split merges (dq_merge, dkv_merge) and launches
//     (launch_bwd_dq, launch_bwd_dkv); each source wraps a body in a
//     __global__ kernel of its own name and shape;
//   * the fp32 forward of K1 and K4a on the same 3xTF32 products (fwd_tf32
//     over a block shape FwdCfg: Q, K and V split into TF32 halves once per
//     block or by each warp, V stored transposed, swz_rows), its split merge
//     (fwd_merge, also K4a's bf16 merge) and launch (launch_fwd_tf32);
//   * allow_smem (the dynamic shared-memory attribute, once per device) and
//     rows_aligned (what cp.async and TMA need of a tensor's rows).
// Every function is inline; each source that includes this header is built
// into a library of its own (ops/flash_attention.py::build, which hashes this
// header with each source).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA box (64 columns x the map's rows, of one head) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int d0, int row, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(row), "r"(h), "r"(b)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// wgmma shared-memory descriptor, 128-byte swizzle. `lbo`/`sbo` in bytes: the
// stride byte offset is the step between groups of eight 128-byte rows
// (1024); the leading byte offset is not read at these shapes (one swizzle
// atom across the product's K-major depth or MN-major width).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving accesses of wgmma accumulators across the
// asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, "
      "1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]),
        "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 16] * B[16 x 32], A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (bf16 pairs in the
// accumulator's layout), B from shared memory MN-major (transpose flag set)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---------------------------------------------------------------------------
// mma.sync, ldmatrix, cp.async
// ---------------------------------------------------------------------------

// byte address of 16-byte chunk `chunk` of row `row` in a tile of D-element
// rows of T (bf16 unless named) whose chunks are XOR-swizzled by (row & 7):
// ldmatrix's eight rows and cp.async's writes hit distinct banks
template <int D, typename T = __nv_bfloat16>
__device__ __forceinline__ uint32_t swz(uint32_t tile, int row, int chunk) {
  return tile + row * (D * (int)sizeof(T)) + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds a finite x: half of the dropped range added to the
// magnitude's bits, then the 13 dropped bits cleared. Two integer operations,
// where cvt.rna compiles to about four (it also sorts out infinities and NaN,
// which no attention gradient here holds) and slowed K2 and K3 measurably.
__device__ __forceinline__ uint32_t to_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x = big + small, both TF32: big is x rounded to TF32 and small the exact
// residual x - big rounded again. big * b_big + big * b_small + small * b_big
// then misses the product of x and b by the two small terms' product and the
// second rounding, about 2^-21 of it: fp32-class, where one TF32 pass keeps
// about 2^-11.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d[16 x 8] += a[16 x 8] b[8 x 8], TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An fp32 A operand of m16n8k8 (four elements a thread) split into its TF32
// halves
struct SplitA {
  uint32_t big[4], small[4];
};
__device__ __forceinline__ SplitA split_a(float a0, float a1, float a2, float a3) {
  SplitA s;
  tf32_split(a0, s.big[0], s.small[0]);
  tf32_split(a1, s.big[1], s.small[1]);
  tf32_split(a2, s.big[2], s.small[2]);
  tf32_split(a3, s.big[3], s.small[3]);
  return s;
}

// d += a b in fp32 accuracy on the tensor cores (3xTF32), b already split
// into its TF32 halves: the two small terms first, then big * big, into a
// fresh fp32 sum of this 8-deep k step, which is then added to d on the CUDA
// cores. The tensor cores truncate the sums they write: taken into d itself,
// three truncations per k step at d's size pile up over a k loop thousands
// of keys long (dQ, dK, dV, O) and reach the fp32 bound, where one rounding
// to nearest per step at d's size and three truncations at the step's size
// do not.
__device__ __forceinline__ void mma_tf32x3_split(float (&d)[4], const uint32_t (&a_big)[4],
                                                 const uint32_t (&a_small)[4], uint32_t b0_big, uint32_t b1_big,
                                                 uint32_t b0_small, uint32_t b1_small) {
  float step[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(step, a_small, b0_big, b1_big);
  mma_tf32(step, a_big, b0_small, b1_small);
  mma_tf32(step, a_big, b0_big, b1_big);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += step[i];
}

// the same with b in fp32, split here (the backward kernels: every warp
// splits the B operand it reads)
__device__ __forceinline__ void mma_tf32x3(float (&d)[4], const SplitA& a, float b0, float b1) {
  uint32_t b0_big, b0_small, b1_big, b1_small;
  tf32_split(b0, b0_big, b0_small);
  tf32_split(b1, b1_big, b1_small);
  mma_tf32x3_split(d, a.big, a.small, b0_big, b1_big, b0_small, b1_small);
}

// ---------------------------------------------------------------------------
// the mma.sync backward loops (K2/K3 in flash_attention_bwd.cu, K4b/K4c in
// flash_attention_kgrid_bwd.cu)
// ---------------------------------------------------------------------------

// the sum of the eight products of two 16-byte chunks of bf16 pairs, in fp32
__device__ __forceinline__ float dot8_bf16(const uint4& a, const uint4& b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(y[i] << 16), acc);
    acc = fmaf(__uint_as_float(x[i] & 0xffff0000u), __uint_as_float(y[i] & 0xffff0000u), acc);
  }
  return acc;
}

// the sum of the products of two 16-byte chunks of T (8 bf16 or 4 fp32), in fp32
template <typename T>
__device__ __forceinline__ float dot_chunk(const uint4& a, const uint4& b) {
  if constexpr (std::is_same<T, float>::value) {
    float acc = 0.f;
    acc = fmaf(__uint_as_float(a.x), __uint_as_float(b.x), acc);
    acc = fmaf(__uint_as_float(a.y), __uint_as_float(b.y), acc);
    acc = fmaf(__uint_as_float(a.z), __uint_as_float(b.z), acc);
    return fmaf(__uint_as_float(a.w), __uint_as_float(b.w), acc);
  } else {
    return dot8_bf16(a, b);
  }
}

// two neighbouring output elements, from fp32
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// Shared memory of a backward block: two resident [ROWS][D] tiles (K2/K4b: Q
// and dO; K3/K4c: K and V) and a 2-stage ring of two streamed [TILE][D] tiles
// (K2/K4b: K and V; K3/K4c: Q and dO), of ELEM-byte elements, with SCALARS
// two fp32 [TILE] vectors per stage (lse and delta). Rows are swizzled by
// swz; every tile starts on 128 bytes.
template <int D, int ROWS, int TILE, bool SCALARS, int ELEM = 2>
struct BwdLayout {
  static constexpr int ROW = D * ELEM;
  static constexpr int A_OFF = 0;  // the resident tiles
  static constexpr int B_OFF = ROWS * ROW;
  static constexpr int RING_OFF = 2 * ROWS * ROW;
  static constexpr int X_OFF = 0;  // the streamed tiles, within a stage
  static constexpr int Y_OFF = TILE * ROW;
  static constexpr int L_OFF = 2 * TILE * ROW;
  static constexpr int DL_OFF = L_OFF + TILE * 4;
  static constexpr int STAGE = 2 * TILE * ROW + (SCALARS ? 8 * TILE : 0);
  static constexpr int BYTES = RING_OFF + 2 * STAGE;
};

// rows [r0, r0 + ROWS) of a BSHD slice of T (bf16 or fp32) into a swizzled
// tile by a block of THREADS threads, one 16-byte cp.async per chunk; rows at
// or past n are zero-filled
template <int D, int ROWS, int THREADS, typename T>
__device__ __forceinline__ void load_rows(uint32_t dst, const T* src, long long row_stride, int r0, int n) {
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per chunk
  constexpr int CH = D / EPC;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH;
    const int c = i - r * CH;
    const bool ok = r0 + r < n;
    cp_async16(swz<D, T>(dst, r, c), src + (ok ? (long long)(r0 + r) * row_stride : 0) + c * EPC, ok);
  }
}

// acc[16 rows x BQ] += A[16 rows x D] B[BQ x D]^T over the whole head dim: A
// fragments from the warp's rows `row0`.. of `a_tile`, B the rows of `b_tile`
// (both row-major [row][d], non-transposed ldmatrix). K3/K4c: S^T = K Q^T and
// dP^T = V dO^T; K2/K4b: S = Q K^T and dP = dO V^T. Chunk c of acc holds
// columns 8c + 2t (+1) of rows g (e = 0, 1) and g + 8 (e = 2, 3).
template <int D, int BQ>
__device__ __forceinline__ void keys_by_q(float (&acc)[BQ / 8][4], uint32_t a_tile, uint32_t b_tile, int row0,
                                          int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, swz<D>(a_tile, row0 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      uint32_t bq[4];
      ldsm_x4(bq, swz<D>(b_tile, 16 * j + ((lane >> 4) << 3) + (lane & 7), 2 * kk + ((lane >> 3) & 1)));
      mma_bf16(acc[2 * j], a, bq[0], bq[1]);
      mma_bf16(acc[2 * j + 1], a, bq[2], bq[3]);
    }
  }
}

// acc[16 rows x N] += P[16 rows x BQ] X[BQ x (columns 8*chunk0 .. + N)]: A =
// P from registers (the accumulator layout of keys_by_q, rounded to bf16), B
// = N columns of the [BQ][D] tile X from 16-byte chunk `chunk0` (even) on,
// read with the transposing ldmatrix. K3/K4c: dV += P^T dO, dK += dS^T Q;
// K2/K4b: dQ += dS K. N = D takes every column; a column split (K4b/K4c
// above D 128) gives each warp N = D / warps of it.
template <int D, int N, int BQ>
__device__ __forceinline__ void keys_by_d(float (&acc)[N / 8][4], const float (&p)[BQ / 8][4], uint32_t x_tile,
                                          int chunk0, int lane) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      uint32_t bx[4];
      ldsm_x4_t(bx, swz<D>(x_tile, 16 * kk + (lane & 15), chunk0 + 2 * n + (lane >> 4)));
      mma_bf16(acc[2 * n], a, bx[0], bx[1]);
      mma_bf16(acc[2 * n + 1], a, bx[2], bx[3]);
    }
  }
}

// The fp32 counterparts of keys_by_q and keys_by_d, on the tensor cores in
// fp32 accuracy: every product is mma.sync m16n8k8 TF32 issued three times
// over the split operands (mma_tf32x3). The tiles hold fp32 rows swizzled by
// swz<D, float> in 16-byte chunks of 4 floats.
//
// keys_by_q_tf32: acc[16 rows x BQ] += A[16 rows x D] B[BQ x D]^T. The
// non-transposed ldmatrix moves 32-bit words as pairs of b16 halves, so its
// four 8x8 b16 matrices are four 8-row x 4-float blocks: exactly the TF32 A
// fragment of m16n8k8 (rows g, g + 8 x columns t, t + 4) and two n-blocks'
// B fragments, at the addresses keys_by_q gives them, an 8-float k step in
// place of a 16-bf16 one. Chunk c of acc holds columns 8c + 2t (+1) of rows
// g (e = 0, 1) and g + 8 (e = 2, 3), as in bf16.
template <int D, int BQ>
__device__ __forceinline__ void keys_by_q_tf32(float (&acc)[BQ / 8][4], uint32_t a_tile, uint32_t b_tile, int row0,
                                               int lane) {
  // not unrolled: unrolled, the compiler hoists the loads of every k step
  // and runs out of registers (spills in K2, K3)
#pragma unroll 1
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, swz<D, float>(a_tile, row0 + (lane & 15), 2 * kk + (lane >> 4)));
    const SplitA sa = split_a(__uint_as_float(a[0]), __uint_as_float(a[1]), __uint_as_float(a[2]),
                              __uint_as_float(a[3]));
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      uint32_t bq[4];
      ldsm_x4(bq, swz<D, float>(b_tile, 16 * j + ((lane >> 4) << 3) + (lane & 7), 2 * kk + ((lane >> 3) & 1)));
      mma_tf32x3(acc[2 * j], sa, __uint_as_float(bq[0]), __uint_as_float(bq[1]));
      mma_tf32x3(acc[2 * j + 1], sa, __uint_as_float(bq[2]), __uint_as_float(bq[3]));
    }
  }
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float r;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(r) : "r"(addr) : "memory");
  return r;
}

// keys_by_d_tf32: acc[16 rows x N] += P[16 rows x BQ] X[BQ x (columns
// 4*chunk0 .. + N)], P from registers in keys_by_q_tf32's accumulator layout.
// That layout is not the TF32 A fragment (a thread holds columns 2t, 2t + 1,
// the fragment wants t, t + 4), so each 8-key k step is taken in a permuted
// order, the same for A and B: k = t is key 2t and k = t + 4 key 2t + 1. A is
// then (p[kk][0], p[kk][2], p[kk][1], p[kk][3]) with no shuffle, and B's
// elements X[8kk + 2t (+1)][column g of the n-block] are read one float each
// (ldmatrix has no 32-bit transpose). The swizzle puts the warp's 32 reads on
// 32 distinct banks: rows 2t and 2t + 1 XOR the chunk by 2t (+1), and the
// lanes' columns g span two chunks of 4 words.
template <int D, int N, int BQ>
__device__ __forceinline__ void keys_by_d_tf32(float (&acc)[N / 8][4], const float (&p)[BQ / 8][4], uint32_t x_tile,
                                               int chunk0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BQ / 8; ++kk) {
    const SplitA sa = split_a(p[kk][0], p[kk][2], p[kk][1], p[kk][3]);
    const int r0 = 8 * kk + 2 * t;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const int col = 4 * chunk0 + 8 * n + g;
      const uint32_t word = (col & 3) << 2;
      mma_tf32x3(acc[n], sa, lds_f32(swz<D, float>(x_tile, r0, col >> 2) + word),
                 lds_f32(swz<D, float>(x_tile, r0 + 1, col >> 2) + word));
    }
  }
}

// the products of a backward body for its element type T
template <typename T, int D, int BQ>
__device__ __forceinline__ void keys_by_q_t(float (&acc)[BQ / 8][4], uint32_t a_tile, uint32_t b_tile, int row0,
                                            int lane) {
  if constexpr (std::is_same<T, float>::value)
    keys_by_q_tf32<D, BQ>(acc, a_tile, b_tile, row0, lane);
  else
    keys_by_q<D, BQ>(acc, a_tile, b_tile, row0, lane);
}
template <typename T, int D, int N, int BQ>
__device__ __forceinline__ void keys_by_d_t(float (&acc)[N / 8][4], const float (&p)[BQ / 8][4], uint32_t x_tile,
                                            int chunk0, int lane) {
  if constexpr (std::is_same<T, float>::value)
    keys_by_d_tf32<D, N, BQ>(acc, p, x_tile, chunk0, lane);
  else
    keys_by_d<D, N, BQ>(acc, p, x_tile, chunk0, lane);
}

// (batch, seq, head) element strides of the six tensors a backward kernel
// touches, in the order of its C entry point
struct Strides {
  long long t[6][3];
};

// The shape of a backward block. It owns SLABS 16-row slabs of the resident
// axis (K2/K4b: q rows; K3/K4c: keys); CS warps share a slab, each computing
// the slab's S and dP over the whole head dim and owning DC = D / CS of the
// gradient columns. The streamed axis (K2/K4b: keys; K3/K4c: q rows) passes
// in TILE-row tiles through a 2-stage ring, and splits across blocks (grid z)
// in runs of whole UNIT rows. T is the tensors' element type: bf16
// (m16n8k16 products) or fp32 (3xTF32 m16n8k8 products).
template <int D_, int SLABS, int CS_, int TILE_, int UNIT_, typename T_ = __nv_bfloat16>
struct BwdCfg {
  using T = T_;
  static constexpr int D = D_, CS = CS_, TILE = TILE_, UNIT = UNIT_;
  static constexpr int ROWS = 16 * SLABS;
  static constexpr int THREADS = 32 * SLABS * CS;
  static constexpr int DC = D / CS;
  static constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  using DqSmem = BwdLayout<D, ROWS, TILE, false, sizeof(T)>;  // Q, dO resident; K, V streamed
  using DkvSmem = BwdLayout<D, ROWS, TILE, true, sizeof(T)>;  // K, V resident; Q, dO, lse, delta streamed
  static_assert(DC % (2 * EPC) == 0, "a warp's columns are whole blocks of the transposed B loads");
  static_assert(UNIT % TILE == 0 && TILE % 16 == 0, "a split is whole tiles, a tile whole ldmatrix blocks");
};

// [lo, hi) of split `split` of a length-n axis cut in `splits` runs of whole
// `unit`-row units (ops/flash_attention.py::split_ranges)
__device__ __forceinline__ int2 split_range(int n, int splits, int split, int unit) {
  const int per = ((n + unit - 1) / unit + splits - 1) / splits * unit;
  const int lo = min(n, split * per);
  return make_int2(lo, min(n, lo + per));
}

// The body of K2 (flash_bwd_dq_tc_kernel) and K4b (kgrid_bwd_dq_tc_kernel):
// dQ for one (ROWS-row q tile, batch*head, split of the key range). Per
// TILE-key tile: S = Q K^T, P = exp(scale S - lse) (scale applied to S in
// fp32; an exact 0 for keys past the split's end), dP = dO V^T, dS = P o (dP
// - delta), dQ[:, col0..] += dS K[:, col0..]. delta = rowsum(dO o O) in the
// prologue (a quad of threads per row, O in 16-byte loads); split 0 writes it.
// splits == 1 writes dQ (C::T, its own strides); splits > 1 writes unscaled
// fp32 partials [splits, B*H, Sq, D] for dq_merge. Strides: q, k, v, o, dO, dQ.
template <class C, typename T = typename C::T>
__device__ __forceinline__ void bwd_dq_tc(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                          const T* __restrict__ o, const T* __restrict__ dout,
                                          const float* __restrict__ lse, float* __restrict__ delta,
                                          T* __restrict__ dq, float* __restrict__ part_dq, int H, int Sq, int Sk,
                                          int splits, Strides st, float scale) {
  constexpr int D = C::D, TILE = C::TILE, EPC = C::EPC;
  using L = typename C::DqSmem;
  constexpr int CH = D / EPC;  // 16-byte chunks per row
  extern __shared__ __align__(128) uint8_t bwd_smem[];
  const uint32_t base = smem_u32(bwd_smem);
  const uint32_t sQ = base + L::A_OFF, sG = base + L::B_OFF;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qrow = warp / C::CS * 16;  // the warp's 16 q rows of the tile
  const int part = warp % C::CS;       // and its share of dQ's columns:
  const int col0 = part * C::DC;       // [col0, col0 + DC)
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * C::ROWS;
  const int split = blockIdx.z;
  const int2 range = split_range(Sk, splits, split, C::UNIT);
  const int lo = range.x, hi = range.y;
  const int n_tiles = (hi - lo + TILE - 1) / TILE;

  const T* qb = q + b * st.t[0][0] + h * st.t[0][2];
  const T* kb = k + b * st.t[1][0] + h * st.t[1][2];
  const T* vb = v + b * st.t[2][0] + h * st.t[2][2];
  const T* ob = o + b * st.t[3][0] + h * st.t[3][2];
  const T* gb = dout + b * st.t[4][0] + h * st.t[4][2];

  auto load_kv_tile = [&](int stage, int k0) {
    const uint32_t ring = base + L::RING_OFF + stage * L::STAGE;
    load_rows<D, TILE, C::THREADS>(ring + L::X_OFF, kb, st.t[1][1], k0, Sk);
    load_rows<D, TILE, C::THREADS>(ring + L::Y_OFF, vb, st.t[2][1], k0, Sk);
  };

  load_rows<D, C::ROWS, C::THREADS>(sQ, qb, st.t[0][1], q0, Sq);
  load_rows<D, C::ROWS, C::THREADS>(sG, gb, st.t[4][1], q0, Sq);
  cp_async_commit();
  if (n_tiles > 0) load_kv_tile(0, lo);
  cp_async_commit();

  // this thread's rows g and g + 8 of the warp's 16: lse, and delta =
  // rowsum(dO o O) in fp32, the four threads of a quad splitting the head dim
  float lse_l2[2], dl[2];
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + g + 8 * r;
    const int qi = q0 + row;
    float acc = 0.f;
    if (qi < Sq) {
      const T* orow = ob + (long long)qi * st.t[3][1];
#pragma unroll
      for (int c = t * (CH / 4); c < (t + 1) * (CH / 4); ++c)
        acc += dot_chunk<T>(*reinterpret_cast<const uint4*>(orow + EPC * c),
                            *reinterpret_cast<const uint4*>(bwd_smem + swz<D, T>(L::B_OFF, row, c)));
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[r] = acc;
    lse_l2[r] = qi < Sq ? lse[(long long)bh * Sq + qi] * LOG2E : 0.f;
    if (split == 0 && part == 0 && t == 0 && qi < Sq) delta[(long long)bh * Sq + qi] = acc;
  }

  float acc_dq[C::DC / 8][4];
#pragma unroll
  for (int n = 0; n < C::DC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dq[n][e] = 0.f;
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = lo + it * TILE;
    if (it + 1 < n_tiles) {
      load_kv_tile((it + 1) & 1, k0 + TILE);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t ring = base + L::RING_OFF + (it & 1) * L::STAGE;
    const uint32_t sK = ring + L::X_OFF, sV = ring + L::Y_OFF;

    // S = Q K^T, then P = exp(scale S - lse): chunk c holds keys 8c + 2t (+1)
    // of q rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float p[TILE / 8][4];
#pragma unroll
    for (int c = 0; c < TILE / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[c][e] = 0.f;
    keys_by_q_t<T, D, TILE>(p, sQ, sK, qrow, lane);
#pragma unroll
    for (int c = 0; c < TILE / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // keys past the split's end (Sk) would add to dQ: their P is an exact 0
        const bool ok = k0 + 8 * c + 2 * t + (e & 1) < hi;
        p[c][e] = ok ? exp2f(fmaf(p[c][e], scale_log2, -lse_l2[e >> 1])) : 0.f;
      }

    // dP = dO V^T, then dS = P o (dP - delta), then dQ[:, col0..] += dS K[:, col0..]
    float ds[TILE / 8][4];
#pragma unroll
    for (int c = 0; c < TILE / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[c][e] = 0.f;
    keys_by_q_t<T, D, TILE>(ds, sG, sV, qrow, lane);
#pragma unroll
    for (int c = 0; c < TILE / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[c][e] = p[c][e] * (ds[c][e] - dl[e >> 1]);
    keys_by_d_t<T, D, C::DC, TILE>(acc_dq, ds, sK, col0 / EPC, lane);
    __syncthreads();  // the stage is free for the tile after next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + qrow + g + 8 * r;
    if (qi >= Sq) continue;
    if (splits == 1) {
      T* row = dq + b * st.t[5][0] + h * st.t[5][2] + (long long)qi * st.t[5][1] + col0;
#pragma unroll
      for (int n = 0; n < C::DC / 8; ++n)
        store2(row + 8 * n + 2 * t, scale * acc_dq[n][2 * r], scale * acc_dq[n][2 * r + 1]);
    } else {
      float* row = part_dq + (((long long)split * gridDim.y + bh) * Sq + qi) * D + col0;
#pragma unroll
      for (int n = 0; n < C::DC / 8; ++n)
        *reinterpret_cast<float2*>(row + 8 * n + 2 * t) = make_float2(acc_dq[n][2 * r], acc_dq[n][2 * r + 1]);
    }
  }
}

// The body of K3 (flash_bwd_dkv_tc_kernel) and K4c (kgrid_bwd_dkv_tc_kernel):
// dK and dV for one (ROWS-key tile, batch*head, split of the query range).
// Per TILE-row q tile: S^T = K Q^T, P^T = exp(scale S^T - lse) (an exact 0 on
// padded query rows), dV += P^T dO, dP^T = V dO^T, dS^T = P^T o (dP^T -
// delta), dK += dS^T Q, each over the warp's DC columns. splits == 1 writes
// dK, dV (C::T, their own strides); splits > 1 writes fp32 partials [splits,
// B*H, Sk, D] (dK already scaled; zeros for a split with no q rows) for
// dkv_merge. Strides: q, k, v, dO, dK, dV.
template <class C, typename T = typename C::T>
__device__ __forceinline__ void bwd_dkv_tc(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                           const T* __restrict__ dout, const float* __restrict__ lse,
                                           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                                           float* __restrict__ part_dk, float* __restrict__ part_dv, int H, int Sq,
                                           int Sk, int splits, Strides st, float scale) {
  constexpr int D = C::D, TILE = C::TILE, EPC = C::EPC;
  using L = typename C::DkvSmem;
  extern __shared__ __align__(128) uint8_t bwd_smem[];
  const uint32_t base = smem_u32(bwd_smem);
  const uint32_t sK = base + L::A_OFF, sV = base + L::B_OFF;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int krow = warp / C::CS * 16;  // the warp's 16 keys of the tile
  const int part = warp % C::CS;       // and its share of dK's and dV's columns:
  const int col0 = part * C::DC;       // [col0, col0 + DC)
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * C::ROWS;
  const int split = blockIdx.z;
  const int2 range = split_range(Sq, splits, split, C::UNIT);
  const int lo = range.x, hi = range.y;
  const int n_tiles = (hi - lo + TILE - 1) / TILE;

  const T* qb = q + b * st.t[0][0] + h * st.t[0][2];
  const T* kb = k + b * st.t[1][0] + h * st.t[1][2];
  const T* vb = v + b * st.t[2][0] + h * st.t[2][2];
  const T* gb = dout + b * st.t[3][0] + h * st.t[3][2];
  const float* lse_b = lse + (long long)bh * Sq;
  const float* delta_b = delta + (long long)bh * Sq;

  auto load_q_tile = [&](int stage, int i0) {
    const uint32_t ring = base + L::RING_OFF + stage * L::STAGE;
    load_rows<D, TILE, C::THREADS>(ring + L::X_OFF, qb, st.t[0][1], i0, Sq);
    load_rows<D, TILE, C::THREADS>(ring + L::Y_OFF, gb, st.t[3][1], i0, Sq);
    for (int i = tid; i < TILE; i += C::THREADS) {
      const bool ok = i0 + i < Sq;
      cp_async4(ring + L::L_OFF + 4 * i, lse_b + (ok ? i0 + i : 0), ok);
      cp_async4(ring + L::DL_OFF + 4 * i, delta_b + (ok ? i0 + i : 0), ok);
    }
  };

  load_rows<D, C::ROWS, C::THREADS>(sK, kb, st.t[1][1], k0, Sk);
  load_rows<D, C::ROWS, C::THREADS>(sV, vb, st.t[2][1], k0, Sk);
  if (n_tiles > 0) load_q_tile(0, lo);
  cp_async_commit();

  float acc_dk[C::DC / 8][4], acc_dv[C::DC / 8][4];
#pragma unroll
  for (int n = 0; n < C::DC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = lo + it * TILE;
    if (it + 1 < n_tiles) {
      load_q_tile((it + 1) & 1, i0 + TILE);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int stage_off = L::RING_OFF + (it & 1) * L::STAGE;
    const uint32_t sQ = base + stage_off + L::X_OFF, sG = base + stage_off + L::Y_OFF;
    const float* sL = reinterpret_cast<const float*>(bwd_smem + stage_off + L::L_OFF);
    const float* sD = reinterpret_cast<const float*>(bwd_smem + stage_off + L::DL_OFF);

    // S^T = K Q^T, then P^T = exp(scale S^T - lse): chunk c holds q columns
    // 8c + 2t (+1) of key rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float p[TILE / 8][4];
#pragma unroll
    for (int c = 0; c < TILE / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[c][e] = 0.f;
    keys_by_q_t<T, D, TILE>(p, sK, sQ, krow, lane);
#pragma unroll
    for (int c = 0; c < TILE / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * c + 2 * t + (e & 1);
        // padded query rows would add to dK and dV: their P is an exact 0
        p[c][e] = i0 + col < Sq ? exp2f(fmaf(p[c][e], scale_log2, -sL[col] * LOG2E)) : 0.f;
      }
    keys_by_d_t<T, D, C::DC, TILE>(acc_dv, p, sG, col0 / EPC, lane);  // dV += P^T dO

    // dP^T = V dO^T, then dS^T = P^T o (dP^T - delta)
    float ds[TILE / 8][4];
#pragma unroll
    for (int c = 0; c < TILE / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[c][e] = 0.f;
    keys_by_q_t<T, D, TILE>(ds, sV, sG, krow, lane);
#pragma unroll
    for (int c = 0; c < TILE / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[c][e] = p[c][e] * (ds[c][e] - sD[8 * c + 2 * t + (e & 1)]);
    keys_by_d_t<T, D, C::DC, TILE>(acc_dk, ds, sQ, col0 / EPC, lane);  // dK += dS^T Q (scaled at the end)
    __syncthreads();  // the stage is free for the tile after next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + krow + g + 8 * r;
    if (key >= Sk) continue;
    if (splits == 1) {
      T* krow_p = dk + b * st.t[4][0] + h * st.t[4][2] + (long long)key * st.t[4][1] + col0;
      T* vrow_p = dv + b * st.t[5][0] + h * st.t[5][2] + (long long)key * st.t[5][1] + col0;
#pragma unroll
      for (int n = 0; n < C::DC / 8; ++n) {
        store2(krow_p + 8 * n + 2 * t, scale * acc_dk[n][2 * r], scale * acc_dk[n][2 * r + 1]);
        store2(vrow_p + 8 * n + 2 * t, acc_dv[n][2 * r], acc_dv[n][2 * r + 1]);
      }
    } else {
      const long long row = ((long long)split * gridDim.y + bh) * Sk + key;
      float* pk = part_dk + row * D + col0;
      float* pv = part_dv + row * D + col0;
#pragma unroll
      for (int n = 0; n < C::DC / 8; ++n) {
        *reinterpret_cast<float2*>(pk + 8 * n + 2 * t) =
            make_float2(scale * acc_dk[n][2 * r], scale * acc_dk[n][2 * r + 1]);
        *reinterpret_cast<float2*>(pv + 8 * n + 2 * t) = make_float2(acc_dv[n][2 * r], acc_dv[n][2 * r + 1]);
      }
    }
  }
}

// dQ (bf16 or fp32) = scale * the sum of the splits' fp32 partials, in split
// order (no atomics: two runs give the same bits); one thread per
// (batch*head, q row, column pair)
template <int D, typename T>
__device__ __forceinline__ void dq_merge(const float* __restrict__ part_dq, T* __restrict__ dq, int BH, int H, int Sq,
                                         int splits, Strides st, float scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long plane = (long long)BH * Sq * D;
  if (2 * i >= plane) return;
  const int col = (int)(2 * i % D);
  const long long row = 2 * i / D;  // bh * Sq + qi
  const int qi = (int)(row % Sq);
  const int bh = (int)(row / Sq);
  const int b = bh / H;
  const int h = bh - b * H;
  float2 sum = make_float2(0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float2 a = *reinterpret_cast<const float2*>(part_dq + s * plane + 2 * i);
    sum.x += a.x;
    sum.y += a.y;
  }
  store2(dq + b * st.t[5][0] + h * st.t[5][2] + (long long)qi * st.t[5][1] + col, scale * sum.x, scale * sum.y);
}

// dK, dV (bf16 or fp32) = the sum of the splits' fp32 partials, in split
// order; one thread per (batch*head, key, column pair)
template <int D, typename T>
__device__ __forceinline__ void dkv_merge(const float* __restrict__ part_dk, const float* __restrict__ part_dv,
                                          T* __restrict__ dk, T* __restrict__ dv, int BH, int H, int Sk, int splits,
                                          Strides st) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long plane = (long long)BH * Sk * D;
  if (2 * i >= plane) return;
  const int col = (int)(2 * i % D);
  const long long row = 2 * i / D;  // bh * Sk + key
  const int key = (int)(row % Sk);
  const int bh = (int)(row / Sk);
  const int b = bh / H;
  const int h = bh - b * H;
  float2 sk = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float2 a = *reinterpret_cast<const float2*>(part_dk + s * plane + 2 * i);
    const float2 c = *reinterpret_cast<const float2*>(part_dv + s * plane + 2 * i);
    sk.x += a.x;
    sk.y += a.y;
    sv.x += c.x;
    sv.y += c.y;
  }
  store2(dk + b * st.t[4][0] + h * st.t[4][2] + (long long)key * st.t[4][1] + col, sk.x, sk.y);
  store2(dv + b * st.t[5][0] + h * st.t[5][2] + (long long)key * st.t[5][1] + col, sv.x, sv.y);
}

// ---------------------------------------------------------------------------
// the fp32 forward (K1 in flash_attention_fwd.cu, K4a in
// flash_attention_kgrid.cu): 3xTF32 mma.sync on operands split once per block
// ---------------------------------------------------------------------------

constexpr float MASKED = -1e30f;  // a masked logit: exp2 of it minus any real max is an exact 0

// byte address of 16-byte chunk `chunk` of row `row` in a tile of rows of CH
// chunks (CH 2, 4 or a multiple of 8), XOR-swizzled so that chunk c of any 8
// consecutive rows falls on 8 distinct 16-byte bank groups: an ldmatrix
// 8x8 matrix is read in one pass. For CH >= 8 this is swz<4 * CH, float>.
template <int CH>
__device__ __forceinline__ uint32_t swz_rows(uint32_t tile, int row, int chunk) {
  constexpr int PER_LINE = CH >= 8 ? 1 : 8 / CH;  // rows per 128-byte line
  constexpr int MASK = (CH >= 8 ? 8 : CH) - 1;
  return tile + row * (CH * 16) + ((chunk ^ ((row / PER_LINE) & MASK)) << 4);
}

__device__ __forceinline__ void sts_v4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}
__device__ __forceinline__ void sts_b32(uint32_t addr, uint32_t a) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(a) : "memory");
}

// four fp32 values times `mul` as one 16-byte chunk at `off`: split into
// TF32 halves in the big and the small tile (PRESPLIT), or as they are in
// the big tile (each warp splits what it reads)
template <bool PRESPLIT>
__device__ __forceinline__ void sts_split4(uint32_t big, uint32_t small, uint32_t off, float4 x, float mul) {
  if (!PRESPLIT) {
    sts_v4(big + off, __float_as_uint(x.x * mul), __float_as_uint(x.y * mul), __float_as_uint(x.z * mul),
           __float_as_uint(x.w * mul));
    return;
  }
  uint32_t b[4], s[4];
  tf32_split(x.x * mul, b[0], s[0]);
  tf32_split(x.y * mul, b[1], s[1]);
  tf32_split(x.z * mul, b[2], s[2]);
  tf32_split(x.w * mul, b[3], s[3]);
  sts_v4(big + off, b[0], b[1], b[2], b[3]);
  sts_v4(small + off, s[0], s[1], s[2], s[3]);
}

// one split operand, element for element as ldmatrix gives it: from the big
// and the small tile at the same offset (PRESPLIT), or read as fp32 from the
// big tile and split here
template <bool PRESPLIT>
__device__ __forceinline__ void ldsm_x4_split(uint32_t (&big)[4], uint32_t (&small)[4], uint32_t big_tile,
                                              uint32_t small_tile, uint32_t off) {
  ldsm_x4(big, big_tile + off);
  if (PRESPLIT) {
    ldsm_x4(small, small_tile + off);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) tf32_split(__uint_as_float(big[i]), big[i], small[i]);
  }
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The shape of an fp32 forward block: SLABS slabs of 16 * WM q rows; CS
// warps share a slab, warp `part` owning head-dim columns [part * DC, (part
// + 1) * DC) of Q, K, V and O: it computes the slab's scores over its
// columns, the CS partial scores are summed through shared memory (in part
// order, so every warp of the slab holds the same bits), and it accumulates
// O on its columns. A warp's WM 16-row m-tiles share every B fragment it
// reads. Keys pass in TILE-key tiles; the key range splits across blocks
// (grid z) in runs of whole UNIT keys. PRESPLIT: the block splits Q, K and V
// into TF32 halves once, into a big and a small shared tile each; else the
// tiles hold fp32 and each warp splits what it reads (half the shared
// memory and its traffic, more instructions a product).
template <int D_, int SLABS_, int CS_, int TILE_, int UNIT_, int WM_, bool PRESPLIT_>
struct FwdCfg {
  static constexpr int D = D_, SLABS = SLABS_, CS = CS_, TILE = TILE_, UNIT = UNIT_, WM = WM_;
  static constexpr bool PRESPLIT = PRESPLIT_;
  static constexpr int ROWS = 16 * WM * SLABS;
  static constexpr int THREADS = 32 * SLABS * CS;
  static constexpr int DC = D / CS;
  static constexpr int CH = D / 4;     // 16-byte chunks of a Q or K row
  static constexpr int TCH = TILE / 4;  // ... of a row of the transposed V tile
  // shared memory (bytes): Q [ROWS][D], K [TILE][D] and V^T [D][TILE], each
  // a big and (PRESPLIT) a small tile; the partial scores
  static constexpr int NT = PRESPLIT ? 2 : 1;
  static constexpr int Q_BYTES = ROWS * D * 4, KV_BYTES = TILE * D * 4;
  static constexpr int QB = 0, QS = (NT - 1) * Q_BYTES, KB = NT * Q_BYTES, KS = KB + (NT - 1) * KV_BYTES,
                       VB = KB + NT * KV_BYTES, VS = VB + (NT - 1) * KV_BYTES, X_OFF = VB + NT * KV_BYTES;
  static constexpr int BYTES = X_OFF + (CS > 1 ? SLABS * CS * WM * 16 * TILE * 4 : 0);
  // 16-byte chunks of K (and of V) a thread carries: the tile's TILE * CH
  // over the block, the last ones partly empty where they do not divide
  static constexpr int PREFETCH = (TILE * CH + THREADS - 1) / THREADS;
  static constexpr bool RAGGED = (TILE * CH) % THREADS != 0;
  static_assert(DC % 16 == 0 && TILE % 8 == 0 && UNIT % TILE == 0, "whole ldmatrix blocks; a split is whole tiles");
  static_assert(TCH == 2 || TCH == 4 || TCH % 8 == 0, "swz_rows takes the transposed rows");
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// The fp32 forward of K1 (flash_fwd_tf32_kernel) and K4a
// (kgrid_fwd_tf32_kernel) for one (ROWS-row q tile, batch*head, split of the
// key range). Every product is 3xTF32 mma.sync m16n8k8 (mma_tf32x3_split)
// on operands split into TF32 halves: by the block once, in shared memory
// (PRESPLIT: Q, times scale * log2(e), before the key loop; each K and V tile
// as it lands), or by each warp as it reads them. V is stored transposed
// with its keys permuted within each 8 (position t holds key 2t, position
// t + 4 key 2t + 1), so that P's accumulator layout is the A fragment
// (keys_by_d_tf32's order) and V^T's B fragments come by ldmatrix. K and V
// tiles are prefetched into registers one tile ahead (16-byte loads; keys at
// or past the split's end are zeros), then stored after a barrier. Per tile:
// S = Q K^T (over the warp's columns, then summed across the slab), keys
// past the split's end masked, the online softmax in base 2 (fp32 m, l;
// P = exp2(S - m)), O += P V on the warp's columns. splits == 1 writes
// O = acc / l and lse = (m + log2 l) ln 2; splits > 1 writes the unnormalised
// fp32 partials [splits, B*H, Sq](, D) for fwd_merge (m in natural-log
// units; an empty split keeps m = MASKED, l = 0, acc = 0). Strides: q, k,
// v, o.
template <class C>
__device__ __forceinline__ void fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
                                         const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                                         float* __restrict__ part_acc, float* __restrict__ part_m,
                                         float* __restrict__ part_l, int H, int Sq, int Sk, Strides st,
                                         float scale_log2) {
  constexpr int D = C::D, TILE = C::TILE, CH = C::CH, TCH = C::TCH, DC = C::DC, NP = C::PREFETCH, WM = C::WM;
  constexpr int NC = TILE / 8;  // 8-key chunks of a tile
  constexpr bool PRE = C::PRESPLIT;
  constexpr int KP_UNROLL = WM == 1 ? 2 : 1;  // two m-tiles' A fragments of two k-step pairs do not fit
  extern __shared__ __align__(128) uint8_t fwd_smem[];
  const uint32_t base = smem_u32(fwd_smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slab = warp / C::CS;
  const int part = warp % C::CS;
  const int row0 = 16 * WM * slab;  // the warp's q rows of the tile: m-tile i at row0 + 16 i
  const int col0 = part * DC;       // and its head-dim columns [col0, col0 + DC)
  const int c0 = col0 / 4;          // as 16-byte chunks
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * C::ROWS;
  const int splits = gridDim.z;
  const int split = blockIdx.z;
  const int2 range = split_range(Sk, splits, split, C::UNIT);
  const int lo = range.x, hi = range.y;
  const int n_tiles = (hi - lo + TILE - 1) / TILE;

  const float* qb = q + b * st.t[0][0] + h * st.t[0][2];
  const float* kb = k + b * st.t[1][0] + h * st.t[1][2];
  const float* vb = v + b * st.t[2][0] + h * st.t[2][2];

  // K: chunk c of key r (chunks of a key on neighbouring threads, as the
  // K tile is stored); V: key r of chunk c (keys on neighbouring threads, so
  // that the transposed stores of a warp spread over the banks)
  float4 kr[NP], vr[NP];
  auto prefetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int i = tid + j * C::THREADS;
      if (C::RAGGED && i >= TILE * CH) break;
      const int rk = i / CH, ck = i - rk * CH;
      const int rv = i % TILE, cv = i / TILE;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      kr[j] = k0 + rk < hi ? __ldg(reinterpret_cast<const float4*>(kb + (long long)(k0 + rk) * st.t[1][1] + 4 * ck))
                           : zero;
      vr[j] = k0 + rv < hi ? __ldg(reinterpret_cast<const float4*>(vb + (long long)(k0 + rv) * st.t[2][1] + 4 * cv))
                           : zero;
    }
  };
  if (n_tiles > 0) prefetch(lo);

  // Q times scale * log2(e); rows past Sq are zeros and never stored
  for (int i = tid; i < C::ROWS * CH; i += C::THREADS) {
    const int r = i / CH, c = i - r * CH;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) x = __ldg(reinterpret_cast<const float4*>(qb + (long long)(q0 + r) * st.t[0][1] + 4 * c));
    sts_split4<PRE>(base + C::QB, base + C::QS, swz_rows<CH>(0, r, c), x, scale_log2);
  }

  float acc[WM][DC / 8][4];
  float m_r[WM][2], l_r[WM][2];  // running max of the base-2 scores, rows g and g + 8; this thread's part of the sum
#pragma unroll
  for (int i = 0; i < WM; ++i) {
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
    m_r[i][0] = m_r[i][1] = MASKED;
    l_r[i][0] = l_r[i][1] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = lo + it * TILE;
    __syncthreads();  // every warp is done with the previous tile (and Q is stored)
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int i = tid + j * C::THREADS;
      if (C::RAGGED && i >= TILE * CH) break;
      const int rk = i / CH, ck = i - rk * CH;
      sts_split4<PRE>(base + C::KB, base + C::KS, swz_rows<CH>(0, rk, ck), kr[j], 1.f);
      const int rv = i % TILE, cv = i / TILE;
      const int pos = (rv & ~7) | ((rv & 7) >> 1) | ((rv & 1) << 2);  // key 2t -> t, 2t + 1 -> t + 4
      const float x[4] = {vr[j].x, vr[j].y, vr[j].z, vr[j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t off = swz_rows<TCH>(0, 4 * cv + e, pos >> 2) + 4 * (pos & 3);
        if (PRE) {
          uint32_t big, small;
          tf32_split(x[e], big, small);
          sts_b32(base + C::VB + off, big);
          sts_b32(base + C::VS + off, small);
        } else {
          sts_b32(base + C::VB + off, __float_as_uint(x[e]));
        }
      }
    }
    __syncthreads();  // the tiles are stored; the registers are free for the next tile
    if (it + 1 < n_tiles) prefetch(k0 + TILE);

    // S = Q K^T over this warp's columns, two 8-deep k steps per ldmatrix:
    // chunk c of s[i] holds keys 8c + 2t (+1) of m-tile i's rows g (e = 0, 1)
    // and g + 8 (e = 2, 3)
    float s[WM][NC][4];
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][c][e] = 0.f;
#pragma unroll(KP_UNROLL)
    for (int kp = 0; kp < DC / 16; ++kp) {
      uint32_t qa[WM][2][4], qs[WM][2][4];
#pragma unroll
      for (int i = 0; i < WM; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          ldsm_x4_split<PRE>(qa[i][hh], qs[i][hh], base + C::QB, base + C::QS,
                             swz_rows<CH>(0, row0 + 16 * i + (lane & 15), c0 + 4 * kp + 2 * hh + (lane >> 4)));
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        uint32_t kb4[4], ks4[4];
        ldsm_x4_split<PRE>(kb4, ks4, base + C::KB, base + C::KS,
                           swz_rows<CH>(0, 8 * j + (lane & 7), c0 + 4 * kp + (lane >> 3)));
#pragma unroll
        for (int i = 0; i < WM; ++i) {
          mma_tf32x3_split(s[i][j], qa[i][0], qs[i][0], kb4[0], kb4[1], ks4[0], ks4[1]);
          mma_tf32x3_split(s[i][j], qa[i][1], qs[i][1], kb4[2], kb4[3], ks4[2], ks4[3]);
        }
      }
    }
    if constexpr (C::CS > 1) {
      // the slab's full scores: the CS parts summed in part order through
      // shared memory, [part][m-tile][chunk][lane] float4 per slab
      float4* x = reinterpret_cast<float4*>(fwd_smem + C::X_OFF) + slab * C::CS * WM * NC * 32;
#pragma unroll
      for (int i = 0; i < WM; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          x[((part * WM + i) * NC + c) * 32 + lane] = make_float4(s[i][c][0], s[i][c][1], s[i][c][2], s[i][c][3]);
      bar_sync(1 + slab, 32 * C::CS);
#pragma unroll
      for (int i = 0; i < WM; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float4 sum = x[(i * NC + c) * 32 + lane];
#pragma unroll
          for (int p = 1; p < C::CS; ++p) {
            const float4 y = x[((p * WM + i) * NC + c) * 32 + lane];
            sum.x += y.x;
            sum.y += y.y;
            sum.z += y.z;
            sum.w += y.w;
          }
          s[i][c][0] = sum.x;
          s[i][c][1] = sum.y;
          s[i][c][2] = sum.z;
          s[i][c][3] = sum.w;
        }
    }

    // online softmax in base 2 (Q carries scale * log2(e)); keys past the
    // split's end are masked before the max
#pragma unroll
    for (int i = 0; i < WM; ++i) {
      float mx[2] = {m_r[i][0], m_r[i][1]};
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + 8 * c + 2 * t + (e & 1) >= hi) s[i][c][e] = MASKED;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[i][c][e]);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f(m_r[i][r] - mx[r]);
        m_r[i][r] = mx[r];
        l_r[i][r] *= corr[r];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][c][e] = exp2f(s[i][c][e] - m_r[i][e >> 1]);
          l_r[i][e >> 1] += s[i][c][e];
        }
#pragma unroll
      for (int n = 0; n < DC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] *= corr[e >> 1];
    }

    // O[:, col0..] += P V[:, col0..]: each 8-key k step in the permuted
    // order, A = P split from the accumulator layout, B from V^T
#pragma unroll
    for (int kk = 0; kk < NC; ++kk) {
      SplitA pa[WM];
#pragma unroll
      for (int i = 0; i < WM; ++i) pa[i] = split_a(s[i][kk][0], s[i][kk][2], s[i][kk][1], s[i][kk][3]);
#pragma unroll
      for (int n2 = 0; n2 < DC / 16; ++n2) {
        uint32_t vb4[4], vs4[4];
        ldsm_x4_split<PRE>(
            vb4, vs4, base + C::VB, base + C::VS,
            swz_rows<TCH>(0, col0 + 16 * n2 + ((lane >> 4) << 3) + (lane & 7), 2 * kk + ((lane >> 3) & 1)));
#pragma unroll
        for (int i = 0; i < WM; ++i) {
          mma_tf32x3_split(acc[i][2 * n2], pa[i].big, pa[i].small, vb4[0], vb4[1], vs4[0], vs4[1]);
          mma_tf32x3_split(acc[i][2 * n2 + 1], pa[i].big, pa[i].small, vb4[2], vb4[3], vs4[2], vs4[3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[i][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int qi = q0 + row0 + 16 * i + g + 8 * r;
      if (qi >= Sq) continue;
      if (splits == 1) {
        const float inv = 1.f / l;
        float* orow = o + b * st.t[3][0] + h * st.t[3][2] + (long long)qi * st.t[3][1] + col0;
#pragma unroll
        for (int n = 0; n < DC / 8; ++n)
          store2(orow + 8 * n + 2 * t, acc[i][n][2 * r] * inv, acc[i][n][2 * r + 1] * inv);
        if (part == 0 && t == 0) lse[(long long)bh * Sq + qi] = (m_r[i][r] + log2f(l)) * LN2;
      } else {
        const long long row = ((long long)split * gridDim.y + bh) * Sq + qi;
        float* prow = part_acc + row * D + col0;
#pragma unroll
        for (int n = 0; n < DC / 8; ++n)
          *reinterpret_cast<float2*>(prow + 8 * n + 2 * t) = make_float2(acc[i][n][2 * r], acc[i][n][2 * r + 1]);
        if (part == 0 && t == 0) {
          part_m[row] = m_r[i][r] == MASKED ? MASKED : m_r[i][r] * LN2;
          part_l[row] = l;
        }
      }
    }
}

// A forward's output element from fp32
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

constexpr int FWD_MERGE_THREADS = 128;
constexpr int FWD_MAX_SPLITS = 64;

// The merge of a split forward (K4a's kgrid_merge_kernel, fp32 K1's
// flash_fwd_merge_kernel), one block per (q row, batch*head): m* = max m_s,
// l* = sum l_s e^(m_s - m*), O = sum acc_s e^(m_s - m*) / l*, lse = m* +
// log l*. An empty split (m = MASKED, l = 0) has weight exp(-1e30 - m*) = 0.
template <typename T>
__device__ __forceinline__ void fwd_merge(const float* __restrict__ part_acc, const float* __restrict__ part_m,
                                          const float* __restrict__ part_l, T* __restrict__ o,
                                          float* __restrict__ lse, int H, int Sq, int D, int splits, long long o_sb,
                                          long long o_ss, long long o_sh) {
  __shared__ float w[FWD_MAX_SPLITS];
  __shared__ float inv_l;
  const int qi = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const long long plane = (long long)gridDim.y * Sq;  // rows per split
  const long long row = (long long)bh * Sq + qi;
  if (threadIdx.x == 0) {
    float m_star = MASKED;
    for (int s = 0; s < splits; ++s) m_star = fmaxf(m_star, part_m[s * plane + row]);
    float l_star = 0.f;
    for (int s = 0; s < splits; ++s) {
      w[s] = expf(part_m[s * plane + row] - m_star);
      l_star += part_l[s * plane + row] * w[s];
    }
    inv_l = 1.f / l_star;
    lse[row] = m_star + logf(l_star);
  }
  __syncthreads();
  T* orow = o + b * o_sb + h * o_sh + (long long)qi * o_ss;
  for (int col = threadIdx.x; col < D; col += FWD_MERGE_THREADS) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc = fmaf(part_acc[(s * plane + row) * D + col], w[s], acc);
    store1(orow + col, acc * inv_l);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// cudaFuncSetAttribute for `kernel` once per device (the attribute is the
// device's); `done` holds one bit per device, kept by the caller per kernel
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes, uint64_t& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && (done >> dev) & 1)) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done |= uint64_t(1) << dev;
  return err;
}

// every row of a BSHD tensor (element strides sb, ss, sh of `elem`-byte
// elements) starts on 16 bytes
inline bool rows_aligned(const void* p, long long sb, long long ss, long long sh, int B, int S, int H,
                         int elem = 2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (B == 1 || sb * elem % 16 == 0) &&
         (S == 1 || ss * elem % 16 == 0) && (H == 1 || sh * elem % 16 == 0);
}

inline Strides unpack(const long long* s) {
  Strides st;
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 3; ++j) st.t[i][j] = s[3 * i + j];
  return st;
}

// The launch of a bwd_dq_tc kernel (K2, K4b) of shape C over a grid of
// (q tiles, B*H, splits), then of its dq_merge kernel when split; tensors of
// C::T. cp.async and the delta prologue move 16-byte chunks: q, k, v, o and dO
// rows must start on 16 bytes (else cudaErrorInvalidValue). `smem_set` is the kernel's
// allow_smem record. Strides: q, k, v, o, dO, dQ.
template <class C, typename Kernel, typename Merge>
inline int launch_bwd_dq(Kernel kernel, Merge merge, uint64_t& smem_set, const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse, float* delta, void* dq, float* part_dq,
                         int B, int H, int Sq, int Sk, int splits, const long long* s, float scale,
                         cudaStream_t stream) {
  using T = typename C::T;
  constexpr int E = sizeof(T);
  if (!rows_aligned(q, s[0], s[1], s[2], B, Sq, H, E) || !rows_aligned(k, s[3], s[4], s[5], B, Sk, H, E) ||
      !rows_aligned(v, s[6], s[7], s[8], B, Sk, H, E) || !rows_aligned(o, s[9], s[10], s[11], B, Sq, H, E) ||
      !rows_aligned(dout, s[12], s[13], s[14], B, Sq, H, E))
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || (splits > 1 && part_dq == nullptr)) return (int)cudaErrorInvalidValue;
  constexpr int smem = C::DqSmem::BYTES;
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const Strides st = unpack(s);
  dim3 grid((Sq + C::ROWS - 1) / C::ROWS, B * H, splits);
  kernel<<<grid, C::THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                             static_cast<const T*>(v), static_cast<const T*>(o),
                                             static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), part_dq, H,
                                             Sq, Sk, splits, st, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long pairs = (long long)B * H * Sq * C::D / 2;
  merge<<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(part_dq, static_cast<T*>(dq), B * H, H, Sq, splits, st,
                                                              scale);
  return (int)cudaGetLastError();
}

// The launch of a bwd_dkv_tc kernel (K3, K4c) of shape C over a grid of (key
// tiles, B*H, splits), then of its dkv_merge kernel when split; q, k, v and dO
// rows must start on 16 bytes. Strides: q, k, v, dO, dK, dV.
template <class C, typename Kernel, typename Merge>
inline int launch_bwd_dkv(Kernel kernel, Merge merge, uint64_t& smem_set, const void* q, const void* k, const void* v,
                          const void* dout, const float* lse, const float* delta, void* dk, void* dv, float* part_dk,
                          float* part_dv, int B, int H, int Sq, int Sk, int splits, const long long* s, float scale,
                          cudaStream_t stream) {
  using T = typename C::T;
  constexpr int E = sizeof(T);
  if (!rows_aligned(q, s[0], s[1], s[2], B, Sq, H, E) || !rows_aligned(k, s[3], s[4], s[5], B, Sk, H, E) ||
      !rows_aligned(v, s[6], s[7], s[8], B, Sk, H, E) || !rows_aligned(dout, s[9], s[10], s[11], B, Sq, H, E))
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || (splits > 1 && (part_dk == nullptr || part_dv == nullptr))) return (int)cudaErrorInvalidValue;
  constexpr int smem = C::DkvSmem::BYTES;
  cudaError_t err = allow_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const Strides st = unpack(s);
  dim3 grid((Sk + C::ROWS - 1) / C::ROWS, B * H, splits);
  kernel<<<grid, C::THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                             static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
                                             static_cast<T*>(dk), static_cast<T*>(dv), part_dk, part_dv, H, Sq, Sk,
                                             splits, st, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long pairs = (long long)B * H * Sk * C::D / 2;
  merge<<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(part_dk, part_dv, static_cast<T*>(dk),
                                                              static_cast<T*>(dv), B * H, H, Sk, splits, st);
  return (int)cudaGetLastError();
}

// The launch of an fwd_tf32 kernel (fp32 K1, K4a) of shape C over a grid of
// (q tiles, B*H, splits), then of its fwd_merge kernel when split. The
// 16-byte loads need q, k and v rows on 16 bytes (else
// cudaErrorInvalidValue); o is written with float2 stores. Strides (12): q,
// k, v, o.
template <class C, typename Kernel, typename Merge>
inline int launch_fwd_tf32(Kernel kernel, Merge merge, uint64_t& smem_set, const void* q, const void* k,
                           const void* v, void* o, float* lse, float* part_acc, float* part_m, float* part_l, int B,
                           int H, int Sq, int Sk, int splits, const long long* s, float scale, cudaStream_t stream) {
  if (!rows_aligned(q, s[0], s[1], s[2], B, Sq, H, 4) || !rows_aligned(k, s[3], s[4], s[5], B, Sk, H, 4) ||
      !rows_aligned(v, s[6], s[7], s[8], B, Sk, H, 4))
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > FWD_MAX_SPLITS || (splits > 1 && (part_acc == nullptr || part_m == nullptr ||
                                                               part_l == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, C::BYTES, smem_set);
  if (err != cudaSuccess) return (int)err;
  Strides st{};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 3; ++j) st.t[i][j] = s[3 * i + j];
  dim3 grid((Sq + C::ROWS - 1) / C::ROWS, B * H, splits);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                 static_cast<const float*>(v), static_cast<float*>(o), lse, part_acc,
                                                 part_m, part_l, H, Sq, Sk, st, scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  merge<<<dim3(Sq, B * H), FWD_MERGE_THREADS, 0, stream>>>(part_acc, part_m, part_l, static_cast<float*>(o), lse, H,
                                                           Sq, C::D, splits, s[9], s[10], s[11]);
  return (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, fetched once through
// cudaGetDriverEntryPoint (the library links no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A [B, S, H, D] bf16 tensor as TMA sees it: dims innermost first (D, S, H,
// B), byte strides of S, H and B (a dim of size 1 takes a dense stride: its
// own is never stepped), boxes of 64 columns x `rows` rows of one head, with
// the 128-byte swizzle the wgmma descriptors read; TMA zero-fills a box past
// the tensor's end. Returns false for what TMA refuses: a base or stride not
// on 16 bytes.
inline bool bshd_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, long long sb, long long ss,
                     long long sh, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  if (S == 1) ss = (long long)H * D;
  if (H == 1) sh = D;
  if (B == 1) sb = (long long)S * H * D;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || ss % 8 || sh % 8 || sb % 8 || ss <= 0 || sh <= 0 || sb <= 0)
    return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
