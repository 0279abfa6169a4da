// Dynamic-int8 matrix product for Hopper (sm_90a): a quantise pass, then a
// persistent TMA + wgmma GEMM.
//
// Replaces tdspa/kernels/quant_matmul.py `_quant_matmul_pallas` (body
// `_quant_matmul_kernel`):
//
//   sx[m]    = max(max_k |x[m,k]|, 1e-30) * f32(1/127)      (x upcast to f32)
//   xq[m,k]  = clip(rint(x[m,k] / sx[m]), -127, 127)          (int8)
//   out[m,n] = (f32(sum_k xq[m,k] * wq[n,k]) * sx[m]) * ws[n]
//
// x is f32 or bf16 [M, K]; the weight is quantised per column outside the
// kernel and given transposed, wq int8 [N, K] with scales ws f32 [N]; the
// output is f32 [M, N].
//
// Numerics: the scale multiplies by the f32 reciprocal of 127, as XLA
// compiles the JAX package's `/ 127.0`; x / sx is an IEEE division
// (__fdiv_rn, never a reciprocal multiply); round half to even (rintf); s32
// accumulation (exact: |sum| <= 127^2 K); the dequantisation order
// (acc * sx) * ws of the TPU body. With the same quantised values the result
// equals the plain version bit for bit.
//
// What bounds it on an H100: the 3DSPA shapes do 2 K int8 operations per f32
// output element (K = 384..2048) against 4 bytes written per element and 2-4
// bytes read per x element, about 100-500 operations per byte: below the
// ~590 where the int8 tensor cores take over from 3.35 TB/s, so device-memory
// bytes bound the large-M shapes, chiefly the f32 output and the x read.
//
// Design (two launches per product):
// 1. quantize_rows_kernel: one warp per row holds the row in registers (at
//    most 24 float4 per lane for K <= 3072), so x is read from device memory
//    once; it writes the row's scale and its int8 values, xq [M, K] (the
//    wrapper's scratch). 4 bytes of f32 x become 1 byte of xq: 6 bytes moved
//    per element against the 8 of reading x twice.
// 2. int8_gemm_kernel: persistent, one block per SM walking 128 x BN output
//    tiles, the N tiles of one 128-row stripe back to back so that the stripe
//    of xq stays in L2. Warpgroup 0 gives its registers up (setmaxnreg) and
//    one of its threads keeps TMA loads of xq [128, 128 B] and wq [BN, 128 B]
//    tiles in flight through a ring of 4 stages guarded by mbarriers;
//    warpgroups 1 and 2 take 64 rows each and run wgmma m64nBNk32 s8.s8.s32
//    with both operands K-major from the 128-byte-swizzled tiles. The
//    epilogue dequantises in f32 into a 128-byte-swizzled staging tile per
//    warpgroup and writes it with TMA stores of whole 128-byte rows, which
//    drain while the warpgroup runs the next tile (the producer already
//    loads it). TMA zero-fills rows past M or N and K past its end on load
//    and writes only rows below M and columns below N on store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// ---- quantise pass ----

constexpr int Q_WARPS = 8;  // rows per block, one warp each
constexpr int MAX_K = 3072;

// Four consecutive x values of a row, as f32.
template <bool X_BF16>
__device__ __forceinline__ float4 load4(const void* x, long long off) {
  if (X_BF16) {
    const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(x) + off);
    return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                       __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
  }
  return *reinterpret_cast<const float4*>(static_cast<const float*>(x) + off);
}

__device__ __forceinline__ uint32_t quantize(float v, float sx) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, sx)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(r)));
}

// Lane l holds columns 128 i + 4 l .. +3 of its warp's row, i < CHUNKS.
template <bool X_BF16, int CHUNKS>
__global__ void __launch_bounds__(Q_WARPS * 32) quantize_rows_kernel(
    const void* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx, int M, int K) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * Q_WARPS + threadIdx.x / 32;
  if (row >= M) return;
  const long long base = row * K;
  float4 v[CHUNKS];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = i * 128 + lane * 4;
    v[i] = c < K ? load4<X_BF16>(x, base + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[i].x), fabsf(v[i].y)),
                             fmaxf(fabsf(v[i].z), fabsf(v[i].w))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = fmaxf(amax, 1e-30f) * (1.f / 127.f);
  if (lane == 0) sx[row] = s;
  uint32_t* dst = reinterpret_cast<uint32_t*>(xq + base);
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = i * 128 + lane * 4;
    if (c < K) {
      dst[c / 4] = quantize(v[i].x, s) | (quantize(v[i].y, s) << 8) |
                   (quantize(v[i].z, s) << 16) | (quantize(v[i].w, s) << 24);
    }
  }
}

template <bool X_BF16>
int launch_quantize(const void* x, void* xq, void* sx, int M, int K, cudaStream_t st) {
  const int chunks = (K + 127) / 128;
  const unsigned blocks = static_cast<unsigned>((M + Q_WARPS - 1) / Q_WARPS);
  auto* q = static_cast<int8_t*>(xq);
  auto* s = static_cast<float*>(sx);
  if (chunks <= 4) {
    quantize_rows_kernel<X_BF16, 4><<<blocks, Q_WARPS * 32, 0, st>>>(x, q, s, M, K);
  } else if (chunks <= 8) {
    quantize_rows_kernel<X_BF16, 8><<<blocks, Q_WARPS * 32, 0, st>>>(x, q, s, M, K);
  } else if (chunks <= 12) {
    quantize_rows_kernel<X_BF16, 12><<<blocks, Q_WARPS * 32, 0, st>>>(x, q, s, M, K);
  } else if (chunks <= 16) {
    quantize_rows_kernel<X_BF16, 16><<<blocks, Q_WARPS * 32, 0, st>>>(x, q, s, M, K);
  } else {
    quantize_rows_kernel<X_BF16, 24><<<blocks, Q_WARPS * 32, 0, st>>>(x, q, s, M, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- GEMM ----

constexpr int BM = 128;      // output rows per tile: two consumer warpgroups of 64
constexpr int BK = 128;      // K bytes per stage: one 128-byte swizzled row per tile row
constexpr int STAGES = 4;    // depth of the TMA ring
constexpr int THREADS = 384; // warpgroup 0 loads, warpgroups 1 and 2 compute

// Per consumer warpgroup, its 64 x BN f32 output tile staged for the TMA
// store: BN / 32 boxes of 64 rows of 128 bytes, 128-byte swizzled.
template <int BN>
__host__ __device__ constexpr int out_stage_bytes() {
  return 64 * BN * 4;
}

template <int BN>
constexpr size_t gemm_smem_bytes() {
  return 1024 + static_cast<size_t>(STAGES) * (BM + BN) * BK + 2 * out_stage_bytes<BN>() +
         2 * STAGES * sizeof(uint64_t);
}

// acc[64 x BN] = A[64 x 32] . B[BN x 32]^T (+ acc when accumulate), int8 in,
// int32 out; both operands K-major in shared memory.
template <int BN>
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[BN / 2], uint64_t da, uint64_t db,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<128>(int32_t (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int32_t (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1) int8_gemm_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_out, const float* __restrict__ sx,
    const float* __restrict__ ws, int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_s = sm90::align1024(smem_raw);   // [STAGES][BM rows of 128 B]
  uint8_t* b_s = a_s + STAGES * BM * BK;      // [STAGES][BN rows of 128 B]
  uint8_t* o_s = b_s + STAGES * BN * BK;      // [2 warpgroups][out_stage_bytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(o_s + 2 * out_stage_bytes<BN>());
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);   // the producer's expect_tx; TMA bytes complete it
      sm90::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * n_tiles;
  const int k_steps = (K + BK - 1) / BK;

  if (wg == 0) {
    sm90::setmaxnreg_dec<40>();
    if (warp == 0 && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
        for (int ks = 0; ks < k_steps; ++ks) {
          sm90::mbar_wait(&empty[stage], phase ^ 1);
          sm90::mbar_expect_tx(&full[stage], (BM + BN) * BK);
          sm90::tma_load_2d(a_s + stage * BM * BK, &map_a, &full[stage], ks * BK, m0);
          sm90::tma_load_2d(b_s + stage * BN * BK, &map_b, &full[stage], ks * BK, n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    const int half = wg - 1;  // this warpgroup's 64 rows of the tile
    const int g = lane / 4, t = lane % 4;
    int stage = 0;
    uint32_t phase = 0;
    int32_t acc[BN / 2];  // each tile's first k-step overwrites it
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
      for (int ks = 0; ks < k_steps; ++ks) {
        sm90::mbar_wait(&full[stage], phase);
        const uint64_t da = sm90::desc_sw128(a_s + stage * BM * BK + half * 64 * BK);
        const uint64_t db = sm90::desc_sw128(b_s + stage * BN * BK);
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 32; ++k) {  // k32 steps: +32 bytes along the swizzled rows
          wgmma_s8<BN>(acc, da + 2 * k, db + 2 * k, ks > 0 || k > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      // acc[4j + e]: row 16 warp + g (+8 for e >= 2), column 8j + 2t + (e & 1).
      // Dequantised into this warpgroup's staging tile, where column c of row
      // r lies in box c / 32 at 16-byte chunk (c % 32 / 4) ^ (r % 8); the TMA
      // store writes only the rows below M and columns below N.
      uint8_t* stage_out = o_s + half * out_stage_bytes<BN>();
      const int r0 = m0 + half * 64 + warp * 16 + g;
      const float s0 = r0 < M ? sx[r0] : 0.f, s1 = r0 + 8 < M ? sx[r0 + 8] : 0.f;
      if (threadIdx.x % 128 == 0) sm90::bulk_wait_read<0>();  // the last tile's store has read it
      sm90::named_sync(3 + half, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        const float w0 = col < N ? ws[col] : 0.f, w1 = col < N ? ws[col + 1] : 0.f;
        const int c = 8 * j + 2 * t, box = c / 32, chunk = c % 32 / 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + g + 8 * h;
          const float sr = h ? s1 : s0;
          float2* dst = reinterpret_cast<float2*>(stage_out + box * 64 * 128 + r * 128 +
                                                  ((chunk ^ (r % 8)) * 16) + (c % 4) * 4);
          *dst = make_float2((__int2float_rn(acc[4 * j + 2 * h]) * sr) * w0,
                             (__int2float_rn(acc[4 * j + 2 * h + 1]) * sr) * w1);
        }
      }
      sm90::fence_proxy_async();  // the generic-proxy stores, visible to TMA
      sm90::named_sync(3 + half, 128);
      if (threadIdx.x % 128 == 0) {
#pragma unroll
        for (int box = 0; box < BN / 32; ++box) {
          sm90::tma_store_2d(&map_out, stage_out + box * 64 * 128, n0 + 32 * box, m0 + half * 64);
        }
        sm90::bulk_commit();
      }
    }
    if (threadIdx.x % 128 == 0) sm90::bulk_wait<0>();  // the stores are done before the block exits
  }
}

template <int BN>
int launch_gemm(const void* xq, const void* sx, const void* wq, const void* ws, void* out, int M,
                int K, int N, int grid, cudaStream_t st) {
  CUtensorMap map_a, map_b, map_out;
  const cuuint64_t dims_a[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t dims_b[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N)};
  const cuuint64_t row_bytes[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box_a[2] = {BK, BM}, box_b[2] = {BK, BN};
  int err = sm90::encode_sw128(&map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq, dims_a, row_bytes,
                               box_a);
  if (err) return err;
  err = sm90::encode_sw128(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wq, dims_b, row_bytes, box_b);
  if (err) return err;
  const cuuint64_t dims_out[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(M)};
  const cuuint64_t out_row_bytes[1] = {static_cast<cuuint64_t>(N) * 4};
  const cuuint32_t box_out[2] = {32, 64};  // 128 bytes of f32 by a warpgroup's 64 rows
  err = sm90::encode_sw128(&map_out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, out, dims_out,
                           out_row_bytes, box_out);
  if (err) return err;
  auto kernel = int8_gemm_kernel<BN>;
  constexpr size_t smem = gemm_smem_bytes<BN>();
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, THREADS, smem, st>>>(map_a, map_b, map_out, static_cast<const float*>(sx),
                                      static_cast<const float*>(ws), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points return a cudaError_t: the launch's own error, or
// cudaErrorInvalidValue for arguments the kernels do not take (K a multiple
// of 16 up to 3072, N a multiple of 8, BN 64 or 128, 1 <= grid <= tiles).

// x f32 (x_bf16 = 0) or bf16 [M, K] -> xq int8 [M, K], sx f32 [M].
extern "C" int tdspa_quantize_rows(const void* x, void* xq, void* sx, int x_bf16, int M, int K,
                                   void* stream) {
  if (M < 1 || K < 16 || K > MAX_K || K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_quantize<true>(x, xq, sx, M, K, st)
                : launch_quantize<false>(x, xq, sx, M, K, st);
}

// xq int8 [M, K], sx f32 [M], wq int8 [N, K], ws f32 [N] -> out f32 [M, N];
// `grid` persistent blocks over the ceil(M/128) * ceil(N/bn) tiles.
extern "C" int tdspa_int8_gemm(const void* xq, const void* sx, const void* wq, const void* ws,
                               void* out, int M, int K, int N, int bn, int grid, void* stream) {
  const long long tiles =
      static_cast<long long>((M + BM - 1) / BM) * ((N + bn - 1) / (bn > 0 ? bn : 1));
  if (M < 1 || K < 16 || K > MAX_K || K % 16 != 0 || N < 8 || N % 8 != 0 ||
      (bn != 64 && bn != 128) || grid < 1 || grid > tiles || tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  return bn == 128 ? launch_gemm<128>(xq, sx, wq, ws, out, M, K, N, grid, st)
                   : launch_gemm<64>(xq, sx, wq, ws, out, M, K, N, grid, st);
}
