// Dynamic-int8 matrix product for Hopper (sm_90a).
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
// Layout: one block of 8 warps per 64-row M tile and per share of the N
// tiles (grid.y splits the N tiles when M has few tiles). The block first
// reads its 64 rows twice, once for each row's amax and once to quantise
// it into an int8 slab [64, K] in shared memory, so x is read from device
// memory once per split and quantised once. Then, for each 128-column N
// tile, 64-byte-deep weight tiles stream in through cp.async (double
// buffered) and each warp computes a 32 x 32 piece with mma.sync
// m16n8k32 s8.s8.s32, the slab as the A operand and the [N, K] weight rows
// as the column-major B operand. The epilogue dequantises in f32.
//
// What bounds it on an H100: the 3DSPA shapes do 2 K operations per f32
// output element (K = 384..2048) against 4 bytes written per element and
// 2-4 bytes read per x element, about 100-500 int8 operations per byte:
// below the ~590 operations per byte where the int8 tensor cores take over
// from 3.35 TB/s, so device-memory bytes bound the large-M shapes, chiefly
// the f32 output. The design reads x once and keeps the quantised
// activations out of device memory. Not done yet: wgmma, TMA, a persistent
// grid, and more than one block per SM at K >= 1536 (the slab takes 99 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // x rows per block
constexpr int BN = 128;       // output columns per N tile
constexpr int BK = 64;        // weight bytes (K values) per pipeline stage
constexpr int THREADS = 256;  // 8 warps: 2 along M x 4 along N, 32 x 32 each
constexpr int W_LD = BK + 16;  // bytes per staged weight row (bank spread)
constexpr int W_STAGE = BN * W_LD;

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D[16x8] += A[16x32] . B[32x8], int8 inputs, int32 accumulate.
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros (past N or K).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

template <bool X_BF16>
__global__ void __launch_bounds__(THREADS) quant_matmul_kernel(
    const void* __restrict__ x, const int8_t* __restrict__ wq, const float* __restrict__ ws,
    float* __restrict__ out, int M, int K, int N, int kp, int tiles_per_split) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ float sx_s[BM];
  const int slab_ld = kp + 16;  // bytes per slab row: kp is a multiple of BK
  int8_t* xq_s = smem;
  int8_t* w_s = smem + BM * slab_ld;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM;

  // Phase 1: each warp takes 8 rows: the row's amax, then its int8 values
  // (columns K..kp-1, and rows past M, are zero).
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = m0 + r;
    uint32_t* dst = reinterpret_cast<uint32_t*>(xq_s + r * slab_ld);
    if (row >= M) {
      for (int c = lane * 4; c < kp; c += 128) dst[c / 4] = 0u;
      continue;
    }
    const long long base = static_cast<long long>(row) * K;
    float amax = 0.f;
    for (int c = lane * 4; c < K; c += 128) {
      const float4 v = load4<X_BF16>(x, base + c);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float sx = fmaxf(amax, 1e-30f) * (1.f / 127.f);
    if (lane == 0) sx_s[r] = sx;
    for (int c = lane * 4; c < kp; c += 128) {
      uint32_t packed = 0u;
      if (c < K) {
        const float4 v = load4<X_BF16>(x, base + c);
        packed = quantize(v.x, sx) | (quantize(v.y, sx) << 8) | (quantize(v.z, sx) << 16) |
                 (quantize(v.w, sx) << 24);
      }
      dst[c / 4] = packed;
    }
  }
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;  // mma group id / thread in group
  const int wm = warp / 4, wn = warp % 4;
  const int n_tiles = (N + BN - 1) / BN;
  const int tile_end = min(n_tiles, (blockIdx.y + 1) * tiles_per_split);
  const int k_steps = kp / BK;

  for (int tile = blockIdx.y * tiles_per_split; tile < tile_end; ++tile) {
    const int n0 = tile * BN;
    auto load_w = [&](int stage, int k0) {
      int8_t* dst = w_s + stage * W_STAGE;
      for (int i = threadIdx.x; i < BN * (BK / 16); i += THREADS) {
        const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
        const int n = n0 + r, k = k0 + c;
        const bool ok = n < N && k < K;
        cp_async16(dst + r * W_LD + c, ok ? wq + static_cast<long long>(n) * K + k : wq,
                   ok ? 16 : 0);
      }
      cp_async_commit();
    };

    int acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;

    load_w(0, 0);
    for (int ks = 0; ks < k_steps; ++ks) {
      if (ks + 1 < k_steps) {
        load_w((ks + 1) & 1, (ks + 1) * BK);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int8_t* wt = w_s + (ks & 1) * W_STAGE;
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        const int kc = ks * BK + kk * 32;
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int8_t* ar = xq_s + (wm * 32 + mi * 16 + g) * slab_ld + kc + 4 * t;
          a[mi][0] = ld32(ar);
          a[mi][1] = ld32(ar + 8 * slab_ld);
          a[mi][2] = ld32(ar + 16);
          a[mi][3] = ld32(ar + 8 * slab_ld + 16);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int8_t* br = wt + (wn * 32 + ni * 8 + g) * W_LD + kk * 32 + 4 * t;
          const uint32_t b[2] = {ld32(br), ld32(br + 16)};
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], a[mi], b);
        }
      }
      __syncthreads();  // this stage is read before the next load overwrites it
    }

#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * t;
        if (col >= N) continue;
        const float w0 = ws[col], w1 = ws[col + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + mi * 16 + g + 8 * h;
          if (m0 + r >= M) continue;
          const float sx = sx_s[r];
          const float o0 = (__int2float_rn(acc[mi][ni][2 * h]) * sx) * w0;
          const float o1 = (__int2float_rn(acc[mi][ni][2 * h + 1]) * sx) * w1;
          *reinterpret_cast<float2*>(out + static_cast<long long>(m0 + r) * N + col) =
              make_float2(o0, o1);
        }
      }
    }
  }
}

template <bool X_BF16>
int launch(const void* x, const void* wq, const void* ws, void* out, int M, int K, int N,
           int splits, int tiles_per_split, cudaStream_t stream) {
  const int kp = (K + BK - 1) / BK * BK;
  const size_t smem = static_cast<size_t>(BM) * (kp + 16) + 2 * W_STAGE;
  auto kernel = quant_matmul_kernel<X_BF16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + BM - 1) / BM, splits);
  kernel<<<grid, THREADS, smem, stream>>>(x, static_cast<const int8_t*>(wq),
                                          static_cast<const float*>(ws), static_cast<float*>(out),
                                          M, K, N, kp, tiles_per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t: the launch's own error, or cudaErrorInvalidValue
// for arguments the kernel does not take (K a multiple of 16 up to 3072, N a
// multiple of 8, splits * tiles_per_split covering the N tiles).
extern "C" int tdspa_quant_matmul(const void* x, const void* wq, const void* ws, void* out,
                                  int x_bf16, int M, int K, int N, int splits,
                                  int tiles_per_split, void* stream) {
  const int n_tiles = (N + BN - 1) / BN;
  if (M < 1 || K < 16 || K > 3072 || K % 16 != 0 || N < 8 || N % 8 != 0 || splits < 1 ||
      splits > 65535 || tiles_per_split < 1 ||
      static_cast<long long>(splits) * tiles_per_split < n_tiles ||
      (M + BM - 1) / BM > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<true>(x, wq, ws, out, M, K, N, splits, tiles_per_split, st)
                : launch<false>(x, wq, ws, out, M, K, N, splits, tiles_per_split, st);
}
