// Bilinear sampling of per-frame grids at track positions, for Hopper (sm_90a).
//
// Replaces tdspa/kernels/bilinear.py `bilinear_sample_pallas` (body
// `_bilinear_frame_kernel`): for each frame t and point n at (x, y),
//
//   x0 = floor(x), wx = x - x0 (y likewise), corners clamped one by one,
//   out[n,t,:] = g00 (1-wx)(1-wy) + g01 wx (1-wy) + g10 (1-wx) wy + g11 wx wy
//
// grid f32 or bf16 [T, H, W, C], coords f32 [N, T, 2] -> out f32 or bf16
// [N, T, C]. The weights come from the unclamped floor, so points outside
// the grid take edge values with out-of-range weights (the reference rule).
// Products and sums are f32 in exactly the order above, left to right, and
// the source is built with --fmad=false, so the result equals the plain
// gather of tdspa_torch/ops/geometry.py bit for bit.
//
// Layout: one block per (frame, tile of points). The tile's coordinates are
// read once: its first threads compute each point's four corner offsets and
// two weights into shared memory. Then the threads walk (point, channel
// vector) pairs, consecutive threads on consecutive channel vectors of a
// point, with 16-byte corner loads (4 f32 or 8 bf16 channels) where C
// and the grid's alignment allow.
//
// What bounds it on an H100: about 11 f32 operations per output element
// against 4 bytes written per element and up to 4 corner reads: device-
// memory bytes. A DINO frame (36 x 36 x 768 f32, 4 MB) does not fit shared
// memory, but the frames a wave of blocks works on stay in the 50 MB L2, so
// a corner row is read from device memory about once and the output is
// written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_POINTS = 1024;  // points per block (C = 1: four per thread)

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<uint16_t>(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

__device__ __forceinline__ uint16_t to_bf16(float v) {
  __nv_bfloat16 b = __float2bfloat16_rn(v);
  return *reinterpret_cast<uint16_t*>(&b);
}

// VEC values to device memory: 16-byte stores where they fill whole ones.
template <typename U, int VEC>
__device__ __forceinline__ void store(U* dst, const U (&v)[VEC]) {
  if constexpr (VEC * sizeof(U) % 16 == 0) {
#pragma unroll
    for (int i = 0; i < VEC * static_cast<int>(sizeof(U)) / 16; ++i) {
      uint4 chunk;
      memcpy(&chunk, reinterpret_cast<const char*>(v) + 16 * i, 16);
      reinterpret_cast<uint4*>(dst)[i] = chunk;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[e] = v[e];
  }
}

// VEC channels per item; T is float or uint16_t (bf16 bits).
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) bilinear_kernel(
    const T* __restrict__ grid, const float* __restrict__ coords, void* __restrict__ out,
    int out_bf16, int frames, int H, int W, int C, int N, int points) {
  __shared__ int off_s[4][MAX_POINTS];  // corner offsets within the frame (elements)
  __shared__ float wx_s[MAX_POINTS], wy_s[MAX_POINTS];
  const int t = blockIdx.y;
  const int p0 = blockIdx.x * points;
  const int count = min(points, N - p0);

  for (int i = threadIdx.x; i < count; i += THREADS) {
    const long long n = p0 + i;
    const float x = coords[(n * frames + t) * 2];
    const float y = coords[(n * frames + t) * 2 + 1];
    const float x0f = floorf(x), y0f = floorf(y);
    wx_s[i] = x - x0f;
    wy_s[i] = y - y0f;
    // Clamping the floor to [-1, W] first keeps the int conversion in range
    // and leaves both clamped corners unchanged.
    const int xi = static_cast<int>(fminf(fmaxf(x0f, -1.f), static_cast<float>(W)));
    const int yi = static_cast<int>(fminf(fmaxf(y0f, -1.f), static_cast<float>(H)));
    const int x0 = min(max(xi, 0), W - 1), x1 = min(max(xi + 1, 0), W - 1);
    const int y0 = min(max(yi, 0), H - 1), y1 = min(max(yi + 1, 0), H - 1);
    off_s[0][i] = (y0 * W + x0) * C;
    off_s[1][i] = (y0 * W + x1) * C;
    off_s[2][i] = (y1 * W + x0) * C;
    off_s[3][i] = (y1 * W + x1) * C;
  }
  __syncthreads();

  const T* frame = grid + static_cast<long long>(t) * H * W * C;
  const int vecs = C / VEC;
  for (int i = threadIdx.x; i < count * vecs; i += THREADS) {
    const int p = i / vecs, c = (i % vecs) * VEC;
    const float wx = wx_s[p], wy = wy_s[p];
    const float ux = 1.f - wx, uy = 1.f - wy;
    T g[4][VEC];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const T* src = frame + off_s[j][p] + c;
      if constexpr (VEC * sizeof(T) == 16) {
        const uint4 chunk = *reinterpret_cast<const uint4*>(src);
        memcpy(g[j], &chunk, 16);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) g[j][e] = src[e];
      }
    }
    float r[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      // ((g00*ux)*uy + (g01*wx)*uy) + (g10*ux)*wy + (g11*wx)*wy, each op rounded.
      float s = to_f32(g[0][e]) * ux * uy;
      s = s + to_f32(g[1][e]) * wx * uy;
      s = s + to_f32(g[2][e]) * ux * wy;
      r[e] = s + to_f32(g[3][e]) * wx * wy;
    }
    const long long o = ((static_cast<long long>(p0 + p) * frames + t) * C) + c;
    if (out_bf16) {
      uint16_t h[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) h[e] = to_bf16(r[e]);
      store(static_cast<uint16_t*>(out) + o, h);
    } else {
      store(static_cast<float*>(out) + o, r);
    }
  }
}

template <typename T, int VEC>
int launch(const void* grid, const float* coords, void* out, int out_bf16, int frames, int H,
           int W, int C, int N, cudaStream_t st) {
  const int vecs = C / VEC;
  const int points = max(1, min(MAX_POINTS, 2048 / vecs));  // about 8 items per thread
  const dim3 blocks((N + points - 1) / points, frames);
  bilinear_kernel<T, VEC><<<blocks, THREADS, 0, st>>>(static_cast<const T*>(grid), coords, out,
                                                       out_bf16, frames, H, W, C, N, points);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t: the launch's own error, or cudaErrorInvalidValue for
// shapes the kernel does not take (a frame of at most 2^31 elements, at most
// 65535 frames).
extern "C" int tdspa_bilinear_sample(const void* grid, const void* coords, void* out,
                                     int grid_bf16, int out_bf16, int T, int H, int W, int C,
                                     int N, void* stream) {
  if (T < 1 || T > 65535 || H < 1 || W < 1 || C < 1 || N < 1 ||
      static_cast<long long>(H) * W * C > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xy = static_cast<const float*>(coords);
  // 16-byte vectors when every corner row starts on a 16-byte boundary.
  const bool aligned = reinterpret_cast<uintptr_t>(grid) % 16 == 0;
  if (grid_bf16) {
    return aligned && C % 8 == 0 ? launch<uint16_t, 8>(grid, xy, out, out_bf16, T, H, W, C, N, st)
                      : launch<uint16_t, 1>(grid, xy, out, out_bf16, T, H, W, C, N, st);
  }
  return aligned && C % 4 == 0 ? launch<float, 4>(grid, xy, out, out_bf16, T, H, W, C, N, st)
                    : launch<float, 1>(grid, xy, out, out_bf16, T, H, W, C, N, st);
}
