// Row norms of the transformer stacks, for Hopper (sm_90a): the bias-free,
// centered LayerNorm and the per-head RMSNorm of core/attention.py `_Norm`,
// forward and backward.
//
// Replaces no TPU kernel: on the TPU, XLA fuses flax's LayerNorm and RMSNorm
// into their neighbours. Eager PyTorch runs each norm as about ten passes
// over the tensor (x*x, two means, x - mean, rsqrt * scale, the product and
// the casts): 40 bytes of device memory per element of the normed tensor,
// and more again through autograd. Here the forward reads each row once and
// writes it once; the backward reads x and dy once and writes dx once.
//
// Forward, a row of width W (x f32 or bf16, statistics in f32):
//   mean2 = sum(x^2) / W
//   centered: mean = sum(x) / W, var = max(mean2 - mean^2, 0), y = x - mean
//   RMS:      var = mean2, y = x
//   out = y * (rsqrt(var + 1e-6) * scale), rounded once to f32 or bf16
// (flax's fast variance, as the JAX reference takes it; csrc/block.cu's
// LayerNorm takes the two-pass variance of the TPU block kernel instead.)
//
// Backward, with r = rsqrt(var + 1e-6) and g = dy * scale:
//   centered: dx = r (g - mean(g) - y r^2 mean(g y)); where the clamp held
//             var at 0 the last term is dropped, as autograd of max(., 0) does
//   RMS:      dx = r (g - x r^2 mean(g x))
//   dscale = sum over rows of (dy y) r: each block writes its rows' sums as
//            f32 partials, then sum_partials_kernel adds them in a fixed
//            order. No atomics, so the result is the same on every run.
// dy is the sum of 1 to 4 cotangents, one from each projection that reads
// the forward's output (a block's shared query norm has 3, or 4 with the
// cross-attention's query): the kernel adds them in f32 registers in the
// order given, so no f32 cotangent is written to memory.
//
// Layout: `lanes` consecutive lanes of a warp hold one row (32 / lanes rows a
// warp), each lane NV vectors of VEC elements in registers: VEC = 4 f32 or 8
// bf16 values, one 16-byte load (W a multiple of VEC, operands 16-byte
// aligned: kernels/norm.py copies an operand that is not); a warp holds rows
// of up to 1536 values. A lane group sums with xor shuffles
// inside itself, and takes RPG rows at once (two where a lane holds at most
// 16 values of a row) to keep several loads in flight. `lanes` and NV follow the
// width (kernels/norm.py::plan): the heads' 64- and 96-wide bf16 rows take 8
// and 4 lanes (4 and 8 rows a warp), the stacks' rows of 256 to 1280 f32
// values a whole warp. The backward of f32 x with bf16 cotangents takes
// vectors of 8 values (two 16-byte words of x, one of each cotangent) where W
// is a multiple of 8 (kernels/norm.py::backward_plan): with 4, each cotangent
// moved in 8-byte words, and 3 of them read 57 % of the byte bound on an H100
// at widths 384 and 1280 (in 16-byte words 90 and 72 %). The backward runs the
// grid the caller gives (one block a row of its dscale partials), each block
// walking tiles of rows.
//
// What bounds it on an H100: device-memory bytes, at a few f32 operations per
// byte. Forward W x (in + out) bytes a row: 6 an element f32 -> bf16, 4
// bf16 -> bf16, 8 f32 -> f32; backward x, each cotangent and dx (14 an
// element for f32 x and three bf16 cotangents).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_VALUES = 1536;  // of a row held by one warp's registers
constexpr int MAX_COTANGENTS = 4;  // the backward's dy operands, summed
constexpr float EPS = 1e-6f;
constexpr unsigned FULL = 0xffffffffu;

// Vectors a lane holds at most: MAX_VALUES over a warp.
__host__ __device__ constexpr int max_nv(int vec) { return MAX_VALUES / (32 * vec); }

// Rows a lane group takes at once: two where a lane holds at most 16 values
// of a row. (Four rows of the 64-wide heads ran slower than two on an H100:
// fewer blocks resident for their registers.)
__host__ __device__ constexpr int rows_per_group(int nv, int vec) { return nv * vec <= 16 ? 2 : 1; }

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<uint16_t>(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ uint16_t from_f32<uint16_t>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// N consecutive values of type T (float, or uint16_t for bf16 bits) as f32,
// moved in 16-byte words, or in 8-byte ones where a vector of an f32 row
// meets bf16 (its output, or its cotangent in the backward: 4 values).
template <typename T, int N>
__device__ __forceinline__ void load(const T* p, float (&v)[N]) {
  constexpr int BYTES = N * static_cast<int>(sizeof(T));
  constexpr int WORD = BYTES % 16 == 0 ? 16 : 8;
  static_assert(BYTES % WORD == 0, "whole 16- or 8-byte words");
  T raw[N];
#pragma unroll
  for (int i = 0; i < BYTES / WORD; ++i) {
    if constexpr (WORD == 16) {
      const uint4 w = reinterpret_cast<const uint4*>(p)[i];
      memcpy(reinterpret_cast<char*>(raw) + 16 * i, &w, 16);
    } else {
      const uint2 w = reinterpret_cast<const uint2*>(p)[i];
      memcpy(reinterpret_cast<char*>(raw) + 8 * i, &w, 8);
    }
  }
#pragma unroll
  for (int e = 0; e < N; ++e) v[e] = to_f32(raw[e]);
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const float (&v)[N]) {
  constexpr int BYTES = N * static_cast<int>(sizeof(T));
  constexpr int WORD = BYTES % 16 == 0 ? 16 : 8;
  static_assert(BYTES % WORD == 0, "whole 16- or 8-byte words");
  T raw[N];
#pragma unroll
  for (int e = 0; e < N; ++e) raw[e] = from_f32<T>(v[e]);
#pragma unroll
  for (int i = 0; i < BYTES / WORD; ++i) {
    if constexpr (WORD == 16) {
      uint4 w;
      memcpy(&w, reinterpret_cast<const char*>(raw) + 16 * i, 16);
      reinterpret_cast<uint4*>(p)[i] = w;
    } else {
      uint2 w;
      memcpy(&w, reinterpret_cast<const char*>(raw) + 8 * i, 8);
      reinterpret_cast<uint2*>(p)[i] = w;
    }
  }
}

// The sum over this lane's group: `lanes` consecutive lanes, an aligned block.
// Every lane of the warp calls it.
__device__ __forceinline__ float group_sum(float s, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  return s;
}

struct Stats {
  float mean;  // 0 for RMS
  float r;     // rsqrt(var + eps)
  bool keep;   // the variance's gradient passes the clamp (mean2 - mean^2 >= 0)
};

__device__ __forceinline__ Stats row_stats(float s1, float s2, int width, int centered) {
  const float mean2 = s2 / static_cast<float>(width);
  if (!centered) return {0.f, rsqrtf(mean2 + EPS), true};
  const float mean = s1 / static_cast<float>(width);
  const float d = mean2 - mean * mean;
  return {mean, rsqrtf(fmaxf(d, 0.f) + EPS), d >= 0.f};
}

// The statistics of RPG rows whose values this lane holds in v.
template <int RPG, int NV, int VEC>
__device__ __forceinline__ void all_stats(const float (&v)[RPG][NV][VEC], int width, int centered,
                                          int lanes, Stats (&st)[RPG]) {
#pragma unroll
  for (int rr = 0; rr < RPG; ++rr) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        s1 += v[rr][i][e];
        s2 += v[rr][i][e] * v[rr][i][e];
      }
    }
    st[rr] = row_stats(group_sum(s1, lanes), group_sum(s2, lanes), width, centered);
  }
}

// RPG rows of x (dead rows and vectors as zeros): row `first + rr * stride`,
// vector i * lanes + sub.
template <typename T, int RPG, int NV, int VEC>
__device__ __forceinline__ void load_rows(const T* x, long long first, int stride, int sub,
                                          int lanes, int rows, int width,
                                          float (&v)[RPG][NV][VEC]) {
  const int vectors = width / VEC;
#pragma unroll
  for (int rr = 0; rr < RPG; ++rr) {
    const long long row = first + static_cast<long long>(rr) * stride;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = i * lanes + sub;
      if (row < rows && vi < vectors) {
        load(x + row * width + vi * VEC, v[rr][i]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[rr][i][e] = 0.f;
      }
    }
  }
}

// The backward's cotangents: p[0..K) of one dtype, summed in this order.
struct Cotangents {
  const void* p[MAX_COTANGENTS];
};

// The f32 sum of K cotangents' rows, loaded as load_rows loads x.
template <typename D, int K, int RPG, int NV, int VEC>
__device__ __forceinline__ void load_sum(const Cotangents& dy, long long first, int stride,
                                         int sub, int lanes, int rows, int width,
                                         float (&g)[RPG][NV][VEC]) {
  load_rows<D, RPG, NV, VEC>(static_cast<const D*>(dy.p[0]), first, stride, sub, lanes, rows,
                             width, g);
#pragma unroll
  for (int j = 1; j < K; ++j) {
    float t[RPG][NV][VEC];
    load_rows<D, RPG, NV, VEC>(static_cast<const D*>(dy.p[j]), first, stride, sub, lanes, rows,
                               width, t);
#pragma unroll
    for (int rr = 0; rr < RPG; ++rr) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) g[rr][i][e] += t[rr][i][e];
      }
    }
  }
}

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(THREADS) row_norm_kernel(
    const T* __restrict__ x, const float* __restrict__ scale, void* __restrict__ out,
    int out_bf16, int centered, int rows, int width, int lanes) {
  constexpr int RPG = rows_per_group(NV, VEC);
  const int lane = threadIdx.x % 32, sub = lane % lanes, groups = 32 / lanes;
  const long long first =
      (static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32) * groups * RPG + lane / lanes;
  float v[RPG][NV][VEC];
  load_rows<T, RPG, NV, VEC>(x, first, groups, sub, lanes, rows, width, v);
  Stats st[RPG];
  all_stats<RPG, NV, VEC>(v, width, centered, lanes, st);
  const int vectors = width / VEC;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = i * lanes + sub;
    if (vi >= vectors) continue;
    float sc[VEC];
    load(scale + vi * VEC, sc);
#pragma unroll
    for (int rr = 0; rr < RPG; ++rr) {
      const long long row = first + static_cast<long long>(rr) * groups;
      if (row >= rows) continue;
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = (v[rr][i][e] - st[rr].mean) * (st[rr].r * sc[e]);
      const long long off = row * width + vi * VEC;
      if (out_bf16) {
        store(static_cast<uint16_t*>(out) + off, o);
      } else {
        store(static_cast<float*>(out) + off, o);
      }
    }
  }
}

// dy: K cotangents, each f32 or bf16 (the forward's output dtype); dx takes
// x's dtype. The blocks walk the tiles of rows (a grid stride); each writes
// its dscale sums to partial[blockIdx.x, :W].
template <typename T, int VEC, int NV, int K>
__global__ void __launch_bounds__(THREADS) row_norm_backward_kernel(
    const T* __restrict__ x, const float* __restrict__ scale, Cotangents dy, int dy_bf16,
    T* __restrict__ dx, float* __restrict__ partial, int centered, int rows, int width,
    int lanes) {
  constexpr int RPG = rows_per_group(NV, VEC);
  __shared__ float block_sum[32 * NV * VEC];
  const int lane = threadIdx.x % 32, sub = lane % lanes, groups = 32 / lanes;
  const int warp = threadIdx.x / 32, vectors = width / VEC;
  const long long tile = static_cast<long long>(WARPS) * groups * RPG;
  const float inv_width = 1.f / static_cast<float>(width);
  float acc[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
  }
  for (long long base = blockIdx.x * tile; base < rows; base += gridDim.x * tile) {
    const long long first = base + static_cast<long long>(warp) * groups * RPG + lane / lanes;
    float xv[RPG][NV][VEC], gv[RPG][NV][VEC];
    load_rows<T, RPG, NV, VEC>(x, first, groups, sub, lanes, rows, width, xv);
    if (dy_bf16) {
      load_sum<uint16_t, K, RPG, NV, VEC>(dy, first, groups, sub, lanes, rows, width, gv);
    } else {
      load_sum<float, K, RPG, NV, VEC>(dy, first, groups, sub, lanes, rows, width, gv);
    }
    Stats st[RPG];
    all_stats<RPG, NV, VEC>(xv, width, centered, lanes, st);
    float sg[RPG], sgy[RPG];  // sum(g), sum(g y) of each row
#pragma unroll
    for (int rr = 0; rr < RPG; ++rr) sg[rr] = sgy[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = i * lanes + sub;
      if (vi >= vectors) continue;
      float sc[VEC];
      load(scale + vi * VEC, sc);
#pragma unroll
      for (int rr = 0; rr < RPG; ++rr) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float g = gv[rr][i][e] * sc[e];
          sg[rr] += g;
          sgy[rr] += g * (xv[rr][i][e] - st[rr].mean);
        }
      }
    }
    float mg[RPG], k[RPG];
#pragma unroll
    for (int rr = 0; rr < RPG; ++rr) {
      const float sum_g = group_sum(sg[rr], lanes), sum_gy = group_sum(sgy[rr], lanes);
      mg[rr] = centered ? sum_g * inv_width : 0.f;
      k[rr] = st[rr].keep ? st[rr].r * st[rr].r * (sum_gy * inv_width) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = i * lanes + sub;
      if (vi >= vectors) continue;
      float sc[VEC];
      load(scale + vi * VEC, sc);
#pragma unroll
      for (int rr = 0; rr < RPG; ++rr) {
        const long long row = first + static_cast<long long>(rr) * groups;
        if (row >= rows) continue;
        float d[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float y = xv[rr][i][e] - st[rr].mean;
          d[e] = st[rr].r * (gv[rr][i][e] * sc[e] - mg[rr] - y * k[rr]);
          acc[i][e] += gv[rr][i][e] * y * st[rr].r;
        }
        store(dx + row * width + vi * VEC, d);
      }
    }
  }
  // The lane groups of a warp hold the same columns: add them, then the
  // warps one after another, in a fixed order.
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      for (int o = lanes; o < 32; o <<= 1) acc[i][e] += __shfl_xor_sync(FULL, acc[i][e], o);
    }
  }
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w && lane < lanes) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int vi = i * lanes + lane;
        if (vi >= vectors) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float& s = block_sum[vi * VEC + e];
          s = (w == 0 ? 0.f : s) + acc[i][e];
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < width; c += THREADS) {
    partial[static_cast<long long>(blockIdx.x) * width + c] = block_sum[c];
  }
}

// dscale[c] = the sum of partial[:parts, c]: 32 columns a block, eight slices
// of the parts each, then the slices in order.
__global__ void __launch_bounds__(THREADS) sum_partials_kernel(
    const float* __restrict__ partial, float* __restrict__ dscale, int parts, int width) {
  __shared__ float slice_sum[WARPS][32];
  const int lane = threadIdx.x % 32, slice = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < width) {
    for (int p = slice; p < parts; p += WARPS) s += partial[static_cast<long long>(p) * width + c];
  }
  slice_sum[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && c < width) {
    float t = slice_sum[0][lane];
#pragma unroll
    for (int k = 1; k < WARPS; ++k) t += slice_sum[k][lane];
    dscale[c] = t;
  }
}

long long blocks_for(int rows, int lanes, int nv, int vec) {
  const long long tile = static_cast<long long>(WARPS) * (32 / lanes) * rows_per_group(nv, vec);
  return (rows + tile - 1) / tile;
}

template <typename T, int VEC, int NV>
int forward(const void* x, const float* scale, void* out, int out_bf16, int centered, int rows,
            int width, int lanes, cudaStream_t st) {
  row_norm_kernel<T, VEC, NV><<<blocks_for(rows, lanes, NV, VEC), THREADS, 0, st>>>(
      static_cast<const T*>(x), scale, out, out_bf16, centered, rows, width, lanes);
  return static_cast<int>(cudaGetLastError());
}

// The backward on a grid of `parts` blocks (the rows of the partials).
template <typename T, int VEC, int K, int NV>
int backward(const void* x, const float* scale, Cotangents dy, int dy_bf16, void* dx,
             float* partial, float* dscale, int centered, int rows, int width, int lanes,
             int parts, cudaStream_t st) {
  row_norm_backward_kernel<T, VEC, NV, K><<<parts, THREADS, 0, st>>>(
      static_cast<const T*>(x), scale, dy, dy_bf16, static_cast<T*>(dx), partial, centered,
      rows, width, lanes);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  sum_partials_kernel<<<(width + 31) / 32, THREADS, 0, st>>>(partial, dscale, parts, width);
  return static_cast<int>(cudaGetLastError());
}

// The launch with NV = nv, 1 to max_nv(VEC): kernels/norm.py::plan returns
// each of them for some width.
template <typename T, int VEC, int NV = 1, typename... A>
int forward_nv(int nv, A... args) {
  if constexpr (NV > max_nv(VEC)) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return nv == NV ? forward<T, VEC, NV>(args...) : forward_nv<T, VEC, NV + 1>(nv, args...);
  }
}

template <typename T, int VEC, int K, int NV = 1, typename... A>
int backward_nv(int nv, A... args) {
  if constexpr (NV > max_nv(VEC)) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return nv == NV ? backward<T, VEC, K, NV>(args...)
                    : backward_nv<T, VEC, K, NV + 1>(nv, args...);
  }
}

// The backward with K = k cotangents, 1 to MAX_COTANGENTS.
template <typename T, int VEC, int K = 1, typename... A>
int backward_k(int k, int nv, A... args) {
  if constexpr (K > MAX_COTANGENTS) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return k == K ? backward_nv<T, VEC, K>(nv, args...)
                  : backward_k<T, VEC, K + 1>(k, nv, args...);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The plan kernels/norm.py::plan gives for vectors of 8 values (vec8) or 4:
// W a multiple of the vector, `lanes` a power of two up to 32, lanes * nv
// vectors covering the row.
bool valid(bool vec8, int rows, int width, int lanes, int nv) {
  const int vec = vec8 ? 8 : 4;
  return rows >= 1 && width >= 1 && width % vec == 0 && lanes >= 1 && lanes <= 32 &&
         (lanes & (lanes - 1)) == 0 && nv >= 1 && nv <= max_nv(vec) &&
         static_cast<long long>(lanes) * nv * vec >= width &&
         blocks_for(rows, lanes, nv, vec) < (1LL << 31);
}

}  // namespace

// Each returns a cudaError_t: the launch's own error, or cudaErrorInvalidValue
// for a plan or operands the kernel does not take (operands not 16-byte
// aligned among them).
extern "C" int tdspa_row_norm_forward(const void* x, const void* scale, void* out, int x_bf16,
                                      int out_bf16, int centered, int rows, int width, int lanes,
                                      int nv, void* stream) {
  if (!valid(x_bf16, rows, width, lanes, nv) ||
      !(aligned16(x) && aligned16(scale) && aligned16(out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const float*>(scale);
  if (x_bf16) {
    return forward_nv<uint16_t, 8>(nv, x, s, out, out_bf16, centered, rows, width, lanes, st);
  }
  return forward_nv<float, 4>(nv, x, s, out, out_bf16, centered, rows, width, lanes, st);
}

// dy0..dy3: the cotangents, `cotangents` of them (1 to 4; the rest may be
// null), all of dy_bf16's dtype, summed in that order; partial: f32
// [parts, width] scratch, one row a block of the backward's grid; dscale:
// f32 [width].
extern "C" int tdspa_row_norm_backward(const void* x, const void* scale, const void* dy0,
                                       const void* dy1, const void* dy2, const void* dy3,
                                       void* dx, void* partial, void* dscale, int cotangents,
                                       int x_bf16, int dy_bf16, int centered, int rows,
                                       int width, int lanes, int nv, int parts, void* stream) {
  const Cotangents dy{{dy0, dy1, dy2, dy3}};
  const bool wide = !x_bf16 && dy_bf16 && width % 8 == 0;  // f32 x in 8-value vectors
  bool ok = valid(x_bf16 || wide, rows, width, lanes, nv) && parts >= 1 && cotangents >= 1 &&
            cotangents <= MAX_COTANGENTS && aligned16(x) && aligned16(scale) && aligned16(dx);
  for (int j = 0; ok && j < cotangents; ++j) ok = dy.p[j] != nullptr && aligned16(dy.p[j]);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const float*>(scale);
  auto* p = static_cast<float*>(partial);
  auto* ds = static_cast<float*>(dscale);
  if (x_bf16) {
    return backward_k<uint16_t, 8>(cotangents, nv, x, s, dy, dy_bf16, dx, p, ds, centered, rows,
                                   width, lanes, parts, st);
  }
  if (wide) {
    return backward_k<float, 8>(cotangents, nv, x, s, dy, dy_bf16, dx, p, ds, centered, rows,
                                width, lanes, parts, st);
  }
  return backward_k<float, 4>(cotangents, nv, x, s, dy, dy_bf16, dx, p, ds, centered, rows,
                              width, lanes, parts, st);
}
