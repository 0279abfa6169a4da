// The ViT block's memory-bound stages, for Hopper (sm_90a): the residual
// prologue and LayerNorm of a row, and the SwiGLU gate, of
// features/vit.py `_Block` and `Dinov2`'s final norm.
//
// Replaces no TPU kernel: on the TPU, XLA fuses these stages into their
// neighbours. Eager PyTorch runs a flax LayerNorm as about ten passes over the
// tensor, the output projection's bias add, the layer scale and the residual
// sum as three more, and the SwiGLU's bias add, SiLU and product as three
// over the FFN's widest tensor. Here each stage crosses device memory once,
// in the dtype its reader takes.
//
// vit_residual_norm_kernel, a row of width W, with X the residual stream's
// dtype (f32 or bf16) and H the projection's (f32 or bf16, no wider than X):
//   residual (optional): x' = x + round_X(hb * round_X(ls)),
//                        hb = round_H(h + round_H(b)),
//             h the output projection's GEMM without its bias b, ls the layer
//             scale; x' rounded to X and written
//   norm (optional):     mean = sum(x') / W, var = max(sum(x'^2) / W - mean^2, 0)
//             (flax's fast variance, in f32)
//             out = (x' - mean) * (rsqrt(var + eps) * scale) + nbias, rounded
//             once to f32 or bf16
// Built with --fmad=false, so every product and sum rounds on its own as the
// eager chain's do: x' is the eager chain's to the bit, and `out` differs
// from it only by the order in which the row's sums add up.
//
// swiglu_gate_kernel, over y = the FFN's first GEMM without its bias b,
// [rows, 2F] in T (f32 or bf16), halves y1 = y[:, :F], y2 = y[:, F:]:
//   g = round_T(round_T(silu(a)) * u), a = round_T(y1 + round_T(b1)),
//   u = round_T(y2 + round_T(b2)), silu(a) = a / (1 + exp(-a)) in f32
// as PyTorch computes F.silu(x1) * x2 on the biased halves, to the bit;
// [rows, F] in T.
//
// Layout of the row kernel: as csrc/norm.cu's (copied rather than shared, so
// that the stacks' kernel stays as it is): `lanes` consecutive lanes of a warp
// hold one row (32 / lanes rows a warp), each lane NV vectors of VEC = 8
// values in registers, moved as one 16-byte word (bf16) or two (f32); W a
// multiple of 8, rows of up to 1536 values; operands 16-byte aligned
// (kernels/vit_block.py copies one that is not). A lane group sums with xor
// shuffles inside itself, and takes RPG rows at once (two where a lane holds
// at most 16 values of a row). `lanes` and NV follow the width
// (kernels/vit_block.py::plan): ViT-S's 384 values take 16 lanes and 3
// vectors, ViT-B's 768, ViT-L's 1024 and ViT-g's 1536 a whole warp and 3, 4
// and 6 vectors.
//
// The row kernel keeps h in its 16-byte words until it adds it (bf16 packed
// two to a register); the residual prologue is a template parameter, so the
// norm-only launches hold registers for x alone.
//
// What bounds both on an H100: device-memory bytes. A giant row of the
// attention side's launch reads x (f32) and h (bf16) and writes x' (f32) and
// the norm (bf16): 12 bytes an element; the gate reads 4 bytes and writes 2
// an output element (bf16). At ViT-g's shapes (a launch of 37 to 105 us) each
// reads 73 to 81 % of the bound on an H100, at four times the rows 76 to 86 %:
// the rest is a launch's fixed cost.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_VALUES = 1536;  // of a row held by one warp's registers
constexpr int VEC = 8;            // values a lane moves at once
constexpr int MAX_NV = MAX_VALUES / (32 * VEC);
// The gate: 16-byte output words a thread, and blocks an SM its registers
// allow (on an H100 two words a thread at four blocks ran fastest: 0.105 ms
// at ViT-g's shape, against 0.109 with four words and 0.115 with one).
constexpr int GATE_ITEMS = 2;
constexpr int GATE_MIN_BLOCKS = 4;
constexpr unsigned FULL = 0xffffffffu;

// Rows a lane group takes at once: two where a lane holds at most 16 values
// of a row.
__host__ __device__ constexpr int rows_per_group(int nv) { return nv * VEC <= 16 ? 2 : 1; }

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

// v rounded to T (round to nearest even for bf16), as f32.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

// N consecutive values of type T (float, or uint16_t for bf16 bits) as f32,
// moved in 16-byte words, or 8-byte ones where N values take 8 bytes.
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

// RPG rows of x (dead rows and vectors as zeros): row `first + rr * stride`,
// vector i * lanes + sub.
template <typename T, int RPG, int NV>
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

// A vector of VEC values of type T, as the 16-byte words it was loaded in:
// bf16 values stay packed in registers until they are used.
template <typename T>
struct Words {
  static constexpr int N = VEC * static_cast<int>(sizeof(T)) / 16;
  uint4 w[N];
};

// N values of type T held in the 16-byte words w, as f32.
template <typename T, int N>
__device__ __forceinline__ void unpack(const uint4* w, float (&v)[N]) {
  T raw[N];
  memcpy(raw, w, sizeof(raw));
#pragma unroll
  for (int e = 0; e < N; ++e) v[e] = to_f32(raw[e]);
}

// RESIDUAL: the prologue runs (h, bias, layer_scale, x_out); out == nullptr:
// no norm.
template <typename X, typename H, int NV, bool RESIDUAL>
__global__ void __launch_bounds__(THREADS) vit_residual_norm_kernel(
    const X* __restrict__ x, const H* __restrict__ h, const float* __restrict__ bias,
    const float* __restrict__ layer_scale, X* __restrict__ x_out,
    const float* __restrict__ scale, const float* __restrict__ norm_bias,
    void* __restrict__ out, int out_bf16, float eps, int rows, int width, int lanes) {
  constexpr int RPG = rows_per_group(NV);
  const int lane = threadIdx.x % 32, sub = lane % lanes, groups = 32 / lanes;
  const long long first =
      (static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32) * groups * RPG + lane / lanes;
  const int vectors = width / VEC;
  float v[RPG][NV][VEC];
  load_rows<X, RPG, NV>(x, first, groups, sub, lanes, rows, width, v);
  if constexpr (RESIDUAL) {
    Words<H> hw[RPG][NV];
#pragma unroll
    for (int rr = 0; rr < RPG; ++rr) {
      const long long row = first + static_cast<long long>(rr) * groups;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int vi = i * lanes + sub;
        if (row < rows && vi < vectors) {
          hw[rr][i] = *reinterpret_cast<const Words<H>*>(h + row * width + vi * VEC);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = i * lanes + sub;
      if (vi >= vectors) continue;
      float b[VEC], ls[VEC];
      load(bias + vi * VEC, b);
      load(layer_scale + vi * VEC, ls);
#pragma unroll
      for (int rr = 0; rr < RPG; ++rr) {
        const long long row = first + static_cast<long long>(rr) * groups;
        if (row >= rows) continue;
        float hv[VEC];
        unpack<H>(hw[rr][i].w, hv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float hb = round_to<H>(hv[e] + round_to<H>(b[e]));
          v[rr][i][e] = round_to<X>(v[rr][i][e] + round_to<X>(hb * round_to<X>(ls[e])));
        }
        store(x_out + row * width + vi * VEC, v[rr][i]);
      }
    }
  }
  if (out == nullptr) return;
  float mean[RPG], r[RPG];
  const float inv_width = 1.f / static_cast<float>(width);
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
    mean[rr] = group_sum(s1, lanes) * inv_width;
    const float var = fmaxf(group_sum(s2, lanes) * inv_width - mean[rr] * mean[rr], 0.f);
    r[rr] = rsqrtf(var + eps);
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = i * lanes + sub;
    if (vi >= vectors) continue;
    float sc[VEC], nb[VEC];
    load(scale + vi * VEC, sc);
    load(norm_bias + vi * VEC, nb);
#pragma unroll
    for (int rr = 0; rr < RPG; ++rr) {
      const long long row = first + static_cast<long long>(rr) * groups;
      if (row >= rows) continue;
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = (v[rr][i][e] - mean[rr]) * (r[rr] * sc[e]) + nb[e];
      const long long off = row * width + vi * VEC;
      if (out_bf16) {
        store(static_cast<uint16_t*>(out) + off, o);
      } else {
        store(static_cast<float*>(out) + off, o);
      }
    }
  }
}

// silu(a) = a / (1 + exp(-a)), as PyTorch's F.silu computes it in f32 (expf,
// IEEE division). Where the result is rounded to bf16 (T = bf16) the fast
// intrinsics give the same bf16 for every bf16 a above -80 (below it their
// quotient flushes to 0), at a third of the instructions: on an H100 they
// took the gate from 72 to 79 % of its byte bound.
// tests/test_torch_cuda.py checks every finite bf16 input.
template <typename T>
__device__ __forceinline__ float silu(float a) {
  if constexpr (sizeof(T) == 2) {
    if (a > -80.f) return __fdividef(a, 1.f + __expf(-a));
  }
  return a / (1.f + expf(-a));
}

// GATE_ITEMS 16-byte output words a thread, THREADS apart; all loads issued
// before any arithmetic. items < 2^31 (the launch checks).
template <typename T>
__global__ void __launch_bounds__(THREADS, GATE_MIN_BLOCKS) swiglu_gate_kernel(
    const T* __restrict__ y, const float* __restrict__ bias, T* __restrict__ g, int items,
    int hidden) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int per_row = hidden / V;
  const int base = blockIdx.x * THREADS * GATE_ITEMS + threadIdx.x;
  uint4 a[GATE_ITEMS], u[GATE_ITEMS];  // V values each
  long long at[GATE_ITEMS];
  int col[GATE_ITEMS];
#pragma unroll
  for (int k = 0; k < GATE_ITEMS; ++k) {
    const int item = base + k * THREADS;
    if (item >= items) continue;
    const int row = item / per_row;
    col[k] = (item - row * per_row) * V;
    at[k] = static_cast<long long>(row) * hidden;
    a[k] = *reinterpret_cast<const uint4*>(y + 2 * at[k] + col[k]);
    u[k] = *reinterpret_cast<const uint4*>(y + 2 * at[k] + hidden + col[k]);
  }
#pragma unroll
  for (int k = 0; k < GATE_ITEMS; ++k) {
    if (base + k * THREADS >= items) continue;
    float y1[V], y2[V], b1[V], b2[V], o[V];
    unpack<T>(&a[k], y1);
    unpack<T>(&u[k], y2);
    load(bias + col[k], b1);
    load(bias + hidden + col[k], b2);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float x1 = round_to<T>(y1[e] + round_to<T>(b1[e]));
      const float x2 = round_to<T>(y2[e] + round_to<T>(b2[e]));
      o[e] = round_to<T>(silu<T>(x1)) * x2;
    }
    store(g + at[k] + col[k], o);
  }
}

long long blocks_for(int rows, int lanes, int nv) {
  const long long tile = static_cast<long long>(WARPS) * (32 / lanes) * rows_per_group(nv);
  return (rows + tile - 1) / tile;
}

template <typename X, typename H, int NV>
int residual_norm(const void* x, const void* h, const float* bias, const float* layer_scale,
                  void* x_out, const float* scale, const float* norm_bias, void* out,
                  int out_bf16, float eps, int rows, int width, int lanes, cudaStream_t st) {
  auto* kernel = h != nullptr ? vit_residual_norm_kernel<X, H, NV, true>
                              : vit_residual_norm_kernel<X, H, NV, false>;
  kernel<<<blocks_for(rows, lanes, NV), THREADS, 0, st>>>(
      static_cast<const X*>(x), static_cast<const H*>(h), bias, layer_scale,
      static_cast<X*>(x_out), scale, norm_bias, out, out_bf16, eps, rows, width, lanes);
  return static_cast<int>(cudaGetLastError());
}

// The launch with NV = nv, 1 to MAX_NV: kernels/vit_block.py::plan returns
// each of them for some width.
template <typename X, typename H, int NV = 1, typename... A>
int residual_norm_nv(int nv, A... args) {
  if constexpr (NV > MAX_NV) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return nv == NV ? residual_norm<X, H, NV>(args...)
                    : residual_norm_nv<X, H, NV + 1>(nv, args...);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The plan kernels/vit_block.py::plan gives: W a multiple of VEC, `lanes` a
// power of two up to 32, lanes * nv vectors covering the row.
bool valid(int rows, int width, int lanes, int nv) {
  return rows >= 1 && width >= 1 && width % VEC == 0 && lanes >= 1 && lanes <= 32 &&
         (lanes & (lanes - 1)) == 0 && nv >= 1 && nv <= MAX_NV &&
         static_cast<long long>(lanes) * nv * VEC >= width &&
         blocks_for(rows, lanes, nv) < (1LL << 31);
}

}  // namespace

// Each returns a cudaError_t: the launch's own error, or cudaErrorInvalidValue
// for a plan or operands the kernel does not take (operands not 16-byte
// aligned among them).
//
// x [rows, width] in X (x_bf16); bias, layer_scale, scale, norm_bias f32
// [width]. h == NULL: no residual prologue; else h [rows, width] in H
// (h_bf16; H = f32 with X = bf16 is refused) and x_out [rows, width] in X.
// out == NULL: no norm; else out [rows, width], bf16 where out_bf16.
extern "C" int tdspa_vit_residual_norm(const void* x, const void* h, const void* bias,
                                       const void* layer_scale, void* x_out, const void* scale,
                                       const void* norm_bias, void* out, int x_bf16, int h_bf16,
                                       int out_bf16, float eps, int rows, int width, int lanes,
                                       int nv, void* stream) {
  if (h == nullptr) h_bf16 = x_bf16;
  const bool residual_ok = h == nullptr || (aligned16(h) && aligned16(bias) &&
                                            aligned16(layer_scale) && aligned16(x_out));
  const bool norm_ok = out == nullptr || (aligned16(out) && aligned16(scale) &&
                                          aligned16(norm_bias));
  if (!valid(rows, width, lanes, nv) || (h == nullptr && out == nullptr) || !aligned16(x) ||
      !residual_ok || !norm_ok || (x_bf16 && !h_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const float*>(bias);
  const auto* ls = static_cast<const float*>(layer_scale);
  const auto* sc = static_cast<const float*>(scale);
  const auto* nb = static_cast<const float*>(norm_bias);
  if (x_bf16) {
    return residual_norm_nv<uint16_t, uint16_t>(nv, x, h, b, ls, x_out, sc, nb, out, out_bf16,
                                                eps, rows, width, lanes, st);
  }
  if (h_bf16) {
    return residual_norm_nv<float, uint16_t>(nv, x, h, b, ls, x_out, sc, nb, out, out_bf16, eps,
                                             rows, width, lanes, st);
  }
  return residual_norm_nv<float, float>(nv, x, h, b, ls, x_out, sc, nb, out, out_bf16, eps, rows,
                                        width, lanes, st);
}

// y [rows, 2 * hidden] and out [rows, hidden] in bf16 (bf16) or f32; bias f32
// [2 * hidden]; hidden a multiple of a 16-byte word's values.
extern "C" int tdspa_swiglu_gate(const void* y, const void* bias, void* out, int bf16, int rows,
                                 int hidden, void* stream) {
  const int v = bf16 ? 8 : 4;
  if (rows < 1 || hidden < 1 || hidden % v || !(aligned16(y) && aligned16(bias) && aligned16(out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long items = static_cast<long long>(rows) * (hidden / v);
  if (items >= (1LL << 31) - THREADS * GATE_ITEMS) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (items + THREADS * GATE_ITEMS - 1) / (THREADS * GATE_ITEMS);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const float*>(bias);
  if (bf16) {
    swiglu_gate_kernel<uint16_t><<<blocks, THREADS, 0, st>>>(
        static_cast<const uint16_t*>(y), b, static_cast<uint16_t*>(out), static_cast<int>(items),
        hidden);
  } else {
    swiglu_gate_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(y), b, static_cast<float*>(out), static_cast<int>(items), hidden);
  }
  return static_cast<int>(cudaGetLastError());
}
