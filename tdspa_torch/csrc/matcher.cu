// Learned-matcher correlation cost patches against a template bank, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel tdspa/kernels/matcher.py::cost_patches_multi_pallas
// (pallas_call at :210, body `_cost_kernel` :68; `cost_patches_pallas` :157
// is its M = 1 case). It computes the XLA path of the matcher,
// tdspa/features/matcher.py::_cost_patches_multi (ported as
// tdspa_torch/kernels/matcher.py::cost_patches_reference, this kernel's plain
// version):
//
//   costs[n,t,m,k] = sum_d bilinear(feats[t], fpos[n,t] + off[k])[d] * tvec[n,m,d]
//
// with off[k] = (k % (2R+1) - R, k / (2R+1) - R) and the corner rule of
// ops/geometry.bilinear_sample (weights from the unclamped floor, each corner
// clamped on its own). The TPU kernel shifts border windows inward instead.
//
// Contract before blending. The offsets are integers, so the (2R+1)^2
// samples of one (point, frame) read one window of (2R+2)^2 pixels, columns
// clamp(xi - R + i) and rows clamp(yi - R + j) with (xi, yi) the floor of
// the position: offset k's corners are window columns kx, kx + 1 and rows
// ky, ky + 1, which is the per-corner clamp of the plain version, also far
// outside the map. The kernel forms the window's dot products once,
//
//   G[m,j,i] = F[row j, column i] . tvec[n,m]        ((2R+2)^2 M dots of D)
//
// then each cost as the bilinear blend of four G, against 81 blends of 4 D
// channels and 81 M dots of D. The weights are the plain version's own:
// per offset column, x = px + ox rounded in f32 and wx = x - floor(x);
// where px + ox rounds up onto an integer, the sample sits on column kx + 1
// with weight 1 (rows alike). Only the order of the sums differs (dot then
// blend, against blend then dot): about 1e-7 on L2-normalised features.
//
// Layout: a warp takes four consecutive points of one frame, one after the
// other, with their positions read in one round up front (they are the
// latency at the head of each point's chain) and their windows overlapping
// in L1; four warps per block, frames slowest (the grid's second
// dimension) so that the blocks in flight share one frame's feature map in
// L2 (256 x 256 x 16 f32 = 4 MB at the pipeline's shape). Each lane takes
// whole window pixels, 32 per round (4
// rounds for R = 4), and contracts a pixel's D channels (D / 4 16-byte
// loads) with up to MG template vectors held in its registers, so no
// product is summed across lanes. G and the offsets' weights sit in shared
// memory; the blend takes one offset per lane and writes each template's
// 81-float row with coalesced streaming stores (this kernel does not read
// the costs again).
//
// What bounds it on an H100: the feature map is read once (T x Hf x Wf x D
// f32, 629 MB for 150 frames of 512x512) and the costs written once (N x T x
// M x 81 f32: 199 MB at M = 1, 796 MB at M = 4), against 2 D M flops per
// window pixel and 7 per cost: device-memory bytes bound it (about 0.25 ms
// at M = 1 and 0.43 ms at M = 4 at 3.35 TB/s). Each map pixel lies in about
// six (point, frame) windows at the pipeline's spacing, so the windows
// read 3.9 GB a launch from L2 and L1. Measured on an H100 (PERF.md), the
// kernel runs at about a fifth of its bound, and neither its device-memory
// nor its L2 traffic is what holds it: redirecting its loads to one
// address, dropping its stores, or staging a block's overlapping windows in
// shared memory each moved it by a quarter or less, or slowed it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int ITEMS = 4;  // consecutive points per warp
constexpr int MAX_RADIUS = 8;  // a block's window products stay under 48 KB
constexpr unsigned FULL = 0xffffffffu;

struct Shape {
  int N, T, Hf, Wf, M, R;
};

// Clamp before the conversion so that a position far outside stays defined.
__device__ __forceinline__ int to_index(float v) {
  return static_cast<int>(fminf(fmaxf(v, -1e9f), 1e9f));
}

// MG templates per pass over the window (MG x D floats in registers). RC > 0
// fixes the radius at compile time, so that the window's index arithmetic
// divides by constants (the shipped matcher's 4: an eighth faster at M = 4
// than a runtime radius on an H100); RC = 0 reads it from the shape.
template <int D, int MG, int RC>
__global__ void __launch_bounds__(WARPS * 32)
    cost_patches_kernel(const float* __restrict__ feats, const float* __restrict__ tvec,
                        const float* __restrict__ fpos, float* __restrict__ out, Shape s) {
  constexpr int V = D / 4;  // 16-byte pieces of a pixel
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.y, first = (blockIdx.x * WARPS + warp) * ITEMS;  // frames slowest
  if (first >= s.N) return;
  const int R = RC > 0 ? RC : s.R;
  const int W = 2 * R + 2, NP = W * W, side = 2 * R + 1, K2 = side * side;
  float* G = smem + warp * (MG * NP + 2 * side);  // [MG][W][W] window dot products
  float* wxy = G + MG * NP;                       // [side] column weights, then [side] row weights
  const float4* frame =
      reinterpret_cast<const float4*>(feats + static_cast<size_t>(t) * s.Hf * s.Wf * D);
  // The warp's positions in one round of loads: lane i holds item i's.
  float2 pos = make_float2(0.f, 0.f);
  if (lane < ITEMS && first + lane < s.N) {
    pos = __ldg(reinterpret_cast<const float2*>(fpos) +
                static_cast<size_t>(first + lane) * s.T + t);
  }
  for (int item = 0; item < ITEMS && first + item < s.N; ++item) {
    const int n = first + item;
    const size_t pt = static_cast<size_t>(n) * s.T + t;
    const float px = __shfl_sync(FULL, pos.x, item), py = __shfl_sync(FULL, pos.y, item);
    const float pxf = floorf(px), pyf = floorf(py);
    const int xi = to_index(pxf), yi = to_index(pyf);
    for (int c = lane; c < 2 * side; c += 32) {
      const bool col = c < side;
      const float o = static_cast<float>((col ? c : c - side) - R);
      const float v = (col ? px : py) + o, vf = floorf(v);
      wxy[c] = vf > (col ? pxf : pyf) + o ? 1.f : v - vf;
    }

    const int rounds = (NP + 31) / 32;
    for (int m0 = 0; m0 < s.M; m0 += MG) {
      const int mg = min(MG, s.M - m0);
      float4 tq[MG][V];
      const float4* tv =
          reinterpret_cast<const float4*>(tvec + (static_cast<size_t>(n) * s.M + m0) * D);
#pragma unroll
      for (int g = 0; g < MG; ++g) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          tq[g][v] = g < mg ? __ldg(tv + g * V + v) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int r = 0; r < rounds; ++r) {
        const int p = lane + 32 * r;
        if (p < NP) {
          const int j = p / W, i = p - j * W;
          const int yy = min(max(yi - R + j, 0), s.Hf - 1);
          const int xx = min(max(xi - R + i, 0), s.Wf - 1);
          const float4* f = frame + (yy * s.Wf + xx) * V;
          float4 px4[V];
#pragma unroll
          for (int v = 0; v < V; ++v) px4[v] = __ldg(f + v);
#pragma unroll
          for (int g = 0; g < MG; ++g) {
            float acc = 0.f;
#pragma unroll
            for (int v = 0; v < V; ++v) {
              acc += px4[v].x * tq[g][v].x + px4[v].y * tq[g][v].y + px4[v].z * tq[g][v].z +
                     px4[v].w * tq[g][v].w;
            }
            G[g * NP + p] = acc;
          }
        }
      }
      __syncwarp();
      float* o = out + (pt * s.M + m0) * K2;
      for (int k = lane; k < K2; k += 32) {
        const int ky = k / side, kx = k - ky * side;
        const float wx = wxy[kx], wy = wxy[side + ky];
        const float w00 = (1.f - wx) * (1.f - wy), w01 = wx * (1.f - wy);
        const float w10 = (1.f - wx) * wy, w11 = wx * wy;
        const float* g = G + ky * W + kx;
        for (int m = 0; m < mg; ++m) {
          __stcs(o + m * K2 + k,
                 g[m * NP] * w00 + g[m * NP + 1] * w01 + g[m * NP + W] * w10 +
                     g[m * NP + W + 1] * w11);
        }
      }
      __syncwarp();  // G and the weights are rewritten by the next group or item
    }
  }
}

template <int D, int MG, int RC>
cudaError_t launch(const float* feats, const float* tvec, const float* fpos, float* out,
                   const Shape& s, cudaStream_t stream) {
  const int W = 2 * s.R + 2, side = 2 * s.R + 1;
  const size_t smem = sizeof(float) * WARPS * (MG * W * W + 2 * side);
  const dim3 grid((s.N + WARPS * ITEMS - 1) / (WARPS * ITEMS), s.T);
  cost_patches_kernel<D, MG, RC><<<grid, WARPS * 32, smem, stream>>>(feats, tvec, fpos, out, s);
  return cudaGetLastError();
}

template <int D, int MG>
cudaError_t launch_r(const float* feats, const float* tvec, const float* fpos, float* out,
                     const Shape& s, cudaStream_t stream) {
  return s.R == 4 ? launch<D, MG, 4>(feats, tvec, fpos, out, s, stream)
                  : launch<D, MG, 0>(feats, tvec, fpos, out, s, stream);
}

// A single template, or groups of up to 64 template floats in registers.
template <int D>
cudaError_t launch_d(const float* feats, const float* tvec, const float* fpos, float* out,
                     const Shape& s, cudaStream_t stream) {
  constexpr int MG = 64 / D < 4 ? 64 / D : 4;
  return s.M == 1 ? launch_r<D, 1>(feats, tvec, fpos, out, s, stream)
                  : launch_r<D, MG>(feats, tvec, fpos, out, s, stream);
}

}  // namespace

// feats [T, Hf, Wf, D] f32 (16-byte aligned), tvec [N, M, D] f32 (16-byte
// aligned), fpos [N, T, 2] f32 feature-pixel (x, y); writes out
// [N, T, M, (2R+1)^2] f32 on `stream`. D is 8, 16 or 32; R is at most 8;
// T at most 65535 (the grid's second dimension).
// Returns a cudaError_t.
extern "C" int tdspa_cost_patches(const void* feats, const void* tvec, const void* fpos, void* out,
                                  int N, int T, int Hf, int Wf, int D, int M, int R,
                                  void* stream) {
  if (N < 1 || T < 1 || T > 65535 || Hf < 1 || Wf < 1 || M < 1 || R < 0 || R > MAX_RADIUS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s{N, T, Hf, Wf, M, R};
  const float* f = static_cast<const float*>(feats);
  const float* tv = static_cast<const float*>(tvec);
  const float* p = static_cast<const float*>(fpos);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return static_cast<int>(launch_d<8>(f, tv, p, o, s, st));
    case 16: return static_cast<int>(launch_d<16>(f, tv, p, o, s, st));
    case 32: return static_cast<int>(launch_d<32>(f, tv, p, o, s, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
