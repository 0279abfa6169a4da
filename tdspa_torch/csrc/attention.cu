// Fused key-masked multi-head attention forward for Hopper (sm_90a).
//
// Replaces the two TPU bodies on the 3DSPA path, tdspa/kernels/attention.py
// `_mha_kernel` (whole KV per batch tile) and `_mha_flash_kernel` (KV-blocked
// online softmax). Those two exist only because of VMEM sizing; here one
// KV-looping online-softmax kernel computes both functions:
//
//   out[b,s,h,:] = softmax_k(q[b,s,h,:] . k[b,k,h,:] * scale, key-masked) . v[b,k,h,:]
//
// q/k/v are bf16 in the JAX layout [B, S|K, H, D]; the mask is uint8 [B, K]
// (nonzero = attend) or null; the output is f32 or bf16 [B, S, H, D].
//
// Numerics follow the Pallas kernels: bf16 products with f32 accumulation,
// logits scaled by `scale` in f32 afterwards, running max / denominator /
// accumulator in f32, P rounded to bf16 before P.V. A user-masked logit is
// FLT_MAX-negated (finfo(f32).min, never -inf), and the running max starts
// there too, so a row whose keys are all masked sees exp(0) = 1 on every
// key and returns the mean of all K values. Keys past K (the ragged last
// tile) are excluded by index and never enter that mean.
//
// Layout: one block per (batch item, head, query tile); each warp owns 16
// query rows and runs mma.sync m16n8k16 (bf16 in, f32 accumulate) for both
// products, with the Q fragments in registers, the O accumulator in
// registers, and a 64-key K/V tile staged in shared memory per step.
//
// What bounds it on an H100: at the main-path shapes the work is
// 2 * 2 * S * K * D flops per (item, head) against reading q, k, v once
// and writing the output once, about 50-120 flops per byte: far below the
// ~295 flops/byte where bf16 tensor cores take over, so device-memory
// bytes bound it. The design keeps logits and probabilities out of device
// memory entirely (the plain version writes and reads them as f32).
// Not done yet: cp.async/TMA double buffering of the K/V tiles and wgmma;
// and the B=1 stacks (128 queries x 8 heads, e.g. the 128x2048 latent
// cross-attention) launch only 64 one-warp blocks on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int KV_TILE = 64;  // keys staged per step
constexpr int PAD = 8;       // bf16 elements of padding per shared row (bank spread)
constexpr uint8_t KEY_ATTEND = 1, KEY_MASKED = 0, KEY_PAST_END = 2;

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[16x8] += A[16x16] . B[16x8], bf16 inputs, f32 accumulate.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// DP: head width rounded up to a multiple of 16 (the mma depth); columns
// D..DP-1 are zero in every operand and never stored.
template <int DP, bool OUT_BF16>
__global__ void __launch_bounds__(256) attention_fwd_kernel(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, const uint8_t* __restrict__ mask,
    void* __restrict__ out, int S, int K, int H, int D, int q_blocks, float scale) {
  constexpr int KSTEPS = DP / 16;   // mma k-steps over the head width
  constexpr int NTILES = DP / 8;    // 8-wide output column tiles
  constexpr int LD = DP + PAD;      // shared row stride, elements
  constexpr int CHUNKS = DP / 8;    // 16-byte chunks per shared row
  __shared__ __align__(16) uint16_t k_s[KV_TILE * LD];
  __shared__ __align__(16) uint16_t v_s[KV_TILE * LD];
  __shared__ uint8_t key_s[KV_TILE];

  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma group id / thread in group

  const long long blk = blockIdx.x;
  const int qb = static_cast<int>(blk % q_blocks);
  const int h = static_cast<int>((blk / q_blocks) % H);
  const long long b = blk / (static_cast<long long>(q_blocks) * H);

  const long long row_stride = static_cast<long long>(H) * D;  // elements per s (or k) step
  const uint16_t* qh = q + b * S * row_stride + h * D;
  const uint16_t* kh = k + b * K * row_stride + h * D;
  const uint16_t* vh = v + b * K * row_stride + h * D;

  const int row0 = (qb * warps + warp) * 16;  // this warp's first query row
  const bool active = row0 < S;               // warp-uniform
  const int r_lo = row0 + g, r_hi = row0 + g + 8;

  // Q as mma A fragments: rows r_lo / r_hi, columns kk*16 + 2t (+1, +8, +9).
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c0 = kk * 16 + 2 * t, c1 = c0 + 8;
    qf[kk][0] = (r_lo < S && c0 < D) ? ld_pair(qh + r_lo * row_stride + c0) : 0u;
    qf[kk][1] = (r_hi < S && c0 < D) ? ld_pair(qh + r_hi * row_stride + c0) : 0u;
    qf[kk][2] = (r_lo < S && c1 < D) ? ld_pair(qh + r_lo * row_stride + c1) : 0u;
    qf[kk][3] = (r_hi < S && c1 < D) ? ld_pair(qh + r_hi * row_stride + c1) : 0u;
  }

  float acc[NTILES][4];
#pragma unroll
  for (int n = 0; n < NTILES; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-FLT_MAX, -FLT_MAX};  // rows r_lo, r_hi
  float l_run[2] = {0.f, 0.f};            // this thread's share of the denominator

  for (int kv0 = 0; kv0 < K; kv0 += KV_TILE) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < KV_TILE * CHUNKS; i += blockDim.x) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      const int j = kv0 + r;
      uint4 kc = make_uint4(0u, 0u, 0u, 0u), vc = kc;
      if (j < K && c < D) {
        kc = *reinterpret_cast<const uint4*>(kh + j * row_stride + c);
        vc = *reinterpret_cast<const uint4*>(vh + j * row_stride + c);
      }
      *reinterpret_cast<uint4*>(&k_s[r * LD + c]) = kc;
      *reinterpret_cast<uint4*>(&v_s[r * LD + c]) = vc;
    }
    for (int i = threadIdx.x; i < KV_TILE; i += blockDim.x) {
      const int j = kv0 + i;
      key_s[i] = j >= K ? KEY_PAST_END
               : (mask == nullptr || mask[b * K + j] != 0) ? KEY_ATTEND : KEY_MASKED;
    }
    __syncthreads();
    if (!active) continue;

    // S = Q . K^T for 64 keys: 8 column tiles of 8 keys.
    float s[KV_TILE / 8][4];
#pragma unroll
    for (int n = 0; n < KV_TILE / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint16_t* kr = &k_s[(n * 8 + g) * LD + kk * 16 + 2 * t];
        const uint32_t bf[2] = {ld_pair(kr), ld_pair(kr + 8)};
        mma_16816(s[n], qf[kk], bf);
      }
    }

    // Scale, mask, and the tile's row maxima (a row lives on 4 lanes).
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < KV_TILE / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const float x = key_s[col] == KEY_ATTEND ? s[n][e] * scale : -FLT_MAX;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m_run[r] - mx[r]);
      m_run[r] = mx[r];
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NTILES; ++n) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
    }

    // P = exp(S - max), f32 into the denominator, bf16 into the A fragments.
    uint32_t pf[KV_TILE / 16][4];
#pragma unroll
    for (int n = 0; n < KV_TILE / 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        p[e] = key_s[col] == KEY_PAST_END ? 0.f : expf(s[n][e] - mx[e >> 1]);
        l_run[e >> 1] += p[e];
      }
      // C tile n covers keys n*8..n*8+7: the low (n even) or high (n odd)
      // 8 keys of A fragment n/2.
      pf[n / 2][(n & 1) * 2 + 0] = pack_bf16(p[0], p[1]);  // row r_lo
      pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);  // row r_hi
    }

    // O += P . V: B fragment rows are keys 2t, 2t+1 (+8, +9), column g.
#pragma unroll
    for (int kk = 0; kk < KV_TILE / 16; ++kk) {
      const uint16_t* vr = &v_s[(kk * 16 + 2 * t) * LD];
#pragma unroll
      for (int n = 0; n < NTILES; ++n) {
        const int c = n * 8 + g;
        const uint32_t bf[2] = {
            static_cast<uint32_t>(vr[c]) | (static_cast<uint32_t>(vr[LD + c]) << 16),
            static_cast<uint32_t>(vr[8 * LD + c]) | (static_cast<uint32_t>(vr[9 * LD + c]) << 16)};
        mma_16816(acc[n], pf[kk], bf);
      }
    }
  }
  if (!active) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int n = 0; n < NTILES; ++n) {
    const int c = n * 8 + 2 * t;
    if (c >= D) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r == 0 ? r_lo : r_hi;
      if (row >= S) continue;
      const float o0 = acc[n][2 * r] / l_run[r], o1 = acc[n][2 * r + 1] / l_run[r];
      const long long off = (b * S + row) * row_stride + h * D + c;
      if (OUT_BF16) {
        *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(out) + off) = pack_bf16(o0, o1);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + off) = make_float2(o0, o1);
      }
    }
  }
}

template <int DP>
void launch(const void* q, const void* k, const void* v, const void* mask, void* out,
            bool out_bf16, long long blocks, int threads, int S, int K, int H, int D,
            int q_blocks, float scale, cudaStream_t stream) {
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const uint16_t*>(k);
  const auto* vp = static_cast<const uint16_t*>(v);
  const auto* mp = static_cast<const uint8_t*>(mask);
  if (out_bf16) {
    attention_fwd_kernel<DP, true><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        qp, kp, vp, mp, out, S, K, H, D, q_blocks, scale);
  } else {
    attention_fwd_kernel<DP, false><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        qp, kp, vp, mp, out, S, K, H, D, q_blocks, scale);
  }
}

}  // namespace

// Returns a cudaError_t: the launch's own error, or cudaErrorInvalidValue
// for arguments the kernel does not take. `warps` query tiles of 16 rows per
// block, `q_blocks` blocks per (item, head): q_blocks * warps * 16 >= S.
extern "C" int tdspa_attention_forward(const void* q, const void* k, const void* v,
                                       const void* mask, void* out, int out_bf16, int B,
                                       int S, int K, int H, int D, int q_blocks, int warps,
                                       float scale, void* stream) {
  const long long blocks = static_cast<long long>(B) * H * q_blocks;
  if (B < 1 || S < 1 || K < 1 || H < 1 || D < 8 || D > 128 || D % 8 != 0 || warps < 1 ||
      warps > 8 || q_blocks < 1 || static_cast<long long>(q_blocks) * warps * 16 < S ||
      blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = warps * 32;
  auto st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 16: launch<16>(q, k, v, mask, out, out_bf16, blocks, threads, S, K, H, D, q_blocks, scale, st); break;
    case 32: launch<32>(q, k, v, mask, out, out_bf16, blocks, threads, S, K, H, D, q_blocks, scale, st); break;
    case 48: launch<48>(q, k, v, mask, out, out_bf16, blocks, threads, S, K, H, D, q_blocks, scale, st); break;
    case 64: launch<64>(q, k, v, mask, out, out_bf16, blocks, threads, S, K, H, D, q_blocks, scale, st); break;
    case 80: launch<80>(q, k, v, mask, out, out_bf16, blocks, threads, S, K, H, D, q_blocks, scale, st); break;
    case 96: launch<96>(q, k, v, mask, out, out_bf16, blocks, threads, S, K, H, D, q_blocks, scale, st); break;
    case 112: launch<112>(q, k, v, mask, out, out_bf16, blocks, threads, S, K, H, D, q_blocks, scale, st); break;
    default: launch<128>(q, k, v, mask, out, out_bf16, blocks, threads, S, K, H, D, q_blocks, scale, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
