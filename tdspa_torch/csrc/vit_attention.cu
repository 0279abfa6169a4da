// Maskless multi-head attention forward for ViT frames on Hopper (sm_90a).
//
// Replaces the TPU kernel that both ViT backbones (DINOv2 features and the
// VDA depth backbone) run: tdspa/kernels/attention.py `_flash_perhead`
// (pallas_call at :214) with its body `_mha_flash_perhead_kernel` (:138):
//
//   out[b,s,h,:] = softmax_k(q[b,s,h,:] . k[b,k,h,:] * scale) . v[b,k,h,:]
//
// q/k/v are bf16 in the JAX layout [B, S|K, H, 64]; the output is f32 or
// bf16 [B, S, H, 64]. Every DINOv2 preset has a head width of 64, so that is
// the only width this kernel takes. There is no mask: keys past K (the
// ragged last tile) are excluded by index, as the TPU body excludes the
// padded tail of its last KV block from the static kv_len.
//
// Numerics follow the Pallas body: bf16 products with f32 accumulation, the
// logits scaled in f32 after the product, running max / denominator /
// accumulator in f32, P rounded to bf16 before P.V. The exponentials are
// exp2 of logits pre-multiplied by log2(e), which equals exp to f32 rounding.
// The TPU body's head-major [B,H,S,D] layout, transposed [KB,S] logits and
// per-head grid exist only to fit VMEM; none of them carries over.
//
// Layout: one block of 8 warps per (batch item, head, 128 query rows); each
// warp owns 16 query rows, keeps its Q fragments and its O accumulator in
// registers and runs mma.sync m16n8k16 for both products. K and V tiles of
// 64 keys are copied to shared memory with cp.async, double buffered, so the
// next tile's copy overlaps this tile's products; ldmatrix (transposed for
// V) feeds the mma B fragments.
//
// What bounds it on an H100: at the main-path shapes (B=8 frames, S=K=1297
// or 1370 tokens, H=12) a launch does 4*B*H*S*K*64 flops, 41-46 GFLOP,
// against 64-80 MB of q, k, v and output: about 600 flops per byte, above
// the ~295 where bf16 tensor cores rather than memory set the limit. So
// operations bound it (0.042 / 0.047 ms at 989 TFLOP/s). The design keeps
// the [S, K] logits and probabilities on chip and feeds the tensor cores
// from shared memory without waiting on device memory.
// Not done yet: wgmma (mma.sync reaches only part of Hopper's tensor-core
// rate), TMA copies with a producer warp, larger KV tiles, and a persistent
// launch that overlaps one tile's softmax with the next tile's products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HEAD = 64;             // head width
constexpr int KV_TILE = 64;          // keys per step
constexpr int WARPS = 8;             // 16 query rows each
constexpr int ROWS = WARPS * 16;     // query rows per block
constexpr int LD = HEAD + 8;         // shared row stride (bf16): 144 bytes, conflict-free ldmatrix
constexpr int CHUNKS = HEAD / 8;     // 16-byte chunks per row
constexpr int KSTEPS = HEAD / 16;    // mma k-steps over the head width
constexpr int OTILES = HEAD / 8;     // 8-wide output column tiles
constexpr int STILES = KV_TILE / 8;  // 8-wide logit column tiles

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` = 0 writes zeros (keys past K).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[16x8] += A[16x16] . B[16x8], bf16 inputs, f32 accumulate.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool OUT_BF16>
__global__ void __launch_bounds__(WARPS * 32) vit_attention_kernel(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, void* __restrict__ out, int S, int K, int H,
    int q_blocks, float scale_log2) {
  __shared__ __align__(16) uint16_t k_s[2][KV_TILE * LD];
  __shared__ __align__(16) uint16_t v_s[2][KV_TILE * LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma group id / thread in group

  const long long blk = blockIdx.x;
  const int qb = static_cast<int>(blk % q_blocks);
  const int h = static_cast<int>((blk / q_blocks) % H);
  const long long b = blk / (static_cast<long long>(q_blocks) * H);

  const long long row_stride = static_cast<long long>(H) * HEAD;  // elements per token
  const uint16_t* qh = q + b * S * row_stride + h * HEAD;
  const uint16_t* kh = k + b * K * row_stride + h * HEAD;
  const uint16_t* vh = v + b * K * row_stride + h * HEAD;

  // Stage keys tile*64 .. +63 of K and V into buffer `buf`; rows past K are zeros.
  auto load_tile = [&](int tile, int buf) {
    const int kv0 = tile * KV_TILE;
    for (int i = threadIdx.x; i < KV_TILE * CHUNKS; i += WARPS * 32) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      const int j = kv0 + r;
      const bool inside = j < K;
      const long long off = static_cast<long long>(inside ? j : 0) * row_stride + c;
      cp_async16(smem_addr(&k_s[buf][r * LD + c]), kh + off, inside ? 16 : 0);
      cp_async16(smem_addr(&v_s[buf][r * LD + c]), vh + off, inside ? 16 : 0);
    }
    cp_async_commit();
  };

  const int tiles = (K + KV_TILE - 1) / KV_TILE;
  load_tile(0, 0);

  const int row0 = qb * ROWS + warp * 16;  // this warp's first query row
  const bool active = row0 < S;            // warp-uniform
  const int r_lo = row0 + g, r_hi = row0 + g + 8;

  // Q as mma A fragments: rows r_lo / r_hi, columns kk*16 + 2t (+1, +8, +9).
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c0 = kk * 16 + 2 * t, c1 = c0 + 8;
    qf[kk][0] = r_lo < S ? ld_pair(qh + r_lo * row_stride + c0) : 0u;
    qf[kk][1] = r_hi < S ? ld_pair(qh + r_hi * row_stride + c0) : 0u;
    qf[kk][2] = r_lo < S ? ld_pair(qh + r_lo * row_stride + c1) : 0u;
    qf[kk][3] = r_hi < S ? ld_pair(qh + r_hi * row_stride + c1) : 0u;
  }

  float acc[OTILES][4];
#pragma unroll
  for (int n = 0; n < OTILES; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows r_lo, r_hi, in log2 units
  float l_run[2] = {0.f, 0.f};              // this thread's share of the denominator

  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < tiles) {
      load_tile(tile + 1, buf ^ 1);  // that buffer was last read before the previous sync
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile is in shared memory for every warp

    if (active) {
      const int kv0 = tile * KV_TILE;
      const uint16_t* ks = k_s[buf];
      const uint16_t* vs = v_s[buf];

      // S = Q . K^T for 64 keys. ldmatrix x4 over 8 keys x 32 dims gives the
      // B fragments of two k-steps: matrix m covers dims kp*32 + m*8.
      float s[STILES][4];
#pragma unroll
      for (int n = 0; n < STILES; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kp = 0; kp < KSTEPS / 2; ++kp) {
          uint32_t bf[4];
          ldmatrix_x4(bf, smem_addr(ks + (n * 8 + (lane & 7)) * LD + kp * 32 + (lane >> 3) * 8));
          mma_16816(s[n], qf[2 * kp], bf[0], bf[1]);
          mma_16816(s[n], qf[2 * kp + 1], bf[2], bf[3]);
        }
      }

      // Scale into log2 units, drop keys past K, and the tile's row maxima
      // (a row lives on the 4 lanes of a group).
      const bool full = kv0 + KV_TILE <= K;
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int n = 0; n < STILES; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + n * 8 + 2 * t + (e & 1);
          const float x = (full || col < K) ? s[n][e] * scale_log2 : -INFINITY;
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m_run[r] - mx[r]);  // 0 on the first tile (m_run = -inf)
        m_run[r] = mx[r];
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < OTILES; ++n) {
        acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
      }

      // P = exp(S - max): f32 into the denominator, bf16 into the A fragments.
      uint32_t pf[KV_TILE / 16][4];
#pragma unroll
      for (int n = 0; n < STILES; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f(s[n][e] - mx[e >> 1]);  // keys past K: exp2(-inf) = 0
          l_run[e >> 1] += p[e];
        }
        // Logit tile n covers keys n*8..n*8+7: the low (n even) or high
        // (n odd) 8 keys of A fragment n/2.
        pf[n / 2][(n & 1) * 2 + 0] = pack_bf16(p[0], p[1]);  // row r_lo
        pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);  // row r_hi
      }

      // O += P . V. ldmatrix x4 transposed over 16 keys x 16 dims gives the
      // B fragments of two output tiles: matrix m covers keys (m & 1) * 8 and
      // dims of tile 2 * np + (m >> 1).
#pragma unroll
      for (int kk = 0; kk < KV_TILE / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < OTILES / 2; ++np) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, smem_addr(vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                          (np * 2 + (lane >> 4)) * 8));
          mma_16816(acc[2 * np], pf[kk], bf[0], bf[1]);
          mma_16816(acc[2 * np + 1], pf[kk], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  if (!active) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int n = 0; n < OTILES; ++n) {
    const int c = n * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r == 0 ? r_lo : r_hi;
      if (row >= S) continue;
      const float o0 = acc[n][2 * r] / l_run[r], o1 = acc[n][2 * r + 1] / l_run[r];
      const long long off = (b * S + row) * row_stride + h * HEAD + c;
      if (OUT_BF16) {
        *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(out) + off) = pack_bf16(o0, o1);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + off) = make_float2(o0, o1);
      }
    }
  }
}

}  // namespace

// Returns a cudaError_t: the launch's own error, or cudaErrorInvalidValue for
// arguments the kernel does not take. `q_blocks` blocks of 128 query rows per
// (item, head): q_blocks * 128 >= S. `scale` is the softmax scale (1/sqrt(D)).
extern "C" int tdspa_vit_attention_forward(const void* q, const void* k, const void* v, void* out,
                                           int out_bf16, int B, int S, int K, int H, int D,
                                           int q_blocks, float scale, void* stream) {
  const long long blocks = static_cast<long long>(B) * H * q_blocks;
  if (B < 1 || S < 1 || K < 1 || H < 1 || D != HEAD || q_blocks < 1 ||
      static_cast<long long>(q_blocks) * ROWS < S || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const uint16_t*>(k);
  const auto* vp = static_cast<const uint16_t*>(v);
  auto st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * 1.4426950408889634f;
  if (out_bf16) {
    vit_attention_kernel<true><<<static_cast<unsigned>(blocks), WARPS * 32, 0, st>>>(
        qp, kp, vp, out, S, K, H, q_blocks, scale_log2);
  } else {
    vit_attention_kernel<false><<<static_cast<unsigned>(blocks), WARPS * 32, 0, st>>>(
        qp, kp, vp, out, S, K, H, q_blocks, scale_log2);
  }
  return static_cast<int>(cudaGetLastError());
}
