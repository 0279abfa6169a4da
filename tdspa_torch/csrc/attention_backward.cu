// Backward of the differentiable fused attention for Hopper (sm_90a).
//
// Replaces the recompute of JAX's `fused_attention` custom VJP,
// tdspa/kernels/attention.py `_fused_bwd` (the VJP of `_xla_reference`):
// the TPU has no backward kernel, XLA fuses the recompute. For bf16
// q [B,S,H,D], k, v [B,K,H,D], a uint8 key mask [B,K] (nonzero = attend) or
// null, and the f32 cotangent g [B,S,H,D], it writes bf16 dq, dk, dv:
//
//   qs = bf16(q / bf16(sqrt D))          (the wrapper passes bf16(sqrt D))
//   s  = qs . k^T (f32 sums), masked keys finfo(f32).min
//   P  = exp(s - m) / l                  m = row max, l = row sum, two numbers
//   dP = bf16(g . v^T)                   JAX rounds the cotangent of bf16 P
//   D_ = rowsum(dP o P)                  the softmax VJP's term
//   dS = P o (dP - D_), zero at masked keys
//   dv = bf16(bf16(P)^T . g), dk = bf16(dS^T . qs), dq = bf16(bf16(dS . k) / bf16(sqrt D))
//
// A fully masked row has m = finfo.min and l = K: P is 1/K on every key
// (masked ones too, so dv gets g/K there) while dS is zero, so dq of that row
// is exactly 0. The kernel rounds two operands more than JAX: g to bf16 once
// on load, and dS to bf16 as the A operand of the dk and dq products; both
// stay within bf16 tolerance of the plain version
// (`kernels/attention.py::attention_backward_reference`).
//
// What bounds it on an H100: reading q, k, v (bf16) and g (f32) once and
// writing dq, dk, dv (bf16) against 10 S K D flops per (item, head) of
// products: at the training shapes (S, K about 150, D 64 or 96) about 95
// flops per byte, far below the ~295 where bf16 tensor cores bound, so
// device-memory bytes bound it. The design reads each input once, keeps P,
// dP and dS out of device memory, and keeps the loads of the next work item
// in flight while the current one computes.
//
// Design: a persistent grid (one block of four warpgroups per SM) walks the
// work items (item, head, ROWS query rows, ROWS keys); ROWS = 192 (3
// consumer warpgroups x 64 rows) for D <= 96, 128 for D > 96. At the training
// shapes (S, K <= 192) one work item owns every query and key of an (item,
// head), so dq, dk and dv are whole: no atomics, no partial sums.
//   Warpgroup 0 gives its registers up (setmaxnreg 32): warp 0 issues the
// TMA loads of g and v, warp 1 writes the key states from the mask and
// issues the TMA loads of q and k, warps 2-3 convert g. q, k, v arrive as 4-D
// tensor maps over [B, S|K, H, D] in boxes of 32 columns (64-byte rows,
// 64-byte swizzle, the wgmma operand layout), so rows past S or K and
// columns past D arrive as zeros. g (f32, 40 % of the bytes) arrives by TMA
// in four pieces of ROWS / 4 rows into a two-stage ring inside v's tile; the
// converters write it as bf16 into g's tile, then v loads into its own tile.
// The consumers scale q in place (qs = bf16(q / root) through the corrected
// reciprocal) at the start of each item.
//   Warpgroups 1-3 (setmaxnreg 160) own 64 query rows and 64 keys each and
// run three phases on wgmma m64nNk16 (bf16 in, f32 accumulation), with
// named barriers between them:
//   1. query rows: s = qs k^T and dP = g v^T per 64-key tile (both operands
//      K-major in shared memory), the online row max m, sum l and sum of P
//      bf16(dP), kept as (m, 1/l, D_) per row in shared memory; bf16(dP)
//      goes to the dP^T buffer (bf16, 64-query boxes of 128-byte rows, the
//      128-byte swizzle), so the key pass reads it instead of recomputing
//      it, and v is free after this phase;
//   2. key rows (as FlashAttention-2's backward): per 64 queries s^T = k
//      qs^T, P^T in registers, dS^T = P^T (dP^T - D_) over dP^T in place,
//      and dv += bf16(P^T) g with P^T as the register A operand and g read
//      N-major (rows along K) through a descriptor whose leading offset
//      steps between the 32-column boxes;
//   3. dk (key rows) = dS^T qs with dS^T K-major from shared memory, then dq
//      (query rows) = dS k with dS^T read M-major (the transposed A).
// Six products per item in all (s, dP, s^T, dv, dk, dq), on 64-column tiles;
// a last tile with at most 32 live keys or queries runs at 32 columns (S =
// 151 pads to 160, not 192).
//   The loads overlap the compute where the tiles are free: after phase 1
// (v no longer read) the next item's g pieces load into v's tile; after
// phase 2 (g free) the converters write them into g's tile and v loads;
// after phase 3's dk, q; after its dq, k. Each bf16 output is staged in the
// tile that just fell free (dv in g's, dk in q's, dq in k's) and written by
// a TMA store; f32 partial sums go from registers to device memory.
//   Shared memory at D = 96: q, g, k, v 4 x 36 KB (192 rows x 96 bf16), dP^T
// / dS^T 72 KB (192 x 192 bf16), row statistics and key states 3.8 KB: 221 KB
// of the 227 KB; the g staging ring (2 x 18 KB) reuses v's tile. D = 128 with
// 128 rows: 4 x 32 + 32 KB. Registers in a consumer thread at D = 96: dv's
// accumulator (48 f32) beside s^T of 64 keys x 64 queries (32 f32) and P^T's
// bf16 A fragments (16). ptxas reports 128 registers at launch and no
// spills at any head width (the build report,
// `build/tdspa_torch/attention_backward.log`, and PERF.md): every
// accumulator is zeroed before its first product, since one left undefined
// is merged by the compiler with the other phases' and the merged value
// stays live, spilled, around every wgmma.
//
// Larger shapes: with one key chunk (K <= ROWS) the same kernel writes f32
// partial dk and dv per query chunk, summed in chunk order by
// sum_chunks_kernel. With more than one key chunk (the latents'
// cross-attention over 2048 keys) a row-statistics pass (the same kernel in
// STATS mode: phase 1 only) writes each (query chunk, key chunk)'s f32
// (m, l, sum P dP); the main pass (CHUNK mode) merges them in chunk order per
// query row, runs phase 1 on its key chunk for dP^T alone, then phases 2 and
// 3, and writes f32 partial dq, summed in chunk order (deterministic: no
// atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int CONSUMERS = 3;                        // warpgroups 1-3 compute
constexpr int CTHREADS = 128 * CONSUMERS;
constexpr int THREADS = 128 + CTHREADS;             // warpgroup 0 loads and converts
constexpr int PIECES = 4;                           // g arrives in 4 f32 pieces
constexpr float L2E = 1.4426950408889634f;

// What a launch computes: FULL = phases 1-3 over one key chunk; STATS = phase
// 1 only, writing partial row statistics; CHUNK = the merged statistics of
// every key chunk, phase 1 for dP^T alone, then phases 2-3.
constexpr int FULL = 0, STATS = 1, CHUNK = 2;

// mbarriers: TMA arrivals, the converters' hand-offs, and the consumers'
// releases of the tiles they no longer read.
enum Bar {
  Q_FULL, STAGE_FULL0, STAGE_FULL1, STAGE_EMPTY0, STAGE_EMPTY1, G_READY, K_FULL, V_FULL,
  STATES_FULL, V_EMPTY, G_EMPTY, Q_EMPTY, KDS_EMPTY, BARS
};

// The layout for head width DP (D rounded up to 32).
template <int DP>
struct Cfg {
  static constexpr int ROWS = DP > 96 ? 128 : 192;  // query rows and keys per work item
  static constexpr int NBX = DP / 32;                 // 32-column boxes of 64-byte rows
  static constexpr int BOXB = ROWS * 64;              // bytes per box
  static constexpr int TILE = NBX * BOXB;             // bytes of q, g, k or v
  static constexpr int DS_BOXB = ROWS * 128;          // dP^T / dS^T: 64 queries x ROWS keys
  static constexpr int DS_BYTES = ROWS / 64 * DS_BOXB;
  static constexpr int KS = DP / 16;                  // k16 steps over the head width
  static constexpr int PIECE_ROWS = ROWS / PIECES;    // a g piece fills half of v's tile
  static constexpr size_t BYTES = 1024 + 4 * static_cast<size_t>(TILE) + DS_BYTES +
                                  3 * ROWS * sizeof(float) + ROWS * sizeof(float2) +
                                  BARS * sizeof(uint64_t);
};

// 2^x on the special-function unit (2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8 x 8 bf16 matrices from their mma fragments (a bf16 pair a thread)
// to shared memory transposed: lane l gives the address of stored row l % 8
// of matrix l / 8.
__device__ __forceinline__ void stmatrix_t(void* row, const uint32_t (&x)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   sm90::smem_u32(row)),
               "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3])
               : "memory");
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x / root correctly rounded, as torch's bf16 division computes it in f32,
// without the general division's range checks: rinv is the correctly rounded
// 1 / root and one fma corrects the product (Markstein), exact for a root of
// at most 8 significant bits and quotients in the normal range.
__device__ __forceinline__ float div_root(float x, float root, float rinv) {
  const float q = x * rinv;
  return fmaf(fmaf(-q, root, x), rinv, q);
}

// The descriptor of the tile at shared address `addr`, rebuilt where it is
// used: the empty asm keeps the compiler from computing every k16 step's
// descriptor ahead of a loop and holding them all in registers, which left
// too few for the accumulators (spills, and wgmma serialised around them).
__device__ __forceinline__ uint64_t desc_at(uint32_t addr, uint32_t layout, uint32_t lbo,
                                            uint32_t sbo) {
  asm volatile("" : "+r"(addr));
  return sm90::desc(addr, layout, lbo, sbo);
}
// The 64-byte-swizzled q, g, k, v tiles: K-major (rows of 64 bytes, 8-row
// groups 512 bytes apart) and N-major (rows along K; the leading offset steps
// from one 32-column box to the next); dS^T's 128-byte-swizzled boxes.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) { return desc_at(addr, 2, 16, 512); }
template <int DP>
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return desc_at(addr, 2, Cfg<DP>::BOXB, 512);
}
__device__ __forceinline__ uint64_t desc_ds(uint32_t addr) { return desc_at(addr, 1, 1024, 1024); }

// d = A B^T over the head width (KS k16 steps): the 64 rows of A at shared
// address `a` and the N rows of B at `b`, both K-major in 64-byte-swizzled
// tiles of boxes BOXB bytes apart.
template <int N, int KS, int BOXB>
__device__ __forceinline__ void product_k(float (&d)[N / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {  // 16 columns: box kk / 2, bytes 32 (kk % 2)
    const int at = (kk / 2) * BOXB + 32 * (kk % 2);
    sm90::wgmma_ss<N>(d, desc_k(a + at), desc_k(b + at), kk > 0);
  }
}
// The same for a 64-column tile of d, or only its first 32 columns when
// `half` (a last tile with at most 32 live keys or queries: S = K = 151 pads
// to 160 columns instead of 192).
template <int KS, int BOXB>
__device__ __forceinline__ void product_k_tile(float (&d)[32], uint32_t a, uint32_t b, bool half) {
  if (half) {
    product_k<32, KS, BOXB>(*reinterpret_cast<float(*)[16]>(&d[0]), a, b);
  } else {
    product_k<64, KS, BOXB>(d, a, b);
  }
}

struct Item {
  int b, h, qc, kc;
};

// Zeroes a wgmma accumulator before its first product. The product does not
// read it (scale-d 0), but an array left undefined is merged by the compiler
// with the accumulators of other phases, whose values then stay live in
// registers across the whole work item.
template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// x, hidden from the compiler's reuse of earlier values: what a store after
// a loop needs is recomputed there instead of held in registers through it.
__device__ __forceinline__ int fresh(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ Item decode(int w, int H, int q_chunks, int k_chunks) {
  Item it;
  it.kc = w % k_chunks;
  w /= k_chunks;
  it.qc = w % q_chunks;
  w /= q_chunks;
  it.h = w % H;
  it.b = w / H;
  return it;
}

// Writes a warpgroup's 64-row f32 accumulator (this warp's rows row0 +
// lane / 4, +8; DP / 8 column blocks) to f32 rows of [B, N, H, D]: the
// partial sums of one chunk, which sum_chunks_kernel adds up.
template <int DP>
__device__ __forceinline__ void store_partial_rows(const float (&acc)[DP / 2], float* part, int b,
                                                   int h, int row0, int N, int H, int D) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = row0 + g + 8 * r;
    if (n >= N) continue;
    const long long at = ((static_cast<long long>(b) * N + n) * H + h) * D + 2 * t4;
    float2* row = reinterpret_cast<float2*>(part + at);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j < D) row[4 * j] = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// Writes this warp's rows row0 + 16 (warp % 4) + lane / 4, +8 of a
// warpgroup's f32 accumulator as bf16 (divided by `root` after one rounding
// when root > 0) into a q, g, k or v tile's layout (32-column boxes of
// 64-byte rows, 64-byte swizzle), from which a TMA store writes them out.
template <int DP>
__device__ __forceinline__ void stage_rows(const float (&acc)[DP / 2], uint8_t* tile, int row0,
                                           float root, float rinv) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int warp = (threadIdx.x / 32) % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * warp + g + 8 * r;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      float x0 = acc[4 * j + 2 * r], x1 = acc[4 * j + 2 * r + 1];
      if (root > 0.f) {
        x0 = div_root(round_bf16(x0), root, rinv);
        x1 = div_root(round_bf16(x1), root, rinv);
      }
      *reinterpret_cast<uint32_t*>(tile + (j / 4) * Cfg<DP>::BOXB + row * 64 +
                                   (((j % 4) ^ ((row >> 1) & 3)) << 4) + 4 * t4) =
          pack_bf16(x0, x1);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1) attention_backward_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_g,
    const __grid_constant__ CUtensorMap map_dq, const __grid_constant__ CUtensorMap map_dk,
    const __grid_constant__ CUtensorMap map_dv, const uint8_t* __restrict__ mask,
    __nv_bfloat16* __restrict__ dq,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, float* __restrict__ dq_part,
    float* __restrict__ dk_part, float* __restrict__ dv_part, float4* __restrict__ stats, int B,
    int S, int K, int H, int D, int q_chunks, int k_chunks, int mode, float root) {
  using L = Cfg<DP>;
  constexpr int ROWS = L::ROWS, NBX = L::NBX, BOXB = L::BOXB, TILE = L::TILE, KS = L::KS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = sm90::align1024(smem_raw);  // qs (q until converted)
  uint8_t* g_s = q_s + TILE;                 // bf16(g)
  uint8_t* k_s = g_s + TILE;
  uint8_t* v_s = k_s + TILE;                 // v, or the two g stages before it
  uint8_t* ds_s = v_s + TILE;                // dP^T, then dS^T: [query / 64][key][query % 64]
  float* m_s = reinterpret_cast<float*>(ds_s + L::DS_BYTES);  // per query: row max
  float* rl_s = m_s + ROWS;                                     // 1 / row sum
  float* dd_s = rl_s + ROWS;                                    // D_ = rowsum(dP o P)
  // Per key (c, b): its logit is s c + b (attend (1, 0), masked (0, -FLT_MAX),
  // past K (0, -inf)).
  float2* key_s = reinterpret_cast<float2*>(dd_s + ROWS);
  uint64_t* bar = reinterpret_cast<uint64_t*>(key_s + ROWS);

  // Warpgroup and warp indices through a shuffle, so that the compiler sees
  // them warp-uniform and keeps the branches on them free of divergence.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) % 4, 0), lane = threadIdx.x % 32;
  const int work = B * H * q_chunks * k_chunks;
  const float rinv = __fdiv_rn(1.f, root);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < BARS; ++i) {
      sm90::mbar_init(&bar[i], i == G_READY || i == STAGE_EMPTY0 || i == STAGE_EMPTY1 ? 2
                               : i == STATES_FULL                             ? 32
                               : i >= V_EMPTY                                 ? 4 * CONSUMERS
                                                                              : 1);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    sm90::setmaxnreg_dec<32>();
    if (warp == 0) {  // TMA: the g pieces through v's tile, then v
      if (lane == 0) {
        uint32_t n = 0, piece = 0;
        for (int w = blockIdx.x; w < work; w += gridDim.x, ++n) {
          const Item it = decode(w, H, q_chunks, k_chunks);
          const int q0 = it.qc * ROWS, k0 = it.kc * ROWS;
          sm90::mbar_wait(&bar[V_EMPTY], (n & 1) ^ 1);  // phase 1 no longer reads v
          for (int p = 0; p < PIECES; ++p, ++piece) {
            const int st = piece & 1;
            sm90::mbar_wait(&bar[STAGE_EMPTY0 + st], ((piece >> 1) & 1) ^ 1);
            sm90::mbar_expect_tx(&bar[STAGE_FULL0 + st], L::PIECE_ROWS * D * 4);
            sm90::tma_load_4d(v_s + st * (TILE / 2), &map_g, &bar[STAGE_FULL0 + st], 0, it.h,
                              q0 + p * L::PIECE_ROWS, it.b);
          }
          sm90::mbar_wait(&bar[G_READY], n & 1);  // v's tile no longer stages g
          sm90::mbar_expect_tx(&bar[V_FULL], TILE);
          for (int nb = 0; nb < NBX; ++nb) {
            sm90::tma_load_4d(v_s + nb * BOXB, &map_v, &bar[V_FULL], 32 * nb, it.h, k0, it.b);
          }
        }
      }
    } else if (warp == 1) {  // the key states, then TMA: q, k
      uint32_t n = 0;
      for (int w = blockIdx.x; w < work; w += gridDim.x, ++n) {
        const Item it = decode(w, H, q_chunks, k_chunks);
        const int q0 = it.qc * ROWS, k0 = it.kc * ROWS, keys = min(ROWS, K - k0);
        const uint8_t* mrow = mask == nullptr ? nullptr : mask + static_cast<long long>(it.b) * K;
        sm90::mbar_wait(&bar[G_EMPTY], (n & 1) ^ 1);  // phase 2 no longer reads them
        for (int r = lane; r < ROWS; r += 32) {
          key_s[r] = r >= keys ? make_float2(0.f, -INFINITY)
                     : (mrow == nullptr || mrow[k0 + r] != 0) ? make_float2(1.f, 0.f)
                                                              : make_float2(0.f, -FLT_MAX);
        }
        sm90::mbar_arrive(&bar[STATES_FULL]);
        sm90::mbar_wait(&bar[Q_EMPTY], (n & 1) ^ 1);
        if (lane == 0) {
          sm90::mbar_expect_tx(&bar[Q_FULL], TILE);
          for (int nb = 0; nb < NBX; ++nb) {
            sm90::tma_load_4d(q_s + nb * BOXB, &map_q, &bar[Q_FULL], 32 * nb, it.h, q0, it.b);
          }
        }
        sm90::mbar_wait(&bar[KDS_EMPTY], (n & 1) ^ 1);
        if (lane == 0) {
          sm90::mbar_expect_tx(&bar[K_FULL], TILE);
          for (int nb = 0; nb < NBX; ++nb) {
            sm90::tma_load_4d(k_s + nb * BOXB, &map_k, &bar[K_FULL], 32 * nb, it.h, k0, it.b);
          }
        }
      }
    } else {  // warps 2-3: g's pieces to bf16, once phase 2 no longer reads g's tile
      const int ct = threadIdx.x - 64;
      uint32_t n = 0, piece = 0;
      for (int w = blockIdx.x; w < work; w += gridDim.x, ++n) {
        sm90::mbar_wait(&bar[G_EMPTY], (n & 1) ^ 1);
        for (int p = 0; p < PIECES; ++p, ++piece) {
          const int st = piece & 1;
          sm90::mbar_wait(&bar[STAGE_FULL0 + st], (piece >> 1) & 1);
          const float* src = reinterpret_cast<const float*>(v_s + st * (TILE / 2));
          // Row r, columns 8 c8 .. +7 of the piece into row R of g's tile: box
          // c8 / 4, 16-byte chunk (c8 % 4) ^ ((R / 2) % 4) (the 64-byte swizzle).
          constexpr int CHUNKS = L::PIECE_ROWS * (DP / 8);
          for (int c0 = ct; c0 < CHUNKS; c0 += 128) {  // two independent chunks a step
            float4 a[2], z[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int c = c0 + 64 * u, r = c / (DP / 8), c8 = c % (DP / 8);
              a[u] = z[u] = make_float4(0.f, 0.f, 0.f, 0.f);
              if (c < CHUNKS && 8 * c8 < D) {
                a[u] = *reinterpret_cast<const float4*>(src + r * D + 8 * c8);
                z[u] = *reinterpret_cast<const float4*>(src + r * D + 8 * c8 + 4);
              }
            }
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int c = c0 + 64 * u, c8 = c % (DP / 8), row = p * L::PIECE_ROWS + c / (DP / 8);
              if (c < CHUNKS) {
                *reinterpret_cast<uint4*>(g_s + (c8 / 4) * BOXB + row * 64 +
                                          (((c8 % 4) ^ ((row >> 1) & 3)) << 4)) =
                    make_uint4(pack_bf16(a[u].x, a[u].y), pack_bf16(a[u].z, a[u].w),
                               pack_bf16(z[u].x, z[u].y), pack_bf16(z[u].z, z[u].w));
              }
            }
          }
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(&bar[STAGE_EMPTY0 + st]);
        }
        sm90::fence_proxy_async();  // visible to wgmma
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&bar[G_READY]);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<160>();
  const uint32_t qa = sm90::smem_u32(q_s), ga = sm90::smem_u32(g_s), ka = sm90::smem_u32(k_s),
                 va = sm90::smem_u32(v_s), dsa = sm90::smem_u32(ds_s);
  const int c = wg - 1;  // this warpgroup's 64 query rows (phases 1, 3) and keys (phases 2, 3)
  const int g = lane / 4, t4 = lane % 4;
  const int tid = threadIdx.x - 128;
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&bar[i]);
  };
  // The byte of (query row `q`, key `key`) in the dP^T / dS^T buffer: row
  // `key` of box q / 64, 16-byte chunk (q % 64 / 8) ^ (key % 8) (the 128-byte
  // swizzle).
  auto ds_at = [&](int q, int key) {
    const int cq = q & 63;
    return ds_s + (q >> 6) * L::DS_BOXB + key * 128 + ((((cq >> 3) ^ key) & 7) << 4) +
           (cq & 7) * 2;
  };
  // One chunk's f32 partial sums of dk, dv (over its queries) and dq (over
  // its keys).
  const long long kpart = static_cast<long long>(B) * K * H * D;
  const long long qpart = static_cast<long long>(B) * S * H * D;
  int w_cur = blockIdx.x;  // the work item being computed
  // One output's 64 rows of this warpgroup: f32 partial rows straight to
  // device memory; bf16 rows staged in `tile` (free: every warpgroup is done
  // reading it) and written by one TMA store, whose reads of the tile end
  // before the warpgroup goes on. Then the tile's barrier is released.
  auto emit = [&](const float (&acc)[DP / 2], bool live, float* part, const CUtensorMap* map,
                  uint8_t* tile, int row0, int N, int n0, float rt, int empty) {
    const Item at = decode(fresh(w_cur), H, q_chunks, k_chunks);
    if (part != nullptr) {
      if (live) {
        store_partial_rows<DP>(acc, part, at.b, at.h, n0 + row0 + 16 * warp, N, H, D);
      }
    } else {
      if (live) stage_rows<DP>(acc, tile, row0, rt, rinv);
      sm90::fence_proxy_async();  // the staged rows, visible to the TMA store
      sm90::named_sync(6 + c, 128);
      if (live && threadIdx.x % 128 == 0) {
        for (int nb = 0; nb < NBX; ++nb) {
          sm90::tma_store_4d(map, tile + nb * BOXB + row0 * 64, 32 * nb, at.h, n0 + row0, at.b);
        }
        sm90::bulk_commit();
        sm90::bulk_wait_read<0>();
      }
      sm90::named_sync(6 + c, 128);
    }
    release(empty);
  };
  uint32_t n = 0;
  for (int w = blockIdx.x; w < work; w += gridDim.x, ++n) {
    w_cur = w;
    const Item it = decode(w, H, q_chunks, k_chunks);
    const int q0 = it.qc * ROWS, rows = min(ROWS, S - q0);
    const int k0 = it.kc * ROWS, keys = min(ROWS, K - k0);
    const uint32_t par = n & 1;
    // qs = bf16(q / root) in place, by all consumer threads (elementwise: the
    // swizzle does not matter); then every tile of the item.
    sm90::mbar_wait(&bar[Q_FULL], par);
    for (int i = tid; i < TILE / 16; i += CTHREADS) {
      uint4* at = reinterpret_cast<uint4*>(q_s) + i;
      uint4 x = *at;
      uint32_t* xw = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&xw[e]));
        xw[e] = pack_bf16(div_root(f.x, root, rinv), div_root(f.y, root, rinv));
      }
      *at = x;
    }
    sm90::fence_proxy_async();  // visible to wgmma
    sm90::mbar_wait(&bar[G_READY], par);
    sm90::mbar_wait(&bar[K_FULL], par);
    sm90::mbar_wait(&bar[V_FULL], par);
    sm90::mbar_wait(&bar[STATES_FULL], par);
    sm90::named_sync(1, CTHREADS);  // every row of qs is in place

    // ---- phase 1 (this warpgroup's 64 query rows): s = qs k^T and dP = g v^T
    // per 64-key tile; the row statistics; bf16(dP) into the dP^T buffer ----
    float m_run[2] = {-FLT_MAX, -FLT_MAX}, l_run[2] = {0.f, 0.f}, d_run[2] = {0.f, 0.f};
    const int r0 = 64 * c;
    if (r0 < rows) {
#pragma unroll 1
      for (int t = 0; 64 * t < keys; ++t) {
        const bool half = keys - 64 * t <= 32;
        float s[32], dp[32];
        zero(s);
        zero(dp);
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        sm90::wgmma_fence();
        product_k_tile<KS, BOXB>(s, qa + r0 * 64, ka + t * 64 * 64, half);
        sm90::wgmma_commit();
        product_k_tile<KS, BOXB>(dp, ga + r0 * 64, va + t * 64 * 64, half);
        sm90::wgmma_commit();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        sm90::wgmma_wait<1>();  // s is done; dP runs on under the softmax
        sm90::fence_regs(s);
        // Element 4j + e: row g (+8 for e >= 2), key 64 t + 8 j + 2 t4 + (e & 1).
        const float4* cb4 = reinterpret_cast<const float4*>(key_s + 64 * t);
        float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (half && j >= 4) continue;
          const float4 cb = cb4[4 * j + t4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x =
                (e & 1) ? fmaf(s[4 * j + e], cb.z, cb.w) : fmaf(s[4 * j + e], cb.x, cb.y);
            s[4 * j + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float alpha = ex2((m_run[r] - mx[r]) * L2E);
          l_run[r] *= alpha;
          d_run[r] *= alpha;
          m_run[r] = mx[r];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (half && i >= 16) continue;
          s[i] = ex2((s[i] - m_run[(i >> 1) & 1]) * L2E);
          l_run[(i >> 1) & 1] += s[i];
        }
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (half && i >= 16) continue;
          d_run[(i >> 1) & 1] += s[i] * round_bf16(dp[i]);
        }
        if (mode != STATS) {
          // bf16(dP) into the dP^T buffer for the key pass, transposed by
          // stmatrix: the fragments of key blocks j0, j0 + 1 (rows g and
          // g + 8) are four 8 x 8 matrices; lane l gives the address of key
          // row l % 8 of matrix l / 8, whose 8 queries are one 16-byte chunk.
          const int m = lane / 8, key0 = 64 * t + (m / 2) * 8 + lane % 8;
          const int q = r0 + 16 * warp + 8 * (m % 2);
#pragma unroll
          for (int j0 = 0; j0 < 8; j0 += 2) {
            if (half && j0 >= 4) continue;
            const uint32_t x[4] = {pack_bf16(dp[4 * j0], dp[4 * j0 + 1]),
                                   pack_bf16(dp[4 * j0 + 2], dp[4 * j0 + 3]),
                                   pack_bf16(dp[4 * j0 + 4], dp[4 * j0 + 5]),
                                   pack_bf16(dp[4 * j0 + 6], dp[4 * j0 + 7])};
            stmatrix_t(ds_at(q, key0 + 8 * j0), x);
          }
        }
      }
    }
    sm90::fence_proxy_async();
    release(V_EMPTY);  // v is free for the next item
    if (mode != CHUNK) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        d_run[r] += __shfl_xor_sync(0xffffffffu, d_run[r], 1);
        d_run[r] += __shfl_xor_sync(0xffffffffu, d_run[r], 2);
        const int row = r0 + 16 * warp + g + 8 * r;
        if (t4 != 0) continue;
        if (mode == STATS) {
          if (row < rows) {
            stats[((static_cast<long long>(it.kc) * B + it.b) * H + it.h) * S + q0 + row] =
                make_float4(m_run[r], l_run[r], d_run[r], 0.f);
          }
        } else {  // rows past S: P = 0 in phase 2
          const bool live = row < rows;
          m_s[row] = live ? m_run[r] : 0.f;
          rl_s[row] = live ? 1.f / l_run[r] : 0.f;
          dd_s[row] = live ? d_run[r] / l_run[r] : 0.f;
        }
      }
      if (mode == STATS) {
        release(G_EMPTY);
        release(Q_EMPTY);
        release(KDS_EMPTY);
        continue;
      }
    } else {
      // ---- the statistics of every key chunk, merged in chunk order ----
      const long long chunk = static_cast<long long>(B) * H * S;
      for (int r = tid; r < ROWS; r += CTHREADS) {
        float m = 0.f, rl = 0.f, dd = 0.f;
        if (r < rows) {
          const float4* st = stats + (static_cast<long long>(it.b) * H + it.h) * S + q0 + r;
          m = -FLT_MAX;
          for (int i = 0; i < k_chunks; ++i) m = fmaxf(m, st[i * chunk].x);
          float l = 0.f, d = 0.f;
          for (int i = 0; i < k_chunks; ++i) {
            const float4 x = st[i * chunk];
            const float a = ex2((x.x - m) * L2E);
            l += a * x.y;
            d += a * x.z;
          }
          rl = 1.f / l;
          dd = d / l;
        }
        m_s[r] = m;
        rl_s[r] = rl;
        dd_s[r] = dd;
      }
    }
    sm90::named_sync(2, CTHREADS);  // the statistics and dP^T of every row are in place

    // ---- phase 2 (this warpgroup's 64 keys): per 64 queries s^T = k qs^T,
    // P^T, dS^T = P^T (dP^T - D_) over dP^T in place, and dv += bf16(P^T) g
    // with P^T as the register A operand ----
    const int kr = 64 * c;
    float acc_v[DP / 2];  // dv of this warpgroup's 64 keys
    zero(acc_v);
    if (kr < keys) {
      float (&acc)[DP / 2] = acc_v;
      const float2 ks[2] = {key_s[kr + 16 * warp + g], key_s[kr + 16 * warp + g + 8]};
#pragma unroll 1
      for (int qb = 0; qb < rows; qb += 64) {
        const bool half = rows - qb <= 32;
        float st[32];
        zero(st);
        sm90::fence_regs(st);
        sm90::wgmma_fence();
        product_k_tile<KS, BOXB>(st, ka + kr * 64, qa + qb * 64, half);
        sm90::wgmma_commit();
        sm90::fence_regs(st);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(st);
        // Element 4j + e: key row g (+8 for e >= 2), query qb + 8j + 2 t4 + (e & 1).
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (half && j >= 4) continue;
          const int col = qb + 8 * j + 2 * t4;
          const float2 m = *reinterpret_cast<const float2*>(m_s + col);
          const float2 rl = *reinterpret_cast<const float2*>(rl_s + col);
          const float2 dd = *reinterpret_cast<const float2*>(dd_s + col);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 state = ks[r];
            uint32_t* at = reinterpret_cast<uint32_t*>(ds_at(col, kr + 16 * warp + g + 8 * r));
            const float2 dpt = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(at));
            float p[2], ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float mq = e ? m.y : m.x, rq = e ? rl.y : rl.x, dq_ = e ? dd.y : dd.x;
              p[e] = ex2((fmaf(st[4 * j + 2 * r + e], state.x, state.y) - mq) * L2E) * rq;
              ds[e] = state.x != 0.f ? p[e] * ((e ? dpt.y : dpt.x) - dq_) : 0.f;
              st[4 * j + 2 * r + e] = p[e];
            }
            *at = pack_bf16(ds[0], ds[1]);
          }
        }
        // The C fragments of two 8-query blocks are the A fragment of one k16 step.
        uint32_t pa[4][4];
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pa[kq][i] = pack_bf16(st[8 * kq + 2 * i], st[8 * kq + 2 * i + 1]);
          }
          sm90::fence_regs(pa[kq]);
        }
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
        sm90::wgmma_rs<DP>(acc, pa[0], desc_mn<DP>(ga + qb * 64), 1);
        sm90::wgmma_rs<DP>(acc, pa[1], desc_mn<DP>(ga + (qb + 16) * 64), 1);
        if (!half) {
          sm90::wgmma_rs<DP>(acc, pa[2], desc_mn<DP>(ga + (qb + 32) * 64), 1);
          sm90::wgmma_rs<DP>(acc, pa[3], desc_mn<DP>(ga + (qb + 48) * 64), 1);
        }
        sm90::wgmma_commit();
        sm90::fence_regs(acc);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
      }
    }
    sm90::fence_proxy_async();  // dS^T's stores, visible to phase 3's wgmma
    sm90::named_sync(3, CTHREADS);  // dS^T is whole; no warpgroup reads g any more
    if (dv != nullptr) {
      emit(acc_v, kr < keys, q_chunks > 1 ? dv_part + it.qc * kpart : nullptr, &map_dv, g_s, kr,
           K, k0, 0.f, G_EMPTY);
    } else {
      release(G_EMPTY);  // g and the key states are free for the next item
    }

    // ---- phase 3: dk of this warpgroup's 64 keys = dS^T qs (dS^T K-major from
    // shared memory, qs N-major), then dq of its 64 query rows = dS k (dS^T
    // read M-major, k N-major) ----
    if (dk != nullptr) {
      float acc[DP / 2];
      zero(acc);
      if (kr < keys) {
        const int steps = (rows + 15) / 16;  // 16 queries: 32 bytes of a dS^T row
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll 1
        for (int kq = 0; kq < steps; ++kq) {
          sm90::wgmma_ss<DP, 0, 1>(
              acc, desc_ds(dsa + (kq / 4) * L::DS_BOXB + kr * 128 + 32 * (kq % 4)),
              desc_mn<DP>(qa + kq * 16 * 64), kq > 0);
        }
        sm90::wgmma_commit();
        sm90::fence_regs(acc);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
      }
      sm90::named_sync(4, CTHREADS);  // no warpgroup reads qs any more
      emit(acc, kr < keys, q_chunks > 1 ? dk_part + it.qc * kpart : nullptr, &map_dk, q_s, kr, K,
           k0, 0.f, Q_EMPTY);
    } else {
      release(Q_EMPTY);
    }
    if (dq != nullptr) {
      float acc[DP / 2];
      zero(acc);
      const bool mine = 64 * c < rows;
      if (mine) {
        const int steps = (keys + 15) / 16;  // 16 keys: dS^T rows (A, M-major), k rows (B, N-major)
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll 1
        for (int kk = 0; kk < steps; ++kk) {
          sm90::wgmma_ss<DP, 1, 1>(acc, desc_ds(dsa + c * L::DS_BOXB + kk * 2048),
                                   desc_mn<DP>(ka + kk * 16 * 64), kk > 0);
        }
        sm90::wgmma_commit();
        sm90::fence_regs(acc);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
      }
      sm90::named_sync(5, CTHREADS);  // no warpgroup reads k or dS^T any more
      emit(acc, mine, k_chunks > 1 ? dq_part + it.kc * qpart : nullptr, &map_dq, k_s, 64 * c, S,
           q0, root, KDS_EMPTY);
    } else {
      release(KDS_EMPTY);
    }
  }
  if (threadIdx.x % 128 == 0) sm90::bulk_wait<0>();  // the stores are done before the block exits
}

// out[i] = bf16(sum_c part[c n + i]) over the chunks in order; divided by
// `root` after that rounding, and rounded again, when root > 0 (dq).
__global__ void __launch_bounds__(256) sum_chunks_kernel(const float* __restrict__ part,
                                                         __nv_bfloat16* __restrict__ out,
                                                         long long n, int chunks, float root) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc += part[c * n + i];
  if (root > 0.f) acc = __fdiv_rn(round_bf16(acc), root);
  out[i] = __float2bfloat16_rn(acc);
}

struct Args {
  const void *mask, *dq, *dk, *dv, *dq_part, *dk_part, *dv_part, *stats;
  int B, S, K, H, D, q_chunks, k_chunks;
  float root;
};

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* g, const Args& a,
           cudaStream_t st) {
  using L = Cfg<DP>;
  auto kernel = attention_backward_kernel<DP>;
  constexpr size_t smem = L::BYTES;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr auto BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr auto SW64 = CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap mq, mk, mv, mg;
  int rc = sm90::encode_bshd(&mq, BF16, 2, q, a.B, a.S, a.H, a.D, 32, L::ROWS, SW64);
  if (!rc) rc = sm90::encode_bshd(&mk, BF16, 2, k, a.B, a.K, a.H, a.D, 32, L::ROWS, SW64);
  if (!rc) rc = sm90::encode_bshd(&mv, BF16, 2, v, a.B, a.K, a.H, a.D, 32, L::ROWS, SW64);
  if (!rc) {
    rc = sm90::encode_bshd(&mg, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, g, a.B, a.S, a.H, a.D, a.D,
                           L::PIECE_ROWS, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  // The bf16 outputs' maps for the TMA stores of 64-row boxes (unused for an
  // output that is not computed or is summed from f32 partials).
  CUtensorMap mdq{}, mdk{}, mdv{};
  if (!rc && a.dq != nullptr && a.k_chunks == 1) {
    rc = sm90::encode_bshd(&mdq, BF16, 2, a.dq, a.B, a.S, a.H, a.D, 32, 64, SW64);
  }
  if (!rc && a.dk != nullptr && a.q_chunks == 1) {
    rc = sm90::encode_bshd(&mdk, BF16, 2, a.dk, a.B, a.K, a.H, a.D, 32, 64, SW64);
  }
  if (!rc && a.dv != nullptr && a.q_chunks == 1) {
    rc = sm90::encode_bshd(&mdv, BF16, 2, a.dv, a.B, a.K, a.H, a.D, 32, 64, SW64);
  }
  if (rc) return rc;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long work = static_cast<long long>(a.B) * a.H * a.q_chunks * a.k_chunks;
  const int grid = static_cast<int>(work < sms ? work : sms);
  auto run = [&](int mode) {
    kernel<<<grid, THREADS, smem, st>>>(
        mq, mk, mv, mg, mdq, mdk, mdv, static_cast<const uint8_t*>(a.mask),
        static_cast<__nv_bfloat16*>(const_cast<void*>(a.dq)),
        static_cast<__nv_bfloat16*>(const_cast<void*>(a.dk)),
        static_cast<__nv_bfloat16*>(const_cast<void*>(a.dv)),
        static_cast<float*>(const_cast<void*>(a.dq_part)),
        static_cast<float*>(const_cast<void*>(a.dk_part)),
        static_cast<float*>(const_cast<void*>(a.dv_part)),
        static_cast<float4*>(const_cast<void*>(a.stats)), a.B, a.S, a.K, a.H, a.D, a.q_chunks,
        a.k_chunks, mode, a.root);
    return static_cast<int>(cudaGetLastError());
  };
  if (a.k_chunks == 1) return run(FULL);
  rc = run(STATS);
  return rc ? rc : run(CHUNK);
}

int sum_chunks(const void* part, const void* out, long long n, int chunks, float root,
               cudaStream_t st) {
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sum_chunks_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(const_cast<void*>(out)), n,
      chunks, root);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t: the launches' own error, or cudaErrorInvalidValue for
// arguments the kernels do not take. q, k, v are contiguous bf16 [B, S|K, H,
// D], g contiguous f32 [B, S, H, D], mask uint8 [B, K] or null; `root` is
// bf16(sqrt(D)) as an f32. A null dq, dk or dv is not computed. A work item
// takes ROWS = 192 query rows and keys (128 for D > 96): with q_chunks =
// ceil(S / ROWS) > 1, dk_part and dv_part (f32 [q_chunks, B, K, H, D]) take
// each query chunk's partial sums; with k_chunks = ceil(K / ROWS) > 1,
// dq_part (f32 [k_chunks, B, S, H, D]) each key chunk's, and stats (f32
// [k_chunks, B, H, S, 4]) the row-statistics pass's partials; a last kernel
// sums the partials in chunk order into the bf16 outputs.
extern "C" int tdspa_attention_backward(const void* q, const void* k, const void* v,
                                        const void* mask, const void* g, void* dq, void* dk,
                                        void* dv, void* dq_part, void* dk_part, void* dv_part,
                                        void* stats, int B, int S, int K, int H, int D,
                                        float root, void* stream) {
  if (B < 1 || S < 1 || K < 1 || H < 1 || D < 8 || D > 128 || D % 8 != 0 || !(root > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dp = (D + 31) / 32 * 32, rows = dp > 96 ? 128 : 192;
  const int q_chunks = (S + rows - 1) / rows, k_chunks = (K + rows - 1) / rows;
  const long long work = static_cast<long long>(B) * H * q_chunks * k_chunks;
  if (work > 0x7fffffffLL || (k_chunks > 1 && (stats == nullptr ||
                                               (dq != nullptr && dq_part == nullptr))) ||
      (q_chunks > 1 && ((dk != nullptr && dk_part == nullptr) ||
                        (dv != nullptr && dv_part == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dq == nullptr && dk == nullptr && dv == nullptr) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const Args a{mask, dq, dk, dv, dq_part, dk_part, dv_part, stats, B, S, K, H, D,
               q_chunks, k_chunks, root};
  int err;
  switch (dp) {
    case 32: err = launch<32>(q, k, v, g, a, st); break;
    case 64: err = launch<64>(q, k, v, g, a, st); break;
    case 96: err = launch<96>(q, k, v, g, a, st); break;
    default: err = launch<128>(q, k, v, g, a, st); break;
  }
  if (err) return err;
  if (k_chunks > 1 && dq != nullptr) {
    err = sum_chunks(dq_part, dq, static_cast<long long>(B) * S * H * D, k_chunks, root, st);
    if (err) return err;
  }
  if (q_chunks > 1) {
    const long long n = static_cast<long long>(B) * K * H * D;
    if (dk != nullptr && (err = sum_chunks(dk_part, dk, n, q_chunks, 0.f, st))) return err;
    if (dv != nullptr && (err = sum_chunks(dv_part, dv, n, q_chunks, 0.f, st))) return err;
  }
  return 0;
}
