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
// device-memory bytes bound it. The design reads each input once and keeps
// P, dP and dS out of device memory.
//
// Design: one block of 10 warps per (item, head, 160-query chunk, 160-key
// chunk). At the training shapes (S, K <= 160) that is one block per
// (item, head), which holds all of its q, g, k, v in shared memory (rows
// padded by 16 bytes, so that ldmatrix reads them without bank conflicts),
// loaded once: k, v by cp.async, q scaled and g rounded to bf16 through
// registers. Three phases, each a loop over 16-row mma.sync tiles (16-row
// granularity pads S = 151 to 160, where 64-row wgmma tiles would pad it to
// 192 and do 1.4 times the products):
//   1. query rows (warp w: rows 16w..+15): s = qs k^T and dP = g v^T over
//      every key, the online row max m, sum l and sum of e dP (rescaled as
//      the max grows), kept as (m, 1/l, D_) per row in shared memory;
//   2. key rows (warp w: keys 16w..+15, as FlashAttention-2's backward):
//      s^T = k qs^T and dP^T = v g^T per 32 queries, P^T and dS^T in
//      registers, then dv += bf16(P^T) g and dk += bf16(dS^T) qs with the
//      accumulators in registers, the C fragments reused as A fragments;
//      dS^T is kept in shared memory (bf16);
//   3. query rows again: dq = dS k (ldmatrix.trans of dS^T and k), whole
//      over the chunk's keys, so no atomics.
// Every product is bf16 mma.sync m16n8k16 with f32 accumulation.
//
// Larger shapes split into chunks: with more than one key chunk (the
// latents' cross-attention over 2048 keys) phase 1 walks every key chunk
// (reloading k, v), each block writes its chunk's f32 partial dS k, and a
// second kernel sums the partials in chunk order and rounds them
// (deterministic: no atomics); more than one query chunk does the same for
// dk and dv.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 160;            // query rows and keys per chunk
constexpr int WARPS = ROWS / 16;     // one 16-row mma tile per warp in each phase
constexpr int THREADS = 32 * WARPS;
constexpr float L2E = 1.4426950408889634f;

// Key states in shared memory.
constexpr int ATTEND = 0, MASKED = 1, PAST_K = 2;

// Shared memory of the kernel for head width DP (D rounded up to 32).
template <int DP>
struct Smem {
  static constexpr int PITCH = DP + 8;          // bf16 per row of q, g, k, v
  static constexpr int DS_PITCH = ROWS + 8;     // bf16 per row of dS^T
  static constexpr int TILE = ROWS * PITCH;     // bf16 per tensor
  static constexpr int QG = DP > 96 ? 16 : 32;  // queries per step of phase 2
  static constexpr size_t BYTES = 4 * static_cast<size_t>(TILE) * 2 +
                                  static_cast<size_t>(ROWS) * DS_PITCH * 2 + 3 * ROWS * 4 +
                                  ROWS * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, f32 accumulation. Element
// e of d lies in row lane / 4 (+8 for e >= 2), column 2 (lane % 4) + (e & 1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

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

__device__ __forceinline__ long long row_index(int b, int n, int h, int N, int H) {
  return (static_cast<long long>(b) * N + n) * H + h;
}

// Writes a 16-row tile's f32 accumulators (rows row0 + lane / 4, +8; DP / 8
// column blocks) to bf16 rows of [B, N, H, D] (divided by `root` after one
// rounding when root > 0), or, when `part` is given, to its f32 rows.
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 8][4], __nv_bfloat16* out,
                                           float* part, int b, int h, int row0, int N, int H,
                                           int D, float root, float rinv) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = row0 + g + 8 * r;
    if (n >= N) continue;
    const long long base = row_index(b, n, h, N, H) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * t4;
      if (d >= D) continue;
      float x0 = acc[j][2 * r], x1 = acc[j][2 * r + 1];
      if (part != nullptr) {
        *reinterpret_cast<float2*>(part + base + d) = make_float2(x0, x1);
        continue;
      }
      if (root > 0.f) {
        x0 = div_root(round_bf16(x0), root, rinv);
        x1 = div_root(round_bf16(x1), root, rinv);
      }
      *reinterpret_cast<uint32_t*>(out + base + d) = pack_bf16(x0, x1);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1) attention_backward_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
    const float* __restrict__ g, __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, float* __restrict__ dq_part, float* __restrict__ dk_part,
    float* __restrict__ dv_part, int B, int S, int K, int H, int D, int q_chunks, int k_chunks,
    float root) {
  using L = Smem<DP>;
  constexpr int PITCH = L::PITCH, DS_PITCH = L::DS_PITCH, QG = L::QG;
  constexpr int KSTEPS = DP / 16;          // k16 steps over the head width
  constexpr int LOADS = ROWS * DP / 8 / THREADS;  // 16-byte row pieces per thread per tensor
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // qs rows
  __nv_bfloat16* g_s = q_s + L::TILE;                                 // bf16(g) rows
  __nv_bfloat16* k_s = g_s + L::TILE;
  __nv_bfloat16* v_s = k_s + L::TILE;
  __nv_bfloat16* ds_s = v_s + L::TILE;  // dS^T [key][query]
  float* m_s = reinterpret_cast<float*>(ds_s + ROWS * DS_PITCH);  // per query: row max
  float* rl_s = m_s + ROWS;                                       // 1 / row sum
  float* dd_s = rl_s + ROWS;                                      // rowsum(dP o P)
  int* key_s = reinterpret_cast<int*>(dd_s + ROWS);               // per key: its state

  int w = blockIdx.x;
  const int kc = w % k_chunks;
  w /= k_chunks;
  const int qc = w % q_chunks;
  w /= q_chunks;
  const int h = w % H, b = w / H;
  const int q0 = qc * ROWS, rows = min(ROWS, S - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, t4 = lane % 4;
  const float rinv = __fdiv_rn(1.f, root);

  // ---- qs and bf16(g) of the chunk's query rows, zero past S and D ----
  {
    uint4 qv[LOADS];
    float4 gv[LOADS][2];
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int piece = threadIdx.x + i * THREADS, r = piece / (DP / 8), c = piece % (DP / 8) * 8;
      qv[i] = make_uint4(0, 0, 0, 0);
      gv[i][0] = gv[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && c < D) {
        const long long at = row_index(b, q0 + r, h, S, H) * D + c;
        qv[i] = __ldg(reinterpret_cast<const uint4*>(q + at));
        gv[i][0] = __ldg(reinterpret_cast<const float4*>(g + at));
        gv[i][1] = __ldg(reinterpret_cast<const float4*>(g + at + 4));
      }
    }
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int piece = threadIdx.x + i * THREADS, r = piece / (DP / 8), c = piece % (DP / 8) * 8;
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&qv[i]);
      uint4 qs;
      uint32_t* qw = reinterpret_cast<uint32_t*>(&qs);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(x[e]);
        qw[e] = pack_bf16(div_root(f.x, root, rinv), div_root(f.y, root, rinv));
      }
      *reinterpret_cast<uint4*>(q_s + r * PITCH + c) = qs;
      *reinterpret_cast<uint4*>(g_s + r * PITCH + c) =
          make_uint4(pack_bf16(gv[i][0].x, gv[i][0].y), pack_bf16(gv[i][0].z, gv[i][0].w),
                     pack_bf16(gv[i][1].x, gv[i][1].y), pack_bf16(gv[i][1].z, gv[i][1].w));
    }
  }

  // k and v of key chunk c (zero past K and D) and its keys' states; returns
  // the chunk's key count.
  auto load_kv = [&](int c) {
    const int k0 = c * ROWS, keys = min(ROWS, K - k0);
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int piece = threadIdx.x + i * THREADS, r = piece / (DP / 8), col = piece % (DP / 8) * 8;
      const bool live = r < keys && col < D;
      const long long at = live ? row_index(b, k0 + r, h, K, H) * D + col : 0;
      cp_async16(k_s + r * PITCH + col, k + at, live ? 16 : 0);
      cp_async16(v_s + r * PITCH + col, v + at, live ? 16 : 0);
    }
    for (int r = threadIdx.x; r < ROWS; r += THREADS) {
      key_s[r] = r >= keys ? PAST_K
                 : (mask == nullptr || mask[static_cast<long long>(b) * K + k0 + r] != 0) ? ATTEND
                                                                                         : MASKED;
    }
    cp_async_wait_all();
    return keys;
  };

  // ---- phase 1: the row statistics, over every key chunk ----
  float m_run[2] = {-FLT_MAX, -FLT_MAX}, l_run[2] = {0.f, 0.f}, d_run[2] = {0.f, 0.f};
  const bool my_rows = 16 * warp < rows;
  int keys = 0;
  for (int c = 0; c < k_chunks; ++c) {
    if (c > 0) __syncthreads();  // every warp is done with the last chunk's k, v
    keys = load_kv(k_chunks == 1 ? kc : c);
    __syncthreads();
    if (!my_rows) continue;
    uint32_t aq[KSTEPS][4], ag[KSTEPS][4];  // this warp's qs and g rows as A fragments
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int r = 16 * warp + lane % 8 + (lane / 8) % 2 * 8, col = 16 * kk + lane / 16 * 8;
      ldsm_x4(aq[kk], q_s + r * PITCH + col);
      ldsm_x4(ag[kk], g_s + r * PITCH + col);
    }
    for (int kb = 0; kb < keys; kb += 32) {
      float s[4][4] = {}, dp[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = kb + 16 * half + lane % 8 + lane / 16 * 8;
          const int col = 16 * kk + (lane / 8) % 2 * 8;
          uint32_t bk[4], bv[4];
          ldsm_x4(bk, k_s + r * PITCH + col);
          ldsm_x4(bv, v_s + r * PITCH + col);
          mma(s[2 * half], aq[kk], bk[0], bk[1]);
          mma(s[2 * half + 1], aq[kk], bk[2], bk[3]);
          mma(dp[2 * half], ag[kk], bv[0], bv[1]);
          mma(dp[2 * half + 1], ag[kk], bv[2], bv[3]);
        }
      }
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int2 states = *reinterpret_cast<const int2*>(key_s + kb + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int state = (e & 1) ? states.y : states.x;
          const float x = state == ATTEND ? s[j][e] : state == MASKED ? -FLT_MAX : -INFINITY;
          s[j][e] = x;
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
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2((s[j][e] - m_run[e >> 1]) * L2E);
          l_run[e >> 1] += p;
          d_run[e >> 1] += p * round_bf16(dp[j][e]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    d_run[r] += __shfl_xor_sync(0xffffffffu, d_run[r], 1);
    d_run[r] += __shfl_xor_sync(0xffffffffu, d_run[r], 2);
    const int row = 16 * warp + gq + 8 * r;
    if (t4 == 0) {  // rows past S: P = 0 in phase 2
      const bool live = row < rows;
      m_s[row] = live ? m_run[r] : 0.f;
      rl_s[row] = live ? 1.f / l_run[r] : 0.f;
      dd_s[row] = live ? d_run[r] / l_run[r] : 0.f;
    }
  }
  if (k_chunks > 1) {  // back to this block's own key chunk
    __syncthreads();
    keys = load_kv(kc);
  }
  __syncthreads();

  // ---- phase 2: dv and dk of this warp's 16 keys, dS^T into shared memory ----
  if (16 * warp < keys) {
    float acc_v[DP / 8][4] = {}, acc_k[DP / 8][4] = {};
    const int state[2] = {key_s[16 * warp + gq], key_s[16 * warp + gq + 8]};
    for (int qb = 0; qb < rows; qb += QG) {
      float st[QG / 8][4] = {}, dpt[QG / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t ak[4], av[4];
        const int r = 16 * warp + lane % 8 + (lane / 8) % 2 * 8, col = 16 * kk + lane / 16 * 8;
        ldsm_x4(ak, k_s + r * PITCH + col);
        ldsm_x4(av, v_s + r * PITCH + col);
#pragma unroll
        for (int half = 0; half < QG / 16; ++half) {
          const int rq = qb + 16 * half + lane % 8 + lane / 16 * 8;
          const int cq = 16 * kk + (lane / 8) % 2 * 8;
          uint32_t bq[4], bg[4];
          ldsm_x4(bq, q_s + rq * PITCH + cq);
          ldsm_x4(bg, g_s + rq * PITCH + cq);
          mma(st[2 * half], ak, bq[0], bq[1]);
          mma(st[2 * half + 1], ak, bq[2], bq[3]);
          mma(dpt[2 * half], av, bg[0], bg[1]);
          mma(dpt[2 * half + 1], av, bg[2], bg[3]);
        }
      }
      // P^T and dS^T: rows are keys (their states), columns queries (their
      // statistics).
#pragma unroll
      for (int j = 0; j < QG / 8; ++j) {
        const int col = qb + 8 * j + 2 * t4;
        const float2 m = *reinterpret_cast<const float2*>(m_s + col);
        const float2 rl = *reinterpret_cast<const float2*>(rl_s + col);
        const float2 dd = *reinterpret_cast<const float2*>(dd_s + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ks = state[e >> 1];
          const float mq = (e & 1) ? m.y : m.x, rq = (e & 1) ? rl.y : rl.x;
          const float dq_ = (e & 1) ? dd.y : dd.x;
          const float x = ks == MASKED ? -FLT_MAX : st[j][e];
          const float p = ks == PAST_K ? 0.f : ex2((x - mq) * L2E) * rq;
          st[j][e] = p;
          dpt[j][e] = ks == ATTEND ? p * (round_bf16(dpt[j][e]) - dq_) : 0.f;
        }
        uint32_t* ds_row = reinterpret_cast<uint32_t*>(ds_s + (16 * warp + gq) * DS_PITCH + col);
        ds_row[0] = pack_bf16(dpt[j][0], dpt[j][1]);
        ds_row[4 * DS_PITCH] = pack_bf16(dpt[j][2], dpt[j][3]);  // 8 rows on
      }
      // dv += bf16(P^T) g and dk += bf16(dS^T) qs: the C fragments of two
      // 8-query blocks are the A fragment of one k16 step.
#pragma unroll
      for (int kq = 0; kq < QG / 16; ++kq) {
        const uint32_t pa[4] = {pack_bf16(st[2 * kq][0], st[2 * kq][1]),
                                pack_bf16(st[2 * kq][2], st[2 * kq][3]),
                                pack_bf16(st[2 * kq + 1][0], st[2 * kq + 1][1]),
                                pack_bf16(st[2 * kq + 1][2], st[2 * kq + 1][3])};
        const uint32_t sa[4] = {pack_bf16(dpt[2 * kq][0], dpt[2 * kq][1]),
                                pack_bf16(dpt[2 * kq][2], dpt[2 * kq][3]),
                                pack_bf16(dpt[2 * kq + 1][0], dpt[2 * kq + 1][1]),
                                pack_bf16(dpt[2 * kq + 1][2], dpt[2 * kq + 1][3])};
        const int r = qb + 16 * kq + lane % 8 + (lane / 8) % 2 * 8;
#pragma unroll
        for (int np = 0; np < DP / 16; ++np) {
          const int col = 16 * np + lane / 16 * 8;
          uint32_t bg[4], bq[4];
          ldsm_x4_t(bg, g_s + r * PITCH + col);
          ldsm_x4_t(bq, q_s + r * PITCH + col);
          mma(acc_v[2 * np], pa, bg[0], bg[1]);
          mma(acc_v[2 * np + 1], pa, bg[2], bg[3]);
          mma(acc_k[2 * np], sa, bq[0], bq[1]);
          mma(acc_k[2 * np + 1], sa, bq[2], bq[3]);
        }
      }
    }
    const int k0 = kc * ROWS;
    const long long kpart = static_cast<long long>(qc) * B * K * H * D;
    if (dv != nullptr) {
      store_rows<DP>(acc_v, dv, q_chunks > 1 ? dv_part + kpart : nullptr, b, h,
                     k0 + 16 * warp, K, H, D, 0.f, 0.f);
    }
    if (dk != nullptr) {
      store_rows<DP>(acc_k, dk, q_chunks > 1 ? dk_part + kpart : nullptr, b, h,
                     k0 + 16 * warp, K, H, D, 0.f, 0.f);
    }
  }
  if (dq == nullptr) return;
  __syncthreads();

  // ---- phase 3: dq of this warp's 16 query rows over the chunk's keys ----
  if (!my_rows) return;
  float acc_q[DP / 8][4] = {};
  for (int kb = 0; kb < keys; kb += 16) {
    uint32_t a[4];
    ldsm_x4_t(a, ds_s + (kb + lane % 8 + lane / 16 * 8) * DS_PITCH + 16 * warp +
                     (lane / 8) % 2 * 8);
    const int r = kb + lane % 8 + (lane / 8) % 2 * 8;
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      uint32_t bk[4];
      ldsm_x4_t(bk, k_s + r * PITCH + 16 * np + lane / 16 * 8);
      mma(acc_q[2 * np], a, bk[0], bk[1]);
      mma(acc_q[2 * np + 1], a, bk[2], bk[3]);
    }
  }
  const long long qpart = static_cast<long long>(kc) * B * S * H * D;
  store_rows<DP>(acc_q, dq, k_chunks > 1 ? dq_part + qpart : nullptr, b, h, q0 + 16 * warp, S,
                 H, D, root, rinv);
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

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* mask, const void* g, void* dq,
           void* dk, void* dv, void* dq_part, void* dk_part, void* dv_part, int B, int S, int K,
           int H, int D, int q_chunks, int k_chunks, float root, cudaStream_t st) {
  auto kernel = attention_backward_kernel<DP>;
  constexpr size_t smem = Smem<DP>::BYTES;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long blocks = static_cast<long long>(B) * H * q_chunks * k_chunks;
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(g), static_cast<__nv_bfloat16*>(dq),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      static_cast<float*>(dq_part), static_cast<float*>(dk_part), static_cast<float*>(dv_part), B,
      S, K, H, D, q_chunks, k_chunks, root);
  return static_cast<int>(cudaGetLastError());
}

int sum_chunks(const void* part, void* out, long long n, int chunks, float root, cudaStream_t st) {
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sum_chunks_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out), n, chunks, root);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t: the launches' own error, or cudaErrorInvalidValue for
// arguments the kernels do not take. q, k, v are contiguous bf16 [B, S|K, H,
// D], g contiguous f32 [B, S, H, D], mask uint8 [B, K] or null; `root` is
// bf16(sqrt(D)) as an f32. A null dq, dk or dv is not computed. With
// q_chunks = ceil(S / 160) > 1, dk_part and dv_part (f32 [q_chunks, B, K, H,
// D]) take each query chunk's partial sums; with k_chunks = ceil(K / 160) >
// 1, dq_part (f32 [k_chunks, B, S, H, D]) each key chunk's; a second kernel
// sums them in chunk order into the bf16 outputs.
extern "C" int tdspa_attention_backward(const void* q, const void* k, const void* v,
                                        const void* mask, const void* g, void* dq, void* dk,
                                        void* dv, void* dq_part, void* dk_part, void* dv_part,
                                        int B, int S, int K, int H, int D, float root,
                                        void* stream) {
  if (B < 1 || S < 1 || K < 1 || H < 1 || D < 8 || D > 128 || D % 8 != 0 || !(root > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int q_chunks = (S + ROWS - 1) / ROWS, k_chunks = (K + ROWS - 1) / ROWS;
  const long long blocks = static_cast<long long>(B) * H * q_chunks * k_chunks;
  if (blocks > 0x7fffffffLL || (k_chunks > 1 && dq != nullptr && dq_part == nullptr) ||
      (q_chunks > 1 && ((dk != nullptr && dk_part == nullptr) ||
                        (dv != nullptr && dv_part == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const int dp = (D + 31) / 32 * 32;
  int err;
  switch (dp) {
    case 32: err = launch<32>(q, k, v, mask, g, dq, dk, dv, dq_part, dk_part, dv_part, B, S, K, H, D, q_chunks, k_chunks, root, st); break;
    case 64: err = launch<64>(q, k, v, mask, g, dq, dk, dv, dq_part, dk_part, dv_part, B, S, K, H, D, q_chunks, k_chunks, root, st); break;
    case 96: err = launch<96>(q, k, v, mask, g, dq, dk, dv, dq_part, dk_part, dv_part, B, S, K, H, D, q_chunks, k_chunks, root, st); break;
    default: err = launch<128>(q, k, v, mask, g, dq, dk, dv, dq_part, dk_part, dv_part, B, S, K, H, D, q_chunks, k_chunks, root, st); break;
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
