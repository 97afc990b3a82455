// Flash-attention forward for Hopper (sm_90a), bf16, head_dim 128: TMA,
// wgmma and warp specialisation.
//
// Replaces the TPU forward of ray_tpu/ops/flash_attention.py: `_flash_fwd`
// (the pl.pallas_call at :294; bodies `_fwd_kernel` :88-169 and
// `_fwd_kernel_1pass` :172-212), for the bf16, D = 128 shapes of every main
// path. flash_fwd.cu keeps head_dim 16/32/64 and f32.
//
// Contract (as flash_fwd.cu and the TPU kernel): q [B,Hq,T,128], k/v
// [B,Hkv,S,128] bf16, contiguous, 16-byte aligned; query head h reads kv
// head h / (Hq/Hkv). Scale d^-1/2; softmax statistics in f32 (log2 domain
// inside); p rounded to bf16 before P.V, f32 accumulation. End-aligned
// causal mask: row i sees keys <= i + S - T. Rows that see no key output
// 0 with lse = +1e30; lse [B,Hq,T] f32, natural log. Ragged T and S: the
// TMA boxes read zeros past either edge and the mask drops keys past S.
//
// What bounds it on this card: at the main-path shapes (B8, 8/8 heads or
// B2, 16/8 heads, T=S=2048, causal) the two products are 4.4e10 or 2.2e10
// flops against 25-34 MB of q/k/v/out/lse, far above the H100's ~295
// flops per byte: tensor-core operations (0.070 / 0.035 ms at 989 TFLOP/s).
// The earlier mma.sync kernel reached ~16-18% of that: only wgmma reaches
// the tensor cores' full rate, and its four independent warps each
// re-read whole k/v tiles from shared memory for 16 rows of work.
//
// What the design does about it (FlashAttention-3's shape):
// - A block takes 128 query rows of one (b, h): two consumer warpgroups of
//   64 rows and one producer warp. setmaxnreg moves registers from the
//   producer (24) to the consumers (240).
// - The producer loads the q tile once, then k and v tiles of 128 keys
//   through a 2-stage ring of TMA loads with full/empty mbarriers (160 KB
//   of shared memory, 128-byte swizzle): no thread spends instructions on
//   addresses, and loads run ahead of the products.
// - S = Q.K^T is wgmma m64n128k16 from shared memory, f32 accumulators in
//   registers; the online softmax runs on that fragment (two rows a
//   thread, quad shuffles); P is rounded to bf16 in registers and is the A
//   operand of O += P.V (wgmma from registers), V read MN-major through
//   the transpose bit, so no transposed copy exists.
// - The softmax of tile j overlaps the P.V product of tile j-1: S_j and
//   O += P_{j-1}.V_{j-1} are issued together and only S_j is waited for.
// - Key tiles wholly above the causal diagonal are never loaded, only
//   tiles on the diagonal or the ragged S edge pay for the mask, and the
//   grid starts the heaviest q tiles (the last) first.
//
// Built by ray_tpu_torch/_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through a plain C interface (ctypes).

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int D = 128;
constexpr int kBQ = 128;  // query rows per block, 64 per consumer warpgroup
constexpr int kBK = 128;  // keys per tile
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kHalf = kBK * kHalfCols;                    // elements in one column half
constexpr uint32_t kTileBytes = 2 * kHalf * sizeof(bf16);  // a 128 x 128 bf16 tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {
  bf16 q[2][kHalf];     // [column half][128 rows x 64]
  bf16 k[2][2][kHalf];  // [stage][column half]
  bf16 v[2][2][kHalf];
  uint64_t q_full, k_full[2], k_empty[2], v_full[2], v_empty[2];
};
constexpr int kSmemBytes = sizeof(Smem) + kAtomBytes;  // + room to align the base

__device__ __forceinline__ Smem& smem_at(unsigned char* raw) {
  const uintptr_t p = (reinterpret_cast<uintptr_t>(raw) + kAtomBytes - 1) &
                      ~static_cast<uintptr_t>(kAtomBytes - 1);
  return *reinterpret_cast<Smem*>(p);
}

// Key tiles a block visits: under the causal mask, tiles past the last
// live key of the block's last real row are dead.
__device__ __forceinline__ int live_tiles(int q0, int T_len, int S_len, int causal) {
  int n = (S_len + kBK - 1) / kBK;
  if (causal) {
    const int last_row = min(q0 + kBQ, T_len) - 1;
    const int last_key = min(last_row + S_len - T_len, S_len - 1);
    n = last_key < 0 ? 0 : min(n, last_key / kBK + 1);
  }
  return n;
}

// Every warp of both consumer warpgroups is done with a stage.
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// The two consumer warpgroups take turns to issue their products (named
// barriers 1 and 2: "warpgroup 0 / 1 may issue"), so that one's softmax
// runs while the other's products keep the tensor cores busy.
__device__ __forceinline__ void turn_wait(int wg) { named_sync(1 + wg, 2 * 128); }
__device__ __forceinline__ void turn_pass(int wg) { named_arrive(2 - wg, 2 * 128); }

// s = Q_wg . K_j^T (64 x 128 keys), issued and committed (K_j has landed).
__device__ __forceinline__ void issue_qk(Smem& sm, float (&s)[64], int wg, int j) {
  const int st = j & 1;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* a = sm.q[kk / 4] + wg * 64 * kHalfCols + (kk % 4) * 16;
    const bf16* b = sm.k[st][kk / 4] + (kk % 4) * 16;
    wgmma_n128_ss<0, 0>(s, desc_sw128(a, 0), desc_sw128(b, 0), kk > 0);
  }
  wgmma_commit();
}

// o += P_j . V_j (p: bf16 A fragments over 128 keys), issued and committed
// once V_j has landed.
__device__ __forceinline__ void issue_pv(Smem& sm, float (&o)[64], const uint32_t (&p)[32],
                                         int j) {
  const int st = j & 1;
  mbar_wait(&sm.v_full[st], (j >> 1) & 1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const bf16* b = sm.v[st][0] + kk * 16 * kHalfCols;
    wgmma_n128_rs<1>(o, p + 4 * kk, desc_sw128(b, kHalf * sizeof(bf16)), 1);
  }
  wgmma_commit();
}

// Online softmax of key tile j on the raw score fragment s = q.k: s
// becomes exp2(s * scale2 - m_new), masked entries 0; m (log2 domain) and
// l are updated and c = exp2(m_old - m_new) is returned for the output's
// rescale. Masked scores are -inf, so a row with no live key so far
// (m = -1e30, finite) gets exp2(-inf) = 0 with no test.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&c)[2], int j, int row_w, int r0,
                                             int t4, int T_len, int S_len, int causal,
                                             float scale2) {
  const int offset = S_len - T_len;
  const int k_start = j * kBK;
  const bool need_mask =
      (k_start + kBK > S_len) || (causal && k_start + kBK - 1 > row_w + offset);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kBK / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (need_mask) {
        const int key = k_start + 8 * i + 2 * t4 + (e & 1);
        const int row = r0 + 8 * (e >> 1);
        if (key >= S_len || (causal && key > row + offset)) s[4 * i + e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * i + e]);
    }
  }
  float neg_m[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]) * scale2);
    c[r] = exp2_ftz(m[r] - mn);
    m[r] = mn;
    neg_m[r] = -mn;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = exp2_ftz(fmaf(s[i], scale2, neg_m[r]));
    sum[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * c[r] + sum[r];
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                      float* __restrict__ lse, int Hq, int Hkv, int T_len, int S_len,
                      int causal, float scale2) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = smem_at(smem_raw);

  // The last q tiles of every head first: under the causal mask they have
  // the most live key tiles, and starting the heaviest blocks first
  // shortens the grid's tail. (Keeping a head's q tiles together, for L2
  // reuse of its k/v, timed slower on the H100.)
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int bh = blockIdx.x;  // b * Hq + h
  const int bhk = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int n_tiles = live_tiles(q0, T_len, S_len, causal);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], kConsumers * 4);  // one arrival per consumer warp
      mbar_init(&sm.v_empty[s], kConsumers * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread issues every TMA load ----
    reg_dealloc<24>();
    if (threadIdx.x == kConsumers * 128 && n_tiles > 0) {
      mbar_arrive_expect_tx(&sm.q_full, kTileBytes);
      tma_load_3d(sm.q[0], &tm_q, &sm.q_full, 0, q0, bh);
      tma_load_3d(sm.q[1], &tm_q, &sm.q_full, kHalfCols, q0, bh);
      // K_j goes out before V_{j-1}: S_j is issued one tile ahead of
      // P_{j-1}.V_{j-1}, so K_j is needed first
      for (int j = 0; j <= n_tiles; ++j) {
        if (j < n_tiles) {
          const int st = j & 1;
          mbar_wait(&sm.k_empty[st], ((j >> 1) & 1) ^ 1);
          mbar_arrive_expect_tx(&sm.k_full[st], kTileBytes);
          tma_load_3d(sm.k[st][0], &tm_k, &sm.k_full[st], 0, j * kBK, bhk);
          tma_load_3d(sm.k[st][1], &tm_k, &sm.k_full[st], kHalfCols, j * kBK, bhk);
        }
        if (j > 0) {
          const int jv = j - 1, st = jv & 1;
          mbar_wait(&sm.v_empty[st], ((jv >> 1) & 1) ^ 1);
          mbar_arrive_expect_tx(&sm.v_full[st], kTileBytes);
          tma_load_3d(sm.v[st][0], &tm_v, &sm.v_full[st], 0, jv * kBK, bhk);
          tma_load_3d(sm.v[st][1], &tm_v, &sm.v_full[st], kHalfCols, jv * kBK, bhk);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    reg_alloc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int row_w = q0 + wg * 64;  // this warpgroup's first row
    const int r0 = row_w + warp * 16 + g, r1 = r0 + 8;
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, c[2];

    if (n_tiles > 0) {
      float s[64];
      uint32_t p[32];
      if (wg == 1) turn_pass(wg);  // warpgroup 0 issues first
      mbar_wait(&sm.q_full, 0);
      mbar_wait(&sm.k_full[0], 0);
      turn_wait(wg);
      issue_qk(sm, s, wg, 0);
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(s);
      release(&sm.k_empty[0]);
      softmax_tile(s, m, l, c, 0, row_w, r0, t4, T_len, S_len, causal, scale2);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) acc_to_a(p + 4 * kk, s, kk);

      for (int j = 1; j < n_tiles; ++j) {
        mbar_wait(&sm.k_full[j & 1], (j >> 1) & 1);
        turn_wait(wg);
        issue_qk(sm, s, wg, j);
        issue_pv(sm, o, p, j - 1);
        turn_pass(wg);
        wgmma_wait<1>();  // S_j is done; P_{j-1}.V_{j-1} may still run
        fence_regs(s);
        release(&sm.k_empty[j & 1]);
        softmax_tile(s, m, l, c, j, row_w, r0, t4, T_len, S_len, causal, scale2);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        release(&sm.v_empty[(j - 1) & 1]);
#pragma unroll
        for (int i = 0; i < 64; ++i) o[i] *= c[(i >> 1) & 1];
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) acc_to_a(p + 4 * kk, s, kk);
      }
      turn_wait(wg);
      issue_pv(sm, o, p, n_tiles - 1);
      // warpgroup 1's last pass would have no turn to match
      if (wg == 0) turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(o);
      release(&sm.v_empty[(n_tiles - 1) & 1]);
    }

    // ---- epilogue: normalise, write out and the natural-log lse ----
    bf16* o_bh = out + static_cast<int64_t>(bh) * T_len * D;
    float* lse_bh = lse + static_cast<int64_t>(bh) * T_len;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r == 0 ? r0 : r1;
      const float sum = quad_sum(l[r]);
      const float inv = 1.f / (sum == 0.f ? 1.f : sum);
      if (row < T_len) {
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<__nv_bfloat162*>(o_bh + static_cast<int64_t>(row) * D + 8 * i +
                                             2 * t4) =
              __floats2bfloat162_rn(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
        if (t4 == 0)
          lse_bh[row] = sum == 0.f ? -kNegInf : (m[r] + log2f(sum)) * (1.f / kLog2e);
      }
    }
  }
}

}  // namespace

// Dynamic shared memory a block takes, in bytes.
extern "C" int flash_fwd_sm90_smem_bytes() { return kSmemBytes; }

// Returns a cudaError_t (0 = launched). bf16, head_dim 128 only; q, k and v
// must be 16-byte aligned (TMA).
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v, void* out,
                              void* lse, int B, int Hq, int Hkv, int T_len, int S_len,
                              int causal, void* stream) {
  const int n_qt = (T_len + kBQ - 1) / kBQ;
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || T_len <= 0 || S_len <= 0 ||
      static_cast<int64_t>(B) * Hq > 0x7fffffff || n_qt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = make_map(&tm_q, q, false, D, T_len, B * Hq, kHalfCols, kBQ);
  if (err == cudaSuccess) err = make_map(&tm_k, k, false, D, S_len, B * Hkv, kHalfCols, kBK);
  if (err == cudaSuccess) err = make_map(&tm_v, v, false, D, S_len, B * Hkv, kHalfCols, kBK);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool configured = false;
  if (!configured) {
    err = cudaFuncSetAttribute(flash_fwd_sm90_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const float scale2 = (1.0f / sqrtf(static_cast<float>(D))) * kLog2e;
  flash_fwd_sm90_kernel<<<dim3(B * Hq, n_qt), kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(out), static_cast<float*>(lse), Hq, Hkv, T_len,
      S_len, causal, scale2);
  return static_cast<int>(cudaGetLastError());
}
