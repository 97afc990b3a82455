// Flash-attention dq backward for Hopper (sm_90a), bf16, head_dim 128:
// TMA, wgmma and warp specialisation.
//
// Replaces the dq kernel of `_flash_bwd` in ray_tpu/ops/flash_attention.py
// (the pl.pallas_call at :678, body `_dq_kernel` :315-365) for the bf16,
// D = 128 shapes of the long-context route (S > 8192, `_use_fused_bwd`).
// flash_bwd.cu keeps head_dim 16/32/64 and f32.
//
// Contract (as flash_bwd_sm90.cu): q/do [B,Hq,T,128], k/v [B,Hkv,S,128]
// bf16, contiguous, 16-byte aligned; lse [B,Hq,T] f32 (natural log) from
// the forward; delta = rowsum(do*o) [B,Hq,T] f32. Query head h reads kv
// head h / (Hq/Hkv). Per pair: p = exp2(s*scale*log2e - lse*log2e) under
// the end-aligned causal mask (row i sees keys <= i + S - T); dp = do.v^T;
// ds = p*(dp - delta)*scale rounded to bf16; dq += ds.k in f32, rounded
// once and written to dq [B,Hq,T,128] bf16. Ragged T and S: the TMA boxes
// read zeros past either edge, keys past S are masked, rows past T have
// lse = +big (p = 0) and are not stored. A row that sees no key gets dq =
// 0 exactly (p = 0 on every key); a block whose rows all see none stores
// zeros without loading anything. No atomics: each dq row is summed by
// one thread in one order, so dq is bitwise the same from run to run.
//
// What bounds it on this card: at the long-context shape (B1, 8/8 heads,
// T=S=16384, causal) three products per live pair are 8.2e11 flops
// against 0.17 GB of inputs and outputs: tensor-core operations (0.83 ms
// at 989 TFLOP/s). The mma.sync kernel it replaces reached 28% of that:
// four independent warps of 16 rows each re-read every 32-key k/v tile
// from shared memory, with cp.async and a __syncthreads per tile.
//
// What the design does about it (the Hopper forward's shape,
// flash_fwd_sm90.cu):
// - A block owns 128 query rows of one (b, h): two consumer warpgroups of
//   64 rows (wgmma M = 64) and one producer warp; setmaxnreg moves
//   registers from the producer (24) to the consumers (240). q and do are
//   loaded once by TMA, then held by each warpgroup as register A
//   fragments (ldmatrix); lse and delta of a thread's two rows are read
//   once into registers.
// - K and V tiles of 64 keys stream through a 4-stage TMA ring with
//   full/empty mbarriers (the depth timed best on the card: PERF.md); key
//   tiles past the causal diagonal are never loaded, and the grid starts
//   the heaviest q tiles (the last) first.
// - S = Q_w.K^T and dP = dO_w.V^T are wgmma m64n64k16 with A from
//   registers and K, V read K-major from shared memory: an m64n64 product
//   with both operands in shared memory reads as many bytes a cycle as the
//   SM's shared memory delivers, with A in registers half as many.
//   dS = P*(dP - delta)*scale is formed on the accumulator fragments
//   (exp2 by ex2.approx.ftz) and rounded to bf16 in registers, the A
//   operand of dq += dS.K (wgmma from registers, K read MN-major), so dS
//   never touches shared memory.
// - The products of key tile j+1 are issued together with dq += dS_j.K_j
//   and only they are waited for: the softmax of tile j+1 runs while the
//   tensor cores add tile j into dq. dq (64), S and dP (32 each), dS's
//   fragment (16) and the q and do fragments (64) fit a thread's 240
//   registers; that, and not shared memory, is why a key tile is 64 and
//   not 128.
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
constexpr int kBK = 64;   // keys per tile
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kQHalf = kBQ * kHalfCols;  // elements in a column half of q or do
constexpr int kKHalf = kBK * kHalfCols;  // ... of a k or v tile
constexpr uint32_t kQDoBytes = 4 * kQHalf * sizeof(bf16);  // q and do
constexpr uint32_t kKvBytes = 4 * kKHalf * sizeof(bf16);   // a k and a v tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kBig = 1e30f;  // lse2 of a row past T: p = exp2(-big) = 0

constexpr int kStages = 4;  // the ring's depth, timed best on the card (PERF.md)

struct Smem {
  bf16 q[2][kQHalf];     // [column half][128 rows x 64]
  bf16 dout[2][kQHalf];
  bf16 k[kStages][2][kKHalf];  // [stage][column half][64 keys x 64]
  bf16 v[kStages][2][kKHalf];
  uint64_t qdo_full, full[kStages], empty[kStages];
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

// The A fragments of this warpgroup's 64 rows of a 128-row tile stored as
// two swizzled column halves: one ldmatrix x4 per k-step of 16 columns.
__device__ __forceinline__ void load_a(uint32_t (&a)[32], const bf16 (&tile)[2][kQHalf], int wg) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int row = wg * 64 + warp * 16 + (lane % 8) + 8 * ((lane / 8) & 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int chunk = 2 * (kk % 4) + lane / 16;
    ldmatrix_x4(a + 4 * kk, reinterpret_cast<const unsigned char*>(tile[kk / 4]) +
                                row * kRowBytes + ((chunk ^ (row & 7)) << 4));
  }
}

// s = Q_wg.K^T and dp = dO_wg.V^T of stage st (64 rows x 64 keys; Q_wg and
// dO_wg as register A fragments), issued and committed as one group.
__device__ __forceinline__ void issue_s_dp(Smem& sm, float (&s)[32], float (&dp)[32],
                                           const uint32_t (&qa)[32], const uint32_t (&doa)[32],
                                           int st) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* b = sm.k[st][kk / 4] + (kk % 4) * 16;
    wgmma_n64_rs<0>(s, qa + 4 * kk, desc_sw128(b, 0), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* b = sm.v[st][kk / 4] + (kk % 4) * 16;
    wgmma_n64_rs<0>(dp, doa + 4 * kk, desc_sw128(b, 0), kk > 0);
  }
  wgmma_commit();
}

// dq += dS.K of stage st (ds: bf16 A fragments over 64 keys; K read
// MN-major, LBO = the distance between its column halves), issued and
// committed.
__device__ __forceinline__ void issue_dq(Smem& sm, float (&dq)[64], const uint32_t (&ds)[16],
                                         int st) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_n128_rs<1>(dq, ds + 4 * kk,
                     desc_sw128(sm.k[st][0] + kk * 16 * kHalfCols, kKHalf * sizeof(bf16)), 1);
  wgmma_commit();
}

// ds = p*(dp - delta)*scale into dp, with p = exp2(s*scale2 - lse2) masked
// (the forward's orientation: rows are M, keys are N). Accumulator element
// 4i + e sits at row r0 + 8 (e >> 1), key k_start + 8i + 2 t4 + (e & 1).
__device__ __forceinline__ void ds_tile(const float (&s)[32], float (&dp)[32],
                                        const float (&l2)[2], const float (&dl)[2], int j,
                                        int row_w, int r0, int t4, int T_len, int S_len,
                                        int causal, float scale, float scale2) {
  const int offset = S_len - T_len;
  const int k_start = j * kBK;
  const bool need_mask =
      (k_start + kBK > S_len) || (causal && k_start + kBK - 1 > row_w + offset);
#pragma unroll
  for (int i = 0; i < kBK / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = exp2_ftz(fmaf(s[4 * i + e], scale2, -l2[r]));
      if (need_mask) {
        const int key = k_start + 8 * i + 2 * t4 + (e & 1);
        if (key >= S_len || (causal && key > r0 + 8 * r + offset)) p = 0.f;
      }
      dp[4 * i + e] = p * (dp[4 * i + e] - dl[r]) * scale;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq_out, int Hq, int Hkv, int T_len, int S_len,
                         int causal, float scale, float scale2) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = smem_at(smem_raw);

  // The last q tiles of every head first: under the causal mask they walk
  // the most key tiles.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int bh = blockIdx.x;  // b * Hq + h
  const int bhk = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int n_tiles = live_tiles(q0, T_len, S_len, causal);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.qdo_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread issues every TMA load ----
    reg_dealloc<24>();
    if (threadIdx.x == kConsumers * 128 && n_tiles > 0) {
      mbar_arrive_expect_tx(&sm.qdo_full, kQDoBytes);
      tma_load_3d(sm.q[0], &tm_q, &sm.qdo_full, 0, q0, bh);
      tma_load_3d(sm.q[1], &tm_q, &sm.qdo_full, kHalfCols, q0, bh);
      tma_load_3d(sm.dout[0], &tm_do, &sm.qdo_full, 0, q0, bh);
      tma_load_3d(sm.dout[1], &tm_do, &sm.qdo_full, kHalfCols, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(&sm.empty[st], ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.full[st], kKvBytes);
        tma_load_3d(sm.k[st][0], &tm_k, &sm.full[st], 0, j * kBK, bhk);
        tma_load_3d(sm.k[st][1], &tm_k, &sm.full[st], kHalfCols, j * kBK, bhk);
        tma_load_3d(sm.v[st][0], &tm_v, &sm.full[st], 0, j * kBK, bhk);
        tma_load_3d(sm.v[st][1], &tm_v, &sm.full[st], kHalfCols, j * kBK, bhk);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    reg_alloc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int row_w = q0 + wg * 64;  // this warpgroup's first row
    const int r0 = row_w + warp * 16 + g;
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      const bool ok = row < T_len;
      l2[r] = ok ? lse[static_cast<int64_t>(bh) * T_len + row] * kLog2e : kBig;
      dl[r] = ok ? delta[static_cast<int64_t>(bh) * T_len + row] : 0.f;
    }
    float dq[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;

    if (n_tiles > 0) {
      float s[32], dp[32];
      uint32_t ds[16], qa[32], doa[32];
      mbar_wait(&sm.qdo_full, 0);
      load_a(qa, sm.q, wg);
      load_a(doa, sm.dout, wg);
      mbar_wait(&sm.full[0], 0);
      issue_s_dp(sm, s, dp, qa, doa, 0);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      for (int j = 0; j < n_tiles; ++j) {
        ds_tile(s, dp, l2, dl, j, row_w, r0, t4, T_len, S_len, causal, scale, scale2);
        if (j > 0) {  // dq += dS_{j-1}.K_{j-1} is done: its ds and stage are free
          wgmma_wait<0>();
          fence_regs(dq);
          fence_regs(ds);
          release(&sm.empty[(j - 1) % kStages]);
        }
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) acc_to_a(ds + 4 * kk, dp, kk);
        const bool more = j + 1 < n_tiles;
        if (more) {
          const int st = (j + 1) % kStages;
          mbar_wait(&sm.full[st], ((j + 1) / kStages) & 1);
          issue_s_dp(sm, s, dp, qa, doa, st);
        }
        issue_dq(sm, dq, ds, j % kStages);
        if (more) {
          wgmma_wait<1>();  // S, dP of tile j+1 are done; dS_j.K_j may still run
          fence_regs(s);
          fence_regs(dp);
        }
      }
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(ds);
      release(&sm.empty[(n_tiles - 1) % kStages]);
    }

    // ---- epilogue: dq rounded once to bf16; rows past T are not stored ----
    bf16* dq_bh = dq_out + static_cast<int64_t>(bh) * T_len * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= T_len) continue;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(dq_bh + static_cast<int64_t>(row) * D + 8 * i +
                                           2 * t4) =
            __floats2bfloat162_rn(dq[4 * i + 2 * r], dq[4 * i + 2 * r + 1]);
    }
  }
}

}  // namespace

// Dynamic shared memory a block takes, in bytes.
extern "C" int flash_bwd_dq_sm90_smem_bytes() { return kSmemBytes; }

// Returns a cudaError_t (0 = launched). bf16, head_dim 128 only; q, k, v
// and do must be 16-byte aligned (TMA). dq [B,Hq,T,128] bf16 is written.
extern "C" int flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int B, int Hq,
                                 int Hkv, int T_len, int S_len, int causal, void* stream) {
  const int n_qt = (T_len + kBQ - 1) / kBQ;
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || T_len <= 0 || S_len <= 0 ||
      static_cast<int64_t>(B) * Hq > 0x7fffffff || n_qt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  cudaError_t err = make_map(&tm_q, q, false, D, T_len, B * Hq, kHalfCols, kBQ);
  if (err == cudaSuccess) err = make_map(&tm_do, dout, false, D, T_len, B * Hq, kHalfCols, kBQ);
  if (err == cudaSuccess) err = make_map(&tm_k, k, false, D, S_len, B * Hkv, kHalfCols, kBK);
  if (err == cudaSuccess) err = make_map(&tm_v, v, false, D, S_len, B * Hkv, kHalfCols, kBK);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool configured = false;
  if (!configured) {
    err = cudaFuncSetAttribute(flash_bwd_dq_sm90_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_bwd_dq_sm90_kernel<<<dim3(B * Hq, n_qt), kThreads, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_do, tm_k, tm_v, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), Hq, Hkv, T_len, S_len, causal,
      scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
