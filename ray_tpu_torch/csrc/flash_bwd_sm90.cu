// Flash-attention backward for Hopper (sm_90a), bf16, head_dim 128: TMA,
// wgmma and warp specialisation. Two entry points, one kernel template:
//
//   flash_bwd_fused_sm90  replaces `_flash_bwd_fused` of
//                         ray_tpu/ops/flash_attention.py (the pl.pallas_call
//                         at :575, body `_bwd_fused_kernel` :432-529) for the
//                         bf16, D = 128 shapes of the 350m and 1B training
//                         paths: dq, dk and dv in one visit of each live
//                         (q tile, key tile) pair, dq by bulk reduce-adds.
//   flash_bwd_dkv_sm90    replaces `_flash_bwd`'s dkv kernel (the
//                         pl.pallas_call at :707, body `_dkv_kernel`
//                         :368-429) for the bf16, D = 128 shapes of the
//                         long-context route (S > 8192, `_use_fused_bwd`):
//                         the same kernel without its dq stage.
//
// flash_bwd_dq_sm90.cu is the long-context route's dq kernel; flash_bwd.cu
// keeps head_dim 16/32/64 and f32.
//
// Contract (as flash_bwd.cu): q/do [B,Hq,T,128], k/v [B,Hkv,S,128] bf16,
// contiguous, 16-byte aligned; lse [B,Hq,T] f32 (natural log) from the
// forward; delta = rowsum(do*o) [B,Hq,T] f32. Query head h reads kv head
// h / (Hq/Hkv). Per pair: p = exp2(s*scale*log2e - lse*log2e) under the
// end-aligned causal mask (row i sees keys <= i + S - T); dv += p^T.do
// with p rounded to bf16; dp = do.v^T; ds = p*(dp - delta)*scale rounded
// to bf16; dk += ds^T.q; dq += ds.k (fused only). dk and dv sum over the
// GQA group in f32 and are rounded once; dq is added in f32 into the
// caller's zeroed [B,Hq,T,128] f32 buffer. Ragged T and S: the TMA boxes
// read zeros past either edge, keys past S are masked, rows past T have
// lse = +big (p = 0) and their dq rows fall outside the reduce-add's
// tensor.
//
// What bounds them on this card: at the 350m training shape (B8, 8/8
// heads, T=S=2048, causal) the fused kernel's five products per live pair
// are 1.7e11 flops against 0.24 GB of inputs and outputs; at the
// long-context shape (B1, 8/8 heads, T=S=16384) dkv's four are 1.1e12
// flops against 0.20 GB: tensor-core operations (0.17 and 1.11 ms at 989
// TFLOP/s). The mma.sync kernels reached 14% (fused) and 22% (dkv) of
// that: 239 registers a thread (one block an SM), every warp re-reading
// 32-row q/do tiles with ldmatrix, three __syncthreads an iteration, and
// (fused) dq added as D vector atomics per row per block.
//
// What the design does about it (FlashAttention-3's shape):
// - A block owns 128 keys of one (b, kv head): two consumer warpgroups of
//   64 keys (wgmma M = 64) and one producer warp; setmaxnreg moves
//   registers from the producer (40) to the consumers (232). K and V are
//   loaded once by TMA.
// - The block walks the 64-row q tiles of every query head of its group
//   from the causal diagonal on; q, do (TMA) and lse, delta (the producer
//   warp's loads) arrive through a ring with full/empty mbarriers: 2
//   stages in the fused kernel, whose ds and dq stages leave no room for
//   more, 4 in the dkv kernel (the depth timed best on the card: PERF.md).
// - s^T = K.q^T and dp^T = V.do^T are wgmma m64n64k16 from shared memory;
//   p^T and ds^T are formed on the accumulator fragments, rounded to bf16
//   in registers and are the A operands of dv += p^T.do and dk += ds^T.q
//   (wgmma from registers, do and q read MN-major). dk and dv stay in f32
//   registers for the whole walk.
// - Fused only: ds^T goes to shared memory by stmatrix (double-buffered,
//   one named barrier an iteration between the two warpgroups); each
//   warpgroup then computes half of dq's columns, ds.K (wgmma, both
//   operands MN-major), stages the f32 tile in swizzled shared memory and
//   adds it into the dq buffer with TMA reduce-adds: 2 bulk operations per
//   warpgroup and tile in place of 128 threads' vector atomics. The adds'
//   order changes from run to run, so dq is not bitwise reproducible.
// - Without dq the two warpgroups never meet inside the walk, so one's
//   softmax can run while the other's products hold the tensor cores, and
//   dk and dv are bitwise the same from run to run. s^T and dp^T are then
//   two commit groups, so p^T is formed while dp^T's product runs, and its
//   exp2 is one ex2.approx.ftz: both timed faster there (and no faster in
//   the fused kernel, which keeps one group and exp2f).
//
// Built by ray_tpu_torch/_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and called through a plain C interface (ctypes).

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int D = 128;
constexpr int kKB = 128;  // keys per block, 64 per consumer warpgroup
constexpr int kQB = 64;   // query rows per inner tile
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kKvHalf = kKB * kHalfCols;  // elements in a column half of k or v
constexpr int kQHalf = kQB * kHalfCols;   // ... of a q or do tile
constexpr int kDqBox = 32;                // f32 columns in one 128-byte swizzled row
constexpr uint32_t kKvBytes = 4 * kKvHalf * sizeof(bf16);  // k and v
constexpr uint32_t kQDoBytes = 4 * kQHalf * sizeof(bf16);  // q and do tiles
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kBig = 1e30f;  // lse2 of a row past T: p = exp2(-big) = 0

// The fused kernel's dq stage: ds^T, double-buffered, and each
// warpgroup's f32 dq tile, staged for the reduce-adds.
struct DqSmem {
  bf16 ds[2][kKB * kQB];     // [stage][128 keys x 64 q rows]: ds^T
  float dq[kConsumers][2][kQB * kDqBox];  // [warpgroup][box][64 rows x 32]
};
struct NoDq {};

// Every array is a whole number of 1024-byte atoms, so each starts
// aligned; without dq the empty base takes no room.
template <bool kDq, int kStages>
struct Smem : std::conditional_t<kDq, DqSmem, NoDq> {
  bf16 k[2][kKvHalf];        // [column half][128 keys x 64]
  bf16 v[2][kKvHalf];
  bf16 q[kStages][2][kQHalf];     // [stage][column half][64 rows x 64]
  bf16 dout[kStages][2][kQHalf];
  float lse2[kStages][kQB];  // lse * log2e, kBig past T
  float dl[kStages][kQB];    // delta, 0 past T
  uint64_t kv_full, full[kStages], empty[kStages];
};
template <bool kDq, int kStages>
constexpr int kSmemBytes = sizeof(Smem<kDq, kStages>) + kAtomBytes;  // + room to align

template <class S>
__device__ __forceinline__ S& smem_at(unsigned char* raw) {
  const uintptr_t p = (reinterpret_cast<uintptr_t>(raw) + kAtomBytes - 1) &
                      ~static_cast<uintptr_t>(kAtomBytes - 1);
  return *reinterpret_cast<S*>(p);
}

// p^T = exp2(s^T*scale2 - lse2) into sT, 0 where masked (the s^T
// fragment is 64 keys x 64 q rows: element 4i + e at key kr0 + 8 (e >> 1),
// row 8i + 2 t4 + (e & 1) of the tile). kDq, the fused kernel: exp2f, and
// ds^T into dpT in the same pass (two passes spill there, and
// ex2.approx.ftz timed no faster). Otherwise (dkv) one ex2.approx.ftz,
// which timed faster, and dpT is left alone: its product may still run.
template <bool kDq>
__device__ __forceinline__ void form_pT(float (&sT)[32], float (&dpT)[32], const float* lse2,
                                        const float* dl, int kr0, int t4, int q0, int offset,
                                        int S_len, int causal, bool need_mask, float scale,
                                        float scale2) {
#pragma unroll
  for (int i = 0; i < kQB / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ql = 8 * i + 2 * t4 + (e & 1);
      const int key = kr0 + 8 * (e >> 1);
      float p = kDq ? exp2f(sT[4 * i + e] * scale2 - lse2[ql])
                    : exp2_ftz(fmaf(sT[4 * i + e], scale2, -lse2[ql]));
      if (need_mask && (key >= S_len || (causal && key > q0 + ql + offset))) p = 0.f;
      sT[4 * i + e] = p;
      if constexpr (kDq) dpT[4 * i + e] = p * (dpT[4 * i + e] - dl[ql]) * scale;
    }
  }
}

// ds^T = p^T*(dp^T - delta)*scale into dpT.
__device__ __forceinline__ void form_dsT(const float (&pT)[32], float (&dpT)[32],
                                         const float* dl, int t4, float scale) {
#pragma unroll
  for (int i = 0; i < kQB / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ql = 8 * i + 2 * t4 + (e & 1);
      dpT[4 * i + e] = pT[4 * i + e] * (dpT[4 * i + e] - dl[ql]) * scale;
    }
  }
}

// kDq: the fused kernel (dq, dk, dv); without it the dkv kernel (dk,
// dv), whose two warpgroups never meet inside the walk.
template <bool kDq, int kStages>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_dq,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk_out, bf16* __restrict__ dv_out, int Hq, int Hkv,
                      int T_len, int S_len, int causal, float scale, float scale2) {
  extern __shared__ unsigned char smem_raw[];
  auto& sm = smem_at<Smem<kDq, kStages>>(smem_raw);

  // Key tile 0 of every kv head first: under the causal mask it meets the
  // most q tiles, and the heaviest blocks first shorten the grid's tail.
  // (Keeping a head's key tiles together, for L2 reuse of q/do and dq,
  // timed slower on the H100.)
  const int k0 = blockIdx.y * kKB;
  const int bhk = blockIdx.x;  // b * Hkv + kv head
  const int b = bhk / Hkv, group = Hq / Hkv;
  const int h0 = (bhk % Hkv) * group;
  const int offset = S_len - T_len;
  // the first q tile with a row that sees key k0
  const int qt0 = causal && k0 - offset > 0 ? (k0 - offset) / kQB : 0;
  const int per_head = (T_len + kQB - 1) / kQB - qt0;
  const int n_iter = per_head > 0 ? per_head * group : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);                // every producer lane
      mbar_init(&sm.empty[s], kConsumers * 4);  // every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer warp: TMA for k, v, q, do; plain loads for lse, delta ----
    reg_dealloc<40>();
    if (threadIdx.x / 32 == kConsumers * 4) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.kv_full, kKvBytes);
        tma_load_3d(sm.k[0], &tm_k, &sm.kv_full, 0, k0, bhk);
        tma_load_3d(sm.k[1], &tm_k, &sm.kv_full, kHalfCols, k0, bhk);
        tma_load_3d(sm.v[0], &tm_v, &sm.kv_full, 0, k0, bhk);
        tma_load_3d(sm.v[1], &tm_v, &sm.kv_full, kHalfCols, k0, bhk);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % kStages;
        mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
        const int bh = b * Hq + h0 + it / per_head;
        const int q0 = (qt0 + it % per_head) * kQB;
#pragma unroll
        for (int i = lane; i < kQB; i += 32) {
          const int qi = q0 + i;
          const bool ok = qi < T_len;
          sm.lse2[st][i] = ok ? lse[static_cast<int64_t>(bh) * T_len + qi] * kLog2e : kBig;
          sm.dl[st][i] = ok ? delta[static_cast<int64_t>(bh) * T_len + qi] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.full[st], kQDoBytes);
          tma_load_3d(sm.q[st][0], &tm_q, &sm.full[st], 0, q0, bh);
          tma_load_3d(sm.q[st][1], &tm_q, &sm.full[st], kHalfCols, q0, bh);
          tma_load_3d(sm.dout[st][0], &tm_do, &sm.full[st], 0, q0, bh);
          tma_load_3d(sm.dout[st][1], &tm_do, &sm.full[st], kHalfCols, q0, bh);
        } else {
          mbar_arrive(&sm.full[st]);
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    reg_alloc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int key_w = k0 + wg * 64;  // this warpgroup's first key
    const int kr0 = key_w + warp * 16 + g, kr1 = kr0 + 8;  // a thread's two keys
    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(&sm.kv_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int st = it % kStages;
      const int q0 = (qt0 + it % per_head) * kQB;
      mbar_wait(&sm.full[st], (it / kStages) & 1);

      // ---- s^T = K_w.q^T and dp^T = V_w.do^T: 64 keys x 64 rows ----
      float sT[32], dpT[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* a = sm.k[kk / 4] + wg * 64 * kHalfCols + (kk % 4) * 16;
        const bf16* bq = sm.q[st][kk / 4] + (kk % 4) * 16;
        wgmma_n64_ss<0, 0>(sT, desc_sw128(a, 0), desc_sw128(bq, 0), kk > 0);
      }
      if constexpr (!kDq) wgmma_commit();  // dkv: s^T is waited for alone
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* a = sm.v[kk / 4] + wg * 64 * kHalfCols + (kk % 4) * 16;
        const bf16* bd = sm.dout[st][kk / 4] + (kk % 4) * 16;
        wgmma_n64_ss<0, 0>(dpT, desc_sw128(a, 0), desc_sw128(bd, 0), kk > 0);
      }
      wgmma_commit();

      // ---- p^T (masked) into sT, ds^T into dpT ----
      const bool need_mask =
          (key_w + 64 > S_len) || (causal && key_w + 63 > q0 + offset);
      if constexpr (kDq) {
        wgmma_wait<0>();
        fence_regs(sT);
        fence_regs(dpT);
        form_pT<true>(sT, dpT, sm.lse2[st], sm.dl[st], kr0, t4, q0, offset, S_len, causal,
                      need_mask, scale, scale2);
      } else {  // p^T is formed while dp^T's product runs
        wgmma_wait<1>();
        fence_regs(sT);
        form_pT<false>(sT, dpT, sm.lse2[st], sm.dl[st], kr0, t4, q0, offset, S_len, causal,
                       need_mask, scale, scale2);
        wgmma_wait<0>();
        fence_regs(dpT);
        form_dsT(sT, dpT, sm.dl[st], t4, scale);
      }
      uint32_t pa[16], da[16];
#pragma unroll
      for (int kk = 0; kk < kQB / 16; ++kk) {
        acc_to_a(pa + 4 * kk, sT, kk);
        acc_to_a(da + 4 * kk, dpT, kk);
      }

      // ---- dv += p^T.do and dk += ds^T.q: 64 keys x 128 ----
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQB / 16; ++kk)
        wgmma_n128_rs<1>(dv, pa + 4 * kk,
                         desc_sw128(sm.dout[st][0] + kk * 16 * kHalfCols, kQHalf * sizeof(bf16)),
                         1);
#pragma unroll
      for (int kk = 0; kk < kQB / 16; ++kk)
        wgmma_n128_rs<1>(dk, da + 4 * kk,
                         desc_sw128(sm.q[st][0] + kk * 16 * kHalfCols, kQHalf * sizeof(bf16)),
                         1);
      wgmma_commit();

      if constexpr (!kDq) {
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(da);
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.empty[st]);  // q, do, lse, delta of this stage
      } else {
        // ---- ds^T (bf16) to shared memory, swizzled as a TMA box would be ----
#pragma unroll
        for (int kk = 0; kk < kQB / 16; ++kk) {
          const int mat = lane / 8;
          const int row = wg * 64 + warp * 16 + (lane % 8) + 8 * (mat & 1);
          const int chunk = 2 * kk + (mat >> 1);
          stmatrix_x4(reinterpret_cast<unsigned char*>(sm.ds[st]) + row * kRowBytes +
                          ((chunk ^ (row & 7)) << 4),
                      da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3]);
        }
        fence_proxy_async();
        if (tid == 0) bulk_wait_read();  // the last reduce-add has read sm.dq[wg]
        named_sync(1, kConsumers * 128);  // both halves of ds^T are written

        // ---- dq[:, 64 wg ..] = ds.K_half: 64 rows x 64, over 128 keys ----
        float dq[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKB / 16; ++kk) {
          const bf16* a = sm.ds[st] + kk * 16 * kQB;
          const bf16* bk = sm.k[wg] + kk * 16 * kHalfCols;
          wgmma_n64_ss<1, 1>(dq, desc_sw128(a, 0), desc_sw128(bk, 0), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(da);
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.empty[st]);  // q, do, lse, delta of this stage

        // ---- the f32 dq tile to swizzled shared memory, then reduce-add ----
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = 8 * (i % 4) + 2 * t4;  // within the 32-column box
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = warp * 16 + g + 8 * r;
            float* dst = reinterpret_cast<float*>(
                reinterpret_cast<unsigned char*>(sm.dq[wg][i / 4]) + row * kRowBytes +
                (((col / 4) ^ (row & 7)) << 4) + (col % 4) * 4);
            *reinterpret_cast<float2*>(dst) =
                make_float2(dq[4 * i + 2 * r], dq[4 * i + 2 * r + 1]);
          }
        }
        fence_proxy_async();
        named_sync(2 + wg, 128);
        if (tid == 0) {
          const int bh = b * Hq + h0 + it / per_head;
          tma_reduce_add_3d(&tm_dq, sm.dq[wg][0], wg * 64, q0, bh);
          tma_reduce_add_3d(&tm_dq, sm.dq[wg][1], wg * 64 + kDqBox, q0, bh);
          bulk_commit();
        }
      }
    }
    if constexpr (kDq) {
      if (tid == 0) bulk_wait();
    }

    // ---- epilogue: dk, dv rounded once to bf16 ----
    const int64_t kv_off = static_cast<int64_t>(bhk) * S_len * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = r == 0 ? kr0 : kr1;
      if (key >= S_len) continue;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int64_t at = kv_off + static_cast<int64_t>(key) * D + 8 * i + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(dk_out + at) =
            __floats2bfloat162_rn(dk[4 * i + 2 * r], dk[4 * i + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv_out + at) =
            __floats2bfloat162_rn(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
      }
    }
  }
}

// The fused kernel keeps a 2-stage ring: its ds and dq stages leave
// no room for a third. The dkv kernel's ring depth: see the top note.
constexpr int kFusedStages = 2;
constexpr int kDkvStages = 4;

// Checks the arguments, builds the tensor maps and launches one variant.
// dq_acc is null for the dkv kernel, whose dq map is then unused (q's).
template <bool kDq, int kStages>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq_acc, void* dk, void* dv, int B,
                   int Hq, int Hkv, int T_len, int S_len, int causal, void* stream) {
  const int n_kt = (S_len + kKB - 1) / kKB;
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || T_len <= 0 || S_len <= 0 ||
      static_cast<int64_t>(B) * Hq > 0x7fffffff || n_kt > 65535)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dq_acc)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dq;
  cudaError_t err = make_map(&tm_q, q, false, D, T_len, B * Hq, kHalfCols, kQB);
  if (err == cudaSuccess) err = make_map(&tm_do, dout, false, D, T_len, B * Hq, kHalfCols, kQB);
  if (err == cudaSuccess) err = make_map(&tm_k, k, false, D, S_len, B * Hkv, kHalfCols, kKB);
  if (err == cudaSuccess) err = make_map(&tm_v, v, false, D, S_len, B * Hkv, kHalfCols, kKB);
  if (err == cudaSuccess)
    err = kDq ? make_map(&tm_dq, dq_acc, true, D, T_len, B * Hq, kDqBox, kQB)
              : make_map(&tm_dq, q, false, D, T_len, B * Hq, kHalfCols, kQB);
  if (err != cudaSuccess) return err;
  constexpr int smem = kSmemBytes<kDq, kStages>;
  static bool configured = false;  // one per instance
  if (!configured) {
    err = cudaFuncSetAttribute(flash_bwd_sm90_kernel<kDq, kStages>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_bwd_sm90_kernel<kDq, kStages>
      <<<dim3(B * Hkv, n_kt), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          tm_q, tm_do, tm_k, tm_v, tm_dq, static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), Hq,
          Hkv, T_len, S_len, causal, scale, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory a block takes, in bytes.
extern "C" int flash_bwd_fused_sm90_smem_bytes() { return kSmemBytes<true, kFusedStages>; }
extern "C" int flash_bwd_dkv_sm90_smem_bytes() { return kSmemBytes<false, kDkvStages>; }

// Each returns a cudaError_t (0 = launched). bf16, head_dim 128 only; q,
// k, v, do (and dq_acc) must be 16-byte aligned (TMA). dq_acc is a zeroed
// f32 [B,Hq,T,128] buffer that the fused kernel adds into; dk and dv are
// written.
extern "C" int flash_bwd_fused_sm90(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq_acc, void* dk, void* dv, int B, int Hq, int Hkv,
                                    int T_len, int S_len, int causal, void* stream) {
  return static_cast<int>(launch<true, kFusedStages>(q, k, v, dout, lse, delta, dq_acc, dk, dv,
                                                     B, Hq, Hkv, T_len, S_len, causal, stream));
}

extern "C" int flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int Hq, int Hkv, int T_len,
                                  int S_len, int causal, void* stream) {
  return static_cast<int>(launch<false, kDkvStages>(q, k, v, dout, lse, delta, nullptr, dk, dv,
                                                    B, Hq, Hkv, T_len, S_len, causal, stream));
}
