// Flash attention forward for Hopper: O = softmax(Q K^T / sqrt(d)) V and the
// per-row logsumexp of the scaled scores.
//
// Replaces deepfake_video_detection_tpu/ops/attention.py::_short_attn_kernel
// (K2, n_pad <= 512: the ViT blocks, N = 197 at 224 px) and computes the same
// function as ::_attn_kernel (K3, the streaming kernel for n_pad > 512), since
// it streams over any N. As in those kernels, keys >= N are masked to -1e30
// (not -inf), l is guarded by max(l, 1e-30), sums are taken in f32 whatever
// the input type, O is written in the input type and lse in f32.
//
// Routed by dtype in dfdt_flash_fwd, and bf16 by the split count S:
//
// bf16 (serving, and every path under --bf16: bf16 activations) runs
// flash_fwd_bf16_wgmma_kernel (S = 1: N <= 512, the ViT blocks) or, split,
// flash_fwd_split_bf16_wgmma_kernel, both built from Hopper's own parts
// (wgmma_tma.cuh). What bounds it on an H100: at the ViT-B/16 training shape
// (128, 12, 197, 64) bytes by the roofline: one call moves 38.7 MB x 4 + lse
// (0.047 ms at 3.35 TB/s) and does 4*N^2*d*B*H = 15.3 GFLOP (0.015 ms at
// 989 TFLOP/s; with P's second term and the tiles' padding of 197 rows and
// keys to 256 the tensor cores do ~2.2x that). In practice neither: a
// block's time is latency (its phases in cycles: tools/flash_fwd_check.py
// --trace, PERF.md): the wait for the first Q and K tiles, then per key
// tile the products' issue stalls on a tensor pipe shared by the SM's 3
// blocks and the softmax's 32 ex2 a thread queue on the MUFU, ~2,600
// cycles a tile. At the long-clip shapes ((2, 4,
// 1025, 64), 4 heads a clip) the call is too small to fill the card, and
// the time is the tile body's rate times the tiles the slowest block walks.
//
// Design (as FlashAttention-3's, without its persistent grid): one block per
// (64-row query tile, b*h), row tile fastest in the grid so the tiles of one
// head run together and share its K/V in L2; 160 threads: a consumer
// warpgroup (4 warps, 16 query rows each) and a producer warp. The
// producer's one thread sets up the mbarriers and loads by TMA
// (cp.async.bulk.tensor through a 4-D tensor map per operand, (d, N, H, B)
// with the caller's byte strides, so the q/k/v views of a fused QKV
// projection go in without a copy): the Q tile and the first K and V tiles
// before the block's threads meet, then K and V tiles of BN keys (64; 32
// above d = 128) into rings of 2 stages each, with a full and an empty
// mbarrier a stage. Tiles land 128-byte swizzled, in the layout wgmma
// reads, one box per 64 columns of the head dim; rows past N and columns
// past d arrive as TMA's zero fill, so no thread computes an address or a
// predicate for a copy. The consumers take S = Q K^T as wgmma m64nBNk16
// products from shared memory into f32 registers; the online softmax runs
// on those accumulators (their layout is the m16n8 C layout repeated, so
// the row max and sum go over the 4 lanes of a quad), with one
// ex2.approx.ftz on the scores times scale*log2(e) folded into an FMA, and
// lse converted back to the natural log on store. P goes from the
// accumulators into P.V as the A operand from registers, V as B from
// shared memory (transposed: its d axis is the contiguous one), split into
// two bf16 terms (hi = bf16(P), lo = bf16(P - hi), two products a k-step):
// one term keeps P to 2^-9 and moved a
// saturated long-clip loss by a bf16 ulp of its logit against the f32 plain
// version; two keep it to ~2^-17. The loop overlaps the tensor cores with
// the softmax: at tile t the warpgroup issues S_t = Q K_t^T, then O +=
// P_{t-1} V_{t-1}, waits for S_t alone, runs the softmax of tile t while P.V
// is in flight, then waits for it and rescales O. K's stage is released as
// soon as S_t is done, V's once its product is done. O goes out through
// shared memory (the Q tile's, free by then, swizzled likewise) and one TMA
// store a 64-column block, which drops rows past N. Padding: only the tile
// that holds key N - 1 masks keys and skips its 16-key P.V steps wholly at
// or past N. The head dim is padded to DP, a multiple of 64; the wrapper
// hands over d a multiple of 8 with 16-byte row strides (a zero-padded copy
// otherwise). At d = 64 (ptxas, sm_90a): 122 registers, no spill, 3 blocks
// an SM; dynamic shared memory 2 * DP * (64 + 4 * BN) + 72 bytes of barriers
// + 1 KB to align the base to 1024 bytes: 42,056 bytes. Any instruction
// other than a product that writes an accumulator between a product's
// issue and its wait makes ptxas serialize every product of the kernel
// (note C7515; a narrower S product for the last tile, branching on the
// same accumulator, did so and was slower): chip_smoke.py fails the build
// on that note. Tried and slower on the card: a persistent grid (the
// rings running on across work items), two consumer warpgroups sharing K/V
// (1 block an SM), and the tile loop without the overlap at 4 blocks an SM.
//
// The split route (bf16, chosen by the wrapper for N > 512: the TPU's
// streaming kernel K3's regime, the temporal transformer's long clips).
// There a call has few heads (B*H = 4-8), so one block per (row tile, b*h)
// leaves most SMs idle and each block walks 11-17 key tiles in series. The
// wrapper picks S key splits from the shape alone (ops/attention.py,
// _long_splits); flash_fwd_split_bf16_wgmma_kernel runs one block per
// (64-row query tile, key split, b*h), row tile fastest, each walking its
// own run of key tiles with the same body and writing O_s = acc / l_s and
// lse_s in f32 to the caller's scratch, S*B*H*N*(d + 1)*4 bytes. The splits
// are balanced and each keeps at least 2 tiles, so only the last one holds
// key N - 1 and masks. flash_fwd_combine_kernel then takes each row's
// partials in order: lse = log sum_s exp(lse_s), O = sum_s exp(lse_s - lse)
// O_s, O rounded once to bf16 and written through the caller's strides.
// Nothing depends on block order, so reruns are bit-identical. The combine
// kernel takes 48 registers.
//
// f32 (the training CLI's and the evaluator's default without --bf16; the
// f32 gates are 1e-4 absolute on O, 1e-3 on lse) runs flash_fwd_tf32_kernel
// at every N (f32 has no split route): K2's regime and, at N > 512, K3's.
// Every product runs on the tensor cores as 3xTF32 (mma_tf32.cuh): each f32
// operand split into two tf32 terms, three mma.m16n8k8 tf32 products for
// one f32 product, f32 sums, so O keeps the error of f32 arithmetic (one
// tf32 term misses 1e-4). What bounds it on an H100: at (128, 12, 197, 64)
// it moves 311 MB (0.093 ms at 3.35 TB/s) and does 15.3 GFLOP, x 3 at
// 495 TFLOP/s tf32 = 0.093 ms: both alike. In practice it is bound by
// instruction issue: each operand element is split in registers (big
// truncated, a subtraction, small rounded by two integer operations: four
// instructions; cvt.rna.tf32.f32 for both terms, five each after ptxas,
// took 47 % more time), and every product is three mma.sync. Design: one
// block of 4 warps per (64-row query tile, b*h), each warp 16 query rows,
// row tile fastest, the online softmax on the C fragments (softmax_tile),
// with f32 tiles in shared memory,
// rows padded to DP + 4 floats (DP = d rounded up to 32, 64, 128 or 256;
// conflict-free for both kinds of read below): the Q tile once, K/V tiles of
// 32 keys through a 2-stage 16-byte cp.async ring (64-key tiles took 2 blocks
// an SM and were slower). Q and K fragments load by ldmatrix on f32 rows
// with no transpose; V's by 32-bit loads, since ldmatrix.trans would cut
// each f32 word in half. P goes from the accumulators into P.V as its A
// operand with no shared memory: accumulator column 2t is taken as k = t and
// 2t + 1 as k = t + 4, and V's rows are read in that order. Dynamic shared
// memory (64 + 4 * 32) (DP + 4) * 4 bytes: 52,224 at d = 64. d must be a
// multiple of 4 with 16-byte aligned rows (the wrapper's zero-padded copy
// otherwise).
//
// Both: there is no grouping of heads per program (_short_group): it existed
// because a TPU grid runs in sequence, while this grid fills the 132 SMs in
// parallel (at N > 512 the f32 grid is as short of blocks as the bf16 one
// was before its split route). O is written through element strides for the
// B, H and N axes; the f32 kernel reads Q, K and V through them as well (the
// last axis contiguous), the bf16 kernels through their tensor maps.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "tma_map.cuh"
#include "wgmma_tma.cuh"

namespace {

constexpr int kBlockM = 64;   // query rows per block
constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, h, n;
};

// The online-softmax update of one tile for one warp, on the C fragments
// s of its scores (both dtypes' tile bodies): LAST masks keys >= N to -1e30;
// the max is taken on the raw scores (sl2 > 0) and the scale folds into the
// exponent's FMA; m (log2 units) and l are rescaled, alpha is the factor
// for the accumulator, and s becomes P.
// 2^x, with a denormal result flushed to 0: one MUFU.EX2 where exp2f adds
// the instructions that keep denormals
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int NT, bool LAST, bool FTZ = false>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int key0, int N, float sl2,
                                               int tq) {
  float mx[2] = {kNegBig, kNegBig};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (LAST && key0 + j * 8 + 2 * tq + (e & 1) >= N) s[j][e] = kNegBig;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * sl2);  // log2 units
    alpha[i] = FTZ ? exp2_ftz(m[i] - m_new) : exp2f(m[i] - m_new);
    m[i] = m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = fmaf(s[j][e], sl2, -m[e >> 1]);
      const float p = FTZ ? exp2_ftz(x) : exp2f(x);
      s[j][e] = p;
      l[e >> 1] += p;
    }
}

// online_softmax and the accumulator's rescale, for the f32 kernel's warps
template <int NT, int DP, bool LAST>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4], float (&acc)[DP / 8][4],
                                             float (&m)[2], float (&l)[2], int key0, int N,
                                             float sl2, int tq) {
  float alpha[2];
  online_softmax<NT, LAST>(s, m, l, alpha, key0, N, sl2, tq);
#pragma unroll
  for (int jd = 0; jd < DP / 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jd][e] *= alpha[e >> 1];
}

// ---- bf16: the Hopper kernel (TMA, mbarriers, wgmma, a producer warp) ----

template <int DP> struct HopperFwd {
  static constexpr int CONSUMERS = 128;            // one warpgroup: 64 query rows
  static constexpr int THREADS = CONSUMERS + 32;   // and the producer warp
  static constexpr int BM = 64;                    // query rows per block
  static constexpr int BN = DP <= 128 ? 64 : 32;   // keys per K/V tile
  static constexpr int CB = DP / 64;               // 64-column (128-byte) blocks of d
  static constexpr int STAGES = 2;                 // of the K ring and of the V ring
  static constexpr uint32_t Q_BYTES = BM * DP * 2;
  static constexpr uint32_t KV_BYTES = BN * DP * 2;  // one K or V tile
  // Q, the K stages, the V stages (each 1024-byte aligned), then the
  // barriers: Q full, K full x2, K empty x2, V full x2, V empty x2
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr size_t smem = BAR_OFF + 9 * 8 + 1024;  // + alignment of the base
};

// Cycle marks of a block's phases, kept only in the build that
// tools/flash_fwd_check.py --trace makes (-DDFDT_FWD_TRACE): consumer thread
// 0 of each block stores clock64() at entry (0), once Q and the first K
// tile have arrived (1), once the first S is done (2), after the tile loop
// (3), after the last P.V (4) and after the epilogue (5).
#ifdef DFDT_FWD_TRACE
constexpr int kTraceBlocks = 1 << 16;
__device__ long long g_fwd_trace[kTraceBlocks][6];
#define FWD_MARK(k)                                    \
  do {                                                 \
    if (threadIdx.x == 0 && blockIdx.x < kTraceBlocks) \
      g_fwd_trace[blockIdx.x][k] = clock64();          \
  } while (0)
#else
#define FWD_MARK(k) \
  do {              \
  } while (0)
#endif

// One block: query rows [row0, row0 + 64) of head bh against its run of key
// tiles [t0, t1) (all of them when !SPLIT), then O and lse (!SPLIT) or the
// split's O_s and lse_s (SPLIT). part_o (B*H, S, N, d) f32 holds O_s
// normalised by its own l_s, part_lse (B*H, S, N) lse_s in the natural log.
template <int DP, bool SPLIT>
__device__ __forceinline__ void fwd_block(const CUtensorMap& tq, const CUtensorMap& tk,
                                          const CUtensorMap& tv, const CUtensorMap& to, float* lse,
                                          float* part_o, float* part_lse, int H, int N, int d,
                                          int splits, float scale) {
  FWD_MARK(0);
  using C = HopperFwd<DP>;
  constexpr int BN = C::BN, CB = C::CB, NT = BN / 8, KS = BN / 16, ST = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (dfdt::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + C::K_OFF, sV = base + C::V_OFF;
  const uint32_t q_full = base + C::BAR_OFF;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (3 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (5 + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (7 + s); };

  const bool producer = threadIdx.x == C::CONSUMERS;  // one thread keeps the rings full
  if (producer) {
    dfdt::tma_prefetch(&tq);
    dfdt::tma_prefetch(&tk);
    dfdt::tma_prefetch(&tv);
  }
  const dfdt::Work w = dfdt::block_work<C::BM, BN>(N, SPLIT ? splits : 1);
  const int b = w.bh / H;
  const int h = w.bh % H;
  const int n = w.t1 - w.t0;  // key tiles of this block

  // the K or V tile i of this block into its stage, once the stage is free
  auto load_kv = [&](int i, uint32_t ring, const CUtensorMap* map, uint32_t full,
                     uint32_t empty) {
    const int st = i % ST;
    dfdt::mbar_wait(empty, ((i / ST) & 1) ^ 1);  // passes at once in the first round
    dfdt::mbar_expect_tx(full, C::KV_BYTES);
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
      dfdt::tma_load_4d(ring + st * C::KV_BYTES + cb * BN * 128, map, full, cb * 64,
                        (w.t0 + i) * BN, h, b);
  };

  // the producer sets up the barriers and starts the loads of Q and of the
  // first K and V tiles before the block's threads meet
  if (producer) {
    dfdt::mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < ST; ++st) {
      dfdt::mbar_init(k_full(st), 1);
      dfdt::mbar_init(v_full(st), 1);
      dfdt::mbar_init(k_empty(st), C::CONSUMERS);
      dfdt::mbar_init(v_empty(st), C::CONSUMERS);
    }
    dfdt::mbar_fence_init();
    dfdt::mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
      dfdt::tma_load_4d(sQ + cb * C::BM * 128, &tq, q_full, cb * 64, w.row0, h, b);
    load_kv(0, sK, &tk, k_full(0), k_empty(0));
    load_kv(0, sV, &tv, v_full(0), v_empty(0));
  }
  __syncthreads();

  if (threadIdx.x >= C::CONSUMERS) {
    if (producer) {
      for (int i = 1; i < n; ++i) {
        load_kv(i, sK, &tk, k_full(i % ST), k_empty(i % ST));
        load_kv(i, sV, &tv, v_full(i % ST), v_empty(i % ST));
      }
    }
    return;
  }

  // the consumer warpgroup
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tq4 = lane % 4;
  const float sl2 = scale * kLog2e;
  float m[2] = {kNegBig, kNegBig};  // running max, log2 units, rows g and g + 8
  float l[2] = {0.f, 0.f};          // this lane's part of the running sum
  float alpha[2];
  float acc[CB][8][4] = {};         // O, one 64-column block of d at a time
  float s[NT][4] = {};              // S, then P, of one key tile
  uint32_t ph[KS][4], pl[KS][4];    // P's two bf16 terms as A operands, k-step kk
  // K-major operands (Q, K): 8-row groups 1024 bytes apart; a k-step of 16
  // columns is 32 bytes into the swizzled row, a column block BM or BN rows on
  const uint64_t desc_q = dfdt::desc_sw128(sQ, 16, 1024);

  // S = Q K^T of the K tile in stage st, issued as one group
  auto issue_qk = [&](int st) {
    const uint64_t desc_k = dfdt::desc_sw128(sK + st * C::KV_BYTES, 16, 1024);
    dfdt::fence_regs(s);
    dfdt::wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd) {
      const uint32_t q_off = (kd / 4) * C::BM * 128 + (kd % 4) * 32;
      const uint32_t k_off = (kd / 4) * BN * 128 + (kd % 4) * 32;
      dfdt::wgmma_ss<BN>(s, desc_q + (q_off >> 4), desc_k + (k_off >> 4), kd > 0);
    }
    dfdt::wgmma_commit();
  };

  // O += P V of the V tile in stage st over its first `ksteps` 16-key steps,
  // each step as hi.V + lo.V, issued as one group. V is N-major (d
  // contiguous): 8-key groups 1024 bytes apart, column blocks BN rows apart.
  auto issue_pv = [&](int st, int ksteps) {
    const uint64_t desc_v = dfdt::desc_sw128(sV + st * C::KV_BYTES, BN * 128, 1024);
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) dfdt::fence_regs(acc[cb]);
    dfdt::fence_regs(ph);
    dfdt::fence_regs(pl);
    dfdt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk < ksteps) {
#pragma unroll
        for (int cb = 0; cb < CB; ++cb) {
          const uint64_t dv = desc_v + ((kk * 16 * 128 + cb * BN * 128) >> 4);
          dfdt::wgmma_rs_n64_tb(acc[cb], ph[kk], dv);
          dfdt::wgmma_rs_n64_tb(acc[cb], pl[kk], dv);
        }
      }
    }
    dfdt::wgmma_commit();
  };

  // the softmax of key tile t on s, then P's two terms into hi/lo; returns
  // the 16-key steps of P.V with a live key
  auto scores_to_p = [&](int t, uint32_t (&hi)[KS][4], uint32_t (&lo)[KS][4]) {
    const int key0 = t * BN;
    int ksteps = KS;
    if (key0 + BN > N) {
      online_softmax<NT, true, true>(s, m, l, alpha, key0, N, sl2, tq4);
      ksteps = (N - key0 + 15) / 16;
    } else {
      online_softmax<NT, false, true>(s, m, l, alpha, key0, N, sl2, tq4);
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) dfdt::c_to_a_split<NT>(hi[kk], lo[kk], s, kk);
    return ksteps;
  };

  dfdt::mbar_wait(q_full, 0);
  dfdt::mbar_wait(k_full(0), 0);
  FWD_MARK(1);
  issue_qk(0);
  dfdt::wgmma_wait<0>();
  dfdt::fence_regs(s);
  FWD_MARK(2);
  dfdt::mbar_arrive(k_empty(0));
  int ksteps = scores_to_p(w.t0, ph, pl);  // acc is 0: no rescale

  for (int i = 1; i < n; ++i) {
    const int st = i % ST, pst = (i - 1) % ST;
    dfdt::mbar_wait(k_full(st), (i / ST) & 1);
    issue_qk(st);
    dfdt::mbar_wait(v_full(pst), ((i - 1) / ST) & 1);
    issue_pv(pst, ksteps);
    dfdt::wgmma_wait<1>();  // S of tile i; P.V of tile i - 1 runs on
    dfdt::fence_regs(s);
    dfdt::mbar_arrive(k_empty(st));
    uint32_t nh[KS][4], nl[KS][4];
    const int next_ksteps = scores_to_p(w.t0 + i, nh, nl);
    dfdt::wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) dfdt::fence_regs(acc[cb]);
    dfdt::fence_regs(ph);
    dfdt::fence_regs(pl);
    dfdt::mbar_arrive(v_empty(pst));
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[cb][j][e] *= alpha[e >> 1];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ph[kk][e] = nh[kk][e];
        pl[kk][e] = nl[kk][e];
      }
    ksteps = next_ksteps;
  }
  FWD_MARK(3);
  const int last = (n - 1) % ST;
  dfdt::mbar_wait(v_full(last), ((n - 1) / ST) & 1);
  issue_pv(last, ksteps);
  dfdt::wgmma_wait<0>();
#pragma unroll
  for (int cb = 0; cb < CB; ++cb) dfdt::fence_regs(acc[cb]);
  FWD_MARK(4);

  const int g = lane / 4;
  float inv[2], row_lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float l_safe = fmaxf(l[i], 1e-30f);
    // one fast reciprocal per row; its error is far below the bf16 output's
    inv[i] = __fdividef(1.f, l_safe);
    row_lse[i] = m[i] * kLn2 + logf(l_safe);
  }
  const int wrow0 = w.row0 + warp * 16;
  if constexpr (SPLIT) {
    const long long plane = ((long long)w.bh * splits + w.s) * N;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gr = wrow0 + g + 8 * i;
      if (gr >= N) continue;
      float* dst = part_o + (plane + gr) * d;
#pragma unroll
      for (int cb = 0; cb < CB; ++cb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = cb * 64 + j * 8 + 2 * tq4;
          if (c < d)
            *reinterpret_cast<float2*>(dst + c) =
                make_float2(acc[cb][j][2 * i] * inv[i], acc[cb][j][2 * i + 1] * inv[i]);
        }
      if (tq4 == 0) part_lse[plane + gr] = row_lse[i];
    }
  } else {
    // O in bf16 through shared memory, 128-byte swizzled like Q, into the
    // Q tile's space (free once every warp is past its last S), then one
    // TMA store a column block: rows past N and columns past d stay unwritten
    dfdt::named_bar_sync(1, C::CONSUMERS);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g + 8 * i;
#pragma unroll
      for (int cb = 0; cb < CB; ++cb)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dfdt::st_shared_b32(sQ + cb * C::BM * 128 + r * 128 + ((j ^ (r & 7)) << 4) + 4 * tq4,
                              dfdt::pack_bf16(acc[cb][j][2 * i] * inv[i],
                                              acc[cb][j][2 * i + 1] * inv[i]));
      if (tq4 == 0 && w.row0 + r < N) lse[(long long)w.bh * N + w.row0 + r] = row_lse[i];
    }
    dfdt::fence_proxy_async();
    dfdt::named_bar_sync(1, C::CONSUMERS);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int cb = 0; cb < CB; ++cb)
        dfdt::tma_store_4d(&to, sQ + cb * C::BM * 128, cb * 64, w.row0, h, b);
      dfdt::tma_store_commit();
      dfdt::tma_store_wait_read();
    }
  }
  FWD_MARK(5);
}

// N <= 512, or a grid that fills the card unsplit: one block per (64-row
// query tile, b*h) walks every key tile.
template <int DP>
__global__ void __launch_bounds__(HopperFwd<DP>::THREADS)
flash_fwd_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap to, float* __restrict__ lse,
                            int H, int N, int d, float scale) {
  fwd_block<DP, false>(tq, tk, tv, to, lse, nullptr, nullptr, H, N, d, 1, scale);
}

// The split route: one block per (64-row query tile, key split, b*h).
template <int DP>
__global__ void __launch_bounds__(HopperFwd<DP>::THREADS)
flash_fwd_split_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  float* __restrict__ part_o, float* __restrict__ part_lse,
                                  int H, int N, int d, int splits, float scale) {
  fwd_block<DP, true>(tq, tk, tv, tq, nullptr, part_o, part_lse, H, N, d, splits, scale);
}

// Arguments of the combine kernel: the split kernel's partials part_o
// (B*H, S, N, d) and part_lse (B*H, S, N), and where O and lse go.
struct CombineArgs {
  __nv_bfloat16* o;
  float* lse;
  float *part_o, *part_lse;
  Strides so;
  int H, N, d, splits;
};

constexpr int kCombineThreads = 256;

// O and lse of each query row from its S partials, summed over s in order:
// lse = log sum_s exp(lse_s), O = sum_s exp(lse_s - lse) O_s. One thread per
// (row, 8 columns); rows = B*H*N.
__global__ void __launch_bounds__(kCombineThreads)
flash_fwd_combine_kernel(CombineArgs a, long long rows) {
  const int cpr = a.d / 8;
  const long long i = (long long)blockIdx.x * kCombineThreads + threadIdx.x;
  if (i >= rows * cpr) return;
  const int c = (int)(i % cpr) * 8;
  const long long row = i / cpr;
  const int n = (int)(row % a.N);
  const long long bh = row / a.N;
  const long long first = bh * a.splits * a.N + n;  // (bh, s = 0, n)
  // unrolled, so the loads of several splits are in flight at once
  float mx = kNegBig;
#pragma unroll 4
  for (int s = 0; s < a.splits; ++s) mx = fmaxf(mx, a.part_lse[first + (long long)s * a.N]);
  float l = 0.f, acc[8] = {};
#pragma unroll 4
  for (int s = 0; s < a.splits; ++s) {
    const long long r = first + (long long)s * a.N;
    const float wgt = expf(a.part_lse[r] - mx);
    const float4* src = reinterpret_cast<const float4*>(a.part_o + r * a.d + c);
    const float4 x = src[0], y = src[1];
    l += wgt;
    acc[0] = fmaf(wgt, x.x, acc[0]);
    acc[1] = fmaf(wgt, x.y, acc[1]);
    acc[2] = fmaf(wgt, x.z, acc[2]);
    acc[3] = fmaf(wgt, x.w, acc[3]);
    acc[4] = fmaf(wgt, y.x, acc[4]);
    acc[5] = fmaf(wgt, y.y, acc[5]);
    acc[6] = fmaf(wgt, y.z, acc[6]);
    acc[7] = fmaf(wgt, y.w, acc[7]);
  }
  const float l_safe = fmaxf(l, 1e-30f);
  const float inv = 1.f / l_safe;
  __nv_bfloat16* dst = a.o + (bh / a.H) * a.so.b + (bh % a.H) * a.so.h + n * a.so.n + c;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    reinterpret_cast<__nv_bfloat162*>(dst)[j] =
        __floats2bfloat162_rn(acc[2 * j] * inv, acc[2 * j + 1] * inv);
  if (c == 0) a.lse[row] = mx + logf(l_safe);
}

// geo: 9 values per operand (q, k, v, o), as encode_map reads them
template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* o, const long long* geo,
                const CombineArgs& a, int B, float scale, cudaStream_t stream) {
  using C = HopperFwd<DP>;
  const int n_tiles = (a.N + C::BN - 1) / C::BN;
  if (a.splits > n_tiles) return (int)cudaErrorInvalidValue;  // no split without keys
  const bool split = a.splits > 1;
  CUtensorMap mq, mk, mv, mo;
  int err = dfdt::encode_map(&mq, q, geo, a.d, a.N, a.H, B, C::BM);
  if (!err) err = dfdt::encode_map(&mk, k, geo + 9, a.d, a.N, a.H, B, C::BN);
  if (!err) err = dfdt::encode_map(&mv, v, geo + 18, a.d, a.N, a.H, B, C::BN);
  if (!err && !split) err = dfdt::encode_map(&mo, o, geo + 27, a.d, a.N, a.H, B, C::BM);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      split ? (const void*)flash_fwd_split_bf16_wgmma_kernel<DP>
            : (const void*)flash_fwd_bf16_wgmma_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)B * a.H * a.N;
  const long long blocks = (long long)B * a.H * ((a.N + C::BM - 1) / C::BM) * a.splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (split)
    flash_fwd_split_bf16_wgmma_kernel<DP><<<(unsigned)blocks, C::THREADS, C::smem, stream>>>(
        mq, mk, mv, a.part_o, a.part_lse, a.H, a.N, a.d, a.splits, scale);
  else
    flash_fwd_bf16_wgmma_kernel<DP><<<(unsigned)blocks, C::THREADS, C::smem, stream>>>(
        mq, mk, mv, mo, a.lse, a.H, a.N, a.d, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || !split) return (int)e;
  const long long cells = rows * (a.d / 8);
  flash_fwd_combine_kernel<<<(unsigned)((cells + kCombineThreads - 1) / kCombineThreads),
                             kCombineThreads, 0, stream>>>(a, rows);
  return (int)cudaGetLastError();
}

// ---- f32: the 3xTF32 tensor-core kernel ----

template <int DP> struct TfFwd {
  static constexpr int THREADS = 128;  // 4 warps of 16 query rows
  static constexpr int BM = 64;        // query rows per block
  static constexpr int BN = 32;        // keys per K/V tile (64 was slower)
  static constexpr int LD = DP + 4;    // floats per shared-memory row
  static constexpr size_t smem = sizeof(float) * (BM + 4 * BN) * LD;
};

// One K/V tile for one warp, in f32 by 3xTF32 (mma_tf32.cuh): S = Q K^T,
// the online-softmax update, acc += P V. LAST (the tile that holds key
// N - 1) masks keys >= N and skips the steps wholly at or past N.
template <int DP, int BN, bool LAST>
__device__ __forceinline__ void fwd_tile_tf32(float (&acc)[DP / 8][4], float (&m)[2],
                                              float (&l)[2], uint32_t wQ, uint32_t tK,
                                              const float* tV, int key0, int N, float sl2,
                                              int tq) {
  constexpr int LD = DP + 4, NT = BN / 8;
  const int kv = LAST ? N - key0 : BN;  // live keys of this tile

  // S = Q K^T, the k-steps outermost so each Q fragment is split once a tile
  float s[NT][4] = {};
#pragma unroll
  for (int kd = 0; kd < DP / 8; ++kd) {
    uint32_t r[4];
    dfdt::ldsm_x4(r, wQ + kd * 32);
    dfdt::FragA a;
    dfdt::split_a(a, r);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (!LAST || np * 16 < kv) {
        uint32_t bk[4];
        dfdt::ldsm_x4(bk, tK + 4 * (np * 16 * LD + kd * 8));
        dfdt::FragB b0, b1;
        dfdt::split_b(b0, __uint_as_float(bk[0]), __uint_as_float(bk[1]));
        dfdt::split_b(b1, __uint_as_float(bk[2]), __uint_as_float(bk[3]));
        dfdt::mma_3xtf32(s[2 * np], a, b0);
        dfdt::mma_3xtf32(s[2 * np + 1], a, b1);
      }
    }
  }

  softmax_tile<NT, DP, LAST>(s, acc, m, l, key0, N, sl2, tq);

  // acc += P V: P from the accumulators in the relabelled k order, V's B
  // fragments by 32-bit reads of rows 2t and 2t + 1
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    if (!LAST || kk * 8 < kv) {
      dfdt::FragA a;
      dfdt::c_to_a_tf32<NT>(a, s, kk);
#pragma unroll
      for (int jd = 0; jd < DP / 8; ++jd) {
        dfdt::FragB b;
        dfdt::load_b_kn<LD>(b, tV, kk, jd);
        dfdt::mma_3xtf32(acc[jd], a, b);
      }
    }
  }
}

// One block per (64-row query tile, b*h), row tile fastest: Q once, then
// every K/V tile through the 2-stage cp.async ring; O and lse in f32.
template <int DP>
__global__ void __launch_bounds__(TfFwd<DP>::THREADS)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, Strides sq, Strides sk, Strides sv, Strides so,
                      int H, int N, int d, float scale) {
  using C = TfFwd<DP>;
  constexpr int BN = C::BN, LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + C::BM * LD;   // two stages
  float* sV = sK + 2 * BN * LD;  // two stages

  const dfdt::Work w = dfdt::block_work<C::BM, BN>(N, 1);
  const int b = w.bh / H;
  const int h = w.bh % H;
  const int row0 = w.row0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tq = lane % 4;
  const bool active = row0 + warp * 16 < N;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  dfdt::tile_async<DP, LD, C::BM, C::THREADS>(sQ, q + b * sq.b + h * sq.h, sq.n, row0, N, d);
  dfdt::tile_async<DP, LD, BN, C::THREADS>(sK, kb, sk.n, 0, N, d);
  dfdt::tile_async<DP, LD, BN, C::THREADS>(sV, vb, sv.n, 0, N, d);
  dfdt::cp_async_commit();

  const float sl2 = scale * kLog2e;
  float m[2] = {kNegBig, kNegBig};  // running max, log2 units, rows g and g + 8
  float l[2] = {0.f, 0.f};          // this lane's part of the running sum
  float acc[DP / 8][4] = {};
  const uint32_t wQ = dfdt::smem_u32(sQ + warp * 16 * LD) + dfdt::a_off_f32<LD>(lane);
  const int n_tiles = (N + BN - 1) / BN;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      dfdt::tile_async<DP, LD, BN, C::THREADS>(sK + (st ^ 1) * BN * LD, kb, sk.n,
                                                   (t + 1) * BN, N, d);
      dfdt::tile_async<DP, LD, BN, C::THREADS>(sV + (st ^ 1) * BN * LD, vb, sv.n,
                                                   (t + 1) * BN, N, d);
      dfdt::cp_async_commit();
      dfdt::cp_async_wait<1>();
    } else {
      dfdt::cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      const uint32_t tK = dfdt::smem_u32(sK + st * BN * LD) + dfdt::bn_off_f32<LD>(lane);
      const float* tV = sV + st * BN * LD + dfdt::bk_off_f32<LD>(lane);
      if ((t + 1) * BN <= N)
        fwd_tile_tf32<DP, BN, false>(acc, m, l, wQ, tK, tV, t * BN, N, sl2, tq);
      else
        fwd_tile_tf32<DP, BN, true>(acc, m, l, wQ, tK, tV, t * BN, N, sl2, tq);
    }
    __syncthreads();
  }
  if (!active) return;

  const int wrow0 = row0 + warp * 16;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float l_safe = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / l_safe;
    const int gr = wrow0 + lane / 4 + 8 * i;
    if (gr < N && tq == 0) lse[(long long)w.bh * N + gr] = m[i] * kLn2 + logf(l_safe);
  }
  dfdt::store_rows_f32<DP>(o + b * so.b + h * so.h, so.n, acc, inv, wrow0, N, d, lane);
}

// q, k, v, o: (b, h, n) strides in st[0..3]
template <int DP>
cudaError_t launch_tf32(const float* q, const float* k, const float* v, float* o, float* lse,
                        const Strides* st, int B, int H, int N, int d, float scale,
                        cudaStream_t stream) {
  using C = TfFwd<DP>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tf32_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((N + C::BM - 1) / C::BM);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_tf32_kernel<DP><<<(unsigned)blocks, C::THREADS, C::smem, stream>>>(
      q, k, v, o, lse, st[0], st[1], st[2], st[3], H, N, d, scale);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (b, h, n) for q, k, v and o in that order.
// bf16 goes to the Hopper kernels, which read q, k and v and write o through
// tensor maps built from `tma` (9 values for each of q, k, v and o, see
// encode_map; d a multiple of 8; the combine kernel writes o through its
// strides); f32 goes to the 3xTF32 kernel, which takes 16-byte rows
// (cudaErrorMisalignedAddress otherwise) and ignores `tma`. splits: 1, or
// (bf16 only) the key splits S of the split route, with `scratch` the
// caller's f32 buffer of S*B*H*N*(d + 1) elements for the partials.

extern "C" int dfdt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int H, int N, int d, int is_bf16,
                              const long long* strides, float scale, int splits, void* scratch,
                              void* stream, const long long* tma) {
  if (B < 1 || H < 1 || N < 1 || d < 1 || d > 256 || N > 65535 * kBlockM || splits < 1 ||
      (splits > 1 && (!is_bf16 || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (!is_bf16) {
    if (!dfdt::f32_aligned(q, sq, d) || !dfdt::f32_aligned(k, sk, d) ||
        !dfdt::f32_aligned(v, sv, d) || so.b % 2 || so.h % 2 || so.n % 2)
      return (int)cudaErrorMisalignedAddress;
    const Strides st[4] = {sq, sk, sv, so};
    const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
                *fv = static_cast<const float*>(v);
    float* fo = static_cast<float*>(o);
    if (d <= 32) return (int)launch_tf32<32>(fq, fk, fv, fo, l, st, B, H, N, d, scale, s);
    if (d <= 64) return (int)launch_tf32<64>(fq, fk, fv, fo, l, st, B, H, N, d, scale, s);
    if (d <= 128) return (int)launch_tf32<128>(fq, fk, fv, fo, l, st, B, H, N, d, scale, s);
    return (int)launch_tf32<256>(fq, fk, fv, fo, l, st, B, H, N, d, scale, s);
  }
  if (tma == nullptr || d % 8 || so.b % 2 || so.h % 2 || so.n % 2 ||
      reinterpret_cast<uintptr_t>(o) % 4)
    return (int)cudaErrorMisalignedAddress;
  float* part_o = static_cast<float*>(scratch);
  const CombineArgs a{static_cast<__nv_bfloat16*>(o), l, part_o,
                      part_o ? part_o + (long long)splits * B * H * N * d : nullptr,
                      so, H, N, d, splits};
  if (d <= 64) return launch_bf16<64>(q, k, v, o, tma, a, B, scale, s);
  if (d <= 128) return launch_bf16<128>(q, k, v, o, tma, a, B, scale, s);
  if (d <= 192) return launch_bf16<192>(q, k, v, o, tma, a, B, scale, s);
  return launch_bf16<256>(q, k, v, o, tma, a, B, scale, s);
}

#ifdef DFDT_FWD_TRACE
// the first `blocks` blocks' cycle marks (6 each) of the last traced launch
extern "C" int dfdt_fwd_trace(long long* out, int blocks) {
  return (int)cudaMemcpyFromSymbol(out, g_fwd_trace, sizeof(long long) * 6 * blocks);
}
#endif

extern "C" const char* dfdt_error_string(int code) { return dfdt::error_string(code); }
