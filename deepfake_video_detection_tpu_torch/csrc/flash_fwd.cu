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
// f32 gates are 1e-4 absolute on O, 1e-3 on lse) runs
// flash_fwd_tf32_wgmma_kernel at every N (f32 has no split route): K2's
// regime and, at N > 512, K3's. Every product is f32-accurate as 3xTF32 on
// tf32 wgmma (mma_tf32.cuh): each operand split into big (x truncated to
// tf32) and small (x - big rounded to tf32), a product taken k-step by
// k-step as small.big + big.small + big.big with f32 sums, so O keeps the
// error of f32 arithmetic (one tf32 term misses 1e-4). What bounds it on an
// H100: at (128, 12, 197, 64) it moves 311 MB (0.093 ms at 3.35 TB/s) and
// does 15.3 GFLOP, x 3 at 495 TFLOP/s tf32 = 0.093 ms: both alike; with the
// tiles' padding (197 rows to 256, 197 keys to 224) the tensor cores do
// ~1.5x that. In practice a block's time is latency: per key tile the
// warpgroup splits K, transposes V and runs the softmax, ~3,700 cycles with
// three blocks an SM (tools/flash_fwd_check.py --dtype f32 --trace,
// PERF.md), where the tile's 72 products take ~770 at the tensor cores'
// full rate. Design: one block per (64-row query tile, b*h), row tile
// fastest, one warpgroup (128 threads) whose thread 0 sets up the
// mbarriers and loads by TMA through f32 tensor maps (d, N, H, B) with the
// caller's byte strides, boxes of 32 columns (one 128-byte swizzled row):
// the Q tile once, then K/V tiles of 32 keys into a ring of 2 stages (1
// above d = 128), K and V of a tile sharing a stage and its full mbarrier.
// tf32 wgmma reads shared memory K-major only, so: (1) Q lands K-major for
// S = Q K^T; up to d = 64 it is split once a block, big into registers as
// the A operand (32 registers) and small written back over the Q tile as
// an A operand from shared memory, which brings the kernel to 146
// registers and three blocks an SM (both terms in registers took 174, two
// blocks and more time, PERF.md; bounded to 168, ptxas serialized the
// products);
// above d = 64 both terms are read and split 2 k-steps at a time (1 at
// d = 256) while the group before runs; (2) each K tile is split in shared
// memory (big written back in place, explicitly truncated, small beside
// it), the K-major B operand of S (split_k_tile); (3) each V tile lands
// N-major, so the warpgroup writes it transposed into big and small tiles
// (row n holds column n of V, its 32 keys in the relabelled order of an
// accumulator A operand: accumulator column 2t as k = t, 2t + 1 as
// k = t + 4), the K-major B operand of O += P V, whose A operands are P's
// two terms split in registers from the accumulators (transpose_v_tile:
// each lane gathers the 4 keys of one output chunk by 32-bit loads and
// stores it whole, every address the same for every tile). S takes wgmma
// m64n32k8 products, P V m64n64k8 (m64n32k8 at d = 32), a k-step's three
// in the order small.big, big.small, big.big. The online softmax runs on
// S's accumulators (online_softmax: ex2 on the scores times scale*log2(e)
// folded into an FMA, lse back in the natural log on store). Each tile's
// two splits overlap a product: at tile i the warpgroup forms P_i and
// issues O += P_i V_i, splits K_{i+1} while it runs, issues S_{i+1} = Q
// K_{i+1}^T, waits for P V and transposes V_{i+1} while S runs, then waits
// for S; a named barrier after each split (and before the V transpose
// overwrites V_i's) stands for the stage's empty mbarrier, so thread 0
// refills the stage at once. No group is in flight across the loop's back
// edge. S_{i+1} is issued after tile i's softmax, not before it as in the
// bf16 kernel: a split must land before the product that reads it, and
// this order hides both splits, the larger phases, under a product each.
// The V transpose is a call (__noinline__): every inlined form of the loop
// tried made ptxas (CUDA 12.9) exit with a segmentation fault. Keys past N
// arrive as TMA's zero fill and the tile that holds key N - 1 masks
// them (its products still run every k-step); O goes out through the Q
// tile's shared memory (free by then) by TMA stores, which drop rows past N
// and columns past d. Dynamic shared memory at d = 64: 64 * 256 (Q) + 2 * 2
// * 32 * 256 (the ring) + 32 * 256 (K's small term) + 2 * 64 * 128 (V^T's
// terms) + 24 bytes of barriers + 1 KB to align the base: 74,776 bytes.
// The wrapper hands over d a multiple of 4 with 16-byte row strides (a
// zero-padded copy otherwise).
//
// Both: there is no grouping of heads per program (_short_group): it existed
// because a TPU grid runs in sequence, while this grid fills the 132 SMs in
// parallel (at N > 512 the f32 grid is as short of blocks as the bf16 one
// was before its split route). Every kernel reads Q, K and V through tensor
// maps; O is written through a tensor map too, but for the split route's
// combine kernel, which writes it through element strides for the B, H and
// N axes.

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

// The online-softmax update of one tile for one warp, on the accumulator
// fragments s of its scores (both dtypes' tile bodies): LAST masks keys >= N to -1e30;
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
// tools/flash_fwd_check.py --trace makes (-DDFDT_FWD_TRACE): thread 0 of
// each block stores clock64() at entry (0), once Q and the first K tile have
// arrived (1), once the first S is done (2), after the tile loop (3), after
// the last P.V (4) and after the epilogue (5). The f32 kernel also sums, over
// the tiles after the first, the cycles of four phases of a tile (6-9): the
// softmax, P's split and the issue of P.V; the wait for the next K/V tile,
// K's split and the issue of S; the wait for P.V and V's transpose; the wait
// for S, the barrier and the refill.
#ifdef DFDT_FWD_TRACE
constexpr int kTraceBlocks = 1 << 16;
constexpr int kTraceSlots = 10;
__device__ long long g_fwd_trace[kTraceBlocks][kTraceSlots];
#define FWD_MARK(k)                                    \
  do {                                                 \
    if (threadIdx.x == 0 && blockIdx.x < kTraceBlocks) \
      g_fwd_trace[blockIdx.x][k] = clock64();          \
  } while (0)
#define FWD_PHASES long long fwd_t = clock64(), fwd_ph[4] = {0, 0, 0, 0}
#define FWD_PHASE(k)                     \
  do {                                   \
    const long long fwd_now = clock64(); \
    fwd_ph[k] += fwd_now - fwd_t;        \
    fwd_t = fwd_now;                     \
  } while (0)
#define FWD_PHASES_STORE                                                \
  do {                                                                  \
    if (threadIdx.x == 0 && blockIdx.x < kTraceBlocks)                  \
      for (int fwd_k = 0; fwd_k < 4; ++fwd_k)                           \
        g_fwd_trace[blockIdx.x][6 + fwd_k] = fwd_ph[fwd_k];             \
  } while (0)
#else
#define FWD_MARK(k) \
  do {              \
  } while (0)
#define FWD_PHASES \
  do {             \
  } while (0)
#define FWD_PHASE(k) \
  do {               \
  } while (0)
#define FWD_PHASES_STORE \
  do {                   \
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
  const void* ptrs[4] = {q, k, v, o};
  const int box_rows[4] = {C::BM, C::BN, C::BN, C::BM};
  CUtensorMap m[4];  // q, k, v, and (unsplit) o
  dfdt::LaunchCache& cache = dfdt::launch_cache();
  int err = cache.maps(m, ptrs, geo, box_rows, split ? 3 : 4, a.d, a.N, a.H, B, false);
  if (!err)
    err = cache.smem_attribute(split ? (const void*)flash_fwd_split_bf16_wgmma_kernel<DP>
                                     : (const void*)flash_fwd_bf16_wgmma_kernel<DP>,
                               (int)C::smem);
  if (err) return err;
  const long long rows = (long long)B * a.H * a.N;
  const long long blocks = (long long)B * a.H * ((a.N + C::BM - 1) / C::BM) * a.splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (split)
    flash_fwd_split_bf16_wgmma_kernel<DP><<<(unsigned)blocks, C::THREADS, C::smem, stream>>>(
        m[0], m[1], m[2], a.part_o, a.part_lse, a.H, a.N, a.d, a.splits, scale);
  else
    flash_fwd_bf16_wgmma_kernel<DP><<<(unsigned)blocks, C::THREADS, C::smem, stream>>>(
        m[0], m[1], m[2], m[3], a.lse, a.H, a.N, a.d, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !split) return (int)e;
  const long long cells = rows * (a.d / 8);
  flash_fwd_combine_kernel<<<(unsigned)((cells + kCombineThreads - 1) / kCombineThreads),
                             kCombineThreads, 0, stream>>>(a, rows);
  return (int)cudaGetLastError();
}

// ---- f32: 3xTF32 on Hopper (TMA, mbarriers, tf32 wgmma) ----

// The f32 forward's geometry at padded head dim DP (32, 64, 128 or 256):
// one warpgroup a 64-row query tile, K/V tiles of 32 keys.
template <int DP> struct TfFwd {
  static constexpr int THREADS = 128;
  static constexpr int BM = 64;                   // query rows per block
  static constexpr int BN = 32;                   // keys per K/V tile (one 128-byte row of V^T)
  static constexpr int ST = DP <= 128 ? 2 : 1;    // stages of the K/V ring
  static constexpr int NB = DP < 64 ? DP : 64;    // columns of one P.V product
  // up to d = 64 Q is split once: big kept in registers, small written over
  // its tile (an A operand from shared memory), so that three blocks fit an
  // SM; above, both terms are read and split KC k-steps a group
  static constexpr bool QREG = DP <= 64;
  static constexpr int KC = DP <= 128 ? 2 : 1;
  static constexpr int MIN_BLOCKS = QREG ? 3 : 1;  // blocks an SM the registers must allow
  static constexpr int QN = QREG ? DP / 8 : 2 * KC;  // k-steps of Q's terms in registers
  static constexpr uint32_t Q_BYTES = BM * DP * 4;
  static constexpr uint32_t TILE = BN * DP * 4;   // a K or V tile
  static constexpr uint32_t VT = DP * 128;        // V^T's big or small term: DP rows of 128 bytes
  // Q | the ring (K, V a stage) | K's small term | V^T big, small | barriers:
  // Q full, full x ST
  static constexpr uint32_t RING = Q_BYTES;
  static constexpr uint32_t KS = RING + ST * 2 * TILE;
  static constexpr uint32_t VTB = KS + TILE;
  static constexpr uint32_t BAR = VTB + 2 * VT;
  static constexpr size_t smem = BAR + (1 + ST) * 8 + 1024;  // + alignment of the base
};

// K's tile (32 rows at kt, as TMA landed it) split for 3xTF32 by the
// warpgroup: big (x truncated to tf32) written back in place, small at ks,
// the same layout: the K-major B operand of S = Q K^T. Thread t takes the
// 16-byte chunks t + 128 i, G at a time (all read before the first write:
// the accesses are ordered asm), so a warp's 8 lanes take a 128-byte row.
// (flash_bwd.cu's split_tile, which holds all of a thread's chunks at once,
// took 28 % more time at d = 256 here, PERF.md.)
template <int DP>
__device__ __forceinline__ void split_k_tile(uint32_t kt, uint32_t ks) {
  constexpr int IT = 32 * DP / 4 / 128;  // chunks a thread
  constexpr int G = IT < 4 ? IT : 4;
#pragma unroll
  for (int i0 = 0; i0 < IT; i0 += G) {
    float4 x[G];
#pragma unroll
    for (int i = 0; i < G; ++i) x[i] = dfdt::ld_shared_v4(kt + (threadIdx.x + (i0 + i) * 128) * 16);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const uint32_t off = (threadIdx.x + (i0 + i) * 128) * 16;
      uint32_t big[4], small[4];
      dfdt::split_tf32(x[i].x, big[0], small[0]);
      dfdt::split_tf32(x[i].y, big[1], small[1]);
      dfdt::split_tf32(x[i].z, big[2], small[2]);
      dfdt::split_tf32(x[i].w, big[3], small[3]);
      dfdt::st_shared_v4(kt + off, big[0], big[1], big[2], big[3]);
      dfdt::st_shared_v4(ks + off, small[0], small[1], small[2], small[3]);
    }
  }
}

// V's tile (32 keys at vt, as TMA landed it) written transposed as its two
// tf32 terms: row c of tb (big) and of ts (small) holds column c of V, its
// 32 keys in the relabelled k order (key 8j + 2u at k-step j's position u,
// 8j + 2u + 1 at u + 4), 128-byte swizzled: the K-major B operand of O +=
// P V. A unit is one 32-column block, one k-step j and one parity of keys;
// warp w takes units w + 4 i, each lane one column: the 4 keys of its
// column (32-bit loads: the 32 lanes on 32 banks), split, go out as one
// 16-byte chunk of each term (8 lanes on 8 chunks). Every address is the
// same for every tile: a base and constant offsets. G units are read before
// the first of them is written. A call, not inlined: see the header.
template <int DP>
__device__ __noinline__ void transpose_v_tile(uint32_t vt, uint32_t tb, uint32_t ts) {
  constexpr int IT = DP / 16;  // units a warp
  constexpr int G = IT < 4 ? IT : 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, p = warp & 1;
  // key 8j + 2u + p of this lane's column, less the unit's offset
  uint32_t src[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    src[u] = vt + (2 * u + p) * 128 + (((lane >> 2) ^ (2 * u + p)) << 4) + (lane & 3) * 4;
  // unit warp + 4 i: p, k-step j and column block in bits 0, 1-2 and 3 on
  auto keys = [&](int i) { return (((warp + 4 * i) >> 3) * 32 + ((warp + 4 * i) >> 1 & 3) * 8); };
#pragma unroll
  for (int i0 = 0; i0 < IT; i0 += G) {
    float x[G][4];
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) x[i][u] = dfdt::ld_shared_f32(src[u] + keys(i0 + i) * 128);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int unit = warp + 4 * (i0 + i), j = unit >> 1 & 3;
      uint32_t big[4], small[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) dfdt::split_tf32(x[i][u], big[u], small[u]);
      const uint32_t to = ((unit >> 3) * 32 + lane) * 128 + (((2 * j + p) ^ (lane & 7)) << 4);
      dfdt::st_shared_v4(tb + to, big[0], big[1], big[2], big[3]);
      dfdt::st_shared_v4(ts + to, small[0], small[1], small[2], small[3]);
    }
  }
}

// One block per (64-row query tile, b*h), row tile fastest: O = softmax(Q
// K^T scale) V and lse over every key tile, in f32 (the design: the header).
template <int DP>
__global__ void __launch_bounds__(TfFwd<DP>::THREADS, TfFwd<DP>::MIN_BLOCKS)
flash_fwd_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap to, float* __restrict__ lse,
                            int H, int N, float scale) {
  FWD_MARK(0);
  using C = TfFwd<DP>;
  constexpr int BN = C::BN, ST = C::ST, NB = C::NB, CBO = DP / NB, NT = BN / 8, KC = C::KC;
  constexpr uint32_t TILE = C::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (dfdt::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, ring = base + C::RING, sKs = base + C::KS;
  const uint32_t sVtb = base + C::VTB, sVts = sVtb + C::VT;
  const uint32_t q_full = base + C::BAR;
  auto full = [&](int st) { return q_full + 8 + 8 * st; };

  const dfdt::Work w = dfdt::block_work<C::BM, BN>(N, 1);
  const int b = w.bh / H;
  const int h = w.bh % H;
  const int n = w.t1;  // key tiles
  const bool leader = threadIdx.x == 0;
  // K/V tile i into its stage (free: the caller has passed the barrier
  // after the stage's last reader)
  auto load_kv = [&](int i) {
    const uint32_t kt = ring + 2 * (i % ST) * TILE;
    dfdt::mbar_expect_tx(full(i % ST), 2 * TILE);
    dfdt::load_f32<DP, BN, BN>(kt, &tk, full(i % ST), i * BN, h, b);
    dfdt::load_f32<DP, BN, BN>(kt + TILE, &tv, full(i % ST), i * BN, h, b);
  };
  if (leader) {
    dfdt::tma_prefetch(&tq);
    dfdt::tma_prefetch(&tk);
    dfdt::tma_prefetch(&tv);
    dfdt::tma_prefetch(&to);
    dfdt::mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < ST; ++st) dfdt::mbar_init(full(st), 1);
    dfdt::mbar_fence_init();
    dfdt::mbar_expect_tx(q_full, C::Q_BYTES);
    dfdt::load_f32<DP, C::BM, C::BM>(sQ, &tq, q_full, w.row0, h, b);
    for (int i = 0; i < ST && i < n; ++i) load_kv(i);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tq4 = lane % 4;
  const float sl2 = scale * kLog2e;
  float m[2] = {kNegBig, kNegBig};  // running max, log2 units, rows g and g + 8
  float l[2] = {0.f, 0.f};          // this lane's part of the running sum
  float alpha[2];
  float acc[CBO][NB / 8][4] = {};   // O, NB columns of d at a time
  float s[NT][4];                   // S, then P, of one key tile
  uint32_t pb[NT][4], ps[NT][4];    // P's terms as the A operands of its k-steps
  uint32_t qb[C::QN][4], qs[C::QREG ? 1 : C::QN][4];  // Q's terms as A operands

  // Q's A operands of k-steps [k0, k0 + cnt) into slots [slot, slot + cnt),
  // read from its tile and split (above d = 64)
  auto load_q = [&](int k0, int slot, int cnt) {
    const int r = warp * 16 + lane / 4;
#pragma unroll
    for (int kk = 0; kk < cnt; ++kk) {
      const int col = (k0 + kk) * 8 + tq4;
      const uint32_t o[4] = {dfdt::sw_f32(r, col, 64), dfdt::sw_f32(r + 8, col, 64),
                             dfdt::sw_f32(r, col + 4, 64), dfdt::sw_f32(r + 8, col + 4, 64)};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dfdt::split_tf32(dfdt::ld_shared_f32(sQ + o[e]), qb[slot + kk][e], qs[slot + kk][e]);
    }
  };
  // Q's big terms into registers and its small terms over its tile, in place
  auto split_q = [&]() {
    const int r = warp * 16 + lane / 4;
    uint32_t o[DP / 8][4];
    float x[DP / 8][4];
#pragma unroll
    for (int kd = 0; kd < DP / 8; ++kd) {
      const int col = kd * 8 + tq4;
      o[kd][0] = dfdt::sw_f32(r, col, 64);
      o[kd][1] = dfdt::sw_f32(r + 8, col, 64);
      o[kd][2] = dfdt::sw_f32(r, col + 4, 64);
      o[kd][3] = dfdt::sw_f32(r + 8, col + 4, 64);
#pragma unroll
      for (int e = 0; e < 4; ++e) x[kd][e] = dfdt::ld_shared_f32(sQ + o[kd][e]);
    }
#pragma unroll
    for (int kd = 0; kd < DP / 8; ++kd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t small;
        dfdt::split_tf32(x[kd][e], qb[kd][e], small);
        dfdt::st_shared_b32(sQ + o[kd][e], small);
      }
  };
  // the three products of k-step kd of S = Q K^T, Q's big term in slot q
  // (its small term in slot q, or over its tile), K's big in place at kt,
  // its small term at sKs
  auto s_kstep = [&](uint32_t kt, int kd, int q) {
    const uint32_t off = ((kd / 4) * BN * 128 + (kd % 4) * 32) >> 4;
    const uint64_t db = dfdt::desc_sw128(kt, 16, 1024) + off;
    const uint64_t ds = dfdt::desc_sw128(sKs, 16, 1024) + off;
    if constexpr (C::QREG) {
      static_assert(BN == 32, "Q's small term enters m64n32k8 products");
      const uint32_t qoff = ((kd / 4) * C::BM * 128 + (kd % 4) * 32) >> 4;
      dfdt::wgmma_tf32_ss_n32(s, dfdt::desc_sw128(sQ, 16, 1024) + qoff, db, kd > 0);
    } else {
      dfdt::wgmma_tf32<BN>(s, qs[q], db, kd > 0);
    }
    dfdt::wgmma_tf32<BN>(s, qb[q], ds, 1);
    dfdt::wgmma_tf32<BN>(s, qb[q], db, 1);
  };
  // S = Q K^T of the split K tile at kt: one group, or (Q read from its
  // tile) a group of KC k-steps at a time, the next KC read and split while
  // one runs
  auto issue_s = [&](uint32_t kt) {
    if constexpr (C::QREG) {
      dfdt::fence_regs(s);
      dfdt::wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < DP / 8; ++kd) s_kstep(kt, kd, kd);
      dfdt::wgmma_commit();
    } else {
      load_q(0, 0, KC);
#pragma unroll
      for (int g = 0; g < DP / 8 / KC; ++g) {
        const int u = (g & 1) * KC;
        dfdt::fence_regs(s);
        dfdt::fence_regs(qb);
        dfdt::fence_regs(qs);
        dfdt::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) s_kstep(kt, g * KC + kk, u + kk);
        dfdt::wgmma_commit();
        if (g + 1 < DP / 8 / KC) {
          dfdt::wgmma_wait<1>();  // group g - 1, the last reader of the other slots, is done
          dfdt::fence_regs(qb);
          dfdt::fence_regs(qs);
          load_q((g + 1) * KC, KC - u, KC);
        }
      }
    }
  };
  // O += P V: P's terms (pb, ps) from registers, V^T's from shared memory,
  // NB columns a product; one group
  auto issue_pv = [&]() {
#pragma unroll
    for (int cb = 0; cb < CBO; ++cb) dfdt::fence_regs(acc[cb]);
    dfdt::fence_regs(pb);
    dfdt::fence_regs(ps);
    dfdt::wgmma_fence();
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int cb = 0; cb < CBO; ++cb) {
        const uint32_t off = (cb * NB * 128 + j * 32) >> 4;
        const uint64_t db = dfdt::desc_sw128(sVtb, 16, 1024) + off;
        const uint64_t ds = dfdt::desc_sw128(sVts, 16, 1024) + off;
        dfdt::wgmma_tf32<NB>(acc[cb], ps[j], db, 1);
        dfdt::wgmma_tf32<NB>(acc[cb], pb[j], ds, 1);
        dfdt::wgmma_tf32<NB>(acc[cb], pb[j], db, 1);
      }
    dfdt::wgmma_commit();
  };
  auto retire_pv = [&]() {
#pragma unroll
    for (int cb = 0; cb < CBO; ++cb) dfdt::fence_regs(acc[cb]);
    dfdt::fence_regs(pb);
    dfdt::fence_regs(ps);
  };

  // Q's terms (up to d = 64), the first tile's splits and its S
  dfdt::mbar_wait(q_full, 0);
  if constexpr (C::QREG) split_q();
  dfdt::mbar_wait(full(0), 0);
  FWD_MARK(1);
  split_k_tile<DP>(ring, sKs);
  transpose_v_tile<DP>(ring + TILE, sVtb, sVts);
  dfdt::fence_proxy_async();
  dfdt::named_bar_sync(1, C::THREADS);
  issue_s(ring);
  dfdt::wgmma_wait<0>();
  dfdt::fence_regs(s);
  dfdt::fence_regs(qb);
  dfdt::fence_regs(qs);
  dfdt::named_bar_sync(1, C::THREADS);  // every warp's S is done: stage 0 is free
  if (leader && ST < n) load_kv(ST);
  FWD_MARK(2);
  FWD_PHASES;

  // the softmax of tile i on s, P's terms, then O += P V, issued
  auto softmax_pv = [&](int i) {
    if ((i + 1) * BN > N)
      online_softmax<NT, true, true>(s, m, l, alpha, i * BN, N, sl2, tq4);
    else
      online_softmax<NT, false, true>(s, m, l, alpha, i * BN, N, sl2, tq4);
#pragma unroll
    for (int cb = 0; cb < CBO; ++cb)
#pragma unroll
      for (int j = 0; j < NB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[cb][j][e] *= alpha[e >> 1];
    // accumulator column 2t is k = t, 2t + 1 is k = t + 4
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      dfdt::split_tf32(s[j][0], pb[j][0], ps[j][0]);
      dfdt::split_tf32(s[j][2], pb[j][1], ps[j][1]);
      dfdt::split_tf32(s[j][1], pb[j][2], ps[j][2]);
      dfdt::split_tf32(s[j][3], pb[j][3], ps[j][3]);
    }
    issue_pv();
  };

  // tile i's P V runs while K_{i+1} is split and S_{i+1} issued; then V_{i+1}
  // is transposed while S_{i+1} runs
  for (int i = 0; i + 1 < n; ++i) {
    softmax_pv(i);
    FWD_PHASE(0);
    const int st = (i + 1) % ST;
    const uint32_t kt = ring + 2 * st * TILE;
    dfdt::mbar_wait(full(st), ((i + 1) / ST) & 1);
    split_k_tile<DP>(kt, sKs);
    dfdt::fence_proxy_async();
    dfdt::named_bar_sync(1, C::THREADS);
    issue_s(kt);
    FWD_PHASE(1);
    // V_{i+1} transposed while S_{i+1} runs, once every warp is past P V
    dfdt::wgmma_wait<1>();
    retire_pv();
    dfdt::named_bar_sync(1, C::THREADS);
    transpose_v_tile<DP>(kt + TILE, sVtb, sVts);
    dfdt::fence_proxy_async();
    FWD_PHASE(2);
    dfdt::wgmma_wait<0>();
    dfdt::fence_regs(s);
    dfdt::fence_regs(qb);
    dfdt::fence_regs(qs);
    // V^T is written and every warp's S is done: the stage is free
    dfdt::named_bar_sync(1, C::THREADS);
    if (leader && i + 1 + ST < n) load_kv(i + 1 + ST);
    FWD_PHASE(3);
  }
  FWD_MARK(3);
  softmax_pv(n - 1);
  dfdt::wgmma_wait<0>();
  retire_pv();
  FWD_MARK(4);
  FWD_PHASES_STORE;

  const int g = lane / 4;
  float inv[2], row_lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float l_safe = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / l_safe;
    row_lse[i] = m[i] * kLn2 + logf(l_safe);
  }
  // O through the Q tile's shared memory, swizzled as TMA stores it: every
  // warp's last read of it (Q's split, or the last S) is behind a barrier
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
#pragma unroll
    for (int cb = 0; cb < CBO; ++cb)
#pragma unroll
      for (int j = 0; j < NB / 8; ++j)
        dfdt::st_shared_v2(sQ + dfdt::sw_f32(r, cb * NB + j * 8 + 2 * tq4, 64),
                           acc[cb][j][2 * i] * inv[i], acc[cb][j][2 * i + 1] * inv[i]);
    if (tq4 == 0 && w.row0 + r < N) lse[(long long)w.bh * N + w.row0 + r] = row_lse[i];
  }
  dfdt::fence_proxy_async();
  dfdt::named_bar_sync(1, C::THREADS);
  if (leader) {
#pragma unroll
    for (int cb = 0; cb < DP / 32; ++cb)
      dfdt::tma_store_4d(&to, sQ + cb * C::BM * 128, cb * 32, w.row0, h, b);
    dfdt::tma_store_commit();
    dfdt::tma_store_wait_read();
  }
  FWD_MARK(5);
}

// geo: 9 values per operand (q, k, v, o), as encode_map reads them; Q's and
// O's boxes 64 rows, K's and V's 32, every box 32 columns
template <int DP>
int launch_tf32(const void* q, const void* k, const void* v, void* o, float* lse,
                const long long* geo, int B, int H, int N, int d, float scale,
                cudaStream_t stream) {
  using C = TfFwd<DP>;
  const void* ptrs[4] = {q, k, v, o};
  const int box_rows[4] = {C::BM, C::BN, C::BN, C::BM};
  CUtensorMap m[4];
  dfdt::LaunchCache& cache = dfdt::launch_cache();
  int err = cache.maps(m, ptrs, geo, box_rows, 4, d, N, H, B, true);
  if (!err) err = cache.smem_attribute((const void*)flash_fwd_tf32_wgmma_kernel<DP>, (int)C::smem);
  if (err) return err;
  const long long blocks = (long long)B * H * ((N + C::BM - 1) / C::BM);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_fwd_tf32_wgmma_kernel<DP><<<(unsigned)blocks, C::THREADS, C::smem, stream>>>(
      m[0], m[1], m[2], m[3], lse, H, N, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The two int64 blocks of a forward call (ops/attention.py packs them). The
// plan, built once per shape, strides, dtype, device and alignment of the
// inputs: the call's sizes (d the head dim the kernels see), the dtype, the
// scale's f32 bits, 12 element strides ((b, h, n) of q, k, v and o; the
// combine kernel's o) and the tensor maps' geometries (9 values for each of
// q, k, v and o, as encode_map reads them). The call: the pointers, the
// stream and the split count S (1, or bf16's key splits, with `scratch` an
// f32 buffer of S*B*H*N*(d + 1) elements for the partials).
enum FwdPlan { kPB, kPH, kPN, kPD, kPBf16, kPScale, kPStrides, kPGeo = kPStrides + 12 };
enum FwdCall { kCQ, kCK, kCV, kCO, kCLse, kCScratch, kCStream, kCSplits };

// Both dtypes read q, k and v and write o through tensor maps: bf16 (d a
// multiple of 8) goes to the Hopper kernels, f32 (d a multiple of 4) to the
// 3xTF32 Hopper kernel.
extern "C" int dfdt_flash_fwd(const long long* call, const long long* plan) {
  const int B = (int)plan[kPB], H = (int)plan[kPH], N = (int)plan[kPN], d = (int)plan[kPD];
  const bool is_bf16 = plan[kPBf16] != 0;
  const int splits = (int)call[kCSplits];
  void* scratch = reinterpret_cast<void*>(call[kCScratch]);
  if (B < 1 || H < 1 || N < 1 || d < 1 || d > 256 || N > 65535 * kBlockM || splits < 1 ||
      (splits > 1 && (!is_bf16 || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (d % (is_bf16 ? 8 : 4)) return (int)cudaErrorMisalignedAddress;
  float scale;
  const uint32_t scale_bits = (uint32_t)plan[kPScale];
  std::memcpy(&scale, &scale_bits, sizeof scale);
  const long long* strides = plan + kPStrides;
  const long long* tma = plan + kPGeo;
  const void* q = reinterpret_cast<const void*>(call[kCQ]);
  const void* k = reinterpret_cast<const void*>(call[kCK]);
  const void* v = reinterpret_cast<const void*>(call[kCV]);
  void* o = reinterpret_cast<void*>(call[kCO]);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(call[kCStream]);
  float* l = reinterpret_cast<float*>(call[kCLse]);
  if (!is_bf16) {
    if (d <= 32) return launch_tf32<32>(q, k, v, o, l, tma, B, H, N, d, scale, s);
    if (d <= 64) return launch_tf32<64>(q, k, v, o, l, tma, B, H, N, d, scale, s);
    if (d <= 128) return launch_tf32<128>(q, k, v, o, l, tma, B, H, N, d, scale, s);
    return launch_tf32<256>(q, k, v, o, l, tma, B, H, N, d, scale, s);
  }
  const Strides so{strides[9], strides[10], strides[11]};
  if (so.b % 2 || so.h % 2 || so.n % 2 || reinterpret_cast<uintptr_t>(o) % 4)
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

// Forget the tensor maps and shared-memory attributes this library keeps
// (tests: a cleared cache must give the same results).
extern "C" void dfdt_clear_launch_cache() { dfdt::launch_cache().clear(); }

#ifdef DFDT_FWD_TRACE
// the first `blocks` blocks' cycle marks and phase sums (kTraceSlots each)
// of the last traced launch
extern "C" int dfdt_fwd_trace(long long* out, int blocks) {
  return (int)cudaMemcpyFromSymbol(out, g_fwd_trace, sizeof(long long) * kTraceSlots * blocks);
}
#endif

extern "C" const char* dfdt_error_string(int code) { return dfdt::error_string(code); }
