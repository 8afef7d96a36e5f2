// Flash attention backward for Hopper: dQ, dK and dV of O = softmax(Q K^T s) V,
// s = 1/sqrt(d), from the forward's O and per-row logsumexp L.
//
// Replaces deepfake_video_detection_tpu/ops/attention.py::_short_bwd_kernel
// (K4, n_pad <= 512: the ViT blocks in training, N = 197 at 224 px) and
// computes the same functions as ::_bwd_dq_kernel (K5) and ::_bwd_dkv_kernel
// (K6), the streaming FlashAttention-2 passes for n_pad > 512, since both
// kernels here stream over any N. As in those kernels: keys >= N get P = 0
// (the -1e30 mask), query rows >= N get P = 0 (the padded rows the TPU
// kernels zero explicitly), sums are taken in f32 whatever the input type
// (the bf16 kernels round P and dS once to bf16 as product operands), and
// dQ, dK, dV are written in the input type.
//
// Why two passes and not K4's single program: K4 runs one program per group
// of heads that holds the whole (Np, Np) f32 score slab on chip. At Np = 256
// that is 256 KB per head, and a Hopper block has at most 227 KB of shared
// memory. So the design is FlashAttention-2's: a dQ pass (one block per
// 64-row query tile, streaming K/V tiles) and a dK/dV pass (one block per
// 64-key tile, streaming Q/dO tiles). Each recomputes S and P from L, so P is
// computed twice where K4 computed it once. Blocks write disjoint rows: no
// atomics (FlashAttention-3's one pass adds dQ by f32 atomics, whose order
// changes from run to run), and repeated runs agree bit for bit.
//
// D = rowsum(dO * O) is fused into the dQ pass: each dQ block computes D for
// its own query rows and writes it to a scratch vector; the dK/dV pass,
// launched after it on the same stream, reads it. (On the split route every
// split block of a row tile computes D, the same sum in the same order, and
// split 0 writes it.)
//
// What bounds it on an H100: by the roofline, bytes. At the ViT-B/16
// training shape (128, 12, 197, 64) bf16 the function reads q, k, v, O, dO
// (5 x 38.7 MB) and lse, and writes dq, dk, dv (3 x 38.7 MB): ~312 MB,
// ~0.093 ms at 3.35 TB/s; its 10*N^2*d*B*H = 38 GFLOP take ~0.039 ms at
// 989 TFLOP/s. Two passes read ~470 MB (0.14 ms). Routed by dtype in
// dfdt_flash_bwd, and bf16 by the split count S:
//
// bf16 (every path under --bf16) runs flash_bwd_dq_bf16_wgmma_kernel and
// flash_bwd_dkv_bf16_wgmma_kernel (S = 1: N <= 512, the ViT blocks), built
// as the forward is from Hopper's own parts (wgmma_tma.cuh). A block is one
// warpgroup (4 warps, 16 of the block's 64 rows each: query rows in the dQ
// pass, key rows in the dK/dV pass) whose thread 0 sets up the mbarriers
// and loads by TMA through 4-D tensor maps (d, N, H, B) built from the
// caller's byte strides (tma_map.cuh; the q/k/v views of a fused QKV
// projection and dO's head-merge view go in as they are): the block's own
// tiles once (Q, dO and O; or K and V), then the streamed 64-row tiles
// (K/V; or Q/dO) through a ring of 3 stages (2 above d = 128) with a full
// and an empty mbarrier a stage. Tiles land 128-byte swizzled, one box per
// 64 columns of the head dim; rows past N and columns past d arrive as
// TMA's zero fill. Every product is a wgmma m64n64k16 with f32 accumulators
// in the layouts of the forward: S = Q K^T and dP = dO V^T (dQ pass), S^T =
// K Q^T and dP^T = V dO^T (dK/dV pass) with both operands K-major from
// shared memory; dQ += dS K, dV += P^T dO and dK += dS^T Q with P and dS
// rounded once to bf16 in registers as the A operand (c_to_a) and K, dO, Q
// as the MN-major B, so Q and dO serve the dK/dV pass through two
// descriptors of one TMA tile. P = exp2(S * scale*log2(e) - L*log2(e)) and
// dS = P (dP - D) are formed on the accumulators. Each iteration issues S
// and dP of tile i, then the dQ (dK, dV) products of tile i - 1, and forms
// P while dP and those run and dS while those run; it retires every product
// before the next (a group in flight across the loop's back edge, or a
// product under a branch, made ptxas serialize them: notes C7514/C7515/
// C7520). The dK/dV pass takes each streamed tile's lse and D rows by
// cp.async of its threads into the ring stage, tracked by the stage's full
// mbarrier (a (B*H, N) f32 row of 197 is not a multiple of 16 bytes, which
// TMA requires). Each block writes one 64-column block of its outputs (d >
// 64 runs d / 64 blocks a row tile, each recomputing S and dP over the whole
// d: a 64 x DP dK and dV would not fit a warpgroup's registers above d =
// 64), in bf16 through shared memory and a TMA store. At d = 64 (ptxas,
// sm_90a): the dQ pass 168 registers, 3 blocks an SM, 75,072 bytes of
// dynamic shared memory; the dK/dV pass 200-202 registers, 2 blocks an SM,
// 68,152 bytes; no spill. Padding: the streamed tile that holds row N - 1
// masks P (its products still run every 16-row step). The head dim is
// padded to DP, a multiple of 64; the wrapper hands over d a multiple of 8
// with 16-byte row strides (a zero-padded copy otherwise).
//
// The split route (bf16, chosen by the wrapper for N > 512: the TPU's
// streaming passes K5 and K6, the long-clip temporal transformer in
// training). With B*H = 4 heads the two passes have few blocks on 132 SMs,
// each walking every streamed tile in series. The wrapper picks S splits
// from the shape alone (ops/attention.py, _long_splits), and
// flash_bwd_dq_split_bf16_wgmma_kernel and
// flash_bwd_dkv_split_bf16_wgmma_kernel run one block per (64-row tile,
// column block, split, b*h), row tile fastest: the dQ pass splits its key
// tiles, the dK/dV pass its query tiles, each block walking its own
// balanced run (at least 2 tiles, so only the last split holds row N - 1)
// with the same body as above and writing unscaled f32 partials of dQ, or
// of dK and dV, to the caller's scratch, 3*S*B*H*N*d*4 bytes.
// flash_bwd_reduce_kernel then sums each row's S partials in order, applies
// the scale (dQ, dK) and rounds once to bf16 through the caller's strides:
// no atomics, reruns are bit-identical.
//
// f32 (the training CLI's default without --bf16; the f32 gate is atol =
// rtol = 1e-3) runs flash_bwd_dq_tf32_wgmma_kernel and
// flash_bwd_dkv_tf32_wgmma_kernel at every N (f32 has no split route): K4's
// regime and, at N > 512, K5's and K6's. Two passes as above (one warpgroup
// a block owning 64 rows, row tile fastest, D fused into the dQ pass, each
// block writing one column block of its outputs: 64 columns, 32 at d <= 32;
// no atomics, so reruns are bit-identical), every product f32-accurate as
// 3xTF32 on tf32 wgmma: each operand split into big (x truncated to tf32)
// and small (x - big rounded to tf32, cvt.rna's rounding), a product taken
// k-step by k-step as small.big + big.small + big.big with f32 sums. Thread
// 0 loads the block's own tiles once (and, in the dQ pass up to d = 128, O
// for D) and the streamed tiles (32 rows, 16 above d = 128) through a ring
// of 2 stages (dQ up to d = 128) or 1 by TMA, through f32 tensor maps whose
// boxes are 32 columns (one 128-byte swizzled row) by 32 (16) rows. tf32
// wgmma reads shared-memory operands K-major only, so the design is built
// around that: (1) the own side's operands of S = Q K^T and dP = dO V^T (dQ
// pass) and of S^T = K Q^T and dP^T = V dO^T (dK/dV pass) are A operands,
// read from the landed tiles into registers 2 k-steps at a time (the next
// 2 while a group runs) and split there; (2) once a streamed tile lands,
// the warpgroup splits it in shared memory (big written back in place,
// small beside it), the K-major B operand of those products, and writes big
// and small of the block's output columns transposed (K^T; Q^T and dO^T),
// the K-major B operand of dQ += dS K, dK += dS^T Q and dV += P^T dO, whose
// A operands (dS, dS^T, P^T) come from the accumulators and are split in
// registers; the transposed rows are stored in the relabelled order of
// mma_tf32.cuh (accumulator column 2t as k = t, 2t + 1 as k = t + 4), so an
// accumulator feeds the next product with no shuffle. Big is written
// explicitly, so no product depends on what the tensor core does with the
// low 13 bits of an f32 operand. Turning those three products around
// instead (dQ^T = K^T dS^T and so on: K, Q and dO as A operands read from
// their tiles, dS and P written as B tiles) took no transposes but more
// time: the writes, a proxy fence and a barrier between the softmax and
// the products cost more than the transposes did (PERF.md §6). Each
// product is retired before the next step (a group in flight across a
// loop's back edge made ptxas serialize the bf16 products), and two blocks
// run on an SM at d = 64 to overlap one block's splits and softmax with
// the other's products: at d = 64 (ptxas, sm_90a) the dQ pass 197-198
// registers and 99,624 bytes of dynamic shared memory, the dK/dV pass 227
// registers and 99,864 bytes; no spill. What bounds it on an H100: at (128,
// 12, 197, 64) it moves ~621 MB (0.185 ms at 3.35 TB/s) and does 38.2 GFLOP,
// x 3 at 495 TFLOP/s tf32 = 0.231 ms: operations. Above d = 128, D reads O
// and dO from global memory, so the wrapper hands over 16-byte rows (d a
// multiple of 4; a zero-padded copy otherwise).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "tma_map.cuh"
#include "wgmma_tma.cuh"

namespace {

struct Strides {
  long long b, h, n;
};

// ---- bf16: the Hopper kernels (TMA, mbarriers, wgmma) ----

constexpr float kLog2e = 1.4426950408889634f;

// 2^x, with a denormal result flushed to 0: one MUFU.EX2
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DP> struct HopperBwd {
  // one warpgroup, the block's 64 rows; its thread 0 also issues the TMA
  // loads. A producer warp of its own, as the forward has, would hold as
  // many registers as a consumer: 5 warps of 200 (the dK/dV pass at d = 64)
  // fit one block an SM, since an SM's 4 partitions hold 16,384 registers
  // each and so 2 such warps; 4 warps fit two blocks.
  static constexpr int THREADS = 128;
  static constexpr int ROWS = 64;                 // rows a block owns, and a streamed tile's
  static constexpr int CB = DP / 64;              // 64-column blocks of d; a block writes one
  // of the streamed ring: a stage is held while the next tile's products
  // run, so 3 keep a load in flight; 2 above d = 128 (shared memory)
  static constexpr int STAGES = DP <= 128 ? 3 : 2;
  static constexpr uint32_t TILE = ROWS * DP * 2;  // one 64-row bf16 tile, 1024-byte aligned
  // dQ pass: Q, dO, O, the stages (K then V), D of the block's rows, then
  // the barriers: Q and dO full, O full, full x STAGES, empty x STAGES
  static constexpr uint32_t DQ_RING = 3 * TILE;
  static constexpr uint32_t DQ_D = DQ_RING + STAGES * 2 * TILE;
  static constexpr uint32_t DQ_BAR = DQ_D + ROWS * 4;
  static constexpr size_t dq_smem = DQ_BAR + (2 + 2 * STAGES) * 8 + 1024;  // + base alignment
  // dK/dV pass: K, V, the stages (Q then dO), each stage's lse and D rows,
  // then the barriers: K and V full, full x STAGES, empty x STAGES
  static constexpr uint32_t DKV_RING = 2 * TILE;
  static constexpr uint32_t DKV_LD = DKV_RING + STAGES * 2 * TILE;
  static constexpr uint32_t DKV_BAR = DKV_LD + STAGES * 2 * ROWS * 4;
  static constexpr size_t dkv_smem = DKV_BAR + (1 + 2 * STAGES) * 8 + 1024;
};

// The work of one block: its 64 rows from row0 of head bh = (b, h), its
// output column block cg, and the streamed tiles [t0, t1) of split s.
// Blocks go row tile fastest, then column block, split and head, so the
// blocks that share a head's streamed tiles run together and share them in
// L2. The splits are balanced as dfdt::block_work balances them.
struct BwdWork {
  int row0, cg, s, bh, b, h, t0, t1;
};

template <int CB, bool SPLIT>
__device__ __forceinline__ BwdWork bwd_work(int N, int H, int splits) {
  const int n_tiles = (N + 63) / 64;  // row tiles and streamed tiles alike
  const int S = SPLIT ? splits : 1;
  int x = blockIdx.x;
  BwdWork w;
  w.row0 = (x % n_tiles) * 64;
  x /= n_tiles;
  w.cg = x % CB;
  x /= CB;
  w.s = x % S;
  w.bh = x / S;
  w.b = w.bh / H;
  w.h = w.bh % H;
  w.t0 = w.s * n_tiles / S;
  w.t1 = (w.s + 1) * n_tiles / S;
  return w;
}

// Cycle marks of a block's phases, kept only in the build that
// tools/flash_bwd_check.py --trace makes (-DDFDT_BWD_TRACE): thread 0 of
// each block of pass p (0: dQ, 1: dK/dV) stores clock64() at entry (0),
// once the block's own tiles and the first streamed tile have arrived (1),
// after the first streamed tile's products are issued (2), after the tile
// loop's last product (3) and after the epilogue (4). The f32 passes also
// sum, over their streamed tiles, the cycles of four phases of a tile
// (5-8): waiting for it and splitting it (barriers included), the products
// over the head dim (S, dP), the softmax (P, dS; the stage's release
// included) and the products of P or dS.
#ifdef DFDT_BWD_TRACE
constexpr int kTraceBlocks = 1 << 16;
constexpr int kTraceSlots = 9;
__device__ long long g_bwd_trace[2][kTraceBlocks][kTraceSlots];
#define BWD_MARK(p, k)                                 \
  do {                                                 \
    if (threadIdx.x == 0 && blockIdx.x < kTraceBlocks) \
      g_bwd_trace[p][blockIdx.x][k] = clock64();       \
  } while (0)
#define BWD_PHASES long long bwd_t = clock64(), bwd_ph[4] = {0, 0, 0, 0}
#define BWD_PHASE(k)                  \
  do {                                \
    const long long bwd_now = clock64(); \
    bwd_ph[k] += bwd_now - bwd_t;     \
    bwd_t = bwd_now;                  \
  } while (0)
#define BWD_PHASES_STORE(p)                                                   \
  do {                                                                        \
    if (threadIdx.x == 0 && blockIdx.x < kTraceBlocks)                        \
      for (int bwd_k = 0; bwd_k < 4; ++bwd_k)                                 \
        g_bwd_trace[p][blockIdx.x][5 + bwd_k] = bwd_ph[bwd_k];                \
  } while (0)
#else
#define BWD_MARK(p, k) \
  do {                 \
  } while (0)
#define BWD_PHASES \
  do {             \
  } while (0)
#define BWD_PHASE(k) \
  do {               \
  } while (0)
#define BWD_PHASES_STORE(p) \
  do {                      \
  } while (0)
#endif

// One 64-row tile of a tensor map into shared memory at dst, its 64-column
// blocks one after another, completing on bar.
template <int CB>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int row0, int h, int b) {
#pragma unroll
  for (int cb = 0; cb < CB; ++cb)
    dfdt::tma_load_4d(dst + cb * 64 * 128, map, bar, cb * 64, row0, h, b);
}

// d = A B^T over the head dim, 64 x 64 x DP, as one group: A and B 64-row
// tiles in shared memory, both K-major (d contiguous; 8-row groups 1024
// bytes apart, a k-step of 16 columns 32 bytes into the swizzled row, a
// column block 64 rows on).
template <int DP>
__device__ __forceinline__ void issue_abt(float (&d)[8][4], uint32_t a, uint32_t b) {
  const uint64_t desc_a = dfdt::desc_sw128(a, 16, 1024);
  const uint64_t desc_b = dfdt::desc_sw128(b, 16, 1024);
  dfdt::fence_regs(d);
  dfdt::wgmma_fence();
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
    const uint32_t off = ((kd / 4) * 64 * 128 + (kd % 4) * 32) >> 4;
    dfdt::wgmma_ss_n64(d, desc_a + off, desc_b + off, kd > 0);
  }
  dfdt::wgmma_commit();
}

// acc += X Y, 64 x 64 x 64, as one group: X from registers (x[kk] the A
// operand of its 16-row step kk), Y column block cg of the streamed tile at
// y (its rows the reduction axis, d contiguous: the MN-major B, 8-row groups
// 1024 bytes apart, column blocks 64 rows apart). Every step is issued, also
// in the tile that holds row N - 1 (its X is 0 past N): skipping them by a
// branch made ptxas serialize the products (note C7520), which was slower.
__device__ __forceinline__ void issue_xy(float (&acc)[8][4], uint32_t (&x)[4][4], uint32_t y,
                                         int cg) {
  const uint64_t desc_y = dfdt::desc_sw128(y, 64 * 128, 1024);
  dfdt::fence_regs(acc);
  dfdt::fence_regs(x);
  dfdt::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    dfdt::wgmma_rs_n64_tb(acc, x[kk], desc_y + ((kk * 16 * 128 + cg * 64 * 128) >> 4));
  dfdt::wgmma_commit();
}

// A 64 x 64 accumulator times `mul`, rounded to bf16, into a free 64-row
// column block of shared memory at dst (128-byte swizzled, as TMA stores it).
__device__ __forceinline__ void stage_bf16(uint32_t dst, const float (&acc)[8][4], float mul,
                                           int warp, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + lane / 4 + 8 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dfdt::st_shared_b32(dst + r * 128 + ((j ^ (r & 7)) << 4) + 4 * (lane % 4),
                          dfdt::pack_bf16(acc[j][2 * i] * mul, acc[j][2 * i + 1] * mul));
  }
}

// A 64 x 64 accumulator as unscaled f32 rows of a split's partial (row
// stride d), rows < N, columns cg * 64 + c < d.
__device__ __forceinline__ void store_partial(float* dst, const float (&acc)[8][4], int row0,
                                              int cg, int N, int d, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + warp * 16 + lane / 4 + 8 * i;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = cg * 64 + j * 8 + 2 * (lane % 4);
      if (c < d)
        *reinterpret_cast<float2*>(dst + (long long)row * d + c) =
            make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

// The dQ pass. One block per (64-row query tile, column block cg of d, key
// split, b*h). Thread 0 loads Q, dO and O once and the split's K/V tiles
// through the ring; the warpgroup issues S = Q K^T and dP = dO V^T of the
// first tile, computes D = rowsum(dO * O) for its rows while they run
// (every split computes it, split 0 of column block 0 writes it), then per
// K/V tile forms P = exp(S scale - L) (0 on keys >= N) and dS = P (dP - D)
// and issues dQ += dS K (column block cg of K) beside the next tile's S and
// dP. dQ goes out times the scale in bf16 by a TMA store (!SPLIT) or as an
// unscaled f32 partial (SPLIT). part (B*H, S, N, d) f32.
template <int DP, bool SPLIT>
__device__ __forceinline__ void dq_block(const CUtensorMap& tq, const CUtensorMap& tk,
                                         const CUtensorMap& tv, const CUtensorMap& to,
                                         const CUtensorMap& tdo, const CUtensorMap& tdq,
                                         const float* lse, float* dvec, float* part, int H, int N,
                                         int d, int splits, float scale) {
  BWD_MARK(0, 0);
  using C = HopperBwd<DP>;
  constexpr int CB = C::CB, ST = C::STAGES;
  constexpr uint32_t TILE = C::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = dfdt::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);  // the same address, generic
  const uint32_t sQ = base, sdO = base + TILE, sO = base + 2 * TILE;
  const uint32_t ring = base + C::DQ_RING;  // stage st: K at ring + 2 st TILE, V a TILE on
  float* sD = reinterpret_cast<float*>(gbase + C::DQ_D);
  const uint32_t qd_full = base + C::DQ_BAR, o_full = qd_full + 8;
  auto full = [&](int st) { return qd_full + 16 + 8 * st; };
  auto empty = [&](int st) { return qd_full + 16 + 8 * (ST + st); };

  const BwdWork w = bwd_work<CB, SPLIT>(N, H, splits);
  const int n = w.t1 - w.t0;  // K/V tiles of this block
  const bool leader = threadIdx.x == 0;  // sets up the barriers, issues every TMA load

  // by the leader: K/V tile i of this block into its stage, which is free
  auto load_kv = [&](int i) {
    const int st = i % ST;
    dfdt::mbar_expect_tx(full(st), 2 * TILE);
    load_tile<CB>(ring + 2 * st * TILE, &tk, full(st), (w.t0 + i) * 64, w.h, w.b);
    load_tile<CB>(ring + (2 * st + 1) * TILE, &tv, full(st), (w.t0 + i) * 64, w.h, w.b);
  };

  if (leader) {
    dfdt::tma_prefetch(&tq);
    dfdt::tma_prefetch(&tk);
    dfdt::tma_prefetch(&tv);
    dfdt::tma_prefetch(&tdo);
    dfdt::tma_prefetch(&to);
    dfdt::mbar_init(qd_full, 1);
    dfdt::mbar_init(o_full, 1);
#pragma unroll
    for (int st = 0; st < ST; ++st) {
      dfdt::mbar_init(full(st), 1);
      dfdt::mbar_init(empty(st), C::THREADS);
    }
    dfdt::mbar_fence_init();
    dfdt::mbar_expect_tx(qd_full, 2 * TILE);
    load_tile<CB>(sQ, &tq, qd_full, w.row0, w.h, w.b);
    load_tile<CB>(sdO, &tdo, qd_full, w.row0, w.h, w.b);
    load_kv(0);
    dfdt::mbar_expect_tx(o_full, TILE);
    load_tile<CB>(sO, &to, o_full, w.row0, w.h, w.b);
    for (int i = 1; i < ST && i < n; ++i) load_kv(i);
  }
  __syncthreads();

  // warp w owns rows 16w..16w+15, lane l rows l / 4 and l / 4 + 8 of them
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq4 = lane % 4;
  const float sl2 = scale * kLog2e;
  float lrow[2];  // lse of rows g, g + 8 in log2 units (0 past N)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = w.row0 + warp * 16 + g + 8 * i;
    lrow[i] = row < N ? lse[(long long)w.bh * N + row] * kLog2e : 0.f;
  }
  float acc[8][4] = {};  // dQ, column block cg
  float s[8][4], dp[8][4];
  uint32_t ds[4][4];  // dS in bf16, the A operand of dQ += dS K

  dfdt::mbar_wait(qd_full, 0);
  dfdt::mbar_wait(full(0), 0);
  BWD_MARK(0, 1);
  issue_abt<DP>(s, sQ, ring);          // S = Q K^T
  issue_abt<DP>(dp, sdO, ring + TILE);  // dP = dO V^T

  // D = rowsum(dO * O) while they run: two threads a row, each 16-byte reads
  // of the same swizzled positions of both tiles
  dfdt::mbar_wait(o_full, 0);
  {
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    float sum = 0.f;
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t off = cb * 64 * 128 + r * 128 + (half * 4 + c) * 16;
        const uint4 ov = *reinterpret_cast<const uint4*>(gbase + 2 * TILE + off);
        const uint4 dv = *reinterpret_cast<const uint4*>(gbase + TILE + off);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(o2[e]);
          const float2 y = __bfloat1622float2(d2[e]);
          sum = fmaf(x.x, y.x, sum);
          sum = fmaf(x.y, y.y, sum);
        }
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      sD[r] = sum;
      if (w.s == 0 && w.cg == 0 && w.row0 + r < N) dvec[(long long)w.bh * N + w.row0 + r] = sum;
    }
  }
  __syncthreads();
  const float drow[2] = {sD[warp * 16 + g], sD[warp * 16 + g + 8]};

  // P = exp(S scale - L), 0 on keys >= N, over the accumulator of a done S
  auto scores_to_p = [&](int live) {  // live: keys of the tile below N
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * tq4 + (e & 1);
        s[j][e] = col < live ? exp2_ftz(fmaf(s[j][e], sl2, -lrow[e >> 1])) : 0.f;
      }
  };
  // dS = P (dP - D) into s, once dP is done
  auto p_to_ds = [&]() {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= dp[j][e] - drow[e >> 1];
  };

  // Each iteration issues and retires all its products (a group that is
  // still in flight at the loop's back edge makes ptxas serialize them):
  // S and dP of tile i, then dQ += dS K of tile i - 1 with its dS from
  // registers; P of tile i while dP and that product run, dS while the
  // product runs.
  dfdt::wgmma_wait<1>();
  dfdt::fence_regs(s);
  scores_to_p(N - w.t0 * 64);
  dfdt::wgmma_wait<0>();
  dfdt::fence_regs(dp);
  p_to_ds();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) dfdt::c_to_a<8>(ds[kk], s, kk);  // rounded once to bf16
  BWD_MARK(0, 2);
  for (int i = 1; i < n; ++i) {
    const int st = i % ST, pst = (i - 1) % ST;
    dfdt::mbar_wait(full(st), (i / ST) & 1);
    issue_abt<DP>(s, sQ, ring + 2 * st * TILE);
    issue_abt<DP>(dp, sdO, ring + (2 * st + 1) * TILE);
    issue_xy(acc, ds, ring + 2 * pst * TILE, w.cg);  // dQ += dS K of tile i - 1
    dfdt::wgmma_wait<2>();
    dfdt::fence_regs(s);
    scores_to_p(N - (w.t0 + i) * 64);
    dfdt::wgmma_wait<1>();
    dfdt::fence_regs(dp);
    p_to_ds();
    dfdt::wgmma_wait<0>();
    dfdt::fence_regs(acc);
    dfdt::fence_regs(ds);
    dfdt::mbar_arrive(empty(pst));
    // the leader refills the stage of tile i - 1 once every warp is done with it
    if (leader && i - 1 + ST < n) {
      dfdt::mbar_wait(empty(pst), ((i - 1) / ST) & 1);
      load_kv(i - 1 + ST);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) dfdt::c_to_a<8>(ds[kk], s, kk);
  }
  issue_xy(acc, ds, ring + 2 * ((n - 1) % ST) * TILE, w.cg);  // the last tile's dQ += dS K
  dfdt::wgmma_wait<0>();
  dfdt::fence_regs(acc);
  BWD_MARK(0, 3);

  if constexpr (SPLIT) {
    store_partial(part + ((long long)w.bh * splits + w.s) * N * d, acc, w.row0, w.cg, N, d, warp,
                  lane);
  } else {
    // dQ through the Q tile's first column block (free once every warp is
    // past its last S), one TMA store: rows past N and columns past d stay
    // unwritten
    __syncthreads();
    stage_bf16(sQ, acc, scale, warp, lane);
    dfdt::fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      dfdt::tma_store_4d(&tdq, sQ, w.cg * 64, w.row0, w.h, w.b);
      dfdt::tma_store_commit();
      dfdt::tma_store_wait_read();
    }
  }
  BWD_MARK(0, 4);
}

// The dK/dV pass. One block per (64-key tile, column block cg of d, query
// split, b*h). Thread 0 loads K and V once and the split's Q/dO tiles
// through the ring by TMA; every thread loads one of each tile's lse or D
// rows by cp.async (0 past N). Per tile the warpgroup issues S^T = K Q^T
// and dP^T = V dO^T beside the last tile's dV += P^T dO and dK += dS^T Q,
// forms P^T = exp(S^T scale - L) (0 on query rows >= N) and dS^T = P^T (dP^T
// - D) while they run, and rounds both to bf16 as the next products' A
// operands. Q and dO are each read through two descriptors of one TMA tile:
// K-major for S^T and dP^T, MN-major for dK and dV. dK (times the scale) and
// dV go out in bf16 by TMA stores (!SPLIT) or as unscaled f32 partials at
// part + plane and part + 2 plane (SPLIT).
template <int DP, bool SPLIT>
__device__ __forceinline__ void dkv_block(const CUtensorMap& tq, const CUtensorMap& tk,
                                          const CUtensorMap& tv, const CUtensorMap& tdo,
                                          const CUtensorMap& tdk, const CUtensorMap& tdv,
                                          const float* lse, const float* dvec, float* part,
                                          long long plane, int H, int N, int d, int splits,
                                          float scale) {
  BWD_MARK(1, 0);
  using C = HopperBwd<DP>;
  constexpr int CB = C::CB, ST = C::STAGES;
  constexpr uint32_t TILE = C::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = dfdt::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sK = base, sV = base + TILE;
  const uint32_t ring = base + C::DKV_RING;  // stage st: Q at ring + 2 st TILE, dO a TILE on
  float* sLD = reinterpret_cast<float*>(gbase + C::DKV_LD);  // stage st: lse, then D, 64 each
  const uint32_t kv_full = base + C::DKV_BAR;
  auto full = [&](int st) { return kv_full + 8 + 8 * st; };
  auto empty = [&](int st) { return kv_full + 8 + 8 * (ST + st); };

  const BwdWork w = bwd_work<CB, SPLIT>(N, H, splits);
  const int n = w.t1 - w.t0;  // Q/dO tiles of this block
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool leader = threadIdx.x == 0;  // sets up the barriers, issues every TMA load

  // by the leader: Q/dO tile i into its stage, which is free
  auto load_q = [&](int i) {
    const int st = i % ST;
    dfdt::mbar_expect_tx(full(st), 2 * TILE);
    load_tile<CB>(ring + 2 * st * TILE, &tq, full(st), (w.t0 + i) * 64, w.h, w.b);
    load_tile<CB>(ring + (2 * st + 1) * TILE, &tdo, full(st), (w.t0 + i) * 64, w.h, w.b);
  };
  // by every thread: one lse (threads 0-63) or D (64-127) of tile i's rows
  // into its stage by cp.async, 0 past N, tracked by the stage's full barrier
  auto load_ld = [&](int i) {
    const int st = i % ST, row = (w.t0 + i) * 64 + threadIdx.x % 64;
    const bool ok = row < N;
    const float* src = threadIdx.x < 64 ? lse : dvec;
    dfdt::cp_async4(sLD + st * 128 + threadIdx.x, src + (ok ? (long long)w.bh * N + row : 0),
                    ok);
    dfdt::mbar_arrive_cp_async(full(st));
  };

  if (leader) {
    dfdt::tma_prefetch(&tq);
    dfdt::tma_prefetch(&tk);
    dfdt::tma_prefetch(&tv);
    dfdt::tma_prefetch(&tdo);
    dfdt::mbar_init(kv_full, 1);
#pragma unroll
    for (int st = 0; st < ST; ++st) {
      dfdt::mbar_init(full(st), 1 + C::THREADS);  // the transactions' arrival and the rows'
      dfdt::mbar_init(empty(st), C::THREADS);
    }
    dfdt::mbar_fence_init();
    dfdt::mbar_expect_tx(kv_full, 2 * TILE);
    load_tile<CB>(sK, &tk, kv_full, w.row0, w.h, w.b);
    load_tile<CB>(sV, &tv, kv_full, w.row0, w.h, w.b);
    for (int i = 0; i < ST && i < n; ++i) load_q(i);
  }
  __syncthreads();
  for (int i = 0; i < ST && i < n; ++i) load_ld(i);

  // warp w owns key rows 16w..16w+15
  const int tq4 = lane % 4;
  const float sl2 = scale * kLog2e;
  float acc_dk[8][4] = {}, acc_dv[8][4] = {};  // column block cg
  float s[8][4], dp[8][4];
  uint32_t pt[4][4], ds[4][4];  // P^T and dS^T in bf16, A operands

  dfdt::mbar_wait(kv_full, 0);
  dfdt::mbar_wait(full(0), 0);
  BWD_MARK(1, 1);
  issue_abt<DP>(s, sK, ring);          // S^T = K Q^T
  issue_abt<DP>(dp, sV, ring + TILE);  // dP^T = V dO^T

  // P^T = exp(S^T scale - L), 0 on query rows >= N, over the accumulator of
  // a done S^T; L of the tile in stage st
  auto scores_to_p = [&](int st, int live) {  // live: query rows of the tile below N
    const float* tL = sLD + st * 128;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(tL + j * 8 + 2 * tq4);
      const float nl[2] = {-l2.x * kLog2e, -l2.y * kLog2e};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * tq4 + (e & 1);
        s[j][e] = col < live ? exp2_ftz(fmaf(s[j][e], sl2, nl[e & 1])) : 0.f;
      }
    }
  };
  // dS^T = P^T (dP^T - D) into dp, once dP^T is done
  auto p_to_ds = [&](int st) {
    const float* tD = sLD + st * 128 + 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(tD + j * 8 + 2 * tq4);
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - ((e & 1) ? d2.y : d2.x));
    }
  };
  // P^T and dS^T rounded once to bf16, the A operands of dV and dK
  auto to_operands = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      dfdt::c_to_a<8>(pt[kk], s, kk);
      dfdt::c_to_a<8>(ds[kk], dp, kk);
    }
  };

  // Each iteration issues and retires all its products (as in the dQ
  // pass): S^T and dP^T of tile i, then dV += P^T dO and dK += dS^T Q of
  // tile i - 1; P^T of tile i while dP^T and those run, dS^T while they run.
  dfdt::wgmma_wait<1>();
  dfdt::fence_regs(s);
  scores_to_p(0, N - w.t0 * 64);
  dfdt::wgmma_wait<0>();
  dfdt::fence_regs(dp);
  p_to_ds(0);
  to_operands();
  BWD_MARK(1, 2);
  for (int i = 1; i < n; ++i) {
    const int st = i % ST, pst = (i - 1) % ST;
    dfdt::mbar_wait(full(st), (i / ST) & 1);
    issue_abt<DP>(s, sK, ring + 2 * st * TILE);
    issue_abt<DP>(dp, sV, ring + (2 * st + 1) * TILE);
    issue_xy(acc_dv, pt, ring + (2 * pst + 1) * TILE, w.cg);  // dV += P^T dO, tile i - 1
    issue_xy(acc_dk, ds, ring + 2 * pst * TILE, w.cg);        // dK += dS^T Q, tile i - 1
    dfdt::wgmma_wait<3>();
    dfdt::fence_regs(s);
    scores_to_p(st, N - (w.t0 + i) * 64);
    dfdt::wgmma_wait<2>();
    dfdt::fence_regs(dp);
    p_to_ds(st);
    dfdt::wgmma_wait<0>();
    dfdt::fence_regs(acc_dv);
    dfdt::fence_regs(acc_dk);
    dfdt::fence_regs(pt);
    dfdt::fence_regs(ds);
    dfdt::mbar_arrive(empty(pst));
    // the stage of tile i - 1 refilled: Q/dO by the leader once every warp
    // is done with them, lse and D by every thread (each read them in
    // iteration i - 1, which every warp left before this iteration's products)
    if (i - 1 + ST < n) {
      if (leader) {
        dfdt::mbar_wait(empty(pst), ((i - 1) / ST) & 1);
        load_q(i - 1 + ST);
      }
      load_ld(i - 1 + ST);
    }
    to_operands();
  }
  // the last tile's products
  const int last = (n - 1) % ST;
  issue_xy(acc_dv, pt, ring + (2 * last + 1) * TILE, w.cg);
  issue_xy(acc_dk, ds, ring + 2 * last * TILE, w.cg);
  dfdt::wgmma_wait<0>();
  dfdt::fence_regs(acc_dk);
  dfdt::fence_regs(acc_dv);
  BWD_MARK(1, 3);

  if constexpr (SPLIT) {
    float* dst = part + plane + ((long long)w.bh * splits + w.s) * N * d;
    store_partial(dst, acc_dk, w.row0, w.cg, N, d, warp, lane);
    store_partial(dst + plane, acc_dv, w.row0, w.cg, N, d, warp, lane);
  } else {
    // dK and dV through the K and V tiles' first column blocks (free once
    // every warp is past its last S^T and dP^T), a TMA store each
    __syncthreads();
    stage_bf16(sK, acc_dk, scale, warp, lane);
    stage_bf16(sV, acc_dv, 1.f, warp, lane);
    dfdt::fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      dfdt::tma_store_4d(&tdk, sK, w.cg * 64, w.row0, w.h, w.b);
      dfdt::tma_store_4d(&tdv, sV, w.cg * 64, w.row0, w.h, w.b);
      dfdt::tma_store_commit();
      dfdt::tma_store_wait_read();
    }
  }
  BWD_MARK(1, 4);
}

// N <= 512, or a grid that fills the card unsplit: one block per (64-row
// tile, column block, b*h) walks every streamed tile.
template <int DP>
__global__ void __launch_bounds__(HopperBwd<DP>::THREADS)
flash_bwd_dq_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap to,
                               const __grid_constant__ CUtensorMap tdo,
                               const __grid_constant__ CUtensorMap tdq,
                               const float* __restrict__ lse, float* __restrict__ dvec, int H,
                               int N, int d, float scale) {
  dq_block<DP, false>(tq, tk, tv, to, tdo, tdq, lse, dvec, nullptr, H, N, d, 1, scale);
}

template <int DP>
__global__ void __launch_bounds__(HopperBwd<DP>::THREADS)
flash_bwd_dkv_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const __grid_constant__ CUtensorMap tdk,
                                const __grid_constant__ CUtensorMap tdv,
                                const float* __restrict__ lse, const float* __restrict__ dvec,
                                int H, int N, int d, float scale) {
  dkv_block<DP, false>(tq, tk, tv, tdo, tdk, tdv, lse, dvec, nullptr, 0, H, N, d, 1, scale);
}

// The split route: one block per (64-row tile, column block, split, b*h).
template <int DP>
__global__ void __launch_bounds__(HopperBwd<DP>::THREADS)
flash_bwd_dq_split_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                     const __grid_constant__ CUtensorMap tk,
                                     const __grid_constant__ CUtensorMap tv,
                                     const __grid_constant__ CUtensorMap to,
                                     const __grid_constant__ CUtensorMap tdo,
                                     const float* __restrict__ lse, float* __restrict__ dvec,
                                     float* __restrict__ part, int H, int N, int d, int splits,
                                     float scale) {
  dq_block<DP, true>(tq, tk, tv, to, tdo, tq, lse, dvec, part, H, N, d, splits, scale);
}

template <int DP>
__global__ void __launch_bounds__(HopperBwd<DP>::THREADS)
flash_bwd_dkv_split_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                      const __grid_constant__ CUtensorMap tk,
                                      const __grid_constant__ CUtensorMap tv,
                                      const __grid_constant__ CUtensorMap tdo,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ dvec, float* __restrict__ part,
                                      long long plane, int H, int N, int d, int splits,
                                      float scale) {
  dkv_block<DP, true>(tq, tk, tv, tdo, tq, tq, lse, dvec, part, plane, H, N, d, splits, scale);
}

// Arguments of the bf16 launch and of the reduce kernel. The unsplit passes
// write dq, dk and dv by TMA; the split passes write f32 partials, which the
// reduce kernel sums: part + 0, + plane, + 2 plane hold dQ, dK and dV, each
// (B*H, S, N, d) and unscaled, and the reduce writes through the strides.
struct BwdArgs {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  const float* lse;
  float* dvec;
  __nv_bfloat16 *dq, *dk, *dv;
  float* part;
  long long plane;
  Strides sdq, sdk, sdv;
  int H, N, d, splits;
  float scale;
};

constexpr int kReduceThreads = 256;

// dQ, dK and dV from their S partials: the sum over s in order, times the
// scale (dQ, dK) or 1 (dV), rounded once to bf16 and written through the
// caller's strides. One thread per (output, row, 8 columns); rows = B*H*N.
__global__ void __launch_bounds__(kReduceThreads)
flash_bwd_reduce_kernel(BwdArgs a, long long rows) {
  const int cpr = a.d / 8;
  const long long per = rows * cpr;  // items of one output
  const long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= 3 * per) return;
  const int which = (int)(i / per);  // 0: dQ, 1: dK, 2: dV
  const long long j = i % per;
  const int c = (int)(j % cpr) * 8;
  const long long row = j / cpr;
  const int n = (int)(row % a.N);
  const long long bh = row / a.N;
  const float* src = a.part + which * a.plane + (bh * a.splits * a.N + n) * a.d + c;
  const long long step = (long long)a.N * a.d;  // from split s to s + 1
  float acc[8] = {};
#pragma unroll 4  // the loads of several splits in flight at once
  for (int s = 0; s < a.splits; ++s) {
    const float4* p = reinterpret_cast<const float4*>(src + s * step);
    const float4 x = p[0], y = p[1];
    acc[0] += x.x;
    acc[1] += x.y;
    acc[2] += x.z;
    acc[3] += x.w;
    acc[4] += y.x;
    acc[5] += y.y;
    acc[6] += y.z;
    acc[7] += y.w;
  }
  const float mul = which < 2 ? a.scale : 1.f;
  __nv_bfloat16* base = which == 0 ? a.dq : which == 1 ? a.dk : a.dv;
  const Strides st = which == 0 ? a.sdq : which == 1 ? a.sdk : a.sdv;
  __nv_bfloat16* dst = base + (bh / a.H) * st.b + (bh % a.H) * st.h + n * st.n + c;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    reinterpret_cast<__nv_bfloat162*>(dst)[k] =
        __floats2bfloat162_rn(acc[2 * k] * mul, acc[2 * k + 1] * mul);
}

// geo: 9 values per operand (q, k, v, o, dout, dq, dk, dv), as encode_map
// reads them; every box 64 rows (the block's own tiles and the streamed ones)
template <int DP>
int launch_bf16(const BwdArgs& a, const long long* geo, int B, cudaStream_t stream) {
  using C = HopperBwd<DP>;
  const int n_tiles = (a.N + C::ROWS - 1) / C::ROWS;
  if (a.splits > n_tiles) return (int)cudaErrorInvalidValue;  // no split without rows
  const bool split = a.splits > 1;
  const void* ptrs[8] = {a.q, a.k, a.v, a.o, a.dout, a.dq, a.dk, a.dv};
  const int box_rows[8] = {C::ROWS, C::ROWS, C::ROWS, C::ROWS, C::ROWS, C::ROWS, C::ROWS, C::ROWS};
  CUtensorMap m[8];  // q, k, v, o, dout, and (unsplit) dq, dk, dv
  dfdt::LaunchCache& cache = dfdt::launch_cache();
  int err = cache.maps(m, ptrs, geo, box_rows, split ? 5 : 8, a.d, a.N, a.H, B, false);
  if (!err)
    err = cache.smem_attribute(split ? (const void*)flash_bwd_dq_split_bf16_wgmma_kernel<DP>
                                     : (const void*)flash_bwd_dq_bf16_wgmma_kernel<DP>,
                               (int)C::dq_smem);
  if (!err)
    err = cache.smem_attribute(split ? (const void*)flash_bwd_dkv_split_bf16_wgmma_kernel<DP>
                                     : (const void*)flash_bwd_dkv_bf16_wgmma_kernel<DP>,
                               (int)C::dkv_smem);
  if (err) return err;
  const long long blocks = (long long)B * a.H * n_tiles * C::CB * a.splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)blocks;
  if (split)
    flash_bwd_dq_split_bf16_wgmma_kernel<DP><<<grid, C::THREADS, C::dq_smem, stream>>>(
        m[0], m[1], m[2], m[3], m[4], a.lse, a.dvec, a.part, a.H, a.N, a.d, a.splits, a.scale);
  else
    flash_bwd_dq_bf16_wgmma_kernel<DP><<<grid, C::THREADS, C::dq_smem, stream>>>(
        m[0], m[1], m[2], m[3], m[4], m[5], a.lse, a.dvec, a.H, a.N, a.d, a.scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (split)
    flash_bwd_dkv_split_bf16_wgmma_kernel<DP><<<grid, C::THREADS, C::dkv_smem, stream>>>(
        m[0], m[1], m[2], m[4], a.lse, a.dvec, a.part, a.plane, a.H, a.N, a.d, a.splits,
        a.scale);
  else
    flash_bwd_dkv_bf16_wgmma_kernel<DP><<<grid, C::THREADS, C::dkv_smem, stream>>>(
        m[0], m[1], m[2], m[4], m[6], m[7], a.lse, a.dvec, a.H, a.N, a.d, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || !split) return (int)e;
  const long long rows = (long long)B * a.H * a.N;
  const long long items = 3 * rows * (a.d / 8);
  flash_bwd_reduce_kernel<<<(unsigned)((items + kReduceThreads - 1) / kReduceThreads),
                            kReduceThreads, 0, stream>>>(a, rows);
  return (int)cudaGetLastError();
}

// ---- f32: 3xTF32 on Hopper (TMA, mbarriers, tf32 wgmma) ----

// The f32 passes' geometry at padded head dim DP (32, 64, 128 or 256): one
// warpgroup owns 64 rows (query rows in the dQ pass, key rows in the dK/dV
// pass) and streams BN-row tiles of the other side; a block writes OC
// columns of its outputs (CB blocks a row tile, each recomputing S and dP
// over the whole d, as the bf16 passes do above d = 64).
template <int DP> struct TfHopper {
  static constexpr int THREADS = 128;
  static constexpr int ROWS = 64;
  static constexpr int BN = DP <= 128 ? 32 : 16;  // rows of a streamed tile (a TMA box)
  static constexpr int OC = DP < 64 ? DP : 64;    // output columns of a block
  static constexpr int CB = DP / OC;
  static constexpr int KC = 2;  // k-steps of an own-side product a group
  // raw stages of the streamed ring: the dQ pass keeps a load in flight, the
  // dK/dV pass has the room for one at d = 64 (two blocks an SM)
  static constexpr int DQ_ST = DP <= 128 ? 2 : 1;
  static constexpr int DKV_ST = 1;
  static constexpr uint32_t OWN = ROWS * DP * 4;  // a 64-row f32 tile, 1024-byte aligned
  static constexpr uint32_t STR = BN * DP * 4;    // a streamed tile
  static constexpr uint32_t TT = OC * 128;        // a transposed tile: OC rows of 128 bytes
  // the dQ pass loads O by TMA into its small-term tiles (free until the
  // first split) where they hold a 64-row tile, up to d = 128; above, D
  // reads O from global memory
  static constexpr bool O_TMA = 2 * BN >= ROWS;
  // dQ pass: Q, dO | the ring (K, V a stage) | K_s, V_s, K^T big, K^T small |
  // D of the block's rows | barriers: own full, full x ST, empty x ST
  static constexpr uint32_t DQ_RING = 2 * OWN;
  static constexpr uint32_t DQ_CONV = DQ_RING + DQ_ST * 2 * STR;
  static constexpr uint32_t DQ_D = DQ_CONV + 2 * STR + 2 * TT;
  static constexpr uint32_t DQ_BAR = DQ_D + ROWS * 4;
  static constexpr size_t dq_smem = DQ_BAR + (1 + 2 * DQ_ST) * 8 + 1024;  // + base alignment
  // dK/dV pass: K, V | the ring (Q, dO a stage) | Q_s, dO_s, Q^T and dO^T
  // big and small | lse and D rows of two tiles | barriers, as above
  static constexpr uint32_t DKV_RING = 2 * OWN;
  static constexpr uint32_t DKV_CONV = DKV_RING + DKV_ST * 2 * STR;
  static constexpr uint32_t DKV_LD = DKV_CONV + 2 * STR + 4 * TT;
  static constexpr uint32_t DKV_BAR = DKV_LD + 2 * 2 * BN * 4;
  static constexpr size_t dkv_smem = DKV_BAR + (1 + 2 * DKV_ST) * 8 + 1024;
};

// The byte offset of this thread's chunk `it` of a streamed tile in
// split_tile's order: 64 chunks (8 rows x 8) a block of rows, two warps a
// block, each warp rows 0-3 at even chunks and 4-7 at odd ones or the
// reverse, so each group of 8 lanes takes a 128-byte row.
template <int BN>
__device__ __forceinline__ uint32_t chunk_off(int it) {
  const int i = threadIdx.x + it * 128, lane = i & 31, blk = i >> 6, pc = lane & 7;
  const int r = (blk % (BN / 8)) * 8 + (lane >> 3) + 4 * ((pc & 1) ^ ((i >> 5) & 1));
  return (blk / (BN / 8)) * BN * 128 + r * 128 + pc * 16;
}

// v[0..3] = v[k..3], v[0..k-1] (k in 0..3), by selects: no local memory
__device__ __forceinline__ void rotate4(uint32_t (&v)[4], int k) {
  if (k & 1) {
    const uint32_t t = v[0];
    v[0] = v[1];
    v[1] = v[2];
    v[2] = v[3];
    v[3] = t;
  }
  if (k & 2) {
    uint32_t t = v[0];
    v[0] = v[2];
    v[2] = t;
    t = v[1];
    v[1] = v[3];
    v[3] = t;
  }
}

// A streamed tile (BN rows at raw, as TMA landed it) split for 3xTF32 by
// every thread of the block: big (x truncated to tf32) written back in place
// and small (x - big rounded to tf32) at sm, the same layout, both the K-major
// B operand of S = A X^T. With TRANS, columns [c0, c0 + OC) also go
// transposed to tb (big) and ts (small): row n holds column c0 + n, its BN
// rows along the 128-byte row in the relabelled k order of an accumulator A
// operand (row 8j + 2t at k-step j's position t, 8j + 2t + 1 at t + 4), the
// K-major B operand of acc += P X. Every access is free of bank conflicts:
// a warp takes 8 rows of a 32-column block (chunk_off), each group of 8
// lanes the 8 16-byte chunks of a 128-byte row (the 16-byte loads and
// stores), and each lane writes its 4 transposed values starting at the
// (chunk / 2)-th, so that the 32 lanes of each scalar store hit 32 banks.
template <int DP, int BN, int OC, bool TRANS>
__device__ __forceinline__ void split_tile(uint32_t raw, uint32_t sm, uint32_t tb, uint32_t ts,
                                           int c0) {
  constexpr int IT = DP / 4 * BN / 128;  // chunks a thread
  static_assert(DP / 4 * BN % 128 == 0, "a tile's chunks spread evenly over the block");
  // every chunk of the thread read before the first write (the accesses are
  // ordered asm, so a write would hold the next chunk's read behind it)
  float4 x[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) x[it] = dfdt::ld_shared_v4(raw + chunk_off<BN>(it));
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int i = threadIdx.x + it * 128, lane = i & 31, blk = i >> 6, pc = lane & 7;
    const int r = (blk % (BN / 8)) * 8 + (lane >> 3) + 4 * ((pc & 1) ^ ((i >> 5) & 1));
    const uint32_t off = chunk_off<BN>(it);
    uint32_t big[4], small[4];
    dfdt::split_tf32(x[it].x, big[0], small[0]);
    dfdt::split_tf32(x[it].y, big[1], small[1]);
    dfdt::split_tf32(x[it].z, big[2], small[2]);
    dfdt::split_tf32(x[it].w, big[3], small[3]);
    dfdt::st_shared_v4(raw + off, big[0], big[1], big[2], big[3]);
    dfdt::st_shared_v4(sm + off, small[0], small[1], small[2], small[3]);
    if constexpr (TRANS) {
      const int lc = pc ^ (r & 7);                               // the chunk's 4 columns
      const int col = (blk / (BN / 8)) * 32 + lc * 4 - c0;  // of x.x
      if (col >= 0 && col < OC) {
        const int kp = (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);  // r's relabelled position
        const int rot = (lc >> 1) & 3;                             // value e + rot first
        rotate4(big, rot);
        rotate4(small, rot);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int nr = col + ((e + rot) & 3);
          const uint32_t to = nr * 128 + (((kp >> 2) ^ (nr & 7)) << 4) + (kp & 3) * 4;
          dfdt::st_shared_b32(tb + to, big[e]);
          dfdt::st_shared_b32(ts + to, small[e]);
        }
      }
    }
  }
}

// s = A0 X0^T and t = A1 X1^T over the head dim, 64 x BN x DP, 3xTF32: A0,
// A1 64-row own tiles (raw f32, as TMA stores them) read into registers and
// split there, KC k-steps at a time; X0, X1 streamed tiles split by
// split_tile (big at x?b, small at x?s), read K-major. Each k-step issues
// small(A) big(X), big(A) small(X), then big(A) big(X); each KC k-steps are
// one group. The A registers are double-buffered: the next KC k-steps are
// read and split while a group runs, once the group before it (the last
// reader of that buffer) is retired.
template <int DP, int BN, int KC>
__device__ __forceinline__ void own_products(float (&s)[BN / 8][4], float (&t)[BN / 8][4],
                                             uint32_t a0, uint32_t a1, uint32_t x0b,
                                             uint32_t x0s, uint32_t x1b, uint32_t x1s, int warp,
                                             int lane) {
  constexpr int NC = DP / 8 / KC;  // groups
  const int r = warp * 16 + lane / 4, c = lane % 4;
  uint32_t ab[2][KC][4], as[2][KC][4], bb[2][KC][4], bs[2][KC][4];
  auto load = [&](int k0, uint32_t(&xb)[KC][4], uint32_t(&xs)[KC][4], uint32_t(&yb)[KC][4],
                  uint32_t(&ys)[KC][4]) {
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const int col = (k0 + kk) * 8 + c;
      const uint32_t o[4] = {dfdt::sw_f32(r, col, 64), dfdt::sw_f32(r + 8, col, 64),
                             dfdt::sw_f32(r, col + 4, 64), dfdt::sw_f32(r + 8, col + 4, 64)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dfdt::split_tf32(dfdt::ld_shared_f32(a0 + o[e]), xb[kk][e], xs[kk][e]);
        dfdt::split_tf32(dfdt::ld_shared_f32(a1 + o[e]), yb[kk][e], ys[kk][e]);
      }
    }
  };
  load(0, ab[0], as[0], bb[0], bs[0]);
#pragma unroll
  for (int g = 0; g < NC; ++g) {
    const int u = g & 1;
    dfdt::fence_regs(s);
    dfdt::fence_regs(t);
    dfdt::fence_regs(ab[u]);
    dfdt::fence_regs(as[u]);
    dfdt::fence_regs(bb[u]);
    dfdt::fence_regs(bs[u]);
    dfdt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const int kd = g * KC + kk;
      const uint32_t off = ((kd / 4) * BN * 128 + (kd % 4) * 32) >> 4;
      const uint64_t d0b = dfdt::desc_sw128(x0b, 16, 1024) + off;
      const uint64_t d0s = dfdt::desc_sw128(x0s, 16, 1024) + off;
      const uint64_t d1b = dfdt::desc_sw128(x1b, 16, 1024) + off;
      const uint64_t d1s = dfdt::desc_sw128(x1s, 16, 1024) + off;
      dfdt::wgmma_tf32<BN>(s, as[u][kk], d0b, kd > 0);
      dfdt::wgmma_tf32<BN>(s, ab[u][kk], d0s, 1);
      dfdt::wgmma_tf32<BN>(s, ab[u][kk], d0b, 1);
      dfdt::wgmma_tf32<BN>(t, bs[u][kk], d1b, kd > 0);
      dfdt::wgmma_tf32<BN>(t, bb[u][kk], d1s, 1);
      dfdt::wgmma_tf32<BN>(t, bb[u][kk], d1b, 1);
    }
    dfdt::wgmma_commit();
    if (g + 1 < NC) {
      dfdt::wgmma_wait<1>();  // group g - 1, the last reader of the other buffer, is done
      dfdt::fence_regs(ab[u ^ 1]);
      dfdt::fence_regs(as[u ^ 1]);
      dfdt::fence_regs(bb[u ^ 1]);
      dfdt::fence_regs(bs[u ^ 1]);
      load((g + 1) * KC, ab[u ^ 1], as[u ^ 1], bb[u ^ 1], bs[u ^ 1]);
    }
  }
  dfdt::wgmma_wait<0>();
  dfdt::fence_regs(s);
  dfdt::fence_regs(t);
  dfdt::fence_regs(ab);  // live until the products that read them are done
  dfdt::fence_regs(as);
  dfdt::fence_regs(bb);
  dfdt::fence_regs(bs);
}

// acc += X Y, 64 x OC x BN, 3xTF32, as one group (the caller retires it): X
// (P or dS) from its accumulator, split in registers into the A operands of
// its BN / 8 k-steps (columns relabelled), Y transposed by split_tile (big at
// yb, small at ys), read K-major. xb and xs hold the A operands: the caller
// fences them after the wait, as the product reads them until it is done.
template <int BN, int OC>
__device__ __forceinline__ void issue_xy_tf32(float (&acc)[OC / 8][4], const float (&x)[BN / 8][4],
                                              uint32_t (&xb)[BN / 8][4],
                                              uint32_t (&xs)[BN / 8][4], uint32_t yb,
                                              uint32_t ys) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    dfdt::split_tf32(x[j][0], xb[j][0], xs[j][0]);
    dfdt::split_tf32(x[j][2], xb[j][1], xs[j][1]);
    dfdt::split_tf32(x[j][1], xb[j][2], xs[j][2]);
    dfdt::split_tf32(x[j][3], xb[j][3], xs[j][3]);
  }
  dfdt::fence_regs(acc);
  dfdt::fence_regs(xb);
  dfdt::fence_regs(xs);
  dfdt::wgmma_fence();
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const uint64_t db = dfdt::desc_sw128(yb, 16, 1024) + ((j * 32) >> 4);
    const uint64_t ds = dfdt::desc_sw128(ys, 16, 1024) + ((j * 32) >> 4);
    dfdt::wgmma_tf32<OC>(acc, xs[j], db, 1);
    dfdt::wgmma_tf32<OC>(acc, xb[j], ds, 1);
    dfdt::wgmma_tf32<OC>(acc, xb[j], db, 1);
  }
  dfdt::wgmma_commit();
}

// A 64 x OC accumulator times mul into the 64-row f32 tile at dst (as TMA
// stores it), then by thread 0 to the tensor map's rows [row0, row0 + 64),
// columns [c0, c0 + OC): rows past N and columns past d stay unwritten.
template <int OC, int BN>
__device__ __forceinline__ void stage_f32(uint32_t dst, const float (&acc)[OC / 8][4], float mul,
                                          int warp, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + lane / 4 + 8 * i;
#pragma unroll
    for (int j = 0; j < OC / 8; ++j)
      dfdt::st_shared_v2(dst + dfdt::sw_f32(r, j * 8 + 2 * (lane % 4), 64), acc[j][2 * i] * mul,
                         acc[j][2 * i + 1] * mul);
  }
}

template <int OC, int BN>
__device__ __forceinline__ void store_f32(const CUtensorMap* map, uint32_t src, int c0, int row0,
                                          int h, int b) {
#pragma unroll
  for (int cb = 0; cb < OC / 32; ++cb)
#pragma unroll
    for (int rb = 0; rb < 64 / BN; ++rb)
      dfdt::tma_store_4d(map, src + cb * 64 * 128 + rb * BN * 128, c0 + cb * 32, row0 + rb * BN,
                         h, b);
}

// The dQ pass in f32. One block per (64-row query tile, output column block
// cg, b*h), row tile fastest. Thread 0 loads Q and dO once and the K/V tiles
// through the ring by TMA; every thread computes D = rowsum(dO * O) of its
// row from global memory while they land (column block 0 writes it). Per
// K/V tile the warpgroup splits K and V (K also transposed: columns of cg),
// takes S = Q K^T and dP = dO V^T, releases the stage, forms P = exp(S scale
// - L) (0 on keys >= N) and dS = P (dP - D) on the accumulators and takes
// dQ += dS K; dQ goes out times the scale by TMA stores.
template <int DP>
__global__ void __launch_bounds__(TfHopper<DP>::THREADS, 1)
flash_bwd_dq_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap to,
                               const __grid_constant__ CUtensorMap tdo,
                               const __grid_constant__ CUtensorMap tdq,
                               const float* __restrict__ o, const float* __restrict__ dout,
                               Strides so, Strides sdo, const float* __restrict__ lse,
                               float* __restrict__ dvec, int H, int N, int d, float scale) {
  BWD_MARK(0, 0);
  using C = TfHopper<DP>;
  constexpr int BN = C::BN, OC = C::OC, ST = C::DQ_ST;
  constexpr uint32_t OWN = C::OWN, STR = C::STR, TT = C::TT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = dfdt::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);  // the same address, generic
  float* sD = reinterpret_cast<float*>(gbase + C::DQ_D);
  const uint32_t sQ = base, sdO = base + OWN;
  const uint32_t ring = base + C::DQ_RING;  // stage st: K at ring + 2 st STR, V a tile on
  const uint32_t sKs = base + C::DQ_CONV, sVs = sKs + STR, sKtb = sVs + STR, sKts = sKtb + TT;
  const uint32_t own_full = base + C::DQ_BAR;
  auto full = [&](int st) { return own_full + 8 + 8 * st; };
  auto empty = [&](int st) { return own_full + 8 + 8 * (ST + st); };

  const BwdWork w = bwd_work<C::CB, false>(N, H, 1);
  const int n = (N + BN - 1) / BN;  // K/V tiles
  const bool leader = threadIdx.x == 0;
  auto load_kv = [&](int i) {
    const int st = i % ST;
    dfdt::mbar_expect_tx(full(st), 2 * STR);
    dfdt::load_f32<DP, BN, BN>(ring + 2 * st * STR, &tk, full(st), i * BN, w.h, w.b);
    dfdt::load_f32<DP, BN, BN>(ring + (2 * st + 1) * STR, &tv, full(st), i * BN, w.h, w.b);
  };
  if (leader) {
    dfdt::tma_prefetch(&tq);
    dfdt::tma_prefetch(&tk);
    dfdt::tma_prefetch(&tv);
    dfdt::tma_prefetch(&tdo);
    if (C::O_TMA) dfdt::tma_prefetch(&to);
    dfdt::mbar_init(own_full, 1);
#pragma unroll
    for (int st = 0; st < ST; ++st) {
      dfdt::mbar_init(full(st), 1);
      dfdt::mbar_init(empty(st), C::THREADS);
    }
    dfdt::mbar_fence_init();
    dfdt::mbar_expect_tx(own_full, (C::O_TMA ? 3 : 2) * OWN);
    dfdt::load_f32<DP, 64, BN>(sQ, &tq, own_full, w.row0, w.h, w.b);
    dfdt::load_f32<DP, 64, BN>(sdO, &tdo, own_full, w.row0, w.h, w.b);
    if (C::O_TMA) dfdt::load_f32<DP, 64, BN>(sKs, &to, own_full, w.row0, w.h, w.b);
    for (int i = 0; i < ST && i < n; ++i) load_kv(i);
  }
  __syncthreads();

  // D = rowsum(dO * O): two threads a row, 16-byte reads of the same
  // positions of both tiles once they land (O in the small-term tiles), or
  // of both rows from global memory
  if constexpr (C::O_TMA) {
    dfdt::mbar_wait(own_full, 0);
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    float sum = 0.f;
#pragma unroll
    for (int cb = 0; cb < DP / 32; ++cb)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t off = cb * 64 * 128 + r * 128 + (((half * 4 + c) ^ (r & 7)) << 4);
        const float4 x = *reinterpret_cast<const float4*>(gbase + (sKs - base) + off);
        const float4 y = *reinterpret_cast<const float4*>(gbase + OWN + off);
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
        sum = fmaf(x.z, y.z, sum);
        sum = fmaf(x.w, y.w, sum);
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      sD[r] = sum;
      if (w.cg == 0 && w.row0 + r < N) dvec[(long long)w.bh * N + w.row0 + r] = sum;
    }
  } else {
    const int r = threadIdx.x / 2, gr = w.row0 + r;
    float sum = 0.f;
    if (gr < N) {
      const float* orow = o + w.b * so.b + w.h * so.h + gr * so.n;
      const float* drow = dout + w.b * sdo.b + w.h * sdo.h + gr * sdo.n;
      // every load issued before the first sum (a loop bounded by d alone
      // waited for each pair in turn)
      float4 x[DP / 8], y[DP / 8];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int c = j * 8 + (threadIdx.x % 2) * 4;
        const float4 zero = {0.f, 0.f, 0.f, 0.f};
        x[j] = c < d ? *reinterpret_cast<const float4*>(orow + c) : zero;
        y[j] = c < d ? *reinterpret_cast<const float4*>(drow + c) : zero;
      }
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        sum = fmaf(x[j].x, y[j].x, sum);
        sum = fmaf(x[j].y, y[j].y, sum);
        sum = fmaf(x[j].z, y[j].z, sum);
        sum = fmaf(x[j].w, y[j].w, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (threadIdx.x % 2 == 0) {
      sD[r] = sum;
      if (w.cg == 0 && gr < N) dvec[(long long)w.bh * N + gr] = sum;
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq4 = lane % 4;
  const float sl2 = scale * kLog2e;
  float lrow[2];  // lse of rows g, g + 8 in log2 units (0 past N)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = w.row0 + warp * 16 + lane / 4 + 8 * i;
    lrow[i] = row < N ? lse[(long long)w.bh * N + row] * kLog2e : 0.f;
  }
  __syncthreads();  // D is in sD, and O's tile is free for the first split
  const float drow[2] = {sD[warp * 16 + lane / 4], sD[warp * 16 + lane / 4 + 8]};

  float acc[OC / 8][4] = {};  // dQ, column block cg
  float s[BN / 8][4], dp[BN / 8][4];
  uint32_t xb[BN / 8][4], xs[BN / 8][4];  // dS as tf32 A operands
  if (!C::O_TMA) dfdt::mbar_wait(own_full, 0);
  BWD_PHASES;
  for (int i = 0; i < n; ++i) {
    const int st = i % ST;
    const uint32_t tK = ring + 2 * st * STR, tV = tK + STR;
    dfdt::mbar_wait(full(st), (i / ST) & 1);
    if (i == 0) BWD_MARK(0, 1);
    dfdt::named_bar_sync(1, C::THREADS);  // every warp is past the last tile's dQ product
    split_tile<DP, BN, OC, true>(tK, sKs, sKtb, sKts, w.cg * OC);
    split_tile<DP, BN, OC, false>(tV, sVs, 0, 0, 0);
    dfdt::fence_proxy_async();
    dfdt::named_bar_sync(1, C::THREADS);
    BWD_PHASE(0);
    own_products<DP, BN, C::KC>(s, dp, sQ, sdO, tK, sKs, tV, sVs, warp, lane);
    BWD_PHASE(1);
    dfdt::mbar_arrive(empty(st));
    if (leader && i + ST < n) {
      dfdt::mbar_wait(empty(st), (i / ST) & 1);
      load_kv(i + ST);
    }
    const int live = N - i * BN;  // keys of the tile below N
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * tq4 + (e & 1);
        const float p = col < live ? exp2_ftz(fmaf(s[j][e], sl2, -lrow[e >> 1])) : 0.f;
        s[j][e] = p * (dp[j][e] - drow[e >> 1]);
      }
    BWD_PHASE(2);
    issue_xy_tf32<BN, OC>(acc, s, xb, xs, sKtb, sKts);  // dQ += dS K
    dfdt::wgmma_wait<0>();
    dfdt::fence_regs(acc);
    dfdt::fence_regs(xb);
    dfdt::fence_regs(xs);
    BWD_PHASE(3);
    if (i == 0) BWD_MARK(0, 2);
  }
  BWD_MARK(0, 3);
  BWD_PHASES_STORE(0);
  // dQ through the Q tile (free once every warp is past its last S)
  __syncthreads();
  stage_f32<OC, BN>(sQ, acc, scale, warp, lane);
  dfdt::fence_proxy_async();
  __syncthreads();
  if (leader) {
    store_f32<OC, BN>(&tdq, sQ, w.cg * OC, w.row0, w.h, w.b);
    dfdt::tma_store_commit();
    dfdt::tma_store_wait_read();
  }
  BWD_MARK(0, 4);
}

// The dK/dV pass in f32. One block per (64-key tile, output column block cg,
// b*h), row tile fastest. Thread 0 loads K and V once and the Q/dO tiles
// through the ring by TMA; every thread loads one of the next tile's lse or
// D rows by cp.async (0 past N), tracked by its stage's full barrier. Per
// Q/dO tile the warpgroup splits Q and dO (both also transposed: columns of
// cg), takes S^T = K Q^T and dP^T = V dO^T, releases the stage, forms P^T =
// exp(S^T scale - L) (0 on query rows >= N) and dS^T = P^T (dP^T - D), and
// takes dV += P^T dO and dK += dS^T Q; dK (times the scale) and dV go out by
// TMA stores.
template <int DP>
__global__ void __launch_bounds__(TfHopper<DP>::THREADS, 1)
flash_bwd_dkv_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const __grid_constant__ CUtensorMap tdk,
                                const __grid_constant__ CUtensorMap tdv,
                                const float* __restrict__ lse, const float* __restrict__ dvec,
                                int H, int N, float scale) {
  BWD_MARK(1, 0);
  using C = TfHopper<DP>;
  constexpr int BN = C::BN, OC = C::OC, ST = C::DKV_ST;
  constexpr uint32_t OWN = C::OWN, STR = C::STR, TT = C::TT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = dfdt::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* sLD = reinterpret_cast<float*>(smem_raw + (base - raw) + C::DKV_LD);  // tile parity p:
  // lse at sLD + 2 BN p, D BN on
  const uint32_t sK = base, sV = base + OWN;
  const uint32_t ring = base + C::DKV_RING;  // stage st: Q at ring + 2 st STR, dO a tile on
  const uint32_t sQs = base + C::DKV_CONV, sdOs = sQs + STR;
  const uint32_t sQtb = sdOs + STR, sQts = sQtb + TT, sdOtb = sQts + TT, sdOts = sdOtb + TT;
  const uint32_t own_full = base + C::DKV_BAR;
  auto full = [&](int st) { return own_full + 8 + 8 * st; };
  auto empty = [&](int st) { return own_full + 8 + 8 * (ST + st); };

  const BwdWork w = bwd_work<C::CB, false>(N, H, 1);
  const int n = (N + BN - 1) / BN;  // Q/dO tiles
  const bool leader = threadIdx.x == 0;
  auto load_q = [&](int i) {
    const int st = i % ST;
    dfdt::mbar_expect_tx(full(st), 2 * STR);
    dfdt::load_f32<DP, BN, BN>(ring + 2 * st * STR, &tq, full(st), i * BN, w.h, w.b);
    dfdt::load_f32<DP, BN, BN>(ring + (2 * st + 1) * STR, &tdo, full(st), i * BN, w.h, w.b);
  };
  // by every thread: one lse (threads 0 .. BN-1) or D (BN .. 2BN-1) row of
  // tile i into its parity's rows, 0 past N; every thread arrives on the
  // stage's full barrier once its copies land
  auto load_ld = [&](int i) {
    if (threadIdx.x < 2 * BN) {
      const int row = i * BN + threadIdx.x % BN;
      const bool ok = row < N;
      const float* src = threadIdx.x < BN ? lse : dvec;
      dfdt::cp_async4(sLD + (i & 1) * 2 * BN + threadIdx.x,
                      src + (ok ? (long long)w.bh * N + row : 0), ok);
    }
    dfdt::mbar_arrive_cp_async(full(i % ST));
  };
  if (leader) {
    dfdt::tma_prefetch(&tq);
    dfdt::tma_prefetch(&tk);
    dfdt::tma_prefetch(&tv);
    dfdt::tma_prefetch(&tdo);
    dfdt::mbar_init(own_full, 1);
#pragma unroll
    for (int st = 0; st < ST; ++st) {
      dfdt::mbar_init(full(st), 1 + C::THREADS);  // the transactions' arrival and the rows'
      dfdt::mbar_init(empty(st), C::THREADS);
    }
    dfdt::mbar_fence_init();
    dfdt::mbar_expect_tx(own_full, 2 * OWN);
    dfdt::load_f32<DP, 64, BN>(sK, &tk, own_full, w.row0, w.h, w.b);
    dfdt::load_f32<DP, 64, BN>(sV, &tv, own_full, w.row0, w.h, w.b);
    for (int i = 0; i < ST && i < n; ++i) load_q(i);
  }
  __syncthreads();
  load_ld(0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq4 = lane % 4;
  const float sl2 = scale * kLog2e;
  float acc_dk[OC / 8][4] = {}, acc_dv[OC / 8][4] = {};  // column block cg
  float s[BN / 8][4], dp[BN / 8][4];
  uint32_t pb[BN / 8][4], ps[BN / 8][4], xb[BN / 8][4], xs[BN / 8][4];  // P^T, dS^T
  dfdt::mbar_wait(own_full, 0);
  BWD_PHASES;
  for (int i = 0; i < n; ++i) {
    const int st = i % ST;
    const uint32_t tQ = ring + 2 * st * STR, tdO = tQ + STR;
    dfdt::mbar_wait(full(st), (i / ST) & 1);
    if (i == 0) BWD_MARK(1, 1);
    // every warp is past the last tile's products and its lse and D rows
    dfdt::named_bar_sync(1, C::THREADS);
    if (i + 1 < n) load_ld(i + 1);
    split_tile<DP, BN, OC, true>(tQ, sQs, sQtb, sQts, w.cg * OC);
    split_tile<DP, BN, OC, true>(tdO, sdOs, sdOtb, sdOts, w.cg * OC);
    dfdt::fence_proxy_async();
    dfdt::named_bar_sync(1, C::THREADS);
    BWD_PHASE(0);
    own_products<DP, BN, C::KC>(s, dp, sK, sV, tQ, sQs, tdO, sdOs, warp, lane);
    BWD_PHASE(1);
    dfdt::mbar_arrive(empty(st));
    if (leader && i + ST < n) {
      dfdt::mbar_wait(empty(st), (i / ST) & 1);
      load_q(i + ST);
    }
    const float* tL = sLD + (i & 1) * 2 * BN;
    const int live = N - i * BN;  // query rows of the tile below N
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(tL + j * 8 + 2 * tq4);
      const float2 d2 = *reinterpret_cast<const float2*>(tL + BN + j * 8 + 2 * tq4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * tq4 + (e & 1);
        const float p =
            col < live ? exp2_ftz(fmaf(s[j][e], sl2, -((e & 1) ? l2.y : l2.x) * kLog2e)) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - ((e & 1) ? d2.y : d2.x));
      }
    }
    BWD_PHASE(2);
    issue_xy_tf32<BN, OC>(acc_dv, s, pb, ps, sdOtb, sdOts);  // dV += P^T dO
    issue_xy_tf32<BN, OC>(acc_dk, dp, xb, xs, sQtb, sQts);   // dK += dS^T Q
    dfdt::wgmma_wait<0>();
    dfdt::fence_regs(acc_dv);
    dfdt::fence_regs(acc_dk);
    dfdt::fence_regs(pb);
    dfdt::fence_regs(ps);
    dfdt::fence_regs(xb);
    dfdt::fence_regs(xs);
    BWD_PHASE(3);
    if (i == 0) BWD_MARK(1, 2);
  }
  BWD_MARK(1, 3);
  BWD_PHASES_STORE(1);
  // dK and dV through the K and V tiles (free once every warp is past its
  // last S^T and dP^T)
  __syncthreads();
  stage_f32<OC, BN>(sK, acc_dk, scale, warp, lane);
  stage_f32<OC, BN>(sV, acc_dv, 1.f, warp, lane);
  dfdt::fence_proxy_async();
  __syncthreads();
  if (leader) {
    store_f32<OC, BN>(&tdk, sK, w.cg * OC, w.row0, w.h, w.b);
    store_f32<OC, BN>(&tdv, sV, w.cg * OC, w.row0, w.h, w.b);
    dfdt::tma_store_commit();
    dfdt::tma_store_wait_read();
  }
  BWD_MARK(1, 4);
}

// Arguments of the f32 launch: D's inputs by pointer and strides (read from
// global memory), everything else by tensor map.
struct TfArgs {
  const float *q, *k, *v, *o, *dout;
  const float* lse;
  float* dvec;
  float *dq, *dk, *dv;
  Strides so, sdo;
  int H, N, d;
  float scale;
};

// geo: 9 values per operand (q, k, v, o, dout, dq, dk, dv), as encode_map
// reads them; every f32 box BN rows of 32 columns
template <int DP>
int launch_tf32(const TfArgs& a, const long long* geo, int B, cudaStream_t stream) {
  using C = TfHopper<DP>;
  const void* ptrs[8] = {a.q, a.k, a.v, a.o, a.dout, a.dq, a.dk, a.dv};
  const int box_rows[8] = {C::BN, C::BN, C::BN, C::BN, C::BN, C::BN, C::BN, C::BN};
  CUtensorMap m[8];
  dfdt::LaunchCache& cache = dfdt::launch_cache();
  int err = cache.maps(m, ptrs, geo, box_rows, 8, a.d, a.N, a.H, B, true);
  if (!err)
    err = cache.smem_attribute((const void*)flash_bwd_dq_tf32_wgmma_kernel<DP>, (int)C::dq_smem);
  if (!err)
    err = cache.smem_attribute((const void*)flash_bwd_dkv_tf32_wgmma_kernel<DP>,
                               (int)C::dkv_smem);
  if (err) return err;
  const long long blocks = (long long)B * a.H * ((a.N + C::ROWS - 1) / C::ROWS) * C::CB;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bwd_dq_tf32_wgmma_kernel<DP><<<(unsigned)blocks, C::THREADS, C::dq_smem, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], a.o, a.dout, a.so, a.sdo, a.lse, a.dvec, a.H, a.N,
      a.d, a.scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkv_tf32_wgmma_kernel<DP><<<(unsigned)blocks, C::THREADS, C::dkv_smem, stream>>>(
      m[0], m[1], m[2], m[4], m[6], m[7], a.lse, a.dvec, a.H, a.N, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The two int64 blocks of a backward call (ops/attention.py packs them). The
// plan, built once per shape, strides, dtype, device and alignment of the
// inputs: the call's sizes (d the head dim the kernels see), the dtype, the
// scale's f32 bits, 24 element strides ((b, h, n) of q, k, v, o, dout, dq,
// dk, dv) and the tensor maps' geometries (9 values for each of the eight,
// as encode_map reads them). The call: the pointers (lse and dvec, scratch
// for D, contiguous f32 (B, H, N)), the stream and the split count S (1, or
// bf16's splits, with `scratch` an f32 buffer of 3*S*B*H*N*d elements for
// the partials).
enum BwdPlan { kPB, kPH, kPN, kPD, kPBf16, kPScale, kPStrides, kPGeo = kPStrides + 24 };
enum BwdCall {
  kCQ, kCK, kCV, kCO, kCDout, kCLse, kCDvec, kCDq, kCDk, kCDv, kCScratch, kCStream, kCSplits
};

// Both dtypes read q, k, v, dout and write dq, dk, dv through tensor maps:
// bf16 (d a multiple of 8) goes to the bf16 Hopper kernels, which read o by
// its map too (the reduce kernel of the split route writes dq, dk, dv
// through their strides); f32 (d a multiple of 4) to the 3xTF32 Hopper
// kernels, which read o and dout for D through their strides (16-byte rows).
extern "C" int dfdt_flash_bwd(const long long* call, const long long* plan) {
  const int B = (int)plan[kPB], H = (int)plan[kPH], N = (int)plan[kPN], d = (int)plan[kPD];
  const bool is_bf16 = plan[kPBf16] != 0;
  const int splits = (int)call[kCSplits];
  void* scratch = reinterpret_cast<void*>(call[kCScratch]);
  if (B < 1 || H < 1 || N < 1 || d < 1 || d > 256 || N > 65535 * 32 || splits < 1 ||
      (splits > 1 && (!is_bf16 || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  float scale;
  const uint32_t scale_bits = (uint32_t)plan[kPScale];
  std::memcpy(&scale, &scale_bits, sizeof scale);
  const long long* strides = plan + kPStrides;
  const long long* tma = plan + kPGeo;
  auto ptr = [call](int i) { return reinterpret_cast<void*>(call[i]); };
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(call[kCStream]);
  const float* l = static_cast<const float*>(ptr(kCLse));
  float* dvv = static_cast<float*>(ptr(kCDvec));
  for (int i = 5; i < 8; ++i)
    if (st[i].b % 2 || st[i].h % 2 || st[i].n % 2) return (int)cudaErrorMisalignedAddress;
  if (!is_bf16) {
    if (!dfdt::f32_aligned(ptr(kCO), st[3], d) || !dfdt::f32_aligned(ptr(kCDout), st[4], d))
      return (int)cudaErrorMisalignedAddress;
    using F = const float*;
    const TfArgs a{static_cast<F>(ptr(kCQ)), static_cast<F>(ptr(kCK)), static_cast<F>(ptr(kCV)),
                   static_cast<F>(ptr(kCO)), static_cast<F>(ptr(kCDout)), l, dvv,
                   static_cast<float*>(ptr(kCDq)), static_cast<float*>(ptr(kCDk)),
                   static_cast<float*>(ptr(kCDv)), st[3], st[4], H, N, d, scale};
    if (d <= 32) return launch_tf32<32>(a, tma, B, s);
    if (d <= 64) return launch_tf32<64>(a, tma, B, s);
    if (d <= 128) return launch_tf32<128>(a, tma, B, s);
    return launch_tf32<256>(a, tma, B, s);
  }
  if (d % 8) return (int)cudaErrorMisalignedAddress;
  using T = __nv_bfloat16;
  const BwdArgs a{static_cast<const T*>(ptr(kCQ)), static_cast<const T*>(ptr(kCK)),
                  static_cast<const T*>(ptr(kCV)), static_cast<const T*>(ptr(kCO)),
                  static_cast<const T*>(ptr(kCDout)), l, dvv, static_cast<T*>(ptr(kCDq)),
                  static_cast<T*>(ptr(kCDk)), static_cast<T*>(ptr(kCDv)),
                  static_cast<float*>(scratch), (long long)splits * B * H * N * d,
                  st[5], st[6], st[7], H, N, d, splits, scale};
  if (d <= 64) return launch_bf16<64>(a, tma, B, s);
  if (d <= 128) return launch_bf16<128>(a, tma, B, s);
  if (d <= 192) return launch_bf16<192>(a, tma, B, s);
  return launch_bf16<256>(a, tma, B, s);
}

// Forget the tensor maps and shared-memory attributes this library keeps
// (tests: a cleared cache must give the same results).
extern "C" void dfdt_clear_launch_cache() { dfdt::launch_cache().clear(); }

#ifdef DFDT_BWD_TRACE
// the first `blocks` blocks' cycle marks and phase sums (kTraceSlots each)
// of the last traced launch of pass p (0: dQ, 1: dK/dV)
extern "C" int dfdt_bwd_trace(long long* out, int p, int blocks) {
  return (int)cudaMemcpyFromSymbol(out, g_bwd_trace, sizeof(long long) * kTraceSlots * blocks,
                                   sizeof(long long) * kTraceSlots * kTraceBlocks * p);
}
#endif

extern "C" const char* dfdt_error_string(int code) { return dfdt::error_string(code); }
