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
// rtol = 1e-3) runs flash_bwd_dq_tf32_kernel and flash_bwd_dkv_tf32_kernel
// at every N (f32 has no split route): K4's regime and, at N > 512, K5's
// and K6's. Two passes as above (blocks of 4 warps of 16 rows, 64-row
// blocks, row tile fastest, D fused into the dQ pass, a 2-stage cp.async
// ring of 32-row streamed tiles, 16 above d = 128; P and dS formed on the
// accumulator fragments and fed to the next product with no shared memory;
// no atomics, so reruns are bit-identical), with every product on the
// tensor cores as 3xTF32 (mma_tf32.cuh): each f32 operand split into two
// tf32 terms, three mma.m16n8k8 tf32 products for one f32 product, f32
// sums. What bounds it on an H100: at (128, 12, 197, 64) it moves ~621 MB
// (0.185 ms at 3.35 TB/s) and does 38.2 GFLOP, x 3 at 495 TFLOP/s tf32 =
// 0.231 ms: operations. In practice instruction issue bounds it, as the
// forward (mma_tf32.cuh: the splits, three mma.sync a product; the split by
// truncation and integer rounding in place of cvt.rna.tf32.f32 took 35 %
// off). f32 tiles sit in shared memory in rows padded to DP + 4 floats (DP
// = d rounded up to 32, 64, 128 or 256); operands stored [n][k] (K for Q
// K^T, Q and dO in the dK/dV pass's S^T and dP^T) load by ldmatrix on f32
// rows, operands stored [k][n] (K for dS K, dO for P^T dO, Q for dS^T Q) by
// 32-bit loads in the relabelled k order of the accumulator fragments.
// Dynamic shared memory (128 + 4 BN) (DP + 4) * 4 bytes plus the f32 rows:
// 69,888 (dQ) and 70,144 (dK/dV) at d = 64. d must be a multiple of 4 with
// 16-byte aligned rows (the wrapper's zero-padded copy otherwise); the f32
// kernels take element strides for the B, H and N axes (the last axis
// contiguous), so dO goes in as the strided view autograd hands over.

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
// loop's last product (3) and after the epilogue (4).
#ifdef DFDT_BWD_TRACE
constexpr int kTraceBlocks = 1 << 16;
__device__ long long g_bwd_trace[2][kTraceBlocks][5];
#define BWD_MARK(p, k)                                 \
  do {                                                 \
    if (threadIdx.x == 0 && blockIdx.x < kTraceBlocks) \
      g_bwd_trace[p][blockIdx.x][k] = clock64();       \
  } while (0)
#else
#define BWD_MARK(p, k) \
  do {                 \
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
  CUtensorMap m[8];  // q, k, v, o, dout, and (unsplit) dq, dk, dv
  for (int i = 0; i < (split ? 5 : 8); ++i) {
    const int err = dfdt::encode_map(&m[i], ptrs[i], geo + 9 * i, a.d, a.N, a.H, B, C::ROWS);
    if (err) return err;
  }
  const void* dq_kernel = split ? (const void*)flash_bwd_dq_split_bf16_wgmma_kernel<DP>
                                : (const void*)flash_bwd_dq_bf16_wgmma_kernel<DP>;
  const void* dkv_kernel = split ? (const void*)flash_bwd_dkv_split_bf16_wgmma_kernel<DP>
                                 : (const void*)flash_bwd_dkv_bf16_wgmma_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)C::dq_smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::dkv_smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)B * a.H * n_tiles * C::CB * a.splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)blocks;
  if (split)
    flash_bwd_dq_split_bf16_wgmma_kernel<DP><<<grid, C::THREADS, C::dq_smem, stream>>>(
        m[0], m[1], m[2], m[3], m[4], a.lse, a.dvec, a.part, a.H, a.N, a.d, a.splits, a.scale);
  else
    flash_bwd_dq_bf16_wgmma_kernel<DP><<<grid, C::THREADS, C::dq_smem, stream>>>(
        m[0], m[1], m[2], m[3], m[4], m[5], a.lse, a.dvec, a.H, a.N, a.d, a.scale);
  e = cudaGetLastError();
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

// ---- f32: the 3xTF32 tensor-core kernels ----

template <int DP> struct TfBwd {
  static constexpr int THREADS = 128;             // 4 warps of 16 rows
  static constexpr int ROWS = 64;                 // rows a block owns
  static constexpr int BN = DP <= 128 ? 32 : 16;  // rows per streamed tile
  static constexpr int LD = DP + 4;               // floats per shared-memory row
  static constexpr size_t tiles = sizeof(float) * (2 * ROWS + 4 * BN) * LD;
  static constexpr size_t dq_smem = tiles + sizeof(float) * ROWS;
  static constexpr size_t dkv_smem = tiles + sizeof(float) * 4 * BN;
};

// S = A0 B0^T and T = A1 B1^T for one warp in f32 by 3xTF32: A0, A1 the
// warp's 16 rows at a0/a1 (a_off_f32 layout), B0, B1 the streamed tile's
// rows at b0/b1 (bn_off_f32 layout). The k-steps run outermost, so each A
// fragment is split once a tile. LAST as in two_products.
template <int DP, int BN, bool LAST>
__device__ __forceinline__ void two_products_tf32(float (&s)[BN / 8][4], float (&t)[BN / 8][4],
                                                  uint32_t a0, uint32_t a1, uint32_t b0,
                                                  uint32_t b1, int live) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = t[j][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < DP / 8; ++kd) {
    uint32_t r0[4], r1[4];
    dfdt::ldsm_x4(r0, a0 + kd * 32);
    dfdt::ldsm_x4(r1, a1 + kd * 32);
    dfdt::FragA x0, x1;
    dfdt::split_a(x0, r0);
    dfdt::split_a(x1, r1);
#pragma unroll
    for (int np = 0; np < BN / 16; ++np) {
      if (!LAST || np * 16 < live) {
        uint32_t y0[4], y1[4];
        dfdt::ldsm_x4(y0, b0 + 4 * (np * 16 * LD + kd * 8));
        dfdt::ldsm_x4(y1, b1 + 4 * (np * 16 * LD + kd * 8));
        dfdt::FragB f;
        dfdt::split_b(f, __uint_as_float(y0[0]), __uint_as_float(y0[1]));
        dfdt::mma_3xtf32(s[2 * np], x0, f);
        dfdt::split_b(f, __uint_as_float(y0[2]), __uint_as_float(y0[3]));
        dfdt::mma_3xtf32(s[2 * np + 1], x0, f);
        dfdt::split_b(f, __uint_as_float(y1[0]), __uint_as_float(y1[1]));
        dfdt::mma_3xtf32(t[2 * np], x1, f);
        dfdt::split_b(f, __uint_as_float(y1[2]), __uint_as_float(y1[3]));
        dfdt::mma_3xtf32(t[2 * np + 1], x1, f);
      }
    }
  }
}

// acc += X Y for one warp in f32 by 3xTF32: X is 16 x BN, the C fragments
// x (relabelled k order); Y the streamed tile stored [k][n] at y
// (bk_off_f32 added), read by 32-bit loads. LAST as in product_into.
template <int DP, int BN, bool LAST>
__device__ __forceinline__ void product_into_tf32(float (&acc)[DP / 8][4],
                                                  const float (&x)[BN / 8][4], const float* y,
                                                  int live) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    if (!LAST || kk * 8 < live) {
      dfdt::FragA a;
      dfdt::c_to_a_tf32<BN / 8>(a, x, kk);
#pragma unroll
      for (int jd = 0; jd < DP / 8; ++jd) {
        dfdt::FragB b;
        dfdt::load_b_kn<LD>(b, y, kk, jd);
        dfdt::mma_3xtf32(acc[jd], a, b);
      }
    }
  }
}

// The dQ pass in f32 (both passes are compiled for 1 block per SM: with no
// minimum, ptxas held the dK/dV pass to 168 registers at d = 64 and spilled).
// One block per (64-row query tile, b*h), row tile
// fastest: D for the tile's rows, then a walk over every K/V tile
// accumulating dQ = sum dS K, written times the scale.
template <int DP>
__global__ void __launch_bounds__(TfBwd<DP>::THREADS, 1)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ o,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         float* __restrict__ dvec, float* __restrict__ dq, Strides sq,
                         Strides sk, Strides sv, Strides so, Strides sdo, Strides sdq, int H,
                         int N, int d, float scale) {
  using C = TfBwd<DP>;
  constexpr int BN = C::BN, LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sdO = sQ + C::ROWS * LD;
  float* sK = sdO + C::ROWS * LD;  // two stages
  float* sV = sK + 2 * BN * LD;    // two stages
  float* sD = sV + 2 * BN * LD;

  const dfdt::Work w = dfdt::block_work<C::ROWS, BN>(N, 1);
  const int bh = w.bh;
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = w.row0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow0 = row0 + warp * 16;
  const bool active = wrow0 < N;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  dfdt::tile_async<DP, LD, C::ROWS, C::THREADS>(sQ, q + b * sq.b + h * sq.h, sq.n, row0, N,
                                                    d);
  dfdt::tile_async<DP, LD, C::ROWS, C::THREADS>(sdO, dob, sdo.n, row0, N, d);
  dfdt::tile_async<DP, LD, BN, C::THREADS>(sK, kb, sk.n, 0, N, d);
  dfdt::tile_async<DP, LD, BN, C::THREADS>(sV, vb, sv.n, 0, N, d);
  dfdt::cp_async_commit();

  // D = rowsum(dO * O): two lanes per row, 16-byte reads
  {
    const int r = threadIdx.x / 2;
    const int gr = row0 + r;
    float part = 0.f;
    if (gr < N) {
      const float* orow = o + b * so.b + h * so.h + gr * so.n;
      const float* drow = dob + gr * sdo.n;
      for (int c = (threadIdx.x % 2) * 4; c < d; c += 8) {
        const float4 x = *reinterpret_cast<const float4*>(orow + c);
        const float4 y = *reinterpret_cast<const float4*>(drow + c);
        part = fmaf(x.x, y.x, part);
        part = fmaf(x.y, y.y, part);
        part = fmaf(x.z, y.z, part);
        part = fmaf(x.w, y.w, part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (threadIdx.x % 2 == 0) {
      sD[r] = part;
      if (gr < N) dvec[(long long)bh * N + gr] = part;
    }
  }

  const float sl2 = scale * kLog2e;
  float lrow[2], drow[2] = {0.f, 0.f};  // lse (log2 units) and D of rows g, g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = wrow0 + lane / 4 + 8 * i;
    lrow[i] = gr < N ? lse[(long long)bh * N + gr] * kLog2e : 0.f;
  }
  float acc[DP / 8][4] = {};
  const uint32_t wQ = dfdt::smem_u32(sQ + warp * 16 * LD) + dfdt::a_off_f32<LD>(lane);
  const uint32_t wdO = dfdt::smem_u32(sdO + warp * 16 * LD) + dfdt::a_off_f32<LD>(lane);
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
      if (t == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) drow[i] = sD[warp * 16 + lane / 4 + 8 * i];
      }
      const int key0 = t * BN;
      const int kv = min(BN, N - key0);
      float* tK = sK + st * BN * LD;
      const uint32_t uK = dfdt::smem_u32(tK);
      const uint32_t uV = dfdt::smem_u32(sV + st * BN * LD);
      // LAST: the tile that holds key N - 1 (masked, with skips)
      auto step = [&](auto last) {
        constexpr bool LAST = decltype(last)::value;
        // S = Q K^T, dP = dO V^T
        float s[BN / 8][4], dp[BN / 8][4];
        two_products_tf32<DP, BN, LAST>(s, dp, wQ, wdO, uK + dfdt::bn_off_f32<LD>(lane),
                                        uV + dfdt::bn_off_f32<LD>(lane), kv);
        // dS = P (dP - D), P = exp(S scale - L) and 0 on keys >= N
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool live = !LAST || key0 + j * 8 + 2 * (lane % 4) + (e & 1) < N;
            const float p = live ? exp2f(fmaf(s[j][e], sl2, -lrow[e >> 1])) : 0.f;
            s[j][e] = p * (dp[j][e] - drow[e >> 1]);
          }
        // dQ += dS K
        product_into_tf32<DP, BN, LAST>(acc, s, tK + dfdt::bk_off_f32<LD>(lane), kv);
      };
      if (kv == BN)
        step(std::false_type{});
      else
        step(std::true_type{});
    }
    __syncthreads();
  }
  if (!active) return;
  const float mul[2] = {scale, scale};
  dfdt::store_rows_f32<DP>(dq + b * sdq.b + h * sdq.h, sdq.n, acc, mul, wrow0, N, d,
                                   lane);
}

// The dK/dV pass in f32. One block per (64-key tile, b*h), row tile
// fastest: a walk over every Q/dO tile (with its lse and D rows)
// accumulating dV = sum P^T dO and dK = sum dS^T Q (written times the
// scale); P = 0 on query rows >= N.
template <int DP>
__global__ void __launch_bounds__(TfBwd<DP>::THREADS, 1)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dvec,
                          float* __restrict__ dk, float* __restrict__ dv, Strides sq,
                          Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv, int H,
                          int N, int d, float scale) {
  using C = TfBwd<DP>;
  constexpr int BN = C::BN, LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + C::ROWS * LD;
  float* sQ = sV + C::ROWS * LD;  // two stages
  float* sdO = sQ + 2 * BN * LD;  // two stages
  float* sL = sdO + 2 * BN * LD;  // two stages
  float* sD = sL + 2 * BN;        // two stages

  const dfdt::Work w = dfdt::block_work<C::ROWS, BN>(N, 1);
  const int bh = w.bh;
  const int b = bh / H;
  const int h = bh % H;
  const int key0 = w.row0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wkey0 = key0 + warp * 16;
  const bool active = wkey0 < N;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* lb = lse + (long long)bh * N;
  const float* db = dvec + (long long)bh * N;
  // query tile `tile` (its Q, dO, lse and D rows) into stage `st`
  auto load_queries = [&](int tile, int st) {
    const int q0 = tile * BN;
    dfdt::tile_async<DP, LD, BN, C::THREADS>(sQ + st * BN * LD, qb, sq.n, q0, N, d);
    dfdt::tile_async<DP, LD, BN, C::THREADS>(sdO + st * BN * LD, dob, sdo.n, q0, N, d);
    for (int i = threadIdx.x; i < 2 * BN; i += C::THREADS) {
      const int r = i % BN;
      const bool ok = q0 + r < N;
      const float* src = i < BN ? lb : db;
      dfdt::cp_async4((i < BN ? sL : sD) + st * BN + r, ok ? src + q0 + r : src, ok);
    }
  };
  dfdt::tile_async<DP, LD, C::ROWS, C::THREADS>(sK, k + b * sk.b + h * sk.h, sk.n, key0, N,
                                                    d);
  dfdt::tile_async<DP, LD, C::ROWS, C::THREADS>(sV, v + b * sv.b + h * sv.h, sv.n, key0, N,
                                                    d);
  load_queries(0, 0);
  dfdt::cp_async_commit();

  const float sl2 = scale * kLog2e;
  float acc_dk[DP / 8][4] = {}, acc_dv[DP / 8][4] = {};
  const uint32_t wK = dfdt::smem_u32(sK + warp * 16 * LD) + dfdt::a_off_f32<LD>(lane);
  const uint32_t wV = dfdt::smem_u32(sV + warp * 16 * LD) + dfdt::a_off_f32<LD>(lane);
  const int n_tiles = (N + BN - 1) / BN;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      load_queries(t + 1, st ^ 1);
      dfdt::cp_async_commit();
      dfdt::cp_async_wait<1>();
    } else {
      dfdt::cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      const int q0 = t * BN;
      const int qv = min(BN, N - q0);
      const float* tQ = sQ + st * BN * LD;
      const float* tdO = sdO + st * BN * LD;
      const float* tL = sL + st * BN;
      const float* tD = sD + st * BN;
      // LAST: the tile that holds query row N - 1 (masked, with skips)
      auto step = [&](auto last) {
        constexpr bool LAST = decltype(last)::value;
        // S^T = K Q^T, dP^T = V dO^T
        float s[BN / 8][4], dp[BN / 8][4];
        two_products_tf32<DP, BN, LAST>(s, dp, wK, wV,
                                        dfdt::smem_u32(tQ) + dfdt::bn_off_f32<LD>(lane),
                                        dfdt::smem_u32(tdO) + dfdt::bn_off_f32<LD>(lane), qv);
        // P^T (0 on query rows >= N: their lse is not a logsumexp) and dS^T
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j * 8 + 2 * (lane % 4) + (e & 1);
            const float p = !LAST || q0 + col < N
                                ? exp2f(fmaf(s[j][e], sl2, -tL[col] * kLog2e))
                                : 0.f;
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - tD[col]);
          }
        // dV += P^T dO, dK += dS^T Q
        product_into_tf32<DP, BN, LAST>(acc_dv, s, tdO + dfdt::bk_off_f32<LD>(lane), qv);
        product_into_tf32<DP, BN, LAST>(acc_dk, dp, tQ + dfdt::bk_off_f32<LD>(lane), qv);
      };
      if (qv == BN)
        step(std::false_type{});
      else
        step(std::true_type{});
    }
    __syncthreads();
  }
  if (!active) return;
  const float mul_dk[2] = {scale, scale}, one[2] = {1.f, 1.f};
  dfdt::store_rows_f32<DP>(dk + b * sdk.b + h * sdk.h, sdk.n, acc_dk, mul_dk, wkey0, N,
                                   d, lane);
  dfdt::store_rows_f32<DP>(dv + b * sdv.b + h * sdv.h, sdv.n, acc_dv, one, wkey0, N, d,
                                   lane);
}

// st: (b, h, n) strides of q, k, v, o, dout, dq, dk, dv
template <int DP>
cudaError_t launch_tf32(const float* q, const float* k, const float* v, const float* o,
                        const float* dout, const float* lse, float* dvec, float* dq, float* dk,
                        float* dv, const Strides* st, int B, int H, int N, int d, float scale,
                        cudaStream_t stream) {
  using C = TfBwd<DP>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tf32_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_tf32_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::dkv_smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((N + C::ROWS - 1) / C::ROWS);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dq_tf32_kernel<DP><<<(unsigned)blocks, C::THREADS, C::dq_smem, stream>>>(
      q, k, v, o, dout, lse, dvec, dq, st[0], st[1], st[2], st[3], st[4], st[5], H, N, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_tf32_kernel<DP><<<(unsigned)blocks, C::THREADS, C::dkv_smem, stream>>>(
      q, k, v, dout, lse, dvec, dk, dv, st[0], st[1], st[2], st[4], st[6], st[7], H, N, d, scale);
  return cudaGetLastError();
}

}  // namespace

// strides: 24 element strides, (b, h, n) for q, k, v, o, dout, dq, dk, dv in
// that order. lse and dvec (scratch for D) are contiguous f32 (B, H, N).
// bf16 goes to the Hopper kernels, which read q, k, v, o, dout and write dq,
// dk, dv through tensor maps built from `tma` (9 values for each of the
// eight, see encode_map; d a multiple of 8; the reduce kernel of the split
// route writes dq, dk, dv through their strides); f32 goes to the 3xTF32
// kernels, which take 16-byte rows of q, k, v, o, dout
// (cudaErrorMisalignedAddress otherwise) and ignore `tma`. splits: 1, or
// (bf16 only) the splits S of the split route, with `scratch` the caller's
// f32 buffer of 3*S*B*H*N*d elements for the partials.
extern "C" int dfdt_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* dvec, void* dq,
                              void* dk, void* dv, int B, int H, int N, int d, int is_bf16,
                              const long long* strides, float scale, int splits, void* scratch,
                              void* stream, const long long* tma) {
  if (B < 1 || H < 1 || N < 1 || d < 1 || d > 256 || N > 65535 * 32 || splits < 1 ||
      (splits > 1 && (!is_bf16 || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dvv = static_cast<float*>(dvec);
  for (int i = 5; i < 8; ++i)
    if (st[i].b % 2 || st[i].h % 2 || st[i].n % 2) return (int)cudaErrorMisalignedAddress;
  if (!is_bf16) {
    const void* ins[5] = {q, k, v, o, dout};
    for (int i = 0; i < 5; ++i)
      if (!dfdt::f32_aligned(ins[i], st[i], d)) return (int)cudaErrorMisalignedAddress;
    using F = const float*;
    F fq = static_cast<F>(q), fk = static_cast<F>(k), fv = static_cast<F>(v),
      fo = static_cast<F>(o), fdo = static_cast<F>(dout);
    float *fdq = static_cast<float*>(dq), *fdk = static_cast<float*>(dk),
          *fdv = static_cast<float*>(dv);
#define DFDT_BWD_TF32(DP) \
  launch_tf32<DP>(fq, fk, fv, fo, fdo, l, dvv, fdq, fdk, fdv, st, B, H, N, d, scale, s)
    if (d <= 32) return (int)DFDT_BWD_TF32(32);
    if (d <= 64) return (int)DFDT_BWD_TF32(64);
    if (d <= 128) return (int)DFDT_BWD_TF32(128);
    return (int)DFDT_BWD_TF32(256);
#undef DFDT_BWD_TF32
  }
  if (tma == nullptr || d % 8) return (int)cudaErrorMisalignedAddress;
  using T = __nv_bfloat16;
  const BwdArgs a{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<const T*>(o), static_cast<const T*>(dout), l, dvv,
                  static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
                  static_cast<float*>(scratch), (long long)splits * B * H * N * d,
                  st[5], st[6], st[7], H, N, d, splits, scale};
  if (d <= 64) return launch_bf16<64>(a, tma, B, s);
  if (d <= 128) return launch_bf16<128>(a, tma, B, s);
  if (d <= 192) return launch_bf16<192>(a, tma, B, s);
  return launch_bf16<256>(a, tma, B, s);
}

#ifdef DFDT_BWD_TRACE
// the first `blocks` blocks' cycle marks (5 each) of the last traced launch
// of pass p (0: dQ, 1: dK/dV)
extern "C" int dfdt_bwd_trace(long long* out, int p, int blocks) {
  return (int)cudaMemcpyFromSymbol(out, g_bwd_trace, sizeof(long long) * 5 * blocks,
                                   sizeof(long long) * 5 * kTraceBlocks * p);
}
#endif

extern "C" const char* dfdt_error_string(int code) { return dfdt::error_string(code); }
