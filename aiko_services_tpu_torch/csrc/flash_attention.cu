// Flash attention for Hopper (sm_90a), bf16 in and out, f32 softmax.
//
// Replaces: aiko_services_tpu/ops/attention.py `_flash_kernel` (called
// through `flash_attention`), the Pallas kernel that runs the Whisper
// encoder's self-attention once the audio context reaches 1024 positions.
//
// What bounds it on an H100: operations, and at D = 64 the exponentials
// beside them.  At the Whisper-small serving shape (B*H = 96, S = 1536,
// D = 64) the two products are 4*96*1536^2*64 = 5.8e10 FLOP (0.059 ms at
// 989 TFLOP/s) against 75 MB of q/k/v/o traffic; the softmax evaluates
// 96*1536^2 = 2.3e8 exp2, which at 16 a clock per SM also takes ~0.06 ms
// on the special-function units, and its max, scale, sum and convert
// instructions come on top.  The S x S score matrix never reaches device
// memory.
//
// Design, per what bounds it:
// - Both products on wgmma (warpgroup MMA, bf16 operands, f32
//   accumulators).  S = Q K^T is m64n128k16 with Q and K read from
//   shared memory (K-major, 128-byte swizzle: one D = 64 bf16 row is one
//   swizzle row).  O += P V is m64n64k16 with P as the register A
//   operand: the S accumulator fragment has the A fragment's layout, so
//   the probabilities are rounded to bf16 in registers and never touch
//   shared memory; V is read from shared memory transposed (MN-major).
// - A block owns 192 query rows: three consumer warpgroups of 64 rows
//   share every K/V tile (each tile read from L2 serves 192 rows), and
//   the SM's schedulers interleave one warpgroup's softmax with another's
//   products.  Three measured faster than two (with or without issuing
//   the next tile's S before this tile's PV, or taking turns through
//   named barriers): at D = 64 the softmax's instructions, not the
//   tensor cores, are most of a warpgroup's time.
// - A producer warpgroup (one elected thread) keeps a two-stage ring of
//   128-key K and V tiles filled by TMA, completion on mbarriers; K and V
//   of a stage have their own full and empty barriers, so S = Q K^T
//   starts while V is still arriving.  The tensor maps are built on the
//   host per call over (D, and the operand's sequence, head and batch
//   axes in stride order), so the heads-last view and contiguous
//   [B, H, S, D] load without a copy.  The producer gives its registers
//   to the consumers (setmaxnreg: 56 and 152 a thread).
// - Persistent grid: one block per SM walks the (batch*head, 192-row
//   tile) list, so a block's next Q tile and K/V tiles load while it
//   finishes the last one.
// - Scores stay raw; the scale (times log2 e) folds into one FFMA per
//   score before exp2 (ex2.approx).  The running max and sum stay in f32
//   registers; the row sum is kept per thread and reduced once at the end.
// Edges: S a multiple of 64.  A Q tile past S and a key tile past S load
// zeros there (TMA fills out-of-bounds rows with 0); keys past S are
// masked, rows past S are not written.  Causal runs stop at the diagonal
// and mask the key tiles it crosses.  A row whose every key is masked
// keeps l == 0 and is written as 0 (the reference's l == 0 guard).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kConsumerWGs = 3;
constexpr int kBlockQ = 64 * kConsumerWGs;   // 64 rows a consumer warpgroup
constexpr int kBlockK = 128;           // keys per K/V tile
constexpr int kStages = 2;             // K/V ring depth
constexpr int kConsumerThreads = 128 * kConsumerWGs;
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kConsumerWarps = kConsumerThreads / 32;
// registers a thread after the hand-over (setmaxnreg): the producer keeps
// few, the consumers take the rest of the 64K (S 64, O 32 and P 32 a
// thread, beside addresses and the softmax state)
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 152;
static_assert(kProducerRegs * 128 + kConsumerRegs * kConsumerThreads <=
                  65536,
              "register hand-over exceeds the register file");
constexpr int kRowBytes = kHeadDim * 2;           // one 128-byte swizzle row
constexpr int kQBytes = kBlockQ * kRowBytes;      // 24 KB
constexpr int kTileBytes = kBlockK * kRowBytes;   // 16 KB
constexpr int kBarriers = 2 + 4 * kStages;
// Q, the K ring, the V ring (each 1024-byte aligned, as the 128-byte
// swizzle needs), the barriers, and room to align the base
constexpr int kSmemBytes =
    kQBytes + 2 * kStages * kTileBytes + kBarriers * 8 + 1024;

struct OutStrides {                    // element strides of o
  long long b, h, s;
};

// -- shared memory, barriers, TMA --------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// spin until the barrier's phase of this parity has completed; a wait
// that never ends (a broken ring) traps, so the call fails instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one tile of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// The tensor map's axes 1..3 are the operand's sequence, head and batch
// axes sorted by stride; `order` packs the map axis of each (2 bits each:
// sequence, head, batch).  Coordinates of (position, head, batch).
__device__ __forceinline__ void tile_coords(int order, int pos, int h, int b,
                                            int& c1, int& c2, int& c3) {
  const int as = order & 3, ah = (order >> 2) & 3;
  c1 = as == 1 ? pos : ah == 1 ? h : b;
  c2 = as == 2 ? pos : ah == 2 ? h : b;
  c3 = as == 3 ? pos : ah == 3 ? h : b;
}

// -- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor of a tile of 128-byte rows written with
// the 128-byte swizzle (as TMA writes it): start address, 8-row groups
// 1024 bytes apart.  The same offset is given as both the leading and the
// stride byte offset: a K-major operand whose k16 slice lies inside one
// swizzle row uses neither beyond the group stride, and V's MN-major
// tile is one swizzle atom wide (N = 64), so the one stride that applies
// is the 1024 bytes from one 8-key group to the next.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t kGroup = 1024 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (kGroup << 16) |
         (kGroup << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses of wgmma's registers across the
// asynchronous product's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}


// d (+)= A(64x16, smem) * B(16x128, smem, K-major), bf16 -> f32
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A(64x16, registers) * B(16x64, smem, MN-major), bf16 -> f32
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// -- arithmetic ----------------------------------------------------------------

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);  // .x: low half
  return *reinterpret_cast<uint32_t*>(&pair);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  return x + __shfl_xor_sync(0xffffffff, x, 2);
}

// -- one key tile of a consumer warpgroup --------------------------------------

// S = Q K^T for 64 rows x 128 keys, issued (the caller waits)
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q,
                                         uint32_t k) {
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk)
    wgmma_ss_n128(sc, smem_desc(q + kk * 32), smem_desc(k + kk * 32),
                  kk > 0);
  wgmma_commit();
}

// O += P V: 16 keys a step, V's tile read transposed (issued)
__device__ __forceinline__ void issue_pv(float (&acc)[32],
                                         const uint32_t (&p)[kBlockK / 16][4],
                                         uint32_t v) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk)
    wgmma_rs_n64(acc, p[kk], smem_desc(v + kk * 16 * kRowBytes));
  wgmma_commit();
}

// The online softmax of one score tile in the log2 domain, rows r0 (the
// accumulator's even pairs) and r1, in place: masks keys past S and,
// causal, above the diagonal if `masked`, updates the running max m and
// this thread's row sums l, leaves the f32 probabilities in sc and the
// factors that rescale O in corr.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int key0, bool masked, int seq,
                                             int causal, int r0, int r1,
                                             int t, float scale_log2) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int key = key0 + (i / 4) * 8 + 2 * t + (i & 1);
      const int row = (i & 2) ? r1 : r0;
      if (key >= seq || (causal && key > row)) sc[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; i += 4) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[i], sc[i + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[i + 2], sc[i + 3]));
  }
  float safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float top = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
    safe[r] = top == -INFINITY ? 0.f : top;
    corr[r] = fast_exp2(m[r] - safe[r]);     // m = -inf: 0
    m[r] = top;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -safe[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += sc[i];
  }
  l[0] = l[0] * corr[0] + sum[0];
  l[1] = l[1] * corr[1] + sum[1];
}

// the probabilities rounded to bf16 as PV's A fragments: 16 keys a step,
// (row r0, keys 2t, 2t + 1), (r1, same), (r0, 2t + 8, + 9), (r1, same)
__device__ __forceinline__ void pack_probabilities(
    const float (&sc)[64], uint32_t (&p)[kBlockK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[kk][i] = pack_bf16(sc[kk * 8 + 2 * i], sc[kk * 8 + 2 * i + 1]);
}

__device__ __forceinline__ void rescale(float (&acc)[32],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    acc[i] *= corr[0];
    acc[i + 1] *= corr[0];
    acc[i + 2] *= corr[1];
    acc[i + 3] *= corr[1];
  }
}

// -- the kernel ------------------------------------------------------------------

// Work: tiles of (batch*head, kBlockQ query rows), in that order, walked
// by a persistent grid.  Key tiles of a Q tile: all (or, causal, up to the
// diagonal).  A key tile is masked where it reaches past S or, causal,
// past the tile's first row.
__device__ __forceinline__ int key_tiles(int q0, int seq, int causal) {
  const int last = causal ? min(q0 + kBlockQ, seq) : seq;
  return (last + kBlockK - 1) / kBlockK;
}

__device__ __forceinline__ bool needs_mask(int key0, int q0, int seq,
                                           int causal) {
  return key0 + kBlockK > seq || (causal && key0 + kBlockK - 1 > q0);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       int order_q, int order_k, int order_v,
                       __nv_bfloat16* __restrict__ o, OutStrides so,
                       int heads, int seq, int q_tiles, int tiles,
                       float scale_log2, int causal) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = sq + kQBytes;                    // kStages tiles
  const uint32_t sv = sk + kStages * kTileBytes;       // kStages tiles
  const uint32_t bars = sv + kStages * kTileBytes;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 16 + 8 * s; };
  auto k_empty = [&](int s) { return bars + 16 + 8 * (kStages + s); };
  auto v_full = [&](int s) { return bars + 16 + 8 * (2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 16 + 8 * (3 * kStages + s); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumerWarps);
      mbar_init(v_empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // == producer: one thread issues every load ==========================
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != kConsumerThreads) return;
    int use = 0;                       // K/V ring uses so far
    int round = 0;                     // Q tiles so far
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++round) {
      const int bh = tile / q_tiles, q0 = (tile % q_tiles) * kBlockQ;
      const int b = bh / heads, h = bh % heads;
      int c1, c2, c3;
      mbar_wait(q_empty, (round & 1) ^ 1);
      mbar_expect_tx(q_full, kQBytes);
      tile_coords(order_q, q0, h, b, c1, c2, c3);
      tma_load(sq, &map_q, q_full, c1, c2, c3);
      const int n = key_tiles(q0, seq, causal);
      for (int j = 0; j < n; ++j, ++use) {
        const int s = use % kStages;
        const uint32_t parity = ((use / kStages) & 1) ^ 1;
        mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), kTileBytes);
        tile_coords(order_k, j * kBlockK, h, b, c1, c2, c3);
        tma_load(sk + s * kTileBytes, &map_k, k_full(s), c1, c2, c3);
        mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), kTileBytes);
        tile_coords(order_v, j * kBlockK, h, b, c1, c2, c3);
        tma_load(sv + s * kTileBytes, &map_v, v_full(s), c1, c2, c3);
      }
    }
    return;
  }

  // == consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a Q tile ==
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4;
  const int t = lane & 3;                      // fragment column
  const int row_in_tile = wg * 64 + (warp % 4) * 16 + (lane >> 2);  // + 8
  const uint32_t sq_wg = sq + wg * 64 * kRowBytes;
  // a consumer warp releases a ring slot once its products have read it
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  int use = 0, round = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++round) {
    const int bh = tile / q_tiles, q0 = (tile % q_tiles) * kBlockQ;
    const int b = bh / heads, h = bh % heads;
    const int r0 = q0 + row_in_tile, r1 = r0 + 8;
    const int n = key_tiles(q0, seq, causal);

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float sc[64];
    uint32_t p[kBlockK / 16][4];
    float m[2] = {-INFINITY, -INFINITY};      // running max, log2 domain
    float l[2] = {0.f, 0.f};                  // this thread's row sums
    float corr[2];
    mbar_wait(q_full, round & 1);

    for (int j = 0; j < n; ++j, ++use) {
      const int s = use % kStages;
      const uint32_t parity = (use / kStages) & 1;
      mbar_wait(k_full(s), parity);
      issue_qk(sc, sq_wg, sk + s * kTileBytes);
      wgmma_wait_all();
      fence_regs(sc);
      release(k_empty(s));
      if (j == n - 1) release(q_empty);     // Q is read for this tile
      softmax_tile(sc, m, l, corr, j * kBlockK,
                   needs_mask(j * kBlockK, q0, seq, causal), seq, causal, r0,
                   r1, t, scale_log2);
      pack_probabilities(sc, p);
      rescale(acc, corr);
      mbar_wait(v_full(s), parity);
      issue_pv(acc, p, sv + s * kTileBytes);
      wgmma_wait_all();
      fence_regs(acc);
      release(v_empty(s));
    }

    // epilogue: rows past S (a half tile) are not written
    const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
    const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
    const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
    __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const int col = (i / 4) * 8 + 2 * t;
      if (r0 < seq)
        *reinterpret_cast<uint32_t*>(ob + r0 * so.s + col) =
            pack_bf16(acc[i] * inv0, acc[i + 1] * inv0);
      if (r1 < seq)
        *reinterpret_cast<uint32_t*>(ob + r1 * so.s + col) =
            pack_bf16(acc[i + 2] * inv1, acc[i + 3] * inv1);
    }
  }
}

// -- host side -----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: reached through the
// runtime's entry-point query, so the library links no libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled function = nullptr;
  if (function == nullptr) {
    void* found = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &found,
                                         12000, cudaEnableDefault,
                                         &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      function = reinterpret_cast<EncodeTiled>(found);
  }
  return function;
}

// A [rows, 64] bf16 tile map over one operand: axis 0 is D, axes 1..3 the
// sequence, head and batch axes sorted by stride (the driver wants them
// in that order); `order` receives the map axis of each.  Returns false
// where the driver refuses the operand.
bool make_map(CUtensorMap* map, int* order, const void* base,
              const long long* strides, int batch, int heads, int seq,
              int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  // (stride, extent, box) of sequence, head, batch
  long long stride[3] = {strides[2], strides[1], strides[0]};
  const long long extent[3] = {seq, heads, batch};
  const int box[3] = {rows, 1, 1};
  int axis[3] = {0, 1, 2};                 // sorted by stride, stable
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && stride[axis[j]] < stride[axis[j - 1]]; --j) {
      const int tmp = axis[j];
      axis[j] = axis[j - 1];
      axis[j - 1] = tmp;
    }
  cuuint64_t dims[4] = {kHeadDim, 0, 0, 0};
  cuuint64_t bytes[3];
  cuuint32_t boxes[4] = {kHeadDim, 0, 0, 0};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  int packed = 0;
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(extent[axis[i]]);
    bytes[i] = static_cast<cuuint64_t>(stride[axis[i]]) * 2;
    boxes[i + 1] = static_cast<cuuint32_t>(box[axis[i]]);
    packed |= (i + 1) << (2 * axis[i]);
  }
  *order = packed;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, bytes, boxes, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

const char* aiko_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, o: bf16 [batch, heads, seq, 64] with unit stride on the last
// axis (64 is the head dim of every Whisper size), 16-byte aligned rows.
// strides: 12 element strides, (batch, head, seq) for q, k, v and o in
// that order.  seq must be a multiple of 64, scale positive.  Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for what it does not
// take, cudaErrorNotSupported if the driver refuses a tensor map).
int aiko_flash_attention_bf16(const void* q, const void* k, const void* v,
                              void* o, int batch, int heads, int seq,
                              int head_dim, const long long* strides,
                              float scale, int causal, void* stream) {
  if (head_dim != kHeadDim || seq % 64 != 0 || seq < 64 || batch < 1 ||
      heads < 1 || !(scale > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const int q_tiles = (seq + kBlockQ - 1) / kBlockQ;
  const long long tiles = static_cast<long long>(batch) * heads * q_tiles;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  CUtensorMap map_q, map_k, map_v;
  int order_q, order_k, order_v;
  if (!make_map(&map_q, &order_q, q, strides, batch, heads, seq, kBlockQ) ||
      !make_map(&map_k, &order_k, k, strides + 3, batch, heads, seq,
                kBlockK) ||
      !make_map(&map_v, &order_v, v, strides + 6, batch, heads, seq,
                kBlockK))
    return static_cast<int>(cudaErrorNotSupported);

  int device = 0, multiprocessors = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&multiprocessors,
                                 cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);

  const OutStrides so = {strides[9], strides[10], strides[11]};
  const int grid = static_cast<int>(
      tiles < multiprocessors ? tiles : multiprocessors);
  flash_attention_kernel<<<grid, kThreads, kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_v, order_q, order_k, order_v,
      static_cast<__nv_bfloat16*>(o), so, heads, seq, q_tiles,
      static_cast<int>(tiles), scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
