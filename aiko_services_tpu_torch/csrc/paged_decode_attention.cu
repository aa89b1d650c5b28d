// Paged decode attention for Hopper (sm_90a): GQA query rows of one
// (slot, KV head) attend over K/V read straight out of the serving block
// pool through the slot's block table, plus this round's side buffer.
//
// Replaces: aiko_services_tpu/ops/paged_attention.py `_paged_attn_kernel`
// (called through `paged_decode_attention`), in its three numerics: native
// pools, and int8 pools ({"q" int8, "s" f32 per position}) with
// fold_scales true or false.  What it computes, per query row r = g * W + w
// of slot s and KV head h:
//   main scores  q_r . K[tables[s, j], h, t] * scale, masked to -1e30 at
//                positions j * B + t >= entry_lengths[s];
//   side scores  q_r . k_side[s, h, p] * scale, masked to -1e30 where
//                side_valid[s, w, p] is false;
//   out          softmax over the whole row (main then side) . V, in f32.
// Int8 pools, fold (decode): the int8 values are the dot operands, the
// main score takes * s_k[t] after the scale and before the mask, and the
// weight * s_v[t] before the PV product.  Int8 pools, dequantize (the
// chunked-prefill extend): each value becomes round(q_i8 * round(s)) in
// the compute type (bf16 or f32) before the dots, exactly the product
// JAX's dequantize_kv_cache forms.  A row whose every score is masked
// gets the uniform average of every value it covers (nb * B main
// positions and P side entries), exactly as a softmax of equal -1e30
// scores does in the JAX kernel.
//
// What bounds it on an H100 depends on the rows per (slot, KV head), G*W:
// each K and V element loaded takes one multiply-add per row.
// - Decode (G*W = 4 at Llama-1B): 4 multiply-adds per element, far below
//   the ~295 operations per byte where the tensor cores become the limit.
//   At 16 slots x 8 KV heads, t_cap 256, B = 32, D = 64 the K+V that the
//   extents need are at most 8.4 MB bf16 (4.2 MB int8 + 0.5 MB scales):
//   1.3-2.5 us at 3.35 TB/s.  The limit is latency: loads in flight and
//   blocks enough to fill 132 SMs.
// - Extend (G*W = 256, a 64-token chunk): 256 multiply-adds per element,
//   ~256 operations per byte from a bf16 pool and ~512 from an int8 one:
//   at or above the ridge, so the products belong on the tensor cores
//   and each K/V element must be read once per (slot, KV head).
//
// Design: two paths, picked by the caller's plan from host-known shapes
// (ops/paged_attention.py `kernel_plan`; never from entry_lengths).
// 1. Split over T (few rows, and every f32 call): one block per (slot,
//    KV head, tile of 4 or 16 rows, split).  A main split covers a fixed
//    run of positions (64-256, a multiple of 32); one more split takes
//    the side buffer.  Splits past a slot's extent exit at once, unless a
//    row of the tile is fully masked: then every split covers its
//    positions.  The block's first loads (the extent, the query rows,
//    each lane's first table id) go out together.  Each warp of the block
//    takes two 32-position tiles of its split through a two-stage
//    cp.async ring of its own (16-byte copies in the storage type: bf16,
//    f32, or int8 plus f32 scales; zero-filled past the range), so the
//    next tile is in flight while this one is used.  One lane per
//    position: its K row comes out of shared memory
//    (chunks XOR-swizzled: no bank conflicts) against the query rows,
//    prescaled by scale * log2 e and read as broadcasts; an online
//    softmax per row in registers (running max from -inf, rescale of the
//    running sum and accumulators); then each lane owns two of the 64
//    output dims for the PV product, the tile's weights read four at a
//    time as broadcasts.  f32 products throughout.  The warps merge in
//    shared memory and the block writes (max, sum, accumulators) of its
//    split to scratch the wrapper allocates; a second kernel, launched
//    from the same C entry as a programmatic dependent launch (it is
//    resident before the first ends and waits on its grid), merges the
//    splits of each row.  A second launch rather than a last block that
//    merges behind a counter: no counter to keep zeroed between calls
//    and streams, no fence, and the merge order is fixed.
// 2. Tensor cores (bf16, more than 16 rows): one block of 8 warps per
//    (slot, KV head, 256 rows), each warp owning 32 rows (two m16 tiles),
//    so each K/V position is read, and in mode 2 dequantized, once per
//    (slot, KV head).  32-position K/V tiles come through a three-stage
//    cp.async ring; int8 tiles are converted to bf16 in shared memory
//    (mode 1: the values exactly, the scales applied per column after
//    QK^T and to the weights before PV; mode 2: round(q * round(s))).
//    QK^T and PV run as mma.sync m16n8k16 (bf16 operands, f32
//    accumulators); the query fragments, the scores, the running max and
//    sum and the accumulators stay in registers, and the unnormalised
//    probabilities are rounded to bf16 for PV (as JAX and the plain
//    version round their weights).  Rows past G*W are zero and not
//    written.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kHeadDim = 64;
constexpr int kMaxBlockTokens = 128;
constexpr float kMasked = -1e30f;           // JAX's mask value
constexpr float kLog2e = 1.4426950408889634f;

// pool numerics (the C entry's `mode`)
constexpr int kNative = 0;
constexpr int kInt8Fold = 1;
constexpr int kInt8Dequant = 2;

// the C entry's `path`
constexpr int kSplitPath = 0;
constexpr int kTensorPath = 1;

// split path
constexpr int kWarpTile = 32;               // positions per warp tile
constexpr int kMaxSplitWarps = 4;
constexpr int kSplitStages = 2;

// tensor path
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaRows = kMmaWarps * 32;    // rows per block
constexpr int kMmaTile = 32;                // positions per stage
constexpr int kMmaStages = 3;
constexpr int kPitch = kHeadDim + 8;        // bf16 per smem row (padded)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to the compute type T (and back to f32)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// -- cp.async -------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; !valid writes 16 zero bytes and reads nothing
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_address(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_address(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// -- mma.sync fragments (as csrc/flash_attention.cu) ----------------------
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);  // .x: low half
  return *reinterpret_cast<uint32_t*>(&pair);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// d += a(16x16, row) * b(16x8, col), bf16 operands, f32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, offset));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    x += __shfl_xor_sync(0xffffffff, x, offset);
  return x;
}


struct Shape {
  int num_kv;        // KV heads
  int rows;          // query rows per (slot, head): G * W
  int width;         // W, queries per slot
  int nb;            // table entries per slot
  int block_tokens;  // B
  int side_len;      // P
  long long table_stride;
  int tile_rows;     // rows per block
  int row_tiles;     // ceil(rows / tile_rows)
  int split_len;     // split path: positions per main split
  int splits;        // split path: main splits + 1 (the side buffer's)
  long long ml_offset;  // split path: where (max, sum) start in partials
};

struct Operands {
  const void* q;
  const void* k_pool;
  const void* k_scale;
  const void* v_pool;
  const void* v_scale;
  const void* tables;
  const void* k_side;
  const void* v_side;
  const void* side_valid;
  const void* entry_lengths;
  void* out;
  // split path: f32 [slot heads, splits, rows, 64] sums, then at
  // ml_offset [slot heads, splits, rows, 2] (running max, running sum)
  float* partials;
};

// A row sees nothing when its slot's extent is 0 and none of its side
// entries is visible.
__device__ __forceinline__ bool fully_masked(const uint8_t* side_valid,
                                             const Shape& sh, int s,
                                             int row) {
  const uint8_t* valid = side_valid + (static_cast<long long>(s) *
                                       sh.width + row % sh.width) *
                                          sh.side_len;
  for (int p = 0; p < sh.side_len; ++p)
    if (valid[p]) return false;
  return true;
}

// [0, limit): the main positions a block covers.  Past a slot's extent
// every position is masked, which changes no row that sees anything, so
// they are covered only when one of the block's rows sees nothing at
// all: that row is the uniform average over all nb * B main and P side
// positions.  Every thread of the block calls it.
__device__ int covered_positions(const void* side_valid, const Shape& sh,
                                 int s, int entry, int row0, int rows) {
  __shared__ int any_fully_masked;
  const int covered = sh.nb * sh.block_tokens;
  if (entry > 0) return min(entry, covered);
  if (threadIdx.x == 0) any_fully_masked = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    if (fully_masked(static_cast<const uint8_t*>(side_valid), sh, s,
                     row0 + r))
      any_fully_masked = 1;                 // every writer stores 1
  __syncthreads();
  return any_fully_masked ? covered : 0;
}

// == split path ============================================================

// 16-byte chunks in one 64-element row of storage type S
template <typename S>
constexpr int kChunks = kHeadDim * static_cast<int>(sizeof(S)) / 16;

// where chunk c of row j of a tile sits: XOR-swizzled, so that the eight
// lanes of a quarter warp reading chunk c of eight consecutive rows (one
// row a lane) hit eight distinct 16-byte bank groups
template <typename S>
__device__ __forceinline__ int swizzle(int chunk, int row) {
  if constexpr (sizeof(S) == 1) return chunk ^ ((row >> 1) & 3);
  else return chunk ^ (row & 7);
}

// one 16-byte chunk of S values as floats
template <typename S>
__device__ __forceinline__ void unpack(const uint4& raw, float* x) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<S, float>::value) {
      x[i] = __uint_as_float(words[i]);
    } else if constexpr (std::is_same<S, __nv_bfloat16>::value) {
      x[2 * i] = __uint_as_float(words[i] << 16);
      x[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        x[4 * i + b] = static_cast<float>(
            static_cast<int8_t>((words[i] >> (8 * b)) & 0xffu));
    }
  }
}

// two consecutive S values as floats
template <typename S>
__device__ __forceinline__ float2 load_pair(const unsigned char* p) {
  if constexpr (std::is_same<S, float>::value) {
    return *reinterpret_cast<const float2*>(p);
  } else if constexpr (std::is_same<S, __nv_bfloat16>::value) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  } else {
    const uint16_t w = *reinterpret_cast<const uint16_t*>(p);
    return make_float2(static_cast<float>(static_cast<int8_t>(w & 0xffu)),
                       static_cast<float>(static_cast<int8_t>(w >> 8)));
  }
}

// one warp's stage: K rows, V rows (in the compute type's size, the
// largest a tile holds), K scales, V scales
template <typename T>
constexpr int kSplitStage = 2 * kWarpTile * kHeadDim * sizeof(T) +
                            2 * kWarpTile * sizeof(float);

template <typename T, int kR>
constexpr int kSplitWarpBytes = kSplitStages * kSplitStage<T> +
                                kR * kWarpTile * sizeof(float);

// Lane j of the calling warp copies position j of tile t of [lo, hi)
// (main positions through the table, or side entries) into the stage at
// `base`; past hi it writes zeros.  `id`: the position's block id when
// the caller has loaded it already, else -1.
template <typename T, typename S, bool kScales>
__device__ __forceinline__ void issue_tile(const Operands& x, const Shape& sh,
                                           int h, long long slot_head,
                                           const int* table, bool side,
                                           int lo, int hi, int t,
                                           unsigned char* base, int id) {
  constexpr int C = kChunks<S>;
  constexpr int E = 16 / static_cast<int>(sizeof(S));
  constexpr int kRowsBytes = kWarpTile * kHeadDim * sizeof(T);
  const int lane = threadIdx.x % 32;
  const int p = lo + t * kWarpTile + lane;
  const bool valid = p < hi;
  long long row = 0;
  if (valid) {
    if (side) {
      row = slot_head * sh.side_len + p;
    } else {
      if (id < 0) id = __ldg(table + p / sh.block_tokens);
      row = (static_cast<long long>(id) * sh.num_kv + h) * sh.block_tokens +
            p % sh.block_tokens;
    }
  }
  const S* k_src = static_cast<const S*>(side ? x.k_side : x.k_pool) +
                   row * kHeadDim;
  const S* v_src = static_cast<const S*>(side ? x.v_side : x.v_pool) +
                   row * kHeadDim;
  unsigned char* k_dst = base + lane * C * 16;
  unsigned char* v_dst = base + kRowsBytes + lane * C * 16;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    copy16(k_dst + swizzle<S>(c, lane) * 16, k_src + c * E, valid);
    copy16(v_dst + swizzle<S>(c, lane) * 16, v_src + c * E, valid);
  }
  if constexpr (kScales) {
    float* scales = reinterpret_cast<float*>(base + 2 * kRowsBytes);
    copy4(scales + lane, static_cast<const float*>(x.k_scale) + row, valid);
    copy4(scales + kWarpTile + lane,
          static_cast<const float*>(x.v_scale) + row, valid);
  }
}

// One warp's part of a split: the 32-position tiles warp, warp + warps,
// ... of positions [lo, hi), read in storage type S (the pool's, or T for
// the side buffer) through the warp's two-stage cp.async ring (the first
// tile already issued into stage 0 by the caller), into the warp's
// running max m, sum l and accumulators acc (dims 2 lane, 2 lane + 1).
template <typename T, typename S, int kR, bool kFold, bool kDequant>
__device__ __forceinline__ void attend_range(
    const Operands& x, const Shape& sh, int s, int h, long long slot_head,
    bool side, int entry, int row0, int lo, int hi, const int* table,
    const float* q_s, unsigned char* warp_smem, float (&m)[kR],
    float (&l)[kR], float (&acc)[kR][2]) {
  constexpr int C = kChunks<S>;
  constexpr int E = 16 / static_cast<int>(sizeof(S));
  constexpr int kRowsBytes = kWarpTile * kHeadDim * sizeof(T);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const int tiles = (hi - lo + kWarpTile - 1) / kWarpTile;
  const int mine = tiles > warp ? (tiles - warp + warps - 1) / warps : 0;
  float* pbuf = reinterpret_cast<float*>(warp_smem +
                                         kSplitStages * kSplitStage<T>);
  const uint8_t* side_valid = static_cast<const uint8_t*>(x.side_valid) +
                              static_cast<long long>(s) * sh.width *
                                  sh.side_len;

  for (int i = 0; i < mine; ++i) {
    if (i + 1 < mine)
      issue_tile<T, S, kFold || kDequant>(
          x, sh, h, slot_head, table, side, lo, hi, warp + (i + 1) * warps,
          warp_smem + (i + 1) % kSplitStages * kSplitStage<T>, -1);
    commit();
    wait_pending<1>();
    __syncwarp();
    const unsigned char* base = warp_smem + (i % kSplitStages) *
                                                kSplitStage<T>;
    const unsigned char* k_tile = base;
    const unsigned char* v_tile = base + kRowsBytes;
    const float* ks = reinterpret_cast<const float*>(base + 2 * kRowsBytes);
    const float* vs = ks + kWarpTile;
    const int p0 = lo + (warp + i * warps) * kWarpTile;
    const int count = min(kWarpTile, hi - p0);
    const int p = p0 + lane;
    const bool in = lane < count;

    // scores: this lane's position against every row
    float sc[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) sc[r] = 0.f;
    float k_round = 1.f;
    if constexpr (kDequant) k_round = round_to<T>(ks[lane]);
    const unsigned char* k_row = k_tile + lane * C * 16;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          k_row + swizzle<S>(c, lane) * 16);
      float kv[E];
      unpack<S>(raw, kv);
      if constexpr (kDequant) {
#pragma unroll
        for (int e = 0; e < E; ++e) kv[e] = round_to<T>(kv[e] * k_round);
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float4* qr = reinterpret_cast<const float4*>(
            q_s + r * kHeadDim + c * E);
#pragma unroll
        for (int e4 = 0; e4 < E / 4; ++e4) {
          const float4 qq = qr[e4];
          sc[r] = fmaf(qq.x, kv[4 * e4], sc[r]);
          sc[r] = fmaf(qq.y, kv[4 * e4 + 1], sc[r]);
          sc[r] = fmaf(qq.z, kv[4 * e4 + 2], sc[r]);
          sc[r] = fmaf(qq.w, kv[4 * e4 + 3], sc[r]);
        }
      }
    }

    // fold, mask, online softmax per row; the weights go to pbuf
    const float fold_k = kFold ? ks[lane] : 1.f;
    const float fold_v = kFold ? vs[lane] : 1.f;
    const bool main_valid = p < entry;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const bool valid =
          side ? in && side_valid[((row0 + r) % sh.width) * sh.side_len +
                                  p] != 0
               : main_valid;
      const float score = !in ? -INFINITY : (valid ? sc[r] * fold_k
                                                   : kMasked);
      // finite: the tile's lane 0 is in range, so its score is >= -1e30
      const float m_new = fmaxf(m[r], warp_max(score));
      const float weight = exp2f(score - m_new);
      const float corr = exp2f(m[r] - m_new);   // 0 on the first tile
      l[r] = l[r] * corr + warp_sum(weight);
      m[r] = m_new;
      acc[r][0] *= corr;
      acc[r][1] *= corr;
      pbuf[r * kWarpTile + lane] = weight * fold_v;
    }
    __syncwarp();

    // PV: this lane's two dims; positions past the range carry weight 0
    // and zero-filled values
    constexpr int kPairBytes = 2 * static_cast<int>(sizeof(S));
    const int chunk = lane * kPairBytes / 16;
    const int within = lane * kPairBytes % 16;
    // (unrolled whole, so every index is a constant: no local memory)
#pragma unroll
    for (int t = 0; t < kWarpTile; t += 4) {
      if (t >= count) break;
      float vx[4], vy[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int row = t + u;
        const float2 pair = load_pair<S>(v_tile + row * C * 16 +
                                         swizzle<S>(chunk, row) * 16 +
                                         within);
        vx[u] = pair.x;
        vy[u] = pair.y;
        if constexpr (kDequant) {
          const float v_round = round_to<T>(vs[row]);
          vx[u] = round_to<T>(vx[u] * v_round);
          vy[u] = round_to<T>(vy[u] * v_round);
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float4 w = *reinterpret_cast<const float4*>(
            pbuf + r * kWarpTile + t);
        acc[r][0] = fmaf(w.x, vx[0], acc[r][0]);
        acc[r][0] = fmaf(w.y, vx[1], acc[r][0]);
        acc[r][0] = fmaf(w.z, vx[2], acc[r][0]);
        acc[r][0] = fmaf(w.w, vx[3], acc[r][0]);
        acc[r][1] = fmaf(w.x, vy[0], acc[r][1]);
        acc[r][1] = fmaf(w.y, vy[1], acc[r][1]);
        acc[r][1] = fmaf(w.z, vy[2], acc[r][1]);
        acc[r][1] = fmaf(w.w, vy[3], acc[r][1]);
      }
    }
    __syncwarp();                           // the next tile reuses pbuf
  }
}

// One block per (slot, KV head, tile of kR rows, split): a main split's
// positions, or (the last split) the side buffer; writes the split's
// partial (max, sum, accumulators) per row.
template <typename T, int kMode, int kR>
__global__ void __launch_bounds__(kMaxSplitWarps * 32)
paged_split_kernel(Operands x, Shape sh, float scale_log2) {
  using Pool = typename std::conditional<kMode == kNative, T, int8_t>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int warps = blockDim.x / 32;
  const int split = blockIdx.x % sh.splits;
  const int rest = blockIdx.x / sh.splits;
  const int tile = rest % sh.row_tiles;
  const int slot_head_index = rest / sh.row_tiles;
  const int s = slot_head_index / sh.num_kv;
  const int h = slot_head_index % sh.num_kv;
  const long long slot_head = slot_head_index;
  const int row0 = tile * kR;
  const int rows = min(kR, sh.rows - row0);
  const bool side = split == sh.splits - 1;
  // the merge kernel may start launching now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // Loads that depend on nothing go out together: the slot's extent, the
  // query rows (into q_raw, in T), and the table id of this lane's first
  // position (read whether or not the extent reaches it).
  const int entry = __ldg(static_cast<const int*>(x.entry_lengths) + s);
  float* q_s = reinterpret_cast<float*>(smem);
  unsigned char* q_raw = smem + kR * kHeadDim * sizeof(float);
  const T* q = static_cast<const T*>(x.q) +
               (slot_head * sh.rows + row0) * kHeadDim;
  for (int c = tid; c < kR * kChunks<T>; c += blockDim.x) {
    const bool valid = c / kChunks<T> < rows;   // rows past G*W: zeros
    copy16(q_raw + c * 16, valid ? q + c * (16 / sizeof(T)) : q, valid);
  }
  commit();
  const int* table = static_cast<const int*>(x.tables) +
                     static_cast<long long>(s) * sh.table_stride;
  const int lo = side ? 0 : split * sh.split_len;
  const int p_first = lo + warp * kWarpTile + lane;
  const int first_id = !side && p_first < sh.nb * sh.block_tokens
                           ? __ldg(table + p_first / sh.block_tokens) : -1;

  const int hi = side ? sh.side_len
                      : min(lo + sh.split_len,
                            covered_positions(x.side_valid, sh, s, entry,
                                              row0, rows));
  const long long part_row0 = (slot_head * sh.splits + split) * sh.rows +
                              row0;
  float* part_acc = x.partials + part_row0 * kHeadDim;
  float* part_ml = x.partials + sh.ml_offset + part_row0 * 2;
  if (lo >= hi) {                           // nothing here: an empty partial
    wait_pending<0>();
    for (int r = tid; r < rows; r += blockDim.x) {
      part_ml[2 * r] = -INFINITY;
      part_ml[2 * r + 1] = 0.f;
    }
    return;
  }

  // this warp's first tile into stage 0 of its ring, then the query rows
  // in f32, prescaled by scale * log2 e
  unsigned char* warp_smem = q_raw + kR * kHeadDim * sizeof(T) +
                             warp * kSplitWarpBytes<T, kR>;
  if (warp * kWarpTile < hi - lo) {
    if (side)
      issue_tile<T, T, false>(x, sh, h, slot_head, table, true, lo, hi, warp,
                              warp_smem, -1);
    else
      issue_tile<T, Pool, kMode != kNative>(x, sh, h, slot_head, table,
                                            false, lo, hi, warp, warp_smem,
                                            first_id);
  }
  commit();
  wait_pending<1>();                        // the query rows landed
  __syncthreads();
  const T* q_in = reinterpret_cast<const T*>(q_raw);
  for (int e = tid; e < kR * kHeadDim; e += blockDim.x)
    q_s[e] = to_float(q_in[e]) * scale_log2;
  __syncthreads();

  float m[kR], l[kR], acc[kR][2];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    acc[r][0] = acc[r][1] = 0.f;
  }
  if (side)
    attend_range<T, T, kR, false, false>(x, sh, s, h, slot_head, true, entry,
                                         row0, lo, hi, table, q_s, warp_smem,
                                         m, l, acc);
  else
    attend_range<T, Pool, kR, kMode == kInt8Fold, kMode == kInt8Dequant>(
        x, sh, s, h, slot_head, false, entry, row0, lo, hi, table, q_s,
        warp_smem, m, l, acc);

  // merge the warps (the rings are free now) into the split's partial
  __syncthreads();
  float* merge_acc = reinterpret_cast<float*>(q_raw);
  float* merge_ml = merge_acc + warps * kR * kHeadDim;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    merge_acc[(warp * kR + r) * kHeadDim + 2 * lane] = acc[r][0];
    merge_acc[(warp * kR + r) * kHeadDim + 2 * lane + 1] = acc[r][1];
    if (lane == 0) {
      merge_ml[(warp * kR + r) * 2] = m[r];
      merge_ml[(warp * kR + r) * 2 + 1] = l[r];
    }
  }
  __syncthreads();
  for (int e = tid; e < rows * kHeadDim; e += blockDim.x) {
    const int r = e / kHeadDim, d = e % kHeadDim;
    float top = -INFINITY;
    for (int w = 0; w < warps; ++w)
      top = fmaxf(top, merge_ml[(w * kR + r) * 2]);
    float sum = 0.f, total = 0.f;           // finite top: warp 0 had a tile
    for (int w = 0; w < warps; ++w) {
      const float mw = merge_ml[(w * kR + r) * 2];
      if (mw == -INFINITY) continue;        // a warp without a tile
      const float c = exp2f(mw - top);
      sum += c * merge_acc[(w * kR + r) * kHeadDim + d];
      total += c * merge_ml[(w * kR + r) * 2 + 1];
    }
    part_acc[r * kHeadDim + d] = sum;
    if (d == 0) {
      part_ml[2 * r] = top;
      part_ml[2 * r + 1] = total;
    }
  }
}

// One block of 64 threads per (slot, KV head, row): the row's split
// partials merged, out = sum_s 2^(m_s - M) acc_s / sum_s 2^(m_s - M) l_s.
__global__ void __launch_bounds__(kHeadDim)
paged_combine_kernel(const float* __restrict__ partials,
                     float* __restrict__ out, int rows, int splits,
                     long long ml_offset) {
  // launched early (programmatic dependent launch): wait for the split
  // kernel's grid to finish and its partials to be visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long row = blockIdx.x;         // slot_head * rows + r
  const long long first = (row / rows) * splits * rows + row % rows;
  const float* ml = partials + ml_offset;
  const int d = threadIdx.x;
  float top = -INFINITY;
  for (int sp = 0; sp < splits; ++sp)
    top = fmaxf(top, ml[(first + static_cast<long long>(sp) * rows) * 2]);
  float sum = 0.f, total = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const long long i = first + static_cast<long long>(sp) * rows;
    const float mi = ml[2 * i];
    if (mi == -INFINITY) continue;          // a split with nothing to attend
    const float c = exp2f(mi - top);
    sum += c * partials[i * kHeadDim + d];
    total += c * ml[2 * i + 1];
  }
  out[row * kHeadDim + d] = sum / total;
}

// == tensor-core path (bf16) ================================================

// One block of 8 warps per (slot, KV head, 256 rows); warp w owns rows
// 32 w .. 32 w + 31 of the tile as two m16 tiles.
template <int kMode>
__global__ void __launch_bounds__(kMmaThreads)
paged_mma_kernel(Operands x, Shape sh, float scale_log2) {
  using bf16 = __nv_bfloat16;
  constexpr bool kInt8 = kMode != kNative;
  constexpr bool kFold = kMode == kInt8Fold;
  constexpr int kRowBytes = kPitch * 2;
  constexpr int kTileBytes = kMmaTile * kRowBytes;
  constexpr int kStageBytes = 2 * kTileBytes + 2 * kMmaTile * 4;
  // stage: K rows, V rows (bf16 at the padded pitch, or int8 64-byte
  // rows), K scales, V scales; int8 tiles convert into kc / vc
  __shared__ __align__(16) unsigned char ring[kMmaStages * kStageBytes];
  __shared__ __align__(16) bf16 kc[kMmaTile * kPitch];
  __shared__ __align__(16) bf16 vc[kMmaTile * kPitch];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;    // fragment row group, column
  const int tile = blockIdx.x % sh.row_tiles;
  const int slot_head_index = blockIdx.x / sh.row_tiles;
  const int s = slot_head_index / sh.num_kv;
  const int h = slot_head_index % sh.num_kv;
  const long long slot_head = slot_head_index;
  const int row0 = tile * kMmaRows;
  const int rows = min(kMmaRows, sh.rows - row0);
  const int entry = static_cast<const int*>(x.entry_lengths)[s];
  const int limit = covered_positions(x.side_valid, sh, s, entry, row0,
                                      rows);
  const int n_main = (limit + kMmaTile - 1) / kMmaTile;
  const int n_tiles = n_main + (sh.side_len + kMmaTile - 1) / kMmaTile;
  const int* table = static_cast<const int*>(x.tables) +
                     static_cast<long long>(s) * sh.table_stride;

  // query A fragments, zero past G*W
  const bf16* qb = static_cast<const bf16*>(x.q) +
                   (slot_head * sh.rows + row0) * kHeadDim;
  uint32_t qf[2][4][4];
  const uint8_t* side_row[2][2];            // side_valid rows of mine
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int ra = warp * 32 + mt * 16 + g, rb = ra + 8;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = kk * 16 + 2 * t;
      qf[mt][kk][0] = ra < rows ? *reinterpret_cast<const uint32_t*>(
                                      qb + ra * kHeadDim + c) : 0u;
      qf[mt][kk][1] = rb < rows ? *reinterpret_cast<const uint32_t*>(
                                      qb + rb * kHeadDim + c) : 0u;
      qf[mt][kk][2] = ra < rows ? *reinterpret_cast<const uint32_t*>(
                                      qb + ra * kHeadDim + c + 8) : 0u;
      qf[mt][kk][3] = rb < rows ? *reinterpret_cast<const uint32_t*>(
                                      qb + rb * kHeadDim + c + 8) : 0u;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      side_row[mt][hh] = static_cast<const uint8_t*>(x.side_valid) +
                         (static_cast<long long>(s) * sh.width +
                          (row0 + ra + 8 * hh) % sh.width) * sh.side_len;
  }

  // tile i (main tiles first, then the side buffer's) into its stage:
  // thread tid copies part tid % 8 of position tid / 8
  auto issue = [&](int i) {
    unsigned char* stage = ring + (i % kMmaStages) * kStageBytes;
    const bool main = i < n_main;
    const int pos = tid / 8, part = tid % 8;
    const int p = (main ? i : i - n_main) * kMmaTile + pos;
    const bool valid = p < (main ? limit : sh.side_len);
    long long row = 0;
    if (valid)
      row = main ? (static_cast<long long>(__ldg(table + p / sh.block_tokens)) *
                        sh.num_kv + h) * sh.block_tokens +
                       p % sh.block_tokens
                 : slot_head * sh.side_len + p;
    if (kInt8 && main) {                    // parts 0-3: K, 4-7: V
      const int8_t* src = static_cast<const int8_t*>(
          part < 4 ? x.k_pool : x.v_pool);
      copy16(stage + (part < 4 ? 0 : kTileBytes) + pos * kHeadDim +
                 (part % 4) * 16,
             src + row * kHeadDim + (part % 4) * 16, valid);
      if (part < 2) {
        float* scales = reinterpret_cast<float*>(stage + 2 * kTileBytes);
        copy4(scales + part * kMmaTile + pos,
              static_cast<const float*>(part == 0 ? x.k_scale : x.v_scale) +
                  row,
              valid);
      }
    } else {
      const bf16* k_src = static_cast<const bf16*>(main ? x.k_pool
                                                        : x.k_side);
      const bf16* v_src = static_cast<const bf16*>(main ? x.v_pool
                                                        : x.v_side);
      copy16(stage + pos * kRowBytes + part * 16,
             k_src + row * kHeadDim + part * 8, valid);
      copy16(stage + kTileBytes + pos * kRowBytes + part * 16,
             v_src + row * kHeadDim + part * 8, valid);
    }
  };

  float acc[2][8][4];
  float m[2][2], l[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      acc[mt][dt][0] = acc[mt][dt][1] = acc[mt][dt][2] = acc[mt][dt][3] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }
  const bool active = warp * 32 < rows;

#pragma unroll
  for (int i = 0; i < kMmaStages - 1; ++i) {
    if (i < n_tiles) issue(i);
    commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    wait_pending<kMmaStages - 2>();
    __syncthreads();                        // tile i landed; i - 1 is done
    const unsigned char* stage = ring + (i % kMmaStages) * kStageBytes;
    const bool main = i < n_main;
    const float* ks = reinterpret_cast<const float*>(stage + 2 * kTileBytes);
    const float* vs = ks + kMmaTile;
    const bf16* k_tile = reinterpret_cast<const bf16*>(stage);
    const bf16* v_tile = reinterpret_cast<const bf16*>(stage + kTileBytes);
    if (kInt8 && main) {
      // int8 -> bf16: exactly (fold), or round(q * round(s)) (dequantize)
      const int pos = tid / 8, col = (tid % 8) * 8;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const uint2 raw = *reinterpret_cast<const uint2*>(
            stage + kv * kTileBytes + pos * kHeadDim + col);
        const float s_round =
            kFold ? 1.f : round_to<bf16>((kv == 0 ? ks : vs)[pos]);
        uint32_t packed[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t word = e < 2 ? raw.x : raw.y;
          const int shift = (e % 2) * 16;
          const float lo = static_cast<float>(
              static_cast<int8_t>((word >> shift) & 0xffu));
          const float hi = static_cast<float>(
              static_cast<int8_t>((word >> (shift + 8)) & 0xffu));
          packed[e] = pack_bf16(lo * s_round, hi * s_round);
        }
        *reinterpret_cast<uint4*>((kv == 0 ? kc : vc) + pos * kPitch + col) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
      __syncthreads();
      k_tile = kc;
      v_tile = vc;
    }
    // the tile kMmaStages - 1 ahead, into the stage tile i - 1 used
    if (i + kMmaStages - 1 < n_tiles) issue(i + kMmaStages - 1);
    commit();
    if (!active) continue;

    const int p0 = (main ? i : i - n_main) * kMmaTile;
    const int hi = main ? limit : sh.side_len;
    // S = Q K^T: this warp's 32 rows x 32 positions
    float sc[2][4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      sc[0][nt][0] = sc[0][nt][1] = sc[0][nt][2] = sc[0][nt][3] = 0.f;
      sc[1][nt][0] = sc[1][nt][1] = sc[1][nt][2] = sc[1][nt][3] = 0.f;
      const bf16* k_row = k_tile + (nt * 8 + g) * kPitch;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c = kk * 16 + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(k_row + c);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(k_row + c + 8);
        mma_16816(sc[0][nt], qf[0][kk], b0, b1);
        mma_16816(sc[1][nt], qf[1][kk], b0, b1);
      }
    }

    // scale into the log2 domain, fold, mask; row max
    float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const int p = p0 + col;
        const int hh = e >> 1;
        const float fold = kFold && main ? ks[col] : 1.f;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const bool valid = main ? p < entry
                                  : p < hi && side_row[mt][hh][p] != 0;
          const float v = p >= hi ? -INFINITY
                                  : (valid ? sc[mt][nt][e] * scale_log2 * fold
                                           : kMasked);
          sc[mt][nt][e] = v;
          mx[mt][hh] = fmaxf(mx[mt][hh], v);
        }
      }
    }
    float corr[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v = mx[mt][hh];
        v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, 2));
        // finite: position p0 is in range for every row, its score >= -1e30
        const float m_new = fmaxf(m[mt][hh], v);
        corr[mt][hh] = exp2f(m[mt][hh] - m_new);   // 0 on the first tile
        m[mt][hh] = m_new;
      }
    }

    // P = exp2(S - m), row sums in f32; the weights take s_v (fold)
    float rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const float fold = kFold && main ? vs[col] : 1.f;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float p = exp2f(sc[mt][nt][e] - m[mt][e >> 1]);
          rs[mt][e >> 1] += p;
          sc[mt][nt][e] = p * fold;
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v = rs[mt][hh];
        v += __shfl_xor_sync(0xffffffff, v, 1);
        v += __shfl_xor_sync(0xffffffff, v, 2);
        l[mt][hh] = l[mt][hh] * corr[mt][hh] + v;
      }
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        acc[mt][dt][0] *= corr[mt][0];
        acc[mt][dt][1] *= corr[mt][0];
        acc[mt][dt][2] *= corr[mt][1];
        acc[mt][dt][3] *= corr[mt][1];
      }
    }

    // O += P V: the score accumulators repack as A fragments in place
    const uint16_t* v_raw = reinterpret_cast<const uint16_t*>(v_tile);
#pragma unroll
    for (int kk = 0; kk < kMmaTile / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        a[mt][0] = pack_bf16(sc[mt][2 * kk][0], sc[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(sc[mt][2 * kk][2], sc[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(sc[mt][2 * kk + 1][0], sc[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(sc[mt][2 * kk + 1][2], sc[mt][2 * kk + 1][3]);
      }
      const int key = kk * 16 + 2 * t;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        const int n = dt * 8 + g;
        const uint32_t b0 = pack_raw(v_raw[key * kPitch + n],
                                     v_raw[(key + 1) * kPitch + n]);
        const uint32_t b1 = pack_raw(v_raw[(key + 8) * kPitch + n],
                                     v_raw[(key + 9) * kPitch + n]);
        mma_16816(acc[0][dt], a[0], b0, b1);
        mma_16816(acc[1][dt], a[1], b0, b1);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * 32 + mt * 16 + g + 8 * hh;
      if (r >= rows) continue;
      const float inv = 1.f / l[mt][hh];
      float* o = static_cast<float*>(x.out) +
                 (slot_head * sh.rows + row0 + r) * kHeadDim;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        *reinterpret_cast<float2*>(o + dt * 8 + 2 * t) = make_float2(
            acc[mt][dt][2 * hh] * inv, acc[mt][dt][2 * hh + 1] * inv);
    }
  }
}

// == launches ==============================================================

template <typename T, int kMode, int kR>
int launch_split(const Operands& x, long long slot_heads, const Shape& sh,
                 float scale_log2, cudaStream_t stream) {
  // two tiles a warp, so each warp's ring holds the next tile while it
  // attends this one
  const int warps = max(1, min(kMaxSplitWarps, sh.split_len /
                                                   (kSplitStages * kWarpTile)));
  const size_t smem = kR * kHeadDim * (sizeof(float) + sizeof(T)) +
                      static_cast<size_t>(warps) * kSplitWarpBytes<T, kR>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_split_kernel<T, kMode, kR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long grid = slot_heads * sh.row_tiles * sh.splits;
  const long long rows = slot_heads * sh.rows;
  if (grid > 0x7fffffffLL || rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  paged_split_kernel<T, kMode, kR>
      <<<static_cast<unsigned>(grid), warps * 32, smem, stream>>>(
          x, sh, scale_log2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the merge, launched while the split kernel runs (programmatic
  // dependent launch); it waits on the split grid before reading
  cudaLaunchAttribute early[1];
  early[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(rows));
  config.blockDim = dim3(kHeadDim);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  config.attrs = early;
  config.numAttrs = 1;
  const float* partials = x.partials;
  return static_cast<int>(cudaLaunchKernelEx(
      &config, paged_combine_kernel, partials, static_cast<float*>(x.out),
      sh.rows, sh.splits, sh.ml_offset));
}

template <int kMode>
int launch_mma(const Operands& x, long long slot_heads, const Shape& sh,
               float scale_log2, cudaStream_t stream) {
  const long long grid = slot_heads * sh.row_tiles;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  paged_mma_kernel<kMode><<<static_cast<unsigned>(grid), kMmaThreads, 0,
                            stream>>>(x, sh, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kMode>
int launch_path(int path, const Operands& x, long long slot_heads,
                const Shape& sh, float scale_log2, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (path == kTensorPath)
      return launch_mma<kMode>(x, slot_heads, sh, scale_log2, stream);
  }
  if (sh.tile_rows == 4)
    return launch_split<T, kMode, 4>(x, slot_heads, sh, scale_log2, stream);
  return launch_split<T, kMode, 16>(x, slot_heads, sh, scale_log2, stream);
}

template <typename T>
int launch_mode(int mode, int path, const Operands& x, long long slot_heads,
                const Shape& sh, float scale_log2, cudaStream_t stream) {
  switch (mode) {
    case kNative:
      return launch_path<T, kNative>(path, x, slot_heads, sh, scale_log2,
                                     stream);
    case kInt8Fold:
      return launch_path<T, kInt8Fold>(path, x, slot_heads, sh, scale_log2,
                                       stream);
    default:
      return launch_path<T, kInt8Dequant>(path, x, slot_heads, sh,
                                          scale_log2, stream);
  }
}

}  // namespace

extern "C" {

const char* aiko_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: [slots, num_kv, rows, 64]; k_side, v_side: [slots, num_kv, side_len,
// 64], of one type (bf16 when is_bf16, else f32); k_pool, v_pool: [N,
// num_kv, block_tokens, 64] of that type when mode is 0 (native), int8
// when mode is 1 (int8, scales folded) or 2 (int8, dequantized in the
// compute type), with k_scale, v_scale f32 [N, num_kv, block_tokens]
// (ignored, and may be null, in mode 0); all contiguous, the pools and
// side buffers 16-byte aligned.  tables: int32 [slots, >= nb] with row
// stride table_stride, every id in [0, N); side_valid: bool (one byte)
// [slots, width, side_len]; entry_lengths: int32 [slots]; out: f32
// [slots, num_kv, rows, 64].  rows = groups * width, any count,
// 1 <= block_tokens <= 128, nb >= 1.  The plan (ops/paged_attention.py
// kernel_plan): path 1 (tensor cores, bf16 only) with tile_rows 256, or
// path 0 (split over T) with tile_rows 4 or 16, split_len a multiple of
// 32 and main_splits = ceil(nb * block_tokens / split_len); path 0 needs
// partials, f32 scratch of slots * num_kv * (main_splits + 1) * rows * 66
// elements.  Launches on `stream` (path 0: the split kernel, then the
// kernel that merges the splits), returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape, mode or plan it does not take).
int aiko_paged_decode_attention(int is_bf16, int mode, const void* q,
                                const void* k_pool, const void* k_scale,
                                const void* v_pool, const void* v_scale,
                                const void* tables, long long table_stride,
                                const void* k_side, const void* v_side,
                                const void* side_valid,
                                const void* entry_lengths, void* out,
                                int slots, int num_kv, int rows, int width,
                                int nb, int block_tokens, int side_len,
                                int head_dim, float scale, int path,
                                int tile_rows, int split_len,
                                int main_splits, void* partials,
                                void* stream) {
  if (head_dim != kHeadDim || slots < 1 || num_kv < 1 || rows < 1 ||
      width < 1 || rows % width != 0 || nb < 1 || block_tokens < 1 ||
      block_tokens > kMaxBlockTokens || side_len < 0 || mode < kNative ||
      mode > kInt8Dequant ||
      (mode != kNative && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long covered = static_cast<long long>(nb) * block_tokens;
  if (covered > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (path == kTensorPath) {
    if (!is_bf16 || tile_rows != kMmaRows)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (path != kSplitPath || (tile_rows != 4 && tile_rows != 16) ||
             split_len < kWarpTile || split_len % kWarpTile != 0 ||
             main_splits != (covered + split_len - 1) / split_len ||
             partials == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long slot_heads = static_cast<long long>(slots) * num_kv;
  Shape sh;
  sh.num_kv = num_kv;
  sh.rows = rows;
  sh.width = width;
  sh.nb = nb;
  sh.block_tokens = block_tokens;
  sh.side_len = side_len;
  sh.table_stride = table_stride;
  sh.tile_rows = tile_rows;
  sh.row_tiles = (rows + tile_rows - 1) / tile_rows;
  sh.split_len = split_len;
  sh.splits = main_splits + 1;
  sh.ml_offset = slot_heads * sh.splits * rows * kHeadDim;
  const Operands x{q,          k_pool, k_scale, v_pool,
                   v_scale,    tables, k_side,  v_side,
                   side_valid, entry_lengths,   out,
                   static_cast<float*>(partials)};
  const float scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mode<__nv_bfloat16>(mode, path, x, slot_heads, sh,
                                      scale_log2, s);
  return launch_mode<float>(mode, path, x, slot_heads, sh, scale_log2, s);
}

}  // extern "C"
