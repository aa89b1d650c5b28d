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
// What bounds it on an H100: device-memory bytes.  Each K and V element
// takes part in one multiply-add per query row (G * W = 4 rows in decode),
// far below the ~295 operations per byte where the tensor cores would
// become the limit.  At the Llama-1B decode shape (16 slots, 8 KV heads,
// t_cap 256, B = 32, D = 64) the K+V the slots' extents need are at most
// 8.4 MB bf16 (4.2 MB int8 plus 0.5 MB of scales): 1.3-2.5 us at
// 3.35 TB/s, about what one launch costs.  The extend (G * W = 256 rows,
// a 64-entry side buffer) does 256 multiply-adds per K/V element: still
// below the tensor-core line.
//
// Design (simple first): one block of 128 threads per (slot, KV head,
// tile of at most 64 query rows); a tile reads the slot's blocks itself,
// so K/V are read once per tile (the extend's 256 rows: 4 times).  The
// tile's query rows sit in shared memory in f32, prescaled by
// scale * log2 e (softmax in the exp2 domain).  The block walks the table
// entries that the slot's extent needs (every entry when one of the
// tile's rows is fully masked), reading each K and V block once into
// shared memory as f32 (int8 values one byte a load; the fold scales
// beside them), then the side buffer in chunks of B: scores per
// (row, position) pair, an online softmax per row (one warp a row:
// running max from -inf, rescale of the running sum and of the
// accumulators), and the PV product into f32 accumulators held in
// registers.  Not yet: cp.async/TMA prefetch of the next block while this
// one is used, and a split over T for long contexts.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadDim = 64;
constexpr int kTileRows = 64;                                // per block
constexpr int kMaxAcc = kTileRows * kHeadDim / kThreads;     // per thread
constexpr int kMaxBlockTokens = 128;
constexpr int kKeyPitch = kHeadDim + 1;     // conflict-free K row reads
constexpr float kMasked = -1e30f;           // JAX's mask value
constexpr float kLog2e = 1.4426950408889634f;

// pool numerics (the C entry's `mode`)
constexpr int kNative = 0;
constexpr int kInt8Fold = 1;
constexpr int kInt8Dequant = 2;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

// x rounded to the compute type T (and back to f32)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Shape {
  int num_kv;        // KV heads
  int rows;          // query rows per (slot, head): G * W
  int tiles;         // row tiles per (slot, head): ceil(rows / 64)
  int width;         // W, queries per slot
  int nb;            // table entries per slot
  int block_tokens;  // B
  int side_len;      // P
  long long table_stride;
};

// `count` rows of kHeadDim contiguous elements → shared f32 rows at `pitch`
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int pitch,
                                          const T* __restrict__ src,
                                          int count) {
  for (int e = threadIdx.x; e < count * kHeadDim; e += kThreads)
    dst[(e / kHeadDim) * pitch + e % kHeadDim] = to_float(src[e]);
}

// one pool block of int8 rows dequantized in the compute type T:
// round(q * round(s)), the product JAX's dequantize_kv_cache forms
template <typename T>
__device__ __forceinline__ void load_dequantized(float* dst, int pitch,
                                                 const int8_t* __restrict__ src,
                                                 const float* __restrict__ s,
                                                 int count) {
  for (int e = threadIdx.x; e < count * kHeadDim; e += kThreads) {
    const int t = e / kHeadDim;
    dst[t * pitch + e % kHeadDim] =
        round_to<T>(to_float(src[e]) * round_to<T>(s[t]));
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const void* __restrict__ k_data,
                    const float* __restrict__ k_scale,
                    const void* __restrict__ v_data,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const T* __restrict__ k_side,
                    const T* __restrict__ v_side,
                    const uint8_t* __restrict__ side_valid,
                    const int* __restrict__ entry_lengths,
                    float* __restrict__ out, Shape sh, float scale_log2) {
  using Pool = typename std::conditional<kMode == kNative, T, int8_t>::type;
  const Pool* k_pool = static_cast<const Pool*>(k_data);
  const Pool* v_pool = static_cast<const Pool*>(v_data);
  const int B = sh.block_tokens, P = sh.side_len;
  const int tile = blockIdx.x % sh.tiles;
  const int slot_head_index = blockIdx.x / sh.tiles;
  const int s = slot_head_index / sh.num_kv;
  const int h = slot_head_index % sh.num_kv;
  const long long slot_head = static_cast<long long>(s) * sh.num_kv + h;
  const int row0 = tile * kTileRows;                  // first absolute row
  const int rows = min(kTileRows, sh.rows - row0);    // this tile's rows
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  extern __shared__ float smem[];
  float* q_s = smem;                        // [rows][64]
  float* k_s = q_s + rows * kHeadDim;       // [B][65]
  float* v_s = k_s + B * kKeyPitch;         // [B][64]
  float* p_s = v_s + B * kHeadDim;          // [rows][B] scores, then p
  float* m_s = p_s + rows * B;              // running max (log2 domain)
  float* l_s = m_s + rows;                  // running sum
  float* c_s = l_s + rows;                  // this tile's rescale factor
  float* ks_s = c_s + rows;                 // [B] fold: K scales
  float* vs_s = ks_s + B;                   // [B] fold: V scales
  __shared__ int fully_masked;

  const long long q_offset = (slot_head * sh.rows + row0) * kHeadDim;
  for (int e = tid; e < rows * kHeadDim; e += kThreads)
    q_s[e] = to_float(q[q_offset + e]) * scale_log2;
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  const int entry = entry_lengths[s];
  if (tid == 0) fully_masked = 0;
  __syncthreads();
  if (entry <= 0) {                         // uniform over the block
    for (int r = tid; r < rows; r += kThreads) {
      const int w = (row0 + r) % sh.width;
      const uint8_t* valid = side_valid + (static_cast<long long>(s) *
                                           sh.width + w) * P;
      bool any = false;
      for (int p = 0; p < P && !any; ++p) any = valid[p] != 0;
      if (!any) fully_masked = 1;           // every writer stores 1
    }
    __syncthreads();
  }
  // blocks past the extent hold masked positions only: they change no
  // row that sees anything, so they are read only for a fully masked one
  const int needed = entry > 0 ? (entry + B - 1) / B : 0;
  const int nblocks = fully_masked ? sh.nb : min(sh.nb, needed);

  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  // one tile of K/V rows, already in k_s / v_s (and, folding, their
  // scales in ks_s / vs_s): `count` positions at base + [0, count)
  auto attend = [&](int count, bool in_pool, int base) {
    const bool fold = kMode == kInt8Fold && in_pool;
    for (int e = tid; e < rows * count; e += kThreads) {
      const int r = e / count, t = e % count;
      const float* qr = q_s + r * kHeadDim;
      const float* kt = k_s + t * kKeyPitch;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < kHeadDim; ++d) dot = fmaf(qr[d], kt[d], dot);
      if (fold) dot *= ks_s[t];
      const bool valid =
          in_pool ? base + t < entry
               : side_valid[(static_cast<long long>(s) * sh.width +
                             (row0 + r) % sh.width) * P + base + t] != 0;
      p_s[r * B + t] = valid ? dot : kMasked;
    }
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      float* row = p_s + r * B;
      float tile_max = -INFINITY;
      for (int t = lane; t < count; t += 32) tile_max = fmaxf(tile_max, row[t]);
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1)
        tile_max = fmaxf(tile_max,
                         __shfl_xor_sync(0xffffffff, tile_max, offset));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, tile_max);   // finite: >= kMasked
      float sum = 0.f;
      for (int t = lane; t < count; t += 32) {
        const float p = exp2f(row[t] - m_new);
        row[t] = fold ? p * vs_s[t] : p;            // the weight * s_v
        sum += p;
      }
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1)
        sum += __shfl_xor_sync(0xffffffff, sum, offset);
      if (lane == 0) {
        const float corr = exp2f(m_old - m_new);    // 0 on the first tile
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int e = tid + i * kThreads;
      if (e < rows * kHeadDim) {
        const int r = e / kHeadDim, d = e % kHeadDim;
        const float* pr = p_s + r * B;
        float a = acc[i] * c_s[r];
        for (int t = 0; t < count; ++t) a = fmaf(pr[t], v_s[t * kHeadDim + d], a);
        acc[i] = a;
      }
    }
    __syncthreads();                        // the next tile reuses smem
  };

  const int* table = tables + static_cast<long long>(s) * sh.table_stride;
  for (int j = 0; j < nblocks; ++j) {
    const long long block = static_cast<long long>(table[j]) * sh.num_kv + h;
    const Pool* k_block = k_pool + block * B * kHeadDim;
    const Pool* v_block = v_pool + block * B * kHeadDim;
    if constexpr (kMode == kInt8Dequant) {
      load_dequantized<T>(k_s, kKeyPitch, k_block, k_scale + block * B, B);
      load_dequantized<T>(v_s, kHeadDim, v_block, v_scale + block * B, B);
    } else {
      load_rows(k_s, kKeyPitch, k_block, B);
      load_rows(v_s, kHeadDim, v_block, B);
      if constexpr (kMode == kInt8Fold) {
        for (int t = tid; t < B; t += kThreads) {
          ks_s[t] = k_scale[block * B + t];
          vs_s[t] = v_scale[block * B + t];
        }
      }
    }
    __syncthreads();
    attend(B, true, j * B);
  }
  for (int p0 = 0; p0 < P; p0 += B) {
    const long long side = (slot_head * P + p0) * kHeadDim;
    const int count = min(B, P - p0);
    load_rows(k_s, kKeyPitch, k_side + side, count);
    load_rows(v_s, kHeadDim, v_side + side, count);
    __syncthreads();
    attend(count, false, p0);
  }

  float* o = out + q_offset;
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < rows * kHeadDim) o[e] = acc[i] / l_s[e / kHeadDim];
  }
}

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
};

template <typename T, int kMode>
int launch(const Operands& x, int slots, const Shape& sh, float scale_log2,
           cudaStream_t stream) {
  const size_t rows = static_cast<size_t>(min(sh.rows, kTileRows));
  const size_t block = static_cast<size_t>(sh.block_tokens);
  const size_t smem = (rows * kHeadDim + block * (kKeyPitch + kHeadDim) +
                       rows * block + 3 * rows + 2 * block) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, kMode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long grid = static_cast<long long>(slots) * sh.num_kv * sh.tiles;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  paged_decode_kernel<T, kMode><<<static_cast<unsigned>(grid), kThreads,
                                  smem, stream>>>(
      static_cast<const T*>(x.q), x.k_pool,
      static_cast<const float*>(x.k_scale), x.v_pool,
      static_cast<const float*>(x.v_scale),
      static_cast<const int*>(x.tables), static_cast<const T*>(x.k_side),
      static_cast<const T*>(x.v_side),
      static_cast<const uint8_t*>(x.side_valid),
      static_cast<const int*>(x.entry_lengths), static_cast<float*>(x.out),
      sh, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mode(int mode, const Operands& x, int slots, const Shape& sh,
                float scale_log2, cudaStream_t stream) {
  switch (mode) {
    case kNative:
      return launch<T, kNative>(x, slots, sh, scale_log2, stream);
    case kInt8Fold:
      return launch<T, kInt8Fold>(x, slots, sh, scale_log2, stream);
    default:
      return launch<T, kInt8Dequant>(x, slots, sh, scale_log2, stream);
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
// (ignored, and may be null, in mode 0); all contiguous.  tables: int32
// [slots, >= nb] with row stride table_stride, every id in [0, N);
// side_valid: bool (one byte) [slots, width, side_len]; entry_lengths:
// int32 [slots]; out: f32 [slots, num_kv, rows, 64].  rows = groups *
// width, any count (tiled 64 at a time), 1 <= block_tokens <= 128,
// nb >= 1.  Launches on `stream`, returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape or mode it does not take).
int aiko_paged_decode_attention(int is_bf16, int mode, const void* q,
                                const void* k_pool, const void* k_scale,
                                const void* v_pool, const void* v_scale,
                                const void* tables, long long table_stride,
                                const void* k_side, const void* v_side,
                                const void* side_valid,
                                const void* entry_lengths, void* out,
                                int slots, int num_kv, int rows, int width,
                                int nb, int block_tokens, int side_len,
                                int head_dim, float scale, void* stream) {
  if (head_dim != kHeadDim || slots < 1 || num_kv < 1 || rows < 1 ||
      width < 1 || rows % width != 0 || nb < 1 || block_tokens < 1 ||
      block_tokens > kMaxBlockTokens || side_len < 0 || mode < kNative ||
      mode > kInt8Dequant ||
      (mode != kNative && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  sh.num_kv = num_kv;
  sh.rows = rows;
  sh.tiles = (rows + kTileRows - 1) / kTileRows;
  sh.width = width;
  sh.nb = nb;
  sh.block_tokens = block_tokens;
  sh.side_len = side_len;
  sh.table_stride = table_stride;
  const Operands x{q,      k_pool, k_scale,    v_pool,        v_scale, tables,
                   k_side, v_side, side_valid, entry_lengths, out};
  const float scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mode<__nv_bfloat16>(mode, x, slots, sh, scale_log2, s);
  return launch_mode<float>(mode, x, slots, sh, scale_log2, s);
}

}  // extern "C"
