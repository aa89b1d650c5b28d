// Paged decode attention for Hopper (sm_90a): GQA query rows of one
// (slot, KV head) attend over K/V read straight out of the serving block
// pool through the slot's block table, plus this round's side buffer.
//
// Replaces: aiko_services_tpu/ops/paged_attention.py `_paged_attn_kernel`
// (called through `paged_decode_attention`), native pools.  What it
// computes, per query row r = g * W + w of slot s and KV head h:
//   main scores  q_r . K[tables[s, j], h, t] * scale, masked to -1e30 at
//                positions j * B + t >= entry_lengths[s];
//   side scores  q_r . k_side[s, h, p] * scale, masked to -1e30 where
//                side_valid[s, w, p] is false;
//   out          softmax over the whole row (main then side) . V, in f32.
// A row whose every score is masked gets the uniform average of every
// value it covers (nb * B main positions and P side entries), exactly as
// a softmax of equal -1e30 scores does in the JAX kernel.
//
// What bounds it on an H100: device-memory bytes.  Each K and V element
// takes part in one multiply-add per query row (G * W = 4 rows in decode),
// far below the ~295 operations per byte where the tensor cores would
// become the limit.  At the Llama-1B decode shape (16 slots, 8 KV heads,
// t_cap 256, B = 32, D = 64) the K+V the slots' extents need are at most
// 8.4 MB bf16: 2.5 us at 3.35 TB/s, about what one launch costs.
//
// Design (simple first): one block of 128 threads per (slot, KV head).
// The query rows sit in shared memory in f32, prescaled by scale * log2 e
// (softmax in the exp2 domain).  The block walks the table entries that
// the slot's extent needs (every entry when one of its rows is fully
// masked), reading each K and V block once into shared memory, then the
// side buffer in chunks of B: scores per (row, position) pair, an online
// softmax per row (one warp a row: running max from -inf, rescale of the
// running sum and of the accumulators), and the PV product into f32
// accumulators held in registers.  Not yet: cp.async/TMA prefetch of the
// next block while this one is used, and a split over T for long contexts.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadDim = 64;
constexpr int kMaxRows = 64;                                 // G * W
constexpr int kMaxAcc = kMaxRows * kHeadDim / kThreads;      // per thread
constexpr int kMaxBlockTokens = 128;
constexpr int kKeyPitch = kHeadDim + 1;     // conflict-free K row reads
constexpr float kMasked = -1e30f;           // JAX's mask value
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Shape {
  int num_kv;        // KV heads
  int rows;          // query rows per (slot, head): G * W
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const T* __restrict__ k_side,
                    const T* __restrict__ v_side,
                    const uint8_t* __restrict__ side_valid,
                    const int* __restrict__ entry_lengths,
                    float* __restrict__ out, Shape sh, float scale_log2) {
  const int rows = sh.rows, B = sh.block_tokens, P = sh.side_len;
  const int s = blockIdx.x / sh.num_kv;
  const int h = blockIdx.x % sh.num_kv;
  const long long slot_head = static_cast<long long>(s) * sh.num_kv + h;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  extern __shared__ float smem[];
  float* q_s = smem;                        // [rows][64]
  float* k_s = q_s + rows * kHeadDim;       // [B][65]
  float* v_s = k_s + B * kKeyPitch;         // [B][64]
  float* p_s = v_s + B * kHeadDim;          // [rows][B] scores, then p
  float* m_s = p_s + rows * B;              // running max (log2 domain)
  float* l_s = m_s + rows;                  // running sum
  float* c_s = l_s + rows;                  // this tile's rescale factor
  __shared__ int fully_masked;

  const T* q_rows = q + slot_head * rows * kHeadDim;
  for (int e = tid; e < rows * kHeadDim; e += kThreads)
    q_s[e] = to_float(q_rows[e]) * scale_log2;
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  const int entry = entry_lengths[s];
  if (tid == 0) fully_masked = 0;
  __syncthreads();
  if (entry <= 0) {                         // uniform over the block
    for (int w = tid; w < sh.width; w += kThreads) {
      const uint8_t* valid = side_valid + (static_cast<long long>(s) *
                                           sh.width + w) * P;
      bool any = false;
      for (int p = 0; p < P; ++p) any = any || valid[p];
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

  // one tile: `count` K/V rows at positions base + [0, count)
  auto attend = [&](const T* ksrc, const T* vsrc, int count, bool in_pool,
                    int base) {
    load_rows(k_s, kKeyPitch, ksrc, count);
    load_rows(v_s, kHeadDim, vsrc, count);
    __syncthreads();
    for (int e = tid; e < rows * count; e += kThreads) {
      const int r = e / count, t = e % count;
      const float* qr = q_s + r * kHeadDim;
      const float* kt = k_s + t * kKeyPitch;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < kHeadDim; ++d) dot = fmaf(qr[d], kt[d], dot);
      const bool valid =
          in_pool ? base + t < entry
               : side_valid[(static_cast<long long>(s) * sh.width +
                             r % sh.width) * P + base + t] != 0;
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
        row[t] = p;
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
    const long long block = (static_cast<long long>(table[j]) * sh.num_kv +
                             h) * B * kHeadDim;
    attend(k_pool + block, v_pool + block, B, true, j * B);
  }
  for (int p0 = 0; p0 < P; p0 += B) {
    const long long side = (slot_head * P + p0) * kHeadDim;
    attend(k_side + side, v_side + side, min(B, P - p0), false, p0);
  }

  float* o = out + slot_head * rows * kHeadDim;
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < rows * kHeadDim) o[e] = acc[i] / l_s[e / kHeadDim];
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* k_side, const void* v_side,
           const void* side_valid, const void* entry_lengths, void* out,
           int slots, const Shape& sh, float scale_log2,
           cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(sh.rows) * kHeadDim +
       static_cast<size_t>(sh.block_tokens) * (kKeyPitch + kHeadDim) +
       static_cast<size_t>(sh.rows) * sh.block_tokens + 3 * sh.rows) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  paged_decode_kernel<T><<<slots * sh.num_kv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const T*>(k_side), static_cast<const T*>(v_side),
      static_cast<const uint8_t*>(side_valid),
      static_cast<const int*>(entry_lengths), static_cast<float*>(out), sh,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* aiko_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: [slots, num_kv, rows, 64]; k_pool, v_pool: [N, num_kv, block_tokens,
// 64]; k_side, v_side: [slots, num_kv, side_len, 64], all of one type
// (bf16 when is_bf16, else f32) and contiguous.  tables: int32 [slots,
// >= nb] with row stride table_stride, every id in [0, N); side_valid:
// bool (one byte) [slots, width, side_len]; entry_lengths: int32 [slots];
// out: f32 [slots, num_kv, rows, 64].  rows = groups * width <= 64,
// 1 <= block_tokens <= 128, nb >= 1.  Launches on `stream`, returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).
int aiko_paged_decode_attention(int is_bf16, const void* q,
                                const void* k_pool, const void* v_pool,
                                const void* tables, long long table_stride,
                                const void* k_side, const void* v_side,
                                const void* side_valid,
                                const void* entry_lengths, void* out,
                                int slots, int num_kv, int rows, int width,
                                int nb, int block_tokens, int side_len,
                                int head_dim, float scale, void* stream) {
  if (head_dim != kHeadDim || slots < 1 || num_kv < 1 || rows < 1 ||
      rows > kMaxRows || width < 1 || rows % width != 0 || nb < 1 ||
      block_tokens < 1 || block_tokens > kMaxBlockTokens || side_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  sh.num_kv = num_kv;
  sh.rows = rows;
  sh.width = width;
  sh.nb = nb;
  sh.block_tokens = block_tokens;
  sh.side_len = side_len;
  sh.table_stride = table_stride;
  const float scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, k_side, v_side,
                                 side_valid, entry_lengths, out, slots, sh,
                                 scale_log2, s);
  return launch<float>(q, k_pool, v_pool, tables, k_side, v_side,
                       side_valid, entry_lengths, out, slots, sh, scale_log2,
                       s);
}

}  // extern "C"
