// Flash attention for Hopper (sm_90a), bf16 in and out, f32 softmax.
//
// Replaces: aiko_services_tpu/ops/attention.py `_flash_kernel` (called
// through `flash_attention`), the Pallas kernel that runs the Whisper
// encoder's self-attention once the audio context reaches 1024 positions.
//
// What bounds it on an H100: the two products.  At the Whisper-small
// serving shape (B*H = 96, S = 1536, D = 64) the kernel does
// 4*96*1536^2*64 = 5.8e10 FLOP against 75 MB of q/k/v/o traffic, i.e.
// ~770 FLOP per byte, far above the card's ~295 bf16 FLOP/byte ridge:
// it is compute-bound, and the S x S score matrix must never reach
// device memory.
//
// Design: one thread block of 4 warps per (batch*head, 64-row q tile).
// Each warp owns 16 query rows.  The block walks the K/V sequence in
// 64-row tiles staged in shared memory (rows padded by 8 bf16 so the
// fragment loads are free of bank conflicts).  Both products run on the
// tensor cores with mma.sync m16n8k16 (bf16 operands, f32 accumulators).
// The score fragment of QK^T has exactly the register layout of the A
// operand of PV, so the probabilities never leave registers: the running
// max, the running sum and the output accumulator stay in f32 registers
// for the whole sweep (the TPU kernel's VMEM scratch).  Scores are kept
// in the log2 domain (scale * log2 e folded in) so the exponentials are
// exp2f.  Causal runs skip the K tiles above the diagonal and mask the
// diagonal tile.  A row whose every key is masked keeps l == 0 and is
// written as 0 (the reference's l == 0 guard).
//
// Simple first: no cp.async / TMA pipelining and no wgmma yet; a later
// change can overlap the tile loads with the products.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // 4 warps x 16 rows
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr int kPad = 8;       // bf16 elements of padding per smem row

struct Strides {              // element strides (batch, head, sequence)
  long long q[3], k[3], v[3], o[3];
};

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

// copy a [64, D] bf16 tile (row stride `stride` elements) into smem
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[D + kPad],
                                          const __nv_bfloat16* src,
                                          long long stride) {
  constexpr int kChunks = D / 8;             // 16-byte chunks per row
  for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
    const int row = i / kChunks;
    const int chunk = i % kChunks;
    *reinterpret_cast<uint4*>(&dst[row][chunk * 8]) =
        *reinterpret_cast<const uint4*>(src + row * stride + chunk * 8);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int heads, int seq,
                       Strides st, float scale_log2, int causal) {
  __shared__ __align__(16) __nv_bfloat16 sk[kBlockK][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 sv[kBlockK][D + kPad];

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;                   // fragment row group
  const int t = lane & 3;                    // thread within the group

  const __nv_bfloat16* qb = q + b * st.q[0] + h * st.q[1];
  const __nv_bfloat16* kb = k + b * st.k[0] + h * st.k[1];
  const __nv_bfloat16* vb = v + b * st.v[0] + h * st.v[1];
  __nv_bfloat16* ob = o + b * st.o[0] + h * st.o[1];

  // Q tile through smem (the K buffer) into A fragments held all sweep
  load_tile<D>(sk, qb + q0 * st.q[2], st.q[2]);
  __syncthreads();
  uint32_t qf[D / 16][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(&sk[r0][c]);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(&sk[r0 + 8][c]);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(&sk[r0][c + 8]);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(&sk[r0 + 8][c + 8]);
  }
  __syncthreads();

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};       // rows g and g + 8
  float l[2] = {0.f, 0.f};
  const int row_pos[2] = {q0 + r0, q0 + r0 + 8};

  // causal: K tiles strictly above the diagonal are skipped
  const int kv_tiles = causal ? blockIdx.x + 1 : seq / kBlockK;
  const uint16_t* sv_raw = reinterpret_cast<const uint16_t*>(&sv[0][0]);

  for (int kt = 0; kt < kv_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    load_tile<D>(sk, kb + k0 * st.k[2], st.k[2]);
    load_tile<D>(sv, vb + k0 * st.v[2], st.v[2]);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const int n = nt * 8 + g;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&sk[n][c]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&sk[n][c + 8]);
        mma_16816(s[nt], qf[kk], b0, b1);
      }
    }

    // scale into the log2 domain, mask, row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        float x = s[nt][i] * scale_log2;
        if (causal && k0 + nt * 8 + 2 * t + (i & 1) > row_pos[r])
          x = -INFINITY;
        s[nt][i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float m_safe[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_safe[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = m[r] == -INFINITY ? 0.f : exp2f(m[r] - m_safe[r]);
      m[r] = m_new;
    }

    // P = exp2(S - m), row sums in f32
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float p =
            s[nt][i] == -INFINITY ? 0.f : exp2f(s[nt][i] - m_safe[r]);
        s[nt][i] = p;
        rs[r] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffff, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffff, rs[r], 2);
      l[r] = l[r] * corr[r] + rs[r];
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // O += P V: the score accumulators repack as A fragments in place
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = kk * 16 + 2 * t;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int n = dt * 8 + g;
        const uint32_t b0 = pack_raw(sv_raw[key * (D + kPad) + n],
                                     sv_raw[(key + 1) * (D + kPad) + n]);
        const uint32_t b1 = pack_raw(sv_raw[(key + 8) * (D + kPad) + n],
                                     sv_raw[(key + 9) * (D + kPad) + n]);
        mma_16816(acc[dt], a, b0, b1);
      }
    }
    __syncthreads();
  }

  const float inv0 = 1.f / (l[0] == 0.f ? 1.f : l[0]);
  const float inv1 = 1.f / (l[1] == 0.f ? 1.f : l[1]);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(ob + row_pos[0] * st.o[2] + col) =
        pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    *reinterpret_cast<uint32_t*>(ob + row_pos[1] * st.o[2] + col) =
        pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

}  // namespace

extern "C" {

const char* aiko_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, o: bf16 [batch, heads, seq, 64] with unit stride on the last
// axis (64 is the head dim of every Whisper size).  strides: 12 element
// strides, (batch, head, seq) for q, k, v and o in that order.  Launches
// on `stream` and returns cudaGetLastError().
int aiko_flash_attention_bf16(const void* q, const void* k, const void* v,
                              void* o, int batch, int heads, int seq,
                              int head_dim, const long long* strides,
                              float scale, int causal, void* stream) {
  if (seq % kBlockQ != 0 || batch * heads > 65535 || batch * heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  const dim3 grid(seq / kBlockQ, batch * heads);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_kernel<64><<<grid, kThreads, 0, s>>>(
      qp, kp, vp, op, heads, seq, st, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
