// Decode-time cross attention for Hopper (sm_90a): one query row per
// (batch, head) against a precomputed, read-only K/V, bf16 in and out.
//
// Replaces: aiko_services_tpu/ops/attention.py `_cross_decode_kernel`
// (called through `cross_decode_attention`).  As in the JAX package the
// kernel is kept beside its plain version but not dispatched: the
// Whisper decode tail runs layers.mha's einsum branch.
//
// What bounds it on an H100: device-memory bytes.  Each K and V byte is
// used in one multiply-add, so at the Whisper-small decode shape
// (B = 8, H = 12, T = 1536, D = 64) the 37.7 MB of K+V take at least
// 11.3 us at 3.35 TB/s while the arithmetic is negligible.
//
// Design: one block of 256 threads per (batch, head) streams that head's
// K and V exactly once with 16-byte loads.  D/8 neighbouring lanes share
// one key row (for D = 64: 8 lanes x 8 bf16 = one 128-byte row), so each
// warp reads whole rows and the per-key dot product reduces with
// shuffles.  The T scores stay in shared memory (plain, not online,
// softmax: T fits, as it fitted VMEM on the TPU); the max, the
// exponent sum and the PV product run in f32, and the per-group partial
// outputs reduce through shared memory.  Positions past T are never
// read, which is what the TPU kernel's mask of its 128-padding does.
//
// Simple first: one block per head leaves some SMs idle at B*H = 96; a
// split over T with a second combining pass is the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Strides {              // element strides
  long long q[2];             // (batch, head)
  long long k[3], v[3];       // (batch, head, position)
  long long o[2];             // (batch, head)
};

__device__ __forceinline__ void unpack8(const uint4& raw, float (&out)[8]) {
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct SumOp {
  __device__ float operator()(float a, float b) const { return a + b; }
};

template <typename Op>
__device__ float block_reduce(float value, float* scratch, Op op) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    value = op(value, __shfl_xor_sync(0xffffffff, value, offset));
  if (lane == 0) scratch[warp] = value;
  __syncthreads();
  value = scratch[0];
  for (int i = 1; i < kThreads / 32; ++i) value = op(value, scratch[i]);
  __syncthreads();                         // scratch is reused
  return value;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
cross_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int heads, int t_len,
                    Strides st, float scale_log2) {
  constexpr int kLanes = D / 8;            // lanes sharing one key row
  constexpr int kGroups = kThreads / kLanes;
  extern __shared__ float smem[];
  float* scores = smem;                    // [t_len]
  float* partial = smem + t_len;           // [kGroups][D]
  __shared__ float scratch[kThreads / 32];

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int group = threadIdx.x / kLanes;
  const int sub = threadIdx.x % kLanes;

  const __nv_bfloat16* kb = k + b * st.k[0] + h * st.k[1] + sub * 8;
  const __nv_bfloat16* vb = v + b * st.v[0] + h * st.v[1] + sub * 8;
  float qv[8];
  unpack8(*reinterpret_cast<const uint4*>(
              q + b * st.q[0] + h * st.q[1] + sub * 8), qv);
#pragma unroll
  for (int i = 0; i < 8; ++i) qv[i] *= scale_log2;

  // scores (log2 domain) and their max; the loop bound is uniform over
  // the block, so every lane of a warp reaches the shuffles, and lanes
  // past t_len contribute nothing
  float local_max = -INFINITY;
  for (int base = 0; base < t_len; base += kGroups) {
    const int t = base + group;
    const bool valid = t < t_len;
    float dot = 0.f;
    if (valid) {
      float kv[8];
      unpack8(*reinterpret_cast<const uint4*>(kb + t * st.k[2]), kv);
#pragma unroll
      for (int i = 0; i < 8; ++i) dot = fmaf(qv[i], kv[i], dot);
    }
#pragma unroll
    for (int offset = kLanes / 2; offset > 0; offset >>= 1)
      dot += __shfl_xor_sync(0xffffffff, dot, offset);
    if (valid) {
      if (sub == 0) scores[t] = dot;
      local_max = fmaxf(local_max, dot);
    }
  }
  const float m = block_reduce(local_max, scratch, MaxOp());

  // t_len >= 1, so m is finite
  float local_sum = 0.f;
  for (int t = threadIdx.x; t < t_len; t += kThreads) {
    const float p = exp2f(scores[t] - m);
    scores[t] = p;
    local_sum += p;
  }
  const float l = block_reduce(local_sum, scratch, SumOp());

  // PV: each group sums its keys, then the groups reduce in smem
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int t = group; t < t_len; t += kGroups) {
    float vv[8];
    unpack8(*reinterpret_cast<const uint4*>(vb + t * st.v[2]), vv);
    const float p = scores[t];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, vv[i], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) partial[group * D + sub * 8 + i] = acc[i];
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float sum = 0.f;
    for (int gi = 0; gi < kGroups; ++gi) sum += partial[gi * D + d];
    o[b * st.o[0] + h * st.o[1] + d] = __float2bfloat16(sum / l);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int heads, int t_len, const Strides& st, float scale_log2,
           cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(t_len) + (kThreads / (D / 8)) * D) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cross_decode_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cross_decode_kernel<D><<<batch * heads, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      heads, t_len, st, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* aiko_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, o: bf16 [batch, heads, 1, 64]; k, v: bf16 [batch, heads, t_len, 64];
// unit stride on the last axis (64: the head dim of every Whisper size).
// strides: 10 element strides, q (batch, head), k (batch, head,
// position), v (batch, head, position), o (batch, head).  Launches on
// `stream`, returns cudaGetLastError().
int aiko_cross_decode_attention_bf16(const void* q, const void* k,
                                     const void* v, void* o, int batch,
                                     int heads, int t_len, int head_dim,
                                     const long long* strides, float scale,
                                     void* stream) {
  if (t_len < 1 || batch * heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  st.q[0] = strides[0];
  st.q[1] = strides[1];
  for (int i = 0; i < 3; ++i) {
    st.k[i] = strides[2 + i];
    st.v[i] = strides[5 + i];
  }
  st.o[0] = strides[8];
  st.o[1] = strides[9];
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  return launch<64>(q, k, v, o, batch, heads, t_len, st, scale_log2, s);
}

}  // extern "C"
