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
// 11.3 us at 3.35 TB/s while the arithmetic is negligible.  To come near
// that rate every SM needs its share of the loads in flight at once.
//
// Design: split T across blocks, then merge.
// - One block of 128 threads per (batch, head, split), as many splits as
//   make one wave of 6 blocks on every SM (ops/attention.py
//   `cross_decode_plan`, from host-known shapes): 768 blocks of 192
//   positions at the decode shape, all resident at once.
// - 8 neighbouring lanes share one key row (8 lanes x 8 bf16 = one
//   128-byte row), so each group of 8 reads whole rows and a warp reads
//   4 neighbouring rows.  A group takes every 16th row of its split, 4
//   rows a step: the 8 16-byte K and V loads of a step go out before the
//   first is used (up to 128 bytes in flight a lane, ~96 KB an SM).
// - Per group an online softmax in f32 (the step's scores reduced over
//   the 8 lanes with shuffles, one rescale a step), the groups merged in
//   shared memory into the split's f32 partial (max, sum, weighted sum of
//   values) in a scratch buffer the wrapper allocates.
// - A second kernel, launched from the same C entry as a programmatic
//   dependent launch (resident early, `griddepcontrol.wait` before it
//   reads), merges the splits of each (batch, head): nothing to zero
//   between calls.  Positions past T are never read, which is what the
//   TPU kernel's mask of its 128-padding does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kThreads = 128;
// resident on an SM (<= 80 registers a thread); ops/attention.py
// _CROSS_BLOCKS_PER_SM sizes the wave to it
constexpr int kMinBlocks = 6;
constexpr int kLanes = kHeadDim / 8;       // lanes sharing one key row
constexpr int kGroups = kThreads / kLanes; // key rows a block takes at once
constexpr int kUnroll = 4;                // rows a group loads at once

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

// One block per (batch*head, split): the split's partial.  Group g (8
// lanes) takes rows g, g + 32, ... of the split, so a warp's 4 groups
// read 4 neighbouring 128-byte rows; each lane holds 8 values of D.
// partials: [bh * splits + split] x 64 weighted sums, then at ml_offset
// the (max, sum) pairs, max in the log2 domain.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cross_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   float* __restrict__ partials, long long ml_offset,
                   int heads, int t_len, int split_len, int splits,
                   Strides st, float scale_log2) {
  __shared__ float group_acc[kGroups][kHeadDim];
  __shared__ float group_ml[kGroups][2];

  // the merge may launch now; it waits for this grid before reading
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const long long part = blockIdx.x;
  const int bh = blockIdx.x / splits, sp = blockIdx.x % splits;
  const int b = bh / heads, h = bh % heads;
  const int lo = sp * split_len;
  const int n = min(split_len, t_len - lo);               // >= 1
  const int group = threadIdx.x / kLanes, sub = threadIdx.x % kLanes;

  const __nv_bfloat16* kb =
      k + b * st.k[0] + h * st.k[1] + lo * st.k[2] + sub * 8;
  const __nv_bfloat16* vb =
      v + b * st.v[0] + h * st.v[1] + lo * st.v[2] + sub * 8;
  float qv[8];
  unpack8(*reinterpret_cast<const uint4*>(q + b * st.q[0] + h * st.q[1] +
                                          sub * 8), qv);
#pragma unroll
  for (int i = 0; i < 8; ++i) qv[i] *= scale_log2;

  // online softmax over the group's rows, kUnroll rows a step: all their
  // K and V loads go out before the first is used.  The loop bound is
  // uniform over the block, so every lane reaches the shuffles.
  float m = -INFINITY, l = 0.f;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int base = 0; base < n; base += kGroups * kUnroll) {
    uint4 kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * kGroups + group;
      if (t < n) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + t * st.k[2]));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + t * st.v[2]));
      }
    }
    float score[kUnroll];
    float top = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool valid = base + u * kGroups + group < n;
      float dot = 0.f;
      if (valid) {
        float kv[8];
        unpack8(kr[u], kv);
#pragma unroll
        for (int i = 0; i < 8; ++i) dot = fmaf(qv[i], kv[i], dot);
      }
#pragma unroll
      for (int offset = kLanes / 2; offset > 0; offset >>= 1)
        dot += __shfl_xor_sync(0xffffffff, dot, offset);
      score[u] = valid ? dot : -INFINITY;
      top = fmaxf(top, score[u]);
    }
    const float safe = top == -INFINITY ? 0.f : top;   // no row yet: 0
    const float corr = exp2f(m - safe);
    m = top;
    l *= corr;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] *= corr;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (score[u] == -INFINITY) continue;
      const float p = exp2f(score[u] - safe);
      float vv[8];
      unpack8(vr[u], vv);
      l += p;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, vv[i], acc[i]);
    }
  }

  // the block's groups merged into the split's partial
#pragma unroll
  for (int i = 0; i < 8; ++i) group_acc[group][sub * 8 + i] = acc[i];
  if (sub == 0) {
    group_ml[group][0] = m;
    group_ml[group][1] = l;
  }
  __syncthreads();
  if (threadIdx.x < kHeadDim) {
    float top = -INFINITY;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) top = fmaxf(top, group_ml[gi][0]);
    float sum = 0.f, total = 0.f;         // n >= 1: top is finite
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      const float c = exp2f(group_ml[gi][0] - top);   // no row: 0
      sum += c * group_acc[gi][threadIdx.x];
      total += c * group_ml[gi][1];
    }
    partials[part * kHeadDim + threadIdx.x] = sum;
    if (threadIdx.x == 0) {
      partials[ml_offset + 2 * part] = top;
      partials[ml_offset + 2 * part + 1] = total;
    }
  }
}

// One block of 64 threads per (batch, head): its splits merged,
// out = sum_s 2^(m_s - M) acc_s / sum_s 2^(m_s - M) l_s.
__global__ void __launch_bounds__(kHeadDim)
cross_merge_kernel(const float* __restrict__ partials, long long ml_offset,
                   __nv_bfloat16* __restrict__ o, int heads, int splits,
                   Strides st) {
  // launched early (programmatic dependent launch): wait for the split
  // kernel's grid to finish and its partials to be visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long first = static_cast<long long>(blockIdx.x) * splits;
  const float* ml = partials + ml_offset;
  const int d = threadIdx.x;
  float top = -INFINITY;
  for (int sp = 0; sp < splits; ++sp) top = fmaxf(top, ml[2 * (first + sp)]);
  float sum = 0.f, total = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const long long i = first + sp;
    const float c = exp2f(ml[2 * i] - top);   // every split holds a key
    sum += c * partials[i * kHeadDim + d];
    total += c * ml[2 * i + 1];
  }
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  o[b * st.o[0] + h * st.o[1] + d] = __float2bfloat16(sum / total);
}

}  // namespace

extern "C" {

const char* aiko_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, o: bf16 [batch, heads, 1, 64]; k, v: bf16 [batch, heads, t_len, 64];
// unit stride on the last axis (64: the head dim of every Whisper size),
// 16-byte aligned rows.  strides: 10 element strides, q (batch, head),
// k (batch, head, position), v (batch, head, position), o (batch, head).
// split_len and splits = ceil(t_len / split_len) come from
// ops/attention.py cross_decode_plan; partials: f32
// scratch of batch * heads * splits * 66.  Launches the split kernel and
// the merge kernel on `stream`, returns cudaGetLastError().
int aiko_cross_decode_attention_bf16(const void* q, const void* k,
                                     const void* v, void* o, void* partials,
                                     int batch, int heads, int t_len,
                                     int head_dim, int split_len, int splits,
                                     const long long* strides, float scale,
                                     void* stream) {
  if (t_len < 1 || batch < 1 || heads < 1 || head_dim != kHeadDim ||
      split_len < 1 || splits != (t_len + split_len - 1) / split_len)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bh = static_cast<long long>(batch) * heads;
  if (bh * splits > 0x7fffffffLL)
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
  float* scratch = static_cast<float*>(partials);
  const long long ml_offset = bh * splits * kHeadDim;
  cross_split_kernel<<<static_cast<unsigned>(bh * splits), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), scratch, ml_offset, heads, t_len,
      split_len, splits, st, scale_log2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the merge, launched while the split kernel runs (programmatic
  // dependent launch); it waits on the split grid before reading
  cudaLaunchAttribute early[1];
  early[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(bh));
  config.blockDim = dim3(kHeadDim);
  config.dynamicSmemBytes = 0;
  config.stream = s;
  config.attrs = early;
  config.numAttrs = 1;
  const float* merged = scratch;
  return static_cast<int>(cudaLaunchKernelEx(
      &config, cross_merge_kernel, merged, ml_offset,
      static_cast<__nv_bfloat16*>(o), heads, splits, st));
}

}  // extern "C"
