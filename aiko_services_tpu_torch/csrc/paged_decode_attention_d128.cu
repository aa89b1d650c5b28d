// Paged decode attention for Hopper (sm_90a) in bf16 at head dim 128
// (Llama-3-8B).
//
// Replaces: aiko_services_tpu/ops/paged_attention.py `_paged_attn_kernel`
// (called through `paged_decode_attention`) for bf16 operands at head
// dim 128.  The kernels, their design and what bounds them are in
// paged_decode_attention.cuh; this source instantiates them for its type
// and head dim and exports the C entry (ops/paged_attention.py picks the
// library by both).

#include "paged_decode_attention.cuh"

extern "C" {

const char* aiko_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// paged_decode_attention_entry (paged_decode_attention.cuh) takes
// is_bf16 1 and head_dim 128 only
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
  return paged_decode_attention_entry<__nv_bfloat16, 128>(
      is_bf16, mode, q, k_pool, k_scale, v_pool, v_scale, tables,
      table_stride, k_side, v_side, side_valid, entry_lengths, out, slots,
      num_kv, rows, width, nb, block_tokens, side_len, head_dim, scale, path,
      tile_rows, split_len, main_splits, partials, stream);
}

}  // extern "C"
