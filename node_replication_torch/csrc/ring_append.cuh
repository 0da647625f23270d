// The fused combiner round's ring append, shared by the fused kernels
// (hashmap_replay.cu, vspace_replay.cu).
//
// The TPU kernels copy two pre-blended ring row spans by DMA because
// Mosaic cannot index the lane axis dynamically. A CUDA thread can store
// to any slot, so here every thread of the grid takes ring slots s in a
// grid-stride pass and writes out[s] = batch[d] when
// d = (s - tail) & mask < count, else out[s] = in[s]: each slot written
// once, one launch per round. `tail` is read from its device scalar, so
// a round needs no host sync.

#pragma once

#include <stdint.h>

__device__ __forceinline__ void ring_append_pass(
    int64_t gtid, int64_t gstride, const int64_t* __restrict__ tail_ptr,
    int count, int cap, int arg_w, const int32_t* __restrict__ batch_opc,
    const int32_t* __restrict__ batch_args,
    const int32_t* __restrict__ ring_opc_in,
    const int32_t* __restrict__ ring_args_in,
    int32_t* __restrict__ ring_opc_out,
    int32_t* __restrict__ ring_args_out) {
  const int64_t mask = static_cast<int64_t>(cap) - 1;
  const int64_t tail_slot = (*tail_ptr) & mask;
  for (int64_t s = gtid; s < cap; s += gstride) {
    const int64_t d = (s - tail_slot) & mask;
    if (d < count) {
      ring_opc_out[s] = batch_opc[d];
      for (int a = 0; a < arg_w; ++a)
        ring_args_out[s * arg_w + a] = batch_args[d * arg_w + a];
    } else {
      ring_opc_out[s] = ring_opc_in[s];
      for (int a = 0; a < arg_w; ++a)
        ring_args_out[s * arg_w + a] = ring_args_in[s * arg_w + a];
    }
  }
}
