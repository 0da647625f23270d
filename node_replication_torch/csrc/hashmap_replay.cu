// Hashmap replay and fused combiner-round kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the reference package:
//   K2  node_replication_tpu/ops/pallas_replay.py:_replay_kernel
//       (built by make_hashmap_replay, driven by make_pallas_step)
//   K1  node_replication_tpu/ops/pallas_replay.py:_fused_hashmap_kernel
//       (built by make_fused_hashmap_calls, driven by FusedHashmapEngine)
// Both are one templated body: APPEND adds K1's ring append, FENCED its
// fenced-lane restore.
//
// What they compute. A window of W entries (opcode, key, value) is
// replayed IN ORDER into every replica's column of the transposed state
// planes values/present int32[Kp, R]. k = floored key mod n_keys.
// PUT (1): values[k] = v, present[k] = 1, resp 0. REMOVE (2):
// values[k] = 0, present[k] = 0, resp = present[k] before. Any other
// opcode is inert, resp 0. The planes are out of place, as in the
// reference: the input is copied to the output, then replayed.
//
// Layout and parallelism. A warp covers 32 neighbouring replica
// columns, so each row read-modify-write is one coalesced 128-byte
// access. Entries on different keys commute, so the key space is
// partitioned: warp `part` of a column group owns the rows with
// k % n_part == part, copies them in->out, and replays exactly the
// entries whose key it owns, in window order. Every (row, column) cell
// and every response element has one owner thread, so the kernel needs
// no atomics and no inter-block ordering, and the n_part-fold split
// multiplies the warps in flight (R = 4096 alone gives 128 warps for
// 132 SMs). The key is the same for all lanes, so each branch is
// warp-uniform. The window is staged through shared memory in chunks
// (opcode, reduced key, owner, value); every lane reads the same entry,
// a broadcast.
//
// What bounds it. The planes are far larger than L2 at the flagship
// shape (2 x 164 MB in, 2 x 164 MB out, R = 4096, Kp = 10000), so the
// copy is bound by device-memory bytes; the per-owner replay chain is a
// sequence of dependent loads (latency), hidden by the warps of the
// other partitions and columns.
//
// K1's append is ring_append.cuh's grid-stride pass (each ring slot
// written once, `tail` read from its device scalar). The reference also
// chunks the replica axis into calls of at most MAX_GRID grid steps
// (ops/pallas_chunk.py) because of an aliased-block pipeline race in
// Mosaic; that does not exist here: one launch per round. The replay
// reads the batch from its input, not from the ring, so the append and
// the replay do not depend on each other inside the launch.
//
// Fenced lanes (FENCED) replay like every other lane, so their
// responses are computed; their state rows are then restored from the
// input by the same owner thread (the caller zeroes their responses).
//
// Plain C interface, loaded with ctypes (node_replication_torch/ops/
// replay.py). Each entry point launches on the given stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "ring_append.cuh"

namespace {

constexpr int kLanes = 32;    // replica columns per warp (blockDim.x)
constexpr int kWarps = 2;     // key partitions per block (blockDim.y)
constexpr int kChunk = 1024;  // window entries staged per pass

template <bool APPEND, bool FENCED>
__global__ void __launch_bounds__(kLanes * kWarps)
hashmap_round_kernel(
    const int32_t* __restrict__ opc, const int32_t* __restrict__ key,
    int key_stride, const int32_t* __restrict__ val, int val_stride,
    int window, int n_keys, int kp, int n_rep, int n_part,
    const int32_t* __restrict__ vals_in,
    const int32_t* __restrict__ pres_in,
    int32_t* __restrict__ vals_out, int32_t* __restrict__ pres_out,
    int32_t* __restrict__ resps, const int32_t* __restrict__ fenced,
    const int64_t* __restrict__ tail_ptr, int count, int cap, int arg_w,
    const int32_t* __restrict__ batch_args,
    const int32_t* __restrict__ ring_opc_in,
    const int32_t* __restrict__ ring_args_in,
    int32_t* __restrict__ ring_opc_out,
    int32_t* __restrict__ ring_args_out) {
  __shared__ int32_t s_opc[kChunk];
  __shared__ int32_t s_key[kChunk];
  __shared__ int32_t s_own[kChunk];
  __shared__ int32_t s_val[kChunk];

  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const int nthreads = kLanes * kWarps;
  const int r = blockIdx.x * kLanes + threadIdx.x;
  const int part = blockIdx.y * kWarps + threadIdx.y;
  const bool live = r < n_rep;

  if (APPEND) {
    const int64_t gtid =
        (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
            nthreads + tid;
    const int64_t gstride =
        static_cast<int64_t>(gridDim.x) * gridDim.y * nthreads;
    ring_append_pass(gtid, gstride, tail_ptr, count, cap, arg_w, opc,
                     batch_args, ring_opc_in, ring_args_in, ring_opc_out,
                     ring_args_out);
  }

  if (live) {
    for (int k = part; k < kp; k += n_part) {
      const size_t o = static_cast<size_t>(k) * n_rep + r;
      vals_out[o] = vals_in[o];
      pres_out[o] = pres_in[o];
    }
  }

  for (int c0 = 0; c0 < window; c0 += kChunk) {
    const int n = min(kChunk, window - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < n; i += nthreads) {
      // floored modulo: C's % truncates toward zero, so a negative key
      // would index a negative row
      int k = key[static_cast<size_t>(c0 + i) * key_stride] % n_keys;
      if (k < 0) k += n_keys;
      s_opc[i] = opc[c0 + i];
      s_key[i] = k;
      s_own[i] = k % n_part;
      s_val[i] = val[static_cast<size_t>(c0 + i) * val_stride];
    }
    __syncthreads();
    if (live) {
      for (int i = 0; i < n; ++i) {
        if (s_own[i] != part) continue;  // warp-uniform
        const int op = s_opc[i];
        const size_t o = static_cast<size_t>(s_key[i]) * n_rep + r;
        const int32_t row_p = pres_out[o];
        if (op == 1) {
          vals_out[o] = s_val[i];
          pres_out[o] = 1;
        } else if (op == 2) {
          vals_out[o] = 0;
          pres_out[o] = 0;
        }
        resps[static_cast<size_t>(c0 + i) * n_rep + r] =
            (op == 2) ? row_p : 0;
      }
    }
  }

  if (FENCED && live && fenced[r] > 0) {
    for (int k = part; k < kp; k += n_part) {
      const size_t o = static_cast<size_t>(k) * n_rep + r;
      vals_out[o] = vals_in[o];
      pres_out[o] = pres_in[o];
    }
  }
}

dim3 grid_for(int n_rep, int n_part) {
  return dim3((n_rep + kLanes - 1) / kLanes, n_part / kWarps);
}

}  // namespace

extern "C" {

// Key partitions must be a positive multiple of this.
int nr_hashmap_warps_per_block() { return kWarps; }

int nr_hashmap_replay(const int32_t* opc, const int32_t* key,
                      const int32_t* val, int window, int n_keys, int kp,
                      int n_rep, int n_part, const int32_t* vals_in,
                      const int32_t* pres_in, int32_t* vals_out,
                      int32_t* pres_out, int32_t* resps, void* stream) {
  hashmap_round_kernel<false, false>
      <<<grid_for(n_rep, n_part), dim3(kLanes, kWarps), 0,
         static_cast<cudaStream_t>(stream)>>>(
          opc, key, 1, val, 1, window, n_keys, kp, n_rep, n_part,
          vals_in, pres_in, vals_out, pres_out, resps, nullptr, nullptr,
          0, 0, 0, nullptr, nullptr, nullptr, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

int nr_hashmap_fused_round(
    const int32_t* opc, const int32_t* batch_args, int arg_w, int window,
    int n_keys, int kp, int n_rep, int n_part, const int32_t* vals_in,
    const int32_t* pres_in, int32_t* vals_out, int32_t* pres_out,
    int32_t* resps, const int32_t* fenced, const int64_t* tail, int count,
    int cap, const int32_t* ring_opc_in, const int32_t* ring_args_in,
    int32_t* ring_opc_out, int32_t* ring_args_out, void* stream) {
  const dim3 grid = grid_for(n_rep, n_part);
  const dim3 block(kLanes, kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fenced != nullptr) {
    hashmap_round_kernel<true, true><<<grid, block, 0, s>>>(
        opc, batch_args, arg_w, batch_args + 1, arg_w, window, n_keys, kp,
        n_rep, n_part, vals_in, pres_in, vals_out, pres_out, resps, fenced,
        tail, count, cap, arg_w, batch_args, ring_opc_in, ring_args_in,
        ring_opc_out, ring_args_out);
  } else {
    hashmap_round_kernel<true, false><<<grid, block, 0, s>>>(
        opc, batch_args, arg_w, batch_args + 1, arg_w, window, n_keys, kp,
        n_rep, n_part, vals_in, pres_in, vals_out, pres_out, resps, nullptr,
        tail, count, cap, arg_w, batch_args, ring_opc_in, ring_args_in,
        ring_opc_out, ring_args_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
