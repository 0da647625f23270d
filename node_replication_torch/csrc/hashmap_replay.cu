// Hashmap replay and fused combiner-round kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the reference package:
//   K2  node_replication_tpu/ops/pallas_replay.py:_replay_kernel
//       (built by make_hashmap_replay, driven by make_pallas_step)
//   K1  node_replication_tpu/ops/pallas_replay.py:_fused_hashmap_kernel
//       (built by make_fused_hashmap_calls, driven by FusedHashmapEngine)
// Each has its own body: K2 is hashmap_replay_kernel, K1 is
// hashmap_round_kernel (APPEND adds its ring append, FENCED its
// fenced-lane restore).
//
// What they compute. A window of W entries (opcode, key, value) is
// replayed IN ORDER into every replica's column of the transposed state
// planes values/present int32[Kp, R]. k = floored key mod n_keys.
// PUT (1): values[k] = v, present[k] = 1, resp 0. REMOVE (2):
// values[k] = 0, present[k] = 0, resp = present[k] before. Any other
// opcode is inert, resp 0. The planes are out of place, as in the
// reference: the input is copied to the output, then replayed.
//
// K2: shared-memory row tiles. Block b owns a tile of kK2Rows key rows x
// kK2Cols replica columns of both planes (64 KiB), and every state cell
// and response element has exactly one owner block, so there are no
// atomics and no ordering between blocks.
//   1. The tile comes in with cp.async (16-byte copies over 4 neighbouring
//      columns, all of a thread's copies in flight at once; 4-byte copies
//      when R % 4 != 0 or a plane is not 16-byte aligned).
//   2. While it lands, the block scans the window once, cooperatively, in
//      chunks of kK2Chunk entries: each thread reduces kK2Per keys (loaded
//      coalesced, the next chunk's while this one is replayed), a ballot
//      per warp and a prefix over the 32 per-warp counts keep, in window
//      order, only the entries whose k lies in the tile's rows (stable
//      compaction into shared memory). Only those entries' opcodes and
//      values are read. No warp walks the window serially; at the
//      flagship shape a tile's list is ~6.5 entries.
//   3. Thread c walks the list on column c of the tile: each entry's
//      read-modify-write is a shared-memory access, never a wait on
//      device memory, and the entry's response segment resps[i, columns]
//      is written once, coalesced, by the block that owns k's rows
//      (inert entries too, with 0). Padding rows (n_keys <= k < Kp) are
//      copied and never replayed.
//   4. The tile goes out once, 16-byte streaming stores.
// 16 rows x 512 columns: 64 KiB of tile, 8 KiB of list and the counts,
// three blocks per SM. At R = 4096, Kp = 10000 that is 5,000 blocks.
//
// What bounds K2: device-memory bytes. The state in and out and the
// responses are 722,518,016 B at R = 4096, Kp = 10000, W = 4096, 0.216 ms
// at 3.35 TB/s; the replay itself lives in shared memory. The window scan
// reads blocks x W x 4 B of keys (82 MB at the flagship, from L2 and L1,
// not device memory).
//
// K1 keeps its first body. A warp covers 32 neighbouring replica columns,
// so each row read-modify-write is one coalesced 128-byte access. The
// key space is partitioned: warp `part` of a column group owns the rows
// with k % n_part == part, copies them in->out, and replays exactly the
// entries whose key it owns, in window order, with dependent
// device-memory loads (latency, hidden by the warps of the other
// partitions and columns). The window is staged through shared memory
// in chunks (opcode, reduced key, owner, value); every lane reads the
// same entry, a broadcast.
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

// ---------------------------------------------------------------- K2

constexpr int kK2Threads = 512;          // threads per block
constexpr int kK2Cols = kK2Threads;      // tile columns: one per thread
constexpr int kK2Rows = 16;              // tile rows (keys)
constexpr int kK2Warps = kK2Threads / kLanes;
constexpr int kK2Per = kLanes / kK2Warps;  // entries per thread a chunk
constexpr int kK2Chunk = kK2Threads * kK2Per;  // entries scanned a pass
constexpr int kK2Tile = kK2Rows * kK2Cols;     // ints per plane tile
constexpr size_t kK2Smem =
    sizeof(int32_t) * (2 * kK2Tile + 2 * kK2Chunk + kK2Per * kK2Warps);
static_assert(kK2Per * kK2Warps == kLanes, "one count per lane");
static_assert(kK2Rows <= 64 && kK2Chunk <= (1 << 23), "list packing");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One block per (row tile, column tile), column tile fastest. VEC: R % 4
// == 0 and 16-byte aligned planes, so a tile row is whole int4s.
template <bool VEC>
__global__ void __launch_bounds__(kK2Threads, 3)
hashmap_replay_kernel(
    const int32_t* __restrict__ opc, const int32_t* __restrict__ key,
    const int32_t* __restrict__ val, int window, int n_keys, int kp,
    int n_rep, int n_ct, const int32_t* __restrict__ vals_in,
    const int32_t* __restrict__ pres_in, int32_t* __restrict__ vals_out,
    int32_t* __restrict__ pres_out, int32_t* __restrict__ resps) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* s_v = smem;               // [kK2Rows][kK2Cols] values
  int32_t* s_p = s_v + kK2Tile;      // [kK2Rows][kK2Cols] present
  int32_t* s_ent = s_p + kK2Tile;     // [kK2Chunk] off << 8 | row << 2 | op
  int32_t* s_arg = s_ent + kK2Chunk;  // [kK2Chunk] the entry's value
  int32_t* s_cnt = s_arg + kK2Chunk;  // [kK2Per][kK2Warps] hits

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int warp = tid / kLanes;
  const int row0 = static_cast<int>(blockIdx.x / n_ct) * kK2Rows;
  const int col0 = static_cast<int>(blockIdx.x % n_ct) * kK2Cols;
  const int rows = min(kK2Rows, kp - row0);
  const int cols = min(kK2Cols, n_rep - col0);
  const size_t base = static_cast<size_t>(row0) * n_rep + col0;

  // 1. the tile in, asynchronously
  if (VEC) {
    constexpr int q4 = kK2Cols / 4;
    for (int q = tid; q < rows * q4; q += kK2Threads) {
      const int rr = q / q4, cc = q % q4 * 4;
      if (cc < cols) {
        const size_t g = base + static_cast<size_t>(rr) * n_rep + cc;
        cp_async16(s_v + rr * kK2Cols + cc, vals_in + g);
        cp_async16(s_p + rr * kK2Cols + cc, pres_in + g);
      }
    }
  } else {
    for (int q = tid; q < rows * kK2Cols; q += kK2Threads) {
      const int rr = q / kK2Cols, cc = q % kK2Cols;
      if (cc < cols) {
        const size_t g = base + static_cast<size_t>(rr) * n_rep + cc;
        cp_async4(s_v + q, vals_in + g);
        cp_async4(s_p + q, pres_in + g);
      }
    }
  }

  // 2. scan: thread tid reduces entries c0 + j * kK2Threads + tid; the
  // next chunk's keys are loaded while this one is replayed
  int32_t keys[kK2Per];
#pragma unroll
  for (int j = 0; j < kK2Per; ++j) {
    const int e = j * kK2Threads + tid;
    keys[j] = e < window ? __ldg(key + e) : 0;
  }
  for (int c0 = 0; c0 < window; c0 += kK2Chunk) {
    unsigned hits[kK2Per];
    int32_t ent[kK2Per], arg[kK2Per];
#pragma unroll
    for (int j = 0; j < kK2Per; ++j) {
      const int off = j * kK2Threads + tid;
      const int e = c0 + off;  // c0 + off < window < 2^31
      bool hit = false;
      ent[j] = arg[j] = 0;
      if (e < window) {
        int k = keys[j];
        if (static_cast<unsigned>(k) >= static_cast<unsigned>(n_keys)) {
          // floored modulo: C's % truncates toward zero
          k %= n_keys;
          if (k < 0) k += n_keys;
        }
        hit = static_cast<unsigned>(k - row0) <
              static_cast<unsigned>(rows);
        if (hit) {
          const int op = __ldg(opc + e);
          ent[j] = off << 8 | (k - row0) << 2 |
                   (op == 1 ? 1 : op == 2 ? 2 : 0);
          arg[j] = __ldg(val + e);
        }
      }
      hits[j] = __ballot_sync(0xffffffffu, hit);
      keys[j] = e < window - kK2Chunk ? __ldg(key + e + kK2Chunk) : 0;
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kK2Per; ++j)
        s_cnt[j * kK2Warps + warp] = __popc(hits[j]);
    }
    __syncthreads();  // the counts are in; the last chunk's list is spent
    // window order is (j, warp, lane): lane l of every warp scans the
    // 32 counts, so each warp knows where its hits go
    const int cnt = s_cnt[lane];
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    const int n_hit = __shfl_sync(0xffffffffu, incl, kLanes - 1);
#pragma unroll
    for (int j = 0; j < kK2Per; ++j) {
      const int at0 =
          __shfl_sync(0xffffffffu, incl - cnt, j * kK2Warps + warp);
      if (hits[j] >> lane & 1u) {
        const int at = at0 + __popc(hits[j] & ((1u << lane) - 1u));
        s_ent[at] = ent[j];
        s_arg[at] = arg[j];
      }
    }
    cp_async_wait_all();  // this thread's part of the tile has landed
    __syncthreads();      // the list and the whole tile are visible

    // 3. replay: thread tid on column tid, the list in window order
    if (tid < cols) {
      int32_t* out = resps + static_cast<size_t>(c0) * n_rep + col0 + tid;
      for (int i = 0; i < n_hit; ++i) {
        const int e = s_ent[i];
        const int at = (e >> 2 & 63) * kK2Cols + tid;
        const int op = e & 3;
        const int32_t p = s_p[at];
        if (op == 1) {
          s_v[at] = s_arg[i];
          s_p[at] = 1;
        } else if (op == 2) {
          s_v[at] = 0;
          s_p[at] = 0;
        }
        out[static_cast<size_t>(e >> 8) * n_rep] = op == 2 ? p : 0;
      }
    }
  }
  cp_async_wait_all();  // an empty window scanned nothing
  __syncthreads();      // every column's replay is done

  // 4. the tile out
  if (VEC) {
    constexpr int q4 = kK2Cols / 4;
    for (int q = tid; q < rows * q4; q += kK2Threads) {
      const int rr = q / q4, cc = q % q4 * 4;
      if (cc < cols) {
        const size_t g = base + static_cast<size_t>(rr) * n_rep + cc;
        const int at = rr * kK2Cols + cc;
        __stcs(reinterpret_cast<int4*>(vals_out + g),
               *reinterpret_cast<const int4*>(s_v + at));
        __stcs(reinterpret_cast<int4*>(pres_out + g),
               *reinterpret_cast<const int4*>(s_p + at));
      }
    }
  } else {
    for (int q = tid; q < rows * kK2Cols; q += kK2Threads) {
      const int rr = q / kK2Cols, cc = q % kK2Cols;
      if (cc < cols) {
        const size_t g = base + static_cast<size_t>(rr) * n_rep + cc;
        __stcs(vals_out + g, s_v[q]);
        __stcs(pres_out + g, s_p[q]);
      }
    }
  }
}

template <bool VEC>
cudaError_t launch_replay(int n_blocks, int n_ct, cudaStream_t s,
                          const int32_t* opc, const int32_t* key,
                          const int32_t* val, int window, int n_keys, int kp,
                          int n_rep, const int32_t* vals_in,
                          const int32_t* pres_in, int32_t* vals_out,
                          int32_t* pres_out, int32_t* resps) {
  // set on every call: the attributes belong to the current device
  cudaError_t err = cudaFuncSetAttribute(
      hashmap_replay_kernel<VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kK2Smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(hashmap_replay_kernel<VEC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  hashmap_replay_kernel<VEC><<<n_blocks, kK2Threads, kK2Smem, s>>>(
      opc, key, val, window, n_keys, kp, n_rep, n_ct, vals_in, pres_in,
      vals_out, pres_out, resps);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---------------------------------------------------------------- K1

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

// K2's tile: writes its rows, columns and window chunk; returns its
// dynamic shared memory in bytes.
int nr_hashmap_replay_tile(int* rows, int* cols, int* chunk) {
  *rows = kK2Rows;
  *cols = kK2Cols;
  *chunk = kK2Chunk;
  return static_cast<int>(kK2Smem);
}

int nr_hashmap_replay(const int32_t* opc, const int32_t* key,
                      const int32_t* val, int window, int n_keys, int kp,
                      int n_rep, const int32_t* vals_in,
                      const int32_t* pres_in, int32_t* vals_out,
                      int32_t* pres_out, int32_t* resps, void* stream) {
  const int n_ct = (n_rep + kK2Cols - 1) / kK2Cols;
  const int64_t n_blocks =
      static_cast<int64_t>((kp + kK2Rows - 1) / kK2Rows) * n_ct;
  if (n_blocks == 0) return static_cast<int>(cudaSuccess);
  if (n_blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n_rep % 4 == 0 && aligned16(vals_in) &&
                   aligned16(pres_in) && aligned16(vals_out) &&
                   aligned16(pres_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec ? launch_replay<true>(static_cast<int>(n_blocks), n_ct, s, opc,
                                key, val, window, n_keys, kp, n_rep,
                                vals_in, pres_in, vals_out, pres_out, resps)
          : launch_replay<false>(static_cast<int>(n_blocks), n_ct, s, opc,
                                 key, val, window, n_keys, kp, n_rep,
                                 vals_in, pres_in, vals_out, pres_out,
                                 resps);
  return static_cast<int>(err);
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
