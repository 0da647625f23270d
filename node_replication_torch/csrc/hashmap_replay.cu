// Hashmap replay and fused combiner-round kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the reference package:
//   K2  node_replication_tpu/ops/pallas_replay.py:_replay_kernel
//       (built by make_hashmap_replay, driven by make_pallas_step)
//   K1  node_replication_tpu/ops/pallas_replay.py:_fused_hashmap_kernel
//       (built by make_fused_hashmap_calls, driven by FusedHashmapEngine)
// Both run one body, tile_body<VEC, APPEND, FENCED>: K2
// (hashmap_replay_kernel<VEC>) is its APPEND = false, FENCED = false
// case with unit key and value strides; K1 (hashmap_round_kernel<VEC,
// FENCED>) adds the ring append (APPEND) and, for a fenced fleet, the
// fenced-lane restore (FENCED), and reads the key and value at stride
// arg_w from the batch's args.
//
// What they compute. A window of W entries (opcode, key, value) is
// replayed IN ORDER into every replica's column of the transposed state
// planes values/present int32[Kp, R]. k = floored key mod n_keys.
// PUT (1): values[k] = v, present[k] = 1, resp 0. REMOVE (2):
// values[k] = 0, present[k] = 0, resp = present[k] before. Any other
// opcode is inert, resp 0. The planes are out of place, as in the
// reference: the input is copied to the output, then replayed.
//
// Shared-memory row tiles. Block b owns a tile of kTileRows key rows x
// kTileCols replica columns of both planes (64 KiB), and every state
// cell and response element has exactly one owner block, so there are
// no atomics and no ordering between blocks.
//   1. The tile comes in with cp.async (16-byte copies over 4
//      neighbouring columns, all of a thread's copies in flight at once;
//      4-byte copies when R % 4 != 0 or a plane is not 16-byte aligned).
//   2. K1: while it lands, the first cap / kTileThreads blocks write the
//      ring (ring_append.cuh: each slot written once, `tail` read from
//      its device scalar), one slot a thread. The replay reads the
//      batch from its input, not from the ring, so the append and the
//      replay do not depend on each other inside the launch.
//   3. The block scans the window once, cooperatively, in chunks of
//      kTileChunk entries: each thread reduces kTilePer keys (loaded
//      coalesced, the next chunk's while this one is replayed), a ballot
//      per warp and a prefix over the 32 per-warp counts keep, in window
//      order, only the entries whose k lies in the tile's rows (stable
//      compaction into shared memory). Only those entries' opcodes and
//      values are read. No warp walks the window serially; at the
//      flagship shape a tile's list is ~6.5 entries of a 4096 window.
//   4. Thread c walks the list on column c of the tile: each entry's
//      read-modify-write is a shared-memory access, never a wait on
//      device memory, and the entry's response segment resps[i, columns]
//      is written once, coalesced, by the block that owns k's rows
//      (inert entries and K1's NOOP padding too, with 0), so all W x R
//      responses are written. Padding rows (n_keys <= k < Kp) are copied
//      and never replayed.
//   5. FENCED: a fenced column replays like every other, so its
//      responses are a full replay's (as in the reference); its tile
//      column is then re-read from the input (the caller zeroes its
//      responses).
//   6. The tile goes out once, 16-byte streaming stores.
// 16 rows x 512 columns: 64 KiB of tile, 8 KiB of list and the counts,
// three blocks per SM. At R = 4096, Kp = 10000 that is 5,000 blocks; at
// a mesh shard's R = 1024, 1,250.
//
// What bounds both: device-memory bytes. The state in and out and the
// responses (K1: and the ring in and out and the batch) are read or
// written once; the replay lives in shared memory. K2 at R = 4096,
// Kp = 10000, W = 4096: 722,518,016 B, 0.216 ms at 3.35 TB/s. K1 at
// R = 4096, W = 256: 661,655,552 B, 0.1975 ms; at a mesh shard's
// R = 1024, W = 256: 166,989,824 B, 0.0498 ms. The window scan reads
// blocks x W x 4 B of keys (from L2 and L1, not device memory).
//
// The reference also chunks the replica axis into calls of at most
// MAX_GRID grid steps (ops/pallas_chunk.py) because of an aliased-block
// pipeline race in Mosaic; that does not exist here: one launch a call.
//
// Plain C interface, loaded with ctypes (node_replication_torch/ops/
// replay.py). Each entry point launches on the given stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "ring_append.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kTileThreads = 512;          // threads per block
constexpr int kTileCols = kTileThreads;    // tile columns: one per thread
constexpr int kTileRows = 16;              // tile rows (keys)
constexpr int kTileWarps = kTileThreads / kLanes;
constexpr int kTilePer = kLanes / kTileWarps;     // entries a thread a chunk
constexpr int kTileChunk = kTileThreads * kTilePer;  // entries a pass
constexpr int kTile = kTileRows * kTileCols;         // ints per plane tile
constexpr size_t kTileSmem =
    sizeof(int32_t) * (2 * kTile + 2 * kTileChunk + kTilePer * kTileWarps);
static_assert(kTilePer * kTileWarps == kLanes, "one count per lane");
static_assert(kTileRows <= 64 && kTileChunk <= (1 << 23), "list packing");

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

// One call's operands. K2 leaves the ring and `fenced` null, and its
// keys and values are unit-stride; K1 reads them at args[:, 0] and
// args[:, 1], at stride arg_w.
struct Round {
  const int32_t* opc;
  const int32_t* key;
  const int32_t* val;
  int window, n_keys, kp, n_rep, n_ct;
  const int32_t* vals_in;
  const int32_t* pres_in;
  int32_t* vals_out;
  int32_t* pres_out;
  int32_t* resps;
  const int32_t* fenced;  // int32[R], > 0 = fenced (FENCED)
  // the ring append (APPEND)
  const int64_t* tail;
  int count, cap, arg_w;
  const int32_t* batch_args;
  const int32_t* ring_opc_in;
  const int32_t* ring_args_in;
  int32_t* ring_opc_out;
  int32_t* ring_args_out;
};

// The body of both kernels: one block per (row tile, column tile),
// column tile fastest. VEC: R % 4 == 0 and 16-byte aligned planes, so a
// tile row is whole int4s.
template <bool VEC, bool APPEND, bool FENCED>
__device__ __forceinline__ void tile_body(const Round& a) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* s_v = smem;                  // [kTileRows][kTileCols] values
  int32_t* s_p = s_v + kTile;           // [kTileRows][kTileCols] present
  int32_t* s_ent = s_p + kTile;         // [kTileChunk] off<<8 | row<<2 | op
  int32_t* s_arg = s_ent + kTileChunk;  // [kTileChunk] the entry's value
  int32_t* s_cnt = s_arg + kTileChunk;  // [kTilePer][kTileWarps] hits

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int warp = tid / kLanes;
  const int n_rep = a.n_rep, window = a.window, n_keys = a.n_keys;
  const int row0 = static_cast<int>(blockIdx.x / a.n_ct) * kTileRows;
  const int col0 = static_cast<int>(blockIdx.x % a.n_ct) * kTileCols;
  const int rows = min(kTileRows, a.kp - row0);
  const int cols = min(kTileCols, n_rep - col0);
  const size_t base = static_cast<size_t>(row0) * n_rep + col0;

  // 1. the tile in, asynchronously
  if (VEC) {
    constexpr int q4 = kTileCols / 4;
    for (int q = tid; q < rows * q4; q += kTileThreads) {
      const int rr = q / q4, cc = q % q4 * 4;
      if (cc < cols) {
        const size_t g = base + static_cast<size_t>(rr) * n_rep + cc;
        cp_async16(s_v + rr * kTileCols + cc, a.vals_in + g);
        cp_async16(s_p + rr * kTileCols + cc, a.pres_in + g);
      }
    }
  } else {
    for (int q = tid; q < rows * kTileCols; q += kTileThreads) {
      const int rr = q / kTileCols, cc = q % kTileCols;
      if (cc < cols) {
        const size_t g = base + static_cast<size_t>(rr) * n_rep + cc;
        cp_async4(s_v + q, a.vals_in + g);
        cp_async4(s_p + q, a.pres_in + g);
      }
    }
  }
  const bool fen = FENCED && tid < cols && __ldg(a.fenced + col0 + tid) > 0;

  // 2. the ring, while the tile lands
  if (APPEND &&
      static_cast<int64_t>(blockIdx.x) * kTileThreads < a.cap) {
    ring_append_pass(static_cast<int64_t>(blockIdx.x) * kTileThreads + tid,
                     static_cast<int64_t>(gridDim.x) * kTileThreads,
                     a.tail, a.count, a.cap, a.arg_w, a.opc, a.batch_args,
                     a.ring_opc_in, a.ring_args_in, a.ring_opc_out,
                     a.ring_args_out);
  }

  // 3. scan: thread tid reduces entries c0 + j * kTileThreads + tid; the
  // next chunk's keys are loaded while this one is replayed
  const size_t stride = APPEND ? static_cast<size_t>(a.arg_w) : 1;
  int32_t keys[kTilePer];
#pragma unroll
  for (int j = 0; j < kTilePer; ++j) {
    const int e = j * kTileThreads + tid;
    keys[j] = e < window ? __ldg(a.key + e * stride) : 0;
  }
  for (int c0 = 0; c0 < window; c0 += kTileChunk) {
    unsigned hits[kTilePer];
    int32_t ent[kTilePer], arg[kTilePer];
#pragma unroll
    for (int j = 0; j < kTilePer; ++j) {
      const int off = j * kTileThreads + tid;
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
          const int op = __ldg(a.opc + e);
          ent[j] = off << 8 | (k - row0) << 2 |
                   (op == 1 ? 1 : op == 2 ? 2 : 0);
          arg[j] = __ldg(a.val + e * stride);
        }
      }
      hits[j] = __ballot_sync(0xffffffffu, hit);
      keys[j] = e < window - kTileChunk
                    ? __ldg(a.key + (e + kTileChunk) * stride) : 0;
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kTilePer; ++j)
        s_cnt[j * kTileWarps + warp] = __popc(hits[j]);
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
    for (int j = 0; j < kTilePer; ++j) {
      const int at0 =
          __shfl_sync(0xffffffffu, incl - cnt, j * kTileWarps + warp);
      if (hits[j] >> lane & 1u) {
        const int at = at0 + __popc(hits[j] & ((1u << lane) - 1u));
        s_ent[at] = ent[j];
        s_arg[at] = arg[j];
      }
    }
    cp_async_wait_all();  // this thread's part of the tile has landed
    __syncthreads();      // the list and the whole tile are visible

    // 4. replay: thread tid on column tid, the list in window order
    if (tid < cols) {
      int32_t* out = a.resps + static_cast<size_t>(c0) * n_rep + col0 + tid;
      for (int i = 0; i < n_hit; ++i) {
        const int e = s_ent[i];
        const int at = (e >> 2 & 63) * kTileCols + tid;
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

  // 5. a fenced column takes its input back
  if (FENCED) {
    if (fen) {
      for (int rr = 0; rr < rows; ++rr) {
        const size_t g = base + static_cast<size_t>(rr) * n_rep + tid;
        s_v[rr * kTileCols + tid] = __ldg(a.vals_in + g);
        s_p[rr * kTileCols + tid] = __ldg(a.pres_in + g);
      }
    }
    __syncthreads();
  }

  // 6. the tile out
  if (VEC) {
    constexpr int q4 = kTileCols / 4;
    for (int q = tid; q < rows * q4; q += kTileThreads) {
      const int rr = q / q4, cc = q % q4 * 4;
      if (cc < cols) {
        const size_t g = base + static_cast<size_t>(rr) * n_rep + cc;
        const int at = rr * kTileCols + cc;
        __stcs(reinterpret_cast<int4*>(a.vals_out + g),
               *reinterpret_cast<const int4*>(s_v + at));
        __stcs(reinterpret_cast<int4*>(a.pres_out + g),
               *reinterpret_cast<const int4*>(s_p + at));
      }
    }
  } else {
    for (int q = tid; q < rows * kTileCols; q += kTileThreads) {
      const int rr = q / kTileCols, cc = q % kTileCols;
      if (cc < cols) {
        const size_t g = base + static_cast<size_t>(rr) * n_rep + cc;
        __stcs(a.vals_out + g, s_v[q]);
        __stcs(a.pres_out + g, s_p[q]);
      }
    }
  }
}

// K2 (its own entry, so that a profile tells the two kernels apart)
template <bool VEC>
__global__ void __launch_bounds__(kTileThreads, 3)
hashmap_replay_kernel(const Round a) {
  tile_body<VEC, false, false>(a);
}

// K1
template <bool VEC, bool FENCED>
__global__ void __launch_bounds__(kTileThreads, 3)
hashmap_round_kernel(const Round a) {
  tile_body<VEC, true, FENCED>(a);
}

template <bool VEC, bool APPEND, bool FENCED>
cudaError_t launch_tile(int n_blocks, const Round& a, cudaStream_t s) {
  void (*kernel)(Round) = APPEND ? hashmap_round_kernel<VEC, FENCED>
                                 : hashmap_replay_kernel<VEC>;
  // set on every call: the attributes belong to the current device
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kTileSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, kTileThreads, kTileSmem, s>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Fills in the tiling of `a` and launches the instantiation for its
// planes' alignment.
template <bool APPEND, bool FENCED>
cudaError_t launch(Round a, cudaStream_t s) {
  a.n_ct = (a.n_rep + kTileCols - 1) / kTileCols;
  const int64_t n_blocks =
      static_cast<int64_t>((a.kp + kTileRows - 1) / kTileRows) * a.n_ct;
  // an append needs a block even where there is no tile
  if (n_blocks == 0) return APPEND ? cudaErrorInvalidValue : cudaSuccess;
  if (n_blocks > INT32_MAX) return cudaErrorInvalidValue;
  const bool vec = a.n_rep % 4 == 0 && aligned16(a.vals_in) &&
                   aligned16(a.pres_in) && aligned16(a.vals_out) &&
                   aligned16(a.pres_out);
  const int nb = static_cast<int>(n_blocks);
  return vec ? launch_tile<true, APPEND, FENCED>(nb, a, s)
             : launch_tile<false, APPEND, FENCED>(nb, a, s);
}

}  // namespace

extern "C" {

// The tile: writes its rows, columns and window chunk; returns its
// dynamic shared memory in bytes.
int nr_hashmap_replay_tile(int* rows, int* cols, int* chunk) {
  *rows = kTileRows;
  *cols = kTileCols;
  *chunk = kTileChunk;
  return static_cast<int>(kTileSmem);
}

int nr_hashmap_replay(const int32_t* opc, const int32_t* key,
                      const int32_t* val, int window, int n_keys, int kp,
                      int n_rep, const int32_t* vals_in,
                      const int32_t* pres_in, int32_t* vals_out,
                      int32_t* pres_out, int32_t* resps, void* stream) {
  Round a{};
  a.opc = opc;
  a.key = key;
  a.val = val;
  a.window = window;
  a.n_keys = n_keys;
  a.kp = kp;
  a.n_rep = n_rep;
  a.vals_in = vals_in;
  a.pres_in = pres_in;
  a.vals_out = vals_out;
  a.pres_out = pres_out;
  a.resps = resps;
  return static_cast<int>(
      launch<false, false>(a, static_cast<cudaStream_t>(stream)));
}

int nr_hashmap_fused_round(
    const int32_t* opc, const int32_t* batch_args, int arg_w, int window,
    int n_keys, int kp, int n_rep, const int32_t* vals_in,
    const int32_t* pres_in, int32_t* vals_out, int32_t* pres_out,
    int32_t* resps, const int32_t* fenced, const int64_t* tail, int count,
    int cap, const int32_t* ring_opc_in, const int32_t* ring_args_in,
    int32_t* ring_opc_out, int32_t* ring_args_out, void* stream) {
  Round a{};
  a.opc = opc;
  a.key = batch_args;
  a.val = batch_args + 1;
  a.window = window;
  a.n_keys = n_keys;
  a.kp = kp;
  a.n_rep = n_rep;
  a.vals_in = vals_in;
  a.pres_in = pres_in;
  a.vals_out = vals_out;
  a.pres_out = pres_out;
  a.resps = resps;
  a.fenced = fenced;
  a.tail = tail;
  a.count = count;
  a.cap = cap;
  a.arg_w = arg_w;
  a.batch_args = batch_args;
  a.ring_opc_in = ring_opc_in;
  a.ring_args_in = ring_args_in;
  a.ring_opc_out = ring_opc_out;
  a.ring_args_out = ring_args_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(fenced != nullptr ? launch<true, true>(a, s)
                                            : launch<true, false>(a, s));
}

}  // extern "C"
