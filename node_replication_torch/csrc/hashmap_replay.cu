// Hashmap replay and fused combiner-round kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the reference package:
//   K2  node_replication_tpu/ops/pallas_replay.py:_replay_kernel
//       (built by make_hashmap_replay, driven by make_pallas_step)
//   K1  node_replication_tpu/ops/pallas_replay.py:_fused_hashmap_kernel
//       (built by make_fused_hashmap_calls, driven by FusedHashmapEngine)
// Both run one body, tile_body<MODEL, VEC, APPEND, FENCED>: K2
// (hashmap_replay_kernel<VEC>) is its APPEND = false, FENCED = false
// case over the planes with unit key and value strides; K1
// (hashmap_round_kernel<MODEL, VEC, FENCED>) adds the ring append
// (APPEND) and, for a fenced fleet, the fenced replicas (FENCED), and
// reads the key and value at stride arg_w from the batch's args. MODEL
// is the layout of the state, fixed by the entry point:
//   planes (MODEL = false): the reference's transposed values/present
//     int32[Kp, R] and responses int32[W, R]; K2;
//   states (MODEL = true): the model's own values int32[R, K], present
//     bool[R, K] (one byte, 0/1) and responses int32[R, W]; K1 through
//     FusedHashmapEngine.round_fn, so a round does no layout work.
// APPEND is true exactly where MODEL is: K1 runs over the states alone.
//
// What they compute. A window of W entries (opcode, key, value) is
// replayed IN ORDER into every replica's copy of the table.
// k = floored key mod n_keys. PUT (1): values[k] = v, present[k] = 1,
// resp 0. REMOVE (2): values[k] = 0, present[k] = 0, resp = present[k]
// before. Any other opcode is inert, resp 0. The state is out of place,
// as in the reference: the input is copied to the output, then replayed.
//
// Shared-memory tiles. Block b owns a tile of keys x replicas of both
// planes, and every state cell and response element has exactly one
// owner block, so there are no atomics and no ordering between blocks.
// The tile is a box of a row-major matrix: lines along the axis that is
// contiguous in device memory (a key row of the planes, a replica row of
// the states), and that axis is the grid's fastest.
//   planes: 16 key rows x 512 replica columns, 512 threads, a thread a
//     column: 64 KiB of tile, three blocks per SM. At R = 4096,
//     Kp = 10000 that is 5,000 blocks; at a mesh shard's R = 1024, 1,250.
//   states: 64 keys x 128 replica rows, 128 threads, a thread a row:
//     32 KiB of values and 8 KiB of present (a row's run is 256 bytes of
//     values and two 32-byte sectors of present), four blocks per SM. At
//     R = 4096, K = 10000 that is 5,024 blocks. (At that shape 32 keys x
//     256 rows ran 6% slower, 32 x 512 15%.)
//   1. The tile comes in with cp.async: 16-byte copies along the lines
//      (all of a thread's copies in flight at once) when a line's pitch
//      is a multiple of 4 cells (planes: R % 4 == 0; states: K % 4 == 0,
//      and the present rows in 16 bytes when K % 16 == 0, else in 4) and
//      every base is 16-byte aligned; else cell by cell (the states'
//      present by plain byte loads).
//   2. K1: while it lands, the first cap / threads blocks write the
//      ring (ring_append.cuh: each slot written once, `tail` read from
//      its device scalar), one slot a thread. The replay reads the
//      batch from its input, not from the ring, so the append and the
//      replay do not depend on each other inside the launch.
//   3. The block scans the window once, cooperatively, in chunks of
//      1024 entries: each thread reduces 32 / warps keys (loaded
//      coalesced, the next chunk's while this one is replayed), a ballot
//      per warp and a prefix over the 32 per-warp counts keep, in window
//      order, only the entries whose k lies in the tile's keys (stable
//      compaction into shared memory). Only those entries' opcodes and
//      values are read. No warp walks the window serially; at the
//      flagship shape a planes tile's list is ~6.5 entries of a 4096
//      window, a states tile's ~1.6 of a 256 window.
//   4. Each thread walks the list on its replica: each entry's
//      read-modify-write is a shared-memory access, never a wait on
//      device memory, and the entry's responses for the tile's replicas
//      are written by the block that owns k (inert entries and K1's NOOP
//      padding too, with 0), so all W x R responses are written: planes,
//      one coalesced segment resps[i, replicas]; states, resps[r, i] a
//      thread. Padding rows of the planes (n_keys <= k < Kp) are copied
//      and never replayed.
//   5. FENCED (states): a fenced row is not replayed, so it goes out as
//      it came in, and its responses are written as 0.
//   6. The tile goes out once, 16-byte streaming stores where it came in
//      by 16-byte copies.
//
// What bounds them: device-memory bytes. The state in and out and the
// responses (K1: and the ring in and out and the batch) are read or
// written once; the replay lives in shared memory. K2 at R = 4096,
// Kp = 10000, W = 4096: 722,518,016 B, 0.216 ms at 3.35 TB/s. K1 at
// R = 4096, K = 10000, W = 256, ring 2^16: 415,895,552 B (int32 values
// and byte present in and out, the responses, the ring in and out, the
// batch), 0.1241 ms.
// The window scan reads blocks x W x 4 B of keys (from L2 and L1, not
// device memory).
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

#include <type_traits>

#include "ring_append.cuh"

namespace {

constexpr int kLanes = 32;

// The tile of each layout (MODEL: the states [R, K], else the planes
// [Kp, R]); a thread per replica of the tile.
template <bool MODEL>
struct Tile {
  static constexpr int kThreads = MODEL ? 128 : 512;
  static constexpr int kKeys = MODEL ? 64 : 16;
  static constexpr int kBlocksPerSm = MODEL ? 4 : 3;
  using Pres = typename std::conditional<MODEL, uint8_t, int32_t>::type;
  static constexpr int kWarps = kThreads / kLanes;
  static constexpr int kPer = kLanes / kWarps;  // entries a thread a chunk
  static constexpr int kChunk = kThreads * kPer;  // entries a pass
  static constexpr int kCells = kKeys * kThreads;  // cells of a plane tile
  // cells of a tile line in shared memory (along the contiguous axis)
  static constexpr int kLine = MODEL ? kKeys : kThreads;
  static constexpr size_t kSmem = (sizeof(int32_t) + sizeof(Pres)) * kCells +
                                  sizeof(int32_t) * (2 * kChunk + kLanes);
  static_assert(kPer * kWarps == kLanes, "one count per lane");
  static_assert(kKeys <= 64 && kChunk <= (1 << 23), "list packing");
  static_assert(kKeys % 16 == 0, "whole 16-byte present runs");
};

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
// args[:, 1], at stride arg_w. `kp` is the table's keys as laid out:
// Kp rows of the planes, K columns of the states.
struct Round {
  const int32_t* opc;
  const int32_t* key;
  const int32_t* val;
  int window, n_keys, kp, n_rep, n_ct;
  int pres16;  // the states' present rows go in 16-byte runs (VEC)
  const int32_t* vals_in;
  const void* pres_in;  // Tile<MODEL>::Pres
  int32_t* vals_out;
  void* pres_out;
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

// The body of every kernel: one block per (key tile, replica tile), the
// contiguous axis's tile fastest. VEC: a line's pitch is a multiple of 4
// cells and the bases are 16-byte aligned, so a line is whole int4s.
template <bool MODEL, bool VEC, bool APPEND, bool FENCED>
__device__ __forceinline__ void tile_body(const Round& a) {
  using T = Tile<MODEL>;
  using Pres = typename T::Pres;
  constexpr int kT = T::kThreads, kKeys = T::kKeys, kLine = T::kLine;
  constexpr int kWarps = T::kWarps, kPer = T::kPer, kChunk = T::kChunk;
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* s_v = smem;                                   // values tile
  Pres* s_p = reinterpret_cast<Pres*>(s_v + T::kCells);  // present tile
  // [kChunk] off<<8 | key<<2 | op, [kChunk] the entry's value,
  // [kPer][kWarps] hits
  int32_t* s_ent = reinterpret_cast<int32_t*>(s_p + T::kCells);
  int32_t* s_arg = s_ent + kChunk;
  int32_t* s_cnt = s_arg + kChunk;
  const Pres* pres_in = static_cast<const Pres*>(a.pres_in);
  Pres* pres_out = static_cast<Pres*>(a.pres_out);

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int warp = tid / kLanes;
  const int n_rep = a.n_rep, window = a.window, n_keys = a.n_keys;
  const int ct = static_cast<int>(blockIdx.x % a.n_ct);
  const int lt = static_cast<int>(blockIdx.x / a.n_ct);
  const int key0 = (MODEL ? ct : lt) * kKeys;
  const int rep0 = (MODEL ? lt : ct) * kT;
  const int keys = min(kKeys, a.kp - key0);
  const int reps = min(kT, n_rep - rep0);
  // the tile's lines: replica rows of the states, key rows of the planes
  const int lines = MODEL ? reps : keys;
  const int len = MODEL ? keys : reps;  // cells of a line
  const size_t pitch = MODEL ? a.kp : n_rep;
  const size_t base = MODEL ? static_cast<size_t>(rep0) * a.kp + key0
                            : static_cast<size_t>(key0) * n_rep + rep0;
  // each line's 16-byte runs of present (states with pres16)
  constexpr int kRun16 = kLine / 16;
  const bool pres16 = MODEL && VEC && a.pres16;

  // 1. the tile in, asynchronously
  if (VEC) {
    constexpr int q4 = kLine / 4;
    for (int q = tid; q < lines * q4; q += kT) {
      const int ln = q / q4, c = q % q4 * 4;
      if (c < len) {
        const size_t g = base + ln * pitch + c;
        const int at = ln * kLine + c;
        cp_async16(s_v + at, a.vals_in + g);
        if (!MODEL)
          cp_async16(s_p + at, pres_in + g);
        else if (!pres16)
          cp_async4(s_p + at, pres_in + g);
      }
    }
    if (pres16) {
      for (int q = tid; q < lines * kRun16; q += kT) {
        const int ln = q / kRun16, c = q % kRun16 * 16;
        if (c < len)
          cp_async16(s_p + ln * kLine + c, pres_in + base + ln * pitch + c);
      }
    }
  } else {
    for (int q = tid; q < lines * kLine; q += kT) {
      const int ln = q / kLine, c = q % kLine;
      if (c < len) {
        const size_t g = base + ln * pitch + c;
        cp_async4(s_v + q, a.vals_in + g);
        if constexpr (MODEL)
          s_p[q] = pres_in[g];  // visible after the scan's barrier
        else
          cp_async4(s_p + q, pres_in + g);
      }
    }
  }
  const bool fen = FENCED && tid < reps && __ldg(a.fenced + rep0 + tid) > 0;

  // 2. the ring, while the tile lands
  if (APPEND && static_cast<int64_t>(blockIdx.x) * kT < a.cap) {
    ring_append_pass(static_cast<int64_t>(blockIdx.x) * kT + tid,
                     static_cast<int64_t>(gridDim.x) * kT, a.tail, a.count,
                     a.cap, a.arg_w, a.opc, a.batch_args, a.ring_opc_in,
                     a.ring_args_in, a.ring_opc_out, a.ring_args_out);
  }

  // 3. scan: thread tid reduces entries c0 + j * kT + tid; the next
  // chunk's keys are loaded while this one is replayed
  const size_t stride = APPEND ? static_cast<size_t>(a.arg_w) : 1;
  int32_t keys_j[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = j * kT + tid;
    keys_j[j] = e < window ? __ldg(a.key + e * stride) : 0;
  }
  for (int c0 = 0; c0 < window; c0 += kChunk) {
    unsigned hits[kPer];
    int32_t ent[kPer], arg[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int off = j * kT + tid;
      const int e = c0 + off;  // c0 + off < window < 2^31
      bool hit = false;
      ent[j] = arg[j] = 0;
      if (e < window) {
        int k = keys_j[j];
        if (static_cast<unsigned>(k) >= static_cast<unsigned>(n_keys)) {
          // floored modulo: C's % truncates toward zero
          k %= n_keys;
          if (k < 0) k += n_keys;
        }
        hit = static_cast<unsigned>(k - key0) <
              static_cast<unsigned>(keys);
        if (hit) {
          const int op = __ldg(a.opc + e);
          ent[j] = off << 8 | (k - key0) << 2 |
                   (op == 1 ? 1 : op == 2 ? 2 : 0);
          arg[j] = __ldg(a.val + e * stride);
        }
      }
      hits[j] = __ballot_sync(0xffffffffu, hit);
      keys_j[j] = e < window - kChunk
                      ? __ldg(a.key + (e + kChunk) * stride) : 0;
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        s_cnt[j * kWarps + warp] = __popc(hits[j]);
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
    for (int j = 0; j < kPer; ++j) {
      const int at0 =
          __shfl_sync(0xffffffffu, incl - cnt, j * kWarps + warp);
      if (hits[j] >> lane & 1u) {
        const int at = at0 + __popc(hits[j] & ((1u << lane) - 1u));
        s_ent[at] = ent[j];
        s_arg[at] = arg[j];
      }
    }
    cp_async_wait_all();  // this thread's part of the tile has landed
    __syncthreads();      // the list and the whole tile are visible

    // 4. replay: thread tid on replica rep0 + tid, the list in window
    // order; a fenced replica of the states keeps its cells and
    // answers 0
    if (tid < reps) {
      int32_t* out = MODEL ? a.resps + static_cast<size_t>(rep0 + tid) *
                                           window + c0
                           : a.resps + static_cast<size_t>(c0) * n_rep +
                                 rep0 + tid;
      const size_t out_step = MODEL ? 1 : n_rep;
      for (int i = 0; i < n_hit; ++i) {
        const int e = s_ent[i];
        const int kk = e >> 2 & 63;
        const int at = MODEL ? tid * kKeys + kk : kk * kT + tid;
        const int op = e & 3;
        int32_t r = 0;
        if (!(MODEL && fen)) {
          const int32_t p = s_p[at];
          if (op == 1) {
            s_v[at] = s_arg[i];
            s_p[at] = 1;
          } else if (op == 2) {
            s_v[at] = 0;
            s_p[at] = 0;
          }
          r = op == 2 ? p : 0;
        }
        out[static_cast<size_t>(e >> 8) * out_step] = r;
      }
    }
  }
  cp_async_wait_all();  // an empty window scanned nothing
  __syncthreads();      // every replica's replay is done

  // 6. the tile out
  if (VEC) {
    constexpr int q4 = kLine / 4;
    for (int q = tid; q < lines * q4; q += kT) {
      const int ln = q / q4, c = q % q4 * 4;
      if (c < len) {
        const size_t g = base + ln * pitch + c;
        const int at = ln * kLine + c;
        __stcs(reinterpret_cast<int4*>(a.vals_out + g),
               *reinterpret_cast<const int4*>(s_v + at));
        if (!MODEL)
          __stcs(reinterpret_cast<int4*>(pres_out + g),
                 *reinterpret_cast<const int4*>(s_p + at));
        else if (!pres16)
          __stcs(reinterpret_cast<int*>(pres_out + g),
                 *reinterpret_cast<const int*>(s_p + at));
      }
    }
    if (pres16) {
      for (int q = tid; q < lines * kRun16; q += kT) {
        const int ln = q / kRun16, c = q % kRun16 * 16;
        if (c < len) {
          const int at = ln * kLine + c;
          __stcs(reinterpret_cast<int4*>(pres_out + base + ln * pitch + c),
                 *reinterpret_cast<const int4*>(s_p + at));
        }
      }
    }
  } else {
    for (int q = tid; q < lines * kLine; q += kT) {
      const int ln = q / kLine, c = q % kLine;
      if (c < len) {
        const size_t g = base + ln * pitch + c;
        __stcs(a.vals_out + g, s_v[q]);
        if constexpr (MODEL)
          pres_out[g] = s_p[q];
        else
          __stcs(pres_out + g, s_p[q]);
      }
    }
  }
}

// K2 (its own entry, so that a profile tells the two kernels apart)
template <bool VEC>
__global__ void __launch_bounds__(Tile<false>::kThreads,
                                  Tile<false>::kBlocksPerSm)
hashmap_replay_kernel(const Round a) {
  tile_body<false, VEC, false, false>(a);
}

// K1
template <bool MODEL, bool VEC, bool FENCED>
__global__ void __launch_bounds__(Tile<MODEL>::kThreads,
                                  Tile<MODEL>::kBlocksPerSm)
hashmap_round_kernel(const Round a) {
  tile_body<MODEL, VEC, true, FENCED>(a);
}

template <bool MODEL, bool VEC, bool APPEND, bool FENCED>
cudaError_t launch_tile(int n_blocks, const Round& a, cudaStream_t s) {
  void (*kernel)(Round);
  if constexpr (APPEND)
    kernel = hashmap_round_kernel<MODEL, VEC, FENCED>;
  else
    kernel = hashmap_replay_kernel<VEC>;
  constexpr int smem = static_cast<int>(Tile<MODEL>::kSmem);
  // set on every call: the attributes belong to the current device
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, Tile<MODEL>::kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Fills in the tiling of `a` and launches the instantiation for its
// layout's alignment.
template <bool MODEL, bool APPEND, bool FENCED>
cudaError_t launch(Round a, cudaStream_t s) {
  using T = Tile<MODEL>;
  const int64_t key_tiles = (a.kp + T::kKeys - 1) / T::kKeys;
  const int64_t rep_tiles = (a.n_rep + T::kThreads - 1) / T::kThreads;
  a.n_ct = static_cast<int>(MODEL ? key_tiles : rep_tiles);
  const int64_t n_blocks = key_tiles * rep_tiles;
  // an append needs a block even where there is no tile
  if (n_blocks == 0) return APPEND ? cudaErrorInvalidValue : cudaSuccess;
  if (n_blocks > INT32_MAX) return cudaErrorInvalidValue;
  const int pitch = MODEL ? a.kp : a.n_rep;
  a.pres16 = MODEL && a.kp % 16 == 0;
  const bool vec = pitch % 4 == 0 && aligned16(a.vals_in) &&
                   aligned16(a.pres_in) && aligned16(a.vals_out) &&
                   aligned16(a.pres_out);
  const int nb = static_cast<int>(n_blocks);
  return vec ? launch_tile<MODEL, true, APPEND, FENCED>(nb, a, s)
             : launch_tile<MODEL, false, APPEND, FENCED>(nb, a, s);
}

}  // namespace

extern "C" {

// The planes' tile: writes its rows, columns and window chunk; returns
// its dynamic shared memory in bytes.
int nr_hashmap_replay_tile(int* rows, int* cols, int* chunk) {
  *rows = Tile<false>::kKeys;
  *cols = Tile<false>::kThreads;
  *chunk = Tile<false>::kChunk;
  return static_cast<int>(Tile<false>::kSmem);
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
      launch<false, false, false>(a, static_cast<cudaStream_t>(stream)));
}

// K1 over the states: values int32[n_rep, n_keys], present
// bool[n_rep, n_keys] (bytes 0/1), resps int32[n_rep, window]; a fenced
// replica keeps its state and answers 0.
int nr_hashmap_fused_round_model(
    const int32_t* opc, const int32_t* batch_args, int arg_w, int window,
    int n_keys, int n_rep, const int32_t* vals_in, const uint8_t* pres_in,
    int32_t* vals_out, uint8_t* pres_out, int32_t* resps,
    const int32_t* fenced, const int64_t* tail, int count, int cap,
    const int32_t* ring_opc_in, const int32_t* ring_args_in,
    int32_t* ring_opc_out, int32_t* ring_args_out, void* stream) {
  Round a{};
  a.opc = opc;
  a.key = batch_args;
  a.val = batch_args + 1;
  a.window = window;
  a.n_keys = n_keys;
  a.kp = n_keys;
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
  return static_cast<int>(fenced != nullptr ? launch<true, true, true>(a, s)
                                            : launch<true, true, false>(a, s));
}

}  // extern "C"
