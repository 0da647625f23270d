// Flat vspace (page table) span replay kernels for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of the reference package, which share
// one body there (ops/pallas_vspace.py:_flat_body):
//   K4   node_replication_tpu/ops/pallas_vspace.py:_flat_kernel
//        (built by make_vspace_replay(radix=False), driven by
//        make_pallas_vspace_step)
//   K7a  node_replication_tpu/ops/pallas_vspace.py:_flat_plan_kernel
//        (make_vspace_plan_replay(radix=False),
//        make_pallas_vspace_plan_step)
//   K5   node_replication_tpu/ops/pallas_vspace.py:_fused_flat_kernel
//        (FusedVspaceEngine.round_fn)
// Here too they are one templated body: PLAN adds K7a's touched plane,
// APPEND adds K5's ring append (ring_append.cuh).
//
// What they compute. W entries (opcode, a0 = vpage, a1, a2) are replayed
// IN ORDER into every replica's page row frames[r, 0:P); a row is
// `row_len` >= P ints long (the model layout [R, P], or the reference's
// padded [R, ROWS, 128], whose padding is copied through). Only MAP (1)
// and UNMAP (2) act: n = clip(UNMAP ? a1 : a2, 0, max_span) and
// vm = a0 mod P (floored). Span lane l < n touches page (vm + l) mod P
// when the int32 sum a0 + l, wrapping as in the reference, is < P; that
// is l < lo or l >= hi with lo = clip(P - a0, 0, n) and
// hi = clip(2^31 - a0, 0, n), computed in 64 bits. MAP stores a1 + l
// (int32 wrap, computed unsigned), UNMAP stores 0. The response counts
// the span's pages that were unmapped (MAP) or mapped (UNMAP) before the
// entry on replica 0: one canonical copy, which speaks for the fleet
// under the lock-step invariant, as in the reference. Other opcodes are
// inert with response 0. Frames are out of place, as in the reference:
// the input is copied to the output, then replayed. PLAN copies the
// touched plane in->out the same way and sets it on every written page.
//
// Layout and parallelism. Replicas are independent, but R = 256 alone
// gives 256 warps. Entries commute unless their spans share pages, so
// each row is cut into tiles of kTile pages: warp (r, tile) owns
// frames[r, tile*kTile : (tile+1)*kTile), loads it into its own slice of
// shared memory, replays there, in window order, exactly the entries
// whose span meets its tile, and writes the tile out. Every cell has one
// owner warp, so the state needs no atomics and no ordering between
// blocks, and each entry's read-modify-write is a shared-memory access,
// not a dependent device-memory round trip. A span can meet more than
// one tile, so its response is a sum of per-tile counts: replica 0's
// warps add theirs with an integer atomicAdd into responses zeroed
// before the launch, exact in any order. Inside a warp, lane j takes
// span lanes l = j, j + 32, ...; the count is a warp reduction;
// __syncwarp() between entries orders one entry's stores before the
// next one's loads. The window is staged through shared memory in chunks
// of kChunk entries, pre-reduced (vm, n, lo, hi, a1, is-MAP); a warp
// tests 32 staged entries at once with a ballot and walks the hits in
// order. K7a runs at R = 1: P / kTile warps (256 at P = 2^18).
//
// What bounds them. Device-memory bytes: the tile copies move the whole
// state in and out once (2 x 268 MB at R = 256, P = 2^18); the replay
// itself stays in shared memory (PLAN's touched stores go to device
// memory, but nothing waits on them). Each block also stages the whole
// window and each warp scans it, a cost in instructions that grows with
// W x R x P / kTile.
//
// Dropped from the reference: its VMEM replica groups, the MAX_GRID
// replica chunking, the 4096-entry SMEM window chunks of the step paths
// (the kernel stages its own window, so any window is one launch), the
// copy_in un-aliasing (an aliased-block pipeline race of Mosaic), and
// the [ROWS, 128] padding of the fused round (K5 takes [R, P]).
//
// Plain C interface, loaded with ctypes (node_replication_torch/ops/
// vspace.py). Each entry point zeroes the responses, launches on the
// given stream and returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ring_append.cuh"

namespace {

constexpr int kLanes = 32;    // threads per warp (blockDim.x)
constexpr int kWarps = 8;     // (replica, tile) warps per block
constexpr int kTile = 1024;   // pages per warp, held in shared memory
constexpr int kChunk = 512;   // window entries staged per pass
constexpr int kUnroll = 4;    // loads in flight per lane in the copies
constexpr unsigned kFull = 0xffffffffu;

template <bool PLAN, bool APPEND>
__global__ void __launch_bounds__(kLanes * kWarps)
vspace_round_kernel(
    const int32_t* __restrict__ opc, const int32_t* __restrict__ args,
    int arg_w, int window, int n_pages, int max_span, int n_rep,
    int row_len, int n_tiles, const int32_t* __restrict__ fr_in,
    int32_t* __restrict__ fr_out, const int32_t* __restrict__ tch_in,
    int32_t* __restrict__ tch_out, int32_t* __restrict__ resps,
    const int64_t* __restrict__ tail_ptr, int count, int cap,
    const int32_t* __restrict__ ring_opc_in,
    const int32_t* __restrict__ ring_args_in,
    int32_t* __restrict__ ring_opc_out,
    int32_t* __restrict__ ring_args_out) {
  __shared__ int32_t s_tile[kWarps][kTile];
  __shared__ int32_t s_vm[kChunk];
  __shared__ int32_t s_n[kChunk];  // span length, 0 for inert entries
  __shared__ int32_t s_lo[kChunk];
  __shared__ int32_t s_hi[kChunk];
  __shared__ int32_t s_val[kChunk];
  __shared__ int8_t s_map[kChunk];

  const int lane = threadIdx.x;
  const int tid = threadIdx.y * kLanes + lane;
  const int nthreads = kLanes * kWarps;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.y;
  const int r = static_cast<int>(warp / n_tiles);
  const bool live = r < n_rep;  // warp-uniform
  const int p0 = static_cast<int>(warp % n_tiles) * kTile;
  const int c1 = min(p0 + kTile, row_len) - p0;  // tile length, padding too
  const int p1 = min(p0 + kTile, n_pages);       // replay end
  const size_t row = static_cast<size_t>(live ? r : 0) * row_len + p0;
  int32_t* tile = s_tile[threadIdx.y];

  if (APPEND) {
    ring_append_pass(static_cast<int64_t>(blockIdx.x) * nthreads + tid,
                     static_cast<int64_t>(gridDim.x) * nthreads, tail_ptr,
                     count, cap, arg_w, opc, args, ring_opc_in,
                     ring_args_in, ring_opc_out, ring_args_out);
  }

  if (live) {
    for (int q = lane; q < c1; q += kLanes * kUnroll) {
      int32_t v[kUnroll], tv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = q + u * kLanes;
        v[u] = p < c1 ? fr_in[row + p] : 0;
        if (PLAN) tv[u] = p < c1 ? tch_in[row + p] : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = q + u * kLanes;
        if (p < c1) {
          tile[p] = v[u];
          if (PLAN) tch_out[row + p] = tv[u];
        }
      }
    }
  }
  __syncwarp();

  for (int c0 = 0; c0 < window; c0 += kChunk) {
    const int cn = min(kChunk, window - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < cn; i += nthreads) {
      const int32_t* a = args + static_cast<size_t>(c0 + i) * arg_w;
      const int op = opc[c0 + i];
      const bool active = op == 1 || op == 2;
      const int n = active ? min(max(op == 2 ? a[1] : a[2], 0), max_span)
                           : 0;
      // floored modulo: C's % truncates toward zero
      int vm = a[0] % n_pages;
      if (vm < 0) vm += n_pages;
      const long long vs = a[0];
      s_vm[i] = vm;
      s_n[i] = n;
      s_lo[i] = static_cast<int>(
          min(max(static_cast<long long>(n_pages) - vs, 0LL),
              static_cast<long long>(n)));
      s_hi[i] = static_cast<int>(
          min(max((1LL << 31) - vs, 0LL), static_cast<long long>(n)));
      s_val[i] = a[1];
      s_map[i] = op == 1;
    }
    __syncthreads();
    if (!live) continue;
    for (int j0 = 0; j0 < cn; j0 += kLanes) {
      const int j = j0 + lane;
      bool hit = false;
      if (j < cn) {
        const int n = s_n[j];
        const int vm = s_vm[j];
        // [vm, vm + n) or its wrapped part [0, vm + n - P) meets [p0, p1)
        hit = n > 0 && ((vm < p1 && vm + n > p0) || vm + n - n_pages > p0);
      }
      unsigned todo = __ballot_sync(kFull, hit);
      while (todo) {
        const int i = j0 + __ffs(todo) - 1;
        todo &= todo - 1;
        const int vm = s_vm[i], n = s_n[i], lo = s_lo[i], hi = s_hi[i];
        const bool is_map = s_map[i] != 0;
        const uint32_t base = static_cast<uint32_t>(s_val[i]);
        int cnt = 0;
        for (int l = lane; l < n; l += kLanes) {
          int pg = vm + l;
          if (pg >= n_pages) pg -= n_pages;
          if ((l < lo || l >= hi) && pg >= p0 && pg < p1) {
            const int t = pg - p0;
            cnt += is_map ? tile[t] == 0 : tile[t] != 0;
            tile[t] = is_map
                ? static_cast<int32_t>(base + static_cast<uint32_t>(l))
                : 0;
            if (PLAN) tch_out[row + t] = 1;
          }
        }
        if (r == 0) {
          cnt = __reduce_add_sync(kFull, cnt);
          if (lane == 0 && cnt != 0) atomicAdd(&resps[c0 + i], cnt);
        }
        __syncwarp();
      }
    }
  }

  if (live) {
    __syncwarp();
    for (int p = lane; p < c1; p += kLanes) fr_out[row + p] = tile[p];
  }
}

template <bool PLAN, bool APPEND>
int launch(const int32_t* opc, const int32_t* args, int arg_w, int window,
           int n_pages, int max_span, int n_rep, int row_len,
           const int32_t* fr_in, int32_t* fr_out, const int32_t* tch_in,
           int32_t* tch_out, int32_t* resps, const int64_t* tail,
           int count, int cap, const int32_t* ring_opc_in,
           const int32_t* ring_args_in, int32_t* ring_opc_out,
           int32_t* ring_args_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      resps, 0, static_cast<size_t>(window) * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (row_len + kTile - 1) / kTile;
  const int64_t warps = static_cast<int64_t>(n_rep) * n_tiles;
  const dim3 grid(static_cast<unsigned>((warps + kWarps - 1) / kWarps));
  vspace_round_kernel<PLAN, APPEND><<<grid, dim3(kLanes, kWarps), 0, s>>>(
      opc, args, arg_w, window, n_pages, max_span, n_rep, row_len, n_tiles,
      fr_in, fr_out, tch_in, tch_out, resps, tail, count, cap, ring_opc_in,
      ring_args_in, ring_opc_out, ring_args_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K4: frames[n_rep, row_len] in -> out, resps[window].
int nr_vspace_replay(const int32_t* opc, const int32_t* args, int arg_w,
                     int window, int n_pages, int max_span, int n_rep,
                     int row_len, const int32_t* fr_in, int32_t* fr_out,
                     int32_t* resps, void* stream) {
  return launch<false, false>(
      opc, args, arg_w, window, n_pages, max_span, n_rep, row_len, fr_in,
      fr_out, nullptr, nullptr, resps, nullptr, 0, 0, nullptr, nullptr,
      nullptr, nullptr, stream);
}

// K7a: K4 plus the touched plane tch[n_rep, row_len] in -> out.
int nr_vspace_plan_replay(const int32_t* opc, const int32_t* args,
                          int arg_w, int window, int n_pages, int max_span,
                          int n_rep, int row_len, const int32_t* fr_in,
                          int32_t* fr_out, const int32_t* tch_in,
                          int32_t* tch_out, int32_t* resps, void* stream) {
  return launch<true, false>(
      opc, args, arg_w, window, n_pages, max_span, n_rep, row_len, fr_in,
      fr_out, tch_in, tch_out, resps, nullptr, 0, 0, nullptr, nullptr,
      nullptr, nullptr, stream);
}

// K5: the ring append of batch entries j < count at slots
// (tail + j) & (cap - 1), then K4 over the whole batch.
int nr_vspace_fused_round(const int32_t* opc, const int32_t* args,
                          int arg_w, int window, int n_pages, int max_span,
                          int n_rep, int row_len, const int32_t* fr_in,
                          int32_t* fr_out, int32_t* resps,
                          const int64_t* tail, int count, int cap,
                          const int32_t* ring_opc_in,
                          const int32_t* ring_args_in,
                          int32_t* ring_opc_out, int32_t* ring_args_out,
                          void* stream) {
  return launch<false, true>(
      opc, args, arg_w, window, n_pages, max_span, n_rep, row_len, fr_in,
      fr_out, nullptr, nullptr, resps, tail, count, cap, ring_opc_in,
      ring_args_in, ring_opc_out, ring_args_out, stream);
}

}  // extern "C"
