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
// Here too they are one body: PLAN adds K7a's touched plane, APPEND adds
// K5's ring append (ring_append.cuh) to the decode pre-pass.
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
// inert with response 0. Frames are out of place, as in the reference.
// PLAN sets the touched plane on every written page and copies it
// through elsewhere.
//
// Design: the window is decoded once per launch and scanned once per
// (tile, replica group), never once per (replica, tile). Two kernels on
// one stream, one C call:
//   1. flat_decode_kernel, one thread per entry, writes to a scratch
//      buffer the entry's record and a 32-bit tile key, and zeroes its
//      response. The acting lanes are ONE interval [l0, l1): with
//      n <= max_span <= P < 2^30, lo > 0 means a0 < P, so 2^31 - a0 > n
//      and hi = n; otherwise lo = 0. So the record is (s | is-MAP << 30,
//      c, v) with s = (vm + l0) mod P the first page, c = l1 - l0 pages
//      (all distinct, c <= P) and v = a1 + l0 the first MAP value: page
//      (s + j) mod P gets v + j. The key is (s >> 10) << 1 | (the span
//      also meets the next tile, tile 0 after the last), all ones when
//      c = 0 (inert opcodes, n <= 0, vpages in [P, 2^31 - n]), and
//      kAllTiles for a span that meets three tiles or more (c > 1024, or
//      a wrap through a short last tile; never on the bench's spans of
//      at most 64): a superset, since the replay tests every page.
//      APPEND's threads also run the ring append (ring_append_pass) over
//      a grid of max(W, cap) threads.
//   2. flat_kernel: block (tile, group) owns pages [p0, p0 + 1024) of
//      `group` replica rows g0 .. g0 + group - 1 (group = min(kGroup, R)).
//      a. Row g0 of the tile comes into shared memory by cp.async
//         (16-byte copies; 4-byte ones when row_len % 4 != 0 or a plane is
//         not 16-byte aligned); a per-page flag byte is cleared.
//      b. Meanwhile the block scans the tile keys once, cooperatively, in
//         chunks of kChunk (each thread kPer keys, the next chunk's loaded
//         while this one replays): a ballot per warp and a prefix over the
//         32 per-warp counts keep, in window order, the entries that meet
//         the tile (hashmap_replay_kernel's compaction); only their records
//         are read. At R = 256, P = 2^18, W = 4096 a tile meets ~17.
//      c. Warp 0 replays that list on row g0 in shared memory, lane j
//         taking the span's pages in the tile j, j + 32, ..., at most two
//         runs (before and after the wrap through page 0). Each written
//         page gets its flag. Row 0's block adds its counts into the
//         zeroed responses (integer atomicAdd: exact in any order).
//      d. Every write stores a value that depends on the entry alone,
//         never on the row it lands in, and only the response reads the
//         row (replica 0's). So every row of the group ends equal to row
//         g0's replay on the flagged pages and to its own input elsewhere:
//         row g0 goes out from shared memory, rows g0 + 1 .. stream in
//         (16-byte loads, kUnroll in flight per thread), take the flagged
//         pages from the replayed row, and stream out (16-byte streaming
//         stores). PLAN streams the touched plane the same way
//         (touched_out = flag ? 1 : touched_in). This is the reference's
//         own plan/merge split (window_merge), inside one launch. Row
//         padding [P, row_len) is never flagged and is copied through.
//
// What bounds them: device-memory bytes, the tile copies moving the state
// in and out once (2 x 268 MB at R = 256, P = 2^18). The scan reads
// n_blocks x W x 4 B of tile keys from L2 (1024 blocks x 16 KiB at that
// shape), the replay ~17 entries on one row per block, in shared memory.
// A tile whose list is long (a hot spot) replays it serially, one warp,
// so its block's time grows with its list. The scratch is 20 B per
// entry: it grows with W, never with tiles x W.
//
// Dropped from the reference: its VMEM replica groups, the MAX_GRID
// replica chunking, the 4096-entry SMEM window chunks of the step paths
// (the kernels take any window in one launch), the copy_in un-aliasing
// (an aliased-block pipeline race of Mosaic), and the [ROWS, 128]
// padding of the fused round (K5 takes [R, P]).
//
// Plain C interface, loaded with ctypes (node_replication_torch/ops/
// vspace.py). Each entry point takes a scratch buffer of 5 * W int32
// (16-byte aligned) from its caller, launches both kernels on the given
// stream and returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ring_append.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kThreads = 256;  // replay block: 8 warps
constexpr int kWarps = kThreads / kLanes;
constexpr int kPer = 4;        // keys per thread a chunk
constexpr int kChunk = kThreads * kPer;  // entries scanned a pass
constexpr int kGroup = 64;     // replica rows per block
constexpr int kUnroll = 4;     // 16-byte loads in flight per thread
constexpr int kTileBits = 10;
constexpr int kTile = 1 << kTileBits;  // pages per tile
constexpr int kDecodeThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoTile = 0xffffffffu;    // a key that meets no tile
constexpr uint32_t kAllTiles = 0xfffffffeu;  // a key that meets every tile
constexpr int kMapBit = 30;    // record word 0: s | is-MAP << kMapBit
static_assert(kPer * kWarps == kLanes, "one count per lane");

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

// 1. One thread per entry: record, tile key, zeroed response; APPEND's
// grid also writes the ring, one slot a thread.
template <bool APPEND>
__global__ void __launch_bounds__(kDecodeThreads)
flat_decode_kernel(const int32_t* __restrict__ opc,
                   const int32_t* __restrict__ args, int arg_w, int window,
                   int n_pages, int max_span, int4* __restrict__ recs,
                   uint32_t* __restrict__ keys, int32_t* __restrict__ resps,
                   const int64_t* __restrict__ tail_ptr, int count, int cap,
                   const int32_t* __restrict__ ring_opc_in,
                   const int32_t* __restrict__ ring_args_in,
                   int32_t* __restrict__ ring_opc_out,
                   int32_t* __restrict__ ring_args_out) {
  const int i = blockIdx.x * kDecodeThreads + threadIdx.x;
  if (APPEND) {
    ring_append_pass(i, static_cast<int64_t>(gridDim.x) * kDecodeThreads,
                     tail_ptr, count, cap, arg_w, opc, args, ring_opc_in,
                     ring_args_in, ring_opc_out, ring_args_out);
  }
  if (i >= window) return;
  const int32_t* a = args + static_cast<size_t>(i) * arg_w;
  const int op = opc[i];
  const bool active = op == 1 || op == 2;
  const int n = active ? min(max(op == 2 ? a[1] : a[2], 0), max_span) : 0;
  // floored modulo: C's % truncates toward zero
  int vm = a[0] % n_pages;
  if (vm < 0) vm += n_pages;
  const long long vs = a[0];
  const int lo = static_cast<int>(
      min(max(static_cast<long long>(n_pages) - vs, 0LL),
          static_cast<long long>(n)));
  const int hi = static_cast<int>(
      min(max((1LL << 31) - vs, 0LL), static_cast<long long>(n)));
  const int l0 = lo > 0 ? 0 : hi;  // the acting lanes [l0, l1)
  const int l1 = lo > 0 ? lo : n;
  const int c = l1 - l0;
  int s = vm + l0;  // < 2P < 2^31
  if (s >= n_pages) s -= n_pages;
  uint32_t key = kNoTile;
  if (c > 0) {
    const int last_tile = (n_pages - 1) >> kTileBits;
    const int ts = s >> kTileBits;
    const bool wraps = s + c > n_pages;
    const int e = wraps ? s + c - 1 - n_pages : s + c - 1;  // last page
    const int te = e >> kTileBits;
    key = kAllTiles;
    if (!wraps && te - ts <= 1) {
      key = static_cast<uint32_t>(ts) << 1 | (te != ts);
    } else if (wraps && ts == last_tile && te == 0) {
      // tile 0 follows the last one; one tile when P <= kTile
      key = static_cast<uint32_t>(ts) << 1 | (last_tile != 0);
    }
  }
  keys[i] = key;
  const uint32_t v = static_cast<uint32_t>(a[1]) + static_cast<uint32_t>(l0);
  recs[i] = make_int4(s | (op == 1) << kMapBit, c, static_cast<int32_t>(v),
                      0);
  resps[i] = 0;
}

// 2. Block (tile, group), tile fastest. VEC: row_len % 4 == 0 and
// 16-byte aligned planes, so a tile row is whole int4s.
template <bool PLAN, bool VEC>
__global__ void __launch_bounds__(kThreads)
flat_kernel(const int4* __restrict__ recs, const uint32_t* __restrict__ keys,
            int window, int n_pages, int n_rep, int row_len, int n_tiles,
            int group, const int32_t* __restrict__ fr_in,
            int32_t* __restrict__ fr_out, const int32_t* __restrict__ tch_in,
            int32_t* __restrict__ tch_out, int32_t* __restrict__ resps) {
  __shared__ __align__(16) int32_t tile[kTile];  // row g0, replayed
  __shared__ __align__(16) uint8_t flag[kTile];  // per page, 1 = written
  __shared__ int4 s_list[kChunk];  // (s | is-MAP << 30, c, v, i)
  __shared__ int32_t s_cnt[kLanes];  // [kPer][kWarps] hits

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int warp = tid / kLanes;
  const int t = static_cast<int>(blockIdx.x % n_tiles);
  const int g0 = static_cast<int>(blockIdx.x / n_tiles) * group;
  const int rows = min(group, n_rep - g0);
  const int p0 = t * kTile;
  const int c1 = min(p0 + kTile, row_len) - p0;  // tile length, padding too
  const int p1 = min(p0 + kTile, n_pages);       // replay end
  const size_t base = static_cast<size_t>(g0) * row_len + p0;
  // the tile before this one, cyclically: its keys' next tile is t
  const int n_ptiles = (n_pages + kTile - 1) >> kTileBits;
  const uint32_t prev = static_cast<uint32_t>(t == 0 ? n_ptiles - 1 : t - 1);
  // a tile of padding only meets no entry
  const int scan_end = p0 < n_pages ? window : 0;

  // a. row g0 in, asynchronously; the flags cleared
  if (VEC) {
    for (int q = tid; q < c1 / 4; q += kThreads)
      cp_async16(tile + 4 * q, fr_in + base + 4 * q);
  } else {
    for (int q = tid; q < c1; q += kThreads)
      cp_async4(tile + q, fr_in + base + q);
  }
  for (int q = tid; q < kTile / 4; q += kThreads)
    reinterpret_cast<uint32_t*>(flag)[q] = 0;

  // b. scan: thread tid tests entries c0 + j * kThreads + tid
  uint32_t key[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = j * kThreads + tid;
    key[j] = e < scan_end ? __ldg(keys + e) : kNoTile;
  }
  for (int c0 = 0; c0 < scan_end; c0 += kChunk) {
    unsigned hits[kPer];
    int4 rec[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = c0 + j * kThreads + tid;
      const uint32_t k0 = key[j] >> 1;
      const bool hit = k0 == static_cast<uint32_t>(t)
          || ((key[j] & 1u) && k0 == prev) || key[j] == kAllTiles;
      if (hit) {
        rec[j] = __ldg(recs + e);
        rec[j].w = e;
      }
      hits[j] = __ballot_sync(kFull, hit);
      key[j] = e + kChunk < scan_end ? __ldg(keys + e + kChunk) : kNoTile;
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
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    const int n_hit = __shfl_sync(kFull, incl, kLanes - 1);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int at0 = __shfl_sync(kFull, incl - cnt, j * kWarps + warp);
      if (hits[j] >> lane & 1u)
        s_list[at0 + __popc(hits[j] & ((1u << lane) - 1u))] = rec[j];
    }
    cp_async_wait_all();  // this thread's part of row g0 has landed
    __syncthreads();      // the list and the whole row are visible

    // c. warp 0 replays the list on row g0, in window order
    if (warp != 0) continue;
    for (int h = 0; h < n_hit; ++h) {
      const int4 en = s_list[h];
      const bool is_map = (en.x >> kMapBit) != 0;
      const int s = en.x & ((1 << kMapBit) - 1);
      const int c = en.y;
      const uint32_t v = static_cast<uint32_t>(en.z);
      int cnt_i = 0;
      // the span's pages [s, s + c) mod P in [p0, p1): page p is lane
      // p - s before the wrap through page 0, p + P - s after it
#pragma unroll
      for (int run = 0; run < 2; ++run) {
        const int lo = run == 0 ? max(s, p0) : p0;
        const int hi = run == 0 ? min(min(s + c, n_pages), p1)
                                : min(s + c - n_pages, p1);
        const uint32_t j0 = static_cast<uint32_t>(
            run == 0 ? -s : n_pages - s);
        for (int p = lo + lane; p < hi; p += kLanes) {
          const int q = p - p0;
          const int old = tile[q];
          cnt_i += is_map ? old == 0 : old != 0;
          tile[q] = is_map
              ? static_cast<int32_t>(v + j0 + static_cast<uint32_t>(p))
              : 0;
          flag[q] = 1;
        }
      }
      if (g0 == 0) {  // replica 0's row: the response
        cnt_i = __reduce_add_sync(kFull, cnt_i);
        if (lane == 0 && cnt_i != 0) atomicAdd(&resps[en.w], cnt_i);
      }
      __syncwarp();  // this entry's stores before the next one's loads
    }
  }
  cp_async_wait_all();  // an empty scan waited for nothing
  __syncthreads();      // the replay is done

  // d. the group's rows out: row g0 is the replayed tile, every other
  // row its own input with the flagged pages taken from the tile
  if (VEC) {
    const int q4 = c1 / 4;
    const int n_out = rows * q4;
    const int4* t4 = reinterpret_cast<const int4*>(tile);
    const uint32_t* f4 = reinterpret_cast<const uint32_t*>(flag);
    for (int x0 = tid; x0 < n_out; x0 += kThreads * kUnroll) {
      int4 in[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int x = x0 + u * kThreads;
        const int j = x / q4;
        if (x < n_out && j > 0) {
          const size_t g = base + static_cast<size_t>(j) * row_len
                           + 4 * (x - j * q4);
          in[u] = __ldcs(reinterpret_cast<const int4*>(fr_in + g));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int x = x0 + u * kThreads;
        if (x >= n_out) break;
        const int j = x / q4, q = x - j * q4;
        const size_t g = base + static_cast<size_t>(j) * row_len + 4 * q;
        const uint32_t f = f4[q];
        const int4 tv = t4[q];
        int4 o = tv;
        if (j > 0) {
          o = in[u];
          if (f & 0xffu) o.x = tv.x;
          if (f & 0xff00u) o.y = tv.y;
          if (f & 0xff0000u) o.z = tv.z;
          if (f & 0xff000000u) o.w = tv.w;
        }
        __stcs(reinterpret_cast<int4*>(fr_out + g), o);
        if (PLAN) {
          int4 w = __ldcs(reinterpret_cast<const int4*>(tch_in + g));
          if (f & 0xffu) w.x = 1;
          if (f & 0xff00u) w.y = 1;
          if (f & 0xff0000u) w.z = 1;
          if (f & 0xff000000u) w.w = 1;
          __stcs(reinterpret_cast<int4*>(tch_out + g), w);
        }
      }
    }
  } else {
    const int n_out = rows * c1;
    for (int x = tid; x < n_out; x += kThreads) {
      const int j = x / c1, q = x - j * c1;
      const size_t g = base + static_cast<size_t>(j) * row_len + q;
      const bool f = flag[q] != 0;
      __stcs(fr_out + g, j == 0 || f ? tile[q] : __ldcs(fr_in + g));
      if (PLAN) __stcs(tch_out + g, f ? 1 : __ldcs(tch_in + g));
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool PLAN, bool APPEND>
int launch(const int32_t* opc, const int32_t* args, int arg_w, int window,
           int n_pages, int max_span, int n_rep, int row_len,
           const int32_t* fr_in, int32_t* fr_out, const int32_t* tch_in,
           int32_t* tch_out, int32_t* resps, int32_t* scratch,
           const int64_t* tail, int count, int cap,
           const int32_t* ring_opc_in, const int32_t* ring_args_in,
           int32_t* ring_opc_out, int32_t* ring_args_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!aligned16(scratch)) return static_cast<int>(cudaErrorInvalidValue);
  int4* recs = reinterpret_cast<int4*>(scratch);
  uint32_t* keys = reinterpret_cast<uint32_t*>(
      scratch + 4 * static_cast<size_t>(window));
  const int decode = APPEND ? max(window, cap) : window;
  if (decode > 0) {
    flat_decode_kernel<APPEND>
        <<<(decode + kDecodeThreads - 1) / kDecodeThreads, kDecodeThreads, 0,
           s>>>(opc, args, arg_w, window, n_pages, max_span, recs, keys,
                resps, tail, count, cap, ring_opc_in, ring_args_in,
                ring_opc_out, ring_args_out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_tiles = (row_len + kTile - 1) / kTile;
  const int group = min(kGroup, n_rep);
  const int64_t blocks =
      static_cast<int64_t>(n_tiles) * ((n_rep + group - 1) / group);
  bool vec = row_len % 4 == 0 && aligned16(fr_in) && aligned16(fr_out);
  if (PLAN) vec = vec && aligned16(tch_in) && aligned16(tch_out);
  decltype(&flat_kernel<PLAN, true>) kernel =
      vec ? &flat_kernel<PLAN, true> : &flat_kernel<PLAN, false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      recs, keys, window, n_pages, n_rep, row_len, n_tiles, group, fr_in,
      fr_out, tch_in, tch_out, resps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K4: frames[n_rep, row_len] in -> out, resps[window]; scratch[5 *
// window] int32, 16-byte aligned.
int nr_vspace_replay(const int32_t* opc, const int32_t* args, int arg_w,
                     int window, int n_pages, int max_span, int n_rep,
                     int row_len, const int32_t* fr_in, int32_t* fr_out,
                     int32_t* resps, int32_t* scratch, void* stream) {
  return launch<false, false>(
      opc, args, arg_w, window, n_pages, max_span, n_rep, row_len, fr_in,
      fr_out, nullptr, nullptr, resps, scratch, nullptr, 0, 0, nullptr,
      nullptr, nullptr, nullptr, stream);
}

// K7a: K4 plus the touched plane tch[n_rep, row_len] in -> out.
int nr_vspace_plan_replay(const int32_t* opc, const int32_t* args,
                          int arg_w, int window, int n_pages, int max_span,
                          int n_rep, int row_len, const int32_t* fr_in,
                          int32_t* fr_out, const int32_t* tch_in,
                          int32_t* tch_out, int32_t* resps,
                          int32_t* scratch, void* stream) {
  return launch<true, false>(
      opc, args, arg_w, window, n_pages, max_span, n_rep, row_len, fr_in,
      fr_out, tch_in, tch_out, resps, scratch, nullptr, 0, 0, nullptr,
      nullptr, nullptr, nullptr, stream);
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
                          int32_t* scratch, void* stream) {
  return launch<false, true>(
      opc, args, arg_w, window, n_pages, max_span, n_rep, row_len, fr_in,
      fr_out, nullptr, nullptr, resps, scratch, tail, count, cap,
      ring_opc_in, ring_args_in, ring_opc_out, ring_args_out, stream);
}

}  // extern "C"
