// Radix vspace (4-level page table) replay kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the reference package, which share
// one body there (ops/pallas_vspace.py:_radix_body):
//   K6   node_replication_tpu/ops/pallas_vspace.py:_radix_kernel
//        (built by make_vspace_replay(radix=True), driven by
//        make_pallas_vspace_step(radix=True))
//   K7b  node_replication_tpu/ops/pallas_vspace.py:_radix_plan_kernel
//        (make_vspace_plan_replay(radix=True),
//        make_pallas_vspace_plan_step(radix=True))
// Here too they are one templated body: PLAN adds K7b's delta planes.
//
// What they compute. W entries (opcode, a0 = vpage, a1, a2) are replayed
// IN ORDER into every replica's page table pt[r, 0:P) (a row is
// `row_len` >= P ints: the model layout [R, P] or the reference's padded
// [R, ROWS, 128], whose padding is copied through) and into ONE
// canonical copy of the level tables pd[l2], pdpt[l3], pml4[1]
// (P <= 2^27, so every page's PML4 entry is 0). vs = a0 mod P
// (floored). Before each entry, page p is WALKED when pml4[0] > 0,
// pdpt[p >> 18] > 0, pd[p >> 9] > 0 and pt[p] != 0. MAP (1) and
// MAP_DEVICE (2) act on the span [vs, min(vs + n, P)), n =
// clip(a2, 0, max_span), storing ((a1 + (p - vs) + 1) & FRAME_MASK),
// with DEV_BIT for MAP_DEVICE (computed unsigned); UNMAP (3) stores 0
// on its span, n = clip(a1, 0, max_span); UNMAP_TABLE (4) stores 0 on
// the 512-page region of vs (pages < P). The response, replica 0's,
// counts the span's pages NOT walked (maps), walked (unmap), or the
// region's walked pages (teardown). Then the levels: a MAP with n > 0
// sets pd[vs >> 9], pd[(vs >> 9) + 1] when the span's last page reaches
// that region and it is < l2, pdpt[vs >> 18] and pdpt[last >> 18] where
// < l3, and pml4[0]; a teardown clears pd[vs >> 9] (set or not). Other
// opcodes are inert with response 0. PLAN (K7b, R = 1) also carries
// `wins` (set on span pages, reset on torn-down regions), `clr` (set on
// torn-down regions) and `pdt` (set on every PD entry a MAP marks or a
// teardown clears); untouched cells keep their input values.
//
// Design: the window is decoded once per launch and tested once per
// (tile, replica group), never once per (replica, tile). Two kernels on
// one stream, one C call:
//   1. radix_decode_kernel, one thread per entry, writes to a scratch
//      buffer the entry's record (vs | kind << 28, n, a1) and a 32-bit
//      tile key: (vs >> 10) << 1 | (the span's last page < P lies in the
//      next 1024-page tile), all ones for an entry that writes no page
//      (inert opcodes, spans of n <= 0). It zeroes the responses and
//      finds, by atomicMin (order-free, so deterministic), first[0], the
//      first live MAP (n > 0), and first[1 + k], the first live MAP whose
//      vs >> 18 or last >> 18 (where < l3) is k. The entry point memsets
//      `first` to 0x7f7f7f7f, above any W, before the launch.
//   2. radix_kernel: block (tile, group) owns pages [p0, p0 + 1024) of
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
//      c. Warp 0 replays that list on row g0 in shared memory, tracking
//         the tile's two PD entries (ra, rb) in registers; every entry that
//         updates them meets the tile (a MAP's span runs through every
//         region it marks, at a page < P; a teardown's region is in the
//         tile). The walk's upper levels need no list entry: before entry
//         i they are on when (pml4_in[0] > 0 || first[0] < i) &&
//         (pdpt_in[kk] > 0 || first[1 + kk] < i), kk the tile's PDPT
//         entry; strict, so the MAP at first[0] walks with the levels it
//         found. Row 0's block adds its counts into the zeroed responses
//         (integer atomicAdd: an entry meets at most two tiles).
//         Each replayed page gets a flag byte (kWinsSet on span pages,
//         kWinsReset | kClrSet on torn-down ones: K7b's delta state).
//      d. Every write stores a value that depends on the entry alone,
//         never on the row it lands in, and only the response reads the
//         row (replica 0's). So every row of the group ends equal to row
//         g0's replay on the flagged pages and to its own input elsewhere:
//         row g0 goes out from shared memory, rows g0 + 1 .. stream in
//         (16-byte loads, kUnroll in flight per thread), take the flagged
//         pages from the replayed row, and stream out (16-byte streaming
//         stores). This is the reference's own plan/merge split
//         (window_merge), inside one launch.
//   The levels: block 0 writes pdpt_out[k] = first[1 + k] < W ? 1 :
//   pdpt_in[k] and pml4_out likewise (no in->out copies, no set-only
//   stores); the tile's group-0 block owns pd_out[ra], pd_out[rb] (and
//   K7b's pdt_out). Every output cell has one writer.
//
// What bounds them: device-memory bytes, the tile copies moving pt in and
// out once (2 x 268 MB at R = 256, P = 2^18). The scan reads
// n_blocks x W x 4 B of tile keys from L2 (1024 blocks x 16 KiB at that
// shape), the replay ~17 entries on one row per block, in shared memory.
// A tile whose list is long (a hot spot) replays it serially, one warp,
// so its block's time grows with its list. The rows other than g0 pass
// through registers, not shared memory: 64 rows a block keep many blocks
// of 21.6 KB resident, and staging 16 rows by cp.async measured slower on
// the card. The scratch is 20 B per entry plus (1 + l3) ints: it grows
// with W, never with tiles x W.
//
// Dropped from the reference: its VMEM replica groups and MAX_GRID
// chunks (which recompute the canonical levels once per grid step), the
// 4096-entry SMEM window chunks of the step paths, the copy_in
// un-aliasing (an aliased-block pipeline race of Mosaic), and the
// [ROWS, 128] padding of the plan planes (K7b takes [1, P]).
//
// Plain C interface, loaded with ctypes (node_replication_torch/ops/
// vspace.py). Each entry point takes a scratch buffer of
// 5 * W + 1 + l3 int32 (16-byte aligned) from its caller, launches both
// kernels on the given stream and returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kThreads = 256;  // replay block: 8 warps
constexpr int kWarps = kThreads / kLanes;
constexpr int kPer = 4;        // keys per thread a chunk
constexpr int kChunk = kThreads * kPer;  // entries scanned a pass
constexpr int kGroup = 64;     // replica rows per block
constexpr int kUnroll = 4;     // 16-byte loads in flight per thread
constexpr int kTile = 1024;    // pages per tile: two PD entries
constexpr int kDecodeThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoTile = 0xffffffffu;  // a key that meets no tile
constexpr int kVsBits = 28;    // record word 0: vs | kind << kVsBits
constexpr uint32_t kFrameMask = (1u << 30) - 1;
constexpr uint32_t kDevBit = 1u << 30;
constexpr int kFirstFill = 0x7f;  // first[] bytes before the decode
// per-page flag bytes (K7b's delta state; nonzero = written)
constexpr uint8_t kWinsSet = 1;    // wins := 1
constexpr uint8_t kWinsReset = 2;  // wins := 0
constexpr uint8_t kClrSet = 4;     // clr := 1
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

// 1. One thread per entry: record, tile key, zeroed response, first[].
__global__ void __launch_bounds__(kDecodeThreads)
radix_decode_kernel(const int32_t* __restrict__ opc,
                    const int32_t* __restrict__ args, int arg_w,
                    int window, int n_pages, int max_span, int l3,
                    int4* __restrict__ recs, uint32_t* __restrict__ keys,
                    int32_t* __restrict__ first,
                    int32_t* __restrict__ resps) {
  const int i = blockIdx.x * kDecodeThreads + threadIdx.x;
  const int lane = threadIdx.x % kLanes;
  bool live = false;
  int k0 = -1, k1 = -1;  // the PDPT entries a live MAP sets
  if (i < window) {
    const int32_t* a = args + static_cast<size_t>(i) * arg_w;
    const int op = opc[i];
    const int kind = op >= 1 && op <= 4 ? op : 0;
    const int n = kind >= 1 && kind <= 3
        ? min(max(kind == 3 ? a[1] : a[2], 0), max_span) : 0;
    // floored modulo: C's % truncates toward zero
    int vs = a[0] % n_pages;
    if (vs < 0) vs += n_pages;
    uint32_t key = kNoTile;
    if (kind == 4) {
      key = static_cast<uint32_t>(vs >> 10) << 1;
    } else if (kind != 0 && n > 0) {
      const int hi = min(vs + n, n_pages) - 1;  // the last page acted on
      key = static_cast<uint32_t>(vs >> 10) << 1 | ((hi >> 10) != (vs >> 10));
    }
    keys[i] = key;
    recs[i] = make_int4(vs | kind << kVsBits, n, a[1], 0);
    resps[i] = 0;
    live = (kind == 1 || kind == 2) && n > 0;
    if (live) {
      const int last = vs + n - 1;
      k0 = vs >> 18;
      if ((last >> 18) < l3 && (last >> 18) != k0) k1 = last >> 18;
    }
  }
  // a warp's lanes hold consecutive entries: its lowest lane of a kind
  // holds the smallest index, so one atomic per warp and PDPT entry
  const unsigned any = __ballot_sync(kFull, live);
  if (any && lane == __ffs(any) - 1) atomicMin(&first[0], i);
  const unsigned m0 = __match_any_sync(kFull, k0);
  if (k0 >= 0 && lane == __ffs(m0) - 1) atomicMin(&first[1 + k0], i);
  const unsigned m1 = __match_any_sync(kFull, k1);
  if (k1 >= 0 && lane == __ffs(m1) - 1) atomicMin(&first[1 + k1], i);
}

// PLAN's write-out of one page: wins and clr from the flag byte.
__device__ __forceinline__ int32_t wins_of(uint32_t f, int32_t in) {
  return (f & kWinsSet) ? 1 : (f & kWinsReset) ? 0 : in;
}

__device__ __forceinline__ int32_t clr_of(uint32_t f, int32_t in) {
  return (f & kClrSet) ? 1 : in;
}

// 2. Block (tile, group), tile fastest. VEC: row_len % 4 == 0 and
// 16-byte aligned planes, so a tile row is whole int4s.
template <bool PLAN, bool VEC>
__global__ void __launch_bounds__(kThreads)
radix_kernel(
    const int4* __restrict__ recs, const uint32_t* __restrict__ keys,
    const int32_t* __restrict__ first, int window, int n_pages, int n_rep,
    int row_len, int n_tiles, int group, int l2, int l3,
    const int32_t* __restrict__ pt_in, int32_t* __restrict__ pt_out,
    const int32_t* __restrict__ pd_in, int32_t* __restrict__ pd_out,
    const int32_t* __restrict__ pdpt_in, int32_t* __restrict__ pdpt_out,
    const int32_t* __restrict__ pml4_in, int32_t* __restrict__ pml4_out,
    const int32_t* __restrict__ wins_in, int32_t* __restrict__ wins_out,
    const int32_t* __restrict__ clr_in, int32_t* __restrict__ clr_out,
    const int32_t* __restrict__ pdt_in, int32_t* __restrict__ pdt_out,
    int32_t* __restrict__ resps) {
  __shared__ __align__(16) int32_t tile[kTile];    // row g0, replayed
  __shared__ __align__(16) uint8_t flag[kTile];    // per page, 0 = untouched
  __shared__ int4 s_list[kChunk];  // (vs | kind << 28, n, a1, i)
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

  // a. row g0 in, asynchronously; the flags cleared
  if (VEC) {
    for (int q = tid; q < c1 / 4; q += kThreads)
      cp_async16(tile + 4 * q, pt_in + base + 4 * q);
  } else {
    for (int q = tid; q < c1; q += kThreads)
      cp_async4(tile + q, pt_in + base + q);
  }
  for (int q = tid; q < kTile / 4; q += kThreads)
    reinterpret_cast<uint32_t*>(flag)[q] = 0;

  // the upper levels: one writer, from the decode's first[]
  if (blockIdx.x == 0) {
    for (int k = tid; k < l3; k += kThreads)
      pdpt_out[k] = first[1 + k] < window ? 1 : pdpt_in[k];
    if (tid == 0) pml4_out[0] = first[0] < window ? 1 : pml4_in[0];
  }
  // before entry i the tile's upper levels are on when i > wal
  const int kk = min(p0 >> 18, l3 - 1);
  const int wal = max(pml4_in[0] > 0 ? -1 : first[0],
                      pdpt_in[kk] > 0 ? -1 : first[1 + kk]);
  // the tile's two PD entries, tracked in warp 0's registers
  const int ra = p0 >> 9, rb = ra + 1;
  int pd_a = 0, pd_b = 0, pdt_a = 0, pdt_b = 0;
  if (warp == 0) {
    pd_a = ra < l2 ? pd_in[ra] : 0;
    pd_b = rb < l2 ? pd_in[rb] : 0;
    if (PLAN) {
      pdt_a = ra < l2 ? pdt_in[ra] : 0;
      pdt_b = rb < l2 ? pdt_in[rb] : 0;
    }
  }

  // b. scan: thread tid tests entries c0 + j * kThreads + tid
  uint32_t key[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = j * kThreads + tid;
    key[j] = e < window ? __ldg(keys + e) : kNoTile;
  }
  for (int c0 = 0; c0 < window; c0 += kChunk) {
    unsigned hits[kPer];
    int4 rec[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = c0 + j * kThreads + tid;
      const uint32_t lo = key[j] >> 1;
      const bool hit = lo == static_cast<uint32_t>(t)
          || ((key[j] & 1u) && lo + 1 == static_cast<uint32_t>(t));
      if (hit) {
        rec[j] = __ldg(recs + e);
        rec[j].w = e;
      }
      hits[j] = __ballot_sync(kFull, hit);
      key[j] = e + kChunk < window ? __ldg(keys + e + kChunk) : kNoTile;
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
      const int kind = en.x >> kVsBits;
      const int vs = en.x & ((1 << kVsBits) - 1);
      const int n = en.y, i = en.w;
      const bool up = i > wal;  // the walk reads pre-op levels
      int cnt_i = 0;
      if (kind == 4) {
        const int lo = (vs >> 9) << 9;
        const int pdr = (vs >> 9) == ra ? pd_a : pd_b;
        const int end = min(lo + 512, n_pages);
        for (int p = lo + lane; p < end; p += kLanes) {
          const int q = p - p0;
          cnt_i += up && pdr > 0 && tile[q] != 0;
          tile[q] = 0;
          flag[q] = kWinsReset | kClrSet;
        }
      } else {
        const bool is_map = kind != 3;
        const uint32_t v0 = static_cast<uint32_t>(en.z) + 1u;
        const uint32_t dev = kind == 2 ? kDevBit : 0u;
        const int hi = min(vs + n, p1);
        for (int p = max(vs, p0) + lane; p < hi; p += kLanes) {
          const int q = p - p0;
          const int pdv = (p >> 9) == ra ? pd_a : pd_b;
          const bool walk = up && pdv > 0 && tile[q] != 0;
          cnt_i += is_map ? !walk : walk;
          tile[q] = is_map
              ? static_cast<int32_t>(
                    ((v0 + static_cast<uint32_t>(p - vs)) & kFrameMask) | dev)
              : 0;
          flag[q] = (flag[q] & kClrSet) | kWinsSet;
        }
      }
      if (g0 == 0) {  // replica 0's row: the response
        cnt_i = __reduce_add_sync(kFull, cnt_i);
        if (lane == 0 && cnt_i != 0) atomicAdd(&resps[i], cnt_i);
      }
      // the level updates (warp-uniform registers)
      const int r0 = vs >> 9;
      if (kind == 4) {
        if (r0 == ra) {
          pd_a = 0;
          pdt_a = 1;
        } else if (r0 == rb) {
          pd_b = 0;
          pdt_b = 1;
        }
      } else if (kind != 3) {  // a span of n > 0 that meets the tile
        const bool mark1 = r0 + 1 < l2 && r0 + 1 <= ((vs + n - 1) >> 9);
        if (r0 == ra || (mark1 && r0 + 1 == ra)) {
          pd_a = 1;
          pdt_a = 1;
        }
        if (r0 == rb || (mark1 && r0 + 1 == rb)) {
          pd_b = 1;
          pdt_b = 1;
        }
      }
      __syncwarp();  // this entry's stores before the next one's loads
    }
  }
  cp_async_wait_all();  // an empty window scanned nothing
  __syncthreads();      // the replay is done

  if (g0 == 0 && tid == 0) {  // the one owner of pd[ra], pd[rb]
    if (ra < l2) pd_out[ra] = pd_a;
    if (rb < l2) pd_out[rb] = pd_b;
    if (PLAN) {
      if (ra < l2) pdt_out[ra] = pdt_a;
      if (rb < l2) pdt_out[rb] = pdt_b;
    }
  }

  // d. the group's rows out: row g0 is the replayed tile, every other
  // row its own input with the flagged pages taken from the tile
  if (VEC) {
    const int q4 = c1 / 4;
    const int n_out = rows * q4;
    const int4* t4 = reinterpret_cast<const int4*>(tile);
    const uint32_t* f4 = reinterpret_cast<const uint32_t*>(flag);
    for (int x0 = tid; x0 < n_out; x0 += kThreads * kUnroll) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int x = x0 + u * kThreads;
        const int j = x / q4;
        if (x < n_out && j > 0) {
          const size_t g = base + static_cast<size_t>(j) * row_len
                           + 4 * (x - j * q4);
          v[u] = __ldcs(reinterpret_cast<const int4*>(pt_in + g));
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
          o = v[u];
          if (f & 0xffu) o.x = tv.x;
          if (f & 0xff00u) o.y = tv.y;
          if (f & 0xff0000u) o.z = tv.z;
          if (f & 0xff000000u) o.w = tv.w;
        }
        __stcs(reinterpret_cast<int4*>(pt_out + g), o);
        if (PLAN) {
          int4 w = __ldcs(reinterpret_cast<const int4*>(wins_in + g));
          int4 c = __ldcs(reinterpret_cast<const int4*>(clr_in + g));
          w = make_int4(wins_of(f & 0xffu, w.x), wins_of(f >> 8 & 0xffu, w.y),
                        wins_of(f >> 16 & 0xffu, w.z), wins_of(f >> 24, w.w));
          c = make_int4(clr_of(f & 0xffu, c.x), clr_of(f >> 8 & 0xffu, c.y),
                        clr_of(f >> 16 & 0xffu, c.z), clr_of(f >> 24, c.w));
          __stcs(reinterpret_cast<int4*>(wins_out + g), w);
          __stcs(reinterpret_cast<int4*>(clr_out + g), c);
        }
      }
    }
  } else {
    const int n_out = rows * c1;
    for (int x = tid; x < n_out; x += kThreads) {
      const int j = x / c1, q = x - j * c1;
      const size_t g = base + static_cast<size_t>(j) * row_len + q;
      const uint32_t f = flag[q];
      __stcs(pt_out + g, j == 0 || f ? tile[q] : __ldcs(pt_in + g));
      if (PLAN) {
        __stcs(wins_out + g, wins_of(f, __ldcs(wins_in + g)));
        __stcs(clr_out + g, clr_of(f, __ldcs(clr_in + g)));
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool PLAN>
int launch(const int32_t* opc, const int32_t* args, int arg_w, int window,
           int n_pages, int max_span, int n_rep, int row_len,
           const int32_t* pt_in, int32_t* pt_out, const int32_t* pd_in,
           int32_t* pd_out, const int32_t* pdpt_in, int32_t* pdpt_out,
           const int32_t* pml4_in, int32_t* pml4_out,
           const int32_t* wins_in, int32_t* wins_out, const int32_t* clr_in,
           int32_t* clr_out, const int32_t* pdt_in, int32_t* pdt_out,
           int32_t* resps, int32_t* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int l2 = (n_pages + 511) / 512;
  const int l3 = (n_pages + (1 << 18) - 1) >> 18;
  if (!aligned16(scratch)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t w = static_cast<size_t>(window);
  int4* recs = reinterpret_cast<int4*>(scratch);
  uint32_t* keys = reinterpret_cast<uint32_t*>(scratch + 4 * w);
  int32_t* first = scratch + 5 * w;
  cudaError_t err = cudaMemsetAsync(
      first, kFirstFill, static_cast<size_t>(1 + l3) * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (window > 0) {
    radix_decode_kernel<<<(window + kDecodeThreads - 1) / kDecodeThreads,
                          kDecodeThreads, 0, s>>>(
        opc, args, arg_w, window, n_pages, max_span, l3, recs, keys, first,
        resps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_tiles = (row_len + kTile - 1) / kTile;
  const int group = min(kGroup, n_rep);
  const int64_t blocks =
      static_cast<int64_t>(n_tiles) * ((n_rep + group - 1) / group);
  bool vec = row_len % 4 == 0 && aligned16(pt_in) && aligned16(pt_out);
  if (PLAN) {
    vec = vec && aligned16(wins_in) && aligned16(wins_out)
          && aligned16(clr_in) && aligned16(clr_out);
  }
  decltype(&radix_kernel<PLAN, true>) kernel =
      vec ? &radix_kernel<PLAN, true> : &radix_kernel<PLAN, false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      recs, keys, first, window, n_pages, n_rep, row_len, n_tiles, group,
      l2, l3, pt_in, pt_out, pd_in, pd_out, pdpt_in, pdpt_out, pml4_in,
      pml4_out, wins_in, wins_out, clr_in, clr_out, pdt_in, pdt_out, resps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K6: pt[n_rep, row_len] in -> out, the canonical levels pd[l2],
// pdpt[l3], pml4[1] in -> out, resps[window]; scratch[5 * window + 1 +
// l3] int32, 16-byte aligned.
int nr_vspace_radix_replay(const int32_t* opc, const int32_t* args,
                           int arg_w, int window, int n_pages, int max_span,
                           int n_rep, int row_len, const int32_t* pt_in,
                           int32_t* pt_out, const int32_t* pd_in,
                           int32_t* pd_out, const int32_t* pdpt_in,
                           int32_t* pdpt_out, const int32_t* pml4_in,
                           int32_t* pml4_out, int32_t* resps,
                           int32_t* scratch, void* stream) {
  return launch<false>(opc, args, arg_w, window, n_pages, max_span, n_rep,
                       row_len, pt_in, pt_out, pd_in, pd_out, pdpt_in,
                       pdpt_out, pml4_in, pml4_out, nullptr, nullptr,
                       nullptr, nullptr, nullptr, nullptr, resps, scratch,
                       stream);
}

// K7b: K6 plus wins/clr[n_rep, row_len] and pdt[l2] in -> out.
int nr_vspace_radix_plan_replay(
    const int32_t* opc, const int32_t* args, int arg_w, int window,
    int n_pages, int max_span, int n_rep, int row_len, const int32_t* pt_in,
    int32_t* pt_out, const int32_t* pd_in, int32_t* pd_out,
    const int32_t* pdpt_in, int32_t* pdpt_out, const int32_t* pml4_in,
    int32_t* pml4_out, const int32_t* wins_in, int32_t* wins_out,
    const int32_t* clr_in, int32_t* clr_out, const int32_t* pdt_in,
    int32_t* pdt_out, int32_t* resps, int32_t* scratch, void* stream) {
  return launch<true>(opc, args, arg_w, window, n_pages, max_span, n_rep,
                      row_len, pt_in, pt_out, pd_in, pd_out, pdpt_in,
                      pdpt_out, pml4_in, pml4_out, wins_in, wins_out,
                      clr_in, clr_out, pdt_in, pdt_out, resps, scratch,
                      stream);
}

}  // extern "C"
