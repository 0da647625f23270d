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
// Layout and parallelism: the flat kernels' tiles
// (csrc/vspace_replay.cu). Warp (replica, tile) owns
// pt[r, tile*1024 : (tile+1)*1024), loads it into shared memory, replays
// there in window order exactly the entries that meet its tile, and
// writes it out; replica 0's warps add their per-tile counts into the
// zeroed responses with an integer atomicAdd.
// What is new is the levels, which every replica shares:
//   - A PD entry covers 512 pages, so a 1024-page tile holds exactly two
//     (ra, rb), and every entry that updates either of them meets the
//     tile (a MAP's span runs through every region it marks, at a page
//     < P; a teardown's region is in the tile). So the warp tracks its
//     two PD entries in registers as it replays, and replica 0's warp is
//     their one owner: it writes pd_out (and K7b's pdt_out) at the end.
//   - PDPT and PML4 are global and monotone (only ever set), and a
//     tile's walk turns on at the first live MAP ANYWHERE in the window
//     that sets its PDPT entry or PML4, whose span need not meet the
//     tile. So the ballot that picks a warp's entries also catches every
//     live MAP while the warp's two upper flags are not both set; it
//     updates the flags (in registers) in window order.
//   - pdpt_out/pml4_out are copied from their inputs on the stream
//     before the launch; inside, block 0's staging threads only SET
//     entries (to 1) for every live MAP, so no order is needed. A copy
//     inside the kernel would race with those sets.
//   - K7b keeps per page one byte of wins/clr state in shared memory
//     beside the tile and resolves it against the inputs at write-out.
// The window is staged through shared memory in chunks of kChunk
// entries, pre-reduced (vs, n, a1, kind); a warp tests 32 staged entries
// at once with a ballot and walks the hits in order; __syncwarp()
// between entries orders one entry's shared stores before the next
// one's loads.
//
// What bounds them. Device-memory bytes: the tile copies move pt in and
// out once (2 x 268 MB at R = 256, P = 2^18); the replay stays in shared
// memory. As in K4, each block also stages the whole window and each
// warp scans it, a cost in instructions that grows with W x R x P / 1024.
//
// Dropped from the reference: its VMEM replica groups and MAX_GRID
// chunks (which recompute the canonical levels once per grid step), the
// 4096-entry SMEM window chunks of the step paths, the copy_in
// un-aliasing (an aliased-block pipeline race of Mosaic), and the
// [ROWS, 128] padding of the plan planes (K7b takes [1, P]).
//
// Plain C interface, loaded with ctypes (node_replication_torch/ops/
// vspace.py). Each entry point zeroes the responses, copies the upper
// levels in -> out, launches on the given stream and returns the first
// CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;    // threads per warp (blockDim.x)
constexpr int kWarps = 8;     // (replica, tile) warps per block
constexpr int kTile = 1024;   // pages per warp: two PD entries
constexpr int kChunk = 512;   // window entries staged per pass
constexpr int kUnroll = 4;    // loads in flight per lane in the copies
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kFrameMask = (1u << 30) - 1;
constexpr uint32_t kDevBit = 1u << 30;
// K7b's per-page state in shared memory
constexpr uint8_t kWinsSet = 1;    // wins := 1
constexpr uint8_t kWinsReset = 2;  // wins := 0
constexpr uint8_t kClrSet = 4;     // clr := 1

template <bool PLAN>
__global__ void __launch_bounds__(kLanes * kWarps)
radix_kernel(
    const int32_t* __restrict__ opc, const int32_t* __restrict__ args,
    int arg_w, int window, int n_pages, int max_span, int n_rep,
    int row_len, int n_tiles, int l2, int l3,
    const int32_t* __restrict__ pt_in, int32_t* __restrict__ pt_out,
    const int32_t* __restrict__ pd_in, int32_t* __restrict__ pd_out,
    const int32_t* __restrict__ pdpt_in, int32_t* pdpt_out,
    const int32_t* __restrict__ pml4_in, int32_t* pml4_out,
    const int32_t* __restrict__ wins_in, int32_t* __restrict__ wins_out,
    const int32_t* __restrict__ clr_in, int32_t* __restrict__ clr_out,
    const int32_t* __restrict__ pdt_in, int32_t* __restrict__ pdt_out,
    int32_t* __restrict__ resps) {
  __shared__ int32_t s_tile[kWarps][kTile];
  __shared__ uint8_t s_flag[PLAN ? kWarps : 1][PLAN ? kTile : 1];
  __shared__ int32_t s_vs[kChunk];
  __shared__ int32_t s_n[kChunk];   // span length; 0 for inert entries
  __shared__ int32_t s_val[kChunk];
  __shared__ int8_t s_kind[kChunk];  // the opcode, 0 when inert

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
  uint8_t* flag = s_flag[PLAN ? threadIdx.y : 0];

  // the tile's two PD entries and its PDPT entry, tracked in registers
  const int ra = p0 >> 9, rb = ra + 1;
  const int kk = min(p0 >> 18, l3 - 1);
  int pd_a = 0, pd_b = 0, pdt_a = 0, pdt_b = 0;
  bool pdpt_on = false, pml4_on = false;

  if (live) {
    pd_a = ra < l2 ? pd_in[ra] : 0;
    pd_b = rb < l2 ? pd_in[rb] : 0;
    if (PLAN) {
      pdt_a = ra < l2 ? pdt_in[ra] : 0;
      pdt_b = rb < l2 ? pdt_in[rb] : 0;
    }
    pdpt_on = pdpt_in[kk] > 0;
    pml4_on = pml4_in[0] > 0;
    for (int q = lane; q < c1; q += kLanes * kUnroll) {
      int32_t v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = q + u * kLanes;
        v[u] = p < c1 ? pt_in[row + p] : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = q + u * kLanes;
        if (p < c1) {
          tile[p] = v[u];
          if (PLAN) flag[p] = 0;
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
      const int kind = op >= 1 && op <= 4 ? op : 0;
      const int n = kind >= 1 && kind <= 3
          ? min(max(kind == 3 ? a[1] : a[2], 0), max_span) : 0;
      // floored modulo: C's % truncates toward zero
      int vs = a[0] % n_pages;
      if (vs < 0) vs += n_pages;
      s_vs[i] = vs;
      s_n[i] = n;
      s_val[i] = a[1];
      s_kind[i] = static_cast<int8_t>(kind);
      if (blockIdx.x == 0 && (kind == 1 || kind == 2) && n > 0) {
        // set-only stores of the monotone levels (vs >> 27 == 0)
        const int last = vs + n - 1;
        if ((vs >> 18) < l3) pdpt_out[vs >> 18] = 1;
        if ((last >> 18) < l3) pdpt_out[last >> 18] = 1;
        pml4_out[0] = 1;
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int j0 = 0; j0 < cn; j0 += kLanes) {
      const int j = j0 + lane;
      bool hit = false;
      if (j < cn) {
        const int kind = s_kind[j], vs = s_vs[j], n = s_n[j];
        if (kind == 4) {
          hit = (vs >> 10) == (p0 >> 10);  // its region lies in the tile
        } else if (kind != 0 && n > 0) {
          hit = vs < p1 && vs + n > p0;
          // a live MAP anywhere may switch the tile's walk on
          if (!hit && kind != 3 && !(pdpt_on && pml4_on)) {
            hit = !pml4_on || (vs >> 18) == kk
                  || ((vs + n - 1) >> 18) == kk;
          }
        }
      }
      unsigned todo = __ballot_sync(kFull, hit);
      while (todo) {
        const int i = j0 + __ffs(todo) - 1;
        todo &= todo - 1;
        const int kind = s_kind[i], vs = s_vs[i], n = s_n[i];
        const bool up = pdpt_on && pml4_on;  // the walk reads pre-op levels
        int cnt = 0;
        if (kind == 4) {
          const int base = (vs >> 9) << 9;
          const int pdr = (vs >> 9) == ra ? pd_a : pd_b;
          const int end = min(base + 512, n_pages);
          for (int p = base + lane; p < end; p += kLanes) {
            const int t = p - p0;
            cnt += up && pdr > 0 && tile[t] != 0;
            tile[t] = 0;
            if (PLAN) flag[t] = kWinsReset | kClrSet;
          }
        } else {
          const bool is_map = kind != 3;
          const uint32_t base = static_cast<uint32_t>(s_val[i]) + 1u;
          const uint32_t dev = kind == 2 ? kDevBit : 0u;
          const int hi = min(vs + n, p1);
          for (int p = max(vs, p0) + lane; p < hi; p += kLanes) {
            const int t = p - p0;
            const int pdv = (p >> 9) == ra ? pd_a : pd_b;
            const bool walk = up && pdv > 0 && tile[t] != 0;
            cnt += is_map ? !walk : walk;
            tile[t] = is_map
                ? static_cast<int32_t>(
                      ((base + static_cast<uint32_t>(p - vs)) & kFrameMask)
                      | dev)
                : 0;
            if (PLAN) flag[t] = (flag[t] & kClrSet) | kWinsSet;
          }
        }
        if (r == 0) {
          cnt = __reduce_add_sync(kFull, cnt);
          if (lane == 0 && cnt != 0) atomicAdd(&resps[c0 + i], cnt);
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
        } else if ((kind == 1 || kind == 2) && n > 0) {
          const int last = vs + n - 1;
          const bool mark1 = r0 + 1 < l2 && r0 + 1 <= (last >> 9);
          if (r0 == ra || (mark1 && r0 + 1 == ra)) {
            pd_a = 1;
            pdt_a = 1;
          }
          if (r0 == rb || (mark1 && r0 + 1 == rb)) {
            pd_b = 1;
            pdt_b = 1;
          }
          pml4_on = true;
          if ((vs >> 18) == kk || (last >> 18) == kk) pdpt_on = true;
        }
        __syncwarp();
      }
    }
  }

  if (live) {
    __syncwarp();
    for (int p = lane; p < c1; p += kLanes) {
      pt_out[row + p] = tile[p];
      if (PLAN) {
        const uint8_t f = flag[p];
        wins_out[row + p] = (f & kWinsSet) ? 1
                            : (f & kWinsReset) ? 0 : wins_in[row + p];
        clr_out[row + p] = (f & kClrSet) ? 1 : clr_in[row + p];
      }
    }
    if (r == 0 && lane == 0) {  // the one owner of pd[ra], pd[rb]
      if (ra < l2) pd_out[ra] = pd_a;
      if (rb < l2) pd_out[rb] = pd_b;
      if (PLAN) {
        if (ra < l2) pdt_out[ra] = pdt_a;
        if (rb < l2) pdt_out[rb] = pdt_b;
      }
    }
  }
}

template <bool PLAN>
int launch(const int32_t* opc, const int32_t* args, int arg_w, int window,
           int n_pages, int max_span, int n_rep, int row_len,
           const int32_t* pt_in, int32_t* pt_out, const int32_t* pd_in,
           int32_t* pd_out, const int32_t* pdpt_in, int32_t* pdpt_out,
           const int32_t* pml4_in, int32_t* pml4_out,
           const int32_t* wins_in, int32_t* wins_out, const int32_t* clr_in,
           int32_t* clr_out, const int32_t* pdt_in, int32_t* pdt_out,
           int32_t* resps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int l2 = (n_pages + 511) / 512;
  const int l3 = (n_pages + (1 << 18) - 1) >> 18;
  cudaError_t err = cudaMemsetAsync(
      resps, 0, static_cast<size_t>(window) * sizeof(int32_t), s);
  if (err == cudaSuccess) {
    err = cudaMemcpyAsync(pdpt_out, pdpt_in, l3 * sizeof(int32_t),
                          cudaMemcpyDeviceToDevice, s);
  }
  if (err == cudaSuccess) {
    err = cudaMemcpyAsync(pml4_out, pml4_in, sizeof(int32_t),
                          cudaMemcpyDeviceToDevice, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (row_len + kTile - 1) / kTile;
  const int64_t warps = static_cast<int64_t>(n_rep) * n_tiles;
  const dim3 grid(static_cast<unsigned>((warps + kWarps - 1) / kWarps));
  radix_kernel<PLAN><<<grid, dim3(kLanes, kWarps), 0, s>>>(
      opc, args, arg_w, window, n_pages, max_span, n_rep, row_len, n_tiles,
      l2, l3, pt_in, pt_out, pd_in, pd_out, pdpt_in, pdpt_out, pml4_in,
      pml4_out, wins_in, wins_out, clr_in, clr_out, pdt_in, pdt_out, resps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K6: pt[n_rep, row_len] in -> out, the canonical levels pd[l2],
// pdpt[l3], pml4[1] in -> out, resps[window].
int nr_vspace_radix_replay(const int32_t* opc, const int32_t* args,
                           int arg_w, int window, int n_pages, int max_span,
                           int n_rep, int row_len, const int32_t* pt_in,
                           int32_t* pt_out, const int32_t* pd_in,
                           int32_t* pd_out, const int32_t* pdpt_in,
                           int32_t* pdpt_out, const int32_t* pml4_in,
                           int32_t* pml4_out, int32_t* resps,
                           void* stream) {
  return launch<false>(opc, args, arg_w, window, n_pages, max_span, n_rep,
                       row_len, pt_in, pt_out, pd_in, pd_out, pdpt_in,
                       pdpt_out, pml4_in, pml4_out, nullptr, nullptr,
                       nullptr, nullptr, nullptr, nullptr, resps, stream);
}

// K7b: K6 plus wins/clr[n_rep, row_len] and pdt[l2] in -> out.
int nr_vspace_radix_plan_replay(
    const int32_t* opc, const int32_t* args, int arg_w, int window,
    int n_pages, int max_span, int n_rep, int row_len, const int32_t* pt_in,
    int32_t* pt_out, const int32_t* pd_in, int32_t* pd_out,
    const int32_t* pdpt_in, int32_t* pdpt_out, const int32_t* pml4_in,
    int32_t* pml4_out, const int32_t* wins_in, int32_t* wins_out,
    const int32_t* clr_in, int32_t* clr_out, const int32_t* pdt_in,
    int32_t* pdt_out, int32_t* resps, void* stream) {
  return launch<true>(opc, args, arg_w, window, n_pages, max_span, n_rep,
                      row_len, pt_in, pt_out, pd_in, pd_out, pdpt_in,
                      pdpt_out, pml4_in, pml4_out, wins_in, wins_out,
                      clr_in, clr_out, pdt_in, pdt_out, resps, stream);
}

}  // extern "C"
