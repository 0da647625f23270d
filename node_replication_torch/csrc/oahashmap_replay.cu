// Open-addressing hash map replay kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   K3   node_replication_tpu/ops/pallas_oahashmap.py:_oa_kernel/_oa_body
//        (built by make_oahashmap_replay, driven by
//        make_pallas_oahashmap_step)
//
// What it computes. W entries (opcode, a0 = key, a1 = value) are
// replayed IN ORDER into every replica's three planes keys/vals/flag
// [R, row_len] (row_len >= n_slots; the reference's [R, ROWS, 128] with
// its guard row, whose padding is copied through). A key's window is
// the `probe` slots (home + i) mod n_slots, home = mix(key) mod n_slots,
// with the reference model's uint32 mix (the int32 emulation of
// `_mix_mod` is a Mosaic workaround; here it is plain uint32_t). PUT (1)
// writes key, value and OCCUPIED at the window's first slot holding the
// key, else at its first slot that is not occupied, response 0; with
// neither, it is dropped, response -2. REMOVE (2) writes TOMBSTONE at
// the first slot holding the key, response 1, else 0. Other opcodes are
// inert with response 0. The response is replica 0's: one canonical
// copy, which speaks for the fleet under the lock-step invariant.
//
// Layout and parallelism. Windows overlap across any slot boundary and
// the target choice needs the whole window's state before the entry, so
// the vspace kernels' one-owner tiles do not carry over. The design is
// the simple one: one warp per replica walks the window in order; per
// entry its lanes load the probe slots' flags and keys (up to four each,
// all issued before the first use; the next entry's opcode and key are
// loaded a step ahead), two ballots give the first match and the first
// free position, and lane 0 writes the target slot. __syncwarp() between
// entries orders that store before the next entry's loads. The planes
// are copied in -> out on the stream before the launch (the kernel then
// works in place on the outputs).
//
// What bounds it. The copy moves the three planes in and out once
// (3.2 GB at R = 16, n_slots = 2^23); the replay then costs one
// dependent device-memory round trip per entry and warp (latency, not
// bandwidth: W x ~1 us at W = 4096), with only R warps in flight.
// Overlapping entries' loads (a window prefetched ahead and patched by
// the entries before it), or more warps per replica, is later work.
//
// Dropped from the reference: its VMEM replica groups, the MAX_GRID
// chunks, and the two-run row blends of a wrapped window.
//
// Plain C interface, loaded with ctypes (node_replication_torch/ops/
// oahashmap.py). The entry point zeroes the responses, copies the
// planes, launches on the given stream and returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kRounds = 4;  // probe <= 128 = kRounds x kLanes positions
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kOcc = 1;
constexpr int32_t kTomb = 2;

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

__global__ void __launch_bounds__(kLanes)
oa_kernel(const int32_t* __restrict__ opc, const int32_t* __restrict__ args,
          int arg_w, int window, int n_slots, int probe, int row_len,
          int32_t* keys, int32_t* vals, int32_t* flag,
          int32_t* __restrict__ resps) {
  const int lane = threadIdx.x;
  const int r = blockIdx.x;  // one warp per replica
  const size_t row = static_cast<size_t>(r) * row_len;
  int32_t* k_row = keys + row;
  int32_t* v_row = vals + row;
  int32_t* f_row = flag + row;
  // the next entry's opcode and key are loaded while this one runs
  int op_next = window > 0 ? opc[0] : 0;
  int32_t k_next = window > 0 ? args[0] : 0;
  for (int i = 0; i < window; ++i) {
    const int op = op_next;
    const int32_t k = k_next;
    if (i + 1 < window) {
      op_next = opc[i + 1];
      k_next = args[static_cast<size_t>(i + 1) * arg_w];
    }
    if (op != 1 && op != 2) continue;  // inert: response 0 (zeroed)
    const uint32_t home = mix(static_cast<uint32_t>(k))
                          % static_cast<uint32_t>(n_slots);
    int32_t fl[kRounds], kv[kRounds];
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int pos = u * kLanes + lane;
      int s = static_cast<int>(home) + pos;
      if (s >= n_slots) s -= n_slots;  // probe <= n_slots
      fl[u] = pos < probe ? f_row[s] : kOcc;
      kv[u] = pos < probe ? k_row[s] : 0;
    }
    int first_match = probe, first_free = probe;
#pragma unroll
    for (int u = kRounds - 1; u >= 0; --u) {  // lowest position wins
      const int pos = u * kLanes + lane;
      const unsigned m =
          __ballot_sync(kFull, pos < probe && fl[u] == kOcc && kv[u] == k);
      const unsigned f = __ballot_sync(kFull, pos < probe && fl[u] != kOcc);
      if (m) first_match = u * kLanes + __ffs(m) - 1;
      if (f) first_free = u * kLanes + __ffs(f) - 1;
    }
    const bool is_put = op == 1;
    const int target = first_match < probe ? first_match
                       : is_put ? first_free : probe;
    if (target < probe && lane == 0) {
      int s = static_cast<int>(home) + target;
      if (s >= n_slots) s -= n_slots;
      if (is_put) {
        k_row[s] = k;
        v_row[s] = args[static_cast<size_t>(i) * arg_w + 1];
        f_row[s] = kOcc;
      } else {
        f_row[s] = kTomb;
      }
    }
    if (r == 0 && lane == 0) {
      resps[i] = is_put ? (target < probe ? 0 : -2)
                        : (first_match < probe ? 1 : 0);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// K3: keys/vals/flag[n_rep, row_len] in -> out, resps[window].
int nr_oahashmap_replay(const int32_t* opc, const int32_t* args, int arg_w,
                        int window, int n_slots, int probe, int n_rep,
                        int row_len, const int32_t* keys_in,
                        int32_t* keys_out, const int32_t* vals_in,
                        int32_t* vals_out, const int32_t* flag_in,
                        int32_t* flag_out, int32_t* resps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t plane = static_cast<size_t>(n_rep) * row_len * sizeof(int32_t);
  cudaError_t err = cudaMemsetAsync(
      resps, 0, static_cast<size_t>(window) * sizeof(int32_t), s);
  const int32_t* ins[3] = {keys_in, vals_in, flag_in};
  int32_t* outs[3] = {keys_out, vals_out, flag_out};
  for (int p = 0; p < 3 && err == cudaSuccess; ++p) {
    err = cudaMemcpyAsync(outs[p], ins[p], plane, cudaMemcpyDeviceToDevice,
                          s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  oa_kernel<<<n_rep, kLanes, 0, s>>>(opc, args, arg_w, window, n_slots,
                                     probe, row_len, keys_out, vals_out,
                                     flag_out, resps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
