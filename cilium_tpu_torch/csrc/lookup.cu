// The two lookups of K20 outside the datapath, two CUDA kernels for
// Hopper (sm_90a).
//
// HASH_LOOKUP replaces the JAX package's jitted `lookup_batch`
// (cilium_tpu/engine/hashtable.py:200) over the windowed open-addressed
// table that `build_hash_table` (:160) builds: keys u32 [C + S, KW], the
// main region of C (a power of two) slots then an S-row stash, and
// value_index i32 [C + S].  One thread per query:
//   hash     FNV-1a over the query's KW words (common.cuh), masked to C;
//   window   the P slots (h + p) & (C - 1), p = 0 .. P - 1: the window
//            wraps at the end of the main region; the first hit in window
//            order wins (the reference's argmax);
//   stash    on a window miss only (a window hit beats a stash hit), the
//            stash's S x KW words, staged once per block in shared memory,
//            compared in row order; the first hit wins;
//   sentinel a query of all-ones words (the empty-slot key) is masked to
//            found = 0, index = 0; a miss gives index 0, not -1.
//
// IPCACHE_LOOKUP replaces `lpm_lookup` (cilium_tpu/ipcache/lpm.py:1103)
// over an IPCacheDevice: `_lookup_kernel` (:1091) -> `_ipcache_device_
// kernel` (:1079), ipcache_lookup_fused with ingress true where the table
// has L3 planes.  It runs the datapath's own ipcache stage,
// cdp::ipcache_lookup<IPC> of ipcache.cuh (the /32 bucket row, the stash,
// then the range classes or the [B, P] scan staged per block by
// cdp::stage_ranges), one thread per address, on a DatapathArgs that
// holds only the ipcache fields (kernels.py _fill_ipcache).  The value is
// the identity index + 1 in the idx forms, the raw identity in the generic
// one, 0 on a miss.
//
// What bounds them on an H100: bytes, by dependent gathers.  A hash query
// streams 4 KW bytes in and 5 out, and reads one window of P KW-word rows
// (128 B at KW = 4: one or two sectors of 32 B per slot, one line when
// the window does not wrap) and the hit's value_index word.  An address
// streams 4 B in and out, and reads one bucket row (256 B generic, 512 B
// with L3 planes) and on a miss one row per range class.  This first
// version does the simple thing: read-only loads per thread, the window
// read slot by slot, a row's words past the first compared only where its
// first word matches the query's (held in a register).
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "ipcache.cuh"

namespace clk {

constexpr int BLOCK = 256;
constexpr uint32_t EMPTY = 0xFFFFFFFFu;

// The field order is the ctypes Structure's order in kernels.py;
// lookup_struct_sizes() lets the wrapper check that the two agree.
struct HashArgs {
  const uint32_t* keys;        // [capacity + stash_n, kw]
  const int32_t* value_index;  // [capacity + stash_n]
  const uint32_t* query;       // [B, kw]
  uint8_t* found;              // [B]
  int32_t* index;              // [B]
  int32_t B;
  int32_t kw;
  int32_t capacity;  // a power of two
  int32_t stash_n;
  int32_t window;
};

struct IpcLookupArgs {
  cdp::DatapathArgs dp;  // the ipcache fields and B only
  const uint32_t* ips;   // [B]
  uint32_t* out;         // [B]
  int32_t form;          // IPC_IDX_PLANES, IPC_IDX or IPC_GENERIC
};

// the block's staged stash: stash_n x kw words
extern __shared__ uint32_t s_stash[];

__global__ void __launch_bounds__(BLOCK) hash_lookup_kernel(const HashArgs a) {
  const int kw = a.kw;
  const int sn = a.stash_n * kw;
  const uint32_t* stash = a.keys + static_cast<size_t>(a.capacity) * kw;
  for (int k = threadIdx.x; k < sn; k += BLOCK) s_stash[k] = __ldg(stash + k);
  __syncthreads();
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= a.B) return;
  const uint32_t* q = a.query + static_cast<size_t>(i) * kw;
  const uint32_t q0 = __ldg(q);
  uint32_t h = cdp::fnv1a_word(cdp::FNV_OFFSET, q0);
  bool sentinel = q0 == EMPTY;
  for (int w = 1; w < kw; ++w) {
    const uint32_t x = __ldg(q + w);
    h = cdp::fnv1a_word(h, x);
    sentinel &= x == EMPTY;
  }
  const uint32_t mask = static_cast<uint32_t>(a.capacity) - 1u;
  h &= mask;
  bool found = false;
  int32_t index = 0;
  // a row is compared past its first word only where that word matches
  for (int p = 0; p < a.window && !found; ++p) {
    const uint32_t slot = (h + static_cast<uint32_t>(p)) & mask;
    const uint32_t* row = a.keys + static_cast<size_t>(slot) * kw;
    if (__ldg(row) != q0) continue;
    bool eq = true;
    for (int w = 1; w < kw; ++w) eq &= __ldg(row + w) == __ldg(q + w);
    if (eq) {
      found = true;
      index = __ldg(a.value_index + slot);
    }
  }
  for (int s = 0; s < a.stash_n && !found; ++s) {
    const uint32_t* row = s_stash + s * kw;
    if (row[0] != q0) continue;
    bool eq = true;
    for (int w = 1; w < kw; ++w) eq &= row[w] == __ldg(q + w);
    if (eq) {
      found = true;
      index = __ldg(a.value_index + a.capacity + s);
    }
  }
  if (sentinel) {
    found = false;
    index = 0;
  }
  a.found[i] = found ? 1 : 0;
  a.index[i] = index;
}

template <int IPC>
__global__ void __launch_bounds__(BLOCK)
    ipcache_lookup_kernel(const IpcLookupArgs a) {
  cdp::stage_ranges(a.dp);
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i < a.dp.B)
    a.out[i] = cdp::ipcache_lookup<IPC>(a.dp, __ldg(a.ips + i), true).value;
}

}  // namespace clk

extern "C" {

int lookup_struct_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(cdp::DatapathArgs));
  out[1] = static_cast<int>(sizeof(clk::HashArgs));
  out[2] = static_cast<int>(sizeof(clk::IpcLookupArgs));
  return 3;
}

// The dynamic shared memory one block of the current device may opt in
// to (227 KB on an H100): the wrapper refuses a larger stash.
int lookup_smem_limit() {
  int dev = 0;
  int limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return limit;
}

// Launch HASH_LOOKUP on `stream` with `smem` bytes of staged stash, opting
// in past the default 48 KB where the stash needs it; returns
// cudaGetLastError() (a stash past the opt-in limit: cudaErrorInvalidValue).
int launch_hash_lookup(const clk::HashArgs* a, int smem, void* stream) {
  if (a->B <= 0) return 0;
  if (smem > lookup_smem_limit()) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(clk::hash_lookup_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int grid = (a->B + clk::BLOCK - 1) / clk::BLOCK;
  clk::hash_lookup_kernel<<<grid, clk::BLOCK, smem,
                            static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// Launch IPCACHE_LOOKUP on `stream`; returns cudaGetLastError() (an
// unknown form: cudaErrorInvalidValue).
int launch_ipcache_lookup(const clk::IpcLookupArgs* a, void* stream) {
  if (a->dp.B <= 0) return 0;
  const int grid = (a->dp.B + clk::BLOCK - 1) / clk::BLOCK;
  const size_t smem = cdp::scan_smem_bytes(a->dp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->form) {
    case cdp::IPC_IDX_PLANES:
      clk::ipcache_lookup_kernel<cdp::IPC_IDX_PLANES>
          <<<grid, clk::BLOCK, smem, s>>>(*a);
      break;
    case cdp::IPC_IDX:
      clk::ipcache_lookup_kernel<cdp::IPC_IDX>
          <<<grid, clk::BLOCK, smem, s>>>(*a);
      break;
    case cdp::IPC_GENERIC:
      clk::ipcache_lookup_kernel<cdp::IPC_GENERIC>
          <<<grid, clk::BLOCK, smem, s>>>(*a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
