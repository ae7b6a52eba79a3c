// The tuple-level policy lattice and the DIR-24-8 lookup, two CUDA
// kernels for Hopper (sm_90a).
//
// LATTICE replaces the JAX package's jitted `evaluate_batch`
// (cilium_tpu/engine/verdict.py:432 `_verdict_kernel`, K23), its counter
// form (`:610` `_verdict_kernel_with_counters`, as cilium_tpu/replay.py
// `replay_lattice` runs it) and, in IP mode, the fused CIDR path
// (`:627` `_verdict_kernel_from_ips`, K20).  Per tuple, one thread:
//   unpack        the [6, B] pack (ep, identity, dport, proto, dir, frag)
//   ipcache       IP mode: dir24_8() (common.cuh) over the source address,
//                 in place of the pack's identity (ipcache/lpm.py:1091)
//   lattice       tuple_verdict() of verdict.cuh, shared with DATAPATH6:
//                 the two-region id_direct read (_index_identity), the
//                 hashed probes or without the hash the dense port_slot /
//                 l4_allow_bits / l4_meta reads (_probes), the
//                 l3_allow_bits word and the combine, the fragment rule
//                 included
//   counters      optional: one atomicAdd per hit into a zeroed
//                 [E, 2, Kg + N] buffer (an index outside the buffer,
//                 after negative ones count from the end, drops its
//                 update, as an XLA scatter does)
// LPM_LOOKUP replaces `lpm_lookup` (ipcache/lpm.py:1103, the DIR-24-8
// branch of `_lookup_kernel`): dir24_8() alone, one thread per address.
//
// What bounds them on an H100: dependent reads, not arithmetic.  A tuple
// streams 24 B in and 6 B out, then reads one id_direct word, two hashed
// L4 rows (128 B compact, 256 B wide) with a stash scan, one l4_meta word
// (compact) and one l3_allow_bits word; IP mode adds the 4 B address, one
// l1 word from a 64 MB table (only the cells the addresses touch) and,
// for a block cell, one l2 word.  Config 5's policy tables are 40 MB and
// mostly stay in the 50 MB L2, so the kernel is bound by L2 and DRAM
// sector traffic of dependent gathers.  This first version does the
// simple thing: read-only loads (__ldg) per thread, every matching lane
// summed (no early exit, as the reference's masked sums), one global
// atomicAdd per counted hit.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "verdict.cuh"

namespace clt {

using cdp::dir24_8;
using cdp::PolicyView;

constexpr int BLOCK = 256;

// The field order is the ctypes Structure's order in kernels.py;
// lattice_struct_sizes() lets the wrapper check that the two agree.
struct LatticeArgs {
  const uint32_t* tuples;     // [6, B] u32 words
  const uint32_t* src_ips;    // [B] in IP mode, else null
  const uint32_t* l1;         // [2^24] (IP mode)
  const uint32_t* l2;         // [n_blocks, 256] (IP mode)
  PolicyView pol;
  uint8_t* allowed;           // outputs [B]
  int32_t* proxy_port;
  uint8_t* match_kind;
  uint32_t* acc;              // [E, 2, Kg + N] or null
  int32_t B;
  int32_t n_blocks;
};

struct LpmArgs {
  const uint32_t* l1;
  const uint32_t* l2;
  const uint32_t* ips;
  uint32_t* out;
  int32_t B;
  int32_t n_blocks;
};

__global__ void __launch_bounds__(BLOCK) lattice_kernel(const LatticeArgs a) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= a.B) return;
  const size_t b = static_cast<size_t>(a.B);
  const uint32_t* t = a.tuples;
  const int32_t ep = static_cast<int32_t>(__ldg(t + i));
  uint32_t ident = __ldg(t + b + i);
  const uint32_t dport = cdp::clip_u(static_cast<int32_t>(__ldg(t + 2 * b + i)),
                                     65535);
  const uint32_t proto = cdp::clip_u(static_cast<int32_t>(__ldg(t + 3 * b + i)),
                                     255);
  const int32_t dir = static_cast<int32_t>(__ldg(t + 4 * b + i));
  const bool frag = __ldg(t + 5 * b + i) != 0;
  if (a.src_ips) ident = dir24_8(a.l1, a.l2, a.n_blocks, __ldg(a.src_ips + i));

  uint32_t idx;
  const cdp::Lattice v = cdp::tuple_verdict(a.pol, ep, dir, dport, proto,
                                            ident, frag, &idx);
  a.allowed[i] = v.allowed;
  a.proxy_port[i] = v.proxy;
  a.match_kind[i] = static_cast<uint8_t>(v.kind);

  if (a.acc) {
    // L4 hits count at slot j, L3 hits at column kg + idx
    const bool hit_l4 = v.kind == cdp::MATCH_L4 || v.kind == cdp::MATCH_L4_WILD;
    if (hit_l4 || v.kind == cdp::MATCH_L3) {
      const cdp::L4Tables& l4 = a.pol.l4;
      const int64_t cols = static_cast<int64_t>(l4.kg) + a.pol.n_ids;
      const int64_t e = ep < 0 ? static_cast<int64_t>(ep) + l4.n_eps : ep;
      const int64_t d = dir < 0 ? static_cast<int64_t>(dir) + 2 : dir;
      int64_t c = hit_l4 ? static_cast<int64_t>(v.j)
                         : static_cast<int64_t>(l4.kg) + idx;
      if (c < 0) c += cols;
      if (e >= 0 && e < l4.n_eps && d >= 0 && d < 2 && c >= 0 && c < cols)
        atomicAdd(a.acc + (e * 2 + d) * cols + c, 1u);
    }
  }
}

__global__ void __launch_bounds__(BLOCK) lpm_lookup_kernel(const LpmArgs a) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i < a.B) a.out[i] = dir24_8(a.l1, a.l2, a.n_blocks, __ldg(a.ips + i));
}

}  // namespace clt

extern "C" int lattice_struct_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(cdp::L4Tables));
  out[1] = static_cast<int>(sizeof(cdp::PolicyView));
  out[2] = static_cast<int>(sizeof(clt::LatticeArgs));
  out[3] = static_cast<int>(sizeof(clt::LpmArgs));
  return 4;
}

// Launch LATTICE on `stream`; returns cudaGetLastError().
extern "C" int launch_lattice(const clt::LatticeArgs* args, void* stream) {
  if (args->B > 0) {
    const int grid = (args->B + clt::BLOCK - 1) / clt::BLOCK;
    clt::lattice_kernel<<<grid, clt::BLOCK, 0,
                          static_cast<cudaStream_t>(stream)>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch LPM_LOOKUP on `stream`; returns cudaGetLastError().
extern "C" int launch_lpm_lookup(const clt::LpmArgs* args, void* stream) {
  if (args->B > 0) {
    const int grid = (args->B + clt::BLOCK - 1) / clt::BLOCK;
    clt::lpm_lookup_kernel<<<grid, clt::BLOCK, 0,
                             static_cast<cudaStream_t>(stream)>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}
