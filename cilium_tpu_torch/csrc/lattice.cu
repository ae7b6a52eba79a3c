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
//   lattice       lattice_of() below, from verdict.cuh's stages (as its
//                 tuple_verdict(), which DATAPATH6 runs, in another
//                 order): the two-region id_direct read (_index_identity),
//                 the hashed probes or without the hash the dense
//                 port_slot / l4_allow_bits / l4_meta reads (_probes), the
//                 l3_allow_bits word and the combine, the fragment rule
//                 included
//   counters      optional: each hit into a zeroed [E, 2, Kg + N] buffer
//                 (an index outside the buffer, after negative ones count
//                 from the end, drops its update, as an XLA scatter does)
// LPM_LOOKUP replaces `lpm_lookup` (ipcache/lpm.py:1103, the DIR-24-8
// branch of `_lookup_kernel`): dir24_8() alone, one thread per address.
//
// What bounds them on an H100: dependent reads, not arithmetic.  A tuple
// streams 24 B in and 6 B out, then reads one id_direct word, two hashed
// L4 rows (128 B compact, 256 B wide) with a stash scan, one l4_meta word
// (compact) and one l3_allow_bits word; IP mode adds the 4 B address, one
// l1 word from a 64 MB table (only the cells the addresses touch) and,
// for a block cell, one l2 word.  Config 5's policy tables are 40 MB and
// mostly stay in the 50 MB L2, so the kernel is bound by the latency of
// its chain of dependent gathers (l1, l2, id_direct, the exact row, the
// l4_meta word) and by L2 sector traffic.  The design is the pair
// kernel's per-flow one (csrc/datapath.cu), as ROUTED_PROBE
// (csrc/mesh.cu) runs it: one thread a tuple (lane groups lost 4-10 x
// there), its words read before anything else; the id_direct read
// issued first, then the wildcard probe, whose keys do not depend on the
// identity, then the exact probe and the l3_allow_bits word, which do;
// the key planes of both L4 rows read in 16-byte loads (PairReads) where
// a row is 16-byte aligned; the compact layout's stashes staged once a
// block in shared memory when they fit LATTICE_STASH_SMEM bytes (the
// wide layout's, and larger ones, read where they lie by the same code);
// a batch of LATTICE_STREAM_TUPLES or more read and its three columns
// stored with the streaming hints, so that the stream does not push the
// tables out of the L2 (a smaller one stays there beside them); a
// template per entry layout (2 or 3 words, or the dense branch), mode (IP
// or the pack's identity) and streaming; registers fitted to
// LATTICE_BLOCKS_PER_SM blocks an SM; the counter form's hits aggregated
// a block (common.cuh cell_add: a Zipf stream's hot cells take one
// atomic a block).  Every matching lane is summed (no early exit, as the
// reference's masked sums).
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

// LATTICE's blocks an SM, its registers fitted to them; the stash
// bytes a block stages at most; and the batch from which the tuple
// planes are read and the columns stored with the streaming hints: 48 MB
// of tuple words, about the L2's size (a smaller batch stays in the L2
// beside the tables, and a caller that evaluates it again reads it from
// there)
constexpr int LATTICE_BLOCKS_PER_SM = 6;
constexpr int LATTICE_STASH_SMEM = 16 * 1024;
constexpr int LATTICE_STREAM_TUPLES = 1 << 21;

__host__ __device__ inline int lattice_stash_words(const LatticeArgs& a) {
  const cdp::L4Tables& l4 = a.pol.l4;
  return l4.rows ? l4.ew * (l4.stash_n + l4.wstash_n) : 0;
}

// Whether a block stages the stashes: the compact layout's, where they
// fit.  Its stash reads ran faster from the staged copies (through
// generic loads) than from global memory, the wide layout's slower
// (PERF.md), so the wide ones are read where they lie.
__host__ __device__ inline bool lattice_stashes_staged(const LatticeArgs& a) {
  const int n = lattice_stash_words(a);
  return a.pol.l4.ew == 2 && n > 0 && n * 4 <= LATTICE_STASH_SMEM;
}

// The lattice of one tuple (engine/verdict.py _probes + _combine, as
// verdict.cuh tuple_verdict runs it), its reads reordered: EW the entry
// words of the hashed L4 tables (2 compact, 3 wide) or 0 for the dense
// branch; `ex_stash` and `wd_stash` where the block reads the stashes.
// ep and dir are the tuple's int32 words, dport and proto clipped.
// Writes the identity index to *idx (the counters' L3 column).  Its own
// code, not tuple_verdict<PairReads> over a copy of the L4 tables with
// these stashes: that took 7 % longer on config 5's wide tables with the
// wildcard probe also issued first, 17 % with it last (PERF.md).
template <int EW>
__device__ __forceinline__ cdp::Lattice lattice_of(
    const PolicyView& p, const uint32_t* ex_stash, const uint32_t* wd_stash,
    int32_t ep, int32_t dir, uint32_t dport, uint32_t proto, uint32_t ident,
    bool frag, uint32_t* idx) {
  using cdp::gather_ix;
  const cdp::L4Tables& l4 = p.l4;
  bool known;
  *idx = cdp::index_identity(p, ident, &known);
  const size_t row =
      static_cast<size_t>(gather_ix(ep, l4.n_eps)) * 2 + gather_ix(dir, 2);
  cdp::Probes q;
  if constexpr (EW == 0) {
    q = cdp::dense_probes(p.port_slot, p.l4_allow, l4.meta, l4.n_eps, l4.kg,
                          p.n_words, ep, dir, dport, proto,
                          cdp::dense_word(*idx, p.n_words), *idx & 31u, known);
  } else {
    const uint32_t ep32 = static_cast<uint32_t>(ep);
    const uint32_t dir32 = static_cast<uint32_t>(dir);
    uint32_t w0, w1;
    // -- the wildcard probe: no identity in its keys
    cdp::l4_keys(EW, ep32, dir32, dport, proto, cdp::L4H_WILD_IDX, &w0, &w1);
    const cdp::L4Probe wd = cdp::l4_probe_ew<cdp::PairReads>(
        l4.wrows, l4.wnrows, l4.wlanes, wd_stash, l4.wstash_n, EW, w0, w1);
    // -- the exact probe, on the identity's index
    cdp::l4_keys(EW, ep32, dir32, dport, proto, *idx, &w0, &w1);
    const cdp::L4Probe ex = cdp::l4_probe_ew<cdp::PairReads>(
        l4.rows, l4.nrows, l4.lanes, ex_stash, l4.stash_n, EW, w0, w1);
    q.p1 = known && ex.hit;
    q.p3 = wd.hit;
    const uint32_t val = q.p1 ? ex.val : wd.val;
    if constexpr (EW == 3) {
      q.proxy = static_cast<int32_t>(val & 0xFFFFu);
      q.j = static_cast<int32_t>(val >> 16);
    } else {
      q.j = static_cast<int32_t>(val);
      const uint32_t meta =
          __ldg(l4.meta + row * l4.kg + gather_ix(q.j, l4.kg));
      q.proxy = (q.p1 || q.p3) ? static_cast<int32_t>(meta >> 1) : 0;
    }
  }
  const bool l3 = (__ldg(p.l3_allow + row * p.n_words +
                         cdp::dense_word(*idx, p.n_words)) >>
                   (*idx & 31u)) &
                  1u;
  return cdp::combine(q.p1, known && l3, q.p3, q.proxy, q.j, frag);
}

// A tuple plane's word and an output column's, with STREAM through the
// L2 once (the streaming hints), else cached as the tables are.
template <bool STREAM>
__device__ __forceinline__ uint32_t ld_tuple(const uint32_t* p) {
  if constexpr (STREAM) {
    return __ldcs(p);
  } else {
    return __ldg(p);
  }
}

template <bool STREAM, typename T>
__device__ __forceinline__ void st_column(T* p, T v) {
  if constexpr (STREAM) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// One thread a tuple: its words are read before the block stages the
// stashes, so that their latency and the staging's overlap.  STREAM is
// the launch's choice (LATTICE_STREAM_TUPLES).
template <int EW, bool IP, bool STREAM>
__global__ void __launch_bounds__(BLOCK, LATTICE_BLOCKS_PER_SM)
    lattice_kernel(const __grid_constant__ LatticeArgs a) {
  extern __shared__ uint32_t s_stash[];
  __shared__ cdp::CellTable cells;
  const PolicyView& p = a.pol;
  const size_t b = static_cast<size_t>(a.B);
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < a.B;
  const uint32_t* t = a.tuples;
  uint32_t w[6], ip = 0;
#pragma unroll
  for (int c = 0; c < 6; ++c)
    w[c] = live ? ld_tuple<STREAM>(t + c * b + i) : 0u;
  if constexpr (IP) ip = live ? ld_tuple<STREAM>(a.src_ips + i) : 0u;
  const uint32_t* ex_stash = p.l4.stash;
  const uint32_t* wd_stash = p.l4.wstash;
  if (EW == 2 && lattice_stashes_staged(a)) {
    const int n_ex = EW * p.l4.stash_n, n_wd = EW * p.l4.wstash_n;
    for (int k = threadIdx.x; k < n_ex; k += BLOCK)
      s_stash[k] = __ldg(p.l4.stash + k);
    for (int k = threadIdx.x; k < n_wd; k += BLOCK)
      s_stash[n_ex + k] = __ldg(p.l4.wstash + k);
    __syncthreads();
    ex_stash = s_stash;
    wd_stash = s_stash + n_ex;
  }
  if (a.acc) cdp::cell_init(cells);
  int64_t cell = -1;
  if (live) {
    const int32_t ep = static_cast<int32_t>(w[0]);
    const uint32_t ident =
        IP ? dir24_8(a.l1, a.l2, a.n_blocks, ip) : w[1];
    const uint32_t dport = cdp::clip_u(static_cast<int32_t>(w[2]), 65535);
    const uint32_t proto = cdp::clip_u(static_cast<int32_t>(w[3]), 255);
    const int32_t dir = static_cast<int32_t>(w[4]);
    uint32_t idx;
    const cdp::Lattice v = lattice_of<EW>(p, ex_stash, wd_stash, ep, dir,
                                          dport, proto, ident, w[5] != 0,
                                          &idx);
    st_column<STREAM>(a.allowed + i, static_cast<uint8_t>(v.allowed));
    st_column<STREAM>(a.proxy_port + i, v.proxy);
    st_column<STREAM>(a.match_kind + i, static_cast<uint8_t>(v.kind));
    // L4 hits count at slot j, L3 hits at column kg + idx; an index
    // outside the buffer, after negative ones count from the end, drops
    // its update (an XLA scatter)
    const bool hit_l4 =
        v.kind == cdp::MATCH_L4 || v.kind == cdp::MATCH_L4_WILD;
    if (a.acc && (hit_l4 || v.kind == cdp::MATCH_L3)) {
      const cdp::L4Tables& l4 = p.l4;
      const int64_t cols = static_cast<int64_t>(l4.kg) + p.n_ids;
      const int64_t e = ep < 0 ? static_cast<int64_t>(ep) + l4.n_eps : ep;
      const int64_t d = dir < 0 ? static_cast<int64_t>(dir) + 2 : dir;
      int64_t c = hit_l4 ? static_cast<int64_t>(v.j)
                         : static_cast<int64_t>(l4.kg) + idx;
      if (c < 0) c += cols;
      if (e >= 0 && e < l4.n_eps && d >= 0 && d < 2 && c >= 0 && c < cols)
        cell = (e * 2 + d) * cols + c;
    }
  }
  if (a.acc) {
    cdp::cell_add(cells, a.acc, cell);
    cdp::cell_flush(cells, a.acc);
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

namespace {

template <int EW, bool IP>
void launch_lattice_mode(const clt::LatticeArgs& a, cudaStream_t stream) {
  const int grid = (a.B + clt::BLOCK - 1) / clt::BLOCK;
  const size_t smem =
      clt::lattice_stashes_staged(a)
          ? static_cast<size_t>(clt::lattice_stash_words(a)) * 4
          : 0;
  if (a.B >= clt::LATTICE_STREAM_TUPLES)
    clt::lattice_kernel<EW, IP, true><<<grid, clt::BLOCK, smem, stream>>>(a);
  else
    clt::lattice_kernel<EW, IP, false><<<grid, clt::BLOCK, smem, stream>>>(a);
}

template <int EW>
void launch_lattice_ew(const clt::LatticeArgs& a, cudaStream_t stream) {
  if (a.src_ips)
    launch_lattice_mode<EW, true>(a, stream);
  else
    launch_lattice_mode<EW, false>(a, stream);
}

}  // namespace

// Launch LATTICE on `stream` (one instantiation per entry layout, mode
// and streaming; the compact stashes in dynamic shared memory where they
// fit); returns
// cudaGetLastError() (hashed entries of other than 2 or 3 words:
// cudaErrorInvalidValue).
extern "C" int launch_lattice(const clt::LatticeArgs* args, void* stream) {
  const clt::LatticeArgs& a = *args;
  const int ew = a.pol.l4.rows ? a.pol.l4.ew : 0;
  if (ew != 0 && ew != 2 && ew != 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (ew == 3)
      launch_lattice_ew<3>(a, s);
    else if (ew == 2)
      launch_lattice_ew<2>(a, s);
    else
      launch_lattice_ew<0>(a, s);
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
