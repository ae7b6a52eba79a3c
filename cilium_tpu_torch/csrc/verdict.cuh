// Policy lattice stage (engine/verdict.py _probes + _combine) over either
// hashed L4 entry layout, planar rows plus a stash:
//   compact, 2 words: cw0 = idx18 | (dport & 0x3FFF) << 18
//     cw1 = dport >> 14 | proto << 2 | ep << 10 | dir << 18 | j << 19;
//     the matched slot j rebuilds the proxy port from l4_meta[ep, dir, j];
//   wide, 3 words (JAX engine/verdict.py:189-288): l4h_key0 = idx |
//     dir << 22 | (ep & 0x1FF) << 23, l4h_key1 = dport << 16 | proto << 8
//     | ep >> 9, value j << 16 | proxy summed over hits.
// The exact and wildcard probes are one row read each plus the stash.
// Table reads take their indices as an XLA gather does (gather_ix).
// PolicyView and tuple_verdict() are the whole lattice of one tuple from
// its raw identity (identity index through id_direct, then the hashed or
// dense probes, probe 2 and the combine), shared by LATTICE
// (csrc/lattice.cu) and DATAPATH6 (csrc/datapath6.cu).
#pragma once

#include "common.cuh"

namespace cdp {

constexpr uint32_t MATCH_NONE = 0, MATCH_L4 = 1, MATCH_L3 = 2,
                   MATCH_L4_WILD = 3, MATCH_FRAG_DROP = 4;
constexpr uint32_t L4H_WILD_IDX = (1u << 22) - 1;
constexpr uint32_t L4C_WILD_IDX18 = (1u << 18) - 1;
constexpr uint32_t L4C_CMP_MASK = ((1u << 19) - 1) | (1u << 31);

struct L4Probe {
  bool hit;
  uint32_t val;  // the summed slot index j of matching entries
};

__device__ __forceinline__ uint32_t l4c_key0(uint32_t idx, uint32_t dport) {
  const uint32_t idx18 = idx == L4H_WILD_IDX ? L4C_WILD_IDX18 : idx;
  return (idx18 & 0x3FFFFu) | ((dport & 0x3FFFu) << 18);
}

__device__ __forceinline__ uint32_t l4c_key1(uint32_t dport, uint32_t proto,
                                             uint32_t ep, uint32_t dir) {
  return (dport >> 14) | ((proto & 0xFFu) << 2) | ((ep & 0xFFu) << 10) |
         ((dir & 1u) << 18);
}

// The lane compares of one fetched row of `lanes` words holding ew-word
// planar entries (engine/verdict.py l4hash_row_parts): every matching
// lane counts, its value summed (j for compact entries, j << 16 | proxy
// for wide ones).  The key plane is walked whole (RD: how, common.cuh
// Reads), the rest read only where it matches.  The routed mesh probe
// (csrc/mesh.cu) calls it on the row its shard owns.
template <typename RD = ThreadReads>
__device__ __forceinline__ L4Probe l4_row_parts(const uint32_t* row,
                                                int lanes, int ew,
                                                uint32_t w0, uint32_t w1) {
  L4Probe p{false, 0u};
  const int e = lanes / ew;
  RD::keys(row, e, [&](int k, uint32_t key) {
    if (key != w0) return;
    const uint32_t k1 = __ldg(row + e + k);
    if (ew == 3) {
      if (k1 == w1) {
        p.hit = true;
        p.val += __ldg(row + 2 * e + k);
      }
    } else if ((k1 & L4C_CMP_MASK) == w1) {
      p.hit = true;
      p.val += (k1 >> 19) & 0xFFFu;
    }
  });
  return p;
}

// The same compares over a stash of stash_n ew-word entries
// (l4hash_stash_parts).
template <typename RD = ThreadReads>
__device__ __forceinline__ L4Probe l4_stash_parts(const uint32_t* stash,
                                                  int stash_n, int ew,
                                                  uint32_t w0, uint32_t w1) {
  L4Probe p{false, 0u};
  for (int s = 0; s < stash_n; ++s) {
    const uint32_t* ent = stash + static_cast<size_t>(ew) * s;
    if (RD::stash(ent) != w0) continue;
    const uint32_t k1 = RD::stash(ent + 1);
    if (ew == 3) {
      if (k1 == w1) {
        p.hit = true;
        p.val += RD::stash(ent + 2);
      }
    } else if ((k1 & L4C_CMP_MASK) == w1) {
      p.hit = true;
      p.val += (k1 >> 19) & 0xFFFu;
    }
  }
  return p;
}

// One hashed probe: the FNV-1a row, then its lanes and the stash.
template <typename RD = ThreadReads>
__device__ __forceinline__ L4Probe l4_probe_ew(const uint32_t* rows,
                                               int nrows, int lanes,
                                               const uint32_t* stash,
                                               int stash_n, int ew,
                                               uint32_t w0, uint32_t w1) {
  const uint32_t h = fnv1a2(w0, w1);
  const uint32_t* row =
      rows + static_cast<size_t>(h & static_cast<uint32_t>(nrows - 1)) * lanes;
  L4Probe p = l4_row_parts<RD>(row, lanes, ew, w0, w1);
  const L4Probe s = l4_stash_parts<RD>(stash, stash_n, ew, w0, w1);
  p.hit = p.hit || s.hit;
  p.val += s.val;
  return p;
}

// The probe key words of either layout (l4hash_probe_keys): ep and dir
// as u32 words, dport and proto clipped; idx may be L4H_WILD_IDX.
__device__ __forceinline__ void l4_keys(int ew, uint32_t ep, uint32_t dir,
                                        uint32_t dport, uint32_t proto,
                                        uint32_t idx, uint32_t* w0,
                                        uint32_t* w1) {
  if (ew == 3) {
    *w0 = idx | (dir << 22) | ((ep & 0x1FFu) << 23);
    *w1 = (dport << 16) | (proto << 8) | (ep >> 9);
  } else {
    *w0 = l4c_key0(idx, dport);
    *w1 = l4c_key1(dport, proto, ep, dir);
  }
}

// An XLA gather's index: negative counts from the end, then it clamps.
__device__ __forceinline__ int gather_ix(int32_t i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// dport and proto as the lattice takes them: clipped to their ranges
__device__ __forceinline__ uint32_t clip_u(int32_t v, int32_t hi) {
  return v < 0 ? 0u : static_cast<uint32_t>(v > hi ? hi : v);
}

// The hashed L4 tables and the l4_meta plane, as one stage reads them;
// shared by the datapath kernels (lattice() below) and LATTICE
// (csrc/lattice.cu).  ew is the entry word count (2 compact, 3 wide).
struct L4Tables {
  const uint32_t* rows;
  const uint32_t* stash;
  const uint32_t* wrows;
  const uint32_t* wstash;
  const uint32_t* meta;  // [n_eps, 2, kg]
  int32_t nrows;
  int32_t lanes;
  int32_t stash_n;
  int32_t wnrows;
  int32_t wlanes;
  int32_t wstash_n;
  int32_t ew;
  int32_t n_eps;
  int32_t kg;
};

struct Probes {
  bool p1, p3;
  int32_t proxy;
  int32_t j;
};

// Probes 1 and 3 over the hashed entry tables (engine/verdict.py
// _probes' hashed branch): the keys take ep and dir as u32 words, the
// compact layout's l4_meta read takes them as gather indices.  dport
// and proto are already clipped.
template <typename RD = ThreadReads>
__device__ __forceinline__ Probes hashed_probes(const L4Tables& t,
                                                uint32_t ep, uint32_t dir,
                                                uint32_t dport,
                                                uint32_t proto, uint32_t idx,
                                                bool known) {
  Probes r;
  if (t.ew == 3) {
    const uint32_t k1 = (dport << 16) | (proto << 8) | (ep >> 9);
    const uint32_t dk = (dir << 22) | ((ep & 0x1FFu) << 23);
    const L4Probe p1 = l4_probe_ew<RD>(t.rows, t.nrows, t.lanes, t.stash,
                                       t.stash_n, 3, idx | dk, k1);
    const L4Probe p3 = l4_probe_ew<RD>(t.wrows, t.wnrows, t.wlanes, t.wstash,
                                       t.wstash_n, 3, L4H_WILD_IDX | dk, k1);
    r.p1 = known && p1.hit;
    r.p3 = p3.hit;
    const uint32_t val = r.p1 ? p1.val : p3.val;
    r.proxy = static_cast<int32_t>(val & 0xFFFFu);
    r.j = static_cast<int32_t>(val >> 16);
    return r;
  }
  const uint32_t k1 = l4c_key1(dport, proto, ep, dir);
  const L4Probe p1 = l4_probe_ew<RD>(t.rows, t.nrows, t.lanes, t.stash,
                                     t.stash_n, 2, l4c_key0(idx, dport), k1);
  const L4Probe p3 =
      l4_probe_ew<RD>(t.wrows, t.wnrows, t.wlanes, t.wstash, t.wstash_n, 2,
                      l4c_key0(L4H_WILD_IDX, dport), k1);
  r.p1 = known && p1.hit;
  r.p3 = p3.hit;
  r.j = static_cast<int32_t>(r.p1 ? p1.val : p3.val);
  const uint32_t meta = __ldg(
      t.meta + (static_cast<size_t>(gather_ix(static_cast<int32_t>(ep),
                                              t.n_eps)) * 2 +
                gather_ix(static_cast<int32_t>(dir), 2)) *
                   t.kg +
      gather_ix(r.j, t.kg));
  r.proxy = (r.p1 || r.p3) ? static_cast<int32_t>(meta >> 1) : 0;
  return r;
}

struct Lattice {
  bool allowed;
  int32_t proxy;
  uint32_t kind;
  int32_t j;
};

// The combine (policy.h order; fragments skip the L4 probes).
__device__ __forceinline__ Lattice combine(bool probe1, bool probe2,
                                           bool probe3, int32_t proxy,
                                           int32_t j, bool frag) {
  const bool q1 = probe1 && !frag;
  const bool q3 = probe3 && !frag;
  Lattice r;
  r.allowed = q1 || probe2 || q3;
  r.proxy = (r.allowed && (q1 || (!probe2 && q3))) ? proxy : 0;
  r.kind = q1       ? MATCH_L4
           : probe2 ? MATCH_L3
           : q3     ? MATCH_L4_WILD
           : frag   ? MATCH_FRAG_DROP
                    : MATCH_NONE;
  r.j = j;
  return r;
}

// The policy tables as the tuple lattice reads them.  The field order is
// the ctypes Structure's order in kernels.py (PolicyViewArgs).
struct PolicyView {
  const uint32_t* id_direct;  // [direct_n]
  const uint32_t* l3_allow;   // [E, 2, W]
  const uint32_t* port_slot;  // [256, 65536] u16 values (dense branch)
  const uint32_t* l4_allow;   // [E, 2, Kg, W] (dense branch)
  L4Tables l4;                // rows null: the dense branch
  int32_t direct_n;
  int32_t n_ids;
  int32_t n_words;
  uint32_t lo_len;
};

constexpr uint32_t LOCAL_ID_BASE = 1u << 24;
constexpr uint32_t NO_INDEX = 0xFFFFFFFFu;
constexpr uint32_t RESERVED_WORLD = 2;  // an ipcache miss's identity
constexpr uint32_t NO_SLOT = 0xFFFFu;

// identity -> dense index through id_direct's two regions, with the
// reference's unsigned compares and position clamp; an unknown identity
// gets n_ids - 1 (engine/verdict.py _index_identity).
__device__ __forceinline__ uint32_t index_identity(const uint32_t* id_direct,
                                                   int32_t direct_n_i,
                                                   uint32_t lo_len,
                                                   int32_t n_ids,
                                                   uint32_t ident,
                                                   bool* known) {
  const bool local = ident >= LOCAL_ID_BASE;
  const uint32_t off = ident - LOCAL_ID_BASE;
  const uint32_t direct_n = static_cast<uint32_t>(direct_n_i);
  const bool in_range = local ? off < direct_n - lo_len : ident < lo_len;
  uint32_t pos = local ? lo_len + off : ident;
  pos = pos < direct_n - 1 ? pos : direct_n - 1;
  const uint32_t v = __ldg(id_direct + pos);
  *known = in_range && v != NO_INDEX;
  return *known ? v : static_cast<uint32_t>(n_ids - 1);
}

__device__ __forceinline__ uint32_t index_identity(const PolicyView& p,
                                                   uint32_t ident,
                                                   bool* known) {
  return index_identity(p.id_direct, p.direct_n, p.lo_len, p.n_ids, ident,
                        known);
}

// Probes 1 and 3 without the hashed tables (engine/verdict.py _probes'
// dense branch, K8): the slot from port_slot[proto, dport] (u16 values
// in int32), then l4_allow_bits[ep, dir, j, word] and l4_meta[ep, dir,
// j], ep, dir and j taken as an XLA gather takes them.  `word` indexes
// the n_words on hand (dense_word(), or a shard's local word) and `bit`
// is idx & 31; dport and proto are already clipped.  Shared by the tuple
// lattice (index_probes), the datapath kernels (lattice()) and the
// word-sharded mesh probe (csrc/mesh.cu).
__device__ __forceinline__ int dense_word(uint32_t idx, int n_words) {
  return gather_ix(static_cast<int32_t>(idx) >> 5, n_words);
}

__device__ __forceinline__ Probes dense_probes(
    const uint32_t* port_slot, const uint32_t* l4_allow, const uint32_t* meta,
    int n_eps, int kg, int n_words, int32_t ep, int32_t dir, uint32_t dport,
    uint32_t proto, int word, uint32_t bit, bool known) {
  const size_t row =
      static_cast<size_t>(gather_ix(ep, n_eps)) * 2 + gather_ix(dir, 2);
  const uint32_t slot = __ldg(port_slot + proto * 65536u + dport);
  const bool has_port = slot != NO_SLOT;
  Probes q;
  q.j = has_port ? static_cast<int32_t>(slot) : 0;
  const size_t cell = row * kg + gather_ix(q.j, kg);
  const uint32_t exact = __ldg(l4_allow + cell * n_words + word);
  const uint32_t m = __ldg(meta + cell);
  q.proxy = static_cast<int32_t>(m >> 1);
  q.p1 = known && has_port && ((exact >> bit) & 1u);
  q.p3 = has_port && (m & 1u);
  return q;
}

// The three probes of one tuple from its resolved identity index
// (engine/verdict.py _probes with idx_known): ep and dir are the
// tuple's int32 words, dport and proto already clipped.  `l3_bit` < 0
// reads probe 2's bit from l3_allow_bits (word idx >> 5 taken as a gather
// index), else it is the ipcache's L3 bit.  RD reads the hashed rows'
// key planes (hashed_probes).  Shared by tuple_verdict() and the verdict
// memo's lattice on missed keys (csrc/memo.cu, with PairReads).
struct ProbeBits {
  bool p1, p2, p3;
  int32_t proxy;
  int32_t j;
};

template <typename RD = ThreadReads>
__device__ __forceinline__ ProbeBits index_probes(const PolicyView& p,
                                                  int32_t ep, int32_t dir,
                                                  uint32_t dport,
                                                  uint32_t proto, uint32_t idx,
                                                  bool known, int l3_bit) {
  const int word = dense_word(idx, p.n_words);
  const uint32_t bit = idx & 31u;
  const size_t row = static_cast<size_t>(gather_ix(ep, p.l4.n_eps)) * 2 +
                     gather_ix(dir, 2);
  const Probes q =
      p.l4.rows ? hashed_probes<RD>(p.l4, static_cast<uint32_t>(ep),
                                    static_cast<uint32_t>(dir), dport, proto,
                                    idx, known)
                : dense_probes(p.port_slot, p.l4_allow, p.l4.meta, p.l4.n_eps,
                               p.l4.kg, p.n_words, ep, dir, dport, proto, word,
                               bit, known);
  bool l3;
  if (l3_bit < 0) {
    l3 = (__ldg(p.l3_allow + row * p.n_words + word) >> bit) & 1u;
  } else {
    l3 = l3_bit != 0;
  }
  return ProbeBits{q.p1, known && l3, q.p3, q.proxy, q.j};
}

// The lattice of one tuple (engine/verdict.py _probes + _combine): ep and
// dir are the tuple's int32 words, dport and proto already clipped to
// their ranges.  Writes the identity index to *idx (the counters' L3
// column).  RD reads the hashed rows' key planes (index_probes).
template <typename RD = ThreadReads>
__device__ __forceinline__ Lattice tuple_verdict(const PolicyView& p,
                                                 int32_t ep, int32_t dir,
                                                 uint32_t dport,
                                                 uint32_t proto,
                                                 uint32_t ident, bool frag,
                                                 uint32_t* idx) {
  bool known;
  *idx = index_identity(p, ident, &known);
  const ProbeBits b =
      index_probes<RD>(p, ep, dir, dport, proto, *idx, known, -1);
  return combine(b.p1, b.p2, b.p3, b.proxy, b.j, frag);
}

__device__ __forceinline__ L4Tables l4_tables(const DatapathArgs& a) {
  return L4Tables{a.l4_rows,   a.l4_stash,  a.l4w_rows, a.l4w_stash,
                  a.l4_meta,   a.l4_nrows,  a.l4_lanes, a.l4_stash_n,
                  a.l4w_nrows, a.l4w_lanes, a.l4w_stash_n, a.l4_ew,
                  a.n_eps,     a.kg};
}

// Probe 2's bit from l3_allow_bits [n_eps, 2, n_words] (the datapath
// without L3 planes): endpoint, direction and word (idx as int32 >> 5)
// taken as an XLA gather takes them.
__device__ __forceinline__ bool l3_allow_bit(const DatapathArgs& a,
                                             uint32_t ep, uint32_t dir,
                                             uint32_t idx) {
  const size_t row =
      static_cast<size_t>(gather_ix(static_cast<int32_t>(ep), a.n_eps)) * 2 +
      gather_ix(static_cast<int32_t>(dir), 2);
  const int word = dense_word(idx, a.n_words);
  return (__ldg(a.l3_allow + row * a.n_words + word) >> (idx & 31u)) & 1u;
}

// The datapath's lattice: probes 1-3 and the combine, with idx and known
// from the ipcache (or id_direct) and l3_bit from the ipcache's L3 word
// or l3_allow_bit; `t` is l4_tables(a), its stashes where the kernel
// keeps them; without the hashed L4 tables (l4_rows null) probes 1 and 3
// read the dense planes (K8's dense branch).
template <typename RD = ThreadReads>
__device__ __forceinline__ Lattice lattice(const DatapathArgs& a,
                                           const L4Tables& t, uint32_t ep,
                                           uint32_t dir, uint32_t dport_w,
                                           uint32_t proto_w, uint32_t idx,
                                           bool known, bool l3_bit,
                                           bool frag) {
  const uint32_t dport = clip_u(static_cast<int32_t>(dport_w), 65535);
  const uint32_t proto = clip_u(static_cast<int32_t>(proto_w), 255);
  const Probes p =
      a.l4_rows ? hashed_probes<RD>(t, ep, dir, dport, proto, idx, known)
                : dense_probes(a.port_slot, a.l4_allow, a.l4_meta, a.n_eps,
                               a.kg, a.n_words, static_cast<int32_t>(ep),
                               static_cast<int32_t>(dir), dport, proto,
                               dense_word(idx, a.n_words), idx & 31u, known);
  return combine(p.p1, known && l3_bit, p.p3, p.proxy, p.j, frag);
}

}  // namespace cdp
