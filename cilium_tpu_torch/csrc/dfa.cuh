// HTTP DFA matching on the card: the device code of K16.
//
// Replaces the JAX package's `evaluate_http_batch`
// (cilium_tpu/l7/http.py, with `_dfa_scan` and `_dfa_scan_strided`).
// Each thread scans its request's method, path and host through the
// three union DFAs, one byte per step with the base transition table,
// stopping at the field's length (the reference's `pos < len` gate;
// a length above the row width scans the whole row, a length of 0 or
// less leaves the start state).  The strided form of the reference
// ends in the same state, since its padding maps to an identity class,
// so the byte scan needs no strided tables.  The three DFAs' tables
// (transitions as u16, byte classes, accept words, absent words) are
// staged in shared memory by the whole block first.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cl7 {

constexpr int N_FIELDS = 3;  // method, path, host

// One union DFA as the wrapper hands it over, in device memory.
struct DfaGlobal {
  const int32_t* trans;    // [S, C], u16 values held in int32
  const uint8_t* classes;  // [256] byte -> class
  const uint32_t* accept;  // [S, W] per-rule accept bits
  int32_t n_states;
  int32_t n_classes;
  int32_t start;
};

struct HttpTablesArgs {
  DfaGlobal dfa[N_FIELDS];
  const uint32_t* absent[N_FIELDS];  // [W] rules that omit the field
  const uint32_t* ident_rules;       // [N, W]
  int32_t n_ident;
  int32_t n_words;
};

struct HttpFieldsArgs {
  const uint8_t* data[N_FIELDS];  // [B, L_f] bytes, row-major
  const int32_t* len[N_FIELDS];   // [B]
  int32_t width[N_FIELDS];        // L_f
};

// The same tables once staged in shared memory.
struct DfaShared {
  const uint16_t* trans;
  const uint8_t* classes;
  const uint32_t* accept;
  int32_t n_classes;
  int32_t start;
};

struct HttpShared {
  DfaShared dfa[N_FIELDS];
  const uint32_t* absent[N_FIELDS];
  const uint32_t* ident_rules;
  int32_t n_ident;
  int32_t n_words;
};

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Bytes of shared memory the HTTP tables take, in staging order.
__host__ __device__ inline size_t http_smem_bytes(const HttpTablesArgs& t) {
  size_t n = 0;
  for (int f = 0; f < N_FIELDS; ++f) {
    const size_t s = static_cast<size_t>(t.dfa[f].n_states);
    n += align16(256);
    n += align16(s * t.dfa[f].n_classes * sizeof(uint16_t));
    n += align16(s * t.n_words * sizeof(uint32_t));
    n += align16(static_cast<size_t>(t.n_words) * sizeof(uint32_t));
  }
  return n;
}

// Copies the tables into `smem` with every thread of the block; the
// caller synchronises the block before reading them.
__device__ inline HttpShared stage_http(const HttpTablesArgs& t,
                                        unsigned char* smem) {
  HttpShared h;
  size_t off = 0;
#pragma unroll
  for (int f = 0; f < N_FIELDS; ++f) {
    const DfaGlobal& d = t.dfa[f];
    const int sc = d.n_states * d.n_classes;
    const int sw = d.n_states * t.n_words;
    uint8_t* cls = smem + off;
    off += align16(256);
    uint16_t* tr = reinterpret_cast<uint16_t*>(smem + off);
    off += align16(static_cast<size_t>(sc) * sizeof(uint16_t));
    uint32_t* acc = reinterpret_cast<uint32_t*>(smem + off);
    off += align16(static_cast<size_t>(sw) * sizeof(uint32_t));
    uint32_t* ab = reinterpret_cast<uint32_t*>(smem + off);
    off += align16(static_cast<size_t>(t.n_words) * sizeof(uint32_t));
    for (int k = threadIdx.x; k < 256; k += blockDim.x) cls[k] = d.classes[k];
    for (int k = threadIdx.x; k < sc; k += blockDim.x)
      tr[k] = static_cast<uint16_t>(d.trans[k]);
    for (int k = threadIdx.x; k < sw; k += blockDim.x) acc[k] = d.accept[k];
    for (int k = threadIdx.x; k < t.n_words; k += blockDim.x)
      ab[k] = t.absent[f][k];
    h.dfa[f] = DfaShared{tr, cls, acc, d.n_classes, d.start};
    h.absent[f] = ab;
  }
  h.ident_rules = t.ident_rules;
  h.n_ident = t.n_ident;
  h.n_words = t.n_words;
  return h;
}

// The final state of one field: min(len, width) byte steps.
__device__ inline int dfa_scan(const DfaShared& d, const uint8_t* row,
                               int width, int len) {
  int s = d.start;
  const int n = len < width ? len : width;
  for (int p = 0; p < n; ++p) {
    s = d.trans[s * d.n_classes + d.classes[__ldg(row + p)]];
  }
  return s;
}

__device__ inline int clamp_index(int v, int n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

// Row i's verdict: matched[w] = (acc_m | absent_m) & (acc_p | absent_p)
// & (acc_h | absent_h) & ident_rules[clip(ident)][w] & (known ? ~0 : 0)
// & scope[w] over the W words; allowed = any word non-zero.  `scope`
// and `matched` may be null (no scope; matched words not wanted).
__device__ inline bool http_match(const HttpShared& h,
                                  const HttpFieldsArgs& f, size_t i,
                                  int32_t ident, bool known,
                                  const uint32_t* scope, uint32_t* matched) {
  int st[N_FIELDS];
#pragma unroll
  for (int fld = 0; fld < N_FIELDS; ++fld) {
    const int width = f.width[fld];
    st[fld] = dfa_scan(h.dfa[fld], f.data[fld] + i * width, width,
                       __ldg(f.len[fld] + i));
  }
  const int w_count = h.n_words;
  const uint32_t* irow =
      h.ident_rules +
      static_cast<size_t>(clamp_index(ident, h.n_ident)) * w_count;
  const uint32_t* am = h.dfa[0].accept + static_cast<size_t>(st[0]) * w_count;
  const uint32_t* ap = h.dfa[1].accept + static_cast<size_t>(st[1]) * w_count;
  const uint32_t* ah = h.dfa[2].accept + static_cast<size_t>(st[2]) * w_count;
  const uint32_t kmask = known ? 0xFFFFFFFFu : 0u;
  bool any = false;
  for (int w = 0; w < w_count; ++w) {
    uint32_t m = (am[w] | h.absent[0][w]) & (ap[w] | h.absent[1][w]) &
                 (ah[w] | h.absent[2][w]) & __ldg(irow + w) & kmask;
    if (scope != nullptr) m &= __ldg(scope + w);
    if (matched != nullptr) matched[w] = m;
    any |= m != 0;
  }
  return any;
}

}  // namespace cl7
