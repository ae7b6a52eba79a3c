// Kafka rule matching on the card: the device code of K17a.
//
// Replaces the JAX package's `evaluate_kafka_batch`
// (cilium_tpu/l7/kafka.py), which compares every request with every
// rule as [B, R] and [B, T, R] integer tensors.  A rule can reach the
// reference's `base` only when its bit is set in the request's
// identity row (and scope row) and the identity is known, so each
// thread walks exactly those rules, word by word, and gives the same
// answer: `allow_all` when a matching rule names no topic (or the
// request has none), else every active topic slot must be covered by
// a matching rule naming it.  Overflowed rows are denied.  The rule
// columns are staged in shared memory by the whole block first.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dfa.cuh"

namespace cl7 {

struct KafkaTablesArgs {
  const uint32_t* keys_lo;   // [R] api keys 0-31 bitmask
  const uint32_t* keys_hi;   // [R] api keys 32-63
  const uint8_t* keys_any;   // [R] wildcard api key
  const int32_t* version;    // [R] -1 = wildcard
  const uint32_t* client;    // [R] 0 = wildcard
  const uint32_t* topic;     // [R] 0 = wildcard
  const uint32_t* ident_rules;  // [N, W]
  int32_t n_rules;
  int32_t n_ident;
  int32_t n_words;
};

struct KafkaFieldsArgs {
  const int32_t* kind;         // [B] api key
  const int32_t* version;      // [B]
  const uint32_t* client;      // [B] interned, 0 = unseen
  const uint32_t* topics;      // [B, T] interned, 0xFFFFFFFF = empty slot
  const int32_t* topic_count;  // [B]
  const uint8_t* parsed;       // [B]
  const uint8_t* checks_client;  // [B]
  const uint8_t* overflow;     // [B]
  int32_t n_topics;            // T <= 32
};

struct KafkaShared {
  const uint32_t* keys_lo;
  const uint32_t* keys_hi;
  const uint32_t* client;
  const uint32_t* topic;
  const int32_t* version;
  const uint8_t* keys_any;
  const uint32_t* ident_rules;
  int32_t n_rules;
  int32_t n_ident;
  int32_t n_words;
};

__host__ __device__ inline size_t kafka_smem_bytes(const KafkaTablesArgs& t) {
  const size_t r = static_cast<size_t>(t.n_rules);
  return 5 * align16(r * sizeof(uint32_t)) + align16(r);
}

// Copies the rule columns into `smem` with every thread of the block;
// the caller synchronises the block before reading them.
__device__ inline KafkaShared stage_kafka(const KafkaTablesArgs& t,
                                          unsigned char* smem) {
  const int r = t.n_rules;
  const size_t col = align16(static_cast<size_t>(r) * sizeof(uint32_t));
  uint32_t* lo = reinterpret_cast<uint32_t*>(smem);
  uint32_t* hi = reinterpret_cast<uint32_t*>(smem + col);
  uint32_t* cl = reinterpret_cast<uint32_t*>(smem + 2 * col);
  uint32_t* tp = reinterpret_cast<uint32_t*>(smem + 3 * col);
  int32_t* ver = reinterpret_cast<int32_t*>(smem + 4 * col);
  uint8_t* any = smem + 5 * col;
  for (int k = threadIdx.x; k < r; k += blockDim.x) {
    lo[k] = t.keys_lo[k];
    hi[k] = t.keys_hi[k];
    cl[k] = t.client[k];
    tp[k] = t.topic[k];
    ver[k] = t.version[k];
    any[k] = t.keys_any[k];
  }
  return KafkaShared{lo, hi, cl, tp, ver, any, t.ident_rules,
                     r, t.n_ident, t.n_words};
}

// Row i's verdict.  `topic_kinds` has bit k set for each api key k < 64
// whose request carries topics; `scope` may be null.
__device__ inline bool kafka_match(const KafkaShared& k,
                                   const KafkaFieldsArgs& f, size_t i,
                                   int32_t ident, bool known,
                                   const uint32_t* scope,
                                   uint64_t topic_kinds) {
  const int32_t kind = __ldg(f.kind + i);
  const int32_t ver = __ldg(f.version + i);
  const uint32_t cli = __ldg(f.client + i);
  const int32_t count = __ldg(f.topic_count + i);
  const bool parsed = __ldg(f.parsed + i) != 0;
  const bool checks = __ldg(f.checks_client + i) != 0;
  const int t_count = f.n_topics;
  const uint32_t* topics = f.topics + i * t_count;
  // the reference shifts by clip(kind, 0, 31) and clip(kind - 32, 0, 31)
  // and gates negative kinds off; kinds of 64 or more match no word
  const bool topic_kind =
      kind >= 0 && kind < 64 && ((topic_kinds >> kind) & 1ull) != 0;
  bool allow_all = false;
  uint32_t covered = 0;  // bit t: topic slot t covered by a matching rule
  if (known) {
    const uint32_t* irow =
        k.ident_rules +
        static_cast<size_t>(clamp_index(ident, k.n_ident)) * k.n_words;
    for (int w = 0; w < k.n_words && !allow_all; ++w) {
      uint32_t bits = __ldg(irow + w);
      if (scope != nullptr) bits &= __ldg(scope + w);
      while (bits != 0u) {
        const int r = w * 32 + __ffs(bits) - 1;
        bits &= bits - 1u;
        if (r >= k.n_rules) break;
        bool key_ok = k.keys_any[r] != 0;
        if (!key_ok && kind >= 0) {
          if (kind < 32)
            key_ok = ((k.keys_lo[r] >> kind) & 1u) != 0;
          else if (kind < 64)
            key_ok = ((k.keys_hi[r] >> (kind - 32)) & 1u) != 0;
        }
        if (kind < 0) key_ok = false;
        const int32_t rv = k.version[r];
        const uint32_t rc = k.client[r];
        const uint32_t rt = k.topic[r];
        const bool ver_ok = rv < 0 || rv == ver;
        const bool client_ok = rc == 0u || rc == cli || !checks;
        const bool nontopic_ok = !(rt != 0u && topic_kind && !parsed);
        if (!(key_ok && ver_ok && client_ok && nontopic_ok)) continue;
        if (rt == 0u || count == 0) {
          allow_all = true;
          break;
        }
        for (int t = 0; t < t_count; ++t) {
          if (__ldg(topics + t) == rt) covered |= 1u << t;
        }
      }
    }
  }
  bool all_covered = count > 0;
  for (int t = 0; t < t_count && all_covered; ++t) {
    if (t < count && ((covered >> t) & 1u) == 0u) all_covered = false;
  }
  return (allow_all || all_covered) && __ldg(f.overflow + i) == 0;
}

}  // namespace cl7
