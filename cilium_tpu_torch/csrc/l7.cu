// L7 policy on the card: four CUDA kernels for Hopper (sm_90a).
//
//   http_match_kernel      K16  replaces evaluate_http_batch
//                               (cilium_tpu/l7/http.py, with _dfa_scan,
//                               _dfa_scan_strided and _mxu_lookup)
//   kafka_match_kernel     K17a replaces evaluate_kafka_batch
//                               (cilium_tpu/l7/kafka.py)
//   fleet_l7_kernel        K17b replaces evaluate_fleet_l7
//                               (cilium_tpu/l7/fleet.py)
//   memcache_match_kernel  K17c replaces MemcacheDeviceTables.evaluate's
//                               device part (cilium_tpu/l7/memcached.py)
//
// Shape: one thread per request (or per compacted redirected flow),
// blocks of 256.  Each block first stages the tables it reads often
// (the three union DFAs, the Kafka rule columns) in dynamic shared
// memory; the wrapper refuses tables that exceed the card's limit for
// one block.  The per-identity rule rows and the per-scope rows stay in
// device memory and are read once per request.
//
// What bounds them on an H100: the HTTP scan is a chain of dependent
// shared-memory lookups, two per byte (class, then transition), over
// each request's own bytes; the Kafka match walks the few rules that
// the identity row and the scope row admit.  The bytes a request moves
// are its fields, its identity and scope rows and one byte of verdict.
// This first version reads each thread's field bytes with byte loads
// from its own row: threads of a warp touch 32 different rows, so the
// loads do not coalesce; that, and not arithmetic, is the first thing
// to change when the kernels are made fast.
//
// The memcached match stages the rule columns (256-bit opcode mask,
// exact key id, device flag) in dynamic shared memory a tile of
// min(R, MC_TILE) rules at a time, so a short table reserves only what
// it holds; each thread then walks only the rules whose
// bit is set in its identity's row, reading each row word once.  It
// stops at the first live device rule (allowed); a host-only rule it
// passes sets needs_host, which an allow clears.
#include <cuda_runtime.h>

#include <cstdint>

#include "dfa.cuh"
#include "kafka.cuh"

namespace cl7 {

constexpr int BLOCK = 256;
constexpr int PARSER_HTTP = 1;
constexpr int PARSER_KAFKA = 2;

struct HttpArgs {
  HttpTablesArgs t;
  HttpFieldsArgs f;
  const int32_t* ident_idx;  // [B]
  const uint8_t* known;      // [B]
  const uint32_t* scope;     // [B, W] or null
  uint8_t* allowed;          // [B]
  uint32_t* matched;         // [B, W]
  int32_t n;                 // B
};

struct KafkaArgs {
  KafkaTablesArgs t;
  KafkaFieldsArgs f;
  const int32_t* ident_idx;
  const uint8_t* known;
  const uint32_t* scope;  // [B, W] or null
  uint8_t* allowed;
  uint64_t topic_kinds;
  int32_t n;
};

struct FleetArgs {
  HttpTablesArgs http;
  HttpFieldsArgs hf;
  KafkaTablesArgs kafka;
  KafkaFieldsArgs kf;
  const uint8_t* parser_kind;   // [E * 2 * Kg]
  const uint32_t* scope_http;   // [E * 2 * Kg, Wh]
  const uint32_t* scope_kafka;  // [E * 2 * Kg, Wk]
  const int32_t* ep_index;      // [B]
  const int32_t* direction;     // [B]
  const int32_t* l4_slot;       // [B]
  const int32_t* ident_idx;     // [B]
  const uint8_t* known;         // [B]
  uint8_t* allowed;             // [B]
  uint64_t topic_kinds;
  int32_t has_http;   // the fleet has HTTP tables and the call has fields
  int32_t has_kafka;  // the same for Kafka
  int32_t n_scopes;   // E * 2 * Kg
  int32_t kg;
  int32_t n;
};

struct MemcacheArgs {
  const uint32_t* opcode_mask;  // [R, 8] 256-bit opcode mask per rule
  const uint32_t* rule_key;     // [R] interned exact key, 0 = any
  const uint8_t* device_ok;     // [R] 0 = prefix/regex rule (host only)
  const uint32_t* ident_rules;  // [N, W] rule-membership bits
  const int32_t* opcode;        // [B] raw opcode, -1 = absent
  const uint32_t* key_id;       // [B] interned key, 0 = absent/unseen
  const int32_t* ident_idx;     // [B]
  const uint8_t* known;         // [B]
  uint8_t* allowed;             // [B]
  uint8_t* needs_host;          // [B]
  int32_t n_rules;              // R (never the padded row of R = 0)
  int32_t n_ident;              // N
  int32_t n_words;              // W >= ceil(R / 32)
  int32_t n;                    // B
};

constexpr int MC_TILE = 1024;  // most rules per shared-memory tile (37 KB)

// Rules per tile: all R when they fit one tile, else MC_TILE.
__host__ __device__ inline int memcache_tile(const MemcacheArgs& a) {
  return a.n_rules < MC_TILE ? a.n_rules : MC_TILE;
}

// A tile's mask words, key ids and device flags: 37 bytes a rule.
inline size_t memcache_smem_bytes(const MemcacheArgs& a) {
  return static_cast<size_t>(memcache_tile(a)) * (8 * 4 + 4 + 1);
}

inline size_t fleet_smem_bytes(const FleetArgs& a) {
  return (a.has_http ? http_smem_bytes(a.http) : 0) +
         (a.has_kafka ? kafka_smem_bytes(a.kafka) : 0);
}

__global__ void __launch_bounds__(BLOCK) http_match_kernel(const HttpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const HttpShared h = stage_http(a.t, smem);
  __syncthreads();
  const size_t i = static_cast<size_t>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= static_cast<size_t>(a.n)) return;
  const size_t w = static_cast<size_t>(a.t.n_words);
  a.allowed[i] = http_match(h, a.f, i, __ldg(a.ident_idx + i),
                            __ldg(a.known + i) != 0,
                            a.scope != nullptr ? a.scope + i * w : nullptr,
                            a.matched + i * w);
}

__global__ void __launch_bounds__(BLOCK) kafka_match_kernel(const KafkaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const KafkaShared k = stage_kafka(a.t, smem);
  __syncthreads();
  const size_t i = static_cast<size_t>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= static_cast<size_t>(a.n)) return;
  const size_t w = static_cast<size_t>(a.t.n_words);
  a.allowed[i] = kafka_match(k, a.f, i, __ldg(a.ident_idx + i),
                             __ldg(a.known + i) != 0,
                             a.scope != nullptr ? a.scope + i * w : nullptr,
                             a.topic_kinds);
}

__global__ void __launch_bounds__(BLOCK) fleet_l7_kernel(const FleetArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  HttpShared h{};
  KafkaShared k{};
  size_t off = 0;
  if (a.has_http) {
    h = stage_http(a.http, smem);
    off = http_smem_bytes(a.http);
  }
  if (a.has_kafka) k = stage_kafka(a.kafka, smem + off);
  __syncthreads();
  const size_t i = static_cast<size_t>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= static_cast<size_t>(a.n)) return;
  // lin = ep * 2Kg + dir * Kg + clip(slot, 0, Kg - 1), read as the
  // reference's gather reads it: negative from the end, then clamped
  const int32_t slot = __ldg(a.l4_slot + i);
  int64_t lin = static_cast<int64_t>(__ldg(a.ep_index + i)) * (2 * a.kg) +
                static_cast<int64_t>(__ldg(a.direction + i)) * a.kg +
                (slot < 0 ? 0 : (slot >= a.kg ? a.kg - 1 : slot));
  if (lin < 0) lin += a.n_scopes;
  lin = lin < 0 ? 0 : (lin >= a.n_scopes ? a.n_scopes - 1 : lin);
  const int kind = a.parser_kind[lin];
  const int32_t ident = __ldg(a.ident_idx + i);
  const bool known = __ldg(a.known + i) != 0;
  bool ok = false;
  if (kind == PARSER_HTTP && a.has_http) {
    ok = http_match(h, a.hf, i, ident, known,
                    a.scope_http + lin * a.http.n_words, nullptr);
  } else if (kind == PARSER_KAFKA && a.has_kafka) {
    ok = kafka_match(k, a.kf, i, ident, known,
                     a.scope_kafka + lin * a.kafka.n_words, a.topic_kinds);
  }
  a.allowed[i] = ok;
}

__global__ void __launch_bounds__(BLOCK)
    memcache_match_kernel(const MemcacheArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = memcache_tile(a);
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_key = s_mask + static_cast<size_t>(tile) * 8;
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(s_key + tile);
  const size_t i = static_cast<size_t>(blockIdx.x) * BLOCK + threadIdx.x;
  const bool live = i < static_cast<size_t>(a.n);
  int32_t raw = -1;
  uint32_t key = 0;
  int32_t ident = 0;
  bool known = false;
  if (live) {
    raw = __ldg(a.opcode + i);
    key = __ldg(a.key_id + i);
    ident = __ldg(a.ident_idx + i);
    known = __ldg(a.known + i) != 0;
  }
  // the mask word and bit of the opcode clipped to [0, 255]; a negative
  // raw opcode matches no rule
  const int op = raw < 0 ? 0 : (raw > 255 ? 255 : raw);
  const int op_word = op >> 5;
  const uint32_t op_bit = static_cast<uint32_t>(op & 31);
  // the identity row, clipped to [0, N - 1]; `known` masks it
  const int32_t row = ident < 0 ? 0 : (ident >= a.n_ident ? a.n_ident - 1
                                                          : ident);
  const uint32_t* irow =
      a.ident_rules + static_cast<size_t>(row) * static_cast<size_t>(a.n_words);
  bool ok = false;
  bool host = false;
  for (int t0 = 0; t0 < a.n_rules; t0 += tile) {
    const int tn = min(tile, a.n_rules - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < tn; k += BLOCK) {
      s_key[k] = __ldg(a.rule_key + t0 + k);
      s_ok[k] = __ldg(a.device_ok + t0 + k);
    }
    for (int k = threadIdx.x; k < tn * 8; k += BLOCK) {
      s_mask[k] = __ldg(a.opcode_mask + static_cast<size_t>(t0) * 8 + k);
    }
    __syncthreads();
    if (!live || !known || ok) continue;
    // one tile holds every rule, or MC_TILE (a multiple of 32) of them:
    // a tile's rules are whole words
    const int w_end = (t0 + tn + 31) >> 5;
    for (int w = t0 >> 5; w < w_end && !ok; ++w) {
      uint32_t bits = __ldg(irow + w);
      const int past = a.n_rules - (w << 5);  // rules left from this word
      if (past < 32) bits &= (1u << past) - 1u;
      while (bits != 0u) {
        const int j = (w << 5) + __ffs(bits) - 1 - t0;
        bits &= bits - 1u;
        if (!s_ok[j]) {
          host = true;
        } else if (raw >= 0 && ((s_mask[j * 8 + op_word] >> op_bit) & 1u) &&
                   (s_key[j] == 0u || s_key[j] == key)) {
          ok = true;
          break;
        }
      }
    }
  }
  if (live) {
    a.allowed[i] = ok;
    a.needs_host[i] = host && !ok;
  }
}

// Sets the kernel's dynamic shared memory and launches it; returns
// cudaGetLastError(), or cudaErrorInvalidValue when the tables do not
// fit one block's shared memory (the wrapper checks that first).
template <typename Args>
int launch(void (*kernel)(const Args), const Args& a, size_t smem,
           void* stream) {
  int dev = 0;
  int limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  if (a.n > 0) {
    const unsigned grid = static_cast<unsigned>((a.n + BLOCK - 1) / BLOCK);
    kernel<<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cl7

extern "C" int l7_struct_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(cl7::HttpArgs));
  out[1] = static_cast<int>(sizeof(cl7::KafkaArgs));
  out[2] = static_cast<int>(sizeof(cl7::FleetArgs));
  out[3] = static_cast<int>(sizeof(cl7::MemcacheArgs));
  return 4;
}

// The most dynamic shared memory one block may use on the current card.
extern "C" int l7_smem_limit() {
  int dev = 0;
  int limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return limit;
}

extern "C" long long http_match_smem(const cl7::HttpArgs* a) {
  return static_cast<long long>(cl7::http_smem_bytes(a->t));
}

extern "C" long long kafka_match_smem(const cl7::KafkaArgs* a) {
  return static_cast<long long>(cl7::kafka_smem_bytes(a->t));
}

extern "C" long long fleet_l7_smem(const cl7::FleetArgs* a) {
  return static_cast<long long>(cl7::fleet_smem_bytes(*a));
}

extern "C" int launch_http_match(const cl7::HttpArgs* a, void* stream) {
  return cl7::launch(cl7::http_match_kernel, *a, cl7::http_smem_bytes(a->t),
                     stream);
}

extern "C" int launch_kafka_match(const cl7::KafkaArgs* a, void* stream) {
  return cl7::launch(cl7::kafka_match_kernel, *a,
                     cl7::kafka_smem_bytes(a->t), stream);
}

extern "C" int launch_fleet_l7(const cl7::FleetArgs* a, void* stream) {
  return cl7::launch(cl7::fleet_l7_kernel, *a, cl7::fleet_smem_bytes(*a),
                     stream);
}

extern "C" int launch_memcache_match(const cl7::MemcacheArgs* a,
                                     void* stream) {
  return cl7::launch(cl7::memcache_match_kernel, *a,
                     cl7::memcache_smem_bytes(*a), stream);
}
