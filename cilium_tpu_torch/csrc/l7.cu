// L7 policy on the card: three CUDA kernels for Hopper (sm_90a).
//
//   http_match_kernel   K16  replaces evaluate_http_batch
//                            (cilium_tpu/l7/http.py, with _dfa_scan,
//                            _dfa_scan_strided and _mxu_lookup)
//   kafka_match_kernel  K17a replaces evaluate_kafka_batch
//                            (cilium_tpu/l7/kafka.py)
//   fleet_l7_kernel     K17b replaces evaluate_fleet_l7
//                            (cilium_tpu/l7/fleet.py)
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
  return 3;
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
