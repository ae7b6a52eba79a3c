// SHADOW_DIFF: K19, the shadow plane's per-row verdict diff, on the card.
//
// Replaces cilium_tpu/shadow.py diff_codes (jitted as ShadowPlane
// _device_diff, site shadow.diff): from a live and a shadow verdict set
// (allowed u8, proxy_port i32, match_kind u8, [B] each) it writes four
// u8 [B] columns: ca, cp, ck (the columns changed) and the transition
// code.  Each value is widened to int32 and compared as int32, as the
// reference's astype(int32) compares are, so allowed values other than
// 0 and 1, negative and out-of-range proxy ports and any kind give the
// reference's codes: a2d = ca & (live_allowed != 0), d2a = ca &
// (live_allowed == 0), and trans = a2d ? ALLOW_TO_DENY : d2a ?
// DENY_TO_ALLOW : (cp | ck) ? CHANGED : NONE.
//
// Bound: bytes.  A row reads 2 x (1 + 4 + 1) B and writes 4 B, 16 B in
// all and nothing reused: 67,108,864 B at 4,194,304 rows, 0.0200 ms at
// 3.35 TB/s.  One thread takes four rows: where every column's base is
// aligned (the wrapper says so) it reads each u8 column as one 32-bit
// word and each proxy column as one 16-byte int4, and writes each
// output as one 32-bit word; the ragged tail, and unaligned columns,
// go row by row.

#include <cstdint>
#include <cuda_runtime.h>

namespace cshd {

constexpr int BLOCK = 256;
constexpr uint8_t TRANS_NONE = 0;
constexpr uint8_t TRANS_ALLOW_TO_DENY = 1;
constexpr uint8_t TRANS_DENY_TO_ALLOW = 2;
constexpr uint8_t TRANS_CHANGED = 3;

struct DiffArgs {
  const uint8_t* live_allowed;
  const int32_t* live_proxy;
  const uint8_t* live_kind;
  const uint8_t* shadow_allowed;
  const int32_t* shadow_proxy;
  const uint8_t* shadow_kind;
  uint8_t* ca;
  uint8_t* cp;
  uint8_t* ck;
  uint8_t* trans;
  int64_t n;
  int32_t vector;  // every base aligned for the four-row loads
  int32_t pad;
};

struct Row {
  uint8_t ca, cp, ck, trans;
};

__device__ __forceinline__ Row diff_row(uint32_t la, int32_t lp, uint32_t lk,
                                        uint32_t sa, int32_t sp,
                                        uint32_t sk) {
  Row r;
  const bool ca = static_cast<int32_t>(la) != static_cast<int32_t>(sa);
  const bool cp = lp != sp;
  const bool ck = static_cast<int32_t>(lk) != static_cast<int32_t>(sk);
  const bool a2d = ca && la != 0;
  const bool d2a = ca && la == 0;
  r.ca = ca;
  r.cp = cp;
  r.ck = ck;
  r.trans = a2d ? TRANS_ALLOW_TO_DENY
                : (d2a ? TRANS_DENY_TO_ALLOW
                       : ((cp || ck) ? TRANS_CHANGED : TRANS_NONE));
  return r;
}

__device__ __forceinline__ uint32_t byte_of(uint32_t word, int k) {
  return (word >> (8 * k)) & 0xFFu;
}

__global__ void __launch_bounds__(BLOCK)
    shadow_diff_kernel(const __grid_constant__ DiffArgs a) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  const int64_t row0 = g * 4;
  if (row0 >= a.n) return;
  if (a.vector && row0 + 4 <= a.n) {
    const uint32_t la = __ldg(reinterpret_cast<const uint32_t*>(a.live_allowed) + g);
    const uint32_t lk = __ldg(reinterpret_cast<const uint32_t*>(a.live_kind) + g);
    const uint32_t sa = __ldg(reinterpret_cast<const uint32_t*>(a.shadow_allowed) + g);
    const uint32_t sk = __ldg(reinterpret_cast<const uint32_t*>(a.shadow_kind) + g);
    const int4 lp = __ldg(reinterpret_cast<const int4*>(a.live_proxy) + g);
    const int4 sp = __ldg(reinterpret_cast<const int4*>(a.shadow_proxy) + g);
    const int32_t lpv[4] = {lp.x, lp.y, lp.z, lp.w};
    const int32_t spv[4] = {sp.x, sp.y, sp.z, sp.w};
    uint32_t ca = 0, cp = 0, ck = 0, tr = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const Row r = diff_row(byte_of(la, k), lpv[k], byte_of(lk, k),
                             byte_of(sa, k), spv[k], byte_of(sk, k));
      ca |= static_cast<uint32_t>(r.ca) << (8 * k);
      cp |= static_cast<uint32_t>(r.cp) << (8 * k);
      ck |= static_cast<uint32_t>(r.ck) << (8 * k);
      tr |= static_cast<uint32_t>(r.trans) << (8 * k);
    }
    reinterpret_cast<uint32_t*>(a.ca)[g] = ca;
    reinterpret_cast<uint32_t*>(a.cp)[g] = cp;
    reinterpret_cast<uint32_t*>(a.ck)[g] = ck;
    reinterpret_cast<uint32_t*>(a.trans)[g] = tr;
    return;
  }
  const int64_t end = row0 + 4 < a.n ? row0 + 4 : a.n;
  for (int64_t i = row0; i < end; ++i) {
    const Row r = diff_row(a.live_allowed[i], a.live_proxy[i], a.live_kind[i],
                           a.shadow_allowed[i], a.shadow_proxy[i],
                           a.shadow_kind[i]);
    a.ca[i] = r.ca;
    a.cp[i] = r.cp;
    a.ck[i] = r.ck;
    a.trans[i] = r.trans;
  }
}

}  // namespace cshd

extern "C" int shadow_struct_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(cshd::DiffArgs));
  return 0;
}

// One diff of n rows on `stream`; returns cudaGetLastError().
extern "C" int launch_shadow_diff(const cshd::DiffArgs* args, void* stream) {
  if (args->n > 0) {
    const int64_t groups = (args->n + 3) / 4;
    const int64_t blocks = (groups + cshd::BLOCK - 1) / cshd::BLOCK;
    cshd::shadow_diff_kernel<<<static_cast<unsigned>(blocks), cshd::BLOCK, 0,
                               static_cast<cudaStream_t>(stream)>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}
