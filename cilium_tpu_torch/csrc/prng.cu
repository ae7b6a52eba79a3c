// PICK_DRAW: the churn loop's uniform picks, one CUDA kernel for Hopper
// (sm_90a).
//
// It replaces the draw inside the JAX package's jitted churn program
// `step_pool_rand` (cilium_tpu/replay.py:222-237):
// `jax.random.randint(key, (B,), 0, P, uint32)` under threefry2x32 with
// `jax_threefry_partitionable` on.  The host (prng.py) derives the batch
// key, PRNGKey(len(ct) ^ n) folded with the batch index, and splits it
// into the two subkeys k1 and k2; per pick i the kernel computes
//   hi = bits(k1, i), lo = bits(k2, i),
//   bits(k, i) = y0 ^ y1 where (y0, y1) = threefry2x32(k, (i >> 32, i)),
//   pick = ((hi % P) * m + lo % P) % P, every step in u32 (wrapping),
// with m = (2^16 % P)^2 % P, also taken in u32 by the host.
//
// Shape: one thread per pick, 40 rounds of add, rotate and xor in
// registers; the only memory traffic is the 4-byte pick written.
#include <cuda_runtime.h>

#include <cstdint>

namespace cpr {

constexpr int BLOCK = 256;

// The field order is the ctypes Structure's order in kernels.py
// (PickArgs); prng_args_size() lets the wrapper check that they agree.
struct PickArgs {
  uint32_t* picks;  // [n] out
  uint32_t k1[2];   // split(key)[0]: the high draw's key
  uint32_t k2[2];   // split(key)[1]: the low draw's key
  uint32_t span;    // P >= 1
  uint32_t mult;    // (2^16 % P)^2 % P in u32
  int64_t n;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 (20 rounds) of the counter (x0, x1); returns y0 ^ y1.
__device__ __forceinline__ uint32_t threefry_bits(const uint32_t k[2],
                                                  uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k[0], k[1], k[0] ^ k[1] ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return x0 ^ x1;
}

__global__ void __launch_bounds__(BLOCK) pick_draw_kernel(const PickArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= a.n) return;
  const uint32_t chi = static_cast<uint32_t>(static_cast<uint64_t>(i) >> 32);
  const uint32_t clo = static_cast<uint32_t>(i);
  const uint32_t hi = threefry_bits(a.k1, chi, clo);
  const uint32_t lo = threefry_bits(a.k2, chi, clo);
  a.picks[i] = ((hi % a.span) * a.mult + lo % a.span) % a.span;
}

}  // namespace cpr

extern "C" int prng_args_size() {
  return static_cast<int>(sizeof(cpr::PickArgs));
}

// Launch one draw on `stream`; returns cudaGetLastError().
extern "C" int launch_pick_draw(const cpr::PickArgs* args, void* stream) {
  if (args->n > 0) {
    const int64_t grid = (args->n + cpr::BLOCK - 1) / cpr::BLOCK;
    cpr::pick_draw_kernel<<<static_cast<unsigned>(grid), cpr::BLOCK, 0,
                            static_cast<cudaStream_t>(stream)>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}
