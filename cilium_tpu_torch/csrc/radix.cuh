// The stable LSD radix sort of the memo on the mesh's probe (mesh.cu
// MESH_MEMO_PROBE), one block of kernels each pass, launched in order on
// one stream (a global order or count needs a grid-wide barrier between
// them), and the block scan that the memo kernels (memo.cu) share.
//
// The radix sort moves (key words, payload) pairs between two buffers,
// 8 bits a pass, least significant word first; a pass whose digit is
// the same for every element is skipped on the device.  Equal keys
// keep their input order (the stable order XLA's CPU sort gives).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace crx {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int RADIX = 256;
constexpr int TILE = 4096;                 // radix elements per block
constexpr int WARP_TILE = TILE / WARPS;    // 512: 16 chunks of 32
constexpr int SCAN_THREADS = 1024;         // the digit scan's block

// The radix sort's buffers: ping-pong key words and a payload (the
// element's position), the per-block digit histograms, the buffer each
// pass reads (parity[p]; parity[p + 1] equals it when pass p is skipped)
// and the element count on the device.
struct SortArgs {
  uint32_t* key[2][3];
  uint32_t* val[2];
  uint32_t* hist;     // [RADIX * n_blocks], digit-major
  uint32_t* digits;   // [2 * RADIX]: each digit's total, then its base
  int32_t* parity;    // [passes + 1]
  const int32_t* n;   // elements (<= cap)
  int32_t cap;
  int32_t n_blocks;   // ceil(cap / TILE)
};

// -- scans -------------------------------------------------------------------

// Inclusive scan of one value per thread over a block of N threads
// (N <= 1024, a multiple of 32): warp shuffles, then the warp sums.
// `total` (when not null) gets the block's sum.
template <int N>
__device__ __forceinline__ uint32_t block_inclusive(uint32_t x,
                                                    uint32_t* total) {
  __shared__ uint32_t s_warp[N / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < N / 32 ? s_warp[lane] : 0u;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < N / 32) s_warp[lane] = w;
  }
  __syncthreads();
  const uint32_t r = x + (warp ? s_warp[warp - 1] : 0u);
  if (total) *total = s_warp[N / 32 - 1];
  __syncthreads();
  return r;
}

// -- the stable LSD radix sort -------------------------------------------------

__global__ void __launch_bounds__(BLOCK)
    radix_hist(SortArgs a, int pass, int word, int shift) {
  __shared__ uint32_t h[RADIX];
  for (int d = threadIdx.x; d < RADIX; d += BLOCK) h[d] = 0;
  __syncthreads();
  const int n = *a.n;
  const uint32_t* kin = a.key[a.parity[pass]][word];
  const int base = blockIdx.x * TILE;
  for (int i = threadIdx.x; i < TILE; i += BLOCK) {
    const int g = base + i;
    if (g < n) atomicAdd(&h[(kin[g] >> shift) & 0xFFu], 1u);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < RADIX; d += BLOCK)
    a.hist[d * a.n_blocks + blockIdx.x] = h[d];
}

// Each digit's per-block counts (one block per digit, the counts
// contiguous): their exclusive scan in place, and the digit's total.
__global__ void __launch_bounds__(SCAN_THREADS) radix_digit_scan(SortArgs a) {
  __shared__ uint32_t s_total;
  uint32_t* h = a.hist + static_cast<size_t>(blockIdx.x) * a.n_blocks;
  uint32_t carry = 0;
  for (int base = 0; base < a.n_blocks; base += SCAN_THREADS) {
    const int i = base + threadIdx.x;
    const uint32_t x = i < a.n_blocks ? h[i] : 0u;
    const uint32_t incl = block_inclusive<SCAN_THREADS>(x, &s_total);
    if (i < a.n_blocks) h[i] = carry + incl - x;
    carry += s_total;
    __syncthreads();
  }
  if (threadIdx.x == 0) a.digits[blockIdx.x] = carry;
}

// The digits' bases (an exclusive scan of their totals, RADIX threads).
// A pass whose digit is one value for every element keeps the buffer
// (parity[pass + 1] = parity[pass]).
__global__ void __launch_bounds__(RADIX) radix_digit_base(SortArgs a,
                                                          int pass) {
  __shared__ int s_skip;
  if (threadIdx.x == 0) s_skip = 0;
  __syncthreads();
  const uint32_t t = a.digits[threadIdx.x];
  const uint32_t incl = block_inclusive<RADIX>(t, nullptr);
  a.digits[RADIX + threadIdx.x] = incl - t;
  if (t == static_cast<uint32_t>(*a.n)) s_skip = 1;
  __syncthreads();
  if (threadIdx.x == 0)
    a.parity[pass + 1] = a.parity[pass] ^ (s_skip ? 0 : 1);
}

// The stable scatter of one pass: each warp walks its 512 elements in
// chunks of 32, ranks a lane among the chunk's lanes of its digit with
// __match_any_sync, and takes its base from the warp's running count of
// that digit (warps ordered within the block, blocks by the scan).
template <int KW>
__global__ void __launch_bounds__(BLOCK)
    radix_scatter(SortArgs a, int pass, int word, int shift) {
  const int cur = a.parity[pass];
  if (a.parity[pass + 1] == cur) return;  // a skipped pass
  __shared__ uint32_t s_cnt[WARPS][RADIX];
  for (int i = threadIdx.x; i < WARPS * RADIX; i += BLOCK)
    (&s_cnt[0][0])[i] = 0;
  __syncthreads();
  const int n = *a.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wbase = blockIdx.x * TILE + warp * WARP_TILE;
  const uint32_t* kin = a.key[cur][word];
  for (int c = 0; c < WARP_TILE / 32; ++c) {
    const int g = wbase + c * 32 + lane;
    const bool ok = g < n;
    const uint32_t d = ok ? (kin[g] >> shift) & 0xFFu : RADIX + lane;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    if (ok && lane == __ffs(peers) - 1) s_cnt[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int d = threadIdx.x; d < RADIX; d += BLOCK) {
    uint32_t run = a.hist[d * a.n_blocks + blockIdx.x] + a.digits[RADIX + d];
    for (int w = 0; w < WARPS; ++w) {
      const uint32_t c = s_cnt[w][d];
      s_cnt[w][d] = run;
      run += c;
    }
  }
  __syncthreads();
  const int nxt = cur ^ 1;
  for (int c = 0; c < WARP_TILE / 32; ++c) {
    const int g = wbase + c * 32 + lane;
    const bool ok = g < n;
    const uint32_t d = ok ? (kin[g] >> shift) & 0xFFu : RADIX + lane;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    if (ok) {
      const uint32_t pos =
          s_cnt[warp][d] + __popc(peers & ((1u << lane) - 1u));
#pragma unroll
      for (int w = 0; w < KW; ++w) a.key[nxt][w][pos] = a.key[cur][w][g];
      a.val[nxt][pos] = a.val[cur][g];
    }
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) s_cnt[warp][d] += __popc(peers);
    __syncwarp();
  }
}

// Passes over `bytes` digits of each of the KW words, least significant
// word (the last) first.
template <int KW>
inline void radix_sort(const SortArgs& a, int bytes, cudaStream_t st) {
  int pass = 0;
  for (int w = KW - 1; w >= 0; --w) {
    for (int b = 0; b < bytes; ++b, ++pass) {
      radix_hist<<<a.n_blocks, BLOCK, 0, st>>>(a, pass, w, 8 * b);
      radix_digit_scan<<<RADIX, SCAN_THREADS, 0, st>>>(a);
      radix_digit_base<<<1, RADIX, 0, st>>>(a, pass);
      radix_scatter<KW><<<a.n_blocks, BLOCK, 0, st>>>(a, pass, w, 8 * b);
    }
  }
}

}  // namespace crx
