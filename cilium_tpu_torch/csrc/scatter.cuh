// The tile routine of the row scatters: PUBLISH_SCATTER and REPAIR_SCATTER
// (csrc/publish.cu) and CT_DELTA (csrc/churn.cu) run it, one block a
// tile.  A segment views a leaf as [outer, n_axis, inner] and its payload
// as [outer, k, inner]: values[o, r, i] goes to leaf[o, idx[r], i], with
// jax's scatter rules (an index below 0 gets its axis size added once; a
// row with any index still outside [0, size) is dropped).  The host
// (kernels.scatter_args) lays out the tiles; csrc/publish.cu's note says
// how a tile is copied and why.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cpub {

constexpr int MAX_SEGMENTS = 16;
constexpr int BLOCK = 256;
constexpr int MAX_TILE_ROWS = 2048;  // index rows a tile stages
constexpr int UNROLL = 4;

// Every field is 8 bytes: the host fills the struct as an int64 array.
struct Segment {
  uint32_t* dst;
  const void* idx0;  // int64 (the stores) or int32 (CT_DELTA) indices
  const void* idx1;  // null for one indexed axis
  const uint32_t* values;
  int64_t size0;  // the indexed axes' sizes: cells = size0 * size1
  int64_t size1;
  int64_t outer;  // rows before the indexed axis (1 for a publish)
  int64_t inner;  // words of one cell
  int64_t k;      // payload rows
  // the tiling, laid out by the host
  int64_t cols;      // words of a tile's chunk of a row
  int64_t log_rows;  // a tile's index rows: 1 << log_rows at most
  int64_t outers;    // a tile's outer rows at most
  int64_t col_tiles;
  int64_t row_tiles;
  int64_t tile_start;  // this segment's first block
};

// The launch's segments and its blocks; a launch of one segment (CT_DELTA)
// passes ArgsOf<1>, 136 bytes of kernel parameters where Args are 1,936.
template <int NSEG>
struct ArgsOf {
  Segment seg[NSEG];
  int64_t n_seg;
  int64_t tiles;  // blocks of the launch
};
using Args = ArgsOf<MAX_SEGMENTS>;

// n / d for n < 2^31 with a multiply (d's magic number, made once per
// block).
struct FastDiv {
  uint32_t m, s;
  __device__ explicit FastDiv(uint32_t d) {
    s = d > 1 ? 32 - __clz(d - 1) : 0;
    m = static_cast<uint32_t>(((1ull << 32) * ((1ull << s) - d)) / d + 1);
  }
  __device__ uint32_t operator()(uint32_t n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) {
  return x < y ? x : y;
}

__device__ __forceinline__ int pow2_floor(int x) {
  return 1 << (31 - __clz(x));
}

__device__ __forceinline__ int pow2_ceil(int x) {
  return x <= 1 ? 1 : 1 << (32 - __clz(x - 1));
}

// n elements of T from s to d, element e by lane e % lanes, UNROLL loads
// in flight before the stores.
template <typename T>
__device__ __forceinline__ void copy_lanes(const T* __restrict__ s,
                                           T* __restrict__ d, int n,
                                           int lane, int lanes) {
  for (int e = lane; e < n; e += UNROLL * lanes) {
    T x[UNROLL];
#pragma unroll
    for (int q = 0; q < UNROLL; ++q)
      if (e + q * lanes < n) x[q] = __ldg(s + e + q * lanes);
#pragma unroll
    for (int q = 0; q < UNROLL; ++q)
      if (e + q * lanes < n) d[e + q * lanes] = x[q];
  }
}

// One run of `len` words: 16-byte vectors where both sides share their
// alignment, scalar words at the edges and where they do not.
__device__ __forceinline__ void copy_run(const uint32_t* src, uint32_t* dst,
                                         int len, int lane, int lanes) {
  const int ms = static_cast<int>(reinterpret_cast<uintptr_t>(src) >> 2) & 3;
  const int md = static_cast<int>(reinterpret_cast<uintptr_t>(dst) >> 2) & 3;
  if (ms != md) {
    copy_lanes(src, dst, len, lane, lanes);
    return;
  }
  const int head = min((4 - md) & 3, len);
  const int nv = (len - head) >> 2;
  const int done = head + 4 * nv;
  copy_lanes(src, dst, head, lane, lanes);
  copy_lanes(reinterpret_cast<const uint4*>(src + head),
             reinterpret_cast<uint4*>(dst + head), nv, lane, lanes);
  copy_lanes(src + done, dst + done, len - done, lane, lanes);
}

// One block: one tile of one segment, its indices of type IX.
template <typename IX, typename A>
__device__ __forceinline__ void scatter_tile(const A& a) {
  __shared__ int32_t cell[MAX_TILE_ROWS];
  const int64_t b = blockIdx.x;
  int s = 0;
  while (s + 1 < a.n_seg && b >= a.seg[s + 1].tile_start) ++s;
  const Segment& g = a.seg[s];
  uint32_t t = static_cast<uint32_t>(b - g.tile_start);
  const uint32_t col_tiles = static_cast<uint32_t>(g.col_tiles);
  const uint32_t row_tiles = static_cast<uint32_t>(g.row_tiles);
  const uint32_t ct = t % col_tiles;
  t /= col_tiles;
  const uint32_t rt = t % row_tiles;
  const uint32_t ot = t / row_tiles;

  const int64_t r0 = static_cast<int64_t>(rt) << g.log_rows;
  const int nrows =
      static_cast<int>(min64(int64_t{1} << g.log_rows, g.k - r0));
  const int64_t c0 = static_cast<int64_t>(ct) * g.cols;
  const int ncols = static_cast<int>(min64(g.cols, g.inner - c0));
  const int64_t o0 = static_cast<int64_t>(ot) * g.outers;
  const int nouter = static_cast<int>(min64(g.outers, g.outer - o0));
  const int64_t cells = g.size0 * g.size1;

  // the tile's index rows, once, with jax's rules (-1: dropped)
  for (int j = threadIdx.x; j < nrows; j += BLOCK) {
    int64_t i0 = static_cast<const IX*>(g.idx0)[r0 + j];
    if (i0 < 0) i0 += g.size0;
    bool ok = i0 >= 0 && i0 < g.size0;
    if (g.idx1 != nullptr) {
      int64_t i1 = static_cast<const IX*>(g.idx1)[r0 + j];
      if (i1 < 0) i1 += g.size1;
      ok = ok && i1 >= 0 && i1 < g.size1;
      i0 = i0 * g.size1 + i1;
    }
    cell[j] = ok ? static_cast<int32_t>(i0) : -1;
  }
  __syncthreads();
  bool consecutive = true;
  for (int j = threadIdx.x; j < nrows; j += BLOCK)
    consecutive = consecutive && cell[j] >= 0 &&
                  (j == 0 || cell[j] == cell[j - 1] + 1);
  const bool run = __syncthreads_and(consecutive);

  // runs: one per outer row (consecutive cells), or one per (outer row,
  // index row); a whole tile is one run where it covers whole rows of
  // both the payload and the leaf
  const int64_t src_row = g.k * g.inner;   // payload words per outer row
  const int64_t dst_row = cells * g.inner;  // leaf words per outer row
  const uint32_t* src0 = g.values + ((o0 * g.k + r0) * g.inner + c0);
  uint32_t* dst0 = g.dst + (o0 * dst_row + c0);
  int len, runs;
  if (run) {
    len = nrows * ncols;
    runs = nouter;
    if (nouter > 1 && len == src_row && len == dst_row) {
      len *= nouter;
      runs = 1;
    }
  } else {
    len = ncols;
    runs = nouter * nrows;
  }
  const int lanes = min(pow2_ceil((len + 3) >> 2),
                        pow2_floor(max(1, BLOCK / min(runs, BLOCK))));
  const int per_pass = BLOCK / lanes;
  const int lane = threadIdx.x & (lanes - 1);
  if (run) {
    const int64_t at = static_cast<int64_t>(cell[0]) * g.inner;
    for (int n = threadIdx.x / lanes; n < runs; n += per_pass)
      copy_run(src0 + n * src_row, dst0 + (n * dst_row + at), len, lane,
               lanes);
    return;
  }
  const FastDiv by_rows(static_cast<uint32_t>(nrows));
#pragma unroll 4
  for (int n = threadIdx.x / lanes; n < runs; n += per_pass) {
    const int o = static_cast<int>(by_rows(static_cast<uint32_t>(n)));
    const int j = n - o * nrows;
    const int32_t c = cell[j];
    if (c < 0) continue;
    copy_run(src0 + (o * src_row + static_cast<int64_t>(j) * g.inner),
             dst0 + (o * dst_row + static_cast<int64_t>(c) * g.inner), len,
             lane, lanes);
  }
}

}  // namespace cpub
