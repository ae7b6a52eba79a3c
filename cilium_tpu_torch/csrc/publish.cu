// PUBLISH_SCATTER and REPAIR_SCATTER: K18's publish scatter and its
// readmission repair on the card.
//
// Replaces cilium_tpu/engine/publish.py DeviceTableStore._apply_fn
// (`apply`, jit site publish.scatter): for each leaf of a TableDelta,
// `leaf.at[idx].set(values)` into the spare epoch, which the reference
// donates.  Here the spare epoch's own tensors are written in place.
//
// One launch covers every scattered leaf of a publish.  The argument
// struct (a __grid_constant__ kernel parameter) holds a segment per
// leaf: the destination, its indexed axes' sizes (one axis, or two for
// port_slot's (proto, dport)), the words of one destination row, the
// int64 index arrays and the payload rows.  A grid-stride loop walks
// the flat (segment, payload row, word) space; each item finds its
// segment by a short linear scan of the segments' start offsets.
//
// jax's scatter rules, not torch's: an index below 0 gets its axis
// size added once, and a row with any index still outside [0, size) is
// dropped (FILL_OR_DROP).  Duplicate indices carry identical rows
// (the store's pow2 padding repeats the last row), so any write order
// gives the same bits.  Every word is 32 bits: u32 leaves travel as
// int32 with the same bits, port_slot's u16 payload is widened to the
// int32 the port keeps on the card.
//
// Bound: bytes.  The index and value bytes are read once and the
// destination rows written once; nothing is computed.  A row of
// l4_allow_bits is 2 x Kg x W words (8.5 MB at config 5), so the loop
// spreads a row's words over the whole grid: neighbouring threads
// write neighbouring words.

// REPAIR_SCATTER replaces cilium_tpu/engine/publish.py
// DeviceTableStore._repair_fn (`apply`, jit site publish.repair, run by
// repair_rows :953): for each leaf of a chip's owned row sets,
// `leaf.at[(slice(None),) * axis + (idx,)].set(values)` along one
// interior axis of the epoch the reference donates; here the epoch's
// own tensors (each device's slices) are written in place.  A segment
// views the leaf as [outer, n_axis, inner] and the payload as
// [outer, k, inner]: values[o, r, i] goes to leaf[o, idx[r], i], with
// the same index rules and the same flat grid-stride walk as the
// publish scatter.  Bound: bytes, as the publish scatter: the index and
// value bytes read once, the destination words written once.

#include <cstdint>
#include <cuda_runtime.h>

namespace cpub {

constexpr int MAX_SEGMENTS = 16;
constexpr int BLOCK = 256;
constexpr int MAX_BLOCKS = 132 * 16;

struct Segment {
  uint32_t* dst;
  const int64_t* idx0;
  const int64_t* idx1;  // null for one indexed axis
  const uint32_t* values;
  int64_t size0;
  int64_t size1;
  int64_t rows;   // payload rows
  int64_t words;  // 32-bit words of one destination row
  int64_t start;  // first flat item of this segment
  int32_t axes;
  int32_t pad;
};

struct ScatterArgs {
  Segment seg[MAX_SEGMENTS];
  int32_t n_seg;
  int32_t pad;
  int64_t total;  // sum of rows * words over the segments
};

__global__ void __launch_bounds__(BLOCK)
    publish_scatter_kernel(const __grid_constant__ ScatterArgs a) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * BLOCK;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
       k < a.total; k += stride) {
    int s = 0;
    while (s + 1 < a.n_seg && k >= a.seg[s + 1].start) ++s;
    const Segment& g = a.seg[s];
    const int64_t off = k - g.start;
    const int64_t r = off / g.words;
    const int64_t w = off - r * g.words;
    int64_t cell = g.idx0[r];
    if (cell < 0) cell += g.size0;
    if (cell < 0 || cell >= g.size0) continue;
    if (g.axes == 2) {
      int64_t i1 = g.idx1[r];
      if (i1 < 0) i1 += g.size1;
      if (i1 < 0 || i1 >= g.size1) continue;
      cell = cell * g.size1 + i1;
    }
    g.dst[cell * g.words + w] = g.values[off];
  }
}

struct RepairSegment {
  uint32_t* dst;
  const int64_t* idx;      // [k]
  const uint32_t* values;  // [outer, k, inner]
  int64_t outer;
  int64_t n_axis;  // the leaf's size along the repaired axis
  int64_t inner;   // words after the axis
  int64_t k;       // payload rows along the axis
  int64_t start;   // first flat item of this segment
};

struct RepairArgs {
  RepairSegment seg[MAX_SEGMENTS];
  int32_t n_seg;
  int32_t pad;
  int64_t total;  // sum of outer * k * inner over the segments
};

__global__ void __launch_bounds__(BLOCK)
    repair_scatter_kernel(const __grid_constant__ RepairArgs a) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * BLOCK;
  for (int64_t f = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
       f < a.total; f += stride) {
    int s = 0;
    while (s + 1 < a.n_seg && f >= a.seg[s + 1].start) ++s;
    const RepairSegment& g = a.seg[s];
    const int64_t off = f - g.start;
    const int64_t i = off % g.inner;
    const int64_t r = (off / g.inner) % g.k;
    const int64_t o = off / (g.inner * g.k);
    int64_t cell = g.idx[r];
    if (cell < 0) cell += g.n_axis;
    if (cell < 0 || cell >= g.n_axis) continue;
    g.dst[(o * g.n_axis + cell) * g.inner + i] = g.values[off];
  }
}

}  // namespace cpub

extern "C" int publish_struct_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(cpub::Segment));
  out[1] = static_cast<int>(sizeof(cpub::ScatterArgs));
  out[2] = static_cast<int>(sizeof(cpub::RepairSegment));
  out[3] = static_cast<int>(sizeof(cpub::RepairArgs));
  return 0;
}

// One repair scatter of every segment on `stream`; returns
// cudaGetLastError().
extern "C" int launch_repair_scatter(const cpub::RepairArgs* args,
                                     void* stream) {
  if (args->total > 0) {
    int64_t blocks = (args->total + cpub::BLOCK - 1) / cpub::BLOCK;
    if (blocks > cpub::MAX_BLOCKS) blocks = cpub::MAX_BLOCKS;
    cpub::repair_scatter_kernel<<<static_cast<int>(blocks), cpub::BLOCK, 0,
                                  static_cast<cudaStream_t>(stream)>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}

// One scatter of every segment on `stream`; returns cudaGetLastError().
extern "C" int launch_publish_scatter(const cpub::ScatterArgs* args,
                                      void* stream) {
  if (args->total > 0) {
    int64_t blocks = (args->total + cpub::BLOCK - 1) / cpub::BLOCK;
    if (blocks > cpub::MAX_BLOCKS) blocks = cpub::MAX_BLOCKS;
    cpub::publish_scatter_kernel<<<static_cast<int>(blocks), cpub::BLOCK, 0,
                                   static_cast<cudaStream_t>(stream)>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}
