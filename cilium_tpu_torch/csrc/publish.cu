// PUBLISH_SCATTER and REPAIR_SCATTER: K18's publish scatter and its
// readmission repair on the card.
//
// PUBLISH_SCATTER replaces cilium_tpu/engine/publish.py
// DeviceTableStore._apply_fn (`apply`, jit site publish.scatter): for
// each leaf of a TableDelta, `leaf.at[idx].set(values)` into the spare
// epoch, which the reference donates.  Here the spare epoch's own
// tensors are written in place.  One or two leading axes are indexed
// (two for port_slot's (proto, dport)); the indices fold into one cell
// index i0 * size1 + i1 over the leaf viewed as [cells, words].
//
// REPAIR_SCATTER replaces cilium_tpu/engine/publish.py
// DeviceTableStore._repair_fn (`apply`, jit site publish.repair, run by
// repair_rows :953), and through it DatapathStore._scatter_fn
// (engine/datapath_mesh.py :846) and the relayout windows: for each leaf
// of a chip's row sets, `leaf.at[(slice(None),) * axis + (idx,)]
// .set(values)` along one interior axis, in place.  A segment views the
// leaf as [outer, n_axis, inner] and the payload as [outer, k, inner]:
// values[o, r, i] goes to leaf[o, idx[r], i].  A publish is the same
// geometry with outer = 1, so both kernels run one tile routine
// (csrc/scatter.cuh; CT_DELTA in csrc/churn.cu runs it too).
//
// jax's scatter rules, not torch's: an index below 0 gets its axis
// size added once, and a row with any index still outside [0, size) is
// dropped (FILL_OR_DROP).  Duplicate indices carry identical rows (the
// stores' pow2 padding repeats the last row), so any write order gives
// the same bits.  Every word is 32 bits: u32 leaves travel as int32
// with the same bits, port_slot's u16 payload is widened to the int32
// the port keeps on the card.  One launch covers up to MAX_SEGMENTS
// leaves.
//
// Bound: bytes.  The index bytes and the payload are read once and the
// destination words written once (chip_smoke.py counts the same:
// idx + 2 x values); nothing is computed.  The shapes that matter are
// few very wide rows (a publish's l4_allow_bits row is 2 x Kg x W
// words, 8.5 MB at config 5) and long runs of a narrow axis (a
// readmission repairs l4_allow_bits and l3_allow_bits along their
// sharded last axis: inner = 1, an owned range of k consecutive words
// per outer row).  The design:
//  * The host lays out a table of tiles per segment: a tile is an
//    outer range x a chunk of at most MAX_TILE_ROWS index rows x a
//    chunk of a row's words, at most `tile words` in all (1,024 to
//    8,192, from the launch's size: about one tile an SM, which beat
//    two to eight on the card).  One block is one tile.  A block finds its segment once (a
//    scan of at most 16 starts) and its tile from blockIdx with two
//    32-bit divisions; nothing is divided per word, and 64-bit
//    arithmetic makes only a run's base address.
//  * The block reads its index rows once, into shared memory, with the
//    index rules applied.  Where they are consecutive cells (an owned
//    range, a row split over tiles) the tile is one contiguous run per
//    outer row, and one run for the whole tile where the tile covers
//    whole rows on both sides; otherwise each row is its own run.
//  * A run is copied with 16-byte loads and stores where its source and
//    destination share their alignment (scalar words before the first
//    aligned vector and after the last), with 32-bit words where they
//    do not; lanes per run are picked from the runs' length and count,
//    and each lane keeps UNROLL loads in flight before it stores.

#include "scatter.cuh"

namespace cpub {

__global__ void __launch_bounds__(BLOCK)
    publish_scatter_kernel(const __grid_constant__ Args a) {
  scatter_tile<int64_t>(a);
}

__global__ void __launch_bounds__(BLOCK)
    repair_scatter_kernel(const __grid_constant__ Args a) {
  scatter_tile<int64_t>(a);
}

}  // namespace cpub

// The layout and limits the host must agree with: sizeof(Segment),
// sizeof(Args), MAX_SEGMENTS, MAX_TILE_ROWS.
extern "C" int publish_struct_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(cpub::Segment));
  out[1] = static_cast<int>(sizeof(cpub::Args));
  out[2] = cpub::MAX_SEGMENTS;
  out[3] = cpub::MAX_TILE_ROWS;
  return 0;
}

// One repair scatter of every segment on `stream`, one block a tile;
// returns cudaGetLastError().
extern "C" int launch_repair_scatter(const cpub::Args* args, void* stream) {
  if (args->tiles > 0)
    cpub::repair_scatter_kernel<<<static_cast<unsigned>(args->tiles),
                                  cpub::BLOCK, 0,
                                  static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// One publish scatter of every segment on `stream`; returns
// cudaGetLastError().
extern "C" int launch_publish_scatter(const cpub::Args* args, void* stream) {
  if (args->tiles > 0)
    cpub::publish_scatter_kernel<<<static_cast<unsigned>(args->tiles),
                                   cpub::BLOCK, 0,
                                   static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
