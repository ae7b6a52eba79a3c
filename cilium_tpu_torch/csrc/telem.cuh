// The [2, 20] telemetry rows (engine/verdict.py telemetry_masks: ingress
// row 0, egress row 1, one column a mask) and the replica count of the
// mesh combines: MESH_COMBINE and MESH_MEMO_COMBINE's back pass
// (mesh.cu), DP_MESH_COMBINE (datapath_mesh.cu).
//
// A warp counts its tuples' masks with one ballot a column: lane c keeps
// column c's ingress and egress counts (telem_warp_add, once per tuple a
// lane; a grid-stride kernel calls it once a round and keeps the counts
// in registers).  The block then sums the lanes' counts and the tuples'
// replica counts in shared memory and adds each nonzero sum into the
// buffers with one atomicAdd a block, row and column (telem_commit).
// Integer adds commute: the rows end as the plain versions' sums.
#pragma once

#include <cstdint>

namespace ctl {

constexpr int TELEM_COLS = 20;

// Every lane of the warp, once a round: `tbits` the tuple's masks (bit c
// column c; 0 for an inactive lane), `ingress` its row.  Adds the warp's
// counts of column c into lane c's n_in and n_out.
__device__ __forceinline__ void telem_warp_add(uint32_t tbits, bool ingress,
                                               uint32_t& n_in,
                                               uint32_t& n_out) {
  const int lane = threadIdx.x & 31;
  const uint32_t in = __ballot_sync(0xFFFFFFFFu, ingress);
#pragma unroll
  for (int c = 0; c < TELEM_COLS; ++c) {
    const uint32_t b = __ballot_sync(0xFFFFFFFFu, (tbits >> c) & 1u);
    if (lane == c) {
      n_in += static_cast<uint32_t>(__popc(b & in));
      n_out += static_cast<uint32_t>(__popc(b & ~in));
    }
  }
}

// Every thread of the block, once, after its last telem_warp_add: the
// block's sums into telem [2, 20] (null: no telemetry) and `served` (each
// thread's replica count) into replica [1].
__device__ __forceinline__ void telem_commit(uint32_t* telem,
                                             uint32_t* replica,
                                             uint32_t n_in, uint32_t n_out,
                                             uint32_t served) {
  __shared__ uint32_t s_rows[2 * TELEM_COLS + 1];  // + the replica count
  if (threadIdx.x <= 2 * TELEM_COLS) s_rows[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const uint32_t warp_served = __reduce_add_sync(0xFFFFFFFFu, served);
  if (lane == 0 && warp_served) atomicAdd(&s_rows[2 * TELEM_COLS], warp_served);
  if (telem != nullptr && lane < TELEM_COLS) {
    if (n_in) atomicAdd(&s_rows[lane], n_in);
    if (n_out) atomicAdd(&s_rows[TELEM_COLS + lane], n_out);
  }
  __syncthreads();
  if (threadIdx.x < 2 * TELEM_COLS && telem != nullptr && s_rows[threadIdx.x])
    atomicAdd(telem + threadIdx.x, s_rows[threadIdx.x]);
  if (threadIdx.x == 2 * TELEM_COLS && s_rows[threadIdx.x])
    atomicAdd(replica, s_rows[threadIdx.x]);
}

// Both, for a kernel of one tuple a thread.
__device__ __forceinline__ void telem_block_sum(uint32_t* telem,
                                                uint32_t* replica,
                                                uint32_t tbits, bool ingress,
                                                uint32_t served) {
  uint32_t n_in = 0, n_out = 0;
  if (telem != nullptr) telem_warp_add(tbits, ingress, n_in, n_out);
  telem_commit(telem, replica, n_in, n_out, served);
}

}  // namespace ctl
