// The conntrack churn loop's two device programs besides the datapath
// step, CUDA kernels for Hopper (sm_90a).
//
// CHURN_COMPACT replaces the JAX package's intent compaction
// `_churn_compact` (cilium_tpu/replay.py:65), which the churn programs
// `_churn_fns` (:192) fuse behind the datapath step.  Over one batch of
// B step outputs (the flows are pool[:, picks[i]], read again here) it
// computes:
//   flag        (ct_create | ct_delete) & row < valid
//   h           FNV-1a of (final_daddr, saddr, final_dport << 16 | sport,
//               proto << 8 | direction)
//   claim       a [slots] table: slot h & (slots - 1) keeps the smallest
//               flagged row id that hashes to it
//   winner      flag & claim[slot] == row
//   true loser  flag & !winner & h[claim[slot]] != h (a distinct flow that
//               lost its slot; it needs a rerun)
//   intents     the first `cap` winners in row order, as 12 u32 columns of
//               [12, cap], the rest zero
//   header      [n_tx, allowed, redirected, remaining]: n_tx = min(winners,
//               cap, B), allowed and redirected summed over rows < valid,
//               remaining = true losers + winners past the cap; every sum
//               wraps at 2^32.
// atomicMin makes the claim deterministic (the smallest row id wins
// whatever the order of the atomics), so the output is bit-exact with the
// reference's stable argsort of where(winner, row, B).  The dependencies
// need four launches: (1) fill the claim table with B; (2) hash the
// flagged rows into scratch and atomicMin their ids into the table (only
// after every slot is filled); (3) per block of 4,096 rows, mark the
// winners and count winners, true losers, allowed and redirected (only
// after every claim has landed; a true loser reads its winner's full
// 32-bit hash from scratch); (4) per block, an exclusive scan of the
// earlier blocks' winner counts, then a scatter of the block's winners in
// row order (warp ballots and a shared-memory scan per 256-row chunk),
// the zeroing of the intent columns past n_tx, and the header.
//
// What bounds it: bytes.  Every row's two flags, allowed byte and proxy
// port are read (7 B a row, 14.7 MB at B = 2,097,152); a flagged row adds
// its final address and port and its pool words; a winner adds rev_nat,
// slave and the pre-DNAT address and port; the [12, cap] intents (3.1 MB
// at cap 65,536) are written once.  The claim table (2 MB at 2^19 slots),
// the hash scratch and the winner bytes are scratch traffic the bound does
// not count.  This first version is simple: coalesced per-row passes, one
// atomic per flagged row, and a scan whose cost is a read of the per-block
// counts (512 blocks at B = 2,097,152) by every block.
//
// CT_DELTA replaces the CT part of the JAX package's row scatter
// `apply_bucket_delta` (cilium_tpu/ct/device.py:536), jitted with the
// snapshot donated (cilium_tpu/replay.py `_delta_fn`): changed bucket rows
// [M, lanes] written into the resident snapshot [Cb, lanes] at idx [M], in
// place, with jax's scatter rules: an index below 0 gets Cb added once,
// and one still outside [0, Cb) drops its row.  Duplicate indices (the
// pow2 padding repeats the first changed bucket) carry identical rows, so
// the racing writes are idempotent.  It is PUBLISH_SCATTER's geometry
// with one segment (outer = 1, the bucket axis indexed by int32 indices,
// a row's lanes as inner), so it runs that scatter's tile routine
// (csrc/scatter.cuh) on a tiling the host lays out: each block stages
// its index rows once, copies runs of consecutive buckets as one
// stretch, and moves 16-byte vectors.  Bound: the index read once and
// the rows read once and written once (the churn loop's 16,384-row delta
// of 512-byte rows: 16.8 MB, 0.005 ms at 3.35 TB/s); the launch is most
// of what it costs.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "scatter.cuh"

namespace cch {

constexpr int BLOCK = 256;
constexpr int CHUNKS = 16;
constexpr int ROWS = BLOCK * CHUNKS;  // rows per block of passes (3), (4)
constexpr int N_INTENT = 12;

// Mirror of the ctypes Structure ChurnArgs in kernels.py, field for field.
struct ChurnArgs {
  // the step's outputs [B]
  const uint8_t* ct_create;
  const uint8_t* ct_delete;
  const uint8_t* allowed;
  const int32_t* proxy_port;
  const uint32_t* final_daddr;
  const int32_t* final_dport;
  const int32_t* rev_nat;
  const int32_t* lb_slave;
  // the flows: pool [8, pool_n] (FLOW_COLUMNS order), picks [B]
  const uint32_t* pool;
  const uint32_t* picks;
  // scratch: claim [slots], hash [B], winner [B], counts [blocks, 4]
  int32_t* claim;
  uint32_t* hash;
  uint8_t* winner;
  uint32_t* counts;
  // outputs: header [4], intents [12, cap]
  uint32_t* header;
  uint32_t* intents;
  int32_t B;
  int32_t valid;
  int32_t cap;
  int32_t slots;
  int32_t pool_n;
};

// FLOW_COLUMNS rows of the pool
constexpr int C_SADDR = 1, C_DADDR = 2, C_SPORT = 3, C_DPORT = 4,
              C_PROTO = 5, C_DIR = 6;

__device__ __forceinline__ const uint32_t* pool_row(const ChurnArgs& a,
                                                    int i) {
  // clamped as the step's gather: an XLA gather's int32 index
  const int32_t p = static_cast<int32_t>(__ldg(a.picks + i));
  return a.pool + (p < 0 ? 0 : p < a.pool_n ? p : a.pool_n - 1);
}

__device__ __forceinline__ uint32_t pool_word(const ChurnArgs& a,
                                              const uint32_t* col0, int c) {
  return __ldg(col0 + static_cast<size_t>(c) * a.pool_n);
}

__device__ __forceinline__ bool flagged(const ChurnArgs& a, int i) {
  return i < a.valid && (a.ct_create[i] | a.ct_delete[i]);
}

// block-wide sum of one value per thread; every thread gets the total
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* s_tmp) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // s_tmp may still be read from the previous call
  if (lane == 0) s_tmp[warp] = v;
  __syncthreads();
  uint32_t t = 0;
#pragma unroll
  for (int w = 0; w < BLOCK / 32; ++w) t += s_tmp[w];
  return t;
}

__global__ void __launch_bounds__(BLOCK) claim_fill_kernel(const ChurnArgs a) {
  const int s = blockIdx.x * BLOCK + threadIdx.x;
  if (s < a.slots) a.claim[s] = a.B;
}

__global__ void __launch_bounds__(BLOCK) claim_min_kernel(const ChurnArgs a) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= a.B || !flagged(a, i)) return;
  const uint32_t* col0 = pool_row(a, i);
  const uint32_t saddr = pool_word(a, col0, C_SADDR);
  const uint32_t sport = pool_word(a, col0, C_SPORT);
  const uint32_t proto = pool_word(a, col0, C_PROTO);
  const uint32_t dir = pool_word(a, col0, C_DIR);
  const uint32_t dport = static_cast<uint32_t>(a.final_dport[i]);
  const uint32_t h = cdp::fnv1a4(a.final_daddr[i], saddr,
                                 (dport << 16) | (sport & 0xFFFFu),
                                 (proto << 8) | dir);
  a.hash[i] = h;
  atomicMin(a.claim + (h & static_cast<uint32_t>(a.slots - 1)), i);
}

__global__ void __launch_bounds__(BLOCK) mark_kernel(const ChurnArgs a) {
  __shared__ uint32_t s_tmp[BLOCK / 32];
  const int base = blockIdx.x * ROWS;
  uint32_t win = 0, loser = 0, allow = 0, redir = 0;
  for (int c = 0; c < CHUNKS; ++c) {
    const int i = base + c * BLOCK + threadIdx.x;
    if (i >= a.B) break;
    bool w = false;
    if (flagged(a, i)) {
      const uint32_t h = a.hash[i];
      const int wr = a.claim[h & static_cast<uint32_t>(a.slots - 1)];
      w = wr == i;
      // wr <= i is a flagged row, so its hash is in scratch
      loser += (!w && a.hash[wr] != h);
    }
    a.winner[i] = w;
    win += w;
    if (i < a.valid) {
      allow += a.allowed[i];
      redir += a.proxy_port[i] > 0;
    }
  }
  win = block_sum(win, s_tmp);
  loser = block_sum(loser, s_tmp);
  allow = block_sum(allow, s_tmp);
  redir = block_sum(redir, s_tmp);
  if (threadIdx.x == 0) {
    uint32_t* c = a.counts + 4 * static_cast<size_t>(blockIdx.x);
    c[0] = win;
    c[1] = loser;
    c[2] = allow;
    c[3] = redir;
  }
}

__global__ void __launch_bounds__(BLOCK) scatter_kernel(const ChurnArgs a) {
  __shared__ uint32_t s_tmp[BLOCK / 32];
  __shared__ uint32_t s_warp[BLOCK / 32];
  // the earlier blocks' winners (this block's first position) and the
  // batch totals
  uint32_t pre = 0, tw = 0, tl = 0, ta = 0, tr = 0;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += BLOCK) {
    const uint32_t* c = a.counts + 4 * static_cast<size_t>(b);
    tw += c[0];
    if (b < static_cast<int>(blockIdx.x)) pre += c[0];
    tl += c[1];
    ta += c[2];
    tr += c[3];
  }
  pre = block_sum(pre, s_tmp);
  tw = block_sum(tw, s_tmp);
  tl = block_sum(tl, s_tmp);
  ta = block_sum(ta, s_tmp);
  tr = block_sum(tr, s_tmp);
  const uint32_t take = static_cast<uint32_t>(min(a.cap, a.B));
  const uint32_t n_tx = min(tw, take);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.header[0] = n_tx;
    a.header[1] = ta;
    a.header[2] = tr;
    a.header[3] = tl + (tw - n_tx);
  }

  // the block's winners in row order, chunk by chunk
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t lt = (1u << lane) - 1u;
  const int base = blockIdx.x * ROWS;
  uint32_t running = pre;
  for (int c = 0; c < CHUNKS && running < take; ++c) {
    const int i = base + c * BLOCK + threadIdx.x;
    const bool w = i < a.B && a.winner[i];
    const uint32_t ballot = __ballot_sync(0xFFFFFFFFu, w);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    uint32_t off = 0, total = 0;
#pragma unroll
    for (int k = 0; k < BLOCK / 32; ++k) {
      off += k < warp ? s_warp[k] : 0u;
      total += s_warp[k];
    }
    const uint32_t pos = running + off + __popc(ballot & lt);
    if (w && pos < take) {
      const uint32_t* col0 = pool_row(a, i);
      const uint32_t v[N_INTENT] = {
          a.ct_create[i],
          a.ct_delete[i],
          a.final_daddr[i],
          static_cast<uint32_t>(a.final_dport[i]),
          pool_word(a, col0, C_SADDR),
          pool_word(a, col0, C_SPORT),
          pool_word(a, col0, C_PROTO),
          pool_word(a, col0, C_DIR),
          static_cast<uint32_t>(a.rev_nat[i]),
          static_cast<uint32_t>(a.lb_slave[i]),
          pool_word(a, col0, C_DADDR),
          pool_word(a, col0, C_DPORT),
      };
#pragma unroll
      for (int r = 0; r < N_INTENT; ++r)
        a.intents[static_cast<size_t>(r) * a.cap + pos] = v[r];
    }
    running += total;
    __syncthreads();  // s_warp is rewritten by the next chunk
  }

  // zero the intent columns [n_tx, cap), spread over the grid
  const uint32_t tail = static_cast<uint32_t>(a.cap) - n_tx;
  const size_t n_zero = static_cast<size_t>(N_INTENT) * tail;
  for (size_t k = static_cast<size_t>(blockIdx.x) * BLOCK + threadIdx.x;
       k < n_zero; k += static_cast<size_t>(gridDim.x) * BLOCK) {
    const size_t r = k / tail;
    a.intents[r * a.cap + n_tx + k % tail] = 0u;
  }
}

// CT_DELTA: one block a tile of the one segment (csrc/scatter.cuh).
__global__ void __launch_bounds__(cpub::BLOCK)
    ct_delta_kernel(const __grid_constant__ cpub::ArgsOf<1> a) {
  cpub::scatter_tile<int32_t>(a);
}

}  // namespace cch

extern "C" int churn_struct_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(cch::ChurnArgs));
  out[1] = static_cast<int>(sizeof(cpub::ArgsOf<1>));
  return 0;
}

// blocks of the mark and scatter passes for B rows (the wrapper sizes the
// counts scratch with it)
extern "C" int churn_blocks(int b) {
  return b > 0 ? (b + cch::ROWS - 1) / cch::ROWS : 1;
}

// The four launches of one compaction on `stream`; returns the first
// launch error (cudaGetLastError() after each launch), 0 when all
// launched.
extern "C" int launch_churn_compact(const cch::ChurnArgs* args, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cch::ChurnArgs& a = *args;
  int err;
  cch::claim_fill_kernel<<<(a.slots + cch::BLOCK - 1) / cch::BLOCK,
                           cch::BLOCK, 0, s>>>(a);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  if (a.B > 0) {
    cch::claim_min_kernel<<<(a.B + cch::BLOCK - 1) / cch::BLOCK, cch::BLOCK,
                            0, s>>>(a);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  }
  const int blocks = churn_blocks(a.B);
  cch::mark_kernel<<<blocks, cch::BLOCK, 0, s>>>(a);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  cch::scatter_kernel<<<blocks, cch::BLOCK, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One CT delta on `stream`: the tiles of its one segment
// (kernels.scatter_args); returns cudaGetLastError().
extern "C" int launch_ct_delta(const cpub::ArgsOf<1>* args, void* stream) {
  if (args->tiles > 0)
    cch::ct_delta_kernel<<<static_cast<unsigned>(args->tiles), cpub::BLOCK, 0,
                           static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
