"""The policy lattice, plain PyTorch version: bpf/lib/policy.h's
3-probe verdict, over tuple batches and inside the fused datapath.

  probe 1: exact (identity, dport, proto)   [skipped for fragments]
  probe 2: L3-only (identity)               -> plain allow, no proxy
  probe 3: L4 wildcard (any identity, dport, proto)
  miss:    DROP_POLICY (DROP_FRAG_NOSUPPORT for fragments)

The identity resolves to a dense index through the two-region
`id_direct` table, or arrives pre-resolved with its L3 bit from the
idx/l3-plane ipcache (the fused datapath).  With the hashed L4 entry
tables, probes 1 and 3 are each one hashed row read plus a lane
compare (and a stash compare); without them the dense fallback reads
port_slot, l4_allow_bits and l4_meta.  Probe 2 reads l3_allow_bits, or
the pre-resolved bit.  Every lane that matches is summed, as the
reference's masked sums do; a well-formed table has at most one.

Table reads follow an XLA gather: a negative endpoint or direction
counts from the end of its axis, then every index clamps to the
table.  The counter scatter follows an XLA scatter: negative indices
count from the end, and an update still outside the buffer is dropped.

`evaluate_batch` (K23), its counter form and `evaluate_batch_from_ips`
(K20's fused form) run the LATTICE kernel on CUDA tensors and the plain
version here on CPU tensors.  Also here: the per-entry counter columns
and the telemetry masks of the fused datapath.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from cilium_tpu_torch.compiler.tables import (
    L4C_CMP_MASK,
    L4C_WILD_IDX18,
    L4H_WILD_IDX,
    LOCAL_ID_BASE,
    NO_INDEX,
    NO_SLOT,
    l4_entry_words,
)
from cilium_tpu_torch.ct.table import (
    CT_ESTABLISHED,
    CT_NEW,
    CT_RELATED,
    CT_REPLY,
)
from cilium_tpu_torch.device import (
    MASK32,
    require_on,
    resolve_device,
    widen,
)
from cilium_tpu_torch.engine.hashtable import fnv1a
from cilium_tpu_torch.engine.oracle import (
    MATCH_FRAG_DROP,
    MATCH_L3,
    MATCH_L4,
    MATCH_L4_WILD,
    MATCH_NONE,
)

# Columns of the [2, TELEM_COLS] telemetry accumulator (row 0 =
# ingress, row 1 = egress).
TELEM_TOTAL = 0
TELEM_FORWARDED = 1
TELEM_DENIED = 2
TELEM_DROP_PREFILTER = 3
TELEM_DROP_POLICY = 4
TELEM_DROP_FRAG = 5
TELEM_MATCH_L4 = 6
TELEM_MATCH_L3 = 7
TELEM_MATCH_L4_WILD = 8
TELEM_MATCH_NONE = 9
TELEM_MATCH_FRAG = 10
TELEM_LB_DNAT = 11
TELEM_CT_NEW = 12
TELEM_CT_ESTABLISHED = 13
TELEM_CT_REPLY = 14
TELEM_CT_RELATED = 15
TELEM_CT_BYPASS_ALLOW = 16
TELEM_CT_DELETE = 17
TELEM_IPCACHE_WORLD = 18
TELEM_PROXY_REDIRECT = 19
TELEM_COLS = 20

TELEM_NAMES = (
    "total", "forwarded", "denied", "drop_prefilter", "drop_policy",
    "drop_frag", "match_l4", "match_l3", "match_l4_wild", "match_none",
    "match_frag", "lb_dnat", "ct_new", "ct_established", "ct_reply",
    "ct_related", "ct_bypass_allow", "ct_delete", "ipcache_world",
    "proxy_redirect",
)


@dataclass
class TupleBatch:
    """A batch of flow tuples (the SearchContext of the datapath), int32
    tensors [B]: ep_index, identity (u32 bits: the source identity on
    ingress, the destination's on egress), dport, proto, direction
    (0 ingress, 1 egress) and a bool is_fragment.  `packed` is the
    [6, B] int32 upload the columns are views of, when they came from
    one; the kernel reads it."""

    ep_index: torch.Tensor
    identity: torch.Tensor
    dport: torch.Tensor
    proto: torch.Tensor
    direction: torch.Tensor
    is_fragment: torch.Tensor
    packed: Optional[torch.Tensor] = None

    @staticmethod
    def from_numpy(ep_index, identity, dport, proto, direction,
                   is_fragment=None, device=None) -> "TupleBatch":
        """One [6, B] u32 pack uploaded to `device` (None = the card)
        in a single copy.  Every column is cast through u32, as the
        reference's pack is: an ep_index of -1 arrives as int32 -1, and
        any nonzero fragment word is True."""
        from cilium_tpu_torch.convert import tuple_batch_to

        return tuple_batch_to(
            pack_tuples(ep_index, identity, dport, proto, direction,
                        is_fragment),
            device,
        )

    def pack(self) -> torch.Tensor:
        """The [6, B] int32 pack of the columns."""
        if self.packed is not None:
            return self.packed
        return torch.stack([
            self.ep_index.to(torch.int32), self.identity.to(torch.int32),
            self.dport.to(torch.int32), self.proto.to(torch.int32),
            self.direction.to(torch.int32), self.is_fragment.to(torch.int32),
        ]).contiguous()


def pack_tuples(ep_index, identity, dport, proto, direction,
                is_fragment=None) -> np.ndarray:
    """The [6, B] u32 host pack of TupleBatch.from_numpy."""
    b = len(ep_index)
    if is_fragment is None:
        is_fragment = np.zeros(b, dtype=bool)
    packed = np.empty((6, b), dtype=np.uint32)
    packed[0] = np.asarray(ep_index).astype(np.uint32, copy=False)
    packed[1] = np.asarray(identity, np.uint32)
    packed[2] = np.asarray(dport).astype(np.uint32, copy=False)
    packed[3] = np.asarray(proto).astype(np.uint32, copy=False)
    packed[4] = np.asarray(direction).astype(np.uint32, copy=False)
    packed[5] = np.asarray(is_fragment).astype(np.uint32)
    return packed


def _tuple_batch_from_packed(packed: torch.Tensor) -> TupleBatch:
    """The columns of a [6, B] int32 pack (u32 bits), as views."""
    return TupleBatch(
        ep_index=packed[0], identity=packed[1], dport=packed[2],
        proto=packed[3], direction=packed[4], is_fragment=packed[5] != 0,
        packed=packed,
    )


@dataclass
class Verdicts:
    """Per-tuple results: allowed u8 0/1, proxy_port int32 (0 = plain
    allow), match_kind u8 (MATCH_* codes)."""

    allowed: torch.Tensor
    proxy_port: torch.Tensor
    match_kind: torch.Tensor


def _gather_ix(i, n: int):
    """An XLA gather's index: negative counts from the end, then it
    clamps to [0, n)."""
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def _index_identity(tables, identity):
    """Identity -> dense index through the two-region id_direct table
    ([0, lo_len) cluster-scope ids, [lo_len, end) local CIDR ids offset
    by LOCAL_ID_BASE), with the reference's unsigned compares and its
    position clamp.  `identity` int64 holding u32 values.  Returns
    (idx int64, known bool); an unknown identity gets idx n - 1."""
    n = int(tables.id_table.shape[0])
    direct_sz = int(tables.id_direct.shape[0])
    lo_len = int(tables.id_lo_len) & MASK32
    is_local = identity >= LOCAL_ID_BASE
    local_off = (identity - LOCAL_ID_BASE) & MASK32
    pos = torch.where(is_local, (lo_len + local_off) & MASK32, identity)
    in_range = torch.where(
        is_local,
        local_off < ((direct_sz - lo_len) & MASK32),
        identity < lo_len,
    )
    v = widen(tables.id_direct[pos.clamp(max=direct_sz - 1)])
    known = in_range & (v != int(NO_INDEX))
    return torch.where(known, v, n - 1), known


def _index(tables, batch: TupleBatch):
    """Index resolution from the small replicated tables only (the
    word-sharded mesh's probe): (idx, word, bit, known, j, has_port),
    int64 and bool [B], all global.  The L4 slot comes from port_slot,
    read at the clipped (proto, dport)."""
    idx, known = _index_identity(tables, widen(batch.identity))
    word = idx >> 5
    bit = idx & 31
    proto = batch.proto.to(torch.int64).clamp(0, 255)
    dport = batch.dport.to(torch.int64).clamp(0, 65535)
    slot = tables.port_slot[proto, dport].to(torch.int64)
    has_port = slot != int(NO_SLOT)
    j = torch.where(has_port, slot, 0)
    return idx, word, bit, known, j, has_port


def l4hash_probe_keys(entry_words: int, ep, dirn, idx, dport, proto):
    """(w0, w1) probe key words for either hashed layout; `idx` may
    carry L4H_WILD_IDX, which the compact layout remaps to its own
    18-bit sentinel.  All inputs int64."""
    if entry_words == 2:
        idx18 = torch.where(
            idx == int(L4H_WILD_IDX), int(L4C_WILD_IDX18), idx
        )
        w0 = (idx18 & 0x3FFFF) | ((dport & 0x3FFF) << 18)
        w1 = (
            (dport >> 14)
            | ((proto & 0xFF) << 2)
            | ((ep & 0xFF) << 10)
            | ((dirn & 1) << 18)
        )
        return w0, w1
    w0 = (idx | (dirn << 22) | ((ep & 0x1FF) << 23)) & 0xFFFFFFFF
    w1 = ((dport << 16) | (proto << 8) | (ep >> 9)) & 0xFFFFFFFF
    return w0, w1


def _msum(hit, vals):
    return torch.where(hit, vals, 0).sum(dim=1) & 0xFFFFFFFF


def l4hash_row_parts(rows, w0, w1, entry_words: int):
    """Lane compares against fetched rows.  Returns (found, val): val
    is `j << 16 | proxy` (3-word) or the bare slot j (compact)."""
    r = widen(rows)
    e = r.shape[1] // entry_words
    if entry_words == 2:
        k1 = r[:, e : 2 * e]
        hit = (r[:, :e] == w0[:, None]) & (
            (k1 & int(L4C_CMP_MASK)) == w1[:, None]
        )
        vals = (k1 >> 19) & 0xFFF
    else:
        hit = (r[:, :e] == w0[:, None]) & (r[:, e : 2 * e] == w1[:, None])
        vals = r[:, 2 * e : 3 * e]
    return hit.any(dim=1), _msum(hit, vals)


def l4hash_stash_parts(stash, w0, w1, entry_words: int):
    s = widen(stash)
    if entry_words == 2:
        s_hit = (s[None, :, 0] == w0[:, None]) & (
            (s[None, :, 1] & int(L4C_CMP_MASK)) == w1[:, None]
        )
        vals = (s[None, :, 1] >> 19) & 0xFFF
    else:
        s_hit = (s[None, :, 0] == w0[:, None]) & (s[None, :, 1] == w1[:, None])
        vals = s[None, :, 2]
    return s_hit.any(dim=1), _msum(s_hit, vals)


def _l4hash_probe(rows, stash, ep, dirn, idx, dport, proto):
    """One probe of a hashed L4 table: (hit, value)."""
    entry_words = l4_entry_words(stash)
    w0, w1 = l4hash_probe_keys(entry_words, ep, dirn, idx, dport, proto)
    h = fnv1a(torch.stack([w0, w1], dim=1))
    row = rows[h & (rows.shape[0] - 1)]
    found, val = l4hash_row_parts(row, w0, w1, entry_words)
    s_found, s_val = l4hash_stash_parts(stash, w0, w1, entry_words)
    return found | s_found, (val + s_val) & 0xFFFFFFFF


def l4hash_value_decode(tables, ep, dirn, probe1, val1, hit3, val3,
                        entry_words: int):
    """(proxy, j) from the exact/wild probe values.  The compact
    layout rebuilds proxy from one l4_meta read at [ep, dir, j]
    (indices as an XLA gather takes them, see _gather_ix)."""
    val = torch.where(probe1, val1, val3)
    if entry_words == 3:
        return val & 0xFFFF, val >> 16
    j32 = torch.where(val >= (1 << 31), val - (1 << 32), val)  # as int32
    e_count, _, kg = tables.l4_meta.shape
    meta = widen(tables.l4_meta[
        _gather_ix(ep, e_count), _gather_ix(dirn, 2), _gather_ix(j32, kg)
    ])
    proxy = torch.where(probe1 | hit3, meta >> 1, 0)
    return proxy, j32


def _probes(tables, ep, dirn, dport, proto, identity=None, idx_known=None):
    """The three map probes (policy.h:46).  ep, dirn: int64 as the
    tuple's int32 words (table reads take them as _gather_ix does, the
    hash keys their u32 bits); dport, proto int64, clipped here.  The
    identity is either `identity` (int64 u32 values), resolved through
    id_direct, or `idx_known` = (idx, known[, l3_bit]) pre-resolved by
    the idx-form ipcache: then id_direct is not read, and with l3_bit
    l3_allow_bits is not read either.  With `l4_hash_rows` None the
    dense fallback takes the place of the hashed probes.  Returns
    (probe1, probe2, probe3, proxy, j, idx)."""
    l3_bit = None
    if idx_known is None:
        idx, known = _index_identity(tables, identity)
    else:
        idx, known = idx_known[0], idx_known[1]
        if len(idx_known) > 2:
            l3_bit = idx_known[2]
    # the word read takes idx as the reference's int32 index does
    idx32 = torch.where(idx >= 1 << 31, idx - (1 << 32), idx)
    word = _gather_ix(idx32 >> 5, int(tables.l3_allow_bits.shape[2]))
    bit = idx & 31
    proto = proto.clamp(0, 255)
    dport = dport.clamp(0, 65535)
    e_count, _, kg = tables.l4_meta.shape
    epg, dg = _gather_ix(ep, e_count), _gather_ix(dirn, 2)
    if tables.l4_hash_rows is not None:
        # an unknown identity resolves to the in-range fallback idx and
        # probe 1 is masked by `known`; the wildcard probe is not
        ep32, d32 = ep & MASK32, dirn & MASK32
        hit1, val1 = _l4hash_probe(
            tables.l4_hash_rows, tables.l4_hash_stash, ep32, d32, idx, dport,
            proto,
        )
        hit3, val3 = _l4hash_probe(
            tables.l4_wild_rows, tables.l4_wild_stash, ep32, d32,
            torch.full_like(idx, int(L4H_WILD_IDX)), dport, proto,
        )
        probe1 = known & hit1
        probe3 = hit3
        proxy, j = l4hash_value_decode(
            tables, ep, dirn, probe1, val1, hit3, val3, l4_entry_words(tables)
        )
    else:
        slot = tables.port_slot[proto, dport].to(torch.int64)
        has_port = slot != int(NO_SLOT)
        j = torch.where(has_port, slot, 0)
        jg = _gather_ix(j, kg)
        exact = widen(tables.l4_allow_bits[epg, dg, jg, word])
        meta = widen(tables.l4_meta[epg, dg, jg])
        proxy = meta >> 1
        probe1 = known & has_port & ((exact >> bit) & 1).bool()
        probe3 = has_port & (meta & 1).bool()
    if l3_bit is None:
        l3_bit = ((widen(tables.l3_allow_bits[epg, dg, word]) >> bit) & 1).bool()
    return probe1, known & l3_bit, probe3, proxy, j, idx


def _combine(probe1, probe2, probe3, proxy, frag):
    """Lattice combine (policy.h order; fragments skip L4 probes).
    Returns (allowed bool, proxy int64, match_kind u8)."""
    p1 = probe1 & ~frag
    p3 = probe3 & ~frag
    allowed = p1 | probe2 | p3
    proxy_out = torch.where(p1 | (~probe2 & p3), proxy, 0)
    proxy_out = torch.where(allowed, proxy_out, 0)
    kind = torch.where(
        p1, MATCH_L4,
        torch.where(
            probe2, MATCH_L3,
            torch.where(
                p3, MATCH_L4_WILD,
                torch.where(frag, MATCH_FRAG_DROP, MATCH_NONE),
            ),
        ),
    ).to(torch.uint8)
    return allowed, proxy_out, kind


def _counter_cols(kind, ep, dirn, j, idx, kg: int):
    """Scatter ingredients of the per-entry counters: (ep, dir, col,
    weight); L4 hits count at slot j, L3 hits at column kg + idx."""
    hit_l4 = (kind == MATCH_L4) | (kind == MATCH_L4_WILD)
    hit_l3 = kind == MATCH_L3
    col = torch.where(hit_l4, j, kg + idx)
    return ep, dirn, col, (hit_l4 | hit_l3)


def _accumulate_counters(acc, ep, dirn, col, weight):
    """Add each weighted hit into the counter buffer acc [E, 2, C] in
    place, as an XLA scatter-add does: a negative index counts from the
    end of its axis, and an update still outside the buffer is
    dropped."""
    e_count, two, c = acc.shape
    ix = [torch.where(i < 0, i + n, i)
          for i, n in ((ep, e_count), (dirn, two), (col, c))]
    ok = weight
    for i, n in zip(ix, (e_count, two, c)):
        ok = ok & (i >= 0) & (i < n)
    flat = (ix[0][ok] * two + ix[1][ok]) * c + ix[2][ok]
    acc.view(-1).index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return acc


def split_counters(acc, tables):
    """The flat buffer as (l4 [E, 2, Kg], l3 [E, 2, N]) views."""
    kg = tables.l4_meta.shape[2]
    return acc[:, :, :kg], acc[:, :, kg:]


def _lattice_plain(tables, batch: TupleBatch, identity=None,
                   counters: bool = False):
    """Plain version of the tuple-batch lattice: Verdicts, and with
    `counters` the fresh [E, 2, Kg + N] hit buffer.  `identity`
    (int64 u32 values) replaces the batch's identity column."""
    ep = batch.ep_index.to(torch.int64)
    dirn = batch.direction.to(torch.int64)
    if identity is None:
        identity = widen(batch.identity)
    probe1, probe2, probe3, proxy, j, idx = _probes(
        tables, ep, dirn, batch.dport.to(torch.int64),
        batch.proto.to(torch.int64), identity=identity,
    )
    allowed, proxy_out, kind = _combine(
        probe1, probe2, probe3, proxy, batch.is_fragment.bool()
    )
    v = Verdicts(allowed=allowed.to(torch.uint8),
                 proxy_port=proxy_out.to(torch.int32), match_kind=kind)
    if not counters:
        return v, None
    acc = make_counter_buffers(tables)
    kg = int(tables.l4_meta.shape[2])
    _accumulate_counters(acc, *_counter_cols(kind, ep, dirn, j, idx, kg))
    return v, acc


def _verdict_kernel(tables, batch: TupleBatch) -> Verdicts:
    """Plain version of the reference's `_verdict_kernel`."""
    return _lattice_plain(tables, batch)[0]


def _verdict_kernel_with_counters(tables, batch: TupleBatch):
    """Plain version of the counter form: (Verdicts, l4 [E, 2, Kg],
    l3 [E, 2, N]) of fresh per-batch counters."""
    v, acc = _lattice_plain(tables, batch, counters=True)
    return (v, *split_counters(acc, tables))


def _lattice_device(tables, batch: TupleBatch, device) -> torch.device:
    dev = resolve_device(device)
    require_on(batch.ep_index, dev,
               "the tuple batch (TupleBatch.from_numpy(..., device))")
    require_on(tables.l3_allow_bits, dev,
               "the policy tables (convert.policy_tables_to)")
    return dev


def evaluate_batch(tables, batch: TupleBatch, device=None) -> Verdicts:
    """The tuple-batch lattice (K23) on `device` (None = the card),
    where `tables` (PolicyTables) and `batch` must already lie.  A CUDA
    device launches LATTICE; the CPU runs the plain version."""
    if _lattice_device(tables, batch, device).type == "cuda":
        from cilium_tpu_torch import kernels

        return kernels.LATTICE(tables, batch)[0]
    return _verdict_kernel(tables, batch)


def evaluate_batch_with_counters(tables, batch: TupleBatch, device=None):
    """The counter form of evaluate_batch: (Verdicts, l4 [E, 2, Kg],
    l3 [E, 2, N]) of this batch's hits (u32 bits in int32)."""
    if _lattice_device(tables, batch, device).type == "cuda":
        from cilium_tpu_torch import kernels

        v, acc = kernels.LATTICE(tables, batch, counters=True)
        return (v, *split_counters(acc, tables))
    return _verdict_kernel_with_counters(tables, batch)


def evaluate_batch_from_ips(lpm_tables, policy_tables, src_ips,
                            batch: TupleBatch, device=None) -> Verdicts:
    """The CIDR path (K20's fused form): each tuple's identity is the
    DIR-24-8 lookup of its source address (0 when the ipcache misses),
    then the lattice; the batch's identity column is ignored.  All
    inputs lie on `device` (None = the card): a CUDA device launches
    LATTICE in IP mode, the CPU runs the plain versions."""
    from cilium_tpu_torch.ipcache.lpm import lpm_lookup_plain

    dev = _lattice_device(policy_tables, batch, device)
    require_on(src_ips, dev, "src_ips")
    require_on(lpm_tables.l1, dev, "the LPM tables (convert.lpm_to)")
    if dev.type == "cuda":
        from cilium_tpu_torch import kernels

        return kernels.LATTICE(policy_tables, batch, lpm=lpm_tables,
                               src_ips=src_ips)[0]
    ids = lpm_lookup_plain(lpm_tables, src_ips)
    return _lattice_plain(policy_tables, batch, identity=ids)[0]


def telemetry_masks(pre_dropped, ct_result, match_kind, allowed, ct_delete,
                    proxy_port, lb_slave, ipcache_miss):
    """The TELEM_* column masks as bool [B] tensors, in column order."""
    allowed = allowed.bool()
    pre = pre_dropped.bool()
    kind = match_kind
    denied = ~allowed
    post = denied & ~pre
    pass_ct = (ct_result == CT_REPLY) | (ct_result == CT_RELATED)
    pol_allow = (kind == MATCH_L4) | (kind == MATCH_L3) | (
        kind == MATCH_L4_WILD
    )
    return [
        torch.ones_like(allowed),
        allowed,
        denied,
        pre,
        post & (kind == MATCH_NONE),
        post & (kind == MATCH_FRAG_DROP),
        kind == MATCH_L4,
        kind == MATCH_L3,
        kind == MATCH_L4_WILD,
        kind == MATCH_NONE,
        kind == MATCH_FRAG_DROP,
        lb_slave > 0,
        ct_result == CT_NEW,
        ct_result == CT_ESTABLISHED,
        ct_result == CT_REPLY,
        ct_result == CT_RELATED,
        pass_ct & ~pol_allow & ~pre,
        ct_delete.bool(),
        ipcache_miss.bool(),
        (proxy_port > 0) & allowed,
    ]


def make_counter_buffers(tables) -> torch.Tensor:
    """Zeroed counter buffer [E, 2, Kg + N] (u32 bits in int32) on the
    policy tables' device: L4 slot columns first, then L3 identity
    columns."""
    e_count, _, kg = tables.l4_meta.shape
    n = tables.id_table.shape[0]
    return torch.zeros(
        (e_count, 2, kg + n), dtype=torch.int32, device=tables.l4_meta.device
    )


def make_telemetry_buffers(device) -> torch.Tensor:
    """Zeroed [2, TELEM_COLS] telemetry accumulator (u32 bits in
    int32)."""
    return torch.zeros((2, TELEM_COLS), dtype=torch.int32, device=device)


def make_sharded_evaluator(mesh=None, batch_axis: str = "batch"):
    """The batch split over the mesh's batch axis, the tables
    replicated (flow batches shard like packets across nodes, tables
    replicate like per-node BPF maps): fn(tables, batch) -> Verdicts.
    Each batch row runs the tuple lattice on its own device (LATTICE on
    a CUDA device, the plain version on the CPU) over its slice, and
    the rows' verdicts concatenate in batch order.  `tables` is
    PolicyTables (host or device) or MeshTables placed replicated;
    `batch` a TupleBatch (B a multiple of the batch-axis size) or
    sharded.shard_batch's rows.  With `mesh=None` it is evaluate_batch."""
    if mesh is None:
        return evaluate_batch
    from cilium_tpu_torch.engine import sharded

    shardings = sharded.replicated_table_shardings(mesh)

    def run(tables, batch) -> Verdicts:
        mt = sharded.placed(tables, shardings)
        sb = sharded.shard_batch(mesh, batch, batch_axis=batch_axis)
        home = mesh.devices[0, 0]
        outs = []
        for b in range(int(mesh.shape[batch_axis])):
            dev = mesh.devices[b, 0]
            outs.append(evaluate_batch(mt.shard(b, 0), sb.on(b, dev),
                                       device=dev))
        return Verdicts(*(torch.cat([getattr(o, c).to(home) for o in outs])
                          for c in ("allowed", "proxy_port", "match_kind")))

    return run
