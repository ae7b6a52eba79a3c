"""Moving datapath tables between host numpy and device tensors.

`tables_to` moves tables built by this package's own builders onto a
device.  `tables_from_numpy` takes the leaves of tables built
elsewhere (the JAX package's `DatapathTables`, handed over as numpy
arrays and Python scalars) and builds this package's tables from
them: the carried-across form of the same compiled maps.
`datapath6_tables_to` and `datapath6_tables_from_numpy` do the same
for the v6 program's tables, `flow_batch6_to` moves a v6 flow batch.

`map_states_from_numpy` builds this package's MapStateArrays from a
map state's arrays (the JAX package's MapStateArrays handed over as
numpy: packed u64 keys and proxy ports), and `map_states_to_numpy` is
the reverse.

Every u32 array becomes an int32 tensor holding the same bits; static
layout facts (bucket counts, widths, class schedules) and scalar leaves
(the policy's `id_lo_len` and its `generation` stamp) become Python
ints.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cilium_tpu_torch.compiler.tables import PolicyTables
from cilium_tpu_torch.ct.device import CTSnapshot
from cilium_tpu_torch.device import resolve_device, u32_tensor
from cilium_tpu_torch.engine.datapath import DatapathTables
from cilium_tpu_torch.engine.datapath6 import (
    CT6Snapshot,
    Datapath6Tables,
    FlowBatch6,
    Prefilter6,
)
from cilium_tpu_torch.ipcache.lpm import IPCacheDevice, LPMTables
from cilium_tpu_torch.ipcache.lpm6 import IPCache6Device
from cilium_tpu_torch.lb.device import LBInline, LBTables
from cilium_tpu_torch.lb.device6 import LB6Inline
from cilium_tpu_torch.maps.policymap import MapStateArrays
from cilium_tpu_torch.prefilter import PrefilterRanges
from cilium_tpu_torch.tunnel import TunnelTables, TunnelTables6

# (plane, class or classes, may be None) of each table set; of several
# classes a plane takes the first whose required leaves are all given
_PLANES = (
    ("prefilter", (PrefilterRanges, LPMTables), False),
    ("ipcache", (IPCacheDevice, LPMTables), False),
    ("ct", CTSnapshot, False),
    ("lb", (LBInline, LBTables), False),
    ("policy", PolicyTables, False),
    ("tunnel", TunnelTables, True),
)
_PLANES6 = (
    ("prefilter", Prefilter6, False),
    ("ipcache", IPCache6Device, False),
    ("ct", CT6Snapshot, False),
    ("policy", PolicyTables, False),
    ("tunnel", TunnelTables6, True),
    ("lb", LB6Inline, True),
)


def _leaf_to(value, device):
    """One host leaf on `device`: a u32 array as int32 bits (a fresh
    tensor, never an alias of `value`), a u16 array widened to int32, a
    numpy scalar or 0-d array as a Python int."""
    if isinstance(value, np.ndarray) and value.ndim > 0:
        if value.dtype == np.uint32:
            return u32_tensor(value, device)
        if value.dtype == np.uint16:
            return torch.from_numpy(value.astype(np.int32)).to(device)
        raise TypeError(f"unexpected table leaf dtype {value.dtype}")
    if isinstance(value, (np.integer, np.ndarray)):
        return int(value)
    return value


def _plane_to(plane, device):
    if plane is None:
        return None
    return dataclasses.replace(
        plane,
        **{
            f.name: _leaf_to(getattr(plane, f.name), device)
            for f in dataclasses.fields(plane)
        },
    )


def _tables_to(cls, planes, tables, device):
    dev = resolve_device(device)
    return cls(**{name: _plane_to(getattr(tables, name), dev)
                  for name, _, _ in planes})


def tables_to(tables: DatapathTables, device=None) -> DatapathTables:
    """Host-built tables -> the same tables on `device` (None = the
    card).  Cold leaves already dropped (None) stay None, and so does
    an absent tunnel map."""
    return _tables_to(DatapathTables, _PLANES, tables, device)


def datapath6_tables_to(tables: Datapath6Tables,
                        device=None) -> Datapath6Tables:
    """Host-built v6 tables -> the same tables on `device` (None = the
    card); an absent tunnel map or LB stays None."""
    return _tables_to(Datapath6Tables, _PLANES6, tables, device)


def _check_host_value(path: str, value) -> None:
    ok = value is None or isinstance(
        value, (np.ndarray, np.generic, int, bool, tuple)
    )
    if not ok:
        raise TypeError(
            f"{path}: tables_from_numpy takes numpy arrays and Python "
            f"scalars only, got {type(value).__name__}"
        )


def _planes_from_numpy(leaves: dict, planes) -> dict:
    out = {}
    for name, cls, optional in planes:
        src = leaves.get(name)
        if src is None:
            if not optional:
                raise KeyError(f"{name} missing")
            out[name] = None
            continue
        if isinstance(cls, tuple):
            cls = next((c for c in cls if all(
                f.name in src for f in dataclasses.fields(c)
                if f.default is dataclasses.MISSING)), cls[0])
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in src:
                value = src[f.name]
                _check_host_value(f"{name}.{f.name}", value)
                if isinstance(value, tuple):
                    value = tuple(int(v) for v in value)
                kwargs[f.name] = value
            elif f.default is dataclasses.MISSING:
                raise KeyError(f"{name}.{f.name} missing")
        out[name] = cls(**kwargs)
    return out


def tables_from_numpy(leaves: dict, device=None) -> DatapathTables:
    """Build the port's tables from a dict of planes, each a dict of
    leaf name -> numpy array or Python scalar, keyed as the JAX
    package's table fields are: {"prefilter": {base, mask} or the
    DIR-24-8 {l1, l2}, "ipcache": {buckets, stash, range_*, n_buckets,
    values_are_idx, world_plus1, l3_planes, world_l3_*, range_rows,
    range_class_plens, bucket_entries, value_width, l3_width,
    range_widths} or {l1, l2}, "ct": {buckets, stash, n_buckets,
    entry_words}, "lb": {rows, stash, n_buckets} (inline) or {buckets,
    stash, backend_rows, n_buckets} (classic), "policy": {id_table, ...,
    generation (optional, the publish stamp, carried as a Python int)},
    "tunnel": {base, mask, endpoint} or None}.  A missing leaf the port
    needs raises."""
    return tables_to(DatapathTables(**_planes_from_numpy(leaves, _PLANES)),
                     device)


def host_tables_from_numpy(leaves: dict) -> DatapathTables:
    """tables_from_numpy's tables kept on the host: the leaves as
    given (numpy arrays and Python scalars), the input of the mesh
    stores and evaluators, which place them themselves."""
    return DatapathTables(**_planes_from_numpy(leaves, _PLANES))


def datapath6_tables_from_numpy(leaves: dict,
                                device=None) -> Datapath6Tables:
    """The port's v6 tables on `device` (None = the card) from the JAX
    package's compiled v6 leaves: {"prefilter": {base, mask},
    "ipcache": {buckets, stash, range_base, range_mask, range_plen,
    range_value, n_buckets}, "ct": {buckets, stash, n_buckets},
    "policy": {id_table, ...}, "tunnel": {base, mask, endpoint} or
    None, "lb": {rows, stash, n_buckets} or None}."""
    return datapath6_tables_to(
        Datapath6Tables(**_planes_from_numpy(leaves, _PLANES6)), device)


def flow_batch6_to(flows: FlowBatch6, device=None) -> FlowBatch6:
    """A v6 flow batch -> the same columns on `device` (None = the
    card)."""
    dev = resolve_device(device)
    return FlowBatch6(**{
        f.name: getattr(flows, f.name).to(dev)
        for f in dataclasses.fields(FlowBatch6)
    })


def plane_to(plane, device=None):
    """One table plane (any of the dataclasses above, numpy leaves) ->
    the same plane on `device` (None = the card): for swapping one
    plane of tables already there, a recompiled CT6 snapshot or a
    tunnel map."""
    return _plane_to(plane, resolve_device(device))


def policy_tables_to(tables: PolicyTables, device=None) -> PolicyTables:
    """Bare policy tables (numpy, as compile_map_states builds them) ->
    the same tables on `device` (None = the card): the tables of
    evaluate_batch and replay_lattice.  port_slot's u16 becomes int32,
    the `generation` stamp a Python int; leaves already dropped (None)
    stay None."""
    return _plane_to(tables, resolve_device(device))


def lpm_to(tables: LPMTables, device=None) -> LPMTables:
    """DIR-24-8 tables (numpy u32) -> the same tables on `device` (None
    = the card).  l1 is 64 MB: move it once per world, not per batch."""
    return _plane_to(tables, resolve_device(device))


def hashtable_to(table, device=None):
    """A HashTable built on the host (engine/hashtable.py) -> the same
    table on `device` (None = the card): keys as int32 bits,
    value_index int32."""
    from cilium_tpu_torch.device import array_tensor

    dev = resolve_device(device)
    return dataclasses.replace(
        table, keys=u32_tensor(table.keys, dev),
        value_index=array_tensor(np.asarray(table.value_index, np.int32),
                                 dev))


def lpm_from_numpy(leaves: dict, device=None) -> LPMTables:
    """The port's LPMTables on `device` (None = the card) from the
    leaves of tables built elsewhere: {l1: u32 [2^24], l2: u32
    [blocks, 256]}."""
    for name in ("l1", "l2"):
        _check_host_value(f"lpm.{name}", leaves[name])
    return lpm_to(LPMTables(l1=np.asarray(leaves["l1"], np.uint32),
                            l2=np.asarray(leaves["l2"], np.uint32)), device)


def tuple_batch_to(packed: np.ndarray, device=None):
    """One [6, B] u32 tuple pack (verdict.pack_tuples) -> a TupleBatch on
    `device` (None = the card), in one copy; the columns are views of
    the uploaded pack."""
    from cilium_tpu_torch.engine.verdict import _tuple_batch_from_packed

    packed = np.asarray(packed)
    if packed.ndim != 2 or packed.shape[0] != 6:
        raise ValueError(f"a tuple pack is [6, B], got {packed.shape}")
    return _tuple_batch_from_packed(u32_tensor(packed, resolve_device(device)))


def cache_rows_to(rows, device=None) -> torch.Tensor:
    """Verdict-cache rows (numpy u32 [n_rows + 1, W], as
    memo.make_cache_rows builds them or carried out of another cache)
    -> an int32 tensor with the same bits on `device` (None = the
    card).  Checks that the width is one of the three row layouts."""
    from cilium_tpu_torch.engine.memo import CACHE_WORDS, cache_layout

    rows = np.asarray(rows)
    if rows.ndim != 2 or rows.shape[0] < 2:
        raise ValueError(f"cache rows are [n_rows + 1, W], got {rows.shape}")
    n_rows = rows.shape[0] - 1
    if n_rows & (n_rows - 1):
        raise ValueError(f"cache rows must be a power of two: {n_rows}")
    e, ranked, subw = cache_layout(rows)
    want = (4 * e + e // 8 + 1 if subw
            else CACHE_WORDS * e + (1 if ranked else 0))
    if e < 1 or rows.shape[1] != want:
        raise ValueError(f"no cache row layout is {rows.shape[1]} words wide")
    return u32_tensor(rows, resolve_device(device))


def cache_rows_to_numpy(rows: torch.Tensor) -> np.ndarray:
    """Cache rows on any device -> numpy u32, the reference's form."""
    return rows.detach().cpu().numpy().view(np.uint32).copy()


def ct_snapshot_to(snapshot: CTSnapshot, device=None) -> CTSnapshot:
    """A CT snapshot (numpy buckets and stash) -> the same snapshot on
    `device` (None = the card)."""
    return _plane_to(snapshot, resolve_device(device))


def ct_snapshot_from_numpy(leaves: dict, device=None) -> CTSnapshot:
    """The port's CTSnapshot on `device` (None = the card) from the
    leaves of a snapshot built elsewhere: {buckets: u32 [Cb, lanes],
    stash: u32 [S, 5], n_buckets, entry_words (default 5)}."""
    for name in ("buckets", "stash"):
        _check_host_value(f"ct.{name}", leaves[name])
    snap = CTSnapshot(
        buckets=np.asarray(leaves["buckets"], np.uint32),
        stash=np.asarray(leaves["stash"], np.uint32),
        n_buckets=int(leaves["n_buckets"]),
        entry_words=int(leaves.get("entry_words", 5)),
    )
    return ct_snapshot_to(snap, device)


def flow_pool_to(pool: dict, device=None) -> torch.Tensor:
    """A flow pool's numpy columns -> its [8, P] pack (FLOW_COLUMNS
    order, u32 bits in int32) on `device` (None = the card): the state
    `replay.replay_pool` uploads, for handing the same pool to two
    loops."""
    from cilium_tpu_torch.replay import pack_flow_pool

    return u32_tensor(pack_flow_pool(pool), resolve_device(device))


# ---------------------------------------------------------------------------
# L7 tables (l7/http.py, l7/kafka.py, l7/fleet.py)
# ---------------------------------------------------------------------------


def _l7_array_to(value: np.ndarray, device) -> torch.Tensor:
    if value.dtype == np.uint32:
        return u32_tensor(value, device)
    if value.dtype == np.uint16:
        return torch.from_numpy(value.astype(np.int32)).to(device)
    if value.dtype in (np.uint8, np.int32, np.int64, np.bool_):
        return torch.from_numpy(np.array(value, copy=True)).to(device)
    raise TypeError(f"unexpected L7 table leaf dtype {value.dtype}")


def _l7_to(obj, device):
    """Every numpy array leaf of an L7 table dataclass (nested
    dataclasses and lists of arrays included) -> a tensor on `device`;
    scalars, rule specs and the interner stay as they are."""
    if isinstance(obj, np.ndarray):
        return _l7_array_to(obj, device)
    if isinstance(obj, list):
        return [_l7_to(v, device) if isinstance(v, np.ndarray) else v
                for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _l7_to(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)
        })
    return obj


def l7_tables_to(tables, device=None):
    """Any host L7 table set (HTTPTables or HTTPPolicy, KafkaTables,
    FleetL7, a generic parser's device tables such as
    MemcacheDeviceTables) -> the same tables with tensor leaves on
    `device` (None = the card)."""
    return _l7_to(tables, resolve_device(device))


def _dfa_from_numpy(leaves: dict):
    from cilium_tpu_torch.l7.regex_dfa import DFA

    return DFA(
        trans=np.asarray(leaves["trans"]),
        accept=np.asarray(leaves["accept"]),
        classes=np.asarray(leaves["classes"]),
        start=int(leaves["start"]),
    )


def _strided_from_numpy(leaves):
    from cilium_tpu_torch.l7.http import StridedDFA

    if leaves is None:
        return None
    return StridedDFA(
        classes=np.asarray(leaves["classes"]),
        id_class0=int(leaves["id_class0"]),
        base_trans=np.asarray(leaves["base_trans"]),
        level_maps=[np.asarray(a) for a in leaves["level_maps"]],
        level_ncs=[int(v) for v in leaves["level_ncs"]],
        level_ids=[int(v) for v in leaves["level_ids"]],
        level_trans=[np.asarray(a) for a in leaves["level_trans"]],
        trans=np.asarray(leaves["trans"]),
        start=int(leaves["start"]),
        accept=np.asarray(leaves["accept"]),
    )


def _http_host_from_numpy(leaves: dict):
    """Host HTTPTables from the leaves of tables compiled elsewhere: {method_dfa, path_dfa, host_dfa: {trans, accept,
    classes, start}, absent_method, absent_path, absent_host,
    ident_rules, n_rules, n_words, method_sdfa, path_sdfa, host_sdfa:
    None or {classes, id_class0, base_trans, level_maps, level_ncs,
    level_ids, level_trans, trans, start, accept}}."""
    from cilium_tpu_torch.l7.http import HTTPTables

    kwargs = {}
    for f in ("method", "path", "host"):
        kwargs[f"{f}_dfa"] = _dfa_from_numpy(leaves[f"{f}_dfa"])
        kwargs[f"{f}_sdfa"] = _strided_from_numpy(leaves.get(f"{f}_sdfa"))
        kwargs[f"absent_{f}"] = np.asarray(leaves[f"absent_{f}"])
    return HTTPTables(
        ident_rules=np.asarray(leaves["ident_rules"]),
        n_rules=int(leaves["n_rules"]),
        n_words=int(leaves["n_words"]),
        **kwargs,
    )


def _kafka_host_from_numpy(leaves: dict):
    """Host KafkaTables from the leaves of tables compiled elsewhere: {rule_keys_lo, rule_keys_hi, rule_keys_any,
    rule_version, rule_client, rule_topic, ident_rules, n_rules,
    interner: {string: id}, specs: optional list of dicts of
    KafkaRuleSpec fields}."""
    from cilium_tpu_torch.l7.kafka import Interner, KafkaRuleSpec, KafkaTables

    interner = Interner()
    interner._ids = {str(k): int(v) for k, v in leaves["interner"].items()}
    return KafkaTables(
        rule_keys_lo=np.asarray(leaves["rule_keys_lo"]),
        rule_keys_hi=np.asarray(leaves["rule_keys_hi"]),
        rule_keys_any=np.asarray(leaves["rule_keys_any"]),
        rule_version=np.asarray(leaves["rule_version"]),
        rule_client=np.asarray(leaves["rule_client"]),
        rule_topic=np.asarray(leaves["rule_topic"]),
        ident_rules=np.asarray(leaves["ident_rules"]),
        n_rules=int(leaves["n_rules"]),
        interner=interner,
        specs=[KafkaRuleSpec(**s) for s in leaves.get("specs", [])],
    )


def http_tables_from_numpy(leaves: dict, device=None):
    """The port's HTTPTables on `device` (None = the card) from the
    leaves of tables compiled elsewhere (see _http_host_from_numpy),
    as numpy arrays and Python scalars."""
    return l7_tables_to(_http_host_from_numpy(leaves), device)


def kafka_tables_from_numpy(leaves: dict, device=None):
    """The port's KafkaTables on `device` (None = the card) from the
    leaves of tables compiled elsewhere (see _kafka_host_from_numpy),
    the interner's string -> id map included."""
    return l7_tables_to(_kafka_host_from_numpy(leaves), device)


def fleet_from_numpy(leaves: dict, device=None):
    """The port's FleetL7 on `device` (None = the card) from the leaves
    of a fleet compiled elsewhere: {http: None or {tables: <HTTP
    leaves>, device_rules: optional list of dicts of HTTPRuleSpec
    fields}, kafka: None or <Kafka leaves>, scope_http, scope_kafka,
    parser_kind}."""
    from cilium_tpu_torch.l7.fleet import FleetL7
    from cilium_tpu_torch.l7.http import HTTPPolicy, HTTPRuleSpec

    http = None
    if leaves["http"] is not None:
        http = HTTPPolicy(
            tables=_http_host_from_numpy(leaves["http"]["tables"]),
            host_rules=[],
            device_rules=[HTTPRuleSpec(**s) for s in
                          leaves["http"].get("device_rules", [])],
        )
    kafka = (
        _kafka_host_from_numpy(leaves["kafka"])
        if leaves["kafka"] is not None else None
    )
    fleet = FleetL7(
        http=http,
        kafka=kafka,
        scope_http=np.asarray(leaves["scope_http"]),
        scope_kafka=np.asarray(leaves["scope_kafka"]),
        parser_kind=np.asarray(leaves["parser_kind"]),
    )
    return l7_tables_to(fleet, device)


def map_states_from_numpy(keys_packed, proxy) -> MapStateArrays:
    """A map state from its arrays: `keys_packed` strictly increasing
    u64 (identity<<32 | dport<<16 | proto<<8 | dir) and the parallel u32
    `proxy` ports; copied, so the result shares no memory with the
    caller's.  Counters start at 0."""
    keys = np.array(keys_packed, dtype=np.uint64)
    proxy = np.array(proxy, dtype=np.uint32)
    if len(keys) > 1 and not (keys[1:] > keys[:-1]).all():
        raise ValueError("keys_packed must be strictly increasing")
    if proxy.shape != keys.shape:
        raise ValueError("keys_packed and proxy must be parallel")
    return MapStateArrays(keys, proxy)


def map_states_to_numpy(state) -> tuple:
    """The (keys_packed, proxy) arrays of a map state (a MapStateArrays
    or a dict state), copies."""
    if not isinstance(state, MapStateArrays):
        state = MapStateArrays.from_dict(state)
    return state.keys_packed.copy(), state.proxy.copy()
