"""Host connection-tracking table: the conntrack entries the datapath
reads.

Model of bpf/lib/conntrack.h and pkg/maps/ctmap: the tuple layout
(daddr, saddr, dport, sport, nexthdr, flags), where flags carry the
direction (TUPLE_F_OUT / TUPLE_F_IN / TUPLE_F_SERVICE) and RELATED;
entries keep the rev-NAT index and the LB backend (slave) of
load-balanced flows.  Creation, deletion by the CT write-back and GC
are modelled here: the datapath's lookups run on the device over a
compiled snapshot (ct.device).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict

# conntrack.h tuple flags
TUPLE_F_OUT = 0
TUPLE_F_IN = 1
TUPLE_F_RELATED = 2
TUPLE_F_SERVICE = 4

# lookup results
CT_NEW = 0
CT_ESTABLISHED = 1
CT_REPLY = 2
CT_RELATED = 3

# directions
CT_INGRESS = 0
CT_EGRESS = 1
CT_SERVICE = 2

# default lifetimes in seconds
CT_DEFAULT_LIFETIME_TCP = 21600
CT_DEFAULT_LIFETIME_NONTCP = 60
CT_SYN_TIMEOUT = 60

IPPROTO_TCP = 6

# pkg/maps/ctmap/ctmap.go: entries per endpoint-local map
MAX_ENTRIES_LOCAL = 65536


@dataclass(frozen=True)
class CTTuple:
    """ipv4_ct_tuple, addresses as u32 host ints."""

    daddr: int
    saddr: int
    dport: int
    sport: int
    nexthdr: int
    flags: int = TUPLE_F_OUT


@dataclass
class CTEntry:
    lifetime: int = 0
    rev_nat_index: int = 0
    slave: int = 0
    seen_non_syn: bool = False
    # pre-DNAT frontend of a load-balanced flow (0 = not DNATed): the
    # device bucket index places such entries twice, once in the
    # bucket of the original tuple
    orig_daddr: int = 0
    orig_dport: int = 0


class CTMap:
    def __init__(self, max_entries: int = MAX_ENTRIES_LOCAL) -> None:
        self.entries: Dict[CTTuple, CTEntry] = {}
        self.max_entries = max_entries
        # the GC clock: seconds since this map was created (now())
        self._epoch = time.monotonic()
        # bumped by create and gc; the churn loop's device-snapshot
        # cache (replay._ChurnDriver) gates on it and on the key set
        self.mutations = 0
        # creations dropped because the map was full (best effort)
        self.insert_failures = 0

    def now(self) -> int:
        """Seconds since this map's creation (the GC clock)."""
        return int(time.monotonic() - self._epoch)

    @staticmethod
    def _update_timeout(entry: CTEntry, is_tcp: bool, syn: bool,
                        now: int) -> None:
        lifetime = CT_DEFAULT_LIFETIME_NONTCP
        if is_tcp:
            entry.seen_non_syn |= not syn
            lifetime = (
                CT_DEFAULT_LIFETIME_TCP if entry.seen_non_syn
                else CT_SYN_TIMEOUT
            )
        entry.lifetime = now + lifetime

    def create(self, tup: CTTuple, dir: int, now: int = 0,
               rev_nat_index: int = 0, slave: int = 0,
               tcp_syn: bool = False, orig_daddr: int = 0,
               orig_dport: int = 0) -> CTEntry:
        """ct_create4: the key's flags follow `dir` (ingress OUT,
        egress IN, service SERVICE).  Raises OverflowError when full."""
        if dir == CT_INGRESS:
            flags = TUPLE_F_OUT
        elif dir == CT_EGRESS:
            flags = TUPLE_F_IN
        else:
            flags = TUPLE_F_SERVICE
        key = CTTuple(
            tup.daddr, tup.saddr, tup.dport, tup.sport, tup.nexthdr, flags
        )
        if len(self.entries) >= self.max_entries and key not in self.entries:
            raise OverflowError("CT map full")
        entry = CTEntry(
            rev_nat_index=rev_nat_index, slave=slave,
            orig_daddr=orig_daddr, orig_dport=orig_dport,
        )
        self._update_timeout(entry, tup.nexthdr == IPPROTO_TCP, tcp_syn, now)
        self.entries[key] = entry
        self.mutations += 1
        return entry

    def gc(self, now: int) -> int:
        """Drop the entries whose lifetime ended before `now`; returns
        how many."""
        dead = [k for k, v in self.entries.items() if v.lifetime < now]
        for k in dead:
            del self.entries[k]
        if dead:
            self.mutations += 1
        return len(dead)

    def create_best_effort(self, tup: CTTuple, dir: int, **kw) -> bool:
        """CT creation is best-effort, as ct_create4 is in the kernel
        datapath: a full map drops this entry (counted in
        `insert_failures`) and the caller's stream goes on; the flow's
        create retries on its next appearance.  Returns True when the
        entry landed."""
        try:
            self.create(tup, dir, **kw)
            return True
        except OverflowError:
            self.insert_failures += 1
            return False
