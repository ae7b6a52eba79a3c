"""A seeded datapath world at the map-state level, config 5 by default.

Config 5 is the repo's headline deployment (bench.py's
build_config5): 50,000 policy rules over 32 endpoints and 65,536
identities in teams of 16, with the rule mix 84 % plain L4 (224 ports
x TCP/UDP), 8 % L3-only, 4 % CIDR /24 with local CIDR identities, 3 %
HTTP and 1 % Kafka (both redirected to a proxy port).  This module
builds that world at the datapath's own inputs, the contents of the
BPF maps the agent writes, without the control plane:

  * per-endpoint policy map states (ingress rules as above, plus the
    localhost allow, two L4 wildcard ports, and L3 allow of every
    identity on egress, since no rule enforces egress);
  * the ipcache: a /32 per identity and endpoint, the CIDR /24
    blocks, a /16 and a /10 (three prefix lengths), and one /16 whose
    identity is outside the policy universe;
  * 16 service VIPs with 2 endpoint backends each; the prefilter
    203.0.113.0/24;
  * a 50,000-flow pool with bench's shares (2 % prefiltered and 3 %
    world sources, 10 % of egress flows to VIPs, 10 % junk ports, 2 %
    fragments, 2.5 % proxy-bound L7 clients), plus 3 % DNS and
    metrics flows on the wildcard ports and sources from the CIDR
    ranges and the unknown-identity range;
  * conntrack seeded from the pool: forward entries (some of them on
    flows policy now denies), reply-direction entries, and
    service-scope entries with their DNATed flow entries for VIP
    flows;
  * packed4 pairs: an ingress half and an egress half sampled from
    the pool, uniform or Zipf-ranked, or with one hot flow that counts
    (`hot_pair`).

Everything is drawn from one numpy Generator seeded by `seed`.

`node_world` is config 5's rule mix on a node past every table
threshold of the agent's builders (110 endpoints, 1,024 prefilter
CIDRs, a 64-backend VIP, CIDR identities over 8 prefix lengths, or
with `lpm` 4,096 /24 CIDR identities); its extra draws come from a
second Generator.

`config6_world` is bench.py's config 6, the fused IPv6 datapath, at
the same level; `config6_ct_pass` builds its conntrack variant and
`tunnel_map` the overlay of 256 remote nodes that both config 5 and
config 6 can run with.

The bare policy lattice has worlds of its own, at the same level:
`example_world` (config 1), `cidr_world` (config 2, with its DIR-24-8
mapping and tuple generator), and over config 5: `lattice_tuples`
(bench.py's lattice line), `lattice_records` (flow records drawn
from the pool, each carrying its peer's identity), `stash_world` (a
policy whose L4 entries overflow into both stashes), `stash_tuples`
(tuples that probe a policy's stash entries) and `identity_addresses`
(addresses that resolve to given identities).  `pool_records` and
`oracle_context` serve the fused record replay and its composed host
oracle.

Policy publication takes config 5's states as `map_state_arrays` (the
daemon endpoints' form) and churns them with `one_rule_states`,
bench.py's one-rule update at map-state level.

`proxy_world` starts from rules instead: the L7 proxy's redirects of
one server endpoint, with configs 3 and 4's HTTP and Kafka rules and
24 memcached rules written as JSON, identities allocated from labels,
and request templates for all three parsers.

`rules_world` is config 5 from rules, as bench.py's build_config5
builds it: `build_rules`' 50,000 rules through the port's Daemon
(endpoints, identities with their /32s, `policy_add`, one
`regenerate_all`), with bench's one-rule update `add_one_rule`, the
tuples and flow records `rules_tuples` and `rules_records` draw over
it, and `restricting_rule`, the shadow candidate that restricts one of
its L3-only rules.
"""

from __future__ import annotations

import ipaddress
import json
import time
import types
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

import numpy as np

from cilium_tpu_torch.compiler.tables import (
    L4H_WILD_IDX,
    LOCAL_ID_BASE,
    PAD_ID,
    RESERVED_WORLD,
    build_id_table,
    compile_map_states,
    l4_entry_records,
    repack_l4_subword,
    split_hot,
)
from cilium_tpu_torch.ct.device import compile_ct
from cilium_tpu_torch.ct.table import CT_SERVICE, CTMap, CTTuple
from cilium_tpu_torch.engine.datapath import (
    FLOW_COLUMNS,
    DatapathTables,
    pack_flow_records4,
    subword_datapath_tables,
)
from cilium_tpu_torch.ipcache.lpm import (
    build_ipcache,
    specialize_ipcache_to_idx,
)
from cilium_tpu_torch.lb.device import compile_lb
from cilium_tpu_torch.lb.service import L3n4Addr, ServiceManager
from cilium_tpu_torch.maps.policymap import (
    EGRESS,
    INGRESS,
    MapStateArrays,
    PolicyKey,
    PolicyMapStateEntry,
    pack_keys,
)
from cilium_tpu_torch.prefilter import build_prefilter
from cilium_tpu_torch.tunnel import TunnelMap

RESERVED_HOST = 1
HTTP_PORTS = tuple(range(8000, 8016))
KAFKA_PORTS = tuple(range(9090, 9098))
WILD_PORTS = ((53, 17), (9100, 6))  # any identity may reach these
PREFILTER_CIDR = "203.0.113.0/24"
UNKNOWN_RANGE = "10.251.0.0/16"
UNKNOWN_IDENTITY = 200  # never allocated: outside the policy universe
# CIDR identity blocks of a length other than /24 are laid out from
# these bases, one region per length ((first octet, octets spanned));
# /24 blocks are 198.18.0.0/24, 198.18.1.0/24, ... in block order
_CIDR_REGIONS = {8: (20, 44), 12: (64, 6), 16: (70, 2), 20: (72, 2),
                 28: (74, 1)}
# first octets of a drawn blocklist (203 holds PREFILTER_CIDR)
_BLOCK_OCTETS = tuple(o for o in range(200, 224) if o != 203)
BIG_VIP = "172.16.1.1"


def _ip(s: str) -> int:
    return int(ipaddress.ip_address(s))


def _ip_str(v: int) -> str:
    return str(ipaddress.ip_address(int(v)))


@dataclass
class World:
    states: list  # per-endpoint PolicyMapState, endpoint axis order
    identity_ids: List[int]
    ipc_map: Dict[str, int]  # cidr -> identity
    prefilter_cidrs: List[str]
    ct: CTMap
    mgr: ServiceManager
    pool: Dict[str, np.ndarray]
    identity_pad: int = 1024
    filter_pad: int = 64
    meta: dict = field(default_factory=dict)
    # the L7 rules as (rule index, endpoint, port, team), and each
    # team's member identities
    l7_rules: list = field(default_factory=list)
    team_members: list = field(default_factory=list)

    def host_tables(self) -> DatapathTables:
        """The compiled maps in their wide layouts (host numpy), each
        plane in the layout its dispatching builder picks for its size,
        as the agent assembles them (cilium_tpu/daemon.py:2255)."""
        pol = compile_map_states(
            self.states, self.identity_ids, identity_pad=self.identity_pad,
            filter_pad=self.filter_pad,
        )
        return DatapathTables(
            prefilter=build_prefilter(self.prefilter_cidrs),
            ipcache=specialize_ipcache_to_idx(build_ipcache(self.ipc_map), pol),
            ct=compile_ct(self.ct),
            lb=compile_lb(self.mgr),
            policy=pol,
        )

    def pairs(self, seed: int, half: int, k: int,
              zipf: Optional[float] = None) -> List[np.ndarray]:
        """k packed4 pairs [2, 4, half] u32: half 0 samples the pool's
        ingress flows, half 1 its egress flows; uniformly, or
        Zipf-ranked with exponent `zipf` (rank r drawn with weight
        r^-zipf through a random permutation of the rows)."""
        prng = np.random.default_rng(seed)
        pool = self.pool
        subsets = [
            np.nonzero(pool["direction"] == d)[0] for d in (INGRESS, EGRESS)
        ]
        weights = []
        for sub in subsets:
            if zipf is None:
                weights.append(None)
            else:
                w = np.arange(1, len(sub) + 1, dtype=np.float64) ** -zipf
                weights.append((prng.permutation(len(sub)), w / w.sum()))
        out = []
        for _ in range(k):
            pair = np.empty((2, 4, half), np.uint32)
            for row, sub in enumerate(subsets):
                if weights[row] is None:
                    picks = sub[prng.integers(0, len(sub), size=half)]
                else:
                    perm, p = weights[row]
                    picks = sub[perm[prng.choice(len(sub), size=half, p=p)]]
                pair[row] = pack_flow_records4(
                    **{c: pool[c][picks] for c in FLOW_COLUMNS}
                )
            out.append(pair)
        return out


def zipf_picks(prng, n: int, size: int, s: float) -> np.ndarray:
    """Ranked-Zipf sample of `size` rows of n: rank r (1-based) drawn
    with probability r^-s (normalised), ranks mapped through a random
    permutation so the head rows are arbitrary rows (bench.py's
    zipf_picks, draw for draw)."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** -float(s)
    w /= w.sum()
    perm = prng.permutation(n)
    return perm[prng.choice(n, size=size, p=w)]


def zipf_pairs(world: World, prng, half: int, k: int,
               s: float) -> List[np.ndarray]:
    """k packed4 pairs [2, 4, half] u32 whose halves draw the pool's
    ingress and egress rows by zipf_picks(s), a new permutation for
    every half, as bench.py's memo section draws its Zipf pairs."""
    pool = world.pool
    subsets = [np.nonzero(pool["direction"] == d)[0] for d in (INGRESS, EGRESS)]
    out = []
    for _ in range(k):
        pair = np.empty((2, 4, half), np.uint32)
        for row, sub in enumerate(subsets):
            picks = sub[zipf_picks(prng, len(sub), half, s)]
            pair[row] = pack_flow_records4(
                **{c: pool[c][picks] for c in FLOW_COLUMNS})
        out.append(pair)
    return out


def hot_pair(pair: np.ndarray, kinds, share: float, seed: int,
             halves=(0, 1)) -> np.ndarray:
    """A packed4 pair [2, 4, B] whose halves in `halves` each have a
    `share` of their rows (drawn from `seed`) replaced by the half's
    first flow whose lattice match kind counts a hit (L4, L3 or the L4
    wildcard; `kinds` [2, B] the pair's match kinds): one hot flow, one
    hot counter cell a half, as the hottest row of a steep Zipf stream
    gives."""
    rng = np.random.default_rng(seed)
    out = pair.copy()
    for h in halves:
        hot = int(np.nonzero(np.isin(np.asarray(kinds[h]), (1, 2, 3)))[0][0])
        rows = rng.random(pair.shape[2]) < share
        out[h][:, rows] = pair[h][:, hot:hot + 1]
    return out


def hot_tuples(cols: dict, kinds, n: int, seed: int) -> dict:
    """`n` lattice tuples drawn from the tuple columns `cols` so that
    their hits crowd a few counter cells: the first tuple whose match
    kind (`kinds`, the lattice's, one a tuple) is an L4 or wildcard hit
    (else an L3 hit) makes more than half of them, five others (L3 hits,
    then L4 hits, first) three quarters of the rest, random tuples of
    `cols` the remainder, shuffled (drawn from `seed`)."""
    kinds = [int(k) for k in np.asarray(kinds)]
    hot = min(range(len(kinds)),
              key=lambda k: (kinds[k] not in (1, 3), kinds[k] != 2, k))
    rest = sorted((k for k in range(len(kinds)) if k != hot),
                  key=lambda k: (kinds[k] != 2, kinds[k] not in (1, 3), k))
    rng = np.random.default_rng(seed)
    n_hot = n // 2 + n // 16
    few = (n - n_hot) * 3 // 4 // 5
    pick = np.concatenate([
        np.full(n_hot, hot), np.repeat(rest[:5], few),
        rng.integers(0, len(kinds), n - n_hot - 5 * few)])
    pick = rng.permutation(pick)
    return {k: np.asarray(v)[pick] for k, v in cols.items()}


def headline_tables(world: World,
                    wide: Optional[DatapathTables] = None) -> DatapathTables:
    """The config-5 headline layout (host numpy): every sub-word
    transform applied (compact L4, compact CT, packed ipcache planes;
    raises if one does not fit) and the policy's cold plane dropped.
    `wide` reuses tables already built by `world.host_tables()`."""
    sub = subword_datapath_tables(wide or world.host_tables())
    sub.policy = split_hot(sub.policy)
    return sub


def _cidr_blocks(n: int, plens) -> list:
    """(base u32, prefix length) of CIDR block b = 0..n-1: lengths in
    turn from `plens`, /24 blocks at 198.18.0.0 + 256 b, the others
    packed into their length's region."""
    out = []
    for b in range(n):
        plen = int(plens[b % len(plens)])
        if plen == 24:
            out.append((_ip("198.18.0.0") + (b << 8), plen))
            continue
        if plen not in _CIDR_REGIONS:
            raise ValueError(f"no region for /{plen} CIDR blocks")
        octet, span = _CIDR_REGIONS[plen]
        k = b // len(plens)
        if k >= span << (plen - 8):
            raise ValueError(f"too many /{plen} CIDR blocks")
        out.append(((octet << 24) + (k << (32 - plen)), plen))
    return out


def _blocklist(rng: np.random.Generator, n: int) -> List[str]:
    """`n` distinct v4 CIDRs of /16 to /24 under _BLOCK_OCTETS, sorted."""
    out = set()
    while len(out) < n:
        plen = int(rng.integers(16, 25))
        first = int(rng.choice(_BLOCK_OCTETS))
        rest = int(rng.integers(0, 1 << 24)) & ~((1 << (32 - plen)) - 1)
        out.add(f"{_ip_str((first << 24) | rest)}/{plen}")
    return sorted(out)


def make_world(seed: int = 5, n_rules: int = 50_000, n_endpoints: int = 32,
               n_identities: int = 65_536, team_size: int = 16,
               n_cidr_blocks: int = 256, n_vips: int = 16,
               n_pool: int = 50_000, ct_max_entries: int = 65_536,
               identity_pad: int = 1024, filter_pad: int = 64,
               cidr_plens=(24,), n_blocklist: int = 0,
               big_vip_backends: int = 0) -> World:
    """Build the world (see the module docstring); the defaults are
    config 5's scale.  The node-scale options (node_world) keep every
    draw of the main generator and take theirs from a second one, so a
    world without them is config 5's draw for draw: `cidr_plens`, the
    prefix lengths of the CIDR identity blocks in turn; `n_blocklist`
    more prefilter CIDRs (/16 to /24); `big_vip_backends`, one more VIP,
    BIG_VIP:80, with that many backends over the endpoints.  With any
    of them the pool's CIDR-range sources are drawn from every block,
    half its prefiltered sources from the blocklist, and a third of its
    VIP flows go to BIG_VIP."""
    rng = np.random.default_rng(seed)
    extras = (tuple(cidr_plens) != (24,) or n_blocklist > 0
              or big_vip_backends > 0 or n_cidr_blocks > 256)
    rng2 = np.random.default_rng([seed, 7])
    cidr_blocks = _cidr_blocks(n_cidr_blocks, cidr_plens)
    e_count = n_endpoints

    # -- identities and their addresses
    ep_ident = [256 + i for i in range(e_count)]
    n_cluster = n_identities - e_count
    cluster_ident = np.arange(256 + e_count, 256 + e_count + n_cluster)
    n_teams = max(n_identities // team_size, 1)
    cidr_ident = [LOCAL_ID_BASE + b for b in range(n_cidr_blocks + 2)]
    identity_ids = (
        [RESERVED_HOST, RESERVED_WORLD] + ep_ident
        + cluster_ident.tolist() + cidr_ident
    )
    ep_ip = np.array(
        [_ip(f"10.250.{i // 256}.{i % 256}") for i in range(e_count)],
        np.uint32,
    )
    id_ip = (0x0A000000 | (np.arange(n_cluster) + 1)).astype(np.uint32)

    ipc_map: Dict[str, int] = {}
    for i in range(e_count):
        ipc_map[_ip_str(ep_ip[i]) + "/32"] = ep_ident[i]
    for i in range(n_cluster):
        ipc_map[_ip_str(id_ip[i]) + "/32"] = int(cluster_ident[i])
    for b, (base, plen) in enumerate(cidr_blocks):
        ipc_map[f"{_ip_str(base)}/{plen}"] = LOCAL_ID_BASE + b
    ipc_map["198.18.0.0/16"] = LOCAL_ID_BASE + n_cidr_blocks
    ipc_map["100.64.0.0/10"] = LOCAL_ID_BASE + n_cidr_blocks + 1
    ipc_map[UNKNOWN_RANGE] = UNKNOWN_IDENTITY

    # -- policy rules (bench.py build_rules' mix), lowered to map states
    team_members = [cluster_ident[t::n_teams].tolist() for t in range(n_teams)]
    reserved_ports = set(HTTP_PORTS) | set(KAFKA_PORTS) | {
        p for p, _ in WILD_PORTS
    }
    cand = np.array(
        [p for p in range(1000, 30000) if p not in reserved_ports]
    )
    plain_ports = rng.choice(cand, size=224, replace=False)
    l7_ports = HTTP_PORTS + KAFKA_PORTS

    def proxy_of(e: int, port: int) -> int:
        return 10000 + e * len(l7_ports) + l7_ports.index(port)

    states = [dict() for _ in range(e_count)]
    l7_pairs = []  # (rule index, endpoint, port, team) of L7 rules
    kinds = rng.random(n_rules)
    teams = rng.integers(0, n_teams, size=n_rules)
    port_pick = rng.integers(0, len(plain_ports), size=n_rules)
    udp = rng.random(n_rules) >= 0.7
    blocks = rng.integers(0, n_cidr_blocks, size=n_rules)
    http_pick = rng.integers(0, len(HTTP_PORTS), size=n_rules)
    kafka_pick = rng.integers(0, len(KAFKA_PORTS), size=n_rules)
    plain = PolicyMapStateEntry()
    for i in range(n_rules):
        e = i % e_count
        st = states[e]
        kind = kinds[i]
        members = team_members[int(teams[i])]
        if kind < 0.84:
            port = int(plain_ports[port_pick[i]])
            proto = 17 if udp[i] else 6
            for m in members:
                st[PolicyKey(m, port, proto, INGRESS)] = plain
        elif kind < 0.92:
            for m in members:
                st[PolicyKey(m, 0, 0, INGRESS)] = plain
        elif kind < 0.96:
            st[PolicyKey(LOCAL_ID_BASE + int(blocks[i]), 0, 0, INGRESS)] = plain
        else:
            port = (
                HTTP_PORTS[int(http_pick[i])] if kind < 0.99
                else KAFKA_PORTS[int(kafka_pick[i])]
            )
            entry = PolicyMapStateEntry(proxy_port=proxy_of(e, port))
            for m in members:
                st[PolicyKey(m, port, 6, INGRESS)] = entry
            l7_pairs.append((i, e, port, int(teams[i])))
    for e in range(e_count):
        st = states[e]
        st[PolicyKey(RESERVED_HOST, 0, 0, INGRESS)] = plain
        for port, proto in WILD_PORTS:
            st[PolicyKey(0, port, proto, INGRESS)] = plain
        # no rule selects egress: every identity is allowed out at L3
        st.update(
            {PolicyKey(num, 0, 0, EGRESS): plain for num in identity_ids}
        )

    # -- services: VIPs onto endpoint backends
    mgr = ServiceManager()
    vips = []
    backends_of = []
    for i in range(n_vips):
        vip = f"172.16.0.{i + 1}"
        picks = rng.choice(e_count, size=min(2, e_count), replace=False)
        backends = [
            L3n4Addr(_ip_str(ep_ip[int(b)]), int(plain_ports[i]), 6)
            for b in picks
        ]
        mgr.upsert(L3n4Addr(vip, 80, 6), backends)
        vips.append(_ip(vip))
        backends_of.append(backends)
    if big_vip_backends:
        perm = rng2.permutation(e_count)
        mgr.upsert(L3n4Addr(BIG_VIP, 80, 6), [
            L3n4Addr(_ip_str(ep_ip[int(perm[j % e_count])]),
                     8080 + j // e_count, 6)
            for j in range(big_vip_backends)
        ])
    blocklist = _blocklist(rng2, n_blocklist)

    # -- the flow pool (bench.py make_flow_pool's shares)
    n = n_pool
    pick_ep = rng.integers(0, e_count, size=n)
    direction = (rng.random(n) < 0.5).astype(np.uint8)
    peer = id_ip[rng.integers(0, n_cluster, size=n)]
    r = rng.random(n)
    peer = np.where(r < 0.02, _ip("203.0.113.0") + rng.integers(0, 256, n), peer)
    peer = np.where(
        (r >= 0.02) & (r < 0.05), _ip("8.8.0.0") + rng.integers(0, 1 << 16, n),
        peer,
    )
    peer = np.where(
        (r >= 0.05) & (r < 0.07),
        _ip("198.18.0.0") + rng.integers(0, 1 << 16, n), peer,
    )
    peer = np.where(
        (r >= 0.07) & (r < 0.075),
        _ip("100.64.0.0") + rng.integers(0, 1 << 22, n), peer,
    )
    peer = np.where(
        (r >= 0.075) & (r < 0.08),
        _ip("10.251.0.0") + rng.integers(0, 1 << 16, n), peer,
    ).astype(np.uint32)
    if extras:
        # CIDR-range sources from every block, of every length
        rows = np.nonzero((r >= 0.05) & (r < 0.07))[0]
        blk = rng2.integers(0, n_cidr_blocks, size=len(rows))
        base = np.array([b for b, _ in cidr_blocks], np.int64)[blk]
        span = 1 << (32 - np.array([p for _, p in cidr_blocks], np.int64)[blk])
        peer[rows] = (base + rng2.integers(0, span)).astype(np.uint32)
        if blocklist:
            # half the prefiltered sources from the blocklist
            rows = np.nonzero(r < 0.02)[0]
            rows = rows[rng2.random(len(rows)) < 0.5]
            nets = [ipaddress.ip_network(c) for c in blocklist]
            pick = rng2.integers(0, len(nets), size=len(rows))
            off = rng2.integers(0, 1 << 8, size=len(rows))
            peer[rows] = [int(nets[k].network_address) + int(o)
                          % nets[k].num_addresses for k, o in zip(pick, off)]
    to_vip = (direction == EGRESS) & (rng.random(n) < 0.10)
    vip_idx = rng.integers(0, len(vips), size=n)
    vip_arr = np.asarray(vips, np.uint32)
    saddr = np.where(direction == INGRESS, peer, ep_ip[pick_ep])
    daddr = np.where(
        direction == INGRESS, ep_ip[pick_ep],
        np.where(to_vip, vip_arr[vip_idx], peer),
    )
    if big_vip_backends:
        daddr[to_vip & (rng2.random(n) < 1 / 3)] = _ip(BIG_VIP)
    all_ports = (
        [(int(p), 6) for p in plain_ports] + [(int(p), 17) for p in plain_ports]
        + [(p, 6) for p in l7_ports] + list(WILD_PORTS)
    )
    ports = np.asarray([p for p, _ in all_ports], np.int64)
    protos = np.asarray([pr for _, pr in all_ports], np.int64)
    pick_port = rng.integers(0, len(ports), size=n)
    # 3 % DNS / metrics-scrape flows on the wildcard ports
    wild = np.nonzero(rng.random(n) < 0.03)[0]
    pick_port[wild] = len(ports) - len(WILD_PORTS) + rng.integers(
        0, len(WILD_PORTS), size=len(wild)
    )
    junk = rng.random(n) < 0.10
    dport = np.where(junk, rng.integers(30000, 65536, size=n), ports[pick_port])
    dport = np.where(to_vip, 80, dport)
    proto = np.where(junk | to_vip, 6, protos[pick_port])
    sport = rng.integers(1024, 65536, size=n)
    frag = rng.random(n) < 0.02
    ep_index = pick_ep.astype(np.int64)
    # proxy-bound L7 clients, overlaid last: an allowed team member
    # hitting the rule's port at the rule's endpoint
    if l7_pairs:
        rows = np.nonzero(rng.random(n) < 0.025)[0]
        rules = rng.integers(0, len(l7_pairs), size=len(rows))
        for row, ri in zip(rows, rules):
            _, e, port, team = l7_pairs[int(ri)]
            members = team_members[team]
            m = members[int(rng.integers(0, len(members)))]
            direction[row] = INGRESS
            ep_index[row] = e
            saddr[row] = id_ip[m - int(cluster_ident[0])]
            daddr[row] = ep_ip[e]
            dport[row] = port
            proto[row] = 6
            frag[row] = False
            to_vip[row] = False
    pool = {
        "ep_index": ep_index,
        "saddr": saddr.astype(np.uint32),
        "daddr": daddr.astype(np.uint32),
        "sport": sport.astype(np.int64),
        "dport": dport.astype(np.int64),
        "proto": proto.astype(np.int64),
        "direction": direction.astype(np.int64),
        "is_fragment": frag,
    }

    # -- conntrack seeded from the pool
    ct = CTMap(max_entries=ct_max_entries)
    u = rng.random(n)
    for row in range(n):
        d = int(pool["direction"][row])
        tup = CTTuple(
            int(pool["daddr"][row]), int(pool["saddr"][row]),
            int(pool["dport"][row]), int(pool["sport"][row]),
            int(pool["proto"][row]),
        )
        if to_vip[row]:
            if u[row] < 0.5:
                # a live service flow: the service-scope entry names
                # its backend, the DNATed flow entry lives beside it
                svc = mgr.lookup(L3n4Addr(_ip_str(tup.daddr), 80, 6))
                slave = int(rng.integers(1, len(svc.backends) + 1))
                be = svc.backends[slave - 1].addr
                ct.create_best_effort(
                    tup, CT_SERVICE, rev_nat_index=svc.id, slave=slave
                )
                ct.create_best_effort(
                    CTTuple(be.ip_u32(), tup.saddr, be.port, tup.sport, 6),
                    EGRESS, rev_nat_index=svc.id, slave=slave,
                    orig_daddr=tup.daddr, orig_dport=80,
                )
        elif u[row] < 0.30:
            ct.create_best_effort(tup, d)  # forward: ESTABLISHED
        elif u[row] < 0.40:
            # the other side opened it: this flow's probe sees REPLY
            ct.create_best_effort(
                CTTuple(tup.saddr, tup.daddr, tup.sport, tup.dport,
                        tup.nexthdr),
                1 - d,
            )
    return World(
        states=states,
        identity_ids=identity_ids,
        ipc_map=ipc_map,
        prefilter_cidrs=[PREFILTER_CIDR] + blocklist,
        ct=ct,
        mgr=mgr,
        pool=pool,
        identity_pad=identity_pad,
        filter_pad=filter_pad,
        meta={
            "rules": n_rules, "endpoints": e_count,
            "identities": n_identities, "teams": n_teams,
            "l7_rules": len(l7_pairs), "ct_entries": len(ct.entries),
            "pool": n_pool,
        },
        l7_rules=l7_pairs,
        team_members=team_members,
    )


# -- node-scale worlds -------------------------------------------------------------

NODE_ENDPOINTS = 110  # the kubelet's default --max-pods
NODE_BLOCKLIST = 1024  # prefilter CIDRs, the size of a public DROP list
NODE_BIG_VIP_BACKENDS = 64  # the classic LB's per-service limit
NODE_CIDR_PLENS = (8, 12, 16, 20, 24, 28)
NODE_LPM_CIDRS = 4096  # /24 CIDR identities: past the ipcache's 512 ranges


def node_world(lpm: bool = False, seed: int = 5, **kw) -> World:
    """A node-scale world: config 5's rule mix, identities and teams
    (seed 5, 50,000 rules, 65,536 identities in teams of 16) on a node
    of NODE_ENDPOINTS endpoints, with a prefilter of NODE_BLOCKLIST
    CIDRs (203.0.113.0/24 and 1,023 drawn /16 to /24), config 5's 16
    VIPs and BIG_VIP with NODE_BIG_VIP_BACKENDS backends, and 256 CIDR
    identity blocks over NODE_CIDR_PLENS (with config 5's /16, /10 and
    unknown /16: 259 ranges over 8 lengths).  Each table takes the
    layout the agent's builders pick past their thresholds: the idx
    ipcache without L3 planes (more than 32 endpoints) and with the
    [B, P] range scan (more than 4 lengths), the DIR-24-8 prefilter
    (more than 128 CIDRs), the classic LB (more than 40 backends).
    `lpm` is the `node_lpm` deployment: NODE_LPM_CIDRS /24 CIDR
    identities instead of the 256 blocks, so the ipcache holds more
    than 512 ranges and is DIR-24-8 itself.  `kw` overrides
    make_world's arguments (the tests' small nodes)."""
    args = dict(n_endpoints=NODE_ENDPOINTS, n_blocklist=NODE_BLOCKLIST - 1,
                big_vip_backends=NODE_BIG_VIP_BACKENDS,
                cidr_plens=NODE_CIDR_PLENS)
    if lpm:
        args.update(n_cidr_blocks=NODE_LPM_CIDRS, cidr_plens=(24,))
    args.update(kw)
    return make_world(seed=seed, **args)


# -- the L7 side ---------------------------------------------------------------


def l7_fleet(world: World, policy) -> "FleetL7":
    """Config 5's fleet L7 matchers (bench.py build_rules' L7 rules):
    per L7 rule i at (endpoint e, port), one spec in the scope
    (e, INGRESS, slot of the port) that admits the team's members by
    lattice index (the pair step's sec_id); HTTP rules match GET on
    /api/v{i % 4}/[a-z]+, Kafka rules topic{i % 32} with any api key.
    `policy` is the host PolicyTables of `world.host_tables()` (its
    cold `port_slot` plane gives the slots)."""
    from cilium_tpu_torch.compiler.tables import NO_SLOT
    from cilium_tpu_torch.l7.fleet import (
        PARSER_HTTP_ID,
        PARSER_KAFKA_ID,
        compile_fleet_from_specs,
    )
    from cilium_tpu_torch.l7.http import HTTPRuleSpec
    from cilium_tpu_torch.l7.kafka import KafkaRuleSpec

    if policy.port_slot is None:
        raise ValueError("l7_fleet needs the policy's port_slot plane")
    e_count, _, kg = policy.l4_meta.shape
    id_table = np.asarray(policy.id_table)
    parser_kind = np.zeros((e_count, 2, kg), np.uint8)
    http_specs, kafka_specs = [], []
    for i, e, port, team in world.l7_rules:
        j = int(policy.port_slot[6, port])
        if j == int(NO_SLOT):
            raise ValueError(f"L7 port {port} has no L4 slot")
        scope = (e, INGRESS, j)
        idx = np.searchsorted(id_table, world.team_members[team]).tolist()
        if port in HTTP_PORTS:
            parser_kind[scope] = PARSER_HTTP_ID
            http_specs.append(HTTPRuleSpec(
                identity_indices=idx, method="GET",
                path=f"/api/v{i % 4}/[a-z]+", scope_key=scope,
            ))
        else:
            parser_kind[scope] = PARSER_KAFKA_ID
            kafka_specs.append(KafkaRuleSpec(
                identity_indices=idx, topic=f"topic{i % 32}",
                scope_key=scope,
            ))
    return compile_fleet_from_specs(
        http_specs, kafka_specs, parser_kind, len(id_table)
    )


def l7_payloads(world: World, fleet, seed: int = 23):
    """Per pool row, the first request of its connection (bench.py
    build_l7_payloads): HTTP fields for rows aimed at ports 8000-8015,
    Kafka fields for ports 9090-9097, empty requests elsewhere.
    Returns (requests, kafka requests, HTTP fields (m, ml, p, pl, h, hl)
    padded and trimmed, Kafka fields in pad_kafka_requests' order), all
    numpy and aligned with the pool's rows."""
    from cilium_tpu_torch.l7.http import pad_requests, trim_packed
    from cilium_tpu_torch.l7.kafka import KafkaRequest, pad_kafka_requests

    rng = np.random.default_rng(seed)
    dport = world.pool["dport"]
    n = len(dport)
    reqs = []
    for i in range(n):
        p = int(dport[i])
        if 8000 <= p < 8016:
            k = int(rng.integers(0, 5))
            path = (
                f"/api/v{p % 4}/items",
                f"/api/v{(p + 1) % 4}/items",
                "/api/v9/nope",
                "/health",
                f"/api/v{p % 4}/x{i % 97}",
            )[k]
            method = "GET" if k != 3 else "POST"
            reqs.append((method.encode(), path.encode(), b""))
        else:
            reqs.append((b"", b"", b""))
    m, ml, p_, pl, h, hl, overflow = pad_requests(reqs)
    if overflow.any():
        raise ValueError("an L7 payload exceeds its field budget")
    m, p_, h = trim_packed(m, ml), trim_packed(p_, pl), trim_packed(h, hl)
    kreqs = []
    for i in range(n):
        if 9090 <= int(dport[i]) < 9098:
            kreqs.append(KafkaRequest(
                kind=0, version=0, client_id=f"client{i % 4}",
                topics=(f"topic{int(rng.integers(0, 48))}",), parsed=True,
            ))
        else:
            kreqs.append(KafkaRequest(kind=0, version=0, client_id="",
                                      topics=(), parsed=True))
    kf = pad_kafka_requests(fleet.kafka, kreqs)
    return reqs, kreqs, (m, ml, p_, pl, h, hl), tuple(np.asarray(x) for x in kf)


@dataclass
class RequestWorld:
    """A batch of L7 requests against one rule set (configs 3 and 4):
    the specs, the compiled policy, the 256 request templates, the
    per-request template pick, identity index and known flag, the
    request fields gathered by pick, and 256 rows for the host
    oracle."""

    specs: list
    policy: object  # HTTPPolicy or KafkaTables
    templates: list
    pick: np.ndarray
    ident: np.ndarray
    known: np.ndarray
    fields: tuple
    sample: np.ndarray


def http_request_world(n: int = 1 << 20, seed: int = 13) -> RequestWorld:
    """Config 3 (bench.py config3): 24 HTTP rules over 1,024 identities,
    256 request templates, `n` requests."""
    from cilium_tpu_torch.l7.http import (
        HTTPRuleSpec,
        compile_http_rules,
        pad_requests,
        trim_packed,
    )

    rng = np.random.default_rng(seed)
    n_ident = 1024
    specs = []
    for i in range(24):
        specs.append(HTTPRuleSpec(
            identity_indices=list(rng.integers(0, n_ident, size=64)),
            method="GET|POST" if i % 3 else "GET",
            path=f"/api/v{i % 4}/[a-z]+(/[0-9]+)?",
            host="" if i % 2 else r"svc[0-9]+\.cluster\.local",
        ))
    policy = compile_http_rules(specs, n_ident)
    templates = []
    for i in range(256):
        method = rng.choice(["GET", "POST", "PUT", "DELETE"])
        path = rng.choice([
            f"/api/v{i % 4}/users/{i}",
            f"/api/v{i % 4}/items",
            "/health",
            "/api/v9/nope",
            f"/api/v{i % 4}/x" + "y" * int(rng.integers(0, 40)),
        ])
        host = rng.choice([f"svc{i % 8}.cluster.local", "evil.example.com",
                           ""])
        templates.append((method.encode(), path.encode(), host.encode()))
    tm, tml, tp, tpl, th, thl, _ = pad_requests(templates)
    tm, tp, th = trim_packed(tm, tml), trim_packed(tp, tpl), trim_packed(th, thl)
    pick = rng.integers(0, len(templates), size=n)
    ident = rng.integers(0, n_ident, size=n).astype(np.int32)
    sample = rng.integers(0, n, size=256)
    return RequestWorld(
        specs=specs, policy=policy, templates=templates, pick=pick,
        ident=ident, known=np.ones(n, dtype=bool),
        fields=tuple(a[pick] for a in (tm, tml, tp, tpl, th, thl)),
        sample=sample,
    )


def kafka_request_world(n: int = 1 << 20, seed: int = 17) -> RequestWorld:
    """Config 4 (bench.py config4): 24 Kafka rules over 1,024
    identities, 256 request templates, `n` requests."""
    from cilium_tpu_torch.l7.kafka import (
        KafkaRequest,
        KafkaRuleSpec,
        compile_kafka_rules,
        pad_kafka_requests,
    )

    rng = np.random.default_rng(seed)
    n_ident = 1024
    specs = []
    for i in range(24):
        specs.append(KafkaRuleSpec(
            identity_indices=frozenset(
                int(x) for x in rng.integers(0, n_ident, size=64)
            ),
            api_keys=(0,) if i % 2 else (1, 2, 3),
            topic=f"topic{i % 16}" if i % 3 else "",
        ))
    tables = compile_kafka_rules(specs, n_ident)
    templates = []
    for i in range(256):
        kind = int(rng.choice([0, 1, 2, 3, 8, 9]))
        count = int(rng.integers(0, 3))
        topics = [f"topic{int(t)}" for t in rng.integers(0, 24, size=count)]
        templates.append(KafkaRequest(
            kind=kind, version=0, client_id=f"client{i % 4}",
            topics=tuple(topics), parsed=True,
        ))
    packed = pad_kafka_requests(tables, templates)
    pick = rng.integers(0, len(templates), size=n)
    ident = rng.integers(0, n_ident, size=n).astype(np.int32)
    sample = rng.integers(0, n, size=256)
    return RequestWorld(
        specs=specs, policy=tables, templates=templates, pick=pick,
        ident=ident, known=np.ones(n, dtype=bool),
        fields=tuple(np.asarray(a)[pick] for a in packed),
        sample=sample,
    )


# -- the bare policy lattice ------------------------------------------------------

FRAG_SHARE = 0.02  # fragments among lattice_records (the pool's share)


@dataclass
class LatticeWorld:
    """Map states over one identity universe for the bare lattice
    (configs 1 and 2): `tuples` is config 1's batch; `ipc_map` and
    `rng` drive config 2's CIDR batches."""

    states: list
    identity_ids: List[int]
    identity_pad: int = 1024
    filter_pad: int = 64
    tuples: Optional[dict] = None
    ipc_map: Dict[str, int] = field(default_factory=dict)
    rng: Optional[np.random.Generator] = None

    def policy_tables(self):
        """The compiled PolicyTables (host numpy, hashed and dense
        leaves both)."""
        return compile_map_states(
            self.states, self.identity_ids, identity_pad=self.identity_pad,
            filter_pad=self.filter_pad,
        )

    def make_cidr_batch(self, count: int):
        """Config 2's tuple distribution (bench.py config2's
        make_cidr_batch, drawn from the world's generator): source
        addresses uniform over 10.0.0.0/8 and tuple columns for endpoint
        0, ingress, TCP to 443 or 80.  Returns (addrs u32, columns)."""
        rng = self.rng
        addrs = (0x0A000000 | rng.integers(0, 1 << 24, size=count)).astype(
            np.uint32)
        return addrs, dict(
            ep_index=np.zeros(count, np.int32),
            identity=np.zeros(count, np.uint32),
            dport=rng.choice([443, 80], size=count),
            proto=np.full(count, 6),
            direction=np.zeros(count, np.int64),
        )


def example_world(n_identities: int = 64, batch: int = 1024) -> LatticeWorld:
    """Config 1 (__graft_entry__._build_example, bench.py config1): one
    endpoint (app=server) whose ingress admits app=client (identity 256)
    on TCP 80 and app=peer (257) at L3, written as the map state the
    policy repository computes for it; 64 identities (256, 257, then
    300 on); identity_pad 64, filter_pad 8; `batch` tuples drawn with
    seed 0."""
    ids = [256, 257] + [300 + i for i in range(n_identities - 2)]
    state = {
        PolicyKey(256, 80, 6, INGRESS): PolicyMapStateEntry(),
        PolicyKey(257, 0, 0, INGRESS): PolicyMapStateEntry(),
    }
    rng = np.random.default_rng(0)
    arr = np.asarray(ids, dtype=np.uint32)
    tuples = dict(
        ep_index=np.zeros(batch, np.int32),
        identity=rng.choice(arr, size=batch),
        dport=rng.choice([80, 443], size=batch),
        proto=np.full(batch, 6),
        direction=np.zeros(batch, np.int64),
    )
    return LatticeWorld(states=[state], identity_ids=ids, identity_pad=64,
                        filter_pad=8, tuples=tuples)


def cidr_world(n16: int = 64, n24: int = 4096, n32: int = 16384,
               seed: int = 11) -> LatticeWorld:
    """Config 2 (bench.py config2): /16s, /24s and /32s over 10.0.0.0/8
    (20,544 prefixes at the defaults), each with its own local CIDR
    identity; one endpoint admitting every second identity on TCP 443
    and every fifth at L3, on ingress.  The generator behind
    make_cidr_batch is seeded with `seed`."""
    base_local = LOCAL_ID_BASE
    mapping: Dict[str, int] = {}
    ids: List[int] = []

    def add(cidr):
        mapping[cidr] = base_local + len(ids)
        ids.append(base_local + len(ids))

    for i in range(n16):
        add(f"10.{i}.0.0/16")
    for i in range(n24):
        add(f"10.{64 + i // 256}.{i % 256}.0/24")
    for i in range(n32):
        a, b = 128 + i // 8192, (i // 32) % 256
        add(f"10.{a}.{b}.{i % 32 * 8}/32")
    state = {}
    for num_id in ids[::2]:
        state[PolicyKey(num_id, 443, 6, INGRESS)] = PolicyMapStateEntry()
    for num_id in ids[::5]:
        state[PolicyKey(num_id, 0, 0, INGRESS)] = PolicyMapStateEntry()
    return LatticeWorld(states=[state], identity_ids=ids, identity_pad=1024,
                        ipc_map=mapping, rng=np.random.default_rng(seed))


def map_state_arrays(states) -> list:
    """Each map state as MapStateArrays, the form the daemon's endpoints
    hold and FleetCompiler lowers with array operations.  Built from
    the key columns (MapStateArrays.build) rather than from_dict's
    per-entry sort; equal to it for states whose counters are 0."""
    out = []
    for st in states:
        if isinstance(st, MapStateArrays):
            out.append(st)
            continue
        n = len(st)
        col = lambda f: np.fromiter((f(k) for k in st), np.int64, n)
        keys = pack_keys(col(lambda k: k.identity), col(lambda k: k.dest_port),
                         col(lambda k: k.nexthdr),
                         col(lambda k: k.traffic_direction))
        proxy = np.fromiter((v.proxy_port for v in st.values()), np.int64, n)
        out.append(MapStateArrays.build(keys, proxy))
    return out


def one_rule_states(w: World, port: int, team: int = 0, endpoint: int = 0,
                    states=None, remove: bool = False) -> list:
    """bench.py's churn unit `add_one_rule` (team t0 -> app0 on one TCP
    port) at map-state level: a copy of `states` (default w.states) in
    which endpoint `endpoint`'s ingress state gains PolicyKey(m, port,
    6, INGRESS) for every identity m of team `team` (bench's world
    names endpoint i app{i}), or with `remove` loses those keys.  Only
    that endpoint's state is a new object, of the same kind (dict or
    MapStateArrays); the caller bumps its state token."""
    states = list(w.states if states is None else states)
    members = [int(m) for m in w.team_members[team]]
    st = states[endpoint]
    if isinstance(st, MapStateArrays):
        keys = pack_keys(members, port, 6, INGRESS)
        if remove:
            keep = ~np.isin(st.keys_packed, keys)
            new = MapStateArrays(st.keys_packed[keep], st.proxy[keep],
                                 st.packets[keep], st.bytes[keep])
        else:
            new = MapStateArrays.build(
                np.concatenate([st.keys_packed, keys]),
                np.concatenate([st.proxy, np.zeros(len(keys), np.uint32)]))
    else:
        new = dict(st)
        for m in members:
            key = PolicyKey(m, port, 6, INGRESS)
            if remove:
                new.pop(key, None)
            else:
                new[key] = PolicyMapStateEntry()
    states[endpoint] = new
    return states


def lattice_tuples(w: World, n: int, seed: int = 1) -> dict:
    """bench.py's lattice line over config 5: endpoints, identities
    (256 on), dports in [1, 65535), TCP or UDP and directions uniform;
    tuple columns as numpy arrays."""
    rng = np.random.default_rng(seed)
    return dict(
        ep_index=rng.integers(0, w.meta["endpoints"], size=n),
        identity=rng.integers(256, 256 + w.meta["identities"],
                              size=n).astype(np.uint32),
        dport=rng.integers(1, 65535, size=n),
        proto=rng.choice([6, 17], size=n),
        direction=rng.integers(0, 2, size=n),
    )


# the stash world's hashed L4 rows: two wide entries (6 lanes), two
# compact ones (4 lanes)
STASH_LANES = {"wide": 6, "compact": 4}


def stash_world(seed: int = 1):
    """A small world of config 5's rule mix (400 rules, 16 endpoints,
    512 identities) whose policy compiles into hashed L4 rows of two
    entries (STASH_LANES), so that entries overflow into both stashes
    (the rows double only until the overflow fits the 64-row stash):
    (world, {"wide": PolicyTables, "compact": PolicyTables}), host numpy,
    the wide tables with their dense leaves too."""
    w = make_world(seed=seed, n_rules=400, n_endpoints=16,
                   n_identities=512, n_cidr_blocks=16, n_vips=4,
                   n_pool=3000, ct_max_entries=4096, identity_pad=256,
                   filter_pad=16)
    wide = compile_map_states(w.states, w.identity_ids,
                              identity_pad=w.identity_pad,
                              filter_pad=w.filter_pad,
                              hash_lanes=STASH_LANES["wide"])
    return w, {"wide": wide, "compact": repack_l4_subword(
        wide, lanes=STASH_LANES["compact"])}


def identity_addresses(identity_ids, identities):
    """Addresses for the lattice's IP mode: each of `identity_ids` at a
    /32 of 11.0.0.0/8, in order ({cidr: identity}, for build_lpm), and
    the source address u32 [B] of each of `identities` (12.0.0.1, which
    the map misses, for one not in it)."""
    at = {int(ident): 0x0B000000 + k for k, ident in enumerate(identity_ids)}
    cidrs = {f"{a >> 24}.{(a >> 16) & 255}.{(a >> 8) & 255}.{a & 255}/32":
             ident for ident, a in at.items()}
    return cidrs, np.asarray([at.get(int(i), 0x0C000001)
                              for i in identities], np.uint32)


def stash_tuples(policy, seed: int) -> dict:
    """One tuple a used entry of both hashed L4 stashes of the host
    PolicyTables `policy` (either entry layout), exact stash first: the
    entry's endpoint, direction, dport and proto, and the identity of its
    index (for a wildcard entry one of the table's identities drawn from
    `seed`); tuple columns as numpy arrays, no fragments.  With rows
    narrow enough that entries overflow, they probe the stashes."""
    rng = np.random.default_rng(seed)
    recs = l4_entry_records(replace(
        policy, l4_hash_rows=np.asarray(policy.l4_hash_rows)[:0],
        l4_wild_rows=np.asarray(policy.l4_wild_rows)[:0]))
    ids = np.asarray(policy.id_table)
    parts = []
    for r in (recs["exact"], recs["wild"]):
        idx = r["idx"].astype(np.int64)
        idx = np.where(idx == int(L4H_WILD_IDX),
                       rng.integers(0, len(ids), len(idx)),
                       np.minimum(idx, len(ids) - 1))
        parts.append(dict(ep_index=r["ep"].astype(np.int64),
                          identity=ids[idx].astype(np.uint32),
                          dport=r["dport"].astype(np.int64),
                          proto=r["proto"].astype(np.int64),
                          direction=r["d"].astype(np.int64)))
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    out["is_fragment"] = np.zeros(len(out["dport"]), np.int64)
    return out


def lattice_records(w: World, n: int, seed: int = 31) -> bytes:
    """`n` flow records drawn uniformly from the world's flow pool: each
    carries its row's endpoint (as the record's ep_id), addresses,
    ports, proto and direction, the identity of its remote peer (the
    source on ingress, the destination on egress) as the plain
    lpm_lookup over build_lpm(w.ipc_map) resolves it (0 where it
    misses), and a fragment flag drawn with share FRAG_SHARE."""
    from cilium_tpu_torch.convert import lpm_to
    from cilium_tpu_torch.ipcache.lpm import build_lpm, lpm_lookup
    from cilium_tpu_torch.native.loader import encode_flow_records

    pool = w.pool
    peer = np.where(pool["direction"] == INGRESS, pool["saddr"],
                    pool["daddr"]).astype(np.uint32)
    lpm = lpm_to(build_lpm(w.ipc_map), "cpu")
    peer_id = lpm_lookup(lpm, peer, device="cpu").numpy().view(np.uint32)
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, len(peer), size=n)
    return encode_flow_records(
        ep_id=pool["ep_index"][picks], identity=peer_id[picks],
        saddr=pool["saddr"][picks], daddr=pool["daddr"][picks],
        sport=pool["sport"][picks], dport=pool["dport"][picks],
        proto=pool["proto"][picks], direction=pool["direction"][picks],
        is_fragment=rng.random(n) < FRAG_SHARE,
    )


def pool_records(w: World, rows) -> bytes:
    """The flow pool's `rows` as flow records (identity 0: the fused
    replay derives it on the device), as bench.py's encode_pool_sample
    writes them."""
    from cilium_tpu_torch.native.loader import encode_flow_records

    rows = np.asarray(rows)
    pool = w.pool
    return encode_flow_records(
        ep_id=pool["ep_index"][rows], identity=np.zeros(len(rows), np.uint32),
        **{c: pool[c][rows] for c in FLOW_COLUMNS if c != "ep_index"},
    )


def oracle_context(w: World) -> dict:
    """The host maps hostpath.composed_oracle reads: the prefilter and
    the ipcache as host LPMs, the CT map and the service manager."""
    from cilium_tpu_torch.engine.hostpath import HostLPM

    return {
        "prefilter": HostLPM({c: 1 for c in w.prefilter_cidrs}),
        "ipcache": HostLPM(w.ipc_map),
        "ct": w.ct,
        "mgr": w.mgr,
    }


# -- overlay mode ------------------------------------------------------------------

TUNNEL_NODES = 256


def tunnel_map(n_nodes: int = TUNNEL_NODES) -> TunnelMap:
    """The overlay of `n_nodes` remote nodes, both families in one map:
    node k has the node IP 192.168.k.1 (the v4 underlay), the v4 pod
    CIDR 10.251.k.0/24 (over config 5's UNKNOWN_RANGE) and the v6 pod
    CIDR of config 6's address i = 16 k, 2001:db8:{i >> 8}:{i & 0xFF}::/64
    (a 16th of config 6's addresses live on remote nodes)."""
    tm = TunnelMap()
    for k in range(n_nodes):
        node_ip = f"192.168.{k}.1"
        i = 16 * k
        tm.set_tunnel_endpoint(f"10.251.{k}.0/24", node_ip)
        tm.set_tunnel_endpoint(f"2001:db8:{i >> 8:x}:{i & 0xFF:x}::/64",
                               node_ip)
    return tm


# -- config 6: the fused IPv6 datapath ------------------------------------------

CONFIG6_VIP = "fd00:77::1"


@dataclass
class World6:
    """bench.py's config 6 at the map-state level: one endpoint's
    policy state over the identities, the v6 ipcache, the prefilter,
    the VIP with its backends, and the flows (FlowBatch6.from_numpy's
    numpy columns); `sample` are bench's 256 composed-oracle rows."""

    states: list
    identity_ids: List[int]
    ipc_map: Dict[str, int]
    prefilter_cidrs: List[str]
    mgr: ServiceManager
    addrs: List[str]
    flows: Dict[str, np.ndarray]
    sample: np.ndarray
    identity_pad: int = 1024

    def host_tables(self, ct: Optional[CTMap] = None,
                    tunnel: Optional[TunnelMap] = None):
        """The compiled v6 tables (host numpy): CT6 from `ct` (an empty
        map by default), the tunnel map's v6 half when one is given."""
        from cilium_tpu_torch.engine.datapath6 import (
            Datapath6Tables,
            build_prefilter6,
            compile_ct6,
        )
        from cilium_tpu_torch.ipcache.lpm6 import build_ipcache6
        from cilium_tpu_torch.lb.device6 import compile_lb6

        return Datapath6Tables(
            prefilter=build_prefilter6(self.prefilter_cidrs),
            ipcache=build_ipcache6(self.ipc_map),
            ct=compile_ct6(CTMap() if ct is None else ct),
            policy=compile_map_states(self.states, self.identity_ids,
                                      identity_pad=self.identity_pad),
            tunnel=None if tunnel is None else tunnel.tables6(),
            lb=compile_lb6(self.mgr),
        )


def config6_world(n: int, seed: int = 29) -> World6:
    """bench.py config 6 (`config6`), draw for draw from one Generator
    seeded by `seed`: 4,096 identities from 4096, one /128 each under
    2001:db8::/32 plus fd00::/8 for the first; 64 ports from
    [1000, 30000); ingress L4 rules for every second identity, ingress
    L3 for every fifth, egress TCP 8443 for every third; the VIP
    fd00:77::1 port 443 onto the first 4 addresses at 8443; the
    prefilter 2600:1::/32; `n` flows from endpoint 0, TCP, 10 % to the
    VIP (egress), the rest half egress; then the 256 oracle rows."""
    from cilium_tpu_torch.ipcache.lpm6 import ip6_limbs

    rng = np.random.default_rng(seed)
    base_id, n_ident = 4096, 4096
    ids = list(range(base_id, base_id + n_ident))
    ipc_map: Dict[str, int] = {}
    addrs = []
    for i, num_id in enumerate(ids):
        a = f"2001:db8:{i >> 8:x}:{i & 0xFF:x}::{(i % 9) + 1:x}"
        ipc_map[f"{a}/128"] = num_id
        addrs.append(a)
    ipc_map["fd00::/8"] = ids[0]

    state = {}
    ports = rng.choice(np.arange(1000, 30000), size=64, replace=False)
    plain = PolicyMapStateEntry()
    for num_id in ids[::2]:
        p = int(ports[num_id % len(ports)])
        state[PolicyKey(num_id, p, 6, INGRESS)] = plain
    for num_id in ids[::5]:
        state[PolicyKey(num_id, 0, 0, INGRESS)] = plain
    for num_id in ids[::3]:
        state[PolicyKey(num_id, 8443, 6, EGRESS)] = plain

    mgr = ServiceManager()
    mgr.upsert(L3n4Addr(CONFIG6_VIP, 443, 6),
               [L3n4Addr(b, 8443, 6) for b in addrs[:4]])

    limbs = np.array([ip6_limbs(a) for a in addrs], np.uint32)
    pick = rng.integers(0, len(addrs), size=n)
    saddr = limbs[pick]
    to_vip = rng.random(n) < 0.1
    dpick = rng.integers(0, len(addrs), size=n)
    daddr = limbs[dpick]
    daddr[to_vip] = ip6_limbs(CONFIG6_VIP)
    direction = (rng.random(n) < 0.5).astype(np.int64)
    direction[to_vip] = 1
    dport = rng.choice(ports, size=n).astype(np.int64)
    dport[to_vip] = 443
    flows = dict(
        ep_index=np.zeros(n, np.int32), saddr=saddr, daddr=daddr,
        sport=rng.integers(1024, 60000, size=n), dport=dport,
        proto=np.full(n, 6), direction=direction,
    )
    sample = rng.integers(0, n, size=256)
    return World6(
        states=[state], identity_ids=ids, ipc_map=ipc_map,
        prefilter_cidrs=["2600:1::/32"], mgr=mgr, addrs=addrs, flows=flows,
        sample=sample,
    )


def config6_ct_pass(flows: Dict[str, np.ndarray], out, count: int):
    """Config 6's conntrack variant, from a first pass `out`
    (Datapath6Verdicts, any device) over the first `count` rows of
    `flows`: those rows are written back into a fresh CTMap with
    apply_ct_writeback6.  Returns (the map, the second pass's flows):
    the same rows, then their reverses (post-DNAT destination as the
    source, ports swapped, direction flipped), which take ESTABLISHED,
    REPLY and service-stickiness hits once CT6 is compiled from the
    map."""
    from cilium_tpu_torch.engine.datapath6 import (
        FlowBatch6,
        apply_ct_writeback6,
    )

    head = {k: np.asarray(v)[:count] for k, v in flows.items()}
    ct = CTMap()
    apply_ct_writeback6(ct, out, FlowBatch6.from_numpy(**head, device="cpu"))
    fdaddr = out.final_daddr.cpu().numpy().view(np.uint32)
    rev = dict(
        ep_index=head["ep_index"], saddr=fdaddr, daddr=head["saddr"],
        sport=out.final_dport.cpu().numpy(), dport=head["sport"],
        proto=head["proto"], direction=1 - np.asarray(head["direction"]),
    )
    second = {
        k: np.concatenate([head[k], np.asarray(rev[k]).astype(head[k].dtype)])
        for k in head
    }
    return ct, second



# -- config 6's edges: the stashes in use, duplicate and near-miss keys ---------

V6_EDGE_TUNNEL = {
    "2001:db8::/32": "192.168.9.1",
    "2001:db8::/48": "192.168.3.1",
    "2001:db8:0:7::/64": "192.168.200.1",
    "2001:db8:0:8::/64": "192.168.2.1",
    "2001:db8:0:7:1::/80": "192.168.150.1",
    "2001:db8:0:8::5/128": "192.168.250.1",
}
V6_EDGE_RANGES = {"2001:db8:77::/48": 4100, "2001:db8:77:1::/64": 4101,
                  "ffff::/16": 4102}
V6_EDGE_CROWD = 30  # /128s in one ipcache6 row: 25 fit, the rest stashed
V6_EDGE_CT = 150  # CT6 entries over 16 rows of 11: the rest stashed
V6_ONES = "ffff:ffff:ffff:ffff:ffff:ffff:ffff:ffff"


@dataclass
class World6Edges:
    """config6_world's maps widened to the v6 tables' edges (v6_edge_world):
    `tables` the compiled host tables (numpy) after the edits, `probes`
    the addresses the edits concern by name, `flows` FlowBatch6's numpy
    columns."""

    w: World6
    ct: CTMap
    tunnel: TunnelMap
    tables: object  # Datapath6Tables
    probes: Dict[str, str]
    flows: Dict[str, np.ndarray]


def _empty_lanes6(row, per: int, planes: int, empty) -> List[int]:
    return [e for e in range(per)
            if all(row[k * per + e] == empty[k] for k in range(planes))]


def v6_edge_world(n: int = 2048, seed: int = 41) -> World6Edges:
    """config6_world(256, seed)'s maps with the v6 tables' edges, from one
    Generator seeded by `seed`:
      * ipcache6: V6_EDGE_CROWD more /128s that hash into one bucket row,
        so its stash holds some; a row-resident key copied into the stash
        with another value (found in both, summed); a key copied into an
        empty lane of its own row with another value (a duplicate in one
        row); two entries in a probed address's row that equal it in limb
        1 and differ in limb 3 or limb 0 (near misses); an all-ones stash
        row with value 7 (which the all-ones address alone sums);
        V6_EDGE_RANGES, the /48 again with another value (a tie of best
        length) and a /64 inside it;
      * CT6: V6_EDGE_CT entries in 16 rows (the rest in the stash), one row
        entry copied into the stash and one into an empty lane of its row
        with other values, one near miss (the same ports word, another
        limb 1);
      * the tunnel map V6_EDGE_TUNNEL: nested ranges with other endpoints
        (/32, /48, /64, /80, /128);
    and `n` flows over those addresses, the world's, the all-ones one, the
    prefilter's and the VIP, every direction word, ports and protocols
    past their fields, a tenth egress to the VIP's service, a third
    replaying a CT entry forward or reversed."""
    from cilium_tpu_torch.engine.datapath6 import (
        CT6_ENTRY_WORDS,
        CT6_PER_BUCKET,
        compile_ct6,
    )
    from cilium_tpu_torch.engine.hashtable import _fnv1a_host
    from cilium_tpu_torch.ipcache.lpm6 import V6_ENTRIES_PER_BUCKET, ip6_limbs

    rng = np.random.default_rng(seed)
    w = config6_world(256, seed=seed)
    ids = w.identity_ids
    # V6_EDGE_CROWD addresses that share one row of the ipcache6's buckets
    nb = 16
    while nb * 8 < len(w.ipc_map) + V6_EDGE_CROWD:
        nb *= 2
    cand = np.zeros((4 * nb * V6_EDGE_CROWD, 4), np.uint32)
    cand[:, 0], cand[:, 1] = 0x20010DB8, 0x000E0000  # 2001:db8:e::k
    cand[:, 3] = np.arange(1, len(cand) + 1)
    rows = _fnv1a_host(cand) & (nb - 1)
    crowd = [str(ipaddress.IPv6Address(0x20010DB8000E0000 << 64 | int(k)))
             for k in cand[rows == rows[0], 3][:V6_EDGE_CROWD]]
    ipc_map = dict(w.ipc_map)
    for k, a in enumerate(crowd):
        ipc_map[f"{a}/128"] = ids[k]
    ipc_map.update(V6_EDGE_RANGES)
    w = replace(w, ipc_map=ipc_map)
    tm = TunnelMap()
    for prefix, node in V6_EDGE_TUNNEL.items():
        tm.set_tunnel_endpoint(prefix, node)

    # CT6: entries between the world's addresses, forward, as the datapath
    # creates them (ingress, egress, service scope)
    ct = CTMap(max_entries=V6_EDGE_CT)
    ct_rows = []
    for _ in range(V6_EDGE_CT):
        s_, d_ = (w.addrs[int(i)] for i in rng.integers(0, 64, 2))
        sp, dp = (int(x) for x in rng.integers(1024, 60000, 2))
        direction = int(rng.integers(0, 3))
        ct.create(CTTuple(int(ipaddress.IPv6Address(d_)),
                          int(ipaddress.IPv6Address(s_)), dp, sp, 6),
                  direction, rev_nat_index=int(rng.integers(0, 3)),
                  slave=int(rng.integers(0, 3)))
        ct_rows.append((s_, d_, sp, dp, direction))
    ct.max_entries = 32  # compile_ct6 sizes the rows by it: 16 rows
    host = w.host_tables(ct=ct, tunnel=tm)

    # -- the ipcache6 edits
    ipc = host.ipcache
    buckets, stash = np.array(ipc.buckets), np.array(ipc.stash)
    per = V6_ENTRIES_PER_BUCKET
    ones = np.uint32(0xFFFFFFFF)
    used = int((stash[:, :4] != ones).any(axis=1).sum())
    if not 0 < used < len(stash) - 2:
        raise AssertionError(f"the ipcache6 stash holds {used} rows")
    probes = {"crowd_stashed": crowd[-1], "crowd_row": crowd[0]}
    lim = {a: np.array(ip6_limbs(a), np.uint32) for a in w.addrs[:64]}

    def row_of(a):
        return int(_fnv1a_host(lim[a][None])[0]) & (nb - 1)

    free = {a: _empty_lanes6(buckets[row_of(a)], per, 4, [ones] * 4)
            for a in w.addrs[:64]}
    roomy = [a for a in w.addrs[:64] if len(free[a]) >= 3]
    both, dup, near = roomy[0], roomy[1], roomy[2]
    stash[used] = (*lim[both], 7777)  # in its row and in the stash
    r, e = row_of(dup), free[dup][0]  # twice in its row
    for k in range(4):
        buckets[r, k * per + e] = lim[dup][k]
    buckets[r, 4 * per + e] = 8888
    r = row_of(near)  # limb 1 equal, limb 3 or limb 0 not
    for e, flip in zip(free[near][:2], (3, 0)):
        limbs = lim[near].copy()
        limbs[flip] ^= 1
        for k in range(4):
            buckets[r, k * per + e] = limbs[k]
        buckets[r, 4 * per + e] = 9999
    stash[used + 1, 4] = 7  # an all-ones row with a value
    # the /48 once more with another value: a tie of best length
    base, mask = np.array(ipc.range_base), np.array(ipc.range_mask)
    plen, value = np.array(ipc.range_plen), np.array(ipc.range_value)
    src = int(np.nonzero(plen == 49)[0][0])
    pad = int(np.nonzero(plen == 0)[0][0])
    base[pad], mask[pad], plen[pad], value[pad] = (base[src], mask[src], 49,
                                                   4103)
    host.ipcache = replace(ipc, buckets=buckets, stash=stash, range_base=base,
                           range_mask=mask, range_plen=plen,
                           range_value=value)
    probes.update(both=both, dup=dup, near=near, ones=V6_ONES)

    # -- the CT6 edits
    snap = host.ct
    cb = np.array(snap.buckets)
    cs = np.concatenate([np.array(snap.stash),
                         compile_ct6(CTMap()).stash[:1]])
    cper = CT6_PER_BUCKET
    ct_used = int((cs[:, 9] != ones).sum())
    if not 0 < ct_used < len(cs):
        raise AssertionError(f"the CT6 stash holds {ct_used} entries")
    lanes = [(r, e) for r in range(len(cb)) for e in range(cper)
             if cb[r, 9 * cper + e] != ones]
    holes = {r: [e for e in range(cper) if cb[r, 9 * cper + e] == ones]
             for r in range(len(cb))}
    r, e = lanes[0]
    cs[ct_used] = cb[r, np.arange(CT6_ENTRY_WORDS) * cper + e]
    cs[ct_used, 10] ^= 0x00010001  # in its row and in the stash
    r = next(r for r in range(len(cb)) if holes[r] and len(holes[r]) < cper)
    e = next(e for e in range(cper) if cb[r, 9 * cper + e] != ones)
    h = holes[r][0]
    for k in range(CT6_ENTRY_WORDS):  # twice in its row
        cb[r, k * cper + h] = cb[r, k * cper + e]
    cb[r, 10 * cper + h] ^= 0x00020002
    if len(holes[r]) > 1:  # the same ports word, another limb 1
        h2 = holes[r][1]
        for k in range(CT6_ENTRY_WORDS):
            cb[r, k * cper + h2] = cb[r, k * cper + e]
        cb[r, 1 * cper + h2] ^= 1
    host.ct = replace(snap, buckets=cb, stash=cs)

    # -- the flows
    pool = (w.addrs[:64] + crowd + [both, dup, near, V6_ONES,
            "2001:db8:77::5", "2001:db8:77:1::9", "2001:db8:0:7::3",
            "2001:db8:0:7:1::4", "2001:db8:0:8::5", "2600:1::9",
            CONFIG6_VIP, "fd00::1", "::", "ffff::1"])
    pick = rng.integers(0, len(pool), size=(2, n))
    flows = dict(
        ep_index=rng.choice([0, 0, 0, 1, -1], size=n),
        saddr=np.array([ip6_limbs(pool[i]) for i in pick[0]], np.uint32),
        daddr=np.array([ip6_limbs(pool[i]) for i in pick[1]], np.uint32),
        sport=rng.choice([1024, 5000, 65536 + 7, -2], size=n),
        dport=rng.choice([53, 443, 8443, 65535, 70000, -5], size=n),
        proto=rng.choice([6, 6, 17, 256 + 6, -1], size=n),
        direction=rng.choice([0, 1, 2, -1], size=n),
        is_fragment=rng.random(n) < 0.05,
    )
    vip = rng.random(n) < 0.1  # egress TCP to the VIP's port
    flows["daddr"][vip] = ip6_limbs(CONFIG6_VIP)
    flows["dport"][vip], flows["proto"][vip] = 443, 6
    flows["direction"][vip] = 1
    for i in np.nonzero(rng.random(n) < 0.33)[0]:
        s_, d_, sp, dp, direction = ct_rows[int(rng.integers(len(ct_rows)))]
        if direction < 2 and rng.random() < 0.5:
            s_, d_, sp, dp, direction = d_, s_, dp, sp, 1 - direction
        flows["saddr"][i] = ip6_limbs(s_)
        flows["daddr"][i] = ip6_limbs(d_)
        flows["sport"][i], flows["dport"][i] = sp, dp
        flows["proto"][i], flows["direction"][i] = 6, direction
    return World6Edges(w=w, ct=ct, tunnel=tm, tables=host, probes=probes,
                       flows=flows)



def v6_unstaged(tables, rows: int = 2048):
    """Host v6 tables (numpy) with every broadcast list and stash padded to
    `rows` rows of entries that match nothing or only what the tables'
    own empties match (ranges with base limb 0 = 1 and mask 0, all-ones
    ipcache6 stash rows of value 0, CT6 stash entries whose proto|flags
    word is 0xFFFFFFFF): the same lookups, tables too large for DATAPATH6
    to stage, which it then reads where they lie."""
    from cilium_tpu_torch.engine.datapath6 import Prefilter6

    def pad(a, fill):
        a = np.asarray(a)
        extra = np.empty((rows - len(a),) + a.shape[1:], a.dtype)
        extra[...] = fill
        return np.concatenate([a, extra])

    never = np.array([1, 0, 0, 0], np.uint32)
    ones = np.uint32(0xFFFFFFFF)
    ipc, ct = tables.ipcache, tables.ct
    ct_empty = np.zeros(ct.stash.shape[1], np.uint32)
    ct_empty[9] = ones
    out = replace(
        tables,
        prefilter=Prefilter6(base=pad(tables.prefilter.base, never),
                             mask=pad(tables.prefilter.mask, 0)),
        ipcache=replace(ipc, stash=pad(ipc.stash, [ones] * 4 + [0]),
                        range_base=pad(ipc.range_base, never),
                        range_mask=pad(ipc.range_mask, 0),
                        range_plen=pad(ipc.range_plen, 0),
                        range_value=pad(ipc.range_value, 0)),
        ct=replace(ct, stash=pad(ct.stash, ct_empty)))
    if tables.tunnel is not None:
        tun = tables.tunnel
        out.tunnel = replace(tun, base=pad(tun.base, never),
                             mask=pad(tun.mask, 0),
                             endpoint=pad(tun.endpoint, 0))
    return out


# -- the L7 proxy from rules ---------------------------------------------------

PROXY_TEAMS = 64
PROXY_RULES = 24  # rules per parser, as in configs 3 and 4
MEMCACHE_OPS = ("get", "set", "readGroup", "delete", "writeGroup", "getk",
                "add", "increment")
PROXY_UNKNOWN_SHARE = 0.01


@dataclass
class ProxyWorld:
    """One server endpoint's L7 policy from rules (`rules_json`, for
    rules_from_json), over identities allocated from labels
    (`identity_labels`, in allocation order), with request templates
    for the three parsers and, per parser, each request's template
    pick, identity index and known flag (`draws[parser] = (pick,
    ident, known)`), drawn over a universe of `n_universe` indices."""

    rules_json: str
    identity_labels: List[List[str]]
    server_labels: tuple
    http_templates: list  # (method, path, host) bytes
    kafka_templates: list  # (kind, version, client_id, topics, parsed)
    memcache_wire: bytes  # the memcached templates as request frames
    draws: Dict[str, tuple]
    n_universe: int


def _rule(team, port: int, rules, name: str, egress: bool = False):
    """One rule of the server: `team` (an int, or a list of ints as a
    matchExpressions In) on TCP `port`, with L7 `rules` or none."""
    if isinstance(team, int):
        peer = {"matchLabels": {"k8s:team": f"t{team}"}}
    else:
        peer = {"matchExpressions": [{"key": "k8s:team", "operator": "In",
                                      "values": [f"t{t}" for t in team]}]}
    block = {"toPorts": [{"ports": [{"port": str(port), "protocol": "TCP"}]}]}
    if rules is not None:
        block["toPorts"][0]["rules"] = rules
    if egress:
        block["toEndpoints"] = [peer]
    else:
        block["fromEndpoints"] = [peer]
    return {
        "endpointSelector": {"matchLabels": {"k8s:app": "server"}},
        "egress" if egress else "ingress": [block],
        "labels": [f"k8s:policy={name}"],
    }


def memcache_rule(i: int, n_rules: int) -> dict:
    """Memcached rule i of n: an OPCODE_MAP name or group, and two
    thirds keyExact, a sixth keyPrefix, then keyRegex, then no key."""
    n_exact, n_prefix = (2 * n_rules) // 3, n_rules // 6
    n_regex = max((n_rules - n_exact - n_prefix) // 2, 1)
    rule = {"opCode": MEMCACHE_OPS[i % len(MEMCACHE_OPS)]}
    if i < n_exact:
        rule["keyExact"] = f"key{i}"
    elif i < n_exact + n_prefix:
        rule["keyPrefix"] = f"pre{i}"
    elif i < n_exact + n_prefix + n_regex:
        rule["keyRegex"] = f"^rx{i}[0-9]+$"
    return rule


def proxy_rules() -> list:
    """The JSON rules: PROXY_RULES each of HTTP on TCP/80 (config 3's
    methods, paths and hosts), Kafka on TCP/9092 (config 4's API keys
    and topics) and memcached on TCP/11211 (OPCODE_MAP names and groups;
    two thirds keyExact, then keyPrefix, keyRegex, no key), each
    allowing one team; on 11211 also an entry with an empty `l7` list
    and an L4-only rule (the wildcard pass makes it an L7 allow-all);
    and one egress HTTP rule on TCP/8080 to every fourth team."""
    n_rules = PROXY_RULES
    out = []
    for i in range(n_rules):
        out.append(_rule(i % PROXY_TEAMS, 80, {"http": [{
            "method": "GET|POST" if i % 3 else "GET",
            "path": f"/api/v{i % 4}/[a-z]+(/[0-9]+)?",
            "host": "" if i % 2 else r"svc[0-9]+\.cluster\.local",
        }]}, f"http-{i}"))
    for i in range(n_rules):
        topic = {"topic": f"topic{i % 16}"} if i % 3 else {}
        keys = ["produce"] if i % 2 else ["fetch", "offsets", "metadata"]
        out.append(_rule((n_rules + i) % PROXY_TEAMS, 9092, {"kafka": [
            {"apiKey": k, **topic} for k in keys]}, f"kafka-{i}"))
    for i in range(n_rules):
        out.append(_rule((2 * n_rules + i) % PROXY_TEAMS, 11211, {
            "l7proto": "binarymemcache", "l7": [memcache_rule(i, n_rules)]},
            f"memcache-{i}"))
    out.append(_rule(PROXY_TEAMS - 2, 11211, {
        "l7proto": "binarymemcache", "l7": []}, "memcache-empty"))
    out.append(_rule(PROXY_TEAMS - 1, 11211, None, "memcache-l4"))
    out.append(_rule(list(range(0, PROXY_TEAMS, 4)), 8080, {"http": [{
        "method": "GET|PUT", "path": "/(api|out)/.*"}]}, "http-egress",
        egress=True))
    return out


def _memcache_frames(rng, count: int = 256) -> bytes:
    """`count` request frames, each aimed at rule i % (PROXY_RULES + 2):
    three times in four with one of the rule's opcodes (else any of
    the rules' opcodes, quit, noop or 255), four times in five with a
    key the rule's matcher takes (else another key)."""
    from cilium_tpu_torch.l7.memcached import OPCODE_MAP, encode_request

    ops = sorted({op for name in MEMCACHE_OPS for op in OPCODE_MAP[name]})
    ops += [7, 10, 255]  # quit, noop and an opcode no rule names
    frames = []
    for i in range(count):
        j = i % (PROXY_RULES + 2)
        rule = (memcache_rule(j, PROXY_RULES) if j < PROXY_RULES
                else {"opCode": "get"})
        own = OPCODE_MAP[rule["opCode"]]
        op = (own[int(rng.integers(0, len(own)))] if rng.random() < 0.75
              else int(rng.choice(ops)))
        if rng.random() < 0.2:
            key = f"other{i % 7}"
        elif "keyExact" in rule:
            key = rule["keyExact"]
        elif "keyPrefix" in rule:
            key = f"{rule['keyPrefix']}x{i}"
        elif "keyRegex" in rule:
            key = f"rx{j}{i}"
        else:
            key = f"free{i}"
        extras = b"\0" * 4 if i % 5 == 0 else b""
        frames.append(encode_request(op, key, extras, b"v" * int(i % 3)))
    return b"".join(frames)


def proxy_world(n_identities: int = 1024, n_requests: int = 1 << 20,
                seed: int = 19) -> ProxyWorld:
    """The proxy's world at configs 3 and 4's widths by default:
    `n_identities` identities labelled `k8s:team=t{i % 64}`,
    `k8s:svc=s{i}`, the rules of `proxy_rules`, 256 templates per
    parser (config 3's HTTP draws, config 4's Kafka draws, memcached
    frames from encode_request) and `n_requests` requests per parser,
    their identity indices drawn over the universe (the allocated
    identities and the 5 reserved ones), 1 % unknown."""
    rng = np.random.default_rng(seed)
    identity_labels = [[f"k8s:team=t{i % PROXY_TEAMS}", f"k8s:svc=s{i}"]
                       for i in range(n_identities)]
    n_universe = n_identities + 5  # the reserved identities 1-5
    http = []
    for i in range(256):
        method = rng.choice(["GET", "POST", "PUT", "DELETE"])
        path = rng.choice([
            f"/api/v{i % 4}/users/{i}", f"/api/v{i % 4}/items", "/health",
            "/api/v9/nope", f"/api/v{i % 4}/x" + "y" * int(rng.integers(0, 40)),
            "/out/" + "z" * int(rng.integers(0, 200)),
        ])
        host = rng.choice([f"svc{i % 8}.cluster.local", "evil.example.com", ""])
        http.append((method.encode(), path.encode(), host.encode()))
    kafka = []
    for i in range(256):
        count = int(rng.integers(0, 3)) if i % 64 else 10  # some overflow
        kafka.append((
            int(rng.choice([0, 1, 2, 3, 8, 9])), 0, f"client{i % 4}",
            tuple(f"topic{int(t)}" for t in rng.integers(0, 24, size=count)),
            bool(i % 16),
        ))
    wire = _memcache_frames(rng)
    draws = {}
    for parser in ("http", "kafka", "memcache"):
        pick = rng.integers(0, 256, size=n_requests)
        ident = rng.integers(0, n_universe, size=n_requests).astype(np.int32)
        known = rng.random(n_requests) >= PROXY_UNKNOWN_SHARE
        draws[parser] = (pick, ident, known)
    return ProxyWorld(
        rules_json=json.dumps(proxy_rules()),
        identity_labels=identity_labels, server_labels=("k8s:app=server",),
        http_templates=http, kafka_templates=kafka, memcache_wire=wire,
        draws=draws, n_universe=n_universe,
    )


PROXY_ENDPOINT_ID = 4242
# the universe's padding: build_id_table's row count for the proxy world
PROXY_IDENTITY_PAD = 1024


def proxy_setup(pw: ProxyWorld, device=None, wait_group=None):
    """The world's rules through the port's control plane onto a Proxy
    on `device`: rules_from_json, sanitize, Repository.add_list,
    identities from the labels (IdentityAllocator), the universe index
    from build_id_table (FleetCompiler's), resolve_l4_policy for the
    server's labels, and update_endpoint_redirects for an endpoint
    object carrying `id`, `desired_l4_policy` and
    `realized_redirects`.  Returns a namespace with the repository,
    allocator, id_table, id_index, policy, endpoint, proxy, the
    redirects by parser ("http", "kafka", "memcache", "http_egress") and
    the wall seconds of each step (`seconds`: rules, identities,
    resolve, redirects; with a `wait_group`, redirects includes the
    wait for the asynchronous compiles)."""
    from cilium_tpu_torch.compiler.mapstate import resolve_l4_policy
    from cilium_tpu_torch.identity import IdentityAllocator
    from cilium_tpu_torch.labels import LabelArray, Labels
    from cilium_tpu_torch.policy.api import rules_from_json
    from cilium_tpu_torch.policy.repository import Repository
    from cilium_tpu_torch.proxy import Proxy

    seconds = {}
    t = time.perf_counter()
    rules = rules_from_json(pw.rules_json)
    for r in rules:
        r.sanitize()
    repo = Repository()
    repo.add_list(rules)
    seconds["rules"] = time.perf_counter() - t
    t = time.perf_counter()
    alloc = IdentityAllocator()
    for labels in pw.identity_labels:
        alloc.allocate(Labels.from_model(labels))
    cache = alloc.identity_cache()
    id_table = build_id_table(list(cache), PROXY_IDENTITY_PAD)
    id_index = {int(v): i for i, v in enumerate(id_table) if v != PAD_ID}
    seconds["identities"] = time.perf_counter() - t
    t = time.perf_counter()
    policy = resolve_l4_policy(repo, LabelArray.parse(*pw.server_labels))
    endpoint = types.SimpleNamespace(
        id=PROXY_ENDPOINT_ID, desired_l4_policy=policy, realized_redirects={}
    )
    seconds["resolve"] = time.perf_counter() - t
    t = time.perf_counter()
    proxy = Proxy(device=device)
    proxy.update_endpoint_redirects(endpoint, cache, id_index, len(id_table),
                                    wait_group=wait_group)
    if wait_group is not None and not wait_group.wait(timeout=600):
        raise RuntimeError("a redirect compile failed or timed out")
    seconds["redirects"] = time.perf_counter() - t
    redirects = {
        "http": proxy.redirect_for(PROXY_ENDPOINT_ID, True, "TCP", 80),
        "kafka": proxy.redirect_for(PROXY_ENDPOINT_ID, True, "TCP", 9092),
        "memcache": proxy.redirect_for(PROXY_ENDPOINT_ID, True, "TCP", 11211),
        "http_egress": proxy.redirect_for(PROXY_ENDPOINT_ID, False, "TCP",
                                          8080),
    }
    return types.SimpleNamespace(
        repo=repo, allocator=alloc, cache=cache, id_table=id_table,
        id_index=id_index, policy=policy, endpoint=endpoint, proxy=proxy,
        redirects=redirects, seconds=seconds,
    )


def proxy_requests(pw: ProxyWorld, parser: str):
    """The request list of `parser` (templates by pick; memcached frames
    decoded once with decode_stream), its identity indices and known
    flags."""
    pick, ident, known = pw.draws[parser]
    if parser == "memcache":
        from cilium_tpu_torch.l7.memcached import decode_stream

        templates, _ = decode_stream(pw.memcache_wire)
    elif parser == "kafka":
        from cilium_tpu_torch.l7.kafka import KafkaRequest

        templates = [KafkaRequest(kind=k, version=v, client_id=c, topics=t,
                                  parsed=p)
                     for k, v, c, t, p in pw.kafka_templates]
    else:
        templates = pw.http_templates
    return [templates[i] for i in pick.tolist()], ident, known


# -- config 5 from rules ---------------------------------------------------------


def build_rules(rng, n_rules: int, n_endpoints: int, n_teams: int):
    """bench.py's build_rules: a mixed policy of `n_rules` rules, plain
    L4 (84 %), L3-only (8 %), CIDR /24 (4 %), HTTP L7 (3 %) and Kafka
    L7 (1 %); every rule selects one app (endpoint) and allows one team
    (identity group).  Returns (rules, all_ports, l7_pairs): the
    (port, proto) universe of the rules and the (endpoint index, port,
    team index) of each L7 rule."""
    from cilium_tpu_torch.labels import LabelArray
    from cilium_tpu_torch.policy.api import (
        CIDRRule,
        EndpointSelector,
        IngressRule,
        L7Rules,
        PortProtocol,
        PortRule,
        PortRuleHTTP,
        PortRuleKafka,
        Rule,
    )

    def es(key, value):
        return EndpointSelector(match_labels={f"k8s.{key}": value})

    plain_ports = rng.choice(np.arange(1000, 30000), size=224, replace=False)
    http_ports = list(HTTP_PORTS)
    kafka_ports = list(KAFKA_PORTS)

    rules = []
    l7_pairs = []
    for i in range(n_rules):
        app = f"app{i % n_endpoints}"
        team_idx = int(rng.integers(0, n_teams))
        team = f"t{team_idx}"
        kind = rng.random()
        sel = es("app", app)
        src = es("team", team)
        if kind < 0.84:
            port = int(plain_ports[int(rng.integers(0, len(plain_ports)))])
            proto = "TCP" if rng.random() < 0.7 else "UDP"
            ingress = IngressRule(
                from_endpoints=[src],
                to_ports=[PortRule(
                    ports=[PortProtocol(port=str(port), protocol=proto)])],
            )
        elif kind < 0.92:
            ingress = IngressRule(from_endpoints=[src])  # L3-only
        elif kind < 0.96:
            block = int(rng.integers(0, 256))
            ingress = IngressRule(
                from_cidr_set=[CIDRRule(cidr=f"198.18.{block}.0/24")])
        elif kind < 0.99:
            port = http_ports[int(rng.integers(0, len(http_ports)))]
            l7_pairs.append((i % n_endpoints, port, team_idx))
            ingress = IngressRule(
                from_endpoints=[src],
                to_ports=[PortRule(
                    ports=[PortProtocol(port=str(port), protocol="TCP")],
                    rules=L7Rules(http=[PortRuleHTTP(
                        method="GET", path=f"/api/v{i % 4}/[a-z]+")]),
                )],
            )
        else:
            port = kafka_ports[int(rng.integers(0, len(kafka_ports)))]
            l7_pairs.append((i % n_endpoints, port, team_idx))
            ingress = IngressRule(
                from_endpoints=[src],
                to_ports=[PortRule(
                    ports=[PortProtocol(port=str(port), protocol="TCP")],
                    rules=L7Rules(kafka=[PortRuleKafka(
                        topic=f"topic{i % 32}")]),
                )],
            )
        rules.append(Rule(endpoint_selector=sel, ingress=[ingress],
                          labels=LabelArray.parse(f"bench-rule-{i}")))
    all_ports = (
        [(int(p), 6) for p in plain_ports]
        + [(int(p), 17) for p in plain_ports]
        + [(p, 6) for p in http_ports]
        + [(p, 6) for p in kafka_ports]
    )
    return rules, all_ports, l7_pairs


def add_one_rule(d, port: int, app: str = "app0", team: str = "t0",
                 label_prefix: str = "bench-incr") -> None:
    """bench.py's add_one_rule, the one-rule churn unit: allow `team`
    -> `app` on one TCP port, through `d.policy_add`."""
    from cilium_tpu_torch.labels import LabelArray
    from cilium_tpu_torch.policy.api import (
        EndpointSelector,
        IngressRule,
        PortProtocol,
        PortRule,
        Rule,
    )

    d.policy_add([Rule(
        endpoint_selector=EndpointSelector(match_labels={"k8s.app": app}),
        ingress=[IngressRule(
            from_endpoints=[EndpointSelector(match_labels={"k8s.team": team})],
            to_ports=[PortRule(
                ports=[PortProtocol(port=str(port), protocol="TCP")])],
        )],
        labels=LabelArray.parse(f"{label_prefix}-{port}"),
    )])


def rules_world(seed: int = 5, n_rules: int = 50_000, n_endpoints: int = 32,
                n_identities: int = 65_536, device=None):
    """Config 5 from rules (bench.py's build_config5 up to the published
    tables), through the port's Daemon on `device` (None = the card):
    one endpoint per app (10.250.x.y, labels app=app{i}), then
    `n_identities - n_endpoints` cluster identities in teams of
    `n_identities // 16` (labels team, svc), each with a /32 in the
    ipcache from 10.0.0.1 on, then `build_rules` through `policy_add`
    and one explicit `regenerate_all`.  Returns a namespace: the daemon,
    the published version, host tables, index and map states, the
    identity /32s (`id_ips`, u32) and ids, the endpoint addresses
    (`ep_ip`, id -> u32), `all_ports`, `l7_pairs`, `n_teams`, `rules`,
    and bench's `timings` (identity_setup_s, policy_add_s,
    regenerate_s)."""
    from cilium_tpu_torch.daemon import Daemon
    from cilium_tpu_torch.ipcache.ipcache import IPIdentity
    from cilium_tpu_torch.labels import Label, Labels

    rng = np.random.default_rng(seed)
    timings = {}
    d = Daemon(num_workers=8, device=device)  # bench.py's builder pool

    t0 = time.perf_counter()
    ep_ip = {}
    for i in range(n_endpoints):
        ip = f"10.250.{i // 256}.{i % 256}"
        ep_ip[100 + i] = _ip(ip)
        d.create_endpoint(100 + i,
                          Labels({"app": Label("app", f"app{i}", "k8s")}),
                          ipv4=ip, name=f"ep{i}")
    n_teams = max(n_identities // 16, 1)
    id_ips, ids = [], []
    for i in range(n_identities - n_endpoints):
        labels = Labels({
            "team": Label("team", f"t{i % n_teams}", "k8s"),
            "svc": Label("svc", f"s{i}", "k8s"),
        })
        ident, _ = d.identity_allocator.allocate(labels)
        ip = 0x0A000000 | (i + 1)  # 10.0.0.0/8, dense
        id_ips.append(ip)
        ids.append(ident.id)
        d.ipcache.upsert(_ip_str(ip), IPIdentity(ident.id, "kvstore"))
    timings["identity_setup_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rules, all_ports, l7_pairs = build_rules(rng, n_rules, n_endpoints,
                                             n_teams)
    d.policy_add(rules)
    timings["policy_add_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    d.regenerate_all("bench import")
    timings["regenerate_s"] = time.perf_counter() - t0

    version, tables, index, states = (
        d.endpoint_manager.published_with_states())
    return types.SimpleNamespace(
        daemon=d, version=version, tables=tables, index=index,
        states=states, id_ips=np.asarray(id_ips, np.uint32),
        ids=np.asarray(ids, np.int64), ep_ip=ep_ip, all_ports=all_ports,
        l7_pairs=l7_pairs, n_teams=n_teams, rules=rules, timings=timings,
    )


RULE_SHARE = 0.25  # rules_tuples' rows drawn from a rule's own shape


def rules_tuples(rw, n: int, seed: int = 1) -> dict:
    """`n` lattice tuples over a rules_world, as numpy columns: endpoint
    axis indices, identities of the published universe (its id_table),
    the rules' (port, proto) pairs, directions and 2 % fragments, all
    uniform; then a RULE_SHARE of rows takes a drawn rule's own shape
    (its endpoint, a member of its team, its port, or a drawn port for
    an L3-only rule; ingress, no fragment), so that allows, redirects
    and rule changes show.  CIDR rules keep the uniform row."""
    from cilium_tpu_torch.compiler.tables import PAD_ID

    rng = np.random.default_rng(seed)
    id_table = np.asarray(rw.tables.id_table).view(np.uint32)
    universe = id_table[id_table != np.uint32(PAD_ID)]
    ports = np.asarray(rw.all_ports, np.int64)
    axis = np.asarray(sorted(rw.index.values()), np.int64)
    pick = rng.integers(0, len(ports), size=n)
    cols = dict(
        ep_index=axis[rng.integers(0, len(axis), size=n)],
        identity=universe[rng.integers(0, len(universe), size=n)],
        dport=ports[pick, 0],
        proto=ports[pick, 1],
        direction=rng.integers(0, 2, size=n),
        is_fragment=rng.random(n) < FRAG_SHARE,
    )
    # each rule's shape: endpoint axis index, team (-1 for a CIDR
    # rule), port and proto (0 for an L3-only rule)
    shape = np.zeros((len(rw.rules), 4), np.int64)
    for r, rule in enumerate(rw.rules):
        ing = rule.ingress[0]
        app = rule.endpoint_selector.match_labels["k8s.app"]
        shape[r, 0] = rw.index[100 + int(app[3:])]
        shape[r, 1] = (int(ing.from_endpoints[0].match_labels["k8s.team"][1:])
                       if ing.from_endpoints else -1)
        if ing.to_ports:
            pp = ing.to_ports[0].ports[0]
            shape[r, 2] = int(pp.port)
            shape[r, 3] = 6 if pp.protocol == "TCP" else 17
    shaped = np.flatnonzero(rng.random(n) < RULE_SHARE)
    got = shape[rng.integers(0, len(rw.rules), size=len(shaped))]
    members = rng.integers(0, max(len(rw.ids) // rw.n_teams, 1),
                           size=len(shaped))
    drawn = ports[rng.integers(0, len(ports), size=len(shaped))]
    keep = got[:, 1] >= 0
    rows, got = shaped[keep], got[keep]
    members, drawn = members[keep], drawn[keep]
    i_id = members * rw.n_teams + got[:, 1]
    i_id = np.where(i_id >= len(rw.ids), got[:, 1], i_id)
    l3 = got[:, 2] == 0
    cols["ep_index"][rows] = got[:, 0]
    cols["identity"][rows] = rw.ids[i_id]
    cols["dport"][rows] = np.where(l3, drawn[:, 0], got[:, 2])
    cols["proto"][rows] = np.where(l3, drawn[:, 1], got[:, 3])
    cols["direction"][rows] = INGRESS
    cols["is_fragment"][rows] = False
    cols["identity"] = cols["identity"].astype(np.uint32)
    return cols


def rules_records(rw, n: int, seed: int = 31) -> bytes:
    """`n` flow records of rules_tuples(rw, n, seed): the endpoint axis
    index as ep_id, the identity pre-resolved (replay_lattice's input),
    zero addresses and source ports."""
    from cilium_tpu_torch.native.loader import encode_flow_records

    t = rules_tuples(rw, n, seed)
    zeros = np.zeros(n, np.uint32)
    return encode_flow_records(
        ep_id=t["ep_index"], identity=t["identity"], saddr=zeros,
        daddr=zeros, sport=zeros, dport=t["dport"], proto=t["proto"],
        direction=t["direction"], is_fragment=t["is_fragment"])


def restricted_rule_index(rules) -> int:
    """The first L3-only rule whose (app, team) no other L3-only rule
    allows: the rule a shadow candidate restricts, so that its
    allow-to-deny rows show."""
    def pair(r):
        ing = r.ingress[0]
        if not ing.from_endpoints or ing.to_ports:
            return None
        return (r.endpoint_selector.match_labels["k8s.app"],
                ing.from_endpoints[0].match_labels["k8s.team"])

    pairs = [pair(r) for r in rules]
    count: Dict[tuple, int] = {}
    for p in pairs:
        if p is not None:
            count[p] = count.get(p, 0) + 1
    return next(i for i, p in enumerate(pairs)
                if p is not None and count[p] == 1)


def restricting_rule(rules, port: int, api=None, labels_cls=None):
    """A shadow candidate: add_one_rule's shape (the restricted rule's
    team -> its app on TCP `port`) under the labels of the rule
    `restricted_rule_index` picks, so that it replaces that L3-only
    rule.  `api` and `labels_cls` default to this package's policy API
    and LabelArray."""
    if api is None:
        from cilium_tpu_torch.policy import api
    if labels_cls is None:
        from cilium_tpu_torch.labels import LabelArray as labels_cls
    base = rules[restricted_rule_index(rules)]
    app = base.endpoint_selector.match_labels["k8s.app"]
    team = base.ingress[0].from_endpoints[0].match_labels["k8s.team"]
    return api.Rule(
        endpoint_selector=api.EndpointSelector(match_labels={"k8s.app": app}),
        ingress=[api.IngressRule(
            from_endpoints=[api.EndpointSelector(
                match_labels={"k8s.team": team})],
            to_ports=[api.PortRule(ports=[api.PortProtocol(
                port=str(port), protocol="TCP")])],
        )],
        labels=labels_cls.parse(*(str(lab) for lab in base.labels)),
    )
