"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds the CUDA kernels from cilium_tpu_torch/csrc with nvcc (one
process per library, started together), builds the config-5 world
(50,000 rules, 32 endpoints, 65,536 identities) and its fleet L7
matchers from fixed seeds, and drives these paths, each with the
launch counts set to 0 just before it and read just after:

  main_path  the headline datapath: PersistentPairDispatcher with
             K = 4 over 8 pairs of 2 x 2,097,152 flows, one copy and
             one PERSISTENT_PAIR launch per super-batch (2 launches, 0
             of DATAPATH_PAIR), after the pair kernel is checked
             bit-exact against its plain version on a full pair and two
             small worlds, and on a full pair over the wide layouts
             (wide_pair_check), and persistent_check holds
             PERSISTENT_PAIR against its plain version on a [4, 2, 4,
             2,097,152] super-batch and runs 9 pairs through a
             dispatcher at site "smoke.persistent" (2 super-launches, 1
             DATAPATH_PAIR remainder, the site's jit-cache calls and the
             datapath_persistent_* deltas as the reference counts
             them); main_path_trace counts the host-to-device copies
             (1 per super-batch) and persistent_timing times
             PERSISTENT_PAIR per super-batch beside 4 x DATAPATH_PAIR;
  churn      config 5's conntrack churn loop (replay_pool, bench.py's
             ct_churn_tuples_per_sec): a seed pass of 2 x 2,097,152
             picks drawn on the card, then the timed pass of
             4 x 2,097,152, over the wide tables (DATAPATH_STEP,
             CHURN_COMPACT, CT_DELTA); before it churn_check holds the
             three kernels against their plain versions at full width
             and runs 2 batches of the loop on the kernels and on the
             plain versions; after it, churn_trace and churn_timing;
  l7_http    config 3: 1,048,576 HTTP requests against 24 rules
             through evaluate_http_batch (HTTP_MATCH);
  l7_kafka   config 4: 1,048,576 Kafka requests against 24 rules
             through evaluate_kafka_batch (KAFKA_MATCH);
  l7_proxy   the L7 proxy from rules (world.proxy_world): 75 JSON rules
             (24 HTTP on TCP/80 with config 3's patterns, 24 Kafka on
             TCP/9092 with config 4's, 24 memcached on TCP/11211, one
             egress HTTP) through rules_from_json, Repository and
             resolve_l4_policy for one server endpoint, 1,024
             identities from labels, the four redirects compiled by
             Proxy.update_endpoint_redirects onto the card
             (proxy_setup, timed); then 1,048,576 requests per parser
             through verdict_http, verdict_kafka and verdict_generic
             (HTTP_MATCH, KAFKA_MATCH, MEMCACHE_MATCH; the egress
             redirect through verdict_http), each against the same call
             on the plain versions (the entry points' kernels swapped
             for them) and 256 rows against the host matchers, the
             memcached rows flagged for the host against the plain
             version's; then proxy_timing holds MEMCACHE_MATCH against
             its plain version at the world's 25 rules and at 70; and
             l7_proxy_monitor logs 131,072 HTTP requests to a MonitorBus
             (as many deny events as denials);
  combined   config 5's datapath + proxy step: 8 steps of
             2 x 2,097,152 flows, redirected flows compacted to
             131,072 per half and judged by the fleet L7 matchers
             (DATAPATH_PAIR and FLEET_L7), with a traced idle share;
  lattice    bench.py's lattice line: 8 calls of evaluate_batch on
             config 5's 4,194,304 tuples (LATTICE), after lattice_check
             holds LATTICE in every mode (config 5's compact and wide
             tables, config 1's dense tables, config 2's IP mode; with
             and without counters; config 5's tuples drawn Zipf(1.1)
             with counters) and LPM_LOOKUP against their plain versions,
             and LATTICE on a world whose entries overflow into both
             stashes (lattice_cases_check: tuples on the stash entries
             and edge words, every layout and mode, the stashes also
             padded past what the kernel stages);
  replay_lattice  10,000,000 flow records of config 5's pool through
             replay_lattice in batches of 1,048,576 with counters
             (LATTICE), its first 2 batches also on the plain version,
             512 sampled records against the oracle, a traced run;
  cidr       config 2: evaluate_batch_from_ips at 100,000 tuples (16
             calls) and 1,048,576 (8 calls), bench's 512-row oracle, and
             lpm_lookup of the addresses (LATTICE in IP mode, LPM_LOOKUP);
  config1_latency  config 1's 1,024 tuples through evaluate_batch, 256
             synchronised calls, p50 and p99, every call against the
             oracle (LATTICE); then lattice_timing;
  config6    bench.py's config 6, the fused IPv6 datapath: 1,048,576 v6
             flows through datapath6_step, one call against bench's
             256-row composed oracle, then 8 calls timed (DATAPATH6);
             before it config6_check holds DATAPATH6 against its plain
             version on those flows, with the 256-node tunnel map, and
             on both passes of the conntrack variant (a 65,536-flow
             slice written back, then the slice and its reverses), on
             the v6 tables' edges (world.v6_edge_world, its tables
             staged and padded to be read in place), and
             DATAPATH_PAIR and DATAPATH_STEP against theirs on config 5's
             tables with the same tunnel map (overlay mode); after it
             config6_timing;
  replay     the north star, config 5's fused record replay: 10,000,000
             flow records of the pool through replay() in batches of
             1,048,576 with counters and telemetry (DATAPATH_STEP in its
             accumulate forms), after forms_check holds every
             single-batch form and the unpacked pair forms against their
             plain versions on 1,048,576 flows over the headline and
             wide tables, and replay_check the whole replay on the card
             against the plain loop (stats, u64 counters, telemetry,
             the metrics registry's increments) and 512 sampled pool
             rows against the composed host oracle; then replay_trace
             and replay_churn: replay(ct_map=...) over 2 x 2,097,152
             records of pool rows on the wide tables (DATAPATH_STEP,
             CHURN_COMPACT, CT_DELTA), first against the plain loop,
             then timed; then flow_capture: replay(flow_store=
             FlowStore()) over 1,048,576 records in 4 batches into the
             default 65,536-record ring, against the same replay without
             a store and a host recomputation of the ring from the
             batches' drained columns, the captured, cut and evicted
             counts, and the same columns through capture_batch with the
             metrics registry (flow_store_evicted);
  node, node_lpm  the node-scale worlds (world.node_world: 110
             endpoints, 1,024 prefilter CIDRs, a 64-backend VIP, CIDR
             identities over 8 prefix lengths; node_lpm with 4,096 /24
             CIDR identities), whose tables take the DIR-24-8
             prefilter, the classic LB and the idx ipcache without L3
             planes with the [B, P] range scan (node) or a DIR-24-8
             ipcache (node_lpm): 8 pairs through
             PersistentPairDispatcher (K = 4, PERSISTENT_PAIR),
             verdicts/s and a traced idle share (its device time and
             copies "not_measured" where the profiler's later session
             loses its device rows, else the copies checked against
             the super-batches; CUDA events time the loop too); before
             it node_world
             asserts the layouts and node_check holds DATAPATH_PAIR (2
             full pairs), PERSISTENT_PAIR (a super-batch of 4 pairs of
             2 x 524,288) and DATAPATH_STEP's forms (1,048,576 flows)
             against their
             plain versions, replay() (2 batches) and int-pick
             replay_pool (2 x 2,097,152, wide tables) against the plain
             loops with the snapshot against its mirror, and 512 pool
             rows against the composed oracle; after it node_timing
             times both kernels on the world's layouts, and config 5's
             again in the same run;
  publish    policy publication (bench.py's delta_update_ms): config 5's
             map states as MapStateArrays through the port's
             FleetCompiler and a default DeviceTableStore on the card;
             two full uploads, bench's 3 priming one-rule steps (team 0
             -> endpoint 0 on TCP 4301-4303), 8 timed ones (4304-4311),
             4 removals (the first around a memo stamp flush: 0 hits on
             the new epoch, equal to LATTICE, then hits), one step that
             grows the identity universe (id_table and id_direct
             scatter) and one that adds 64 ports past the slot pad (Kg
             grows: whole leaves replaced inside a delta publish)
             (PUBLISH_SCATTER).  After every publish each epoch leaf
             equals its host compile, the previous epoch its snapshot,
             PUBLISH_SCATTER its plain version on the same payloads and
             base, LATTICE on the live epoch LATTICE on a fresh full
             upload (bench's 4,194,304 tuples and probes of every
             change, which flip as the map states say), and the epoch
             two publishes back is refused; then publish_timing;
  rules      config 5 from rules (world.rules_world,
             bench.py's build_config5): 50,000 rules, 32 endpoints,
             65,536 identities through the port's Daemon on the card
             (endpoints, identities with their /32s, policy_add, the
             two-phase regenerate sweep with its proxy redirects), then
             published_device()'s full upload, checked leaf for leaf
             (rules_setup); LATTICE on that epoch over 4,194,304 tuples
             (world.rules_tuples) against its plain version and 512
             oracle rows, and one evaluate_batch_from_ips call on the
             DIR-24-8 tables of the daemon's ipcache against the plain
             version, HostLPM with the oracle, and lookup_host on 8 rows
             (rules_check); bench.py's update from a rule: add_one_rule,
             regenerate_all, published_device(), 3 priming and 8 timed
             steps, each timed one a delta and every epoch equal to its
             host tables (rule_update, PUBLISH_SCATTER);
             compile_candidate_world over one candidate rule
             (world.restricting_rule), uploaded, LATTICE on the live and
             candidate epochs and SHADOW_DIFF, against its plain version
             and the numpy diff of the oracle on 512 rows, with at least
             one row changed (shadow), then shadow_timing;
             replay_lattice(manager=...) over 1,048,576 records with
             counters against the plain loop, sync_counters_to_endpoints
             (the synced packets equal the counters' sum) and the refusal
             of a snapshot two publishes old (manager_replay); then
             trace_spans: a priming step and 8 update steps from a rule,
             each under a root span of the port's tracer, one
             compiler.compile, compiler.delta_for and publish.epoch span
             per step, their median ms beside the step's own split, and
             one step's span tree;
  memo       config 5's memoized headline pair (bench.py's timed memo
             loop): 8 Zipf(1.1) pairs of 2 x 2,097,152 flows through
             memo_pair_packed4 behind AsyncBatchDispatcher (depth 2),
             rep_cap 524,288, a 16,384-row verdict cache
             (DATAPATH_PAIR_MEMO's front and back passes, MEMO_DEDUP and
             MEMO_CACHE per half), hit rate, dedup factor, and the
             uncached headline on the same pairs in turns; before it
             memo_check runs bench.py's memo gates at rep_cap 2,097,152
             (uniform cold and warm, Zipf twice) against the plain
             memoized pair and the uncached DATAPATH_PAIR, each memo kernel
             against its plain version, a stamp flush onto the policy of
             a delta publish through the publish phase's compiler and
             store (0 hits, then hits), a hot pair (one flow that counts
             a hit takes 3 rows of 4 of each half: one hot counter cell)
             cold and warm, an overflow at rep_cap 1,024 (of the uniform
             pair, and of a pair whose hot ingress half fits it) and
             memo_evaluate against LATTICE and its plain version on
             4,194,304 Zipf tuples, MEMO_DEDUP against its plain
             version on its edge cases (dedup_case_keys, each at rep_cap
             n_unique, half of it and past it), and MEMO_CACHE against
             its plain version on both halves of the Zipf pair's keys
             over the three layouts at 8, 16 and 32 entries, one bucket,
             one key, rep_cap = U and an overflow with the restore
             (cache_cases_check);
  memo_lattice  memo_evaluate (the daemon's serving shape) through a
             VerdictCache, 8 calls on those tuples (MEMO_KEYS_LATTICE,
             MEMO_DEDUP, MEMO_CACHE), and LATTICE's uncached line; then
             memo_timing;
  dense      K8's dense branch (dense_check): DATAPATH_PAIR and
             DATAPATH_STEP on config 5's headline tables with the
             policy's hashed L4 leaves set to None (the wide compile's
             port_slot and l4_allow_bits), a full pair and 2,097,152
             pool picks, against their plain versions and the hashed
             tables' run (every column but l4_slot);
  mesh       the lattice on a mesh (K21): config 5's map states through
             a FleetCompiler into a partitioned and a replica store on a
             virtual (2, 4) mesh of the card, the word-sharded and the
             (8, 1) replicated placements (mesh_setup); the word-sharded,
             partitioned, failover and sharded evaluators once each over
             the lattice phase's 4,194,304 tuples (8 MESH_PROBE, 16
             ROUTED_PROBE, 6 MESH_COMBINE and 8 LATTICE launches); then
             mesh_check (each kernel against its plain version on every
             shard and batch row; ROUTED_PROBE's records also on (2, 4)
             and (4, 2) meshes of a small world whose tuples hit both
             L4 stashes and carry out-of-range words, partitioned,
             healthy and with a dead chip, and the failover evaluator
             with holes on the card against the CPU: routed_cases_check;
             the evaluators' verdicts, counters and
             folded per-chip telemetry against LATTICE's, chip (0, 1)
             dead with and without garbage in its own rows against the
             healthy mesh, replica_hits > 0), mesh_store_update (a
             one-rule delta into both stores: the owning shards' rows
             only, both replica copies, verdicts against LATTICE on a
             fresh upload) and mesh_timing;
  failover   the mesh's host half: a ChipFailoverRouter on the same
             (2, 4) mesh over a replica store of config 5's tables and
             the 4,194,304 tuples (failover_setup), launch counts set
             to 0 around each dispatch: failover_healthy (16
             ROUTED_PROBE, 2 MESH_COMBINE; no degradation, re-split,
             replica hit or chip failure), failover_kill (chip 1 killed
             through the engine.dispatch fault seam: replica_hits > 0,
             equal outputs), failover_resplit (its backup too: row 0
             re-splits), failover_readmit (two one-rule deltas by
             PUBLISH_SCATTER while out, the missed rows poisoned in the
             chip's own slice, the half-open probe's rebalance by
             REPAIR_SCATTER: bytes beside a full upload, live and spare
             epochs equal to fresh uploads, verdicts against LATTICE),
             failover_terminal (every breaker open, 4,096 tuples
             through the host fold against LATTICE), failover_memo
             (attach_memo at R_local = 1,024 and 8 lanes, a Zipf(1.1)
             stream cold and warm, healthy and with chip 1 dead,
             against an uncached router: MEMO_KEYS_LATTICE, MEMO_DEDUP,
             MESH_MEMO_PROBE, MESH_MEMO_COMBINE, ROUTED_PROBE and
             MESH_MEMO_INSERT; a forced overflow re-dispatched uncached;
             make_partitioned_memo_evaluator against the partitioned
             evaluator) and failover_timing (each new kernel against its
             plain version, cold and warm, and timed);
  dp_mesh    the fused datapath on the same (2, 4) mesh (K21 datapath
             mesh): dp_mesh_setup (config 5's compact DatapathTables, a
             DatapathStore published twice, the byte models), dp_mesh
             (the pair evaluator over a pair of 2 x 2,097,152 flows and
             the per-flow evaluator over the same 4,194,304 flows
             shuffled, healthy and with chip (0, 1) dead and its primary
             rows poisoned in a private copy: 80 DP_MESH_PROBE and 6
             DP_MESH_COMBINE launches each time; the 15 columns, both
             counter buffers and the telemetry against DATAPATH_PAIR and
             DATAPATH_STEP on the single-device tables), dp_mesh_node
             (the node world's tables: the [B, P] scan, the classic LB,
             one pair), dp_mesh_store (two churn steps of a CT write-back
             and an ipcache upsert, each a delta below a tenth of a full
             upload; resident blocks against the host augmentation;
             repair_chip(1) by REPAIR_SCATTER), dp_failover_* (the
             router's dispatch_flows of the 4,194,304 flows healthy, chip
             (0, 1) killed, its backup (0, 2) dead too, the backup back,
             the chip readmitted with its poisoned blocks repaired) and
             dp_mesh_timing (each new kernel against its plain version,
             every round, and timed; the evaluators beside DATAPATH_PAIR
             and DATAPATH_STEP);
  hash_lookup  the generic hash table (K20 rest a): 262,144 unique
             4-word keys (capacity 1,048,576 + a 128-row stash, a cluster
             of keys homed in the main region's last slots filling the
             stash and wrapping their windows), 4,194,304 queries (half
             hits, half misses, 1,024 all-ones sentinel rows) through
             lookup_batch (HASH_LOOKUP), against the plain version and
             65,536 rows against a host dict; then timed;
  ipcache_lookup  lpm_lookup over the bucketized ipcache (K20 rest b):
             1,048,576 addresses through config 5's generic, idx with L3
             planes and sub-word forms and the node world's idx form
             with the [B, P] scan (IPCACHE_LOOKUP, one launch each),
             each against the plain version, the generic form also
             against DIR-24-8 built from the same map; then timed;
  reshard    live resharding: a router over config 5's FleetCompiler
             policy tables with its compact DatapathTables attached, on
             a virtual (2, 2) mesh, grown to (2, 4) and shrunk back
             through ReshardPlan in about 8 bounded steps each, a
             checked dispatch of both planes (dispatch against LATTICE,
             dispatch_flows against DATAPATH_STEP) at every step and 0
             differing entries; during the grow a chip of new column 2
             dies at the reshard.migrate seam (the plan completes from
             the replicas) and a churn publish of both planes (a
             one-rule policy delta, a CT write-back and an ipcache
             upsert) patches the live epochs and is folded into the
             staged ones; REPAIR_SCATTER against its plain version on
             the grow's datapath relayout segments (the REPAIR_SCATTER
             row's `relayout`).

    python3 chip_smoke.py --ab-parent DIR

also builds DIR/cilium_tpu_torch/csrc/{publish,churn,datapath,datapath6,
lattice,datapath_mesh,lookup,memo,mesh}.cu (a `git archive` of the parent
commit)
into cilium_tpu_torch/_build/ab/,
beside the package's own build, and runs the parent's kernels beside
this one's: at each of the four sites of PUBLISH_SCATTER and
REPAIR_SCATTER (publish_timing's one-rule publish, failover_timing's
readmission, dp_mesh_store's churn delta, reshard's relayout queue) on
copies of the site's segments, every entry agreeing, both timed in
turns parent, new, new, parent (the row's `ab`; the scatter_ab phase
sums the sites up, its A/B held to SCATTER_AB_BUDGET_S); in
persistent_timing PERSISTENT_PAIR at K = 4 and DATAPATH_PAIR on the
timed super-batch, every entry of the 15 columns, the counters and the
telemetry agreeing, in the same turns (pair_ab: the rows' `ab`); in
churn_timing the parent's CT_DELTA beside this one and index_copy_ on
the run's delta (`parent_ms`, `parent_events_ms`) and the parent's
DATAPATH_STEP on the churn batch beside this one (the parent's kernel
reads the planar pool, this one the row-major copy; library_ab: the
step row's `ab`),
and in step_form_timing on the record replay's accum_telem form (the
`datapath_step_modes` line's `ab`); in memo_timing the parent's
MEMO_DEDUP on the Zipf pair half's keys and on MEMO_DISTINCT distinct
keys, every output entry agreeing (memo_ab: the row's `ab`), the
parent's MEMO_CACHE on both halves of the Zipf pair, v0, v1, hit, the
rows and the stats agreeing (cache_ab: device ms, events and the
wrapper's host µs queued behind a spin, the row's `ab`), the parent's
memo mode passes (the front pass's key words and columns, the back
pass's columns, and its counters and telemetry from zeroed carries
agreeing; library_ab: DATAPATH_PAIR_MEMO's `ab`), and the whole
memoized pair on the parent's csrc/datapath.cu and csrc/memo.cu
(memo_pair_ab: DATAPATH_PAIR_MEMO's row); in mesh_timing the parent's
ROUTED_PROBE, partitioned and in failover mode on shard 0 of the dead
chip's batch row and on the shard serving its backup rows (library_ab:
the row's `ab`); and, every
result agreeing, in the same turns, LATTICE in each of lattice_timing's
shapes, DATAPATH6 on config 6's flows with and without the tunnel map,
DP_MESH_PROBE's four rounds on shard (0, 0) in dp_mesh_timing
and IPCACHE_LOOKUP on each form of ipcache_lookup (library_ab: the
rows' `ab`), whose stage code (csrc/*.cuh) the pair kernel shares.
The four scatter sites alone, on config 5's world: `python3 -c "import
chip_smoke; chip_smoke.scatter_alone('DIR')"` (DIR None: no A/B).

The churn path's int picks are drawn on the card by PICK_DRAW, the
reference's threefry2x32 randint; churn_check also runs 2 int-pick
batches on the kernels and on the plain versions (the same picks), and
prng_check holds PICK_DRAW against the plain draw on 2,097,152 picks
for 4 keys at the pool's size and at 3,000,017.

Every kernel is held bit-exact against its plain PyTorch version at
the path's shapes, each L7 and lattice path against a host oracle on
sampled rows, and the churn loop's resident CT snapshot against its
host mirror.  Exits non-zero on any failure, and without a CUDA
device.

The line before the last two is {"kernels": [...]}: per kernel its
launches on its path, its error against the plain version, its time
(CUDA events over 20 launches), the plain version's time, and the
least time the card could take: the bytes this run's data needs read
and written once at 3.35 TB/s, or its operations at 67 T/s, whichever
is larger.  CT_DELTA's time is its device ms queued behind a spin (the
CUDA events a caller sees in `events_ms`), on the churn loop's first
delta.  `library_ms` is the time of `index_copy_` for CT_DELTA (device
ms likewise, `library_events_ms` beside),
of `torch.unique` for MEMO_DEDUP, of one `index_put_` per leaf for
PUBLISH_SCATTER (on in-range payloads: a time only, torch raises where
jax drops), of `index_copy_` along the repaired axis for REPAIR_SCATTER
(a time only), of `torch.randint` for PICK_DRAW
(other numbers on the same shape: a time only) and null for the others:
no single PyTorch call computes the fused datapath steps (pair,
persistent or single-batch), the intent
compaction, a DFA scan, the Kafka rule match, the fleet's routed match,
the policy lattice, the two dependent DIR-24-8 reads, the v6 program,
the verdict cache, the memo's key words, the memcached rule match or
the shadow diff.  LATTICE's launches are
summed over its four paths, its time is config 5's compact mode;
LPM_LOOKUP's time is config 2's 1,048,576 addresses; DATAPATH6's is
config 6's 1,048,576 flows in device ms queued behind a spin (the
caller's CUDA events in `events_ms`, ptxas in `ptxas`).  PERSISTENT_PAIR's time is one launch on
4 pairs of 2 x 2,097,152 flows (`datapath_pair_x4_ms`: 4 DATAPATH_PAIR
launches on the same pairs), its plain time one call, its bound
needed_bytes over the super-batch (each distinct table row across the
4 pairs once); its launches are the main, persistent_check and node
paths' (`launches_by_path`); `device_ms` its device ms queued behind a
spin, `design` the kernel's launch there (pair_launch: its grid, the
stash words staged and the dynamic shared memory a block takes),
`stash_rows` the tables' stash rows, `ptxas` the registers, spills and
static shared memory of each layout's instantiation.  LATTICE's row
carries each timed shape's events, device ms and bound (`modes_ms`) and
the ptxas record of each of its instantiations (`ptxas`: entry words,
IP mode, streaming); DATAPATH_PAIR_MEMO's its front and back passes'
times and their ptxas records by layout (`ptxas`).  The DATAPATH_PAIR and DATAPATH_STEP rows
also carry their time in overlay mode (`tunnel_ms`, `tunnel_plain_ms`,
`tunnel_bound_ms`: the same bound plus the 3 KB map read whole,
`tunnel_max_abs_err`), and DATAPATH6's row its time, plain time and
bound with the tunnel map.  DP_MESH_COMBINE's row also carries its
wrapper's one zero fill alone and its share (`fills_ms`, `fills_share`),
the four fills the wrapper made before (`four_fills_ms`) and the counter
buffers' bytes (`counter_bytes`), and its `reshard_launch` the same at
the reshard shape with that shape's bound.  DATAPATH_STEP's launches are summed over
its three paths (churn, replay, replay_churn; `launches_by_path`), and
its replay modes' times, plain times and bounds are the line
{"datapath_step_modes": ...} just before.  DATAPATH_PAIR's launches
are summed over the main path, persistent_check's remainder, the two
node paths and the combined loop (`launches_by_path`); both datapath
rows carry `by_layout`: per layout
instantiation (kernels.layout_name) and world, the time, plain time,
bytes, operations and bound of node_timing.  Then the card's name and
power limit as nvidia-smi prints them, then {"ok": true, "device":
{...}}.  The memo rows: DATAPATH_PAIR_MEMO's time is its front and back
passes on one Zipf pair (`front_ms`, `back_ms`, their device ms
`front_device_ms`, `back_device_ms` queued behind a spin; `memo_pair_ms`
the whole memoized pair, `uncached_pair_ms` DATAPATH_PAIR on the same
pair) and its plain time the whole plain memoized pair; MEMO_DEDUP's and
MEMO_CACHE's times are one half's at rep_cap 524,288 (MEMO_CACHE's the
ingress half's events; `device_ms`, `egress_ms`, `egress_device_ms` and
the wrapper's `host_us` per call beside them), MEMO_DEDUP's library call
`torch.unique(keys, dim=0, return_inverse=True)`; MEMO_KEYS_LATTICE's
time is its keys and combine launches on 4,194,304 tuples.
SHADOW_DIFF's time is its device time over 20 launches at 4,194,304
rows queued behind a device spin (`queued_ms`; `wrapper_ms` the CUDA
events of 20 launches as a caller sees them, the wrapper's host time
included; the serve_* keys the same at 131,072 rows), its bound 16 B a
row; LATTICE's and
PUBLISH_SCATTER's launches include the from-rules paths
(`launches_by_path`).
PUBLISH_SCATTER's time is one launch on the last timed step's payloads
(every scattered leaf) and base epoch, its bound their index and value
bytes read and the destination rows written once.  It and
REPAIR_SCATTER's four sites (the row's own readmission time,
`datapath_delta`, `relayout`) give device ms over 20 calls queued
behind a device spin (`ms`, `library_ms`: warm in the L2 where the
site's bytes fit), the same with the L2 evicted before each call
(`cold_ms`, `library_cold_ms`), the caller's CUDA events (`events_ms`,
`library_events_ms`), and each segment's [leaf shape, axis, index rows]
(`geometry`).  HTTP_MATCH's and
KAFKA_MATCH's launches are summed over configs 3 and 4 and the proxy
path (`launches_by_path`); MEMCACHE_MATCH's time is one launch on the
proxy's 1,048,576 packed memcached requests against its 25 rules
(`wide_ms` at 70 rules), its bound those requests' 15 bytes each, each
distinct identity row and the rule columns, read or written once.
MESH_PROBE's, ROUTED_PROBE's and MESH_COMBINE's times are device time
per launch on shard (0, 0)'s 2,097,152 tuples (the combine over the
partitioned run's 4 records), 20 launches queued behind a device spin
(ROUTED_PROBE's `failover` and `failover_backup` in failover mode with
chip (0, 1) dead, its `rows_aligned` whether the rows allow 16-byte
key-plane loads, its `ptxas` registers and spills; the reshard path's
launches of the three mesh kernels timed at their own shape in each
row's `reshard_launch`);
their bounds the tuple words and record words each reads or writes and
each distinct row the shard's plain version gathers, once; `evaluators`
the ms and verdicts/s of each evaluator and of LATTICE in the same run.
DP_MESH_PROBE's time is the mean per launch of rounds S, L, F and P on
shard (0, 0)'s 2,097,152 flows (`by_round` each, its plain version and
bound), device time over 20 launches queued behind a device spin (CUDA
events as the caller sees them in `wrapper_ms`); DP_MESH_COMBINE's one
launch over batch row 0's 4 round-P records; their bounds the flow words each reads,
the record rows it needs (a row that shard 0 alone writes counted once)
and writes, and each distinct row the shard's plain version gathers,
once; `evaluators` both evaluators' ms beside DATAPATH_PAIR's and
DATAPATH_STEP's on the same flows, with their spread over repeated
timings and traced runs (the device's busy ms and the ms it waited on
the host).
DATAPATH_PAIR's row also carries its dense-branch time (`dense_ms`,
`dense_plain_ms`, `dense_bound_ms`, `dense_max_abs_err`, and
`dense_hashed_ms` the hashed tables on the same pair).

Map states from rules: the CPU recipe is
`world.rules_world(n_rules=600, n_endpoints=4, n_identities=256,
device="cpu")` (the port's Daemon), tested against the reference's own
build_config5 by `JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_endpoint.py tests/test_torch_shadow.py -q`.  The
phases rules_setup to manager_replay above run alone with
`python3 -c "import chip_smoke; from cilium_tpu_torch import kernels;
kernels.build_all(('shadow', 'lattice', 'publish'));
chip_smoke.rules_phases(kernels, [])"` on one H100.  Gotchas:
proxy ports come from the daemon's second sweep, in endpoint insertion
order; the oracle counts hits, so it runs on copies of the map states;
a stale device epoch is refused by the compiler's stamp check; at these
sizes a caller's time of SHADOW_DIFF is its wrapper's host time
(`wrapper_ms`), so its `ms` queues the launches behind a device spin.

Persistent pair and observability: the CPU recipe of the persistent
program, the flow ring and the tracer is tested against the reference by
`JAX_PLATFORMS=cpu python -m pytest tests/test_torch_persistent.py
tests/test_torch_tracing.py tests/test_torch_flow.py -q`; the kernel's
test on one H100 is `python -m pytest --noconftest
tests/test_torch_persistent.py -q -m cuda`.  Gotchas: a dispatcher's
per-pair results are views of fresh stacked outputs (no later launch
writes them); the remainder runs pair by pair through DATAPATH_PAIR;
the update steps of trace_spans need a primed spare epoch to publish
deltas; the reference's replay feeds no metrics registry to its
capture, so flow_store_evicted is checked through a second feed.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import gc
import ipaddress
import json
import operator
import subprocess
import sys
import time

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate (float32 table entry)
HALF = 1 << 21  # bench.py's --batch 1 << 22, split into two halves
PERSIST_K = 4  # bench.py's --persist-pairs
N_PAIRS = 8
L7_REQUESTS = 1 << 20  # configs 3 and 4 (bench.py --l7-requests: 1,000,000)
COMBINED_STEPS = 8
CHURN_BATCH = 1 << 21  # bench.py's seed_batch for the churn passes
CHECK_SLOTS = 1 << 12  # a claim table small enough to collide
CHECK_CAP = 1 << 10  # a cap below the winners of CHECK_SLOTS
ORACLE_ROWS = 512  # bench.py _gate_combined's sample
LATTICE_TUPLES = 1 << 22  # bench.py's lattice line (--batch)
LATTICE_CALLS = 8
REPLAY_RECORDS = 10_000_000  # BASELINE.json's replay
REPLAY_BATCH = 1 << 20  # replay_lattice's default batch
CIDR_TUPLES = 100_000  # bench.py --cidr-tuples
CIDR_CALLS = 16
CIDR_BIG = 1 << 20
CIDR_BIG_CALLS = 8
CONFIG1_CALLS = 256
CONFIG1_DENSE_TUPLES = 1 << 20  # config 1's distribution, at a card's width
CONFIG6_FLOWS = 1 << 20  # bench.py config 6's batch
CONFIG6_CALLS = 8
CONFIG6_SLICE = 1 << 16  # the conntrack variant's slice
PICK_SPAN_WRAP = 3_000_017  # a pool past 65,536 rows: randint's square wraps
PICK_KEYS = 4
FORMS_FLOWS = 1 << 20  # forms_check's config-5 flows
FORMS_DIR2 = 64  # of them with direction 2
REPLAY_CHURN_BATCH = 1 << 21
REPLAY_HEAD_BATCHES = 2  # replay_trace's records
TELEM_METRICS = ("forward_count", "drop_count", "policy_verdict_total",
                 "datapath_stage_total")
# the v6 table leaves DATAPATH6 reads: (plane, leaf)
READS6 = (
    ("prefilter", "base"), ("prefilter", "mask"),
    ("ipcache", "buckets"), ("ipcache", "stash"), ("ipcache", "range_base"),
    ("ipcache", "range_mask"), ("ipcache", "range_plen"),
    ("ipcache", "range_value"),
    ("ct", "buckets"), ("ct", "stash"), ("lb", "rows"), ("lb", "stash"),
    ("tunnel", "base"), ("tunnel", "mask"), ("tunnel", "endpoint"),
    ("policy", "id_direct"), ("policy", "l3_allow_bits"),
    ("policy", "l4_hash_rows"), ("policy", "l4_hash_stash"),
    ("policy", "l4_wild_rows"), ("policy", "l4_wild_stash"),
    ("policy", "l4_meta"),
)


def phase(name: str, t0: float, **fields) -> None:
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{name}] {time.perf_counter() - t0:.3f}s {extra}".rstrip(),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def compare(got, want, dp) -> int:
    """Max |difference| over every verdict column of both halves
    (u32 columns as unsigned); 0 means bit-exact."""
    worst = 0
    for g, w in zip(got, want):
        for col in dp.VERDICT_COLUMNS:
            a = getattr(g, col).to(torch.int64)
            b = getattr(w, col).to(torch.int64)
            if col in dp.U32_COLUMNS:
                a, b = a & 0xFFFFFFFF, b & 0xFFFFFFFF
            worst = max(worst, int((a - b).abs().max().item()) if a.numel() else 0)
    return worst


def buf_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int(
        ((a.to(torch.int64) & 0xFFFFFFFF) - (b.to(torch.int64) & 0xFFFFFFFF))
        .abs().max().item()
    )


def check_pairs(tables, pairs, kernels, dp, verdict) -> int:
    """Kernel vs plain over `pairs` from fresh carries: max error over
    the 15 columns, the counters and the telemetry."""
    acc_k = verdict.make_counter_buffers(tables.policy)
    tel_k = verdict.make_telemetry_buffers(acc_k.device)
    acc_p, tel_p = acc_k.clone(), tel_k.clone()
    err = 0
    for p in pairs:
        pt = torch.from_numpy(p.view(np.int32)).cuda()
        ki, ke, acc_k, tel_k = kernels.DATAPATH_PAIR(tables, pt, acc_k, tel_k)
        pi, pe, acc_p, tel_p = dp.datapath_pair_plain(tables, pt, acc_p, tel_p)
        err = max(err, compare((ki, ke), (pi, pe), dp))
    torch.cuda.synchronize()
    return max(err, buf_err(acc_k, acc_p), buf_err(tel_k, tel_p))


def check_super(tables, pairs, kernels, dp, verdict) -> int:
    """PERSISTENT_PAIR against persistent_pair_plain on the super-batch
    of `pairs` (host [2, 4, B] each) from fresh carries: max error over
    the 15 stacked columns, the counters and the telemetry."""
    stacked = torch.from_numpy(np.stack(pairs).view(np.int32)).cuda()
    acc_k = verdict.make_counter_buffers(tables.policy)
    tel_k = verdict.make_telemetry_buffers(acc_k.device)
    acc_p, tel_p = acc_k.clone(), tel_k.clone()
    ki, ke, acc_k, tel_k = kernels.PERSISTENT_PAIR(tables, stacked, acc_k,
                                                   tel_k)
    pi, pe, acc_p, tel_p = dp.persistent_pair_plain(tables, stacked, acc_p,
                                                    tel_p)
    torch.cuda.synchronize()
    return max(compare((ki, ke), (pi, pe), dp), buf_err(acc_k, acc_p),
               buf_err(tel_k, tel_p))


# the pair kernel's 12 layout instantiations on small worlds: the
# make_world settings that put each plane in each of its layouts
LAYOUT_BASE = dict(n_rules=400, n_identities=512, n_vips=4, n_pool=3000,
                   ct_max_entries=4096, identity_pad=256, filter_pad=16,
                   n_endpoints=4, n_cidr_blocks=16)
LAYOUT_PLANES = (
    {"ranges": {}, "dir24_8": dict(n_blocklist=140)},  # prefilter
    {"inline": {}, "classic": dict(big_vip_backends=50)},  # LB
    {"idx_planes": {}, "idx": dict(n_endpoints=36),  # ipcache
     "generic": dict(n_cidr_blocks=520)},
)


# DATAPATH_STEP's forms in layouts_check: its flags on and off
LAYOUT_STEP_FORMS = (
    {},
    {"emit_sec_id": False, "acc": True, "telem": True},
    {"static_dir": 1, "acc": True},
    {"static_dir": 0, "emit_sec_id": False, "telem": True},
)


def check_step(tables, pool, kernels, dp, verdict) -> int:
    """DATAPATH_STEP against its plain version on a world's [8, P] pool:
    5,000 picks (the last row, rows past it, picks with bit 31 set)
    gathered from the pool's row-major copy (made by the wrapper, and
    passed in), and the
    first 4,999 rows as a pack without picks, each in LAYOUT_STEP_FORMS
    from carries that are not zero: max error over the 15 columns, the
    counters and the telemetry."""
    n = int(pool.shape[1])
    pk = np.random.default_rng(12).integers(0, n, 5000).astype(np.int64)
    pk[:6] = [n - 1, n, n + 7, 0xFFFFFFFF, 0x80000000, 0]
    picks = torch.from_numpy(pk.astype(np.uint32).view(np.int32)).cuda()
    err = 0
    for src, pks, rows in ((pool, picks, None),
                           (pool, picks, dp.pool_rows_of(pool)),
                           (pool[:, :4999].contiguous(), None, None)):
        for form in LAYOUT_STEP_FORMS:
            kw = dict(form)
            if kw.get("acc"):
                kw["acc"] = verdict.make_counter_buffers(tables.policy) + 1
            if kw.get("telem"):
                kw["telem"] = verdict.make_telemetry_buffers("cuda") + 2
            kp = {k: v.clone() if torch.is_tensor(v) else v
                  for k, v in kw.items()}
            got = kernels.DATAPATH_STEP(tables, src, pks, pool_rows=rows,
                                        **kw)
            want = step_plain(tables, src, pks, **kp)
            err = max(err, compare((got,), (want,), dp), *(
                buf_err(kw[b], kp[b]) for b in ("acc", "telem") if b in kw))
    torch.cuda.synchronize()
    return err


def check_memo(tables, w, kernels, dp, verdict) -> int:
    """The memoized pair (memo_pair_packed4: DATAPATH_PAIR_MEMO's front
    and back passes, MEMO_DEDUP, MEMO_CACHE) against memo_pair_plain on a
    world's uniform pair of 2 x 5,000 flows cold and warm, its Zipf(1.1)
    pair, and the Zipf pair again at a capacity it overflows, carries and
    cache rows threaded through: max error over the 15 columns, the
    counters, the telemetry, the rows, the hit flags and the stats."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.engine import memo

    uni = w.pairs(seed=13, half=5000, k=1)[0]
    zp = world.zipf_pairs(w, np.random.default_rng(54), 5000, 1, 1.1)[0]
    rows = torch.from_numpy(memo.make_cache_rows(1 << 8, 8).view(np.int32)
                            ).cuda()
    acc = verdict.make_counter_buffers(tables.policy)
    tel = verdict.make_telemetry_buffers("cuda")
    acc_p, tel_p = acc.clone(), tel.clone()
    err = 0
    for pair, cap in ((uni, 5000), (uni, 5000), (zp, 5000), (zp, 64)):
        pt = torch.from_numpy(pair.view(np.int32)).cuda()
        k = memo.memo_pair_packed4(tables, pt, rows, acc, tel, cap)
        p = memo.memo_pair_plain(tables, pt, rows, acc_p, tel_p, cap)
        err = max(err, memo_err(k, p, dp))
        rows, acc, tel, acc_p, tel_p = k[4], k[2], k[3], p[2], p[3]
    torch.cuda.synchronize()
    return err


def layouts_check(kernels, dp, verdict) -> dict:
    """DATAPATH_PAIR over 2 pairs of 2 x 5,000 flows, PERSISTENT_PAIR
    over 4 pairs of 2 x 4,999, DATAPATH_STEP over the world's pool
    (check_step: picks, the row-major copy, a pack, every form flag) and
    the memoized pair (check_memo: DATAPATH_PAIR_MEMO's front and back
    passes with MEMO_DEDUP and MEMO_CACHE, cold, warm and overflowing)
    against their plain versions on 12 small worlds, one per layout
    instantiation (LAYOUT_PLANES), each with its wide tables and its
    headline ones (sub-word, hot plane): 0 differences, and every
    instantiation taken."""
    from cilium_tpu_torch.replay import pack_flow_pool

    import itertools

    from cilium_tpu_torch import world
    from cilium_tpu_torch.compiler.tables import split_hot
    from cilium_tpu_torch.convert import tables_to

    t = time.perf_counter()
    errs, taken = {}, set()
    for combo in itertools.product(*(p.items() for p in LAYOUT_PLANES)):
        w = world.make_world(seed=5, **{**LAYOUT_BASE, **{
            k: v for _, o in combo for k, v in o.items()}})
        wide = w.host_tables()
        pool = torch.from_numpy(pack_flow_pool(w.pool).view(np.int32)).cuda()
        for form, host in (("wide", wide),
                           ("headline", dp.subword_datapath_tables(wide))):
            host.policy = split_hot(host.policy)
            tables = tables_to(host, "cuda")
            name = kernels.datapath_layout(tables)
            taken.add(name.split("+")[0])
            errs[f"{'/'.join(c[0] for c in combo)} {form}: {name}"] = max(
                check_pairs(tables, w.pairs(seed=9, half=5000, k=2), kernels,
                            dp, verdict),
                check_super(tables, w.pairs(seed=10, half=4999, k=4),
                            kernels, dp, verdict),
                check_step(tables, pool, kernels, dp, verdict),
                check_memo(tables, w, kernels, dp, verdict))
            del tables
    want = {kernels.layout_name(i) for i in range(12)}
    phase("layouts_check", t, instantiations=len(taken),
          max_abs_err=json.dumps(errs))
    if any(errs.values()) or taken != want:
        raise SystemExit(f"layouts_check: a kernel differs from its plain "
                         f"version, or layouts {sorted(want - taken)} were "
                         f"not taken")
    return errs


def once_ms(fn) -> float:
    """One synchronised call's wall time, in ms."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def h2d_copies(prof) -> int:
    """Host-to-device copies in a profiler run."""
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and "HtoD" in ev.key)


def event_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class RowReads(TorchFunctionMode):
    """Records, per table leaf, the rows (or elements) a plain run
    gathers with tensor indices."""

    def __init__(self, leaves):
        super().__init__()
        self.names = {id(t): name for name, t in leaves}
        self.units = {}  # name -> (bytes per unit, [flat unit indices])

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = (self.names.get(id(args[0]))
                if func is torch.Tensor.__getitem__ else None)
        if name is not None:
            t, ix = args[0], args[1]
            ix = ix if isinstance(ix, tuple) else (ix,)
            flat = 0
            for k, i in enumerate(ix):
                flat = flat * t.shape[k] + i.to(torch.int64)
            unit = t[(0,) * len(ix)].numel() * t.element_size()
            self.units.setdefault(name, (unit, []))[1].append(flat.reshape(-1))
        return func(*args, **(kwargs or {}))


def leaf_bytes(leaves, run):
    """Bytes of the rows of `leaves` ([(name, tensor)]) that `run()` (a
    plain version) gathers: each distinct row (or element) that the
    inputs select, read once and whole; a leaf read without tensor
    indices (a stash, the prefilter) counts whole.  Returns (bytes,
    gathered bytes, what run() returned)."""
    rec = RowReads(leaves)
    with rec:
        out = run()
    total = gathered = 0
    for name, t in leaves:
        if name in rec.units:
            unit, idx = rec.units[name]
            idx = torch.cat(idx)
            total += unit * int(torch.unique(idx).numel())
            gathered += unit * idx.numel()
        else:
            total += t.numel() * t.element_size()
    return total, gathered, out


def table_row_bytes(tables, leaf_names, run):
    """leaf_bytes over (plane, leaf) names of a DatapathTables.  Returns
    (bytes, gathered bytes)."""
    leaves = [(f"{plane}.{leaf}", getattr(getattr(tables, plane), leaf))
              for plane, leaf in leaf_names]
    return leaf_bytes(leaves, run)[:2]


def out_bytes_per_flow(dp) -> int:
    return sum(
        torch.empty(0, dtype=dp.VERDICT_DTYPES[c]).element_size()
        for c in dp.VERDICT_COLUMNS
    )


def needed_bytes(tables, pair, dp, verdict, kernels):
    """Bytes one pair step (`pair` [2, 4, B]) or one persistent program
    (a super-batch [K, 2, 4, B]) must move for these pairs' data: the
    flows read and the 15 columns written once; each distinct table row
    (across the K pairs) that
    the flows' hashes select read once, whole (the rows the plain
    version gathers; it probes every range class for every flow where
    the kernel stops at the first hit, which overcounts by at most the
    17 KB range table); the stashes and the prefilter read whole; each
    counter entry the pair changes read and written; the telemetry
    read and written.  Returns (bytes, row-read bytes per flow)."""
    acc = verdict.make_counter_buffers(tables.policy)
    tel = verdict.make_telemetry_buffers(acc.device)
    plain = dp.persistent_pair_plain if pair.dim() == 4 else (
        dp.datapath_pair_plain)
    rows_b, gathered = table_row_bytes(
        tables, kernels.datapath_reads(tables),
        lambda: plain(tables, pair, acc, tel))
    flows = pair.numel() // 4
    total = pair.numel() * 4 + out_bytes_per_flow(dp) * flows
    total += 2 * tel.numel() * 4 + 2 * 4 * int(torch.count_nonzero(acc).item())
    return total + rows_b, gathered / flows


def flow_ops(tables):
    """Integer operations a flow needs, counted low: 16 per hashed word
    (4 byte steps of shift, mask, xor, multiply) and 4 per row lane
    compared.  Every flow hashes the CT key (4 words), the ipcache key
    (1, none with DIR-24-8) and two L4 keys (2 each) and compares a CT
    row, an ipcache row and two L4 rows; a flow that is not ingress adds
    6 hashed words (LB service 2, flow 4), the service-scope CT probe
    and the LB row's slots (2 inline, 32 classic entries).  Returns
    (per flow, per flow that is not ingress); the [B, P] scan's
    compares are counted apart (scan_flows)."""
    from cilium_tpu_torch.ipcache.lpm import IPCacheDevice
    from cilium_tpu_torch.lb.device import LBTables

    pol, ipc, ct = tables.policy, tables.ipcache, tables.ct
    ct_e = ct.buckets.shape[1] // ct.entry_words
    l4_e = pol.l4_hash_rows.shape[1] // pol.l4_hash_stash.shape[1]
    if isinstance(ipc, IPCacheDevice):
        words = 1
        lanes = ipc.bucket_entries or (32 if ipc.l3_planes else 64)
    else:
        words, lanes = 0, 0
    lb = 32 if isinstance(tables.lb, LBTables) else 2
    return (16 * (8 + words) + 4 * (ct_e + lanes + 2 * l4_e),
            16 * 6 + 4 * (ct_e + lb))


def scan_ops(tables, flows, out) -> int:
    """The [B, P] scan's operations for these flows: 2 (mask, compare)
    per range for each flow whose peer misses the exact ipcache table;
    0 with range classes or DIR-24-8."""
    from cilium_tpu_torch.device import widen
    from cilium_tpu_torch.engine.hashtable import fnv1a
    from cilium_tpu_torch.ipcache import lpm

    ipc = tables.ipcache
    if not isinstance(ipc, lpm.IPCacheDevice) or ipc.range_rows is not None:
        return 0
    ing = flows.direction == 0
    peer = torch.where(ing, widen(flows.saddr), widen(out.final_daddr))
    rows = ipc.buckets[fnv1a(peer[:, None]) & (ipc.n_buckets - 1)]
    found = (lpm.ipcache_bucket_parts(ipc, rows, peer, ing)[0]
             | lpm.ipcache_stash_parts(ipc, peer, ing)[0])
    return 2 * int(ipc.range_base.shape[0]) * int((~found).sum())


def table_leaves(tables):
    import dataclasses

    for plane in dataclasses.fields(tables):
        obj = getattr(tables, plane.name)
        if obj is None:
            continue
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, torch.Tensor):
                yield f"{plane.name}.{f.name}", v


def reset_counts(kernels) -> None:
    for k in kernels.KERNELS:
        k.launches = 0


def kernel_row(kernel, source, replaces, launches, err, ms, plain_ms,
               bound_bytes_ms, bound_ops_ms, library_ms=None) -> dict:
    return {
        "name": kernel.name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": library_ms,
    }


def int_err(a: torch.Tensor, b: torch.Tensor, u32: bool = False) -> int:
    """Max |a - b| over two integer or bool tensors (u32 bits compared
    as unsigned); 0 means bit-exact."""
    if a.shape != b.shape:
        raise SystemExit(f"shapes differ: {tuple(a.shape)} {tuple(b.shape)}")
    x, y = a.to(torch.int64), b.to(torch.int64)
    if u32:
        x, y = x & 0xFFFFFFFF, y & 0xFFFFFFFF
    return int((x - y).abs().max().item()) if x.numel() else 0


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits per row of u32 words held in int32: [B, W] -> [B]."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return sum(((w >> k) & 1).sum(dim=1) for k in range(32))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def http_need(tables, fields, ident, rows=None):
    """Bytes and integer operations the HTTP match needs for these
    requests: each field's bytes up to its length (min(len, width)),
    the lengths, identity and known flag read once, the allowed byte
    and the W matched words written, each distinct identity row read
    once, the DFA tables read once; operations: 4 per scanned byte (the
    class lookup, the transition's index and its lookup) and 10 per
    mask word.  `rows` restricts the count to a subset of the rows."""
    w = int(tables.n_words)
    scanned = 0
    for k in range(3):
        data, lens = fields[2 * k], fields[2 * k + 1]
        if rows is not None:
            lens = lens[rows]
        scanned += int(lens.to(torch.int64).clamp(0, data.shape[1]).sum())
    b = int(ident.numel() if rows is None else rows.numel())
    idx = ident if rows is None else ident[rows]
    n_ident = int(tables.ident_rules.shape[0])
    distinct = int(torch.unique(idx.to(torch.int64).clamp(0, n_ident - 1))
                   .numel())
    dfa_bytes = sum(
        nbytes(getattr(tables, f"{f}_dfa").trans) // 2  # u16 values
        + nbytes(getattr(tables, f"{f}_dfa").accept, getattr(tables,
                 f"absent_{f}")) + 256
        for f in ("method", "path", "host")
    )
    total = scanned + b * (3 * 4 + 4 + 1 + 1 + 4 * w) + distinct * 4 * w
    return total + dfa_bytes, 4 * scanned + 10 * w * b


def kafka_need(tables, fields, ident, known, rows=None, scope=None):
    """Bytes and integer operations the Kafka match needs: each
    request's fields (kind, version, client, T topics, count, three
    flags), identity and known flag read once and its verdict written,
    each distinct identity row read once, the rule columns read once;
    operations: 12 + T per rule the request's identity row (and scope
    row) admits, 2 per topic slot."""
    t_count = int(fields[3].shape[1])
    ident = ident if rows is None else ident[rows]
    known = known if rows is None else known[rows]
    b = int(ident.numel())
    n_ident, w = (int(v) for v in tables.ident_rules.shape)
    idx = ident.to(torch.int64).clamp(0, n_ident - 1)
    bits = tables.ident_rules[idx]
    if scope is not None:
        bits = bits & scope
    active = int((popcount(bits) * known.to(torch.int64)).sum())
    distinct = int(torch.unique(idx).numel())
    rules = int(tables.rule_keys_lo.numel())
    total = b * (4 * 3 + 4 * t_count + 4 + 3 + 4 + 1 + 1)
    total += distinct * 4 * w + 21 * rules
    return total, (12 + t_count) * active + 2 * t_count * b


def http_oracle(hw, allowed) -> int:
    """Mismatches of the HTTP verdicts against the host matcher on
    config 3's sampled rows (bench.py config3's oracle)."""
    from cilium_tpu_torch.l7.http import http_rule_matches_host

    got = allowed.cpu().numpy()
    bad = 0
    for i in hw.sample:
        m, p, h = hw.templates[int(hw.pick[i])]
        want = any(
            int(hw.ident[i]) in spec.identity_indices
            and http_rule_matches_host(spec, m, p, h)
            for spec in hw.specs
        )
        bad += int(bool(got[i]) != want)
    return bad


def kafka_oracle(kw, allowed) -> int:
    """Mismatches against MatchesRule on config 4's sampled rows."""
    from cilium_tpu_torch.l7.kafka import matches_rules_host

    got = allowed.cpu().numpy()
    return sum(
        int(bool(got[i]) != matches_rules_host(
            kw.templates[int(kw.pick[i])], kw.specs, int(kw.ident[i])))
        for i in kw.sample
    )


def l7_http_phase(kernels) -> dict:
    """Config 3 through evaluate_http_batch: the kernel against its
    plain version (allowed and matched), the host oracle, times and the
    bound."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.convert import l7_tables_to
    from cilium_tpu_torch.device import array_tensor
    from cilium_tpu_torch.l7 import http

    t = time.perf_counter()
    hw = world.http_request_world(n=L7_REQUESTS)
    tables = l7_tables_to(hw.policy.tables, "cuda")
    args = tuple(array_tensor(a, "cuda")
                 for a in (*hw.fields, hw.ident, hw.known))
    torch.cuda.synchronize()
    reset_counts(kernels)
    allowed, matched = http.evaluate_http_batch(tables, *args)
    torch.cuda.synchronize()
    launches = kernels.HTTP_MATCH.launches
    if launches != 1:
        raise SystemExit(f"l7_http: HTTP_MATCH launched {launches} times")
    p_allowed, p_matched = http.evaluate_http_batch_plain(tables, *args)
    err = max(int_err(allowed, p_allowed), int_err(matched, p_matched, True))
    mismatches = http_oracle(hw, allowed)
    n_allowed = int(allowed.sum())
    ms = event_ms(lambda: kernels.HTTP_MATCH(tables, *args), 20)
    plain_ms = event_ms(lambda: http.evaluate_http_batch_plain(tables, *args),
                        3)
    need, ops = http_need(tables, args[:6], args[6])
    bb, bo = need / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    phase("l7_http", t, requests=L7_REQUESTS, rules=len(hw.specs),
          launches=launches, allowed=n_allowed, max_abs_err=err,
          oracle_rows=len(hw.sample), oracle_mismatches=mismatches,
          ms=round(ms, 4), plain_ms=round(plain_ms, 4), bytes=need, ops=ops,
          bound_bytes_ms=round(bb, 4), bound_ops_ms=round(bo, 4),
          requests_per_s=round(L7_REQUESTS / (ms / 1e3)))
    if err or mismatches or not 0 < n_allowed < L7_REQUESTS:
        raise SystemExit("l7_http: the kernel disagrees or the mix is empty")
    return kernel_row(kernels.HTTP_MATCH, "cilium_tpu_torch/csrc/l7.cu",
                      "cilium_tpu/l7/http.py:477", launches, err, ms,
                      plain_ms, bb, bo)


def l7_kafka_phase(kernels) -> dict:
    """Config 4 through evaluate_kafka_batch, checked and timed as the
    HTTP phase is."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.convert import l7_tables_to
    from cilium_tpu_torch.device import array_tensor
    from cilium_tpu_torch.l7 import kafka

    t = time.perf_counter()
    kw = world.kafka_request_world(n=L7_REQUESTS)
    tables = l7_tables_to(kw.policy, "cuda")
    args = tuple(array_tensor(a, "cuda")
                 for a in (*kw.fields, kw.ident, kw.known))
    torch.cuda.synchronize()
    reset_counts(kernels)
    allowed = kafka.evaluate_kafka_batch(tables, *args)
    torch.cuda.synchronize()
    launches = kernels.KAFKA_MATCH.launches
    if launches != 1:
        raise SystemExit(f"l7_kafka: KAFKA_MATCH launched {launches} times")
    err = int_err(allowed, kafka.evaluate_kafka_batch_plain(tables, *args))
    mismatches = kafka_oracle(kw, allowed)
    n_allowed = int(allowed.sum())
    ms = event_ms(lambda: kernels.KAFKA_MATCH(tables, *args), 20)
    plain_ms = event_ms(
        lambda: kafka.evaluate_kafka_batch_plain(tables, *args), 3)
    need, ops = kafka_need(tables, args[:8], args[8], args[9])
    bb, bo = need / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    phase("l7_kafka", t, requests=L7_REQUESTS, rules=len(kw.specs),
          launches=launches, allowed=n_allowed, max_abs_err=err,
          oracle_rows=len(kw.sample), oracle_mismatches=mismatches,
          ms=round(ms, 4), plain_ms=round(plain_ms, 4), bytes=need, ops=ops,
          bound_bytes_ms=round(bb, 4), bound_ops_ms=round(bo, 4),
          requests_per_s=round(L7_REQUESTS / (ms / 1e3)))
    if err or mismatches or not 0 < n_allowed < L7_REQUESTS:
        raise SystemExit("l7_kafka: the kernel disagrees or the mix is empty")
    return kernel_row(kernels.KAFKA_MATCH, "cilium_tpu_torch/csrc/l7.cu",
                      "cilium_tpu/l7/kafka.py:265", launches, err, ms,
                      plain_ms, bb, bo)


PROXY_REQUESTS = 1 << 20  # per parser, configs 3 and 4's width
PROXY_ORACLE_ROWS = 256
MEMCACHE_WIDE_RULES = 70  # MEMCACHE_MATCH's second check: three words


@contextlib.contextmanager
def plain_route(kernels):
    """The L7 entry points answer with their plain versions on the same
    card tensors (no launch counted) while the context is open."""
    from cilium_tpu_torch.l7 import http, kafka, memcached

    saved = (kernels.HTTP_MATCH, kernels.KAFKA_MATCH, kernels.MEMCACHE_MATCH)
    kernels.HTTP_MATCH = http.evaluate_http_batch_plain
    kernels.KAFKA_MATCH = kafka.evaluate_kafka_batch_plain
    kernels.MEMCACHE_MATCH = memcached.memcache_match_plain
    try:
        yield
    finally:
        (kernels.HTTP_MATCH, kernels.KAFKA_MATCH,
         kernels.MEMCACHE_MATCH) = saved


def proxy_setup_phase(kernels):
    """The proxy world from rules on the card: JSON rules, repository,
    1,024 identities from labels, resolve_l4_policy, the four redirects'
    compiles (world.proxy_setup)."""
    from cilium_tpu_torch import world

    t = time.perf_counter()
    pw = world.proxy_world(n_requests=PROXY_REQUESTS)
    made = time.perf_counter() - t
    ps = world.proxy_setup(pw)
    torch.cuda.synchronize()
    reds = ps.redirects
    if any(r is None for r in reds.values()):
        raise SystemExit(f"proxy_setup: a redirect is missing: {reds}")
    gt = reds["memcache"].generic_tables
    phase("proxy_setup", t, rules=len(ps.repo.rules),
          identities=len(ps.cache), universe=len(ps.id_table),
          redirects=len(ps.endpoint.realized_redirects),
          ports=sorted(ps.endpoint.realized_redirects.values()),
          http_rules=reds["http"].http_policy.tables.n_rules,
          kafka_rules=reds["kafka"].kafka_tables.n_rules,
          memcache_rules=len(gt.specs),
          memcache_host_rules=sum(not s.device_expressible
                                  for s in gt.specs),
          world_s=round(made, 3),
          **{f"{k}_s": round(v, 4) for k, v in ps.seconds.items()},
          compile_from_rules_s=round(sum(ps.seconds.values()), 4),
          device=str(ps.proxy.device))
    if ps.proxy.device.type != "cuda":
        raise SystemExit("proxy_setup: the proxy is not on the card")
    return pw, ps


def proxy_host_oracle(parser, red, reqs, ident, known, allowed) -> int:
    """Mismatches of `allowed` against the host matchers on sampled
    rows: HTTP full matches over every rule of the redirect, Kafka's
    MatchesRule, proxylib's policymap matching."""
    from cilium_tpu_torch.l7 import kafka, proxylib
    from cilium_tpu_torch.l7.http import http_rule_matches_host

    rows = np.random.default_rng(7).integers(0, len(reqs),
                                             size=PROXY_ORACLE_ROWS)
    bad = 0
    for i in rows.tolist():
        k, n = bool(known[i]), int(ident[i])
        if parser == "http":
            pol = red.http_policy
            want = k and any(
                n in spec.identity_indices
                and http_rule_matches_host(spec, *reqs[i])
                for spec in pol.device_rules + pol.host_rules)
        elif parser == "kafka":
            want = k and kafka.matches_rules_host(
                reqs[i], red.kafka_tables.specs, n)
        else:
            want = k and proxylib.matches_rules_host(
                red.generic_tables, reqs[i], n)
        bad += int(bool(allowed[i]) != want)
    return bad


def proxy_pack_s(parser, red, reqs) -> float:
    """Wall seconds of the verdict call's host pack alone (the
    reference's Python loop over the requests)."""
    from cilium_tpu_torch.l7.http import pad_requests, trim_packed
    from cilium_tpu_torch.l7.kafka import pad_kafka_requests

    t = time.perf_counter()
    if parser == "http":
        m, ml, p, pl, h, hl, _ = pad_requests(reqs)
        trim_packed(m, ml), trim_packed(p, pl), trim_packed(h, hl)
    elif parser == "kafka":
        pad_kafka_requests(red.kafka_tables, reqs)
    else:
        red.generic_tables.device.pack(reqs)
    return time.perf_counter() - t


PROXY_CALLS = (("http", "verdict_http", "http_match"),
               ("kafka", "verdict_kafka", "kafka_match"),
               ("memcache", "verdict_generic", "memcache_match"))


def l7_proxy_phase(kernels, pw, ps) -> dict:
    """Each parser's 1,048,576 requests through the proxy's verdict call
    on the card (log=False): its kernel must launch; the verdicts equal
    the same call on the plain versions and the host matchers on 256
    rows; the memcached rows flagged for the host are exactly the plain
    version's, and some of them end allowed by a prefix or regex rule.
    Returns the launches per parser and the memcached requests' packed
    columns on the card."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.device import array_tensor
    from cilium_tpu_torch.l7 import memcached

    out = {}
    for parser, method, kname in PROXY_CALLS:
        t = time.perf_counter()
        reqs, ident, known = world.proxy_requests(pw, parser)
        red = ps.redirects[parser]
        call = getattr(ps.proxy, method)
        kernel = {k.name: k for k in kernels.KERNELS}[kname]
        torch.cuda.synchronize()
        reset_counts(kernels)
        t1 = time.perf_counter()
        allowed = call(red, reqs, ident, known, log=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = kernel.launches
        others = {k.name: k.launches for k in kernels.KERNELS
                  if k is not kernel and k.launches}
        pack_s = proxy_pack_s(parser, red, reqs)
        with plain_route(kernels):
            t2 = time.perf_counter()
            plain = call(red, reqs, ident, known, log=False)
            plain_wall = time.perf_counter() - t2
        diff = int((np.asarray(allowed) != np.asarray(plain)).sum())
        mismatches = proxy_host_oracle(parser, red, reqs, ident, known,
                                       allowed)
        extra = {}
        if parser == "memcache":
            tab = red.generic_tables.device
            opcode, key_id = tab.pack(reqs)
            cols = [array_tensor(a, "cuda") for a in
                    (opcode, key_id, ident.astype(np.int32), known)]
            ka, kh = kernels.MEMCACHE_MATCH(tab, *cols)
            pa, ph = memcached.memcache_match_plain(tab, *cols)
            host_rows = kh.cpu().numpy()
            extra = dict(
                needs_host=int(host_rows.sum()),
                needs_host_diff=int((kh != ph).sum()),
                device_allowed_diff=int((ka != pa).sum()),
                host_allowed=int((host_rows & np.asarray(allowed)).sum()),
            )
        n_allowed = int(np.asarray(allowed).sum())
        phase(f"l7_proxy_{parser}", t, requests=len(reqs), launches=launches,
              others=others, allowed=n_allowed, plain_diff=diff,
              oracle_rows=PROXY_ORACLE_ROWS, oracle_mismatches=mismatches,
              verdict_s=round(wall, 4), pack_s=round(pack_s, 4),
              plain_verdict_s=round(plain_wall, 4),
              requests_per_s=round(len(reqs) / wall), **extra)
        if (launches < 1 or others or diff or mismatches
                or not 0 < n_allowed < len(reqs)):
            raise SystemExit(f"l7_proxy_{parser}: the kernel did not launch, "
                             "or the verdicts disagree, or the mix is empty")
        if parser == "memcache" and (
            extra["needs_host_diff"] or extra["device_allowed_diff"]
            or not extra["needs_host"] or not extra["host_allowed"]
        ):
            raise SystemExit("l7_proxy_memcache: the host rows differ from "
                             "the plain version's, or none ends allowed")
        out[parser] = launches
    # the egress redirect: HTTP_MATCH again, against the plain route
    reqs, ident, known = world.proxy_requests(pw, "http")
    t = time.perf_counter()
    reset_counts(kernels)
    eg = ps.proxy.verdict_http(ps.redirects["http_egress"], reqs, ident,
                               known, log=False)
    launches = kernels.HTTP_MATCH.launches
    with plain_route(kernels):
        eg_plain = ps.proxy.verdict_http(ps.redirects["http_egress"], reqs,
                                         ident, known, log=False)
    diff = int((eg != eg_plain).sum())
    phase("l7_proxy_http_egress", t, launches=launches,
          allowed=int(eg.sum()), plain_diff=diff)
    if launches != 1 or diff or not 0 < int(eg.sum()) < len(reqs):
        raise SystemExit("l7_proxy_http_egress: launch, difference or mix")
    out["http"] += launches
    n = PROXY_MONITOR_REQUESTS
    proxy_monitor(ps, reqs[:n], ident[:n], known[:n])
    return out, cols


PROXY_MONITOR_REQUESTS = 1 << 17  # the access log is a host loop per request


def proxy_monitor(ps, reqs, ident, known) -> None:
    """l7_proxy_monitor: HTTP requests through verdict_http with log=True
    on a proxy whose monitor is a MonitorBus: one LogRecordNotify per
    request, as many "Denied" events as the call's denials, and the bus's
    bounded queue counting what it could not hold."""
    from cilium_tpu_torch.monitor import MonitorBus

    t = time.perf_counter()
    bus = MonitorBus()
    q = bus.subscribe_queue()
    verdicts = {"Forwarded": 0, "Denied": 0}

    def count(ev):
        verdicts[ev.verdict] += 1

    bus.subscribe(count)
    saved, ps.proxy.monitor = ps.proxy.monitor, bus
    try:
        t1 = time.perf_counter()
        allowed = np.asarray(ps.proxy.verdict_http(ps.redirects["http"], reqs,
                                                   ident, known, log=True))
        logged_s = time.perf_counter() - t1
    finally:
        ps.proxy.monitor = saved
    denied = int((~allowed.astype(bool)).sum())
    phase("l7_proxy_monitor", t, requests=len(reqs), denied=denied,
          denied_events=verdicts["Denied"],
          forwarded_events=verdicts["Forwarded"], queued=len(q),
          lost_events=bus.lost_events, verdict_logged_s=round(logged_s, 4))
    if (verdicts["Denied"] != denied
            or verdicts["Forwarded"] != len(reqs) - denied
            or len(q) + bus.lost_events != len(reqs)):
        raise SystemExit("l7_proxy_monitor: the monitor's events do not "
                         "match the HTTP verdicts")


def memcache_need(tab, cols):
    """Bytes and integer operations MEMCACHE_MATCH needs: per request
    the opcode, key id and identity index (4 B each) and the known flag
    read, the two verdict bytes written; each distinct identity row's
    W words read once; the R rule columns (32 + 4 + 1 B) read once;
    operations: 8 per rule bit the known requests' rows carry, 10 per
    request."""
    opcode, key_id, ident, known = cols
    b = int(opcode.numel())
    n, w = (int(v) for v in tab.ident_rules.shape)
    idx = ident.to(torch.int64).clamp(0, n - 1)
    distinct = int(torch.unique(idx).numel())
    bits = int((popcount(tab.ident_rules[idx]) * known.to(torch.int64)).sum())
    need = b * (4 + 4 + 4 + 1 + 2) + distinct * 4 * w + len(tab.specs) * 37
    return need, 8 * bits + 10 * b


def memcache_wide_tables(n_identities: int):
    """70 memcached rules (three membership words) over the proxy's
    universe, from compile_rules: world.memcache_rule's split of exact
    keys, prefixes, regexes and bare opcodes, each rule's 64 identities
    drawn from a fixed seed."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.convert import l7_tables_to
    from cilium_tpu_torch.l7 import memcached

    rng = np.random.default_rng(71)
    specs = []
    for j in range(MEMCACHE_WIDE_RULES):
        d = world.memcache_rule(j, MEMCACHE_WIDE_RULES)
        idx = rng.integers(0, n_identities, size=64).tolist()
        specs.extend(memcached.compile_rules([d], idx))
    return l7_tables_to(memcached.compile_device(specs, n_identities), "cuda")


def proxy_timing(kernels, ps, cols, launches) -> dict:
    """MEMCACHE_MATCH alone on the proxy's packed memcached columns:
    against its plain version at the world's R and at R = 70, its time
    (CUDA events over 20 launches), the plain time and the bound."""
    from cilium_tpu_torch.l7.memcached import memcache_match_plain

    t = time.perf_counter()
    tab = ps.redirects["memcache"].generic_tables.device
    wide = memcache_wide_tables(int(tab.ident_rules.shape[0]))
    # both tables read the same packed columns (key ids of the world's
    # interner): a check of the kernel against its plain version
    err = 0
    for which, tb in (("world", tab), ("wide", wide)):
        ka, kh = kernels.MEMCACHE_MATCH(tb, *cols)
        pa, ph = memcache_match_plain(tb, *cols)
        e = max(int_err(ka, pa), int_err(kh, ph))
        err = max(err, e)
        print(f"  memcache_match {which}: rules={len(tb.specs)} "
              f"words={int(tb.ident_rules.shape[1])} max_abs_err={e} "
              f"allowed={int(ka.sum())} needs_host={int(kh.sum())}",
              flush=True)
    ms = event_ms(lambda: kernels.MEMCACHE_MATCH(tab, *cols), 20)
    plain_ms = event_ms(lambda: memcache_match_plain(tab, *cols), 3)
    wide_ms = event_ms(lambda: kernels.MEMCACHE_MATCH(wide, *cols), 20)
    need, ops = memcache_need(tab, cols)
    bb, bo = need / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    b = int(cols[0].numel())
    phase("proxy_timing", t, requests=b, rules=len(tab.specs),
          max_abs_err=err, ms=round(ms, 4), plain_ms=round(plain_ms, 4),
          wide_ms=round(wide_ms, 4), bytes=need, ops=ops,
          bound_bytes_ms=round(bb, 4), bound_ops_ms=round(bo, 4),
          requests_per_s=round(b / (ms / 1e3)))
    if err:
        raise SystemExit("proxy_timing: MEMCACHE_MATCH differs from plain")
    row = kernel_row(kernels.MEMCACHE_MATCH, "cilium_tpu_torch/csrc/l7.cu",
                     "cilium_tpu/l7/memcached.py:241", launches, err, ms,
                     plain_ms, bb, bo)
    row["wide_ms"] = wide_ms
    return row


def proxy_phases(kernels, http_row, kafka_row) -> dict:
    """The L7 proxy from rules (proxy_setup, l7_proxy, proxy_timing);
    adds the proxy path's launches to the HTTP_MATCH and KAFKA_MATCH
    rows (`launches_by_path`) and returns MEMCACHE_MATCH's row."""
    pw, ps = proxy_setup_phase(kernels)
    got, cols = l7_proxy_phase(kernels, pw, ps)
    for row, parser, phase_name in ((http_row, "http", "l7_http"),
                                    (kafka_row, "kafka", "l7_kafka")):
        row["launches_by_path"] = {phase_name: row["launches"],
                                   "l7_proxy": got[parser]}
        row["launches"] = sum(row["launches_by_path"].values())
    row = proxy_timing(kernels, ps, cols, got["memcache"])
    del pw, ps, got, cols
    torch.cuda.empty_cache()
    return row


def combined_oracle(w, fleet, reqs, kreqs, id_table, picks, out,
                    n_rows: int, seed: int) -> tuple:
    """The composed host oracle (bench.py _gate_combined) on `n_rows`
    redirected flows sampled from one step: each flow's proxy port
    equals its policy map entry's, and its L7 verdict equals the host
    matchers' over the rules of its own (endpoint, direction, slot)
    scope.  Returns (rows checked, mismatches)."""
    from cilium_tpu_torch.l7.fleet import PARSER_HTTP_ID, PARSER_KAFKA_ID
    from cilium_tpu_torch.l7.http import http_rule_matches_host
    from cilium_tpu_torch.l7.kafka import matches_rules_host
    from cilium_tpu_torch.maps.policymap import PolicyKey

    http_by_scope, kafka_by_scope = {}, {}
    for spec in fleet.http.device_rules:
        http_by_scope.setdefault(spec.scope_key, []).append(spec)
    for spec in fleet.kafka.specs:
        kafka_by_scope.setdefault(spec.scope_key, []).append(spec)
    picks = picks.cpu().numpy()
    order = out.order.cpu().numpy()
    l7 = out.l7_allowed.cpu().numpy()
    cands = []
    for half, v in enumerate(out.verdicts):
        red = ((v.proxy_port > 0) & (v.allowed != 0)).cpu().numpy()
        cands += [(half, int(pos))
                  for pos in np.nonzero(red[order[half]])[0]]
    rng = np.random.default_rng(seed)
    sample = rng.choice(len(cands), size=min(n_rows, len(cands)), replace=False)
    cols = {h: {c: getattr(v, c).cpu().numpy()
                for c in ("proxy_port", "l4_slot", "sec_id")}
            for h, v in enumerate(out.verdicts)}
    bad = 0
    for s in sample:
        half, pos = cands[int(s)]
        row = int(order[half, pos])
        p = int(picks[half, row])
        e, d = int(w.pool["ep_index"][p]), int(w.pool["direction"][p])
        sidx = int(cols[half]["sec_id"][row])
        key = PolicyKey(int(id_table[sidx]), int(w.pool["dport"][p]),
                        int(w.pool["proto"][p]), d)
        entry = w.states[e].get(key)
        if entry is None or entry.proxy_port != int(cols[half]["proxy_port"][row]):
            bad += 1
            continue
        scope = (e, d, int(cols[half]["l4_slot"][row]))
        kind = int(fleet.parser_kind[scope])
        if kind == PARSER_HTTP_ID:
            m, pth, h = reqs[p]
            want = any(sidx in spec.identity_indices
                       and http_rule_matches_host(spec, m, pth, h)
                       for spec in http_by_scope.get(scope, []))
        elif kind == PARSER_KAFKA_ID:
            want = matches_rules_host(kreqs[p], kafka_by_scope.get(scope, []),
                                      sidx)
        else:
            want = False
        bad += int(bool(l7[half, pos]) != want)
    return len(sample), bad


def combined_phase(kernels, w, tables, fleet) -> tuple:
    """Config 5's combined datapath + proxy step (see the module
    docstring): checks, the 8-step loop, its trace, and FLEET_L7 alone
    against its plain version, timed, with its bound.  Returns FLEET_L7's
    row and DATAPATH_PAIR's launches on the loop."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.convert import l7_tables_to
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import verdict
    from cilium_tpu_torch.l7 import combined as cb
    from cilium_tpu_torch.l7.fleet import (
        PARSER_HTTP_ID,
        PARSER_KAFKA_ID,
        evaluate_fleet_l7_plain,
        scope_rows,
    )

    t = time.perf_counter()
    reqs, kreqs, hf, kf = world.l7_payloads(w, fleet)
    fd = l7_tables_to(fleet, "cuda")
    pool = cb.pool_to(w.pool, hf, kf, "cuda")
    dirs = [torch.from_numpy(np.nonzero(w.pool["direction"] == d)[0]).cuda()
            for d in (0, 1)]
    gen = torch.Generator(device="cuda").manual_seed(101)

    def draw():
        return torch.stack([
            sub[torch.randint(0, sub.numel(), (cb.COMBINED_BATCH,),
                              device="cuda", generator=gen)]
            for sub in dirs
        ])

    # -- kernel path against the plain path on one step's picks
    picks0 = draw()
    acc_k = verdict.make_counter_buffers(tables.policy)
    tel_k = verdict.make_telemetry_buffers("cuda")
    acc_p, tel_p = acc_k.clone(), tel_k.clone()
    got = cb.combined_step(tables, fd, pool, picks0, acc_k, tel_k)
    want = cb.combined_step_plain(tables, fd, pool, picks0, acc_p, tel_p)
    err_step = max(
        int_err(got.header, want.header, True),
        int_err(got.l7_allowed, want.l7_allowed),
        int_err(got.order, want.order),
        int_err(acc_k, acc_p, True), int_err(tel_k, tel_p, True),
        compare(got.verdicts, want.verdicts, dp),
    )
    del want
    cols, fh, fk = cb.fleet_inputs(pool, picks0, got.order, got.verdicts)
    f_got = kernels.FLEET_L7(fd, *cols, http_fields=fh, kafka_fields=fk)
    f_plain = evaluate_fleet_l7_plain(fd, *cols, http_fields=fh,
                                      kafka_fields=fk)
    err_fleet = int_err(f_got, f_plain)
    id_table = tables.policy.id_table.cpu().numpy().view(np.uint32)
    checked, bad = combined_oracle(
        w, fleet, reqs, kreqs, id_table, picks0, got, ORACLE_ROWS, 7)
    # the redirected rows that reached each parser, and those it allowed
    redirected = torch.stack([
        ((v.proxy_port > 0) & (v.allowed != 0)) for v in got.verdicts
    ]).gather(1, got.order).reshape(-1)
    kind = fd.parser_kind.reshape(-1)[scope_rows(fd, *cols[:3])]
    reached = {
        name: (int((redirected & (kind == k)).sum()),
               int((f_got & redirected & (kind == k)).sum()))
        for name, k in (("http", PARSER_HTTP_ID), ("kafka", PARSER_KAFKA_ID))
    }
    phase("combined_check", t, step_max_abs_err=err_step,
          fleet_max_abs_err=err_fleet, oracle_rows=checked,
          oracle_mismatches=bad, redirected_and_allowed_by_parser=reached,
          header_in=got.header[0].cpu().numpy().view(np.uint32).tolist(),
          header_eg=got.header[1].cpu().numpy().view(np.uint32).tolist())
    if err_step or err_fleet or bad or checked == 0:
        raise SystemExit("combined: the kernels disagree with the plain "
                         "versions or the host oracle")
    if not all(n for n, _ in reached.values()):
        raise SystemExit(f"combined: a parser was not reached: {reached}")

    # -- the loop: counts from 0, 8 steps, headers summed on the card
    acc = verdict.make_counter_buffers(tables.policy)
    tel = verdict.make_telemetry_buffers("cuda")
    all_picks = [draw() for _ in range(COMBINED_STEPS)]
    tot = torch.zeros((2, 4), dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    reset_counts(kernels)
    t = time.perf_counter()
    for picks in all_picks:
        out = cb.combined_step(tables, fd, pool, picks, acc, tel)
        tot += out.header.to(torch.int64) & 0xFFFFFFFF
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {k.name: k.launches for k in kernels.KERNELS}
    totals = (tot.sum(dim=0) & 0xFFFFFFFF).cpu().tolist()
    per_half = tot.cpu().tolist()
    flows = COMBINED_STEPS * 2 * cb.COMBINED_BATCH
    combined_n, redirected, l7_allowed, overflow = totals
    phase("combined", t, steps=COMBINED_STEPS, flows=flows,
          launches=counts, verdicts_per_s=round(flows / wall),
          wall_ms=round(wall * 1e3, 3), allowed=combined_n,
          redirected=redirected, l7_allowed=l7_allowed, overflow=overflow,
          per_half=per_half)
    if counts[kernels.DATAPATH_PAIR.name] != COMBINED_STEPS or counts[
            kernels.FLEET_L7.name] != COMBINED_STEPS:
        raise SystemExit(f"combined: launches {counts}")
    if overflow != 0 or redirected == 0 or not 0 < l7_allowed < redirected:
        raise SystemExit("combined: overflow, no redirects, or a "
                         "degenerate L7 mix")

    # -- where the loop's time goes: one traced run of 4 steps
    t = time.perf_counter()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        for picks in all_picks[:4]:
            cb.combined_step(tables, fd, pool, picks, acc, tel)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t1) * 1e3
    busy = device_busy(prof)
    busy_ms = sum(busy.values())
    for key, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  device {ms:.3f} ms  {key[:90]}", flush=True)
    phase("combined_trace", t, steps=4, wall_ms=round(traced_ms, 3),
          device_busy_ms=round(busy_ms, 3),
          device_idle_share=round(1 - busy_ms / traced_ms, 4))

    # -- FLEET_L7 alone on one step's compacted rows: time and bound
    t = time.perf_counter()
    ms = event_ms(lambda: kernels.FLEET_L7(
        fd, *cols, http_fields=fh, kafka_fields=fk), 20)
    plain_ms = event_ms(lambda: evaluate_fleet_l7_plain(
        fd, *cols, http_fields=fh, kafka_fields=fk), 3)
    lin = scope_rows(fd, *cols[:3])
    n_scopes = int(fd.parser_kind.numel())
    lin = lin.clamp(0, n_scopes - 1)
    kind = fd.parser_kind.reshape(-1)[lin]
    hrows = torch.nonzero(kind == PARSER_HTTP_ID).reshape(-1)
    krows = torch.nonzero(kind == PARSER_KAFKA_ID).reshape(-1)
    hb, ho = http_need(fd.http.tables, fh, cols[3], rows=hrows)
    kscope = fd.scope_kafka.reshape(n_scopes, -1)[lin[krows]]
    kb, ko = kafka_need(fd.kafka, fk, cols[3], cols[4], rows=krows,
                        scope=kscope)
    rows_n = int(cols[0].numel())
    distinct = int(torch.unique(lin).numel())
    scope_b = 4 * (int(torch.unique(lin[hrows]).numel())
                   * fd.http.tables.n_words
                   + int(torch.unique(lin[krows]).numel())
                   * int(fd.scope_kafka.shape[-1]))
    need = hb + kb + scope_b + rows_n * (4 * 4 + 1 + 1) + distinct
    ops = ho + ko + 8 * rows_n
    bb, bo = need / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    phase("fleet_timing", t, rows=rows_n, http_rows=int(hrows.numel()),
          kafka_rows=int(krows.numel()), ms=round(ms, 4),
          plain_ms=round(plain_ms, 4), bytes=need, ops=ops,
          bound_bytes_ms=round(bb, 4), bound_ops_ms=round(bo, 4))
    return kernel_row(kernels.FLEET_L7, "cilium_tpu_torch/csrc/l7.cu",
                      "cilium_tpu/l7/fleet.py:172",
                      counts[kernels.FLEET_L7.name], max(err_step, err_fleet),
                      ms, plain_ms, bb, bo), counts[kernels.DATAPATH_PAIR.name]


# -- the churn loop (config 5's replay_pool) ------------------------------------


class PlainRoute:
    """Within the block, the entry points find the plain versions (run
    on the card's tensors) where they look up the kernels named in
    `plain` ({name in kernels: plain function}); the kernels are put
    back on exit.  Their launch counts do not move."""

    def __init__(self, kernels, plain: dict):
        self.kernels = kernels
        self.plain = plain

    def __enter__(self):
        self.saved = {n: getattr(self.kernels, n) for n in self.plain}
        for n, f in self.plain.items():
            setattr(self.kernels, n, f)

    def __exit__(self, *exc):
        for n, k in self.saved.items():
            setattr(self.kernels, n, k)


def step_plain(tables, pool, picks=None, pool_rows=None, **form):
    """DATAPATH_STEP's plain version, called as the kernel is (every
    form; `picks` None reads the pack directly; the pool's row-major
    copy holds the same flows)."""
    from cilium_tpu_torch.engine import datapath as dp

    flows = (dp.flow_batch_from_packed(pool) if picks is None
             else dp.pool_flows(pool, picks))
    return dp.datapath_step_plain(tables, flows, **form)


def churn_plain() -> dict:
    """The churn loop's kernels' plain versions, for PlainRoute."""
    from cilium_tpu_torch import replay as rp
    from cilium_tpu_torch.ct.device import apply_bucket_delta_plain
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.prng import pick_draw_plain

    def flows(pool, picks):
        return dp.pool_flows(pool, picks)

    return {
        "DATAPATH_STEP": step_plain,
        "CHURN_COMPACT": lambda out, pool, picks, valid, cap, slots:
            rp._churn_compact(out, flows(pool, picks), valid, cap, slots),
        "CT_DELTA": lambda snap, idx, rows: apply_bucket_delta_plain(
            snap, idx, rows),
        "PICK_DRAW": pick_draw_plain,
    }


def same_loops(maps, stats) -> bool:
    """Two churn runs agree: stats, every CT entry in order, and the
    resident snapshots byte for byte."""
    snaps = [m._device_churn_cache[1] for m in maps]
    return (
        stats_fields(stats[0]) == stats_fields(stats[1])
        and list(maps[0].entries) == list(maps[1].entries)
        and maps[0].entries == maps[1].entries
        and torch.equal(snaps[0].buckets, snaps[1].buckets)
        and torch.equal(snaps[0].stash, snaps[1].stash)
    )


def stats_fields(st) -> dict:
    return {f: getattr(st, f) for f in (
        "total", "allowed", "denied", "redirected", "batches", "ct_created",
        "ct_deleted", "rounds", "intents")}


def pinned_ct(ct):
    out = copy.deepcopy(ct)
    out.now = lambda: 0  # both loops stamp the same lifetimes
    return out


def churn_check(kernels, w, tables) -> dict:
    """DATAPATH_STEP, CHURN_COMPACT and CT_DELTA against their plain
    versions at full width, then 2 batches of the loop with kernels and
    with the plain versions on two copies of the CT.  Returns the
    inputs the timing phase reuses and the worst error."""
    from cilium_tpu_torch import replay as rp
    from cilium_tpu_torch.convert import ct_snapshot_to, flow_pool_to
    from cilium_tpu_torch.ct.device import (
        CTBucketIndex,
        apply_bucket_delta_plain,
    )
    from cilium_tpu_torch.engine import datapath as dp

    t = time.perf_counter()
    pool = flow_pool_to(w.pool, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(77)
    picks = torch.randint(0, pool.shape[1], (CHURN_BATCH,), generator=gen,
                          device="cuda", dtype=torch.int32)
    out = kernels.DATAPATH_STEP(tables, pool, picks)
    flows = dp.flow_batch_from_packed(pool[:, picks.long()])
    plain = dp.datapath_step_plain(tables, flows)
    err_step = compare((out,), (plain,), dp)
    valid = CHURN_BATCH - CHURN_BATCH // 128
    headers, err_compact, intents = {}, 0, None
    for label, cap, slots in (
        ("default", rp._CT_INTENT_CAP, rp._CT_CLAIM_SLOTS),
        ("small_slots", rp._CT_INTENT_CAP, CHECK_SLOTS),
        ("small_slots_cap", CHECK_CAP, CHECK_SLOTS),
    ):
        h, i = kernels.CHURN_COMPACT(out, pool, picks, valid, cap, slots)
        ph, pi = rp._churn_compact(plain, flows, valid, cap, slots)
        err_compact = max(err_compact, int_err(h, ph, True),
                          int_err(i, pi, True))
        headers[label] = h.cpu().numpy().view(np.uint32).tolist()
        if intents is None:
            intents = i
    # CT_DELTA on the first round's delta of the default compaction
    ct = copy.deepcopy(w.ct)
    index = CTBucketIndex(ct)
    snap = ct_snapshot_to(index.full_snapshot(), "cuda")
    ref = copy.deepcopy(snap)
    packed = rp._fetch_intents(intents, headers["default"][0])
    created, deleted = dp.apply_ct_writeback_host(
        ct, packed[0].astype(bool), packed[1].astype(bool),
        *(packed[j] for j in range(2, 10)), orig_daddr=packed[10],
        orig_dport=packed[11], now=0)
    idx, rows, _ = index.apply(created, deleted)
    idx_t = torch.from_numpy(idx).cuda()
    rows_t = torch.from_numpy(rows.view(np.int32)).cuda()
    kernels.CT_DELTA(snap, idx_t, rows_t)
    apply_bucket_delta_plain(ref, idx_t, rows_t)
    mirror = torch.from_numpy(index.full_snapshot().buckets.view(np.int32))
    err_delta = max(int_err(snap.buckets, ref.buckets, True),
                    int_err(snap.buckets.cpu(), mirror, True))
    # a delta whose indices leave the table, on copies: -1 and -n count
    # from the end once, n, n + 3 and -n - 1 drop their rows (jax's
    # scatter rules), a duplicate carries the same row
    n = int(snap.buckets.shape[0])
    edge = torch.tensor([2, -1, n, 5, -n, n + 3, 2, -n - 1, n - 2],
                        dtype=torch.int32, device="cuda")
    erows = torch.randint(-2**31, 2**31 - 1, (edge.numel(), rows_t.shape[1]),
                          generator=gen, device="cuda", dtype=torch.int32)
    erows[6] = erows[0]
    snap_e, ref_e = copy.deepcopy(snap), copy.deepcopy(snap)
    kernels.CT_DELTA(snap_e, edge, erows)
    apply_bucket_delta_plain(ref_e, edge, erows)
    torch.cuda.synchronize()
    err_edge = int_err(snap_e.buckets, ref_e.buckets, True)
    changed = int((snap_e.buckets != snap.buckets).any(dim=1).sum())
    if not (torch.equal(snap_e.buckets[n - 1], erows[1])
            and torch.equal(snap_e.buckets[0], erows[4])):
        err_edge = max(err_edge, 1)
    del snap_e, ref_e
    phase("churn_check_kernels", t, batch=CHURN_BATCH, valid=valid,
          step_max_abs_err=err_step, compact_max_abs_err=err_compact,
          delta_max_abs_err=err_delta, headers=headers,
          delta_rows=int(idx.size), created=len(created),
          deleted=len(deleted), edge_delta_max_abs_err=err_edge,
          edge_delta_indices=edge.tolist(), edge_rows_changed=changed)
    err_delta = max(err_delta, err_edge)
    if err_step or err_compact or err_delta:
        raise SystemExit("churn_check: a kernel differs from its plain version")
    n_def, _, _, rem_def = headers["default"]
    _, _, _, rem_small = headers["small_slots"]
    n_cut, _, _, rem_cut = headers["small_slots_cap"]
    if not (n_def > 0 and rem_small > 0 and n_cut == CHECK_CAP
            and rem_cut > rem_small):
        raise SystemExit(f"churn_check: collisions, true losers or the cap "
                         f"cut did not occur: {headers}")

    # 2 batches of the loop: kernels, then the plain versions
    t = time.perf_counter()
    rng = np.random.default_rng(78)
    picks_np = rng.integers(0, pool.shape[1], 2 * CHURN_BATCH).astype(
        np.uint32)
    maps = [pinned_ct(w.ct), pinned_ct(w.ct)]
    reset_counts(kernels)
    s_k = rp.replay_pool(tables, dict(w.pool), picks_np, CHURN_BATCH,
                         ct_map=maps[0], device="cuda")
    launched = {k.name: k.launches for k in kernels.KERNELS}
    with PlainRoute(kernels, churn_plain()):
        s_p = rp.replay_pool(tables, dict(w.pool), picks_np, CHURN_BATCH,
                             ct_map=maps[1], device="cuda")
    torch.cuda.synchronize()
    same = same_loops(maps, (s_k, s_p))
    phase("churn_check_loop", t, batches=2, stats=stats_fields(s_k),
          launches=launched, ct_entries=len(maps[0].entries),
          equal_to_plain=same)
    step_n = launched[kernels.DATAPATH_STEP.name]
    if not same or step_n != s_k.rounds or launched[
            kernels.CHURN_COMPACT.name] != s_k.rounds or not launched[
            kernels.CT_DELTA.name]:
        raise SystemExit("churn_check: the loop on the kernels differs from "
                         "the plain loop, or a kernel did not launch")

    # 2 batches of int picks: the picks drawn by PICK_DRAW and by the
    # plain draw are the reference's threefry numbers, so both loops
    # take the same flows
    t = time.perf_counter()
    maps = [pinned_ct(w.ct), pinned_ct(w.ct)]
    reset_counts(kernels)
    s_k = rp.replay_pool(tables, dict(w.pool), 2 * CHURN_BATCH, CHURN_BATCH,
                         ct_map=maps[0], device="cuda")
    drawn = kernels.PICK_DRAW.launches
    with PlainRoute(kernels, churn_plain()):
        s_p = rp.replay_pool(tables, dict(w.pool), 2 * CHURN_BATCH,
                             CHURN_BATCH, ct_map=maps[1], device="cuda")
    torch.cuda.synchronize()
    same_int = same_loops(maps, (s_k, s_p))
    phase("churn_check_int_picks", t, batches=2, stats=stats_fields(s_k),
          pick_draw_launches=drawn, ct_entries=len(maps[0].entries),
          equal_to_plain=same_int)
    if not same_int or drawn != 2 or kernels.PICK_DRAW.launches != 2:
        raise SystemExit("churn_check: the int-pick loop on the kernels "
                         "differs from the plain loop")
    return dict(pool=pool, picks=picks, out=out, flows=flows, plain=plain,
                valid=valid, snap=snap, idx=idx_t, rows=rows_t,
                err=max(err_step, err_compact, err_delta))


def churn_phase(kernels, w, tables) -> dict:
    """Bench's shape: a seed pass of 2 x 2,097,152 int picks, then the
    timed pass of 4 x 2,097,152 on the same CT; the launch counts cover
    both.  Ends with the resident snapshot against the host mirror."""
    from cilium_tpu_torch import replay as rp

    t = time.perf_counter()
    ct = copy.deepcopy(w.ct)
    pool = dict(w.pool)
    before = len(ct.entries)
    reset_counts(kernels)
    seed = rp.replay_pool(tables, pool, 2 * CHURN_BATCH, CHURN_BATCH,
                          ct_map=ct)
    timed = rp.replay_pool(tables, pool, 4 * CHURN_BATCH, CHURN_BATCH,
                           ct_map=ct)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in kernels.KERNELS}
    index, snap, _ = ct._device_churn_cache
    full = index.full_snapshot()
    mirror_err = max(
        int_err(snap.buckets.cpu(), torch.from_numpy(
            full.buckets.view(np.int32)), True),
        int_err(snap.stash.cpu(), torch.from_numpy(
            full.stash.view(np.int32)), True),
    )
    for name, st in (("seed", seed), ("timed", timed)):
        print(f"  churn {name} " + json.dumps(dict(
            stats_fields(st), reruns=st.reruns, seconds=st.seconds,
            fold_seconds=st.fold_seconds,
            tuples_per_s=st.verdicts_per_sec)), flush=True)
    rounds = seed.rounds + timed.rounds
    phase("churn", t, tuples_per_s=round(timed.verdicts_per_sec),
          seconds=round(timed.seconds, 6),
          ct_created=seed.ct_created + timed.ct_created,
          ct_deleted=seed.ct_deleted + timed.ct_deleted,
          ct_entries_before=before, ct_entries_after=len(ct.entries),
          insert_failures=ct.insert_failures, rounds=rounds,
          reruns=seed.reruns + timed.reruns, launches=counts,
          snapshot_vs_mirror_err=mirror_err)
    # one PICK_DRAW a batch: the int picks are drawn on the card
    others = [k.name for k in kernels.KERNELS if k.launches and k not in (
        kernels.DATAPATH_STEP, kernels.CHURN_COMPACT, kernels.CT_DELTA,
        kernels.PICK_DRAW)]
    if (counts[kernels.DATAPATH_STEP.name] != rounds
            or counts[kernels.CHURN_COMPACT.name] != rounds
            or counts[kernels.PICK_DRAW.name] != seed.batches + timed.batches
            or not counts[kernels.CT_DELTA.name] or others):
        raise SystemExit(f"churn: launches {counts} for {rounds} rounds")
    if mirror_err or timed.total != 4 * CHURN_BATCH:
        raise SystemExit("churn: the snapshot differs from the host mirror")
    return dict(ct=ct, pool=pool, counts=counts, timed=timed)


def churn_trace(tables, run) -> None:
    """torch.profiler over one pass of 4 batches on the churned CT."""
    from cilium_tpu_torch import replay as rp

    t = time.perf_counter()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        st = rp.replay_pool(tables, run["pool"], 4 * CHURN_BATCH,
                            CHURN_BATCH, ct_map=run["ct"])
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t1) * 1e3
    busy = device_busy(prof)
    busy_ms = sum(busy.values())
    for key, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  device {ms:.3f} ms  {key[:90]}", flush=True)
    # the profiler slows the host's side of every round; the timed pass
    # ran the same work (4 batches, same CT) untraced
    untraced_ms = run["timed"].seconds * 1e3
    phase("churn_trace", t, batches=4, rounds=st.rounds,
          intents=st.intents, wall_ms=round(traced_ms, 3),
          device_busy_ms=round(busy_ms, 3),
          device_idle_share=round(1 - busy_ms / traced_ms, 4),
          untraced_wall_ms=round(untraced_ms, 3),
          untraced_idle_share=round(1 - busy_ms / untraced_ms, 4),
          fold_host_s=round(st.fold_seconds, 6))


def churn_timing(kernels, tables, chk, counts) -> list:
    """Each churn kernel alone at full width: CUDA events over 20 warm
    launches, its plain version, its bound (the bytes this run's data
    needs, each read or written once, at 3.35 TB/s), and for CT_DELTA
    the one PyTorch call that computes the same function."""
    from cilium_tpu_torch import replay as rp
    from cilium_tpu_torch.ct.device import apply_bucket_delta_plain
    from cilium_tpu_torch.engine import datapath as dp

    t = time.perf_counter()
    pool, picks, out, flows = chk["pool"], chk["picks"], chk["out"], \
        chk["flows"]
    b = int(picks.numel())
    # DATAPATH_STEP: picks and columns streamed, each distinct pool row
    # and table row read once; as the churn loop calls it (the pool's
    # row-major copy kept), CUDA events and device ms queued behind a spin
    pool_rows = dp.pool_rows_of(pool)
    step_calls = {
        "churn": lambda: kernels.DATAPATH_STEP(tables, pool, picks,
                                               pool_rows=pool_rows)}
    step_times = {}
    for name in list(step_calls) + list(step_calls)[::-1]:
        step_times.setdefault(f"{name}_ms", []).append(
            event_ms(step_calls[name], 20))
        step_times.setdefault(f"{name}_device_ms", []).append(
            spun_ms(queued_ms, step_calls[name], "churn_timing"))
    step_times = {k: float(np.median(v)) for k, v in step_times.items()}
    step_ms = step_times["churn_ms"]
    step_plain = event_ms(lambda: dp.datapath_step_plain(
        tables, dp.flow_batch_from_packed(pool[:, picks.long()])), 3)
    rows_b, gathered = table_row_bytes(
        tables, kernels.datapath_reads(tables) + (("policy", "id_table"),),
        lambda: dp.datapath_step_plain(tables, flows))
    distinct = int(torch.unique(picks).numel())
    step_bytes = b * (4 + out_bytes_per_flow(dp)) + distinct * 32 + rows_b
    # integer operations, counted low as for the pair (flow_ops)
    per_flow, egress_ops = flow_ops(tables)
    not_in = int((flows.direction != 0).sum())
    step_ops = per_flow * b + egress_ops * not_in
    # CHURN_COMPACT: every row's flags, allowed byte and proxy port; a
    # flagged row's final address and port, pick and pool words; a
    # winner's rev_nat and slave; the intents and header written
    valid = chk["valid"]
    compact_ms = event_ms(lambda: kernels.CHURN_COMPACT(
        out, pool, picks, valid, rp._CT_INTENT_CAP, rp._CT_CLAIM_SLOTS), 20)
    compact_plain = event_ms(lambda: rp._churn_compact(
        chk["plain"], flows, valid), 3)
    in_valid = torch.arange(b, device="cuda") < valid
    flag = (out.ct_create | out.ct_delete) & in_valid
    header, _ = kernels.CHURN_COMPACT(out, pool, picks, valid,
                                      rp._CT_INTENT_CAP, rp._CT_CLAIM_SLOTS)
    n_flag = int(flag.sum())
    winners = int(header[0])
    flag_rows = int(torch.unique(picks[flag]).numel())
    compact_bytes = (7 * b + 12 * n_flag + 24 * flag_rows + 8 * winners
                     + 12 * 4 * rp._CT_INTENT_CAP + 16)
    compact_ops = 4 * b + 16 * 4 * n_flag  # flag tests; 4 hashed words
    # CT_DELTA: the first round's padded delta (its pow2 padding repeats
    # the first changed bucket with the same row), device ms queued behind
    # a spin with the caller's CUDA events beside, as the scatters; the
    # parent's kernel (--ab-parent) and index_copy_ the yardsticks.  The
    # function needs the M indices and each distinct bucket's row read and
    # written once.
    snap, idx, rows = chk["snap"], chk["idx"], chk["rows"]
    idx64 = idx.long()
    calls = {"new": lambda: kernels.CT_DELTA(snap, idx, rows),
             "library": lambda: snap.buckets.index_copy_(0, idx64, rows)}
    if "churn" in AB["libs"]:
        calls["parent"] = lambda: parent_ct_delta(kernels, snap, idx, rows)
    launches = kernels.CT_DELTA.launches
    delta = {f"{who}_{m}": [] for who in calls for m in ("ms", "events_ms")}
    for who in list(calls) + list(calls)[::-1]:
        delta[f"{who}_ms"].append(spun_ms(queued_ms, calls[who], "ct_delta"))
        delta[f"{who}_events_ms"].append(event_ms(calls[who], 20))
    kernels.CT_DELTA.launches = launches
    delta = {k: float(np.median(v)) for k, v in delta.items()}
    delta_ms, library_ms = delta["new_ms"], delta["library_ms"]
    delta_plain = event_ms(lambda: apply_bucket_delta_plain(snap, idx, rows),
                           20)
    # DATAPATH_STEP of the parent's csrc/datapath.cu (--ab-parent; its
    # kernel reads the planar pool, and pool_rows shares its word with
    # the pair kernels' flows, which its step never reads)
    step_ab = library_ab(kernels, "datapath", step_calls)
    m = int(idx.numel())
    m_distinct = int(torch.unique(idx).numel())
    delta_bytes = m * 4 + 2 * m_distinct * rows.shape[1] * 4
    bounds = {name: nb / HBM_BYTES_PER_S * 1e3 for name, nb in (
        ("step", step_bytes), ("compact", compact_bytes),
        ("delta", delta_bytes))}
    bounds_ops = {name: n / OPS_PER_S * 1e3 for name, n in (
        ("step", step_ops), ("compact", compact_ops))}
    phase("churn_timing", t, step_ms=round(step_ms, 4),
          step_plain_ms=round(step_plain, 4), step_bytes=step_bytes,
          step_row_bytes_per_flow=round(gathered / b, 2),
          compact_ms=round(compact_ms, 4),
          compact_plain_ms=round(compact_plain, 4),
          compact_bytes=compact_bytes, flagged=n_flag, winners=winners,
          delta_ms=round(delta_ms, 4), delta_plain_ms=round(delta_plain, 4),
          delta_library_ms=round(library_ms, 4),
          delta_times=json.dumps({k: round(v, 4) for k, v in delta.items()}),
          step_times=json.dumps({k: round(v, 4)
                                 for k, v in step_times.items()}),
          step_ab=json.dumps(step_ab and step_ab["medians"]), delta_rows=m,
          delta_rows_distinct=m_distinct,
          delta_bytes=delta_bytes, step_ops=step_ops,
          compact_ops=compact_ops,
          bound_bytes_ms={k: round(v, 4) for k, v in bounds.items()},
          bound_ops_ms={k: round(v, 4) for k, v in bounds_ops.items()})
    err = chk["err"]
    src = "cilium_tpu_torch/csrc/"
    rows_out = [
        kernel_row(kernels.DATAPATH_STEP, src + "datapath.cu",
                   "cilium_tpu/engine/datapath.py:604",
                   counts[kernels.DATAPATH_STEP.name], err, step_ms,
                   step_plain, bounds["step"], bounds_ops["step"]),
        kernel_row(kernels.CHURN_COMPACT, src + "churn.cu",
                   "cilium_tpu/replay.py:65",
                   counts[kernels.CHURN_COMPACT.name], err, compact_ms,
                   compact_plain, bounds["compact"], bounds_ops["compact"]),
        kernel_row(kernels.CT_DELTA, src + "churn.cu",
                   "cilium_tpu/ct/device.py:536",
                   counts[kernels.CT_DELTA.name], err, delta_ms, delta_plain,
                   bounds["delta"], 0.0, library_ms),
    ]
    rows_out[2].update(events_ms=delta["new_events_ms"],
                       library_events_ms=delta["library_events_ms"],
                       parent_ms=delta.get("parent_ms"),
                       parent_events_ms=delta.get("parent_events_ms"))
    rows_out[0].update(ptxas=STEP_PTXAS,
                       device_ms=step_times["churn_device_ms"])
    if step_ab is not None:
        rows_out[0]["ab"] = step_ab["medians"]
    return rows_out


# -- the churn loop's pick draw (PICK_DRAW) --------------------------------------


def prng_check(kernels, w, counts) -> dict:
    """PICK_DRAW against the plain draw, bit for bit, on CHURN_BATCH
    picks for PICK_KEYS batch keys (PRNGKey(len(ct) ^ n) folded with
    batches 0..3), with P the pool's rows and PICK_SPAN_WRAP (where
    randint's u32 square wraps to 0); then its time beside its bound
    (4 B a pick written, or its operations counted low) and the time of
    torch.randint on the same shape, which draws other numbers (a time
    only, not the same function).  `counts` are the churn path's
    launches."""
    from cilium_tpu_torch import prng

    t = time.perf_counter()
    n_pool = len(w.pool["saddr"])
    base = prng.prng_key(len(w.ct.entries) ^ (4 * CHURN_BATCH))
    keys = [prng.fold_in(base, b) for b in range(PICK_KEYS)]
    errs = {}
    for span in (n_pool, PICK_SPAN_WRAP):
        errs[span] = max(
            int_err(prng.randint_u32(key, CHURN_BATCH, span),
                    prng.randint_u32_plain(key, CHURN_BATCH, span, "cuda"),
                    True)
            for key in keys)
    first = prng.randint_u32(keys[0], CHURN_BATCH, n_pool)
    spread = int(torch.unique(first).numel())
    sub = prng.split(keys[0])
    ms = event_ms(lambda: kernels.PICK_DRAW(sub, CHURN_BATCH, n_pool, "cuda"),
                  20)
    plain_ms = event_ms(lambda: prng.pick_draw_plain(sub, CHURN_BATCH, n_pool,
                                                     "cuda"), 3)
    library_ms = event_ms(lambda: torch.randint(
        0, n_pool, (CHURN_BATCH,), device="cuda", dtype=torch.int32), 20)
    out_bytes = 4 * CHURN_BATCH
    # two threefry2x32 a pick: 20 rounds of add, rotate (two shifts and
    # an or) and xor, 5 key injections of 3 adds; then 3 remainders, a
    # multiply and an add
    ops = CHURN_BATCH * (2 * (20 * 5 + 5 * 3) + 5)
    bb = out_bytes / HBM_BYTES_PER_S * 1e3
    bo = ops / OPS_PER_S * 1e3
    phase("prng_check", t, picks=CHURN_BATCH, keys=PICK_KEYS,
          max_abs_err=errs, distinct_picks=spread, ms=round(ms, 4),
          plain_ms=round(plain_ms, 4), library_ms=round(library_ms, 4),
          bytes=out_bytes, ops=ops, bound_bytes_ms=round(bb, 6),
          bound_ops_ms=round(bo, 6))
    if any(errs.values()) or spread < n_pool // 2:
        raise SystemExit(f"prng_check: PICK_DRAW differs from the plain draw "
                         f"{errs}, or draws {spread} distinct picks")
    return kernel_row(kernels.PICK_DRAW, "cilium_tpu_torch/csrc/prng.cu",
                      "cilium_tpu/replay.py:231", counts[kernels.PICK_DRAW.name],
                      max(errs.values()), ms, plain_ms, bb, bo, library_ms)


# -- the tuple-level lattice (configs 1, 2 and config 5's lattice line) --------


def lattice_plain(tables, batch, counters=False, lpm=None, src_ips=None):
    """LATTICE's plain version, called as the kernel is."""
    from cilium_tpu_torch.engine import verdict as vd
    from cilium_tpu_torch.ipcache.lpm import lpm_lookup_plain

    ids = None if lpm is None else lpm_lookup_plain(lpm, src_ips)
    return vd._lattice_plain(tables, batch, identity=ids, counters=counters)


def verdicts_err(got, want) -> int:
    return max(int_err(getattr(got, c), getattr(want, c))
               for c in ("allowed", "proxy_port", "match_kind"))


def lattice_setup(w, tables, wide_t) -> dict:
    """The lattice worlds on the card: config 5's policy tables (compact
    and wide) with bench's lattice tuples; config 1 (hashed hot plane,
    and dense without the hash) with its batch, and its distribution at
    CONFIG1_DENSE_TUPLES; config 2's policy, DIR-24-8 tables and batches
    drawn in bench.py config2's order (100,000 tuples, the 512 oracle
    rows, 1,048,576 tuples); config 5's ipcache as DIR-24-8
    (build_lpm(w.ipc_map)) with 1,048,576 of the pool's peer
    addresses; 4,194,304 of bench's tuples drawn Zipf(1.1) from
    65,536 (memo_zipf_tuples: a few hot counter cells); and the first
    batch of config 5's record replay (replay_lattice_phase's records
    and batch, as replay.read_batches decodes them)."""
    from cilium_tpu_torch import replay as rp
    from cilium_tpu_torch import world
    from cilium_tpu_torch.compiler.tables import split_hot
    from cilium_tpu_torch.convert import lpm_to, policy_tables_to
    from cilium_tpu_torch.engine.verdict import TupleBatch
    from cilium_tpu_torch.ipcache.lpm import build_lpm

    t = time.perf_counter()
    ex = world.example_world()
    ex_big = world.example_world(batch=CONFIG1_DENSE_TUPLES)
    pol1 = ex.policy_tables()
    dense1 = dataclasses.replace(pol1, **{k: None for k in (
        "l4_hash_rows", "l4_hash_stash", "l4_wild_rows", "l4_wild_stash")})
    cw = world.cidr_world()
    src_s, cols_s = cw.make_cidr_batch(CIDR_TUPLES)
    sample = cw.rng.integers(0, CIDR_TUPLES, size=ORACLE_ROWS)
    src_b, cols_b = cw.make_cidr_batch(CIDR_BIG)
    pool = w.pool
    rows = np.random.default_rng(43).integers(0, len(pool["direction"]),
                                              CIDR_BIG)
    peer = np.where(pool["direction"] == 0, pool["saddr"], pool["daddr"])
    u = dict(
        c5=TupleBatch.from_numpy(**world.lattice_tuples(w, LATTICE_TUPLES),
                                 device="cuda"),
        c5_zipf=TupleBatch.from_numpy(
            **memo_zipf_tuples(w, LATTICE_TUPLES, 61), device="cuda"),
        c5_replay=next(rp.read_batches(
            world.lattice_records(w, REPLAY_BATCH, seed=31), REPLAY_BATCH,
            device="cuda"))[0],
        c5_policy=tables.policy, c5_wide=wide_t.policy,
        ex=ex, c1=policy_tables_to(split_hot(pol1), "cuda"),
        c1_batch=TupleBatch.from_numpy(**ex.tuples, device="cuda"),
        c1_dense=policy_tables_to(dense1, "cuda"),
        c1_big=TupleBatch.from_numpy(**ex_big.tuples, device="cuda"),
        cw=cw, c2=policy_tables_to(split_hot(cw.policy_tables()), "cuda"),
        c2_lpm=lpm_to(build_lpm(cw.ipc_map), "cuda"),
        c2_small=(src_s, cols_s,
                  torch.from_numpy(src_s.view(np.int32)).cuda(),
                  TupleBatch.from_numpy(**cols_s, device="cuda")),
        c2_sample=sample,
        c2_big=(src_b, cols_b,
                torch.from_numpy(src_b.view(np.int32)).cuda(),
                TupleBatch.from_numpy(**cols_b, device="cuda")),
        c5_lpm=lpm_to(build_lpm(w.ipc_map), "cuda"),
        c5_ips=torch.from_numpy(
            peer[rows].astype(np.uint32).view(np.int32)).cuda(),
    )
    torch.cuda.synchronize()
    phase("lattice_setup", t, c5_tuples=LATTICE_TUPLES,
          c1_identities=len(ex.identity_ids),
          c1_l4_hash_rows=tuple(u["c1"].l4_hash_rows.shape),
          c2_prefixes=len(cw.ipc_map), c2_blocks=int(u["c2_lpm"].l2.shape[0]),
          c5_lpm_blocks=int(u["c5_lpm"].l2.shape[0]),
          c5_policy_identities=int(tables.policy.id_table.shape[0]))
    return u


def lattice_modes(u) -> dict:
    """LATTICE's modes at this run's shapes: (tables, batch, kwargs)."""
    ip = dict(lpm=u["c2_lpm"], src_ips=u["c2_big"][2])
    return {
        "c5_zipf_counters": (u["c5_policy"], u["c5_zipf"],
                             {"counters": True}),
        "c5_compact": (u["c5_policy"], u["c5"], {}),
        "c5_compact_counters": (u["c5_policy"], u["c5"], {"counters": True}),
        "c5_wide": (u["c5_wide"], u["c5"], {}),
        "c5_wide_counters": (u["c5_wide"], u["c5"], {"counters": True}),
        "c5_replay_counters": (u["c5_policy"], u["c5_replay"],
                               {"counters": True}),
        "c1_dense": (u["c1_dense"], u["c1_big"], {}),
        "c1_dense_counters": (u["c1_dense"], u["c1_big"], {"counters": True}),
        "c2_ip": (u["c2"], u["c2_big"][3], ip),
        "c2_ip_counters": (u["c2"], u["c2_big"][3], dict(ip, counters=True)),
    }


LATTICE_CASE_TUPLES = 20_000
LATTICE_CASE_PAD = 2048  # stash rows past csrc/lattice.cu's 16 KB staged


def lattice_case_tables():
    """world.stash_world's policy (hashed L4 rows of two entries: both
    stashes used): {layout: host PolicyTables} for "wide", "compact" and
    "dense" (no hash), and "wide_pad", "compact_pad" with both stashes
    padded by LATTICE_CASE_PAD empty rows (past the shared memory
    LATTICE stages, so read where they lie); and the world."""
    from cilium_tpu_torch import world

    w, tabs = world.stash_world()
    tabs["dense"] = dataclasses.replace(tabs["wide"], **{k: None for k in (
        "l4_hash_rows", "l4_hash_stash", "l4_wild_rows", "l4_wild_stash")})
    for name, empty in (("wide", (0, M32, 0)), ("compact", (0, 1 << 31))):
        pad = np.tile(np.asarray(empty, np.uint32), (LATTICE_CASE_PAD, 1))
        tabs[f"{name}_pad"] = dataclasses.replace(tabs[name], **{
            k: np.concatenate([np.asarray(getattr(tabs[name], k)), pad])
            for k in ("l4_hash_stash", "l4_wild_stash")})
    return tabs, w


def lattice_cases_check(kernels) -> dict:
    """LATTICE against its plain version on lattice_case_tables' world:
    LATTICE_CASE_TUPLES of bench's tuples, edge words in the first 16
    (routed_edge_cols: identities past id_direct's regions, negative and
    huge endpoints and directions, dports past 65,535), then one tuple a
    used stash entry of the wide and the compact tables
    (world.stash_tuples), and one in 7 fragments; in each layout (wide,
    compact, dense, and wide and compact with the padded stashes), with
    and without counters, and in IP mode (world.identity_addresses: the
    world's identities at /32s through DIR-24-8, the edge identities at
    an address it misses).  {case: differing entries}, and the stash
    rows."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.convert import lpm_to, policy_tables_to
    from cilium_tpu_torch.engine.verdict import TupleBatch
    from cilium_tpu_torch.ipcache.lpm import build_lpm

    tabs, w = lattice_case_tables()
    cols = routed_edge_cols(world.lattice_tuples(w, LATTICE_CASE_TUPLES,
                                                 seed=3))
    at = 16
    for name in ("wide", "compact"):
        st = world.stash_tuples(tabs[name], 4)
        n = len(st["dport"])
        for k, v in st.items():
            if k in cols:
                cols[k][at:at + n] = v
        at += n
    cols["is_fragment"] = (np.arange(LATTICE_CASE_TUPLES) % 7 == 3
                           ).astype(np.int64)
    cidrs, src = world.identity_addresses(w.identity_ids, cols["identity"])
    ip = dict(lpm=lpm_to(build_lpm(cidrs), "cuda"),
              src_ips=torch.from_numpy(src.view(np.int32)).cuda())
    batch = TupleBatch.from_numpy(**cols, device="cuda")
    launches = kernels.LATTICE.launches
    errs = {}
    for name, host in tabs.items():
        tab = policy_tables_to(host, "cuda")
        modes = [({}, ""), ({"counters": True}, "_counters")]
        if name != "dense":
            modes += [(dict(ip), "_ip"), (dict(ip, counters=True),
                                          "_ip_counters")]
        for kw, tag in modes:
            v, acc = kernels.LATTICE(tab, batch, **kw)
            pv, pacc = lattice_plain(tab, batch, **kw)
            err = verdicts_err(v, pv)
            if acc is not None:
                err = max(err, int_err(acc, pacc, True))
            errs[name + tag] = err
        del tab
    torch.cuda.synchronize()
    kernels.LATTICE.launches = launches
    return dict(errs=errs, stash_tuples=at - 16, stash_rows={
        n: [int(tabs[n].l4_hash_stash.shape[0]),
            int(tabs[n].l4_wild_stash.shape[0])]
        for n in ("wide", "compact", "wide_pad", "compact_pad")})


def lattice_check(kernels, u) -> int:
    """LATTICE in every mode and LPM_LOOKUP on both DIR-24-8 tables,
    each against its plain version on the same inputs, and LATTICE on
    lattice_cases_check's stash-heavy world: 0 differences."""
    from cilium_tpu_torch.ipcache.lpm import lpm_lookup_plain

    t = time.perf_counter()
    errs = {}
    for name, (tab, batch, kw) in lattice_modes(u).items():
        v, acc = kernels.LATTICE(tab, batch, **kw)
        pv, pacc = lattice_plain(tab, batch, **kw)
        err = verdicts_err(v, pv)
        if acc is not None:
            err = max(err, int_err(acc, pacc, True))
        errs[name] = err
        del v, acc, pv, pacc
    for name, lpm, ips in (("lpm_c2", u["c2_lpm"], u["c2_big"][2]),
                           ("lpm_c5", u["c5_lpm"], u["c5_ips"])):
        errs[name] = int_err(kernels.LPM_LOOKUP(lpm, ips),
                             lpm_lookup_plain(lpm, ips), True)
    torch.cuda.synchronize()
    cases = lattice_cases_check(kernels)
    errs.update({f"case_{k}": v for k, v in cases["errs"].items()})
    phase("lattice_check", t, max_abs_err=errs,
          case_stash_tuples=cases["stash_tuples"],
          case_stash_rows=json.dumps(cases["stash_rows"]))
    if any(errs.values()):
        raise SystemExit(f"lattice_check: a kernel differs from its plain "
                         f"version: {errs}")
    return max(errs.values())


def lattice_phase(kernels, u) -> int:
    """bench.py's lattice_verdicts_per_sec_per_chip: 8 calls of
    evaluate_batch on config 5's 4,194,304 tuples already on the card."""
    from cilium_tpu_torch.engine.verdict import evaluate_batch

    tab, batch = u["c5_policy"], u["c5"]
    evaluate_batch(tab, batch)
    torch.cuda.synchronize()
    reset_counts(kernels)
    t = time.perf_counter()
    outs = [evaluate_batch(tab, batch) for _ in range(LATTICE_CALLS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = kernels.LATTICE.launches
    kinds = torch.bincount(outs[0].match_kind.long(), minlength=5).tolist()
    phase("lattice", t, calls=LATTICE_CALLS, tuples=LATTICE_TUPLES,
          launches=launches, wall_ms=round(wall * 1e3, 4),
          verdicts_per_s=round(LATTICE_CALLS * LATTICE_TUPLES / wall),
          allowed=int(outs[0].allowed.sum()),
          redirected=int((outs[0].proxy_port > 0).sum()), match_kinds=kinds)
    if launches != LATTICE_CALLS or any(
            not torch.equal(o.allowed, outs[0].allowed) for o in outs):
        raise SystemExit(f"lattice: {launches} launches or unstable output")
    return launches


def replay_oracle(states, rec, v) -> int:
    """Mismatches of sampled records (their columns in `rec`, their
    verdicts in `v`) against policy_can_access, hits not counted."""
    from cilium_tpu_torch.engine.oracle import policy_can_access

    got = [getattr(v, c).cpu().numpy()
           for c in ("allowed", "proxy_port", "match_kind")]
    bad = 0
    for k in range(len(rec["ep_id"])):
        want = policy_can_access(
            states[int(rec["ep_id"][k])], int(rec["identity"][k]),
            int(rec["dport"][k]), int(rec["proto"][k]),
            int(rec["direction"][k]), bool(rec["is_fragment"][k]),
            count_hits=False)
        bad += int((bool(got[0][k]), int(got[1][k]), int(got[2][k])) != (
            want.allowed, want.proxy_port, want.match_kind))
    return bad


def replay_lattice_phase(kernels, w, u) -> int:
    """Config 5's record replay (the north star's path): 10,000,000
    records of lattice_records against the 50k-rule tables in batches
    of 1,048,576 with counters; its first 2 batches again on the kernel
    and on the plain version; 512 sampled records through
    evaluate_batch against the oracle; a traced run of 2 batches."""
    from cilium_tpu_torch import replay as rp
    from cilium_tpu_torch import world
    from cilium_tpu_torch.engine.verdict import TupleBatch, evaluate_batch
    from cilium_tpu_torch.native.loader import (
        FLOW_RECORD_DTYPE,
        decode_flow_records,
    )

    t = time.perf_counter()
    buf = world.lattice_records(w, REPLAY_RECORDS, seed=31)
    build_s = time.perf_counter() - t
    tab = u["c5_policy"]
    torch.cuda.synchronize()
    reset_counts(kernels)
    st, l4, l3 = rp.replay_lattice(tab, buf, REPLAY_BATCH)
    torch.cuda.synchronize()
    launches = kernels.LATTICE.launches
    others = {k.name: k.launches for k in kernels.KERNELS if k.launches
              and k is not kernels.LATTICE}
    n = st.total
    phase("replay_lattice", t, records=n, batches=st.batches,
          launches=launches, seconds=st.seconds,
          records_per_s=round(n / st.seconds),
          allowed_share=round(st.allowed / n, 6),
          denied_share=round(st.denied / n, 6),
          redirected_share=round(st.redirected / n, 6),
          l4_hits=int(l4.sum()), l3_hits=int(l3.sum()),
          host_spans_s={k: round(v, 6) for k, v in st.spans.items()},
          records_build_s=round(build_s, 3))
    if (launches != st.batches or others or n != REPLAY_RECORDS
            or not 0 < st.allowed < n or st.redirected == 0):
        raise SystemExit(f"replay_lattice: launches {launches} for "
                         f"{st.batches} batches, others {others}, stats {st}")

    # the first 2 batches on the kernel and on the plain version
    t = time.perf_counter()
    head = buf[: 2 * REPLAY_BATCH * FLOW_RECORD_DTYPE.itemsize]
    s_k, k4, k3 = rp.replay_lattice(tab, head, REPLAY_BATCH)
    with PlainRoute(kernels, {"LATTICE": lattice_plain}):
        s_p, p4, p3 = rp.replay_lattice(tab, head, REPLAY_BATCH)
    fields = ("total", "allowed", "denied", "redirected", "batches")
    same = (all(getattr(s_k, f) == getattr(s_p, f) for f in fields)
            and np.array_equal(k4, p4) and np.array_equal(k3, p3))
    # 512 sampled records through evaluate_batch against the oracle
    rec = decode_flow_records(buf)
    rows = np.random.default_rng(44).integers(0, n, ORACLE_ROWS)
    sub = {k: v[rows] for k, v in rec.items()}
    v = evaluate_batch(tab, TupleBatch.from_numpy(
        ep_index=sub["ep_id"].astype(np.int64), identity=sub["identity"],
        dport=sub["dport"], proto=sub["proto"], direction=sub["direction"],
        is_fragment=sub["is_fragment"]))
    bad = replay_oracle(w.states, sub, v)
    phase("replay_lattice_check", t, batches=2, equal_to_plain=same,
          stats={f: getattr(s_k, f) for f in fields},
          oracle_rows=ORACLE_ROWS, oracle_mismatches=bad)
    if not same or bad:
        raise SystemExit("replay_lattice: the kernel loop differs from the "
                         "plain loop, or the oracle disagrees")

    # where the time goes: a traced run of the same 2 batches
    t = time.perf_counter()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        rp.replay_lattice(tab, head, REPLAY_BATCH)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t1) * 1e3
    busy = device_busy(prof)
    busy_ms = sum(busy.values())
    for key, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  device {ms:.3f} ms  {key[:90]}", flush=True)
    phase("replay_lattice_trace", t, batches=2, wall_ms=round(traced_ms, 3),
          untraced_ms=round(s_k.seconds * 1e3, 3),
          device_busy_ms=round(busy_ms, 3),
          device_idle_share=round(1 - busy_ms / traced_ms, 4),
          untraced_idle_share=round(1 - busy_ms / (s_k.seconds * 1e3), 4))
    return launches


# -- the fused record replay (replay(): config 5's north star) --------------------


def forms_flows(w, n: int, seed: int):
    """n config-5 pool flows on the card: n / 2 drawn from the pool's
    ingress rows, then n / 2 from its egress rows.  Returns (the step
    forms' FlowBatch, whose last FORMS_DIR2 rows have direction 2; the
    ingress half; the egress half)."""
    from cilium_tpu_torch import replay as rp
    from cilium_tpu_torch.engine import datapath as dp

    def on_card(words):
        return dp.flow_batch_from_packed(
            torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).cuda())

    rng = np.random.default_rng(seed)
    halves = []
    for d in (0, 1):
        sub = np.nonzero(w.pool["direction"] == d)[0]
        halves.append(sub[rng.integers(0, len(sub), n // 2)])
    words = rp.pack_flow_pool(
        {c: w.pool[c][np.concatenate(halves)] for c in dp.FLOW_COLUMNS})
    split = [on_card(words[:, k * (n // 2):(k + 1) * (n // 2)])
             for k in (0, 1)]
    words[dp.FLOW_COLUMNS.index("direction"), -FORMS_DIR2:] = 2
    return on_card(words), split[0], split[1]


# the single-batch forms: (name, entry point's form, emits sec_id)
STEP_FORMS = (
    ("step", {}, True),
    ("with_counters", {"acc": True}, True),
    ("accum", {"acc": True}, False),
    ("accum_ingress", {"acc": True, "static_dir": 0}, False),
    ("accum_egress", {"acc": True, "static_dir": 1}, False),
    ("telem", {"telem": True}, True),
    ("accum_telem", {"acc": True, "telem": True}, False),
)


def run_form(dp, verdict, tables, flows, name):
    """Form `name` through its entry point (the kernel on the card) and
    its plain version on the same inputs: ((out, acc, telem) of each)."""
    _, form, emit = next(f for f in STEP_FORMS if f[0] == name)
    fresh = lambda: (verdict.make_counter_buffers(tables.policy) + 1
                     if form.get("acc") else None)
    acc_k, acc_p = fresh(), fresh()
    tel_k = tel_p = None
    if form.get("telem"):
        tel_k = verdict.make_telemetry_buffers("cuda") + 2
        tel_p = tel_k.clone()
    static = form.get("static_dir")
    if name == "step":
        got = dp.datapath_step(tables, flows)
    elif name == "with_counters":
        got, l4, l3 = dp.datapath_step_with_counters(tables, flows)
        acc_k = torch.cat([l4, l3], dim=2) + 1
    elif name == "telem":
        got, trow = dp.datapath_step_telem(tables, flows)
        tel_k = trow + 2
    elif name == "accum_telem":
        got, _, _ = dp.datapath_step_accum_telem(tables, flows, acc_k, tel_k)
    else:
        entry = {None: dp.datapath_step_accum,
                 0: dp.datapath_step_accum_ingress,
                 1: dp.datapath_step_accum_egress}[static]
        got, _ = entry(tables, flows, acc_k)
    want = dp.datapath_step_plain(tables, flows, acc=acc_p, telem=tel_p,
                                  emit_sec_id=emit, static_dir=static)
    return (got, acc_k, tel_k), (want, acc_p, tel_p)


def forms_err(dp, k, p) -> int:
    err = compare((k[0],), (p[0],), dp)
    for a, b in zip(k[1:], p[1:]):
        if a is not None:
            err = max(err, buf_err(a, b))
    return err


def forms_check(kernels, w, tables, wide_t) -> dict:
    """Every single-batch form (DATAPATH_STEP) and the unpacked pair
    forms (DATAPATH_PAIR) on the card against their plain versions, on
    FORMS_FLOWS config-5 flows (half ingress, half egress, FORMS_DIR2 of
    them with direction 2), over the headline and the wide tables: the
    15 columns, the counters and the telemetry, 0 differences."""
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import verdict

    t = time.perf_counter()
    flows, f_in, f_eg = forms_flows(w, FORMS_FLOWS, seed=47)
    errs = {}
    for label, tabs in (("compact", tables), ("wide", wide_t)):
        for name, _, _ in STEP_FORMS:
            k, p = run_form(dp, verdict, tabs, flows, name)
            errs[f"{label}_{name}"] = forms_err(dp, k, p)
            del k, p
        for name in ("accum_pair", "accum_pair_telem",
                     "accum_pair_telem_packed4"):
            acc_k = verdict.make_counter_buffers(tabs.policy)
            tel_k = verdict.make_telemetry_buffers("cuda")
            acc_p, tel_p = acc_k.clone(), tel_k.clone()
            if name == "accum_pair":
                ki, ke, _ = dp.datapath_step_accum_pair(tabs, f_in, f_eg,
                                                        acc_k)
                tel_k = tel_p = None
            elif name == "accum_pair_telem":
                ki, ke, _, _ = dp.datapath_step_accum_pair_telem(
                    tabs, f_in, f_eg, acc_k, tel_k)
            else:
                ki, ke, _, _ = dp.datapath_step_accum_pair_telem_packed4(
                    tabs, dp.pack_flow_batch4(f_in), dp.pack_flow_batch4(f_eg),
                    acc_k, tel_k)
            pi, pe = dp._pair_plain(tabs, f_in, f_eg, acc_p, tel_p)
            err = max(compare((ki, ke), (pi, pe), dp), buf_err(acc_k, acc_p))
            if tel_k is not None:
                err = max(err, buf_err(tel_k, tel_p))
            errs[f"{label}_{name}"] = err
    torch.cuda.synchronize()
    dir2 = int((flows.direction == 2).sum())
    phase("forms_check", t, flows=FORMS_FLOWS, direction_2_rows=dir2,
          max_abs_err=errs)
    if any(errs.values()):
        raise SystemExit(f"forms_check: a form differs from its plain "
                         f"version: {errs}")
    return dict(flows=flows, err=max(errs.values()))


def registry_values() -> dict:
    from cilium_tpu_torch import metrics

    return {name: dict(getattr(metrics.registry, name)._values)
            for name in TELEM_METRICS}


def registry_deltas(before, after) -> dict:
    return {name: {"|".join(k): v - before[name].get(k, 0.0)
                   for k, v in after[name].items()
                   if v != before[name].get(k, 0.0)}
            for name in TELEM_METRICS}


def replay_run(tables, buf, batch, **kw):
    """replay() with counters and telemetry, synchronised; returns
    (stats, l4, l3, the registry's increments)."""
    from cilium_tpu_torch import replay as rp

    before = registry_values()
    st, l4, l3 = rp.replay(tables, buf, batch, collect_telemetry=True, **kw)
    torch.cuda.synchronize()
    return st, l4, l3, registry_deltas(before, registry_values())


REPLAY_FIELDS = ("total", "allowed", "denied", "redirected", "batches")


def replay_check(kernels, w, tables, buf) -> int:
    """replay() on the card against the plain loop on the card (every
    DATAPATH_STEP launch routed to its plain version) over the same
    records: stats, u64 counters, telemetry and the metrics registry's
    increments, 0 differences.  Then ORACLE_ROWS sampled pool rows
    through read_flow_batches and datapath_step against
    composed_oracle and its stages, as bench.py's config-5 gate does."""
    from cilium_tpu_torch import replay as rp
    from cilium_tpu_torch import world
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine.hostpath import composed_oracle

    t = time.perf_counter()
    k = replay_run(tables, buf, REPLAY_BATCH)
    with PlainRoute(kernels, {"DATAPATH_STEP": step_plain}):
        p = replay_run(tables, buf, REPLAY_BATCH)
    same = {
        "stats": all(getattr(k[0], f) == getattr(p[0], f)
                     for f in REPLAY_FIELDS),
        "l4": np.array_equal(k[1], p[1]),
        "l3": np.array_equal(k[2], p[2]),
        "telemetry": np.array_equal(k[0].telemetry, p[0].telemetry),
        "registry": k[3] == p[3],
    }
    rows = np.random.default_rng(45).integers(0, len(w.pool["saddr"]),
                                              ORACLE_ROWS)
    flows, _ = next(rp.read_flow_batches(world.pool_records(w, rows),
                                         ORACLE_ROWS))
    out = dp.datapath_step(tables, flows)
    allow, proxy, sec, stages = composed_oracle(
        world.oracle_context(w), w.states, w.pool, list(rows),
        return_stages=True)
    got = {c: getattr(out, c).cpu().numpy() for c in dp.VERDICT_COLUMNS}
    bad = ((got["allowed"] != allow) | (got["proxy_port"] != proxy)
           | (got["sec_id"].view(np.uint32) != sec)
           | (got["pre_dropped"] != stages["pre_drop"])
           | (got["ct_result"] != stages["ct_res"])
           | (got["match_kind"] != stages["match_kind"])
           | (got["ipcache_miss"] != stages["ipcache_miss"])
           | ((got["lb_slave"] > 0) != stages["lb_hit"]))
    phase("replay_check", t, records=k[0].total, batches=k[0].batches,
          equal_to_plain=same, oracle_rows=ORACLE_ROWS,
          oracle_mismatches=int(bad.sum()),
          oracle_lb_hits=int(stages["lb_hit"].sum()),
          oracle_ct_hits=int((stages["ct_res"] != 0).sum()))
    if not all(same.values()) or bad.any():
        raise SystemExit("replay_check: replay() on the card differs from the "
                         "plain loop, or the composed oracle disagrees")
    return 0


def replay_phase(kernels, tables, buf) -> dict:
    """The timed replay of REPLAY_RECORDS records in batches of
    REPLAY_BATCH with counters and telemetry: records/s, spans, stats;
    the launches of this run alone."""
    from cilium_tpu_torch.telemetry import telemetry_summary

    torch.cuda.synchronize()
    reset_counts(kernels)
    t = time.perf_counter()
    st, l4, l3, deltas = replay_run(tables, buf, REPLAY_BATCH)
    launches = kernels.DATAPATH_STEP.launches
    others = {k.name: k.launches for k in kernels.KERNELS
              if k.launches and k is not kernels.DATAPATH_STEP}
    n = st.total
    tel = st.telemetry
    print("  replay telemetry " + json.dumps(telemetry_summary(tel)),
          flush=True)
    phase("replay", t, records=n, batches=st.batches, launches=launches,
          seconds=st.seconds, records_per_s=round(n / st.seconds),
          spans_s={k: round(v, 6) for k, v in st.spans.report().items()},
          allowed=st.allowed, denied=st.denied, redirected=st.redirected,
          l4_hits=int(l4.sum()), l3_hits=int(l3.sum()),
          registry_forward=sum(deltas["forward_count"].values()))
    if (launches != st.batches or others or n != REPLAY_RECORDS
            or not 0 < st.allowed < n or st.redirected == 0
            or int(tel[:, 0].sum()) != n):
        raise SystemExit(f"replay: launches {launches} for {st.batches} "
                         f"batches, others {others}, stats {st}")
    return dict(launches=launches, seconds=st.seconds)


def replay_trace(tables, buf) -> None:
    """torch.profiler over the first REPLAY_HEAD_BATCHES batches of the
    replay: the device's idle share and the top device operations."""
    from cilium_tpu_torch.native.loader import FLOW_RECORD_DTYPE

    t = time.perf_counter()
    head = buf[: REPLAY_HEAD_BATCHES * REPLAY_BATCH
               * FLOW_RECORD_DTYPE.itemsize]
    untraced = replay_run(tables, head, REPLAY_BATCH)[0].seconds * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        replay_run(tables, head, REPLAY_BATCH)
        traced_ms = (time.perf_counter() - t1) * 1e3
    busy = device_busy(prof)
    busy_ms = sum(busy.values())
    for key, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  device {ms:.3f} ms  {key[:90]}", flush=True)
    phase("replay_trace", t, batches=REPLAY_HEAD_BATCHES,
          wall_ms=round(traced_ms, 3), untraced_ms=round(untraced, 3),
          device_busy_ms=round(busy_ms, 3),
          device_idle_share=round(1 - busy_ms / traced_ms, 4),
          untraced_idle_share=round(1 - busy_ms / untraced, 4))


def replay_churn(kernels, w, wide_t) -> dict:
    """replay(ct_map=...) over 2 x REPLAY_CHURN_BATCH records of pool
    rows drawn uniformly (each flow with its own fragment flag, as
    bench.py's encode_pool_sample writes them) on the wide tables: first
    the card against the plain loop on the card (DATAPATH_STEP,
    CHURN_COMPACT and CT_DELTA routed to their plain versions), stats,
    counters, every CT entry and the snapshots, and the snapshot against
    its host mirror; then the timed pass on a fresh copy of the CT, with
    its launches.  (Records that carry one flow both as a fragment and
    not make the reference's churn mode rerun a batch without end: the
    fragment row deletes what the other creates; ROADMAP queue 3.)"""
    from cilium_tpu_torch import replay as rp
    from cilium_tpu_torch import world

    t = time.perf_counter()
    rows = np.random.default_rng(37).integers(0, len(w.pool["saddr"]),
                                              2 * REPLAY_CHURN_BATCH)
    buf = world.pool_records(w, rows)
    maps = [pinned_ct(w.ct), pinned_ct(w.ct)]
    k = rp.replay(wide_t, buf, REPLAY_CHURN_BATCH, ct_map=maps[0])
    with PlainRoute(kernels, churn_plain()):
        p = rp.replay(wide_t, buf, REPLAY_CHURN_BATCH, ct_map=maps[1])
    torch.cuda.synchronize()
    index, snap, _ = maps[0]._device_churn_cache
    full = index.full_snapshot()
    mirror_err = max(
        int_err(snap.buckets.cpu(), torch.from_numpy(
            full.buckets.view(np.int32)), True),
        int_err(snap.stash.cpu(), torch.from_numpy(
            full.stash.view(np.int32)), True))
    same = (same_loops(maps, (k[0], p[0])) and np.array_equal(k[1], p[1])
            and np.array_equal(k[2], p[2]))
    phase("replay_churn_check", t, batches=k[0].batches,
          stats=stats_fields(k[0]), equal_to_plain=same,
          snapshot_vs_mirror_err=mirror_err,
          ct_entries=len(maps[0].entries))
    if not same or mirror_err or k[0].ct_created == 0:
        raise SystemExit("replay_churn: the card differs from the plain loop "
                         "or the snapshot from its mirror")

    ct = copy.deepcopy(w.ct)
    torch.cuda.synchronize()
    reset_counts(kernels)
    t = time.perf_counter()
    st, l4, _ = rp.replay(wide_t, buf, REPLAY_CHURN_BATCH, ct_map=ct)
    torch.cuda.synchronize()
    counts = {kk.name: kk.launches for kk in kernels.KERNELS if kk.launches}
    phase("replay_churn", t, records=st.total, batches=st.batches,
          records_per_s=round(st.total / st.seconds),
          seconds=round(st.seconds, 6), rounds=st.rounds, reruns=st.reruns,
          intents=st.intents, fold_seconds=round(st.fold_seconds, 6),
          ct_created=st.ct_created, ct_deleted=st.ct_deleted,
          l4_hits=int(l4.sum()),
          spans_s={kk: round(v, 6) for kk, v in st.spans.report().items()},
          launches=counts)
    allowed = {kernels.DATAPATH_STEP.name, kernels.CHURN_COMPACT.name,
               kernels.CT_DELTA.name}
    if (counts.get(kernels.DATAPATH_STEP.name) != st.rounds
            or counts.get(kernels.CHURN_COMPACT.name) != st.rounds
            or set(counts) - allowed or st.total != 2 * REPLAY_CHURN_BATCH):
        raise SystemExit(f"replay_churn: launches {counts} for {st.rounds} "
                         f"rounds")
    return dict(launches=counts.get(kernels.DATAPATH_STEP.name, 0),
                err=0)


def step_form_timing(kernels, tables, flows) -> dict:
    """DATAPATH_STEP in the replay's modes on FORMS_FLOWS flows (direct
    [8, B] pack): CUDA events over 20 launches, device ms queued behind
    a spin, the record replay's accum_telem form against the parent's
    kernel (--ab-parent, library_ab), the plain version's time and the
    bound (the pack read and the columns written once, each
    distinct table row the flows select read once, each counter entry
    the form changes read and written, the telemetry read and written;
    or the operations counted low as churn_timing counts them)."""
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import verdict

    t = time.perf_counter()
    pack = dp.pack_flow_batch(flows)
    b = int(pack.shape[1])
    pol = tables.policy
    per_flow, egress_ops = flow_ops(tables)
    acc = verdict.make_counter_buffers(pol)
    tel = verdict.make_telemetry_buffers("cuda")
    modes, ab = {}, None
    for name, form, emit in STEP_FORMS:
        if name == "with_counters":
            continue
        kw = dict(emit_sec_id=emit, static_dir=form.get("static_dir"))
        if form.get("acc"):
            kw["acc"] = acc
        if form.get("telem"):
            kw["telem"] = tel
        call = lambda: kernels.DATAPATH_STEP(tables, pack, None, **kw)
        ms = event_ms(call, 20)
        device_ms = spun_ms(queued_ms, call, "step_form_timing")
        if name == "accum_telem":  # the record replay's form
            ab = library_ab(kernels, "datapath", {name: call})
        plain_ms = event_ms(lambda: step_plain(tables, pack, None, **kw), 3)
        fresh = dict(kw)
        if "acc" in kw:
            fresh["acc"] = verdict.make_counter_buffers(pol)
        if "telem" in kw:
            fresh["telem"] = verdict.make_telemetry_buffers("cuda")
        leaves = kernels.datapath_reads(tables) + (
            (("policy", "id_table"),) if emit else ())
        rows_b, _ = table_row_bytes(
            tables, leaves, lambda: step_plain(tables, pack, None, **fresh))
        need = b * (32 + out_bytes_per_flow(dp)) + rows_b
        if "acc" in fresh:
            need += 8 * int(torch.count_nonzero(fresh["acc"]).item())
        if "telem" in fresh:
            need += 2 * 4 * fresh["telem"].numel()
        static = form.get("static_dir")
        not_in = {0: 0, 1: b}.get(static, int((flows.direction != 0).sum()))
        ops = per_flow * b + egress_ops * not_in
        bb = need / HBM_BYTES_PER_S * 1e3
        bo = ops / OPS_PER_S * 1e3
        modes[name] = dict(ms=round(ms, 4), device_ms=round(device_ms, 4),
                           plain_ms=round(plain_ms, 4),
                           bytes=need, ops=ops,
                           bound_ms=round(max(bb, bo), 6),
                           bound_by="bytes" if bb >= bo else "operations")
    if ab is not None:
        modes["accum_telem"]["ab"] = ab["medians"]
    phase("step_form_timing", t, flows=b)
    return modes


def replay_phases(kernels, w, tables, wide_t, rows) -> None:
    """The fused record replay: forms_check, replay_check, replay,
    replay_trace, replay_churn, the forms' timings.  Notes the replay
    paths' launches and errors in the DATAPATH_STEP row and prints the
    forms' times on a line of their own."""
    from cilium_tpu_torch import world

    chk = forms_check(kernels, w, tables, wide_t)
    t = time.perf_counter()
    buf = world.lattice_records(w, REPLAY_RECORDS, seed=31)
    phase("replay_records", t, records=REPLAY_RECORDS, bytes=len(buf))
    replay_check(kernels, w, tables, buf)
    run = replay_phase(kernels, tables, buf)
    replay_trace(tables, buf)
    del buf
    churn = replay_churn(kernels, w, wide_t)
    modes = step_form_timing(kernels, tables, chk["flows"])
    print(json.dumps({"datapath_step_modes": modes}), flush=True)
    for r in rows:
        if r["name"] == kernels.DATAPATH_STEP.name:
            r["launches_by_path"] = {"churn": r["launches"],
                                     "replay": run["launches"],
                                     "replay_churn": churn["launches"]}
            r["launches"] = sum(r["launches_by_path"].values())
            r["max_abs_err"] = max(r["max_abs_err"], chk["err"])


FLOW_RECORDS = 1 << 20
FLOW_BATCH = 1 << 18  # 4 batches: the ring keeps the newest records
FLOW_FIELDS = ("chip", "ep_id", "src_identity", "dst_identity", "dport",
               "proto", "direction", "verdict", "match_kind", "drop_reason",
               "proxy_port", "ct_state")


def drained_columns(tables, batches) -> list:
    """Each replay batch's capture inputs drained to the host: the 15
    columns of datapath_step on the card (the identity as sec_id) and the
    flows' endpoint, protocol and direction words, over the valid rows."""
    from cilium_tpu_torch.engine import datapath as dp

    out = []
    for flows, valid in batches:
        v = dp.datapath_step(tables, flows)
        col = {c: getattr(v, c)[:valid].cpu().numpy()
               for c in dp.VERDICT_COLUMNS}
        for c in ("ep_index", "proto", "direction"):
            col[c] = getattr(flows, c)[:valid].cpu().numpy()
        col["sec_id"] = col["sec_id"].view(np.uint32).astype(np.int64)
        out.append(col)
    return out


def capture_inputs(col) -> dict:
    """capture_batch's keyword arguments for one drained batch, the peer
    identity on its side of the pair, as replay's capture sets them."""
    dirs, sec = col["direction"], col["sec_id"]
    return dict(
        ep_ids=col["ep_index"], src_identities=np.where(dirs == 0, sec, 0),
        dst_identities=np.where(dirs == 0, 0, sec), dports=col["final_dport"],
        protos=col["proto"], directions=dirs, allowed=col["allowed"],
        match_kind=col["match_kind"], proxy_port=col["proxy_port"],
        pre_dropped=col["pre_dropped"], ct_result=col["ct_result"],
        ct_delete=col["ct_delete"], lb_slave=col["lb_slave"],
        ipcache_miss=col["ipcache_miss"])


def expected_flows(drained, sample, cap) -> tuple:
    """A host recomputation of the flow ring, independent of
    capture_batch: every drop of a batch and its first `sample` allows
    (None: all), the drops cut to the newest `cap` when a batch has more
    (its allows then dropped too), the drop reason from the prefilter bit
    and the match kind; the newest `cap` records over all batches.
    Returns ({field: array}, records built, drops cut, drops)."""
    from cilium_tpu_torch.engine.oracle import MATCH_FRAG_DROP

    parts, built, cut, drops_total = [], 0, 0, 0
    for col in drained:
        allowed = col["allowed"].astype(bool)
        drops = np.nonzero(~allowed)[0]
        allows = np.nonzero(allowed)[0]
        if sample is not None:
            allows = allows[:sample]
        drops_total += len(drops)
        if len(drops) > cap:
            cut += len(drops) - cap
            drops, allows = drops[-cap:], allows[:0]
        idx = np.concatenate([drops, allows])
        built += len(idx)
        dirs, sec = col["direction"], col["sec_id"]
        reason = np.where(col["pre_dropped"], "Policy denied (CIDR)",
                          np.where(col["match_kind"] == MATCH_FRAG_DROP,
                                   "Fragmentation needed",
                                   "Policy denied (L3)"))
        parts.append(dict(
            chip=np.zeros(len(idx), np.int64), ep_id=col["ep_index"][idx],
            src_identity=np.where(dirs == 0, sec, 0)[idx],
            dst_identity=np.where(dirs == 0, 0, sec)[idx],
            dport=col["final_dport"][idx], proto=col["proto"][idx],
            direction=dirs[idx],
            verdict=np.where(allowed, "FORWARDED", "DROPPED")[idx],
            match_kind=col["match_kind"][idx],
            drop_reason=np.where(allowed, "", reason)[idx],
            proxy_port=col["proxy_port"][idx], ct_state=col["ct_result"][idx],
        ))
    want = {f: np.concatenate([q[f] for q in parts])[-cap:]
            for f in FLOW_FIELDS}
    return want, built, cut, drops_total


def flow_capture(kernels, w, tables) -> None:
    """flow_capture: replay(..., flow_store=FlowStore()) over
    FLOW_RECORDS of config 5's records in batches of FLOW_BATCH, at the
    FlowStore's default capacity (65,536) and the default
    MonitorAggregationLevel; its stats, counters and telemetry against
    the same call without a store; the ring's records against a host
    recomputation from the batches' drained columns (expected_flows);
    the captured, cut and evicted counts; and the same columns through
    capture_batch with the metrics registry, whose store must equal the
    replay's record by record and whose flow_store_evicted gauge must
    equal its evicted count.  Prints the capture's host seconds (the
    drain span's growth) beside the replay's wall."""
    from cilium_tpu_torch import option
    from cilium_tpu_torch import replay as rp
    from cilium_tpu_torch import world
    from cilium_tpu_torch.flow import (
        FlowStore,
        allow_sample_for_level,
        capture_batch,
    )
    from cilium_tpu_torch.metrics import registry as metrics

    t = time.perf_counter()
    buf = world.lattice_records(w, FLOW_RECORDS, seed=37)
    store = FlowStore()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    st, l4, l3 = rp.replay(tables, buf, FLOW_BATCH, collect_telemetry=True,
                           flow_store=store)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    t1 = time.perf_counter()
    st0, l40, l30 = rp.replay(tables, buf, FLOW_BATCH, collect_telemetry=True)
    torch.cuda.synchronize()
    wall0 = time.perf_counter() - t1
    capture_s = st.spans["drain"].total() - st0.spans["drain"].total()
    same = (all(getattr(st, f) == getattr(st0, f) for f in REPLAY_FIELDS)
            and np.array_equal(l4, l40) and np.array_equal(l3, l30)
            and np.array_equal(st.telemetry, st0.telemetry))
    sample = allow_sample_for_level(
        option.Config.opts.level(option.MONITOR_AGGREGATION))
    drained = drained_columns(
        tables, rp.read_flow_batches(buf, FLOW_BATCH, None, "cuda"))
    want, built, cut, n_drops = expected_flows(drained, sample,
                                               store.capacity)
    snap = store.snapshot()
    got = {f: np.array([getattr(rec, f) for rec in snap]) for f in FLOW_FIELDS}
    diff = {f: int((got[f] != want[f]).sum()) for f in FLOW_FIELDS
            if got[f].shape != want[f].shape or (got[f] != want[f]).any()}
    counts_ok = (store.captured_total == built
                 and store.evicted == built - len(snap) + cut
                 and n_drops == st.denied)
    # the same columns through capture_batch with the metrics registry
    fed = FlowStore()
    dropped0 = metrics.flow_records_captured_total.get("DROPPED")
    for col in drained:
        capture_batch(fed, **capture_inputs(col), allow_sample=sample,
                      metrics_registry=metrics)
    same_fed = [dataclasses.replace(a, ts=0.0) for a in fed.snapshot()] == [
        dataclasses.replace(b, ts=0.0) for b in snap]
    gauge = metrics.flow_store_evicted.get()
    dropped = metrics.flow_records_captured_total.get("DROPPED") - dropped0
    phase("flow_capture", t, records=st.total, batches=st.batches,
          batch=FLOW_BATCH, capacity=store.capacity, allow_sample=sample,
          ring=len(snap), captured=store.captured_total, evicted=store.evicted,
          cut=cut, denied=st.denied, equal_without_store=same,
          host_recompute_diff=json.dumps(diff), counts_ok=counts_ok,
          metrics_store_equal=same_fed, flow_store_evicted=gauge,
          captured_dropped_metric=dropped, capture_host_s=round(capture_s, 4),
          replay_wall_s=round(wall, 4), replay_wall_without_store_s=round(
              wall0, 4))
    if (not same or diff or not counts_ok or not same_fed
            or gauge != store.evicted or dropped != st.denied
            or len(snap) != store.capacity):
        raise SystemExit("flow_capture: the capture changed the replay, or "
                         "the ring differs from the host recomputation, or "
                         "the counts do not add up")


def cidr_phase(kernels, u) -> tuple:
    """Config 2 (bench.py config2): evaluate_batch_from_ips at 100,000
    tuples (16 calls) and at 1,048,576 (8 calls), bench's 512-row oracle
    (HostLPM + policy_can_access) on the first batch, and lpm_lookup of
    each batch's addresses held against HostLPM on those rows."""
    from cilium_tpu_torch.engine.hostpath import HostLPM
    from cilium_tpu_torch.engine.oracle import policy_can_access
    from cilium_tpu_torch.engine.verdict import evaluate_batch_from_ips
    from cilium_tpu_torch.ipcache.lpm import lpm_lookup

    t = time.perf_counter()
    cw, tab, lpm = u["cw"], u["c2"], u["c2_lpm"]
    src, cols, src_d, batch = u["c2_small"]
    torch.cuda.synchronize()
    reset_counts(kernels)
    out = evaluate_batch_from_ips(lpm, tab, src_d, batch)
    ids = lpm_lookup(lpm, src_d)
    ids_big = lpm_lookup(lpm, u["c2_big"][2])
    torch.cuda.synchronize()
    host = HostLPM(cw.ipc_map)
    allowed = out.allowed.cpu().numpy()
    got_ids = ids.cpu().numpy().view(np.uint32)
    big_src = u["c2_big"][0]
    big_ids = ids_big.cpu().numpy().view(np.uint32)
    bad = bad_ids = 0
    for i in u["c2_sample"]:
        sec = host.lookup(int(src[i]))
        v = policy_can_access(cw.states[0], sec, int(cols["dport"][i]), 6, 0,
                              count_hits=False)
        bad += int(bool(allowed[i]) != v.allowed)
        bad_ids += int(int(got_ids[i]) != sec)
        bad_ids += int(int(big_ids[i]) != host.lookup(int(big_src[i])))

    def timed(steps, src_t, b):
        evaluate_batch_from_ips(lpm, tab, src_t, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [evaluate_batch_from_ips(lpm, tab, src_t, b)
                for _ in range(steps)]
        torch.cuda.synchronize()
        return steps * int(src_t.numel()) / (time.perf_counter() - t0), outs

    vps_small, _ = timed(CIDR_CALLS, src_d, batch)
    vps_big, outs = timed(CIDR_BIG_CALLS, u["c2_big"][2], u["c2_big"][3])
    counts = {k.name: k.launches for k in kernels.KERNELS if k.launches}
    phase("cidr", t, tuples=CIDR_TUPLES, calls=CIDR_CALLS,
          verdicts_per_s=round(vps_small), tuples_big=CIDR_BIG,
          calls_big=CIDR_BIG_CALLS, verdicts_per_s_big=round(vps_big),
          allowed=int(out.allowed.sum()),
          allowed_big=int(outs[0].allowed.sum()), launches=counts,
          oracle_rows=ORACLE_ROWS, oracle_mismatches=bad,
          lpm_mismatches=bad_ids)
    if bad or bad_ids or set(counts) != {kernels.LATTICE.name,
                                         kernels.LPM_LOOKUP.name}:
        raise SystemExit("cidr: the oracle disagrees or launches are off")
    return counts[kernels.LATTICE.name], counts[kernels.LPM_LOOKUP.name]


def config1_latency_phase(kernels, u) -> int:
    """Config 1 (bench.py config1): the wall time of evaluate_batch on
    its 1,024 tuples, each call synchronised, over CONFIG1_CALLS calls;
    every call's verdicts held against evaluate_batch_oracle."""
    from cilium_tpu_torch.engine.oracle import evaluate_batch_oracle
    from cilium_tpu_torch.engine.verdict import evaluate_batch

    t = time.perf_counter()
    ex, tab, batch = u["ex"], u["c1"], u["c1_batch"]
    for _ in range(10):
        evaluate_batch(tab, batch)
    torch.cuda.synchronize()
    reset_counts(kernels)
    times, outs = [], []
    for _ in range(CONFIG1_CALLS):
        t0 = time.perf_counter()
        outs.append(evaluate_batch(tab, batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = kernels.LATTICE.launches
    want = evaluate_batch_oracle(ex.states, **ex.tuples)
    want = [torch.from_numpy(a.astype(np.int64)).cuda() for a in want]
    bad = sum(
        int((getattr(o, c).to(torch.int64) != wv).sum())
        for o in outs
        for c, wv in zip(("allowed", "proxy_port", "match_kind"), want))
    ms = np.asarray(times) * 1e3
    phase("config1_latency", t, tuples=len(ex.tuples["ep_index"]),
          calls=CONFIG1_CALLS, launches=launches,
          p50_ms=round(float(np.percentile(ms, 50)), 4),
          p99_ms=round(float(np.percentile(ms, 99)), 4),
          min_ms=round(float(ms.min()), 4),
          allowed=int(outs[0].allowed.sum()), oracle_mismatches=bad)
    if bad or launches != CONFIG1_CALLS:
        raise SystemExit("config1_latency: verdicts differ from the oracle")
    return launches


def lattice_need(tab, batch, counters=False, lpm=None, src_ips=None):
    """Bytes and integer operations LATTICE needs for this batch: 24 B
    per tuple in and 6 B out (and 4 B per source address in IP mode);
    each distinct table row or element the plain version gathers (the
    two hashed rows, id_direct, l4_meta, l3_allow_bits, port_slot and
    l4_allow_bits, l1) read once, the stashes whole, each l2 row a block
    address selects once; each counter entry the batch changes read and
    written.  Operations, counted low: 16 per hashed word and 4 per lane
    or stash entry compared (two probes), 16 for a dense or DIR-24-8
    read."""
    from cilium_tpu_torch.device import widen
    from cilium_tpu_torch.ipcache.lpm import BLOCK_FLAG

    names = ("id_direct", "l3_allow_bits", "l4_meta") + (
        ("port_slot", "l4_allow_bits") if tab.l4_hash_rows is None else
        ("l4_hash_rows", "l4_hash_stash", "l4_wild_rows", "l4_wild_stash"))
    leaves = [(f"policy.{n}", getattr(tab, n)) for n in names]
    if lpm is not None:
        leaves.append(("lpm.l1", lpm.l1))
    rows_b, _, (_, acc) = leaf_bytes(leaves, lambda: lattice_plain(
        tab, batch, counters=counters, lpm=lpm, src_ips=src_ips))
    b = int(batch.ep_index.numel())
    total = rows_b + b * (24 + 6)
    ops = b * 16
    if lpm is not None:
        v1 = widen(lpm.l1[widen(src_ips) >> 8])
        blocks = v1[(v1 & int(BLOCK_FLAG)) != 0] & ~int(BLOCK_FLAG)
        total += b * 4 + 1024 * int(torch.unique(blocks).numel())
        ops += b * 16
    if acc is not None:
        total += 2 * 4 * int(torch.count_nonzero(acc).item())
    if tab.l4_hash_rows is not None:
        ew = int(tab.l4_hash_stash.shape[1])
        lanes = (tab.l4_hash_rows.shape[1] + tab.l4_wild_rows.shape[1]) // ew
        ops += b * (16 * 4 + 4 * (lanes + tab.l4_hash_stash.shape[0]
                                  + tab.l4_wild_stash.shape[0]))
    return total, ops


def lattice_timing(kernels, u, launches_lattice, launches_lpm, err) -> list:
    """LATTICE in each mode and LPM_LOOKUP alone: CUDA events over 20
    warm launches, the plain versions, and the bounds (see
    lattice_need; LPM_LOOKUP: 8 B per address, each distinct l1 entry
    and l2 row once)."""
    from cilium_tpu_torch.device import widen
    from cilium_tpu_torch.ipcache.lpm import BLOCK_FLAG, lpm_lookup_plain

    t = time.perf_counter()
    res = {}
    ip_small = dict(lpm=u["c2_lpm"], src_ips=u["c2_small"][2])
    modes = dict(lattice_modes(u),
                 c1_1024=(u["c1"], u["c1_batch"], {}),
                 c2_ip_100k=(u["c2"], u["c2_small"][3], ip_small))
    launches = kernels.LATTICE.launches
    for name, (tab, batch, kw) in modes.items():
        call = lambda: kernels.LATTICE(tab, batch, **kw)
        ms = event_ms(call, 20)
        # the device's own time: the calls queued behind a spin (at the
        # config-1 and CIDR sizes the events time the host's launches)
        device_ms = spun_ms(queued_ms, call, "lattice_timing")
        plain_ms = event_ms(lambda: lattice_plain(tab, batch, **kw), 3)
        need, ops = lattice_need(tab, batch, **kw)
        res[name] = dict(
            tuples=int(batch.ep_index.numel()), ms=ms, device_ms=device_ms,
            plain_ms=plain_ms, bytes=need, ops=ops,
            bound_bytes_ms=need / HBM_BYTES_PER_S * 1e3,
            bound_ops_ms=ops / OPS_PER_S * 1e3)
    kernels.LATTICE.launches = launches
    for name, lpm, ips in (("lpm_c2", u["c2_lpm"], u["c2_big"][2]),
                           ("lpm_c5", u["c5_lpm"], u["c5_ips"])):
        ms = event_ms(lambda: kernels.LPM_LOOKUP(lpm, ips), 20)
        plain_ms = event_ms(lambda: lpm_lookup_plain(lpm, ips), 3)
        cell = widen(ips) >> 8
        v1 = widen(lpm.l1[cell])
        blocks = v1[(v1 & int(BLOCK_FLAG)) != 0] & ~int(BLOCK_FLAG)
        need = (8 * int(ips.numel()) + 4 * int(torch.unique(cell).numel())
                + 1024 * int(torch.unique(blocks).numel()))
        ops = 16 * int(ips.numel())
        res[name] = dict(
            addresses=int(ips.numel()), ms=ms, plain_ms=plain_ms, bytes=need,
            ops=ops, bound_bytes_ms=need / HBM_BYTES_PER_S * 1e3,
            bound_ops_ms=ops / OPS_PER_S * 1e3)
    for name, r in res.items():
        print(f"  lattice_timing {name} " + json.dumps(r), flush=True)
    # the parent's csrc/lattice.cu (--ab-parent) on every shape above
    ab = library_ab(kernels, "lattice", {
        name: (lambda tab=tab, batch=batch, kw=kw: kernels.LATTICE(
            tab, batch, **kw))
        for name, (tab, batch, kw) in modes.items()})
    phase("lattice_timing", t, modes=len(res))
    main, lpm = res["c5_compact"], res["lpm_c2"]
    src = "cilium_tpu_torch/csrc/lattice.cu"
    row = kernel_row(kernels.LATTICE, src, "cilium_tpu/engine/verdict.py:432",
                     launches_lattice, err, main["ms"], main["plain_ms"],
                     main["bound_bytes_ms"], main["bound_ops_ms"])
    row["modes_ms"] = {n: {"events": round(r["ms"], 4),
                           "device": round(r["device_ms"], 4),
                           "bound": round(max(r["bound_bytes_ms"],
                                              r["bound_ops_ms"]), 4)}
                       for n, r in res.items() if "device_ms" in r}
    row["ptxas"] = LATTICE_PTXAS
    if ab is not None:
        row["ab"] = ab["medians"]
        row["ab_differing"] = ab["differing"]
    return [
        row,
        kernel_row(kernels.LPM_LOOKUP, src, "cilium_tpu/ipcache/lpm.py:1091",
                   launches_lpm, err, lpm["ms"], lpm["plain_ms"],
                   lpm["bound_bytes_ms"], lpm["bound_ops_ms"]),
    ]


def lattice_phases(kernels, w, tables, wide_t) -> list:
    """The tuple-level lattice: set-up, the check, then config 5's
    lattice line and record replay, config 2, config 1, and the kernel
    timings.  LATTICE's launches are summed over its four paths, each
    counted from 0."""
    u = lattice_setup(w, tables, wide_t)
    err = lattice_check(kernels, u)
    n_lat = lattice_phase(kernels, u)
    n_lat += replay_lattice_phase(kernels, w, u)
    n_cidr, n_lpm = cidr_phase(kernels, u)
    n_lat += n_cidr + config1_latency_phase(kernels, u)
    return lattice_timing(kernels, u, n_lat, n_lpm, err)


def verdicts6_err(got, want) -> int:
    """Max |difference| over the 13 Datapath6Verdicts columns (u32
    columns as unsigned); 0 means bit-exact."""
    from cilium_tpu_torch.engine import datapath6 as d6

    return max(int_err(getattr(got, c), getattr(want, c),
                       c in d6.U32_COLUMNS6) for c in d6.VERDICT6_COLUMNS)


def config6_setup() -> dict:
    """bench.py's config 6 (world.config6_world at 1,048,576 flows) and
    the 256-node overlay on the card: the tables with and without the
    tunnel map (the policy's hot plane: the hashed lattice), the
    flows."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.compiler.tables import split_hot
    from cilium_tpu_torch.convert import datapath6_tables_to
    from cilium_tpu_torch.engine.datapath6 import FlowBatch6

    t = time.perf_counter()
    w6 = world.config6_world(CONFIG6_FLOWS)
    tm = world.tunnel_map()
    host = w6.host_tables(tunnel=tm)
    host.policy = split_hot(host.policy)
    tunnel = datapath6_tables_to(host, "cuda")
    u = dict(w6=w6, tm=tm, tunnel=tunnel,
             tables=dataclasses.replace(tunnel, tunnel=None),
             flows=FlowBatch6.from_numpy(**w6.flows, device="cuda"))
    total = sum(v.numel() * v.element_size()
                for _, v in table_leaves(tunnel))
    phase("config6_setup", t, flows=CONFIG6_FLOWS,
          identities=len(w6.identity_ids), prefixes=len(w6.ipc_map),
          ct_buckets=int(tunnel.ct.n_buckets),
          ipcache_buckets=int(tunnel.ipcache.n_buckets),
          tunnel_ranges=int(tunnel.tunnel.endpoint.shape[0]),
          table_bytes=total)
    return u


def config6_check(kernels, u, w, tables, wide_t) -> dict:
    """DATAPATH6 against its plain version on config 6's 1,048,576
    flows, with the tunnel map, on both passes of the conntrack variant
    (a 65,536-flow slice written back, CT6 recompiled, then the slice and
    its reverses) and on the edge world (world.v6_edge_world) with its
    tables staged and read in place; DATAPATH_PAIR and DATAPATH_STEP against
    theirs on config 5's tables with the 256-node tunnel map.  Returns
    the errors and the overlay inputs for the timings."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.convert import (
        datapath6_tables_to,
        flow_pool_to,
        plane_to,
    )
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import datapath6 as d6
    from cilium_tpu_torch.engine import verdict

    t = time.perf_counter()
    errs = {}
    for name in ("tables", "tunnel"):
        got = kernels.DATAPATH6(u[name], u["flows"])
        errs[name] = verdicts6_err(got, d6.datapath6_plain(u[name], u["flows"]))
    tunnelled6 = int((got.tunnel_endpoint != 0).sum().item())
    head = d6.FlowBatch6(**{
        f.name: getattr(u["flows"], f.name)[:CONFIG6_SLICE]
        for f in dataclasses.fields(d6.FlowBatch6)})
    first = kernels.DATAPATH6(u["tables"], head)
    errs["ct_first"] = verdicts6_err(first, d6.datapath6_plain(u["tables"],
                                                               head))
    ct, second = world.config6_ct_pass(u["w6"].flows, first, CONFIG6_SLICE)
    ct_tables = dataclasses.replace(
        u["tables"], ct=plane_to(d6.compile_ct6(ct), "cuda"))
    flows2 = d6.FlowBatch6.from_numpy(**second, device="cuda")
    got2 = kernels.DATAPATH6(ct_tables, flows2)
    errs["ct_second"] = verdicts6_err(got2, d6.datapath6_plain(ct_tables,
                                                               flows2))
    ct_results = torch.bincount(got2.ct_result.long(), minlength=4).tolist()
    sticky = int(((got2.lb_slave[:CONFIG6_SLICE] > 0)
                  & (got2.ct_result[:CONFIG6_SLICE] == 1)).sum().item())
    # the v6 tables' edges (world.v6_edge_world: the stashes in use,
    # duplicate and near-miss keys, tied ranges, nested tunnel ranges),
    # staged and padded past what a block stages (read in place)
    edges = world.v6_edge_world()
    ef = d6.FlowBatch6.from_numpy(**edges.flows, device="cuda")
    for name, host6 in (("edges", edges.tables),
                        ("edges_in_place", world.v6_unstaged(edges.tables))):
        t6 = datapath6_tables_to(host6, "cuda")
        errs[name] = verdicts6_err(kernels.DATAPATH6(t6, ef),
                                   d6.datapath6_plain(t6, ef))

    # v4 overlay mode: config 5's tables with the same 256 nodes
    tun4 = plane_to(u["tm"].tables(), "cuda")
    tables_tun = dataclasses.replace(tables, tunnel=tun4)
    wide_tun = dataclasses.replace(wide_t, tunnel=tun4)
    pair = w.pairs(seed=43, half=HALF, k=1)
    errs["pair_tunnel"] = check_pairs(tables_tun, pair, kernels, dp, verdict)
    pair_dev = torch.from_numpy(pair[0].view(np.int32)).cuda()
    pool = flow_pool_to(w.pool, "cuda")
    picks = torch.randint(0, pool.shape[1], (CHURN_BATCH,), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(6),
                          dtype=torch.int32)
    got4 = kernels.DATAPATH_STEP(wide_tun, pool, picks)
    want4 = dp.datapath_step_plain(
        wide_tun, dp.flow_batch_from_packed(pool[:, picks.long()]))
    errs["step_tunnel"] = compare((got4,), (want4,), dp)
    tunnelled4 = int((got4.tunnel_endpoint != 0).sum().item())
    torch.cuda.synchronize()
    phase("config6_check", t, max_abs_err=errs, slice=CONFIG6_SLICE,
          ct_entries=len(ct.entries), second_pass=int(flows2.saddr.shape[0]),
          second_ct_results=ct_results, sticky_established=sticky,
          tunnelled_v6=tunnelled6, tunnelled_v4_step=tunnelled4)
    if any(errs.values()):
        raise SystemExit(f"a kernel differs from its plain version: {errs}")
    if not (ct_results[1] and ct_results[2] and sticky and tunnelled6
            and tunnelled4):
        raise SystemExit("the config-6 variants missed a stage")
    return dict(errs=errs, tables_tun=tables_tun, wide_tun=wide_tun,
                pair_dev=pair_dev, pool=pool, picks=picks)


def config6_oracle(w6, out) -> int:
    """bench.py config 6's composed oracle (:2879-2901) on its 256
    sampled rows: the host LB (lb6_lookup_host, slave_for_host), the
    host LPM (lookup_host6, WORLD when it misses) and the map state's
    verdict (policy_can_access).  Returns the mismatches."""
    import ipaddress

    from cilium_tpu_torch.compiler.tables import RESERVED_WORLD
    from cilium_tpu_torch.engine.oracle import policy_can_access
    from cilium_tpu_torch.ipcache.lpm6 import int_of_limbs, lookup_host6
    from cilium_tpu_torch.lb.device6 import lb6_lookup_host, slave_for_host

    allowed = out.allowed.cpu().numpy()
    slave = out.lb_slave.cpu().numpy()
    f = w6.flows
    bad = 0
    for i in w6.sample:
        s = str(ipaddress.IPv6Address(int_of_limbs(f["saddr"][i])))
        d = str(ipaddress.IPv6Address(int_of_limbs(f["daddr"][i])))
        dirn, eff_d, eff_p = int(f["direction"][i]), d, int(f["dport"][i])
        if dirn == 1:
            svc = lb6_lookup_host(w6.mgr, d, eff_p, 6)
            if svc is not None and svc.backends:
                sl = slave_for_host(svc, s, d, int(f["sport"][i]), eff_p, 6)
                bad += int(slave[i]) != sl
                eff_d = svc.backends[sl - 1].addr.ip
                eff_p = svc.backends[sl - 1].addr.port
        sec = lookup_host6(w6.ipc_map, s if dirn == 0 else eff_d)
        v = policy_can_access(w6.states[0], sec or RESERVED_WORLD, eff_p, 6,
                              dirn)
        bad += bool(allowed[i]) != v.allowed
    return bad


def config6_phase(kernels, u) -> int:
    """Config 6 through the entry point: one call held against bench's
    composed oracle, then bench's timed loop, 8 calls of
    datapath6_step on the flows already on the card, synchronised at
    the end as bench.py's block_until_ready is.  Returns DATAPATH6's
    launches on this path."""
    from cilium_tpu_torch.engine.datapath6 import datapath6_step

    tables, flows = u["tables"], u["flows"]
    torch.cuda.synchronize()
    reset_counts(kernels)
    t = time.perf_counter()
    out = datapath6_step(tables, flows)
    mismatches = config6_oracle(u["w6"], out)
    t1 = time.perf_counter()
    outs = [datapath6_step(tables, flows) for _ in range(CONFIG6_CALLS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = kernels.DATAPATH6.launches
    others = {k.name: k.launches for k in kernels.KERNELS
              if k is not kernels.DATAPATH6}
    phase("config6", t, calls=CONFIG6_CALLS, flows=CONFIG6_FLOWS,
          launches=launches, wall_ms=round(wall * 1e3, 4),
          verdicts_per_s=round(CONFIG6_CALLS * CONFIG6_FLOWS / wall),
          allowed=int(outs[-1].allowed.sum().item()),
          lb_dnat=int((outs[-1].lb_slave > 0).sum().item()),
          oracle_rows=len(u["w6"].sample), oracle_mismatches=mismatches)
    if launches != CONFIG6_CALLS + 1 or any(others.values()) or mismatches:
        raise SystemExit(f"config 6: {launches} DATAPATH6 launches, others "
                         f"{others}, {mismatches} oracle mismatches")
    return launches


def datapath6_need(tables, flows):
    """Bytes and integer operations DATAPATH6 needs for these flows: 53 B
    of columns in and 46 B out a flow; each distinct table row or word
    the plain version gathers (the CT6, ipcache6 and LB6 rows, the two
    hashed L4 rows, id_direct, l3_allow_bits) read once; the stashes,
    the ranges and the tunnel map whole.  Operations, counted low: 16
    per hashed word and 4 per lane word compared; a flow hashes 18
    words (CT6 10, ipcache6 4, two L4 probes 2 each) and compares a CT6
    row (11 entries x 9 key words), an ipcache6 row (25 x 4), the
    ranges (4 a range) and two L4 rows; a non-ingress flow with a v6 LB
    adds 25 hashed words (service CT6 10, LB key 5, flow hash 10), a CT6
    row and the LB row's 2 slots (5 words each); with a tunnel map an
    allowed non-ingress flow compares 4 limbs a range."""
    from cilium_tpu_torch.engine import datapath6 as d6

    leaves = []
    for plane, leaf in READS6:
        obj = getattr(tables, plane)
        if obj is not None and getattr(obj, leaf, None) is not None:
            leaves.append((f"{plane}.{leaf}", getattr(obj, leaf)))
    rows_b, gathered, out = leaf_bytes(
        leaves, lambda: d6.datapath6_plain(tables, flows))
    b = int(flows.saddr.shape[0])
    pol = tables.policy
    n_ranges = int(tables.ipcache.range_base.shape[0])
    l4_lanes = (pol.l4_hash_rows.shape[1] + pol.l4_wild_rows.shape[1]) // int(
        pol.l4_hash_stash.shape[1])
    ops = b * (16 * 18 + 4 * (11 * 9 + 25 * 4 + 4 * n_ranges + l4_lanes))
    if tables.lb is not None:
        non_ingress = int((flows.direction != 0).sum().item())
        ops += non_ingress * (16 * 25 + 4 * (11 * 9 + 2 * 5))
    if tables.tunnel is not None:
        scans = int((out.allowed.bool() & (flows.direction != 0)).sum().item())
        ops += scans * 4 * int(tables.tunnel.endpoint.shape[0])
    return rows_b + 99 * b, ops, gathered / b


def config6_timing(kernels, u, chk, launches6) -> tuple:
    """DATAPATH6's device ms on config 6's flows (with and without the
    tunnel map; 20 calls queued behind a device spin), its CUDA events
    (the wrapper's host time included), ptxas's registers and spills, the
    plain version's ms and the bound (see datapath6_need); then
    DATAPATH_PAIR and DATAPATH_STEP in overlay mode (the pair of
    config6_check, 2,097,152 picks of the pool).  Returns (DATAPATH6's
    row, the overlay times)."""
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import datapath6 as d6
    from cilium_tpu_torch.engine import verdict

    t = time.perf_counter()
    tables, flows = u["tables"], u["flows"]
    events = event_ms(lambda: kernels.DATAPATH6(tables, flows), 20)
    ms = spun_ms(queued_ms, lambda: kernels.DATAPATH6(tables, flows),
                 "config6")
    plain_ms = event_ms(lambda: d6.datapath6_plain(tables, flows), 3)
    tunnel_ms = spun_ms(queued_ms,
                        lambda: kernels.DATAPATH6(u["tunnel"], flows),
                        "config6")
    tunnel_plain_ms = event_ms(
        lambda: d6.datapath6_plain(u["tunnel"], flows), 3)
    need, ops, gathered = datapath6_need(tables, flows)
    bb, bo = need / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    t_need, t_ops, _ = datapath6_need(u["tunnel"], flows)
    tunnel_bound_ms = max(t_need / HBM_BYTES_PER_S, t_ops / OPS_PER_S) * 1e3
    acc = verdict.make_counter_buffers(chk["tables_tun"].policy)
    tel = verdict.make_telemetry_buffers(acc.device)
    pair_dev, pool, picks = chk["pair_dev"], chk["pool"], chk["picks"]
    overlay = dict(
        pair_ms=event_ms(lambda: kernels.DATAPATH_PAIR(
            chk["tables_tun"], pair_dev, acc, tel), 20),
        pair_plain_ms=event_ms(lambda: dp.datapath_pair_plain(
            chk["tables_tun"], pair_dev, acc, tel), 3),
        step_ms=event_ms(lambda: kernels.DATAPATH_STEP(
            chk["wide_tun"], pool, picks), 20),
        step_plain_ms=event_ms(lambda: dp.datapath_step_plain(
            chk["wide_tun"], dp.flow_batch_from_packed(pool[:, picks.long()])),
            3),
    )
    phase("config6_timing", t, ms=round(ms, 4), events_ms=round(events, 4),
          plain_ms=round(plain_ms, 4),
          tunnel_ms=round(tunnel_ms, 4),
          tunnel_plain_ms=round(tunnel_plain_ms, 4),
          tunnel_bound_ms=round(tunnel_bound_ms, 4), tunnel_ops=t_ops,
          bytes=need, ops=ops,
          row_bytes_per_flow=round(gathered, 2),
          bound_bytes_ms=round(bb, 4), bound_ops_ms=round(bo, 4),
          kernel_verdicts_per_s=round(CONFIG6_FLOWS / (ms / 1e3)),
          overlay={k: round(v, 4) for k, v in overlay.items()})
    row = kernel_row(kernels.DATAPATH6, "cilium_tpu_torch/csrc/datapath6.cu",
                     "cilium_tpu/engine/datapath6.py:452", launches6,
                     max(chk["errs"][k] for k in (
                         "tables", "tunnel", "ct_first", "ct_second", "edges",
                         "edges_in_place")),
                     ms, plain_ms, bb, bo)
    row["tunnel_ms"] = tunnel_ms
    row["tunnel_plain_ms"] = tunnel_plain_ms
    row["tunnel_bound_ms"] = tunnel_bound_ms
    row["events_ms"] = events
    row["ptxas"] = D6_PTXAS
    # the parent's csrc/datapath6.cu (--ab-parent): the shared stage code
    ab = library_ab(kernels, "datapath6", {
        "config6": lambda: kernels.DATAPATH6(tables, flows),
        "config6_tunnel": lambda: kernels.DATAPATH6(u["tunnel"], flows)})
    if ab is not None:
        row["ab"] = ab["medians"]
    return row, overlay


def config6_phases(kernels, w, tables, wide_t, rows) -> None:
    """Config 6 and overlay mode: set-up, the checks, bench's path, the
    timings.  Appends DATAPATH6's row to `rows` and notes the overlay
    times in the DATAPATH_PAIR and DATAPATH_STEP rows."""
    u = config6_setup()
    chk = config6_check(kernels, u, w, tables, wide_t)
    launches6 = config6_phase(kernels, u)
    row, overlay = config6_timing(kernels, u, chk, launches6)
    # overlay mode reads the same rows plus the v4 map, whole
    tun = chk["tables_tun"].tunnel
    map_ms = sum(v.numel() * v.element_size()
                 for v in (tun.base, tun.mask, tun.endpoint)) / HBM_BYTES_PER_S * 1e3
    for r in rows:
        kind = {"datapath_pair": "pair", "datapath_step": "step"}.get(r["name"])
        if kind:
            r["tunnel_ms"] = overlay[f"{kind}_ms"]
            r["tunnel_plain_ms"] = overlay[f"{kind}_plain_ms"]
            r["tunnel_bound_ms"] = r["bound_ms"] + map_ms
            r["tunnel_max_abs_err"] = chk["errs"][f"{kind}_tunnel"]
    rows.append(row)


# -- node-scale worlds: the datapath's remaining table layouts -------------------

NODE_WORLDS = ("node", "node_lpm")


def node_world_phase(kernels, label: str) -> dict:
    """Build world.node_world (node_lpm: lpm=True) at full width, its
    headline (sub-word, hot plane) and wide tables on the card, and
    assert the layout each plane took: the DIR-24-8 prefilter, the
    classic LB, and the idx ipcache without L3 planes and with the
    [B, P] scan (node) or the DIR-24-8 ipcache (node_lpm)."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.compiler.tables import split_hot
    from cilium_tpu_torch.convert import tables_to
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.ipcache.lpm import IPCacheDevice, LPMTables
    from cilium_tpu_torch.lb.device import LBTables

    t = time.perf_counter()
    w = world.node_world(lpm=label == "node_lpm")
    wide = w.host_tables()
    host = dp.subword_datapath_tables(wide)  # raises if a plane does not fit
    host.policy = split_hot(host.policy)
    ipc = host.ipcache
    layout = {
        "prefilter": type(host.prefilter).__name__,
        "prefilter_cidrs": len(w.prefilter_cidrs),
        "lb": type(host.lb).__name__,
        "ipcache": type(ipc).__name__,
        "ipcache_l3_planes": getattr(ipc, "l3_planes", None),
        "ipcache_range_classes": getattr(ipc, "range_rows", None) is not None,
        "ranges": (int(ipc.range_base.shape[0])
                   if isinstance(ipc, IPCacheDevice) else None),
    }
    want_ipc = (isinstance(ipc, LPMTables) if label == "node_lpm" else (
        isinstance(ipc, IPCacheDevice) and ipc.values_are_idx
        and not ipc.l3_planes and ipc.range_rows is None))
    if not (isinstance(host.prefilter, LPMTables)
            and isinstance(host.lb, LBTables) and want_ipc):
        raise SystemExit(f"{label}: a plane took another layout: {layout}")
    wide_t = tables_to(
        dataclasses.replace(wide, policy=split_hot(wide.policy)), "cuda")
    tables = tables_to(host, "cuda")
    del wide
    nbytes = sum(v.numel() * v.element_size()
                 for _, v in table_leaves(tables))
    names = {"headline": kernels.datapath_layout(tables),
             "wide": kernels.datapath_layout(wide_t)}
    phase("node_world", t, world=label, **w.meta, table_bytes=nbytes,
          layout=json.dumps(layout), kernel_layouts=json.dumps(names))
    return dict(w=w, host=host, tables=tables, wide_t=wide_t,
                layout=names["headline"], wide_layout=names["wide"])


def oracle_mismatches(w, tables, rows) -> tuple:
    """ORACLE_ROWS pool rows through read_flow_batches and datapath_step
    against composed_oracle and its stages.  The oracle's sec_id is the
    raw identity; the idx-form ipcache gives an identity outside the
    policy universe the parking index's identity id_table[N - 1] (the
    reference's specialize_ipcache_to_idx), so there the expected sec_id
    is that.  Returns (mismatched rows, stages)."""
    from cilium_tpu_torch import replay as rp
    from cilium_tpu_torch import world
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine.hostpath import composed_oracle
    from cilium_tpu_torch.ipcache.lpm import IPCacheDevice

    flows, _ = next(rp.read_flow_batches(world.pool_records(w, rows),
                                         len(rows)))
    out = dp.datapath_step(tables, flows)
    allow, proxy, sec, stages = composed_oracle(
        world.oracle_context(w), w.states, w.pool, list(rows),
        return_stages=True)
    known = np.isin(sec, np.asarray(w.identity_ids, np.uint32))
    stages["outside_universe"] = ~known
    if isinstance(tables.ipcache, IPCacheDevice) and (
            tables.ipcache.values_are_idx):
        id_table = tables.policy.id_table.cpu().numpy().view(np.uint32)
        sec = np.where(known, sec, id_table[-1])
    got = {c: getattr(out, c).cpu().numpy() for c in dp.VERDICT_COLUMNS}
    bad = ((got["allowed"] != allow) | (got["proxy_port"] != proxy)
           | (got["sec_id"].view(np.uint32) != sec)
           | (got["pre_dropped"] != stages["pre_drop"])
           | (got["ct_result"] != stages["ct_res"])
           | (got["match_kind"] != stages["match_kind"])
           | (got["ipcache_miss"] != stages["ipcache_miss"])
           | ((got["lb_slave"] > 0) != stages["lb_hit"]))
    return int(bad.sum()), stages


def node_check(kernels, label: str, nw: dict) -> tuple:
    """0 differences required everywhere: DATAPATH_PAIR over 2 pairs of
    2 x 2,097,152 flows, PERSISTENT_PAIR over a super-batch of 4 pairs
    of 2 x 524,288, and DATAPATH_STEP's forms over 1,048,576 flows
    against their plain versions on the card (15 columns, counters,
    telemetry); replay() over 2 batches and replay_pool with 2 int-pick
    batches of 2,097,152 on the wide tables against the plain loops (CT
    entries, snapshots, and the snapshot against its host mirror); 512
    pool rows against the composed oracle.  Returns the worst error of
    the pair and step kernels, and PERSISTENT_PAIR's."""
    from cilium_tpu_torch import replay as rp
    from cilium_tpu_torch import world
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import verdict

    w, tables, wide_t = nw["w"], nw["tables"], nw["wide_t"]
    t = time.perf_counter()
    err_pair = check_pairs(tables, w.pairs(seed=51, half=HALF, k=2), kernels,
                           dp, verdict)
    err_super = check_super(tables, w.pairs(seed=52, half=HALF // 4,
                                            k=PERSIST_K), kernels, dp, verdict)
    flows, _, _ = forms_flows(w, FORMS_FLOWS, seed=53)
    errs = {}
    for name, _, _ in STEP_FORMS:
        k, p = run_form(dp, verdict, tables, flows, name)
        errs[name] = forms_err(dp, k, p)
        del k, p
    torch.cuda.synchronize()
    buf = world.lattice_records(w, 2 * REPLAY_BATCH, seed=55)
    k = replay_run(tables, buf, REPLAY_BATCH)
    with PlainRoute(kernels, {"DATAPATH_STEP": step_plain}):
        p = replay_run(tables, buf, REPLAY_BATCH)
    same_replay = (all(getattr(k[0], f) == getattr(p[0], f)
                       for f in REPLAY_FIELDS)
                   and np.array_equal(k[1], p[1])
                   and np.array_equal(k[2], p[2])
                   and np.array_equal(k[0].telemetry, p[0].telemetry)
                   and k[3] == p[3])
    maps = [pinned_ct(w.ct), pinned_ct(w.ct)]
    s_k = rp.replay_pool(wide_t, dict(w.pool), 2 * CHURN_BATCH, CHURN_BATCH,
                         ct_map=maps[0], device="cuda")
    with PlainRoute(kernels, churn_plain()):
        s_p = rp.replay_pool(wide_t, dict(w.pool), 2 * CHURN_BATCH,
                             CHURN_BATCH, ct_map=maps[1], device="cuda")
    torch.cuda.synchronize()
    same_pool = same_loops(maps, (s_k, s_p))
    index, snap, _ = maps[0]._device_churn_cache
    full = index.full_snapshot()
    mirror_err = max(
        int_err(snap.buckets.cpu(), torch.from_numpy(
            full.buckets.view(np.int32)), True),
        int_err(snap.stash.cpu(), torch.from_numpy(
            full.stash.view(np.int32)), True))
    rows = np.random.default_rng(57).integers(0, len(w.pool["saddr"]),
                                              ORACLE_ROWS)
    bad, stages = oracle_mismatches(w, tables, rows)
    err = max(err_pair, max(errs.values()))
    phase("node_check", t, world=label, pair_max_abs_err=err_pair,
          persistent_max_abs_err=err_super,
          forms_max_abs_err=errs, replay_equal_to_plain=same_replay,
          replay_records=k[0].total, pool_equal_to_plain=same_pool,
          pool_stats=stats_fields(s_k), snapshot_vs_mirror_err=mirror_err,
          oracle_rows=ORACLE_ROWS, oracle_mismatches=bad,
          oracle_lb_hits=int(stages["lb_hit"].sum()),
          oracle_pre_drops=int(stages["pre_drop"].sum()),
          oracle_ipcache_misses=int(stages["ipcache_miss"].sum()),
          oracle_outside_universe=int(stages["outside_universe"].sum()))
    if (err or err_super or not same_replay or not same_pool or mirror_err
            or bad or s_k.ct_created == 0):
        raise SystemExit(f"node_check ({label}): a kernel differs from its "
                         f"plain version, or the oracle disagrees")
    return err, err_super


def node_path(kernels, label: str, nw: dict) -> dict:
    """The node world's pair path: N_PAIRS pairs of 2 x 2,097,152 flows
    through PersistentPairDispatcher (K = PERSIST_K: PERSISTENT_PAIR), the
    launch counts set to 0 just before and read just after; its outputs
    against the plain version; then one traced run of the same loop for
    the device's idle share and its host-to-device copies, and one with
    CUDA events around each super-batch's copy and kernel (the device's
    busy time without the profiler)."""
    from cilium_tpu_torch.device import u32_tensor
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import verdict

    w, tables = nw["w"], nw["tables"]
    pairs = w.pairs(seed=59, half=HALF, k=N_PAIRS)
    acc = verdict.make_counter_buffers(tables.policy)
    tel = verdict.make_telemetry_buffers(acc.device)
    disp = dp.PersistentPairDispatcher(tables, PERSIST_K, acc, tel)
    torch.cuda.synchronize()
    reset_counts(kernels)
    t = time.perf_counter()
    results = []
    for p in pairs:
        results.extend(disp.submit(p))
    rem, acc, tel = disp.flush()
    results.extend(rem)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = kernels.PERSISTENT_PAIR.launches
    pair_launches = kernels.DATAPATH_PAIR.launches
    others = {k.name: k.launches for k in kernels.KERNELS
              if k.launches and k is not kernels.PERSISTENT_PAIR}
    flows = N_PAIRS * 2 * HALF
    acc_p = verdict.make_counter_buffers(tables.policy)
    tel_p = verdict.make_telemetry_buffers(acc_p.device)
    err = 0
    for p, got in zip(pairs, results):
        pt = torch.from_numpy(p.view(np.int32)).cuda()
        pi, pe, acc_p, tel_p = dp.datapath_pair_plain(tables, pt, acc_p, tel_p)
        err = max(err, compare(got, (pi, pe), dp))
    torch.cuda.synchronize()
    err = max(err, buf_err(acc, acc_p), buf_err(tel, tel_p))
    telem = (tel.cpu().to(torch.int64) & 0xFFFFFFFF).sum(dim=0).tolist()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    disp_t = dp.PersistentPairDispatcher(
        tables, PERSIST_K, verdict.make_counter_buffers(tables.policy),
        verdict.make_telemetry_buffers(acc.device))
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        for p in pairs:
            disp_t.submit(p)
        disp_t.flush()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t1) * 1e3
    busy = device_busy(prof)
    busy_ms = sum(busy.values())
    copies = h2d_copies(prof)
    for key, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:4]:
        print(f"  device {ms:.3f} ms  {key[:90]}", flush=True)
    # the profiler's later sessions in one process can lose every device
    # row: then its device time and copies were not measured
    traced = busy_ms > 0
    if traced and copies != disp_t.launches:
        raise SystemExit(f"node ({label}): {copies} host-to-device copies "
                         f"for {disp_t.launches} super-batches")
    # the same loop timed by CUDA events: each super-batch's copy and
    # kernel bracketed on the stream, the host staging before the bracket
    marks = []
    acc_e = verdict.make_counter_buffers(tables.policy)
    tel_e = verdict.make_telemetry_buffers(acc.device)
    program = dp.persistent_pair_program(PERSIST_K)
    host = np.empty((PERSIST_K,) + pairs[0].shape, np.uint32)
    host_t = torch.from_numpy(host.view(np.int32))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(0, N_PAIRS, PERSIST_K):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # the dispatcher's staging: torch's copy into the reused buffer
        for dst, p in zip(host_t, pairs[i:i + PERSIST_K]):
            dst.copy_(torch.from_numpy(p.view(np.int32)))
        start.record()
        stacked = u32_tensor(host, acc_e.device)
        _, _, acc_e, tel_e = program(tables, stacked, acc_e, tel_e)
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    events_wall_ms = (time.perf_counter() - t1) * 1e3
    events_busy_ms = sum(a.elapsed_time(b) for a, b in marks)
    phase("node", t, world=label, pairs=N_PAIRS, k=PERSIST_K,
          persistent_pair_launches=launches,
          datapath_pair_launches=pair_launches,
          h2d_copies=copies if traced else "not_measured",
          verdicts_per_s=round(flows / wall),
          wall_s=round(wall, 6), max_abs_err=err,
          traced_wall_ms=round(traced_ms, 3),
          device_busy_ms=(round(busy_ms, 3) if traced
                          else "not_measured"),
          device_idle_share=(round(1 - busy_ms / traced_ms, 4) if traced
                             else "not_measured"),
          events_wall_ms=round(events_wall_ms, 3),
          events_busy_ms=round(events_busy_ms, 3),
          events_idle_share=round(1 - events_busy_ms / events_wall_ms, 4),
          telemetry=json.dumps(dict(zip(verdict.TELEM_NAMES, telem))))
    if (launches != N_PAIRS // PERSIST_K or others or len(results) != N_PAIRS
            or err or telem[verdict.TELEM_TOTAL] != flows):
        raise SystemExit(f"node ({label}): {launches} PERSISTENT_PAIR "
                         f"launches for {N_PAIRS} pairs at K = {PERSIST_K}, "
                         f"others {others}, error {err}")
    return dict(launches=launches, pair_launches=pair_launches, err=err)


def datapath_timing(kernels, tables, wide_t, pair, pool, picks) -> dict:
    """DATAPATH_PAIR on one full pair (headline tables) and DATAPATH_STEP
    on CHURN_BATCH pool picks (wide tables): CUDA events over 20
    launches, the plain version's time, and each bound: the bytes this
    run's data needs (needed_bytes' count: the stream once, each
    distinct table row or word the flows select once, stashes and scan
    ranges whole, changed counters read and written) at 3.35 TB/s, or
    the operations (flow_ops, scan_ops) at 67 T/s, whichever is larger.
    Scratch carries; launches not counted."""
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import verdict

    acc = verdict.make_counter_buffers(tables.policy)
    tel = verdict.make_telemetry_buffers(acc.device)
    pair_ms = event_ms(lambda: kernels.DATAPATH_PAIR(tables, pair, acc, tel),
                       20)
    pair_plain = event_ms(
        lambda: dp.datapath_pair_plain(tables, pair, acc, tel), 3)
    pair_bytes, per_flow_rows = needed_bytes(tables, pair, dp, verdict,
                                             kernels)
    per_flow, egress = flow_ops(tables)
    half = int(pair.shape[2])
    halves = [dp.flow_batch_from_packed4(pair[h]) for h in (0, 1)]
    outs = dp.datapath_pair_plain(tables, pair, acc.clone(), tel.clone())
    pair_ops = per_flow * 2 * half + egress * half + sum(
        scan_ops(tables, f, o) for f, o in zip(halves, outs[:2]))
    b = int(picks.numel())
    flows = dp.flow_batch_from_packed(pool[:, picks.long()])
    step_ms = event_ms(lambda: kernels.DATAPATH_STEP(wide_t, pool, picks), 20)
    step_plain = event_ms(lambda: dp.datapath_step_plain(
        wide_t, dp.flow_batch_from_packed(pool[:, picks.long()])), 3)
    rows_b, _ = table_row_bytes(
        wide_t, kernels.datapath_reads(wide_t) + (("policy", "id_table"),),
        lambda: dp.datapath_step_plain(wide_t, flows))
    step_bytes = (b * (4 + out_bytes_per_flow(dp))
                  + int(torch.unique(picks).numel()) * 32 + rows_b)
    out = dp.datapath_step_plain(wide_t, flows)
    per_flow, egress = flow_ops(wide_t)
    step_ops = (per_flow * b + egress * int((flows.direction != 0).sum())
                + scan_ops(wide_t, flows, out))

    def row(ms, plain, nb, ops):
        bb, bo = nb / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
        return dict(ms=round(ms, 4), plain_ms=round(plain, 4), bytes=nb,
                    ops=ops, bound_ms=round(max(bb, bo), 6),
                    bound_by="bytes" if bb >= bo else "operations")

    return dict(pair=row(pair_ms, pair_plain, pair_bytes, pair_ops),
                pair_row_bytes_per_flow=round(per_flow_rows, 2),
                step=row(step_ms, step_plain, step_bytes, step_ops))


def plane_timing(kernels, w5, tables5, pair, node_prefilter) -> dict:
    """DATAPATH_PAIR on config 5's headline tables with one plane at a
    time in a node layout, on the same full pair: the node world's
    DIR-24-8 prefilter; config 5's services in the classic LB; its
    ipcache without range classes (the [B, P] scan over its ranges);
    its ipcache map as DIR-24-8 (the generic branch).  Each against its
    plain version on that pair (0 differences), then its time, plain
    time and bound as datapath_timing counts them."""
    from cilium_tpu_torch.convert import plane_to
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import verdict
    from cilium_tpu_torch.ipcache.lpm import build_lpm
    from cilium_tpu_torch.lb.device import compile_lb_classic

    variants = {
        "prefilter dir24_8": dataclasses.replace(
            tables5, prefilter=node_prefilter),
        "lb classic": dataclasses.replace(
            tables5, lb=plane_to(compile_lb_classic(w5.mgr), "cuda")),
        "ipcache scan": dataclasses.replace(
            tables5, ipcache=dataclasses.replace(tables5.ipcache,
                                                 range_rows=None)),
        "ipcache dir24_8": dataclasses.replace(
            tables5, ipcache=plane_to(build_lpm(w5.ipc_map), "cuda")),
    }
    out = {}
    for name, tabs in variants.items():
        acc = verdict.make_counter_buffers(tabs.policy)
        tel = verdict.make_telemetry_buffers(acc.device)
        k = kernels.DATAPATH_PAIR(tabs, pair, acc.clone(), tel.clone())
        p = dp.datapath_pair_plain(tabs, pair, acc.clone(), tel.clone())
        err = max(compare(k[:2], p[:2], dp), buf_err(k[2], p[2]),
                  buf_err(k[3], p[3]))
        ms = event_ms(lambda: kernels.DATAPATH_PAIR(tabs, pair, acc, tel), 20)
        plain = event_ms(lambda: dp.datapath_pair_plain(tabs, pair, acc, tel),
                         3)
        nb, _ = needed_bytes(tabs, pair, dp, verdict, kernels)
        per_flow, egress = flow_ops(tabs)
        half = int(pair.shape[2])
        halves = [dp.flow_batch_from_packed4(pair[h]) for h in (0, 1)]
        ops = per_flow * 2 * half + egress * half + sum(
            scan_ops(tabs, f, o) for f, o in zip(halves, p[:2]))
        bb, bo = nb / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
        out[name] = dict(layout=kernels.datapath_layout(tabs),
                         max_abs_err=err, ms=round(ms, 4),
                         plain_ms=round(plain, 4), bytes=nb, ops=ops,
                         bound_ms=round(max(bb, bo), 6),
                         bound_by="bytes" if bb >= bo else "operations")
    return out


def node_phases(kernels, w5, tables5, wide5, rows) -> tuple:
    """Both node worlds (node_world, node_check, node, node_timing), then
    config 5's DATAPATH_PAIR and DATAPATH_STEP timed again in the same
    run, and the pair with one node-layout plane at a time
    (node_planes); the results go into the kernels' rows: launches of
    each world's path (`launches_by_path`, PERSISTENT_PAIR's and
    DATAPATH_PAIR's), the worst error, per layout instantiation the time,
    plain time and bound (`by_layout`), and per swapped plane
    (`by_plane`).  Returns the node world and its headline host tables
    (the [B, P] scan's world, for dp_mesh_node)."""
    from cilium_tpu_torch.convert import flow_pool_to

    timing, launches, pair_launches, err, err_super = {}, {}, {}, 0, 0
    for label in NODE_WORLDS:
        nw = node_world_phase(kernels, label)
        e_pair, e_super = node_check(kernels, label, nw)
        err = max(err, e_pair)
        run = node_path(kernels, label, nw)
        err_super = max(err_super, e_super, run["err"])
        launches[label] = run["launches"]
        pair_launches[label] = run["pair_launches"]
        t = time.perf_counter()
        w = nw["w"]
        pair = torch.from_numpy(w.pairs(seed=61, half=HALF, k=1)[0].view(
            np.int32)).cuda()
        pool = flow_pool_to(w.pool, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(63)
        picks = torch.randint(0, pool.shape[1], (CHURN_BATCH,), generator=gen,
                              device="cuda", dtype=torch.int32)
        res = datapath_timing(kernels, nw["tables"], nw["wide_t"], pair, pool,
                              picks)
        timing[label] = dict(res, pair_layout=nw["layout"],
                             step_layout=nw["wide_layout"])
        if label == "node":
            node_prefilter = nw["tables"].prefilter
            node_keep = (nw["w"], nw["host"])
        phase("node_timing", t, world=label, **{
            k: json.dumps(v) if isinstance(v, dict) else v
            for k, v in timing[label].items()})
        del nw, pair, pool, picks
        torch.cuda.empty_cache()
    # config 5 again, in the same run as the node worlds
    t = time.perf_counter()
    pair = torch.from_numpy(w5.pairs(seed=41, half=HALF, k=1)[0].view(
        np.int32)).cuda()
    pool = flow_pool_to(w5.pool, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(77)
    picks = torch.randint(0, pool.shape[1], (CHURN_BATCH,), generator=gen,
                          device="cuda", dtype=torch.int32)
    res = datapath_timing(kernels, tables5, wide5, pair, pool, picks)
    timing["config5"] = dict(res,
                             pair_layout=kernels.datapath_layout(tables5),
                             step_layout=kernels.datapath_layout(wide5))
    phase("node_timing", t, world="config5", **{
        k: json.dumps(v) if isinstance(v, dict) else v
        for k, v in timing["config5"].items()})
    t = time.perf_counter()
    planes = plane_timing(kernels, w5, tables5, pair, node_prefilter)
    phase("node_planes", t, **{k: json.dumps(v) for k, v in planes.items()})
    err = max([err] + [v["max_abs_err"] for v in planes.values()])
    for r in rows:
        if r["name"] in (kernels.DATAPATH_PAIR.name,
                         kernels.DATAPATH_STEP.name):
            key = "pair" if r["name"] == kernels.DATAPATH_PAIR.name else "step"
            r["by_layout"] = {
                f"{tm[key + '_layout']} ({label})": tm[key]
                for label, tm in timing.items()}
            r["max_abs_err"] = max(r["max_abs_err"], err)
        if r["name"] == kernels.DATAPATH_PAIR.name:
            r["by_plane"] = {k: {f: v[f] for f in (
                "layout", "ms", "plain_ms", "bound_ms", "bound_by")}
                for k, v in planes.items()}
            r["launches_by_path"].update(pair_launches)
            r["launches"] = sum(r["launches_by_path"].values())
        if r["name"] == kernels.PERSISTENT_PAIR.name:
            r["launches_by_path"].update(launches)
            r["launches"] = sum(r["launches_by_path"].values())
            r["max_abs_err"] = max(r["max_abs_err"], err_super)
    return node_keep


# -- policy publication ----------------------------------------------------------

PUBLISH_PRIME_PORTS = (4301, 4302, 4303)  # bench.py:1390-1394
PUBLISH_TIMED_PORTS = tuple(range(4304, 4312))
PUBLISH_REMOVE_PORTS = (4311, 4310, 4309, 4308)
PUBLISH_NEW_IDS = tuple(range(70_000, 70_064))  # inside the identity pad
PUBLISH_NEW_PORTS = 64
PUBLISH_NEW_PORT_BASE = 40_000
PUBLISH_MEMO_PORT = 4312  # memo_check's delta publish
# bench.py:1400-1412's leaf list, and the stamp
PUBLISH_LEAVES = ("id_table", "id_direct", "id_lo_len", "port_slot",
                  "l4_meta", "l4_allow_bits", "l3_allow_bits", "l4_hash_rows",
                  "l4_hash_stash", "l4_wild_rows", "l4_wild_stash",
                  "generation")
M32 = 0xFFFFFFFF


def host_copy(t):
    """Host PolicyTables copied out of FleetCompiler's ping-pong
    buffers (the compiler overwrites them two compiles later)."""
    return dataclasses.replace(t, **{
        f.name: np.array(getattr(t, f.name), copy=True)
        for f in dataclasses.fields(t)
        if isinstance(getattr(t, f.name), np.ndarray)})


def epoch_err(dev, host) -> int:
    """Words of a device epoch that differ from the host tables it was
    published from, over PUBLISH_LEAVES (the stamp by its low 32
    bits); 0 means equal."""
    from cilium_tpu_torch.convert import _leaf_to

    bad = 0
    for name in PUBLISH_LEAVES:
        a, b = getattr(dev, name), getattr(host, name)
        if name in ("generation", "id_lo_len"):
            bad += int((int(a) & M32) != (int(b) & M32))
            continue
        want = _leaf_to(np.asarray(b), "cuda")
        if tuple(a.shape) != tuple(want.shape):
            bad += max(a.numel(), want.numel())
            continue
        bad += int((a != want).sum().item())
    return bad


def probe_cols(pub) -> tuple:
    """Probe tuples of every change the phase makes, and whether the
    current map states allow each: (columns, allowed bool [P]).  An
    ingress tuple of (endpoint, identity, TCP port) is allowed by its
    exact key or its identity's L3 key (no wildcard entry covers these
    ports)."""
    from cilium_tpu_torch.maps.policymap import INGRESS, pack_keys

    w = pub["w"]
    team = [int(m) for m in w.team_members[0]]
    ports = (PUBLISH_PRIME_PORTS + PUBLISH_TIMED_PORTS + (PUBLISH_MEMO_PORT,)
             + tuple(PUBLISH_NEW_PORT_BASE + i
                     for i in range(PUBLISH_NEW_PORTS)))
    ep = [0] * (len(team) * len(ports)) + [1] * len(PUBLISH_NEW_IDS)
    ident = team * len(ports) + list(PUBLISH_NEW_IDS)
    dport = [p for p in ports for _ in team] + [80] * len(PUBLISH_NEW_IDS)
    ep, ident, dport = (np.asarray(v, np.int64) for v in (ep, ident, dport))
    allowed = np.zeros(len(ep), bool)
    for e in (0, 1):
        st = pub["states"][e]
        sel = ep == e
        for key in (pack_keys(ident[sel], dport[sel], 6, INGRESS),
                    pack_keys(ident[sel], 0, 0, INGRESS)):
            allowed[sel] |= np.isin(key, st.keys_packed)
    cols = dict(ep_index=ep, identity=ident.astype(np.uint32), dport=dport,
                proto=np.full(len(ep), 6), direction=np.zeros(len(ep),
                                                               np.int64))
    return cols, allowed


def publish_step(pub, states, dirty, ids=None, keep=False) -> dict:
    """One policy update through the port: the fleet's map states
    (`dirty` endpoints' tokens bumped) -> FleetCompiler.compile ->
    delta_for against the store's spare epoch -> DeviceTableStore.publish,
    each timed; then every check of the publish phase.  Returns the
    step's record; with `keep` it holds the scatter's payloads and its
    base leaves (for the kernel's timing)."""
    from cilium_tpu_torch.compiler.delta import tables_nbytes
    from cilium_tpu_torch.convert import policy_tables_to
    from cilium_tpu_torch.engine.publish import (
        StaleEpochError,
        delta_payloads,
        scatter_segments_plain,
    )
    from cilium_tpu_torch.engine.verdict import TupleBatch, evaluate_batch

    fc, store = pub["fc"], pub["store"]
    for e in dirty:
        pub["tokens"][e] += 1
    pub["states"] = states
    if ids is not None:
        pub["ids"] = ids
    prev = store.current()
    t0 = time.perf_counter()
    host, _ = fc.compile(
        [(e, s, pub["tokens"][e]) for e, s in enumerate(states)], pub["ids"])
    t1 = time.perf_counter()
    delta = fc.delta_for(store.spare_stamp(), host)
    t2 = time.perf_counter()
    base = None
    if delta is not None:
        # the spare's leaves before the scatter writes them (the plain
        # version's input)
        spare = store.get(store.spare_stamp())
        base = {n: getattr(spare, n).clone() for n in delta.updates}
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    dev, st = store.publish(host, delta)
    t4 = time.perf_counter()
    snap = host_copy(host)
    rec = dict(mode=st.mode, compile_ms=(t1 - t0) * 1e3,
               delta_ms=(t2 - t1) * 1e3, publish_ms=(t4 - t3) * 1e3,
               bytes_h2d=st.bytes_h2d, full_bytes=tables_nbytes(host),
               scatter_leaves=st.scatter_leaves,
               replaced_leaves=st.replaced_leaves,
               kg=int(host.l4_meta.shape[2]),
               w=int(host.l3_allow_bits.shape[2]))
    # every leaf of the live epoch against the host compile; the
    # previous epoch (still live) against the snapshot it came from
    rec["live_err"] = epoch_err(dev, snap)
    rec["prev_err"] = (epoch_err(prev[1], pub["snaps"][-1])
                       if prev is not None else 0)
    # PUBLISH_SCATTER against its plain version on the same payloads and
    # base epoch
    rec["scatter_err"] = 0
    if base is not None:
        payloads = delta_payloads(delta, "cuda")
        scatter_segments_plain([(base[n], idx, vals)
                                for n, (idx, vals) in payloads.items()])
        rec["scatter_err"] = max([int_err(base[n], getattr(dev, n),
                                          u32=True) for n in base] + [0])
        if keep:
            rec["payloads"], rec["base"] = payloads, base
        del payloads
    # LATTICE on the live epoch against a fresh full upload of the host
    # tables, on bench's tuples and on the probes of every change
    fresh = policy_tables_to(snap, "cuda")
    cols, allowed = probe_cols(pub)
    probe = TupleBatch.from_numpy(**cols, device="cuda")
    rec["lattice_err"] = max(
        verdicts_err(evaluate_batch(dev, b), evaluate_batch(fresh, b))
        for b in (pub["batch"], probe))
    got = evaluate_batch(dev, probe).allowed.cpu().numpy().astype(bool)
    rec["probe_err"] = int((got != allowed).sum())
    rec["probe_allowed"] = allowed
    del fresh
    # the epoch two publishes back is refused
    pub["epochs"].append(dev)
    rec["stale_refused"] = True
    if len(pub["epochs"]) >= 3:
        try:
            store.check_current(pub["epochs"][-3])
            rec["stale_refused"] = False
        except StaleEpochError:
            pass
        store.check_current(pub["epochs"][-2])
    pub["snaps"] = (pub["snaps"] + [snap])[-2:]
    pub["epochs"] = pub["epochs"][-3:]
    rec["ok"] = (rec["live_err"] == 0 and rec["prev_err"] == 0
                 and rec["scatter_err"] == 0 and rec["lattice_err"] == 0
                 and rec["probe_err"] == 0 and rec["stale_refused"])
    return rec


def step_line(label, rec) -> None:
    print(f"  publish {label}: " + " ".join(
        f"{k}={round(v, 3) if isinstance(v, float) else v}"
        for k, v in rec.items()
        if k not in ("payloads", "base", "probe_allowed")), flush=True)


def memo_serve(cache, pol, batch) -> tuple:
    """One memo_evaluate through a VerdictCache (the daemon's serving
    shape): (Verdicts, the stats row)."""
    from cilium_tpu_torch.engine import memo

    stamp, rows = cache.acquire()
    v, rows2, _, st = memo.memo_evaluate(pol, batch, rows,
                                         rep_cap=MEMO_TUPLES)
    row = cache.account(st)
    cache.commit(stamp, rows2)
    return v, row


def memo_stamp(pol) -> tuple:
    """The verdict cache's stamp of a policy epoch, as bench.py forms it
    (`_memo_stamp`): the generation's low 32 bits and the layout."""
    from cilium_tpu_torch.compiler.tables import tables_layout_version

    return int(pol.generation) & M32, tables_layout_version(pol)


def publish_phases(kernels, w, rows) -> dict:
    """publish: config 5's map states (MapStateArrays) through the
    port's FleetCompiler and a default DeviceTableStore on the card:
    two full publishes, bench.py's 3 priming one-rule steps, 8 timed
    ones, 4 removals (the first around a memo stamp flush), one step
    that grows the identity universe and one that adds 64 ports past the
    slot pad; every step checked (publish_step).  Launch counts are set
    to 0 just before the steps and read just after.  Appends
    PUBLISH_SCATTER's row; returns the compiler and store for memo_check."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.compiler.tables import FleetCompiler
    from cilium_tpu_torch.engine import memo
    from cilium_tpu_torch.engine.publish import (
        DeviceTableStore,
        _resident_bytes,
        scatter_segments_plain,
    )
    from cilium_tpu_torch.engine.verdict import TupleBatch, evaluate_batch

    t = time.perf_counter()
    arrays = world.map_state_arrays(w.states)
    lt = world.lattice_tuples(w, LATTICE_TUPLES)
    pub = dict(w=w, fc=FleetCompiler(identity_pad=w.identity_pad,
                                     filter_pad=w.filter_pad),
               store=DeviceTableStore(), tokens=[0] * len(arrays),
               ids=list(w.identity_ids), states=arrays, snaps=[], epochs=[],
               batch=TupleBatch.from_numpy(**lt, device="cuda"))
    setup_s = time.perf_counter() - t
    full = [publish_step(pub, arrays, range(len(arrays))),
            publish_step(pub, arrays, ())]
    for i, rec in enumerate(full):
        step_line(f"full{i}", rec)
    phase("publish_setup", t, endpoints=len(arrays),
          entries=sum(len(a) for a in arrays), arrays_s=round(setup_s, 3),
          full_modes=[r["mode"] for r in full],
          full_compile_ms=[round(r["compile_ms"], 3) for r in full],
          full_upload_ms=[round(r["publish_ms"], 3) for r in full],
          full_bytes=full[0]["full_bytes"])

    t = time.perf_counter()
    reset_counts(kernels)
    steps = []

    def one_rule(label, port, remove=False, keep=False):
        states = world.one_rule_states(w, port, states=pub["states"],
                                       remove=remove)
        rec = publish_step(pub, states, (0,), keep=keep)
        step_line(label, rec)
        steps.append((label, rec))
        return rec

    for port in PUBLISH_PRIME_PORTS:
        one_rule(f"prime{port}", port)
    timed = [one_rule(f"timed{port}", port,
                      keep=port == PUBLISH_TIMED_PORTS[-1])
             for port in PUBLISH_TIMED_PORTS]

    # a memo stamp flush around the first removal: warm the cache on the
    # live epoch, publish, then the new stamp must flush it
    cache = memo.VerdictCache(n_rows=MEMO_ROWS, device="cuda")
    zt = TupleBatch.from_numpy(**memo_zipf_tuples(w, MEMO_TUPLES, 67),
                               device="cuda")
    live = pub["store"].current()[1]
    cache.ensure(memo_stamp(live))
    warm = [memo_serve(cache, live, zt)[1]["hits"] for _ in range(2)]
    flushes = cache.flushes
    removed = [one_rule(f"remove{PUBLISH_REMOVE_PORTS[0]}",
                        PUBLISH_REMOVE_PORTS[0], remove=True)]
    live = pub["store"].current()[1]
    flushed = cache.ensure(memo_stamp(live)) and cache.flushes == flushes + 1
    v0, r0 = memo_serve(cache, live, zt)
    memo_err = verdicts_err(v0, evaluate_batch(live, zt))
    v1, r1 = memo_serve(cache, live, zt)
    memo_err = max(memo_err, verdicts_err(v1, evaluate_batch(live, zt)))
    memo_ok = (flushed and warm[1] > 0 and r0["hits"] == 0
               and r1["hits"] > 0 and memo_err == 0)
    print(f"  publish memo flush: warm_hits={warm} flushed={flushed} "
          f"hits_after={[r0['hits'], r1['hits']]} err={memo_err}",
          flush=True)
    del zt, cache
    for port in PUBLISH_REMOVE_PORTS[1:]:
        removed.append(one_rule(f"remove{port}", port, remove=True))

    # the identity universe grows inside its pad (id_table and id_direct
    # scatter); endpoint 1 admits the new identities at L3
    from cilium_tpu_torch.maps.policymap import INGRESS, MapStateArrays, pack_keys

    st1 = pub["states"][1]
    new_keys = pack_keys(PUBLISH_NEW_IDS, 0, 0, INGRESS)
    states = list(pub["states"])
    states[1] = MapStateArrays.build(
        np.concatenate([st1.keys_packed, new_keys]),
        np.concatenate([st1.proxy, np.zeros(len(new_keys), np.uint32)]))
    grow = publish_step(pub, states, (1,),
                        ids=pub["ids"] + list(PUBLISH_NEW_IDS))
    step_line("identities", grow)
    steps.append(("identities", grow))
    # 64 new ports past the slot pad: Kg grows, whole leaves replaced
    states = pub["states"]
    for i in range(PUBLISH_NEW_PORTS):
        states = world.one_rule_states(w, PUBLISH_NEW_PORT_BASE + i,
                                       states=states)
    kg_before = grow["kg"]
    ports = publish_step(pub, states, (0,))
    step_line("ports", ports)
    steps.append(("ports", ports))
    torch.cuda.synchronize()
    launches = kernels.PUBLISH_SCATTER.launches
    path_s = time.perf_counter() - t

    delta_steps = [r for _, r in steps]
    scatters = sum(r["scatter_leaves"] > 0 for r in delta_steps)
    flips = int(sum((~steps[i - 1][1]["probe_allowed"]
                     & steps[i][1]["probe_allowed"]).sum()
                    for i in range(1, len(steps))))
    med = lambda k: float(np.median([r[k] for r in timed]))
    live = pub["store"].current()[1]
    ok = (all(r["ok"] for r in full + delta_steps)
          and all(r["mode"] == "full" for r in full)
          and all(r["mode"] == "delta" for r in delta_steps)
          and launches == scatters > 0 and memo_ok and flips > 0
          and grow["scatter_leaves"] > 0
          and ports["kg"] > kg_before and ports["replaced_leaves"] > 1)
    phase("publish", t, steps=len(steps), launches=launches,
          delta_scatters=scatters, path_s=round(path_s, 3),
          compile_ms=round(med("compile_ms"), 3),
          delta_for_ms=round(med("delta_ms"), 3),
          publish_ms=round(med("publish_ms"), 3),
          update_ms=round(med("compile_ms") + med("delta_ms")
                          + med("publish_ms"), 3),
          bytes_h2d=int(np.median([r["bytes_h2d"] for r in timed])),
          tables_nbytes=timed[-1]["full_bytes"],
          scatter_leaves=timed[-1]["scatter_leaves"],
          replaced_leaves=timed[-1]["replaced_leaves"],
          identity_step=json.dumps({k: grow[k] for k in (
              "bytes_h2d", "scatter_leaves", "replaced_leaves")}),
          port_step=json.dumps({k: ports[k] for k in (
              "kg", "bytes_h2d", "scatter_leaves", "replaced_leaves")}),
          kg=[kg_before, ports["kg"]], w=ports["w"],
          epoch_bytes=_resident_bytes(live),
          store_bytes=json.dumps(pub["store"].chip_bytes()),
          probe_flips=flips, memo_flush=memo_ok, ok=ok)
    if not ok:
        raise SystemExit("publish failed")

    # PUBLISH_SCATTER on the last timed step's payloads and base epoch:
    # the kernel, the plain version and one index_put_ per leaf (the
    # payloads are in range: torch would raise where jax drops)
    t = time.perf_counter()
    last = timed[-1]
    segs = [(last["base"][n].clone(), idx, vals)
            for n, (idx, vals) in last["payloads"].items()]
    plain = [(d.clone(), i, v) for d, i, v in segs]
    lib = [(d.clone(), i, v) for d, i, v in segs]
    tm = scatter_times(lambda: kernels.PUBLISH_SCATTER(segs),
                       lambda: [d.index_put_(i, v) for d, i, v in lib])
    plain_ms = event_ms(lambda: scatter_segments_plain(plain), 20)
    err = max(max(r["scatter_err"] for r in delta_steps),
              max(int_err(a[0], b[0], u32=True) for a, b in zip(segs, plain)))
    payload_bytes = sum(nbytes(*i) + 2 * nbytes(v) for _, i, v in segs)
    bound_ms = payload_bytes / HBM_BYTES_PER_S * 1e3
    geometry = scatter_geometry(segs, "publish")
    phase("publish_timing", t, ms=round(tm["device_ms"], 4),
          cold_ms=round(tm["cold_ms"], 4),
          events_ms=round(tm["events_ms"], 4), plain_ms=round(plain_ms, 4),
          library_ms=round(tm["library_device_ms"], 4),
          library_cold_ms=round(tm["library_cold_ms"], 4),
          library_events_ms=round(tm["library_events_ms"], 4),
          bound_ms=round(bound_ms, 4), payload_bytes=payload_bytes,
          leaves=[n for n in last["payloads"]],
          geometry=json.dumps(geometry), max_abs_err=err)
    if err:
        raise SystemExit("PUBLISH_SCATTER differs from its plain version")
    ab = scatter_ab(kernels, "publish", "publish", segs)
    rows.append(dict(kernel_row(
        kernels.PUBLISH_SCATTER, "cilium_tpu_torch/csrc/publish.cu",
        "cilium_tpu/engine/publish.py:232", launches, err, tm["device_ms"],
        plain_ms, bound_ms, 0.0, library_ms=tm["library_device_ms"]),
        cold_ms=tm["cold_ms"], events_ms=tm["events_ms"],
        library_cold_ms=tm["library_cold_ms"],
        library_events_ms=tm["library_events_ms"], leaves=len(segs),
        payload_bytes=payload_bytes, geometry=geometry, ab=ab))
    last.pop("payloads")
    last.pop("base")
    del segs, plain, lib, timed, steps
    return pub


# -- config 5 from rules ----------------------------------------------------------

RULES_TUPLES = 1 << 22  # bench.py's lattice line (--batch)
RULES_IP_TUPLES = 1 << 20  # rules_check's evaluate_batch_from_ips call
RULES_LOOKUP_HOST_ROWS = 8  # of the IP rows, also through lookup_host
RULE_PRIME_PORTS = (4301, 4302, 4303)  # bench.py:1390-1394
RULE_TIMED_PORTS = tuple(range(4304, 4312))
SHADOW_PORT = 4321
SHADOW_SERVE_ROWS = 1 << 17  # the serving plane's batch (serve.py)
MANAGER_RECORDS = 1 << 20
MANAGER_STALE_PORTS = (4331, 4332)
DIFF_ROW_BYTES = 2 * (1 + 4 + 1) + 4  # SHADOW_DIFF: six columns in, four out


def oracle_verdicts(states, cols, rows) -> tuple:
    """evaluate_batch_oracle over `rows` of the tuple columns, on a copy
    of the map states (the oracle counts hits; the endpoints' own
    counters stay as they are)."""
    from cilium_tpu_torch.engine.oracle import evaluate_batch_oracle

    return evaluate_batch_oracle(
        copy.deepcopy(list(states)), *(cols[k][rows] for k in (
            "ep_index", "identity", "dport", "proto", "direction",
            "is_fragment")))


def oracle_err(v, rows, want) -> int:
    """Rows of `v` (Verdicts on the card) at `rows` that differ from the
    oracle's (allowed, proxy_port, match_kind) columns."""
    got = [getattr(v, c)[torch.from_numpy(rows).cuda()].cpu().numpy()
           .astype(np.int64) for c in ("allowed", "proxy_port", "match_kind")]
    return int(sum((g != w.astype(np.int64)) for g, w in zip(got, want)).sum())


def timed_compiles(em) -> list:
    """Wall seconds of every EndpointManager.publish_tables (the fleet
    compile of a sweep) from now on, appended to the returned list."""
    seconds = []
    inner = em.publish_tables

    def publish_tables(*args, **kw):
        t = time.perf_counter()
        out = inner(*args, **kw)
        seconds.append(time.perf_counter() - t)
        return out

    em.publish_tables = publish_tables
    return seconds


def rules_setup(kernels) -> dict:
    """rules_setup: config 5 from rules (world.rules_world, bench.py's
    build_config5 at full width) through the port's Daemon on the card,
    then published_device()'s full upload, checked leaf for leaf."""
    from cilium_tpu_torch import world

    t = time.perf_counter()
    rw = world.rules_world()
    d = rw.daemon
    em = d.endpoint_manager
    spans = d.last_regen_spans.report()
    redirects = d.proxy.redirects
    entries = [len(s) for s in rw.states]
    host = host_copy(rw.tables)
    t1 = time.perf_counter()
    _, dev, index = em.published_device()
    upload_s = time.perf_counter() - t1
    st = em.last_publish_stats
    err = epoch_err(dev, host)
    phase("rules_setup", t, rules=len(rw.rules), endpoints=len(rw.index),
          identities=len(rw.ids), **{k: round(v, 3)
                                     for k, v in rw.timings.items()},
          regen_spans_s=json.dumps({k: round(v, 3) for k, v in spans.items()}),
          redirect_s=round(spans.get("proxy", 0.0), 3),
          redirects=len(redirects),
          proxy_ports=len({r.proxy_port for r in redirects.values()}),
          l7_rules=len(rw.l7_pairs),
          entries_per_endpoint=json.dumps([min(entries),
                                           int(np.median(entries)),
                                           max(entries)]),
          entries=sum(entries), upload_mode=st.mode,
          upload_bytes=st.bytes_h2d, upload_ms=round(st.seconds * 1e3, 3),
          published_device_ms=round(upload_s * 1e3, 3), epoch_err=err)
    if st.mode != "full" or err or not redirects or index != rw.index:
        raise SystemExit("rules_setup: the first device publish is not a "
                         "full upload equal to the host tables")
    return dict(rw=rw, dev=dev, host=host)


def rules_check(kernels, r) -> int:
    """rules_check: LATTICE on the from-rules epoch over 4,194,304
    tuples (world.rules_tuples), against the plain version on the card
    and 512 rows against the oracle over the published map states; then
    one evaluate_batch_from_ips call on the DIR-24-8 tables of the
    daemon's ipcache over sources drawn from the identity /32s, against
    the plain version, HostLPM plus the oracle on 512 rows and
    lookup_host on 8 of them.  Returns LATTICE's launches."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.convert import lpm_to
    from cilium_tpu_torch.engine.hostpath import HostLPM
    from cilium_tpu_torch.engine.verdict import (
        TupleBatch,
        evaluate_batch,
        evaluate_batch_from_ips,
    )
    from cilium_tpu_torch.ipcache.lpm import build_lpm, lookup_host

    t = time.perf_counter()
    rw, dev = r["rw"], r["dev"]
    cols = world.rules_tuples(rw, RULES_TUPLES, seed=71)
    batch = TupleBatch.from_numpy(**cols, device="cuda")
    r.update(cols=cols, batch=batch)
    torch.cuda.synchronize()
    reset_counts(kernels)
    v = evaluate_batch(dev, batch)
    torch.cuda.synchronize()
    launches = kernels.LATTICE.launches
    err = verdicts_err(v, lattice_plain(dev, batch)[0])
    rng = np.random.default_rng(72)
    rows = rng.integers(0, RULES_TUPLES, ORACLE_ROWS)
    bad = oracle_err(v, rows, oracle_verdicts(rw.states, cols, rows))
    allowed = v.allowed.to(torch.int64).sum().item() / RULES_TUPLES
    redirected = (v.proxy_port > 0).to(torch.int64).sum().item()

    # the CIDR path over the daemon's ipcache
    mappings = dict(rw.daemon.lpm_builder.mappings)
    lpm = lpm_to(build_lpm(mappings), "cuda")
    src = rw.id_ips[rng.integers(0, len(rw.id_ips), RULES_IP_TUPLES)]
    src_t = torch.from_numpy(src.view(np.int32)).cuda()
    sub = {k: c[:RULES_IP_TUPLES] for k, c in cols.items()}
    ip_batch = TupleBatch.from_numpy(**sub, device="cuda")
    torch.cuda.synchronize()
    n0 = kernels.LATTICE.launches
    vi = evaluate_batch_from_ips(lpm, dev, src_t, ip_batch)
    torch.cuda.synchronize()
    launches += kernels.LATTICE.launches - n0
    ip_err = verdicts_err(vi, lattice_plain(dev, ip_batch, lpm=lpm,
                                            src_ips=src_t)[0])
    host_lpm = HostLPM(mappings)
    ip_rows = rng.integers(0, RULES_IP_TUPLES, ORACLE_ROWS)
    ids = np.asarray([host_lpm.lookup(int(a)) for a in src[ip_rows]],
                     np.uint32)
    lookup_bad = sum(
        lookup_host(mappings, str(ipaddress.ip_address(int(src[k]))))
        != int(ids[i])
        for i, k in enumerate(ip_rows[:RULES_LOOKUP_HOST_ROWS]))
    sub_rows = {k: c[ip_rows] for k, c in sub.items()}
    sub_rows["identity"] = ids
    ip_bad = oracle_err(vi, ip_rows, oracle_verdicts(
        rw.states, sub_rows, np.arange(len(ip_rows))))
    phase("rules_check", t, tuples=RULES_TUPLES, launches=launches,
          max_abs_err=err, oracle_rows=ORACLE_ROWS, oracle_mismatches=bad,
          allowed_share=round(allowed, 6), redirected=redirected,
          ip_tuples=RULES_IP_TUPLES, ip_max_abs_err=ip_err,
          ip_oracle_mismatches=ip_bad, lookup_host_rows=RULES_LOOKUP_HOST_ROWS,
          lookup_host_mismatches=lookup_bad, prefixes=len(mappings))
    if err or bad or ip_err or ip_bad or lookup_bad or launches != 2 or (
            redirected == 0):
        raise SystemExit("rules_check: LATTICE on the from-rules epoch "
                         "differs from its plain version or the oracle")
    r["lattice_err"] = max(err, ip_err)
    return launches


def rule_step(d, compiles, port, label) -> dict:
    """One of bench.py's update steps: add_one_rule on `port`, the
    daemon's regenerate_all, published_device(); its split in ms (the
    fleet compiles from `compiles`, timed_compiles' list), its publish
    mode and bytes, and the epoch's error against its host tables."""
    from cilium_tpu_torch import world

    em = d.endpoint_manager
    n_comp = len(compiles)
    t0 = time.perf_counter()
    world.add_one_rule(d, port, label_prefix="bench-delta")
    t1 = time.perf_counter()
    d.regenerate_all("delta-update bench")
    t2 = time.perf_counter()
    _, dev, _ = em.published_device()
    t3 = time.perf_counter()
    st = em.last_publish_stats
    host = em.published()[1]
    rec = dict(mode=st.mode, bytes_h2d=st.bytes_h2d,
               policy_add_ms=(t1 - t0) * 1e3,
               map_states_ms=(t2 - t1 - sum(compiles[n_comp:])) * 1e3,
               compile_ms=sum(compiles[n_comp:]) * 1e3,
               delta_for_ms=(t3 - t2 - st.seconds) * 1e3,
               publish_ms=st.seconds * 1e3, update_ms=(t3 - t0) * 1e3,
               epoch_err=epoch_err(dev, host))
    print(f"  rule_update {label}{port}: " + " ".join(
        f"{k}={round(v, 3) if isinstance(v, float) else v}"
        for k, v in rec.items()), flush=True)
    return rec


def rule_update(kernels, r) -> int:
    """rule_update: bench.py's incremental update from a rule on the
    card: add_one_rule, the daemon's regenerate_all, published_device()
    (delta_for and PUBLISH_SCATTER); 3 priming steps, then 8 timed ones
    on fresh ports; every timed step a delta and every epoch equal to
    its host tables.  Returns PUBLISH_SCATTER's launches."""
    t = time.perf_counter()
    d = r["rw"].daemon
    compiles = timed_compiles(d.endpoint_manager)
    prime = [rule_step(d, compiles, p, "prime") for p in RULE_PRIME_PORTS]
    torch.cuda.synchronize()
    reset_counts(kernels)
    timed = [rule_step(d, compiles, p, "timed") for p in RULE_TIMED_PORTS]
    torch.cuda.synchronize()
    launches = kernels.PUBLISH_SCATTER.launches
    med = {k: round(float(np.median([s[k] for s in timed])), 3)
           for k in ("update_ms", "policy_add_ms", "map_states_ms",
                     "compile_ms", "delta_for_ms", "publish_ms")}
    ok = (all(s["mode"] == "delta" for s in timed)
          and all(s["epoch_err"] == 0 for s in prime + timed)
          and launches == len(timed))
    phase("rule_update", t, steps=len(prime) + len(timed), launches=launches,
          **med, bytes_h2d=int(np.median([s["bytes_h2d"] for s in timed])),
          modes=[s["mode"] for s in prime + timed], ok=ok)
    if not ok:
        raise SystemExit("rule_update: a timed step was not a delta, or an "
                         "epoch differs from its host tables")
    return launches


def shadow_phase(kernels, r) -> dict:
    """shadow: compile_candidate_world over one candidate rule (world.
    restricting_rule: an L3-only rule of rules_world restricted to one
    port under its labels), uploaded with policy_tables_to; LATTICE on
    the live and candidate epochs over rules_check's 4,194,304 tuples,
    then SHADOW_DIFF; against its plain version on the same columns, and
    512 rows against the numpy diff of the oracle over both worlds'
    map states."""
    from cilium_tpu_torch import shadow, world
    from cilium_tpu_torch.convert import policy_tables_to
    from cilium_tpu_torch.engine.verdict import evaluate_batch

    t = time.perf_counter()
    rw, batch, cols = r["rw"], r["batch"], r["cols"]
    em = rw.daemon.endpoint_manager
    cand = world.restricting_rule(rw.rules, SHADOW_PORT)
    t1 = time.perf_counter()
    tables_c, index_c, states_c = shadow.compile_candidate_world(
        rw.daemon, [cand])
    compile_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    cand_dev = policy_tables_to(tables_c, "cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t1
    _, live_dev, index = em.published_device()
    live_states = em.published_with_states()[3]
    torch.cuda.synchronize()
    reset_counts(kernels)
    lv = evaluate_batch(live_dev, batch)
    cv = evaluate_batch(cand_dev, batch)
    codes = shadow.diff_codes(lv.allowed, lv.proxy_port, lv.match_kind,
                              cv.allowed, cv.proxy_port, cv.match_kind)
    torch.cuda.synchronize()
    launches = {"lattice": kernels.LATTICE.launches,
                "shadow_diff": kernels.SHADOW_DIFF.launches}
    cols_v = (lv.allowed, lv.proxy_port, lv.match_kind,
              cv.allowed, cv.proxy_port, cv.match_kind)
    plain = shadow.diff_codes_plain(*cols_v)
    err = max(int_err(a, b) for a, b in zip(codes, plain))
    totals = torch.bincount(codes[3].to(torch.int64), minlength=4).tolist()
    changed = [int(c.to(torch.int64).sum().item()) for c in codes[:3]]
    rows = np.random.default_rng(73).integers(0, RULES_TUPLES, ORACLE_ROWS)
    want = shadow.diff_codes_np(*oracle_verdicts(live_states, cols, rows),
                                *oracle_verdicts(states_c, cols, rows))
    rows_t = torch.from_numpy(rows).cuda()
    bad = sum(int((c[rows_t].cpu().numpy() != w).sum())
              for c, w in zip(codes, want))
    phase("shadow", t, compile_s=round(compile_s, 3),
          upload_ms=round(upload_s * 1e3, 3), launches=json.dumps(launches),
          max_abs_err=err, transitions=json.dumps(dict(zip(
              (shadow.TRANS_NAMES[k] or "none" for k in range(4)), totals))),
          changed_allowed_proxy_kind=changed, oracle_rows=ORACLE_ROWS,
          oracle_mismatches=bad, same_index=index_c == index)
    if (err or bad or index_c != index or totals[shadow.TRANS_ALLOW_TO_DENY]
            == 0 or launches != {"lattice": 2, "shadow_diff": 1}):
        raise SystemExit("shadow: SHADOW_DIFF differs from its plain version "
                         "or the oracle, or the candidate changed no row")
    del cand_dev
    return dict(cols=cols_v, launches=launches["shadow_diff"], err=err,
                lattice_launches=launches["lattice"])


@contextlib.contextmanager
def gc_paused():
    """The garbage collector off while calls are queued behind a device
    spin: one pass over this process's objects can outlast the spin."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def queued_ms(fn, reps: int, spin_cycles: int = 50_000_000):
    """Device ms per call of `fn` with the host's launch time hidden:
    the calls queue behind a device spin (torch.cuda._sleep, about 25
    ms) while the events time them back to back.  None when the device
    reached the start event before the last call was queued (the host
    was slower than the spin)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with gc_paused():
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        late = start.query()
    torch.cuda.synchronize()
    return None if late else start.elapsed_time(end) / reps


SCATTER_REPS = 20
SCATTER_SPIN = 100_000_000  # cycles, about 50 ms: a host loop of copies fits


L2_FLUSH_BYTES = 128 << 20  # read before a cold call: the L2 is 50 MB


def cold_ms(fn, reps: int, spin_cycles: int = SCATTER_SPIN):
    """Device ms per call of `fn` with a cold L2: each call bracketed by
    its own events after a 128 MB read that evicts the L2 (clean lines:
    the call pays no write-back of another's), all queued behind a
    device spin (so no host time falls inside a bracket).  None when the
    device reached the first event before the last call was queued."""
    fn()
    scratch = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                          device="cuda")
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    with gc_paused():
        torch.cuda._sleep(spin_cycles)
        for start, end in ev:
            scratch.sum()
            start.record()
            fn()
            end.record()
        late = ev[0][0].query()
    torch.cuda.synchronize()
    return None if late else sum(s.elapsed_time(e) for s, e in ev) / reps


def spun_ms(measure, fn, what: str, reps: int = SCATTER_REPS) -> float:
    """`measure` (queued_ms or cold_ms) of `fn` over `reps` calls,
    again behind a ten times longer spin when the host fell behind the
    first (as mesh_timing does); SystemExit when it falls behind that."""
    for spin in (SCATTER_SPIN, 10 * SCATTER_SPIN):
        ms = measure(fn, reps, spin)
        if ms is not None:
            return ms
    raise SystemExit(f"{what}: the calls did not queue behind the device "
                     f"spin")


def scatter_times(kernel, library) -> dict:
    """A scatter kernel's and its library call's time over SCATTER_REPS
    calls each: device ms with the calls queued back to back behind a
    device spin (queued_ms: the payload and rows warm in the L2 where
    they fit), the same with the L2 evicted before each call (cold_ms),
    and the CUDA events a caller sees (event_ms; minus the device ms,
    the host's share)."""
    return dict(device_ms=spun_ms(queued_ms, kernel, "scatter timing"),
                cold_ms=spun_ms(cold_ms, kernel, "scatter timing"),
                events_ms=event_ms(kernel, SCATTER_REPS),
                library_device_ms=spun_ms(queued_ms, library,
                                          "scatter timing"),
                library_cold_ms=spun_ms(cold_ms, library, "scatter timing"),
                library_events_ms=event_ms(library, SCATTER_REPS))


def scatter_geometry(segs, kind: str) -> list:
    """Per segment [leaf shape, axis, index rows]; a publish's axis is
    its last indexed one (0, or 1 for port_slot's two)."""
    if kind == "publish":
        return [[list(d.shape), len(i) - 1, int(v.shape[0])]
                for d, i, v in segs]
    return [[list(d.shape), int(a), int(i.numel())] for d, a, i, _ in segs]


# -- the A/B: the parent commit's kernels beside this one's -----------------

SCATTER_AB_BUDGET_S = 120.0  # the four sites' A/B together
SCATTER_AB_TURNS = ("parent", "new", "new", "parent")
# the parent's libraries built, and the package's library each stands in
# for inside parent_library
AB_STEMS = ("publish", "churn", "datapath", "datapath6", "lattice",
            "datapath_mesh", "lookup", "memo", "mesh")
AB_LIBRARIES = {"churn": "CHURN_LIBRARY", "datapath": "DATAPATH_LIBRARY",
                "datapath6": "DATAPATH6_LIBRARY", "lattice": "LATTICE_LIBRARY",
                "datapath_mesh": "DP_MESH_LIBRARY", "lookup": "LOOKUP_LIBRARY",
                "memo": "MEMO_LIBRARY", "mesh": "MESH_LIBRARY"}
AB = {"lib": None, "source": None, "libs": {}, "sites": {}, "s": 0.0}


def _parent_mesh_args(kernels):
    """The parent's cms::CombineArgs, MemoFrontArgs and MemoBackArgs in
    csrc/mesh.cu (before MESH_COMBINE and MESH_MEMO_COMBINE's passes
    became cooperative launches that zero their own counter buffers:
    the wrapper's zero fills, the flag scan's scratch, the scatter-back
    through srow and gid)."""
    if "mesh_args" not in AB:
        P, I = ctypes.c_void_p, ctypes.c_int32
        tp = P * kernels.MESH_MAX_TP

        def mirror(name, fields):
            return type(name, (ctypes.Structure,), {"_fields_": fields})

        AB["mesh_args"] = (
            mirror("_ParentCombineArgs", [("parts", tp)] + [(n, P) for n in (
                "tuples", "meta", "valid", "allowed", "proxy_port",
                "match_kind", "l4", "l3", "telem", "replica")] + [
                (n, I) for n in ("B", "tp", "mode", "ew", "n_eps", "kg",
                                 "l3_shards", "c_local")]),
            mirror("_ParentMemoFrontArgs", [("recs", tp)] + [
                (n, P) for n in ("rep_orig", "n_unique", "tuples", "rep",
                                 "flags", "prefix", "sums", "n_elems",
                                 "miss_pos", "n_miss", "miss_pack")] + [
                (n, I) for n in ("B", "rep_cap", "miss_cap", "tp")]),
            mirror("_ParentMemoBackArgs", [("parts", tp)] + [
                (n, P) for n in (
                    "rep", "miss_pos", "n_miss", "miss_pack", "srow", "gid",
                    "n_unique", "dedup_overflow", "tuples", "keys", "meta",
                    "valid", "alive", "rv", "mv", "allowed", "proxy_port",
                    "match_kind", "hit", "l4", "l3", "telem", "replica",
                    "stats", "counters")] + [
                (n, I) for n in ("B", "rep_cap", "miss_cap", "tp", "ew",
                                 "n_eps", "kg", "l3_shards", "c_local",
                                 "failover", "l3_sharded", "wn",
                                 "w_local")]))
    return AB["mesh_args"]


def _parent_mesh_launch(kernels, launch: str, a, dev) -> None:
    err = getattr(AB["libs"]["mesh"], launch)(ctypes.byref(a),
                                              kernels._stream(dev))
    if err:
        raise SystemExit(f"ab: the parent's {launch}: CUDA error {err}")


class ParentMeshCombine:
    """The parent's MESH_COMBINE wrapper (its four zero fills, one
    launch), on the parent's build of csrc/mesh.cu."""

    def __init__(self, kernels) -> None:
        self.k = kernels

    def __call__(self, parts, tab, batch, g, valid=None, telemetry=True):
        from cilium_tpu_torch.engine.verdict import Verdicts

        k = self.k
        packed, dev, b = k._tuples(batch, "parent mesh_combine")
        a = _parent_mesh_args(k)[0]()
        rows = k.MESH_RECORD_ROWS if g.mode == 0 else k.ROUTED_RECORD_ROWS
        for n, part in enumerate(parts):
            a.parts[n] = k._ptr(part, f"record {n}", dev, shape=(rows, b))
        a.tuples = packed.data_ptr()
        l4t = k._l4_tables(tab, dev)
        a.meta, a.n_eps, a.kg = l4t.meta, l4t.n_eps, l4t.kg
        a.ew = l4t.ew if tab.l4_hash_rows is not None else 3
        keep = None
        if valid is not None:
            keep = valid.to(device=dev, dtype=torch.uint8).contiguous()
            a.valid = keep.data_ptr()
        cols = int(g.l3_shards) * int(g.c_local)
        out = Verdicts(
            allowed=torch.empty(b, dtype=torch.uint8, device=dev),
            proxy_port=torch.empty(b, dtype=torch.int32, device=dev),
            match_kind=torch.empty(b, dtype=torch.uint8, device=dev))
        l4 = torch.zeros((a.n_eps, 2, a.kg), dtype=torch.int32, device=dev)
        l3 = torch.zeros((a.n_eps, 2, cols), dtype=torch.int32, device=dev)
        replica = torch.zeros(1, dtype=torch.int32, device=dev)
        telem = (torch.zeros((2, k.TELEM_COLS), dtype=torch.int32,
                             device=dev) if telemetry else None)
        a.allowed = out.allowed.data_ptr()
        a.proxy_port = out.proxy_port.data_ptr()
        a.match_kind = out.match_kind.data_ptr()
        a.l4, a.l3, a.replica = l4.data_ptr(), l3.data_ptr(), replica.data_ptr()
        if telem is not None:
            a.telem = telem.data_ptr()
        a.B, a.tp, a.mode = b, len(parts), int(g.mode)
        a.l3_shards, a.c_local = int(g.l3_shards), int(g.c_local)
        _parent_mesh_launch(k, "launch_mesh_combine", a, dev)
        del keep
        return out, l4, l3, telem, replica[0]


class ParentMeshMemoCombine:
    """The parent's MESH_MEMO_COMBINE wrappers on its build of
    csrc/mesh.cu: the front (7 launches: the sum, the flag scan, the
    fill, the compaction, the pack) and the back (4 zero fills, 5
    launches, the scatter-back through srow and gid), each call's
    scratch allocated anew."""

    def __init__(self, kernels) -> None:
        self.k = kernels

    def front(self, records, g, packed, mg) -> dict:
        k = self.k
        dev, b = packed.device, int(packed.shape[1])
        a = _parent_mesh_args(k)[1]()
        for n, rec in enumerate(records):
            a.recs[n] = k._ptr(rec, f"record {n}", dev, shape=(4, mg.rep_cap))
        a.rep_orig = g["rep_orig"].data_ptr()
        a.n_unique = g["n_unique"].data_ptr()
        a.tuples = packed.data_ptr()
        out = {"rep": torch.empty((4, mg.rep_cap), dtype=torch.int32,
                                  device=dev),
               "miss_pos": torch.empty(mg.miss_cap, dtype=torch.int32,
                                       device=dev),
               "n_miss": torch.empty(1, dtype=torch.int32, device=dev),
               "miss_pack": torch.empty((6, mg.miss_cap), dtype=torch.int32,
                                        device=dev)}
        scratch = torch.empty((2, mg.rep_cap), dtype=torch.int32, device=dev)
        sums = torch.empty(max(-(-mg.rep_cap // 1024), 1), dtype=torch.int32,
                           device=dev)
        n_elems = torch.empty(1, dtype=torch.int32, device=dev)
        a.rep, a.miss_pos = out["rep"].data_ptr(), out["miss_pos"].data_ptr()
        a.n_miss, a.miss_pack = (out["n_miss"].data_ptr(),
                                 out["miss_pack"].data_ptr())
        a.flags, a.prefix = scratch[0].data_ptr(), scratch[1].data_ptr()
        a.sums, a.n_elems = sums.data_ptr(), n_elems.data_ptr()
        a.B, a.rep_cap, a.miss_cap, a.tp = b, mg.rep_cap, mg.miss_cap, mg.ntp
        _parent_mesh_launch(k, "launch_mesh_memo_front", a, dev)
        del scratch, sums, n_elems
        return out

    def back(self, front, rparts, tab, g, packed, keys, mg, rg, valid=None,
             alive_row=None, telemetry=True):
        from cilium_tpu_torch.engine.verdict import Verdicts

        k = self.k
        dev, b = keys.device, int(keys.shape[1])
        keep = []
        a = _parent_mesh_args(k)[2]()
        for n, part in enumerate(rparts):
            a.parts[n] = part.data_ptr()
        a.rep, a.miss_pos = front["rep"].data_ptr(), front["miss_pos"].data_ptr()
        a.n_miss, a.miss_pack = (front["n_miss"].data_ptr(),
                                 front["miss_pack"].data_ptr())
        a.srow, a.gid = g["srow"].data_ptr(), g["gid"].data_ptr()
        a.n_unique = g["n_unique"].data_ptr()
        a.dedup_overflow = g["overflow"].data_ptr()
        a.tuples, a.keys = packed.data_ptr(), keys.data_ptr()
        l4t = k._l4_tables(tab, dev)
        a.meta, a.n_eps, a.kg, a.ew = l4t.meta, l4t.n_eps, l4t.kg, l4t.ew
        if mg.failover and valid is not None:
            v8 = valid.to(device=dev, dtype=torch.uint8).contiguous()
            keep.append(v8)
            a.valid = v8.data_ptr()
        a.alive = k._alive_ptr(mg, alive_row, dev, keep)
        cols = int(rg.l3_shards) * int(rg.c_local)
        v = Verdicts(
            allowed=torch.empty(b, dtype=torch.uint8, device=dev),
            proxy_port=torch.empty(b, dtype=torch.int32, device=dev),
            match_kind=torch.empty(b, dtype=torch.uint8, device=dev))
        hit = torch.empty(b, dtype=torch.bool, device=dev)
        l4 = torch.zeros((a.n_eps, 2, a.kg), dtype=torch.int32, device=dev)
        l3 = torch.zeros((a.n_eps, 2, cols), dtype=torch.int32, device=dev)
        small = torch.zeros(9, dtype=torch.int32, device=dev)
        replica, stats, counters = small[0:1], small[1:6], small[6:9]
        telem = (torch.zeros((2, k.TELEM_COLS), dtype=torch.int32,
                             device=dev) if telemetry else None)
        rv = torch.empty((2, mg.rep_cap), dtype=torch.int32, device=dev)
        mv = torch.empty((2, mg.miss_cap), dtype=torch.int32, device=dev)
        a.rv, a.mv = rv.data_ptr(), mv.data_ptr()
        a.allowed, a.proxy_port = v.allowed.data_ptr(), v.proxy_port.data_ptr()
        a.match_kind, a.hit = v.match_kind.data_ptr(), hit.data_ptr()
        a.l4, a.l3 = l4.data_ptr(), l3.data_ptr()
        if telem is not None:
            a.telem = telem.data_ptr()
        a.replica, a.stats = replica.data_ptr(), stats.data_ptr()
        a.counters = counters.data_ptr()
        a.B, a.rep_cap, a.miss_cap, a.tp = b, mg.rep_cap, mg.miss_cap, mg.ntp
        a.l3_shards, a.c_local = int(rg.l3_shards), int(rg.c_local)
        a.failover, a.l3_sharded = int(mg.failover), int(rg.l3_sharded)
        a.wn, a.w_local = int(rg.wn), int(rg.w_local)
        _parent_mesh_launch(k, "launch_mesh_memo_back", a, dev)
        del keep, rv
        return v, l4, l3, telem, replica, hit, stats, mv


def _bind_parent_mesh(kernels, lib) -> None:
    """The parent's csrc/mesh.cu: bound as this package's where its
    argument blocks are this package's sizes; else (a parent before the
    combines became cooperative launches) its unchanged launchers with
    this package's blocks and the combine and the memo combine's with
    the mirrors of _parent_mesh_args, every size checked against the
    parent's own, and parent_library then swaps in ParentMeshCombine and
    ParentMeshMemoCombine."""
    lib.mesh_struct_sizes.argtypes = [ctypes.POINTER(ctypes.c_int)]
    sizes = (ctypes.c_int * 9)()
    lib.mesh_struct_sizes(sizes)
    if list(sizes) == [ctypes.sizeof(x) for x in (
            kernels.PolicyViewArgs, kernels.MeshProbeArgs,
            kernels.RoutedProbeArgs, kernels.CombineArgs, kernels.SortArgs,
            kernels.MemoProbeArgs, kernels.MemoFrontArgs,
            kernels.MemoBackArgs, kernels.MemoInsertArgs)]:
        kernels._MeshLibrary().bind(lib)
        return
    AB["mesh_mirrors"] = True
    combine, front, back = _parent_mesh_args(kernels)
    blocks = (("launch_mesh_probe", kernels.MeshProbeArgs),
              ("launch_routed_probe", kernels.RoutedProbeArgs),
              ("launch_mesh_combine", combine),
              ("launch_mesh_memo_probe", kernels.MemoProbeArgs),
              ("launch_mesh_memo_front", front),
              ("launch_mesh_memo_back", back),
              ("launch_mesh_memo_insert", kernels.MemoInsertArgs))
    kernels._Library.declare(lib, blocks)
    want = [ctypes.sizeof(x) for x in (
        kernels.PolicyViewArgs, kernels.MeshProbeArgs,
        kernels.RoutedProbeArgs, combine, kernels.SortArgs,
        kernels.MemoProbeArgs, front, back, kernels.MemoInsertArgs)]
    if list(sizes) != want:
        raise SystemExit(f"ab: the parent's mesh.cu argument blocks are "
                         f"{list(sizes)} bytes, the mirrors {want}")


def ab_start(kernels, parent: str) -> list:
    """Start nvcc on `parent`/cilium_tpu_torch/csrc/<stem>.cu (a `git
    archive` of the parent commit) for each of AB_STEMS, with the
    package's flags, into cilium_tpu_torch/_build/ab/; returns the
    running builds for ab_load."""
    from pathlib import Path

    jobs = []
    for stem in AB_STEMS:
        src = Path(parent) / "cilium_tpu_torch" / "csrc" / f"{stem}.cu"
        if not src.is_file():
            raise SystemExit(f"ab: no {src}")
        out = kernels.BUILD_DIR / "ab" / f"lib{stem}_parent.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        jobs.append((stem, src, out, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return jobs


def ab_load(kernels, jobs) -> None:
    """Wait for ab_start's builds and bind them, each argument layout
    checked against the parent's own sizes: publish.cu's launchers (the
    tile table of kernels.scatter_args), and the others by their
    library's own bind (AB_LIBRARIES)."""
    t = time.perf_counter()
    for stem, src, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"ab: nvcc of {src} failed:\n{log}")
        lib = ctypes.CDLL(str(out))
        if stem == "publish":
            kernels._PublishLibrary().bind(lib)
            AB.update(lib=lib, source=str(src))
        elif stem == "mesh":
            _bind_parent_mesh(kernels, lib)
        else:
            type(getattr(kernels, AB_LIBRARIES[stem]))().bind(lib)
        AB["libs"][stem] = lib
    phase("ab_build", t, sources=[str(j[1]) for j in jobs])


def _parent_scatter(kernels, launch: str, geometry, segments) -> None:
    """The parent's PUBLISH_SCATTER or REPAIR_SCATTER launch on the
    segments' tile table (its wrapper's checks and tiling are this
    package's: the parent's argument layout is the same)."""
    dev = segments[0][0].device
    args = kernels.scatter_args([geometry(s, dev) for s in segments],
                                "scatter_ab")
    err = getattr(AB["lib"], launch)(ctypes.addressof(args),
                                     kernels._stream(dev))
    if err:
        raise SystemExit(f"scatter_ab: the parent's {launch}: {err}")


def _parent_publish(kernels, segments) -> None:
    _parent_scatter(kernels, "launch_publish_scatter",
                    lambda s, dev: kernels._publish_geometry(*s, dev),
                    segments)


def _parent_repair(kernels, segments) -> None:
    _parent_scatter(kernels, "launch_repair_scatter",
                    lambda s, dev: kernels._repair_geometry(
                        s[0], int(s[1]), s[2], s[3], dev), segments)


def parent_ct_delta(kernels, snap, idx, rows) -> None:
    """The parent's CT_DELTA: this package's wrapper, its checks and
    argument block (the parent's layout is the same), launching the
    parent's build; its launch not counted."""
    lib, n = kernels.CHURN_LIBRARY, kernels.CT_DELTA.launches
    mine, lib.lib = lib.lib, AB["libs"]["churn"]
    try:
        kernels.CT_DELTA(snap, idx, rows)
    finally:
        lib.lib = mine
        kernels.CT_DELTA.launches = n


@contextlib.contextmanager
def parent_library(kernels, stem: str):
    """The wrappers of csrc/<stem>.cu (AB_LIBRARIES) launch the parent's
    build inside; for a mesh.cu of other argument blocks
    (_bind_parent_mesh), kernels.MESH_COMBINE and
    kernels.MESH_MEMO_COMBINE are the parent's own wrappers there
    (ParentMeshCombine, ParentMeshMemoCombine).  The launch counts are
    left as they were."""
    lib = getattr(kernels, AB_LIBRARIES[stem])
    mine = lib.load()
    counts = [k.launches for k in kernels.KERNELS]
    swapped = {}
    if stem == "mesh" and AB.get("mesh_mirrors"):
        swapped = {"MESH_COMBINE": kernels.MESH_COMBINE,
                   "MESH_MEMO_COMBINE": kernels.MESH_MEMO_COMBINE}
        kernels.MESH_COMBINE = ParentMeshCombine(kernels)
        kernels.MESH_MEMO_COMBINE = ParentMeshMemoCombine(kernels)
    lib.lib = AB["libs"][stem]
    try:
        yield
    finally:
        lib.lib = mine
        for name, k in swapped.items():
            setattr(kernels, name, k)
        for k, n in zip(kernels.KERNELS, counts):
            k.launches = n


def parent_datapath(kernels):
    """DATAPATH_PAIR, PERSISTENT_PAIR and DATAPATH_STEP launch the
    parent's csrc/datapath.cu inside."""
    return parent_library(kernels, "datapath")


def _tensors(x):
    """The tensors of a kernel's result, in order (tuples, lists and
    dataclasses walked)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


LIB_AB_REPS = 20


def library_ab(kernels, stem: str, calls: dict, device: bool = True):
    """The parent's build of csrc/<stem>.cu against this one's
    (--ab-parent) on `calls` ({name: a call of one of its kernels}):
    each call's result once under each, every entry agreeing (SystemExit
    otherwise); then CUDA events over LIB_AB_REPS calls and (with
    `device`) device ms with the calls queued behind a device spin, in
    turns parent, new, new, parent, and their medians.  `device` False
    for calls that wait on the device (an evaluator).  Launches not
    counted; None without the parent."""
    if stem not in AB["libs"]:
        return None
    t = time.perf_counter()
    launches = [k.launches for k in kernels.KERNELS]
    differ = {}
    for name, fn in calls.items():
        new = list(_tensors(fn()))
        with parent_library(kernels, stem):
            old = list(_tensors(fn()))
        torch.cuda.synchronize()
        differ[name] = (sum(entries_differ(a, b) for a, b in zip(new, old))
                        + abs(len(new) - len(old)))
        del new, old
    rec = {f"{who}_{name}_{m}": [] for who in ("parent", "new")
           for name in calls
           for m in (("ms", "device_ms") if device else ("ms",))}
    for who in SCATTER_AB_TURNS:
        ctx = (parent_library(kernels, stem) if who == "parent"
               else contextlib.nullcontext())
        with ctx:
            for name, fn in calls.items():
                rec[f"{who}_{name}_ms"].append(event_ms(fn, LIB_AB_REPS))
                if device:
                    rec[f"{who}_{name}_device_ms"].append(
                        spun_ms(queued_ms, fn, f"{stem}_ab"))
    for k, n in zip(kernels.KERNELS, launches):
        k.launches = n
    out = dict(differing=differ,
               medians={k: round(float(np.median(v)), 4)
                        for k, v in rec.items()},
               turns={k: [round(x, 4) for x in v] for k, v in rec.items()},
               source=str(kernels.BUILD_DIR / "ab" / f"lib{stem}_parent.so"),
               seconds=round(time.perf_counter() - t, 3))
    print(f"  {stem}_ab " + json.dumps(out), flush=True)
    if any(differ.values()):
        raise SystemExit(f"{stem}_ab: entries differ between the parent's "
                         f"kernels and this one's: {differ}")
    return out


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of `fn`: the time to queue `calls`
    calls, none waited for (the device runs behind)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def scatter_ab(kernels, site: str, kind: str, segs):
    """The parent's kernel against this one on copies of `segs` (the
    site's own segments, `kind` "publish" or "repair"), in chunks of
    MAX_SCATTER_SEGMENTS a launch: each writes its copies once and every
    entry must agree (SystemExit otherwise), then both are timed in
    turns parent, new, new, parent (device ms queued behind a spin and
    CUDA events over SCATTER_REPS calls, host µs over 200).  The new kernel's launch
    count is left as it was.  None when no parent was built."""
    if AB["lib"] is None:
        return None
    t = time.perf_counter()
    new = kernels.PUBLISH_SCATTER if kind == "publish" else (
        kernels.REPAIR_SCATTER)
    old = _parent_publish if kind == "publish" else _parent_repair
    step = kernels.MAX_SCATTER_SEGMENTS
    copies = {w: [(s[0].clone(),) + tuple(s[1:]) for s in segs]
              for w in ("parent", "new")}
    calls = {
        "parent": lambda: [old(kernels, copies["parent"][k:k + step])
                           for k in range(0, len(segs), step)],
        "new": lambda: [new(copies["new"][k:k + step])
                        for k in range(0, len(segs), step)],
    }
    launches = new.launches
    calls["parent"]()
    calls["new"]()
    torch.cuda.synchronize()
    differ = sum(entries_differ(a[0], b[0])
                 for a, b in zip(copies["parent"], copies["new"]))
    rec = {f"{w}_{m}": [] for w in ("parent", "new")
           for m in ("ms", "events_ms", "host_us")}
    for who in SCATTER_AB_TURNS:
        rec[f"{who}_ms"].append(spun_ms(queued_ms, calls[who],
                                        f"scatter_ab {site}"))
        rec[f"{who}_events_ms"].append(event_ms(calls[who], SCATTER_REPS))
        rec[f"{who}_host_us"].append(host_us(calls[who]))
    new.launches = launches
    del copies
    AB["s"] += time.perf_counter() - t
    rec.update(differing=differ, segments=len(segs),
               seconds=round(time.perf_counter() - t, 3))
    AB["sites"][site] = rec
    print(f"  scatter_ab {site} " + json.dumps(rec), flush=True)
    if differ:
        raise SystemExit(f"scatter_ab {site}: {differ} entries differ "
                         f"between the parent's kernel and this one")
    if AB["s"] > SCATTER_AB_BUDGET_S:
        raise SystemExit(f"scatter_ab: {AB['s']:.1f} s past its budget of "
                         f"{SCATTER_AB_BUDGET_S} s")
    return rec


SCATTER_AB_SITES = ("publish", "readmission", "datapath_delta", "relayout")


def scatter_ab_phase() -> None:
    """scatter_ab: the four sites' A/B in one line; fails when a site
    was not reached."""
    if AB["lib"] is None:
        return
    missing = [s for s in SCATTER_AB_SITES if s not in AB["sites"]]
    med = lambda v: round(float(np.median(v)), 4)
    phase("scatter_ab", time.perf_counter() - AB["s"], source=AB["source"],
          sites=json.dumps({s: dict(
              {k: med(v) for k, v in r.items() if isinstance(v, list)},
              differing=r["differing"]) for s, r in AB["sites"].items()}),
          missing=missing)
    if missing:
        raise SystemExit(f"scatter_ab: sites not reached: {missing}")


def shadow_timing(kernels, s) -> dict:
    """shadow_timing: SHADOW_DIFF at 4,194,304 rows and at the serving
    plane's 131,072: its device time over 20 launches queued behind a
    device spin (`ms`), CUDA events over 20 launches as the caller sees
    them (`wrapper_ms`: the wrapper's host time when a launch takes
    less), its plain version, and the bound: 16 B a row (six columns
    read, four written) at 3.35 TB/s."""
    from cilium_tpu_torch import shadow

    t = time.perf_counter()
    res = {}
    for n in (RULES_TUPLES, SHADOW_SERVE_ROWS):
        cols = tuple(c[:n] for c in s["cols"])
        res[n] = dict(
            ms=queued_ms(lambda: kernels.SHADOW_DIFF(*cols), 20),
            wrapper_ms=event_ms(lambda: kernels.SHADOW_DIFF(*cols), 20),
            plain_ms=event_ms(lambda: shadow.diff_codes_plain(*cols), 5),
            bound_ms=DIFF_ROW_BYTES * n / HBM_BYTES_PER_S * 1e3)
    main, serve = res[RULES_TUPLES], res[SHADOW_SERVE_ROWS]
    r4 = lambda v: None if v is None else round(v, 4)
    phase("shadow_timing", t, rows=RULES_TUPLES, ms=r4(main["ms"]),
          wrapper_ms=r4(main["wrapper_ms"]), plain_ms=r4(main["plain_ms"]),
          bound_ms=r4(main["bound_ms"]), serve_rows=SHADOW_SERVE_ROWS,
          serve_ms=r4(serve["ms"]), serve_wrapper_ms=r4(serve["wrapper_ms"]),
          serve_plain_ms=r4(serve["plain_ms"]),
          serve_bound_ms=r4(serve["bound_ms"]))
    if main["ms"] is None or serve["ms"] is None:
        raise SystemExit("shadow_timing: the launches did not queue behind "
                         "the device spin")
    return dict(kernel_row(
        kernels.SHADOW_DIFF, "cilium_tpu_torch/csrc/shadow.cu",
        "cilium_tpu/shadow.py:90", s["launches"], s["err"], main["ms"],
        main["plain_ms"], main["bound_ms"], 0.0),
        wrapper_ms=main["wrapper_ms"], serve_rows=SHADOW_SERVE_ROWS,
        serve_ms=serve["ms"], serve_wrapper_ms=serve["wrapper_ms"],
        serve_plain_ms=serve["plain_ms"], serve_bound_ms=serve["bound_ms"])


def manager_replay(kernels, r) -> int:
    """manager_replay: replay_lattice(manager=...) over 1,048,576 records
    of the from-rules world with counters (LATTICE), against the plain
    loop; sync_counters_to_endpoints, whose synced packets must equal
    the counters' sum; then the snapshot two publishes old is refused.
    Returns LATTICE's launches."""
    from cilium_tpu_torch import replay as rp
    from cilium_tpu_torch import world
    from cilium_tpu_torch.native.loader import FLOW_RECORD_DTYPE

    t = time.perf_counter()
    rw = r["rw"]
    d = rw.daemon
    em = d.endpoint_manager
    buf = world.rules_records(rw, MANAGER_RECORDS, seed=74)
    _, dev, index = em.published_device()
    torch.cuda.synchronize()
    reset_counts(kernels)
    st, l4, l3 = rp.replay_lattice(dev, buf, REPLAY_BATCH, manager=em)
    torch.cuda.synchronize()
    launches = kernels.LATTICE.launches
    with PlainRoute(kernels, {"LATTICE": lattice_plain}):
        sp, p4, p3 = rp.replay_lattice(dev, buf, REPLAY_BATCH, manager=em)
    fields = ("total", "allowed", "denied", "redirected", "batches")
    same = (all(getattr(st, f) == getattr(sp, f) for f in fields)
            and np.array_equal(l4, p4) and np.array_equal(l3, p3))

    def packets():
        return sum(int(e.realized_map_state.packets.sum())
                   for e in em.endpoints())

    before = packets()
    t1 = time.perf_counter()
    updated = rp.sync_counters_to_endpoints(l4, l3, em, dev, index)
    sync_s = time.perf_counter() - t1
    synced = packets() - before
    hits = int(l4.sum()) + int(l3.sum())
    # two publishes later the snapshot is refused, the live epoch is not
    for port in MANAGER_STALE_PORTS:
        world.add_one_rule(d, port, label_prefix="stale")
        d.regenerate_all("stale snapshot")
        live = em.published_device()[1]
    try:
        rp.replay_lattice(dev, buf[:4096 * FLOW_RECORD_DTYPE.itemsize], 4096,
                          manager=em)
        refused = False
    except ValueError as exc:
        refused = "stale" in str(exc)
    em.check_tables_current(live)
    phase("manager_replay", t, records=st.total, batches=st.batches,
          launches=launches, seconds=round(st.seconds, 4),
          records_per_s=round(st.total / st.seconds),
          equal_to_plain=same, l4_hits=int(l4.sum()), l3_hits=int(l3.sum()),
          entries_updated=updated, synced_packets=synced,
          sync_s=round(sync_s, 3), stale_refused=refused)
    if (not same or synced != hits or not refused or updated == 0
            or launches != st.batches or st.total != MANAGER_RECORDS):
        raise SystemExit("manager_replay: the replay differs from the plain "
                         "loop, the synced packets differ from the counters, "
                         "or the stale snapshot was not refused")
    return launches


TRACE_PRIME_PORT = 4340
TRACE_PORTS = tuple(range(4341, 4341 + 8))
TRACE_SEAMS = ("compiler.compile", "compiler.delta_for", "publish.epoch")


def trace_spans(kernels, r) -> None:
    """trace_spans: rule_update's steps (rule_step) on 8 fresh ports after
    a priming one, each under a root span of the port's module tracer:
    every step must export
    exactly one compiler.compile, one compiler.delta_for and one
    publish.epoch span in its trace, and publish a delta equal to its
    host tables.  Prints the seams' median ms beside the step's own split
    and render_span_tree of the last step."""
    from collections import Counter

    from cilium_tpu_torch import tracing

    t = time.perf_counter()
    d = r["rw"].daemon
    compiles = timed_compiles(d.endpoint_manager)
    rule_step(d, compiles, TRACE_PRIME_PORT, "prime")
    tr = tracing.tracer
    tr.reset(seed=12, sample_rate=1.0)
    recs, seam_ms, counts = [], {k: [] for k in TRACE_SEAMS}, []
    for port in TRACE_PORTS:
        with tr.span("rule_update.step", site="smoke",
                     attrs={"port": port}) as root:
            recs.append(rule_step(d, compiles, port, "traced"))
        spans = tr.get_trace(root.trace_id)
        counts.append(Counter(sp.name for sp in spans))
        for sp in spans:
            if sp.name in seam_ms:
                seam_ms[sp.name].append(sp.duration_ms)
    print(tracing.render_span_tree([sp.to_dict() for sp in spans]),
          end="", flush=True)
    med = {f"{k}_ms": round(float(np.median(v)), 3)
           for k, v in seam_ms.items()}
    split = {k: round(float(np.median([rec[k] for rec in recs])), 3)
             for k in ("compile_ms", "delta_for_ms", "publish_ms",
                       "update_ms")}
    ok = (all(c[k] == 1 for c in counts for k in TRACE_SEAMS)
          and all(rec["mode"] == "delta" and rec["epoch_err"] == 0
                  for rec in recs)
          and tr.dropped == 0)
    phase("trace_spans", t, steps=len(TRACE_PORTS),
          spans_per_step=json.dumps(dict(counts[-1])),
          seams=json.dumps(med), split=json.dumps(split),
          tracer_overhead_ms=round(tr.overhead_s * 1e3, 3),
          spans_finished=tr.finished_total, ok=ok)
    if not ok:
        raise SystemExit("trace_spans: a step did not export one span per "
                         "seam, or did not publish a delta equal to its "
                         "host tables")


def rules_phases(kernels, rows) -> None:
    """Config 5 from rules: rules_setup, rules_check, rule_update, shadow,
    shadow_timing, manager_replay (each resets the launch counts just
    before its path and reads them just after) and trace_spans (which
    counts spans); SHADOW_DIFF's row is appended to `rows`, and LATTICE's and
    PUBLISH_SCATTER's rows count these paths' launches too
    (`launches_by_path`)."""
    r = rules_setup(kernels)
    n_lat = rules_check(kernels, r)
    n_pub = rule_update(kernels, r)
    s = shadow_phase(kernels, r)
    n_lat += s["lattice_launches"]
    rows.append(shadow_timing(kernels, s))
    del s
    n_lat += manager_replay(kernels, r)
    trace_spans(kernels, r)
    for row in rows:
        extra = {"lattice": n_lat, "publish_scatter": n_pub}.get(row["name"])
        if extra is not None:
            row["launches_by_path"] = {"earlier": row["launches"],
                                       "rules": extra}
            row["launches"] += extra
    del r


MEMO_ROWS = 1 << 14  # bench.py's VerdictCache(n_rows=1 << 14)
MEMO_REP_CAP = max(HALF >> 2, 1 << 10)  # bench.py's memo_rep_cap
MEMO_OVERFLOW_CAP = 1 << 10
MEMO_ZIPF_S = 1.1  # bench.py --zipf-s
MEMO_PAIRS = 8
MEMO_DEPTH = 2  # the AsyncBatchDispatcher's depth
MEMO_TUPLES = 1 << 22  # memo_evaluate's Zipf tuples
MEMO_CALLS = 8
MEMO_KERNELS = ("datapath_pair_memo", "memo_dedup", "memo_cache",
                "memo_keys_lattice")


def memo_err(k, p, dp) -> int:
    """Max difference between two memoized pairs' outputs: the 15
    columns of both halves, the counters, the telemetry, the rows, the
    hit flags and the stats."""
    return max(compare(k[:2], p[:2], dp), buf_err(k[2], p[2]),
               buf_err(k[3], p[3]), int_err(k[4], p[4], u32=True),
               int_err(k[5], p[5]), int_err(k[6], p[6]),
               int_err(k[7], p[7], u32=True))


def memo_gate(kernels, tables, pair_host, cache, rep_cap):
    """One pair through the memoized kernels, the plain memoized pair
    and the uncached DATAPATH_PAIR, from fresh carries and the cache's
    rows (bench.py's _memo_gate): returns (stats row, error against the
    plain version, error against the uncached pair over the 15 columns,
    the counters and the telemetry, hits consistent with the stats)."""
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import memo
    from cilium_tpu_torch.engine import verdict

    pt = torch.from_numpy(pair_host.view(np.int32)).cuda()
    stamp, rows = cache.acquire()
    acc = verdict.make_counter_buffers(tables.policy)
    tel = verdict.make_telemetry_buffers("cuda")
    bufs = [(acc.clone(), tel.clone()) for _ in range(3)]
    k = memo.memo_pair_packed4(tables, pt, rows, *bufs[0], rep_cap)
    p = memo.memo_pair_plain(tables, pt, rows, *bufs[1], rep_cap)
    u = kernels.DATAPATH_PAIR(tables, pt, *bufs[2])
    torch.cuda.synchronize()
    row = cache.account(k[7])
    err_ref = max(compare(k[:2], u[:2], dp), buf_err(k[2], u[2]),
                  buf_err(k[3], u[3]))
    hits = int(k[5].sum().item() + k[6].sum().item()) == row["hits"]
    cache.commit(stamp, k[4])
    return row, memo_err(k, p, dp), err_ref, hits


def memo_pair_inputs(keys):
    """The plain lattice inputs of a pair half from its key words (exact
    for packed4 flows: ep < 2^16, direction 0 or 1)."""
    from cilium_tpu_torch.device import widen

    k0, k1, k2 = (widen(keys[i]) for i in range(3))
    return dict(keys=(k0, k1, k2), idx=k0, known=((k1 >> 1) & 1).bool(),
                l3_bit=(k1 & 1).bool(), ep=k2 >> 1, dirn=k2 & 1,
                dport=k1 >> 16, proto=(k1 >> 8) & 0xFF)


def groups_to_card(g):
    """dedup_groups' plain dict as MEMO_CACHE takes MEMO_DEDUP's."""
    i32 = lambda x: x.to(torch.int32).contiguous()
    dev = g["srow"].device
    return dict(srow=i32(g["srow"]), gid=i32(g["gid"]), rgid=i32(g["rgid"]),
                rep_orig=i32(g["rep_orig"]),
                n_unique=torch.tensor([g["n_unique"]], dtype=torch.int32,
                                      device=dev),
                overflow=torch.tensor([g["overflow"]], dtype=torch.int32,
                                      device=dev))


def dedup_err(k, p) -> int:
    err = max(int_err(k[n], p[n]) for n in ("srow", "gid", "rgid",
                                            "rep_orig", "rep_valid"))
    return max(err, abs(int(k["n_unique"].item()) - p["n_unique"]),
               abs(int(k["overflow"].item()) - p["overflow"]))


MEMO_DISTINCT = HALF  # the all-distinct dedup batch


def dedup_case_keys(seed: int) -> dict:
    """MEMO_DEDUP's edge cases, {name: keys int32 [3, B] on the card}:
    100,000 equal keys, MEMO_DISTINCT distinct ones (every word varies),
    one row, 10,007 rows of 3,001 keys (not a multiple of the 2,048- or
    4,096-row tiles), 50,000 rows of 700 keys with bit 31 set in each
    word."""
    rng = np.random.default_rng(seed)

    def card(words):
        return torch.from_numpy(np.ascontiguousarray(
            words.astype(np.uint32)).view(np.int32)).cuda()

    def drawn(n, k, high=False):
        base = rng.integers(0, 1 << 32, (k, 3), dtype=np.int64)
        if high:
            base |= 1 << 31
        return base[rng.integers(0, k, n)].T

    b = MEMO_DISTINCT
    distinct = np.stack([
        np.arange(b, dtype=np.uint64) * 2654435761 % (1 << 32),
        rng.integers(0, 1 << 32, b, dtype=np.int64),
        rng.integers(0, 1 << 32, b, dtype=np.int64)])
    equal = np.array([[0x80000001], [0xFFFFFFFF], [0x7FFFFFFF]],
                     dtype=np.int64)
    return {"all_equal": card(np.tile(equal, (1, 100_000))),
            "all_distinct": card(distinct), "one_row": card(drawn(1, 1)),
            "ragged": card(drawn(10_007, 3_001)),
            "bit31": card(drawn(50_000, 700, high=True))}


def dedup_cases_check(kernels, cases: dict) -> dict:
    """MEMO_DEDUP against its plain version on each of `cases`
    (dedup_case_keys) at rep_cap n_unique, half of it (an overflow) and
    n_unique + 5: {case: max error}."""
    from cilium_tpu_torch.device import widen
    from cilium_tpu_torch.engine import memo

    errs = {}
    for name, keys in cases.items():
        inp = [widen(keys[i]) for i in range(3)]
        u = memo.dedup_groups(*inp, 1)["n_unique"]
        errs[name] = max(
            dedup_err(kernels.MEMO_DEDUP(keys, cap),
                      memo.dedup_groups(*inp, cap))
            for cap in sorted({u, max(u // 2, 1), u + 5}))
    torch.cuda.synchronize()
    return errs


DEDUP_QUEUED = 5  # the parent's dedup is some 60 launches a call: a
# longer queue behind the spin fills the launch queue and blocks the host


def dedup_ab(kernels, batches: dict, rep_cap: int) -> dict:
    """MEMO_DEDUP on each of `batches` ({name: keys}) at rep_cap: CUDA
    events over 20 calls and device ms over DEDUP_QUEUED calls queued
    behind a spin, in turns parent, new, new, parent with the parent's
    build (--ab-parent; every output entry equal, SystemExit otherwise),
    else this build's twice; medians.  Launches not counted."""
    ab = "memo" in AB["libs"]

    def parent_dedup(k):
        with parent_library(kernels, "memo"):
            return kernels.MEMO_DEDUP(k, rep_cap)

    calls = {"new": lambda k: kernels.MEMO_DEDUP(k, rep_cap),
             "parent": parent_dedup}
    launches = kernels.MEMO_DEDUP.launches
    differ = {}
    if ab:
        for name, k in batches.items():
            a, b = calls["new"](k), calls["parent"](k)
            differ[name] = sum(entries_differ(a[f], b[f]) for f in b)
    rec = {}
    for who in SCATTER_AB_TURNS if ab else ("new", "new"):
        for name, k in batches.items():
            fn = lambda: calls[who](k)
            rec.setdefault(f"{who}_{name}_ms", []).append(event_ms(fn, 20))
            rec.setdefault(f"{who}_{name}_device_ms", []).append(
                spun_ms(queued_ms, fn, "memo_ab", DEDUP_QUEUED))
    kernels.MEMO_DEDUP.launches = launches
    med = {k: round(float(np.median(v)), 4) for k, v in rec.items()}
    out = dict(differing=differ, rep_cap=rep_cap, medians=med,
               turns={k: [round(x, 4) for x in v] for k, v in rec.items()})
    if ab:  # rgid's writes: the device ms against the parent's
        out["device_ms_over_parent"] = {
            name: round(med[f"new_{name}_device_ms"]
                        - med[f"parent_{name}_device_ms"], 4)
            for name in batches}
    print("  memo_ab " + json.dumps(out), flush=True)
    if any(differ.values()):
        raise SystemExit(f"memo_ab: MEMO_DEDUP's outputs differ from the "
                         f"parent's: {differ}")
    return out


def spun_host_us(fn, calls: int = 20) -> float:
    """Host microseconds per call of `fn` with the launches queued behind
    a device spin (the device busy, so the host never waits on it)."""
    fn()
    torch.cuda.synchronize()
    with gc_paused():
        torch.cuda._sleep(SCATTER_SPIN)
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def cache_ab(kernels, pol, keys, gs, rows, has_l3: bool) -> dict:
    """MEMO_CACHE on both halves of a Zipf pair (`keys` [2, 3, B] and
    their MEMO_DEDUP groups `gs`) from the warm `rows`, as the memoized
    pair runs it: the ingress half copies the rows into a buffer and
    commits there, the egress half commits in place, adds to the stats
    and restores the rows on an overflow.  Per half: device ms over 20
    calls queued behind a spin, CUDA events over 20 calls and the
    wrapper's host µs per call queued behind a spin, in turns parent,
    new, new, parent with the parent's build (--ab-parent: both halves'
    v0, v1, hit, the rows and the stats must agree, SystemExit
    otherwise), else this build's twice; medians.  Launches not
    counted."""
    from cilium_tpu_torch.engine import memo

    ab = "memo" in AB["libs"]
    b = int(keys.shape[2])
    def parent_cache(*a, **k):
        with parent_library(kernels, "memo"):
            return kernels.MEMO_CACHE(*a, **k)

    impl = {"new": kernels.MEMO_CACHE, "parent": parent_cache}
    bufs = {who: dict(rows=torch.empty_like(rows),
                      stats=torch.empty(memo.STATS, dtype=torch.int32,
                                        device="cuda"),
                      vals=torch.empty((2, 2, b), dtype=torch.int32,
                                       device="cuda"),
                      hits=torch.empty((2, b), dtype=torch.bool,
                                       device="cuda"))
            for who in ("new", "parent")}

    def half(who, h):
        u = bufs[who]
        return lambda: impl[who](
            pol, keys[h], gs[h], rows if h == 0 else u["rows"], u["rows"],
            u["stats"], rep_cap=MEMO_REP_CAP, has_l3=has_l3,
            accumulate=h == 1, restore=rows if h == 1 else None,
            out=(u["vals"][h, 0], u["vals"][h, 1], u["hits"][h]))

    launches = kernels.MEMO_CACHE.launches
    differ = None
    if ab:
        for who in ("new", "parent"):
            half(who, 0)()
            half(who, 1)()
        torch.cuda.synchronize()
        differ = {k: entries_differ(bufs["new"][k], bufs["parent"][k])
                  for k in ("rows", "stats", "vals", "hits")}
    rec = {}
    for who in SCATTER_AB_TURNS if ab else ("new", "new"):
        for h in (0, 1):
            fn = half(who, h)
            rec.setdefault(f"{who}_half{h}_device_ms", []).append(
                spun_ms(queued_ms, fn, "cache_ab"))
            rec.setdefault(f"{who}_half{h}_ms", []).append(event_ms(fn, 20))
            rec.setdefault(f"{who}_half{h}_host_us", []).append(
                spun_host_us(fn))
    kernels.MEMO_CACHE.launches = launches
    out = dict(differing=differ, rep_cap=MEMO_REP_CAP,
               medians={k: round(float(np.median(v)), 4)
                        for k, v in rec.items()},
               turns={k: [round(x, 4) for x in v] for k, v in rec.items()})
    print("  cache_ab " + json.dumps(out), flush=True)
    if differ and any(differ.values()):
        raise SystemExit(f"cache_ab: MEMO_CACHE's outputs differ from the "
                         f"parent's: {differ}")
    return out


CACHE_CASE_ROWS = 1 << 6  # a narrow cache: many keys a bucket


CACHE_MANY_TUPLES = 1 << 19  # more representatives than HIT_SMEM_WORDS' bits


def distinct_tuples(w, seed: int) -> dict:
    """CACHE_MANY_TUPLES of bench's lattice tuples with their dports drawn
    over the whole range: nearly every tuple a key of its own."""
    from cilium_tpu_torch import world

    cols = world.lattice_tuples(w, CACHE_MANY_TUPLES, seed=seed)
    cols["dport"] = np.random.default_rng(seed).integers(
        0, 1 << 16, CACHE_MANY_TUPLES)
    return cols


def cache_cases_check(kernels, pol, keys2, has_l3: bool, many) -> dict:
    """MEMO_CACHE against memo_cache_plain on both halves of a pair's
    keys (`keys2` [2, 3, B]; the ingress half copies the rows and commits
    into the copy, the egress half commits in place, adds to the stats
    and restores on an overflow), over the three layouts at 8, 16 and 32
    entries (CACHE_CASE_ROWS rows: ranks past the lanes), one bucket for
    every representative, one key (U = 1), rep_cap = U, an overflow of
    the second half with the restore, and `many` (keys [2, 3, B'] without
    an L3 bit whose halves hold more representatives than a block's
    shared memory holds hit bits: the kernel reads them from global
    memory): {case: differing entries of v0, v1, hit, the rows and the
    stats}."""
    from cilium_tpu_torch.convert import cache_rows_to
    from cilium_tpu_torch.device import widen
    from cilium_tpu_torch.engine import memo

    def rows_of(layout, e, n):
        if layout == "legacy":
            return np.full((n + 1, memo.CACHE_WORDS * e), memo.EMPTY,
                           np.uint32)
        return memo.make_cache_rows(n, e, subword=layout == "subword")

    cases = {f"{lay}_{e}": (lay, e, CACHE_CASE_ROWS, keys2, (None, None),
                            has_l3)
             for lay in ("legacy", "rank", "subword") for e in (8, 16, 32)}
    one = keys2[:, :, :1].expand(-1, -1, 1 << 16).contiguous()
    cases.update(one_bucket=("rank", 8, 1, keys2, (None, None), has_l3),
                 one_key=("rank", 8, CACHE_CASE_ROWS, one, (None, None),
                          has_l3),
                 rep_cap_u=("subword", 16, CACHE_CASE_ROWS, keys2,
                            ("u", "u"), has_l3),
                 overflow_restore=("rank", 8, CACHE_CASE_ROWS, keys2,
                                   (None, "half"), has_l3),
                 many_reps=("rank", 8, MEMO_ROWS, many, (None, None),
                            False))
    launches = kernels.MEMO_CACHE.launches
    errs = {}
    for name, (layout, e, n, kk, caps, has_l3) in cases.items():
        rows = cache_rows_to(rows_of(layout, e, n), "cuda")
        out_rows = torch.empty_like(rows)
        stats = torch.empty(memo.STATS, dtype=torch.int32, device="cuda")
        p_rows = rows
        p_stats = torch.zeros(memo.STATS, dtype=torch.int64, device="cuda")
        err = 0
        for h in (0, 1):
            keys = kk[h]
            k0, k1, k2 = (widen(keys[i]) for i in range(3))
            u = memo.dedup_groups(k0, k1, k2, 1)["n_unique"]
            cap = {None: int(keys.shape[1]), "u": u,
                   "half": max(u // 2, 1)}[caps[h]]
            g = memo.dedup_groups(k0, k1, k2, cap)
            got = kernels.MEMO_CACHE(
                pol, keys, groups_to_card(g), rows if h == 0 else out_rows,
                out_rows, stats, rep_cap=cap, has_l3=has_l3,
                accumulate=h == 1, restore=rows if h == 1 else None)
            pv0, pv1, phit, prow, pst = memo.memo_cache_plain(
                pol, p_rows, (k0, k1, k2), g, k0, ((k1 >> 1) & 1).bool(),
                (k1 & 1).bool() if has_l3 else None, k2 >> 1, k2 & 1,
                k1 >> 16, (k1 >> 8) & 0xFF, cap)
            p_stats = p_stats + pst
            restored = h == 1 and int(p_stats[memo.STAT_OVERFLOW]) != 0
            p_rows = rows if restored else prow
            torch.cuda.synchronize()
            err += (int_err(got[0], pv0, u32=True)
                    + int_err(got[1], pv1, u32=True) + int_err(got[2], phit)
                    + int_err(out_rows, p_rows, u32=True)
                    + int_err(stats, p_stats, u32=True))
        if name == "overflow_restore" and not restored:
            err += 1
        errs[name] = err
    kernels.MEMO_CACHE.launches = launches
    return errs


@contextlib.contextmanager
def parent_memo_pair(kernels):
    """The memoized pair's kernels launch the parent's builds inside:
    csrc/datapath.cu's front and back passes and csrc/memo.cu's
    MEMO_DEDUP and MEMO_CACHE (--ab-parent)."""
    with parent_library(kernels, "datapath"), parent_library(kernels, "memo"):
        yield


def memo_pair_ab(kernels, tables, pt, rows, acc, tel) -> dict:
    """The whole memoized pair (memo_pair_packed4) against the same pair
    on the parent's builds of csrc/datapath.cu and csrc/memo.cu
    (--ab-parent): every output equal (SystemExit otherwise), then CUDA
    events and device ms over 20 pairs, in turns parent, new, new,
    parent; medians.  None without the parent's builds.  Launches not
    counted."""
    from cilium_tpu_torch.engine import memo

    if "memo" not in AB["libs"] or "datapath" not in AB["libs"]:
        return None
    launches = [k.launches for k in kernels.KERNELS]

    def run(a, t_):
        return memo.memo_pair_packed4(tables, pt, rows, a, t_, MEMO_REP_CAP)

    got = {}
    for who in ("new", "parent"):
        ctx = (parent_memo_pair(kernels) if who == "parent"
               else contextlib.nullcontext())
        with ctx:
            got[who] = list(_tensors(run(acc.clone().zero_(),
                                         tel.clone().zero_())))
    torch.cuda.synchronize()
    differ = sum(entries_differ(a, b) for a, b in zip(got["new"],
                                                       got["parent"]))
    rec = {}
    for who in SCATTER_AB_TURNS:
        ctx = (parent_memo_pair(kernels) if who == "parent"
               else contextlib.nullcontext())
        with ctx:
            fn = lambda: run(acc, tel)  # noqa: E731
            rec.setdefault(f"{who}_ms", []).append(event_ms(fn, 20))
            rec.setdefault(f"{who}_device_ms", []).append(
                spun_ms(queued_ms, fn, "memo_pair_ab", DEDUP_QUEUED))
    for k, n in zip(kernels.KERNELS, launches):
        k.launches = n
    out = dict(differing=differ,
               medians={k: round(float(np.median(v)), 4)
                        for k, v in rec.items()},
               turns={k: [round(x, 4) for x in v] for k, v in rec.items()})
    print("  memo_pair_ab " + json.dumps(out), flush=True)
    if differ:
        raise SystemExit(f"memo_pair_ab: {differ} entries differ from the "
                         f"parent's memoized pair")
    return out


def memo_keys_plain(pol, batch):
    """MEMO_KEYS_LATTICE's keys mode, plain: [3, B] int64 u32 values."""
    from cilium_tpu_torch.device import widen
    from cilium_tpu_torch.engine import memo
    from cilium_tpu_torch.engine.verdict import _index_identity

    idx, known = _index_identity(pol, widen(batch.identity))
    return torch.stack(memo.memo_key_words(
        idx, known, None, batch.ep_index.to(torch.int64),
        batch.direction.to(torch.int64),
        batch.dport.to(torch.int64).clamp(0, 65535),
        batch.proto.to(torch.int64).clamp(0, 255)))


def memo_policy_churn(w, tables, pub):
    """The stamp flush's new epoch: one more one-rule update (team 0 ->
    endpoint 0 on TCP PUBLISH_MEMO_PORT) published through the publish
    phase's FleetCompiler and DeviceTableStore (a delta publish, every
    publish_step check), its host tables in the headline layout beside
    the other planes, as bench.py's memo section repacks the daemon's
    published tables.  The policy keeps the epoch's generation stamp."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.compiler.tables import repack_l4_subword, split_hot
    from cilium_tpu_torch.convert import policy_tables_to

    states = world.one_rule_states(w, PUBLISH_MEMO_PORT, states=pub["states"])
    rec = publish_step(pub, states, (0,))
    step_line("memo", rec)
    if rec["mode"] != "delta" or not rec["ok"]:
        raise SystemExit("memo_check's delta publish failed")
    pol = split_hot(repack_l4_subword(pub["snaps"][-1]))
    return dataclasses.replace(tables, policy=policy_tables_to(pol, "cuda"))


def memo_zipf_tuples(w, n: int, seed: int) -> dict:
    """`n` lattice tuples whose rows are drawn rank-Zipf(1.1) from 65,536
    of bench's lattice tuples."""
    from cilium_tpu_torch import world

    base = world.lattice_tuples(w, 1 << 16, seed=seed)
    picks = world.zipf_picks(np.random.default_rng(seed + 1), 1 << 16, n,
                             MEMO_ZIPF_S)
    return {k: v[picks] for k, v in base.items()}


def memo_check(kernels, w, tables, pub) -> dict:
    """memo_check: bench.py's memo gates on the card at rep_cap = HALF
    (uniform cold and warm, Zipf twice) and once more on the Zipf pair
    at the timed loop's rep_cap (MEMO_REP_CAP), each new kernel against its
    plain version on the Zipf pair's keys, the stamp flush onto the
    policy of a delta publish through the port's FleetCompiler and
    DeviceTableStore (memo_policy_churn; the cache's stamp is bench.py's
    `_memo_stamp`: 0 hits, then hits), the overflow case (rep_cap
    1,024: stats, and the carried state unchanged) and memo_evaluate
    against LATTICE and its plain version on 4,194,304 Zipf tuples
    (cold and warm).  Also a hot pair (world.hot_pair: one flow that
    counts a hit takes 3 rows of 4 of each half of the Zipf pair) cold
    and warm, and the overflow case on a pair whose ingress half is all
    that flow and fits the capacity while its egress half overflows it.
    The limit is 0 differences."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.convert import cache_rows_to
    from cilium_tpu_torch.device import widen
    from cilium_tpu_torch.engine import memo
    from cilium_tpu_torch.engine import verdict
    from cilium_tpu_torch.engine.verdict import TupleBatch

    t = time.perf_counter()
    cache = memo.VerdictCache(n_rows=MEMO_ROWS, device="cuda")
    cache.ensure(memo_stamp(tables.policy))
    uni = w.pairs(seed=41, half=HALF, k=1)[0]
    zp = world.zipf_pairs(w, np.random.default_rng(53), HALF, 1,
                          MEMO_ZIPF_S)[0]
    err_plain = err_ref = 0
    hits = {}
    consistent = True
    # the last gate runs at the timed loop's rep_cap
    for tag, pair, cap in (("uniform_cold", uni, HALF),
                           ("uniform_warm", uni, HALF), ("zipf", zp, HALF),
                           ("zipf_warm", zp, HALF),
                           ("zipf_timed_cap", zp, MEMO_REP_CAP)):
        row, ep_, er, ok = memo_gate(kernels, tables, pair, cache, cap)
        err_plain, err_ref = max(err_plain, ep_), max(err_ref, er)
        consistent &= ok and row["overflow"] == 0
        hits[tag] = row["hits"]
    # a hot pair: the Zipf pair with one flow that counts a hit in 3 rows
    # of 4 of each half (one hot counter cell a half for the back pass's
    # aggregated atomics), cold and warm
    ki, ke, _, _ = kernels.DATAPATH_PAIR(
        tables, torch.from_numpy(zp.view(np.int32)).cuda(),
        verdict.make_counter_buffers(tables.policy),
        verdict.make_telemetry_buffers("cuda"))
    kinds = [ki.match_kind.cpu().numpy(), ke.match_kind.cpu().numpy()]
    hot = world.hot_pair(zp, kinds, 0.75, 91)
    for tag in ("hot", "hot_warm"):
        row, ep_, er, ok = memo_gate(kernels, tables, hot, cache, HALF)
        err_plain, err_ref = max(err_plain, ep_), max(err_ref, er)
        consistent &= ok and row["overflow"] == 0
        hits[tag] = row["hits"]

    gate_rows = dict(cache.snapshot())

    # each new kernel against its plain version on the Zipf pair's keys
    pt = torch.from_numpy(zp.view(np.int32)).cuda()
    front = kernels.DATAPATH_PAIR_MEMO.front(tables, pt)
    keys = front.keys[0]
    g_k = kernels.MEMO_DEDUP(keys, HALF)
    inp = memo_pair_inputs(keys)
    g_p = memo.dedup_groups(*inp["keys"], HALF)
    err_dedup = dedup_err(g_k, g_p)
    cases = dedup_case_keys(71)
    err_cases = dedup_cases_check(kernels, cases)
    err_dedup = max(err_dedup, *err_cases.values())
    rows = cache.rows
    out_k = torch.empty_like(rows)
    st_k = torch.empty(memo.STATS, dtype=torch.int32, device="cuda")
    v0, v1, hit = kernels.MEMO_CACHE(
        tables.policy, keys, groups_to_card(g_p), rows, out_k, st_k,
        rep_cap=HALF, has_l3=front.has_l3)
    pv0, pv1, phit, prow, pst = memo.memo_cache_plain(
        tables.policy, rows, inp["keys"], g_p, inp["idx"], inp["known"],
        inp["l3_bit"] if front.has_l3 else None, inp["ep"], inp["dirn"],
        inp["dport"], inp["proto"], HALF)
    err_cache = max(int_err(v0, pv0, u32=True), int_err(v1, pv1, u32=True),
                    int_err(hit, phit), int_err(out_k, prow, u32=True),
                    int_err(st_k, pst, u32=True))
    many = torch.stack([kernels.MEMO_KEYS_LATTICE.keys(
        tables.policy, TupleBatch.from_numpy(**distinct_tuples(w, seed),
                                             device="cuda").pack())
        for seed in (66, 67)])
    err_cache_cases = cache_cases_check(kernels, tables.policy, front.keys,
                                        front.has_l3, many)
    del many
    err_cache = max(err_cache, *err_cache_cases.values())

    # the stamp flush: a new epoch's policy, 0 hits, then hits again
    tables2 = memo_policy_churn(w, tables, pub)
    stamp2 = memo_stamp(tables2.policy)
    flushed = (stamp2[0] == pub["store"].current_stamp() & M32
               and cache.ensure(stamp2) and cache.flushes == 1)
    for tag in ("flush", "flush_warm"):
        row, ep_, er, ok = memo_gate(kernels, tables2, zp, cache, HALF)
        err_plain, err_ref = max(err_plain, ep_), max(err_ref, er)
        consistent &= ok and row["overflow"] == 0
        hits[tag] = row["hits"]
    del tables2

    # overflow: the stats report it, the carried state stays as it was;
    # on the uniform pair, and on a pair whose ingress half is all the hot
    # flow (it fits the capacity) while its egress half overflows it
    hot_in = world.hot_pair(zp, kinds, 1.0, 92, halves=(0,))
    overflow, err_over = [], 0
    for pair in (uni, hot_in):
        pu = torch.from_numpy(pair.view(np.int32)).cuda()
        acc = verdict.make_counter_buffers(tables.policy)
        tel = verdict.make_telemetry_buffers("cuda")
        rows0 = cache.rows.clone()
        k = memo.memo_pair_packed4(tables, pu, cache.rows, acc, tel,
                                   MEMO_OVERFLOW_CAP)
        p = memo.memo_pair_plain(tables, pu, cache.rows, acc.clone(),
                                 tel.clone(), MEMO_OVERFLOW_CAP)
        torch.cuda.synchronize()
        overflow.append(int(k[7][memo.STAT_OVERFLOW].item()))
        err_over = max(err_over, int_err(k[7], p[7], u32=True),
                       buf_err(k[2], torch.zeros_like(acc)),
                       buf_err(k[3], torch.zeros_like(tel)),
                       int_err(k[4], rows0, u32=True),
                       int_err(p[4], rows0, u32=True))

    # memo_evaluate against LATTICE and its plain version
    cols = memo_zipf_tuples(w, MEMO_TUPLES, 61)
    batch = TupleBatch.from_numpy(**cols, device="cuda")
    pol = tables.policy
    rows_e = cache_rows_to(memo.make_cache_rows(MEMO_ROWS), "cuda")
    err_eval = err_eval_ref = 0
    eval_hits = []
    for _ in range(2):
        v, rows2, hit_e, st = memo.memo_evaluate(pol, batch, rows_e,
                                                 rep_cap=MEMO_TUPLES)
        pv, prows, phit_e, pst_e = memo.memo_evaluate_plain(
            pol, batch, rows_e, MEMO_TUPLES)
        lv = kernels.LATTICE(pol, batch)[0]
        torch.cuda.synchronize()
        err_eval = max(err_eval, verdicts_err(v, pv),
                       int_err(rows2, prows, u32=True),
                       int_err(hit_e, phit_e), int_err(st, pst_e, u32=True))
        err_eval_ref = max(err_eval_ref, verdicts_err(v, lv))
        eval_hits.append(int(st[memo.STAT_HIT].item()))
        rows_e = rows2
    k_keys = kernels.MEMO_KEYS_LATTICE.keys(pol, batch.pack())
    err_keys = int_err(widen(k_keys), memo_keys_plain(pol, batch))
    torch.cuda.synchronize()

    ok = (err_plain == 0 and err_ref == 0 and consistent and flushed
          and hits["uniform_cold"] == 0 and hits["uniform_warm"] > 0
          and hits["zipf_warm"] > 0 and hits["zipf_timed_cap"] > 0
          and hits["flush"] == 0
          and hits["flush_warm"] > 0 and hits["hot_warm"] > 0
          and min(overflow) > 0 and err_over == 0
          and err_dedup == 0 and err_cache == 0 and err_eval == 0
          and err_eval_ref == 0 and err_keys == 0 and eval_hits[0] == 0
          and eval_hits[1] > 0)
    phase("memo_check", t, rep_cap=HALF, timed_rep_cap=MEMO_REP_CAP,
          rows=MEMO_ROWS,
          hits=json.dumps(hits), pair_vs_plain_err=err_plain,
          pair_vs_uncached_err=err_ref, hits_consistent=consistent,
          flushed=flushed, dedup_err=err_dedup,
          dedup_cases_err=json.dumps(err_cases), cache_err=err_cache,
          cache_cases_err=json.dumps(err_cache_cases),
          overflow_cap=MEMO_OVERFLOW_CAP, overflow=overflow,
          overflow_err=err_over, evaluate_tuples=MEMO_TUPLES,
          evaluate_vs_plain_err=err_eval,
          evaluate_vs_lattice_err=err_eval_ref, evaluate_hits=eval_hits,
          keys_err=err_keys, gate_cache=json.dumps(gate_rows))
    if not ok:
        raise SystemExit("memo_check failed")
    return dict(err_pair=max(err_plain, err_ref, err_over), err_dedup=err_dedup,
                err_cache=err_cache, err_keys=max(err_keys, err_eval),
                batch=batch, zp=zp, distinct=cases["all_distinct"])


def memo_loop(kernels, tables, pairs, memo_on: bool) -> dict:
    """The headline's double-buffered staging loop (AsyncBatchDispatcher,
    depth 2) over `pairs`, with the memo plane in front of the lattice
    (rep_cap MEMO_REP_CAP, a fresh 16,384-row cache warmed by one pair)
    or uncached (DATAPATH_PAIR); launch counts set to 0 just before the
    timed pairs and read just after."""
    from cilium_tpu_torch.convert import cache_rows_to
    from cilium_tpu_torch.device import u32_tensor
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import memo
    from cilium_tpu_torch.engine import verdict
    from cilium_tpu_torch.engine.publish import AsyncBatchDispatcher

    st = dict(acc=verdict.make_counter_buffers(tables.policy),
              tel=verdict.make_telemetry_buffers("cuda"),
              rows=cache_rows_to(memo.make_cache_rows(MEMO_ROWS), "cuda"))
    stats = []

    def dispatch(pt, acc, tel):
        if not memo_on:
            return dp.datapath_step_accum_pair_telem_packed4_stacked(
                tables, pt, acc, tel)[:2]
        out = memo.memo_pair_packed4(tables, pt, st["rows"], acc, tel,
                                     MEMO_REP_CAP)
        st["rows"] = out[4]
        stats.append(out[7])
        return out[:2]

    # warm-up (first touch of the cache) into scratch carries
    dispatch(u32_tensor(pairs[0], "cuda"), st["acc"].clone(),
             st["tel"].clone())
    torch.cuda.synchronize()
    stats.clear()
    disp = AsyncBatchDispatcher(
        pack_fn=lambda p: (u32_tensor(p, "cuda"),),
        dispatch_fn=lambda pt: dispatch(pt, st["acc"], st["tel"]),
        depth=MEMO_DEPTH)
    reset_counts(kernels)
    t0 = time.perf_counter()
    done = []
    for p in pairs:
        done.extend(disp.submit((p,)))
    done.extend(disp.flush())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels.KERNELS}
    if any(exc is not None for _, _, exc in done) or len(done) != len(pairs):
        raise SystemExit("memo loop: a batch failed")
    folded = ((torch.stack(stats).to(torch.int64) & 0xFFFFFFFF).sum(dim=0)
              .tolist() if stats else None)
    return dict(wall=wall, acc=st["acc"], tel=st["tel"], counts=counts,
                folded=folded,
                overflow_batches=sum(int(s[memo.STAT_OVERFLOW].item()) > 0
                                     for s in stats),
                verdicts_per_s=len(pairs) * 2 * HALF / wall)


def memo_path(kernels, w, tables) -> dict:
    """memo: bench.py's timed memo loop on the card: 8 Zipf(1.1) pairs
    through the memoized pair (rep_cap 524,288, 16,384 cache rows), and
    the uncached headline on the same pairs, in turns (uncached, memo,
    memo, uncached).  The memoized loop's counters and telemetry must
    equal the uncached loop's, and only the memo kernels may launch."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.engine import memo

    t = time.perf_counter()
    pairs = world.zipf_pairs(w, np.random.default_rng(59), HALF, MEMO_PAIRS,
                             MEMO_ZIPF_S)
    runs = [memo_loop(kernels, tables, pairs, on)
            for on in (False, True, True, False)]
    memo_runs = runs[1:3]
    want = {"datapath_pair_memo": 2 * MEMO_PAIRS, "memo_dedup": 2 * MEMO_PAIRS,
            "memo_cache": 2 * MEMO_PAIRS}
    launches_ok = all(
        all(r["counts"][n] == want.get(n, 0) for n in r["counts"])
        for r in memo_runs)
    err = max(max(buf_err(r["acc"], runs[0]["acc"]),
                  buf_err(r["tel"], runs[0]["tel"])) for r in memo_runs)
    f = memo_runs[0]["folded"]
    hit_rate = f[memo.STAT_HIT] / max(f[memo.STAT_TUPLES], 1)
    dedup = f[memo.STAT_TUPLES] / max(f[memo.STAT_UNIQUE], 1)
    phase("memo", t, pairs=MEMO_PAIRS, depth=MEMO_DEPTH,
          rep_cap=MEMO_REP_CAP, rows=MEMO_ROWS, zipf_s=MEMO_ZIPF_S,
          verdicts_per_s=[round(r["verdicts_per_s"]) for r in memo_runs],
          uncached_verdicts_per_s=[round(runs[i]["verdicts_per_s"])
                                   for i in (0, 3)],
          hit_rate=round(hit_rate, 6), dedup_factor=round(dedup, 2),
          unique_keys_per_batch=round(f[memo.STAT_UNIQUE] / MEMO_PAIRS / 2),
          insertions=f[memo.STAT_INSERT],
          overflow_batches=[r["overflow_batches"] for r in memo_runs],
          launches=json.dumps(memo_runs[0]["counts"]),
          counters_vs_uncached_err=err)
    if not launches_ok or err or any(r["overflow_batches"] for r in memo_runs):
        raise SystemExit("memo: wrong launches, an overflow, or counters "
                         "that differ from the uncached loop")
    return dict(launches=memo_runs[0]["counts"], pairs=pairs)


def memo_lattice_path(kernels, tables, batch) -> dict:
    """memo_lattice: memo_evaluate (the daemon's serving shape) through
    a VerdictCache over 4,194,304 Zipf tuples, 8 calls, and LATTICE's
    uncached line on the same tuples; the last call's verdicts against
    LATTICE's (0 differences)."""
    from cilium_tpu_torch.engine import memo

    t = time.perf_counter()
    pol = tables.policy
    cache = memo.VerdictCache(n_rows=MEMO_ROWS, device="cuda")
    cache.ensure(memo_stamp(pol))
    torch.cuda.synchronize()
    reset_counts(kernels)
    t0 = time.perf_counter()
    stats = []
    for _ in range(MEMO_CALLS):
        stamp, rows = cache.acquire()
        v, rows2, _, st = memo.memo_evaluate(pol, batch, rows,
                                             rep_cap=MEMO_TUPLES)
        cache.commit(stamp, rows2)
        stats.append(st)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels.KERNELS}
    for st in stats:
        cache.account(st)
    t1 = time.perf_counter()
    for _ in range(MEMO_CALLS):
        lv = kernels.LATTICE(pol, batch)[0]
    torch.cuda.synchronize()
    wall_u = time.perf_counter() - t1
    err = verdicts_err(v, lv)
    want = {"memo_keys_lattice": 2 * MEMO_CALLS, "memo_dedup": MEMO_CALLS,
            "memo_cache": MEMO_CALLS}
    snap = cache.snapshot()
    phase("memo_lattice", t, calls=MEMO_CALLS, tuples=MEMO_TUPLES,
          verdicts_per_s=round(MEMO_CALLS * MEMO_TUPLES / wall),
          uncached_verdicts_per_s=round(MEMO_CALLS * MEMO_TUPLES / wall_u),
          hit_rate=round(snap["hit_rate"], 6),
          dedup_factor=round(snap["dedup_factor"], 2),
          launches=json.dumps(counts), max_abs_err=err)
    if err or any(counts[n] != want.get(n, 0) for n in counts):
        raise SystemExit("memo_lattice: wrong launches or verdicts")
    return counts


def memo_mode_plain(tables, pair, vals, acc, tel):
    """DATAPATH_PAIR's memo mode (its front and back passes), plain: both
    packed4 halves through the fused pipeline with stage 6's lattice
    outputs read from the memo's value words vals int32 [2, 2, B] (v0,
    v1 per half); the counters and telemetry accumulate into `acc` and
    `tel` in place.  Returns (out_in, out_eg)."""
    from cilium_tpu_torch.device import narrow, widen
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import memo
    from cilium_tpu_torch.engine.verdict import (
        _accumulate_counters,
        _index_identity,
    )

    halves = []
    for h in (0, 1):
        words = memo.unpack_value_words(widen(vals[h, 0]), widen(vals[h, 1]))

        def fn(pol, ep, dirn, dport, proto, identity=None, idx_known=None,
               words=words):
            idx = (idx_known[0] if idx_known is not None
                   else _index_identity(pol, identity)[0])
            return (*words, idx)

        halves.append(dp._datapath_half(
            tables, dp.flow_batch_from_packed4(pair[h]), h == 0,
            lattice_fn=fn))
    (out_i, cols_i, t_i), (out_e, cols_e, t_e) = halves
    _accumulate_counters(
        acc, *(torch.cat([a, b]) for a, b in zip(cols_i, cols_e)))
    tel.copy_(narrow(widen(tel) + torch.stack([t_i, t_e])))
    return out_i, out_e


def memo_timing(kernels, tables, chk, path, lat_counts) -> list:
    """memo_timing: each memo kernel on a Zipf pair (rep_cap 524,288, a
    warm cache): CUDA events over 20 launches, the plain version's
    time, the byte bound (the stream once, each distinct table or cache
    row the plain version gathers once, outputs written once), and
    torch.unique's time for MEMO_DEDUP; the four kernels' rows."""
    from cilium_tpu_torch.device import widen
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import memo
    from cilium_tpu_torch.engine import verdict

    t = time.perf_counter()
    pol = tables.policy
    pt = torch.from_numpy(path["pairs"][0].view(np.int32)).cuda()
    acc = verdict.make_counter_buffers(pol)
    tel = verdict.make_telemetry_buffers("cuda")
    rows = torch.from_numpy(memo.make_cache_rows(MEMO_ROWS).view(np.int32)
                            ).cuda()
    rows = memo.memo_pair_packed4(tables, pt, rows, acc, tel,
                                  MEMO_REP_CAP)[4]  # warm
    front = kernels.DATAPATH_PAIR_MEMO.front(tables, pt)
    keys = front.keys[0]
    g = kernels.MEMO_DEDUP(keys, MEMO_REP_CAP)
    out_rows = torch.empty_like(rows)
    stats = torch.empty(memo.STATS, dtype=torch.int32, device="cuda")
    vals = torch.empty((2, 2, HALF), dtype=torch.int32, device="cuda")
    hits = torch.empty((2, HALF), dtype=torch.bool, device="cuda")

    def cache_call(h, gh):
        return kernels.MEMO_CACHE(
            pol, front.keys[h], gh, rows, out_rows, stats,
            rep_cap=MEMO_REP_CAP, has_l3=front.has_l3, accumulate=h == 1,
            out=(vals[h, 0], vals[h, 1], hits[h]))

    g1 = kernels.MEMO_DEDUP(front.keys[1], MEMO_REP_CAP)
    cache_call(0, g)
    cache_call(1, g1)
    # the front and back passes against their plain version on these
    # value words, from fresh carries
    bufs = [(acc.clone().zero_(), tel.clone().zero_()) for _ in range(2)]
    mode_k = kernels.DATAPATH_PAIR_MEMO.back(tables, pt, front, vals,
                                             *bufs[0], stats)
    mode_p = memo_mode_plain(tables, pt, vals, *bufs[1])
    torch.cuda.synchronize()
    err_mode = max(compare(mode_k, mode_p, dp), buf_err(*(x[0] for x in bufs)),
                   buf_err(*(x[1] for x in bufs)))
    if err_mode:
        raise SystemExit(f"memo_timing: the memo mode differs from its plain "
                         f"version by {err_mode}")
    mode_plain_ms = event_ms(lambda: memo_mode_plain(
        tables, pt, vals, acc.clone(), tel.clone()), 2)
    front_fn = lambda: kernels.DATAPATH_PAIR_MEMO.front(tables, pt)  # noqa
    back_fn = lambda: kernels.DATAPATH_PAIR_MEMO.back(  # noqa: E731
        tables, pt, front, vals, acc, tel, stats)
    front_ms, back_ms = event_ms(front_fn, 20), event_ms(back_fn, 20)
    front_dev = spun_ms(queued_ms, front_fn, "memo_timing front")
    back_dev = spun_ms(queued_ms, back_fn, "memo_timing back")
    # the passes on the parent's csrc/datapath.cu (--ab-parent): the front
    # pass's key words and 8 columns and the back pass's columns agreeing,
    # both timed in turns; and the back pass's counters and telemetry from
    # zeroed carries agreeing
    pass_ab = library_ab(kernels, "datapath", {
        "memo_front": lambda: (lambda f: (f.keys, [f.cols[c] for c in (
            "ct_result", "pre_dropped", "sec_id", "final_daddr",
            "final_dport", "rev_nat", "lb_slave", "ipcache_miss")]))(
                front_fn()),
        "memo_back": back_fn})
    if pass_ab is not None:
        carries = []
        for ctx in (contextlib.nullcontext(),
                    parent_library(kernels, "datapath")):
            a0, t0 = acc.clone().zero_(), tel.clone().zero_()
            with ctx:
                kernels.DATAPATH_PAIR_MEMO.back(tables, pt, front, vals, a0,
                                                t0, stats)
            carries.append((a0, t0))
        torch.cuda.synchronize()
        pass_ab["differing"]["memo_back_carries"] = max(
            buf_err(carries[0][0], carries[1][0]),
            buf_err(carries[0][1], carries[1][1]))
        if pass_ab["differing"]["memo_back_carries"]:
            raise SystemExit("memo_timing: the back pass's counters or "
                             "telemetry differ from the parent's")
        del carries
    dedup_ms = event_ms(lambda: kernels.MEMO_DEDUP(keys, MEMO_REP_CAP), 20)
    # against the parent's (--ab-parent) on these Zipf keys and on
    # MEMO_DISTINCT distinct keys, device ms beside the events
    d_ab = dedup_ab(kernels, {"zipf": keys, "distinct": chk["distinct"]},
                    MEMO_REP_CAP)
    # MEMO_CACHE on both halves against the parent's (--ab-parent):
    # device ms, events and the wrapper's host µs
    c_ab = cache_ab(kernels, pol, front.keys, (g, g1), rows, front.has_l3)
    cache_ms = c_ab["medians"]["new_half0_ms"]
    pair_ms = event_ms(lambda: memo.memo_pair_packed4(
        tables, pt, rows, acc, tel, MEMO_REP_CAP), 20)
    p_ab = memo_pair_ab(kernels, tables, pt, rows, acc, tel)
    uncached_ms = event_ms(lambda: kernels.DATAPATH_PAIR(tables, pt, acc, tel),
                           20)
    unique_ms = event_ms(lambda: torch.unique(keys.t(), dim=0,
                                              return_inverse=True), 20)
    inp = memo_pair_inputs(keys)
    g_p = memo.dedup_groups(*inp["keys"], MEMO_REP_CAP)
    dedup_plain = event_ms(lambda: memo.dedup_groups(*inp["keys"],
                                                     MEMO_REP_CAP), 3)

    def cache_plain():
        return memo.memo_cache_plain(
            pol, rows, inp["keys"], g_p, inp["idx"], inp["known"],
            inp["l3_bit"] if front.has_l3 else None, inp["ep"], inp["dirn"],
            inp["dport"], inp["proto"], MEMO_REP_CAP)

    cache_plain_ms = event_ms(cache_plain, 3)
    pair_plain = event_ms(lambda: memo.memo_pair_plain(
        tables, pt, rows, acc.clone(), tel.clone(), MEMO_REP_CAP), 2)
    batch = chk["batch"]
    packed = batch.pack()
    kv = kernels.MEMO_KEYS_LATTICE.keys(pol, packed)
    keys_ms = event_ms(lambda: kernels.MEMO_KEYS_LATTICE.keys(pol, packed), 20)
    v0 = torch.zeros(MEMO_TUPLES, dtype=torch.int32, device="cuda")
    comb_ms = event_ms(lambda: kernels.MEMO_KEYS_LATTICE.combine(v0, v0,
                                                                 packed), 20)
    keys_plain = event_ms(lambda: memo_keys_plain(pol, batch), 3)

    # -- bounds: what each function's inputs and outputs need moved
    b = HALF
    n_valid = min(int(g["n_unique"].item()), MEMO_REP_CAP)
    dedup_bytes = b * (12 + 8) + (MEMO_REP_CAP + 1) * 4 + MEMO_REP_CAP + 8
    leaves = [("cache.rows", rows)] + [
        (f"policy.{n}", getattr(pol, n)) for n in (
            "l4_hash_rows", "l4_hash_stash", "l4_wild_rows", "l4_wild_stash",
            "l4_meta")]
    rows_b, _, (_, _, _, rows_new, _) = leaf_bytes(leaves, cache_plain)
    changed = int((rows_new != rows).any(dim=1).sum().item())
    cache_bytes = (b * (8 + 9) + n_valid * (4 + 12) + rows_b
                   + changed * rows.shape[1] * 4)
    no_lattice = tuple(x for x in kernels.datapath_reads(tables)
                       if x[0] != "policy")
    tab_b, _ = table_row_bytes(tables, no_lattice, lambda: (
        dp.datapath_pair_plain(tables, pt, acc.clone(), tel.clone())))
    flows = 2 * b
    front_back_bytes = (flows * (16 + out_bytes_per_flow(dp) + 12 + 8) + tab_b
                        + 2 * 4 * int(torch.count_nonzero(acc).item())
                        + 2 * tel.numel() * 4)
    per_flow, egress = flow_ops(tables)
    l4_e = pol.l4_hash_rows.shape[1] // pol.l4_hash_stash.shape[1]
    mode_ops = (per_flow - 2 * (16 * 2 + 4 * l4_e)) * flows + egress * b
    ident = widen(batch.identity)
    keys_bytes = (MEMO_TUPLES * (20 + 12 + 12 + 6)
                  + 4 * int(torch.unique(ident).numel()))
    mb = lambda n: n / HBM_BYTES_PER_S * 1e3
    mo = lambda n: n / OPS_PER_S * 1e3
    per_pair = {n: path["launches"][n] / MEMO_PAIRS
                for n in ("datapath_pair_memo", "memo_dedup", "memo_cache")}
    phase("memo_timing", t, front_ms=round(front_ms, 4),
          back_ms=round(back_ms, 4), front_device_ms=round(front_dev, 4),
          back_device_ms=round(back_dev, 4), dedup_ms=round(dedup_ms, 4),
          cache_ms=round(cache_ms, 4), memo_pair_ms=round(pair_ms, 4),
          uncached_pair_ms=round(uncached_ms, 4),
          unique_ms=round(unique_ms, 4), dedup_plain_ms=round(dedup_plain, 4),
          cache_plain_ms=round(cache_plain_ms, 4),
          memo_pair_plain_ms=round(pair_plain, 4),
          memo_mode_plain_ms=round(mode_plain_ms, 4), memo_mode_err=err_mode,
          keys_ms=round(keys_ms, 4),
          combine_ms=round(comb_ms, 4), keys_plain_ms=round(keys_plain, 4),
          representatives=n_valid, dedup_bytes=dedup_bytes,
          cache_bytes=cache_bytes, memo_mode_bytes=front_back_bytes,
          keys_bytes=keys_bytes, launches_per_pair=json.dumps(per_pair))
    del kv
    rows_out = [
        dict(kernel_row(
            kernels.DATAPATH_PAIR_MEMO, "cilium_tpu_torch/csrc/datapath.cu",
            "cilium_tpu/engine/memo.py:781",
            path["launches"]["datapath_pair_memo"], max(chk["err_pair"],
                                                         err_mode),
            front_ms + back_ms, mode_plain_ms, mb(front_back_bytes),
            mo(mode_ops)),
            front_ms=front_ms, back_ms=back_ms, front_device_ms=front_dev,
            back_device_ms=back_dev, memo_pair_ms=pair_ms,
            memo_pair_ab=p_ab["medians"] if p_ab else None,
            ab=pass_ab["medians"] if pass_ab else None,
            ab_differing=pass_ab["differing"] if pass_ab else None,
            ptxas={"front": MEMO_FRONT_PTXAS, "back": MEMO_BACK_PTXAS},
            memo_pair_plain_ms=pair_plain, uncached_pair_ms=uncached_ms,
            plain_of="the front and back passes, plain, on the same value "
                     "words",
            launches_per_pair=per_pair["datapath_pair_memo"]),
        dict(kernel_row(
            kernels.MEMO_DEDUP, "cilium_tpu_torch/csrc/memo.cu",
            "cilium_tpu/engine/memo.py:205",
            path["launches"]["memo_dedup"] + lat_counts["memo_dedup"],
            chk["err_dedup"], dedup_ms, dedup_plain, mb(dedup_bytes),
            mo(3 * b), library_ms=unique_ms),
            launches_by_path={"memo": path["launches"]["memo_dedup"],
                              "memo_lattice": lat_counts["memo_dedup"]},
            launches_per_pair=per_pair["memo_dedup"],
            ptxas=DEDUP_PTXAS.get(""),
            device_ms=d_ab["medians"]["new_zipf_device_ms"],
            distinct_ms=d_ab["medians"]["new_distinct_ms"],
            distinct_device_ms=d_ab["medians"]["new_distinct_device_ms"],
            ab=d_ab["medians"] if d_ab["differing"] else None,
            ab_device_ms_over_parent=d_ab.get("device_ms_over_parent")),
        dict(kernel_row(
            kernels.MEMO_CACHE, "cilium_tpu_torch/csrc/memo.cu",
            "cilium_tpu/engine/memo.py:326",
            path["launches"]["memo_cache"] + lat_counts["memo_cache"],
            chk["err_cache"], cache_ms, cache_plain_ms, mb(cache_bytes),
            mo(n_valid * (16 * 3 + 4 * 8))),
            launches_by_path={"memo": path["launches"]["memo_cache"],
                              "memo_lattice": lat_counts["memo_cache"]},
            launches_per_pair=per_pair["memo_cache"],
            device_ms=c_ab["medians"]["new_half0_device_ms"],
            egress_ms=c_ab["medians"]["new_half1_ms"],
            egress_device_ms=c_ab["medians"]["new_half1_device_ms"],
            host_us=c_ab["medians"]["new_half0_host_us"],
            egress_host_us=c_ab["medians"]["new_half1_host_us"],
            ptxas=CACHE_PTXAS.get(""),
            ab=c_ab["medians"] if c_ab["differing"] is not None else None,
            ab_differing=c_ab["differing"]),
        dict(kernel_row(
            kernels.MEMO_KEYS_LATTICE, "cilium_tpu_torch/csrc/memo.cu",
            "cilium_tpu/engine/memo.py:673",
            lat_counts["memo_keys_lattice"], chk["err_keys"],
            keys_ms + comb_ms, keys_plain, mb(keys_bytes),
            mo(MEMO_TUPLES * 8)),
            keys_ms=keys_ms, combine_ms=comb_ms),
    ]
    return rows_out


def memo_phases(kernels, w, tables, rows, pub) -> None:
    """The verdict memo's phases (memo_check, memo, memo_lattice,
    memo_timing) on config 5's compact tables; their kernels' rows go
    into `rows`.  `pub` is publish_phases' compiler and store."""
    chk = memo_check(kernels, w, tables, pub)
    path = memo_path(kernels, w, tables)
    lat = memo_lattice_path(kernels, tables, chk["batch"])
    rows.extend(memo_timing(kernels, tables, chk, path, lat))


# -- the persistent pair program (K13) ------------------------------------------

DISPATCH_CHECK_PAIRS = 9  # persistent_check's dispatcher: 2 super-launches + 1
PERSIST_SITE = "smoke.persistent"


def site_calls(site: str) -> tuple:
    from cilium_tpu_torch.metrics import registry as m

    return (m.jit_cache_hits.get(site), m.jit_cache_misses.get(site),
            m.datapath_persistent_launches.get(),
            m.datapath_persistent_pairs.get())


def persistent_check(kernels, w, tables) -> dict:
    """PERSISTENT_PAIR against its plain version on one [4, 2, 4,
    2,097,152] super-batch of config 5's compact world (15 columns,
    counters, telemetry); then DISPATCH_CHECK_PAIRS pairs through a
    PersistentPairDispatcher at site "smoke.persistent", the launch counts
    set to 0 just before and read just after, against as many plain pair
    steps: 2 PERSISTENT_PAIR launches and 1 DATAPATH_PAIR remainder, 2
    calls at the site (a miss and a hit), 1 at its remainder site, and
    the datapath_persistent_* deltas 2 launches and 8 pairs (the
    reference's arithmetic, tests/test_subword.py)."""
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import verdict

    t = time.perf_counter()
    err_super = check_super(tables, w.pairs(seed=43, half=HALF, k=PERSIST_K),
                            kernels, dp, verdict)
    pairs = w.pairs(seed=44, half=HALF, k=DISPATCH_CHECK_PAIRS)
    before = site_calls(PERSIST_SITE)
    rem0 = site_calls(PERSIST_SITE + ".remainder")
    disp = dp.PersistentPairDispatcher(
        tables, PERSIST_K, verdict.make_counter_buffers(tables.policy),
        verdict.make_telemetry_buffers("cuda"), site=PERSIST_SITE)
    torch.cuda.synchronize()
    reset_counts(kernels)
    got = [r for p in pairs for r in disp.submit(p)]
    rem, acc, tel = disp.flush()
    got += rem
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS if k.launches}
    after = site_calls(PERSIST_SITE)
    rem1 = site_calls(PERSIST_SITE + ".remainder")
    deltas = dict(hits=after[0] - before[0], misses=after[1] - before[1],
                  persistent_launches=after[2] - before[2],
                  persistent_pairs=after[3] - before[3],
                  remainder_calls=rem1[0] + rem1[1] - rem0[0] - rem0[1])
    acc_p = verdict.make_counter_buffers(tables.policy)
    tel_p = verdict.make_telemetry_buffers("cuda")
    err_disp = 0
    for p, res in zip(pairs, got):
        pt = torch.from_numpy(p.view(np.int32)).cuda()
        pi, pe, acc_p, tel_p = dp.datapath_pair_plain(tables, pt, acc_p, tel_p)
        err_disp = max(err_disp, compare(res, (pi, pe), dp))
    torch.cuda.synchronize()
    err_disp = max(err_disp, buf_err(acc, acc_p), buf_err(tel, tel_p))
    n_super = DISPATCH_CHECK_PAIRS // PERSIST_K
    n_rem = DISPATCH_CHECK_PAIRS % PERSIST_K
    want = {kernels.PERSISTENT_PAIR.name: n_super,
            kernels.DATAPATH_PAIR.name: n_rem}
    phase("persistent_check", t, super_batch=f"[{PERSIST_K}, 2, 4, {HALF}]",
          super_max_abs_err=err_super, pairs=DISPATCH_CHECK_PAIRS,
          k=PERSIST_K, launches=json.dumps(launches),
          site=PERSIST_SITE, **deltas, dispatcher_max_abs_err=err_disp)
    if (err_super or err_disp or launches != want or len(got) != len(pairs)
            or disp.launches != n_super
            or deltas["hits"] + deltas["misses"] != n_super
            or deltas["persistent_launches"] != n_super
            or deltas["persistent_pairs"] != n_super * PERSIST_K
            or deltas["remainder_calls"] != n_rem):
        raise SystemExit("persistent_check: PERSISTENT_PAIR differs from its "
                         "plain version, or the dispatcher's launches or "
                         "counts are not the reference's")
    return dict(err=max(err_super, err_disp), launches=launches)


PAIR_PTXAS = {}  # layout name: the pair kernel's ptxas record (build)
STEP_PTXAS = {}  # the same of DATAPATH_STEP's kernel
DEDUP_PTXAS = {}  # MEMO_DEDUP's kernel ({"": record})
CACHE_PTXAS = {}  # MEMO_CACHE's kernel ({"": record})
ROUTED_PTXAS = {}  # ROUTED_PROBE's kernel ({"": record})
LATTICE_PTXAS = {}  # LATTICE's instantiations (lattice_ptxas)
MEMO_FRONT_PTXAS = {}  # the memo mode's front pass, by layout
MEMO_BACK_PTXAS = {}  # its back pass ({"": record})
D6_PTXAS = {}  # DATAPATH6's kernel ({"": ...})
COMBINE_PTXAS = {}  # DP_MESH_COMBINE's kernel ({"": ...})
MESH_PTXAS = {}  # MESH_COMBINE's and the memo combine's passes (build)
PAIR_AB_REPS = 20


def pair_ptxas(kernels, log: str, entry: str = "datapath_persistent_"
               "kernel", templ: str = r"ILi(\d)ELi(\d)ELi(\d)E",
               key=None) -> dict:
    """A datapath kernel (PERSISTENT_PAIR's by default) in each layout
    instantiation from `-Xptxas -v` output of csrc/datapath.cu: {layout
    name: {registers, spill_stores, spill_loads, smem}} (smem the static
    bytes); a kernel that is no template: {"": {...}}.  Another kernel's
    instantiations: `templ` matches its mangled template arguments and
    `key` names an instantiation from their digits."""
    import re

    if key is None:
        def key(pf, lb, ipc):
            return kernels.layout_name(int(pf) + 2 * int(lb) + 4 * int(ipc))
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*" + entry +
                      r"(?:" + templ + r")?", line)
        if m:
            cur = "" if m.group(1) is None else key(*m.groups())
            out[cur] = {}
            continue
        if "Compiling entry" in line:
            cur = None
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[cur]["smem"] = int(m.group(1)) if m else 0
    return out


def lattice_ptxas(kernels, log: str) -> dict:
    """LATTICE's instantiations in csrc/lattice.cu's `-Xptxas -v` output:
    {"ew<entry words>[_ip][_stream]": record} (pair_ptxas)."""
    def key(ew, ip, stream):
        return "ew" + ew + "".join(
            f"_{n}" for n, b in (("ip", ip), ("stream", stream)) if b == "1")

    return pair_ptxas(kernels, log, "lattice_kernel",
                      r"ILi(\d)ELb(\d)ELb(\d)E", key)


def pair_outputs(kernels, tables, stacked):
    """PERSISTENT_PAIR over `stacked` and DATAPATH_PAIR over its first
    pair, each from fresh carries: ((columns, acc, telem), ...)."""
    from cilium_tpu_torch.engine import verdict

    out = []
    for launch in (lambda a, t: kernels.PERSISTENT_PAIR(tables, stacked, a,
                                                        t),
                   lambda a, t: kernels.DATAPATH_PAIR(tables, stacked[0], a,
                                                      t)):
        acc = verdict.make_counter_buffers(tables.policy)
        tel = verdict.make_telemetry_buffers("cuda")
        ki, ke, acc, tel = launch(acc, tel)
        out.append(((ki, ke), acc, tel))
    torch.cuda.synchronize()
    return out


def outputs_differ(got, want, dp) -> int:
    """Entries that differ between two pair_outputs records: every
    column of both halves, the counters and the telemetry."""
    (gv, ga, gt), (wv, wa, wt) = got, want
    return (sum(entries_differ(getattr(g, c), getattr(w, c))
                for g, w in zip(gv, wv) for c in dp.VERDICT_COLUMNS)
            + entries_differ(ga, wa) + entries_differ(gt, wt))


def pair_ab(kernels, tables, stacked, acc, tel):
    """The parent commit's csrc/datapath.cu against this one (the A/B,
    --ab-parent): PERSISTENT_PAIR on `stacked` (K = 4) and DATAPATH_PAIR
    on its first pair write fresh outputs once each and every entry must
    agree (SystemExit otherwise); then both are timed in turns parent,
    new, new, parent: CUDA events over PAIR_AB_REPS launches and device
    ms with the launches queued behind a device spin.  None without the
    parent."""
    from cilium_tpu_torch.engine import datapath as dp

    if "datapath" not in AB["libs"]:
        return None
    t = time.perf_counter()
    new = pair_outputs(kernels, tables, stacked)
    with parent_datapath(kernels):
        old = pair_outputs(kernels, tables, stacked)
    differ = {"persistent_pair": outputs_differ(new[0], old[0], dp),
              "datapath_pair": outputs_differ(new[1], old[1], dp)}
    del new, old
    calls = {
        "persistent_pair": lambda: kernels.PERSISTENT_PAIR(tables, stacked,
                                                           acc, tel),
        "datapath_pair": lambda: kernels.DATAPATH_PAIR(tables, stacked[0],
                                                       acc, tel),
    }
    rec = {f"{who}_{k}_{m}": [] for who in ("parent", "new")
           for k in calls for m in ("ms", "device_ms")}
    launches = [k.launches for k in kernels.KERNELS]
    for who in SCATTER_AB_TURNS:
        ctx = (parent_datapath(kernels) if who == "parent"
               else contextlib.nullcontext())
        with ctx:
            for k, fn in calls.items():
                rec[f"{who}_{k}_ms"].append(event_ms(fn, PAIR_AB_REPS))
                rec[f"{who}_{k}_device_ms"].append(
                    spun_ms(queued_ms, fn, "pair_ab"))
    for k, n in zip(kernels.KERNELS, launches):
        k.launches = n
    med = {k: round(float(np.median(v)), 4) for k, v in rec.items()}
    out = dict(differing=differ, medians=med,
               turns={k: [round(x, 4) for x in v] for k, v in rec.items()},
               source=str(kernels.BUILD_DIR / "ab" / "libdatapath_parent.so"),
               seconds=round(time.perf_counter() - t, 3))
    print("  pair_ab " + json.dumps(out), flush=True)
    if any(differ.values()):
        raise SystemExit(f"pair_ab: entries differ between the parent's "
                         f"pair kernel and this one: {differ}")
    return out


PAIR_STASH_SMEM = 64 * 1024  # csrc/datapath.cu STASH_SMEM


def pair_launch(kernels, tables, stacked, acc, tel) -> dict:
    """PERSISTENT_PAIR's launch on `stacked` as csrc/datapath.cu lays it
    out: one thread a flow, a block for each unit of 256 flows of one
    half of one pair (the grid), the four stashes staged in shared
    memory where their words fit PAIR_STASH_SMEM bytes, after the [B, P]
    scan's ranges (the dynamic shared memory a block takes)."""
    a = kernels._pair_args(tables, stacked, acc, tel, 4)
    words = (5 * a.ct_stash_n + a.ipc_stash_w * a.ipc_stash_n
             + a.l4_ew * (a.l4_stash_n + a.l4w_stash_n))
    scan = (6 if a.range_l3_in else 4) * a.n_ranges * 4 if a.range_base else 0
    staged = words * 4 <= PAIR_STASH_SMEM
    return dict(lanes_a_flow=1, block=256,
                grid=2 * int(stacked.shape[0]) * -(-a.B // 256),
                stash_words=words, stashes_in_shared_memory=staged,
                smem_bytes=scan + (words * 4 if staged else 0))


def persistent_timing(kernels, tables, pairs) -> dict:
    """PERSISTENT_PAIR's ms per super-batch over 20 launches on the first
    PERSIST_K pairs pre-staged on the card, beside 4 x DATAPATH_PAIR's on
    the same pairs, the plain version's ms (one call) and the bound: the
    bytes these K pairs need (needed_bytes over the super-batch: the
    stream of every pair, each distinct table row across the K pairs
    once) at 3.35 TB/s, or their operations (flow_ops) at 67 T/s,
    whichever is larger; the kernel's launch here (pair_launch; its
    ptxas registers and spills per layout from the build) and, with
    --ab-parent, pair_ab.  Scratch carries; launches not counted."""
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import verdict

    t = time.perf_counter()
    stacked = torch.from_numpy(np.stack(pairs[:PERSIST_K]).view(
        np.int32)).cuda()
    acc = verdict.make_counter_buffers(tables.policy)
    tel = verdict.make_telemetry_buffers("cuda")
    ms = event_ms(lambda: kernels.PERSISTENT_PAIR(tables, stacked, acc, tel),
                  20)
    device_ms = spun_ms(queued_ms, lambda: kernels.PERSISTENT_PAIR(
        tables, stacked, acc, tel), "persistent_timing")

    def pair_loop():
        for k in range(PERSIST_K):
            kernels.DATAPATH_PAIR(tables, stacked[k], acc, tel)

    pair_ms = event_ms(pair_loop, 20)
    plain_ms = once_ms(lambda: dp.persistent_pair_plain(tables, stacked, acc,
                                                        tel))
    need, per_flow = needed_bytes(tables, stacked, dp, verdict, kernels)
    per_flow_ops, egress_ops = flow_ops(tables)
    ops = (per_flow_ops * 2 + egress_ops) * HALF * PERSIST_K
    bb, bo = need / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    design = pair_launch(kernels, tables, stacked, acc, tel)
    stashes = {name: int(getattr(leaf, "stash").shape[0]) for name, leaf in (
        ("ct", tables.ct), ("ipcache", tables.ipcache))
        if getattr(leaf, "stash", None) is not None}
    if tables.policy.l4_hash_stash is not None:
        stashes.update(l4=int(tables.policy.l4_hash_stash.shape[0]),
                       l4_wild=int(tables.policy.l4_wild_stash.shape[0]))
    ab = pair_ab(kernels, tables, stacked, acc, tel)
    phase("persistent_timing", t, k=PERSIST_K, half=HALF, ms=round(ms, 4),
          device_ms=round(device_ms, 4),
          datapath_pair_x4_ms=round(pair_ms, 4), plain_ms=round(plain_ms, 4),
          bytes=need, ops=ops, bound_bytes_ms=round(bb, 4),
          bound_ops_ms=round(bo, 4), row_bytes_per_flow=round(per_flow, 2),
          verdicts_per_s=round(PERSIST_K * 2 * HALF / (ms / 1e3)),
          design=json.dumps(design), stash_rows=json.dumps(stashes),
          ptxas=json.dumps(PAIR_PTXAS.get(kernels.layout_name(0))))
    return dict(ms=ms, device_ms=device_ms, pair_ms=pair_ms,
                plain_ms=plain_ms, bb=bb, bo=bo, design=design,
                stash_rows=stashes, ab=ab)


def device_busy(prof) -> dict:
    """Device time per kernel or copy from a profiler run, each once (a
    host op such as aten::copy_ also reports its copy's device time)
    and without the profiler's own "Activity Buffer Request" rows."""
    return {
        ev.key: ev.self_device_time_total / 1e3
        for ev in prof.key_averages()
        if ev.device_type == torch.autograd.DeviceType.CUDA
        and ev.self_device_time_total > 0
        and not ev.key.startswith("Activity Buffer")
    }


# -- the lattice on a mesh (K21) and the dense datapath (K8 dense) ---------------

MESH_SHAPE = (2, 4)  # (dp, tp) of the partitioned and failover meshes
SHARDED_SHAPE = (8, 1)  # make_sharded_evaluator's mesh
MESH_DEAD = (0, 1)  # the failover check's dead chip
MESH_VALID_EVERY = 16  # one tuple in 16 is padding in the valid-masked runs
MESH_UPDATE_PORT = 4331  # the stores' one-rule update (team 0 -> app0)
MESH_CALLS = 4  # timed calls per evaluator
MESH_SRC = "cilium_tpu_torch/csrc/mesh.cu"


def mesh_telemetry(v, direction, valid=None) -> torch.Tensor:
    """The [2, TELEM_COLS] telemetry of the lattice's verdicts with the
    datapath's stages absent (the mesh evaluators' epilogue), summed in
    plain torch: the single-device side of the per-chip fold."""
    from cilium_tpu_torch.engine import verdict as vd

    d = direction.to(torch.int64)
    ok = torch.ones_like(d, dtype=torch.bool) if valid is None else valid
    zeros = torch.zeros_like(d)
    masks = vd.telemetry_masks(zeros, zeros, v.match_kind, v.allowed, zeros,
                               v.proxy_port, zeros, zeros)
    row_in = torch.stack([(m & (d == 0) & ok).sum() for m in masks])
    total = torch.stack([(m & ok).sum() for m in masks])
    return torch.stack([row_in, total - row_in])


def rows_differ(got, want, keep=None) -> int:
    """Rows of two verdict sets that differ in any column."""
    bad = None
    for c in ("allowed", "proxy_port", "match_kind"):
        d = getattr(got, c).to(torch.int64) != getattr(want, c).to(
            torch.int64)
        bad = d if bad is None else bad | d
    if keep is not None:
        bad = bad & keep
    return int(bad.sum().item())


def entries_differ(a, b) -> int:
    """Entries of two integer tensors (u32 bits) that differ."""
    if tuple(a.shape) != tuple(b.shape):
        return max(a.numel(), b.numel())
    return int(((a.to(torch.int64) & M32) != (b.to(torch.int64) & M32))
               .sum().item())


def record_rows_differ(a, b) -> int:
    """Tuples whose partial records [5, B] differ in any row."""
    return int((a != b).any(dim=0).sum().item())


def mesh_out_err(got, want, keep=None) -> int:
    """Differences between two evaluator outputs (Verdicts, then integer
    tensors): verdict rows (within `keep`) plus counter entries."""
    err = rows_differ(got[0], want[0], keep)
    for a, b in zip(got[1:], want[1:]):
        err += entries_differ(a, b)
    return err


def dense_check(kernels, tables, dense_pol_host, w) -> dict:
    """DATAPATH_PAIR and DATAPATH_STEP on config 5's headline tables with
    the policy's hashed L4 leaves set to None (K8's dense branch: the
    wide compile's port_slot and l4_allow_bits) against their plain
    versions on a full pair and 2,097,152 pool picks, and against the
    hashed tables' run on the same flows (every column but l4_slot,
    which the dense branch reads for every port with a slot; counters
    and telemetry equal); PERSISTENT_PAIR at K = 1 on the dense pair
    against the plain pair.  Then DATAPATH_PAIR's dense time, plain
    time and bound."""
    from cilium_tpu_torch.convert import flow_pool_to, policy_tables_to
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import verdict

    t = time.perf_counter()
    dense = dataclasses.replace(tables, policy=policy_tables_to(
        dataclasses.replace(dense_pol_host, l4_hash_rows=None,
                            l4_hash_stash=None, l4_wild_rows=None,
                            l4_wild_stash=None), "cuda"))
    pair = torch.from_numpy(w.pairs(seed=61, half=HALF, k=1)[0].view(
        np.int32)).cuda()
    runs = {}
    for name, tab, fn in (("dense", dense, kernels.DATAPATH_PAIR),
                          ("plain", dense, dp.datapath_pair_plain),
                          ("hashed", tables, kernels.DATAPATH_PAIR),
                          ("persistent", dense, kernels.PERSISTENT_PAIR)):
        acc = verdict.make_counter_buffers(tab.policy)
        tel = verdict.make_telemetry_buffers(acc.device)
        if name == "persistent":  # K = 1: pair 0's columns at [0]
            oi, oe, acc, tel = fn(tab, pair[None], acc, tel)
            runs[name] = (dp.DatapathVerdicts(**{
                c: getattr(oi, c)[0] for c in dp.VERDICT_COLUMNS}),
                dp.DatapathVerdicts(**{
                    c: getattr(oe, c)[0] for c in dp.VERDICT_COLUMNS}),
                acc, tel)
        else:
            runs[name] = fn(tab, pair, acc, tel)
    pool = flow_pool_to(w.pool, "cuda")
    picks = torch.from_numpy(np.random.default_rng(62).integers(
        0, pool.shape[1], CHURN_BATCH).astype(np.int32)).cuda()
    steps = {"dense": kernels.DATAPATH_STEP(dense, pool, picks),
             "plain": step_plain(dense, pool, picks),
             "hashed": kernels.DATAPATH_STEP(tables, pool, picks)}
    torch.cuda.synchronize()
    errs = {}
    for other, skip in (("plain", ()), ("hashed", ("l4_slot",)),
                        ("persistent", ())):
        e = 0
        for g, p in zip(runs["dense"][:2], runs[other][:2]):
            for col in dp.VERDICT_COLUMNS:
                if col not in skip:
                    e += int((getattr(g, col) != getattr(p, col)).sum())
        e += entries_differ(runs["dense"][2], runs[other][2])
        e += entries_differ(runs["dense"][3], runs[other][3])
        errs[f"pair_vs_{other}"] = e
        if other in steps:
            errs[f"step_vs_{other}"] = sum(
                int((getattr(steps["dense"], c) != getattr(steps[other], c))
                    .sum()) for c in dp.VERDICT_COLUMNS if c not in skip)
    acc_s = verdict.make_counter_buffers(dense.policy)
    tel_s = verdict.make_telemetry_buffers(acc_s.device)
    ms = event_ms(lambda: kernels.DATAPATH_PAIR(dense, pair, acc_s, tel_s),
                  20)
    plain_ms = event_ms(
        lambda: dp.datapath_pair_plain(dense, pair, acc_s, tel_s), 3)
    hashed_ms = event_ms(
        lambda: kernels.DATAPATH_PAIR(tables, pair, acc_s.new_zeros(
            runs["hashed"][2].shape), tel_s), 20)
    need, _ = needed_bytes(dense, pair, dp, verdict, kernels)
    res = dict(ms=ms, plain_ms=plain_ms, hashed_ms=hashed_ms, bytes=need,
               bound_ms=need / HBM_BYTES_PER_S * 1e3, err=max(errs.values()))
    phase("dense_check", t, half=HALF, picks=CHURN_BATCH, errs=errs,
          dense_ms=round(ms, 4), dense_plain_ms=round(plain_ms, 4),
          hashed_ms=round(hashed_ms, 4), dense_bound_ms=round(
              res["bound_ms"], 4),
          layout=kernels.datapath_layout(dense))
    if any(errs.values()):
        raise SystemExit(f"dense_check: the dense branch differs: {errs}")
    return res


def mesh_setup(w) -> dict:
    """Config 5's map states through a FleetCompiler (two compiles, the
    second a new generation), the partitioned and the replica store on a
    virtual (2, 4) mesh of the card (both epochs full), the tables on
    the card for LATTICE, the word-sharded and the replicated
    placements, the lattice phase's tuples split over both meshes, and
    the evaluators."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.compiler.tables import FleetCompiler
    from cilium_tpu_torch.convert import policy_tables_to
    from cilium_tpu_torch.engine import mesh, sharded
    from cilium_tpu_torch.engine.verdict import (
        TupleBatch,
        make_sharded_evaluator,
    )

    t = time.perf_counter()
    arrays = world.map_state_arrays(w.states)
    fc = FleetCompiler(identity_pad=w.identity_pad, filter_pad=w.filter_pad)
    ids = list(w.identity_ids)
    hosts = [host_copy(fc.compile([(e, s, 0) for e, s in enumerate(arrays)],
                                  ids)[0]) for _ in range(2)]
    compile_s = time.perf_counter() - t
    m24 = mesh.make_mesh(*MESH_SHAPE)
    m81 = mesh.make_mesh(*SHARDED_SHAPE)
    stores = {"partitioned": sharded.make_partitioned_store(m24),
              "replica": sharded.make_replica_store(m24)}
    upload_ms = {}
    for name, store in stores.items():
        upload_ms[name] = [round(once_ms(lambda: store.publish(h)), 3)
                           for h in hosts]
    host = hosts[1]
    single = policy_tables_to(host, "cuda")
    batch = TupleBatch.from_numpy(**world.lattice_tuples(w, LATTICE_TUPLES),
                                  device="cuda")
    valid = torch.arange(LATTICE_TUPLES, device="cuda") % MESH_VALID_EVERY != 0
    u = dict(
        fc=fc, arrays=arrays, ids=ids, host=host, single=single, batch=batch,
        valid=valid, m24=m24, m81=m81, stores=stores,
        mt_mesh=mesh.place_tables(single, mesh.shardings_of(
            m24, sharded.table_specs())),
        mt_shard=mesh.place_tables(single, sharded.replicated_table_shardings(
            m81)),
        sb24=sharded.shard_batch(m24, batch),
        sb24v=sharded.shard_batch(m24, batch, valid=valid),
        sb81=sharded.shard_batch(m81, batch),
        ev_mesh=sharded.make_mesh_evaluator(m24, collect_telemetry=True),
        ev_part=sharded.make_partitioned_evaluator(m24, host,
                                                   collect_telemetry=True),
        ev_fail=sharded.make_failover_evaluator(m24, host,
                                                collect_telemetry=True),
        ev_shard=make_sharded_evaluator(m81),
        alive=np.ones(MESH_SHAPE, bool),
    )
    u["mt_part"] = stores["partitioned"].current()[1]
    u["mt_rep"] = stores["replica"].current()[1]
    torch.cuda.synchronize()
    chip = stores["replica"].chip_bytes()
    phase("mesh_setup", t, tuples=LATTICE_TUPLES, mesh=MESH_SHAPE,
          sharded_mesh=SHARDED_SHAPE, identities=int(host.id_table.shape[0]),
          words=int(host.l3_allow_bits.shape[2]),
          hash_rows=int(host.l4_hash_rows.shape[0]),
          endpoints=int(host.l4_meta.shape[0]),
          compile_s=round(compile_s, 3), full_upload_ms=upload_ms,
          replica_chip_bytes=chip[0],
          geometry_part=dataclasses.asdict(u["ev_part"].geom),
          geometry_fail=dataclasses.asdict(u["ev_fail"].geom),
          cuda_allocated=torch.cuda.memory_allocated())
    return u


def mesh_path(kernels, u) -> dict:
    """The slice's path, launch counts set to 0 just before and read
    just after: the four evaluators once each over the 4,194,304 tuples
    (the word-sharded and partitioned meshes with telemetry, the failover
    mesh healthy with every tuple valid, the sharded evaluator on (8,
    1)).  Each probe kernel launches once per shard, the combine once
    per batch row, LATTICE once per batch shard."""
    dp_, tp = MESH_SHAPE
    torch.cuda.synchronize()
    reset_counts(kernels)
    t = time.perf_counter()
    outs = dict(
        mesh=u["ev_mesh"](u["mt_mesh"], u["sb24"]),
        part=u["ev_part"](u["mt_part"], u["sb24"]),
        fail=u["ev_fail"](u["mt_rep"], u["sb24"], u["alive"], None),
        shard=u["ev_shard"](u["mt_shard"], u["sb81"]),
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {k.name: k.launches for k in kernels.KERNELS if k.launches}
    want = {kernels.MESH_PROBE.name: dp_ * tp,
            kernels.ROUTED_PROBE.name: 2 * dp_ * tp,
            kernels.MESH_COMBINE.name: 3 * dp_,
            kernels.LATTICE.name: SHARDED_SHAPE[0]}
    phase("mesh", t, tuples=LATTICE_TUPLES, evaluators=len(outs),
          wall_ms=round(wall * 1e3, 3), launches=counts,
          replica_hits=int(outs["fail"][3]))
    if counts != want:
        raise SystemExit(f"mesh: launches {counts}, expected {want}")
    return dict(outs=outs, counts=counts)


def mesh_kernel_checks(kernels, u) -> dict:
    """Each mesh kernel against its plain version on the same inputs, on
    every shard (MESH_PROBE on the word-sharded placement, ROUTED_PROBE
    on the partitioned epoch and in failover mode on the replica epoch
    with chip MESH_DEAD dead) and every batch row (MESH_COMBINE in each
    mode, the failover one valid-masked): differing tuples or entries."""
    from cilium_tpu_torch.engine import sharded as sh

    dp_, tp = MESH_SHAPE
    alive = np.ones(MESH_SHAPE, bool)
    alive[MESH_DEAD] = False
    alive_t = torch.from_numpy(alive).cuda()
    g_mesh = sh.mesh_geom(int(u["host"].l3_allow_bits.shape[2]), tp)
    g_part, g_fail = u["ev_part"].geom, u["ev_fail"].geom
    errs = {"mesh_probe": 0, "routed_probe": 0, "routed_probe_failover": 0,
            "mesh_combine": 0}
    for b in range(dp_):
        row_parts = {"mesh": [], "part": [], "fail": []}
        sb = u["sb24v"]
        for t in range(tp):
            dev = u["m24"].devices[b, t]
            bl = sb.on(b, dev)
            tab = u["mt_mesh"].shard(b, t)
            k = kernels.MESH_PROBE(tab, bl, t * g_mesh.w_local)
            errs["mesh_probe"] += record_rows_differ(
                k, sh.mesh_probe_plain(tab, bl, t * g_mesh.w_local))
            row_parts["mesh"].append(k)
            tab = u["mt_part"].shard(b, t)
            k = kernels.ROUTED_PROBE(tab, bl, g_part, t)
            errs["routed_probe"] += record_rows_differ(
                k, sh.routed_probe_plain(tab, bl, g_part, t))
            row_parts["part"].append(k)
            tab = u["mt_rep"].shard(b, t)
            k = kernels.ROUTED_PROBE(tab, bl, g_fail, t, alive_t[b])
            errs["routed_probe_failover"] += record_rows_differ(
                k, sh.routed_probe_plain(tab, bl, g_fail, t, alive_t[b]))
            row_parts["fail"].append(k)
        dev = u["m24"].devices[b, 0]
        bl, vl = sb.on(b, dev), sb.valid_on(b, dev)
        for mode, g, mt, valid in (("mesh", g_mesh, u["mt_mesh"], None),
                                   ("part", g_part, u["mt_part"], None),
                                   ("fail", g_fail, u["mt_rep"], vl)):
            tab = mt.shard(b, 0)
            k = kernels.MESH_COMBINE(row_parts[mode], tab, bl, g, valid)
            p = sh.mesh_combine_plain(row_parts[mode], tab, bl, g, valid)
            errs["mesh_combine"] += mesh_out_err(k, p)
    torch.cuda.synchronize()
    return errs


ROUTED_CASE_TUPLES = 8000
ROUTED_CASE_MESHES = ((2, 4), (4, 2))


def routed_edge_cols(cols) -> dict:
    """`cols` with edge words in its first 16 tuples: identities past
    id_direct's two regions and outside the universe, negative and huge
    endpoints and directions, dports past 65,535."""
    out = {k: np.asarray(v).copy() for k, v in cols.items()}
    edge = dict(
        identity=[0xFFFFFFFF, 0x7FFFFFFF, (1 << 24) + 70000, (1 << 24) - 1,
                  999999, 1 << 31, (1 << 24) + 200, 7],
        ep_index=[-1, -2, 1 << 20, 0xFFFFFFFF, 2, 1, 0, -3],
        direction=[-1, 2, 255, 0xFFFFFFFE, 1, 0, 1, 0],
        dport=[70000, 65536, 1 << 31, 0xFFFFFFFF, 80, 53, 443, 8080])
    for k, v in edge.items():
        col = out[k].astype(np.int64)
        col[:16] = np.asarray(v * 2, np.int64)
        out[k] = (col & 0xFFFFFFFF).astype(np.uint32)
    return out


def stash_hit_cols(pol, cols) -> dict:
    """`cols` with the tuples from the 17th on replaced, one an entry,
    by tuples whose keys are the entries of both L4 stashes (the compact
    layout's key words decoded: identity, dport, proto, endpoint,
    direction), so that both stashes are hit."""
    out = {k: np.asarray(v).copy() for k, v in cols.items()}
    ids = np.asarray(pol.id_table).astype(np.int64) & M32
    at = 16
    for stash in (pol.l4_hash_stash, pol.l4_wild_stash):
        for w0, w1 in (np.asarray(stash).astype(np.int64) & M32)[:, :2]:
            if w0 == 0xFFFFFFFF:  # an empty slot
                continue
            idx = int(w0 & 0x3FFFF)
            out["identity"][at] = ids[min(idx, len(ids) - 1)]
            out["dport"][at] = (w0 >> 18) | ((w1 & 3) << 14)
            out["proto"][at] = (w1 >> 2) & 0xFF
            out["ep_index"][at] = (w1 >> 10) & 0xFF
            out["direction"][at] = (w1 >> 18) & 1
            at += 1
    return out


def routed_cases_check(kernels) -> dict:
    """ROUTED_PROBE against routed_probe_plain on every shard of (2, 4)
    and (4, 2) meshes, partitioned and in failover mode healthy and with
    chip (0, 1) dead, on a small world whose hashed tables are repacked
    at 4 lanes (entries spill into both stashes: the tuples hit them)
    with routed_edge_cols' and stash_hit_cols' tuples; then the failover
    evaluator with holes (one tuple in 5 not valid) and chip (0, 1) dead
    on the card against the same evaluator on the plain versions on the
    CPU.
    {name: differing entries}, and the stash hits."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.compiler import partition
    from cilium_tpu_torch.compiler.tables import repack_l4_subword
    from cilium_tpu_torch.convert import policy_tables_to
    from cilium_tpu_torch.engine import mesh, sharded
    from cilium_tpu_torch.engine.verdict import TupleBatch

    w = world.make_world(seed=6, n_rules=400, n_endpoints=4,
                         n_identities=512, n_cidr_blocks=16, n_vips=4,
                         n_pool=3000, ct_max_entries=4096, identity_pad=256,
                         filter_pad=16)
    pol = repack_l4_subword(w.host_tables().policy, lanes=4)
    cols = routed_edge_cols(world.lattice_tuples(w, ROUTED_CASE_TUPLES,
                                                 seed=3))
    cols["identity"][16::7] = 7  # unknown identities
    cols = stash_hit_cols(pol, cols)
    valid = np.arange(ROUTED_CASE_TUPLES) % 5 != 0
    launches = kernels.ROUTED_PROBE.launches
    errs, stash_hits = {}, 0
    for dp_, tp in ROUTED_CASE_MESHES:
        m = mesh.make_mesh(dp_, tp, device="cuda")
        batch = TupleBatch.from_numpy(**cols, device="cuda")
        sb = sharded.shard_batch(m, batch)
        dead = np.ones((dp_, tp), bool)
        dead[0, 1] = False
        for mode, failover, alive in (("partitioned", False, None),
                                      ("healthy", True, np.ones_like(dead)),
                                      ("dead", True, dead)):
            tab = (partition.replicate_table_leaves(pol, tp) if failover
                   else pol)
            specs, g = sharded._routed_geom(pol, tp, "table",
                                            failover=failover)
            placed = mesh.place_tables(policy_tables_to(tab, "cuda"),
                                       mesh.shardings_of(m, specs))
            differ = 0
            for (b, t), dev in np.ndenumerate(m.devices):
                bl = sb.on(b, dev)
                row = (torch.from_numpy(alive[b]).cuda() if failover
                       else None)
                k = kernels.ROUTED_PROBE(placed.shard(b, t), bl, g, t, row)
                p = sharded.routed_probe_plain(placed.shard(b, t), bl, g, t,
                                               row)
                differ += entries_differ(k, p)
                stash_hits += int(((p[0] & sharded.F_STASH) != 0).sum())
            errs[f"{dp_}x{tp}_{mode}"] = differ
        runs = []
        for dev in ("cuda", "cpu"):
            mm = mesh.make_mesh(dp_, tp, device=dev)
            runs.append(sharded.make_failover_evaluator(mm, pol)(
                policy_tables_to(partition.replicate_table_leaves(pol, tp),
                                 dev),
                TupleBatch.from_numpy(**cols, device=dev), dead, valid))
        torch.cuda.synchronize()
        cpu = lambda x: torch.as_tensor(x).cpu()  # noqa: E731
        errs[f"{dp_}x{tp}_evaluator_holes"] = sum(
            entries_differ(cpu(getattr(runs[0][0], c)),
                           cpu(getattr(runs[1][0], c)))
            for c in ("allowed", "proxy_port", "match_kind")) + sum(
            entries_differ(cpu(a), cpu(b_))
            for a, b_ in zip(runs[0][1:], runs[1][1:]))
    kernels.ROUTED_PROBE.launches = launches
    return dict(errs=errs, stash_hits=stash_hits,
                stash_rows=int(pol.l4_hash_stash.shape[0]),
                wild_stash_rows=int(pol.l4_wild_stash.shape[0]))


def mesh_check(kernels, u, path) -> dict:
    """mesh_check: every count of differing rows or entries must be 0 —
    the kernels against their plain versions (mesh_kernel_checks); the
    four evaluators' verdicts against single-device LATTICE's on the same
    tuples; their l4_counts and reassembled l3_counts against LATTICE's
    counters; their per-chip telemetry folded (fold_telemetry_per_chip)
    against the single-device telemetry; the failover mesh with chip
    MESH_DEAD dead (valid-masked) against the healthy mesh, with
    replica_hits > 0, also after that chip's own primary rows and words
    are overwritten with garbage."""
    from cilium_tpu_torch.engine.verdict import split_counters
    from cilium_tpu_torch.metrics import Registry
    from cilium_tpu_torch.telemetry import fold_telemetry_per_chip

    t = time.perf_counter()
    errs = mesh_kernel_checks(kernels, u)
    cases = routed_cases_check(kernels)
    errs.update({f"routed_{k}": v for k, v in cases["errs"].items()})
    ref_v, ref_acc = kernels.LATTICE(u["single"], u["batch"], counters=True)
    ref_l4, ref_l3 = split_counters(ref_acc, u["single"])
    ref_tel = mesh_telemetry(ref_v, u["batch"].direction)
    outs = path["outs"]
    for name in ("mesh", "part", "fail"):
        o = outs[name]
        errs[f"{name}_verdicts"] = rows_differ(o[0], ref_v)
        errs[f"{name}_l4"] = entries_differ(o[1], ref_l4)
        errs[f"{name}_l3"] = entries_differ(o[2], ref_l3)
        trows = o[4] if name == "fail" else o[3]
        folded = fold_telemetry_per_chip(trows.cpu().numpy().view(np.uint32),
                                         registry=Registry())
        errs[f"{name}_telemetry"] = int((folded.astype(np.int64) != ref_tel
                                         .cpu().numpy()).sum())
    errs["shard_verdicts"] = rows_differ(outs["shard"], ref_v)
    errs["fail_healthy_replica_hits"] = int(outs["fail"][3])

    # chip MESH_DEAD dead, one tuple in MESH_VALID_EVERY padding
    valid = u["valid"]
    dead = np.ones(MESH_SHAPE, bool)
    dead[MESH_DEAD] = False
    healthy = u["ev_fail"](u["mt_rep"], u["sb24v"], u["alive"], None)
    gone = u["ev_fail"](u["mt_rep"], u["sb24v"], dead, None)
    # every output but replica_hits (0 healthy, > 0 with a dead chip)
    drop_hits = lambda o: o[:3] + o[4:]  # noqa: E731
    errs["dead_vs_healthy"] = mesh_out_err(drop_hits(gone),
                                           drop_hits(healthy), keep=valid)
    hits = [int(gone[3])]
    # ... and its own primary rows and words garbage
    g = u["ev_fail"].geom
    own = u["mt_rep"].shard(*MESH_DEAD)
    rows = own.l4_hash_rows.clone()
    rows[:g.n_row_shard] = -1
    words = own.l3_allow_bits.clone()
    words[:, :, :g.wn] = -1
    shards = u["mt_rep"].shards.copy()
    shards[MESH_DEAD] = dataclasses.replace(own, l4_hash_rows=rows,
                                            l3_allow_bits=words)
    garbled = dataclasses.replace(u["mt_rep"], shards=shards)
    gone = u["ev_fail"](garbled, u["sb24v"], dead, None)
    errs["garbage_vs_healthy"] = mesh_out_err(drop_hits(gone),
                                              drop_hits(healthy), keep=valid)
    hits.append(int(gone[3]))
    errs["valid_telemetry"] = int((fold_telemetry_per_chip(
        healthy[4].cpu().numpy().view(np.uint32), registry=Registry()
    ).astype(np.int64) != mesh_telemetry(ref_v, u["batch"].direction, valid)
        .cpu().numpy()).sum())
    del garbled, rows, words, shards
    torch.cuda.synchronize()
    bad = {k: v for k, v in errs.items()
           if v and k != "fail_healthy_replica_hits"}
    phase("mesh_check", t, tuples=LATTICE_TUPLES, errs=errs,
          routed_cases_stash_hits=cases["stash_hits"],
          routed_cases_stash_rows=[cases["stash_rows"],
                                   cases["wild_stash_rows"]],
          dead_chip=MESH_DEAD, dead_replica_hits=hits,
          allowed=int(ref_v.allowed.sum()),
          match_kinds=torch.bincount(ref_v.match_kind.long(),
                                     minlength=5).tolist())
    if (bad or errs["fail_healthy_replica_hits"] or min(hits) <= 0
            or cases["stash_hits"] <= 0):
        raise SystemExit(f"mesh_check: {bad}, replica hits {hits}, stash "
                         f"hits {cases['stash_hits']}")
    return errs


def store_update_check(kernels, u, w) -> dict:
    """The publish phase's one-rule update (team 0 -> app0 on TCP
    MESH_UPDATE_PORT) through the compiler's delta into the partitioned
    and the replica store: each publishes a delta; every shard's updated
    leaves equal the device layout's slice of the new host tables (both
    copies in the replica store); no shard has a changed row that the
    delta's routing does not send it; and the partitioned and failover
    evaluators on the new epochs equal LATTICE on a fresh single-device
    upload, on the tuples and on probes of the new rule."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.compiler import partition
    from cilium_tpu_torch.convert import policy_tables_to
    from cilium_tpu_torch.engine import sharded as sh
    from cilium_tpu_torch.engine.publish import route_update
    from cilium_tpu_torch.engine.verdict import TupleBatch

    t = time.perf_counter()
    fc, stores = u["fc"], u["stores"]
    states = world.one_rule_states(w, MESH_UPDATE_PORT, states=u["arrays"])
    host = host_copy(fc.compile([(e, s, int(e == 0))
                                 for e, s in enumerate(states)],
                                u["ids"])[0])
    base = stores["partitioned"].spare_stamp()
    delta = fc.delta_for(base, host)
    if delta is None or stores["replica"].spare_stamp() != base:
        raise SystemExit("store_update_check: no delta for the update")
    tp = MESH_SHAPE[1]
    errs, stats = {}, {}
    for kind, store in stores.items():
        lay = host if kind == "partitioned" else (
            partition.replicate_table_leaves(host, tp))
        dd = delta if kind == "partitioned" else partition.replica_delta(
            delta, host, tp)
        spare = store.get(base)
        before = {}
        for coord in u["m24"].coords():
            for name in dd.updates:
                leaf = getattr(spare.shard(*coord), name)
                if id(leaf) not in before:
                    before[id(leaf)] = leaf.clone()
        ms = once_ms(lambda: stats.__setitem__(kind, store.publish(host,
                                                                    delta)))
        dev, st = stats[kind]
        stats[kind] = (dev, dict(mode=st.mode, ms=round(ms, 3),
                                 bytes_h2d=st.bytes_h2d,
                                 scatter_leaves=st.scatter_leaves,
                                 replaced_leaves=st.replaced_leaves))
        slice_err = stray = 0
        for coord in u["m24"].coords():
            for name in dd.updates:
                got = getattr(dev.shard(*coord), name)
                sharding = getattr(store._shardings, name)
                want = np.ascontiguousarray(np.asarray(getattr(lay, name))[
                    sharding.slices(dev.leaf_shape(name), coord)])
                want = torch.from_numpy(want.view(np.int32) if want.dtype ==
                                        np.uint32 else want.astype(np.int32))
                slice_err += int((got.cpu() != want).reshape(
                    got.shape[0], -1).any(dim=1).sum())
                old = before[id(getattr(spare.shard(*coord), name))]
                changed = (got != old).reshape(got.shape[0], -1).any(dim=1)
                routed = route_update(dd.updates[name],
                                      dev.leaf_shape(name), sharding, coord)
                owned = torch.zeros_like(changed)
                if routed is not None:
                    owned[torch.from_numpy(routed[0][0]).cuda()] = True
                stray += int((changed & ~owned).sum())
        errs[f"{kind}_slices"] = slice_err
        errs[f"{kind}_stray_rows"] = stray
        errs[f"{kind}_mode"] = int(stats[kind][1]["mode"] != "delta")
    fresh = policy_tables_to(host, "cuda")
    members = [int(m) for m in w.team_members[0]]
    probe = TupleBatch.from_numpy(
        ep_index=np.zeros(2 * len(members), np.int64),
        identity=np.asarray(members * 2, np.uint32),
        dport=np.full(2 * len(members), MESH_UPDATE_PORT),
        proto=np.full(2 * len(members), 6),
        direction=np.zeros(2 * len(members), np.int64), device="cuda")
    m24 = u["m24"]
    ev_p = sh.make_partitioned_evaluator(m24, host)
    ev_f = sh.make_failover_evaluator(m24, host)
    for name, b in (("tuples", u["batch"]), ("probes", probe)):
        ref = kernels.LATTICE(fresh, b)[0]
        errs[f"part_{name}"] = rows_differ(
            ev_p(stats["partitioned"][0], b)[0], ref)
        errs[f"fail_{name}"] = rows_differ(ev_f(
            stats["replica"][0], b, u["alive"], None)[0], ref)
        if name == "probes":
            errs["probes_denied"] = int((ref.allowed == 0).sum())
    torch.cuda.synchronize()
    phase("mesh_store_update", t, port=MESH_UPDATE_PORT, errs=errs,
          stats={k: v[1] for k, v in stats.items()},
          updated=sorted(delta.updates), replaced=sorted(delta.replace))
    if any(errs.values()):
        raise SystemExit(f"mesh_store_update: {errs}")
    return errs


def mesh_need(u, kind: str, b: int, t: int, alive_row=None) -> int:
    """Bytes one probe launch must move for its batch row's data: the
    tuple's five words the probe reads (20 B; the fragment word is the
    combine's) in and its record out (MESH_PROBE 16 B, ROUTED_PROBE 20
    B) per tuple, and each distinct row or element of the shard's
    leaves the plain version gathers, read once; stashes whole.  `kind`
    "routed" is the partitioned epoch, "failover" the replica epoch
    under `alive_row`."""
    from cilium_tpu_torch.engine import sharded as sh

    sb = u["sb24"]
    dev = u["m24"].devices[b, t]
    bl = sb.on(b, dev)
    if kind != "mesh":
        return routed_need(
            u["mt_part" if kind == "routed" else "mt_rep"].shard(b, t), bl,
            u["ev_part" if kind == "routed" else "ev_fail"].geom, t,
            alive_row)
    tab = u["mt_mesh"].shard(b, t)
    g = sh.mesh_geom(int(u["host"].l3_allow_bits.shape[2]), MESH_SHAPE[1])
    names = ("id_direct", "port_slot", "l4_meta", "l4_allow_bits",
             "l3_allow_bits")
    rows_b, _, _ = leaf_bytes([(n, getattr(tab, n)) for n in names],
                              lambda: sh.mesh_probe_plain(tab, bl,
                                                          t * g.w_local))
    return rows_b + int(bl.ep_index.numel()) * (20 + 16)


def routed_need(tab, bl, g, t: int, alive_row=None) -> int:
    """Bytes one ROUTED_PROBE launch must move (mesh_need's rule): the
    tuple's five words in and its 20-byte record out per tuple, and each
    distinct row or element of the shard's leaves the plain version
    gathers, read once; stashes whole."""
    from cilium_tpu_torch.engine import sharded as sh

    names = ("id_direct", "l4_hash_rows", "l4_hash_stash", "l4_wild_rows",
             "l4_wild_stash", "l3_allow_bits")
    rows_b, _, _ = leaf_bytes(
        [(n, getattr(tab, n)) for n in names],
        lambda: sh.routed_probe_plain(tab, bl, g, t, alive_row))
    return rows_b + int(bl.ep_index.numel()) * (20 + 20)


def combine_need(parts, tab, bl, g, valid=None, whole: bool = False) -> int:
    """Bytes one routed-mode combine launch must move for these records:
    per tuple the ep, dir and fragment words (12 B), the flags and the
    owner's value of every record (8 B each), the head record's stash
    and wildcard values (8 B) and 6 B of verdict out (1 B of `valid` in
    with it); the L3 column of each L3 hit on its owner (4 B); each
    l4_meta cell the plain version gathers; each counter entry the row
    changes and the [2, 20] telemetry read and written once, or with
    `whole` the counter buffers the call returns written whole (l4, l3:
    every entry once), the telemetry and the replica count written
    once."""
    from cilium_tpu_torch.compiler.tables import l4_entry_words
    from cilium_tpu_torch.engine import oracle
    from cilium_tpu_torch.engine import sharded as sh

    n = int(bl.ep_index.numel())
    meta_b, _, out = leaf_bytes(
        [("l4_meta", tab.l4_meta)],
        lambda: sh.mesh_combine_plain(parts, tab, bl, g, valid))
    if l4_entry_words(tab) == 3:  # the value words carry the proxy
        meta_b = 0
    v, l4, l3 = out[0], out[1], out[2]
    l3_hit = v.match_kind.to(torch.int64) == oracle.MATCH_L3
    owner_reads = sum(
        int((l3_hit & ((p[0].to(torch.int64) & sh.F_P2) != 0)).sum().item())
        for p in parts[:g.l3_shards])
    changed = int(torch.count_nonzero(l4).item()) + int(
        torch.count_nonzero(l3).item())
    counters = (4 * (l4.numel() + l3.numel()) + 160 + 4 if whole
                else 2 * 4 * changed + 2 * 160)
    return (n * (12 + 8 * len(parts) + 8 + 6 + (valid is not None))
            + 4 * owner_reads + meta_b + counters)


def mesh_combine_times(kernels, fn, parts, tab, bl, g, valid,
                       what: str) -> dict:
    """MESH_COMBINE at one shape: device ms of 20 calls queued behind a
    spin (spun_ms), CUDA events and the wrapper's host us a call; the
    time of one torch.zeros of its counter region (`region_fill_ms`:
    what the launch's own zeroing would cost as a fill) and its share of
    the call; the bound two ways (combine_need: the counter entries the
    row changes, and the counter buffers written whole)."""
    ms = spun_ms(queued_ms, fn, what)
    out = fn()
    words = sum(x.numel() for x in out[1:4] if x is not None) + 1
    fill = spun_ms(queued_ms, lambda: torch.zeros(
        words, dtype=torch.int32, device=out[1].device), what)
    need = combine_need(parts, tab, bl, g, valid)
    whole = combine_need(parts, tab, bl, g, valid, whole=True)
    return dict(tuples=int(bl.ep_index.numel()), records=len(parts), ms=ms,
                events_ms=event_ms(fn, 20), host_us=host_us(fn, 100),
                region_fill_ms=fill, fill_share=fill / ms,
                counter_bytes=4 * words, bytes=need,
                bound_ms=need / HBM_BYTES_PER_S * 1e3, bytes_whole=whole,
                bound_whole_ms=whole / HBM_BYTES_PER_S * 1e3)


def mesh_timing(kernels, u, path, chk, smi) -> list:
    """Each mesh kernel's device ms per call (20 launches on shard (0,
    0)'s or batch row 0's inputs queued behind a device spin,
    `queued_ms`), CUDA events over the same 20 launches as the caller
    sees them (`wrapper_ms`: the wrapper's host time when a launch takes
    less), its plain version's ms and its byte bound at 3.35 TB/s; each
    evaluator's verdicts/s over MESH_CALLS calls beside LATTICE's on the
    same tuples; with the card's name and power limit."""
    from cilium_tpu_torch.engine import sharded as sh

    t = time.perf_counter()
    tp = MESH_SHAPE[1]
    sb = u["sb24"]
    dev = u["m24"].devices[0, 0]
    bl = sb.on(0, dev)
    g_mesh = sh.mesh_geom(int(u["host"].l3_allow_bits.shape[2]), tp)
    g_part = u["ev_part"].geom
    tab_m, tab_p = u["mt_mesh"].shard(0, 0), u["mt_part"].shard(0, 0)
    parts = [kernels.ROUTED_PROBE(u["mt_part"].shard(0, k), bl, g_part, k)
             for k in range(tp)]
    # failover mode with chip MESH_DEAD dead: shard 0 of its batch row,
    # and the shard that serves the dead chip's rows from its backup
    # region
    g_fail = u["ev_fail"].geom
    alive = np.ones(MESH_SHAPE, bool)
    alive[MESH_DEAD] = False
    row_f = torch.from_numpy(alive[MESH_DEAD[0]]).cuda()
    back = (MESH_DEAD[1] + 1) % tp
    tab_f, tab_fb = (u["mt_rep"].shard(MESH_DEAD[0], 0),
                     u["mt_rep"].shard(MESH_DEAD[0], back))
    bl_f = sb.on(MESH_DEAD[0], u["m24"].devices[MESH_DEAD[0], 0])
    routed = {
        "routed_probe": lambda: kernels.ROUTED_PROBE(tab_p, bl, g_part, 0),
        "routed_failover": lambda: kernels.ROUTED_PROBE(tab_f, bl_f, g_fail,
                                                        0, row_f),
        "routed_failover_backup": lambda: kernels.ROUTED_PROBE(
            tab_fb, bl_f, g_fail, back, row_f)}
    res = {}
    for name, fn, plain in (
            ("mesh_probe", lambda: kernels.MESH_PROBE(tab_m, bl, 0),
             lambda: sh.mesh_probe_plain(tab_m, bl, 0)),
            ("routed_probe", routed["routed_probe"],
             lambda: sh.routed_probe_plain(tab_p, bl, g_part, 0)),
            ("routed_failover", routed["routed_failover"],
             lambda: sh.routed_probe_plain(tab_f, bl_f, g_fail, 0, row_f)),
            ("routed_failover_backup", routed["routed_failover_backup"],
             lambda: sh.routed_probe_plain(tab_fb, bl_f, g_fail, back,
                                           row_f)),
            ("mesh_combine",
             lambda: kernels.MESH_COMBINE(parts, tab_p, bl, g_part),
             lambda: sh.mesh_combine_plain(parts, tab_p, bl, g_part))):
        if name == "mesh_combine":
            res[name] = mesh_combine_times(kernels, fn, parts, tab_p, bl,
                                           g_part, None, "mesh_timing")
            res[name].update(wrapper_ms=res[name]["events_ms"],
                             plain_ms=event_ms(plain, 3))
            continue
        ms = queued_ms(fn, 20)
        if ms is None:  # the host fell behind the spin: a longer one
            ms = queued_ms(fn, 20, spin_cycles=500_000_000)
        if ms is None:
            raise SystemExit(f"mesh_timing {name}: the launches did not "
                             "queue behind the device spin")
        wrapper_ms = event_ms(fn, 20)
        plain_ms = event_ms(plain, 3)
        if name.startswith("routed_failover"):
            need = mesh_need(u, "failover", MESH_DEAD[0],
                             back if name.endswith("backup") else 0, row_f)
        else:
            need = mesh_need(u, "mesh" if name == "mesh_probe" else "routed",
                             0, 0)
        res[name] = dict(tuples=int(bl.ep_index.numel()), ms=ms,
                         wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                         bytes=need, bound_ms=need / HBM_BYTES_PER_S * 1e3)
    rates = {}
    evals = (
        ("lattice", lambda: kernels.LATTICE(u["single"], u["batch"])),
        ("mesh", lambda: u["ev_mesh"](u["mt_mesh"], u["sb24"])),
        ("partitioned", lambda: u["ev_part"](u["mt_part"], u["sb24"])),
        ("failover", lambda: u["ev_fail"](u["mt_rep"], u["sb24v"],
                                          u["alive"], None)),
        ("sharded", lambda: u["ev_shard"](u["mt_shard"], u["sb81"])),
    )
    for name, fn in evals:
        fn()
        ms = event_ms(fn, MESH_CALLS)
        rates[name] = dict(ms=round(ms, 4),
                           verdicts_per_s=round(LATTICE_TUPLES / ms * 1e3))
    for name, r in res.items():
        print(f"  mesh_timing {name} " + json.dumps(r), flush=True)
    print("  mesh_timing evaluators " + json.dumps(rates), flush=True)
    # ROUTED_PROBE's 16-byte key-plane loads: the rows' alignment at the
    # lanes the epochs use (a row is aligned when its tensor's base is and
    # its lanes are a multiple of 4)
    aligned = {}
    for name, mt in (("partitioned", u["mt_part"]), ("replica", u["mt_rep"])):
        for leaf in ("l4_hash_rows", "l4_wild_rows"):
            bases = {int(getattr(mt.shard(b_, t_), leaf).data_ptr()) % 16
                     for (b_, t_), _ in np.ndenumerate(u["m24"].devices)}
            lanes = int(getattr(mt.shard(0, 0), leaf).shape[1])
            aligned[f"{name}.{leaf}"] = dict(lanes=lanes,
                                             base_mod16=sorted(bases),
                                             aligned=bases == {0}
                                             and lanes % 4 == 0)
    print("  mesh_timing rows_aligned " + json.dumps(aligned), flush=True)
    # against the parent's csrc/mesh.cu (--ab-parent): ROUTED_PROBE,
    # MESH_PROBE and MESH_COMBINE, then the two evaluators that launch
    # them dp x tp and dp times a call (events)
    ab = library_ab(kernels, "mesh", dict(
        routed, mesh_probe=lambda: kernels.MESH_PROBE(tab_m, bl, 0),
        mesh_combine=lambda: kernels.MESH_COMBINE(parts, tab_p, bl, g_part)))
    ev_ab = library_ab(kernels, "mesh", {
        f"{name}_evaluator": fn for name, fn in evals
        if name in ("partitioned", "failover")}, device=False)
    phase("mesh_timing", t, card=repr(smi), calls=MESH_CALLS)
    rows = []
    for kernel, replaces in (
            (kernels.MESH_PROBE, "cilium_tpu/engine/sharded.py:172"),
            (kernels.ROUTED_PROBE, "cilium_tpu/engine/sharded.py:292"),
            (kernels.MESH_COMBINE, "cilium_tpu/engine/sharded.py:114")):
        r = res[kernel.name]
        err = {"mesh_probe": chk["mesh_probe"],
               "routed_probe": max(chk["routed_probe"],
                                   chk["routed_probe_failover"]),
               "mesh_combine": chk["mesh_combine"]}[kernel.name]
        row = kernel_row(kernel, MESH_SRC, replaces,
                         path["counts"][kernel.name], err, r["ms"],
                         r["plain_ms"], r["bound_ms"], 0.0)
        row["evaluators"] = rates
        if kernel is kernels.ROUTED_PROBE:
            for mode in ("routed_failover", "routed_failover_backup"):
                f = res[mode]
                row[mode[7:]] = dict(ms=f["ms"], events_ms=f["wrapper_ms"],
                                     plain_ms=f["plain_ms"],
                                     bound_ms=f["bound_ms"])
            row.update(events_ms=r["wrapper_ms"], ptxas=ROUTED_PTXAS.get(""),
                       rows_aligned=aligned,
                       evaluator_ab=ev_ab["medians"] if ev_ab else None)
        if kernel is kernels.MESH_COMBINE:
            row.update({k: r[k] for k in (
                "events_ms", "host_us", "region_fill_ms", "fill_share",
                "counter_bytes", "bytes_whole", "bound_whole_ms")},
                ptxas=MESH_PTXAS.get("combine"))
        if ab:
            mine = ("routed_" if kernel is kernels.ROUTED_PROBE
                    else kernel.name)
            row.update(ab={k: v for k, v in ab["medians"].items()
                           if mine in k},
                       ab_differing={k: v for k, v in ab["differing"].items()
                                     if mine in k})
        rows.append(row)
    return rows


def mesh_phases(kernels, w, rows, smi) -> None:
    """The lattice on a mesh (K21): mesh_setup, the path (mesh),
    mesh_check, the stores' one-rule update, mesh_timing; the three
    kernels' rows go into `rows`."""
    u = mesh_setup(w)
    path = mesh_path(kernels, u)
    chk = mesh_check(kernels, u, path)
    store_update_check(kernels, u, w)
    for row in rows:
        if row["name"] == kernels.LATTICE.name:
            row.setdefault("launches_by_path", {"earlier": row["launches"]})
            row["launches_by_path"]["mesh"] = path["counts"][row["name"]]
            row["launches"] += path["counts"][row["name"]]
    rows.extend(mesh_timing(kernels, u, path, chk, smi))
    failover_phases(kernels, w, u, rows, smi)


# -- the mesh's host half: the per-chip failover router (K18 repair, K21 memo)

FAIL_TERMINAL_TUPLES = 4096  # the terminal fold is host Python
FAIL_PORTS = (4351, 4352)  # the deltas published while a chip is out
FAIL_DEAD = MESH_DEAD  # coordinate (0, 1), ordinal 1
FAIL_RESPLIT = (0, 2)  # (0, 1)'s backup: row 0 loses table slice 1
FAIL_MEMO_ROWS, FAIL_MEMO_ENTRIES = 1 << 10, 8  # attach_memo's defaults
FAIL_OVERFLOW_SHIFT = 30  # rep_cap = min(local_b, 256): a Zipf row overflows
FAIL_CALLS = 20


class ManualClock:
    """The breakers' clock, moved by hand: a half-open probe is due when
    the smoke says so, not when a timer fires."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def fail_result_err(res, ref) -> int:
    """Differences between two FailoverResults: verdict rows, counter
    entries and the folded telemetry's."""
    err = 0
    for c in ("allowed", "proxy_port", "match_kind"):
        err += int((np.asarray(getattr(res.verdicts, c)).astype(np.int64)
                    != np.asarray(getattr(ref.verdicts, c)).astype(np.int64))
                   .sum())
    for f in ("l4_counts", "l3_counts"):
        err += int((getattr(res, f) != getattr(ref, f)).sum())
    if res.telemetry is not None or ref.telemetry is not None:
        err += int((res.telemetry.astype(np.uint64).sum(axis=0)
                    != ref.telemetry.astype(np.uint64).sum(axis=0)).sum())
    return err


def fail_ref_err(res, ref) -> int:
    """A FailoverResult against LATTICE's verdicts, counters and
    telemetry on the same tuples (ref: v, l4, l3, telemetry [2, T])."""
    v, l4, l3, tel = ref
    err = 0
    for c in ("allowed", "proxy_port", "match_kind"):
        err += int((np.asarray(getattr(res.verdicts, c)).astype(np.int64)
                    != getattr(v, c).cpu().numpy().astype(np.int64)).sum())
    err += int((res.l4_counts.astype(np.int64)
                != l4.cpu().numpy().view(np.uint32).astype(np.int64)).sum())
    err += int((res.l3_counts.astype(np.int64)
                != l3.cpu().numpy().view(np.uint32).astype(np.int64)).sum())
    if res.telemetry is not None:
        err += int((res.telemetry.astype(np.int64).sum(axis=0)
                    != tel.cpu().numpy()).sum())
    return err


def lattice_ref(kernels, single, batch):
    from cilium_tpu_torch.engine.verdict import split_counters

    v, acc = kernels.LATTICE(single, batch, counters=True)
    l4, l3 = split_counters(acc, single)
    return v, l4, l3, mesh_telemetry(v, batch.direction)


def epoch_vs_fresh(mt, host, m24) -> int:
    """Leaves of a MeshTables epoch that differ, on any coordinate, from
    a fresh full placement of the replica layout of `host`."""
    from cilium_tpu_torch.compiler import partition
    from cilium_tpu_torch.engine import mesh

    aug = partition.replicate_table_leaves(host, MESH_SHAPE[1])
    fresh = mesh.place_tables(aug, partition.table_shardings(m24, aug))
    err = 0
    for coord in m24.coords():
        a, b = mt.shard(*coord), fresh.shard(*coord)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor):
                err += entries_differ(x, y)
            elif x != y and f.name != "generation":
                err += 1
    return err


def failover_setup(kernels, w, u) -> dict:
    """Two routers on the virtual (2, 4) mesh of the card over config 5's
    FleetCompiler tables (u["host"]), each publishing them twice (both
    epochs full): `router` (the smoke's, telemetry on) and `plain` (the
    uncached comparison of the memo phase).  Banks on a manual clock,
    one failure opens a breaker, no host fold (a failed launch then
    raises instead of folding: set only for the terminal phase)."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.engine.failover import ChipFailoverRouter
    from cilium_tpu_torch.resilience import ChipBreakerBank

    t = time.perf_counter()
    clock = ManualClock()
    routers = {}
    for name in ("router", "plain"):
        bank = ChipBreakerBank(recovery_timeout=1.0, failure_threshold=1,
                               clock=clock)
        r = ChipFailoverRouter(u["m24"], u["host"], bank=bank,
                               collect_telemetry=True)
        for _ in range(2):
            r.publish(u["host"])
        routers[name] = r
    cols = world.lattice_tuples(w, LATTICE_TUPLES)
    torch.cuda.synchronize()
    phase("failover_setup", t, tuples=LATTICE_TUPLES, mesh=MESH_SHAPE,
          ordinals=routers["router"].ordinals.tolist(),
          replica_chip_bytes=routers["router"].store.chip_bytes()[0])
    return dict(clock=clock, cols=cols, **routers)


def fail_dispatch(kernels, router, cols, name, t, want=None, **fields):
    """One router dispatch with the launch counts set to 0 just before
    and read just after; `want` the launch counts expected."""
    torch.cuda.synchronize()
    reset_counts(kernels)
    t1 = time.perf_counter()
    res = router.dispatch(**cols)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = {k.name: k.launches for k in kernels.KERNELS if k.launches}
    if want is not None and counts != want:
        raise SystemExit(f"{name}: launches {counts}, expected {want}")
    return res, counts, wall


def failover_paths(kernels, w, u, fu, smi) -> dict:
    """failover_healthy, failover_kill, failover_resplit, failover_readmit
    and failover_terminal through the smoke's router."""
    from cilium_tpu_torch import faultinject, world
    from cilium_tpu_torch.compiler import partition
    from cilium_tpu_torch.compiler.delta import tables_nbytes
    from cilium_tpu_torch.convert import policy_tables_to
    from cilium_tpu_torch.engine.hostpath import lattice_fold_host
    from cilium_tpu_torch.engine.verdict import TupleBatch

    dp_, tp = MESH_SHAPE
    router, cols = fu["router"], fu["cols"]
    dead = int(router.ordinals[FAIL_DEAD])
    routed = {kernels.ROUTED_PROBE.name: dp_ * tp,
              kernels.MESH_COMBINE.name: dp_}
    ref = lattice_ref(kernels, u["single"], u["batch"])
    counts = {}

    # -- 1. healthy: no fault armed
    t = time.perf_counter()
    healthy, counts["healthy"], wall = fail_dispatch(
        kernels, router, cols, "failover_healthy", t, routed)
    err = fail_ref_err(healthy, ref)
    phase("failover_healthy", t, tuples=LATTICE_TUPLES, err=err,
          wall_ms=round(wall * 1e3, 3), launches=counts["healthy"],
          degraded=healthy.degraded, rerouted=healthy.rerouted,
          replica_hits=healthy.replica_hits,
          chip_failures=dict(router.stats.chip_failures))
    if (err or healthy.degraded or healthy.rerouted or healthy.replica_hits
            or router.stats.chip_failures):
        raise SystemExit("failover_healthy: the healthy router differs or "
                         "degraded")

    # -- 2. kill chip (0, 1) through the fault seam until its breaker opens
    t = time.perf_counter()
    faultinject.arm("engine.dispatch", f"raise:chip={dead}")
    killed, counts["kill"], wall = fail_dispatch(
        kernels, router, cols, "failover_kill", t, routed)
    again = router.dispatch(**cols)
    err = fail_result_err(killed, healthy) + fail_result_err(again, healthy)
    phase("failover_kill", t, chip=dead, err=err, wall_ms=round(wall * 1e3, 3),
          replica_hits=[killed.replica_hits, again.replica_hits],
          state=router.bank.state(dead), degraded=killed.degraded,
          rerouted=killed.rerouted, launches=counts["kill"])
    if (err or killed.replica_hits <= 0 or killed.degraded or killed.rerouted
            or router.bank.state(dead) == "closed"):
        raise SystemExit("failover_kill: the replicas did not serve the "
                         "dead chip's rows bit-identically")

    # -- 3. its backup dies too: row 0 re-splits across the survivors
    t = time.perf_counter()
    backup = int(router.ordinals[FAIL_RESPLIT])
    router.bank.record_failure(backup, "smoke kill")
    split, counts["resplit"], wall = fail_dispatch(
        kernels, router, cols, "failover_resplit", t, routed)
    err = fail_result_err(split, healthy)
    phase("failover_resplit", t, chips=[dead, backup], err=err,
          rerouted=split.rerouted, degraded=split.degraded,
          replica_hits=split.replica_hits, wall_ms=round(wall * 1e3, 3),
          rerouted_batches=router.stats.rerouted_batches)
    if err or not split.rerouted or split.degraded:
        raise SystemExit("failover_resplit: the re-split differs")

    # -- 4. two one-rule deltas while the chips are out, then readmission
    t = time.perf_counter()
    fc = u["fc"]
    arrays, states = u["arrays"], list(w.states)
    hosts = []
    torch.cuda.synchronize()
    reset_counts(kernels)
    for k, port in enumerate(FAIL_PORTS):
        arrays = world.one_rule_states(w, port, states=arrays)
        states = world.one_rule_states(w, port, states=states)
        host = host_copy(fc.compile([(e, s, 10 + k if e == 0 else 0)
                                     for e, s in enumerate(arrays)],
                                    u["ids"])[0])
        delta = fc.delta_for(router.store.spare_stamp(), host)
        _, st = router.publish(host, delta)
        if delta is None or st.mode != "delta":
            raise SystemExit(f"failover_readmit: publish of port {port} was "
                             f"{st.mode}")
        hosts.append(host)
    torch.cuda.synchronize()
    counts["outage_publish"] = {k.name: k.launches for k in kernels.KERNELS
                                if k.launches}
    if counts["outage_publish"] != {kernels.PUBLISH_SCATTER.name: 2}:
        raise SystemExit(f"failover_readmit: publish launches "
                         f"{counts['outage_publish']}")
    ledger = router.store.chip_outage(dead)
    faultinject.disarm("engine.dispatch")
    router.bank.breaker(backup).reset()
    fu["clock"].now += 2.0  # the dead chip's breaker is due for its probe
    single = policy_tables_to(hosts[-1], "cuda")
    ref_new = lattice_ref(kernels, single, u["batch"])
    store = router.store
    # the rows the dead chip missed, garbage in its own slice of the live
    # epoch (a private copy: coordinates of one card share a block)
    mt = store.current()[1]
    own = mt.shard(*FAIL_DEAD)
    poison = {}
    for name, (axis, idx) in router._owned_row_sets(dead, ledger).items():
        blk = getattr(store._shardings, name).slices(mt.leaf_shape(name),
                                                     FAIL_DEAD)[axis]
        leaf = getattr(own, name).clone()
        leaf.index_fill_(axis, torch.from_numpy(idx - blk.start).cuda(), -1)
        poison[name] = leaf
    mt.shards[FAIL_DEAD] = dataclasses.replace(own, **poison)
    poisoned = {k: int((v == -1).sum()) for k, v in poison.items()}
    spare_before = store._slots[store._cur ^ 1]["epoch"]
    back, counts["readmit"], wall = fail_dispatch(
        kernels, router, cols, "failover_readmit", t)
    repair_launches = counts["readmit"].get(kernels.REPAIR_SCATTER.name, 0)
    aug = partition.replicate_table_leaves(hosts[-1], tp)
    full_bytes = tables_nbytes(aug)
    live_err = epoch_vs_fresh(store.current()[1], hosts[-1], u["m24"])
    spare = store._slots[store._cur ^ 1]
    spare_err = epoch_vs_fresh(spare["tables"], hosts[0], u["m24"])
    err = fail_ref_err(back, ref_new)
    phase("failover_readmit", t, ports=FAIL_PORTS, chips=[dead, backup],
          missed=len(ledger["missed"]), needs_full=ledger["needs_full"],
          poisoned_words=poisoned,
          rebalanced=list(back.rebalanced_chips),
          rebalance_bytes=back.rebalance_bytes, full_upload_bytes=full_bytes,
          rebalance_ms=round(back.rebalance_ms, 3), live_epoch_err=live_err,
          spare_epoch=[spare_before, spare["epoch"]], spare_epoch_err=spare_err,
          verdict_err=err, state=router.bank.state(dead),
          repair_launches=repair_launches, launches=counts["readmit"],
          publish_launches=counts["outage_publish"])
    if (err or live_err or spare_err or dead not in back.rebalanced_chips
            or not 0 < back.rebalance_bytes < full_bytes
            or router.bank.state(dead) != "closed" or not repair_launches
            or back.degraded or back.replica_hits or not poisoned):
        raise SystemExit("failover_readmit: the readmission did not repair "
                         "the chip's rows")

    # -- 5. every breaker open: the terminal host fold on a small batch
    t = time.perf_counter()
    small = {k: v[:FAIL_TERMINAL_TUPLES] for k, v in cols.items()}
    router.host_fold = lambda *a: lattice_fold_host(states, *a[:5],
                                                    is_fragment=a[5])
    for o in router.ordinals.ravel():
        router.bank.record_failure(int(o), "smoke outage")
    fold, counts["terminal"], wall = fail_dispatch(
        kernels, router, small, "failover_terminal", t, {})
    sb = TupleBatch.from_numpy(**small, device="cuda")
    want = kernels.LATTICE(single, sb)[0]
    err = rows_differ(_host_v(fold), _cpu_v(want))
    router.host_fold = None
    router.bank.reset()
    phase("failover_terminal", t, tuples=FAIL_TERMINAL_TUPLES, err=err,
          degraded=fold.degraded, wall_ms=round(wall * 1e3, 3),
          degraded_batches=router.stats.degraded_batches)
    if err or not fold.degraded:
        raise SystemExit("failover_terminal: the host fold differs")
    return dict(counts=counts, healthy=healthy, hosts=hosts, states=states,
                single=single, ref_new=ref_new, smi=smi)


def _host_v(res):
    from cilium_tpu_torch.engine.verdict import Verdicts

    return Verdicts(*(torch.from_numpy(np.asarray(getattr(res.verdicts, c)))
                      for c in ("allowed", "proxy_port", "match_kind")))


def _cpu_v(v):
    from cilium_tpu_torch.engine.verdict import Verdicts

    return Verdicts(*(getattr(v, c).cpu() for c in ("allowed", "proxy_port",
                                                    "match_kind")))


def memo_counts(kernels, dispatches: int = 1) -> dict:
    dp_, tp = MESH_SHAPE
    per = {kernels.MEMO_KEYS_LATTICE.name: dp_, kernels.MEMO_DEDUP.name: dp_,
           kernels.MESH_MEMO_PROBE.name: dp_,  # one per row on one card
           kernels.MESH_MEMO_COMBINE.name: 2 * dp_,
           kernels.ROUTED_PROBE.name: dp_ * tp,
           kernels.MESH_MEMO_INSERT.name: dp_ * tp}
    return {k: v * dispatches for k, v in per.items()}


def failover_memo(kernels, w, u, fu, fp) -> dict:
    """failover_memo: attach_memo() at the reference's defaults, a
    Zipf(1.1) stream of LATTICE_TUPLES dispatched cold then warm against
    the uncached router on the same epoch, healthy and with chip (0, 1)
    dead (the kill flushes the cache); a batch forced to overflow is
    re-dispatched uncached; then make_partitioned_memo_evaluator once
    against the partitioned evaluator."""
    from cilium_tpu_torch.engine import sharded as sh
    from cilium_tpu_torch.engine.memo_mesh import (
        make_partitioned_memo_evaluator,
    )
    from cilium_tpu_torch.engine.verdict import TupleBatch

    t = time.perf_counter()
    router, plain = fu["router"], fu["plain"]
    for host in fp["hosts"]:
        plain.publish(host)
    zcols = memo_zipf_tuples(w, LATTICE_TUPLES, seed=61)
    router.attach_memo(FAIL_MEMO_ROWS, FAIL_MEMO_ENTRIES)
    cache = router._memo["cache"]
    dead = int(router.ordinals[FAIL_DEAD])
    errs, hit_rates, counts = {}, {}, {}
    results = {}
    for tag in ("healthy", "dead"):
        if tag == "dead":
            flushes = cache.flushes
            for r in (router, plain):
                r.bank.record_failure(dead, "smoke kill")
            errs["kill_flushed"] = int(cache.flushes != flushes + 1)
        ref = plain.dispatch(**zcols)
        for when in ("cold", "warm"):
            res, c, wall = fail_dispatch(kernels, router, zcols,
                                         f"failover_memo {tag} {when}", t,
                                         memo_counts(kernels))
            counts[f"{tag}_{when}"] = c
            errs[f"{tag}_{when}"] = fail_result_err(res, ref)
            hit_rates[f"{tag}_{when}"] = round(float(res.cache_hit.mean()), 4)
            errs[f"{tag}_{when}_degraded"] = int(res.degraded or res.rerouted)
            results[f"{tag}_{when}"] = res
            print(f"  failover_memo {tag} {when} wall_ms "
                  f"{round(wall * 1e3, 3)} replica_hits {res.replica_hits} "
                  f"ref_replica_hits {ref.replica_hits}", flush=True)
        errs[f"{tag}_replica"] = int(
            (ref.replica_hits > 0) != (tag == "dead")
            or (tag == "dead" and results["dead_cold"].replica_hits <= 0))
    for r in (router, plain):
        r.bank.reset()
    # a forced overflow: re-dispatched through the uncached evaluator
    router._memo["rep_shift"] = FAIL_OVERFLOW_SHIFT
    before = router._memo["overflow_redispatches"]
    over = router.dispatch(**zcols)
    router._memo["rep_shift"] = 2
    errs["overflow"] = fail_result_err(over, plain.dispatch(**zcols))
    errs["overflow_redispatched"] = int(
        over.cache_hit is not None
        or router._memo["overflow_redispatches"] != before + 1)
    # make_partitioned_memo_evaluator once, against the partitioned mesh
    batch = TupleBatch.from_numpy(**zcols, device="cuda")
    sbz = sh.shard_batch(u["m24"], batch)
    rep_cap = LATTICE_TUPLES // MESH_SHAPE[0] >> 2
    ev = make_partitioned_memo_evaluator(u["m24"], u["host"], cache.rows,
                                         rep_cap, collect_telemetry=True)
    rows0 = make_cache(u["m24"]).rows
    got = ev(u["mt_part"], sbz, rows0)
    want = u["ev_part"](u["mt_part"], sbz)
    errs["partitioned_memo"] = mesh_out_err(
        (got[0], got[1], got[2], got[6]), want)
    errs["partitioned_memo_overflow"] = int(got[5][3].item())
    torch.cuda.synchronize()
    snap = cache.snapshot()
    phase("failover_memo", t, tuples=LATTICE_TUPLES, zipf_s=MEMO_ZIPF_S,
          rows_local=FAIL_MEMO_ROWS, entries=FAIL_MEMO_ENTRIES, errs=errs,
          hit_rate=hit_rates, dedup_factor=round(snap["dedup_factor"], 3),
          memo_hits=router._memo["hits"], flushes=snap["flushes"],
          overflow_redispatches=router._memo["overflow_redispatches"],
          launches=counts["healthy_warm"])
    if any(errs.values()) or hit_rates["healthy_warm"] <= 0:
        raise SystemExit(f"failover_memo: {errs}")
    return dict(zcols=zcols, counts=counts, errs=errs, batch=batch)


def make_cache(m24):
    from cilium_tpu_torch.engine.memo_mesh import make_partitioned_cache

    return make_partitioned_cache(m24, FAIL_MEMO_ROWS, FAIL_MEMO_ENTRIES)


def memo_stage_need(stage, mg, g, front, rows, b, tp) -> int:
    """Bytes one memo-stage launch must move for these inputs, each read
    once and each output written once (mesh_need's rule): the valid
    representatives' key words and rep_orig, the cache rows they probe
    (distinct rows, whole) and the row's tp records (probe); the tp
    records, the
    missed tuples and the pack (front); the routed records, the reps'
    words, srow and gid, each tuple's ep, dir, fragment and index words
    and its verdict and hit out (back); the slice copied and the entries
    written (insert)."""
    from cilium_tpu_torch.engine.memo_mesh import _scalar

    nv = min(_scalar(g["n_unique"]), mg.rep_cap)
    nm = min(_scalar(front["n_miss"]), mg.miss_cap)
    row_b = mg.width * 4
    if stage == "probe":
        return nv * 16 + rows * row_b + tp * mg.rep_cap * 16
    if stage == "front":
        return tp * 16 * mg.rep_cap + nm * 28 + mg.rep_cap * 16 + \
            mg.miss_cap * (4 + 24)
    if stage == "back":
        return (tp * 20 * mg.miss_cap + mg.rep_cap * 16 + b * (8 + 16)
                + b * 7 + mg.miss_cap * 8 + 2 * 160)
    return 2 * (mg.c_local + 1) * row_b + nm * 5 * 4


def memo_combine_times(kernels, res, g, packed, keys, mg, rg, tab0, valid,
                       alive, b, tp) -> dict:
    """MESH_MEMO_COMBINE at failover_timing's inputs: device ms of
    FAIL_CALLS calls queued behind a spin (spun_ms), the front and the
    back apart and together, on the cold and the warm slice; CUDA events
    and the wrapper's host us a call beside each; the plain versions' ms
    and each pass's bound (memo_stage_need) on both slices.  `ms` is the
    cold slice's front and back together."""
    from cilium_tpu_torch.engine import memo_mesh as mm

    passes = {}
    for tag, r in res.items():
        def front(r=r):
            return kernels.MESH_MEMO_COMBINE.front(r["recs"], g, packed, mg)

        def back(r=r):
            return kernels.MESH_MEMO_COMBINE.back(
                r["front"], r["rparts"], tab0, g, packed, keys, mg, rg,
                valid, alive, True)

        for name, fn in (("front", front), ("back", back),
                         ("both", lambda f=front, k=back: (f(), k()))):
            passes[f"{name}_{tag}"] = dict(
                device_ms=spun_ms(queued_ms, fn, "failover_timing"),
                events_ms=event_ms(fn, FAIL_CALLS),
                host_us=host_us(fn, 50))
        need = {p: memo_stage_need(p, mg, g, r["front"], 0, b, tp)
                for p in ("front", "back")}
        for p in ("front", "back"):
            passes[f"{p}_{tag}"].update(
                bytes=need[p], bound_ms=need[p] / HBM_BYTES_PER_S * 1e3)
        passes[f"front_{tag}"]["plain_ms"] = event_ms(
            lambda r=r: mm.memo_front_plain(r["recs"], g, packed, mg), 3)
        passes[f"back_{tag}"]["plain_ms"] = event_ms(
            lambda r=r: mm.memo_back_plain(r["front"], r["rparts"], tab0, g,
                                           packed, keys, mg, rg, valid,
                                           alive, True), 3)
    return dict(ms=passes["both_cold"]["device_ms"], library_ms=None,
                events_ms=passes["both_cold"]["events_ms"],
                host_us=passes["front_cold"]["host_us"]
                + passes["back_cold"]["host_us"], passes=passes)


def memo_ab_calls(kernels, res, g, packed, keys, mg, rg, mt, valid, alive,
                  tp) -> dict:
    """library_ab's calls for the memo on the mesh at failover_timing's
    inputs, both slices: MESH_MEMO_PROBE, the memo combine's two passes
    (the back on this package's front, whose outputs the parent's front
    gives bit for bit) and MESH_MEMO_INSERT; each a list of its output
    tensors in a fixed order."""
    calls = {}
    for tag, r in res.items():
        rows_t = dict(enumerate(r["rows"]))
        calls[f"{tag}_probe"] = lambda rows_t=rows_t: [
            v for _, v in sorted(kernels.MESH_MEMO_PROBE(
                rows_t, keys, g, mg, alive).items())]
        calls[f"{tag}_front"] = lambda r=r: operator.itemgetter(
            "rep", "miss_pos", "n_miss", "miss_pack")(
            kernels.MESH_MEMO_COMBINE.front(r["recs"], g, packed, mg))
        calls[f"{tag}_back"] = lambda r=r: kernels.MESH_MEMO_COMBINE.back(
            r["front"], r["rparts"], mt.shard(0, 0), g, packed, keys, mg, rg,
            valid, alive, True)
        calls[f"{tag}_insert"] = lambda r=r: kernels.MESH_MEMO_INSERT(
            r["rows"][0], r["front"], r["back"][7], r["back"][6], keys, g, mg,
            0, alive)
    return calls


def failover_timing(kernels, u, fu, fp, fm, smi) -> list:
    """failover_timing: each new kernel against its plain version on the
    same inputs at the phase's shapes (batch row 0 of the Zipf stream on
    the router's live epoch, a cold cache slice and the warm one; the
    rebalance's whole owned region of chip (0, 1)), bit-exact; CUDA
    events over FAIL_CALLS launches; the plain version's ms; the byte
    bound at 3.35 TB/s; index_copy_ beside REPAIR_SCATTER."""
    from cilium_tpu_torch.compiler import partition
    from cilium_tpu_torch.convert import _leaf_to
    from cilium_tpu_torch.engine import memo_mesh as mm
    from cilium_tpu_torch.engine import publish
    from cilium_tpu_torch.engine import sharded as sh
    from cilium_tpu_torch.engine.verdict import _tuple_batch_from_packed

    t = time.perf_counter()
    dp_, tp = MESH_SHAPE
    router = fu["router"]
    mt = router.store.current()[1]
    rg = router._ev.geom
    local_b = LATTICE_TUPLES // dp_
    ev = router._memo_evaluator(max(local_b >> 2, min(local_b, 256)))
    mg = ev.memo_geom
    sb = sh.shard_batch(u["m24"], fm["batch"])
    dev = u["m24"].devices[0, 0]
    packed = sb.on(0, dev).pack()
    valid = torch.ones(local_b, dtype=torch.bool, device=dev)
    alive = torch.ones(tp, dtype=torch.bool, device=dev)
    # the row's key words and groups as the memo path makes them
    # (MEMO_KEYS_LATTICE, MEMO_DEDUP)
    keys = mm._keys(mt.shard(0, 0), packed)
    g = mm._dedup(keys, mg.rep_cap)
    errs, res = {}, {}
    slices = {"cold": [make_cache(u["m24"]).rows.block(0, k).reshape(
                  -1, mg.width) for k in range(tp)],
              "warm": [router._memo["cache"].rows.block(0, k).reshape(
                  -1, mg.width) for k in range(tp)]}
    for tag, rows in slices.items():
        by_t = dict(enumerate(rows))
        got = kernels.MESH_MEMO_PROBE(by_t, keys, g, mg, alive)
        want = mm.memo_probe_plain(by_t, keys, g, mg, alive)
        errs[f"probe_{tag}"] = sum(entries_differ(got[k], want[k])
                                   for k in range(tp))
        recs = [got[k] for k in range(tp)]
        front = kernels.MESH_MEMO_COMBINE.front(recs, g, packed, mg)
        fpl = mm.memo_front_plain(recs, g, packed, mg)
        errs[f"front_{tag}"] = sum(entries_differ(front[k], fpl[k])
                                   for k in front)
        miss = _tuple_batch_from_packed(front["miss_pack"])
        rparts = [kernels.ROUTED_PROBE(mt.shard(0, k), miss, rg, k, alive)
                  for k in range(tp)]
        back = kernels.MESH_MEMO_COMBINE.back(
            front, rparts, mt.shard(0, 0), g, packed, keys, mg, rg, valid,
            alive, True)
        bpl = mm.memo_back_plain(front, rparts, mt.shard(0, 0), g, packed,
                                 keys, mg, rg, valid, alive, True)
        errs[f"back_{tag}"] = rows_differ(back[0], bpl[0]) + sum(
            entries_differ(a, b) for a, b in zip(back[1:], bpl[1:]))
        ins = kernels.MESH_MEMO_INSERT(rows[0], front, back[7], back[6], keys,
                                       g, mg, 0, alive)
        errs[f"insert_{tag}"] = entries_differ(ins, mm.memo_insert_plain(
            rows[0], front, back[7], back[6], keys, g, mg, 0, alive))
        res[tag] = dict(rows=rows, recs=recs, front=front, rparts=rparts,
                        back=back)
    c = res["cold"]
    rows0 = c["rows"]
    # the distinct bucket rows batch row 0's probe reads, over its tp
    # coordinates
    gg = mm._groups64(g)
    _, h = mm._rep_keys(keys, gg)
    bucket = (h & (mg.c_global - 1))[:min(gg["n_unique"], mg.rep_cap)]
    probe_rows = int(torch.unique(bucket).numel())
    rows0_t = dict(enumerate(rows0))
    timed = {
        "mesh_memo_probe": (
            lambda: kernels.MESH_MEMO_PROBE(rows0_t, keys, g, mg, alive),
            lambda: mm.memo_probe_plain(rows0_t, keys, g, mg, alive),
            memo_stage_need("probe", mg, g, c["front"], probe_rows,
                            local_b, tp)),
        "mesh_memo_combine": (
            lambda: (kernels.MESH_MEMO_COMBINE.front(c["recs"], g, packed, mg),
                     kernels.MESH_MEMO_COMBINE.back(
                         c["front"], c["rparts"], mt.shard(0, 0), g, packed,
                         keys, mg, rg, valid, alive, True)),
            lambda: (mm.memo_front_plain(c["recs"], g, packed, mg),
                     mm.memo_back_plain(c["front"], c["rparts"],
                                        mt.shard(0, 0), g, packed, keys, mg,
                                        rg, valid, alive, True)),
            memo_stage_need("front", mg, g, c["front"], 0, local_b, tp)
            + memo_stage_need("back", mg, g, c["front"], 0, local_b, tp)),
        "mesh_memo_insert": (
            lambda: kernels.MESH_MEMO_INSERT(rows0[0], c["front"], c["back"][7],
                                             c["back"][6], keys, g, mg, 0,
                                             alive),
            lambda: mm.memo_insert_plain(rows0[0], c["front"], c["back"][7],
                                         c["back"][6], keys, g, mg, 0, alive),
            memo_stage_need("insert", mg, g, c["front"], 0, local_b, tp)),
    }
    # REPAIR_SCATTER on the rebalance's largest call: chip (0, 1)'s whole
    # owned regions of the live epoch, from the retained host tables
    dead = int(router.ordinals[FAIL_DEAD])
    aug = partition.replicate_table_leaves(fp["hosts"][-1], tp)
    segs_k, segs_p, lib, rep_bytes = [], [], [], 0
    for name, (axis, idx) in router._whole_owned_row_sets(dead).items():
        dst = getattr(mt.shard(*FAIL_DEAD), name)
        blk = getattr(router.store._shardings, name).slices(
            mt.leaf_shape(name), FAIL_DEAD)
        values = np.take(np.asarray(getattr(aug, name)), idx, axis=axis)
        values = np.ascontiguousarray(values[tuple(
            slice(None) if a == axis else s for a, s in enumerate(blk))])
        li = torch.from_numpy(idx - blk[axis].start).cuda()
        vt = _leaf_to(values, "cuda")
        segs_k.append((dst.clone(), axis, li, vt))
        segs_p.append((dst.clone(), axis, li, vt))
        lib.append((dst.clone(), axis, li, vt))
        rep_bytes += li.numel() * 8 + 2 * vt.numel() * 4
    kernels.REPAIR_SCATTER(segs_k)
    publish.repair_segments_plain(segs_p)
    errs["repair"] = sum(entries_differ(a[0], b[0])
                         for a, b in zip(segs_k, segs_p))
    timed["repair_scatter"] = (
        lambda: kernels.REPAIR_SCATTER(segs_k),
        lambda: publish.repair_segments_plain(segs_p), rep_bytes)
    out = {}
    for name, (fn, plain, need) in timed.items():
        if name == "repair_scatter":
            # device time (queued behind a spin) beside the caller's
            # events, for the kernel and index_copy_
            tm = scatter_times(fn, lambda: [
                d.index_copy_(a, i, v) for d, a, i, v in lib])
            out[name] = dict(ms=tm["device_ms"],
                             library_ms=tm["library_device_ms"], **tm,
                             geometry=scatter_geometry(segs_k, "repair"))
        elif name == "mesh_memo_combine":
            out[name] = memo_combine_times(kernels, res, g, packed, keys, mg,
                                           rg, mt.shard(0, 0), valid, alive,
                                           local_b, tp)
        else:
            out[name] = dict(ms=event_ms(fn, FAIL_CALLS), library_ms=None)
        out[name].update(plain_ms=event_ms(plain, 3), bytes=need,
                         bound_ms=need / HBM_BYTES_PER_S * 1e3)
        print(f"  failover_timing {name} " + json.dumps(out[name]),
              flush=True)
    out["repair_scatter"]["ab"] = scatter_ab(kernels, "readmission",
                                             "repair", segs_k)
    # against the parent's csrc/mesh.cu (--ab-parent): the memo's three
    # kernels on both slices, every output entry agreeing
    ab = library_ab(kernels, "mesh", memo_ab_calls(
        kernels, res, g, packed, keys, mg, rg, mt, valid, alive, tp))
    for name in ("mesh_memo_probe", "mesh_memo_combine", "mesh_memo_insert"):
        out[name]["ab"] = None if ab is None else {
            k: v for k, v in ab["medians"].items()
            if k.split("_")[2] in {"mesh_memo_probe": ("probe",),
                                   "mesh_memo_combine": ("front", "back"),
                                   "mesh_memo_insert": ("insert",)}[name]}
    torch.cuda.synchronize()
    phase("failover_timing", t, card=repr(smi), calls=FAIL_CALLS, errs=errs,
          rep_cap=mg.rep_cap, miss_cold=mm._scalar(c["front"]["n_miss"]),
          n_unique=mm._scalar(g["n_unique"]))
    if any(errs.values()):
        raise SystemExit(f"failover_timing: kernels differ from plain {errs}")
    return dict(times=out, errs=errs)


def failover_phases(kernels, w, u, rows, smi) -> None:
    """The mesh's host half (K18 repair, K21 memo): the router's paths,
    the memo on the router, the kernels' timing; the four new kernels'
    rows go into `rows`, and the failover path's launches of the earlier
    kernels into their rows' launches_by_path."""
    fu = failover_setup(kernels, w, u)
    fp = failover_paths(kernels, w, u, fu, smi)
    fm = failover_memo(kernels, w, u, fu, fp)
    ft = failover_timing(kernels, u, fu, fp, fm, smi)
    memo_launches = {}
    for c in fm["counts"].values():
        for k, v in c.items():
            memo_launches[k] = memo_launches.get(k, 0) + v
    path_launches = dict(memo_launches)
    for c in fp["counts"].values():
        for k, v in c.items():
            path_launches[k] = path_launches.get(k, 0) + v
    for row in rows:
        n = path_launches.get(row["name"], 0)
        if n:
            row.setdefault("launches_by_path", {"earlier": row["launches"]})
            row["launches_by_path"]["failover"] = n
            row["launches"] += n
    tt = ft["times"]
    for kernel, replaces, errk in (
            (kernels.REPAIR_SCATTER, "cilium_tpu/engine/publish.py:925",
             ("repair",)),
            (kernels.MESH_MEMO_PROBE, "cilium_tpu/engine/sharded.py:1493",
             ("probe_cold", "probe_warm")),
            (kernels.MESH_MEMO_COMBINE, "cilium_tpu/engine/sharded.py:1374",
             ("front_cold", "front_warm", "back_cold", "back_warm")),
            (kernels.MESH_MEMO_INSERT, "cilium_tpu/engine/sharded.py:1573",
             ("insert_cold", "insert_warm"))):
        r = tt[kernel.name]
        src = ("cilium_tpu_torch/csrc/publish.cu"
               if kernel is kernels.REPAIR_SCATTER else MESH_SRC)
        row = kernel_row(kernel, src, replaces, path_launches.get(
            kernel.name, 0), max(ft["errs"][k] for k in errk), r["ms"],
            r["plain_ms"], r["bound_ms"], 0.0, r["library_ms"])
        if kernel is kernels.REPAIR_SCATTER:
            row.update({k: r[k] for k in (
                "cold_ms", "events_ms", "library_cold_ms",
                "library_events_ms", "geometry", "ab")})
        else:
            row["ab"] = r["ab"]
        if kernel is kernels.MESH_MEMO_COMBINE:
            row.update(events_ms=r["events_ms"], host_us=r["host_us"],
                       passes=r["passes"], ptxas=MESH_PTXAS.get("memo"))
        rows.append(row)
    if any(not path_launches.get(k.name) for k in (
            kernels.REPAIR_SCATTER, kernels.MESH_MEMO_PROBE,
            kernels.MESH_MEMO_COMBINE, kernels.MESH_MEMO_INSERT)):
        raise SystemExit(f"failover: a new kernel never launched on its "
                         f"path: {path_launches}")


# -- the fused datapath on the mesh (K21 datapath mesh) -----------------------

DP_SRC = "cilium_tpu_torch/csrc/datapath_mesh.cu"
DP_FLOWS = 2 * HALF  # the per-flow evaluator's flows, of mixed direction
DP_WB_FLOWS = 1 << 12  # a CT write-back step's flows (the host applies them)
DP_UPSERT_STRIDE = 97  # the ipcache upsert rewrites /32 entry 97 (k + 1)
DP_POISON = -559038737  # 0xDEADBEEF in a dead chip's primary rows
DP_CALLS = 20
DP_EV_CALLS = 3  # timed calls per evaluator
DP_EV_REPEATS = 3  # the evaluators' repeated timings and traced runs


def words_of_pair(pair, seed: int) -> torch.Tensor:
    """A packed4 pair [2, 4, B] on the card as one flow batch of its
    2 B flows (int32 [8, 2 B] words, FLOW_COLUMNS order), shuffled so
    each batch row sees both directions."""
    from cilium_tpu_torch.device import narrow

    h = pair.to(torch.int64) & M32
    w2, w3 = h[:, 2], h[:, 3]
    cols = (w3 >> 16, h[:, 0], h[:, 1], w2 >> 16, w2 & 0xFFFF,
            (w3 >> 8) & 0xFF, (w3 >> 1) & 1, w3 & 1)
    words = torch.stack([c.reshape(-1) for c in cols])
    gen = torch.Generator(device=pair.device).manual_seed(seed)
    perm = torch.randperm(words.shape[1], generator=gen, device=pair.device)
    return narrow(words[:, perm]).contiguous()


def dp_rows_differ(got, want, id_table=None) -> int:
    """Flows whose 15 DatapathVerdicts columns differ in any column;
    with `id_table`, want's sec_id is a raw lattice index (the pair
    step's) and is compared as the identity it indexes."""
    from cilium_tpu_torch.engine import datapath as dp

    bad = None
    for c in dp.VERDICT_COLUMNS:
        a = getattr(got, c).to(torch.int64)
        b = getattr(want, c)
        if c == "sec_id" and id_table is not None:
            b = id_table[b.to(torch.int64)]
        b = b.to(torch.int64)
        if c in dp.U32_COLUMNS:
            a, b = a & M32, b & M32
        d = a != b
        bad = d if bad is None else bad | d
    return int(bad.sum().item())


def dp_oracle(kernels, tables, pair, words) -> dict:
    """The single-device program on the same tables and flows: the pair
    through DATAPATH_PAIR (fresh counters and telemetry), the flows
    through datapath_step_with_counters and datapath_step_telem
    (DATAPATH_STEP)."""
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import verdict

    out = {}
    if pair is not None:
        acc = verdict.make_counter_buffers(tables.policy)
        tel = verdict.make_telemetry_buffers(acc.device)
        oi, oe, acc, tel = kernels.DATAPATH_PAIR(tables, pair, acc, tel)
        l4, l3 = verdict.split_counters(acc, tables.policy)
        out["pair"] = (oi, oe, l4, l3, tel)
    if words is not None:
        fb = dp.flow_batch_from_packed(words)
        o, l4, l3 = dp.datapath_step_with_counters(tables, fb)
        _, tel = dp.datapath_step_telem(tables, fb)
        out["flows"] = (o, l4, l3, tel)
    torch.cuda.synchronize()
    return out


def dp_out_errs(got, want, id_table, pair: bool) -> dict:
    """Differing rows of the columns (each half of a pair), entries of
    the counters and of the telemetry summed over the batch rows."""
    from cilium_tpu_torch.device import narrow, widen

    n_v = 2 if pair else 1
    errs = {}
    for k in range(n_v):
        errs[f"rows{k}"] = dp_rows_differ(got[k], want[k],
                                          id_table if pair else None)
    errs["l4"] = entries_differ(got[n_v], want[n_v])
    errs["l3"] = entries_differ(got[n_v + 1], want[n_v + 1])
    errs["telemetry"] = entries_differ(
        narrow(widen(got[-1]).sum(dim=0)), want[-1])
    return errs


def dp_poisoned(md, coord, axes):
    """A copy of the epoch `md` whose coordinate `coord` holds private
    copies of its sharded blocks with the primary region written over
    (coordinates of one card share a block: the other row keeps its
    own)."""
    from cilium_tpu_torch.engine import datapath_mesh as dm

    shards = md.shards.copy()
    tab = shards[coord]
    ups = {}
    for (fam, name), axis in axes.items():
        leaf = getattr(getattr(tab, fam), name).clone()
        leaf.narrow(axis, 0, leaf.shape[axis] // 2).fill_(DP_POISON)
        ups[(fam, name)] = leaf
    shards[coord] = dm._with_leaves(tab, ups)
    return dataclasses.replace(md, shards=shards)


def dp_mesh_setup(kernels, w, host, tables) -> dict:
    """Config 5's compact DatapathTables (the headline's, nothing cut)
    through _check_fused_world, a DatapathStore on the virtual (2, 4)
    mesh published twice (both epochs full), the byte models, the pair
    of 2 x 2,097,152 flows and its flows as one mixed batch of
    4,194,304, and both evaluators."""
    from cilium_tpu_torch.compiler import partition
    from cilium_tpu_torch.engine import datapath_mesh as dm
    from cilium_tpu_torch.engine import mesh

    t = time.perf_counter()
    tp = MESH_SHAPE[1]
    dm._check_fused_world(host)
    m24 = mesh.make_mesh(*MESH_SHAPE)
    store = dm.DatapathStore(m24)
    upload_ms = [round(once_ms(lambda: store.publish(host)), 3)
                 for _ in range(2)]
    _, per_chip, repl, ovh = partition.datapath_bytes_model(host, tp)
    pair = torch.from_numpy(w.pairs(seed=71, half=HALF, k=1)[0].view(
        np.int32)).cuda()
    words = words_of_pair(pair, 72)
    ev = dm.make_failover_datapath_evaluator(m24, host,
                                             collect_telemetry=True)
    ev_pair = dm.make_failover_datapath_pair_evaluator(m24, host)
    torch.cuda.synchronize()
    chip = store.chip_bytes()
    geom = {k: v for k, v in ev.geom.items() if k != "route"}
    phase("dp_mesh_setup", t, flows=DP_FLOWS, pair_half=HALF,
          mesh=MESH_SHAPE, full_bytes=store.full_bytes(),
          chip_bytes=[chip[k] for k in sorted(chip)],
          model_per_chip=per_chip, model_replicated=repl,
          model_overhead=ovh,
          universe_1=partition.datapath_universe_max_identities(host, 1),
          universe_4=partition.datapath_universe_max_identities(host, tp),
          alltoall_bytes_per_tuple=partition.datapath_alltoall_bytes_per_tuple(
              tp, len(geom["class_plens"])),
          full_upload_ms=upload_ms, geometry=json.dumps(geom),
          replica_leaves=sorted(".".join(k) for k in
                                partition.datapath_all_replica_axes(host, tp)),
          cuda_allocated=torch.cuda.memory_allocated())
    return dict(m24=m24, store=store, pair=pair, words=words, ev=ev,
                ev_pair=ev_pair, host=host, tables=tables,
                axes=partition.datapath_all_replica_axes(host, tp))


def dp_counts(kernels) -> dict:
    return {k.name: k.launches for k in kernels.KERNELS if k.launches}


def dp_run(kernels, u, md, alive, tag: str) -> tuple:
    """Both evaluators once on `md` (launch counts set to 0 just before,
    read just after): the pair, then the mixed batch."""
    torch.cuda.synchronize()
    reset_counts(kernels)
    t = time.perf_counter()
    out_pair = u["ev_pair"](md, u["pair"], alive, None)
    out_flows = u["ev"](md, u["words"], alive, None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = dp_counts(kernels)
    dp_, tp = MESH_SHAPE
    want = {kernels.DP_MESH_PROBE.name: (2 + 4) * dp_ * tp + 4 * dp_ * tp,
            kernels.DP_MESH_COMBINE.name: 2 * dp_ + dp_}
    if counts != want:
        raise SystemExit(f"dp_mesh {tag}: launches {counts}, expected {want}")
    return out_pair, out_flows, counts, wall


def dp_mesh_path(kernels, u, oracle) -> dict:
    """The slice's path: the pair evaluator over the pair and the per-flow
    evaluator over the mixed batch, healthy and with chip (0, 1) dead
    (its primary rows written over in a private copy), every output
    against the single-device program."""
    md = u["store"].current()
    id_table = u["tables"].policy.id_table
    runs, counts = {}, {}
    for tag in ("healthy", "dead"):
        t = time.perf_counter()
        alive = np.ones(MESH_SHAPE, bool)
        epoch = md
        if tag == "dead":
            alive[MESH_DEAD] = False
            epoch = dp_poisoned(md, MESH_DEAD, u["axes"])
        out_pair, out_flows, counts[tag], wall = dp_run(kernels, u, epoch,
                                                        alive, tag)
        errs = {"pair_" + k: v for k, v in dp_out_errs(
            out_pair, oracle["pair"], id_table, True).items()}
        errs.update({"flows_" + k: v for k, v in dp_out_errs(
            out_flows, oracle["flows"], None, False).items()})
        hits = [int(out_pair[4]), int(out_flows[3])]
        phase("dp_mesh", t, case=tag, flows=DP_FLOWS, pair_flows=2 * HALF,
              wall_ms=round(wall * 1e3, 3), launches=counts[tag],
              replica_hits=hits, differing=errs)
        if any(errs.values()) or (tag == "dead") != all(hits):
            raise SystemExit(f"dp_mesh {tag}: the mesh differs from the "
                             f"single-device program: {errs}, hits {hits}")
        runs[tag] = (out_pair, out_flows)
    return dict(counts=counts, runs=runs)


def dp_mesh_node(kernels, u, node) -> dict:
    """The node world (its ipcache without range rows: the [B, P] scan;
    the classic LB; the DIR-24-8 prefilter) at one pair through the pair
    evaluator, healthy and with chip (0, 1) dead, against DATAPATH_PAIR
    on its tables."""
    from cilium_tpu_torch.compiler import partition
    from cilium_tpu_torch.convert import tables_to
    from cilium_tpu_torch.engine import datapath_mesh as dm

    t = time.perf_counter()
    nw, nhost = node
    tp = MESH_SHAPE[1]
    if nhost.ipcache.range_rows is not None:
        raise SystemExit("dp_mesh_node: the node world took range classes")
    ntab = tables_to(nhost, "cuda")
    ev = dm.make_failover_datapath_pair_evaluator(u["m24"], nhost)
    md = dm.place_datapath(partition.replicate_datapath_leaves(nhost, tp),
                           ev.shardings)
    pair = torch.from_numpy(nw.pairs(seed=73, half=HALF, k=1)[0].view(
        np.int32)).cuda()
    want = dp_oracle(kernels, ntab, pair, None)["pair"]
    axes = partition.datapath_all_replica_axes(nhost, tp)
    errs, counts, hits = {}, {}, {}
    for tag in ("healthy", "dead"):
        alive = np.ones(MESH_SHAPE, bool)
        epoch = md
        if tag == "dead":
            alive[MESH_DEAD] = False
            epoch = dp_poisoned(md, MESH_DEAD, axes)
        torch.cuda.synchronize()
        reset_counts(kernels)
        got = ev(epoch, pair, alive, None)
        torch.cuda.synchronize()
        counts[tag] = dp_counts(kernels)
        errs[tag] = dp_out_errs(got, want, ntab.policy.id_table, True)
        hits[tag] = int(got[4])
    phase("dp_mesh_node", t, pair_flows=2 * HALF,
          layout=kernels.datapath_layout(ntab), replica_hits=hits,
          launches=counts, differing=errs,
          sharded=sorted(".".join(k) for k in axes))
    if any(v for e in errs.values() for v in e.values()) or not hits["dead"]:
        raise SystemExit(f"dp_mesh_node: the mesh differs on the node "
                         f"world: {errs}")
    return dict(counts=counts)


def dp_churn(kernels, w, host, tables, words, step: int):
    """One CT write-back step (the single-device verdicts of the step's
    DP_WB_FLOWS flows applied to the world's CT map) and one ipcache
    upsert, the two planes recompiled in the headline's layouts: the
    new host tables.  The upsert gives an existing /32 another identity
    (config 5's bucket plane is full: one more /32 regrows it, a
    geometry change that uploads in full)."""
    from cilium_tpu_torch.ct.device import compact_ct_snapshot, compile_ct
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.ipcache.lpm import (
        build_ipcache,
        specialize_ipcache_to_idx,
        subword_ipcache,
    )

    fb = dp.flow_batch_from_packed(
        words[:, step * DP_WB_FLOWS:(step + 1) * DP_WB_FLOWS].contiguous())
    out = kernels.DATAPATH_STEP(tables, fb.packed)
    created, deleted = dp.apply_ct_writeback(w.ct, out, fb, now=step + 1)
    keys = [k for k in w.ipc_map if k.endswith("/32")]
    key = keys[DP_UPSERT_STRIDE * (step + 1) % len(keys)]
    w.ipc_map[key] = next(int(i) for i in w.identity_ids[step + 1:]
                          if int(i) != w.ipc_map[key])
    new = dataclasses.replace(
        host, ct=compact_ct_snapshot(compile_ct(w.ct)),
        ipcache=subword_ipcache(specialize_ipcache_to_idx(
            build_ipcache(w.ipc_map), host.policy)))
    return new, created, deleted


def dp_resident_err(store, host) -> int:
    """Entries of the current epoch's blocks that differ from the
    augmented host tables, over every sharded leaf and coordinate."""
    from cilium_tpu_torch.compiler import partition
    from cilium_tpu_torch.convert import _leaf_to

    md = store.current()
    aug = partition.replicate_datapath_leaves(host, MESH_SHAPE[1])
    err = 0
    for (fam, name), _ in partition.datapath_all_replica_axes(
            host, MESH_SHAPE[1]).items():
        full = _leaf_to(np.asarray(getattr(getattr(aug, fam), name)), "cuda")
        sh = getattr(getattr(md.shardings, fam), name)
        for coord in md.mesh.coords():
            block = getattr(getattr(md.shard(*coord), fam), name)
            err += entries_differ(block, full[sh.slices(tuple(full.shape),
                                                         coord)])
    return err


def dp_mesh_store(kernels, w, u) -> dict:
    """Two churn steps (a CT write-back and an ipcache upsert each), each
    published as a row-diff delta below a tenth of a full upload; the
    resident blocks against the host augmentation; then repair_chip(1)
    (REPAIR_SCATTER), its bytes and ms."""
    from cilium_tpu_torch.convert import tables_to

    t = time.perf_counter()
    store, host, tables = u["store"], u["host"], u["tables"]
    full = store.full_bytes()
    steps, counts = [], {}
    for step in range(2):
        host, created, deleted = dp_churn(kernels, w, host, tables,
                                          u["words"], step)
        torch.cuda.synchronize()
        reset_counts(kernels)
        t1 = time.perf_counter()
        _, st = store.publish(host)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        counts[f"publish{step}"] = dp_counts(kernels)
        steps.append(dict(mode=st.mode, bytes_h2d=st.bytes_h2d,
                          rows=st.scattered_rows,
                          replaced=st.replaced_leaves, ms=round(ms, 3),
                          created=created, deleted=deleted))
        if st.mode != "delta" or not st.bytes_h2d < full / 10:
            raise SystemExit(f"dp_mesh_store: step {step} published "
                             f"{st.mode}, {st.bytes_h2d} B of {full}")
        tables = tables_to(host, "cuda")
    resident = dp_resident_err(store, host)
    torch.cuda.synchronize()
    reset_counts(kernels)
    t1 = time.perf_counter()
    rep_bytes = store.repair_chip(1)
    torch.cuda.synchronize()
    rep_ms = (time.perf_counter() - t1) * 1e3
    counts["repair"] = dp_counts(kernels)
    resident_after = dp_resident_err(store, host)
    # the last publish diffed against the spare: the world two steps back
    scatter = dp_delta_scatter(kernels, store, u["host"], host)
    phase("dp_mesh_store", t, full_bytes=full, steps=json.dumps(steps),
          resident_err=[resident, resident_after], repair_bytes=rep_bytes,
          repair_ms=round(rep_ms, 3), launches=counts,
          delta_scatter=json.dumps(scatter))
    if (resident or resident_after or not 0 < rep_bytes < full
            or not counts["repair"].get(kernels.REPAIR_SCATTER.name)
            or scatter["err"]):
        raise SystemExit("dp_mesh_store: the resident epoch, the repair or "
                         "the delta's scatter differs")
    return dict(host=host, tables=tables, counts=counts, scatter=scatter)


def dp_delta_scatter(kernels, store, prev, host) -> dict:
    """REPAIR_SCATTER at the last churn delta's sizes (the reference's
    DatapathStore._scatter_fn): the row diff of the two augmented host
    tables routed to the current epoch's blocks, written into copies of
    them by the kernel and by its plain version (compared), timed beside
    index_copy_ on the same segments; the bound their index bytes and
    their rows read and written once."""
    from cilium_tpu_torch.compiler import partition
    from cilium_tpu_torch.engine import datapath_mesh as dm
    from cilium_tpu_torch.engine import publish

    tp = MESH_SHAPE[1]
    aug = partition.replicate_datapath_leaves(host, tp)
    payloads, _, n_rows, nbytes = dm.row_diff(
        aug, partition.replicate_datapath_leaves(prev, tp),
        partition.datapath_all_replica_axes(host, tp))
    segs = [s for v in dm.segments(store.current(), payloads).values()
            for s in v]
    segs_k = [(d.clone(), a, i, v) for d, a, i, v in segs]
    segs_p = [(d.clone(), a, i, v) for d, a, i, v in segs]
    lib = [(d.clone(), a, i, v) for d, a, i, v in segs]
    kernels.REPAIR_SCATTER(segs_k)
    publish.repair_segments_plain(segs_p)
    err = sum(entries_differ(a[0], b[0]) for a, b in zip(segs_k, segs_p))
    need = sum(i.numel() * 8 + 2 * v.numel() * 4 for _, _, i, v in segs)
    tm = scatter_times(lambda: kernels.REPAIR_SCATTER(segs_k),
                       lambda: [d.index_copy_(a, i, v)
                                for d, a, i, v in lib])
    return dict(
        segments=len(segs), rows=n_rows, bytes_h2d=nbytes, err=err,
        ms=tm["device_ms"], library_ms=tm["library_device_ms"], **tm,
        plain_ms=event_ms(lambda: publish.repair_segments_plain(segs_p), 3),
        bytes=need, bound_ms=need / HBM_BYTES_PER_S * 1e3,
        geometry=scatter_geometry(segs, "repair"),
        ab=scatter_ab(kernels, "datapath_delta", "repair", segs))


def dp_host_cols(words) -> dict:
    """The flow batch's columns on the host, as dispatch_flows takes
    them."""
    from cilium_tpu_torch.engine import datapath as dp

    a = words.cpu().numpy()
    cols = {c: a[k] for k, c in enumerate(dp.FLOW_COLUMNS)}
    cols["saddr"] = cols["saddr"].view(np.uint32)
    cols["daddr"] = cols["daddr"].view(np.uint32)
    cols["is_fragment"] = cols["is_fragment"] != 0
    return cols


def dp_result_err(res, want) -> dict:
    """A FailoverResult of dispatch_flows against the single-device
    program's outputs (columns, counters, telemetry)."""
    from cilium_tpu_torch.engine import datapath as dp

    got = dp.DatapathVerdicts(**{
        c: torch.from_numpy(np.ascontiguousarray(getattr(res.verdicts, c)
                                                 ).astype(np.int64))
        for c in dp.VERDICT_COLUMNS})
    o, l4, l3, tel = want
    return {
        "rows": dp_rows_differ(got, dp.DatapathVerdicts(**{
            c: getattr(o, c).cpu() for c in dp.VERDICT_COLUMNS})),
        "l4": int((res.l4_counts != _u32np(l4)).sum()),
        "l3": int((res.l3_counts != _u32np(l3)).sum()),
        "telemetry": int((res.telemetry.astype(np.uint64).sum(axis=0)
                          != _u32np(tel)).sum()),
    }


def _u32np(t):
    return t.cpu().numpy().view(np.uint32)


def dp_failover(kernels, u, host, tables) -> dict:
    """ChipFailoverRouter.attach_datapath on the churned world, then
    dispatch_flows of the 4,194,304 flows healthy, with chip (0, 1)
    killed through the fault seam (replica gathers, no host fold: none
    is configured), with its backup (0, 2) dead too (the row re-split),
    the backup closed again (its datapath slices repaired), and at the
    dead chip's readmission (its private blocks written over first; the
    datapath repair drains _dp_out), each against the single-device
    program."""
    from cilium_tpu_torch import faultinject
    from cilium_tpu_torch.engine.failover import ChipFailoverRouter
    from cilium_tpu_torch.resilience import ChipBreakerBank

    t = time.perf_counter()
    clock = ManualClock()
    bank = ChipBreakerBank(recovery_timeout=1.0, failure_threshold=1,
                           clock=clock)
    router = ChipFailoverRouter(u["m24"], host.policy, bank=bank,
                                collect_telemetry=True)
    router.attach_datapath(host)
    cols = dp_host_cols(u["words"])
    want = dp_oracle(kernels, tables, None, u["words"])["flows"]
    full = router.dp_store.full_bytes()
    phase("dp_failover_setup", t, flows=DP_FLOWS, full_bytes=full)
    dead = int(router.ordinals[MESH_DEAD])
    backup = int(router.ordinals[FAIL_RESPLIT])
    dp_, tp = MESH_SHAPE
    per_dispatch = {kernels.DP_MESH_PROBE.name: 4 * dp_ * tp,
                    kernels.DP_MESH_COMBINE.name: dp_}
    counts, results = {}, {}

    def dispatch(tag):
        torch.cuda.synchronize()
        reset_counts(kernels)
        t1 = time.perf_counter()
        res = router.dispatch_flows(**cols)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts[tag] = dp_counts(kernels)
        err = dp_result_err(res, want)
        results[tag] = res
        return res, err, wall

    for tag in ("healthy", "kill", "resplit", "backup_back", "readmit"):
        t = time.perf_counter()
        if tag == "kill":
            faultinject.arm("engine.dispatch", f"raise:chip={dead}")
        if tag == "resplit":
            router.bank.record_failure(backup, "smoke kill")
        if tag == "backup_back":  # the backup closes: its slices repaired
            router.bank.breaker(backup).reset()
        if tag == "readmit":
            faultinject.disarm("engine.dispatch")
            clock.now += 2.0
            st = router.dp_store
            st._slots[st._cur]["dev"] = dp_poisoned(
                st.current(), MESH_DEAD, u["axes"])
        res, err, wall = dispatch(tag)
        phase(f"dp_failover_{tag}", t, chip=dead, err=err,
              wall_ms=round(wall * 1e3, 3), launches=counts[tag],
              replica_hits=res.replica_hits, rerouted=res.rerouted,
              degraded=res.degraded, rebalanced=list(res.rebalanced_chips),
              rebalance_bytes=res.rebalance_bytes, full_upload_bytes=full,
              rebalance_ms=round(res.rebalance_ms, 3),
              dp_out=sorted(router._dp_out), state=router.bank.state(dead))
        repair = counts[tag].get(kernels.REPAIR_SCATTER.name, 0)
        bad = (any(err.values()) or res.degraded
               or {k: v for k, v in counts[tag].items()
                   if k != kernels.REPAIR_SCATTER.name} != per_dispatch)
        if tag == "healthy":
            bad |= bool(res.replica_hits or res.rerouted)
        if tag == "kill":
            bad |= res.replica_hits <= 0 or res.rerouted or (
                dead not in router._dp_out)
        if tag == "resplit":
            bad |= not res.rerouted
        if tag == "backup_back":
            bad |= (res.rerouted or res.replica_hits <= 0 or not repair
                    or res.rebalanced_chips != (backup,)
                    or not 0 < res.rebalance_bytes < full)
        if tag == "readmit":
            bad |= (res.rebalanced_chips != (dead,) or bool(router._dp_out)
                    or not 0 < res.rebalance_bytes < full or not repair
                    or res.replica_hits or router.bank.state(dead) != "closed")
        if bad:
            raise SystemExit(f"dp_failover_{tag}: the router's fused path "
                             f"differs or degraded: {err}")
    return dict(counts=counts)


def dp_records(kernels, u, form_pair: bool = False) -> dict:
    """Batch row 0's records of every round and its combine, on the
    kernels, from the store's epoch: the per-flow batch's row (or the
    pair's egress half's)."""
    from cilium_tpu_torch.engine import datapath_mesh as dm

    dp_, tp = MESH_SHAPE
    md = u["store"].current()
    g = u["ev"].geom
    n = DP_FLOWS // dp_
    flows = u["words"][:, :n].contiguous()
    alive = torch.ones(tp, dtype=torch.bool, device="cuda")
    recs, prev = {}, None
    for rnd in range(4):
        prev = [kernels.DP_MESH_PROBE(rnd, md.shard(0, k), flows,
                                      dm.FORM_WORDS, prev, alive, k, g)
                for k in range(tp)]
        recs[rnd] = prev
    return dict(md=md, g=g, flows=flows, alive=alive, recs=recs)


# the flow words (4 B each) a step reads: rounds S and L the tuple's five,
# F the five and the direction, P the ep, direction and protocol words,
# the combine the ep, saddr, direction and fragment words
DP_FLOW_BYTES = (20, 20, 24, 12)
DP_COMBINE_FLOW_BYTES = 16
DP_OUT_BYTES = 39  # the 15 DatapathVerdicts columns of a flow


def dp_head_rows(rnd: int, tab) -> int:
    """The value rows of round `rnd`'s record that shard 0 alone writes
    (the other shards write 0 there): F's post-DNAT daddr, dport, rev_nat
    and slave; P's wildcard value, idx, CT result and post-DNAT tuple;
    all of L's with the classic LB layout, which shard 0 alone runs."""
    from cilium_tpu_torch.engine import datapath_mesh as dm
    from cilium_tpu_torch.lb.device import LBInline

    if rnd == dm.ROUND_L:
        return 0 if isinstance(tab.lb, LBInline) else dm.RECORD_ROWS[rnd] - 1
    return {dm.ROUND_S: 0, dm.ROUND_F: 4, dm.ROUND_P: 7}[rnd]


def dp_probe_need(u, r, rnd: int, t: int) -> int:
    """Bytes one DP_MESH_PROBE launch of shard t must move for its batch
    row's data: the flow words the round reads (DP_FLOW_BYTES); the
    previous round's records, the flags and the value rows of all tp
    records and the head rows (dp_head_rows) of shard 0's alone; its
    record out (on shards 1 .. tp - 1 without the head rows); and each
    distinct row or element of the shard's leaves that the plain version
    gathers, read once; stashes and the scan's ranges whole (shard 0
    reads them)."""
    from cilium_tpu_torch.engine import datapath_mesh as dm
    from cilium_tpu_torch.lb.device import LBInline

    tab = r["md"].shard(0, t)
    leaves = {
        dm.ROUND_S: [("ct", "buckets"), ("ct", "stash")],
        dm.ROUND_L: ([("lb", "rows"), ("lb", "stash")]
                     if isinstance(tab.lb, LBInline) else
                     [("lb", "buckets"), ("lb", "stash"),
                      ("lb", "backend_rows")]),
        dm.ROUND_F: [("ct", "buckets"), ("ct", "stash"),
                     ("ipcache", "buckets"), ("ipcache", "stash")]
        + ([("ipcache", "range_rows")] if tab.ipcache.range_rows is not None
           else [("ipcache", f"range_{k}") for k in
                 ("base", "mask", "plen", "value")]),
        dm.ROUND_P: [("policy", "l4_hash_rows"), ("policy", "l4_hash_stash"),
                     ("policy", "l4_wild_rows"), ("policy", "l4_wild_stash"),
                     ("policy", "l3_allow_bits")],
    }[rnd]
    if t != 0:  # the replicated leaves are shard 0's
        leaves = [lf for lf in leaves if lf[1] in (
            "buckets", "rows", "range_rows", "l4_hash_rows",
            "l3_allow_bits")]
    prev = None if rnd == 0 else r["recs"][rnd - 1]
    rows_b, _, _ = leaf_bytes(
        [(f"{f}.{n}", getattr(getattr(tab, f), n)) for f, n in leaves],
        lambda: dm.dp_mesh_probe_plain(rnd, tab, r["flows"], dm.FORM_WORDS,
                                       prev, r["alive"], t, r["g"]))
    b = int(r["flows"].shape[1])
    tp = MESH_SHAPE[1]
    prev_rows = 0
    if rnd != 0:
        head = dp_head_rows(rnd - 1, tab)
        prev_rows = (dm.RECORD_ROWS[rnd - 1] - head) * tp + head
    out_rows = dm.RECORD_ROWS[rnd] - (0 if t == 0 else dp_head_rows(rnd, tab))
    return rows_b + b * (DP_FLOW_BYTES[rnd] + 4 * (prev_rows + out_rows))


def dp_combine_need(tab, parts, flows, g) -> int:
    """Bytes one DP_MESH_COMBINE launch must move for a batch row: the
    flow words it reads (16 B a flow); of the tp round-P records `parts`
    the flags and the owner's value of each (8 B each) and the head rows
    of shard 0's (28 B); the L3 column of each L3 hit on the shard that
    read the word (4 B); the 39 B of columns out; each l4_meta cell (not
    with 3-word L4 entries, whose values carry the proxy) and id_table
    entry the plain version gathers; the prefilter whole; the counter
    buffers the call returns written whole (l4, l3: every entry once), the
    [2, 20] telemetry and the replica count written once.  `tab` is shard
    0's tables."""
    from cilium_tpu_torch.compiler.tables import l4_entry_words
    from cilium_tpu_torch.engine import datapath_mesh as dm
    from cilium_tpu_torch.engine import oracle

    leaves = [("policy.id_table", tab.policy.id_table)] + [
        (f"prefilter.{f.name}", getattr(tab.prefilter, f.name))
        for f in dataclasses.fields(tab.prefilter)]
    if l4_entry_words(tab.policy) != 3:
        leaves.append(("policy.l4_meta", tab.policy.l4_meta))
    meta_b, _, out = leaf_bytes(leaves, lambda: dm.dp_mesh_combine_plain(
        parts, tab, flows, dm.FORM_WORDS, g))
    l3_hit = out[0].match_kind.to(torch.int64) == oracle.MATCH_L3
    owner_reads = sum(
        int((l3_hit & ((p[0].to(torch.int64) & dm.P_P2) != 0)).sum().item())
        for p in parts[:g["route"].l3_shards])
    counters = out[1].numel() + out[2].numel()
    b = int(flows.shape[1])
    head = dp_head_rows(dm.ROUND_P, tab)
    return (b * (DP_COMBINE_FLOW_BYTES + 8 * len(parts) + 4 * head
                 + DP_OUT_BYTES) + 4 * owner_reads + meta_b
            + 4 * counters + 160 + 4)


def combine_fills(g, tab):
    """The zero fill of DP_MESH_COMBINE's wrapper (its l4, l3, replica
    and telemetry buffers are views of one zeroed allocation), for the
    fill's time alone."""
    from cilium_tpu_torch.engine.verdict import TELEM_COLS

    pol = tab.policy
    n_eps, kg = int(pol.l4_meta.shape[0]), int(pol.l4_meta.shape[2])
    n_l3 = int(g["route"].l3_shards) * int(g["route"].c_local)
    n = n_eps * 2 * (kg + n_l3) + 1 + 2 * TELEM_COLS
    return lambda: torch.zeros(n, dtype=torch.int32, device="cuda")


def combine_times(kernels, fn, tab, parts, flows, g, what: str) -> dict:
    """DP_MESH_COMBINE's device ms at one shape (a call, its wrapper's
    zero fill with it), its zero fill's alone and share, the four fills
    the wrapper made before it zeroed one allocation (each buffer its
    own torch.zeros: `four_fills_ms`), CUDA events, and the bound
    (dp_combine_need)."""
    need = dp_combine_need(tab, parts, flows, g)
    ms = dp_device_ms(fn, what)
    fills = dp_device_ms(combine_fills(g, tab), f"{what} fills")
    out = fn()
    shapes = [tuple(x.shape) for x in out[1:] if x is not None]
    four = dp_device_ms(lambda: [torch.zeros(s, dtype=torch.int32,
                                             device="cuda") for s in shapes],
                        f"{what} four fills")
    return dict(ms=ms, fills_ms=fills, fills_share=fills / ms,
                four_fills_ms=four, counter_bytes=4 * sum(
                    x.numel() for x in out[1:] if x is not None),
                wrapper_ms=event_ms(fn, DP_CALLS), bytes=need,
                bound_ms=need / HBM_BYTES_PER_S * 1e3, flows=int(
                    flows.shape[1]), records=len(parts))


def dp_device_ms(fn, what: str) -> float:
    """A kernel's device ms per launch: DP_CALLS launches queued behind a
    device spin (queued_ms), a longer spin if the host fell behind."""
    ms = queued_ms(fn, DP_CALLS)
    if ms is None:
        ms = queued_ms(fn, DP_CALLS, spin_cycles=500_000_000)
    if ms is None:
        raise SystemExit(f"dp_mesh_timing {what}: the launches did not "
                         "queue behind the device spin")
    return ms


def busy_split(fn, reps: int) -> dict:
    """One traced run of `reps` calls of `fn`: the wall ms per call (the
    profiler's own host time included), the device's busy ms per call
    (device_busy's kernels and copies) and the rest, the ms per call
    the device waited on the host."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / reps
    busy = sum(device_busy(prof).values()) / reps
    return dict(wall_ms=wall, busy_ms=busy, idle_ms=wall - busy)


def dp_mesh_timing(kernels, u, path_counts, smi) -> list:
    """Each new kernel against its plain version on the card at the path's
    shapes (batch row 0 of the mixed batch: every round on every shard,
    the combine; the pair's ingress half's rounds F and P on shard 0),
    bit-exact; its device ms per launch (DP_CALLS launches on shard (0,
    0) queued behind a device spin) and CUDA events over as many
    launches as the caller sees them (`wrapper_ms`: the wrapper's host
    time when a launch takes less), the plain version's ms and the byte
    bound at 3.35 TB/s; both evaluators' ms beside DATAPATH_PAIR's and
    DATAPATH_STEP's on the same flows; with the card's name and power
    limit."""
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import datapath_mesh as dm
    from cilium_tpu_torch.engine import verdict

    t = time.perf_counter()
    tp = MESH_SHAPE[1]
    r = dp_records(kernels, u)
    md, g, flows, alive = r["md"], r["g"], r["flows"], r["alive"]
    errs = {}
    for rnd, name in enumerate("SLFP"):
        prev = None if rnd == 0 else r["recs"][rnd - 1]
        errs[name] = sum(entries_differ(
            r["recs"][rnd][k], dm.dp_mesh_probe_plain(
                rnd, md.shard(0, k), flows, dm.FORM_WORDS, prev, alive, k, g))
            for k in range(tp))
    got = kernels.DP_MESH_COMBINE(r["recs"][3], md.shard(0, 0), flows,
                                  dm.FORM_WORDS, g)
    want = dm.dp_mesh_combine_plain(r["recs"][3], md.shard(0, 0), flows,
                                    dm.FORM_WORDS, g)
    errs["combine"] = dp_rows_differ(got[0], want[0]) + sum(
        entries_differ(a, b) for a, b in zip(got[1:], want[1:]))
    # the pair's ingress half: packed4 flows, static ingress (F, P only)
    half = u["pair"][0][:, :HALF // MESH_SHAPE[0]].contiguous()
    prev_k = prev_p = None
    errs["pair_ingress"] = 0
    for rnd in (dm.ROUND_F, dm.ROUND_P):
        prev_k = [kernels.DP_MESH_PROBE(rnd, md.shard(0, k), half,
                                        dm.FORM_PACKED4, prev_k, alive, k, g,
                                        0) for k in range(tp)]
        prev_p = [dm.dp_mesh_probe_plain(rnd, md.shard(0, k), half,
                                         dm.FORM_PACKED4, prev_p, alive, k,
                                         g, 0) for k in range(tp)]
        errs["pair_ingress"] += sum(entries_differ(a, b)
                                    for a, b in zip(prev_k, prev_p))
    gk = kernels.DP_MESH_COMBINE(prev_k, md.shard(0, 0), half,
                                 dm.FORM_PACKED4, g, None, 0)
    gp = dm.dp_mesh_combine_plain(prev_p, md.shard(0, 0), half,
                                  dm.FORM_PACKED4, g, None, 0)
    errs["pair_ingress"] += dp_rows_differ(gk[0], gp[0]) + sum(
        entries_differ(a, b) for a, b in zip(gk[1:], gp[1:]))
    torch.cuda.synchronize()
    if any(errs.values()):
        raise SystemExit(f"dp_mesh_timing: kernels differ from plain {errs}")
    rounds = {}
    for rnd, name in enumerate("SLFP"):
        prev = None if rnd == 0 else r["recs"][rnd - 1]
        tab = md.shard(0, 0)
        fn = (lambda rnd=rnd, prev=prev, tab=tab: kernels.DP_MESH_PROBE(
            rnd, tab, flows, dm.FORM_WORDS, prev, alive, 0, g))
        plain = (lambda rnd=rnd, prev=prev, tab=tab: dm.dp_mesh_probe_plain(
            rnd, tab, flows, dm.FORM_WORDS, prev, alive, 0, g))
        need = dp_probe_need(u, r, rnd, 0)
        rounds[name] = dict(ms=dp_device_ms(fn, f"round {name}"),
                            wrapper_ms=event_ms(fn, DP_CALLS),
                            plain_ms=event_ms(plain, 2), bytes=need,
                            bound_ms=need / HBM_BYTES_PER_S * 1e3)
    # the parent's csrc/datapath_mesh.cu (--ab-parent): the shared stage
    # code, each round on shard (0, 0)
    ab = library_ab(kernels, "datapath_mesh", {
        name: (lambda rnd=rnd, prev=(None if rnd == 0 else r["recs"][rnd - 1]):
               kernels.DP_MESH_PROBE(rnd, md.shard(0, 0), flows,
                                     dm.FORM_WORDS, prev, alive, 0, g))
        for rnd, name in enumerate("SLFP")})
    tab0 = md.shard(0, 0)
    comb_fn = (lambda: kernels.DP_MESH_COMBINE(
        r["recs"][3], tab0, flows, dm.FORM_WORDS, g))
    comb = combine_times(kernels, comb_fn, tab0, r["recs"][3], flows, g,
                         "combine")
    comb["plain_ms"] = event_ms(lambda: dm.dp_mesh_combine_plain(
        r["recs"][3], tab0, flows, dm.FORM_WORDS, g), 2)
    comb["ptxas"] = COMBINE_PTXAS
    # the parent's combine beside this one (--ab-parent), with and
    # without telemetry
    comb_ab = library_ab(kernels, "datapath_mesh", {
        "combine": comb_fn,
        "combine_no_telemetry": lambda: kernels.DP_MESH_COMBINE(
            r["recs"][3], tab0, flows, dm.FORM_WORDS, g, None, None,
            False)})
    # the evaluators beside the single-device program on the same flows
    alive_all = np.ones(MESH_SHAPE, bool)
    tables = u["tables"]
    acc = verdict.make_counter_buffers(tables.policy)
    tel = verdict.make_telemetry_buffers(acc.device)
    fb = dp.flow_batch_from_packed(u["words"])
    evals = dict(
        pair_evaluator_ms=event_ms(lambda: u["ev_pair"](
            md, u["pair"], alive_all, None), DP_EV_CALLS),
        datapath_pair_ms=event_ms(lambda: kernels.DATAPATH_PAIR(
            tables, u["pair"], acc, tel), DP_CALLS),
        flow_evaluator_ms=event_ms(lambda: u["ev"](
            md, u["words"], alive_all, None), DP_EV_CALLS),
        datapath_step_ms=event_ms(lambda: dp.datapath_step_with_counters(
            tables, fb), DP_CALLS))
    evals["pair_ratio"] = (evals["pair_evaluator_ms"]
                           / evals["datapath_pair_ms"])
    evals["flow_ratio"] = (evals["flow_evaluator_ms"]
                           / evals["datapath_step_ms"])
    # the evaluators' spread: DP_EV_REPEATS more timings each, and as many
    # traced runs that split a call into the device's busy time and the
    # time it waited on the host (launches, the per-row copies and syncs)
    spread = {}
    for name, fn in (
            ("pair_evaluator", lambda: u["ev_pair"](md, u["pair"], alive_all,
                                                    None)),
            ("flow_evaluator", lambda: u["ev"](md, u["words"], alive_all,
                                               None))):
        spread[name] = dict(
            ms=[event_ms(fn, DP_EV_CALLS) for _ in range(DP_EV_REPEATS)],
            traced=[busy_split(fn, DP_EV_CALLS)
                    for _ in range(DP_EV_REPEATS)])
    evals["spread"] = spread
    for name, res in list(rounds.items()) + [("combine", comb)]:
        print(f"  dp_mesh_timing {name} " + json.dumps(res), flush=True)
    print("  dp_mesh_timing evaluators " + json.dumps(evals), flush=True)
    phase("dp_mesh_timing", t, card=repr(smi), calls=DP_CALLS,
          flows_per_row=int(flows.shape[1]), errs=errs)
    probe = dict(ms=sum(v["ms"] for v in rounds.values()) / 4,
                 wrapper_ms=sum(v["wrapper_ms"] for v in rounds.values()) / 4,
                 plain_ms=sum(v["plain_ms"] for v in rounds.values()) / 4,
                 bound_ms=sum(v["bound_ms"] for v in rounds.values()) / 4)
    rows = []
    for kernel, res, replaces in (
            (kernels.DP_MESH_PROBE, probe,
             "cilium_tpu/engine/datapath_mesh.py:231"),
            (kernels.DP_MESH_COMBINE, comb,
             "cilium_tpu/engine/datapath_mesh.py:231")):
        row = kernel_row(kernel, DP_SRC, replaces,
                         path_counts.get(kernel.name, 0), 0, res["ms"],
                         res["plain_ms"], res["bound_ms"], 0.0)
        row["wrapper_ms"] = res["wrapper_ms"]
        row["evaluators"] = evals
        dp_, tp = MESH_SHAPE
        row["launches_per_dispatch"] = (
            {"flows": 4 * dp_ * tp, "pair": 6 * dp_ * tp}
            if kernel is kernels.DP_MESH_PROBE
            else {"flows": dp_, "pair": 2 * dp_})
        if kernel is kernels.DP_MESH_PROBE:
            row["by_round"] = rounds
            if ab is not None:
                row["ab"] = ab["medians"]
        else:
            row.update({k: comb[k] for k in (
                "fills_ms", "fills_share", "four_fills_ms", "counter_bytes",
                "ptxas", "bytes")})
            if comb_ab is not None:
                row["ab"] = comb_ab["medians"]
        rows.append(row)
    return rows


def dp_mesh_phases(kernels, w, host, tables, node, rows, smi) -> None:
    """The fused datapath on the mesh (K21 datapath mesh): dp_mesh_setup,
    the path (dp_mesh, dp_mesh_node), dp_mesh_store, dp_failover,
    dp_mesh_timing; the two new kernels' rows go into `rows`, and the
    paths' launches of REPAIR_SCATTER into its row's launches_by_path."""
    u = dp_mesh_setup(kernels, w, host, tables)
    oracle = dp_oracle(kernels, tables, u["pair"], u["words"])
    path = dp_mesh_path(kernels, u, oracle)
    nodep = dp_mesh_node(kernels, u, node)
    del oracle
    st = dp_mesh_store(kernels, w, u)
    fo = dp_failover(kernels, u, st["host"], st["tables"])
    u["tables"] = st["tables"]
    totals = {}
    for c in (list(path["counts"].values()) + list(nodep["counts"].values())
              + list(st["counts"].values()) + list(fo["counts"].values())):
        for k, v in c.items():
            totals[k] = totals.get(k, 0) + v
    for row in rows:
        n = totals.get(row["name"], 0)
        if n:
            row.setdefault("launches_by_path", {"earlier": row["launches"]})
            row["launches_by_path"]["dp_mesh"] = n
            row["launches"] += n
        if row["name"] == kernels.REPAIR_SCATTER.name:
            row["datapath_delta"] = {k: st["scatter"][k] for k in (
                "segments", "rows", "ms", "cold_ms", "events_ms", "plain_ms",
                "bound_ms", "library_ms", "library_cold_ms",
                "library_events_ms", "geometry", "ab")}
    torch.cuda.empty_cache()
    rows.extend(dp_mesh_timing(kernels, u, totals, smi))
    if any(not totals.get(k.name) for k in (kernels.DP_MESH_PROBE,
                                           kernels.DP_MESH_COMBINE)):
        raise SystemExit(f"dp_mesh: a new kernel never launched on its path: "
                         f"{totals}")


def dp_mesh_alone() -> None:
    """dp_mesh_setup and dp_mesh_timing alone on config 5's world (the
    kernels built first), for the spread of their times across
    processes: `python3 -c "import chip_smoke;
    chip_smoke.dp_mesh_alone()"` on one H100."""
    from cilium_tpu_torch import kernels, world
    from cilium_tpu_torch.convert import tables_to

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = nvidia_smi()
    t = time.perf_counter()
    kernels.build_all()
    for k in kernels.KERNELS:
        k.load()
    phase("build", t, card=repr(smi))
    w = world.make_world(seed=5)
    host = world.headline_tables(w, w.host_tables())
    u = dp_mesh_setup(kernels, w, host, tables_to(host, "cuda"))
    dp_mesh_timing(kernels, u, {}, smi)


# -- the lookups of K20 outside the datapath (HASH_LOOKUP, IPCACHE_LOOKUP) --------

LOOKUP_SRC = "cilium_tpu_torch/csrc/lookup.cu"
HASH_KEYS = 1 << 18  # capacity LOAD_FACTOR_INV x keys = 1,048,576
HASH_KW = 4  # a CT tuple's key words
HASH_QUERIES = 1 << 22  # half hits, half misses
HASH_CANDIDATES = 1 << 26  # keys hashed on the card to find the cluster
HASH_CLUSTER_SLOTS = 4  # the cluster's home slots: the main region's last
HASH_STASH_FILL = 120  # stash rows the cluster aims to fill (of 128)
HASH_SENTINELS = 1024  # all-ones query rows
HASH_DICT_ROWS = 1 << 16  # queries also held against a host dict
IPC_ADDRESSES = 1 << 20
LOOKUP_CALLS = 20


def hash_world(seed: int = 61) -> dict:
    """262,144 unique KW = 4 keys, a few of them a cluster whose home
    slots are the main region's last HASH_CLUSTER_SLOTS (found by hashing
    HASH_CANDIDATES random keys on the card), sized so that the stash
    holds about HASH_STASH_FILL keys and the cluster's windows wrap to
    slot 0; the table built on the host (build_hash_table)."""
    from cilium_tpu_torch.engine import hashtable as ht

    t = time.perf_counter()
    cap = ht.LOAD_FACTOR_INV * HASH_KEYS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cand = torch.randint(-(1 << 31), 1 << 31, (HASH_CANDIDATES, HASH_KW),
                         generator=gen, device="cuda", dtype=torch.int32)
    home = ht.fnv1a(cand) & (cap - 1)
    cluster = cand[home >= cap - HASH_CLUSTER_SLOTS].cpu().numpy().view(
        np.uint32)
    del cand, home
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed)
    bg = np.unique(rng.integers(0, 1 << 32, size=(HASH_KEYS + 4096, HASH_KW),
                                dtype=np.uint64).astype(np.uint32), axis=0)
    bg = bg[~(bg == M32).all(axis=1)]
    bg = bg[~(bg[:, None, :] == cluster[None, :, :]).all(axis=2).any(axis=1)]
    bg = bg[rng.permutation(len(bg))]
    _, base_left = ht._place_vectorized(ht._fnv1a_host(bg[:HASH_KEYS]), cap,
                                        ht.PROBE_WINDOW)
    n_cluster = min(len(cluster), 2 * HASH_CLUSTER_SLOTS + 8
                    + HASH_STASH_FILL - len(base_left))
    while True:
        keys = np.concatenate([bg[:HASH_KEYS - n_cluster],
                               cluster[:n_cluster]])
        table = ht.build_hash_table(keys, min_capacity=cap)
        stash = int((~(table.keys[cap:] == M32).all(axis=1)).sum())
        if table.capacity == cap:
            break
        n_cluster -= 8  # the stash overflowed: a smaller cluster
    wrapped = int((table.value_index[:ht.PROBE_WINDOW]
                   >= HASH_KEYS - n_cluster).sum())
    phase("hash_world", t, keys=len(keys), capacity=table.capacity,
          stash_rows=table.keys.shape[0] - cap, stash_filled=stash,
          cluster=n_cluster, cluster_candidates=len(cluster),
          wrapped_slots=wrapped)
    if stash < HASH_STASH_FILL // 2 or not wrapped:
        raise SystemExit(f"hash_world: stash {stash}, wrapped {wrapped}")
    return dict(keys=keys, table=table, cluster=n_cluster, stash=stash)


def hash_queries(hw: dict, seed: int = 62) -> np.ndarray:
    """HASH_QUERIES rows, shuffled: half hits (every stash and cluster key,
    then keys drawn with repetition), half misses (random u32 rows,
    HASH_SENTINELS all-ones rows and keys with one word flipped)."""
    rng = np.random.default_rng(seed)
    keys = hw["keys"]
    half = HASH_QUERIES // 2
    n = len(keys)
    special = np.arange(n - hw["cluster"], n)
    hits = keys[np.concatenate([special, rng.integers(
        0, n, size=half - len(special))])]
    flip = keys[rng.integers(0, n, size=4096)].copy()
    flip[:, 1] ^= 0x5A5A5A5A
    miss = np.concatenate([
        np.full((HASH_SENTINELS, HASH_KW), M32, np.uint32), flip,
        rng.integers(0, 1 << 32, size=(half - HASH_SENTINELS - len(flip),
                                       HASH_KW), dtype=np.uint64
                     ).astype(np.uint32)])
    q = np.concatenate([hits, miss])
    return q[rng.permutation(len(q))]


def hash_need(table, q: torch.Tensor, found: torch.Tensor,
              index: torch.Tensor) -> int:
    """Bytes HASH_LOOKUP must move on `q`, whose answer is (found,
    index): the queries read and (found, index) written once, the key
    words of each distinct main-region slot a window reads and of the
    stash, once, and the value_index word of each distinct slot a query
    hits (keys are distinct, so one index per slot)."""
    from cilium_tpu_torch.engine import hashtable as ht

    cap = int(table.capacity)
    h = ht.fnv1a(q) & (cap - 1)
    touched = torch.zeros(cap, dtype=torch.bool, device=q.device)
    for p in range(int(table.max_probes)):
        touched[(h + p) & (cap - 1)] = True
    slots = int(touched.sum().item())
    kw = int(table.keys.shape[1])
    stash = int(table.keys.shape[0]) - cap
    hit_slots = int(torch.unique(index[found]).numel())
    return (nbytes(q) + q.shape[0] * 5 + (slots + stash) * 4 * kw
            + hit_slots * 4)


def hash_lookup_phase(kernels, rows) -> None:
    """hash_lookup: the generic hash table (K20 rest a) at 262,144 keys
    and 4,194,304 queries through lookup_batch (HASH_LOOKUP, counts set to
    0 just before and read just after), against the plain version on the
    card and HASH_DICT_ROWS rows against a host dict; then timed."""
    from cilium_tpu_torch.convert import hashtable_to
    from cilium_tpu_torch.engine import hashtable as ht

    hw = hash_world()
    t = time.perf_counter()
    tab = hashtable_to(hw["table"], "cuda")
    qh = hash_queries(hw)
    q = torch.from_numpy(qh.view(np.int32)).cuda()
    torch.cuda.synchronize()
    reset_counts(kernels)
    t1 = time.perf_counter()
    found, index = ht.lookup_batch(tab, q)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = dp_counts(kernels)
    pf, pi = ht.lookup_batch_plain(tab, q)
    err = max(int_err(found, pf), int_err(index, pi))
    rows_dict = {tuple(k): i for i, k in enumerate(hw["keys"].tolist())}
    fh, ih = found[:HASH_DICT_ROWS].cpu().numpy(), index[
        :HASH_DICT_ROWS].cpu().numpy()
    dict_err = 0
    for k, f, i in zip(qh[:HASH_DICT_ROWS].tolist(), fh, ih):
        want = rows_dict.get(tuple(k))
        dict_err += (bool(f) != (want is not None)) or (
            want is not None and int(i) != want) or (want is None and i != 0)
    n_found = int(found.sum().item())
    phase("hash_lookup", t, keys=len(hw["keys"]), queries=HASH_QUERIES,
          kw=HASH_KW, capacity=tab.capacity, stash_filled=hw["stash"],
          launches=counts, wall_ms=round(wall * 1e3, 3), found=n_found,
          max_abs_err=err, dict_rows=HASH_DICT_ROWS, dict_differing=dict_err)
    if (err or dict_err or counts != {kernels.HASH_LOOKUP.name: 1}
            or n_found < HASH_QUERIES // 2):
        raise SystemExit("hash_lookup: the kernel differs from its plain "
                         "version or the host dict")
    t = time.perf_counter()
    ms = event_ms(lambda: kernels.HASH_LOOKUP(tab, q), LOOKUP_CALLS)
    qms = queued_ms(lambda: kernels.HASH_LOOKUP(tab, q), LOOKUP_CALLS)
    plain_ms = event_ms(lambda: ht.lookup_batch_plain(tab, q), 3)
    need = hash_need(tab, q, pf, pi)
    ops = HASH_QUERIES * (12 * HASH_KW + 2 * ht.PROBE_WINDOW * HASH_KW)
    bb, bo = need / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    phase("hash_lookup_timing", t, ms=round(ms, 4), queued_ms=qms,
          plain_ms=round(plain_ms, 4), need_bytes=need,
          bound_ms=round(max(bb, bo), 4))
    row = kernel_row(kernels.HASH_LOOKUP, LOOKUP_SRC,
                     "cilium_tpu/engine/hashtable.py:200",
                     counts[kernels.HASH_LOOKUP.name], err, ms, plain_ms,
                     bb, bo)
    row.update(queued_ms=qms, launches_by_path={"hash_lookup": 1})
    rows.append(row)


def ipcache_forms(w, host, node) -> dict:
    """The IPCacheDevice forms on the host: config 5's generic (raw
    identities), its idx form with L3 planes (32 endpoints), that form in
    sub-word planes (the headline's), and the node world's idx form
    without L3 planes and with the [B, P] scan."""
    from cilium_tpu_torch.ipcache.lpm import (
        build_ipcache,
        specialize_ipcache_to_idx,
        subword_ipcache,
    )

    generic = build_ipcache(w.ipc_map)
    planes = specialize_ipcache_to_idx(generic, host.policy)
    return {"config5_generic": generic, "config5_idx_planes": planes,
            "config5_subword": subword_ipcache(planes),
            "node_idx_scan": node[1].ipcache}


def ipc_addresses(ipc_map, seed: int = 63) -> np.ndarray:
    """IPC_ADDRESSES addresses: every /32 of the map, the first and last
    address of every range, the empty-lane marker 0xFFFFFFFF, and
    random addresses inside the ranges and anywhere."""
    rng = np.random.default_rng(seed)
    exact, lo, hi = [], [], []
    for cidr in ipc_map:
        net = ipaddress.ip_network(cidr, strict=False)
        if net.prefixlen == 32:
            exact.append(int(net.network_address))
        else:
            lo.append(int(net.network_address))
            hi.append(int(net.broadcast_address))
    lo, hi = np.asarray(lo, np.int64), np.asarray(hi, np.int64)
    pick = rng.integers(0, len(lo), size=IPC_ADDRESSES // 4)
    inside = lo[pick] + (rng.random(len(pick)) * (hi[pick] - lo[pick] + 1)
                         ).astype(np.int64)
    head = np.concatenate([exact, lo, hi, [M32] * 16, inside]).astype(
        np.int64)[:IPC_ADDRESSES // 2]
    rest = rng.integers(0, 1 << 32, size=IPC_ADDRESSES - len(head))
    return np.concatenate([head, rest]).astype(np.uint32)


def distinct_words(row: torch.Tensor, lane: torch.Tensor) -> int:
    """The count of distinct (row, lane) pairs: the u32 words read."""
    return int(torch.unique(row.to(torch.int64) * 65536 + lane).numel())


def ipc_need(ipc, ips: torch.Tensor) -> int:
    """Bytes IPCACHE_LOOKUP must move on `ips`: the addresses read and
    the values written once; the key lanes of each distinct bucket row
    the addresses hash to and the stash's address column; the one value
    word holding each distinct exact hit's entry; and, for the addresses
    no /32 holds, the base and length lanes of each distinct range-class
    row their classes probe, longest first until one hits (or the scan's
    base, mask and length columns), with the value word of each distinct
    range hit.  The L3 planes and columns are not counted: lpm_lookup
    returns the value alone."""
    from cilium_tpu_torch.device import widen
    from cilium_tpu_torch.engine import subword as sw
    from cilium_tpu_torch.engine.hashtable import fnv1a
    from cilium_tpu_torch.ipcache import lpm

    x = ips.to(torch.int64) & M32
    sub = bool(ipc.bucket_entries)
    per = (ipc.bucket_entries if sub
           else (32 if ipc.l3_planes else lpm.IP_ENTRIES_PER_BUCKET))
    vpl = 32 // (ipc.value_width if sub else 32)  # entries a value word
    h = fnv1a(x[:, None]) & (int(ipc.n_buckets) - 1)
    need = 8 * x.numel() + int(torch.unique(h).numel()) * per * 4
    hit = widen(ipc.buckets[:, :per][h]) == x[:, None]
    b_found = hit.any(dim=1)
    lane = hit.to(torch.int8).argmax(dim=1) // vpl
    need += 4 * distinct_words(h[b_found], lane[b_found])
    stash = widen(ipc.stash)
    need += 4 * int(stash.shape[0])
    s_hit = stash[None, :, 0] == x[:, None]
    s_found = s_hit.any(dim=1)
    need += 4 * int(torch.unique(s_hit.to(torch.int8).argmax(dim=1)[
        s_found]).numel())
    rest = x[~(b_found | s_found)]
    if ipc.range_rows is None:
        base, mask = widen(ipc.range_base), widen(ipc.range_mask)
        plen = widen(ipc.range_plen)
        need += 4 * 3 * int(plen.shape[0])
        won = []
        for k in range(0, int(rest.shape[0]), 1 << 12):
            r = rest[k:k + (1 << 12)]
            match = (r[:, None] & mask[None, :]) == base[None, :]
            lens = torch.where(match, plen[None, :], 0)
            best = lens.amax(dim=1)
            won.append(lens.argmax(dim=1)[best > 0])
        if won:
            need += 4 * int(torch.unique(torch.cat(won)).numel())
        return need
    e = lpm.RANGE_ENTRIES_PER_BUCKET
    wd = ipc.range_widths or (32, 32, 32)
    kl = sw.lanes_for(e, wd[1])
    nrows = int(ipc.range_rows.shape[0])
    for sp in ipc.range_class_plens:
        w0, rh = lpm.range_class_key(rest, int(sp))
        rh = rh & (nrows - 1)
        need += int(torch.unique(rh).numel()) * 4 * (e + kl)
        row = ipc.range_rows[rh]
        hit = (widen(row[:, :e]) == w0[:, None]) & (
            sw.unpack_lanes(row[:, e:e + kl], wd[1], e) == int(sp))
        f = hit.any(dim=1)
        need += 4 * distinct_words(rh[f], hit.to(torch.int8).argmax(
            dim=1)[f] // (32 // wd[2]))
        rest = rest[~f]
    return need


def ipcache_lookup_phase(kernels, w, host, node, rows) -> None:
    """ipcache_lookup: IPC_ADDRESSES addresses through lpm_lookup over
    each IPCacheDevice form (IPCACHE_LOOKUP, counts set to 0 just before
    and read just after), each against its plain version on the card;
    the generic form also against lpm_lookup_plain over build_lpm of the
    same map (DIR-24-8, an independent build); then timed."""
    from cilium_tpu_torch.convert import lpm_to, plane_to
    from cilium_tpu_torch.device import narrow
    from cilium_tpu_torch.ipcache import lpm

    t = time.perf_counter()
    forms = {k: plane_to(v, "cuda") for k, v in ipcache_forms(
        w, host, node).items()}
    ips = {"config5": torch.from_numpy(ipc_addresses(w.ipc_map).view(
        np.int32)).cuda(), "node": torch.from_numpy(ipc_addresses(
            node[0].ipc_map, 64).view(np.int32)).cuda()}
    ips_of = {k: ips["node" if k.startswith("node") else "config5"]
              for k in forms}
    torch.cuda.synchronize()
    reset_counts(kernels)
    t1 = time.perf_counter()
    outs = {k: lpm.lpm_lookup(v, ips_of[k]) for k, v in forms.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = dp_counts(kernels)
    errs = {k: int_err(outs[k], narrow(lpm.lookup_plain(v, ips_of[k])),
                       u32=True) for k, v in forms.items()}
    dir24 = lpm.lpm_lookup_plain(lpm_to(lpm.build_lpm(w.ipc_map), "cuda"),
                                 ips["config5"])
    marker = (ips["config5"].to(torch.int64) & M32) == M32
    indep = int(((outs["config5_generic"].to(torch.int64) & M32)
                 != dir24)[~marker].sum().item())
    layouts = {k: dict(l3_planes=bool(v.l3_planes),
                       range_classes=v.range_rows is not None,
                       bucket_entries=int(v.bucket_entries),
                       idx=bool(v.values_are_idx),
                       found=int((outs[k] != 0).sum().item()))
               for k, v in forms.items()}
    phase("ipcache_lookup", t, addresses=IPC_ADDRESSES, launches=counts,
          wall_ms=round(wall * 1e3, 3), max_abs_err=json.dumps(errs),
          generic_vs_dir24_8_differing=indep, forms=json.dumps(layouts))
    if (any(errs.values()) or indep
            or counts != {kernels.IPCACHE_LOOKUP.name: len(forms)}
            or any(not v["found"] for v in layouts.values())):
        raise SystemExit("ipcache_lookup: the kernel differs from its plain "
                         "version or the generic form from DIR-24-8")
    t = time.perf_counter()
    by_form = {}
    for k, v in forms.items():
        x = ips_of[k]
        ms = event_ms(lambda: kernels.IPCACHE_LOOKUP(v, x), LOOKUP_CALLS)
        qms = queued_ms(lambda: kernels.IPCACHE_LOOKUP(v, x), LOOKUP_CALLS)
        plain_ms = event_ms(lambda: lpm.lookup_plain(v, x), 3)
        need = ipc_need(v, x)
        by_form[k] = dict(ms=ms, queued_ms=qms, plain_ms=plain_ms,
                          need_bytes=need,
                          bound_ms=need / HBM_BYTES_PER_S * 1e3,
                          max_abs_err=errs[k])
    # the parent's csrc/lookup.cu (--ab-parent): the shared stage code
    ab = library_ab(kernels, "lookup", {
        k: (lambda v=v, x=ips_of[k]: kernels.IPCACHE_LOOKUP(v, x))
        for k, v in forms.items()})
    phase("ipcache_lookup_timing", t, by_form=json.dumps(by_form))
    head = by_form["config5_subword"]
    row = kernel_row(kernels.IPCACHE_LOOKUP, LOOKUP_SRC,
                     "cilium_tpu/ipcache/lpm.py:1079",
                     counts[kernels.IPCACHE_LOOKUP.name], max(errs.values()),
                     head["ms"], head["plain_ms"], head["bound_ms"], 0.0)
    row.update(queued_ms=head["queued_ms"], by_form=by_form,
               launches_by_path={"ipcache_lookup": len(forms)})
    if ab is not None:
        row["ab"] = ab["medians"]
    rows.append(row)


# -- live resharding of the mesh stores ---------------------------------------------

RESHARD_SHAPE = (2, 2)  # the source mesh; the grow goes to (2, 4) and back
RESHARD_GROW_TP = 4
RESHARD_TUPLES = 1 << 18  # a checked dispatch's tuples, and its flows
RESHARD_STEPS = 8  # step_bytes: the grow's moved bytes over this many steps
RESHARD_PORT = 4361  # the policy churn's one-rule delta (team 0 -> app0)
RESHARD_CHURN_STEP = 2  # dp_churn's step (dp_mesh_store took 0 and 1)
RESHARD_CHURN_AT = 2  # the churn publish lands after this many grow steps


def reshard_setup(kernels, w, host, tables) -> dict:
    """The reshard phase's world: config 5's map states through a
    FleetCompiler (the router's policy tables) and a one-rule churn of
    them (RESHARD_PORT), config 5's compact DatapathTables (`host`) and
    a datapath churn step of them (a CT write-back and an ipcache
    upsert, dp_churn); the router on the virtual (2, 2) mesh (published
    twice, the datapath attached), breakers on a manual clock; the
    RESHARD_TUPLES tuples and flows of every checked dispatch and their
    references on both worlds (LATTICE, DATAPATH_STEP)."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.compiler.tables import FleetCompiler
    from cilium_tpu_torch.convert import policy_tables_to, tables_to
    from cilium_tpu_torch.engine import mesh
    from cilium_tpu_torch.engine.failover import ChipFailoverRouter
    from cilium_tpu_torch.engine.verdict import TupleBatch
    from cilium_tpu_torch.resilience import ChipBreakerBank

    t = time.perf_counter()
    fc = FleetCompiler(identity_pad=w.identity_pad, filter_pad=w.filter_pad)
    ids = list(w.identity_ids)
    arrays = world.map_state_arrays(w.states)
    pols = [host_copy(fc.compile([(e, s, 0) for e, s in enumerate(arrays)],
                                 ids)[0])]
    arrays = world.one_rule_states(w, RESHARD_PORT, states=arrays)
    pols.append(host_copy(fc.compile(
        [(e, s, 1 if e == 0 else 0) for e, s in enumerate(arrays)], ids)[0]))
    compile_s = time.perf_counter() - t
    cols = world.lattice_tuples(w, RESHARD_TUPLES, seed=7)
    batch = TupleBatch.from_numpy(**cols, device="cuda")
    pair = torch.from_numpy(w.pairs(seed=73, half=RESHARD_TUPLES // 2,
                                    k=1)[0].view(np.int32)).cuda()
    words = words_of_pair(pair, 74)
    dhosts = [host, dp_churn(kernels, w, host, tables, words,
                             RESHARD_CHURN_STEP)[0]]
    refs = []
    for pol, dh in zip(pols, dhosts):
        single = policy_tables_to(pol, "cuda")
        refs.append((lattice_ref(kernels, single, batch),
                     dp_oracle(kernels, tables_to(dh, "cuda"), None,
                               words)["flows"]))
        del single
    clock = ManualClock()
    bank = ChipBreakerBank(recovery_timeout=1.0, failure_threshold=1,
                           clock=clock)
    router = ChipFailoverRouter(mesh.make_mesh(*RESHARD_SHAPE), pols[0],
                                bank=bank, collect_telemetry=True)
    for _ in range(2):
        router.publish(pols[0])
    router.attach_datapath(host)
    torch.cuda.synchronize()
    phase("reshard_setup", t, mesh=RESHARD_SHAPE, tuples=RESHARD_TUPLES,
          compile_s=round(compile_s, 3), ordinals=router.ordinals.tolist(),
          policy_full_bytes=tables_nbytes_of(router.store),
          datapath_full_bytes=router.dp_store.full_bytes())
    return dict(router=router, clock=clock, fc=fc, pols=pols, dhosts=dhosts,
                refs=refs, cols=cols, fcols=dp_host_cols(words))


def tables_nbytes_of(store) -> int:
    """The host bytes of a DeviceTableStore's live epoch (its layout)."""
    return int(store._slots[store._cur]["nbytes"])


def reshard_check(kernels, r, ref, tag: str, stats: list) -> dict:
    """One checked dispatch of each plane: router.dispatch of the tuples
    against LATTICE's verdicts, counters and telemetry, dispatch_flows of
    the flows against DATAPATH_STEP's; the differing entries must be 0."""
    router = r["router"]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = router.dispatch(**r["cols"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    dres = router.dispatch_flows(**r["fcols"])
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    rec = dict(tag=tag, policy_ms=round((t2 - t1) * 1e3, 3),
               datapath_ms=round((t3 - t2) * 1e3, 3),
               policy_differing=fail_ref_err(res, ref[0]),
               datapath_differing=sum(dp_result_err(dres, ref[1]).values()),
               replica_hits=[res.replica_hits, dres.replica_hits],
               tp=router.tp)
    stats.append(rec)
    if rec["policy_differing"] or rec["datapath_differing"] or (
            res.degraded or dres.degraded):
        raise SystemExit(f"reshard {tag}: a checked dispatch differs from "
                         f"LATTICE or DATAPATH_STEP: {rec}")
    return rec


def moved_bytes(pol, dtables) -> int:
    """Bytes of the rows a grow from RESHARD_SHAPE moves: both stores'
    moved rows (partition.reshard_moved_rows and
    datapath_reshard_moved_rows) times their row bytes."""
    from cilium_tpu_torch.compiler import partition

    total = 0
    src, dst = RESHARD_SHAPE[1], RESHARD_GROW_TP
    sets = [(pol, name, axis, idx) for name, (axis, idx) in
            partition.reshard_moved_rows(pol, src, dst).items()]
    sets += [(getattr(dtables, fam), name, axis, idx)
             for (fam, name), (axis, idx) in
             partition.datapath_reshard_moved_rows(dtables, src,
                                                   dst).items()]
    for obj, name, axis, idx in sets:
        leaf = np.asarray(getattr(obj, name))
        total += int(idx.size) * (leaf.nbytes // leaf.shape[axis])
    return total


def relayout_hold(kernels, store, plan) -> dict:
    """REPAIR_SCATTER against its plain version on the relayout segments
    of the grow's whole datapath queue (every moved row of the staged
    target epoch, each leaf's rows on each block), on copies of the
    staged blocks; timed beside the plain version and index_copy_."""
    from cilium_tpu_torch.engine import datapath_mesh as dm
    from cilium_tpu_torch.engine.publish import repair_segments_plain

    sets = {}
    for it in plan._pending:
        if it["plane"] == "datapath":
            prev = sets.get(it["key"])
            sets[it["key"]] = (it["axis"], it["idx"] if prev is None else
                               np.concatenate([prev[1], it["idx"]]))
    slot = store._slots[store._cur ^ 1]
    aug = slot["host"]
    payloads = [(fam, name, axis, idx, np.take(np.asarray(getattr(getattr(
        aug, fam), name)), idx, axis=axis)) for (fam, name), (axis, idx)
        in sorted(sets.items())]
    segs = [s for v in dm.segments(slot["dev"], payloads).values() for s in v]

    def copies():
        return [(d.clone(), a, i, v) for d, a, i, v in segs]

    def kernel(segments):
        for k in range(0, len(segments), kernels.MAX_SCATTER_SEGMENTS):
            kernels.REPAIR_SCATTER(
                segments[k:k + kernels.MAX_SCATTER_SEGMENTS])

    got, want = copies(), copies()
    kernel(got)
    repair_segments_plain(want)
    err = max(entries_differ(a[0], b[0]) for a, b in zip(got, want))
    tm = scatter_times(lambda: kernel(got), lambda: [
        d.index_copy_(a, i, v) for d, a, i, v in want])
    plain_ms = event_ms(lambda: repair_segments_plain(want), 3)
    need = sum(nbytes(i) + 2 * nbytes(v) for _, _, i, v in segs)
    del got, want
    return dict(segments=len(segs), rows=sum(int(i.numel())
                                             for _, _, i, _ in segs),
                ms=tm["device_ms"], library_ms=tm["library_device_ms"],
                **tm, plain_ms=plain_ms,
                bound_ms=need / HBM_BYTES_PER_S * 1e3, max_abs_err=err,
                geometry=scatter_geometry(segs, "repair"),
                ab=scatter_ab(kernels, "relayout", "repair", segs))


def reshard_launch_calls(kernels, r) -> dict:
    """The reshard path's ROUTED_PROBE, MESH_COMBINE and DP_MESH_COMBINE
    calls at their own shape, built as the router's dispatch builds them
    from its live epochs after the shrink: batch row 0 of the
    RESHARD_TUPLES tuples and flows on its (2, 2) mesh, every chip
    alive, shard (0, 0).  {name: (call, tuples)}."""
    from cilium_tpu_torch.engine import datapath_mesh as dm
    from cilium_tpu_torch.engine import sharded as sh
    from cilium_tpu_torch.engine.verdict import TupleBatch

    router = r["router"]
    dp_, tp = router.mesh.devices.shape
    dev = router.mesh.devices[0, 0]
    mt, g = router.store.current()[1], router._ev.geom
    n = RESHARD_TUPLES // dp_
    batch = TupleBatch.from_numpy(**r["cols"], device=dev)
    bl = sh.shard_batch(router.mesh, batch).on(0, dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    alive = torch.ones(tp, dtype=torch.bool, device=dev)
    parts = [kernels.ROUTED_PROBE(mt.shard(0, k), bl, g, k, alive)
             for k in range(tp)]
    md, dg = router.dp_store.current(), router._dp_ev.geom
    flows = router._flow_batch(r["fcols"])[:, :n].contiguous()
    prev = None
    for rnd in range(4):
        prev = [kernels.DP_MESH_PROBE(rnd, md.shard(0, k), flows,
                                      dm.FORM_WORDS, prev, alive, k, dg)
                for k in range(tp)]
    tab0 = mt.shard(0, 0)
    return {
        kernels.ROUTED_PROBE.name: (
            lambda: kernels.ROUTED_PROBE(tab0, bl, g, 0, alive), n,
            dict(kind="routed", tab=tab0, bl=bl, g=g, alive=alive)),
        kernels.MESH_COMBINE.name: (
            lambda: kernels.MESH_COMBINE(parts, tab0, bl, g, valid, True), n,
            dict(kind="combine", tab=tab0, parts=parts, bl=bl, g=g,
                 valid=valid)),
        kernels.DP_MESH_COMBINE.name: (
            lambda: kernels.DP_MESH_COMBINE(prev, md.shard(0, 0), flows,
                                            dm.FORM_WORDS, dg, valid, None,
                                            True), n,
            dict(kind="dp", tab=md.shard(0, 0), parts=prev, flows=flows,
                 g=dg)),
    }


def reshard_launch_timing(kernels, r) -> dict:
    """The reshard path's mesh launches at their own shape
    (reshard_launch_calls), each timed: device ms over 20 calls queued
    behind a spin and CUDA events over 20 calls; ROUTED_PROBE's bound at
    that shape (routed_need); MESH_COMBINE's (mesh_combine_times) and
    DP_MESH_COMBINE's (combine_times) zero fill's share and bounds; each
    beside the parent's (--ab-parent).  Launches not counted."""
    launches = [k.launches for k in kernels.KERNELS]
    out = {}
    for name, (fn, n, aux) in reshard_launch_calls(kernels, r).items():
        out[name] = dict(device_ms=spun_ms(queued_ms, fn, "reshard timing"),
                         events_ms=event_ms(fn, 20), tuples=n)
        if aux["kind"] == "routed":
            need = routed_need(aux["tab"], aux["bl"], aux["g"], 0,
                               aux["alive"])
            out[name].update(bytes=need,
                             bound_ms=need / HBM_BYTES_PER_S * 1e3)
        elif aux["kind"] == "combine":
            out[name].update(mesh_combine_times(
                kernels, fn, aux["parts"], aux["tab"], aux["bl"], aux["g"],
                aux["valid"], "reshard combine"))
        else:
            out[name].update(combine_times(
                kernels, fn, aux["tab"], aux["parts"], aux["flows"],
                aux["g"], "reshard combine"))
        ab = library_ab(kernels, "mesh" if aux["kind"] != "dp" else
                        "datapath_mesh", {f"reshard_{name}": fn})
        if ab is not None:
            out[name]["ab"] = ab["medians"]
    for k, n in zip(kernels.KERNELS, launches):
        k.launches = n
    print("  reshard_launch_timing " + json.dumps(out), flush=True)
    return out


def reshard_phase(kernels, w, host, tables, rows) -> None:
    """reshard: the router's stores on the virtual (2, 2) mesh grown to
    (2, 4) and shrunk back through ReshardPlan (counts set to 0 just
    before and read just after), a checked dispatch of both planes at
    every step; during the grow a chip of a new column dies at the
    reshard.migrate seam (the plan completes from the replicas) and a
    churn publish of both planes lands (dual-applied); REPAIR_SCATTER
    against its plain version on the relayout segments."""
    from cilium_tpu_torch import faultinject
    from cilium_tpu_torch.compiler import partition
    from cilium_tpu_torch.engine import reshard
    from cilium_tpu_torch.metrics import registry as metrics

    r = reshard_setup(kernels, w, host, tables)
    router = r["router"]
    checks = []
    t = time.perf_counter()
    reset_counts(kernels)
    reshard_check(kernels, r, r["refs"][0], "before", checks)
    path = dp_counts(kernels)
    moved = moved_bytes(r["pols"][0], r["dhosts"][0])
    step_bytes = max(moved // RESHARD_STEPS, 1)
    legs, ref = [], r["refs"][0]
    for tp, dtables in ((RESHARD_GROW_TP, r["dhosts"][0]),
                        (RESHARD_SHAPE[1], r["dhosts"][1])):
        plan = reshard.ReshardPlan(
            router, reshard.reshard_target_mesh(router, tp),
            step_bytes=step_bytes, on_fault="complete", dtables=dtables)
        plan.begin()
        grow = tp == RESHARD_GROW_TP
        if grow:
            hold = relayout_hold(kernels, router.dp_store, plan)
            victim = plan._target_ordinals_of_col(RESHARD_SHAPE[1])[0]
            faultinject.arm("reshard.migrate", f"raise:chip={victim}")
        reset_counts(kernels)
        pol_bytes0 = metrics.rebalance_bytes_h2d_total.get()
        step_ms = []
        while plan.pending():
            t1 = time.perf_counter()
            plan.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            if grow and plan.stats["steps"] == RESHARD_CHURN_AT:
                # the churn publish: a policy delta against the live
                # epoch and a datapath churn step, then the staged fold
                pol2, dh2 = r["pols"][1], r["dhosts"][1]
                delta = r["fc"].delta_for(router.store.current_stamp(), pol2)
                _, st = router.publish(pol2, delta)
                _, dst = router.publish_datapath(dh2)
                plan.on_publish(pol2, dtables=dh2)
                ref = r["refs"][1]
                if st.mode != "delta" or dst.mode != "delta" or (
                        router.store.relayout_state()["broken"]):
                    raise SystemExit(f"reshard: the churn publish took "
                                     f"{st.mode}/{dst.mode}")
            reshard_check(kernels, r, ref, f"tp{tp} step "
                          f"{plan.stats['steps']}", checks)
        faultinject.disarm_all()
        full = {"policy": tables_nbytes_of(router.store),
                "datapath": router.dp_store.full_bytes()}
        t1 = time.perf_counter()
        out = plan.cutover()
        torch.cuda.synchronize()
        cut_ms = (time.perf_counter() - t1) * 1e3
        pol_bytes = metrics.rebalance_bytes_h2d_total.get() - pol_bytes0
        after = reshard_check(kernels, r, ref, f"tp{tp} after", checks)
        for k, v in dp_counts(kernels).items():
            path[k] = path.get(k, 0) + v
        leg = dict(tp=f"{RESHARD_SHAPE[1]}->{tp}" if grow
                   else f"{RESHARD_GROW_TP}->{tp}",
                   outcome=out["outcome"], steps=out["steps"],
                   restarts=out["restarts"], dead_cols=out["dead_cols"],
                   bytes_h2d={"policy": int(pol_bytes),
                              "datapath": int(out["bytes_h2d"] - pol_bytes)},
                   source_full_bytes=full, step_bytes=step_bytes,
                   step_ms=[round(x, 3) for x in step_ms],
                   cutover_ms=round(cut_ms, 3), plan_ms=round(out["ms"], 3),
                   ordinals=router.ordinals.tolist(),
                   target_full_bytes={
                       "policy": tables_nbytes_of(router.store),
                       "datapath": router.dp_store.full_bytes()},
                   replica_hits_after=after["replica_hits"])
        legs.append(leg)
        phase("reshard_leg", t1, **{k: json.dumps(v) if isinstance(
            v, (dict, list)) else v for k, v in leg.items()})
        if (out["outcome"] != "cutover" or out["restarts"]
                or out["steps"] < 2 or router.tp != tp):
            raise SystemExit(f"reshard {leg['tp']}: {out}")
    during = [c for c in checks if c["tag"] not in ("before",)
              and not c["tag"].endswith("after")]
    disp = {k: dict(policy_ms=round(float(np.median([c["policy_ms"]
                                                     for c in v])), 3),
                    datapath_ms=round(float(np.median([c["datapath_ms"]
                                                       for c in v])), 3))
            for k, v in (("before", checks[:1]), ("during", during),
                         ("after", [checks[-1]]))}
    differing = [c["policy_differing"] + c["datapath_differing"]
                 for c in checks]
    phase("reshard", t, launches=json.dumps(path), legs=len(legs),
          checks=len(checks), differing_per_check=json.dumps(differing),
          dispatch_ms=json.dumps(disp), grow_dead_cols=legs[0]["dead_cols"],
          relayout_repair=json.dumps(hold),
          ordinals=json.dumps([leg["ordinals"] for leg in legs]))
    need = (kernels.REPAIR_SCATTER, kernels.PUBLISH_SCATTER,
            kernels.ROUTED_PROBE, kernels.MESH_COMBINE,
            kernels.DP_MESH_PROBE, kernels.DP_MESH_COMBINE)
    if (any(differing) or hold["max_abs_err"]
            or any(not path.get(k.name) for k in need)
            or legs[0]["dead_cols"] != [RESHARD_SHAPE[1]]
            or legs[0]["ordinals"] != [[0, 1, 4, 5], [2, 3, 6, 7]]
            or legs[1]["ordinals"] != [[0, 1], [2, 3]]):
        raise SystemExit(f"reshard: {path}, relayout {hold}")
    timed = reshard_launch_timing(kernels, r)
    for row in rows:
        n = path.get(row["name"], 0)
        if n:
            row.setdefault("launches_by_path", {"earlier": row["launches"]})
            row["launches_by_path"]["reshard"] = n
            row["launches"] += n
        if row["name"] in timed:
            row["reshard_launch"] = timed[row["name"]]
        if row["name"] == kernels.REPAIR_SCATTER.name:
            row["relayout"] = hold
            row["max_abs_err"] = max(row["max_abs_err"], hold["max_abs_err"])
    print("  reshard " + json.dumps({"legs": legs, "dispatch_ms": disp}),
          flush=True)


def lookup_reshard_alone() -> None:
    """hash_lookup, ipcache_lookup and reshard alone (the lookup kernels,
    the mesh, datapath-mesh and publish libraries built first) on config
    5's world and the node world: `python3 -c "import chip_smoke;
    chip_smoke.lookup_reshard_alone()"` on one H100."""
    from cilium_tpu_torch import kernels, world
    from cilium_tpu_torch.convert import tables_to

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    t = time.perf_counter()
    kernels.build_all(("lookup", "mesh", "datapath_mesh", "publish",
                       "datapath", "lattice"))
    phase("build", t, card=repr(nvidia_smi()))
    w = world.make_world(seed=5)
    host = world.headline_tables(w, w.host_tables())
    tables = tables_to(host, "cuda")
    nw = node_world_phase(kernels, "node")
    rows = [kernel_row(k, "", "", 0, 0, 0.0, 0.0, 0.0, 0.0)
            for k in (kernels.REPAIR_SCATTER,)]
    hash_lookup_phase(kernels, rows)
    ipcache_lookup_phase(kernels, w, host, (nw["w"], nw["host"]), rows)
    del nw
    torch.cuda.empty_cache()
    reshard_phase(kernels, w, host, tables, rows)
    print(json.dumps({"kernels": rows}), flush=True)


def scatter_alone(parent=None) -> None:
    """The four sites of PUBLISH_SCATTER and REPAIR_SCATTER alone on
    config 5's world (every kernel built first): publish, the mesh and
    its failover phases (the readmission), dp_mesh_setup and
    dp_mesh_store (the churn delta's scatter), reshard (the relayout);
    with `parent` (a `git archive` of the parent commit) each site's
    scatter_ab too: `python3 -c "import chip_smoke;
    chip_smoke.scatter_alone('PARENT_DIR')"` on one H100."""
    from cilium_tpu_torch import kernels, world
    from cilium_tpu_torch.convert import tables_to

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = nvidia_smi()
    t = time.perf_counter()
    ab_jobs = ab_start(kernels, parent) if parent else None
    for stem, (_, log) in kernels.build_all(verbose=True).items():
        for line in log.splitlines():
            if stem == "publish" and ("registers" in line or "spill" in line
                                      or "Compiling entry" in line):
                print(f"  ptxas {stem}:", line.strip(), flush=True)
    for k in kernels.KERNELS:
        k.load()
    phase("build", t, card=repr(smi))
    if ab_jobs:
        ab_load(kernels, ab_jobs)
    w = world.make_world(seed=5)
    host = world.headline_tables(w, w.host_tables())
    tables = tables_to(host, "cuda")
    rows = [kernel_row(k, "", "", 0, 0, 0.0, 0.0, 0.0, 0.0)
            for k in kernels.KERNELS]
    publish_phases(kernels, w, rows)
    torch.cuda.empty_cache()
    u = mesh_setup(w)
    failover_phases(kernels, w, u, rows, smi)
    del u
    torch.cuda.empty_cache()
    st = dp_mesh_store(kernels, w, dp_mesh_setup(kernels, w, host, tables))
    del st["tables"], st["host"]
    torch.cuda.empty_cache()
    reshard_phase(kernels, w, host, tables, rows)
    scatter_ab_phase()
    mine = [r for r in rows if r["name"] in (
        "publish_scatter", "repair_scatter") and r["source"]]
    for r in mine:
        if r["name"] == "repair_scatter":
            r["datapath_delta"] = st["scatter"]
    print(json.dumps({"kernels": mine}), flush=True)


def main(argv=()) -> int:
    """`--ab-parent DIR`: also time the parent commit's csrc/ libraries
    of AB_STEMS, from DIR (a `git archive` of it), beside this one's
    (scatter_ab, churn_timing, pair_ab, library_ab)."""
    parent = None
    if argv:
        if len(argv) != 2 or argv[0] != "--ab-parent":
            print("usage: chip_smoke.py [--ab-parent DIR]", file=sys.stderr)
            return 2
        parent = argv[1]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    from cilium_tpu_torch import kernels, world
    from cilium_tpu_torch.compiler.tables import repack_l4_subword, split_hot
    from cilium_tpu_torch.convert import tables_to
    from cilium_tpu_torch.ct.device import compact_ct_snapshot
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import verdict
    from cilium_tpu_torch.ipcache.lpm import subword_ipcache

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    phase("device", t0, kind=repr(kind), count=count, smi=repr(smi),
          torch=torch.__version__, cuda=torch.version.cuda)

    # -- kernel build: one nvcc per library, started together (ptxas
    # registers and spills per kernel), the parent's beside them
    t = time.perf_counter()
    ab_jobs = ab_start(kernels, parent) if parent else None
    for stem, (_, log) in kernels.build_all(verbose=True).items():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or (
                "spill" in line
            ):
                print(f"  ptxas {stem}:", line.strip(), flush=True)
        if stem == "datapath":
            PAIR_PTXAS.update(pair_ptxas(kernels, log))
            STEP_PTXAS.update(pair_ptxas(kernels, log,
                                         "datapath_step_kernel"))
            MEMO_FRONT_PTXAS.update(pair_ptxas(
                kernels, log, "datapath_memo_front_kernel"))
            MEMO_BACK_PTXAS.update(pair_ptxas(
                kernels, log, "datapath_pair_memo_back_kernel"))
        if stem == "lattice":
            LATTICE_PTXAS.update(lattice_ptxas(kernels, log))
        if stem == "memo":
            DEDUP_PTXAS.update(pair_ptxas(kernels, log, "dedup_kernel"))
            CACHE_PTXAS.update(pair_ptxas(kernels, log, "cache_kernel"))
        if stem == "mesh":
            ROUTED_PTXAS.update(pair_ptxas(kernels, log,
                                           "routed_probe_kernel"))
            MESH_PTXAS.update(
                combine=pair_ptxas(kernels, log, "mesh_combine_kernel"),
                memo={p: pair_ptxas(kernels, log, f"memo_{p}_kernel")
                      for p in ("front", "back")})
        if stem == "datapath6":
            D6_PTXAS.update(pair_ptxas(kernels, log, "datapath6_kernel"))
        if stem == "datapath_mesh":
            COMBINE_PTXAS.update(pair_ptxas(kernels, log,
                                            "dp_mesh_combine_kernel"))
    for k in kernels.KERNELS:
        k.load()
    phase("build", t)
    if ab_jobs:
        ab_load(kernels, ab_jobs)

    # -- config-5 world, headline layouts, onto the card
    t = time.perf_counter()
    w = world.make_world(seed=5)
    wide = w.host_tables()
    fleet = world.l7_fleet(w, wide.policy)
    host = world.headline_tables(w, wide)
    # the wide layouts (3-word L4, 5-word CT, u32 ipcache planes), hot
    # plane only: the churn loop's tables
    wide_t = tables_to(
        dataclasses.replace(wide, policy=split_hot(wide.policy)), "cuda")
    # the wide compile's policy with its cold planes, for dense_check
    dense_pol_host = wide.policy
    del wide
    tables = tables_to(host, "cuda")
    total = 0
    for name, v in table_leaves(tables):
        nbytes = v.numel() * v.element_size()
        total += nbytes
        print(f"  table {name} {tuple(v.shape)} {nbytes} B", flush=True)
    phase("world", t, **w.meta, table_bytes=total,
          http_rules=fleet.http.tables.n_rules, kafka_rules=fleet.kafka.n_rules)

    # -- kernel vs plain: one full-width pair, exact
    t = time.perf_counter()
    full = w.pairs(seed=41, half=HALF, k=1)
    err_full = check_pairs(tables, full, kernels, dp, verdict)
    phase("kernel_vs_plain_full", t, half=HALF, max_abs_err=err_full)
    if err_full != 0:
        raise SystemExit("kernel differs from the plain version (full pair)")
    # small worlds: 16-bit ipcache values, Zipf pairs; and narrow rows
    # that spill into the CT and L4 stashes
    t = time.perf_counter()
    small = world.make_world(
        seed=1, n_rules=400, n_endpoints=4, n_identities=512,
        n_cidr_blocks=16, n_vips=4, n_pool=3000, ct_max_entries=4096,
        identity_pad=256, filter_pad=16,
    )
    sh = world.headline_tables(small)
    err_small = check_pairs(
        tables_to(sh, "cuda"), small.pairs(seed=3, half=50_000, k=2, zipf=1.2),
        kernels, dp, verdict,
    )
    wide = small.host_tables()
    narrow = dp.DatapathTables(
        prefilter=wide.prefilter,
        ipcache=subword_ipcache(wide.ipcache),
        ct=compact_ct_snapshot(wide.ct, lanes=12),
        lb=wide.lb,
        policy=split_hot(repack_l4_subword(wide.policy, lanes=4)),
    )
    stash_rows = (int(narrow.ct.stash.shape[0]),
                  int(narrow.policy.l4_hash_stash.shape[0]))
    err_stash = check_pairs(
        tables_to(narrow, "cuda"), small.pairs(seed=4, half=50_000, k=2),
        kernels, dp, verdict,
    )
    phase("kernel_vs_plain_small", t, max_abs_err=err_small,
          stash_world_err=err_stash, ct_l4_stash_rows=stash_rows,
          value_width=sh.ipcache.value_width)
    if err_small or err_stash:
        raise SystemExit("kernel differs from the plain version (small worlds)")
    layouts_check(kernels, dp, verdict)

    # -- timings at the full width (scratch carries; launches not counted)
    t = time.perf_counter()
    pair_dev = torch.from_numpy(full[0].view(np.int32)).cuda()
    acc_s = verdict.make_counter_buffers(tables.policy)
    tel_s = verdict.make_telemetry_buffers(acc_s.device)
    kernel_ms = event_ms(
        lambda: kernels.DATAPATH_PAIR(tables, pair_dev, acc_s, tel_s), 20
    )
    plain_ms = event_ms(
        lambda: dp.datapath_pair_plain(tables, pair_dev, acc_s, tel_s), 3
    )
    phase("timing", t, kernel_ms=round(kernel_ms, 4),
          plain_ms=round(plain_ms, 4))

    # -- PERSISTENT_PAIR against its plain version, the dispatcher's counts
    pchk = persistent_check(kernels, w, tables)

    # -- the main path: the persistent pair dispatcher (PERSISTENT_PAIR,
    # one copy and one launch per K pairs)
    pairs = w.pairs(seed=42, half=HALF, k=N_PAIRS)
    acc = verdict.make_counter_buffers(tables.policy)
    tel = verdict.make_telemetry_buffers(acc.device)
    disp = dp.PersistentPairDispatcher(tables, PERSIST_K, acc, tel)
    torch.cuda.synchronize()
    reset_counts(kernels)
    t = time.perf_counter()
    results = []
    for p in pairs:
        results.extend(disp.submit(p))
    rem, acc, tel = disp.flush()
    results.extend(rem)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = kernels.PERSISTENT_PAIR.launches
    pair_launches = kernels.DATAPATH_PAIR.launches
    others = {k.name: k.launches for k in kernels.KERNELS
              if k.launches and k is not kernels.PERSISTENT_PAIR}
    flows = N_PAIRS * 2 * HALF
    phase("main_path", t, pairs=N_PAIRS, k=PERSIST_K,
          persistent_pair_launches=launches,
          datapath_pair_launches=pair_launches,
          super_launches=disp.launches, verdicts_per_s=round(flows / wall))
    if (launches != N_PAIRS // PERSIST_K or len(results) != N_PAIRS
            or others):
        raise SystemExit(f"{launches} PERSISTENT_PAIR launches for {N_PAIRS} "
                         f"pairs at K = {PERSIST_K}, others {others}")
    telem = (tel.cpu().to(torch.int64) & 0xFFFFFFFF).sum(dim=0).tolist()
    print("  telemetry", json.dumps(dict(zip(verdict.TELEM_NAMES, telem))),
          flush=True)
    silent = [
        name for name, v in zip(verdict.TELEM_NAMES, telem)
        if v == 0 and name != "ct_related"
    ]
    if silent or telem[verdict.TELEM_TOTAL] != flows:
        raise SystemExit(f"telemetry columns never counted: {silent}")
    # the main path's outputs against the plain version of the same pairs
    t = time.perf_counter()
    acc_p = verdict.make_counter_buffers(tables.policy)
    tel_p = verdict.make_telemetry_buffers(acc_p.device)
    err_main = 0
    for p, got in zip(pairs, results):
        pt = torch.from_numpy(p.view(np.int32)).cuda()
        pi, pe, acc_p, tel_p = dp.datapath_pair_plain(tables, pt, acc_p, tel_p)
        err_main = max(err_main, compare(got, (pi, pe), dp))
    torch.cuda.synchronize()
    err_main = max(err_main, buf_err(acc, acc_p), buf_err(tel, tel_p))
    phase("main_path_vs_plain", t, max_abs_err=err_main)
    if err_main:
        raise SystemExit("main path differs from the plain version")

    # -- where the main path's time goes: one traced run of the same loop
    t = time.perf_counter()
    acc_t = verdict.make_counter_buffers(tables.policy)
    tel_t = verdict.make_telemetry_buffers(acc_t.device)
    disp_t = dp.PersistentPairDispatcher(tables, PERSIST_K, acc_t, tel_t)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        for p in pairs:
            disp_t.submit(p)
        disp_t.flush()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t1) * 1e3
    busy = device_busy(prof)
    busy_ms = sum(busy.values())
    copies = h2d_copies(prof)
    for key, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  device {ms:.3f} ms  {key[:90]}", flush=True)
    phase("main_path_trace", t, wall_ms=round(traced_ms, 3),
          device_busy_ms=round(busy_ms, 3),
          device_idle_share=round(1 - busy_ms / traced_ms, 4),
          super_launches=disp_t.launches, h2d_copies=copies,
          h2d_copies_per_super_batch=copies / max(disp_t.launches, 1))
    if copies != disp_t.launches:
        raise SystemExit(f"main_path_trace: {copies} host-to-device copies "
                         f"for {disp_t.launches} super-batches")

    # -- the bound: what the timed pair's data needs moved (see
    # needed_bytes), or its operations, whichever takes longer
    b2 = 2 * HALF
    bytes_moved, gathered_per_flow = needed_bytes(
        tables, pair_dev, dp, verdict, kernels
    )
    # integer operations the flows need, counted low (flow_ops)
    per_flow_ops, egress_ops = flow_ops(tables)
    ops = per_flow_ops * b2 + egress_ops * HALF
    bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops / OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    phase("bound", time.perf_counter(), bytes=bytes_moved, ops=ops,
          bound_bytes_ms=round(bound_bytes_ms, 4),
          bound_ops_ms=round(bound_ops_ms, 4),
          row_bytes_per_flow=round(gathered_per_flow, 2),
          kernel_ms_per_pair=round(kernel_ms, 4),
          kernel_verdicts_per_s=round(b2 / (kernel_ms / 1e3)))

    # -- PERSISTENT_PAIR per super-batch beside 4 x DATAPATH_PAIR
    ptim = persistent_timing(kernels, tables, pairs)

    # -- the pair kernel on the wide layouts: one full pair, exact
    t = time.perf_counter()
    err_wide = check_pairs(wide_t, full, kernels, dp, verdict)
    phase("wide_pair_check", t, half=HALF, max_abs_err=err_wide,
          ct_entry_words=wide_t.ct.entry_words,
          l4_entry_words=int(wide_t.policy.l4_hash_stash.shape[1]),
          ipcache_value_width=wide_t.ipcache.value_width)
    if err_wide != 0:
        raise SystemExit("kernel differs from the plain version (wide pair)")

    rows = [kernel_row(
        kernels.DATAPATH_PAIR, "cilium_tpu_torch/csrc/datapath.cu",
        "cilium_tpu/engine/datapath.py:801", pair_launches,
        max(err_full, err_small, err_stash, err_wide), kernel_ms,
        plain_ms, bound_bytes_ms, bound_ops_ms,
    ), kernel_row(
        kernels.PERSISTENT_PAIR, "cilium_tpu_torch/csrc/datapath.cu",
        "cilium_tpu/engine/datapath.py:922", launches,
        max(pchk["err"], err_main), ptim["ms"], ptim["plain_ms"], ptim["bb"],
        ptim["bo"],
    )]
    rows[1].update(datapath_pair_x4_ms=ptim["pair_ms"],
                   device_ms=ptim["device_ms"], design=ptim["design"],
                   stash_rows=ptim["stash_rows"], ptxas=PAIR_PTXAS)
    if ptim["ab"] is not None:
        med = ptim["ab"]["medians"]
        for r, key in ((rows[0], "datapath_pair"),
                       (rows[1], "persistent_pair")):
            r["ab"] = dict(differing=ptim["ab"]["differing"][key], **{
                f"{who}_{m}": med[f"{who}_{key}_{m}"]
                for who in ("parent", "new") for m in ("ms", "device_ms")})
    # DATAPATH_PAIR's launches by path: the main path's (the dispatcher's
    # remainder, none at K = 4 over 8 pairs), persistent_check's dispatcher
    # remainder, and the node and combined paths below
    rows[0]["launches_by_path"] = {
        "main": pair_launches,
        "persistent_check": pchk["launches"][kernels.DATAPATH_PAIR.name]}
    rows[1]["launches_by_path"] = {
        "main": launches,
        "persistent_check": pchk["launches"][kernels.PERSISTENT_PAIR.name]}
    for r in rows[:2]:
        r["launches"] = sum(r["launches_by_path"].values())
    del pairs, results, full, disp, disp_t
    torch.cuda.empty_cache()

    # -- the churn loop: checks, bench's passes, trace, kernel timings
    chk = churn_check(kernels, w, wide_t)
    run = churn_phase(kernels, w, wide_t)
    churn_trace(wide_t, run)
    rows.extend(churn_timing(kernels, wide_t, chk, run["counts"]))
    rows.append(prng_check(kernels, w, run["counts"]))
    del chk, run
    torch.cuda.empty_cache()

    rows.append(l7_http_phase(kernels))
    rows.append(l7_kafka_phase(kernels))
    rows.append(proxy_phases(kernels, rows[-2], rows[-1]))
    fleet_row, combined_pairs = combined_phase(kernels, w, tables, fleet)
    rows.append(fleet_row)
    rows[0]["launches_by_path"]["combined"] = combined_pairs
    rows[0]["launches"] += combined_pairs
    rows.extend(lattice_phases(kernels, w, tables, wide_t))
    torch.cuda.empty_cache()
    config6_phases(kernels, w, tables, wide_t, rows)
    torch.cuda.empty_cache()
    replay_phases(kernels, w, tables, wide_t, rows)
    flow_capture(kernels, w, tables)
    torch.cuda.empty_cache()
    node = node_phases(kernels, w, tables, wide_t, rows)
    torch.cuda.empty_cache()
    pub = publish_phases(kernels, w, rows)
    torch.cuda.empty_cache()
    rules_phases(kernels, rows)
    torch.cuda.empty_cache()
    memo_phases(kernels, w, tables, rows, pub)
    del pub
    torch.cuda.empty_cache()
    dense = dense_check(kernels, tables, dense_pol_host, w)
    rows[0].update(dense_ms=dense["ms"], dense_plain_ms=dense["plain_ms"],
                   dense_bound_ms=dense["bound_ms"],
                   dense_max_abs_err=dense["err"],
                   dense_hashed_ms=dense["hashed_ms"])
    del dense_pol_host
    torch.cuda.empty_cache()
    mesh_phases(kernels, w, rows, smi)
    torch.cuda.empty_cache()
    dp_mesh_phases(kernels, w, host, tables, node, rows, smi)
    torch.cuda.empty_cache()
    hash_lookup_phase(kernels, rows)
    ipcache_lookup_phase(kernels, w, host, node, rows)
    del node
    torch.cuda.empty_cache()
    reshard_phase(kernels, w, host, tables, rows)
    scatter_ab_phase()

    if len(rows) != len(kernels.KERNELS):
        raise SystemExit(f"{len(rows)} kernel rows for "
                         f"{len(kernels.KERNELS)} kernels")
    print("[library] library_ms is null except for ct_delta "
          "(index_copy_ of the delta's rows; device ms queued behind a "
          "spin, as its ms, the CUDA events beside), memo_dedup (torch.unique of the key rows with the "
          "inverse), publish_scatter (one index_put_ per leaf on in-range "
          "payloads: a time only; device ms queued behind a spin, as its "
          "ms) and pick_draw (torch.randint on the same shape: "
          "other numbers, so a time only): no single PyTorch call computes "
          "the fused datapath steps (v4 or v6), the intent compaction, a "
          "DFA scan, the Kafka rule match, the fleet's routed match, the "
          "policy lattice, the two dependent DIR-24-8 reads, the verdict "
          "cache, the memo's key words, the memcached rule match, the "
          "shadow diff's four columns, or the mesh's shard probes and "
          "their combine, or the memo's probe, combine and insert on the "
          "mesh, or the fused datapath's rounds and combine on the mesh, "
          "or the windowed hash-table lookup with its stash, or the "
          "bucketized ipcache lookup; "
          "repair_scatter's is index_copy_ along the repaired axis "
          "(a time only; device ms queued behind a spin, as its ms)",
          flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
