"""The hand-written CUDA kernel against its plain PyTorch version, on the
card.  Needs an NVIDIA GPU and nvcc: without them the test skips, and
the decision is made inside the test (never at import), so every
xdist worker collects the same tests.  On the card:

    python -m pytest --noconftest tests/test_torch_kernel.py -q -m cuda
"""

import os
import shutil

import numpy as np
import pytest
import torch


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if shutil.which("nvcc") is None and not os.path.exists(
        "/usr/local/cuda/bin/nvcc"
    ):
        pytest.skip("no nvcc to build the kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("zipf", [None, 1.2])
def test_kernel_matches_plain_version(zipf):
    _need_card()
    from cilium_tpu_torch import kernels, world
    from cilium_tpu_torch.convert import tables_to
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import verdict

    w = world.make_world(
        seed=2, n_rules=400, n_endpoints=4, n_identities=512,
        n_cidr_blocks=16, n_vips=4, n_pool=3000, ct_max_entries=4096,
        identity_pad=256, filter_pad=16,
    )
    tables = tables_to(world.headline_tables(w), "cuda")
    acc_k = verdict.make_counter_buffers(tables.policy)
    tel_k = verdict.make_telemetry_buffers("cuda")
    acc_p, tel_p = acc_k.clone(), tel_k.clone()
    before = kernels.DATAPATH_PAIR.launches
    for p in w.pairs(seed=9, half=20_000, k=3, zipf=zipf):
        pt = torch.from_numpy(p.view(np.int32)).cuda()
        ki, ke, acc_k, tel_k = kernels.DATAPATH_PAIR(tables, pt, acc_k, tel_k)
        pi, pe, acc_p, tel_p = dp.datapath_pair_plain(tables, pt, acc_p, tel_p)
        torch.cuda.synchronize()
        for got, want in ((ki, pi), (ke, pe)):
            for col in dp.VERDICT_COLUMNS:
                assert torch.equal(getattr(got, col), getattr(want, col)), col
    assert torch.equal(acc_k, acc_p)
    assert torch.equal(tel_k, tel_p)
    assert kernels.DATAPATH_PAIR.launches == before + 3


@pytest.mark.cuda
def test_kernel_refuses_layouts_it_does_not_implement():
    _need_card()
    import dataclasses

    from cilium_tpu_torch import kernels, world
    from cilium_tpu_torch.compiler.tables import split_hot
    from cilium_tpu_torch.convert import tables_to
    from cilium_tpu_torch.engine import verdict

    w = world.make_world(
        seed=2, n_rules=100, n_endpoints=4, n_identities=256,
        n_cidr_blocks=4, n_vips=2, n_pool=500, ct_max_entries=1024,
        identity_pad=256, filter_pad=16,
    )
    wide = w.host_tables()  # 3-word L4, 5-word CT: the kernels take them
    wide.policy = split_hot(wide.policy)
    tables = tables_to(wide, "cuda")
    acc = verdict.make_counter_buffers(tables.policy)
    tel = verdict.make_telemetry_buffers("cuda")
    pair = torch.from_numpy(w.pairs(seed=1, half=64, k=1)[0].view(np.int32))
    kernels.DATAPATH_PAIR(tables, pair.cuda(), acc, tel)
    # without range classes the kernel scans every range ([B, P]), as
    # the plain version does
    from cilium_tpu_torch.engine import datapath as dp

    no_ranges = dataclasses.replace(
        tables, ipcache=dataclasses.replace(tables.ipcache, range_rows=None))
    got = kernels.DATAPATH_PAIR(no_ranges, pair.cuda(), acc.clone(),
                                tel.clone())
    want = dp.datapath_pair_plain(no_ranges, pair.cuda(), acc.clone(),
                                  tel.clone())
    for g, p in zip(got[:2], want[:2]):
        for col in dp.VERDICT_COLUMNS:
            assert torch.equal(getattr(g, col), getattr(p, col)), col
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    # without the hashed L4 tables the kernels take the dense lattice
    # (K8's dense branch), and refuse tables without its planes
    dense_t = tables_to(dataclasses.replace(w.host_tables(), policy=(
        dataclasses.replace(w.host_tables().policy, l4_hash_rows=None,
                            l4_hash_stash=None, l4_wild_rows=None,
                            l4_wild_stash=None))), "cuda")
    got = kernels.DATAPATH_PAIR(dense_t, pair.cuda(), acc.clone(),
                                tel.clone())
    want = dp.datapath_pair_plain(dense_t, pair.cuda(), acc.clone(),
                                  tel.clone())
    for g, p in zip(got[:2], want[:2]):
        for col in dp.VERDICT_COLUMNS:
            assert torch.equal(getattr(g, col), getattr(p, col)), col
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    no_planes = dataclasses.replace(dense_t, policy=dataclasses.replace(
        dense_t.policy, l4_allow_bits=None))
    with pytest.raises(ValueError, match="dense port_slot"):
        kernels.DATAPATH_PAIR(no_planes, pair.cuda(), acc, tel)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.DATAPATH_PAIR(tables, pair, acc, tel)


@pytest.mark.cuda
@pytest.mark.parametrize("compact", [False, True])
def test_dense_datapath_matches_plain_version(compact):
    """DATAPATH_PAIR and DATAPATH_STEP on tables without the hashed L4
    tables (K8's dense branch) against their plain versions, and
    against the hashed tables' verdicts (every column but the slot,
    which the dense branch reads for every port with a slot)."""
    _need_card()
    import dataclasses

    from cilium_tpu_torch import kernels, world
    from cilium_tpu_torch.convert import tables_to
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import verdict

    w = world.make_world(
        seed=4, n_rules=400, n_endpoints=4, n_identities=512,
        n_cidr_blocks=16, n_vips=4, n_pool=3000, ct_max_entries=4096,
        identity_pad=256, filter_pad=16,
    )
    wide = w.host_tables()
    hashed = dp.subword_datapath_tables(wide) if compact else wide
    dense = dataclasses.replace(hashed, policy=dataclasses.replace(
        wide.policy, l4_hash_rows=None, l4_hash_stash=None,
        l4_wild_rows=None, l4_wild_stash=None))
    ht, dt = tables_to(hashed, "cuda"), tables_to(dense, "cuda")
    pair = torch.from_numpy(w.pairs(seed=5, half=20_000, k=1)[0].view(
        np.int32)).cuda()
    outs = {}
    for name, tab, fn in (("dense", dt, kernels.DATAPATH_PAIR),
                          ("plain", dt, dp.datapath_pair_plain),
                          ("hashed", ht, kernels.DATAPATH_PAIR)):
        acc = verdict.make_counter_buffers(tab.policy)
        tel = verdict.make_telemetry_buffers("cuda")
        outs[name] = fn(tab, pair, acc, tel)
    pairs = torch.stack([pair, pair.flip(-1)])
    got = kernels.PERSISTENT_PAIR(dt, pairs,
                                  verdict.make_counter_buffers(dt.policy),
                                  verdict.make_telemetry_buffers("cuda"))
    want = dp.persistent_pair_plain(dt, pairs,
                                    verdict.make_counter_buffers(dt.policy),
                                    verdict.make_telemetry_buffers("cuda"))
    torch.cuda.synchronize()
    for g, p in zip(got, want):
        if isinstance(g, torch.Tensor):
            assert torch.equal(g, p)
        else:
            for col in dp.VERDICT_COLUMNS:
                assert torch.equal(getattr(g, col), getattr(p, col)), col
    for other, skip in (("plain", ()), ("hashed", ("l4_slot",))):
        for g, p in zip(outs["dense"][:2], outs[other][:2]):
            for col in dp.VERDICT_COLUMNS:
                if col not in skip:
                    assert torch.equal(getattr(g, col), getattr(p, col)), (
                        other, col)
        assert torch.equal(outs["dense"][2], outs[other][2]), other
        assert torch.equal(outs["dense"][3], outs[other][3]), other
    from cilium_tpu_torch.convert import flow_pool_to

    pool = flow_pool_to(w.pool, "cuda")
    picks = torch.arange(int(pool.shape[1]), dtype=torch.int32,
                         device="cuda").flip(0)
    got = kernels.DATAPATH_STEP(dt, pool, picks)
    want = dp.datapath_step_plain(
        dt, dp.flow_batch_from_packed(pool[:, picks.long()]))
    for col in dp.VERDICT_COLUMNS:
        assert torch.equal(getattr(got, col), getattr(want, col)), col


def _routed_records_differ(m, pol, batch, alive, tp) -> int:
    """ROUTED_PROBE against routed_probe_plain on every shard of the
    CUDA mesh `m`, partitioned and in failover mode under `alive`:
    differing record entries."""
    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.compiler import partition
    from cilium_tpu_torch.convert import policy_tables_to
    from cilium_tpu_torch.engine import mesh, sharded

    differ = 0
    sb = sharded.shard_batch(m, batch)
    alive_t = torch.from_numpy(alive).cuda()
    for failover, tab in ((False, pol),
                          (True, partition.replicate_table_leaves(pol, tp))):
        specs, g = sharded._routed_geom(pol, tp, "table", failover=failover)
        placed = mesh.place_tables(policy_tables_to(tab, "cuda"),
                                   mesh.shardings_of(m, specs))
        for (b, t), dev in np.ndenumerate(m.devices):
            bl = sb.on(b, dev)
            row = alive_t[b] if failover else None
            k = kernels.ROUTED_PROBE(placed.shard(b, t), bl, g, t, row)
            p = sharded.routed_probe_plain(placed.shard(b, t), bl, g, t, row)
            differ += int((k != p).sum().item())
    return differ


@pytest.mark.cuda
@pytest.mark.parametrize("dp_,tp", [(2, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("compact", [False, True, "stash_edges", "hot"])
def test_mesh_kernels_match_plain_versions(dp_, tp, compact):
    """MESH_PROBE, ROUTED_PROBE and MESH_COMBINE through the four mesh
    evaluators on a CUDA mesh of virtual chips against the plain
    versions on a CPU mesh of the same shape: every output; each kernel
    launched once per shard (probes) or batch row (combine); and
    ROUTED_PROBE's records against its plain version's on every shard,
    partitioned and in failover mode.  "stash_edges" repacks the hashed
    tables at 4 lanes (entries spill into both stashes, which are hit)
    and puts edge words in the first 16 tuples: identities past
    id_direct's regions, negative and huge endpoints and directions,
    dports past 65,535.  "hot" takes the compact tables and a hot batch
    of the tuples (world.hot_tuples: one tuple that hits a counted entry
    makes more than half of the 8,000, five others most of the rest), so
    MESH_COMBINE's counted hits crowd a few cells."""
    _need_card()
    import dataclasses

    from cilium_tpu_torch import kernels, world
    from cilium_tpu_torch.compiler import partition
    from cilium_tpu_torch.compiler.tables import repack_l4_subword
    from cilium_tpu_torch.convert import policy_tables_to
    from cilium_tpu_torch.engine import mesh, sharded, verdict
    from cilium_tpu_torch.engine.verdict import TupleBatch

    w = world.make_world(
        seed=6, n_rules=400, n_endpoints=4, n_identities=512,
        n_cidr_blocks=16, n_vips=4, n_pool=3000, ct_max_entries=4096,
        identity_pad=256, filter_pad=16,
    )
    pol = w.host_tables().policy
    if compact:
        lanes = {"stash_edges": {"lanes": 4}}.get(compact, {})
        pol = dataclasses.replace(repack_l4_subword(pol, **lanes), port_slot=(
            pol.port_slot), l4_allow_bits=pol.l4_allow_bits)
    cols = world.lattice_tuples(w, 8 * 1000, seed=3)
    cols["identity"][::7] = 7  # unknown identities
    cols["is_fragment"] = np.arange(8000) % 11 == 0
    if compact == "hot":
        from cilium_tpu_torch.convert import policy_tables_to as to

        kinds = verdict.evaluate_batch(
            to(pol, "cpu"), TupleBatch.from_numpy(**cols, device="cpu"),
            device="cpu").match_kind
        cols = world.hot_tuples(cols, kinds.numpy(), 8000, seed=4)
    if compact == "stash_edges":
        edge = dict(
            identity=[0xFFFFFFFF, 0x7FFFFFFF, (1 << 24) + 70000,
                      (1 << 24) - 1, 999999, 1 << 31, (1 << 24) + 200, 7],
            ep_index=[-1, -2, 1 << 20, 0xFFFFFFFF, 2, 1, 0, -3],
            direction=[-1, 2, 255, 0xFFFFFFFE, 1, 0, 1, 0],
            dport=[70000, 65536, 1 << 31, 0xFFFFFFFF, 80, 53, 443, 8080])
        for k, v in edge.items():
            cols[k] = np.asarray(cols[k]).astype(np.int64)
            cols[k][:16] = np.asarray(v * 2, np.int64)
            cols[k] = (cols[k] & 0xFFFFFFFF).astype(np.uint32)
        # then one tuple an entry of both stashes: their keys decoded
        ids = np.asarray(pol.id_table).astype(np.int64) & 0xFFFFFFFF
        at = 16
        for stash in (pol.l4_hash_stash, pol.l4_wild_stash):
            for w0, w1 in (np.asarray(stash).astype(np.int64)
                           & 0xFFFFFFFF)[:, :2]:
                if w0 == 0xFFFFFFFF:
                    continue
                cols["identity"][at] = ids[min(int(w0 & 0x3FFFF),
                                               len(ids) - 1)]
                cols["dport"][at] = (w0 >> 18) | ((w1 & 3) << 14)
                cols["proto"][at] = (w1 >> 2) & 0xFF
                cols["ep_index"][at] = (w1 >> 10) & 0xFF
                cols["direction"][at] = (w1 >> 18) & 1
                at += 1
    valid = np.arange(8000) % 5 != 0
    alive = np.ones((dp_, tp), bool)
    if tp > 1:
        alive[0, 1] = False
    runs = {}
    for dev in ("cuda", "cpu"):
        m = mesh.make_mesh(dp_, tp, device=dev)
        tab = policy_tables_to(pol, dev)
        batch = TupleBatch.from_numpy(**cols, device=dev)
        aug = policy_tables_to(partition.replicate_table_leaves(pol, tp), dev)
        before = {k.name: k.launches for k in (
            kernels.MESH_PROBE, kernels.ROUTED_PROBE, kernels.MESH_COMBINE)}
        runs[dev] = (
            sharded.make_mesh_evaluator(m, collect_telemetry=True)(tab, batch),
            sharded.make_partitioned_evaluator(m, pol,
                                               collect_telemetry=True)(
                tab, batch),
            sharded.make_failover_evaluator(m, pol, collect_telemetry=True)(
                aug, batch, alive, valid),
            (verdict.make_sharded_evaluator(m)(tab, batch),),
        )
        torch.cuda.synchronize()
        after = {k.name: k.launches for k in (
            kernels.MESH_PROBE, kernels.ROUTED_PROBE, kernels.MESH_COMBINE)}
        if dev == "cuda":
            assert after["mesh_probe"] - before["mesh_probe"] == dp_ * tp
            assert after["routed_probe"] - before["routed_probe"] == (
                2 * dp_ * tp)
            assert after["mesh_combine"] - before["mesh_combine"] == 3 * dp_
        else:
            assert after == before
    for k, (got, want) in enumerate(zip(runs["cuda"], runs["cpu"])):
        for c in ("allowed", "proxy_port", "match_kind"):
            assert torch.equal(getattr(got[0], c).cpu(),
                               getattr(want[0], c)), (k, c)
        for a, b in zip(got[1:], want[1:]):
            assert torch.equal(a.cpu(), b), k
    m = mesh.make_mesh(dp_, tp, device="cuda")
    batch = TupleBatch.from_numpy(**cols, device="cuda")
    assert _routed_records_differ(m, pol, batch, alive, tp) == 0
    if compact == "stash_edges":  # both stashes hit
        stash = sharded.routed_probe_plain(
            policy_tables_to(pol, "cuda"), batch, sharded._routed_geom(
                pol, 1, "table", failover=False)[1], 0)
        assert int(((stash[0] & sharded.F_STASH) != 0).sum()) > 0
