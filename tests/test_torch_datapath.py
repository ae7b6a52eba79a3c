"""The PyTorch port's plain pair step and PersistentPairDispatcher on the
CPU against the JAX package's pair step and dispatcher: all 15
DatapathVerdicts columns, the [E, 2, Kg + N] counter buffer and the
[2, 20] telemetry buffer, with tolerance 0 (every value is an
integer).  Tables either built by the port or carried across from the
JAX builders (convert.tables_from_numpy); compact and wide layouts;
uniform and Zipf pairs; two seeds."""

import numpy as np
import pytest
import torch

import jax

from cilium_tpu.engine import datapath as jdp
from cilium_tpu.engine.verdict import (
    make_counter_buffers as j_counters,
    make_telemetry_buffers as j_telem,
)
from cilium_tpu_torch import convert, world
from cilium_tpu_torch.compiler.tables import repack_l4_subword, split_hot
from cilium_tpu_torch.ct.device import compact_ct_snapshot
from cilium_tpu_torch.engine import datapath as tdp
from cilium_tpu_torch.engine import verdict as tv

from torch_parity import (
    SMALL,
    assert_same_buffers,
    assert_same_verdicts,
    chaos_storm,
    jax_host_tables,
    jax_leaves,
    jax_run_pairs,
    port_run_pairs,
)


def _port_tables(w, layout, source, jt):
    if source == "convert":
        return convert.tables_from_numpy(jax_leaves(jt), device="cpu")
    host = w.host_tables()
    if layout == "compact":
        host = tdp.subword_datapath_tables(host)
    host.policy = split_hot(host.policy)
    return convert.tables_to(host, "cpu")


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("source", ["port", "convert"])
@pytest.mark.parametrize("layout", ["compact", "wide"])
def test_pair_step_matches_jax(seed, source, layout):
    """Uniform and Zipf pairs through both pair steps, carries
    threaded across pairs."""
    w = world.make_world(seed=seed, **SMALL)
    jt = jax_host_tables(w, subword=(layout == "compact"))
    tt = _port_tables(w, layout, source, jt)
    assert (tt.ct.entry_words == 4) == (layout == "compact")
    pairs = w.pairs(seed=10 + seed, half=192, k=2) + w.pairs(
        seed=20 + seed, half=192, k=2, zipf=1.2
    )
    j_outs, jacc, jtel = jax_run_pairs(jt, pairs)
    t_outs, acc, tel = port_run_pairs(tt, pairs)
    for n, ((ji, je), (ti, te)) in enumerate(zip(j_outs, t_outs)):
        assert_same_verdicts(ti, ji, f"pair {n} ingress")
        assert_same_verdicts(te, je, f"pair {n} egress")
    assert_same_buffers(acc, tel, jacc, jtel)
    # the worlds reach every stage the telemetry can see on this path
    counts = tel.numpy().view(np.uint32).sum(axis=0)
    silent = [
        name for name, c in zip(tv.TELEM_NAMES, counts)
        if c == 0 and name != "ct_related"
    ]
    assert not silent, silent


def test_pair_step_matches_jax_on_storm_world():
    """The storm world's compact tables carried across, with its own
    flow shapes (VIP with three backends, ranges at /12 and /24)."""
    storm = chaos_storm()
    dt, parts = storm._fused_world(7)
    jt, report = jdp.subword_datapath_tables(dt)
    assert all(v == "packed" for v in report.values()), report
    tt = convert.tables_from_numpy(jax_leaves(jt), device="cpu")
    rng = np.random.default_rng(5)
    pairs = []
    for r in range(3):
        pair = np.empty((2, 4, 256), np.uint32)
        for half in range(2):
            f = storm._fused_flows(rng, 256, parts)
            f["direction"] = np.full(256, half)
            pair[half] = tdp.pack_flow_records4(**f)
        pairs.append(pair)
    j_outs, jacc, jtel = jax_run_pairs(jt, pairs)
    t_outs, acc, tel = port_run_pairs(tt, pairs)
    for (ji, je), (ti, te) in zip(j_outs, t_outs):
        assert_same_verdicts(ti, ji, "ingress")
        assert_same_verdicts(te, je, "egress")
    assert_same_buffers(acc, tel, jacc, jtel)


def test_narrow_rows_with_full_stashes_match_jax():
    """Narrow L4 and CT rows spill into the stashes; the probes must
    sum the stash hits exactly as the reference does."""
    from cilium_tpu.compiler.tables import repack_l4_subword as j_l4
    from cilium_tpu.ct.device import compact_ct_snapshot as j_ct
    import dataclasses

    w = world.make_world(seed=3, **SMALL)
    jt = jax_host_tables(w, subword=True)
    jwide = jax_host_tables(w, subword=False)
    jt = dataclasses.replace(
        jt, policy=j_l4(jwide.policy, lanes=4), ct=j_ct(jwide.ct, lanes=12)
    )
    host = w.host_tables()
    host = tdp.subword_datapath_tables(host)
    wide = w.host_tables()
    host.policy = split_hot(repack_l4_subword(wide.policy, lanes=4))
    host.ct = compact_ct_snapshot(wide.ct, lanes=12)
    assert host.ct.stash.shape[0] > 1 and host.policy.l4_hash_stash.shape[0] > 1
    tt = convert.tables_to(host, "cpu")
    pairs = w.pairs(seed=8, half=256, k=2)
    j_outs, jacc, jtel = jax_run_pairs(jt, pairs)
    t_outs, acc, tel = port_run_pairs(tt, pairs)
    for (ji, je), (ti, te) in zip(j_outs, t_outs):
        assert_same_verdicts(ti, ji, "ingress")
        assert_same_verdicts(te, je, "egress")
    assert_same_buffers(acc, tel, jacc, jtel)


@pytest.mark.parametrize("seed", [1, 2])
def test_persistent_dispatcher_matches_jax(seed):
    """K = 3 over 7 pairs: 2 super-batches plus a remainder of one
    pair, against the JAX dispatcher (one scan launch per K pairs);
    the port runs one persistent program call per K pairs and the
    remainder pair by pair."""
    w = world.make_world(seed=seed, **SMALL)
    jt = jax_host_tables(w, subword=True)
    host = tdp.subword_datapath_tables(w.host_tables())
    host.policy = split_hot(host.policy)
    tt = convert.tables_to(host, "cpu")
    pairs = w.pairs(seed=30 + seed, half=160, k=4) + w.pairs(
        seed=40 + seed, half=160, k=3, zipf=1.3
    )

    jd = jdp.PersistentPairDispatcher(
        jt, 3, jax.device_put(j_counters(jt.policy)),
        jax.device_put(j_telem()), site="test.torch.persistent",
    )
    acc = tv.make_counter_buffers(tt.policy)
    tel = tv.make_telemetry_buffers("cpu")
    td = tdp.PersistentPairDispatcher(tt, 3, acc, tel)
    j_got, t_got = [], []
    for p in pairs:
        j_got.extend(jd.submit(p))
        t_got.extend(td.submit(p))
        assert len(j_got) == len(t_got)
    j_rem, jacc, jtel = jd.flush()
    t_rem, acc, tel = td.flush()
    j_got.extend(j_rem)
    t_got.extend(t_rem)
    assert td.launches == jd.launches == 2
    assert len(t_got) == len(pairs)
    for (ji, je), (ti, te) in zip(j_got, t_got):
        assert_same_verdicts(ti, ji, "ingress")
        assert_same_verdicts(te, je, "egress")
    assert_same_buffers(acc, tel, jacc, jtel)


def test_packed4_round_trip():
    """pack_flow_records4 (port) equals the reference's packing, and the
    plain unpack restores every column."""
    rng = np.random.default_rng(0)
    n = 1000
    cols = dict(
        ep_index=rng.integers(0, 1 << 16, n),
        saddr=rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
        daddr=rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
        sport=rng.integers(0, 1 << 16, n),
        dport=rng.integers(0, 1 << 16, n),
        proto=rng.integers(0, 256, n),
        direction=rng.integers(0, 2, n),
        is_fragment=rng.random(n) < 0.5,
    )
    packed = tdp.pack_flow_records4(**cols)
    np.testing.assert_array_equal(packed, jdp.pack_flow_records4(**cols))
    f = tdp.flow_batch_from_packed4(torch.from_numpy(packed.view(np.int32)))
    for name, want in cols.items():
        np.testing.assert_array_equal(
            getattr(f, name).numpy(), np.asarray(want).astype(
                bool if name == "is_fragment" else np.int64
            ), err_msg=name,
        )
    with pytest.raises(ValueError):
        tdp.pack_flow_records4(**{**cols, "ep_index": np.full(n, 1 << 16)})
