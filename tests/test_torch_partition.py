"""The PyTorch port's partition rule layer (cilium_tpu_torch/compiler/
partition.py) on the CPU against the JAX package's: the rule matching,
every leaf's PartitionSpec as a tuple, the divisibility fallback, the
digests, the N+1 replica layout and delta rewrite, and the byte models,
on `random_map_state` worlds of seeds 0 and 1.  Every comparison is
exact."""

import dataclasses

import numpy as np
import pytest

from cilium_tpu_torch.compiler import delta as tdelta
from cilium_tpu_torch.compiler import partition as tpart
from cilium_tpu_torch.compiler.tables import compile_map_states as t_compile
from cilium_tpu_torch.engine.mesh import P as TP
from cilium_tpu_torch.maps import policymap as tpm

try:
    from jax.sharding import PartitionSpec as JP

    from cilium_tpu.compiler import delta as jdelta
    from cilium_tpu.compiler import partition as jpart
    from cilium_tpu.compiler.tables import compile_map_states as j_compile
    from cilium_tpu.maps import policymap as jpm

    from tests.test_verdict_engine import random_map_state
    from torch_parity import convert_states
except ImportError:  # the card's machine has no JAX
    jpart = None

WIDE_IDS = [1, 2, 3, 4, 5] + [256 + i for i in range(120)] + [65536, 70000]
NTPS = (1, 2, 3, 4, 5, 8)


def _need_jax():
    if jpart is None:
        pytest.skip("JAX is not installed")


def _build(seed, n_eps=3, identity_pad=256):
    """The same world through both compilers: (port tables, JAX
    tables)."""
    rng = np.random.default_rng(seed)
    states = [random_map_state(rng, WIDE_IDS, n_l4=16, n_l3=24)
              for _ in range(n_eps)]
    jt = j_compile(states, WIDE_IDS, identity_pad=identity_pad,
                   filter_pad=16)
    tt = t_compile(convert_states(states, jpm, tpm), WIDE_IDS,
                   identity_pad=identity_pad, filter_pad=16)
    return tt, jt


def _specs_equal(port, ref):
    for name in tpart.POLICY_LEAF_NAMES:
        assert tuple(getattr(port, name)) == tuple(getattr(ref, name)), name


@pytest.mark.parametrize("case", ["first_match", "scalars", "unmatched"])
def test_match_partition_rules_matches_jax(case):
    _need_jax()
    if case == "first_match":
        args = ([(r"^l3_allow_bits$", "l3"), (r".*", "rep")],
                ["l3_allow_bits", "id_table"],
                [np.zeros((2, 2, 8), np.uint32), np.zeros(4, np.uint32)])
    elif case == "scalars":
        args = ([(r".*", "table")], ["generation", "one_elem", "none_leaf"],
                [np.uint64(7), np.zeros((1,), np.uint32), None])
    else:
        with pytest.raises(ValueError, match="partition rule not found"):
            tpart.match_partition_rules([(r"^only_this$", TP())],
                                        ["something_else"],
                                        [np.zeros(8, np.uint32)])
        return
    spec = {"l3": (None, None, "table"), "rep": (), "table": ("table",)}
    rules_t = [(pat, TP(*spec[s])) for pat, s in args[0]]
    rules_j = [(pat, JP(*spec[s])) for pat, s in args[0]]
    got = tpart.match_partition_rules(rules_t, args[1], args[2])
    want = jpart.match_partition_rules(rules_j, args[1], args[2])
    assert [tuple(s) for s in got] == [tuple(s) for s in want]


@pytest.mark.parametrize("seed", [0, 1])
def test_policy_specs_match_jax(seed):
    _need_jax()
    tt, jt = _build(seed)
    _specs_equal(tpart.policy_partition_specs(tt),
                 jpart.policy_partition_specs(jt))
    for ntp in NTPS:
        _specs_equal(tpart.divisible_partition_specs(tt, ntp),
                     jpart.divisible_partition_specs(jt, ntp))
        assert tpart.replica_axes(tt, ntp) == jpart.replica_axes(jt, ntp)


def test_rule_tables_and_digests_match_jax():
    _need_jax()
    for axis in ("table", "other_axis"):
        t_rules = tpart.default_table_rules(axis)
        j_rules = jpart.default_table_rules(axis)
        assert [(p, tuple(s)) for p, s in t_rules] == [
            (p, tuple(s)) for p, s in j_rules]
        assert tpart.partition_digest(t_rules) == jpart.partition_digest(
            j_rules)
        assert [(p, tuple(s)) for p, s in tpart.default_ipcache_rules(
            axis)] == [(p, tuple(s))
                       for p, s in jpart.default_ipcache_rules(axis)]
        for ntp in (None, 2, 4, 8):
            assert tpart.replica_partition_digest(axis, ntp=ntp) == (
                jpart.replica_partition_digest(axis, ntp=ntp))
    assert tpart.replica_partition_digest() != tpart.partition_digest(
        tpart.default_table_rules())
    assert (tpart.REPLICA_LEAVES, tpart.REPLICA_BACKUP_OFFSET) == (
        jpart.REPLICA_LEAVES, jpart.REPLICA_BACKUP_OFFSET)
    assert tpart.POLICY_LEAF_NAMES == jpart.POLICY_LEAF_NAMES
    assert tpart.IPCACHE_LEAF_NAMES == jpart.IPCACHE_LEAF_NAMES


def test_named_tree_map_key_paths_match_jax():
    _need_jax()
    tree = {"a": np.zeros(4), "sub": {"b": np.ones(2), "c": [np.ones(1)]}}
    seen_t, seen_j = {}, {}
    tpart.named_tree_map(lambda n, leaf: seen_t.setdefault(n, leaf.shape),
                         tree)
    jpart.named_tree_map(lambda n, leaf: seen_j.setdefault(n, leaf.shape),
                         tree)
    assert seen_t == seen_j == {"a": (4,), "sub/b": (2,), "sub/c/0": (1,)}
    doubled = tpart.named_tree_map(lambda n, x, y: x + y, tree, tree)
    np.testing.assert_array_equal(doubled["sub"]["c"][0], np.full(1, 2.0))


def test_ipcache_specs_match_jax():
    _need_jax()
    from cilium_tpu.ipcache import lpm as jlpm
    from cilium_tpu_torch.ipcache import lpm as tlpm

    cidrs = {"10.0.0.1/32": 7, "10.1.0.0/16": 9}
    jdev, tdev = jlpm.build_ipcache(cidrs), tlpm.build_ipcache(cidrs)
    want = jpart.ipcache_partition_specs(jdev)
    got = tpart.ipcache_partition_specs(tdev)
    for name in tpart.IPCACHE_LEAF_NAMES:
        assert tuple(got[name]) == tuple(getattr(want, name)), name
    lpm = tpart.ipcache_partition_specs(tlpm.build_lpm({"10.0.0.1/32": 7}))
    assert all(tuple(s) == () for s in lpm.values())


@pytest.mark.parametrize("ntp", [2, 4])
def test_replica_layout_matches_jax(ntp):
    _need_jax()
    arr = np.arange(8 * 3, dtype=np.uint32).reshape(8, 3)
    for axis in (0, 1) if ntp == 2 else (0,):
        a = arr if axis == 0 else arr[:, :2]
        np.testing.assert_array_equal(
            tpart.replicate_shard_axis(a, ntp, axis),
            jpart.replicate_shard_axis(a, ntp, axis))
    idx = np.arange(16)
    for got, want in zip(tpart.replica_positions(idx, 16 // ntp, ntp),
                         jpart.replica_positions(idx, 16 // ntp, ntp)):
        np.testing.assert_array_equal(got, want)
    tt, jt = _build(0)
    taug = tpart.replicate_table_leaves(tt, ntp)
    jaug = jpart.replicate_table_leaves(jt, ntp)
    for name in tpart.POLICY_LEAF_NAMES:
        a, b = getattr(taug, name), getattr(jaug, name)
        if isinstance(b, np.ndarray) and b.ndim:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("ntp", [2, 4])
def test_replica_delta_matches_jax(ntp):
    """A delta with a row scatter of l4_hash_rows, a slab scatter of
    l3_allow_bits, an untouched leaf and a whole-leaf replacement,
    rewritten into augmented coordinates by both packages."""
    _need_jax()
    tt, jt = _build(1)
    rng = np.random.default_rng(ntp)
    rows = tt.l4_hash_rows
    r_idx = rng.choice(rows.shape[0], size=5, replace=False)
    e_idx = np.array([0, 2])
    ups = {
        "l4_hash_rows": ((r_idx,), rng.integers(
            0, 1 << 32, size=(5, rows.shape[1]), dtype=np.uint32)),
        "l3_allow_bits": ((e_idx,), rng.integers(
            0, 1 << 32, size=(2,) + tt.l3_allow_bits.shape[1:],
            dtype=np.uint32)),
        "l4_meta": ((e_idx,), np.asarray(tt.l4_meta)[e_idx]),
    }
    replace = {"l3_allow_bits": np.asarray(tt.l3_allow_bits)[::-1].copy()}

    def make(mod):
        return mod.TableDelta(
            base_stamp=3, new_stamp=4,
            updates={n: mod.LeafUpdate(idx=i, values=v)
                     for n, (i, v) in ups.items()},
            replace=dict(replace), layout=7)

    got = tpart.replica_delta(make(tdelta), tt, ntp)
    want = jpart.replica_delta(make(jdelta), jt, ntp)
    assert (got.base_stamp, got.new_stamp, got.layout) == (3, 4, 7)
    assert sorted(got.updates) == sorted(want.updates)
    for name in want.updates:
        for a, b in zip(got.updates[name].idx, want.updates[name].idx):
            np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(got.updates[name].values,
                                      want.updates[name].values,
                                      err_msg=name)
    for name in want.replace:
        np.testing.assert_array_equal(got.replace[name], want.replace[name])


@pytest.mark.parametrize("seed", [0, 1])
def test_byte_models_match_jax(seed):
    _need_jax()
    tt, jt = _build(seed)
    for n in (1, 2, 4, 5, 8):
        assert tpart.shard_bytes_model(tt, n) == jpart.shard_bytes_model(
            jt, n)
        assert tpart.replica_bytes_model(tt, n) == (
            jpart.replica_bytes_model(jt, n))
        for hbm in (16 << 30, 1 << 20):
            assert tpart.universe_max_identities(tt, n, hbm) == (
                jpart.universe_max_identities(jt, n, hbm))
        assert tpart.alltoall_bytes_per_tuple(n) == (
            jpart.alltoall_bytes_per_tuple(n))
    rows, per_chip, overhead = tpart.replica_bytes_model(tt, 4)
    assert overhead > 0 and per_chip > overhead
    assert dataclasses.is_dataclass(tt)
