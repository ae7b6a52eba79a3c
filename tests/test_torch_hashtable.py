"""The PyTorch port's generic device hash table (engine/hashtable.py) on
the CPU against the JAX package's: `build_hash_table` leaf for leaf
(random tables of several key widths, a cluster of keys that share one
window and overflow into the stash, the ValueError of a collision set
larger than window and stash), and `lookup_batch` through the port's
entry point (device="cpu", the plain version) against
`jax.jit(lookup_batch)` on hits, misses, stash keys, keys whose window
wraps at the end of the main region, keys of all-ones words and random
keys from the whole u32 range.  Every value is an integer: every
comparison is exact.

The cuda-marked tests at the end hold HASH_LOOKUP against its plain
version on the card; they need no JAX:

    python -m pytest --noconftest tests/test_torch_hashtable.py -q -m cuda
"""

import os
import shutil

import numpy as np
import pytest
import torch

from cilium_tpu_torch import convert
from cilium_tpu_torch import kernels as tkern
from cilium_tpu_torch.engine import hashtable as tht

try:
    import jax
    import jax.numpy as jnp

    from cilium_tpu.engine import hashtable as jht
except ImportError:  # the card's machine has no JAX: only cuda tests run
    jax = None

EMPTY = 0xFFFFFFFF


def _need_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("no nvcc to build the kernels")


def _keys(rng, n, kw):
    k = rng.integers(0, 1 << 32, size=(n, kw), dtype=np.uint64).astype(
        np.uint32)
    k = np.unique(k, axis=0)
    # the all-ones key marks an empty slot: callers never insert it
    return k[~(k == EMPTY).all(axis=1)]


def _cluster(seed=7, extra=4):
    """More than PROBE_WINDOW keys whose home slots collide at capacity
    1,024 (tests/test_ct_lb.py's stash-overflow cluster)."""
    rng = np.random.default_rng(seed)
    cands = _keys(rng, 200_000, 4)
    h = tht._fnv1a_host(cands) & 1023
    vals, counts = np.unique(h, return_counts=True)
    return cands[h == vals[np.argmax(counts)]][:tht.PROBE_WINDOW + extra]


def _wrap_cluster(capacity=1024):
    """Keys whose home slot lies in the last window of the main region,
    so their window wraps to slot 0: enough of them that some place past
    the wrap."""
    rng = np.random.default_rng(11)
    cands = _keys(rng, 400_000, 4)
    h = tht._fnv1a_host(cands).astype(np.int64) & (capacity - 1)
    near_end = cands[h >= capacity - 3]
    return near_end[:24]


def _same_table(port, ref):
    assert port.capacity == ref.capacity
    assert port.max_probes == ref.max_probes
    for leaf in ("keys", "value_index"):
        got, want = getattr(port, leaf), np.asarray(getattr(ref, leaf))
        assert got.dtype == want.dtype and got.shape == want.shape, leaf
        np.testing.assert_array_equal(got, want, err_msg=leaf)


def _queries(rng, keys, n_miss=256):
    """Hits, misses and sentinel rows, shuffled: the keys, random keys
    from the whole u32 range, single-word flips of keys, all-ones rows
    and a key with one all-ones word."""
    kw = keys.shape[1]
    miss = rng.integers(0, 1 << 32, size=(n_miss, kw),
                        dtype=np.uint64).astype(np.uint32)
    flip = keys[:n_miss].copy()
    flip[:, 0] ^= 0xDEADBEEF
    part = keys[:4].copy()
    part[:, -1] = EMPTY
    edge = np.array([[EMPTY] * kw, [0] * kw, [EMPTY - 1] * kw], np.uint32)
    q = np.concatenate([keys, miss, flip, part, edge, edge])
    return q[rng.permutation(len(q))]


def _same_lookup(port_table, ref_table, query, tag):
    tt = convert.hashtable_to(port_table, "cpu")
    found, index = tht.lookup_batch(tt, query, device="cpu")
    jfound, jindex = jax.jit(jht.lookup_batch)(ref_table, jnp.asarray(query))
    assert found.dtype == torch.bool and index.dtype == torch.int32
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound),
                                  err_msg=f"{tag} found")
    np.testing.assert_array_equal(index.numpy(), np.asarray(jindex),
                                  err_msg=f"{tag} index")
    return found.numpy(), index.numpy()


def test_constants_match_jax():
    _need_jax()
    for name in ("PROBE_WINDOW", "STASH_SIZE", "LOAD_FACTOR_INV",
                 "_MAX_GROWTH_DOUBLINGS"):
        assert getattr(tht, name) == getattr(jht, name), name
    assert int(tht.EMPTY) == int(jht.EMPTY)


@pytest.mark.parametrize("n,kw,min_cap", [(1, 1, 16), (500, 4, 16),
                                          (3000, 2, 64), (700, 5, 4096),
                                          (0, 3, 16)])
def test_build_and_lookup_match_jax(n, kw, min_cap):
    _need_jax()
    rng = np.random.default_rng(n * 10 + kw)
    keys = _keys(rng, n, kw)
    tt, jt = tht.build_hash_table(keys, min_cap), jht.build_hash_table(
        keys, min_cap)
    _same_table(tt, jt)
    if n:
        found, index = _same_lookup(tt, jt, _queries(rng, keys), f"{n}x{kw}")
        assert found.sum() >= len(keys)
    # the exact keys in order: every one found at its own row
    found, index = _same_lookup(tt, jt, keys.reshape(-1, kw), "keys")
    assert found.all()
    np.testing.assert_array_equal(index, np.arange(len(keys)))


def test_stash_overflow_cluster_matches_jax():
    _need_jax()
    cluster = _cluster()
    assert len(cluster) > tht.PROBE_WINDOW
    tt = tht.build_hash_table(cluster, min_capacity=1024)
    jt = jht.build_hash_table(cluster, min_capacity=1024)
    _same_table(tt, jt)
    stash = np.asarray(tt.keys[tt.capacity:])
    assert (~(stash == EMPTY).all(axis=1)).sum() >= 1  # keys in the stash
    found, index = _same_lookup(tt, jt, cluster, "cluster")
    assert found.all()
    np.testing.assert_array_equal(index, np.arange(len(cluster)))
    rng = np.random.default_rng(1)
    _same_lookup(tt, jt, _queries(rng, cluster, 64), "cluster mixed")


def test_window_wrap_matches_jax():
    _need_jax()
    keys = _wrap_cluster()
    tt = tht.build_hash_table(keys, min_capacity=1024)
    jt = jht.build_hash_table(keys, min_capacity=1024)
    _same_table(tt, jt)
    assert tt.capacity == 1024
    # some key sits in the first slots: its window wrapped
    slots = np.flatnonzero(~(np.asarray(tt.keys[:tt.capacity]) == EMPTY)
                           .all(axis=1))
    assert slots.min() < tht.PROBE_WINDOW and slots.max() >= 1020
    found, index = _same_lookup(tt, jt, keys, "wrap")
    assert found.all()
    np.testing.assert_array_equal(index, np.arange(len(keys)))


def test_duplicate_window_hits_take_the_first():
    """A key stored twice (in the window and in the stash, and twice in
    the window): the first hit in window order wins, a window hit beats
    the stash, and the stash takes its first hit, as in JAX."""
    _need_jax()
    rng = np.random.default_rng(5)
    keys = _keys(rng, 40, 3)
    jt = jht.build_hash_table(keys, min_capacity=256)
    k = np.asarray(jt.keys).copy()
    vi = np.asarray(jt.value_index).copy()
    cap = jt.capacity
    h = int(tht._fnv1a_host(keys[:1])[0]) & (cap - 1)
    free = [s for s in range(h, h + tht.PROBE_WINDOW)
            if (k[s % cap] == EMPTY).all()]
    k[free[-1] % cap] = keys[0]
    vi[free[-1] % cap] = 777
    k[cap], k[cap + 1] = keys[1], keys[1]
    vi[cap], vi[cap + 1] = 501, 502
    k[cap + 2], vi[cap + 2] = keys[0], 900
    # a key held only by the stash, twice
    lone = np.array([[7, 8, 9]], np.uint32)
    k[cap + 3], k[cap + 4] = lone[0], lone[0]
    vi[cap + 3], vi[cap + 4] = 601, 602
    jt2 = jht.HashTable(k, vi, jt.max_probes, cap)
    tt2 = tht.HashTable(k, vi, jt.max_probes, cap)
    found, index = _same_lookup(tt2, jt2, np.concatenate([keys[:2], lone]),
                                "duplicates")
    assert found.all() and index[2] == 601


def test_whole_u32_range_matches_jax():
    """Random keys with words from every part of the u32 range (top bit
    set, small, near the all-ones sentinel), a table built from half of
    them, every one queried."""
    _need_jax()
    rng = np.random.default_rng(9)
    parts = [rng.integers(0, 1 << 32, size=(2000, 4), dtype=np.uint64),
             rng.integers(0, 16, size=(2000, 4), dtype=np.uint64),
             rng.integers((1 << 32) - 16, 1 << 32, size=(2000, 4),
                          dtype=np.uint64),
             rng.integers(1 << 31, 1 << 32, size=(2000, 4), dtype=np.uint64)]
    cands = np.unique(np.concatenate(parts).astype(np.uint32), axis=0)
    cands = cands[~(cands == EMPTY).all(axis=1)]
    cands = cands[rng.permutation(len(cands))]
    keys = cands[: len(cands) // 2]
    tt, jt = tht.build_hash_table(keys), jht.build_hash_table(keys)
    _same_table(tt, jt)
    found, _ = _same_lookup(tt, jt, np.concatenate([cands, [[EMPTY] * 4]]),
                            "u32 range")
    assert found[: len(keys)].sum() > 0


def test_adversarial_collisions_fail_loudly():
    _need_jax()
    n = tht.PROBE_WINDOW + tht.STASH_SIZE + 1
    dup = np.tile(np.array([[1, 2, 3, 4]], dtype=np.uint32), (n, 1))
    for build in (tht.build_hash_table, jht.build_hash_table):
        with pytest.raises(ValueError, match="unplaced"):
            build(dup, min_capacity=64)


def test_growth_past_min_capacity_matches_jax():
    """A cluster of more than window + stash keys sharing a home slot at
    the first capacity, but not at the doubled one: the build grows, as
    in JAX."""
    _need_jax()
    rng = np.random.default_rng(3)
    cands = _keys(rng, 300_000, 2)
    lo = tht._fnv1a_host(cands).astype(np.int64) & 1023
    vals, counts = np.unique(lo, return_counts=True)
    pick = cands[lo == vals[np.argmax(counts)]][:tht.STASH_SIZE + 12]
    tt = tht.build_hash_table(pick, min_capacity=16)
    jt = jht.build_hash_table(pick, min_capacity=16)
    _same_table(tt, jt)
    assert tt.capacity > 1024  # the first capacity for 140 keys
    _same_lookup(tt, jt, pick, "grown")


def test_lookup_refusals():
    keys = np.arange(8, dtype=np.uint32).reshape(4, 2)
    host = tht.build_hash_table(keys)
    with pytest.raises(ValueError, match="hash table"):
        tht.lookup_batch(host, keys, device="cpu")
    tt = convert.hashtable_to(host, "cpu")
    with pytest.raises(ValueError, match=r"query must be \[B, 2\]"):
        tht.lookup_batch(tt, np.zeros((3, 3), np.uint32), device="cpu")
    found, index = tht.lookup_batch(tt, np.zeros((0, 2), np.uint32),
                                    device="cpu")
    assert found.shape == (0,) and index.shape == (0,)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkern.HASH_LOOKUP(tt, torch.zeros((2, 2), dtype=torch.int32))


# -- on the card ----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [1, 4, 5])
def test_hash_lookup_matches_plain_on_card(kw):
    _need_card()
    rng = np.random.default_rng(kw)
    cands = np.unique(rng.integers(0, 1 << 32, size=(40_000, kw),
                                   dtype=np.uint64).astype(np.uint32), axis=0)
    keys = cands[: len(cands) // 2]
    host = tht.build_hash_table(keys, min_capacity=64)
    cpu = convert.hashtable_to(host, "cpu")
    gpu = convert.hashtable_to(host, "cuda")
    q = np.concatenate([cands, np.full((3, kw), EMPTY, np.uint32)])
    before = tkern.HASH_LOOKUP.launches
    found, index = tht.lookup_batch(gpu, q)
    torch.cuda.synchronize()
    assert tkern.HASH_LOOKUP.launches == before + 1
    pf, pi = tht.lookup_batch(cpu, q, device="cpu")
    assert torch.equal(found.cpu(), pf) and torch.equal(index.cpu(), pi)
    assert bool(found[: len(keys)].all())


@pytest.mark.cuda
def test_hash_lookup_stash_and_wrap_on_card():
    _need_card()
    for keys, cap in ((_cluster(extra=60), 1024), (_wrap_cluster(), 1024)):
        host = tht.build_hash_table(keys, min_capacity=cap)
        found, index = tht.lookup_batch(convert.hashtable_to(host, "cuda"),
                                        keys)
        pf, pi = tht.lookup_batch(convert.hashtable_to(host, "cpu"), keys,
                                  device="cpu")
        assert torch.equal(found.cpu(), pf) and torch.equal(index.cpu(), pi)
        assert bool(pf.all())


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [128, 512])
def test_hash_lookup_wide_stash_on_card(kw):
    """A stash past the default 48 KB of shared memory (128 rows x 128
    words, 64 KB) opts in to more and matches the plain version; one past
    the device's opt-in limit (128 x 512 words, 256 KB) is refused."""
    _need_card()
    rng = np.random.default_rng(kw)
    keys = _keys(rng, 2000, kw)
    host = tht.build_hash_table(keys, min_capacity=64)
    gpu = convert.hashtable_to(host, "cuda")
    q = np.concatenate([keys, _keys(rng, 500, kw)])
    if kw * tht.STASH_SIZE * 4 > tkern.LOOKUP_LIBRARY.smem_limit(
            gpu.keys.device):
        with pytest.raises(ValueError, match="shared memory"):
            tht.lookup_batch(gpu, q)
        return
    found, index = tht.lookup_batch(gpu, q)
    pf, pi = tht.lookup_batch(convert.hashtable_to(host, "cpu"), q,
                              device="cpu")
    assert torch.equal(found.cpu(), pf) and torch.equal(index.cpu(), pi)
    assert bool(pf[: len(keys)].all())
