"""The port's threefry2x32 draw (cilium_tpu_torch/prng.py) against
jax.random on the CPU, with tolerance 0 (every value is an integer):

  * `jax_threefry_partitionable` is on, the mode the port copies (a
    flip in jax shows up here first);
  * `prng_key` against `jax.random.PRNGKey` on seeds 0, 1, 2^31 - 1,
    2^32 and above, negative ones and `len(ct) ^ n` values (the
    reference never enables x64, so every seed keeps its low 32 bits);
  * `fold_in` and `split` against jax's;
  * `randint_u32` against `jax.random.randint(key, (B,), 0, P, uint32)`
    for P in {1, 64, 50,000, 3,000,017} (the last wraps the u32 square
    of the multiplier to 0) at a B that is not a power of two;
  * an int-pick `replay_pool` against the reference's on two SMALL
    worlds with a partial last batch: the stats, every CT entry and the
    snapshot.

The `cuda`-marked tests hold PICK_DRAW against the plain draw and the
int-pick loop on the card against the plain loop; they need no JAX and
skip here:

    python -m pytest --noconftest tests/test_torch_prng.py -q -m cuda
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from cilium_tpu_torch import convert, prng
from cilium_tpu_torch import replay as trp

try:
    import jax
    import jax.numpy as jnp
    import jax.random as jrandom

    from test_torch_churn import (
        _assert_same_ct,
        _assert_same_snapshot,
        _replay_both,
        _world,
    )
except ImportError:  # the card's machine has no JAX: only cuda tests run
    jax = None

SPANS = (1, 64, 50_000, 3_000_017)
SEEDS = (0, 1, (1 << 31) - 1, 1 << 32, (1 << 40) + 7, 3000 ^ 4796,
         4096 ^ (2 * 2048 + 700))


def _need_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if shutil.which("nvcc") is None and not os.path.exists(
        "/usr/local/cuda/bin/nvcc"
    ):
        pytest.skip("no nvcc to build the kernels")


def _key_of(jkey):
    return tuple(int(v) for v in np.asarray(jkey))


def test_threefry_partitionable_is_on():
    _need_jax()
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_and_split_match_jax(seed):
    _need_jax()
    key = prng.prng_key(seed)
    assert key == _key_of(jrandom.PRNGKey(seed))
    for data in (0, 1, 5, (1 << 32) - 1):
        assert prng.fold_in(key, data) == _key_of(
            jrandom.fold_in(jrandom.PRNGKey(seed), data))
    k1, k2 = jrandom.split(jrandom.PRNGKey(seed))
    assert prng.split(key) == (_key_of(k1), _key_of(k2))


def test_prng_key_cuts_seeds_to_32_bits():
    """The reference runs without x64, so PRNGKey keeps a seed's low 32
    bits: above 2^32 and negative seeds too."""
    _need_jax()
    assert jax.config.jax_enable_x64 is False
    for seed in ((1 << 40) + 3, (1 << 63) - 1, -1, -5, -(1 << 31) - 1):
        assert prng.prng_key(seed) == _key_of(jrandom.PRNGKey(seed)), seed
        assert prng.prng_key(seed) == (0, seed % (1 << 32))


@pytest.mark.parametrize("span", SPANS)
def test_randint_matches_jax(span):
    _need_jax()
    for seed, batch in ((7, 0), (3000 ^ 4796, 2), ((1 << 31) - 1, 9)):
        jkey = jrandom.fold_in(jrandom.PRNGKey(seed), batch)
        want = np.asarray(jrandom.randint(jkey, (1001,), 0, span,
                                          dtype=jnp.uint32))
        key = prng.fold_in(prng.prng_key(seed), batch)
        got = prng.randint_u32(key, 1001, span, device="cpu")
        assert got.dtype == torch.int32 and got.shape == (1001,)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert prng.randint_multiplier(span) == (
        0 if span > 1 << 16 else ((1 << 16) % span) ** 2 % span)


def test_threefry_known_answer():
    """The Random123 known-answer vectors of threefry2x32-20: key and
    counter all ones, and all zeros."""
    m = 0xFFFFFFFF
    assert prng.threefry2x32(m, m, m, m) == (0x1CB996FC, 0xBB002BE7)
    assert prng.threefry2x32(0, 0, 0, 0) == (0x6B200159, 0x99BA4EFE)


@pytest.mark.parametrize("seed", [1, 2])
def test_replay_pool_int_picks_matches_jax(seed, monkeypatch):
    """The int-pick loop draws the reference's picks: the same stats,
    rounds and intents, every CT entry and the snapshot bytes, over two
    full batches and a partial one."""
    _need_jax()
    w = _world(seed)
    n = 2 * 2048 + 700
    js, ts, jmap, tmap = _replay_both(w, n, 2048, 1 << 10, monkeypatch)
    for f in ("total", "allowed", "denied", "redirected", "batches",
              "ct_created", "ct_deleted"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.batches == 3 and ts.total == n
    assert ts.ct_created > 0 and ts.reruns > 0
    _assert_same_ct(tmap, jmap)
    _assert_same_snapshot(tmap._device_churn_cache[1],
                          jmap._device_churn_cache[1])


# -- on the card -----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("span", SPANS)
def test_pick_draw_matches_plain(span):
    _need_card()
    from cilium_tpu_torch import kernels

    key = prng.fold_in(prng.prng_key(12345 ^ 99), 3)
    before = kernels.PICK_DRAW.launches
    got = prng.randint_u32(key, 100_003, span, device="cuda")
    want = prng.randint_u32_plain(key, 100_003, span, device="cuda")
    torch.cuda.synchronize()
    assert kernels.PICK_DRAW.launches == before + 1
    assert got.device.type == "cuda" and torch.equal(got, want)
    assert prng.randint_u32(key, 0, span, device="cuda").numel() == 0


@pytest.mark.cuda
def test_int_pick_loop_on_card_matches_plain(monkeypatch):
    """replay_pool with an int pick count on the card (PICK_DRAW and the
    churn kernels) and on the CPU (the plain versions): the same picks,
    so equal stats, CT entries and snapshot bytes."""
    _need_card()
    from test_torch_churn import _card_world, convert_ct_port

    w, tables = _card_world()
    cpu_tables = convert.tables_to(w.host_tables(), "cpu")
    maps = [convert_ct_port(w.ct), convert_ct_port(w.ct)]
    monkeypatch.setattr(trp, "_CT_CLAIM_SLOTS", 1 << 10)
    stats = [
        trp.replay_pool(t, dict(w.pool), 3 * 4096 + 100, batch_size=4096,
                        ct_map=m, device=d)
        for t, m, d in ((tables, maps[0], "cuda"),
                        (cpu_tables, maps[1], "cpu"))
    ]
    a, b = (dataclasses.replace(s, seconds=0.0, fold_seconds=0.0)
            for s in stats)
    assert a == b and a.ct_created > 0
    assert list(maps[0].entries) == list(maps[1].entries)
    for leaf in ("buckets", "stash"):
        assert torch.equal(getattr(maps[0]._device_churn_cache[1], leaf).cpu(),
                           getattr(maps[1]._device_churn_cache[1], leaf))
