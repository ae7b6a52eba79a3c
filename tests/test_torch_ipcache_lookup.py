"""The PyTorch port's `lpm_lookup` over a bucketized IPCacheDevice
(ipcache/lpm.py; IPCACHE_LOOKUP on the card, `lookup_plain` on the CPU)
against the JAX package's jitted `_lookup_kernel`, on the same numpy
inputs, for every form the builders make:

  * `build_ipcache` with hashed range classes (at most RANGE_CLASS_MAX
    prefix lengths) and with the [B, P] scan (more lengths), /32 entries
    crowded into the stash, a /32 of 255.255.255.255;
  * `specialize_ipcache_to_idx` with L3 planes (at most 32 endpoints)
    and without (more), whose values are the identity index + 1;
  * `subword_ipcache` of both;
  * `LPMBuilder.tables()`, also past MAX_RANGES prefixes (DIR-24-8).

The port's builders give the JAX builders' leaves, and every value is an
integer: every comparison is exact.  Addresses: every stored /32, every
range's first and last address and its neighbours, random u32 and the
empty-lane marker 0xFFFFFFFF, whose answer is JAX's.

The cuda-marked test at the end holds IPCACHE_LOOKUP against its plain
version on the card; it needs no JAX:

    python -m pytest --noconftest tests/test_torch_ipcache_lookup.py -q -m cuda
"""

import ipaddress
import os
import shutil

import numpy as np
import pytest
import torch

from cilium_tpu_torch import convert
from cilium_tpu_torch import kernels as tkern
from cilium_tpu_torch.compiler import tables as ttab
from cilium_tpu_torch.ipcache import lpm as tlpm
from cilium_tpu_torch.maps import policymap as tpm

try:
    import jax
    import jax.numpy as jnp

    from cilium_tpu.compiler import tables as jtab
    from cilium_tpu.ipcache import lpm as jlpm
    from cilium_tpu.maps import policymap as jpm

    from tests.test_verdict_engine import random_map_state
    from torch_parity import assert_same_leaves, convert_states
except ImportError:  # the card's machine has no JAX: only cuda tests run
    jax = None

IDS = [1, 2, 3, 4, 5] + [256 + i for i in range(120)] + [65536, 70000]
_CACHE = {}


def _need_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("no nvcc to build the kernels")


def _mapping(seed, n_exact, plens, n_ranges, crowd=0):
    """{cidr: identity}: `n_exact` /32s, `n_ranges` ranges over the
    prefix lengths `plens`, `crowd` /32s more that share one bucket (so
    they spill into the stash), identities from IDS and unknown ones."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([IDS, [999_999, 7_777_777]])
    out = {}
    for ip in rng.integers(0, 1 << 32, size=n_exact, dtype=np.uint64):
        out[f"{ipaddress.ip_address(int(ip))}/32"] = int(rng.choice(ids))
    for k in range(n_ranges):
        pl = int(plens[k % len(plens)])
        base = int(rng.integers(0, 1 << 32)) & ((0xFFFFFFFF << (32 - pl))
                                               & 0xFFFFFFFF if pl else 0)
        out[f"{ipaddress.ip_address(base)}/{pl}"] = int(rng.choice(ids))
    if crowd:
        cands = rng.integers(0, 1 << 32, size=200_000, dtype=np.uint64
                             ).astype(np.uint32)
        h = tlpm._fnv1a_host(cands[:, None]) & 15
        for ip in cands[h == 3][:crowd]:
            out[f"{ipaddress.ip_address(int(ip))}/32"] = int(rng.choice(ids))
    return out


MAPS = {
    "classes": dict(seed=1, n_exact=300, plens=(8, 16, 24), n_ranges=40),
    "scan": dict(seed=2, n_exact=200, plens=(0, 6, 10, 14, 19, 27, 31),
                 n_ranges=60),
    "stash": dict(seed=3, n_exact=10, plens=(12, 20), n_ranges=8,
                  crowd=90),
    "empty_ranges": dict(seed=4, n_exact=50, plens=(24,), n_ranges=0),
}


def _addresses(mapping, seed, n_random=2000):
    rng = np.random.default_rng(seed)
    out = [0, 0xFFFFFFFF, 0xFFFFFFFE, 1]
    for cidr in mapping:
        net = ipaddress.ip_network(cidr, strict=False)
        lo, hi = int(net.network_address), int(net.broadcast_address)
        out += [lo, hi, (lo - 1) & 0xFFFFFFFF, (hi + 1) & 0xFFFFFFFF]
    out += list(rng.integers(0, 1 << 32, size=n_random, dtype=np.uint64))
    return np.asarray(out, dtype=np.uint64).astype(np.uint32)


def _policies(n_eps):
    """JAX and port policy tables of `n_eps` random endpoints."""
    key = ("policies", n_eps)
    if key not in _CACHE:
        rng = np.random.default_rng(40 + n_eps)
        states = [random_map_state(rng, IDS, n_l4=4, n_l3=24)
                  for _ in range(n_eps)]
        tstates = convert_states(states, jpm, tpm)
        _CACHE[key] = (
            jtab.compile_map_states(states, IDS, identity_pad=256,
                                    filter_pad=16),
            ttab.compile_map_states(tstates, IDS, identity_pad=256,
                                    filter_pad=16))
    return _CACHE[key]


def _built(case, form):
    """(port host IPCacheDevice, JAX IPCacheDevice, mapping) of one map
    case in one form, the leaves checked equal."""
    key = ("built", case, form)
    if key in _CACHE:
        return _CACHE[key]
    mapping = _mapping(**MAPS[case])
    tdev, jdev = tlpm.build_ipcache(mapping), jlpm.build_ipcache(mapping)
    if form != "generic":
        jpol, tpol = _policies(4 if form.startswith("planes") else 33)
        tdev = tlpm.specialize_ipcache_to_idx(tdev, tpol)
        jdev = jlpm.specialize_ipcache_to_idx(jdev, jpol)
    if form.endswith("subword"):
        tdev, jdev = tlpm.subword_ipcache(tdev), jlpm.subword_ipcache(jdev)
    assert_same_leaves(tdev, jdev, f"{case}/{form}")
    _CACHE[key] = (tdev, jdev, mapping)
    return _CACHE[key]


def _same(tdev, jdev, ips, tag):
    got = tlpm.lpm_lookup(convert.plane_to(tdev, "cpu"), ips, device="cpu")
    assert got.dtype == torch.int32
    want = np.asarray(jax.jit(jlpm._lookup_kernel)(jdev, jnp.asarray(ips)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want,
                                  err_msg=tag)
    return want


FORMS = ("generic", "planes", "planes_subword", "idx", "idx_subword")


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", sorted(MAPS))
def test_lpm_lookup_over_ipcache_matches_jax(case, form):
    _need_jax()
    tdev, jdev, mapping = _built(case, form)
    assert isinstance(tdev, tlpm.IPCacheDevice)
    assert bool(tdev.l3_planes) == form.startswith("planes")
    if case == "scan":
        assert tdev.range_rows is None  # more than RANGE_CLASS_MAX lengths
    elif case == "classes":
        assert tdev.range_rows is not None
    if case == "stash":
        assert int((np.asarray(tdev.stash)[:, 0] != 0xFFFFFFFF).sum()) > 0
    want = _same(tdev, jdev, _addresses(mapping, 7), f"{case}/{form}")
    assert (want != 0).any()


def test_lookup_of_the_broadcast_address_matches_jax():
    """A /32 of 255.255.255.255 (the empty-lane marker as an address)
    and the marker as a query against tables without it: JAX's answers,
    whatever the host oracle says."""
    _need_jax()
    for mapping in ({"255.255.255.255/32": 42, "10.0.0.0/8": 5},
                    {"10.0.0.1/32": 3, "0.0.0.0/0": 9}, {}):
        tdev, jdev = tlpm.build_ipcache(mapping), jlpm.build_ipcache(mapping)
        ips = np.array([0xFFFFFFFF, 0x0A000001, 0x0B000000, 0], np.uint32)
        _same(tdev, jdev, ips, repr(mapping))
        jpol, tpol = _policies(4)
        _same(tlpm.specialize_ipcache_to_idx(tdev, tpol),
              jlpm.specialize_ipcache_to_idx(jdev, jpol), ips,
              f"idx {mapping!r}")


@pytest.mark.parametrize("n_ranges", [30, 600])
def test_lpm_builder_tables_match_jax(n_ranges):
    """The listener's tables (LPMBuilder.tables()): bucketized, or
    DIR-24-8 past MAX_RANGES ranges."""
    _need_jax()
    mapping = _mapping(seed=9, n_exact=100, plens=(16, 20, 24),
                       n_ranges=n_ranges)
    tb, jb = tlpm.LPMBuilder(), jlpm.LPMBuilder()
    for cidr, ident in mapping.items():
        tb("upsert", cidr, None, None, None, ident)
        jb("upsert", cidr, None, None, None, ident)
    tb("delete", next(iter(mapping)), None, None, None, 0)
    jb("delete", next(iter(mapping)), None, None, None, 0)
    tdev, jdev = tb.tables(), jb.tables()
    assert isinstance(tdev, tlpm.IPCacheDevice) == (n_ranges < 512)
    assert_same_leaves(tdev, jdev, "builder")
    ips = _addresses(mapping, 3, 500)
    if isinstance(tdev, tlpm.IPCacheDevice):
        _same(tdev, jdev, ips, "builder")
    else:
        got = tlpm.lpm_lookup(convert.lpm_to(tdev, "cpu"), ips, device="cpu")
        want = np.asarray(jax.jit(jlpm._lookup_kernel)(jdev, jnp.asarray(ips)))
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_lpm_lookup_refusals():
    host = tlpm.build_ipcache({"10.0.0.0/8": 1})
    with pytest.raises(ValueError, match="ipcache tables"):
        tlpm.lpm_lookup(host, np.zeros(1, np.uint32), device="cpu")
    dev = convert.plane_to(host, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkern.IPCACHE_LOOKUP(dev, torch.zeros(2, dtype=torch.int32))


# -- on the card ----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MAPS))
def test_ipcache_lookup_matches_plain_on_card(case):
    _need_card()
    mapping = _mapping(**MAPS[case])
    host = tlpm.build_ipcache(mapping)
    forms = [host, tlpm.subword_ipcache(host)]
    ips = _addresses(mapping, 5, 100_000)
    for dev in forms:
        before = tkern.IPCACHE_LOOKUP.launches
        got = tlpm.lpm_lookup(convert.plane_to(dev, "cuda"), ips)
        torch.cuda.synchronize()
        assert tkern.IPCACHE_LOOKUP.launches == before + 1
        want = tlpm.lpm_lookup(convert.plane_to(dev, "cpu"), ips,
                               device="cpu")
        assert torch.equal(got.cpu(), want), case
