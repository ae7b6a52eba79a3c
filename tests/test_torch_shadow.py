"""The PyTorch port's shadow diff on the CPU against the JAX package's:
`diff_codes` (the jitted `shadow.diff` and its numpy form) over the
full value grid, `compile_candidate_world` on config 5's recipe from
rules at a small size (tables, index and states), the diff of the live
and candidate worlds through the lattice against the reference's and
the oracle's, and the diff record's helpers.  Every comparison is
exact.

The cuda-marked test holds SHADOW_DIFF against its plain version on
the card; it needs no JAX and skips here:

    python -m pytest --noconftest tests/test_torch_shadow.py -q -m cuda
"""

import argparse
import itertools
import os
import shutil

import numpy as np
import pytest
import torch

from cilium_tpu_torch import shadow as tsh
from cilium_tpu_torch import world
from cilium_tpu_torch.convert import policy_tables_to
from cilium_tpu_torch.engine.oracle import evaluate_batch_oracle
from cilium_tpu_torch.engine.verdict import TupleBatch, evaluate_batch

try:
    import jax
    import jax.numpy as jnp

    import bench
    from cilium_tpu import shadow as jsh
    from cilium_tpu.engine import verdict as jv
    from cilium_tpu.labels import LabelArray as JLabelArray
    from cilium_tpu.policy import api as japi
    from torch_parity import assert_same_states as assert_states_equal
    from torch_parity import assert_same_tables_low32 as assert_tables_equal
except ImportError:  # the card's machine has no JAX: only cuda tests run
    jax = None

ALLOWED = (0, 1, 2, 255)
PROXY = (-1, 0, 1, 65535, 70000)
KINDS = (0, 1, 2, 3, 4, 255)
SMALL = dict(n_rules=600, n_endpoints=4, n_identities=256)


def _need_jax():
    if jax is None:
        pytest.skip("JAX is not installed")


def _grid():
    """Every (live, shadow) pair of (allowed, proxy, kind) values."""
    side = list(itertools.product(ALLOWED, PROXY, KINDS))
    rows = np.asarray([a + b for a, b in itertools.product(side, side)],
                      np.int64)
    return (rows[:, 0].astype(np.uint8), rows[:, 1].astype(np.int32),
            rows[:, 2].astype(np.uint8), rows[:, 3].astype(np.uint8),
            rows[:, 4].astype(np.int32), rows[:, 5].astype(np.uint8))


def test_diff_codes_full_grid_matches_reference():
    _need_jax()
    cols = _grid()
    want = jax.jit(lambda *c: jsh.diff_codes(*c, xp=jnp))(*cols)
    want_np = jsh.diff_codes(*cols, xp=np)
    got_plain = tsh.diff_codes_plain(*(torch.from_numpy(c) for c in cols))
    got_entry = tsh.diff_codes(*(torch.from_numpy(c) for c in cols))
    got_np = tsh.diff_codes_np(*cols)
    for k in range(4):
        w = np.asarray(want[k])
        assert w.dtype == np.uint8
        assert np.array_equal(w, want_np[k])
        for got in (got_plain[k].numpy(), got_entry[k].numpy(), got_np[k]):
            assert got.dtype == np.uint8
            assert np.array_equal(got, w), k
    # every transition occurs on the grid
    assert set(np.unique(got_np[3]).tolist()) == {0, 1, 2, 3}


def test_diff_codes_refuses_mixed_devices():
    cols = [torch.zeros(4, dtype=torch.uint8)] * 6
    cols[1] = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        tsh.diff_codes(*cols)


def test_constants_and_record_helpers_match_reference():
    _need_jax()
    assert tsh.TRANS_NAMES == jsh.TRANS_NAMES
    assert tsh.DIFF_COLUMNS == jsh.DIFF_COLUMNS
    for allowed, kind in itertools.product((0, 1), range(6)):
        assert tsh._drop_reason_of(allowed, kind) == jsh._drop_reason_of(
            allowed, kind)
    for gen in (0, 5, (7 << 32) | 3, np.uint64((1 << 63) | 9)):
        assert tsh._norm_stamp(gen) == jsh._norm_stamp(gen)
    kw = dict(ts=1.5, ep_id=100, src_identity=300, dst_identity=0, dport=80,
              proto=6, direction=1, live_allowed=True, shadow_allowed=False,
              live_match_kind=1, shadow_match_kind=0, live_proxy_port=0,
              shadow_proxy_port=0, transition="allow_to_deny",
              shadow_reason="Policy denied")
    assert tsh.DiffRecord(**kw).to_dict() == jsh.DiffRecord(**kw).to_dict()


def test_compile_candidate_world_and_diff_match_reference():
    """The candidate world of both packages, leaf for leaf, then the
    lattice over the live and candidate worlds and the diff: the port's
    (plain versions) against the jitted reference and the numpy diff of
    the oracle's verdicts; the candidate changes rows."""
    _need_jax()
    args = argparse.Namespace(rules=SMALL["n_rules"],
                              endpoints=SMALL["n_endpoints"],
                              identities=SMALL["n_identities"], pool=1000)
    ref = bench.build_config5(args, np.random.default_rng(5))[0]
    ref.policy_trigger.close(wait=True)
    rw = world.rules_world(seed=5, device="cpu", **SMALL)
    cand_ref = world.restricting_rule(rw.rules, 4321, japi, JLabelArray)
    cand = world.restricting_rule(rw.rules, 4321)
    assert repr(cand_ref) == repr(cand)
    t_ref, i_ref, s_ref = jsh.compile_candidate_world(ref, [cand_ref])
    t, i, s = tsh.compile_candidate_world(rw.daemon, [cand])
    assert i == i_ref == rw.index
    assert_tables_equal(t_ref, t)
    for a, b in zip(s_ref, s):
        assert_states_equal(a, b)
    # the live daemon is untouched
    assert len(rw.daemon.repo.rules) == SMALL["n_rules"]

    cols = world.rules_tuples(rw, 6000, seed=3)
    live_dev = policy_tables_to(rw.tables, "cpu")
    cand_dev = policy_tables_to(t, "cpu")
    batch = TupleBatch.from_numpy(**cols, device="cpu")
    lv = evaluate_batch(live_dev, batch, device="cpu")
    cv = evaluate_batch(cand_dev, batch, device="cpu")
    got = tsh.diff_codes(lv.allowed, lv.proxy_port, lv.match_kind,
                         cv.allowed, cv.proxy_port, cv.match_kind)

    _, live_ref, _ = ref.endpoint_manager.published()
    jb = jv.TupleBatch.from_numpy(**cols)
    jl = jv.evaluate_batch(live_ref, jb)
    jc = jv.evaluate_batch(t_ref, jb)
    want = jax.jit(lambda *c: jsh.diff_codes(*c, xp=jnp))(
        jl.allowed, jl.proxy_port, jl.match_kind,
        jc.allowed, jc.proxy_port, jc.match_kind)
    for k in range(4):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    oracle = [evaluate_batch_oracle(states, cols["ep_index"],
                                    cols["identity"], cols["dport"],
                                    cols["proto"], cols["direction"],
                                    cols["is_fragment"])
              for states in (rw.states, s)]
    want_np = tsh.diff_codes_np(*oracle[0], *oracle[1])
    for k in range(4):
        assert np.array_equal(got[k].numpy(), want_np[k]), k
    trans = got[3].numpy()
    assert (trans == tsh.TRANS_ALLOW_TO_DENY).sum() > 0


@pytest.mark.cuda
def test_shadow_diff_kernel_matches_plain():
    """SHADOW_DIFF against its plain version: the full grid, a random
    draw of a ragged length, and unaligned column views (the row by
    row path)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        pytest.skip("no nvcc to build the kernel")
    from cilium_tpu_torch import kernels

    rng = np.random.default_rng(1)
    n = 100_003
    rand = (rng.choice(ALLOWED, n).astype(np.uint8),
            rng.choice(PROXY, n).astype(np.int32),
            rng.choice(KINDS, n).astype(np.uint8),
            rng.choice(ALLOWED, n).astype(np.uint8),
            rng.choice(PROXY, n).astype(np.int32),
            rng.choice(KINDS, n).astype(np.uint8))
    for cols in (_grid(), rand):
        for start in (0, 1):
            dev = [torch.from_numpy(c).cuda()[start:] for c in cols]
            before = kernels.SHADOW_DIFF.launches
            got = tsh.diff_codes(*dev)
            want = tsh.diff_codes_plain(*(c.cpu() for c in dev))
            torch.cuda.synchronize()
            assert kernels.SHADOW_DIFF.launches == before + 1
            for g, w in zip(got, want):
                assert g.dtype == torch.uint8
                assert torch.equal(g.cpu(), w)
    with pytest.raises(ValueError, match="dtype"):
        kernels.SHADOW_DIFF(*(torch.zeros(8, dtype=torch.int32,
                                          device="cuda") for _ in range(6)))
