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
    # the dense lattice inside the datapath is not implemented
    dense = dataclasses.replace(tables, policy=dataclasses.replace(
        tables.policy, l4_hash_rows=None))
    with pytest.raises(ValueError, match="dense lattice"):
        kernels.DATAPATH_PAIR(dense, pair.cuda(), acc, tel)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.DATAPATH_PAIR(tables, pair, acc, tel)
