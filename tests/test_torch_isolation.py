"""The PyTorch port stands alone: importing it loads neither JAX nor
any module of cilium_tpu, no source of it names either, and its entry
points never fall back to the CPU on their own."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "cilium_tpu_torch"

# `cilium_tpu.` (a submodule) and `from/import cilium_tpu` as a whole
# word, never cilium_tpu_torch
_FORBIDDEN = re.compile(
    r"cilium_tpu\.|from\s+cilium_tpu\s+import|import\s+cilium_tpu\b(?!_)"
    r"|import\s+jax\b|from\s+jax\b"
)


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_import_loads_no_jax_and_no_reference_module():
    """A fresh interpreter imports every module of the port; neither
    jax nor any cilium_tpu.* module may end up in sys.modules."""
    mods = list(_modules())
    for m in ("cilium_tpu_torch.kernels", "cilium_tpu_torch.replay",
              "cilium_tpu_torch.ct.device", "cilium_tpu_torch.convert",
              "cilium_tpu_torch.engine.datapath6",
              "cilium_tpu_torch.ipcache.lpm6", "cilium_tpu_torch.lb.device6",
              "cilium_tpu_torch.tunnel", "cilium_tpu_torch.prng",
              "cilium_tpu_torch.telemetry", "cilium_tpu_torch.metrics",
              "cilium_tpu_torch.spanstat",
              "cilium_tpu_torch.monitor.events", "cilium_tpu_torch.labels",
              "cilium_tpu_torch.identity", "cilium_tpu_torch.policy.repository",
              "cilium_tpu_torch.compiler.mapstate",
              "cilium_tpu_torch.l7.memcached", "cilium_tpu_torch.proxy.proxy",
              "cilium_tpu_torch.logging", "cilium_tpu_torch.option",
              "cilium_tpu_torch.compiler.selectorcache",
              "cilium_tpu_torch.ipcache.ipcache",
              "cilium_tpu_torch.ipcache.cidr", "cilium_tpu_torch.endpoint",
              "cilium_tpu_torch.endpoint.endpoint",
              "cilium_tpu_torch.endpoint.manager",
              "cilium_tpu_torch.endpoint.checkpoint",
              "cilium_tpu_torch.policy.trace", "cilium_tpu_torch.daemon",
              "cilium_tpu_torch.shadow", "cilium_tpu_torch.tracing",
              "cilium_tpu_torch.monitor", "cilium_tpu_torch.monitor.bus",
              "cilium_tpu_torch.monitor.dissect", "cilium_tpu_torch.flow",
              "cilium_tpu_torch.flow.store", "cilium_tpu_torch.flow.capture"):
        assert m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'cilium_tpu'\n"
        "             or m.startswith('cilium_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_name_neither_jax_nor_the_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert PKG / "replay.py" in files
    for path in files:
        text = path.read_text()
        hit = _FORBIDDEN.search(text)
        assert hit is None, f"{path.relative_to(ROOT)}: {hit.group(0)!r}"
    # the pattern itself catches what it must and spares the port's name
    assert _FORBIDDEN.search("from cilium_tpu.engine import datapath")
    assert _FORBIDDEN.search("import cilium_tpu")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from cilium_tpu_torch import world")
    assert not _FORBIDDEN.search("import cilium_tpu_torch.kernels")


def test_entry_points_default_to_the_card():
    """device=None means the card: without one it raises instead of
    quietly running on the CPU; with one the tables land on it.  The
    lattice's entry points (evaluate_batch, evaluate_batch_from_ips,
    lpm_lookup, replay_lattice) take device=None the same way."""
    import numpy as np

    from cilium_tpu_torch import world
    from cilium_tpu_torch.convert import lpm_to, policy_tables_to, tables_to
    from cilium_tpu_torch.device import resolve_device
    from cilium_tpu_torch.engine.verdict import (
        TupleBatch,
        evaluate_batch,
        evaluate_batch_from_ips,
    )
    from cilium_tpu_torch.ipcache.lpm import build_lpm, lpm_lookup
    from cilium_tpu_torch.native.loader import encode_flow_records
    from cilium_tpu_torch.replay import replay_lattice

    ex = world.example_world(batch=16)
    pol = policy_tables_to(ex.policy_tables(), "cpu")
    batch = TupleBatch.from_numpy(**ex.tuples, device="cpu")
    lpm = lpm_to(build_lpm({"10.0.0.0/8": 256}), "cpu")
    ips = np.full(16, 0x0A000001, np.uint32)
    buf = encode_flow_records(
        ep_id=ex.tuples["ep_index"], identity=ex.tuples["identity"],
        saddr=ips, daddr=ips, sport=np.zeros(16), dport=ex.tuples["dport"],
        proto=ex.tuples["proto"], direction=ex.tuples["direction"],
        is_fragment=np.zeros(16))
    calls = [
        lambda d: evaluate_batch(pol, batch, device=d),
        lambda d: evaluate_batch_from_ips(
            lpm, pol, torch.from_numpy(ips.view(np.int32)), batch, device=d),
        lambda d: lpm_lookup(lpm, ips, device=d),
        lambda d: replay_lattice(pol, buf, 8, device=d),
        lambda d: TupleBatch.from_numpy(**ex.tuples, device=d),
    ]
    for call in calls:
        if torch.cuda.is_available():
            # the CPU inputs are refused on the card, never run there
            if call is not calls[-1]:
                with pytest.raises(ValueError, match="must be tensors on"):
                    call(None)
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call(None)
        assert call("cpu") is not None

    w = world.make_world(
        seed=1, n_rules=50, n_endpoints=2, n_identities=64, n_cidr_blocks=4,
        n_vips=2, n_pool=200, ct_max_entries=256, identity_pad=64,
        filter_pad=16,
    )
    host = world.headline_tables(w)
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert tables_to(host).ct.buckets.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tables_to(host)
    assert tables_to(host, "cpu").ct.buckets.device.type == "cpu"


def test_policy_plane_defaults_to_the_card():
    """Daemon, EndpointManager and DeviceTableStore take device=None as
    the card: without one the daemon and the store raise, and the
    manager's first device publish raises; device="cpu" runs."""
    from cilium_tpu_torch import world
    from cilium_tpu_torch.daemon import Daemon
    from cilium_tpu_torch.endpoint import EndpointManager
    from cilium_tpu_torch.engine.publish import DeviceTableStore

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (Daemon, DeviceTableStore):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    rw = world.rules_world(seed=1, n_rules=40, n_endpoints=2,
                           n_identities=32, device="cpu")
    em = EndpointManager()
    for e in rw.daemon.endpoint_manager.endpoints():
        em.insert(e)
    em.publish_tables(rw.daemon.identity_cache())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        em.published_device()
    dev = rw.daemon.endpoint_manager.published_device()[1]
    assert dev.l4_meta.device.type == "cpu"


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without CUDA,
    and also from a directory that holds nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in (
        (ROOT, ROOT / "chip_smoke.py"),
        (tmp_path, tmp_path / "chip_smoke.py"),
    ):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        proc = subprocess.run(
            [sys.executable, str(script)], cwd=str(cwd), env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
