"""Endpoint checkpoint / restore.

The port's own copy of the JAX package's endpoint/checkpoint.py.

Re-design of the reference's state-dir persistence: per-endpoint JSON
(the C header file becomes the serialized realized map state — config
IS data here, not generated code) written via the current→next→failed
directory shuffle of pkg/endpoint/policy.go:738-775, and boot-time
restore (daemon/state.go restoreOldEndpoints: re-allocate identities
from labels, mark restoring, regenerate).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import List, Optional

from cilium_tpu_torch.endpoint.endpoint import (
    STATE_RESTORING,
    STATE_WAITING_TO_REGENERATE,
    Endpoint,
)
from cilium_tpu_torch.identity import IdentityAllocator
from cilium_tpu_torch.labels import labels_from_json
from cilium_tpu_torch.maps.policymap import (
    PolicyKey,
    PolicyMapState,
    PolicyMapStateEntry,
)

STATE_FILE = "ep_state.json"

# Checkpoint schema version — the analog of the reference's pinned-map
# schema that bpf/cilium-map-migrate.c migrates on upgrade (init.sh
# runs it before the agent attaches).  History:
#   0: round-1 shape — no version stamp, no realized_redirects, map
#      entries without packets/bytes counters;
#   1: adds the explicit version stamp, realized_redirects, and
#      per-entry packets/bytes;
#   2: adds per-endpoint runtime options ("opts" — `cilium endpoint
#      config` state, which is compiled datapath state in the
#      reference and must survive restarts).
# A checkpoint newer than SCHEMA_VERSION is NOT restored (a downgraded
# agent must not guess at fields it does not know), mirroring
# map-migrate refusing unknown map properties.
SCHEMA_VERSION = 2

# version k → pure doc→doc migration producing version k+1
_MIGRATIONS = {}


def _migration(frm: int):
    def register(fn):
        _MIGRATIONS[frm] = fn
        return fn

    return register


@_migration(0)
def _v0_to_v1(doc: dict) -> dict:
    """Round-1 checkpoints: stamp the version, default the fields
    later rounds added (redirects; per-entry counters)."""
    doc = dict(doc)
    doc["version"] = 1
    doc.setdefault("realized_redirects", {})
    doc["realized_map_state"] = [
        {**{"packets": 0, "bytes": 0}, **item}
        for item in doc.get("realized_map_state", [])
    ]
    return doc


@_migration(1)
def _v1_to_v2(doc: dict) -> dict:
    doc = dict(doc)
    doc["version"] = 2
    doc.setdefault("opts", {})
    return doc


class CheckpointTooNew(ValueError):
    """Checkpoint written by a NEWER framework version."""


def migrate_doc(doc: dict) -> dict:
    """Apply registered migrations until the doc reaches
    SCHEMA_VERSION (missing stamp ⇒ version 0)."""
    version = int(doc.get("version", 0))
    if version > SCHEMA_VERSION:
        raise CheckpointTooNew(
            f"checkpoint version {version} > supported "
            f"{SCHEMA_VERSION}"
        )
    while version < SCHEMA_VERSION:
        fn = _MIGRATIONS.get(version)
        if fn is None:
            raise ValueError(
                f"no migration registered from version {version}"
            )
        doc = fn(doc)
        version = int(doc["version"])
    return doc


def migrate_state_dir(state_dir: str) -> int:
    """Rewrite old-version checkpoints in place (the init.sh
    map-migrate moment: run once at boot, BEFORE restore).  Returns
    the number migrated; too-new or unparseable files are left
    untouched for the operator."""
    migrated = 0
    if not os.path.isdir(state_dir):
        return 0
    for entry in sorted(os.listdir(state_dir)):
        path = os.path.join(state_dir, entry, STATE_FILE)
        if not os.path.isfile(path):
            continue
        try:
            with open(path) as f:
                doc = json.load(f)
        except (ValueError, json.JSONDecodeError):
            continue
        if int(doc.get("version", 0)) == SCHEMA_VERSION:
            continue
        try:
            doc = migrate_doc(doc)
        except (CheckpointTooNew, ValueError):
            continue
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(path), prefix=".tmp_migrate"
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
            migrated += 1
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return migrated


def _map_state_to_json(state: PolicyMapState) -> list:
    return [
        {
            "identity": k.identity,
            "dest_port": k.dest_port,
            "nexthdr": k.nexthdr,
            "dir": k.traffic_direction,
            "proxy_port": v.proxy_port,
            "packets": v.packets,
            "bytes": v.bytes,
        }
        for k, v in state.items()
    ]


def _map_state_from_json(items: list) -> PolicyMapState:
    return {
        PolicyKey(
            item["identity"], item["dest_port"], item["nexthdr"], item["dir"]
        ): PolicyMapStateEntry(
            proxy_port=item["proxy_port"],
            packets=item.get("packets", 0),
            bytes=item.get("bytes", 0),
        )
        for item in items
    }


def save_endpoint(endpoint: Endpoint, state_dir: str) -> str:
    """Write <state_dir>/<ep id>/ep_state.json atomically (write to a
    temp file, rename — the reference's directory-shuffle transaction
    reduced to a file swap)."""
    ep_dir = os.path.join(state_dir, str(endpoint.id))
    os.makedirs(ep_dir, exist_ok=True)
    doc = {
        "version": SCHEMA_VERSION,
        "id": endpoint.id,
        "name": endpoint.name,
        "ipv4": endpoint.ipv4,
        "labels": (
            [
                {"key": l.key, "value": l.value, "source": l.source}
                for l in endpoint.security_identity.labels.values()
            ]
            if endpoint.security_identity
            else []
        ),
        "policy_revision": endpoint.policy_revision,
        "realized_map_state": _map_state_to_json(
            endpoint.realized_map_state
        ),
        "realized_redirects": endpoint.realized_redirects,
        "opts": dict(endpoint.opts),
    }
    fd, tmp = tempfile.mkstemp(dir=ep_dir, prefix=".tmp_state")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, os.path.join(ep_dir, STATE_FILE))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return os.path.join(ep_dir, STATE_FILE)


def restore_endpoints(
    state_dir: str, allocator: Optional[IdentityAllocator] = None
) -> List[Endpoint]:
    """restoreOldEndpoints (daemon/state.go): parse the state dir,
    re-allocate identities from the checkpointed labels (ids may
    change across restarts — the labels are the durable key), mark
    restoring → waiting-to-regenerate.  Unparseable directories are
    skipped, as the reference skips and logs."""
    endpoints: List[Endpoint] = []
    if not os.path.isdir(state_dir):
        return endpoints
    for entry in sorted(os.listdir(state_dir)):
        path = os.path.join(state_dir, entry, STATE_FILE)
        if not os.path.isfile(path):
            continue
        try:
            with open(path) as f:
                doc = json.load(f)
            doc = migrate_doc(doc)
            endpoint = Endpoint(
                endpoint_id=int(doc["id"]),
                ipv4=doc.get("ipv4"),
                name=doc.get("name", ""),
            )
            endpoint.set_state(STATE_RESTORING, "restoring")
            # policy_revision round-trips for observability only; the
            # regeneration gate reads next_policy_revision, which is
            # deliberately NOT restored — a fresh daemon regenerates
            # restored endpoints unconditionally (daemon/state.go
            # regenerateRestoredEndpoints), since the checkpointed
            # revision belongs to the old daemon's repo numbering
            endpoint.policy_revision = doc.get("policy_revision", 0)
            endpoint.realized_map_state = _map_state_from_json(
                doc.get("realized_map_state", [])
            )
            endpoint.realized_redirects = dict(
                doc.get("realized_redirects", {})
            )
            endpoint.opts.update(
                {
                    k: bool(v)
                    for k, v in doc.get("opts", {}).items()
                }
            )
            if allocator is not None and doc.get("labels"):
                ident, _ = allocator.allocate(
                    labels_from_json(doc["labels"])
                )
                endpoint.set_identity(ident)
            endpoint.set_state(
                STATE_WAITING_TO_REGENERATE, "restored"
            )
            endpoints.append(endpoint)
        except (ValueError, KeyError, json.JSONDecodeError):
            # includes CheckpointTooNew (a ValueError): a downgraded
            # agent must not guess at unknown fields
            continue
    return endpoints
