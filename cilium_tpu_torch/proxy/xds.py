"""Generic versioned-resource cache + ACK-gated observation — the
xDS machinery.

The port's own copy of the JAX package's module of the same path:
host Python, imports rewritten to cilium_tpu_torch.

Behavioral port of pkg/envoy/xds/{cache.go,set.go,
ack.go}: a Cache holds resource sets keyed (typeURL, name); every
mutation through a transaction bumps ONE monotonically increasing
version shared by all type URLs (cache.go:34-140), observers learn of
new versions (set.go ResourceVersionObserver), and `get_resources`
blocks until the cache moves past the subscriber's last-known version
— the long-poll the reference's gRPC stream performs.  The
AckingVersionObserver pattern (ack.go) is carried by
utils/completion.py's NACK-capable WaitGroup: `wait_for_version`
completes a Completion when an observer acknowledges having applied a
version, which is exactly how the proxy's redirect publication gates
table flips.

The Proxy publishes every installed redirect's compiled matcher
generation into the shared cache (type URL per parser), so
out-of-band consumers (tests, tooling, a future NPDS server) observe
the same versioned view Envoy would."""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple


class Cache:
    """pkg/envoy/xds/cache.go — versioned resource sets."""

    def __init__(self) -> None:
        self._lock = threading.Condition()
        # typeURL → {name: resource}
        self._resources: Dict[str, Dict[str, object]] = {}
        # typeURL → version of the last tx that changed that set
        self._type_versions: Dict[str, int] = {}
        self._version = 0  # cache-wide, monotonically increasing
        self._observers: Dict[str, List[Callable[[str, int], None]]] = {}

    # -- transactions (cache.go tx) -----------------------------------------

    def _tx(
        self,
        typeurl: str,
        upserts: Dict[str, object],
        deletes: Tuple[str, ...],
        force: bool = False,
    ) -> Tuple[int, bool]:
        with self._lock:
            res = self._resources.setdefault(typeurl, {})
            updated = False
            for name, resource in upserts.items():
                if force or res.get(name) is not resource:
                    res[name] = resource
                    updated = True
            for name in deletes:
                if name in res:
                    del res[name]
                    updated = True
            if not updated and not force:
                return self._version, False
            self._version += 1
            self._type_versions[typeurl] = self._version
            version = self._version
            observers = list(self._observers.get(typeurl, ()))
            self._lock.notify_all()
        for observer in observers:
            observer(typeurl, version)
        return version, True

    def upsert(self, typeurl: str, name: str, resource,
               force: bool = False) -> Tuple[int, bool]:
        return self._tx(typeurl, {name: resource}, (), force)

    def delete(self, typeurl: str, name: str) -> Tuple[int, bool]:
        return self._tx(typeurl, {}, (name,))

    def clear(self, typeurl: str) -> Tuple[int, bool]:
        with self._lock:
            names = tuple(self._resources.get(typeurl, ()))
        return self._tx(typeurl, {}, names)

    def lookup(self, typeurl: str, name: str):
        with self._lock:
            return self._resources.get(typeurl, {}).get(name)

    def version(self) -> int:
        with self._lock:
            return self._version

    # -- observation (set.go) ------------------------------------------------

    def add_observer(
        self, typeurl: str, observer: Callable[[str, int], None]
    ) -> None:
        with self._lock:
            self._observers.setdefault(typeurl, []).append(observer)

    # -- the stream read (cache.go GetResources) -----------------------------

    def get_resources(
        self,
        typeurl: str,
        last_version: Optional[int] = None,
        names: Optional[List[str]] = None,
        timeout: Optional[float] = None,
    ) -> Optional[Tuple[int, Dict[str, object]]]:
        """Current (version, resources) for a type URL; with
        `last_version`, BLOCKS until that type's set has changed past
        it (the gRPC stream's deferred response, cache.go:184-240).
        None on timeout."""
        import time as _time

        deadline = (
            None if timeout is None else _time.monotonic() + timeout
        )
        with self._lock:
            while (
                last_version is not None
                and self._type_versions.get(typeurl, 0) <= last_version
            ):
                remaining = (
                    None
                    if deadline is None
                    else deadline - _time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return None
                self._lock.wait(timeout=remaining)
            res = dict(self._resources.get(typeurl, {}))
            if names is not None:
                res = {n: res[n] for n in names if n in res}
            return self._version, res


def wait_for_version(
    cache: Cache,
    typeurl: str,
    version: int,
    wait_group,
) -> None:
    """AckingVersionObserver (ack.go): adds a Completion to the wait
    group that completes once an observer reports the cache reaching
    `version` for `typeurl` — the NACK-capable ACK gate the daemon's
    regeneration waits on."""
    completion = wait_group.add_completion()
    done = threading.Event()

    def observer(t: str, v: int) -> None:
        if v >= version and not done.is_set():
            done.set()
            completion.complete()

    cache.add_observer(typeurl, observer)
    # the version may already be reached (observer registered late)
    if cache.version() >= version:
        if not done.is_set():
            done.set()
            completion.complete()
