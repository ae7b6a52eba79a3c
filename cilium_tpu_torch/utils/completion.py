"""WaitGroup-with-deadline for ACK-gated publication.

The port's own copy of the JAX package's module of the same path:
host Python, imports rewritten to cilium_tpu_torch.

Port of pkg/completion: policy regeneration blocks on
proxy ACKs (pkg/envoy/xds/ack.go) with a timeout
(EndpointGenerationTimeout, pkg/endpoint/bpf.go:442); the same
pattern gates device table flips on consumer acknowledgment.
"""

from __future__ import annotations

import threading
from typing import List, Optional


class Completion:
    def __init__(self) -> None:
        self._event = threading.Event()
        self._failed = False

    def complete(self) -> None:
        self._event.set()

    def fail(self) -> None:
        """NACK (xds/ack.go's NACK path): the waiter returns False
        immediately instead of blocking out the timeout."""
        self._failed = True
        self._event.set()

    @property
    def completed(self) -> bool:
        return self._event.is_set() and not self._failed

    @property
    def failed(self) -> bool:
        return self._failed


class WaitGroup:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._completions: List[Completion] = []

    def add_completion(self) -> Completion:
        c = Completion()
        with self._lock:
            self._completions.append(c)
        return c

    def wait(self, timeout: Optional[float] = None) -> bool:
        """True when every completion finished in time; False on
        timeout (the caller keeps old state and retries, like failed
        regenerations, pkg/endpoint/policy.go:770-775)."""
        import time

        deadline = None if timeout is None else time.time() + timeout
        with self._lock:
            completions = list(self._completions)
        for c in completions:
            remaining = (
                None if deadline is None else max(0.0, deadline - time.time())
            )
            if not c._event.wait(timeout=remaining):
                return False
            if c.failed:
                return False
        return True

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._completions)
