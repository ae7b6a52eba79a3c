"""Batch dispatch: the double-buffered async pipeline and the pow2 size
class (the reference's engine/publish.py `AsyncBatchDispatcher` and
`next_pow2`).  The device table store of that module
(`DeviceTableStore`, its epochs and delta scatters) is not here yet.
"""

from __future__ import annotations

from collections import deque

import torch


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    size = 1
    while size < n:
        size <<= 1
    return size


def _has_cuda_tensor(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(_has_cuda_tensor(o) for o in out)
    if isinstance(out, dict):
        return any(_has_cuda_tensor(o) for o in out.values())
    fields = getattr(out, "__dataclass_fields__", None)
    if fields:
        return any(_has_cuda_tensor(getattr(out, f)) for f in fields)
    return False


class AsyncBatchDispatcher:
    """A bounded staging pipeline that overlaps the host pack of batch
    N + 1 with the device compute of batch N.

      * `submit(host_args, meta)` runs `pack_fn` (encode and upload, the
        host half) and `dispatch_fn` (the launches, which return before
        the device finishes), then drains the batches beyond `depth` in
        FIFO order: up to `depth + 1` batches are in flight.
      * results come back through submit()/flush() as `(meta, result,
        exc)` tuples in submission order.
      * a failure at pack, dispatch or drain is captured as that
        batch's `exc` instead of stopping the pipeline.

    Draining waits on a CUDA event recorded on the current stream right
    after the batch's dispatch (results on the CPU are complete when
    dispatch returns)."""

    def __init__(self, pack_fn, dispatch_fn, depth: int = 1) -> None:
        self.pack_fn = pack_fn
        self.dispatch_fn = dispatch_fn
        self.depth = max(int(depth), 0)
        self._pending = deque()
        self.submitted = 0
        self.failed = 0

    def _drain_one(self):
        meta, out, exc, event = self._pending.popleft()
        if exc is None and event is not None:
            try:
                event.synchronize()
            except Exception as drain_exc:  # the device failed mid-compute
                out, exc = None, drain_exc
                self.failed += 1
        return meta, out, exc

    def submit(self, host_args: tuple, meta=None) -> list:
        """Stage and dispatch one batch; returns the drained (meta,
        result, exc) tuples that completed (possibly none)."""
        self.submitted += 1
        out, exc, event = None, None, None
        try:
            out = self.dispatch_fn(*self.pack_fn(*host_args))
            if _has_cuda_tensor(out):
                event = torch.cuda.Event()
                event.record()
        except Exception as batch_exc:  # pack or dispatch
            out, exc = None, batch_exc
            self.failed += 1
        self._pending.append((meta, out, exc, event))
        done = []
        while len(self._pending) > self.depth:
            done.append(self._drain_one())
        return done

    def flush(self) -> list:
        """Drain every batch in flight, in order."""
        done = []
        while self._pending:
            done.append(self._drain_one())
        return done
