"""Device choice and u32 word storage for the PyTorch port.

Every u32 table leaf and u32 output column is carried as a
`torch.int32` tensor holding the same 32 bits: `np_u32.view(np.int32)`
on the way in, `.numpy().view(np.uint32)` on the way out.  The CUDA
kernel reads these buffers as `const uint32_t*`.

`torch.uint32` is not used: on the CPU it lacks `+`, `>>`, `<<`, `>`,
`%`, `gather` and `index_put`, and `int32 >>` is an arithmetic shift.
So the plain (CPU-capable) versions widen to `int64` and mask with
`MASK32` after every multiply and left shift.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def resolve_device(device=None) -> torch.device:
    """`None` means the card.  Without a card this raises: an entry
    point never quietly falls back to the CPU — callers that want the
    plain version pass `device="cpu"` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run "
            "the plain PyTorch version"
        )
    return dev


def u32_tensor(arr, device) -> torch.Tensor:
    """numpy u32 (or anything castable to it) -> int32 tensor with the
    same bits, on `device`."""
    a = np.ascontiguousarray(np.asarray(arr).astype(np.uint32, copy=False))
    t = torch.from_numpy(a.view(np.int32))
    # never alias the caller's array: a device copy or a CPU clone
    return t.clone() if torch.device(device).type == "cpu" else t.to(device)


def array_tensor(arr, device) -> torch.Tensor:
    """numpy array -> tensor on `device`: u32 as int32 with the same
    bits (see u32_tensor), every other dtype kept; never aliases the
    caller's array."""
    a = np.asarray(arr)
    if a.dtype == np.uint32:
        return u32_tensor(a, device)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.clone() if torch.device(device).type == "cpu" else t.to(device)


def widen(t: torch.Tensor) -> torch.Tensor:
    """u32 bits in any integer tensor -> int64 holding the unsigned
    value in [0, 2^32)."""
    return t.to(torch.int64) & MASK32


def narrow(t: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 value -> int32 tensor with the same bits."""
    v = t & MASK32
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def on_device(t, dev: torch.device) -> bool:
    """Whether `t` is a tensor on `dev` (a CUDA device without an
    index means the current one)."""
    if not isinstance(t, torch.Tensor) or t.device.type != dev.type:
        return False
    if dev.type != "cuda":
        return True
    want = torch.cuda.current_device() if dev.index is None else dev.index
    return t.device.index == want


def require_on(t, dev: torch.device, what: str) -> None:
    """Raise unless `t` is a tensor on `dev`; `what` names the input and
    how to move it there."""
    if not on_device(t, dev):
        where = t.device if isinstance(t, torch.Tensor) else type(t).__name__
        raise ValueError(f"{what} must be tensors on {dev}, got {where}")


def tensor_on(x, dev: torch.device, name: str) -> torch.Tensor:
    """An entry point's array input on `dev`: a numpy array (or
    anything numpy takes) is uploaded, u32 as int32 bits; a tensor must
    already lie there."""
    if isinstance(x, torch.Tensor):
        require_on(x, dev, name)
        return x
    return array_tensor(x, dev)


def table_device(leaf, what: str) -> torch.device:
    """The device of a table set, read from one of its leaves; tables
    still in numpy raise (move them with `convert` first)."""
    if not isinstance(leaf, torch.Tensor):
        raise ValueError(
            f"{what} are {type(leaf).__name__}s, not tensors: move them "
            "to a device with convert first"
        )
    return leaf.device
