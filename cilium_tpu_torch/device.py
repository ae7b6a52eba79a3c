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
