"""The threefry2x32 draw of the churn loop's uniform picks.

The reference draws an int-pick batch as
`randint(fold_in(PRNGKey(len(ct) ^ n), batch), (B,), 0, P, uint32)`
under jax's default PRNG, threefry2x32, with `jax_threefry_partitionable`
on (its default since jax 0.5).  This module is the port's own copy of
that path, so an int-pick `replay_pool` draws the reference's picks:

  * `threefry2x32(k0, k1, x0, x1)`: 20 rounds, rotations
    (13, 15, 26, 6) and (17, 29, 16, 24), a key injection every 4;
  * `prng_key(seed)`: `PRNGKey` of a Python int as the reference runs
    it, without x64 (it never enables it): the seed is cut to its low
    32 bits, so the key is (0, seed mod 2^32) for any seed, above 2^32
    or negative too (with x64 jax would split a 64-bit seed into two
    words instead);
  * `fold_in(key, data)`: threefry of the counter pair (0, data u32);
  * `split(key)`: the partitionable split, threefry of the counters
    (0, 0) and (0, 1), one pair of output words per subkey;
  * `random_bits(key, n)`: the partitionable bits, threefry of the
    counter (hi, lo) of each index i (i >> 32, i & 0xFFFFFFFF), the two
    output words XORed;
  * `randint_u32(key, n, span)`: `randint` with minval 0 and dtype
    uint32: hi from split's first subkey, lo from its second, then
    `((hi % span) * m + lo % span) % span` with
    `m = (2^16 % span)^2 % span`, all in u32 with wraparound: the
    square wraps to 0 once span passes 65,536 (so then only `lo`
    counts), and the product can wrap below that.

The key derivations are host integer code.  `randint_u32` on a CUDA
device launches PICK_DRAW (kernels.py, csrc/prng.cu); on the CPU it
runs `randint_u32_plain`, which works on int64 tensors masked to 32
bits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cilium_tpu_torch.device import MASK32, narrow, resolve_device

ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter words (x0, x1) under the key
    (k0, k1): Python ints or int64 tensors holding u32 values (the key
    words may be ints beside tensor counters).  Returns (y0, y1)."""
    ks = (k0, k1, (k0 ^ k1 ^ KS_PARITY) & MASK32)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int) -> Key:
    """`PRNGKey(seed)` of a Python int (threefry_seed without x64)."""
    return 0, seed & MASK32


def fold_in(key: Key, data: int) -> Key:
    return threefry2x32(key[0], key[1], 0, data & MASK32)


def split(key: Key) -> Tuple[Key, Key]:
    """The two subkeys of the partitionable `split(key)`."""
    a0, a1 = threefry2x32(key[0], key[1], 0, 0)
    b0, b1 = threefry2x32(key[0], key[1], 0, 1)
    return (a0, a1), (b0, b1)


def random_bits(key: Key, n: int, device="cpu") -> torch.Tensor:
    """32-bit partitionable random bits [n] as int64 u32 values."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key[0], key[1], i >> 32, i & MASK32)
    return y0 ^ y1


def randint_multiplier(span: int) -> int:
    """randint's multiplier (2^16 % span)^2 % span, the square taken in
    u32: past span 65,536 it wraps to 0, and so does the multiplier."""
    m = (1 << 16) % span
    return ((m * m) & MASK32) % span


def _span(span: int) -> int:
    span = int(span)
    if not 0 <= span <= MASK32:
        raise ValueError(f"span {span} outside the u32 range")
    return span if span > 0 else 1  # maxval <= minval: always 0


def pick_draw_plain(subkeys: Tuple[Key, Key], n: int, span: int,
                    device="cpu") -> torch.Tensor:
    """Plain version of PICK_DRAW, called as the kernel is: the picks of
    the key whose split gave `subkeys` (int32 [n], u32 values)."""
    span = _span(span)
    k1, k2 = subkeys
    hi = random_bits(k1, n, device)
    lo = random_bits(k2, n, device)
    mult = randint_multiplier(span)
    off = ((hi % span) * mult) & MASK32
    off = (off + lo % span) & MASK32
    return narrow(off % span)


def randint_u32_plain(key: Key, n: int, span: int,
                      device="cpu") -> torch.Tensor:
    """Plain version of `randint(key, (n,), 0, span, uint32)`: int32
    [n] holding the u32 picks."""
    return pick_draw_plain(split(key), n, span, device)


def randint_u32(key: Key, n: int, span: int, device=None) -> torch.Tensor:
    """`randint(key, (n,), 0, span, uint32)` on `device` (None = the
    card): int32 [n] with the u32 picks.  A CUDA device launches
    PICK_DRAW; the CPU runs the plain version."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from cilium_tpu_torch import kernels

        return kernels.PICK_DRAW(split(key), n, _span(span), dev)
    if dev.type == "cpu":
        return randint_u32_plain(key, n, span, dev)
    raise ValueError(f"unsupported device {dev}")
