"""Flow records: the binary form a Hubble flow export is replayed from.

One record is the 24-byte `struct flow_record` (little endian): ep_id,
identity, saddr, daddr (u32), sport, dport (u16), proto, direction,
flags, pad (u8); flag bit 0 marks a fragment.  The decoder returns the
same columns as the reference's native decoder, through numpy.
"""

from __future__ import annotations

import numpy as np

FLOW_RECORD_DTYPE = np.dtype([
    ("ep_id", "<u4"),
    ("identity", "<u4"),
    ("saddr", "<u4"),
    ("daddr", "<u4"),
    ("sport", "<u2"),
    ("dport", "<u2"),
    ("proto", "u1"),
    ("direction", "u1"),
    ("flags", "u1"),
    ("pad", "u1"),
])

# decoded column -> record field (is_fragment is flags bit 0)
_COLUMNS = (
    ("ep_id", np.uint32), ("identity", np.uint32), ("saddr", np.uint32),
    ("daddr", np.uint32), ("sport", np.uint16), ("dport", np.uint16),
    ("proto", np.uint8), ("direction", np.uint8), ("is_fragment", np.uint8),
)


def decode_flow_records(buf: bytes) -> dict:
    """Binary flow records -> {column: array}.  A buffer that is not a
    whole number of records raises ValueError: a truncated stream must
    not lose its tail quietly."""
    size = FLOW_RECORD_DTYPE.itemsize
    if len(buf) % size:
        raise ValueError(
            f"truncated flow record buffer: {len(buf)} bytes is not a "
            f"multiple of the {size}-byte record size"
        )
    rec = np.frombuffer(buf, dtype=FLOW_RECORD_DTYPE)
    out = {}
    for name, dtype in _COLUMNS:
        if name == "is_fragment":
            out[name] = (rec["flags"] & 1).astype(dtype)
        else:
            out[name] = rec[name].astype(dtype)
    return out


def encode_flow_records(ep_id, identity, saddr, daddr, sport, dport, proto,
                        direction, is_fragment) -> bytes:
    """Columns -> binary flow records (the inverse of
    decode_flow_records; pad bytes are 0)."""
    rec = np.zeros(len(ep_id), dtype=FLOW_RECORD_DTYPE)
    rec["ep_id"] = ep_id
    rec["identity"] = identity
    rec["saddr"] = saddr
    rec["daddr"] = daddr
    rec["sport"] = sport
    rec["dport"] = dport
    rec["proto"] = proto
    rec["direction"] = direction
    rec["flags"] = np.asarray(is_fragment, np.uint8) & 1
    return rec.tobytes()
