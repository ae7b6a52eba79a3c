"""Build, binding and wrappers of the hand-written CUDA kernels.

`csrc/datapath.cu`, `csrc/l7.cu`, `csrc/churn.cu`, `csrc/lattice.cu`,
`csrc/datapath6.cu`, `csrc/prng.cu`, `csrc/memo.cu`, `csrc/publish.cu`,
`csrc/shadow.cu`, `csrc/mesh.cu` and `csrc/datapath_mesh.cu` (with their
headers) are each compiled by `nvcc` for `sm_90a` into a shared library
with a plain C interface, at first use, into `cilium_tpu_torch/_build/`
(one file per source digest), and bound with ctypes.  Nothing here runs
at import: the CPU tests import this module on a machine with no `nvcc`
and no card.

`DATAPATH_PAIR(tables, pair, acc, telem)` is the pair step on the
card, `PERSISTENT_PAIR(tables, pairs, acc, telem)` K of them over a
[K, 2, 4, B] super-batch in one launch (K13; DATAPATH_PAIR is its K = 1
launch), and `DATAPATH_STEP(tables, pool, picks)` the single-batch step
over pool[:, picks] (read from the pool's row-major copy, `pool_rows`
or one made per call; or over an [8, B] pack with `picks=None`), in
each of its forms: a static direction, the raw index or the identity
as sec_id, counters into a carried `acc`, telemetry into a carried
`telem`.  Both check devices, dtypes, shapes and the table layouts and
raise on anything else.  The kernels implement the compact entry
layouts (2-word L4 entries, 4-word CT rows) and the wide ones (3-word
L4 entries, 5-word CT rows), with or without a v4 tunnel map (overlay
mode), over every plane layout the agent's builders pick: the range
or DIR-24-8 prefilter, the inline or classic LB, the idx ipcache with
or without L3 planes or the generic one (raw identities, bucketized or
DIR-24-8), its ranges by hashed classes or the [B, P] scan, and, with
policy tables without the hashed L4 entries, the dense lattice
(port_slot and l4_allow_bits: K8's dense branch).  `_fill_tables` picks one of the kernels' 12 layout
instantiations (`layout_name`).  They allocate the outputs with
`torch.empty`, launch on the current stream without synchronising,
raise if the launch reports an error, and count their launches in
`.launches`.

`CHURN_COMPACT` and `CT_DELTA` (csrc/churn.cu) are the churn loop's
intent compaction (K22) and CT bucket delta (K18's CT part) under the
same rules.  One CHURN_COMPACT call is four device launches (see the
source note) and counts one.  CT_DELTA runs the row scatters' tile
routine (csrc/scatter.cuh) on a tiling laid out by `scatter_args`, with
jax's scatter rules on its indices.

`HTTP_MATCH`, `KAFKA_MATCH`, `FLEET_L7` and `MEMCACHE_MATCH`
(csrc/l7.cu) are the L7 matchers K16, K17a, K17b and K17c under the
same rules: they check device, dtype, shape and limits (the staged
tables must fit one block's shared memory; MEMCACHE_MATCH stages its
rules in tiles of at most 1,024) and raise on anything else, allocate their
outputs, launch on the current stream, raise on a launch error and
count `.launches`.

`LATTICE` and `LPM_LOOKUP` (csrc/lattice.cu) are the tuple-level
lattice (K23; with `lpm` and `src_ips`, K20's fused CIDR form) and the
DIR-24-8 lookup (K20), under the same rules.

`PICK_DRAW(subkeys, n, span, device)` (csrc/prng.cu) is the churn
loop's threefry2x32 uniform draw (K22's picks, see prng.py), under the
same rules.

`MEMO_DEDUP`, `MEMO_CACHE` and `MEMO_KEYS_LATTICE` (csrc/memo.cu) are
the verdict memo's levels A and B and memo_evaluate's key words and
combine (K14); `DATAPATH_PAIR_MEMO` launches DATAPATH_PAIR's memo mode
(its front and back passes).  engine/memo.py strings them together.
Each call counts one launch: MEMO_DEDUP is one cooperative kernel (after
a memset of its barrier), MEMO_CACHE one cooperative kernel (its barrier
words zeroed once, in its held scratch).

`PUBLISH_SCATTER(segments)` (csrc/publish.cu) is the device table
store's delta scatter (K18 publish): every scattered leaf of a publish
written in place into the spare epoch's tensors, in one launch, with
jax's scatter rules (engine/publish.py `scatter_segments_plain` is its
plain version).

`SHADOW_DIFF(la, lp, lk, sa, sp, sk)` (csrc/shadow.cu) is the shadow
plane's per-row diff of a live and a shadow verdict set (K19), under
the same rules (shadow.py `diff_codes_plain` is its plain version).

`MESH_PROBE`, `ROUTED_PROBE` and `MESH_COMBINE` (csrc/mesh.cu) are the
lattice on a mesh (K21): a shard's step of the word-sharded and of the
routed (partitioned, failover) evaluators, and one batch row's combine
over the table axis, under the same rules (engine/sharded.py strings
them together and holds their plain versions).

`DP_MESH_PROBE` and `DP_MESH_COMBINE` (csrc/datapath_mesh.cu) are the
fused datapath on a mesh (K21): one shard's step of one round (S, L, F,
P) of the routed pipeline and one batch row's combine, under the same
rules (engine/datapath_mesh.py strings them together and holds their
plain versions).

`HASH_LOOKUP(table, query)` and `IPCACHE_LOOKUP(ipc, ips)`
(csrc/lookup.cu) are the generic hash-table lookup and the lookup over
a bucketized IPCacheDevice (the rest of K20), under the same rules
(engine/hashtable.py `lookup_batch_plain` and ipcache/lpm.py
`lookup_plain` are their plain versions).

`DATAPATH6(tables, flows)` (csrc/datapath6.cu) is the fused IPv6
program (K15, with the v6 tunnel stage of K11) over Datapath6Tables and
a FlowBatch6, under the same rules: it checks every table plane and
flow column, allocates the 13 columns, launches on the current stream,
raises on a launch error and counts `.launches`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

from cilium_tpu_torch.compiler.tables import l4_entry_words
from cilium_tpu_torch.engine.datapath import (
    VERDICT_COLUMNS,
    VERDICT_DTYPES,
    DatapathVerdicts,
    pool_rows_of,
)
from cilium_tpu_torch.engine.datapath_mesh import RECORD_ROWS
from cilium_tpu_torch.engine.subword import lanes_for
from cilium_tpu_torch.engine.verdict import TELEM_COLS
from cilium_tpu_torch.ipcache.lpm import (
    MAX_RANGES,
    RANGE_CLASS_MAX,
    IPCacheDevice,
    LPMTables,
)
from cilium_tpu_torch.lb.device import INLINE_STASH, LBInline, LBTables
from cilium_tpu_torch.prefilter import PrefilterRanges
from cilium_tpu_torch.tunnel import TunnelTables, TunnelTables6

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# csrc/<stem>.cu, one library each
LIBRARIES = ("datapath", "l7", "churn", "lattice", "datapath6", "prng",
             "memo", "publish", "shadow", "mesh", "datapath_mesh", "lookup")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# the plane layouts of csrc/common.cuh; layout = PF + 2 LB + 4 IPC
PF_RANGES, PF_LPM = 0, 1
LB_INLINE, LB_CLASSIC = 0, 1
IPC_IDX_PLANES, IPC_IDX, IPC_GENERIC = 0, 1, 2
_PF_NAMES = ("ranges", "dir24_8")
_LB_NAMES = ("inline", "classic")
_IPC_NAMES = ("idx_planes", "idx", "generic")


def layout_name(layout: int) -> str:
    """The instantiation's name, e.g. "dir24_8/classic/idx"."""
    return "/".join((_PF_NAMES[layout & 1], _LB_NAMES[(layout >> 1) & 1],
                     _IPC_NAMES[layout >> 2]))


def datapath_layout(tables) -> str:
    """The instantiation DATAPATH_PAIR and DATAPATH_STEP take for these
    tables (on the card), by name, with "+scan" where the ipcache's
    ranges take the [B, P] scan; raises where _fill_tables does."""
    a = DatapathArgs()
    _fill_tables(a, tables, tables.policy.id_table.device)
    return layout_name(a.layout) + ("+scan" if a.range_base else "")


def datapath_reads(tables) -> tuple:
    """The table leaves the datapath kernels read for these tables'
    layouts: (plane, leaf) pairs."""
    pf = (("prefilter", "l1"), ("prefilter", "l2")) if isinstance(
        tables.prefilter, LPMTables) else (("prefilter", "base"),
                                           ("prefilter", "mask"))
    lb = (("lb", "buckets"), ("lb", "stash"), ("lb", "backend_rows")) if (
        isinstance(tables.lb, LBTables)) else (("lb", "rows"), ("lb", "stash"))
    ipc = tables.ipcache
    if isinstance(ipc, LPMTables):
        ic = (("ipcache", "l1"), ("ipcache", "l2"))
    else:
        ic = (("ipcache", "buckets"), ("ipcache", "stash"))
        if ipc.range_rows is not None:
            ic += (("ipcache", "range_rows"),)
        else:
            ic += tuple(("ipcache", f"range_{k}") for k in (
                "base", "mask", "plen", "value")
                + (("l3_in", "l3_out") if ipc.l3_planes else ()))
    if tables.policy.l4_hash_rows is None:
        pol = (("policy", "port_slot"), ("policy", "l4_allow_bits"),
               ("policy", "l4_meta"))
    else:
        pol = (("policy", "l4_hash_rows"), ("policy", "l4_hash_stash"),
               ("policy", "l4_wild_rows"), ("policy", "l4_wild_stash"),
               ("policy", "l4_meta"))
    idx_form = isinstance(ipc, IPCacheDevice) and ipc.values_are_idx
    if not (idx_form and ipc.l3_planes):
        pol += (("policy", "l3_allow_bits"),)
    if not idx_form:
        pol += (("policy", "id_direct"),)
    return pf + (("ct", "buckets"), ("ct", "stash")) + lb + ic + pol


_P = ctypes.c_void_p
_I = ctypes.c_int32


class KernelError(RuntimeError):
    """A kernel library that failed to build or load, or a launch that
    reported an error: a fault of the program, never of a chip, so the
    failover router lets it propagate instead of routing around it."""


_PTRS = (
    "pf_base", "pf_mask", "ct_buckets", "ct_stash", "lb_rows",
    "lb_stash", "ipc_buckets", "ipc_stash", "ipc_range_rows", "l4_rows",
    "l4_stash", "l4w_rows", "l4w_stash", "l4_meta",
) + VERDICT_COLUMNS + ("acc", "telem")
_INTS = (
    "B", "pf_n", "ct_nb", "ct_lanes", "ct_stash_n", "lb_nb", "lb_stash_n",
    "ipc_nb", "ipc_lanes", "ipc_per", "ipc_vw", "ipc_lw", "ipc_stash_n",
    "range_nrows", "range_lanes", "range_e", "n_classes",
)
_INTS2 = (
    "l4_nrows", "l4_lanes", "l4_stash_n", "l4w_nrows", "l4w_lanes",
    "l4w_stash_n", "n_eps", "kg", "n_ids",
)
_PTRS3 = ("pool", "picks", "id_table")
_INTS3 = ("pool_n", "ct_ew", "l4_ew")
_PTRS4 = ("tun_base", "tun_mask", "tun_endpoint")


class _FlowsWord(ctypes.Union):
    """DatapathArgs' first word: the pair kernels' flows or the step's
    row-major pool (a union in csrc/common.cuh)."""

    _fields_ = [("pair", _P), ("pool_rows", _P)]


class DatapathArgs(ctypes.Structure):
    """Mirror of cdp::DatapathArgs in csrc/common.cuh, field for field."""

    _anonymous_ = ("flows",)
    _fields_ = (
        [("flows", _FlowsWord)]
        + [(name, ctypes.c_void_p) for name in _PTRS]
        + [(name, ctypes.c_int32) for name in _INTS]
        + [
            ("class_plens", ctypes.c_int32 * RANGE_CLASS_MAX),
            ("range_widths", ctypes.c_int32 * 5),
            ("range_offs", ctypes.c_int32 * 5),
        ]
        + [(name, ctypes.c_int32) for name in _INTS2]
        + [
            ("world_plus1", ctypes.c_uint32),
            ("world_l3_in", ctypes.c_uint32),
            ("world_l3_out", ctypes.c_uint32),
        ]
        + [(name, ctypes.c_void_p) for name in _PTRS3]
        + [(name, ctypes.c_int32) for name in _INTS3]
        + [(name, ctypes.c_void_p) for name in _PTRS4]
        + [("tun_n", ctypes.c_int32), ("static_dir", ctypes.c_int32),
           ("emit_sec_id", ctypes.c_int32), ("layout", ctypes.c_int32)]
        + [("pf_l1", _P), ("pf_l2", _P), ("pf_blocks", _I),
           ("lb_backends", _P), ("lb_backend_n", _I), ("ipc_stash_w", _I),
           ("ipc_l1", _P), ("ipc_l2", _P), ("ipc_blocks", _I)]
        + [(f"range_{k}", _P) for k in ("base", "mask", "plen", "value",
                                        "l3_in", "l3_out")]
        + [("n_ranges", _I), ("l3_allow", _P), ("id_direct", _P),
           ("n_words", _I), ("direct_n", _I), ("lo_len", ctypes.c_uint32)]
        + [("memo_keys", _P), ("memo_vals", _P), ("memo_stats", _P),
           ("memo", _I), ("port_slot", _P), ("l4_allow", _P)]
    )


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise KernelError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(stem: str) -> Path:
    """The shared library of csrc/<stem>.cu, named by the digest of
    every source in csrc/ and the flags."""
    digest = hashlib.sha1()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def build_all(stems=LIBRARIES, verbose: bool = False) -> dict:
    """Compile csrc/<stem>.cu for each stem, once per source digest,
    with one nvcc process per library, all started together.  Returns
    {stem: (path of the shared library, the compiler's output; empty
    when an existing build was reused)}.  `verbose` adds -Xptxas -v
    (registers and spills)."""
    out, running = {}, []
    for stem in stems:
        lib = _lib_path(stem)
        if lib.exists():
            out[stem] = (lib, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((stem, lib, tmp, proc))
    failed = []
    for stem, lib, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {stem}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        out[stem] = (lib, log)
    if failed:
        raise KernelError("\n".join(failed))
    return out


def build(stem: str, verbose: bool = False):
    """Compile csrc/<stem>.cu alone; see build_all."""
    return build_all((stem,), verbose=verbose)[stem]


def _ptr(t: torch.Tensor, name: str, device: torch.device, dtype=torch.int32,
         shape=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    return t.data_ptr()


def _pow2(n: int, name: str) -> int:
    if n <= 0 or n & (n - 1):
        raise ValueError(f"{name} = {n} is not a power of two")
    return n


def _stream(device: torch.device) -> int:
    """The raw handle of `device`'s current CUDA stream: the query
    torch.cuda.current_stream(device).cuda_stream makes, without
    building a Stream object (a few microseconds a launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


class _Library:
    """csrc/<stem>.cu, built and bound once for the wrappers that
    launch its kernels; `bind` declares the C functions and checks that
    the argument layouts agree with the source."""

    stem = ""

    def __init__(self) -> None:
        self.lib = None
        self.build_log = ""

    def load(self, verbose: bool = False):
        if self.lib is None:
            path, self.build_log = build(self.stem, verbose=verbose)
            try:
                lib = ctypes.CDLL(str(path))
                self.bind(lib)
            except (OSError, RuntimeError) as exc:
                raise KernelError(f"csrc/{self.stem}.cu: {exc}") from exc
            self.lib = lib
        return self.lib

    def bind(self, lib) -> None:
        raise NotImplementedError

    @staticmethod
    def declare(lib, launchers) -> None:
        """`int launch(const Args*, void* stream)` for each (name, Args)."""
        for launch, args in launchers:
            getattr(lib, launch).argtypes = [ctypes.POINTER(args), _P]
            getattr(lib, launch).restype = ctypes.c_int

    def launch(self, launch: str, args, device, name: str, *ints) -> None:
        """Launch on the current stream, with `ints` between the
        arguments and the stream; raise on a launch error."""
        lib = self.load()
        err = getattr(lib, launch)(ctypes.byref(args), *ints,
                                   _stream(device))
        if err != 0:
            raise KernelError(f"{name} launch failed: CUDA error {err}")


class _DatapathLibrary(_Library):
    """csrc/datapath.cu: DATAPATH_PAIR, DATAPATH_STEP and
    PERSISTENT_PAIR."""

    stem = "datapath"

    def bind(self, lib) -> None:
        self.declare(lib, (("launch_datapath_pair", DatapathArgs),
                           ("launch_datapath_step", DatapathArgs)))
        lib.launch_datapath_persistent.argtypes = [
            ctypes.POINTER(DatapathArgs), ctypes.c_int, _P]
        lib.launch_datapath_persistent.restype = ctypes.c_int
        lib.datapath_args_size.argtypes = []
        lib.datapath_args_size.restype = ctypes.c_int
        if lib.datapath_args_size() != ctypes.sizeof(DatapathArgs):
            raise RuntimeError(
                "DatapathArgs layout differs between kernels.py and "
                "csrc/common.cuh"
            )


DATAPATH_LIBRARY = _DatapathLibrary()


def _fill_tables(a: DatapathArgs, tables, dev) -> None:
    """Check every table plane the datapath kernels read, fill its part
    of `a` and pick the layout instantiation; raise on a layout the
    kernels do not implement."""
    pf = tables.prefilter
    if isinstance(pf, PrefilterRanges):
        a.pf_base = _ptr(pf.base, "prefilter.base", dev)
        a.pf_mask = _ptr(pf.mask, "prefilter.mask", dev,
                         shape=tuple(pf.base.shape))
        a.pf_n = int(pf.base.shape[0])
        pf_form = PF_RANGES
    elif isinstance(pf, LPMTables):
        a.pf_l1, a.pf_l2, a.pf_blocks = _lpm_tables(pf, dev)
        pf_form = PF_LPM
    else:
        raise ValueError(f"unknown prefilter form {type(pf).__name__}")

    ct = tables.ct
    ew = int(ct.entry_words)
    if ew not in (4, 5):
        raise ValueError(f"the kernel takes 4- or 5-word CT rows, not {ew}")
    if ct.stash.shape[1] != 5:
        raise ValueError("the CT stash must keep 5-word entries")
    a.ct_buckets = _ptr(ct.buckets, "ct.buckets", dev)
    a.ct_stash = _ptr(ct.stash, "ct.stash", dev)
    a.ct_nb = _pow2(int(ct.n_buckets), "ct.n_buckets")
    if ct.buckets.shape[0] != ct.n_buckets:
        raise ValueError("ct.buckets rows differ from n_buckets")
    a.ct_lanes = int(ct.buckets.shape[1])
    if a.ct_lanes < ew or (ew == 4 and a.ct_lanes % 4):
        raise ValueError("compact CT rows must hold whole 4-word entries")
    a.ct_ew = ew
    a.ct_stash_n = int(ct.stash.shape[0])

    lb_form = _fill_lb(a, tables.lb, dev)
    ipc_form = _fill_ipcache(a, tables.ipcache, dev)

    pol = tables.policy
    l4 = _l4_tables(pol, dev)
    for key, pre in (("l4", ""), ("l4w", "w")):
        for f in ("rows", "stash", "nrows", "lanes", "stash_n"):
            setattr(a, f"{key}_{f}", getattr(l4, pre + f))
    a.l4_ew = l4.ew
    e_count, _, kg = (int(s) for s in pol.l4_meta.shape)
    n = int(pol.id_table.shape[0])
    a.l4_meta = _ptr(pol.l4_meta, "policy.l4_meta", dev)
    a.n_eps, a.kg, a.n_ids = e_count, kg, n
    a.id_table = _ptr(pol.id_table, "policy.id_table", dev, shape=(n,))
    l3 = pol.l3_allow_bits
    a.n_words = int(l3.shape[2]) if l3.dim() == 3 else 0
    if a.n_words < 1:
        raise ValueError("policy.l3_allow_bits must be [E, 2, W >= 1]")
    a.l3_allow = _ptr(l3, "policy.l3_allow_bits", dev,
                      shape=(e_count, 2, a.n_words))
    if pol.l4_hash_rows is None:
        # K8's dense branch: probes 1 and 3 read port_slot and
        # l4_allow_bits (l4_rows stays null)
        if pol.port_slot is None or pol.l4_allow_bits is None:
            raise ValueError("policy tables without the hashed L4 tables "
                             "need the dense port_slot and l4_allow_bits")
        a.port_slot = _ptr(pol.port_slot, "policy.port_slot", dev,
                           shape=(256, 65536))
        a.l4_allow = _ptr(pol.l4_allow_bits, "policy.l4_allow_bits", dev,
                          shape=(e_count, 2, kg, a.n_words))
    direct_n = int(pol.id_direct.shape[0])
    if not 1 <= direct_n < 1 << 31:
        raise ValueError(f"id_direct has {direct_n} entries")
    a.id_direct = _ptr(pol.id_direct, "policy.id_direct", dev,
                       shape=(direct_n,))
    a.direct_n = direct_n
    a.lo_len = int(pol.id_lo_len) & 0xFFFFFFFF
    if tables.tunnel is not None:
        a.tun_base, a.tun_mask, a.tun_endpoint, a.tun_n = _tunnel_ranges(
            tables.tunnel, TunnelTables, 1, dev)
    a.layout = pf_form + 2 * lb_form + 4 * ipc_form


def _fill_lb(a: DatapathArgs, lb, dev) -> int:
    """The LB plane: inline slots, or classic bucket entries and backend
    rows.  Returns its layout."""
    if isinstance(lb, LBInline):
        if lb.rows.shape[1] != 128 or lb.stash.shape[1] != 64:
            raise ValueError("inline LB rows must be 128 lanes, stash 64")
        if lb.stash.shape[0] > INLINE_STASH:
            raise ValueError("LB stash exceeds its capacity")
        a.lb_rows = _ptr(lb.rows, "lb.rows", dev)
        a.lb_stash = _ptr(lb.stash, "lb.stash", dev)
        a.lb_nb = _pow2(int(lb.n_buckets), "lb.n_buckets")
        if lb.rows.shape[0] != lb.n_buckets:
            raise ValueError("lb.rows differ from n_buckets")
        a.lb_stash_n = int(lb.stash.shape[0])
        return LB_INLINE
    if isinstance(lb, LBTables):
        a.lb_nb = _pow2(_rows_of(lb.buckets, "lb.buckets", dev, 128),
                        "lb buckets")
        if a.lb_nb != lb.n_buckets:
            raise ValueError("lb.buckets rows differ from n_buckets")
        a.lb_rows = lb.buckets.data_ptr()
        a.lb_stash_n = _rows_of(lb.stash, "lb.stash", dev, 4)
        a.lb_stash = lb.stash.data_ptr()
        a.lb_backend_n = _rows_of(lb.backend_rows, "lb.backend_rows", dev, 128)
        a.lb_backends = lb.backend_rows.data_ptr()
        return LB_CLASSIC
    raise ValueError(f"unknown LB layout {type(lb).__name__}")


def _fill_ipcache(a: DatapathArgs, ipc, dev, rows=None) -> int:
    """The ipcache plane: DIR-24-8 (generic), or bucket rows and stash
    with hashed range classes or the [B, P] scan.  `rows` is the bucket
    rows expected on hand (n_buckets where None; a mesh shard's block
    otherwise).  Returns its layout."""
    if isinstance(ipc, LPMTables):
        a.ipc_l1, a.ipc_l2, a.ipc_blocks = _lpm_tables(ipc, dev)
        return IPC_GENERIC
    if not isinstance(ipc, IPCacheDevice):
        raise ValueError(f"unknown ipcache form {type(ipc).__name__}")
    planes = bool(ipc.l3_planes)
    if ipc.values_are_idx:
        form = IPC_IDX_PLANES if planes else IPC_IDX
    else:
        form = IPC_GENERIC
    sub = int(ipc.bucket_entries)
    per = sub or (32 if planes else 64)
    vw, lw = (int(ipc.value_width), int(ipc.l3_width)) if sub else (32, 32)
    if vw not in (16, 32) or lw not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"unsupported ipcache widths {vw}/{lw}")
    lanes = per + lanes_for(per, vw) + (2 * lanes_for(per, lw) if planes else 0)
    if ipc.buckets.dim() != 2 or ipc.buckets.shape[1] < lanes:
        raise ValueError("ipcache bucket rows narrower than their planes")
    stash_w = 4 if planes else 2
    if ipc.stash.dim() != 2 or ipc.stash.shape[1] < stash_w:
        raise ValueError(f"the ipcache stash needs {stash_w} columns")
    a.ipc_buckets = _ptr(ipc.buckets, "ipcache.buckets", dev)
    a.ipc_stash = _ptr(ipc.stash, "ipcache.stash", dev)
    a.ipc_stash_w = int(ipc.stash.shape[1])
    a.ipc_nb = _pow2(int(ipc.n_buckets), "ipcache.n_buckets")
    if ipc.buckets.shape[0] != (ipc.n_buckets if rows is None else rows):
        raise ValueError("ipcache.buckets rows differ from n_buckets")
    a.ipc_lanes = int(ipc.buckets.shape[1])
    a.ipc_per, a.ipc_vw, a.ipc_lw = per, vw, lw
    a.ipc_stash_n = int(ipc.stash.shape[0])
    if ipc.range_rows is None:
        _fill_range_scan(a, ipc, planes, dev)
    else:
        _fill_range_classes(a, ipc, 5 if planes else 3, dev)
    a.world_plus1 = int(ipc.world_plus1) & 0xFFFFFFFF
    a.world_l3_in = int(ipc.world_l3_in) & 0xFFFFFFFF
    a.world_l3_out = int(ipc.world_l3_out) & 0xFFFFFFFF
    return form


def _fill_range_scan(a: DatapathArgs, ipc, planes: bool, dev) -> None:
    """The [B, P] scan's ranges (staged per block in shared memory)."""
    p = int(ipc.range_base.shape[0]) if ipc.range_base.dim() == 1 else 0
    if not 1 <= p <= MAX_RANGES:
        raise ValueError(f"the range scan takes 1 to {MAX_RANGES} ranges, "
                         f"got {p}")
    names = ("base", "mask", "plen", "value") + (
        ("l3_in", "l3_out") if planes else ())
    for k in names:
        setattr(a, f"range_{k}", _ptr(getattr(ipc, f"range_{k}"),
                                      f"ipcache.range_{k}", dev, shape=(p,)))
    a.n_ranges = p


def _fill_range_classes(a: DatapathArgs, ipc, planes: int, dev) -> None:
    """The hashed range-class rows: `planes` planes (base, plen, value
    and with 5 the L3 words), u32 or sub-word."""
    a.ipc_range_rows = _ptr(ipc.range_rows, "ipcache.range_rows", dev)
    a.range_nrows = _pow2(int(ipc.range_rows.shape[0]), "range rows")
    a.range_lanes = int(ipc.range_rows.shape[1])
    plens = tuple(ipc.range_class_plens)
    if len(plens) > RANGE_CLASS_MAX or any(not 1 <= p <= 32 for p in plens):
        raise ValueError(f"unsupported range class schedule {plens}")
    a.n_classes = len(plens)
    for c, p in enumerate(plens):
        a.class_plens[c] = p
    if ipc.range_widths:
        widths = tuple(int(w) for w in ipc.range_widths)
        if len(widths) != planes:
            raise ValueError(f"range rows must carry {planes} planes")
        e = 8
    else:
        e = a.range_lanes // planes
        widths = (32,) * planes
    off = 0
    for p, w in enumerate(widths):
        a.range_widths[p] = w
        a.range_offs[p] = off
        off += lanes_for(e, w)
    if off > a.range_lanes:
        raise ValueError("range rows narrower than their planes")
    a.range_e = e


def _tunnel_ranges(tun, cls, limbs: int, dev):
    """Check a tunnel map's lowered form (base, mask [P] or [P, 4],
    endpoint [P]); returns (base, mask, endpoint pointers, P)."""
    if not isinstance(tun, cls):
        raise ValueError(f"the tunnel map must be {cls.__name__}")
    ep = tun.endpoint
    p = int(ep.shape[0]) if isinstance(ep, torch.Tensor) and ep.dim() == 1 else 0
    if not 1 <= p < 1 << 31:
        raise ValueError("tunnel.endpoint must be a tensor [P >= 1]")
    shape = (p,) if limbs == 1 else (p, limbs)
    return (_ptr(tun.base, "tunnel.base", dev, shape=shape),
            _ptr(tun.mask, "tunnel.mask", dev, shape=shape),
            _ptr(tun.endpoint, "tunnel.endpoint", dev, shape=(p,)), p)


class L4TablesArgs(ctypes.Structure):
    """Mirror of cdp::L4Tables in csrc/verdict.cuh, field for field."""

    _fields_ = (
        [(name, ctypes.c_void_p)
         for name in ("rows", "stash", "wrows", "wstash", "meta")]
        + [(name, ctypes.c_int32) for name in (
            "nrows", "lanes", "stash_n", "wnrows", "wlanes", "wstash_n",
            "ew", "n_eps", "kg")]
    )


def _l4_tables(pol, dev) -> L4TablesArgs:
    """Check the policy tables' hashed L4 pair (when present) and
    l4_meta plane, and fill an L4Tables; rows stay null without the
    hash (the dense branch)."""
    t = L4TablesArgs()
    t.meta = _ptr(pol.l4_meta, "policy.l4_meta", dev)
    if pol.l4_meta.dim() != 3 or pol.l4_meta.shape[1] != 2:
        raise ValueError("policy.l4_meta must be [E, 2, Kg]")
    t.n_eps, _, t.kg = (int(v) for v in pol.l4_meta.shape)
    if t.n_eps < 1 or t.kg < 1:
        raise ValueError("policy.l4_meta is empty")
    if pol.l4_hash_rows is None:
        return t
    t.ew = l4_entry_words(pol)
    for pre, key, rows, stash in (
        ("", "l4", pol.l4_hash_rows, pol.l4_hash_stash),
        ("w", "l4w", pol.l4_wild_rows, pol.l4_wild_stash),
    ):
        if stash.shape[1] != t.ew or rows.shape[1] < t.ew:
            raise ValueError(f"policy.{key} entries are not {t.ew}-word")
        setattr(t, pre + "rows", _ptr(rows, f"policy.{key}_rows", dev))
        setattr(t, pre + "stash", _ptr(stash, f"policy.{key}_stash", dev))
        setattr(t, pre + "nrows", _pow2(int(rows.shape[0]), f"{key} rows"))
        setattr(t, pre + "lanes", int(rows.shape[1]))
        setattr(t, pre + "stash_n", int(stash.shape[0]))
    return t


def _alloc_columns(a: DatapathArgs, shape, dev) -> dict:
    cols = {
        name: torch.empty(shape, dtype=VERDICT_DTYPES[name], device=dev)
        for name in VERDICT_COLUMNS
    }
    for name, t in cols.items():
        setattr(a, name, t.data_ptr())
    return cols


def _pair_args(tables, pairs, acc, telem, dims: int) -> DatapathArgs:
    """Validate a pair step's inputs (`pairs` [2, 4, B], or with
    `dims` 4 a super-batch [K, 2, 4, B]) and fill its launch
    arguments."""
    dev = pairs.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {dev}")
    if pairs.dim() != dims or pairs.shape[dims - 3:dims - 1] != (2, 4):
        lead = "[2, 4, B]" if dims == 3 else "[K, 2, 4, B]"
        raise ValueError(f"pair must be {lead}, got {tuple(pairs.shape)}")
    b = int(pairs.shape[-1])
    if b >= 1 << 31:
        raise ValueError("half-batch too large")
    a = DatapathArgs()
    a.pair = _ptr(pairs, "pair", dev)
    a.B = b
    _fill_tables(a, tables, dev)
    e_count, kg, n = a.n_eps, a.kg, a.n_ids
    if tuple(acc.shape) != (e_count, 2, kg + n):
        raise ValueError(f"acc must be [E, 2, Kg + N], got {tuple(acc.shape)}")
    if tuple(telem.shape) != (2, TELEM_COLS):
        raise ValueError(f"telem must be [2, {TELEM_COLS}]")
    a.acc = _ptr(acc, "acc", dev)
    a.telem = _ptr(telem, "telem", dev)
    return a


class DatapathPairKernel:
    """The pair step on the card (see the module docstring)."""

    name = "datapath_pair"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return DATAPATH_LIBRARY.load(verbose)

    def __call__(self, tables, pair, acc, telem):
        a = _pair_args(tables, pair, acc, telem, 3)
        cols = _alloc_columns(a, (2, a.B), pair.device)
        DATAPATH_LIBRARY.launch("launch_datapath_pair", a, pair.device,
                                self.name)
        self.launches += 1
        out_i = DatapathVerdicts(**{k: v[0] for k, v in cols.items()})
        out_e = DatapathVerdicts(**{k: v[1] for k, v in cols.items()})
        return out_i, out_e, acc, telem


class DatapathStepKernel:
    """The single-batch step on the card: the 15 columns [B] of the
    flows pool[:, picks] (pool int32 [8, P] in FLOW_COLUMNS order,
    picks int32 [B]; a pick past the pool clamps to its last row), or
    with `picks=None` of the flows pool[:, i] of an [8, B] pack.  The
    forms: `static_dir` None takes each flow's direction, INGRESS (0) or
    EGRESS (1) runs every flow as that side; `emit_sec_id` writes the
    identity or the raw lattice index; `acc` [E, 2, Kg + N] takes the
    counter hits and `telem` [2, 20] the telemetry sums, in place.
    The kernel reads a picked flow's 32 B from the pool's row-major copy
    [P, 8] in two 16-byte loads: `pool_rows` (`pool_rows_of(pool)`, which
    a caller that steps one pool many times keeps), else one made here."""

    name = "datapath_step"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return DATAPATH_LIBRARY.load(verbose)

    def __call__(self, tables, pool, picks=None, *, acc=None, telem=None,
                 emit_sec_id: bool = True, static_dir=None,
                 pool_rows=None) -> DatapathVerdicts:
        dev = _cuda_device(pool, self.name)
        if pool.dim() != 2 or pool.shape[0] != 8:
            raise ValueError(f"pool must be [8, P], got {tuple(pool.shape)}")
        n = int(pool.shape[1])
        if picks is None:
            b = _batch(n)
        else:
            if not 1 <= n < 1 << 31:
                raise ValueError(f"pool has {n} rows")
            if picks.dim() != 1:
                raise ValueError("picks must be [B]")
            b = _batch(int(picks.shape[0]))
        if static_dir not in (None, 0, 1):
            raise ValueError(f"static_dir must be None, 0 or 1, not "
                             f"{static_dir!r}")
        a = DatapathArgs()
        a.pool = _ptr(pool, "pool", dev, shape=(8, n))
        if picks is not None:
            if pool_rows is None:
                pool_rows = pool_rows_of(pool)
            a.pool_rows = _ptr(pool_rows, "pool_rows", dev, shape=(n, 8))
            if a.pool_rows % 16:
                raise ValueError("pool_rows is not 16-byte aligned")
            a.picks = _ptr(picks, "picks", dev, shape=(b,))
        a.pool_n, a.B = n, b
        a.static_dir = -1 if static_dir is None else int(static_dir)
        a.emit_sec_id = int(bool(emit_sec_id))
        _fill_tables(a, tables, dev)
        if acc is not None:
            a.acc = _ptr(acc, "acc", dev,
                         shape=(a.n_eps, 2, a.kg + a.n_ids))
        if telem is not None:
            a.telem = _ptr(telem, "telem", dev, shape=(2, TELEM_COLS))
        cols = _alloc_columns(a, (b,), dev)
        DATAPATH_LIBRARY.launch("launch_datapath_step", a, dev, self.name)
        self.launches += 1
        return DatapathVerdicts(**cols)


class PersistentPairKernel:
    """K13 on the card: K pair steps in one launch over a super-batch
    `pairs` [K, 2, 4, B] (int32 words, pair k's halves at [k, 0] and
    [k, 1]), every pair's counter hits into the one `acc` and every
    half's telemetry into the one `telem`, in place.  Returns (outs_in,
    outs_eg, acc, telem): DatapathVerdicts whose columns are [K, B]
    views of fresh [K, 2, B] outputs, pair k's at [k]."""

    name = "persistent_pair"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return DATAPATH_LIBRARY.load(verbose)

    def __call__(self, tables, pairs, acc, telem):
        a = _pair_args(tables, pairs, acc, telem, 4)
        k = int(pairs.shape[0])
        if not 1 <= k <= 65535:
            raise ValueError(f"{self.name}: K = {k} pairs, 1 to 65,535")
        cols = _alloc_columns(a, (k, 2, a.B), pairs.device)
        DATAPATH_LIBRARY.launch("launch_datapath_persistent", a, pairs.device,
                                self.name, k)
        self.launches += 1
        outs_i = DatapathVerdicts(**{n: v[:, 0] for n, v in cols.items()})
        outs_e = DatapathVerdicts(**{n: v[:, 1] for n, v in cols.items()})
        return outs_i, outs_e, acc, telem


DATAPATH_PAIR = DatapathPairKernel()
DATAPATH_STEP = DatapathStepKernel()
PERSISTENT_PAIR = PersistentPairKernel()


# ---------------------------------------------------------------------------
# L7 matchers (csrc/l7.cu)
# ---------------------------------------------------------------------------

class DfaGlobal(ctypes.Structure):
    _fields_ = [("trans", _P), ("classes", _P), ("accept", _P),
                ("n_states", _I), ("n_classes", _I), ("start", _I)]


class HttpTablesArgs(ctypes.Structure):
    _fields_ = [("dfa", DfaGlobal * 3), ("absent", _P * 3),
                ("ident_rules", _P), ("n_ident", _I), ("n_words", _I)]


class HttpFieldsArgs(ctypes.Structure):
    _fields_ = [("data", _P * 3), ("len", _P * 3), ("width", _I * 3)]


class KafkaTablesArgs(ctypes.Structure):
    _fields_ = [("keys_lo", _P), ("keys_hi", _P), ("keys_any", _P),
                ("version", _P), ("client", _P), ("topic", _P),
                ("ident_rules", _P), ("n_rules", _I), ("n_ident", _I),
                ("n_words", _I)]


class KafkaFieldsArgs(ctypes.Structure):
    _fields_ = [("kind", _P), ("version", _P), ("client", _P),
                ("topics", _P), ("topic_count", _P), ("parsed", _P),
                ("checks_client", _P), ("overflow", _P), ("n_topics", _I)]


class HttpArgs(ctypes.Structure):
    """Mirror of cl7::HttpArgs in csrc/l7.cu, field for field."""

    _fields_ = [("t", HttpTablesArgs), ("f", HttpFieldsArgs),
                ("ident_idx", _P), ("known", _P), ("scope", _P),
                ("allowed", _P), ("matched", _P), ("n", _I)]


class KafkaArgs(ctypes.Structure):
    """Mirror of cl7::KafkaArgs in csrc/l7.cu, field for field."""

    _fields_ = [("t", KafkaTablesArgs), ("f", KafkaFieldsArgs),
                ("ident_idx", _P), ("known", _P), ("scope", _P),
                ("allowed", _P), ("topic_kinds", ctypes.c_uint64),
                ("n", _I)]


class FleetArgs(ctypes.Structure):
    """Mirror of cl7::FleetArgs in csrc/l7.cu, field for field."""

    _fields_ = [("http", HttpTablesArgs), ("hf", HttpFieldsArgs),
                ("kafka", KafkaTablesArgs), ("kf", KafkaFieldsArgs),
                ("parser_kind", _P), ("scope_http", _P), ("scope_kafka", _P),
                ("ep_index", _P), ("direction", _P), ("l4_slot", _P),
                ("ident_idx", _P), ("known", _P), ("allowed", _P),
                ("topic_kinds", ctypes.c_uint64), ("has_http", _I),
                ("has_kafka", _I), ("n_scopes", _I), ("kg", _I), ("n", _I)]


class MemcacheArgs(ctypes.Structure):
    """Mirror of cl7::MemcacheArgs in csrc/l7.cu, field for field."""

    _fields_ = [("opcode_mask", _P), ("rule_key", _P), ("device_ok", _P),
                ("ident_rules", _P), ("opcode", _P), ("key_id", _P),
                ("ident_idx", _P), ("known", _P), ("allowed", _P),
                ("needs_host", _P), ("n_rules", _I), ("n_ident", _I),
                ("n_words", _I), ("n", _I)]


# (launcher, its shared-memory size function, Args): the staged kernels
_L7_LAUNCHERS = (
    ("launch_http_match", "http_match_smem", HttpArgs),
    ("launch_kafka_match", "kafka_match_smem", KafkaArgs),
    ("launch_fleet_l7", "fleet_l7_smem", FleetArgs),
)


class _L7Library(_Library):
    """csrc/l7.cu: the four L7 wrappers."""

    stem = "l7"

    def bind(self, lib) -> None:
        self.declare(lib, [(launch, args) for launch, _, args in
                           _L7_LAUNCHERS]
                     + [("launch_memcache_match", MemcacheArgs)])
        for _, smem, args in _L7_LAUNCHERS:
            getattr(lib, smem).argtypes = [ctypes.POINTER(args)]
            getattr(lib, smem).restype = ctypes.c_longlong
        lib.l7_smem_limit.argtypes = []
        lib.l7_smem_limit.restype = ctypes.c_int
        lib.l7_struct_sizes.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.l7_struct_sizes.restype = ctypes.c_int
        sizes = (ctypes.c_int * 4)()
        lib.l7_struct_sizes(sizes)
        want = [ctypes.sizeof(a) for _, _, a in _L7_LAUNCHERS]
        want.append(ctypes.sizeof(MemcacheArgs))
        if list(sizes) != want:
            raise RuntimeError(
                f"L7 argument layouts differ between kernels.py {want} "
                f"and csrc/l7.cu {list(sizes)}"
            )

    def launch_staged(self, launch: str, smem: str, args, device,
                      name: str) -> None:
        """Refuse tables that do not fit one block's shared memory, then
        launch."""
        lib = self.load()
        need = getattr(lib, smem)(ctypes.byref(args))
        limit = lib.l7_smem_limit()
        if need > limit:
            raise ValueError(
                f"{name}: the staged tables take {need} B of shared memory, "
                f"more than the {limit} B one block may use"
            )
        self.launch(launch, args, device, name)


L7_LIBRARY = _L7Library()


def _cuda_device(t, name):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        where = t.device if isinstance(t, torch.Tensor) else type(t).__name__
        raise ValueError(f"{name}: the kernel runs on CUDA tensors, got {where}")
    return t.device


def _fill_http_tables(t: HttpTablesArgs, tables, dev) -> int:
    """Check the device-form HTTPTables and fill `t`; returns W."""
    w = int(tables.n_words)
    if w < 1:
        raise ValueError("HTTP tables need at least one mask word")
    for f, field in enumerate(("method", "path", "host")):
        dfa = getattr(tables, f"{field}_dfa")
        if dfa.trans.dim() != 2:
            raise ValueError(f"{field}_dfa.trans must be [S, C]")
        s_count, c_count = (int(v) for v in dfa.trans.shape)
        if not (1 <= s_count <= 1 << 16 and 1 <= c_count <= 256):
            raise ValueError(
                f"{field}_dfa has {s_count} states and {c_count} classes; "
                "the kernel takes at most 65536 states and 256 classes"
            )
        if not 0 <= int(dfa.start) < s_count:
            raise ValueError(f"{field}_dfa.start out of range")
        d = t.dfa[f]
        d.trans = _ptr(dfa.trans, f"{field}_dfa.trans", dev, torch.int32)
        d.classes = _ptr(dfa.classes, f"{field}_dfa.classes", dev,
                         torch.uint8, (256,))
        d.accept = _ptr(dfa.accept, f"{field}_dfa.accept", dev, torch.int32,
                        (s_count, w))
        d.n_states, d.n_classes, d.start = s_count, c_count, int(dfa.start)
        t.absent[f] = _ptr(getattr(tables, f"absent_{field}"),
                           f"absent_{field}", dev, torch.int32, (w,))
    ident = tables.ident_rules
    n = int(ident.shape[0])
    if n < 1:
        raise ValueError("ident_rules has no rows")
    t.ident_rules = _ptr(ident, "ident_rules", dev, torch.int32, (n, w))
    t.n_ident, t.n_words = n, w
    return w


def _fill_http_fields(f: HttpFieldsArgs, fields, b: int, dev) -> None:
    if len(fields) != 6:
        raise ValueError("HTTP fields are (m, ml, p, pl, h, hl)")
    for k, name in enumerate(("method", "path", "host")):
        data, lens = fields[2 * k], fields[2 * k + 1]
        if data.dim() != 2 or data.shape[0] != b:
            raise ValueError(f"{name} must be [B={b}, L]")
        f.data[k] = _ptr(data, name, dev, torch.uint8)
        f.len[k] = _ptr(lens, f"{name}_len", dev, torch.int32, (b,))
        f.width[k] = int(data.shape[1])


def _fill_kafka_tables(t: KafkaTablesArgs, tables, dev) -> int:
    """Check the device-form KafkaTables and fill `t`; returns W."""
    r = int(tables.rule_keys_lo.shape[0])
    if r < 1:
        raise ValueError("Kafka tables need at least one rule column")
    t.keys_lo = _ptr(tables.rule_keys_lo, "rule_keys_lo", dev, torch.int32, (r,))
    t.keys_hi = _ptr(tables.rule_keys_hi, "rule_keys_hi", dev, torch.int32, (r,))
    t.keys_any = _ptr(tables.rule_keys_any, "rule_keys_any", dev, torch.uint8,
                      (r,))
    t.version = _ptr(tables.rule_version, "rule_version", dev, torch.int32, (r,))
    t.client = _ptr(tables.rule_client, "rule_client", dev, torch.int32, (r,))
    t.topic = _ptr(tables.rule_topic, "rule_topic", dev, torch.int32, (r,))
    ident = tables.ident_rules
    if ident.dim() != 2 or ident.shape[0] < 1:
        raise ValueError("ident_rules must be [N >= 1, W]")
    n, w = (int(v) for v in ident.shape)
    if w * 32 < r:
        raise ValueError(f"ident_rules has {w} words for {r} rules")
    t.ident_rules = _ptr(ident, "ident_rules", dev, torch.int32)
    t.n_rules, t.n_ident, t.n_words = r, n, w
    return w


def _fill_kafka_fields(f: KafkaFieldsArgs, fields, b: int, dev) -> None:
    if len(fields) != 8:
        raise ValueError("Kafka fields are pad_kafka_requests' eight")
    kind, version, client, topics, count, parsed, checks, overflow = fields
    if topics.dim() != 2 or topics.shape[0] != b or topics.shape[1] > 32:
        raise ValueError("topics must be [B, T] with T <= 32")
    f.kind = _ptr(kind, "kind", dev, torch.int32, (b,))
    f.version = _ptr(version, "version", dev, torch.int32, (b,))
    f.client = _ptr(client, "client", dev, torch.int32, (b,))
    f.topics = _ptr(topics, "topics", dev, torch.int32)
    f.topic_count = _ptr(count, "topic_count", dev, torch.int32, (b,))
    f.parsed = _ptr(parsed, "parsed", dev, torch.bool, (b,))
    f.checks_client = _ptr(checks, "checks_client", dev, torch.bool, (b,))
    f.overflow = _ptr(overflow, "overflow", dev, torch.bool, (b,))
    f.n_topics = int(topics.shape[1])


def _topic_kinds() -> int:
    from cilium_tpu_torch.l7.kafka import TOPIC_API_KEYS

    return sum(1 << k for k in TOPIC_API_KEYS if 0 <= k < 64)


def _batch(b: int) -> int:
    if b >= 1 << 31:
        raise ValueError("batch too large")
    return b


class HttpMatchKernel:
    """K16 on the card: (allowed bool [B], matched int32 [B, W])."""

    name = "http_match"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return L7_LIBRARY.load(verbose)

    def __call__(self, tables, method, method_len, path, path_len, host,
                 host_len, ident_idx, known, scope_bits=None):
        dev = _cuda_device(method, self.name)
        b = _batch(int(method.shape[0]))
        a = HttpArgs()
        w = _fill_http_tables(a.t, tables, dev)
        _fill_http_fields(a.f, (method, method_len, path, path_len, host,
                                host_len), b, dev)
        a.ident_idx = _ptr(ident_idx, "ident_idx", dev, torch.int32, (b,))
        a.known = _ptr(known, "known", dev, torch.bool, (b,))
        a.scope = (None if scope_bits is None else
                   _ptr(scope_bits, "scope_bits", dev, torch.int32, (b, w)))
        allowed = torch.empty(b, dtype=torch.bool, device=dev)
        matched = torch.empty((b, w), dtype=torch.int32, device=dev)
        a.allowed, a.matched, a.n = allowed.data_ptr(), matched.data_ptr(), b
        L7_LIBRARY.launch_staged("launch_http_match", "http_match_smem", a,
                                 dev, self.name)
        self.launches += 1
        return allowed, matched


class KafkaMatchKernel:
    """K17a on the card: allowed bool [B]."""

    name = "kafka_match"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return L7_LIBRARY.load(verbose)

    def __call__(self, tables, kind, version, client, topics, topic_count,
                 parsed, checks_client, overflow, ident_idx, known,
                 scope_bits=None):
        dev = _cuda_device(kind, self.name)
        b = _batch(int(kind.shape[0]))
        a = KafkaArgs()
        w = _fill_kafka_tables(a.t, tables, dev)
        _fill_kafka_fields(a.f, (kind, version, client, topics, topic_count,
                                 parsed, checks_client, overflow), b, dev)
        a.ident_idx = _ptr(ident_idx, "ident_idx", dev, torch.int32, (b,))
        a.known = _ptr(known, "known", dev, torch.bool, (b,))
        a.scope = (None if scope_bits is None else
                   _ptr(scope_bits, "scope_bits", dev, torch.int32, (b, w)))
        allowed = torch.empty(b, dtype=torch.bool, device=dev)
        a.allowed, a.n = allowed.data_ptr(), b
        a.topic_kinds = _topic_kinds()
        L7_LIBRARY.launch_staged("launch_kafka_match", "kafka_match_smem", a,
                                 dev, self.name)
        self.launches += 1
        return allowed


class FleetL7Kernel:
    """K17b on the card: allowed bool [B]."""

    name = "fleet_l7"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return L7_LIBRARY.load(verbose)

    def __call__(self, fleet, ep_index, direction, l4_slot, ident_idx, known,
                 http_fields=None, kafka_fields=None):
        dev = _cuda_device(ep_index, self.name)
        b = _batch(int(ep_index.shape[0]))
        a = FleetArgs()
        pk = fleet.parser_kind
        if pk.dim() != 3 or pk.shape[1] != 2:
            raise ValueError("parser_kind must be [E, 2, Kg]")
        e_count, _, kg = (int(v) for v in pk.shape)
        scopes = e_count * 2 * kg
        if not 1 <= scopes < 1 << 31:
            raise ValueError(f"{scopes} scopes")
        a.parser_kind = _ptr(pk, "parser_kind", dev, torch.uint8)
        a.n_scopes, a.kg = scopes, kg
        a.has_http = int(fleet.http is not None and http_fields is not None)
        a.has_kafka = int(fleet.kafka is not None and kafka_fields is not None)
        if a.has_http:
            wh = _fill_http_tables(a.http, fleet.http.tables, dev)
            _fill_http_fields(a.hf, http_fields, b, dev)
            a.scope_http = _ptr(fleet.scope_http, "scope_http", dev,
                                torch.int32, (e_count, 2, kg, wh))
        if a.has_kafka:
            wk = _fill_kafka_tables(a.kafka, fleet.kafka, dev)
            _fill_kafka_fields(a.kf, kafka_fields, b, dev)
            a.scope_kafka = _ptr(fleet.scope_kafka, "scope_kafka", dev,
                                 torch.int32, (e_count, 2, kg, wk))
        a.ep_index = _ptr(ep_index, "ep_index", dev, torch.int32, (b,))
        a.direction = _ptr(direction, "direction", dev, torch.int32, (b,))
        a.l4_slot = _ptr(l4_slot, "l4_slot", dev, torch.int32, (b,))
        a.ident_idx = _ptr(ident_idx, "ident_idx", dev, torch.int32, (b,))
        a.known = _ptr(known, "known", dev, torch.bool, (b,))
        allowed = torch.empty(b, dtype=torch.bool, device=dev)
        a.allowed, a.n = allowed.data_ptr(), b
        a.topic_kinds = _topic_kinds()
        L7_LIBRARY.launch_staged("launch_fleet_l7", "fleet_l7_smem", a,
                                 dev, self.name)
        self.launches += 1
        return allowed


class MemcacheMatchKernel:
    """K17c on the card: (allowed bool [B], needs_host bool [B]) over
    the first R = len(tables.specs) rules (R >= 1; the entry point
    answers an empty rule set without a launch)."""

    name = "memcache_match"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return L7_LIBRARY.load(verbose)

    def __call__(self, tables, opcode, key_id, ident_idx, known):
        dev = _cuda_device(opcode, self.name)
        b = _batch(int(opcode.shape[0]))
        r = len(tables.specs)
        if r < 1:
            raise ValueError("memcache_match needs at least one rule")
        ident = tables.ident_rules
        if ident.dim() != 2 or ident.shape[0] < 1:
            raise ValueError("ident_rules must be [N >= 1, W]")
        n, w = (int(v) for v in ident.shape)
        if w * 32 < r:
            raise ValueError(f"ident_rules has {w} words for {r} rules")
        if tables.opcode_mask.dim() != 2 or tables.opcode_mask.shape[0] < r:
            raise ValueError(f"opcode_mask must be [R >= {r}, 8]")
        a = MemcacheArgs()
        a.opcode_mask = _ptr(tables.opcode_mask[:r], "opcode_mask", dev,
                             torch.int32, (r, 8))
        a.rule_key = _ptr(tables.key_id[:r], "key_id", dev, torch.int32,
                          (r,))
        a.device_ok = _ptr(tables.device_ok[:r], "device_ok", dev,
                           torch.bool, (r,))
        a.ident_rules = _ptr(ident, "ident_rules", dev, torch.int32)
        a.opcode = _ptr(opcode, "opcode", dev, torch.int32, (b,))
        a.key_id = _ptr(key_id, "key_id", dev, torch.int32, (b,))
        a.ident_idx = _ptr(ident_idx, "ident_idx", dev, torch.int32, (b,))
        a.known = _ptr(known, "known", dev, torch.bool, (b,))
        allowed = torch.empty(b, dtype=torch.bool, device=dev)
        needs_host = torch.empty(b, dtype=torch.bool, device=dev)
        a.allowed, a.needs_host = allowed.data_ptr(), needs_host.data_ptr()
        a.n_rules, a.n_ident, a.n_words, a.n = r, n, w, b
        L7_LIBRARY.launch("launch_memcache_match", a, dev, self.name)
        self.launches += 1
        return allowed, needs_host


HTTP_MATCH = HttpMatchKernel()
KAFKA_MATCH = KafkaMatchKernel()
FLEET_L7 = FleetL7Kernel()
MEMCACHE_MATCH = MemcacheMatchKernel()


# ---------------------------------------------------------------------------
# The churn loop (csrc/churn.cu)
# ---------------------------------------------------------------------------

# the step outputs CHURN_COMPACT reads, with their dtypes
_CHURN_OUT = (
    ("ct_create", torch.bool), ("ct_delete", torch.bool),
    ("allowed", torch.uint8), ("proxy_port", torch.int32),
    ("final_daddr", torch.int32), ("final_dport", torch.int32),
    ("rev_nat", torch.int32), ("lb_slave", torch.int32),
)


class ChurnArgs(ctypes.Structure):
    """Mirror of cch::ChurnArgs in csrc/churn.cu, field for field."""

    _fields_ = (
        [(name, _P) for name, _ in _CHURN_OUT]
        + [(name, _P) for name in ("pool", "picks", "claim", "hash",
                                   "winner", "counts", "header", "intents")]
        + [(name, _I) for name in ("B", "valid", "cap", "slots", "pool_n")]
    )


class _ChurnLibrary(_Library):
    """csrc/churn.cu: CHURN_COMPACT and CT_DELTA."""

    stem = "churn"

    def bind(self, lib) -> None:
        self.declare(lib, (("launch_churn_compact", ChurnArgs),))
        lib.launch_ct_delta.argtypes = [_P, _P]
        lib.launch_ct_delta.restype = ctypes.c_int
        lib.churn_blocks.argtypes = [ctypes.c_int]
        lib.churn_blocks.restype = ctypes.c_int
        lib.churn_struct_sizes.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.churn_struct_sizes.restype = ctypes.c_int
        sizes = (ctypes.c_int * 2)()
        lib.churn_struct_sizes(sizes)
        want = [ctypes.sizeof(ChurnArgs), ctypes.sizeof(_DELTA_ARGS)]
        if list(sizes) != want:
            raise RuntimeError(
                f"churn argument layouts differ between kernels.py "
                f"{want} and csrc/churn.cu {list(sizes)}"
            )


CHURN_LIBRARY = _ChurnLibrary()


class ChurnCompactKernel:
    """K22 on the card: (header int32 [4], intents int32 [12, cap]) of
    a step's outputs over pool[:, picks], bit-exact with
    replay._churn_compact on the same flows."""

    name = "churn_compact"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return CHURN_LIBRARY.load(verbose)

    def __call__(self, out, pool, picks, valid: int, cap: int,
                 claim_slots: int):
        dev = _cuda_device(pool, self.name)
        if pool.dim() != 2 or pool.shape[0] != 8 or pool.shape[1] < 1:
            raise ValueError(f"pool must be [8, P >= 1], got "
                             f"{tuple(pool.shape)}")
        b = _batch(int(picks.shape[0]))
        if not 0 <= int(valid) <= b:
            raise ValueError(f"valid = {valid} outside [0, {b}]")
        if not 1 <= int(cap) < 1 << 31:
            raise ValueError(f"cap = {cap}")
        slots = _pow2(int(claim_slots), "claim_slots")
        if slots >= 1 << 31:
            raise ValueError("claim table too large")
        a = ChurnArgs()
        for name, dtype in _CHURN_OUT:
            setattr(a, name, _ptr(getattr(out, name), f"out.{name}", dev,
                                  dtype, (b,)))
        n = int(pool.shape[1])
        a.pool = _ptr(pool, "pool", dev, shape=(8, n))
        a.picks = _ptr(picks, "picks", dev, shape=(b,))
        lib = self.load()
        blocks = lib.churn_blocks(b)
        scratch = dict(
            claim=torch.empty(slots, dtype=torch.int32, device=dev),
            hash=torch.empty(max(b, 1), dtype=torch.int32, device=dev),
            winner=torch.empty(max(b, 1), dtype=torch.uint8, device=dev),
            counts=torch.empty(4 * blocks, dtype=torch.int32, device=dev),
        )
        header = torch.empty(4, dtype=torch.int32, device=dev)
        intents = torch.empty((12, int(cap)), dtype=torch.int32, device=dev)
        for name, t in scratch.items():
            setattr(a, name, t.data_ptr())
        a.header, a.intents = header.data_ptr(), intents.data_ptr()
        a.B, a.valid, a.cap, a.slots, a.pool_n = b, int(valid), int(cap), \
            slots, n
        CHURN_LIBRARY.launch("launch_churn_compact", a, dev, self.name)
        self.launches += 1
        return header, intents


class CtDeltaKernel:
    """K18's CT part on the card: rows int32 [M, lanes] written into
    snapshot.buckets at idx int32 [M], in place, with jax's scatter
    rules (an index below 0 counts from the end once, a row whose index
    is still outside the table is dropped); returns the snapshot.  One
    launch of the row scatters' tile routine (csrc/scatter.cuh) over one
    segment (scatter_args), built into csrc/churn.cu; an empty delta
    launches nothing."""

    name = "ct_delta"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return CHURN_LIBRARY.load(verbose)

    def __call__(self, snapshot, idx, rows):
        buckets = snapshot.buckets
        dev = _cuda_device(buckets, self.name)
        if buckets.dim() != 2:
            raise ValueError("ct.buckets must be [Cb, lanes]")
        nb, lanes = (int(v) for v in buckets.shape)
        _cell_limit(nb)
        m = int(idx.shape[0])
        if m == 0:
            return snapshot
        geo = ((_ptr(buckets, "ct.buckets", dev),
                _ptr(idx, "idx", dev, shape=(m,)), 0,
                _ptr(rows, "rows", dev, shape=(m, lanes)),
                nb, 1, 1, lanes, m),)
        args = scatter_args(geo, self.name, _DELTA_ARGS)
        err = self.load().launch_ct_delta(ctypes.addressof(args),
                                          _stream(dev))
        if err != 0:
            raise KernelError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1
        return snapshot


CHURN_COMPACT = ChurnCompactKernel()
CT_DELTA = CtDeltaKernel()


# ---------------------------------------------------------------------------
# The tuple-level lattice and the DIR-24-8 lookup (csrc/lattice.cu)
# ---------------------------------------------------------------------------


class PolicyViewArgs(ctypes.Structure):
    """Mirror of cdp::PolicyView in csrc/verdict.cuh, field for field."""

    _fields_ = (
        [(name, _P) for name in ("id_direct", "l3_allow", "port_slot",
                                 "l4_allow")]
        + [("l4", L4TablesArgs)]
        + [(name, _I) for name in ("direct_n", "n_ids", "n_words")]
        + [("lo_len", ctypes.c_uint32)]
    )


def _policy_view(tables, dev) -> PolicyViewArgs:
    """Check the policy tables the tuple lattice reads (hashed L4
    tables, or without them the dense port_slot and l4_allow_bits) and
    fill a PolicyView."""
    v = PolicyViewArgs()
    v.l4 = _l4_tables(tables, dev)
    e_count, kg = v.l4.n_eps, v.l4.kg
    n = int(tables.id_table.shape[0])
    if n < 32 or n % 32 or n >= 1 << 31:
        raise ValueError(f"{n} identities: not a positive multiple of 32")
    w = n // 32
    v.n_ids, v.n_words = n, w
    direct_n = int(tables.id_direct.shape[0])
    if not 1 <= direct_n < 1 << 31:
        raise ValueError(f"id_direct has {direct_n} entries")
    v.id_direct = _ptr(tables.id_direct, "policy.id_direct", dev,
                       shape=(direct_n,))
    v.direct_n = direct_n
    v.lo_len = int(tables.id_lo_len) & 0xFFFFFFFF
    v.l3_allow = _ptr(tables.l3_allow_bits, "policy.l3_allow_bits", dev,
                      shape=(e_count, 2, w))
    if tables.l4_hash_rows is None:
        v.port_slot = _ptr(tables.port_slot, "policy.port_slot", dev,
                           shape=(256, 65536))
        v.l4_allow = _ptr(tables.l4_allow_bits, "policy.l4_allow_bits",
                          dev, shape=(e_count, 2, kg, w))
    return v


class LatticeArgs(ctypes.Structure):
    """Mirror of clt::LatticeArgs in csrc/lattice.cu, field for field."""

    _fields_ = (
        [(name, _P) for name in ("tuples", "src_ips", "l1", "l2")]
        + [("pol", PolicyViewArgs)]
        + [(name, _P) for name in ("allowed", "proxy_port", "match_kind",
                                   "acc")]
        + [(name, _I) for name in ("B", "n_blocks")]
    )


class LpmArgs(ctypes.Structure):
    """Mirror of clt::LpmArgs in csrc/lattice.cu, field for field."""

    _fields_ = [("l1", _P), ("l2", _P), ("ips", _P), ("out", _P), ("B", _I),
                ("n_blocks", _I)]


class _LatticeLibrary(_Library):
    """csrc/lattice.cu: LATTICE and LPM_LOOKUP."""

    stem = "lattice"

    def bind(self, lib) -> None:
        self.declare(lib, (("launch_lattice", LatticeArgs),
                           ("launch_lpm_lookup", LpmArgs)))
        lib.lattice_struct_sizes.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.lattice_struct_sizes.restype = ctypes.c_int
        sizes = (ctypes.c_int * 4)()
        lib.lattice_struct_sizes(sizes)
        want = [ctypes.sizeof(a) for a in (L4TablesArgs, PolicyViewArgs,
                                           LatticeArgs, LpmArgs)]
        if list(sizes) != want:
            raise RuntimeError(
                f"lattice argument layouts differ between kernels.py "
                f"{want} and csrc/lattice.cu {list(sizes)}"
            )


LATTICE_LIBRARY = _LatticeLibrary()


def _lpm_tables(tables, dev):
    """Check DIR-24-8 tables; returns (l1 ptr, l2 ptr, n_blocks)."""
    from cilium_tpu_torch.ipcache.lpm import L1_SIZE

    l2 = tables.l2
    if l2.dim() != 2 or l2.shape[1] != 256 or l2.shape[0] < 1:
        raise ValueError(f"lpm.l2 must be [blocks >= 1, 256], got "
                         f"{tuple(l2.shape)}")
    if l2.shape[0] >= 1 << 31:
        raise ValueError("lpm.l2 has too many blocks")
    return (_ptr(tables.l1, "lpm.l1", dev, shape=(L1_SIZE,)),
            _ptr(l2, "lpm.l2", dev), int(l2.shape[0]))


class LatticeKernel:
    """K23 on the card, and K20's fused form with `lpm` and `src_ips`:
    (Verdicts [B], acc int32 [E, 2, Kg + N] or None) of a TupleBatch
    against PolicyTables, hashed (3- or 2-word entries) or dense (no
    hash: port_slot and l4_allow_bits).  With `counters` the hits land
    in a fresh zeroed buffer (split with verdict.split_counters)."""

    name = "lattice"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return LATTICE_LIBRARY.load(verbose)

    def __call__(self, tables, batch, counters: bool = False, lpm=None,
                 src_ips=None):
        from cilium_tpu_torch.engine.verdict import Verdicts

        packed = batch.pack()
        dev = _cuda_device(packed, self.name)
        if packed.dim() != 2 or packed.shape[0] != 6:
            raise ValueError(f"the tuple pack must be [6, B], got "
                             f"{tuple(packed.shape)}")
        b = _batch(int(packed.shape[1]))
        a = LatticeArgs()
        a.tuples = _ptr(packed, "tuples", dev, shape=(6, b))
        a.B = b
        if (lpm is None) != (src_ips is None):
            raise ValueError("IP mode takes both lpm and src_ips")
        if lpm is not None:
            a.src_ips = _ptr(src_ips, "src_ips", dev, shape=(b,))
            a.l1, a.l2, a.n_blocks = _lpm_tables(lpm, dev)
        a.pol = _policy_view(tables, dev)
        e_count, kg, n = a.pol.l4.n_eps, a.pol.l4.kg, a.pol.n_ids
        out = Verdicts(
            allowed=torch.empty(b, dtype=torch.uint8, device=dev),
            proxy_port=torch.empty(b, dtype=torch.int32, device=dev),
            match_kind=torch.empty(b, dtype=torch.uint8, device=dev),
        )
        a.allowed = out.allowed.data_ptr()
        a.proxy_port = out.proxy_port.data_ptr()
        a.match_kind = out.match_kind.data_ptr()
        acc = None
        if counters:
            acc = torch.zeros((e_count, 2, kg + n), dtype=torch.int32,
                              device=dev)
            a.acc = acc.data_ptr()
        LATTICE_LIBRARY.launch("launch_lattice", a, dev, self.name)
        self.launches += 1
        return out, acc


class LpmLookupKernel:
    """K20's DIR-24-8 lookup on the card: ips int32 [B] (u32 bits) ->
    identities int32 [B] (u32 bits, 0 = no entry)."""

    name = "lpm_lookup"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return LATTICE_LIBRARY.load(verbose)

    def __call__(self, tables, ips):
        dev = _cuda_device(ips, self.name)
        if ips.dim() != 1:
            raise ValueError("ips must be [B]")
        b = _batch(int(ips.shape[0]))
        a = LpmArgs()
        a.l1, a.l2, a.n_blocks = _lpm_tables(tables, dev)
        a.ips = _ptr(ips, "ips", dev, shape=(b,))
        out = torch.empty(b, dtype=torch.int32, device=dev)
        a.out, a.B = out.data_ptr(), b
        LATTICE_LIBRARY.launch("launch_lpm_lookup", a, dev, self.name)
        self.launches += 1
        return out


LATTICE = LatticeKernel()
LPM_LOOKUP = LpmLookupKernel()


# ---------------------------------------------------------------------------
# The fused IPv6 datapath (csrc/datapath6.cu)
# ---------------------------------------------------------------------------


class IPCache6TableArgs(ctypes.Structure):
    """Mirror of cdp::IPCache6Table in csrc/ipcache6.cuh."""

    _fields_ = (
        [(name, _P) for name in ("buckets", "stash", "range_base",
                                 "range_mask", "range_plen", "range_value")]
        + [(name, _I) for name in ("nb", "stash_n", "n_ranges")]
    )


class CT6TableArgs(ctypes.Structure):
    """Mirror of cdp::CT6Table in csrc/ct6.cuh."""

    _fields_ = [("buckets", _P), ("stash", _P), ("nb", _I), ("stash_n", _I)]


class LB6TableArgs(ctypes.Structure):
    """Mirror of cdp::LB6Table in csrc/lb6.cuh."""

    _fields_ = [("rows", _P), ("stash", _P), ("nb", _I), ("stash_n", _I)]


_FLOW6 = (("ep_index", torch.int32, False), ("saddr", torch.int32, True),
          ("daddr", torch.int32, True), ("sport", torch.int32, False),
          ("dport", torch.int32, False), ("proto", torch.int32, False),
          ("direction", torch.int32, False),
          ("is_fragment", torch.bool, False))


class Datapath6Args(ctypes.Structure):
    """Mirror of cdp::Datapath6Args in csrc/datapath6.cu."""

    _fields_ = (
        [(name, _P) for name, _, _ in _FLOW6]
        + [(name, _P) for name in ("pf_base", "pf_mask", "tun_base",
                                   "tun_mask", "tun_endpoint")]
        + [("ipc", IPCache6TableArgs), ("ct", CT6TableArgs),
           ("lb", LB6TableArgs), ("pol", PolicyViewArgs)]
        + [(name, _P) for name in (
            "allowed", "proxy_port", "match_kind", "ct_result", "pre_dropped",
            "sec_id", "ct_create", "ct_delete", "tunnel_endpoint",
            "final_daddr", "final_dport", "rev_nat", "lb_slave")]
        + [(name, _I) for name in ("B", "pf_n", "tun_n")]
    )


class _Datapath6Library(_Library):
    """csrc/datapath6.cu: DATAPATH6."""

    stem = "datapath6"

    def bind(self, lib) -> None:
        self.declare(lib, (("launch_datapath6", Datapath6Args),))
        lib.datapath6_struct_sizes.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.datapath6_struct_sizes.restype = ctypes.c_int
        sizes = (ctypes.c_int * 6)()
        lib.datapath6_struct_sizes(sizes)
        want = [ctypes.sizeof(a) for a in (
            L4TablesArgs, PolicyViewArgs, IPCache6TableArgs, CT6TableArgs,
            LB6TableArgs, Datapath6Args)]
        if list(sizes) != want:
            raise RuntimeError(
                f"datapath6 argument layouts differ between kernels.py "
                f"{want} and csrc/datapath6.cu {list(sizes)}"
            )


DATAPATH6_LIBRARY = _Datapath6Library()


def _rows_of(t, name: str, dev, width: int) -> int:
    """Rows of a [R, width] table leaf (R >= 1), checked."""
    if not isinstance(t, torch.Tensor) or t.dim() != 2 or t.shape[1] != width:
        got = tuple(t.shape) if isinstance(t, torch.Tensor) else type(t)
        raise ValueError(f"{name} must be [R, {width}], got {got}")
    r = int(t.shape[0])
    if not 1 <= r < 1 << 31:
        raise ValueError(f"{name} has {r} rows")
    _ptr(t, name, dev)
    return r


def _aligned16(ptrs: dict) -> None:
    """DATAPATH6 reads these leaves in 16-byte words: each must start on
    a 16-byte boundary (a fresh tensor does; a view may not)."""
    for name, ptr in ptrs.items():
        if ptr % 16:
            raise ValueError(f"{name} does not start on a 16-byte boundary")


def _fill_tables6(a: Datapath6Args, tables, dev) -> None:
    """Check every plane DATAPATH6 reads and fill its part of `a`."""
    from cilium_tpu_torch.engine.datapath6 import (
        CT6_ENTRY_WORDS,
        CT6Snapshot,
        Prefilter6,
    )
    from cilium_tpu_torch.ipcache.lpm6 import IPCache6Device
    from cilium_tpu_torch.lb.device6 import (
        INLINE6_SLOT,
        INLINE6_STASH,
        LB6Inline,
    )

    pf = tables.prefilter
    if not isinstance(pf, Prefilter6):
        raise ValueError("the prefilter must be Prefilter6")
    a.pf_n = _rows_of(pf.base, "prefilter.base", dev, 4)
    a.pf_base = pf.base.data_ptr()
    a.pf_mask = _ptr(pf.mask, "prefilter.mask", dev, shape=(a.pf_n, 4))

    ipc = tables.ipcache
    if not isinstance(ipc, IPCache6Device):
        raise ValueError("the ipcache must be IPCache6Device")
    t = a.ipc
    t.nb = _pow2(_rows_of(ipc.buckets, "ipcache.buckets", dev, 128),
                 "ipcache buckets")
    if t.nb != ipc.n_buckets:
        raise ValueError("ipcache.buckets rows differ from n_buckets")
    t.buckets = ipc.buckets.data_ptr()
    t.stash_n = _rows_of(ipc.stash, "ipcache.stash", dev, 5)
    t.stash = ipc.stash.data_ptr()
    t.n_ranges = _rows_of(ipc.range_base, "ipcache.range_base", dev, 4)
    t.range_base = ipc.range_base.data_ptr()
    p = t.n_ranges
    t.range_mask = _ptr(ipc.range_mask, "ipcache.range_mask", dev,
                        shape=(p, 4))
    t.range_plen = _ptr(ipc.range_plen, "ipcache.range_plen", dev, shape=(p,))
    t.range_value = _ptr(ipc.range_value, "ipcache.range_value", dev,
                         shape=(p,))

    ct = tables.ct
    if not isinstance(ct, CT6Snapshot):
        raise ValueError("the conntrack must be CT6Snapshot")
    a.ct.nb = _pow2(_rows_of(ct.buckets, "ct.buckets", dev, 128), "ct buckets")
    if a.ct.nb != ct.n_buckets:
        raise ValueError("ct.buckets rows differ from n_buckets")
    a.ct.buckets = ct.buckets.data_ptr()
    a.ct.stash_n = _rows_of(ct.stash, "ct.stash", dev, CT6_ENTRY_WORDS)
    a.ct.stash = ct.stash.data_ptr()

    lb = tables.lb
    if lb is not None:
        if not isinstance(lb, LB6Inline):
            raise ValueError("the LB must be LB6Inline")
        a.lb.nb = _pow2(_rows_of(lb.rows, "lb.rows", dev, 128), "lb rows")
        if a.lb.nb != lb.n_buckets:
            raise ValueError("lb.rows differ from n_buckets")
        a.lb.rows = lb.rows.data_ptr()
        a.lb.stash_n = _rows_of(lb.stash, "lb.stash", dev, INLINE6_SLOT)
        if a.lb.stash_n > INLINE6_STASH:
            raise ValueError("LB6 stash exceeds its capacity")
        a.lb.stash = lb.stash.data_ptr()

    if tables.tunnel is not None:
        a.tun_base, a.tun_mask, a.tun_endpoint, a.tun_n = _tunnel_ranges(
            tables.tunnel, TunnelTables6, 4, dev)
    a.pol = _policy_view(tables.policy, dev)
    _aligned16({"prefilter.base": a.pf_base, "prefilter.mask": a.pf_mask,
                "ipcache.buckets": t.buckets,
                "ipcache.range_base": t.range_base,
                "ipcache.range_mask": t.range_mask,
                "ct.buckets": a.ct.buckets, "lb.rows": a.lb.rows or 0,
                "lb.stash": a.lb.stash or 0, "tunnel.base": a.tun_base or 0,
                "tunnel.mask": a.tun_mask or 0})


class Datapath6Kernel:
    """K15 on the card: the 13 Datapath6Verdicts columns of a FlowBatch6
    (int32 columns, addresses [B, 4]) against Datapath6Tables."""

    name = "datapath6"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return DATAPATH6_LIBRARY.load(verbose)

    def __call__(self, tables, flows):
        from cilium_tpu_torch.engine.datapath6 import (
            VERDICT6_COLUMNS,
            VERDICT6_DTYPES,
            Datapath6Verdicts,
        )

        dev = _cuda_device(flows.saddr, self.name)
        b = _batch(int(flows.saddr.shape[0]))
        a = Datapath6Args()
        for name, dtype, limbs in _FLOW6:
            shape = (b, 4) if limbs else (b,)
            setattr(a, name, _ptr(getattr(flows, name), f"flows.{name}", dev,
                                  dtype, shape))
        a.B = b
        _aligned16({"flows.saddr": a.saddr, "flows.daddr": a.daddr})
        _fill_tables6(a, tables, dev)
        cols = {}
        for name in VERDICT6_COLUMNS:
            shape = (b, 4) if name == "final_daddr" else (b,)
            cols[name] = torch.empty(shape, dtype=VERDICT6_DTYPES[name],
                                     device=dev)
            setattr(a, name, cols[name].data_ptr())
        DATAPATH6_LIBRARY.launch("launch_datapath6", a, dev, self.name)
        self.launches += 1
        return Datapath6Verdicts(**cols)


DATAPATH6 = Datapath6Kernel()


# ---------------------------------------------------------------------------
# The churn loop's pick draw (csrc/prng.cu)
# ---------------------------------------------------------------------------


class PickArgs(ctypes.Structure):
    """Mirror of cpr::PickArgs in csrc/prng.cu, field for field."""

    _fields_ = [("picks", _P), ("k1", ctypes.c_uint32 * 2),
                ("k2", ctypes.c_uint32 * 2), ("span", ctypes.c_uint32),
                ("mult", ctypes.c_uint32), ("n", ctypes.c_int64)]


class _PrngLibrary(_Library):
    """csrc/prng.cu: PICK_DRAW."""

    stem = "prng"

    def bind(self, lib) -> None:
        self.declare(lib, (("launch_pick_draw", PickArgs),))
        lib.prng_args_size.argtypes = []
        lib.prng_args_size.restype = ctypes.c_int
        if lib.prng_args_size() != ctypes.sizeof(PickArgs):
            raise RuntimeError(
                "PickArgs layout differs between kernels.py and csrc/prng.cu"
            )


PRNG_LIBRARY = _PrngLibrary()


class PickDrawKernel:
    """K22's draw on the card: int32 [n] with the u32 picks of
    `randint(key, (n,), 0, span, uint32)`, from the key's two split
    subkeys ((k1, k2) as prng.split returns them)."""

    name = "pick_draw"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return PRNG_LIBRARY.load(verbose)

    def __call__(self, subkeys, n: int, span: int, device):
        from cilium_tpu_torch.prng import randint_multiplier

        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"{self.name}: the kernel runs on CUDA, got {dev}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        n, span = int(n), int(span)
        if not 0 <= n < 1 << 40:
            raise ValueError(f"{self.name}: n = {n}")
        if not 1 <= span <= 0xFFFFFFFF:
            raise ValueError(f"{self.name}: span = {span}")
        a = PickArgs()
        (a.k1[0], a.k1[1]), (a.k2[0], a.k2[1]) = subkeys
        a.span, a.mult, a.n = span, randint_multiplier(span), n
        picks = torch.empty(n, dtype=torch.int32, device=dev)
        a.picks = picks.data_ptr()
        PRNG_LIBRARY.launch("launch_pick_draw", a, dev, self.name)
        self.launches += 1
        return picks


PICK_DRAW = PickDrawKernel()


# ---------------------------------------------------------------------------
# The verdict memo (csrc/memo.cu, and DATAPATH_PAIR's memo mode)
# ---------------------------------------------------------------------------

_RADIX = 256
_RADIX_TILE = 4096  # csrc/radix.cuh TILE
_DEDUP_BIG_TILE = 4096  # csrc/memo.cu BIG_TILE
_DEDUP_FEW_TILES = 32  # csrc/memo.cu FEW_TILES
# MEMO_CACHE's scratch regions in CacheArgs order: per representative
# (rep_cap words; rv two, r_hit and r_hit_lane a byte, hit_bits a bit),
# per bucket (n_rows; b_slots SLOTS), then the control words
# (csrc/memo.cu CTL_WORDS)
CACHE_SCRATCH = ("r_bucket", "r_rank_word", "r_empty", "r_arrive", "rv",
                 "hit_bits", "seg", "r_hit", "r_hit_lane", "b_count",
                 "b_start", "b_placed", "b_slots")
_CACHE_CTL_WORDS = 8  # csrc/memo.cu CTL_WORDS
_CACHE_SLOTS = 4  # csrc/memo.cu SLOTS: a bucket's own member slots
# the PolicyTables leaves _policy_view reads
_VIEW_LEAVES = ("id_table", "id_direct", "id_lo_len", "port_slot", "l4_meta",
                "l4_allow_bits", "l3_allow_bits", "l4_hash_rows",
                "l4_hash_stash", "l4_wild_rows", "l4_wild_stash")


class SortArgs(ctypes.Structure):
    """Mirror of cmm::SortArgs in csrc/memo.cu, field for field."""

    _fields_ = [("key", (_P * 3) * 2), ("val", _P * 2), ("hist", _P),
                ("digits", _P), ("parity", _P), ("n", _P), ("cap", _I),
                ("n_blocks", _I)]


class DedupArgs(ctypes.Structure):
    """Mirror of cmm::DedupArgs in csrc/memo.cu, field for field."""

    _fields_ = (
        [(name, _P) for name in ("keys", "slot", "slot_group",
                                 "row_slot")]
        + [("sk", (_P * 4) * 2)]
        + [(name, _P) for name in (
            "hist", "totals", "dtot", "status", "misc", "bar", "srow", "gid",
            "rgid", "n_unique", "rep_orig", "rep_valid", "overflow")]
        + [("B", _I), ("rep_cap", _I), ("t_mask", ctypes.c_uint32)]
    )


class CacheArgs(ctypes.Structure):
    """Mirror of cmm::CacheArgs in csrc/memo.cu, field for field."""

    _fields_ = (
        [("pol", PolicyViewArgs)]
        + [(name, _P) for name in (
            "keys", "ep_w", "dir_w", "rgid", "rep_orig", "n_unique",
            "dedup_overflow", "rows_in", "rows_out", "restore", "v0", "v1",
            "hit", "stats", *CACHE_SCRATCH, "ctl")]
        + [(name, _I) for name in (
            "B", "rep_cap", "n_rows", "width", "entries",
            "ranked", "subword", "has_l3", "accumulate", "hit_smem_words")]
    )


class KeysArgs(ctypes.Structure):
    """Mirror of cmm::KeysArgs in csrc/memo.cu, field for field."""

    _fields_ = [("tuples", _P), ("pol", PolicyViewArgs), ("keys", _P),
                ("v0", _P), ("v1", _P), ("allowed", _P), ("proxy_port", _P),
                ("match_kind", _P), ("B", _I), ("mode", _I)]


class _MemoLibrary(_Library):
    """csrc/memo.cu: MEMO_DEDUP, MEMO_CACHE and MEMO_KEYS_LATTICE."""

    stem = "memo"

    def bind(self, lib) -> None:
        self.declare(lib, (("launch_memo_dedup", DedupArgs),
                           ("launch_memo_cache", CacheArgs),
                           ("launch_memo_keys", KeysArgs)))
        lib.memo_struct_sizes.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.memo_struct_sizes.restype = ctypes.c_int
        sizes = (ctypes.c_int * 5)()
        lib.memo_struct_sizes(sizes)
        want = [ctypes.sizeof(a) for a in (SortArgs, DedupArgs, CacheArgs,
                                           KeysArgs, PolicyViewArgs)]
        if list(sizes) != want:
            raise RuntimeError(
                f"memo argument layouts differ between kernels.py {want} "
                f"and csrc/memo.cu {list(sizes)}"
            )


MEMO_LIBRARY = _MemoLibrary()


def _sort_args(cap: int, key_words: int, passes: int, n_ptr: int,
               dev) -> tuple:
    """A SortArgs over `cap` elements of `key_words` key words and its
    buffers (kept alive by the caller)."""
    n_blocks = max((cap + _RADIX_TILE - 1) // _RADIX_TILE, 1)
    bufs = [torch.empty((2, key_words + 1, cap), dtype=torch.int32,
                        device=dev),
            torch.empty(_RADIX * (n_blocks + 2), dtype=torch.int32,
                        device=dev),
            torch.empty(passes + 1, dtype=torch.int32, device=dev)]
    s = SortArgs()
    for side in (0, 1):
        for w in range(key_words):
            s.key[side][w] = bufs[0][side, w].data_ptr()
        s.val[side] = bufs[0][side, key_words].data_ptr()
    s.hist, s.parity, s.n = bufs[1].data_ptr(), bufs[2].data_ptr(), n_ptr
    s.digits = bufs[1][_RADIX * n_blocks:].data_ptr()
    s.cap, s.n_blocks = cap, n_blocks
    return s, bufs


def _keys3(keys, name: str):
    dev = _cuda_device(keys, name)
    if keys.dim() != 2 or keys.shape[0] != 3:
        raise ValueError(f"{name}: keys must be [3, B], got "
                         f"{tuple(keys.shape)}")
    b = int(keys.shape[1])
    if not 1 <= b < 1 << 31:
        raise ValueError(f"{name}: batch of {b}")
    _ptr(keys, "keys", dev)
    return dev, b


def dedup_scratch_words(b: int) -> tuple:
    """MEMO_DEDUP's scratch for a batch of `b`: the hash table's slots
    (a power of two, at least 2b and 64; 8 bytes each) and the word
    count of each region, in DedupArgs order (each a multiple of 4
    words: 16-byte aligned)."""
    slots = max(64, 1 << (2 * b - 1).bit_length())
    tiles = max(-(-b // _DEDUP_BIG_TILE), _DEDUP_FEW_TILES)
    up4 = lambda n: -(-n // 4) * 4
    return slots, (("slot", 2 * slots), ("slot_group", slots),
                   ("row_slot", up4(b)),
                   *((f"sk{side}{w}", up4(b)) for side in (0, 1)
                     for w in range(4)),
                   ("hist", 256 * tiles), ("totals", 256),
                   ("dtot", 16 * 256), ("status", 16 * _DEDUP_FEW_TILES * 256),
                   ("misc", 8), ("bar", 4))


class MemoDedupKernel:
    """K14's level A on the card: memo.dedup_groups of the key words
    keys int32 [3, B] (u32 bits).  Returns the dict of dedup_groups with
    tensors: srow, gid, rgid int32 [B], n_unique int32 [1], rep_orig
    int32 [rep_cap + 1], rep_valid bool [rep_cap], overflow int32 [1].
    One cooperative launch (csrc/memo.cu); its scratch is one
    allocation."""

    name = "memo_dedup"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return MEMO_LIBRARY.load(verbose)

    def __call__(self, keys, rep_cap: int) -> dict:
        dev, b = _keys3(keys, self.name)
        rep_cap = int(rep_cap)
        if not 1 <= rep_cap < (1 << 31) - 1:
            raise ValueError(f"{self.name}: rep_cap = {rep_cap}")
        ints = torch.empty(2, dtype=torch.int32, device=dev)
        out = dict(
            srow=torch.empty(b, dtype=torch.int32, device=dev),
            gid=torch.empty(b, dtype=torch.int32, device=dev),
            rgid=torch.empty(b, dtype=torch.int32, device=dev),
            n_unique=ints[0:1], overflow=ints[1:2],
            rep_orig=torch.empty(rep_cap + 1, dtype=torch.int32, device=dev),
            rep_valid=torch.empty(rep_cap, dtype=torch.bool, device=dev),
        )
        slots, regions = dedup_scratch_words(b)
        words = sum(n for _, n in regions)
        scratch = torch.empty(words, dtype=torch.int32, device=dev)
        a = DedupArgs()
        at = scratch.data_ptr()
        for name, n in regions:
            if name.startswith("sk"):
                a.sk[int(name[2])][int(name[3])] = at
            else:
                setattr(a, name, at)
            at += 4 * n
        a.keys = keys.data_ptr()
        for name, t in out.items():
            setattr(a, name, t.data_ptr())
        a.B, a.rep_cap, a.t_mask = b, rep_cap, slots - 1
        MEMO_LIBRARY.launch("launch_memo_dedup", a, dev, self.name)
        self.launches += 1
        # the scratch may be freed now: the caching allocator hands it
        # only to work queued after the kernel on the same stream
        del scratch
        return out


def cache_scratch_words(rep_cap: int, n_rows: int) -> tuple:
    """MEMO_CACHE's scratch regions in CacheArgs order, (name, int32
    words) each a multiple of 4 words (16-byte aligned): CACHE_SCRATCH
    (per representative, per bucket), then the control words."""
    up4 = lambda n: -(-n // 4) * 4
    per = {"rv": 2 * up4(rep_cap), "hit_bits": up4(-(-rep_cap // 32)),
           "r_hit": up4(-(-rep_cap // 4)), "r_hit_lane": up4(-(-rep_cap // 4)),
           "b_count": up4(n_rows), "b_start": up4(n_rows),
           "b_placed": up4(n_rows),
           "b_slots": up4(n_rows * _CACHE_SLOTS)}
    return tuple((n, per.get(n, up4(rep_cap))) for n in CACHE_SCRATCH) + (
        ("ctl", _CACHE_CTL_WORDS),)


class MemoCacheKernel:
    """K14's level B on the card: the probe of each representative of
    MEMO_DEDUP's groups `g` in rows_in ([n_rows + 1, W] int32, any of the
    three layouts), the insert lanes, the lattice (index_probes over the
    policy tables `pol`) on the missed representatives, the commit into
    rows_out (which the rows are first copied into when it is another
    buffer) when nothing overflowed, and the scatter-back in row order
    (g["rgid"]).  Writes the stats row into `stats` int32 [5] (added to
    it with `accumulate`); with `restore` copies those rows back into
    rows_out when the stats show an overflow.  `has_l3`: key bit 0 is
    the ipcache's L3 bit (else probe 2 reads l3_allow_bits); `ep_dir`:
    the tuples' endpoint and direction words [B] (else decoded from
    k2).  Returns (v0, v1 int32 [B], hit bool [B]), into `out` when
    given.  One cooperative launch (csrc/memo.cu).

    The scratch (cache_scratch_words) is kept across calls, one
    allocation per (device, stream), laid out for the largest rep_cap
    and n_rows seen there and regrown past them: calls on one stream
    run in order, so each may reuse it (the old buffer goes back to the
    allocator in stream order); a call on another stream gets its own.
    Its barrier words are zeroed when it is made, and each call leaves
    them zero.  The policy tables' view is rebuilt only when an address,
    shape or dtype of a leaf it reads (_VIEW_LEAVES) differs from the
    last call's."""

    name = "memo_cache"

    def __init__(self) -> None:
        self.launches = 0
        self._scratch = {}  # (device, stream) -> (rep_cap, n_rows, ptrs, buf)
        self._view = (None, None)  # (leaves_key, view)

    def load(self, verbose: bool = False):
        return MEMO_LIBRARY.load(verbose)

    def _policy(self, pol, dev) -> PolicyViewArgs:
        key = [dev]
        for name in _VIEW_LEAVES:
            x = getattr(pol, name)
            key.append((x.data_ptr(), x.shape, x.dtype)
                       if isinstance(x, torch.Tensor) else x)
        if key != self._view[0]:
            self._view = (key, _policy_view(pol, dev))
        return self._view[1]

    def _scratch_ptrs(self, dev, rep_cap: int, n_rows: int) -> dict:
        key = (dev.index, _stream(dev))
        got = self._scratch.get(key)
        if got is None or got[0] < rep_cap or got[1] < n_rows:
            if got is not None:
                rep_cap, n_rows = max(rep_cap, got[0]), max(n_rows, got[1])
            regions = cache_scratch_words(rep_cap, n_rows)
            buf = torch.zeros(sum(n for _, n in regions), dtype=torch.int32,
                              device=dev)
            ptrs, at = {}, buf.data_ptr()
            for name, n in regions:
                ptrs[name] = at
                at += 4 * n
            got = self._scratch[key] = (rep_cap, n_rows, ptrs, buf)
        return got[2]

    def __call__(self, pol, keys, g, rows_in, rows_out, stats, *,
                 rep_cap: int, has_l3: bool,
                 accumulate: bool = False, restore=None, ep_dir=None,
                 out=None):
        from cilium_tpu_torch.engine.memo import cache_layout, rank_column

        dev, b = _keys3(keys, self.name)
        rep_cap = int(rep_cap)
        if not 1 <= rep_cap < 1 << 31:
            raise ValueError(f"{self.name}: rep_cap {rep_cap}")
        if rows_in.dim() != 2 or rows_in.shape[0] < 2:
            raise ValueError(f"{self.name}: rows must be [n_rows + 1, W]")
        n_rows = _pow2(int(rows_in.shape[0]) - 1, "cache rows")
        width = int(rows_in.shape[1])
        e, ranked, subw = cache_layout(rows_in)
        if not 1 <= e <= 32 or rank_column(rows_in) + int(ranked) > width:
            raise ValueError(f"{self.name}: no row layout is {width} wide")
        a = CacheArgs()
        a.pol = self._policy(pol, dev)
        a.keys = keys.data_ptr()
        if ep_dir is not None:
            a.ep_w = _ptr(ep_dir[0], "ep words", dev, shape=(b,))
            a.dir_w = _ptr(ep_dir[1], "direction words", dev, shape=(b,))
        a.rgid = _ptr(g["rgid"], "rgid", dev, shape=(b,))
        a.rep_orig = _ptr(g["rep_orig"], "rep_orig", dev, shape=(rep_cap + 1,))
        a.n_unique = _ptr(g["n_unique"], "n_unique", dev, shape=(1,))
        a.dedup_overflow = _ptr(g["overflow"], "overflow", dev, shape=(1,))
        shape = tuple(rows_in.shape)
        a.rows_in = _ptr(rows_in, "rows_in", dev)
        a.rows_out = _ptr(rows_out, "rows_out", dev, shape=shape)
        if restore is not None:
            a.restore = _ptr(restore, "restore", dev, shape=shape)
        a.stats = _ptr(stats, "stats", dev, shape=(5,))
        if out is None:
            out = (torch.empty(b, dtype=torch.int32, device=dev),
                   torch.empty(b, dtype=torch.int32, device=dev),
                   torch.empty(b, dtype=torch.bool, device=dev))
        a.v0 = _ptr(out[0], "v0", dev, shape=(b,))
        a.v1 = _ptr(out[1], "v1", dev, shape=(b,))
        a.hit = _ptr(out[2], "hit", dev, dtype=torch.bool, shape=(b,))
        for name, at in self._scratch_ptrs(dev, rep_cap, n_rows).items():
            setattr(a, name, at)
        a.B, a.rep_cap, a.n_rows, a.width = b, rep_cap, n_rows, width
        a.entries, a.ranked, a.subword = e, int(ranked), int(subw)
        a.has_l3 = int(bool(has_l3))
        a.accumulate = int(bool(accumulate))
        MEMO_LIBRARY.launch("launch_memo_cache", a, dev, self.name)
        self.launches += 1
        return out


class MemoKeysLatticeKernel:
    """memo_evaluate's front and back on the card: `keys(pol, packed)`
    gives the key words int32 [3, B] of a [6, B] tuple pack (the identity
    index through id_direct, memo.memo_key_words without an L3 bit);
    `combine(v0, v1, packed)` the Verdicts of the memo's value words and
    the pack's fragment words.  Each call is one launch."""

    name = "memo_keys_lattice"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return MEMO_LIBRARY.load(verbose)

    def _args(self, pol, packed, mode: int, view=None):
        dev = _cuda_device(packed, self.name)
        if packed.dim() != 2 or packed.shape[0] != 6:
            raise ValueError(f"{self.name}: the tuple pack must be [6, B]")
        b = _batch(int(packed.shape[1]))
        a = KeysArgs()
        a.tuples = _ptr(packed, "tuples", dev, shape=(6, b))
        if view is not None:
            a.pol = view
        elif pol is not None:
            a.pol = _policy_view(pol, dev)
        a.B, a.mode = b, mode
        return a, dev, b

    def keys(self, pol, packed, view=None):
        """`view` (a PolicyViewArgs) in place of `pol`: a mesh shard's
        tables (_shard_view), whose identity index tables are whole."""
        a, dev, b = self._args(pol, packed, 0, view)
        keys = torch.empty((3, b), dtype=torch.int32, device=dev)
        a.keys = keys.data_ptr()
        MEMO_LIBRARY.launch("launch_memo_keys", a, dev, self.name)
        self.launches += 1
        return keys

    def combine(self, v0, v1, packed):
        from cilium_tpu_torch.engine.verdict import Verdicts

        a, dev, b = self._args(None, packed, 1)
        a.v0 = _ptr(v0, "v0", dev, shape=(b,))
        a.v1 = _ptr(v1, "v1", dev, shape=(b,))
        v = Verdicts(
            allowed=torch.empty(b, dtype=torch.uint8, device=dev),
            proxy_port=torch.empty(b, dtype=torch.int32, device=dev),
            match_kind=torch.empty(b, dtype=torch.uint8, device=dev),
        )
        a.allowed = v.allowed.data_ptr()
        a.proxy_port = v.proxy_port.data_ptr()
        a.match_kind = v.match_kind.data_ptr()
        MEMO_LIBRARY.launch("launch_memo_keys", a, dev, self.name)
        self.launches += 1
        return v


class MemoFront:
    """What DATAPATH_PAIR's memo front pass leaves for the back pass: the
    launch arguments, the 15 columns (8 of them written), the key words
    int32 [2, 3, B] and whether key bit 0 is the ipcache's L3 bit."""

    def __init__(self, args, cols, keys, has_l3: bool) -> None:
        self.args = args
        self.cols = cols
        self.keys = keys
        self.has_l3 = has_l3


class DatapathPairMemoKernel:
    """DATAPATH_PAIR's memo mode (csrc/datapath.cu) on the card.
    `front(tables, pair)` runs stages 1-5 of both halves, writes the
    columns that do not depend on the lattice and the policy-key words,
    and returns a MemoFront; `back(tables, pair, front, vals, acc, telem,
    stats)` takes the memo's value words vals int32 [2, 2, B] (v0, v1 per
    half) and the summed stats int32 [5], runs the combine, the tunnel
    stage, the counters into `acc` and the telemetry into `telem` (both
    only when the stats show no overflow) and returns (out_in, out_eg).
    Each pass is one launch."""

    name = "datapath_pair_memo"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return DATAPATH_LIBRARY.load(verbose)

    def front(self, tables, pair) -> MemoFront:
        dev = _cuda_device(pair, self.name)
        if pair.dim() != 3 or pair.shape[:2] != (2, 4):
            raise ValueError(f"pair must be [2, 4, B], got {tuple(pair.shape)}")
        b = _batch(int(pair.shape[2]))
        a = DatapathArgs()
        a.pair = _ptr(pair, "pair", dev)
        a.B = b
        _fill_tables(a, tables, dev)
        cols = _alloc_columns(a, (2, b), dev)
        keys = torch.empty((2, 3, b), dtype=torch.int32, device=dev)
        a.memo_keys, a.memo = keys.data_ptr(), 1
        DATAPATH_LIBRARY.launch("launch_datapath_pair", a, dev, self.name)
        self.launches += 1
        return MemoFront(a, cols, keys, (a.layout >> 2) == IPC_IDX_PLANES)

    def back(self, tables, pair, front: MemoFront, vals, acc, telem, stats):
        dev = _cuda_device(pair, self.name)
        a = front.args
        b = int(a.B)
        if a.pair != pair.data_ptr():
            raise ValueError("back() takes the pair its front() ran on")
        a.memo_vals = _ptr(vals, "vals", dev, shape=(2, 2, b))
        a.memo_stats = _ptr(stats, "stats", dev, shape=(5,))
        a.acc = _ptr(acc, "acc", dev, shape=(a.n_eps, 2, a.kg + a.n_ids))
        a.telem = _ptr(telem, "telem", dev, shape=(2, TELEM_COLS))
        a.memo = 2
        DATAPATH_LIBRARY.launch("launch_datapath_pair", a, dev, self.name)
        self.launches += 1
        cols = front.cols
        return (DatapathVerdicts(**{k: v[0] for k, v in cols.items()}),
                DatapathVerdicts(**{k: v[1] for k, v in cols.items()}))


MEMO_DEDUP = MemoDedupKernel()
MEMO_CACHE = MemoCacheKernel()
MEMO_KEYS_LATTICE = MemoKeysLatticeKernel()
DATAPATH_PAIR_MEMO = DatapathPairMemoKernel()


# ---------------------------------------------------------------------------
# The device table store's delta scatter (csrc/publish.cu)
# ---------------------------------------------------------------------------

MAX_SCATTER_SEGMENTS = 16  # csrc/publish.cu MAX_SEGMENTS
MAX_TILE_ROWS = 2048  # csrc/publish.cu MAX_TILE_ROWS
SCATTER_TILE_WORDS = (1 << 10, 1 << 13)  # a tile's words, least and most
SCATTER_TARGET_TILES = 132  # about one block an SM of an H100
# cpub::Segment, every field 8 bytes, then cpub::Args's n_seg and tiles
SEGMENT_FIELDS = ("dst", "idx0", "idx1", "values", "size0", "size1",
                  "outer", "inner", "k", "cols", "log_rows", "outers",
                  "col_tiles", "row_tiles", "tile_start")
_SCATTER_ARGS = ctypes.c_int64 * (
    len(SEGMENT_FIELDS) * MAX_SCATTER_SEGMENTS + 2)
_DELTA_ARGS = ctypes.c_int64 * (len(SEGMENT_FIELDS) + 2)  # cpub::ArgsOf<1>


@functools.lru_cache(maxsize=4096)
def scatter_tile_words(total: int) -> int:
    """A scatter tile's words for a launch that moves `total` payload
    words: the power of two at or below total / SCATTER_TARGET_TILES,
    kept within SCATTER_TILE_WORDS (small scatters still fill the card,
    large ones keep several 16-byte vectors a thread)."""
    lo, hi = SCATTER_TILE_WORDS
    return min(hi, max(lo, 1 << max(
        (total // SCATTER_TARGET_TILES).bit_length() - 1, 0)))


@functools.lru_cache(maxsize=4096)
def scatter_tiling(outer: int, k: int, inner: int, tile_words: int) -> tuple:
    """csrc/publish.cu's tiles of a segment of values [outer, k, inner]:
    (cols, log_rows, outers, col_tiles, row_tiles, outer_tiles).  A tile
    is `outers` outer rows x 1 << log_rows index rows x `cols` words of
    a row (the last tile of each axis clipped), at most `tile_words`
    words; a row wider than a tile is split into column chunks, one
    index row a tile.  Cached: a store scatters the same leaf shapes
    and payload sizes again and again."""
    cols = inner if inner < tile_words else tile_words
    cap = tile_words // cols
    rows = MAX_TILE_ROWS if cap >= MAX_TILE_ROWS else (
        1 << (cap.bit_length() - 1))
    if k < rows:
        rows = 1 << (k - 1).bit_length()
    outers = tile_words // (cols * (k if k < rows else rows))
    if outers > outer:
        outers = outer
    return (cols, rows.bit_length() - 1, outers, -(-inner // cols),
            -(-k // rows), -(-outer // outers))


class _PublishLibrary(_Library):
    """csrc/publish.cu: PUBLISH_SCATTER and REPAIR_SCATTER."""

    stem = "publish"

    def bind(self, lib) -> None:
        for launch in ("launch_publish_scatter", "launch_repair_scatter"):
            getattr(lib, launch).argtypes = [_P, _P]
            getattr(lib, launch).restype = ctypes.c_int
        lib.publish_struct_sizes.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.publish_struct_sizes.restype = ctypes.c_int
        got = (ctypes.c_int * 4)()
        lib.publish_struct_sizes(got)
        want = [8 * len(SEGMENT_FIELDS), ctypes.sizeof(_SCATTER_ARGS),
                MAX_SCATTER_SEGMENTS, MAX_TILE_ROWS]
        if list(got) != want:
            raise RuntimeError(
                f"publish argument layout and limits differ between "
                f"kernels.py {want} and csrc/publish.cu {list(got)}"
            )

    def scatter(self, launch: str, geo, device, name: str) -> None:
        """One launch over the segments `geo` (scatter_args)."""
        args = scatter_args(geo, name)
        err = getattr(self.load(), launch)(ctypes.addressof(args),
                                           _stream(device))
        if err != 0:
            raise KernelError(f"{name} launch failed: CUDA error {err}")


def scatter_args(geo, name: str, block=_SCATTER_ARGS):
    """csrc/scatter.cuh's argument block for the segments `geo`, each
    (dst, idx0, idx1, values pointers, size0, size1, outer, inner, k):
    the segments and their tiles (scatter_tiling), as int64 words, in
    `block` (ArgsOf<16> or, for one segment, ArgsOf<1>)."""
    tile_words = scatter_tile_words(sum(g[6] * g[7] * g[8] for g in geo))
    flat, tiles = [], 0
    for g in geo:
        cols, log_rows, outers, ct, rt, ot = scatter_tiling(
            g[6], g[8], g[7], tile_words)
        flat.extend(g)
        flat.extend((cols, log_rows, outers, ct, rt, tiles))
        tiles += ct * rt * ot
    if tiles >= 1 << 31:
        raise ValueError(f"{name}: {tiles} tiles in one launch")
    args = block()
    args[:len(flat)] = flat
    args[-2], args[-1] = len(geo), tiles
    return args


PUBLISH_LIBRARY = _PublishLibrary()


def _cell_limit(cells: int) -> None:
    # csrc/publish.cu stages a row's cell index as int32
    if cells >= 1 << 31:
        raise ValueError(f"{cells} cells, at most 2**31 - 1")


def _publish_geometry(dst, idx, values, dev) -> tuple:
    """One publish segment's pointers (checked by _ptr) and sizes."""
    axes = len(idx)
    shape = tuple(dst.shape)
    if axes not in (1, 2) or len(shape) < axes:
        raise ValueError(f"{axes} indexed axes of a {len(shape)}-d leaf")
    rows = values.shape[0]
    size1 = shape[1] if axes == 2 else 1
    _cell_limit(shape[0] * size1)
    return (_ptr(dst, "dst", dev),
            _ptr(idx[0], "idx[0]", dev, torch.int64, (rows,)),
            _ptr(idx[1], "idx[1]", dev, torch.int64, (rows,))
            if axes == 2 else 0,
            _ptr(values, "values", dev, shape=(rows,) + shape[axes:]),
            shape[0], size1, 1, math.prod(shape[axes:]), rows)


def _repair_geometry(dst, axis: int, idx, values, dev) -> tuple:
    """One repair segment's pointers (checked by _ptr) and sizes."""
    shape = tuple(dst.shape)
    if not 0 <= axis < len(shape):
        raise ValueError(f"axis {axis} of a {len(shape)}-d leaf")
    k = idx.shape[0]
    _cell_limit(shape[axis])
    return (_ptr(dst, "dst", dev),
            _ptr(idx, "idx", dev, torch.int64, (k,)), 0,
            _ptr(values, "values", dev,
                 shape=shape[:axis] + (k,) + shape[axis + 1:]),
            shape[axis], 1, math.prod(shape[:axis]),
            math.prod(shape[axis + 1:]), k)


class PublishScatterKernel:
    """K18's publish scatter on the card: for each (dst, idx, values) of
    `segments`, dst[idx] = values in place, in one launch, with
    scatter_segments_plain's rules (negative indices count from the end
    once, a row with an index out of range is dropped).  dst is an
    int32 tensor; idx a tuple of 1 or 2 int64 [R] tensors (the indexed
    leading axes); values int32 [R, *dst.shape[len(idx):]]."""

    name = "publish_scatter"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return PUBLISH_LIBRARY.load(verbose)

    def __call__(self, segments):
        segments = [s for s in segments if s[2].numel()]
        if not segments:
            return
        if len(segments) > MAX_SCATTER_SEGMENTS:
            raise ValueError(f"{len(segments)} leaves in one scatter, at "
                             f"most {MAX_SCATTER_SEGMENTS}")
        dev = _cuda_device(segments[0][0], self.name)
        geo = []
        for n, (dst, idx, values) in enumerate(segments):
            try:
                geo.append(_publish_geometry(dst, idx, values, dev))
            except (TypeError, ValueError) as exc:
                raise type(exc)(f"segment {n}: {exc}") from None
        PUBLISH_LIBRARY.scatter("launch_publish_scatter", geo, dev,
                                self.name)
        self.launches += 1


class RepairScatterKernel:
    """K18's readmission repair on the card: for each (dst, axis, idx,
    values) of `segments`, dst[(slice(None),) * axis + (idx,)] = values
    in place, in one launch, with engine/publish.py
    repair_segments_plain's rules (negative indices count from the end
    once, an index out of range is dropped).  dst is an int32 tensor;
    idx int64 [K]; values int32 of dst's shape with K at `axis`."""

    name = "repair_scatter"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return PUBLISH_LIBRARY.load(verbose)

    def __call__(self, segments):
        segments = [s for s in segments if s[3].numel()]
        if not segments:
            return
        if len(segments) > MAX_SCATTER_SEGMENTS:
            raise ValueError(f"{len(segments)} leaves in one repair, at "
                             f"most {MAX_SCATTER_SEGMENTS}")
        dev = _cuda_device(segments[0][0], self.name)
        geo = []
        for n, (dst, axis, idx, values) in enumerate(segments):
            try:
                geo.append(_repair_geometry(dst, int(axis), idx, values,
                                            dev))
            except (TypeError, ValueError) as exc:
                raise type(exc)(f"segment {n}: {exc}") from None
        PUBLISH_LIBRARY.scatter("launch_repair_scatter", geo, dev,
                                self.name)
        self.launches += 1


PUBLISH_SCATTER = PublishScatterKernel()
REPAIR_SCATTER = RepairScatterKernel()


# ---------------------------------------------------------------------------
# The shadow plane's verdict diff (csrc/shadow.cu)
# ---------------------------------------------------------------------------

_DIFF_IN = ("live_allowed", "live_proxy", "live_kind", "shadow_allowed",
            "shadow_proxy", "shadow_kind")
_DIFF_OUT = ("ca", "cp", "ck", "trans")


class DiffArgs(ctypes.Structure):
    """Mirror of cshd::DiffArgs in csrc/shadow.cu, field for field."""

    _fields_ = ([(name, _P) for name in _DIFF_IN + _DIFF_OUT]
                + [("n", ctypes.c_int64), ("vector", _I), ("pad", _I)])


class _ShadowLibrary(_Library):
    """csrc/shadow.cu: SHADOW_DIFF."""

    stem = "shadow"

    def bind(self, lib) -> None:
        self.declare(lib, (("launch_shadow_diff", DiffArgs),))
        lib.shadow_struct_sizes.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.shadow_struct_sizes.restype = ctypes.c_int
        sizes = (ctypes.c_int * 1)()
        lib.shadow_struct_sizes(sizes)
        if list(sizes) != [ctypes.sizeof(DiffArgs)]:
            raise RuntimeError(
                f"shadow argument layout differs between kernels.py "
                f"{ctypes.sizeof(DiffArgs)} and csrc/shadow.cu {list(sizes)}"
            )


SHADOW_LIBRARY = _ShadowLibrary()


class ShadowDiffKernel:
    """K19 on the card: the per-row diff of a live and a shadow verdict
    set.  Takes allowed u8, proxy_port int32 and match_kind u8 columns,
    live then shadow, all [B] on one CUDA device; returns (ca, cp, ck,
    trans), u8 [B] each, with shadow.diff_codes_plain's values."""

    name = "shadow_diff"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return SHADOW_LIBRARY.load(verbose)

    def __call__(self, live_allowed, live_proxy, live_kind, shadow_allowed,
                 shadow_proxy, shadow_kind):
        cols = (live_allowed, live_proxy, live_kind, shadow_allowed,
                shadow_proxy, shadow_kind)
        dev = _cuda_device(live_allowed, self.name)
        if live_allowed.dim() != 1:
            raise ValueError(f"{self.name}: columns must be [B], got "
                             f"{tuple(live_allowed.shape)}")
        n = int(live_allowed.shape[0])
        if n >= 1 << 31:
            raise ValueError(f"{self.name}: {n} rows, at most 2^31 - 1")
        a = DiffArgs()
        for name, col in zip(_DIFF_IN, cols):
            dtype = torch.int32 if name.endswith("proxy") else torch.uint8
            setattr(a, name, _ptr(col, name, dev, dtype, (n,)))
        out = tuple(torch.empty((len(_DIFF_OUT), n), dtype=torch.uint8,
                                device=dev))
        for name, col in zip(_DIFF_OUT, out):
            setattr(a, name, col.data_ptr())
        # the four-row loads: u8 columns on 4 bytes, proxy columns on 16
        a.vector = int(all(
            c.data_ptr() % (16 if c.dtype == torch.int32 else 4) == 0
            for c in cols + out))
        a.n = n
        if n:
            SHADOW_LIBRARY.launch("launch_shadow_diff", a, dev, self.name)
            self.launches += 1
        return out


SHADOW_DIFF = ShadowDiffKernel()

# ---------------------------------------------------------------------------
# The lattice on a mesh (csrc/mesh.cu)
# ---------------------------------------------------------------------------

MESH_MAX_TP = 16  # csrc/mesh.cu MAX_TP
MESH_RECORD_ROWS = 4  # MESH_PROBE's record: flags, proxy, j, L3 column
ROUTED_RECORD_ROWS = 5  # ROUTED_PROBE's: flags, owner, stash, wild, column


class MeshProbeArgs(ctypes.Structure):
    """Mirror of cms::MeshProbeArgs in csrc/mesh.cu, field for field."""

    _fields_ = [("tuples", _P), ("pol", PolicyViewArgs), ("out", _P),
                ("B", _I), ("w_off", _I)]


class RoutedProbeArgs(ctypes.Structure):
    """Mirror of cms::RoutedProbeArgs in csrc/mesh.cu, field for field."""

    _fields_ = ([("tuples", _P), ("pol", PolicyViewArgs), ("alive", _P),
                 ("out", _P)]
                + [(n, _I) for n in (
                    "B", "t", "ntp", "rows_sharded", "l3_sharded",
                    "failover", "n_rows_global", "n_local", "w_local",
                    "n_row_shard", "wn", "n_ids")])


class CountsArgs(ctypes.Structure):
    """Mirror of cms::Counts in csrc/mesh.cu, field for field."""

    _fields_ = [("base", _P), ("l3_at", ctypes.c_int64),
                ("telem_at", ctypes.c_int64), ("replica_at", ctypes.c_int64),
                ("words", ctypes.c_int64)]


class CombineArgs(ctypes.Structure):
    """Mirror of cms::CombineArgs in csrc/mesh.cu, field for field."""

    _fields_ = ([("parts", _P * MESH_MAX_TP)]
                + [(n, _P) for n in (
                    "tuples", "meta", "valid", "allowed", "proxy_port",
                    "match_kind")]
                + [("counts", CountsArgs), ("bar", _P)]
                + [(n, _I) for n in (
                    "B", "tp", "mode", "ew", "n_eps", "kg", "l3_shards",
                    "c_local")])


class MemoProbeArgs(ctypes.Structure):
    """Mirror of cms::MemoProbeArgs in csrc/mesh.cu, field for field."""

    _fields_ = ([("rows", _P * MESH_MAX_TP), ("rec", _P * MESH_MAX_TP)]
                + [(n, _P) for n in ("keys", "rep_orig", "n_unique",
                                     "alive")]
                + [("sort", SortArgs), ("n_valid", _P)]
                + [(n, _I) for n in ("B", "rep_cap", "c_local", "ntp",
                                     "entries", "width", "failover",
                                     "bucket_passes")])


class MemoFrontArgs(ctypes.Structure):
    """Mirror of cms::MemoFrontArgs in csrc/mesh.cu, field for field."""

    _fields_ = ([("recs", _P * MESH_MAX_TP)]
                + [(n, _P) for n in ("rep_orig", "n_unique", "tuples", "rep",
                                     "miss_pos", "n_miss", "miss_pack",
                                     "scratch")]
                + [(n, _I) for n in ("B", "rep_cap", "miss_cap", "tp")])


class MemoBackArgs(ctypes.Structure):
    """Mirror of cms::MemoBackArgs in csrc/mesh.cu, field for field."""

    _fields_ = ([("parts", _P * MESH_MAX_TP)]
                + [(n, _P) for n in (
                    "rep", "miss_pos", "n_miss", "miss_pack", "rgid",
                    "n_unique", "dedup_overflow", "tuples", "keys", "meta",
                    "valid", "alive", "mv", "allowed", "proxy_port",
                    "match_kind", "hit")]
                + [("counts", CountsArgs), ("stats", _P), ("scratch", _P)]
                + [(n, _I) for n in (
                    "B", "rep_cap", "miss_cap", "tp", "ew", "n_eps", "kg",
                    "l3_shards", "c_local", "failover", "l3_sharded", "wn",
                    "w_local")])


class MemoInsertArgs(ctypes.Structure):
    """Mirror of cms::MemoInsertArgs in csrc/mesh.cu, field for field."""

    _fields_ = ([(n, _P) for n in ("rows_in", "rows_out", "rep", "miss_pos",
                                   "n_miss", "mv", "stats", "keys",
                                   "rep_orig", "alive")]
                + [(n, _I) for n in ("B", "rep_cap", "miss_cap", "c_local",
                                     "ntp", "entries", "width", "t",
                                     "failover")])


class _MeshLibrary(_Library):
    """csrc/mesh.cu: MESH_PROBE, ROUTED_PROBE, MESH_COMBINE and the memo
    on the mesh (MESH_MEMO_PROBE, MESH_MEMO_COMBINE, MESH_MEMO_INSERT)."""

    stem = "mesh"

    def bind(self, lib) -> None:
        self.declare(lib, (("launch_mesh_probe", MeshProbeArgs),
                           ("launch_routed_probe", RoutedProbeArgs),
                           ("launch_mesh_combine", CombineArgs),
                           ("launch_mesh_memo_probe", MemoProbeArgs),
                           ("launch_mesh_memo_front", MemoFrontArgs),
                           ("launch_mesh_memo_back", MemoBackArgs),
                           ("launch_mesh_memo_insert", MemoInsertArgs)))
        lib.mesh_struct_sizes.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.mesh_struct_sizes.restype = ctypes.c_int
        lib.mesh_memo_scratch_words.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        lib.mesh_memo_scratch_words.restype = None
        sizes = (ctypes.c_int * 9)()
        lib.mesh_struct_sizes(sizes)
        want = [ctypes.sizeof(a) for a in (
            PolicyViewArgs, MeshProbeArgs, RoutedProbeArgs, CombineArgs,
            SortArgs, MemoProbeArgs, MemoFrontArgs, MemoBackArgs,
            MemoInsertArgs)]
        if list(sizes) != want:
            raise RuntimeError(
                f"mesh argument layouts differ between kernels.py {want} "
                f"and csrc/mesh.cu {list(sizes)}"
            )


MESH_LIBRARY = _MeshLibrary()


def _shard_view(tab, dev, dense: bool) -> PolicyViewArgs:
    """Check one shard's policy tables and fill a PolicyView: id_direct
    and the identity pad global, l3_allow_bits the shard's resident
    words (n_words), and with `dense` port_slot and the shard's
    l4_allow_bits words; the hashed tables when present (rows the
    shard's resident rows)."""
    v = PolicyViewArgs()
    v.l4 = _l4_tables(tab, dev)
    e_count, kg = v.l4.n_eps, v.l4.kg
    n = int(tab.id_table.shape[0])
    if n < 1 or n >= 1 << 31:
        raise ValueError(f"{n} identities")
    v.n_ids = n
    direct_n = int(tab.id_direct.shape[0])
    if not 1 <= direct_n < 1 << 31:
        raise ValueError(f"id_direct has {direct_n} entries")
    v.id_direct = _ptr(tab.id_direct, "policy.id_direct", dev,
                       shape=(direct_n,))
    v.direct_n = direct_n
    v.lo_len = int(tab.id_lo_len) & 0xFFFFFFFF
    l3 = tab.l3_allow_bits
    w = int(l3.shape[2]) if l3.dim() == 3 else 0
    if w < 1:
        raise ValueError("policy.l3_allow_bits must be [E, 2, W >= 1]")
    v.n_words = w
    v.l3_allow = _ptr(l3, "policy.l3_allow_bits", dev, shape=(e_count, 2, w))
    if dense:
        if tab.port_slot is None or tab.l4_allow_bits is None:
            raise ValueError("the word-sharded probe reads the dense "
                             "port_slot and l4_allow_bits")
        v.port_slot = _ptr(tab.port_slot, "policy.port_slot", dev,
                           shape=(256, 65536))
        v.l4_allow = _ptr(tab.l4_allow_bits, "policy.l4_allow_bits", dev,
                          shape=(e_count, 2, kg, w))
    return v


def _tuples(batch, name: str):
    packed = batch.pack()
    dev = _cuda_device(packed, name)
    if packed.dim() != 2 or packed.shape[0] != 6:
        raise ValueError(f"the tuple pack must be [6, B], got "
                         f"{tuple(packed.shape)}")
    b = _batch(int(packed.shape[1]))
    return packed, dev, b


class MeshProbeKernel:
    """K21's word-sharded probe on the card: the partial record int32
    [4, B] of one shard (engine/sharded.py mesh_probe_plain) from a
    TupleBatch and the shard's PolicyTables (replicated index tables,
    the word slices of l4_allow_bits and l3_allow_bits, whose first word
    is `w_off`)."""

    name = "mesh_probe"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return MESH_LIBRARY.load(verbose)

    def __call__(self, tab, batch, w_off: int) -> torch.Tensor:
        packed, dev, b = _tuples(batch, self.name)
        a = MeshProbeArgs()
        a.tuples = _ptr(packed, "tuples", dev, shape=(6, b))
        a.pol = _shard_view(tab, dev, dense=True)
        if not 0 <= int(w_off) < 1 << 26:
            raise ValueError(f"w_off = {w_off}")
        a.w_off = int(w_off)
        out = torch.empty((MESH_RECORD_ROWS, b), dtype=torch.int32,
                          device=dev)
        a.out, a.B = out.data_ptr(), b
        MESH_LIBRARY.launch("launch_mesh_probe", a, dev, self.name)
        self.launches += 1
        return out


class RoutedProbeKernel:
    """K21's routed probe on the card: shard t's partial record int32
    [5, B] (engine/sharded.py routed_probe_plain) under the RouteGeom
    `g`, from a TupleBatch and the shard's PolicyTables (hashed, its
    resident rows and L3 words); in failover mode `alive_row` bool [tp]
    is its batch row's chip health."""

    name = "routed_probe"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return MESH_LIBRARY.load(verbose)

    def __call__(self, tab, batch, g, t: int, alive_row=None
                 ) -> torch.Tensor:
        packed, dev, b = _tuples(batch, self.name)
        if tab.l4_hash_rows is None:
            raise ValueError(f"{self.name} reads the hashed L4 tables")
        a = RoutedProbeArgs()
        a.tuples = _ptr(packed, "tuples", dev, shape=(6, b))
        a.pol = _shard_view(tab, dev, dense=False)
        a.t, a.ntp = int(t), int(g.ntp)
        if not 0 <= a.t < a.ntp <= MESH_MAX_TP:
            raise ValueError(f"shard {t} of {g.ntp}")
        a.rows_sharded, a.l3_sharded = int(g.rows_sharded), int(g.l3_sharded)
        a.failover = int(g.failover)
        a.n_rows_global = _pow2(int(g.n_rows_global), "hashed rows")
        a.n_local, a.w_local = int(g.n_local), int(g.w_local)
        a.n_row_shard, a.wn, a.n_ids = int(g.n_row_shard), int(g.wn), int(
            g.n_ids)
        if int(tab.l4_hash_rows.shape[0]) != (
                g.n_local if g.rows_sharded else g.n_rows_global):
            raise ValueError(f"{self.name}: {tuple(tab.l4_hash_rows.shape)} "
                             f"rows on the shard, the geometry says "
                             f"{g.n_local}")
        if a.pol.n_words != g.w_local:
            raise ValueError(f"{self.name}: {a.pol.n_words} L3 words on "
                             f"the shard, the geometry says {g.w_local}")
        keep = None
        if g.failover:
            if alive_row is None:
                raise ValueError("failover mode takes alive_row [tp]")
            keep = alive_row.to(device=dev, dtype=torch.uint8).contiguous()
            a.alive = _ptr(keep, "alive_row", dev, torch.uint8, (a.ntp,))
        out = torch.empty((ROUTED_RECORD_ROWS, b), dtype=torch.int32,
                          device=dev)
        a.out, a.B = out.data_ptr(), b
        MESH_LIBRARY.launch("launch_routed_probe", a, dev, self.name)
        self.launches += 1
        return out


def _combine_counts(dev, n_eps: int, kg: int, n_l3: int, telemetry: bool):
    """A combine's counter buffers as views of one int32 allocation that
    its kernel zeroes (csrc/mesh.cu Counts): (CountsArgs, l4 [E, 2, Kg],
    l3 [E, 2, n_l3], telemetry [2, TELEM_COLS] or None, replica [1]),
    each region 16-byte aligned."""
    up4 = lambda n: -(-n // 4) * 4  # noqa: E731
    n4, n3 = n_eps * 2 * kg, n_eps * 2 * n_l3
    at3 = up4(n4)
    at_t = up4(at3 + n3)
    at_r = at_t + (2 * TELEM_COLS if telemetry else 0)
    words = up4(at_r + 1)
    buf = torch.empty(words, dtype=torch.int32, device=dev)
    c = CountsArgs(buf.data_ptr(), at3, at_t if telemetry else -1, at_r,
                   words)
    telem = (buf[at_t:at_t + 2 * TELEM_COLS].view(2, TELEM_COLS)
             if telemetry else None)
    return (c, buf[:n4].view(n_eps, 2, kg), buf[at3:at3 + n3].view(
        n_eps, 2, n_l3), telem, buf[at_r:at_r + 1])


class MeshCombineKernel:
    """K21's combine on the card: the tp partial records of one batch
    row (on its device; [4, B] in mesh mode, [5, B] routed), its
    TupleBatch and a shard's PolicyTables (l4_meta) -> (Verdicts, l4
    [E, 2, Kg], l3 [E, 2, l3_shards * c_local], telemetry [2, 20] or
    None, replica tuples []), counters as u32 bits in int32
    (engine/sharded.py mesh_combine_plain).  One cooperative launch
    that zeroes the counter buffers (views of one allocation) before it
    counts; its grid barrier's words are kept across calls, zeroed when
    made (one allocation per device and stream: calls on one stream run
    in order), and each launch leaves them zero."""

    name = "mesh_combine"

    def __init__(self) -> None:
        self.launches = 0
        self._bar = {}  # (device, stream) -> the barrier's words

    def load(self, verbose: bool = False):
        return MESH_LIBRARY.load(verbose)

    def __call__(self, parts, tab, batch, g, valid=None,
                 telemetry: bool = True):
        from cilium_tpu_torch.engine.verdict import Verdicts

        packed, dev, b = _tuples(batch, self.name)
        if not 1 <= len(parts) <= MESH_MAX_TP or len(parts) != g.ntp:
            raise ValueError(f"{self.name}: {len(parts)} records for "
                             f"{g.ntp} table shards")
        if not 1 <= g.l3_shards <= len(parts):
            raise ValueError(f"{self.name}: l3_shards = {g.l3_shards}")
        a = CombineArgs()
        # mode 0 is engine/sharded.py MODE_MESH
        rows = MESH_RECORD_ROWS if g.mode == 0 else ROUTED_RECORD_ROWS
        for k, part in enumerate(parts):
            a.parts[k] = _ptr(part, f"record {k}", dev, shape=(rows, b))
        a.tuples = _ptr(packed, "tuples", dev, shape=(6, b))
        l4t = _l4_tables(tab, dev)
        a.meta, a.n_eps, a.kg = l4t.meta, l4t.n_eps, l4t.kg
        a.ew = l4t.ew if tab.l4_hash_rows is not None else 3
        keep = None
        if valid is not None:
            keep = valid.to(device=dev, dtype=torch.uint8).contiguous()
            a.valid = _ptr(keep, "valid", dev, torch.uint8, (b,))
        cols = int(g.l3_shards) * int(g.c_local)
        if not 1 <= cols < 1 << 31:
            raise ValueError(f"{self.name}: {cols} L3 counter columns")
        u8 = torch.empty((2, b), dtype=torch.uint8, device=dev)
        out = Verdicts(
            allowed=u8[0],
            proxy_port=torch.empty(b, dtype=torch.int32, device=dev),
            match_kind=u8[1],
        )
        a.counts, l4, l3, telem, replica = _combine_counts(
            dev, a.n_eps, a.kg, cols, telemetry)
        a.allowed = out.allowed.data_ptr()
        a.proxy_port = out.proxy_port.data_ptr()
        a.match_kind = out.match_kind.data_ptr()
        key = (dev.index, _stream(dev))
        if key not in self._bar:
            self._bar[key] = torch.zeros(4, dtype=torch.int32, device=dev)
        a.bar = self._bar[key].data_ptr()
        a.B, a.tp, a.mode = b, len(parts), int(g.mode)
        a.l3_shards, a.c_local = int(g.l3_shards), int(g.c_local)
        MESH_LIBRARY.launch("launch_mesh_combine", a, dev, self.name)
        self.launches += 1
        del keep
        return out, l4, l3, telem, replica[0]


def _memo_mesh_common(keys, g, mg, name: str):
    """Check a batch row's key words int32 [3, B] and MEMO_DEDUP groups
    against the memo geometry; returns (device, B)."""
    dev, b = _keys3(keys, name)
    if not 1 <= mg.ntp <= MESH_MAX_TP:
        raise ValueError(f"{name}: {mg.ntp} table shards")
    if not 1 <= mg.entries <= 32 or mg.width < 5 * mg.entries:
        raise ValueError(f"{name}: {mg.entries} lanes in {mg.width} words")
    _pow2(mg.c_local * mg.ntp, "cache buckets")
    if not 1 <= mg.rep_cap < 1 << 30 or not 1 <= mg.miss_cap < 1 << 30:
        raise ValueError(f"{name}: rep_cap {mg.rep_cap}, miss_cap "
                         f"{mg.miss_cap}")
    _ptr(g["rep_orig"], "rep_orig", dev, shape=(mg.rep_cap + 1,))
    _ptr(g["n_unique"], "n_unique", dev, shape=(1,))
    return dev, b


def _alive_ptr(mg, alive_row, dev, keep: list) -> int:
    if not mg.failover:
        return 0
    if alive_row is None:
        raise ValueError("failover mode takes alive_row [tp]")
    a = alive_row.to(device=dev, dtype=torch.uint8).contiguous()
    keep.append(a)
    return _ptr(a, "alive_row", dev, torch.uint8, (mg.ntp,))


class MeshMemoProbeKernel:
    """K21's memo probe on the card, for the coordinates of one batch row
    that lie on one device: `rows` {t: cache slice [R_local + 1, W]} ->
    {t: record int32 [4, rep_cap]} (engine/memo_mesh.py
    memo_probe_plain) from the row's key words and MEMO_DEDUP groups;
    `alive_row` bool [tp] in failover mode.  One call runs the init, one
    stable radix sort of the valid representatives by bucket and the
    probe of every coordinate given."""

    name = "mesh_memo_probe"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return MESH_LIBRARY.load(verbose)

    def __call__(self, rows: dict, keys, g, mg, alive_row=None) -> dict:
        dev, b = _memo_mesh_common(keys, g, mg, self.name)
        if not rows or not all(0 <= int(t) < mg.ntp for t in rows):
            raise ValueError(f"{self.name}: shards {sorted(rows)} of "
                             f"{mg.ntp}")
        if mg.ntp > MESH_MAX_TP:
            raise ValueError(f"{self.name}: {mg.ntp} table shards, at most "
                             f"{MESH_MAX_TP}")
        keep = []
        a = MemoProbeArgs()
        recs = {}
        for t, slice_t in rows.items():
            a.rows[int(t)] = _ptr(slice_t, f"cache rows {t}", dev,
                                  shape=(mg.c_local + 1, mg.width))
            recs[int(t)] = torch.empty((4, mg.rep_cap), dtype=torch.int32,
                                       device=dev)
            a.rec[int(t)] = recs[int(t)].data_ptr()
        a.keys, a.rep_orig = keys.data_ptr(), g["rep_orig"].data_ptr()
        a.n_unique = g["n_unique"].data_ptr()
        a.alive = _alive_ptr(mg, alive_row, dev, keep)
        n_valid = torch.empty(1, dtype=torch.int32, device=dev)
        a.n_valid = n_valid.data_ptr()
        bits = max((mg.c_local * mg.ntp).bit_length() - 1, 1)
        passes = (bits + 7) // 8
        a.sort, sort_bufs = _sort_args(mg.rep_cap, 1, passes,
                                       n_valid.data_ptr(), dev)
        a.B, a.rep_cap, a.c_local, a.ntp = b, mg.rep_cap, mg.c_local, mg.ntp
        a.entries, a.width = mg.entries, mg.width
        a.failover, a.bucket_passes = int(mg.failover), passes
        MESH_LIBRARY.launch("launch_mesh_memo_probe", a, dev, self.name)
        self.launches += 1
        del sort_bufs, keep, n_valid
        return recs


class MeshMemoCombineKernel:
    """K21's memo combine on the card, in two passes per batch row, each
    one cooperative launch (csrc/mesh.cu).  `front(records, g, packed,
    mg)`: the table-axis sum of the tp probe records, the hit masked by
    rep_valid, the ascending compaction of the missed representatives
    and their [6, miss_cap] tuple pack (memo_front_plain).
    `back(front, rparts, tab, g, packed, keys, mg, rg, valid, alive_row,
    telemetry)`: the missed representatives' lattice from the tp
    ROUTED_PROBE records packed into value words, the scatter-back to
    every tuple in row order (g["rgid"]), the combine, the counters (the
    buffers zeroed by the launch), the telemetry row, the replica count
    and the stats row (memo_back_plain); `front` is this front pass's
    output for the same records.  The passes' scratch
    (mesh_memo_scratch_words: barriers, counters, the missed flags, the
    representatives' value words) is kept across calls, one allocation
    for both per device and stream (calls on one stream run in order),
    laid out for the largest rep_cap seen there and zeroed when made;
    each launch leaves its control words zero."""

    name = "mesh_memo_combine"

    def __init__(self) -> None:
        self.launches = 0
        # (device, stream) -> (rep_cap laid out for, front, back, buffer)
        self._held = {}

    def load(self, verbose: bool = False):
        return MESH_LIBRARY.load(verbose)

    def _scratch(self, dev, rep_cap: int) -> tuple:
        """(front, back) scratch pointers for this rep_cap: the front's
        region, then the back's, laid out for the largest rep_cap seen
        on this stream (each region's control words at its start)."""
        key = (dev.index, _stream(dev))
        got = self._held.get(key)
        if got is None or got[0] < rep_cap:
            words = (ctypes.c_longlong * 2)()
            self.load().mesh_memo_scratch_words(rep_cap, words)
            buf = torch.zeros(int(words[0]) + int(words[1]),
                              dtype=torch.int32, device=dev)
            got = self._held[key] = (rep_cap, buf.data_ptr(),
                                     buf.data_ptr() + 4 * int(words[0]), buf)
        return got[1], got[2]

    def front(self, records, g, packed, mg) -> dict:
        dev = _cuda_device(packed, self.name)
        b = _batch(int(packed.shape[1]))
        if len(records) != mg.ntp:
            raise ValueError(f"{self.name}: {len(records)} records for "
                             f"{mg.ntp} table shards")
        a = MemoFrontArgs()
        for k, rec in enumerate(records):
            a.recs[k] = _ptr(rec, f"record {k}", dev, shape=(4, mg.rep_cap))
        a.rep_orig = _ptr(g["rep_orig"], "rep_orig", dev,
                          shape=(mg.rep_cap + 1,))
        a.n_unique = _ptr(g["n_unique"], "n_unique", dev, shape=(1,))
        a.tuples = _ptr(packed, "tuples", dev, shape=(6, b))
        rc, mc = mg.rep_cap, mg.miss_cap
        # the four outputs, views of one allocation
        buf = torch.empty(4 * rc + 7 * mc + 1, dtype=torch.int32, device=dev)
        out = {"rep": buf[:4 * rc].view(4, rc),
               "miss_pos": buf[4 * rc:4 * rc + mc],
               "miss_pack": buf[4 * rc + mc:4 * rc + 7 * mc].view(6, mc),
               "n_miss": buf[4 * rc + 7 * mc:]}
        a.rep, a.miss_pos = out["rep"].data_ptr(), out["miss_pos"].data_ptr()
        a.n_miss, a.miss_pack = (out["n_miss"].data_ptr(),
                                 out["miss_pack"].data_ptr())
        a.scratch = self._scratch(dev, rc)[0]
        a.B, a.rep_cap, a.miss_cap, a.tp = b, rc, mc, mg.ntp
        MESH_LIBRARY.launch("launch_mesh_memo_front", a, dev, self.name)
        self.launches += 1
        return out

    def back(self, front, rparts, tab, g, packed, keys, mg, rg, valid=None,
             alive_row=None, telemetry: bool = True):
        from cilium_tpu_torch.engine.verdict import Verdicts

        dev, b = _memo_mesh_common(keys, g, mg, self.name)
        if len(rparts) != mg.ntp:
            raise ValueError(f"{self.name}: {len(rparts)} routed records "
                             f"for {mg.ntp} table shards")
        keep = []
        a = MemoBackArgs()
        rc, mc = mg.rep_cap, mg.miss_cap
        for k, part in enumerate(rparts):
            a.parts[k] = _ptr(part, f"routed record {k}", dev,
                              shape=(ROUTED_RECORD_ROWS, mc))
        a.rep = _ptr(front["rep"], "rep", dev, shape=(4, rc))
        a.miss_pos = _ptr(front["miss_pos"], "miss_pos", dev, shape=(mc,))
        a.n_miss = _ptr(front["n_miss"], "n_miss", dev, shape=(1,))
        a.miss_pack = _ptr(front["miss_pack"], "miss_pack", dev,
                           shape=(6, mc))
        a.rgid = _ptr(g["rgid"], "rgid", dev, shape=(b,))
        a.n_unique = g["n_unique"].data_ptr()
        a.dedup_overflow = _ptr(g["overflow"], "overflow", dev, shape=(1,))
        a.tuples = _ptr(packed, "tuples", dev, shape=(6, b))
        a.keys = keys.data_ptr()
        l4t = _l4_tables(tab, dev)
        a.meta, a.n_eps, a.kg = l4t.meta, l4t.n_eps, l4t.kg
        a.ew = l4t.ew
        if mg.failover and valid is not None:
            v8 = valid.to(device=dev, dtype=torch.uint8).contiguous()
            keep.append(v8)
            a.valid = _ptr(v8, "valid", dev, torch.uint8, (b,))
        a.alive = _alive_ptr(mg, alive_row, dev, keep)
        cols = int(rg.l3_shards) * int(rg.c_local)
        if not 1 <= cols < 1 << 31:
            raise ValueError(f"{self.name}: {cols} L3 counter columns")
        if rg.l3_sharded and not (rg.wn if mg.failover else rg.w_local):
            raise ValueError(f"{self.name}: a sharded L3 plane of 0 words")
        # the outputs, views of two allocations (and the counters' one)
        u8 = torch.empty((3, b), dtype=torch.uint8, device=dev)
        i32 = torch.empty(b + 8 + 2 * mc, dtype=torch.int32, device=dev)
        v = Verdicts(allowed=u8[0], proxy_port=i32[:b], match_kind=u8[1])
        hit = u8[2].view(torch.bool)
        stats, mv = i32[b:b + 5], i32[b + 8:].view(2, mc)
        a.counts, l4, l3, telem, replica = _combine_counts(
            dev, a.n_eps, a.kg, cols, telemetry)
        a.mv = mv.data_ptr()
        a.allowed, a.proxy_port = (v.allowed.data_ptr(),
                                   v.proxy_port.data_ptr())
        a.match_kind, a.hit = v.match_kind.data_ptr(), hit.data_ptr()
        a.stats = stats.data_ptr()
        a.scratch = self._scratch(dev, rc)[1]
        a.B, a.rep_cap, a.miss_cap, a.tp = b, rc, mc, mg.ntp
        a.l3_shards, a.c_local = int(rg.l3_shards), int(rg.c_local)
        a.failover, a.l3_sharded = int(mg.failover), int(rg.l3_sharded)
        a.wn, a.w_local = int(rg.wn), int(rg.w_local)
        MESH_LIBRARY.launch("launch_mesh_memo_back", a, dev, self.name)
        self.launches += 1
        del keep
        return v, l4, l3, telem, replica, hit, stats, mv


class MeshMemoInsertKernel:
    """K21's memo insert on the card: a copy of coordinate t's cache slice
    [R_local + 1, W] with the live missed representatives it owns
    written at their lanes, unless the row's stats show an overflow
    (memo_insert_plain).  Returns the new slice."""

    name = "mesh_memo_insert"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return MESH_LIBRARY.load(verbose)

    def __call__(self, rows, front, mv, stats, keys, g, mg, t: int,
                 alive_row=None):
        dev, b = _memo_mesh_common(keys, g, mg, self.name)
        if not 0 <= int(t) < mg.ntp:
            raise ValueError(f"{self.name}: shard {t} of {mg.ntp}")
        keep = []
        a = MemoInsertArgs()
        shape = (mg.c_local + 1, mg.width)
        a.rows_in = _ptr(rows, "cache rows", dev, shape=shape)
        out = torch.empty(shape, dtype=torch.int32, device=dev)
        a.rows_out = out.data_ptr()
        a.rep = _ptr(front["rep"], "rep", dev, shape=(4, mg.rep_cap))
        a.miss_pos = _ptr(front["miss_pos"], "miss_pos", dev,
                          shape=(mg.miss_cap,))
        a.n_miss = _ptr(front["n_miss"], "n_miss", dev, shape=(1,))
        a.mv = _ptr(mv, "mv", dev, shape=(2, mg.miss_cap))
        a.stats = _ptr(stats, "stats", dev, shape=(5,))
        a.keys, a.rep_orig = keys.data_ptr(), g["rep_orig"].data_ptr()
        a.alive = _alive_ptr(mg, alive_row, dev, keep)
        a.B, a.rep_cap, a.miss_cap = b, mg.rep_cap, mg.miss_cap
        a.c_local, a.ntp, a.entries = mg.c_local, mg.ntp, mg.entries
        a.width, a.t, a.failover = mg.width, int(t), int(mg.failover)
        MESH_LIBRARY.launch("launch_mesh_memo_insert", a, dev, self.name)
        self.launches += 1
        del keep
        return out


MESH_PROBE = MeshProbeKernel()
ROUTED_PROBE = RoutedProbeKernel()
MESH_COMBINE = MeshCombineKernel()
MESH_MEMO_PROBE = MeshMemoProbeKernel()
MESH_MEMO_COMBINE = MeshMemoCombineKernel()
MESH_MEMO_INSERT = MeshMemoInsertKernel()


# ---------------------------------------------------------------------------
# The fused datapath on a mesh (csrc/datapath_mesh.cu)
# ---------------------------------------------------------------------------



class DpMeshArgs(ctypes.Structure):
    """Mirror of cdm::DpMeshArgs in csrc/datapath_mesh.cu, field for
    field."""

    _fields_ = ([("dp", DatapathArgs), ("flows", _P),
                 ("prev", _P * MESH_MAX_TP), ("out", _P), ("alive", _P)]
                + [(n, _I) for n in (
                    "B", "flow_form", "round", "t", "ntp", "static_dir",
                    "ct_sharded", "lb_sharded", "ipc_sharded",
                    "range_sharded", "rows_sharded", "l3_sharded", "n_ct",
                    "n_lb", "n_ipc", "n_range", "n_rows_global", "wn",
                    "n_l3_ids", "scan")])


class DpCombineArgs(ctypes.Structure):
    """Mirror of cdm::DpCombineArgs in csrc/datapath_mesh.cu, field for
    field."""

    _fields_ = ([("dp", DatapathArgs), ("flows", _P),
                 ("parts", _P * MESH_MAX_TP)]
                + [(n, _P) for n in ("valid", "l4", "l3", "telem",
                                     "replica")]
                + [(n, _I) for n in ("B", "flow_form", "tp", "static_dir",
                                     "l3_shards", "c_local")])


class _DpMeshLibrary(_Library):
    """csrc/datapath_mesh.cu: DP_MESH_PROBE and DP_MESH_COMBINE."""

    stem = "datapath_mesh"

    def bind(self, lib) -> None:
        self.declare(lib, (("launch_dp_mesh_probe", DpMeshArgs),
                           ("launch_dp_mesh_combine", DpCombineArgs)))
        lib.dp_mesh_struct_sizes.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.dp_mesh_struct_sizes.restype = ctypes.c_int
        sizes = (ctypes.c_int * 3)()
        lib.dp_mesh_struct_sizes(sizes)
        want = [ctypes.sizeof(a) for a in (DatapathArgs, DpMeshArgs,
                                           DpCombineArgs)]
        if list(sizes) != want:
            raise RuntimeError(
                f"datapath mesh argument layouts differ between kernels.py "
                f"{want} and csrc/datapath_mesh.cu {list(sizes)}")


DP_MESH_LIBRARY = _DpMeshLibrary()


def _fill_shard(a: DatapathArgs, tab, dev, g: dict) -> None:
    """Check one mesh shard's DatapathTables (its local blocks of the
    sharded planes, the replicated leaves whole) against the fused
    geometry `g` and fill the DatapathArgs view the mesh kernels read."""
    ntp = int(g["ntp"])

    def local(sharded: bool, n_global: int) -> int:
        return 2 * n_global // ntp if sharded else n_global

    pf = tab.prefilter
    if isinstance(pf, PrefilterRanges):
        a.pf_base = _ptr(pf.base, "prefilter.base", dev)
        a.pf_mask = _ptr(pf.mask, "prefilter.mask", dev,
                         shape=tuple(pf.base.shape))
        a.pf_n = int(pf.base.shape[0])
    elif isinstance(pf, LPMTables):
        a.pf_l1, a.pf_l2, a.pf_blocks = _lpm_tables(pf, dev)
    else:
        raise ValueError(f"unknown prefilter form {type(pf).__name__}")
    ct = tab.ct
    ew = int(ct.entry_words)
    if ew not in (4, 5) or ct.stash.shape[1] != 5:
        raise ValueError("the kernel takes 4- or 5-word CT rows and a "
                         "5-word stash")
    a.ct_buckets = _ptr(ct.buckets, "ct.buckets", dev)
    if ct.buckets.shape[0] != local(g["ct_sharded"], g["n_ct"]):
        raise ValueError(f"ct.buckets has {ct.buckets.shape[0]} rows on the "
                         f"shard, the geometry says "
                         f"{local(g['ct_sharded'], g['n_ct'])}")
    a.ct_lanes, a.ct_ew = int(ct.buckets.shape[1]), ew
    if a.ct_lanes < ew or (ew == 4 and a.ct_lanes % 4):
        raise ValueError("compact CT rows must hold whole 4-word entries")
    a.ct_stash = _ptr(ct.stash, "ct.stash", dev)
    a.ct_stash_n = int(ct.stash.shape[0])
    lb = tab.lb
    if isinstance(lb, LBInline):
        if lb.rows.shape[1] != 128 or lb.stash.shape[1] != 64:
            raise ValueError("inline LB rows must be 128 lanes, stash 64")
        if lb.rows.shape[0] != local(g["lb_sharded"], g["n_lb"]):
            raise ValueError("lb.rows on the shard differ from the geometry")
        a.lb_rows = _ptr(lb.rows, "lb.rows", dev)
        a.lb_stash = _ptr(lb.stash, "lb.stash", dev)
        a.lb_nb = _pow2(int(lb.n_buckets), "lb.n_buckets")
        a.lb_stash_n = int(lb.stash.shape[0])
    else:
        _fill_lb(a, lb, dev)
    ipc = tab.ipcache
    if not isinstance(ipc, IPCacheDevice) or not ipc.values_are_idx:
        raise ValueError("the fused mesh datapath takes an idx-form "
                         "IPCacheDevice")
    _fill_ipcache(a, ipc, dev, rows=local(g["ipc_sharded"], g["n_ipc"]))
    if ipc.range_rows is not None and (
            ipc.range_rows.shape[0] != local(g["range_sharded"],
                                             g["n_range"])):
        raise ValueError("ipcache.range_rows on the shard differ from the "
                         "geometry")
    pol = tab.policy
    if pol.l4_hash_rows is None:
        raise ValueError("the fused mesh datapath reads the hashed L4 tables")
    l4 = _l4_tables(pol, dev)
    for key, pre in (("l4", ""), ("l4w", "w")):
        for f in ("rows", "stash", "nrows", "lanes", "stash_n"):
            setattr(a, f"{key}_{f}", getattr(l4, pre + f))
    if a.l4_nrows != local(g["rows_sharded"], g["n_rows_global"]):
        raise ValueError("policy.l4_hash_rows on the shard differ from the "
                         "geometry")
    a.l4_ew = l4.ew
    a.l4_meta = l4.meta
    a.n_eps, a.kg = l4.n_eps, l4.kg
    n = int(pol.id_table.shape[0])
    a.n_ids = n
    a.id_table = _ptr(pol.id_table, "policy.id_table", dev, shape=(n,))
    l3 = pol.l3_allow_bits
    w = int(l3.shape[2]) if l3.dim() == 3 else 0
    if w != local(g["l3_sharded"], g["w_global"]) or w < 1:
        raise ValueError(f"policy.l3_allow_bits has {w} words on the shard, "
                         f"the geometry says "
                         f"{local(g['l3_sharded'], g['w_global'])}")
    a.n_words = w
    a.l3_allow = _ptr(l3, "policy.l3_allow_bits", dev,
                      shape=(a.n_eps, 2, w))
    if tab.tunnel is not None:
        a.tun_base, a.tun_mask, a.tun_endpoint, a.tun_n = _tunnel_ranges(
            tab.tunnel, TunnelTables, 1, dev)


def _flows_of(flows, form: int, name: str):
    dev = _cuda_device(flows, name)
    rows = 8 if form == 0 else 4
    if flows.dim() != 2 or flows.shape[0] != rows:
        raise ValueError(f"{name}: flows must be [{rows}, B], got "
                         f"{tuple(flows.shape)}")
    b = _batch(int(flows.shape[1]))
    return dev, b, _ptr(flows, "flows", dev, shape=(rows, b))


class DpMeshProbeKernel:
    """K21's fused-datapath probe on the card: shard t's record int32
    [RECORD_ROWS[rnd], B] of round `rnd` (engine/datapath_mesh.py
    dp_mesh_probe_plain) from its DatapathTables (local blocks), its
    batch row's flows (int32 [8, B] words, or a packed4 half [4, B] with
    `form` 1), the row's tp records of the previous round, the row's
    chip health `alive_row` bool [tp] and the fused geometry `g`;
    `static_dir` None, 0 (ingress: rounds F and P only) or 1."""

    name = "dp_mesh_probe"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return DP_MESH_LIBRARY.load(verbose)

    def __call__(self, rnd: int, tab, flows, form: int, prev, alive_row,
                 t: int, g: dict, static_dir=None) -> torch.Tensor:
        dev, b, fptr = _flows_of(flows, form, self.name)
        ntp = int(g["ntp"])
        if not 0 <= int(t) < ntp <= MESH_MAX_TP:
            raise ValueError(f"{self.name}: shard {t} of {ntp}")
        if rnd not in (0, 1, 2, 3):
            raise ValueError(f"{self.name}: round {rnd}")
        if static_dir not in (None, 0, 1) or (static_dir == 0 and rnd < 2):
            raise ValueError(f"{self.name}: round {rnd} of static direction "
                             f"{static_dir!r}")
        a = DpMeshArgs()
        _fill_shard(a.dp, tab, dev, g)
        a.flows = fptr
        reads = rnd > 0 and not (rnd == 2 and static_dir == 0)
        if reads:
            if prev is None or len(prev) != ntp:
                raise ValueError(f"{self.name}: round {rnd} reads the "
                                 f"previous round's {ntp} records")
            for k, p in enumerate(prev):
                a.prev[k] = _ptr(p, f"record {k}", dev,
                                 shape=(RECORD_ROWS[rnd - 1], b))
        keep = alive_row.to(device=dev, dtype=torch.uint8).contiguous()
        a.alive = _ptr(keep, "alive_row", dev, torch.uint8, (ntp,))
        out = torch.empty((RECORD_ROWS[rnd], b), dtype=torch.int32,
                          device=dev)
        a.out = out.data_ptr()
        a.B, a.flow_form, a.round, a.t, a.ntp = b, int(form), rnd, int(t), ntp
        a.static_dir = -1 if static_dir is None else int(static_dir)
        for k in ("ct_sharded", "lb_sharded", "ipc_sharded", "range_sharded",
                  "rows_sharded", "l3_sharded"):
            setattr(a, k, int(bool(g[k])))
        a.n_ct = _pow2(int(g["n_ct"]), "ct rows")
        a.n_lb = _pow2(int(g["n_lb"]), "lb rows") if g["lb_inline"] else 0
        a.n_ipc = _pow2(int(g["n_ipc"]), "ipcache rows")
        a.n_range = (_pow2(int(g["n_range"]), "range rows")
                     if g["n_range"] else 0)
        a.n_rows_global = _pow2(int(g["n_rows_global"]), "hashed rows")
        a.wn, a.n_l3_ids = int(g["wn"]), int(g["route"].n_ids)
        if g["l3_sharded"] and a.wn < 1:
            raise ValueError(f"{self.name}: a sharded L3 plane of 0 words")
        a.scan = int(rnd == 2 and int(t) == 0 and bool(a.dp.range_base))
        DP_MESH_LIBRARY.launch("launch_dp_mesh_probe", a, dev, self.name)
        self.launches += 1
        del keep
        return out


class DpMeshCombineKernel:
    """K21's fused-datapath combine on the card: one batch row's tp
    round-P records, shard 0's DatapathTables, the row's flows and the
    fused geometry `g` -> (DatapathVerdicts [B], l4 [E, 2, Kg], l3 [E, 2,
    l3_shards * c_local], telemetry [2, 20] or None, the (tuple, shard)
    pairs served from a backup region []), counters as u32 bits in
    int32, masked by `valid` bool [B] where given (engine/
    datapath_mesh.py dp_mesh_combine_plain)."""

    name = "dp_mesh_combine"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return DP_MESH_LIBRARY.load(verbose)

    def __call__(self, parts, tab, flows, form: int, g: dict, valid=None,
                 static_dir=None, telemetry: bool = True):
        dev, b, fptr = _flows_of(flows, form, self.name)
        tp = int(g["ntp"])
        if len(parts) != tp or not 1 <= tp <= MESH_MAX_TP:
            raise ValueError(f"{self.name}: {len(parts)} records for {tp} "
                             f"table shards")
        if static_dir not in (None, 0, 1):
            raise ValueError(f"{self.name}: static direction {static_dir!r}")
        route = g["route"]
        if not 1 <= route.l3_shards <= tp:
            raise ValueError(f"{self.name}: l3_shards = {route.l3_shards}")
        a = DpCombineArgs()
        _fill_shard(a.dp, tab, dev, g)
        a.flows = fptr
        for k, part in enumerate(parts):
            a.parts[k] = _ptr(part, f"record {k}", dev,
                              shape=(RECORD_ROWS[3], b))
        keep = None
        if valid is not None:
            keep = valid.to(device=dev, dtype=torch.uint8).contiguous()
            a.valid = _ptr(keep, "valid", dev, torch.uint8, (b,))
        cols = _alloc_columns(a.dp, (b,), dev)
        n_l3 = int(route.l3_shards) * int(route.c_local)
        if not 1 <= n_l3 < 1 << 31:
            raise ValueError(f"{self.name}: {n_l3} L3 counter columns")
        # the four counter buffers the kernel adds into, views of one
        # zeroed allocation: one fill in place of four
        n4, n3 = a.dp.n_eps * 2 * a.dp.kg, a.dp.n_eps * 2 * n_l3
        zeroed = torch.zeros(n4 + n3 + 1 + 2 * TELEM_COLS, dtype=torch.int32,
                             device=dev)
        l4 = zeroed[:n4].view(a.dp.n_eps, 2, a.dp.kg)
        l3 = zeroed[n4:n4 + n3].view(a.dp.n_eps, 2, n_l3)
        replica = zeroed[n4 + n3:n4 + n3 + 1]
        telem = (zeroed[n4 + n3 + 1:].view(2, TELEM_COLS) if telemetry
                 else None)
        a.l4, a.l3, a.replica = l4.data_ptr(), l3.data_ptr(), replica.data_ptr()
        if telem is not None:
            a.telem = telem.data_ptr()
        a.B, a.flow_form, a.tp = b, int(form), tp
        a.static_dir = -1 if static_dir is None else int(static_dir)
        a.l3_shards, a.c_local = int(route.l3_shards), int(route.c_local)
        DP_MESH_LIBRARY.launch("launch_dp_mesh_combine", a, dev, self.name)
        self.launches += 1
        del keep
        return DatapathVerdicts(**cols), l4, l3, telem, replica[0]


DP_MESH_PROBE = DpMeshProbeKernel()
DP_MESH_COMBINE = DpMeshCombineKernel()


# ---------------------------------------------------------------------------
# The lookups of K20 outside the datapath (csrc/lookup.cu)
# ---------------------------------------------------------------------------

class HashArgs(ctypes.Structure):
    """Mirror of clk::HashArgs in csrc/lookup.cu, field for field."""

    _fields_ = ([(n, _P) for n in ("keys", "value_index", "query", "found",
                                   "index")]
                + [(n, _I) for n in ("B", "kw", "capacity", "stash_n",
                                     "window")])


class IpcLookupArgs(ctypes.Structure):
    """Mirror of clk::IpcLookupArgs in csrc/lookup.cu, field for field."""

    _fields_ = [("dp", DatapathArgs), ("ips", _P), ("out", _P),
                ("form", _I)]


class _LookupLibrary(_Library):
    """csrc/lookup.cu: HASH_LOOKUP and IPCACHE_LOOKUP."""

    stem = "lookup"

    def __init__(self) -> None:
        super().__init__()
        self.smem_limits = {}

    def bind(self, lib) -> None:
        lib.launch_hash_lookup.argtypes = [ctypes.POINTER(HashArgs),
                                           ctypes.c_int, _P]
        lib.launch_hash_lookup.restype = ctypes.c_int
        self.declare(lib, (("launch_ipcache_lookup", IpcLookupArgs),))
        lib.lookup_smem_limit.argtypes = []
        lib.lookup_smem_limit.restype = ctypes.c_int
        lib.lookup_struct_sizes.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.lookup_struct_sizes.restype = ctypes.c_int
        sizes = (ctypes.c_int * 3)()
        lib.lookup_struct_sizes(sizes)
        want = [ctypes.sizeof(a) for a in (DatapathArgs, HashArgs,
                                           IpcLookupArgs)]
        if list(sizes) != want:
            raise RuntimeError(
                f"lookup argument layouts differ between kernels.py {want} "
                f"and csrc/lookup.cu {list(sizes)}")


    def smem_limit(self, device) -> int:
        """The dynamic shared memory one block of `device` may opt in to
        (asked once a device)."""
        if device not in self.smem_limits:
            with torch.cuda.device(device):
                self.smem_limits[device] = int(self.load().lookup_smem_limit())
        return self.smem_limits[device]


LOOKUP_LIBRARY = _LookupLibrary()


class HashLookupKernel:
    """K20's generic hash-table lookup on the card (engine/hashtable.py):
    (found bool [B], index int32 [B]) of a query int32 [B, KW] (u32
    bits) against a HashTable on the same device (keys int32 [C + S, KW],
    value_index int32 [C + S])."""

    name = "hash_lookup"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return LOOKUP_LIBRARY.load(verbose)

    def __call__(self, table, query):
        dev = _cuda_device(query, self.name)
        keys, vi = table.keys, table.value_index
        if keys.dim() != 2 or keys.shape[1] < 1:
            raise ValueError(f"hash keys must be [C + S, KW >= 1], got "
                             f"{tuple(keys.shape)}")
        rows, kw = (int(x) for x in keys.shape)
        cap = _pow2(int(table.capacity), "hash capacity")
        if not cap <= rows < 1 << 31 or rows * kw >= 1 << 31:
            raise ValueError(f"{rows} hash rows for capacity {cap}")
        window = int(table.max_probes)
        if window < 1:
            raise ValueError(f"probe window {window}")
        stash_n = rows - cap
        smem = stash_n * kw * 4
        limit = LOOKUP_LIBRARY.smem_limit(dev)
        if smem > limit:
            raise ValueError(f"{self.name}: a stash of {stash_n} x {kw} words "
                             f"exceeds the {limit} B of shared memory one "
                             f"block may use")
        b = _batch(int(query.shape[0]))
        a = HashArgs()
        a.keys = _ptr(keys, "hash keys", dev)
        a.value_index = _ptr(vi, "hash value_index", dev, shape=(rows,))
        a.query = _ptr(query, "query", dev, shape=(b, kw))
        found = torch.empty(b, dtype=torch.bool, device=dev)
        index = torch.empty(b, dtype=torch.int32, device=dev)
        a.found, a.index = found.data_ptr(), index.data_ptr()
        a.B, a.kw, a.capacity, a.stash_n, a.window = b, kw, cap, stash_n, window
        LOOKUP_LIBRARY.launch("launch_hash_lookup", a, dev, self.name, smem)
        self.launches += 1
        return found, index


class IpcacheLookupKernel:
    """K20's lookup over a bucketized IPCacheDevice on the card
    (ipcache/lpm.py lpm_lookup): ips int32 [B] (u32 bits) -> values
    int32 [B] (u32 bits: the identity index + 1 in the idx forms, the
    identity in the generic one; 0 = no entry), every form the builders
    make (range classes or the [B, P] scan, u32 or sub-word planes, with
    or without L3 planes)."""

    name = "ipcache_lookup"

    def __init__(self) -> None:
        self.launches = 0

    def load(self, verbose: bool = False):
        return LOOKUP_LIBRARY.load(verbose)

    def __call__(self, ipc, ips):
        dev = _cuda_device(ips, self.name)
        if not isinstance(ipc, IPCacheDevice):
            raise ValueError(f"{self.name} takes an IPCacheDevice, got "
                             f"{type(ipc).__name__}")
        if ips.dim() != 1:
            raise ValueError("ips must be [B]")
        b = _batch(int(ips.shape[0]))
        a = IpcLookupArgs()
        a.form = _fill_ipcache(a.dp, ipc, dev)
        a.ips = _ptr(ips, "ips", dev, shape=(b,))
        out = torch.empty(b, dtype=torch.int32, device=dev)
        a.out, a.dp.B = out.data_ptr(), b
        LOOKUP_LIBRARY.launch("launch_ipcache_lookup", a, dev, self.name)
        self.launches += 1
        return out


HASH_LOOKUP = HashLookupKernel()
IPCACHE_LOOKUP = IpcacheLookupKernel()


KERNELS = (DATAPATH_PAIR, DATAPATH_STEP, CHURN_COMPACT, CT_DELTA,
           HTTP_MATCH, KAFKA_MATCH, FLEET_L7, LATTICE, LPM_LOOKUP, DATAPATH6,
           PICK_DRAW, DATAPATH_PAIR_MEMO, MEMO_DEDUP, MEMO_CACHE,
           MEMO_KEYS_LATTICE, PUBLISH_SCATTER, MEMCACHE_MATCH, SHADOW_DIFF,
           PERSISTENT_PAIR, MESH_PROBE, ROUTED_PROBE, MESH_COMBINE,
           REPAIR_SCATTER, MESH_MEMO_PROBE, MESH_MEMO_COMBINE,
           MESH_MEMO_INSERT, DP_MESH_PROBE, DP_MESH_COMBINE, HASH_LOOKUP,
           IPCACHE_LOOKUP)
