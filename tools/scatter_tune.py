"""PUBLISH_SCATTER and REPAIR_SCATTER on one card at the geometries of
chip_smoke.py's four sites (the one-rule publish, the readmission, the
fused mesh store's churn delta, the grow's relayout queue), with leaves,
indices and payloads made here from a seed: each kernel's device ms (20
calls queued behind a device spin, chip_smoke.queued_ms, and with the
L2 evicted by a 128 MB read before each, chip_smoke.cold_ms; a late
reading again behind a longer spin, chip_smoke.spun_ms) for
each tiling in TILINGS (kernels.SCATTER_TARGET_TILES and
SCATTER_TILE_WORDS; a one-row scatter gives a launch's fixed cost),
every launch checked against the plain version first; then the
wrappers' host microseconds split into their parts.

    python3 tools/scatter_tune.py [--default] [--source CSRC_DIR]

`--default` times the package's own tiling alone and skips the host
split; `--source` builds the kernels from another csrc/ directory (a
variant of csrc/publish.cu with the same interface) into a build
directory of its own, to time it beside the package's in turns.
Prints one JSON line per (site, tiling), one per host part, and the
card's name and power limit.  Needs a CUDA device; imports no JAX.
"""

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import cold_ms, host_us, queued_ms, spun_ms  # noqa: E402

# (SCATTER_TARGET_TILES, SCATTER_TILE_WORDS)
TILINGS = ((33, (1024, 8192)), (66, (1024, 8192)), (132, (1024, 8192)),
           (264, (1024, 8192)), (512, (1024, 8192)), (132, (2048, 8192)),
           (132, (512, 8192)), (132, (1024, 16384)))
# chip_smoke.py run 1's `geometry`: [leaf shape, axis, index rows]
PUBLISH = [((32, 2, 2080), 1, 1), ((32, 2, 512, 2080), 1, 1),
           ((131072, 64), 1, 32), ((32, 2, 512), 1, 1), ((256, 65536), 2, 2)]
READMISSION = [((65536, 64), 0, 65536), ((32, 2, 1040), 2, 1040)]
DELTA = [((8192, 64), 0, k) for k in (1, 2, 1, 1641, 1626, 1623, 3302)]
FLOOR = [((8192, 64), 0, 1)]  # one row: a launch's fixed cost
RELAYOUT = ([((8192, 64), 0, 8192)] * 4 + [((64, 34), 0, 64)] * 2
            + [((8, 128), 0, 8)] * 2 + [((32, 2, 1040), 2, 1040)] * 2
            + [((131072, 32), 0, 131072)] * 2)


def words(rng, shape):
    return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, shape,
                                         dtype=np.int64).astype(np.int32)
                            ).cuda()


def publish_segments(rng):
    out = []
    for shape, axes, k in PUBLISH:
        idx = tuple(torch.from_numpy(rng.choice(shape[a], k, replace=False)
                                     ).cuda() for a in range(axes))
        out.append((words(rng, shape), idx, words(rng, (k,) + shape[axes:])))
    return out


def repair_segments(rng, geo):
    out = []
    for shape, axis, k in geo:
        n = shape[axis]
        idx = np.arange(n) if k == n else np.sort(rng.choice(n, k, False))
        vshape = shape[:axis] + (k,) + shape[axis + 1:]
        out.append((words(rng, shape), axis, torch.from_numpy(idx).cuda(),
                    words(rng, vshape)))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("scatter_tune: no CUDA device", file=sys.stderr)
        return 2
    from pathlib import Path

    from cilium_tpu_torch import kernels
    from cilium_tpu_torch.engine.publish import (
        repair_segments_plain,
        scatter_segments_plain,
    )

    args = sys.argv[1:]
    default = "--default" in args
    source = args[args.index("--source") + 1] if "--source" in args else None
    if source:
        kernels.CSRC = Path(source).resolve()
        kernels.BUILD_DIR = kernels.BUILD_DIR / "variant"
    kernels.build("publish")
    rng = np.random.default_rng(17)
    sites = {"publish": publish_segments(rng),
             "readmission": repair_segments(rng, READMISSION),
             "datapath_delta": repair_segments(rng, DELTA),
             "relayout": repair_segments(rng, RELAYOUT)}
    sites["floor"] = repair_segments(rng, FLOOR)
    package = kernels.SCATTER_TARGET_TILES, kernels.SCATTER_TILE_WORDS
    for target, words_range in (package,) if default else TILINGS:
        kernels.SCATTER_TARGET_TILES = target
        kernels.SCATTER_TILE_WORDS = words_range
        for site, segs in sites.items():
            pub = site == "publish"
            kern = kernels.PUBLISH_SCATTER if pub else kernels.REPAIR_SCATTER
            plain = scatter_segments_plain if pub else repair_segments_plain
            got = [(s[0].clone(),) + tuple(s[1:]) for s in segs]
            want = [(s[0].clone(),) + tuple(s[1:]) for s in segs]
            kern(got)
            plain(want)
            differ = sum(int((a[0] != b[0]).sum()) for a, b in zip(got, want))
            if differ:
                raise SystemExit(f"{site}: {differ} entries differ")
            nbytes = sum(s[-1].numel() * 4 * 2 + sum(
                i.numel() * 8 for i in (s[1] if pub else (s[2],)))
                for s in segs)
            print(json.dumps(dict(
                site=site, source=source or "package", target_tiles=target,
                tile_words=words_range,
                device_ms=spun_ms(queued_ms, lambda: kern(got), site),
                cold_ms=spun_ms(cold_ms, lambda: kern(got), site),
                bound_ms=nbytes / 3.35e12 * 1e3, bytes=nbytes)), flush=True)
    kernels.SCATTER_TARGET_TILES, kernels.SCATTER_TILE_WORDS = package
    dev = torch.device("cuda", 0)
    for site in () if default else ("readmission", "datapath_delta"):
        segs = sites[site]
        geo = [kernels._repair_geometry(d, a, i, v, dev)
               for d, a, i, v in segs]
        args = kernels.scatter_args(geo, "repair_scatter")
        lib = kernels.PUBLISH_LIBRARY.load()
        parts = {
            "wrapper": lambda: kernels.REPAIR_SCATTER(segs),
            "geometry": lambda: [kernels._repair_geometry(d, a, i, v, dev)
                                 for d, a, i, v in segs],
            "tiling_args_launch": lambda: kernels.PUBLISH_LIBRARY.scatter(
                "launch_repair_scatter", geo, dev, "repair_scatter"),
            "launch_call": lambda: lib.launch_repair_scatter(
                ctypes.addressof(args), kernels._stream(dev)),
            "current_stream": lambda: torch.cuda.current_stream(
                dev).cuda_stream,
            "index_copy_": lambda: [d.index_copy_(a, i, v)
                                    for d, a, i, v in segs],
        }
        if hasattr(torch._C, "_cuda_getCurrentRawStream"):
            parts["raw_stream"] = lambda: torch._C._cuda_getCurrentRawStream(
                dev.index)
        print(json.dumps(dict(site=site, segments=len(segs), host_us={
            k: host_us(f) for k, f in parts.items()})), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
