"""The PyTorch port's headline loop on one card, two trees compared in
one run: config 5's 8 pairs of 2 x 2,097,152 flows through
PersistentPairDispatcher at K = 4, as chip_smoke.py's main_path drives
them, timed with the staging and copies included.

    python3 tools/torch_headline_ab.py PARENT_DIR CHANGE_DIR

runs the trees in the order parent, change, change, parent, each in a
process of its own that imports the port from that tree, builds its
datapath library, the config-5 world and its headline tables, then
times REPS loops with a fresh dispatcher each (as main_path does) and
REPS loops through one dispatcher kept across them.  Prints one JSON
line per process, the card's name and power limit, and a summary line.
Needs a CUDA device; imports no JAX.
"""

import json
import os
import subprocess
import sys
import time

REPS = 6
N_PAIRS = 8
PERSIST_K = 4
HALF = 1 << 21


def one_tree() -> dict:
    import torch

    from cilium_tpu_torch import convert, kernels, world
    from cilium_tpu_torch.engine import datapath as dp
    from cilium_tpu_torch.engine import verdict

    kernels.build_all(("datapath",))
    w = world.make_world(seed=5)
    tables = convert.tables_to(world.headline_tables(w), "cuda")
    pairs = w.pairs(seed=42, half=HALF, k=N_PAIRS)
    flows = N_PAIRS * 2 * HALF

    def loop(disp) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for p in pairs:
            disp.submit(p)
        disp.flush()
        torch.cuda.synchronize()
        return flows / (time.perf_counter() - t)

    def dispatcher():
        acc = verdict.make_counter_buffers(tables.policy)
        return dp.PersistentPairDispatcher(
            tables, PERSIST_K, acc, verdict.make_telemetry_buffers(acc.device))

    fresh = [loop(dispatcher()) for _ in range(REPS)]
    kept = dispatcher()
    reused = [loop(kept) for _ in range(REPS)]
    return dict(tree=os.getcwd(), fresh_dispatcher_vps=fresh,
                reused_dispatcher_vps=reused)


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(one_tree()), flush=True)
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = (os.path.abspath(d) for d in sys.argv[1:])
    me = os.path.abspath(__file__)
    runs = []
    for tree in (parent, change, change, parent):
        env = dict(os.environ, PYTHONPATH=tree)
        out = subprocess.run([sys.executable, me, "--one"], cwd=tree, env=env,
                             capture_output=True, text=True, check=True)
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        rec["side"] = "parent" if tree == parent else "change"
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    summary = {}
    for side in ("parent", "change"):
        for key in ("fresh_dispatcher_vps", "reused_dispatcher_vps"):
            vals = sorted(v for r in runs if r["side"] == side for v in r[key])
            summary[f"{side}_{key}_median"] = vals[len(vals) // 2]
            summary[f"{side}_{key}_range"] = [vals[0], vals[-1]]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
