#!/usr/bin/env python
"""Wire-soak sweep on the GPU.

Runs tools/daemon_soak.py across carriers × load × geometry and writes
the ms/frame frontier of the block daemon through the actual 3-plane
UDP protocol as JSON (default chiprun_out/soak_sweep.json). Every row
carries `config` (the knobs), `why` (what the row demonstrates) and
the child's full result; the SocketBus row runs bus-server-hosted
radios across a real process boundary, the configuration closest to
physical hardware.

    python tools/soak_sweep.py                 # full grid
    python tools/soak_sweep.py --quick         # frontier rows only
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(carriers: int, blocks: int, compact: int, ul_slots: int,
            dl_carriers: int, depth: int, block_frames: int,
            bus: str) -> dict:
    cmd = [sys.executable, os.path.join(REPO, "tools", "daemon_soak.py"),
           "--carriers", str(carriers), "--blocks", str(blocks),
           "--compact", str(compact),
           "--ul-slots", str(ul_slots), "--dl-carriers",
           str(dl_carriers), "--depth", str(depth),
           "--block-frames", str(block_frames), "--bus", bus]
    p = subprocess.run(cmd, capture_output=True, text=True)
    line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else "{}"
    try:
        return json.loads(line)
    except json.JSONDecodeError:
        return {"error": (p.stderr or "")[-400:]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out",
                    default=os.path.join(REPO, "chiprun_out",
                                         "soak_sweep.json"))
    args = ap.parse_args()

    # (carriers, compact, ul_slots, dl_carriers, block_frames, depth,
    #  bus, why)
    frontier = [
        (1, 1, 7, -1, 26, 2, "replay",
         "1-carrier full load: the smallest deployment — the "
         "real-time budget must be met HERE if anywhere"),
        (2, 1, 7, -1, 26, 2, "replay", "2 carriers full load"),
        (4, 1, 7, -1, 26, 2, "replay", "4 carriers full load"),
        (8, 1, 7, -1, 26, 2, "replay", "8 carriers full load"),
    ]
    if args.quick:
        grid = frontier
    else:
        grid = frontier + [
            # geometry variants at the frontier: bigger blocks + a
            # deeper pipeline amortize per-transfer latency
            (2, 1, 7, -1, 52, 3, "replay",
             "52-frame blocks + depth 3: fewer, larger transfers"),
            (4, 1, 7, -1, 52, 3, "replay", "52-frame blocks at 4"),
            (8, 1, 7, -1, 52, 3, "replay", "52-frame blocks at 8"),
            # scale-up, full load
            (16, 1, 7, -1, 26, 2, "replay", "16 carriers full load"),
            (32, 1, 7, -1, 26, 2, "replay", "32 carriers full load"),
            # dense-path baseline (D2H bytes before compaction)
            (8, 0, 7, -1, 26, 2, "replay",
             "dense D2H baseline at the frontier point"),
            # realistic sparse load: compaction's target regime
            (16, 1, 2, 4, 26, 2, "replay", "sparse load 16"),
            (32, 1, 2, 8, 26, 2, "replay", "sparse load 32"),
            (64, 1, 2, 16, 26, 2, "replay", "sparse load 64"),
            (128, 1, 2, 32, 26, 2, "replay", "sparse load 128"),
            # the configuration closest to hardware: every sample
            # crosses an AF_UNIX bus to a server process
            (8, 1, 3, -1, 26, 2, "socket",
             "bus-server-hosted radios (SocketBus across a real "
             "process boundary; ms/frame + bus MB/s recorded)"),
        ]

    artifact = {"rows": []}
    for carriers, compact, ul_slots, dl_c, bf, depth, bus, why in grid:
        blocks = 25 if carriers <= 32 else 15
        if bf >= 52:
            blocks = max(blocks // 2, 8)
        tag = (f"c={carriers} compact={compact} ul={ul_slots} "
               f"dl={dl_c} bf={bf} depth={depth} bus={bus}")
        print(f"[soak-sweep] {tag}...", file=sys.stderr, flush=True)
        r = run_one(carriers, blocks, compact, ul_slots, dl_c, depth,
                    bf, bus)
        r.setdefault("detail", {})
        r["config"] = {"carriers": carriers, "compact": bool(compact),
                       "ul_slots": ul_slots, "dl_carriers": dl_c,
                       "block_frames": bf, "depth": depth, "bus": bus}
        r["why"] = why
        artifact["rows"].append(r)
        print(f"[soak-sweep]   -> {r.get('value')} {r.get('unit', '')} "
              f"realtime={r.get('detail', {}).get('realtime')}",
              file=sys.stderr, flush=True)
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
    print(json.dumps(artifact))


if __name__ == "__main__":
    main()
