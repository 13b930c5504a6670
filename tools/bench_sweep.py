#!/usr/bin/env python
"""Mode × carriers bench sweep on the GPU.

Runs bench.py as a subprocess for every (mode, carriers) combination
and writes the results as JSON (default chiprun_out/bench_sweep.json).

    python tools/bench_sweep.py
    python tools/bench_sweep.py --quick    # 128-carrier modes only
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(mode: str, carriers: int, iters: int,
            max_toa: int = 0) -> dict:
    env = dict(os.environ, BENCH_MODE=mode, BENCH_CHANNELS=str(carriers),
               BENCH_ITERS=str(iters), BENCH_MAX_TOA=str(max_toa))
    p = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                       env=env, capture_output=True, text=True)
    line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else "{}"
    try:
        return json.loads(line)
    except json.JSONDecodeError:
        return {"error": p.stderr[-400:]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "bench_sweep.json"))
    args = ap.parse_args()

    if args.quick:
        grid = [(m, 128, 0) for m in ("exact", "decoded", "downlink",
                                      "duplex", "duplex_decoded")]
    else:
        # every uplink/duplex row is exact semantics; duplex_decoded =
        # the fully-resident L1 (FEC both directions in-program)
        grid = ([("exact", c, 0) for c in (8, 128, 512, 1024)]
                + [("decoded", 128, 0), ("decoded", 512, 0),
                   ("decoded", 1024, 0),
                   ("downlink", 128, 0),
                   ("downlink", 512, 0),
                   ("downlink", 1024, 0)]
                + [("duplex", c, 0) for c in (8, 128, 512, 1024)]
                + [("duplex_decoded", c, 0) for c in (128, 512, 1024)]
                # the SETMAXDELAY windowed TSC correlation
                + [("exact", 1024, 4)])

    results = []
    for mode, carriers, max_toa in grid:
        # keep the timed span well above bench.py's noise guard
        # (dt > 0.02 s): small carrier counts need more iterations
        iters = 8 if carriers <= 256 else 4
        if carriers <= 128:
            iters = 32 if mode in ("exact", "decoded", "downlink") else 24
        print(f"[sweep] {mode} @ {carriers} max_toa={max_toa}...",
              file=sys.stderr, flush=True)
        r = run_one(mode, carriers, iters, max_toa)
        r["mode"], r["carriers"] = mode, carriers
        if max_toa:
            r["max_toa"] = max_toa
        results.append(r)
        print(f"[sweep]   -> {r.get('value')} {r.get('unit', '')}",
              file=sys.stderr, flush=True)
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
