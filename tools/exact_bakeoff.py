#!/usr/bin/env python
"""Bake-off: the two EXACT-semantics uplink engines on the GPU.

`process_block_exact` (batched heavy ops + light scalar scan) vs the
per-frame `rx_step` scan — identical semantics (tests/test_exact_block
.py), different schedules. Each is compiled once per carrier count on
bench.py's planted-burst symbol stream (standard channel layout),
warmed, and timed over `--reps` calls that each end in
`block_until_ready`. Prints the median and minimum ms per 13-frame block
and, as its last line, one JSON object with the measured frontier —
the evidence for the device programs' use of the batched schedule.

    python tools/exact_bakeoff.py [--carriers 8,32,64,128,512,1024]
"""

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--carriers", default="8,32,64,128,512,1024")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.lax as lax
    import jax.numpy as jnp

    from bench import planted_symbols, standard_chan_type
    from openbts_ttsou_tpu.models.transceiver import (
        UplinkSpec,
        process_block_exact,
    )
    from openbts_ttsou_tpu.parallel.sharded import _slot_windows
    from openbts_ttsou_tpu.trx import TrxConfig, init_state
    from openbts_ttsou_tpu.trx import engine as eng
    from openbts_ttsou_tpu.utils.compile_cache import enable_compile_cache

    dev0 = jax.devices()[0]
    if dev0.platform != "gpu":
        raise SystemExit(f"the bake-off measures the GPU; found "
                         f"{dev0.platform}")
    enable_compile_cache()
    spec = UplinkSpec(frames=13)
    f = spec.frames
    rows = []
    for n_chan in (int(x) for x in args.carriers.split(",")):
        cfg = TrxConfig(n_chan=n_chan)
        state = init_state(cfg)._replace(
            chan_type=jnp.asarray(standard_chan_type(n_chan)))
        sym = jax.device_put(
            planted_symbols(n_chan, spec.block_symbols, f))
        impls = {
            "batched": jax.jit(
                lambda st, s: process_block_exact(cfg, f, st, s)),
            "scan": jax.jit(lambda st, s: lax.scan(
                lambda a, fr: eng.rx_step(cfg, a, fr), st,
                _slot_windows(s, f))),
        }
        for impl, fn in impls.items():
            jax.block_until_ready(fn(state, sym))  # compile + warm
            ts = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                jax.block_until_ready(fn(state, sym))
                ts.append((time.perf_counter() - t0) * 1e3)
            rows.append({"carriers": n_chan, "impl": impl,
                         "median_ms_per_block": statistics.median(ts),
                         "min_ms_per_block": min(ts)})
            print(f"[bakeoff] {n_chan}@{impl}: median "
                  f"{rows[-1]['median_ms_per_block']} ms/block, min "
                  f"{rows[-1]['min_ms_per_block']}", file=sys.stderr,
                  flush=True)

    # the recommended boundary: the largest carrier count up to which
    # the batched schedule wins at every count measured
    by_c = {}
    for r in rows:
        by_c.setdefault(r["carriers"], {})[r["impl"]] = \
            r["median_ms_per_block"]
    boundary = 0
    for c_, d in sorted(by_c.items()):
        if d["batched"] > d["scan"]:
            break
        boundary = c_
    print(json.dumps({"metric": "exact_engine_bakeoff", "rows": rows,
                      "recommended_batch_max_chan": boundary,
                      "reps": args.reps, "platform": dev0.platform,
                      "device_kind": dev0.device_kind}))


if __name__ == "__main__":
    main()
