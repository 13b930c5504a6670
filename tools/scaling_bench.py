#!/usr/bin/env python
"""Scaling-efficiency measurement for the sharded pipeline
(BASELINE config 5: samples/s at mesh sizes 1..N).

Runs on the real devices and fails if fewer are present than
`--devices` asks for. With --cpu the same SPMD program runs on a
virtual CPU device mesh (--xla_force_host_platform_device_count), which
validates the sharding and gives relative-efficiency numbers for the
collective structure (absolute CPU throughput says nothing of a GPU).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8,
                    help="largest mesh to measure")
    ap.add_argument("--chan-per-shard", type=int, default=2)
    ap.add_argument("--frames-per-shard", type=int, default=13)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run on a virtual CPU mesh of --devices")
    args = ap.parse_args()

    if args.cpu:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count="
                        f"{args.devices}").strip()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from openbts_ttsou_tpu.parallel import make_mesh, sharded_uplink_pipeline
    from openbts_ttsou_tpu.parallel.sharded import (
        ShardedPipelineSpec,
        state_for_shards,
    )
    from openbts_ttsou_tpu.trx import ChanType, TrxConfig, init_state

    n_avail = len(jax.devices())
    if n_avail < args.devices:
        raise SystemExit(f"asked for {args.devices} devices, found "
                         f"{n_avail} ({jax.devices()[0].platform})")
    results = []
    sizes = [n for n in (1, 2, 4, 8, 16) if n <= args.devices]
    rng = np.random.default_rng(0)
    for n in sizes:
        mesh = make_mesh(n)
        n_time = mesh.shape["time"]
        n_chan = args.chan_per_shard * mesh.shape["chan"]
        cfg = TrxConfig(n_chan=n_chan)
        spec = ShardedPipelineSpec(n_chan_total=n_chan,
                                   frames_per_shard=args.frames_per_shard)
        ct = np.zeros((n_chan, 8), np.int32)
        ct[:, 1:] = ChanType.I
        state = init_state(cfg)._replace(chan_type=jnp.asarray(ct))
        state_sh = state_for_shards(state, n_time)
        samples = jax.device_put(
            (rng.standard_normal((n_chan, n_time * spec.block_in))
             + 1j * rng.standard_normal((n_chan, n_time * spec.block_in))
             ).astype(np.complex64) * 400.0)

        def measure(**kw):
            step = sharded_uplink_pipeline(mesh, cfg, spec, **kw)
            st, res, clock = step(state_sh, samples,
                                  jnp.asarray(0, jnp.int32))
            jax.block_until_ready(res)  # warm
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    st, res, clock = step(st, samples,
                                          jnp.asarray(0, jnp.int32))
                jax.block_until_ready(res)
                best = min(best, time.perf_counter() - t0)
            return best

        dt = measure()  # full pipeline: halos + clock psum + carry
        dt_nocarry = measure(carry_state=False)
        dt_nocoll = measure(collectives=False)  # compute-only isolation
        total = args.iters * n_chan * n_time * spec.block_in
        sps = total / dt
        results.append({"devices": n, "mesh": dict(mesh.shape),
                        "Msps": round(sps / 1e6, 3)})
        base = results[0]["Msps"]
        eff = sps / 1e6 / (base * n)
        print(json.dumps({
            **results[-1],
            "efficiency_vs_1dev": round(eff, 3),
            "step_ms": round(dt / args.iters * 1e3, 2),
            "carry_cost_ms": round((dt - dt_nocarry) / args.iters * 1e3,
                                   2),
            "collective_cost_ms": round(
                (dt - dt_nocoll) / args.iters * 1e3, 2),
        }))


if __name__ == "__main__":
    main()
