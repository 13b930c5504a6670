#!/usr/bin/env python
"""One process of a multi-process `jax.distributed` run of the sharded
uplink pipeline (driven by tests/test_distributed.py).

This is the DCN analogue of the reference's two cooperating processes
(Transceiver52M/Transceiver.cpp:42-44 UDP planes; SURVEY.md §2.2 P5):
each process owns a slice of the device mesh, contributes its local
shard of the global sample stream, and the `ppermute`/`psum`/
`all_gather` collectives inside `sharded_uplink_pipeline` ride the
cross-process transport that `jax.distributed` provides.

Launch (one per process):
    JAX_COORDINATOR_ADDRESS=127.0.0.1:<port> JAX_NUM_PROCESSES=N \
    JAX_PROCESS_ID=k XLA_FLAGS=--xla_force_host_platform_device_count=D \
    python tools/distributed_worker.py [steps]

Each process independently computes the same deterministic scenario,
runs the distributed program, verifies its *addressable* result shards
against a serial single-device reference, and prints one JSON line.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import jax

    # the worker runs on the CPU backend; set before any backend use
    jax.config.update("jax_platforms", "cpu")

    from openbts_ttsou_tpu.parallel import distributed

    distributed.initialize()  # from JAX_COORDINATOR_ADDRESS etc.

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from openbts_ttsou_tpu.ops import fir, gmsk
    from openbts_ttsou_tpu.parallel.sharded import (
        ShardedPipelineSpec,
        _slot_windows,
        sharded_duplex_pipeline,
        sharded_uplink_pipeline,
        state_for_shards,
        state_partition_specs,
    )
    from openbts_ttsou_tpu.trx import ChanType, TrxConfig, init_state, rx_step
    from openbts_ttsou_tpu.utils import constants as C

    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    duplex = os.environ.get("WORKER_DUPLEX", "") == "1"
    # compute-dominated geometry knob (round-3 verdict #7): more
    # carriers per shard makes per-step compute >> the Gloo RTT, so the
    # measured efficiency itself carries the >=80% scaling claim
    n_carriers = int(os.environ.get("WORKER_CARRIERS", "1"))
    verify = os.environ.get("WORKER_VERIFY", "1") == "1"
    pid = jax.process_index()
    nproc = jax.process_count()
    devs = jax.devices()  # global, across processes
    n_time = len(devs)
    mesh = Mesh(np.asarray(devs).reshape(1, n_time), ("chan", "time"))

    cfg = TrxConfig(n_chan=n_carriers)
    spec = ShardedPipelineSpec(n_chan_total=n_carriers,
                               frames_per_shard=13)
    frames_step = n_time * spec.frames_per_shard
    frames_total = steps * frames_step

    # deterministic scenario, identical in every process
    rng = np.random.default_rng(7)
    bits = np.concatenate(
        [[0, 0, 0], rng.integers(0, 2, 57), [1], C.TRAINING_SEQUENCE[0],
         [1], rng.integers(0, 2, 57), [0, 0, 0]]).astype(np.uint8)
    wave = 9000.0 * np.asarray(gmsk.modulate_burst(bits[None], 1))[0]
    sym = np.zeros((1, frames_total * 1250), np.complex64)
    planted = []
    for f in range(1, frames_total, 3):
        sym[0, f * 1250 + 157: f * 1250 + 157 + len(wave)] += wave
        planted.append(f)
    sym = np.broadcast_to(sym, (n_carriers, sym.shape[1])).copy()
    up_lpf = fir.resampler_lpf(96, 65, 651)
    down_lpf = fir.resampler_lpf(65, 96, 961)
    dev_rate = np.asarray(fir.polyphase_resample(
        jnp.asarray(sym), 96, 65, up_lpf))

    chan_type = np.zeros((n_carriers, 8), np.int32)
    chan_type[:, 1] = ChanType.I
    state0 = init_state(cfg)._replace(chan_type=jnp.asarray(chan_type))

    # serial single-device reference (local, no collectives); skipped
    # in pure-throughput runs (WORKER_VERIFY=0)
    det_serial = None
    if verify:
        sym_back = fir.polyphase_resample(jnp.asarray(dev_rate), 65, 96,
                                          down_lpf)
        wins = _slot_windows(sym_back, frames_total)
        st = state0
        det_serial = []
        for f in range(frames_total):
            st, r = rx_step(cfg, st, wins[f])
            det_serial.append(np.asarray(r.detected))
        det_serial = np.stack(det_serial)  # [frames_total, C, 8]

    # global arrays: every process provides its addressable shards of
    # the SAME logical value (jax.make_array_from_callback slices the
    # full local copy by the sharding's index map)
    def gput(x, pspec):
        x = np.asarray(x)
        sh = NamedSharding(mesh, pspec)
        return jax.make_array_from_callback(x.shape, sh,
                                            lambda idx: x[idx])

    state_sh = jax.tree.map(
        gput, state_for_shards(jax.tree.map(np.asarray, state0), n_time),
        state_partition_specs())

    if duplex:
        # tx window bits identical in every process; the serial tx
        # reference for shard verification
        from openbts_ttsou_tpu.models.transceiver import (
            UplinkSpec,
            downlink_block,
        )

        rng2 = np.random.default_rng(11)
        dl_bits_all = rng2.integers(
            0, 2, (frames_total, n_carriers, 8, 148)).astype(np.uint8)
        dl_valid_all = rng2.random((frames_total, n_carriers, 8)) < 0.6
        dl_atten_all = np.zeros((frames_total, n_carriers, 8),
                                np.float32)
        tx_serial = []
        if verify:
            for s in range(steps):
                sl = slice(s * frames_step, (s + 1) * frames_step)
                tx_serial.append(np.asarray(downlink_block(
                    cfg, UplinkSpec(frames=frames_step), state0,
                    jnp.asarray(dl_bits_all[sl]),
                    jnp.asarray(dl_valid_all[sl]),
                    jnp.asarray(dl_atten_all[sl]),
                    jnp.asarray(s * frames_step, jnp.int32))))
        step_fn = sharded_duplex_pipeline(mesh, cfg, spec,
                                          carry_state=True)
    else:
        step_fn = sharded_uplink_pipeline(mesh, cfg, spec,
                                          carry_state=True)
    block = n_time * spec.block_in

    ok = True
    mismatches = 0
    hits = 0
    t_compile = t_run = 0.0
    clock_vals = []
    for s in range(steps):
        x = gput(dev_rate[:, s * block: (s + 1) * block],
                 P("chan", "time"))
        fn0 = jnp.asarray(s * frames_step, jnp.int32)
        t0 = time.perf_counter()
        if duplex:
            sl = slice(s * frames_step, (s + 1) * frames_step)
            state_sh, res, tx, clock = step_fn(
                state_sh, x, gput(dl_bits_all[sl], P("time", "chan")),
                gput(dl_valid_all[sl], P("time", "chan")),
                gput(dl_atten_all[sl], P("time", "chan")), fn0)
            jax.block_until_ready((res.detected, tx))
            # verify addressable TX shards against the serial modulator
            if verify:
                scale = np.abs(tx_serial[s]).max() or 1.0
                for shard in tx.addressable_shards:
                    got = np.asarray(shard.data)
                    want = tx_serial[s][shard.index]
                    bad = ~np.isclose(got, want, atol=2e-4 * scale)
                    if bad.any():
                        ok = False
                        mismatches += int(bad.sum())
        else:
            state_sh, res, clock = step_fn(state_sh, x, fn0)
            jax.block_until_ready(res.detected)
        dt = time.perf_counter() - t0
        if s == 0:
            t_compile = dt
        else:
            t_run += dt
        clock_vals.append(int(np.asarray(clock)))
        # verify the shards THIS process owns against the serial run
        for shard in res.detected.addressable_shards:
            got = np.asarray(shard.data)
            if verify:
                f_lo = s * frames_step + shard.index[0].start
                want = det_serial[f_lo: f_lo + got.shape[0]]
                if not np.array_equal(got, want):
                    ok = False
                    mismatches += int((got != want).sum())
            hits += int(got[:, 0, 1].sum())
    expect_clock = block
    ok = ok and all(c == expect_clock for c in clock_vals)

    print(json.dumps({
        "process": pid, "n_processes": nproc, "n_devices": n_time,
        "duplex": duplex, "carriers": n_carriers, "verified": verify,
        "ok": ok, "mismatches": mismatches, "local_hits": hits,
        "clock": clock_vals[0],
        "steps": steps,
        "compile_s": round(t_compile, 3),
        "per_step_s": round(t_run / max(steps - 1, 1), 4),
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
