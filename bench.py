#!/usr/bin/env python
"""Benchmark: uplink DSP chain throughput on one accelerator.

Runs the flagship pipeline — 961-tap polyphase resample (65/96) →
energy detect → TSC/RACH correlate → peak detect → channel est/DFE →
demodulate — batched over many ARFCN channels, and reports device-rate
complex Msamples/s per device. Baseline: bench/cpu_baseline.cpp, a
hand-written single-core mirror of the same chain (its measured rate
is cached in bench/baseline_cpu.json).

Refuses to run without a GPU. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
BASELINE_CACHE = os.path.join(REPO, "bench", "baseline_cpu.json")


def measure_mirror_baseline() -> float:
    """Single-core samples/s of the hand-written mirror of the chain."""
    if os.path.exists(BASELINE_CACHE):
        with open(BASELINE_CACHE) as f:
            return json.load(f)["samples_per_s"]
    exe = os.path.join(REPO, "bench", "cpu_baseline")
    src = os.path.join(REPO, "bench", "cpu_baseline.cpp")
    subprocess.run(["g++", "-O3", "-march=native", "-o", exe, src], check=True)
    out = subprocess.run([exe, "400"], check=True, capture_output=True,
                        text=True).stdout.strip()
    data = json.loads(out)
    with open(BASELINE_CACHE, "w") as f:
        json.dump(data, f)
    return data["samples_per_s"]


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def standard_chan_type(n_chan: int):
    """[C, 8] channel combinations of the standard layout: C-IV on TN0,
    C-I TCH/F on TN1-7."""
    import numpy as np

    from openbts_ttsou_tpu.trx import ChanType

    chan_type = np.zeros((n_chan, 8), np.int32)
    chan_type[:, 1:] = ChanType.I
    chan_type[:, 0] = ChanType.IV
    return chan_type


def planted_symbols(n_chan: int, block_symbols: int, frames: int):
    """Symbol-rate uplink [C, block_symbols] complex64: low noise plus
    one TSC-0 normal burst in TN1 of every frame of every carrier (keeps
    every detection path honest; compute is data-independent anyway)."""
    import numpy as np

    from openbts_ttsou_tpu.ops import gmsk
    from openbts_ttsou_tpu.utils import constants as C

    rng = np.random.default_rng(0)
    sym = (rng.standard_normal((n_chan, block_symbols))
           + 1j * rng.standard_normal((n_chan, block_symbols))
           ).astype(np.complex64) * 10.0
    bits = np.concatenate(
        [[0, 0, 0], rng.integers(0, 2, 57), [1], C.TRAINING_SEQUENCE[0], [1],
         rng.integers(0, 2, 57), [0, 0, 0]]).astype(np.uint8)
    wave = 9000.0 * gmsk.modulate_burst_np(bits[None], 1)[0]
    for f in range(frames):
        off = f * 1250 + 157
        sym[:, off: off + 148] += wave
    return sym


def main():
    import numpy as np

    # the exact engine: the live daemon's frame-walk semantics
    n_chan = int(os.environ.get("BENCH_CHANNELS", "512"))
    iters = int(os.environ.get("BENCH_ITERS", "8"))
    # exact | decoded (uplink) | downlink | duplex | duplex_decoded
    mode = os.environ.get("BENCH_MODE", "exact")

    baseline_sps = measure_mirror_baseline()

    import jax

    from openbts_ttsou_tpu.utils.compile_cache import enable_compile_cache

    dev0 = jax.devices()[0]
    if dev0.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; found {dev0.platform}")
    enable_compile_cache()

    import jax.numpy as jnp

    from openbts_ttsou_tpu.models.transceiver import (
        UplinkSpec,
        uplink_block,
        uplink_block_decoded,
    )
    from openbts_ttsou_tpu.trx import TrxConfig, init_state

    # BENCH_MAX_TOA=<symbols> applies the 52M windowed TSC correlation
    # (2·maxTOA+1 lags) — the SETMAXDELAY-driven compute win
    max_toa = int(os.environ.get("BENCH_MAX_TOA", "0")) or None
    # BENCH_RACH_SLOTS: comma-separated TNs that can carry RACH, or
    # "all" for the dense engine (the default).
    rs_env = os.environ.get("BENCH_RACH_SLOTS", "all")
    rach_slots = None if rs_env == "all" else tuple(
        int(t) for t in rs_env.split(","))
    log(f"devices={jax.devices()} mode={mode} chan={n_chan} "
        f"iters={iters} max_toa={max_toa} rach_slots={rach_slots}")
    cfg = TrxConfig(n_chan=n_chan, max_toa=max_toa,
                    rach_slots=rach_slots)
    spec = UplinkSpec(frames=13)

    state = init_state(cfg)._replace(
        chan_type=jnp.asarray(standard_chan_type(n_chan)))

    # device-rate IQ with real bursts planted
    sym = planted_symbols(n_chan, spec.block_symbols, spec.frames)
    from openbts_ttsou_tpu.ops import fir
    _lpf_up = fir.resampler_lpf(96, 65, 651)
    dev = jax.jit(
        lambda s: fir.polyphase_resample(s, 96, 65, _lpf_up)
        [:, : spec.block_in]
    )(jax.device_put(sym))  # one compiled prep program
    jax.block_until_ready(dev)
    log("prep done")

    # One fused program: scan `iters` chained uplink blocks and return a
    # scalar probe — one dispatch per timed run.
    import jax.lax as lax

    if mode in ("downlink", "duplex", "duplex_decoded"):
        from openbts_ttsou_tpu.models.transceiver import (
            RX_HALO_DEV,
            TX_TAIL_SYM,
            downlink_block,
            duplex_block_decoded,
            duplex_block_wire,
        )

        rng2 = np.random.default_rng(1)
        dl_bits = jnp.asarray(rng2.integers(
            0, 2, (spec.frames, n_chan, 8, 148)).astype(np.uint8))
        dl_valid = jnp.asarray(np.ones((spec.frames, n_chan, 8), bool))
        dl_atten = jnp.asarray(np.zeros((spec.frames, n_chan, 8),
                                        np.float32))

    if mode == "downlink":
        def make_fused(length):
            @jax.jit
            def fused(state, samples):
                del samples

                def body(fn, _):
                    # perturb the gains by the loop counter: tx_step
                    # ignores fn, so an unperturbed body is
                    # loop-invariant and XLA hoists the entire block
                    # out of the scan (measured dt ≈ 0 at any length)
                    a = dl_atten + (fn % 977).astype(jnp.float32) * 1e-6
                    tx = downlink_block(cfg, spec, state, dl_bits,
                                        dl_valid, a, fn)
                    return fn + spec.frames, (jnp.sum(jnp.real(tx[..., 0])),
                                              jnp.sum(dl_valid))
                _, (probes, dets) = lax.scan(
                    body, jnp.asarray(0, jnp.int32), None, length=length)
                return jnp.sum(probes), jnp.sum(dets)
            return fused
    elif mode == "duplex":
        # uplink samples in the daemon's int16 ADC format, halo'd
        ul_i16 = jax.jit(lambda s: jnp.clip(jnp.round(jnp.stack(
            [jnp.real(s), jnp.imag(s)], -1)), -32767, 32767
        ).astype(jnp.int16))(jnp.pad(
            dev, ((0, 0), (RX_HALO_DEV, RX_HALO_DEV))))

        def make_fused(length):
            @jax.jit
            def fused(state, samples):
                del samples
                tail0 = jnp.zeros((n_chan, TX_TAIL_SYM), jnp.complex64)

                def body(carry, _):
                    st, tail, fn = carry
                    # carrier roll + gain perturbation defeat
                    # loop-invariant hoisting of the rx resample
                    # front-end and the whole tx modulate+resample leg
                    # (tx_step is fn-independent; see the uplink and
                    # downlink modes)
                    ul = jnp.roll(ul_i16, fn % 3, axis=0)
                    da = dl_atten + (fn % 977).astype(jnp.float32) * 1e-6
                    st2, tx, tail2, wire = duplex_block_wire(
                        cfg, spec, st, ul, tail, dl_bits, dl_valid,
                        da, fn, True)
                    probe = (jnp.sum(wire.soft_u8[..., 0].astype(
                        jnp.int32)) + jnp.sum(tx[:, 0, :].astype(
                            jnp.int32)))
                    return (st2, tail2, fn + spec.frames), \
                        (probe, jnp.sum(wire.detected))
                carry, (probes, dets) = lax.scan(
                    body, (state, tail0, jnp.asarray(0, jnp.int32)),
                    None, length=length)
                return jnp.sum(probes), jnp.sum(dets)
            return fused
    elif mode == "duplex_decoded":
        # the fully-resident configuration: FEC both directions INSIDE
        # the device program — XCCH + TCH/FS + FACCH encode on the tx
        # leg, streaming XCCH/RACH/TCH decode on the rx leg; L2 frames
        # and vocoder bits are the only host payloads
        from openbts_ttsou_tpu.gsm import l1fec
        from openbts_ttsou_tpu.models.transceiver import (
            DECODE_PRELUDE,
            XcchTxCarry,
            duplex_block_decoded as _dbd,
        )

        rng3 = np.random.default_rng(2)
        tch_mask = np.zeros((n_chan, 8), bool)
        tch_mask[:, 2:6] = True  # 4 TCH slots, 4 signalling slots
        frames184 = jnp.asarray(rng3.integers(
            0, 2, (4, n_chan, 8, 184)).astype(np.uint8))
        xv = jnp.asarray(np.ones((4, n_chan, 8), bool))
        speech = jnp.asarray(rng3.integers(
            0, 2, (3, n_chan, 8, 260)).astype(np.uint8))
        spv = jnp.asarray(np.ones((3, n_chan, 8), bool))
        facch = jnp.zeros((3, n_chan, 8, 184), jnp.uint8)
        fav = jnp.zeros((3, n_chan, 8), bool)
        content = (frames184, xv, speech, spv, facch, fav,
                   jnp.asarray(tch_mask))

        def make_fused(length):
            @jax.jit
            def fused(state, samples):
                # the halo'd uplink comes from the ARGUMENT, not a
                # closure constant
                ul_halo = jnp.pad(samples,
                                  ((0, 0), (RX_HALO_DEV, RX_HALO_DEV)))
                tail0 = jnp.zeros((n_chan, TX_TAIL_SYM), jnp.complex64)
                tc0 = (l1fec.TchTxCarry.zeros(n_chan * 8),
                       XcchTxCarry.zeros(n_chan))
                prev0 = jnp.zeros((DECODE_PRELUDE, n_chan, 8, 148),
                                  jnp.float32)

                def body(carry, _):
                    st, tail, tc, prev, pv, fn = carry
                    ul = jnp.roll(ul_halo, fn % 3, axis=0)
                    da = dl_atten + (fn % 977).astype(jnp.float32) * 1e-6
                    st = st._replace(fn=fn % 2715648)
                    # static slot split matching tch_mask: the decode
                    # leg runs each Viterbi only on its configured TNs
                    (st2, tx, tail2, blocks, tc2, prev2,
                     pv2) = _dbd(cfg, spec, st, ul, tail, content, da,
                                 tc, fn, prev, pv, 0, 0,
                                 (0, 1, 6, 7), (2, 3, 4, 5))
                    probe = (jnp.sum(blocks.bits[..., 0].astype(
                        jnp.int32)) + jnp.sum(jnp.real(tx[:, 0]))
                        + jnp.sum(blocks.tch_speech[..., 0].astype(
                            jnp.int32)))
                    dets = jnp.sum(blocks.ok) + jnp.sum(blocks.tch_good)
                    return (st2, tail2, tc2, prev2, pv2,
                            fn + spec.frames), (probe, dets)
                carry, (probes, dets) = lax.scan(
                    body, (state, tail0, tc0, prev0,
                           jnp.asarray(False), jnp.asarray(0, jnp.int32)),
                    None, length=length)
                return jnp.sum(probes), jnp.sum(dets)
            return fused
    else:
        block_fn = {"exact": uplink_block,
                    "decoded": uplink_block_decoded}[mode]

        def make_fused(length):
            @jax.jit
            def fused(state, samples):
                def body(st, _):
                    # rotate the carrier axis by the (carried) frame
                    # counter: with loop-invariant samples XLA hoists
                    # the whole 961-tap resampler out of the scan and
                    # the bench times a chain that skips it (measured
                    # +12% at exact@512). The roll forces every block
                    # to ingest "new" data, as streaming does.
                    s = jnp.roll(samples, st.fn % 3, axis=0)
                    out = block_fn(cfg, spec, st, s)
                    st, res = out[0], out[1]
                    probe = jnp.sum(res.soft_bits[..., 0])
                    if mode == "decoded":  # include FEC output
                        probe = probe + jnp.sum(out[2].bits[..., 0])
                    return st, (probe, jnp.sum(res.detected))
                st, (probes, dets) = lax.scan(body, state, None,
                                              length=length)
                return jnp.sum(probes), jnp.sum(dets)
            return fused

    # Two scan lengths, k and 2k: sps is computed from t(2k) − t(k),
    # which cancels the fixed per-dispatch costs (host dispatch, the
    # transfer of the result).
    fused_1 = make_fused(iters)
    fused_2 = make_fused(2 * iters)

    def timed(fn):
        t0 = time.perf_counter()
        probe, dets = jax.block_until_ready(fn(state, dev))
        return time.perf_counter() - t0, dets

    # warm runs (compile + execute once each)
    log("fused: compile+warm run (k)")
    jax.block_until_ready(fused_1(state, dev))
    log("fused: compile+warm run (2k)")
    jax.block_until_ready(fused_2(state, dev))
    log("fused warm done; timing")

    from openbts_ttsou_tpu.utils.profiling import maybe_trace

    reps = int(os.environ.get("BENCH_REPS", "3"))
    with maybe_trace():  # OPENBTS_TRACE=<dir> for an XPlane trace
        t1 = min(timed(fused_1)[0] for _ in range(reps))
        t2, dets = float("inf"), None
        for _ in range(reps):
            t, d = timed(fused_2)
            if t < t2:
                t2, dets = t, d
    dt = t2 - t1  # time for `iters` blocks, fixed overhead cancelled
    if not (dt > 0.02 and dt > 0.1 * t1):
        # overhead noise swamped the difference: the measurement is
        # unreliable
        raise RuntimeError(
            f"timing too noisy: t1={t1:.4f}s t2={t2:.4f}s")
    fetch_rtt = max(2 * t1 - t2, 0.0)  # implied fixed overhead

    total_samples = iters * n_chan * spec.block_in
    sps = total_samples / dt
    detected = int(np.asarray(dets))

    metric = {"downlink": "downlink_chain_throughput",
              "duplex": "duplex_chain_throughput",
              "duplex_decoded": "duplex_decoded_chain_throughput"}.get(
                  mode, "uplink_chain_throughput")
    print(json.dumps({
        "metric": metric,
        "value": round(sps / 1e6, 3),
        "unit": "Msamples/s/chip",
        "vs_baseline": round(sps / baseline_sps, 2),
        "detail": {
            "n_chan": n_chan,
            "iters": iters,
            "frame_latency_ms": round(dt / (iters * spec.frames) * 1e3,
                                      3),
            "mode": mode,
            **({"duplex_exact": True}
               if mode.startswith("duplex") else {}),
            "seconds": round(dt, 4),
            "fetch_rtt_s": round(fetch_rtt, 4),
            "detections_last_block": detected,
            "max_toa": max_toa,
            "rach_slots": rs_env,
            "cpu_baseline_Msps": round(baseline_sps / 1e6, 3),
            "cpu_baseline_harness": "hand-written mirror",
            "platform": dev0.platform,
            "device_kind": dev0.device_kind,
            "device_count": len(jax.devices()),
        },
    }))


if __name__ == "__main__":
    main()
