#!/usr/bin/env python
"""Per-stage timing of the uplink chain on the current backend.

Each stage runs as one fused jit program iterating ITERS times inside a
lax.scan (carry-perturbed inputs prevent loop-invariant hoisting), so
one dispatch covers ITERS stage calls.
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    import numpy as np

    import jax
    import jax.lax as lax
    import jax.numpy as jnp

    from openbts_ttsou_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from openbts_ttsou_tpu.models.transceiver import UplinkSpec
    from openbts_ttsou_tpu.ops import correlate as xcorr
    from openbts_ttsou_tpu.ops import dfe as dfe_mod
    from openbts_ttsou_tpu.ops import fir
    from openbts_ttsou_tpu.ops import gmsk as gmsk_mod
    from openbts_ttsou_tpu.parallel.sharded import _slot_windows
    from openbts_ttsou_tpu.trx import TrxConfig
    from openbts_ttsou_tpu.trx import engine as eng

    import os
    n_chan = int(os.environ.get("BENCH_CHANNELS", "32"))
    f, iters = 13, 16
    spec = UplinkSpec(frames=f)
    rng = np.random.default_rng(0)
    dev = jax.device_put(
        (rng.standard_normal((n_chan, spec.block_in))
         + 1j * rng.standard_normal((n_chan, spec.block_in))
         ).astype(np.complex64) * 50)
    sym = jax.device_put(
        (rng.standard_normal((n_chan, spec.block_symbols))
         + 1j * rng.standard_normal((n_chan, spec.block_symbols))
         ).astype(np.complex64) * 50)
    bursts = jax.jit(lambda s: _slot_windows(s, f).reshape((-1, 157)))(sym)
    n = int(bursts.shape[0])
    sps = 1

    def probe(r):
        return sum(jnp.sum(jnp.abs(leaf).astype(jnp.float32))
                   for leaf in jax.tree_util.tree_leaves(r)
                   if hasattr(leaf, "dtype"))

    def timeit(name, fn, x, *extra):
        @jax.jit
        def fused(x0, *ex):
            def body(c, _):
                return probe(fn(x0 * (1.0 + 1e-12 * c), *ex)), None
            out, _ = lax.scan(body, jnp.float32(0), None, length=iters)
            return out
        jax.block_until_ready(fused(x, *extra))  # compile + warm
        t0 = time.perf_counter()
        jax.block_until_ready(fused(x, *extra))
        dt = (time.perf_counter() - t0) / iters
        print(f"{name:28s} {dt * 1e3:8.3f} ms/iter")

    thr = np.zeros((n,), np.float32)
    tscf = np.zeros((n,), np.int32)
    amp = jax.device_put(np.ones((n,), np.complex64))
    toa = np.zeros((n,), np.float32)
    ce = jax.device_put(np.ones((n, 6), np.complex64))
    snr = np.full((n,), 10.0, np.float32)

    lpf = fir.resampler_lpf(65, 96, 961)
    timeit("resample 961t",
           lambda s: fir.polyphase_resample(s, 65, 96, lpf), dev)
    timeit("slot windows", lambda s: _slot_windows(s, f), sym)
    timeit("energy_detect",
           lambda b, t: xcorr.energy_detect(b, 20, t)[0], bursts, thr)
    timeit("analyze_traffic",
           lambda b, t: xcorr.analyze_traffic_burst(
               b, t, sps, threshold=3.0,
               estimate_channel=True)[0].amplitude, bursts, tscf)
    timeit("detect_rach",
           lambda b: xcorr.detect_rach(b, sps, threshold=5.0).amplitude,
           bursts)
    timeit("demodulate",
           lambda b, a, t: gmsk_mod.demodulate_burst(b, sps, a, t),
           bursts, amp, toa)
    timeit("design_dfe",
           lambda c_, s_: dfe_mod.design_dfe(c_, s_, eng.DFE_NF)[0],
           ce, snr)


if __name__ == "__main__":
    main()
