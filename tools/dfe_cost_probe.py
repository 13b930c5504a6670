#!/usr/bin/env python
"""Measure what the gated DFE equalizer scan costs the whole batch.

The question: does one channel with SETMAXDELAY>1 tax the entire
C-carrier batch, because `rx_step` runs the 157-step
`equalize_burst` scan (gated by `lax.cond`, engine.py:312-326) over all
C*8 bursts whenever ANY channel needs it.  This probe times the exact
per-frame engine block (`uplink_block`, the live daemon's path) with
the DFE off (max_expected_delay=1 everywhere) and fully on
(SETMAXDELAY>1 on every channel, valid channel estimates) at several
carrier counts, so the tax is a measured number rather than a guess.

The scan has 157 sequential, tiny steps; if it is latency-dominated,
the cost is a roughly batch-size-independent addition per frame — and
masking the scan per-channel would buy ~nothing.

Timing follows bench.py's two-length trick: one fused program scans the
block k and 2k times; the difference cancels all fixed dispatch/fetch
costs.

Usage: python tools/dfe_cost_probe.py [n_chan ...]
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

    from openbts_ttsou_tpu.models.transceiver import UplinkSpec, uplink_block
    from openbts_ttsou_tpu.trx import TrxConfig
    from openbts_ttsou_tpu.trx import engine as eng
    from openbts_ttsou_tpu.utils import constants as C

    chans = [int(a) for a in sys.argv[1:]] or [128, 512, 1024]
    spec = UplinkSpec()
    rng = np.random.default_rng(0)

    def make_fused(length):
        @jax.jit
        def fused(state, samples):
            def body(st, _):
                st, res = uplink_block(
                    TrxConfig(n_chan=samples.shape[0]), spec, st, samples)
                return st, jnp.sum(res.soft_bits[..., 0])
            st, probes = lax.scan(body, state, None, length=length)
            return jnp.sum(probes)
        return fused

    k = 2
    f1, f2 = make_fused(k), make_fused(2 * k)

    print(f"# device={jax.devices()[0].device_kind}, per-frame ms over "
          f"{spec.frames}-frame blocks, two-length timing (k={k})",
          flush=True)
    print("| n_chan | dfe off ms/frame | dfe on ms/frame | tax ms/frame |",
          flush=True)
    print("|---|---|---|---|", flush=True)
    for c in chans:
        cfg = TrxConfig(n_chan=c)
        # all-TCH slots so every frame expects a TSC burst — otherwise
        # use_dfe is never true and the equalizer cond never fires
        chan_type = np.full((c, 8), int(eng.ChanType.I), np.int32)
        samples = (rng.standard_normal((c, spec.block_in)) * 100.0
                   + 1j * rng.standard_normal((c, spec.block_in)) * 100.0
                   ).astype(np.complex64)
        # The "on" measurement needs use_dfe to hold for the whole
        # block, which requires chan_valid to survive: a failed TSC
        # detection only clears it when the ENERGY gate fired
        # (engine.py chan_valid update), so the noise power must stay
        # under the initial threshold² or the probe silently measures
        # the dfe-off path while claiming "on".
        noise_pwr = float(np.mean(np.abs(samples) ** 2))
        assert noise_pwr < 0.5 * C.INITIAL_ENERGY_THRESHOLD ** 2, (
            f"noise power {noise_pwr:.0f} too close to the energy "
            f"gate {C.INITIAL_ENERGY_THRESHOLD ** 2:.0f}; the DFE-on "
            "leg would lose chan_valid mid-block")
        dev = jax.device_put(samples)
        ms = {}
        for mode in ("off", "on"):
            st = eng.init_state(cfg)._replace(
                chan_type=jnp.asarray(chan_type))
            if mode == "on":
                st = st._replace(
                    max_expected_delay=jnp.full((c,), 4, jnp.int32),
                    chan_valid=jnp.ones((c, 8), bool),
                )
            for fn in (f1, f2):  # compile+warm both lengths
                jax.block_until_ready(fn(st, dev))
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                jax.block_until_ready(f1(st, dev))
                t1 = time.perf_counter()
                jax.block_until_ready(f2(st, dev))
                t2 = time.perf_counter()
                best = min(best, (t2 - t1) - (t1 - t0))
            ms[mode] = best / (k * spec.frames) * 1e3
        print(f"| {c} | {ms['off']:.3f} | {ms['on']:.3f} "
              f"| {ms['on'] - ms['off']:+.3f} |", flush=True)


if __name__ == "__main__":
    main()
