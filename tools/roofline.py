#!/usr/bin/env python
"""Roofline placement of the uplink block program on the GPU.

Uses XLA's own compiled-program cost model (`compiled.cost_analysis()`:
FLOPs and bytes accessed, the compiler's accounting) for the uplink
block at each carrier count, times the compiled block on the device,
and places each configuration against the card's float32 compute and
HBM-bandwidth ceilings from `PEAKS`.

Caveats on reading the numbers:
- "bytes accessed" is the pre-fusion logical count — an upper bound on
  HBM traffic (fusion keeps intermediates on-chip).
- XLA counts a lax.scan body ONCE, not per trip: the threshold-walk
  scan of `process_block_exact` is counted for one frame.

    python tools/roofline.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: Published peaks per `device_kind`: dense float32 outside the tensor
#: cores (every contraction on this path asks for Precision.HIGHEST,
#: which keeps float32 off TF32) and HBM bandwidth. Source: NVIDIA H100
#: Tensor Core GPU data sheet, SXM5 column (at its 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes": 3.35e12,
                              "source": "NVIDIA H100 data sheet, SXM5"},
}


def main():
    import numpy as np

    import jax
    import jax.numpy as jnp

    from openbts_ttsou_tpu.models.transceiver import (UplinkSpec,
                                                      uplink_block)
    from openbts_ttsou_tpu.trx import ChanType, TrxConfig, init_state
    from openbts_ttsou_tpu.utils.compile_cache import enable_compile_cache

    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise SystemExit(f"no published peaks for device_kind {kind!r}")
    peak = PEAKS[kind]
    enable_compile_cache()

    max_toa = int(os.environ.get("BENCH_MAX_TOA", "0")) or None
    spec = UplinkSpec(frames=13)
    rows = []
    for n_chan in (128, 512, 1024):
        cfg = TrxConfig(n_chan=n_chan, max_toa=max_toa)
        chan_type = np.zeros((n_chan, 8), np.int32)
        chan_type[:, 1:] = ChanType.I
        chan_type[:, 0] = ChanType.IV
        state = init_state(cfg)._replace(
            chan_type=jnp.asarray(chan_type))
        rng = np.random.default_rng(0)
        dev = jax.device_put(
            (rng.standard_normal((n_chan, spec.block_in))
             + 1j * rng.standard_normal((n_chan, spec.block_in))
             ).astype(np.complex64) * 50)

        compiled = uplink_block.lower(cfg, spec, state, dev).compile()
        cost = compiled.cost_analysis()
        if isinstance(cost, list):  # older jax returns [dict]
            cost = cost[0]
        flops = float(cost.get("flops", 0.0))
        byts = float(cost.get("bytes accessed", 0.0))

        jax.block_until_ready(compiled(state, dev))
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            out = compiled(state, dev)
        jax.block_until_ready(out)
        t_block = (time.perf_counter() - t0) / reps
        t_min = max(flops / peak["f32_flops"], byts / peak["hbm_bytes"])
        rows.append({
            "carriers": n_chan,
            "max_toa": max_toa,
            "gflop_per_block": flops / 1e9,
            "mb_per_block": byts / 1e6,
            "flop_per_byte": flops / byts,
            "ms_per_block": t_block * 1e3,
            "roofline_share": t_min / t_block,
            "bound": ("compute" if flops / peak["f32_flops"]
                      > byts / peak["hbm_bytes"] else "memory"),
        })
        print(json.dumps(rows[-1]), flush=True)

    print(json.dumps({"device_kind": kind, "peaks": peak, "rows": rows}))


if __name__ == "__main__":
    main()
