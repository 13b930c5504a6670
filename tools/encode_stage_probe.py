#!/usr/bin/env python
"""Per-stage timing of the duplex_decoded legs on the GPU.

Times each sub-program of the fully-resident duplex as a fused scan
(same hoisting-proofed pattern as stage_bench): the FEC encode leg
(xcch_encode over the [4, C, 8] group grid, tch_tx_window, combined
_encode_dl_window), the radio tx leg, the exact rx, rx+decode, and
the whole duplex_block_decoded.

DCE trap: a probe that sums only `blocks.ok` lets XLA dead-code-
eliminate the TCH/FACCH/RACH decoders entirely, so the later stages
here sum every output field they want timed.

    python tools/encode_stage_probe.py --carriers 1024
"""

import argparse
import json
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--carriers", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args()

    import numpy as np

    import jax
    import jax.lax as lax
    import jax.numpy as jnp

    from openbts_ttsou_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from openbts_ttsou_tpu.gsm import l1fec
    from openbts_ttsou_tpu.models import transceiver as M
    from openbts_ttsou_tpu.trx import TrxConfig, init_state

    c = args.carriers
    f = 13
    iters = args.iters
    cfg = TrxConfig(n_chan=c)
    spec = M.UplinkSpec(frames=f)
    state = init_state(cfg)
    rng = np.random.default_rng(0)

    put = jax.device_put
    frames184 = put(rng.integers(0, 2, (4, c, 8, 184)).astype(np.uint8))
    xcch_valid = put(np.ones((4, c, 8), bool))
    gt = 3
    speech = put(rng.integers(0, 2, (gt, c, 8, 260)).astype(np.uint8))
    sp_valid = put(np.ones((gt, c, 8), bool))
    facch = put(np.zeros((gt, c, 8, 184), np.uint8))
    fa_valid = put(np.zeros((gt, c, 8), bool))
    tm = np.zeros((c, 8), bool)
    tm[:, 4:] = True
    tch_mask = put(tm)
    tch_carry = jax.jit(lambda: l1fec.TchTxCarry.zeros(c * 8))()
    xcch_carry = jax.jit(lambda: M.XcchTxCarry.zeros(c))()
    atten = put(np.zeros((f, c, 8), np.float32))
    bits_plain = put(rng.integers(0, 2, (f, c, 8, 148)).astype(np.uint8))
    valid_plain = put(np.ones((f, c, 8), bool))

    from openbts_ttsou_tpu.trx import engine as eng
    from openbts_ttsou_tpu.ops import fir

    # `state` is passed as a jit ARGUMENT everywhere rather than baked
    # into each program as a constant.
    def timed(name, mk_step, x0):
        """mk_step(st, x) -> (x', probe); scan it iters times fused."""

        @jax.jit
        def run(st, x0):
            def body(x, _):
                x2, p = mk_step(st, x)
                return x2, p

            xf, ps = lax.scan(body, x0, None, length=iters)
            return jnp.sum(ps)

        jax.block_until_ready(run(state, x0))  # warm
        t0 = time.perf_counter()
        jax.block_until_ready(run(state, x0))
        dt = time.perf_counter() - t0
        ms_frame = dt / iters / f * 1000
        print(f"[probe] {name:34s} {dt*1000/iters:8.2f} ms/window "
              f"{ms_frame:7.3f} ms/frame", file=sys.stderr, flush=True)
        return ms_frame

    res = {}

    # 1. XCCH encode alone over the [4, C, 8] grid
    def s_xcch(st, x):
        out = l1fec.xcch_encode(x, tsc=None)
        x2 = (x + jnp.sum(out).astype(jnp.uint8)) % 2
        return x2, jnp.sum(out.astype(jnp.int32))

    res["xcch_encode_4xCx8"] = timed("xcch_encode [4,C,8,184]", s_xcch,
                                     frames184)

    # 2. TCH window encode alone
    def s_tch(st, x):
        sp, carry = x
        tb, isb, hu, carry2 = l1fec.tch_tx_window(
            sp.reshape(gt, c * 8, 260), sp_valid.reshape(gt, c * 8),
            facch.reshape(gt, c * 8, 184), fa_valid.reshape(gt, c * 8),
            carry, jnp.asarray(0, jnp.int32), f)
        sp2 = (sp + jnp.sum(tb).astype(jnp.uint8)) % 2
        return (sp2, carry2), jnp.sum(tb.astype(jnp.int32))

    res["tch_tx_window"] = timed("tch_tx_window", s_tch,
                                 (speech, tch_carry))

    # 3. full _encode_dl_window (both legs + mask combine)
    def s_enc(st, x):
        fr, tc, xc = x
        bits, valid, tc2, xc2 = M._encode_dl_window(
            cfg, spec, st, fr, xcch_valid, speech, sp_valid, facch,
            fa_valid, tch_mask, tc, jnp.asarray(0, jnp.int32),
            xcch_phase=0, xcch_carry=xc)
        fr2 = (fr + jnp.sum(bits).astype(jnp.uint8)) % 2
        return (fr2, tc2, xc2), jnp.sum(bits.astype(jnp.int32))

    res["encode_dl_window"] = timed("_encode_dl_window (full)", s_enc,
                                    (frames184, tch_carry, xcch_carry))

    # 4. radio tx leg alone (modulate + assemble + resample)
    lpf_tx = fir.resampler_lpf(spec.q, spec.p, 651)
    tail0 = jax.jit(
        lambda: jnp.zeros((c, M.TX_TAIL_SYM * 1), jnp.complex64))()

    def s_radio(st, x):
        b, tail = x
        slots = eng.tx_frames(cfg, st, b, valid_plain, atten)
        sym = M._assemble_stream(slots)
        stream = jnp.concatenate([tail.astype(sym.dtype), sym], axis=-1)
        y = fir.polyphase_resample(stream, spec.q, spec.p, lpf_tx)
        b2 = (b + jnp.sum(jnp.abs(y)).astype(jnp.uint8)) % 2
        return (b2, sym[..., -M.TX_TAIL_SYM:]), jnp.sum(jnp.abs(y))

    res["radio_tx_leg"] = timed("tx_frames+assemble+resample", s_radio,
                                (bits_plain, tail0))

    # 5. uplink exact rx alone, 6. rx + streaming decode, 7. the whole
    # fully-resident duplex program — to localize the fusion loss
    ul_halo = put((rng.standard_normal((c, M.RX_HALO_DEV + spec.block_in))
                   .astype(np.float32)))
    prev_soft = jax.jit(lambda: jnp.full(
        (M.DECODE_PRELUDE, c, 8, 148), 0.5, jnp.float32))()
    prev_valid = jax.jit(lambda: jnp.asarray(False))()

    from openbts_ttsou_tpu.parallel.halo import resample_block

    lpf_rx = fir.resampler_lpf(spec.p, spec.q, spec.taps)

    def s_rx(st, x):
        h = x
        sym_ul = resample_block(h.astype(jnp.complex64), spec.p, spec.q,
                                lpf_rx, M.RX_HALO_DEV, spec.block_in)
        st2, resx = M.process_block_exact(cfg, f, st, sym_ul[..., :spec.block_symbols])
        h2 = h + jnp.sum(resx.soft_bits[..., 0]) * 1e-9
        return h2, jnp.sum(resx.timing)

    res["uplink_exact_rx"] = timed("resample+exact rx", s_rx, ul_halo)

    def s_rxdec(st, x):
        h = x
        sym_ul = resample_block(h.astype(jnp.complex64), spec.p, spec.q,
                                lpf_rx, M.RX_HALO_DEV, spec.block_in)
        st2, resx = M.process_block_exact(cfg, f, st, sym_ul[..., :spec.block_symbols])
        blocks = M.decode_block(resx, jnp.asarray(0, jnp.int32), f, 0,
                                prev_soft=prev_soft, prev_valid=prev_valid)
        h2 = h + jnp.sum(resx.soft_bits[..., 0]) * 1e-9
        return h2, (jnp.sum(blocks.ok.astype(jnp.int32))
                + jnp.sum(blocks.bits.astype(jnp.int32))
                + jnp.sum(blocks.tch_speech.astype(jnp.int32))
                + jnp.sum(blocks.facch_ok.astype(jnp.int32))
                + jnp.sum(blocks.rach_ra))

    res["uplink_rx_plus_decode"] = timed("rx + decode_block", s_rxdec,
                                         ul_halo)

    dl_content = (frames184, xcch_valid, speech, sp_valid, facch,
                  fa_valid, tch_mask)

    def s_full(st, x):
        h, tail, tc, xc, ps, pv = x
        st2, tx, tail2, blocks, carry2, ps2, pv2 = \
            M.duplex_block_decoded(
                cfg, spec, st, h.astype(jnp.complex64), tail, dl_content,
                atten, (tc, xc), jnp.asarray(0, jnp.int32), ps, pv,
                0, 0)
        h2 = h + jnp.sum(jnp.abs(tx[:, :1])) * 1e-9
        return ((h2, tail2, carry2[0], carry2[1], ps2,
                 jnp.asarray(True)),
                (jnp.sum(blocks.ok.astype(jnp.int32))
                + jnp.sum(blocks.bits.astype(jnp.int32))
                + jnp.sum(blocks.tch_speech.astype(jnp.int32))
                + jnp.sum(blocks.facch_ok.astype(jnp.int32))
                + jnp.sum(blocks.rach_ra)))

    res["duplex_decoded_full"] = timed(
        "duplex_block_decoded (full)", s_full,
        (ul_halo, tail0, tch_carry, xcch_carry, prev_soft, prev_valid))

    # 8. the same program with the static slot split (4 XCCH + 4 TCH
    # TNs)
    def s_full_split(st, x):
        h, tail, tc, xc, ps, pv = x
        st2, tx, tail2, blocks, carry2, ps2, pv2 = \
            M.duplex_block_decoded(
                cfg, spec, st, h.astype(jnp.complex64), tail, dl_content,
                atten, (tc, xc), jnp.asarray(0, jnp.int32), ps, pv,
                0, 0, (0, 1, 6, 7), (2, 3, 4, 5))
        h2 = h + jnp.sum(jnp.abs(tx[:, :1])) * 1e-9
        return ((h2, tail2, carry2[0], carry2[1], ps2,
                 jnp.asarray(True)),
                (jnp.sum(blocks.ok.astype(jnp.int32))
                + jnp.sum(blocks.bits.astype(jnp.int32))
                + jnp.sum(blocks.tch_speech.astype(jnp.int32))
                + jnp.sum(blocks.facch_ok.astype(jnp.int32))
                + jnp.sum(blocks.rach_ra)))

    res["duplex_decoded_full_split"] = timed(
        "duplex_block_decoded (slot split)", s_full_split,
        (ul_halo, tail0, tch_carry, xcch_carry, prev_soft, prev_valid))

    print(json.dumps({"carriers": c, "iters": iters,
                      "ms_per_frame": res}))


if __name__ == "__main__":
    main()
