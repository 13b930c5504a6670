"""process_block_exact ≡ per-frame rx_step scan — ZERO drift.

The batched-exact engine (models/transceiver.py) claims bit-level
semantic equality with scanning `eng.rx_step` over the window (the
reference's pullRadioVector walk, Transceiver52M/Transceiver.cpp:
268-408): same detections, same soft bits, same adaptive-threshold
trajectory, same channel/DFE adoption. These tests pin that claim on
adversarial streams — planted TSC + RACH bursts, noise-only frames
(threshold decay), energy-without-detection frames (threshold bump
walks), DFE-enabled carriers with stale/invalid channel state forcing
mid-window adoption — across consecutive blocks so state threading is
exercised, not just one window.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from openbts_ttsou_tpu.models.transceiver import (
    UplinkSpec,
    process_block_exact,
)
from openbts_ttsou_tpu.ops import gmsk
from openbts_ttsou_tpu.parallel.sharded import _slot_windows
from openbts_ttsou_tpu.trx import engine as eng
from openbts_ttsou_tpu.utils import constants as C
from openbts_ttsou_tpu.utils.gsm_time import FRAME_SYMBOLS

SPEC = UplinkSpec()
F = SPEC.frames


def scan_reference(cfg, state, sym):
    """The ground truth: rx_step scanned frame by frame."""
    wins = _slot_windows(jnp.asarray(sym), F)
    return jax.lax.scan(lambda st, fr: eng.rx_step(cfg, st, fr),
                        state, wins)


def make_stream(rng, c, tsc=2, amp=9000.0, rach_frames=(), tsc_rate=0.7,
                energy_noise_frames=(), noise=20.0):
    """[C, F·1250] symbol stream with planted bursts.

    tsc_rate: probability a (frame, chan, slot) carries a real TSC
    burst; rach_frames: frames whose slot 0 carries a RACH burst;
    energy_noise_frames: frames flooded with high-power noise (energy
    without detection → threshold bump walk)."""
    sym = (rng.standard_normal((c, F * FRAME_SYMBOLS, 2)) * noise
           ).astype(np.float32).view(np.complex64)[..., 0]
    offs = np.concatenate([[0], np.cumsum([157, 156, 156, 156] * 2)])[:8]
    for f in range(F):
        for ch in range(c):
            for tn in range(8):
                start = f * FRAME_SYMBOLS + offs[tn]
                if f in rach_frames and tn == 0:
                    bits = np.zeros(148, np.uint8)
                    bits[:8] = [0, 1, 0, 1, 0, 1, 0, 1]
                    bits[8:49] = C.RACH_SYNCH_SEQUENCE
                    bits[49:85] = rng.integers(0, 2, 36)
                    w = amp * gmsk.modulate_burst_np(bits[None], 1,
                                                     guard_len=9)[0]
                    end = min(start + len(w), sym.shape[1])
                    sym[ch, start:end] += w[: end - start]
                elif rng.random() < tsc_rate:
                    bits = rng.integers(0, 2, 148).astype(np.uint8)
                    bits[61:87] = C.TRAINING_SEQUENCE[tsc]
                    w = amp * gmsk.modulate_burst_np(bits[None], 1,
                                                     guard_len=9)[0]
                    end = min(start + len(w), sym.shape[1])
                    sym[ch, start:end] += w[: end - start]
                elif f in energy_noise_frames:
                    sym[ch, start: start + 157] += (
                        rng.standard_normal((157, 2)) * amp * 0.5
                    ).astype(np.float32).view(np.complex64)[..., 0]
    return sym


def assert_equal_results(ra, rb, atol=2e-4):
    np.testing.assert_array_equal(np.asarray(ra.detected),
                                  np.asarray(rb.detected))
    np.testing.assert_array_equal(np.asarray(ra.is_rach),
                                  np.asarray(rb.is_rach))
    np.testing.assert_array_equal(np.asarray(ra.rssi),
                                  np.asarray(rb.rssi))
    np.testing.assert_array_equal(np.asarray(ra.timing),
                                  np.asarray(rb.timing))
    np.testing.assert_allclose(np.asarray(ra.soft_bits),
                               np.asarray(rb.soft_bits), atol=atol)


def assert_equal_states(sa, sb, atol=2e-4):
    for name in sa._fields:
        a, b = np.asarray(getattr(sa, name)), np.asarray(getattr(sb, name))
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            # rtol at float32-ulp scale: the batched engine computes
            # the candidates in batched kernels, the scan per frame —
            # same math, last-ulp rounding
            np.testing.assert_allclose(a, b, atol=atol, rtol=5e-6,
                                       err_msg=name)


def drive_both(cfg, state0, streams):
    """Run both engines over consecutive blocks from the same state."""
    sa = sb = state0
    for sym in streams:
        d = jnp.asarray(sym)
        sa, ra = scan_reference(cfg, sa, d)
        sb, rb = process_block_exact(cfg, F, sb, d)
        assert_equal_results(ra, rb)
        assert_equal_states(sa, sb)
    return sa, sb


def _base_state(cfg, combo=eng.ChanType.I, tsc=2, max_delay=0):
    st = eng.init_state(cfg)
    c = cfg.n_chan
    return st._replace(
        chan_type=jnp.full((c, 8), combo, jnp.int32),
        tsc=jnp.full((c,), tsc, jnp.int32),
        max_expected_delay=jnp.full((c,), max_delay, jnp.int32),
    )


def test_exact_block_tsc_only():
    """Pure TCH traffic: detections, thresholds, soft bits identical."""
    cfg = eng.TrxConfig(n_chan=2)
    rng = np.random.default_rng(7)
    st = _base_state(cfg)
    streams = [make_stream(rng, 2) for _ in range(3)]
    drive_both(cfg, st, streams)


def test_exact_block_rach_and_mixed_combos():
    """Combination V beacon (RACH windows) + II + VII idle phases."""
    cfg = eng.TrxConfig(n_chan=2, rach_slots=(0,))
    rng = np.random.default_rng(11)
    st = _base_state(cfg)
    combos = np.full((2, 8), eng.ChanType.I, np.int32)
    combos[:, 0] = eng.ChanType.V
    combos[:, 1] = eng.ChanType.II
    combos[:, 7] = eng.ChanType.VII
    st = st._replace(chan_type=jnp.asarray(combos))
    streams = [make_stream(rng, 2, rach_frames=(1, 5, 9))
               for _ in range(3)]
    drive_both(cfg, st, streams)


def test_exact_block_threshold_walk_adversarial():
    """Noise-only frames (50-frame quiet decay), high-energy
    undetectable frames (miss bumps with exp decay), and detection
    streaks (hit decrements) — the sequential walk's three arms."""
    cfg = eng.TrxConfig(n_chan=2)
    rng = np.random.default_rng(13)
    st = _base_state(cfg)
    # start with an elevated threshold and an old false-detect stamp so
    # the quiet-decay arm (Δ > 50) fires immediately
    st = st._replace(
        energy_threshold=jnp.full((2,), 900.0, jnp.float32),
        prev_false_detect_fn=jnp.full((2,), -60, jnp.int32),
        fn=jnp.int32(0))
    streams = [
        make_stream(rng, 2, tsc_rate=0.0, noise=5.0),  # silence
        make_stream(rng, 2, tsc_rate=0.0,
                    energy_noise_frames=(0, 1, 2, 6),
                    noise=5.0),  # energy, no detect → bumps
        make_stream(rng, 2, tsc_rate=0.9),  # detection streak
    ]
    drive_both(cfg, st, streams)


def test_exact_block_dfe_adoption():
    """DFE-enabled carriers (SETMAXDELAY > 1): stale/invalid channel
    state forces mid-window adoption; equalizer weights must switch at
    the same frame in both engines, and a validity clear (energy burst
    the correlator rejects) must re-trigger adoption identically."""
    cfg = eng.TrxConfig(n_chan=2, max_toa=8)
    rng = np.random.default_rng(17)
    st = _base_state(cfg, max_delay=4)
    # invalid at entry → the first successful TSC frame adopts
    streams = [make_stream(rng, 2, tsc_rate=0.8) for _ in range(2)]
    # then a mid-stream clear: undetectable energy on all slots
    streams.append(make_stream(rng, 2, tsc_rate=0.4,
                               energy_noise_frames=(2, 3)))
    streams.append(make_stream(rng, 2, tsc_rate=0.8))
    drive_both(cfg, st, streams)


def test_exact_block_aged_estimate_readoption():
    """A valid but >50-frame-old estimate must re-adopt at the first
    successful TSC frame of the window in both engines."""
    cfg = eng.TrxConfig(n_chan=1, max_toa=8)
    rng = np.random.default_rng(23)
    st = _base_state(cfg, max_delay=4)
    sa, sb = drive_both(cfg, st, [make_stream(rng, 1, tsc_rate=0.9)])
    # age the estimate past the 50-frame refresh horizon
    aged = sa._replace(fn=sa.fn + 60)
    agedb = sb._replace(fn=sb.fn + 60)
    assert_equal_states(aged, agedb)
    drive_both(cfg, aged, [make_stream(rng, 1, tsc_rate=0.9)
                           for _ in range(2)])


def test_exact_block_max_toa_window():
    """The 52M windowed correlation geometry (static max_toa) under
    both engines, with per-carrier SETMAXDELAY acceptance."""
    cfg = eng.TrxConfig(n_chan=2, max_toa=6)
    rng = np.random.default_rng(29)
    st = _base_state(cfg)
    st = st._replace(max_expected_delay=jnp.asarray([0, 1], jnp.int32))
    drive_both(cfg, st, [make_stream(rng, 2) for _ in range(2)])
