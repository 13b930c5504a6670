"""Batched GSM layer-0 engine: burst clock, detection dispatch, mod/demod.

Reference behavior: `Transceiver52M/Transceiver.{h,cpp}` —
`expectedCorrType` (Transceiver.cpp:207-266), `pullRadioVector`
(:268-408, the uplink hot path), `addRadioVector`/`pushRadioVector`
(:103-181, downlink with filler-table fallback), adaptive energy
threshold (:91,294-303,336-375), per-timeslot channel state and 50-frame
DFE re-estimation (:311-348), RSSI/TOA reporting (:396-399).

Design notes
------------
* One `rx_step` call processes a whole GSM frame for every channel at
  once: `[chan, slot, samples]`, flattened to `[chan·slot]` bursts for
  the batched detectors. TSC and RACH correlators both run densely and
  the per-slot expected burst type selects between them — the dense
  compute is cheaper than divergent control flow, and slots of a frame
  are the batch, not a loop.
* The reference mutates one scalar energy threshold per transceiver as
  it walks the 8 slots; here the 8 slots' contributions are applied in
  slot order as a compile-time-unrolled fold so the semantics match.
* All state lives in an explicit `TrxState` NamedTuple (a pytree), so
  the whole engine is `jit`/`shard_map`-compatible and the stream can be
  checkpointed by saving one pytree (SURVEY.md §5 checkpoint note).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from openbts_ttsou_tpu.ops import correlate as xcorr
from openbts_ttsou_tpu.ops import dfe as dfe_mod
from openbts_ttsou_tpu.ops import gmsk
from openbts_ttsou_tpu.utils import constants as C
from openbts_ttsou_tpu.utils.gsm_time import (HYPERFRAME,
    SLOT_SAMPLE_PATTERN, fn_delta)

Array = jax.Array

SLOT_SAMPLES = 157  # uniform per-slot sample window (1 sps), masked per TN
CHAN_TAPS = 6  # channel estimate length in symbols (sigProcLib.cpp:1009)
DFE_NF = 7  # feedforward taps (Transceiver.cpp:345)


class ChanType:
    """Channel combinations (Transceiver.h:79-88)."""

    NONE = 0
    I = 1
    II = 2
    III = 3
    IV = 4
    V = 5
    VI = 6
    VII = 7
    LOOPBACK = 8


class CorrType:
    """Expected burst type (Transceiver.h:91-96)."""

    OFF = 0
    IDLE = 1
    RACH = 2
    TSC = 3


class TrxConfig(NamedTuple):
    """Static engine configuration (hashable; jit-static)."""

    n_chan: int = 1  # number of ARFCN carriers
    sps: int = 1  # samples per symbol
    rach_threshold: float = C.RACH_DETECT_THRESHOLD
    tsc_threshold: float = C.TSC_DETECT_THRESHOLD
    tx_full_scale: float = C.TX_FULL_SCALE
    rssi_full_scale: float = C.RSSI_FULL_SCALE
    #: static TSC correlation window: restrict the midamble search to
    #: 2·max_toa+1 lags (the 52M CUSTOM-span correlation,
    #: Transceiver52M/sigProcLib.cpp:983-1000). None = the 64M
    #: full-segment geometry. Per-carrier SETMAXDELAY values below this
    #: window still apply dynamically via state.max_expected_delay.
    max_toa: int | None = None
    #: static tuple of timeslot indices that can carry RACH (the union
    #: over carriers of slots whose channel combination is IV/V/VI —
    #: per-slot corrType dispatch, Transceiver.cpp:207-266). The
    #: full-burst 41-symbol RACH correlator — the chain's most
    #: expensive — then runs only on those slots. None = all 8 (always
    #: correct); a slot outside the tuple never detects RACH.
    rach_slots: tuple | None = None


class TrxState(NamedTuple):
    """Per-[chan] and per-[chan, slot] functional state
    (Transceiver.h:110-140)."""

    fn: Array  # [] int32 — current frame number
    chan_type: Array  # [C, 8] int32 (ChanType)
    tsc: Array  # [C] int32 — training sequence code (mTSC)
    max_expected_delay: Array  # [C] int32 (mMaxExpectedDelay)
    energy_threshold: Array  # [C] f32 (mEnergyThreshold)
    prev_false_detect_fn: Array  # [C] i32 (prevFalseDetectionTime)
    chan_valid: Array  # [C, 8] bool — channelResponse[ts] != NULL
    chan_response: Array  # [C, 8, CHAN_TAPS·sps] c64
    chan_resp_offset: Array  # [C, 8] f32
    chan_amplitude: Array  # [C, 8] c64
    snr: Array  # [C, 8] f32 (SNRestimate)
    dfe_forward: Array  # [C, 8, DFE_NF] c64
    dfe_feedback: Array  # [C, 8, CHAN_TAPS·sps − 1] c64
    chan_estimate_fn: Array  # [C, 8] i32 (channelEstimateTime)
    filler: Array  # [C, 8, SLOT_SAMPLES·sps] c64 — filler burst per slot


class RxResult(NamedTuple):
    """Per-frame receive output (all [C, 8] + soft bits [C, 8, 148])."""

    detected: Array  # bool — burst present and correlator fired
    is_rach: Array  # bool — detection was a RACH (else TSC)
    soft_bits: Array  # f32 [C, 8, 148] in [0, 1]
    rssi: Array  # i32 — round(20·log10(fullScale/|amp|)) (cpp:397)
    timing: Array  # i32 — TOA in 1/256 symbol (cpp:399)


def init_state(cfg: TrxConfig) -> TrxState:
    """Fresh engine state with dummy-burst filler table
    (Transceiver.cpp:69-93)."""
    c = cfg.n_chan
    sps = cfg.sps
    nw = CHAN_TAPS * sps
    dummy = np.zeros((8, SLOT_SAMPLES * sps), np.complex64)
    for tn in range(8):
        guard = 8 + (1 if tn % 4 == 0 else 0)
        mod = gmsk.modulate_burst_np(C.DUMMY_BURST[None], sps,
                                     guard_len=guard)[0]
        dummy[tn, : len(mod)] = mod * cfg.tx_full_scale
    return jax.device_put(TrxState(
        fn=np.int32(0),
        chan_type=np.zeros((c, 8), np.int32),
        tsc=np.zeros((c,), np.int32),
        max_expected_delay=np.zeros((c,), np.int32),
        energy_threshold=np.full((c,), C.INITIAL_ENERGY_THRESHOLD,
                                 np.float32),
        prev_false_detect_fn=np.zeros((c,), np.int32),
        chan_valid=np.zeros((c, 8), bool),
        chan_response=np.zeros((c, 8, nw), np.complex64),
        chan_resp_offset=np.zeros((c, 8), np.float32),
        chan_amplitude=np.ones((c, 8), np.complex64),
        snr=np.ones((c, 8), np.float32),
        dfe_forward=np.zeros((c, 8, DFE_NF), np.complex64),
        # the DFE is symbol-rate (equalizeBurst "Assumes symbol-rate
        # sampling"), so the feedback span is CHAN_TAPS − 1 regardless
        # of sps — the design input is the decimated channel estimate
        dfe_feedback=np.zeros((c, 8, CHAN_TAPS - 1), np.complex64),
        chan_estimate_fn=np.zeros((c, 8), np.int32),
        filler=np.broadcast_to(dummy, (c, 8, SLOT_SAMPLES * sps)).copy(),
    ))


def expected_corr_type(chan_type: Array, fn: Array) -> Array:
    """Vectorized expectedCorrType (Transceiver.cpp:207-266).

    chan_type: [C, 8] int32; fn: [] int32. Returns [C, 8] CorrType.
    """
    m2 = fn % 2
    m26 = fn % 26
    m51 = fn % 51
    del m26  # combination I ignores the mod-26 idle slot (cpp:214-218)

    def full(v):
        return jnp.full_like(chan_type, v)

    tsc, idle, rach, off = (full(CorrType.TSC), full(CorrType.IDLE),
                            full(CorrType.RACH), full(CorrType.OFF))
    v_is_rach = ((m51 <= 36) & (m51 >= 14)) | (m51 == 4) | (m51 == 5) | \
        (m51 == 45) | (m51 == 46)
    return jnp.select(
        [
            chan_type == ChanType.NONE,
            chan_type == ChanType.I,
            chan_type == ChanType.II,
            chan_type == ChanType.III,
            (chan_type == ChanType.IV) | (chan_type == ChanType.VI),
            chan_type == ChanType.V,
            chan_type == ChanType.VII,
            chan_type == ChanType.LOOPBACK,
        ],
        [
            off,
            tsc,
            jnp.where(m2 == 1, idle, tsc),
            tsc,
            rach,
            jnp.where(v_is_rach, rach, tsc),
            jnp.where((m51 <= 14) & (m51 >= 12), idle, tsc),
            jnp.where((m51 <= 50) & (m51 >= 48), idle, tsc),
        ],
        off,
    )


def _flat(x):
    return x.reshape((-1,) + x.shape[2:])


def _detect_rach_slots(frame3: Array, sps: int, threshold: float,
                       rach_slots) -> xcorr.Detection:
    """detect_rach over every (row, slot) burst of frame3 [N, 8, T], or
    — when `rach_slots` restricts it — only over the RACH-capable
    slots, with the results scattered back to the dense [N·8] layout.

    The full-burst 41-symbol RACH correlation + its 51-offset valley is
    the chain's most expensive correlator, and the memory-bound
    pipeline feels every byte of it; a typical config carries RACH on
    one slot (the C-IV beacon), so the static restriction removes 7/8
    of that traffic. Slots outside the tuple report no-detection (the
    reference's per-slot corrType dispatch never runs the RACH
    correlator there either, Transceiver.cpp:358-364)."""
    m = frame3.shape[0]
    if rach_slots is None:
        return xcorr.detect_rach(frame3.reshape(m * 8, -1), sps,
                                 threshold=threshold)
    ks = sorted({int(t) for t in rach_slots})
    n = m * 8
    if not ks:
        z = jnp.zeros((n,), jnp.float32)
        return xcorr.Detection(jnp.zeros((n,), bool),
                               jnp.zeros((n,), jnp.complex64), z, z)
    sub = jnp.concatenate([frame3[:, t: t + 1, :] for t in ks], axis=1)
    d = xcorr.detect_rach(sub.reshape(m * len(ks), -1), sps,
                          threshold=threshold)

    def expand(x, fill):
        full = jnp.full((m, 8), fill, x.dtype)
        xs = x.reshape(m, len(ks))
        for i, t in enumerate(ks):
            full = full.at[:, t].set(xs[:, i])
        return full.reshape(-1)

    return xcorr.Detection(
        expand(d.detected, False),
        expand(d.amplitude, 0),
        expand(d.toa, 0.0),
        expand(d.peak_to_mean, 0.0))


@functools.partial(jax.jit, static_argnums=(0,))
def rx_step(cfg: TrxConfig, state: TrxState, frame: Array
            ) -> tuple[TrxState, RxResult]:
    """Process one uplink frame for all channels.

    frame: [C, 8, SLOT_SAMPLES·sps] complex64 — per-slot sample windows.
    Implements pullRadioVector (Transceiver.cpp:268-408) densely over
    the [chan, slot] batch.
    """
    c, sps = cfg.n_chan, cfg.sps
    fn = state.fn
    bursts = _flat(frame)  # [C*8, T]
    n = bursts.shape[0]

    corr_type = expected_corr_type(state.chan_type, fn)  # [C,8]
    active = (corr_type == CorrType.TSC) | (corr_type == CorrType.RACH)
    # A RACH-typed slot outside cfg.rach_slots never runs the
    # correlator (the reference simply has no decoder installed there)
    # — treat it as inactive so real energy on it can't bump the
    # carrier's threshold as a perpetual "miss"
    if cfg.rach_slots is not None:
        allowed = np.zeros(8, bool)
        allowed[list(cfg.rach_slots)] = True
        active = active & ~((corr_type == CorrType.RACH) &
                            ~jnp.asarray(allowed)[None, :])

    # --- energy gate (cpp:292-303) ------------------------------------
    thr = jnp.repeat(state.energy_threshold, 8)  # [C*8]
    has_energy, _ = xcorr.energy_detect(bursts, 20 * sps, thr)
    has_energy = has_energy.reshape(c, 8) & active

    # --- TSC path (cpp:311-348) ---------------------------------------
    need_dfe = state.max_expected_delay > 1  # [C]
    tsc_flat = jnp.repeat(state.tsc, 8)
    # The reference estimates the channel only when a slot needs a DFE
    # re-estimate (needDFE && (>50 frames old || invalid), cpp:311-330).
    # Computing `want_est` up front lets the whole estimation tail skip
    # at runtime on the frames — usually all of them — where no slot
    # qualifies (the chain is HBM-bound; the skip is a direct win).
    frames_since_est = fn_delta(fn, state.chan_estimate_fn)  # [C,8]
    want_est = ((frames_since_est > 50) | ~state.chan_valid) & \
        need_dfe[:, None]
    det_tsc, chan_est, chan_off = xcorr.analyze_traffic_burst(
        bursts, tsc_flat, sps, threshold=cfg.tsc_threshold,
        estimate_channel=True, max_toa=cfg.max_toa,
        gate_estimation=jnp.any(want_est))

    # --- RACH path (cpp:358-375) --------------------------------------
    det_rach = _detect_rach_slots(frame, sps, cfg.rach_threshold,
                                  cfg.rach_slots)

    is_tsc = (corr_type == CorrType.TSC).reshape(-1)
    is_rach = (corr_type == CorrType.RACH).reshape(-1)
    gate = has_energy.reshape(-1)
    success = gate & jnp.where(is_tsc, det_tsc.detected,
                               jnp.where(is_rach, det_rach.detected, False))
    # RACH acceptance window: TOA must fall inside the configured
    # maximum expected delay (detectRACHBurst's maxTOA bound driven by
    # SETMAXDELAY, Transceiver.cpp pullRadioVector; 0 = unbounded)
    max_toa = (jnp.repeat(state.max_expected_delay[:, None], 8, axis=1)
               .reshape(-1).astype(jnp.float32) * cfg.sps)
    success = success & jnp.where(
        is_rach & (max_toa > 0), det_rach.toa <= max_toa, True)
    # TSC acceptance: the 52M windowed correlation physically bounds
    # |TOA| ≤ max(SETMAXDELAY, 3)·sps per carrier (Transceiver52M/
    # sigProcLib.cpp:982-990). With the static window at cfg.max_toa,
    # the per-carrier dynamic bound applies as an acceptance mask.
    tsc_bound = jnp.maximum(max_toa, 3.0 * cfg.sps)
    success = success & jnp.where(
        is_tsc, (det_tsc.toa <= tsc_bound) & (det_tsc.toa >= -tsc_bound),
        True)
    amplitude = jnp.where(is_tsc, det_tsc.amplitude, det_rach.amplitude)
    toa = jnp.where(is_tsc, det_tsc.toa, det_rach.toa)

    # --- channel state update (cpp:315-346) ---------------------------
    do_est = want_est.reshape(-1) & is_tsc & success
    # SNRestimate = |amp|²/(thr²+1) (cpp:330)
    new_snr = jnp.abs(amplitude) ** 2 / (thr * thr + 1.0)
    chan_norm = chan_est / jnp.where(amplitude == 0, 1.0, amplitude)[:, None]
    # The DFE is a symbol-rate construct: the reference's designDFE
    # G1(Nf) buffer requires ≤ Nf channel taps (sigProcLib.cpp:1253-1264
    # would overflow on a 6·sps-tap estimate at sps > 1, and
    # equalizeBurst says "Assumes symbol-rate sampling"). Decimate the
    # oversampled estimate to its 6 symbol-rate taps first.
    dfe_chan = chan_norm[..., :: cfg.sps] if cfg.sps > 1 else chan_norm
    dfe_w, dfe_b = jax.lax.cond(  # gated with the estimation tail
        jnp.any(want_est),
        lambda _: dfe_mod.design_dfe(dfe_chan,
                                     jnp.maximum(new_snr, 1e-6), DFE_NF),
        lambda _: (jnp.zeros((n, DFE_NF), jnp.complex64),
                   jnp.zeros((n, CHAN_TAPS - 1), jnp.complex64)),
        operand=None)

    def upd(old, new, mask):
        m = mask.reshape((c, 8) + (1,) * (old.ndim - 2))
        return jnp.where(m, new.reshape(old.shape), old)

    new_state = state._replace(
        chan_valid=jnp.where(do_est.reshape(c, 8), True,
                             state.chan_valid & ~((~det_tsc.detected &
                                                   is_tsc & gate)
                                                  .reshape(c, 8))),
        chan_response=upd(state.chan_response, chan_norm, do_est),
        chan_resp_offset=upd(state.chan_resp_offset, chan_off, do_est),
        chan_amplitude=upd(state.chan_amplitude, amplitude, do_est),
        snr=upd(state.snr, new_snr, do_est),
        dfe_forward=upd(state.dfe_forward, dfe_w, do_est),
        dfe_feedback=upd(state.dfe_feedback, dfe_b, do_est),
        chan_estimate_fn=upd(state.chan_estimate_fn,
                             jnp.full((n,), fn, jnp.int32), do_est),
    )

    # --- adaptive energy threshold (cpp:294-303, 331-333, 350-356,
    #     366-375), folded over the 8 slots in order -------------------
    e_thr = state.energy_threshold
    prev_false = state.prev_false_detect_fn
    gate2 = has_energy  # [C,8]
    succ2 = success.reshape(c, 8)
    act2 = active
    for tn in range(8):
        frames_elapsed = fn_delta(fn, prev_false).astype(jnp.float32)
        low_energy = act2[:, tn] & ~gate2[:, tn]
        quiet = low_energy & (frames_elapsed > 50)
        e_thr = jnp.where(quiet, e_thr - 10.0, e_thr)
        prev_false = jnp.where(quiet, fn, prev_false)
        hit = succ2[:, tn]
        e_thr = jnp.where(hit, jnp.maximum(e_thr - 1.0, 0.0), e_thr)
        miss = act2[:, tn] & gate2[:, tn] & ~succ2[:, tn]
        e_thr = jnp.where(
            miss, e_thr + 10.0 * jnp.exp(-frames_elapsed), e_thr)
        prev_false = jnp.where(miss, fn, prev_false)
    new_state = new_state._replace(energy_threshold=e_thr,
                                   prev_false_detect_fn=prev_false)

    # --- demodulation (cpp:381-395) -----------------------------------
    soft_plain = gmsk.demodulate_burst(bursts, sps, amplitude, toa)
    use_dfe = is_tsc & jnp.repeat(need_dfe, 8) & \
        new_state.chan_valid.reshape(-1)
    k = 148

    # the equalizer scan is the frame's deepest sequential chain; skip
    # it at runtime unless some channel needs it (the reference
    # branches per burst the same way)
    def _run_eq(_):
        scaled = bursts / jnp.where(amplitude == 0, 1.0,
                                    amplitude)[:, None]
        return dfe_mod.equalize_burst(
            scaled, toa - new_state.chan_resp_offset.reshape(-1), sps,
            _flat(new_state.dfe_forward),
            _flat(new_state.dfe_feedback))[:, :k]

    soft_eq = jax.lax.cond(
        jnp.any(use_dfe), _run_eq,
        lambda _: jnp.full((bursts.shape[0], k), 0.5, jnp.float32),
        operand=None)
    soft = jnp.where(use_dfe[:, None], soft_eq,
                     soft_plain[:, :k])
    soft = jnp.where(success[:, None], soft, 0.5)

    # --- RSSI / timing (cpp:396-399) ----------------------------------
    amp_abs = jnp.maximum(jnp.abs(amplitude), 1e-9)
    rssi = jnp.floor(20.0 * jnp.log10(cfg.rssi_full_scale / amp_abs)
                     ).astype(jnp.int32)
    timing = jnp.round(toa * 256.0 / sps).astype(jnp.int32)

    new_state = new_state._replace(fn=(fn + 1) % HYPERFRAME)
    res = RxResult(
        detected=success.reshape(c, 8),
        is_rach=(success & is_rach).reshape(c, 8),
        soft_bits=soft.reshape(c, 8, k),
        rssi=rssi.reshape(c, 8),
        timing=timing.reshape(c, 8),
    )
    return new_state, res


@functools.partial(jax.jit, static_argnums=(0,))
def tx_step(cfg: TrxConfig, state: TrxState, bits: Array, valid: Array,
            atten_db: Array, fn: Array) -> Array:
    """Modulate one downlink frame for all channels.

    bits: [C, 8, 148] uint8; valid: [C, 8] bool (filler-table fallback
    where False — Transceiver.cpp:165-175); atten_db: [C, 8] f32 relative
    attenuation (addRadioVector scale, cpp:111). Returns the frame's
    samples [C, 8, SLOT_SAMPLES·sps] (slot windows; slot lengths follow
    the 157/156 pattern with trailing zeros).
    """
    del fn
    return tx_frames(cfg, state, bits[None], valid[None],
                     atten_db[None])[0]


def tx_frames(cfg: TrxConfig, state: TrxState, bits: Array, valid: Array,
              atten_db: Array) -> Array:
    """Modulate a WHOLE window of downlink frames in one batch.

    bits [F, C, 8, 148], valid/atten_db [F, C, 8] →
    [F, C, 8, SLOT_SAMPLES·sps]. tx_step reads only block-constant
    state (filler table, full scale) and ignores fn, so the
    reference's frame-at-a-time driveTransmitFIFO walk
    (Transceiver.cpp:672-722) carries no sequential dependency — one
    F·C·8-burst modulation replaces the F-step scan (the scan was the
    dominant serialization inside the fused duplex program)."""
    f, c, sps = bits.shape[0], cfg.n_chan, cfg.sps
    t = SLOT_SAMPLES * sps
    flat = bits.reshape(f * c * 8, bits.shape[-1])
    mod = gmsk.modulate_burst(flat, sps, guard_len=9)  # [F·C·8, 157·sps]
    scale = (cfg.tx_full_scale *
             10.0 ** (-atten_db.reshape(-1) / 10.0)).astype(jnp.float32)
    mod = mod * scale[:, None]
    # mask samples beyond the true slot length (157/156/156/156 pattern)
    slot_len = jnp.asarray(np.array(SLOT_SAMPLE_PATTERN, np.int32)) * sps
    mask = jnp.arange(t)[None, :] < jnp.tile(slot_len, (f * c,))[:, None]
    mod = jnp.where(mask, mod[:, :t], 0.0)
    fill = jnp.broadcast_to(state.filler.reshape(1, c * 8, t),
                            (f, c * 8, t)).reshape(f * c * 8, t)
    out = jnp.where(valid.reshape(-1)[:, None], mod, fill)
    return out.reshape(f, c, 8, t)
