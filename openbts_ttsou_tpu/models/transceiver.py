"""The flagship model: a complete multi-channel GSM transceiver pipeline.

Composes the DSP kernel library (`ops/`), the layer-0 engine (`trx/`)
and the resampler front-end into the reference's two hot call stacks
(SURVEY.md §3.1-3.2):

  uplink:   device-rate IQ → polyphase 65/96 → slot windows →
            energy/TSC/RACH detect → demod/equalize → soft bits
  downlink: burst bits → GMSK modulate (+filler fallback) →
            polyphase 96/65 → device-rate IQ

One `Transceiver` instance owns the functional `TrxState`; all compute
is jitted and batched over `[chan, slot]`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np

from openbts_ttsou_tpu.ops import fir
from openbts_ttsou_tpu.trx import engine as eng
from openbts_ttsou_tpu.utils.gsm_time import FRAME_SYMBOLS, HYPERFRAME

Array = jax.Array


class UplinkSpec(NamedTuple):
    """Static geometry of one uplink processing block."""

    frames: int = 13  # 13 frames → integral 65/96 resampling (60 ms)
    p: int = 65
    q: int = 96
    taps: int = 961

    @property
    def block_symbols(self) -> int:
        return self.frames * FRAME_SYMBOLS

    @property
    def block_in(self) -> int:
        assert (self.block_symbols * self.q) % self.p == 0
        return self.block_symbols * self.q // self.p


@functools.partial(jax.jit, static_argnums=(0, 1))
def uplink_block(cfg: eng.TrxConfig, spec: UplinkSpec, state: eng.TrxState,
                 samples: Array) -> tuple[eng.TrxState, eng.RxResult]:
    """Process one device-rate block for all channels.

    samples: [C, spec.block_in] complex64 at the 400 kS/s device rate
    (the 64M USRP path, Transceiver/radioInterface.cpp:197-260).
    Returns per-frame results stacked [frames, C, 8, ...] with the
    reference's exact per-frame semantics (pullRadioVector,
    Transceiver.cpp:268-408)."""
    lpf = fir.resampler_lpf(spec.p, spec.q, spec.taps)  # trace-time const
    sym = fir.polyphase_resample(samples, spec.p, spec.q, lpf)
    return process_block_exact(cfg, spec.frames, state,
                               sym[..., : spec.block_symbols])


def process_block_exact(cfg: eng.TrxConfig, frames: int,
                        state: eng.TrxState, sym: Array
                        ) -> tuple[eng.TrxState, eng.RxResult]:
    """Exact-semantics block receiver at block-batched kernel sizes.

    Semantically identical to scanning `eng.rx_step` over the window
    (pinned burst-for-burst by tests/test_exact_block.py), and the only
    schedule the device programs use: on the H100 it beat the per-frame
    scan at every carrier count measured, 8 to 1024, by 1.3x to 3.7x
    (tools/exact_bakeoff.py; PERF.md). It is restructured for a wide
    device: everything threshold-INdependent — the
    TSC/RACH correlators, channel estimation, DFE design, demodulation
    and the equalizer (the window's heavy compute) — runs ONCE batched
    over all frames·C·8 bursts, while the reference's genuinely
    sequential recurrences (the per-slot adaptive-threshold walk, the
    energy gate against the running threshold, and channel/DFE state
    adoption — Transceiver.cpp:294-375) run in a `lax.scan` whose body
    is a few dozen [C]/[C,8] scalar ops. The per-frame scan of the
    full `rx_step` pipeline paid 26 small kernels of launch/HBM
    overhead per block at small carrier counts (the 8-carrier wire
    regime); here the sequential chain carries no heavy tensors.

    Key structural facts making this exact, not approximate:
    * detection (peak/valley correlation, TOA bounds) never reads the
      energy threshold — only the final energy gate does;
    * within one frame all 8 slots gate against the frame-ENTRY
      threshold (rx_step computes has_energy once, then folds);
    * channel/DFE adoption selects whole frames: each burst's
      equalizer weights are those of the LAST adoption at or before
      its frame (or the entry state), so per-burst weight selection is
      an [F+1]-way gather over batched candidates.
    """
    from openbts_ttsou_tpu.ops import correlate as xcorr
    from openbts_ttsou_tpu.ops import dfe as dfe_mod
    from openbts_ttsou_tpu.ops import gmsk as gmsk_mod
    from openbts_ttsou_tpu.parallel.sharded import _slot_windows
    from openbts_ttsou_tpu.utils.gsm_time import fn_delta

    c, sps = cfg.n_chan, cfg.sps
    f = frames
    wins = _slot_windows(sym, f)  # [F, C, 8, T]
    bursts = wins.reshape((-1, wins.shape[-1]))  # [F·C·8, T]
    fn0 = state.fn
    fns = (fn0 + jnp.arange(f)) % HYPERFRAME  # [F]

    corr_type = jax.vmap(
        lambda fn: eng.expected_corr_type(state.chan_type, fn))(fns)
    active = (corr_type == eng.CorrType.TSC) | \
        (corr_type == eng.CorrType.RACH)
    if cfg.rach_slots is not None:
        allowed = np.zeros(8, bool)
        allowed[list(cfg.rach_slots)] = True
        active = active & ~((corr_type == eng.CorrType.RACH) &
                            ~jnp.asarray(allowed)[None, None, :])
    is_tsc = corr_type == eng.CorrType.TSC  # [F, C, 8]
    is_rach = corr_type == eng.CorrType.RACH
    ts_flat = is_tsc.reshape(-1)
    ra_flat = is_rach.reshape(-1)

    # raw per-burst energy once; the scan re-compares it against the
    # walking threshold (energyDetect gate, cpp:292-303)
    _, energy = xcorr.energy_detect(bursts, 20 * sps, jnp.float32(0))
    energy = energy.reshape(f, c, 8)

    need_dfe = state.max_expected_delay > 1  # [C]
    # estimation-tail gate: an upper bound on "some frame wants an
    # estimate" that needs no threshold walk — staleness without
    # adoption is monotone (max at the last frame), and a mid-window
    # validity clear (which can create demand) requires a TSC burst
    # in the window at all. Over-approximating only costs compute;
    # the adopted-state semantics come from the scan's do_est.
    stale_ub = fn_delta(fns[-1], state.chan_estimate_fn) > 50  # [C,8]
    gate_est_ub = jnp.any(
        need_dfe[:, None] & (stale_ub | ~state.chan_valid |
                             jnp.any(is_tsc, axis=0)))

    tsc_flat = jnp.tile(jnp.repeat(state.tsc, 8), f)
    det_tsc, chan_est, chan_off = xcorr.analyze_traffic_burst(
        bursts, tsc_flat, sps, threshold=cfg.tsc_threshold,
        estimate_channel=True, max_toa=cfg.max_toa,
        gate_estimation=gate_est_ub)
    det_rach = eng._detect_rach_slots(
        wins.reshape(f * c, 8, wins.shape[-1]), sps, cfg.rach_threshold,
        cfg.rach_slots)

    # type dispatch + TOA acceptance — the threshold-independent part
    # of `success`; the energy gate joins inside the scan
    det_any = jnp.where(ts_flat, det_tsc.detected,
                        jnp.where(ra_flat, det_rach.detected, False))
    med = jnp.tile(jnp.repeat(state.max_expected_delay[:, None], 8,
                              axis=1).reshape(-1), f
                   ).astype(jnp.float32) * sps
    det_any = det_any & jnp.where(ra_flat & (med > 0),
                                  det_rach.toa <= med, True)
    tsc_bound = jnp.maximum(med, 3.0 * sps)
    det_any = det_any & jnp.where(
        ts_flat, (det_tsc.toa <= tsc_bound) & (det_tsc.toa >= -tsc_bound),
        True)
    amplitude = jnp.where(ts_flat, det_tsc.amplitude, det_rach.amplitude)
    toa = jnp.where(ts_flat, det_tsc.toa, det_rach.toa)

    # ---- the light sequential scan: threshold walk + adoption --------
    def frame_step(carry, inp):
        thr, prev_false, valid, est_fn, last_adopt = carry
        ii, fn_i, act_i, e_i, d_raw, d_ok, tsc_i = inp
        thr_entry = thr
        gate = (e_i > (thr * thr)[:, None]) & act_i
        success = gate & d_ok
        frames_since = fn_delta(fn_i, est_fn)
        want = ((frames_since > 50) | ~valid) & need_dfe[:, None]
        do_est = want & tsc_i & success
        new_valid = jnp.where(do_est, True,
                              valid & ~(~d_raw & tsc_i & gate))
        new_est_fn = jnp.where(do_est, jnp.full_like(est_fn, fn_i),
                               est_fn)
        new_last = jnp.where(do_est, jnp.full_like(last_adopt, ii),
                             last_adopt)
        # slot-ordered threshold fold — verbatim rx_step's (cpp:294-375)
        for tn in range(8):
            frames_elapsed = fn_delta(fn_i, prev_false
                                      ).astype(jnp.float32)
            low_energy = act_i[:, tn] & ~gate[:, tn]
            quiet = low_energy & (frames_elapsed > 50)
            thr = jnp.where(quiet, thr - 10.0, thr)
            prev_false = jnp.where(quiet, fn_i, prev_false)
            hit = success[:, tn]
            thr = jnp.where(hit, jnp.maximum(thr - 1.0, 0.0), thr)
            miss = act_i[:, tn] & gate[:, tn] & ~success[:, tn]
            thr = jnp.where(
                miss, thr + 10.0 * jnp.exp(-frames_elapsed), thr)
            prev_false = jnp.where(miss, fn_i, prev_false)
        return ((thr, prev_false, new_valid, new_est_fn, new_last),
                (success, do_est, new_valid, new_last, thr_entry))

    carry0 = (state.energy_threshold, state.prev_false_detect_fn,
              state.chan_valid, state.chan_estimate_fn,
              jnp.full((c, 8), -1, jnp.int32))
    xs = (jnp.arange(f, dtype=jnp.int32), fns, active, energy,
          det_tsc.detected.reshape(f, c, 8),
          det_any.reshape(f, c, 8), is_tsc)
    ((thr_f, pf_f, valid_f, estfn_f, last_f),
     (success_s, do_est_s, valid_post_s, last_post_s,
      thr_entry_s)) = lax.scan(frame_step, carry0, xs)
    success = success_s.reshape(-1)  # [F·C·8]

    # ---- estimation candidates + DFE design (batched, gated) ---------
    thr_b = jnp.repeat(thr_entry_s, 8, axis=-1).reshape(-1)  # [F·C·8]
    new_snr_all = jnp.abs(amplitude) ** 2 / (thr_b * thr_b + 1.0)
    amp_safe = jnp.where(amplitude == 0, 1.0, amplitude)
    chan_norm_all = chan_est / amp_safe[:, None]
    dfe_chan_all = (chan_norm_all[..., :: sps] if sps > 1
                    else chan_norm_all)
    n = f * c * 8
    w_all, b_all = jax.lax.cond(
        gate_est_ub,
        lambda _: dfe_mod.design_dfe(dfe_chan_all,
                                     jnp.maximum(new_snr_all, 1e-6),
                                     eng.DFE_NF),
        lambda _: (jnp.zeros((n, eng.DFE_NF), jnp.complex64),
                   jnp.zeros((n, eng.CHAN_TAPS - 1), jnp.complex64)),
        operand=None)

    # ---- per-burst candidate selection ([F+1]-way) ------------------
    c8 = c * 8

    def _cands(entry, per_frame):
        return jnp.concatenate(
            [entry.reshape((1, c8) + entry.shape[2:]),
             per_frame.reshape((f, c8) + per_frame.shape[1:])], axis=0)

    def _sel(cand, idx):
        """cand [F+1, C8, ...] picked at idx [K, C8] → [K, C8, ...]:
        a gather, so the selected values are exact."""
        return cand[idx, jnp.arange(c8)[None, :]]

    # equalizer weights per burst: adoption state AFTER its own frame
    sel_post = last_post_s.reshape(f, c8) + 1  # [F, C8] in [0, F]
    cand_w = _cands(state.dfe_forward, w_all)
    cand_b = _cands(state.dfe_feedback, b_all)
    cand_off = _cands(state.chan_resp_offset.reshape(c, 8, 1),
                      chan_off.reshape(n, 1))
    w_sel = _sel(cand_w, sel_post).reshape(n, eng.DFE_NF)
    b_sel = _sel(cand_b, sel_post).reshape(n, eng.CHAN_TAPS - 1)
    off_sel = _sel(cand_off, sel_post).reshape(n)

    use_dfe = (ts_flat & jnp.tile(jnp.repeat(need_dfe, 8), f) &
               valid_post_s.reshape(-1))
    k = 148

    # ---- demod + equalizer (batched, equalizer runtime-gated) --------
    soft_plain = gmsk_mod.demodulate_burst(bursts, sps, amplitude, toa)

    def _run_eq(_):
        scaled = bursts / amp_safe[:, None]
        return dfe_mod.equalize_burst(scaled, toa - off_sel, sps,
                                      w_sel, b_sel)[:, :k]

    soft_eq = jax.lax.cond(
        jnp.any(use_dfe), _run_eq,
        lambda _: jnp.full((n, k), 0.5, jnp.float32), operand=None)
    soft = jnp.where(use_dfe[:, None], soft_eq, soft_plain[:, :k])
    soft = jnp.where(success[:, None], soft, 0.5)

    amp_abs = jnp.maximum(jnp.abs(amplitude), 1e-9)
    rssi = jnp.floor(20.0 * jnp.log10(cfg.rssi_full_scale / amp_abs)
                     ).astype(jnp.int32)
    timing = jnp.round(toa * 256.0 / sps).astype(jnp.int32)

    # ---- final state: LAST adoption per (chan, slot), or entry -------
    sel_f = (last_f.reshape(c8) + 1)[None]  # [1, C8]

    def pick_f(entry, per_frame):
        return _sel(_cands(entry, per_frame), sel_f)[0]

    new_state = state._replace(
        fn=(fn0 + f) % HYPERFRAME,
        energy_threshold=thr_f,
        prev_false_detect_fn=pf_f,
        chan_valid=valid_f,
        chan_estimate_fn=estfn_f,
        chan_response=pick_f(state.chan_response, chan_norm_all
                             ).reshape(c, 8, -1),
        chan_resp_offset=pick_f(state.chan_resp_offset.reshape(c, 8, 1),
                                chan_off.reshape(n, 1)).reshape(c, 8),
        chan_amplitude=pick_f(state.chan_amplitude.reshape(c, 8, 1),
                              amplitude.reshape(n, 1)).reshape(c, 8),
        snr=pick_f(state.snr.reshape(c, 8, 1),
                   new_snr_all.reshape(n, 1)).reshape(c, 8),
        dfe_forward=pick_f(state.dfe_forward, w_all).reshape(c, 8, -1),
        dfe_feedback=pick_f(state.dfe_feedback, b_all
                            ).reshape(c, 8, -1),
    )
    res = eng.RxResult(
        detected=success.reshape(f, c, 8),
        is_rach=(success & ra_flat).reshape(f, c, 8),
        soft_bits=soft.reshape(f, c, 8, k),
        rssi=rssi.reshape(f, c, 8),
        timing=timing.reshape(f, c, 8),
    )
    return new_state, res


class DecodedBlocks(NamedTuple):
    """On-device FEC output for one uplink block: XCCH blocks fully
    contained in the window (`bits` [G, C, 8, 184] uint8 in air bit
    order, `ok` [G, C, 8] bool FireCode syndrome, `first_fn` [] int32 —
    the FN of group 0's first burst), per-frame RACH decodes
    (`rach_ra` [F, C, 8] int32, `rach_ok` [F, C, 8] bool — RA value and
    color-code check where a RACH was detected), and TCH/FS + FACCH
    8-burst diagonal half-blocks completing inside the window
    (TCHFACCHL1Decoder, GSML1FEC.cpp:1031-1175): `tch_speech`
    [Gt, C, 8, 260] uint8 coder-order vocoder frames, `tch_good`
    [Gt, C, 8] (class-1a parity + tail, and not stolen), `facch_bits`
    [Gt, C, 8, 184] air-order FACCH frames with `facch_ok` (FireCode,
    and stolen), `tch_stolen` [Gt, C, 8] (the completing burst's Hl
    flag), `tch_end_fn` [Gt] int32 FN of each group's completing burst
    (−1 where `tch_valid` is False — the window held no such group)."""

    bits: Array
    ok: Array
    first_fn: Array
    rach_ra: Array
    rach_ok: Array
    tch_speech: Array
    tch_good: Array
    facch_bits: Array
    facch_ok: Array
    tch_stolen: Array
    tch_end_fn: Array
    tch_valid: Array


@functools.partial(jax.jit, static_argnums=(0, 1, 4, 5, 6))
def uplink_block_decoded(cfg: eng.TrxConfig, spec: UplinkSpec,
                         state: eng.TrxState, samples: Array,
                         bsic: int = 0,
                         xcch_tns: tuple | None = None,
                         tch_tns: tuple | None = None
                         ) -> tuple[eng.TrxState, eng.RxResult,
                                    DecodedBlocks]:
    """Full device-resident receiver: device-rate IQ → detection/demod →
    XCCH FEC decode, one fused program.

    The reference splits this at the UDP boundary (soft bits cross to
    the BTS process, GSML1FEC decodes burst-at-a-time per channel);
    batching the 4-burst deinterleave + 16-state Viterbi + FireCode
    syndrome over every (chan, slot) on the device removes
    the host round trip for bulk receivers (IQ scanners, load tests,
    multi-ARFCN pods). Groups are the FN%4-aligned 4-burst XCCH blocks
    (interleaver block boundary, GSML1FEC.cpp:572-630) fully inside the
    13-frame window — always 3 of them."""
    from openbts_ttsou_tpu.gsm import l1fec

    fn0 = state.fn
    new_state, res = uplink_block(cfg, spec, state, samples)
    return new_state, res, decode_block(
        res, fn0, spec.frames, bsic, xcch_tns=xcch_tns,
        tch_tns=tch_tns, rach_tns=cfg.rach_slots)


@functools.lru_cache(maxsize=None)
def _tch_group_tables(frames: int):
    """Static TCH half-block geometry per window phase p = fn0 % 26.

    The TCH/F 26-multiframe (GSMTDMA.cpp:245-270) skips fn%26 ∈ {12, 25}
    (SACCH/idle); the diagonal burst index B = reverseMapping(fn) % 8 is
    continuous across repeats (24 ≡ 0 mod 8). A half-block completes at
    every burst with B % 4 == 3 whose 7 predecessors are also inside
    the window (TCHFACCHL1Decoder::processBurst, GSML1FEC.cpp:1051-1068).

    Returns (frame_idx [26, Gt, 8], end_frame [26, Gt], valid [26, Gt]).
    """
    from openbts_ttsou_tpu.gsm.tdma import FACCH_TCHF

    rev = FACCH_TCHF.reverse_map()  # [26], −1 on SACCH/idle
    per_phase = []
    gmax = 1
    for p in range(26):
        tch = [(f, int(rev[(p + f) % 26]) % 8) for f in range(frames)
               if rev[(p + f) % 26] >= 0]
        groups = [([tch[i - 7 + j][0] for j in range(8)], f)
                  for i, (f, b) in enumerate(tch)
                  if b % 4 == 3 and i >= 7]
        per_phase.append(groups)
        gmax = max(gmax, len(groups))
    idx = np.zeros((26, gmax, 8), np.int32)
    end = np.zeros((26, gmax), np.int32)
    valid = np.zeros((26, gmax), bool)
    for p, groups in enumerate(per_phase):
        for g, (fr, f_end) in enumerate(groups):
            idx[p, g], end[p, g], valid[p, g] = fr, f_end, True
    return idx, end, valid


#: frames of previous-window soft bits carried by the streaming
#: decoder: a TCH 8-burst diagonal can reach 8 frames back (8 bursts
#: spanning one idle frame); XCCH groups need at most 3
DECODE_PRELUDE = 8


def _sub_tns(x: Array, tns: tuple, axis: int) -> Array:
    """Static TN subset (XLA lowers the constant take to slices)."""
    return jnp.take(x, np.asarray(tns, np.int32), axis=axis)


def _back_tns(x: Array, tns: tuple, axis: int, fill=0) -> Array:
    """Scatter a TN-subset result back into the full 8-slot lane
    (non-configured slots report `fill` — the host demux never reads
    them, mirroring TRXManager's per-(TN, FN) demux table)."""
    full = list(x.shape)
    full[axis] = 8
    out = jnp.full(full, fill, x.dtype)
    return out.at[
        tuple(slice(None) if a != axis else np.asarray(tns, np.int32)
              for a in range(len(full)))].set(x)


@functools.partial(jax.jit, static_argnums=(0, 1, 4, 7, 8))
def uplink_block_decoded_stream(cfg: eng.TrxConfig, spec: UplinkSpec,
                                state: eng.TrxState, samples: Array,
                                bsic: int, prev_soft: Array,
                                prev_valid: Array,
                                xcch_tns: tuple | None = None,
                                tch_tns: tuple | None = None
                                ) -> tuple[eng.TrxState, eng.RxResult,
                                           DecodedBlocks, Array, Array]:
    """Streaming fused receiver: like `uplink_block_decoded`, but FEC
    groups whose bursts SPAN the window boundary decode too, by
    prepending the previous window's last DECODE_PRELUDE frames of
    soft bits (the reference's per-burst decoders never lose groups to
    windowing — mI[] persists across bursts, GSML1FEC.cpp:572-630,
    1031-1100; this carry restores that on the windowed path). Each
    group is decoded exactly once: only groups COMPLETING inside the
    new window are reported.

    prev_soft [DECODE_PRELUDE, C, 8, 148] (zeros on the first window),
    prev_valid [] bool (False on the first window — prelude-spanning
    groups are then masked out). Returns (state', res, blocks,
    prev_soft', prev_valid')."""
    fn0 = state.fn
    new_state, res = uplink_block(cfg, spec, state, samples)
    blocks = decode_block(res, fn0, spec.frames, bsic,
                          prev_soft=prev_soft, prev_valid=prev_valid,
                          xcch_tns=xcch_tns, tch_tns=tch_tns,
                          rach_tns=cfg.rach_slots)
    return (new_state, res, blocks,
            res.soft_bits[-DECODE_PRELUDE:],
            jnp.asarray(True))


def decode_block(res: eng.RxResult, fn0: Array, frames: int,
                 bsic: int = 0, prev_soft: Array | None = None,
                 prev_valid: Array | None = None,
                 xcch_tns: tuple | None = None,
                 tch_tns: tuple | None = None,
                 rach_tns: tuple | None = None) -> DecodedBlocks:
    """FEC-decode one block's RxResult on device: the FN%4-aligned
    4-burst XCCH groups inside the window, per-frame RACH decode, and
    the TCH/FS + FACCH 8-burst diagonal half-blocks. Shared by the
    single-chip and sharded pipelines. With `prev_soft` (the streaming
    carry, see `uplink_block_decoded_stream`), groups spanning the
    left window edge decode as well; groups are reported exactly once
    (those completing in the current window).

    `xcch_tns`/`tch_tns`/`rach_tns` (static TN tuples, default all 8)
    restrict each decoder to the timeslots actually configured for
    that channel type — the slot combination is quasi-static between
    SETSLOT commands, exactly the knowledge TRXManager's demux table
    encodes per (TN, FN) (TRXManager.cpp:146-168), and the decode leg
    is Viterbi-scan-bound, so halving the slot set nearly halves its
    cost. Outputs keep the full [..., 8, ...] shape; non-configured
    slots report not-ok/invalid (the host demux never reads them)."""
    from openbts_ttsou_tpu.gsm import fec, l1fec

    c = res.soft_bits.shape[1]
    p = DECODE_PRELUDE if prev_soft is not None else 0
    if p:
        soft_all = jnp.concatenate([prev_soft, res.soft_bits], axis=0)
        pv = prev_valid
    else:
        soft_all = res.soft_bits
        pv = jnp.asarray(True)
    fn0_ext = (fn0 - p) % HYPERFRAME
    n_g = (p + frames) // 4
    off = (-fn0_ext) % 4  # frames until the next FN%4 block boundary
    # pad the frame axis so the slice never clamps (off ≤ 3); groups
    # extending past the window are masked invalid below
    xt = tuple(range(8)) if xcch_tns is None else tuple(xcch_tns)
    nx = len(xt)
    soft_x = soft_all if nx == 8 else _sub_tns(soft_all, xt, 2)
    soft_p = jnp.pad(soft_x, ((0, 3), (0, 0), (0, 0), (0, 0)))
    soft = lax.dynamic_slice_in_dim(soft_p, off, n_g * 4, axis=0)
    # [G·4, C, nx, 148] → [G, 4, C, nx, 148] → [G·C·nx, 4, 148]
    g = jnp.moveaxis(soft.reshape(n_g, 4, c, nx, 148), 1, 3)
    bits, ok = l1fec.xcch_decode(g.reshape(n_g * c * nx, 4, 148))
    bits = bits.reshape(n_g, c, nx, 184)
    ok = ok.reshape(n_g, c, nx)
    if nx < 8:
        bits = _back_tns(bits, xt, 2)
        ok = _back_tns(ok, xt, 2, fill=False)
    ends = off + (jnp.arange(n_g) + 1) * 4
    # report each group exactly once: it must END inside the current
    # window; prelude-reaching groups need a valid carry
    complete = (ends <= p + frames) & (ends > p) & \
        ((ends - 4 >= p) | pv)

    # RACH: every detected access burst decodes in the same program
    # (RACHL1Decoder::writeLowSide, GSML1FEC.cpp:474-513), on the
    # RACH-capable slots
    rt = tuple(range(8)) if rach_tns is None else tuple(rach_tns)
    rach_soft = res.soft_bits[
        ..., l1fec.RACH_DATA_START: l1fec.RACH_DATA_START + 36]
    if len(rt) < 8:
        rach_soft = _sub_tns(rach_soft, rt, 2)
    ra, ra_ok = l1fec.rach_decode(rach_soft, bsic)
    if len(rt) < 8:
        ra = _back_tns(ra, rt, 2)
        ra_ok = _back_tns(ra_ok, rt, 2, fill=False)

    # TCH/FS + FACCH (TCHFACCHL1Decoder::processBurst + deinterleave +
    # decode/decodeTCH, GSML1FEC.cpp:1031-1175). In window coordinates
    # the deinterleaver's circular-row offsets (0/4) fold away: with
    # the group's 8 bursts ordered oldest→newest, coded bit k always
    # reads burst k % 8 — i.e. tch_interleave_map(0).
    ti, te, tv = _tch_group_tables(p + frames)
    gt = ti.shape[1]
    p26 = fn0_ext % 26
    gf = lax.dynamic_index_in_dim(jnp.asarray(ti), p26, 0, keepdims=False)
    ge = lax.dynamic_index_in_dim(jnp.asarray(te), p26, 0, keepdims=False)
    gv = lax.dynamic_index_in_dim(jnp.asarray(tv), p26, 0, keepdims=False)
    # once-only + carry-validity masking, as for the XCCH groups
    gv = gv & (ge >= p) & ((gf[:, 0] >= p) | pv)
    tt = tuple(range(8)) if tch_tns is None else tuple(tch_tns)
    nt = len(tt)
    soft_t = soft_all if nt == 8 else _sub_tns(soft_all, tt, 2)
    grp = jnp.take(soft_t, gf.reshape(-1), axis=0)
    grp = jnp.moveaxis(grp.reshape((gt, 8, c, nt, 148)), 1, 3)
    payload, (hl, _hu) = fec.unmap_from_burst(grp)  # [Gt, C, nt, 8, 114]
    coded = fec.deinterleave(payload.reshape(gt * c * nt, 8, 114),
                             fec.tch_interleave_map(0))  # [.., 456]
    # stealing flag: Hl of the completing (newest) burst
    # (GSML1FEC.cpp:1073; the encoder sets both H bits per GSM 05.03
    # 4.2.5, the decoder keys on Hl)
    stolen = hl[..., 7] > 0.5  # [Gt, C, nt]
    speech, tch_parity = l1fec.tch_decode(coded)
    fbits, f_ok = l1fec.xcch_decode_coded(coded)
    speech = speech.reshape(gt, c, nt, 260)
    tch_parity = tch_parity.reshape(gt, c, nt)
    fbits = fbits.reshape(gt, c, nt, 184)
    f_ok = f_ok.reshape(gt, c, nt)
    if nt < 8:
        speech = _back_tns(speech, tt, 2)
        tch_parity = _back_tns(tch_parity, tt, 2, fill=False)
        fbits = _back_tns(fbits, tt, 2)
        f_ok = _back_tns(f_ok, tt, 2, fill=False)
        stolen = _back_tns(stolen, tt, 2, fill=False)
    gvc = gv[:, None, None]

    return DecodedBlocks(
        bits=bits,
        ok=ok & complete[:, None, None],
        first_fn=(fn0_ext + off) % HYPERFRAME,
        rach_ra=ra.astype(jnp.int32),
        rach_ok=ra_ok & res.is_rach,
        tch_speech=speech,
        tch_good=tch_parity & ~stolen & gvc,
        facch_bits=fbits,
        facch_ok=f_ok & stolen & gvc,
        tch_stolen=stolen & gvc,
        tch_end_fn=jnp.where(gv, (fn0_ext + ge) % HYPERFRAME, -1),
        tch_valid=gv,
    )


@functools.partial(jax.jit, static_argnums=(0, 1))
def downlink_block(cfg: eng.TrxConfig, spec: UplinkSpec, state: eng.TrxState,
                   bits: Array, valid: Array, atten_db: Array,
                   fn0: Array) -> Array:
    """Modulate `frames` downlink frames and resample to device rate.

    bits: [frames, C, 8, 148]; valid/atten_db: [frames, C, 8].
    Returns [C, spec.block_in] device-rate samples
    (driveTransmitFIFO → pushBuffer, Transceiver.cpp:672-722 +
    Transceiver/radioInterface.cpp:123-186).
    """
    del fn0  # tx_step ignores fn; the stream layout is frame-indexed
    # whole-window batched modulation (no per-frame scan)
    slots = eng.tx_frames(cfg, state, bits, valid, atten_db)
    # [frames, C, 8, 157] → continuous stream [C, frames·1250]
    sym = _assemble_stream(slots)
    lpf = fir.resampler_lpf(spec.q, spec.p, 651)
    out = fir.polyphase_resample(sym, spec.q, spec.p, lpf)
    return out[..., : spec.block_in]


@functools.partial(jax.jit, static_argnums=(0, 1))
def downlink_block_encoded(cfg: eng.TrxConfig, spec: UplinkSpec,
                           state: eng.TrxState, frames184: Array,
                           valid: Array, atten_db: Array,
                           fn0: Array) -> Array:
    """FEC-in-program downlink: 184-bit L2 frames → FireCode parity +
    rate-1/2 conv + diagonal interleave + burst mapping
    (XCCHL1Encoder::sendFrame, GSML1FEC.cpp:768-849) → GMSK modulate →
    96/65 resample, one fused program for every (chan, slot).

    frames184: [G, C, 8, 184] air-order frames for the G = frames//4
    FN%4-aligned groups starting at fn0 (fn0 must be block-aligned);
    valid/atten_db: [G, C, 8]. Returns [C, spec.block_in] device-rate
    samples; invalid (group, chan, slot) entries transmit the filler
    table like downlink_block."""
    from openbts_ttsou_tpu.gsm import l1fec

    g, c = frames184.shape[0], cfg.n_chan
    assert g * 4 <= spec.frames
    bursts = l1fec.xcch_encode(frames184, tsc=None)  # [G, C, 8, 4, 148]
    # TSC per carrier comes from the engine state at modulation time:
    # map_to_burst left the midamble zeroed when tsc=None, so write it
    # from state.tsc (the SETTSC plane) for every burst
    from openbts_ttsou_tpu.utils import constants as C

    tsc_bank = jnp.asarray(np.asarray(C.TRAINING_SEQUENCE, np.uint8))
    mid = tsc_bank[state.tsc]  # [C, 26]
    bursts = bursts.at[..., 61:87].set(
        mid[None, :, None, None, :].astype(bursts.dtype))
    # [G, C, 8, 4, 148] → [G·4 frames, C, 8, 148]
    bits = jnp.moveaxis(bursts, 3, 1).reshape(g * 4, c, 8, 148)
    pad = spec.frames - g * 4
    bits = jnp.pad(bits, ((0, pad), (0, 0), (0, 0), (0, 0)))
    v = jnp.repeat(valid, 4, axis=0)
    v = jnp.pad(v, ((0, pad), (0, 0), (0, 0)))
    a = jnp.repeat(atten_db, 4, axis=0)
    a = jnp.pad(a, ((0, pad), (0, 0), (0, 0)))
    return downlink_block(cfg, spec, state, bits.astype(jnp.uint8), v, a,
                          fn0)


#: leftover coded XCCH frames a streaming window carries to its
#: successor: a 4-burst group starting ≤3 frames before the window
#: edge finishes inside the next window
XCCH_TX_CARRY = 3


class XcchTxCarry:
    """Cross-window carry for the streaming XCCH downlink grid (see
    `_encode_dl_window` with `xcch_phase`): the ≤3 coded burst frames
    of a group that started in the previous window plus their valid
    plane — the tx-side mirror of the rx DECODE_PRELUDE."""

    @staticmethod
    def zeros(c: int):
        return (jnp.zeros((XCCH_TX_CARRY, c, 8, 148), jnp.uint8),
                jnp.zeros((XCCH_TX_CARRY, c, 8), bool))


def _encode_dl_window(cfg: eng.TrxConfig, spec: UplinkSpec,
                      state: eng.TrxState, frames184: Array,
                      xcch_valid: Array, speech: Array, sp_valid: Array,
                      facch: Array, fa_valid: Array, tch_mask: Array,
                      carry, fn0: Array, xcch_phase: int | None = None,
                      xcch_carry: tuple | None = None,
                      xcch_tns: tuple | None = None,
                      tch_tns: tuple | None = None
                      ) -> tuple[Array, Array, tuple, tuple | None]:
    """Shared FEC-encode leg of `downlink_block_tch` and
    `duplex_block_decoded`: XCCH + TCH/FS + FACCH content for one
    window → (bits [F, C, 8, 148] with per-carrier TSC stamped, valid
    [F, C, 8], tch_carry', xcch_carry').

    Two XCCH layouts:
    * legacy (`xcch_phase=None`): fn0 must be FN%4-aligned; group g
      occupies window frames [4g..4g+3] (downlink_block_encoded's
      contract).
    * streaming (`xcch_phase = fn0 % 4`, static): groups live on the
      ABSOLUTE FN%4 grid — the grid the uplink decoder's groups use
      (decode_block) — so 13-frame windows whose starts drift mod 4
      still transmit decodable groups. Group g of this window starts
      at local frame ((-phase) % 4) + 4g; a group extending past the
      window edge carries its tail frames to the next window through
      `xcch_carry` (the tx mirror of the rx soft-bit prelude).
      frames184 is then [4, C, 8, 184] (the at-most-4 group starts).
    """
    from openbts_ttsou_tpu.gsm import l1fec
    from openbts_ttsou_tpu.utils import constants as C

    f, c = spec.frames, cfg.n_chan
    g = frames184.shape[0]
    gt = speech.shape[0]
    # static slot split (see decode_block): each encoder runs only on
    # its configured TNs; outputs scatter back to the full 8-slot lane
    xt = tuple(range(8)) if xcch_tns is None else tuple(xcch_tns)
    nx = len(xt)
    tt = tuple(range(8)) if tch_tns is None else tuple(tch_tns)
    nt = len(tt)

    # ---- XCCH leg (XCCHL1Encoder::sendFrame, GSML1FEC.cpp:768-849) ---
    f184 = frames184 if nx == 8 else _sub_tns(frames184, xt, 2)
    xvs = xcch_valid if nx == 8 else _sub_tns(xcch_valid, xt, 2)
    bursts = l1fec.xcch_encode(f184, tsc=None)  # [G, C, nx, 4, 148]
    new_xcch_carry = None
    if xcch_phase is None:
        xb = jnp.moveaxis(bursts, 3, 1).reshape(g * 4, c, nx, 148)
        pad = f - g * 4
        xb = jnp.pad(xb, ((0, pad), (0, 0), (0, 0), (0, 0)))
        xv = jnp.pad(jnp.repeat(xvs, 4, axis=0),
                     ((0, pad), (0, 0), (0, 0)))
    else:
        assert g == 4 and xcch_carry is not None
        off = (-int(xcch_phase)) % 4  # local frame of the first grid
        cb, cv = xcch_carry
        if nx < 8:
            cb, cv = _sub_tns(cb, xt, 2), _sub_tns(cv, xt, 2)
        nb = jnp.moveaxis(bursts, 3, 1).reshape(16, c, nx, 148)
        nv = jnp.repeat(xvs, 4, axis=0)  # [16, C, nx]
        seq_b = jnp.concatenate([cb, nb], axis=0)  # [19, C, nx, 148]
        seq_v = jnp.concatenate([cv, nv], axis=0)
        # static slice: carry frames fill local 0..off−1 (the window
        # reads the LAST `off` carry entries), the window spans
        # grid-relative [XCCH_TX_CARRY−off, +f)
        start = XCCH_TX_CARRY - off
        xb = lax.slice_in_dim(seq_b, start, start + f, axis=0)
        xv = lax.slice_in_dim(seq_v, start, start + f, axis=0)
        # next carry, RIGHT-aligned so the successor's static slice
        # [XCCH_TX_CARRY−off', :] lands on the continuation frames:
        # its off' = (off − f) % 4 determines how many it consumes
        off_next = (off - f) % 4
        cstart = start + f - (XCCH_TX_CARRY - off_next)
        keep = (jnp.arange(XCCH_TX_CARRY) >=
                (XCCH_TX_CARRY - off_next))[:, None, None]
        ncb = lax.slice_in_dim(seq_b, cstart,
                               cstart + XCCH_TX_CARRY, axis=0)
        ncv = lax.slice_in_dim(seq_v, cstart,
                               cstart + XCCH_TX_CARRY, axis=0) & keep
        if nx < 8:
            ncb = _back_tns(ncb, xt, 2)
            ncv = _back_tns(ncv, xt, 2, fill=False)
        new_xcch_carry = (ncb, ncv)
    if nx < 8:
        xb = _back_tns(xb, xt, 2)
        xv = _back_tns(xv, xt, 2, fill=False)

    # ---- TCH/FS + FACCH leg (TCHFACCHL1Encoder, GSML1FEC.cpp:
    # 1106-1120, 1280-1393) --------------------------------------------
    if nt < 8:
        sp_s = _sub_tns(speech, tt, 2)
        spv_s = _sub_tns(sp_valid, tt, 2)
        fa_s = _sub_tns(facch, tt, 2)
        fav_s = _sub_tns(fa_valid, tt, 2)
        # TchTxCarry lanes are [C·8, 8, 114]-shaped per (carrier, TN):
        # subset the TN lane axis the same way
        carry_s = tuple(
            _sub_tns(x.reshape((c, 8) + x.shape[1:]), tt, 1)
            .reshape((c * nt,) + x.shape[1:]) for x in carry)
    else:
        sp_s, spv_s, fa_s, fav_s, carry_s = (speech, sp_valid, facch,
                                             fa_valid, carry)
    n = c * nt
    tb, t_isburst, _hu, carry2 = l1fec.tch_tx_window(
        sp_s.reshape(gt, n, 260), spv_s.reshape(gt, n),
        fa_s.reshape(gt, n, 184), fav_s.reshape(gt, n),
        carry_s, fn0, f)
    tb = tb.reshape(f, c, nt, 148)
    t_isburst = t_isburst.reshape(f, c, nt)
    if nt < 8:
        tb = _back_tns(tb, tt, 2)
        t_isburst = _back_tns(t_isburst, tt, 2, fill=False)
        carry2 = tuple(
            _back_tns(x.reshape((c, nt) + x.shape[1:]), tt, 1,
                      fill=False if x.dtype == jnp.bool_ else 0)
            .reshape((c * 8,) + x.shape[1:]) for x in carry2)
    tv = t_isburst & tch_mask[None]

    bits = jnp.where(tch_mask[None, :, :, None], tb, xb)
    valid = jnp.where(tch_mask[None], tv, xv)
    tsc_bank = jnp.asarray(np.asarray(C.TRAINING_SEQUENCE, np.uint8))
    mid = tsc_bank[state.tsc]  # [C, 26]
    bits = bits.at[..., 61:87].set(
        mid[None, :, None, :].astype(bits.dtype))
    return bits.astype(jnp.uint8), valid, carry2, new_xcch_carry


@functools.partial(jax.jit, static_argnums=(0, 1, 11, 12, 13, 14))
def duplex_block_decoded(cfg: eng.TrxConfig, spec: UplinkSpec,
                         state: eng.TrxState, ul_halo: Array,
                         tx_tail: Array, dl_content: tuple,
                         atten_db: Array, tx_carry, fn0_dl: Array,
                         prev_soft: Array, prev_valid: Array,
                         bsic: int = 0, xcch_phase: int = 0,
                         xcch_tns: tuple | None = None,
                         tch_tns: tuple | None = None
                         ) -> tuple[eng.TrxState, Array, Array,
                                    DecodedBlocks, tuple, Array, Array]:
    """The fully-resident BTS layer 1, both directions, ONE device
    program: downlink FEC (XCCH + TCH/FS + FACCH encode, diagonal
    interleave, stealing flags) → GMSK modulate → 96/65 resample, AND
    uplink 65/96 resample → exact detection/demod → streaming FEC
    decode (XCCH + RACH + TCH/FS + FACCH with the cross-window soft-bit
    prelude carry). The reference splits all of this across two
    processes and a UDP socket (Transceiver52M ↔ GSML1FEC); here L2
    frames and vocoder bits are the ONLY host traffic — IQ, soft bits
    and coded bits never leave the device.

    dl_content = (frames184 [4, C, 8, 184] on the ABSOLUTE FN%4 grid
    (see `_encode_dl_window` streaming layout), xcch_valid [4, C, 8],
    speech [Gt, C, 8, 260], sp_valid, facch [Gt, C, 8, 184], fa_valid,
    tch_mask [C, 8]); tx_carry = (l1fec.TchTxCarry.zeros(C*8),
    XcchTxCarry.zeros(C)) threading BOTH cross-window encoder carries;
    xcch_phase (static) = fn0_dl % 4 — the window-start drift of
    13-frame windows cycles through 4 phases, each its own compiled
    variant; prev_soft/prev_valid the streaming decode carry
    (uplink_block_decoded_stream). Stream continuity (ul_halo, tx_tail,
    TX_DELAY_DEV) as in duplex_block_wire.

    `xcch_tns`/`tch_tns` (static, default all 8): the configured slot
    split — both the encode and decode legs run each FEC chain only on
    its slots (the Viterbi/conv scans are the program's dominant cost;
    see decode_block). `tch_mask` must be False outside `tch_tns` and
    True nowhere in `xcch_tns`'s XCCH-carrying slots; RACH decode
    follows cfg.rach_slots.

    Returns (state', tx_dev [C, block_in], tx_tail', DecodedBlocks,
    tx_carry', prev_soft', prev_valid').
    Match: GSML1FEC.cpp:572-630,1106-1120 (the encode/decode pair)
    riding Transceiver.cpp:268-408/672-722 (the radio pair)."""
    from openbts_ttsou_tpu.parallel.halo import resample_block

    frames = spec.frames
    (frames184, xcch_valid, speech, sp_valid, facch, fa_valid,
     tch_mask) = dl_content
    tch_carry, xcch_carry = tx_carry

    # ---- downlink: FEC encode → modulate → resample -------------------
    bits, valid, tch_carry2, xcch_carry2 = _encode_dl_window(
        cfg, spec, state, frames184, xcch_valid, speech, sp_valid,
        facch, fa_valid, tch_mask, tch_carry, fn0_dl,
        xcch_phase=xcch_phase, xcch_carry=xcch_carry,
        xcch_tns=xcch_tns, tch_tns=tch_tns)
    tx_carry2 = (tch_carry2, xcch_carry2)
    slots = eng.tx_frames(cfg, state, bits, valid, atten_db)
    sym = _assemble_stream(slots)
    stream = jnp.concatenate([tx_tail.astype(sym.dtype), sym], axis=-1)
    lpf_tx = fir.resampler_lpf(spec.q, spec.p, 651)
    y = fir.polyphase_resample(stream, spec.q, spec.p, lpf_tx)
    tx = lax.slice_in_dim(y, TX_DELAY_DEV, TX_DELAY_DEV + spec.block_in,
                          axis=-1)
    new_tail = sym[..., -TX_TAIL_SYM:]

    # ---- uplink: resample → exact rx → streaming FEC decode -----------
    fn0 = state.fn
    lpf_rx = fir.resampler_lpf(spec.p, spec.q, spec.taps)
    sym_ul = resample_block(ul_halo, spec.p, spec.q, lpf_rx, RX_HALO_DEV,
                            spec.block_in)
    state2, res = process_block_exact(cfg, frames, state,
                                      sym_ul[..., : spec.block_symbols])
    blocks = decode_block(res, fn0, frames, bsic,
                          prev_soft=prev_soft, prev_valid=prev_valid,
                          xcch_tns=xcch_tns, tch_tns=tch_tns,
                          rach_tns=cfg.rach_slots)
    return (state2, tx, new_tail, blocks, tx_carry2,
            res.soft_bits[-DECODE_PRELUDE:], jnp.asarray(True))


@functools.partial(jax.jit, static_argnums=(0, 1))
def downlink_block_tch(cfg: eng.TrxConfig, spec: UplinkSpec,
                       state: eng.TrxState, frames184: Array,
                       xcch_valid: Array, speech: Array, sp_valid: Array,
                       facch: Array, fa_valid: Array, tch_mask: Array,
                       atten_db: Array, carry, fn0: Array
                       ) -> tuple[Array, tuple]:
    """Full FEC-in-program downlink with TCH/FS + FACCH: the fused
    device program now carries speech, mirroring the uplink direction's
    on-device TCH decoder (decode_block).

    XCCH leg: frames184 [G, C, 8, 184] air-order L2 frames on the
    G = frames//4 FN%4-aligned groups (XCCHL1Encoder::sendFrame,
    GSML1FEC.cpp:768-849), masked by xcch_valid [G, C, 8].
    TCH leg: speech [Gt, C, 8, 260] coder-order vocoder frames
    (sp_valid [Gt, C, 8]) and facch [Gt, C, 8, 184] (fa_valid) feed
    the windowed diagonal interleaver (tch_tx_window; 260-bit class
    1a/1b/2 partition + 3-bit CRC + 378/78 split + 8-burst diagonal +
    stealing flags — TCHFACCHL1Encoder, GSML1FEC.cpp:1106-1120,
    1280-1393), with `carry` from `l1fec.TchTxCarry.zeros(C*8)`
    threading the cross-window diagonal halves. tch_mask [C, 8] bool
    selects which slots are TCH/F; all others take the XCCH leg.
    atten_db [frames, C, 8]. Returns ([C, spec.block_in] device-rate
    samples, carry'); slots with no content transmit the filler table.
    """
    bits, valid, carry2, _ = _encode_dl_window(
        cfg, spec, state, frames184, xcch_valid, speech, sp_valid,
        facch, fa_valid, tch_mask, carry, fn0)
    out = downlink_block(cfg, spec, state, bits, valid, atten_db, fn0)
    return out, carry2


# Streaming-duplex halo geometry. The 961-tap 65/96 rx resampler reads
# ±⌈960/130⌉ = 8 device samples around each symbol — rounded to one
# 96-sample polyphase period per side; the 651-tap 96/65 tx resampler
# reads ±⌈650/192⌉ = 4 symbols — rounded to one 65-symbol period,
# carried as a 2×65-symbol left history (the reference's
# sendHistory/rcvHistory INHISTORY=130/OUTHISTORY=192 buffers,
# Transceiver/radioInterface.h:35-41, radioInterface.cpp:123-260).
RX_HALO_DEV = 96
TX_TAIL_SYM = 130
TX_DELAY_DEV = (TX_TAIL_SYM // 2) * 96 // 65  # 96 device samples


class WireBlock(NamedTuple):
    """One block's uplink results pre-quantized for the UDP data plane
    (driveReceiveFIFO serialization, Transceiver52M/Transceiver.cpp:
    652-667): soft bits already scaled ×255 to the wire's byte format."""

    detected: Array  # [F, C, 8] bool
    soft_u8: Array  # [F, C, 8, 148] uint8
    rssi: Array  # [F, C, 8] int32
    timing: Array  # [F, C, 8] int32 (1/256 symbol)


@functools.partial(jax.jit, static_argnums=(0, 1, 9))
def duplex_block_wire(cfg: eng.TrxConfig, spec: UplinkSpec,
                      state: eng.TrxState, ul_halo: Array, tx_tail: Array,
                      dl_bits: Array, dl_valid: Array, dl_atten: Array,
                      tx_fn0: Array, io_i16: bool = False
                      ) -> tuple[eng.TrxState, Array, Array, WireBlock]:
    """One fused streaming-duplex block: modulate + 96/65-resample the
    downlink window AND detect/demodulate the uplink window, with exact
    stream continuity across blocks.

    ul_halo:  [C, RX_HALO_DEV + block_in + RX_HALO_DEV] device-rate rx
              samples (one polyphase period of past and future stream);
    tx_tail:  [C, TX_TAIL_SYM] — the previous block's final modulated
              symbols (zeros on the first block);
    dl_bits/dl_valid/dl_atten: [frames, C, 8, ...] downlink window.

    Returns (state', tx_dev [C, block_in], tx_tail', WireBlock). The tx
    samples cover device timestamps shifted TX_DELAY_DEV early (the
    causal filter delay the reference absorbs in its history buffers) —
    the daemon writes them at ts − TX_DELAY_DEV so the air timeline is
    exact.

    io_i16 (static): move radio samples across the host boundary as
    int16 I/Q pairs [C, T, 2] — the USRP's native sample format — with
    the float conversion done on device (the reference burns host CPU
    on exactly this in USRPifyVector/unUSRPifyVector,
    Transceiver52M/radioInterface.cpp:101-146; on the device it is a
    free fused op and halves the PCIe bytes).

    The uplink walk is ALWAYS the reference's exact pullRadioVector
    semantics (per-frame threshold walk, 50-frame channel aging),
    scheduled by `process_block_exact`.
    """
    from openbts_ttsou_tpu.parallel.halo import resample_block

    if io_i16:
        ul_halo = (ul_halo[..., 0].astype(jnp.float32)
                   + 1j * ul_halo[..., 1].astype(jnp.float32)
                   ).astype(jnp.complex64)
    frames = spec.frames

    # ---- downlink (driveTransmitFIFO → pushBuffer) --------------------
    # one batched modulation for the whole window: the reference's
    # per-frame walk has no sequential dependency (tx_frames), and the
    # F-step scan here was half of the 26-small-kernel serialization
    # that made exact mode lose inside this fusion (round-3 verdict)
    slots = eng.tx_frames(cfg, state, dl_bits, dl_valid, dl_atten)
    sym = _assemble_stream(slots)  # [C, frames·1250]
    stream = jnp.concatenate([tx_tail.astype(sym.dtype), sym], axis=-1)
    lpf_tx = fir.resampler_lpf(spec.q, spec.p, 651)
    y = fir.polyphase_resample(stream, spec.q, spec.p, lpf_tx)
    tx = lax.slice_in_dim(y, TX_DELAY_DEV, TX_DELAY_DEV + spec.block_in,
                          axis=-1)
    if io_i16:  # DAC format, clipped like USRPifyVector
        tx = jnp.stack([jnp.real(tx), jnp.imag(tx)], axis=-1)
        tx = jnp.clip(jnp.round(tx), -32767.0, 32767.0).astype(jnp.int16)
    new_tail = sym[..., -TX_TAIL_SYM:]

    # ---- uplink (pullBuffer → detection/demod) ------------------------
    lpf_rx = fir.resampler_lpf(spec.p, spec.q, spec.taps)
    sym_ul = resample_block(ul_halo, spec.p, spec.q, lpf_rx, RX_HALO_DEV,
                            spec.block_in)
    state2, res = process_block_exact(cfg, frames, state,
                                      sym_ul[..., : spec.block_symbols])
    soft_u8 = jnp.clip(jnp.round(res.soft_bits * 255.0), 0.0, 255.0
                       ).astype(jnp.uint8)
    wire = WireBlock(res.detected, soft_u8, res.rssi, res.timing)
    return state2, tx, new_tail, wire


# ---------------------------------------------------------------------------
# single-buffer block I/O: the whole duplex block crosses the host
# boundary as ONE uint8 array each way (one DMA per direction per
# block). The uplink datagrams are built ON DEVICE in the reference's
# wire format, so the host's only work is a boolean row-select + send.
# ---------------------------------------------------------------------------

DL_ROW = 150  # per-(frame, chan, slot): 148 bit-bytes + valid + gain
UL_PKT = 158  # uplink datagram (protocol.UPLINK_LEN)
PACK_HDR = 8  # fn0 (4 bytes BE) + tx_fn0 (4 bytes BE)


def pack_dl_buffer(bits: Array, valid: Array, gain: Array, fn0: int,
                   tx_fn0: int,
                   ul_i16: np.ndarray | None = None) -> np.ndarray:
    """Host side: dense downlink window (+ optionally the uplink int16
    samples) → ONE uint8 buffer — a single host→device DMA per block.

    bits [F, C, 8, 148] uint8, valid [F, C, 8] bool, gain [F, C, 8]
    float (the wire's attenuation byte, driveTransmitPriorityQueue);
    ul_i16 int16 [C, T, 2] ADC samples appended as raw bytes."""
    f, c = bits.shape[0], bits.shape[1]
    body = np.empty((f, c, 8, DL_ROW), np.uint8)
    body[..., :148] = bits
    body[..., 148] = valid
    body[..., 149] = np.asarray(gain, np.int64) & 0xFF
    hdr = np.frombuffer(np.array([fn0, tx_fn0], ">u4").tobytes(), np.uint8)
    parts = [hdr, body.reshape(-1)]
    if ul_i16 is not None:
        parts.append(np.ascontiguousarray(ul_i16, "<i2")
                     .view(np.uint8).reshape(-1))
    return np.concatenate(parts)


def _be32(x: Array) -> Array:
    """int32 [...] → big-endian bytes [..., 4] uint8."""
    sh = [(x >> s) & 0xFF for s in (24, 16, 8, 0)]
    return jnp.stack(sh, axis=-1).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnums=(0, 1))
def duplex_block_packed(cfg: eng.TrxConfig, spec: UplinkSpec,
                        state: eng.TrxState, io_buf: Array,
                        tx_tail: Array
                        ) -> tuple[eng.TrxState, Array, Array]:
    """`duplex_block_wire` with single-buffer I/O both ways: io_buf is
    the 1-D uint8 buffer from `pack_dl_buffer(..., ul_i16=...)` —
    header + downlink window + uplink int16 ADC bytes, ONE
    host→device DMA. Returns (state', tx_tail', out) with `out` a 1-D
    uint8 buffer laid out as
      [C·block_in·4]            tx int16 I/Q bytes (DAC format)
      [F·C·8·UL_PKT]            ready-to-send uplink datagrams
      [F·C·8]                   detection mask bytes
    — one device→host DMA, parsed with `unpack_block_result`."""
    f, c = spec.frames, cfg.n_chan
    hdr = io_buf[:PACK_HDR].astype(jnp.int32)
    fn0 = (hdr[0] << 24) | (hdr[1] << 16) | (hdr[2] << 8) | hdr[3]
    tx_fn0 = (hdr[4] << 24) | (hdr[5] << 16) | (hdr[6] << 8) | hdr[7]
    dl_end = PACK_HDR + f * c * 8 * DL_ROW
    body = io_buf[PACK_HDR:dl_end].reshape(f, c, 8, DL_ROW)
    bits = body[..., :148]
    valid = body[..., 148] > 0
    atten = body[..., 149].astype(jnp.float32)
    t_halo = spec.block_in + 2 * RX_HALO_DEV
    ul_i16 = jax.lax.bitcast_convert_type(
        io_buf[dl_end: dl_end + c * t_halo * 4].reshape(c, t_halo, 2, 2),
        jnp.int16)
    state = state._replace(fn=fn0)
    state2, tx, tail2, wire = duplex_block_wire(
        cfg, spec, state, ul_i16, tx_tail, bits, valid, atten, tx_fn0,
        True)

    # device-side datagram assembly (the bytes of protocol.pack_uplink;
    # driveReceiveFIFO serialization, Transceiver52M/Transceiver.cpp:
    # 652-667)
    fns = (fn0 + jnp.arange(f, dtype=jnp.int32)) % HYPERFRAME
    fnb = jnp.broadcast_to(_be32(fns)[:, None, None, :], (f, c, 8, 4))
    tnb = jnp.broadcast_to(
        jnp.arange(8, dtype=jnp.uint8)[None, None, :, None], (f, c, 8, 1))
    rssib = (wire.rssi & 0xFF).astype(jnp.uint8)[..., None]
    toa_u = (wire.timing & 0xFFFF).astype(jnp.int32)
    toab = jnp.stack([(toa_u >> 8) & 0xFF, toa_u & 0xFF],
                     axis=-1).astype(jnp.uint8)
    nul = jnp.zeros((f, c, 8, 2), jnp.uint8)
    pkts = jnp.concatenate([tnb, fnb, rssib, toab, wire.soft_u8, nul],
                           axis=-1)  # [F, C, 8, 158]

    tx_bytes = jax.lax.bitcast_convert_type(tx, jnp.uint8)  # [C,T,2,2]
    out = jnp.concatenate([
        tx_bytes.reshape(-1), pkts.reshape(-1),
        wire.detected.astype(jnp.uint8).reshape(-1)])
    return state2, tail2, out


UL_PKT_C = UL_PKT + 2  # packed uplink row: datagram + carrier index


@functools.partial(jax.jit, static_argnums=(0, 1))
def duplex_block_compact(cfg: eng.TrxConfig, spec: UplinkSpec,
                         state: eng.TrxState, io_buf: Array,
                         tx_tail: Array
                         ) -> tuple[eng.TrxState, Array, Array, Array,
                                    Array]:
    """`duplex_block_packed` with device-side result compaction: the
    uplink datagram stream and the DAC stream cross the host boundary
    only where they carry information.

    io_buf is `pack_dl_buffer(...)` + a trailing [C] live-carrier mask
    (see `pack_dl_buffer_live`). Returns (state', tx_tail', hdr, tx_buf,
    pkt_buf):

      hdr     [8]              uint8: n_det (BE32), n_live (BE32)
      tx_buf  [C+1, block_in·4] int16-byte DAC rows, LIVE carriers
                               prefix-packed (row C is the drop slot);
      pkt_buf [F·C·8+1, 160]   ready-to-send uplink datagrams + 2-byte
                               carrier index, DETECTED rows
                               prefix-packed.

    The host fetches hdr (8 bytes), then only the first n_live tx rows
    and n_det datagram rows — D2H scales with detection density and
    non-filler tx load instead of the full F·C·8 datagram matrix + all
    C DAC rows (the dense result buffer at 128 carriers is ~14 MB per
    60 ms block). A carrier whose window AND previous window are all filler
    transmits the cached filler block host-side (the filler table is
    one constant pattern, Transceiver.cpp:69-85, so its resampled
    stream is block-periodic once the overlap tail is also filler).
    Match: driveReceiveFIFO only serializes DETECTED bursts
    (Transceiver.cpp:652-667) — the dense path shipped every slot."""
    f, c = spec.frames, cfg.n_chan
    body_end = PACK_HDR + f * c * 8 * DL_ROW
    t_halo = spec.block_in + 2 * RX_HALO_DEV
    ul_end = body_end + c * t_halo * 4
    live = io_buf[ul_end: ul_end + c] > 0  # [C]

    state2, tail2, out = duplex_block_packed(cfg, spec, state, io_buf,
                                             tx_tail)
    a = c * spec.block_in * 4
    b = a + f * c * 8 * UL_PKT
    tx_rows = out[:a].reshape(c, spec.block_in * 4)
    pkt_rows = out[a:b].reshape(f * c * 8, UL_PKT)
    det = out[b:] > 0  # [F·C·8]

    # carrier index per flattened (f, c, tn) row, as 2 BE bytes
    chan_idx = jnp.tile(jnp.repeat(jnp.arange(c, dtype=jnp.int32), 8), f)
    chan_b = jnp.stack([(chan_idx >> 8) & 0xFF, chan_idx & 0xFF],
                       axis=-1).astype(jnp.uint8)
    rows160 = jnp.concatenate([pkt_rows, chan_b], axis=-1)

    n_rows = f * c * 8
    pos = jnp.where(det, jnp.cumsum(det) - 1, n_rows)
    pkt_buf = jnp.zeros((n_rows + 1, UL_PKT_C), jnp.uint8)
    pkt_buf = pkt_buf.at[pos].set(rows160, mode="drop")

    lpos = jnp.where(live, jnp.cumsum(live) - 1, c)
    tx_buf = jnp.zeros((c + 1, spec.block_in * 4), jnp.uint8)
    tx_buf = tx_buf.at[lpos].set(tx_rows, mode="drop")

    hdr = jnp.concatenate([_be32(det.sum().astype(jnp.int32)),
                           _be32(live.sum().astype(jnp.int32))])
    return state2, tail2, hdr, tx_buf, pkt_buf


def pack_dl_buffer_live(bits: Array, valid: Array, gain: Array, fn0: int,
                        tx_fn0: int, ul_i16: np.ndarray,
                        live: np.ndarray) -> np.ndarray:
    """`pack_dl_buffer` + the [C] live-carrier mask consumed by
    `duplex_block_compact` (host-computed: a carrier is live unless its
    current AND previous downlink windows were pure filler)."""
    base = pack_dl_buffer(bits, valid, gain, fn0, tx_fn0, ul_i16=ul_i16)
    return np.concatenate([base,
                           np.asarray(live, np.uint8).reshape(-1)])


def unpack_block_result(out: np.ndarray, n_chan: int, spec: UplinkSpec
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host side: one fetched uint8 buffer → (tx int16 [C, block_in, 2],
    datagrams [F, C, 8, UL_PKT], detected [F, C, 8] bool)."""
    f, c, t = spec.frames, n_chan, spec.block_in
    a = c * t * 4
    b = a + f * c * 8 * UL_PKT
    tx = out[:a].view("<i2").reshape(c, t, 2)
    pkts = out[a:b].reshape(f, c, 8, UL_PKT)
    det = out[b:].reshape(f, c, 8).astype(bool)
    return tx, pkts, det


def _assemble_stream(slots: Array) -> Array:
    """[frames, C, 8, 157] slot windows → [C, frames·1250] stream,
    laying slots at the 157/156/156/156 offsets (overlapping final
    samples of 156-slots are already zero-masked by tx_step)."""
    from openbts_ttsou_tpu.utils.gsm_time import SLOT_SAMPLE_PATTERN

    frames, c = slots.shape[0], slots.shape[1]
    offs = np.concatenate([[0], np.cumsum(SLOT_SAMPLE_PATTERN)])[:-1]
    out = jnp.zeros((c, frames * FRAME_SYMBOLS + 1), slots.dtype)
    idx = (np.arange(frames)[:, None, None] * FRAME_SYMBOLS
           + offs[None, :, None] + np.arange(eng.SLOT_SAMPLES)[None, None, :])
    idx = np.minimum(idx, frames * FRAME_SYMBOLS)
    flat_idx = jnp.asarray(idx).reshape(-1)
    vals = jnp.moveaxis(slots, 1, 0).reshape(c, -1)
    out = out.at[:, flat_idx].add(vals)
    return out[:, :-1]


class Transceiver:
    """Stateful convenience wrapper (the `Transceiver` object of
    Transceiver52M/Transceiver.h:44, minus the threads)."""

    def __init__(self, cfg: eng.TrxConfig = eng.TrxConfig(),
                 spec: UplinkSpec = UplinkSpec()):
        self.cfg = cfg
        self.spec = spec
        self.state = eng.init_state(cfg)

    # -- control verbs (driveControl, Transceiver.cpp:423-569) ---------
    def set_slot(self, chan: int, tn: int, combo: int) -> None:
        self.state = self.state._replace(
            chan_type=self.state.chan_type.at[chan, tn].set(combo))

    def set_tsc(self, chan: int, tsc: int) -> None:
        self.state = self.state._replace(
            tsc=self.state.tsc.at[chan].set(tsc))

    def set_max_delay(self, chan: int, delay: int) -> None:
        self.state = self.state._replace(
            max_expected_delay=self.state.max_expected_delay.at[chan]
            .set(delay))

    # -- data plane ----------------------------------------------------
    def process_uplink(self, samples: Array) -> eng.RxResult:
        self.state, res = uplink_block(self.cfg, self.spec, self.state,
                                       samples)
        return res

    def rx_frame(self, frame: Array) -> eng.RxResult:
        self.state, res = eng.rx_step(self.cfg, self.state, frame)
        return res

    def tx_frame(self, bits: Array, valid: Array, atten_db: Array) -> Array:
        return eng.tx_step(self.cfg, self.state, bits, valid, atten_db,
                           self.state.fn)
