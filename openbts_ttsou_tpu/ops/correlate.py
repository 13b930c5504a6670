"""Burst detection: templates, peak detection, RACH/TSC correlators.

Reference behavior: `Transceiver/sigProcLib.cpp:779-857` (midamble/RACH
template generation), `:663-711` (peakDetect + early-late sinc
interpolation), `:860-932` (detectRACHBurst, energyDetect), `:935-1037`
(analyzeTrafficBurst + channel estimation). The 52M variant's windowed
correlation (CUSTOM span, `Transceiver52M/sigProcLib.cpp:983-1000`) is
available through `max_toa`.

Design notes
------------
* Correlations are batched grouped convolutions; per-burst templates
  (one TSC per channel) use the depthwise path.
* The reference's early-late peak refinement (to 1/1024 sample) is kept
  as the same 9-step halving descent, but vectorized over the whole
  burst batch: each step evaluates two 21-tap sinc interpolations from
  one pre-extracted 25-sample window per burst. (An earlier dense
  `[21, 2049]` sinc-bank-matmul variant had the same precision but
  ~10× the memory traffic; the faithful descent is both cheaper and
  closer to the reference's tie-break behavior.)
* Detection decisions stay as masks/soft booleans; no data-dependent
  control flow, so thousands of channels batch cleanly.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from openbts_ttsou_tpu.ops import fir
from openbts_ttsou_tpu.utils import constants as C

Array = jax.Array

PEAK_GRID_STEP = 1.0 / 1024.0  # reference precision (sigProcLib.cpp:688)
PEAK_GRID_HALF = 1024  # search ±1 sample around the integer peak
SINC_HALF_WIDTH = 10  # interpolatePoint window (sigProcLib.cpp:643-645)


# ---------------------------------------------------------------------------
# numpy-side template generation (trace-time constants, like the
# reference's sigProcLibSetup/generateMidamble/generateRACHSequence)
# ---------------------------------------------------------------------------

def _np_modulate(bits: np.ndarray, sps: int, pulse: np.ndarray | None) -> np.ndarray:
    n = len(bits)
    x = np.zeros(sps * n, dtype=np.complex128)
    x[:: sps] = 2.0 * bits - 1.0
    x *= np.exp(1j * (np.pi / 2 / sps) * np.arange(len(x)))
    if pulse is None:
        return x
    full = np.convolve(x, pulse)
    start = len(pulse) // 2 if len(pulse) % 2 else len(pulse) // 2 - 1
    return full[start : start + len(x)]


def _np_peak(x: np.ndarray):
    """Integer+fractional peak of |x|² via dense sinc-grid refinement."""
    p = np.abs(x) ** 2
    i0 = int(np.argmax(p))
    offs = np.arange(-PEAK_GRID_HALF, PEAK_GRID_HALF + 1) * PEAK_GRID_STEP
    vals = np.zeros(len(offs), dtype=np.complex128)
    for k, off in enumerate(offs):
        ix = i0 + off
        lo = max(int(np.floor(ix)) - SINC_HALF_WIDTH, 0)
        hi = min(int(np.floor(ix)) + SINC_HALF_WIDTH + 1, len(x) - 1)
        idx = np.arange(lo, hi)
        vals[k] = np.sum(x[idx] * np.sinc(idx - ix))
    kbest = int(np.argmax(np.abs(vals) ** 2))
    return vals[kbest], i0 + offs[kbest]


@dataclasses.dataclass(frozen=True)
class CorrelationTemplate:
    """A detection template: waveform + autocorrelation gain and TOA
    (reference: CorrelationSequence, sigProcLib.cpp:52-56)."""

    sequence: np.ndarray  # complex64 [L]
    gain: complex
    toa: float


@functools.lru_cache(maxsize=None)
def midamble_template(tsc: int, sps: int) -> CorrelationTemplate:
    """Midamble correlation template for TSC 0-7.

    (generateMidamble, sigProcLib.cpp:779-828): the template is the
    middle 16 bits of the 26-bit TSC modulated with a unit pulse and
    scaled by −1 (the +180° phase of a sequence starting at symbol 66);
    its gain/TOA come from correlating against the full pulse-shaped
    26-bit midamble scaled by +j (+90° at symbol 61).
    """
    from openbts_ttsou_tpu.ops.gmsk import gsm_pulse

    assert 0 <= tsc <= 7
    bits = C.TRAINING_SEQUENCE[tsc].astype(np.float64)
    middle = -1.0 * _np_modulate(bits[5:21], sps, None)
    midamble = 1j * _np_modulate(bits, sps, gsm_pulse(sps).astype(np.float64))
    autocorr = np.convolve(midamble, np.conj(middle[::-1]))
    start = (len(middle) // 2) if len(middle) % 2 else (len(middle) // 2 - 1)
    autocorr = autocorr[start : start + len(midamble)]
    gain, toa = _np_peak(autocorr)
    return CorrelationTemplate(middle.astype(np.complex64), complex(gain),
                               float(toa) - 5 * sps)


@functools.lru_cache(maxsize=None)
def rach_template(sps: int) -> CorrelationTemplate:
    """RACH synch-sequence template (generateRACHSequence,
    sigProcLib.cpp:830-857)."""
    from openbts_ttsou_tpu.ops.gmsk import gsm_pulse

    bits = C.RACH_SYNCH_SEQUENCE.astype(np.float64)
    seq = _np_modulate(bits, sps, gsm_pulse(sps).astype(np.float64))
    autocorr = np.convolve(seq, np.conj(seq[::-1]))
    start = (len(seq) // 2) if len(seq) % 2 else (len(seq) // 2 - 1)
    autocorr = autocorr[start : start + len(seq)]
    gain, toa = _np_peak(autocorr)
    return CorrelationTemplate(seq.astype(np.complex64), complex(gain), float(toa))


@functools.lru_cache(maxsize=None)
def midamble_bank(sps: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All 8 TSC templates stacked: (sequences [8, 16*sps], gains [8],
    toas [8]) for gather-by-TSC batched correlation."""
    ts = [midamble_template(t, sps) for t in range(8)]
    return (
        np.stack([t.sequence for t in ts]),
        np.array([t.gain for t in ts], np.complex64),
        np.array([t.toa for t in ts], np.float32),
    )


# ---------------------------------------------------------------------------
# batched device kernels
# ---------------------------------------------------------------------------

EARLY_LATE_STEPS = 9  # incr 0.5 … 1/512 (the while > 1/1024 loop)
_ELW = 25  # floor(ix) ∈ [i0−2, i0+1] → absolute taps i0−12 … i0+11


def peak_detect(x: Array):
    """Batched peak detection with fractional refinement.

    x: [..., T] complex. Returns (peak_val complex [...],
    peak_idx float32 [...], avg_pwr float32 [...]).
    Matches peakDetect (sigProcLib.cpp:663-711): integer argmax of |x|²,
    then the reference's early-late sinc-balancing descent to 1/1024
    sample — vectorized as 9 fixed halving steps with a done-mask in
    place of the data-dependent `while`/`break`. avg power excludes the
    (interpolated) peak sample.

    The early/late positions stay within ±2 samples of the integer
    peak, so every interpolatePoint evaluation (sigProcLib.cpp:639-659,
    21 taps at [⌊ix⌋−10, min(⌊ix⌋+11, T−1))) reads from one fixed
    25-sample window around i0, extracted once as fused stencil
    reductions — no [.., 25, T] materialization and no per-row gather.
    """
    x = jnp.asarray(x)
    t = x.shape[-1]
    xr = jnp.real(x).astype(jnp.float32)
    xi = jnp.imag(x).astype(jnp.float32)
    p = xr * xr + xi * xi
    i0 = jnp.argmax(p, axis=-1)  # [...]
    sum_power = jnp.sum(p, axis=-1)

    half = (_ELW - 1) // 2  # 12
    onehot = (jnp.arange(t) == i0[..., None]).astype(jnp.float32)
    pad = [(0, 0)] * (x.ndim - 1) + [(half, half)]
    xrp, xip = jnp.pad(xr, pad), jnp.pad(xi, pad)
    win_r = jnp.stack(
        [jnp.sum(onehot * jax.lax.slice_in_dim(xrp, j, j + t, axis=-1),
                 axis=-1) for j in range(_ELW)], axis=-1)
    win_i = jnp.stack(
        [jnp.sum(onehot * jax.lax.slice_in_dim(xip, j, j + t, axis=-1),
                 axis=-1) for j in range(_ELW)], axis=-1)
    j_abs = (i0[..., None].astype(jnp.float32) - half
             + jnp.arange(_ELW, dtype=jnp.float32))  # [..., 25]

    def interp(ix):
        """interpolatePoint at per-burst fractional index ix [...]."""
        fl = jnp.floor(ix)[..., None]
        lo = jnp.maximum(fl - SINC_HALF_WIDTH, 0.0)
        hi = jnp.minimum(fl + SINC_HALF_WIDTH + 1.0, float(t - 1))
        taps = jnp.sinc(j_abs - ix[..., None])
        taps = jnp.where((j_abs >= lo) & (j_abs < hi), taps, 0.0)
        return (jnp.sum(win_r * taps, axis=-1),
                jnp.sum(win_i * taps, axis=-1))

    early = i0.astype(jnp.float32) - 1.0
    done = jnp.zeros(x.shape[:-1], bool)
    incr = 0.5
    for _ in range(EARLY_LATE_STEPS):
        er, ei = interp(early)
        lr, li = interp(early + 2.0)
        e2 = er * er + ei * ei
        l2 = lr * lr + li * li
        step = jnp.where(e2 < l2, incr, -incr)
        done = done | (e2 == l2)  # the reference's `else break`
        early = jnp.where(done, early, early + step)
        incr *= 0.5
    peak_idx = early + 1.0
    vr, vi = interp(peak_idx)
    peak_val = (vr + 1j * vi).astype(jnp.complex64)
    avg_pwr = (sum_power - (vr * vr + vi * vi)) / (t - 1)
    return peak_val, peak_idx, avg_pwr


def energy_detect(x: Array, window: int, threshold: Array):
    """(detected bool [...], avg_pwr f32 [...]) — mean power over the
    first `window` samples vs threshold² (energyDetect,
    sigProcLib.cpp:916-932)."""
    x = jnp.asarray(x)
    w = min(window, x.shape[-1])
    avg = jnp.mean(jnp.abs(x[..., :w]) ** 2, axis=-1)
    thr = jnp.asarray(threshold, jnp.float32)
    return avg > thr * thr, avg


@dataclasses.dataclass
class Detection:
    """Batched detection result (all fields [...])."""

    detected: Array  # bool
    amplitude: Array  # complex64 — peak / template gain
    toa: Array  # float32 — samples, template-compensated
    peak_to_mean: Array  # float32


def _valley_power(corr: Array, peak_int: Array, offsets: np.ndarray):
    """Σ|corr[peak+o]|² over in-range offsets; returns (power, count).

    Gather-free: the offset sum is a sliding mask convolution of |corr|²
    (shift-and-accumulate over static offsets) evaluated at the peak via
    a one-hot contraction; the in-range count per position is a static
    table contracted the same way.
    """
    t = corr.shape[-1]
    p2 = jnp.abs(corr) ** 2
    lo, hi = int(offsets.min()), int(offsets.max())
    pad = [(0, 0)] * (corr.ndim - 1) + [(-lo if lo < 0 else 0,
                                         hi if hi > 0 else 0)]
    pp = jnp.pad(p2, pad)
    base = -lo if lo < 0 else 0
    acc = None
    for o in offsets.tolist():
        s = jax.lax.slice_in_dim(pp, base + o, base + o + t, axis=-1)
        acc = s if acc is None else acc + s
    # count[i] = #offsets with 0 <= i + o < t — static per position
    pos = np.arange(t)[:, None] + offsets[None, :]
    count_tab = jnp.asarray(((pos >= 0) & (pos < t)).sum(-1)
                            .astype(np.float32))
    onehot = (jnp.arange(t) == peak_int[..., None]).astype(jnp.float32)
    power = jnp.einsum("...t,...t->...", onehot, acc,
                       precision=jax.lax.Precision.HIGHEST)
    count = jnp.einsum("...t,t->...", onehot, count_tab,
                       precision=jax.lax.Precision.HIGHEST)
    return power, count


def detect_rach(burst: Array, sps: int,
                threshold: float = C.RACH_DETECT_THRESHOLD) -> Detection:
    """Batched RACH burst detection (detectRACHBurst,
    sigProcLib.cpp:860-914).

    burst: [..., T] complex. Correlates against the RACH synch template,
    peak-detects, and tests peak/RMS over the "valley" (symbols 57-107
    after the peak). TOA is compensated by the template TOA + 8 symbols.
    """
    tmpl = rach_template(sps)
    corr = fir.correlate(burst, jnp.asarray(tmpl.sequence), fir.NO_DELAY)
    peak_val, peak_idx, _ = peak_detect(corr)
    peak_int = jnp.round(peak_idx).astype(jnp.int32)

    offsets = np.arange(57 * sps, 107 * sps + 1)
    valley, count = _valley_power(corr, peak_int, offsets)
    rms = jnp.sqrt(valley / jnp.maximum(count, 1)) + 1e-5
    peak_to_mean = jnp.abs(peak_val) / rms

    t = corr.shape[-1]
    ok = (peak_idx >= 0) & (peak_idx <= t) & (count >= 2)
    detected = ok & (peak_to_mean > threshold)
    amplitude = jnp.where(ok, peak_val / tmpl.gain, 0.0)
    toa = peak_idx - tmpl.toa - 8 * sps
    return Detection(detected, amplitude.astype(jnp.complex64), toa,
                     peak_to_mean)


# Normal-burst correlation geometry (analyzeTrafficBurst,
# sigProcLib.cpp:951,1000): correlate a 36-symbol segment starting at
# symbol 56; the midamble TSC starts 10 symbols in (61 − 5 for the
# template's 16-bit middle − ... folded into template TOA).
TSC_SEGMENT_START = 56
TSC_SEGMENT_LEN = 36
TSC_SEGMENT_OFFSET = 10  # (66 − 56) symbols

# Correlation index of a TOA-0 midamble, modulo the template's
# sub-sample TOA: the 16·sps-bit middle sequence peaks 8·sps into its
# NO_DELAY correlation (all 8 template TOAs round to 8·sps — the 52M
# expectedTOAPeak constant, Transceiver52M/sigProcLib.cpp:992).
TSC_PEAK_SYMBOL = 8


def analyze_traffic_burst(burst: Array, tsc, sps: int,
                          threshold: float = C.TSC_DETECT_THRESHOLD,
                          estimate_channel: bool = False,
                          chan_taps_symbols: int = 6,
                          max_toa: int | None = None,
                          gate_estimation: Array | None = None):
    """Batched normal-burst midamble detection + channel estimation.

    burst: [..., T] complex; tsc: int or int32 [...] per-burst TSC.
    Returns (Detection, channel_response [..., chan_taps_symbols*sps] or
    None, chan_resp_offset [...] or None).
    (analyzeTrafficBurst, sigProcLib.cpp:935-1037.)

    max_toa (static, in samples — the reference hands the SETMAXDELAY
    symbol count straight to this samples-typed parameter,
    Transceiver52M/Transceiver.cpp:324-330,483) enables the 52M windowed
    correlation (Transceiver52M/sigProcLib.cpp:983-1000): the value is
    clamped to ≥3·sps, the burst segment spans 66±max(maxTOA, 5·sps)
    symbols, and only the 2·maxTOA+1 lags around the expected peak are
    searched — detections, the valley-power in-range count, and the
    channel-estimate window guards are all confined to that window
    exactly as the reference's CUSTOM-span correlation confines them.
    `None` keeps the 64M full-segment geometry (±10-symbol span).

    gate_estimation (optional scalar bool array): when given, the whole
    channel-estimation tail (fractional un-delay + candidate-window
    energy search) runs under a `lax.cond` and is skipped at runtime
    when False — the reference only estimates when a slot needs a DFE
    re-estimate (needDFE && aged/invalid, Transceiver.cpp:311-330), so
    most frames skip it, and the skip saves the estimation tail's
    memory traffic.
    """
    seqs, gains, toas = midamble_bank(sps)
    burst = jnp.asarray(burst)
    lead = burst.shape[:-1]
    if isinstance(tsc, (int, np.integer)):
        seq = jnp.broadcast_to(jnp.asarray(seqs[tsc]), lead + seqs.shape[-1:])
        gain = jnp.asarray(gains[tsc])
        tmpl_toa = jnp.asarray(toas[tsc])
    else:
        tsc = jnp.asarray(tsc)
        seq = jnp.asarray(seqs)[tsc]  # [..., L]
        gain = jnp.asarray(gains)[tsc]
        tmpl_toa = jnp.asarray(toas)[tsc]

    if max_toa is None:
        span = TSC_SEGMENT_OFFSET * sps  # the 64M fixed ±10-symbol span
        mt = span  # every lag of the segment participates
    else:
        # maxTOA < 3*samplesPerSymbol → 3*samplesPerSymbol; spanTOA ≥
        # 5*samplesPerSymbol (Transceiver52M/sigProcLib.cpp:982-985)
        mt = max(int(max_toa), 3 * sps)
        span = max(mt, 5 * sps)
    seg = burst[..., 66 * sps - span: (66 + 16) * sps + span]
    corr = fir.correlate(seg, seq, fir.NO_DELAY)
    if max_toa is not None:
        # keep the 2·maxTOA+1 lags around the expected TOA-0 peak — the
        # CUSTOM-span window (corrLen, startIx = expectedTOAPeak−maxTOA)
        center = TSC_PEAK_SYMBOL * sps + span
        corr = corr[..., center - mt: center + mt + 1]
    peak_val, peak_idx, _ = peak_detect(corr)
    peak_int = jnp.round(peak_idx).astype(jnp.int32)

    # Valley: ±(2..5) symbols around the peak (sigProcLib.cpp:970-980).
    offs = np.arange(2 * sps, 5 * sps + 1)
    offsets = np.concatenate([-offs[::-1], offs])
    valley, count = _valley_power(corr, peak_int, offsets)
    rms = jnp.sqrt(valley / jnp.maximum(count, 1)) + 1e-5
    peak_to_mean = jnp.abs(peak_val) / rms

    t = corr.shape[-1]
    ok = (peak_idx >= 0) & (peak_idx <= t) & (count >= 2)
    detected = ok & (peak_to_mean > threshold)
    amplitude = jnp.where(ok, peak_val / gain, 0.0).astype(jnp.complex64)
    if max_toa is None:
        # TOA-0 peak sits at template_toa + span in segment coordinates
        toa = peak_idx - tmpl_toa - span
    else:
        # restricted coordinates: the window starts maxTOA lags before
        # the expected peak, so TOA = peak − maxTOA (sigProcLib.cpp:1039)
        # — template-compensated like the unrestricted path (the 8
        # sub-sample template TOAs differ from 8·sps by <0.01 samples)
        toa = peak_idx - mt - (tmpl_toa - TSC_PEAK_SYMBOL * sps)
    det = Detection(detected, amplitude, toa, peak_to_mean)
    if not estimate_channel:
        return det, None, None

    # Channel estimation (sigProcLib.cpp:1005-1031): un-delay the
    # correlation, then slide a 6-symbol window over 7 candidate
    # positions, keeping the last window whose energy exceeds 95% of the
    # running max (the reference loop's exact tie-break).
    #
    # Gather-free window extraction: the candidate start indices
    # floor(toa_offset) + (i−5)·sps only span a small STATIC range (the
    # 8 template TOAs are trace-time constants), so the per-burst
    # windows come from a one-hot contraction against statically-sliced
    # shifted copies — never a take_along_axis over the burst batch.
    if max_toa is None:
        toa_offset = jnp.broadcast_to(
            jnp.asarray(tmpl_toa, jnp.float32) + span, lead)
        all_offs = toas + span  # [8] trace-time consts
    else:
        # restricted window: TOAoffset = maxTOA exactly (the 52M
        # requestChannel anchor, Transceiver52M/sigProcLib.cpp:1046)
        toa_offset = jnp.full(lead, float(mt), jnp.float32)
        all_offs = np.array([float(mt)], np.float32)
    nw = chan_taps_symbols * sps

    def _estimate(_):
        return _estimate_channel(corr, toa, gain, toa_offset, all_offs,
                                 nw, sps, t, lead)

    if gate_estimation is None:
        chan, chan_offset = _estimate(None)
    else:
        chan, chan_offset = jax.lax.cond(
            gate_estimation, _estimate,
            lambda _: (jnp.zeros(lead + (nw,), jnp.complex64),
                       jnp.zeros(lead, jnp.float32)),
            operand=None)
    return det, chan, chan_offset


def _estimate_channel(corr, toa, gain, toa_offset, all_offs, nw, sps, t,
                      lead):
    """The channel-estimation tail of analyze_traffic_burst
    (sigProcLib.cpp:1005-1031), split out so callers can gate it."""
    from openbts_ttsou_tpu.ops.gmsk import delay_vector

    corr_d = delay_vector(corr, -toa)
    # window starts: floor(toa_offset + (i−5)*sps), i = 0..6
    starts = jnp.floor(toa_offset[..., None]).astype(jnp.int32) \
        + (jnp.arange(7) - 5) * sps
    in_range = (starts >= 0) & (starts + nw <= t)  # [..., 7]
    # static bound on every possible start value
    v_lo = int(np.floor(all_offs.min())) - 5 * sps
    v_hi = int(np.floor(all_offs.max())) + 1 * sps
    v_vals = np.arange(v_lo, v_hi + 1)  # [V]
    # shifted copies corr_pad[..., v + u] for u < nw, clamped in-range
    pad_l = max(0, -v_lo)
    pad_r = max(0, v_hi + nw - t)
    pad = [(0, 0)] * (corr_d.ndim - 1) + [(pad_l, pad_r)]
    corr_p = jnp.pad(corr_d, pad)
    wins_v = jnp.stack(
        [jax.lax.slice_in_dim(corr_p, pad_l + v, pad_l + v + nw, axis=-1)
         for v in v_vals.tolist()], axis=-2)  # [..., V, nw]
    onehot = (starts[..., :, None] ==
              jnp.asarray(v_vals)).astype(jnp.float32)  # [..., 7, V]
    wins_v = jnp.broadcast_to(wins_v, lead + wins_v.shape[-2:])
    wins = (jnp.einsum("...iv,...vu->...iu", onehot,
                       jnp.real(wins_v),
                       precision=jax.lax.Precision.HIGHEST)
            + 1j * jnp.einsum("...iv,...vu->...iu", onehot,
                              jnp.imag(wins_v),
                              precision=jax.lax.Precision.HIGHEST)
            ).astype(jnp.complex64)  # [..., 7, nw]
    energies = jnp.where(in_range,
                         jnp.sum(jnp.abs(wins) ** 2, axis=-1), -jnp.inf)

    def body(i, carry):
        max_e, max_i = carry
        e = energies[..., i]
        take = e > 0.95 * max_e
        return jnp.where(take, jnp.maximum(e, max_e), max_e), \
            jnp.where(take, i, max_i)

    max_e = jnp.full(lead, -jnp.inf)
    max_i = jnp.full(lead, -1, jnp.int32)
    for i in range(7):
        max_e, max_i = body(i, (max_e, max_i))

    pick_i = (jnp.arange(7) == (max_i % 7)[..., None]
              ).astype(jnp.float32)  # [..., 7]
    chan = (jnp.einsum("...i,...iu->...u", pick_i, jnp.real(wins),
                       precision=jax.lax.Precision.HIGHEST)
            + 1j * jnp.einsum("...i,...iu->...u", pick_i, jnp.imag(wins),
                              precision=jax.lax.Precision.HIGHEST)
            ).astype(jnp.complex64)
    chan = chan / (gain[..., None] if gain.ndim else gain)
    # offset = 5·sps − maxI (sigProcLib.cpp:1029, exact formula)
    chan_offset = (5 * sps - max_i).astype(jnp.float32)
    return chan.astype(jnp.complex64), chan_offset
