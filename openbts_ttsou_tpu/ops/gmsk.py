"""GMSK modulation and demodulation.

Reference behavior: `Transceiver/sigProcLib.cpp:411-430` (generateGSMPulse),
`:214-264` (rotation tables / GMSKRotate / GMSKReverseRotate), `:521-565`
(modulateBurst), `:507-519` (vectorSlicer), `:1056-1097` (demodulateBurst),
`:573-616` (delayVector).

Design notes
------------
* Rotation "tables" are closed-form `exp(+j·(π/2)·k/sps)` ramps computed
  at trace time (the reference's 1024-entry trig LUT + linear interp is a
  2008-era CPU trick; exact trig on the device is cheaper and differs only
  at the LUT's interpolation-error level, well inside the SNR parity
  bound).
* Everything is batched over leading axes; the per-burst fractional delay
  becomes a per-batch 21-tap depthwise convolution.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from openbts_ttsou_tpu.ops import fir

Array = jax.Array


@functools.lru_cache(maxsize=None)
def gsm_pulse(sps: int, symbol_span: int = 2) -> np.ndarray:
    """Analytic GMSK pulse approximation, energy-normalized.

    0.96·exp(−1.1380 t² − 0.527 t⁴) over `symbol_span` symbols
    (sigProcLib.cpp:411-430; invoked with span 2 at
    Transceiver52M/Transceiver.cpp:65). Returns float32 [span*sps+1].
    """
    n = sps * symbol_span + 1
    t = (np.arange(n) - (n - 1) // 2) / float(sps)
    x = 0.96 * np.exp(-1.1380 * t * t - 0.527 * t ** 4)
    x /= np.sqrt(np.sum(x * x) / sps)
    return x.astype(np.float32)


@functools.lru_cache(maxsize=None)
def rotation(n: int, sps: int) -> np.ndarray:
    """exp(+j·(π/2)·k/sps), k=0..n-1 (initGMSKRotationTables,
    sigProcLib.cpp:214-225). complex64 [n]."""
    phase = (np.pi / 2.0 / sps) * np.arange(n)
    return np.exp(1j * phase).astype(np.complex64)


def gmsk_rotate(x: Array, sps: int) -> Array:
    """π/2-per-symbol phase ramp (GMSKRotate, sigProcLib.cpp:232-247)."""
    return x * jnp.asarray(rotation(x.shape[-1], sps))


def gmsk_reverse_rotate(x: Array, sps: int) -> Array:
    """Conjugate ramp (GMSKReverseRotate, sigProcLib.cpp:249-264)."""
    return x * jnp.conj(jnp.asarray(rotation(x.shape[-1], sps)))


def modulate_burst(bits: Array, sps: int, guard_len: int = 0,
                   pulse: Array | None = None) -> Array:
    """bits → GMSK baseband waveform.

    bits: [..., N] {0,1}. Returns [..., sps*(N+guard_len)] complex64.
    Pipeline (modulateBurst, sigProcLib.cpp:521-565): ±1 impulses at sps
    spacing → π/2-per-symbol rotation → pulse-shape convolution (NO_DELAY).
    """
    bits = jnp.asarray(bits)
    n = bits.shape[-1]
    total = sps * (n + guard_len)
    x = jnp.zeros(bits.shape[:-1] + (total,), jnp.float32)
    sym = 2.0 * bits.astype(jnp.float32) - 1.0
    x = x.at[..., : n * sps : sps].set(sym)
    rot = gmsk_rotate(x.astype(jnp.complex64), sps)
    if pulse is None:
        pulse = gsm_pulse(sps)
    return fir.convolve(rot, jnp.asarray(pulse), fir.NO_DELAY, b_real=True)


def modulate_burst_np(bits: np.ndarray, sps: int,
                      guard_len: int = 0) -> np.ndarray:
    """Pure-NumPy modulator for trace-time/setup constants (e.g. the
    filler table) — same math as `modulate_burst` without touching the
    device."""
    bits = np.asarray(bits)
    n = bits.shape[-1]
    total = sps * (n + guard_len)
    x = np.zeros(bits.shape[:-1] + (total,), np.complex128)
    x[..., : n * sps : sps] = 2.0 * bits - 1.0
    x = x * rotation(total, sps)
    pulse = gsm_pulse(sps).astype(np.float64)
    start = len(pulse) // 2 if len(pulse) % 2 else len(pulse) // 2 - 1
    out = np.empty_like(x)
    for idx in np.ndindex(x.shape[:-1]):
        full = np.convolve(x[idx], pulse)
        out[idx] = full[start : start + total]
    return out.astype(np.complex64)


def vector_slicer(x: Array) -> Array:
    """Soft-output slicer: clamp(0.5·(Re{x}+1), 0, 1)
    (vectorSlicer, sigProcLib.cpp:507-519)."""
    return jnp.clip(0.5 * (jnp.real(x) + 1.0), 0.0, 1.0)


@functools.lru_cache(maxsize=None)
def _sinc_delay_base(num_taps: int = 21) -> np.ndarray:
    return np.arange(num_taps, dtype=np.float32)


def fractional_delay_kernel(frac: Array, num_taps: int = 21) -> Array:
    """Per-batch 21-tap sinc interpolation kernel delaying by `frac`.

    kernel[i] = sinc(π·(i - c - frac)) with c = num_taps//2
    (delayVector, sigProcLib.cpp:582-592). frac: [...] → [..., num_taps].
    Where |frac| ≤ 1e-2 the reference skips the filter; we emulate that
    with an exact unit impulse so jit stays branch-free.
    """
    frac = jnp.asarray(frac, jnp.float32)
    c = num_taps // 2
    i = jnp.asarray(_sinc_delay_base(num_taps))
    arg = i - c - frac[..., None]
    kernel = jnp.sinc(arg)  # sin(πx)/(πx)
    delta = (i == c).astype(jnp.float32) * jnp.ones_like(frac)[..., None]
    small = (jnp.abs(frac) <= 1e-2)[..., None]
    return jnp.where(small, delta, kernel)


def delay_vector(x: Array, delay: Array, num_taps: int = 21,
                 max_shift: int = 40) -> Array:
    """Delay each burst by a (possibly fractional) number of samples.

    x: [..., T] complex; delay: [...] float (positive = later). Matches
    delayVector (sigProcLib.cpp:573-616): a `num_taps` sinc interpolator
    at the fractional part, displaced by the integer part.

    Formulation: the fractional part is a per-burst `num_taps`-tap sinc
    convolution; the integer part is a radix-9 shift — two 9-way
    one-hot select-accumulate stages (k = 9·q + r) over stride-1
    slices, instead of a per-row dynamic gather of [B, T]; folding the
    integer shift into one (num_taps + 2·max_shift)-tap kernel would
    cost 101-tap dense FMAs for 21 live taps.
    Integer shifts beyond ±max_shift clamp (the engine bounds TOA by
    the correlation window / SETMAXDELAY well inside that).
    """
    x = jnp.asarray(x)
    t = x.shape[-1]
    delay = jnp.broadcast_to(jnp.asarray(delay, jnp.float32), x.shape[:-1])
    int_off = jnp.clip(jnp.floor(delay), -max_shift, max_shift
                       ).astype(jnp.int32)
    frac = delay - jnp.floor(delay)
    kernel = fractional_delay_kernel(frac, num_taps)
    y = fir.convolve(x, kernel.astype(jnp.complex64), fir.NO_DELAY,
                     b_real=True)

    # integer shift y[t] -> y[t - k], zero outside, as two one-hot
    # stages: k = (9·a − 4·9) + (r − 4) with a, r ∈ [0, 9)
    radix = 9
    assert 2 * max_shift + 1 <= radix * radix
    base = radix // 2 * radix  # 36
    ka = (int_off + base + radix // 2) // radix  # [0, 9)
    kr = (int_off + base + radix // 2) % radix  # [0, 9)
    pad = [(0, 0)] * (x.ndim - 1)
    yp = jnp.pad(y, pad + [(base + radix // 2, base + radix // 2)])
    mid = None
    for a in range(radix):
        sel = (ka == a).astype(jnp.float32)[..., None]
        s = jax.lax.slice_in_dim(yp, 2 * base - radix * a,
                                 2 * base - radix * a + t + radix - 1,
                                 axis=-1)
        mid = s * sel if mid is None else mid + s * sel
    out = None
    for r in range(radix):
        sel = (kr == r).astype(jnp.float32)[..., None]
        s = jax.lax.slice_in_dim(mid, radix - 1 - r, radix - 1 - r + t,
                                 axis=-1)
        out = s * sel if out is None else out + s * sel
    return out


def decimate(x: Array, factor: int) -> Array:
    """Every factor-th sample (decimateVector, sigProcLib.cpp:1039-1053)."""
    if factor <= 1:
        return x
    return x[..., ::factor]


def demodulate_burst(x: Array, sps: int, channel: Array, toa: Array) -> Array:
    """Coherent GMSK demod to soft bits in [0,1].

    x: [..., T]; channel: [...] complex gain; toa: [...] samples.
    (demodulateBurst, sigProcLib.cpp:1056-1097): scale by 1/channel →
    delay by −TOA → reverse-rotate → decimate to 1 sps → slicer.
    Returns [..., T//sps] float32.
    """
    x = jnp.asarray(x)
    ch = jnp.asarray(channel, jnp.complex64)
    y = x / ch[..., None]
    y = delay_vector(y, -jnp.asarray(toa, jnp.float32))
    y = gmsk_reverse_rotate(y, sps)
    y = decimate(y, sps)
    return vector_slicer(y)
