"""Slow, direct NumPy golden model of the reference DSP semantics.

Hand-written from the documented behavior of Transceiver/sigProcLib.cpp
(see SURVEY.md §2.1); used only to validate the JAX kernels on small
inputs. Deliberately scalar/loopy so it mirrors the C++ exactly.
"""

import numpy as np


def conv_full(a, b):
    """y[t] = Σ_k a[t−k]·b[k], length La+Lb−1."""
    return np.convolve(a, b)


def convolve_mode(a, b, mode, start=None, length=None):
    La, Lb = len(a), len(b)
    full = np.convolve(a, b)
    if mode == "full":
        s, n = 0, La + Lb - 1
    elif mode == "overlap":
        s, n = La, abs(La - Lb) + 1
    elif mode == "start":
        s, n = 0, La
    elif mode == "with_tail":
        s, n = Lb, La
    elif mode == "no_delay":
        s, n = (Lb // 2 if Lb % 2 else Lb // 2 - 1), La
    elif mode == "custom":
        s, n = start, length
    out = np.zeros(n, dtype=full.dtype)
    for i in range(n):
        if 0 <= s + i < len(full):
            out[i] = full[s + i]
    return out


def gsm_pulse(sps, span=2):
    n = sps * span + 1
    t = (np.arange(n) - (n - 1) // 2) / sps
    x = 0.96 * np.exp(-1.1380 * t * t - 0.527 * t ** 4)
    return x / np.sqrt(np.sum(x * x) / sps)


def modulate_burst(bits, sps, guard=0, pulse=None):
    n = len(bits)
    x = np.zeros(sps * (n + guard), dtype=np.complex128)
    x[: n * sps : sps] = 2.0 * np.asarray(bits) - 1.0
    rot = np.exp(1j * (np.pi / 2 / sps) * np.arange(len(x)))
    x *= rot
    if pulse is None:
        pulse = gsm_pulse(sps)
    return convolve_mode(x, pulse, "no_delay")


def polyphase_resample(x, p, q, lpf):
    """Direct transcription of the branch-indexed loop
    (sigProcLib.cpp:1177-1205)."""
    n_out = int(np.ceil(len(x) * p / q))
    out = np.zeros(n_out, dtype=np.complex128)
    out_ix = (len(lpf) - 1) // 2 // q
    for n in range(n_out):
        i = out_ix + n
        branch = (i * q) % p
        input_offset = (i * q - branch) // p
        in_i = input_offset
        f_i = branch
        while in_i >= len(x):
            in_i -= 1
            f_i += p
        s = 0.0 + 0.0j
        while in_i >= 0 and f_i < len(lpf):
            s += x[in_i] * lpf[f_i]
            in_i -= 1
            f_i += p
        out[n] = s
    return out


def delay_vector(x, delay):
    int_off = int(np.floor(delay))
    frac = delay - int_off
    if abs(frac) > 1e-2:
        k = np.sinc(np.arange(21) - 10 - frac)
        shifted = convolve_mode(x, k, "no_delay")
    else:
        shifted = x.copy()
    out = np.zeros_like(x)
    for i in range(len(x)):
        j = i - int_off
        if 0 <= j < len(shifted):
            out[i] = shifted[j]
    return out


def sinc_interpolate(x, ix):
    start = max(int(np.floor(ix)) - 10, 0)
    end = min(int(np.floor(ix)) + 11, len(x) - 1)
    val = 0.0 + 0.0j
    for i in range(start, end):
        val += x[i] * np.sinc(i - ix)
    return val
