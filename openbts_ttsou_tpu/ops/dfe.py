"""Decision-feedback equalizer: design + burst equalization.

Reference behavior: `Transceiver/sigProcLib.cpp:1246-1340` (designDFE,
the Al-Dhahir & Cioffi Cholesky-factor recursion) and `:1343-1399`
(equalizeBurst).

Design notes
------------
* `design_dfe` is a short static recursion (Nf=7 unrolled at trace time),
  batched over channels with `vmap` — it runs off the per-burst hot path
  exactly as the reference re-estimates only every 50 frames
  (Transceiver52M/Transceiver.cpp:313).
* `equalize_burst`'s per-symbol feedback loop is a `lax.scan` whose carry
  is the ring of the last nu rotated hard decisions; everything before it
  (feedforward filter) is a batched convolution.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from openbts_ttsou_tpu.ops import fir, gmsk

Array = jax.Array


def design_dfe_single(chan: Array, snr: Array, nf: int = 7):
    """DFE design for one channel response.

    chan: [L] complex (symbol-spaced); snr: scalar linear SNR estimate.
    Returns (feedforward [nf], feedback [L-1]) complex64.
    Direct functional transcription of designDFE
    (sigProcLib.cpp:1246-1340).
    """
    chan = jnp.asarray(chan, jnp.complex64)
    nu = chan.shape[-1] - 1
    assert nu + 1 <= nf, "channel longer than feedforward span"

    g0 = jnp.zeros(nf, jnp.complex64).at[0].set(
        (1.0 / jnp.sqrt(jnp.asarray(snr, jnp.float32))).astype(jnp.complex64))
    g1 = jnp.zeros(nf, jnp.complex64).at[: nu + 1].set(jnp.conj(chan))

    rows = []
    d = jnp.float32(1.0)
    for i in range(nf):
        d = jnp.abs(g0[0]) ** 2 + jnp.abs(g1[0]) ** 2
        li = jnp.zeros(nf + nu, jnp.complex64)
        span = min(nf, nf + nu - i)  # iterator-bound guard (cpp:1276)
        li = li.at[i : i + span].set(
            ((g0 * jnp.conj(g0[0]) + g1 * jnp.conj(g1[0])) / d)[:span])
        rows.append(li)
        k = g1[0] / g0[0]
        if i != nf - 1:
            norm = 1.0 / jnp.sqrt(1.0 + jnp.abs(k) ** 2)
            g0n = (g1 * jnp.conj(k) + g0) * norm
            g1n = (g1 - k * g0) * norm
            # delayVector(G1new, -1.0): advance one symbol, zero-fill tail
            g1n = jnp.concatenate([g1n[1:], jnp.zeros(1, jnp.complex64)])
            g0, g1 = g0n, g1n

    ll = jnp.stack(rows)  # [nf, nf+nu]
    feedback = -jnp.conj(ll[nf - 1, nf : nf + nu])

    v = jnp.zeros(nf, jnp.complex64).at[nf - 1].set(1.0)
    for kk in range(nf - 2, -1, -1):
        acc = -jnp.sum(v[kk + 1 : nf] * ll[kk, kk + 1 : nf])
        v = v.at[kk].set(acc)

    w = []
    for i in range(nf):
        end = min(nu, nf - 1 - i)
        wi = jnp.sum(v[i : i + end + 1] * jnp.conj(chan[: end + 1]))
        w.append(wi / d)
    feedforward = jnp.stack(w)
    return feedforward.astype(jnp.complex64), feedback.astype(jnp.complex64)


def design_dfe(chan: Array, snr: Array, nf: int = 7):
    """Batched DFE design. chan: [..., L]; snr: [...].
    Returns (feedforward [..., nf], feedback [..., L-1])."""
    chan = jnp.asarray(chan)
    lead = chan.shape[:-1]
    if not lead:
        return design_dfe_single(chan, snr, nf)
    f = jax.vmap(lambda c, s: design_dfe_single(c, s, nf))
    c2 = chan.reshape((-1, chan.shape[-1]))
    s2 = jnp.broadcast_to(jnp.asarray(snr), lead).reshape(-1)
    w, b = f(c2, s2)
    return (w.reshape(lead + w.shape[-1:]), b.reshape(lead + b.shape[-1:]))


def equalize_burst(burst: Array, toa: Array, sps: int, feedforward: Array,
                   feedback: Array) -> Array:
    """DFE equalization to soft bits in [0,1].

    burst: [B, T] complex (symbol-rate after the feedforward stage — the
    reference asserts symbol-spaced input); toa: [B]; feedforward [B, Nf];
    feedback [B, nu]. (equalizeBurst, sigProcLib.cpp:1343-1399.)
    """
    burst = jnp.asarray(burst)
    assert burst.ndim == 2, "equalize_burst expects [batch, time]"
    bsz, t = burst.shape
    nf = feedforward.shape[-1]
    nu = feedback.shape[-1]

    x = gmsk.delay_vector(burst, -jnp.asarray(toa, jnp.float32))
    pf_full = fir.convolve(x, jnp.asarray(feedforward), fir.FULL_SPAN)
    pf = pf_full[..., nf - 1 : nf - 1 + t]  # [B, T]

    rot = jnp.asarray(gmsk.rotation(t, sps))  # [T]
    b = jnp.asarray(feedback)  # [B, nu]

    def step(hist, inp):
        # hist: [B, nu] rotated hard decisions, hist[:,0] = previous symbol
        pf_t, rot_t, rev_t = inp
        d = pf_t + jnp.sum(b * hist, axis=-1)
        soft_pre = d * rev_t
        dec = jnp.where(jnp.real(soft_pre) > 0.0, 1.0, -1.0).astype(
            jnp.complex64)
        hist = jnp.concatenate([(dec * rot_t)[:, None], hist[:, :-1]], axis=1)
        return hist, soft_pre

    hist0 = jnp.zeros((bsz, nu), jnp.complex64)
    inputs = (pf.T, rot, jnp.conj(rot))
    _, soft_pre = jax.lax.scan(step, hist0, inputs)
    return gmsk.vector_slicer(soft_pre.T)  # [B, T]
