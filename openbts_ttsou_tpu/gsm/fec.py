"""FEC primitives: CRC/Fire parity, convolutional coding, Viterbi, interleaving.

Reference behavior: `CommonLibs/BitVector.{h,cpp}` — `Generator` LFSR
(BitVector.h:35-87), `Parity` (BitVector.h:94), convolutional `encode`
(BitVector.cpp:217), `ViterbiR2O4` rate-1/2 K=5 soft decoder
(BitVector.h:121, BitVector.cpp:289-525) — and the GSM 05.03 interleaving
formulas of `GSM/GSML1FEC.cpp:616-630,811-822,1106-1120,1380-1393`.

Design notes
------------
* The Viterbi decoder is a `lax.scan` over the coded sequence with carry
  (path costs [B,16], path-history registers [B,16]); it reproduces the
  reference's *deferred-decision* decoder (deferral 24, emit the bit 24
  steps back of the current best survivor) rather than a full-traceback
  decoder, so outputs match the C++ bit for bit, including its
  tie-breaking (strict `<` prefers the 0-prefix candidate, first-minimum
  survivor selection).
* CRC state is a bit-plane array (batched over frames), so the 40-bit
  Fire code needs no uint64 support.
* Interleavers are constant index maps applied as gathers/scatters.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

# ---------------------------------------------------------------------------
# Parity / CRC (Generator + Parity)
# ---------------------------------------------------------------------------

# (poly, parity_bits, codeword_bits) as constructed in GSML1FEC.cpp:
FIRECODE_XCCH = (0x10004820009, 40, 224)  # GSML1FEC.cpp:537
PARITY_RACH = (0x06F, 6, 8)  # GSML1FEC.h:473
PARITY_SCH = (0x0575, 10, 25)  # GSML1FEC.cpp:882
PARITY_TCH = (0x0B, 3, 50)  # GSML1FEC.cpp:1005


def _poly_bits(poly: int, n: int) -> np.ndarray:
    """Exponents 0..n-1 of `poly` as an [n] uint8 array (LSB first)."""
    return np.array([(poly >> i) & 1 for i in range(n)], np.uint8)


@functools.lru_cache(maxsize=None)
def _crc_contribution_matrix(poly: int, size: int, n_bits: int,
                             encoder: bool) -> np.ndarray:
    """[n_bits, size] GF(2) matrix C with final_state = (bits @ C) mod 2.

    The LFSR update (Generator::encoderShift / syndromeShift,
    BitVector.h:66-83) is linear over GF(2) in the input bits with a
    zero initial state, so the final state is the XOR of each input
    bit's unit-impulse response — computed here once per
    (poly, size, length) in numpy and contracted as one matrix product
    at runtime instead of a length-n sequential scan."""
    coeff = _poly_bits(poly, size).astype(np.uint8)
    c = np.zeros((n_bits, size), np.uint8)
    for i in range(n_bits):
        state = np.zeros(size, np.uint8)
        for t in range(n_bits):
            in_bit = np.uint8(1 if t == i else 0)
            msb = state[size - 1]
            fb = (msb ^ in_bit) if encoder else msb
            new_lsb = np.uint8(0) if encoder else in_bit
            state = np.concatenate([[new_lsb], state[: size - 1]]) ^ \
                (fb * coeff)
        c[i] = state
    return c


def crc_state_run(bits: Array, poly: int, size: int, *, encoder: bool) -> Array:
    """Run the LFSR over `bits` along the last axis; return final state
    as an [..., size] bit-plane (index 0 = exponent 0 / LSB).

    encoder=True → Generator::encoderShift (BitVector.h:77-83);
    encoder=False → syndromeShift (BitVector.h:66-71). Evaluated as one
    GF(2) matmul against the precomputed unit-response matrix (exact:
    f32 accumulates ≤ n_bits < 2^24 before the mod)."""
    bits = jnp.asarray(bits, jnp.uint8)
    c = jnp.asarray(_crc_contribution_matrix(poly, size, bits.shape[-1],
                                             encoder), jnp.float32)
    acc = jnp.matmul(bits.astype(jnp.float32), c,
                     precision=jax.lax.Precision.HIGHEST)
    return (acc.astype(jnp.int32) & 1).astype(jnp.uint8)


def parity_word(data: Array, spec=FIRECODE_XCCH, invert: bool = True) -> Array:
    """Compute the parity field for `data` [..., K]; returns [..., P]
    bits in frame order (MSB of the register first — Parity::
    writeParityWord + fillField, BitVector.cpp:411-418)."""
    poly, p, _ = spec
    state = crc_state_run(data, poly, p, encoder=True)
    if invert:
        state = state ^ np.uint8(1)
    return jnp.flip(state, axis=-1)  # MSB-first into the frame


def syndrome_ok(data_and_parity: Array, spec=FIRECODE_XCCH) -> Array:
    """True where the [..., K+P] codeword (with *inverted* parity as
    transmitted) has zero syndrome (XCCHL1Decoder::decode,
    GSML1FEC.cpp:640-652: invert parity, then syndromeShift over d|p)."""
    poly, p, _ = spec  # the spec's codeword-size field is metadata only
    data_and_parity = jnp.asarray(data_and_parity, jnp.uint8)
    n = data_and_parity.shape[-1]
    fixed = data_and_parity.at[..., n - p :].set(
        data_and_parity[..., n - p :] ^ np.uint8(1))
    state = crc_state_run(fixed, poly, p, encoder=False)
    return jnp.all(state == 0, axis=-1)


# ---------------------------------------------------------------------------
# Convolutional code (rate 1/2, K=5, G0=1+D³+D⁴, G1=1+D+D³+D⁴)
# ---------------------------------------------------------------------------

VITERBI_POLYS = (0x19, 0x1B)  # ViterbiR2O4 mCoeffs (BitVector.cpp:292-293)
V_ORDER = 4
V_STATES = 16
V_DEFERRAL = 24  # 6 * order (BitVector.h "mDeferral")


def conv_encode(bits: Array) -> Array:
    """Rate-1/2 convolutional encode: [..., K] → [..., 2K]
    (BitVector::encode, BitVector.cpp:217-238). Output bit 2i is G0,
    2i+1 is G1, zero initial state."""
    bits = jnp.asarray(bits, jnp.uint8)
    outs = []
    for poly in VITERBI_POLYS:
        taps = _poly_bits(poly, V_ORDER + 1)  # taps[k] multiplies bit i−k
        acc = jnp.zeros_like(bits)
        for k in range(V_ORDER + 1):
            if taps[k]:
                shifted = jnp.pad(bits, [(0, 0)] * (bits.ndim - 1) +
                                  [(k, 0)])[..., : bits.shape[-1]]
                acc = acc ^ shifted
        outs.append(acc)
    return jnp.stack(outs, axis=-1).reshape(bits.shape[:-1] +
                                            (2 * bits.shape[-1],))


@functools.lru_cache(maxsize=None)
def _viterbi_tables():
    """Expected output bits per (path, new_state):
    path 0 = previous state ns>>1, path 1 = (ns>>1)|8.
    Returns (e0 [2,16], e1 [2,16], prev [2,16]) uint8/int32."""
    e0 = np.zeros((2, V_STATES), np.uint8)
    e1 = np.zeros((2, V_STATES), np.uint8)
    prev = np.zeros((2, V_STATES), np.int32)

    def par(x):
        return bin(x).count("1") & 1

    for ns in range(V_STATES):
        b = ns & 1
        for path in range(2):
            p = (ns >> 1) | (8 * path)
            idx5 = ((p << 1) | b) & 0x1F
            e0[path, ns] = par(idx5 & VITERBI_POLYS[0])
            e1[path, ns] = par(idx5 & VITERBI_POLYS[1])
            prev[path, ns] = p
    return e0, e1, prev


def viterbi_decode(soft: Array) -> Array:
    """Soft-input Viterbi decode: [..., 2K] soft bits in [0,1] → [..., K]
    hard bits. Bit-exact emulation of SoftVector::decode +
    ViterbiR2O4::step (BitVector.cpp:289-525): deferred-decision decoder
    with deferral 24, cost tables 0.25/clamped-probabilities, hard-sliced
    branch comparison, 0-prefix-preferred pruning.
    """
    soft = jnp.asarray(soft, jnp.float32)
    lead = soft.shape[:-1]
    soft2 = soft.reshape((-1, soft.shape[-1]))
    bsz, sz = soft2.shape
    assert sz % 2 == 0
    n_out = sz // 2
    steps = n_out + V_DEFERRAL

    e0, e1, prev = _viterbi_tables()
    e0 = jnp.asarray(e0, jnp.float32)  # [2,16]
    e1 = jnp.asarray(e1, jnp.float32)
    prev = jnp.asarray(prev)

    # Cost tables (BitVector.cpp:473-495): p = clamp(min(s,1−s), 0.01),
    # ip = clamp(1−p, 0.01); match=0.25/ip, mismatch=0.25/p; pads 0.5.
    hard = (soft2 > 0.5).astype(jnp.float32)
    p = jnp.minimum(soft2, 1.0 - soft2)
    p = jnp.maximum(p, 0.01)
    ip = jnp.maximum(1.0 - p, 0.01)
    match = 0.25 / ip
    mismatch = 0.25 / p

    def pad_to(x, fill):
        extra = 2 * steps - sz
        return jnp.concatenate(
            [x, jnp.full((bsz, extra), fill, x.dtype)], axis=-1)

    # Padded hard bits repeat the final sliced bit (BitVector.cpp:466-469).
    last = hard[:, -1:]
    hard_p = jnp.concatenate(
        [hard, jnp.repeat(last, 2 * steps - sz, axis=-1)], axis=-1)
    match_p = pad_to(match, 0.5)
    mismatch_p = pad_to(mismatch, 0.5)

    # Reshape to per-step pairs: bit 2t is G0's, 2t+1 is G1's.
    h0 = hard_p[:, 0::2].T  # [steps, B]
    h1 = hard_p[:, 1::2].T
    m0, mm0 = match_p[:, 0::2].T, mismatch_p[:, 0::2].T
    m1, mm1 = match_p[:, 1::2].T, mismatch_p[:, 1::2].T

    def step(carry, inp):
        cost, hist = carry  # [B,16] f32, [B,16] uint32
        b0, b1, ma0, mi0, ma1, mi1 = inp  # each [B]
        # branch metric per (path, ns): match/mismatch vs hard bits
        mis0 = jnp.abs(e0[None] - b0[:, None, None])  # [B,2,16] 1 if differ
        mis1 = jnp.abs(e1[None] - b1[:, None, None])
        bm = (mis0 * mi0[:, None, None] + (1 - mis0) * ma0[:, None, None]
              + mis1 * mi1[:, None, None] + (1 - mis1) * ma1[:, None, None])
        cand = cost[:, prev] + bm  # [B,2,16]
        take1 = cand[:, 1] < cand[:, 0]  # strict: prefer 0-prefix on ties
        new_cost = jnp.where(take1, cand[:, 1], cand[:, 0])
        nb = jnp.asarray(np.arange(V_STATES) & 1, jnp.uint32)
        # survivor history: both predecessor rows are static gathers
        # (XLA shuffles), selected per state — no dynamic gather
        new_hist = (jnp.where(take1, hist[:, prev[1]], hist[:, prev[0]])
                    << 1) | nb
        best = jnp.argmin(new_cost, axis=1)  # first minimum
        onehot = jnp.arange(V_STATES)[None] == best[:, None]
        out_bit = (jnp.sum(jnp.where(onehot, new_hist, 0), axis=1)
                   >> V_DEFERRAL) & 1
        return (new_cost, new_hist), out_bit

    cost0 = jnp.zeros((bsz, V_STATES), jnp.float32)
    hist0 = jnp.zeros((bsz, V_STATES), jnp.uint32)
    _, outs = jax.lax.scan(step, (cost0, hist0),
                           (h0, h1, m0, mm0, m1, mm1), unroll=8)
    bits = outs[V_DEFERRAL:].T.astype(jnp.uint8)  # [B, n_out]
    return bits.reshape(lead + (n_out,))


# ---------------------------------------------------------------------------
# Interleaving (GSM 05.03)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def xcch_interleave_map() -> np.ndarray:
    """k → flat index B*114+j of i[B][j] for the 4-burst diagonal
    interleaver (GSM 05.03 4.1.4; GSML1FEC.cpp:811-822)."""
    k = np.arange(456)
    B = k % 4
    j = 2 * ((49 * k) % 57) + ((k % 8) // 4)
    return (B * 114 + j).astype(np.int32)


@functools.lru_cache(maxsize=None)
def tch_interleave_map(block_offset: int = 0) -> np.ndarray:
    """k → flat index B*114+j for the 8-burst diagonal TCH interleaver
    (GSM 05.03 3.1.3; GSML1FEC.cpp:1380-1393)."""
    k = np.arange(456)
    B = (k + block_offset) % 8
    j = 2 * ((49 * k) % 57) + ((k % 8) // 4)
    return (B * 114 + j).astype(np.int32)


def interleave(c: Array, imap: np.ndarray, num_bursts: int) -> Array:
    """c [..., 456] → i [..., num_bursts, 114] via scatter."""
    c = jnp.asarray(c)
    flat = jnp.zeros(c.shape[:-1] + (num_bursts * 114,), c.dtype)
    flat = flat.at[..., jnp.asarray(imap)].set(c)
    return flat.reshape(c.shape[:-1] + (num_bursts, 114))


def deinterleave(i: Array, imap: np.ndarray) -> Array:
    """i [..., num_bursts, 114] → c [..., 456] via gather."""
    i = jnp.asarray(i)
    flat = i.reshape(i.shape[:-2] + (-1,))
    return flat[..., jnp.asarray(imap)]


# ---------------------------------------------------------------------------
# Burst mapping (GSM 05.02 5.2.3; GSML1FEC.cpp:823-849 / 550-614)
# ---------------------------------------------------------------------------

def map_to_burst(i_frame: Array, stealing: tuple[int, int] = (1, 1),
                 tsc: int | None = None) -> Array:
    """114 interleaved bits → 148-bit normal burst: bits 3..59 and
    88..144, stealing flags Hl/Hu at 60/87, training sequence at 61..86
    when `tsc` is given (the encoder hardcodes TSC=BCC,
    GSML1FEC.cpp:723-726), tails zero. i_frame: [..., 114]."""
    from openbts_ttsou_tpu.utils import constants as C

    i_frame = jnp.asarray(i_frame, jnp.uint8)
    out = jnp.zeros(i_frame.shape[:-1] + (148,), jnp.uint8)
    out = out.at[..., 3:60].set(i_frame[..., :57])
    out = out.at[..., 88:145].set(i_frame[..., 57:])
    out = out.at[..., 60].set(stealing[0])
    out = out.at[..., 87].set(stealing[1])
    if tsc is not None:
        out = out.at[..., 61:87].set(
            jnp.asarray(C.TRAINING_SEQUENCE[tsc], jnp.uint8))
    return out


def unmap_from_burst(burst: Array) -> tuple[Array, Array]:
    """148 soft/hard bits → (114 payload bits, (hl, hu) stealing flags)
    (XCCHL1Decoder::processBurst reads data1/data2,
    GSML1FEC.cpp:572-614)."""
    burst = jnp.asarray(burst)
    payload = jnp.concatenate(
        [burst[..., 3:60], burst[..., 88:145]], axis=-1)
    return payload, (burst[..., 60], burst[..., 87])
