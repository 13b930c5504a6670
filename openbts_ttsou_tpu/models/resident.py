"""Host-side streaming wrapper for the fully-resident BTS L1.

`duplex_block_decoded` (models/transceiver.py) is one device program
per 13-frame window carrying FEC in both directions, but it threads
FIVE pieces of cross-window streaming state (engine TrxState, the tx
symbol tail, the TCH diagonal-interleaver carry, the streaming XCCH tx
grid carry, and the rx soft-bit decode prelude) plus the FN%4 phase
cycling over its 4 compiled variants. `ResidentL1` owns all of that so
a consumer pushes one window of downlink CONTENT (L2 frames + vocoder
bits) and uplink SAMPLES per step and receives the device-rate tx
stream and the window's decodes — the same L2-frames-in /
L2-frames-out contract the reference's GSML1FEC presents to the SAP
mux (GSML1FEC.h:81,343), with the whole layer below it (coding,
interleaving, GMSK, resampling, detection, demodulation, Viterbi)
resident on the device.

Checkpoint/resume: `carry()` returns the complete streaming state as
one pytree; `restore()` installs it. Together with the deterministic
FN bookkeeping this is the resident path's save/restore contract
(SURVEY §5 checkpoint = constants + stream cursor + per-slot state).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from openbts_ttsou_tpu.gsm import l1fec
from openbts_ttsou_tpu.models import transceiver as M
from openbts_ttsou_tpu.trx import engine as eng
from openbts_ttsou_tpu.utils.gsm_time import HYPERFRAME


class ResidentL1:
    """Streaming driver for `duplex_block_decoded`.

    Parameters mirror the program's statics: `cfg`/`spec` fix the
    geometry, `bsic` the RACH color code, `xcch_tns`/`tch_tns` the
    static slot split (decode_block docstring). `fn0` is the first
    window's frame number; each `step` advances it by `spec.frames`.
    """

    def __init__(self, cfg: eng.TrxConfig, spec: M.UplinkSpec | None = None,
                 bsic: int = 0, xcch_tns: tuple | None = None,
                 tch_tns: tuple | None = None,
                 state: eng.TrxState | None = None, fn0: int = 0):
        self.cfg = cfg
        self.spec = spec or M.UplinkSpec()
        self.bsic = bsic
        self.xcch_tns = xcch_tns
        self.tch_tns = tch_tns
        c = cfg.n_chan
        self.state = state if state is not None else eng.init_state(cfg)
        self.fn = int(fn0) % HYPERFRAME
        self.tx_tail = jnp.zeros((c, M.TX_TAIL_SYM), jnp.complex64)
        self.tx_carry = (l1fec.TchTxCarry.zeros(c * 8),
                         M.XcchTxCarry.zeros(c))
        self.prev_soft = jnp.zeros((M.DECODE_PRELUDE, c, 8, 148),
                                   jnp.float32)
        self.prev_valid = jnp.asarray(False)

    # -- streaming state as one pytree (checkpoint/resume) -------------
    def carry(self):
        return {"state": self.state, "fn": self.fn,
                "tx_tail": self.tx_tail, "tx_carry": self.tx_carry,
                "prev_soft": self.prev_soft,
                "prev_valid": self.prev_valid}

    def restore(self, carry) -> None:
        self.state = carry["state"]
        self.fn = int(carry["fn"]) % HYPERFRAME
        self.tx_tail = carry["tx_tail"]
        self.tx_carry = carry["tx_carry"]
        self.prev_soft = carry["prev_soft"]
        self.prev_valid = carry["prev_valid"]

    def step(self, ul_halo, dl_content, atten_db=None):
        """One 13-frame window.

        ul_halo: [C, block_in + 2·RX_HALO_DEV] complex64 device-rate
        uplink (the caller's stream slice, RX_HALO_DEV of context each
        side — the daemon's halo'd read); dl_content: the 7-tuple of
        `_encode_dl_window`'s streaming layout (frames184 [4, C, 8,
        184] on the ABSOLUTE FN%4 grid, xcch_valid, speech, sp_valid,
        facch, fa_valid, tch_mask); atten_db: [F, C, 8] float32 per-
        burst attenuation (zeros when omitted).

        Returns (tx [C, block_in] device-rate downlink, DecodedBlocks).
        """
        spec = self.spec
        if atten_db is None:
            atten_db = jnp.zeros((spec.frames, self.cfg.n_chan, 8),
                                 jnp.float32)
        fn = self.fn
        st = self.state._replace(fn=jnp.asarray(fn, jnp.int32))
        (st2, tx, tail2, blocks, carry2, prev2,
         pvalid2) = M.duplex_block_decoded(
            self.cfg, spec, st, ul_halo, self.tx_tail, dl_content,
            atten_db, self.tx_carry, jnp.asarray(fn, jnp.int32),
            self.prev_soft, self.prev_valid, self.bsic, fn % 4,
            self.xcch_tns, self.tch_tns)
        self.state = st2
        self.tx_tail = tail2
        self.tx_carry = carry2
        self.prev_soft = prev2
        self.prev_valid = pvalid2
        self.fn = (fn + spec.frames) % HYPERFRAME
        return tx, blocks

    # -- downlink content helpers --------------------------------------
    def empty_content(self, tch_mask: np.ndarray):
        """An all-idle window's dl_content (filler everywhere)."""
        c = self.cfg.n_chan
        z8 = np.uint8
        return tuple(jnp.asarray(a) for a in (
            np.zeros((4, c, 8, 184), z8), np.zeros((4, c, 8), bool),
            np.zeros((3, c, 8, 260), z8), np.zeros((3, c, 8), bool),
            np.zeros((3, c, 8, 184), z8), np.zeros((3, c, 8), bool),
            np.asarray(tch_mask, bool)))

    def xcch_group_slots(self):
        """Local group-start frames for the CURRENT window's absolute
        FN%4 grid: group g starts at local frame ((-fn%4) % 4) + 4g —
        the caller fills frames184[g] for starts ≤ frames−1 (a group
        may extend into the next window via the tx carry)."""
        off = (-self.fn) % 4
        return [off + 4 * g for g in range(4) if off + 4 * g
                < self.spec.frames + 3]
