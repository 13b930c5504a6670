import numpy as np
import pytest

import jax.numpy as jnp

from openbts_ttsou_tpu.models.transceiver import (
    Transceiver,
    UplinkSpec,
    downlink_block,
    uplink_block,
)
from openbts_ttsou_tpu.ops import fir, gmsk
from openbts_ttsou_tpu.trx import ChanType, TrxConfig, init_state
from openbts_ttsou_tpu.utils import constants as C

RNG = np.random.default_rng(53)


def normal_burst_bits(tsc=0, seed=1):
    rng = np.random.default_rng(seed)
    return np.concatenate(
        [[0, 0, 0], rng.integers(0, 2, 57), [1], C.TRAINING_SEQUENCE[tsc], [1],
         rng.integers(0, 2, 57), [0, 0, 0]]).astype(np.uint8)


def test_uplink_block_detects_planted_bursts():
    cfg = TrxConfig(n_chan=2)
    spec = UplinkSpec(frames=13)
    chan_type = np.zeros((2, 8), np.int32)
    chan_type[:, 2] = ChanType.I
    state = init_state(cfg)._replace(chan_type=jnp.asarray(chan_type))

    sym = np.zeros((2, spec.block_symbols), np.complex64)
    planted = {}
    for c in range(2):
        for f in range(2, 11, 4):
            bits = normal_burst_bits(seed=10 * c + f)
            wave = 9000.0 * np.asarray(gmsk.modulate_burst(bits[None], 1))[0]
            sym[c, f * 1250 + 313: f * 1250 + 313 + 148] += wave
            planted[(c, f)] = bits
    dev = np.asarray(fir.polyphase_resample(
        jnp.asarray(sym), 96, 65, fir.resampler_lpf(96, 65, 651)))
    dev = jnp.asarray(dev[:, : spec.block_in])

    st, res = uplink_block(cfg, spec, state, dev)
    det = np.asarray(res.detected)
    soft = np.asarray(res.soft_bits)
    for (c, f), bits in planted.items():
        assert det[f, c, 2], f"missed chan {c} frame {f}"
        ber = np.mean((soft[f, c, 2] > 0.5).astype(int) != bits)
        assert ber < 0.02
    # no detections on inactive slots
    assert not det[:, :, 0].any()
    assert int(st.fn) == 13


def test_downlink_block_round_trips_through_uplink():
    """Full duplex loopback at device rate: downlink modulator →
    96/65 → (wire) → 65/96 → uplink detector."""
    cfg = TrxConfig(n_chan=1)
    spec = UplinkSpec(frames=13)
    state = init_state(cfg)._replace(
        chan_type=jnp.full((1, 8), ChanType.I, jnp.int32))

    bits = np.zeros((13, 1, 8, 148), np.uint8)
    sent = {}
    for f in range(13):
        for tn in range(8):
            b = normal_burst_bits(seed=f * 8 + tn)
            bits[f, 0, tn] = b
            sent[(f, tn)] = b
    valid = jnp.ones((13, 1, 8), bool)
    att = jnp.zeros((13, 1, 8), jnp.float32)
    dev = downlink_block(cfg, spec, state, jnp.asarray(bits), valid, att,
                         jnp.asarray(0, jnp.int32))
    assert dev.shape == (1, spec.block_in)

    st, res = uplink_block(cfg, spec, state, dev)
    det = np.asarray(res.detected)
    soft = np.asarray(res.soft_bits)
    missed = sum(0 if det[f, 0, tn] else 1 for (f, tn) in sent)
    assert missed <= 2, f"missed {missed} bursts"  # stream-edge effects
    bers = [np.mean((soft[f, 0, tn] > 0.5).astype(int) != b)
            for (f, tn), b in sent.items() if det[f, 0, tn]]
    assert np.mean(bers) < 0.01, f"duplex mean BER {np.mean(bers)}"


def test_transceiver_wrapper_control_verbs():
    trx = Transceiver(TrxConfig(n_chan=2))
    trx.set_slot(0, 3, ChanType.VII)
    trx.set_tsc(0, 5)
    trx.set_max_delay(1, 4)
    assert int(trx.state.chan_type[0, 3]) == ChanType.VII
    assert int(trx.state.tsc[0]) == 5
    assert int(trx.state.max_expected_delay[1]) == 4
    frame = jnp.zeros((2, 8, 157), jnp.complex64)
    res = trx.rx_frame(frame)
    assert not np.asarray(res.detected).any()
    assert int(trx.state.fn) == 1


def test_uplink_block_batched_exact_recovers_bursts():
    """The batched-exact engine (the ≤128-carrier dispatch of
    uplink_block) recovers planted bursts and matches the per-frame
    scan exactly (full equality matrix: tests/test_exact_block.py)."""
    from openbts_ttsou_tpu.models.transceiver import process_block_exact
    from openbts_ttsou_tpu.parallel.sharded import _slot_windows
    import jax.lax as lax
    from openbts_ttsou_tpu.trx import engine as _eng

    cfg = TrxConfig(n_chan=2)
    spec = UplinkSpec(frames=13)
    chan_type = np.zeros((2, 8), np.int32)
    chan_type[:, 2] = ChanType.I
    chan_type[:, 0] = ChanType.IV
    state = init_state(cfg)._replace(chan_type=jnp.asarray(chan_type))

    sym = np.zeros((2, spec.block_symbols), np.complex64)
    planted = {}
    for c in range(2):
        for f in range(1, 12, 3):
            bits = normal_burst_bits(seed=7 * c + f)
            wave = 9000.0 * np.asarray(gmsk.modulate_burst(bits[None], 1))[0]
            sym[c, f * 1250 + 313: f * 1250 + 313 + 148] += wave
            planted[(c, f)] = bits
    dev = np.asarray(fir.polyphase_resample(
        jnp.asarray(sym), 96, 65, fir.resampler_lpf(96, 65, 651)))
    dev = jnp.asarray(dev[:, : spec.block_in])

    st_a, res_a = uplink_block(cfg, spec, state, dev)  # batched (C=2)
    lpf = fir.resampler_lpf(65, 96, 961)
    sym_d = fir.polyphase_resample(dev, 65, 96, lpf)[
        ..., : spec.block_symbols]
    wins = _slot_windows(sym_d, spec.frames)
    st_b, res_b = lax.scan(
        lambda st, fr: _eng.rx_step(cfg, st, fr), state, wins)
    np.testing.assert_array_equal(np.asarray(res_a.detected),
                                  np.asarray(res_b.detected))
    np.testing.assert_allclose(np.asarray(res_a.soft_bits),
                               np.asarray(res_b.soft_bits), atol=1e-3)
    assert int(st_b.fn) == 13
    det = np.asarray(res_b.detected)
    soft = np.asarray(res_b.soft_bits)
    for (c, f), bits in planted.items():
        assert det[f, c, 2]
        assert np.mean((soft[f, c, 2] > 0.5).astype(int) != bits) < 0.02


def test_uplink_block_decoded_xcch_on_device():
    """Device-resident receiver: plant a 4-burst XCCH block (FEC-encoded
    184-bit frame) on an FN%4 boundary; uplink_block_decoded detects,
    demodulates AND FEC-decodes it in one program, honoring a
    misaligned block-start FN."""
    from openbts_ttsou_tpu.gsm import l1fec
    from openbts_ttsou_tpu.models.transceiver import uplink_block_decoded

    cfg = TrxConfig(n_chan=2)
    spec = UplinkSpec(frames=13)
    chan_type = np.zeros((2, 8), np.int32)
    chan_type[:, 2] = ChanType.I
    chan_type[:, 0] = ChanType.IV  # RACH slot
    fn0 = 6  # off = (-6) % 4 = 2 → first group at relative frame 2
    state = init_state(cfg)._replace(
        chan_type=jnp.asarray(chan_type),
        fn=jnp.asarray(np.int32(fn0)))

    rng = np.random.default_rng(7)
    frame184 = rng.integers(0, 2, 184).astype(np.uint8)
    bursts = np.asarray(l1fec.xcch_encode(frame184[None], tsc=0))[0]

    sym = np.zeros((2, spec.block_symbols), np.complex64)
    for b in range(4):  # relative frames 2..5 on chan 1, slot 2
        wave = 9000.0 * np.asarray(gmsk.modulate_burst(bursts[b][None],
                                                       1))[0]
        sym[1, (2 + b) * 1250 + 313: (2 + b) * 1250 + 313 + 148] += wave
    # plant a RACH on chan 0 slot 0, frame 7 (RA=0xB3, BSIC=2)
    rach = np.zeros(148, np.uint8)
    rach[:8] = [0, 1] * 4
    rach[8:49] = C.RACH_SYNCH_SEQUENCE
    rach[49:85] = np.asarray(l1fec.rach_encode(np.uint8(0xB3),
                                               np.uint8(2)))
    rwave = 9000.0 * np.asarray(gmsk.modulate_burst(rach[None], 1))[0]
    sym[0, 7 * 1250: 7 * 1250 + 148] += rwave
    dev = np.asarray(fir.polyphase_resample(
        jnp.asarray(sym), 96, 65, fir.resampler_lpf(96, 65, 651)))
    dev = jnp.asarray(dev[:, : spec.block_in])

    st, res, dec = uplink_block_decoded(cfg, spec, state, dev, 2)
    ok = np.asarray(dec.ok)
    bits = np.asarray(dec.bits)
    assert int(np.asarray(dec.first_fn)) == 8  # fn0 + off
    assert ok[0, 1, 2], "XCCH block not decoded"
    assert np.array_equal(bits[0, 1, 2], frame184)
    # nothing else decodes as valid
    ok = ok.copy()
    ok[0, 1, 2] = False
    assert not ok.any()
    # the planted access burst decodes on-device too
    rach_ok = np.asarray(dec.rach_ok)
    assert rach_ok[7, 0, 0], "RACH not decoded"
    assert int(np.asarray(dec.rach_ra)[7, 0, 0]) == 0xB3
    rach_ok = rach_ok.copy()
    rach_ok[7, 0, 0] = False
    assert not rach_ok.any()


def test_full_duplex_fec_on_device():
    """Device-resident full duplex: downlink_block_encoded (FireCode +
    conv + interleave + GMSK + 96/65) feeds uplink_block_decoded
    (65/96 + detect + demod + Viterbi + syndrome) — L2 frames in, the
    same L2 frames out, two fused programs end to end."""
    from openbts_ttsou_tpu.models.transceiver import (
        downlink_block_encoded,
        uplink_block_decoded,
    )

    cfg = TrxConfig(n_chan=2)
    spec = UplinkSpec(frames=13)
    chan_type = np.full((2, 8), ChanType.I, np.int32)
    state = init_state(cfg)._replace(chan_type=jnp.asarray(chan_type),
                                     fn=jnp.asarray(np.int32(0)))

    rng = np.random.default_rng(11)
    frames184 = rng.integers(0, 2, (3, 2, 8, 184)).astype(np.uint8)
    valid = np.ones((3, 2, 8), bool)
    atten = np.zeros((3, 2, 8), np.float32)

    dev = downlink_block_encoded(cfg, spec, state, jnp.asarray(frames184),
                                 jnp.asarray(valid), jnp.asarray(atten),
                                 jnp.asarray(np.int32(0)))
    st, res, dec = uplink_block_decoded(cfg, spec, state, dev)
    ok = np.asarray(dec.ok)
    bits = np.asarray(dec.bits)
    assert ok.all(), f"undecoded blocks at {np.argwhere(~ok)[:4]}"
    assert np.array_equal(bits, frames184)


def test_decode_block_tch_facch_matches_host():
    """The fused TCH/FS + FACCH decode (decode_block) reproduces the
    host TCHFACCHL1 path (TCHFACCHL1Decoder, GSML1FEC.cpp:1031-1175):
    same vocoder frames, same FACCH frames, same stealing flags."""
    from openbts_ttsou_tpu.gsm import channels, gsm610, tdma
    from openbts_ttsou_tpu.gsm.transfer import L2Frame, RxBurst
    from openbts_ttsou_tpu.models.transceiver import decode_block
    from openbts_ttsou_tpu.trx import engine as eng

    rng = np.random.default_rng(11)
    tn = 2
    tx = channels.TCHFACCHL1(tn, tdma.FACCH_TCHF, tdma.FACCH_TCHF, tsc=0)
    tx.open(0)
    tx.resync(0)

    facch_l2 = rng.integers(0, 2, 184).astype(np.uint8)
    payloads = [rng.integers(0, 2, 260).astype(np.uint8) for _ in range(3)]
    tx.send_l2(L2Frame(facch_l2))  # half-block 0: stolen (FACCH)
    for pl in payloads:
        tx.send_tch(pl)  # half-blocks 1..3: speech
    for _ in range(4):
        tx.dispatch_block()

    bursts = {b.fn: b.bits for b in tx.tx_queue}
    fn_first = min(bursts)
    frames = 13

    # host decode
    rx = channels.TCHFACCHL1(tn, tdma.FACCH_TCHF, tdma.FACCH_TCHF, tsc=0)
    rx.open(0)
    facch_rx = []

    class _Rec:
        def write_low_side(self, frame):
            facch_rx.append(np.asarray(frame.bits))

    rx.upstream = _Rec()
    for f in range(frames):
        fn = fn_first + f
        if fn in bursts:
            rx.write_low_side(RxBurst(bursts[fn].astype(np.float32), fn, tn))

    # fused decode on a synthetic 1-channel RxResult window
    soft = np.full((frames, 1, 8, 148), 0.5, np.float32)
    det = np.zeros((frames, 1, 8), bool)
    for f in range(frames):
        fn = fn_first + f
        if fn in bursts:
            soft[f, 0, tn] = bursts[fn]
            det[f, 0, tn] = True
    res = eng.RxResult(
        detected=jnp.asarray(det), is_rach=jnp.zeros_like(jnp.asarray(det)),
        soft_bits=jnp.asarray(soft),
        rssi=jnp.zeros((frames, 1, 8), jnp.int32),
        timing=jnp.zeros((frames, 1, 8), jnp.int32))
    dec = decode_block(res, jnp.asarray(fn_first), frames)

    valid = np.asarray(dec.tch_valid)
    assert valid.sum() == 2  # two complete half-blocks in 13 frames
    ends = np.asarray(dec.tch_end_fn)[valid]

    # group 0 = the stolen FACCH block
    g0 = np.flatnonzero(valid)[0]
    assert bool(np.asarray(dec.tch_stolen)[g0, 0, tn])
    assert bool(np.asarray(dec.facch_ok)[g0, 0, tn])
    assert not bool(np.asarray(dec.tch_good)[g0, 0, tn])
    from openbts_ttsou_tpu.gsm import l1fec

    got_l2 = np.asarray(l1fec.lsb8msb(np.asarray(dec.facch_bits)[g0, 0, tn]))
    np.testing.assert_array_equal(got_l2, facch_l2)
    assert len(facch_rx) == 1 and np.array_equal(facch_rx[0], facch_l2)

    # group 1 = the first speech block
    g1 = np.flatnonzero(valid)[1]
    assert not bool(np.asarray(dec.tch_stolen)[g1, 0, tn])
    assert bool(np.asarray(dec.tch_good)[g1, 0, tn])
    assert not bool(np.asarray(dec.facch_ok)[g1, 0, tn])
    want_d = gsm610.payload_to_coder(payloads[0])
    np.testing.assert_array_equal(
        np.asarray(dec.tch_speech)[g1, 0, tn], want_d)
    # host heard the same frame (speech_out is payload order)
    assert len(rx.speech_out) >= 1
    np.testing.assert_array_equal(rx.speech_out[0], payloads[0])

    # the completing-burst FNs agree with the host mapping
    for fn_end in ends:
        b = tdma.FACCH_TCHF.reverse(int(fn_end) % 26)
        assert b is not None and b % 4 == 3

    # inactive (chan, slot) entries decode to not-good
    assert not np.asarray(dec.tch_good)[:, 0, 0].any()
    assert not np.asarray(dec.facch_ok)[:, 0, 0].any()


def test_decode_block_tch_all_phases():
    """The static group tables cover every window phase fn0 % 26: each
    group's completing burst is a real B%4==3 TCH frame and all eight
    member frames are in-window TCH frames in diagonal order."""
    from openbts_ttsou_tpu.gsm import tdma
    from openbts_ttsou_tpu.models.transceiver import _tch_group_tables

    frames = 13
    idx, end, valid = _tch_group_tables(frames)
    assert idx.shape[0] == 26
    for p in range(26):
        for g in range(idx.shape[1]):
            if not valid[p, g]:
                continue
            fr = idx[p, g]
            assert fr[-1] == end[p, g]
            bs = []
            for f in fr:
                r = tdma.FACCH_TCHF.reverse((p + int(f)) % 26)
                assert r is not None
                bs.append(r % 8)
            assert bs[-1] % 4 == 3
            # consecutive diagonal indices mod 8
            for a, b in zip(bs, bs[1:]):
                assert (b - a) % 8 == 1
        # at least one group for every phase in a 13-frame window
        assert valid[p].any()


def test_uplink_block_decoded_tch_over_the_air():
    """Over-the-air fused voice receive: host-encoded TCH/FS + FACCH
    bursts → GMSK modulate → 96/65 → 65/96 → detection/demod → 8-burst
    diagonal deinterleave + Viterbi + class-1a parity, all in ONE
    uplink_block_decoded program. The [Gt, C, 8, 260] vocoder output
    matches the transmitted frames."""
    from openbts_ttsou_tpu.gsm import channels, gsm610, l1fec, tdma
    from openbts_ttsou_tpu.gsm.transfer import L2Frame
    from openbts_ttsou_tpu.models.transceiver import uplink_block_decoded

    rng = np.random.default_rng(23)
    tn = 2
    tx = channels.TCHFACCHL1(tn, tdma.FACCH_TCHF, tdma.FACCH_TCHF, tsc=0)
    tx.open(0)
    tx.resync(0)
    facch_l2 = rng.integers(0, 2, 184).astype(np.uint8)
    payloads = [rng.integers(0, 2, 260).astype(np.uint8) for _ in range(3)]
    tx.send_l2(L2Frame(facch_l2))
    for pl in payloads:
        tx.send_tch(pl)
    for _ in range(4):
        tx.dispatch_block()
    bursts = {b.fn: b.bits for b in tx.tx_queue}
    fn0 = min(bursts)

    cfg = TrxConfig(n_chan=1)
    spec = UplinkSpec(frames=13)
    chan_type = np.zeros((1, 8), np.int32)
    chan_type[0, tn] = ChanType.I
    state = init_state(cfg)._replace(
        chan_type=jnp.asarray(chan_type),
        fn=jnp.asarray(np.int32(fn0)))

    sym = np.zeros((1, spec.block_symbols), np.complex64)
    slot_off = [0, 157, 313, 469, 625, 782, 938, 1094][tn]
    for f in range(13):
        fn = fn0 + f
        if fn in bursts:
            wave = 9000.0 * np.asarray(
                gmsk.modulate_burst(bursts[fn][None], 1))[0]
            sym[0, f * 1250 + slot_off: f * 1250 + slot_off + 148] += wave
    dev = np.asarray(fir.polyphase_resample(
        jnp.asarray(sym), 96, 65, fir.resampler_lpf(96, 65, 651)))
    dev = jnp.asarray(dev[:, : spec.block_in])

    st, res, dec = uplink_block_decoded(cfg, spec, state, dev)
    valid = np.asarray(dec.tch_valid)
    assert valid.sum() == 2
    g0, g1 = np.flatnonzero(valid)[:2]
    assert bool(np.asarray(dec.tch_stolen)[g0, 0, tn])
    assert bool(np.asarray(dec.facch_ok)[g0, 0, tn])
    got_l2 = np.asarray(l1fec.lsb8msb(np.asarray(dec.facch_bits)[g0, 0, tn]))
    np.testing.assert_array_equal(got_l2, facch_l2)
    assert bool(np.asarray(dec.tch_good)[g1, 0, tn])
    np.testing.assert_array_equal(
        np.asarray(dec.tch_speech)[g1, 0, tn],
        gsm610.payload_to_coder(payloads[0]))


def test_decode_block_static_slot_split_matches_full():
    """decode_block with xcch_tns/tch_tns/rach_tns restricted to the
    configured slots computes bit-identical results on those slots and
    not-ok/invalid elsewhere — the static slot split is a pure
    scheduling change (each Viterbi runs only where its channel type
    is configured, per TRXManager's demux table)."""
    import jax.numpy as jnp

    from openbts_ttsou_tpu.models.transceiver import (
        DECODE_PRELUDE,
        decode_block,
    )
    from openbts_ttsou_tpu.trx import engine as eng

    rng = np.random.default_rng(7)
    c, f = 2, 13
    soft = jnp.asarray(rng.random((f, c, 8, 148)).astype(np.float32))
    prev = jnp.asarray(
        rng.random((DECODE_PRELUDE, c, 8, 148)).astype(np.float32))
    res = eng.RxResult(
        detected=jnp.ones((f, c, 8), bool),
        is_rach=jnp.asarray(rng.random((f, c, 8)) < 0.3),
        soft_bits=soft,
        rssi=jnp.zeros((f, c, 8), jnp.int32),
        timing=jnp.zeros((f, c, 8), jnp.int32),
    )
    fn0 = jnp.asarray(51, jnp.int32)
    xt, tt, rt = (0, 1, 6, 7), (2, 3, 4, 5), (0,)
    full = decode_block(res, fn0, f, 5, prev_soft=prev,
                        prev_valid=jnp.asarray(True))
    part = decode_block(res, fn0, f, 5, prev_soft=prev,
                        prev_valid=jnp.asarray(True),
                        xcch_tns=xt, tch_tns=tt, rach_tns=rt)
    xt_a, tt_a, rt_a = list(xt), list(tt), list(rt)

    np.testing.assert_array_equal(np.asarray(part.bits)[:, :, xt_a],
                                  np.asarray(full.bits)[:, :, xt_a])
    np.testing.assert_array_equal(np.asarray(part.ok)[:, :, xt_a],
                                  np.asarray(full.ok)[:, :, xt_a])
    other = [t for t in range(8) if t not in xt]
    assert not np.asarray(part.ok)[:, :, other].any()

    np.testing.assert_array_equal(
        np.asarray(part.tch_speech)[:, :, tt_a],
        np.asarray(full.tch_speech)[:, :, tt_a])
    for fld in ("tch_good", "facch_ok", "tch_stolen"):
        np.testing.assert_array_equal(
            np.asarray(getattr(part, fld))[:, :, tt_a],
            np.asarray(getattr(full, fld))[:, :, tt_a])
        assert not np.asarray(getattr(part, fld))[
            :, :, [t for t in range(8) if t not in tt]].any()
    np.testing.assert_array_equal(
        np.asarray(part.facch_bits)[:, :, tt_a],
        np.asarray(full.facch_bits)[:, :, tt_a])

    np.testing.assert_array_equal(np.asarray(part.rach_ra)[:, :, rt_a],
                                  np.asarray(full.rach_ra)[:, :, rt_a])
    np.testing.assert_array_equal(np.asarray(part.rach_ok)[:, :, rt_a],
                                  np.asarray(full.rach_ok)[:, :, rt_a])
    assert not np.asarray(part.rach_ok)[:, :, 1:].any()


def test_duplex_decoded_slot_split_roundtrip_equivalence():
    """duplex_block_decoded with the static slot split produces the
    same tx stream and the same decodes on the configured slots as the
    unrestricted program (one window; tch_mask within tch_tns)."""
    import jax.numpy as jnp

    from openbts_ttsou_tpu.gsm import l1fec
    from openbts_ttsou_tpu.models.transceiver import (
        DECODE_PRELUDE,
        RX_HALO_DEV,
        TX_TAIL_SYM,
        UplinkSpec,
        XcchTxCarry,
        duplex_block_decoded,
    )
    from openbts_ttsou_tpu.trx import engine as eng

    rng = np.random.default_rng(13)
    c = 1
    cfg = eng.TrxConfig(n_chan=c)
    spec = UplinkSpec()
    state = eng.init_state(cfg)
    f = spec.frames

    xt, tt = (0, 1, 6, 7), (2, 3, 4, 5)
    tch_mask = np.zeros((c, 8), bool)
    tch_mask[:, 2:6] = True
    frames184 = rng.integers(0, 2, (4, c, 8, 184)).astype(np.uint8)
    xv = np.ones((4, c, 8), bool)
    speech = rng.integers(0, 2, (3, c, 8, 260)).astype(np.uint8)
    spv = np.ones((3, c, 8), bool)
    facch = np.zeros((3, c, 8, 184), np.uint8)
    fav = np.zeros((3, c, 8), bool)
    content = tuple(jnp.asarray(x) for x in
                    (frames184, xv, speech, spv, facch, fav, tch_mask))
    atten = jnp.zeros((f, c, 8), jnp.float32)
    ul = jnp.zeros((c, RX_HALO_DEV * 2 + spec.block_in), jnp.complex64)
    tail = jnp.zeros((c, TX_TAIL_SYM), jnp.complex64)
    prev = jnp.zeros((DECODE_PRELUDE, c, 8, 148), jnp.float32)

    outs = []
    for tns in ((None, None), (xt, tt)):
        tc0 = (l1fec.TchTxCarry.zeros(c * 8), XcchTxCarry.zeros(c))
        outs.append(duplex_block_decoded(
            cfg, spec, state, ul, tail, content, atten, tc0,
            jnp.asarray(0, jnp.int32), prev, jnp.asarray(False),
            0, 0, tns[0], tns[1]))
    (s_a, tx_a, tl_a, bl_a, cr_a, ps_a, pv_a) = outs[0]
    (s_b, tx_b, tl_b, bl_b, cr_b, ps_b, pv_b) = outs[1]

    # identical tx stream: XCCH slots carry XCCH, TCH slots TCH, and
    # the mask routes exactly as before the split
    np.testing.assert_array_equal(np.asarray(tx_a), np.asarray(tx_b))
    np.testing.assert_array_equal(np.asarray(tl_a), np.asarray(tl_b))
    # identical decodes on the configured slots
    np.testing.assert_array_equal(np.asarray(bl_a.bits)[:, :, list(xt)],
                                  np.asarray(bl_b.bits)[:, :, list(xt)])
    np.testing.assert_array_equal(
        np.asarray(bl_a.tch_speech)[:, :, list(tt)],
        np.asarray(bl_b.tch_speech)[:, :, list(tt)])
    # TCH tx carry agrees on the TCH lanes
    ca = np.asarray(cr_a[0][0]).reshape(c, 8, 8, 114)
    cb = np.asarray(cr_b[0][0]).reshape(c, 8, 8, 114)
    np.testing.assert_array_equal(ca[:, list(tt)], cb[:, list(tt)])
