"""End-to-end over-the-air location update: a simulated MS performs the
complete GSM attach against the full BTS stack, entirely through the
radio path:

  MS RACH burst → engine detect → AccessGrantResponder → Immediate
  Assignment on AGCH (MS demodulates it off the air) → MS SABM+LUR on
  the assigned SDCCH/4 → LAPDm contention resolution → Control → SIP
  REGISTER (registrar stubbed) → Location Updating Accept with a TMSI
  delivered back over the air → MS decodes it.

This is the reference's RACH→LUR call stack (SURVEY §3.4) exercised
against real modulation, detection, FEC and LAPDm in both directions.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from openbts_ttsou_tpu.apps.openbts import BTSApp
from openbts_ttsou_tpu.gsm import l1fec, tdma
from openbts_ttsou_tpu.gsm.l3 import common as l3c
from openbts_ttsou_tpu.gsm.l3 import mm, parse_l3, rr
from openbts_ttsou_tpu.gsm.lapdm import L2LAPDm, LAPDState
from openbts_ttsou_tpu.gsm.transfer import FrameType, L2Frame
from openbts_ttsou_tpu.ops import correlate as xc
from openbts_ttsou_tpu.ops import gmsk
from openbts_ttsou_tpu.sip.message import SIPMessage, make_response
from openbts_ttsou_tpu.trx.daemon import SLOT_OFFSETS, TrxDaemon, TrxDaemonConfig
from openbts_ttsou_tpu.trx.radio import DuplexLoopbackRadio
from openbts_ttsou_tpu.utils import constants as C

BASE = 44700
IMSI = "001010123456789"
AMPL = 9000.0


class MS:
    """Minimal mobile-station simulation over the duplex radio."""

    def __init__(self, radio: DuplexLoopbackRadio, daemon: TrxDaemon,
                 bcc: int):
        self.radio = radio
        self.daemon = daemon
        self.bcc = bcc
        self.l2 = L2LAPDm(c=0, sapi=0)
        self.sdcch_sub = None

    def tx_burst(self, bits: np.ndarray, fn: int, tn: int = 0) -> None:
        wave = AMPL * gmsk.modulate_burst_np(
            np.asarray(bits, np.uint8)[None], 1, guard_len=9)[0]
        ts = self.daemon._frame_ts(fn) + int(SLOT_OFFSETS[tn])
        self.radio.ms_write(wave, ts)

    def tx_rach(self, ra: int, fn: int) -> None:
        coded = np.asarray(l1fec.rach_encode(
            np.asarray([ra]), np.asarray(self.bcc)))[0]
        bits = np.zeros(148, np.uint8)
        bits[:8] = [0, 1, 0, 1, 0, 1, 0, 1]
        bits[8:49] = C.RACH_SYNCH_SEQUENCE
        bits[49:85] = coded
        self.tx_burst(bits, fn)

    def rx_soft(self, fn: int, tn: int = 0):
        """Demodulate one downlink burst off the air."""
        ts = self.daemon._frame_ts(fn) + int(SLOT_OFFSETS[tn])
        raw = self.radio.ms_read(157, ts)
        if np.abs(raw).max() < 1.0:
            return None
        det, _, _ = xc.analyze_traffic_burst(raw[None], self.bcc, 1)
        if not bool(np.asarray(det.detected)[0]):
            return None
        soft = np.asarray(gmsk.demodulate_burst(
            raw[None], 1, det.amplitude, det.toa))[0]
        return soft[:148]

    def rx_l2_block(self, fns) -> L2Frame | None:
        softs = []
        for fn in fns:
            s = self.rx_soft(fn)
            if s is None:
                return None
            softs.append(s)
        frames, ok = l1fec.xcch_decode(np.stack(softs)[None])
        if not bool(np.asarray(ok)[0]):
            return None
        return L2Frame(np.asarray(l1fec.lsb8msb(np.asarray(frames)[0])))

    def tx_l2(self, frame: L2Frame, mapping: tdma.TDMAMapping,
              fn_from: int) -> int:
        bits = np.asarray(l1fec.lsb8msb(frame.bits))
        bursts = np.asarray(l1fec.xcch_encode(bits[None],
                                              tsc=self.bcc))[0]
        fn = fn_from
        for b in bursts:
            fn = mapping.next_write_time(fn)
            self.tx_burst(b, fn)
            fn += 1
        return fn


class DaemonClock:
    """Deterministic clock slaved to the simulated daemon (the
    wall-clock extrapolating Clock assumes real-time radio pacing)."""

    def __init__(self, daemon):
        self.daemon = daemon

    def fn(self):
        return self.daemon.tx_fn

    def set_fn(self, fn):
        pass


def make_rig(base=BASE):
    """BTSApp + TrxDaemon over a duplex loopback radio, configured and
    powered on: (app, daemon, radio, sip_out)."""
    radio = DuplexLoopbackRadio()
    daemon = TrxDaemon(radio, TrxDaemonConfig(base_port=base))
    app = BTSApp(trx_base_port=base)
    # the simulated radio runs much slower than real time; keep the
    # channel-recycling timers out of the way
    app.bts.config.set("GSM.Timer.T3101", "600000")
    app.bts.config.set("GSM.Timer.T3109", "600000")
    # a live MS acks one I-frame per 51-frame multiframe, so a 3-deep
    # release queue (MMInformation + LUAccept + ChannelRelease) takes
    # ~300 frames to drain; T3111 must span that (Control restarts the
    # deadline on drain progress, and the _reclaim_channels fixture —
    # not this timer — recycles channels between tests)
    app.bts.config.set("GSM.Timer.T3111", "2500")
    app.bts.clock = DaemonClock(daemon)
    for ch in app.dcch:
        ch.l1.clock = app.bts.clock.fn
        if ch.sacch is not None:
            ch.sacch.clock = app.bts.clock.fn
    # TCH FACCH LAPDm timers must follow the simulated frame clock too
    # (the very-early flow signals on the FACCH)
    for tch in app.bts.tch_pool:
        tch.l1.clock = app.bts.clock.fn
    sip_out = []
    app.control.sip_send = sip_out.append
    # deterministic bring-up: configure the daemon directly
    from openbts_ttsou_tpu.trx import protocol as proto

    for verb, args in (("RXTUNE", (890000,)), ("TXTUNE", (935000,)),
                       ("SETTSC", (app.bts.bcc,)), ("SETSLOT", (0, 5)),
                       ("POWERON", ())):
        daemon.handle_control(proto.pack_command(verb, *args))
    assert daemon.on
    return app, daemon, radio, sip_out


@pytest.fixture(scope="module")
def rig():
    app, daemon, radio, sip_out = make_rig()
    yield app, daemon, radio, sip_out
    app.shutdown()


def pump(app, daemon, frames=1):
    for _ in range(frames):
        daemon.step()
        app.step()


@pytest.fixture(autouse=True)
def _reclaim_channels(rig):
    """Each OTA scenario is independent (fresh RACH); tests routinely
    end mid-release (the simulated MS stops acking once it has what it
    asserts on), so reclaim every dedicated channel afterwards —
    otherwise leaked SDCCHs exhaust the pool for later module tests."""
    yield
    app, daemon, radio, sip_out = rig
    ctl = app.control
    for ch in list(app.dcch) + list(app.bts.tch_pool):
        ch.l1.close()
        if getattr(ch, "sacch", None) is not None:
            ch.sacch.close()
        if hasattr(ch, "reset"):
            ch.reset()
        app.bts.release(ch)
    ctl.channel_transactions.clear()
    ctl.pending_release.clear()
    for t in list(ctl.transactions.entries()):
        v = getattr(t, "voice", None)
        if v is not None and hasattr(v, "close"):
            v.close()
        if t.sip is not None:
            t.sip.close()
        ctl.transactions.remove(t.id)
    sip_out.clear()


def test_over_the_air_location_update(rig):
    location_update(*rig)


def location_update(app, daemon, radio, sip_out):
    """The over-the-air LUR scenario; returns the decoded accept."""
    ms = MS(radio, daemon, app.bts.bcc)
    pump(app, daemon, 5)  # beacon warm-up

    # --- 1. RACH in a combination-V access window ---------------------
    fn_r = daemon.fn + 8
    while fn_r % 51 not in range(14, 37):
        fn_r += 1
    ms.tx_rach(0x42, fn_r)
    agch_frames = None
    for _ in range(80):
        pump(app, daemon)
        if app.bts.sdcch_available() < app.bts.sdcch_total():
            break
    assert app.bts.sdcch_available() < app.bts.sdcch_total(), \
        "RACH not granted"

    # --- 2. MS finds the Immediate Assignment on the AGCH -------------
    ia = None
    fn = fn_r
    deadline = fn_r + 160
    while fn < deadline and ia is None:
        pump(app, daemon)
        # AGCH blocks start at frames ≡ 6 (mod 51)
        while fn < daemon.fn - 5:
            if fn % 51 == 6:
                frame = ms.rx_l2_block([fn, fn + 1, fn + 2, fn + 3])
                if frame is not None:
                    msg = parse_l3(frame.bits[8:])  # Bbis pseudolength
                    if isinstance(msg, rr.ImmediateAssignment):
                        ia = msg
                        break
            fn += 1
    assert ia is not None, "no Immediate Assignment decoded"
    assert ia.reference.ra == 0x42
    sub = ia.channel.type_and_offset - 4
    assert 0 <= sub < 4
    dl_map, ul_map = tdma.SDCCH_4[sub]

    # --- 3. SABM carrying the LUR (contention resolution) -------------
    lur = mm.LocationUpdatingRequest(
        app.bts.lai(), l3c.MobileIdentity.imsi(IMSI))
    payload = lur.encode()
    ms.l2._send_u(FrameType.SABM, True, ms.l2.c, payload)
    ms.l2.state = LAPDState.AwaitingEstablish  # awaiting the UA
    sabm = ms.l2.take_l1_out()[0]
    ms.tx_l2(sabm, ul_map, daemon.fn + 4)
    # run until the BTS issues the SIP REGISTER
    for _ in range(120):
        pump(app, daemon)
        if sip_out:
            break
    assert sip_out, "no REGISTER emitted"
    reg = SIPMessage.parse(sip_out.pop())
    assert reg.method == "REGISTER"
    assert f"IMSI{IMSI}" in (reg.get("from") or "")

    # --- 4. registrar accepts → LU Accept + TMSI over the air ---------
    t = app.control.transactions.entries()[0]
    ch = app.bts.sdcch_pool[sub]
    app.control.on_sip_response(t, ch, make_response(reg, 200, "OK"))
    accept = None
    guard = daemon.fn + 140
    fn = daemon.fn
    while fn < guard and accept is None:
        pump(app, daemon)
        while fn < daemon.fn - 5:
            if dl_map.reverse(fn) == 0:
                frame = ms.rx_l2_block([fn, fn + 1, fn + 2, fn + 3])
                if frame is not None:
                    ms.l2.write_low_side(frame)
            fn += 1
        while (l3 := ms.l2.read_high_side()) is not None:
            if len(l3.bits) >= 16:
                msg = parse_l3(l3.bits)
                if isinstance(msg, mm.LocationUpdatingAccept):
                    accept = msg
                    break
    assert accept is not None, "no LocationUpdatingAccept decoded"
    assert accept.identity is not None
    assert app.control.tmsis.imsi(accept.identity.tmsi) == IMSI
    assert accept.lai.lac == app.bts.lac
    return accept


def test_over_the_air_mo_call(rig):
    """Complete MO call signaling over the radio: RACH → SDCCH → CM
    Service → Setup → (SIP INVITE) → Alerting → Connect → ConnectAck →
    Disconnect/Release (SURVEY §3.5), with every L3 message crossing
    the modulation/FEC/LAPDm path in both directions."""
    from openbts_ttsou_tpu.gsm.l3 import cc
    from openbts_ttsou_tpu.gsm.transfer import L3Frame, Primitive
    from openbts_ttsou_tpu.sip.message import make_sdp

    app, daemon, radio, sip_out = rig
    sip_out.clear()
    ms = MS(radio, daemon, app.bts.bcc)

    # --- access: RACH → IA --------------------------------------------
    free_before = app.bts.sdcch_available()
    fn_r = daemon.fn + 8
    while fn_r % 51 not in range(14, 37):
        fn_r += 1
    ms.tx_rach(0x17, fn_r)
    for _ in range(80):
        pump(app, daemon)
        if app.bts.sdcch_available() < free_before:
            break
    assert app.bts.sdcch_available() < free_before
    ia = None
    fn = fn_r
    while fn < fn_r + 160 and ia is None:
        pump(app, daemon)
        while fn < daemon.fn - 5:
            if fn % 51 == 6:
                frame = ms.rx_l2_block([fn, fn + 1, fn + 2, fn + 3])
                if frame is not None:
                    msg = parse_l3(frame.bits[8:])
                    if isinstance(msg, rr.ImmediateAssignment) and \
                            msg.reference.ra == 0x17:
                        ia = msg
                        break
            fn += 1
    assert ia is not None
    sub = ia.channel.type_and_offset - 4
    dl_map, ul_map = tdma.SDCCH_4[sub]
    ch = app.bts.sdcch_pool[sub]

    # --- establish with CM Service Request in the SABM ----------------
    req = mm.CMServiceRequest(service_type=1,
                              identity=l3c.MobileIdentity.imsi(IMSI))
    ms.l2._send_u(FrameType.SABM, True, ms.l2.c, req.encode())
    ms.l2.state = LAPDState.AwaitingEstablish
    ul_fn = ms.tx_l2(ms.l2.take_l1_out()[0], ul_map, daemon.fn + 4)

    got = []
    fn_scan = daemon.fn - 10

    def ms_drive(rounds, want=None):
        """Pump; decode downlink blocks; transmit MS L2 responses."""
        nonlocal ul_fn, fn_scan
        for _ in range(rounds):
            pump(app, daemon)
            while fn_scan < daemon.fn - 5:
                if dl_map.reverse(fn_scan) == 0:
                    frame = ms.rx_l2_block([fn_scan, fn_scan + 1,
                                            fn_scan + 2, fn_scan + 3])
                    if frame is not None:
                        ms.l2.write_low_side(frame)
                fn_scan += 1
            for out in ms.l2.take_l1_out():
                ul_fn = ms.tx_l2(out, ul_map, max(ul_fn, daemon.fn + 4))
            while (l3 := ms.l2.read_high_side()) is not None:
                if len(l3.bits) >= 16:
                    m = parse_l3(l3.bits)
                    if m is not None:
                        got.append(m)
                        if want is not None and isinstance(m, want):
                            return m
        return None

    acc = ms_drive(140, mm.CMServiceAccept)
    assert acc is not None, f"no CMServiceAccept; got {got}"

    # --- Setup → CallProceeding + INVITE ------------------------------
    setup = cc.Setup(cc.CalledPartyBCDNumber("2125551212"))
    ms.l2.write_high_side(L3Frame(setup.encode(), Primitive.DATA))
    for out in ms.l2.take_l1_out():
        ul_fn = ms.tx_l2(out, ul_map, max(ul_fn, daemon.fn + 4))
    proc = ms_drive(160, cc.CallProceeding)
    assert proc is not None, f"no CallProceeding; got {got}"
    assert sip_out, "no INVITE emitted"
    invite = SIPMessage.parse(sip_out.pop(0))
    assert invite.method == "INVITE" and "2125551212" in invite.uri

    # --- remote rings then answers ------------------------------------
    t = app.control.transactions.find_by_imsi(IMSI)
    app.control.on_sip_response(
        t, ch, make_response(invite, 180, "Ringing", to_tag="rr"))
    alert = ms_drive(160, cc.Alerting)
    assert alert is not None, f"no Alerting; got {got}"
    app.control.on_sip_response(
        t, ch, make_response(invite, 200, "OK", to_tag="rr",
                             body=make_sdp("127.0.0.1", 40002)))
    conn = ms_drive(160, cc.Connect)
    assert conn is not None, f"no Connect; got {got}"
    # ACK went to the SIP side
    assert any(SIPMessage.parse(b).method == "ACK" for b in sip_out)
    sip_out.clear()

    # --- MS hangs up ---------------------------------------------------
    ms.l2.write_high_side(L3Frame(cc.Disconnect().encode(),
                                  Primitive.DATA))
    for out in ms.l2.take_l1_out():
        ul_fn = ms.tx_l2(out, ul_map, max(ul_fn, daemon.fn + 4))
    rel = ms_drive(160, cc.Release)
    assert rel is not None, f"no Release; got {got}"
    assert any(SIPMessage.parse(b).method == "BYE" for b in sip_out)


def test_over_the_air_mt_sms(rig):
    """MT-SMS end to end over the radio: page on the PCH → MS RACHes →
    Paging Response in the SABM → network-initiated SAPI-3 link →
    CP-DATA(RP-DATA(SMS-DELIVER)) off the air → MS returns CP-ACK +
    CP-DATA(RP-ACK) → transaction closed and SDCCH released
    (SMSControl.cpp:425 deliverSMSToMS over the full PHY/L2 path)."""
    from openbts_ttsou_tpu.sms import messages as sms_m

    app, daemon, radio, sip_out = rig
    sip_out.clear()
    ms = MS(radio, daemon, app.bts.bcc)
    ms.l2_sms = L2LAPDm(c=0, sapi=3)
    free_before = app.bts.sdcch_available()

    # --- network queues an MT-SMS; pager announces it ------------------
    TEXT = "wake up neo"
    app.control.initiate_mtsms(IMSI, "5552000", TEXT)
    page_id = None
    fn = daemon.fn
    guard = fn + 240
    while fn < guard and page_id is None:
        pump(app, daemon)
        while fn < daemon.fn - 5:
            if fn % 51 == 12:  # PCH block (CCCH[1])
                frame = ms.rx_l2_block([fn, fn + 1, fn + 2, fn + 3])
                if frame is not None:
                    msg = parse_l3(frame.bits[8:])
                    if isinstance(msg, rr.PagingRequestType1):
                        for ident in (msg.id1, msg.id2):
                            if ident is not None and ident.kind != 0:
                                page_id = ident
                                break
            fn += 1
    assert page_id is not None, "no page decoded on the PCH"

    # --- MS answers: RACH → IA → SABM(Paging Response) -----------------
    fn_r = daemon.fn + 8
    while fn_r % 51 not in range(14, 37):
        fn_r += 1
    ms.tx_rach(0x29, fn_r)
    ia = None
    fn = fn_r
    while fn < fn_r + 160 and ia is None:
        pump(app, daemon)
        while fn < daemon.fn - 5:
            if fn % 51 == 6:
                frame = ms.rx_l2_block([fn, fn + 1, fn + 2, fn + 3])
                if frame is not None:
                    msg = parse_l3(frame.bits[8:])
                    if isinstance(msg, rr.ImmediateAssignment) and \
                            msg.reference.ra == 0x29:
                        ia = msg
                        break
            fn += 1
    assert ia is not None, "no Immediate Assignment for the page answer"
    sub = ia.channel.type_and_offset - 4
    dl_map, ul_map = tdma.SDCCH_4[sub]

    resp = rr.PagingResponse(page_id)
    ms.l2._send_u(FrameType.SABM, True, ms.l2.c, resp.encode())
    ms.l2.state = LAPDState.AwaitingEstablish
    ul_fn = ms.tx_l2(ms.l2.take_l1_out()[0], ul_map, daemon.fn + 4)

    # --- drive both SAPs until the DELIVER arrives ---------------------
    deliver = None
    fn_scan = daemon.fn - 10
    for _ in range(240):
        pump(app, daemon)
        while fn_scan < daemon.fn - 5:
            if dl_map.reverse(fn_scan) == 0:
                frame = ms.rx_l2_block([fn_scan, fn_scan + 1,
                                        fn_scan + 2, fn_scan + 3])
                if frame is not None:
                    (ms.l2_sms if frame.sapi() == 3
                     else ms.l2).write_low_side(frame)
            fn_scan += 1
        for l2 in (ms.l2, ms.l2_sms):
            for out in l2.take_l1_out():
                ul_fn = ms.tx_l2(out, ul_map, max(ul_fn, daemon.fn + 4))
        while (l3 := ms.l2_sms.read_high_side()) is not None:
            if len(l3.bits) >= 16:
                cp = sms_m.parse_cp(np.packbits(l3.bits).tobytes())
                if isinstance(cp, sms_m.CPData):
                    rp = sms_m.parse_rp(cp.rpdu)
                    if isinstance(rp, sms_m.RPData):
                        deliver = sms_m.TLDeliver.parse(rp.tpdu)
                        break
        if deliver is not None:
            break
    assert deliver is not None, "no SMS-DELIVER decoded on SAPI 3"
    assert deliver.text == TEXT and deliver.orig == "5552000"
    assert ms.l2_sms.state == LAPDState.LinkEstablished

    # --- MS acknowledges: CP-ACK then CP-DATA(RP-ACK) ------------------
    from openbts_ttsou_tpu.gsm.transfer import L3Frame, Primitive

    for pdu in (sms_m.CPAck(ti=deliver and 0).encode(),
                sms_m.CPData(ti=0, rpdu=sms_m.RPAck(
                    reference=1, mo=True).encode()).encode()):
        bits = np.unpackbits(np.frombuffer(pdu, np.uint8))
        ms.l2_sms.write_high_side(L3Frame(bits, Primitive.DATA))
    closed = False
    # release closure is ack-paced: the ChannelRelease I-frame queues
    # behind the SMS exchange's downlink (one block per 51-multiframe)
    # and must be acknowledged before the deferred hard release fires
    for _ in range(700):
        pump(app, daemon)
        while fn_scan < daemon.fn - 5:
            if dl_map.reverse(fn_scan) == 0:
                frame = ms.rx_l2_block([fn_scan, fn_scan + 1,
                                        fn_scan + 2, fn_scan + 3])
                if frame is not None:
                    (ms.l2_sms if frame.sapi() == 3
                     else ms.l2).write_low_side(frame)
            fn_scan += 1
        for l2 in (ms.l2, ms.l2_sms):
            for out in l2.take_l1_out():
                ul_fn = ms.tx_l2(out, ul_map, max(ul_fn, daemon.fn + 4))
        from openbts_ttsou_tpu.control.common import ServiceType
        if app.control.transactions.find_by_imsi(
                IMSI, services=(ServiceType.MobileTerminatedSMS,)) is None \
                and app.bts.sdcch_available() == free_before:
            closed = True
            break
    assert closed, "MT-SMS transaction not closed / SDCCH not released"


def test_over_the_air_voice_call(rig):
    """Full MO voice call with traffic: signaling on the SDCCH, early
    assignment to a TCH/F, then GSM 06.10 speech frames over the air in
    BOTH directions bridged to RTP (assignTCHF CallControl.cpp:441-470
    and the in-call pump :393-407, over real modulation/FEC)."""
    import socket
    import struct

    from openbts_ttsou_tpu.control.voice import payload_to_rtp, rtp_to_payload
    from openbts_ttsou_tpu.gsm import channels
    from openbts_ttsou_tpu.gsm.l3 import cc
    from openbts_ttsou_tpu.gsm.transfer import L3Frame, Primitive, RxBurst
    from openbts_ttsou_tpu.sip.message import make_sdp
    from openbts_ttsou_tpu.trx import protocol as proto

    app, daemon, radio, sip_out = rig
    sip_out.clear()
    ms = MS(radio, daemon, app.bts.bcc)
    rng = np.random.default_rng(7)

    # --- access + CM service (as in the MO-call test) ------------------
    free_before = app.bts.sdcch_available()
    fn_r = daemon.fn + 8
    while fn_r % 51 not in range(14, 37):
        fn_r += 1
    ms.tx_rach(0x33, fn_r)
    for _ in range(80):
        pump(app, daemon)
        if app.bts.sdcch_available() < free_before:
            break
    ia = None
    fn = fn_r
    while fn < fn_r + 160 and ia is None:
        pump(app, daemon)
        while fn < daemon.fn - 5:
            if fn % 51 == 6:
                frame = ms.rx_l2_block([fn, fn + 1, fn + 2, fn + 3])
                if frame is not None:
                    msg = parse_l3(frame.bits[8:])
                    if isinstance(msg, rr.ImmediateAssignment) and \
                            msg.reference.ra == 0x33:
                        ia = msg
                        break
            fn += 1
    assert ia is not None
    sub = ia.channel.type_and_offset - 4
    dl_map, ul_map = tdma.SDCCH_4[sub]
    ch = app.bts.sdcch_pool[sub]

    req = mm.CMServiceRequest(service_type=1,
                              identity=l3c.MobileIdentity.imsi(IMSI))
    ms.l2._send_u(FrameType.SABM, True, ms.l2.c, req.encode())
    ms.l2.state = LAPDState.AwaitingEstablish
    ul_fn = ms.tx_l2(ms.l2.take_l1_out()[0], ul_map, daemon.fn + 4)

    got = []
    fn_scan = daemon.fn - 10

    def ms_drive(rounds, want=None):
        nonlocal ul_fn, fn_scan
        for _ in range(rounds):
            pump(app, daemon)
            while fn_scan < daemon.fn - 5:
                if dl_map.reverse(fn_scan) == 0:
                    frame = ms.rx_l2_block([fn_scan, fn_scan + 1,
                                            fn_scan + 2, fn_scan + 3])
                    if frame is not None:
                        ms.l2.write_low_side(frame)
                fn_scan += 1
            for out in ms.l2.take_l1_out():
                ul_fn = ms.tx_l2(out, ul_map, max(ul_fn, daemon.fn + 4))
            while (l3 := ms.l2.read_high_side()) is not None:
                if len(l3.bits) >= 16:
                    m = parse_l3(l3.bits)
                    if m is not None:
                        got.append(m)
                        if want is not None and isinstance(m, want):
                            return m
        return None

    assert ms_drive(140, mm.CMServiceAccept) is not None, f"got {got}"

    # --- call setup; early assignment lands during proceeding ----------
    setup = cc.Setup(cc.CalledPartyBCDNumber("8005551000"))
    ms.l2.write_high_side(L3Frame(setup.encode(), Primitive.DATA))
    for out in ms.l2.take_l1_out():
        ul_fn = ms.tx_l2(out, ul_map, max(ul_fn, daemon.fn + 4))
    assign = ms_drive(420, rr.AssignmentCommand)
    if assign is None:
        assign = next((m for m in got
                       if isinstance(m, rr.AssignmentCommand)), None)
    l2b = ch.l2[0]
    assert assign is not None, (
        f"no AssignmentCommand; got {got}; bts l2 state={l2b.state} "
        f"vs={l2b.vs} va={l2b.va} pending={len(l2b._pending_segments)} "
        f"l1out={len(l2b._l1_out)} txq={len(ch.l1.tx_queue)}")
    tch_tn = assign.channel.tn
    assert any(t.tn == tch_tn for t in app.bts.tch_pool)
    # the daemon must expect traffic bursts on that slot
    daemon.handle_control(proto.pack_command("SETSLOT", tch_tn, 1))

    invite = next(SIPMessage.parse(b) for b in sip_out
                  if SIPMessage.parse(b).method == "INVITE")
    sip_out.clear()
    t = max((x for x in app.control.transactions.entries()
             if x.imsi == IMSI and x.called == "8005551000"),
            key=lambda x: x.id, default=None) or \
        app.control.transactions.entries()[-1]

    # remote answers with SDP pointing at our test socket
    rtp_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rtp_sock.bind(("127.0.0.1", 0))
    rtp_sock.setblocking(False)
    rtp_port = rtp_sock.getsockname()[1]
    app.control.on_sip_response(
        t, ch, make_response(invite, 200, "OK", to_tag="vv",
                             body=make_sdp("127.0.0.1", rtp_port)))
    assert ms_drive(160, cc.Connect) is not None, f"no Connect; got {got}"

    # MS confirms the assignment (handled on the old channel)
    ms.l2.write_high_side(L3Frame(rr.AssignmentComplete().encode(),
                                  Primitive.DATA))
    for out in ms.l2.take_l1_out():
        ul_fn = ms.tx_l2(out, ul_map, max(ul_fn, daemon.fn + 4))
    for _ in range(6):
        ms_drive(50)
        if getattr(t, "voice", None) is not None:
            break
    assert getattr(t, "voice", None) is not None, "voice pump not attached"
    assert t.tch.l1.active and t.tch.tn == tch_tn

    # --- uplink speech: MS TCH modem → air → BTS → RTP -----------------
    ms_tx = channels.TCHFACCHL1(tch_tn, tdma.FACCH_TCHF,
                                tdma.FACCH_TCHF, tsc=app.bts.bcc)
    ms_tx.open(0)
    # align the first burst on an 8-burst interleaver boundary
    fn0 = daemon.fn + 6
    while not (tdma.FACCH_TCHF.reverse(fn0) is not None
               and tdma.FACCH_TCHF.reverse(fn0) % 8 == 0):
        fn0 += 1
    ms_tx.next_write_fn = fn0
    speech = [rng.integers(0, 2, 260).astype(np.uint8) for _ in range(3)]
    for fr in speech:
        ms_tx.send_tch(fr)
    for _ in range(4):  # 3 speech blocks + 1 filler to flush
        ms_tx.dispatch_block()
    bursts = list(ms_tx.tx_queue)
    ms_tx.tx_queue.clear()
    rtp_in = []
    bi = 0
    for _ in range(300):
        while bi < len(bursts) and bursts[bi].fn <= daemon.fn + 6:
            b = bursts[bi]
            ms.tx_burst(b.bits, b.fn, tn=tch_tn)
            bi += 1
        pump(app, daemon)
        try:
            while True:
                data, _ = rtp_sock.recvfrom(2048)
                if len(data) >= 12 + 33:
                    rtp_in.append(data[12:])
        except BlockingIOError:
            pass
        if len(rtp_in) >= 2 and bi >= len(bursts):
            break
    ups = [rtp_to_payload(p) for p in rtp_in]
    ups = [u for u in ups if u is not None]
    matches = sum(any(np.array_equal(u, s) for s in speech) for u in ups)
    assert matches >= 2, f"uplink speech not bridged ({len(ups)} frames)"

    # --- downlink speech: RTP → BTS → air → MS decode ------------------
    bts_rtp = t.sip.rtp
    down = [rng.integers(0, 2, 260).astype(np.uint8) for _ in range(3)]
    seq = 0
    for fr in down:
        hdr = struct.pack("!BBHII", 0x80, 3, seq, seq * 160, 0x1234)
        rtp_sock.sendto(hdr + payload_to_rtp(fr),
                        ("127.0.0.1", bts_rtp.local_port))
        seq += 1
    ms_rx = channels.TCHFACCHL1(tch_tn, tdma.FACCH_TCHF,
                                tdma.FACCH_TCHF, tsc=app.bts.bcc)
    ms_rx.open(0)
    fn_tch = daemon.fn - 2
    for _ in range(400):
        pump(app, daemon)
        while fn_tch < daemon.fn - 5:
            if tdma.FACCH_TCHF.reverse(fn_tch) is not None:
                soft = ms.rx_soft(fn_tch, tn=tch_tn)
                if soft is not None:
                    ms_rx.write_low_side(RxBurst(soft, fn=fn_tch,
                                                 tn=tch_tn))
            fn_tch += 1
        decoded = [d for d in ms_rx.speech_out if d.any()]
        if sum(any(np.array_equal(d, s) for s in down)
               for d in decoded) >= 2:
            break
    decoded = [d for d in ms_rx.speech_out if d.any()]
    matches = sum(any(np.array_equal(d, s) for s in down) for d in decoded)
    assert matches >= 2, \
        f"downlink speech not decoded ({len(ms_rx.speech_out)} frames)"

    # --- MS releases the link over the air (DISC → reclaim) ------------
    ms.l2.write_high_side(L3Frame(primitive=Primitive.RELEASE))
    for out in ms.l2.take_l1_out():
        ul_fn = ms.tx_l2(out, ul_map, max(ul_fn, daemon.fn + 4))
    freed = False
    for _ in range(200):
        pump(app, daemon)
        if app.bts.sdcch_available() == free_before:
            freed = True
            break
    assert freed, "SDCCH not reclaimed after MS DISC"


def test_over_the_air_sms_via_smqueue(rig):
    """The complete store-and-forward loop across BOTH daemons
    (SMSControl.cpp:301,425 bridged by smqueue.cpp): the MS submits an
    SMS over the air (MOSMSController → SIP MESSAGE), smqueue queues,
    rewrites the sender via the HLR and forwards, the BTS ingests the
    forwarded MESSAGE and pages the destination — which answers and
    decodes the SMS-DELIVER off the air."""
    import time as systime

    from openbts_ttsou_tpu.control.common import ServiceType
    from openbts_ttsou_tpu.smqueue import SMq
    from openbts_ttsou_tpu.sms import messages as sms_m

    app, daemon, radio, sip_out = rig
    sip_out.clear()
    app.control.hlr.add_user(IMSI, "5553000")  # self-addressed loop
    ms = MS(radio, daemon, app.bts.bcc)
    ms.l2_sms = L2LAPDm(c=0, sapi=3)
    TEXT = "ping via smqueue"

    # --- MO leg: RACH → SDCCH → CM Service (SMS) → CP-DATA -------------
    fn_r = daemon.fn + 8
    while fn_r % 51 not in range(14, 37):
        fn_r += 1
    ms.tx_rach(0x21, fn_r)
    ia = None
    fn = fn_r
    while fn < fn_r + 160 and ia is None:
        pump(app, daemon)
        while fn < daemon.fn - 5:
            if fn % 51 == 6:
                frame = ms.rx_l2_block([fn, fn + 1, fn + 2, fn + 3])
                if frame is not None:
                    msg = parse_l3(frame.bits[8:])
                    if isinstance(msg, rr.ImmediateAssignment) and \
                            msg.reference.ra == 0x21:
                        ia = msg
                        break
            fn += 1
    assert ia is not None, "no IA for the MO-SMS access"
    sub = ia.channel.type_and_offset - 4
    dl_map, ul_map = tdma.SDCCH_4[sub]

    req = mm.CMServiceRequest(service_type=4,
                              identity=l3c.MobileIdentity.imsi(IMSI))
    ms.l2._send_u(FrameType.SABM, True, ms.l2.c, req.encode())
    ms.l2.state = LAPDState.AwaitingEstablish
    ul_fn = ms.tx_l2(ms.l2.take_l1_out()[0], ul_map, daemon.fn + 4)
    fn_scan = daemon.fn - 10

    def ms_drive(rounds, until=lambda: False):
        nonlocal ul_fn, fn_scan
        for _ in range(rounds):
            pump(app, daemon)
            while fn_scan < daemon.fn - 5:
                if dl_map.reverse(fn_scan) == 0:
                    frame = ms.rx_l2_block([fn_scan, fn_scan + 1,
                                            fn_scan + 2, fn_scan + 3])
                    if frame is not None:
                        (ms.l2_sms if frame.sapi() == 3
                         else ms.l2).write_low_side(frame)
                fn_scan += 1
            for l2 in (ms.l2, ms.l2_sms):
                for out in l2.take_l1_out():
                    ul_fn = ms.tx_l2(out, ul_map,
                                     max(ul_fn, daemon.fn + 4))
            if until():
                return True
        return until()

    assert ms_drive(120, lambda: ms.l2.state == LAPDState.LinkEstablished)

    # SAPI-3 link first (empty SABM), then the CP-DATA as segmented
    # I-frames — a 36-byte CP PDU exceeds one frame's info field, the
    # LAPDm segmentation case (GSML2LAPDm.h:167, sendMultiframeData)
    ms.l2_sms._send_u(FrameType.SABM, True, ms.l2_sms.c)
    ms.l2_sms.state = LAPDState.AwaitingEstablish
    ul_fn = ms.tx_l2(ms.l2_sms.take_l1_out()[0], ul_map,
                     max(ul_fn, daemon.fn + 4))
    assert ms_drive(120,
                    lambda: ms.l2_sms.state == LAPDState.LinkEstablished)

    from openbts_ttsou_tpu.gsm.transfer import L3Frame, Primitive

    tl = sms_m.TLSubmit(mr=1, dest="5553000", text=TEXT)
    rp = sms_m.RPData(reference=2, dest="170", tpdu=tl.encode(), mo=True)
    cp = sms_m.CPData(ti=0, rpdu=rp.encode())
    cp_bits = np.unpackbits(np.frombuffer(cp.encode(), np.uint8))
    ms.l2_sms.write_high_side(L3Frame(cp_bits, Primitive.DATA))
    assert ms_drive(160, lambda: bool(sip_out)), "no SIP MESSAGE out"
    mo_msg = SIPMessage.parse(sip_out[-1])
    assert mo_msg.method == "MESSAGE" and mo_msg.body == TEXT
    assert mo_msg.uri_user("to") == "5553000"

    # --- smqueue daemon: queue, sender rewrite, forward ----------------
    forwarded = []
    smq = SMq(send=lambda to, rendered: forwarded.append((to, rendered)),
              resolve=lambda u: u if u == "5553000" else None,
              hlr=app.control.hlr)
    ok200 = smq.handle_sip_message(mo_msg)
    assert ok200.status == 200
    t0 = systime.monotonic()
    for k in range(8):
        smq.process_queue(t0 + k + 1)
        if forwarded:
            break
    assert forwarded, "smqueue did not forward the MESSAGE"
    to_user, rendered = forwarded[0]
    assert to_user == "5553000"
    mt_msg = SIPMessage.parse(rendered.encode())
    assert mt_msg.body == TEXT
    # sender rewritten from IMSI-form to the registered CLID
    assert mt_msg.uri_user("from") == "5553000"

    # --- BTS ingests the forwarded MESSAGE → pages the MS --------------
    app._on_message(mt_msg)
    t = app.control.transactions.find_by_imsi(
        IMSI, services=(ServiceType.MobileTerminatedSMS,))
    assert t is not None and t.message == TEXT

    # --- MT leg over the air: page → RACH → DELIVER --------------------
    ms2 = MS(radio, daemon, app.bts.bcc)
    ms2.l2_sms = L2LAPDm(c=0, sapi=3)
    page_id = None
    fn = daemon.fn
    guard = fn + 240
    while fn < guard and page_id is None:
        pump(app, daemon)
        while fn < daemon.fn - 5:
            if fn % 51 == 12:
                frame = ms2.rx_l2_block([fn, fn + 1, fn + 2, fn + 3])
                if frame is not None:
                    msg = parse_l3(frame.bits[8:])
                    if isinstance(msg, rr.PagingRequestType1):
                        for ident in (msg.id1, msg.id2):
                            if ident is not None and ident.kind != 0:
                                page_id = ident
                                break
            fn += 1
    assert page_id is not None, "no page for the forwarded SMS"

    fn_r2 = daemon.fn + 8
    while fn_r2 % 51 not in range(14, 37):
        fn_r2 += 1
    ms2.tx_rach(0x2D, fn_r2)
    ia2 = None
    fn = fn_r2
    while fn < fn_r2 + 160 and ia2 is None:
        pump(app, daemon)
        while fn < daemon.fn - 5:
            if fn % 51 == 6:
                frame = ms2.rx_l2_block([fn, fn + 1, fn + 2, fn + 3])
                if frame is not None:
                    msg = parse_l3(frame.bits[8:])
                    if isinstance(msg, rr.ImmediateAssignment) and \
                            msg.reference.ra == 0x2D:
                        ia2 = msg
                        break
            fn += 1
    assert ia2 is not None, "no IA for the page answer"
    sub2 = ia2.channel.type_and_offset - 4
    dl2, ul2 = tdma.SDCCH_4[sub2]

    resp = rr.PagingResponse(page_id)
    ms2.l2._send_u(FrameType.SABM, True, ms2.l2.c, resp.encode())
    ms2.l2.state = LAPDState.AwaitingEstablish
    ul_fn2 = ms2.tx_l2(ms2.l2.take_l1_out()[0], ul2, daemon.fn + 4)

    deliver = None
    fn_scan2 = daemon.fn - 10
    for _ in range(240):
        pump(app, daemon)
        while fn_scan2 < daemon.fn - 5:
            if dl2.reverse(fn_scan2) == 0:
                frame = ms2.rx_l2_block([fn_scan2, fn_scan2 + 1,
                                         fn_scan2 + 2, fn_scan2 + 3])
                if frame is not None:
                    (ms2.l2_sms if frame.sapi() == 3
                     else ms2.l2).write_low_side(frame)
            fn_scan2 += 1
        for l2 in (ms2.l2, ms2.l2_sms):
            for out in l2.take_l1_out():
                ul_fn2 = ms2.tx_l2(out, ul2, max(ul_fn2, daemon.fn + 4))
        while (l3 := ms2.l2_sms.read_high_side()) is not None:
            if len(l3.bits) >= 16:
                cpm = sms_m.parse_cp(np.packbits(l3.bits).tobytes())
                if isinstance(cpm, sms_m.CPData):
                    rpm = sms_m.parse_rp(cpm.rpdu)
                    if isinstance(rpm, sms_m.RPData):
                        deliver = sms_m.TLDeliver.parse(rpm.tpdu)
                        break
        if deliver is not None:
            break
    assert deliver is not None, "forwarded SMS never delivered OTA"
    assert deliver.text == TEXT
    assert deliver.orig == "5553000"


def test_over_the_air_veryearly_call(rig):
    """Very-early assignment MO call over the air: the MS RACHes and is
    granted a TCH/F directly; all signalling rides the FACCH (8-burst
    diagonal, stealing flags); the network switches the channel to
    speech mode with ChannelModeModify and blocks on the MS's
    acknowledge (MOCStarter veryEarly, CallControl.cpp:666-680); then
    uplink speech flows on the SAME channel and bridges to RTP."""
    import socket
    import struct

    from openbts_ttsou_tpu.control.voice import rtp_to_payload
    from openbts_ttsou_tpu.gsm import channels
    from openbts_ttsou_tpu.gsm.l3 import cc
    from openbts_ttsou_tpu.gsm.transfer import (
        ChannelType, L3Frame, Primitive, RxBurst,
    )
    from openbts_ttsou_tpu.sip.message import SIPMessage as SIPMsg
    from openbts_ttsou_tpu.sip.message import make_sdp
    from openbts_ttsou_tpu.trx import protocol as proto

    app, daemon, radio, sip_out = rig
    sip_out.clear()
    ms = MS(radio, daemon, app.bts.bcc)
    rng = np.random.default_rng(11)
    # earlier rig tests end with a LAPDm DISC instead of the full CC
    # release, leaving their reserved TCHs busy (the rig disables the
    # T3101/T3109 recycling sweep that would reclaim them); reclaim
    # here so this test starts with a free pool
    for t in list(app.control.transactions.entries()):
        app.control.transactions.remove(t.id)
    for tch in app.bts.tch_pool:
        tch.close()
        if hasattr(tch, "reset"):
            tch.reset()
        app.bts.release(tch)
        app.control.channel_transactions.pop(id(tch), None)
    app.bts.config.set("GSM.AssignmentType", "veryearly")
    try:
        # the daemon must expect traffic bursts on every TCH slot
        for tch in app.bts.tch_pool:
            daemon.handle_control(
                proto.pack_command("SETSLOT", tch.tn, 1))
        free_before = app.bts.tch_available()

        # --- RACH → Immediate Assignment straight onto a TCH/F --------
        fn_r = daemon.fn + 8
        while fn_r % 51 not in range(14, 37):
            fn_r += 1
        ms.tx_rach(0x2B, fn_r)
        for _ in range(80):
            pump(app, daemon)
            if app.bts.tch_available() < free_before:
                break
        assert app.bts.tch_available() < free_before, \
            "veryearly access grant did not allocate a TCH"
        ia = None
        fn = fn_r
        while fn < fn_r + 160 and ia is None:
            pump(app, daemon)
            while fn < daemon.fn - 5:
                if fn % 51 == 6:
                    frame = ms.rx_l2_block([fn, fn + 1, fn + 2, fn + 3])
                    if frame is not None:
                        msg = parse_l3(frame.bits[8:])
                        if isinstance(msg, rr.ImmediateAssignment) and \
                                msg.reference.ra == 0x2B:
                            ia = msg
                            break
                fn += 1
        assert ia is not None
        assert ia.channel.type_and_offset == 1, "IA must assign a TCH/F"
        tch_tn = ia.channel.tn
        bts_tch = next(t for t in app.bts.tch_pool if t.tn == tch_tn)

        # --- MS-side FACCH modem: tx + rx TCH/F L1s + LAPDm -----------
        ms_l2 = L2LAPDm(c=0, sapi=0, chan_type=ChannelType.FACCH)
        ms_tx = channels.TCHFACCHL1(tch_tn, tdma.FACCH_TCHF,
                                    tdma.FACCH_TCHF, tsc=app.bts.bcc)
        ms_tx.open(0)
        ms_rx = channels.TCHFACCHL1(tch_tn, tdma.FACCH_TCHF,
                                    tdma.FACCH_TCHF, tsc=app.bts.bcc)
        ms_rx.open(0)

        class _Sink:
            def write_low_side(self, frame):
                ms_l2.write_low_side(frame)

        ms_rx.upstream = _Sink()
        fn_scan = daemon.fn - 2
        got = []

        def ms_drive(rounds, want=None):
            """Pump; demodulate the downlink FACCH; send MS frames."""
            nonlocal fn_scan
            for _ in range(rounds):
                pump(app, daemon)
                while fn_scan < daemon.fn - 5:
                    if tdma.FACCH_TCHF.reverse(fn_scan) is not None:
                        soft = ms.rx_soft(fn_scan, tn=tch_tn)
                        if soft is not None:
                            ms_rx.write_low_side(
                                RxBurst(soft, fn=fn_scan, tn=tch_tn))
                    fn_scan += 1
                outs = ms_l2.take_l1_out()
                if outs:
                    ms_tx.resync(daemon.fn, lead=5)
                    for out in outs:
                        ms_tx.send_l2(out)
                    while ms_tx._facch_q or (
                            ms_tx._offset != 0 and ms_tx.tx_queue):
                        ms_tx.dispatch_block()
                    ms_tx.dispatch_block()  # flush the second diagonal
                while ms_tx.tx_queue and \
                        ms_tx.tx_queue[0].fn <= daemon.fn + 30:
                    b = ms_tx.tx_queue.popleft()
                    if b.fn > daemon.fn - 2:
                        ms.tx_burst(b.bits, b.fn, tn=tch_tn)
                while (l3 := ms_l2.read_high_side()) is not None:
                    if len(l3.bits) >= 16:
                        m = parse_l3(l3.bits)
                        if m is not None:
                            got.append(m)
                            if want is not None and isinstance(m, want):
                                return m
            return None

        # --- establish on the FACCH with CM Service Request -----------
        req = mm.CMServiceRequest(
            service_type=1, identity=l3c.MobileIdentity.imsi(IMSI))
        ms_l2._send_u(FrameType.SABM, True, ms_l2.c, req.encode())
        ms_l2.state = LAPDState.AwaitingEstablish
        acc = ms_drive(200, mm.CMServiceAccept)
        assert acc is not None, f"no CMServiceAccept on FACCH; got {got}"

        # --- Setup → CallProceeding + ChannelModeModify ----------------
        ms_l2.write_high_side(L3Frame(
            cc.Setup(cc.CalledPartyBCDNumber("7005551111")).encode(),
            Primitive.DATA))
        cmm = ms_drive(300, rr.ChannelModeModify)
        assert cmm is not None, f"no ChannelModeModify; got {got}"
        assert cmm.mode == rr.ChannelMode.SpeechV1
        assert cmm.channel.type_and_offset == 1
        assert cmm.channel.tn == tch_tn
        assert any(isinstance(m, cc.CallProceeding) for m in got)
        invite = next(SIPMsg.parse(b) for b in sip_out
                      if SIPMsg.parse(b).method == "INVITE")
        sip_out.clear()

        # --- MS acknowledges the mode change ---------------------------
        ms_l2.write_high_side(L3Frame(
            rr.ChannelModeModifyAcknowledge(
                cmm.channel, cmm.mode).encode(), Primitive.DATA))
        t = max((x for x in app.control.transactions.entries()
                 if x.imsi == IMSI and x.called == "7005551111"),
                key=lambda x: x.id)
        for _ in range(12):
            ms_drive(30)
            if getattr(t, "pending_mode", "unset") is None:
                break
        assert getattr(t, "pending_mode", "unset") is None, \
            f"mode-modify ack not processed; got {got}"
        assert getattr(t, "tch", None) is bts_tch

        # --- remote answers; MS connects; voice pump attaches ----------
        rtp_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rtp_sock.bind(("127.0.0.1", 0))
        rtp_sock.setblocking(False)
        app.control.on_sip_response(
            t, bts_tch, make_response(
                invite, 200, "OK", to_tag="ve",
                body=make_sdp("127.0.0.1",
                              rtp_sock.getsockname()[1])))
        conn = ms_drive(200, cc.Connect)
        assert conn is not None, f"no Connect on FACCH; got {got}"
        ack = cc.ConnectAcknowledge()
        ack.ti = conn.ti & 0x7  # MS echoes the TI without the flag
        ms_l2.write_high_side(L3Frame(ack.encode(), Primitive.DATA))
        for _ in range(10):
            ms_drive(20)
            if getattr(t, "voice", None) is not None:
                break
        assert getattr(t, "voice", None) is not None, \
            "voice pump not attached after ConnectAcknowledge"

        # --- uplink speech on the SAME channel -------------------------
        fn0 = daemon.fn + 6
        while not (tdma.FACCH_TCHF.reverse(fn0) is not None
                   and tdma.FACCH_TCHF.reverse(fn0) % 8 == 0):
            fn0 += 1
        ms_tx.next_write_fn = fn0
        ms_tx._offset = 0
        ms_tx._itx[:] = 0
        speech = [rng.integers(0, 2, 260).astype(np.uint8)
                  for _ in range(3)]
        for fr in speech:
            ms_tx.send_tch(fr)
        for _ in range(4):
            ms_tx.dispatch_block()
        bursts = list(ms_tx.tx_queue)
        ms_tx.tx_queue.clear()
        rtp_in = []
        bi = 0
        for _ in range(300):
            while bi < len(bursts) and bursts[bi].fn <= daemon.fn + 6:
                b = bursts[bi]
                ms.tx_burst(b.bits, b.fn, tn=tch_tn)
                bi += 1
            pump(app, daemon)
            try:
                while True:
                    data, _ = rtp_sock.recvfrom(2048)
                    if len(data) >= 12 + 33:
                        rtp_in.append(data[12:])
            except BlockingIOError:
                pass
            if len(rtp_in) >= 2 and bi >= len(bursts):
                break
        ups = [rtp_to_payload(p) for p in rtp_in]
        ups = [u for u in ups if u is not None]
        matches = sum(any(np.array_equal(u, s) for s in speech)
                      for u in ups)
        assert matches >= 2, \
            f"uplink speech not bridged after mode set ({len(ups)})"
    finally:
        app.bts.config.set("GSM.AssignmentType", "early")

def test_over_the_air_lur_delivers_shortname(rig):
    """LUR with GSM.ShortName configured: the MS decodes an
    MMInformation carrying the name BEFORE the LocationUpdatingAccept
    (MobilityManagement.cpp:203) — the `shortname` CLI knob is a real,
    transmitted feature."""
    app, daemon, radio, sip_out = rig
    sip_out.clear()
    # clear stragglers from earlier module tests: deferred releases
    # hard-release at the T3111 deadline under pumping
    for _ in range(200):
        if app.bts.sdcch_available() == app.bts.sdcch_total() and \
                not app.control.pending_release:
            break
        pump(app, daemon)
    app.bts.config.set("GSM.ShortName", "TestNet")
    try:
        ms = MS(radio, daemon, app.bts.bcc)
        free_before = app.bts.sdcch_available()
        fn_r = daemon.fn + 8
        while fn_r % 51 not in range(14, 37):
            fn_r += 1
        ms.tx_rach(0x31, fn_r)
        for _ in range(80):
            pump(app, daemon)
            if app.bts.sdcch_available() < free_before:
                break
        assert app.bts.sdcch_available() < free_before
        ia = None
        fn = fn_r
        while fn < fn_r + 160 and ia is None:
            pump(app, daemon)
            while fn < daemon.fn - 5:
                if fn % 51 == 6:
                    frame = ms.rx_l2_block([fn, fn + 1, fn + 2, fn + 3])
                    if frame is not None:
                        msg = parse_l3(frame.bits[8:])
                        if isinstance(msg, rr.ImmediateAssignment) and \
                                msg.reference.ra == 0x31:
                            ia = msg
                            break
                fn += 1
        assert ia is not None
        sub = ia.channel.type_and_offset - 4
        dl_map, ul_map = tdma.SDCCH_4[sub]
        ch = app.bts.sdcch_pool[sub]

        lur = mm.LocationUpdatingRequest(
            app.bts.lai(), l3c.MobileIdentity.imsi(IMSI))
        ms.l2._send_u(FrameType.SABM, True, ms.l2.c, lur.encode())
        ms.l2.state = LAPDState.AwaitingEstablish
        ul_fn = ms.tx_l2(ms.l2.take_l1_out()[0], ul_map, daemon.fn + 4)
        for _ in range(140):
            pump(app, daemon)
            if sip_out:
                break
        assert sip_out, "no REGISTER emitted"
        reg = SIPMessage.parse(sip_out.pop())
        t = app.control.transactions.entries()[0]
        app.control.on_sip_response(t, ch, make_response(reg, 200, "OK"))

        got = []
        fn_scan = daemon.fn - 10
        guard = daemon.fn + 500  # 3 queued blocks at 1/multiframe
        while daemon.fn < guard and not any(
                isinstance(m, mm.LocationUpdatingAccept) for m in got):
            pump(app, daemon)
            while fn_scan < daemon.fn - 5:
                if dl_map.reverse(fn_scan) == 0:
                    frame = ms.rx_l2_block([fn_scan, fn_scan + 1,
                                            fn_scan + 2, fn_scan + 3])
                    if frame is not None:
                        ms.l2.write_low_side(frame)
                fn_scan += 1
            for out in ms.l2.take_l1_out():
                ul_fn = ms.tx_l2(out, ul_map, max(ul_fn, daemon.fn + 4))
            while (l3 := ms.l2.read_high_side()) is not None:
                if len(l3.bits) >= 16:
                    m = parse_l3(l3.bits)
                    if m is not None:
                        got.append(m)
        kinds = [type(m).__name__ for m in got]
        infos = [m for m in got if isinstance(m, mm.MMInformation)]
        assert infos, f"no MMInformation off the air; got {kinds}"
        assert infos[0].short_name == "TestNet"
        # ordering: the name precedes the accept (the reference's send
        # order at MobilityManagement.cpp:203-207)
        assert kinds.index("MMInformation") < \
            kinds.index("LocationUpdatingAccept")
    finally:
        app.bts.config.set("GSM.ShortName", "")


def test_over_the_air_emergency_call_progress_and_hold(rig):
    """Emergency call via the EmergencySetup MTI with the in-call
    legs: E-MOC routes to PBX.Emergency (CallControl.cpp:1020-1060),
    SIP 100 Trying produces L3 Progress (:739), and an in-call Hold is
    rejected with HoldReject cause 0x3f (:356-360) — every message
    crossing the air interface."""
    from openbts_ttsou_tpu.gsm.l3 import cc
    from openbts_ttsou_tpu.gsm.transfer import L3Frame, Primitive

    app, daemon, radio, sip_out = rig
    sip_out.clear()
    # clear stragglers from earlier module tests: deferred releases
    # hard-release at the T3111 deadline under pumping
    for _ in range(200):
        if app.bts.sdcch_available() == app.bts.sdcch_total() and \
                not app.control.pending_release:
            break
        pump(app, daemon)
    app.bts.config.set("PBX.Emergency", "112")
    ms = MS(radio, daemon, app.bts.bcc)

    free_before = app.bts.sdcch_available()
    fn_r = daemon.fn + 8
    while fn_r % 51 not in range(14, 37):
        fn_r += 1
    ms.tx_rach(0x2A, fn_r)
    for _ in range(80):
        pump(app, daemon)
        if app.bts.sdcch_available() < free_before:
            break
    assert app.bts.sdcch_available() < free_before
    ia = None
    fn = fn_r
    while fn < fn_r + 160 and ia is None:
        pump(app, daemon)
        while fn < daemon.fn - 5:
            if fn % 51 == 6:
                frame = ms.rx_l2_block([fn, fn + 1, fn + 2, fn + 3])
                if frame is not None:
                    msg = parse_l3(frame.bits[8:])
                    if isinstance(msg, rr.ImmediateAssignment) and \
                            msg.reference.ra == 0x2A:
                        ia = msg
                        break
            fn += 1
    assert ia is not None
    sub = ia.channel.type_and_offset - 4
    dl_map, ul_map = tdma.SDCCH_4[sub]

    req = mm.CMServiceRequest(service_type=8,
                              identity=l3c.MobileIdentity.imsi(IMSI))
    ms.l2._send_u(FrameType.SABM, True, ms.l2.c, req.encode())
    ms.l2.state = LAPDState.AwaitingEstablish
    ul_fn = ms.tx_l2(ms.l2.take_l1_out()[0], ul_map, daemon.fn + 4)

    got = []
    fn_scan = daemon.fn - 10

    def ms_drive(rounds, want=None):
        nonlocal ul_fn, fn_scan
        for _ in range(rounds):
            pump(app, daemon)
            while fn_scan < daemon.fn - 5:
                if dl_map.reverse(fn_scan) == 0:
                    frame = ms.rx_l2_block([fn_scan, fn_scan + 1,
                                            fn_scan + 2, fn_scan + 3])
                    if frame is not None:
                        ms.l2.write_low_side(frame)
                fn_scan += 1
            for out in ms.l2.take_l1_out():
                ul_fn = ms.tx_l2(out, ul_map, max(ul_fn, daemon.fn + 4))
            while (l3 := ms.l2.read_high_side()) is not None:
                if len(l3.bits) >= 16:
                    m = parse_l3(l3.bits)
                    if m is not None:
                        got.append(m)
                        if want is not None and isinstance(m, want):
                            return m
        return None

    acc = ms_drive(140, mm.CMServiceAccept)
    assert acc is not None, f"no CMServiceAccept; got {got}"

    # --- EmergencySetup MTI → CallProceeding + INVITE to 112 ----------
    es = cc.EmergencySetup()
    es.ti = 0x05
    ms.l2.write_high_side(L3Frame(es.encode(), Primitive.DATA))
    for out in ms.l2.take_l1_out():
        ul_fn = ms.tx_l2(out, ul_map, max(ul_fn, daemon.fn + 4))
    proc = ms_drive(160, cc.CallProceeding)
    assert proc is not None, f"no CallProceeding; got {got}"
    assert proc.ti == (1 << 3) | 5
    assert sip_out, "no INVITE emitted"
    invite = SIPMessage.parse(sip_out.pop(0))
    assert invite.method == "INVITE" and "112" in invite.uri

    ch = app.bts.sdcch_pool[sub]
    t = app.control.transactions.find_by_imsi(IMSI)

    # --- 100 Trying → Progress off the air ----------------------------
    app.control.on_sip_response(t, ch,
                                make_response(invite, 100, "Trying"))
    prog = ms_drive(160, cc.Progress)
    assert prog is not None, f"no Progress; got {got}"
    assert prog.ti == (1 << 3) | 5

    # --- in-call Hold → HoldReject ------------------------------------
    hold = cc.Hold()
    hold.ti = 0x05
    ms.l2.write_high_side(L3Frame(hold.encode(), Primitive.DATA))
    for out in ms.l2.take_l1_out():
        ul_fn = ms.tx_l2(out, ul_map, max(ul_fn, daemon.fn + 4))
    rej = ms_drive(160, cc.HoldReject)
    assert rej is not None, f"no HoldReject; got {got}"
    assert rej.cause.value == 0x3F
    assert rej.ti == (1 << 3) | 5

    # --- teardown ------------------------------------------------------
    disc = cc.Disconnect()
    disc.ti = 0x05
    ms.l2.write_high_side(L3Frame(disc.encode(), Primitive.DATA))
    for out in ms.l2.take_l1_out():
        ul_fn = ms.tx_l2(out, ul_map, max(ul_fn, daemon.fn + 4))
    rel = ms_drive(160, cc.Release)
    assert rel is not None, f"no Release; got {got}"
    assert rel.ti == (1 << 3) | 5  # MO transaction keeps flag 1
