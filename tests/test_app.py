"""BTSApp composition test: app + in-thread transceiver daemon."""

import threading
import time

import numpy as np
import pytest

from openbts_ttsou_tpu.apps.openbts import BTSApp
from openbts_ttsou_tpu.cli import Parser
from openbts_ttsou_tpu.trx.daemon import TrxDaemon, TrxDaemonConfig
from openbts_ttsou_tpu.trx.radio import LoopbackRadio

BASE = 49700


@pytest.fixture(scope="module")
def rig():
    daemon = TrxDaemon(LoopbackRadio(), TrxDaemonConfig(base_port=BASE))
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            daemon.step()
            time.sleep(0.001)

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    app = BTSApp(trx_base_port=BASE)
    yield app, daemon
    stop.set()
    t.join(timeout=2)
    app.shutdown()


def test_bringup_and_beacon(rig):
    app, daemon = rig
    assert app.bringup()
    assert daemon.on
    # clock synced from IND CLOCK
    deadline = time.time() + 5
    while time.time() < deadline and app.bts.clock.fn() == 0:
        app.trx.poll_clock(timeout_ms=100)
    assert app.bts.clock.fn() > 0
    # service loop schedules beacon bursts into the daemon; the
    # daemon's first frame includes the engine jit compile, so poll
    # with a generous deadline rather than a fixed step count
    deadline = time.time() + 120
    while time.time() < deadline and daemon.fn == 0 and \
            len(daemon.pending_tx) == 0:
        app.step()
        time.sleep(0.005)
    assert len(daemon.pending_tx) > 0 or daemon.fn > 0


def test_cli_commands(rig):
    app, _ = rig
    p = app.parser
    assert "uptime" in p.process("help")
    assert "openbts-ttsou-tpu" in p.process("version")
    assert "frame number" in p.process("uptime")
    assert "SDCCH" in p.process("load")
    out = p.process("cellid 310 260 777 42")
    assert "LAC=777" in out and "CI=42" in out
    assert p.process("config GSM.Foo bar") == "set"
    assert "GSM.Foo bar" in p.process("config GSM.Foo")
    assert "(empty)" in p.process("tmsis") or p.process("tmsis")
    assert "paging" in p.process("page 001010123456789 5")
    assert "unknown command" in p.process("bogus")
    assert "usage" in p.process("page")
    assert "TN0" in p.process("chans")
    # CLI.cpp:685-712 verbs added for full parity
    assert p.process("assignment") == "early"
    assert p.process("assignment veryearly") == "veryearly"
    assert "usage" in p.process("assignment sometimes")
    assert p.process("shortname OpenBTS-X") == "OpenBTS-X"
    lac0 = app.bts.lac
    assert f"LAC={lac0 + 1}" in p.process("rolllac")
    assert "LAC=555" in p.process("rolllac 555")
    assert "(no matches)" in p.process("findimsi 99999")
    assert "logging to" in p.process("setlogfile /tmp/cli_verbs.log")


def test_cli_sendsms_and_calls(rig):
    app, _ = rig
    out = app.parser.process("sendsms 001010123456789 100 hello there")
    assert "queued" in out
    assert "MobileTerminatedSMS" in app.parser.process("calls")
    tid = app.control.transactions.entries()[0].id
    assert "removed" in app.parser.process(f"endcall {tid}")


def test_config_file_driven_app(tmp_path):
    from openbts_ttsou_tpu.utils.config import ConfigurationTable

    cfg = ConfigurationTable("examples/openbts.config")
    assert cfg.get_int("GSM.ARFCN") == 207
    assert cfg.is_static("GSM.ARFCN")
    from openbts_ttsou_tpu.gsm.btsconfig import BTSConfig

    bts = BTSConfig(cfg)
    assert bts.arfcn == 207 and bts.lac == 1000
    assert bts.bsic() == 2


def test_sdcch8_slots_from_config():
    """GSM.NumC7s builds SDCCH/8 sets on their own slots
    (combination VII, the reference's NumC7s loop)."""
    import threading

    from openbts_ttsou_tpu.utils.config import ConfigurationTable

    daemon = TrxDaemon(LoopbackRadio(), TrxDaemonConfig(base_port=49790))
    cfg = ConfigurationTable()
    cfg.set("GSM.NumC7s", "1")
    cfg.set("GSM.NumTCH", "1")
    app = BTSApp(cfg, trx_base_port=49790)
    try:
        # 4 SDCCH/4 + 8 SDCCH/8
        assert app.bts.sdcch_total() == 12
        assert sum(1 for ch in app.bts.sdcch_pool if ch.l1.tn == 1) == 8
        # TCH moved past the C-VII slot
        assert [t.tn for t in app.bts.tch_pool] == [2]
        stop = threading.Event()

        def loop():
            while not stop.is_set():
                daemon.step()
                time.sleep(0.001)

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        try:
            assert app.bringup()
        finally:
            stop.set()
            t.join(timeout=2)
    finally:
        app.shutdown()


def test_sacch_si56_fill(rig):
    """Open SACCHs idle-fill with the SI5/SI6 rotation."""
    app, daemon = rig
    ch = app.bts.get_sdcch()
    try:
        ch.open(app.bts.clock.fn())
        for _ in range(10):
            app.step()
            time.sleep(0.002)
        total = app._si56_flip
        assert total >= 1  # fill frames were generated
    finally:
        ch.l1.close()
        if ch.sacch is not None:
            ch.sacch.close()
        app.bts.release(ch)


def test_ms_link_release_reclaims_channel(rig):
    """An MS DISC (LAPDm release) hands the SDCCH back to the pool
    (the reference's post-RELEASE close-out in DCCHDispatch)."""
    from openbts_ttsou_tpu.gsm.lapdm import LAPDState

    app, daemon = rig
    free0 = app.bts.sdcch_available()
    ch = app.bts.get_sdcch()
    ch.open(app.bts.clock.fn())
    # simulate an established then MS-released link
    ch.l2[0].state = LAPDState.LinkEstablished
    app.step()
    ch.l2[0].state = LAPDState.LinkReleased
    app.step()
    assert app.bts.sdcch_available() == free0
    assert not ch.l1.active


def test_inbound_sip_message_and_invite_hooks(rig):
    """Inbound SIP MESSAGE → MT-SMS transaction + page; INVITE →
    MT-call transaction + page (SIPInterface demux callbacks)."""
    from openbts_ttsou_tpu.control.common import ServiceType
    from openbts_ttsou_tpu.sip.message import make_request

    app, _ = rig
    imsi = "001019999999999"
    msg = make_request("MESSAGE", f"IMSI{imsi}", "411", "127.0.0.1",
                       5062, "127.0.0.1", 5060, body="mt text")
    app._on_message(msg)
    t = app.control.transactions.find_by_imsi(
        imsi, services=(ServiceType.MobileTerminatedSMS,))
    assert t is not None and t.message == "mt text"
    assert app.bts.pager.size() >= 1
    app.control.transactions.remove(t.id)

    inv = make_request("INVITE", f"IMSI{imsi}", "2125550000",
                       "127.0.0.1", 5062, "127.0.0.1", 5060)
    app._on_invite(inv)
    t = app.control.transactions.find_by_imsi(
        imsi, services=(ServiceType.MobileTerminatedCall,))
    assert t is not None and t.calling == "2125550000"
    assert t.sip is not None
    app.control.transactions.remove(t.id)


def test_very_early_assignment(rig):
    """CLI `assignment veryearly` sends the RACH response straight to a
    TCH/F (channel type 1) whose FACCH binds the eventual transaction
    (AccessGrantResponder channel-type choice + TCHFACCHLogicalChannel,
    GSMLogicalChannel.h:411-455)."""
    from openbts_ttsou_tpu.gsm.l3 import rr
    from openbts_ttsou_tpu.utils.gsm_time import Time

    app, _ = rig
    app.parser.process("assignment veryearly")
    try:
        ch = app.control.handle_rach(0x05, Time(1000, 0), -50.0, 1.0)
        assert ch is not None and ch.is_tch
        assert ch.l1.active
        # the immediate assignment queued on the AGCH carries TCH/F
        frame = app.bts.agch_q[-1]
        from openbts_ttsou_tpu.gsm.l3 import parse_l3

        msg = parse_l3(np.asarray(frame.bits))
        assert isinstance(msg, rr.ImmediateAssignment)
        assert msg.channel.type_and_offset == 1
        assert msg.channel.tn == ch.l1.tn
    finally:
        ch.l1.close()
        app.bts.release(ch)
        app.parser.process("assignment early")


def test_facch_transaction_binding(rig):
    """assign_tch binds the transaction to the TCH so AssignmentComplete
    arriving on the FACCH resolves it (RadioResource.cpp:285)."""
    from openbts_ttsou_tpu.gsm.l3 import rr

    app, _ = rig
    from openbts_ttsou_tpu.control.common import ServiceType

    ctl = app.control
    sd = app.bts.get_sdcch()
    t = ctl.transactions.new(ServiceType.MobileOriginatedCall,
                             imsi="001010000000099")
    ctl.channel_transactions[id(sd)] = t.id
    ctl.assign_tch(sd, t)
    assert getattr(t, "tch", None) is not None
    assert ctl.channel_transactions[id(t.tch)] == t.id
    # AssignmentComplete on the TCH (FACCH) opens it + resolves t
    ctl.assignment_complete(t.tch, rr.AssignmentComplete())
    assert t.tch.l1.active
    t.tch.l1.close()
    app.bts.release(t.tch)
    app.bts.release(sd)
