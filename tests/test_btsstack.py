"""Full-stack integration: TRXManager ↔ TrxDaemon over the UDP wire
protocol, with the JAX engine and a loopback radio in the middle.

BTS side: LogicalChannel (SDCCH + LAPDm) → ARFCNManager →
[UDP data plane] → TrxDaemon (tx_step modulation) → LoopbackRadio →
(rx_step detection/demod) → [UDP] → ARFCNManager demux → XCCHL1 →
LAPDm. The echoed downlink must decode bit-exactly after the complete
radio round trip — the moral equivalent of the reference's
testRadio.cpp + SWLOOPBACK."""

import numpy as np
import pytest

from openbts_ttsou_tpu.gsm import channels, tdma
from openbts_ttsou_tpu.gsm.transfer import FrameType, L3Frame, Primitive
from openbts_ttsou_tpu.gsm.trxmanager import TransceiverManager
from openbts_ttsou_tpu.trx.daemon import TrxDaemon, TrxDaemonConfig
from openbts_ttsou_tpu.trx.radio import LoopbackRadio

BASE = 48700
TSC = 2


@pytest.fixture(scope="module")
def rig():
    daemon = TrxDaemon(LoopbackRadio(),
                       TrxDaemonConfig(base_port=BASE))
    mgr = TransceiverManager(n_arfcn=1, local_base=BASE + 100,
                             remote_base=BASE)
    yield daemon, mgr


def _cmd(daemon, arfcn, verb, *args):
    arfcn.ctrl_sock.send(
        __import__("openbts_ttsou_tpu.trx.protocol",
                   fromlist=["pack_command"]).pack_command(verb, *args))
    daemon.step()
    resp = arfcn.ctrl_sock.recv(256, timeout_ms=2000)
    assert resp is not None
    from openbts_ttsou_tpu.trx import protocol as proto

    kind, rverb, rargs = proto.parse_message(resp)
    assert kind == "RSP" and rverb == verb and rargs[0] == "0", resp
    return rargs


def test_full_stack_echo(rig):
    daemon, mgr = rig
    arfcn = mgr.arfcn(0)

    # --- bring-up over the control plane (OpenBTS.cpp:200-214) --------
    _cmd(daemon, arfcn, "RXTUNE", 890000)
    _cmd(daemon, arfcn, "TXTUNE", 935000)
    _cmd(daemon, arfcn, "SETTSC", TSC)
    _cmd(daemon, arfcn, "SETSLOT", 0, 7)  # combination VII (SDCCH/8)
    _cmd(daemon, arfcn, "POWERON")
    assert daemon.on

    # clock plane synced the BTS frame clock
    assert mgr.poll_clock(timeout_ms=2000)
    fn0 = mgr.clock.fn()
    assert fn0 > 0

    # --- BTS channel: SDCCH/8 subchannel 0 on TN0, echo-decodable -----
    dl, _ = tdma.SDCCH_8[0]
    l1 = channels.XCCHL1(0, dl, dl, tsc=TSC)  # loopback: decode own dl
    ch = channels.LogicalChannel(l1)
    arfcn.install_decoder(l1)
    sched_fn = daemon.tx_fn + 30
    ch.open(sched_fn)

    msg = np.random.default_rng(5).integers(0, 2, 160).astype(np.uint8)
    ch.send(L3Frame(msg, Primitive.UNIT_DATA))
    assert len(ch.l1.tx_queue) == 4
    for b in list(ch.l1.tx_queue):
        arfcn.write_high_side(b)
    ch.l1.tx_queue.clear()

    # --- run the transceiver until the echo lands ---------------------
    got_uplinks = 0
    for _ in range(200):
        daemon.step()
        got_uplinks += arfcn.drive_rx(timeout_ms=0)
        if ch.l1.good_frames:
            break
        if daemon.fn - sched_fn > 120:
            break
    assert got_uplinks >= 4, f"only {got_uplinks} uplink bursts"
    assert ch.l1.good_frames >= 1, (
        f"no good frames (bad={ch.l1.bad_frames}, uplinks={got_uplinks})")

    # the decoded L2 frame is our UI frame: it reached LAPDm as UNIT_DATA
    l3 = ch.recv()
    assert l3 is not None and l3.primitive == Primitive.UNIT_DATA
    np.testing.assert_array_equal(l3.bits[: len(msg)], msg)

    _cmd(daemon, arfcn, "POWEROFF")
