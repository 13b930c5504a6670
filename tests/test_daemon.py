"""End-to-end daemon test: a fake BTS drives the transceiver daemon over
the reference's UDP wire protocol with a loopback radio — this
framework's equivalent of the reference's testRadio.cpp + SWLOOPBACK flow."""

import numpy as np
import pytest

from openbts_ttsou_tpu.runtime import UdpTransport
from openbts_ttsou_tpu.trx import protocol as proto
from openbts_ttsou_tpu.trx.daemon import TrxDaemon, TrxDaemonConfig
from openbts_ttsou_tpu.trx.engine import ChanType
from openbts_ttsou_tpu.utils import constants as C

BASE = 47700


@pytest.fixture(scope="module")
def rig():
    daemon = TrxDaemon(
        __import__("openbts_ttsou_tpu.trx.radio", fromlist=["LoopbackRadio"])
        .LoopbackRadio(),
        TrxDaemonConfig(base_port=BASE),
    )
    bts_clock = UdpTransport(BASE + 100, "127.0.0.1", BASE)
    bts_ctrl = UdpTransport(BASE + 101, "127.0.0.1", BASE + 1)
    bts_data = UdpTransport(BASE + 102, "127.0.0.1", BASE + 2)
    yield daemon, bts_clock, bts_ctrl, bts_data
    for s in (bts_clock, bts_ctrl, bts_data):
        s.close()


def _cmd(daemon, ctrl, verb, *args):
    ctrl.send(proto.pack_command(verb, *args))
    daemon.step()
    resp = ctrl.recv(256, timeout_ms=2000)
    assert resp is not None, f"no response to {verb}"
    kind, rverb, rargs = proto.parse_message(resp)
    assert kind == "RSP" and rverb == verb
    return int(rargs[0]), rargs[1:]


def test_bringup_sequence(rig):
    daemon, bts_clock, bts_ctrl, _ = rig
    # POWERON before tuning must fail (Transceiver.cpp:459-462)
    status, _ = _cmd(daemon, bts_ctrl, "POWERON")
    assert status == 1
    status, args = _cmd(daemon, bts_ctrl, "RXTUNE", 890000)
    assert status == 0
    status, _ = _cmd(daemon, bts_ctrl, "TXTUNE", 935000)
    assert status == 0
    status, args = _cmd(daemon, bts_ctrl, "SETTSC", 2)
    assert status == 0 and args == ["2"]
    status, _ = _cmd(daemon, bts_ctrl, "SETSLOT", 0, 1)  # combination I
    assert status == 0
    status, _ = _cmd(daemon, bts_ctrl, "POWERON")
    assert status == 0
    assert daemon.on
    # control activity triggered clock indications
    msg = bts_clock.recv(64, timeout_ms=2000)
    assert msg is not None
    kind, verb, args = proto.parse_message(msg)
    assert (kind, verb) == ("IND", "CLOCK")


def test_downlink_burst_loops_back_to_uplink(rig):
    daemon, _, bts_ctrl, bts_data = rig
    assert daemon.on
    tsc = int(daemon.state.tsc[0])
    rng = np.random.default_rng(3)
    bits = np.concatenate(
        [[0, 0, 0], rng.integers(0, 2, 57), [1], C.TRAINING_SEQUENCE[tsc],
         [1], rng.integers(0, 2, 57), [0, 0, 0]]).astype(np.uint8)
    # schedule bursts on slot 0 a few frames ahead of the tx deadline
    sent_fns = [daemon.tx_fn + k for k in range(1, 4)]
    for fn in sent_fns:
        bts_data.send(proto.pack_downlink(
            proto.DownlinkBurst(0, fn, 0, bits)))
    uplinks = []
    for _ in range(8):
        daemon.step()
        while True:
            msg = bts_data.recv(512, timeout_ms=200)
            if msg is None:
                break
            uplinks.append(proto.unpack_uplink(msg))
    got_fns = sorted(u.fn for u in uplinks if u.tn == 0)
    # loopback radio has zero delay: tx at fn appears in rx frame fn
    assert set(sent_fns) <= set(got_fns), (sent_fns, got_fns)
    u = next(u for u in uplinks if u.fn == sent_fns[0])
    ber = np.mean((u.soft > 0.5).astype(int) != bits)
    assert ber < 0.02, f"daemon loopback BER {ber}"


def test_poweroff(rig):
    daemon, _, bts_ctrl, _ = rig
    status, _ = _cmd(daemon, bts_ctrl, "POWEROFF")
    assert status == 0
    assert not daemon.on


def test_multi_arfcn_daemon():
    """Two carriers batched through one engine, each with its own
    control/data port triple (the reference runs one process per ARFCN;
    we batch them)."""
    from openbts_ttsou_tpu.trx.radio import LoopbackRadio

    base = 46700
    daemon = TrxDaemon([LoopbackRadio(), LoopbackRadio()],
                       TrxDaemonConfig(base_port=base, n_arfcn=2))
    ctrls = [UdpTransport(base + 100 + 3 * i + 1, "127.0.0.1",
                          base + 3 * i + 1) for i in range(2)]
    datas = [UdpTransport(base + 100 + 3 * i + 2, "127.0.0.1",
                          base + 3 * i + 2) for i in range(2)]
    try:
        for i, c in enumerate(ctrls):
            for verb, args in (("RXTUNE", (890000 + i,)),
                               ("TXTUNE", (935000 + i,)),
                               ("SETTSC", (i,)), ("SETSLOT", (0, 1)),
                               ("POWERON", ())):
                c.send(proto.pack_command(verb, *args))
                daemon.step()
                resp = c.recv(256, timeout_ms=2000)
                assert resp is not None
                kind, rverb, rargs = proto.parse_message(resp)
                assert (kind, rverb, rargs[0]) == ("RSP", verb, "0")
        assert daemon.carrier_on == [True, True]
        assert int(daemon.state.tsc[0]) == 0
        assert int(daemon.state.tsc[1]) == 1
        # send a burst on each carrier; each comes back on its own port
        rng = np.random.default_rng(8)
        for i, d in enumerate(datas):
            bits = np.concatenate(
                [[0, 0, 0], rng.integers(0, 2, 57), [1],
                 C.TRAINING_SEQUENCE[i], [1], rng.integers(0, 2, 57),
                 [0, 0, 0]]).astype(np.uint8)
            d.send(proto.pack_downlink(
                proto.DownlinkBurst(0, daemon.tx_fn + 2 + i, 0, bits)))
        got = [0, 0]
        for _ in range(8):
            daemon.step()
            for i, d in enumerate(datas):
                while (msg := d.recv(512, timeout_ms=100)) is not None:
                    got[i] += 1
        assert got[0] >= 1 and got[1] >= 1, got
    finally:
        for s in ctrls + datas:
            s.close()


def test_alignment_measurement():
    from openbts_ttsou_tpu.trx.radio import LoopbackRadio

    daemon = TrxDaemon(LoopbackRadio(delay_samples=37),
                       TrxDaemonConfig(base_port=45800))
    offset = daemon.measure_alignment()
    assert offset == 37


def test_control_robustness():
    """Malformed control packets must not crash the daemon (the
    reference logs bogus commands and answers RSP ... NAK)."""
    from openbts_ttsou_tpu.trx.daemon import TrxDaemon, TrxDaemonConfig
    from openbts_ttsou_tpu.trx.radio import LoopbackRadio

    daemon = TrxDaemon(LoopbackRadio(), TrxDaemonConfig(base_port=49950))
    for pkt in (b"", b"CMD", b"CMD BOGUSVERB 1 2 3", b"\xff\x00garbage",
                b"CMD SETSLOT notanint x", b"IND CLOCK 5",
                b"CMD RXTUNE"):
        try:
            daemon.handle_control(pkt)
        except Exception as e:
            raise AssertionError(f"daemon crashed on {pkt!r}: {e}")
    # well-formed command still works afterwards
    from openbts_ttsou_tpu.trx import protocol as proto

    rsp = daemon.handle_control(proto.pack_command("POWEROFF"))
    assert rsp is not None and b"POWEROFF" in rsp


def test_adaptive_clock_lead_on_underrun():
    """Late downlink bursts grow the advertised clock lead
    (driveTransmitFIFO adaptation, Transceiver.cpp:688-716)."""
    from openbts_ttsou_tpu.trx import protocol as proto
    from openbts_ttsou_tpu.trx.daemon import TrxDaemon, TrxDaemonConfig
    from openbts_ttsou_tpu.trx.radio import LoopbackRadio

    daemon = TrxDaemon(LoopbackRadio(), TrxDaemonConfig(base_port=49960))
    lead0 = daemon.clock_lead
    import numpy as np

    bits = np.zeros(148, np.uint8)
    # a burst for a frame already transmitted = underrun
    late_fn = (daemon.tx_fn - 2) % (2715648)
    daemon.handle_downlink(proto.pack_downlink(
        proto.DownlinkBurst(tn=0, fn=late_fn, gain=0, bits=bits)))
    assert daemon.underruns == 1
    assert daemon.clock_lead == lead0 + 1
    # comfortably-early bursts shrink it back toward the floor
    early_fn = (daemon.tx_fn + daemon.clock_lead + 20) % (2715648)
    daemon.handle_downlink(proto.pack_downlink(
        proto.DownlinkBurst(tn=0, fn=early_fn, gain=0, bits=bits)))
    assert daemon.clock_lead == lead0


def test_radio_alignment_measurement():
    """update_alignment measures the Tx->Rx timebase offset with an
    impulse ping (USRPDevice::updateAlignment / USRPping,
    USRPDevice.cpp:518): the loopback radio's configured delay is
    recovered exactly."""
    from openbts_ttsou_tpu.trx.radio import (
        DECIM_52M,
        DEVICE_RATE_64M,
        MASTER_CLOCK_52M,
        LoopbackRadio,
    )

    r = LoopbackRadio(delay_samples=17, full_scale=1.0)
    assert r.update_alignment() == 17
    assert r.timestamp_offset == 17
    assert LoopbackRadio().update_alignment() == 0
    # clocking constants (USRPDevice.cpp:54,151-152)
    assert abs(MASTER_CLOCK_52M / DECIM_52M - 1625e3 / 6.0) < 1e-6
    assert DEVICE_RATE_64M == 400e3
