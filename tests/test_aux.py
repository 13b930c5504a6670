"""Auxiliary subsystems: SACCH L1 header, GSMTAP tap, config, logger."""

import socket

import numpy as np
import pytest

from openbts_ttsou_tpu.gsm import channels, tdma
from openbts_ttsou_tpu.gsm.transfer import L2Frame, RxBurst
from openbts_ttsou_tpu.utils import gsmtap
from openbts_ttsou_tpu.utils.config import ConfigurationTable
from openbts_ttsou_tpu.utils.logger import ALARM, gAlarms, get_logger

RNG = np.random.default_rng(3)


def test_sacch_l1_header_round_trip():
    dl, ul = tdma.SACCH_C8[0]
    tx = channels.SACCHL1(0, dl, dl)  # loopback on downlink mapping
    tx.open(0)
    tx.ordered_ms_power = 29
    tx.ordered_ms_timing = 7
    l2bits = RNG.integers(0, 2, 168).astype(np.uint8)
    tx.send_l2(L2Frame(np.concatenate([l2bits, np.zeros(16, np.uint8)])))
    bursts = []
    while tx.tx_queue:
        bursts.append(tx.tx_queue.popleft())
    assert len(bursts) == 4

    received = []

    class FakeMux:
        def write_low_side(self, frame):
            received.append(frame)

    tx.upstream = FakeMux()
    for b in bursts:
        tx.write_low_side(RxBurst(b.bits.astype(np.float32), fn=b.fn,
                                  tn=0))
    assert tx.good_frames == 1
    # the L1 header came back: power level encode(29)=5 → decode → 29
    assert tx.actual_ms_power == 29
    assert tx.actual_ms_timing == 7
    np.testing.assert_array_equal(received[0].bits[:168], l2bits)


def test_sacch_fill_preempted_by_real_data():
    """A pre-queued SI5/SI6 fill block that has not started
    transmitting is replaced by real L3 data (the reference decides
    fill-vs-data at dispatch time, SACCHL1Encoder, so data never waits
    a SACCH period behind filler)."""
    from openbts_ttsou_tpu.gsm.transfer import L3Frame, Primitive

    dl, ul = tdma.SACCH_C8[0]
    l1_dl, l1_ul = tdma.SDCCH_8[0]
    l1 = channels.XCCHL1(0, l1_dl, l1_ul)
    sacch = channels.SACCHL1(0, dl, ul)
    ch = channels.LogicalChannel(l1, sapis=(0, 3), sacch=sacch)
    l1.open(0)
    sacch.open(0)

    fill = L3Frame(RNG.integers(0, 2, 144).astype(np.uint8),
                   Primitive.UNIT_DATA)
    ch.send_sacch(fill, fill=True)
    fill_fns = [b.fn for b in sacch.tx_queue]
    assert len(fill_fns) == 4
    fill_bits = [b.bits.copy() for b in sacch.tx_queue]

    real = L3Frame(RNG.integers(0, 2, 144).astype(np.uint8),
                   Primitive.UNIT_DATA)
    ch.send_sacch(real)
    # the fill block was preempted: still exactly one 4-burst block,
    # occupying the same frame numbers, with different payload
    assert [b.fn for b in sacch.tx_queue] == fill_fns
    assert any(not np.array_equal(a.bits, b)
               for a, b in zip(sacch.tx_queue, fill_bits))

    # but once a fill burst has shipped, it is NOT preempted
    sacch2 = channels.SACCHL1(0, dl, ul)
    ch2 = channels.LogicalChannel(channels.XCCHL1(0, l1_dl, l1_ul),
                                  sapis=(0,), sacch=sacch2)
    ch2.l1.open(0)
    sacch2.open(0)
    ch2.send_sacch(fill, fill=True)
    sacch2.tx_queue.popleft()  # one burst already on the air
    ch2.send_sacch(real)
    assert len(sacch2.tx_queue) == 3 + 4  # fill tail + real block


def test_gsmtap_emission():
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(2.0)
    port = rx.getsockname()[1]
    tap = gsmtap.GSMTAPDumper("127.0.0.1", port)
    bits = RNG.integers(0, 2, 184).astype(np.uint8)
    tap.write_l2_frame(bits, arfcn=42, tn=3, fn=12345,
                       chan_type=gsmtap.CHANNEL_SDCCH, uplink=True)
    data, _ = rx.recvfrom(2048)
    assert data[0] == gsmtap.GSMTAP_VERSION
    assert data[2] == gsmtap.GSMTAP_TYPE_UM
    assert data[3] == 3  # timeslot
    fn = int.from_bytes(data[8:12], "big")
    assert fn == 12345
    assert len(data) == 16 + 23
    rx.close()


def test_configuration_table(tmp_path):
    p = tmp_path / "test.config"
    p.write_text("""# comment
$static GSM.ARFCN
$optional GSM.Shortname
GSM.ARFCN 207
GSM.MCC 310
SIP.Timer 2.5
GSM.Neighbors 1 2 3
""")
    cfg = ConfigurationTable(str(p))
    assert cfg.get_int("GSM.ARFCN") == 207
    assert cfg.get_str("GSM.MCC") == "310"
    assert cfg.get_num("SIP.Timer") == 2.5
    assert cfg.get_vector("GSM.Neighbors") == [1.0, 2.0, 3.0]
    assert cfg.defines("GSM.MCC") and not cfg.defines("GSM.Nope")
    assert cfg.is_static("GSM.ARFCN")
    assert not cfg.is_required("GSM.Shortname")
    # static keys refuse runtime set
    assert not cfg.set("GSM.ARFCN", 1)
    assert cfg.set("GSM.MCC", "001")
    assert cfg.get_str("GSM.MCC") == "001"
    with pytest.raises(KeyError):
        cfg.get_str("No.Such.Key")
    assert cfg.get_str("No.Such.Key", "fallback") == "fallback"
    out = tmp_path / "saved.config"
    cfg.save(str(out))
    cfg2 = ConfigurationTable(str(out))
    assert cfg2.get_int("GSM.ARFCN") == 207


def test_alarm_ring():
    log = get_logger("openbts_ttsou.test")
    before = len(gAlarms.recent())
    log.log(ALARM, "test alarm %d", 42)
    recent = gAlarms.recent()
    assert any("test alarm 42" in a for a in recent)
