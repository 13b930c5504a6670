"""USRP device driver over a simulated packet bus.

Exercises the assembled `USRPRadio` — tx packetization, ring
reassembly + 32→64-bit timestamp extension, control-channel alignment
ping, RFX900 register programming — against `SimBus`, a software USRP
speaking the real 512-byte packet format (the reference binds the same
pieces over libusrp in Transceiver52M/USRPDevice.cpp:232-296,318-505).
"""

import struct

import numpy as np

from openbts_ttsou_tpu.trx import protocol as proto
from openbts_ttsou_tpu.trx.usrp import (
    CTRL_CHAN,
    PAYLOAD_BYTES,
    PKT_BYTES,
    SimBus,
    USRPRadio,
    build_packets,
)
from openbts_ttsou_tpu.utils import constants as C


def _wait_for_socket(path, srv, timeout_s=60.0):
    """Wait until the bus-server child has bound its socket. The child
    imports the package (and JAX) first, which takes seconds on a
    loaded host."""
    import time

    deadline = time.monotonic() + timeout_s
    while not path.exists():
        assert srv.poll() is None, "bus server exited"
        assert time.monotonic() < deadline, "bus server never bound"
        time.sleep(0.05)


def test_build_packets_format():
    """writeSamples packetization (USRPDevice.cpp:467-505): header
    fields, 504-byte splits, per-packet timestamp advance."""
    n = 300  # samples → 1200 bytes → 3 packets (504+504+192)
    iq = np.arange(2 * n, dtype=np.int16).reshape(n, 2)
    pkts = build_packets(iq.tobytes(), ts=1000)
    assert len(pkts) == 3 * PKT_BYTES
    seen = []
    for i in range(3):
        word0, ts = struct.unpack_from("<II", pkts, i * PKT_BYTES)
        paylen = word0 & 0x1FF
        chan = (word0 >> 16) & 0x1F
        is_start = (word0 >> 28) & 1
        is_end = (word0 >> 27) & 1
        assert chan == 0
        assert is_start == (1 if i == 0 else 0)
        assert is_end == (1 if i == 2 else 0)
        seen.append((ts, paylen))
    assert seen[0] == (1000, 504)
    assert seen[1] == (1000 + 126, 504)
    assert seen[2] == (1000 + 252, 1200 - 1008)
    # payload round-trips
    body = b"".join(pkts[i * PKT_BYTES + 8: i * PKT_BYTES + 8 + pl]
                    for i, (_, pl) in enumerate(seen))
    assert body == iq.tobytes()


def test_alignment_and_loopback():
    """updateAlignment (USRPDevice.cpp:518): the ping measures the
    Tx→Rx offset; after alignment a probe written at T reads back
    at T."""
    bus = SimBus(hw_delay=137)
    radio = USRPRadio(bus)
    assert radio.start() and bus.started
    off = radio.update_alignment(ts=4000)
    assert radio.is_aligned
    assert off == 137
    probe = np.zeros(64, np.complex64)
    probe[0] = 20000.0
    t0 = 20000
    radio.write_samples(probe, t0)
    got = radio.read_samples(64, t0)
    peak = int(np.argmax(np.abs(got)))
    assert peak == 0 and abs(got[0]) > 10000


def test_timestamp_wrap_extension():
    """32→64-bit extension (readSamples, USRPDevice.cpp:358-363): a
    stream crossing the 2^32 sample boundary stays contiguous."""
    start = (1 << 32) - 500
    bus = SimBus(hw_delay=0, start_ts=start)
    radio = USRPRadio(bus)
    # device-domain write straddling the wrap
    probe = np.zeros(1000, np.complex64)
    probe[0] = 9000.0
    probe[999] = 7000.0
    radio.write_samples(probe, start)
    got = radio.read_samples(1000, start)
    assert abs(got[0]) > 5000
    assert abs(got[999]) > 3500  # past the 32-bit boundary
    assert radio.ring.last_pkt_ts >= 1 << 32


def test_underrun_flag_surfaces():
    bus = SimBus(hw_delay=0, underrun_at=0)
    radio = USRPRadio(bus)
    radio.read_samples(600, 0)
    assert radio.underruns >= 1


def test_rfx900_tuning_programs_bus():
    bus = SimBus()
    radio = USRPRadio(bus)
    assert radio.set_tx_freq(935.2e6)
    assert radio.set_rx_freq(890.2e6)
    sides = [s for s, _ in bus.programmed]
    assert sides == ["tx", "rx"]
    # residuals recorded for the digital mixer (USRPDevice.cpp:527,540)
    # — bounded by the synthesizer's step plus the deliberate
    # LO_OFFSET detune (USRPDevice.cpp:531-556)
    assert abs(radio.tx_residual_hz) < 8e6


def test_daemon_runs_unchanged_over_usrp_radio():
    """The per-frame daemon drives USRPRadio(SimBus) exactly as it
    drives LoopbackRadio: bring-up over the wire, downlink burst loops
    back through the bus and is detected on uplink."""
    from openbts_ttsou_tpu.runtime import UdpTransport
    from openbts_ttsou_tpu.trx.daemon import TrxDaemon, TrxDaemonConfig

    base = 47900
    bus = SimBus(hw_delay=53)
    radio = USRPRadio(bus)
    radio.update_alignment(ts=1000)
    assert radio.timestamp_offset == 53
    daemon = TrxDaemon(radio, TrxDaemonConfig(base_port=base))
    ctrl = UdpTransport(base + 101, "127.0.0.1", base + 1)
    data = UdpTransport(base + 102, "127.0.0.1", base + 2)

    def cmd(verb, *args):
        ctrl.send(proto.pack_command(verb, *args))
        daemon.step()
        rsp = ctrl.recv(256, timeout_ms=2000)
        assert rsp is not None
        return proto.parse_message(rsp)

    cmd("RXTUNE", 890000)
    cmd("TXTUNE", 935000)
    cmd("SETTSC", 0)
    cmd("SETSLOT", 0, 1)
    kind, verb, args = cmd("POWERON")
    assert args[0] == "0" and daemon.on

    rng = np.random.default_rng(5)
    bits = np.concatenate(
        [[0, 0, 0], rng.integers(0, 2, 57), [1], C.TRAINING_SEQUENCE[0],
         [1], rng.integers(0, 2, 57), [0, 0, 0]]).astype(np.uint8)
    for fn in range(daemon.tx_fn + 1, daemon.tx_fn + 4):
        data.send(proto.pack_downlink(proto.DownlinkBurst(0, fn, 0, bits)))
    uplinks = []
    for _ in range(8):
        daemon.step()
        while True:
            d = data.recv(256, timeout_ms=20)
            if not d:
                break
            uplinks.append(proto.unpack_uplink(d))
    assert uplinks, "no uplink detections through the USRP driver"
    b = uplinks[0]
    hard = (b.soft > 0.5).astype(np.uint8)
    assert np.array_equal(hard, bits & 1)
    for s in (ctrl, data):
        s.close()


def test_socket_bus_crosses_process(tmp_path):
    """The `Bus` seam across a REAL process boundary: a bus server
    subprocess hosts the SimBus; `SocketBus` speaks to it over an
    AF_UNIX socket — alignment ping, loopback and register programming
    all flow through the transport (the boundary where libusb would
    sit)."""
    import subprocess
    import sys

    from openbts_ttsou_tpu.trx.usrp import SocketBus

    sock = str(tmp_path / "usrp.sock")
    srv = subprocess.Popen(
        [sys.executable, "-m", "openbts_ttsou_tpu.trx.bus_server",
         "--socket", sock, "--carriers", "1", "--hw-delay", "137"])
    try:
        _wait_for_socket(tmp_path / "usrp.sock", srv)
        bus = SocketBus(sock)
        radio = USRPRadio(bus)
        assert radio.start()
        assert radio.set_tx_freq(935.2e6) and radio.set_rx_freq(890.2e6)
        off = radio.update_alignment(ts=4000)
        assert radio.is_aligned and off == 137
        probe = np.zeros(64, np.complex64)
        probe[0] = 20000.0
        radio.write_samples(probe, 20000)
        got = radio.read_samples(64, 20000)
        assert int(np.argmax(np.abs(got))) == 0 and abs(got[0]) > 10000
        bus.close()
    finally:
        srv.terminate()
        srv.wait(timeout=10)


def test_block_daemon_over_socket_bus(tmp_path):
    """Block-scale USRP drive across the process boundary: the
    block-pipelined daemon runs over `USRPBankRadio` → `SocketBus` →
    bus-server subprocess (the round-3 gaps: no bank adapter for
    USRPRadio, and a Bus never exercised across a transport). The
    server's SimBus streams a planted-burst stimulus; detections flow
    back through the full wire protocol while the daemon's DAC blocks
    arrive at the server as USRP packets."""
    import subprocess
    import sys

    from openbts_ttsou_tpu.ops import fir, gmsk
    from openbts_ttsou_tpu.runtime import UdpTransport
    from openbts_ttsou_tpu.trx.daemon import (
        BlockTrxDaemon,
        TrxDaemonConfig,
    )
    from openbts_ttsou_tpu.trx.usrp import SocketBus, USRPBankRadio

    import jax.numpy as jnp

    n = 2
    # stimulus: device-rate int16 with TSC-0 bursts in slots 1-3 of
    # every frame, one 13-frame period (exactly block_in samples so
    # the tiling stays frame-aligned)
    rng = np.random.default_rng(4)
    sym = np.zeros((1, 13 * 1250), np.complex64)
    offs = np.concatenate([[0], np.cumsum([157, 156, 156, 156] * 2)])[:8]
    bits = {}
    for tn in range(1, 4):
        b = np.concatenate(
            [[0, 0, 0], rng.integers(0, 2, 57), [1],
             C.TRAINING_SEQUENCE[0], [1], rng.integers(0, 2, 57),
             [0, 0, 0]]).astype(np.uint8)
        bits[tn] = b
        w = 5000.0 * np.asarray(gmsk.modulate_burst(b[None], 1))[0]
        for f in range(13):
            o = f * 1250 + offs[tn]
            sym[0, o: o + len(w)] += w
    lpf = fir.resampler_lpf(96, 65, 651)
    dev = np.asarray(fir.polyphase_resample(
        jnp.asarray(sym), 96, 65, lpf))[0, : 13 * 1250 * 96 // 65]
    stim = np.clip(np.stack([dev.real, dev.imag], -1).round(),
                   -32767, 32767).astype(np.int16)
    np.save(tmp_path / "stim.npy", stim)

    sock = str(tmp_path / "usrp.sock")
    srv = subprocess.Popen(
        [sys.executable, "-m", "openbts_ttsou_tpu.trx.bus_server",
         "--socket", sock, "--carriers", str(n), "--hw-delay", "0",
         "--stimulus", str(tmp_path / "stim.npy")])
    try:
        _wait_for_socket(tmp_path / "usrp.sock", srv)
        radios = [USRPRadio(SocketBus(sock, carrier=c))
                  for c in range(n)]
        bank = USRPBankRadio(radios)
        base = 48900
        daemon = BlockTrxDaemon(
            bank, TrxDaemonConfig(base_port=base, n_arfcn=n))
        peer = base + 100
        ctrl = [UdpTransport(peer + 3 * i + 1, "127.0.0.1",
                             base + 3 * i + 1) for i in range(n)]
        data = [UdpTransport(peer + 3 * i + 2, "127.0.0.1",
                             base + 3 * i + 2) for i in range(n)]
        for i in range(n):
            for verb, a in (("RXTUNE", (890000,)),
                            ("TXTUNE", (935000,)), ("SETTSC", (0,))):
                ctrl[i].send(proto.pack_command(verb, *a))
            for tn in range(1, 4):
                ctrl[i].send(proto.pack_command("SETSLOT", tn, 1))
        daemon.step()
        for i in range(n):
            ctrl[i].send(proto.pack_command("POWERON"))
        daemon.step()
        for _ in range(4):
            daemon.step()
        daemon.flush()

        got = {i: [] for i in range(n)}
        for i in range(n):
            while True:
                d = data[i].recv(256, timeout_ms=50)
                if not d:
                    break
                got[i].append(proto.unpack_uplink(d))
        for i in range(n):
            assert len(got[i]) >= 3 * 13, \
                f"carrier {i}: {len(got[i])} detections over socket bus"
            assert {b.tn for b in got[i]} == {1, 2, 3}
            for b in got[i][:6]:
                hard = (b.soft > 0.5).astype(np.uint8)
                assert np.array_equal(hard, bits[b.tn] & 1)
        # the daemon's DAC blocks crossed the bus as USRP packets
        # (several hundred 504-byte payload packets per block window)
        assert radios[0].ring.last_pkt_ts > 0
    finally:
        srv.terminate()
        srv.wait(timeout=10)
