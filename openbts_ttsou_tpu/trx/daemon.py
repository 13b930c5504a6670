"""The transceiver daemon: the `runTransceiver` equivalent.

Binds the three UDP planes (clock = base, control = base+1, data =
base+2; peer at base+100+i — Transceiver52M/Transceiver.cpp:42-44,
runTransceiver.cpp:68-74), drives the radio one GSM frame at a time
through the jitted engine, and speaks the reference's wire protocol so
an unmodified BTS stack (TRXManager) can control it.

Where the reference runs one transceiver **process per ARFCN**, this
daemon batches N carriers through one jitted engine step — the
improvement the batched `[chan, slot]` layout buys — while exposing the
same per-ARFCN control/data port triples (base + 3·i + {1,2}) that
`TRXManager` expects.

The reference uses three service threads; here a single `step()`
processes control messages, ingests downlink bursts, advances one frame
of radio I/O through `rx_step`/`tx_step`, and emits the clock beacon —
callable from a `run()` loop or directly from tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from openbts_ttsou_tpu.runtime import BurstQueue, UdpTransport
from openbts_ttsou_tpu.trx import engine as eng
from openbts_ttsou_tpu.trx import protocol as proto
from openbts_ttsou_tpu.trx.radio import Radio
from openbts_ttsou_tpu.utils.gsm_time import (
    FRAME_SYMBOLS,
    HYPERFRAME,
    SLOT_SAMPLE_PATTERN,
)

SLOT_OFFSETS = np.concatenate([[0], np.cumsum(SLOT_SAMPLE_PATTERN)])[:-1]


@dataclasses.dataclass
class TrxDaemonConfig:
    base_port: int = 5700
    peer_host: str = "127.0.0.1"
    peer_port_offset: int = 100  # BTS listens at base+100+i
    sps: int = 1
    n_arfcn: int = 1
    start_fn: int = 0
    tx_latency_frames: int = 2  # initial latency (runTransceiver.cpp:71)
    #: static TSC correlation window in samples (the 52M 2·maxTOA+1-lag
    #: restriction, Transceiver52M/sigProcLib.cpp:983-1000); None = the
    #: full ±10-symbol segment. SETMAXDELAY values at or below this
    #: still apply per carrier dynamically.
    max_toa: int | None = None
    #: static tuple of timeslots that can carry RACH (combination
    #: IV/V/VI slots in the channel plan — TN 0 for the standard
    #: beacon). Restricts the expensive full-burst RACH correlator to
    #: those slots; None = all 8 (correct for any SETSLOT). Static for
    #: the same recompile reason as max_toa.
    rach_slots: tuple | None = None


class TrxDaemon:
    """N-ARFCN transceiver daemon over a pluggable radio (one radio per
    carrier, or one vectorized `BankRadio` for all of them)."""

    def __init__(self, radio, cfg: TrxDaemonConfig = TrxDaemonConfig()):
        self.cfg = cfg
        if hasattr(radio, "read_bank"):
            self.bank = radio
            self.radios: List[Radio] = [radio] * cfg.n_arfcn
        else:
            self.bank = None
            self.radios = radio if isinstance(radio, list) else [radio]
            assert len(self.radios) == cfg.n_arfcn
        base, peer = cfg.base_port, cfg.base_port + cfg.peer_port_offset
        self.clock_sock = UdpTransport(base, cfg.peer_host, peer)
        self.ctrl_socks = [
            UdpTransport(base + 3 * i + 1, cfg.peer_host, peer + 3 * i + 1)
            for i in range(cfg.n_arfcn)]
        self.data_socks = [
            UdpTransport(base + 3 * i + 2, cfg.peer_host, peer + 3 * i + 2)
            for i in range(cfg.n_arfcn)]
        self.engine_cfg = eng.TrxConfig(n_chan=cfg.n_arfcn, sps=cfg.sps,
                                        max_toa=cfg.max_toa,
                                        rach_slots=cfg.rach_slots)
        self.state = eng.init_state(self.engine_cfg)
        self.carrier_on = [False] * cfg.n_arfcn
        self.tx_freq = [0.0] * cfg.n_arfcn
        self.rx_freq = [0.0] * cfg.n_arfcn
        self.power = [-10] * cfg.n_arfcn
        self.fn = cfg.start_fn  # receive-side frame clock
        self.tx_fn = cfg.start_fn + cfg.tx_latency_frames
        self.underruns = 0
        self.stale_dumped = 0  # bursts dropped past their deadline
        self.clock_lead = proto.CLOCK_LEAD_FRAMES
        self.last_clock_fn: Optional[int] = None
        # native priority queue of pending downlink bursts keyed by
        # (fn, carrier, tn) — the reference's VectorQueue
        # (radioInterface.cpp:30-73) lives in C++ here too
        self.pending_tx = BurstQueue()

    @property
    def on(self) -> bool:
        return any(self.carrier_on)

    # ------------------------------------------------------------------
    # control plane (driveControl, Transceiver.cpp:423-569)
    # ------------------------------------------------------------------
    def handle_control(self, data: bytes, carrier: int = 0) -> bytes | None:
        try:
            kind, verb, args = proto.parse_message(data)
        except ValueError:
            return None
        if kind != "CMD":
            return None
        self._send_clock()
        try:
            return self._dispatch_command(verb, args, carrier)
        except (ValueError, IndexError, TypeError):
            # malformed arguments: NAK like the reference's bogus-
            # command path (driveControl, Transceiver.cpp:423-569)
            return proto.pack_response(verb, 1)

    def _dispatch_command(self, verb: str, args, carrier: int
                          ) -> bytes | None:
        ok = 0
        extra: tuple = ()
        if verb == "POWEROFF":
            self.carrier_on[carrier] = False
        elif verb == "POWERON":
            if not self.tx_freq[carrier] or not self.rx_freq[carrier]:
                ok = 1
            else:
                if not self.carrier_on[carrier]:
                    self.radios[carrier].start()
                    self.carrier_on[carrier] = True
        elif verb == "RXTUNE":
            self.rx_freq[carrier] = float(args[0]) * 1e3
            ok = 0 if self.radios[carrier].set_rx_freq(
                self.rx_freq[carrier]) else 1
            extra = (args[0],)
        elif verb == "TXTUNE":
            self.tx_freq[carrier] = float(args[0]) * 1e3
            ok = 0 if self.radios[carrier].set_tx_freq(
                self.tx_freq[carrier]) else 1
            extra = (args[0],)
        elif verb == "SETTSC":
            tsc = int(args[0])
            if 0 <= tsc <= 7:
                self.state = self.state._replace(
                    tsc=self.state.tsc.at[carrier].set(tsc))
            else:
                ok = 1
            extra = (tsc,)
        elif verb == "SETSLOT":
            tn, combo = int(args[0]), int(args[1])
            if 0 <= tn <= 7:
                self.state = self.state._replace(
                    chan_type=self.state.chan_type.at[carrier, tn]
                    .set(combo))
            else:
                ok = 1
            extra = (tn, combo)
        elif verb == "SETPOWER":
            self.power[carrier] = int(args[0])
            extra = (self.power[carrier],)
        elif verb == "ADJPOWER":
            self.power[carrier] += int(args[0])
            extra = (self.power[carrier],)
        elif verb == "SETMAXDELAY":
            # Applies dynamically: the engine bounds accepted TOAs to
            # ±max(value, 3)·sps per carrier (the 52M window's
            # acceptance semantics, Transceiver52M/sigProcLib.cpp:
            # 982-990) with no recompile. The static correlation-window
            # shrink (the compute win) is a construction-time choice —
            # TrxDaemonConfig.max_toa — because changing it would
            # recompile the engine mid-bring-up and starve the control
            # plane (the reference reconfigures for free; XLA doesn't).
            self.state = self.state._replace(
                max_expected_delay=self.state.max_expected_delay
                .at[carrier].set(int(args[0])))
            extra = (args[0],)
        else:
            return None  # bogus command: reference just logs
        return proto.pack_response(verb, ok, *extra)

    # ------------------------------------------------------------------
    # data plane
    # ------------------------------------------------------------------
    def handle_downlink(self, data: bytes, carrier: int = 0) -> None:
        try:
            burst = proto.unpack_downlink(data)
        except ValueError:
            return
        # adaptive transmit latency (driveTransmitFIFO,
        # Transceiver.cpp:688-716): a burst arriving for a frame we
        # already transmitted is an underrun — grow the clock lead so
        # the BTS schedules further ahead; shrink slowly when clean.
        if (self.tx_fn - burst.fn) % HYPERFRAME < HYPERFRAME // 2 and \
                burst.fn != self.tx_fn:
            self.underruns += 1
            self.clock_lead = min(self.clock_lead + 1, 40)
            self._send_clock(force=True)
        elif self.underruns and (burst.fn - self.tx_fn) % HYPERFRAME > \
                self.clock_lead + 10:
            self.clock_lead = max(self.clock_lead - 1,
                                  proto.CLOCK_LEAD_FRAMES)
        self.pending_tx.push(
            burst.fn % HYPERFRAME, carrier, burst.tn,
            np.float32(burst.gain).tobytes()
            + np.asarray(burst.bits, np.uint8).tobytes())

    def _frame_ts(self, fn: int) -> int:
        return (fn - self.cfg.start_fn) * FRAME_SYMBOLS * self.cfg.sps

    def step_frame(self) -> List[Tuple[int, proto.UplinkBurst]]:
        """Advance one GSM frame for all carriers: transmit tx_fn,
        receive fn. Returns (carrier, burst) uplink tuples."""
        n, sps = self.cfg.n_arfcn, self.cfg.sps
        # ---- downlink (driveTransmitFIFO + pushRadioVector) ----------
        # drop bursts whose deadline already passed; the engine's filler
        # table covers the slot instead (stale-burst dump,
        # Transceiver.cpp:144-154)
        self.stale_dumped += self.pending_tx.dump_stale(self.tx_fn)
        bits = np.zeros((n, 8, 148), np.uint8)
        valid = np.zeros((n, 8), bool)
        atten = np.zeros((n, 8), np.float32)
        for c in range(n):
            for tn in range(8):
                b = self.pending_tx.pop_exact(self.tx_fn, c, tn)
                if b is not None:
                    bits[c, tn] = np.frombuffer(b[4:], np.uint8)[:148] & 1
                    valid[c, tn] = True
                    atten[c, tn] = float(np.frombuffer(b[:4],
                                                       np.float32)[0])
        slots = jax.device_get(eng.tx_step(
            self.engine_cfg, self.state, jnp.asarray(bits),
            jnp.asarray(valid), jnp.asarray(atten),
            jnp.asarray(self.tx_fn, jnp.int32)))
        for c in range(n):
            if not self.carrier_on[c]:
                continue
            frame_samples = np.zeros(FRAME_SYMBOLS * sps, np.complex64)
            for tn in range(8):
                off = SLOT_OFFSETS[tn] * sps
                ln = SLOT_SAMPLE_PATTERN[tn] * sps
                frame_samples[off: off + ln] += slots[c, tn, :ln]
            self.radios[c].write_samples(frame_samples,
                                         self._frame_ts(self.tx_fn))
        self.tx_fn = (self.tx_fn + 1) % HYPERFRAME

        # ---- uplink (driveReceiveFIFO + pullRadioVector) -------------
        ts = self._frame_ts(self.fn)
        frame = np.zeros((n, 8, eng.SLOT_SAMPLES * sps), np.complex64)
        for c in range(n):
            if not self.carrier_on[c]:
                continue
            raw = self.radios[c].read_samples(FRAME_SYMBOLS * sps + sps, ts)
            for tn in range(8):
                off = SLOT_OFFSETS[tn] * sps
                frame[c, tn] = raw[off: off + eng.SLOT_SAMPLES * sps]
        self.state = self.state._replace(fn=jnp.asarray(self.fn, jnp.int32))
        self.state, res = eng.rx_step(self.engine_cfg, self.state,
                                      jax.device_put(frame))
        out: List[Tuple[int, proto.UplinkBurst]] = []
        det = np.asarray(res.detected)
        soft = np.asarray(res.soft_bits)
        rssi = np.asarray(res.rssi)
        timing = np.asarray(res.timing)
        for c in range(n):
            if not self.carrier_on[c]:
                continue
            for tn in range(8):
                if det[c, tn]:
                    out.append((c, proto.UplinkBurst(
                        tn, self.fn, int(rssi[c, tn]),
                        int(timing[c, tn]), soft[c, tn])))
        self.fn = (self.fn + 1) % HYPERFRAME
        return out

    def measure_alignment(self, carrier: int = 0,
                          probe_len: int = 64) -> int:
        """Measure the radio's Tx→Rx timestamp offset with an impulse
        probe (USRPDevice::updateAlignment, USRPDevice.cpp:518: the
        reference pings the control channel and trims `timestampOffset`;
        with a software radio the offset is the loopback delay)."""
        ts = self._frame_ts(self.tx_fn) + 10_000  # quiet region
        probe = np.zeros(probe_len, np.complex64)
        probe[0] = 20000.0
        self.radios[carrier].write_samples(probe, ts)
        window = self.radios[carrier].read_samples(4 * probe_len,
                                                   ts - probe_len)
        peak = int(np.argmax(np.abs(window)))
        return peak - probe_len  # samples of Tx→Rx delay

    def _send_clock(self, force: bool = False) -> None:
        self.clock_sock.send(proto.pack_clock(
            (self.tx_fn + self.clock_lead) % HYPERFRAME))
        self.last_clock_fn = self.tx_fn

    def step(self) -> None:
        """One service iteration: control, data ingest, one frame."""
        for c in range(self.cfg.n_arfcn):
            # drain the WHOLE control queue each step (the reference's
            # ControlServiceLoop blocks on the socket and services
            # commands as fast as they arrive, Transceiver.cpp:754-760;
            # one-per-step made a bring-up burst take several frames)
            while True:
                msg = self.ctrl_socks[c].recv(256, timeout_ms=0)
                if not msg:
                    break
                resp = self.handle_control(msg, c)
                if resp:
                    self.ctrl_socks[c].send(resp)
            while True:
                d = self.data_socks[c].recv(512, timeout_ms=0)
                if not d:
                    break
                self.handle_downlink(d, c)
        if not self.on:
            return
        for carrier, burst in self.step_frame():
            self.data_socks[carrier].send(proto.pack_uplink(burst))
        if (self.last_clock_fn is None or
                (self.tx_fn - self.last_clock_fn) % HYPERFRAME
                >= proto.CLOCK_PERIOD_FRAMES):
            self._send_clock()

    def run(self, max_frames: int | None = None) -> None:
        n = 0
        while max_frames is None or n < max_frames:
            self.step()
            n += 1


class BlockTrxDaemon(TrxDaemon):
    """Block-pipelined daemon: one fused device step per 13-frame window
    (downlink modulate+96/65 resample AND uplink 65/96 resample+detect+
    demod, `models.transceiver.duplex_block_wire`) behind the same
    3-plane wire protocol.

    Where the reference overlaps I/O and DSP with three service threads
    (Transceiver52M/Transceiver.cpp:744-778), this daemon overlaps them
    with the device: each `step()` dispatches block N asynchronously,
    then — while the device computes it — retires block N−1 (fetch, radio
    write, uplink datagram batch) and ingests block N+1's downlink
    bursts. Burst marshalling is native and dense: `bpq_pop_block` /
    `bpq_push_block` / `udt_send_batch` move whole windows per call
    instead of per-(carrier, slot) Python loops.
    """

    def __init__(self, radio, cfg: TrxDaemonConfig = TrxDaemonConfig(),
                 block_frames: int = 13, pipeline_depth: int = 1,
                 compact: bool = True):
        from openbts_ttsou_tpu.models.transceiver import UplinkSpec

        super().__init__(radio, cfg)
        # The uplink is ALWAYS the reference's exact pullRadioVector
        # semantics (models/transceiver.process_block_exact).
        assert block_frames % 13 == 0, \
            "65/96 streaming needs 13-frame multiples"
        self.spec = UplinkSpec(frames=block_frames)
        n = cfg.n_arfcn
        from openbts_ttsou_tpu.models.transceiver import TX_TAIL_SYM

        self._tx_tail = jax.device_put(
            np.zeros((n, TX_TAIL_SYM), np.complex64))
        self._rx_block = 0
        self._tx_block = 0
        self._frames_since_late = 0
        #: blocks kept in flight on the device before retiring. Depth 1
        #: overlaps host I/O with one device step (the reference's
        #: thread overlap); deeper pipelines hide a slower transfer at
        #: the cost of `depth` blocks of latency.
        self.pipeline_depth = pipeline_depth
        self._pending: list = []  # (out_buffer, rx_fn0, tx_block)
        #: device-side result compaction (duplex_block_compact): D2H
        #: carries only detected datagrams + live-carrier DAC rows
        self.compact = compact
        self._prev_any_valid = np.ones(n, bool)  # bootstrap: all live
        self._filler_tx: np.ndarray | None = None  # cached filler block
        self.d2h_bytes = 0  # result bytes fetched (both paths)
        self.d2h_bytes_dense = 0  # what the dense layout would have cost
        # Radio samples cross the host/device boundary as int16 I/Q —
        # the USRP sample format — with the float conversion fused into
        # the device program (the reference burns host CPU on exactly
        # this in USRPifyVector, radioInterface.cpp:101-146). Radios
        # that speak int16 natively (`int16_io`) skip all conversions.
        self._radio_i16 = bool(getattr(self.bank, "int16_io", False))

    # -- plane servicing (bulk) -----------------------------------------
    def _service_control(self) -> None:
        for c, sock in enumerate(self.ctrl_socks):
            while True:
                msg = sock.recv(256, timeout_ms=0)
                if not msg:
                    break
                resp = self.handle_control(msg, c)
                if resp:
                    sock.send(resp)

    def _ingest_downlink(self) -> None:
        late_total = 0
        for c, sock in enumerate(self.data_socks):
            pkts = sock.drain_fixed(proto.DOWNLINK_LEN, 16384)
            if len(pkts):
                _, late = self.pending_tx.push_block(c, pkts, self.tx_fn)
                late_total += late
        # adaptive clock lead (driveTransmitFIFO, Transceiver.cpp:
        # 688-716): late bursts grow the lead; a quiet 216 frames
        # shrinks it back toward the initial value
        if late_total:
            self.underruns += late_total
            self.clock_lead = min(self.clock_lead + 1, 40)
            self._frames_since_late = 0
            self._send_clock(force=True)
        else:
            self._frames_since_late += self.spec.frames
            if self._frames_since_late >= proto.CLOCK_PERIOD_FRAMES:
                self.clock_lead = max(self.clock_lead - 1,
                                      proto.CLOCK_LEAD_FRAMES)
                self._frames_since_late = 0

    # -- radio I/O at the 400 kS/s device rate ---------------------------
    def _read_ul(self, block: int) -> np.ndarray:
        """int16 [C, halo+block_in+halo, 2] uplink window."""
        from openbts_ttsou_tpu.models.transceiver import RX_HALO_DEV

        n = self.spec.block_in + 2 * RX_HALO_DEV
        ts = block * self.spec.block_in - RX_HALO_DEV
        if self.bank is not None:
            raw = self.bank.read_bank(n, ts)
        else:
            raw = np.stack([r.read_samples(n, ts) for r in self.radios])
        if not self._radio_i16:  # complex radio → ADC format
            raw = np.clip(np.stack([raw.real, raw.imag], -1).round(),
                          -32767, 32767).astype(np.int16)
        return raw

    def _write_tx(self, tx_i16: np.ndarray, block: int) -> None:
        """tx_i16: int16 [C, block_in, 2] — the DAC sample format."""
        from openbts_ttsou_tpu.models.transceiver import TX_DELAY_DEV

        ts = block * self.spec.block_in - TX_DELAY_DEV
        if self.bank is not None:
            self.bank.write_bank(tx_i16, ts)
            return
        txc = (tx_i16[..., 0].astype(np.float32)
               + 1j * tx_i16[..., 1].astype(np.float32))
        for c, r in enumerate(self.radios):
            if self.carrier_on[c]:
                r.write_samples(txc[c], ts)

    # -- the pipeline -----------------------------------------------------
    def _retire(self, pending) -> None:
        """Fetch block N−1's packed result — ONE device→host transfer —
        and push it out (runs while block N computes on device)."""
        from openbts_ttsou_tpu.models.transceiver import unpack_block_result

        out, rx_fn0, tx_block = pending
        buf = np.asarray(out)  # uint8: the only sync point per block
        self.d2h_bytes += buf.nbytes
        self.d2h_bytes_dense += buf.nbytes
        tx, pkts, det = unpack_block_result(buf, self.cfg.n_arfcn,
                                            self.spec)
        self._write_tx(tx, tx_block)
        for c in range(self.cfg.n_arfcn):
            if not self.carrier_on[c]:
                continue
            mask = det[:, c].reshape(-1)
            if mask.any():
                rows = pkts[:, c].reshape(-1, pkts.shape[-1])[mask]
                self.data_socks[c].send_batch(rows)

    @staticmethod
    def _bucket(n: int, step: int) -> int:
        """Round a row count up to a bucket so slice-fetch shapes stay
        few (each distinct prefix length compiles one tiny gather)."""
        return min(-(-max(n, 1) // step) * step, 1 << 30)

    def _retire_compact(self, pending) -> None:
        """Fetch block N−1's COMPACTED result: the 8-byte header, then
        only the live DAC rows and detected datagram rows
        (duplex_block_compact). Filler carriers replay the cached
        filler block host-side."""
        from openbts_ttsou_tpu.models.transceiver import UL_PKT, UL_PKT_C

        (hdr, tx_buf, pkt_buf), live, cacheable, tx_block = pending
        h = np.asarray(hdr)  # sync point
        n_det = int.from_bytes(h[:4].tobytes(), "big")
        n_live = int.from_bytes(h[4:8].tobytes(), "big")
        n, t4 = self.cfg.n_arfcn, self.spec.block_in * 4
        f = self.spec.frames

        live_idx = np.flatnonzero(live)
        assert len(live_idx) == n_live
        # issue BOTH row fetches before reading either: the two slice
        # copies then fly concurrently — the compact path costs 2 round
        # trips (header + rows) instead of 3
        rows_dev = tx_buf[: self._bucket(n_live, 8)] if n_live else None
        prows_dev = pkt_buf[: self._bucket(n_det, 256)] if n_det \
            else None
        for d in (rows_dev, prows_dev):
            if d is not None and hasattr(d, "copy_to_host_async"):
                d.copy_to_host_async()
        tx = np.empty((n, self.spec.block_in, 2), np.int16)
        if n_live:
            rows = np.asarray(rows_dev)
            self.d2h_bytes += rows.nbytes
            tx[live_idx] = rows[:n_live].view("<i2").reshape(
                n_live, self.spec.block_in, 2)
        if n_live < n:
            if self._filler_tx is None:
                # bootstrap miss: the mask said live for every carrier
                # until a (filler, filler-tail) block has been seen
                raise RuntimeError("filler cache empty but carrier "
                                   "suppressed")
            tx[live == 0] = self._filler_tx
        elif self._filler_tx is None:
            # capture the cache from any carrier whose current AND
            # previous windows were filler (its output IS the periodic
            # filler block; pattern identical across carriers)
            cand = np.flatnonzero(cacheable)
            if len(cand):
                self._filler_tx = tx[cand[0]].copy()
        self._write_tx(tx, tx_block)

        if n_det:
            prows = np.asarray(prows_dev)
            self.d2h_bytes += prows.nbytes
            prows = prows[:n_det]
            chans = (prows[:, UL_PKT].astype(np.int32) << 8) | \
                prows[:, UL_PKT + 1]
            order = np.argsort(chans, kind="stable")
            prows, chans = prows[order], chans[order]
            starts = np.searchsorted(chans, np.arange(n))
            ends = np.searchsorted(chans, np.arange(n), side="right")
            for c in range(n):
                if ends[c] > starts[c] and self.carrier_on[c]:
                    self.data_socks[c].send_batch(
                        np.ascontiguousarray(
                            prows[starts[c]: ends[c], :UL_PKT]))
        self.d2h_bytes += h.nbytes
        self.d2h_bytes_dense += (n * t4 + f * n * 8 * (UL_PKT + 1))

    def step(self) -> None:
        """One block service iteration: control, bulk data ingest,
        dispatch block N, retire block N−1, clock beacon."""
        import jax.numpy as jnp

        from openbts_ttsou_tpu.models.transceiver import (
            duplex_block_compact,
            duplex_block_packed,
            pack_dl_buffer,
            pack_dl_buffer_live,
        )

        f = self.spec.frames
        self._service_control()
        self._ingest_downlink()
        if not self.on:
            return
        # downlink window marshalling (stale-burst dump + dense pop,
        # pushRadioVector semantics, Transceiver.cpp:141-181)
        self.stale_dumped += self.pending_tx.dump_stale(self.tx_fn)
        bits, valid, gain, _ = self.pending_tx.pop_block(
            self.tx_fn, f, self.cfg.n_arfcn)
        ul = self._read_ul(self._rx_block)
        if self.compact:
            any_valid = np.asarray(valid).any(axis=(0, 2))  # [C]
            self._cacheable = ~any_valid & ~self._prev_any_valid
            live = any_valid | self._prev_any_valid | \
                (self._filler_tx is None)
            self._prev_any_valid = any_valid
            io_buf = pack_dl_buffer_live(bits, valid, gain, self.fn,
                                         self.tx_fn, ul, live)
            st, tail, hdr, tx_buf, pkt_buf = duplex_block_compact(
                self.engine_cfg, self.spec, self.state,
                jnp.asarray(io_buf), self._tx_tail)
            pend = ((hdr, tx_buf, pkt_buf), np.asarray(live, bool),
                    self._cacheable.copy(), self._tx_block)
        else:
            io_buf = pack_dl_buffer(bits, valid, gain, self.fn,
                                    self.tx_fn, ul_i16=ul)
            # ONE host→device transfer, one fused program, one packed
            # result to fetch later: the device builds the uplink
            # datagrams itself (duplex_block_packed)
            st, tail, out = duplex_block_packed(
                self.engine_cfg, self.spec, self.state,
                jnp.asarray(io_buf), self._tx_tail)
            pend = (out, self.fn, self._tx_block)
        self.state, self._tx_tail = st, tail
        self._pending.append(pend)
        self.fn = (self.fn + f) % HYPERFRAME
        self.tx_fn = (self.tx_fn + f) % HYPERFRAME
        self._rx_block += 1
        self._tx_block += 1
        while len(self._pending) > self.pipeline_depth:
            p = self._pending.pop(0)
            (self._retire_compact if self.compact else self._retire)(p)
        if (self.last_clock_fn is None or
                (self.tx_fn - self.last_clock_fn) % HYPERFRAME
                >= proto.CLOCK_PERIOD_FRAMES):
            self._send_clock()

    def flush(self) -> None:
        """Retire every in-flight block (call after the last step)."""
        while self._pending:
            p = self._pending.pop(0)
            (self._retire_compact if self.compact else self._retire)(p)

    def run(self, max_frames: int | None = None) -> None:
        n = 0
        while max_frames is None or n < max_frames:
            self.step()
            n += self.spec.frames
        self.flush()


def main():  # pragma: no cover - manual entry point
    import argparse

    from openbts_ttsou_tpu.trx.radio import LoopbackRadio
    from openbts_ttsou_tpu.utils.compile_cache import enable_compile_cache

    ap = argparse.ArgumentParser(description="GSM transceiver daemon")
    ap.add_argument("--base-port", type=int, default=5700)
    ap.add_argument("--peer", default="127.0.0.1")
    ap.add_argument("--arfcns", type=int, default=1)
    ap.add_argument("--loopback-delay", type=int, default=0)
    args = ap.parse_args()
    enable_compile_cache()
    radios = [LoopbackRadio(delay_samples=args.loopback_delay)
              for _ in range(args.arfcns)]
    daemon = TrxDaemon(radios,
                       TrxDaemonConfig(base_port=args.base_port,
                                       peer_host=args.peer,
                                       n_arfcn=args.arfcns))
    daemon.run()


if __name__ == "__main__":  # pragma: no cover
    main()
