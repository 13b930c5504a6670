"""Soak test: ≥1000-frame continuous duplex run through the daemon.

The reference transceiver runs indefinitely against USRP clock drift,
USB underruns and a BTS that schedules bursts with variable lead
(driveTransmitFIFO's adaptive latency, Transceiver.cpp:672-722; clock
beacon every 216 frames, :726-739). This drives the daemon through
the same regime over the wire protocol with a loopback radio:

* downlink bursts scheduled with jittered lead (1-5 frames),
* periodic injected underruns (bursts for already-transmitted frames),
* a recovery phase with generous lead so the latency analog walks back.

Asserts the adaptive clock-lead climbs on underruns and returns to the
reference lead, the IND CLOCK cadence never exceeds 216 frames, stale
bursts are dumped (bounded queue), and detection/demod stay healthy for
the whole run.
"""

import numpy as np
import pytest

from openbts_ttsou_tpu.runtime import UdpTransport
from openbts_ttsou_tpu.trx import protocol as proto
from openbts_ttsou_tpu.trx.daemon import TrxDaemon, TrxDaemonConfig
from openbts_ttsou_tpu.trx.radio import LoopbackRadio
from openbts_ttsou_tpu.utils import constants as C
from openbts_ttsou_tpu.utils.gsm_time import HYPERFRAME

BASE = 47900
N_FRAMES = 1100
UNDERRUN_EVERY = 149  # inject a stale burst at this frame cadence
RECOVERY_START = 900  # after this, schedule far ahead so the lead decays


def _normal_bits(tsc, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate(
        [[0, 0, 0], rng.integers(0, 2, 57), [1], C.TRAINING_SEQUENCE[tsc],
         [1], rng.integers(0, 2, 57), [0, 0, 0]]).astype(np.uint8)


def test_soak_1000_frames_duplex():
    daemon = TrxDaemon(LoopbackRadio(), TrxDaemonConfig(base_port=BASE))
    clock = UdpTransport(BASE + 100, "127.0.0.1", BASE)
    ctrl = UdpTransport(BASE + 101, "127.0.0.1", BASE + 1)
    data = UdpTransport(BASE + 102, "127.0.0.1", BASE + 2)
    try:
        for verb, args in (("RXTUNE", (890000,)), ("TXTUNE", (935000,)),
                           ("SETTSC", (1,)), ("SETSLOT", (0, 1)),
                           ("POWERON", ())):
            ctrl.send(proto.pack_command(verb, *args))
            daemon.step()
            assert ctrl.recv(256, timeout_ms=2000) is not None, verb
        while clock.recv(64, timeout_ms=10):  # drain bring-up beacons
            pass

        rng = np.random.default_rng(99)
        tsc = 1
        bits = _normal_bits(tsc, 4)
        scheduled = set()
        injected_underruns = 0
        clock_events = []  # frame index at each IND CLOCK
        lead_trace = []
        uplink_fns = set()
        last_uplink_k = -1

        for k in range(N_FRAMES):
            # downlink scheduling with jittered lead; generous lead in
            # the recovery phase so the adaptive latency walks back down
            if k < RECOVERY_START:
                lead = int(rng.integers(1, 6))
            else:
                lead = daemon.clock_lead + 11
            fn = (daemon.tx_fn + lead) % HYPERFRAME
            if fn not in scheduled:
                scheduled.add(fn)
                data.send(proto.pack_downlink(
                    proto.DownlinkBurst(0, fn, 0, bits)))
            if k % UNDERRUN_EVERY == UNDERRUN_EVERY - 1 \
                    and k < RECOVERY_START:
                # a burst for a frame already transmitted = underrun
                data.send(proto.pack_downlink(
                    proto.DownlinkBurst(0, daemon.tx_fn - 3, 0, bits)))
                injected_underruns += 1
            daemon.step()
            lead_trace.append(daemon.clock_lead)
            while True:
                msg = clock.recv(64, timeout_ms=0)
                if not msg:
                    break
                kind, verb, args = proto.parse_message(msg)
                assert (kind, verb) == ("IND", "CLOCK")
                clock_events.append(k)
            while True:
                msg = data.recv(512, timeout_ms=0)
                if not msg:
                    break
                ub = proto.unpack_uplink(msg)
                assert ub.tn == 0
                uplink_fns.add(ub.fn)
                last_uplink_k = k
                # loopback demod recovers the scheduled bits
                hard = (np.asarray(ub.soft) > 0.5).astype(np.uint8)
                ber = float(np.mean(hard[:148] != bits))
                assert ber < 0.05, f"BER {ber} at frame {k}"

        # --- adaptive latency (underrun climb + recovery) --------------
        assert daemon.underruns == injected_underruns
        assert max(lead_trace) > proto.CLOCK_LEAD_FRAMES
        assert daemon.clock_lead == proto.CLOCK_LEAD_FRAMES, \
            f"lead did not recover: {daemon.clock_lead}"
        # --- clock beacon cadence --------------------------------------
        assert clock_events, "no clock beacons during the soak"
        gaps = np.diff([0] + clock_events)
        assert gaps.max() <= proto.CLOCK_PERIOD_FRAMES, \
            f"beacon gap {gaps.max()} exceeds the 216-frame cadence"
        assert len(clock_events) >= N_FRAMES // proto.CLOCK_PERIOD_FRAMES
        # --- stale bursts are dumped, queue stays bounded ---------------
        assert daemon.stale_dumped >= injected_underruns
        assert len(daemon.pending_tx) < 64
        # --- duplex health: detections kept flowing all the way through -
        # (jittered leads collide on some frame numbers, so not every
        # frame carries a scheduled burst; well over half must)
        assert len(uplink_fns) > 0.55 * N_FRAMES
        assert last_uplink_k >= N_FRAMES - 50, \
            f"uplink went quiet at frame {last_uplink_k}"
    finally:
        for s in (clock, ctrl, data):
            s.close()
