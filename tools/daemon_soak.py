#!/usr/bin/env python
"""Real-time soak: the block-pipelined daemon at scale, over the wire.

Stands up `BlockTrxDaemon` with N carriers (default 128) against a
BTS-side stub in the same process speaking the reference's 3-plane UDP
protocol: the stub configures every carrier through the control plane
(RXTUNE/TXTUNE/SETTSC/SETSLOT/POWERON), follows the clock plane's
IND CLOCK beacons, keeps every (carrier, slot, frame) of the downlink
data plane fed ahead of the clock lead, and drains the uplink
detections. Uplink air is a replayed device-rate bank with a normal
burst planted in every active slot, so all detection paths stay hot
(the reference's equivalent of one fully loaded ARFCN per process,
Transceiver52M/runTransceiver.cpp:68-74 — here N of them through one
device step).

Prints one JSON line: wall-clock ms per GSM frame (budget: 4.615 ms),
detections, uplink/downlink datagram counts, stale/underrun stats.

Run on the GPU:
    python tools/daemon_soak.py --carriers 128 --blocks 50
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def log(msg):
    print(f"[soak] {msg}", file=sys.stderr, flush=True)


def build_uplink_bank(n_chan: int, frames: int, ul_slots: int = 7):
    """Device-rate int16 bank with TSC-0 bursts in slots 1..ul_slots of
    every frame (slot 0 runs combination IV = RACH, left quiet here);
    ul_slots < 7 models a partially loaded ARFCN, the realistic
    regime where device-side datagram compaction pays."""
    import jax
    import numpy as np

    from openbts_ttsou_tpu.ops import fir, gmsk
    from openbts_ttsou_tpu.utils import constants as C

    # one carrier's stream, resampled once, broadcast to n_chan (every
    # carrier carries the same air pattern — detection work per carrier
    # is identical either way)
    rng = np.random.default_rng(0)
    sym = np.zeros((1, frames * 1250), np.complex64)
    offs = np.concatenate([[0], np.cumsum([157, 156, 156, 156] * 2)])[:8]
    for tn in range(1, 1 + ul_slots):
        b = np.concatenate(
            [[0, 0, 0], rng.integers(0, 2, 57), [1], C.TRAINING_SEQUENCE[0],
             [1], rng.integers(0, 2, 57), [0, 0, 0]]).astype(np.uint8)
        w = 5000.0 * gmsk.modulate_burst_np(b[None], 1)[0]
        for f in range(frames):
            o = f * 1250 + offs[tn]
            sym[:, o: o + len(w)] += w[None]
    lpf = fir.resampler_lpf(96, 65, 651)
    dev = jax.device_get(jax.jit(
        lambda s: fir.polyphase_resample(s, 96, 65, lpf))(
            jax.device_put(sym)))[:, : frames * 1250 * 96 // 65]
    # NO pad: the replay tiles modulo its length, and the bank is
    # seamlessly periodic only when the period is exactly the
    # whole-frame device length (a pad shifts every frame after the
    # first wrap and detections die)
    return np.broadcast_to(dev, (n_chan, dev.shape[1])).copy()


def run(argv=None) -> dict:
    """One soak with the command-line arguments `argv`; returns the
    result and fails if the uplink starved."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--carriers", type=int, default=128)
    ap.add_argument("--blocks", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=6)
    ap.add_argument("--base-port", type=int, default=36700)
    ap.add_argument("--depth", type=int, default=2,
                    help="device pipeline depth (blocks in flight)")
    ap.add_argument("--block-frames", type=int, default=13,
                    help="frames per device block (13-multiples); "
                    "bigger blocks amortize per-transfer latency at "
                    "the cost of block latency (the reference's chunk-"
                    "size knob, radioInterface.h:40-41)")
    ap.add_argument("--exact", type=int, default=1,  # retained for
                    # sweep-script compat; the daemon is always exact
                    help="1 = reference per-frame rx semantics (the "
                    "daemon default), 0 = once-per-block refresh")
    ap.add_argument("--compact", type=int, default=1,
                    help="1 = device-side D2H compaction (packed "
                    "datagrams + live-carrier DAC rows), 0 = dense")
    ap.add_argument("--ul-slots", type=int, default=7,
                    help="slots per frame carrying uplink bursts (7 = "
                    "fully loaded; lower = sparse detection)")
    ap.add_argument("--dl-carriers", type=int, default=-1,
                    help="carriers receiving live downlink bursts "
                    "(-1 = all; fewer leaves the rest on the filler "
                    "table, engaging tx-row suppression)")
    ap.add_argument("--bus", choices=("replay", "socket"),
                    default="replay",
                    help="radio backing: 'replay' = in-process sample "
                    "bank; 'socket' = USRPBankRadio over SocketBus to "
                    "a bus-server SUBPROCESS — the configuration "
                    "closest to real hardware (every sample crosses "
                    "the process/transport seam where libusb sits, "
                    "USRPDevice.cpp:318-505)")
    args = ap.parse_args(argv)

    import jax

    from openbts_ttsou_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import numpy as np

    from openbts_ttsou_tpu.runtime import UdpTransport
    from openbts_ttsou_tpu.trx import protocol as proto
    from openbts_ttsou_tpu.trx.daemon import BlockTrxDaemon, TrxDaemonConfig
    from openbts_ttsou_tpu.trx.radio import ReplayBankRadio
    from openbts_ttsou_tpu.utils.gsm_time import HYPERFRAME

    n = args.carriers
    log(f"devices={jax.devices()} carriers={n} blocks={args.blocks} "
        f"bus={args.bus}")
    log("building uplink bank")
    bf = args.block_frames
    buses = None
    srv = None
    if args.bus == "socket":
        import subprocess
        import tempfile

        from openbts_ttsou_tpu.trx.usrp import (
            SocketBus,
            USRPBankRadio,
            USRPRadio,
        )

        cplx = build_uplink_bank(1, 4 * bf, args.ul_slots)[0]
        stim = np.clip(np.stack([cplx.real, cplx.imag], -1).round(),
                       -32767, 32767).astype(np.int16)
        tmpd = tempfile.mkdtemp(prefix="soakbus_")
        np.save(os.path.join(tmpd, "stim.npy"), stim)
        sock = os.path.join(tmpd, "usrp.sock")
        srv = subprocess.Popen(
            [sys.executable, "-m", "openbts_ttsou_tpu.trx.bus_server",
             "--socket", sock, "--carriers", str(n), "--hw-delay", "0",
             "--stimulus", os.path.join(tmpd, "stim.npy")])
        for _ in range(200):
            if os.path.exists(sock):
                break
            time.sleep(0.05)
        buses = [SocketBus(sock, carrier=c) for c in range(n)]
        bank = USRPBankRadio([USRPRadio(b) for b in buses])
    else:
        bank = ReplayBankRadio(build_uplink_bank(n, 4 * bf,
                                                 args.ul_slots))
    daemon = BlockTrxDaemon(
        bank, TrxDaemonConfig(base_port=args.base_port, n_arfcn=n),
        block_frames=args.block_frames, pipeline_depth=args.depth,
        compact=bool(args.compact))
    n_dl = n if args.dl_carriers < 0 else min(args.dl_carriers, n)

    peer = args.base_port + 100
    clock = UdpTransport(peer, "127.0.0.1", args.base_port)
    ctrl = [UdpTransport(peer + 3 * i + 1, "127.0.0.1",
                         args.base_port + 3 * i + 1) for i in range(n)]
    data = [UdpTransport(peer + 3 * i + 2, "127.0.0.1",
                         args.base_port + 3 * i + 2) for i in range(n)]

    # ---- bring-up over the control plane (OpenBTS.cpp:200-214) -------
    log("bring-up: control plane")
    for i in range(n):
        for verb, a in (("RXTUNE", (890000,)), ("TXTUNE", (935000,)),
                        ("SETTSC", (0,)), ("SETSLOT", (0, 4))):
            ctrl[i].send(proto.pack_command(verb, *a))
        for tn in range(1, 8):
            ctrl[i].send(proto.pack_command("SETSLOT", tn, 1))
    daemon.step()  # services every queued command
    for i in range(n):
        ctrl[i].send(proto.pack_command("POWERON"))
    daemon.step()
    rsp = ctrl[n - 1].recv(128, timeout_ms=500)
    assert daemon.on and rsp is not None, "bring-up failed"

    # ---- soak loop -----------------------------------------------------
    rng = np.random.default_rng(7)
    dl_bits = rng.integers(0, 2, (bf, 8, 148)).astype(np.uint8)
    dl_valid = np.ones((bf, 8), bool)
    beacons, ul_pkts, dl_pkts = 0, 0, 0
    feed_fn = None
    t_timed = 0.0
    det_total = 0

    def pump(block_idx):
        """BTS stub: follow the clock, feed downlink, drain uplink."""
        nonlocal beacons, ul_pkts, dl_pkts, feed_fn
        while True:
            d = clock.recv(64, timeout_ms=0)
            if not d:
                break
            _, _, a = proto.parse_message(d)
            beacons += 1
            if feed_fn is None:
                feed_fn = int(a[0])
        if feed_fn is not None:
            pkts = proto.pack_downlink_block(dl_bits, dl_valid, feed_fn,
                                             hyperframe=HYPERFRAME)
            for i in range(n_dl):
                data[i].send_batch(pkts)
                dl_pkts += pkts.shape[0]
            feed_fn = (feed_fn + bf) % HYPERFRAME
        for i in range(n):
            got = data[i].drain_fixed(proto.UPLINK_LEN, 2048)
            ul_pkts += got.shape[0]

    total_blocks = args.warmup + args.blocks
    stale0 = underrun0 = 0
    for b in range(total_blocks):
        if b == args.warmup:
            t0 = time.perf_counter()
            # warmup (compile) blocks run far slower than the clock
            # lead assumes; their stale/underrun churn isn't steady
            # state, so report the timed window's deltas
            stale0, underrun0 = daemon.stale_dumped, daemon.underruns
        pump(b)
        daemon.step()
        if b == args.warmup - 1:
            log("warmup done; timing")
    daemon.flush()
    t_timed = time.perf_counter() - t0
    pump(total_blocks)

    frames = args.blocks * bf
    ms_per_frame = t_timed / frames * 1e3
    expected_det_per_block = bf * n * args.ul_slots
    result = {
        "metric": "daemon_soak_ms_per_frame",
        "value": round(ms_per_frame, 3),
        "unit": "ms/frame (budget 4.615)",
        "vs_baseline": round(4.615 / ms_per_frame, 2),
        "detail": {
            "carriers": n,
            "blocks_timed": args.blocks,
            "realtime": ms_per_frame < 4.615,
            "uplink_datagrams": ul_pkts,
            "downlink_datagrams": dl_pkts,
            "expected_uplink_per_block": expected_det_per_block,
            "clock_beacons": beacons,
            "stale_dumped": daemon.stale_dumped - stale0,
            "underruns": daemon.underruns - underrun0,
            "clock_lead": daemon.clock_lead,
            "exact": bool(args.exact),
            "compact": bool(args.compact),
            "ul_slots": args.ul_slots,
            "dl_carriers": n_dl,
            "d2h_bytes_per_block": round(
                daemon.d2h_bytes / max(total_blocks, 1)),
            "d2h_bytes_per_block_dense": round(
                daemon.d2h_bytes_dense / max(total_blocks, 1)),
            "bus": args.bus,
            "block_frames": bf,
            "depth": args.depth,
            **({"bus_tx_MB": round(sum(b.tx_bytes for b in buses)
                                   / 1e6, 2),
                "bus_rx_MB": round(sum(b.rx_bytes for b in buses)
                                   / 1e6, 2),
                "bus_MBps": round(sum(b.tx_bytes + b.rx_bytes
                                      for b in buses)
                                  / max(t_timed, 1e-9) / 1e6, 1)}
               if buses else {}),
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
        },
    }
    if srv is not None:
        srv.terminate()
        srv.wait(timeout=10)
    # sanity: uplink detections must actually flow at scale
    need = expected_det_per_block * (args.blocks - 2)
    if args.bus == "socket":
        # the SimBus stream starts at the hardware's own ts origin;
        # alignment settles within a few blocks
        need = expected_det_per_block * max(args.blocks // 2, 1)
    assert ul_pkts >= need, f"uplink starved: {ul_pkts} < {need}"
    return result


if __name__ == "__main__":
    print(json.dumps(run()))
