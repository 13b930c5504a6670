#!/usr/bin/env python
"""Smoke run of the GSM transceiver on one GPU.

Drives the main path once through the entry points a user calls, at the
widths the system supports on one card: 8 carriers (a real multi-TRX
site) and 1024 carriers, each carrier 8 timeslots in the standard
layout (combination IV on TN0, C-I TCH/F on TN1-7; the fully-resident
duplex splits the slots 4 signalling + 4 TCH). Phases, in order:

  gpu-tests  the tests marked `gpu`, in a pytest child process
  bts-spawn  BTSApp(spawn_transceiver=True) in a child process: its
             transceiver grandchild owns the card, the BTS does not
  device     the card, and a bit-exact complex64 host<->device trip
  compile    each device program lowered and compiled at real width
  exact      uplink_block on the planted-burst input: every burst
             detected; batched schedule == rx_step scan; GPU == CPU
  resident   ResidentL1 at 1024 carriers: real XCCH/TCH/FACCH content
             sent, looped back, every frame decoded exactly once
  served     BlockTrxDaemon over the 3-plane UDP wire (daemon_soak)
  bts        an over-the-air location update through BTSApp+TrxDaemon

The two child phases run before this process first uses JAX, so one
process holds the card at a time. Any failure exits non-zero; the last
line printed is {"ok": true, "device": {...}}.

    python chip_smoke.py            # one GPU, every phase above
    python chip_smoke.py --four     # only the sharded path, four GPUs
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import openbts_ttsou_tpu  # noqa: E402,F401  (fails outside the repo)

SMALL, FULL = 8, 1024  # carriers
#: tolerance on soft bits ([0, 1] floats, float32 with every contraction
#: at Precision.HIGHEST): half of one 1/255 step of the uplink wire
#: format, so the quantized bytes differ by at most one
SOFT_ATOL = 2e-3
XCCH_TNS, TCH_TNS = (0, 1, 6, 7), (2, 3, 4, 5)

_T0 = time.monotonic()


def log(phase: str, msg: str) -> None:
    print(f"[{phase} {time.monotonic() - _T0:7.1f}s] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    """Fail the run (an assert would vanish under `python -O`)."""
    if not ok:
        raise RuntimeError(what)


def nvidia_smi() -> str:
    """Card name and power limit, read by a process that is not JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def probe_devices() -> tuple:
    """(platform, device_kind, count) as JAX reports them, read in a
    child process so that this one does not hold the card yet."""
    code = ("import json, jax; d = jax.devices(); "
            "print(json.dumps([d[0].platform, d[0].device_kind, len(d)]))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"JAX found no device:\n{r.stderr[-2000:]}")
    return tuple(json.loads(r.stdout.strip().splitlines()[-1]))


def require_gpu(platform: str) -> None:
    if platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found "
                         f"{platform!r}")


# ---------------------------------------------------------------------------
# child-process phases
# ---------------------------------------------------------------------------

def phase_gpu_tests() -> None:
    env = dict(os.environ, OPENBTS_TEST_PLATFORMS="cuda,cpu")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "-p", "no:randomly"],
        cwd=REPO, env=env, capture_output=True, text=True)
    print(r.stdout[-3000:], flush=True)
    if r.returncode != 0 or " passed" not in r.stdout:
        raise SystemExit(f"gpu tests failed (rc {r.returncode})\n"
                         f"{r.stderr[-2000:]}")
    log("gpu-tests", "passed")


def spawned_bts(base_port: int = 45700, frames: int = 300,
                timeout_s: float = 300.0) -> None:
    """BTSApp(spawn_transceiver=True): the control-plane bring-up must
    be answered by the spawned daemon and its clock must advance
    `frames` frames. Runs as its own process (see phase_bts_spawn)."""
    import jax

    from openbts_ttsou_tpu.apps.openbts import BTSApp
    from openbts_ttsou_tpu.trx import protocol as proto
    from openbts_ttsou_tpu.utils.gsm_time import HYPERFRAME

    app = BTSApp(trx_base_port=base_port, spawn_transceiver=True)
    clock_fns = []
    handle = app.trx.handle_clock

    def handle_and_record(data):
        handle(data)
        kind, verb, args = proto.parse_message(data)
        if kind == "IND" and verb == "CLOCK":
            clock_fns.append(int(args[0]))

    app.trx.handle_clock = handle_and_record
    try:
        check(jax.devices()[0].platform == "cpu", str(jax.devices()))
        app.trx.start()
        deadline = time.monotonic() + timeout_s
        while not app.bringup():
            check(app.trx_child.poll() is None, "transceiver exited")
            check(time.monotonic() < deadline, "bring-up unanswered")
        while not clock_fns or \
                (clock_fns[-1] - clock_fns[0]) % HYPERFRAME < frames:
            check(app.trx_child.poll() is None, "transceiver exited")
            check(time.monotonic() < deadline,
                  f"clock stalled: {clock_fns[:1]}..{clock_fns[-1:]}")
            app.step()
            time.sleep(0.002)
        print(f"bring-up answered; BTS on {jax.devices()[0].platform}; "
              f"{len(clock_fns)} IND CLOCK, FN {clock_fns[0]} -> "
              f"{clock_fns[-1]}", flush=True)
    finally:
        app.shutdown()
        app.trx_child.wait(timeout=30)


def phase_bts_spawn() -> None:
    r = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.spawned_bts()"],
        cwd=REPO, capture_output=True, text=True)
    print(r.stdout[-2000:], flush=True)
    if r.returncode:
        raise SystemExit(f"spawned BTS failed\n{r.stderr[-3000:]}")
    log("bts-spawn", "passed")


# ---------------------------------------------------------------------------
# in-process phases
# ---------------------------------------------------------------------------

def phase_device(cache_dir: str) -> dict:
    import jax
    import numpy as np

    d = jax.devices()
    log("device", f"kind={d[0].device_kind} count={len(d)} "
        f"jax={jax.__version__} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={cache_dir}")
    rng = np.random.default_rng(0)
    tree = {"iq": (rng.standard_normal((FULL, 24000, 2)) * 3e4
                   ).astype(np.float32).view(np.complex64)[..., 0],
            "taps": (rng.standard_normal(7) + 1j * rng.standard_normal(7)
                     ).astype(np.complex64),
            "scalar": np.complex64(1.5 - 2.25j)}
    back = jax.device_get(jax.device_put(tree))
    for k, v in tree.items():
        b = np.asarray(back[k])
        check(b.dtype == np.complex64
              and b.tobytes() == np.asarray(v).tobytes(), k)
    log("device", "complex64 round trip bit-exact "
        f"({tree['iq'].nbytes} B)")
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def _layout_state(cfg):
    import jax.numpy as jnp

    from bench import standard_chan_type
    from openbts_ttsou_tpu.trx import init_state

    return init_state(cfg)._replace(
        chan_type=jnp.asarray(standard_chan_type(cfg.n_chan)))


def _report(tag: str, compiled, seconds: float) -> None:
    m = compiled.memory_analysis()
    log("compile", f"{tag}: {seconds:.1f} s; argument "
        f"{m.argument_size_in_bytes} B, output {m.output_size_in_bytes} B,"
        f" temp {m.temp_size_in_bytes} B, code "
        f"{m.generated_code_size_in_bytes} B")


def _compile(tag: str, fn, *args):
    t0 = time.perf_counter()
    c = fn.lower(*args).compile()
    _report(tag, c, time.perf_counter() - t0)
    return c


def phase_compile(small: int = SMALL, full: int = FULL) -> dict:
    """Compile each device program; returns the uplink_block ones."""
    import jax
    import jax.numpy as jnp

    from openbts_ttsou_tpu.gsm import l1fec
    from openbts_ttsou_tpu.models import transceiver as M
    from openbts_ttsou_tpu.trx import TrxConfig

    spec = M.UplinkSpec()
    f, t_halo = spec.frames, spec.block_in + 2 * M.RX_HALO_DEV
    sds = jax.ShapeDtypeStruct
    out = {}
    for c in (small, full):
        cfg = TrxConfig(n_chan=c)
        st = _layout_state(cfg)
        out[c] = _compile(f"uplink_block@{c}", M.uplink_block, cfg, spec,
                          st, sds((c, spec.block_in), jnp.complex64))
        _compile(f"duplex_block_wire@{c}", M.duplex_block_wire, cfg, spec,
                 st, sds((c, t_halo, 2), jnp.int16),
                 sds((c, M.TX_TAIL_SYM), jnp.complex64),
                 sds((f, c, 8, 148), jnp.uint8), sds((f, c, 8), bool),
                 sds((f, c, 8), jnp.float32), sds((), jnp.int32), True)

    c = full
    cfg = TrxConfig(n_chan=c)
    content = (sds((4, c, 8, 184), jnp.uint8), sds((4, c, 8), bool),
               sds((3, c, 8, 260), jnp.uint8), sds((3, c, 8), bool),
               sds((3, c, 8, 184), jnp.uint8), sds((3, c, 8), bool),
               sds((c, 8), bool))
    carry = jax.eval_shape(lambda: (l1fec.TchTxCarry.zeros(c * 8),
                                    M.XcchTxCarry.zeros(c)))
    _compile(f"duplex_block_decoded@{c}", M.duplex_block_decoded, cfg,
             spec, _layout_state(cfg), sds((c, t_halo), jnp.complex64),
             sds((c, M.TX_TAIL_SYM), jnp.complex64), content,
             sds((f, c, 8), jnp.float32), carry, sds((), jnp.int32),
             sds((M.DECODE_PRELUDE, c, 8, 148), jnp.float32),
             sds((), bool), 0, 0, XCCH_TNS, TCH_TNS)

    # the served path's program, as BlockTrxDaemon calls it
    c = small
    cfg = TrxConfig(n_chan=c)
    n_buf = (M.PACK_HDR + f * c * 8 * M.DL_ROW + c * t_halo * 4 + c)
    _compile(f"duplex_block_compact@{c}", M.duplex_block_compact, cfg,
             spec, _layout_state(cfg), sds((n_buf,), jnp.uint8),
             sds((c, M.TX_TAIL_SYM), jnp.complex64))
    return out


def _compare(phase: str, tag: str, a, b, atol: float = SOFT_ATOL) -> None:
    """Two RxResults: identical detections, TOA and hard bits; soft
    bits within `atol`."""
    import numpy as np

    det_a, det_b = np.asarray(a.detected), np.asarray(b.detected)
    check(np.array_equal(det_a, det_b),
          f"{tag}: detections differ at {np.argwhere(det_a != det_b)[:5]}")
    tim_a, tim_b = np.asarray(a.timing), np.asarray(b.timing)
    check(np.array_equal(tim_a[det_a], tim_b[det_b]), f"{tag}: TOA")
    sa, sb = np.asarray(a.soft_bits), np.asarray(b.soft_bits)
    hard = np.array_equal((sa > 0.5)[det_a], (sb > 0.5)[det_b])
    err = float(np.max(np.abs(sa - sb))) if sa.size else 0.0
    log(phase, f"{tag}: {int(det_a.sum())} detections identical, TOA "
        f"identical, hard bits identical={hard}, max |soft diff| {err} "
        f"(atol {atol})")
    check(hard and err <= atol, tag)


def phase_exact(compiled: dict, small: int = SMALL,
                full: int = FULL) -> None:
    import jax
    import jax.lax as lax
    import numpy as np

    from bench import planted_symbols
    from openbts_ttsou_tpu.models import transceiver as M
    from openbts_ttsou_tpu.ops import fir
    from openbts_ttsou_tpu.parallel.sharded import _slot_windows
    from openbts_ttsou_tpu.trx import TrxConfig
    from openbts_ttsou_tpu.trx import engine as eng

    spec = M.UplinkSpec()
    f = spec.frames
    lpf_up = fir.resampler_lpf(96, 65, 651)
    lpf_dn = fir.resampler_lpf(65, 96, 961)
    to_dev = jax.jit(lambda s: fir.polyphase_resample(
        s, 96, 65, lpf_up)[:, : spec.block_in])
    to_sym = jax.jit(lambda x: fir.polyphase_resample(
        x, 65, 96, lpf_dn)[:, : spec.block_symbols])
    batched = jax.jit(M.process_block_exact, static_argnums=(0, 1))
    for c in (small, full):
        cfg = TrxConfig(n_chan=c)
        state = _layout_state(cfg)
        samples = to_dev(jax.device_put(
            planted_symbols(c, spec.block_symbols, f)))
        _, res = compiled[c](state, samples)
        det = np.asarray(res.detected)
        check(det[:, :, 1].all(), f"@{c}: planted bursts missed")
        log("exact", f"@{c}: {int(det[:, :, 1].sum())} of {f * c} planted "
            f"bursts detected ({int(det.sum())} detections in all)")
        sym = to_sym(samples)
        scan = jax.jit(lambda st, s: lax.scan(
            lambda a, fr: eng.rx_step(cfg, a, fr), st, _slot_windows(s, f)))
        _compare("exact", f"@{c} batched vs rx_step scan",
                 batched(cfg, f, state, sym)[1], scan(state, sym)[1])
        if c == small:
            cpu = jax.devices("cpu")[0]
            _, res_cpu = M.uplink_block(cfg, spec,
                                        jax.device_put(state, cpu),
                                        jax.device_put(samples, cpu))
            _compare("exact", f"@{c} GPU vs CPU", res, res_cpu)


def resident_content(rng, c: int, w: int, fnw: int, live: bool):
    """One window's dl_content for ResidentL1 with the TCH/XCCH slot
    split on every carrier, and the frames it sends: TCH slots carry
    speech or FACCH per group, XCCH slots one L2 frame per group that
    starts inside the window (on the absolute FN%4 grid)."""
    import numpy as np

    tch, xcch = list(TCH_TNS), list(XCCH_TNS)
    sp = np.zeros((3, c, 8, 260), np.uint8)
    spv = np.zeros((3, c, 8), bool)
    fa = np.zeros((3, c, 8, 184), np.uint8)
    fav = np.zeros((3, c, 8), bool)
    x = np.zeros((4, c, 8, 184), np.uint8)
    xv = np.zeros((4, c, 8), bool)
    tch_mask = np.zeros((c, 8), bool)
    tch_mask[:, tch] = True
    sent = collections.Counter()
    if live:
        for j in range(3):
            if (w + j) % 2:
                fa[j][:, tch] = rng.integers(0, 2, (c, 4, 184))
                fav[j][:, tch] = True
                kind, payload = "f", fa[j]
            else:
                sp[j][:, tch] = rng.integers(0, 2, (c, 4, 260))
                spv[j][:, tch] = True
                kind, payload = "s", sp[j]
            sent.update((kind, ci, tn, payload[ci, tn].tobytes())
                        for ci in range(c) for tn in tch)
        off = (-(fnw % 4)) % 4
        for g in range((12 - off) // 4 + 1):
            x[g][:, xcch] = rng.integers(0, 2, (c, 4, 184))
            xv[g][:, xcch] = True
            sent.update(("x", ci, tn, x[g, ci, tn].tobytes())
                        for ci in range(c) for tn in xcch)
    return (x, xv, sp, spv, fa, fav, tch_mask), sent


def decoded_frames(blocks) -> collections.Counter:
    """Every frame a window decoded, as (kind, carrier, TN, payload)."""
    import numpy as np

    got = collections.Counter()
    for kind, ok, bits in (
            ("s", blocks.tch_good, blocks.tch_speech),
            ("f", blocks.facch_ok, blocks.facch_bits),
            ("x", blocks.ok, blocks.bits)):
        ok, bits = np.asarray(ok), np.asarray(bits)
        for g, ci, tn in np.argwhere(ok):
            got[(kind, int(ci), int(tn), bits[g, ci, tn].tobytes())] += 1
    return got


def phase_resident(c: int = FULL, windows: int = 4) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from openbts_ttsou_tpu.gsm import tdma
    from openbts_ttsou_tpu.models import ResidentL1
    from openbts_ttsou_tpu.models import transceiver as M
    from openbts_ttsou_tpu.trx import TrxConfig
    from openbts_ttsou_tpu.trx import engine as eng

    cfg = TrxConfig(n_chan=c)
    spec = M.UplinkSpec()
    b, h = spec.block_in, M.RX_HALO_DEV
    rev = tdma.FACCH_TCHF.reverse_map()
    fn0 = int(np.where(rev == 0)[0][0])
    while fn0 % 4:
        fn0 += 26
    state = eng.init_state(cfg)._replace(
        chan_type=jnp.full((c, 8), eng.ChanType.I, jnp.int32))
    rng = np.random.default_rng(5)
    contents, sent = [], collections.Counter()
    for w in range(windows + 1):  # the last window drains the carries
        content, s = resident_content(rng, c, w, fn0 + spec.frames * w,
                                      w < windows)
        contents.append(tuple(jnp.asarray(a) for a in content))
        sent += s

    def drive(uplink):
        l1 = ResidentL1(cfg, spec, xcch_tns=XCCH_TNS, tch_tns=TCH_TNS,
                        state=state, fn0=fn0)
        return [l1.step(uplink(w), contents[w])
                for w in range(windows + 1)]

    t0 = time.perf_counter()
    silence = jnp.zeros((c, b + 2 * h), jnp.complex64)
    air = np.concatenate(
        [np.asarray(tx) / cfg.tx_full_scale * 9000.0
         for tx, _ in drive(lambda w: silence)]
        + [np.zeros((c, 2 * h), np.complex64)], axis=-1)
    log("resident", f"pass 1 (tx) done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    got = collections.Counter()
    for _, blocks in drive(lambda w: jnp.asarray(
            air[:, w * b: (w + 1) * b + 2 * h])):
        got += decoded_frames(blocks)
    log("resident", f"pass 2 (rx) done in {time.perf_counter() - t0:.1f} s")
    kinds = collections.Counter(k[0] for k in sent.elements())
    stats = jax.devices()[0].memory_stats() or {}
    log("resident", f"@{c} carriers, {windows} windows: sent "
        f"{sum(sent.values())} frames {dict(kinds)}, decoded "
        f"{sum(got.values())}; peak_bytes_in_use "
        f"{stats.get('peak_bytes_in_use', 'not reported')}")
    check(max(got.values(), default=1) == 1, "a frame decoded twice")
    check(got == sent, f"lost {sum((sent - got).values())}, "
          f"spurious {sum((got - sent).values())}")


def phase_served(c: int = SMALL, blocks: int = 24,
                 power: str = "") -> None:
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import daemon_soak

    r = daemon_soak.run(["--carriers", str(c), "--blocks", str(blocks),
                         "--warmup", "6", "--base-port", "36700"])
    d = r["detail"]
    need = d["expected_uplink_per_block"] * (blocks - 2)
    log("served", f"@{c} carriers: {blocks} timed blocks, uplink "
        f"datagrams {d['uplink_datagrams']} (need >= {need}), downlink "
        f"{d['downlink_datagrams']}, clock beacons {d['clock_beacons']}")
    log("served", f"{r['value']} ms/frame (information only) on "
        f"{power or 'this card'}")
    check(d["clock_beacons"] > 0, "no clock beacons")
    check(d["uplink_datagrams"] >= need, "uplink starved")


def phase_bts() -> None:
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_e2e_lur as lur

    rig = lur.make_rig()
    try:
        accept = lur.location_update(*rig)
    finally:
        rig[0].shutdown()
    log("bts", f"location update accepted over the air: TMSI "
        f"{accept.identity.tmsi:#x}, LAC {accept.lai.lac}")


# ---------------------------------------------------------------------------
# the sharded path on four cards
# ---------------------------------------------------------------------------

def four(c: int = FULL) -> dict:
    """sharded_uplink_pipeline(mode="decoded") with the slot split and
    sharded_duplex_pipeline on make_mesh(4) (2 chan × 2 time), against
    the same 26 frames on one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import __graft_entry__ as graft
    from openbts_ttsou_tpu.gsm import l1fec
    from openbts_ttsou_tpu.models.transceiver import DECODE_PRELUDE
    from openbts_ttsou_tpu.parallel import (make_mesh,
                                            sharded_duplex_pipeline,
                                            sharded_uplink_pipeline)
    from openbts_ttsou_tpu.parallel.sharded import (ShardedPipelineSpec,
                                                    state_for_shards)
    from openbts_ttsou_tpu.trx import TrxConfig, init_state
    from openbts_ttsou_tpu.trx import engine as eng
    from openbts_ttsou_tpu.utils import constants as C
    from tools import collective_inventory as ci

    mesh4, mesh1 = make_mesh(4), make_mesh(1)
    n_t, frames = mesh4.shape["time"], 13
    f_all = n_t * frames
    fn0 = 52  # FN%4 == 0: XCCH groups start at local frames 0, 4, ...
    cfg = TrxConfig(n_chan=c)
    spec4 = ShardedPipelineSpec(n_chan_total=c, frames_per_shard=frames)
    spec1 = ShardedPipelineSpec(n_chan_total=c, frames_per_shard=f_all)
    state = init_state(cfg)._replace(
        chan_type=jnp.full((c, 8), eng.ChanType.I, jnp.int32))
    log("four", f"mesh {dict(mesh4.shape)} on "
        f"{[d.id for d in mesh4.devices.flat]}, {c} carriers, {f_all} "
        f"frames from FN {fn0}")

    # downlink bursts: XCCH frames on the FN%4 grid of the XCCH slots
    # (decodable content), TSC-stamped random bursts on the TCH slots
    rng = np.random.default_rng(11)
    n_g = f_all // 4
    frames184 = rng.integers(0, 2, (n_g, c, 8, 184)).astype(np.uint8)
    xb = np.asarray(l1fec.xcch_encode(jnp.asarray(frames184),
                                      tsc=0))  # [G, C, 8, 4, 148]
    bits = rng.integers(0, 2, (f_all, c, 8, 148)).astype(np.uint8)
    bits[..., 61:87] = C.TRAINING_SEQUENCE[0]
    xcch = list(XCCH_TNS)
    bits[: 4 * n_g][:, :, xcch] = np.moveaxis(xb, 3, 1).reshape(
        4 * n_g, c, 8, 148)[:, :, xcch]
    valid = np.ones((f_all, c, 8), bool)
    valid[4 * n_g:][:, :, xcch] = False
    att = np.zeros((f_all, c, 8), np.float32)
    sent = collections.Counter(
        ("x", ci_, tn, frames184[g, ci_, tn].tobytes())
        for g in range(n_g) for ci_ in range(c) for tn in xcch)

    def run_duplex(mesh, spec, ul):
        step = sharded_duplex_pipeline(mesh, cfg, spec)
        args = (state_for_shards(state, mesh.shape["time"]), ul, bits,
                valid, att, jnp.asarray(fn0, jnp.int32))
        return step, step(*args), args

    zeros = jnp.zeros((c, n_t * spec4.block_in), jnp.complex64)
    _, (_, _, air, _), _ = run_duplex(mesh1, spec1, zeros)
    ul = jnp.asarray(np.asarray(air) / cfg.tx_full_scale * 9000.0)
    _, (_, res1, tx1, _), _ = run_duplex(mesh1, spec1, ul)
    dstep, (_, res4, tx4, _), dargs = run_duplex(mesh4, spec4, ul)
    tx_err = float(np.max(np.abs(np.asarray(tx4) - np.asarray(tx1))))
    log("four", f"duplex tx: max |4-card − 1-card| {tx_err} of full "
        f"scale {cfg.tx_full_scale}")
    check(tx_err <= 1e-3 * cfg.tx_full_scale, "duplex tx differs")
    _compare("four", "duplex rx 4-card vs 1-card", res4, res1)

    # streaming decoded uplink with the slot split, the same 26 frames
    def decoded(mesh, spec):
        step = sharded_uplink_pipeline(mesh, cfg, spec, mode="decoded",
                                       xcch_tns=XCCH_TNS, tch_tns=TCH_TNS)
        args = (state_for_shards(state, mesh.shape["time"]), ul,
                jnp.asarray(fn0, jnp.int32),
                jnp.zeros((1, DECODE_PRELUDE, c, 8, 148), jnp.float32),
                jnp.asarray(False))
        _, r, _, dec = step(*args)
        return step, args, r, decoded_frames(dec)

    ustep, uargs, r4, got4 = decoded(mesh4, spec4)
    _, _, r1, got1 = decoded(mesh1, spec1)
    _compare("four", "decoded uplink 4-card vs 1-card", r4, r1)
    check(max(got4.values(), default=1) == 1, "a frame decoded twice")
    check(got4 == got1, "decoded frames differ")
    xs = collections.Counter({k: v for k, v in got4.items()
                              if k[0] == "x"})
    log("four", f"decoded frames identical: {sum(got4.values())}; XCCH "
        f"{sum(xs.values())} of {sum(sent.values())} sent")
    check(xs == sent, "XCCH frames lost")

    for tag, step, args in (("uplink decoded", ustep, uargs),
                            ("duplex", dstep, dargs)):
        inv = ci.inventory(step.lower(*args).compile())
        log("four", f"collective inventory, {tag}: {json.dumps(inv)}")
    graft.dryrun_multichip(4)
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(mesh4.devices.flat)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args()

    platform, _, count = probe_devices()
    require_gpu(platform)
    power = nvidia_smi()
    print(f"card: {power}", flush=True)
    if args.four and count < 4:
        raise SystemExit(f"--four needs 4 GPUs, found {count}")
    if not args.four:
        phase_gpu_tests()
        phase_bts_spawn()

    import jax

    from openbts_ttsou_tpu.utils.compile_cache import enable_compile_cache

    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        jax.config.update("jax_platforms", plats + ",cpu")  # reference
    cache_dir = enable_compile_cache()
    if args.four:
        device = four()
    else:
        device = phase_device(cache_dir)
        compiled = phase_compile()
        phase_exact(compiled)
        phase_resident()
        phase_served(power=power)
        phase_bts()
    print(f"card: {power}", flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
