"""The sharded full-duplex pipeline: dp over channels, sp over time.

Maps the reference's process layout (SURVEY.md §2.2) onto a
``(chan, time)`` mesh:

- the `chan` axis shards ARFCN carriers (data parallelism — each carrier
  is independent, like the per-ARFCN `ARFCNManager`s);
- the `time` axis shards the sample stream into blocks (sequence/context
  parallelism): the polyphase front-end gets its overlap-save boundary
  samples from ring neighbors via `ppermute` (the reference's
  INHISTORY/OUTHISTORY buffers, Transceiver/radioInterface.cpp:123-260);
- the burst clock is pure index math (block index → FN), checked with a
  `psum` sample-count agreement (the IND CLOCK plane,
  Transceiver.cpp:726-739).

Each time shard advances its own copy of the adaptive engine state over
its frames (a stream-parallel worker). With ``carry_state=True`` (the
default) the step ends with an on-device merge over the `time` axis so
every shard starts the next step from the stream-end state:

- `energy_threshold`: the shard deltas are summed (`psum`) onto the
  common start value — exact against the serial engine whenever each
  shard's window is shorter than the 50-frame adaptation horizon
  (frames_per_shard ≤ 50), because then each shard contributes at most
  the events the serial stream would have produced in its frames;
- `prev_false_detect_fn`: latest event wins (`pmax` of the
  window-relative fn);
- per-slot channel/DFE estimates: last writer wins — the shard with
  the newest `chan_estimate_fn` supplies the [C, 8] slot's state
  (`all_gather` + argmax; T is small so the gather is bytes).

Within one step the shards still evolve independently from the common
start (the serial chain is not recomputable in parallel); the merge
makes the *step-boundary* trajectory track the serial stream, which is
what the 50-frame-scale adaptation needs. `tests/test_parallel.py::
test_cross_shard_state_carry` pins this against the serial engine with
near-threshold bursts and shows the no-carry mode diverging.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from openbts_ttsou_tpu.ops import fir
from openbts_ttsou_tpu.parallel.halo import exchange_halo, resample_halo, resample_block
from openbts_ttsou_tpu.trx import engine as eng
from openbts_ttsou_tpu.utils.gsm_time import FRAME_SYMBOLS, SLOT_SAMPLE_PATTERN

Array = jax.Array


class ShardedPipelineSpec(NamedTuple):
    """Static geometry of one sharded step."""

    n_chan_total: int
    frames_per_shard: int
    p: int = 65  # device rate → symbol rate (the 64M USRP 400 kS/s path)
    q: int = 96
    taps: int = 961

    @property
    def block_symbols(self) -> int:
        return self.frames_per_shard * FRAME_SYMBOLS

    @property
    def block_in(self) -> int:
        """Device-rate samples per time shard (multiple of q)."""
        assert (self.block_symbols * self.q) % self.p == 0, (
            "frames_per_shard·1250·q must divide p — use multiples of 13 "
            "frames (1250·96/65 = 24000/13)")
        return self.block_symbols * self.q // self.p

    @property
    def halo_in(self) -> int:
        return resample_halo(self.p, self.q, self.taps)


def _slot_windows(symbols: Array, frames: int) -> Array:
    """[C, frames·1250] symbol-rate stream → [frames, C, 8, 157] slot
    windows along the 157/156/156/156 framing
    (Transceiver52M/radioInterface.cpp:270-292)."""
    c = symbols.shape[0]
    offs = np.concatenate([[0], np.cumsum(SLOT_SAMPLE_PATTERN)])[:-1]
    starts = (np.arange(frames)[:, None] * FRAME_SYMBOLS + offs[None, :])
    idx = starts[..., None] + np.arange(eng.SLOT_SAMPLES)  # [F, 8, 157]
    idx = np.minimum(idx, symbols.shape[-1] - 1)
    win = symbols[:, jnp.asarray(idx)]  # [C, F, 8, 157]
    return jnp.moveaxis(win, 0, 1)


def state_for_shards(state: eng.TrxState, n_time_shards: int) -> eng.TrxState:
    """Replicate engine state across time shards: every leaf gains a
    leading [time_shards] axis."""
    return jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n_time_shards,) + x.shape).copy(),
        state)


def state_partition_specs() -> eng.TrxState:
    """PartitionSpecs of the [time_shards]-stacked TrxState — the
    pipeline's state in/out sharding contract (exported so multi-host
    drivers can build global arrays with matching NamedShardings)."""
    return eng.TrxState(
        fn=P("time"),
        chan_type=P("time", "chan"),
        tsc=P("time", "chan"),
        max_expected_delay=P("time", "chan"),
        energy_threshold=P("time", "chan"),
        prev_false_detect_fn=P("time", "chan"),
        chan_valid=P("time", "chan"),
        chan_response=P("time", "chan"),
        chan_resp_offset=P("time", "chan"),
        chan_amplitude=P("time", "chan"),
        snr=P("time", "chan"),
        dfe_forward=P("time", "chan"),
        dfe_feedback=P("time", "chan"),
        chan_estimate_fn=P("time", "chan"),
        filler=P("time", "chan"),
    )


def _merge_time_shards(state0: eng.TrxState, state: eng.TrxState,
                       fn0: Array, frames_total: int) -> eng.TrxState:
    """Fold the per-time-shard end states into the stream-end state
    (the reference's single Transceiver walks these fields serially,
    Transceiver.cpp:294-356; see the module docstring for the merge
    semantics and its exactness window). Must run inside `shard_map`
    over the "time" axis. `state0` is the common step-start state."""
    from openbts_ttsou_tpu.utils.gsm_time import HYPERFRAME, fn_delta

    # cumulative scalar adaptation: sum the shard deltas
    e_thr = state0.energy_threshold + lax.psum(
        state.energy_threshold - state0.energy_threshold, "time")
    # event clock: the latest false-detect/quiet event in the window
    rel_false = fn_delta(state.prev_false_detect_fn, fn0)
    rel_false = lax.pmax(rel_false, "time")
    prev_false = (fn0 + rel_false) % HYPERFRAME

    # per-slot channel/DFE state: the shard holding the newest estimate
    # wins (estimate fns are disjoint across shards; stale entries are
    # identical in every shard, so ties are value-ties)
    rel_est = fn_delta(state.chan_estimate_fn, fn0)  # [C, 8]
    rels = lax.all_gather(rel_est, "time")  # [T, C, 8]
    winner = jnp.argmax(rels, axis=0).astype(jnp.int32)

    def take_winner(leaf):
        g = lax.all_gather(leaf, "time")  # [T, C, 8, ...]
        idx = winner.reshape((1,) + winner.shape
                             + (1,) * (g.ndim - 3))
        idx = jnp.broadcast_to(idx, (1,) + g.shape[1:])
        return jnp.take_along_axis(g, idx, axis=0)[0]

    return state._replace(
        fn=((fn0 + frames_total) % HYPERFRAME).astype(jnp.int32),
        energy_threshold=e_thr,
        prev_false_detect_fn=prev_false,
        chan_valid=take_winner(state.chan_valid),
        chan_response=take_winner(state.chan_response),
        chan_resp_offset=take_winner(state.chan_resp_offset),
        chan_amplitude=take_winner(state.chan_amplitude),
        snr=take_winner(state.snr),
        dfe_forward=take_winner(state.dfe_forward),
        dfe_feedback=take_winner(state.dfe_feedback),
        chan_estimate_fn=take_winner(state.chan_estimate_fn),
    )


def _downlink_shard(cfg_local: eng.TrxConfig, spec: ShardedPipelineSpec,
                    state0: eng.TrxState, dl_bits: Array, dl_valid: Array,
                    dl_atten: Array, fn_start: Array,
                    collectives: bool) -> Array:
    """One time shard's downlink leg: modulate its frames, then 96/65
    resample to device rate with symbol halos from ring neighbors (the
    tx mirror of the rx overlap-save — the reference carries
    sendHistory on this path, Transceiver/radioInterface.cpp:123-186).
    Must run inside `shard_map`; returns [C_local, block_in]."""
    from openbts_ttsou_tpu.models.transceiver import _assemble_stream

    del fn_start  # tx_frames: the whole shard modulates in one batch
    slots = eng.tx_frames(cfg_local, state0, dl_bits, dl_valid, dl_atten)
    sym = _assemble_stream(slots)  # [C_local, F·1250]
    h = resample_halo(spec.q, spec.p, 651)  # symbols per side (65)
    if collectives:
        sym = exchange_halo(sym, h, h, "time")
    else:  # benchmark isolation only: zero halos, WRONG at shard edges
        sym = jnp.pad(sym, [(0, 0)] * (sym.ndim - 1) + [(h, h)])
    lpf = fir.resampler_lpf(spec.q, spec.p, 651)
    return resample_block(sym, spec.q, spec.p, lpf, h,
                          spec.block_symbols)


def sharded_uplink_pipeline(mesh: jax.sharding.Mesh, cfg: eng.TrxConfig,
                            spec: ShardedPipelineSpec,
                            mode: str = "exact",
                            carry_state: bool = True,
                            collectives: bool = True,
                            xcch_tns: tuple | None = None,
                            tch_tns: tuple | None = None):
    """Build the jitted sharded step.

    Returns ``step(state_sh, samples, fn0) -> (state_sh, result, clock)``
    with:
      samples: [C_total, time_shards·(halo-free) block_in] complex64
               device-rate stream, sharded P('chan', 'time');
      state_sh: TrxState with leading [time_shards] axis,
               sharded P('time', 'chan', ...);
      fn0:     [] int32, first frame number of this step's stream window;
      result:  RxResult stacked [F_total, C_total, 8, ...] sharded
               P('time', 'chan');
      clock:   [] int32 — psum'd sample count (clock-plane agreement).

    mode="decoded" adds STREAMING on-device FEC: the step signature
    becomes ``step(state_sh, samples, fn0, prev_soft, prev_valid) ->
    (state_sh, result, clock, DecodedBlocks)`` where prev_soft is
    [1, DECODE_PRELUDE, C_total, 8, 148] (the previous step's final
    soft-bit tail: ``res.soft_bits[-DECODE_PRELUDE:][None]``; zeros +
    prev_valid=False on the first step). Groups spanning time-shard
    boundaries decode via a neighbor ppermute of soft-bit tails; the
    step boundary rides the carried prev_soft.
    """
    n_time = mesh.shape["time"]
    n_chan_dev = mesh.shape["chan"]
    assert spec.n_chan_total % n_chan_dev == 0
    c_local = spec.n_chan_total // n_chan_dev
    cfg_local = cfg._replace(n_chan=c_local)
    lpf = fir.resampler_lpf(spec.p, spec.q, spec.taps)  # trace-time const

    state_specs = state_partition_specs()
    result_specs = eng.RxResult(*([P("time", "chan")] * 5))

    def body(state_sh: eng.TrxState, samples: Array, fn0: Array,
             prev_soft: Array | None = None,
             prev_valid: Array | None = None):
        # drop the leading per-shard axis (size 1 locally)
        state = jax.tree.map(lambda x: x[0], state_sh)
        state0 = state
        # 1. halo exchange + blockwise resample to symbol rate (sp axis)
        h = spec.halo_in
        if collectives:
            x = exchange_halo(samples, h, h, "time")
        else:  # benchmark isolation only: zero halos, WRONG at edges
            x = jnp.pad(samples,
                        [(0, 0)] * (samples.ndim - 1) + [(h, h)])
        sym = resample_block(x, spec.p, spec.q, lpf, h, spec.block_in)
        # 2. advance the engine over this shard's frames (dp over chan)
        t_idx = lax.axis_index("time")
        fn_start = fn0 + t_idx * spec.frames_per_shard
        state = state._replace(fn=(fn_start).astype(jnp.int32))

        # EXACT per-frame semantics in every mode
        from openbts_ttsou_tpu.models.transceiver import (
            process_block_exact,
        )

        state, results = process_block_exact(
            cfg_local, spec.frames_per_shard, state, sym)
        # 4. cross-time-shard state carry: merge the adaptive state so
        # every shard starts the next step from the stream-end state
        if carry_state and collectives:
            state = _merge_time_shards(
                state0, state, fn0, n_time * spec.frames_per_shard)
        # 5. clock plane: agree on total samples consumed
        if collectives:
            clock = lax.psum(
                jnp.asarray(samples.shape[-1], jnp.int32) *
                jnp.ones((), jnp.int32), ("time", "chan")) // n_chan_dev
        else:
            clock = jnp.asarray(samples.shape[-1] * n_time, jnp.int32)
        if mode == "decoded":
            # 5. STREAMING on-device FEC per shard (decode_block with
            # the soft-bit prelude): FEC groups spanning shard
            # boundaries decode too. Shard t's prelude is shard t−1's
            # soft-bit tail — one neighbor ppermute hop along the time
            # ring — and shard 0's is the PREVIOUS STEP's final tail
            # (the carried `prev_soft`), so the carry genuinely crosses
            # both shard and step boundaries (the reference's
            # persistent per-burst mI[] semantics, GSML1FEC.cpp:
            # 572-630, 1031-1100, restored on the sharded path).
            from openbts_ttsou_tpu.models.transceiver import (
                DECODE_PRELUDE,
                decode_block,
            )

            tail = results.soft_bits[-DECODE_PRELUDE:]
            if collectives and n_time > 1:
                shifted = lax.ppermute(
                    tail, "time",
                    [(i, i + 1) for i in range(n_time - 1)])
            else:
                shifted = jnp.zeros_like(tail)
            prelude = jnp.where(t_idx == 0, prev_soft[0], shifted)
            pvalid = jnp.where(t_idx == 0, prev_valid, True)
            # static slot split (decode_block docstring): each FEC
            # chain runs only on its configured TNs; RACH follows
            # cfg.rach_slots
            dec = decode_block(results, fn_start,
                               spec.frames_per_shard,
                               prev_soft=prelude, prev_valid=pvalid,
                               xcch_tns=xcch_tns, tch_tns=tch_tns,
                               rach_tns=cfg_local.rach_slots)
            dec = dec._replace(first_fn=dec.first_fn[None])
            return (jax.tree.map(lambda x: x[None], state), results,
                    clock, dec)
        return (jax.tree.map(lambda x: x[None], state), results, clock)

    out_specs = (state_specs, result_specs, P())
    in_specs = (state_specs, P("chan", "time"), P())
    if mode == "decoded":
        from openbts_ttsou_tpu.models.transceiver import DecodedBlocks

        # prev_soft carries a leading [1] axis replicated over time so
        # each shard can address it uniformly; chan stays sharded
        in_specs = in_specs + (P(None, None, "chan"), P())
        out_specs = out_specs + (DecodedBlocks(
            bits=P("time", "chan"), ok=P("time", "chan"),
            first_fn=P("time"), rach_ra=P("time", "chan"),
            rach_ok=P("time", "chan"),
            tch_speech=P("time", "chan"), tch_good=P("time", "chan"),
            facch_bits=P("time", "chan"), facch_ok=P("time", "chan"),
            tch_stolen=P("time", "chan"), tch_end_fn=P("time"),
            tch_valid=P("time")),)
    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(mapped)


def sharded_duplex_pipeline(mesh: jax.sharding.Mesh, cfg: eng.TrxConfig,
                            spec: ShardedPipelineSpec,
                            mode: str = "exact",
                            carry_state: bool = True,
                            collectives: bool = True):
    """Full-duplex sharded step: the uplink pipeline of
    `sharded_uplink_pipeline` PLUS a time-sharded downlink leg — each
    time shard modulates its own frames and 96/65-resamples them to
    device rate with symbol halos exchanged over the ring (the tx
    overlap-save that the reference's sendHistory carries between
    chunks, Transceiver/radioInterface.cpp:123-186).

    Returns ``step(state_sh, ul_samples, dl_bits, dl_valid, dl_atten,
    fn0) -> (state_sh, rx_result, tx_samples, clock)`` with:
      ul_samples: [C_total, T·block_in] P('chan', 'time');
      dl_bits:    [F_total, C_total, 8, 148] P('time', 'chan') — the tx
                  window covers the same frames as the rx window;
      tx_samples: [C_total, T·block_in] P('chan', 'time') device-rate
                  downlink, bit-identical to a serial full-stream
                  modulate+resample.
    """
    n_time = mesh.shape["time"]
    n_chan_dev = mesh.shape["chan"]
    assert spec.n_chan_total % n_chan_dev == 0
    c_local = spec.n_chan_total // n_chan_dev
    cfg_local = cfg._replace(n_chan=c_local)
    lpf = fir.resampler_lpf(spec.p, spec.q, spec.taps)

    state_specs = state_partition_specs()
    result_specs = eng.RxResult(*([P("time", "chan")] * 5))

    def body(state_sh: eng.TrxState, samples: Array, dl_bits: Array,
             dl_valid: Array, dl_atten: Array, fn0: Array):
        state = jax.tree.map(lambda x: x[0], state_sh)
        state0 = state
        t_idx = lax.axis_index("time")
        fn_start = (fn0 + t_idx * spec.frames_per_shard).astype(jnp.int32)

        # ---- downlink leg (tx halo ring) ------------------------------
        tx = _downlink_shard(cfg_local, spec, state0, dl_bits, dl_valid,
                             dl_atten, fn_start, collectives)

        # ---- uplink leg (identical to sharded_uplink_pipeline) --------
        h = spec.halo_in
        if collectives:
            x = exchange_halo(samples, h, h, "time")
        else:
            x = jnp.pad(samples,
                        [(0, 0)] * (samples.ndim - 1) + [(h, h)])
        sym = resample_block(x, spec.p, spec.q, lpf, h, spec.block_in)
        state = state._replace(fn=fn_start)
        from openbts_ttsou_tpu.models.transceiver import (
            process_block_exact,
        )

        state, results = process_block_exact(
            cfg_local, spec.frames_per_shard, state, sym)
        if carry_state and collectives:
            state = _merge_time_shards(
                state0, state, fn0, n_time * spec.frames_per_shard)
        if collectives:
            clock = lax.psum(
                jnp.asarray(samples.shape[-1], jnp.int32) *
                jnp.ones((), jnp.int32), ("time", "chan")) // n_chan_dev
        else:
            clock = jnp.asarray(samples.shape[-1] * n_time, jnp.int32)
        return (jax.tree.map(lambda x: x[None], state), results, tx,
                clock)

    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(state_specs, P("chan", "time"), P("time", "chan"),
                  P("time", "chan"), P("time", "chan"), P()),
        out_specs=(state_specs, result_specs, P("chan", "time"), P()),
        check_vma=False,
    )
    return jax.jit(mapped)
