#!/usr/bin/env python
"""Compiled-HLO collective inventory for the sharded pipelines.

`inventory(compiled)` walks a compiled program's optimized HLO for every
collective op (collective-permute, all-gather, all-reduce,
reduce-scatter, all-to-all) and reports the op count and exact bytes
landing on each device per step — the compiler's own numbers behind
SCALING.md's "what moves between devices per step" table. The GPU
lowers collectives as asynchronous `*-start`/`*-done` pairs whose start
returns a tuple of buffers; each pair counts once, by the shape of its
`-done` result.

Run as a script, it compiles the sharded uplink and duplex steps on a
virtual 8-device CPU mesh and prints their inventories:

    python tools/collective_inventory.py
"""

import collections
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DTYPE_BYTES = {"f32": 4, "f64": 8, "c64": 8, "c128": 16, "s32": 4,
               "u32": 4, "s64": 8, "u8": 1, "s8": 1, "pred": 1,
               "bf16": 2, "f16": 2, "s16": 2, "u16": 2, "u64": 8}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def shape_bytes(shape_str: str) -> int:
    """Total bytes of an HLO shape string (handles tuples)."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        if dt not in DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


COLLECTIVES = ("collective-permute", "all-gather", "all-reduce",
               "reduce-scatter", "all-to-all")


_INSTR_RE = re.compile(r"(?:ROOT )?%?\S+ = (.*?) ([\w-]+)\(")


def inventory_text(hlo: str) -> dict:
    """Collective ops in optimized HLO text → {op: {"count",
    "bytes_per_step"}}, bytes being each op's RESULT shape (what lands
    on each device). An async pair is counted at its `-done`."""
    out: dict = collections.defaultdict(lambda: [0, 0])
    for line in hlo.splitlines():
        m = _INSTR_RE.match(line.strip())
        if not m:
            continue
        shape_str, op = m.groups()
        if op.endswith("-start"):
            continue
        key = op.removesuffix("-done")
        if key in COLLECTIVES:
            out[key][0] += 1
            out[key][1] += shape_bytes(shape_str)
    return {k: {"count": v[0], "bytes_per_step": v[1]}
            for k, v in sorted(out.items())}


def inventory(compiled) -> dict:
    """`inventory_text` of a `jax.stages.Compiled` program."""
    return inventory_text(compiled.as_text())


def main():
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")

    import jax

    jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from openbts_ttsou_tpu.parallel import (
        make_mesh,
        sharded_duplex_pipeline,
        sharded_uplink_pipeline,
    )
    from openbts_ttsou_tpu.parallel.sharded import (
        ShardedPipelineSpec,
        state_for_shards,
    )
    from openbts_ttsou_tpu.trx import ChanType, TrxConfig, init_state

    mesh = make_mesh(8)
    n_time = mesh.shape["time"]
    n_chan = 2 * mesh.shape["chan"]
    cfg = TrxConfig(n_chan=n_chan)
    spec = ShardedPipelineSpec(n_chan_total=n_chan, frames_per_shard=13)
    chan_type = np.full((n_chan, 8), ChanType.I, np.int32)
    state = init_state(cfg)._replace(chan_type=jnp.asarray(chan_type))
    state_sh = state_for_shards(state, n_time)
    samples = jnp.zeros((n_chan, n_time * spec.block_in), jnp.complex64)
    fn0 = jnp.asarray(0, jnp.int32)

    results = {"mesh": dict(mesh.shape),
               "n_chan_total": n_chan,
               "frames_per_step": n_time * spec.frames_per_shard}

    up = sharded_uplink_pipeline(mesh, cfg, spec)
    comp = up.lower(state_sh, samples, fn0).compile()
    results["uplink"] = inventory(comp)

    frames_total = n_time * spec.frames_per_shard
    bits = jnp.zeros((frames_total, n_chan, 8, 148), jnp.uint8)
    valid = jnp.ones((frames_total, n_chan, 8), bool)
    att = jnp.zeros((frames_total, n_chan, 8), jnp.float32)
    dup = sharded_duplex_pipeline(mesh, cfg, spec)
    comp2 = dup.lower(state_sh, samples, bits, valid, att, fn0).compile()
    results["duplex"] = inventory(comp2)

    # context: per-shard input volume for the same step
    results["local_input_bytes_per_step"] = (
        spec.block_in * 8 * (n_chan // mesh.shape["chan"]))
    print(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
