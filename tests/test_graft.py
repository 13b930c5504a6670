"""Guard the graft contract: entry() compiles and runs; the multichip
dry run executes on the virtual CPU mesh."""

import importlib.util
import os

import jax
import pytest


def _load():
    path = os.path.join(os.path.dirname(__file__), "..",
                        "__graft_entry__.py")
    spec = importlib.util.spec_from_file_location("graft", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_compiles_and_runs():
    mod = _load()
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    state, res = out
    assert res.soft_bits.shape == (4, 8, 148)


def test_dryrun_multichip_8():
    mod = _load()
    mod.dryrun_multichip(8)


def test_dryrun_multichip_2():
    mod = _load()
    mod.dryrun_multichip(2)


# Optimized HLO in the form the GPU compiler emits: asynchronous
# collectives as *-start/*-done pairs whose start returns a tuple.
GPU_HLO = """
ENTRY %main (p0: c64[2,1000]) -> c64[2,1000] {
  %all-gather-start = (f32[2,8]{1,0}, f32[4,8]{1,0}) all-gather-start(f32[2,8]{1,0} %p1), channel_id=1, replica_groups=[2,2]<=[4], dimensions={0}, use_global_device_ids=true
  %all-gather-done = f32[4,8]{1,0} all-gather-done((f32[2,8]{1,0}, f32[4,8]{1,0}) %all-gather-start)
  %collective-permute-start = (c64[2,96]{1,0}, c64[2,96]{1,0}, u32[], u32[]) collective-permute-start(c64[2,96]{1,0} %slice.1), channel_id=2, source_target_pairs={{0,1},{1,0}}
  %collective-permute-done = c64[2,96]{1,0} collective-permute-done((c64[2,96]{1,0}, c64[2,96]{1,0}, u32[], u32[]) %collective-permute-start)
  %collective-permute-start.1 = (c64[2,96]{1,0}, c64[2,96]{1,0}) collective-permute-start(c64[2,96]{1,0} %slice.2), channel_id=3, source_target_pairs={{1,0},{0,1}}
  %collective-permute-done.1 = c64[2,96]{1,0} collective-permute-done((c64[2,96]{1,0}, c64[2,96]{1,0}) %collective-permute-start.1)
  %all-reduce-start = (f32[2]{0}, s32[]) all-reduce-start(f32[2]{0} %a, s32[] %b), channel_id=4, replica_groups={{0,1},{2,3}}, to_apply=%add
  %all-reduce-done = (f32[2]{0}, s32[]) all-reduce-done((f32[2]{0}, s32[]) %all-reduce-start)
  %all-reduce = s32[] all-reduce(s32[] %c), channel_id=5, replica_groups={{0,2},{1,3}}, to_apply=%add.1
  ROOT %fusion = c64[2,1000]{1,0} fusion(c64[2,96]{1,0} %collective-permute-done, c64[2,96]{1,0} %collective-permute-done.1), kind=kLoop, calls=%fused
}
"""


def test_collective_inventory_counts_async_pairs_once():
    ci_path = os.path.join(os.path.dirname(__file__), "..", "tools",
                           "collective_inventory.py")
    spec = importlib.util.spec_from_file_location("_ci", ci_path)
    ci = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ci)
    assert ci.inventory_text(GPU_HLO) == {
        "all-gather": {"count": 1, "bytes_per_step": 4 * 8 * 4},
        "all-reduce": {"count": 2, "bytes_per_step": 2 * 4 + 4 + 4},
        "collective-permute": {"count": 2,
                               "bytes_per_step": 2 * 2 * 96 * 8},
    }
