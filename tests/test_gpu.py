"""Checks that need a GPU (marked `gpu`; they skip elsewhere).

Run on a card with

    OPENBTS_TEST_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openbts_ttsou_tpu.models.transceiver import UplinkSpec, process_block_exact
from openbts_ttsou_tpu.ops import fir

pytestmark = pytest.mark.gpu

#: soft-bit tolerance between devices or schedules: half of one 1/255
#: step of the uplink wire format (float32, Precision.HIGHEST)
SOFT_ATOL = 2e-3


def test_complex64_transfer_is_bit_exact(gpu_device):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((64, 24000, 2)) * 3e4).astype(
        np.float32).view(np.complex64)[..., 0]
    back = np.asarray(jax.device_get(jax.device_put(x, gpu_device)))
    assert back.dtype == np.complex64
    assert back.tobytes() == x.tobytes()


@pytest.mark.parametrize("p,q,taps", [(65, 96, 961), (96, 65, 651)])
def test_resampler_on_gpu_matches_cpu(gpu_device, p, q, taps):
    rng = np.random.default_rng(p)
    x = (rng.standard_normal((8, 4800))
         + 1j * rng.standard_normal((8, 4800))).astype(np.complex64)
    lpf = fir.resampler_lpf(p, q, taps)
    run = jax.jit(lambda v: fir.polyphase_resample(v, p, q, lpf))
    got = np.asarray(run(jax.device_put(x, gpu_device)))
    want = np.asarray(run(jax.device_put(x, jax.devices("cpu")[0])))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_exact_block_on_gpu_matches_cpu(gpu_device):
    """The batched exact receiver on the card against the same program
    on the CPU: identical detections and TOA, soft bits within
    SOFT_ATOL."""
    from test_exact_block import _base_state, make_stream

    from openbts_ttsou_tpu.trx import engine as eng

    cfg = eng.TrxConfig(n_chan=2, rach_slots=(0,))
    rng = np.random.default_rng(11)
    combos = np.full((2, 8), eng.ChanType.I, np.int32)
    combos[:, 0] = eng.ChanType.V
    st = _base_state(cfg)._replace(chan_type=jnp.asarray(combos))
    sym = make_stream(rng, 2, rach_frames=(1, 5, 9))
    f = UplinkSpec().frames
    run = jax.jit(lambda s, x: process_block_exact(cfg, f, s, x))
    out = []
    for dev in (gpu_device, jax.devices("cpu")[0]):
        _, res = run(jax.device_put(st, dev), jax.device_put(sym, dev))
        out.append(jax.device_get(res))
    a, b = out
    np.testing.assert_array_equal(a.detected, b.detected)
    np.testing.assert_array_equal(a.timing[a.detected],
                                  b.timing[b.detected])
    np.testing.assert_allclose(a.soft_bits, b.soft_bits, atol=SOFT_ATOL)
