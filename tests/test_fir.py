import numpy as np
import pytest

import reference_dsp as ref
from openbts_ttsou_tpu.ops import fir

RNG = np.random.default_rng(0)


def _rand_complex(*shape):
    return (RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)).astype(
        np.complex64
    )


@pytest.mark.parametrize("mode", ["full", "overlap", "start", "with_tail", "no_delay"])
@pytest.mark.parametrize("la,lb", [(40, 7), (40, 8), (7, 40), (30, 21)])
def test_convolve_modes_match_reference(mode, la, lb):
    a = _rand_complex(la)
    b = _rand_complex(lb)
    got = np.asarray(fir.convolve(a[None], b, mode))[0]
    want = ref.convolve_mode(a.astype(np.complex128), b.astype(np.complex128), mode)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_convolve_custom_span():
    a, b = _rand_complex(50), _rand_complex(9)
    got = np.asarray(fir.convolve(a[None], b, fir.CUSTOM, start=13, length=11))[0]
    want = ref.convolve_mode(
        a.astype(np.complex128), b.astype(np.complex128), "custom", 13, 11
    )
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_convolve_batched_shared_filter():
    a = _rand_complex(5, 64)
    b = _rand_complex(9)
    got = np.asarray(fir.convolve(a, b, "full"))
    for i in range(5):
        want = np.convolve(a[i].astype(np.complex128), b.astype(np.complex128))
        np.testing.assert_allclose(got[i], want, rtol=2e-4, atol=2e-4)


def test_convolve_per_batch_filters():
    a = _rand_complex(4, 32)
    b = _rand_complex(4, 9)
    got = np.asarray(fir.convolve(a, b, "full"))
    for i in range(4):
        want = np.convolve(a[i].astype(np.complex128), b[i].astype(np.complex128))
        np.testing.assert_allclose(got[i], want, rtol=2e-4, atol=2e-4)


def test_correlate_is_reversed_conjugate_convolution():
    a, b = _rand_complex(40), _rand_complex(8)
    got = np.asarray(fir.correlate(a[None], b, "no_delay"))[0]
    want = ref.convolve_mode(
        a.astype(np.complex128), np.conj(b[::-1]).astype(np.complex128), "no_delay"
    )
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_design_lpf_dc_gain():
    taps = fir.design_lpf(1.0 / 96, 651, dc_gain=96.0)
    assert taps.shape == (651,)
    np.testing.assert_allclose(taps.sum(), 96.0, rtol=1e-4)


@pytest.mark.parametrize("p,q,taps", [(96, 65, 651), (65, 96, 961), (3, 2, 31), (2, 3, 25)])
def test_polyphase_resample_matches_reference(p, q, taps):
    lpf = fir.resampler_lpf(p, q, taps).astype(np.float64)
    x = _rand_complex(200)
    got = np.asarray(fir.polyphase_resample(x[None], p, q, lpf))[0]
    want = ref.polyphase_resample(x.astype(np.complex128), p, q, lpf)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


def test_polyphase_round_trip_preserves_burst():
    # 65/96 up then 96/65 down (the 64M radio path, radioInterface.cpp:123-260)
    sps = 1
    from openbts_ttsou_tpu.ops import gmsk

    bits = RNG.integers(0, 2, 148)
    burst = np.asarray(gmsk.modulate_burst(bits[None], sps))[0]
    up = fir.polyphase_resample(burst[None], 96, 65, fir.resampler_lpf(96, 65, 651))
    down = np.asarray(
        fir.polyphase_resample(up, 65, 96, fir.resampler_lpf(65, 96, 961))
    )[0]
    assert len(down) == int(np.ceil(np.ceil(148 * 96 / 65) * 65 / 96))
    # Demod the round-tripped burst: soft bits must recover the data.
    soft = np.asarray(gmsk.demodulate_burst(down[None, :148], sps, 1.0 + 0j, 0.0))[0]
    ber = np.mean((soft > 0.5).astype(int) != bits)
    assert ber < 0.01, f"round-trip BER {ber}"


def test_einsum_conv_backend_equivalence():
    """The window-contraction form (banded product for burst-length
    shared filters, strided windows × filter bank for the resampler)
    must match the direct convolutions: numpy's full convolution and
    the zero-stuffed dilated `lax.conv_general_dilated` resampler."""
    a = _rand_complex(3, 80)
    b_shared = _rand_complex(21)
    x = _rand_complex(2, 24000)
    lpf = fir.resampler_lpf(65, 96, 961)

    ref_conv = np.stack([np.convolve(a[i].astype(np.complex128),
                                     b_shared.astype(np.complex128))
                         for i in range(3)])
    ref_poly = np.asarray(fir.polyphase_resample(x, 65, 96, lpf,
                                                 method="dilated"))
    got_conv = np.asarray(fir.convolve(a, b_shared, "full"))
    got_poly = np.asarray(fir.polyphase_resample(x, 65, 96, lpf))
    np.testing.assert_allclose(got_conv, ref_conv, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_poly, ref_poly, rtol=2e-4,
                               atol=2e-4 * np.abs(ref_poly).max())


@pytest.mark.parametrize("rows", [8, 64])
@pytest.mark.parametrize("p,q,taps", [(65, 96, 961), (96, 65, 651)])
def test_small_batch_resampler_matches_dilated(rows, p, q, taps):
    """The polyphase resampler at the small row counts of a real site
    (8 carriers, or 8 carriers × 8 slots) against the direct
    zero-stuffed dilated convolution."""
    x = _rand_complex(rows, 650)
    lpf = fir.resampler_lpf(p, q, taps)
    got = np.asarray(fir.polyphase_resample(x, p, q, lpf))
    want = np.asarray(fir.polyphase_resample(x, p, q, lpf,
                                             method="dilated"))
    assert got.shape == want.shape == (rows, -(-650 * p // q))
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())
