"""The port's monogenic ops (xmipp3_tpu_torch.ops.monogenic) against the
reference package's ops/monogenic.py on the same numpy-seeded volumes at
32-48^3, on the CPU.

Tolerances: amplitudes and band-passed maps 1e-5 of the max; phase
congruency's energy 1e-4 of the max, its phase and orientation 1e-3 rad
where the Riesz part is above 1e-3 of its max; MonoRes maps equal on
>= 99.9 % of the masked voxels and never more than one band apart (a voxel
whose amplitude ties the threshold to roundoff may move by one band),
resolved fractions within 1e-3; FSO curves equal; the 3DFSC 1e-6 and its
filtered map 1e-5 of the max; local filtering 1e-4 of the max;
percentiles to 1e-12 relative of numpy's.
"""
import numpy as np
import pytest
import torch

from test_torch_common import rel_err
from xmipp3_tpu.ops import monogenic as jmono
from xmipp3_tpu_torch.ops import monogenic as tmono

torch.set_num_threads(1)
CPU = "cpu"


def blob_volume(n, seed, sigma_noise=0.3, blur=None):
    """Gaussian blobs inside a sphere of radius n/3 plus white noise."""
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[:n, :n, :n].astype(np.float32) - n // 2
    vol = np.zeros((n, n, n), np.float32)
    for _ in range(8):
        c = rng.uniform(-n / 5, n / 5, 3)
        s = rng.uniform(1.0, 2.5)
        vol += np.exp(-((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2)
                      / (2 * s * s)).astype(np.float32)
    if blur is not None:
        f = np.sqrt(sum(g ** 2 for g in np.meshgrid(
            np.fft.fftfreq(n), np.fft.fftfreq(n), np.fft.rfftfreq(n),
            indexing="ij")))
        vol = np.fft.irfftn(np.fft.rfftn(vol) * (f <= blur), s=vol.shape,
                        axes=(0, 1, 2))
    return (vol + sigma_noise * rng.standard_normal(vol.shape)).astype(
        np.float32)


def sphere(n, radius):
    z, y, x = np.mgrid[:n, :n, :n] - n // 2
    return (z * z + y * y + x * x) <= radius * radius


def test_monogenic_amplitude_matches():
    vol = blob_volume(32, 0)
    got = tmono.monogenic_amplitude_3d(vol, device=CPU)
    assert rel_err(got, np.asarray(jmono.monogenic_amplitude_3d(vol))) \
        <= 1e-5
    assert rel_err(tmono.monogenic_amplitude_3d(vol[:, :, :30], device=CPU),
                   np.asarray(jmono.monogenic_amplitude_3d(vol[:, :, :30]))) \
        <= 1e-5


def test_phase_cong_mono_on_a_synthetic_image():
    rng = np.random.default_rng(5)
    y, x = np.mgrid[:96, :80].astype(np.float32)
    im = (np.sin(x / 3.0) + (np.hypot(y - 40, x - 30) < 15)
          + 0.2 * rng.standard_normal(y.shape)).astype(np.float32)
    got = [t.numpy() for t in tmono.phase_cong_mono(im, 3, 6.0, 1.6,
                                                    0.55, device=CPU)]
    want = [np.asarray(a) for a in jmono.phase_cong_mono(im, 3, 6.0, 1.6,
                                                         0.55)]
    assert rel_err(got[2], want[2]) <= 1e-4
    h = want[2] ** 2 - (want[2] - 1e-4) ** 2 * np.sin(want[0]) ** 2
    live = h > 1e-3 * h.max()
    for g, w in zip(got[:2], want[:2]):
        d = np.angle(np.exp(1j * (g - w)))
        assert np.abs(d[live]).max() <= 1e-3


def test_bandpass_matches():
    vol = blob_volume(32, 1)
    for w1, w2 in ((0.0, 0.2), (0.1, 0.35)):
        assert rel_err(tmono.bandpass_3d(vol, w1, w2, device=CPU),
                       np.asarray(jmono.bandpass_3d(vol, w1, w2))) <= 1e-5


def test_percentile_matches_numpy():
    rng = np.random.default_rng(0)
    for n in (1, 2, 81, 1000, 4097):
        x = (rng.standard_normal(n) * 30).astype(np.float32)
        for qs in ([5, 17, 83, 95], [2, 98], [95.0], [0, 100]):
            got = tmono.percentile_linear(torch.as_tensor(x), qs).numpy()
            want = np.percentile(x, qs)
            assert np.allclose(got, want, rtol=1e-12, atol=0), (n, qs)


def _bands(res, min_res, freqs, Ts):
    table = np.concatenate([[min_res], Ts / freqs]).astype(np.float32)
    return np.abs(res[..., None] - table).argmin(axis=-1)


def hold_maps(got, want, mask, min_res, freqs, Ts):
    got, want = np.asarray(got), np.asarray(want)
    equal = float(np.isclose(got[mask], want[mask], rtol=1e-6).mean())
    bands = np.abs(_bands(got[mask], min_res, freqs, Ts)
                   - _bands(want[mask], min_res, freqs, Ts))
    assert equal >= 0.999, equal
    assert bands.max() <= 1


MONORES_CASES = {
    "default": dict(),
    "halves": dict(noise_vol=True),
    "halves_in_mask": dict(noise_vol=True, noise_only_in_halves=True),
    "gaussian": dict(gaussian=True, n_freqs=12),
    "excl_step": dict(mask_excl=True, step=1.0, min_res=12.0, max_res=3.0),
    "significance": dict(significance=0.99, noise_vol=True, n_freqs=8),
}


@pytest.mark.parametrize("case", sorted(MONORES_CASES))
def test_local_resolution_monores_matches(case):
    kw = dict(MONORES_CASES[case])
    n, Ts = 40, 1.5
    v1 = blob_volume(n, 3, blur=0.3)
    v2 = blob_volume(n, 3, blur=0.3) + 0.3 * np.random.default_rng(9) \
        .standard_normal((n, n, n)).astype(np.float32)
    mask = sphere(n, n // 3)
    if kw.pop("noise_vol", False):
        kw["noise_vol"] = 0.5 * (v1 - v2)
    if kw.pop("mask_excl", False):
        kw["mask_excl"] = sphere(n, n // 2 - 2) & ~sphere(n, n // 2 - 5)
    vol = 0.5 * (v1 + v2)
    want, freqs, frac = jmono.local_resolution_monores(vol, mask, Ts, **kw)
    got, gfreqs, gfrac = tmono.local_resolution_monores(vol, mask, Ts,
                                                        device=CPU, **kw)
    assert np.array_equal(gfreqs, freqs)
    min_res = kw.get("min_res", n * Ts / 3)
    hold_maps(got, want, mask, min_res, freqs, Ts)
    assert np.abs(gfrac - np.asarray(frac)).max() <= 1e-3
    assert got.dtype == torch.float32 and got.shape == vol.shape


@pytest.mark.parametrize("cone,threshold", [(20.0, 0.143), (30.0, 0.5)])
def test_fso_matches(cone, threshold):
    n = 32
    a = blob_volume(n, 4, sigma_noise=0.0)
    rng = np.random.default_rng(6)
    v1 = a + 0.2 * rng.standard_normal(a.shape).astype(np.float32)
    v2 = a + 0.2 * rng.standard_normal(a.shape).astype(np.float32)
    freqs, fso = tmono.fso_directional(v1, v2, 1.0, cone_deg=cone,
                                       threshold=threshold, device=CPU)
    wf, wfso = jmono.fso_directional(v1, v2, 1.0, cone_deg=cone,
                                     threshold=threshold)
    assert np.array_equal(freqs, wf)
    assert np.array_equal(fso, wfso)
    out = tmono.fso_directional(v1, v2, 1.0, cone_deg=cone,
                                threshold=threshold, compute_3dfsc=True,
                                device=CPU)
    ref = jmono.fso_directional(v1, v2, 1.0, cone_deg=cone,
                                threshold=threshold, compute_3dfsc=True)
    assert np.array_equal(out[1], ref[1])
    assert np.abs(out[2].numpy() - ref[2]).max() <= 1e-6
    assert rel_err(out[3], ref[3]) <= 1e-5


def test_local_filter_by_resolution_matches():
    n, Ts = 32, 1.0
    vol = blob_volume(n, 7)
    rng = np.random.default_rng(8)
    res = rng.uniform(2.5, 9.0, (n, n, n)).astype(np.float32)
    for bands in (12, 5):
        got = tmono.local_filter_by_resolution(vol, res, Ts, bands,
                                               device=CPU)
        want = jmono.local_filter_by_resolution(vol, res, Ts, bands)
        assert rel_err(got, want) <= 1e-4
