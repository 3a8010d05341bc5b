"""--useCTF gridding in the port against the reference on the CPU (N=32,
P=64, phantom particles), and the correction pinned against a planted CTF.

The reference's CPU paths (its tap expansion, reconstruct.py:238-274) put
the image weight alone into the weights cube and drop the CTF modulator
that its TPU kernels and the C++ reference apply (ROADMAP.md §3 logs this
fault). The port applies the modulator on every path. So:
- the factor table (ctf_gridding_multipliers) is held to the reference's
  with the threshold rule of test_torch_ctf.py;
- whole volumes are held to the reference's gridding of the same table:
  the data cubes from its backproject_chunk with (ctf_data, ctf_w), the
  weights cube from its backproject_chunk of centred delta images (whose
  kept spectrum is 1) with the modulator as the data factor, then its
  finalize_volume. nn and tri to 1e-4 * max, kb to 5e-3 (K3's window
  polynomial against the exact Bessel window);
- the programs are held to the reference's programs where the fault cannot
  show: CTFs with |c| >= --minCTF at every kept sample, so that the
  modulator is 1 (nn, 1e-4; inline labels and ctfModel files).
Where the modulator is not 1, 1/c amplifies the two packages' CTF roundoff
(a few 1e-6) by up to 1/minCTF^2, and the table, not the volume, is where
the packages are compared.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_common import phantom_batch, rel_err
from xmipp3_tpu.ops import reconstruct as jrec
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu_torch.core.geometry import euler_matrix
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.sym import SymList
from xmipp3_tpu_torch.ops import reconstruct as trec
from xmipp3_tpu_torch.ops.ctf import (CTFDescription, ctf_params_arrays)
from xmipp3_tpu_torch.programs import get_program

torch.set_num_threads(1)

N, C, TS = 32, 16, 2.0
TOL = {"tri": 1e-4, "nn": 1e-4, "kb": 5e-3}


def _descs(count=C, gentle=False):
    """Realistic CTFs at 2 A/px (8,000-20,000 A of defocus, 300 A of
    astigmatism, zeros in the band); `gentle` ones (Q0 0.7, 1,500-2,500 A
    at 4 A/px) keep |c| >= 0.4 at every sample."""
    if gentle:
        return [CTFDescription(sampling_rate=4.0, voltage=300, Cs=2.7,
                               Q0=0.7, defocusU=1500 + 1000 * k / count,
                               defocusV=1600 + 1000 * k / count,
                               azimuthal_angle=11.0 * k) for k in range(count)]
    return [CTFDescription(sampling_rate=TS, voltage=300, Cs=2.7, Q0=0.1,
                           defocusU=8000 + 12000 * k / count,
                           defocusV=8300 + 12000 * k / count,
                           azimuthal_angle=180.0 * k / count)
            for k in range(count)]


@pytest.mark.parametrize("phase_flipped", [False, True])
@pytest.mark.parametrize("min_ctf", [0.01, 0.2])
def test_ctf_gridding_multipliers_match_reference(min_ctf, phase_flipped):
    """The threshold rule of test_torch_ctf.py: away from ||c| - minCTF|
    <= 1e-5 no sample takes the other branch, the data factors agree to
    1e-3 relative (1/c) or exactly (sgn c), the weight factors to 2e-5."""
    from xmipp3_tpu.ops.ctf import ctf_pure_batched as jpure
    p = ctf_params_arrays(_descs())
    dj, wj = (np.asarray(a) for a in jrec.ctf_gridding_multipliers(
        p, TS, min_ctf, N, 0.5, phase_flipped))
    dt, wt = (a.numpy() for a in trec.ctf_gridding_multipliers(
        p, TS, min_ctf, N, 0.5, phase_flipped, device="cpu"))
    FX, FY = (a.numpy() / np.float32(TS) for a in
              trec._kept_freqs(N, 0.5, torch.device("cpu")))
    c = np.asarray(jpure(FX, FY, p))
    assert dt.shape == dj.shape == c.shape == (
        C, int(jrec._disk_mask(N, 0.5).sum()))
    away = np.abs(np.abs(c) - min_ctf) > 1e-5
    above = away & (np.abs(c) >= min_ctf)
    assert int(((wt < 1) != (wj < 1))[away].sum()) == 0
    assert (np.abs(dt - dj)[above] <= 1e-3 * np.abs(dj)[above]).all()
    np.testing.assert_array_equal(dt[away & ~above], dj[away & ~above])
    np.testing.assert_allclose(wt[away], wj[away], rtol=0, atol=2e-5)
    assert above.sum() > 0 and (away & ~above).sum() > 0


def _reference_volume(b, table, interp, sym="c1"):
    """The reference's gridding of the port's CTF table (see the module
    docstring), finalized by the reference."""
    f = b["flip"]
    imgs = np.where(f[:, None, None], b["imgs"][:, :, ::-1], b["imgs"])
    sx = np.where(f, -b["sx"], b["sx"]).astype(np.float32)
    delta = np.zeros_like(imgs)
    delta[:, N // 2, N // 2] = 1.0
    z = np.zeros(len(imgs), np.float32)
    A = np.asarray(euler_matrix(b["rot"], b["tilt"], b["psi"]), np.float32)
    P = 2 * N
    cd, cw = (a.numpy() for a in table)
    zero = lambda: jnp.zeros((P, P, P), jnp.float32)
    dr, di, dw = zero(), zero(), zero()
    for S in SymList(sym).sym_matrices():
        m = np.einsum("cij,jk->cik", A, S.astype(np.float32))
        dr, di, _ = jrec.backproject_chunk(
            dr, di, zero(), imgs, m, sx, b["sy"], b["w"], P, 0.5,
            interp=interp, ctf_data=cd, ctf_w=cw)
        dw, _, _ = jrec.backproject_chunk(
            dw, zero(), zero(), delta, m, z, z, b["w"], P, 0.5,
            interp=interp, ctf_data=cw, ctf_w=cw)
    return np.asarray(jrec.finalize_volume(dr, di, dw, N, P, interp=interp))


@pytest.mark.parametrize("phase_flipped", [False, True])
@pytest.mark.parametrize("interp", list(TOL))
def test_ctf_volumes_match_the_reference_gridding(interp, phase_flipped):
    b = phantom_batch(31, C, N)
    p = ctf_params_arrays(_descs())
    kw = dict(sampling=TS, min_ctf=0.01, phase_flipped=phase_flipped)
    table = trec.ctf_gridding_multipliers(p, TS, 0.01, N, 0.5, phase_flipped,
                                          device="cpu")
    want = _reference_volume(b, table, interp)
    args = (b["imgs"], b["rot"], b["tilt"], b["psi"], b["sx"], b["sy"])
    got = trec.reconstruct_fourier(*args, weights=b["w"], flip=b["flip"],
                                   interp=interp, batch=8, ctfp=p,
                                   device="cpu", **kw)
    assert got.shape == (N, N, N) and torch.isfinite(got).all()
    assert rel_err(got, want) <= TOL[interp]
    # the streaming reconstructor, one batch, equals the one-call form
    rec = trec.FourierReconstructor(N, interp=interp, device="cpu", **kw)
    rec.add_batch(*args, weights=b["w"], flip=b["flip"], ctfp=p)
    assert rel_err(rec.finish(), got) <= 1e-5
    assert (rec.sampling, rec.min_ctf, rec.phase_flipped) == (
        TS, 0.01, phase_flipped)


def test_ctf_table_is_shared_by_the_symmetry_loop():
    """c4: the table is computed once per batch and grids every symmetry
    copy (the reference's gridding of the same table, four copies)."""
    b = phantom_batch(32, 8, N)
    p = ctf_params_arrays(_descs(8))
    table = trec.ctf_gridding_multipliers(p, TS, 0.01, N, 0.5, False,
                                          device="cpu")
    want = _reference_volume(b, table, "tri", sym="c4")
    got = trec.reconstruct_fourier(
        b["imgs"], b["rot"], b["tilt"], b["psi"], b["sx"], b["sy"],
        weights=b["w"], flip=b["flip"], sym="c4", interp="tri", ctfp=p,
        sampling=TS, device="cpu")
    assert rel_err(got, want) <= TOL["tri"]


# -- the program ---------------------------------------------------------------

def _ctf_views(b, descs, flip_phase=False):
    """The particles with each row's CTF applied in Fourier space (signed,
    or its absolute value for phase-flipped data), made with numpy."""
    out = np.empty_like(b["imgs"])
    for i, d in enumerate(descs):
        c = d.generate_2d(N, N, device="cpu").numpy()
        c = np.abs(c) if flip_phase else c
        out[i] = np.fft.irfft2(np.fft.rfft2(b["imgs"][i]) * c, s=(N, N))
    return out


def _write_set(d, b, descs, mode):
    """parts.mrcs + parts.xmd with inline ctf* labels ("inline"), a
    ctfModel column naming one .ctfparam per row ("model"), or no CTF
    labels ("none")."""
    stk = str(d / "parts.mrcs")
    save_image(stk, b["imgs"])
    rows = []
    for i, c in enumerate(descs):
        row = {"image": f"{i + 1}@{stk}", "angleRot": float(b["rot"][i]),
               "angleTilt": float(b["tilt"][i]),
               "anglePsi": float(b["psi"][i]), "shiftX": float(b["sx"][i]),
               "shiftY": float(b["sy"][i])}
        if mode == "inline":
            row.update({lbl: float(getattr(c, a)) for a, lbl in
                        CTFDescription._MD_MAP.items()
                        if a in ("sampling_rate", "voltage", "defocusU",
                                 "defocusV", "azimuthal_angle", "Cs", "Q0")})
        elif mode == "model":
            fn = str(d / f"m{i % 4}.ctfparam")
            descs[i % 4].write(fn)
            row["ctfModel"] = fn
        rows.append(row)
    fn = str(d / "parts.xmd")
    MetaData.fromRows(rows).write(fn)
    return fn


def _vol(path):
    return np.squeeze(Image(str(path)).data)


@pytest.mark.parametrize("mode", ["inline", "model"])
def test_cli_usectf_matches_the_reference_program(tmp_path, mode):
    b = phantom_batch(33, C, N)
    b["flip"][:] = False
    descs = _descs(gentle=True)
    if mode == "model":              # four files, row i names file i % 4
        descs = [descs[i % 4] for i in range(C)]
    b["imgs"] = _ctf_views(b, descs)
    fn = _write_set(tmp_path, b, descs, mode)
    args = ["-i", fn, "--interp", "nn", "--useCTF", "--sampling", "4",
            "--minCTF", "0.3", "--batch", "8"]
    assert get_program("reconstruct_fourier").run_with_args(
        args + ["-o", str(tmp_path / "port.vol"), "--device", "cpu"]) == 0
    assert jax_program("reconstruct_fourier").run_with_args(
        args + ["-o", str(tmp_path / "ref.vol"), "--mesh", "none"]) == 0
    port, ref = _vol(tmp_path / "port.vol"), _vol(tmp_path / "ref.vol")
    assert port.shape == (N, N, N)
    assert rel_err(port, ref) <= TOL["nn"]
    # the program is the library on the same rows
    lib = trec.reconstruct_fourier(
        b["imgs"], b["rot"], b["tilt"], b["psi"], b["sx"], b["sy"],
        interp="nn", batch=8, ctfp=ctf_params_arrays(descs), sampling=4.0,
        min_ctf=0.3, device="cpu")
    assert rel_err(port, lib) <= 1e-6


def test_cli_has_ctf_gate(tmp_path):
    """The reference's hasCTF gate: --useCTF on rows without ctfModel or
    ctfDefocusU is the plain reconstruction, and CTF labels without
    --useCTF are ignored."""
    b = phantom_batch(34, 8, N)
    fn = _write_set(tmp_path, b, _descs(8), "none")
    prog = lambda extra, out: get_program("reconstruct_fourier") \
        .run_with_args(["-i", fn, "-o", str(tmp_path / out), "--interp",
                        "nn", "--device", "cpu"] + extra)
    assert prog(["--useCTF", "--sampling", "2"], "gated.vol") == 0
    assert prog([], "plain.vol") == 0
    np.testing.assert_array_equal(_vol(tmp_path / "gated.vol"),
                                  _vol(tmp_path / "plain.vol"))
    fn = _write_set(tmp_path, b, _descs(8), "inline")
    assert prog([], "labels.vol") == 0
    np.testing.assert_array_equal(_vol(tmp_path / "labels.vol"),
                                  _vol(tmp_path / "plain.vol"))


def test_usectf_undoes_a_planted_ctf(tmp_path):
    """CTF-modulated phantom views rebuilt with --useCTF correlate better
    with the clean views' reconstruction than the same views rebuilt
    without it; with --phaseFlipped the same holds for phase-flipped
    views (|CTF| planted)."""
    b = phantom_batch(35, 48, N)
    b["flip"][:] = False
    descs = _descs(48)
    clean = trec.reconstruct_fourier(
        b["imgs"], b["rot"], b["tilt"], b["psi"], b["sx"], b["sy"],
        interp="tri", device="cpu").numpy()
    corr = lambda v: float(np.corrcoef(np.ravel(v), clean.ravel())[0, 1])
    for flipped in (False, True):
        b2 = dict(b, imgs=_ctf_views(b, descs, flip_phase=flipped))
        fn = _write_set(tmp_path, b2, descs, "inline")
        got = {}
        for use in (True, False):
            out = tmp_path / f"r{int(use)}{int(flipped)}.vol"
            extra = (["--useCTF", "--sampling", "2"]
                     + (["--phaseFlipped"] if flipped else [])) if use else []
            assert get_program("reconstruct_fourier").run_with_args(
                ["-i", fn, "-o", str(out), "--interp", "tri", "--device",
                 "cpu"] + extra) == 0
            got[use] = corr(_vol(out))
        # the correction removes at least 90 % of the planted misfit
        assert got[True] > 0.99 and 1 - got[True] < 0.1 * (1 - got[False]), \
            got
