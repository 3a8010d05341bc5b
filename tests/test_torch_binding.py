"""The port's binding surface (xmipp3_tpu_torch/binding/: xmippLib,
xmipp_base, the stand-ins of binding/site, the MATLAB wrappers and the
xmipp_torch entry point) against the root xmippLib / xmipp_base, the JAX
package's binding, on the CPU.

Inputs are made with numpy from seeds at N=32 and written to files that
both bindings read. The port runs with device="cpu". Tolerances, as a
share of the max of the JAX side's output:
- projections, CTF, linear filters: 1e-5;
- B-spline readApplyGeo, the enhanced PSD: 1e-4;
- Euler matrices: 1e-6 absolute;
- metadata, labels: exact;
- image_align: the aligned image's pose within 0.05 (degrees and px),
  read back by registering it onto the reference.
"""
import os
import subprocess
import sys
import tomllib

import numpy as np
import pytest
import torch

import xmippLib as J
import xmipp_base as JB
from test_torch_common import PORT, REPO, rel_err
from xmipp3_tpu_torch.binding import xmippLib as T
from xmipp3_tpu_torch.binding import xmipp_base as TB
from xmipp3_tpu_torch.core.image import save_image
from xmipp3_tpu_torch.ops.ctf import CTFDescription

torch.set_num_threads(1)
N = 32
CPU = "cpu"
SITE = PORT / "binding" / "site"


def blob_volume(seed, n=N, blobs=6):
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32) - n // 2
    vol = np.zeros((n, n, n), np.float32)
    for _ in range(blobs):
        c = rng.uniform(-n / 4, n / 4, 3)
        s = rng.uniform(1.5, 3.0)
        vol += rng.uniform(0.5, 1.2) * np.exp(
            -((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2)
            / (2 * s * s))
    return vol


def smooth_images(seed, count, h=N, w=N):
    """Random images low-passed to a quarter of Nyquist (content that a
    warp resamples without aliasing)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((count, h, w))
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    keep = np.sqrt(fy * fy + fx * fx) < 0.125
    return np.fft.irfft2(np.fft.rfft2(x) * keep, s=(h, w)).astype(np.float32)


def write_ctfs(tmp_path):
    paths = []
    for k, (u, v, az) in enumerate(((12000.0, 11500.0, 30.0),
                                    (15000.0, 14000.0, 75.0))):
        fn = str(tmp_path / f"m{k}.ctfparam")
        CTFDescription(sampling_rate=2.0, voltage=300.0, defocusU=u,
                       defocusV=v, azimuthal_angle=az, Cs=2.7,
                       Q0=0.1).write(fn)
        paths.append(fn)
    return paths


# ---------------------------------------------------------------------------
# the card half, on the CPU
# ---------------------------------------------------------------------------

ANGLES = ((0.0, 0.0, 0.0), (30.0, 60.0, 10.0), (200.0, 135.0, 290.0))


@pytest.mark.parametrize("angles", ANGLES)
def test_fourier_projector(angles):
    vol = blob_volume(0)
    want = J.FourierProjector(vol).projectVolume(*angles).getData()
    img = T.Image()
    img.setData(vol)
    got = T.FourierProjector(img, device=CPU).projectVolume(*angles)
    assert isinstance(got, T.Image)
    assert rel_err(got.getData(), want) <= 1e-5


@pytest.mark.parametrize("angles", ANGLES)
def test_project_volume_double(angles):
    vol = blob_volume(1)
    want = J.projectVolumeDouble(vol, *angles).getData()
    got = T.projectVolumeDouble(vol, *angles, device=CPU).getData()
    assert rel_err(got, want) <= 1e-5


def test_read_apply_geo(tmp_path):
    imgs = smooth_images(2, 4)
    stk = str(tmp_path / "s.mrcs")
    save_image(stk, imgs)
    rows = [{"image": f"{i + 1}@{stk}", "anglePsi": psi, "shiftX": sx,
             "shiftY": sy, "flip": flip} for i, (psi, sx, sy, flip) in
            enumerate(((0.0, 0.0, 0.0, False), (33.0, 1.5, -2.25, False),
                       (-120.0, -0.5, 3.0, True), (271.0, 2.0, 1.0, True)))]
    fn = str(tmp_path / "geo.xmd")
    T.MetaData.fromRows(rows).write(fn)
    mj, mt = J.MetaData(fn), T.MetaData(fn)
    for i, oid in enumerate(mt):
        want = J.Image().readApplyGeo(rows[i]["image"], mj, oid).getData()
        got = T.Image().readApplyGeo(rows[i]["image"], mt, oid,
                                     device=CPU).getData()
        assert rel_err(got, want) <= 1e-4, i
    # without a row it is a plain read
    plain = T.Image().readApplyGeo(rows[1]["image"]).getData()
    assert np.array_equal(plain, imgs[1])


def test_apply_ctf(tmp_path):
    ctf = write_ctfs(tmp_path)[0]
    data = smooth_images(3, 1)[0]
    for absPhase in (False, True):
        ij, it = J.Image(), T.Image()
        ij.setData(data)
        it.setData(data)
        ij.applyCTF(ctf, 2.0, absPhase)
        it.applyCTF(ctf, 2.0, absPhase, device=CPU)
        assert rel_err(it.getData(), ij.getData()) <= 1e-5
    ij, it = J.Image(), T.Image()
    ij.setData(data)
    it.setData(data)
    J.applyCTF(ij, ctf, 1.5)
    T.applyCTF(it, ctf, 1.5, device=CPU)
    assert rel_err(it.getData(), ij.getData()) <= 1e-5


def test_ctf_errors_and_psf(tmp_path):
    a, b = write_ctfs(tmp_path)
    want = J.errorBetween2CTFs(a, b, 64, 0.05, 0.3)
    got = T.errorBetween2CTFs(a, b, 64, 0.05, 0.3, device=CPU)
    assert abs(got - want) <= 1e-5 * abs(want)
    assert T.errorMaxFreqCTFs(a, 1.0) == pytest.approx(
        J.errorMaxFreqCTFs(a, 1.0), rel=1e-12)
    assert T.errorMaxFreqCTFs2D(a, b, 64, 1.0, device=CPU) == \
        pytest.approx(J.errorMaxFreqCTFs2D(a, b, 64, 1.0), rel=1e-5)
    want = J.getPSF(a, 1.0)
    assert want.shape == (512,)
    assert rel_err(T.getPSF(a, 1.0, device=CPU), want) <= 1e-5
    md = T.MetaData(b)
    assert rel_err(T.getPSF(md, 0.8, 0, device=CPU),
                   J.getPSF(J.MetaData(b), 0.8, 0)) <= 1e-5


def _pose_of(aligned, ref):
    """(psi, sx, sy) that register `aligned` onto `ref` (the port's
    aligner on the CPU): zero for a well-aligned image."""
    from xmipp3_tpu_torch.ops.align import iterative_align
    psi, sx, sy, _, _ = iterative_align(ref, aligned[None], device=CPU)
    psi = (float(psi[0]) + 180.0) % 360.0 - 180.0
    return psi, float(sx[0]), float(sy[0])


def test_image_align():
    from xmipp3_tpu_torch.ops.geo import apply_alignment_2d
    ref = smooth_images(4, 1)[0]
    for psi, sx, sy, flip in ((25.0, 2.0, -1.0, False),
                              (-60.0, -1.5, 2.5, True)):
        mov = apply_alignment_2d(ref[None], [psi], [sx], [sy], [flip],
                                 device=CPU)[0].numpy()
        want = J.image_align(ref, mov).getData()
        img = T.Image()
        img.setData(mov)
        got = T.image_align(ref, img, device=CPU).getData()
        for w, g in zip(_pose_of(want, ref), _pose_of(got, ref)):
            assert abs(w - g) <= 0.05, (psi, _pose_of(want, ref),
                                        _pose_of(got, ref))


@pytest.mark.parametrize("name,args,tol", [
    ("bandPassFilter", (0.05, 0.3, 0.02), 1e-5),
    ("gaussianFilter", (0.1,), 1e-5),
    ("realGaussianFilter", (1.5,), 1e-5),
    ("badPixelFilter", (1.5,), 1e-5)])
@pytest.mark.parametrize("dim", [0, 24])
def test_preview_filters(tmp_path, name, args, tol, dim):
    rng = np.random.default_rng(5)
    fn = str(tmp_path / "p.mrc")
    save_image(fn, rng.standard_normal((40, 48)).astype(np.float32))
    ij, it = J.Image(), T.Image()
    getattr(J, name)(ij, fn, *args, dim)
    getattr(T, name)(it, fn, *args, dim, device=CPU)
    assert it.getData().shape == ij.getData().shape
    assert rel_err(it.getData(), ij.getData()) <= tol


def test_fast_estimate_enhanced_psd(tmp_path):
    rng = np.random.default_rng(6)
    fn = str(tmp_path / "mic.mrc")
    save_image(fn, rng.standard_normal((256, 320)).astype(np.float32))
    for down, dim in ((2.0, 64), (4.0, 0)):
        ij, it = J.Image(), T.Image()
        J.fastEstimateEnhancedPSD(ij, fn, down, dim)
        T.fastEstimateEnhancedPSD(it, fn, down, dim, device=CPU)
        assert it.getData().shape == ij.getData().shape
        assert rel_err(it.getData(), ij.getData()) <= 1e-4


# ---------------------------------------------------------------------------
# the host half: the same files through both bindings
# ---------------------------------------------------------------------------

def test_label_constants_and_helpers():
    jn = {k: getattr(J, k) for k in dir(J) if k.startswith("MDL_")}
    tn = {k: getattr(T, k) for k in dir(T) if k.startswith("MDL_")}
    assert jn == tn and len(tn) > 100
    for lab in ("image", "anglePsi", "ctfModel", "micrograph", "itemId",
                "shiftX", "enabled"):
        assert T.labelType(lab) == J.labelType(lab)
        assert T.isValidLabel(lab) and T.labelIsImage(lab) == \
            J.labelIsImage(lab)
        for tag in (T.TAGLABEL_IMAGE, T.TAGLABEL_METADATA, T.TAGLABEL_PSD):
            assert T.labelHasTag(lab, tag) == J.labelHasTag(lab, tag)
        assert T.str2Label(T.label2Str(lab)) == lab
    assert not T.isValidLabel("noSuchLabel")
    assert T.colorStr(1, "x") == J.colorStr(1, "x")
    assert T.gaussian1D(0.3, 1.2, 0.1) == J.gaussian1D(0.3, 1.2, 0.1)
    assert T.activateRegExtensions() and T.activateMathExtensions() is None


def test_filename():
    for name in ("3@stack.mrcs", "block@meta.xmd", "vol.vol",
                 "000002@s.stk"):
        fj, ft = J.FileName(name), T.FileName(name)
        for m in ("getExtension", "removeBlockName", "getBlockName",
                  "isInStack", "isMetaData", "exists"):
            assert getattr(ft, m)() == getattr(fj, m)(), (name, m)
    assert T.FileName("x").compose("root", 3, "xmp") == "root000003.xmp"
    assert T.FileName("x").compose(7, "s.stk") == \
        J.FileName("x").compose(7, "s.stk")
    assert T.FileName("x").compose("b", "f.xmd") == "b@f.xmd"


def test_metadata_both_ways(tmp_path):
    rows = [{"image": f"{i + 1:06d}@s.mrcs", "anglePsi": 10.0 * i,
             "shiftX": 0.5 * i, "ref": i % 3, "enabled": 1}
            for i in range(6)]
    ft, fj = str(tmp_path / "t.xmd"), str(tmp_path / "j.xmd")
    T.MetaData.fromRows(rows).write(ft)
    J.MetaData.fromRows(rows).write(fj)
    assert open(ft).read() == open(fj).read()
    mt, mj = T.MetaData(fj), J.MetaData(ft)
    assert list(mt.df.columns) == list(mj.df.columns)
    assert mt.df.equals(mj.df)
    assert mt == T.MetaData(ft) and not (mt != T.MetaData(ft))
    oid = mt.firstObject()
    assert mt.getValue(T.MDL_ANGLE_PSI, oid) == mj.getValue(
        J.MDL_ANGLE_PSI, mj.firstObject())
    for q in ((T.MDValueEQ("ref", 1), J.MDValueEQ("ref", 1)),
              (T.MDValueGT("anglePsi", 20.0), J.MDValueGT("anglePsi", 20.0)),
              (T.MDValueRange("shiftX", 0.5, 2.0),
               J.MDValueRange("shiftX", 0.5, 2.0)),
              (T.MDValueNE("ref", 0), J.MDValueNE("ref", 0))):
        a, b = T.MetaData(), J.MetaData()
        a.importObjects(mt, q[0])
        b.importObjects(mj, q[1])
        assert a.df.equals(b.df) and a.size() > 0
    for md in (mt, mj):
        md.operate("anglePsi=2*anglePsi, shiftX=shiftX+1")
        md.fillConstant("weight", 0.5)
        md.removeLabel("enabled")
    assert mt.df.equals(mj.df)
    other = T.MetaData.fromRows([{"ref": 1, "cost": 2.0}])
    jt, jj = T.MetaData(), J.MetaData()
    jt.joinNatural(mt, other)
    jj.joinNatural(mj, J.MetaData.fromRows([{"ref": 1, "cost": 2.0}]))
    assert jt.df.equals(jj.df) and jt.size() == 2
    mt.intersection(other, "ref")
    mj.intersection(J.MetaData.fromRows([{"ref": 1, "cost": 2.0}]), "ref")
    assert mt.df.equals(mj.df)
    assert T.getBlocksInMetaDataFile(ft) == J.getBlocksInMetaDataFile(ft)
    assert T.compareTwoMetadataFiles(ft, fj)
    assert T.existsBlockInMetaDataFile(ft) and \
        not T.existsBlockInMetaDataFile(str(tmp_path / "no.xmd"))


def test_image_files_and_inspection(tmp_path):
    rng = np.random.default_rng(7)
    stk = str(tmp_path / "s.mrcs")
    data = rng.standard_normal((3, 16, 20)).astype(np.float32)
    save_image(stk, data)
    fn = str(tmp_path / "s.xmd")
    T.MetaData.fromRows({"image": f"{i + 1}@{stk}"} for i in range(3)) \
        .write(fn)
    assert T.getImageSize(stk) == J.getImageSize(stk) == (20, 16, 1, 3)
    assert T.MetaDataInfo(fn) == J.MetaDataInfo(fn)
    assert T.MetaDataInfo(T.MetaData(fn)) == J.MetaDataInfo(J.MetaData(fn))
    it, ij = T.Image(f"2@{stk}"), J.Image(f"2@{stk}")
    assert np.array_equal(it.getData(), ij.getData())
    assert it.getDimensions() == ij.getDimensions()
    assert it.computeStats() == ij.computeStats()
    assert it.getPixel(3, 4) == ij.getPixel(3, 4)
    assert it.equal(ij.getData()) and it.equal(T.Image(f"2@{stk}"))
    one = str(tmp_path / "one.mrc")
    it.write(one)
    assert T.ImgCompare(one, one) and T.compareTwoImageTolerance(one, one)
    assert T.compareTwoFiles(one, one) == J.compareTwoFiles(one, one)
    assert T.checkImageFileSize(stk) == J.checkImageFileSize(stk) is True
    assert T.checkImageCorners(one) == J.checkImageCorners(one)
    for m in ("__add__",):
        s = getattr(it, m)(it).getData()
        assert np.array_equal(s, getattr(ij, m)(ij).getData())
    it.inplaceAdd(1.0)
    ij.inplaceAdd(1.0)
    assert np.array_equal(it.getData(), ij.getData())
    psd = np.abs(data[0])
    pt, pj = T.Image(), J.Image()
    pt.setData(psd)
    pj.setData(psd)
    pt.convertPSD()
    pj.convertPSD()
    assert np.array_equal(pt.getData(), pj.getData())
    for b in (T, J):
        b.createEmptyFile(str(tmp_path / f"e_{b.__name__}.mrcs"), 8, 6, 1, 2)
    assert T.getImageSize(str(tmp_path / "e_xmippLib.mrcs")) == (8, 6, 1, 2)
    assert open(tmp_path / f"e_{T.__name__}.mrcs", "rb").read() == \
        open(tmp_path / "e_xmippLib.mrcs", "rb").read()
    it.resize(5, 4)
    assert it.getData().shape == (4, 5)


def test_symlist_and_geometry():
    for sym in ("c1", "c4", "d2", "i1"):
        st, sj = T.SymList(sym), J.SymList(sym)
        assert st.getTrueSymsNo() == sj.getTrueSymsNo()
        assert np.allclose(st.getSymmetryMatrices(),
                           sj.getSymmetryMatrices(), atol=1e-6)
    st = T.SymList()
    st.readSymmetryFile("o")
    assert st.getTrueSymsNo() == J.SymList("o").getTrueSymsNo()
    for ang in ((10.0, 20.0, 30.0), (190.0, 170.0, -45.0)):
        A = T.Euler_angles2matrix(*ang)
        assert np.abs(A - J.Euler_angles2matrix(*ang)).max() <= 1e-6
        assert np.abs(np.asarray(T.Euler_matrix2angles(A))
                      - np.asarray(J.Euler_matrix2angles(A))).max() <= 1e-6
        assert np.abs(T.Euler_direction(*ang)
                      - J.Euler_direction(*ang)).max() <= 1e-6
    for v in ((1.0, 2.0, 3.0), (1.0, 0.0, 0.0)):
        for h in (False, True):
            assert np.abs(T.alignWithZ(*v, h) - J.alignWithZ(*v, h)).max() \
                <= 1e-6


def test_file_helpers(tmp_path):
    stk = str(tmp_path / "orig.mrcs")
    save_image(stk, np.zeros((3, 4, 4), np.float32))
    orig = str(tmp_path / "orig.xmd")
    T.MetaData.fromRows({"image": f"{i + 1}@{stk}", "itemId": i + 1}
                        for i in range(3)).write(orig)
    proc = str(tmp_path / "proc.xmd")
    T.MetaData.fromRows({"image": f"{i + 1}@p.mrcs"} for i in (2, 0)) \
        .write(f"images@{proc}")
    outs = [str(tmp_path / f"out_{k}.xmd") for k in "tj"]
    T.substituteOriginalImages(proc, orig, outs[0], T.MDL_IMAGE, False)
    J.substituteOriginalImages(proc, orig, outs[1], J.MDL_IMAGE, False)
    assert open(outs[0]).read() == open(outs[1]).read()
    sel = tmp_path / "pairs.sel"
    sel.write_text("a.xmp b.xmp\nc.xmp d.xmp\n")
    mt, mj = T.MetaData(), J.MetaData()
    T.readMetaDataWithTwoPossibleImages(str(sel), mt)
    J.readMetaDataWithTwoPossibleImages(str(sel), mj)
    assert mt.df.equals(mj.df) and mt.size() == 2
    star = tmp_path / "b.star"
    star.write_text("data_one\n_a 1\nloop_\n_x\n1\n2\n\ndata_two\n_b 2\n")
    for b in (T, J):
        b.bsoftRemoveLoopBlock(str(star), str(tmp_path / f"r{b is T}.star"))
        b.bsoftRestoreLoopBlock(str(tmp_path / f"r{b is T}.star"),
                                str(tmp_path / f"s{b is T}.star"))
    for k in "rs":
        assert (tmp_path / f"{k}True.star").read_text() == \
            (tmp_path / f"{k}False.star").read_text()
    T.dumpToFile(str(tmp_path / "d.sqlite"))
    assert (tmp_path / "d.sqlite").exists()


def test_label_alias():
    T.addLabelAlias("anglePsi", "psiAliasOfThePort")
    J.addLabelAlias("anglePsi", "psiAliasOfThePort")
    assert T.getNewAlias("anglePsi") == J.getNewAlias("anglePsi")


# ---------------------------------------------------------------------------
# xmipp_base
# ---------------------------------------------------------------------------

def _script(base):
    class MyScript(base.XmippScript):
        def defineParams(self):
            self.addUsageLine("project a volume")
            self.addExampleLine("myscript -i v.vol --n 3")
            self.addParamsLine(" -i <input> : input file")
            self.addParamsLine("[--n <n=3>] : count")
            self.addParamsLine("[--rate <r=1.5>] : rate")
            self.addParamsLine("[--list <l=\"\">] : list")

        def readParams(self):
            self.inp = self.getParam("-i")
            self.n = self.getIntParam("--n")
            self.rate = self.getDoubleParam("--rate")
            self.has = self.checkParam("--list")

        def run(self):
            self.result = (self.inp, self.n, self.rate, self.has)
    return MyScript()


@pytest.mark.parametrize("argv", [["myscript", "-i", "a.xmd", "--n", "7"],
                                  ["myscript", "-i", "b.xmd", "--rate",
                                   "0.25", "--list", "x"],
                                  ["myscript", "--help"]])
def test_xmipp_script_parse_and_run(monkeypatch, capsys, argv):
    got = {}
    for base in (TB, JB):
        monkeypatch.setattr("sys.argv", list(argv))
        s = _script(base)
        assert s.tryRun() == 0
        got[base] = getattr(s, "result", None)
    assert got[TB] == got[JB]
    assert (got[TB] is None) == ("--help" in argv)
    monkeypatch.setattr("sys.argv", ["myscript"])
    assert _script(TB).tryRun() == 1      # -i is required


def test_xmipp_base_helpers(tmp_path):
    rng = np.random.default_rng(8)
    for k in range(2):
        save_image(str(tmp_path / f"p{k}.mrcs"),
                   rng.standard_normal((2, 8, 8)).astype(np.float32))
    pat = str(tmp_path / "p*.mrcs")
    mt = TB.createMetaDataFromPattern(pat, isStack=True)
    mj = JB.createMetaDataFromPattern(pat, isStack=True)
    assert mt.df.equals(mj.df) and mt.size() == 4
    fn = str(tmp_path / "pat.xmd")
    mt.write(fn)
    assert TB.getMdSize(fn) == JB.getMdSize(fn) == 4
    assert TB.isMdEmpty(fn) is JB.isMdEmpty(fn) is False
    TB.writeInfoField(str(tmp_path), "iter1", "maxCC", 0.75)
    assert JB.readInfoField(str(tmp_path), "iter1", "maxCC") == \
        TB.readInfoField(str(tmp_path), "iter1", "maxCC") == 0.75
    assert TB.xmippExists(fn) and not TB.xmippExists(fn + ".no")
    row_t, row_j = TB.XmippMdRow(), JB.XmippMdRow()
    for row, md in ((row_t, T.MetaData(fn)), (row_j, J.MetaData(fn))):
        row.readFromMd(md, md.firstObject())
        row.setValue("maxCC", 0.5)
        row.removeLabel("enabled")
    assert str(row_t) == str(row_j) and list(row_t) == list(row_j)
    assert row_t.containsLabel("image") and row_t.hasLabel("maxCC")
    assert row_t.getValue("noSuch", 3) == 3
    out_t, out_j = T.MetaData(), J.MetaData()
    row_t.addToMd(out_t)
    row_j.addToMd(out_j)
    assert out_t.df.equals(out_j.df)
    copy = TB.XmippMdRow()
    copy.copyFromRow(row_t)
    assert str(copy) == str(row_t)


def test_xmipp_base_paths_and_conda(tmp_path, monkeypatch):
    monkeypatch.delenv("XMIPP_HOME", raising=False)
    assert TB.getXmippPath() == str(PORT)
    assert TB.getXmippPath("models", "x") == str(PORT / "models" / "x")
    with pytest.raises(FileNotFoundError):
        TB.getModel("no_such_model")
    assert TB.getModel("no_such_model", doRaise=False).endswith(
        "no_such_model")
    monkeypatch.setenv("XMIPP_HOME", str(tmp_path))
    (tmp_path / "models" / "m").mkdir(parents=True)
    assert TB.XmippScript.getModel("m") == str(tmp_path / "models" / "m")
    C = TB.CondaEnvManager
    assert C.getCondaName(TB.XmippScript) == JB.CondaEnvManager.getCondaName(
        JB.XmippScript) == TB.CONDA_DEFAULT_ENVIRON
    assert C.getCondaExe() == sys.executable and C.getEnvironDir("e") == \
        sys.prefix
    assert C.getCondaEnv({"A": "1"}, "e") == {"A": "1"}
    assert C.getCondaActivationCmd() == "" and list(
        C.yieldInstallAllCmds(True)) == []
    assert C.getCurInstalledDep("torch") == torch.__version__.split("+")[0] \
        or C.getCurInstalledDep("torch") == torch.__version__
    assert C.getCurInstalledDep("no-such-dist", "0") == "0"
    assert C.installEnvironCmd("e", "r.txt") == ""
    marker = tmp_path / "ran"
    TB.XmippScript.runCondaCmd("touch", str(marker))
    assert marker.exists()


# ---------------------------------------------------------------------------
# the surface, the stand-ins, the card default
# ---------------------------------------------------------------------------

def public(module):
    return {n for n in dir(module) if not n.startswith("_")}


@pytest.mark.parametrize("pair", ["xmippLib", "xmipp_base"])
def test_every_public_name_of_the_root_module_is_ported(pair):
    root, port = {"xmippLib": (J, T), "xmipp_base": (JB, TB)}[pair]
    missing = public(root) - public(port)
    assert not missing, sorted(missing)


_SITE_PROBE = """
import sys
import xmippLib, xmipp_base
import xmippPyModules.swiftalign
import xmippPyModules.classifyPcaFuntion.bnb_gpu as bnb
from xmippPyModules.swiftalign.transform import euler_to_matrix
from xmippPyModules.example_module2 import example_inmodule2
for m in (xmippLib, xmipp_base, xmippPyModules, xmippPyModules.swiftalign,
          bnb, example_inmodule2):
    print("FILE", m.__file__)
assert bnb is sys.modules[
    "xmipp3_tpu_torch.binding.xmippPyModules.classifyPcaFuntion.bnb_gpu"]
assert xmippLib.FourierProjector.__module__ == \\
    "xmipp3_tpu_torch.binding.xmippLib"
print("EULER", float(euler_to_matrix(10, 20, 30)[0, 0, 0]))
print("LOADED", sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "xmipp3_tpu")))
"""


def test_site_directory_stands_in_for_the_root_modules(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(SITE), str(REPO)])
    out = subprocess.run([sys.executable, "-c", _SITE_PROBE], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    files = [ln[5:] for ln in out.stdout.splitlines()
             if ln.startswith("FILE ")]
    assert len(files) == 6
    for f in files:
        assert os.path.realpath(f).startswith(str(PORT) + os.sep), f
    assert "LOADED []" in out.stdout, out.stdout
    assert "EULER" in out.stdout


def test_binding_defaults_to_the_card_and_raises_without_one(monkeypatch,
                                                              tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol = blob_volume(9, 16)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.FourierProjector(vol)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.projectVolumeDouble(vol, 0, 0, 0)
    ref = smooth_images(9, 1, 16, 16)[0]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.image_align(ref, ref)
    fn = str(tmp_path / "p.mrc")
    save_image(fn, ref)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        T.bandPassFilter(T.Image(), fn, 0.1, 0.3, 0.02, 8)
    assert T.FourierProjector(vol, device=CPU).projectVolume(
        0, 0, 0).getData().shape == (16, 16)


# ---------------------------------------------------------------------------
# the MATLAB wrappers and the console entry point
# ---------------------------------------------------------------------------

MATLAB = REPO / "bindings" / "matlab"
PORT_MATLAB = PORT / "binding" / "matlab"


@pytest.mark.parametrize("name", sorted(p.name for p in MATLAB.glob("*.m")))
def test_matlab_wrapper_has_a_port_counterpart(name):
    import re

    from xmipp3_tpu_torch.programs import get_program
    from xmipp3_tpu_torch.programs.matlab_bridge import FUNCS
    text = (PORT_MATLAB / name).read_text()
    root = (MATLAB / name).read_text()
    head = lambda t: re.search(r"^function .*$", t, re.M).group(0)
    assert head(text) == head(root)       # the same argument contract
    funcs = re.findall(r"xmipp_matlab_bridge\('(\w+)'", text)
    assert funcs == re.findall(r"xmipp_matlab_bridge\('(\w+)'", root)
    assert all(f in FUNCS for f in funcs), funcs
    assert not re.search(r"['\[]xmipp ", text)    # never the JAX command
    for prog in re.findall(r"['\[]xmipp_torch (\w+)", text):
        assert get_program(prog) is not None, prog
    if name == "xmipp_matlab_bridge.m":
        assert "'xmipp_torch matlab_bridge --func %s" in text


def test_matlab_wrappers_and_entry_point():
    assert sorted(p.name for p in PORT_MATLAB.glob("*.m")) == sorted(
        p.name for p in MATLAB.glob("*.m"))
    assert (PORT_MATLAB / "README.md").is_file()
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())[
        "project"]["scripts"]
    assert scripts["xmipp"] == "xmipp3_tpu.programs:main"
    module, attr = scripts["xmipp_torch"].split(":")
    import importlib

    from xmipp3_tpu_torch.programs import main
    assert module == "xmipp3_tpu_torch.programs"
    assert getattr(importlib.import_module(module), attr) is main
