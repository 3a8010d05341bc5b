"""The port's matlab_bridge, function by function, and its infra programs
(sync_data, compile, test_script_importing_module) against the reference
package's, on the CPU.

Each bridge function runs through both packages' CLI on the same MAT-file
of arguments (scipy.io, as the .m wrappers write them), the port with
--device cpu, and the two result MAT-files are held together:
- read, write, mirror, mirt3D_mexinterp, mask, morphology, volume_segment,
  read_metadata, nma_read_alignment, nma_save_cluster,
  read_structure_factor: equal (the same host numpy and scipy);
- rotate (2-D cubic B-spline and 3-D trilinear warps), scale,
  scale_pyramid, normalize, ctf_correct_phase, psd_enhance, periodogram,
  ctf_generate_filter, resolution: 1e-4 of the max (float32 device
  arithmetic against the reference's);
- align2d: psi within 0.05 degrees and the shifts within 0.05 px;
- adjust_ctf: every defocus within 1 % of the reference's fit (as
  tests/test_torch_ctf_estimation.py holds the estimator), the other
  fields of the struct present.
sync_data runs against a file:// mirror; compile builds and runs a C++
file against the port's native library where g++ is present.
"""
import hashlib
import io
import shutil
import subprocess
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from scipy.io import loadmat, savemat

from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu_torch.core.image import save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.programs import get_program

torch.set_num_threads(1)


def bridge(d, tag, func, args):
    fin, fout = str(d / f"in_{func}.mat"), str(d / f"{tag}_{func}.mat")
    savemat(fin, args)
    get = jax_program if tag == "j" else get_program
    tail = ["-v", "0"] + (["--device", "cpu"] if tag == "t" else [])
    assert get("matlab_bridge").run_with_args(
        ["--func", func, "-i", fin, "-o", fout] + tail) == 0
    return loadmat(fout, squeeze_me=True)


def _arrays(out):
    return {k: v for k, v in out.items() if not k.startswith("__")}


def ctf_psd(n=128, Ts=1.5):
    from xmipp3_tpu_torch.ops.ctf import CTFDescription
    true = CTFDescription(sampling_rate=Ts, voltage=300, Cs=2.7, Q0=0.07,
                          defocusU=15000, defocusV=14000,
                          azimuthal_angle=20.0, K=1.0)
    fy = np.fft.fftfreq(n).astype(np.float32)[:, None] / Ts
    fx = np.fft.rfftfreq(n).astype(np.float32)[None, :] / Ts
    half = true.pure_at(fx, fy, device="cpu").numpy() ** 2 + 0.05
    full = np.concatenate([half, half[:, -2:0:-1]], axis=1)[:, :n]
    return np.fft.fftshift(full)


def cases(d):
    rng = np.random.default_rng(9)
    img = rng.standard_normal((32, 32)).astype(np.float32)
    y, x = np.mgrid[0:32, 0:32].astype(np.float32) - 16
    blob = (np.exp(-(x ** 2 + y ** 2) / 30)
            + 0.6 * np.exp(-((x - 6) ** 2 + y ** 2) / 6)).astype(np.float32)
    z3, y3, x3 = np.mgrid[0:16, 0:16, 0:16].astype(np.float32) - 8
    vol = np.exp(-((x3 - 3) ** 2 + y3 ** 2 + z3 ** 2) / 6.0) \
        .astype(np.float32)
    save_image(str(d / "v.vol"), vol)
    st = {"DeltafU": 12000.0, "DeltafV": 11000.0, "AzimuthalAngle": 30.0,
          "kV": 300.0, "Cs": 2.0, "Q0": 0.1, "K": 1.0,
          "objectPixelSize": 1.5}
    nma = d / "nma"
    nma.mkdir(exist_ok=True)
    MetaData.fromRows({"image": f"{k + 1}@s.mrcs",
                       "nmaDisplacements": np.array([0.5 * k, -k, 2.0]),
                       "cost": 0.1 * k} for k in range(4)).write(
        str(nma / "images.xmd"))
    MetaData.fromRows({"resolutionFreq": 0.05 * (k + 1),
                       "resolutionLogStructure": -0.3 * k}
                      for k in range(6)).write(str(d / "sf.xmd"))
    bw = np.zeros((16, 16), np.float32)
    bw[5:9, 6:11] = 1.0
    bw[12, 3] = 1.0
    pts = rng.uniform(0, 17, (3, 5))
    return {
        "read": [dict(filename=str(d / "v.vol"))],
        "write": [dict(array=vol, filename=str(d / "w.vol"))],
        "rotate": [dict(img=blob, angs=33.0, axis=[], align_z=[],
                        gridding=False, wrap=True),
                   dict(img=vol, angs=[20.0, 30.0, 40.0], axis=[],
                        align_z=[], gridding=False, wrap=False),
                   dict(img=vol, angs=25.0, axis=[1.0, 1.0, 0.0],
                        align_z=[], gridding=False, wrap=False),
                   dict(img=vol, angs=0.0, axis=[],
                        align_z=[0.0, 1.0, 1.0], gridding=False,
                        wrap=True)],
        "scale": [dict(img=img, outsize=[20, 24], gridding=False),
                  dict(img=img, outsize=[48, 48], gridding=True),
                  dict(img=vol, outsize=[12, 12, 12], gridding=True),
                  dict(img=vol, outsize=[12, 20, 12], gridding=False)],
        "scale_pyramid": [dict(img=img, operation="reduce", levels=1),
                          dict(img=img, operation="expand", levels=1),
                          dict(img=vol, operation="reduce", levels=1)],
        "mirror": [dict(img=img, flipstring="xy"),
                   dict(img=vol, flipstring="z")],
        "mirt3D_mexinterp": [dict(input_image=vol, XI=pts[0], YI=pts[1],
                                  ZI=pts[2])],
        "mask": [dict(msize=[16, 16], type=t, params=p, inner=inner)
                 for t, p, inner in (
                     ("circular", [5.0], False), ("crown", [3.0, 6.0], True),
                     ("rectangular", [6.0, 4.0], False),
                     ("gaussian", [3.0], False),
                     ("raised_cosine", [3.0, 6.0], False))]
        + [dict(msize=[16, 16, 16], type="cylinder", params=[4.0, 6.0],
                inner=False)],
        "morphology": [dict(img=bw, operation=op, neig=8, ksize=1, count=c)
                       for op, c in (("dilation", 0), ("erosion", 0),
                                     ("opening", 0), ("closing", 3))],
        "normalize": [dict(img=5 + 2 * img, method=m, mask=[])
                      for m in ("OldXmipp", "NewXmipp")]
        + [dict(img=5 + 2 * img, method=m, mask=(x ** 2 + y ** 2 > 100)
                .astype(np.float64))
           for m in ("NewXmipp", "NewXmipp2", "Near_OldXmipp", "Ramp")],
        "adjust_ctf": [dict(psd=ctf_psd(), Dz=14000.0, voltage=300.0,
                            objectPixelSize=1.5, ctfmodelSize=64, Cs=2.7,
                            min_freq=0.03, max_freq=0.35, Ca=2.0)],
        "ctf_correct_phase": [dict(img=img, st=st, method=m, epsilon=e)
                              for m, e in (("leave", 0.0),
                                           ("remove", 0.2),
                                           ("divide", 0.3))],
        "psd_enhance": [dict(img=np.abs(ctf_psd(64)), center=True,
                             take_log=True, filter_w1=0.05, filter_w2=0.2,
                             decay_width=0.02, mask_w1=0.025, mask_w2=0.2)],
        "periodogram": [dict(image=rng.standard_normal((128, 128))
                             .astype(np.float32), sz=64)],
        "ctf_generate_filter": [dict(Xdim=64, Tm=1.5, DeltafU=12000.0,
                                     DeltafV=10000.0, AzimuthalAngle=15.0,
                                     kV=300.0, Cs=2.0, Q0=0.1, K=1.0)],
        "align2d": [dict(img=np.roll(blob, (2, -3), (0, 1)), ref=blob,
                         mode=m, max_shift=6, Rin=2, Rout=12)
                    for m in ("trans", "complete")]
        + [dict(img=np.rot90(blob).copy(), ref=blob, mode="rot", Rin=2,
                Rout=12, max_shift=0)],
        # the reference image carries noise too: a smooth blob alone has
        # float32 roundoff for its high shells' amplitudes
        "resolution": [dict(img=blob + 0.1 * img,
                            ref=blob + 0.1 * img[::-1].copy(),
                            objectpixelsize=1.5)],
        "volume_segment": [dict(vol=vol, sampling=1.5, mass=300.0,
                                type="voxels", enable_threshold=False),
                           dict(vol=vol, sampling=1.5, mass=2000.0,
                                type="dalton", enable_threshold=False),
                           dict(vol=vol, threshold=0.3,
                                enable_threshold=True)],
        "read_metadata": [dict(filename=str(d / "sf.xmd"))],
        "nma_read_alignment": [dict(NMAdirectory=str(nma))],
        "nma_save_cluster": [dict(NMAdirectory=str(nma), clusterName="c1",
                                  inCluster=[1.0, 0.0, 1.0, 1.0])],
        "read_structure_factor": [dict(rundir=str(d / "sf.xmd"))],
    }


DEVICE_FUNCS = {"rotate", "scale", "scale_pyramid", "normalize",
                "ctf_correct_phase", "psd_enhance", "periodogram",
                "ctf_generate_filter", "resolution"}
FUNCS = sorted([
    "read", "write", "rotate", "scale", "scale_pyramid", "mirror",
    "mirt3D_mexinterp", "mask", "morphology", "normalize", "adjust_ctf",
    "ctf_correct_phase", "psd_enhance", "periodogram",
    "ctf_generate_filter", "align2d", "resolution", "volume_segment",
    "read_metadata", "nma_read_alignment", "nma_save_cluster",
    "read_structure_factor"])


def test_bridge_covers_every_function():
    from xmipp3_tpu.programs.matlab_bridge import FUNCS as JF
    from xmipp3_tpu_torch.programs.matlab_bridge import FUNCS as TF
    assert sorted(TF) == sorted(JF) == FUNCS


@pytest.mark.parametrize("func", FUNCS)
def test_bridge_function_matches_the_reference(func, tmp_path):
    for k, args in enumerate(cases(tmp_path)[func]):
        want = _arrays(bridge(tmp_path, "j", func, args))
        if func in ("write", "nma_save_cluster"):
            shutil.move(str(tmp_path / ("w.vol" if func == "write" else
                                        "nma/c1.xmd")),
                        str(tmp_path / f"ref_{k}"))
        got = _arrays(bridge(tmp_path, "t", func, args))
        assert sorted(got) == sorted(want), (func, k)
        if func == "adjust_ctf":
            for f in ("DeltafU", "DeltafV"):
                assert abs(got[f] - want[f]) <= 0.01 * abs(want[f])
            continue
        if func == "align2d":
            for f, tol in (("Psi", 0.05), ("Xoff", 0.05), ("Yoff", 0.05)):
                assert abs(float(got[f]) - float(want[f])) <= tol, (k, f)
            continue
        for key in want:
            a, b = want[key], got[key]
            if isinstance(a, np.ndarray) and a.dtype.kind in "fc" \
                    and func in DEVICE_FUNCS:
                assert a.shape == b.shape, (k, key)
                fin = np.isfinite(a)
                assert np.array_equal(fin, np.isfinite(b)), (k, key)
                err = np.abs(a[fin] - b[fin]).max() if fin.any() else 0.0
                assert err <= 1e-4 * max(np.abs(a[fin]).max(), 1e-30), \
                    (k, key, err)
            elif isinstance(a, np.ndarray) and a.dtype.kind in "fc":
                assert np.array_equal(a, b, equal_nan=True), (k, key)
            else:
                assert np.array_equal(np.asarray(a), np.asarray(b)), (k, key)
        if func == "write":
            assert (tmp_path / "w.vol").read_bytes() == \
                (tmp_path / f"ref_{k}").read_bytes()
        if func == "nma_save_cluster":
            assert (tmp_path / "nma" / "c1.xmd").read_text() == \
                (tmp_path / f"ref_{k}").read_text()


# -- infra --------------------------------------------------------------------

def _md5(path):
    return hashlib.md5(path.read_bytes()).hexdigest()


@pytest.fixture()
def mirror(tmp_path):
    """A file:// mirror: a dataset with two files and its MANIFEST, and a
    DLmodels tarball."""
    import tarfile
    root = tmp_path / "mirror"
    ds = root / "testSet"
    (ds / "sub").mkdir(parents=True)
    (ds / "a.txt").write_text("alpha\n")
    (ds / "sub" / "b.bin").write_bytes(bytes(range(40)))
    (ds / "MANIFEST").write_text(
        f"a.txt {_md5(ds / 'a.txt')}\n"
        f"sub/b.bin {_md5(ds / 'sub' / 'b.bin')}\n")
    (root / "MANIFEST").write_text("./testSet\n")
    src = tmp_path / "model"
    src.mkdir()
    (src / "weights.txt").write_text("w\n")
    tgz = root / "xmipp_model_demo.tgz"
    with tarfile.open(tgz, "w:gz") as tf:
        tf.add(src / "weights.txt", arcname="demo/weights.txt")
    (root / "xmipp_models_MANIFEST").write_text(
        f"{_md5(tgz)} xmipp_model_demo.tgz\n")
    return root


def run_both(name, args, tmp_path):
    """Run `name` in both packages; args(tag) gives each its arguments.
    Returns their standard outputs."""
    outs = []
    for tag, get in (("j", jax_program), ("t", get_program)):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert get(name).run_with_args(args(tag)) == 0, tag
        outs.append(buf.getvalue())
    return outs


def test_sync_data_download_and_update_from_a_file_mirror(mirror, tmp_path):
    url = "file://" + str(mirror)
    outs = run_both("sync_data", lambda t: [
        "download", str(tmp_path / t / "data"), url, "testSet"], tmp_path)
    assert outs[0] == outs[1]
    for t in "jt":
        got = tmp_path / t / "data"
        assert (got / "a.txt").read_text() == "alpha\n"
        assert (got / "sub" / "b.bin").read_bytes() == bytes(range(40))
    (mirror / "testSet" / "a.txt").write_text("beta\n")
    (mirror / "testSet" / "MANIFEST").write_text(
        f"a.txt {_md5(mirror / 'testSet' / 'a.txt')}\n"
        f"sub/b.bin {_md5(mirror / 'testSet' / 'sub' / 'b.bin')}\n")
    outs = run_both("sync_data", lambda t: [
        "update", str(tmp_path / t / "data"), url, "testSet"], tmp_path)
    assert outs[0] == outs[1] and "Updated files: 1" in outs[1]
    assert (tmp_path / "t" / "data" / "a.txt").read_text() == "beta\n"
    outs = run_both("sync_data", lambda t: [
        "download", str(tmp_path / t / "models"), url, "DLmodels"], tmp_path)
    assert outs[0] == outs[1]
    assert (tmp_path / "t" / "models" / "demo" / "weights.txt").read_text() \
        == "w\n"


def test_test_script_importing_module_prints_the_reference_lines(tmp_path):
    outs = run_both("test_script_importing_module", lambda t: [], tmp_path)
    assert outs[0] == outs[1]
    assert outs[1].splitlines()[-1] == \
        "[       OK ] test_script_importing_module"


@pytest.mark.skipif(shutil.which("g++") is None or shutil.which("make")
                    is None, reason="needs g++ and make to build")
def test_compile_links_against_the_port_native_library(tmp_path):
    from xmipp3_tpu_torch import native
    src = tmp_path / "hello.cpp"
    src.write_text('#include <cstdio>\nextern "C" int mrc_read_slices('
                   'const char*, const long*, long, float*, int);\n'
                   'int main() { std::printf("%d\\n", mrc_read_slices('
                   '"none.mrc", nullptr, 0, nullptr, 1) != 0); }\n')
    prog = get_program("compile")
    with redirect_stdout(io.StringIO()):
        assert prog.run_with_args(["-i", str(src), "-o",
                                   str(tmp_path / "hello"), "-v", "0"]) == 0
    assert (tmp_path / "hello").exists()
    assert native.get_lib() is not None
    out = subprocess.run([str(tmp_path / "hello")], capture_output=True,
                         text=True, timeout=30)
    assert out.returncode == 0 and out.stdout.strip() == "1"
    ldd = subprocess.run(["ldd", str(tmp_path / "hello")],
                         capture_output=True, text=True).stdout
    assert native.LIB_DIR in ldd


def test_native_reads_a_stack_like_the_image_reader(tmp_path):
    from xmipp3_tpu_torch import native
    from xmipp3_tpu_torch.core.image import Image
    stack = np.random.default_rng(3).standard_normal((5, 12, 10)) \
        .astype(np.float32)
    fn = str(tmp_path / "s.mrcs")
    save_image(fn, stack)
    got = native.read_stack_slices(fn, [4, 0, 2], (12, 10), "mrc")
    if got is None:
        pytest.skip("the native library could not be built here")
    assert np.array_equal(got, Image.read_stack(fn)[[4, 0, 2]])
