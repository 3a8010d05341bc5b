"""The slice as a whole: the port's reconstruct_fourier program against the
reference's, both run with run_with_args on the same .xmd + .mrcs, the
port with --device cpu. The written volumes (and --prepare_fsc halves)
must agree within the tolerance of the gridding window."""
import numpy as np
import pytest
import torch

from test_torch_common import phantom_batch, rel_err
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu_torch.core.errors import XmippError
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.programs import get_program, main

torch.set_num_threads(1)

N, C = 32, 16
TOL = {"tri+kb": 1e-4, "nn": 1e-4, "kb": 5e-3}


def _dataset(tmp_path, seed=21):
    b = phantom_batch(seed, C, N)
    stk = str(tmp_path / "parts.mrcs")
    save_image(stk, b["imgs"])
    rows = [{"image": f"{i + 1}@{stk}", "angleRot": float(b["rot"][i]),
             "angleTilt": float(b["tilt"][i]), "anglePsi": float(b["psi"][i]),
             "shiftX": float(b["sx"][i]), "shiftY": float(b["sy"][i]),
             "weight": float(b["w"][i]), "flip": int(b["flip"][i])}
            for i in range(C)]
    fn = str(tmp_path / "parts.xmd")
    MetaData.fromRows(rows).write(fn)
    return fn


def _vol(path):
    return np.squeeze(Image(str(path)).data)


@pytest.mark.parametrize("sym", ["c1", "c4"])
@pytest.mark.parametrize("interp", ["kb", "tri+kb", "nn"])
def test_cli_writes_the_reference_volumes(tmp_path, interp, sym):
    fn = _dataset(tmp_path)
    extra = ["--interp", interp, "--sym", sym]
    fsc = sym != "c1"            # the c4 runs also split FSC halves
    if fsc:
        extra += ["--weight", "--prepare_fsc", "{root}"]
    outs = {}
    # the reference on its serial path (tests/conftest.py shows it eight
    # host devices, on which it would otherwise take its dp mesh)
    for side, prog, dev in (("ref", jax_program, ["--mesh", "none"]),
                            ("port", get_program, ["--device", "cpu"])):
        out = tmp_path / f"{side}.vol"
        args = ["-i", fn, "-o", str(out)] + [
            a.format(root=str(tmp_path / side)) for a in extra] + dev
        assert prog("reconstruct_fourier").run_with_args(args) == 0
        outs[side] = out
    ref, port = _vol(outs["ref"]), _vol(outs["port"])
    assert port.shape == (N, N, N) and np.isfinite(port).all()
    assert rel_err(port, ref) <= TOL[interp]
    if fsc:
        for h in (1, 2):
            half = f"_{h}_recons.vol"
            assert rel_err(_vol(str(tmp_path / "port") + half),
                           _vol(str(tmp_path / "ref") + half)) <= TOL[interp]


def test_cli_dispatcher_runs_the_program(tmp_path, capsys):
    fn = _dataset(tmp_path)
    out = tmp_path / "rec.vol"
    assert main(["xmipp", "reconstruct_fourier", "-i", fn, "-o", str(out),
                 "--interp", "nn", "--device", "cpu"]) == 0
    assert _vol(out).shape == (N, N, N)
    assert main(["xmipp", "--help"]) == 0
    assert "xmipp_reconstruct_fourier" in capsys.readouterr().out
    assert main(["xmipp", "no_such_program"]) == 1


@pytest.mark.parametrize("flag", [["--useCTF"], ["--mesh", "dp"],
                                  ["--dist_nprocs", "2"]])
def test_cli_rejects_flags_of_later_slices(tmp_path, flag):
    fn = _dataset(tmp_path)
    prog = get_program("reconstruct_fourier")
    with pytest.raises(XmippError, match="ROADMAP"):
        prog.run_with_args(["-i", fn, "-o", str(tmp_path / "r.vol"),
                            "--device", "cpu"] + flag)
