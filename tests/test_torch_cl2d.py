"""CL2D of the port (xmipp3_tpu_torch.models.cl2d) against the reference
package's on the CPU, on the same numpy-seeded images at N=32.

- correntropy_assign: <= 1e-5 of the max similarity; its sigma^2 takes
  numpy's median (the mean of the two middle values at an even count).
- _center_refs and initial_references: <= 1e-5 * max.
- classify_cl2d whole on tests/test_classify.py's 4-prototype set and its
  two-class set: the same class for >= 98 % of the images, references
  <= 1e-3 * max, the same level count; each option of the reference's
  surface (--classicalMultiref, --distance correlation, --neigh,
  --useThresholdMask, --minsize, --nref0) likewise.
- The mesh path (--mesh dp over 2 gloo ranks of the CLI) against the
  port's serial run: the same classes and the same references (the ranks
  match the serial run's chunks), only rank 0 writes, no rank imports
  jax.
"""
import numpy as np
import pytest
import torch

from test_classify import two_class_stack
from test_torch_common import Ranks, rel_err
from xmipp3_tpu.models import cl2d as jcl2d
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.models import cl2d as tcl2d
from xmipp3_tpu_torch.programs import get_program

torch.set_num_threads(1)


def four_class_set(seed=3, n=32, B=48, noise=0.15):
    """The 4-prototype set of tests/test_classify.py (:87-101): labels and
    noise drawn from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n].astype(np.float32) - n // 2
    protos = [
        np.exp(-(x ** 2 + y ** 2) / 30),
        np.exp(-((x - 6) ** 2 + y ** 2) / 18)
        + np.exp(-((x + 6) ** 2 + y ** 2) / 18),
        np.exp(-(x ** 2 / 60 + y ** 2 / 8)),
        np.exp(-(x ** 2 + (y - 5) ** 2) / 12)
        + np.exp(-(x ** 2 + (y + 5) ** 2) / 40)]
    labels = rng.integers(0, 4, B)
    imgs = np.stack([protos[c] for c in labels]).astype(np.float32)
    imgs += noise * rng.standard_normal(imgs.shape).astype(np.float32)
    return imgs, labels


@pytest.fixture(scope="module")
def two_class():
    return two_class_stack(n_per=16, size=32)[0]


def _hold(rj, rt):
    agree = float((np.asarray(rj["assignments"])
                   == np.asarray(rt["assignments"])).mean())
    assert agree >= 0.98, agree
    assert rel_err(rt["refs"], rj["refs"]) <= 1e-3
    assert len(rt["levels"]) == len(rj["levels"])
    for lj, lt in zip(rj["levels"], rt["levels"]):
        assert np.asarray(lt["refs"]).shape == np.asarray(lj["refs"]).shape
        assert float((lj["assignments"] == lt["assignments"]).mean()) >= 0.98


def test_correntropy_assign_matches_the_reference(two_class):
    refs = two_class[:5] + 0.1
    want = jcl2d.correntropy_assign(two_class, refs)
    got = tcl2d.correntropy_assign(two_class, refs, device="cpu")
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-5


def test_median_is_numpys():
    for n in (5, 6):
        x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
        assert float(tcl2d._median(torch.as_tensor(x))) == \
            pytest.approx(float(np.median(x)), rel=1e-6)


def test_center_refs_and_initial_references(two_class):
    prev = two_class[:4]
    refs = np.roll(prev, (1, -2), axis=(1, 2))
    want = np.asarray(jcl2d._center_refs(refs, prev))
    got = tcl2d._center_refs(torch.as_tensor(refs), torch.as_tensor(prev))
    assert rel_err(got, want) <= 1e-5
    assert rel_err(tcl2d.initial_references(two_class, 3, seed=5,
                                            device="cpu"),
                   jcl2d.initial_references(two_class, 3, seed=5)) <= 1e-5


def test_classify_cl2d_four_prototypes_matches_the_reference():
    imgs, labels = four_class_set()
    kw = dict(n_iters=4, max_shift=2, nref0=2)
    rj = jcl2d.classify_cl2d(imgs, 4, **kw)
    rt = tcl2d.classify_cl2d(imgs, 4, device="cpu", **kw)
    _hold(rj, rt)
    assert [len(lev["refs"]) for lev in rt["levels"]] == [2, 4]


@pytest.mark.parametrize("kw", [
    {}, {"classical_multiref": True}, {"distance": "correlation"},
    {"neigh": 2}, {"threshold_mask": 0.05}, {"min_size_pct": 60.0},
    {"nref0": 3}], ids=lambda kw: "-".join(kw) or "defaults")
def test_classify_cl2d_options_match_the_reference(two_class, kw):
    rj = jcl2d.classify_cl2d(two_class, 4, n_iters=4, max_shift=4, **kw)
    rt = tcl2d.classify_cl2d(two_class, 4, n_iters=4, max_shift=4,
                             device="cpu", **kw)
    _hold(rj, rt)


def test_cl2d_mesh_dp_over_two_ranks_matches_serial(tmp_path, two_class):
    stk = str(tmp_path / "parts.mrcs")
    save_image(stk, two_class)
    args = ["-i", stk, "--nref", "4", "--iter", "4", "--maxShift", "4",
            "--oroot", "cl"]
    serial = tmp_path / "serial"
    serial.mkdir()
    assert get_program("classify_CL2D").run_with_args(
        args + ["--odir", str(serial), "--device", "cpu", "-v", "0"]) == 0
    mesh = tmp_path / "mesh"
    mesh.mkdir()
    reps = Ranks(2, [{"name": "cl2d", "program": "classify_CL2D",
                      "argv": args + ["--odir", str(mesh), "--mesh", "dp"]}],
                 tmp_path, {}).join()
    for rep in reps:
        assert rep["jobs"]["cl2d"].get("rc") == 0, rep["jobs"]["cl2d"]
        assert rep["modules"] == []
    assert reps[0]["jobs"]["cl2d"]["writes"] >= 1
    assert reps[1]["jobs"]["cl2d"]["writes"] == 0
    a = MetaData(str(serial / "cl_images.xmd"))
    b = MetaData(str(mesh / "cl_images.xmd"))
    assert np.array_equal(a.getColumn("ref"), b.getColumn("ref"))
    assert np.array_equal(Image.read_stack(str(mesh / "cl_references.stk")),
                          Image.read_stack(str(serial /
                                               "cl_references.stk")))
    for lev in ("level_00", "level_01"):
        assert (mesh / lev / "cl_classes.xmd").is_file()


def test_match_chunks_dealt_to_the_ranks_are_the_serial_runs(monkeypatch,
                                                              two_class):
    """_match on a 2-rank mesh: chunks of 7 of 32 images (the last padded)
    dealt out in turn; gathered back in chunk order, each rank's results
    equal the serial run's bit for bit."""
    from xmipp3_tpu_torch.parallel import mesh as pmesh
    monkeypatch.setattr(tcl2d, "MATCH_CHUNK", 7)
    imgs = torch.as_tensor(two_class)
    refs = imgs[:3]
    serial = tcl2d._match(refs, imgs, 4, True, None)
    local = {0: [], 1: []}

    class Rank:
        shape = {"data": 2}

        def __init__(self, r):
            self.coords = {"data": r}

    def gather(t, mesh, axis):
        local[mesh.coords[axis]].append(t)
        return torch.cat([t, t])           # the shape of the gather

    monkeypatch.setattr(pmesh, "all_gather", gather)
    for r in (0, 1):
        tcl2d._match(refs, imgs, 4, True, Rank(r))
    for k, want in enumerate(serial):
        both = torch.cat([local[0][k], local[1][k]])
        got = both.reshape(2, -1, 7).transpose(0, 1).reshape(-1)[:32]
        assert torch.equal(got, want)
