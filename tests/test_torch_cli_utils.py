"""The image and metadata utility programs of the port against the
reference package's programs on the same files, on the CPU (N=32):

- each of the 19 programs through both dispatchers on one stack of 6
  phantom views (with poses), one 16^3 volume and one operand image; each
  package writes into a directory of its own (j/ and t/), so that paths
  differ only there;
- exactly equal where the reference is exact: the window, the mirror, the
  threshold, the noise (numpy draws moved to the card and added in
  float32, as the reference adds them), image_convert's round trip and
  depth rewrite, image_header, the histogram counts, and every metadata
  program (metadata_utilities through the cases of
  tests/test_metadata_utilities_cli.py; split; import; histogram;
  angular_distance; the EMX round trip) but angular_rotate, whose poses
  the port composes in float64: within 1e-3 degrees of the reference's as
  rotations, and at a pole, where the reference's float32 composition
  loses the in-plane angle, within 1e-3 degrees of the truth;
- to float32 roundoff elsewhere, each tolerance relative to the max of
  the reference's output: the transcendental image_operate operations
  1e-6; the randomised phases, the downsample and the Fourier resize 1e-5
  (the reference transforms in float64 numpy or XLA); the spline resize
  1e-5; image_convert with the rows' geometry applied on read 1e-5;
  statistics 1e-5 (the port sums in float64 on the device, the reference
  in float32 numpy);
- the metadata programs' random draws without a seed (random_subset,
  bootstrap, the rand_* fills) by their shapes and ranges only;
- every one of the 23 programs and 7 aliases declares exactly the
  reference's grammar (names, aliases, arguments, defaults, choices and
  requirements; the help comments may differ), the aliases dispatch to
  their program's class, and the programs that work on pixels raise
  without a card unless --device cpu is given;
- the two flags whose other values the reference accepts and never reads
  (transform_downsample --method, image_statistics --mask <type>) raise
  for those values (ROADMAP.md section 3, item 11).
"""
import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from test_torch_common import phantom_batch
from test_torch_project import phantom8
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu_torch.core.image import Image, save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.programs import ALIASES, get_program

torch.set_num_threads(1)

N, C = 32, 6
NEW = ["image_operate", "transform_window", "transform_add_noise",
       "transform_threshold", "transform_mirror",
       "transform_randomize_phases", "transform_downsample", "image_resize",
       "image_convert", "image_header", "image_statistics",
       "image_histogram", "metadata_utilities", "metadata_split",
       "metadata_import", "metadata_histogram", "angular_distance",
       "angular_rotate", "metadata_convert_emx", "reconstruct_art",
       "reconstruct_wbp", "reconstruct_significant", "align_significant"]
NEW_ALIASES = ["mpi_image_operate", "mpi_image_resize",
               "mpi_transform_threshold", "mpi_reconstruct_art",
               "mpi_reconstruct_wbp", "mpi_reconstruct_significant",
               "cuda_align_significant"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("utils")
    for t in "jt":
        (d / t).mkdir()
    b = phantom_batch(7, C, N)
    rng = np.random.default_rng(7)
    imgs = b["imgs"] + 0.2 * rng.standard_normal(b["imgs"].shape).astype(
        np.float32)
    imgs[0, :3, :3] = 0.0                     # zeros for the divisions
    imgs[1, 5, 5] = -1.0                      # a negative for sqrt and log
    save_image(str(d / "s.mrcs"), imgs)
    save_image(str(d / "s.stk"), imgs)
    rows = [{"image": f"{i + 1:06d}@{d / 's.mrcs'}", "itemId": i + 1,
             "angleRot": float(b["rot"][i]), "angleTilt": float(b["tilt"][i]),
             "anglePsi": float(b["psi"][i]), "shiftX": float(b["sx"][i]),
             "shiftY": float(b["sy"][i]), "weight": float(b["w"][i])}
            for i in range(C)]
    MetaData.fromRows(rows).write(str(d / "s.xmd"))
    plain = [{k: v for k, v in r.items() if k not in (
        "anglePsi", "shiftX", "shiftY")} for r in rows]
    MetaData.fromRows(plain).write(str(d / "plain.xmd"))
    op = rng.standard_normal((N, N)).astype(np.float32)
    op[3, 3] = 0.0
    save_image(str(d / "op.xmp"), op)
    save_image(str(d / "v.vol"), phantom8(16))
    return d


def both(name, args_of, device=True):
    """Run `name` through both dispatchers; args_of(tag) gives each run's
    arguments (tag "j" for the reference, "t" for the port). Returns the
    two runs' standard output."""
    outs = []
    for tag, prog in (("j", jax_program), ("t", get_program)):
        tail = ["-v", "0"] + (["--device", "cpu"] if tag == "t" and device
                              else [])
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = prog(name).run_with_args(args_of(tag) + tail)
        assert rc == 0, (tag, name)
        outs.append(buf.getvalue())
    return outs


def stack(path):
    return np.asarray(Image(str(path)).data)


def hold_stacks(d, name, tol=0.0):
    want, got = stack(d / "j" / name), stack(d / "t" / name)
    assert got.shape == want.shape
    if tol == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


def rows(path, block=None):
    md = MetaData(str(path), block=block)
    return [md.getRow(i) for i in md]


def _same(a, b):
    if isinstance(a, str):
        return a.replace("/j/", "/t/") == b
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b or (a != a and b != b)


def hold_rows(want, got, close=None):
    """Equal rows (the j/ and t/ directories aside); close: {label: tol}
    relative to the label's max |value|."""
    close = close or {}
    assert len(got) == len(want)
    for k in (want[0] if want else {}):
        if k in close:
            a = np.array([r[k] for r in want], np.float64)
            b = np.array([r[k] for r in got], np.float64)
            assert np.abs(a - b).max() <= close[k] * max(np.abs(a).max(),
                                                         1e-30), k
            continue
        for r, s in zip(want, got):
            assert _same(r[k], s[k]), (k, r[k], s[k])
    assert [list(r) for r in want] == [list(r) for r in got]


def md_pair(d, name, block=None):
    return rows(d / "j" / name, block), rows(d / "t" / name, block)


# -- image programs ----------------------------------------------------------

EXACT_OPS = [("plus", "2.5"), ("minus", "OP"), ("mult", "0.5"),
             ("divide", "OP"), ("min", "OP"), ("max", "0.1"), ("abs", None),
             ("square", None), ("reset", None)]
ROUND_OPS = [("sqrt", None), ("log", None), ("log10", None), ("exp", None),
             ("pow", "3"), ("divide", "0.3")]


@pytest.mark.parametrize("op,arg", EXACT_OPS + ROUND_OPS,
                         ids=lambda v: str(v))
def test_image_operate_matches_the_reference(data, op, arg):
    d = data
    name = f"op_{op}_{arg}.mrcs".replace("/", "")
    val = [] if arg is None else [str(d / "op.xmp") if arg == "OP" else arg]
    both("image_operate", lambda t: ["-i", str(d / "s.mrcs"), "-o",
                                     str(d / t / name), f"--{op}", *val])
    exact = (op, arg) in EXACT_OPS
    hold_stacks(d, name, 0.0 if exact else 1e-6)


def test_image_operate_takes_a_stack_operand_row_by_row(data, tmp_path):
    """An operand with one image per input image: the port adds row i to
    image i in every batch (batches of 2 here); the reference broadcasts
    the operand against its whole batch, which works for one batch."""
    d = data
    both("image_operate", lambda t: ["-i", str(d / "s.mrcs"), "-o",
                                     str(d / t / "op_stack.mrcs"),
                                     "--minus", str(d / "s.mrcs")])
    hold_stacks(d, "op_stack.mrcs")
    assert not stack(d / "t" / "op_stack.mrcs").any()
    prog = get_program("image_operate")
    prog.batch_size = 2
    assert prog.run_with_args(["-i", str(d / "s.mrcs"), "-o",
                               str(tmp_path / "o.mrcs"), "--plus",
                               str(d / "s.mrcs"), "--device", "cpu", "-v",
                               "0"]) == 0
    np.testing.assert_array_equal(stack(tmp_path / "o.mrcs"),
                                  2 * stack(d / "s.mrcs"))


WINDOW = {
    "pad": (["--size", "40"], "s.mrcs"),
    "crop": (["--size", "24", "20"], "s.mrcs"),
    "crop_px": (["--crop", "4"], "s.mrcs"),
    "corner": (["--size", "40", "--pad", "corner"], "s.mrcs"),
    "avg": (["--size", "36", "--pad", "avg"], "s.mrcs"),
    "fill": (["--size", "36", "--fill_value", "2"], "s.mrcs"),
    "corners": (["--corners", "-10", "-8", "12", "9"], "s.mrcs"),
    "physical": (["--corners", "2", "3", "20", "30", "--physical"],
                 "s.mrcs"),
    "volume": (["--size", "20"], "v.vol"),
    "volume_corners": (["--corners", "-4", "-5", "-6", "3", "4", "5"],
                       "v.vol"),
    "unitcell": (["--unitcell", "c4", "1", "7"], "v.vol"),
}


@pytest.mark.parametrize("case", list(WINDOW))
def test_transform_window_matches_the_reference(data, case):
    d = data
    flags, src = WINDOW[case]
    ext = ".vol" if src == "v.vol" else ".mrcs"
    both("transform_window", lambda t: ["-i", str(d / src), "-o",
                                        str(d / t / f"win_{case}{ext}"),
                                        *flags])
    hold_stacks(d, f"win_{case}{ext}")


NOISE = {
    "gaussian": ["--type", "gaussian", "0.5", "0.1"],
    "student": ["--type", "student", "4", "0.3", "0.0"],
    "uniform": ["--type", "uniform", "-0.2", "0.4"],
    "limits": ["--type", "gaussian", "1", "0", "--limit0", "-0.5",
               "--limitF", "0.7"],
}


@pytest.mark.parametrize("case", list(NOISE))
def test_transform_add_noise_matches_the_reference(data, case):
    """The same Generator(seed) draws, cast to float32 and added: equal."""
    d = data
    both("transform_add_noise", lambda t: ["-i", str(d / "s.mrcs"), "-o",
                                           str(d / t / f"noise_{case}.mrcs"),
                                           "--seed", "11", *NOISE[case]])
    hold_stacks(d, f"noise_{case}.mrcs")


THRESHOLD = {
    "below": ["--select", "below", "0.1"],
    "above_binarize": ["--select", "above", "0.5", "--substitute",
                       "binarize"],
    "abs_below_value": ["--select", "abs_below", "0.3", "--substitute",
                        "value", "-2"],
    "noise": ["--select", "below", "0.0", "--substitute", "noise", "1",
              "0.5"],
}


@pytest.mark.parametrize("case", list(THRESHOLD))
def test_transform_threshold_matches_the_reference(data, case):
    d = data
    both("transform_threshold", lambda t: ["-i", str(d / "s.mrcs"), "-o",
                                           str(d / t / f"thr_{case}.mrcs"),
                                           *THRESHOLD[case]])
    hold_stacks(d, f"thr_{case}.mrcs")


@pytest.mark.parametrize("flags,src", [
    (["--flipX"], "s.mrcs"), (["--flipY"], "s.mrcs"),
    (["--flipX", "--flipY"], "s.mrcs"), (["--flipZ", "--flipX"], "v.vol")],
    ids=["x", "y", "xy", "volume_zx"])
def test_transform_mirror_matches_the_reference(data, flags, src):
    d = data
    name = "mir" + "".join(flags).replace("--flip", "_") + \
        os.path.splitext(src)[1]
    both("transform_mirror", lambda t: ["-i", str(d / src), "-o",
                                        str(d / t / name), *flags])
    hold_stacks(d, name)


def test_transform_randomize_phases_matches_the_reference(data):
    d = data
    both("transform_randomize_phases", lambda t: [
        "-i", str(d / "s.mrcs"), "-o", str(d / t / "rph.mrcs"), "--freq",
        "0.15", "--seed", "4"])
    hold_stacks(d, "rph.mrcs", 1e-5)
    a = np.abs(np.fft.rfft2(stack(d / "t" / "rph.mrcs")))
    b = np.abs(np.fft.rfft2(stack(d / "s.mrcs")))
    assert np.abs(a - b).max() <= 1e-4 * b.max()     # amplitudes kept


def test_transform_downsample_matches_the_reference(data):
    d = data
    both("transform_downsample", lambda t: [
        "-i", str(d / "s.mrcs"), "-o", str(d / t / "down.mrcs"), "--step",
        "2"])
    hold_stacks(d, "down.mrcs", 1e-5)
    assert stack(d / "t" / "down.mrcs").shape == (C, N // 2, N // 2)


RESIZE = {"fourier": (["--fourier", "--dim", "16"], 1e-5),
          "fourier_up": (["--fourier", "--factor", "1.5"], 1e-5),
          "spline": (["--dim", "20", "24"], 1e-5),
          "linear": (["--factor", "0.75", "--interp", "linear"], 1e-5)}


@pytest.mark.parametrize("case", list(RESIZE))
def test_image_resize_matches_the_reference(data, case):
    d = data
    flags, tol = RESIZE[case]
    both("image_resize", lambda t: ["-i", str(d / "s.mrcs"), "-o",
                                    str(d / t / f"rs_{case}.mrcs"), *flags])
    hold_stacks(d, f"rs_{case}.mrcs", tol)


def test_image_convert_round_trip_matches_the_reference(data):
    d = data
    both("image_convert", lambda t: ["-i", str(d / "plain.xmd"), "-o",
                                     str(d / t / "conv.stk")])
    hold_stacks(d, "conv.stk")
    np.testing.assert_array_equal(stack(d / "t" / "conv.stk"),
                                  stack(d / "s.mrcs"))
    both("image_convert", lambda t: ["-i", str(d / t / "conv.stk"), "-o",
                                     str(d / t / "back.mrcs")])
    hold_stacks(d, "back.mrcs")
    np.testing.assert_array_equal(stack(d / "t" / "back.mrcs"),
                                  stack(d / "s.mrcs"))
    both("image_convert", lambda t: ["-i", str(d / "s.mrcs"), "-o",
                                     str(d / t / "u8.mrcs"), "--depth",
                                     "uint8", "--range_adjust"])
    hold_stacks(d, "u8.mrcs")
    both("image_convert", lambda t: ["-i", str(d / "s.mrcs"), "-o",
                                     str(d / t / "big.mrc"), "--swap",
                                     "big"])
    assert (d / "j" / "big.mrc").read_bytes() == \
        (d / "t" / "big.mrc").read_bytes()


def test_image_convert_applies_the_rows_geometry(data):
    d = data
    both("image_convert", lambda t: ["-i", str(d / "s.xmd"), "-o",
                                     str(d / t / "geo.mrcs")])
    hold_stacks(d, "geo.mrcs", 1e-5)
    assert np.abs(stack(d / "t" / "geo.mrcs") - stack(d / "s.mrcs")).max() \
        > 0.1


def test_image_header_matches_the_reference(data):
    d = data
    for t in "jt":
        save_image(str(d / t / "h.stk"), stack(d / "s.mrcs"))
    outs = both("image_header", lambda t: ["-i", str(d / t / "h.stk")])
    assert outs[0].replace("/j/", "/t/") == outs[1]
    both("image_header", lambda t: ["-i", str(d / t / "h.stk"),
                                    "--sampling_rate", "2.5"])
    outs = both("image_header", lambda t: ["-i", str(d / t / "h.stk"),
                                           "--sampling_rate"])
    assert outs[0].replace("/j/", "/t/") == outs[1]
    assert "2.5000" in outs[1]
    for t in "jt":
        md = MetaData(str(d / "s.xmd"))
        md.setColumnValues("image", [f"{i + 1:06d}@{d / t / 'h.stk'}"
                                     for i in range(C)])
        md.write(str(d / t / "geo_rows.xmd"))
    both("image_header", lambda t: ["-i", str(d / t / "geo_rows.xmd"),
                                    "--assign", "--round_shifts"])
    assert (d / "j" / "h.stk").read_bytes() == (d / "t" / "h.stk").read_bytes()
    both("image_header", lambda t: ["-i", str(d / t / "h.stk"), "--extract",
                                    "-o", str(d / t / "hdr.xmd")])
    hold_rows(*md_pair(d, "hdr.xmd"))
    outs = both("image_header", lambda t: ["-i", str(d / t / "h.stk"),
                                           "--print", "1"])
    assert outs[0].replace("/j/", "/t/") == outs[1]
    both("image_header", lambda t: ["-i", str(d / t / "h.stk"), "--reset"])
    assert (d / "j" / "h.stk").read_bytes() == (d / "t" / "h.stk").read_bytes()


STATS = {"plain": [], "mask": ["--mask", "circular", "10", "--save_mask",
                               "MASK"],
         "image_stats": ["--save_image_stats", "ROOT"]}


@pytest.mark.parametrize("case", list(STATS))
def test_image_statistics_matches_the_reference(data, case):
    d = data

    def args(t):
        sub = {"MASK": str(d / t / "mask.xmp"), "ROOT": str(d / t / "st_")}
        return ["-i", str(d / "s.xmd"), "-o", str(d / t / f"st_{case}.xmd"),
                *[sub.get(a, a) for a in STATS[case]]]
    both("image_statistics", args)
    want, got = md_pair(d, f"st_{case}.xmd")
    hold_rows(want, got, {k: 1e-5 for k in ("min", "max", "avg", "stddev")})
    if case == "mask":
        hold_stacks(d, "mask.xmp")
    if case == "image_stats":
        hold_stacks(d, "st_average.xmp", 1e-6)
        hold_stacks(d, "st_stddev.xmp", 1e-5)


@pytest.mark.parametrize("flags", [
    ["--steps", "20"], ["--steps", "7", "--range", "-0.5", "1.5", "--norm"],
    ["--range", "0.2", "0.2"]], ids=["steps", "range_norm", "empty_range"])
def test_image_histogram_matches_the_reference(data, flags):
    d = data
    name = "hist_" + "_".join(flags).replace("-", "") + ".xmd"
    both("image_histogram", lambda t: ["-i", str(d / "s.mrcs"), "-o",
                                       str(d / t / name), *flags])
    hold_rows(*md_pair(d, name))


def test_histogram_counts_equal_numpy_at_bin_edges():
    """Values on the linspace edges and at the range's ends land in
    numpy's bins."""
    from xmipp3_tpu_torch.programs.image_misc import histogram
    edges = np.linspace(-1.3, 2.9, 8)
    v = np.concatenate([edges, np.nextafter(edges, np.inf),
                        np.nextafter(edges, -np.inf), [-5.0, 5.0]])
    v = v.astype(np.float32)
    got, e = histogram(torch.as_tensor(v), 7, -1.3, 2.9)
    want, we = np.histogram(v, bins=7, range=(-1.3, 2.9))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(e, we)


def test_refused_values_of_unread_flags(data, tmp_path):
    """transform_downsample --method smooth and image_statistics --mask
    with another type: the reference accepts them and does the Fourier
    crop and the circle; the port refuses them."""
    from xmipp3_tpu_torch.core.errors import XmippError
    d = data
    with pytest.raises(XmippError, match="--method smooth"):
        get_program("transform_downsample").run_with_args(
            ["-i", str(d / "s.mrcs"), "-o", str(tmp_path / "x.mrcs"),
             "--step", "2", "--method", "smooth", "--device", "cpu"])
    assert not (tmp_path / "x.mrcs").exists()
    assert get_program("image_statistics").run_with_args(
        ["-i", str(d / "s.mrcs"), "--mask", "rectangular", "5", "--device",
         "cpu", "-v", "0"]) == 1


# -- metadata programs -------------------------------------------------------

@pytest.fixture(scope="module")
def mds(data):
    d = data
    for t in "jt":
        MetaData.fromRows([
            {"image": f"img{i:03d}.spi", "angleRot": 10.0 * i,
             "cost": float(i)} for i in range(1, 7)]).write(str(d / t / "a.xmd"))
        MetaData.fromRows([
            {"image": f"img{i:03d}.spi", "weight": 0.5 * i}
            for i in (2, 4, 9)]).write(str(d / t / "b.xmd"))
        MetaData.fromRows([{"image": "img002.spi", "angleRot": 20.0,
                            "cost": 2.0},
                           {"image": "img099.spi", "angleRot": 0.0,
                            "cost": 9.0}]).write(str(d / t / "c.xmd"))
        MetaData.fromRows([{"ref": f"img{i:03d}.spi", "score": float(i)}
                           for i in (1, 3)]).write(str(d / t / "r.xmd"))
        MetaData.fromRows([{"extra": float(i)} for i in range(6)]).write(
            str(d / t / "m.xmd"))
        MetaData.fromRows([
            {"image": "a", "nmaDisplacements": np.array([3.0, 0.0])},
            {"image": "b", "nmaDisplacements": np.array([1.0, 5.0])},
            {"image": "c", "nmaDisplacements": np.array([2.0, 1.0])},
        ]).write(str(d / t / "v.xmd"))
        MetaData.fromRows([{"defocusGroup": i % 2, "count": 1.0 + i}
                           for i in range(6)]).write(str(d / t / "g.xmd"))
        MetaData.fromRows([{"ctfDefocusU": 15000.0,
                            "ctfVoltage": 300.0}]).write(
                                str(d / t / "ctf.xmd"))
        MetaData.fromRows([{"image": f"i{i}", "ctfModel": str(
            d / t / "ctf.xmd")} for i in range(3)]).write(
                str(d / t / "parts.xmd"))
        with open(d / t / "cols.txt", "w") as fh:
            fh.write("# comment\n1 4.5 a.spi\n2 6.5 b.spi\n")
    return d


MDU = {  # case -> (input, flags); A, B, ... name files of the run's dir
    "union": ("a", ["--set", "union", "C", "image"]),
    "union_all": ("a", ["--set", "union_all", "C", "image"]),
    "intersection": ("a", ["--set", "intersection", "B", "image"]),
    "subtraction": ("a", ["--set", "subtraction", "B", "image"]),
    "join": ("a", ["--set", "join", "B", "image"]),
    "natural_join": ("a", ["--set", "natural_join", "B"]),
    "inner_join": ("a", ["--set", "inner_join", "R", "image", "ref"]),
    "merge": ("a", ["--set", "merge", "M"]),
    "sort_desc": ("a", ["--operate", "sort", "cost", "desc"]),
    "percentile": ("a", ["--operate", "percentile", "cost", "pmax"]),
    "modify_values": ("a", ["--operate", "modify_values",
                            "angleRot=sin(radians(angleRot))"]),
    "modify_where": ("a", ["--operate", "modify_values",
                           "cost=0 WHERE angleRot>30"]),
    "randomize": ("a", ["--operate", "randomize"]),
    "expand": ("a", ["--operate", "expand", "3"]),
    "keep_column": ("a", ["--operate", "keep_column", "image cost"]),
    "drop_column": ("a", ["--operate", "drop_column", "cost"]),
    "rename_column": ("a", ["--operate", "rename_column", "cost wRobust"]),
    "remove_duplicates": ("c", ["--operate", "remove_duplicates", "cost"]),
    "sort_vector": ("v", ["--operate", "sort", "nmaDisplacements:0"]),
    "select": ("a", ["--query", "select", "angleRot > 15 AND cost < 5"]),
    "count": ("g", ["--query", "count", "defocusGroup"]),
    "sum": ("g", ["--query", "sum", "defocusGroup", "count"]),
    "fill_constant": ("a", ["--fill", "shiftX shiftY", "constant", "5"]),
    "fill_lineal": ("a", ["--fill", "w", "lineal", "1", "2"]),
    "fill_expand": ("parts", ["--fill", "ctfModel", "expand"]),
    "import_txt": ("cols.txt", ["--file", "import_txt", "itemId cost image"]),
}


@pytest.mark.parametrize("case", list(MDU))
def test_metadata_utilities_matches_the_reference(mds, case):
    d = mds
    src, flags = MDU[case]

    def args(t):
        f = lambda n: str(d / t / (n if "." in n else n + ".xmd"))
        flag = [f(a.lower()) if a in ("B", "C", "R", "M") else a
                for a in flags]
        return ["-i", f(src), "-o", str(d / t / f"mdu_{case}.xmd"), *flag]
    both("metadata_utilities", args, device=False)
    hold_rows(*md_pair(d, f"mdu_{case}.xmd"))


@pytest.mark.parametrize("flags,size", [
    (["--operate", "random_subset", "3"], 3), (["--operate", "bootstrap"], 6),
    (["--fill", "r", "rand_uniform", "2", "3"], 6),
    (["--fill", "r", "rand_gaussian", "0", "1"], 6),
    (["--fill", "r", "rand_student", "0", "1", "3"], 6)],
    ids=["random_subset", "bootstrap", "uniform", "gaussian", "student"])
def test_metadata_utilities_unseeded_draws(mds, flags, size):
    """The reference draws these from an unseeded Generator: the port's
    rows have the reference's shape, order rule and range."""
    d = mds
    both("metadata_utilities", lambda t: [
        "-i", str(d / t / "a.xmd"), "-o", str(d / t / "mdu_draw.xmd"),
        *flags], device=False)
    want, got = md_pair(d, "mdu_draw.xmd")
    assert len(got) == len(want) == size
    assert [list(r) for r in got] == [list(r) for r in want]
    if flags[0] == "--operate":
        names = [r["image"] for r in got]
        assert names == sorted(names)
    if flags[2:3] == ["rand_uniform"]:
        assert all(2 <= r["r"] <= 3 for r in got)


def test_metadata_utilities_queries_print_and_modes(mds):
    d = mds
    for q in ("size", "labels", "blocks"):
        outs = both("metadata_utilities", lambda t: [
            "-i", str(d / t / "a.xmd"), "--query", q], device=False)
        assert outs[0].replace("/j/", "/t/") == outs[1]
    outs = both("metadata_utilities", lambda t: [
        "-i", str(d / t / "a.xmd"), "-o", str(d / t / "pr.xmd"),
        "--print"], device=False)
    assert outs[0] == outs[1]
    both("metadata_utilities", lambda t: [
        "-i", str(d / t / "a.xmd"), "-o", f"b2@{d / t / 'pr.xmd'}",
        "--operate", "sort", "cost", "--mode", "append"], device=False)
    assert (d / "j" / "pr.xmd").read_text() == \
        (d / "t" / "pr.xmd").read_text()


def test_metadata_utilities_file_operations(mds):
    d = mds
    for t in "jt":
        src = d / t / "files"
        src.mkdir()
        for i in range(2):
            (src / f"f{i}.spi").write_bytes(b"x" * 8)
        MetaData.fromRows([{"image": str(src / f"f{i}.spi")}
                           for i in range(2)]).write(str(d / t / "f.xmd"))
    both("metadata_utilities", lambda t: [
        "-i", str(d / t / "f.xmd"), "-o", str(d / t / "fc.xmd"), "--file",
        "copy", str(d / t / "copied"), "image"], device=False)
    hold_rows(*md_pair(d, "fc.xmd"))
    assert sorted(os.listdir(d / "t" / "copied")) == ["f0.spi", "f1.spi"]
    both("metadata_utilities", lambda t: [
        "-i", str(d / t / "f.xmd"), "--file", "delete", "image"],
        device=False)
    assert not list((d / "t" / "files").iterdir())


SPLIT = {"random": ["-n", "3"], "ordered": ["-n", "2", "--dont_randomize"],
         "unsorted": ["-n", "4", "--dont_sort", "--seed", "5"],
         "label": ["-n", "2", "-l", "weight"],
         "correlation": ["-n", "2", "--use_correlation", "CC", "20", "3"]}


@pytest.mark.parametrize("case", list(SPLIT))
def test_metadata_split_matches_the_reference(data, case):
    d = data
    rng = np.random.default_rng(2)
    save_image(str(d / "cc.xmp"), rng.standard_normal((C, 9)).astype(
        np.float32))

    def args(t):
        (d / t / f"sp_{case}").mkdir(exist_ok=True)
        return ["-i", str(d / "s.xmd"), "--oroot",
                str(d / t / f"sp_{case}" / "part"),
                *[str(d / "cc.xmp") if a == "CC" else a
                  for a in SPLIT[case]]]
    both("metadata_split", args, device=False)
    names = sorted(os.listdir(d / "j" / f"sp_{case}"))
    assert names == sorted(os.listdir(d / "t" / f"sp_{case}")) and names
    for n in names:
        hold_rows(*md_pair(d, f"sp_{case}/{n}"))


def test_metadata_import_matches_the_reference(data):
    d = data
    with open(d / "cols.txt", "w") as fh:
        fh.write("; comment\n" + "".join(f"{i} {0.25 * i} x{i}.spi\n"
                                          for i in range(C)))
    both("metadata_import", lambda t: [
        "-i", str(d / "cols.txt"), "-o", str(d / t / "imp.xmd"), "--labels",
        "itemId defocusU image2"], device=False)
    hold_rows(*md_pair(d, "imp.xmd"))
    both("metadata_import", lambda t: [
        "-i", str(d / "cols.txt"), "-o", str(d / t / "imp_m.xmd"), "-l",
        "ref", "score", "--merge", str(d / "s.xmd")], device=False)
    hold_rows(*md_pair(d, "imp_m.xmd"))


def test_metadata_histogram_matches_the_reference(data):
    d = data
    outs = both("metadata_histogram", lambda t: [
        "-i", str(d / "s.xmd"), "--col", "angleRot", "-o",
        str(d / t / "mh.xmd"), "--steps", "5", "--percentil", "30"],
        device=False)
    assert outs[0] == outs[1]
    hold_rows(*md_pair(d, "mh.xmd"))
    both("metadata_histogram", lambda t: [
        "-i", str(d / "s.xmd"), "--col", "angleRot", "--col2", "angleTilt",
        "--steps", "4", "--steps2", "3", "--range2", "0", "180", "-o",
        str(d / t / "mh2.xmd"), "--write_as_image",
        str(d / t / "mh2.xmp")], device=False)
    hold_rows(*md_pair(d, "mh2.xmd"))
    hold_stacks(d, "mh2.xmp")


ANGDIST = {"default": [], "sym": ["--sym", "c4", "--check_mirrors"],
           "object": ["--object_rotation", "--check_mirrors"],
           "averages": ["--compute_average_angle", "--compute_average_shift",
                        "--set", "0", "--ang", "2"],
           "weights": ["--compute_weights", "2", "itemId", "1"]}


@pytest.mark.parametrize("case", list(ANGDIST))
def test_angular_distance_matches_the_reference(data, case):
    d = data
    rng = np.random.default_rng(9)
    md = MetaData(str(d / "s.xmd"))
    for k, s in (("angleRot", 20), ("angleTilt", 10), ("anglePsi", 30),
                 ("shiftX", 1)):
        md.setColumnValues(k, (md.getColumn(k) + rng.normal(0, s, C))
                           .tolist())
    for t in "jt":
        md.write(str(d / t / f"ang2_{case}.xmd"))
    both("angular_distance", lambda t: [
        "--ang1", str(d / "s.xmd"), "--ang2", str(d / t / f"ang2_{case}.xmd"),
        "--oroot", str(d / t / f"ad_{case}"), *ANGDIST[case]], device=False)
    out = "_weights.xmd" if case == "weights" else ".xmd"
    hold_rows(*md_pair(d, f"ad_{case}{out}"))
    if case == "weights":
        hold_rows(*md_pair(d, f"ang2_{case}.xmd"))


ROTATE = {"euler": ["--rotate", "10", "20", "30"], "ang": ["--ang", "15"],
          "alignZ": ["--alignZ", "0", "1", "1"],
          "axis": ["--axis", "30", "1", "0", "0", "--write_matrix"]}


def _pose_angle_deg(a, b):
    """Per-row angle between the rotations of two pose tables: the float64
    Euler matrices' ||A^T B - I||_F / sqrt(2)."""
    from xmipp3_tpu_torch.programs.metadata_misc import _euler_matrix64
    mats = [np.stack([_euler_matrix64(r["angleRot"], r["angleTilt"],
                                      r["anglePsi"]) for r in rs])
            for rs in (a, b)]
    rel = np.einsum("nji,njk->nik", *mats) - np.eye(3)
    return np.degrees(np.linalg.norm(rel, axis=(1, 2)) / np.sqrt(2))


@pytest.mark.parametrize("case", list(ROTATE))
def test_angular_rotate_matches_the_reference(data, case):
    """The same rows and columns; each pose within 1e-3 degrees of the
    reference's as a rotation (the port composes in float64, the
    reference in float32), the printed matrix to its 6 decimals."""
    d = data
    outs = both("angular_rotate", lambda t: [
        "-i", str(d / "s.xmd"), "-o", str(d / t / f"rot_{case}.xmd"),
        *ROTATE[case]], device=False)
    num = lambda o: np.array([float(v) for v in
                              o.replace("[", " ").replace("]", " ").split()])
    assert np.abs(num(outs[0]) - num(outs[1])).max(initial=0) <= 2e-6
    want, got = md_pair(d, f"rot_{case}.xmd")
    angles = ("angleRot", "angleTilt", "anglePsi")
    hold_rows([{k: v for k, v in r.items() if k not in angles}
               for r in want],
              [{k: v for k, v in r.items() if k not in angles}
               for r in got])
    assert _pose_angle_deg(got, want).max() <= 1e-3


def test_angular_rotate_keeps_the_in_plane_angle_at_a_pole(tmp_path):
    """A view at the pole (tilt 0, psi 122): rotated and rotated back, the
    port's pose is the input's within 1e-3 degrees; the reference's
    float32 composition leaves a 1e-6 tilt whose noise sets rot + psi
    (ROADMAP.md section 3, item 12)."""
    rows = [{"angleRot": 0.0, "angleTilt": 0.0, "anglePsi": 121.982666},
            {"angleRot": 40.0, "angleTilt": 180.0, "anglePsi": -70.0},
            {"angleRot": 15.0, "angleTilt": 50.0, "anglePsi": 33.0}]
    MetaData.fromRows(rows).write(str(tmp_path / "in.xmd"))
    err = {}
    for tag, prog in (("j", jax_program), ("t", get_program)):
        run = lambda *a: prog("angular_rotate").run_with_args([*a, "-v", "0"])
        assert run("-i", str(tmp_path / "in.xmd"), "-o",
                   str(tmp_path / f"r{tag}.xmd"), "--rotate", "10", "20",
                   "30") == 0
        assert run("-i", str(tmp_path / f"r{tag}.xmd"), "-o",
                   str(tmp_path / f"b{tag}.xmd"), "--rotate", "-30", "-20",
                   "-10") == 0
        back = MetaData(str(tmp_path / f"b{tag}.xmd"))
        err[tag] = _pose_angle_deg(rows, [back.getRow(i) for i in back])
    assert err["t"].max() <= 1e-3
    assert err["j"][2] <= 1e-3 and err["j"][:2].max() > 1.0


def test_angular_rotate_and_its_inverse_give_the_poses_back(data, tmp_path):
    """--rotate a b c, then the inverse rotation (-c, -b, -a): every pose
    within 1e-3 degrees of the input."""
    d = data
    run = lambda *a: get_program("angular_rotate").run_with_args(
        [*a, "-v", "0"])
    assert run("-i", str(d / "s.xmd"), "-o", str(tmp_path / "r.xmd"),
               "--rotate", "10", "20", "30") == 0
    assert run("-i", str(tmp_path / "r.xmd"), "-o", str(tmp_path / "b.xmd"),
               "--rotate", "-30", "-20", "-10") == 0
    assert _pose_angle_deg(rows(d / "s.xmd"),
                           rows(tmp_path / "b.xmd")).max() <= 1e-3


def test_metadata_convert_emx_round_trip_matches_the_reference(data):
    d = data
    for t in "jt":
        md = MetaData(str(d / "s.xmd"))
        md.setColumnValues("ctfDefocusU", [15000.0 + i for i in range(C)])
        md.setColumnValues("ctfVoltage", [300.0] * C)
        md.setColumnValues("sampling_rate", [1.5] * C)
        md.setColumnValues("xcoor", [10.0 * i for i in range(C)])
        md.write(str(d / t / "emx_in.xmd"))
    both("metadata_convert_emx", lambda t: [
        "-i", str(d / t / "emx_in.xmd"), "-o", str(d / t / "x.emx")],
        device=False)
    assert (d / "j" / "x.emx").read_text().replace("/j/", "/t/") == \
        (d / "t" / "x.emx").read_text()
    both("metadata_convert_emx", lambda t: [
        "-i", str(d / t / "x.emx"), "-o", str(d / t / "emx_back.xmd")],
        device=False)
    want, got = md_pair(d, "emx_back.xmd")
    hold_rows(want, got)
    assert [r["ctfDefocusU"] for r in got] == \
        [15000.0 + i for i in range(C)]


# -- the registry ------------------------------------------------------------

def _signature(prog):
    """A program's grammar without its help text."""
    g = prog._grammar

    def args(defs):
        return tuple((a.name, a.default, a.is_rest,
                      tuple((c, args(v)) for c, v in a.choices.items()))
                     for a in defs)
    return ([(n, p.optional, tuple(p.aliases), tuple(p.requires),
              args(p.args)) for n, p in ((n, g.params[n]) for n in g.order)],
            sorted(g._choice_requires.items()))


def _every_endpoint():
    from xmipp3_tpu_torch.programs import list_programs
    return list_programs()


@pytest.mark.parametrize("name", _every_endpoint())
def test_grammar_equals_the_reference(name):
    """Every registered endpoint of the port, programs and aliases, parses
    the reference's grammar: the same flags, defaults and aliases."""
    assert _signature(get_program(name)) == _signature(jax_program(name))


@pytest.mark.parametrize("alias", NEW_ALIASES)
def test_new_alias_dispatches_to_its_program(alias):
    assert type(get_program(alias)) is type(get_program(ALIASES[alias]))
    assert type(jax_program(alias)).__name__ == \
        type(get_program(alias)).__name__


def test_the_registry_holds_85_endpoints():
    from xmipp3_tpu_torch.programs import list_programs
    import test_torch_cli_analysis as analysis
    import test_torch_cli_angular as angular
    import test_torch_cli_flex as flex
    import test_torch_cli_flex_tail as flex_tail
    import test_torch_cli_micrograph as micrograph
    import test_torch_cli_misc as misc
    import test_torch_cli_tail as tail
    import test_torch_cli_tomo as tomo
    import test_torch_cli_volume as volume
    names = set(list_programs())
    assert set(NEW) | set(NEW_ALIASES) <= names
    # the endpoints of later slices (tests/test_torch_cli_angular.py,
    # tests/test_torch_cli_analysis.py, tests/test_torch_cli_micrograph.py,
    # tests/test_torch_cli_misc.py, tests/test_torch_cli_volume.py,
    # tests/test_torch_cli_flex.py, tests/test_torch_cli_flex_tail.py,
    # tests/test_torch_cli_tomo.py, tests/test_torch_cli_tail.py) aside
    later = set().union(*(set(m.NEW) | set(m.NEW_ALIASES)
                          for m in (angular, analysis, micrograph, misc,
                                    volume, flex, flex_tail, tomo, tail)))
    assert len(names - later) == 85 and len(set(ALIASES) - later) == 27


DEVICE_PROGRAMS = {
    "image_operate": ["-i", "x.mrcs", "--plus", "1"],
    "transform_window": ["-i", "x.mrcs", "--size", "8"],
    "transform_add_noise": ["-i", "x.mrcs"],
    "transform_threshold": ["-i", "x.mrcs", "--select", "below", "0"],
    "transform_mirror": ["-i", "x.mrcs", "--flipX"],
    "transform_randomize_phases": ["-i", "x.mrcs"],
    "transform_downsample": ["-i", "x.mrcs", "--step", "2"],
    "image_resize": ["-i", "x.mrcs", "--dim", "8"],
    "image_statistics": ["-i", "x.mrcs"],
    "image_histogram": ["-i", "x.mrcs"],
    "reconstruct_art": ["-i", "x.xmd"],
    "reconstruct_wbp": ["-i", "x.xmd"],
    "reconstruct_significant": ["-i", "x.xmd"],
    "align_significant": ["-i", "x.xmd", "-r", "r.xmd", "-o", "o.xmd"],
}


@pytest.mark.parametrize("name", list(DEVICE_PROGRAMS))
def test_programs_without_a_card_raise(monkeypatch, name):
    """Without --device cpu each program asks for the card before it reads
    anything, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog = get_program(name)
    prog.read(["xmipp_" + name, *DEVICE_PROGRAMS[name]])
    with pytest.raises(RuntimeError, match="--device cpu"):
        prog.run()
