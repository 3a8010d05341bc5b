"""The last programs of final_batch and scripts_misc against the reference
package's on the same files, on the CPU (the 8-blob phantom at N=32, 24
views at known poses, small atomic models, a 128^2 micrograph), the port
with --device cpu; and the registry's 257 endpoints.

Tolerances, relative to the max of the reference's output where not said:
- metadata_xml, metadata_split_3D, coordinates_noisy_zones_filter,
  pdb_analysis, pdb_label_from_volume, pdb_reduce_pseudoatoms (both
  modes), pdb_sph_deform, compare_density, metadata_selfile_create,
  pdb_center, pdb_select, coordinates_consensus, pick_noise,
  graph_max_cut, extract_particles: equal files or rows (the same host
  arithmetic, or float64 on the device to the printed digits);
- volumeset_align: the same angles and maxCC 1e-4;
- ctf_correct_wiener3d: 1e-5 (float64 FFTs of float32 CTFs in both);
- transform_adjust_volume_grey_levels: a and b 1e-4 relative (float32
  projections), the map 1e-4;
- preprocess_mics: 1e-4 (float32 FFTs); volume_consensus: 1e-5 (float32
  Haar bands); cl2d_clustering and the swiftalign classification: the
  same labels (up to their order), averages 1e-5; align_pca_2d: the
  aligned images and average 1e-4, the eigenimages and projections up
  to each axis's sign 1e-3 (EM-PCA in float32 on both sides);
  swiftalign_wiener_2d: 1e-5.
"""
import numpy as np
import pytest
import torch

from test_torch_cli_analysis import aligned, both, rel, rows, vol
from test_torch_project import phantom8
from xmipp3_tpu.programs import get_program as jax_program
from xmipp3_tpu_torch.core.image import save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.pdb import AtomicModel, write_pdb
from xmipp3_tpu_torch.ops.project import FourierProjector
from xmipp3_tpu_torch.programs import ALIASES, get_program

torch.set_num_threads(1)

N, B = 32, 24
NEW = ["metadata_xml", "metadata_split_3D", "coordinates_noisy_zones_filter",
       "volumeset_align", "pdb_analysis", "pdb_label_from_volume",
       "pdb_reduce_pseudoatoms", "pdb_sph_deform", "compare_density",
       "ctf_correct_wiener3d", "transform_adjust_volume_grey_levels",
       "metadata_selfile_create", "pdb_center", "pdb_select",
       "coordinates_consensus", "pick_noise", "preprocess_mics",
       "volume_consensus", "cl2d_clustering", "align_pca_2d",
       "graph_max_cut", "extract_particles", "swiftalign_wiener_2d",
       "swiftalign_aligned_2d_classification", "sync_data", "compile",
       "test_script_importing_module", "matlab_bridge", "deep_consensus",
       "deep_micrograph_cleaner", "deep_hand", "deepRes_resolution",
       "deep_global_assignment", "deep_global_assignment_predict",
       "deep_misalignment_detection", "deep_volume_postprocessing"]
NEW_ALIASES = ["mpi_volumeset_align", "alignPCA_2D", "deep_res_resolution"]
PDB_TEXT = "".join(
    f"ATOM  {i + 1:5d}  {name:<3s} ALA {chain}{i // 2 + 1:4d}    "
    f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00           C\n"
    for i, (name, chain, x, y, z) in enumerate(
        [("CA", "A", 10.0, 20.0, 30.0), ("CB", "A", 12.0, 22.0, 34.0),
         ("CA", "B", -3.5, 1.25, 7.0), ("CB", "B", 0.5, -2.0, 5.5)])) \
    + "TER\nEND\n"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("tail")
    for t in "jt":
        (d / t).mkdir()
    rng = np.random.default_rng(21)
    v = phantom8(N)
    save_image(str(d / "vol.vol"), v)
    rot = rng.uniform(0, 360, B).astype(np.float32)
    tilt = np.degrees(np.arccos(rng.uniform(-1, 1, B))).astype(np.float32)
    psi = rng.uniform(0, 360, B).astype(np.float32)
    P = FourierProjector(v, device="cpu").project_euler(rot, tilt, psi) \
        .numpy()
    views = (P + 0.2 * P.std() * rng.standard_normal(P.shape)).astype(
        np.float32)
    stk = str(d / "views.mrcs")
    save_image(stk, views)
    cls = rng.integers(0, 3, B)
    MetaData.fromRows(
        {"image": f"{i + 1}@{stk}", "angleRot": float(rot[i]),
         "angleTilt": float(tilt[i]), "anglePsi": float(psi[i]),
         "shiftX": float(rng.uniform(-1, 1)), "shiftY": 0.5,
         "flip": int(i % 5 == 0), "imageIndex": int(cls[i] + 3 * (i % 4)),
         "maxCC": float(rng.uniform()), "itemId": i + 1, "enabled": 1,
         "ctfDefocusU": 12000.0 + 300 * i, "ctfDefocusV": 12500.0 + 300 * i,
         "ctfDefocusAngle": 10.0 * i, "ctfVoltage": 300.0}
        for i in range(B)).write(str(d / "views.xmd"))
    # class averages: three distinct views, each in 4 noisy copies
    avgs = np.concatenate([P[k:k + 1] + 0.05 * P.std()
                           * rng.standard_normal((4, N, N))
                           for k in (0, 7, 13)]).astype(np.float32)
    save_image(str(d / "avgs.mrcs"), avgs)
    # a micrograph with a noisy band and particle coordinates
    mic = rng.standard_normal((128, 128)).astype(np.float32)
    mic[:, 96:] *= 6
    save_image(str(d / "mic.mrc"), mic)
    xy = rng.integers(16, 112, (14, 2))
    MetaData.fromRows({"xcoor": int(x), "ycoor": int(y), "itemId": i + 1}
                      for i, (x, y) in enumerate(xy)).write(
        str(d / "pos.xmd"))
    MetaData.fromRows({"xcoor": int(x) + 1, "ycoor": int(y), "itemId": i + 1}
                      for i, (x, y) in enumerate(xy[:9])).write(
        str(d / "pos2.xmd"))
    np.savetxt(str(d / "pos3.txt"), xy[4:] - 1, fmt="%d")
    (d / "pickers.txt").write_text(
        "\n".join(str(d / f) for f in ("pos.xmd", "pos2.xmd", "pos3.txt")))
    MetaData.fromRows([{"micrograph": str(d / "mic.mrc"),
                        "coordinates": str(d / "pos.xmd")}]).write(
        str(d / "mics.xmd"))
    (d / "in.pdb").write_text(PDB_TEXT)
    model = AtomicModel(rng.uniform(-12, 12, (60, 3)), ["C", "N", "O"] * 20,
                        rng.uniform(0, 30, 60).astype(np.float32),
                        rng.uniform(0.1, 2, 60).astype(np.float32))
    write_pdb(str(d / "model.pdb"), model)
    s = {"d": d, "v": v, "views": views, "P": P, "rot": rot, "tilt": tilt,
         "psi": psi}
    return s


def lines(path):
    return open(path).read().splitlines()


def same_files(d, name):
    assert lines(d / "j" / name) == lines(d / "t" / name)


def same_rows(d, name, tol=0.0):
    a, b = rows(d / "j" / name), rows(d / "t" / name)
    assert len(a) == len(b) and [list(r) for r in a] == [list(r) for r in b]
    for ra, rb in zip(a, b):
        for k in ra:
            if isinstance(ra[k], (float, np.floating)):
                assert abs(ra[k] - rb[k]) <= tol * max(abs(ra[k]), 1.0), k
            elif isinstance(ra[k], np.ndarray):
                assert np.abs(ra[k] - rb[k]).max() <= tol, k
            else:
                assert ra[k] == rb[k], k


def same_labels(a, b):
    """a and b give the same partition (up to the labels' names)."""
    pairs = set(zip(a, b))
    return len(pairs) == len(set(a)) == len(set(b))


# -- final_batch --------------------------------------------------------------

def test_metadata_xml_matches_the_reference(data):
    d = data["d"]
    blocks = str(d / "blocks.xmd")
    for b in ("mic_0001", "mic_0002"):
        MetaData.fromRows({"xcoor": 10 * k, "ycoor": 7 * k + 1}
                          for k in range(3)).write(f"{b}@{blocks}",
                                                   append=True)
    parts = str(d / "parts.xmd")
    MetaData.fromRows({"micrograph": f"m{k % 2}.mrc", "xcoor": 4 * k,
                       "ycoor": 9 * k, "enabled": 1 if k != 3 else -1}
                      for k in range(6)).write(parts)
    for name, args in (("generic.xml", ["-i", str(d / "views.xmd"),
                                        "--root", "set"]),
                       ("blocks.xml", ["-i", blocks]),
                       ("parts.xml", ["-i", parts, "--extractParticlesMD"])):
        both("metadata_xml", lambda t: args + ["-o", str(d / t / name)],
             device=False)
        same_files(d, name)


def test_metadata_split_3d_matches_the_reference(data):
    d = data["d"]
    both("metadata_split_3D", lambda t: [
        "-i", str(d / "views.xmd"), "--oroot", str(d / t / "split"),
        "--angSampling", 15, "--maxDist", 25], device=False)
    for suffix in ("_upper", "_lower", "_1", "_2"):
        same_rows(d, f"split{suffix}.xmd")


def test_coordinates_noisy_zones_filter_matches_the_reference(data):
    d = data["d"]
    progs = both("coordinates_noisy_zones_filter", lambda t: [
        "--pos", str(d / "pos.xmd"), "--mic", str(d / "mic.mrc"),
        "-o", str(d / t / "f.xmd"), "--patchSize", 24, "--zmax", 2])
    same_rows(d, "f.xmd")
    assert 0 < progs[1].n_kept < 14


def test_volumeset_align_matches_the_reference(data, tmp_path):
    from xmipp3_tpu_torch.ops.geo import apply_affine_3d
    from xmipp3_tpu_torch.core.geometry import euler_matrix
    d = data["d"]
    R = euler_matrix(np.float32([30.0]), np.float32([0.0]),
                     np.float32([0.0]))[0]
    rot = apply_affine_3d(data["v"], R[None].astype(np.float32),
                          device="cpu")[0].numpy()
    save_image(str(d / "rot.vol"), rot)
    MetaData.fromRows([{"image": str(d / "rot.vol"), "itemId": 1},
                       {"image": str(d / "vol.vol"), "itemId": 2}]).write(
        str(d / "set.xmd"))
    both("volumeset_align", lambda t: [
        "-i", str(d / "set.xmd"), "--ref", str(d / "vol.vol"),
        "-o", str(d / t / "al.xmd"), "--step", 60])
    same_rows(d, "al.xmd", tol=1e-4)
    # --resume keeps the rows already written
    both("volumeset_align", lambda t: [
        "-i", str(d / "set.xmd"), "--ref", str(d / "vol.vol"),
        "-o", str(d / t / "al.xmd"), "--step", 60, "--resume"])
    same_rows(d, "al.xmd", tol=1e-4)


def test_pdb_programs_match_the_reference(data):
    d = data["d"]
    m = str(d / "model.pdb")
    both("pdb_analysis", lambda t: [
        "-i", m, "--operation", "distance_histogram",
        str(d / t / "hist.txt"), 3, 6], device=True)
    same_files(d, "hist.txt")
    both("pdb_reduce_pseudoatoms", lambda t: [
        "-i", m, "-o", str(d / t / "num.pdb"), "--number", 20,
        "--threshold", 0.5], device=False)
    same_files(d, "num.pdb")
    both("pdb_reduce_pseudoatoms", lambda t: [
        "-i", m, "-o", str(d / t / "km.pdb"), "--num", 12])
    same_files(d, "km.pdb")
    lab = np.cumsum(np.ones((N, N, N), np.float32), axis=0) - 10.0
    save_image(str(d / "lab.vol"), lab)
    save_image(str(d / "labmask.vol"), (data["v"] > 0.05).astype(np.float32))
    both("pdb_label_from_volume", lambda t: [
        "--pdb", m, "--vol", str(d / "lab.vol"), "--mask",
        str(d / "labmask.vol"), "-o", str(d / t / "lab.pdb"),
        "--origin", 16, 16, 16, "--radius", 2.5, "--sampling", 1.5,
        "--md", str(d / t / "lab.xmd")], device=False)
    same_files(d, "lab.pdb")
    same_rows(d, "lab.xmd")
    coeffs = np.random.default_rng(3).normal(0, 0.5, 3 * 13)
    MetaData.fromRows([{"sphCoefficients": coeffs}]).write(
        str(d / "clnm.xmd"))
    both("pdb_sph_deform", lambda t: [
        "--pdb", m, "-o", str(d / t / "def.pdb"), "--clnm",
        str(d / "clnm.xmd"), "--boxsize", 40, "--sr", 1.0,
        "--center_mass"], device=False)
    same_files(d, "def.pdb")


def test_pdb_analysis_stats_match_the_reference(data):
    j, t = both("pdb_analysis", lambda t: ["-i", str(data["d"] /
                                                     "model.pdb")])
    assert abs(j.radius_of_gyration - t.radius_of_gyration) <= 1e-12


def test_compare_density_matches_the_reference(data):
    d = data["d"]
    # a blob and the blob with a satellite (tests/test_final_batch.py's
    # pair at half the size)
    z, y, x = np.mgrid[:N, :N, :N].astype(np.float32) - N // 2
    main = np.exp(-(z ** 2 + y ** 2 + x ** 2) / 10.0)
    sat = np.exp(-((z - 11) ** 2 + (y - 11) ** 2 + x ** 2) / 3.5)
    save_image(str(d / "c1.vol"), (main + sat).astype(np.float32))
    save_image(str(d / "c2.vol"), main.astype(np.float32))
    progs = both("compare_density", lambda t: [
        "-v1", str(d / "c1.vol"), "-v2", str(d / "c2.vol"), "-o",
        str(d / t / "cd.xmp"), "--degstep", 30])
    assert np.array_equal(vol(d / "j" / "cd.xmp"), vol(d / "t" / "cd.xmp"))
    assert (progs[1].corr_image != 0).any()


def ctfparam(path, dfu):
    MetaData.fromRows([{"ctfSamplingRate": 1.5, "ctfVoltage": 300.0,
                        "ctfDefocusU": dfu, "ctfDefocusV": dfu + 200.0,
                        "ctfDefocusAngle": 20.0,
                        "ctfSphericalAberration": 2.7, "ctfQ0": 0.1}]
                      ).write(str(path))
    return str(path)


def test_ctf_correct_wiener3d_matches_the_reference(data):
    d = data["d"]
    rng = np.random.default_rng(5)
    groups = []
    for g, dfu in enumerate((8000.0, 15000.0)):
        fn = str(d / f"group{g}.vol")
        save_image(fn, (data["v"] + 0.1 * rng.standard_normal(
            (N, N, N))).astype(np.float32))
        groups.append({"image": fn, "ctfModel": ctfparam(
            d / f"g{g}.ctfparam", dfu), "classCount": 10 + 5 * g})
    MetaData.fromRows(groups).write(str(d / "groups.xmd"))
    for extra in ([], ["--minFreq", 6.0, "--phase_flipped"]):
        both("ctf_correct_wiener3d", lambda t: [
            "-i", str(d / "groups.xmd"), "--oroot", str(d / t / "w"),
            "--wienerConstant", 0.1, *extra])
        for name in ("w_deconvolved.vol", "w_ctffiltered_group01.vol",
                     "w_ctffiltered_group02.vol"):
            assert rel(vol(d / "t" / name), vol(d / "j" / name)) <= 1e-5
    both("ctf_correct_wiener3d", lambda t: [
        "-i", str(d / "group0.vol"), "--ctf", str(d / "g0.ctfparam"),
        "-o", str(d / t / "single.vol"), "--sampling", 2.0])
    assert rel(vol(d / "t" / "single.vol"), vol(d / "j" / "single.vol")) \
        <= 1e-5


def test_adjust_volume_grey_levels_matches_the_reference(data):
    d = data["d"]
    grey = str(d / "grey.xmd")
    stk = str(d / "grey.mrcs")
    save_image(stk, (1.5 * data["P"] + 0.3).astype(np.float32))
    MetaData.fromRows(
        {"image": f"{i + 1}@{stk}", "angleRot": float(data["rot"][i]),
         "angleTilt": float(data["tilt"][i]),
         "anglePsi": float(data["psi"][i])} for i in range(B)).write(grey)
    progs = both("transform_adjust_volume_grey_levels", lambda t: [
        "-i", str(d / "vol.vol"), "-m", grey, "-o", str(d / t / "ag.vol"),
        "--optimize", "--probb_eval", 0.5, "--seed", 3])
    (ja, jb), (ta, tb) = progs[0].ab, progs[1].ab
    assert abs(ta - ja) <= 1e-4 * abs(ja) and abs(tb - jb) <= 1e-4 * abs(jb)
    assert rel(vol(d / "t" / "ag.vol"), vol(d / "j" / "ag.vol")) <= 1e-4
    both("transform_adjust_volume_grey_levels", lambda t: [
        "-i", str(d / "vol.vol"), "-m", grey, "-o", str(d / t / "ag0.vol")])
    assert rel(vol(d / "t" / "ag0.vol"), vol(d / "j" / "ag0.vol")) <= 1e-5
    save_image(str(d / "v5.vol"), (5 * data["v"] - 2).astype(np.float32))
    both("transform_adjust_volume_grey_levels", lambda t: [
        "-i", str(d / "v5.vol"), "-r", str(d / "vol.vol"),
        "-o", str(d / t / "ar.vol")])
    assert rel(vol(d / "t" / "ar.vol"), vol(d / "j" / "ar.vol")) <= 1e-5


# -- scripts_misc -------------------------------------------------------------

def test_metadata_selfile_create_and_pdb_text_programs_match(data):
    d = data["d"]
    for extra in ([], ["-s", "-l", "imageRef"]):
        both("metadata_selfile_create", lambda t: [
            "-p", str(d / "*.mrcs"), "-o", str(d / t / "sel.xmd"), *extra],
            device=False)
        same_rows(d, "sel.xmd")
    both("pdb_center", lambda t: ["-i", str(d / "in.pdb"),
                                  "-o", str(d / t / "c.pdb")], device=False)
    same_files(d, "c.pdb")
    for extra in (["--atom", "CA"], ["--chain", "B"]):
        both("pdb_select", lambda t: ["-i", str(d / "in.pdb"),
                                      "-o", str(d / t / "s.pdb"), *extra],
             device=False)
        same_files(d, "s.pdb")


def test_coordinate_programs_match_the_reference(data):
    d = data["d"]
    for c in (2, -1):
        both("coordinates_consensus", lambda t: [
            "-i", str(d / "pickers.txt"), "-s", 40, "-c", c,
            "-o", str(d / t / "cons.xmd")], device=False)
        same_rows(d, "cons.xmd")
    both("pick_noise", lambda t: [
        "-i", str(d / "mic.mrc"), "-c", str(d / "pos.xmd"),
        "-o", str(d / t / "noise.xmd"), "-s", 8, "-n", 5, "--seed", 4],
        device=False)
    same_rows(d, "noise.xmd")
    for extra in ([], ["--invert", "--normalize"]):
        both("extract_particles", lambda t: [
            "-i", str(d / "mics.xmd"), "-s", 24, "-o", str(d / t / "ex"),
            *extra])
        a, b = rows(d / "j" / "ex" / "particles.xmd"), \
            rows(d / "t" / "ex" / "particles.xmd")
        assert [(r["xcoor"], r["ycoor"]) for r in a] == \
            [(r["xcoor"], r["ycoor"]) for r in b]
        stk = "ex/mic_particles.mrcs"
        assert rel(vol(d / "t" / stk), vol(d / "j" / stk)) <= 1e-6


def test_preprocess_mics_matches_the_reference(data):
    d = data["d"]
    md = str(d / "pp.xmd")
    MetaData.fromRows([{"micrograph": str(d / "mic.mrc"),
                        "ctfModel": ctfparam(d / "mic.ctfparam", 9000.0)}]
                      ).write(md)
    both("preprocess_mics", lambda t: [
        "-i", md, "-s", 1.5, "-o", str(d / t / "pp"), "-d", 2,
        "--invert_contrast", "--phase_flip"])
    assert rel(vol(d / "t" / "pp" / "mic.mrc"),
               vol(d / "j" / "pp" / "mic.mrc")) <= 1e-4


def test_volume_consensus_matches_the_reference(data):
    d = data["d"]
    rng = np.random.default_rng(8)
    fns = []
    for k in range(3):
        fns.append(str(d / f"cons{k}.vol"))
        save_image(fns[-1], (data["v"] + 0.2 * rng.standard_normal(
            (N, N, N))).astype(np.float32))
    (d / "vols.txt").write_text("\n".join(fns))
    both("volume_consensus", lambda t: ["-i", str(d / "vols.txt"),
                                        "-o", str(d / t / "cons.vol")])
    assert rel(vol(d / "t" / "cons.vol"), vol(d / "j" / "cons.vol")) <= 1e-5


def test_cl2d_clustering_matches_the_reference(data):
    d = data["d"]
    progs = both("cl2d_clustering", lambda t: [
        "-i", str(d / "avgs.mrcs"), "-o", str(d / t / "cl"), "-M", 4])
    assert progs[0].n_clusters == progs[1].n_clusters
    a, b = (rows(d / t / "cl" / "clusters.xmd") for t in "jt")
    assert same_labels([r["ref"] for r in a], [r["ref"] for r in b])
    assert rel(vol(d / "t" / "cl" / "cluster_averages.mrcs"),
               vol(d / "j" / "cl" / "cluster_averages.mrcs")) <= 1e-5


def test_align_pca_2d_matches_the_reference(data):
    d = data["d"]
    both("align_pca_2d", lambda t: ["-i", str(d / "avgs.mrcs"),
                                    "-o", str(d / t / "pca"), "--iter", 2,
                                    "--ncomp", 3])
    for name in ("aligned.mrcs", "average.mrc"):
        assert rel(vol(d / "t" / "pca" / name),
                   vol(d / "j" / "pca" / name)) <= 1e-4
    ej, et = (vol(d / t / "pca" / "eigenimages.mrcs").reshape(3, -1).T
              for t in "jt")
    assert rel(aligned(et, ej), ej) <= 1e-3
    pj, pt = (np.array([[r[f"autoParticles{k}"] for k in (1, 2, 3)]
                        for r in rows(d / t / "pca" / "pca.xmd")])
              for t in "jt")
    assert rel(aligned(pt, pj), pj) <= 1e-3


def test_graph_max_cut_matches_the_reference(data):
    d = data["d"]
    W = np.random.default_rng(6).uniform(0, 1, (12, 12))
    np.fill_diagonal(W, 0.0)
    np.savetxt(str(d / "w.txt"), W)
    progs = both("graph_max_cut", lambda t: ["-i", str(d / "w.txt"),
                                             "-o", str(d / t / "cut.txt")],
                 device=False)
    same_files(d, "cut.txt")
    assert progs[0].cut_value == progs[1].cut_value


def test_graph_max_cut_ends_with_a_positive_diagonal(data):
    """The reference's greedy pass counts a node's own weight in its flip
    gain and loops for ever on this matrix; the port's ends at a cut that
    no single flip raises."""
    d = data["d"]
    W = np.random.default_rng(6).uniform(0, 1, (12, 12))
    W = 0.5 * (W + W.T)
    np.savetxt(str(d / "wd.txt"), W)
    prog = get_program("graph_max_cut")
    assert prog.run_with_args(["-i", str(d / "wd.txt"), "-o",
                               str(d / "t" / "cutd.txt"), "-v", "0"]) == 0
    x = 2.0 * np.loadtxt(str(d / "t" / "cutd.txt")) - 1
    cut = lambda x: 0.25 * float(W.sum() - x @ W @ x)
    assert abs(prog.cut_value - cut(x)) <= 1e-12
    for i in range(12):
        y = x.copy()
        y[i] = -y[i]
        assert cut(y) <= cut(x) + 1e-12


def test_swiftalign_programs_match_the_reference(data):
    d = data["d"]
    both("swiftalign_wiener_2d", lambda t: [
        "-i", str(d / "views.xmd"), "-o", str(d / t / "wien.mrcs"),
        "--sampling", 2.0, "--wc", 0.05])
    assert rel(vol(d / "t" / "wien.mrcs"), vol(d / "j" / "wien.mrcs")) \
        <= 1e-5
    assert [r["image"].replace("/t/", "/") for r in
            rows(d / "t" / "wien.xmd")] == \
        [r["image"].replace("/j/", "/") for r in rows(d / "j" / "wien.xmd")]
    both("swiftalign_aligned_2d_classification", lambda t: [
        "-i", str(d / "views.xmd"), "-o", str(d / t / "sw"),
        "--nClasses", 3])
    a, b = (rows(d / t / "sw" / "classes.xmd") for t in "jt")
    assert same_labels([r["ref"] for r in a], [r["ref"] for r in b])


# -- the registry -------------------------------------------------------------

@pytest.mark.parametrize("alias", NEW_ALIASES)
def test_tail_alias_dispatches_to_its_program(alias):
    assert type(get_program(alias)) is type(get_program(ALIASES[alias]))
    assert type(jax_program(alias)).__name__ == \
        type(get_program(alias)).__name__


def test_the_registry_holds_257_endpoints():
    from xmipp3_tpu.programs import list_programs as jax_programs
    from xmipp3_tpu_torch.programs import list_programs
    names = set(list_programs())
    assert len(NEW) == 36 and len(NEW_ALIASES) == 3
    assert set(NEW) | set(NEW_ALIASES) <= names
    assert len(names) == 257 and len(ALIASES) == 62
    assert names == set(jax_programs())
