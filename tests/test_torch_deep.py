"""The port's models/deep.py and deep_* programs against the reference
package's, on the CPU, on numpy-seeded inputs.

Tolerances:
- forward: each network with the weights of a flax init carried over by
  params_from_flax, on 2-4 inputs at 32^2 / 16^3: 1e-5 of the output's
  max (float32 convolutions in both);
- training: the same initial weights and the same batches (the
  reference's numpy Generator), three Adam steps: every epoch's mean loss
  1e-4 relative, every parameter tensor 1e-4 of its max;
- the deep programs: the reference trains at a tiny size through its CLI,
  the test decodes its model file (flax msgpack) into the port's format,
  and the port's CLI scores, maps and texts equal the reference's on that
  model to 1e-4 (of the max for maps); the port's own --train writes a
  file that its predict path reads.
"""
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import unfreeze
from flax.serialization import msgpack_restore
from test_torch_cli_analysis import rel, rows, vol
from xmipp3_tpu.models import deep as jdeep
from xmipp3_tpu_torch.core.image import save_image
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.models import deep as tdeep
from xmipp3_tpu_torch.programs import get_program

torch.set_num_threads(1)

NETS = [("ConvNet2D", dict(n_out=3), (4, 32, 32)),
        ("ConvNet3D", dict(n_out=2), (3, 16, 16, 16)),
        ("UNet3DLite", {}, (2, 16, 16, 16))]


def flax_tree(params):
    return jax.tree_util.tree_map(np.asarray, unfreeze(params))


def pair(kind, kw, X, seed=1):
    """The reference's network initialised from PRNGKey(seed) on X[:1]
    and the port's with the same weights."""
    jm = getattr(jdeep, kind)(**kw)
    p = jm.init(jax.random.PRNGKey(seed), jnp.asarray(X[:1, ..., None]))
    tm = tdeep.KINDS[kind](**kw)
    tm.load_state_dict(tdeep.params_from_flax(tm, flax_tree(p)))
    return jm, p, tm


@pytest.mark.parametrize("kind,kw,shape", NETS, ids=[n[0] for n in NETS])
def test_forward_with_carried_weights_matches_the_reference(kind, kw,
                                                            shape):
    X = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jm, p, tm = pair(kind, kw, X)
    want = np.asarray(jm.apply(p, jnp.asarray(X[..., None])))
    got = tdeep.predict(tm, X, device="cpu")
    if kind == "UNet3DLite":
        want, got = want[..., 0], got[:, 0]
    assert got.shape == want.shape
    assert rel(got, want) <= 1e-5


@pytest.mark.parametrize("kind,kw,shape", NETS, ids=[n[0] for n in NETS])
def test_flax_tree_round_trip_is_exact(kind, kw, shape):
    X = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    _, p, tm = pair(kind, kw, X)
    want = flax_tree(p)
    got = tdeep.flax_from_params(tm)
    leaves = jax.tree_util.tree_leaves_with_path
    assert [k for k, _ in leaves(got)] == [k for k, _ in leaves(want)]
    for (_, a), (_, b) in zip(leaves(got), leaves(want)):
        assert a.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("kind,kw,shape,loss", [
    ("ConvNet2D", dict(n_out=2), (12, 32, 32), "xent"),
    ("ConvNet3D", dict(n_out=1), (12, 16, 16, 16), "mse")],
    ids=["ConvNet2D-xent", "ConvNet3D-mse"])
def test_three_adam_steps_match_the_reference(kind, kw, shape, loss):
    rng = np.random.default_rng(2)
    X = rng.standard_normal(shape).astype(np.float32)
    y = rng.integers(0, 2, len(X)).astype(np.int32) if loss == "xent" \
        else rng.standard_normal((len(X), 1)).astype(np.float32)
    jm = getattr(jdeep, kind)(**kw)
    jp, jhist = jdeep.train_model(jm, X, y, loss, n_epochs=1, batch=4,
                                  seed=3)
    init = jm.init(jax.random.PRNGKey(3), jnp.asarray(X[:1, ..., None]))
    tm = tdeep.KINDS[kind](**kw)
    tm, thist = tdeep.train_model(
        tm, X, y, loss, n_epochs=1, batch=4, seed=3, device="cpu",
        init=tdeep.params_from_flax(tm, flax_tree(init)))
    assert abs(thist[0] - jhist[0]) <= 1e-4 * abs(jhist[0])
    leaves = jax.tree_util.tree_leaves
    for a, b in zip(leaves(tdeep.flax_from_params(tm)),
                    leaves(flax_tree(jp))):
        assert rel(a, b) <= 1e-4


def test_port_init_draws_the_reference_distributions():
    a = tdeep.init_params(tdeep.ConvNet2D(2), seed=5)
    b = tdeep.init_params(tdeep.ConvNet2D(2), seed=5)
    c = tdeep.init_params(tdeep.ConvNet2D(2), seed=6)
    sa, sb, sc = (m.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["convs.1.weight"], sc["convs.1.weight"])
    w = sa["dense0.weight"]            # fan_in 64: lecun std 1/8
    assert abs(float(w.std()) - 0.125) < 0.02
    assert float(w.abs().max()) <= 2 * 0.125 / 0.87962566103423978 + 1e-6
    assert float(sa["convs.0.bias"].abs().max()) == 0.0
    assert float((sa["norms.0.weight"] - 1).abs().max()) == 0.0


def test_model_file_round_trip_and_msgpack_refused(tmp_path):
    m = tdeep.init_params(tdeep.ConvNet3D(2), seed=0)
    tdeep.save_params(tmp_path / "m.pkl", "ConvNet3D", m, {"a": 1})
    n, meta = tdeep.load_params(tmp_path / "m.pkl", tdeep.ConvNet3D(2))
    assert meta == {"a": 1}
    assert all(torch.equal(m.state_dict()[k], n.state_dict()[k])
               for k in m.state_dict())
    with open(tmp_path / "j.pkl", "wb") as f:
        pickle.dump({"kind": "ConvNet3D", "params": b"\x81", "meta": {}}, f)
    with pytest.raises(ValueError, match="msgpack"):
        tdeep.load_params(tmp_path / "j.pkl", tdeep.ConvNet3D(2))


# -- the programs ------------------------------------------------------------

def port_model(src, dst):
    """The reference's model file (flax msgpack bytes) as the port's."""
    with open(src, "rb") as f:
        blob = pickle.load(f)
    blob["params"] = msgpack_restore(blob["params"])
    with open(dst, "wb") as f:
        pickle.dump(blob, f)


def write_set(d, name, arrays, **cols):
    stk = str(d / f"{name}.mrcs")
    save_image(stk, np.asarray(arrays, np.float32))
    n = len(arrays)
    MetaData.fromRows({"image": f"{i + 1}@{stk}",
                       **{k: float(v[i]) for k, v in cols.items()}}
                      for i in range(n)).write(str(d / f"{name}.xmd"))
    return str(d / f"{name}.xmd")


def write_vols(d, name, vols, **cols):
    rows_ = []
    for i, v in enumerate(vols):
        fn = str(d / f"{name}_{i}.mrc")
        save_image(fn, np.asarray(v, np.float32))
        rows_.append({"image": fn, **{k: v_[i] for k, v_ in cols.items()}})
    MetaData.fromRows(rows_).write(str(d / f"{name}.xmd"))
    return str(d / f"{name}.xmd")


def blobs2d(rng, n, size, sigma):
    yy, xx = np.mgrid[:size, :size] - size / 2
    c = rng.uniform(-3, 3, (n, 2))
    return np.exp(-((xx - c[:, 0, None, None]) ** 2
                    + (yy - c[:, 1, None, None]) ** 2) / (2 * sigma ** 2)) \
        + 0.3 * rng.standard_normal((n, size, size))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("deep")
    rng = np.random.default_rng(11)
    s = {}
    s["pos"] = write_set(d, "pos", blobs2d(rng, 8, 32, 4))
    s["neg"] = write_set(d, "neg", 0.5 * rng.standard_normal((8, 32, 32)))
    s["cand"] = write_set(d, "cand", np.concatenate(
        [blobs2d(rng, 3, 32, 4), rng.standard_normal((3, 32, 32))]))
    mic = rng.standard_normal((96, 96)).astype(np.float32)
    mic[:, 48:] += 3 * np.sin(np.arange(48) / 2)[None]
    save_image(str(d / "mic.mrc"), mic)
    z = np.mgrid[:16, :16, :16][2].astype(np.float32)
    vols = [np.cumsum(rng.standard_normal((16, 16, 16)), axis=2) + z
            for _ in range(2)]
    s["vols"] = write_vols(d, "train", vols, resolution=[3.0, 6.0])
    s["good"] = write_vols(d, "good", vols[:1] * 2)
    s["bad"] = write_vols(d, "bad", [v[:, ::-1] for v in vols])
    s["pairs"] = str(d / "pairs.xmd")
    MetaData.fromRows({"image": str(d / f"train_{i}.mrc"),
                       "imageRef": str(d / f"good_{i}.mrc")}
                      for i in range(2)).write(s["pairs"])
    save_image(str(d / "in.mrc"), vols[1])
    ang = rng.uniform(0, 90, (2, 12))
    s["views"] = write_set(d, "views", blobs2d(rng, 12, 32, 3),
                           angleRot=ang[0], angleTilt=ang[1])
    for t in "jt":
        (d / t).mkdir()
    s["d"] = d
    return s


DEEP = {
    "deep_consensus": (
        lambda s: ["--posTrain", s["pos"], "--negTrain", s["neg"]],
        lambda s, t: ["-i", s["cand"], "-o", str(s["d"] / t / "o.xmd")]),
    "deep_micrograph_cleaner": (
        lambda s: ["--goodTrain", s["pos"], "--badTrain", s["neg"]],
        lambda s, t: ["-i", str(s["d"] / "mic.mrc"), "--boxSize", 32,
                      "-o", str(s["d"] / t / "o.mrc")]),
    "deep_hand": (
        lambda s: ["--trainVols", s["vols"]],
        lambda s, t: ["-i", str(s["d"] / "in.mrc"),
                      "-o", str(s["d"] / t / "o.txt")]),
    "deepRes_resolution": (
        lambda s: ["--trainVols", s["vols"], "--patch", 8],
        lambda s, t: ["-i", str(s["d"] / "in.mrc"), "--patch", 8,
                      "-o", str(s["d"] / t / "o.mrc")]),
    "deep_misalignment_detection": (
        lambda s: ["--goodTrain", s["good"], "--badTrain", s["bad"]],
        lambda s, t: ["-i", s["vols"], "-o", str(s["d"] / t / "o.xmd")]),
    "deep_volume_postprocessing": (
        lambda s: ["--trainPairs", s["pairs"]],
        lambda s, t: ["-i", str(s["d"] / "in.mrc"),
                      "-o", str(s["d"] / t / "o.mrc")]),
}


def run_port(args):
    assert get_program(args[0]).run_with_args(
        [str(a) for a in args[1:]] + ["-v", "0", "--device", "cpu"]) == 0


def run_ref(args):
    from xmipp3_tpu.programs import get_program as jax_program
    assert jax_program(args[0]).run_with_args(
        [str(a) for a in args[1:]] + ["-v", "0"]) == 0


def outputs_equal(d, name):
    j, t = d / "j", d / "t"
    if name in ("deep_consensus", "deep_misalignment_detection"):
        key = "zScoreDeepLearning1" if name == "deep_consensus" else "cost"
        a, b = rows(j / "o.xmd"), rows(t / "o.xmd")
        assert [r["enabled"] for r in a] == [r["enabled"] for r in b]
        assert np.abs(np.array([r[key] for r in a])
                      - [r[key] for r in b]).max() <= 1e-4
    elif name == "deep_hand":
        assert abs(float((j / "o.txt").read_text())
                   - float((t / "o.txt").read_text())) <= 1e-4
    else:
        assert rel(vol(t / "o.mrc"), vol(j / "o.mrc")) <= 1e-4


@pytest.mark.parametrize("name", sorted(DEEP))
def test_deep_program_on_the_reference_model_matches(data, name):
    d = data["d"]
    train, apply = DEEP[name]
    jm, tmodel = str(d / f"{name}_j.pkl"), str(d / f"{name}_t.pkl")
    run_ref([name, *apply(data, "j"), *train(data), "--train", "--epochs",
             2, "--model", jm])
    port_model(jm, tmodel)
    run_port([name, *apply(data, "t"), "--model", tmodel])
    outputs_equal(d, name)
    # the port's own training writes a model its predict path reads
    own = str(d / f"{name}_own.pkl")
    run_port([name, *apply(data, "t"), *train(data), "--train",
              "--epochs", 2, "--model", own])
    run_port([name, *apply(data, "t"), "--model", own])


def directions(rs):
    """The unit vectors of the rows' (angleRot, angleTilt)."""
    r = np.deg2rad([x["angleRot"] for x in rs])
    t = np.deg2rad([x["angleTilt"] for x in rs])
    return np.stack([np.sin(t) * np.cos(r), np.sin(t) * np.sin(r),
                     np.cos(t)], axis=-1)


def test_deep_global_assignment_on_the_reference_model_matches(data):
    d = data["d"]
    jm, tmodel = str(d / "ga_j.pkl"), str(d / "ga_t.pkl")
    run_ref(["deep_global_assignment", "-i", data["views"], "--epochs", 2,
             "--model", jm])
    port_model(jm, tmodel)
    for t, run, m in (("j", run_ref, jm), ("t", run_port, tmodel)):
        run(["deep_global_assignment_predict", "-i", data["views"],
             "-o", str(d / t / "ga.xmd"), "--model", m])
    a, b = (directions(rows(d / t / "ga.xmd")) for t in "jt")
    assert np.abs(a - b).max() <= 1e-4
    run_port(["deep_global_assignment", "-i", data["views"], "--epochs", 2,
              "--model", str(d / "ga_own.pkl")])
    run_port(["deep_global_assignment_predict", "-i", data["views"],
              "-o", str(d / "t" / "ga_own.xmd"), "--model",
              str(d / "ga_own.pkl")])
    assert len(rows(d / "t" / "ga_own.xmd")) == 12


def test_softmax_is_the_stable_form():
    from xmipp3_tpu_torch.programs.deep_programs import _prob_of_class1
    logits = np.array([[0.3, -1.2], [2.0, 2.5], [500.0, 520.0]], np.float32)
    p = _prob_of_class1(logits)
    ref = np.exp(logits[:2, 1]) / np.exp(logits[:2]).sum(axis=1)
    assert np.abs(p[:2] - ref).max() <= 1e-7
    assert np.isfinite(p).all() and abs(p[2] - 1.0) <= 1e-6
