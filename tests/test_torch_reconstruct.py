"""The port's streaming reconstructor against the reference's: whole stacks
through reconstruct_fourier (c1 and c4, with shifts, weights and flips),
FourierReconstructor batch by batch, and an accumulation begun in the
reference and finished in the port (from_jax_state).

The particles are projections of a smooth phantom: noise particles put
full power at the Nyquist edge, where K3 drops samples whole and its
polynomial window's tails weigh sparsely covered voxels, so kb maps of
noise differ from the exact-Bessel reference by more than the kb
tolerance (the accumulator tests of test_torch_scatter.py hold noise)."""
import numpy as np
import pytest
import torch

from test_torch_common import phantom_batch, rel_err
from xmipp3_tpu.ops import reconstruct as jrec
from xmipp3_tpu_torch.ops import reconstruct as trec

torch.set_num_threads(1)

N, C = 32, 16
TOL = {"tri": 1e-4, "tri+kb": 1e-4, "nn": 1e-4, "kb": 5e-3}


def _stack(seed):
    b = phantom_batch(seed, C, N)
    return (b["imgs"], b["rot"], b["tilt"], b["psi"]), dict(
        sx=b["sx"], sy=b["sy"], weights=b["w"], flip=b["flip"])


@pytest.mark.parametrize("sym,interp", [("c1", "kb"), ("c4", "kb"),
                                        ("c1", "tri"), ("c4", "nn")])
def test_reconstruct_fourier_matches_reference(sym, interp):
    args, kw = _stack(11)
    assert kw["flip"].any() and not kw["flip"].all()
    want = np.asarray(jrec.reconstruct_fourier(*args, **kw, sym=sym,
                                               interp=interp, batch=8))
    got = trec.reconstruct_fourier(*args, **kw, sym=sym, interp=interp,
                                   batch=8, device="cpu")
    assert isinstance(got, torch.Tensor) and got.shape == (N, N, N)
    assert rel_err(got, want) <= TOL[interp]


def test_reconstructor_accumulators_match_reference_batch_by_batch():
    (imgs, rot, tilt, psi), kw = _stack(12)
    jr = jrec.FourierReconstructor(N, sym="c4", interp="tri")
    tr = trec.FourierReconstructor(N, sym="c4", interp="tri", device="cpu")
    assert tr.P == jr.P == 64 and tr.device == torch.device("cpu")
    for s in (slice(0, 8), slice(8, 16)):
        part = {k: v[s] for k, v in kw.items()}
        jr.add_batch(imgs[s], rot[s], tilt[s], psi[s], **part)
        tr.add_batch(imgs[s], rot[s], tilt[s], psi[s], **part)
        for a, b in ((tr.data_r, jr.data_r), (tr.data_i, jr.data_i),
                     (tr.weights, jr.weights)):
            assert rel_err(a, np.asarray(b)) <= 1e-4


@pytest.mark.parametrize("interp", ["kb", "tri"])
def test_from_jax_state_continues_a_reference_accumulation(interp):
    (imgs, rot, tilt, psi), kw = _stack(13)
    first, second = slice(0, 8), slice(8, 16)
    jr = jrec.FourierReconstructor(N, interp=interp)
    jr.add_batch(imgs[first], rot[first], tilt[first], psi[first],
                 **{k: v[first] for k, v in kw.items()})
    tr = trec.FourierReconstructor.from_jax_state(
        np.asarray(jr.data_r), np.asarray(jr.data_i), np.asarray(jr.weights),
        N, interp=interp, device="cpu")
    tr.add_batch(imgs[second], rot[second], tilt[second], psi[second],
                 **{k: v[second] for k, v in kw.items()})
    jr.add_batch(imgs[second], rot[second], tilt[second], psi[second],
                 **{k: v[second] for k, v in kw.items()})
    assert rel_err(tr.finish(), np.asarray(jr.finish())) <= TOL[interp]


def test_from_jax_state_rejects_a_cube_of_another_size():
    z = np.zeros((32, 32, 32), np.float32)
    with pytest.raises(ValueError, match="expected"):
        trec.FourierReconstructor.from_jax_state(z, z, z, N, device="cpu")


def test_deferred_paths_raise():
    """No path of this module is deferred any more. The kz-slab mode is
    ported (tests/test_torch_parallel.py holds it against the reference): a
    slab of accumulators is taken, and full cubes given with slab_p raise.
    --useCTF gridding is ported (tests/test_torch_reconstruct_ctf.py): a
    ctfp dict is taken, and one without every CTF field raises KeyError,
    as the reference's does."""
    cubes = [torch.zeros((64, 64, 64)) for _ in range(3)]
    args, _ = _stack(14)
    one = (args[0][:1], np.eye(3)[None], [0.0], [0.0], [1.0], 64)
    with pytest.raises(ValueError, match="expected 65536"):
        trec.backproject_chunk(*cubes, *one, slab_p=16)
    slab = [torch.zeros((16, 64, 64)) for _ in range(3)]
    trec.backproject_chunk(*slab, *one, slab_p=16, slab_z0=24)
    assert float(slab[2].sum()) > 0
    with pytest.raises(KeyError):
        trec.reconstruct_fourier(*args, ctfp={"defocusU": np.ones(C)},
                                 device="cpu")
    from xmipp3_tpu_torch.ops.ctf import CTFDescription, ctf_params_arrays
    ctfp = ctf_params_arrays([CTFDescription(voltage=300, defocusU=9000,
                                             defocusV=9000)] * C)
    vol = trec.reconstruct_fourier(*args, ctfp=ctfp, interp="nn",
                                   device="cpu")
    assert torch.isfinite(vol).all() and float(vol.abs().max()) > 0
