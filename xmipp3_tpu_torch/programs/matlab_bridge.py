"""MATLAB/Octave binding bridge: the port of the reference package's
programs/matlab_bridge.py (the `bindings/matlab/` role).

The .m wrappers in xmipp3_tpu_torch/binding/matlab/ marshal their
arguments into a MAT-file, shell out to `xmipp_torch matlab_bridge --func
<name> -i in.mat -o out.mat`, and load the result MAT-file. MATLAB and
Octave read and write v7 MAT-files natively; on the Python side scipy.io
reads and writes them exactly as the reference does. Function surface
and argument contracts follow the reference wrappers one to one
(reference files cited per function). Arrays cross the boundary in MATLAB
memory order; scipy.io preserves logical (i, j, k) indexing.

The image work runs on the card unless `--device cpu` is given: the
rotations, Fourier and spline resizes, the pyramid, the normalisations,
the CTF fit, the CTF phase correction, the PSD enhancement's band pass,
the periodogram, the CTF filter image, the 2-D alignment and the FRC.
The masks, morphology, the trilinear mirt3D interpolation, the 3-D
spline zooms, segmentation and the metadata functions stay on the host
(numpy and scipy), as in the reference.
"""
from __future__ import annotations

import os

import numpy as np

import torch

from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.device import as_tensor, resolve_device


def _squeeze(a):
    return np.squeeze(np.asarray(a))


def _scalar(v, default=None):
    if v is None:
        return default
    a = np.asarray(v).ravel()
    if a.size == 0:
        return default
    return float(a[0])


def _string(v, default=""):
    if v is None:
        return default
    if isinstance(v, str):
        return v
    a = np.asarray(v).ravel()
    if a.size == 0:
        return default
    return str(a[0])


def _bool(v, default=False):
    s = _scalar(v, None)
    return default if s is None else bool(s)


# ---------------------------------------------------------------------------
# image IO (xmipp_read.cpp / xmipp_write.cpp)
# ---------------------------------------------------------------------------

def _fn_read(a, dev):
    from xmipp3_tpu_torch.core.image import Image
    fn = _string(a.get("filename"))
    return {"I": np.squeeze(Image(fn).data).astype(np.float64)}


def _fn_write(a, dev):
    from xmipp3_tpu_torch.core.image import save_image
    save_image(_string(a.get("filename")),
               _squeeze(a["array"]).astype(np.float32))
    return {"ok": 1.0}


# ---------------------------------------------------------------------------
# geometry (tom_xmipp_rotate.cpp, tom_xmipp_scale.cpp,
# tom_xmipp_scale_pyramid.cpp, tom_xmipp_mirror.cpp)
# ---------------------------------------------------------------------------

def _fn_rotate(a, dev):
    from xmipp3_tpu_torch.core.geometry import align_with_z, euler_matrix
    from xmipp3_tpu_torch.ops.geo import apply_affine_2d, apply_affine_3d
    img = _squeeze(a["img"]).astype(np.float32)
    angs = np.atleast_1d(np.asarray(a["angs"], np.float64)).ravel()
    axis = np.asarray(a.get("axis"), np.float64).ravel() \
        if a.get("axis") is not None and np.asarray(a["axis"]).size else None
    align_z = np.asarray(a.get("align_z"), np.float64).ravel() \
        if a.get("align_z") is not None and np.asarray(a["align_z"]).size \
        else None
    wrap = _bool(a.get("wrap"), True)
    if img.ndim == 2:
        psi = np.deg2rad(angs[0])
        c, s = np.cos(psi), np.sin(psi)
        mat = np.array([[c, -s, 0.0], [s, c, 0.0], [0, 0, 1]], np.float32)
        out = apply_affine_2d(as_tensor(img[None], dev),
                              as_tensor(mat[None], dev), order=3,
                              wrap=wrap)[0].cpu().numpy()
    else:
        if align_z is not None:
            A = np.asarray(align_with_z(align_z), np.float64)[:3, :3]
        elif axis is not None:
            Z = np.asarray(align_with_z(axis), np.float64)[:3, :3]
            psi = np.deg2rad(angs[0])
            c, s = np.cos(psi), np.sin(psi)
            Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)
            A = Z.T @ Rz @ Z
        else:
            rot, tilt, psi = (list(angs) + [0.0, 0.0])[:3]
            A = np.asarray(euler_matrix(np.float32(rot), np.float32(tilt),
                                        np.float32(psi)), np.float64)
            A = A.reshape(3, 3)
        out = apply_affine_3d(as_tensor(img, dev),
                              as_tensor(A.astype(np.float32)[None], dev),
                              wrap=wrap)[0].cpu().numpy()
    return {"img_out": out.astype(np.float64)}


def _fn_scale(a, dev):
    from xmipp3_tpu_torch.ops.resize import (fourier_resize_2d,
                                             fourier_resize_3d,
                                             spline_resize_2d)
    img = _squeeze(a["img"]).astype(np.float32)
    outsize = np.asarray(a["outsize"], np.float64).ravel().astype(int)
    gridding = _bool(a.get("gridding"), False)
    if img.ndim == 2:
        oh, ow = int(outsize[0]), int(outsize[1])
        fn = fourier_resize_2d if gridding else spline_resize_2d
        out = fn(as_tensor(img[None], dev), oh, ow)[0].cpu().numpy()
    else:
        od, oh, ow = (int(outsize[i]) if i < len(outsize) else img.shape[i]
                      for i in range(3))
        if gridding:
            out = fourier_resize_3d(as_tensor(img, dev), od, oh, ow) \
                .cpu().numpy()
        else:
            from scipy.ndimage import zoom
            out = zoom(img, (od / img.shape[0], oh / img.shape[1],
                             ow / img.shape[2]), order=3)
    return {"img_out": np.asarray(out, np.float64)}


def _fn_scale_pyramid(a, dev):
    from xmipp3_tpu_torch.ops.resize import pyramid_reduce_2d, spline_resize_2d
    img = _squeeze(a["img"]).astype(np.float32)
    op = _string(a.get("operation"), "reduce").lower()
    levels = int(_scalar(a.get("levels"), 1))
    f = 2 ** levels
    if img.ndim == 2:
        if op == "reduce":
            out = pyramid_reduce_2d(as_tensor(img[None], dev),
                                    levels)[0].cpu().numpy()
        else:
            out = spline_resize_2d(as_tensor(img[None], dev),
                                   img.shape[0] * f,
                                   img.shape[1] * f)[0].cpu().numpy()
    else:
        from scipy.ndimage import zoom
        s = (1.0 / f) if op == "reduce" else float(f)
        out = zoom(img, s, order=3)
    return {"img_out": np.asarray(out, np.float64)}


def _fn_mirror(a, dev):
    img = _squeeze(a["img"])
    flip = _string(a.get("flipstring"), "")
    # logical image axes: x = fastest (last), y = next, z = first
    axes = []
    if "x" in flip:
        axes.append(img.ndim - 1)
    if "y" in flip:
        axes.append(img.ndim - 2)
    if "z" in flip and img.ndim == 3:
        axes.append(0)
    out = np.flip(img, axes) if axes else img
    return {"img_out": np.asarray(out, np.float64)}


def _fn_mirt3d_interp(a, dev):
    """mirt3D_mexinterp.cpp: trilinear interpolation at MATLAB 1-based
    (XI, YI, ZI) with NaN outside the grid; 4-D stacks interpolate each
    volume at the same points."""
    from scipy.ndimage import map_coordinates
    vol = np.asarray(a["input_image"], np.float64)
    xi = np.asarray(a["XI"], np.float64) - 1.0     # MATLAB 1-based
    yi = np.asarray(a["YI"], np.float64) - 1.0
    zi = np.asarray(a["ZI"], np.float64) - 1.0
    vols = vol[None] if vol.ndim == 3 else np.moveaxis(vol, -1, 0)
    outs = [map_coordinates(v, [yi.ravel(), xi.ravel(), zi.ravel()],
                            order=1, mode="constant", cval=np.nan)
            .reshape(xi.shape) for v in vols]
    out = outs[0] if vol.ndim == 3 else np.stack(outs, axis=-1)
    return {"output_image": out}


# ---------------------------------------------------------------------------
# masks / morphology / normalization (tom_xmipp_mask.cpp,
# tom_xmipp_morphology.cpp, tom_xmipp_normalize.cpp)
# ---------------------------------------------------------------------------

def _fn_mask(a, dev):
    from xmipp3_tpu_torch.ops import mask as M
    msize = np.asarray(a["msize"], np.float64).ravel().astype(int)
    shape = tuple(int(s) for s in msize if s > 1) or (int(msize[0]),)
    typ = _string(a.get("type"), "circular").lower()
    par = np.asarray(a.get("params"), np.float64).ravel() \
        if a.get("params") is not None else np.zeros(0)
    inner = _bool(a.get("inner"), False)     # negative-radius mode 1
    if typ == "circular":
        m = np.asarray(M.circular_mask(shape, abs(par[0])))
    elif typ == "crown":
        m = np.asarray(M.crown_mask(shape, abs(par[0]), abs(par[1])))
    elif typ == "rectangular":
        hx, hy = int(abs(par[0])) // 2, int(abs(par[1])) // 2
        hz = int(abs(par[2])) // 2 if len(par) > 2 and len(shape) == 3 \
            else None
        m = np.asarray(M.rectangular_mask(shape, hx, hy, hz))
    elif typ == "gaussian":
        m = np.asarray(M.gaussian_mask(shape, abs(par[0])))
    elif typ == "raised_cosine":
        r1, r2 = abs(par[0]), abs(par[1])
        grids = np.meshgrid(*[np.arange(s, dtype=np.float64) - s // 2
                              for s in shape], indexing="ij")
        r = np.sqrt(sum(g * g for g in grids))
        m = np.where(r <= r1, 1.0, np.where(
            r >= r2, 0.0,
            0.5 * (1 + np.cos(np.pi * (r - r1) / max(r2 - r1, 1e-9)))))
    elif typ == "cylinder":
        r1, h = abs(par[0]), abs(par[1])
        z = np.arange(shape[0], dtype=np.float64) - shape[0] // 2
        yy = np.arange(shape[1], dtype=np.float64) - shape[1] // 2
        xx = np.arange(shape[2], dtype=np.float64) - shape[2] // 2
        rr = np.sqrt(yy[:, None] ** 2 + xx[None, :] ** 2)
        m = ((np.abs(z)[:, None, None] <= h / 2) &
             (rr[None] <= r1)).astype(np.float64)
    else:
        raise ValueError(f"unsupported mask type '{typ}'")
    m = np.asarray(m, np.float64)
    if inner:
        m = 1.0 - m
    return {"mask": m}


def _fn_morphology(a, dev):
    from scipy import ndimage
    img = _squeeze(a["img"])
    b = img > 0.5
    op = _string(a.get("operation"), "dilation").lower()
    neig = int(_scalar(a.get("neig"), 8 if b.ndim == 2 else 18))
    size = int(_scalar(a.get("ksize"), 1))
    count = int(_scalar(a.get("count"), 0))
    conn = {4: 1, 8: 2, 6: 1, 18: 2, 26: 3}.get(neig, 2)
    st = ndimage.generate_binary_structure(b.ndim, conn)

    def dil(x):
        for _ in range(size):
            if count > 0:
                nb = ndimage.convolve(x.astype(np.int32),
                                      st.astype(np.int32),
                                      mode="constant") - x.astype(np.int32)
                x = x | (nb >= count)
            else:
                x = ndimage.binary_dilation(x, st)
        return x

    def ero(x):
        for _ in range(size):
            if count > 0:
                nb = ndimage.convolve((~x).astype(np.int32),
                                      st.astype(np.int32),
                                      mode="constant") - (~x).astype(np.int32)
                x = x & ~(nb >= count)
            else:
                x = ndimage.binary_erosion(x, st)
        return x

    if op == "dilation":
        out = dil(b)
    elif op == "erosion":
        out = ero(b)
    elif op == "opening":
        out = dil(ero(b))
    elif op == "closing":
        out = ero(dil(b))
    else:
        raise ValueError(f"unknown morphology operation '{op}'")
    return {"img_out": out.astype(np.float64)}


def _fn_normalize(a, dev):
    from xmipp3_tpu_torch.ops import normalize as N
    img = _squeeze(a["img"]).astype(np.float32)
    method = _string(a.get("method"), "NewXmipp").lower()
    mask = a.get("mask")
    imgs = as_tensor(img[None], dev)
    if mask is not None and np.asarray(mask).size:
        # explicit background mask (the tom wrapper's third argument)
        bg = torch.as_tensor(_squeeze(mask) > 0.5, device=dev)
        fns = {"newxmipp": lambda: N.normalize_new_xmipp(
                   N.subtract_background_plane(imgs, bg), bg),
               "newxmipp2": lambda: N.normalize_new_xmipp2(imgs, bg),
               "near_oldxmipp": lambda: N.normalize_near_old_xmipp(imgs,
                                                                   bg),
               "ramp": lambda: N.normalize_ramp(imgs, bg),
               "oldxmipp": lambda: N.normalize_old_xmipp(imgs)}
        if method not in fns:
            raise ValueError(f"unsupported masked normalize '{method}'")
        out = fns[method]()[0]
    else:
        out = N.normalize(imgs, method=method)[0]
    if isinstance(out, torch.Tensor):
        out = out.cpu().numpy()
    return {"img_out": np.asarray(out, np.float64)}


# ---------------------------------------------------------------------------
# CTF family (tom_xmipp_adjust_ctf.cpp, tom_xmipp_ctf_correct_phase.cpp,
# tom_xmipp_psd_enhance.cpp, xmipp_ctf_generate_filter.cpp,
# tom_calc_periodogram.m)
# ---------------------------------------------------------------------------

def _half_from_full(psd):
    """The tom wrappers pass a FULL centered periodogram; the estimator
    consumes the rfft half layout (origin at [0,0])."""
    n = psd.shape[0]
    full = np.fft.ifftshift(psd)
    return np.ascontiguousarray(full[:, : n // 2 + 1]).astype(np.float32)


def _ctf_struct(ctf):
    return {
        "DeltafU": ctf.defocusU, "DeltafV": ctf.defocusV,
        "AzimuthalAngle": ctf.azimuthal_angle, "kV": ctf.voltage,
        "K": ctf.K, "Cs": ctf.Cs, "Ca": ctf.Ca, "espr": ctf.espr,
        "ispr": ctf.ispr, "alpha": ctf.alpha, "DeltaF": ctf.DeltaF,
        "DeltaR": ctf.DeltaR, "Q0": ctf.Q0, "base_line": ctf.base_line,
        "sqrt_K": ctf.sqrt_K, "sqU": ctf.sqU, "sqV": ctf.sqV,
        "sqrt_angle": ctf.sqrt_angle, "gaussian_K": ctf.gaussian_K,
        "sigmaU": ctf.sigmaU, "sigmaV": ctf.sigmaV,
        "gaussian_angle": ctf.gaussian_angle, "cU": ctf.cU, "cV": ctf.cV,
        "gaussian_K2": ctf.gaussian_K2, "sigmaU2": ctf.sigmaU2,
        "sigmaV2": ctf.sigmaV2, "gaussian_angle2": ctf.gaussian_angle2,
        "cU2": ctf.cU2, "cV2": ctf.cV2,
        "objectPixelSize": ctf.sampling_rate,
    }


def _fn_adjust_ctf(a, dev):
    from xmipp3_tpu_torch.models.ctf_estimation import CTFEstimator
    psd = _squeeze(a["psd"]).astype(np.float32)
    Dz = _scalar(a.get("Dz"), 10000.0)
    voltage = _scalar(a.get("voltage"), 300.0)
    Ts = _scalar(a.get("objectPixelSize"), 1.0)
    model_size = int(_scalar(a.get("ctfmodelSize"), 0))
    Cs = _scalar(a.get("Cs"), 2.0)
    min_freq = _scalar(a.get("min_freq"), 0.03)
    max_freq = _scalar(a.get("max_freq"), 0.3)
    Ca = _scalar(a.get("Ca"), 2.0)
    est = CTFEstimator(_half_from_full(psd), Ts, voltage, Cs, Q0=0.1,
                       Ca=Ca, min_freq=min_freq, max_freq=max_freq,
                       initial_defocus=(abs(Dz), abs(Dz), 0.0), device=dev)
    ctf = est.estimate()
    out = _ctf_struct(ctf)
    if model_size > 0:
        fy = np.fft.fftfreq(model_size).astype(np.float32)[:, None] / Ts
        fx = np.fft.rfftfreq(model_size).astype(np.float32)[None, :] / Ts
        half = ctf.pure_at(fx, fy, device=dev).cpu().numpy() ** 2
        full = np.concatenate([half, half[:, -2:0:-1]], axis=1)
        out["CTFmodelhalf"] = np.fft.fftshift(full)[:, : model_size]
        out["CTFmodelquadrant"] = np.fft.fftshift(full)
    return out


def _fn_ctf_correct_phase(a, dev):
    from xmipp3_tpu_torch.ops.ctf import CTFDescription
    img = _squeeze(a["img"]).astype(np.float32)
    st = a.get("st", {})

    def g(k, d=0.0):
        return _scalar(st.get(k) if isinstance(st, dict) else None, d)

    ctf = CTFDescription(
        sampling_rate=g("objectPixelSize", 1.0), voltage=g("kV", 300.0),
        defocusU=g("DeltafU"), defocusV=g("DeltafV"),
        azimuthal_angle=g("AzimuthalAngle"), Cs=g("Cs", 2.0),
        Ca=g("Ca", 2.0), Q0=g("Q0", 0.1), K=max(g("K", 1.0), 1e-6))
    method = _string(a.get("method"), "leave").lower()
    eps = _scalar(a.get("epsilon"), 0.0)
    n = img.shape[0]
    Ts = ctf.sampling_rate
    fy = np.fft.fftfreq(n).astype(np.float32)[:, None] / Ts
    fx = np.fft.rfftfreq(img.shape[1]).astype(np.float32)[None, :] / Ts
    h = ctf.pure_at(fx, fy, device=dev).float()
    spec = torch.fft.rfft2(as_tensor(img, dev))
    small = h.abs() < max(eps, 1e-12)
    if method == "remove":
        spec = torch.where(small, 0.0, spec * torch.sign(h))
    elif method == "divide":
        spec = torch.where(small, spec, spec / torch.where(small, 1.0, h))
    else:                                    # leave
        spec = torch.where(small, spec, spec * torch.sign(h))
    out = torch.fft.irfft2(spec, s=img.shape)
    return {"img_out": out.cpu().numpy().astype(np.float64)}


def _fn_psd_enhance(a, dev):
    from xmipp3_tpu_torch.programs.ctf_correct import enhance_psd_filter
    psd = _squeeze(a["img"]).astype(np.float64)
    out = enhance_psd_filter(
        psd,
        _scalar(a.get("filter_w1"), 0.05), _scalar(a.get("filter_w2"), 0.2),
        _scalar(a.get("decay_width"), 0.02),
        _scalar(a.get("mask_w1"), 0.025), _scalar(a.get("mask_w2"), 0.2),
        do_log=_bool(a.get("take_log"), True),
        center=_bool(a.get("center"), True), device=dev)
    return {"img_out": np.asarray(out, np.float64)}


def _fn_periodogram(a, dev):
    from xmipp3_tpu_torch.ops.psd import estimate_psd
    img = _squeeze(a["image"]).astype(np.float32)
    sz = int(_scalar(a.get("sz"), 512))
    half = estimate_psd(img, sz, 0.5, device=dev).cpu().numpy() \
        .astype(np.float64)
    full = np.concatenate([half, half[:, -2:0:-1]], axis=1)[:, :sz]
    return {"psd": np.fft.fftshift(full)}


def _fn_ctf_generate_filter(a, dev):
    """xmipp_ctf_generate_filter.cpp: centered CTF filter image of size
    Xdim for explicit CTF params (used by xmipp_ctf_for_metadata_row.m)."""
    from xmipp3_tpu_torch.ops.ctf import CTFDescription
    Xdim = int(_scalar(a.get("Xdim"), 256))
    Ts = _scalar(a.get("Tm"), 1.0)
    ctf = CTFDescription(
        sampling_rate=Ts, voltage=_scalar(a.get("kV"), 300.0),
        defocusU=_scalar(a.get("DeltafU"), 10000.0),
        defocusV=_scalar(a.get("DeltafV"),
                         _scalar(a.get("DeltafU"), 10000.0)),
        azimuthal_angle=_scalar(a.get("AzimuthalAngle"), 0.0),
        Cs=_scalar(a.get("Cs"), 2.0), Q0=_scalar(a.get("Q0"), 0.1),
        K=_scalar(a.get("K"), 1.0))
    fy = np.fft.fftfreq(Xdim).astype(np.float32)[:, None] / Ts
    fx = np.fft.rfftfreq(Xdim).astype(np.float32)[None, :] / Ts
    half = ctf.pure_at(fx, fy, device=dev).cpu().numpy().astype(np.float64)
    full = np.concatenate([half, half[:, -2:0:-1]], axis=1)[:, :Xdim]
    return {"ctfFilter": full}


# ---------------------------------------------------------------------------
# analysis (tom_xmipp_align2d.cpp, tom_xmipp_resolution.cpp,
# tom_xmipp_volume_segment.cpp)
# ---------------------------------------------------------------------------

def _fn_align2d(a, dev):
    from xmipp3_tpu_torch.ops.align import iterative_align
    from xmipp3_tpu_torch.ops.polar import best_rotation
    from xmipp3_tpu_torch.ops.shift import best_shift
    img = _squeeze(a["img"]).astype(np.float32)
    ref = _squeeze(a["ref"]).astype(np.float32)
    mode = _string(a.get("mode"), "complete").lower()
    max_shift = _scalar(a.get("max_shift"), 0.0) or None
    rin = int(_scalar(a.get("Rin"), 2))
    rout = int(_scalar(a.get("Rout"), img.shape[0] // 2 - 2))
    psi, sx, sy = 0.0, 0.0, 0.0
    if mode == "trans":
        sxj, syj, _ = best_shift(as_tensor(ref, dev),
                                 as_tensor(img[None], dev),
                                 max_shift=None if max_shift is None
                                 else int(max_shift))
        sx, sy = float(sxj[0]), float(syj[0])
    elif mode == "rot":
        ang, _ = best_rotation(ref, img[None], radius_min=max(rin, 1),
                               radius_max=min(rout, img.shape[0] // 2 - 2),
                               device=dev)
        psi = float(ang[0])
    else:
        psij, sxj, syj, _, _ = iterative_align(
            as_tensor(ref, dev), as_tensor(img[None], dev), n_iters=3,
            max_shift=None if max_shift is None else int(max_shift))
        psi = float(psij[0])
        sx, sy = float(sxj[0]), float(syj[0])
    c, s = np.cos(np.deg2rad(psi)), np.sin(np.deg2rad(psi))
    tform = np.array([[c, -s, sx], [s, c, sy], [0, 0, 1]], np.float64)
    return {"Xoff": sx, "Yoff": sy, "Psi": psi, "Tform": tform}


def _fn_resolution(a, dev):
    from xmipp3_tpu_torch.ops.fsc import frc_dpr_curves
    img = _squeeze(a["img"]).astype(np.float32)
    ref = _squeeze(a["ref"]).astype(np.float32)
    Ts = _scalar(a.get("objectpixelsize"), 1.0)
    out = frc_dpr_curves(img, ref, sampling=Ts, do_dpr=True, device=dev)
    return {"freq": out["freq"], "dpr": out["dpr"], "frc": out["frc"],
            "frc_noise": out["frc_noise"]}


def _fn_volume_segment(a, dev):
    vol = _squeeze(a["vol"]).astype(np.float64)
    Ts = _scalar(a.get("sampling"), 1.0)
    mass = _scalar(a.get("mass"), 0.0)
    typ = _string(a.get("type"), "voxels").lower()
    if _bool(a.get("enable_threshold"), False):
        th = _scalar(a.get("threshold"), 0.0)
    else:
        # voxel count from mass (reference volume_segment.cpp mass modes:
        # 1.207 Da/A^3 protein density; ~110 Da per amino acid)
        if typ.startswith("dalton"):
            n_keep = int(mass / (1.207 * Ts ** 3))
        elif typ.startswith("amino"):
            n_keep = int(mass * 110.0 / (1.207 * Ts ** 3))
        else:
            n_keep = int(mass)
        n_keep = int(np.clip(n_keep, 1, vol.size))
        th = np.partition(vol.ravel(), -n_keep)[-n_keep]
    mask = (vol >= th).astype(np.float64)
    return {"seg_mask": mask, "vol_seg": vol * mask,
            "threshold": float(th)}


# ---------------------------------------------------------------------------
# metadata / NMA / structure factor (xmipp_read_metadata.m,
# xmipp_nma_read_alignment.cpp, xmipp_nma_save_cluster.cpp,
# xmipp_read_structure_factor.cpp)
# ---------------------------------------------------------------------------

def _fn_read_metadata(a, dev):
    from xmipp3_tpu_torch.core.metadata import MetaData
    md = MetaData(_string(a.get("filename")))
    out = {}
    for label in md.getActiveLabels():
        col = [md.getValue(label, oid) for oid in md]
        arr = np.asarray(col)
        if arr.dtype.kind in "OUS":
            out[label] = np.asarray([str(v) for v in col], dtype=object)
        else:
            out[label] = arr.astype(np.float64)
    return out


def _fn_nma_read_alignment(a, dev):
    from xmipp3_tpu_torch.core.metadata import MetaData
    d = _string(a.get("NMAdirectory"))
    md = MetaData(os.path.join(d, "images.xmd"))
    images, disp, cost = [], [], []
    for oid in md:
        images.append(str(md.getValue("image", oid)))
        v = md.getValue("nmaDisplacements", oid)
        disp.append(np.asarray(v, np.float64).ravel())
        c = md.getValue("cost", oid)
        cost.append(float(c) if c is not None else 0.0)
    return {"images": np.asarray(images, dtype=object),
            "NMAdisplacements": np.asarray(disp, np.float64),
            "cost": np.asarray(cost, np.float64)}


def _fn_nma_save_cluster(a, dev):
    from xmipp3_tpu_torch.core.metadata import MetaData
    d = _string(a.get("NMAdirectory"))
    name = _string(a.get("clusterName"), "cluster")
    sel = np.asarray(a.get("inCluster"), np.float64).ravel() > 0.5
    md = MetaData(os.path.join(d, "images.xmd"))
    rows = [{"image": str(md.getValue("image", oid)), "enabled": 1}
            for keep, oid in zip(sel, md) if keep]
    out = os.path.join(d, f"{name}.xmd")
    MetaData.fromRows(rows or [{"image": "none", "enabled": 0}]).write(out)
    return {"written": out, "n": float(int(sel.sum()))}


def _fn_read_structure_factor(a, dev):
    from xmipp3_tpu_torch.core.metadata import MetaData
    d = _string(a.get("rundir"))
    fn = d if d.endswith(".xmd") else os.path.join(d, "structureFactor.xmd")
    md = MetaData(fn)
    f2, logF = [], []
    for oid in md:
        f = md.getValue("resolutionFreq", oid)
        v = md.getValue("resolutionLogStructure", oid)
        if f is None or v is None:
            continue
        f2.append(float(f) ** 2)
        logF.append(float(v))
    return {"f2": np.asarray(f2, np.float64),
            "logF": np.asarray(logF, np.float64)}


FUNCS = {
    "read": _fn_read, "write": _fn_write,
    "rotate": _fn_rotate, "scale": _fn_scale,
    "scale_pyramid": _fn_scale_pyramid, "mirror": _fn_mirror,
    "mirt3D_mexinterp": _fn_mirt3d_interp,
    "mask": _fn_mask, "morphology": _fn_morphology,
    "normalize": _fn_normalize,
    "adjust_ctf": _fn_adjust_ctf,
    "ctf_correct_phase": _fn_ctf_correct_phase,
    "psd_enhance": _fn_psd_enhance, "periodogram": _fn_periodogram,
    "ctf_generate_filter": _fn_ctf_generate_filter,
    "align2d": _fn_align2d, "resolution": _fn_resolution,
    "volume_segment": _fn_volume_segment,
    "read_metadata": _fn_read_metadata,
    "nma_read_alignment": _fn_nma_read_alignment,
    "nma_save_cluster": _fn_nma_save_cluster,
    "read_structure_factor": _fn_read_structure_factor,
}


class ProgMatlabBridge(XmippProgram):
    """`xmipp_torch matlab_bridge --func <name> -i <in.mat> -o <out.mat>`.

    One call per wrapper invocation: loads the argument MAT-file, runs the
    named bridge function, saves the result MAT-file (v5 format — readable
    by MATLAB >= R13 and Octave)."""
    name = "xmipp_matlab_bridge"

    def defineParams(self):
        self.addUsageLine("MATLAB/Octave binding bridge "
                          "(xmipp3_tpu_torch/binding/matlab).")
        self.addParamsLine("   --func <name> : Bridge function "
                           f"({', '.join(sorted(FUNCS))})")
        self.addParamsLine("   -i <inmat> : Input MAT-file with the "
                           "wrapper's arguments")
        self.addParamsLine("   -o <outmat> : Output MAT-file")

    def run(self):
        from scipy.io import loadmat, savemat
        func = self.getParam("--func")
        if func not in FUNCS:
            raise ValueError(f"unknown bridge function '{func}'")
        raw = loadmat(self.getParam("-i"), squeeze_me=False,
                      struct_as_record=False, simplify_cells=True)
        args = {k: v for k, v in raw.items() if not k.startswith("__")}
        out = FUNCS[func](args, resolve_device(self.getParam("--device")))
        savemat(self.getParam("-o"), out, do_compression=False)
        if self.verbose:
            print(f"matlab_bridge {func}: wrote {self.getParam('-o')}")
