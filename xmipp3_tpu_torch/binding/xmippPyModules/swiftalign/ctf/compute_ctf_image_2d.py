"""2-D CTF image in the rfft layout (reference
swiftalign/ctf/compute_ctf_image_2d.py role) on the port's full CTF
forward model, evaluated on the card unless `device="cpu"` is given."""
from __future__ import annotations

import numpy as np


def compute_ctf_image_2d(defocus_u, defocus_v, defocus_angle, size,
                         sampling_rate, voltage=300.0, cs=2.7, q0=0.07,
                         phase_shift=0.0, device=None):
    from xmipp3_tpu_torch.ops.ctf import CTFDescription
    ctf = CTFDescription(sampling_rate=float(sampling_rate),
                         voltage=float(voltage), Cs=float(cs),
                         Q0=float(q0), defocusU=float(defocus_u),
                         defocusV=float(defocus_v),
                         azimuthal_angle=float(defocus_angle),
                         K=1.0, phase_shift=float(phase_shift))
    return np.asarray(ctf.generate_2d(size, size, rfft_layout=True,
                                      device=device).cpu())
