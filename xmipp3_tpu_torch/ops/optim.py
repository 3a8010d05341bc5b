"""Optimizers whose objectives run on the card.

Counterpart of the reference package's ops/optim.py:

- `adam_scan`: first-order refinement as a loop of Adam steps on the
  card, each a `torch.autograd.grad` of the objective; the loop reads
  nothing back to the host (the reference runs the same steps as one
  jitted lax.scan of value_and_grad);
- `trust_region_dfo`: scipy's COBYQA (the CONDOR role of the reference's
  C++ suite) drives an objective that runs on the card from the host.
"""
from __future__ import annotations

import numpy as np
import torch

from xmipp3_tpu_torch.device import as_tensor


def adam_scan(loss_fn, x0, n_steps: int, lr, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8, device=None):
    """Minimise `loss_fn(x) -> scalar tensor` with n_steps of Adam from x0
    (float32, on `device`, the card by default; a tensor x0 stays on its
    own device). `lr` may be a scalar or a vector over x's leading axis.
    Returns (x, final_loss) as tensors: the loss is the one of the last
    step, taken before its update, as the reference's scan returns it."""
    x = as_tensor(x0, device).detach().clone()
    lr = as_tensor(lr, x.device)
    lr_b = lr.reshape(lr.shape + (1,) * (x.ndim - lr.ndim)) \
        if lr.ndim else lr
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    # the bias corrections in float32, as the reference's jnp.power
    ts = np.arange(1, n_steps + 1, dtype=np.float32)
    c1 = 1 - np.power(np.float32(b1), ts)
    c2 = 1 - np.power(np.float32(b2), ts)
    loss = torch.zeros((), device=x.device)
    for k in range(n_steps):
        xg = x.requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(xg)
            g, = torch.autograd.grad(loss, xg)
        x = xg.detach()
        loss = loss.detach()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / float(c1[k])
        vh = v / float(c2[k])
        x = x - lr_b * mh / (torch.sqrt(vh) + eps)
    return x, loss


def trust_region_dfo(loss_fn, x0, max_nfev: int = 300, rhobeg=None,
                     bounds=None):
    """Derivative-free trust-region minimiser (the CONDOR role of the
    reference's C++ suite, nma_alignment.h:40): scipy's COBYQA drives
    `loss_fn` (a float32 numpy vector -> a float, or a one-element tensor
    on any device) from the host. Returns (x, f).

    A SciPy without COBYQA raises ValueError("Unknown solver ...") for the
    method; only that error falls back to Powell, with a RuntimeWarning
    that names the method that ran. Any other error (one raised inside the
    objective, a failed launch on the card) is raised: the reference's
    `except Exception` would hide it (ROADMAP.md section 3, item 19)."""
    import warnings

    import scipy
    import scipy.optimize

    x0 = np.asarray(x0, np.float64)

    def f(x):
        return float(loss_fn(x.astype(np.float32)))

    options = {"maxfev": int(max_nfev)}
    if rhobeg is not None:
        options["initial_tr_radius"] = float(rhobeg)
    try:
        res = scipy.optimize.minimize(f, x0, method="COBYQA", bounds=bounds,
                                      options=options)
    except ValueError as e:
        if "Unknown solver" not in str(e):
            raise
        warnings.warn(f"trust_region_dfo: SciPy {scipy.__version__} has no "
                      "COBYQA; ran Powell", RuntimeWarning, stacklevel=2)
        res = scipy.optimize.minimize(
            f, x0, method="Powell",
            options={"maxfev": int(max_nfev), "xtol": 1e-3})
    return np.asarray(res.x, np.float32), float(res.fun)
