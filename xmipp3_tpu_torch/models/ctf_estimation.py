"""CTF estimation: fit the full CTF forward model to an observed PSD.

Counterpart of the reference package's models/ctf_estimation.py (after
the reference's staged estimation, ctf_estimate_from_psd.cpp: background
fits :1072-, the astigmatic defocus grid :1778, the refinement of the
28-parameter model under CTF_fitness :601-984), on the card:

- one float32 model/fitness over the flat band of PSD pixels, batched over
  a leading (estimates, candidates) axis pair and evaluated in chunks of
  at most CHUNK candidate-pixels, so that hundreds of PSDs stay within a
  few GB;
- the compass (pattern) search is a Python loop of rounds over device
  tensors: every round scores all 2F+1 coordinate candidates of every
  estimate in one batched pass, and the move, the step halving and the
  best cost are torch.where updates, so no round waits for the host. The
  reference's vmaps over seeds, bands, PSDs and micrographs are the leading
  batch axis;
- what the reference keeps on the host stays there: the scipy
  least-squares background fit, the Gaussian initialisation, the candidate
  grids and the sector FFTs of the fast defocus initialiser.

The 1-D radial variant (reference ctf_estimate_from_psd_fast) is
`estimate_ctf_1d`; `estimate_ctf_batch` runs B estimates in lockstep.
Entry points take `device=` (the card by default; "cpu" on request).
"""
from __future__ import annotations

import math

import numpy as np
import scipy.optimize
import torch

from xmipp3_tpu_torch.core.timing import timed_phase, timing_enabled
from xmipp3_tpu_torch.device import as_tensor, resolve_device
from xmipp3_tpu_torch.ops.ctf import CTFDescription, _bessel_j0

# ---------------------------------------------------------------------------
# parameter vector layout (all float32; angles in degrees, alpha in rad)
# ---------------------------------------------------------------------------
DEFU, DEFV, ANGLE, LOGK = 0, 1, 2, 3
ESPR, ALPHA, DELTAF, DELTAR, ENVR1, ENVR2 = 4, 5, 6, 7, 8, 9
BASE, SQK, SQU, SQV, SQANG = 10, 11, 12, 13, 14
G1K, G1SU, G1SV, G1ANG, G1CU, G1CV = 15, 16, 17, 18, 19, 20
G2K, G2SU, G2SV, G2ANG, G2CU, G2CV = 21, 22, 23, 24, 25, 26
PHASE_SHIFT = 27
NPARAMS = 28

# named stages -> indices free to move (reference action levels 0..7,
# ctf_estimate_from_psd.cpp CTF_fitness action thresholds)
STAGE_SETS = {
    "bg_sqrt": [BASE, SQK, SQU, SQV, SQANG],
    "bg_gauss": [G1K, G1SU, G1SV, G1ANG, G1CU, G1CV],
    "defocus": [DEFU, DEFV, ANGLE, LOGK],
    "envelope": [DEFU, DEFV, ANGLE, LOGK, ESPR, ALPHA, ENVR1, ENVR2],
    "bg_gauss2": [G2K, G2SU, G2SV, G2ANG, G2CU, G2CV],
    "all": list(range(NPARAMS - 1)),
    "all_vpp": list(range(NPARAMS)),
}

# candidate-pixels scored by one fitness pass: a float32 intermediate of a
# chunk is 64 MB
CHUNK = 1 << 24

# compass rounds queued since the last reset (counted on the host; reading
# it never waits for the card)
compass_stats = {"calls": 0, "rounds": 0}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class _Grid:
    """Per-pixel quantities of a frequency grid (1/Å), fy and fx
    broadcastable: u², u, u⁴, √u and cos 2θ, sin 2θ."""

    def __init__(self, fy, fx, device=None):
        fy = as_tensor(fy, device)
        fx = as_tensor(fx, fy.device)
        self.u2 = fx * fx + fy * fy
        self.u = torch.sqrt(self.u2)
        self.u4 = self.u2 * self.u2
        self.sqrt_u = torch.sqrt(self.u)
        safe = torch.clamp(self.u2, min=1e-30)
        self.c2t = (fx * fx - fy * fy) / safe
        self.s2t = 2 * fx * fy / safe
        self.nd = self.u2.ndim
        self.device = self.u2.device


def _side(consts) -> dict:
    """The model's constants (reference produceSideInfo, ctf.cpp:645-678)
    from consts = (voltage kV, Cs mm, Ca mm, Q0, VPP_radius), computed in
    float32 as the reference evaluates them; returned as Python floats
    holding float32 values, so that no constant is a device tensor."""
    f = np.float32
    voltage, Cs, Ca, Q0, vpp_r = (f(c) for c in consts)
    local_Cs = Cs * f(1e7)
    local_Ca = Ca * f(1e7)
    local_kV = voltage * f(1e3)
    lam = f(12.2643247) / np.sqrt(local_kV * (f(1) + f(0.978466e-6)
                                              * local_kV))
    vpp_m = max(vpp_r, f(1e-6))
    return dict(
        voltage=float(voltage), Q0=float(Q0), vpp_r=float(vpp_r),
        K1=float(f(np.pi) * lam),
        K2=float(f(np.pi / 2) * local_Cs * (lam * lam * lam)),
        K3c=float(f(0.25 * np.pi) * local_Ca * lam),
        lam=float(lam), K7=float(local_Cs * (lam * lam)),
        Ksin=float(np.sqrt(max(f(1) - Q0 * Q0, f(0)))),
        vpp_den=float(f(2) * (vpp_m * vpp_m)),
        log2=float(np.log(f(2.0))))


def _cols(p, nd: int):
    """p (..., NPARAMS) -> a function k -> p[..., k] shaped to broadcast
    against a grid of nd dimensions."""
    shape = p.shape[:-1] + (1,) * nd
    return lambda k: p[..., k].reshape(shape)


# the parameters of each half of the model
SIGNAL_PARAMS = frozenset(range(BASE)) | {PHASE_SHIFT}
NOISE_PARAMS = frozenset(range(BASE, PHASE_SHIFT))


def _signal(c, g: _Grid, s: dict):
    """(K * CTF * E)^2 of the parameter columns c on grid g."""
    u, u2, u4, c2t, s2t = g.u, g.u2, g.u4, g.c2t, g.s2t
    # --- astigmatic defocus
    az = torch.deg2rad(c(ANGLE))
    cos2 = c2t * torch.cos(2 * az) + s2t * torch.sin(2 * az)
    defU, defV = c(DEFU), c(DEFV)
    deltaf = -(defU + defV) / 2 + (-(defU - defV) / 2) * cos2
    deltaf = torch.where(u2 > 0, deltaf, 0.0)
    arg = s["K1"] * deltaf * u2
    if abs(s["vpp_r"]) > 1e-3:
        arg = -c(PHASE_SHIFT) * (1 - torch.exp(-u2 / s["vpp_den"])) + arg
    arg = arg + s["K2"] * u4
    ctf = -(s["Ksin"] * torch.sin(arg) - s["Q0"] * torch.cos(arg))

    # --- envelope (reference getValueDampingAt, ctf.h:424-448)
    K3 = (s["K3c"] * (c(ESPR) / s["voltage"])) ** 2 / s["log2"]
    K5 = math.pi * c(DELTAF) * s["lam"]
    alpha = c(ALPHA)
    K6 = math.pi ** 2 * alpha * alpha
    Eespr = torch.exp(-K3 * u4)
    EdeltaF = _bessel_j0(K5 * u2)
    EdeltaR = torch.sinc(u * c(DELTAR))
    aux = s["K7"] * u2 * u + deltaf * u
    Ealpha = torch.exp(-K6 * aux * aux)
    E = Eespr * EdeltaF * EdeltaR * Ealpha + c(ENVR1) * u + c(ENVR2) * u2
    E = torch.clamp(E, min=0.0)
    return (torch.exp(c(LOGK)) * ctf * E) ** 2


def _noise(c, g: _Grid):
    """Anisotropic background of the parameter columns c on grid g
    (reference getValueNoiseAt, ctf.h:506-539), clamped at 0. The two
    ellipses of a Gaussian share their angle's weights."""
    c2t, s2t, u = g.c2t, g.s2t, g.u

    def weights(angle_deg):
        a = torch.deg2rad(angle_deg)
        cos2d = c2t * torch.cos(2 * a) + s2t * torch.sin(2 * a)
        return (1 + cos2d) / 2, (1 - cos2d) / 2

    def ellip(valU, valV, w):
        # elliptically interpolated radial parameter (reference
        # precomputeValues noise-parameter ellipses, data/ctf.cpp)
        cc, ss = w
        valU, valV = valU.abs(), valV.abs()
        return torch.sqrt(valU * valU * cc + valV * valV * ss)

    w1, w2 = weights(c(G1ANG)), weights(c(G2ANG))
    sq = ellip(c(SQU), c(SQV), weights(c(SQANG)))
    sig1, c1 = ellip(c(G1SU), c(G1SV), w1), ellip(c(G1CU), c(G1CV), w1)
    sig2, c2c = ellip(c(G2SU), c(G2SV), w2), ellip(c(G2CU), c(G2CV), w2)
    noise = (c(BASE)
             + c(G1K).abs() * torch.exp(-sig1 * (u - c1) ** 2)
             + c(SQK).abs() * torch.exp(-sq * g.sqrt_u)
             - c(G2K).abs() * torch.exp(-sig2 * (u - c2c) ** 2))
    return torch.clamp(noise, min=0.0)


def _parts(p, g: _Grid, s: dict):
    """(noise, signal) halves of the model PSD of parameters p (...,
    NPARAMS) on grid g: anisotropic noise and (K * CTF * E)^2, shaped
    p.shape[:-1] + the grid's shape."""
    c = _cols(p, g.nd)
    return _noise(c, g), _signal(c, g, s)


def _finite(x):
    return torch.nan_to_num(x, nan=0.0, posinf=1e30)


def _model_parts(p, fy, fx, n: int, consts):
    """(noise, signal) halves of the model PSD of p (..., NPARAMS) at
    frequencies fy, fx (1/Å, broadcastable); consts = (voltage kV, Cs mm,
    Ca mm, Q0, VPP_radius). `n` is unused (the reference's signature)."""
    p = as_tensor(p)
    return _parts(p, _Grid(fy, fx, p.device), _side(consts))


def _model_psd(p, fy, fx, n: int, consts):
    """Full model PSD: anisotropic noise + (K * CTF * E)^2, clamped to a
    finite range (host optimisers explore extreme parameters)."""
    noise, signal = _model_parts(p, fy, fx, n, consts)
    return torch.clamp(_finite(noise + signal), 0.0, 1e30)


def _masked_pearson(a, b, w):
    """Weighted Pearson correlation over the last axis."""
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    aw = (a * w).sum(-1, keepdim=True) / wsum
    bw = (b * w).sum(-1, keepdim=True) / wsum
    num = ((a - aw) * (b - bw) * w).sum(-1)
    den = torch.sqrt(((a - aw) ** 2 * w).sum(-1)
                     * ((b - bw) ** 2 * w).sum(-1))
    return num / torch.clamp(den, min=1e-12)


class _FitData:
    """One or R observed PSDs on a flat pixel list with their band weights
    and, optionally, enhanced PSDs: everything of the fitness that does not
    depend on the candidate, computed once. psd, band and enh_img are (nb,)
    or (R, nb) tensors on one device; a leading 1 is shared by every
    estimate."""

    def __init__(self, psd, fy, fx, band, consts, enh=None):
        psd = as_tensor(psd)
        dev = psd.device
        self.grid = _Grid(fy, fx, dev)
        self.side = _side(consts)
        psd = psd.reshape(-1, psd.shape[-1])
        w = as_tensor(band, dev).reshape(-1, psd.shape[-1])
        self.lo = torch.log1p(torch.clamp(psd, min=0.0))
        self.w = w
        self.wsum = w.sum(-1, keepdim=True)
        wpos = torch.clamp(self.wsum, min=1.0)
        lo_c = self.lo - (self.lo * w).sum(-1, keepdim=True) / wpos
        self.lo_cw = lo_c * w
        self.lo_ss = (lo_c * lo_c * w).sum(-1, keepdim=True)
        self.enh_w = 0.0
        if enh is not None:
            img, self.enh_w = enh
            img = as_tensor(img, dev).reshape(-1, psd.shape[-1])
            e_c = img - (img * w).sum(-1, keepdim=True) / wpos
            self.enh_cw = e_c * w
            self.enh_ss = (e_c * e_c * w).sum(-1, keepdim=True)
        self.rows = max(t.shape[0] for t in (psd, w) + (
            (self.enh_cw,) if enh is not None else ()))

    @staticmethod
    def _r(t, r0, r1):
        return (t if t.shape[0] == 1 else t[r0:r1])[:, None]

    @staticmethod
    def _part(fn, P, rows):
        """fn of the parameter columns of the candidates P (r, C, NPARAMS),
        (r, C, nb); with `rows` (_Rows) only those candidates are
        evaluated and every other one takes row 0's value."""
        if rows is None:
            return fn(_cols(P, 1))
        if rows.single:
            out = fn(_cols(P[:, :1], 1))
            return out.expand(P.shape[0], P.shape[1], out.shape[-1])
        return fn(_cols(P.index_select(1, rows.sel), 1)).index_select(
            1, rows.idx)

    def _chunk(self, P, r0, r1, signal_rows=None, noise_rows=None):
        """Costs (r, c) of candidates P (r, c, NPARAMS) against rows
        r0:r1."""
        r = lambda t: self._r(t, r0, r1)
        noise = self._part(lambda c: _noise(c, self.grid), P, noise_rows)
        signal = _finite(self._part(
            lambda c: _signal(c, self.grid, self.side), P, signal_rows))
        model = torch.clamp(_finite(noise + signal), 0.0, 1e30)
        lm = torch.log1p(model)
        w, wsum = r(self.w), r(self.wsum)
        wpos = torch.clamp(wsum, min=1.0)
        lm_c = lm - (lm * w).sum(-1, keepdim=True) / wpos
        num = (lm_c * r(self.lo_cw)).sum(-1)
        den = torch.sqrt((lm_c * lm_c * w).sum(-1) * r(self.lo_ss)[..., 0])
        corr = num / torch.clamp(den, min=1e-12)
        # penalty: pure background must not exceed the observed PSD
        noise_c = torch.clamp(_finite(noise), 0.0, 1e30)
        over = torch.clamp(torch.log1p(noise_c) - r(self.lo), min=0.0)
        pen = (over * w).sum(-1) / wsum[..., 0]
        val = -corr + 2.0 * pen
        if self.enh_w:
            s_c = signal - (signal * w).sum(-1, keepdim=True) / wpos
            num = (r(self.enh_cw) * s_c).sum(-1)
            den = torch.sqrt(r(self.enh_ss)[..., 0]
                             * (s_c * s_c * w).sum(-1))
            val = val - self.enh_w * (num / torch.clamp(den, min=1e-12))
        return torch.where(torch.isfinite(val), val, 1e3)

    def costs(self, P, signal_rows=None, noise_rows=None):
        """Fitness of candidates P (R, C, NPARAMS) against the R rows (a
        shared row serves every R): (R, C), in chunks of at most CHUNK
        candidate-pixels. signal_rows / noise_rows (_Rows): the candidates
        that evaluate each half of the model (a split of the candidate axis
        keeps only a single row 0)."""
        R, C = P.shape[:2]
        nb = self.lo.shape[-1]
        rows = max(1, CHUNK // max(C * nb, 1))
        cols = C if rows > 1 else max(1, min(C, CHUNK // max(nb, 1)))
        if cols < C and not all(x is None or x.single
                                for x in (signal_rows, noise_rows)):
            signal_rows = noise_rows = None
        out = []
        for r0 in range(0, R, rows):
            r1 = min(R, r0 + rows)
            out.append(torch.cat([
                self._chunk(P[r0:r1, c0:c0 + cols], r0, r1, signal_rows,
                            noise_rows) for c0 in range(0, C, cols)], dim=1))
        return out[0] if len(out) == 1 else torch.cat(out)


class _Rows:
    """The candidates (a list starting at 0) that evaluate one half of the
    model; every other candidate takes row 0's value of that half, which
    the caller vouches for (its parameters of that half equal row 0's).
    The index tensors are made once, on the device, so that scoring
    candidates copies nothing from the host."""

    def __init__(self, rows: list, C: int, device):
        self.single = list(rows) == [0]
        if not self.single:
            idx = np.zeros(C, np.int64)
            idx[rows] = np.arange(len(rows))
            self.sel = torch.as_tensor(np.asarray(rows, np.int64),
                                       device=device)
            self.idx = torch.as_tensor(idx, device=device)


def _shared_rows(P: np.ndarray, device):
    """signal_rows / noise_rows for candidates P (..., C, NPARAMS) made on
    the host: a single row 0 for a half whose parameters every candidate
    shares with its row 0, else None."""
    same = P == P[..., :1, :]
    keep = lambda ix: _Rows([0], P.shape[-2], device) \
        if same[..., sorted(ix)].all() else None
    return keep(SIGNAL_PARAMS), keep(NOISE_PARAMS)


def _fitness(p, psd, fy, fx, band, n: int, consts, enh=None):
    """Negative masked log-domain correlation + background penalties
    (reference CTF_fitness :601-984; backgrounds above the PSD are
    penalised as the reference's heavy_penalization). enh =
    (enhanced_psd, weight) adds -weight * corr(enhancedPSD, signal) over
    the band (ctf_estimate_from_psd.cpp:848-874, actions 3-4). A 0-d
    tensor."""
    p = as_tensor(p)
    return _FitData(psd, fy, fx, band, consts, enh).costs(
        p.reshape(1, 1, NPARAMS))[0, 0]


def _fitness_batch(P, psd, fy, fx, band, n: int, consts, enh=None):
    """_fitness of each row of P (C, NPARAMS): (C,)."""
    P = as_tensor(P)
    return _FitData(psd, fy, fx, band, consts, enh).costs(P[None])[0]


def _fitness_lockstep(P, psds, fy, fx, bands, n: int, consts):
    """(B, C, NPARAMS) candidates against (B, nb) psds/bands -> (B, C)
    costs, in chunks of at most CHUNK candidate-pixels (a model half that
    the host-made candidates of every row share is evaluated once)."""
    data = _FitData(psds, fy, fx, bands, consts)
    if isinstance(P, np.ndarray):
        return data.costs(torch.as_tensor(P, device=data.lo.device),
                          *_shared_rows(P, data.lo.device))
    return data.costs(P)


# ---------------------------------------------------------------------------
# compass (pattern) search
# ---------------------------------------------------------------------------

def _directions(free, device) -> torch.Tensor:
    """(2F+1, NPARAMS): row 0 stays, rows 1+2j / 2+2j move free[j] by +/-
    one step."""
    E = np.zeros((2 * len(free) + 1, NPARAMS), np.float32)
    for j, idx in enumerate(free):
        E[1 + 2 * j, idx] = 1.0
        E[2 + 2 * j, idx] = -1.0
    return torch.as_tensor(E, device=device)


def _mirror(q, mirror):
    """Tie parameters: q[..., dst] = q[..., src] for each pair, in order."""
    if not mirror:
        return q
    q = q.clone()
    for dst, src in mirror:
        q[..., dst] = q[..., src]
    return q


def _plan(free, device) -> dict:
    """Which candidates of a compass round move each half of the model:
    row 0 stays, rows 1+2j / 2+2j move free[j]."""
    C = 2 * len(free) + 1
    rows = lambda half: _Rows(
        [0] + [c for j, i in enumerate(free) if i in half
               for c in (1 + 2 * j, 2 + 2 * j)], C, device)
    return dict(signal_rows=rows(SIGNAL_PARAMS), noise_rows=rows(NOISE_PARAMS))


def _compass_rounds(p, steps, best, E, cost, plan: dict, mirror,
                    n_rounds: int):
    """n_rounds of [score every +/-step coordinate candidate of every
    estimate -> move to the best, or halve the steps] for R estimates at
    once: p (R, NPARAMS), steps (R, F), best (R,), E the (2F+1, NPARAMS)
    directions, all on one device. Every round is queued on the device
    without waiting for the host: the move, the step halving and the best
    cost are torch.where updates."""
    R, F = steps.shape
    zero = torch.zeros(R, 1, dtype=torch.float32, device=p.device)
    for _ in range(n_rounds):
        srow = torch.cat([zero, steps[:, :, None].expand(R, F, 2)
                          .reshape(R, 2 * F)], dim=1)
        cands = _mirror(p[:, None, :] + E * srow[:, :, None], mirror)
        costs = cost(cands, **plan)
        k = torch.argmin(costs, dim=1, keepdim=True)
        ck = costs.gather(1, k)[:, 0]
        improved = (k[:, 0] != 0) & (ck < best - 1e-7)
        pk = cands.gather(1, k[:, :, None].expand(R, 1, NPARAMS))[:, 0]
        p = torch.where(improved[:, None], pk, p)
        steps = torch.where(improved[:, None], steps, steps * 0.5)
        best = torch.where(improved, ck, best)
    return p, best


def _compass_loop(P0, steps0, cost, free, n_rounds: int, mirror=()):
    """The compass search of R estimates: P0 (R, NPARAMS), steps0 (R, F)
    or (F,); cost(cands (R, C, NPARAMS), signal_rows, noise_rows) -> (R, C),
    told which candidates move each half of the model (_FitData._part).
    Returns (P (R, NPARAMS), best (R,)) tensors; nothing waits for the
    card unless phase timing is on."""
    P0 = as_tensor(P0)
    dev = P0.device
    R = P0.shape[0]
    F = len(free)
    steps = as_tensor(steps0, dev).expand(R, F).clone()
    E = _directions(free, dev)
    plan = _plan(free, dev)
    compass_stats["calls"] += 1
    compass_stats["rounds"] += int(n_rounds)
    with timed_phase("compass rounds"):
        p = _mirror(P0, mirror)
        best = cost(p[:, None])[:, 0]
        p, best = _compass_rounds(p, steps, best, E, cost, plan, mirror,
                                  n_rounds)
        if timing_enabled() and best.is_cuda:
            torch.cuda.synchronize(best.device)
    return p, best


def _compass_core(p0, steps0, psd, fy, fx, band, n: int, consts,
                  free: tuple, n_rounds: int, enh=None, mirror: tuple = ()):
    """The compass search of R estimates: p0 (R, NPARAMS) or (NPARAMS,),
    steps0 (R, F) or (F,), psd / band / the enhanced image (R, nb) or (nb,)
    (a single row is shared). mirror = ((dst, src), ...) ties parameters
    after every move (--radial_noise / symmetric-Gaussian constraints).
    Returns (p, best) shaped as p0's leading axes."""
    p0 = as_tensor(p0)
    single = p0.ndim == 1
    data = _FitData(psd, fy, fx, band, consts, enh)
    P0 = p0.reshape(-1, NPARAMS).to(data.lo.device)
    R = max(P0.shape[0], data.rows)
    p, best = _compass_loop(P0.expand(R, NPARAMS), steps0, data.costs,
                            tuple(free), n_rounds, mirror)
    return (p[0], best[0]) if single else (p, best)


def _compass_opt(p0, steps0, psd, fy, fx, band, n: int, consts, free: tuple,
                 n_rounds: int, enh=None, mirror: tuple = ()):
    """One compass search: p0 (NPARAMS,) -> (p, best)."""
    return _compass_core(p0, steps0, psd, fy, fx, band, n, consts, free,
                         n_rounds, enh, mirror)


def _compass_opt_batch(P0, steps0, psds, fy, fx, band, n: int, consts,
                       free: tuple, n_rounds: int):
    """R independent (seed, PSD) searches at once: the per-region local
    defocus refinements of regions mode (reference
    ctf_estimate_from_micrograph OnePerRegion)."""
    return _compass_core(P0, steps0, psds, fy, fx, band, n, consts, free,
                         n_rounds)


def _compass_opt_seeds(P0, steps0, psd, fy, fx, band, n: int, consts,
                       free: tuple, n_rounds: int, enh=None):
    """Searches from every seed of P0 against ONE psd (the fastDefocus
    ladder candidates)."""
    return _compass_core(P0, steps0, psd, fy, fx, band, n, consts, free,
                         n_rounds, enh)


def _compass_opt_bands(P0, steps0, psd, fy, fx, bands, n: int, consts,
                       free: tuple, n_rounds: int):
    """Searches over per-sample frequency masks bands (R, nb) — the
    --bootstrapFit resamples (reference random Fourier-pixel bootstrap,
    ctf_estimate_from_psd_base.cpp:146-149)."""
    return _compass_core(P0, steps0, psd, fy, fx, bands, n, consts, free,
                         n_rounds)


def _compass_opt_lockstep(P0, steps, psds, fy, fx, bands, n: int, consts,
                          free: tuple, n_rounds: int, enhs, enh_w,
                          mirror: tuple, use_enh: bool):
    """B independent staged fits advance one stage together: per-estimate
    params, steps (B, F), psds, bands and enhanced PSDs."""
    enh = (enhs, enh_w) if use_enh else None
    return _compass_core(P0, steps, psds, fy, fx, bands, n, consts, free,
                         n_rounds, enh, mirror)


def _freq_grids(n: int, Ts: float):
    fy = np.fft.fftfreq(n).astype(np.float32)[:, None] / Ts
    fx = np.fft.rfftfreq(n).astype(np.float32)[None, :] / Ts
    return fy, fx


def _band_pixels(n: int, Ts: float, min_freq: float, max_freq: float):
    """Flat indices of the rfft-layout pixels of an n-PSD inside the
    [min_freq, max_freq] digital annulus, and the flat fy, fx (1/Å) and
    digital radius of every pixel."""
    fy, fx = _freq_grids(n, Ts)
    r_dig = np.sqrt((fy * Ts) ** 2 + (fx * Ts) ** 2)
    idx = np.flatnonzero(((r_dig >= min_freq) & (r_dig <= max_freq)).ravel())
    flat = lambda a: np.broadcast_to(a, r_dig.shape).ravel()
    return idx, flat(fy), flat(fx), r_dig.ravel()


def refine_defocus_batch(psds, seed_params, sampling, voltage=300.0,
                         Cs=2.7, Q0=0.07, Ca=2.0, min_freq=0.03,
                         max_freq=0.35, vpp_radius=0.0, maxiter=3,
                         device=None):
    """Seeded per-PSD defocus refinement for a stack of piece PSDs (R, n,
    n//2+1), every search in one batched compass on `device` (a tensor's
    own device when given one). Returns (R, NPARAMS) refined parameters
    (numpy). The fit reads the band pixels only, as CTFEstimator does."""
    if isinstance(psds, torch.Tensor):
        dev = psds.device if device is None else resolve_device(device)
    else:
        dev = resolve_device(device)
        psds = np.asarray(psds, np.float32)
    R, n = psds.shape[0], psds.shape[1]
    idx, fy, fx, _ = _band_pixels(n, float(sampling), min_freq, max_freq)
    flat = as_tensor(psds, dev).reshape(R, -1)[
        :, torch.as_tensor(idx, device=dev)]
    consts = (float(voltage), float(Cs), float(Ca), float(Q0),
              float(vpp_radius))
    free = tuple(STAGE_SETS["defocus"])
    steps = CTFEstimator._STEPS[list(free)]
    P0 = np.broadcast_to(np.asarray(seed_params, np.float32), (R, NPARAMS))
    P, _ = _compass_opt_batch(
        torch.as_tensor(P0.copy(), device=dev), steps, flat, fy[idx], fx[idx],
        np.ones(len(idx), np.float32), n, consts, free,
        int(max(6 * maxiter, 8)))
    return P.cpu().numpy()


# ---------------------------------------------------------------------------
# staged 2-D estimator
# ---------------------------------------------------------------------------

class CTFEstimator:
    """Staged full-model CTF fit on a half (rfft-layout) PSD; the fitness
    and every compass search run on `device` (the card by default)."""

    def __init__(self, psd_half, sampling: float,
                 voltage: float = 300.0, Cs: float = 2.7, Q0: float = 0.07,
                 Ca: float = 2.0, min_freq: float = 0.03,
                 max_freq: float = 0.35, defocus_range=(2000.0, 40000.0),
                 vpp_radius: float = 0.0, fast: bool = False,
                 enhance_weight: float = 1.0, enhance_f1: float | None = None,
                 enhance_f2: float | None = None, radial_noise: bool = False,
                 model_simplification: int = 0,
                 initial_defocus=None, no_defocus: bool = False,
                 fast_defocus=None, refine_Q0: bool = False,
                 show_optimization: bool = False, device=None):
        self.device = resolve_device(device)
        if isinstance(psd_half, torch.Tensor):
            psd_half = psd_half.cpu().numpy()
        self.psd = np.asarray(psd_half, np.float32)
        self.n = self.psd.shape[0]
        self.Ts = float(sampling)
        self.consts = (float(voltage), float(Cs), float(Ca), float(Q0),
                       float(vpp_radius))
        # the flat band-only layout: the staged fit reads only the pixels
        # inside the [min_freq, max_freq] annulus (the adaptive
        # high-defocus band only shrinks inside it, as a weight update),
        # padded to a multiple of 1024 with zero-weight copies of pixel 0
        idx, fy, fx, r_dig = _band_pixels(self.n, self.Ts, min_freq,
                                          max_freq)
        pad = (-len(idx)) % 1024
        flat_idx = np.concatenate([idx, np.zeros(pad, np.int64)])
        self._flat_idx = flat_idx
        self._flat_pad = pad
        dev = self.device
        self.fy = torch.as_tensor(fy[flat_idx], device=dev)
        self.fx = torch.as_tensor(fx[flat_idx], device=dev)
        self.psd_flat = torch.as_tensor(self.psd.ravel()[flat_idx],
                                        device=dev)
        band = np.ones(len(flat_idx), np.float32)
        if pad:
            band[-pad:] = 0.0
        self.band = torch.as_tensor(band, device=dev)
        self._r_dig_flat = r_dig[flat_idx]
        self.min_freq_dig = min_freq
        self.max_freq_dig = max_freq
        self.defocus_range = defocus_range
        self.fast = fast
        self.radial_noise = bool(radial_noise)
        self.model_simplification = int(model_simplification)
        self.initial_defocus = initial_defocus
        self.no_defocus = bool(no_defocus)
        self.fast_defocus = fast_defocus
        self.refine_Q0 = bool(refine_Q0)
        self.show = bool(show_optimization)
        # enhanced PSD (reference enhance defaults,
        # ctf_estimate_from_psd_base.cpp:155-167: f1/f2 switch on fmax)
        if enhance_f1 is None:
            enhance_f1 = 0.01 if max_freq > 0.35 else 0.02
        if enhance_f2 is None:
            enhance_f2 = 0.08 if max_freq > 0.35 else 0.15
        self.enhance_f1, self.enhance_f2 = float(enhance_f1), \
            float(enhance_f2)
        self.enhance_weight = float(enhance_weight)
        self._enh = None
        if self.enhance_weight != 0.0:
            enh = self._enhanced_half(self.psd, enhance_f1, enhance_f2, dev)
            self._enh = (torch.as_tensor(enh.ravel()[self._flat_idx],
                                         device=dev), self.enhance_weight)
        self.params = np.zeros(NPARAMS, np.float32)

    @staticmethod
    def _enhanced_half(psd_half, f1, f2, device=None):
        """Enhanced PSD in the half (rfft) layout: log1p, then bandpass the
        PSD treated AS AN IMAGE at [f1, f2] (on `device`), then unit
        normalization — the ProgCTFEnhancePSD pipeline the reference fit
        is guided by (f1/f2 defaults ctf_estimate_from_psd_base.cpp:
        155-167)."""
        from xmipp3_tpu_torch.ops.fourier_filter import (
            apply_fourier_mask_2d, band_pass_mask)
        from xmipp3_tpu_torch.ops.psd import psd_half_to_full_centered
        n = psd_half.shape[0]
        full = psd_half_to_full_centered(
            np.log1p(np.maximum(psd_half, 0.0)).astype(np.float32), n)
        filt = apply_fourier_mask_2d(full, band_pass_mask(n, n, f1, f2),
                                     device=device).cpu().numpy()
        filt = (filt - filt.mean()) / max(filt.std(), 1e-12)
        half = np.fft.ifftshift(filt)[:, : n // 2 + 1]
        return np.ascontiguousarray(half).astype(np.float32)

    # -- constraint plumbing (--radial_noise / --model_simplification) ----
    def _mirrors(self) -> tuple:
        """Parameter ties applied inside every compass move."""
        m = []
        if self.radial_noise:
            m += [(SQV, SQU), (G1SV, G1SU), (G1CV, G1CU),
                  (G2SV, G2SU), (G2CV, G2CU)]
        elif self.model_simplification >= 3:
            # symmetric intermediate Gaussian (level 3)
            m += [(G1SV, G1SU), (G1CV, G1CU)]
        return tuple(m)

    def _frozen(self) -> set:
        f = set()
        if self.model_simplification >= 1:    # simplified envelope
            f |= {DELTAF, DELTAR, ENVR1, ENVR2}
        if self.model_simplification >= 2:    # last Gaussian removed
            f |= {G2K, G2SU, G2SV, G2ANG, G2CU, G2CV}
        if self.radial_noise:
            f |= {SQV, SQANG, G1SV, G1CV, G1ANG, G2SV, G2CV, G2ANG}
        elif self.model_simplification >= 3:
            f |= {G1SV, G1CV, G1ANG}
        if self.no_defocus:
            f |= {DEFU, DEFV, ANGLE}
        return f

    def _free(self, stage: str) -> list:
        frozen = self._frozen()
        return [i for i in STAGE_SETS[stage] if i not in frozen]

    # -- fitness plumbing -------------------------------------------------
    def _data(self, use_enh: bool = False) -> _FitData:
        return _FitData(self.psd_flat, self.fy, self.fx, self.band,
                        self.consts, self._enh if use_enh else None)

    def _cost(self, p, use_enh: bool = False) -> float:
        P = torch.as_tensor(np.asarray(p, np.float32), device=self.device)
        return float(self._data(use_enh).costs(P.reshape(1, 1, NPARAMS))[0])

    def _cost_batch(self, P, use_enh: bool = False) -> np.ndarray:
        P = np.asarray(P, np.float32)
        sig, noi = _shared_rows(P, self.device)
        return self._data(use_enh).costs(
            torch.as_tensor(P, device=self.device)[None], sig,
            noi)[0].cpu().numpy()

    # per-parameter pattern-search step scales (same role as the
    # reference's Powell step vector)
    _STEPS = np.array([150.0, 150.0, 4.0, 0.25,        # defU defV ang logK
                       0.3, 2e-4, 20.0, 0.5, 0.05, 0.05,  # envelope
                       0.05, 0.2, 2.0, 2.0, 10.0,     # base sqrtK sqU/V ang
                       0.2, 500.0, 500.0, 10.0, 0.01, 0.01,   # gauss1
                       0.2, 500.0, 500.0, 10.0, 0.01, 0.01,   # gauss2
                       0.1], np.float32)               # phase shift

    def _powell(self, free, maxiter=4, use_enh=False, label=""):
        """Compass/pattern search over the `free` subset — the reference's
        powellOptimizer role: every round scores ALL +/-step coordinate
        candidates in one batched fitness pass on the device."""
        frozen = self._frozen()
        free = [i for i in free if i not in frozen]
        if not free:
            return getattr(self, "final_fitness", 0.0)
        steps = self._STEPS[free].copy()
        # scale data-dependent magnitudes
        psd_scale = float(np.abs(self.psd).mean()) + 1e-12
        for j, idx in enumerate(free):
            if idx in (BASE, SQK, G1K, G2K):
                steps[j] = max(steps[j] * psd_scale, 1e-6)
        n_rounds = max(6 * maxiter, 8)
        p_out, best = _compass_opt(
            torch.as_tensor(self.params, device=self.device), steps,
            self.psd_flat, self.fy, self.fx, self.band, self.n, self.consts,
            free=tuple(free), n_rounds=int(n_rounds),
            enh=self._enh if use_enh else None, mirror=self._mirrors())
        self.params = p_out.cpu().numpy()
        self.final_fitness = float(best)
        if self.show:
            print(f"  [opt] stage={label or free} fitness="
                  f"{self.final_fitness:.5f} defU={self.params[DEFU]:.1f} "
                  f"defV={self.params[DEFV]:.1f} ang="
                  f"{self.params[ANGLE]:.1f}")
        return self.final_fitness

    def _profile(self, profile):
        if profile is None:
            from xmipp3_tpu_torch.ops.psd import radial_profile
            profile = radial_profile(self.psd, device=self.device)
        freqs_dig, prof = profile
        return np.asarray(freqs_dig), np.asarray(prof)

    # -- stage 1: sqrt + baseline background ------------------------------
    def fit_background(self, profile=None):
        freqs_dig, prof = self._profile(profile)
        freqs = freqs_dig / self.Ts
        sel = (freqs_dig > 0.02) & (freqs_dig < 0.45)
        x, y = freqs[sel], prof[sel]

        def resid(q):
            base, sqrtK, sq = q
            bg = base + np.abs(sqrtK) * np.exp(-np.abs(sq) * np.sqrt(x))
            return np.log1p(np.maximum(bg, 0)) - np.log1p(y)

        p0 = np.array([np.percentile(y, 5),
                       max(y.max() - y.min(), 1e-3), 5.0])
        res = scipy.optimize.least_squares(resid, p0, method="lm",
                                           max_nfev=200)
        base, sqrtK, sq = res.x
        self.params[BASE] = max(base, 0.0)
        self.params[SQK] = abs(sqrtK)
        self.params[SQU] = self.params[SQV] = abs(sq)
        self.params[SQANG] = 0.0
        return base, abs(sqrtK), abs(sq)

    # -- stage 2: first Gaussian background --------------------------------
    def fit_gaussian1(self, optimize: bool = True, profile=None):
        freqs_dig, prof = self._profile(profile)
        freqs = freqs_dig / self.Ts
        bg = (self.params[BASE] + self.params[SQK]
              * np.exp(-self.params[SQU] * np.sqrt(np.maximum(freqs, 0))))
        res = prof - bg
        sel = (freqs_dig > 0.01) & (freqs_dig < 0.2) & (res > 0)
        if sel.sum() < 4:
            return
        i = np.argmax(res * sel)
        c = freqs[i]
        K = max(res[i], 1e-6)
        # half-width at half-max -> sigma
        half = res[i] / 2
        width = 0.02 / self.Ts
        for j in range(i, len(res)):
            if not sel[j] or res[j] < half:
                width = max(freqs[j] - c, 1e-4)
                break
        sigma = np.log(2.0) / width ** 2
        self.params[G1K] = K
        self.params[G1SU] = self.params[G1SV] = sigma
        self.params[G1CU] = self.params[G1CV] = c
        if optimize:
            self._powell(STAGE_SETS["bg_sqrt"] + STAGE_SETS["bg_gauss"],
                         maxiter=2)

    # -- stage 3: astigmatic defocus grid search ---------------------------
    @staticmethod
    def _astig_candidates(center, span, n_ast, angs):
        """(defU, defV, angle) grid around center, defU >= defV, one angle
        where they are equal (reference estimate_defoci grid,
        ctf_estimate_from_psd.cpp:1778)."""
        dU = center[DEFU] + np.linspace(-span, span, n_ast, dtype=np.float32)
        dV = center[DEFV] + np.linspace(-span, span, n_ast, dtype=np.float32)
        cands = []
        for u in dU:
            for v in dV:
                if v > u:      # canonical: defU >= defV
                    continue
                for a in angs if u != v else angs[:1]:
                    p = center.copy()
                    p[DEFU], p[DEFV], p[ANGLE] = u, v, a
                    cands.append(p)
        return np.stack(cands)

    def _coarse_candidates(self, n_coarse):
        """The coarse isotropic pass: n_coarse defoci under two gain
        hypotheses."""
        lo, hi = self.defocus_range
        logK0 = np.log(max(self.psd.max() * 1e-2, 1e-8))
        defs = np.linspace(lo, hi, n_coarse, dtype=np.float32)
        ang0 = 0.0 if self.initial_defocus is None \
            else float(self.initial_defocus[2])
        cands = []
        for logK in (logK0, logK0 + np.log(10.0)):
            for d in defs:
                p = self.params.copy()
                p[DEFU] = p[DEFV] = d
                p[ANGLE] = ang0
                p[LOGK] = logK
                cands.append(p)
        return np.stack(cands)

    def _adapt_band(self, best):
        """Beyond f_lim the Thon-ring spacing 1/(2 lambda def f) falls under
        ~2.5 PSD grid samples and the aliased rings only add noise: shrink
        the band there (the failure mode at high defocus on small PSDs)."""
        voltage = self.consts[0]
        lam = 12.2643247 / np.sqrt(voltage * 1e3
                                   * (1 + 0.978466e-6 * voltage * 1e3))
        df_grid = 1.0 / (self.n * self.Ts)
        f_lim = 1.0 / (2.0 * lam * max(best[DEFU], 1.0) * 2.5 * df_grid)
        if f_lim * self.Ts < self.max_freq_dig:
            r = self._r_dig_flat
            band = ((r >= self.min_freq_dig)
                    & (r <= max(f_lim * self.Ts, 2 * self.min_freq_dig))
                    ).astype(np.float32)
            if self._flat_pad:
                band[-self._flat_pad:] = 0.0
            self.band = torch.as_tensor(band, device=self.device)

    def grid_search_defocus(self, n_coarse: int = 60, n_astig: int = 13,
                            n_angles: int = 6):
        P = self._coarse_candidates(n_coarse)
        costs = self._cost_batch(P)
        best = P[int(np.argmin(costs))].copy()
        if self.fast:
            astig_span = 0.15 * best[DEFU]
            n_astig = 7
            n_angles = 4
        else:
            astig_span = max(0.25 * best[DEFU], 2500.0)

        # two levels — high defocus packs Thon rings near the grid
        # resolution and a single coarse level aliases into local optima
        def astig_level(center, span, n_ast, angs):
            P = self._astig_candidates(center, span, n_ast, angs)
            costs = self._cost_batch(P)
            k = int(np.argmin(costs))
            return P[k].astype(np.float32), float(costs[k])

        self._adapt_band(best)
        angs = np.linspace(0.0, 180.0, n_angles, endpoint=False,
                           dtype=np.float32)
        best, cost = astig_level(best, astig_span, n_astig, angs)
        fine_angs = (best[ANGLE] + np.linspace(-20.0, 20.0, 9)) \
            .astype(np.float32)
        best, cost = astig_level(best, astig_span / 5.0, n_astig, fine_angs)
        self.params = best
        return cost

    # -- fast defocus via ring demodulation (--fastDefocus) -----------------
    def fast_defocus_zernike(self) -> bool:
        """Fast initial defocus from the enhanced PSD's ring pattern
        (reference estimate_defoci_Zernike, ctf_estimate_from_psd.cpp:1936;
        the reference package's sector redesign): in x = u^2 coordinates
        the rings are a sinusoid of frequency lambda*defocus, so each
        angular sector's defocus comes from an FFT peak of its radial
        profiles on a uniform u^2 grid (host numpy and scipy); a linear LS
        over sectors d(theta) = d_avg + d_diff*cos(2(theta-az)) gives the
        astigmatism, over a shrinking fmax ladder. The ladder candidates
        are compass-refined together on the device; the best fitness wins,
        and a winner outside [3000, 50000] A falls back to the grid."""
        from scipy.ndimage import map_coordinates

        from xmipp3_tpu_torch.ops.psd import psd_half_to_full_centered
        n = self.n
        # wide-band enhancement: the display band (f2~0.15) cuts image
        # frequencies right where dense Thon rings live
        enh_half = self._enhanced_half(self.psd, 0.01, 0.5, self.device)
        enh_full = psd_half_to_full_centered(
            np.asarray(enh_half, np.float32), n)
        voltage = self.consts[0]
        kv = voltage * 1e3
        lam = 12.2643247 / np.sqrt(kv * (1 + 0.978466e-6 * kv))
        cy = cx = n // 2
        K, n_rays = 12, 9
        thetas = (np.arange(K) + 0.5) * np.pi / K
        r0 = max(int(self.min_freq_dig * n), 2)
        M, P = 512, 8
        win = np.hanning(M)

        def sector_defoci(r1):
            rr = np.arange(r0, r1, 0.5)
            u = rr / (n * self.Ts)
            x = np.linspace(u[0] ** 2, u[-1] ** 2, M)
            df = 1.0 / (P * M * (x[1] - x[0]))
            freqs = np.arange(P * M // 2 + 1) * df
            # exclude the window-scale trend (<3 cycles over the window
            # masquerades as a tiny-defocus ghost) and absurd defoci
            f_lo = max(3.0 / (x[-1] - x[0]), 1.5e3 * lam)
            sel = (freqs > f_lo) & (freqs < 1.2e5 * lam)
            ds = np.empty(K)
            for k in range(K):
                Facc = np.zeros(P * M // 2 + 1)
                for j in range(n_rays):
                    t = thetas[k] + (j - (n_rays - 1) / 2) \
                        * (np.pi / K) / n_rays
                    for sgn in (1.0, -1.0):
                        ys = cy + sgn * rr * np.sin(t)
                        xs = cx + sgn * rr * np.cos(t)
                        prof = map_coordinates(enh_full, [ys, xs], order=1)
                        px = np.interp(x, u ** 2, prof)
                        px -= px.mean()
                        Facc += np.abs(np.fft.rfft(px * win, n=P * M))
                pk = int(np.argmax(Facc * sel))
                if 0 < pk < len(Facc) - 1:
                    al, be, ga = Facc[pk - 1], Facc[pk], Facc[pk + 1]
                    delta = 0.5 * (al - ga) / (al - 2 * be + ga + 1e-30)
                else:
                    delta = 0.0
                ds[k] = (pk + delta) * df / lam
            return ds

        A = np.column_stack([np.ones(K), np.cos(2 * thetas),
                             np.sin(2 * thetas)])
        seeds = []
        for fmax in np.linspace(0.95 * self.max_freq_dig,
                                2.5 * self.min_freq_dig, 8):
            r1 = int(fmax * n)
            if r1 - r0 < 10:
                break
            ds = sector_defoci(r1)
            med = np.median(ds)
            # robust: a minority of sectors may lock onto an aliased fold;
            # fit the astigmatic cosine on the median inliers only
            inl = np.abs(ds - med) < 0.3 * max(med, 1.0)
            if inl.sum() < max(K - 3, 3):
                continue
            coef, *_ = np.linalg.lstsq(A[inl], ds[inl], rcond=None)
            d_avg, bc, bs = coef
            d_diff = min(np.hypot(bc, bs), 0.9 * d_avg)
            ang = 0.5 * np.degrees(np.arctan2(bs, bc)) % 180.0
            if not (1e3 < d_avg < 100e3):
                continue
            p = self.params.copy()
            p[DEFU] = d_avg + d_diff
            p[DEFV] = d_avg - d_diff
            p[ANGLE] = ang
            p[LOGK] = np.log(max(self.psd.max() * 1e-2, 1e-8))
            if not any(abs(q[DEFU] - p[DEFU]) < 0.02 * p[DEFU]
                       for q in seeds):
                seeds.append(p)
        if not seeds:
            return False
        free = tuple(self._free("defocus"))
        steps = self._STEPS[list(free)].copy()
        steps[:2] = 400.0                # wider basin than the grid refine
        P_out, costs = _compass_opt_seeds(
            torch.as_tensor(np.stack(seeds), device=self.device), steps,
            self.psd_flat, self.fy, self.fx, self.band, self.n, self.consts,
            free=free, n_rounds=30, enh=self._enh)
        costs = costs.cpu().numpy()
        k = int(np.argmin(costs))
        best = P_out[k].cpu().numpy()
        d_win = 0.5 * (best[DEFU] + best[DEFV])
        # reference acceptance window (ctf_estimate_from_psd.cpp:2049):
        # outside it the ladder failed -> grid fallback
        if not (3e3 < d_win < 50e3):
            return False
        self.params = best
        self.final_fitness = float(costs[k])
        if self.show:
            print(f"  [fastDefocus] {len(seeds)} ladder candidates -> "
                  f"defU={best[DEFU]:.1f} defV={best[DEFV]:.1f} "
                  f"ang={best[ANGLE]:.1f} fitness={self.final_fitness:.5f}")
        return True

    # -- amplitude-contrast refinement (--refine_amplitude_contrast) -------
    def refine_amplitude_contrast(self):
        """Line-search Q0 at the fitted model, then re-refine defocus
        (reference: Q0 joins the optimized set when the flag is given)."""
        v, Cs, Ca, q0, vpp = self.consts
        grid = np.clip(np.linspace(max(0.01, q0 - 0.06), q0 + 0.15, 12),
                       0.005, 0.6)
        costs = []
        for q in grid:
            self.consts = (v, Cs, Ca, float(q), vpp)
            costs.append(self._cost(self.params, use_enh=True))
        q_best = float(grid[int(np.argmin(costs))])
        self.consts = (v, Cs, Ca, q_best, vpp)
        self._powell(STAGE_SETS["defocus"], maxiter=2, use_enh=True,
                     label="Q0-refine")
        if self.show:
            print(f"  [Q0] refined amplitude contrast {q0:.3f} -> "
                  f"{q_best:.3f}")
        return q_best

    # -- bootstrap variability (--bootstrapFit) -----------------------------
    def bootstrap_fit(self, n_boot: int, seed: int = 0):
        """Repeat the defocus fit over random halves of the band's Fourier
        pixels; returns the (n_boot, 3) defocusU/V/angle samples (reference
        bootstrap over randomly chosen Fourier pixels,
        ctf_estimate_from_psd_base.cpp bootstrapWeights)."""
        rng = np.random.default_rng(seed)
        base = self.band.cpu().numpy()
        masks = (rng.random((n_boot,) + base.shape) < 0.5) * base
        free = tuple(self._free("defocus"))
        P0 = torch.as_tensor(np.broadcast_to(self.params, (n_boot, NPARAMS))
                             .copy(), device=self.device)
        P, _ = _compass_opt_bands(
            P0, self._STEPS[list(free)], self.psd_flat, self.fy, self.fx,
            torch.as_tensor(masks.astype(np.float32), device=self.device),
            self.n, self.consts, free=free, n_rounds=14)
        P = P.cpu().numpy()
        return np.stack([P[:, DEFU], P[:, DEFV], P[:, ANGLE]], axis=1)

    # -- full pipeline ------------------------------------------------------
    def _keep_initial_defocus(self):
        """--noDefocus: the initial model's defocus is trusted, only the
        gain (and envelope/background) is fitted."""
        if self.initial_defocus is not None:
            self.params[DEFU] = self.initial_defocus[0]
            self.params[DEFV] = self.initial_defocus[1]
            self.params[ANGLE] = self.initial_defocus[2]
        self.params[LOGK] = np.log(max(self.psd.max() * 1e-2, 1e-8))

    def _g2_init(self):
        """Second Gaussian init: deepest residual valley at mid freq."""
        self.params[G2CU] = self.params[G2CV] = 0.9 * 0.5 / self.Ts
        self.params[G2SU] = self.params[G2SV] = 100.0 * self.Ts ** 2
        self.params[G2K] = 0.0

    def estimate(self) -> CTFDescription:
        self.fit_background()
        self.fit_gaussian1()
        if self.no_defocus:
            self._keep_initial_defocus()
            self._powell([LOGK], maxiter=2, label="gain")
        else:
            if not (self.fast_defocus and self.fast_defocus_zernike()):
                self.grid_search_defocus()
            self._powell(STAGE_SETS["defocus"], maxiter=3, use_enh=True,
                         label="defocus")
        if not self.fast:
            self._powell(STAGE_SETS["envelope"], maxiter=3, label="envelope")
            if self.model_simplification < 2:
                self._g2_init()
                self._powell(STAGE_SETS["bg_gauss2"], maxiter=2,
                             label="gauss2")
            self._powell(STAGE_SETS["all"], maxiter=4, label="all")
        elif not self.no_defocus:
            self._powell(STAGE_SETS["defocus"], maxiter=2, use_enh=True,
                         label="defocus2")
        if abs(self.consts[4]) > 1e-3:       # VPP mode
            self._powell(STAGE_SETS["all_vpp"], maxiter=2, label="vpp")
        if self.refine_Q0:
            self.refine_amplitude_contrast()
        return self.to_ctf()

    def to_ctf(self) -> CTFDescription:
        p = self.params.astype(np.float64)
        defU, defV, ang = float(p[DEFU]), float(p[DEFV]), float(p[ANGLE])
        if defU < defV:
            defU, defV = defV, defU
            ang += 90.0
        ang = ang % 180.0
        voltage, Cs, Ca, Q0, vpp_r = self.consts
        return CTFDescription(
            sampling_rate=self.Ts, voltage=voltage, Cs=Cs, Ca=Ca, Q0=Q0,
            defocusU=defU, defocusV=defV, azimuthal_angle=ang,
            K=float(np.exp(p[LOGK])), espr=float(abs(p[ESPR])),
            alpha=float(abs(p[ALPHA])), DeltaF=float(abs(p[DELTAF])),
            DeltaR=float(abs(p[DELTAR])), envR1=float(p[ENVR1]),
            envR2=float(p[ENVR2]),
            base_line=float(max(p[BASE], 0.0)), sqrt_K=float(abs(p[SQK])),
            sqU=float(abs(p[SQU])), sqV=float(abs(p[SQV])),
            sqrt_angle=float(p[SQANG] % 180.0),
            gaussian_K=float(abs(p[G1K])), sigmaU=float(abs(p[G1SU])),
            sigmaV=float(abs(p[G1SV])), gaussian_angle=float(p[G1ANG] % 180.0),
            cU=float(abs(p[G1CU])), cV=float(abs(p[G1CV])),
            gaussian_K2=float(abs(p[G2K])), sigmaU2=float(abs(p[G2SU])),
            sigmaV2=float(abs(p[G2SV])),
            gaussian_angle2=float(p[G2ANG] % 180.0),
            cU2=float(abs(p[G2CU])), cV2=float(abs(p[G2CV])),
            phase_shift=float(abs(p[PHASE_SHIFT])), VPP_radius=vpp_r)


def estimate_ctf_from_psd(psd_half, sampling, voltage=300.0, Cs=2.7,
                          Q0=0.07, **kw) -> CTFDescription:
    est = CTFEstimator(psd_half, sampling, voltage, Cs, Q0, **kw)
    return est.estimate()


# ---------------------------------------------------------------------------
# 1-D radial variant (reference ctf_estimate_from_psd_fast — a distinct
# program: ProgCTFEstimateFromPSDFast fits the radially averaged profile)
# ---------------------------------------------------------------------------

class _Fit1D:
    """The radial profile's fitness for candidates (R, C, NPARAMS)."""

    def __init__(self, prof, u, w, consts):
        prof = as_tensor(prof)
        self.grid = _Grid(torch.zeros_like(prof), as_tensor(u, prof.device))
        self.side = _side(consts)
        self.w = as_tensor(w, prof.device)
        self.wsum = self.w.sum()
        self.lo = torch.log1p(torch.clamp(prof, min=0.0))
        self.lo_c = self.lo - (self.lo * self.w).sum() / self.wsum

    def costs(self, P, signal_rows=None, noise_rows=None):
        noise, signal = _parts(P, self.grid, self.side)
        model = torch.clamp(_finite(noise + signal), 0.0, 1e30)
        lm = torch.log1p(torch.clamp(model, min=0.0))
        w = self.w
        lm_c = lm - (lm * w).sum(-1, keepdim=True) / self.wsum
        num = (lm_c * self.lo_c * w).sum(-1)
        den = torch.sqrt((lm_c * lm_c * w).sum(-1)
                         * (self.lo_c * self.lo_c * w).sum())
        return -(num / torch.clamp(den, min=1e-12))


def _fitness_1d(p, prof, u, w, consts):
    """Negative weighted log-domain correlation of the isotropic model with
    a radial profile: a 0-d tensor."""
    return _Fit1D(prof, u, w, consts).costs(
        as_tensor(p).reshape(1, 1, NPARAMS))[0, 0]


def _fitness_1d_batch(P, prof, u, w, consts):
    return _Fit1D(prof, u, w, consts).costs(as_tensor(P)[None])[0]


def _compass_opt_1d(p0, steps0, prof, u, w, consts, free: tuple,
                    mirror: tuple, n_rounds: int):
    """1-D profile analog of _compass_opt: isotropic fit with V-params
    mirrored from U after every move."""
    p0 = as_tensor(p0)
    p, best = _compass_loop(p0.reshape(1, NPARAMS), steps0,
                            _Fit1D(prof, u, w, consts).costs, free,
                            n_rounds, mirror)
    return p[0], best[0]


def estimate_ctf_1d(psd_half, sampling, voltage=300.0, Cs=2.7, Q0=0.07,
                    Ca=2.0, min_freq=0.03, max_freq=0.35,
                    defocus_range=(2000.0, 40000.0),
                    device=None) -> CTFDescription:
    """Reference ctf_estimate_from_psd_fast: isotropic fit on the radial
    average (fast 1-D variant; astigmatism is NOT estimated)."""
    from xmipp3_tpu_torch.ops.psd import radial_profile
    dev = resolve_device(device)
    if isinstance(psd_half, torch.Tensor):
        psd_half = psd_half.cpu().numpy()
    freqs_dig, prof = radial_profile(np.asarray(psd_half, np.float32),
                                     device=dev)
    prof = np.asarray(prof, np.float32)
    Ts = float(sampling)
    u = torch.as_tensor((freqs_dig / Ts).astype(np.float32), device=dev)
    w = torch.as_tensor(((freqs_dig >= min_freq) & (freqs_dig <= max_freq))
                        .astype(np.float32), device=dev)
    prof_d = torch.as_tensor(prof, device=dev)
    consts = (float(voltage), float(Cs), float(Ca), float(Q0), 0.0)

    p = np.zeros(NPARAMS, np.float32)
    # background init on the profile tail
    sel = freqs_dig > 0.35
    p[BASE] = float(prof[sel].mean()) if sel.any() else float(prof.min())
    p[SQK] = max(float(prof.max() - p[BASE]), 1e-3)
    p[SQU] = p[SQV] = 5.0

    lo, hi = defocus_range
    logK0 = np.log(max(prof.max() * 1e-2, 1e-8))
    cands = []
    for logK in (logK0, logK0 + np.log(10.0)):
        for d in np.linspace(lo, hi, 120, dtype=np.float32):
            q = p.copy()
            q[DEFU] = q[DEFV] = d
            q[LOGK] = logK
            cands.append(q)
    P = np.stack(cands)
    costs = _fitness_1d_batch(torch.as_tensor(P, device=dev), prof_d, u, w,
                              consts).cpu().numpy()
    p = P[int(np.argmin(costs))].copy()

    # compass refinement over the isotropic subset (V-params mirror U)
    free = (DEFU, LOGK, BASE, SQK, SQU, G1K, G1SU, G1CU)
    mirror = ((DEFV, DEFU), (SQV, SQU), (G1SV, G1SU), (G1CV, G1CU))
    steps = np.array([150.0, 0.25, max(0.05 * abs(p[BASE]), 1e-3),
                      max(0.2 * abs(p[SQK]), 1e-3), 0.5,
                      max(0.2 * abs(p[G1K]) + 1e-3, 1e-3), 500.0, 0.01],
                     np.float32)
    p_out, _ = _compass_opt_1d(torch.as_tensor(p, device=dev), steps,
                               prof_d, u, w, consts, free=free,
                               mirror=mirror, n_rounds=24)
    p = p_out.cpu().numpy()
    return CTFDescription(
        sampling_rate=Ts, voltage=voltage, Cs=Cs, Ca=Ca, Q0=Q0,
        defocusU=float(p[DEFU]), defocusV=float(p[DEFV]), azimuthal_angle=0.0,
        K=float(np.exp(p[LOGK])), base_line=float(max(p[BASE], 0.0)),
        sqrt_K=float(abs(p[SQK])), sqU=float(abs(p[SQU])),
        sqV=float(abs(p[SQV])), gaussian_K=float(abs(p[G1K])),
        sigmaU=float(abs(p[G1SU])), sigmaV=float(abs(p[G1SV])),
        cU=float(abs(p[G1CU])), cV=float(abs(p[G1CV])))


# ---------------------------------------------------------------------------
# local defocus plane fit (reference ctf_estimate_from_micrograph.cpp:470-560
# OnePerRegion: fit defocus(x, y) = a + b x + c y over region centers)
# ---------------------------------------------------------------------------

def fit_defocus_plane(xs, ys, values):
    """Least-squares plane v = a + b*x + c*y; returns (a, b, c)."""
    A = np.stack([np.ones_like(xs), xs, ys], axis=1).astype(np.float64)
    coef, *_ = np.linalg.lstsq(A, np.asarray(values, np.float64), rcond=None)
    return coef


# ---------------------------------------------------------------------------
# lockstep batched estimator (B micrographs at once)
# ---------------------------------------------------------------------------

class _CTFBatch:
    """Run B CTFEstimator instances in lockstep: every device stage is one
    batched pass over the whole batch (host stages are cheap numpy). Same
    acquisition settings across the batch (shared n/fy/fx/consts)."""

    def __init__(self, ests: list):
        self.ests = ests
        e0 = ests[0]
        self.device = e0.device
        self.n = e0.n
        self.fy, self.fx = e0.fy, e0.fx
        self.consts = e0.consts
        self.psds = torch.stack([e.psd_flat for e in ests])
        self.mirror = e0._mirrors()
        self.frozen = e0._frozen()
        if any(e._enh is not None for e in ests):
            self.enhs = torch.stack([e._enh[0] for e in ests])
            self.enh_w = float(e0._enh[1])
        else:
            self.enhs = torch.zeros_like(self.psds)
            self.enh_w = 0.0

    def _bands(self):
        return torch.stack([e.band for e in self.ests])

    def powell(self, free, maxiter=4, use_enh=False, label=""):
        free = tuple(i for i in free if i not in self.frozen)
        if not free:
            return
        steps_all = []
        for e in self.ests:
            st = CTFEstimator._STEPS[list(free)].copy()
            psd_scale = float(np.abs(e.psd).mean()) + 1e-12
            for j, idx in enumerate(free):
                if idx in (BASE, SQK, G1K, G2K):
                    st[j] = max(st[j] * psd_scale, 1e-6)
            steps_all.append(st)
        P0 = torch.as_tensor(np.stack([e.params for e in self.ests]),
                             device=self.device)
        P, best = _compass_opt_lockstep(
            P0, torch.as_tensor(np.stack(steps_all), device=self.device),
            self.psds, self.fy, self.fx, self._bands(), self.n, self.consts,
            free, int(max(6 * maxiter, 8)), self.enhs, self.enh_w,
            self.mirror, bool(use_enh and self.enh_w != 0.0))
        P = P.cpu().numpy()
        best = best.cpu().numpy()
        for i, e in enumerate(self.ests):
            e.params = P[i].copy()
            e.final_fitness = float(best[i])

    def _eval_candidates(self, stacks):
        """stacks: list of (C_i, NPARAMS); pad to max C, return per-est
        (params of argmin, cost)."""
        C = max(s.shape[0] for s in stacks)
        padded = np.stack([
            np.concatenate([s, np.repeat(s[:1], C - s.shape[0], axis=0)])
            if s.shape[0] < C else s for s in stacks]).astype(np.float32)
        costs = _fitness_lockstep(
            padded, self.psds, self.fy,
            self.fx, self._bands(), self.n, self.consts).cpu().numpy()
        out = []
        for i in range(len(stacks)):
            k = int(np.argmin(costs[i]))
            out.append((padded[i, k].copy(), float(costs[i, k])))
        return out

    def grid_search_defocus(self, n_coarse=60, n_astig=13, n_angles=6):
        """Batched CTFEstimator.grid_search_defocus: the coarse isotropic
        pass, the adaptive high-defocus band update and both astigmatic
        levels each run once for the WHOLE batch."""
        ests = self.ests
        bests = self._eval_candidates([e._coarse_candidates(n_coarse)
                                       for e in ests])
        spans = []
        for e, (best, _) in zip(ests, bests):
            if e.fast:
                spans.append(0.15 * best[DEFU])
            else:
                spans.append(max(0.25 * best[DEFU], 2500.0))
            e._adapt_band(best)
        if ests[0].fast:
            n_astig, n_angles = 7, 4
        angs = np.linspace(0.0, 180.0, n_angles, endpoint=False,
                           dtype=np.float32)
        stacks = [CTFEstimator._astig_candidates(b[0], s, n_astig, angs)
                  for b, s in zip(bests, spans)]
        bests = self._eval_candidates(stacks)
        stacks = []
        for (best, _), s in zip(bests, spans):
            fine = (best[ANGLE] + np.linspace(-20.0, 20.0, 9)) \
                .astype(np.float32)
            stacks.append(CTFEstimator._astig_candidates(best, s / 5.0,
                                                         n_astig, fine))
        bests = self._eval_candidates(stacks)
        for e, (best, cost) in zip(self.ests, bests):
            e.params = best
            e.final_fitness = cost


def estimate_ctf_batch(psd_halves, sampling, voltage=300.0, Cs=2.7,
                       Q0=0.07, **kw) -> list:
    """Fit B CTFs in lockstep — every compass stage and the defocus grid
    run as single batched passes over the batch. Returns a list of
    CTFDescription."""
    ests = [CTFEstimator(np.asarray(p, np.float32), sampling, voltage,
                         Cs, Q0, **kw) for p in psd_halves]
    batch = _CTFBatch(ests)
    # one pass for all radial profiles
    from xmipp3_tpu_torch.ops.fourier import radial_average_half
    nbins = ests[0].n // 2
    profs = radial_average_half(
        torch.as_tensor(np.stack([e.psd for e in ests]), device=batch.device),
        nbins).cpu().numpy()
    freqs_dig = (np.arange(nbins) + 0.5) * (0.5 / nbins)
    # vectorized background fit: base + K exp(-s sqrt(f)) is linear in
    # (base, K) given s — grid s, solve the 2x2 LSQ for every (est, s)
    # at once, keep the best (replaces B serial scipy LM fits)
    sel = (freqs_dig > 0.02) & (freqs_dig < 0.45)
    x = freqs_dig[sel] / ests[0].Ts
    Y = np.log1p(np.maximum(profs[:, sel], 0.0))          # (B, M)
    sgrid = np.geomspace(0.5, 40.0, 48)                   # (S,)
    E = np.exp(-sgrid[:, None] * np.sqrt(x)[None, :])     # (S, M)
    # fit prof ~ base + K*E directly (linear), score in log1p space
    Yp = np.maximum(profs[:, sel], 0.0)                   # (B, M)
    StS = np.stack([np.full(len(sgrid), len(x)),
                    E.sum(1), E.sum(1), (E * E).sum(1)],
                   axis=1).reshape(-1, 2, 2)              # (S, 2, 2)
    rhs = np.stack([np.broadcast_to(Yp.sum(1)[:, None],
                                    (len(Yp), len(sgrid))),
                    Yp @ E.T], axis=2)                    # (B, S, 2)
    coef = np.linalg.solve(StS[None], rhs[..., None])[..., 0]  # (B,S,2)
    pred = coef[..., 0:1] + coef[..., 1:2] * E[None]      # (B, S, M)
    err = (np.log1p(np.maximum(pred, 0.0)) - Y[:, None]) ** 2
    best_s = err.sum(-1).argmin(1)                        # (B,)
    for bi, e in enumerate(ests):
        k = best_s[bi]
        base, K = coef[bi, k]
        e.params[BASE] = max(float(base), 0.0)
        e.params[SQK] = abs(float(K))
        e.params[SQU] = e.params[SQV] = float(sgrid[k])
        e.params[SQANG] = 0.0
        e.fit_gaussian1(optimize=False, profile=(freqs_dig, profs[bi]))
    batch.powell(STAGE_SETS["bg_sqrt"] + STAGE_SETS["bg_gauss"], maxiter=2,
                 label="bg")
    if ests[0].no_defocus:
        for e in ests:
            e._keep_initial_defocus()
        batch.powell([LOGK], maxiter=2, label="gain")
    else:
        batch.grid_search_defocus()
        batch.powell(STAGE_SETS["defocus"], maxiter=3, use_enh=True,
                     label="defocus")
    if not ests[0].fast:
        batch.powell(STAGE_SETS["envelope"], maxiter=3, label="envelope")
        if ests[0].model_simplification < 2:
            for e in ests:
                e._g2_init()
            batch.powell(STAGE_SETS["bg_gauss2"], maxiter=2, label="gauss2")
        batch.powell(STAGE_SETS["all"], maxiter=4, label="all")
    elif not ests[0].no_defocus:
        batch.powell(STAGE_SETS["defocus"], maxiter=2, use_enh=True,
                     label="defocus2")
    if abs(ests[0].consts[4]) > 1e-3:
        batch.powell(STAGE_SETS["all_vpp"], maxiter=2, label="vpp")
    return [e.to_ctf() for e in ests]
