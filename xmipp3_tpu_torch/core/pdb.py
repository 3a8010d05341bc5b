"""PDB/CIF atomic model support.

Counterpart of the reference package's core/pdb.py (reference
data/pdb.{h,cpp}: atom I/O, form factors, rasterization; cifpp there, here a
self-contained parser for the fixed-column PDB format and a minimal mmCIF
atom_site reader). The readers, writers and the per-atom splatting are host
numpy, as in the reference; the Fourier downscaling of a finer
rasterization runs on `device` (ops/resize.py), and the blob profile is
ops/basis.py's.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# approximate atomic numbers for common cryo-EM elements (electron counts
# drive scattering strength at this level of modeling)
ATOMIC_NUMBER = {"H": 1, "C": 6, "N": 7, "O": 8, "P": 15, "S": 16,
                 "FE": 26, "MG": 12, "ZN": 30, "CA": 20, "K": 19, "NA": 11,
                 "CL": 17, "MN": 25, "CU": 29}


# covalent radii (Å) for the blob/Gaussian atom descriptions
ATOMIC_RADIUS = {"H": 0.32, "C": 0.77, "N": 0.75, "O": 0.73, "P": 1.06,
                 "S": 1.02, "FE": 1.25, "MG": 1.30, "ZN": 1.25,
                 "CA": 1.74, "K": 2.03, "NA": 1.54, "CL": 0.99,
                 "MN": 1.35, "CU": 1.28}


@dataclass
class AtomicModel:
    coords: np.ndarray          # (N,3) Å, (x,y,z)
    elements: list
    bfactors: np.ndarray
    occupancies: np.ndarray
    het: np.ndarray | None = None       # True where record == HETATM

    def __len__(self):
        return len(self.coords)

    @property
    def weights(self) -> np.ndarray:
        return np.array([ATOMIC_NUMBER.get(e.upper(), 6)
                         for e in self.elements], np.float32)

    @property
    def radii(self) -> np.ndarray:
        return np.array([ATOMIC_RADIUS.get(e.upper(), 0.77)
                         for e in self.elements], np.float32)

    def centered(self) -> "AtomicModel":
        c = self.coords.mean(axis=0)
        return AtomicModel(self.coords - c, self.elements, self.bfactors,
                           self.occupancies, self.het)

    def select(self, mask) -> "AtomicModel":
        mask = np.asarray(mask, bool)
        return AtomicModel(self.coords[mask],
                           [e for e, m in zip(self.elements, mask) if m],
                           self.bfactors[mask], self.occupancies[mask],
                           self.het[mask] if self.het is not None
                           else None)


def read_pdb(path: str) -> AtomicModel:
    coords, elements, bf, occ, het = [], [], [], [], []
    if path.endswith(".cif") or path.endswith(".mmcif"):
        return _read_cif(path)
    with open(path) as f:
        for line in f:
            if line.startswith(("ATOM  ", "HETATM")):
                try:
                    x = float(line[30:38])
                    y = float(line[38:46])
                    z = float(line[46:54])
                except ValueError:
                    continue
                coords.append((x, y, z))
                el = line[76:78].strip() or line[12:14].strip()[:1]
                elements.append(el or "C")
                het.append(line.startswith("HETATM"))
                try:
                    occ.append(float(line[54:60]))
                except ValueError:
                    occ.append(1.0)
                try:
                    bf.append(float(line[60:66]))
                except ValueError:
                    bf.append(0.0)
    return AtomicModel(np.array(coords, np.float64), elements,
                       np.array(bf, np.float32), np.array(occ, np.float32),
                       np.array(het, bool))


def _read_cif(path: str) -> AtomicModel:
    """Minimal mmCIF atom_site loop reader."""
    cols = []
    rows = []
    in_loop = False
    with open(path) as f:
        for line in f:
            s = line.strip()
            if s.startswith("loop_"):
                in_loop = True
                cols = []
                continue
            if in_loop and s.startswith("_atom_site."):
                cols.append(s.split(".")[1].strip())
                continue
            if in_loop and cols:
                if s.startswith(("_", "loop_", "#")) or not s:
                    if rows:
                        break
                    in_loop = bool(cols)
                    continue
                toks = s.split()
                if len(toks) >= len(cols):
                    rows.append(toks[: len(cols)])
    if not rows:
        raise ValueError(f"no atom_site records in {path}")
    ix = {c: i for i, c in enumerate(cols)}
    def col(name, cast=str, default=None):
        if name not in ix:
            return [default] * len(rows)
        return [cast(r[ix[name]]) for r in rows]
    xs = col("Cartn_x", float, 0.0)
    ys = col("Cartn_y", float, 0.0)
    zs = col("Cartn_z", float, 0.0)
    els = col("type_symbol", str, "C")
    occ = col("occupancy", float, 1.0)
    bf = col("B_iso_or_equiv", float, 0.0)
    return AtomicModel(np.stack([xs, ys, zs], axis=1).astype(np.float64),
                       els, np.array(bf, np.float32),
                       np.array(occ, np.float32))


@dataclass
class RichAtom:
    """Full atom record (reference data/pdb.h RichAtom, asserted by
    test_cif_main.cpp compareFirstAtom). mmCIF '.'/'?' null tokens map
    to empty strings."""
    serial: int = 0
    name: str = ""
    alt_id: str = ""            # label_alt_id
    resname: str = ""           # label_comp_id
    altloc: str = ""            # label_asym_id (reference field name)
    resseq: int = 0             # label_seq_id
    seq_id: int = 0             # label_entity_id
    icode: str = ""
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    occupancy: float = 1.0
    bfactor: float = 0.0
    charge: str = ""
    auth_seq_id: int = 0
    auth_comp_id: str = ""
    auth_asym_id: str = ""
    auth_atom_id: str = ""
    pdb_num: int = 1            # pdbx_PDB_model_num
    record: str = "ATOM"


_CIF_ATOM_COLS = [
    "group_PDB", "id", "type_symbol", "label_atom_id", "label_alt_id",
    "label_comp_id", "label_asym_id", "label_entity_id", "label_seq_id",
    "pdbx_PDB_ins_code", "Cartn_x", "Cartn_y", "Cartn_z", "occupancy",
    "B_iso_or_equiv", "pdbx_formal_charge", "auth_seq_id", "auth_comp_id",
    "auth_asym_id", "auth_atom_id", "pdbx_PDB_model_num"]


def _cif_open(path: str):
    if path.endswith(".gz"):
        import gzip
        return gzip.open(path, "rt")
    return open(path)


def _null(tok: str) -> str:
    return "" if tok in (".", "?") else tok


def read_rich_cif(path: str) -> list[RichAtom]:
    """mmCIF atom_site loop -> RichAtom list (reference PDBRichPhantom::read
    via libcifpp, data/pdb.cpp; field mapping pinned by test_cif_main.cpp)."""
    cols, rows = [], []
    in_loop = False
    with _cif_open(path) as f:
        for line in f:
            s = line.strip()
            if s.startswith("loop_"):
                in_loop = True
                cols = []
                continue
            if in_loop and s.startswith("_atom_site."):
                cols.append(s.split(".", 1)[1].strip())
                continue
            if in_loop and cols:
                if s.startswith(("_", "loop_", "#")) or not s:
                    if rows:
                        break
                    in_loop = False
                    cols = []
                    continue
                toks = s.split()
                if len(toks) >= len(cols):
                    rows.append(toks[:len(cols)])
    if not rows:
        raise ValueError(f"no atom_site records in {path}")
    ix = {c: i for i, c in enumerate(cols)}

    def get(r, name, default=""):
        return r[ix[name]] if name in ix else default

    def geti(r, name):
        tok = _null(get(r, name, "0"))
        return int(tok) if tok else 0

    atoms = []
    for r in rows:
        atoms.append(RichAtom(
            serial=geti(r, "id"),
            name=_null(get(r, "label_atom_id")),
            alt_id=_null(get(r, "label_alt_id")),
            resname=_null(get(r, "label_comp_id")),
            altloc=_null(get(r, "label_asym_id")),
            resseq=geti(r, "label_seq_id"),
            seq_id=geti(r, "label_entity_id"),
            icode=_null(get(r, "pdbx_PDB_ins_code")),
            x=float(get(r, "Cartn_x", "0")),
            y=float(get(r, "Cartn_y", "0")),
            z=float(get(r, "Cartn_z", "0")),
            occupancy=float(_null(get(r, "occupancy", "1")) or 1.0),
            bfactor=float(_null(get(r, "B_iso_or_equiv", "0")) or 0.0),
            charge=_null(get(r, "pdbx_formal_charge")),
            auth_seq_id=geti(r, "auth_seq_id"),
            auth_comp_id=_null(get(r, "auth_comp_id")),
            auth_asym_id=_null(get(r, "auth_asym_id")),
            auth_atom_id=_null(get(r, "auth_atom_id")),
            pdb_num=geti(r, "pdbx_PDB_model_num") or 1,
            record=get(r, "group_PDB", "ATOM")))
    return atoms


def write_rich_cif(path: str, atoms: list[RichAtom]) -> None:
    """Write the atom_site loop back out (reference PDBRichPhantom::write
    CIF branch; test_cif_main.cpp writeFile roundtrips through this)."""
    def tok(s: str) -> str:
        return s if s else "."
    with open(path, "w") as f:
        f.write("data_xmipp3tpu\n#\nloop_\n")
        for c in _CIF_ATOM_COLS:
            f.write(f"_atom_site.{c}\n")
        for a in atoms:
            f.write(" ".join([
                a.record, str(a.serial), tok(a.name and a.name[0]),
                tok(a.name), tok(a.alt_id), tok(a.resname), tok(a.altloc),
                str(a.seq_id), str(a.resseq), "?" if not a.icode
                else a.icode, f"{a.x:.3f}", f"{a.y:.3f}", f"{a.z:.3f}",
                f"{a.occupancy:.2f}", f"{a.bfactor:.2f}",
                "?" if not a.charge else a.charge, str(a.auth_seq_id),
                tok(a.auth_comp_id), tok(a.auth_asym_id),
                tok(a.auth_atom_id), str(a.pdb_num)]) + "\n")
        f.write("#\n")


def rich_to_model(atoms: list[RichAtom]) -> AtomicModel:
    """RichAtom list -> the compact AtomicModel used by rasterization."""
    coords = np.array([[a.x, a.y, a.z] for a in atoms], np.float64)
    els = [a.name[:1] if a.name else "C" for a in atoms]
    return AtomicModel(coords, els,
                       np.array([a.bfactor for a in atoms], np.float32),
                       np.array([a.occupancy for a in atoms], np.float32))


def write_pdb(path: str, model: AtomicModel) -> None:
    with open(path, "w") as f:
        for i in range(len(model)):
            x, y, z = model.coords[i]
            el = model.elements[i]
            f.write(f"ATOM  {i + 1:5d}  {el:<3s} ALA A{(i % 9999) + 1:4d}    "
                    f"{x:8.3f}{y:8.3f}{z:8.3f}{model.occupancies[i]:6.2f}"
                    f"{model.bfactors[i]:6.2f}          {el:>2s}\n")
        f.write("END\n")


# Peng (1996) 5-Gaussian electron scattering factors f(s)=sum a_i
# exp(-b_i s^2); real-space density rho(r) = sum a_i (4 pi / b_i)^{3/2}
# exp(-4 pi^2 r^2 / b_i).  (Public physical constants.)
PENG_A = {
    "H": (0.0349, 0.1201, 0.1970, 0.0573, 0.1195),
    "C": (0.0893, 0.2563, 0.7570, 1.0487, 0.3575),
    "N": (0.1022, 0.3219, 0.7982, 0.8197, 0.1715),
    "O": (0.0974, 0.2921, 0.6910, 0.6990, 0.2039),
    "P": (0.2548, 0.6106, 1.4541, 2.3204, 0.8477),
    "S": (0.2497, 0.5628, 1.3899, 2.1865, 0.7715),
    "FE": (0.3946, 1.2725, 1.7031, 2.3140, 1.4795),
}
PENG_B = {
    "H": (0.5347, 3.5867, 12.3471, 18.9525, 38.6269),
    "C": (0.2465, 1.7100, 6.4094, 18.6113, 50.2523),
    "N": (0.2451, 1.7481, 6.1925, 17.3894, 48.1431),
    "O": (0.2067, 1.3815, 4.6943, 12.7105, 32.4726),
    "P": (0.2908, 1.8740, 8.5176, 24.3434, 63.2996),
    "S": (0.2681, 1.6711, 7.0267, 19.5377, 50.3888),
    "FE": (0.2717, 2.0443, 7.6007, 29.9714, 86.2265),
}


def scattering_density(element: str, r2_A2: np.ndarray) -> np.ndarray:
    """Real-space electron scattering density at squared radii (Å²)."""
    el = element.upper()
    if el not in PENG_A:
        el = "C"
    out = np.zeros_like(r2_A2, np.float64)
    for a, b in zip(PENG_A[el], PENG_B[el]):
        out += a * (4 * np.pi / b) ** 1.5 * np.exp(-4 * np.pi ** 2
                                                   * r2_A2 / b)
    return out


def rasterize_modes(model: AtomicModel, dims, sampling: float,
                    mode: str = "scattering", origin=None,
                    sigma: float = -1.0, intensity: str = "occupancy",
                    high_sampling: float | None = None,
                    device=None) -> np.ndarray:
    """Full volume_from_pdb atom-splatting surface
    (volume_from_pdb.cpp:330-480): modes scattering (Peng profiles),
    blobs (Kaiser-Bessel at the atomic radius), poor_gaussian,
    fixed_gaussian (sigma<=0 takes the per-atom sigma from the B-factor
    column); `intensity` picks the weight column in fixed mode;
    `origin` shifts the voxel origin; `high_sampling` rasterizes at a
    finer grid then Fourier-downscales to `sampling` (on `device`, the
    card by default). Returns a host (Z, Y, X) float32 array."""
    if high_sampling is not None and high_sampling < sampling:
        from xmipp3_tpu_torch.ops.resize import fourier_resize_3d
        factor = sampling / high_sampling
        hi_dims = tuple(int(np.ceil(d * factor)) for d in dims)
        hi_orig = (None if origin is None
                   else tuple(o * factor for o in origin))
        hi = rasterize_modes(model, hi_dims, high_sampling, mode,
                             hi_orig, sigma, intensity, None)
        out = fourier_resize_3d(hi, *dims, device=device).cpu().numpy()
        # preserve total mass under the grid change
        return out * (factor ** 3)
    dz, dy, dx = int(dims[2]), int(dims[1]), int(dims[0])
    vol = np.zeros((dz, dy, dx), np.float32)
    if origin is None:
        org = np.array([dx // 2, dy // 2, dz // 2], np.float64)
    else:
        org = -np.asarray(origin, np.float64)         # STARTINGX = orig
    vox = model.coords / sampling + org               # (N,3) x,y,z
    radii_A = model.radii
    use_bfactor = intensity.lower() == "bfactor"
    if mode == "fixed_gaussian":
        weights = (model.bfactors if use_bfactor else model.occupancies)
    else:
        weights = model.weights
    from xmipp3_tpu_torch.ops.basis import kaiser_value
    for i in range(len(model)):
        el = model.elements[i]
        if mode == "scattering":
            rad_A = 4.0
        elif mode == "blobs":
            rad_A = float(radii_A[i])
        elif mode == "poor_gaussian":
            rad_A = max(radii_A[i] / sampling, 4.5)
        else:                                          # fixed_gaussian
            sg = sigma if sigma > 0 else max(float(model.bfactors[i]),
                                             1e-3)
            rad_A = 4.5 * sg
        r_vox = max(int(np.ceil(rad_A / sampling)), 1)
        x, y, z = vox[i]
        ix, iy, iz = int(round(x)), int(round(y)), int(round(z))
        if not (r_vox <= ix < dx - r_vox and r_vox <= iy < dy - r_vox
                and r_vox <= iz < dz - r_vox):
            continue
        offs = np.arange(-r_vox, r_vox + 1)
        oz, oy, ox = np.meshgrid(offs, offs, offs, indexing="ij")
        r2 = (((oz + iz - z) ** 2 + (oy + iy - y) ** 2
               + (ox + ix - x) ** 2) * sampling ** 2)
        if mode == "scattering":
            dens = scattering_density(el, r2)
        elif mode == "blobs":
            dens = weights[i] * kaiser_value(np.sqrt(r2), a=rad_A,
                                             alpha=10.4, m=2)
        else:
            if mode == "poor_gaussian":
                sg = rad_A / (3 * np.sqrt(2.0))
            else:
                sg = sigma if sigma > 0 else max(float(model.bfactors[i]),
                                                 1e-3)
            norm = 1.0 / (2 * np.pi * sg * sg) ** 1.5
            dens = weights[i] * np.exp(-r2 / (2 * sg * sg)) * norm
        vol[iz - r_vox:iz + r_vox + 1, iy - r_vox:iy + r_vox + 1,
            ix - r_vox:ix + r_vox + 1] += dens.astype(np.float32)
    return vol


def rasterize(model: AtomicModel, size: int, sampling: float,
              sigma_a: float = 1.0, center: bool = True) -> np.ndarray:
    """Atoms -> voxel volume: gaussian splat weighted by atomic number
    (reference volume_from_pdb behavior at low resolution)."""
    m = model.centered() if center else model
    vol = np.zeros((size, size, size), np.float32)
    half = size // 2
    vox = m.coords / sampling + half            # (N,3) voxel coords (x,y,z)
    w = m.weights * m.occupancies
    sig = sigma_a / sampling
    r = max(int(np.ceil(3 * sig)), 1)
    offs = np.arange(-r, r + 1)
    dz, dy, dx = np.meshgrid(offs, offs, offs, indexing="ij")
    kernel_d2 = (dz ** 2 + dy ** 2 + dx ** 2).astype(np.float32)
    for i in range(len(m)):
        x, y, z = vox[i]
        ix, iy, iz = int(round(x)), int(round(y)), int(round(z))
        if not (r <= ix < size - r and r <= iy < size - r and
                r <= iz < size - r):
            continue
        fx, fy, fz = x - ix, y - iy, z - iz
        d2 = ((dz - fz) ** 2 + (dy - fy) ** 2 + (dx - fx) ** 2)
        vol[iz - r:iz + r + 1, iy - r:iy + r + 1, ix - r:ix + r + 1] += \
            w[i] * np.exp(-d2 / (2 * sig * sig)).astype(np.float32)
    return vol
