"""The small CNN toolkit behind the deep_* programs, as torch.nn modules.

The three networks of the reference package's models/deep.py at its
widths, in PyTorch's channels-first layout:

- ConvNet2D: three blocks of 3x3 conv (SAME) -> GroupNorm(min(8, w)) ->
  relu -> 2x2 max pool at widths 16, 32, 64, a global average pool,
  Dense 64 -> relu -> Dense n_out;
- ConvNet3D: the same with 3x3x3 convs, widths 8, 16, 32 and
  GroupNorm(min(4, w));
- UNet3DLite: a two-scale residual net of width 16 (two convs, a pool,
  two convs at 2w, a nearest 2x upsampling, the skip concatenated as
  [h1, u], one conv, and x + a last conv to one channel).

The convolutions are cuDNN's; the programs run them in full float32
(device.fp32_products) and train with its deterministic algorithms, so
that a recipe trains the same net on every run of the card. Weights
carry both ways between these modules and the reference's flax
parameter trees (params_from_flax / flax_from_params): flax names its
layers Conv_0, GroupNorm_0, Dense_0 ... in creation order, keeps conv
kernels as (k..., in, out) and dense kernels as (in, out), and
normalises with epsilon 1e-6. A model file is a pickle of {"kind",
"params", "meta"} as the reference writes it, with "params" the nested
flax tree of numpy arrays instead of flax's msgpack bytes.

train_model reproduces the reference's loop step for step: the batches
come from the reference's numpy Generator (np.random.default_rng(seed)
.permutation each epoch) and the optimiser is Adam with the update of
optax.adam (b1 0.9, b2 0.999, eps 1e-8). Without `init` the weights are
drawn from a torch.Generator seeded with `seed`, from the reference's
distributions (LeCun truncated normal kernels, zero biases, unit scales).
"""
from __future__ import annotations

import math
import pickle
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xmipp3_tpu_torch.device import fp32_products, resolve_device

FLAX_GROUPNORM_EPS = 1e-6


class _ConvNet(nn.Module):
    """Conv stack -> global pool -> MLP head (ConvNet2D / ConvNet3D)."""

    dims = 2
    widths = (16, 32, 64)
    max_groups = 8

    def __init__(self, n_out: int = 2, widths=None):
        super().__init__()
        widths = tuple(widths or self.widths)
        conv = nn.Conv2d if self.dims == 2 else nn.Conv3d
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        c_in = 1
        for w in widths:
            self.convs.append(conv(c_in, w, 3, padding=1))
            self.norms.append(nn.GroupNorm(min(self.max_groups, w), w,
                                           eps=FLAX_GROUPNORM_EPS))
            c_in = w
        self.dense0 = nn.Linear(c_in, 64)
        self.dense1 = nn.Linear(64, n_out)
        self.n_out = n_out

    def forward(self, x):                      # (B, 1, *spatial)
        pool = F.max_pool2d if self.dims == 2 else F.max_pool3d
        for conv, norm in zip(self.convs, self.norms):
            x = pool(F.relu(norm(conv(x))), 2, 2)
        x = x.mean(dim=tuple(range(2, x.dim())))
        return self.dense1(F.relu(self.dense0(x)))

    def flax_layers(self):
        """(flax name, torch module) in flax's creation order."""
        out = []
        for k, (c, g) in enumerate(zip(self.convs, self.norms)):
            out += [(f"Conv_{k}", c), (f"GroupNorm_{k}", g)]
        return out + [("Dense_0", self.dense0), ("Dense_1", self.dense1)]


class ConvNet2D(_ConvNet):
    dims, widths, max_groups = 2, (16, 32, 64), 8


class ConvNet3D(_ConvNet):
    dims, widths, max_groups = 3, (8, 16, 32), 4


class UNet3DLite(nn.Module):
    """Two-scale residual conv net for volume-to-volume mappings."""

    def __init__(self, width: int = 16):
        super().__init__()
        w = width
        self.convs = nn.ModuleList([
            nn.Conv3d(1, w, 3, padding=1), nn.Conv3d(w, w, 3, padding=1),
            nn.Conv3d(w, 2 * w, 3, padding=1),
            nn.Conv3d(2 * w, 2 * w, 3, padding=1),
            nn.Conv3d(3 * w, w, 3, padding=1), nn.Conv3d(w, 1, 3, padding=1)])

    def forward(self, x):                      # (B, 1, Z, Y, X)
        c = self.convs
        h1 = F.relu(c[1](F.relu(c[0](x))))
        d = F.max_pool3d(h1, 2, 2)
        d = F.relu(c[3](F.relu(c[2](d))))
        u = d.repeat_interleave(2, 2).repeat_interleave(2, 3) \
            .repeat_interleave(2, 4)           # nearest, exactly 2x
        h = F.relu(c[4](torch.cat([h1, u], dim=1)))
        return x + c[5](h)

    def flax_layers(self):
        return [(f"Conv_{k}", m) for k, m in enumerate(self.convs)]


KINDS = {"ConvNet2D": ConvNet2D, "ConvNet3D": ConvNet3D,
         "UNet3DLite": UNet3DLite}


# -- weights -----------------------------------------------------------------

def params_from_flax(model: nn.Module, tree) -> dict:
    """A state_dict of `model` from a flax parameter tree (nested dicts of
    arrays, with or without the top "params" level)."""
    tree = tree.get("params", tree)
    sd = {}
    names = {id(m): n for n, m in model.named_modules()}
    for fname, m in model.flax_layers():
        leaf = tree[fname]
        pre = names[id(m)] + "."
        if isinstance(m, nn.GroupNorm):
            sd[pre + "weight"] = np.asarray(leaf["scale"])
            sd[pre + "bias"] = np.asarray(leaf["bias"])
            continue
        k = np.asarray(leaf["kernel"])
        # conv (k..., in, out) -> (out, in, k...); dense (in, out) -> (out, in)
        sd[pre + "weight"] = np.transpose(
            k, (k.ndim - 1, k.ndim - 2, *range(k.ndim - 2)))
        sd[pre + "bias"] = np.asarray(leaf["bias"])
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}


def flax_from_params(model: nn.Module) -> dict:
    """The flax parameter tree ({"params": {...}}, numpy float32) of
    `model`'s weights: the inverse of params_from_flax."""
    out = {}
    for fname, m in model.flax_layers():
        w = m.weight.detach().cpu().numpy().astype(np.float32)
        b = m.bias.detach().cpu().numpy().astype(np.float32)
        if isinstance(m, nn.GroupNorm):
            out[fname] = {"scale": w, "bias": b}
        else:
            out[fname] = {"kernel": np.ascontiguousarray(np.transpose(
                w, (*range(2, w.ndim), 1, 0))), "bias": b}
    return {"params": out}


def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Draw `model`'s weights from a torch.Generator seeded with `seed`:
    kernels from a truncated normal on [-2, 2] sigma scaled to variance
    1/fan_in (flax's lecun_normal), biases 0, GroupNorm scales 1."""
    g = torch.Generator().manual_seed(int(seed))
    # std of the unit normal truncated to [-2, 2]
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for _, m in model.flax_layers():
            if isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                continue
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / trunc_std
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
            m.weight.copy_(w * std)
            m.bias.zero_()
    return model


def _channels(X, dev):
    """(N, *spatial) float32 numpy/tensor -> (N, 1, *spatial) on dev."""
    if isinstance(X, torch.Tensor):
        return X.to(dev, torch.float32).unsqueeze(1)
    # a copy: X may be read-only or a negative-stride view (a mirror)
    return torch.from_numpy(np.array(X, np.float32)).to(dev).unsqueeze(1)


@contextmanager
def repeatable():
    """cuDNN's deterministic algorithms inside the block: the convolutions'
    weight gradients otherwise sum with atomics in a run-dependent order,
    and the same recipe trains a different net on each run of the card.
    The previous setting comes back on exit."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def adam(model, lr):
    """Adam with optax.adam's update (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def train_model(model, X, y, loss_kind="xent", n_epochs=20, batch=32,
                lr=1e-3, seed=0, verbose=0, device=None, init=None):
    """Train `model` on X ((N, *spatial) float32) and y ((N,) int labels
    for "xent", (N, d) targets for "mse"); returns (model, per-epoch mean
    losses). `init` is a state_dict to start from (for example
    params_from_flax of the reference's init); without it init_params(
    model, seed) draws the weights."""
    dev = resolve_device(device)
    if init is None:
        init_params(model, seed)
    else:
        model.load_state_dict(init)
    model.to(dev).train()
    rng = np.random.default_rng(seed)
    Xd = _channels(X, dev)
    yd = torch.as_tensor(np.asarray(y), device=dev)
    yd = yd.long() if loss_kind == "xent" else yd.float()
    opt = adam(model, lr)
    N = len(Xd)
    hist = []
    with fp32_products(), repeatable():
        for ep in range(n_epochs):
            order = torch.as_tensor(rng.permutation(N), device=dev)
            tot = torch.zeros((), dtype=torch.float64, device=dev)
            nb = 0
            for i in range(0, N, batch):
                sl = order[i:i + batch]
                out = model(Xd[sl])
                if loss_kind == "xent":
                    loss = F.cross_entropy(out, yd[sl])
                else:
                    loss = ((out - yd[sl]) ** 2).mean()
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                tot += loss.detach()
                nb += 1
            hist.append(float(tot) / max(nb, 1))
            if verbose:
                print(f"epoch {ep + 1}: loss {hist[-1]:.4f}")
    model.eval()
    return model, hist


@torch.no_grad()
def predict(model, X, batch=64, device=None) -> np.ndarray:
    """model(X) in batches of `batch`, as float32 numpy."""
    dev = resolve_device(device)
    model.to(dev).eval()
    outs = []
    with fp32_products():
        for i in range(0, len(X), batch):
            outs.append(model(_channels(X[i:i + batch], dev)))
    return torch.cat(outs).cpu().numpy()


def save_params(path, model_kind, model, meta=None):
    """Write a model file: {"kind", "params" (the flax tree), "meta"}."""
    with open(path, "wb") as f:
        pickle.dump({"kind": model_kind, "params": flax_from_params(model),
                     "meta": meta or {}}, f)


def load_params(path, model):
    """Load a model file into `model`; returns (model, meta)."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    if isinstance(blob["params"], (bytes, bytearray)):
        raise ValueError(
            f"{path}: its weights are flax msgpack bytes (a model file of "
            "the JAX package); the port reads the parameter tree as nested "
            "numpy arrays: decode it with flax.serialization.msgpack_restore "
            "and pickle the tree in its place")
    model.load_state_dict(params_from_flax(model, blob["params"]))
    return model, blob["meta"]
