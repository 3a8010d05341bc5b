"""Streaming band-PCA (reference py_xmipp/classifyPcaFuntion/pca_gpu.py
API: PCAgpu with first_mean/variance/covariance/eigenvector batch
initialization and mean/var/eigenvalue/eigenvector streaming updates —
Oja's rule per frequency band). Host numpy, as on the reference
package's side."""
from __future__ import annotations

import numpy as np


class PCAgpu:
    def __init__(self, nBand):
        self.nBand = int(nBand)

    # -- batch initialization on the first subset ---------------------------
    def first_mean(self, firstBands, firstSet):
        self.mean = np.asarray(firstBands).sum(axis=0) / firstSet
        return self.mean

    def first_variance(self, firstBands, firstSet):
        self.first_mean(firstBands, firstSet)
        c = np.asarray(firstBands) - self.mean[None]
        self.var = np.square(c).sum(axis=0) / firstSet
        return self.mean, self.var

    def first_covariance(self, firstBands, firstSet):
        self.first_variance(firstBands, firstSet)
        self.covariance = np.cov(np.asarray(firstBands).T)
        return self.covariance, self.mean, self.var

    def first_eigenvector(self, firstBands, firstSet):
        self.first_covariance(firstBands, firstSet)
        vals, vecs = np.linalg.eigh(self.covariance)
        self.vals = vals[::-1].copy()
        self.vecs = vecs[:, ::-1].copy()
        return self.mean, self.var, self.vals, self.vecs

    # -- streaming updates (one image at a time, per band) ------------------
    def mean_update(self, band, mean, nIm):
        self.meanUp = [(nIm * mean[n] + band[n]) / (nIm + 1)
                       for n in range(self.nBand)]
        return self.meanUp

    def var_update(self, band, mean, var, nIm):
        self.varUp = [(nIm * var[n] + (band[n] - mean[n]) ** 2) / (nIm + 1)
                      for n in range(self.nBand)]
        return self.varUp

    def phiProjTrain(self, band, mean, vecs):
        # phi = (x - mean)^T V
        self.phi = [(band[n] - mean[n])[None, :] @ vecs[n]
                    for n in range(self.nBand)]
        return self.phi

    def phiProj(self, band, vecs):
        self.proj = [band[n][None, :] @ vecs[n] for n in range(self.nBand)]
        return self.proj

    def eigenvalue_update(self, vals, phi, gamma):
        # lambda <- (1-gamma) lambda + gamma phi^2
        g = float(gamma)
        self.eigval = [vals[n].reshape(1, -1) * (1 - g)
                       + (phi[n] * phi[n]) * g
                       for n in range(self.nBand)]
        return self.eigval

    def eigenvector_update(self, band, vecs, phi, mean, gamma, num_eig):
        # Oja + Gram-Schmidt: v_k <- v_k + gamma phi_k (x - mean
        #                                  - sum_{j<=k} phi_j v_j)
        g = float(gamma)
        self.vecs_update = []
        for n in range(self.nBand):
            x = band[n] - mean[n]
            V = np.asarray(vecs[n]).copy()
            p = np.asarray(phi[n]).ravel()
            recon = np.zeros_like(x)
            for k in range(min(int(num_eig[n]), V.shape[1])):
                recon = recon + p[k] * V[:, k]
                V[:, k] = V[:, k] + g * p[k] * (x - recon)
                nrm = np.linalg.norm(V[:, k])
                if nrm > 1e-12:
                    V[:, k] /= nrm
            self.vecs_update.append(V)
        return self.vecs_update
