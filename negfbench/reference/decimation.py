"""Self-energies of semi-infinite periodic leads, worked out again: the
textbook Lopez Sancho-Rubio decimation and the embedding into the device
matrix.

A frozen copy of the construction of M. P. Lopez Sancho, J. M. Lopez
Sancho and J. Rubio, J. Phys. F 15, 851 (1985), unbalanced: for a lead of
principal layers with on-site block h00 and coupling t from each layer to
the next one away from the device, at z = E + i eta,

    eps_s = eps = h00, alpha = t, beta = t^+;  per iteration
    g = (z - eps)^-1, eps_s += alpha g beta,
    eps += alpha g beta + beta g alpha,
    alpha = alpha g alpha, beta = beta g beta;

the surface Green's function is (z - eps_s)^-1 and the device's contact
cell, coupled to the surface layer by the same t, sees t g_s t^+.  Each
energy stops once the largest change of eps_s is below ``CONV`` of its
largest entry, or after ``MAX_ITER`` iterations.  complex128 throughout.
"""

from __future__ import annotations

import numpy as np
import torch

CONV = 1e-13
MAX_ITER = 200
BLOCK = 64              # energies a batch


def surface_g(h00, t, z, conv=CONV, max_iter=MAX_ITER):
    """The surface Green's functions (b, n, n) at the energies z (b,)
    (complex tensor, eta included) of the lead (h00, t), both (n, n)
    complex128 tensors on z's device."""
    b, n = z.shape[0], h00.shape[0]
    eye = torch.eye(n, dtype=torch.complex128, device=z.device)
    w = z.to(torch.complex128)[:, None, None] * eye
    eps_s = h00.expand(b, n, n).clone()
    eps = eps_s.clone()
    al = t.expand(b, n, n).clone()
    be = t.conj().T.expand(b, n, n).clone()
    live = torch.ones(b, dtype=torch.bool, device=z.device)
    for _ in range(max_iter):
        i = live.nonzero().squeeze(1)
        if i.numel() == 0:
            break
        g = torch.linalg.inv(w[i] - eps[i])
        agb = al[i] @ g @ be[i]
        bga = be[i] @ g @ al[i]
        new = eps_s[i] + agb
        change = agb.abs().amax(dim=(1, 2)) \
            / new.abs().amax(dim=(1, 2)).clamp(min=1e-300)
        eps_s[i] = new
        eps[i] = eps[i] + agb + bga
        al[i] = al[i] @ g @ al[i]
        be[i] = be[i] @ g @ be[i]
        live[i] = ~(change < conv)
    return torch.linalg.inv(w - eps_s)


class Leads:
    """The contacts' self-energies of a device between periodic leads.
    h00: the lead layer's on-site block; couplings: per contact, t from
    the device's contact cell to the lead's surface layer (the same t
    joins each layer to the next); cells: per contact, the device's
    orbitals of its contact cell; N: the device's size."""

    def __init__(self, h00, couplings, cells, N, eta, device):
        c = lambda x: torch.as_tensor(np.asarray(x, dtype=complex),
                                      device=device)
        self.device, self.N, self.eta = device, N, float(eta)
        self.h00 = c(h00)
        self.ts = [c(t) for t in couplings]
        self.cells = [torch.as_tensor(np.asarray(i), device=device)
                      for i in cells]

    def blocks(self, E):
        """Per contact, t g_s t^+ (b, n, n) at the energies E (complex
        tensor), BLOCK energies at a time."""
        z = E.to(torch.complex128) + 1j * self.eta
        out = []
        for t in self.ts:
            parts = []
            for i in range(0, z.shape[0], BLOCK):
                g = surface_g(self.h00, t, z[i:i + BLOCK])
                parts.append(t @ g @ t.conj().T)
            out.append(torch.cat(parts))
        return out

    def embed(self, blocks):
        """The (b, N, N) self-energies of the blocks."""
        sigs = []
        for f, blk in zip(self.cells, blocks):
            sig = torch.zeros((blk.shape[0], self.N, self.N),
                              dtype=torch.complex128, device=blk.device)
            sig[:, f[:, None], f[None, :]] = blk
            sigs.append(sig)
        return sigs

    def table(self, E_all):
        """sigmas(E) for density / transmission over energies that all lie
        in E_all: every energy's blocks from one decimation per contact,
        embedded a chunk at a time."""
        E_all = np.asarray(E_all, dtype=complex).ravel()
        blocks = self.blocks(torch.as_tensor(E_all, device=self.device))
        where = {complex(e): i for i, e in enumerate(E_all)}

        def sigmas(Eb):
            idx = torch.as_tensor([where[complex(e)] for e in
                                   Eb.cpu().numpy()], device=self.device)
            return self.embed([b[idx] for b in blocks])
        return sigmas

    def total_at(self, e):
        """The (N, N) total self-energy at one energy, NumPy."""
        Et = torch.as_tensor(np.array([e], dtype=complex), device=self.device)
        return sum(self.embed(self.blocks(Et)))[0].cpu().numpy()
