"""End-to-end transport on a tight-binding chain junction (no Gaussian).

Wide-band contacts on a TB chain -> transmission, DOS and Landauer
current, sharded over an energy mesh of torch.distributed ranks: a world
of one rank, unless launched under torchrun (one rank per device, e.g.
``torchrun --nproc-per-node 4 -m gaunegf_tpu_torch.examples.
tb_chain_transport``).
Run: python -m gaunegf_tpu_torch.examples.tb_chain_transport
"""

import os
import tempfile

import numpy as np

from gaunegf_tpu_torch import transport as tr
from gaunegf_tpu_torch.examples import cli
from gaunegf_tpu_torch.parallel.mesh import energy_mesh


def main(device, backend=None):
    """max T(E), the integrated DOS and the current at 0.5 V, 300 K.
    ``backend`` is the mesh's: 'nccl' for 'cuda' and 'gloo' for 'cpu'
    unless given."""
    n = 64
    H = -1.0 * (np.eye(n, k=1) + np.eye(n, k=-1))
    S = np.eye(n)

    # wide-band-limit contacts: Gamma = 0.2 eV on the 4 end sites each
    n_c = 4
    sig = np.zeros((n, n), dtype=complex)
    sig[np.ix_(range(n_c), range(n_c))] = -0.1j * np.eye(n_c)
    sig2 = np.zeros((n, n), dtype=complex)
    sig2[np.ix_(range(n - n_c, n), range(n - n_c, n))] = -0.1j * np.eye(n_c)

    if backend is None:
        backend = "nccl" if str(device).startswith("cuda") else "gloo"
    mesh = energy_mesh(device=device, backend=backend)  # ranks on 'e'
    source = tr.SigmaSource(sig, sig2)

    E = np.linspace(-3, 3, 400)
    with tempfile.TemporaryDirectory() as tmp:
        T = tr.calculate_transmission(
            H, S, source, E, device=device, mesh=mesh,
            checkpoint_file=os.path.join(tmp, "tb_trans.npz"))
    dos_tot, _ = tr.calculate_dos(H, S, source, E, device=device, mesh=mesh)
    current = tr.calculate_current(H, S, source, fermi=0.0, qV=0.5, T=300.0,
                                   dE=0.01, device=device, mesh=mesh)
    dos_int = float(np.trapezoid(dos_tot, E))
    print(f"max T(E) = {T.max():.3f}  (ideal single channel -> ~1)")
    print(f"integrated DOS a.u. = {dos_int:.1f}")
    print(f"I(V=0.5V, 300K) = {current:.3e} A")
    return {"max_T": float(T.max()), "dos_integral": dos_int,
            "current": float(current), "ranks": mesh.shape["e"]}


if __name__ == "__main__":
    cli(main, __doc__, backend="torch.distributed backend (default: nccl "
                               "on cuda, gloo on cpu)")
