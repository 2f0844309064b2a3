"""Reference-named compatibility facade over gaunegf_tpu_torch.

Mirrors the public module/function/class names of wliverno/GauNEGF
(``gauNEGF.density``, ``gauNEGF.scf.NEGF``, ``gauNEGF.transport`` ...)
so existing reference scripts run on the GPU with an import change only::

    from gaunegf_tpu_torch.compat import density, transport
    from gaunegf_tpu_torch.compat.scf import NEGF  # Gaussian-backed

or, for verbatim ``import gauNEGF...`` scripts::

    import gaunegf_tpu_torch.compat as compat
    compat.install()                               # registers 'gauNEGF'
    from gauNEGF.scfE import NEGFE                 # now resolves here

Every wrapper translates the reference's camelCase keyword names
(``maxN``, ``showText``, ``fermiGuess`` ...) to this package's API and
delegates.  The reference's signatures carry no device; the facade holds
one, ``'cuda'`` by default (``install(device=...)``, ``set_device``), and
every facade class and function takes a ``device=`` keyword that
overrides it.  Without a GPU ``'cuda'`` raises; nothing falls back to the
CPU.  Reference surface: the module list in SURVEY.md section 2.1
(gauNEGF/*.py public defs).
"""

import sys

from gaunegf_tpu_torch.compat._device import get_device, set_device
from gaunegf_tpu_torch.compat import (  # noqa: F401
    config, density, fermiSearch, integrate, matTools, scf, scfE, surfG1D,
    surfG3D, surfGBethe, surfGTester, transport, utils)

_SUBMODULES = ("config", "density", "fermiSearch", "integrate", "matTools",
               "scf", "scfE", "surfG1D", "surfG3D", "surfGBethe",
               "surfGTester", "transport", "utils")

__all__ = list(_SUBMODULES) + ["install", "set_device", "get_device"]


def install(name: str = "gauNEGF", device=None) -> None:
    """Register this facade in sys.modules under the reference's package
    name, making ``import gauNEGF.density`` etc. resolve here, and set the
    facade's device when one is given.  Refuses to shadow any other module
    of that name: a genuinely installed package, or the JAX package's
    facade installed under it."""
    existing = sys.modules.get(name)
    pkg = sys.modules[__name__]
    if existing is not None and existing is not pkg:
        raise RuntimeError(
            f"refusing to install compat alias: module {name!r} is already "
            f"imported (from {getattr(existing, '__name__', existing)!r}); "
            "unimport it first or use gaunegf_tpu_torch.compat directly")
    if device is not None:
        set_device(device)
    sys.modules[name] = pkg
    for sub in _SUBMODULES:
        sys.modules[f"{name}.{sub}"] = getattr(pkg, sub)
