"""The JAX package's five examples on gaunegf_tpu_torch.

Each module has ``main(device)``, which runs the example on ``device``
(no CPU fallback: 'cuda' without a GPU raises) and returns the numbers it
prints, and runs from the command line as

    python -m gaunegf_tpu_torch.examples.<name> [--device cuda|cpu]

with ``--device`` defaulting to 'cuda'.  Files an example writes go to a
temporary directory (``TMPDIR``), removed when it ends.
"""

import argparse

EXAMPLES = ("au_electrode_kspace", "integral_demo", "reference_migration",
            "si_nanowire_scf", "tb_chain_transport")


def cli(main, doc, argv=None, **extra):
    """Parse ``--device`` (and the ``extra`` options: name -> help) and
    call main(device, ...)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    for name, help_ in extra.items():
        ap.add_argument(f"--{name}", default=None, help=help_)
    args = ap.parse_args(argv)
    return main(**vars(args))
