"""Physical constants and unit conversions.

Values match the reference implementation exactly so that numerical parity
holds to 1e-6 (reference: gauNEGF/scf.py:64, gauNEGF/transport.py:34-37,
gauNEGF/density.py:60-61, gauNEGF/surfGBethe.py:40-44).
"""

HAR_TO_EV = 27.211386    # eV / Hartree
EOVERH = 3.874e-5        # A / eV   (e/h Landauer prefactor)
KB = 8.617e-5            # eV / Kelvin
V_TO_AU = 0.03675        # Volts -> Hartree / elementary charge
BOHR_TO_ANG = 0.529177   # Bohr radius -> Angstrom

# Lowercase aliases matching the reference's variable names
har_to_eV = HAR_TO_EV
eoverh = EOVERH
kB = KB
V_to_au = V_TO_AU
bohr_to_ang = BOHR_TO_ANG
