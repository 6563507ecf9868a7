"""International Standard Atmosphere temperature profile.

Port of ``gcmiipy_tpu/physics/isa.py`` (reference
``standard_atmosphere_isa.py``): an 8-point pressure -> temperature table
(reference ``standard_atmosphere_isa.py:6-11``) used to initialize columns.
SI units (the reference stores Celsius and converts with
``.to_base_units()``).
"""

import numpy as np

from gcmiipy_tpu_torch.physics.ozone import interp

# (reference standard_atmosphere_isa.py:6-7; Celsius converted to Kelvin)
ISA_PRESSURES_PA = np.asarray(
    [0.3734, 3.9564, 66.939, 110.91, 868.02, 5474.9, 22632.0, 108900.0]
)
ISA_TEMPERATURES_K = np.asarray(
    [-86.28, -58.5, -2.5, -2.5, -44.5, -56.5, -56.5, 19.0]
) + 273.15


def temp_at(p):
    """ISA temperature [K] at pressure ``p`` [Pa] (reference
    standard_atmosphere_isa.py:10-11)."""
    return interp(p, ISA_PRESSURES_PA, ISA_TEMPERATURES_K)
