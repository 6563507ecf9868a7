"""Physical constants in plain SI scalars.

The PyTorch port keeps its own copy of ``gcmiipy_tpu/constants.py`` so that
it imports nothing of the JAX package.  Every tensor is a plain float tensor
whose implied unit is the SI unit of its quantity (the reference carries pint
units instead).  Values mirror reference ``constants.py:10-78``.
"""

import math

# Universal gas constant [J / (K mol)]             (reference constants.py:10)
R = 8.3145

# Average molecular weight of dry air [kg / mol]   (reference constants.py:13)
Md = 28.97e-3

# Gas constant of dry air [J / (K kg)]             (reference constants.py:16)
Rd = 287.0

# Density of dry air at 0C and 1000 mb [kg / m^3]  (reference constants.py:19)
rd = 1.275

# Specific heat of dry air [J / (K kg)]            (reference constants.py:22)
Cp = 1004.0

# Heat capacity of dry ground [J / (K m^3)]        (reference constants.py:25)
Cg = 1.13e6

# Potential temperature exponent [-]               (reference constants.py:28)
kappa = Rd / Cp

# Standard reference pressure [Pa]                 (reference constants.py:31)
P0 = 100000.0

# Standard pressure and temperature                (reference constants.py:37-38)
standard_pressure = 101325.0   # [Pa]
standard_temperature = 273.16  # [K]

# Mesopause temperature / pressure                 (reference constants.py:41-42)
t_mesopause = 130.0            # [K]
p_mesopause = 0.5              # [Pa]  (0.0005 kPa)

# Gravity [m / s^2]                                (reference constants.py:45)
G = 9.8

# Radius of earth [m]                              (reference constants.py:48)
radius = 6.3781e6

# Dynamic viscosity of dry air at STP [Pa s]       (reference constants.py:51)
mu_air = 18.5e-6

# Dimension conventions for state arrays [k, j, i] (reference constants.py:54-56)
x_dim = -1  # i / longitude
y_dim = -2  # j / latitude
z_dim = -3  # k / sigma layer

# Solar constant [W / m^2]                         (reference constants.py:59)
solar_constant = 1360.8

# Molar masses [kg / mol]                          (reference constants.py:62-68)
M_ozone = 48.00e-3
M_water = 18.016e-3
M_CO2 = 44.010e-3

# Stefan-Boltzmann constant [W / (m^2 K^4)]        (reference constants.py:71)
sb_constant = 5.67e-8

# Latent heat of vaporization of water [J / kg]    (reference constants.py:74-75)
lhv_water_0c = 2.50e6
lhv_water_100c = 2.25e6

# Gas constant for water vapor [J / (K kg)]        (reference constants.py:78)
Rv = 461.0

# Seconds in a day [s] (used by the Coriolis term, reference dynamics.py:87)
seconds_per_day = 86400.0

# Earth's angular velocity [rad / s]
earth_omega = 2.0 * math.pi / seconds_per_day
