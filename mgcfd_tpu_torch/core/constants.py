"""Physical constants and mesh variants (reference: src/Base/const.h:8-43,
initialize_far_field_conditions in src/Kernels/cfd_loops.h:85-119)."""
from __future__ import annotations

import enum
import math

import numpy as np

GAMMA = 1.4
NDIM = 3
RK = 3  # Runge-Kutta stages per smoothing pass
FF_MACH = 1.2
DEG_ANGLE_OF_ATTACK = 0.0

# The reference stores 0.2 as a float literal widened to double
# (src/Base/common.h:24); fp64 runs must see the same widened value.
SMOOTHING_COEFFICIENT = float(np.float64(np.float32(0.2)))

VAR_DENSITY = 0
VAR_MOMENTUM = slice(1, 4)
VAR_DENSITY_ENERGY = 4
NVAR = 5


class MeshVariant(enum.Enum):
    """Mesh families; selects the step-factor formula and the edge-weight
    damping (euler3d_cpu_double.cpp:333-352, :388-395)."""

    FVCORR = "fvcorr"
    M6_WING = "m6wing"
    LA_CASCADE = "la_cascade"
    ROTOR_37 = "rotor37"

    @property
    def uses_legacy_step_factor(self) -> bool:
        return self is MeshVariant.FVCORR

    @property
    def ewt_damping_factor(self) -> float | None:
        """Edge-weight damping applied at load (a workaround that delays
        NaN blow-up on these meshes, euler3d_cpu_double.cpp:333-352)."""
        return {
            MeshVariant.M6_WING: 5e-8,
            MeshVariant.LA_CASCADE: 1e-7,
            MeshVariant.ROTOR_37: 2e-7,
        }.get(self)

    @property
    def flips_all_normals(self) -> bool:
        """FVCORR flips every edge normal at read time (Rodinia
        compatibility); the others flip only internal edges (io.cpp:
        117-133)."""
        return self is MeshVariant.FVCORR


def far_field_state(dtype=np.float64):
    """Far-field conserved state (5,) and its flux tensor (3, 5):
    rho=1.4, p=1, Mach 1.2, angle of attack 0. ff_flux[d, v] is the flux
    of conserved variable v in direction d, momentum block oriented
    vel[k]*mom[d] as in the reference's compute_flux_contribution."""
    aoa = (math.pi / 180.0) * DEG_ANGLE_OF_ATTACK
    rho = 1.4
    pressure = 1.0
    sos = math.sqrt(GAMMA * pressure / rho)
    speed = FF_MACH * sos
    vel = np.array([speed * math.cos(aoa), speed * math.sin(aoa), 0.0])
    mom = rho * vel
    energy = rho * (0.5 * speed * speed) + pressure / (GAMMA - 1.0)

    q = np.empty(NVAR)
    q[VAR_DENSITY] = rho
    q[VAR_MOMENTUM] = mom
    q[VAR_DENSITY_ENERGY] = energy

    flux = np.empty((NDIM, NVAR))
    flux[:, VAR_DENSITY] = mom
    for d in range(NDIM):
        for k in range(NDIM):
            flux[d, 1 + k] = vel[k] * mom[d] + (pressure if d == k else 0.0)
    flux[:, VAR_DENSITY_ENERGY] = vel * (energy + pressure)
    return q.astype(dtype), flux.astype(dtype)
