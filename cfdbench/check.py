"""The comparison that decides `correct`.

The port's first call of the cell's entry (run_batched's graph, or run)
goes from the benchmark's initial state through K cycles; the reference
(reference/, float64) runs the same K cycles from the same state. Under
the M6 variant the edge weights are damped by 5e-8, so a cycle moves
density, x-momentum and energy by about 1e-7 of their size: below a
float32 spacing, so no float32 run can hold those changes, and the state
or the RMS as a whole cannot tell a cycle that did its flux from one that
did none. The numbers compared are those a float32 run does resolve:

  dq_l0_yz   level 0's transverse momenta (y, z), which the initial state
             keeps near 0: their change over the K cycles against the
             reference's, relative (L2) to the reference's change. It
             carries the internal, boundary and wall flux (pressure enters
             them from every variable), the step factor, the RK update and
             the prolonged coarse correction.
  res_l0_yz  the same channels of level 0's last residual (new - old of
             its last visit), relative to the reference's.
  dq_coarse  every coarser level's state (all variables), the largest of
             |program - reference| relative (L2) to the reference's change
             from the initial state: the restriction's means and the
             coarse visits.
  rms_self   the last cycle's RMS as the port reported it, against the
             plain RMS of the level-0 residual the port returned.

Undamped (the fvcorr variant), a cycle moves every variable by far more
than a float32 spacing, and one more number is compared where the
configuration gives it a limit:

  dq_l0      level 0's whole state: each variable's change over the K
             cycles against the reference's, relative (L2) to the
             reference's change, the largest of the five; so a fault
             confined to density, x-momentum or energy fails it too.

Each is a ratio whose limit is set in the configuration file from the
readings of sound runs (the lower) and of the control (the port's
bfloat16 path, the upper); PERF.md gives both.
"""
from __future__ import annotations

import numpy as np

NAMES = ("dq_l0_yz", "res_l0_yz", "dq_coarse", "rms_self")
# compared only where the configuration's limits name it
OPTIONAL = ("dq_l0",)


def _rel(x, ref) -> float:
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def readings(s0: dict, prog: dict, ref: dict) -> dict:
    """s0, prog, ref: {"variables": [(N, 5)], "residuals": [(N, 5)]} per
    level (float64 numpy), prog and ref also "rms" (one value a cycle)."""
    v0 = s0["variables"]
    vp, vr = prog["variables"], ref["variables"]
    yz = slice(2, 4)
    out = {
        "dq_l0_yz": _rel(vp[0][:, yz] - v0[0][:, yz],
                         vr[0][:, yz] - v0[0][:, yz]),
        "dq_l0": max(_rel(vp[0][:, v] - v0[0][:, v],
                          vr[0][:, v] - v0[0][:, v]) for v in range(5)),
        "res_l0_yz": _rel(prog["residuals"][0][:, yz],
                          ref["residuals"][0][:, yz]),
        "dq_coarse": max((float(np.linalg.norm(vp[i] - vr[i])
                                / np.linalg.norm(vr[i] - v0[i]))
                          for i in range(1, len(vr))), default=0.0),
    }
    r0 = prog["residuals"][0]
    plain = float(np.sqrt((r0 * r0).sum() / r0.shape[0]))
    gap = abs(float(prog["rms"][-1]) - plain)
    out["rms_self"] = gap / plain if plain > 0 else (
        0.0 if gap == 0 else float("inf"))
    return out


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): correct when every number
    that limits names is at most its limit (a NaN is not)."""
    checks = {k: {"value": values[k], "limit": limits[k]}
              for k in NAMES + OPTIONAL if k in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
