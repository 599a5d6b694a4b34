"""Faults planted in the port's timed path, for the control runs
(control.py) and the tests that show `correct` comes out false:

  unchanged  the level-0 smoothing visit returns its state unchanged;
  half       every visit leaves half of the nodes at their old state;
  altered    the RMS is altered by 1e-3 where it is produced.

(The exchange between chips is not a fault a one-chip cell can have.)
Each patches mgcfd_tpu_torch.solver.solver inside a `with plant(name)`
block; a solver built, and a CUDA graph captured, inside the block runs
the fault.
"""
from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half", "altered")
_VISITS = ("_visit", "_visit_window", "_visit_span")


def _keep_half(v, old, n):
    v = v.clone()
    if v.shape[0] == n:
        v[n // 2:] = old[n // 2:]
    else:
        v[:, n // 2:] = old[:, n // 2:]
    return v


def _wrap_visit(orig, fault):
    def visit(lvl, q, *rest):
        v, res, inv = orig(lvl, q, *rest)
        if fault == "unchanged" and rest[-1] == 0:
            return q, q - q, inv
        if fault == "half":
            v = _keep_half(v, q, lvl.num_nodes)
            return v, v - q, inv
        return v, res, inv
    return visit


@contextlib.contextmanager
def plant(fault: str):
    from mgcfd_tpu_torch.solver import solver as mod
    saved = {k: getattr(mod, k) for k in (*_VISITS, "calc_rms")}
    try:
        if fault in ("unchanged", "half"):
            for k in _VISITS:
                setattr(mod, k, _wrap_visit(saved[k], fault))
        elif fault == "altered":
            orig = saved["calc_rms"]
            mod.calc_rms = lambda res, n=None: orig(res, n) * (1.0 + 1e-3)
        else:
            raise ValueError(f"unknown fault {fault!r}")
        yield
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)
