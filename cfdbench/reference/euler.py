"""The MG-CFD V-cycle (warwick-hpsc/MG-CFD-app-plain, euler3d_cpu_double.cpp
main loop) in plain PyTorch, node-major (N, 5) states, at float64.

Per level visit: the step factor (a global min of the local time step,
divided by each node's volume), then 3 RK stages, each the internal-edge
flux (central flux with scalar dissipation), the far-field boundary flux
and the wall flux, accumulated into the nodes, and the update
old + sf / (RK + 1 - j) * flux; the residual is new - old. Per cycle:
levels 0 .. L-1 on the way up, each followed by the restriction (the
mean of the mapped fine nodes; a coarse node with no child keeps its
value), then the prolongation of each coarse residual and the visit of
that level on the way down (level 0 is visited at the next cycle's
start). The RMS is sqrt(sum(r^2) / N) of level 0's residual. The
indirect_rw loop's result is discarded by the app, so it is not here.
"""
from __future__ import annotations

import math

import numpy as np
import torch

GAMMA = 1.4
RK = 3
# the app stores 0.2 as a float literal widened to double
SMOOTHING = float(np.float32(0.2))
# edge-weight damping at load per mesh variant (none for fvcorr)
DAMPING = {"m6wing": 5e-8, "la_cascade": 1e-7, "rotor37": 2e-7}
# edges per block of the flux, so that the temporaries stay small
BLOCK = 1 << 20


def far_field():
    """Free-stream state (5,) and flux tensor (3, 5): rho 1.4, p 1,
    Mach 1.2 along x."""
    rho, p = 1.4, 1.0
    speed = 1.2 * math.sqrt(GAMMA * p / rho)
    vel = np.array([speed, 0.0, 0.0])
    mom = rho * vel
    energy = 0.5 * rho * speed * speed + p / (GAMMA - 1.0)
    q = np.array([rho, *mom, energy])
    flux = np.empty((3, 5))
    flux[:, 0] = mom
    for d in range(3):
        for k in range(3):
            flux[d, 1 + k] = vel[k] * mom[d] + (p if d == k else 0.0)
    flux[:, 4] = vel * (energy + p)
    return q, flux


def primitives(q):
    rho, mom, energy = q[:, 0], q[:, 1:4], q[:, 4]
    vel = mom / rho[:, None]
    speed_sqd = (vel * vel).sum(dim=1)
    pressure = (GAMMA - 1.0) * (energy - 0.5 * rho * speed_sqd)
    sos = torch.sqrt(GAMMA * pressure / rho)
    return vel, pressure, torch.sqrt(speed_sqd), sos


def flux_tensor(q, vel, pressure):
    """F[:, d, v]: flux of variable v in direction d."""
    mom = q[:, 1:4]
    f = torch.empty((q.shape[0], 3, 5), dtype=q.dtype, device=q.device)
    f[:, :, 0] = mom
    f[:, :, 1:4] = mom[:, :, None] * vel[:, None, :]
    idx = torch.arange(3, device=q.device)
    f[:, idx, 1 + idx] += pressure[:, None]
    f[:, :, 4] = vel * (q[:, 4] + pressure)[:, None]
    return f


class _Level:
    def __init__(self, lvl, variant: str, device):
        def t(x, dt=torch.float64):
            return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt)
        factor = DAMPING.get(variant)
        w, bw, ww = lvl.edge_w, lvl.bedge_w, lvl.wedge_w
        if factor is not None:
            d = lvl.coords[lvl.edge_b] - lvl.coords[lvl.edge_a]
            w = w / np.sqrt((d * d).sum(axis=1))[:, None] * factor
            bw, ww = bw * factor, ww * factor
        self.n = lvl.num_nodes
        self.volumes = t(lvl.volumes)
        self.cbrt_volumes = torch.pow(self.volumes, 1.0 / 3.0)
        self.coords = t(lvl.coords)
        self.a, self.b = t(lvl.edge_a, torch.int64), t(lvl.edge_b,
                                                       torch.int64)
        self.w = t(w)
        self.bb, self.bw = t(lvl.bedge_b, torch.int64), t(bw)
        self.wb, self.ww = t(lvl.wedge_b, torch.int64), t(ww)
        self.mapping = None if lvl.mg_mapping is None else \
            t(lvl.mg_mapping, torch.int64)


class ReferenceSolver:
    """The V-cycle of a hierarchy (cfdbench.inputs.level.Hierarchy) from
    a node-major state; run() returns the state after the cycles."""

    def __init__(self, mesh, device="cpu"):
        self.device = torch.device(device)
        self.variant = mesh.variant
        self.levels = [_Level(lv, mesh.variant, self.device)
                       for lv in mesh.levels]
        ff_q, ff_flux = far_field()
        self.ff_flux = torch.as_tensor(ff_flux, device=self.device)

    # -- one level ----------------------------------------------------------
    def fluxes(self, lv: _Level, q):
        out = torch.zeros_like(q)
        for e0 in range(0, lv.a.shape[0], BLOCK):
            a, b = lv.a[e0:e0 + BLOCK], lv.b[e0:e0 + BLOCK]
            w = lv.w[e0:e0 + BLOCK]
            qa, qb = q[a], q[b]
            va, pa, sa, ca = primitives(qa)
            vb, pb, sb, cb = primitives(qb)
            wn = torch.sqrt((w * w).sum(dim=1))
            factor = -wn * (SMOOTHING * 0.5) * (sa + sb + ca + cb)
            central = torch.einsum("ed,edv->ev", w,
                                   flux_tensor(qa, va, pa)
                                   + flux_tensor(qb, vb, pb))
            val = factor[:, None] * (qa - qb) - 0.5 * central
            out.index_add_(0, a, val)
            out.index_add_(0, b, -val)
        _, p, _, _ = primitives(q[lv.bb])
        zero = torch.zeros_like(p)[:, None]
        out.index_add_(0, lv.bb, torch.cat([zero, lv.bw * p[:, None], zero],
                                           dim=1))
        qw = q[lv.wb]
        vw, pw, _, _ = primitives(qw)
        out.index_add_(0, lv.wb, 0.5 * torch.einsum(
            "ed,edv->ev", lv.ww, flux_tensor(qw, vw, pw) + self.ff_flux))
        return out

    def step_factor(self, lv: _Level, q):
        _, _, speed, sos = primitives(q)
        if self.variant == "fvcorr":
            return 0.5 / (torch.sqrt(lv.volumes) * (speed + sos))
        dt = 0.5 * lv.cbrt_volumes / (speed + sos)
        return torch.min(dt) / lv.volumes

    def visit(self, lv: _Level, q):
        old = q
        sf = self.step_factor(lv, q)
        for j in range(RK):
            q = old + (sf / float(RK + 1 - j))[:, None] * self.fluxes(lv, q)
        return q, q - old

    # -- transfers ----------------------------------------------------------
    @staticmethod
    def restrict(fine: _Level, coarse: _Level, vf, vc):
        m = fine.mapping
        n = m.shape[0]
        sums = torch.zeros_like(vc).index_add_(0, m[:n], vf[:n])
        counts = torch.zeros(coarse.n, dtype=vf.dtype,
                             device=vf.device).index_add_(
            0, m[:n], torch.ones(n, dtype=vf.dtype, device=vf.device))
        mapped = counts > 0
        return torch.where(mapped[:, None],
                           sums / counts.clamp(min=1)[:, None], vc)

    @staticmethod
    def prolong(fine: _Level, coarse: _Level, res_c, res_f, vf):
        """vf + res_f - the coarse residual interpolated onto the fine
        nodes: a fine node on its parent takes the parent's residual;
        any other node the inverse-distance mean over its internal edges
        of the residuals of the two ends' parents. Kept from the app: the
        b end's term through a1 uses the distance to a1 but the residual
        of b1 (mg_loops.cpp); a node on no edge takes 0."""
        parent = fine.mapping
        cc, cf = coarse.coords, fine.coords
        on_parent = (cf == cc[parent]).all(dim=1)
        a2, b2 = fine.a, fine.b
        a1, b1 = parent[a2], parent[b2]

        def inv(x):
            return 1.0 / torch.sqrt((x * x).sum(dim=1))
        i_a1a2, i_b1a2 = inv(cf[a2] - cc[a1]), inv(cc[b1] - cf[a2])
        i_b1b2, i_a1b2 = inv(cf[b2] - cc[b1]), inv(cc[a1] - cf[b2])
        live_a = (~on_parent[a2]).to(vf.dtype)
        live_b = (~on_parent[b2]).to(vf.dtype)
        acc = torch.zeros_like(vf)
        acc.index_add_(0, a2, live_a[:, None] * (i_a1a2[:, None] * res_c[a1]
                                                 + i_b1a2[:, None]
                                                 * res_c[b1]))
        acc.index_add_(0, b2, live_b[:, None] * ((i_b1b2 + i_a1b2)[:, None]
                                                 * res_c[b1]))
        wsum = torch.zeros(fine.n, dtype=vf.dtype, device=vf.device)
        wsum.index_add_(0, a2, live_a * (i_a1a2 + i_b1a2))
        wsum.index_add_(0, b2, live_b * (i_b1b2 + i_a1b2))
        interp = torch.where(on_parent[:, None], res_c[parent],
                             acc / torch.where(wsum > 0, wsum,
                                               torch.ones_like(wsum))[:, None])
        return vf + (res_f - interp)

    # -- the cycle ----------------------------------------------------------
    def cycle(self, variables, residuals):
        lv = self.levels
        L = len(lv)
        rms = None

        def visit(i):
            variables[i], residuals[i] = self.visit(lv[i], variables[i])

        for i in range(L - 1):
            visit(i)
            if i == 0:
                rms = self.rms(residuals[0])
            variables[i + 1] = self.restrict(lv[i], lv[i + 1], variables[i],
                                             variables[i + 1])
        visit(L - 1)
        if L == 1:
            rms = self.rms(residuals[0])
        for i in range(L - 2, -1, -1):
            variables[i] = self.prolong(lv[i], lv[i + 1], residuals[i + 1],
                                        residuals[i], variables[i])
            if i > 0:
                visit(i)
        return rms

    def rms(self, res):
        return torch.sqrt((res * res).sum() / res.shape[0])

    def run(self, state: dict, cycles: int) -> dict:
        """state: {"variables": [(N, 5)], "residuals": [(N, 5)]} per
        level, numpy; returns the same after `cycles` cycles (float64
        numpy) and "rms", one value a cycle."""
        def t(x):
            return torch.as_tensor(np.asarray(x, np.float64),
                                   device=self.device)
        variables = [t(v) for v in state["variables"]]
        residuals = [t(r) for r in state["residuals"]]
        rms = [float(self.cycle(variables, residuals)) for _ in
               range(cycles)]
        return {"variables": [v.cpu().numpy() for v in variables],
                "residuals": [r.cpu().numpy() for r in residuals],
                "rms": rms}
