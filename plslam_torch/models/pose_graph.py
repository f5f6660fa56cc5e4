"""Loop closure, 4-DoF pose-graph optimization and drift correction.

Counterpart of `plslam/models/pose_graph.py` (the reference's
`PoseGraph::addKeyFrame`, `detectLoop`, `optimize4DoF` with
`FourDOFError`/`FourDOFWeightError`, drift composition,
`savePoseGraph`/`loadPoseGraph`, and `KeyFrame::findConnection`).

The problem over per-keyframe (x, y, z, yaw) — pitch and roll frozen from
VIO — is a batched Gauss-Newton over a fixed-capacity [K,4] state on the
graph's device, in float32: per-edge residuals and closed-form jacobians
for all edges at once, a scatter-add into a dense (4K)² Hessian, a damped
Cholesky solve. Sequential edges join each keyframe to up to 5
predecessors; loop edges are Huber-weighted (IRLS); yaw wraps in the
residual. `PoseGraph.optimize` pads the graph to power-of-two node and edge
buckets and solves eagerly. Above `_PCG_THRESHOLD` keyframes the
matrix-free PCG solver takes over. The host bookkeeping (edges, drift, keyframe search,
PnP) is numpy, as in the JAX package; the BRIEF search runs the Hamming
kernel.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from plslam_torch.config import LoopConfig
from plslam_torch.models import keyframe_db as kdb
from plslam_torch.ops import cameras
from plslam_torch.ops.imu import cholesky
from plslam_torch.utils import quat_np as qnp
from plslam_torch.utils import timers
from plslam_torch.utils.device import resolve_device
from plslam_torch.utils.geometry import ypr_to_rot

MAX_EDGES_SEQ = 5
# Above this keyframe capacity the dense (4K)² Hessian gives way to the
# matrix-free PCG solver (the JAX package's threshold).
_PCG_THRESHOLD = 6144


def _rot_ypr(yaw, pitch, roll):
    return ypr_to_rot(torch.stack([yaw, pitch, roll], dim=-1))


def _rot_ypr_np(yaw, pitch=0.0, roll=0.0):
    """Host Rz(y) Ry(p) Rx(r) for the per-keyframe bookkeeping."""
    return qnp.ypr_to_rot(np.stack([np.asarray(yaw, np.float64),
                                    np.asarray(pitch, np.float64),
                                    np.asarray(roll, np.float64)], axis=-1))


def _wrap(a):
    """Angle into [−π, π): a floor modulo, as the JAX `%` (never `fmod`)."""
    return torch.remainder(a + np.pi, 2 * np.pi) - np.pi


def _wrap_np(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def _make_edge_system(pitch, roll, e_i, e_j, e_t, e_yaw, e_w, e_valid, e_loop, yaw_scale=0.1):
    """The per-edge residuals and jacobians of the 4-DoF PGO, for all edges
    at once. Edge k: r_t = R(ψᵢ,θᵢ,φᵢ)ᵀ(p_j − p_i) − t̂, r_ψ = wrap(ψ_j − ψ_i
    − Δψ̂)/yaw_scale, both times w_k·valid_k. The jacobian [E,4,8] over
    (p_i, ψ_i, p_j, ψ_j) is written out (the JAX package takes it by
    `jacfwd`): ∂r_t/∂p_j = Rᵀ = −∂r_t/∂p_i, and with ∂R/∂ψ = S R (S the
    cross product with z), ∂r_t/∂ψ_i = Rᵀ Sᵀ(p_j − p_i) = Rᵀ (d_y, −d_x, 0).

    Returns (all_residuals(xyz, yaw) → [E,4], edge_system(xyz, yaw) →
    (r, J, w) with the Huber IRLS weights w of the loop edges applied)."""
    pitch_i, roll_i = pitch[e_i], roll[e_i]
    scale = (e_w * e_valid)[:, None]
    inv_ys = 1.0 / yaw_scale

    def residuals_at(xyz, yaw):
        xi, xj = xyz[e_i], xyz[e_j]
        yi, yj = yaw[e_i], yaw[e_j]
        R = _rot_ypr(yi, pitch_i, roll_i)
        d = xj - xi
        r_t = (R.transpose(-1, -2) @ d[:, :, None])[:, :, 0] - e_t
        r_y = _wrap(yj - yi - e_yaw) * inv_ys
        return torch.cat([r_t, r_y[:, None]], dim=-1) * e_w[:, None] * e_valid[:, None], R, d

    def all_residuals(xyz, yaw):
        return residuals_at(xyz, yaw)[0]

    def edge_system(xyz, yaw):
        r, R, d = residuals_at(xyz, yaw)
        E = r.shape[0]
        RT = R.transpose(-1, -2)
        sd = torch.stack([d[:, 1], -d[:, 0], torch.zeros_like(d[:, 0])], dim=-1)
        dy = (RT @ sd[:, :, None])[:, :, 0]  # [E,3]
        J = torch.zeros((E, 4, 8), dtype=r.dtype, device=r.device)
        J[:, 0:3, 0:3] = -RT
        J[:, 0:3, 3] = dy
        J[:, 0:3, 4:7] = RT
        J[:, 3, 3] = -inv_ys
        J[:, 3, 7] = inv_ys
        J = J * scale[:, :, None]
        rn2 = torch.sum(r * r, dim=-1)
        hub = torch.where(rn2 > 1.0, 1.0 / torch.sqrt(torch.sqrt(rn2)), torch.ones_like(rn2))
        w = torch.where(e_loop > 0, hub, torch.ones_like(hub))
        return r * w[:, None], J * w[:, None, None], w

    return all_residuals, edge_system


def _gauge_free(node_valid):
    """1 on the free nodes: the valid ones except the first (the gauge anchor)."""
    K = node_valid.shape[0]
    first = torch.argmax(node_valid)
    return node_valid * (torch.arange(K, device=node_valid.device) != first).to(node_valid.dtype)


def _accept(xyz, yaw, lam, xyz_new, yaw_new, cost0, cost1):
    """LM accept/reject: a step is taken only when it lowers the cost (a
    NaN step — a failed factorization — never does)."""
    accept = cost1 < cost0
    xyz = torch.where(accept, xyz_new, xyz)
    yaw = torch.where(accept, yaw_new, yaw)
    lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-8), torch.clamp(lam * 8.0, max=1e2))
    return xyz, yaw, lam


def optimize_4dof(xyz0, yaw0, pitch, roll, node_valid, e_i, e_j, e_t, e_yaw, e_w, e_valid, e_loop,
                  iters: int = 12):
    """Batched GN over [K,4] positions + yaw with dense normal equations (the
    small-graph path). The first valid node is the gauge anchor. Returns
    (xyz [K,3], yaw [K], costs [iters]). Nothing here reads a value back to
    the host, so the call can be recorded as a CUDA graph."""
    K = xyz0.shape[0]
    dtype, dev = xyz0.dtype, xyz0.device
    fm = torch.repeat_interleave(_gauge_free(node_valid), 4)
    all_residuals, edge_system = _make_edge_system(
        pitch, roll, e_i, e_j, e_t, e_yaw, e_w, e_valid, e_loop)
    quad = torch.arange(4, device=dev)
    ri = e_i[:, None] * 4 + quad  # [E,4] rows of each edge's endpoints
    rj = e_j[:, None] * 4 + quad
    n4 = 4 * K
    flat = torch.cat([(a[:, :, None] * n4 + b[:, None, :]).reshape(-1)
                      for a, b in ((ri, ri), (rj, rj), (ri, rj), (rj, ri))])
    rows = torch.cat([ri.reshape(-1), rj.reshape(-1)])
    xyz, yaw = xyz0, yaw0
    lam = torch.full((), 1e-4, dtype=dtype, device=dev)  # no host copy: capturable
    costs = []
    for _ in range(iters):
        r, Jk, w = edge_system(xyz, yaw)
        Ji, Jj = Jk[:, :, 0:4], Jk[:, :, 4:8]
        Hii = torch.einsum("era,erb->eab", Ji, Ji)
        Hjj = torch.einsum("era,erb->eab", Jj, Jj)
        Hij = torch.einsum("era,erb->eab", Ji, Jj)
        H = torch.zeros(n4 * n4, dtype=dtype, device=dev).index_add_(
            0, flat, torch.cat([Hii.reshape(-1), Hjj.reshape(-1), Hij.reshape(-1),
                                Hij.transpose(1, 2).reshape(-1)])).reshape(n4, n4)
        b = torch.zeros(n4, dtype=dtype, device=dev).index_add_(
            0, rows, torch.cat([torch.einsum("era,er->ea", Ji, r).reshape(-1),
                                torch.einsum("era,er->ea", Jj, r).reshape(-1)]))
        sc = fm / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-6))
        Hs = H * sc[:, None] * sc[None, :] + torch.diag(1.0 - fm + lam)
        delta = -torch.cholesky_solve((b * sc)[:, None], cholesky(Hs))[:, 0] * sc
        xyz_new = xyz + delta.reshape(K, 4)[:, 0:3]
        yaw_new = yaw + delta.reshape(K, 4)[:, 3]
        cost0 = torch.sum(r * r)
        r_new = all_residuals(xyz_new, yaw_new) * w[:, None]
        cost1 = torch.sum(r_new * r_new)
        xyz, yaw, lam = _accept(xyz, yaw, lam, xyz_new, yaw_new, cost0, cost1)
        costs.append(cost1)
    return xyz, yaw, torch.stack(costs)


def _linear_recurrence(A, b):
    """x_k = A_k x_{k−1} + b_k for k = 0..K−1 with x_{−1} = 0 (A [K,4,4],
    b [K,4]), by recursive doubling: ⌈log₂ K⌉ batched steps instead of K
    sequential ones."""
    K = A.shape[0]
    d = 1
    while d < K:
        b = torch.cat([b[:d], b[d:] + (A[d:] @ b[:-d, :, None])[:, :, 0]])
        A = torch.cat([A[:d], A[d:] @ A[:-d]])
        d *= 2
    return b


def optimize_4dof_pcg(xyz0, yaw0, pitch, roll, node_valid, e_i, e_j, e_t, e_yaw, e_w, e_valid,
                      e_loop, iters: int = 12, cg_iters: int = 96):
    """Large-capacity 4-DoF PGO: GN with a matrix-free PCG inner solve. The
    Hessian is applied edge by edge (O(E) memory); the preconditioner is
    the block-tridiagonal backbone of the graph (the 1-step sequential
    edges), factored block by block as the JAX package's block-Thomas scan
    does. Its two triangular sweeps, linear recurrences in the 4×4 blocks,
    are solved by recursive doubling (`_linear_recurrence`). Same semantics
    as `optimize_4dof`; returns (xyz [K,3], yaw [K], costs [iters])."""
    K = xyz0.shape[0]
    dtype, dev = xyz0.dtype, xyz0.device
    free = _gauge_free(node_valid)
    fm = free[:, None].expand(K, 4)
    all_residuals, edge_system = _make_edge_system(
        pitch, roll, e_i, e_j, e_t, e_yaw, e_w, e_valid, e_loop)
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    zeros_k4 = torch.zeros((K, 4), dtype=dtype, device=dev)
    zeros_k44 = torch.zeros((K, 4, 4), dtype=dtype, device=dev)
    one_step = (e_j == e_i + 1).to(dtype)
    xyz, yaw = xyz0, yaw0
    lam = torch.full((), 1e-4, dtype=dtype, device=dev)  # no host copy: capturable
    costs = []
    for _ in range(iters):
        r, Jk, w = edge_system(xyz, yaw)
        Ji, Jj = Jk[:, :, 0:4], Jk[:, :, 4:8]
        b = zeros_k4.index_add(0, e_i, torch.einsum("era,er->ea", Ji, r))
        b = b.index_add(0, e_j, torch.einsum("era,er->ea", Jj, r)) * fm
        D = zeros_k44.index_add(0, e_i, torch.einsum("era,erb->eab", Ji, Ji))
        D = D.index_add(0, e_j, torch.einsum("era,erb->eab", Jj, Jj))
        O = zeros_k44.index_add(0, e_i, torch.einsum("era,erb->eab", Ji, Jj)
                                * one_step[:, None, None])
        fi = fm[:, :, None] * fm[:, None, :]
        damp = lam * torch.diagonal(D, dim1=1, dim2=2) * fm
        D = D * fi + torch.diag_embed(1.0 - fm) + torch.diag_embed(damp)
        O = O * (free * torch.roll(free, -1))[:, None, None]
        O = torch.cat([O[:-1], torch.zeros_like(O[-1:])])  # no block K−1 → K
        O_prev = torch.cat([torch.zeros_like(O[:1]), O[:-1]])

        def hvp(v):
            vm = v * fm
            ye = torch.einsum("era,ea->er", Ji, vm[e_i]) + torch.einsum("era,ea->er", Jj, vm[e_j])
            out = zeros_k4.index_add(0, e_i, torch.einsum("era,er->ea", Ji, ye))
            out = out.index_add(0, e_j, torch.einsum("era,er->ea", Jj, ye))
            return out * fm + (1.0 - fm) * v + damp * v

        # S_0 = D_0, S_k = D_k − O_{k−1}ᵀ S_{k−1}⁻¹ O_{k−1}: one 4×4 block at a time
        S_inv, prev = [], torch.zeros((4, 4), dtype=dtype, device=dev)
        for k in range(K):
            Sk = D[k] - O_prev[k].T @ (prev @ O_prev[k])
            prev = torch.linalg.inv_ex(Sk + 1e-9 * eye4)[0]
            S_inv.append(prev)
        S_inv = torch.stack(S_inv)
        A_fwd = -S_inv @ O_prev.transpose(1, 2)  # u_k = S_k⁻¹(v_k − O_{k−1}ᵀ u_{k−1})
        A_bwd = torch.flip(-S_inv @ O, dims=[0])  # z_k = u_k − S_k⁻¹ O_k z_{k+1}

        def msolve(v):
            u = _linear_recurrence(A_fwd, (S_inv @ v[:, :, None])[:, :, 0])
            return torch.flip(_linear_recurrence(A_bwd, torch.flip(u, dims=[0])), dims=[0])

        r0 = -b
        z0 = msolve(r0)
        x, rr, p, rz = torch.zeros_like(r0), r0, z0, torch.sum(r0 * z0)
        for _ in range(cg_iters):
            hp = hvp(p)
            alpha = rz / torch.clamp(torch.sum(p * hp), min=1e-30)
            x = x + alpha * p
            rr = rr - alpha * hp
            z = msolve(rr)
            rz_new = torch.sum(rr * z)
            beta = rz_new / torch.clamp(rz, min=1e-30)
            p = z + beta * p
            rz = rz_new
        xyz_new = xyz + x[:, 0:3]
        yaw_new = yaw + x[:, 3]
        cost0 = torch.sum(r * r)
        r_new = all_residuals(xyz_new, yaw_new) * w[:, None]
        cost1 = torch.sum(r_new * r_new)
        xyz, yaw, lam = _accept(xyz, yaw, lam, xyz_new, yaw_new, cost0, cost1)
        costs.append(cost1)
    return xyz, yaw, torch.stack(costs)


def _pow2_at_least(n):
    return 1 << max(int(n) - 1, 0).bit_length()


class PoseGraph:
    """Host orchestration: keyframe insertion, loop detection, the PGO
    trigger and drift composition (the reference's `PoseGraph`). The
    BRIEF/global descriptors, the Hamming search and the PGO run on
    `device` (the card unless told otherwise)."""

    def __init__(self, cfg: LoopConfig, focal=460.0, R_bc=None, p_bc=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.db = kdb.KeyframeDB(cfg.max_keyframes)
        # body_T_cam (x_b = R_bc x_c + p_bc): PnP recovers a CAMERA pose,
        # loop edges join BODY poses
        self.R_bc = np.eye(3) if R_bc is None else np.asarray(R_bc, np.float64).reshape(3, 3)
        self.p_bc = np.zeros(3) if p_bc is None else np.asarray(p_bc, np.float64)
        K = cfg.max_keyframes
        self.vio_p = np.zeros((K, 3))
        self.vio_q = np.zeros((K, 4))
        self.vio_yaw = np.zeros(K)
        self.opt_p = np.zeros((K, 3))
        self.opt_yaw = np.zeros(K)
        self.pitch = np.zeros(K)
        self.roll = np.zeros(K)
        self.t_kf = np.zeros(K)
        self.n = 0
        self.edges = []  # dicts: i, j, t, yaw, w, loop
        self.r_drift = np.eye(3)
        self.t_drift = np.zeros(3)
        self.yaw_drift = 0.0
        self.loop_count = 0
        self.evict_fallbacks = 0  # capacity evictions refused (misaligned DB)
        self._pending_opt = False
        self.last_match = None  # match_points payload for the estimator
        self.stats = []  # per-candidate outcome of `_find_connection`
        self.base_n = 0  # keyframes [0, base_n) came from a loaded map
        self.keep_images = False  # keep each keyframe's image (the match_image dump)
        # host milliseconds: "add_keyframe" (the whole call), "features"
        # (its corners and descriptors), "find_connection" (PnP apart),
        # "pnp", and "optimize" as (K, E, ms)
        self.times = {"add_keyframe": [], "features": [], "find_connection": [], "pnp": [],
                      "optimize": []}

    # ------------------------------------------------------------- keyframes
    def _seq_edges(self, k):
        """Sequential edges into keyframe k from up to 5 predecessors,
        measured from VIO poses only, never across the loaded-map boundary."""
        out = []
        for back in range(1, MAX_EDGES_SEQ + 1):
            i = k - back
            if i < self.base_n:
                break
            Ri = _rot_ypr_np(self.vio_yaw[i], self.pitch[i], self.roll[i])
            rel_t = Ri.T @ (self.vio_p[k] - self.vio_p[i])
            rel_yaw = self.vio_yaw[k] - self.vio_yaw[i]
            out.append(dict(i=i, j=k, t=rel_t, yaw=rel_yaw, w=1.0 if back == 1 else 0.6, loop=0))
        return out

    def add_keyframe(self, t, p_w, q_w, img=None, win_uv=None, win_pts3d=None, cam=None,
                     win_ids=None):
        """`addKeyFrame(cur_kf, detect_loop=1)`. p/q: the VIO body pose.
        img: float [0,1] grayscale image (host array or tensor) for BRIEF;
        without one, no loop detection. win_uv/win_pts3d/win_ids: the
        estimator's window points at this keyframe (pixels, world 3D, global
        feature ids). Returns the accepted loop edge or None."""
        with timers.span("pose_graph.add_keyframe"):
            t0 = time.perf_counter()
            if self.n >= self.cfg.max_keyframes and not self._evict_for_capacity():
                return None
            k = self.n
            self.vio_p[k] = p_w
            self.vio_q[k] = q_w
            ypr = qnp.rot_to_ypr(qnp.quat_to_rot(np.asarray(q_w, np.float64)))
            self.vio_yaw[k] = ypr[0]
            self.pitch[k] = ypr[1]
            self.roll[k] = ypr[2]
            # new nodes enter in the drift-corrected frame of their optimized predecessors
            self.opt_yaw[k] = ypr[0] + self.yaw_drift
            self.opt_p[k] = self.r_drift @ np.asarray(p_w, np.float64) + self.t_drift
            self.t_kf[k] = t
            self.n += 1
            self.edges.extend(self._seq_edges(k))

            loop = None
            self.last_match = None
            if img is not None:
                with timers.span("pose_graph.features"):
                    tf = time.perf_counter()
                    img_t = torch.as_tensor(img, dtype=torch.float32).to(self.device)
                    # the window-point payload is capped at the BRIEF slot budget
                    nmax = kdb.MAX_KP // 2
                    if win_uv is not None and len(win_uv) > nmax:
                        win_uv = win_uv[:nmax]
                        win_ids = win_ids[:nmax] if win_ids is not None else None
                        win_pts3d = win_pts3d[:nmax] if win_pts3d is not None else None
                    uv, valid, desc, gdesc = kdb.extract_keyframe_features(img_t,
                                                                           extra_uv=win_uv)
                    win_desc = None
                    if win_uv is not None and len(win_uv):  # `computeWindowBRIEFPoint`
                        cnt = len(win_uv)
                        buf = np.zeros((nmax, 2), np.float32)
                        buf[:cnt] = np.asarray(win_uv, np.float32)
                        wv = np.zeros((nmax,), np.float32)
                        wv[:cnt] = 1.0
                        wd, _ = kdb.brief_descriptors(img_t,
                                                      torch.as_tensor(buf, device=self.device),
                                                      torch.as_tensor(wv, device=self.device))
                        win_desc = kdb.desc_words(wd)[:cnt]
                    self.times["features"].append(1e3 * (time.perf_counter() - tf))
                    entry = dict(uv=uv, valid=valid, desc=desc, cam=cam,
                                 win_uv=win_uv, win_ids=win_ids, win_pts3d=win_pts3d,
                                 win_desc=win_desc, img_shape=tuple(img_t.shape),
                                 img=(np.asarray(img.cpu() if torch.is_tensor(img) else img,
                                                 np.float32) if self.keep_images else None))
                with timers.span("pose_graph.query"):
                    old = self.db.query(gdesc, exclude_last=self.cfg.min_loop_gap,
                                        min_score=self.cfg.loop_min_score,
                                        always_include=self.base_n,
                                        consistency=self.cfg.loop_consistency,
                                        consistency_gap=self.cfg.consistency_gap)
                    self.db.add(entry, gdesc)
                if old is not None:
                    # geometric disambiguation over the strong candidates, oldest first
                    for cand in (self.db.last_candidates or [old]):
                        loop = self._find_connection(cand, k, entry)
                        if loop is not None:
                            break
                    if loop is not None:
                        timers.count("pose_graph.loop")
                        self.edges.append(loop)
                        self.loop_count += 1
                        self._pending_opt = True
            self.times["add_keyframe"].append(1e3 * (time.perf_counter() - t0))
            return loop

    def _evict_for_capacity(self) -> bool:
        """At capacity, evict every other OLD keyframe that is not in the
        loaded map, not a loop-edge endpoint, not the gauge anchor and not in
        the newest quarter; remap indices, keep loop and map-internal edges,
        rebuild the sequential edges from the stored VIO poses. Returns False
        when nothing is evictable."""
        n = self.n
        loop_nodes = set()
        for e in self.edges:
            if e["loop"]:
                loop_nodes.add(e["i"])
                loop_nodes.add(e["j"])
        protect_from = max(self.base_n, n - max(n // 4, 1))
        evict = set(k for k in range(max(self.base_n, 1), protect_from) if k not in loop_nodes)
        evict = set(sorted(evict)[::2])
        if not evict:
            return False
        # a DB misaligned with the keyframe list cannot be remapped: drop new
        # keyframes instead, loudly
        if self.db.n not in (0, n):
            self.evict_fallbacks += 1
            warnings.warn(
                f"pose graph at capacity with a misaligned keyframe DB "
                f"(db.n={self.db.n} != n={n}): cannot evict safely — new "
                f"keyframes are DROPPED and loop closure degrades. Add "
                f"keyframes uniformly with or without imagery.",
                RuntimeWarning, stacklevel=3)
            return False
        keep = [k for k in range(n) if k not in evict]
        remap = {old: new for new, old in enumerate(keep)}
        for name in ("vio_p", "vio_q", "vio_yaw", "opt_p", "opt_yaw", "pitch", "roll", "t_kf"):
            arr = getattr(self, name)
            arr[: len(keep)] = arr[keep]
        if self.db.n == n:
            self.db.gdescs[: len(keep)] = self.db.gdescs[keep]
            self.db.entries = [self.db.entries[k] for k in keep]
            self.db.n = len(keep)
            self.db.recent = []  # candidate indices shifted; restart the chain
        self.n = len(keep)
        new_edges = [{**e, "i": remap[e["i"]], "j": remap[e["j"]]} for e in self.edges
                     if e["loop"] or (e["i"] < self.base_n and e["j"] < self.base_n)]
        for k in range(1, self.n):
            new_edges.extend(self._seq_edges(k))
        self.edges = new_edges
        return True

    def _desc_on_device(self, entry, key):
        """An entry's descriptor words as an int32 tensor on the graph's
        device, uploaded once and kept with the entry."""
        dev_key = "_" + key + "_dev"
        if entry.get(dev_key) is None:
            entry[dev_key] = kdb.desc_tensor(entry[key], self.device)
        return entry[dev_key]

    def _find_connection(self, old_idx, cur_idx, cur_entry):
        """`KeyFrame::findConnection`: the current keyframe's window points
        match by BRIEF (Hamming < thresh, through the Hamming kernel on the
        card) into the old keyframe's corners; PnP RANSAC on (current world
        3D ↔ old normalized 2D) recovers the old keyframe's pose in the
        current world → a loop edge, and `last_match` for the estimator's
        relocalization."""
        with timers.span("pose_graph.connect"):
            timers.count("pose_graph.candidate")
            return self._connect(old_idx, cur_idx, cur_entry)

    def _connect(self, old_idx, cur_idx, cur_entry):
        t0 = time.perf_counter()
        pnp_ms = None  # stays None for candidates that never reach PnP
        old = self.db.entries[old_idx]
        rec = dict(i=old_idx, j=cur_idx, matches=0, inliers=0, outcome="")
        self.stats.append(rec)
        try:
            if cur_entry.get("win_desc") is None or cur_entry.get("win_pts3d") is None:
                rec["outcome"] = "no_window_points"
                return None
            cam = cur_entry.get("cam") or old.get("cam")
            if cam is None or old.get("desc") is None:
                rec["outcome"] = "no_descriptors"
                return None
            with timers.span("pose_graph.search"):
                timers.count("host_wait")  # the distances
                dist = kdb.hamming_matrix(self._desc_on_device(cur_entry, "win_desc"),
                                          self._desc_on_device(old, "desc")).cpu().numpy()
                dist[:, ~np.asarray(old["valid"], bool)] = 999
                best = dist.argmin(axis=1)
                bestd = dist.min(axis=1)
                good = bestd < self.cfg.desc_hamming_thresh
                rec["matches"] = int(good.sum())
                if good.sum() < 8:
                    rec["outcome"] = "few_matches"
                    return None
                pts3d = np.asarray(cur_entry["win_pts3d"])[good]
                uv_old = np.asarray(old["uv"])[best[good]]
                cam_dev = cam[0].device
                timers.count("host_wait")  # the lifted points
                norm_old = cameras.lift(cam, torch.as_tensor(uv_old, dtype=torch.float32,
                                                             device=cam_dev)).cpu().numpy()
                norm_old = norm_old.astype(np.float64)
            # reprojection gate = 10 px in this camera, in normalized units
            fx = float(cam.fx)
            tp = time.perf_counter()
            with timers.span("pose_graph.pnp"):
                out = kdb.pnp_ransac(pts3d, norm_old, thresh=10.0 / fx,
                                     min_inliers=self.cfg.min_pnp_inliers, return_best=True)
            pnp_ms = 1e3 * (time.perf_counter() - tp)
            if out is None:
                rec["outcome"] = "pnp_failed"
                return None
            R_cw, t_cw, inl = out
            rec["inliers"] = int(np.sum(inl))
            if int(np.sum(inl)) < self.cfg.min_pnp_inliers:
                rec["outcome"] = "pnp_failed"
                return None
            # the old keyframe's camera pose in the current world, then its body pose
            R_wc = R_cw.T
            p_wc = -R_cw.T @ t_cw
            R_w_old = R_wc @ self.R_bc.T
            p_w_old = p_wc - R_w_old @ self.p_bc
            i, j = old_idx, cur_idx
            rel_t = R_w_old.T @ (self.vio_p[j] - p_w_old)
            yaw_old = float(qnp.rot_to_ypr(R_w_old)[0])
            rel_yaw = self.vio_yaw[j] - yaw_old
            if abs(_wrap_np(rel_yaw - (self.opt_yaw[j] - self.opt_yaw[i]))) > np.deg2rad(
                    self.cfg.max_loop_yaw_deg):
                rec["outcome"] = "yaw_gate"
                return None
            if np.linalg.norm(rel_t) > self.cfg.max_loop_translation:
                rec["outcome"] = "translation_gate"
                return None
            rec["outcome"] = "accepted"
            # match_points for the estimator: current-window feature ids and
            # their normalized observations in the OLD camera
            ids = np.asarray(cur_entry["win_ids"]) if cur_entry.get("win_ids") is not None else None
            if ids is not None:
                sel = np.nonzero(good)[0][inl]
                win_uv = cur_entry.get("win_uv")
                self.last_match = dict(
                    ids=ids[sel], obs_old=norm_old[inl], p_old=p_w_old,
                    q_old=qnp.rot_to_quat(R_w_old), old_idx=i, cur_idx=j,
                    # pixels and the old image for the `match_image` dump
                    uv_cur=np.asarray(win_uv)[sel] if win_uv is not None else None,
                    uv_old=uv_old[inl], old_img=old.get("img"))
            return dict(i=i, j=j, t=rel_t, yaw=rel_yaw, w=2.0, loop=1)
        finally:
            ms = 1e3 * (time.perf_counter() - t0)
            if pnp_ms is not None:
                self.times["pnp"].append(pnp_ms)
                ms -= pnp_ms
            self.times["find_connection"].append(ms)

    def update_loop_edge(self, old_idx, cur_idx, p_w_old, q_w_old):
        """Replace the raw PnP measurement of loop edge (old_idx, cur_idx)
        with the old keyframe's BA-refined body pose from the estimator's
        joint relo solve (`updateKeyFrameLoop`), behind the same sanity gates
        as `_find_connection`. Returns True when the edge was updated (a PGO
        re-run is then pending)."""
        R_w_old = qnp.quat_to_rot(np.asarray(q_w_old, np.float64))
        rel_t = R_w_old.T @ (self.vio_p[cur_idx] - np.asarray(p_w_old, np.float64))
        yaw_old = float(qnp.rot_to_ypr(R_w_old)[0])
        rel_yaw = self.vio_yaw[cur_idx] - yaw_old
        dy = _wrap_np(rel_yaw - (self.opt_yaw[cur_idx] - self.opt_yaw[old_idx]))
        if abs(dy) > np.deg2rad(self.cfg.max_loop_yaw_deg):
            return False
        if np.linalg.norm(rel_t) > self.cfg.max_loop_translation:
            return False
        for e in self.edges:
            if e["loop"] and e["i"] == old_idx and e["j"] == cur_idx:
                e.setdefault("t_pnp", e["t"])  # the raw PnP measurement stays for diagnostics
                e.setdefault("yaw_pnp", e["yaw"])
                e["t"] = rel_t
                e["yaw"] = rel_yaw
                self._pending_opt = True
                return True
        return False

    def fast_relocalize(self, edge):
        """`fast_relocalization`: on a confirmed loop into the loaded map,
        shift the drift from that one edge at once, without the full PGO."""
        i, j = edge["i"], edge["j"]
        Ri = _rot_ypr_np(self.opt_yaw[i], self.pitch[i], self.roll[i])
        p_j_map = self.opt_p[i] + Ri @ np.asarray(edge["t"])
        yaw_j_map = self.opt_yaw[i] + edge["yaw"]
        self.yaw_drift = yaw_j_map - self.vio_yaw[j]
        Rz = _rot_ypr_np(self.yaw_drift)
        self.r_drift = Rz
        self.t_drift = p_j_map - Rz @ self.vio_p[j]
        self.opt_p[j] = p_j_map
        self.opt_yaw[j] = yaw_j_map

    # ------------------------------------------------------------------- PGO
    def pgo_inputs(self, K, Ep):
        """The graph as the solvers' float32 tensors on the graph's device,
        K node slots and Ep edge slots (both masked past the live graph)."""
        e_i = np.zeros(Ep, np.int64)
        e_j = np.zeros(Ep, np.int64)
        e_t = np.zeros((Ep, 3))
        e_yaw = np.zeros(Ep)
        e_w = np.zeros(Ep)
        e_loop = np.zeros(Ep)
        e_valid = np.zeros(Ep)
        for m, e in enumerate(self.edges):
            e_i[m], e_j[m] = e["i"], e["j"]
            e_t[m] = e["t"]
            e_yaw[m] = e["yaw"]
            e_w[m] = e["w"]
            e_loop[m] = e["loop"]
            e_valid[m] = 1.0
        node_valid = np.zeros(K)
        node_valid[: self.n] = 1.0
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)  # noqa: E731
        idx = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        return (f32(self.opt_p[:K]), f32(self.opt_yaw[:K]), f32(self.pitch[:K]),
                f32(self.roll[:K]), f32(node_valid), idx(e_i), idx(e_j), f32(e_t), f32(e_yaw),
                f32(e_w), f32(e_valid), f32(e_loop))

    def optimize(self, iters=12):
        """`optimize4DoF` + drift update. Node and edge arrays are padded to
        the next power of two of the live graph (nodes at least 64, at most
        the capacity), as the reference pads them for its compiled shapes.
        The solve runs in float32, eagerly: a CUDA graph per (K, Ep) bucket
        showed no gain over the loop scene's runs, its recordings costing
        what its replays saved (`chip_smoke.py` phase 6 times both). Above `_PCG_THRESHOLD`
        node slots the PCG solver runs instead."""
        if self.n < 2 or not self.edges:
            return
        with timers.span("pose_graph.optimize"):
            t0 = time.perf_counter()
            with timers.span("pose_graph.pgo_pack"):
                K = min(self.cfg.max_keyframes, max(64, _pow2_at_least(self.n)))
                Ep = _pow2_at_least(len(self.edges))
                args = self.pgo_inputs(K, Ep)
            with timers.span("pose_graph.pgo_solve"):
                solve = optimize_4dof if K < _PCG_THRESHOLD else optimize_4dof_pcg
                xyz, yaw, _ = solve(*args, iters=iters)
            with timers.span("pose_graph.pgo_wait"):
                timers.count("host_wait", 2)  # positions and yaws
                self.opt_p[: self.n] = xyz.cpu().numpy()[: self.n]
                self.opt_yaw[: self.n] = yaw.cpu().numpy()[: self.n]
            # drift: the last keyframe optimized vs VIO
            k = self.n - 1
            self.yaw_drift = self.opt_yaw[k] - self.vio_yaw[k]
            Rz = _rot_ypr_np(self.yaw_drift)
            self.r_drift = Rz
            self.t_drift = self.opt_p[k] - Rz @ self.vio_p[k]
            self._pending_opt = False
            self.times["optimize"].append((K, len(self.edges), 1e3 * (time.perf_counter() - t0)))

    def correct(self, p_vio, q_vio):
        """Apply the current drift to a live VIO pose (`updatePath` output)."""
        p = self.r_drift @ np.asarray(p_vio) + self.t_drift
        q = qnp.quat_mul(qnp.rot_to_quat(self.r_drift), np.asarray(q_vio, np.float64))
        return p, q

    # --------------------------------------------------------------- save/load
    def save(self, path):
        """`savePoseGraph`: an npz of arrays only, key for key the JAX
        package's format (descriptors as uint32 words, the camera as
        `cam_to_params`), so that either package loads the other's map."""
        n = self.n
        ents = (self.db.entries + [{}] * n)[:n]
        cam = next((e.get("cam") for e in ents if e.get("cam") is not None), None)

        def stack(key, shape, dtype):
            out = np.zeros((n,) + shape, dtype)
            for k, e in enumerate(ents):
                v = e.get(key)
                if v is not None:
                    out[k] = v
            return out

        w_cnt = np.array([0 if e.get("win_uv") is None else len(e["win_uv"]) for e in ents],
                         np.int64)

        def cat(key, width, dtype):
            parts = [np.asarray(e[key], dtype).reshape(c, width) for e, c in zip(ents, w_cnt) if c]
            return np.concatenate(parts, axis=0) if parts else np.zeros((0, width), dtype)

        kp = kdb.MAX_KP
        kind, params = (0, np.zeros(9)) if cam is None else cameras.cam_to_params(cam)
        np.savez_compressed(
            path,
            n=n, base_n=self.base_n,
            vio_p=self.vio_p[:n], vio_q=self.vio_q[:n], vio_yaw=self.vio_yaw[:n],
            opt_p=self.opt_p[:n], opt_yaw=self.opt_yaw[:n],
            pitch=self.pitch[:n], roll=self.roll[:n],
            t_kf=self.t_kf[:n],
            edges_i=[e["i"] for e in self.edges], edges_j=[e["j"] for e in self.edges],
            edges_t=[e["t"] for e in self.edges], edges_yaw=[e["yaw"] for e in self.edges],
            edges_w=[e["w"] for e in self.edges], edges_loop=[e["loop"] for e in self.edges],
            gdescs=self.db.gdescs[: self.db.n],
            kf_uv=stack("uv", (kp, 2), np.float32),
            kf_valid=stack("valid", (kp,), bool),
            kf_desc=stack("desc", (kp, kdb.N_BRIEF_WORDS), np.uint32),
            win_cnt=w_cnt,
            win_uv=cat("win_uv", 2, np.float64),
            win_ids=cat("win_ids", 1, np.int64),
            win_pts3d=cat("win_pts3d", 3, np.float64),
            win_desc=cat("win_desc", kdb.N_BRIEF_WORDS, np.uint32),
            cam_kind=kind, cam_params=params, has_cam=cam is not None,
        )

    def load(self, path):
        """`loadPoseGraph`: restore the map. Keyframes added afterwards are a
        new session: sequential edges never bridge the map → session gap, and
        a loop edge into the map relocalizes the session."""
        z = np.load(path, allow_pickle=True)
        n = int(z["n"])
        self.n = n
        self.base_n = n
        self.vio_p[:n] = z["vio_p"]
        self.vio_q[:n] = z["vio_q"]
        if "vio_yaw" in z.files:
            self.vio_yaw[:n] = z["vio_yaw"]
        else:  # maps saved before vio_yaw was kept: derive it from vio_q
            self.vio_yaw[:n] = [float(qnp.rot_to_ypr(qnp.quat_to_rot(q))[0]) for q in z["vio_q"]]
        self.opt_p[:n] = z["opt_p"]
        self.opt_yaw[:n] = z["opt_yaw"]
        self.pitch[:n] = z["pitch"]
        self.roll[:n] = z["roll"]
        self.t_kf[:n] = z["t_kf"]
        self.edges = [
            dict(i=int(i), j=int(j), t=np.asarray(t), yaw=float(y), w=float(w), loop=int(lp))
            for i, j, t, y, w, lp in zip(z["edges_i"], z["edges_j"], z["edges_t"],
                                         z["edges_yaw"], z["edges_w"], z["edges_loop"])
        ]
        self.db.gdescs[: len(z["gdescs"])] = z["gdescs"]
        self.db.n = len(z["gdescs"])
        cam = None
        if bool(z["has_cam"]):
            kind = int(z["cam_kind"]) if "cam_kind" in z.files else 0
            cam = cameras.cam_from_params(kind, np.asarray(z["cam_params"], np.float64))
        w_cnt = z["win_cnt"]
        w_off = np.concatenate([[0], np.cumsum(w_cnt)])
        self.db.entries = []
        for k in range(n):
            lo, hi = int(w_off[k]), int(w_off[k + 1])
            self.db.entries.append(dict(
                uv=z["kf_uv"][k], valid=z["kf_valid"][k], desc=z["kf_desc"][k], cam=cam,
                win_uv=z["win_uv"][lo:hi] if hi > lo else None,
                win_ids=z["win_ids"][lo:hi, 0] if hi > lo else None,
                win_pts3d=z["win_pts3d"][lo:hi] if hi > lo else None,
                win_desc=z["win_desc"][lo:hi] if hi > lo else None,
            ))
