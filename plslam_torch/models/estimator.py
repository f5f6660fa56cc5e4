"""Sliding-window visual-inertial estimator — the central state machine.

Counterpart of `plslam/models/estimator.py` (the reference's
`Estimator::processIMU/processImage`, `solveOdometry`, `slideWindow`,
`failureDetection`, `clearState`).

Split of responsibilities:
  host (numpy): feature-table surgery, keyframe decision, window shifting,
    IMU buffering and dead-reckoning.
  device (torch on `device`): preintegration, triangulation, the LM/Schur
    window solve and marginalization, run by `backend_tick` with ONE packed
    readback per frame.

`defer_solve=True` queues the backend work and starts the bundle's copy to
pinned host memory without waiting for it; `finalize()` (called by the next
`process_frame` / `latest_pose` / `window_points`) completes the frame.
Results are identical with and without deferral: IMU samples that arrive
in between are re-dead-reckoned onto the solved state.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from plslam_torch.models.feature_table import LineTable, PointTable
from plslam_torch.config import PLSlamConfig
from plslam_torch.models import marginalization as marg
from plslam_torch.models import residuals as res
from plslam_torch.models import solver as solver_mod
from plslam_torch.models import triangulate
from plslam_torch.models.state import WindowState, cam_poses, layout, zero_state
from plslam_torch.ops import imu as imu_ops
from plslam_torch.utils import cuda_graph
from plslam_torch.utils import quat_np as qnp
from plslam_torch.utils import timers
from plslam_torch.utils.device import HostCopy, astensor, resolve_device
from plslam_torch.utils.geometry import rot_to_quat

MARGIN_OLD = 0
MARGIN_SECOND_NEW = 1
IMU_PAD = 512  # max IMU samples per (possibly merged) keyframe interval
_PRE_KEYS = ("alpha", "beta", "gamma", "jac", "sqrt_info", "dt_sum", "ba", "bg")


class ImuBuffer:
    """Samples of one keyframe interval, including the boundary sample of the
    previous interval (the reference's `IntegrationBase` ctor + push_back)."""

    def __init__(self):
        self.acc: list = []
        self.gyr: list = []
        self.dt: list = []  # len == len(acc) - 1 once seeded

    @property
    def seeded(self):
        return len(self.acc) > 0

    def seed(self, acc, gyr):
        self.acc = [np.asarray(acc, np.float64)]
        self.gyr = [np.asarray(gyr, np.float64)]
        self.dt = []

    def append(self, acc, gyr, dt):
        self.acc.append(np.asarray(acc, np.float64))
        self.gyr.append(np.asarray(gyr, np.float64))
        self.dt.append(float(dt))

    @staticmethod
    def merged(a: "ImuBuffer", b: "ImuBuffer") -> "ImuBuffer":
        if not a.seeded:
            return b
        m = ImuBuffer()
        m.acc = a.acc + b.acc[1:]
        m.gyr = a.gyr + b.gyr[1:]
        m.dt = a.dt + b.dt
        return m

    def padded(self, dtype, device):
        """Fixed-shape (acc [P+1,3], gyr [P+1,3], dt [P]) tensors; padded
        steps have dt = 0, an exact identity of the preintegration."""
        n = min(len(self.dt), IMU_PAD)
        acc = np.zeros((IMU_PAD + 1, 3))
        gyr = np.zeros((IMU_PAD + 1, 3))
        dts = np.zeros(IMU_PAD)
        if n > 0:
            acc[: n + 1] = np.stack(self.acc[: n + 1])
            gyr[: n + 1] = np.stack(self.gyr[: n + 1])
            acc[n + 1:] = acc[n]
            gyr[n + 1:] = gyr[n]
            dts[:n] = self.dt[:n]
        return (astensor(acc, dtype, device), astensor(gyr, dtype, device),
                astensor(dts, dtype, device))


def preintegrate_padded(buf: ImuBuffer, ba, bg, noise, dtype, device) -> dict:
    """Preintegrate one interval buffer; returns the factor-side fields."""
    acc, gyr, dts = buf.padded(dtype, device)
    pre = imu_ops.preintegrate(acc, gyr, dts, astensor(ba, dtype, device),
                               astensor(bg, dtype, device), noise)
    return {"alpha": pre.alpha, "beta": pre.beta, "gamma": pre.gamma, "jac": pre.jac,
            "sqrt_info": imu_ops.sqrt_info_from_cov(pre.cov), "dt_sum": pre.dt_sum,
            "ba": pre.ba, "bg": pre.bg}


def stack_pres(pres) -> dict:
    return {k: torch.stack([p[k] for p in pres]) for k in _PRE_KEYS}


class Estimator:
    def __init__(self, config: PLSlamConfig, dtype=None, device=None):
        self.config = config
        self.cfg = config.solver
        self.lay = layout(self.cfg)
        self.device = resolve_device(device)
        self.dtype = dtype or (torch.float64 if self.cfg.dtype == "float64" else torch.float32)
        imu = config.imu
        self.noise = imu_ops.ImuNoise.create(imu.acc_n, imu.gyr_n, imu.acc_w, imu.gyr_w,
                                             dtype=self.dtype, device=self.device)
        self.g = torch.tensor([0.0, 0.0, imu.g_norm], dtype=self.dtype, device=self.device)
        # CUDA graphs of the backend's fixed-shape parts (CUDA devices only)
        self._graphs = {} if self.device.type == "cuda" else None
        self.clear_state()

    # ------------------------------------------------------------- state mgmt
    def clear_state(self):
        """`Estimator::clearState()` — full re-initialization."""
        nw = self.cfg.window_size + 1
        self.frame_count = 0  # slot index the NEXT frame occupies (0..nw-1)
        self.initialized = False
        self.timestamps = np.zeros(nw)
        self.td_pair = np.zeros(nw)  # per-slot IMU-pairing td (factor td_i)
        self.p = np.zeros((nw, 3))
        self.q = np.tile([1.0, 0, 0, 0], (nw, 1)).astype(np.float64)
        self.v = np.zeros((nw, 3))
        self.ba = np.zeros((nw, 3))
        self.bg = np.zeros((nw, 3))
        ext = self.config.extrinsic
        R_bc = torch.tensor(np.asarray(ext.rot, np.float64).reshape(3, 3))
        self.q_bc = rot_to_quat(R_bc).numpy().copy()
        self.p_bc = np.array(ext.trans, np.float64)
        self.td = float(self.config.temporal.td)
        self.pt_table = PointTable(self.cfg)
        self.ln_table = LineTable(self.cfg)
        self.line_w = np.zeros((self.cfg.max_line_feats, 6))
        self.line_w[:, 1] = 5.0
        self.line_w[:, 5] = 1.0
        # imu_bufs[k] holds samples spanning (frame k-1 → frame k); [0] covers
        # the pre-first-frame samples and is never used as a factor
        self.imu_bufs: list[ImuBuffer] = [ImuBuffer()]
        self.pres: list[Optional[dict]] = [None]
        self.prior: Optional[marg.Prior] = None
        self.last_acc = None
        self.last_gyr = None
        self.solves_since_init = 0
        self._init_bad_solves = 0
        # the observability log persists across failure-triggered re-inits
        self.metrics: list[dict] = getattr(self, "metrics", [])
        self._pending = None  # deferred solve awaiting finalize()
        self._pending_prior = None
        self._kf_snapshot = None
        self.relo: Optional[dict] = None  # pending relocalization frame
        self.relo_result: Optional[dict] = None  # refined relative pose out
        self.ex_calibrated = self.config.extrinsic.estimate_extrinsic != 2
        self._ex_qcam: list = []
        self._ex_qimu: list = []

    def _t(self, x, dtype=None):
        return astensor(x, dtype or self.dtype, self.device)

    # ---------------------------------------------------------------- inputs
    def process_imu(self, dt: float, acc, gyr):
        """`Estimator::processIMU` — buffer the sample and dead-reckon the
        newest state slot (the solver's initial guess)."""
        acc = np.asarray(acc, np.float64)
        gyr = np.asarray(gyr, np.float64)
        first = self.last_acc is None
        buf = self.imu_bufs[-1]
        if not buf.seeded:
            if first:
                buf.seed(acc, gyr)
                self.last_acc, self.last_gyr = acc, gyr
                return
            buf.seed(self.last_acc, self.last_gyr)
        buf.append(acc, gyr, dt)
        k = min(self.frame_count, self.cfg.window_size)
        self._deadreckon_step(k, self.last_acc, self.last_gyr, acc, gyr, dt)
        self.last_acc, self.last_gyr = acc, gyr

    def _deadreckon_step(self, k, acc0, gyr0, acc1, gyr1, dt):
        ba, bg = self.ba[k], self.bg[k]
        g = np.array([0.0, 0.0, self.config.imu.g_norm])
        w_mid = 0.5 * (gyr0 + gyr1) - bg
        q_old = self.q[k].copy()
        q_new = qnp.quat_normalize(qnp.quat_mul(q_old, qnp.quat_exp(w_mid * dt)))
        a0 = qnp.quat_rotate(q_old, acc0 - ba) - g
        a1 = qnp.quat_rotate(q_new, acc1 - ba) - g
        a_mid = 0.5 * (a0 + a1)
        self.p[k] += self.v[k] * dt + 0.5 * a_mid * dt * dt
        self.v[k] += a_mid * dt
        self.q[k] = q_new

    def _replay_open_buffer(self):
        """Re-apply the dead-reckoning of IMU samples that arrived while a
        deferred solve was in flight onto the solved (post-slide) state."""
        buf = self.imu_bufs[-1]
        if not buf.seeded or not buf.dt:
            return
        k = min(self.frame_count, self.cfg.window_size)
        for i, dt in enumerate(buf.dt):
            self._deadreckon_step(k, buf.acc[i], buf.gyr[i], buf.acc[i + 1], buf.gyr[i + 1], dt)

    def preintegrate_buffer(self, buf: ImuBuffer, ba, bg) -> dict:
        return preintegrate_padded(buf, ba, bg, self.noise, self.dtype, self.device)

    def _close_interval(self, k: int):
        """Preintegrate the interval ending at frame slot k."""
        buf = self.imu_bufs[k]
        if len(buf.dt) == 0:
            self.pres[k] = None
            return
        kb = max(k - 1, 0)
        self.pres[k] = self.preintegrate_buffer(buf, self.ba[kb], self.bg[kb])

    # ---------------------------------------------------------------- frames
    def process_frame(self, t: float, pt_ids, pt_obs, pt_vel=None, ln_ids=None, ln_obs=None,
                      oracle_state: Optional[dict] = None, defer_solve: bool = False):
        """`Estimator::processImage`. Returns a per-frame metrics dict.

        oracle_state: optional {p,q,v} ground truth for the newest frame —
        bootstrap mode standing in for `initialStructure()` in tests."""
        self.finalize()
        with timers.span("estimator.process_frame", frame=t):
            fc = min(self.frame_count, self.cfg.window_size)
            # restart handshake: non-monotonic or >1 s gap ⇒ full reset
            last_t = self.timestamps[max(fc - 1, 0)] if self.frame_count > 0 else None
            if last_t is not None and (t < last_t - 1e-9 or t - last_t > 1.0):
                self.clear_state()
                fc = 0
            self.timestamps[fc] = t
            self.td_pair[fc] = self.td
            with timers.span("estimator.preintegrate"):
                self._close_interval(fc)

            with timers.span("estimator.tables"):
                self.pt_table.add_frame(fc, pt_ids, pt_obs, pt_vel)
                if ln_ids is not None and len(ln_ids):
                    self.ln_table.add_frame(fc, ln_ids, ln_obs)

                if not self.ex_calibrated and fc >= 1:
                    self._calibrate_extrinsic_step(fc)

                keyframe = self.pt_table.parallax_keyframe_decision(fc)
                marg_flag = MARGIN_OLD if keyframe else MARGIN_SECOND_NEW
                # a SECOND_NEW merge that would overflow IMU_PAD forces a keyframe
                nw = self.cfg.window_size
                if (marg_flag == MARGIN_SECOND_NEW and self.frame_count >= nw
                        and len(self.imu_bufs[nw - 1].dt) + len(self.imu_bufs[nw].dt) > IMU_PAD):
                    keyframe = True
                    marg_flag = MARGIN_OLD

                if oracle_state is not None and not self.initialized:
                    self.p[fc] = oracle_state["p"]
                    self.q[fc] = oracle_state["q"]
                    self.v[fc] = oracle_state["v"]

                long_tracked = ((self.pt_table.mask[:, fc] > 0)
                                & (np.sum(self.pt_table.mask, axis=1) >= 2))
                m = {"t": t, "frame": fc, "keyframe": bool(keyframe),
                     "tracked": int(self.pt_table.active.sum()),
                     "long_tracked": int(long_tracked.sum())}

                if self.frame_count < self.cfg.window_size:
                    self.frame_count += 1
                    self.imu_bufs.append(ImuBuffer())
                    self.pres.append(None)
                    self.p[self.frame_count] = self.p[self.frame_count - 1]
                    self.q[self.frame_count] = self.q[self.frame_count - 1]
                    self.v[self.frame_count] = self.v[self.frame_count - 1]
                    self.metrics.append(m)
                    return m

            if not self.initialized:
                if oracle_state is not None:
                    self.initialized = True
                    self.solves_since_init = 0
                else:
                    from plslam_torch.models import initializer

                    with timers.span("estimator.initialize"):
                        if self.ex_calibrated and initializer.try_initialize(self):
                            self.initialized = True
                            self.solves_since_init = 0
                        else:
                            self._slide_uninitialized()
                            self.metrics.append(m)
                            return m

            timers.count("estimator.solve")
            bundle, prior, mode = self._dispatch_solve(marg_flag)
            # the next interval's open buffer must exist at dispatch time so that
            # samples arriving before finalize() land in the right interval
            self.imu_bufs.append(ImuBuffer())
            self.pres.append(None)
            # record WHICH relo request (if any) the dispatched bundle solved: a
            # set_relo_frame between dispatch and finalize stays pending
            self._pending = dict(bundle=bundle, prior=prior, mode=mode, marg_flag=marg_flag, m=m,
                                 relo=self.relo)
            if not defer_solve:
                self.finalize()
            return m

    def finalize(self):
        """Complete a deferred `process_frame`: read the solve bundle, apply
        the host-side table surgery / failure detection / window slide, then
        replay the dead-reckoning of samples that arrived meanwhile."""
        if self._pending is None:
            return
        pend, self._pending = self._pending, None
        m = pend["m"]
        with timers.span("estimator.finalize", frame=m["t"]):
            self._pending_prior = pend["prior"] if pend["mode"] != "none" else None
            with timers.span("estimator.wait"):
                b = np.array(pend["bundle"].get()[0], np.float64)
            with timers.span("estimator.finish"):
                m.update(self._finish_solve(b, pend["relo"]))
            self.solves_since_init += 1
            with timers.span("estimator.slide"):
                if self._failure_detection(m):
                    timers.count("estimator.failure")
                    m["failure"] = True
                    self.metrics.append(m)
                    self.clear_state()
                    return
                self._slide(pend["marg_flag"])
                self._replay_open_buffer()
                self.metrics.append(m)

    # ------------------------------------------------- extrinsic calibration
    def _gyro_delta_q(self, fc: int):
        buf = self.imu_bufs[fc] if fc < len(self.imu_bufs) else None
        if buf is None or not buf.seeded or not buf.dt:
            return None
        bg = self.bg[max(fc - 1, 0)]
        q = np.array([1.0, 0.0, 0.0, 0.0])
        for i, dt in enumerate(buf.dt):
            w_mid = 0.5 * (buf.gyr[i] + buf.gyr[i + 1]) - bg
            q = qnp.quat_normalize(qnp.quat_mul(q, qnp.quat_exp(w_mid * dt)))
        return q

    def _calibrate_extrinsic_step(self, fc: int):
        """ESTIMATE_EXTRINSIC=2 live flow (`CalibrationExRotation` per frame)."""
        from plslam_torch.models import initializer as ini

        tbl = self.pt_table
        both = tbl.active & (tbl.mask[:, fc - 1] > 0) & (tbl.mask[:, fc] > 0)
        if both.sum() >= 9:
            out = ini.essential_ransac(tbl.obs[both, fc - 1], tbl.obs[both, fc], iters=60)
            if out is not None:
                R, _, _ = out
                q_cam = qnp.rot_to_quat(R.T)
                q_imu = self._gyro_delta_q(fc)
                if q_imu is not None:
                    self._ex_qcam.append(q_cam)
                    self._ex_qimu.append(q_imu)
        if len(self._ex_qcam) >= self.cfg.window_size:
            q_bc, ok = ini.calibrate_extrinsic_rotation(self._ex_qcam, self._ex_qimu)
            if ok:
                self.q_bc = np.asarray(q_bc, np.float64)
                self.ex_calibrated = True
                self._ex_qcam, self._ex_qimu = [], []

    # --------------------------------------------------------- relocalization
    def set_relo_frame(self, match_ids, match_obs_norm, relo_p, relo_q):
        """`Estimator::setReloFrame`: register an old keyframe's matched
        feature observations (by global feature id, normalized coordinates in
        the old camera) and its pose guess. The next window solve adds relo
        projection factors and refines the old pose jointly; the refined
        relative transform lands in `relo_result`. Returns False (and
        registers nothing) when fewer than 8 matches are in the window."""
        mf = self.cfg.max_features
        obs = np.zeros((mf, 2))
        mask = np.zeros(mf)
        slot_of = {int(i): s for s, i in enumerate(self.pt_table.ids) if i >= 0}
        n = 0
        for fid, ob in zip(match_ids, match_obs_norm):
            s = slot_of.get(int(fid))
            if s is not None:
                obs[s] = ob
                mask[s] = 1.0
                n += 1
        if n < 8:
            return False
        self.relo = dict(obs=obs, mask=mask, p=np.asarray(relo_p, np.float64),
                         q=np.asarray(relo_q, np.float64))
        return True

    def _extract_relo_result(self, p_old, q_old, p_cur, q_cur):
        """Relative pose old keyframe ← newest window frame after the joint
        solve (the reference's `relo_relative_t/q`), from pulled values."""
        q_rel = qnp.quat_mul(qnp.quat_conj(q_old), q_cur)
        t_rel = qnp.quat_rotate(qnp.quat_conj(q_old), p_cur - p_old)
        self.relo_result = dict(t=t_rel, q=q_rel, p_old=p_old, q_old=q_old)

    # ------------------------------------------------------------ device I/O
    def _device_state(self) -> WindowState:
        st = zero_state(self.cfg, self.dtype, self.device)
        return st._replace(
            p=self._t(self.p), q=self._t(self.q), v=self._t(self.v),
            ba=self._t(self.ba), bg=self._t(self.bg),
            p_bc=self._t(self.p_bc), q_bc=self._t(self.q_bc), td=self._t(self.td),
            relo_p=self._t(self.relo["p"] if self.relo else np.zeros(3)),
            relo_q=self._t(self.relo["q"] if self.relo else np.array([1.0, 0, 0, 0])),
            inv_depth=self._t(np.where(self.pt_table.inv_depth > 0, self.pt_table.inv_depth, 0.2)),
            line=self._t(self.line_w),
        )

    def _zero_pre(self):
        dtype, dev = self.dtype, self.device
        return {"alpha": torch.zeros(3, dtype=dtype, device=dev),
                "beta": torch.zeros(3, dtype=dtype, device=dev),
                "gamma": torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=dev),
                "jac": torch.eye(15, dtype=dtype, device=dev),
                "sqrt_info": torch.eye(15, dtype=dtype, device=dev),
                "dt_sum": torch.zeros((), dtype=dtype, device=dev),
                "ba": torch.zeros(3, dtype=dtype, device=dev),
                "bg": torch.zeros(3, dtype=dtype, device=dev)}

    def window_pres(self):
        """(stacked preintegration fields [W,...], validity list) for slots 1..W."""
        zero = self._zero_pre()
        W = self.cfg.window_size
        pres, valid = [], []
        for k in range(1, W + 1):
            pre = self.pres[k] if k < len(self.pres) else None
            pres.append(pre if pre is not None else zero)
            valid.append(pre is not None)
        return stack_pres(pres), valid

    def _factors(self) -> res.WindowFactors:
        f = res.empty_factors(self.cfg, self.lay, self.dtype, self.device)
        stk, valid = self.window_pres()
        f = f._replace(
            imu_alpha=stk["alpha"], imu_beta=stk["beta"], imu_gamma=stk["gamma"],
            imu_jac=stk["jac"], imu_sqrt_info=stk["sqrt_info"], imu_dt=stk["dt_sum"],
            imu_ba=stk["ba"], imu_bg=stk["bg"],
            imu_valid=self._t(np.asarray(valid, np.float64)), g=self.g,
        )
        tbl = self.pt_table
        camc = self.config.camera
        if self.config.temporal.rolling_shutter:
            rowf = np.clip((camc.fy * tbl.obs[..., 1] + camc.cy) / max(camc.image_height, 1), 0.0, 1.0)
            rs_tr = self.config.temporal.rolling_shutter_tr
        else:
            rowf = np.zeros_like(tbl.obs[..., 1])
            rs_tr = 0.0
        f = f._replace(
            pt_obs=self._t(tbl.obs), pt_vel=self._t(tbl.vel), pt_td_ref=self._t(self.td_pair),
            pt_rowf=self._t(rowf), rs_tr=self._t(rs_tr),
            pt_mask=self._t(tbl.mask.astype(np.float64)),
            pt_start=self._t(tbl.start, torch.int64),
            pt_valid=self._t(tbl.used_in_solver().astype(np.float64)),
        )
        ltb = self.ln_table
        f = f._replace(
            ln_obs=self._t(ltb.obs), ln_mask=self._t(ltb.mask.astype(np.float64)),
            ln_valid=self._t(ltb.usable().astype(np.float64)),
            ln_start=self._t(ltb.start, torch.int64),
        )
        # relo factors enter as data (relo_valid 0 or 1), so one recorded
        # CUDA graph of the LM solve serves frames with and without them
        if self.relo is not None:
            f = f._replace(relo_obs=self._t(self.relo["obs"]), relo_mask=self._t(self.relo["mask"]),
                           relo_valid=self._t(1.0))
        if self.prior is not None:
            f = marg.install_prior(f, self.prior)
        return f

    # --------------------------------------------------------------- solving
    def _cam_poses_np(self):
        q_wc = qnp.quat_mul(self.q, self.q_bc[None, :])
        p_wc = self.p + qnp.quat_rotate(self.q, np.broadcast_to(self.p_bc, self.p.shape))
        return p_wc, q_wc

    def _dispatch_solve(self, marg_flag: int):
        """`solveOdometry()` + `optimization()` + outlier gating +
        marginalization, queued on the device with ONE packed readback.
        Returns (readback, prior_device, marg_mode)."""
        with timers.span("estimator.pack"):
            st = self._device_state()
            f = self._factors()
            tbl, ltb = self.pt_table, self.ln_table
            solvable = tbl.solvable()
            tri_need = solvable & (tbl.inv_depth <= 0)
            fb4 = np.sum(tbl.mask, axis=1) >= 4
            ln_active2 = ltb.active & (np.sum(ltb.mask, axis=1) >= 2)
            lneed = ln_active2 & ~ltb.solved
            masks = [self._t(a.astype(np.float64))
                     for a in (solvable, tri_need, fb4, lneed, ln_active2)]
        mode = "old" if marg_flag == MARGIN_OLD else ("new" if self.prior is not None else "none")
        kw = dict(ee=self.config.extrinsic.estimate_extrinsic > 0,
                  etd=self.config.temporal.estimate_td, iters=self.cfg.max_num_iterations)
        with timers.span("estimator.launch"):
            st_out, stats, prior, aux = backend_tick(
                st, f, *masks, self.lay, self.cfg, marg_mode=mode, graphs=self._graphs, **kw)
            with timers.span("backend.gating"):
                bundle = HostCopy(pack_bundle(st_out, stats, aux))
        return bundle, prior, mode

    def _finish_solve(self, b: np.ndarray, dispatched_relo=None) -> dict:
        if b[-1] > 0:  # the flag that `backend_tick` left on the card
            raise torch.linalg.LinAlgError(marg.EIGH_FAILED)
        tbl, ltb = self.pt_table, self.ln_table
        nw, MF, ML = self.cfg.window_size, self.cfg.max_features, self.cfg.max_line_feats
        NW = nw + 1
        off = 0

        def take(n, shape=None):
            nonlocal off
            v = b[off: off + n]
            off += n
            return v.reshape(shape) if shape else v

        self.p = take(NW * 3, (NW, 3))
        self.q = take(NW * 4, (NW, 4))
        self.v = take(NW * 3, (NW, 3))
        self.ba = take(NW * 3, (NW, 3))
        self.bg = take(NW * 3, (NW, 3))
        self.p_bc = take(3)
        self.q_bc = take(4)
        self.td = float(take(1)[0])
        relo_p = take(3)
        relo_q = take(4)
        inv = take(MF)
        self.line_w = take(ML * 6, (ML, 6))
        take(MF)  # point triangulation commits (folded into pt_valid)
        lcommit = take(ML) > 0
        pt_valid = take(MF) > 0
        ln_solved = take(ML) > 0
        pt_err = take(MF)
        ln_err = take(ML)
        p_w = take(MF * 3, (MF, 3))
        cost0, cost, cr0, cr, acc = take(5)

        # triangulation commits + solved-depth writeback + removeFailures
        ltb.solved |= lcommit
        tbl.inv_depth[pt_valid] = inv[pt_valid]
        failed = pt_valid & (inv <= 0)
        if np.any(failed):
            tbl.drop(np.nonzero(failed)[0])
        # removeOutlier / removeLineOutlier (10 px reprojection gates)
        bad = pt_valid & (pt_err > 10.0)
        if np.any(bad):
            tbl.drop(np.nonzero(bad)[0])
        badl = ln_solved & (ln_err > 10.0)
        if np.any(badl):
            ltb.drop(np.nonzero(badl)[0])
        kf_m = pt_valid & (tbl.mask[:, nw] > 0) & (tbl.ids >= 0)
        self._kf_snapshot = (tbl.ids[kf_m].copy(), tbl.obs[kf_m, nw].copy(), p_w[kf_m].copy())
        if dispatched_relo is not None:
            # extract only the relo that was IN the dispatched solve, and
            # clear the live request only if it is still that one (a fresher
            # set_relo_frame stays pending for the next solve)
            self._extract_relo_result(relo_p, relo_q, self.p[nw], self.q[nw])
            if self.relo is dispatched_relo:
                self.relo = None
        return dict(cost0=float(cost0), cost=float(cost), cost_robust0=float(cr0),
                    cost_robust=float(cr), iters_accepted=int(acc),
                    n_pts=int(pt_valid.sum()), n_lines=int(ln_solved.sum()))

    def _failure_detection(self, m: Optional[dict] = None) -> bool:
        """`Estimator::failureDetection`: tracked-feature collapse, a
        persistently bad post-init solve, bias blow-up, position/z jump."""
        nw = self.cfg.window_size
        if m is not None and m.get("long_tracked", 99) < 2:
            return True
        # post-init health gate: a bad visual-inertial alignment shows up as a
        # large PERSISTENT solve cost; 3 consecutive bad solves ⇒ restart
        if m is not None and self.solves_since_init <= 8 and m.get("cost") is not None:
            bad = m["cost"] / max(m.get("n_pts", 0), 1) > 2.0
            self._init_bad_solves = (self._init_bad_solves + 1) if bad else 0
            if self._init_bad_solves >= 3:
                return True
        if np.linalg.norm(self.ba[nw]) > 2.5 or np.linalg.norm(self.bg[nw]) > 1.0:
            return True
        dp = self.p[nw] - self.p[nw - 1]
        return bool(np.linalg.norm(dp) > 5.0 or abs(dp[2]) > 1.0)

    # ---------------------------------------------------------------- slide
    def _slide(self, flag: int):
        """`slideWindow()` — the prior was computed by the backend tick
        (`_pending_prior`); this is host surgery."""
        nw = self.cfg.window_size
        if flag == MARGIN_OLD:
            self.prior = self._pending_prior
            p_wc, q_wc = self._cam_poses_np()
            old0_p, old0_q = p_wc[0].copy(), q_wc[0].copy()
            self._roll_states()
            self.pt_table.slide_old(old0_p, old0_q, p_wc[1], q_wc[1])
            self.ln_table.slide_old()
            self.imu_bufs.pop(1)
            self.pres.pop(1)
        else:
            if self.prior is not None:
                self.prior = self._pending_prior
            # merge interval (nw-1→nw) into (nw-2→nw-1): frame nw-1 dies
            merged = ImuBuffer.merged(self.imu_bufs[nw - 1], self.imu_bufs[nw])
            self.imu_bufs[nw - 1] = merged
            self.imu_bufs.pop(nw)
            self.pres.pop(nw)
            self.pres[nw - 1] = self.preintegrate_buffer(merged, self.ba[nw - 2], self.bg[nw - 2])
            for arr in (self.p, self.q, self.v, self.ba, self.bg):
                arr[nw - 1] = arr[nw]
            self.timestamps[nw - 1] = self.timestamps[nw]
            self.td_pair[nw - 1] = self.td_pair[nw]
            self.pt_table.slide_new()
            self.ln_table.slide_new()

    def _slide_uninitialized(self):
        """During failed initialization the reference always slides old."""
        p_wc, q_wc = self._cam_poses_np()
        old0_p, old0_q = p_wc[0].copy(), q_wc[0].copy()
        self._roll_states()
        self.pt_table.slide_old(old0_p, old0_q, p_wc[1], q_wc[1])
        self.ln_table.slide_old()
        self.imu_bufs.pop(1)
        self.pres.pop(1)
        self.imu_bufs.append(ImuBuffer())
        self.pres.append(None)

    def _roll_states(self):
        for name in ("p", "q", "v", "ba", "bg"):
            arr = getattr(self, name)
            arr[:-1] = arr[1:]
        self.timestamps[:-1] = self.timestamps[1:]
        self.td_pair[:-1] = self.td_pair[1:]

    # ---------------------------------------------------------------- output
    def window_points(self):
        """(ids, norm_obs [n,2], world_3d [n,3]) of triangulated features
        observed in the newest solved frame (pre-slide snapshot)."""
        self.finalize()
        if self._kf_snapshot is None:
            return np.zeros(0, np.int64), np.zeros((0, 2)), np.zeros((0, 3))
        return self._kf_snapshot

    def latest_pose(self):
        self.finalize()
        k = (self.cfg.window_size if self.initialized
             else max(min(self.frame_count, self.cfg.window_size) - 1, 0))
        return self.timestamps[k], self.p[k].copy(), self.q[k].copy()

    def imu_rate_pose(self):
        """IMU-rate propagated odometry: the newest slot as `process_imu`
        dead-reckons it between solves (the reference's `predict()` →
        `pubLatestOdometry`). Returns host copies (p, q, v)."""
        k = min(self.frame_count, self.cfg.window_size)
        return self.p[k].copy(), self.q[k].copy(), self.v[k].copy()


def backend_tick(st, f, solvable, tri_need, fb4, lneed, ln_active2,
                 lay, cfg, ee: bool, etd: bool, iters: int, marg_mode: str, graphs=None):
    """The whole per-frame backend on the device: triangulation → window
    solve → marginalization → outlier/stats extraction.

    marg_mode: 'old' (MARGIN_OLD), 'new' (MARGIN_SECOND_NEW with a live
    prior) or 'none'; in streaming it is known on the host.
    graphs: optional dict of CUDA graphs (`utils/cuda_graph.py`) that the
    window solve and the marginalization's linearization run through; they
    are recorded at the first call of each setting (layout, config, ee, etd,
    iters).
    Returns (st_out, stats, prior, aux) with aux = dict(commit, lcommit,
    pt_valid, ln_solved, pt_err, ln_err, p_w, eigh_failed); `eigh_failed` is
    [] 1 where a marginalization eigendecomposition failed on the card, left
    there for the caller's readback (0 on the CPU, where it raises)."""
    lp = cfg.line_param
    # ---- FeatureManager::triangulate/triangulateLine at pre-solve poses ----
    with timers.span("backend.triangulate"):
        p_wc, q_wc = cam_poses(st)
        inv_tri, ok = triangulate.triangulate_points(p_wc, q_wc, f.pt_obs, f.pt_mask, f.pt_start)
        okf = ok.to(st.p.dtype)
        commit = tri_need * okf
        fallback = tri_need * (1.0 - okf) * fb4
        inv0 = torch.where(commit > 0, inv_tri, st.inv_depth)
        inv0 = torch.where(fallback > 0, torch.full_like(inv0, 1.0 / 5.0), inv0)  # INIT_DEPTH
        L_tri, okl = triangulate.triangulate_lines(p_wc, q_wc, f.ln_obs, f.ln_mask, f.ln_start)
        lcommit = lneed * okl.to(st.p.dtype)
        line0 = torch.where(lcommit[:, None] > 0, L_tri, st.line)
        # post-triangulation validity: previously solved | newly committed |
        # INIT_DEPTH fallback (failed 2-3-obs triangulations never enter the solve)
        pt_valid = solvable * torch.maximum(f.pt_valid, torch.maximum(commit, fallback))
        ln_solved = ln_active2 * torch.maximum(f.ln_valid, lcommit)
        st = st._replace(inv_depth=inv0, line=line0)
        f = f._replace(pt_valid=pt_valid, ln_valid=ln_solved)

    with timers.span("backend.lm"):
        if lp != "world":
            st = st._replace(line=res.lines_from_world(st, st.line, f.ln_start, lp))
        st_out, stats = cuda_graph.run(
            graphs, ("optimize_window", lay, cfg, ee, etd, iters),
            lambda s, f_: solver_mod.optimize_window(s, f_, lay, cfg, estimate_extrinsic=ee,
                                                     estimate_td=etd, num_iters=iters),
            st, f)
        if lp != "world":
            st_out = st_out._replace(line=res.lines_to_world(st_out, f.ln_start, lp))

    with timers.span("backend.marginalize"):
        infos = []
        if marg_mode == "old":
            prior = marg.marginalize_old(st_out, f, lay, cfg, groups=stats.groups, graphs=graphs,
                                         infos=infos)
        elif marg_mode == "new":
            prior = marg.marginalize_second_new(st_out, f, lay, cfg, infos=infos)
        elif marg_mode == "none":
            prior = None
        else:
            raise ValueError(f"unknown marg_mode {marg_mode!r}")
        eigh_failed = marg.eigh_failed(infos, st_out.p)

    # ---- removeOutlier / removeLineOutlier gating metrics ----
    with timers.span("backend.gating"):
        _, _, r_pt, r_ln, _ = stats.groups
        err_px = torch.linalg.norm(r_pt, dim=-1) * 1.5  # whitened → pixels
        pt_err = torch.amax(torch.where(f.pt_mask > 0, err_px, torch.zeros_like(err_px)), dim=1)
        err_ln = torch.amax(torch.abs(r_ln), dim=-1) * 1.5
        ln_err = torch.amax(torch.where(f.ln_mask > 0, err_ln, torch.zeros_like(err_ln)), dim=1)
        p_w = res._world_points(st_out, f)
    aux = dict(commit=commit, lcommit=lcommit, pt_valid=pt_valid, ln_solved=ln_solved,
               pt_err=pt_err, ln_err=ln_err, p_w=p_w, eigh_failed=eigh_failed)
    return st_out, stats, prior, aux


def pack_bundle(st_out: WindowState, stats, aux) -> torch.Tensor:
    """Everything the host needs after a solve, as ONE flat tensor; the
    marginalization's eigh flag last."""
    dtype = st_out.p.dtype
    return torch.cat([
        st_out.p.reshape(-1), st_out.q.reshape(-1), st_out.v.reshape(-1),
        st_out.ba.reshape(-1), st_out.bg.reshape(-1),
        st_out.p_bc, st_out.q_bc, st_out.td.reshape(1),
        st_out.relo_p, st_out.relo_q,
        st_out.inv_depth, st_out.line.reshape(-1),
        aux["commit"], aux["lcommit"], aux["pt_valid"], aux["ln_solved"],
        aux["pt_err"], aux["ln_err"], aux["p_w"].reshape(-1),
        torch.stack([stats.cost0, stats.cost, stats.cost_robust0, stats.cost_robust,
                     stats.accepted.to(dtype)]),
        aux["eigh_failed"].reshape(1),
    ])
