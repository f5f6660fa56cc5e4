"""The comparison that decides `correct`: what the timed path produced,
sampled inside the window, against the plain reference (`reference/`), in
float64 on the CPU once the window has closed.

Numbers compared (each against its limit in `limits/<config>.json`):
  lk_gap_px         widest gap of an LK track that both call good (px)
  lk_status_share   share of the valid points whose status differs
  hamming_mismatch  distance-matrix entries that differ, the line matcher's
  search_mismatch   the same, the keyframe database's BRIEF search
  solve_cost_gap    the reference's robust cost at the port's solved window
                    over its cost at its own solution, less 1
  marg_gap          widest gap between the information JᵀJ of the
                    marginalization's prior and of the reference's
                    marginalization at the port's solved window, in units
                    of the window's own information on each dim
  pgo_gap_m         widest keyframe position gap after the 4-DoF PGO (m)
The reference takes the kernels' and the tick's inputs as the port handed
them over (the previous frame's tracks, the window's state and factors):
it follows the port step by step from the port's own state, and works out
again every quantity the step itself derives (the image pyramid, the
triangulation, the solve, the marginalization).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _f64(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.double() if x.is_floating_point() else x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_f64(v) for v in x])
    return x


def _as(cls, nt):
    """A reference NamedTuple of the same fields as the port's `nt`."""
    return cls(**{k: _f64(v) for k, v in nt._asdict().items()})


def check_lk(samples) -> dict:
    from plbench.reference import lk

    gaps, diff, valid = [0.0], 0, 0
    for s in samples:
        pyr_p = lk.pyramid(_f64(s["prev0"]), s["levels"])
        pyr_c = lk.pyramid(_f64(s["cur0"]), s["levels"])
        v = s["valid"].cpu()
        ref, ref_ok, _ = lk.track(pyr_p, pyr_c, _f64(s["pts"]), v)
        out, ok = _f64(s["out"][0]), s["out"][1].cpu()
        both = ok & ref_ok
        if bool(both.any()):
            gaps.append(float(torch.amax(torch.linalg.norm(out[both] - ref[both], dim=-1))))
        diff += int((ok != ref_ok)[v].sum())
        valid += int(v.sum())
    return {"lk_gap_px": max(gaps), "lk_status_share": diff / max(valid, 1)}


def hamming_mismatch(samples) -> int:
    from plbench.reference import hamming

    bad = 0
    for s in samples:
        ref = hamming.hamming_matrix(s["d1"].cpu().numpy(), s["d2"].cpu().numpy())
        bad += int(np.sum(s["out"].cpu().numpy().astype(np.int64) != ref))
    return bad


def _ref_cfg(cfg):
    from plbench.reference.config import SolverConfig

    fields = {f.name for f in dataclasses.fields(SolverConfig)}
    return SolverConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in fields})


def _window_scale(st, f, lay, cfg, shift: bool):
    """1/√ of the diagonal of the window's Gauss-Newton information on the
    camera-side dims at `st` (every factor, robust weights at `st`), in the
    prior's layout (after the window shift of MARGIN_OLD); 0 on dims that
    no factor informs. The units in which the next solve weighs the prior."""
    from plbench.reference import marginalization, residuals
    from plbench.reference.solver import linearize_blocks

    if cfg.line_param != "world":
        st = st._replace(line=residuals.lines_from_world(st, st.line, f.ln_start, cfg.line_param))
    pt_w, ln_w, _ = residuals.robust_weights(st, f, cfg.focal_length, cfg.cauchy_c,
                                             cfg.line_param)
    ones = torch.ones((lay.dim,), dtype=st.p.dtype)
    _, J, _ = linearize_blocks(st, f, lay, cfg.focal_length, pt_w, ln_w, ones, None,
                               cfg.line_param)
    h = (J * J).sum(0)
    if shift:
        h = h[torch.as_tensor(marginalization._shift_perm(lay))]
    return torch.where(h > 1e-12, torch.rsqrt(torch.clamp(h, min=1e-12)), torch.zeros_like(h))


def _info(prior):
    """The information JᵀJ of a prior; none for a prior not valid."""
    J = prior.J * prior.valid
    return J.T @ J


def marg_gap(prior_port, prior_ref, st_p, f, lay, cfg, shift: bool) -> float:
    """The widest gap between the information JᵀJ of the port's prior and of
    the reference's, in units of the window's own information on each dim
    (`_window_scale`)."""
    d = _window_scale(st_p, f, lay, cfg, shift)
    gap = (_info(_f64(prior_port)) - _info(prior_ref)) * d[:, None] * d[None, :]
    return float(torch.amax(torch.abs(gap)))


def check_solve(samples) -> dict:
    from plbench.reference import backend, marginalization, residuals, state

    cost, marg = [0.0], []
    for s in samples:
        st, f, solvable, tri_need, fb4, lneed, ln2 = s["inputs"]
        st_r, f_r = _as(state.WindowState, st), _as(residuals.WindowFactors, f)
        lay = state.TangentLayout(**s["lay"]._asdict())
        cfg = _ref_cfg(s["cfg"])
        kw = s["kw"]
        st_ref, _, prior_ref, aux = backend.backend_tick(
            st_r, f_r, *[_f64(m) for m in (solvable, tri_need, fb4, lneed, ln2)], lay, cfg,
            ee=kw["ee"], etd=kw["etd"], iters=kw["iters"], marg_mode=kw["marg_mode"])
        st_p = _as(state.WindowState, s["st_out"])
        fr = aux["f"]

        def robust(x):
            g = residuals.residual_groups(x, fr, lay, cfg.focal_length, cfg.line_param)
            return float(residuals.robust_cost_of_groups(g, cfg.cauchy_c))

        cost.append(robust(st_p) / robust(st_ref) - 1.0)
        if prior_ref is not None:
            # the reference's marginalization at the port's solved window
            if kw["marg_mode"] == "old":
                pr = marginalization.marginalize_old(st_p, fr, lay, cfg)
            else:
                pr = marginalization.marginalize_second_new(st_p, fr, lay, cfg)
            if s["prior"] is None:
                marg.append(float("inf"))
            else:
                marg.append(marg_gap(s["prior"], pr, st_p, fr, lay, cfg, kw["marg_mode"] == "old"))
    # no number where no sampled tick marginalized: `marg_gap` is required
    return {"solve_cost_gap": max(cost), **({"marg_gap": max(marg)} if marg else {})}


def check_pgo(samples) -> dict:
    from plbench.reference import pgo

    gaps = [0.0]
    for s in samples:
        args = [_f64(a) for a in s["args"]]
        xyz, _ = pgo.optimize_4dof(*args, **s["kw"])
        live = args[4] > 0
        gaps.append(float(torch.amax(torch.linalg.norm(_f64(s["xyz"])[live] - xyz[live], dim=-1))))
    return {"pgo_gap_m": max(gaps)}


def compare(samples: dict) -> tuple[dict, dict]:
    """(numbers by name, count of calls compared by kind)."""
    torch.set_num_threads(max(1, min(8, torch.get_num_threads())))
    out = {}
    counts = {k: len(v) for k, v in samples.items()}
    with torch.no_grad():
        if samples["lk"]:
            out.update(check_lk(samples["lk"]))
        if samples["hamming"]:
            out["hamming_mismatch"] = hamming_mismatch(samples["hamming"])
        if samples["search"]:
            out["search_mismatch"] = hamming_mismatch(samples["search"])
        if samples["solve"]:
            out.update(check_solve(samples["solve"]))
    if samples["pgo"]:
        out.update(check_pgo(samples["pgo"]))
    return out, counts


def judge(numbers: dict, limits: dict, required: tuple) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}) over the numbers that have a limit:
    every required one present and each at or under its limit."""
    checks, ok = {}, True
    for name in sorted((set(numbers) & set(limits)) | set(required)):
        v = numbers.get(name)
        checks[name] = {"value": v, "limit": limits[name]}
        if v is None or not np.isfinite(v) or v > limits[name]:
            ok = False
    return ok, checks
