"""Command-line launcher of the port, counterpart of `plslam/__main__.py`
(the reference's `roslaunch pl_vio euroc.launch` plus offline evaluation).

    python -m plslam_torch run    --data <seq_dir|mav0> [--config <yaml>] [--output out/]
                                  [--device cuda|cpu]
    python -m plslam_torch eval   --est est.tum (--gt gt.tum | --data <seq_dir>)
    python -m plslam_torch parity --data <euroc_root> [--config <yaml>] [--device cuda|cpu]

`run` drives the pipeline (frontends → estimator → pose graph) over an EuRoC
ASL sequence and writes its trajectory as TUM (`traj_vio.tum`, or the
loop-corrected `traj_loop.tum` with loop closure on); with ground truth
present it prints the ATE/RPE score line. `eval` scores a TUM trajectory
against ground truth (a TUM file or the sequence's
`state_groundtruth_estimate0/data.csv`). `parity` runs and scores every
EuRoC sequence found under a root. The arguments and the score line are the
JAX package's; `--device` (default `cuda`) picks where the pipeline runs,
and without a card the default raises: there is no fallback to the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch


def _load_gt(args):
    """Ground truth as (ts, ps, qs[wxyz]) from --gt TUM or --data EuRoC dir."""
    if args.gt:
        from plslam_torch.eval.metrics import read_tum

        return read_tum(args.gt)
    if args.data:
        from plslam_torch.io.euroc import EurocSequence

        seq = EurocSequence.load(args.data)
        if seq.gt_t is None:
            sys.exit("error: sequence has no state_groundtruth_estimate0/data.csv")
        return seq.gt_t, seq.gt_p, seq.gt_q
    sys.exit("error: provide --gt <tum> or --data <euroc seq dir>")


def _device(name: str) -> str:
    """`--device`, checked: a CUDA device without a card raises."""
    if name.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device; pass --device cpu to run on the CPU")
    return name


def _score(ts, ps, qs, gt, delta, align):
    from plslam_torch.eval.metrics import ate_rmse, rpe

    gt_t, gt_p, gt_q = gt
    ate = ate_rmse(ts, ps, gt_t, gt_p, align=align)
    rpe_t, rpe_r = rpe(ts, ps, gt_t, gt_p, est_q=qs, gt_q=gt_q, delta=delta)
    return dict(ate_rmse_m=round(ate, 4), rpe_trans_m=round(rpe_t, 4),
                rpe_rot_deg=round(rpe_r, 3), frames=len(ts),
                align=align, rpe_delta_s=delta)


def cmd_run(args):
    from plslam_torch.config import PLSlamConfig
    from plslam_torch.eval.metrics import write_tum
    from plslam_torch.runner import run_euroc

    cfg = PLSlamConfig.from_yaml(args.config) if args.config else PLSlamConfig()
    if args.output:
        os.makedirs(args.output, exist_ok=True)
        cfg = dataclasses.replace(cfg, output_path=args.output)
    ts, ps, qs, est, pg = run_euroc(
        args.data, cfg, use_lines=not args.no_lines,
        loop_closure=None if args.loop is None else bool(args.loop),
        max_frames=args.max_frames, progress=not args.quiet, device=_device(args.device),
    )
    out = args.output or "."
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "traj_loop.tum" if pg is not None else "traj_vio.tum")
    write_tum(path, ts, ps, qs)
    print(f"wrote {len(ts)} poses → {path}", file=sys.stderr)
    if pg is not None:
        print(f"loop closures confirmed: {pg.loop_count}", file=sys.stderr)
    from plslam_torch.io.euroc import EurocSequence

    seq = EurocSequence.load(args.data)
    if seq.gt_t is not None and len(ts) >= 3:
        print(json.dumps(_score(ts, ps, qs, (seq.gt_t, seq.gt_p, seq.gt_q),
                                args.rpe_delta, args.align)))


def cmd_eval(args):
    from plslam_torch.eval.metrics import read_tum

    ts, ps, qs = read_tum(args.est)
    print(json.dumps(_score(ts, ps, qs, _load_gt(args), args.rpe_delta, args.align)))


# The 11 EuRoC MAV sequences of the parity protocol with the PL-VIO-lineage
# published ATE RMSE envelope (approximate, from the VINS-Mono / PL-VIO
# papers; parity = an ATE within 1.2× of these), as in the JAX package.
EUROC_SEQUENCES = {
    "MH_01_easy": 0.12, "MH_02_easy": 0.12, "MH_03_medium": 0.13,
    "MH_04_difficult": 0.18, "MH_05_difficult": 0.21,
    "V1_01_easy": 0.07, "V1_02_medium": 0.09, "V1_03_difficult": 0.19,
    "V2_01_easy": 0.08, "V2_02_medium": 0.16, "V2_03_difficult": 0.29,
}


def _find_sequences(root):
    """Map canonical sequence name → on-disk dir (accepts MH_01_easy, MH_01,
    mh_01_easy, … — anything whose prefix matches and contains mav0/)."""
    found = {}
    if not os.path.isdir(root):
        return found
    entries = {e.lower(): e for e in os.listdir(root)}
    for name in EUROC_SEQUENCES:
        for cand in (name.lower(), name[:5].lower()):
            e = entries.get(cand)
            if e and os.path.isdir(os.path.join(root, e, "mav0")):
                found[name] = os.path.join(root, e)
                break
    return found


def cmd_parity(args):
    """Parity run: every EuRoC sequence present under --data, one table."""
    from plslam_torch.config import PLSlamConfig
    from plslam_torch.eval.metrics import write_tum
    from plslam_torch.io.euroc import EurocSequence
    from plslam_torch.runner import run_euroc

    seqs = _find_sequences(args.data)
    if not seqs:
        sys.exit(
            f"error: no EuRoC sequences found under {args.data!r} — expected "
            "subdirs like MH_01_easy/mav0/… (the EuRoC ASL layout)"
        )
    cfg = PLSlamConfig.from_yaml(args.config) if args.config else PLSlamConfig()
    device = _device(args.device)
    out = args.output or "parity_out"
    os.makedirs(out, exist_ok=True)
    rows = []
    for name, path in seqs.items():
        print(f"[parity] {name} …", file=sys.stderr)
        try:
            ts, ps, qs, est, pg = run_euroc(
                path, cfg, use_lines=not args.no_lines,
                max_frames=args.max_frames, progress=False, device=device)
            write_tum(os.path.join(out, f"{name}.tum"), ts, ps, qs)
            seq = EurocSequence.load(path)
            row = dict(sequence=name, lineage_ate_m=EUROC_SEQUENCES[name])
            if seq.gt_t is not None and len(ts) >= 3:
                row.update(_score(ts, ps, qs, (seq.gt_t, seq.gt_p, seq.gt_q),
                                  args.rpe_delta, args.align))
                row["parity"] = bool(row["ate_rmse_m"] <= 1.2 * EUROC_SEQUENCES[name])
            if pg is not None:
                row["loops"] = pg.loop_count
        except Exception as exc:  # a hard sequence must not kill the table
            row = dict(sequence=name, error=f"{type(exc).__name__}: {exc}")
        rows.append(row)
        print(json.dumps(row))
    # markdown summary
    lines = ["| sequence | ATE [m] | RPE-1s [m] | lineage [m] | parity |",
             "|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['sequence']} | {r.get('ate_rmse_m', '—')} | "
            f"{r.get('rpe_trans_m', '—')} | {r.get('lineage_ate_m', '—')} | "
            f"{'✅' if r.get('parity') else ('❌' if 'parity' in r else '—')} |")
    table = "\n".join(lines)
    with open(os.path.join(out, "parity.md"), "w") as fh:
        fh.write(table + "\n")
    print(table, file=sys.stderr)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plslam_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run the full pipeline on an EuRoC ASL sequence")
    r.add_argument("--data", required=True, help="sequence dir (contains mav0/) or mav0 itself")
    r.add_argument("--config", default=None, help="reference-format YAML config")
    r.add_argument("--output", default=None, help="output dir (TUM trajectories, viz dumps)")
    r.add_argument("--no-lines", action="store_true", help="points-only frontend")
    r.add_argument("--loop", type=int, default=None, choices=(0, 1),
                   help="override loop_closure config flag")
    r.add_argument("--max-frames", type=int, default=None)
    r.add_argument("--align", default="yaw", choices=("yaw", "se3", "sim3"))
    r.add_argument("--rpe-delta", type=float, default=1.0)
    r.add_argument("--quiet", action="store_true")
    r.add_argument("--device", default="cuda", help="torch device of the pipeline (cuda, cpu)")
    r.set_defaults(fn=cmd_run)

    p = sub.add_parser("parity", help="run + score every EuRoC sequence under a root dir")
    p.add_argument("--data", required=True, help="EuRoC root (contains MH_01_easy/ … V2_03_difficult/)")
    p.add_argument("--config", default=None, help="reference-format YAML config")
    p.add_argument("--output", default=None, help="output dir (per-seq TUM + parity.md)")
    p.add_argument("--no-lines", action="store_true")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--align", default="yaw", choices=("yaw", "se3", "sim3"))
    p.add_argument("--rpe-delta", type=float, default=1.0)
    p.add_argument("--device", default="cuda", help="torch device of the pipeline (cuda, cpu)")
    p.set_defaults(fn=cmd_parity)

    e = sub.add_parser("eval", help="score a TUM trajectory against ground truth")
    e.add_argument("--est", required=True, help="estimated trajectory (TUM)")
    e.add_argument("--gt", default=None, help="ground-truth trajectory (TUM)")
    e.add_argument("--data", default=None, help="EuRoC sequence dir (uses its GT csv)")
    e.add_argument("--align", default="yaw", choices=("yaw", "se3", "sim3"))
    e.add_argument("--rpe-delta", type=float, default=1.0)
    e.set_defaults(fn=cmd_eval)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
