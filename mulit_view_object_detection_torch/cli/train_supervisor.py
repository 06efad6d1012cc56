"""Segmented-training supervisor: restart train_to_ap across checkpointed
segments.

Port of `tools/train_supervisor.py`. Runs `python -m
mulit_view_object_detection_torch.cli.train_to_ap` as a child with a
host-RSS budget; the child checkpoints and exits 75 when the budget is
passed, and the supervisor relaunches it with --resume until the step
budget is spent or the restart cap is reached. A long quality run so
survives a host that would kill it, losing at most one segment's tail.

    python -m mulit_view_object_detection_torch.cli.train_supervisor \
        --max-rss-gb 60 -- --until-step 4000 --image-size 640 \
        --ckpt build/ckpt --ckpt-every 500 ...

--ckpt and --until-step (an absolute step target) are required: --steps
alone is relative, so each restarted segment would train N more steps
and the run would never end on its budget.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

CHILD = "mulit_view_object_detection_torch.cli.train_to_ap"
# the directory that holds the package, for the child's import path
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _child_env():
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=_ROOT + (os.pathsep + path
                                                if path else ""))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--max-rss-gb", type=float, default=60.0)
    parser.add_argument("--max-restarts", type=int, default=20)
    parser.add_argument("train_args", nargs=argparse.REMAINDER,
                        help="arguments after `--` go to train_to_ap")
    args = parser.parse_args(argv)
    child_args = [a for a in args.train_args if a != "--"]

    def has_flag(flag):
        return any(a == flag or a.startswith(flag + "=")
                   for a in child_args)

    if not has_flag("--ckpt"):
        parser.error("train_to_ap args must include --ckpt "
                     "(the restart contract is checkpoint-based)")
    if not has_flag("--until-step"):
        parser.error("train_to_ap args must include --until-step (an "
                     "absolute target; --steps alone grows the budget "
                     "by N per restart)")

    base = [sys.executable, "-m", CHILD, *child_args,
            "--max-rss-gb", str(args.max_rss_gb)]
    for attempt in range(args.max_restarts + 1):
        cmd = list(base)
        if attempt > 0 and "--resume" not in cmd:
            cmd.append("--resume")
        print(f"[supervisor] segment {attempt}: {' '.join(cmd[1:])}",
              flush=True)
        rc = subprocess.call(cmd, env=_child_env())
        if rc != 75:
            print(f"[supervisor] child exited rc={rc} after "
                  f"{attempt + 1} segment(s)", flush=True)
            return rc
    print(f"[supervisor] gave up after {args.max_restarts} restarts",
          flush=True)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
