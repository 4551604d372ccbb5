"""Preflight checkpoint validator — port of
``neutronstarlite_tpu/tools/verify_checkpoint.py``:

    python -m neutronstarlite_torch.tools.verify_checkpoint <ckpt-dir> [...] [--quiet]

For every ``step-<n>/`` directory under each root (and a legacy flat-layout
checkpoint, if present) it runs the verification that restore runs
(``utils/checkpoint.verify_step_dir``): the manifest, and each array's
sha256, shape and dtype. It prints each array's status and a verdict line;
quarantined ``*.corrupt`` directories are listed and do not fail the
check. It reads the checkpoints of both packages and gives the reference
tool's verdicts.

Exit codes: 0 every checkpoint found is intact; 1 corruption or an
unreadable input; 2 no checkpoint found.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List

from neutronstarlite_torch.utils.checkpoint import (
    CORRUPT_SUFFIX,
    MANIFEST,
    CheckpointCorruptError,
    list_steps,
    verify_step_dir,
)


def _verify_one(step_dir: str, quiet: bool) -> bool:
    """Print one step directory's per-array status; True when intact."""
    label = os.path.relpath(step_dir)
    try:
        manifest, status, _arrays = verify_step_dir(step_dir)
    except CheckpointCorruptError as e:
        print(f"{label}: CORRUPT")
        for problem in e.problems:
            print(f"  !! {problem}")
        return False
    if not quiet:
        for name in sorted(status):
            meta = manifest.get("arrays", {}).get(name, {})
            print(
                f"  {name:<24s} {status[name]:<4s} "
                f"shape={tuple(meta.get('shape', ()))} "
                f"dtype={meta.get('dtype')} "
                f"sha256={meta.get('sha256', '')[:12]}"
            )
    legacy_note = "" if manifest.get("format", 1) >= 2 else " (no digests: legacy format)"
    print(f"{label}: OK step={manifest.get('step')} arrays={len(status)}{legacy_note}")
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m neutronstarlite_torch.tools.verify_checkpoint",
        description="validate checkpoint manifest schema + sha256 digests",
    )
    ap.add_argument("paths", nargs="+", help="checkpoint dir(s) "
                    "(CHECKPOINT_DIR roots or individual step-N dirs)")
    ap.add_argument("--quiet", action="store_true",
                    help="verdict lines only, no per-array detail")
    args = ap.parse_args(argv)

    found = corrupt = 0
    for root in args.paths:
        if not os.path.isdir(root):
            print(f"{root}: not a directory", file=sys.stderr)
            corrupt += 1
            continue
        targets: List[str] = [d for _s, d in list_steps(root)]
        if os.path.exists(os.path.join(root, MANIFEST)):
            targets.append(root)  # legacy flat layout, or a step dir itself
        for name in sorted(os.listdir(root)):
            if CORRUPT_SUFFIX in name:
                print(f"{os.path.join(os.path.relpath(root), name)}: quarantined (skipped)")
        if not targets:
            print(f"{root}: no checkpoint found (no step-*/ dirs, no {MANIFEST})",
                  file=sys.stderr)
            continue
        for step_dir in targets:
            found += 1
            if not _verify_one(step_dir, args.quiet):
                corrupt += 1
    if corrupt:
        return 1
    if not found:
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
