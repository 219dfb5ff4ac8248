"""Report uncovered executable lines from a tools/covtrace.py dump.

    python tools/covreport.py /tmp/mmla_cov.json [--min-pct 100] [--spans]

Executable lines are taken from compiled code objects (``co_lines`` over the
module code and every nested function/class body), so docstrings, comments
and blank lines don't count against coverage.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def executable_lines(path: str) -> set[int]:
    with open(path) as f:
        src = f.read()
    lines: set[int] = set()
    stack = [compile(src, path, "exec")]
    while stack:
        code = stack.pop()
        for _, _, ln in code.co_lines():
            # line 0 is the module code object's synthetic RESUME position,
            # not a source line
            if ln:
                lines.add(ln)
        for const in code.co_consts:
            if hasattr(const, "co_lines"):
                stack.append(const)
    return lines


def spans(nums):
    nums = sorted(nums)
    out, start, prev = [], None, None
    for n in nums:
        if start is None:
            start = prev = n
        elif n == prev + 1:
            prev = n
        else:
            out.append((start, prev))
            start = prev = n
    if start is not None:
        out.append((start, prev))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dump")
    ap.add_argument("--min-pct", type=float, default=100.0,
                    help="only show files below this coverage %%")
    ap.add_argument("--spans", action="store_true",
                    help="print uncovered line spans per file")
    ap.add_argument("--json", metavar="OUT", default=None,
                    help="also write a machine-readable artifact (total "
                         "percent + per-file percent + uncovered spans)")
    args = ap.parse_args()

    with open(args.dump) as f:
        hits = {fn: set(v) for fn, v in json.load(f).items()}

    pkg_root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "mmla_audio_tpu")
    all_files = []
    for root, _dirs, files in os.walk(pkg_root):
        for name in sorted(files):
            if name.endswith(".py"):
                all_files.append(os.path.join(root, name))

    rows = []
    tot_exec = tot_hit = 0
    for fn in all_files:
        ex = executable_lines(fn)
        if not ex:
            continue
        hit = hits.get(fn, set()) & ex
        tot_exec += len(ex)
        tot_hit += len(hit)
        pct = 100.0 * len(hit) / len(ex)
        rows.append((pct, fn, ex - hit))
    rows.sort()

    rel = lambda p: os.path.relpath(p, os.path.dirname(pkg_root))
    for pct, fn, missing in rows:
        if pct >= args.min_pct:
            continue
        print(f"{pct:6.1f}%  {rel(fn)}  ({len(missing)} uncovered)")
        if args.spans and missing:
            chunks = [f"{a}" if a == b else f"{a}-{b}"
                      for a, b in spans(missing)]
            print(f"         {', '.join(chunks)}")
    if tot_exec:
        print(f"\nTOTAL {100.0 * tot_hit / tot_exec:.1f}% "
              f"({tot_hit}/{tot_exec} executable lines)")
    if args.json:
        payload = {
            "total_pct": round(100.0 * tot_hit / max(tot_exec, 1), 1),
            "hit_lines": tot_hit,
            "executable_lines": tot_exec,
            "files": [
                {"file": rel(fn), "pct": round(pct, 1),
                 "uncovered": [f"{a}" if a == b else f"{a}-{b}"
                               for a, b in spans(missing)]}
                for pct, fn, missing in rows
            ],
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
