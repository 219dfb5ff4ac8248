"""Zero-dependency line coverage for the suite via sys.monitoring (PEP 669).

This environment ships no coverage.py; stdlib ``trace`` is far too slow for a
~15-minute suite.  sys.monitoring LINE events with per-location DISABLE after
the first hit cost near-zero once warm, so the full suite runs at native
speed.

Usage:
    MMLA_COV_OUT=/tmp/cov.json python -m pytest tests/ -q -p tools.covtrace
    python tools/covreport.py /tmp/cov.json          # uncovered-line report

Only files under ``mmla_audio_tpu/`` are recorded.  Subprocesses (e.g. the
two-process test in tests/test_dcn.py) are not traced — their coverage is out of scope for
this report.
"""

from __future__ import annotations

import atexit
import json
import os
import sys

_PKG_PREFIX = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "mmla_audio_tpu")
_hits: dict[str, set[int]] = {}


# Constants are bound as DEFAULT ARGS: at interpreter shutdown module
# globals are cleared to None while LINE events still fire from weakref/
# logging teardown callbacks — a global lookup there raises into arbitrary
# unwinding code.  co_filename can also be None for synthesized code.
def _on_line(code, line, _prefix=_PKG_PREFIX, _hits=_hits,
             _DISABLE=sys.monitoring.DISABLE):
    fn = code.co_filename
    if fn is not None and fn.startswith(_prefix):
        _hits.setdefault(fn, set()).add(line)
    return _DISABLE                     # first hit is enough; stop the event


def _dump(_hits=_hits):
    out = os.environ.get("MMLA_COV_OUT", "/tmp/mmla_cov.json")
    payload = {fn: sorted(lines) for fn, lines in _hits.items()}
    with open(out, "w") as f:
        json.dump(payload, f)
    sys.stderr.write(f"[covtrace] wrote {len(payload)} files -> {out}\n")


def install():
    M = sys.monitoring
    M.use_tool_id(M.COVERAGE_ID, "mmlacov")
    M.register_callback(M.COVERAGE_ID, M.events.LINE, _on_line)
    M.set_events(M.COVERAGE_ID, M.events.LINE)
    atexit.register(_dump)


install()
