"""Pin bench.py's start-up and emission contract: GPU-only device guard,
the per-``device_kind`` peak table, cumulative JSON lines and the section
budget."""

from types import SimpleNamespace

import pytest

import bench
from mmla_audio_tpu.utils.device import require_gpu


def test_device_guard_refuses_cpu_backend():
    import jax

    with pytest.raises(RuntimeError, match="GPU is required"):
        require_gpu()                      # the test process is CPU-only
    with pytest.raises(RuntimeError, match="GPU is required"):
        require_gpu(jax.devices("cpu"))
    with pytest.raises(RuntimeError, match="GPU is required"):
        require_gpu([])
    gpu = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    assert require_gpu([gpu]) is gpu


def test_peak_table_gives_no_share_for_unknown_kind():
    got = bench.roofline_shares("Unlisted Card", 1e12, 2e9, 1e-3)
    assert got == {"hbm_gbps": 2000.0, "tflops": 1000.0}
    got = bench.roofline_shares("NVIDIA H100 80GB HBM3", 495e9, 3.35e9, 1e-3)
    assert got["hbm_pct_of_peak"] == 100.0
    assert got["tf32_pct_of_peak"] == 100.0


def test_emit_line_is_parseable_cumulative_partial(capsys):
    """Crash-proof emission: every section re-prints the
    cumulative dict as one JSON line, so killing the run at ANY point leaves
    the last stdout line a valid partial artifact; the final line carries
    complete=true."""
    import json
    import time

    out = {"metric": "m", "value": 1.0}
    t0 = time.perf_counter()
    bench._emit_line(out, t0)                    # after section 1
    out["speaker_step_ms"] = 13.8
    bench._emit_line(out, t0)                    # after section 2
    bench._emit_line(out, t0, complete=True)     # end of run
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 3
    parsed = [json.loads(l) for l in lines]      # every line parses alone
    assert parsed[0]["complete"] is False and "speaker_step_ms" not in parsed[0]
    assert parsed[1]["speaker_step_ms"] == 13.8
    assert parsed[2]["complete"] is True
    assert all("elapsed_s" in p for p in parsed)


def test_section_budget_skips_heavy_tail_only():
    """BENCH_BUDGET_S: sections whose estimate exceeds the remaining budget
    are skipped and recorded; unset budget never skips."""
    import time

    out = {}
    t0 = time.perf_counter()
    assert not bench._section_over_budget(out, "live64", 1e9, t0, 0)
    assert not bench._section_over_budget(out, "speaker", 0.0, t0, 3600)
    assert bench._section_over_budget(out, "live1024", 1e9, t0, 3600)
    assert out["skipped_sections"] == ["live1024"]
