"""Drive the repo-root bench.py artifact (both modes) at tiny shapes.

``python bench.py`` measures on a GPU; this keeps its modes importable,
runnable, and emitting the one-line JSON contract on the CPU (where it
reports no roofline: its numbers are not device metrics).
"""

import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run(extra_env):
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        BENCH_RAYS="32",
        BENCH_STEPS="3",
        BENCH_SUB_STEPS="2",
        BENCH_GRAD_REPS="1",
        # tiny-shape runs keep their own compile cache
        JAX_COMPILATION_CACHE_DIR=str(REPO / ".jax_cache_test"),
        **extra_env,
    )
    out = subprocess.run(
        [sys.executable, str(REPO / "bench.py")], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    rec = json.loads(line)
    # driver contract: at least these four keys (extra diagnostic fields
    # like the dtype sweep and roofline/MFU accounting are allowed)
    assert {"metric", "value", "unit", "vs_baseline"} <= set(rec)
    assert rec["value"] > 0
    return rec


def test_bench_forward_contract():
    rec = _run({})
    assert "ray-steps/s" in rec["unit"]
    assert "EFIT" in rec["metric"]
    assert rec["roofline"] is None            # a CPU run: no device metric


def test_bench_kernel_leg_reports_no_cost_analysis():
    """The window-kernel leg (interpreted here) pads 32 rays to one
    128-ray block, counts only the launched rays in its rate, and reports
    no XLA cost analysis, which cannot see into the kernel."""
    rec = _run({"BENCH_DTYPES": "f32", "BENCH_SOLVER": "rk2",
                "BENCH_FROZEN": "1", "BENCH_FREEZE_EVERY": "2",
                "BENCH_PALLAS_WINDOW": "1"})
    leg = rec["dtypes"]["f32"]
    assert leg["padded_rays"] == 128
    assert leg["ray_steps_per_s"] == rec["value"] > 0
    for key in ("flops_per_ray_step", "bytes_per_ray_step",
                "achieved_gflops", "achieved_gbs"):
        assert leg[key] is None, key
    assert leg["finite_fraction"] == leg["in_domain_fraction"] == 1.0


def test_bench_grad_contract():
    rec = _run({"BENCH_MODE": "grad"})
    assert rec["metric"].startswith("fwd+bwd")


def test_bench_absorption_contract():
    rec = _run({"BENCH_MODE": "absorption"})
    assert rec["metric"].startswith("kamp updates")
    assert rec["unit"] == "ray-slices/s"


def test_bench_korc_contract():
    rec = _run({"BENCH_MODE": "korc", "BENCH_PARTICLES": "8192",
                "BENCH_KORC_STEPS": "20", "BENCH_KORC_CHUNK": "10"})
    assert "particle-steps/s" in rec["unit"]
    assert rec["detail"]["num_particles"] == 8192


def test_peak_table_knows_the_h100():
    import bench
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["f32_flops_per_s"] == 67e12
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    assert peaks["source"]


def test_peak_table_refuses_an_unknown_device():
    import bench
    import pytest
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks("cpu")
