"""Test configuration: emulate an 8-device mesh on CPU, enable f64.

The reference test suite runs everywhere because its CPU LLVM-JIT backend is
a real backend (SURVEY.md section 4); our equivalent trick is XLA's host
platform with a forced device count, which makes every sharding test a real
multi-device test without accelerator hardware.
"""

import os

# Must be set before jax is imported anywhere.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# force the platform through the config as well, in case a plugin
# registered another default
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pathlib  # noqa: E402
import sys  # noqa: E402

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

REFERENCE_DATA = pathlib.Path("/root/reference/graph_tests")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def efit_file():
    return REFERENCE_DATA / "efit.nc"


@pytest.fixture(scope="session")
def efit_gold_file():
    return REFERENCE_DATA / "efit_gold.nc"


@pytest.fixture(scope="session")
def vmec_file():
    return REFERENCE_DATA / "vmec.nc"


@pytest.fixture(scope="session")
def erfi_file():
    return REFERENCE_DATA / "test_erfi.nc"
