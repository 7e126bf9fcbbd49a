import os

# Tests run on the CPU with a virtual 8-device mesh so sharding code paths
# are exercised without accelerator hardware. The CPU is chosen only when
# JAX_PLATFORMS is unset: tests marked `gpu` need the card and run on it
# with JAX_PLATFORMS=cuda,cpu (`python -m pytest -m gpu tests/`). XLA_FLAGS
# must be set before the first backend initialization.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib

import pytest

GOLDEN = pathlib.Path(__file__).parent / "golden"


def _parse_golden(path):
    sections = {}
    cur = None
    with open(path) as fp:
        for line in fp:
            line = line.rstrip("\n")
            if line.startswith("SECTION "):
                cur = line.split()[1]
                sections[cur] = []
            elif cur is not None:
                sections[cur].append(line)
    return sections


@pytest.fixture(scope="session")
def golden():
    return _parse_golden(GOLDEN / "reference_golden.txt")


@pytest.fixture(scope="session")
def brdc_path():
    # The canonical RINEX file; copied from the reference data assets.
    p = GOLDEN / "brdc3540.14n"
    assert p.exists()
    return str(p)


@pytest.fixture(scope="session")
def gpu():
    """The default GPU device; skips where JAX's default backend is not a
    GPU (the CPU test runs)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: python -m pytest -m gpu tests/ on the card")
    return jax.devices()[0]
