import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-minute subprocess tests (dry-run meshes)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one)")


@pytest.fixture(scope="session", autouse=True)
def _cpu_f32():
    # tests run in f32 on the single CPU device; the 512-device dry-run
    # is exercised via a subprocess (test_dryrun.py)
    jax.config.update("jax_enable_x64", False)
    yield


@pytest.fixture
def rng():
    return jax.random.PRNGKey(0)


# -- consolidated harness (tests/helpers.py) as fixtures ------------------

@pytest.fixture
def backend_cfg():
    """Factory fixture: the tiny shared backend-test ModelConfig."""
    from helpers import backend_cfg as factory
    return factory


@pytest.fixture
def engine_harness():
    """Factory fixture: (cfg, params, base_kw, *variants) -> base run,
    asserting greedy token identity across the engine variants."""
    from helpers import assert_engine_identity
    return assert_engine_identity
