import pytest

try:
    from repro_torch import obs
except ImportError:  # a program without the recorder
    obs = None


@pytest.fixture(autouse=True)
def recorder_off():
    """A traced run's readers turn the program's recorder on; each test
    leaves it off and empty, so no later test in the process records."""
    yield
    if obs is not None:
        obs.disable()
        obs.reset()
