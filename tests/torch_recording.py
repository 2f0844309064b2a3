"""The ``recording`` fixture of the port's tests: gaunegf_tpu_torch's
recorder (utils/logging) on and empty for the test, as it was after it.
A test file imports it by name; tests/test_torch_cuda.py runs on the
card without the conftest, so the fixture lives here."""

import pytest

from gaunegf_tpu_torch.utils.logging import recorder


@pytest.fixture
def recording():
    with recorder.recording():
        yield recorder
