"""Shared by the port's CPU test modules: each imports the fixture below,
which caps torch at two intra-op threads while the module runs.

    from _torch_threads import few_torch_threads  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    # The suite runs in several worker processes: torch's default of one
    # busy thread per core in each would starve the timing-sensitive tests
    # running beside these.
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
