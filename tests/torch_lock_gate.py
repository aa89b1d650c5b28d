"""The port's session-wide lock-order gate, a pytest plugin.

tests/conftest.py turns both packages' checkers on (AIKO_LOCK_CHECK=1)
and gates the run on the JAX package's report alone.  This plugin gates
it on the port's: a session-scoped autouse fixture that, when the port's
checker is on, fails the session's last teardown if any test left a
lock-order violation in `aiko_services_tpu_torch.utils.lock_check_report`.
tests/test_torch_lock_gate.py loads it (`pytest_plugins`), so every
worker that collects the suite registers it, and its collection hook
gives every collected test the fixture.  Tests that provoke a
violation on purpose reset the port's checker before they return, as
tests/test_torch_lock_order.py does."""

import pytest

GATE = "_torch_lock_order_gate"


def pytest_collection_modifyitems(items):
    """Put the gate in every item's fixtures: the autouse fixture
    reaches only the items collected after the module that loads this
    plugin, and under xdist a worker may run none of those."""
    for item in items:
        names = getattr(item, "fixturenames", None)
        if names is not None and GATE not in names:
            names.insert(0, GATE)


@pytest.fixture(autouse=True, scope="session")
def _torch_lock_order_gate():
    """Fail the run if any test left a port lock-order violation
    behind: a potential deadlock in the port's threaded code must not
    shrink to a log line."""
    yield
    from aiko_services_tpu_torch.utils import (lock_check_enabled,
                                               lock_check_report)
    if not lock_check_enabled():
        return
    violations = lock_check_report()
    assert not violations, (
        "port lock-order violations detected during the test run:\n"
        + "\n".join(str(v) for v in violations))
