"""The OOM ladder stays quiet on the port's workload tests.

``quiet_ladder`` is a module-scoped autouse fixture: a test module that
imports it zeroes ``retry_stats()``, shuts the process plugin down (so
its first session sizes a store of its own, as ``torch_plugin``'s
fixture does) and records every ``BufferStore`` made while it runs; at
the module's end the ladder must have absorbed nothing and no store may
have spilled, so no silent recovery changes what those tests hold.
"""

import pytest

from spark_rapids_tpu_torch.execs import retry as R
from spark_rapids_tpu_torch.memory import store as S
from torch_plugin import shutdown_plugin


@pytest.fixture(scope="module", autouse=True)
def quiet_ladder():
    stores = []
    init = S.BufferStore.__init__

    def recording(self, *args, **kwargs):
        init(self, *args, **kwargs)
        stores.append(self)

    R.reset_retry_stats()
    shutdown_plugin()
    mp = pytest.MonkeyPatch()
    mp.setattr(S.BufferStore, "__init__", recording)
    try:
        yield stores
    finally:
        mp.undo()
        shutdown_plugin()
    assert R.retry_stats() == dict.fromkeys(R.retry_stats(), 0)
    for st in stores:
        s = st.spill_stats()
        assert (s["spilled_device_to_host"], s["spilled_host_to_disk"]) \
            == (0, 0), s
