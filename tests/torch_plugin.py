"""The port's process plugin in tests.

The buffer store and the task semaphore are process-wide
(``spark_rapids_tpu_torch/plugin.py``): the first session brings them
up, later sessions share them.  ``fresh_plugin`` is a module-scoped
autouse fixture that shuts the live plugin down before and after its
module, so the module's first session sizes a store of its own.
``sized_plugin(conf, device)`` restarts the plugin with ``conf`` for a
block (a store with that conf's budgets), as the JAX tests restart
theirs, and shuts it down after.
"""

import contextlib

import pytest

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.plugin import TorchPlugin


def shutdown_plugin() -> None:
    live = TorchPlugin.live()
    if live is not None:
        live.shutdown()


@contextlib.contextmanager
def sized_plugin(conf, device="cpu"):
    conf = conf if isinstance(conf, C.TorchConf) else C.TorchConf(conf)
    plugin = TorchPlugin.restart(conf, device)
    try:
        yield plugin
    finally:
        plugin.shutdown()


@pytest.fixture(scope="module", autouse=True)
def fresh_plugin():
    shutdown_plugin()
    yield
    shutdown_plugin()
