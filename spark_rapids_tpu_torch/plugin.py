"""Plugin entry point and lifecycle.

Counterpart of ``spark_rapids_tpu/plugin.py`` (SQLPlugin and the
executor plugin's bring-up in the reference).  The plugin owns what is
process-wide: the buffer store, sized once from the conf and the device
by ``memory/device_manager.initialize``, and the task semaphore, made
from the same conf (``memory/semaphore.TpuSemaphore.get``).  Every
``TorchSession`` brings the plugin up if it is not live
(:meth:`TorchPlugin.get_or_create`) and then uses the live store and
semaphore: a new session never closes another's store.  To run with
another budget, shut the live plugin down and bring a new one up
(:meth:`TorchPlugin.restart`), as the JAX tests restart theirs; that
closes the store, so no query may be in flight.  A session whose
device or store keys (``STORE_KEYS``) differ from the live plugin's
raises ``PluginMismatch`` rather than run on a store sized for another
device or budget: the JAX package has one device a process, so it has
no such case.  The one exception is a ``cpu`` session beside a
``cuda`` plugin, a host reference run: it shares the card's store,
whose device tier then holds its host tensors as well.

Frontend adapters: ``register_frontend(name, factory)`` and
``frontend(name)``; ``native`` makes a ``TorchSession``, ``sql`` a
``frontends.sql.SqlSession`` and ``substrait`` (registered when
``frontends/substrait.py`` is imported, which ``frontend`` does on the
first ask) a ``SubstraitFrontend``, each from the plugin's conf and
device.
The JAX plugin's network shuffle bring-up is not ported.
"""

from __future__ import annotations

import atexit
import threading
from typing import Callable, Optional, Union

import torch

from spark_rapids_tpu_torch import config as C

_SHIMS: dict[str, Callable] = {}
_lock = threading.Lock()

#: the keys that size the process store (``memory/device_manager.py``):
#: read once, when the plugin comes up
STORE_KEYS = (C.HBM_BUDGET_BYTES, C.HOST_SPILL_BYTES, C.SPILL_DIR,
              C.SPILL_CODEC, C.SPILL_COMPRESS_HOST, C.MEMORY_FRACTION,
              C.HOST_POOL_BYTES)


class PluginMismatch(RuntimeError):
    """A session asked for a device or store keys other than the live
    plugin's; ``TorchPlugin.restart`` brings up a plugin with them."""


def register_frontend(name: str, factory: Callable) -> None:
    """Register a frontend adapter: ``factory(conf, device)`` -> a
    session-like object over this engine."""
    with _lock:
        _SHIMS[name] = factory


def frontend(name: str = "native") -> Callable:
    """The factory registered as ``name``.  A frontend module of this
    package that registers itself on import (``frontends/substrait.py``)
    is imported on the first ask."""
    with _lock:
        fe = _SHIMS.get(name)
    if fe is None and name.isidentifier():
        import importlib

        try:
            importlib.import_module(f"{__package__}.frontends.{name}")
        except ModuleNotFoundError:
            pass
    with _lock:
        try:
            return _SHIMS[name]
        except KeyError:
            raise KeyError(f"no frontend {name!r} registered "
                           f"(have: {sorted(_SHIMS)})") from None


class TorchPlugin:
    """The process-wide lifecycle owner (SQLPlugin's counterpart)."""

    _instance: Optional["TorchPlugin"] = None

    def __init__(self, conf: Optional[C.TorchConf] = None,
                 device: Union[str, torch.device] = "cuda"):
        from spark_rapids_tpu_torch.memory import device_manager
        from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore

        self.conf = conf if conf is not None else C.TorchConf()
        self.device = torch.device(device)
        self._closed = False
        TpuSemaphore.reset()
        TpuSemaphore.get(self.conf)
        #: the process store at bring-up (sessions read ``get_store()``,
        #: so an explicitly installed store is used as well)
        self.store = device_manager.initialize(self.conf, self.device)
        atexit.register(self.shutdown)

    @classmethod
    def get_or_create(cls, conf: Optional[C.TorchConf] = None,
                      device: Union[str, torch.device, None] = None
                      ) -> "TorchPlugin":
        """The live plugin; brought up from ``conf`` and ``device``
        (``cuda`` when None) when there is none (or it was shut down).
        A live plugin is checked against them: a device it was not
        brought up for, or a store key that ``conf`` sets to another
        value, raises ``PluginMismatch``."""
        with _lock:
            inst = cls._instance
            if inst is None or inst._closed:
                cls._instance = TorchPlugin(
                    conf, "cuda" if device is None else device)
                return cls._instance
        if device is not None:
            inst._check_device(torch.device(device))
        if conf is not None:
            inst._check_store_keys(conf)
        return inst

    def _check_device(self, device: torch.device) -> None:
        def norm(d):
            return (d.type, (d.index or 0) if d.type == "cuda" else None)

        if norm(device) == norm(self.device) or (
                device.type == "cpu" and self.device.type == "cuda"):
            return
        raise PluginMismatch(
            f"a session on {device} beside the live plugin on "
            f"{self.device}: the process store was sized for "
            f"{self.device}; call TorchPlugin.restart(conf, {str(device)!r})"
            " first (no query may be in flight)")

    def _check_store_keys(self, conf: C.TorchConf) -> None:
        differ = [k for k in STORE_KEYS
                  if conf.is_set(k) and conf.get(k) != self.conf.get(k)]
        if differ:
            raise PluginMismatch(
                "the live plugin's store was sized with other values of "
                + ", ".join(f"{k} ({self.conf.get(k)!r}, asked "
                            f"{conf.get(k)!r})" for k in differ)
                + "; the keys size the store only when the plugin comes "
                "up: call TorchPlugin.restart(conf, device) first (no "
                "query may be in flight)")

    @classmethod
    def restart(cls, conf: Optional[C.TorchConf] = None,
                device: Union[str, torch.device] = "cuda"
                ) -> "TorchPlugin":
        """Shut the live plugin down (its store closes) and bring up a
        new one from ``conf`` and ``device``."""
        with _lock:
            old = cls._instance
        if old is not None:
            old.shutdown()
        return cls.get_or_create(conf, device)

    @classmethod
    def live(cls) -> Optional["TorchPlugin"]:
        """The live plugin, without bringing one up."""
        with _lock:
            inst = cls._instance
        return inst if inst is not None and not inst._closed else None

    def session(self, frontend_name: str = "native"):
        return frontend(frontend_name)(self.conf, self.device)

    def shutdown(self) -> None:
        """Release the process-wide state: the store closes and the
        semaphore is dropped."""
        if self._closed:
            return
        self._closed = True
        from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
        from spark_rapids_tpu_torch.memory.store import reset_store

        reset_store()
        TpuSemaphore.reset()


def _native_frontend(conf, device):
    from spark_rapids_tpu_torch.session import TorchSession

    return TorchSession(conf, device=device)


def _sql_frontend(conf, device):
    from spark_rapids_tpu_torch.frontends.sql import SqlSession

    return SqlSession(conf, device=device)


register_frontend("native", _native_frontend)
register_frontend("sql", _sql_frontend)
