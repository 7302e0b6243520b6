"""Versioned parameter store of the serving tier (port of the in-process
``ParameterServer`` and of ``BackpressureError`` in ``repro/core/servers.py``).

Values stay on the device. ``push`` snapshots every tensor with a device
copy (``clone``), so a published version is isolated from buffers the pusher
goes on to update in place. ``pull_if_newer`` on an unchanged version is a
lock and an integer compare: no copy, no tree traversal, no host sync.
"""
from __future__ import annotations

import threading
from typing import Dict, Mapping

import torch


class ParameterServer:
    """Versioned store of state dicts (name -> tensor), Alg. 1/2/3
    'Pull/Push parameters'."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = None
        self._version = 0

    @staticmethod
    def _snapshot(value: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        # device->device copy; never a host transfer
        return {k: t.detach().clone() for k, t in value.items()}

    def push(self, value: Mapping[str, torch.Tensor]) -> int:
        snap = self._snapshot(value)    # copy outside the lock
        with self._lock:
            self._value = snap
            self._version += 1
            return self._version

    def pull(self):
        """Returns (value, version); value is None until the first push."""
        with self._lock:
            return self._value, self._version

    def pull_if_newer(self, version: int):
        """(value, current_version) when the store holds something newer
        than ``version``, else (None, current_version). The unchanged path
        is one lock + int compare."""
        with self._lock:
            if self._version == version or self._value is None:
                return None, self._version
            return self._value, self._version

    @property
    def version(self) -> int:
        with self._lock:
            return self._version


class BackpressureError(RuntimeError):
    """A bounded queue stayed full past its timeout: the consumer is not
    keeping up with its producers."""
