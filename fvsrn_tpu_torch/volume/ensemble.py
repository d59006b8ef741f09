"""Ensemble and time-series volumes on disk, with an LRU cache.

Counterpart of ``fvsrn_tpu/volume/ensemble.py``: ``VolumeEnsembleFactory``
maps (ensemble, timestep) indices to ``.cvol`` filenames through a
printf-style format string with start and step offsets, loads them on
demand with ``Volume.load`` and keeps the latest loads in a bounded
``LRUCache``. Its settings round-trip through JSON; a factory read from
a file resolves relative filenames against the file's folder (``root``).
"""
from __future__ import annotations

import json
import os
import re
from collections import OrderedDict
from typing import Callable, Hashable, Optional

from .volume import Volume


class LRUCache:
    """A bounded cache that evicts its least recently used entry."""

    def __init__(self, capacity: int = 4):
        self.capacity = capacity
        self._store: OrderedDict = OrderedDict()

    def get(self, key: Hashable):
        if key not in self._store:
            return None
        self._store.move_to_end(key)
        return self._store[key]

    def put(self, key: Hashable, value):
        self._store[key] = value
        self._store.move_to_end(key)
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)

    def get_or_load(self, key: Hashable, loader: Callable):
        value = self.get(key)
        if value is None:
            value = loader(key)
            self.put(key, value)
        return value

    def __len__(self):
        return len(self._store)


class VolumeEnsembleFactory:
    def __init__(self, format_string: str = "", start_ensemble: int = 0,
                 num_ensembles: int = 1, start_timestep: int = 0,
                 num_timesteps: int = 1, step_ensemble: int = 1,
                 step_timestep: int = 1, root: str = "./",
                 cache_size: int = 4):
        self.format_string = format_string
        self.start_ensemble = start_ensemble
        self.num_ensembles = num_ensembles
        self.start_timestep = start_timestep
        self.num_timesteps = num_timesteps
        self.step_ensemble = step_ensemble
        self.step_timestep = step_timestep
        self.root = root
        self._cache = LRUCache(cache_size)

    def get_volume_filename(self, ensemble: int, time: int) -> str:
        """The format string applied to (start + step * index) of the
        ensemble and the timestep; a relative result is taken from
        ``root``. Indices out of range raise ``IndexError``."""
        if not 0 <= ensemble < self.num_ensembles:
            raise IndexError("ensemble out of bounds")
        if not 0 <= time < self.num_timesteps:
            raise IndexError("timestep out of bounds")
        e = self.start_ensemble + self.step_ensemble * ensemble
        t = self.start_timestep + self.step_timestep * time
        filename = _tinyformat(self.format_string, e, t)
        if not os.path.isabs(filename):
            filename = os.path.abspath(os.path.join(self.root, filename))
        return filename

    def load_volume(self, ensemble: int, time: int) -> Optional[Volume]:
        """The member's volume (cached), None when its file is missing."""
        filename = self.get_volume_filename(ensemble, time)

        def loader(_key):
            if not os.path.exists(filename):
                return None
            return Volume.load(filename)

        return self._cache.get_or_load((ensemble, time), loader)

    def save(self, filename: str):
        """The settings as JSON (the reference's keys; not ``root``)."""
        with open(filename, "w") as f:
            json.dump({
                "formatString": self.format_string,
                "startEnsemble": self.start_ensemble,
                "stepEnsemble": self.step_ensemble,
                "numEnsembles": self.num_ensembles,
                "startTimestep": self.start_timestep,
                "stepTimestep": self.step_timestep,
                "numTimesteps": self.num_timesteps,
            }, f, indent=2)

    @classmethod
    def from_file(cls, filename: str) -> "VolumeEnsembleFactory":
        """The factory of a JSON settings file, ``root`` its folder."""
        with open(filename) as f:
            j = json.load(f)
        return cls(format_string=j.get("formatString", ""),
                   start_ensemble=j.get("startEnsemble", 0),
                   num_ensembles=j.get("numEnsembles", 1),
                   start_timestep=j.get("startTimestep", 0),
                   num_timesteps=j.get("numTimesteps", 1),
                   step_ensemble=j.get("stepEnsemble", 1),
                   step_timestep=j.get("stepTimestep", 1),
                   root=os.path.dirname(os.path.abspath(filename)))


def _tinyformat(fmt: str, *args) -> str:
    """printf-style formatting of a filename template (%d, %04d, %s, ...),
    as many arguments as it has conversions (a template may name the
    ensemble alone); ``%%`` takes none."""
    n = len(re.findall(r"%[-+0-9.# ]*[a-zA-Z]", fmt.replace("%%", "")))
    return fmt % args[:n] if n else fmt
