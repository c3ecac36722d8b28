"""Persisted tuning database — the torch twin of ``repro/tuner/db.py``.

A flat JSON file mapping ``(feature bucket, mesh shape, constraint set,
dtype)`` keys to the measured winning candidate.  With a warm database the
tuner runs no timed trial: ``launch/purify.py --tuning-db`` resolves
``engine="auto"`` by lookup alone, and ``plan.cache_stats()`` shows it
(``tuner_trials`` stays flat).

Key strings are the reference's for the same inputs; the file's schema is
the port's own (``SCHEMA``), so a file the reference wrote is refused at
load, as the reference refuses an unknown schema.  Records persist modes
only — engine, depth, backend, transport mode, group layout, assignment
mode — never capacities or permutations, which are re-derived from the
concrete pattern on every use.

Each record names the device that measured it (``device_tag``: ``"cpu"``
or ``"cuda:<card name>"``).  A lookup from another device is a miss: a
decision timed on the CPU never answers on the card.
"""
from __future__ import annotations

import json
import os
from typing import Any

SCHEMA = "repro_torch-tuning-db-v1"


def make_key(bucket: tuple, mesh_sig: tuple, constraints: tuple,
             dtype: str) -> str:
    """Deterministic string key (JSON object keys must be strings)."""
    return json.dumps(
        [list(bucket), [list(p) for p in mesh_sig], list(constraints), dtype],
        separators=(",", ":"),
    )


def device_tag(device) -> str:
    """The measuring device as a record stores it: ``"cpu"``, or
    ``"cuda:"`` and the card's name."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


class TuningDB:
    """In-memory record store with optional JSON persistence."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.records: dict[str, dict[str, Any]] = {}

    # ---- persistence ---------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "TuningDB":
        db = cls(path)
        with open(path) as f:
            data = json.load(f)
        if data.get("schema") != SCHEMA:
            raise ValueError(
                f"{path}: unknown tuning-db schema {data.get('schema')!r}"
            )
        db.records = data.get("records", {})
        return db

    @classmethod
    def load_or_create(cls, path: str) -> "TuningDB":
        """Warm-start from ``path`` when it exists, else an empty DB that
        will persist there on the first ``save()``."""
        if path and os.path.exists(path):
            return cls.load(path)
        return cls(path)

    def save(self, path: str | None = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("TuningDB has no path; pass save(path=...)")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"schema": SCHEMA, "records": self.records}, f,
                      indent=1, sort_keys=True)
        os.replace(tmp, path)  # atomic: readers never see a torn file
        self.path = path
        return path

    # ---- records -------------------------------------------------------
    def lookup(self, key: str, device: str | None = None) -> dict | None:
        """The record of ``key``; with ``device`` (a ``device_tag``), only
        one that device measured."""
        rec = self.records.get(key)
        if rec is not None and device is not None \
                and rec.get("device") != device:
            return None
        return rec

    def record(self, key: str, decision: dict) -> None:
        self.records[key] = decision
        if self.path:
            self.save()

    def __len__(self) -> int:
        return len(self.records)
