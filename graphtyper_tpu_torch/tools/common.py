"""What the measurement tools share: the directory that holds the package,
the environment of the child processes they start, and the md5 of a run's
VCF records that every tool compares runs by."""

from __future__ import annotations

import gzip
import hashlib
import os

#: the directory that holds the package and tests/data
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def child_env(**extra: str) -> dict:
    """This process's environment with ROOT first on PYTHONPATH, so a child
    started from any directory imports this checkout's package; `extra`
    entries are set on top."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def records_md5(paths) -> tuple[str, int]:
    """md5 of the record lines of the VCFs (headers dropped) and their count."""
    h = hashlib.md5()
    n_records = 0
    for p in sorted(paths):
        with gzip.open(p, "rt") as f:
            for line in f:
                if not line.startswith("#"):
                    h.update(line.encode())
                    n_records += 1
    return h.hexdigest(), n_records
