"""Durable small-file writes (the counterpart of ``fedcrack_tpu.ioutils``)."""

from __future__ import annotations

import os


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` so the file is never seen torn: a temp
    file in the same directory, fsync, then ``os.replace``; the directory
    fsync after it is best effort. A crash before the rename leaves the old
    file and a ``*.tmp.*`` sibling that readers ignore."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # no directory fsync on this platform; the rename is still atomic
