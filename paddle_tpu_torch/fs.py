"""Filesystem abstraction (``paddle_tpu/fs.py``, local half):
:class:`LocalFS` and :func:`get_fs`, which routes a plain path or a
``file://`` URL to it. The reference's ``HDFSClient`` (``hdfs://`` and
``afs://`` through the ``hadoop fs`` command line) is not ported yet (see
ROADMAP); such a path raises.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Tuple


class LocalFS:
    """The local filesystem, with the reference's method names."""

    def is_exist(self, path: str) -> bool:
        return os.path.exists(path)

    def is_file(self, path: str) -> bool:
        return os.path.isfile(path)

    def is_dir(self, path: str) -> bool:
        return os.path.isdir(path)

    def ls_dir(self, path: str) -> Tuple[List[str], List[str]]:
        """Returns (dirs, files) names within ``path``."""
        if not os.path.isdir(path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, name))
             else files).append(name)
        return dirs, files

    def mkdirs(self, path: str):
        os.makedirs(path, exist_ok=True)

    def delete(self, path: str):
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def rename(self, src: str, dst: str, overwrite: bool = True):
        if not overwrite and os.path.exists(dst):
            raise IOError(f"rename target exists: {dst}")
        os.replace(src, dst)

    def upload(self, local: str, remote: str):
        shutil.copy2(local, remote)

    def download(self, remote: str, local: str):
        shutil.copy2(remote, local)

    def open_read(self, path: str):
        return open(path, "rb")

    def open_write(self, path: str):
        return open(path, "wb")

    def touch(self, path: str):
        with open(path, "a"):
            os.utime(path)


def get_fs(path: str):
    """Route a path to its filesystem: returns (fs, path without the
    ``file://`` scheme). ``hdfs://`` and ``afs://`` raise
    ``NotImplementedError``."""
    if path.startswith(("hdfs://", "afs://")):
        raise NotImplementedError(
            f"{path}: the HDFS client is not ported yet (ROADMAP)")
    if path.startswith("file://"):
        return LocalFS(), path[len("file://"):]
    return LocalFS(), path
