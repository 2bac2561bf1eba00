"""Filesystem abstraction (``paddle_tpu/fs.py``): :class:`LocalFS`,
:class:`HDFSClient` (``hdfs://`` and ``afs://`` through the ``hadoop fs``
command line, as the reference's fleet utils drive it; no libhdfs), and
:func:`get_fs`, which routes a path to one of them.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional, Tuple


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


class HDFSClient:
    """HDFS via the hadoop CLI (fleet utils ``HDFSClient`` parity: the
    reference builds ``hadoop fs [-D k=v ...] -<cmd>`` command lines
    exactly like this). A failed command raises ``IOError`` with the tail
    of its stderr; the ``-test`` probes return a bool."""

    def __init__(self, hadoop_bin: str = "hadoop",
                 configs: Optional[dict] = None, *, timeout: float = 300.0):
        self.hadoop_bin = hadoop_bin
        self.configs = dict(configs or {})
        self.timeout = timeout

    def _base(self) -> List[str]:
        cmd = [self.hadoop_bin, "fs"]
        for k, v in self.configs.items():
            cmd += ["-D", f"{k}={v}"]
        return cmd

    def _run(self, *args, check=True) -> subprocess.CompletedProcess:
        proc = subprocess.run(self._base() + list(args),
                              capture_output=True, text=True,
                              timeout=self.timeout)
        if check and proc.returncode != 0:
            raise IOError(
                f"hadoop fs {' '.join(args)} failed rc={proc.returncode}: "
                f"{proc.stderr.strip()[-500:]}")
        return proc

    def is_exist(self, path: str) -> bool:
        return self._run("-test", "-e", path, check=False).returncode == 0

    def is_file(self, path: str) -> bool:
        return self._run("-test", "-f", path, check=False).returncode == 0

    def is_dir(self, path: str) -> bool:
        return self._run("-test", "-d", path, check=False).returncode == 0

    def ls_dir(self, path: str) -> Tuple[List[str], List[str]]:
        """Returns (dirs, files) names within ``path``, parsed from
        ``-ls`` lines (header and short lines skipped)."""
        proc = self._run("-ls", path, check=False)
        dirs, files = [], []
        for line in proc.stdout.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue  # header/noise
            name = parts[-1].rstrip("/").rsplit("/", 1)[-1]
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def mkdirs(self, path: str):
        self._run("-mkdir", "-p", path)

    def delete(self, path: str):
        self._run("-rm", "-r", "-f", path)

    def rename(self, src: str, dst: str, overwrite: bool = True):
        # hadoop -mv refuses an existing target; LocalFS's default
        # overwrites, so checkpoint rotation behaves alike on both
        if overwrite and self.is_exist(dst):
            self.delete(dst)
        self._run("-mv", src, dst)

    def upload(self, local: str, remote: str):
        self._run("-put", "-f", local, remote)

    def download(self, remote: str, local: str):
        self._run("-get", remote, local)

    def touch(self, path: str):
        self._run("-touchz", path)


def get_fs(path: str, **hdfs_kwargs):
    """Route a path to its filesystem: ``hdfs://`` or ``afs://`` -> an
    :class:`HDFSClient` (``hdfs_kwargs`` go to it); anything else
    (``file://`` included) -> :class:`LocalFS`. Returns (fs, path without
    the ``file://`` scheme)."""
    if path.startswith(("hdfs://", "afs://")):
        return HDFSClient(**hdfs_kwargs), path
    if path.startswith("file://"):
        return LocalFS(), path[len("file://"):]
    return LocalFS(), path
