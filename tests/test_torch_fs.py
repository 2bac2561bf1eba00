"""The port's ``fs.HDFSClient`` against the reference's, on the CPU: a fake
``hadoop`` script first on ``PATH`` logs every command line and emulates
``-test`` and ``-ls`` (as ``tests/test_fs_nas.py:66-88`` does); both
clients must issue the same command lines and parse the same listings, a
failing command raises ``IOError`` with its stderr, and ``get_fs`` routes
``hdfs://`` and ``afs://`` to the client."""

import stat

import pytest

from paddle_tpu import fs as jfs
from paddle_tpu_torch import fs as pfs

STUB = """#!/bin/sh
echo "$@" >> "{log}"
last=""
for a in "$@"; do last="$a"; done
case "$*" in
  *-test*)
    case "$last" in *missing*) exit 1 ;; esac ;;
  *-ls*)
    echo "Found 3 items"
    echo "drwxr-xr-x   - u g          0 2026-01-01 00:00 hdfs://ns/a/sub"
    echo "-rw-r--r--   3 u g       1234 2026-01-01 00:00 hdfs://ns/a/f.txt"
    echo "-rw-r--r--   3 u g         12 2026-01-01 00:00 hdfs://ns/a/g/"
    ;;
esac
exit 0
"""


@pytest.fixture
def hadoop(tmp_path, monkeypatch):
    """A logging ``hadoop`` first on ``PATH``; returns its log path."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "calls.log"
    exe = bindir / "hadoop"
    exe.write_text(STUB.format(log=log))
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}:" + __import__("os").environ[
        "PATH"])
    return log


def _drive(client):
    out = [client.is_exist("hdfs://ns/a"), client.is_exist("hdfs://ns/missing"),
           client.is_file("hdfs://ns/a/f.txt"), client.is_dir("hdfs://ns/a")]
    client.mkdirs("hdfs://ns/a/b")
    client.upload("/tmp/x", "hdfs://ns/a/x")
    client.download("hdfs://ns/a/x", "/tmp/y")
    out.append(client.ls_dir("hdfs://ns/a"))
    client.rename("hdfs://ns/a/x", "hdfs://ns/a/z")
    client.rename("hdfs://ns/a/z", "hdfs://ns/missing", overwrite=False)
    client.delete("hdfs://ns/a/b")
    client.touch("hdfs://ns/a/_SUCCESS")
    return out


def test_command_lines_and_parsing_equal_the_reference(hadoop):
    conf = {"fs.defaultFS": "hdfs://ns", "hadoop.job.ugi": "u,g"}
    want = _drive(jfs.HDFSClient(configs=conf))
    want_calls = hadoop.read_text().splitlines()
    hadoop.unlink()
    got = _drive(pfs.HDFSClient(configs=conf))
    assert got == want
    assert hadoop.read_text().splitlines() == want_calls
    assert got[4] == (["sub"], ["f.txt", "g"])
    assert want_calls[0] == ("fs -D fs.defaultFS=hdfs://ns -D "
                             "hadoop.job.ugi=u,g -test -e hdfs://ns/a")
    assert "-put -f /tmp/x hdfs://ns/a/x" in want_calls[5]


def test_failure_raises_with_stderr(tmp_path):
    exe = tmp_path / "hadoop"
    exe.write_text("#!/bin/sh\necho boom >&2\nexit 3\n")
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    for mod in (jfs, pfs):
        c = mod.HDFSClient(hadoop_bin=str(exe))
        with pytest.raises(IOError, match="rc=3: boom"):
            c.mkdirs("hdfs://ns/x")
        assert c.is_exist("hdfs://ns/x") is False


@pytest.mark.parametrize("path", ["hdfs://ns/a", "afs://ns/a"])
def test_get_fs_routes_remote_paths_to_the_client(path):
    fs, p = pfs.get_fs(path, hadoop_bin="nope", timeout=5.0)
    assert isinstance(fs, pfs.HDFSClient) and p == path
    assert fs.hadoop_bin == "nope" and fs.timeout == 5.0
    fs, p = pfs.get_fs("file:///x/y")
    assert isinstance(fs, pfs.LocalFS) and p == "/x/y"
