"""The sharded snapshot's commit record is never visible half written:
each process writes ``commit_pNNNNN.json`` under a ``.tmp`` name and
renames it once whole, because process 0 parses a record as soon as its
name exists (a record created empty and then filled was read as ``""``
under load in a whole tier-1 run)."""

import json
import os

import torch

from paddle_tpu_torch import fs as fs_lib
from paddle_tpu_torch.resilience.snapshot import SnapshotEngine


class _WatchingFS:
    """Local fs that records, for every write, whether the commit records
    it can see parse."""

    def __init__(self):
        self.inner = fs_lib.LocalFS()
        self.ops = []

    def open_write(self, path):
        self.ops.append(("open_write", os.path.basename(path)))
        return self.inner.open_write(path)

    def rename(self, src, dst, overwrite=True):
        self.ops.append(("rename", os.path.basename(src),
                         os.path.basename(dst)))
        return self.inner.rename(src, dst, overwrite)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_commit_record_is_renamed_into_place_whole(tmp_path):
    fs = _WatchingFS()
    eng = SnapshotEngine(str(tmp_path), fs=fs)
    eng.save(3, {"w": torch.arange(6.0)}, wait=True)
    eng.close()
    writes = [op[1] for op in fs.ops if op[0] == "open_write"]
    assert "commit_p00000.json.tmp" in writes
    assert "commit_p00000.json" not in writes
    assert ("rename", "commit_p00000.json.tmp", "commit_p00000.json") in \
        fs.ops
    sdir = next(p for p in tmp_path.iterdir() if p.name.startswith("step_"))
    names = {p.name for p in sdir.iterdir()}
    assert "commit_p00000.json" in names and not any(
        n.endswith(".tmp") for n in names)
    rec = json.loads((sdir / "commit_p00000.json").read_text())
    assert rec["file"] == "shards_p00000.pkl" and rec["process"] == 0
