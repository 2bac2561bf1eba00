"""Tensor-parallel serving (the reference engine's ``mesh=``/``tp=``
path, ``paddle_tpu/serving/engine.py``) on ``torch.distributed``.

Two pieces the engine stands on:

- the step-side weights of one rank (:func:`rank_layers`): the fused
  qkv projection ``(D, 3D)`` viewed head-major ``(D, 3, H, Dh)`` and the
  output projection ``(D, D)`` viewed ``(H, Dh, D)``, cut on the head
  axis by :func:`~paddle_tpu_torch.parallel.plan.serving_tp_plan` (and
  the MLP by :func:`~paddle_tpu_torch.parallel.plan.serving_prefill_tp_plan`
  on a prefill tier), through the same specs the reference hands
  ``device_put``;
- :class:`TpLink`, the control channel by which rank 0 leads. The
  reference has one controller and ``shard_map`` runs the shards; here
  rank 0's engine schedules, and before each device call it broadcasts a
  fixed int64 header (the operation and its bucket signature) and the
  call's int32 host inputs over a CPU gloo group kept beside the device
  group. Every other rank makes the same call on its heads
  (``ServingEngine.follow``). Page reads gather each rank's head slice
  to rank 0 over the CPU group; page writes scatter them from rank 0.
  A follower that raises leaves its traceback in the process group's
  store; rank 0's pending collective fails when the follower's process
  exits (at once) or at the group's timeout, and re-raises it
  (:class:`TpFollowerError`).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch.models.convert import params_tree
from paddle_tpu_torch.parallel import plan as plan_lib
from paddle_tpu_torch.parallel.collective import group_timeout

#: bucket kinds a header names by index: the signatures a tp engine
#: broadcasts (speculation is refused under tp; the probe twin is rank
#: 0's alone)
KINDS = ("decode", "prefill", "copy_page", "page_read", "page_write")
#: signature fields after the kind, by kind (decode: width; prefill:
#: width, lanes)
_SIG_FIELDS = {"decode": 1, "prefill": 2}

#: header operations
OP_STOP, OP_RUN, OP_BUILD, OP_READ, OP_WRITE = range(5)

#: int64 words of a header: op, kind, two signature fields, payload words
HEADER_WORDS = 5

_ERROR_KEY = "paddle_tpu_torch/tp_error/{}"


class TpFollowerError(RuntimeError):
    """A follower rank of a tensor-parallel engine failed; the message
    carries its traceback."""


def head_major_tree(model) -> Dict[str, dict]:
    """The reference's ``_make_tp_params`` tree of ``model``'s blocks
    (``{"blocks": {"0": {"attn": {"qkv_tp": ..., "out_tp": ...},
    "mlp": ...}}}``), as views of the model's tensors: qkv weight
    ``(D, 3, H, Dh)``, qkv bias ``(3, H, Dh)``, out weight ``(H, Dh,
    D)``; the MLP as it is."""
    cfg = model.cfg
    d, h = cfg.hidden_size, cfg.num_heads
    dh = d // h
    blocks = {}
    for i, blk in enumerate(model.blocks):
        qkv, out = blk.attn.qkv_proj, blk.attn.out_proj
        attn = {"qkv_tp": {"weight": qkv.weight.detach().view(d, 3, h, dh)},
                "out_tp": {"weight": out.weight.detach().view(h, dh, d)}}
        if qkv.bias is not None:
            attn["qkv_tp"]["bias"] = qkv.bias.detach().view(3, h, dh)
        if out.bias is not None:
            attn["out_tp"]["bias"] = out.bias.detach()
        mlp = params_tree(blk.mlp, {n: p.detach() for n, p
                                    in blk.mlp.named_parameters()})
        blocks[str(i)] = {"attn": attn, "mlp": mlp}
    return {"blocks": blocks}


def rank_layers(model, tp: int, index: int,
                mlp_sharded: bool) -> List[Dict[str, torch.Tensor]]:
    """Shard ``index`` of ``tp`` of each block's step-side weights, laid
    out for the step's matmuls: ``qkv_w`` ``(D, 3 * Hl * Dh)`` (columns
    q, k, v of the local heads), ``qkv_b``, ``out_w`` ``(Hl * Dh, D)``,
    ``out_b`` (whole: added once after the all-reduce), and on a prefill
    tier ``fc1_w`` ``(D, F/tp)``, ``fc1_b``, ``fc2_w`` ``(F/tp, D)``,
    ``fc2_b`` (whole). Copies, so the step reads contiguous tensors."""
    tree = head_major_tree(model)
    plan = (plan_lib.serving_prefill_tp_plan() if mlp_sharded
            else plan_lib.serving_tp_plan())
    specs = plan.params_specs(tree)
    coords = {"tp": (index, tp)}
    d = model.cfg.hidden_size

    def cut(path):
        node, spec = tree["blocks"], specs["blocks"]
        for key in path:
            node, spec = node[key], spec[key]
        return plan_lib.shard_slice(node, spec, coords).contiguous()

    layers = []
    for i in range(len(model.blocks)):
        b = str(i)
        lay = {"qkv_w": cut((b, "attn", "qkv_tp", "weight")).reshape(d, -1),
               "out_w": cut((b, "attn", "out_tp", "weight")).reshape(-1, d)}
        if "bias" in tree["blocks"][b]["attn"]["qkv_tp"]:
            lay["qkv_b"] = cut((b, "attn", "qkv_tp", "bias")).reshape(-1)
        if "bias" in tree["blocks"][b]["attn"]["out_tp"]:
            lay["out_b"] = cut((b, "attn", "out_tp", "bias"))
        if mlp_sharded:
            for name in ("fc1", "fc2"):
                lay[f"{name}_w"] = cut((b, "mlp", name, "weight"))
                lay[f"{name}_b"] = cut((b, "mlp", name, "bias"))
        layers.append(lay)
    return layers


def _tp_group_ranks(mesh) -> List[List[int]]:
    """Every "tp" group of ``mesh`` as global ranks, in a fixed order."""
    names = tuple(mesh.mesh_dim_names)
    grid = mesh.mesh.movedim(names.index("tp"), -1)
    return grid.reshape(-1, grid.shape[-1]).tolist()


class TpLink:
    """Rank 0's control channel to the other ranks of its "tp" group
    (module docstring). Every rank of the world makes one, in the same
    order (it makes one CPU gloo group per "tp" group of the mesh)."""

    def __init__(self, mesh):
        mesh_group = mesh.get_group("tp")
        self.rank = mesh.get_local_rank("tp")
        self.size = dist.get_world_size(mesh_group)
        self.lead = self.rank == 0
        # the engine's own groups, with the timeout the caller gave the
        # process group (a mesh's groups may carry the library default):
        # the device group on the mesh's backend for the step's
        # all-reduces, a gloo group on the CPU for the control channel
        timeout = group_timeout()
        kw = {"timeout": timeout} if timeout is not None else {}
        backend = dist.get_backend(mesh_group)
        mine = dist.get_process_group_ranks(mesh_group)
        self.dev_group = self.ctl = None
        for ranks in _tp_group_ranks(mesh):
            dev = dist.new_group(ranks, backend=backend, **kw)
            ctl = dist.new_group(ranks, backend="gloo", **kw)
            if ranks == mine:
                self.dev_group, self.ctl = dev, ctl
        self.ranks = mine
        self.leader = mine[0]
        self.stopped = False

    # -- leader side --------------------------------------------------------

    def _send(self, op: int, kind: int = 0, a: int = 0, b: int = 0,
              payload: Optional[np.ndarray] = None):
        n = 0 if payload is None else int(payload.size)
        hdr = torch.tensor([op, kind, a, b, n], dtype=torch.int64)
        dist.broadcast(hdr, src=self.leader, group=self.ctl)
        if n:
            dist.broadcast(torch.from_numpy(np.ascontiguousarray(
                payload, np.int32).reshape(-1)), src=self.leader,
                group=self.ctl)

    @staticmethod
    def _sig_words(sig) -> Tuple[int, int, int]:
        rest = tuple(sig[1:]) + (0, 0)
        return KINDS.index(sig[0]), int(rest[0]), int(rest[1])

    def send_run(self, sig, flat: np.ndarray):
        self._send(OP_RUN, *self._sig_words(sig), payload=flat)

    def send_build(self, sig):
        self._send(OP_BUILD, *self._sig_words(sig))

    def send_stop(self):
        if not self.stopped:
            self.stopped = True
            self._send(OP_STOP)

    def read_pages(self, pids: Sequence[int], read_local) -> List[tuple]:
        """Rank 0: broadcast the read of pages ``pids``, read this rank's
        head slice (``read_local(pids)``), gather every rank's and join
        them on the head axis (axis 3 of ``(2, L, ps, Hl, Dh)``); the
        scale rows of an int8 pool are whole on every rank and come from
        rank 0's read."""
        self._send(OP_READ, payload=np.asarray(pids, np.int32))
        local = read_local(pids)
        mine = _pack([p[0] for p in local])
        parts = [torch.empty_like(mine) for _ in range(self.size)]
        dist.gather(mine, parts, dst=self.leader, group=self.ctl)
        kv0 = local[0][0] if local else None
        out = []
        per_rank = [_unpack(t, kv0, len(local)) for t in parts]
        for k, page in enumerate(local):
            kv = np.concatenate([r[k] for r in per_rank], axis=3)
            out.append((kv,) + tuple(page[1:]))
        return out

    def write_pages(self, pids: Sequence[int], payloads: List[tuple],
                    heads: int) -> List[tuple]:
        """Rank 0: broadcast the write, scatter each rank its head slice
        of every page (with the scale rows of an int8 page), and return
        rank 0's own slices."""
        self._send(OP_WRITE, payload=np.asarray(pids, np.int32))
        slices = [[tuple([p[0][..., r * heads:(r + 1) * heads, :]]
                         + list(p[1:])) for p in payloads]
                  for r in range(self.size)]
        bufs = [_pack([a for p in pages for a in p]) for pages in slices]
        out = torch.empty_like(bufs[0])
        dist.scatter(out, bufs, src=self.leader, group=self.ctl)
        return slices[0]

    # -- follower side ------------------------------------------------------

    def recv(self):
        """Follower: the next header, as ``(op, sig, payload)``."""
        hdr = torch.zeros(HEADER_WORDS, dtype=torch.int64)
        dist.broadcast(hdr, src=self.leader, group=self.ctl)
        op, kind, a, b, n = (int(v) for v in hdr)
        payload = None
        if n:
            t = torch.zeros(n, dtype=torch.int32)
            dist.broadcast(t, src=self.leader, group=self.ctl)
            payload = t.numpy()
        sig = None
        if op in (OP_RUN, OP_BUILD):
            name = KINDS[kind]
            sig = (name,) + (a, b)[:_SIG_FIELDS.get(name, 0)]
        return op, sig, payload

    def give_pages(self, local: List[tuple]):
        """Follower: send this rank's head slices of a read to rank 0."""
        dist.gather(_pack([p[0] for p in local]), None, dst=self.leader,
                    group=self.ctl)

    def take_pages(self, like: List[tuple]) -> List[tuple]:
        """Follower: receive this rank's slices of a write; ``like``
        gives each page's arrays' shapes and dtypes."""
        flat = [a for p in like for a in p]
        buf = torch.empty(sum(a.nbytes for a in flat), dtype=torch.uint8)
        dist.scatter(buf, None, src=self.leader, group=self.ctl)
        raw = buf.numpy()
        out, at = [], 0
        for p in like:
            arrs = []
            for a in p:
                arrs.append(raw[at:at + a.nbytes].view(a.dtype)
                            .reshape(a.shape).copy())
                at += a.nbytes
            out.append(tuple(arrs))
        return out

    # -- failures -----------------------------------------------------------

    def report(self, text: str):
        """Follower: leave ``text`` (a traceback) in the process group's
        store for rank 0, whose pending collective fails when this
        process exits (or at the group's timeout)."""
        store = dist.distributed_c10d._get_default_store()
        store.set(_ERROR_KEY.format(dist.get_rank()), text)

    def follower_error(self, wait_s: float = 5.0) -> Optional[str]:
        """Rank 0, after a failed collective: the first follower
        traceback the store holds (waiting up to ``wait_s``), or None."""
        try:
            store = dist.distributed_c10d._get_default_store()
        except (RuntimeError, ValueError):
            return None
        keys = [_ERROR_KEY.format(r) for r in self.ranks[1:]]
        deadline = time.monotonic() + wait_s
        while True:
            for key in keys:
                if store.check([key]):
                    return store.get(key).decode()
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.05)


def _pack(arrays: Sequence[np.ndarray]) -> torch.Tensor:
    """Host arrays as one flat uint8 tensor (a copy)."""
    if not arrays:
        return torch.zeros(0, dtype=torch.uint8)
    return torch.from_numpy(np.concatenate(
        [np.ascontiguousarray(a).reshape(-1).view(np.uint8)
         for a in arrays]))


def _unpack(t: torch.Tensor, like: Optional[np.ndarray],
            n: int) -> List[np.ndarray]:
    """``n`` arrays shaped and typed like ``like`` from a flat uint8
    tensor of :func:`_pack`."""
    if like is None:
        return []
    raw = t.numpy()
    return [raw[k * like.nbytes:(k + 1) * like.nbytes].view(like.dtype)
            .reshape(like.shape) for k in range(n)]
