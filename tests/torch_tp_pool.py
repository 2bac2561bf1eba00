"""A pool of spawned ranks for the port's multi-rank CPU tests, and the
cases they run.

``TpPool(n)`` spawns ``n`` processes once (a test module's fixture), each
joining one gloo process group through a TCP store the parent holds on
``127.0.0.1`` (bound to a port the kernel picks, so pools started at once
by parallel test workers never race for a port); ``pool.run(case,
timeout_s, **kw)`` runs ``case(rank, n, **kw)`` (a function of this
module) on every rank at once and returns the ranks' results. Each run
has its own timeout; a rank's traceback or a timeout fails the run and
the pool restarts for the next one. The ranks import the port and numpy
only: no jax.

The serving cases build the same engine on every rank; rank 0 drives it
(``submit``, ``step``, snapshots) and closes it, the others ``follow()``.
"""

import datetime
import multiprocessing as mp
import time
import traceback

import numpy as np

#: each rank's process-group timeout: a rank stuck in a collective fails
#: within it
GROUP_TIMEOUT_S = 60


def _worker(rank, n, port, conn):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    store = dist.TCPStore("127.0.0.1", port, is_master=False,
                          timeout=timeout)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=n,
                            timeout=timeout)
    while True:
        msg = conn.recv()
        if msg is None:
            break
        name, kw = msg
        try:
            conn.send(("ok", globals()[name](rank, n, **kw)))
        except BaseException:
            conn.send(("err", traceback.format_exc()))
            break
    if dist.is_initialized():
        dist.destroy_process_group()


class TpPool:
    """``n`` spawned ranks in one gloo group (module docstring)."""

    def __init__(self, n: int):
        self.n = n
        self._procs = []
        self._conns = []
        self._broken = False
        self._store = None

    def _start(self):
        import torch.distributed as dist
        ctx = mp.get_context("spawn")
        # the group's store lives here, on a port bound at once (port 0):
        # a port picked free and closed again could be taken by another
        # process before rank 0 listened on it
        self._store = dist.TCPStore(
            "127.0.0.1", 0, world_size=self.n + 1, is_master=True,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
            wait_for_workers=False)
        port = self._store.port
        for r in range(self.n):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_worker, args=(r, self.n, port, child),
                            daemon=True)
            p.start()
            child.close()
            self._procs.append(p)
            self._conns.append(parent)

    def run(self, case: str, timeout_s: float = 60, expect_errors=False,
            **kw):
        """``case`` on every rank; returns the ranks' results in rank
        order. Raises AssertionError with every failing rank's traceback,
        or on a timeout (the pool is then restarted). With
        ``expect_errors`` a failing rank's result is its traceback, and
        only a timeout raises."""
        if not self._procs:
            self._start()
        for c in self._conns:
            c.send((case, kw))
        deadline = time.monotonic() + timeout_s
        results, errors = [None] * self.n, []
        for r, c in enumerate(self._conns):
            left = deadline - time.monotonic()
            if left <= 0 or not c.poll(left):
                errors.append(f"rank {r}: no answer within {timeout_s} s")
                continue
            try:
                status, val = c.recv()
            except (EOFError, OSError):
                errors.append(f"rank {r}: exited")
                continue
            if status == "ok":
                results[r] = val
            elif expect_errors:
                results[r] = val
                self._broken = True
            else:
                errors.append(f"rank {r}:\n{val}")
        if errors or self._broken:
            self.close()
        if errors:
            raise AssertionError(f"{case} failed:\n" + "\n".join(errors))
        return results

    def close(self):
        for c in self._conns:
            try:
                c.send(None)
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
        self._procs, self._conns, self._broken = [], [], False
        self._store = None


# ---------------------------------------------------------------------------
# cases: run on every rank
# ---------------------------------------------------------------------------

def _mesh(n, device_type="cpu", **sizes):
    from paddle_tpu_torch.core import mesh as mesh_lib
    return mesh_lib.make_mesh(mesh_lib.MeshConfig(**(sizes or {"tp": n})),
                              device_type=device_type)


def mesh_info(rank, n):
    from paddle_tpu_torch.core import mesh as mesh_lib
    m = _mesh(n)
    out = {"names": tuple(m.mesh_dim_names), "shape": tuple(m.shape),
           "tp_index": mesh_lib.axis_index(m, "tp"),
           "sizes": {a: mesh_lib.axis_size(m, a) for a in mesh_lib.ALL_AXES}}
    try:
        mesh_lib.make_mesh(mesh_lib.MeshConfig(tp=n + 1), device_type="cpu")
    except ValueError as e:
        out["refused"] = str(e)
    with mesh_lib.mesh_context(m):
        out["current"] = mesh_lib.current_mesh() is m
    out["after"] = mesh_lib.current_mesh() is None
    return out


def _local_input(seed, rank, shape=(4, 6)):
    return np.random.default_rng(seed + rank).standard_normal(
        shape).astype(np.float32)


def collective(rank, n, op, seed):
    """One collective over this rank's seeded input; returns the output."""
    import torch
    from paddle_tpu_torch.core import mesh as mesh_lib
    from paddle_tpu_torch.parallel import collective as C
    x = torch.from_numpy(_local_input(seed, rank))
    if op == "hierarchical":
        m = mesh_lib.make_mesh(axis_names=("dcn", "dp"), shape=(2, n // 2),
                               device_type="cpu")
        return C.hierarchical_all_reduce(x, ici_axis="dp", dcn_axis="dcn",
                                         mesh=m).numpy()
    m = _mesh(n)
    with mesh_lib.mesh_context(m):
        if op in ("sum", "max", "min", "prod"):
            out = C.all_reduce(x, "tp", op=op)
        elif op == "sum_over_two_axes":
            out = C.all_reduce(x, ("dp", "tp"))
        elif op == "all_gather":
            out = C.all_gather(x, "tp", concat_axis=1)
        elif op == "reduce_scatter":
            out = C.reduce_scatter(x, "tp", scatter_axis=0)
        elif op == "broadcast":
            out = C.broadcast(x, "tp", root=n - 1)
        elif op == "all_to_all":
            out = C.all_to_all(x, "tp", split_axis=0, concat_axis=1)
        elif op == "ppermute":
            out = C.ppermute(x, "tp", [(i, (i + 1) % n) for i in range(n)])
        elif op == "ppermute_partial":
            out = C.ppermute(x, "tp", [(0, n - 1)])
        elif op == "barrier":
            C.barrier("tp")
            out = x
        else:
            raise ValueError(op)
        assert np.array_equal(x.numpy(), _local_input(seed, rank)), \
            "the input changed"
        return out.numpy()


def local_shards(rank, n, tensors, specs, sizes):
    """Each (tensor, spec) pair's slice on this rank of a mesh ``sizes``."""
    import torch
    from paddle_tpu_torch.parallel.plan import local_shard
    m = _mesh(n, **sizes)
    return [local_shard(torch.from_numpy(t), s, m).numpy()
            for t, s in zip(tensors, specs)]


def quantize(rank, n, x):
    """``quantize_kv`` of this rank's heads with the tp group's MAX
    all-reduce, and without it."""
    import torch
    from paddle_tpu_torch.serving.paged_cache import quantize_kv
    m = _mesh(n)
    hl = x.shape[1] // n
    xl = torch.from_numpy(x[:, rank * hl:(rank + 1) * hl])
    q, s = quantize_kv(xl, (1, 2), group=m.get_group("tp"))
    q_local, s_local = quantize_kv(xl, (1, 2))
    return q.numpy(), s.numpy(), s_local.numpy()


def _model(params, dims, device="cpu"):
    """The GPT of the JAX weights ``params`` (a numpy tree), or with
    ``params`` None one made from seed 0."""
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    if params is None:
        return GPT(GPTConfig(**dims), device=device, seed=0)
    return GPT.from_jax(GPTConfig(**dims), params, device=device)


def _engine(model, n, mesh=None, **kw):
    import torch
    from paddle_tpu_torch.inference import make_serving_engine
    from paddle_tpu_torch.observability import MetricsRegistry
    if kw.get("cache_dtype") == "int8":
        kw["cache_dtype"] = torch.int8
    if kw.get("tp", n) > 1 and not kw.get("tp_probe"):
        kw.setdefault("mesh", mesh if mesh is not None
                      else _mesh(n, model.device.type))
    return make_serving_engine(model, device=model.device,
                               registry=MetricsRegistry(), **kw)


def _drain(eng, out=None):
    out = {} if out is None else out
    while not eng.scheduler.idle():
        out.update(eng.step())
    return out


def _pages(eng):
    return [[t.cpu().numpy().copy() for t in layer]
            for layer in eng.cache.pages]


def serve(rank, n, params, dims, engine_kw, waves, cap=16, eos=7,
          warm=False, report=(), device="cpu"):
    """Build the engine on every rank; rank 0 serves ``waves`` (lists of
    prompts, each wave drained before the next) and returns the tokens
    with what ``report`` names; every rank returns its builds, pages or
    collective counts where asked. A tp=1 engine runs on rank 0 alone."""
    if engine_kw.get("tp") == 1 and rank:
        return {}
    if device != "cpu":
        import torch
        torch.cuda.set_device(torch.device(device))
    model = _model(params, dims, device)
    eng = _engine(model, n, **engine_kw)
    out = {}
    if eng._lead:
        if warm:
            eng.warmup(cost_gauges=False)
        out["tokens"] = []
        for wave in waves:
            got = eng.generate_many(wave, cap, eos_id=eos)
            out["tokens"].append([np.asarray(t) for t in got])
        eng.close()
        for key in report:
            if key == "health":
                out[key] = eng.health()
            elif key == "plan":
                out[key] = (eng.warmup_plan(),
                            sorted(eng.reachable_signatures()),
                            sorted(eng.warmed_signatures))
            elif key == "recompiles":
                out[key] = eng.recompile_detector.recompiles
            elif key == "shared":
                out[key] = int(eng.cache.shared_tokens_total)
            elif key == "anatomy":
                out[key] = (eng.anatomy.records(), eng.anatomy.summary())
    else:
        eng.follow()
    if "builds" in report:
        out["builds"] = eng.graphs.builds
    if "pages" in report:
        out["pages"] = _pages(eng)
    if "launches" in report:
        from paddle_tpu_torch.kernels import registry
        out["launches"] = registry.launch_counts()
    if "all_reduces" in report:
        out["all_reduces"] = dict(eng.tp_all_reduces)
    return out


def handoff(rank, n, params, dims, engine_kw, prompts, cap=16, eos=7):
    """A prefill tier under tp (the Megatron MLP split) hands every
    prompt to a decode tier of the same group: rank 0 returns the tokens
    and both tiers' all-reduce counts."""
    model = _model(params, dims)
    pre = _engine(model, n, tier="prefill", **engine_kw)
    out = {}
    if pre._lead:
        rids = [pre.submit(p, cap, eos) for p in prompts]
        snaps, early = {}, {}
        while not pre.scheduler.idle():
            early.update(pre.step())
            snaps.update(pre.poll_handoffs())
        pre.close()
        out["mlp_sharded"] = pre._mlp_sharded
    else:
        pre.follow()
    out["prefill_all_reduces"] = dict(pre.tp_all_reduces)
    dec = _engine(model, n, tier="decode", **engine_kw)
    if dec._lead:
        new, done = {}, {}
        todo = [r for r in rids if r in snaps]
        while todo or not dec.scheduler.idle():
            while todo and dec.scheduler.free_slots():
                rid = todo.pop(0)
                new[rid] = dec.restore_slot(snaps[rid])
            done.update(dec.step())
        dec.close()
        out["tokens"] = [early[r] if r in early else done[new[r]]
                         for r in rids]
        out["decode_mlp_sharded"] = dec._mlp_sharded
    else:
        dec.follow()
    out["decode_all_reduces"] = dict(dec.tp_all_reduces)
    return out


def refuse_mesh_tp(rank, n, params, dims):
    """A mesh whose tp axis disagrees with ``tp=`` is refused."""
    model = _model(params, dims)
    try:
        _engine(model, n, mesh=_mesh(n), tp=2 * n)
    except ValueError as e:
        return str(e)
    return None


def migrate(rank, n, params, dims, engine_kw, prompt, new_tokens,
            jax_snap=None, corrupt=False):
    """Mid-decode snapshot of ``prompt`` on a tp engine, released and
    restored into a second tp engine of the group, drained; plus a clean
    run and, with ``jax_snap``, the restore of a JAX tp snapshot. Rank 0
    returns the snapshots, the re-snapshots' digests and the tokens."""
    model = _model(params, dims)
    out = {}
    src = _engine(model, n, **engine_kw)
    if src._lead:
        src.submit(prompt, new_tokens)
        for _ in range(2):
            src.step()          # prefill + one decode block: mid-decode
        snap = src.snapshot_slot(0)
        src.release_slot(0)
        src.close()
        out["snap"] = snap
    else:
        src.follow()
    dst = _engine(model, n, **engine_kw)
    if dst._lead:
        nrid = dst.restore_slot(snap)
        again = dst.snapshot_slot(0)
        out["again"] = [r["sha256"] for r in again["manifest"]]
        out["tokens"] = _drain(dst)[nrid]
        if jax_snap is not None:
            jrid = dst.restore_slot(jax_snap)
            out["jax_again"] = dst.snapshot_slot(0)
            out["jax_tokens"] = _drain(dst)[jrid]
        if corrupt:
            bad = dict(snap, shards=list(snap["shards"]))
            bad["shards"][1] = np.zeros_like(np.asarray(snap["shards"][1]))
            in_use = dst.cache.pages_in_use
            try:
                dst.restore_slot(bad)
            except Exception as e:      # noqa: BLE001 - returned to the test
                out["corrupt"] = (type(e).__name__, str(e))
            out["pages_unchanged"] = dst.cache.pages_in_use == in_use
        dst.close()
    else:
        dst.follow()
    clean = _engine(model, n, **engine_kw)
    if clean._lead:
        out["clean"] = clean.generate_many([prompt], new_tokens)[0]
        clean.close()
    else:
        clean.follow()
    return out


def fleet_chips(rank, n, params, dims):
    """A router over a tp replica and a plain one counts its chips."""
    model = _model(params, dims)
    eng = _engine(model, n)
    if not eng._lead:
        eng.follow()
        return None
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.serving import fleet
    reps = [fleet.LocalReplica(eng, name="tp"),
            fleet.LocalReplica(_engine(model, 1, tp=1), name="plain")]
    h = fleet.FleetRouter(reps, registry=MetricsRegistry()).health()
    eng.close()
    return {"chips_total": h["chips_total"],
            "per": {k: v["mesh_devices"] for k, v in h["per_replica"].items()}}


def follower_fails(rank, n, params, dims):
    """A follower that raises at its second device call (the first
    decode block): rank 0's call re-raises its traceback instead of
    waiting out the group timeout."""
    model = _model(params, dims)
    eng = _engine(model, n)
    if eng._lead:
        t0 = time.monotonic()
        try:
            eng.generate_many([np.arange(1, 9, dtype=np.int32)], 24)
        except Exception as e:      # noqa: BLE001 - returned to the test
            return {"error": type(e).__name__, "text": str(e),
                    "s": time.monotonic() - t0}
        eng.close()
        return {"error": None}
    calls = [0]
    run = eng.graphs.run

    def failing(*a, **k):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("injected follower fault")
        return run(*a, **k)
    eng.graphs.run = failing
    eng.follow()            # raises: this rank's process then exits


# -- training across ranks: ring attention, sharded steps, LocalSGD ---------

def _sp_block(x, rank, n, dim=2):
    import torch
    if x is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(
        np.split(x, n, axis=dim)[rank]))


def ring(rank, n, q, k, v, do, bias=None, causal=False, impl="auto",
         count_blocks=False):
    """This rank's blocks of the global q, k, v (and key bias) through
    ``ring_attention`` on an sp=n mesh, the backward seeded with its
    block of ``do``. Returns the rank's output and dq/dk/dv blocks, the
    ring's case counts and, with ``count_blocks``, every plain block
    call (its causal flag, and whether its lse and delta are the merged
    forward's)."""
    import torch
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.parallel import ring_attention as R
    mesh = _mesh(n, sp=n)
    ql, kl, vl = (_sp_block(t, rank, n).requires_grad_() for t in (q, k, v))
    bl = _sp_block(bias, rank, n, dim=3)
    calls = {"fwd": [], "bwd": []}
    saved = {}
    if count_blocks:
        fwd_plain, bwd_parts = A.flash_fwd_plain, A._flash_bwd_parts

        def fwd(*a, causal=False, **kw):
            calls["fwd"].append(bool(causal))
            return fwd_plain(*a, causal=causal, **kw)

        def bwd(q_, k_, v_, b_, g_, lse, delta, causal=False, **kw):
            calls["bwd"].append((bool(causal), lse.data_ptr(),
                                 delta.clone().numpy()))
            return bwd_parts(q_, k_, v_, b_, g_, lse, delta, causal=causal,
                             **kw)
        A.flash_fwd_plain, A._flash_bwd_parts = fwd, bwd
    R.reset_ring_stats()
    try:
        out = R.ring_attention(ql, kl, vl, bias=bl, causal=causal,
                               mesh=mesh, impl=impl)
        g = _sp_block(do, rank, n)
        out.backward(g)
    finally:
        if count_blocks:
            A.flash_fwd_plain, A._flash_bwd_parts = fwd_plain, bwd_parts
    res = {"out": out.detach().numpy(), "dq": ql.grad.numpy(),
           "dk": kl.grad.numpy(), "dv": vl.grad.numpy(),
           "stats": R.ring_stats()}
    if count_blocks:
        delta = A.flash_delta(g, out.detach()).numpy()
        res["fwd_calls"] = calls["fwd"]
        res["bwd_causal"] = [c for c, _, _ in calls["bwd"]]
        res["bwd_one_lse"] = len({p for _, p, _ in calls["bwd"]}) <= 1
        res["bwd_global_delta"] = all(np.array_equal(d, delta)
                                      for _, _, d in calls["bwd"])
    return res


def ring_parity(rank, n, seed):
    """The registered ``ring_attention`` entry's battery on an sp=n mesh
    (CPU legs)."""
    from paddle_tpu_torch.kernels import harness
    from paddle_tpu_torch.core import mesh as mesh_lib
    mesh = _mesh(n, sp=n)
    with mesh_lib.mesh_context(mesh):
        return harness.parity_check("ring_attention", seed)


def _toy_model(params):
    """The reference's parity model (``tests/test_parallel.py``):
    Linear(16, 32) (column hint), an empty Sequential, Linear(32, 4)
    (no hint), from the JAX weights."""
    import torch
    from paddle_tpu_torch.models.convert import state_from_jax
    from paddle_tpu_torch.nn import Linear

    class Toy(torch.nn.Module):          # the reference's {"layers": ...}
        def __init__(self):
            super().__init__()
            self.layers = torch.nn.Sequential(
                Linear(16, 32), torch.nn.Sequential(),
                Linear(32, 4, sharding=None))

        def forward(self, x):
            return self.layers(x)

    model = Toy()
    model.load_state_dict(state_from_jax(params))
    return model


def _toy_loss(m, x, y):
    import torch.nn.functional as Fn
    return Fn.cross_entropy(m(x), y.long())


def _bert_loss(m, **b):
    return m.loss(**b)


#: clip norms below the toy's gradient norms, so that the clips act
CLIP_NORM = {"global": 0.1, "tensor": 0.05}


def _optimizer(name, params, lr):
    """An optimizer of the port by name: "adam", "momentum",
    "adam_global_clip" (``GradientClipByGlobalNorm``),
    "momentum_global_clip",
    "momentum_norm_clip" (``GradientClipByNorm``), "lamb" or "lars"."""
    from paddle_tpu_torch import optimizer as o
    return {
        "adam": lambda: o.Adam(params, learning_rate=lr),
        "momentum": lambda: o.Momentum(params, learning_rate=lr,
                                       momentum=0.9),
        "adam_global_clip": lambda: o.Adam(
            params, learning_rate=lr,
            grad_clip=o.GradientClipByGlobalNorm(CLIP_NORM["global"])),
        "momentum_norm_clip": lambda: o.Momentum(
            params, learning_rate=lr, momentum=0.9,
            grad_clip=o.GradientClipByNorm(CLIP_NORM["tensor"])),
        "momentum_global_clip": lambda: o.Momentum(
            params, learning_rate=lr, momentum=0.9,
            grad_clip=o.GradientClipByGlobalNorm(CLIP_NORM["global"])),
        "lamb": lambda: o.Lamb(params, learning_rate=lr),
        "lars": lambda: o.LarsMomentum(params, learning_rate=lr),
    }[name]()


def sharded_train(rank, n, params, model, sizes, plan_name, batch, steps,
                  opt="adam", lr=1e-2, hints=False, seq_dim=None,
                  cfg=None, local_sgd=0, gather=False):
    """``steps`` steps of the port's ``shard_train_step`` on a mesh of
    ``sizes``: ``model`` "toy" or "bert" (``cfg``: BertConfig fields)
    from the JAX weights ``params``, ``plan_name`` "replicated", "fsdp"
    or "megatron" (with ``hints``, the layers' own), every rank fed the
    global ``batch``; ``opt`` a name of :func:`_optimizer`.
    ``local_sgd=k``: no sharded step; each rank steps
    on its own block of the batch and averages over "dp" when ``step %
    k == 0``. Returns the losses (and, with ``gather``, the parameters
    whole again)."""
    import torch
    from paddle_tpu_torch import train
    from paddle_tpu_torch.core import mesh as mesh_lib
    from paddle_tpu_torch.nn.module import sharding_specs
    from paddle_tpu_torch.optimizer.compression import LocalSGD
    from paddle_tpu_torch.parallel import api, plan as plan_lib
    if model == "toy":
        m, loss_fn = _toy_model(params), _toy_loss
    else:
        from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
        m = BertForPretraining.from_jax(BertConfig.tiny(**cfg), params,
                                        device="cpu")
        loss_fn = _bert_loss
    o = _optimizer(opt, m.parameters(), lr)
    step = train.build_train_step(loss_fn, o)
    state = train.make_train_state(m, o)
    feeds = {k: torch.from_numpy(v) for k, v in batch.items()}
    mesh = _mesh(n, **sizes)
    losses = []
    if local_sgd:
        avg = LocalSGD(k_steps=local_sgd, axis="dp")
        local = api.local_batch(feeds, mesh)
        synced = []
        for i in range(steps):
            if avg.maybe_average(m.parameters(), i, mesh=mesh):
                synced.append([p.detach().numpy().copy()
                               for p in m.parameters()])
            state, met = step(state, **local)
            losses.append(float(met["loss"]))
        return {"losses": losses, "synced": synced,
                "final": [p.detach().numpy() for p in m.parameters()]}
    plan = {"replicated": plan_lib.replicated_plan,
            "fsdp": lambda: plan_lib.fsdp_plan(min_size=128),
            "megatron": plan_lib.megatron_plan}[plan_name]()
    spec = api.batch_specs(feeds, seq_dim=seq_dim) if seq_dim else \
        api.BATCH_SPEC
    run, placed = api.shard_train_step(
        step, mesh, state, plan=plan,
        hints=sharding_specs(m) if hints else {"params": None},
        batch_spec=spec)
    for _ in range(steps):
        placed, met = run(placed, **feeds)
        losses.append({k: float(v) for k, v in met.items()})
    out = {"losses": losses,
           "local_shapes": {k: tuple(p.shape)
                            for k, p in m.named_parameters()},
           "specs": run.specs}
    if gather:
        out["params"] = {k: v.numpy() for k, v in
                         api.gathered_params(m, run.specs, mesh).items()}
    return out


def bert_ring(rank, n, params, cfg, ids, mask=None):
    """``BertModel(attn_impl="ring")`` of the JAX weights on an sp=n mesh:
    this rank's block of ``ids`` (and of the valid-key ``mask``) in,
    this rank's sequence output and the pooled output out."""
    import torch
    from paddle_tpu_torch.core import mesh as mesh_lib
    from paddle_tpu_torch.models.bert import BertConfig, BertModel
    from paddle_tpu_torch.models.convert import state_from_jax
    model = BertModel(BertConfig.tiny(**cfg), device="cpu")
    model.load_state_dict(state_from_jax(params))
    mesh = _mesh(n, sp=n)
    blk = lambda a: None if a is None else _sp_block(a, rank, n, dim=1)
    with torch.no_grad(), mesh_lib.mesh_context(mesh):
        seq, pooled = model(blk(ids), attention_mask=blk(mask))
    return seq.numpy(), pooled.numpy()


def local_sgd_average(rank, n, k, steps, seed):
    """Each rank's seeded parameters (different on every rank) through
    ``LocalSGD(k).maybe_average`` at steps ``0..steps-1``, with a seeded
    rank-own drift added after each step: the parameters after each
    call, and whether it averaged."""
    import torch
    from paddle_tpu_torch.optimizer.compression import LocalSGD
    mesh = _mesh(n, dp=n)
    rng = np.random.default_rng(seed + rank)
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in ((3, 4), (5,))]
    avg = LocalSGD(k_steps=k, axis="dp")
    out = []
    for step in range(steps):
        did = avg.maybe_average(params, step, mesh=mesh)
        out.append((did, [p.numpy().copy() for p in params]))
        for p in params:
            p.add_(torch.from_numpy(rng.standard_normal(tuple(p.shape))
                                    .astype(np.float32)))
    return out


def staging(rank, n):
    """Whether a gloo mesh stages a CUDA tensor's ppermute without and
    with ``stage_cuda_through_host`` (a stand-in with a CUDA device: the
    decision reads only the device), and what a sharded step's graphs
    say when asked to capture."""
    import types
    import torch
    from paddle_tpu_torch import optimizer, train
    from paddle_tpu_torch.core import mesh as mesh_lib
    from paddle_tpu_torch.parallel import api, collective as C
    fake = types.SimpleNamespace(device=torch.device("cuda"))
    out = {}
    for switch in (False, True):
        m = mesh_lib.make_mesh(mesh_lib.MeshConfig(dp=n), device_type="cpu",
                               stage_cuda_through_host=switch)
        g = m.get_group("dp")
        try:
            out[switch] = str(C._stage("ppermute", fake, g, m))
        except NotImplementedError as e:
            out[switch] = f"refused: {e}"
        out[f"all_reduce_{switch}"] = C._stage("all_reduce", fake, g, m)
    model = _toy_model(_toy_params())
    opt = optimizer.SGD(model.parameters(), learning_rate=0.1)
    step = train.build_train_step(_toy_loss, opt)
    run, _ = api.shard_train_step(step, _mesh(n, dp=n),
                                  train.make_train_state(model, opt))
    out["backend"] = run.sharding.backend
    graphed = step.rebuild(sharding=run.sharding, cuda_graphs=True)
    try:
        graphed.check_capturable()
        out["capture"] = None
    except ValueError as e:
        out["capture"] = str(e)
    out["stats"] = C.staged_stats()
    return out


def _toy_params():
    rng = np.random.default_rng(0)
    return {"layers": {
        "0": {"weight": rng.standard_normal((16, 32)).astype(np.float32),
              "bias": np.zeros(32, np.float32)},
        "1": {},
        "2": {"weight": rng.standard_normal((32, 4)).astype(np.float32),
              "bias": np.zeros(4, np.float32)}}}


def aggregate_line(rank, n):
    """``aggregate`` of rank-own values, and the log line a Trainer's
    telemetry prints every ``log_every`` steps."""
    from paddle_tpu_torch.observability import aggregate as agg
    from paddle_tpu_torch.observability.telemetry import StepTelemetry
    from paddle_tpu_torch.observability.registry import MetricsRegistry
    stats = agg.aggregate({"a": float(rank), "b": 10.0 - rank})
    lines = []
    tel = StepTelemetry("train", registry=MetricsRegistry(),
                        log_fn=lines.append, aggregate_every=2,
                        detect_recompiles=False)
    for s in range(1, 5):
        tel.step(s, step_time_s=0.1 * (rank + 1), examples=8)
    return stats, lines


def snapshot_save(rank, n, directory, step, leaves, specs, sizes):
    """Save ``leaves`` (global numpy arrays) as this rank's blocks under
    ``specs`` (one per leaf, None: a plain leaf) from process ``rank`` of
    ``n`` into ``directory``."""
    import torch
    from paddle_tpu_torch.parallel.plan import local_shard
    from paddle_tpu_torch.resilience.snapshot import SnapshotEngine, shard_leaf
    mesh = _mesh(n, **sizes)
    state = {}
    for key, a in leaves.items():
        t = torch.from_numpy(a)
        state[key] = t if specs[key] is None else shard_leaf(
            local_shard(t, specs[key], mesh).clone(), specs[key], mesh)
    eng = SnapshotEngine(directory, process_index=rank, process_count=n)
    eng.save(step, _nest(state), wait=True)
    eng.close()


def _nest(flat):
    out = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def snapshot_restore(rank, n, directory, step, specs, sizes,
                     manager=False):
    """Restore ``step`` with ``shardings`` from ``specs`` (key -> spec or
    None) on a mesh of ``sizes``: per key, ``("shard", index, block)`` or
    ``("whole", array)``, plus the largest region gauge."""
    from paddle_tpu_torch import io as io_lib
    from paddle_tpu_torch import observability
    from paddle_tpu_torch.resilience.snapshot import (Shard, SnapshotEngine,
                                                      flatten_tree)
    mesh = _mesh(n, **sizes)
    shardings = _nest({k: (None if s is None else (s, mesh))
                       for k, s in specs.items()})
    if manager:
        eng = io_lib.CheckpointManager(directory)
    else:
        eng = SnapshotEngine(directory)
    back = eng.restore(step, shardings=shardings)
    eng.close()
    out = {}
    for key, v in flatten_tree(back).items():
        if isinstance(v, Shard):
            out[key] = ("shard", v.index, _np(v.data), v.shape)
        else:
            out[key] = ("whole", _np(v))
    gauge = observability.default().gauge(
        "resilience_restore_max_region_bytes").value()
    return out, gauge


def _np(t):
    import torch
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def sharded_eval(rank, n, params, sizes, plan_name, batch, cfg):
    """``shard_eval_step`` of tiny BERT's forward (MLM and NSP logits) of
    the JAX weights on a mesh of ``sizes``, every rank fed the global
    ``batch``: the replicated outputs."""
    import torch
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.nn.module import sharding_specs
    from paddle_tpu_torch.parallel import api, plan as plan_lib
    m = BertForPretraining.from_jax(BertConfig.tiny(**cfg), params,
                                    device="cpu")
    plan = {"replicated": plan_lib.replicated_plan,
            "fsdp": lambda: plan_lib.fsdp_plan(min_size=128),
            "megatron": plan_lib.megatron_plan}[plan_name]()
    run, placed = api.shard_eval_step(
        lambda model, **b: model(**b), _mesh(n, **sizes), m, plan=plan,
        hints=sharding_specs(m) if plan_name == "megatron" else None)
    mlm, nsp = run(placed, **{k: torch.from_numpy(v)
                              for k, v in batch.items()})
    return mlm.numpy(), nsp.numpy()


def constraint(rank, n, x, g):
    """``with_sharding_constraint`` of a replicated ``x`` to ("dp", None)
    on a dp=n mesh: this rank's block, and the gradient of the block's
    product with ``g``'s block, gathered whole."""
    import torch
    from paddle_tpu_torch.parallel import api
    mesh = _mesh(n, dp=n)
    xt = torch.from_numpy(x).requires_grad_()
    blk = api.with_sharding_constraint(xt, ("dp", None), mesh)
    (blk * torch.from_numpy(g).chunk(n)[rank]).sum().backward()
    return blk.detach().numpy(), xt.grad.numpy()


# -- pipelines ("pp") ---------------------------------------------------------

def _pp_block(lp, h, extra, mb_idx):
    """The reference's toy stage block: ``tanh(h @ w + b) (+ extra)``."""
    import torch
    h = torch.tanh(h @ lp["w"] + lp["b"])
    return h if extra is None else h + extra


def _mb_block(lp, h, extra, mb_idx):
    """Adds the extra and the delivered microbatch index."""
    return h + mb_idx + (0.0 if extra is None else extra)


def pipe_primitive(rank, n, sizes, w, b, x, g, extra=None, circuits=1,
                   layout="whole", block="tanh"):
    """``gpipe`` (``circuits`` 1) or ``circular_pipeline`` of the toy
    block over the stack ``(w, b)`` on a mesh of ``sizes``; ``layout``:
    "whole" (every rank holds the stack), "rows" (this stage's rows of a
    contiguous split, ``stage_rows``) or "pre" (rows of the interleaved
    order, ``pre_interleaved``). Returns the output and the gradients of
    ``sum(out * g)`` with respect to the stack (whole again, canonical
    order), the input and the extra."""
    import torch
    from paddle_tpu_torch.core import mesh as mesh_lib
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel import pipeline as PL
    mesh = _mesh(n, **sizes)
    pp = mesh_lib.axis_size(mesh, "pp")
    s = mesh_lib.axis_index(mesh, "pp")
    stack = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    if layout == "pre":
        stack = PL.interleave_stack(stack, pp, circuits)
    if layout != "whole":
        per = w.shape[0] // pp
        stack = {k: v[s * per:(s + 1) * per] for k, v in stack.items()}
    stack = {k: v.clone().requires_grad_() for k, v in stack.items()}
    xt = torch.from_numpy(x).requires_grad_()
    et = None if extra is None else torch.from_numpy(extra) \
        .requires_grad_()
    kw = dict(extras=et, mesh=mesh, stage_rows=layout != "whole")
    fn = _pp_block if block == "tanh" else _mb_block
    if circuits == 1:
        out = PL.gpipe(fn, stack, xt, **kw)
    else:
        out = PL.circular_pipeline(fn, stack, xt, num_circuits=circuits,
                                   pre_interleaved=layout == "pre", **kw)
    res = {"out": out.detach().numpy()}
    if block != "tanh":
        return res
    (out * torch.from_numpy(g)).sum().backward()
    for k, v in stack.items():
        gk = v.grad
        if layout != "whole":
            gk = C.all_gather(gk, "pp", mesh=mesh)
        if layout == "pre":
            gk = PL.uninterleave_stack(gk, pp, circuits)
        res[k] = gk.numpy()
    res["x"] = xt.grad.numpy()
    if et is not None:
        res["extra"] = et.grad.numpy()
    return res


def pipe_rejections(rank, n):
    """The schedules' refusals on a pp=n mesh: extras split over "pp", a
    stream shorter than the stages under the circular schedule, and
    pre-interleaved rows under GPipe; and a pipelined BERT on an sp=n
    mesh. Returns each message."""
    import torch
    from paddle_tpu_torch.parallel import pipeline as PL
    mesh = _mesh(n, pp=n)
    stack = {"w": torch.zeros(8, 4, 4), "b": torch.zeros(8, 4)}
    out = {}
    for key, call in (
            ("extras_spec", lambda: PL.gpipe(
                _pp_block, stack, torch.zeros(4, 2, 4),
                extras=torch.zeros(4, 2, 4), extras_spec=("pp",),
                mesh=mesh)),
            ("short", lambda: PL.circular_pipeline(
                _pp_block, stack, torch.zeros(2, 1, 4), num_circuits=2,
                mesh=mesh)),
            ("gpipe_pre", lambda: PL.gpipe_layer_stack(
                lambda lp, h, e, gen: h, [dict(w=stack["w"][i])
                                          for i in range(4)],
                torch.zeros(8, 4), num_microbatches=4, mesh=mesh,
                schedule="gpipe", pre_interleaved=True))):
        try:
            call()
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    from paddle_tpu_torch.core import mesh as mesh_lib
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    m = BertForPretraining(BertConfig.tiny(pipeline=True,
                                           attn_impl="ring",
                                           attn_dropout=0.0), device="cpu")
    try:
        with mesh_lib.mesh_context(_mesh(n, sp=n)):
            m.bert(torch.zeros(4, 8, dtype=torch.long))
        out["bert_sp"] = None
    except ValueError as e:
        out["bert_sp"] = str(e)
    return out


def _pp_model(model, cfg, params, device="cpu"):
    """BERT or GPT of ``cfg`` (fields over the tiny config's) from the JAX
    weights ``params``, or from seed 0 when ``params`` is None."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    cls, conf, loss = ((BertForPretraining, BertConfig, _bert_loss)
                       if model == "bert" else
                       (GPT, GPTConfig, lambda m, ids: m.loss(ids)))
    if params is None:
        return cls(conf.tiny(**cfg), device=device, seed=0), loss
    return cls.from_jax(conf.tiny(**cfg), params, device=device), loss


def _pp_mesh(n, device, sizes):
    """A mesh of ``sizes``; on the card (``device`` "cuda:0") with the
    staging switch, every rank on that one card."""
    import torch
    from paddle_tpu_torch.core import mesh as mesh_lib
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    return mesh_lib.make_mesh(
        mesh_lib.MeshConfig(**sizes), device_type=device.split(":")[0],
        stage_cuda_through_host=device.startswith("cuda"))


def pipe_train(rank, n, params, model, cfg, sizes, batch, plan_name="hints",
               steps=1, opt="sgd", lr=0.0, gather=False, device="cpu",
               rng_seed=None):
    """A pipelined tiny BERT or GPT (``cfg``: its config's fields) from the
    JAX weights ``params``, ``steps`` steps of ``shard_train_step`` on a
    mesh of ``sizes`` with the layers' hints (``plan_name`` "fsdp" adds
    FSDP's largest-dim split), every rank fed the global ``batch``.
    Returns the losses, the first step's gradients whole again (the
    gradients the update used), the local shapes and specs, the flash
    kernels' launches, and with ``gather`` the final parameters whole.
    ``device`` "cuda:0" runs every rank on the card (``params`` None:
    weights from seed 0). ``rng_seed``: each rank's default generators
    seeded with ``rng_seed + rank`` before the steps (ranks that draw
    dropout from generators of their own)."""
    import torch
    from paddle_tpu_torch import optimizer as o
    from paddle_tpu_torch import train
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.nn.module import sharding_specs
    from paddle_tpu_torch.parallel import api, plan as plan_lib
    mesh = _pp_mesh(n, device, sizes)
    m, loss_fn = _pp_model(model, cfg, params, device)
    optim = (o.SGD(m.parameters(), learning_rate=lr) if opt == "sgd"
             else _optimizer(opt, m.parameters(), lr))
    step = train.build_train_step(loss_fn, optim)
    state = train.make_train_state(m, optim)
    plan = (plan_lib.fsdp_plan(min_size=128) if plan_name == "fsdp"
            else plan_lib.megatron_plan())
    run, placed = api.shard_train_step(step, mesh, state, plan=plan,
                                       hints=sharding_specs(m))
    feeds = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    losses, grads = [], None
    if rng_seed is not None:
        torch.manual_seed(rng_seed + rank)
    registry.load_all()
    registry.reset_launches()
    for _ in range(steps):
        placed, met = run(placed, **feeds)
        losses.append({k: float(v) for k, v in met.items()})
        if grads is None:
            grads = {k: api.gather_block(p.grad, run.specs.get(k, ()),
                                         mesh).cpu().numpy()
                     for k, p in m.named_parameters()}
    out = {"losses": losses, "grads": grads, "specs": run.specs,
           "launches": registry.launch_counts(),
           "local_shapes": {k: tuple(p.shape)
                            for k, p in m.named_parameters()}}
    if gather:
        out["params"] = {k: v.cpu().numpy() for k, v in
                         api.gathered_params(m, run.specs, mesh).items()}
    return out


def pipe_dropout(rank, n, params, cfg, sizes, ids, seed):
    """The sequence output of a pipelined tiny BERT with dropout live
    (training mode), every rank of a mesh of ``sizes`` fed the same
    ``ids``, the dropout generator seeded with ``seed``."""
    import torch
    from paddle_tpu_torch.core import mesh as mesh_lib
    m, _ = _pp_model("bert", cfg, params)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad(), mesh_lib.mesh_context(_mesh(n, **sizes)):
        seq, _ = m.bert(torch.from_numpy(ids), generator=gen)
    return seq.numpy()


def pipe_trainer(rank, n, params, cfg, batch, steps=4):
    """``Trainer.fit`` of a pipelined tiny BERT's sharded step on pp=n:
    the losses and the log lines (rank 0 prints the aggregate line)."""
    import torch
    from paddle_tpu_torch import optimizer as o
    from paddle_tpu_torch import train
    from paddle_tpu_torch.nn.module import sharding_specs
    from paddle_tpu_torch.observability.registry import MetricsRegistry
    from paddle_tpu_torch.parallel import api
    from paddle_tpu_torch.trainer import Trainer
    m, loss_fn = _pp_model("bert", cfg, params)
    optim = o.Adam(m.parameters(), learning_rate=1e-3)
    run, placed = api.shard_train_step(
        train.build_train_step(loss_fn, optim), _mesh(n, pp=n),
        train.make_train_state(m, optim), hints=sharding_specs(m))
    lines = []
    tr = Trainer(run, placed, log_every=2, log_fn=lines.append,
                 registry=MetricsRegistry())
    feeds = {k: torch.from_numpy(v) for k, v in batch.items()}
    last = tr.fit([feeds] * steps)
    return {"last": last, "lines": lines, "step": tr.step_count}


def pipe_snapshot(rank, n, params, cfg, batch, directory, sizes,
                  device="cpu"):
    """One AdamW step of a pipelined stacked tiny BERT on a mesh of
    ``sizes`` with the layers' hints, its state saved as this rank's
    blocks (``Shard`` leaves) into ``directory``, then restored with
    ``shardings=`` naming "pp": the flat specs, the leaves whose restored
    block differs from this rank's, digests of this rank's blocks and of
    the state gathered whole (digests, so that no state crosses the
    pipe), the blocks' shapes and the keys restored as ``Shard``."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch import optimizer as o
    from paddle_tpu_torch import train
    from paddle_tpu_torch.nn.module import sharding_specs
    from paddle_tpu_torch.parallel import api
    from paddle_tpu_torch.resilience.snapshot import (Shard, SnapshotEngine,
                                                      flatten_tree,
                                                      shard_leaf)
    from paddle_tpu_torch.trainer import state_tree
    mesh = _pp_mesh(n, device, sizes)
    m, loss_fn = _pp_model("bert", cfg, params, device)
    optim = o.AdamW(m.parameters(), learning_rate=1e-3)
    run, placed = api.shard_train_step(
        train.build_train_step(loss_fn, optim), mesh,
        train.make_train_state(m, optim), hints=sharding_specs(m))
    run(placed, **{k: torch.from_numpy(v).to(device)
                   for k, v in batch.items()})
    flat = flatten_tree(state_tree(placed))
    keyed = {}
    for key in flat:
        parts = key.split("/")
        name = (".".join(parts[1:]) if parts[0] == "params" else
                ".".join(parts[3:]) if parts[:2] == ["opt", "slots"]
                else None)
        keyed[key] = run.specs.get(name) if name else None
    tree = {k: (shard_leaf(v.detach(), keyed[k], mesh)
                if keyed[k] is not None and isinstance(v, torch.Tensor)
                else v) for k, v in flat.items()}
    eng = SnapshotEngine(directory, process_index=rank, process_count=n)
    eng.save(1, _nest({k: v for k, v in tree.items()
                       if not k.endswith("\x00empty")}), wait=True)
    eng.close()
    dist.barrier()          # process 0 commits once every file is in
    eng = SnapshotEngine(directory)
    back = flatten_tree(eng.restore(1, shardings=_nest({
        k: (None if s is None else (s, mesh)) for k, s in keyed.items()
        if not k.endswith("\x00empty")})))
    eng.close()
    mine = {k: v.detach() for k, v in flat.items()
            if isinstance(v, torch.Tensor)}
    bad = sorted(k for k, v in mine.items()
                 if not isinstance(back.get(k), (Shard, torch.Tensor))
                 or not torch.equal((back[k].data if isinstance(
                     back[k], Shard) else back[k]).to(v.device), v))
    whole = {k: _digest((api.gather_block(v, keyed[k], mesh)
                         if keyed[k] is not None else v).cpu())
             for k, v in mine.items()}
    return {"specs": {k: s for k, s in keyed.items() if s is not None},
            "differ": bad, "whole": whole,
            "mine": {k: _digest(v.cpu()) for k, v in mine.items()},
            "shapes": {k: tuple(v.shape) for k, v in mine.items()},
            "shards": sorted(k for k, v in back.items()
                             if isinstance(v, Shard))}


def _digest(t) -> str:
    """sha256 of a host tensor's bytes, with its dtype and shape."""
    import hashlib
    a = _np(t)
    return hashlib.sha256(f"{a.dtype}{a.shape}".encode()
                          + np.ascontiguousarray(a).tobytes()).hexdigest()


def pipe_eval(rank, n, params, model, cfg, sizes, batch):
    """``shard_eval_step`` of a pipelined tiny BERT's forward (MLM and
    NSP logits) or GPT's logits from the JAX weights on a mesh of
    ``sizes`` with the layers' hints, every rank fed the global
    ``batch``: the replicated outputs."""
    import torch
    from paddle_tpu_torch.nn.module import sharding_specs
    from paddle_tpu_torch.parallel import api
    m, _ = _pp_model(model, cfg, params)
    m.eval()
    run, placed = api.shard_eval_step(
        lambda mod, **b: mod(**b), _mesh(n, **sizes), m,
        hints=sharding_specs(m))
    out = run(placed, **{k: torch.from_numpy(v) for k, v in batch.items()})
    return [t.numpy() for t in (out if isinstance(out, tuple) else (out,))]


def embed_lookup(rank, n, table, ids, g, combiner=None, padding_idx=None):
    """``ShardedEmbedding`` over "tp" holding this rank's block of
    ``table``'s rows, looked up at the global ``ids`` (and
    ``vocab_parallel_lookup`` on the same block): the output, the block's
    gradient of ``sum(out * g)``, and the plain lookup's output."""
    import torch
    from paddle_tpu_torch.core import mesh as mesh_lib
    from paddle_tpu_torch.parallel import plan
    from paddle_tpu_torch.parallel.embedding import (ShardedEmbedding,
                                                     vocab_parallel_lookup)
    mesh = _mesh(n)
    layer = ShardedEmbedding(*table.shape, combiner=combiner,
                             padding_idx=padding_idx, device="cpu")
    with torch.no_grad():
        layer.weight.data = plan.local_shard(
            torch.from_numpy(table), ("tp", None), mesh).contiguous()
    ids_t = torch.from_numpy(ids)
    with mesh_lib.mesh_context(mesh):
        out = layer(ids_t)
        (out * torch.from_numpy(g)).sum().backward()
    plain = vocab_parallel_lookup(ids_t, layer.weight.detach(), mesh=mesh)
    return (out.detach().numpy(), layer.weight.grad.numpy(),
            plain.numpy())


def deepfm_tp(rank, n, params, num_fields, feat_ids, label):
    """The port's ``DeepFM`` from the JAX weights with its two tables'
    rows split over "tp": the loss, the logits and every gradient (the
    tables' of this rank's block)."""
    import torch
    from paddle_tpu_torch.core import mesh as mesh_lib
    from paddle_tpu_torch.models.deepfm import DeepFM
    from paddle_tpu_torch.parallel import plan
    mesh = _mesh(n)
    m = DeepFM.from_jax(params, num_fields, device="cpu")
    for emb in (m.embedding, m.linear_w):
        emb.weight.data = plan.local_shard(emb.weight.data, ("tp", None),
                                           mesh).contiguous()
    with mesh_lib.mesh_context(mesh):
        ids = torch.from_numpy(feat_ids)
        logits = m(ids)
        loss, _ = m.loss(ids, torch.from_numpy(label))
        loss.backward()
    return (float(loss), logits.detach().numpy(),
            {k: p.grad.numpy() for k, p in m.named_parameters()})


def geo_sgd(rank, n, stacked, anchor, mask=None):
    """``geo_sgd_sync`` over "dp" with this rank's row of ``stacked`` (a
    tree of ``(n, ...)`` arrays): the new local row and anchor."""
    import torch
    from paddle_tpu_torch.parallel import communicator as comm
    local = comm._tree_map(
        lambda x: torch.from_numpy(x[rank:rank + 1].copy()), stacked)
    new_local, new_anchor = comm.geo_sgd_sync(
        local, comm._tree_map(torch.from_numpy, anchor), participants=mask,
        mesh=_mesh(n, dp=n))
    return (comm._tree_map(lambda t: t.numpy(), new_local),
            comm._tree_map(lambda t: t.numpy(), new_anchor))


def feed_rows(rank, n, samples, names, replicated, sizes, batch_size):
    """``data.feeder.device_iterator`` over a mesh of ``sizes``: this
    rank's batches as numpy."""
    from paddle_tpu_torch.data import reader
    from paddle_tpu_torch.data.feeder import device_iterator
    mesh = _mesh(n, **sizes)
    batches = reader.batch(lambda: iter(samples), batch_size)
    return [{k: v.numpy() for k, v in b.items()}
            for b in device_iterator(batches, names, mesh=mesh,
                                     replicated=replicated)]
