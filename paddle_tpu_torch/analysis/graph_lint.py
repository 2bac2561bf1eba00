"""Graph lint CLI: static analysis over the port's step functions and the
model zoo (``tools/graph_lint.py``)::

    python -m paddle_tpu_torch.analysis.graph_lint --preset framework
    python -m paddle_tpu_torch.analysis.graph_lint --preset framework \\
        --cost --cost-diff

lints the reference's surfaces in the port -- the LeNet and ResNet-18
train steps, the GPT cached decode step, the ConvGroup dropout forward,
the serving engine's decode and prefill steps over fp and int8 pools and
at tp=2 (a two-rank gloo group, spawned here, as the tests' pool runs
it), the embedding cache's install and the embedding lookup into DeepFM,
and the kernel registry -- and exits 1 on any unsuppressed
error-severity finding. Every surface is traced on CPU fake tensors:
nothing trains, nothing runs. ``analysis/suppressions.txt`` is the
committed allow-list; entries that match no finding are an error (a
stale suppression would silently re-accept a future regression).

``--cost`` adds the cost tier: every surface's traced graph costed
(``analysis.cost_model``) and checked for unexpected collectives (a
single-card serving step must have none), resharding round trips and the
peak-memory and flops budgets committed in ``analysis/cost_budgets.json``;
plus the bucket-coverage proof that the serving engines' and the
embedding cache's ``warmup()`` plans capture every reachable pow2
signature. ``--cost-diff`` compares static flops, peak memory and
collective bytes with the committed baselines and fails on a regression
beyond the manifest's tolerance; ``--update-budgets`` rewrites the
manifest from this run's CPU traces.

``--concurrency`` adds the host-thread tier (``analysis.concurrency`` and
``analysis.conformance``): lock discipline, the lock-order graph and its
drift against ``analysis/lock_order.json`` (``--update-lock-order``
rewrites it), interface conformance and the ``Reject.reason``
vocabulary.
"""

from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing as mp
import os
import sys
import traceback

import torch

from paddle_tpu_torch import analysis
from paddle_tpu_torch.analysis import hlo_lint
from paddle_tpu_torch.analysis.concurrency import LOCK_ORDER_PATH
from paddle_tpu_torch.analysis.findings import SUPPRESSIONS_PATH

DEFAULT_SUPPRESSIONS = SUPPRESSIONS_PATH
DEFAULT_BUDGETS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "cost_budgets.json")
DEFAULT_LOCK_ORDER = LOCK_ORDER_PATH

#: metrics --cost-diff gates against the committed baseline
DIFF_METRICS = ("flops", "peak_hbm_bytes", "collective_bytes")

#: rules that fire only in their optional tier: the stale-suppression
#: gate judges an entry only when its tier ran
CONCURRENCY_RULES = frozenset({
    "unguarded-access", "lock-order-cycle", "double-acquire",
    "lock-order-drift", "sanitizer-violation", "interface-drift",
    "reject-vocab-drift"})
COST_RULES = frozenset({
    "unexpected-collective", "resharding-churn", "peak-hbm-budget",
    "bucket-coverage", "cost-regression"})

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# train surfaces
# ---------------------------------------------------------------------------

def _train_step_report(model, loss_fn, batch, *, name, suppressions,
                       cost=False):
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.train import build_train_step, make_train_state
    optim = opt.Adam(model.parameters(), learning_rate=1e-3)
    state = make_train_state(model, optim)
    step = build_train_step(loss_fn, optim)
    return analysis.lint_train_step(step, state, batch, name=name,
                                    suppressions=suppressions, cost=cost)


def _ce_loss(m, image, label):
    from paddle_tpu_torch.ops import nn as F
    return torch.mean(F.softmax_with_cross_entropy(m(image), label))


def lint_lenet(suppressions, cost=False):
    from paddle_tpu_torch.models.lenet import LeNet
    batch = {"image": torch.zeros((8, 28, 28, 1)),
             "label": torch.zeros((8, 1), dtype=torch.int64)}
    return _train_step_report(LeNet(device=CPU), _ce_loss, batch,
                              name="lenet_train", suppressions=suppressions,
                              cost=cost)


def lint_resnet18(suppressions, cost=False):
    from paddle_tpu_torch.models.resnet import ResNet
    batch = {"image": torch.zeros((4, 64, 64, 3)),
             "label": torch.zeros((4, 1), dtype=torch.int64)}
    return _train_step_report(
        ResNet(depth=18, num_classes=10, in_ch=3, device=CPU), _ce_loss,
        batch, name="resnet18_train", suppressions=suppressions, cost=cost)


def lint_gpt_decode(suppressions, cost=False):
    """The cached single-token decode step. The port writes the KV cache
    in place (the reference's surface was linted without donation and
    suppressed its undonated-buffer warning; here the rule stays silent
    with no entry)."""
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    model = GPT(GPTConfig.tiny(), device=CPU)
    cache = model.init_cache(8, 256)

    def gpt_decode(cache, token_ids, pos):
        return model.decode_step(token_ids, pos, cache)

    return analysis.lint_fn(
        gpt_decode, cache, torch.zeros((8,), dtype=torch.int64),
        torch.zeros((), dtype=torch.int64), name="gpt_decode",
        ast_fn=model.decode_step, suppressions=suppressions, cost=cost)


def lint_convgroup(suppressions, cost=False):
    """A VGG building block in training mode with batch-norm dropout
    drawing from a generator the caller holds: the generator hygiene
    surface (must stay prng-key-reuse clean)."""
    from paddle_tpu_torch.nn.nets import ImgConvGroup
    model = ImgConvGroup(3, [8, 8], pool_size=2, conv_with_batchnorm=True,
                         conv_batchnorm_drop_rate=0.3, conv_act="relu",
                         device=CPU)

    def vgg_convgroup(model, generator, x):
        return model(x, generator).sum()

    return analysis.lint_fn(
        vgg_convgroup, model, torch.Generator().manual_seed(1),
        torch.zeros((2, 16, 16, 3)), name="vgg_convgroup",
        suppressions=suppressions, cost=cost)


# ---------------------------------------------------------------------------
# serving surfaces
# ---------------------------------------------------------------------------

def tiny_serving_engine(**kw):
    """The preset's serving engine: a tiny GPT from seed 0 on the CPU,
    4 slots of 8 pages of 8 tokens (the reference's preset engine)."""
    from paddle_tpu_torch.inference import make_serving_engine
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.observability import MetricsRegistry
    kw.setdefault("num_slots", 4)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_tokens_per_slot", 64)
    model = GPT(GPTConfig.tiny(), device=CPU, seed=0)
    return make_serving_engine(model, device=CPU,
                               registry=MetricsRegistry(), **kw)


def _tiny_int8_engine(**kw):
    """The int8 engine: the tiny GPT over a large quantized pool (KV-heavy
    on a small model), as the reference's, so the int8 bytes sit far from
    an fp pool's in the committed budgets."""
    kw.setdefault("cache_dtype", torch.int8)
    kw.setdefault("num_pages", 513)
    return tiny_serving_engine(**kw)


def surface_feeds(eng, sig):
    """Fake zero feeds of one bucket signature's layout, on the engine's
    device (made in a fake mode: nothing is allocated)."""
    from paddle_tpu_torch.analysis.api import new_fake_mode
    layout, fn = eng._bucket_spec(sig)
    feeds = {}
    with new_fake_mode():
        for item in layout:
            key, shape = item[0], item[1]
            dtype = item[2] if len(item) > 2 else torch.int32
            feeds[key] = torch.zeros(shape, dtype=dtype, device=eng.device)
    return fn, feeds


def lint_engine_step(eng, kind: str, *, name: str, suppressions=None,
                     cost=False, **kw):
    """Lint the engine's ``kind`` step ("decode" or "prefill") at the
    widest bucket: its graph with the model's weights and the page pool
    as constants it closes over (written in place), the step's int32
    feeds as inputs."""
    c = eng.cache.config
    w = c.max_pages_per_slot
    sig = ("decode", w) if kind == "decode" else \
        ("prefill", w, eng.scheduler.num_slots)
    fn, feeds = surface_feeds(eng, sig)

    def step(feeds):
        return fn(**feeds)

    step.__name__ = name
    return analysis.lint_fn(
        step, feeds, state_argnum=None, name=name,
        ast_fn=eng._decode_loop if kind == "decode" else eng._prefill_loop,
        suppressions=suppressions, cost=cost, **kw)


def lint_serving_decode(suppressions, cost=False):
    """The continuous-batching decode step: the page pool is written in
    place (must lint clean with no undonated-buffer entry) and, under
    ``--cost``, the single-card contract: zero collectives."""
    return lint_engine_step(tiny_serving_engine(), "decode",
                            name="serving_decode",
                            suppressions=suppressions, cost=cost)


def lint_serving_prefill(suppressions, cost=False):
    """The batched chunked-prefill step: same contract as decode."""
    return lint_engine_step(tiny_serving_engine(), "prefill",
                            name="serving_prefill",
                            suppressions=suppressions, cost=cost)


def lint_serving_decode_int8(suppressions, cost=False):
    """The dequant-attend decode step over int8 pages and their scales."""
    return lint_engine_step(_tiny_int8_engine(), "decode",
                            name="serving_decode_int8",
                            suppressions=suppressions, cost=cost)


def lint_serving_prefill_int8(suppressions, cost=False):
    """The dequant-attend batched prefill, the speculative verify step's
    shape as well."""
    return lint_engine_step(_tiny_int8_engine(), "prefill",
                            name="serving_prefill_int8",
                            suppressions=suppressions, cost=cost)


#: the tp surfaces: (name, engine tier, step kind)
TP_SURFACES = (("serving_decode_tp", None, "decode"),
               ("serving_prefill_tp", None, "prefill"),
               ("serving_prefill_tp_mlp", "prefill", "prefill"))
TP_TIMEOUT_S = 120


def _tp_rank(rank, n, port, cost, conn):
    """One rank of the tp=2 group: build each surface's engine (every
    rank builds it, as a tp deployment does); rank 0 traces the step and
    sends back the findings and the cost report, then closes the engine;
    the other rank follows until that close."""
    import torch.distributed as dist
    from paddle_tpu_torch.core import mesh as mesh_lib
    try:
        torch.set_num_threads(1)
        timeout = datetime.timedelta(seconds=TP_TIMEOUT_S)
        store = dist.TCPStore("127.0.0.1", port, is_master=False,
                              timeout=timeout)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=n, timeout=timeout)
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(tp=n),
                                  device_type="cpu")
        out = []
        for name, tier, kind in TP_SURFACES:
            eng = tiny_serving_engine(mesh=mesh, **(
                {"tier": tier} if tier else {}))
            if eng._lead:
                rep = lint_engine_step(
                    eng, kind, name=name, cost=cost, registry=False,
                    **({"mesh_axes": {"tp": n}} if cost else {}))
                out.append((name, list(rep.findings), rep.cost))
                eng.close()
            else:
                eng.follow()
        conn.send(("ok", out))
    except BaseException:
        conn.send(("err", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def tp_reports(suppressions, cost=False, n: int = 2):
    """The tp surfaces' reports, from a spawned group of ``n`` gloo
    ranks (rank 0's traces)."""
    import torch.distributed as dist
    ctx = mp.get_context("spawn")
    store = dist.TCPStore("127.0.0.1", 0, world_size=n + 1, is_master=True,
                          timeout=datetime.timedelta(seconds=TP_TIMEOUT_S),
                          wait_for_workers=False)
    procs, conns = [], []
    for r in range(n):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=_tp_rank, args=(r, n, store.port, cost,
                                               child), daemon=True)
        p.start()
        child.close()
        procs.append(p)
        conns.append(parent)
    try:
        results = []
        for conn in conns:
            if not conn.poll(TP_TIMEOUT_S):
                raise TimeoutError("a tp lint rank did not answer within "
                                   f"{TP_TIMEOUT_S} s")
            try:
                results.append(conn.recv())
            except EOFError:
                raise RuntimeError("a tp lint rank exited before it "
                                   "answered (a spawned process imports "
                                   "the caller's __main__: guard it)")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    for status, val in results:
        if status != "ok":
            raise RuntimeError(f"a tp lint rank failed:\n{val}")
    reports = []
    for name, findings, cost_report in results[0][1]:
        rep = analysis.Report(name, findings, suppressions=suppressions)
        rep.cost = cost_report
        rep.count_into_registry()
        reports.append(rep)
    return reports


# ---------------------------------------------------------------------------
# embedding surfaces, coverage, registry, concurrency
# ---------------------------------------------------------------------------

def _tiny_cache():
    from paddle_tpu_torch.embedding_serving import DeviceEmbeddingCache
    return DeviceEmbeddingCache(64, 9, min_gather_bucket=8, device=CPU)


def lint_embedding_install(suppressions, cost=False):
    """The embedding cache's install: rows scattered into the device
    table in place (must lint clean with no undonated-buffer entry)."""
    cache = _tiny_cache()

    def embedding_cache_install(table, slots, rows):
        table.index_copy_(0, slots, rows)
        return table

    return analysis.lint_fn(
        embedding_cache_install, cache.table,
        torch.zeros((8,), dtype=torch.int64), torch.zeros((8, 9)),
        name="embedding_cache_install", suppressions=suppressions,
        cost=cost)


def lint_embedding_lookup(suppressions, cost=False):
    """The embedding serving hot path: a fixed-shape gather out of the
    (read-only) table into the DeepFM forward. Nothing inside may sync to
    the host: misses are handled on the host before this step."""
    from paddle_tpu_torch.models.deepfm import DeepFMHostKV
    cache = _tiny_cache()
    model = DeepFMHostKV(num_fields=4, embed_dim=8, hidden=(16,),
                         device=CPU)

    def embedding_lookup_serve(table, slots, inv):
        rows = table.index_select(0, slots)
        return model.predict_proba(rows, inv)

    return analysis.lint_fn(
        embedding_lookup_serve, cache.table,
        torch.zeros((8,), dtype=torch.int64),
        torch.zeros((4, 4), dtype=torch.int64), state_argnum=None,
        name="embedding_lookup_serve", suppressions=suppressions,
        cost=cost)


def bucket_coverage_report(suppressions):
    """The ahead-of-time zero-capture proof (``--cost``): the serving
    engines' reachable pow2 signatures all in their warmup plans, with
    deliberately non-pow2 configurations (a raw capacity clamp minting a
    width the warmup doubling loop never visits was the reference's
    historical failure), and the embedding cache's widths."""
    from paddle_tpu_torch.embedding_serving import DeviceEmbeddingCache
    report = analysis.Report("bucket_coverage", suppressions=suppressions)
    for slots, page, cap, tag in ((4, 8, 64, "pow2"), (6, 8, 72, "nonpow2")):
        eng = tiny_serving_engine(num_slots=slots, page_size=page,
                                  max_tokens_per_slot=cap)
        report.extend(hlo_lint.serving_bucket_coverage(
            eng, name=f"serving_{tag}"))
    for capacity, max_uniq, tag in ((64, 48, "pow2"), (50, 50, "nonpow2")):
        cache = DeviceEmbeddingCache(capacity, 9, min_gather_bucket=8,
                                     device=CPU)
        report.extend(hlo_lint.embedding_bucket_coverage(
            cache, max_uniq, name=f"embedding_{tag}"))
    report.count_into_registry()
    return report


def lint_kernel_registry(suppressions, cost=False):
    """The kernel layer's contracts (``kernels.lint``)."""
    from paddle_tpu_torch.kernels.lint import lint_registry
    return lint_registry(suppressions)


def concurrency_report(suppressions, *, lock_order):
    """The host-thread tier: lock discipline, the lock-order graph and
    its drift gate, and the conformance lints, on one report."""
    from paddle_tpu_torch.analysis import conformance
    report = analysis.lint_concurrency(lock_order=lock_order,
                                       suppressions=suppressions,
                                       registry=False)
    report.extend(conformance.lint_interfaces())
    report.extend(conformance.lint_reject_vocab())
    report.count_into_registry()
    return report


PRESETS = {
    "framework": [lint_lenet, lint_resnet18, lint_gpt_decode,
                  lint_convgroup, lint_serving_decode, lint_serving_prefill,
                  lint_serving_decode_int8, lint_serving_prefill_int8,
                  tp_reports, lint_embedding_install, lint_embedding_lookup,
                  lint_kernel_registry],
}


# ---------------------------------------------------------------------------
# budgets and the CLI
# ---------------------------------------------------------------------------

def load_budgets(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"tolerance": 0.10, "surfaces": {}}


def cost_diff(measured: dict, budgets: dict, *, out=print) -> int:
    """Compare measured static costs with the committed baselines;
    returns 1 when a gated metric regressed beyond tolerance (or a
    surface has no committed baseline, or a baseline no surface)."""
    tol = float(budgets.get("tolerance", 0.10))
    surfaces = budgets.get("surfaces", {})
    rc = 0
    out(f"cost diff vs committed baselines (tolerance {tol:.0%}):")
    for name in sorted(measured):
        spec = surfaces.get(name)
        if spec is None:
            out(f"  FAIL {name}: no committed baseline -- run "
                "--update-budgets and commit analysis/cost_budgets.json")
            rc = 1
            continue
        for metric in DIFF_METRICS:
            base = int(spec.get(metric, 0))
            now = int(measured[name].get(metric, 0))
            delta = (now - base) / base if base else (1.0 if now else 0.0)
            flag = ""
            if now > base * (1.0 + tol):
                flag = f"  REGRESSION (> {tol:+.0%})"
                rc = 1
            elif base and now < base * (1.0 - tol):
                flag = "  (improved -- refresh with --update-budgets)"
            out(f"  {name:24s} {metric:18s} {base:>14,d} -> {now:>14,d} "
                f"{delta:+7.1%}{flag}")
    for name in sorted(set(surfaces) - set(measured)):
        out(f"  FAIL {name}: committed baseline has no measured surface "
            "(remove it from analysis/cost_budgets.json)")
        rc = 1
    if rc:
        out("cost diff FAILED -- a static cost metric regressed beyond "
            "tolerance (see above); if intended, regenerate the manifest "
            "with --update-budgets and justify it")
    return rc


def _reports(build, sup, cost):
    out = build(sup, cost=cost)
    return out if isinstance(out, list) else [out]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=sorted(PRESETS),
                    default="framework",
                    help="which set of step functions to lint")
    ap.add_argument("--fail-on", choices=("error", "warning"),
                    default="error",
                    help="exit 1 when any unsuppressed finding is at or "
                         "above this severity")
    ap.add_argument("--suppressions", default=DEFAULT_SUPPRESSIONS,
                    help="suppression file (rule-id + substring per "
                         "line); 'none' disables")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON report per surface instead of text")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    ap.add_argument("--cost", action="store_true",
                    help="add the cost tier: collective/resharding/budget "
                         "rules + the warmup bucket-coverage proof")
    ap.add_argument("--cost-diff", action="store_true",
                    help="fail when static flops/peak memory/collective "
                         "bytes regress beyond the committed tolerance")
    ap.add_argument("--budgets", default=DEFAULT_BUDGETS,
                    help="budget manifest (analysis/cost_budgets.json)")
    ap.add_argument("--update-budgets", action="store_true",
                    help="rewrite the budget manifest from this run's "
                         "traces")
    ap.add_argument("--concurrency", action="store_true",
                    help="add the host-thread tier: lock discipline, the "
                         "lock-order graph and its drift gate, interface "
                         "conformance, the Reject.reason vocabulary")
    ap.add_argument("--lock-order", default=DEFAULT_LOCK_ORDER,
                    help="committed lock-order manifest "
                         "(analysis/lock_order.json)")
    ap.add_argument("--update-lock-order", action="store_true",
                    help="rewrite the lock-order manifest from the "
                         "extracted graph (refused while it is cyclic)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, (sev, desc) in sorted(analysis.RULES.items()):
            print(f"{rule:24s} [{sev}] {desc}")
        return 0

    sup = None
    if args.suppressions and args.suppressions != "none" and \
            os.path.exists(args.suppressions):
        sup = analysis.Suppressions.load(args.suppressions)

    cost_mode = args.cost or args.cost_diff or args.update_budgets
    budgets = load_budgets(args.budgets) if cost_mode else None
    tol = float(budgets.get("tolerance", 0.10)) if budgets else 0.10
    measured = {}

    rc = 0
    for build in PRESETS[args.preset]:
        for report in _reports(build, sup, cost_mode):
            if cost_mode and report.cost is not None:
                measured[report.name] = report.cost.summary()
                if args.cost:
                    spec = budgets["surfaces"].get(report.name, {})
                    report.extend(hlo_lint.lint_cost_report(
                        report.cost,
                        collective_allowlist=spec.get("collectives", []),
                        hbm_budget_bytes=int(
                            spec["peak_hbm_bytes"] * (1 + tol))
                        if "peak_hbm_bytes" in spec else None,
                        flops_budget=int(spec["flops"] * (1 + tol))
                        if "flops" in spec else None))
            print(report.render_json() if args.json
                  else report.render_text())
            if not report.ok(args.fail_on):
                rc = 1

    if args.cost:
        report = bucket_coverage_report(sup)
        print(report.render_json() if args.json else report.render_text())
        if not report.ok(args.fail_on):
            rc = 1

    conc_mode = args.concurrency or args.update_lock_order
    if conc_mode:
        # regenerating skips the drift gate (it is what is rewritten) but
        # keeps cycle/double-acquire/discipline findings
        report = concurrency_report(
            sup, lock_order=None if args.update_lock_order
            else args.lock_order)
        print(report.render_json() if args.json else report.render_text())
        if not report.ok(args.fail_on):
            rc = 1
        if args.update_lock_order:
            from paddle_tpu_torch.analysis import concurrency as _conc
            if not report.graph.acyclic():
                print("refusing to write a CYCLIC lock-order manifest -- "
                      "fix the cycle first (see findings above)",
                      file=sys.stderr)
                rc = 1
            else:
                manifest = _conc.lock_order_manifest(report.graph)
                with open(args.lock_order, "w") as f:
                    json.dump(manifest, f, indent=1, sort_keys=True)
                    f.write("\n")
                print(f"wrote {args.lock_order} "
                      f"({len(manifest['locks'])} locks, "
                      f"{len(manifest['edges'])} edges)")

    if args.update_budgets:
        manifest = {
            "_comment": [
                "Static cost baselines for python -m "
                "paddle_tpu_torch.analysis.graph_lint --cost/--cost-diff,",
                "measured from the preset's traces on CPU fake tensors.",
                "Regenerate with: python -m paddle_tpu_torch.analysis."
                "graph_lint --preset framework --update-budgets",
                "and commit it with the change that moves the numbers.",
                "'collectives' is the per-surface allowlist of permitted "
                "collective kinds",
                "(empty = the single-card contract: zero collectives in "
                "the traced step).",
            ],
            "tolerance": tol,
            "surfaces": {
                name: {**vals,
                       "collectives": budgets["surfaces"]
                       .get(name, {}).get("collectives", [])}
                for name, vals in sorted(measured.items())
            },
        }
        with open(args.budgets, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.budgets} ({len(measured)} surfaces)")
    elif args.cost_diff:
        rc = max(rc, cost_diff(measured, budgets))

    # stale suppressions: judged after the whole preset, for the tiers
    # that ran
    if sup is not None and args.preset == "framework":
        stale = sup.stale()
        if not conc_mode:
            stale = [e for e in stale if e[0] not in CONCURRENCY_RULES]
        if not cost_mode:
            stale = [e for e in stale if e[0] not in COST_RULES]
        if stale:
            for rule, pat in stale:
                print(f"stale suppression: `{rule}  {pat}` matched no "
                      f"finding -- delete it from {args.suppressions}",
                      file=sys.stderr)
            rc = 1

    if rc:
        print(f"graph lint FAILED (findings at >= {args.fail_on} "
              "severity; see above)", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
