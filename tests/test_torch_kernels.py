"""The port's kernel layer on the CPU: the parity battery, the autotuner
and the registry lint (``paddle_tpu_torch/kernels/{harness,autotune,
lint}.py``) against the JAX package's kernel layer.

- ``parity_check``'s plain and dense legs on all seven entries, and a
  fourth leg only the tests run: the reference's lax fallback
  (``paddle_tpu.kernels.harness.dispatch(..., impl="lax")``) through
  numpy on the same seeded inputs, within the entry's tolerance;
- ``tune_key``'s shape bucket (and version and dtypes) equal to
  ``paddle_tpu.kernels.autotune.tune_key``'s for the same shapes;
- the tuning cache's save, load and stale detection; the empty cache's
  prior (each kernel's configuration before the tuner existed) at every
  cell's shape;
- the lint clean on the port, and firing on a tuner outside the
  candidates, an entry point no entry names, an arity mismatch and a
  binding outside a home module.

The kernel legs need the card (``tests/test_torch_cuda.py``).
"""

import dataclasses
import json
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import autotune as ref_autotune
from paddle_tpu.kernels import harness as ref_harness
from paddle_tpu.kernels import registry as ref_registry
from paddle_tpu_torch.kernels import autotune, harness, lint, registry

registry.load_all()
NAMES = registry.names()
#: the reference entry each port entry stands for (its flash entry is
#: one, forward and backward)
REF_NAME = {n: ("flash_attention" if n.startswith("flash") else n)
            for n in NAMES}
PAGED = [n for n in NAMES if n.startswith("ragged")]


def _jnp(args):
    return tuple(None if a is None else jnp.asarray(a.numpy())
                 for a in args)


def test_the_registry_holds_the_seven_kernels():
    assert NAMES == ("flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                     "flash_attention_fwd", "ragged_paged_decode",
                     "ragged_paged_decode_int8", "ragged_paged_prefill",
                     "ragged_paged_prefill_int8")
    for name in NAMES:
        entry = registry.get(name)
        assert entry.cuda_fn.__module__ in registry.HOME_MODULES
        assert set(entry.contract.symbols) <= set(lint.c_prototypes())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_parity_battery_plain_and_dense_legs(name, seed):
    errs = harness.parity_check(name, seed)
    assert set(errs) == {"plain", "reference"}
    assert errs["plain"] <= registry.get(name).tolerance[torch.float32][0] \
        + 1e-3


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", PAGED)
def test_paged_samples_are_the_references_draws(name, seed):
    """The port's sample inputs are the reference's, value for value (the
    int8 pages through each package's ``quantize_kv``)."""
    args, _ = registry.get(name).sample_inputs(seed)
    ref_args, _ = ref_registry.get(name).sample_inputs(seed)
    assert len(args) == len(ref_args)
    for a, r in zip(args, ref_args):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def _lax_leg(name, args, kwargs):
    """The reference's lax fallback on the port's inputs, as numpy: the
    kernel's outputs in the port entry's order (forward: out; dk/dv;
    dq, through ``jax.vjp`` of the fallback)."""
    ref = REF_NAME[name]
    if name == "flash_attention_fwd":
        q, k, v, bias = _jnp(args)
        return (np.asarray(ref_harness.dispatch(ref, q, k, v, bias,
                                                impl="lax", **kwargs)),)
    if name.startswith("flash"):
        q, k, v, bias, do = _jnp(args[:5])
        _, vjp = jax.vjp(lambda q, k, v: ref_harness.dispatch(
            ref, q, k, v, bias, impl="lax", **kwargs), q, k, v)
        dq, dk, dv = (np.asarray(g) for g in vjp(do))
        return (dk, dv) if name.endswith("dkv") else (dq,)
    return (np.asarray(ref_harness.dispatch(ref, *_jnp(args), impl="lax",
                                            **kwargs)),)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_fourth_leg_the_references_lax_fallback(name, seed):
    """The reference's lax fallback on the same seeded inputs agrees with
    the port's dense reference (and so with its plain version) within
    the entry's fp32 tolerance."""
    entry = registry.get(name)
    args, kwargs = entry.sample_inputs(seed)
    want = entry.reference_fn(*args, **kwargs)
    want = want if isinstance(want, tuple) else (want,)
    if name == "flash_attention_fwd":
        want = want[:1]                  # the fallback returns out only
    got = _lax_leg(name, args, kwargs)
    atol, rtol = entry.tolerance[torch.float32]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g, w.numpy(), atol=atol, rtol=rtol)


def test_dispatch_impls_on_the_cpu():
    entry = registry.get("ragged_paged_decode")
    args, _ = entry.sample_inputs(1)
    auto = harness.dispatch(entry.name, *args)
    torch.testing.assert_close(auto, entry.plain_fn(*args), rtol=0, atol=0)
    torch.testing.assert_close(harness.dispatch(entry.name, *args,
                                                impl="plain"), auto)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        harness.dispatch(entry.name, *args, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        harness.dispatch(entry.name, *args, impl="lax")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        entry.cuda_fn(*args, blocks={"warps": 8})


def _ref_args(name, args, kwargs):
    """The reference's call signature for the same shapes: the paged
    entries take the port's arguments; the flash entry (q, k, v)."""
    if name.startswith("flash"):
        return _jnp(args[:3]), kwargs
    return _jnp(args), kwargs


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_tune_key_bucket_equals_the_references(name, seed):
    entry = registry.get(name)
    args, kwargs = entry.sample_inputs(seed)
    key = autotune.tune_key(entry, args, kwargs).split("|")
    ref_key = ref_autotune.tune_key(ref_registry.get(REF_NAME[name]),
                                    *_ref_args(name, args, kwargs)).split("|")
    assert key[0] == name
    # version, pow2 shape bucket, dtypes: the same; the device kind is
    # each package's own
    assert key[1:4] == ref_key[1:4]
    assert key[4] == "cpu"


def test_tune_key_names_the_card_and_the_bf16_dtype():
    entry = registry.get("ragged_paged_decode")
    (q, *rest), _ = autotune.cell_inputs(
        "decode", (autotune.S, autotune.W), "meta")
    key = autotune.tune_key(entry, (q, *rest))
    assert key == ("ragged_paged_decode|v1|s16xh16xd64xps16xmp32|"
                   "bfloat16-int32|cpu")


#: the launch configuration each kernel ran before the tuner existed
TODAY = {
    "ragged_paged_decode": {"warps": 8},
    "ragged_paged_decode_int8": {"warps": 8},
    "ragged_paged_prefill": {"warps": 8},
    "ragged_paged_prefill_int8": {"warps": 4},
}
#: the flash kernels' fixed tiles: bf16 at D = 64 (wgmma), fp32 (scalar)
TILES = {
    ("flash_attention_fwd", torch.bfloat16): {"block_q": 64, "block_k": 128},
    ("flash_attention_bwd_dkv", torch.bfloat16): {"block_q": 64,
                                                  "block_k": 64},
    ("flash_attention_bwd_dq", torch.bfloat16): {"block_q": 64,
                                                 "block_k": 64},
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cell", autotune.CELLS,
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_empty_cache_resolves_todays_configuration(cell, dtype):
    """With an empty cache every cell shape, served or trained, resolves
    to the configuration its kernel ran before the tuner existed."""
    name, _label, kind, geom = cell
    entry = registry.get(name)
    args, kwargs = autotune.cell_inputs(kind, geom, "meta", dtype)
    tuner = autotune.KernelTuner(None)
    got = tuner.get(entry, args, kwargs)
    want = TODAY.get(name) or TILES.get((name, dtype)) or {
        "block_q": 64, "block_k": 64}
    assert got == want
    assert tuner.stats() == {"hits": 0, "misses": 1, "stale": 0,
                             "entries": 0}
    assert entry.contract.admits(args, got)
    assert entry.smem(args, got) <= registry.SMEM_BUDGET_BYTES


def test_the_committed_cache_admits_only_fresh_entries():
    committed = autotune.KernelTuner(autotune.DEFAULT_CACHE_PATH)
    assert committed.stale_entries() == []
    for key, ent in committed.entries.items():
        assert ent["source"] == "measured"
        assert ent["contract_version"] == registry.get(
            key.split("|")[0]).contract.version


def _measured_tuner():
    """A tuner holding one measured decode entry (device_ms made up for
    the round trip; nothing is measured on the CPU). Its blocks are the
    decode's one candidate, so a hit and a miss resolve alike: the
    tuner's counts tell them apart."""
    entry = registry.get("ragged_paged_decode")
    args, kwargs = entry.sample_inputs(2)
    tuner = autotune.KernelTuner(None)
    key = autotune.tune_key(entry, args, kwargs)
    tuner.entries[key] = {"blocks": {"warps": 8},
                          "source": "measured", "contract_version": 1,
                          "device_ms": {"x": 1.0}}
    return entry, args, kwargs, tuner, key


def test_cache_save_load_round_trip(tmp_path):
    entry, args, kwargs, tuner, key = _measured_tuner()
    path = tmp_path / "tune.json"
    tuner.save(str(path))
    data = json.loads(path.read_text())
    assert data["schema_version"] == 1 and list(data["entries"]) == [key]
    loaded = autotune.KernelTuner(str(path))
    assert loaded.entries == tuner.entries
    assert loaded.get(entry, args, kwargs) == {"warps": 8}
    assert loaded.stats()["hits"] == 1
    assert loaded.stale_entries() == []
    assert loaded.report("cpu") == {"fresh": [key], "stale": []}


def test_stale_entries_are_detected_counted_and_ignored(monkeypatch):
    entry, args, kwargs, tuner, key = _measured_tuner()
    # a contract version that moved: the entry is stale
    monkeypatch.setattr(entry, "contract", dataclasses.replace(
        entry.contract, version=2))
    assert tuner.stale_entries() == [key]
    # (the key names the version, so the new contract's lookup misses)
    assert tuner.get(entry, args, kwargs) == TODAY[entry.name]
    assert tuner.stats()["misses"] == 1
    monkeypatch.undo()
    # blocks outside the candidates, and a kernel nobody registered
    tuner.entries[key]["blocks"] = {"warps": 4}
    tuner.entries["no_such_kernel|v1|s8|float32|cpu"] = {
        "blocks": {}, "contract_version": 1}
    assert sorted(tuner.stale_entries()) == sorted(
        [key, "no_such_kernel|v1|s8|float32|cpu"])
    assert tuner.get(entry, args, kwargs) == TODAY[entry.name]
    assert tuner.stats()["stale"] == 1
    assert sorted(tuner.report("cpu")["stale"]) == sorted(
        [key, "no_such_kernel|v1|s8|float32|cpu"])
    assert tuner.purge_stale() == 2 and tuner.entries == {}


def test_a_configuration_outside_the_candidates_raises():
    entry = registry.get("ragged_paged_prefill")
    args, _ = entry.sample_inputs(0)
    with pytest.raises(ValueError, match="outside the contract"):
        entry.blocks_for(args, {"warps": 4})
    with pytest.raises(ValueError, match="outside the contract"):
        entry.blocks_for(args, {"warps": 8, "kv_splits": 1})
    assert entry.blocks_for(args, {"warps": 8}) == {"warps": 8}
    assert entry.blocks_for(args) == {"warps": 8}


def test_measure_refuses_the_cpu():
    entry = registry.get("ragged_paged_decode")
    args, kwargs = entry.sample_inputs(0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        autotune.KernelTuner(None).measure(entry, args, kwargs)


def test_the_lint_is_clean_on_the_port():
    report = lint.lint_registry(registry_metrics=False)
    assert report.findings == [], report.render_text()


class _OutsideTuner:
    def get(self, entry, args, kwargs=None):
        return {"warps": 3}


def test_the_lint_fires_on_a_tuner_outside_the_candidates():
    found = lint.contract_findings(registry.get("ragged_paged_decode"),
                                   tuner=_OutsideTuner())
    assert [f.rule for f in found] == ["kernel-contract"]
    assert "outside the contract's candidates" in found[0].message


def _csrc_copy(tmp_path, edit=None):
    dst = tmp_path / "csrc"
    shutil.copytree(lint.CSRC, dst)
    if edit is not None:
        path = dst / "paged_attention.cu"
        path.write_text(edit(path.read_text()))
    return str(dst)


def test_the_lint_fires_on_an_entry_point_with_no_entry(tmp_path):
    csrc = _csrc_copy(tmp_path, lambda s: s + (
        '\nextern "C" int ptt_paged_extra(const void* q, int n, '
        'void* stream) {\n  return 0;\n}\n'))
    found = lint.bypass_findings(prototypes=lint.c_prototypes(csrc))
    assert [f.rule for f in found] == ["kernel-registry-bypass"]
    assert "ptt_paged_extra" in found[0].message
    report = lint.lint_registry(csrc=csrc, registry_metrics=False)
    assert not report.ok()


def test_the_lint_fires_on_an_arity_mismatch(tmp_path):
    def drop_dtype(src):
        old = ("int Dh, int ps, int w, int P, int dtype,\n"
               "                                float scale, void* stream)")
        assert src.count(old) == 1
        return src.replace(old, "int Dh, int ps, int w, int P,\n"
                           "                                float scale, "
                           "void* stream)")
    protos = lint.c_prototypes(_csrc_copy(tmp_path, drop_dtype))
    found = lint.contract_findings(registry.get("ragged_paged_decode"),
                                   prototypes=protos)
    assert [f.rule for f in found] == ["kernel-contract"]
    assert "ptt_paged_decode: the ctypes signature has 15 arguments, " \
        "the prototype in paged_attention.cu has 14" in found[0].message


def test_the_lint_fires_on_a_bind_outside_a_home_module(tmp_path):
    root = tmp_path / "paddle_tpu_torch"
    (root / "ops").mkdir(parents=True)
    (root / "ops" / "rogue.py").write_text(
        "from paddle_tpu_torch.kernels import build\n\n"
        "def launch():\n"
        "    return build.bind('paged_attention', 'ptt_paged_decode', [])\n")
    found = lint.bypass_findings(root=str(root))
    assert [f.rule for f in found] == ["kernel-registry-bypass"]
    assert found[0].location == "rogue.py:4"
    # allowlisted, it passes; an allowlist entry that matches nothing fires
    assert lint.bypass_findings(root=str(root),
                                allowlist=("paddle_tpu_torch.ops.rogue",)) \
        == []
    stale = lint.bypass_findings(allowlist=("paddle_tpu_torch.ops.gone",))
    assert [f.rule for f in stale] == ["kernel-registry-bypass"]
    assert "stale allowlist entry" in stale[0].message


def test_the_home_modules_are_the_only_binders():
    pkg = pathlib.Path(lint._PKG_ROOT)
    sites = [mod for path, mod in lint._py_files(str(pkg))
             for mod, _ in lint._bind_sites(path, mod)]
    assert sorted(set(sites)) == sorted(registry.HOME_MODULES)


def test_the_lint_checks_the_mesh_entry():
    """The ring's composite entry is clean, and the lint fires on an
    unknown inner kernel and an entry point that runs without a mesh."""
    entry = registry.get_composite("ring_attention")
    assert lint.composite_entry_findings(entry) == []
    bad = dataclasses.replace(entry, inner=("flash_attention_fwd", "nope"),
                              fn=lambda *a, **k: None)
    found = lint.composite_entry_findings(bad)
    assert {f.rule for f in found} == {"composite-entry-contract"}
    text = " ".join(f.message for f in found)
    assert "'nope' is not registered" in text
    assert "fn ran without a mesh" in text


@pytest.mark.parametrize("name", sorted(
    e.name for e in registry.composite_entries()))
def test_every_composite_entry_is_lint_clean(name):
    """One registry and one rule for the entries with no kernel of their
    own: the four tp entries and the ring, each clean, each refusing to
    run without a mesh."""
    entry = registry.get_composite(name)
    assert entry.requires_mesh and set(entry.inner) <= set(registry.names())
    assert lint.composite_entry_findings(entry) == []
    found = lint.composite_entry_findings(dataclasses.replace(
        entry, plain_fn=lambda *a, **k: None))
    assert [f.rule for f in found] == ["composite-entry-contract"]


def test_the_harness_runs_the_mesh_entry_in_a_group():
    """``parity_check("ring_attention", seed)`` on both ranks of a gloo
    group: the composed, plain and auto legs within the contract."""
    from torch_tp_pool import TpPool
    pool = TpPool(2)
    try:
        for errs in pool.run("ring_parity", timeout_s=60, seed=2):
            assert set(errs) == {"xla", "plain", "auto"}
            assert max(errs.values()) <= registry.get_composite(
                "ring_attention").atol
    finally:
        pool.close()


def test_seeded_buckets_hold_the_prior_and_the_work():
    """``seed_default_buckets``: three sample buckets a kernel, each the
    prior stamped with its bytes and flops; a measured entry of the
    current contract is kept."""
    from paddle_tpu_torch.kernels import autotune, registry
    tuner = autotune.KernelTuner()
    seeded = autotune.seed_default_buckets(tuner)
    assert set(seeded.values()) == set(registry.names())
    for key, name in seeded.items():
        ent = tuner.entries[key]
        entry = registry.get(name)
        assert ent["source"] == "prior"
        assert ent["contract_version"] == entry.contract.version
        assert ent["cost_prior"]["flops"] > 0
        assert ent["cost_prior"]["traffic_bytes"] > 0
    key = next(iter(seeded))
    tuner.entries[key] = dict(tuner.entries[key], source="measured")
    entry = registry.get(seeded[key])
    args, kwargs = entry.sample_inputs(0)
    autotune.seed_entry(tuner, entry, args, kwargs)
    assert tuner.entries[key]["source"] == "measured"
    assert tuner.stale_entries() == []


def test_allowlist_file_reads_entries_without_comments(tmp_path):
    from paddle_tpu.kernels import lint as jax_lint
    from paddle_tpu_torch.kernels import lint
    path = tmp_path / "allow.txt"
    path.write_text("# header\nmod.a  # why\n\n  mod.b:ptt_x\n")
    assert lint.load_allowlist(str(path)) == ["mod.a", "mod.b:ptt_x"] == \
        jax_lint.load_allowlist(str(path))
    assert lint.load_allowlist(str(tmp_path / "missing")) == []
    assert lint.bypass_findings(allowlist=lint.load_allowlist(
        str(tmp_path / "missing"))) == []
