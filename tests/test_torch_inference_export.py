"""The export half of the port's ``inference`` (``save_inference_model``,
``load_inference_model``, ``Predictor``, ``fold_batch_norms``) and
``slim``'s int8 weights, against the JAX package on the CPU: a tiny fp32
Transformer from a JAX ``PRNGKey`` exported by both packages, the port's
``Predictor`` within 1e-5 of the reference's, the int8 program within
1e-5 of the model on the reference's dequantized weights, a
save/load round trip bit for bit, the int8 values and scales exactly the
reference's, ``fold_batch_norms`` on a tree carried across (HWIO <->
OIHW), the refusals and ``freeze_native``'s package (written, then
deleted by an export without it), a fresh process that runs the artifact
without importing any model, and ``torch.export`` of a module forced to the
flash path recording ``ptt.flash_fwd`` nodes (fake tensors: nothing
launches)."""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import inference as jinf
from paddle_tpu import slim as jslim
from paddle_tpu.models.transformer import Transformer as JaxTransformer
from paddle_tpu.models.transformer import \
    TransformerConfig as JaxTransformerConfig
from paddle_tpu_torch import inference as pinf
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import slim as pslim
from paddle_tpu_torch.models.convert import params_tree, state_from_jax
from paddle_tpu_torch.models.transformer import Transformer, TransformerConfig
from paddle_tpu_torch.ops import attention as FA

torch.set_num_threads(2)

CFG = dict(dropout=0.0, attn_dropout=0.0, max_len=16)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    jm = JaxTransformer(JaxTransformerConfig.tiny(**CFG, attn_impl="xla"))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    pm = Transformer.from_jax(TransformerConfig.tiny(**CFG), params,
                              device="cpu")
    return jm, params, pm


def _ids(seed=1, b=2, s=10):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 64, (b, s)).astype(np.int32)
    ids[0, s - 3:] = 2                       # padding in one row
    return ids


@pytest.fixture(scope="module")
def exported(pair, tmp_path_factory):
    """(directory, example inputs) of the port's fp32 artifact."""
    _, _, pm = pair
    path = tmp_path_factory.mktemp("export") / "port"
    ex = (torch.from_numpy(_ids(1)), torch.from_numpy(_ids(2)))
    program = pinf.save_inference_model(str(path), pm, ex,
                                        input_names=["src", "tgt"])
    assert program is not None
    return path, ex


def test_round_trip_and_the_reference_predictor(pair, exported):
    jm, params, pm = pair
    path, ex = exported
    src, tgt = (t.numpy() for t in ex)
    meta = json.loads((path / "meta.json").read_text())
    assert meta == {
        "input_names": ["src", "tgt"],
        "inputs": [{"shape": [2, 10], "dtype": "int32"}] * 2,
        "outputs": [{"shape": [2, 10, 64], "dtype": "float32"}],
        "weight_quantize": None, "device": "cpu"}
    reg = obs.default()
    loaded0 = reg.counter("inference_predictors_total").value()
    requests0 = reg.counter("inference_requests_total").value()
    pred = pinf.load_inference_model(str(path))
    got = pred.run(src, tgt)
    with torch.no_grad():
        eager = pm(torch.from_numpy(src), torch.from_numpy(tgt))
    assert torch.equal(got, eager)
    assert torch.equal(pred.run(feed={"src": src, "tgt": tgt}), got)
    assert reg.counter("inference_predictors_total").value() == loaded0 + 1
    assert reg.counter("inference_requests_total").value() == requests0 + 2
    assert reg.histogram("inference_latency_seconds").summary()["count"] >= 2

    ref = path.parent / "ref"
    jinf.save_inference_model(str(ref), lambda p, s, t: jm.forward(p, s, t),
                              params, (jnp.asarray(src), jnp.asarray(tgt)),
                              input_names=["src", "tgt"],
                              freeze_native=False)
    want = jinf.load_inference_model(str(ref)).run(src, tgt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref_meta = json.loads((ref / "meta.json").read_text())
    assert {k: meta[k] for k in ref_meta} == ref_meta


def test_int8_weights_equal_the_references(pair, exported, tmp_path):
    jm, params, pm = pair
    # eagerly, as the reference runs it (under jit XLA turns the scale's
    # division by 127 into a multiplication, an ulp away)
    want = jslim.quantize_weights_int8(params)
    got = pslim.quantize_weights_int8(params_tree(pm, {
        n: p.detach() for n, p in pm.named_parameters()}))
    flat_w, flat_g = state_from_jax(want), {}

    def walk(prefix, node):
        if isinstance(node, dict) and set(node) == {"q", "scale", "axis"}:
            flat_g[prefix + ".q"] = node["q"]
            flat_g[prefix + ".scale"] = node["scale"]
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        else:
            flat_g[prefix] = node

    walk("", got)
    flat_w = {k: v for k, v in flat_w.items() if not k.endswith(".axis")}
    assert sorted(flat_g) == sorted(flat_w)
    n_q = 0
    for k, w in flat_w.items():
        g = flat_g[k]
        assert g.dtype == w.dtype, k
        if k.endswith(".q"):
            n_q += 1
            assert g.dtype == torch.int8
        assert torch.equal(g, w), k
    assert n_q == sum(p.ndim >= 2 for p in pm.parameters())

    path, ex = exported
    src, tgt = (t.numpy() for t in ex)
    pinf.save_inference_model(str(tmp_path / "q8"), pm, ex,
                              weight_quantize="int8")
    pred = pinf.load_inference_model(str(tmp_path / "q8"))
    weights = [sum(t.numel() * t.element_size() for t in
                   torch.export.load(str(d / "__model__.pt2"))
                   .state_dict.values()) for d in (tmp_path / "q8", path)]
    # int8 matrices plus fp32 scales, biases and norms: about a third here
    assert weights[0] < 0.4 * weights[1], weights
    assert pred.meta["weight_quantize"] == "int8"
    assert sum(t.dtype == torch.int8
               for t in pred.program.state_dict.values()) == n_q
    assert not any(k.endswith("proj.weight") for k in pred.program.state_dict)
    got_q8 = pred.run(src, tgt)
    # the program computes the model on the reference's dequantized
    # weights (q * scale in float32)
    deq_state = state_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.jit(jslim.dequantize_weights)(want)))
    deq = params_tree(pm8 := Transformer(pm.cfg, device="cpu"))
    deq = pslim.dequantize_weights(got, keep_int8_resident=True)
    assert all(torch.equal(deq_state[n], t) for n, t in state_from_jax(
        deq).items())
    pm8.load_state_dict(deq_state)
    with torch.no_grad():
        torch.testing.assert_close(got_q8, pm8.eval()(*ex), **TOL)
        full = pm(*ex)
    # and int8 stays near the float program (a loose bound: rounding to
    # 1/254 of each channel's range, through 2 + 2 layers and the tied
    # projection)
    assert float((got_q8 - full).abs().max()) < 0.1 * float(full.std())


def test_export_records_the_flash_op_and_launches_nothing(tmp_path):
    """``torch.export`` traces with fake tensors: the module forced to the
    flash path gives one ``ptt.flash_fwd`` node per attention (2 encoder
    self, 2 decoder self, 2 cross) and no kernel launch is counted."""
    model = Transformer(TransformerConfig.tiny(**CFG, attn_impl="flash",
                                               d_model=64, num_heads=2),
                        device="cpu", seed=3)
    before = FA.FWD.launches
    ex = (torch.from_numpy(_ids(5)), torch.from_numpy(_ids(6)))
    program = pinf.save_inference_model(str(tmp_path / "flash"), model, ex)
    targets = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count(torch.ops.ptt.flash_fwd.default) == 6
    assert torch.ops.ptt.flash_bwd_dkv.default not in targets
    assert FA.FWD.launches == before
    # the loaded program runs the op's CPU implementation
    got = pinf.load_inference_model(str(tmp_path / "flash")).run(*ex)
    with torch.no_grad():
        torch.testing.assert_close(got, model(*ex), rtol=0, atol=0)


def test_a_fresh_process_runs_the_artifact_without_the_model(pair, exported,
                                                             tmp_path):
    _, _, pm = pair
    path, ex = exported
    torch.save(ex, tmp_path / "inputs.pt")
    code = (
        "import sys, torch\n"
        "from paddle_tpu_torch.inference import load_inference_model\n"
        f"pred = load_inference_model({str(path)!r})\n"
        f"out = pred.run(*torch.load({str(tmp_path / 'inputs.pt')!r}))\n"
        f"torch.save(out, {str(tmp_path / 'out.pt')!r})\n"
        "bad = [m for m in sys.modules if m.startswith(("
        "'paddle_tpu_torch.models', 'paddle_tpu_torch.nn', 'jax', "
        "'paddle_tpu.'))]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    with torch.no_grad():
        assert torch.equal(torch.load(tmp_path / "out.pt"), pm(*ex))


def test_refusals(pair, exported, tmp_path):
    _, _, pm = pair
    path, ex = exported
    for mod in (pinf, jinf):
        with pytest.raises(ValueError, match="weight_quantize must be"):
            if mod is pinf:
                mod.save_inference_model(str(tmp_path / "x"), pm, ex,
                                         weight_quantize="int4")
            else:
                mod.save_inference_model(str(tmp_path / "y"), None, {}, (),
                                         weight_quantize="int4")
    # freeze_native writes the AOTInductor package of the native runner
    # (served in test_torch_native_runner.py); an export without it
    # deletes an earlier package, so the runner never serves stale weights
    z, x = tmp_path / "z", torch.arange(6, dtype=torch.float32).reshape(2, 3)
    pinf.save_inference_model(str(z), lambda t: t * 2.0 + 1.0, (x,),
                              freeze_native=True)
    assert (z / "__model__frozen__.pt2").stat().st_size > 0
    assert set(json.loads((z / "meta.json").read_text())) == {
        "input_names", "inputs", "outputs", "weight_quantize", "device"}
    pinf.save_inference_model(str(z), lambda t: t * 2.0 + 1.0, (x,))
    assert not (z / "__model__frozen__.pt2").exists()
    import shutil
    shutil.copytree(path, tmp_path / "cpu")
    meta_path = tmp_path / "cpu" / "meta.json"
    meta = json.loads(meta_path.read_text())
    pred = pinf.Predictor(str(tmp_path / "cpu"))
    with pytest.raises(ValueError, match="expected 2 inputs"):
        pred.run(ex[0])
    if not torch.cuda.is_available():
        meta_path.write_text(json.dumps({**meta, "device": "cuda:0"}))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pinf.Predictor(str(tmp_path / "cpu"))


def _bn(rng, c):
    return {"scale": rng.standard_normal(c).astype(np.float32),
            "bias": rng.standard_normal(c).astype(np.float32),
            "mean": rng.standard_normal(c).astype(np.float32),
            "variance": rng.uniform(0.5, 2, c).astype(np.float32)}


def _conv(rng, cin, cout, bias=True):
    out = {"weight": rng.standard_normal((3, 3, cin, cout)).astype(
        np.float32)}
    if bias:
        out["bias"] = rng.standard_normal(cout).astype(np.float32)
    return out


def _to_port(tree):
    """numpy HWIO tree -> torch OIHW tree."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    t = torch.from_numpy(np.asarray(tree))
    return t.permute(3, 2, 0, 1).contiguous() if t.ndim == 4 else t


def _to_ref(tree):
    if isinstance(tree, dict):
        return {k: _to_ref(v) for k, v in tree.items()}
    a = tree.numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


def test_fold_batch_norms_matches_the_reference_on_a_carried_tree():
    rng = np.random.default_rng(0)
    tree = {
        "block": {"conv": _conv(rng, 3, 4), "bn": _bn(rng, 4)},
        "stem": {"conv": _conv(rng, 4, 5, bias=False), "bn": _bn(rng, 5)},
        "vgg": {"convs": {"0": _conv(rng, 5, 6), "1": _conv(rng, 6, 6)},
                "bns": {"0": _bn(rng, 6), "1": _bn(rng, 6)}},
        # an offset mapping (bns[i] after convs[i + 1]) stays as it is
        "gan": {"convs": {"0": _conv(rng, 2, 3), "1": _conv(rng, 3, 3)},
                "bns": {"1": _bn(rng, 3), "2": _bn(rng, 3)}},
        "head": {"weight": rng.standard_normal((6, 2)).astype(np.float32)},
    }
    want = jax.tree_util.tree_map(np.asarray, jinf.fold_batch_norms(
        jax.tree_util.tree_map(jnp.asarray, tree), 1e-3))
    got = _to_ref(pinf.fold_batch_norms(_to_port(tree), 1e-3))
    flat_w, flat_g = (jax.tree_util.tree_flatten_with_path(t)[0]
                      for t in (want, got))
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                   err_msg=str(path))
    np.testing.assert_array_equal(got["gan"]["convs"]["0"]["weight"],
                                  tree["gan"]["convs"]["0"]["weight"])
