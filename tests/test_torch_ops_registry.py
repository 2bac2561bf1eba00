"""The port's op registry (``paddle_tpu_torch.core.registry``) and its
registered ops against the JAX package on the CPU: the registry's API,
the registered names of each module (the dense op library ``ops/{
elementwise,math,reduction,activation,tensor}.py``, ``ops/{nn,crf,
sequence,control_flow,quant,metrics_ops,niche,detection}.py`` and
``nn/nets.py``)
equal to the reference's with the same ``has_grad`` and presence of a
reference, every op of the dense library on the same numpy inputs
(``ops.samples``) as the JAX op (floats within 1e-6 abs / 1e-5 rel,
integers, bools and indices exactly; the other modules' ops:
``test_torch_ops_registry_structured.py``), the random ops by shape,
range or moments and same-generator determinism, and the battery that
runs every op against its numpy reference."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.nets  # noqa: F401  (registers the reference's glu)
import paddle_tpu.ops  # noqa: F401  (registers the reference's ops)
from paddle_tpu.ops import (control_flow, crf, detection,  # noqa: F401
                            metrics_ops, niche, quant, sequence)
from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.core import registry as preg
from paddle_tpu_torch.ops import (activation, beam_search,  # noqa: F401
                                  elementwise, math, reduction, samples,
                                  tensor)
from torch_parity import DENSE_OPS, op_equals_the_reference, op_module

torch.set_num_threads(2)

MODULES = ("elementwise", "math", "reduction", "activation", "tensor",
           "beam_search", "nn", "crf", "sequence", "control_flow", "quant",
           "metrics_ops", "niche", "nets", "detection")
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _names_of(registry_module, path):
    """The names ``path`` registers, from a fresh execution of its source
    against an empty registry (the live registry is put back)."""
    saved = registry_module._OP_REGISTRY
    registry_module._OP_REGISTRY = {}
    try:
        spec = importlib.util.spec_from_file_location(
            f"_names_of_{path.stem}", path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        return sorted(registry_module._OP_REGISTRY)
    finally:
        registry_module._OP_REGISTRY = saved


@pytest.mark.parametrize("module", MODULES)
def test_registered_names_equal_the_references(module):
    sub = "nn" if module == "nets" else "ops"
    want = _names_of(jreg, ROOT / "paddle_tpu" / sub / f"{module}.py")
    got = _names_of(preg, ROOT / "paddle_tpu_torch" / sub / f"{module}.py")
    assert got
    assert got == want
    for name in got:
        assert preg.get_op(name).has_grad == jreg.get_op(name).has_grad
        assert (preg.get_op(name).reference is None) == (
            jreg.get_op(name).reference is None)


def test_registry_api():
    assert set(preg.list_ops()) == set(preg.all_ops())
    assert preg.list_ops() == sorted(preg.list_ops())
    info = preg.get_op("elementwise_add")
    assert info.name == "elementwise_add" and info.has_grad
    assert preg.get_op("mul").doc.startswith("Flatten-then-matmul")
    with pytest.raises(KeyError, match="not registered"):
        preg.get_op("no_such_op")
    with pytest.raises(ValueError, match="already registered"):
        preg.register_op("relu")(lambda x: x)
    # every registered op but beam search's has a sample, and nothing else
    # does
    ops = set(preg.list_ops()) - {"beam_search", "beam_search_decode"}
    assert ops == set(samples.SAMPLES) | set(samples.RANDOM)
    assert not set(samples.SAMPLES) & set(samples.RANDOM)


@pytest.mark.parametrize("name", sorted(
    n for n in samples.SAMPLES if op_module(n) in DENSE_OPS))
def test_op_equals_the_references(name):
    op_equals_the_reference(name)


@pytest.mark.parametrize("name", samples.RANDOM)
def test_random_op_distribution_and_determinism(name):
    assert samples.check_random(name, "cpu") == []
    # another seed, other values (a permutation of 50 may not repeat)
    fn = preg.get_op(name).fn
    if name == "randperm":
        a = fn(torch.Generator().manual_seed(0), 50)
        b = fn(torch.Generator().manual_seed(1), 50)
        assert not torch.equal(a, b)


NO_DEVICE_GIVEN = {
    "gaussian_random": lambda fn: fn(None, (4,)),
    "uniform_random": lambda fn: fn(None, (4,)),
    "randint": lambda fn: fn(None, 0, 5, (4,)),
    "randperm": lambda fn: fn(None, 5),
    "beam_init": lambda fn: fn(2, 3),
}


@pytest.mark.parametrize("name", sorted(NO_DEVICE_GIVEN))
def test_entry_points_default_to_the_card(name, monkeypatch):
    fn = (beam_search.beam_init if name == "beam_init"
          else preg.get_op(name).fn)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NO_DEVICE_GIVEN[name](fn)
    # a CPU generator, or device="cpu", puts the output on the CPU
    out = (fn(2, 3, device="cpu")[0] if name == "beam_init"
           else NO_DEVICE_GIVEN[name](
               lambda g, *a, **k: fn(torch.Generator(), *a, **k)))
    assert out.device.type == "cpu"


def test_battery_on_the_cpu():
    res = samples.run_battery("cpu")
    assert res["failures"] == {}
    assert res["ops"] == len(samples.SAMPLES) + len(samples.RANDOM)
    assert res["against_numpy"] + res["against_cpu"] == len(samples.SAMPLES)


def test_hash_equals_the_reference_at_the_edges():
    x = np.array([[0, 1, -1, 2 ** 31 - 1, -2 ** 31, 123456789]], np.int32)
    for kw in ({}, {"mod_by": 97, "num_hash": 3}):
        want = np.asarray(jreg.get_op("hash").fn(jnp.asarray(x), **kw))
        got = tensor.hash_op(torch.from_numpy(x), **kw).numpy()
        np.testing.assert_array_equal(got, want)


def test_unique_with_counts_pads_as_the_reference():
    x = np.array([3, 1, 3, 3, 7, 1], np.int32)
    for size in (3,):
        kw = {} if size is None else {"size": size}
        want = jreg.get_op("unique_with_counts").fn(jnp.asarray(x), **kw)
        got = tensor.unique_with_counts(torch.from_numpy(x), **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
