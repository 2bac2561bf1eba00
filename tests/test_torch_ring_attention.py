"""The port's ring attention (``paddle_tpu_torch/parallel/ring_attention.py``)
against the JAX package's ``ring_attention``.

Every case of ``tests/test_ring_attention.py`` (matches full, causal,
padding bias, gradients, gradients with a padding bias), at sp = 2 and 4:
the JAX side on the conftest's virtual CPU devices (an sp mesh of 2 or 4
of them; its flash ring through ``impl="flash_interpret"``, the shared
harness's lax fallback per block), the port side in a gloo pool of CPU
ranks (``torch_tp_pool``), each rank given its sequence block of the same
numpy inputs. The port's composed path ("xla") is held to JAX's "xla",
its flash ring ("plain": the kernels' plain block functions; "auto": the
same here, with F1's head-dim padding) to JAX's "flash_interpret", within
the reference contract's atol = rtol = 2e-5, output and dq/dk/dv. Also:
the flash ring's per-block logic by counting the plain block calls (the
causal case switch, skipped blocks calling nothing, one global lse and the
merged output's delta in every backward block), the registered entry, and
``BertModel(attn_impl="ring")`` at sp=2 against JAX BERT with ring.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.mesh import MeshConfig, make_mesh, mesh_context
from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.bert import BertModel as JaxBertModel
from paddle_tpu.ops import attention as JA
from paddle_tpu.parallel.ring_attention import ring_attention as jax_ring
from paddle_tpu_torch.kernels import registry
from paddle_tpu_torch.parallel import ring_attention as R
from torch_tp_pool import TpPool

TOL = dict(atol=2e-5, rtol=2e-5)
B, H, S, D = 2, 2, 32, 8


@pytest.fixture(scope="module")
def pools():
    ps = {2: TpPool(2), 4: TpPool(4)}
    yield ps
    for p in ps.values():
        p.close()


def _inputs(seed, lengths=None):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, H, S, D)).astype(np.float32)
                   for _ in range(4))
    bias = None
    if lengths is not None:
        mask = np.arange(S)[None, :] < np.asarray(lengths)[:, None]
        bias = np.asarray(JA.make_padding_bias(jnp.asarray(mask)))
    return q, k, v, do, bias


#: the reference test's cases: (inputs seed, causal, key lengths)
CASES = {"matches_full": (0, False, None), "causal": (1, True, None),
         "padding_bias": (2, False, (20, 32)), "grads": (3, True, None),
         "grads_noncausal": (3, False, None),
         "grads_with_padding_bias": (4, False, (24, 32))}


@functools.lru_cache(maxsize=None)
def _jax_ring(case, sp, impl):
    """JAX ring_attention's output and dq/dk/dv (the backward seeded with
    ``do``) on an sp mesh of ``sp`` CPU devices."""
    seed, causal, lengths = CASES[case]
    q, k, v, do, bias = _inputs(seed, lengths)
    mesh = make_mesh(MeshConfig(sp=sp), devices=jax.devices()[:sp])
    b = None if bias is None else jnp.asarray(bias)

    def f(q, k, v):
        return jax_ring(q, k, v, bias=b, causal=causal, mesh=mesh, impl=impl)

    def fwd_bwd(q, k, v, do):
        out, vjp = jax.vjp(f, q, k, v)
        return (out,) + tuple(vjp(do))

    with mesh_context(mesh):
        res = jax.jit(fwd_bwd)(*map(jnp.asarray, (q, k, v, do)))
    return tuple(np.asarray(r) for r in res)


def _port_ring(pool, case, impl, count_blocks=False):
    seed, causal, lengths = CASES[case]
    q, k, v, do, bias = _inputs(seed, lengths)
    got = pool.run("ring", timeout_s=60, q=q, k=k, v=v, do=do, bias=bias,
                   causal=causal, impl=impl, count_blocks=count_blocks)
    cat = lambda key: np.concatenate([g[key] for g in got], axis=2)
    return (cat("out"), cat("dq"), cat("dk"), cat("dv")), got


IMPLS = [("xla", "xla"), ("plain", "flash_interpret"),
         ("auto", "flash_interpret")]


@pytest.mark.parametrize("impl,jax_impl", IMPLS, ids=[i for i, _ in IMPLS])
@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_ring_matches_the_reference_ring(pools, case, sp, impl, jax_impl):
    want = _jax_ring(case, sp, jax_impl)
    got, _ = _port_ring(pools[sp], case, impl)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=f"{case} sp={sp} {name}",
                                   **TOL)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_matches_dense_attention(pools, sp):
    """The reference test's own check: the ring against full attention
    on the whole sequence (the JAX composed path)."""
    seed, causal, lengths = CASES["padding_bias"]
    q, k, v, _, bias = _inputs(seed, lengths)
    ref = np.asarray(JA.scaled_dot_product_attention(
        *map(jnp.asarray, (q, k, v)), bias=jnp.asarray(bias)))
    got, _ = _port_ring(pools[sp], "padding_bias", "plain")
    np.testing.assert_allclose(got[0], ref, **TOL)


@pytest.mark.parametrize("sp", [2, 4])
def test_flash_ring_blocks_by_case(pools, sp):
    """Causal: rank r calls the plain forward block r + 1 times (the
    diagonal with its causal mask first, then the earlier blocks
    unmasked) and skips the n - 1 - r later blocks without a call; the
    backward alike, every block against the one merged lse and delta =
    rowsum(do * out) of the merged output."""
    _, got = _port_ring(pools[sp], "grads", "plain", count_blocks=True)
    for r, g in enumerate(got):
        assert g["fwd_calls"] == [True] + [False] * r
        assert g["bwd_causal"] == [True] + [False] * r
        assert g["stats"]["fwd"] == {"diagonal": 1, "visible": r,
                                     "skipped": sp - 1 - r}
        assert g["stats"]["bwd"] == g["stats"]["fwd"]
        assert g["bwd_one_lse"] and g["bwd_global_delta"]
    _, got = _port_ring(pools[sp], "matches_full", "plain",
                        count_blocks=True)
    for g in got:
        assert g["fwd_calls"] == [False] * sp
        assert g["stats"]["fwd"] == {"diagonal": 0, "visible": sp,
                                     "skipped": 0}


def test_ring_refuses_without_a_mesh_and_unknown_impls():
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="requires a mesh"):
        R.ring_attention(q, q, q)
    with pytest.raises(ValueError, match="unknown impl"):
        R.ring_attention(q, q, q, mesh=object(), impl="pallas")


def test_ring_dropout_refused_by_the_layer():
    from paddle_tpu_torch.nn.transformer import MultiHeadAttention
    with pytest.raises(ValueError, match="dropout"):
        MultiHeadAttention(16, 2, dropout=0.1, attn_impl="ring")


def test_the_ring_entry_declares_the_reference_contract():
    from paddle_tpu import kernels as jax_kernels
    entry = registry.get_composite("ring_attention")
    ref = jax_kernels.get("ring_attention")
    assert entry.name == "ring_attention" and ref.requires_mesh
    assert entry.requires_mesh and entry.version == ref.contract.version
    assert (entry.atol, entry.rtol) == (ref.contract.atol, ref.contract.rtol)
    assert set(entry.arg_layouts) == set(ref.contract.arg_layouts)
    assert set(entry.inner) <= set(registry.names())
    # the seven kernels stay the only kernel entries
    assert len(registry.names()) == 7


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_ring_entry_battery(pools, seed):
    """``harness.parity_check("ring_attention", seed)`` on every rank of
    an sp=2 group: each leg within the contract of the dense attention,
    and the sample shapes are the reference's."""
    for errs in pools[2].run("ring_parity", timeout_s=60, seed=seed):
        assert set(errs) == {"xla", "plain", "auto"}
        assert max(errs.values()) <= 2e-5
    from paddle_tpu import kernels as jax_kernels
    (q, _, _), kw = R.sample_inputs(seed)
    (jq, _, _), jkw = jax_kernels.get("ring_attention").sample_inputs(seed)
    assert tuple(q.shape) == tuple(jq.shape) and kw == jkw


@pytest.mark.parametrize("masked", [False, True], ids=["ids", "padded"])
def test_bert_with_ring_matches_the_reference(pools, masked):
    """``BertModel(attn_impl="ring")`` at sp=2 (each rank its 16 of 32
    tokens) against JAX BERT with ring on an sp=2 mesh: the sequence
    output and, on every rank, the pooled output."""
    cfg = dict(attn_impl="ring", dropout=0.0, attn_dropout=0.0,
               max_position=32)
    jcfg = JaxBertConfig.tiny(**cfg)
    jmodel = JaxBertModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    mask = (np.arange(32)[None, :] < np.array([[20], [32]])) if masked \
        else None
    mesh = make_mesh(MeshConfig(sp=2), devices=jax.devices()[:2])
    with mesh_context(mesh):
        seq, pooled = jax.jit(lambda p, i, m: jmodel(
            p, i, attention_mask=m))(params, jnp.asarray(ids),
                                    None if mask is None
                                    else jnp.asarray(mask))
    got = pools[2].run("bert_ring", timeout_s=60,
                       params=jax.device_get(params), cfg=cfg,
                       ids=ids.astype(np.int64), mask=mask)
    np.testing.assert_allclose(np.concatenate([g[0] for g in got], 1),
                               np.asarray(seq), **TOL)
    for _, p in got:
        np.testing.assert_allclose(p, np.asarray(pooled), **TOL)
