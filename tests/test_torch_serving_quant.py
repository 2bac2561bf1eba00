"""The port's int8 page pool against the JAX package on the CPU.

``quantize_kv`` must give bit-identical int8 rows and scales to
``paddle_tpu.serving.paged_cache.quantize_kv``; the dequant-attend plain
versions must match the reference's int8 kernels through its lax fallback
AND its Pallas body in interpret mode, on the reference's own
``_make_paged_int8_sample`` inputs, within the int8 kernel contract's
5e-5; and the port's engine with ``cache_dtype=torch.int8`` must produce
greedy tokens identical to the JAX engine with ``cache_dtype=jnp.int8``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import observability as jax_obs
from paddle_tpu import serving as jax_serving
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.serving import decode_attention as DA
from paddle_tpu.serving import paged_cache as jax_cache
from paddle_tpu_torch.inference import make_serving_engine
from paddle_tpu_torch.kernels import registry
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.observability import MetricsRegistry
from paddle_tpu_torch.serving import paged_attention as PA
from paddle_tpu_torch.serving.paged_cache import (KV_SCALE_FLOOR,
                                                  PagedCacheConfig,
                                                  PagedKVCache, quantize_kv)

torch.set_num_threads(2)

TOL = dict(atol=5e-5, rtol=5e-5)
DIMS = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
            ffn_size=32, max_position=64)
KERNELS = {
    "decode": (DA.ragged_paged_decode_int8_attention,
               PA.ragged_paged_decode_int8_attention, False),
    "prefill": (DA.ragged_paged_prefill_int8_attention,
                PA.ragged_paged_prefill_int8_attention, True),
}


def _torch(args):
    return tuple(torch.from_numpy(np.array(a)) for a in args)


def _assert_same_quantization(x, axes):
    want_q, want_s = jax_cache.quantize_kv(jnp.asarray(x), axes)
    got_q, got_s = quantize_kv(torch.from_numpy(x), axes)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("case", ["decode", "prefill", "zero_row"])
def test_quantize_kv_is_bit_identical_to_the_reference(case):
    rng = np.random.default_rng(7)
    if case == "decode":
        x, axes = rng.standard_normal((8, 4, 32)).astype(np.float32), (1, 2)
    else:
        x = (3 * rng.standard_normal((4, 16, 4, 32))).astype(np.float32)
        axes = (2, 3)
    if case == "zero_row":
        x[1, 5] = 0.0                        # an all-zero token: the floor
    _assert_same_quantization(x, axes)
    if case == "zero_row":
        q, s = quantize_kv(torch.from_numpy(x), axes)
        assert float(s[1, 5]) == pytest.approx(KV_SCALE_FLOOR / 127.0)
        assert torch.all(q[1, 5] == 0)


def test_quantize_kv_on_twenty_serving_slabs():
    rng = np.random.default_rng(11)
    for _ in range(20):
        x = rng.standard_normal((16, 64, 4, 32)).astype(np.float32)
        _assert_same_quantization(x, (2, 3))


@pytest.mark.parametrize("impl", ["lax", "pallas_interpret"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_plain_matches_reference_kernel(seed, kind, impl):
    jax_fn, port_fn, chunked = KERNELS[kind]
    args, _ = DA._make_paged_int8_sample(seed, chunked=chunked)
    ref = np.asarray(jax_fn(*args, impl=impl))
    got = port_fn(*_torch(args)).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_int8_plain_matches_dense_reference(kind):
    entry = registry.get(f"ragged_paged_{kind}_int8")
    args, _ = DA._make_paged_int8_sample(1, chunked=KERNELS[kind][2])
    targs = _torch(args)
    np.testing.assert_allclose(entry.plain_fn(*targs).numpy(),
                               entry.reference_fn(*targs).numpy(), **TOL)


def _int8_pages(seed, s=4, h=2, dh=8, ps=4, mp=4, p=24):
    rng = np.random.default_rng(seed)
    kq, ks = quantize_kv(torch.from_numpy(
        rng.standard_normal((p, ps, h, dh)).astype(np.float32)), (2, 3))
    vq, vs = quantize_kv(torch.from_numpy(
        rng.standard_normal((p, ps, h, dh)).astype(np.float32)), (2, 3))
    bt = (1 + rng.permutation(s * mp)).reshape(s, mp).astype(np.int32)
    return rng, (kq, vq, ks, vs), torch.from_numpy(bt)


def test_dead_rows_emit_exact_zeros():
    rng, pages, bt = _int8_pages(0)
    q = torch.from_numpy(rng.standard_normal((4, 2, 8)).astype(np.float32))
    lens = torch.tensor([0, 1, 7, 16], dtype=torch.int32)
    dec = PA.ragged_paged_decode_int8_attention(q, *pages, bt, lens)
    assert torch.all(dec[0] == 0)
    want = np.asarray(DA.ragged_paged_decode_int8_attention(
        *map(jnp.asarray, (q.numpy(), *(t.numpy() for t in pages),
                           bt.numpy(), lens.numpy())),
        impl="pallas_interpret"))
    np.testing.assert_allclose(dec.numpy(), want, **TOL)
    qc = torch.from_numpy(rng.standard_normal((4, 4, 2, 8)).astype(np.float32))
    starts = torch.tensor([0, 3, 0, 9], dtype=torch.int32)
    nv = torch.tensor([2, 4, 0, 1], dtype=torch.int32)    # slot 2 inactive
    pre = PA.ragged_paged_prefill_int8_attention(qc, *pages, bt, starts, nv)
    assert torch.all(pre[0, 2:] == 0) and torch.all(pre[2] == 0)
    assert torch.all(pre[3, 1:] == 0)


def test_int8_pool_layout_and_bytes():
    kw = dict(num_layers=2, num_heads=3, head_dim=8, num_slots=2,
              page_size=4, num_pages=6, max_pages_per_slot=2)
    q8 = PagedKVCache(PagedCacheConfig(dtype=torch.int8, **kw), device="cpu")
    bf = PagedKVCache(PagedCacheConfig(dtype=torch.bfloat16, **kw),
                      device="cpu")
    assert q8.config.quantized and not bf.config.quantized
    kp, vp, ks, vs = q8.pages[0]
    assert kp.dtype == vp.dtype == torch.int8 and kp.shape == (6, 4, 3, 8)
    assert ks.dtype == vs.dtype == torch.float32 and ks.shape == (6, 4)
    # per token per layer: K and V at H*Dh bytes each plus two 4-byte
    # scales (int8), against 2*H*Dh*esize (bf16: esize 2)
    assert q8.bytes_per_page() == 2 * 4 * (2 * 3 * 8 + 8)
    assert bf.bytes_per_page() == 2 * 4 * (2 * 3 * 8 * 2)
    assert q8.capacity_bytes() == q8.bytes_per_page() * 5
    q8.reserve(0, 6)
    assert q8.live_bytes() == 2 * q8.bytes_per_page()


def test_int8_work_counts_one_byte_per_element_plus_scales():
    rng, pages, bt = _int8_pages(2)
    q = torch.from_numpy(rng.standard_normal((4, 2, 8)).astype(np.float32))
    lens = torch.tensor([0, 1, 7, 16], dtype=torch.int32)
    nbytes, flops = PA.decode_int8_work(q, *pages, bt, lens)
    h, dh = 2, 8
    assert flops == 4 * 24 * h * dh
    # 3 live q rows + 24 live tokens x (K and V: H*Dh bytes + a 4-byte
    # scale) + 1+2+4 page ids + 4 lengths + the (S, H, Dh) fp32 output
    assert nbytes == (4 * 3 * h * dh + 2 * 24 * (h * dh + 4) + 4 * (7 + 4)
                      + 4 * 4 * h * dh)


# -- the int8 engine against the JAX engine -----------------------------------

@pytest.fixture(scope="module")
def models():
    jmodel = JaxGPT(JaxGPTConfig.tiny(dropout=0.0, attn_impl="xla", **DIMS))
    params = jmodel.init(jax.random.PRNGKey(3))
    model = GPT.from_jax(GPTConfig(**DIMS), jax.device_get(params),
                         device="cpu")
    return jmodel, params, model


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, n).astype(np.int32) for n in lens]


def _both_int8(models, prompts, max_new, eos_id=None, **kw):
    jmodel, params, model = models
    ref = jax_serving.ServingEngine(
        jmodel, params, attn_impl="lax", cache_dtype=jnp.int8,
        registry=jax_obs.MetricsRegistry(), **kw).generate_many(
            prompts, max_new_tokens=max_new, eos_id=eos_id, max_steps=500)
    reg = MetricsRegistry()
    eng = make_serving_engine(model, device="cpu", cache_dtype=torch.int8,
                              registry=reg, **kw)
    got = eng.generate_many(prompts, max_new_tokens=max_new, eos_id=eos_id,
                            max_steps=500)
    assert eng.cache.config.quantized
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    eng.cache.check_invariants()
    assert eng.cache.pages_in_use == 0
    return eng, reg, got


def test_int8_engine_mixed_lengths_over_several_chunks(models):
    _both_int8(models, _prompts(3, [5, 9, 3, 21, 7, 30, 12]), 6,
               num_slots=3, page_size=4, prefill_chunk=8)


@pytest.mark.parametrize("share", [False, True], ids=["no_share", "share"])
def test_int8_engine_prefix_sharing_with_cow_duplicate(models, share):
    rng = np.random.default_rng(20)
    prefix = rng.integers(1, 64, 10).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(1, 64, t).astype(np.int32)])
               for t in (3, 5, 2, 7)]
    prompts.append(prompts[1].copy())       # verbatim duplicate: int8 CoW
    eng, reg, _ = _both_int8(models, prompts, 5, num_slots=2, page_size=4,
                             prefill_chunk=8, prefix_sharing=share)
    if share:
        assert eng.cache.cow_copies_total > 0
        assert reg.counter("serving_prefix_cow_total").value() > 0
    else:
        assert eng.cache.cow_copies_total == 0


def test_int8_engine_early_eos(models):
    _, _, model = models
    prompts = _prompts(5, [6, 11])
    full = make_serving_engine(model, device="cpu", cache_dtype=torch.int8,
                               num_slots=2, page_size=4).generate_many(
                                   prompts[:1], max_new_tokens=12)[0]
    eos = int(full[3])
    _, _, got = _both_int8(models, prompts, 12, eos_id=eos, num_slots=2,
                           page_size=4)
    stop = int(np.argmax(full == eos)) + 1
    np.testing.assert_array_equal(got[0], full[:stop])
    assert len(got[0]) < 12


def test_copy_page_carries_the_scale_rows(models):
    _, _, model = models
    eng = make_serving_engine(model, device="cpu", cache_dtype=torch.int8,
                              num_slots=2, page_size=4)
    for layer in eng.cache.pages:
        for t in layer:
            t[3] = 1 if t.dtype == torch.int8 else 0.5
    eng._copy_page(3, 5)
    for layer in eng.cache.pages:
        assert len(layer) == 4
        for t in layer:
            assert torch.equal(t[5], t[3])
