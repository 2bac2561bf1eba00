"""The port's ragged paged attention against the JAX reference on the CPU.

The plain PyTorch versions of the decode and prefill kernels must match
``paddle_tpu.serving.decode_attention`` run through its lax fallback AND
through the real Pallas kernel in interpret mode, on the reference's own
``_make_paged_sample`` inputs, within the kernel contract's 2e-5. The
CUDA kernels themselves run only on the card (``chip_smoke.py``); here
the tests pin that a CUDA request without a card raises instead of
falling back to the CPU, and that the nvcc build refuses to run
without a compiler.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving import decode_attention as DA
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.kernels import build, registry
from paddle_tpu_torch.serving import paged_attention as PA

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)
KERNELS = {
    "decode": (DA.ragged_paged_decode_attention,
               PA.ragged_paged_decode_attention, False),
    "prefill": (DA.ragged_paged_prefill_attention,
                PA.ragged_paged_prefill_attention, True),
}


def _torch(args):
    return tuple(torch.from_numpy(np.array(a)) for a in args)


@pytest.mark.parametrize("impl", ["lax", "pallas_interpret"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_reference_kernel(seed, kind, impl):
    jax_fn, port_fn, chunked = KERNELS[kind]
    args, _ = DA._make_paged_sample(seed, chunked=chunked)
    ref = np.asarray(jax_fn(*args, impl=impl))
    got = port_fn(*_torch(args)).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_plain_matches_dense_reference(kind):
    entry = registry.get(f"ragged_paged_{kind}")
    args, _ = DA._make_paged_sample(2, chunked=KERNELS[kind][2])
    targs = _torch(args)
    np.testing.assert_allclose(entry.plain_fn(*targs).numpy(),
                               entry.reference_fn(*targs).numpy(), **TOL)


def _decode_setup(seed=0, s=4, h=2, dh=8, ps=4, mp=4, p=24):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((s, h, dh)).astype(np.float32)
    kp = rng.standard_normal((p, ps, h, dh)).astype(np.float32)
    vp = rng.standard_normal((p, ps, h, dh)).astype(np.float32)
    bt = (1 + rng.permutation(s * mp)).reshape(s, mp).astype(np.int32)
    return q, kp, vp, bt


def test_decode_zero_length_slots_emit_exact_zeros():
    q, kp, vp, bt = _decode_setup()
    lens = np.asarray([0, 1, 7, 16], np.int32)
    ref = np.asarray(DA.ragged_paged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, bt, lens)), impl="pallas_interpret"))
    got = PA.ragged_paged_decode_attention(*_torch((q, kp, vp, bt, lens)))
    assert torch.all(got[0] == 0)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_prefill_padding_lanes_and_inactive_slots_emit_exact_zeros():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 4, 2, 8)).astype(np.float32)
    _, kp, vp, bt = _decode_setup(seed=1, s=3)
    starts = np.asarray([0, 3, 0], np.int32)
    nv = np.asarray([2, 4, 0], np.int32)          # slot 2 inactive
    args = (q, kp, vp, bt, starts, nv)
    ref = np.asarray(DA.ragged_paged_prefill_attention(
        *map(jnp.asarray, args), impl="pallas_interpret"))
    got = PA.ragged_paged_prefill_attention(*_torch(args))
    assert torch.all(got[0, 2:] == 0) and torch.all(got[2] == 0)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_stale_page_poison_is_never_attended(kind):
    """NaN in every page no block table references, and a finite poison
    in the dead tail of each slot's last live page: the output depends
    on the live tokens only."""
    q, kp, vp, bt = _decode_setup(seed=2)
    if kind == "decode":
        horizon = np.asarray([6, 0, 13, 16], np.int32)
        rest = (horizon,)
        q_in = q
    else:
        rng = np.random.default_rng(3)
        q_in = rng.standard_normal((4, 4, 2, 8)).astype(np.float32)
        starts = np.asarray([2, 0, 9, 5], np.int32)
        nv = np.asarray([4, 0, 3, 2], np.int32)
        rest = (starts, nv)
        horizon = np.where(nv > 0, starts + nv, 0)
    fn = KERNELS[kind][1]
    clean = fn(*_torch((q_in, kp, vp, bt, *rest)))
    pk, pv = kp.copy(), vp.copy()
    unreferenced = np.setdiff1d(np.arange(kp.shape[0]), bt)
    pk[unreferenced] = np.nan
    pv[unreferenced] = np.nan
    ps = kp.shape[1]
    for s, n in enumerate(horizon):
        if n % ps:
            pk[bt[s, n // ps], n % ps:] = 1e6
            pv[bt[s, n // ps], n % ps:] = 1e6
    poisoned = fn(*_torch((q_in, pk, pv, bt, *rest)))
    assert torch.isfinite(poisoned).all()
    np.testing.assert_allclose(poisoned.numpy(), clean.numpy(), **TOL)


def test_registry_entries_declare_the_replaced_tpu_kernels():
    names = registry.load_all()
    assert names == ("flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                     "flash_attention_fwd", "ragged_paged_decode",
                     "ragged_paged_decode_int8", "ragged_paged_prefill",
                     "ragged_paged_prefill_int8")
    for name, line, tol in (("ragged_paged_decode", 265, 2e-5),
                            ("ragged_paged_prefill", 443, 2e-5),
                            ("ragged_paged_decode_int8", 356, 5e-5),
                            ("ragged_paged_prefill_int8", 533, 5e-5)):
        e = registry.get(name)
        assert e.route == "cuda"
        assert e.source == "paddle_tpu_torch/csrc/paged_attention.cu"
        assert e.replaces == f"paddle_tpu/serving/decode_attention.py:{line}"
        assert e.tolerance[torch.float32] == (tol, tol)
        assert e.tolerance[torch.bfloat16] == (1e-2, 1e-2)
    registry.get("ragged_paged_decode").launches = 5
    registry.reset_launches()
    assert registry.get("ragged_paged_decode").launches == 0


def test_decode_work_counts_live_tokens_only():
    q, kp, vp, bt = _decode_setup()
    lens = np.asarray([0, 1, 7, 16], np.int32)
    nbytes, flops = PA.decode_work(*_torch((q, kp, vp, bt, lens)))
    h, dh = 2, 8
    assert flops == 4 * 24 * h * dh
    # 3 live q rows + 24 live K and V tokens + 1+2+4 page ids + 4
    # lengths, fp32, plus the (S, H, Dh) output
    assert nbytes == 4 * (3 * h * dh + 2 * 24 * h * dh + 7 + 4 + 4 * h * dh)


def test_cuda_without_a_card_raises_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path is moot")
    from paddle_tpu_torch.inference import make_serving_engine
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPT(GPTConfig.tiny())                   # the default is the card
    model = GPT(GPTConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_serving_engine(model)
    q, kp, vp, bt = _decode_setup()
    lens = np.asarray([1, 2, 3, 4], np.int32)
    # the CUDA wrapper refuses CPU tensors rather than running them
    with pytest.raises(ValueError, match="CUDA tensors"):
        PA.paged_decode_cuda(*_torch((q, kp, vp, bt, lens)))
    before = PA.DECODE.launches
    meta = [torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                        device="meta") for a in (q, kp, vp, bt, lens)]
    with pytest.raises(ValueError, match="unsupported device"):
        PA.ragged_paged_decode_attention(*meta)
    assert PA.DECODE.launches == before


def test_paged_cache_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path is moot")
    from paddle_tpu_torch.serving.paged_cache import (PagedCacheConfig,
                                                      PagedKVCache)
    cfg = PagedCacheConfig(num_layers=1, num_heads=2, head_dim=4, num_slots=2,
                           num_pages=4, max_pages_per_slot=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(cfg)
    for dtype in (torch.float32, torch.int8):
        cfg.dtype = dtype
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PagedKVCache(cfg, device="cuda")
        assert PagedKVCache(cfg, device="cpu").pages[0][0].device.type == "cpu"


@pytest.mark.parametrize("seed", [0, 1])
def test_single_slot_prefill_matches_the_reference(seed):
    q, kp, vp, bt = _decode_setup(seed=seed)
    rng = np.random.default_rng(seed + 10)
    qc = rng.standard_normal((5, 2, 8)).astype(np.float32)
    positions = np.asarray([3, 4, 5, 6, 7], np.int32) + 4 * seed
    ref = np.asarray(DA.paged_prefill_attention(
        *map(jnp.asarray, (qc, kp, vp, bt[1], positions))))
    got = PA.paged_prefill_attention(*_torch((qc, kp, vp, bt[1], positions)))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()


def test_library_name_follows_the_source_content(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    first = build.library_path("k")
    assert build.library_path("k") == first
    src.write_text("// v2\n")
    assert build.library_path("k") != first
    assert build.sources() == ["k"]
    assert first.parent == tmp_path / "build"
