"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

They skip without a CUDA device and import neither jax nor the JAX
package, so they run on the GPU machine as they are:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Beyond ``chip_smoke.py`` (which checks the serving shapes), they cover
the geometry the kernels promise: any head dim up to 256 (including
ones that are not a multiple of 32), any page size up to 256, both
element types, and the wrapper's refusals.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.serving import paged_attention as PA

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(seed, s, h, dh, ps, w, c, device):
    rng = np.random.default_rng(seed)
    n_pages = 1 + s * w
    kp = rng.standard_normal((n_pages, ps, h, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, h, dh)).astype(np.float32)
    bt = (1 + rng.permutation(s * w)).reshape(s, w).astype(np.int32)
    lengths = rng.integers(0, w * ps + 1, s).astype(np.int32)
    lengths[0] = 0
    starts = rng.integers(0, max(w * ps - c, 0) + 1, s).astype(np.int32)
    n_valid = rng.integers(0, c + 1, s).astype(np.int32)
    qd = rng.standard_normal((s, h, dh)).astype(np.float32)
    qp = rng.standard_normal((s, c, h, dh)).astype(np.float32)
    t = {k: torch.from_numpy(v).to(device) for k, v in dict(
        kp=kp, vp=vp, bt=bt, lengths=lengths, starts=starts,
        n_valid=n_valid, qd=qd, qp=qp).items()}
    return t


GEOMETRIES = [  # (S, H, Dh, ps, w, C)
    (3, 2, 64, 16, 4, 16),
    (2, 3, 48, 8, 5, 7),
    (2, 1, 256, 4, 3, 5),
    (2, 2, 16, 256, 2, 33),
    (4, 2, 33, 1, 20, 6),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "x".join(map(str, g)))
def test_kernels_match_plain_versions(dev, geom, dtype):
    s, h, dh, ps, w, c = geom
    t = _inputs(sum(geom), s, h, dh, ps, w, c, dev)
    kp, vp = t["kp"].to(dtype), t["vp"].to(dtype)
    atol, rtol = PA.DECODE.tolerance[dtype]
    cases = (
        (PA.DECODE, (t["qd"].to(dtype), kp, vp, t["bt"], t["lengths"])),
        (PA.PREFILL, (t["qp"].to(dtype), kp, vp, t["bt"], t["starts"],
                      t["n_valid"])),
    )
    for entry, args in cases:
        before = entry.launches
        got = entry.cuda_fn(*args)
        torch.cuda.synchronize()
        assert entry.launches == before + 1
        assert got.dtype == dtype and got.shape == args[0].shape
        ref = entry.plain_fn(*(a.float() if a.is_floating_point() else a
                               for a in args))
        torch.testing.assert_close(got.float(), ref, atol=atol, rtol=rtol)
    dec = PA.DECODE.cuda_fn(*cases[0][1])
    assert torch.all(dec[0] == 0)                     # lengths[0] == 0


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    t = _inputs(0, 2, 2, 64, 16, 3, 4, dev)
    args = (t["qd"], t["kp"], t["vp"], t["bt"], t["lengths"])
    with pytest.raises(ValueError, match="contiguous"):
        PA.paged_decode_cuda(t["qd"].transpose(0, 1).contiguous()
                             .transpose(0, 1), *args[1:])
    with pytest.raises(ValueError, match="bfloat16|float32"):
        PA.paged_decode_cuda(t["qd"].bfloat16(), *args[1:])
    with pytest.raises(ValueError, match="int32"):
        PA.paged_decode_cuda(*args[:3], t["bt"].long(), t["lengths"])
    with pytest.raises(TypeError, match="not supported"):
        PA.paged_decode_cuda(*(a.half() if a.is_floating_point() else a
                               for a in args))
    big = torch.zeros((4, 4, 1, 300), device=dev)
    with pytest.raises(ValueError, match="Dh <= 256"):
        PA.paged_decode_cuda(torch.zeros((2, 1, 300), device=dev), big, big,
                             t["bt"], t["lengths"])


def test_engine_on_the_card_matches_the_cpu_engine(dev):
    from paddle_tpu_torch.inference import make_serving_engine
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    cfg = GPTConfig.tiny(vocab_size=64, hidden_size=32, num_heads=2)
    cpu = GPT(cfg, device="cpu", seed=5)
    gpu = GPT(cfg, device=dev, seed=5)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 64, n).astype(np.int32) for n in (5, 17, 9)]
    kw = dict(num_slots=2, page_size=4, prefill_chunk=8)
    want = make_serving_engine(cpu, device="cpu", **kw).generate_many(
        prompts, 6)
    PA.DECODE.launches = PA.PREFILL.launches = 0
    got = make_serving_engine(gpu, device=dev, **kw).generate_many(prompts, 6)
    assert PA.DECODE.launches > 0 and PA.PREFILL.launches > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_out_of_range_page_ids_clamp_like_the_reference_gather(dev):
    t = _inputs(1, 2, 2, 64, 16, 3, 4, dev)
    n_pages = t["kp"].shape[0]
    full = torch.full((2,), 3 * 16, dtype=torch.int32, device=dev)
    bad, last = t["bt"].clone(), t["bt"].clone()
    bad[:, -1] = n_pages + 7
    last[:, -1] = n_pages - 1
    args = (t["qd"], t["kp"], t["vp"])
    torch.testing.assert_close(PA.paged_decode_cuda(*args, bad, full),
                               PA.paged_decode_cuda(*args, last, full),
                               atol=0, rtol=0)
