"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

They skip without a CUDA device and import neither jax nor the JAX
package, so they run on the GPU machine as they are:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Beyond ``chip_smoke.py`` (which checks the serving shapes), they cover
the geometry the kernels promise: any head dim up to 256 (including
ones that are not a multiple of 32), any page size up to 256, both
element types, the int8 dequant-attend kernels over Dh 32/64/128 and
pages of 8 and 16 with clamped page ids, the redesigned int8 decode (K2)
and tensor-core prefill (K4) at Dh 64/48/33/128, a 4-row verify chunk
and a 64-row prefill chunk, on an aligned and a misaligned pool, the
tensor-core fp prefill (K3) over the same head dims and chunks, on an
aligned and a misaligned bf16 pool and past its page-id table, the
int8 and speculative engines at tiny size, the engine's captured CUDA
graphs against eager dispatch (tokens, launch counts, no capture after
warmup) and a capture that fails and must raise, the page-IO graphs
(read, write, read back the same bytes over fp32, bf16 and int8 pools;
pages read back to back never alias the static output), slot migration
between graphed engines mid-decode, ``generate_bucketed``'s one captured
decode graph per bucket against ``generate``, tiny GPT and BERT with head
dim 16 training through the flash kernels as on the CPU (fault F1), the
flash kernels over head dims 32/64/128 with lengths that are not
multiples of their tiles (bf16 runs on the tensor cores) and their
bitwise reproducibility, the wrappers' refusals, and the train step
through one captured graph: bitwise equal to eager on tiny GPT and BERT
with the flash launches counted per replay, a failed capture that
raises, fresh dropout masks per replay, an AMP overflow skipped inside
the graph, and remat under graphs. K1-K4 under every configuration
their contracts declare (one each: the warps a block the kernels fix),
and fault F9's round of threaded replicas beside a capture, 20 times in one
process. Pipelines on the card: a pp=2 group of two processes on
``cuda:0`` training the full-width 2-layer BERT against pp=1, and its
pp-split snapshot restored per stage and whole. The native runner: K5
through its C++ registration bit for bit K5 through the Python op, and a
frozen bf16 tiny Transformer served from C++ with K5 counted there.
The analysis tiers on CUDA tensors: the registered kernels as single
nodes of a trace that launches and allocates nothing, and a copy to the
host found in a step.
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("dh", [64, 48, 33, 256])
def test_decode_few_long_slots_matches_plain_and_repeats_bitwise(dev, dh,
                                                                dtype):
    """Few slots and wide block tables: each warp of the fp decode
    kernel's block folds many pages. Lengths sit at the edges of the
    split of pages over the 8 warps; 16-byte and one-element loads (dh
    33)."""
    s, h, ps, w = 2, 2, 8, 64
    t = _inputs(dh, s, h, dh, ps, w, 1, dev)
    kp, vp = t["kp"].to(dtype), t["vp"].to(dtype)
    q = t["qd"].to(dtype)
    atol, rtol = PA.DECODE.tolerance[dtype]
    for lengths in ((w * ps, w * ps // 2), (3 * ps + 1, 8 * ps),
                    (0, 1), (ps * 7, w * ps - 1)):
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        got = PA.paged_decode_cuda(q, kp, vp, t["bt"], lens)
        again = PA.paged_decode_cuda(q, kp, vp, t["bt"], lens)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert torch.all(got[lens == 0] == 0)
        ref = PA.paged_decode_plain(q.float(), kp.float(), vp.float(),
                                    t["bt"], lens)
        torch.testing.assert_close(got.float(), ref, atol=atol, rtol=rtol)


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


# -- int8 dequant-attend (K2 decode, K4 prefill) ------------------------------

def _int8_inputs(seed, s, h, dh, ps, w, c, device):
    """int8 pages from quantize_kv over seeded normals; the pages no block
    table references carry bytes 127 and NaN scale rows."""
    from paddle_tpu_torch.serving.paged_cache import quantize_kv
    t = _inputs(seed, s, h, dh, ps, w, c, device)
    n_pages = t["kp"].shape[0]
    extra = 3
    pages = []
    for name in ("kp", "vp"):
        q8, sc = quantize_kv(t[name], (2, 3))
        q8 = torch.cat([q8, torch.full((extra,) + q8.shape[1:], 127,
                                       dtype=torch.int8, device=device)])
        sc = torch.cat([sc, torch.full((extra, ps), float("nan"),
                                       device=device)])
        pages.append((q8.contiguous(), sc.contiguous()))
    (t["kq"], t["ks"]), (t["vq"], t["vs"]) = pages
    t["n_live_pages"] = n_pages
    return t


#: geometries for the launch configurations: the serving shape (Dh 64,
#: page 16), a ragged head dim, a long few-slot table, a verify chunk
TUNABLE_GEOMETRIES = [(4, 2, 64, 16, 8, 64), (3, 2, 48, 8, 5, 7),
                      (2, 2, 64, 16, 64, 16), (3, 2, 128, 16, 6, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("geom", TUNABLE_GEOMETRIES,
                         ids=lambda g: "x".join(map(str, g)))
def test_every_launch_configuration_matches_plain(dev, geom, dtype):
    """K1-K4 under every configuration their contracts declare (one
    each: decode 8 warps, K3 8, K4 4), fp32 and bf16, over fp
    and int8 pools (the int8 ones with NaN scale rows on unreferenced
    pages), lengths 0 included: each within the entry's tolerance of the
    plain version, bitwise on a repeat launch, exact zeros for a slot of
    length 0, and counted once per launch."""
    s, h, dh, ps, w, c = geom
    t = _int8_inputs(sum(geom) + 1, s, h, dh, ps, w, c, dev)
    kp, vp = t["kp"].to(dtype), t["vp"].to(dtype)
    q8 = (t["kq"], t["vq"], t["ks"], t["vs"])
    qd, qp = t["qd"].to(dtype), t["qp"].to(dtype)
    cases = (
        (PA.DECODE, (qd, kp, vp, t["bt"], t["lengths"])),
        (PA.PREFILL, (qp, kp, vp, t["bt"], t["starts"], t["n_valid"])),
        (PA.DECODE_INT8, (qd, *q8, t["bt"], t["lengths"])),
        (PA.PREFILL_INT8, (qp, *q8, t["bt"], t["starts"], t["n_valid"])),
    )
    for entry, args in cases:
        atol, rtol = entry.tolerance[dtype]
        ref = entry.plain_fn(args[0].float(), *(
            a.float() if a.is_floating_point() and a.ndim == 4 else a
            for a in args[1:]))
        grid = entry.contract.grid(args)
        assert grid == (entry.contract.prior(args),)
        for blocks in grid:
            before = entry.launches
            got = entry.cuda_fn(*args, blocks=blocks)
            again = entry.cuda_fn(*args, blocks=blocks)
            torch.cuda.synchronize()
            assert entry.launches == before + 2
            what = f"{entry.name} {blocks}"
            assert torch.isfinite(got.float()).all(), what
            torch.testing.assert_close(got.float(), ref, atol=atol,
                                       rtol=rtol, msg=what)
            assert torch.equal(got, again), what
            if args[0].ndim == 3:
                assert torch.all(got[args[-1] == 0] == 0), what


INT8_GEOMETRIES = [(s, h, dh, ps, w, c) for dh in (32, 64, 128)
                   for (s, h, ps, w, c) in ((3, 2, 16, 4, 16), (4, 3, 8, 5, 7))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("geom", INT8_GEOMETRIES,
                         ids=lambda g: "x".join(map(str, g)))
def test_int8_kernels_match_plain_versions(dev, geom, dtype):
    s, h, dh, ps, w, c = geom
    t = _int8_inputs(sum(geom), s, h, dh, ps, w, c, dev)
    pages = (t["kq"], t["vq"], t["ks"], t["vs"])
    cases = (
        (PA.DECODE_INT8, (t["qd"].to(dtype), *pages, t["bt"], t["lengths"])),
        (PA.PREFILL_INT8, (t["qp"].to(dtype), *pages, t["bt"], t["starts"],
                           t["n_valid"])),
    )
    atol, rtol = PA.DECODE_INT8.tolerance[dtype]
    for entry, args in cases:
        before = entry.launches
        got = entry.cuda_fn(*args)
        torch.cuda.synchronize()
        assert entry.launches == before + 1
        assert got.dtype == dtype and got.shape == args[0].shape
        assert torch.isfinite(got.float()).all()
        ref = entry.plain_fn(args[0].float(), *args[1:])
        torch.testing.assert_close(got.float(), ref, atol=atol, rtol=rtol)
        if dtype == torch.float32:
            torch.testing.assert_close(got, entry.reference_fn(*args),
                                       atol=atol, rtol=rtol)
    dec = PA.DECODE_INT8.cuda_fn(*cases[0][1])
    assert torch.all(dec[0] == 0)                     # lengths[0] == 0


def test_int8_out_of_range_page_ids_clamp_with_their_scale_rows(dev):
    t = _int8_inputs(1, 2, 2, 64, 16, 3, 4, dev)
    kq, vq, ks, vs = t["kq"], t["vq"], t["ks"], t["vs"]
    n_pages = kq.shape[0]
    # the last page holds finite content and scales, so a clamped read of
    # the page with another page's scale row would show
    kq[-1] = 5
    vq[-1] = -7
    ks[-1] = 0.25
    vs[-1] = 0.5
    full = torch.full((2,), 3 * 16, dtype=torch.int32, device=dev)
    bad, last = t["bt"].clone(), t["bt"].clone()
    bad[:, -1] = n_pages + 7
    last[:, -1] = n_pages - 1
    pages = (kq, vq, ks, vs)
    got = PA.paged_decode_int8_cuda(t["qd"], *pages, bad, full)
    torch.testing.assert_close(
        got, PA.paged_decode_int8_cuda(t["qd"], *pages, last, full),
        atol=0, rtol=0)
    torch.testing.assert_close(
        got, PA.paged_decode_int8_plain(t["qd"], *pages, last, full),
        **dict(zip(("atol", "rtol"), PA.DECODE_INT8.tolerance[torch.float32])))


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(dev):
    t = _int8_inputs(0, 2, 2, 64, 16, 3, 4, dev)
    q, kq, vq, ks, vs = t["qd"], t["kq"], t["vq"], t["ks"], t["vs"]
    rest = (t["bt"], t["lengths"])
    with pytest.raises(ValueError, match="int8"):
        PA.paged_decode_int8_cuda(q, kq.float(), vq.float(), ks, vs, *rest)
    with pytest.raises(ValueError, match="int8"):
        PA.paged_decode_int8_cuda(q, kq, vq.to(torch.uint8), ks, vs, *rest)
    with pytest.raises(ValueError, match=r"\(P, ps\)"):
        PA.paged_decode_int8_cuda(q, kq, vq, ks[:, :-1].contiguous(), vs,
                                  *rest)
    with pytest.raises(ValueError, match="float32"):
        PA.paged_decode_int8_cuda(q, kq, vq, ks.double(), vs, *rest)
    with pytest.raises(ValueError, match="float32"):
        PA.paged_decode_int8_cuda(q, kq, vq, ks, vs.cpu(), *rest)
    with pytest.raises(ValueError, match="contiguous"):
        PA.paged_decode_int8_cuda(q, kq, vq, ks.t().contiguous().t(), vs,
                                  *rest)
    with pytest.raises(TypeError, match="not supported"):
        PA.paged_decode_int8_cuda(q.half(), kq, vq, ks, vs, *rest)
    with pytest.raises(ValueError, match="CUDA tensors"):
        PA.paged_decode_int8_cuda(q.cpu(), kq.cpu(), vq.cpu(), ks.cpu(),
                                  vs.cpu(), *(a.cpu() for a in rest))
    with pytest.raises(ValueError, match="int8"):
        PA.paged_prefill_int8_cuda(t["qp"], kq.bfloat16(), vq, ks, vs,
                                   t["bt"], t["starts"], t["n_valid"])


def _int8_cases(t, dtype):
    """K2 and K4 (at the chunk of ``t``) on one set of int8 inputs."""
    pages = (t["kq"], t["vq"], t["ks"], t["vs"])
    return ((PA.DECODE_INT8, (t["qd"].to(dtype), *pages, t["bt"],
                              t["lengths"])),
            (PA.PREFILL_INT8, (t["qp"].to(dtype), *pages, t["bt"],
                               t["starts"], t["n_valid"])))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("c", [4, 64], ids=["verify", "prefill"])
@pytest.mark.parametrize("dh", [64, 48, 33, 128, 160])
def test_int8_decode_and_prefill_designs_match_plain_and_repeat_bitwise(
        dev, dh, c, dtype):
    """K2 (16-byte int8 vectors, 8 warps, two buffers; one-element loads
    at dh 33) and K4 (bf16: the tensor-core tile, its 4-row verify split
    and its 64-row prefill; fp32, and bf16 at dh 160: the scalar
    template) over ragged lengths and chunks, with NaN scale rows on
    every unreferenced page: within the registry tolerance of the plain
    versions, two launches bit-identical, dead rows and slots exact
    zeros."""
    s, h, ps, w = 5, 2, 16, 6
    t = _int8_inputs(dh + c, s, h, dh, ps, w, c, dev)
    t["lengths"][:4] = torch.tensor([0, 1, ps, w * ps], dtype=torch.int32)
    t["n_valid"][:3] = torch.tensor([0, c, 1], dtype=torch.int32)
    t["starts"][1] = w * ps - c                      # the chunk ends the slot
    atol, rtol = PA.DECODE_INT8.tolerance[dtype]
    for entry, args in _int8_cases(t, dtype):
        got = entry.cuda_fn(*args)
        again = entry.cuda_fn(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, again), entry.name
        assert torch.isfinite(got.float()).all(), entry.name
        assert torch.all(got[0] == 0), entry.name    # length 0 / inactive
        ref = entry.plain_fn(args[0].float(), *args[1:])
        torch.testing.assert_close(got.float(), ref, atol=atol, rtol=rtol)
    prefill = PA.PREFILL_INT8.cuda_fn(*_int8_cases(t, dtype)[1][1])
    n_valid = t["n_valid"].cpu().numpy()
    for sl in range(s):                              # rows past n_valid
        assert torch.all(prefill[sl, int(n_valid[sl]):] == 0)


def _misaligned(pages):
    """The same pool starting one element past a 16-byte boundary."""
    es = pages.element_size()
    buf = torch.empty(pages.numel() + 16, dtype=pages.dtype,
                      device=pages.device)
    base = (-buf.data_ptr()) % 16 // es + 1
    view = buf[base:base + pages.numel()].view(pages.shape)
    view.copy_(pages)
    assert view.data_ptr() % 16 == es and view.is_contiguous()
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_int8_kernels_on_a_misaligned_pool_take_one_element_loads(dev,
                                                                 dtype):
    """A pool that is not 16-byte aligned takes the one-element path of
    K2 and K4 in the same kernels; K4's staged tile is the same either
    way, so bf16 K4 gives the aligned pool's bits."""
    t = _int8_inputs(3, 4, 2, 64, 16, 5, 64, dev)
    cases = _int8_cases(t, dtype)
    t["kq"], t["vq"] = _misaligned(t["kq"]), _misaligned(t["vq"])
    atol, rtol = PA.DECODE_INT8.tolerance[dtype]
    for (entry, args), (_, moved) in zip(cases, _int8_cases(t, dtype)):
        got = entry.cuda_fn(*moved)
        torch.cuda.synchronize()
        ref = entry.plain_fn(args[0].float(), *args[1:])
        torch.testing.assert_close(got.float(), ref, atol=atol, rtol=rtol)
        if entry is PA.PREFILL_INT8 and dtype == torch.bfloat16:
            assert torch.equal(got, entry.cuda_fn(*args))


# -- fp prefill (K3): the tensor-core tile over bf16 pages -------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("c", [4, 64], ids=["verify", "prefill"])
@pytest.mark.parametrize("dh", [64, 48, 33, 128, 160])
def test_fp_prefill_designs_match_plain_and_repeat_bitwise(dev, dh, c,
                                                          dtype):
    """K3 (bf16 at dh <= 128: the tensor-core tile fed by ldmatrix from
    the staged pages, its 4-row verify split and its 64-row prefill,
    16-byte staging at dh 64/48/128 and one-element staging at dh 33;
    fp32, and bf16 at dh 160: the scalar template) over ragged chunks,
    with NaN in the one page no block table references: within the
    registry tolerance of the plain version, two launches bit-identical,
    dead rows and inactive slots exact zeros."""
    s, h, ps, w = 5, 2, 16, 6
    t = _inputs(dh + c, s, h, dh, ps, w, c, dev)
    t["n_valid"][:3] = torch.tensor([0, c, 1], dtype=torch.int32)
    t["starts"][1] = w * ps - c                      # the chunk ends the slot
    t["kp"][0] = t["vp"][0] = float("nan")           # page 0: unreferenced
    args = (t["qp"].to(dtype), t["kp"].to(dtype), t["vp"].to(dtype),
            t["bt"], t["starts"], t["n_valid"])
    got = PA.PREFILL.cuda_fn(*args)
    again = PA.PREFILL.cuda_fn(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.isfinite(got.float()).all()
    n_valid = t["n_valid"].cpu().numpy()
    for sl in range(s):                              # rows past n_valid
        assert torch.all(got[sl, int(n_valid[sl]):] == 0)
    ref = PA.PREFILL.plain_fn(*(a.float() if a.is_floating_point() else a
                                for a in args))
    atol, rtol = PA.PREFILL.tolerance[dtype]
    torch.testing.assert_close(got.float(), ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_fp_prefill_on_a_misaligned_pool_takes_one_element_loads(dev,
                                                                 dtype):
    """A bf16 pool that is not 16-byte aligned takes K3's one-element
    staging in the same kernel; the staged tile is the same either way,
    so bf16 K3 gives the aligned pool's bits. fp32 takes the scalar
    template either way."""
    t = _inputs(3, 4, 2, 64, 16, 5, 64, dev)
    kp, vp = t["kp"].to(dtype), t["vp"].to(dtype)
    rest = (t["bt"], t["starts"], t["n_valid"])
    q = t["qp"].to(dtype)
    got = PA.PREFILL.cuda_fn(q, _misaligned(kp), _misaligned(vp), *rest)
    torch.cuda.synchronize()
    ref = PA.PREFILL.plain_fn(q.float(), kp.float(), vp.float(), *rest)
    atol, rtol = PA.PREFILL.tolerance[dtype]
    torch.testing.assert_close(got.float(), ref, atol=atol, rtol=rtol)
    if dtype == torch.bfloat16:
        assert torch.equal(got, PA.PREFILL.cuda_fn(q, kp, vp, *rest))


def test_prefill_past_the_page_id_table_takes_the_scalar_template(dev):
    """The tensor-core prefill keeps a block's page ids in shared memory
    for block tables up to 8192 columns (kMaxIdCols); a wider table takes
    the scalar template, bf16 K3 and K4 alike, with the plain versions'
    results."""
    s, h, dh, ps, w, c = 2, 1, 64, 1, 8193, 4
    t = _int8_inputs(7, s, h, dh, ps, w, c, dev)
    t["n_valid"][:] = c
    t["starts"][0] = w * ps - c                      # the table's last column
    rest = (t["bt"], t["starts"], t["n_valid"])
    q = t["qp"].bfloat16()
    atol, rtol = PA.PREFILL.tolerance[torch.bfloat16]
    for entry, pages in ((PA.PREFILL, (t["kp"].bfloat16(),
                                       t["vp"].bfloat16())),
                         (PA.PREFILL_INT8, (t["kq"], t["vq"], t["ks"],
                                            t["vs"]))):
        got = entry.cuda_fn(q, *pages, *rest)
        torch.cuda.synchronize()
        ref = entry.plain_fn(q.float(), *(p.float() if p.dtype ==
                                          torch.bfloat16 else p
                                          for p in pages), *rest)
        torch.testing.assert_close(got.float(), ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize("model", ["gpt", "bert"])
def test_tiny_models_with_head_dim_16_train_on_the_card_like_the_cpu(dev,
                                                                     model):
    """Fault F1: head dim 16 under attn_impl="auto" runs the flash kernels
    on the card (padded to 32) and gives the CPU's loss and gradients;
    the explicit kernel call at head dim 16 still refuses."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    rng = np.random.default_rng(0)
    b, sl = 3, 24
    if model == "gpt":
        cfg = GPTConfig.tiny()
        make = lambda d: GPT(cfg, device=d, seed=2)          # noqa: E731
        feeds = dict(ids=rng.integers(0, cfg.vocab_size, (b, sl)))
    else:
        cfg = BertConfig.tiny(dropout=0.0, attn_dropout=0.0)
        make = lambda d: BertForPretraining(cfg, device=d, seed=2)  # noqa
        feeds = dict(
            input_ids=rng.integers(0, cfg.vocab_size, (b, sl)),
            token_type_ids=np.zeros((b, sl), np.int64),
            attention_mask=np.arange(sl)[None, :] < np.array([sl, 7, 16])[
                :, None],
            mlm_labels=rng.integers(0, cfg.vocab_size, (b, sl)),
            mlm_mask=(rng.random((b, sl)) < 0.3).astype(np.float32),
            nsp_labels=rng.integers(0, 2, b))
    assert cfg.hidden_size // cfg.num_heads == 16
    results = []
    for d in ("cpu", dev):
        net = make(d)
        if results:
            net.load_state_dict(cpu_state)
        else:
            cpu_state = net.state_dict()
        before = FA.FWD.launches, FA.BWD_DKV.launches, FA.BWD_DQ.launches
        loss = net.loss(**{k: torch.from_numpy(np.asarray(v)).to(d)
                           for k, v in feeds.items()})[0]
        loss.backward()
        after = FA.FWD.launches, FA.BWD_DKV.launches, FA.BWD_DQ.launches
        if d == dev:
            torch.cuda.synchronize()
            assert all(a > b_ for a, b_ in zip(after, before))
        results.append((loss.detach().cpu(),
                        {n: p.grad.cpu() for n, p in net.named_parameters()
                         if p.grad is not None}))
    (l_cpu, g_cpu), (l_dev, g_dev) = results
    torch.testing.assert_close(l_dev, l_cpu, atol=1e-5, rtol=1e-5)
    assert g_dev.keys() == g_cpu.keys()
    for n in g_cpu:
        torch.testing.assert_close(g_dev[n], g_cpu[n], atol=1e-4, rtol=1e-4,
                                   msg=lambda m, n=n: f"{n}: {m}")
    q16 = torch.zeros((1, 2, 8, 16), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_fwd_cuda(q16, q16, q16)


@pytest.mark.parametrize("mode", ["int8", "speculative", "int8_speculative"])
def test_int8_and_speculative_engines_on_the_card_match_the_cpu(dev, mode):
    from paddle_tpu_torch.inference import make_serving_engine
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    cfg = GPTConfig.tiny(vocab_size=64, hidden_size=32, num_heads=2)
    dcfg = GPTConfig.tiny(vocab_size=64, hidden_size=16, num_heads=2,
                          num_layers=1)
    cpu, dcpu = GPT(cfg, device="cpu", seed=5), GPT(dcfg, device="cpu", seed=6)
    gpu, dgpu = GPT(cfg, device=dev, seed=5), GPT(dcfg, device=dev, seed=6)
    gpu.load_state_dict(cpu.state_dict())
    dgpu.load_state_dict(dcpu.state_dict())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 64, n).astype(np.int32) for n in (5, 17, 9)]
    kw = dict(num_slots=2, page_size=4, prefill_chunk=8)
    if "int8" in mode:
        kw["cache_dtype"] = torch.int8
    want = make_serving_engine(
        cpu, device="cpu", draft_model=dcpu if "spec" in mode else None,
        **kw).generate_many(prompts, 6)
    registry_entries = (PA.DECODE_INT8, PA.PREFILL_INT8) if "int8" in mode \
        else (PA.DECODE, PA.PREFILL)
    for e in registry_entries:
        e.launches = 0
    eng = make_serving_engine(
        gpu, device=dev, draft_model=dgpu if "spec" in mode else None, **kw)
    got = eng.generate_many(prompts, 6)
    assert all(e.launches > 0 for e in registry_entries)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    eng.cache.check_invariants()
    assert eng.cache.pages_in_use == 0


# -- flash attention (K5 forward, K6a dk/dv, K6b dq) -------------------------

from paddle_tpu_torch.ops import attention as FA  # noqa: E402

FLASH_CASES = [  # (B, H, Sq, Sk, causal, bias)
    (2, 2, 1, 1, False, None),
    (2, 3, 17, 17, True, None),
    (1, 2, 17, 320, True, "key"),      # Sq < Sk: bottom-right diagonal
    (2, 2, 320, 17, True, None),       # Sq > Sk: leading rows see no key
    (3, 2, 320, 320, False, "key"),    # one batch row fully masked
    (1, 2, 512, 512, True, "full"),
    (2, 1, 64, 512, False, "full"),
    # neither length a multiple of the tensor-core kernels' tiles (64
    # query rows, 128 or 64 keys, 64 or 32 query rows in dk/dv)
    (2, 2, 200, 129, True, "key"),
    (1, 3, 129, 200, False, "full"),
]


def _flash_inputs(seed, b, h, sq, sk, d, bias_mode, dev):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((b, h, sq, d)).astype(
        np.float32)).to(dev) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, h, sk, d)).astype(
        np.float32)).to(dev) for _ in range(2))
    bias = None
    if bias_mode == "key":
        lengths = rng.integers(1, sk + 1, b)
        lengths[-1] = 0 if b > 2 else lengths[-1]
        valid = torch.arange(sk)[None, :] < torch.from_numpy(lengths)[:, None]
        bias = FA.make_padding_bias(valid).to(dev)
    elif bias_mode == "full":
        bias = torch.from_numpy(rng.standard_normal((1, h, sq, sk)).astype(
            np.float32)).to(dev)
    return q, k, v, bias, do


def _close(got, want, tol, what):
    atol, rtol = tol
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol, msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "x".join(map(str, c[:4])) +
                         ("_causal" if c[4] else "") + f"_{c[5]}")
def test_flash_kernels_match_plain_versions(dev, case, dh, dtype):
    b, h, sq, sk, causal, bias_mode = case
    q, k, v, bias, do = _flash_inputs(sq + sk + dh, b, h, sq, sk, dh,
                                      bias_mode, dev)
    kw = dict(causal=causal)
    qc, kc, vc, doc = (t.to(dtype) for t in (q, k, v, do))
    q32, k32, v32, do32 = (t.float() for t in (qc, kc, vc, doc))
    out, lse = FA.FWD.cuda_fn(qc, kc, vc, bias, **kw)
    torch.cuda.synchronize()
    assert out.dtype == dtype and lse.dtype == torch.float32
    ref_out, ref_lse = FA.flash_fwd_plain(q32, k32, v32, bias, **kw)
    _close(out, ref_out, FA.FWD.tolerance[dtype], "out")
    alive = ref_lse > FA.NEG_INF / 2
    _close(lse[alive], ref_lse[alive], FA.FWD.tolerance[torch.float32], "lse")
    assert torch.all(lse[~alive] <= FA.NEG_INF / 2)
    assert torch.all(out.float()[~alive] == 0)
    delta = FA.flash_delta(do32, ref_out)
    args = (qc, kc, vc, bias, doc, ref_lse, delta)
    args32 = (q32, k32, v32, bias, do32, ref_lse, delta)
    dk, dv = FA.BWD_DKV.cuda_fn(*args, **kw)
    dq = FA.BWD_DQ.cuda_fn(*args, **kw)
    torch.cuda.synchronize()
    pdq, pdk, pdv = FA._flash_bwd_parts(*args32, **kw)
    tol = FA.BWD_DQ.tolerance[dtype]
    for got, want, name in ((dq, pdq, "dq"), (dk, pdk, "dk"), (dv, pdv, "dv")):
        assert got.dtype == dtype
        _close(got, want, tol, name)


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_bf16_flash_kernels_are_bitwise_reproducible(dev, dh):
    """K5, K6a and K6b write each output once (no atomics, no order that
    depends on scheduling): two launches give identical bits."""
    q, k, v, bias, do = _flash_inputs(dh, 2, 3, 200, 320, dh, "key", dev)
    q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
    runs = []
    for _ in range(2):
        out, lse = FA.flash_fwd_cuda(q, k, v, bias)
        delta = FA.flash_delta(do, out)
        dk, dv = FA.flash_bwd_dkv_cuda(q, k, v, bias, do, lse, delta)
        dq = FA.flash_bwd_dq_cuda(q, k, v, bias, do, lse, delta)
        torch.cuda.synchronize()
        runs.append((out, lse, dk, dv, dq))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_autograd_through_kernels_matches_plain(dev):
    q, k, v, bias, do = _flash_inputs(1, 2, 3, 96, 96, 64, "key", dev)
    results = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = (FA.FWD.launches, FA.BWD_DKV.launches, FA.BWD_DQ.launches)
        out = FA.dot_product_attention(*leaves, bias=bias,
                                       impl="plain" if plain else "auto")
        out.backward(do)
        torch.cuda.synchronize()
        after = (FA.FWD.launches, FA.BWD_DKV.launches, FA.BWD_DQ.launches)
        assert [a - b for a, b in zip(after, before)] == (
            [0, 0, 0] if plain else [1, 1, 1])
        results.append([out.detach()] + [t.grad for t in leaves])
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, atol=5e-5, rtol=5e-5)


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 2, 8, 64), device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_fwd_cuda(q.cpu(), q.cpu(), q.cpu())
    with pytest.raises(TypeError, match="not supported"):
        FA.flash_fwd_cuda(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="bfloat16|float32"):
        FA.flash_fwd_cuda(q, q.bfloat16(), q)
    q48 = torch.zeros((1, 2, 8, 48), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_fwd_cuda(q48, q48, q48)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((1, 8, 2, 64), device=dev).transpose(1, 2)
        FA.flash_fwd_cuda(t, t, t)
    lse = torch.zeros((1, 2, 8), device=dev)
    with pytest.raises(ValueError, match="lse"):
        FA.flash_bwd_dq_cuda(q, q, q, None, q, lse.double(), lse)


# -- the engine's captured CUDA graphs ---------------------------------------

def _graph_engines(dev, mode):
    from paddle_tpu_torch.inference import make_serving_engine
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    cfg = GPTConfig.tiny(vocab_size=64, hidden_size=32, num_heads=2)
    dcfg = GPTConfig.tiny(vocab_size=64, hidden_size=16, num_heads=2,
                          num_layers=1)
    model = GPT(cfg, device=dev, seed=5)
    kw = dict(num_slots=3, page_size=4, prefill_chunk=8,
              max_tokens_per_slot=36)
    if mode == "int8_speculative":
        kw.update(cache_dtype=torch.int8,
                  draft_model=GPT(dcfg, device=dev, seed=6), spec_k=3)
    return lambda **extra: make_serving_engine(model, device=dev, **kw,
                                               **extra)


@pytest.mark.parametrize("mode", ["fp32", "int8_speculative"])
def test_graphed_engine_matches_eager_dispatch(dev, mode):
    """Captured graphs give eager dispatch's tokens with the same kernel
    launches, capture nothing after warmup, and keep their tally of
    launches per signature equal to the registry's counts."""
    from paddle_tpu_torch.kernels import registry
    make = _graph_engines(dev, mode)
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 64, 9)
    prompts = [np.concatenate([shared, rng.integers(1, 64, n)]).astype(
        np.int32) for n in (5, 17, 2, 11)]
    runs = {}
    for graphed in (False, True):
        eng = make(cuda_graphs=graphed)
        eng.warmup()
        assert eng.graphs.graphed == graphed
        assert eng.graphs.builds == len(eng.warmup_plan())
        registry.reset_launches()
        tally = {s: dict(c) for s, c in eng.graphs.launches.items()}
        # twice: the second pass maps the first's published prefix pages
        outs = [eng.generate_many(prompts, 6) for _ in range(2)]
        torch.cuda.synchronize()
        counts = registry.launch_counts()
        assert eng.graphs.builds == len(eng.warmup_plan())
        assert eng.health()["recompiles"] == 0
        for name, n in counts.items():
            assert n == sum(c[name] - tally.get(s, {}).get(name, 0)
                            for s, c in eng.graphs.launches.items())
        if graphed:
            assert eng.graphs.pool_bytes() > 0
        eng.cache.check_invariants()
        runs[graphed] = outs, counts
    (eager, eager_counts), (graphs, graph_counts) = runs[False], runs[True]
    assert graph_counts == eager_counts
    paged = (PA.DECODE_INT8, PA.PREFILL_INT8) if "int8" in mode \
        else (PA.DECODE, PA.PREFILL)
    assert all(graph_counts[e.name] > 0 for e in paged)
    for a, b in zip(sum(graphs, []), sum(eager, [])):
        np.testing.assert_array_equal(a, b)


def test_a_failed_capture_raises_instead_of_dispatching_eagerly(dev):
    """A step that cannot be captured (it reads a value back to the
    host) fails its build with an error, every later build of the engine
    is refused, and serving raises: nothing falls back to eager
    dispatch."""
    make = _graph_engines(dev, "fp32")
    eng = make()
    spec = eng._bucket_spec

    def unsafe(sig):
        layout, fn = spec(sig)

        def step(**inputs):
            int(inputs["lengths"].sum())       # a sync: not capturable
            return fn(**inputs)
        return layout, step

    eng.graphs._spec = unsafe
    with pytest.raises(RuntimeError):
        eng.graphs.build(("decode", 1))
    assert ("decode", 1) not in eng.graphs.signatures()
    eng.graphs._spec = spec
    with pytest.raises(RuntimeError, match="earlier graph capture failed"):
        eng.graphs.build(("prefill", 1, 1))
    with pytest.raises(RuntimeError, match="earlier graph capture failed"):
        eng.generate_many([np.arange(1, 6, dtype=np.int32)], 2)
    assert eng.graphs.builds == 1 and not eng.graphs.signatures()


# -- page IO, migration and cached dense decoding on the card ---------------

def _served_engine(dev, cache_dtype):
    from paddle_tpu_torch.inference import make_serving_engine
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    # the kernels take pages of q's dtype: a bf16 pool serves a bf16 model
    model = GPT(GPTConfig.tiny(vocab_size=64, hidden_size=32, num_heads=2),
                device=dev, seed=5,
                dtype=cache_dtype if cache_dtype == torch.bfloat16
                else torch.float32)
    eng = make_serving_engine(model, device=dev, num_slots=3, page_size=4,
                              prefill_chunk=8, max_tokens_per_slot=36,
                              cache_dtype=cache_dtype)
    eng.warmup()
    assert eng.graphs.graphed
    return eng


@pytest.mark.parametrize("cache_dtype", [None, torch.bfloat16, torch.int8],
                         ids=["fp32", "bf16", "int8"])
def test_page_io_graphs_round_trip_and_never_alias(dev, cache_dtype):
    """read -> write -> read gives the same bytes through the captured
    page-IO graphs, and pages read back to back (one static output, one
    pinned copy each) keep their own bytes."""
    import hashlib
    eng = _served_engine(dev, cache_dtype)
    rng = np.random.default_rng(1)
    for p in [rng.integers(1, 64, n).astype(np.int32) for n in (13, 9)]:
        eng.submit(p, 12)
    eng.step()
    eng.step()
    live = [int(p) for i in eng.scheduler.active_slots()
            for p in eng.cache.slot_pages(i)]
    pair = eng._read_pages(live[:2])
    alone = [eng._read_pages([p])[0] for p in live[:2]]

    def digest(payload):
        h = hashlib.sha256()
        for a in payload:
            h.update(a.tobytes())
        return h.hexdigest()

    assert digest(pair[0]) != digest(pair[1])
    assert [digest(x) for x in pair] == [digest(x) for x in alone]
    free = eng.cache._free[-1]
    eng._write_pages([(free, pair[0])])
    (back,) = eng._read_pages([free])
    assert digest(back) == digest(pair[0])
    if cache_dtype is torch.bfloat16:
        assert back[0].dtype == np.uint16
    builds = eng.graphs.builds
    while not eng.scheduler.idle():
        eng.step()
    assert eng.graphs.builds == builds and eng.health()["recompiles"] == 0


@pytest.mark.parametrize("cache_dtype", [None, torch.int8],
                         ids=["fp32", "int8"])
def test_graphed_migration_mid_decode_keeps_the_tokens(dev, cache_dtype):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 64, n).astype(np.int32) for n in (13, 9, 5)]
    want = _served_engine(dev, cache_dtype).generate_many(prompts, 20)
    a, b = _served_engine(dev, cache_dtype), _served_engine(dev, cache_dtype)
    rids = [a.submit(p, 20) for p in prompts]
    for _ in range(2):                   # prefilled, one or two blocks in
        assert not a.step()
    assert len(a.scheduler.active_slots()) == len(prompts)
    moved = {}
    for slot in list(a.scheduler.active_slots()):
        snap = a.snapshot_slot(slot)
        rid = a.scheduler.slots[slot].request.rid
        a.release_slot(slot)
        moved[rid] = b.restore_slot(snap)
    got = {}
    while not (a.scheduler.idle() and b.scheduler.idle()):
        got.update({("a", r): t for r, t in a.step().items()})
        got.update({("b", r): t for r, t in b.step().items()})
    for i, rid in enumerate(rids):
        out = got[("b", moved[rid])] if rid in moved else got[("a", rid)]
        np.testing.assert_array_equal(out, want[i])
    for eng in (a, b):
        assert eng.graphs.builds == len(eng.warmup_plan())
        assert eng.health()["recompiles"] == 0


def test_bucketed_generate_replays_one_graph_per_bucket(dev):
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.observability import capture_count
    model = GPT(GPTConfig.tiny(vocab_size=64, hidden_size=32, num_heads=2,
                               max_position=64), device=dev, seed=3)
    rng = np.random.default_rng(3)
    for s0 in (9, 12, 16):
        prompt = rng.integers(1, 64, (2, s0)).astype(np.int32)
        before = capture_count()
        got = model.generate_bucketed(prompt, max_new_tokens=7)
        assert capture_count() - before == (1 if s0 == 9 else 0)
        want = model.generate(torch.from_numpy(prompt).to(dev),
                              max_new_tokens=7, use_cache=True)
        assert got.device == want.device
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    slow = model.generate(torch.from_numpy(prompt).to(dev), max_new_tokens=7)
    np.testing.assert_array_equal(slow.cpu().numpy(), want.cpu().numpy())


# -- the serving fleet on the card --------------------------------------------

def _fleet_model(dev, dtype=torch.float32, seed=5):
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    return GPT(GPTConfig.tiny(vocab_size=64, hidden_size=64, num_heads=4,
                              max_position=128), device=dev, seed=seed,
               dtype=dtype)


FLEET_GEOM = dict(num_slots=3, page_size=4, prefill_chunk=8,
                  max_tokens_per_slot=64, decode_block=4)


def _fleet_replica(model, dev, name, **kw):
    from paddle_tpu_torch.inference import make_serving_engine
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.serving import fleet
    return fleet.LocalReplica(make_serving_engine(
        model, device=dev, registry=MetricsRegistry(), **FLEET_GEOM, **kw),
        name=name)


def _fleet_prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, int(k)).astype(np.int32)
            for k in rng.integers(3, 24, n)]


def test_threaded_replicas_serve_while_another_replica_captures(dev):
    """Fault F4: three replicas step on their own threads while a fourth
    captures its whole warmup plan on this thread. Every request
    finishes with the tokens of a run without the concurrent capture,
    replicas stepped during the capture, and no replica built anything
    after its warmup; the fourth then serves the same tokens."""
    _threaded_capture_round(dev)


@pytest.mark.parametrize("repeat", range(20))
def test_threaded_capture_repeated_in_one_process(dev, repeat):
    """Fault F9: the round of the test above, 20 times in one process,
    each round after the last round's engines were dropped (their pinned
    buffers and graphs freed while new ones are captured). A capture
    beside serving threads must never leave a failed host allocation
    behind: every round passes, and so does a pinned allocation and a
    capture after it."""
    _threaded_capture_round(dev, seed=repeat)
    pinned = torch.zeros(64, dtype=torch.int32, pin_memory=True)
    assert pinned.is_pinned()
    graph = torch.cuda.CUDAGraph()
    x = torch.zeros(8, device=dev)
    from paddle_tpu_torch.core.device import graph_capture
    with graph_capture(graph):
        x.add_(1)
    graph.replay()
    torch.cuda.synchronize()
    assert float(x.sum()) == 8.0


def test_f9_stress_warmups_beside_serving_threads(dev):
    """Fault F9's stress shape: in rounds, three replicas serve on their
    own threads, taking a micro-snapshot after every decode block (page
    reads through pinned staging buffers), while this thread warms four
    fresh replicas in turn (a pinned input buffer and a capture per
    signature) and drops each, so pinned blocks and graphs are freed
    while others are captured. Every pinned allocation and capture must
    succeed, and every request keeps the tokens of an undisturbed run."""
    import gc
    import time
    model = _fleet_model(dev)
    prompts = _fleet_prompts(36, seed=11)
    want = _fleet_replica(model, dev, "ref").warmup().engine.generate_many(
        prompts, 32)
    for rnd in range(F9_STRESS_ROUNDS):
        reps = [_fleet_replica(model, dev, f"s{rnd}.{i}",
                               snapshot_every_blocks=1).warmup()
                for i in range(3)]
        for rep in reps:
            rep.start()
        try:
            rids = [(rep, rep.submit(p, 32))
                    for rep, p in zip(reps * len(prompts), prompts)]
            for k in range(4):
                extra = _fleet_replica(model, dev, f"w{rnd}.{k}").warmup()
                assert extra.engine.graphs.builds == len(
                    extra.engine.warmup_plan())
                del extra
                gc.collect()
            got, deadline = {}, time.monotonic() + 120
            while len(got) < len(rids) and time.monotonic() < deadline:
                for i, (rep, rid) in enumerate(rids):
                    if i not in got:
                        toks = rep.result(rid)
                        if toks is not None:
                            got[i] = toks
                assert not any(r.failed for r in reps), \
                    (rnd, [r.last_error for r in reps])
                time.sleep(0.001)
        finally:
            for rep in reps:
                rep.stop()
        assert len(got) == len(rids), rnd
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got[i], w, err_msg=f"round {rnd}")
        del reps
        gc.collect()
        pinned = torch.zeros(64, dtype=torch.int32, pin_memory=True)
        assert pinned.is_pinned()


#: rounds of the F9 stress test in one process
F9_STRESS_ROUNDS = 6


def _threaded_capture_round(dev, seed=0):
    import time
    model = _fleet_model(dev)
    reps = [_fleet_replica(model, dev, f"t{i}").warmup() for i in range(3)]
    prompts = _fleet_prompts(60, seed=seed)
    want = reps[0].engine.generate_many(prompts, 32)
    for rep in reps:
        rep.start()
    try:
        rids = [(rep, rep.submit(p, 32))
                for rep, p in zip(reps * len(prompts), prompts)]
        steps = sum(r.steps for r in reps)
        fourth = _fleet_replica(model, dev, "t3").warmup()
        steps = sum(r.steps for r in reps) - steps
        got, deadline = {}, time.monotonic() + 120
        while len(got) < len(rids) and time.monotonic() < deadline:
            for i, (rep, rid) in enumerate(rids):
                if i not in got:
                    toks = rep.result(rid)
                    if toks is not None:
                        got[i] = toks
            assert not any(r.failed for r in reps), \
                [r.last_error for r in reps]
            time.sleep(0.001)
    finally:
        for rep in reps:
            rep.stop()
    assert steps > 0, "no replica stepped during the capture"
    assert len(got) == len(rids)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[i], w)
    for rep in reps + [fourth]:
        assert rep.engine.graphs.builds == len(rep.engine.warmup_plan())
    for a, b in zip(fourth.engine.generate_many(prompts[:6], 32), want):
        np.testing.assert_array_equal(a, b)
    assert fourth.engine.graphs.builds == len(fourth.engine.warmup_plan())


def test_a_spawned_replica_server_holds_the_in_process_weights(dev):
    """A replica server spawned on the card with the same config and
    seed builds the in-process model's weights (sha256 over every
    parameter) and serves its tokens."""
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.serving.fleet import net
    from paddle_tpu_torch.serving.fleet.net.replica_server import \
        weights_digest
    config = dict(vocab_size=64, hidden_size=64, num_heads=4,
                  max_position=128, dtype="bfloat16")
    proc, addr = net.spawn_replica_server(
        config=config, engine=FLEET_GEOM, seed=11, name="card",
        warmup=False, device="cuda")
    try:
        rep = net.NetReplica(addr, name="card")
        model = GPT(GPTConfig.tiny(**{k: v for k, v in config.items()
                                      if k != "dtype"}),
                    device=dev, dtype=torch.bfloat16, seed=11)
        assert rep.remote_weights == weights_digest(model)
        local = _fleet_replica(model, dev, "local")
        prompts = _fleet_prompts(4, seed=3)
        want = local.engine.generate_many(prompts, 8)
        rids = [rep.submit(p, 8) for p in prompts]
        done = {}
        while len(done) < len(rids):
            done.update(rep.step())
        for r, w in zip(rids, want):
            np.testing.assert_array_equal(done[r], w)
        assert rep.shutdown_server()
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _near_tie(model, prompt, got, want):
    """First difference of two bf16 token streams is a near-tie of the
    dense recompute on ``want``'s context: a top-2 gap of at most one
    bf16 step at the top logit, or under 1e-2 of the logits' std."""
    import math
    j = int(np.nonzero(got != want)[0][0])
    ids = torch.from_numpy(np.concatenate([prompt, want[:j]]).astype(
        np.int64))[None].to(model.device)
    with torch.no_grad():
        logits = model(ids)[0, -1].float()
    top = logits.topk(2).values
    gap = float(top[0] - top[1])
    step = 2.0 ** (math.floor(math.log2(abs(float(top[0])))) - 7)
    return gap <= step or gap < 1e-2 * float(logits.std())


def test_a_drained_bf16_replica_keeps_its_tokens_up_to_a_near_tie(dev):
    """A 2-replica bf16 fleet drains one replica mid-decode: its slots
    restore on the other and every request finishes with the undrained
    run's tokens, or first differs at a near-tie."""
    from paddle_tpu_torch.observability import MetricsRegistry
    from paddle_tpu_torch.serving import fleet
    model = _fleet_model(dev, dtype=torch.bfloat16)
    prompts = _fleet_prompts(3, seed=9)      # the peer has room for all

    def fleet2():
        reps = [_fleet_replica(model, dev, f"r{i}").warmup()
                for i in range(2)]
        return fleet.FleetRouter(reps, registry=MetricsRegistry(),
                                 seed=1), reps

    router, _ = fleet2()
    frids = [router.submit(p, 24) for p in prompts]
    done = router.run_until_idle(max_steps=10_000)
    want = [done[f] for f in frids]
    router, reps = fleet2()
    frids = [router.submit(p, 24) for p in prompts]
    done, eng = {}, reps[1].engine
    for _ in range(1000):
        done.update(router.step())
        if any(0 < len(eng.scheduler.slots[i].generated) < 24
               for i in eng.scheduler.decode_slots()):
            break
    migrated = router.drain_replica(reps[1])
    assert migrated > 0 and router.migrations_total == migrated
    done.update(router.run_until_idle(max_steps=10_000))
    for f, p, w in zip(frids, prompts, want):
        if not np.array_equal(done[f], w):
            assert _near_tie(model, p, done[f], w)
    for rep in reps:
        assert rep.engine.graphs.builds == len(rep.engine.warmup_plan())


# -- the train step through captured CUDA graphs -----------------------------

def _tiny_train(dev, model, cuda_graphs, remat=False, rule="adamw",
                dtype=torch.float32):
    """A tiny GPT or BERT (head dim 16: padded flash), fp32 by default,
    computing in fp32, with AdamW (or Momentum, Adagrad) and its feeds on
    the card."""
    from paddle_tpu_torch.core.dtypes import get_policy
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.optimizer import Adagrad, AdamW, Momentum
    from paddle_tpu_torch.train import build_train_step, make_train_state
    rng = np.random.default_rng(3)
    b, sl = 4, 24
    if model == "gpt":
        net = GPT(GPTConfig.tiny(), device=dev, seed=4)
        feeds = dict(ids=rng.integers(0, 128, (b, sl)))
    else:
        net = BertForPretraining(BertConfig.tiny(dropout=0.0,
                                                 attn_dropout=0.0),
                                 device=dev, seed=4)
        feeds = dict(
            input_ids=rng.integers(0, 128, (b, sl)),
            token_type_ids=np.zeros((b, sl), np.int64),
            attention_mask=np.arange(sl)[None, :] < np.array(
                [sl, 7, 16, 1])[:, None],
            mlm_labels=rng.integers(0, 128, (b, sl)),
            mlm_mask=(rng.random((b, sl)) < 0.3).astype(np.float32),
            nsp_labels=rng.integers(0, 2, b))
    net.to(dtype)
    rules = {"adamw": lambda p: AdamW(p, 1e-3),
             "momentum": lambda p: Momentum(p, 1e-2),
             "adagrad": lambda p: Adagrad(p, 1e-2)}
    state = make_train_state(net, rules[rule](net.parameters()))
    step = build_train_step(lambda m, **f: m.loss(**f), state["opt"],
                            policy=get_policy("full"), remat=remat,
                            cuda_graphs=cuda_graphs)
    feeds = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in feeds.items()}
    return state, step, feeds


def _flash_counts():
    return [FA.FWD.launches, FA.BWD_DKV.launches, FA.BWD_DQ.launches]


@pytest.mark.parametrize("model", ["gpt", "bert"])
def test_graphed_train_step_equals_eager_bitwise(dev, model):
    """fp32: 5 steps through one captured graph (step 1 eager, step 2
    captures, then replays) against 5 eager steps from the same weights:
    losses and parameters bit-identical; one build, no capture after it;
    the flash kernels counted per replay as eager counts them (2 layers x
    1 launch each per step)."""
    from paddle_tpu_torch.observability import recompile
    runs = {}
    for graphs in (False, True):
        state, step, feeds = _tiny_train(dev, model, graphs)
        before = _flash_counts()
        losses = []
        for i in range(5):
            _, m = step(state, **feeds)
            losses.append(m["loss"])
            if i == 1:
                captures = recompile.capture_count()
        torch.cuda.synchronize()
        assert recompile.capture_count() == captures
        counts = [a - b for a, b in zip(_flash_counts(), before)]
        runs[graphs] = ([float(x) for x in losses], counts,
                        [p.detach().clone()
                         for p in state["model"].parameters()],
                        int(state["step"]), state["opt"].num_steps)
        if graphs:
            assert step.builds == 1
    (l0, c0, p0, s0, o0), (l1, c1, p1, s1, o1) = runs[False], runs[True]
    assert l0 == l1 and len(set(l0)) == 5
    assert c0 == c1 == [10, 10, 10]
    assert s0 == s1 == o0 == o1 == 5
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rule", ["momentum", "adagrad"])
def test_graphed_train_step_over_bf16_parameters_equals_eager(dev, rule):
    """bf16 parameters: the reference's promotion makes each parameter
    float32 at step 1 and its slot float32 at step 2, so those steps
    replace state tensors and run eagerly; step 3 leaves the state as it
    found it, step 4 captures and later steps replay. 7 steps against 7
    eager ones from the same weights: losses, parameters and slots bit
    for bit, dtypes included; one build."""
    runs = {}
    for graphs in (False, True):
        state, step, feeds = _tiny_train(dev, "gpt", graphs, rule=rule,
                                         dtype=torch.bfloat16)
        losses = [float(step(state, **feeds)[1]["loss"]) for _ in range(7)]
        opt = state["opt"]
        runs[graphs] = (losses, [t.detach().clone() for t in
                                 opt.params() + opt.state_tensors()])
        if graphs:
            assert step.builds == 1 and step._warm_calls == {
                next(iter(step._graphs)): 3}
    (l0, t0), (l1, t1) = runs[False], runs[True]
    assert l0 == l1 and len(set(l0)) == 7
    assert all(t.dtype != torch.bfloat16 for t in t1)
    for a, b in zip(t0, t1):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_a_replay_on_replaced_state_tensors_raises(dev):
    """A graph reads the tensors it was captured on: after a parameter's
    storage is replaced, the next call raises instead of replaying on
    the old one."""
    state, step, feeds = _tiny_train(dev, "gpt", True)
    for _ in range(3):
        step(state, **feeds)
    p = next(state["model"].parameters())
    p.data = p.data.clone()
    with pytest.raises(ValueError, match="captured on"):
        step(state, **feeds)


_FAILED_CAPTURE = """
import torch
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.train import build_train_step, make_train_state
dev = torch.device("cuda", 0)
net = torch.nn.Linear(4, 2).to(dev)


def loss_fn(m, x):
    loss = m(x).square().mean()
    float(loss.detach())                    # a sync: not capturable
    return loss


state = make_train_state(net, SGD(net.parameters(), 0.1))
step = build_train_step(loss_fn, state["opt"])
x = torch.ones(3, 4, device=dev)
step(state, x=x)                            # eager warm-up
try:
    step(state, x=x)
    raise SystemExit("the capture did not fail")
except RuntimeError as e:
    print("capture failed:", type(e).__name__)
try:
    step(state, x=x + 1)
    raise SystemExit("a build after a failed capture did not raise")
except RuntimeError as e:
    assert "earlier capture failed" in str(e), e
assert step.builds == 1
print("OK")
"""


def test_a_failed_train_capture_raises(dev):
    """A loss that reads a value back to the host cannot be captured:
    the second call (the capture) raises, and so does every later call;
    nothing falls back to eager dispatch. In its own process: a failed
    capture can leave PyTorch's allocator and the default CUDA generator
    in capture mode for the rest of the process."""
    _isolated(_FAILED_CAPTURE)


_DROPOUT_REPLAYS = """
import torch
from paddle_tpu_torch.nn.layers import Dropout
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.train import build_train_step, make_train_state
dev = torch.device("cuda", 0)


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(1 << 20, device=dev))
        self.drop = Dropout(0.1)


net = Net()
state = make_train_state(net, SGD(net.parameters(), 0.0))
step = build_train_step(lambda m, x: (m.drop(m.w) * x).sum(), state["opt"])
x = torch.ones(1 << 20, device=dev)
masks = []
for _ in range(4):
    step(state, x=x)
    masks.append(net.w.grad != 0)
rates = [float(m.float().mean()) for m in masks]
assert all(abs(r - 0.9) < 0.005 for r in rates), rates
assert all(not torch.equal(a, b) for a, b in zip(masks, masks[1:]))
assert step.builds == 1
print("OK", rates)
"""


def test_dropout_under_replays_draws_fresh_masks(dev):
    """Dropout 0.1 inside the captured step: each replay draws a new mask
    (the default CUDA generator advances per replay) at the keep rate. In
    its own process, so that no failed capture of another test has left
    the default generator in capture mode."""
    _isolated(_DROPOUT_REPLAYS)


def _isolated(code):
    import subprocess
    import sys
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, \
        proc.stdout + proc.stderr


def test_amp_overflow_is_skipped_inside_the_graph(dev):
    """scaled_train_step captured (bf16 policy, the flash kernels): a
    replay whose scale is set to infinity in place overflows and is
    skipped on the device: parameters, slots and both step counts
    unchanged, the scale backed off (clipped to max_scale); the next
    replay trains. (2**127 does not overflow this step's bf16 gradients
    on the card.)"""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    net = BertForPretraining(BertConfig.tiny(dropout=0.0, attn_dropout=0.0),
                             device=dev, seed=4)
    _, _, feeds = _tiny_train(dev, "bert", False)
    opt = AdamW(net.parameters(), 1e-3)
    state = amp.make_amp_state(net, opt)
    step = amp.scaled_train_step(lambda m, **f: m.loss(**f), opt)
    for _ in range(2):
        step(state, **feeds)
    state["loss_scale"]["scale"].fill_(float("inf"))
    before = [t.clone() for t in opt.params() + opt.state_tensors()]
    _, m = step(state, **feeds)
    assert not bool(m["grads_finite"]) and float(m["loss_scale"]) == 2.0 ** 24
    after = opt.params() + opt.state_tensors()
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert int(state["step"]) == opt.num_steps == 2
    _, m = step(state, **feeds)
    assert bool(m["grads_finite"]) and int(state["step"]) == 3
    assert step.builds == 1


def test_remat_under_graphs_equals_the_graphed_step(dev):
    """remat=True captured: the same losses and parameters as the
    captured step without remat, bit for bit."""
    runs = []
    for remat in (False, True):
        state, step, feeds = _tiny_train(dev, "bert", True, remat=remat)
        losses = [float(step(state, **feeds)[1]["loss"]) for _ in range(4)]
        runs.append((losses, [p.detach().clone()
                              for p in state["model"].parameters()]))
        assert step.builds == 1
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


# -- tensor parallelism on the card -------------------------------------------

TP_DIMS = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
               ffn_size=128, max_position=128)
TP_GEOM = dict(num_slots=4, page_size=8, max_tokens_per_slot=64,
               cuda_graphs=False)


@pytest.mark.parametrize("cache_dtype", [None, "int8"], ids=["fp32", "int8"])
def test_tp2_group_on_one_card_gives_the_tp1_tokens(dev, cache_dtype):
    """Two ranks on ``cuda:0`` over gloo (rank 0 leads, rank 1 follows):
    greedy tokens equal a tp=1 engine's on the card, and both ranks ran
    the paged kernels on their two heads."""
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from torch_tp_pool import TpPool
    from paddle_tpu_torch.inference import make_serving_engine
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.observability import MetricsRegistry
    build.build_all()           # the ranks load the built libraries
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 128, n).astype(np.int32)
               for n in (9, 17, 30, 5, 21)]
    kw = dict(TP_GEOM, cache_dtype=cache_dtype)
    pool = TpPool(2)
    try:
        res = pool.run("serve", timeout_s=300, params=None, dims=TP_DIMS,
                       engine_kw=kw, waves=[prompts], device="cuda:0",
                       report=("launches", "all_reduces"))
    finally:
        pool.close()
    model = GPT(GPTConfig(**TP_DIMS), device=dev, seed=0)
    eng = make_serving_engine(
        model, device=dev, registry=MetricsRegistry(),
        cache_dtype=torch.int8 if cache_dtype else None, **TP_GEOM)
    want = eng.generate_many(prompts, 16, eos_id=7)
    for a, b in zip(res[0]["tokens"][0], want):
        np.testing.assert_array_equal(a, b)
    names = (("ragged_paged_decode_int8", "ragged_paged_prefill_int8")
             if cache_dtype else
             ("ragged_paged_decode", "ragged_paged_prefill"))
    for r in res:
        assert all(r["launches"][n] > 0 for n in names), r["launches"]
        assert r["all_reduces"]["attn_out"] > 0


@pytest.mark.parametrize("name", ["ragged_paged_decode_tp",
                                  "ragged_paged_prefill_tp",
                                  "ragged_paged_decode_int8_tp",
                                  "ragged_paged_prefill_int8_tp"])
def test_tp_entries_on_a_head_slice_match_plain_and_the_full_kernel(dev,
                                                                    name):
    """Each tp entry on heads [H/2, H) of q and the pool, on the card: its
    kernel within the inner kernel's tolerance of the plain version on
    the slice, and equal to the full-head kernel's output on those
    heads."""
    from paddle_tpu_torch.kernels import registry
    entry = registry.get_composite(name)
    inner_name, = entry.inner
    inner = registry.get(inner_name)
    args, kw = inner.sample_inputs(5)
    args = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
    h = args[0].shape[-2]
    lo = h // 2
    sl = (args[0][..., lo:, :].contiguous(),
          args[1][:, :, lo:].contiguous(), args[2][:, :, lo:].contiguous())
    mesh = object()
    got = entry.fn(*sl, *args[3:], mesh=mesh, **kw)
    plain = entry.plain_fn(*sl, *args[3:], mesh=mesh, **kw)
    atol, rtol = inner.tolerance[torch.float32]
    torch.testing.assert_close(got, plain, atol=atol, rtol=rtol)
    full = inner.cuda_fn(*args, **kw)
    torch.testing.assert_close(got, full[..., lo:, :], atol=atol, rtol=rtol)


def test_staged_all_to_all_on_the_card(dev):
    """F13: two ranks on ``cuda:0`` over gloo with the staging switch:
    ``collective.all_to_all`` sends chunk ``i`` of dim 0 to rank ``i``
    and concatenates what arrives on dim 2 in rank order, the inverse
    gives each rank its own tensor back, and each call is staged once
    (gloo's list-form ``alltoall`` is refused by some torch releases)."""
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from torch_tp_pool import TpPool
    pool = TpPool(2)
    try:
        res = pool.run("all_to_all_exchange", timeout_s=120,
                       device="cuda:0")
    finally:
        pool.close()
    for r, got in enumerate(res):
        want = np.concatenate([res[j]["x"][r:r + 1] for j in range(2)],
                              axis=2)
        np.testing.assert_array_equal(got["there"], want)
        np.testing.assert_array_equal(got["back"], got["x"])
        assert got["staged"]["calls"] == {"all_to_all": 2}
        assert got["staged"]["bytes"] == {"all_to_all": 4 * got["x"].nbytes}


def test_a_graphed_tp_engine_is_refused_on_the_card(dev):
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.serving.engine import ServingEngine
    model = GPT(GPTConfig(**TP_DIMS), device=dev, seed=0)
    with pytest.raises(ValueError, match="NCCL across cards"):
        ServingEngine(model, device=dev, tp=2, num_slots=2)
    # the one-shard probe engine has no collectives: it graphs
    eng = ServingEngine(model, device=dev, tp=2, tp_probe=True,
                        num_slots=2, max_tokens_per_slot=32)
    eng.warmup()
    assert eng.graphs.graphed
    assert all(len(t) == 8 for t in eng.generate_many(
        [np.arange(1, 12, dtype=np.int32)], 8))


# -- pipelines on the card ----------------------------------------------------

PIPE_BERT = dict(vocab_size=30522, hidden_size=768, num_layers=2,
                 num_heads=12, ffn_size=3072, max_position=512, dropout=0.0,
                 attn_dropout=0.0, pipeline=True, pp_microbatches=4)


def _pipe_batch(b=8, s=128, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(s // 4, s + 1, b)
    return dict(
        input_ids=rng.integers(0, 30522, (b, s)).astype(np.int32),
        token_type_ids=np.zeros((b, s), np.int32),
        attention_mask=np.arange(s)[None, :] < lengths[:, None],
        mlm_labels=rng.integers(0, 30522, (b, s)).astype(np.int32),
        mlm_mask=(rng.random((b, s)) < 0.15).astype(np.float32),
        nsp_labels=rng.integers(0, 2, b).astype(np.int32))


def _pipe_pool_run(case, **kw):
    import sys
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from torch_tp_pool import TpPool
    from paddle_tpu_torch.kernels import build
    build.build_all(["flash_attention"])   # the ranks load the library
    pool = TpPool(2)
    try:
        return pool.run(case, timeout_s=300, device="cuda:0", **kw)
    finally:
        pool.close()


def test_pipelined_bert_pp2_on_the_card_matches_pp1(dev):
    """BERT at full width with 2 layers (one a stage), fp32, M=4: two
    ranks on ``cuda:0`` over gloo (the staging switch on) give the loss
    and every gradient of pp=1 in this process, and each rank launched
    K5 8 times (forward and recompute), K6a and K6b 4 times; pp=1 in
    turn gives the loss and gradients of the same weights' stacked
    layers without the pipeline (the plain loop over the whole batch)."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    batch = _pipe_batch()
    res = _pipe_pool_run("pipe_train", params=None, model="bert",
                         cfg=PIPE_BERT, sizes={"pp": 2}, batch=batch)
    feeds = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    model = BertForPretraining(BertConfig.tiny(**PIPE_BERT), device=dev,
                               seed=0)
    loss = model.loss(**feeds)[0]
    loss.backward()
    loop = BertForPretraining(BertConfig.tiny(
        **dict(PIPE_BERT, pipeline=False, stacked_layers=True)),
        device=dev, seed=0)
    loop_loss = loop.loss(**feeds)[0]
    loop_loss.backward()
    assert float(loss.detach()) == pytest.approx(float(loop_loss.detach()),
                                                 rel=1e-5)
    for (k, p), (k2, q) in zip(model.named_parameters(),
                               loop.named_parameters()):
        assert k == k2
        np.testing.assert_allclose(p.grad.cpu().numpy(),
                                   q.grad.cpu().numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for r in res:
        assert r["losses"][0]["loss"] == pytest.approx(
            float(loss.detach()), rel=1e-5)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(r["grads"][k], p.grad.cpu().numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        assert (r["launches"]["flash_attention_fwd"],
                r["launches"]["flash_attention_bwd_dkv"],
                r["launches"]["flash_attention_bwd_dq"]) == (8, 4, 4)


def test_pp2_snapshot_on_the_card_restores_each_stage_and_whole(dev,
                                                                 tmp_path):
    """The pp=2 state of the 2-layer model on the card, saved as each
    stage's rows, restores with ``shardings=`` naming "pp" to each rank's
    blocks and without them to the whole state, bit for bit."""
    from paddle_tpu_torch.resilience.snapshot import (SnapshotEngine,
                                                      flatten_tree)
    res = _pipe_pool_run("pipe_snapshot", params=None, cfg=PIPE_BERT,
                         batch=_pipe_batch(seed=1), directory=str(tmp_path),
                         sizes={"pp": 2})
    from torch_tp_pool import _digest
    key = "params/bert/encoder/attn/qkv_proj/weight"
    for r in res:
        assert r["specs"][key][0] == "pp" and key in r["shards"]
        assert r["differ"] == []
    assert res[0]["mine"][key] != res[1]["mine"][key]
    eng = SnapshotEngine(str(tmp_path))
    whole = flatten_tree(eng.restore(1))
    eng.close()
    for k, digest in res[0]["whole"].items():
        assert _digest(torch.as_tensor(whole[k]).cpu()) == digest, k


# -- embedding serving on the card (chip_smoke phase 10 (a), (b)) -------------

def _embed_setup(dev, model=None, capacity=4096, **kw):
    from paddle_tpu_torch import embedding_serving as es
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.parallel.host_kv import HostKVStore
    store = HostKVStore(17, optimizer="adagrad", init_scale=0.01, seed=0)
    reg = obs.MetricsRegistry()
    ch = es.StreamingUpdateChannel(store, registry=reg)
    eng = es.EmbeddingServingEngine(
        store, model, capacity=capacity, min_bucket=512, max_pending=4,
        channel=ch, max_lag_updates=0, registry=reg, device=dev, **kw)
    return store, ch, eng


def _embed_traffic(seed, n, b=128, f=26, head=512, vocab=50_000):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pick = rng.random((b, f)) < 0.8
        out.append(np.where(pick, rng.integers(0, head, (b, f)),
                            rng.integers(head, vocab, (b, f))))
    return rng, out


def test_embedding_cache_serves_the_stores_rows_with_graphs(dev):
    """Phase 10 (a) at a small vocabulary: every served row equals the
    store's bit for bit with pushes interleaved, the index holds, no
    capture after warmup, and the table keeps its storage."""
    from paddle_tpu_torch.observability import recompile
    store, ch, eng = _embed_setup(dev)
    eng.warmup((128, 26))
    assert eng.cache.graphs.graphed
    assert eng.cache.graphs.builds == len(eng.warmup_plan((128, 26)))
    ptr = eng.cache.table.data_ptr()
    before = recompile.capture_count()
    rng, batches = _embed_traffic(0, 16)
    for i, b in enumerate(batches):
        if i % 4 == 3:
            ch.push_rows(rng.integers(0, 512, 64),
                         rng.normal(0, 0.01, (64, 17)).astype(np.float32))
        rows = eng.serve(b)
        uniq = np.unique(b)
        np.testing.assert_array_equal(rows[:uniq.size], store.pull(uniq))
        eng.cache.check_invariants()
    assert recompile.capture_count() == before
    assert eng.cache.table.data_ptr() == ptr
    assert eng._reg.counter("embedding_cache_evictions_total").value() > 0
    ch.stop()


def test_embedding_deepfm_graph_matches_cpu_and_eager(dev):
    """Phase 10 (b) at a small vocabulary: the forward graph's
    probabilities within 1e-5 of the CPU forward on the same pulled rows,
    and equal to the eager forward on the card bit for bit."""
    import torch
    from paddle_tpu_torch.embedding_serving.device_cache import _pow2_bucket
    from paddle_tpu_torch.models.deepfm import DeepFMHostKV
    from paddle_tpu_torch.observability import recompile
    model = DeepFMHostKV(26, 16, (64, 64), device=dev, seed=1)
    cpu = DeepFMHostKV(26, 16, (64, 64), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    store, ch, eng = _embed_setup(dev, model)
    eng.warmup((128, 26), with_feat_vals=True)
    before = recompile.capture_count()
    _, batches = _embed_traffic(1, 6)
    for i, b in enumerate(batches):
        fv = np.random.default_rng(i).random(b.shape).astype(np.float32)
        fv = fv if i % 2 else None
        probs = eng.serve(b, fv)
        uniq, inv = np.unique(b, return_inverse=True)
        inv = inv.reshape(b.shape)
        w = _pow2_bucket(uniq.size, 512, 4096)
        rows = np.zeros((w, 17), np.float32)
        rows[:uniq.size] = store.pull(uniq)
        fv_t = None if fv is None else torch.from_numpy(fv)
        with torch.no_grad():
            want = cpu.predict_proba(torch.from_numpy(rows),
                                     torch.from_numpy(inv), fv_t).numpy()
            slots = torch.from_numpy(eng.cache.lookup_slots(
                uniq, pad_to=w)).to(dev)
            eager = model.predict_proba(
                eng.cache.table.index_select(0, slots),
                torch.from_numpy(inv).to(dev),
                None if fv_t is None else fv_t.to(dev)).cpu().numpy()
        np.testing.assert_allclose(probs, want, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(probs, eager)
    # without feat_vals was not warmed: its widths are captured at first use
    assert recompile.capture_count() > before
    ch.stop()


def test_embedding_install_keeps_the_table_and_bf16_cache(dev):
    """Installs of every width write into the one table in place (its
    ``data_ptr()`` never changes), padding lanes only touch the null
    slot, and a bf16 cache serves the store's rows rounded to bf16."""
    import torch
    from paddle_tpu_torch import embedding_serving as es
    from paddle_tpu_torch import observability as obs
    for dtype in (torch.float32, torch.bfloat16):
        c = es.DeviceEmbeddingCache(300, 5, dtype=dtype, min_gather_bucket=8,
                                    min_install_bucket=4,
                                    registry=obs.MetricsRegistry(),
                                    device=dev)
        c.warmup(256)
        ptr = c.table.data_ptr()
        rng = np.random.default_rng(2)
        for n in (1, 3, 17, 64, 200, 256):
            ids = rng.choice(10_000, n, replace=False)
            rows = rng.normal(size=(n, 5)).astype(np.float32)
            c.install(ids, rows)
            got = c.gather(ids).float().cpu().numpy()[:n]
            want = torch.from_numpy(rows).to(dtype).float().numpy()
            np.testing.assert_array_equal(got, want)
            assert c.table.data_ptr() == ptr
            assert not c.table[0].any()
            c.check_invariants()
        assert c.graphs.builds == len(c.warmup_plan(256))


# -- data and export (the Transformer slice) -----------------------------------

def _tiny_transformer(dev, dtype=torch.float32, **kw):
    from paddle_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig)
    cfg = TransformerConfig.tiny(dropout=0.0, attn_dropout=0.0, d_model=128,
                                 num_heads=2, ffn_size=256, vocab_size=96,
                                 max_len=64, **kw)
    return Transformer(cfg, device=dev, dtype=dtype, seed=4)


def _packed_epoch(n_pairs=90, rows=4, length=64, seed=3):
    from paddle_tpu_torch.data import packing
    rng = np.random.default_rng(seed)
    srcs = [rng.integers(3, 96, int(rng.integers(4, 40))).astype(np.int32)
            for _ in range(n_pairs)]
    tins = [np.concatenate([[0], s]).astype(np.int32) for s in srcs]
    touts = [np.concatenate([s, [1]]).astype(np.int32) for s in srcs]
    return list(packing.packed_batches(srcs, tins, rows_per_batch=rows,
                                       src_len=length, tgt_len=length,
                                       tgt_extras={"tgt_out": touts}))


_PACKED = ("src", "src_seg", "src_pos", "tgt", "tgt_out", "tgt_seg",
           "tgt_pos")


def test_device_loader_stages_batches_beside_a_captured_train_step(dev):
    """The packed Transformer trains from ``DeviceLoader`` through one
    captured graph: every staged batch equals its host batch, the pinned
    ring was allocated once, before the capture, and the step graph
    launches K5/K6a/K6b once per attention (6 each a step) with the
    segment biases."""
    from paddle_tpu_torch.data.native_feed import DeviceLoader
    from paddle_tpu_torch.observability import recompile
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.train import build_train_step, make_train_state
    epoch = _packed_epoch()
    model = _tiny_transformer(dev)
    state = make_train_state(model, Adam(model.parameters(), 1e-3))
    step = build_train_step(
        lambda m, **b: m.loss_packed(*(b[k] for k in _PACKED)),
        state["opt"])
    captures0 = recompile.capture_count()
    loader = DeviceLoader(iter(epoch * 2), buffer_size=2, device=dev)
    counts = []
    for i, batch in enumerate(loader):
        for k in _PACKED:
            assert np.array_equal(batch[k].cpu().numpy(),
                                  epoch[i % len(epoch)][k])
        before = _flash_counts()
        step(state, **batch)
        counts.append([a - b for a, b in zip(_flash_counts(), before)])
    torch.cuda.synchronize()
    assert step.builds == 1
    allocs = loader.stats()["pinned_allocations"]
    assert len(allocs) == 1 and allocs[0]["captures_before"] == captures0
    assert allocs[0]["thread"] == "MainThread"
    assert all(c == [6, 6, 6] for c in counts), counts


def test_flash_forward_is_the_registered_op(dev):
    """``torch.ops.ptt.flash_fwd`` launches K5 (one count) and equals the
    wrapper bit for bit, with a full segment bias broadcast over heads;
    its fake gives the same shapes and dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from paddle_tpu_torch.ops.sequence import make_segment_attention_bias
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 4, 96, 64)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(3))
    seg = torch.from_numpy(np.repeat(np.arange(4), 24)[None].repeat(2, 0)
                           ).to(dev)
    bias = make_segment_attention_bias(seg)
    before = FA.FWD.launches
    out, lse = torch.ops.ptt.flash_fwd(q, k, v, bias, False, None)
    assert FA.FWD.launches == before + 1
    want, want_lse = FA.flash_fwd_cuda(q, k, v, bias)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    with FakeTensorMode() as mode:
        fq = mode.from_tensor(q)
        fb = mode.from_tensor(bias)
        fo, fl = torch.ops.ptt.flash_fwd(fq, fq, fq, fb, True, 0.5)
    assert fo.shape == q.shape and fo.dtype == q.dtype
    assert fl.shape == q.shape[:3] and fl.dtype == torch.float32


def test_full_bias_backward_takes_the_kernels(dev):
    """A segment bias that needs no gradient runs K6a/K6b (not the
    composed recompute) and matches the plain versions; fully masked
    cross rows are 0 with a 0 dq."""
    from paddle_tpu_torch.ops.sequence import make_segment_attention_bias
    rng = np.random.default_rng(1)
    tseg = torch.from_numpy(np.array([[1] * 40 + [2] * 40 + [0] * 16,
                                      [1] * 96])).to(dev)
    sseg = torch.from_numpy(np.array([[1] * 50 + [2] * 46,
                                      [1] * 60 + [0] * 36])).to(dev)
    bias = make_segment_attention_bias(tseg, sseg)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 2, 96, 64))
                                    .astype(np.float32)).to(dev)
                   for _ in range(4))
    res = []
    for impl in ("flash", "plain"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = _flash_counts()
        out = FA.dot_product_attention(*leaves, bias=bias, impl=impl)
        grads = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(_flash_counts(), before)] == (
            [1, 1, 1] if impl == "flash" else [0, 0, 0])
        res.append((out, *grads))
    dead = (tseg == 0)[:, None, :, None].expand_as(q)
    assert torch.all(res[0][0][dead] == 0) and torch.all(res[0][1][dead] == 0)
    for got, want in zip(*res):
        torch.testing.assert_close(got, want, atol=5e-5, rtol=5e-5)


def test_predictor_on_the_card_launches_k5(dev, tmp_path):
    """A bf16 tiny Transformer exported on the card: the loaded program
    records and launches K5 (6 a call: 2 encoder, 2 decoder, 2 cross),
    and its logits equal the eager model's bit for bit; int8 weights stay
    near them."""
    from paddle_tpu_torch.inference import (load_inference_model,
                                            save_inference_model)
    model = _tiny_transformer(dev, torch.bfloat16).eval()
    rng = np.random.default_rng(2)
    src = rng.integers(3, 96, (3, 40)).astype(np.int32)
    src[0, 30:] = 2
    tgt = rng.integers(3, 96, (3, 40)).astype(np.int32)
    ex = (torch.from_numpy(src).to(dev), torch.from_numpy(tgt).to(dev))
    prog = save_inference_model(str(tmp_path / "m"), model, ex)
    assert [n.target for n in prog.graph.nodes].count(
        torch.ops.ptt.flash_fwd.default) == 6
    pred = load_inference_model(str(tmp_path / "m"))
    assert pred.meta["device"] == "cuda:0"
    before = FA.FWD.launches
    got = pred.run(src, tgt)
    torch.cuda.synchronize()
    assert FA.FWD.launches - before == 6
    with torch.no_grad():
        assert torch.equal(got, model(*ex))
    save_inference_model(str(tmp_path / "q"), model, ex,
                         weight_quantize="int8")
    q8 = load_inference_model(str(tmp_path / "q")).run(*ex)
    assert float((q8.float() - got.float()).abs().max()) < \
        0.25 * float(got.float().std())


def test_native_runner_k5_equals_the_python_op(dev, tmp_path):
    """K5 through the runner's C++ registration (ptt_ops.cc) is K5
    through the Python op bit for bit, and the C++ side counts its
    launch."""
    from paddle_tpu_torch.native.runner import flash_fwd_files
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((2, 3, 40, 64), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    bias = FA.make_padding_bias(torch.arange(40, device=dev)[None]
                                < torch.tensor([[0], [31]], device=dev))
    out, lse = FA.flash_fwd_cuda(q, k, v, bias)
    got = flash_fwd_files(q, k, v, bias, device=str(dev),
                          workdir=str(tmp_path))
    assert got["launches"] == 1
    assert torch.equal(got["out"], out.cpu())
    assert torch.equal(got["lse"], lse.cpu())


def test_native_runner_serves_a_frozen_model_on_the_card(dev, tmp_path):
    """A bf16 tiny Transformer frozen on the card and served by the C++
    runner: 6 K5 launches a call from the C++ counter, repeats bit for
    bit, logits within 4 bf16 ulps of the largest eager logit.

    On an H100 (``chip_native_rounding.py``) this program reads 1 ulp
    against eager, as close to the float32 model as eager bf16 is, while
    each of its modules compiled alone equals eager bit for bit: the
    whole program's fusions move a fifth of the logits by one ulp. The
    model with its key-padding bias dropped, a wrong attention, reads 16
    ulps; 4 lies between the two."""
    from paddle_tpu_torch.inference import save_inference_model
    from paddle_tpu_torch.native.runner import NativePredictor
    model = _tiny_transformer(dev, torch.bfloat16).eval()
    rng = np.random.default_rng(2)
    src = rng.integers(3, 96, (3, 40)).astype(np.int32)
    src[0, 30:] = 2
    tgt = rng.integers(3, 96, (3, 40)).astype(np.int32)
    ex = (torch.from_numpy(src).to(dev), torch.from_numpy(tgt).to(dev))
    save_inference_model(str(tmp_path / "m"), model, ex, freeze_native=True)
    pred = NativePredictor(str(tmp_path / "m"))
    try:
        first = pred.run(src, tgt)[0]
        before = pred.last_call["k5_launches_total"]
        again = pred.run(src, tgt)[0]
        assert pred.last_call["k5_launches_total"] - before == 6
    finally:
        pred.close()
    np.testing.assert_array_equal(first, again)
    with torch.no_grad():
        eager = model(*ex).float().cpu().numpy()
    top = float(np.abs(eager).max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert float(np.abs(first - eager).max()) <= 4 * ulp


def test_lint_traces_the_kernels_as_nodes_and_runs_nothing(dev):
    """The analysis tiers on CUDA tensors: a tiny bf16 BERT train step's
    trace holds one ``ptt.flash_fwd``, ``ptt.flash_bwd_dkv`` and
    ``ptt.flash_bwd_dq`` node a layer, the lint launches nothing and
    allocates nothing, and the step then launches the kernels it traced;
    a paged decode traces as one ``ptt.paged_decode`` node; a copy to
    the host inside a step is a host-callback."""
    import gc
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.analysis import fx_lint
    from paddle_tpu_torch.core.dtypes import get_policy
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.ops import attention as FA
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.train import build_train_step, make_train_state
    net = BertForPretraining(BertConfig.tiny(dropout=0.0, attn_dropout=0.0),
                             device=dev, seed=4)
    _, _, feeds = _tiny_train(dev, "bert", False)
    opt = AdamW(net.parameters(), 1e-3)
    state = make_train_state(net, opt)
    step = build_train_step(lambda m, **f: m.loss(**f), opt,
                            policy=get_policy("bf16"))
    gc.collect()
    torch.cuda.synchronize(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    before = registry.launch_counts()
    rep = analysis.lint_train_step(step, state, feeds, cost=True,
                                   registry=False)
    gc.collect()
    torch.cuda.synchronize(dev)
    assert torch.cuda.memory_allocated(dev) == mem0
    assert registry.count_delta(registry.launch_counts(), before) == {}
    layers = net.cfg.num_layers
    for op in ("ptt.flash_fwd", "ptt.flash_bwd_dkv", "ptt.flash_bwd_dq"):
        assert rep.cost.per_op[op].count == layers, op
    assert rep.ok() and rep.cost.flops_by_class["flash"] > 0
    assert int(state["step"]) == 0
    before = registry.launch_counts()
    step(state, **feeds)
    torch.cuda.synchronize(dev)
    assert registry.count_delta(registry.launch_counts(), before) == {
        FA.FWD.name: layers, FA.BWD_DKV.name: layers,
        FA.BWD_DQ.name: layers}

    rng = np.random.default_rng(0)
    q, kp, vp = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev) for s in ((4, 2, 16), (9, 8, 2, 16),
                                      (9, 8, 2, 16)))
    bt = torch.from_numpy(rng.integers(1, 9, (4, 3)).astype(np.int32)).to(dev)
    lens = torch.tensor([0, 5, 17, 24], dtype=torch.int32, device=dev)
    before = PA.DECODE.launches
    tr = analysis.api.trace(PA.ragged_paged_decode_attention,
                            (q, kp, vp, bt, lens))
    assert fx_lint.graph_summary(tr.gm) == {"ptt.paged_decode": 1}
    assert PA.DECODE.launches == before

    rep = analysis.lint_fn(lambda x: x.sum().cpu() + 1,
                           torch.ones(8, device=dev), registry=False,
                           ast=False)
    assert [f.rule for f in rep] == ["host-callback"]
    assert "copies a device tensor to the CPU" in rep.findings[0].message
