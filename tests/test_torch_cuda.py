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
bitwise reproducibility, and the wrappers' refusals.
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
