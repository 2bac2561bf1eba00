"""The port's native runner (``paddle_tpu_torch.native.runner``, over
``aoti_runner.cc`` and ``ptt_ops.cc``) on the CPU: the C++ schema of
``ptt::flash_fwd`` equal to the Python op's (in the source and in the
built runner's dispatcher), the C++ plain K5 (the op on CPU tensors in a
runner process) against ``flash_fwd_plain`` on fully masked rows, key and
full biases and causal masks, the runner's error strings for a package
it cannot load, ``NativePredictor``'s refusals, and (``slow``: an
AOTInductor compile takes 20-40 s here) a tiny Transformer and the
reference's MLP (``tests/test_native_inference.py``) frozen by
``save_inference_model(freeze_native=True)`` and served from a runner
process against the ``Predictor`` (rtol 1e-5) and the JAX MLP."""

import json
import os
import pathlib
import re
import shutil
import struct
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.layers import Linear as JaxLinear
from paddle_tpu.nn.module import Layer
from paddle_tpu_torch import inference as pinf
from paddle_tpu_torch.models.transformer import Transformer, TransformerConfig
from paddle_tpu_torch.native import runner as NR
from paddle_tpu_torch.ops import attention as FA

torch.set_num_threads(2)

SRC = pathlib.Path(NR.__file__).resolve().parent
TOL = dict(rtol=1e-5, atol=1e-6)


def test_cpp_schema_equals_the_python_op():
    """The schema literal of ptt_ops.cc is the custom_op's (names and
    types must match, or an AOTInductor package's proxy call would not
    find the C++ op)."""
    text = (SRC / "ptt_ops.cc").read_text()
    lit = re.search(r"kFlashFwdSchema =\s*((?:\"[^\"]*\"\s*)+);", text)
    schema = "".join(re.findall(r"\"([^\"]*)\"", lit.group(1)))
    assert "ptt::" + schema == str(torch.ops.ptt.flash_fwd.default._schema)


def test_built_runner_registers_the_same_schema():
    assert NR.runner_schema() == str(torch.ops.ptt.flash_fwd.default._schema)


def _qkv(seed, shape, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    b, h, sq, sk, d = shape
    q = torch.randn((b, h, sq, d), generator=g).to(dtype)
    k = torch.randn((b, h, sk, d), generator=g).to(dtype)
    v = torch.randn((b, h, sk, d), generator=g).to(dtype)
    return q, k, v, g


def _bias(kind, b, sq, sk, g):
    if kind == "none":
        return None
    if kind == "key":             # row 0 fully masked: every key padded
        lens = torch.randint(1, sk + 1, (b,), generator=g)
        lens[0] = 0
        return FA.make_padding_bias(torch.arange(sk)[None] < lens[:, None])
    seg_q = torch.randint(0, 3, (b, sq), generator=g).sort(-1).values
    seg_k = torch.randint(1, 3, (b, sk), generator=g).sort(-1).values
    from paddle_tpu_torch.ops.sequence import make_segment_attention_bias
    return make_segment_attention_bias(seg_q, seg_k)   # seg 0: dead rows


CASES = [  # (B, H, Sq, Sk, D), bias, causal, dtype
    ((2, 2, 9, 9, 32), "key", False, torch.float32),
    ((2, 1, 7, 12, 64), "full", False, torch.float32),
    ((1, 2, 5, 11, 64), "none", True, torch.float32),
    ((2, 2, 8, 8, 128), "key", True, torch.bfloat16),
]


@pytest.mark.parametrize("shape,bias,causal,dtype", CASES,
                         ids=["key", "full_dead_rows", "causal",
                              "bf16_key_causal"])
def test_cpp_plain_k5_equals_flash_fwd_plain(shape, bias, causal, dtype,
                                             tmp_path):
    q, k, v, g = _qkv(len(bias) + shape[-1], shape, dtype)
    bias_t = _bias(bias, shape[0], shape[2], shape[3], g)
    scale = None if causal else 0.3
    got = NR.flash_fwd_files(q, k, v, bias_t, causal=causal, scale=scale,
                             device="cpu", workdir=str(tmp_path))
    want_out, want_lse = FA.flash_fwd_plain(q, k, v, bias_t, causal=causal,
                                            scale=scale)
    assert got["launches"] == 0                      # the CPU launches nothing
    torch.testing.assert_close(got["out"], want_out, rtol=0, atol=0)
    torch.testing.assert_close(got["lse"], want_lse, rtol=0, atol=0)
    if bias == "key":                               # a fully masked row
        assert torch.equal(got["out"][0], torch.zeros_like(got["out"][0]))
        assert bool((got["lse"][0] < FA.NEG_INF / 2).all())


def _serve_frames(model_dir):
    """Start the runner on ``model_dir`` by hand; returns its first reply
    (code, text) and its exit code."""
    cmd_r, cmd_w = os.pipe()
    rep_r, rep_w = os.pipe()
    shm = os.memfd_create("outputs")
    proc = subprocess.Popen([NR.build_runner(), "serve", str(model_dir),
                             str(cmd_r), str(rep_w), str(shm)],
                            pass_fds=(cmd_r, rep_w, shm),
                            stderr=subprocess.PIPE)
    for fd in (cmd_r, rep_w, shm):
        os.close(fd)
    with os.fdopen(rep_r, "rb") as rep, os.fdopen(cmd_w, "wb") as cmd:
        code, n = struct.unpack("=iq", rep.read(12))
        text = rep.read(n).decode()
        if code == 0:
            cmd.write(struct.pack("=iq", 0, 0))
    return code, text, proc.wait(timeout=60)


def test_the_runner_reports_what_it_cannot_load(tmp_path):
    code, text, rc = _serve_frames(tmp_path / "missing")
    assert (code, rc) == (1, 1)
    assert "cannot open" in text and "meta.json" in text
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "meta.json").write_text(json.dumps({
        "input_names": ["x"], "inputs": [{"shape": [2], "dtype": "float32"}],
        "outputs": [{"shape": [2], "dtype": "float32"}],
        "weight_quantize": None, "device": "cpu"}))
    (bad / NR.FROZEN_FILE).write_bytes(b"not a package")
    with pytest.raises(RuntimeError, match="could not load"):
        NR.NativePredictor(str(bad))
    (bad / "meta.json").write_text(json.dumps({"inputs": "no"}))
    code, text, rc = _serve_frames(bad)
    assert (code, rc) == (1, 1) and "meta.json" in text


def test_native_predictor_refusals(tmp_path, monkeypatch):
    d = tmp_path / "m"
    d.mkdir()
    meta = {"input_names": ["x"],
            "inputs": [{"shape": [2], "dtype": "float32"}],
            "outputs": [{"shape": [2], "dtype": "float32"}],
            "weight_quantize": None, "device": "cpu"}
    (d / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(RuntimeError, match="freeze_native=True"):
        NR.NativePredictor(str(d))
    (d / NR.FROZEN_FILE).write_bytes(b"")
    if not torch.cuda.is_available():
        (d / "meta.json").write_text(json.dumps({**meta, "device": "cuda:0"}))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            NR.NativePredictor(str(d))
    # the C++ op runs on the card unless the caller asks for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = torch.zeros(1, 1, 8, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NR.flash_fwd_files(q, q, q)


# -- end to end: freeze, serve from a runner process -------------------------

class _JaxMLP(Layer):
    """The reference's MLP (tests/test_native_inference.py)."""

    def __init__(self):
        super().__init__()
        self.fc1 = JaxLinear(16, 32, sharding=None)
        self.fc2 = JaxLinear(32, 4, sharding=None)

    def forward(self, params, x):
        h = jnp.tanh(self.fc1(params["fc1"], x))
        return jax.nn.softmax(self.fc2(params["fc2"], h), -1), h.sum(-1)


class _MLP(torch.nn.Module):
    """The same MLP in the port, on the reference's (in, out) weights."""

    def __init__(self, params):
        super().__init__()
        self.w = torch.nn.ParameterList(
            torch.nn.Parameter(torch.from_numpy(np.asarray(params[n][k])))
            for n in ("fc1", "fc2") for k in ("weight", "bias"))

    def forward(self, x):
        h = torch.tanh(x @ self.w[0] + self.w[1])
        return torch.softmax(h @ self.w[2] + self.w[3], -1), h.sum(-1)


def _serve_and_compare(path, inputs):
    pred = NR.NativePredictor(str(path))
    try:
        got = pred.run(*inputs)
        again = pred.run(*inputs)
        assert pred.last_call["k5_launches_total"] == 0
    finally:
        pred.close()
    want = pinf.Predictor(str(path)).run(*inputs)
    want = [want] if isinstance(want, torch.Tensor) else list(want)
    assert len(got) == len(want)
    for g, a, w in zip(got, again, want):
        np.testing.assert_array_equal(g, a)
        np.testing.assert_allclose(g, w.numpy(), **TOL)
    return got


@pytest.mark.slow
def test_frozen_transformer_and_mlp_serve_like_the_predictor(tmp_path):
    cfg = TransformerConfig.tiny(dropout=0.0, attn_dropout=0.0, max_len=16,
                                 d_model=64, num_heads=1,
                                 num_encoder_layers=1, num_decoder_layers=1)
    model = Transformer(cfg, device="cpu", seed=3).eval()
    rng = np.random.default_rng(0)
    src = rng.integers(3, 64, (2, 10)).astype(np.int32)
    src[0, 7:] = 2
    tgt = rng.integers(3, 64, (2, 10)).astype(np.int32)
    ex = (torch.from_numpy(src), torch.from_numpy(tgt))
    path = tmp_path / "tf"
    pinf.save_inference_model(str(path), model, ex, input_names=["src", "tgt"],
                              freeze_native=True)
    (logits,) = _serve_and_compare(path, (src, tgt))
    with torch.no_grad():
        np.testing.assert_allclose(logits, model(*ex).numpy(), **TOL)

    jm = _JaxMLP()
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    x = rng.normal(size=(8, 16)).astype(np.float32)
    path = tmp_path / "mlp"
    pinf.save_inference_model(str(path), _MLP(params), (torch.from_numpy(x),),
                              freeze_native=True)
    meta = json.loads((path / "meta.json").read_text())
    assert meta["outputs"] == [{"shape": [8, 4], "dtype": "float32"},
                               {"shape": [8], "dtype": "float32"}]
    got = _serve_and_compare(path, (x,))
    for g, w in zip(got, jm(params, jnp.asarray(x))):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
    shutil.rmtree(tmp_path)
