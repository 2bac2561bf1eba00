"""The port's pipelined Transformer (``TransformerConfig(pipeline=True)``,
``paddle_tpu_torch.models.transformer``) against the JAX package's
(``tests/test_pipeline.py`` ``TestTransformerPipelined``).

The JAX side runs on the conftest's eight virtual CPU devices (a dp=2 x
fsdp=2 x pp=2 mesh, as the reference's test does), the port side in gloo
pools of CPU ranks (``torch_tp_pool``) and in this process at pp=1, on
the same numpy batch and the JAX weights (the layer-list tree carried
across unchanged):

- the encoder and decoder stacks through GPipe and the circular schedule
  (v=2), M=4: the loss within ``rel=1e-5`` and every gradient within
  ``atol=2e-4, rtol=1e-3`` (the reference's tolerances) of the JAX
  pipelined model's, and of its sequential stacks';
- dropout trains under the pipeline: finite losses that differ by seed,
  the same on every rank and at pp=1 (within 1e-6 relative);
- greedy decoding of a pipelined model runs the sequential stacks, equal
  to a model without the pipeline;
- the refusals: a batch the microbatches do not divide (the reference's
  reshape raises TypeError, the port a ValueError naming
  ``pp_microbatches``), the circular schedule over fewer microbatches
  than stages, layers that the stages and circuits do not divide, an
  unknown schedule (ValueError in both packages).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.mesh import MeshConfig, make_mesh, mesh_context
from paddle_tpu.models.transformer import Transformer as JaxTransformer
from paddle_tpu.models.transformer import \
    TransformerConfig as JaxTransformerConfig
from paddle_tpu_torch.models.transformer import (Transformer,
                                                 TransformerConfig)
from torch_tp_pool import TpPool

torch.set_num_threads(2)

CFG = dict(dropout=0.0, attn_dropout=0.0, max_len=16, label_smoothing=0.1,
           num_encoder_layers=4, num_decoder_layers=4)
PP_M = 4
SCHEDULES = {"gpipe": dict(pp_schedule="gpipe", pp_circuits=1),
             "circular": dict(pp_schedule="circular", pp_circuits=2)}


@pytest.fixture(scope="module")
def pools():
    ps = {2: TpPool(2), 4: TpPool(4)}
    yield ps
    for p in ps.values():
        p.close()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _batch(seed=0, b=16, s_src=12, s_tgt=10):
    rng = np.random.RandomState(seed)
    return {"src_ids": rng.randint(3, 64, (b, s_src)).astype(np.int32),
            "tgt_in": rng.randint(3, 64, (b, s_tgt)).astype(np.int32),
            "tgt_out": rng.randint(3, 64, (b, s_tgt)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _jax_ref(schedule):
    """The JAX model's weights (numpy), the batch, and its loss and
    gradients: the sequential stacks (``schedule`` None) or the stacks
    pipelined on the dp=2 x fsdp=2 x pp=2 mesh."""
    m_ref = JaxTransformer(JaxTransformerConfig.tiny(**CFG, attn_impl="xla"))
    params = m_ref.init(jax.random.PRNGKey(0))
    batch = _batch()
    jb = [jnp.asarray(batch[k]) for k in ("src_ids", "tgt_in", "tgt_out")]
    if schedule is None:
        loss, grads = jax.value_and_grad(
            lambda p: m_ref.loss(p, *jb, training=False)[0])(params)
    else:
        m_pp = JaxTransformer(JaxTransformerConfig.tiny(
            **CFG, attn_impl="xla", pipeline=True, pp_microbatches=PP_M,
            **SCHEDULES[schedule]))
        with mesh_context(make_mesh(MeshConfig(dp=2, fsdp=2, pp=2))):
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: m_pp.loss(p, *jb, training=False)[0]))(params)
    return _np_tree(params), batch, float(loss), _flat(_np_tree(grads))


def _hold(loss, grads, want_loss, want_grads, what):
    assert loss == pytest.approx(want_loss, rel=1e-5), what
    assert set(grads) == set(want_grads), what
    for k, g in want_grads.items():
        np.testing.assert_allclose(grads[k], g, atol=2e-4, rtol=1e-3,
                                   err_msg=f"{what} {k}")


def _port(schedule, params, **over):
    fields = dict(CFG, **over)
    if schedule is not None:
        fields.update(pipeline=True, pp_microbatches=PP_M,
                      **SCHEDULES[schedule])
    return Transformer.from_jax(TransformerConfig.tiny(**fields), params,
                                device="cpu")


@pytest.mark.parametrize("schedule", ["gpipe", "circular"])
def test_pp1_loss_and_grads_equal_the_references(schedule):
    """In this process (no mesh: the timetable runs with pp=1) the
    pipelined port equals the JAX pipelined model and its sequential
    stacks."""
    params, batch, loss, grads = _jax_ref(schedule)
    _, _, seq_loss, seq_grads = _jax_ref(None)
    m = _port(schedule, params).eval()
    got = m.loss(**{k: torch.from_numpy(v) for k, v in batch.items()})[0]
    got.backward()
    g = {k: p.grad.numpy() for k, p in m.named_parameters()}
    _hold(float(got), g, loss, grads, f"{schedule} pp=1 vs JAX pipelined")
    _hold(float(got), g, seq_loss, seq_grads,
          f"{schedule} pp=1 vs JAX sequential")


MESHES = {"gpipe": [({"pp": 2, "dp": 2}, "hints"), ({"pp": 2}, "hints")],
          "circular": [({"pp": 2, "dp": 2}, "hints"),
                       ({"pp": 2, "fsdp": 2}, "fsdp")]}
CASES = [(s, i) for s in ("gpipe", "circular") for i in range(2)]


@pytest.mark.parametrize("schedule,mesh_i", CASES,
                         ids=[f"{s}-{'_'.join(MESHES[s][i][0])}"
                              for s, i in CASES])
def test_pipelined_loss_and_grads_on_ranks(pools, schedule, mesh_i):
    """Every rank's loss and every gradient (gathered whole) of the
    sharded step over "pp" equal the JAX pipelined model's and its
    sequential stacks'."""
    params, batch, loss, grads = _jax_ref(schedule)
    _, _, seq_loss, seq_grads = _jax_ref(None)
    sizes, plan = MESHES[schedule][mesh_i]
    n = int(np.prod(list(sizes.values())))
    cfg = dict(CFG, pipeline=True, pp_microbatches=PP_M,
               **SCHEDULES[schedule])
    got = pools[n].run("pipe_train", timeout_s=120, params=params,
                       model="transformer", cfg=cfg, sizes=sizes,
                       batch=batch, plan_name=plan)
    for r, res in enumerate(got):
        what = f"{schedule} {sizes} rank {r}"
        _hold(res["losses"][0]["loss"], res["grads"], loss, grads, what)
        _hold(res["losses"][0]["loss"], res["grads"], seq_loss, seq_grads,
              what + " vs sequential")


def test_dropout_trains_under_the_pipeline(pools):
    """Dropout live at pp=2: finite losses that differ between seeds and
    repeat for one seed, equal on both ranks and to pp=1 here."""
    params, _, _, _ = _jax_ref(None)
    batch = _batch(seed=1, s_src=8, s_tgt=8)
    cfg = dict(CFG, dropout=0.2, pipeline=True, pp_microbatches=PP_M)
    got = pools[2].run("transformer_pipe_dropout", timeout_s=120,
                       params=params, cfg=cfg, batch=batch, seeds=[2, 3, 2])
    assert got[0] == got[1]
    (l2, g2), (l3, _), (l2b, g2b) = got[0]
    assert np.isfinite([l2, l3]).all() and l2 != l3
    assert (l2, g2) == (l2b, g2b)
    m = Transformer.from_jax(TransformerConfig.tiny(**cfg), params,
                             device="cpu").train()
    one = m.loss(**{k: torch.from_numpy(v) for k, v in batch.items()},
                 generator=torch.Generator().manual_seed(2))[0]
    assert float(one) == pytest.approx(l2, rel=1e-6)


def test_decoding_runs_the_sequential_stacks():
    """Greedy decoding of a pipelined model (no mesh, a batch the
    microbatches do not divide) equals the sequential model's, as the
    reference's decoders always run the sequential stacks."""
    params, batch, _, _ = _jax_ref(None)
    src = torch.from_numpy(batch["src_ids"][:3])
    seq = _port(None, params).eval()
    pp = _port("gpipe", params).eval()
    assert torch.equal(pp.greedy_decode(src, max_len=6),
                       seq.greedy_decode(src, max_len=6))
    ids, scores = pp.beam_search_decode(src, beam_size=2, max_len=5)
    want_ids, want_scores = seq.beam_search_decode(src, beam_size=2,
                                                   max_len=5)
    assert torch.equal(ids, want_ids)
    torch.testing.assert_close(scores, want_scores)


def _jax_refusal(fields, b):
    m = JaxTransformer(JaxTransformerConfig.tiny(
        **CFG, attn_impl="xla", pipeline=True, **fields))
    params = m.init(jax.random.PRNGKey(0))
    ids = jnp.full((b, 6), 5, jnp.int32)
    try:
        with mesh_context(make_mesh(MeshConfig(dp=4, pp=2))):
            m.loss(params, ids, ids, ids, training=False)
    except (ValueError, TypeError) as e:    # a bad batch: its reshape's
        return str(e)                       # TypeError
    return None


def test_refusals_match_the_reference(pools):
    got = pools[2].run("transformer_pipe_refusals", timeout_s=60, cfg=CFG)
    assert got[0] == got[1]
    want = {"batch": (dict(pp_microbatches=4), 6),
            "short": (dict(pp_microbatches=1, pp_schedule="circular",
                           pp_circuits=2), 4),
            "layers": (dict(pp_microbatches=2, pp_schedule="circular",
                            pp_circuits=3), 4),
            "schedule": (dict(pp_microbatches=2, pp_schedule="1f1b"), 4)}
    # (the reference's words, the port's)
    words = {"batch": ("does not evenly divide",
                       "not divisible by pp_microbatches"),
             "short": ("microbatches >= pp stages",) * 2,
             "layers": ("not divisible by pp*circuits",) * 2,
             "schedule": ("unknown pipeline schedule",) * 2}
    for key, (fields, b) in want.items():
        ref = _jax_refusal(fields, b)
        assert ref is not None and words[key][0] in ref, (key, ref)
        assert got[0][key] is not None and words[key][1] in got[0][key], \
            (key, got[0][key])
