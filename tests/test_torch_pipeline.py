"""The port's pipeline schedules (``paddle_tpu_torch/parallel/pipeline.py``)
against ``paddle_tpu.parallel.pipeline``.

The JAX side runs the reference's ``gpipe`` and ``circular_pipeline`` on
the conftest's eight virtual CPU devices, as its own ``TestGPipe`` does;
the port side runs in a gloo pool of CPU ranks (``torch_tp_pool``) on the
same numpy stack and inputs:

- gpipe at pp=4 and pp=2: forward, the gradients of the stack, the input
  and an extra riding the ring (a whole stack on every rank, and each
  stage's rows of a split one), and the microbatch index each block
  gets;
- the circular schedule against gpipe at pp=2 (v=4) and pp=4 (v=2), with
  gradients, from a whole stack, a split one, and a pre-interleaved
  split one; the interleave round trip;
- the refusals (extras split over "pp", a short stream under the circular
  schedule, pre-interleaved rows under gpipe, a pipelined BERT on a mesh
  split over "sp"), the bubble fraction and the microbatch round trip.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.mesh import MeshConfig, make_mesh, mesh_context
from paddle_tpu.parallel import pipeline as jpl
from paddle_tpu_torch.parallel import pipeline as pl
from torch_tp_pool import TpPool

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pools():
    ps = {2: TpPool(2), 4: TpPool(4)}
    yield ps
    for p in ps.values():
        p.close()


def _block(params, h, extra=None, mb_idx=None):
    h = jnp.tanh(h @ params["w"] + params["b"])
    return h if extra is None else h + extra


def _stack(seed, n_layers, dim):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((n_layers, dim, dim)) * 0.3)
            .astype(np.float32),
            "b": (rng.standard_normal((n_layers, dim)) * 0.1)
            .astype(np.float32)}


def _inputs(seed, shape, extra=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    e = rng.standard_normal(shape).astype(np.float32) if extra else None
    return x, g, e


@functools.lru_cache(maxsize=None)
def _jax_run(pp, circuits, seed, n_layers, dim, shape, extra):
    """The reference schedule on a pp x dp mesh of the eight devices:
    the output and the gradients of ``sum(out * g)``."""
    stack = _stack(seed, n_layers, dim)
    x, g, e = _inputs(seed + 1, shape, extra)
    mesh = make_mesh(MeshConfig(pp=pp, dp=8 // pp))

    def run(sp, x, e):
        if circuits == 1:
            return jpl.gpipe(_block, sp, x, extras=e, mesh=mesh)
        return jpl.circular_pipeline(_block, sp, x, num_circuits=circuits,
                                     extras=e, mesh=mesh)

    def loss(sp, x, e):
        return (run(sp, x, e) * g).sum()

    with mesh_context(mesh):
        out = jax.jit(run)(stack, x, e)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2) if extra
                                 else (0, 1)))(stack, x, e)
    want = {"out": np.asarray(out), "w": np.asarray(grads[0]["w"]),
            "b": np.asarray(grads[0]["b"]), "x": np.asarray(grads[1])}
    if extra:
        want["extra"] = np.asarray(grads[2])
    return stack, x, g, e, want


def _hold(got, want, what):
    np.testing.assert_allclose(got["out"], want["out"], atol=1e-5,
                               rtol=1e-5, err_msg=f"{what} out")
    for k in want:
        if k != "out":
            np.testing.assert_allclose(got[k], want[k], atol=1e-4,
                                       rtol=1e-4, err_msg=f"{what} {k}")


GPIPE = [(4, "whole", False), (4, "rows", True), (2, "whole", True),
         (2, "rows", False)]


@pytest.mark.parametrize("pp,layout,extra", GPIPE,
                         ids=[f"pp{p}-{lay}-{'extra' if e else 'plain'}"
                              for p, lay, e in GPIPE])
def test_gpipe_matches_the_reference(pools, pp, layout, extra):
    """Forward and every gradient of the port's gpipe equal the
    reference's, on every rank, M=8 microbatches through 8 layers."""
    stack, x, g, e, want = _jax_run(pp, 1, 0, 8, 8, (8, 2, 8), extra)
    got = pools[pp].run("pipe_primitive", timeout_s=60, sizes={"pp": pp},
                        w=stack["w"], b=stack["b"], x=x, g=g, extra=e,
                        layout=layout)
    for r, res in enumerate(got):
        _hold(res, want, f"rank {r}")


def test_gpipe_composes_with_a_data_axis(pools):
    """pp=2 x dp=2 (each dp rank with the whole microbatched input, as
    the schedule sees its own block): the reference's numbers on every
    rank."""
    stack, x, g, e, want = _jax_run(2, 1, 0, 8, 8, (8, 2, 8), True)
    got = pools[4].run("pipe_primitive", timeout_s=60,
                       sizes={"pp": 2, "dp": 2}, w=stack["w"],
                       b=stack["b"], x=x, g=g, extra=e, layout="rows")
    for r, res in enumerate(got):
        _hold(res, want, f"rank {r}")


def test_mb_idx_tracks_the_microbatch(pools):
    """Each block gets the true index of the microbatch it computes (the
    dropout seeds' contract): 4 layers adding it give 4 * m, and an
    extra follows its microbatch, as the reference's blocks see them."""
    M = 6
    mesh = make_mesh(MeshConfig(pp=4, dp=2))
    stack = _stack(3, 4, 4)
    x = np.zeros((M, 1, 4), np.float32)
    extra = np.repeat(100.0 * np.arange(M, dtype=np.float32), 4) \
        .reshape(M, 1, 4)
    with mesh_context(mesh):
        want = np.asarray(jax.jit(lambda sp, x, e: jpl.gpipe(
            lambda p, h, ex, m: h + ex + m.astype(h.dtype), sp, x,
            extras=e, mesh=mesh))(stack, x, extra))
    got = pools[4].run("pipe_primitive", timeout_s=60, sizes={"pp": 4},
                       w=stack["w"], b=stack["b"], x=x, g=x, extra=extra,
                       block="mb")
    expect = 4.0 * (100.0 * np.arange(M) + np.arange(M))
    np.testing.assert_array_equal(want[:, 0, 0], expect)
    for res in got:
        np.testing.assert_array_equal(res["out"], want)


CIRCULAR = [(2, 4, "whole"), (2, 4, "rows"), (2, 2, "pre"), (4, 2, "whole"),
            (4, 2, "pre")]


@pytest.mark.parametrize("pp,v,layout", CIRCULAR,
                         ids=[f"pp{p}-v{v}-{lay}" for p, v, lay in CIRCULAR])
def test_circular_matches_the_reference(pools, pp, v, layout):
    """The circular schedule's forward and gradients equal the
    reference's (and so gpipe's), M=8 through 8 layers; a split stack in
    the canonical order is gathered whole each step, a pre-interleaved
    one is not."""
    stack, x, g, e, want = _jax_run(pp, v, 10, 8, 8, (8, 2, 8), True)
    _, _, _, _, gp = _jax_run(pp, 1, 10, 8, 8, (8, 2, 8), True)
    np.testing.assert_allclose(want["out"], gp["out"], atol=1e-5)
    got = pools[pp].run("pipe_primitive", timeout_s=60, sizes={"pp": pp},
                        w=stack["w"], b=stack["b"], x=x, g=g, extra=e,
                        circuits=v, layout=layout)
    for r, res in enumerate(got):
        _hold(res, want, f"rank {r}")


def test_circular_extras_and_mb_idx(pools):
    """Extras and microbatch indices stay with their microbatch across
    every circuit (8 chunk-layers adding both)."""
    M = 8
    x = np.zeros((M, 1, 4), np.float32)
    extra = np.repeat(100.0 * np.arange(M, dtype=np.float32), 4) \
        .reshape(M, 1, 4)
    stack = _stack(16, 8, 4)
    got = pools[4].run("pipe_primitive", timeout_s=60, sizes={"pp": 4},
                       w=stack["w"], b=stack["b"], x=x, g=x, extra=extra,
                       circuits=2, block="mb")
    expect = 8.0 * (100.0 * np.arange(M) + np.arange(M))
    for res in got:
        np.testing.assert_array_equal(res["out"][:, 0, 0], expect)


def test_interleave_round_trip_equals_the_reference():
    stack = _stack(20, 8, 8)
    for n, v in ((4, 2), (2, 4), (2, 2)):
        want = jpl.interleave_stack(stack, n, v)
        got = pl.interleave_stack(stack, n, v)
        got_t = pl.interleave_stack({k: torch.from_numpy(a)
                                     for k, a in stack.items()}, n, v)
        for k in stack:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
            np.testing.assert_array_equal(got_t[k].numpy(), got[k])
            np.testing.assert_array_equal(
                pl.uninterleave_stack(got, n, v)[k], stack[k])
        # a pre-interleaved stack's contiguous block s is stage s's rows
        for s in range(n):
            rows = pl.stage_index(8, n, s, v)
            per = 8 // n
            np.testing.assert_array_equal(
                got["w"][s * per:(s + 1) * per], stack["w"][rows])


def test_refusals_match_the_reference(pools):
    got = pools[4].run("pipe_rejections", timeout_s=60)
    mesh = make_mesh(MeshConfig(pp=4, dp=2))
    stack = jpl.stack_layer_params(
        [{"w": jnp.zeros((4, 4)), "b": jnp.zeros(4)}] * 8)
    with mesh_context(mesh):
        with pytest.raises(ValueError, match="pp-replicated"):
            from jax.sharding import PartitionSpec as JP
            jpl.gpipe(_block, stack, jnp.zeros((4, 2, 4)),
                      extras=jnp.zeros((4, 2, 4)), extras_spec=JP("pp"),
                      mesh=mesh)
        with pytest.raises(ValueError, match="microbatches"):
            jpl.circular_pipeline(_block, stack, jnp.zeros((2, 1, 4)),
                                  num_circuits=2, mesh=mesh)
    for res in got:
        assert "pp-replicated" in res["extras_spec"]
        assert "microbatches >= pp stages" in res["short"]
        assert "wrong order" in res["gpipe_pre"]
        assert "does not compose with a sequence split" in res["bert_sp"]
    with pytest.raises(ValueError, match="not divisible"):
        pl.circular_pipeline(lambda *a: a[1], {"w": torch.zeros(6, 2)},
                             torch.zeros(4, 1, 2), num_circuits=4)
    with pytest.raises(ValueError, match="not divisible"):
        pl.gpipe_layer_stack(lambda lp, h, e, g: h, [{}] * 2,
                             torch.zeros(6, 2), num_microbatches=4)


def test_bubble_fraction_and_microbatch_round_trip():
    for n, M in [(2, 8), (4, 8), (4, 16)]:
        for v in (1, 2, 4):
            assert pl.pipeline_bubble_fraction(n, M, v) == \
                jpl.pipeline_bubble_fraction(n, M, v)
            assert v == 1 or pl.pipeline_bubble_fraction(n, M, v) < \
                pl.pipeline_bubble_fraction(n, M, 1)
    assert abs(pl.pipeline_bubble_fraction(4, 8, 2) - 3 / 19) < 1e-12
    batch = {"x": torch.arange(24.0).reshape(12, 2)}
    mb = pl.microbatch(batch, 4)
    assert tuple(mb["x"].shape) == (4, 3, 2)
    np.testing.assert_array_equal(
        mb["x"].numpy(),
        np.asarray(jpl.microbatch({"x": jnp.arange(24.0).reshape(12, 2)},
                                  4)["x"]))
    assert torch.equal(pl.unmicrobatch(mb)["x"], batch["x"])
    out, specs = pl.microbatch_extras(torch.zeros(8, 1, 1, 5), 4)
    assert tuple(out.shape) == (4, 2, 1, 1, 5)
    assert specs == (None, ("dp", "fsdp"), None, None, None)


def test_one_process_schedule_is_the_sequential_stack():
    """Without a mesh both schedules run in this process, forward and
    backward, and equal the plain loop over the layers (with and without
    the recompute)."""
    stack = _stack(30, 8, 6)
    x, g, e = _inputs(31, (8, 2, 6), extra=True)

    def seq(w, b, x, e):
        for i in range(8):
            x = torch.tanh(x @ w[i] + b[i]) + e
        return x

    ts = {k: torch.from_numpy(v).requires_grad_() for k, v in stack.items()}
    xt, et = (torch.from_numpy(a).requires_grad_() for a in (x, e))
    (seq(ts["w"], ts["b"], xt, et) * torch.from_numpy(g)).sum().backward()
    want = [t.grad.clone() for t in (ts["w"], ts["b"], xt, et)]
    for v in (1, 2, 4):
        for remat in (True, False):
            for t in (*ts.values(), xt, et):
                t.grad = None

            def block(lp, h, extra, m):
                return torch.tanh(h @ lp["w"] + lp["b"]) + extra

            out = (pl.gpipe(block, ts, xt, extras=et, remat=remat)
                   if v == 1 else
                   pl.circular_pipeline(block, ts, xt, extras=et,
                                        num_circuits=v, remat=remat))
            (out * torch.from_numpy(g)).sum().backward()
            for a, b in zip((ts["w"].grad, ts["b"].grad, xt.grad, et.grad),
                            want):
                torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
