"""Import guard for the port: no file under ``paddle_tpu_torch/``, and
none of ``chip_smoke.py``, ``chip_ab.py`` and ``chip_native_rounding.py``,
imports ``jax``,
``ml_dtypes`` or anything of ``paddle_tpu`` (only the tests import
both). Also pins the packaging of the port."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "paddle_tpu", "ml_dtypes"}
FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_ab.py",
    ROOT / "chip_native_rounding.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ((isinstance(node.func, ast.Attribute)
                    and node.func.attr == "import_module")
                   or (isinstance(node.func, ast.Name)
                       and node.func.id == "__import__"))):
            yield node.lineno, node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, name) for line, name in _imported_roots(tree)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_catches_each_import_form():
    src = ("import jax.numpy as jnp\nfrom paddle_tpu.serving import x\n"
           "import importlib\nimportlib.import_module('jaxlib')\n"
           "__import__('paddle_tpu')\nimport paddle_tpu_torch\n")
    roots = [n.split(".")[0] for _, n in _imported_roots(ast.parse(src))]
    assert [r for r in roots if r in FORBIDDEN] == [
        "jax", "paddle_tpu", "jaxlib", "paddle_tpu"]


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import paddle_tpu_torch.inference, paddle_tpu_torch.serving\n"
            "import paddle_tpu_torch.models, paddle_tpu_torch.kernels\n"
            "import paddle_tpu_torch.train, paddle_tpu_torch.trainer\n"
            "import paddle_tpu_torch.optimizer, paddle_tpu_torch.models.bert\n"
            "import paddle_tpu_torch.data, paddle_tpu_torch.data.native_feed\n"
            "import paddle_tpu_torch.models.transformer, paddle_tpu_torch.slim\n"
            "import paddle_tpu_torch.ops.sequence, paddle_tpu_torch.fs\n"
            "import paddle_tpu_torch.core.registry\n"
            "from paddle_tpu_torch.ops import (elementwise, math, reduction,\n"
            "    activation, tensor, beam_search, samples)\n"
            "import paddle_tpu_torch.native.runner\n"
            "from paddle_tpu_torch import (metrics, config, executor,\n"
            "    fleet, launch, profiler, debug, testing, version)\n"
            "import paddle_tpu_torch.observability.report\n"
            "from paddle_tpu_torch.kernels import registry\n"
            "assert registry.load_all()\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_is_packaged_with_its_cuda_sources():
    text = (ROOT / "pyproject.toml").read_text()
    pkgs = sorted(str(p.parent.relative_to(ROOT)).replace("/", ".")
                  for p in (ROOT / "paddle_tpu_torch").rglob("__init__.py"))
    for pkg in pkgs:
        assert f'"{pkg}"' in text, f"{pkg} missing from pyproject packages"
    assert '"paddle_tpu_torch" = ["csrc/*.cu"]' in text
    assert list((ROOT / "paddle_tpu_torch" / "csrc").glob("*.cu"))


def test_the_parallel_layer_imports_with_jax_blocked():
    """The training half of the parallel layer imports (and its kernel
    registry loads) with ``jax`` and ``paddle_tpu`` made unimportable."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes'):\n"
            "    sys.modules[m] = None\n"
            "import paddle_tpu_torch.parallel.api\n"
            "import paddle_tpu_torch.parallel.ring_attention\n"
            "import paddle_tpu_torch.parallel.functional\n"
            "import paddle_tpu_torch.optimizer.compression\n"
            "import paddle_tpu_torch.resilience.snapshot\n"
            "import paddle_tpu_torch.observability.aggregate\n"
            "import paddle_tpu_torch.native.runner\n"
            "from paddle_tpu_torch import (metrics, config, executor,\n"
            "    fleet, launch, profiler, debug, testing, version)\n"
            "import paddle_tpu_torch.observability.report\n"
            "import paddle_tpu_torch.ops.samples\n"
            "import paddle_tpu_torch.ops.beam_search\n"
            "from paddle_tpu_torch.kernels import registry\n"
            "assert registry.load_all()\n"
            "assert registry.get_composite('ring_attention')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


#: the port's native libraries and the sources each builds from
NATIVE_LIBS = {"kvstore": ["kv_store.cc"],
               "kvserver": ["kv_server.cc", "kv_store.cc"],
               "datafeed": ["data_feed.cc"]}
#: the Python modules that load them
NATIVE_CALLERS = ("parallel/host_kv.py", "parallel/kv_server.py",
                  "data/native_feed.py")


@pytest.mark.parametrize("source", sorted({s for srcs in NATIVE_LIBS.values()
                                            for s in srcs}))
def test_native_sources_are_the_references_byte_for_byte(source):
    """The port keeps its own copy of each native source, the same bytes
    as the reference's (so both packages compute the same rows, batches
    and shuffles from the same inputs)."""
    own = ROOT / "paddle_tpu_torch" / "native" / source
    ref = ROOT / "paddle_tpu" / "native" / source
    assert own.read_bytes() == ref.read_bytes()


def test_the_native_build_reads_only_the_ports_own_sources():
    """Every file the port's g++ builds read lies in
    ``paddle_tpu_torch/native/`` (no local ``#include`` leaves it), the
    libraries go under the ignored ``build/``, and the Python callers name
    only those libraries."""
    from paddle_tpu_torch import native
    own = (ROOT / "paddle_tpu_torch" / "native").resolve()
    for name, sources in NATIVE_LIBS.items():
        for src in native.source_paths(sources):
            assert src.resolve().parent == own, src
            assert src.is_file(), src
            for line in src.read_text().splitlines():
                assert not line.startswith('#include "'), (src, line)
        lib = native.library_path(name, sources)
        assert lib.resolve().is_relative_to((ROOT / "build").resolve())
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    callers = NATIVE_CALLERS
    for rel in callers:
        text = (ROOT / "paddle_tpu_torch" / rel).read_text()
        assert "native.load_library(" in text
        assert "paddle_tpu/" not in text.replace("``paddle_tpu/", "")
    for name, sources in NATIVE_LIBS.items():
        text = "".join((ROOT / "paddle_tpu_torch" / c).read_text()
                       for c in callers)
        assert f'load_library("{name}", {sources!r})'.replace(
            "'", '"') in text


def test_the_sparse_world_imports_with_jax_blocked():
    """Embedding serving, the host KV store, its pserver, DeepFM and the
    communicators import and build their native libraries with ``jax``
    and ``paddle_tpu`` made unimportable."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes'):\n"
            "    sys.modules[m] = None\n"
            "import paddle_tpu_torch.embedding_serving\n"
            "import paddle_tpu_torch.models.deepfm\n"
            "import paddle_tpu_torch.parallel.communicator\n"
            "from paddle_tpu_torch.inference import "
            "make_embedding_serving_engine\n"
            "from paddle_tpu_torch.parallel import host_kv, kv_server\n"
            "s = kv_server.KVServer(3)\n"
            "r = kv_server.RemoteKVStore('localhost', s.port)\n"
            "assert r.pull([1, 2]).shape == (2, 3)\n"
            "r.close(); s.stop()\n"
            "host_kv.HostKVStore(3).close()\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_the_data_and_export_slice_imports_with_jax_blocked():
    """The data path (the MultiSlot feed builds its library), the
    Transformer, the sequence ops, slim and the export half import and
    run a step with ``jax`` and ``paddle_tpu`` made unimportable."""
    code = ("import sys, tempfile, os\n"
            "for m in ('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes'):\n"
            "    sys.modules[m] = None\n"
            "import torch\n"
            "from paddle_tpu_torch.data import datasets, packing, reader\n"
            "from paddle_tpu_torch.data.native_feed import "
            "MultiSlotDataset, DeviceLoader\n"
            "from paddle_tpu_torch.models.transformer import "
            "Transformer, TransformerConfig\n"
            "from paddle_tpu_torch.ops import sequence\n"
            "from paddle_tpu_torch import slim, fs\n"
            "from paddle_tpu_torch.inference import Predictor, "
            "save_inference_model, fold_batch_norms\n"
            "d = tempfile.mkdtemp()\n"
            "p = os.path.join(d, 'a.txt')\n"
            "open(p, 'w').write('2 5 6 1 7\\n')\n"
            "ds = MultiSlotDataset([('a', 'int64'), ('b', 'int64')])\n"
            "ds.set_filelist([p]); assert ds.load_into_memory(1) == 1\n"
            "m = Transformer(TransformerConfig.tiny(), device='cpu')\n"
            "ids = torch.full((1, 4), 5, dtype=torch.int32)\n"
            "assert m(ids, ids).shape == (1, 4, 64)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_the_recurrent_and_structured_slice_imports_with_jax_blocked():
    """The recurrent and structured layer (RNNs, CRF and CTC, the rest of
    the op library, conv layers, nets, MoE, distributions, the book
    models) imports and runs with ``jax`` and ``paddle_tpu`` made
    unimportable."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes', "
            "'optax'):\n"
            "    sys.modules[m] = None\n"
            "import torch\n"
            "from paddle_tpu_torch.nn import rnn, nets, moe, distributions\n"
            "from paddle_tpu_torch.nn.layers import Conv2D, BatchNorm\n"
            "from paddle_tpu_torch.ops import (crf, nn, control_flow, "
            "quant, metrics_ops, niche, samples)\n"
            "from paddle_tpu_torch.models import book\n"
            "m = book.LabelSemanticRoles(20, 5, dim=4, hidden=4, "
            "device='cpu')\n"
            "w = torch.ones(2, 6, dtype=torch.long)\n"
            "n = torch.tensor([6, 3])\n"
            "loss, _ = m.loss(w, w[:, 0], w % 2, w % 5, n)\n"
            "assert torch.isfinite(loss)\n"
            "assert m.decode(w, w[:, 0], w % 2, n).shape == (2, 6)\n"
            "assert samples.run_battery('cpu')['failures'] == {}\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
