"""The port stands alone: importing every module of ``mmlspark_tpu_torch``,
``chip_smoke`` and the root timing scripts (``time_window_read``,
``time_hist``, ``time_read``) loads neither JAX nor any module
of the JAX package, and its entry points refuse to fall back to the CPU
when no card is present. Checked in a fresh interpreter with a clean environment, since
this test process has JAX loaded already (``tests/conftest.py``)."""

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mmlspark_tpu_torch

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

ROOT = Path(__file__).resolve().parents[1]
#: the scripts at the repo's root that run on the card
ROOT_SCRIPTS = ["chip_smoke", "time_window_read", "time_hist", "time_read",
                "time_front"]


def _port_modules():
    names = ["mmlspark_tpu_torch"]
    for info in pkgutil.walk_packages(mmlspark_tpu_torch.__path__,
                                      "mmlspark_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def test_every_port_module_is_listed():
    names = _port_modules()
    for want in ("mmlspark_tpu_torch.ops.paged_attention",
                 "mmlspark_tpu_torch.ops.kv_quant",
                 "mmlspark_tpu_torch.serving.generation",
                 "mmlspark_tpu_torch.utils.cuda_build",
                 "mmlspark_tpu_torch.ops.histogram",
                 "mmlspark_tpu_torch.ops.flash_attention",
                 "mmlspark_tpu_torch.models.gbdt",
                 "mmlspark_tpu_torch.models.gbdt.binning",
                 "mmlspark_tpu_torch.models.gbdt.objectives",
                 "mmlspark_tpu_torch.models.gbdt.trees",
                 "mmlspark_tpu_torch.models.gbdt.booster",
                 "mmlspark_tpu_torch.models.gbdt.train",
                 "mmlspark_tpu_torch.models.gbdt.estimators",
                 "mmlspark_tpu_torch.native",
                 "mmlspark_tpu_torch.parallel.distributed",
                 "mmlspark_tpu_torch.parallel.mesh",
                 "mmlspark_tpu_torch.parallel.launch",
                 "mmlspark_tpu_torch.observability.registry",
                 "mmlspark_tpu_torch.core.params",
                 "mmlspark_tpu_torch.core.residency",
                 "mmlspark_tpu_torch.core.dataframe",
                 "mmlspark_tpu_torch.core.pipeline",
                 "mmlspark_tpu_torch.core.schema",
                 "mmlspark_tpu_torch.core.serialize",
                 "mmlspark_tpu_torch.stages.batching",
                 "mmlspark_tpu_torch.ops.padding",
                 "mmlspark_tpu_torch.ops.compile_cache",
                 "mmlspark_tpu_torch.models.runner",
                 "mmlspark_tpu_torch.onnx.wire",
                 "mmlspark_tpu_torch.onnx.proto",
                 "mmlspark_tpu_torch.onnx.builder",
                 "mmlspark_tpu_torch.onnx.convert",
                 "mmlspark_tpu_torch.models.zoo.resnet",
                 "mmlspark_tpu_torch.models.zoo.bert_onnx",
                 "mmlspark_tpu_torch.models.zoo.vit",
                 "mmlspark_tpu_torch.models.zoo.decoder_onnx",
                 "mmlspark_tpu_torch.models.onnx_model",
                 "mmlspark_tpu_torch.reliability",
                 "mmlspark_tpu_torch.reliability.policy",
                 "mmlspark_tpu_torch.reliability.faults",
                 "mmlspark_tpu_torch.observability.events",
                 "mmlspark_tpu_torch.observability.exposition",
                 "mmlspark_tpu_torch.serving.journal",
                 "mmlspark_tpu_torch.serving.admission",
                 "mmlspark_tpu_torch.serving.server",
                 "mmlspark_tpu_torch.serving.kv_pool",
                 "mmlspark_tpu_torch.serving.continuous",
                 "mmlspark_tpu_torch.reliability.lock_sanitizer",
                 "mmlspark_tpu_torch.observability",
                 "mmlspark_tpu_torch.observability.tracing",
                 "mmlspark_tpu_torch.observability.slo",
                 "mmlspark_tpu_torch.observability.ledger",
                 "mmlspark_tpu_torch.observability.federation",
                 "mmlspark_tpu_torch.observability.timeseries",
                 "mmlspark_tpu_torch.observability.watchdog",
                 "mmlspark_tpu_torch.utils.profiling",
                 "mmlspark_tpu_torch.tuning",
                 "mmlspark_tpu_torch.tuning.observations",
                 "mmlspark_tpu_torch.serving.registry",
                 "mmlspark_tpu_torch.serving.source",
                 "mmlspark_tpu_torch.serving.engine",
                 "mmlspark_tpu_torch.image",
                 "mmlspark_tpu_torch.image.schema",
                 "mmlspark_tpu_torch.image.unroll",
                 "mmlspark_tpu_torch.image.augment",
                 "mmlspark_tpu_torch.image.transforms",
                 "mmlspark_tpu_torch.io.binary",
                 "mmlspark_tpu_torch.io.image_io",
                 "mmlspark_tpu_torch.models.featurizer",
                 "mmlspark_tpu_torch.models.linear",
                 "mmlspark_tpu_torch.models.torch_model",
                 "mmlspark_tpu_torch.explainers",
                 "mmlspark_tpu_torch.explainers.base",
                 "mmlspark_tpu_torch.explainers.regression",
                 "mmlspark_tpu_torch.explainers.superpixel",
                 "mmlspark_tpu_torch.explainers.lime",
                 "mmlspark_tpu_torch.explainers.shap",
                 "mmlspark_tpu_torch.explainers.ice",
                 "mmlspark_tpu_torch.tuning.cost_model",
                 "mmlspark_tpu_torch.vw",
                 "mmlspark_tpu_torch.vw.murmur",
                 "mmlspark_tpu_torch.vw.featurizer",
                 "mmlspark_tpu_torch.vw.learners",
                 "mmlspark_tpu_torch.vw.bandit",
                 "mmlspark_tpu_torch.nn",
                 "mmlspark_tpu_torch.nn.balltree",
                 "mmlspark_tpu_torch.nn.knn",
                 "mmlspark_tpu_torch.recommendation",
                 "mmlspark_tpu_torch.recommendation.sar",
                 "mmlspark_tpu_torch.recommendation.ranking",
                 "mmlspark_tpu_torch.cyber",
                 "mmlspark_tpu_torch.cyber.features",
                 "mmlspark_tpu_torch.cyber.complement_access",
                 "mmlspark_tpu_torch.cyber.dataset",
                 "mmlspark_tpu_torch.cyber.access_anomaly",
                 "mmlspark_tpu_torch.isolationforest",
                 "mmlspark_tpu_torch.isolationforest.iforest",
                 "mmlspark_tpu_torch.featurize",
                 "mmlspark_tpu_torch.featurize.text",
                 "mmlspark_tpu_torch.featurize.tokenizer",
                 "mmlspark_tpu_torch.featurize.value_indexer",
                 "mmlspark_tpu_torch.featurize.clean_missing",
                 "mmlspark_tpu_torch.featurize.data_conversion",
                 "mmlspark_tpu_torch.featurize.count_selector",
                 "mmlspark_tpu_torch.featurize.featurize",
                 "mmlspark_tpu_torch.train",
                 "mmlspark_tpu_torch.train.metrics",
                 "mmlspark_tpu_torch.train.train",
                 "mmlspark_tpu_torch.automl",
                 "mmlspark_tpu_torch.automl.hyperparam",
                 "mmlspark_tpu_torch.automl.tpe",
                 "mmlspark_tpu_torch.automl.tune",
                 "mmlspark_tpu_torch.stages",
                 "mmlspark_tpu_torch.stages.misc",
                 "mmlspark_tpu_torch.exploratory",
                 "mmlspark_tpu_torch.exploratory.balance",
                 "mmlspark_tpu_torch.utils.async_utils",
                 "mmlspark_tpu_torch.io.http",
                 "mmlspark_tpu_torch.io.http.clients",
                 "mmlspark_tpu_torch.io.http.parsers",
                 "mmlspark_tpu_torch.io.http.http_transformer",
                 "mmlspark_tpu_torch.io.ws",
                 "mmlspark_tpu_torch.io.powerbi",
                 "mmlspark_tpu_torch.services",
                 "mmlspark_tpu_torch.services.base",
                 "mmlspark_tpu_torch.services.anomaly",
                 "mmlspark_tpu_torch.services.text",
                 "mmlspark_tpu_torch.services.translate",
                 "mmlspark_tpu_torch.services.vision",
                 "mmlspark_tpu_torch.services.face",
                 "mmlspark_tpu_torch.services.form",
                 "mmlspark_tpu_torch.services.search",
                 "mmlspark_tpu_torch.services.geospatial",
                 "mmlspark_tpu_torch.services.mvad",
                 "mmlspark_tpu_torch.services.audio",
                 "mmlspark_tpu_torch.services.speech",
                 "mmlspark_tpu_torch.services.speech_streaming",
                 "mmlspark_tpu_torch.reliability.breaker",
                 "mmlspark_tpu_torch.reliability.loops",
                 "mmlspark_tpu_torch.utils",
                 "mmlspark_tpu_torch.utils.fault",
                 "mmlspark_tpu_torch.utils.shared",
                 "mmlspark_tpu_torch.serving",
                 "mmlspark_tpu_torch.serving.distributed",
                 "mmlspark_tpu_torch.serving.__main__",
                 "mmlspark_tpu_torch.loadgen",
                 "mmlspark_tpu_torch.loadgen.arrivals",
                 "mmlspark_tpu_torch.loadgen.progress",
                 "mmlspark_tpu_torch.loadgen.scorecard",
                 "mmlspark_tpu_torch.loadgen.scenarios",
                 "mmlspark_tpu_torch.loadgen.sessions"):
        assert want in names


def test_imports_load_no_jax_and_no_reference_package():
    """... nor ``requests``: the port's HTTP clients are the standard
    library's, and the card's machine has no ``requests``."""
    code = (
        "import importlib, json, sys\n"
        f"for name in {_port_modules()!r} + {ROOT_SCRIPTS!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith(('jax.', 'jaxlib', 'flax', 'optax')) or\n"
        "             m == 'mmlspark_tpu' or m.startswith('mmlspark_tpu.') or\n"
        "             m == 'requests' or m.startswith('requests.'))\n"
        "print(json.dumps(bad))\n")
    env = {"PATH": os.environ.get("PATH", ""), "PYTHONPATH": str(ROOT),
           "HOME": os.environ.get("HOME", "/tmp")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("name", ["mmlspark_tpu_torch.parallel.distributed",
                                  "mmlspark_tpu_torch.parallel.mesh",
                                  "mmlspark_tpu_torch.parallel.launch"])
def test_parallel_module_alone_loads_no_jax_and_joins_no_world(name):
    """Each parallel module on its own, in a clean interpreter: a rank
    spawned by ``run_ranks`` re-imports exactly such a module, so it must
    stay free of JAX; importing it forms no process group."""
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module({name!r})\n"
        "import torch.distributed as dist\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith(('jax.', 'jaxlib')) or\n"
        "             m == 'mmlspark_tpu' or m.startswith('mmlspark_tpu.'))\n"
        "print(json.dumps([bad, dist.is_initialized()]))\n")
    env = {"PATH": os.environ.get("PATH", ""), "PYTHONPATH": str(ROOT),
           "HOME": os.environ.get("HOME", "/tmp")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [[], False]


def test_sources_name_no_reference_import():
    """A static check too: no port source imports jax or the JAX
    package (``mmlspark_tpu_torch`` itself does not trip it)."""
    files = list((ROOT / "mmlspark_tpu_torch").rglob("*.py"))
    files += [ROOT / f"{name}.py" for name in ROOT_SCRIPTS]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert mod.split(".")[0] not in ("jax", "jaxlib", "flax",
                                                 "optax"), (f, s)
                assert mod.split(".")[0] != "mmlspark_tpu", (f, s)


def test_native_loop_builds_the_ports_own_source_in_a_clean_interpreter():
    """The port compiles its own ``native/fastpath.cpp`` (no Python or
    numpy headers: a plain C entry point), never the JAX package's file,
    into ``build/native/``, and building and running it loads no JAX and
    no module of the JAX package."""
    from mmlspark_tpu_torch import native
    assert native.SOURCE == ROOT / "mmlspark_tpu_torch" / "native" / \
        "fastpath.cpp"
    text = native.SOURCE.read_text()
    assert "Python.h" not in text and "mmlspark_bin_columns" in text
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from mmlspark_tpu_torch import native\n"
        "lib = native.build()\n"
        "b = native.bin_columns(np.zeros((3, 2)), np.full((2, 1), np.inf),"
        " np.ones(2, np.int64), False)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith(('jax.', 'jaxlib')) or\n"
        "             m == 'mmlspark_tpu' or m.startswith('mmlspark_tpu.'))\n"
        "print(json.dumps([bad, str(lib), str(native.SOURCE),"
        " b.tolist()]))\n")
    env = {"PATH": os.environ.get("PATH", ""), "PYTHONPATH": str(ROOT),
           "HOME": os.environ.get("HOME", "/tmp")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    bad, lib, src, bins = json.loads(proc.stdout.strip().splitlines()[-1])
    assert bad == [] and bins == [[1, 1]] * 3
    assert Path(lib).parent == ROOT / "build" / "native"
    assert src == str(native.SOURCE)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.mark.parametrize("entry", ["resolve_device", "init_paged_cache",
                                   "pool", "decoder", "engine",
                                   "quant_cache", "quant_pool",
                                   "quant_decoder", "vw_learner",
                                   "knn_model", "sar", "access_anomaly",
                                   "train_classifier", "train_regressor",
                                   "simple_detect_anomalies"])
def test_entry_points_default_to_cuda_and_raise(entry):
    _no_cuda()
    from mmlspark_tpu_torch.cyber import AccessAnomaly
    from mmlspark_tpu_torch.nn import KNNModel
    from mmlspark_tpu_torch.recommendation import SAR
    from mmlspark_tpu_torch.vw import VowpalWabbitClassifier
    from mmlspark_tpu_torch.models.zoo.transformer import (
        TransformerConfig, init_paged_cache, init_transformer)
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    from mmlspark_tpu_torch.serving.generation import GenerationEngine
    from mmlspark_tpu_torch.serving.kv_pool import PagedKVPool
    from mmlspark_tpu_torch.services import SimpleDetectAnomalies
    from mmlspark_tpu_torch.train import TrainClassifier, TrainRegressor
    from mmlspark_tpu_torch.utils.device import resolve_device
    cfg = TransformerConfig(vocab=16, layers=1, d_model=8, heads=2, d_ff=16,
                            max_len=16, causal=True, norm="rmsnorm",
                            position="rope", dtype=torch.float32)
    build = {"resolve_device": lambda: resolve_device(),
             "init_paged_cache": lambda: init_paged_cache(cfg, 4, 4),
             "pool": lambda: PagedKVPool(cfg, num_pages=4, page_size=4),
             "decoder": lambda: ContinuousDecoder(init_transformer(cfg), cfg),
             "engine": lambda: GenerationEngine(init_transformer(cfg), cfg),
             "quant_cache": lambda: init_paged_cache(cfg, 4, 4,
                                                     kv_dtype="int8"),
             "quant_pool": lambda: PagedKVPool(cfg, num_pages=4, page_size=4,
                                               kv_dtype="fp8"),
             "quant_decoder": lambda: ContinuousDecoder(
                 init_transformer(cfg), cfg, kv_dtype="int8"),
             "vw_learner": VowpalWabbitClassifier, "knn_model": KNNModel,
             "sar": SAR, "access_anomaly": AccessAnomaly,
             "train_classifier": TrainClassifier,
             "train_regressor": TrainRegressor,
             "simple_detect_anomalies": lambda: SimpleDetectAnomalies(
                 device=None)}
    with pytest.raises(RuntimeError, match="CUDA"):
        build[entry]()
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("entry", ["featurizer", "logistic", "linear",
                                   "torch_model", "image_lime", "image_shap",
                                   "lasso", "transform_resident"])
def test_image_linear_explainer_entry_points_default_to_cuda(entry):
    _no_cuda()
    from mmlspark_tpu_torch.core import DataFrame
    from mmlspark_tpu_torch.explainers import (ImageLIME, ImageSHAP,
                                               batched_lasso)
    from mmlspark_tpu_torch.image import ImageTransformer
    from mmlspark_tpu_torch.models.featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.linear import (LinearRegression,
                                                  LogisticRegression)
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    build = {"featurizer": lambda: ImageFeaturizer(b"onnx"),
             "logistic": LogisticRegression, "linear": LinearRegression,
             "torch_model": lambda: TorchModel(lambda p, f: f),
             "image_lime": ImageLIME, "image_shap": ImageSHAP,
             "lasso": lambda: batched_lasso(np.zeros((1, 2, 1)),
                                            np.zeros((1, 2)),
                                            np.ones((1, 2))),
             "transform_resident": lambda: ImageTransformer(
                 ).transform_resident(DataFrame(
                     {"image": np.zeros((2, 4, 4, 3), np.uint8)}))}
    with pytest.raises(RuntimeError, match="CUDA"):
        build[entry]()


def test_device_info_raises_without_cuda():
    _no_cuda()
    from mmlspark_tpu_torch.utils.device import device_info
    with pytest.raises(RuntimeError):
        device_info()


def test_cuda_build_is_lazy_and_names_its_sources():
    from mmlspark_tpu_torch.utils import cuda_build
    assert (cuda_build.CSRC / "paged_attention.cu").exists()
    assert (cuda_build.CSRC / "histogram.cu").exists()
    assert (cuda_build.CSRC / "flash_attention.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    assert cuda_build._libs == {}         # nothing built at import


def test_cuda_build_names_a_library_by_its_shared_headers(tmp_path,
                                                          monkeypatch):
    """An edit to a shared ``.cuh`` header renames every source's library,
    so no source loads one built against the old header."""
    from mmlspark_tpu_torch.utils import cuda_build
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    before = cuda_build._target("k")
    assert cuda_build._target("k") == before
    (tmp_path / "h.cuh").write_text("// two\n")
    assert cuda_build._target("k") != before
    assert sorted(p.name for p in cuda_build.CSRC.glob("*.cu")) == ["k.cu"]


def test_padding_matches_reference():
    from mmlspark_tpu.ops import padding as ref
    from mmlspark_tpu_torch.ops import padding as port
    for n in (0, 1, 2, 3, 8, 9, 255, 256, 257, 1000):
        assert port.bucket_size(n) == ref.bucket_size(n)
        assert port.bucket_size(n, [4, 16, 64, 2048]) == \
            ref.bucket_size(n, [4, 16, 64, 2048])
    assert port.default_buckets(100) == ref.default_buckets(100)
    with pytest.raises(ValueError):
        port.bucket_size(5000, [4, 16])
    assert np.all(np.diff(port.default_buckets()) > 0)


def test_kv_quant_matches_reference_constants():
    """``ops/kv_quant.py`` is the port's own copy: its constants and
    byte accounting equal the reference module's."""
    import jax.numpy as jnp
    from mmlspark_tpu.ops import kv_quant as ref
    from mmlspark_tpu_torch.ops import kv_quant as port
    assert port._CANON == ref._CANON
    assert (port._QMAX_INT8, port._QMAX_FP8) == (ref._QMAX_INT8,
                                                 ref._QMAX_FP8)
    assert port.SCALE_DTYPE == torch.bfloat16 and \
        ref.SCALE_DTYPE == jnp.bfloat16
    assert port.supports_fp8() and ref.supports_fp8()
    assert port.__all__ == ref.__all__
