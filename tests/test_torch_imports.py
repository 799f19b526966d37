"""The port stands alone: importing every module of ``mmlspark_tpu_torch``,
``chip_smoke`` and ``time_window_read`` loads neither JAX nor any module
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

ROOT = Path(__file__).resolve().parents[1]


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
                 "mmlspark_tpu_torch.parallel.distributed",
                 "mmlspark_tpu_torch.parallel.mesh",
                 "mmlspark_tpu_torch.parallel.launch"):
        assert want in names


def test_imports_load_no_jax_and_no_reference_package():
    code = (
        "import importlib, json, sys\n"
        f"for name in {_port_modules()!r} + ['chip_smoke',\n"
        "                                    'time_window_read']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith(('jax.', 'jaxlib', 'flax', 'optax')) or\n"
        "             m == 'mmlspark_tpu' or m.startswith('mmlspark_tpu.'))\n"
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
    files += [ROOT / "chip_smoke.py", ROOT / "time_window_read.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert mod.split(".")[0] not in ("jax", "jaxlib", "flax",
                                                 "optax"), (f, s)
                assert mod.split(".")[0] != "mmlspark_tpu", (f, s)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.mark.parametrize("entry", ["resolve_device", "init_paged_cache",
                                   "pool", "decoder", "engine",
                                   "quant_cache", "quant_pool",
                                   "quant_decoder"])
def test_entry_points_default_to_cuda_and_raise(entry):
    _no_cuda()
    from mmlspark_tpu_torch.models.zoo.transformer import (
        TransformerConfig, init_paged_cache, init_transformer)
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    from mmlspark_tpu_torch.serving.generation import GenerationEngine
    from mmlspark_tpu_torch.serving.kv_pool import PagedKVPool
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
                 init_transformer(cfg), cfg, kv_dtype="int8")}
    with pytest.raises(RuntimeError, match="CUDA"):
        build[entry]()
    assert resolve_device("cpu").type == "cpu"


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
