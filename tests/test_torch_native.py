"""The port's native binning loop (``mmlspark_tpu_torch/native``): built
with g++ from the port's own ``fastpath.cpp`` into ``build/native/``, its
bins bitwise equal to the port's numpy loop and to the JAX package's
``native.bin_columns`` on float32 and float64 data with NaN, +-inf and
values equal to the bounds, on uint8 and uint16 (max_bin 1023) bins; the
binning counters say which loop ran."""

import subprocess

import numpy as np
import pytest
import torch

from mmlspark_tpu import native as jnative
from mmlspark_tpu.models.gbdt import binning as jbin
from mmlspark_tpu_torch import native
from mmlspark_tpu_torch.models.gbdt import binning as pbin

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"


def _matrix(dtype, n=3000, f=6, seed=0):
    """Normal data with NaN, +-inf and exact bound values planted; column
    3 takes few distinct values (exact midpoint bins)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f))
    X[:, 3] = rng.integers(0, 5, n)
    X[::17, 0] = np.nan
    X[5::23, 1] = np.inf
    X[7::29, 1] = -np.inf
    X[::31, 4] = 1e30
    return X.astype(dtype)


def _mapper(X, max_bin):
    m = pbin.BinMapper(max_bin=max_bin).fit(X)
    table, lengths = m.bounds_table()
    return m, table, lengths


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("max_bin", [255, 1023])
def test_native_equals_numpy_and_reference(dtype, max_bin):
    X = _matrix(dtype, seed=max_bin)
    m, table, lengths = _mapper(X, max_bin)
    # values equal to the bounds: a finite bound of every feature lands
    # on rows of its column (as float32 where X is float32)
    for j in range(X.shape[1]):
        b = m.upper_bounds[j]
        fin = b[np.isfinite(b)]
        if len(fin):
            X[40 + j::53, j] = fin[len(fin) // 2]
    want_u16 = m.n_bins > 256
    assert want_u16 == (max_bin == 1023)
    got = native.bin_columns(X, table, lengths, want_u16)
    plain = pbin.bin_columns_plain(X, table, lengths, want_u16)
    ref = jnative.bin_columns(X, table, lengths, want_u16)
    assert got.dtype == (np.uint16 if want_u16 else np.uint8)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, ref)
    assert (got[np.isnan(X[:, 0]), 0] == 0).all()     # NaN -> bin 0
    assert (got[:, 1:] > 0).all()                     # +-inf are not NaN


def test_mapper_transform_runs_the_native_loop():
    """BinMapper.transform bins dense float input through the native loop
    (float16 upcast first), bitwise the JAX package's mapper; the numpy
    loop runs only when called."""
    X = _matrix(np.float32, seed=3)
    m = pbin.BinMapper(max_bin=64).fit(X)
    jm = jbin.BinMapper(max_bin=64).fit(X)
    pbin.bin_columns.native_calls = pbin.bin_columns.plain_calls = 0
    np.testing.assert_array_equal(m.transform(X), jm.transform(X))
    with np.errstate(over="ignore"):             # 1e30 becomes inf
        X16 = X.astype(np.float16)
    np.testing.assert_array_equal(m.transform(X16), jm.transform(X16))
    assert (pbin.bin_columns.native_calls, pbin.bin_columns.plain_calls) \
        == (2, 0)
    pbin.bin_columns_plain(X, *m.bounds_table(), False)
    assert pbin.bin_columns.plain_calls == 1


def test_native_rejects_what_the_loop_does_not_take():
    X = _matrix(np.float32)
    _, table, lengths = _mapper(X, 32)
    with pytest.raises(TypeError):
        native.bin_columns(np.zeros(X.shape, np.int32), table, lengths,
                           False)
    with pytest.raises(TypeError):
        native.bin_columns(X[:, 0], table, lengths, False)
    with pytest.raises(ValueError):
        native.bin_columns(X, table[:-1], lengths, False)
    bad = lengths.copy()
    bad[2] = table.shape[1] + 1
    with pytest.raises(ValueError):
        native.bin_columns(X, table, bad, False)


def test_native_builds_the_ports_own_source(tmp_path, monkeypatch):
    """The library is compiled from ``mmlspark_tpu_torch/native/
    fastpath.cpp`` (never the JAX package's file) into the checkout's
    ``build/native/``, named by the source's hash; a failed build
    raises."""
    assert native.SOURCE.parent.name == "native"
    assert native.SOURCE.parent.parent.name == "mmlspark_tpu_torch"
    lib = native.build()
    assert lib.parent == native.BUILD_DIR and lib.exists()
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert native.available()
    seen = []

    def run(cmd, **kw):
        seen.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, "", "no compiler")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.subprocess, "run", run)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    (cmd,) = seen
    assert str(native.SOURCE) in cmd
    assert not any("mmlspark_tpu/" in str(a) for a in cmd)
