"""Step checkpoints of the port's GBDT trainer (``checkpoint_dir`` /
``checkpoint_interval``, ``utils/checkpoint.py``'s
``TrainingCheckpointer``) against the JAX package's: the same files on
disk, and a checkpoint written by either package resumed by the other
into the model the writer's own resume gives."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt.train import train as jtrain
from mmlspark_tpu.utils.checkpoint import \
    TrainingCheckpointer as JCheckpointer
from mmlspark_tpu_torch.models.gbdt.booster import Booster as PBooster
from mmlspark_tpu_torch.models.gbdt.train import train as ptrain
from mmlspark_tpu_torch.utils.checkpoint import TrainingCheckpointer

from test_torch_gbdt import BASE, _same_trees, make_data

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

CK = {**BASE, "objective": "binary", "checkpoint_interval": 3}


def _ptrain(*a, **kw):
    return ptrain(*a, device="cpu", **kw)


TRAIN = {"jax": jtrain, "port": _ptrain}


@pytest.fixture(scope="module")
def data():
    X, y, _ = make_data(n=800, seed=31)
    return X, y


def _listing(d):
    out = {}
    for name in sorted(os.listdir(d)):
        p = os.path.join(d, name)
        out[name] = sorted(os.listdir(p)) if os.path.isdir(p) else \
            open(p).read()
    return out


@pytest.fixture(scope="module")
def first_calls(data, tmp_path_factory):
    """Five iterations with checkpoints every 3, by each package."""
    X, y = data
    dirs = {}
    for pkg, fn in TRAIN.items():
        d = str(tmp_path_factory.mktemp(f"ckpt_{pkg}"))
        fn({**CK, "checkpoint_dir": d, "num_iterations": 5}, X, y)
        dirs[pkg] = d
    return dirs


def test_same_files_as_the_reference(first_calls):
    lj, lp = _listing(first_calls["jax"]), _listing(first_calls["port"])
    assert lp.keys() == lj.keys() == {"LATEST", "step_00000003",
                                      "step_00000005"}
    assert lp["LATEST"] == lj["LATEST"] == "5"
    for step in ("step_00000003", "step_00000005"):
        assert lp[step] == lj[step] == ["booster.txt", "meta.json"]
        metas = [json.load(open(os.path.join(first_calls[k], step,
                                             "meta.json")))
                 for k in ("jax", "port")]
        assert metas[0] == metas[1] == {
            "completed_iterations": int(step[5:])}
        texts = [open(os.path.join(first_calls[k], step,
                                   "booster.txt")).read()
                 for k in ("jax", "port")]
        _same_trees(PBooster.from_string(texts[0], device="cpu"),
                    PBooster.from_string(texts[1], device="cpu"))


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_resume_across_packages(writer, reader, first_calls, data,
                                tmp_path):
    """The reader resumes the writer's checkpoint at 5 and trains to 10;
    the writer's own resume of a copy of the same directory gives the
    same trees. The resumed run counts its interval from the resume, as
    the reference does: it saves at 8 and at the end, 10."""
    X, y = data
    mine = str(tmp_path / "reader")
    theirs = str(tmp_path / "writer")
    shutil.copytree(first_calls[writer], mine)
    shutil.copytree(first_calls[writer], theirs)
    p = {**CK, "num_iterations": 10}
    b_reader = TRAIN[reader]({**p, "checkpoint_dir": mine}, X, y)
    b_writer = TRAIN[writer]({**p, "checkpoint_dir": theirs}, X, y)
    _same_trees(b_writer, b_reader)
    assert b_reader.num_trees == 10 and b_reader.best_iteration == 10
    ck = TrainingCheckpointer(mine)
    assert ck.latest_step() == 10
    assert sorted(os.listdir(mine)) == ["LATEST", "step_00000008",
                                        "step_00000010"]
    assert sorted(os.listdir(theirs)) == sorted(os.listdir(mine))
    # a finished run rerun on its directory trains nothing more
    again = TRAIN[reader]({**p, "checkpoint_dir": mine}, X, y)
    assert again.num_trees == 10
    np.testing.assert_array_equal(again.feats, b_reader.feats)


def test_resumed_equals_uninterrupted(first_calls, data, tmp_path):
    X, y = data
    d = str(tmp_path / "c")
    shutil.copytree(first_calls["port"], d)
    resumed = _ptrain({**CK, "checkpoint_dir": d, "num_iterations": 10},
                      X, y)
    whole = _ptrain({**BASE, "objective": "binary", "num_iterations": 10},
                    X, y)
    _same_trees(whole, resumed)


def test_early_stopping_marks_the_run_complete(data, tmp_path):
    """With patience, the stop saves the truncated booster as the full
    budget, as the reference does."""
    X, y = data
    Xv, yv, _ = make_data(n=300, seed=32)
    outs = {}
    for pkg, fn in TRAIN.items():
        d = str(tmp_path / pkg)
        p = {**CK, "checkpoint_dir": d, "num_iterations": 60,
             "early_stopping_round": 2, "learning_rate": 0.5}
        b = fn(p, X, y, valid_sets=[(Xv, yv)])
        meta = JCheckpointer.read_json(os.path.join(
            d, f"step_{60:08d}", "meta.json"))
        outs[pkg] = (b, meta, JCheckpointer(d).latest_step())
    (bj, mj, sj), (bp, mp, sp) = outs["jax"], outs["port"]
    assert mj == mp == {"completed_iterations": 60} and sj == sp == 60
    assert bp.num_trees == bj.num_trees < 60
    _same_trees(bj, bp)


def test_init_score_refused_as_the_reference(data, tmp_path):
    X, y = data
    p = {**CK, "checkpoint_dir": str(tmp_path), "num_iterations": 2}
    for fn in TRAIN.values():
        with pytest.raises(ValueError, match="init_score cannot combine "
                                             "with step checkpoints"):
            fn(p, X, y, init_score=np.zeros(len(y)))


def test_checkpointer_payloads_and_pruning(tmp_path):
    ck = TrainingCheckpointer(str(tmp_path), keep=2)
    assert ck.latest() is None and ck.latest_step() is None
    for step in (1, 2, 3):
        ck.save(step, {"a.txt": f"s{step}", "b.bin": b"\x00\x01",
                       "m.json": {"step": step},
                       "w": np.arange(3.0) * step})
    step, files = ck.latest()
    assert step == 3 and sorted(files) == ["a.txt", "b.bin", "m.json",
                                           "w.npy"]
    assert TrainingCheckpointer.read_text(files["a.txt"]) == "s3"
    assert TrainingCheckpointer.read_json(files["m.json"]) == {"step": 3}
    np.testing.assert_array_equal(np.load(files["w.npy"]), [0.0, 3.0, 6.0])
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000002",
                                            "step_00000003"]
    # the JAX package reads the port's directory
    assert JCheckpointer(str(tmp_path)).latest_step() == 3
