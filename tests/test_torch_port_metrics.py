"""The port's fine-tune losses and metric battery against the JAX
package's: the numpy metrics (no scikit-learn) against JAX's
scikit-learn-backed ones in every task mode, on tied and untied scores, to
1e-12; each loss and its gradient; BestTracker's tie-breaks; the metric
CSV and confusion-matrix writers, including the stdlib PNG renderer a
machine without matplotlib uses."""

import csv
import os
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octcubem_tpu.train import finetune_engine as jeng
from octcubem_tpu.train import losses as jlosses
from octcubem_tpu.train import metrics as jmetrics
from octcubem_tpu_torch.train import finetune_engine as teng
from octcubem_tpu_torch.train import losses as tlosses
from octcubem_tpu_torch.train import metrics as tmetrics
from octcubem_tpu_torch.utils import visualization

pytestmark = pytest.mark.filterwarnings("ignore")


def _close(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        x, y = float(a), float(b)
        if np.isnan(x) or np.isnan(y):
            assert np.isnan(x) and np.isnan(y), (path, x, y)
        else:
            assert abs(x - y) <= 1e-12, (path, x, y)


def _cases(task_mode, seed, tied):
    rng = np.random.default_rng(seed)
    b = int(rng.integers(2, 40))

    def scores(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return np.round(x * 2) / 2 if tied else x  # ties on a 0.5 grid

    if task_mode == "multi_task_default":
        y = (rng.random((b, 5)) > 0.5).astype(np.float32)
        if seed % 3 == 0:
            y[:, 0] = 0  # tasks whose valid rows hold one class
        return y, scores((b, 8))
    if task_mode == "multi_label":
        return (rng.random((b, 3)) > 0.5).astype(np.float32), scores((b, 3))
    if task_mode.startswith("multi_cls"):
        k = int(task_mode[-1])
        return rng.integers(0, k, b).astype(np.int64), scores((b, k))
    if task_mode == "regression":
        y = rng.standard_normal(b).astype(np.float32)
        if seed % 4 == 0:
            y[:] = 1.0  # a constant target: R^2 and r undefined
        return y, scores((b, 1))
    return rng.standard_normal((b, 2)), scores((b, 2))


MODES = ["multi_task_default", "multi_label", "multi_cls2", "multi_cls3",
         "regression", "multi_output_regression"]


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("task_mode", MODES)
def test_metrics_match_sklearn_backed_jax(task_mode, tied):
    mode = "multi_cls" if task_mode.startswith("multi_cls") else task_mode
    for seed in range(25):
        y, s = _cases(task_mode, seed, tied)
        _close(jmetrics.compute_metrics(mode, y, s),
               tmetrics.compute_metrics(mode, y, s))


def test_binary_edge_cases_match():
    """One class present, all scores equal, a perfect and an inverted
    ranking, two samples."""
    cases = [(np.zeros(6), np.linspace(0, 1, 6)),
             (np.ones(6), np.linspace(0, 1, 6)),
             (np.array([0, 1, 0, 1]), np.full(4, 0.5)),
             (np.array([0, 0, 1, 1]), np.array([0.1, 0.2, 0.8, 0.9])),
             (np.array([1, 1, 0, 0]), np.array([0.1, 0.2, 0.8, 0.9])),
             (np.array([0, 1]), np.array([0.7, 0.7]))]
    for y, s in cases:
        _close(jmetrics.binary_task_metrics(y, s),
               tmetrics.binary_task_metrics(y, s))


def test_port_metrics_import_no_sklearn():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(tmetrics))
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert not any(m.startswith("sklearn") for m in names)


# ------------------------------------------------------------- losses

def _loss_pairs():
    rng = np.random.default_rng(3)
    mt_y = (rng.random((6, 5)) > 0.5).astype(np.float32)
    mt_y[0] = 0  # an all-zero row: masked out
    mt_y[1, 0], mt_y[1, 1:] = 1, 0
    yield ("multi_task", jlosses.make_criterion("multi_task_default"),
           tlosses.make_criterion("multi_task_default"),
           rng.standard_normal((6, 8)), mt_y)
    yl = (rng.random((6, 4)) > 0.5).astype(np.float32)
    for focal in (False, True):
        yield (f"multi_label focal={focal}",
               jlosses.make_criterion("multi_label", use_focal=focal),
               tlosses.make_criterion("multi_label", use_focal=focal),
               rng.standard_normal((6, 4)), yl)
    yc = rng.integers(0, 3, 6)
    for sm in (0.0, 0.1):
        yield (f"multi_cls smoothing={sm}",
               jlosses.make_criterion("multi_cls", smoothing=sm),
               tlosses.make_criterion("multi_cls", smoothing=sm),
               rng.standard_normal((6, 3)), yc)
    yield ("regression", jlosses.make_criterion("regression"),
           tlosses.make_criterion("regression"),
           rng.standard_normal((6, 1)), rng.standard_normal(6))


@pytest.mark.parametrize("case", list(_loss_pairs()), ids=lambda c: c[0])
def test_losses_and_gradients_match(case):
    _, jcrit, tcrit, logits, target = case
    logits = logits.astype(np.float32)
    jl, jg = jax.value_and_grad(lambda o: jcrit(o, jnp.asarray(target)))(
        jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    tl = tcrit(x, torch.as_tensor(target))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=5e-6, atol=5e-7)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), atol=5e-7,
                               rtol=5e-5)


def test_smoothed_ce_masks_every_row_invalid():
    z = torch.zeros((3, 2))
    assert tlosses.weighted_label_smoothing_ce(torch.randn(3, 2), z).item() == 0


# ------------------------------------------------------- best tracking

def _seq():
    cls = lambda auc, ap: {"roc": {"macro": auc}, "auprc": {"macro": ap}}  # noqa: E731
    return [cls(0.6, 0.5), cls(0.6, 0.4), cls(0.6, 0.7), cls(0.55, 0.9),
            cls(0.7, 0.1), cls(0.7, 0.1), cls(0.65, 0.9)]


@pytest.mark.parametrize("patience", [None, 1, 2])
def test_best_tracker_tie_breaks_like_jax(patience):
    """AUPRC breaks an AUROC tie; an equal pair is no improvement;
    regression ranks on (r, -MSE); early stop after ``patience``."""
    jt, tt = jeng.BestTracker(patience), teng.BestTracker(patience)
    seq = _seq() + [{"pearson_r": 0.8, "mse": 2.0},
                    {"pearson_r": 0.8, "mse": 1.0},
                    {"pearson_r": 0.8, "mse": 1.0}]
    got = []
    for epoch, m in enumerate(seq):
        a, b = jt.update(epoch, m), tt.update(epoch, m)
        assert a == b
        assert jt.should_stop == tt.should_stop
        got.append(b)
    assert got[:7] == [True, False, True, False, True, False, False]
    assert (tt.best_auc, tt.best_auprc, tt.best_epoch) == (
        jt.best_auc, jt.best_auprc, jt.best_epoch)


# ------------------------------------------------------------- writers

def _read(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("task_mode", ["multi_task_default", "multi_label",
                                       "multi_cls", "regression"])
def test_metric_csvs_and_confusion_images_like_jax(task_mode, tmp_path):
    key = "multi_cls3" if task_mode == "multi_cls" else task_mode
    y, s = _cases(key, 7, False)
    m = tmetrics.compute_metrics(task_mode, y, s)
    jeng.write_metric_csvs(jmetrics.compute_metrics(task_mode, y, s),
                           str(tmp_path / "jax"), "val")
    teng.write_metric_csvs(m, str(tmp_path / "port"), "val")
    jnames = sorted(os.listdir(tmp_path / "jax"))
    assert jnames == sorted(os.listdir(tmp_path / "port"))
    for name in jnames:
        a, b = _read(tmp_path / "jax" / name), _read(tmp_path / "port" / name)
        assert a[0] == b[0] and len(a) == len(b) == 2
        np.testing.assert_allclose(np.array(a[1], float),
                                   np.array(b[1], float), atol=1e-12)
    jp = jeng.write_confusion_matrices(y, s, task_mode, str(tmp_path / "jc"),
                                       "test")
    tp = teng.write_confusion_matrices(y, s, task_mode, str(tmp_path / "tc"),
                                       "test")
    assert [os.path.basename(p) for p in jp] == [os.path.basename(p)
                                                 for p in tp]
    assert all(os.path.getsize(p) > 0 for p in tp)


def _png_pixels(path):
    """Decode an 8-bit gray, unfiltered PNG (what write_matrix_png writes)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24],
                                                               "big")
    pos, idat = 8, b""
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        assert zlib.crc32(kind + body) == int.from_bytes(
            data[pos + 8 + n:pos + 12 + n], "big")
        if kind == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:]


def test_confusion_image_without_matplotlib(tmp_path, monkeypatch):
    """With matplotlib absent the matrix is still written: a shaded grid,
    one cell per entry, darker for larger counts; the counts returned are
    the same as with matplotlib."""
    y, p = [0, 0, 1, 1, 1, 2], [0, 1, 1, 1, 2, 2]
    with_mpl = visualization.save_confusion_matrix(
        y, p, ["a", "b", "c"], str(tmp_path / "mpl.png"))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    path = str(tmp_path / "sub" / "plain.png")
    cm = visualization.save_confusion_matrix(y, p, ["a", "b", "c"], path)
    np.testing.assert_array_equal(cm, with_mpl)
    img = _png_pixels(path)
    assert img.shape == (3 * 24 + 1, 3 * 24 + 1)
    centre = img[12::24, 12::24]
    assert centre[1, 1] < centre[0, 0] < centre[1, 0] == 255
    from PIL import Image

    assert Image.open(path).size == (73, 73)
