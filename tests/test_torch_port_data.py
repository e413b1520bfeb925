"""The port's host data layer against the JAX package's, on the CPU.

Both sides are plain numpy (and PIL / libpng for decoding), so every
comparison is bit-equal: the threaded loader's batches and their order,
the patient datasets on PNG, .npy and DICOM trees, the train transforms
and RandAugment draw for draw, the SPL state and its pickles across
packages both ways, the 2D pretraining dataset, and the native PNG
decoder against JAX's and against PIL."""

import os
import pickle

import numpy as np
import pytest
from PIL import Image

from octcubem_tpu import native as jnative
from octcubem_tpu.data import (ingest as jingest, loader as jloader,
                               patients as jpatients, randaug as jrandaug,
                               spl as jspl, transforms as jtransforms)
from octcubem_tpu_torch import native as tnative
from octcubem_tpu_torch.data import (ingest as tingest, loader as tloader,
                                     patients as tpatients,
                                     randaug as trandaug, spl as tspl,
                                     transforms as ttransforms)
from octcubem_tpu_torch.data.dicom import write_dicom


def _equal(a, b):
    """Nested batches (tuples, lists, dicts, arrays, strings) bit-equal."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


class _Items:
    """(array, name, label) items and an ``epoch`` the loader sets."""

    def __init__(self, n):
        self.n, self.epoch = n, 0

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng((i, self.epoch))
        return (rng.random((3, 4), np.float32), f"item{i}",
                {"label": np.int64(i % 3)})


def _batches(loader, epochs=3):
    out = []
    for e in range(epochs):
        loader.set_epoch(e)
        out.append(list(loader))
    return out


@pytest.mark.parametrize("num_workers", [1, 4])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_matches_jax(num_workers, drop_last):
    kw = dict(batch_size=4, drop_last=drop_last, num_workers=num_workers,
              seed=3)
    tl = tloader.Loader(_Items(18), **kw)
    jl = jloader.Loader(_Items(18), **kw)
    assert len(tl) == len(jl) == (4 if drop_last else 5)
    got, ref = _batches(tl), _batches(jl)
    _equal(got, ref)
    # the per-epoch permutations differ, and set_epoch reached the dataset
    assert got[0][0][1] != got[1][0][1]
    assert tl.dataset.epoch == 2


def test_loader_unshuffled_and_cycle_match_jax():
    tl = tloader.Loader(_Items(10), 3, shuffle=False, num_workers=2)
    jl = jloader.Loader(_Items(10), 3, shuffle=False, num_workers=2)
    assert [b[1] for b in tl] == [[f"item{i}" for i in range(3 * j, 3 * j + 3)]
                                  for j in range(3)]
    tc, jc = tloader.cycle(tl), jloader.cycle(jl)
    got = [next(tc) for _ in range(8)]
    ref = [next(jc) for _ in range(8)]
    _equal(got, ref)
    assert tl.epoch == jl.epoch == 2  # wrapped twice


class _Broken(_Items):
    def __getitem__(self, i):
        if i == 5:
            raise ValueError("bad item 5")
        return super().__getitem__(i)


@pytest.mark.parametrize("mod", [tloader, jloader], ids=["port", "jax"])
def test_loader_raises_a_workers_exception(mod):
    loader = mod.Loader(_Broken(12), 2, shuffle=False, num_workers=3)
    with pytest.raises(RuntimeError, match="loader worker failed") as e:
        list(loader)
    assert "bad item 5" in str(e.value.__cause__)


# ------------------------------------------------------------ fixtures

def _write_png(path, rng, size=40, mode="L"):
    shape = (size, size) if mode == "L" else (size, size, 3)
    arr = (rng.random(shape) * 255).astype(np.uint8)
    Image.fromarray(arr, mode=mode).save(path)


@pytest.fixture(scope="module")
def png_tree(tmp_path_factory):
    """4 patients (two with two visits) of 5-7 PNG frames, one patient's
    frames RGB and one 1024 wide (the 1024 -> 512 rule), and a Kermany
    folder of 2 classes x 2 images."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for p in range(4):
        visits = ["v0", "v1"] if p < 2 else [None]
        for v in visits:
            d = root / "tree" / f"p{p}" / (v or "")
            d.mkdir(parents=True, exist_ok=True)
            for t in range(5 + p % 3):
                _write_png(str(d / f"oct_{t:03d}.png"), rng,
                           size=1024 if p == 3 else 40,
                           mode="RGB" if p == 2 else "L")
    for cls in ("NORMAL", "CNV"):
        d = root / "kermany" / cls
        d.mkdir(parents=True)
        for i in range(2):
            _write_png(str(d / f"k{i}.png"), rng, size=48)
    return root


def test_scan_directory_and_labels_match_jax(png_tree):
    tv = tpatients.scan_directory(str(png_tree / "tree"))
    jv = jpatients.scan_directory(str(png_tree / "tree"))
    assert len(tv) == 6
    assert [(v.patient_id, v.visit_id, v.frames) for v in tv] == [
        (v.patient_id, v.visit_id, v.frames) for v in jv]
    for mode in ("binary_cls", "multi_cls", "multi_label"):
        for v in tv + jv:
            v.labels = {"AMD": int(v.patient_id == "p1"),
                        "DME": int(v.patient_id == "p2")}
        tc, tf = tpatients.build_labels(tv, mode)
        jc, jf = jpatients.build_labels(jv, mode)
        assert tc == jc
        _equal([tf(v) for v in tv], [jf(v) for v in jv])
    tsplit = tpatients.kfold_patient_split(tv, 2, 1, seed=4)
    jsplit = jpatients.kfold_patient_split(jv, 2, 1, seed=4)
    assert ([[v.frames for v in s] for s in tsplit]
            == [[v.frames for v in s] for s in jsplit])
    ts = tpatients.single_fold_split(tv, ["p0"], ["p1", "p2"], ["p3"])
    js = jpatients.single_fold_split(jv, ["p0"], ["p1", "p2"], ["p3"])
    assert ([[v.frames for v in s] for s in ts]
            == [[v.frames for v in s] for s in js])


@pytest.fixture
def pil_only(monkeypatch):
    """Both packages' native decoders unavailable: the PIL path."""
    monkeypatch.setattr(tnative, "load_png_stack_native",
                        lambda *a, **k: None)
    monkeypatch.setattr(jnative, "load_png_stack_native",
                        lambda *a, **k: None)


def _datasets(visits_t, visits_j, mode="frame", **kw):
    ttr, _ = ttransforms.create_3d_transforms(24, 8)
    jtr, _ = jtransforms.create_3d_transforms(24, 8)
    t = tpatients.PatientDataset3D(visits_t, lambda v: np.int64(1),
                                   dataset_mode=mode, max_frames=6,
                                   transform=ttr, seed=5, **kw)
    j = jpatients.PatientDataset3D(visits_j, lambda v: np.int64(1),
                                   dataset_mode=mode, max_frames=6,
                                   transform=jtr, seed=5, **kw)
    return t, j


@pytest.mark.parametrize("decoder", ["native", "pil"])
def test_patient_dataset_frames_match_jax(png_tree, decoder, request):
    if decoder == "pil":
        request.getfixturevalue("pil_only")
    tv = tpatients.scan_directory(str(png_tree / "tree"))
    jv = jpatients.scan_directory(str(png_tree / "tree"))
    t, j = _datasets(tv, jv, return_frame_paths=True)
    for epoch in (0, 1):
        t.epoch = j.epoch = epoch
        for i in range(len(t)):
            got, ref = t[i], j[i]
            _equal(got, ref)
            assert got[0].shape == (8, 24, 24, 1)
            assert len(got[1]) == 6  # frame paths padded / cropped to 6
    # the train transform redraws its flips per epoch
    draws = []
    for epoch in range(6):
        t.epoch = epoch
        draws.append(t[0][0])
    assert any(not np.array_equal(draws[0], d) for d in draws[1:])


def test_patient_dataset_npy_and_dicom_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    for p in range(2):
        d = tmp_path / "npy" / f"p{p}"
        d.mkdir(parents=True)
        np.save(d / "vol.npy", (rng.random((9, 1024, 30)) * 255
                                ).astype(np.float32))
        d = tmp_path / "dcm" / f"p{p}"
        d.mkdir(parents=True)
        vol = (rng.random((7, 30, 40)) * 255).astype(np.uint8)
        write_dicom(str(d / "vol.dcm"), vol,
                    manufacturer="Topcon" if p else "Heidelberg",
                    model="Maestro2" if p else "Spectralis")
    for kind, mode in (("npy", "volume"), ("dcm", "dicom")):
        tv = tpatients.scan_directory(str(tmp_path / kind))
        jv = jpatients.scan_directory(str(tmp_path / kind))
        t, j = _datasets(tv, jv, mode=mode, return_frame_paths=True)
        for i in range(len(t)):
            _equal(t[i], j[i])
        t, j = _datasets(tv, jv, mode=mode, return_patient_id=True)
        _equal(t[1], j[1])
    # the bicubic volume resize
    tv = tpatients.scan_directory(str(tmp_path / "npy"))
    jv = jpatients.scan_directory(str(tmp_path / "npy"))
    t, j = _datasets(tv, jv, mode="volume", volume_resize=(20, 16))
    _equal(t[0], j[0])


def test_center_2d_and_image_folder_match_jax(png_tree):
    tv = tpatients.scan_directory(str(png_tree / "tree"))
    jv = jpatients.scan_directory(str(png_tree / "tree"))
    t = tpatients.PatientDatasetCenter2D(
        tv, lambda v: np.int64(0), ttransforms.Transform2DTrain(16),
        return_path=True)
    j = jpatients.PatientDatasetCenter2D(
        jv, lambda v: np.int64(0), jtransforms.Transform2DTrain(16),
        return_path=True)
    for i in range(len(t)):
        _equal(t[i], j[i])
    t = tpatients.ImageFolderDataset(str(png_tree / "kermany"),
                                     ttransforms.Transform2D(16), epoch=2)
    j = jpatients.ImageFolderDataset(str(png_tree / "kermany"),
                                     jtransforms.Transform2D(16), epoch=2)
    assert t.classes == j.classes == ["CNV", "NORMAL"]
    for i in range(len(t)):
        _equal(t[i], j[i])


# ---------------------------------------------------------- transforms

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_train_transforms_match_jax(seed):
    rng = np.random.default_rng(seed)
    vol = rng.random((11, 30, 26)).astype(np.float32)
    vol[:, :4] = 0  # a blank band: crop_foreground trims it
    vol[:2] = 0
    img = rng.random((40, 36, 3)).astype(np.float32)
    for normalize in (False, True):
        ttr, tval = ttransforms.create_3d_transforms(
            16, 6, normalize_dataset=normalize)
        jtr, jval = jtransforms.create_3d_transforms(
            16, 6, normalize_dataset=normalize)
        _equal(ttr(vol, rng=np.random.default_rng(seed)),
               jtr(vol, rng=np.random.default_rng(seed)))
        _equal(tval(vol), jval(vol))
    _equal(ttransforms.crop_foreground(vol), jtransforms.crop_foreground(vol))
    _equal(ttransforms.Transform2D(24)(img), jtransforms.Transform2D(24)(img))
    _equal(ttransforms.Transform2D(24)(img[..., 0]),
           jtransforms.Transform2D(24)(img[..., 0]))
    _equal(ttransforms.Transform2DTrain(24)(img, np.random.default_rng(seed)),
           jtransforms.Transform2DTrain(24)(img, np.random.default_rng(seed)))


def test_val_transform_is_deterministic():
    vol = np.random.default_rng(0).random((9, 20, 20)).astype(np.float32)
    vol[:, :5] = 0
    _, val = ttransforms.create_3d_transforms(16, 6)
    assert not val.train
    outs = [val(vol, rng=np.random.default_rng(s)) for s in range(4)]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    # the train default crops and flips
    tr = ttransforms.Transform3D(16, 6)
    assert tr.train
    assert any(not np.array_equal(tr(vol, rng=np.random.default_rng(s)),
                                  outs[0]) for s in range(4))


@pytest.mark.parametrize("seed", range(6))
def test_randaug_matches_jax(seed):
    img = np.random.default_rng(10 + seed).random((20, 24, 3)).astype(
        np.float32)
    _equal(trandaug.rand_augment(img, np.random.default_rng(seed)),
           jrandaug.rand_augment(img, np.random.default_rng(seed)))
    _equal(trandaug.random_erasing(img, np.random.default_rng(seed), 1.0),
           jrandaug.random_erasing(img, np.random.default_rng(seed), 1.0))
    batch = np.random.default_rng(seed).random((4, 8, 8, 3)).astype(
        np.float32)
    onehot = np.eye(4, dtype=np.float32)
    _equal(trandaug.mixup_cutmix(batch, onehot, np.random.default_rng(seed)),
           jrandaug.mixup_cutmix(batch, onehot, np.random.default_rng(seed)))
    for op_t, op_j in zip(trandaug._OPS, jrandaug._OPS):
        rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
        if op_t in trandaug._SIGNED:
            _equal(op_t(img, 7.0, rng_t, sign=-1), op_j(img, 7.0, rng_j,
                                                        sign=-1))
        else:
            _equal(op_t(img, 7.0, rng_t), op_j(img, 7.0, rng_j))


# ------------------------------------------------------------------ SPL

def test_spl_state_matches_jax(tmp_path):
    names = [f"f{i}" for i in range(12)]
    ts, js = tspl.SPLState(names), jspl.SPLState(names)
    rng = np.random.default_rng(0)
    paths = [tuple(names[i:i + 6]) for i in (0, 6)]
    paths[1] = paths[1][:4] + ("", "elsewhere")  # pads and unknown names
    for _ in range(2):
        tube = rng.random((2, 2)).astype(np.float32)
        ts.update_from_volume_losses(paths, tube, 3)
        js.update_from_volume_losses(paths, tube, 3)
    per = rng.random(3)
    ts.update_hardness(["f1", "f5", "nope"], per)
    js.update_hardness(["f1", "f5", "nope"], per)
    assert ts.hardness == js.hardness
    assert ts.update_spl(0.5) == js.update_spl(0.5)

    class DS:
        def __init__(self):
            self.names = names

        def __getitem__(self, i):
            return np.float32(i), self.names[i]

    tsub, jsub = ts.subset(DS()), js.subset(DS())
    assert len(tsub) == len(jsub) == 6
    assert [tsub[i] for i in range(6)] == [jsub[i] for i in range(6)]
    # the subset is a live view of the active list
    ts.update_spl(0.25)
    assert len(tsub) == 3

    # pickles pass between the packages both ways, byte for byte
    os.makedirs(tmp_path / "t")
    tp = ts.save(str(tmp_path / "t"), 3)
    js.update_spl(0.25)
    jp = js.save(str(tmp_path), 3)
    assert os.path.basename(tp) == os.path.basename(jp) == \
        "all_image_dict-3.pkl"
    with open(tp, "rb") as f, open(jp, "rb") as g:
        assert f.read() == g.read()
    a, b = jspl.SPLState.load(tp), tspl.SPLState.load(jp)
    assert a.hardness == b.hardness == ts.hardness
    assert a.active == b.active == names
    with open(tp, "rb") as f:
        d = pickle.load(f)
    assert all(set(v) == {"hardness", "mse_loss", "visited"}
               and type(v["hardness"]) is float and type(v["visited"]) is int
               for v in d.values())


def test_pretrain_2d_dataset_matches_jax(png_tree, pil_only):
    tv = tpatients.scan_directory(str(png_tree / "tree"))
    jv = jpatients.scan_directory(str(png_tree / "tree"))
    for kw in (dict(size=32, t_patch=3), dict(size=24, as_tube=False),
               dict(size=32, train=False)):
        t = tspl.Pretrain2DDataset(tv, str(png_tree / "kermany"), **kw)
        j = jspl.Pretrain2DDataset(jv, str(png_tree / "kermany"), **kw)
        assert t.names == j.names
        assert len(t) == sum(len(v.frames) for v in tv) + 4
        for epoch in (0, 1):
            t.epoch = j.epoch = epoch
            for i in range(0, len(t), 3):
                _equal(t[i], j[i])


# --------------------------------------------------------------- native

def test_native_decoder_matches_jax_and_pil(png_tree):
    assert tnative.available(), "g++ and libpng build the native decoder"
    lib = tnative.lib_path()
    assert lib.is_file() and lib.parent != tnative.SOURCE.parent
    for v in tpatients.scan_directory(str(png_tree / "tree")):
        got = tnative.load_png_stack_native(v.frames)
        ref = jnative.load_png_stack_native(v.frames)
        _equal(got, ref)
        frames = []
        for p in v.frames:
            img = Image.open(p).convert("L")
            if img.size[0] == 1024:
                img = img.resize((512, img.size[1]))
            if img.size[1] == 1024:
                img = img.resize((img.size[0], 512))
            frames.append(np.asarray(img, np.float32) / 255.0)
        pil = np.stack(frames)
        assert got.shape == pil.shape
        if v.patient_id in ("p0", "p1"):  # 8-bit gray, no resampling
            np.testing.assert_array_equal(got, pil)
        elif v.patient_id == "p3":
            # the 1024 -> 512 resample rounds in its own fixed point: the
            # JAX package's own bound against PIL
            # (tests/test_crossmodal_native.py)
            assert np.abs(got - pil).max() <= 2.5 / 255
            assert np.abs(got - pil).mean() < 0.5 / 255
        else:
            # RGB frames: libpng's rgb_to_gray truncates where PIL's "L"
            # rounds, one uint8 step at most (the JAX decoder's behaviour,
            # which the port keeps)
            assert np.abs(got - pil).max() <= 1.5 / 255
        _equal(tingest.load_frame_stack(v.frames),
               jingest.load_frame_stack(v.frames))
    assert tnative.load_png_stack_native([]) is None


def test_ingest_helpers_match_jax():
    rng = np.random.default_rng(2)
    vol = rng.random((5, 6, 7)).astype(np.float32)
    paths = [f"f{i}" for i in range(5)]
    for n in (3, 5, 8):
        _equal(tingest.pad_or_crop_frames(vol, n),
               jingest.pad_or_crop_frames(vol, n))
        assert tingest.pad_or_crop_paths(paths, n) == \
            jingest.pad_or_crop_paths(paths, n)
    _equal(tingest.pad_or_crop_frames(vol, 3, same_3_frames=True),
           jingest.pad_or_crop_frames(vol, 3, same_3_frames=True))
    topcon = (rng.random((4, 885, 30)) * 255).astype(np.float32)
    topcon[:, :300] = 3.0
    for model in ("Maestro2", "Triton"):
        _equal(tingest.normalize_dicom_volume(topcon, "Topcon", model),
               jingest.normalize_dicom_volume(topcon, "Topcon", model))
    assert tingest.otsu_threshold(vol) == jingest.otsu_threshold(vol)
