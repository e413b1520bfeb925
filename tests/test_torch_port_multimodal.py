"""Port parity: the COEM data (data/multimodal.py, data/shards.py,
data/geometry.py) against the JAX package's, on a seeded PNG tree: every
one of the 13 modes serves the same records and the same arrays, with and
without the aspect-aware shape fold; the manifest dataset
(build_ga_manifest, OCTFAFIRClsDataset) for modes 9, 10 and 12; the
multi-source dataset and the collate; the tar shards; and the B-scan
coverage geometry.  Arrays are compared exactly: both packages run the
same numpy."""

import io
import os
import tarfile

import numpy as np
import pytest

from octcubem_tpu.data import geometry as jgeo
from octcubem_tpu.data import multimodal as jmm
from octcubem_tpu.data import shards as jsh
from octcubem_tpu_torch.data import geometry as tgeo
from octcubem_tpu_torch.data import multimodal as tmm
from octcubem_tpu_torch.data import shards as tsh


def _png(path, rng, shape):
    from PIL import Image

    arr = (rng.random(shape) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """6 patients: IR + FAF, IR only, FAF only, neither (a visit each),
    and a second visit of patient 0; OCT frames 40 x 48, en face 24 x 24
    RGB."""
    root = tmp_path_factory.mktemp("paired")
    rng = np.random.default_rng(0)
    kinds = [("p0", "v0", True, True), ("p0", "v1", True, False),
             ("p1", "v0", True, False), ("p2", "v0", False, True),
             ("p3", "v0", False, False), ("p4", "v0", True, True)]
    for pid, vid, ir, faf in kinds:
        d = root / pid / vid
        d.mkdir(parents=True)
        for t in range(5):
            _png(str(d / f"oct_{t:03d}.png"), rng, (40, 48))
        if ir:
            _png(str(d / "ir.png"), rng, (24, 24, 3))
        if faf:
            _png(str(d / "faf.png"), rng, (24, 24, 3))
    return root


def _same(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        if isinstance(a[k], np.ndarray) or np.isscalar(a[k]):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{what}: {k}")
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        else:
            assert a[k] == b[k], f"{what}: {k}"


@pytest.mark.parametrize("mode", sorted(jmm.MODE_MAPPING))
@pytest.mark.parametrize("aspect", [False, True])
def test_every_mode_serves_jax_samples(tree, mode, aspect):
    kw = dict(num_frames=6, oct_size=16, enface_size=16, mode=mode,
              aspect_aware=aspect, epoch=1)
    jds = jmm.PairedOCTEnfaceDataset(jmm.scan_paired_directory(str(tree)),
                                     **kw)
    tds = tmm.PairedOCTEnfaceDataset(tmm.scan_paired_directory(str(tree)),
                                     **kw)
    assert tds.mode == jds.mode == jmm.MODE_MAPPING[mode]
    assert len(tds) == len(jds)
    assert [r.visit.frames for r in tds.records] == [
        r.visit.frames for r in jds.records]
    for i in range(len(jds)):
        _same(tds[i], jds[i], f"mode {mode} item {i}")


def test_unknown_mode_refused(tree):
    with pytest.raises(ValueError, match="unknown multimodal mode"):
        tmm.PairedOCTEnfaceDataset([], mode="oct3d_everything")


@pytest.mark.parametrize("shape", [(61, 8, 1024), (25, 6, 512),
                                   (193, 4, 1536), (19, 5, 768),
                                   (49, 6, 512), (121, 4, 768)])
def test_convert_hw_shape_matches_jax(shape):
    vol = np.random.default_rng(1).random(shape).astype(np.float32)
    got = tmm.convert_hw_shape(vol, rng=np.random.default_rng(3))
    want = jmm.convert_hw_shape(vol, rng=np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)


def test_aggregated_dataset_and_collate(tree):
    def parts(mm):
        recs = mm.scan_paired_directory(str(tree))
        return [mm.PairedOCTEnfaceDataset(recs, 6, 16, 16, mode=m)
                for m in ("oct3d_ir", "oct3d_faf_ir")]

    jagg = jmm.AggregatedPairedDataset(parts(jmm))
    tagg = tmm.AggregatedPairedDataset(parts(tmm))
    assert len(tagg) == len(jagg)
    assert tagg.cumulative_sizes == jagg.cumulative_sizes
    for i in range(len(jagg)):
        _same(tagg[i], jagg[i], f"aggregated item {i}")
    assert sorted(tagg.key_to_record()) == sorted(jagg.key_to_record())
    tagg.epoch = 3
    assert all(d.epoch == 3 for d in tagg.datasets)
    tb, tk = tmm.collate_paired([tagg[0], tagg[1]])
    jb, jk = jmm.collate_paired([jagg[0], jagg[1]])
    assert tk == jk
    _same(tb, jb, "collate")


@pytest.fixture(scope="module")
def manifest(tree, tmp_path_factory):
    d = tmp_path_factory.mktemp("manifest")
    labels = d / "labels.csv"
    labels.write_text("patient_id,ga_area,ga_growth\np0,1.5,0.2\n"
                      "p1,2.0,0.4\np2,0.5,0.1\np3,3.0,0.9\np4,1.0,0.3\n")
    out = {}
    for name, mm in (("jax", jmm), ("port", tmm)):
        path = str(d / f"{name}.csv")
        n = mm.build_ga_manifest(str(tree), path, labels_csv=str(labels),
                                 label_keys=["ga_area", "ga_growth"],
                                 n_splits=2, seed=4)
        out[name] = (path, n)
    return out


def test_build_ga_manifest_matches_jax(manifest):
    (jp, jn), (tp, tn) = manifest["jax"], manifest["port"]
    assert tn == jn == 6
    with open(jp) as a, open(tp) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("mode", [9, 10, 12])
def test_cls_manifest_dataset_matches_jax(tree, manifest, mode):
    """Rows a mode can serve: the FAF rows for 9, IR for 10, both for 12
    (filtered here as the reference's manifests are)."""
    import csv

    path = manifest["port"][0]
    with open(path) as f:
        rows = list(csv.DictReader(f))
    need = {9: ("faf_file_path",), 10: ("ir_file_path",),
            12: ("ir_file_path", "faf_file_path")}[mode]
    keep = [r for r in rows if all(r[k] for k in need)]
    sub = path.replace(".csv", f"_mode{mode}.csv")
    with open(sub, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(keep)
    kw = dict(parent_dir=str(tree), mode=mode,
              label_keys=["ga_area", "ga_growth"], num_frames=6, oct_size=16,
              enface_size=16, standardize=False)
    jds = jmm.OCTFAFIRClsDataset(sub, **kw)
    tds = tmm.OCTFAFIRClsDataset(sub, **kw)
    assert len(tds) == len(jds) == len(keep)
    assert tds.available_split == jds.available_split
    for split in jds.available_split:
        assert tds.cv_indices(split) == jds.cv_indices(split)
        tr, _ = jds.cv_indices(split)
        if tr:
            for a, b in zip(tds.raw_label_stats(tr), jds.raw_label_stats(tr)):
                np.testing.assert_array_equal(a, b)
    for i in range(len(jds)):
        _same(tds[i], jds[i], f"mode {mode} row {i}")
    tds.update_dataset_indexing("cv_test", jds.available_split[0])
    jds.update_dataset_indexing("cv_test", jds.available_split[0])
    assert len(tds) == len(jds)
    tds.epoch = jds.epoch = 2
    for i in range(len(jds)):
        _same(tds[i], jds[i], f"mode {mode} cv_test row {i}")


def _shard(path, keys, seed):
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w") as tar:
        for k in keys:
            buf = io.BytesIO()
            np.save(buf, rng.random((3, 4)).astype(np.float32))
            for ext, data in (("npy", buf.getvalue()),
                              ("json", b'{"eye": "OD"}'),
                              ("cls", str(len(k) % 3).encode())):
                info = tarfile.TarInfo(f"{k}.{ext}")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))


def _records(it):
    return [(s["__key__"], s["cls"], s["json"], s["npy"].tobytes())
            for s in it]


def test_shards_match_jax(tmp_path):
    paths = []
    for s in range(3):
        p = str(tmp_path / f"s{s}.tar")
        _shard(p, [f"d{s}.x/item{i}" for i in range(5)], s)
        paths.append(p)
    assert _records(tsh.iterate_shard(paths[0])) == _records(
        jsh.iterate_shard(paths[0]))
    for kw in (dict(shuffle_buffer=4, seed=2),
               dict(shuffle_buffer=1, worker_index=1, num_workers=2)):
        tds, jds = tsh.ShardDataset(paths, **kw), jsh.ShardDataset(paths, **kw)
        for epoch in (0, 1):
            tds.set_epoch(epoch)
            jds.set_epoch(epoch)
            assert _records(tds) == _records(jds)


def test_geometry_matches_jax():
    rng = np.random.default_rng(9)
    for _ in range(20):
        x0, x1 = sorted(rng.uniform(0, 384, 2))
        y = float(rng.uniform(0, 384))
        for direction in ("up", "down"):
            assert (tgeo.horizontal_line_patches(x0, x1, y,
                                                 y_direction=direction)
                    == jgeo.horizontal_line_patches(x0, x1, y,
                                                    y_direction=direction))
    lines = np.stack([np.full(25, 30.0), np.linspace(40, 340, 25),
                      np.full(25, 350.0), np.linspace(40, 340, 25)], 1)
    for flip in (False, True):
        np.testing.assert_array_equal(
            tgeo.bscan_coverage_mask(lines, flip_y=flip),
            jgeo.bscan_coverage_mask(lines, flip_y=flip))
    for res in ((61, 496, 768), (19, 496, 512), (49, 496, 1024),
                (121, 496, 384), (97, 496, 1536)):
        assert tgeo.oct_token_region(res) == jgeo.oct_token_region(res)
