"""The port's COEM CLIs alone on the CPU: cli/retclip.py (train, resume
bit for bit, params-only resume, evaluate-only with the int8 towers and
with a frozen artifact, the multi-root paired data with the retrieval pkl
and its panels, the refusals), cli/retclip_finetune.py (synthetic with
the lock and single-modality ablations, the manifest flow with towers
from a retclip run and an independent test) and cli/retrieval_eval.py
(laterality top-k, panels).  test_torch_port_retclip_pair.py runs both
packages' CLIs on the same flags."""

import csv
import json
import os
import pickle

import numpy as np
import pytest
import torch

from octcubem_tpu_torch.cli import retclip, retclip_finetune, retrieval_eval
from octcubem_tpu_torch.compat.aot import flash_op_calls, load_serving_artifact
from octcubem_tpu_torch.core import checkpoint as ckpt_lib
from octcubem_tpu_torch.data.multimodal import build_ga_manifest

TINY = ["--model_config", "vitl16_octcube_ir_tiny_test", "--device", "cpu"]


def _run(out, *flags, n=40):
    return retclip.main(TINY + ["--synthetic", "--synthetic_n", str(n),
                                "--batch_size", "8", "--output_dir",
                                str(out), *flags])


def _params(out):
    raw, step = ckpt_lib.restore_raw(os.path.join(out, "ckpt"))
    return raw, step


def test_train_and_resume_bit_for_bit(tmp_path):
    """Two epochs in one run equal one epoch then --resume latest into the
    second, bit for bit: params, moments, count, generator.  The params.txt
    records the as-built towers; results.jsonl one row an epoch."""
    _run(tmp_path / "a", "--epochs", "2")
    _run(tmp_path / "b", "--epochs", "1")
    state = _run(tmp_path / "b", "--epochs", "2", "--resume", "latest")
    assert state.step == 2
    (ra, sa), (rb, sb) = _params(tmp_path / "a"), _params(tmp_path / "b")
    assert sa == sb == 1
    for part in ("params",):
        for k, v in ra[part].items():
            assert torch.equal(v, rb[part][k]), k
    for key in ("mu", "nu"):
        for k, v in ra["opt_state"][key].items():
            assert torch.equal(v, rb["opt_state"][key][k]), k
    assert ra["opt_state"]["count"] == rb["opt_state"]["count"] == 2
    assert torch.equal(ra["generator"], rb["generator"])
    with open(tmp_path / "a" / "params.txt") as f:
        rec = json.load(f)
    assert rec["model"] == "vitl16_octcube_ir_tiny_test"
    assert rec["vision_cfg"]["num_heads"] == 2 and rec["embed_dim"] == 16
    with open(tmp_path / "a" / "results.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [0, 1]
    assert 0.0 <= rows[-1]["image_to_enface_R@1"] <= 1.0
    # a 9-group lock on a 2-block tower unlocks everything: moments for
    # every param
    assert set(ra["opt_state"]["mu"]) == set(ra["params"])


def test_params_only_resume_and_geometry_guard(tmp_path):
    _run(tmp_path, "--epochs", "1")
    state = _run(tmp_path, "--epochs", "1", "--resume", "latest",
                 "--resume_params_only")
    raw, _ = _params(tmp_path)
    # the fresh optimizer trained epoch 0 again from the saved params
    assert state.step == 1 and state.tx.count == 1
    assert not torch.equal(state.params.state_dict()["logit_scale"],
                           raw["params"]["logit_scale"])
    with open(tmp_path / "params.txt") as f:
        rec = json.load(f)
    rec["vision_cfg"]["num_heads"] = 1
    with open(tmp_path / "params.txt", "w") as f:
        json.dump(rec, f)
    with pytest.raises(SystemExit, match="geometry mismatch"):
        _run(tmp_path, "--epochs", "2", "--resume", "latest")


@pytest.fixture(scope="module")
def d32_config(tmp_path_factory):
    """A tiny COEM config at head_dim 32 (B1's op serves it, so an
    artifact can be exported)."""
    d = tmp_path_factory.mktemp("cfg")
    path = d / "coem_d32.json"
    path.write_text(json.dumps({
        "embed_dim": 16, "three_mod": False,
        "vision_cfg": {"num_frames": 6, "t_patch_size": 3, "img_size": 32,
                       "patch_size": 16, "in_chans": 1, "embed_dim": 64,
                       "depth": 2, "num_heads": 2},
        "enface_cfg": {"img_size": 32, "patch_size": 16, "in_chans": 3,
                       "embed_dim": 64, "depth": 2, "num_heads": 2,
                       "num_mod_head": 1}}))
    return str(path)


def test_evaluate_only_int8_and_artifact(tmp_path, d32_config):
    """The trained run evaluated live, with the int8 towers, and through
    an exported artifact (B1 op calls in its graph): the artifact's
    metrics equal the live model's; --aot / --quant refuse to train."""
    out = str(tmp_path / "run")
    common = ["--model_config", d32_config, "--device", "cpu", "--synthetic",
              "--synthetic_n", "40", "--batch_size", "8", "--output_dir", out]
    retclip.main(common + ["--epochs", "1"])
    live = retclip.main(common + ["--resume", "latest", "--evaluate_only"])
    q = retclip.main(common + ["--resume", "latest", "--evaluate_only",
                               "--quant", "int8"])
    assert q.keys() == live.keys()
    assert all(0.0 <= v <= 1.0 for k, v in q.items() if "R@" in k)
    art = str(tmp_path / "enc.octaot")
    assert retclip.main(common + ["--resume", "latest", "--export_aot",
                                  art]) == art
    fn, meta = load_serving_artifact(art, "cpu")
    assert meta["kind"] == "coem_retrieval_encoder"
    assert not meta["three_mod"] and meta["in_shapes"][0][0] == 8
    assert flash_op_calls(fn.program) == 4
    aot = retclip.main(common + ["--resume", "latest", "--evaluate_only",
                                 "--aot", art])
    assert aot == live
    with pytest.raises(SystemExit, match="evaluation-only"):
        retclip.main(common + ["--aot", art, "--epochs", "2"])


def _png(path, rng, shape):
    from PIL import Image

    Image.fromarray((rng.random(shape) * 255).astype(np.uint8)).save(path)


def _paired_tree(root, rng, n, faf=False):
    for p in range(n):
        d = root / f"p{p}" / "v0"
        d.mkdir(parents=True)
        for t in range(6):
            _png(str(d / f"oct_{t:03d}.png"), rng, (40, 40))
        _png(str(d / "ir.png"), rng, (40, 40))
        if faf:
            _png(str(d / "faf.png"), rng, (40, 40))


def test_multiroot_pkl_and_retrieval_eval(tmp_path):
    """Two roots behind one loader, the pkl with row-aligned keys and
    paths, then the offline evaluator: laterality top-k from a seeded
    laterality column and two panels."""
    rng = np.random.default_rng(11)
    _paired_tree(tmp_path / "a", rng, 10)
    _paired_tree(tmp_path / "b", rng, 8)
    out = str(tmp_path / "rc")
    retclip.main(TINY + ["--data_dir", str(tmp_path / "a"), "--data_dir",
                         str(tmp_path / "b"), "--batch_size", "8",
                         "--epochs", "1", "--save_retrieval_results",
                         "--output_dir", out])
    pkl = os.path.join(out, "retrieval_results_0.pkl")
    with open(pkl, "rb") as f:
        d = pickle.load(f)
    assert len(d["keys"]) == len(d["image"]) == len(d["enface"])
    assert {k.split("/")[0] for k in d["keys"]} == {"ds0", "ds1"}
    assert all(d["paths"][k]["enface1"] for k in d["keys"])
    with pytest.raises(SystemExit, match="laterality"):
        retrieval_eval.main([pkl])
    lat = np.random.default_rng(3).integers(0, 2, len(d["image"]))
    d["image_laterality"] = d["enface_laterality"] = lat
    with open(pkl, "wb") as f:
        pickle.dump(d, f)
    panels = str(tmp_path / "panels")
    res = retrieval_eval.main([pkl, "--topk", "1", "3", "--panels_dir",
                               panels, "--n_queries", "2"])
    top1 = retrieval_eval.laterality_from_topk(d["image"], d["enface"], lat,
                                               1)
    assert res["laterality_acc@top1"] == float((top1 == lat).mean())
    assert set(res) == {"laterality_acc@top1", "laterality_acc@top3",
                        "panels_written"}
    assert res["panels_written"] == 2 and len(os.listdir(panels)) == 2


def test_refusals(tmp_path, monkeypatch):
    cfg = tmp_path / "dp.json"
    cfg.write_text(json.dumps({"n_data": 2}))
    # n_data 2 needs two ranks (their run: test_torch_port_multihost.py)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        retclip.main(["--preset", str(cfg), "--device", "cpu",
                      "--synthetic", "--output_dir", str(tmp_path / "dp")])
    assert not (tmp_path / "dp").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((retclip.main, ["--synthetic"]),
                       (retclip_finetune.main, ["--tiny"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv + ["--output_dir", str(tmp_path / "nocard")])
    assert not (tmp_path / "nocard").exists()


@pytest.mark.parametrize("flags", [
    ["--three_mod", "--lock_image", "--lock_image_unlocked_groups", "2"],
    ["--single_modality", "enface"],
    ["--three_mod", "--single_modality", "image"]])
def test_finetune_synthetic(tmp_path, flags):
    out = str(tmp_path / "ft")
    reg = retclip_finetune.main(["--tiny", "--device", "cpu", "--epochs",
                                 "2", "--batch_size", "4", "--synthetic_n",
                                 "16", "--output_dir", out] + flags)
    assert sorted(reg) == [0, 1]
    with open(os.path.join(out, "results.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [(r["fold"], r["epoch"]) for r in rows] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(np.isfinite(r["train_loss"]) for r in rows)
    with open(os.path.join(out, "cv_registry.json")) as f:
        assert len(json.load(f)) == 2
    for fold in (0, 1):
        assert len(os.listdir(os.path.join(out, f"ckpt_fold{fold}"))) == 1


def _ga_fixture(tmp_path, rng, name, n):
    root = tmp_path / name
    _paired_tree(root, rng, n, faf=True)
    labels = tmp_path / f"{name}_labels.csv"
    with open(labels, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["patient_id", "ga_area",
                                          "ga_growth"])
        w.writeheader()
        for p in range(n):
            w.writerow({"patient_id": f"p{p}",
                        "ga_area": round(float(rng.random() * 5), 3),
                        "ga_growth": round(float(rng.random()), 3)})
    manifest = str(tmp_path / f"{name}.csv")
    assert build_ga_manifest(str(root), manifest, labels_csv=str(labels),
                             label_keys=["ga_area", "ga_growth"],
                             n_splits=2) == n
    return manifest, str(root)


def test_finetune_manifest_from_a_retclip_run(tmp_path, monkeypatch):
    """The GA-growth flow: 2-fold CV over a manifest, towers from a tiny
    retclip run (the copy checked), per-label best val with the
    independent test captured; a run of other head geometry refused."""
    rng = np.random.default_rng(23)
    manifest, parent = _ga_fixture(tmp_path, rng, "ga", 12)
    ind, _ = _ga_fixture(tmp_path, rng, "ga_ind", 4)
    rc = str(tmp_path / "rc")
    _run(rc, "--epochs", "1", n=24)
    flags = ["--manifest_csv", manifest, "--parent_dir", parent,
             "--independent_manifest_csv", ind, "--init_ckpt", rc, "--tiny",
             "--label_keys", "ga_area,ga_growth", "--multimodal_type", "9",
             "--k_folds", "2", "--epochs", "2", "--batch_size", "4",
             "--device", "cpu"]
    copied = []
    from octcubem_tpu_torch.train import clip_engine

    real = clip_engine.init_towers_from_retclip

    def spy(model, path, step=None):
        out = real(model, path, step)
        copied.append(out[1])
        raw, _ = ckpt_lib.restore_raw(os.path.join(path, "ckpt"))
        for k, v in model.clip.state_dict().items():
            assert torch.equal(v, raw["params"][k]), k
        return out

    monkeypatch.setattr(clip_engine, "init_towers_from_retclip", spy)
    summary = retclip_finetune.main(flags + ["--output_dir",
                                             str(tmp_path / "ft")])
    assert len(copied) == 2 and copied[0] > 0
    assert summary["label_keys"] == ["ga_area", "ga_growth"]
    assert summary["folds"] == [0, 1]
    for k in range(2):
        assert all(e >= 0 for e in summary["best_val_epoch"][k])
        assert all(m is not None and "r2_0" in m
                   for m in summary["independent_test_at_best_val"][0][k])
    with open(tmp_path / "ft" / "best_metrics.json") as f:
        assert json.load(f)["folds"] == [0, 1]
    with open(os.path.join(rc, "params.txt")) as f:
        rec = json.load(f)
    rec["enface_cfg"]["num_heads"] = 4
    with open(os.path.join(rc, "params.txt"), "w") as f:
        json.dump(rec, f)
    with pytest.raises(SystemExit, match="num_heads"):
        retclip_finetune.main(flags + ["--output_dir", str(tmp_path / "x")])
