"""The port's pretraining CLI on the CPU (``--device cpu``, tiny models):
the counterparts of the JAX package's CLI smokes (tests/test_cli_smoke.py),
every resume type and both refusals, the first step against the engine's
step, the export read back by the JAX package's importer, and the val
transform that serving and inference now take."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from octcubem_tpu.cli import infer as jinfer
from octcubem_tpu.compat.torch_import import (import_state_dict as
                                              jimport_state_dict,
                                              load_torch_checkpoint as jload)
from octcubem_tpu.data.transforms import create_3d_transforms as jcreate
from octcubem_tpu.models import mae3d as jmae3d
from octcubem_tpu_torch.cli import export, infer, pretrain, serve
from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax
from octcubem_tpu_torch.core import checkpoint as ckpt_lib
from octcubem_tpu_torch.data import loader as loader_lib, spl as spl_lib
from octcubem_tpu_torch.models import mae3d
from octcubem_tpu_torch.train import mae_engine, optim
from octcubem_tpu_torch.train.train_state import TrainState

TINY = dict(input_size=32, high_res_input_size=64, embed_dim=64, depth=2,
            num_heads=2, decoder_embed_dim=32, decoder_depth=1,
            decoder_num_heads=2, num_frames=6, t_patch_size=3, pred_t_dim=6)


def _run(out, *flags):
    return pretrain.main(["--synthetic", "--tiny", "--device", "cpu",
                          "--output_dir", str(out), *flags])


def _records(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture
def first_step_states(monkeypatch):
    """Copies of the state each CLI run's step function first sees, and
    every step's keyword arguments."""
    seen, calls = [], []
    orig = mae_engine.make_mae_train_step

    def make(*a, **k):
        step = orig(*a, **k)
        first = [True]

        def wrapped(state, *args, **kw):
            if first[0]:
                seen.append({"step": state.step,
                             "params": {n: t.clone() for n, t in
                                        state.params.state_dict().items()},
                             "count": int(state.tx.count),
                             "mu": [m.clone() for m in state.tx.mu],
                             "nu": [m.clone() for m in state.tx.nu],
                             "generator": state.generator.get_state()})
                first[0] = False
            calls.append(kw)
            return step(state, *args, **kw)

        return wrapped

    monkeypatch.setattr(mae_engine, "make_mae_train_step", make)
    return seen, calls


def _matches(snapshot, state):
    params = state.params.state_dict()
    return (snapshot["step"] == state.step
            and snapshot["count"] == state.tx.count
            and all(torch.equal(snapshot["params"][k], params[k])
                    for k in params)
            and all(torch.equal(u, v) for u, v in
                    zip(snapshot["mu"] + snapshot["nu"],
                        state.tx.mu + state.tx.nu))
            and torch.equal(snapshot["generator"], state.generator.get_state()))


def test_pretrain_cli_smoke(tmp_path):
    out = tmp_path / "pt"
    state = _run(out, "--synthetic_n", "32", "--epochs", "1",
                 "--batch_size", "8", "--steps_per_epoch", "4",
                 "--profile_steps", "1")
    assert state.step == 4
    for f in ("log.txt", "all_image_dict-0.pkl", "args.json", "out.log"):
        assert (out / f).is_file(), f
    assert (out / "ckpt" / "0" / "state.pt").is_file()
    assert ckpt_lib.latest_step(str(out / "ckpt")) == 0
    [rec] = _records(out)
    assert set(rec) == {"epoch", "train_loss", "lr", "epoch_time_s",
                        "spl_k", "mask_ratio_2d"}
    assert rec["epoch"] == 0 and np.isfinite(rec["train_loss"])
    # --profile_steps wrote a torch.profiler trace of the window
    with open(out / "profile" / "trace.json") as f:
        trace = json.load(f)
    assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])
    cfg = json.loads((out / "args.json").read_text())
    assert cfg["accum_2d"] == 4 and cfg["output_dir"] == str(out)


def test_profile_window():
    assert pretrain.profile_window(4, 1) == 2  # the JAX CLI's window
    assert pretrain.profile_window(10, 3) == 2
    assert pretrain.profile_window(2, 1) == 1
    assert pretrain.profile_window(1, 1) == 0


def test_pretrain_cli_2d_mode_smoke(tmp_path):
    out = tmp_path / "pt2d"
    state = pretrain.main(["--mode", "2d", "--synthetic", "--tiny",
                           "--device", "cpu", "--epochs", "1",
                           "--batch_size", "8", "--output_dir", str(out)])
    assert state.step == 4  # 32 images, batch 8
    assert (out / "log.txt").is_file()
    with open(out / "all_image_dict-0.pkl", "rb") as f:
        hard = pickle.load(f)
    assert len(hard) == 32 and all(v["visited"] == 1 for v in hard.values())
    assert ckpt_lib.latest_step(str(out / "ckpt")) == 0


def _write_png(path, rng, size=40):
    arr = (rng.random((size, size)) * 255).astype(np.uint8)
    Image.fromarray(arr, mode="L").save(path)


def test_pretrain_cli_real_joint_data(tmp_path):
    """The JAX smoke's fixture: 8 patients x 6 PNG frames and a Kermany
    folder; the SPL dict is keyed by frame paths and written back from
    the 3D batch's frame losses."""
    rng = np.random.default_rng(0)
    data = tmp_path / "data"
    for p in range(8):
        d = data / f"p{p}" / "v0"
        d.mkdir(parents=True)
        for t in range(6):
            _write_png(str(d / f"oct_{t:03d}.png"), rng)
    kermany = tmp_path / "kermany"
    for cls in ("NORMAL", "CNV"):
        d = kermany / cls
        d.mkdir(parents=True)
        for i in range(3):
            _write_png(str(d / f"k{i}.png"), rng)
    out = tmp_path / "pt"
    pretrain.main(["--data_dir", str(data), "--kermany_dir", str(kermany),
                   "--tiny", "--device", "cpu", "--epochs", "2",
                   "--batch_size", "8", "--output_dir", str(out)])
    with open(out / "all_image_dict-1.pkl", "rb") as f:
        hard = pickle.load(f)
    assert len(hard) == 54  # 8 visits x 6 frames + 6 Kermany images
    assert any("kermany" in k for k in hard)
    visited = [k for k, v in hard.items() if v["visited"] > 0]
    assert visited and all(str(data) in k for k in visited)
    assert all(hard[k]["hardness"] > 0 for k in visited)


def test_resume_latest_restores_the_state(tmp_path, first_step_states):
    seen, calls = first_step_states
    out = tmp_path / "a"
    state_a = _run(out, "--epochs", "1", "--batch_size", "8",
                   "--steps_per_epoch", "1")
    state_b = _run(out, "--epochs", "3", "--batch_size", "8",
                   "--steps_per_epoch", "1", "--resume", "latest")
    # run B's first step saw run A's final state, bit for bit
    assert len(seen) == 2 and _matches(seen[1], state_a)
    assert state_b.step == 3
    assert [r["epoch"] for r in _records(out)] == [0, 1, 2]
    assert [c["mask_ratio_2d"] for c in calls] == [0.75, 0.75, 0.8]
    log = (out / "out.log").read_text()
    assert "resumed from" in log and "all_image_dict-0.pkl" in log
    assert sorted(os.listdir(out / "ckpt")) == ["0", "1", "2"]
    # --resume <run dir> and <run dir>/ckpt resume into another run
    for i, src in enumerate((out, out / "ckpt")):
        other = tmp_path / f"c{i}"
        state_c = _run(other, "--epochs", "4", "--batch_size", "8",
                       "--resume", str(src))
        assert len(seen) == 3 + i and _matches(seen[-1], state_b)
        assert state_c.step == 4
    with pytest.raises(SystemExit, match="no checkpoints"):
        _run(tmp_path / "d", "--epochs", "1", "--resume",
             str(tmp_path / "nowhere"))


def test_reset_optim_continues_params(tmp_path):
    out_a = tmp_path / "a"
    state_a = _run(out_a, "--epochs", "1", "--batch_size", "8",
                   "--steps_per_epoch", "1")
    state_a = {k: v.clone() for k, v in state_a.params.state_dict().items()}
    for extra in ((), ("--load_spl_dir", str(out_a), "--epoch_load_spl", "0"),
                  ("--opt_chain",)):
        out_b = tmp_path / f"b{len(extra)}"
        state_b = _run(out_b, "--epochs", "0", "--batch_size", "8",
                       "--resume", str(out_a), "--resume_type",
                       "training_continue_reset_optim", *extra)
        pb = state_b.params.state_dict()
        assert all(torch.equal(state_a[k], pb[k]) for k in pb)
        assert state_b.step == 0 and state_b.tx.count == 0
        assert all(not m.any() for m in state_b.tx.mu + state_b.tx.nu)
        assert ("SPL dict reloaded" in (out_b / "out.log").read_text()) == (
            "--load_spl_dir" in extra)
    assert json.loads((tmp_path / "b1" / "args.json").read_text())[
        "opt_chain"] is True
    with pytest.raises(SystemExit, match="requires --resume"):
        _run(tmp_path / "c", "--epochs", "0", "--resume_type",
             "training_continue_reset_optim")


def test_geometry_mismatch_refused_before_args_json(tmp_path):
    out = tmp_path / "a"
    _run(out, "--epochs", "1", "--batch_size", "8", "--steps_per_epoch", "1")
    before = (out / "args.json").read_text()
    with pytest.raises(SystemExit, match="geometry mismatch"):
        _run(out, "--epochs", "2", "--resume", "latest", "--num_heads", "8")
    with pytest.raises(SystemExit, match="decoder_num_heads"):
        _run(tmp_path / "b", "--epochs", "2", "--resume", str(out / "ckpt"),
             "--decoder_num_heads", "4")
    assert (out / "args.json").read_text() == before


def _imagenet_ft_ckpt(path, d=64, p=16, hid=256):
    """The JAX smoke's supervised timm-style 2D checkpoint (fused qkv,
    final norm, a 1000-class head and pre_logits)."""
    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype("f4"))

    sd = {"cls_token": t(1, 1, d), "pos_embed": t(1, 197, d),
          "patch_embed.proj.weight": t(d, 1, p, p),
          "patch_embed.proj.bias": t(d),
          "norm.weight": t(d), "norm.bias": t(d),
          "head.weight": t(1000, d), "head.bias": t(1000),
          "pre_logits.fc.weight": t(d, d)}
    for i in range(2):
        sd.update({
            f"blocks.{i}.norm1.weight": t(d), f"blocks.{i}.norm1.bias": t(d),
            f"blocks.{i}.attn.qkv.weight": t(3 * d, d),
            f"blocks.{i}.attn.qkv.bias": t(3 * d),
            f"blocks.{i}.attn.proj.weight": t(d, d),
            f"blocks.{i}.attn.proj.bias": t(d),
            f"blocks.{i}.norm2.weight": t(d), f"blocks.{i}.norm2.bias": t(d),
            f"blocks.{i}.mlp.fc1.weight": t(hid, d),
            f"blocks.{i}.mlp.fc1.bias": t(hid),
            f"blocks.{i}.mlp.fc2.weight": t(d, hid),
            f"blocks.{i}.mlp.fc2.bias": t(d)})
    torch.save({"model": sd}, path)
    return sd


@pytest.mark.parametrize("resume_type", ["imagenet_ft", "imagenet_mae",
                                         "retfound_2_flash_attn"])
def test_init_ckpt_2d_types(tmp_path, resume_type):
    ckpt = str(tmp_path / "2d.pth")
    sd = _imagenet_ft_ckpt(ckpt)
    if resume_type != "imagenet_ft":
        for k in ("head.weight", "head.bias", "pre_logits.fc.weight"):
            sd.pop(k)
        torch.save({"model": sd}, ckpt)
    state = _run(tmp_path / "c", "--epochs", "0", "--init_ckpt", ckpt,
                 "--resume_type", resume_type)
    p = state.params.state_dict()
    # the conv kernel inflated over t and divided by t_patch (3)
    want = np.repeat(sd["patch_embed.proj.weight"].numpy()[:, :, None], 3,
                     axis=2) / 3
    np.testing.assert_allclose(p["patch_embed.proj.weight"].numpy(), want,
                               atol=1e-6)
    np.testing.assert_allclose(p["high_res_patch_embed.proj.weight"].numpy(),
                               want, atol=1e-6)
    np.testing.assert_array_equal(p["blocks.0.mixer.Wqkv.weight"].numpy(),
                                  sd["blocks.0.attn.qkv.weight"].numpy())


def test_flash_init_ckpt_and_export_round_trip_through_jax(tmp_path):
    """cli/export on a port run; the .pth reloads through the JAX
    package's importer strictly, equal to the port's params; and the port
    initialises a new run from it (training_new with --init_ckpt)."""
    out = tmp_path / "pt"
    state = _run(out, "--epochs", "1", "--batch_size", "8",
                 "--steps_per_epoch", "1")
    pth = str(tmp_path / "export.pth")
    export.main(["--ckpt", str(out), "--out", pth])
    raw, _ = ckpt_lib.restore_raw(str(out / "ckpt"))
    trained = raw["params"]

    jm = jmae3d.MaskedAutoencoderViT3D(**TINY, attn_impl="naive")
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "masking": jax.random.key(0)},
        jnp.zeros((1, 6, 32, 32, 1)), mask_ratio=0.9))
    template = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    back, rep = jimport_state_dict(template, jload(pth), strict=True)
    assert rep["missing"] == [] and rep["unexpected"] == [], rep
    got = state_dict_from_jax(back)
    assert set(got) == set(trained)
    for k in trained:
        torch.testing.assert_close(got[k], trained[k], rtol=0, atol=0,
                                   msg=k)
    payload = torch.load(pth, map_location="cpu", weights_only=False)
    assert payload["octcubem_tpu_geometry"]["num_heads"] == 16

    init = _run(tmp_path / "init", "--epochs", "0", "--init_ckpt", pth)
    p = init.params.state_dict()
    live = state.params.state_dict()
    assert all(torch.equal(p[k], live[k]) for k in live)


def test_eval_only_writes_its_reconstruction_dump(tmp_path):
    out = tmp_path / "ev"
    assert _run(out, "--eval_only", "--batch_size", "4") is None
    assert (out / "recon_eval.png").is_file()
    [rec] = _records(out)
    assert set(rec) == {"eval_loss"} and np.isfinite(rec["eval_loss"])


def test_first_step_loss_equals_the_engine_step(tmp_path):
    """The CLI's epoch-0 loss after one step is the loss of one
    make_mae_train_step step on the loader's first batch, built with the
    CLI's seeds (model seed 0, generator seed 1), exactly."""
    out = tmp_path / "pt"
    _run(out, "--epochs", "1", "--steps_per_epoch", "1", "--batch_size", "4")
    [rec] = _records(out)

    model = mae3d.create_model(mae3d.MaskedAutoencoderViT3D, device="cpu",
                               seed=0, dtype=torch.bfloat16, **TINY)
    tx = optim.build_adamw(model, 0.0, 0.05)
    state = TrainState.create(model, tx, seed=1)
    # --synthetic_n 8: 8 volumes of 6x32x32, 32 2D images of 3x64x64; the
    # 2D batch is sized for K_min 0.3 of 32 (9), cut to accum_2d 4 x 2
    ds2d = pretrain.SyntheticOCT2D(32, 3, 64)
    ds3d = pretrain.SyntheticOCT3D(8, 6, 32, n_names=32)
    ld3 = loader_lib.Loader(ds3d, 4, num_workers=4)
    ld3.set_epoch(0)
    vols, _, _ = next(iter(ld3))
    ld2 = loader_lib.Loader(spl_lib.SPLState(ds2d.names).subset(ds2d), 8,
                            num_workers=2)
    imgs2d, _ = next(loader_lib.cycle(ld2))
    step = mae_engine.make_mae_train_step(model, tx, joint=True,
                                          use_premask=True, accum_2d=4)
    x2 = torch.from_numpy(imgs2d).reshape(4, 2, 3, 64, 64, 1)
    _, metrics = step(state, torch.from_numpy(vols), mask_ratio=0.9,
                      batch2d=x2, mask_ratio_2d=0.75)
    assert float(metrics["loss"]) == rec["train_loss"]


def test_refusals(monkeypatch, tmp_path):
    # the sp4 preset's mesh needs 4 ranks (its 4-rank run:
    # test_torch_port_dp.py), as JAX's needs 4 devices
    with pytest.raises(ValueError, match="4 devices, have 1"):
        _run(tmp_path / "sp", "--preset", "vitl_joint_pretrain_sp4")
    assert not (tmp_path / "sp").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pretrain.main(["--synthetic", "--tiny", "--output_dir",
                       str(tmp_path / "nocard")])
    assert not (tmp_path / "nocard").exists()


def test_serve_and_infer_take_the_val_transform(tmp_path, monkeypatch):
    """Serving and inference preprocess with the val transform
    (create_3d_transforms(...)[1]), equal to the JAX package's, even on a
    volume whose blank border a train transform would crop."""
    vol = (np.random.default_rng(4).random((9, 40, 44)) * 255).astype(
        np.float32)
    vol[:, :10] = 0
    _, jval = jcreate(32, 6, RandFlipd_prob=0)
    ref = jval(vol)
    captured = []
    orig = serve.make_handler

    def spy(predict, meta, val_transform, lock):
        captured.append(val_transform)
        return orig(predict, meta, val_transform, lock)

    class Stop(Exception):
        pass

    def stop(*a, **k):
        raise Stop

    monkeypatch.setattr(serve, "make_handler", spy)
    monkeypatch.setattr(serve, "ThreadingHTTPServer", stop)
    with pytest.raises(Stop):
        serve.main(["--port", "0", "--device", "cpu", "--embed_dim", "32",
                    "--depth", "1", "--num_heads", "2", "--num_frames", "6",
                    "--input_size", "32", "--nb_classes", "4"])
    [val_t] = captured
    assert not val_t.train
    for seed in range(3):
        np.testing.assert_array_equal(
            val_t(vol, rng=np.random.default_rng(seed)), ref)
    path = str(tmp_path / "vol.npy")
    np.save(path, vol)
    np.testing.assert_array_equal(infer.process_volume(path, 6, 32),
                                  jinfer.process_volume(path, 6, 32))
    np.testing.assert_array_equal(infer.process_volume(path, 6, 32),
                                  (ref / 255.0)[None, ..., None])
