"""Port parity: the multi-process runtime on 2 gloo ranks, and the five
CLIs on 2 ranks against one rank fed the global batch.

Two CPU processes (spawn) join through ``core/multihost.maybe_initialize``
with ``WORLD_SIZE = 2`` in their environment (``env://`` on a free
localhost port, as ``torchrun`` sets it) and run every case once per
module; JAX is imported in the test process only.  Cases:

- ``global_batch`` / ``local_rows`` / ``put_tree`` round trips, the
  placements against JAX's shard shapes (``fsdp_param_spec`` on a
  (data 1, fsdp 2) mesh);
- ``all_reduce_mean``, ``gather_rows`` and ``GatherRows``' gradient;
- ``core/checkpoint``: rank 0 writes, both ranks restore bit for bit;
- ``cli/pretrain.py`` (``--tiny --synthetic``, data parallel),
  ``cli/finetune.py`` (``--tiny --synthetic``), ``cli/predict.py
  --n_data 2``, ``cli/retclip.py`` (the tiny test config) and
  ``cli/retclip_finetune.py --tiny``, each against the same CLI on one
  rank.  A rank's ``--batch_size`` is per rank (JAX's multi-host
  layout), so the one-rank run takes twice the batch, with its loaders'
  order patched to the global batches the two ranks assemble
  (``_global_order``); predict and retclip_finetune take a global batch
  in both packages, so their one-rank run is the same command.

Tolerances: logged losses 1e-5 relative; params after Adam at the CLIs'
eps 1e-8, where an entry whose gradient cancels to ~eps may flip sign:
each within 2 x the summed LR, at most 1e-3 of all entries off by more
than 1e-6 (test_torch_port_dp.py); predictions: the CSV's 4-decimal
rounding step plus the fp32 tolerance, 1.5e-4 (test_torch_port_predict.py).
TensorBoard is stubbed in the CLI runs (``_no_tensorboard``): its import
loads TensorFlow (~20 s a process); the runs log JSON lines.
"""

import csv
import datetime
import json
import os
import socket
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

WORLD = 2
JOIN_S = 300
TOL_LOSS = dict(rtol=1e-5, atol=1e-7)
TOL_CSV = 1.5e-4
CLI_LR = 1e-4
PREDICT_FLAGS = ["--batch_size", "2", "--num_frames", "6", "--input_size",
                 "32", "--nb_classes", "4", "--embed_dim", "64", "--depth",
                 "2", "--num_heads", "2", "--device", "cpu"]


def _no_tensorboard(monkeypatch):
    """TBWriter without a writer, as when TensorBoard cannot be imported
    (until ``monkeypatch`` is undone)."""
    from octcubem_tpu_torch.utils import logging as tlog

    class NoTB(tlog.TBWriter):
        def __init__(self, log_dir):
            self.writer = None

    monkeypatch.setattr(tlog, "TBWriter", NoTB)


def _global_order(world: int, chunks: int = 1):
    """A ``Loader._indices`` for one rank that serves the batches ``world``
    ranks assemble: each global batch is the ranks' local batches (of
    batch_size / world, their stride of the permutation) in rank order,
    chunk by chunk for a feature-cached accumulation of ``chunks``."""
    from octcubem_tpu_torch.data.loader import Loader

    plain = Loader._indices

    def _indices(self):
        idx = plain(self)
        if not self.shuffle:  # the eval loaders: every rank the whole split
            return idx
        per = [idx[r::world][:len(idx) // world] for r in range(world)]
        b = self.batch_size // world
        m = b // chunks
        out = [per[r][i * b + c * m:i * b + (c + 1) * m]
               for i in range(len(per[0]) // b) for c in range(chunks)
               for r in range(world)]
        return np.concatenate(out) if out else idx[:0]

    return _indices


def _pretrain_config(tmp, batch):
    from octcubem_tpu_torch.core.config import PRESETS
    import dataclasses

    cfg = dataclasses.asdict(PRESETS["vitl_joint_pretrain"])
    eff = 2 * WORLD
    cfg.update(epochs=1, warmup_epochs=0, batch_size=batch,
               batch_size_2d=batch, accum_2d=1, min_lr=CLI_LR,
               blr=CLI_LR * 256 / eff, precision="fp32")
    path = Path(tmp) / f"pretrain_{batch}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _finetune_config(tmp):
    from octcubem_tpu_torch.core.config import PRESETS
    import dataclasses

    cfg = dataclasses.asdict(PRESETS["octcube_multitask"])
    cfg.update(drop_path=0.0)  # the ranks' masks are not JAX's at rate > 0
    path = Path(tmp) / "finetune.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _cli_runs(tmp, data_tree, batch, out):
    """(name, main's module, argv) of each CLI case at a per-rank batch."""
    return [
        ("pretrain", "pretrain",
         ["--preset", _pretrain_config(tmp, batch), "--synthetic", "--tiny",
          "--synthetic_n", "8", "--steps_per_epoch", "2", "--device", "cpu",
          "--output_dir", f"{out}/pretrain"]),
        ("finetune", "finetune",
         ["--preset", _finetune_config(tmp), "--tiny", "--synthetic",
          "--synthetic_n", "24", "--epochs", "1", "--batch_size",
          str(batch), "--device", "cpu", "--output_dir", f"{out}/finetune"]),
        ("retclip", "retclip",
         ["--preset", str(Path(tmp) / "retclip.json"), "--model_config",
          "vitl16_octcube_ir_tiny_test", "--synthetic", "--synthetic_n",
          "20", "--batch_size", str(batch), "--epochs", "1", "--device",
          "cpu", "--output_dir", f"{out}/retclip"]),
        ("retclip_finetune", "retclip_finetune",
         ["--tiny", "--batch_size", "4", "--epochs", "1", "--k_folds", "2",
          "--device", "cpu", "--output_dir", f"{out}/retclip_finetune"]),
        ("predict", "predict",
         [data_tree, "--out_csv", f"{out}/predict.csv", "--dump_embeddings",
          f"{out}/predict.npz"] + PREDICT_FLAGS),
    ]


# ------------------------------------------------------------- the ranks

def _rank_main(rank, port, tmp, data_tree, out_dir):
    import importlib

    import torch.distributed as dist

    from octcubem_tpu_torch.core import checkpoint, multihost
    from octcubem_tpu_torch.core.mesh import (fsdp_param_spec, make_mesh)

    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(WORLD), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    _no_tensorboard(pytest.MonkeyPatch())
    info = multihost.maybe_initialize("cpu")
    try:
        res = {"info": np.array([info["process_index"],
                                 info["process_count"]])}
        mesh = make_mesh(device="cpu")
        local = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * rank
        g = multihost.global_batch(mesh, local)
        res["gb_shape"] = np.array(g.shape)
        res["gb_full"] = g.full_tensor().numpy()
        res["gb_local"] = multihost.local_rows(g)
        gm = multihost.global_batch(mesh, local[None], micro_axis=True)
        res["gbm_full"] = gm.full_tensor().numpy()
        fsdp = make_mesh(n_data=1, n_fsdp=WORLD, device="cpu")
        w = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (1024, 1536)).astype(np.float32))
        tree = multihost.put_tree(fsdp, {"blk": {"weight": w,
                                                 "bias": w[0]}},
                                  fsdp_param_spec)
        res["pt_local_shape"] = np.array(tree["blk"]["weight"].to_local()
                                         .shape)
        res["pt_full_equal"] = np.array(bool(torch.equal(
            tree["blk"]["weight"].full_tensor(), w)))
        res["pt_bias_shape"] = np.array(tree["blk"]["bias"].to_local().shape)

        # collectives
        t = torch.tensor([1.0, 2.0]) * (rank + 1)
        res["mean"] = multihost.all_reduce_mean([t, None, t[:1]])[0].numpy()
        x = torch.full((2, 3), float(rank), requires_grad=True)
        gathered = multihost.gather_rows_with_grad(x)
        (gathered * torch.arange(4.0)[:, None]).sum().backward()
        res["gather"] = gathered.detach().numpy()
        res["gather_grad"] = x.grad.numpy()

        # checkpoints: rank 0 writes, both restore
        ck = Path(tmp) / "ckpt"
        state = {"w": torch.full((4,), 3.0 + rank), "step": 1}
        checkpoint.save_checkpoint(str(ck), 1, state, {"epoch": 1},
                                   async_save=True)
        res["ckpt_latest"] = np.array(checkpoint.latest_step(str(ck)))
        res["ckpt_files"] = np.array(sorted(os.listdir(ck)))
        raw, extra, step = checkpoint.restore_checkpoint(str(ck), None)
        res["ckpt_w"] = raw["w"].numpy()
        res["ckpt_step"] = np.array([step, extra["epoch"]])
        checkpoint.save_checkpoint(str(ck), 2, state)
        res["ckpt_deleted"] = np.array(checkpoint.delete_recent_checkpoints(
            str(ck), 1))
        res["ckpt_left"] = np.array(checkpoint.latest_step(str(ck)))
        dist.barrier()

        for name, mod, argv in _cli_runs(tmp, data_tree, 2, out_dir):
            main = importlib.import_module(f"octcubem_tpu_torch.cli.{mod}")
            argv = list(argv)
            if name == "predict":
                argv += ["--n_data", str(WORLD)]
                if rank:  # only rank 0 writes the outputs
                    argv[argv.index("--out_csv") + 1] = f"{out_dir}/r1.csv"
                res["predict_rows"] = np.array(main.main(argv))
            else:
                main.main(argv)
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        multihost.shutdown()


# ----------------------------------------------------- the test process

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _volumes(root):
    rng = np.random.default_rng(5)
    for p in range(5):  # 5 volumes: a tail global batch of one
        d = root / f"p{p}" / "v0"
        d.mkdir(parents=True)
        np.save(d / "vol.npy", (rng.random((6, 40, 40)) * 255).astype(
            np.float32))
    return str(root)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on 2 ranks, then the one-rank CLI runs -> (the ranks'
    results, the ranks' output dir, the one-rank output dir)."""
    tmp = tmp_path_factory.mktemp("gloo_mh")
    (tmp / "retclip.json").write_text(json.dumps({"accum_freq": 2}))
    tree = _volumes(tmp / "data")
    out2, out1 = tmp / "two", tmp / "one"
    out2.mkdir()
    out1.mkdir()
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, port, str(tmp), tree, str(out2)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=JOIN_S)
    for p in procs:
        p.join(max(1.0, (deadline - datetime.datetime.now()).total_seconds()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} did not finish within {JOIN_S} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * WORLD, f"rank exit codes {codes}"

    import importlib

    from octcubem_tpu_torch.data.loader import Loader

    mp_, tb = pytest.MonkeyPatch(), pytest.MonkeyPatch()
    _no_tensorboard(tb)
    try:
        for name, mod, argv in _cli_runs(str(tmp), tree, 2 * WORLD,
                                         str(out1)):
            chunks = 2 if name == "retclip" else 1
            if name in ("pretrain", "finetune", "retclip"):
                mp_.setattr(Loader, "_indices", _global_order(WORLD, chunks))
            if name == "predict":
                argv = list(argv)
                argv[argv.index("--batch_size") + 1] = "2"
            importlib.import_module(f"octcubem_tpu_torch.cli.{mod}").main(
                argv)
            mp_.undo()
    finally:
        mp_.undo()
        tb.undo()
    return [dict(np.load(out2 / f"rank{r}.npz")) for r in range(WORLD)], \
        out2, out1


def test_maybe_initialize_forms_the_group(ranks):
    results, _, _ = ranks
    for r, res in enumerate(results):
        assert res["info"].tolist() == [r, WORLD]


def test_global_batch_and_put_tree_round_trip(ranks):
    """global_batch's global view is the ranks' rows in rank order (dim 1
    with micro_axis) and local_rows gives back the rank's; put_tree's
    fsdp placement keeps each rank the chunk JAX's NamedSharding gives a
    device (on the JAX layout, [in, out]: the 1536-wide input dim) and
    replicates the bias."""
    import jax
    from jax.sharding import Mesh, NamedSharding

    from octcubem_tpu.core.mesh import fsdp_param_spec as jspec

    results, _, _ = ranks
    full = np.concatenate([np.arange(6, dtype=np.float32).reshape(3, 2)
                           + 10 * r for r in range(WORLD)])
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(1, WORLD),
                ("data", "fsdp"))
    flax = jax.ShapeDtypeStruct((1536, 1024), np.float32)
    jshape = NamedSharding(mesh, jspec((), flax)).shard_shape(flax.shape)
    for r, res in enumerate(results):
        assert res["gb_shape"].tolist() == [6, 2]
        np.testing.assert_array_equal(res["gb_full"], full)
        np.testing.assert_array_equal(res["gb_local"], full[3 * r:3 * r + 3])
        np.testing.assert_array_equal(res["gbm_full"], full[None])
        assert tuple(res["pt_local_shape"]) == tuple(jshape)[::-1]
        assert bool(res["pt_full_equal"])
        assert res["pt_bias_shape"].tolist() == [1536]


def test_collectives(ranks):
    """all_reduce_mean is the mean over ranks; gather_rows concatenates in
    rank order; GatherRows hands each rank the gradient of its rows
    summed over the ranks' (identical) losses."""
    results, _, _ = ranks
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res["mean"], [1.5, 3.0])
        np.testing.assert_array_equal(res["gather"][:, 0], [0, 0, 1, 1])
        want = WORLD * np.arange(4.0)[2 * r:2 * r + 2, None] * np.ones((2, 3))
        np.testing.assert_array_equal(res["gather_grad"], want)


def test_checkpoints_on_two_ranks(ranks):
    """Rank 0's state is written once; both ranks read it back after the
    save's barrier, and the deletion is seen by both."""
    results, _, _ = ranks
    for res in results:
        assert int(res["ckpt_latest"]) == 1
        assert res["ckpt_files"].tolist() == ["1"]
        np.testing.assert_array_equal(res["ckpt_w"], np.full(4, 3.0))
        assert res["ckpt_step"].tolist() == [1, 1]
        assert res["ckpt_deleted"].tolist() == [2]
        assert int(res["ckpt_left"]) == 1


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _assert_adam_close(got: dict, want: dict, lr_sum: float):
    """Each entry within 2 x the summed LR, at most 1e-3 of all entries
    off by more than 1e-6 (the module docstring)."""
    assert set(got) == set(want)
    off = total = 0
    for k in want:
        a, b = got[k].float().numpy(), want[k].float().numpy()
        d = np.abs(a - b)
        assert d.max() <= 2 * lr_sum + 1e-6, (k, d.max())
        off += int((d > 1e-6).sum())
        total += d.size
    assert off <= 1e-3 * total, (off, total)


def test_pretrain_cli_two_ranks_equal_one(ranks):
    from octcubem_tpu_torch.core import checkpoint

    _, two, one = ranks
    got, want = (_records(d / "pretrain" / "log.txt") for d in (two, one))
    np.testing.assert_allclose(got[0]["train_loss"], want[0]["train_loss"],
                               **TOL_LOSS)
    assert got[0]["lr"] == pytest.approx(want[0]["lr"], rel=1e-12)
    a, b = (checkpoint.restore_raw(str(d / "pretrain" / "ckpt"))[0]["params"]
            for d in (two, one))
    _assert_adam_close(a, b, 2 * CLI_LR)


def test_finetune_cli_two_ranks_equal_one(ranks):
    _, two, one = ranks
    got, want = (_records(d / "finetune" / "log.txt") for d in (two, one))
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got[0]["train_loss"], want[0]["train_loss"],
                               **TOL_LOSS)
    assert got[0]["val_auc"] == pytest.approx(want[0]["val_auc"], abs=1e-6)


def test_retclip_cli_two_ranks_equal_one(ranks):
    """Two steps of 2 x accum 2 pairs a rank (the bank holds both ranks'
    chunks) against 4 x accum 2 on one rank; the held-out retrieval
    metrics after them, and the saved params."""
    from octcubem_tpu_torch.core import checkpoint

    _, two, one = ranks
    got, want = (_records(d / "retclip" / "results.jsonl") for d in (two, one))
    assert got[0].keys() == want[0].keys()
    for k, v in want[0].items():
        assert got[0][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
    a, b = (checkpoint.restore_raw(str(d / "retclip" / "ckpt"))[0]["params"]
            for d in (two, one))
    _assert_adam_close(a, b, 2 * 1e-4)


def test_retclip_finetune_cli_two_ranks_equal_one(ranks):
    _, two, one = ranks
    got, want = (_records(d / "retclip_finetune" / "results.jsonl")
                 for d in (two, one))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["train_loss"], w["train_loss"],
                                   **TOL_LOSS)
        assert g["val_auc_ovr"] == pytest.approx(w["val_auc_ovr"], abs=1e-6)


def test_predict_cli_two_ranks_equal_one(ranks):
    """--n_data 2: each rank predicts one row of every global batch of 2
    (the tail batch's one volume on rank 0); rank 0's CSV and embeddings
    are in the volumes' order and equal the one-rank run's; every rank
    returns the rows."""
    results, two, one = ranks
    with open(two / "predict.csv") as f:
        got = list(csv.reader(f))
    with open(one / "predict.csv") as f:
        want = list(csv.reader(f))
    assert not (two / "r1.csv").exists()
    assert [r[0] for r in got] == [r[0] for r in want] and len(got) == 6
    np.testing.assert_allclose(np.asarray([r[1:] for r in got[1:]], float),
                               np.asarray([r[1:] for r in want[1:]], float),
                               atol=TOL_CSV, rtol=0)
    np.testing.assert_allclose(np.load(two / "predict.npz")["embeddings"],
                               np.load(one / "predict.npz")["embeddings"],
                               atol=1e-5, rtol=1e-5)
    for res in results:
        assert res["predict_rows"].tolist() == got[1:]
