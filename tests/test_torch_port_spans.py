"""The port's step records and spans (utils/profiling.py): the records and
their phases, the bounded deque, that nothing enters a range or adds an
autograd node while no profiler records, the ``octcube.*`` ranges in a
CPU ``torch.profiler`` trace, the serve handler's phases and the
training log's phase medians."""

import collections
import io
import json
import logging
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from octcubem_tpu_torch.cli import serve
from octcubem_tpu_torch.models import coem, mae3d
from octcubem_tpu_torch.models.vit_st import VisionTransformerST
from octcubem_tpu_torch.train import (clip_engine, finetune_engine, losses,
                                      mae_engine, optim)
from octcubem_tpu_torch.train.train_state import TrainState
from octcubem_tpu_torch.utils import logging as tlogging
from octcubem_tpu_torch.utils import profiling

MAE_KW = dict(input_size=32, patch_size=16, embed_dim=32, depth=2,
              num_heads=2, decoder_embed_dim=32, decoder_depth=1,
              decoder_num_heads=2, num_frames=6, t_patch_size=3,
              pred_t_dim=6, in_chans=1, high_res_input_size=64)
TRAIN_PHASES = {"forward", "backward", "update", "adamw"}


def _mae(kind):
    """A tiny MAE step of ``kind`` (plain, accum, joint) and its inputs."""
    model = mae3d.create_model(mae3d.MaskedAutoencoderViT3D, device="cpu",
                               seed=1, **MAE_KW)
    tx = optim.build_adamw(model, 1e-3, 0.05)
    state = TrainState.create(model, tx, seed=2)
    g = torch.Generator().manual_seed(0)
    accum = 2 if kind == "accum" else 1
    step = mae_engine.make_mae_train_step(model, tx, joint=kind == "joint",
                                          accum_iter=accum)
    x = torch.rand((2, 6, 32, 32, 1), generator=g)
    kw = {}
    if accum > 1:
        x = x.reshape(2, 1, 6, 32, 32, 1)
    if kind == "joint":
        kw["batch2d"] = torch.rand((2, 3, 64, 64, 1), generator=g)
    return lambda s: step(s, x, 0.9, **kw), state


def _clip(kind):
    vcfg = dict(num_frames=6, t_patch_size=3, img_size=32, patch_size=16,
                in_chans=1, embed_dim=32, depth=2, num_heads=2)
    ecfg = dict(img_size=32, patch_size=16, in_chans=3, embed_dim=32,
                depth=2, num_heads=2)
    model = coem.COEP2Tower(embed_dim=16, vision_cfg=vcfg, enface_cfg=ecfg)
    tx = optim.AdamW(model, 1e-3, 0.1)
    state = TrainState.create(model, tx, seed=0)
    g = torch.Generator().manual_seed(1)
    if kind == "clip_accum":
        step = clip_engine.make_clip_accum_train_step(model, tx, 2)
        lead = (2, 2)
    else:
        step = clip_engine.make_clip_train_step(model, tx)
        lead = (4,)
    b = {"image": torch.rand(lead + (6, 32, 32, 1), generator=g),
         "enface": torch.rand(lead + (32, 32, 3), generator=g)}
    return lambda s: step(s, b), state


def _finetune(kind):
    model = VisionTransformerST(
        num_frames=6, t_patch_size=3, img_size=32, patch_size=16, in_chans=1,
        num_classes=6, embed_dim=32, depth=2, num_heads=2,
        head_type="aggregate")
    tx = optim.AdamW(model, 1e-3, 0.05)
    state = TrainState.create(model, tx, 0)
    step = finetune_engine.make_finetune_train_step(
        model, tx, losses.make_criterion("multi_task_default"))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 6, 32, 32, 1),
                                             ).astype(np.float32))
    y = (rng.random((2, 4)) > 0.5).astype(np.float32)
    y[:, 0] = y[:, 1:].sum(1) == 0
    y = torch.from_numpy(y)
    return lambda s: step(s, x, y), state


STEPS = {"mae_plain": ("mae", _mae, "plain"),
         "mae_accum": ("mae", _mae, "accum"),
         "mae_joint": ("mae", _mae, "joint"),
         "clip_accum": ("clip", _clip, "clip_accum"),
         "clip_plain": ("clip", _clip, "clip_plain"),
         "finetune": ("finetune", _finetune, "finetune")}


def _count_ranges_and_nodes(monkeypatch) -> collections.Counter:
    """Count every range the facility opens and every node it adds."""
    seen = collections.Counter()
    real = profiling.record_function

    def counted(name, *a, **kw):
        seen["range"] += 1
        return real(name, *a, **kw)

    monkeypatch.setattr(profiling, "record_function", counted)
    for cls in (profiling._BackwardRange, profiling._AttnBwdOpen,
                profiling._AttnBwdClose):
        apply = cls.apply

        def wrapped(*a, _apply=apply, **kw):
            seen["node"] += 1
            return _apply(*a, **kw)
        monkeypatch.setattr(cls, "apply", wrapped)
    return seen


@pytest.mark.parametrize("name", list(STEPS))
def test_step_record_phases_and_no_spans_untraced(name, monkeypatch):
    """An engine's step leaves one record with exactly the forward,
    backward and update phases (AdamW's inside update), no reduce on one
    rank; with no profiler recording the step enters no range and adds no
    autograd node."""
    engine, make, kind = STEPS[name]
    call, state = make(kind)
    seen = _count_ranges_and_nodes(monkeypatch)
    before = profiling.last_seq()
    state, m = call(state)
    recs = profiling.records_since(before)
    assert len(recs) == 1
    rec = recs[0]
    assert rec["engine"] == engine and not rec["profiled"]
    # a joint step's 2D forward is its own phase inside forward
    assert set(rec["phases"]) == TRAIN_PHASES | (
        {"branch2d"} if name == "mae_joint" else set())
    assert all(v > 0 for v in rec["phases"].values())
    assert rec["phases"]["adamw"] <= rec["phases"]["update"]
    assert sum(rec["phases"][k] for k in ("forward", "backward", "update")
               ) <= rec["seconds"]
    assert seen == collections.Counter()
    assert "attn_fwd" not in rec and "attn_bwd" not in rec


@pytest.mark.parametrize("name", list(STEPS))
def test_step_records_carry_the_path(name):
    """Every engine's record says how the step ran: ``eager`` on the CPU,
    where no step replays a captured graph (train/step_graph.py)."""
    engine, make, kind = STEPS[name]
    call, state = make(kind)
    before = profiling.last_seq()
    call(state)
    recs = profiling.records_since(before)
    assert [(r["engine"], r["path"]) for r in recs] == [(engine, "eager")]
    assert "pool_bytes" not in recs[0]


def test_records_nest_and_the_deque_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "RECORDS", collections.deque(maxlen=3))
    with profiling.phase("forward"):   # no open step: nothing kept
        pass
    assert not profiling.RECORDS
    for i in range(5):
        with profiling.step("outer") as rec:
            with profiling.phase("update"):
                with profiling.phase("adamw"):
                    time.sleep(0.002)
                with profiling.step("inner"):
                    with profiling.phase("forward"):
                        pass
            with profiling.phase("update", on=False):
                pass
    recs = list(profiling.RECORDS)
    assert len(recs) == 3 and recs[-1] is rec
    assert [r["engine"] for r in recs] == ["outer", "inner", "outer"]
    assert set(rec["phases"]) == {"update", "adamw"}
    assert rec["phases"]["update"] >= rec["phases"]["adamw"] >= 0.002
    assert [r["seq"] for r in recs] == list(range(recs[0]["seq"],
                                                  recs[0]["seq"] + 3))
    assert profiling.records_since(recs[1]["seq"]) == [rec]
    with pytest.raises(RuntimeError):
        with profiling.step("failed"):
            raise RuntimeError
    assert profiling.RECORDS[-1] is rec
    assert profiling.RECORDS.maxlen == 3
    assert profiling.MAX_RECORDS == 4096


def _ranges(events, name):
    return [(e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
            if e.get("cat") == "user_annotation" and e["name"] == name]


def _mae_step(joint, premask):
    """A tiny MAE step at a 3D grid of 6 x 6 patches (3 border rows each
    side: the pre-mask's top-up does the work) and its inputs."""
    kw = dict(MAE_KW, input_size=96, high_res_input_size=128)
    model = mae3d.create_model(mae3d.MaskedAutoencoderViT3D, device="cpu",
                               seed=1, **kw)
    tx = optim.build_adamw(model, 1e-3, 0.05)
    state = TrainState.create(model, tx, seed=2)
    step = mae_engine.make_mae_train_step(model, tx, joint=joint,
                                          use_premask=premask)
    g = torch.Generator().manual_seed(0)
    x = torch.rand((1, 6, 96, 96, 1), generator=g)
    b2 = torch.rand((2, 3, 128, 128, 1), generator=g) if joint else None
    return lambda s: step(s, x, 0.9, batch2d=b2), state


SUBPHASES = [(False, False, set()), (False, True, {"premask"}),
             (True, False, {"branch2d"}), (True, True, {"premask", "branch2d"})]


@pytest.mark.parametrize("joint,premask,extra", SUBPHASES,
                         ids=["3d", "3d_premask", "joint", "joint_premask"])
def test_premask_and_branch2d_phases_nest_in_forward(joint, premask, extra):
    """The pre-mask (computed in the step) and each 2D forward of a joint
    step are phases of their own, their host time inside the forward's;
    a 3D-only step without the pre-mask records neither."""
    call, state = _mae_step(joint, premask)
    before = profiling.last_seq()
    call(state)
    (rec,) = profiling.records_since(before)
    ph = rec["phases"]
    assert set(ph) == TRAIN_PHASES | extra
    assert all(ph[k] > 0 for k in extra)
    assert sum(ph[k] for k in extra) <= ph["forward"]
    assert ph["forward"] + ph["backward"] + ph["update"] <= rec["seconds"]


@pytest.mark.parametrize("joint,premask,extra", SUBPHASES,
                         ids=["3d", "3d_premask", "joint", "joint_premask"])
def test_premask_and_branch2d_ranges_nest_in_forward(joint, premask, extra,
                                                     tmp_path):
    """Under a CPU profiler each of those phases is a range
    ``octcube.mae.premask`` / ``octcube.mae.branch2d`` inside an
    ``octcube.mae.forward`` range on the same thread, one per pre-mask
    and per 2D forward; the 2D forward's attention calls run inside
    ``branch2d``."""
    call, state = _mae_step(joint, premask)
    state, _ = call(state)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call(state)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    fwd = _ranges(events, "octcube.mae.forward")
    assert len(fwd) == 1 + joint
    for name in ("premask", "branch2d"):
        got = _ranges(events, f"octcube.mae.{name}")
        assert len(got) == (name in extra)
        for lo, hi, tid in got:
            assert any(a <= lo and hi <= b and t == tid for a, b, t in fwd)
    if joint:
        (lo, hi, tid), = _ranges(events, "octcube.mae.branch2d")
        inside = [a for a, b, t in _ranges(events, "octcube.attn.fwd")
                  if t == tid and lo <= a and b <= hi]
        assert len(inside) == 2 + 1     # the 2D encoder's and decoder's


@pytest.mark.parametrize("name", ["mae_plain", "clip_accum"])
def test_profiled_step_has_the_ranges(name, tmp_path):
    """Under a CPU profiler the trace holds the step's ranges, the
    attention op's (its backward range holding the attention backward's
    node), and the record counts each attention call's shape."""
    engine, make, kind = STEPS[name]
    call, state = make(kind)
    state, _ = call(state)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = call(state)
    rec = profiling.RECORDS[-1]
    assert rec["profiled"] and set(rec["phases"]) == TRAIN_PHASES
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    for ph in ("step", "forward", "backward", "update", "adamw"):
        assert _ranges(events, f"octcube.{engine}.{ph}"), ph
    if engine == "clip":
        (cached,) = _ranges(events, "octcube.clip.cached")
        fwd = _ranges(events, "octcube.clip.forward")
        assert any(a <= cached[0] and cached[1] <= b for a, b, _ in fwd)
        # two chunks, each re-forwarded and differentiated
        assert len(_ranges(events, "octcube.clip.backward")) == 2
    fwd = _ranges(events, "octcube.attn.fwd")
    bwd = _ranges(events, "octcube.attn.bwd")
    assert len(fwd) == len(rec["attn_fwd"]) and fwd
    assert len(bwd) == len(rec["attn_bwd"]) and bwd
    blocks = 2 * 2 if engine == "clip" else 2 + 1   # the towers / enc + dec
    assert len(rec["attn_bwd"]) == blocks * (2 if engine == "clip" else 1)
    b, h, n, d = rec["attn_fwd"][0]
    assert h == 2 and d == 16 and n >= 1
    lo, hi, tid = bwd[0]
    inside = {e["name"] for e in events if e.get("tid") == tid
              and lo <= e.get("ts", -1) <= hi}
    assert any("Flash" in n and n.endswith("Backward") for n in inside)
    got = profiling.range_device_ms(prof)
    assert f"octcube.{engine}.forward" in got    # no card: 0 ms
    # the profiler gone, nothing is entered again
    state, _ = call(state)
    assert not profiling.RECORDS[-1]["profiled"]
    assert "attn_fwd" not in profiling.RECORDS[-1]


def _served(predict, lock):
    meta = {"batch": 1, "num_frames": 6, "input_size": 32}
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(
        predict, meta, lambda v: v, lock))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return httpd, th


class _WatchedLock:
    """A lock that says when a request has started to wait for it."""

    def __init__(self):
        self.lock, self.waiting = threading.Lock(), threading.Event()

    def acquire(self):
        self.waiting.set()
        self.lock.acquire()

    def release(self):
        self.lock.release()


def _serve_lines(caplog):
    return [r.getMessage() for r in caplog.records
            if r.name == "octcubem_tpu_torch.serve"]


def test_serve_queue_ms_covers_the_lock_wait(caplog):
    """A request that waits 0.3 s on the lock reads it in ``queue_ms``;
    ``latency_ms`` stays queue plus predict; the server logs the
    request's phases."""
    lock = _WatchedLock()

    def predict(x):
        time.sleep(0.05)
        return np.zeros((1, 8), np.float32)

    httpd, th = _served(predict, lock)
    buf = io.BytesIO()
    np.save(buf, np.zeros((6, 32, 32), np.float32))
    url = f"http://127.0.0.1:{httpd.server_address[1]}/predict?raw=0"
    box = []

    def post():
        req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            box.append(json.loads(r.read().decode()))

    client = threading.Thread(target=post)
    try:
        with caplog.at_level(logging.INFO, "octcubem_tpu_torch.serve"):
            lock.lock.acquire()
            client.start()
            assert lock.waiting.wait(timeout=30)
            time.sleep(0.3)
            lock.lock.release()
            client.join(timeout=30)
            # the handler keeps its record and logs after it has answered
            deadline = time.monotonic() + 30
            while not _serve_lines(caplog) and time.monotonic() < deadline:
                time.sleep(0.01)
    finally:
        httpd.shutdown()
        th.join(timeout=30)
    assert not th.is_alive() and not client.is_alive()
    (out,) = box
    assert 300 <= out["queue_ms"] <= 5000
    assert 50 <= out["predict_ms"] < out["queue_ms"]
    assert out["latency_ms"] == pytest.approx(
        out["queue_ms"] + out["predict_ms"], abs=2.0)
    assert len(out["probs"][0]) == 4
    (line,) = _serve_lines(caplog)
    assert "200" in line
    for ph in serve.PHASES:
        assert f"{ph} " in line
    rec = profiling.RECORDS[-1]
    assert rec["engine"] == "serve" and set(rec["phases"]) == set(
        serve.PHASES)


def test_log_every_prints_the_interval_phase_medians():
    call, state = _mae("plain")
    lines = []
    meter = tlogging.MetricLogger()
    logger = type("L", (), {"info": staticmethod(lines.append)})
    for _ in meter.log_every(range(3), 2, "h", logger=logger):
        state, _ = call(state)
    # a line at steps 0 and 2 (the last), and the total
    assert len(lines) == 3
    for line in lines[:2]:
        assert all(f" {k}: " in line for k in ("forward", "backward",
                                              "update")), line
    lines.clear()
    for _ in meter.log_every(range(2), 1, "h", logger=logger):
        pass
    assert not any("forward" in line for line in lines)
