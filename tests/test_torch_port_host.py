"""The port's config, runtime, one-rank process summary, logging and
profiling helpers against the JAX package's, on the CPU."""

import dataclasses
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from octcubem_tpu.core import config as jconfig
from octcubem_tpu.models import mae3d as jmae3d
from octcubem_tpu.utils import logging as jlogging
from octcubem_tpu.utils import profiling as jprofiling
from octcubem_tpu_torch.cli import pretrain as tpretrain
from octcubem_tpu_torch.core import config as tconfig
from octcubem_tpu_torch.core import multihost, runtime
from octcubem_tpu_torch.models import mae3d as tmae3d
from octcubem_tpu_torch.utils import logging as tlogging
from octcubem_tpu_torch.utils import profiling as tprofiling


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_presets_equal_jax(name):
    assert name in tconfig.PRESETS
    t, j = tconfig.PRESETS[name], jconfig.PRESETS[name]
    assert type(t).__name__ == type(j).__name__
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tconfig.to_json(t) == jconfig.to_json(j)
    assert set(tconfig.PRESETS) == set(jconfig.PRESETS)


def test_joint_preset_keeps_accum_2d():
    cfg = tconfig.load_config(tconfig.MAEPretrainConfig, "vitl_joint_pretrain")
    assert (cfg.accum_2d, cfg.batch_size_2d, cfg.mask_ratio) == (4, 64, 0.9)


def test_load_config_and_to_json_equal_jax(tmp_path):
    over = dict(epochs=3, batch_size=4, num_heads=8, opt_chain=True,
                output_dir="out")
    for cls in ("MAEPretrainConfig", "FinetuneConfig", "RetClipConfig",
                "InferConfig"):
        t = tconfig.load_config(getattr(tconfig, cls),
                                {"MAEPretrainConfig": "vitl_joint_pretrain",
                                 "FinetuneConfig": "octcube_multitask",
                                 "RetClipConfig": "octcube_ir",
                                 "InferConfig": "infer_8disease"}[cls])
        path = tmp_path / f"{cls}.json"
        path.write_text(tconfig.to_json(t))
        tj = tconfig.load_config(getattr(tconfig, cls), str(path))
        jj = jconfig.load_config(getattr(jconfig, cls), str(path))
        assert dataclasses.asdict(tj) == dataclasses.asdict(jj)
        assert tconfig.to_json(tj) == jconfig.to_json(jj)
    t = tconfig.load_config(tconfig.MAEPretrainConfig, "vitl_joint_pretrain",
                            **over)
    j = jconfig.load_config(jconfig.MAEPretrainConfig, "vitl_joint_pretrain",
                            **over)
    assert tconfig.to_json(t) == jconfig.to_json(j)
    # a file one package wrote loads in the other
    path = tmp_path / "jax.json"
    path.write_text(jconfig.to_json(j))
    assert dataclasses.asdict(tconfig.load_config(
        tconfig.MAEPretrainConfig, str(path))) == dataclasses.asdict(j)
    with pytest.raises(TypeError):
        tconfig.load_config(tconfig.MAEPretrainConfig, "vitl_joint_pretrain",
                            no_such_field=1)


@pytest.mark.parametrize("prev,cur", [
    ({}, {}),
    ({"num_heads": 8}, {}),
    ({"decoder_num_heads": 4, "input_size": 224}, {}),
    ({}, {"num_frames": 48}),
    ({"model": "mae_vit_huge_patch14"}, {"model": "mae_vit_huge_patch14"}),
])
def test_check_resume_geometry_refuses_like_jax(tmp_path, prev, cur):
    base = dataclasses.asdict(jconfig.MAEPretrainConfig())
    base.update(prev)
    path = tmp_path / "args.json"
    path.write_text(json.dumps(base))
    fields = tpretrain._GEOMETRY_FIELDS
    outcomes = []
    for mod in (tconfig, jconfig):
        cfg = dataclasses.replace(mod.MAEPretrainConfig(), **cur)
        try:
            mod.check_resume_geometry(cfg, str(path), fields)
            outcomes.append(None)
        except SystemExit as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == (prev == cur)
    # a missing or unreadable file passes in both
    for mod in (tconfig, jconfig):
        mod.check_resume_geometry(mod.MAEPretrainConfig(num_heads=2),
                                  str(tmp_path / "none.json"), fields)


def test_runtime_and_multihost_on_one_rank(monkeypatch, tmp_path):
    assert runtime.setup_compilation_cache(device="cpu") is None
    assert runtime.setup_compilation_cache("") is None
    info = multihost.announce("cpu")
    assert (info["process_index"], info["process_count"]) == (0, 1)
    assert multihost.summary() == info
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    rows = multihost.local_rows(t * 2)
    assert isinstance(rows, np.ndarray)
    np.testing.assert_array_equal(rows, np.arange(12).reshape(3, 4) * 2)
    np.testing.assert_array_equal(multihost.local_rows(rows), rows)
    # initialize / put_tree / global_batch on a one-rank gloo group (their
    # multi-rank round trips: test_torch_port_multihost.py)
    import torch.distributed as dist
    from octcubem_tpu_torch.core.mesh import make_mesh

    store = dist.FileStore(str(tmp_path / "store"), 1)
    info = multihost.initialize(store=store, world_size=1, rank=0,
                                device="cpu")
    try:
        assert (info["process_index"], info["process_count"]) == (0, 1)
        mesh = make_mesh(device="cpu")
        g = multihost.global_batch(mesh, t)
        assert tuple(g.shape) == (3, 4)
        np.testing.assert_array_equal(multihost.local_rows(g), t.numpy())
        tree = multihost.put_tree(mesh, {"w": t, "n": 3})
        assert tree["n"] == 3
        np.testing.assert_array_equal(tree["w"].full_tensor().numpy(),
                                      t.numpy())
        # a launcher's WORLD_SIZE does not re-join a formed group
        monkeypatch.setenv("WORLD_SIZE", "4")
        assert multihost.announce("cpu")["process_count"] == 1
    finally:
        multihost.shutdown()
    assert multihost.world() == (0, 1)


def test_get_logger_retargets_like_jax(tmp_path):
    for mod, name in ((tlogging, "port_retarget"), (jlogging, "jax_retarget")):
        a, b = tmp_path / name / "a" / "out.log", tmp_path / name / "b.log"
        log = mod.get_logger(name, str(a))
        log.info("first")
        assert mod.get_logger(name, str(b)) is log
        log.info("second")
        assert mod.get_logger(name) is log  # no file: the handler stays
        log.info("third")
        files = [h for h in log.handlers
                 if isinstance(h, logging.FileHandler)]
        assert [h.baseFilename for h in files] == [str(b)]
        for h in files:
            h.flush()
        assert "first" in a.read_text() and "second" not in a.read_text()
        assert "second" in b.read_text() and "third" in b.read_text()
        for h in list(log.handlers):
            log.removeHandler(h)
            h.close()


def test_jsonl_and_meters_match_jax(tmp_path):
    rec = {"epoch": 0, "train_loss": np.float32(1.25), "lr": 1e-4,
           "spl_k": 0.7}
    for mod in (tlogging, jlogging):
        out = tmp_path / mod.__name__.split(".")[0]
        lg = mod.JsonlLogger(str(out))
        lg.write(rec)
        lg.write({"epoch": 1})
    assert ((tmp_path / "octcubem_tpu_torch" / "log.txt").read_text()
            == (tmp_path / "octcubem_tpu" / "log.txt").read_text())
    meters = []
    for mod in (tlogging, jlogging):
        m = mod.MetricLogger()
        for v in (3.0, 1.0, 2.0, 5.0):
            m.update(loss=v, lr=v / 10)
        meters.append((str(m), m.loss.global_avg, m.loss.median,
                       m.loss.avg, m.loss.value))
        with pytest.raises(AttributeError):
            m.nope
    assert meters[0] == meters[1]
    lines = []
    m = tlogging.MetricLogger()
    assert list(m.log_every(range(5), 2, "h", logger=type(
        "L", (), {"info": staticmethod(lines.append)}))) == list(range(5))
    assert len(lines) == 4 and lines[-1].startswith("h Total time")
    assert not tlogging.WandbWriter(False, str(tmp_path)).active
    assert tlogging.is_master()


def test_param_count_and_flops_equal_jax():
    kw = dict(input_size=32, high_res_input_size=64, embed_dim=64, depth=2,
              num_heads=2, decoder_embed_dim=32, decoder_depth=1,
              decoder_num_heads=2, num_frames=6, t_patch_size=3,
              pred_t_dim=6)
    jm = jmae3d.MaskedAutoencoderViT3D(**kw, attn_impl="naive")
    shapes = jax.eval_shape(
        lambda: jm.init({"params": jax.random.key(0),
                         "masking": jax.random.key(0)},
                        jax.numpy.zeros((1, 6, 32, 32, 1)), mask_ratio=0.9))
    tm = tmae3d.create_model(tmae3d.MaskedAutoencoderViT3D, device="cpu",
                             **kw)
    n = jprofiling.param_count(shapes)
    assert tprofiling.param_count(tm) == n
    assert tprofiling.param_count(dict(tm.named_parameters())) == n
    for args in ((4097, 24, 1024), (50, 2, 64, 2.0), (1, 1, 8)):
        assert tprofiling.vit_flops(*args) == jprofiling.vit_flops(*args)
    lin = torch.nn.Linear(16, 8)
    x = torch.randn(4, 16)
    assert tprofiling.flop_count(lin, x)["flops"] == 2 * 4 * 16 * 8
    rows = tprofiling.profile_models([("lin", lin, (x,))])
    assert rows == [{"model": "lin", "flops_G": 0.0}]


def test_trace_writes_a_chrome_trace(tmp_path):
    """``profiler()``'s trace carries the program's ``octcube.*`` ranges:
    a step's and its phases', and the attention op's."""
    from octcubem_tpu_torch.ops.attention import multi_head_attention_qkv

    out = str(tmp_path / "prof")
    qkv = torch.randn(1, 5, 3 * 2 * 8, requires_grad=True)
    with tprofiling.profiler(out):
        with tprofiling.step("demo"):
            with tprofiling.phase("forward"):
                y = multi_head_attention_qkv(qkv, 2).sum()
            with tprofiling.phase("backward", span=False):
                tprofiling.backward(y).backward()
    with open(os.path.join(out, "trace.json")) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert {"octcube.demo.step", "octcube.demo.forward",
            "octcube.demo.backward", "octcube.attn.fwd",
            "octcube.attn.bwd"} <= names
    assert any("mm" in n for n in names)
