"""Port AOT serving artifacts (compat/aot.py, serve --aot) on the CPU.

The artifact is the JAX package's container (magic line, one JSON header
line, payload) around a ``torch.export`` program whose attention is the
B1 custom op, one call per block; on the CPU the op runs B1's plain
version.  The loader refuses a bad magic, a platform the header does not
list, and an artifact the JAX package wrote with ``jax.export``.  Tiny
classifier: width 64, 2 heads of 32 (a head_dim B1 serves), 6x32x32 (8
tube tokens + cls).
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from octcubem_tpu.compat import aot as jaot
from octcubem_tpu_torch.cli import serve
from octcubem_tpu_torch.compat import aot
from octcubem_tpu_torch.data.transforms import Transform3D
from octcubem_tpu_torch.models import vit_st

KW = dict(num_frames=6, t_patch_size=3, img_size=32, patch_size=16,
          in_chans=1, num_classes=4, embed_dim=64, num_heads=2,
          head_type="dropout", global_pool=True)


def _model(depth=2, dtype=torch.float32, seed=1):
    return vit_st.create_model(vit_st.VisionTransformerST, device="cpu",
                               seed=seed, depth=depth, dtype=dtype, **KW)


def _x(seed=0):
    return torch.from_numpy(np.random.default_rng(seed).random(
        (1, 6, 32, 32, 1), dtype=np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_trip_equals_the_live_model(tmp_path, dtype):
    model, x = _model(dtype=dtype), _x()
    path = aot.export_serving_artifact(model, (x,), str(tmp_path / "m.octaot"),
                                       meta={"nb_classes": 4})
    fn, meta = aot.load_serving_artifact(path, device="cpu")
    assert meta["format"] == "torch.export" and meta["platforms"] == ["cpu"]
    assert meta["in_shapes"] == [[1, 6, 32, 32, 1]]
    assert meta["in_dtypes"] == ["float32"] and meta["nb_classes"] == 4
    with torch.inference_mode():
        ref = model(x)
        for seed in (0, 1):
            got = fn(_x(seed))
            assert got.dtype == dtype
            torch.testing.assert_close(got, model(_x(seed)), rtol=0, atol=0)
    assert torch.equal(fn(x), ref)


@pytest.mark.parametrize("depth", [1, 3])
def test_graph_holds_one_flash_op_per_block(tmp_path, depth):
    path = aot.export_serving_artifact(_model(depth), (_x(),),
                                       str(tmp_path / "m.octaot"))
    fn, _ = aot.load_serving_artifact(path, device="cpu")
    assert aot.flash_op_calls(fn.program) == depth
    # the op, not its plain version traced into aten ops
    ops = {str(n.target) for n in fn.program.graph.nodes
           if n.op == "call_function"}
    assert not {"aten.exp.default", "aten.einsum.default"} & ops


def test_a_program_without_the_op_refused(tmp_path):
    """head_dim 16 is not B1's (its attention runs the [B, H, N, D] path,
    which is no op): the export would trace plain attention, an artifact
    that never launches a kernel on the card, and is refused."""
    model = vit_st.create_model(vit_st.VisionTransformerST, device="cpu",
                                seed=1, depth=1, **dict(KW, embed_dim=32))
    with pytest.raises(ValueError, match="no call of the B1 op"):
        aot.export_serving_artifact(model, (_x(),), str(tmp_path / "m.octaot"))


def test_bad_magic_refused(tmp_path):
    path = tmp_path / "junk.octaot"
    path.write_bytes(b"NOT-AN-ARTIFACT\n{}\n")
    with pytest.raises(ValueError, match="not an OCTPU-AOT1 artifact"):
        aot.load_serving_artifact(str(path), device="cpu")


def test_platform_the_header_lacks_refused(tmp_path):
    path = aot.export_serving_artifact(_model(), (_x(),),
                                       str(tmp_path / "m.octaot"),
                                       platforms=("cuda",))
    with pytest.raises(ValueError, match=r"exported for \['cuda'\]"):
        aot.load_serving_artifact(path, device="cpu")
    with pytest.raises(ValueError, match="must be one of"):
        aot.export_serving_artifact(_model(), (_x(),),
                                    str(tmp_path / "n.octaot"),
                                    platforms=("tpu",))


def test_jax_artifact_refused(tmp_path):
    """An artifact of the JAX package's exporter (jax.export StableHLO,
    the same container without the torch format tag)."""
    path = str(tmp_path / "jax.octaot")
    jaot.export_serving_artifact(lambda x: x * 2.0,
                                 (jnp.zeros((1, 3), jnp.float32),), path,
                                 platforms=("cpu",))
    fn, _ = jaot.load_serving_artifact(path)  # a good JAX artifact
    np.testing.assert_array_equal(np.asarray(fn(jnp.ones((1, 3)))), 2.0)
    with pytest.raises(ValueError, match="'jax.export' artifact"):
        aot.load_serving_artifact(path, device="cpu")


def _post_npy(url, arr):
    import io

    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read().decode())


def test_serve_aot_answers(tmp_path):
    """serve --aot: shapes from the header; /predict's probabilities equal
    the live model's on the same preprocessing."""
    model = _model()
    path = aot.export_serving_artifact(
        model, (_x(),), str(tmp_path / "m.octaot"),
        meta={"nb_classes": 4, "quant": "none"})
    started, box = threading.Event(), []
    th = threading.Thread(
        target=serve.main,
        args=(["--aot", path, "--port", "0", "--device", "cpu"], started,
              box), daemon=True)
    th.start()
    assert started.wait(timeout=120), "server did not start"
    httpd = box[0]
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read().decode())
        assert health["status"] == "ok" and health["source"] == path
        assert (health["num_frames"], health["input_size"]) == (6, 32)
        vol = (np.random.default_rng(3).random((6, 40, 40)) * 255
               ).astype(np.float32)
        code, out = _post_npy(base + "/predict", vol)
        assert code == 200, out
        v = Transform3D(32, 6, train=False)(vol) / 255.0
        with torch.inference_mode():
            lg = model(torch.from_numpy(v[None, ..., None])).numpy()
        lg = lg.reshape(1, -1, 2)
        e = np.exp(lg - lg.max(-1, keepdims=True))
        ref = (e / e.sum(-1, keepdims=True))[:, :, 1]
        np.testing.assert_allclose(out["probs"], ref, rtol=0, atol=1e-7)
    finally:
        httpd.shutdown()
        th.join(timeout=30)
