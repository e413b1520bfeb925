"""Port serving path on the CPU: cli/serve.py's HTTP server with a tiny
model, and the host transform and inference helpers against the JAX
package's."""

import http.client
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from octcubem_tpu.cli import infer as jinfer
from octcubem_tpu.data.transforms import create_3d_transforms
from octcubem_tpu_torch.cli import infer as tinfer
from octcubem_tpu_torch.cli import serve
from octcubem_tpu_torch.data.dicom import write_dicom
from octcubem_tpu_torch.data.transforms import Transform3D
from octcubem_tpu_torch.models.vit_st import VisionTransformerST, create_model

ARGS = ["--port", "0", "--device", "cpu", "--precision", "fp32",
        "--embed_dim", "64", "--depth", "2", "--num_heads", "2",
        "--num_frames", "6", "--input_size", "32", "--nb_classes", "4",
        "--seed", "3"]


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


@pytest.fixture(scope="module")
def server():
    started, box = threading.Event(), []
    th = threading.Thread(target=serve.main, args=(ARGS, started, box),
                          daemon=True)
    th.start()
    assert started.wait(timeout=120), "server did not start"
    httpd = box[0]
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    th.join(timeout=30)
    assert not th.is_alive()


def _reference_probs(v):
    """The same seeded model, run directly on a preprocessed volume."""
    model = create_model(VisionTransformerST, device="cpu", seed=3,
                         num_frames=6, t_patch_size=3, img_size=32,
                         in_chans=1, num_classes=4, embed_dim=64, depth=2,
                         num_heads=2, head_type="dropout", global_pool=True)
    with torch.inference_mode():
        logits = model(torch.from_numpy(v[None, ..., None])).numpy()
    logits = logits.reshape(1, -1, 2)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True))[0, :, 1]


def test_healthz(server):
    with urllib.request.urlopen(server + "/healthz", timeout=30) as r:
        health = json.loads(r.read().decode())
    assert health["status"] == "ok" and health["num_frames"] == 6
    assert health["device"] == "cpu" and health["source"] == "random-init"


def test_predict_raw_and_preprocessed(server):
    rng = np.random.default_rng(5)
    vol = (rng.random((7, 40, 44)) * 255).astype(np.float32)
    code, out = _post(server + "/predict", _npy(vol))
    assert code == 200, out
    v = Transform3D(32, 6, train=False)(vol) / 255.0
    np.testing.assert_allclose(out["probs"][0], _reference_probs(v),
                               atol=1e-5)

    v2 = rng.random((6, 32, 32), dtype=np.float32)
    code, out = _post(server + "/predict?raw=0", _npy(v2))
    assert code == 200, out
    np.testing.assert_allclose(out["probs"][0], _reference_probs(v2),
                               atol=1e-5)


@pytest.mark.parametrize("path,body", [
    ("/predict", b"not an npy body"),
    ("/predict", _npy(np.zeros((32, 32), np.float32))),
    ("/predict?raw=0", _npy(np.zeros((6, 30, 32), np.float32))),
])
def test_predict_rejects_bad_bodies(server, path, body):
    code, out = _post(server + path, body)
    assert code == 400 and "error" in out


def test_predict_rejects_oversized_body(server):
    host, port = server.removeprefix("http://").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Length", str(serve.MAX_BODY_BYTES + 1))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 413
        assert "exceeds limit" in json.loads(resp.read().decode())["error"]
    finally:
        conn.close()


def test_unported_serving_options_raise(tmp_path):
    """A10 ported both options: --quant int8 serves (its parity test is
    test_torch_port_quant.py), --aot loads an artifact (a file that is
    none is refused; test_torch_port_aot.py serves one)."""
    bad = tmp_path / "m.octaot"
    bad.write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="not an OCTPU-AOT1 artifact"):
        serve.main(ARGS + ["--aot", str(bad)])
    predict, meta = serve.build_predictor(serve.argparse.Namespace(
        aot=None, ckpt=None, device="cpu", seed=3, num_frames=6,
        input_size=32, nb_classes=4, precision="fp32", quant="int8",
        embed_dim=64, depth=2, num_heads=2))
    assert meta["quant"] == "int8"
    logits = predict(np.zeros((1, 6, 32, 32, 1), np.float32))
    assert logits.shape == (1, 4) and np.isfinite(logits).all()


@pytest.mark.parametrize("shape,normalize", [((7, 50, 60), False),
                                             ((48, 256, 256), False),
                                             ((9, 20, 33), True)])
def test_val_transform_matches_jax(shape, normalize):
    vol = (np.random.default_rng(6).random(shape) * 255).astype(np.float32)
    vol[0, :3] = 0  # zero voxels: NormalizeIntensityd(nonzero) keeps them
    _, jval = create_3d_transforms(input_size=32, num_frames=6,
                                   RandFlipd_prob=0,
                                   normalize_dataset=normalize)
    ref = jval(vol)
    out = Transform3D(32, 6, train=False, normalize=normalize)(vol)
    assert out.shape == ref.shape == (6, 32, 32) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_infer_helpers_match_jax(tmp_path):
    vol = (np.random.default_rng(9).random((10, 40, 40)) * 255)
    path = str(tmp_path / "vol.npy")
    np.save(path, vol)
    np.testing.assert_allclose(tinfer.process_volume(path, 6, 32),
                               jinfer.process_volume(path, 6, 32),
                               atol=1e-6)
    dcm = str(tmp_path / "vol.dcm")  # DICOM (A10): test_torch_port_dicom.py
    write_dicom(dcm, vol.astype(np.uint8))
    np.testing.assert_allclose(tinfer.process_volume(dcm, 6, 32),
                               jinfer.process_volume(dcm, 6, 32), atol=1e-6)
    probs = np.random.default_rng(1).dirichlet([1, 1], size=8)
    assert tinfer.parse_all_output(probs) == jinfer.parse_all_output(probs)
