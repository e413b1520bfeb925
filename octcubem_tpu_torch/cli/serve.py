"""Inference server for the OCT classifier (counterpart of
octcubem_tpu/cli/serve.py), stdlib HTTP only.

    python -m octcubem_tpu_torch.cli.serve --ckpt model.pth --port 8476
    python -m octcubem_tpu_torch.cli.serve --ckpt model.pth --quant int8
    python -m octcubem_tpu_torch.cli.serve --aot model.octaot

Endpoints:
  GET  /healthz   -> {"status": "ok", ...model meta}
  POST /predict   body = .npy bytes (np.save) of one volume [T, H, W]
                  (raw frames; the server applies the val transform and
                  /255) or, with the query ?raw=0, a preprocessed
                  [num_frames, S, S] float volume.  Response:
                  {"probs": [[p_disease...]], "diseases": [...],
                   "latency_ms": ..., "queue_ms": ..., "predict_ms": ...}

``latency_ms`` runs from the request's turn at the lock to the logits on
the host: ``queue_ms`` waiting for the lock (the requests before it)
plus ``predict_ms`` (the copy to the device, the forward and the copy
back).  Each request is one ``utils/profiling.step("serve")`` with the
phases ``parse`` (reading the body, ``np.load``), ``transform``,
``queue``, ``predict`` and ``respond``; the server logs one line a
request with them.

Requests run one at a time at batch 1 behind a lock; the model is built
with seeded random weights and, from ``--ckpt``, the JAX server's import
(the geometry stamp checked first, ``strict=False``: params the file
lacks keep the init, keys with no slot are dropped; /healthz lists both
under "import"), on the card unless ``--device cpu``, and warmed before
the port opens.  ``--quant int8`` builds the float model, imports the
checkpoint, quantizes the block projections (ops/quant.py) and loads
them into a ``quant=True`` model.  ``--aot`` serves a frozen artifact
(compat/aot.py: no model code, shapes from its header) instead.
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..utils import profiling

DISEASES = ["DME", "AMD", "POAG", "EPM", "DR", "VD", "RAO_RVO", "RNV"]

# request-body cap: a raw in-house volume is 61x512x1024 fp64 ~ 256 MB;
# anything past that is a stray upload, not a scan: reject before
# buffering it into host RAM (413)
MAX_BODY_BYTES = 512 * 1024 * 1024
PHASES = ("parse", "transform", "queue", "predict", "respond")
log = logging.getLogger("octcubem_tpu_torch.serve")


def _predictor(fn, device):
    def predict(x: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            out = fn(torch.from_numpy(x).to(device))
        out = out[0] if isinstance(out, tuple) else out
        return out.float().cpu().numpy()

    return predict


def build_predictor(args):
    """Returns (predict(vol_f32[B, T, H, W, 1]) -> logits, meta dict)."""
    from ..compat.torch_import import (check_geometry_stamp,
                                       load_reference_weights,
                                       load_torch_checkpoint)
    from ..core.device import resolve_device
    from ..core.precision import policy_from_name
    from ..models.vit_st import VisionTransformerST, create_model
    from ..ops.quant import quantize_state_dict

    if args.aot:
        from ..compat.aot import load_serving_artifact

        device = resolve_device(args.device)
        fn, meta = load_serving_artifact(args.aot, device)
        b, t, s = meta["in_shapes"][0][:3]
        return _predictor(fn, device), {
            "source": args.aot, "batch": b, "num_frames": t, "input_size": s,
            "nb_classes": meta.get("nb_classes", 16),
            "quant": meta.get("quant", "none"), "device": str(device)}

    if args.ckpt:
        check_geometry_stamp(args.ckpt, args.num_heads or 16)
    device = resolve_device(args.device)
    model_kw = dict(
        num_frames=args.num_frames, t_patch_size=3, img_size=args.input_size,
        in_chans=1, num_classes=args.nb_classes,
        embed_dim=args.embed_dim or 1024, depth=args.depth or 24,
        num_heads=args.num_heads or 16, head_type="dropout", global_pool=True,
        dtype=policy_from_name(args.precision).compute_dtype)
    model = create_model(VisionTransformerST, device=device, seed=args.seed,
                         **model_kw)
    report = {"missing": [], "unexpected": []}
    if args.ckpt:
        report = load_reference_weights(
            model, load_torch_checkpoint(args.ckpt), strict=False)
    if args.quant == "int8":
        float_model = model
        model = create_model(VisionTransformerST, device=device,
                             seed=args.seed, quant=True, **model_kw)
        model.load_state_dict(quantize_state_dict(float_model.state_dict()),
                              strict=True)
        del float_model

    return _predictor(model, device), {
        "source": args.ckpt or "random-init", "batch": 1,
        "num_frames": args.num_frames, "input_size": args.input_size,
        "nb_classes": args.nb_classes, "quant": args.quant,
        "device": str(device), "import": report}


def make_handler(predict, meta, val_transform, lock):
    batch = meta["batch"]
    nf, size = meta["num_frames"], meta["input_size"]

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj: dict):
            self.status = code
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *a):  # quiet; errors go through _json
            pass

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._json(200, {"status": "ok", **meta})
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            self.status = None
            with profiling.step("serve") as rec:
                self._predict(rec["phases"])
            ph = rec["phases"]
            log.info("POST %s %s in %.2f ms: %s", self.path, self.status,
                     rec["seconds"] * 1e3, " ".join(
                         f"{k} {ph[k] * 1e3:.2f}" for k in PHASES
                         if k in ph))

        def _predict(self, phases: dict):
            if not self.path.startswith("/predict"):
                self._json(404, {"error": f"no route {self.path}"})
                return
            with profiling.phase("parse"):
                vol = self._read_volume()
            if vol is None:
                return
            try:
                with profiling.phase("transform"):
                    x = self._model_input(vol)
                if x is None:
                    return
                t0 = time.time()
                with profiling.phase("queue"):
                    lock.acquire()
                try:
                    with profiling.phase("predict"):
                        logits = predict(x)
                finally:
                    lock.release()
                ms = (time.time() - t0) * 1000
                with profiling.phase("respond"):
                    self._respond(logits, ms, phases)
            except Exception as e:  # surface, don't kill the server
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def _read_volume(self):
            """The request's [T, H, W] volume, or None once an error has
            been answered."""
            try:
                n = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                self._json(400, {"error": "bad Content-Length"})
                return None
            if n <= 0:
                # rfile.read(-1) would buffer until EOF: the unbounded
                # read the cap exists to prevent
                self._json(400, {"error": "missing/invalid Content-Length"})
                return None
            if n > MAX_BODY_BYTES:
                self._json(413, {"error": f"body {n} bytes exceeds limit "
                                          f"{MAX_BODY_BYTES}"})
                return None
            try:
                vol = np.load(io.BytesIO(self.rfile.read(n)),
                              allow_pickle=False)
            except Exception as e:
                self._json(400, {"error": f"bad .npy body: {e}"})
                return None
            if vol.ndim != 3:
                self._json(400, {"error": f"expected [T, H, W], got "
                                          f"{list(vol.shape)}"})
                return None
            return vol

        def _model_input(self, vol):
            """The batch the model takes, or None once an error has been
            answered."""
            raw = "raw=0" not in (self.path.split("?", 1) + [""])[1]
            v = vol.astype(np.float32)
            if raw:
                v = val_transform(v) / 255.0
            elif v.shape != (nf, size, size):
                self._json(400, {"error": f"preprocessed volume must be "
                                          f"{[nf, size, size]}, got "
                                          f"{list(v.shape)}"})
                return None
            x = np.zeros((batch, nf, size, size, 1), np.float32)
            x[0] = v[..., None]
            return x

        def _respond(self, logits, ms: float, phases: dict):
            logits = logits[:1].reshape(1, -1, 2)
            e = np.exp(logits - logits.max(-1, keepdims=True))
            probs = (e / e.sum(-1, keepdims=True))[:, :, 1]
            names = (DISEASES if probs.shape[1] == len(DISEASES)
                     else [f"class_{i}" for i in range(probs.shape[1])])
            self._json(200, {"probs": probs.tolist(), "diseases": names,
                             "latency_ms": round(ms, 2),
                             "queue_ms": round(phases["queue"] * 1e3, 2),
                             "predict_ms": round(phases["predict"] * 1e3, 2)})

    return Handler


def main(argv=None, started_event=None, server_box=None):
    parser = argparse.ArgumentParser("OCTCube inference server (PyTorch)")
    parser.add_argument("--aot", default=None,
                        help="frozen serving artifact (compat/aot.py); "
                             "its header gives the input shape")
    parser.add_argument("--ckpt", default=None,
                        help="reference .pth (any layout the importer "
                             "reads); seeded random weights when absent")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8476)
    parser.add_argument("--num_frames", type=int, default=48)
    parser.add_argument("--input_size", type=int, default=256)
    parser.add_argument("--nb_classes", type=int, default=16)
    parser.add_argument("--precision", choices=["fp32", "bf16"],
                        default="bf16")
    parser.add_argument("--quant", choices=["none", "int8"], default="none")
    parser.add_argument("--embed_dim", type=int, default=None)
    parser.add_argument("--depth", type=int, default=None)
    parser.add_argument("--num_heads", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain path")
    args = parser.parse_args(argv)

    from ..core.device import resolve_device
    from ..core.runtime import setup_compilation_cache
    from ..data.transforms import create_3d_transforms

    setup_compilation_cache(device=resolve_device(args.device))
    predict, meta = build_predictor(args)
    _, val_t = create_3d_transforms(meta["input_size"], meta["num_frames"],
                                    RandFlipd_prob=0)
    t0 = time.time()
    predict(np.zeros((meta["batch"], meta["num_frames"], meta["input_size"],
                      meta["input_size"], 1), np.float32))
    log.info("model warm in %.1fs (%s)", time.time() - t0, meta)

    lock = threading.Lock()
    httpd = ThreadingHTTPServer(
        (args.host, args.port), make_handler(predict, meta, val_t, lock))
    log.info("serving on http://%s:%d (POST /predict, GET /healthz)",
             args.host, httpd.server_address[1])
    if server_box is not None:
        server_box.append(httpd)
    if started_event is not None:
        started_event.set()
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
