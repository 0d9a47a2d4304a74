"""Inference serving CLI (counterpart of tpumil/cli/serve.py).

Serves ``tpumil_torch.infer.service.InferenceService`` over plain HTTP
(stdlib only):

  GET  /healthz               -> JSON service/readiness info
  GET  /stats                 -> JSON serving counters (batch fill, errors)
  POST /v1/embed              body: .npy uint8 [N, P, P, 3]
                              -> .npy float32 [N, K] features
  POST /v1/predict            body: .npy float32 [N, K] bag features
                              -> JSON {scores, detected, attention?}
  POST /v1/predict_patches    body: .npy uint8 [N, P, P, 3] (one bag)
                              -> JSON {scores, detected, attention?}
  POST /v1/heatmap            body: .npz {images, positions[, colors]}
                              -> PNG attention map (scores/detected in
                                 X-Tpumil-* headers)

Arrays travel as raw ``.npy`` bytes; the server decodes bodies as
zero-copy ``np.frombuffer`` views and streams responses as header +
memoryview chunks. ``?attention=1`` includes the [N, C] attention matrix.

    python -m tpumil_torch.cli.serve --device cuda \\
        --embedder_weights <run>/model.pth \\
        --aggregator_weights weights/<date>/fold_0.pth --port 8008
"""

from __future__ import annotations

import argparse
import io
import json
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from tpumil_torch.cli.attention_map import (DATA_PARALLEL_HELP,
                                           refuse_data_parallel)

MAX_BODY_BYTES = 1 << 30


def _load_npy(body: bytes) -> np.ndarray:
    try:
        return np.load(io.BytesIO(body), allow_pickle=False)
    except Exception as exc:
        raise ValueError(f"body is not a valid .npy array: {exc}") from None


def _load_npy_zerocopy(body: bytes) -> np.ndarray:
    """Parse the .npy header, then VIEW the payload with np.frombuffer (no
    second copy of the body; the view is read-only, which every consumer
    tolerates). Anything unusual (fortran order, npy v2+) goes through
    np.load."""
    try:
        f = io.BytesIO(body)
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            if not fortran and not dtype.hasobject:
                return np.frombuffer(body, dtype=dtype,
                                     offset=f.tell()).reshape(shape)
    except Exception:
        pass
    return _load_npy(body)


def _npy_chunks(arr: np.ndarray):
    """.npy response as [header bytes, payload memoryview]."""
    arr = np.ascontiguousarray(arr)
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        buf, np.lib.format.header_data_from_array_1_0(arr))
    return [buf.getvalue(), memoryview(arr).cast("B")]


def _load_npz(body: bytes) -> dict:
    try:
        with np.load(io.BytesIO(body), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except Exception as exc:
        raise ValueError(f"body is not a valid .npz archive: {exc}") from None


def _encode_png(image01: np.ndarray) -> bytes:
    from PIL import Image

    from tpumil_torch.ops.image import img_as_ubyte

    buf = io.BytesIO()
    Image.fromarray(img_as_ubyte(image01)).save(buf, format="PNG")
    return buf.getvalue()


def make_handler(service):
    """Build the request-handler class bound to an InferenceService."""

    class Handler(BaseHTTPRequestHandler):
        # one InferenceService shared by all server threads; its
        # micro-batcher makes that sharing the point
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body, ctype: str) -> None:
            """body: bytes or a list of buffer chunks."""
            chunks = body if isinstance(body, list) else [body]
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length",
                             str(sum(len(c) for c in chunks)))
            self.end_headers()
            for c in chunks:
                self.wfile.write(c)

        def _send_json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _read_body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            if n <= 0:
                raise ValueError("missing request body")
            if n > MAX_BODY_BYTES:
                raise ValueError(f"body too large ({n} bytes)")
            return self.rfile.read(n)

        def _want_attention(self) -> bool:
            return "attention=1" in (self.path.split("?", 1) + [""])[1]

        def _prediction_json(self, result) -> dict:
            out = {
                "scores": [float(s) for s in result["scores"]],
                "detected": result["detected"],
                "num_instances": int(result["attention"].shape[0]),
            }
            if self._want_attention():
                out["attention"] = result["attention"].astype(float).tolist()
            return out

        def do_GET(self):  # noqa: N802 (http.server API)
            route = self.path.split("?", 1)[0]
            if route == "/healthz":
                self._send_json(200, service.health())
            elif route == "/stats":
                self._send_json(200, service.stats())
            else:
                self._send_json(404, {"error": f"no route {route}"})

        def do_POST(self):  # noqa: N802
            route = self.path.split("?", 1)[0]
            try:
                if route == "/v1/embed":
                    feats = service.embed(_load_npy_zerocopy(self._read_body()))
                    self._send(200, _npy_chunks(feats), "application/x-npy")
                elif route == "/v1/predict":
                    result = service.predict(
                        _load_npy_zerocopy(self._read_body()))
                    self._send_json(200, self._prediction_json(result))
                elif route == "/v1/predict_patches":
                    result = service.predict_patches(
                        _load_npy_zerocopy(self._read_body()))
                    self._send_json(200, self._prediction_json(result))
                elif route == "/v1/heatmap":
                    data = _load_npz(self._read_body())
                    if "images" not in data or "positions" not in data:
                        raise ValueError(
                            "body must be an .npz with 'images' and "
                            "'positions' (optional 'colors')")
                    image01, result = service.heatmap(
                        data["images"], data["positions"],
                        colors=data.get("colors"))
                    png = _encode_png(image01)
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(png)))
                    self.send_header("X-Tpumil-Scores", json.dumps(
                        [float(s) for s in result["scores"]]))
                    self.send_header("X-Tpumil-Detected",
                                     json.dumps(result["detected"]))
                    self.end_headers()
                    self.wfile.write(png)
                else:
                    self._send_json(404, {"error": f"no route {route}"})
            except (ValueError, RuntimeError) as exc:
                self._send_json(400, {"error": str(exc)})
            except Exception as exc:  # noqa: BLE001 - keep the server alive
                self._send_json(500, {"error": f"{type(exc).__name__}: {exc}"})

    return Handler


def make_server(service, host: str = "127.0.0.1", port: int = 0):
    """ThreadingHTTPServer bound to (host, port); port 0 picks a free one."""
    return ThreadingHTTPServer((host, port), make_handler(service))


def build_service(args):
    from tpumil_torch.infer.service import InferenceService
    from tpumil_torch.models import embedder
    from tpumil_torch.models.embedder import EmbedderConfig
    from tpumil_torch.utils.device import select_device

    device = select_device(args.device)
    if args.aggregator_weights:
        from tpumil_torch.cli.attention_map import load_milnet

        emb, emb_cfg, agg, model_name = load_milnet(
            args.embedder_weights, args.aggregator_weights, args.num_classes,
            device, norm=args.norm, backbone=args.backbone,
            precision=args.precision, space_to_depth=args.space_to_depth)
    else:
        emb_cfg = EmbedderConfig(backbone=args.backbone, norm=args.norm,
                                 num_classes=args.num_classes,
                                 precision=args.precision,
                                 space_to_depth=args.space_to_depth)
        emb = embedder.load_simclr_checkpoint(args.embedder_weights, emb_cfg,
                                              device)
        agg, model_name = None, None
    return InferenceService(
        emb, device, aggregator=agg, model=model_name or "dsmil",
        batch_size=args.batch_size, patch_size=args.patch_size,
        max_wait_ms=args.max_wait_ms, thresholds=args.thres,
        average=args.average)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="tpumil_torch inference server (micro-batched "
                    "embed/predict)")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8008)
    parser.add_argument("--embedder_weights", type=str, required=True)
    parser.add_argument("--aggregator_weights", type=str, default=None,
                        help="optional aggregator .pth; without it only "
                             "/v1/embed is served")
    parser.add_argument("--num_classes", type=int, default=2)
    parser.add_argument("--backbone", type=str, default="resnet18")
    parser.add_argument("--norm", type=str, default="instance",
                        choices=("instance", "batch"))
    parser.add_argument("--precision", type=str, default="f32",
                        choices=("bf16", "f32", "f32h", "f32x"),
                        help="f32 default matches the shipped reference "
                             "thresholds; bf16 for throughput")
    parser.add_argument("--space_to_depth",
                        action=argparse.BooleanOptionalAction, default=False,
                        help="space-to-depth stem rewrite (same math, "
                             "different summation order); moot for instance "
                             "norm at 224^2, whose stem is the fused kernel")
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--patch_size", type=int, default=224)
    parser.add_argument("--max_wait_ms", type=float, default=8.0)
    parser.add_argument("--thres", nargs="+", type=float, default=None)
    parser.add_argument("--average", action="store_true",
                        help="testing-flow score averaging (bag sigmoid + "
                             "max-instance sigmoid)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--data_parallel", type=int, default=0, metavar="N",
                        help=DATA_PARALLEL_HELP)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    refuse_data_parallel(args.data_parallel)
    service = build_service(args)
    server = make_server(service, args.host, args.port)
    host, port = server.server_address[:2]
    print(f"tpumil_torch serving on http://{host}:{port} "
          f"({args.device}, batch {args.batch_size}, "
          f"{args.backbone}/{args.norm}, "
          f"{'embed+predict' if args.aggregator_weights else 'embed only'})",
          flush=True)

    import signal

    def _graceful(signum, frame):  # SIGTERM from an orchestrator
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _graceful)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("tpumil_torch serve: draining and shutting down", flush=True)
    finally:
        server.server_close()
        service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
