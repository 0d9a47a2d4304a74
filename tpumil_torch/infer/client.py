"""Python client for the inference server (copy of tpumil/infer/client.py;
stdlib + numpy only).

Speaks ``tpumil_torch/cli/serve.py``'s wire format: raw ``.npy``/``.npz``
request bodies, ``.npy`` or JSON responses.

    c = ServingClient("http://gpu-host:8008")
    feats = c.embed(patches)                   # [N, 224, 224, 3] u8 -> [N, K]
    result = c.predict_patches(patches)        # scores/detected/attention
    png = c.heatmap(patches, positions)        # rendered PNG bytes
"""

from __future__ import annotations

import io
import json
import urllib.request
from typing import Dict, Optional

import numpy as np


class ServingClient:
    def __init__(self, base_url: str, timeout: float = 300.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _post(self, route: str, body: bytes):
        req = urllib.request.Request(self.base_url + route, data=body)
        return urllib.request.urlopen(req, timeout=self.timeout)

    def _get_json(self, route: str) -> Dict:
        with urllib.request.urlopen(self.base_url + route,
                                    timeout=self.timeout) as r:
            return json.loads(r.read())

    @staticmethod
    def _npy(arr: np.ndarray) -> bytes:
        buf = io.BytesIO()
        np.save(buf, arr, allow_pickle=False)
        return buf.getvalue()

    def health(self) -> Dict:
        return self._get_json("/healthz")

    def stats(self) -> Dict:
        return self._get_json("/stats")

    def embed(self, images: np.ndarray) -> np.ndarray:
        """uint8 ``[N, P, P, 3]`` patches -> float32 ``[N, K]`` features."""
        with self._post("/v1/embed", self._npy(images)) as r:
            return np.load(io.BytesIO(r.read()), allow_pickle=False)

    def predict(self, feats: np.ndarray, attention: bool = False) -> Dict:
        route = "/v1/predict" + ("?attention=1" if attention else "")
        with self._post(route, self._npy(feats)) as r:
            return json.loads(r.read())

    def predict_patches(self, images: np.ndarray,
                        attention: bool = False) -> Dict:
        route = "/v1/predict_patches" + ("?attention=1" if attention else "")
        with self._post(route, self._npy(images)) as r:
            return json.loads(r.read())

    def heatmap(self, images: np.ndarray, positions: np.ndarray,
                colors: Optional[np.ndarray] = None) -> Dict:
        """Returns ``{"png": bytes, "scores": [...], "detected": [...]}``."""
        buf = io.BytesIO()
        arrays = {"images": images, "positions": positions}
        if colors is not None:
            arrays["colors"] = colors
        np.savez(buf, **arrays)
        with self._post("/v1/heatmap", buf.getvalue()) as r:
            return {
                "png": r.read(),
                "scores": json.loads(r.headers["X-Tpumil-Scores"]),
                "detected": json.loads(r.headers["X-Tpumil-Detected"]),
            }
