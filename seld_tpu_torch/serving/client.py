"""Minimal stdlib client for the serving daemon (tests + examples).

    c = SELDClient("127.0.0.1", 8765)
    sed, doa = c.score(x)                     # window/clip artifact
    for chunk in feed:
        sed, doa = c.stream_push("mic0", chunk)   # [k, ...] final frames
    sed, doa = c.stream_finalize("mic0")
"""
from __future__ import annotations

import http.client
import io
import json
from typing import Tuple

import numpy as np


def _npy_bytes(arr: np.ndarray) -> Tuple[bytes, dict]:
    """Serialize to .npy plus wire headers.

    The .npy format cannot self-describe ml_dtypes (bfloat16 saves as raw
    void16 and loads back useless), so those travel as their bit-identical
    unsigned view with an `X-SELD-Dtype` header the server uses to view
    them back.
    """
    arr = np.ascontiguousarray(arr)
    headers = {}
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        wire = {2: np.uint16, 1: np.uint8}.get(arr.dtype.itemsize)
        if wire is None:
            raise ValueError(f"cannot wire-encode dtype {arr.dtype}")
        headers["X-SELD-Dtype"] = arr.dtype.name
        arr = arr.view(wire)
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue(), headers


class SELDClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 8765,
                 timeout: float = 600.0):
        self.host, self.port, self.timeout = host, port, timeout

    def _request(self, method: str, path: str, body: bytes = b"",
                 extra_headers: dict = None):
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        try:
            headers = {"Content-Length": str(len(body))} if body else {}
            headers.update(extra_headers or {})
            conn.request(method, path, body=body or None, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            ctype = resp.getheader("Content-Type", "")
            if resp.status != 200:
                try:
                    msg = json.loads(data).get("error", data[:200])
                except Exception:
                    msg = data[:200]
                raise RuntimeError(f"{method} {path} -> {resp.status}: {msg}")
            if "json" in ctype:
                return json.loads(data)
            if ctype.startswith("text/"):
                return data.decode()
            return dict(np.load(io.BytesIO(data)))
        finally:
            conn.close()

    def health(self) -> dict:
        return self._request("GET", "/healthz")

    def metrics(self) -> str:
        """Prometheus text exposition (GET /metrics)."""
        return self._request("GET", "/metrics")

    def score(self, x: np.ndarray, model: str = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        body, hdrs = _npy_bytes(x)
        from urllib.parse import quote
        path = "/v1/score" + (f"?model={quote(model, safe='')}"
                              if model else "")
        out = self._request("POST", path, body, hdrs)
        return out["sed"], out["doa"]

    def models(self) -> dict:
        """GET /v1/models: every served model's meta, keyed by name."""
        return self._request("GET", "/v1/models")

    def reload(self) -> dict:
        """POST /v1/reload: hot-swap every artifact from its file."""
        return self._request("POST", "/v1/reload")

    def stream_push(self, sid: str, feats: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        body, hdrs = _npy_bytes(feats)
        out = self._request("POST", f"/v1/stream/{sid}/push", body, hdrs)
        return out["sed"], out["doa"]

    def stream_finalize(self, sid: str) -> Tuple[np.ndarray, np.ndarray]:
        out = self._request("POST", f"/v1/stream/{sid}/finalize")
        return out["sed"], out["doa"]

    def stream_drop(self, sid: str) -> bool:
        return bool(self._request("DELETE", f"/v1/stream/{sid}")["dropped"])
