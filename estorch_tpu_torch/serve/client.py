"""Minimal stdlib client for the policy server (serve/server.py).

Counterpart of ``estorch_tpu/serve/client.py``, copied with its code
unchanged.  One persistent keep-alive connection per instance — NOT
thread-safe by design (``http.client`` connections aren't); give each
thread its own client.  For load generation use serve/loadgen.py, whose
selector-based engine keeps many requests in flight from one thread.
"""

from __future__ import annotations

import http.client
import json


class ServeError(RuntimeError):
    """Non-2xx server answer; ``.status`` and ``.payload`` carry it."""

    def __init__(self, status: int, payload: dict):
        super().__init__(f"server answered {status}: {payload}")
        self.status = status
        self.payload = payload


class ServeClient:
    """``ServeClient("127.0.0.1:8321").predict([0.1, 0.2, 0.3])``."""

    def __init__(self, address: str, timeout_s: float = 30.0):
        if "://" in address:
            address = address.split("://", 1)[1]
        host, _, port = address.rstrip("/").partition(":")
        self.host = host
        self.port = int(port or 80)
        self.timeout_s = float(timeout_s)
        self._conn: http.client.HTTPConnection | None = None

    # ------------------------------------------------------------ plumbing

    def _request(self, method: str, path: str, payload: dict | None = None):
        body = json.dumps(payload).encode() if payload is not None else None
        headers = {"Content-Type": "application/json"} if body else {}
        # transparent stale-connection retry for GETs only: a POST whose
        # connection died may ALREADY have been executed server-side
        # (predict counted, reload performed) — silently replaying a
        # non-idempotent request double-applies it, so POST failures
        # surface to the caller, who owns the retry decision
        retriable = method == "GET"
        for attempt in (0, 1):
            if self._conn is None:
                self._conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=self.timeout_s)
            try:
                self._conn.request(method, path, body, headers)
                resp = self._conn.getresponse()
                data = resp.read()
                break
            except (http.client.HTTPException, OSError):
                self.close()
                if attempt or not retriable:
                    raise
        try:
            parsed = json.loads(data) if data else {}
        except ValueError:
            parsed = {"raw": data.decode(errors="replace")}
        if resp.status >= 300:
            raise ServeError(resp.status, parsed)
        return parsed

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- surface

    def predict(self, obs) -> list:
        """One observation → the policy output as a (nested) list.  The
        JSON float round trip is exact (repr shortest-round-trip), so
        the listed values are bit-identical to the server's float32
        outputs."""
        if hasattr(obs, "tolist"):
            obs = obs.tolist()
        return self._request("POST", "/predict", {"obs": obs})["action"]

    def health(self) -> dict:
        return self._request("GET", "/healthz")

    def stats(self) -> dict:
        return self._request("GET", "/stats")

    def reload(self, bundle_path: str) -> dict:
        return self._request("POST", "/reload", {"path": bundle_path})
