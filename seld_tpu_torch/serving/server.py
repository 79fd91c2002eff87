"""HTTP serving daemon for the port's window and clip artifacts and its
streaming bundles (seld_tpu/serving/server.py).

Export once (seld_tpu_torch.inference.export_model), then serve the artifact
from a process with no training code and no checkpoint: stdlib
`http.server` plus a numpy wire format.

Wire protocol (binary request bodies are `.npy`; responses `.npz`):

  GET    /healthz                    JSON {status, units, sessions, ...}
  GET    /metrics                    Prometheus text: per-route request
                                     counters + latency histograms, batch
                                     counters, live-session gauge
  POST   /v1/score[?model=<name>]    npy in -> npz {sed, doa}
                                     (window artifact: x [b, win, F, C];
                                      clip artifact: x [T_clip, F, C];
                                      ?model= routes to a named artifact)
  GET    /v1/models                  JSON {name: {default, path, ...meta}}
  POST   /v1/reload                  hot-swap every artifact (+ streaming
                                     bundle) from its file; live sessions
                                     keep their engine
  POST   /v1/stream/<sid>/push       npy [n, F, C] (or [N, n, F, C]) in ->
                                     npz {sed [k, ...], doa [k, ...]} of
                                     frames that became FINAL this push
  POST   /v1/stream/<sid>/finalize   npz of the remaining frames; frees sid
  DELETE /v1/stream/<sid>            drop a session without finalizing

A bfloat16 body travels as its uint16 bit view with an `X-SELD-Dtype:
bfloat16` header; the server views it back as torch.bfloat16 (no
ml_dtypes needed).

Streaming sessions are created on first push; each shares the bundle's
model (copy.copy of a template engine + reset(), which gives the session
state tensors of its own), so a new session costs microseconds. A global
dispatch lock serializes device work across the threaded server's
handlers (HTTP parsing/serialization still overlaps). A data-parallel
window artifact (export_model --data_parallel N) holds a replica on each
of N cards, and one dispatch spans all N under that lock: the artifact
splits the (padded) static batch into N row blocks and runs them at
once, a worker thread a card.

Dynamic micro-batching (batch_window_ms > 0, window artifacts): concurrent
/v1/score requests
coalesce into ONE device dispatch, row-concatenated on the batch axis.
Greedy-drain policy: requests never idle-wait (solo clients pay zero added
latency); coalescing comes from requests queuing while a dispatch is in
flight. Dispatches chunk at max_batch rows and pad to power-of-two buckets,
bounding the set of batch shapes the device sees. Static-batch artifacts
pad-and-chunk to their exported batch size, which also lifts their
exact-batch restriction.
"""
from __future__ import annotations

import copy
import io
import json
import queue
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

import numpy as np
import torch

MAX_BODY_BYTES = 256 * 1024 * 1024

_STREAM_RE = re.compile(r"^/v1/stream/([A-Za-z0-9_.-]{1,64})/(push|finalize)$")
_STREAM_DEL_RE = re.compile(r"^/v1/stream/([A-Za-z0-9_.-]{1,64})$")

# X-SELD-Dtype names -> (wire view, torch dtype)
_WIRE_DTYPES = {"bfloat16": (np.int16, torch.bfloat16)}


class HTTPError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def _load_npy(body: bytes, dtype_name: Optional[str] = None) -> torch.Tensor:
    """Request body -> host tensor."""
    try:
        arr = np.load(io.BytesIO(body), allow_pickle=False)
    except Exception as e:
        raise HTTPError(400, f"body is not a valid .npy array: {e}")
    if dtype_name and dtype_name != arr.dtype.name:
        # client sent a bfloat16 array as its unsigned bit view
        if dtype_name not in _WIRE_DTYPES:
            raise HTTPError(400, f"unknown X-SELD-Dtype: {dtype_name!r}")
        view, dt = _WIRE_DTYPES[dtype_name]
        if arr.dtype.itemsize != np.dtype(view).itemsize:
            raise HTTPError(400, f"X-SELD-Dtype {dtype_name} itemsize "
                                 f"{np.dtype(view).itemsize} != wire "
                                 f"{arr.dtype.itemsize}")
        return torch.from_numpy(np.ascontiguousarray(arr).view(view)).view(dt)
    if arr.dtype.kind == "V":
        raise HTTPError(400, f"raw void input {arr.dtype}; send the unsigned "
                             "bit view with an X-SELD-Dtype header instead")
    try:
        return torch.from_numpy(np.ascontiguousarray(arr))
    except TypeError as e:
        raise HTTPError(400, f"unsupported input dtype {arr.dtype}: {e}")


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _stack_emits(emits) -> Dict[str, np.ndarray]:
    """[(sed, doa)] -> {'sed': [k, ...], 'doa': [k, ...]} (f32; k may be 0)."""
    if not emits:
        return {"sed": np.zeros((0,), np.float32),
                "doa": np.zeros((0,), np.float32)}
    seds, doas = zip(*emits)
    return {"sed": np.stack([np.asarray(s, np.float32) for s in seds]),
            "doa": np.stack([np.asarray(d, np.float32) for d in doas])}


_LATENCY_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                    1.0, 2.5, 5.0, 10.0)


class _Metrics:
    """Prometheus-text request metrics: per-route counters + latency
    histogram (GET /metrics; text format version 0.0.4)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._requests: Dict[Tuple[str, int], int] = {}
        self._hist: Dict[str, list] = {}
        self._sum: Dict[str, float] = {}

    def observe(self, route: str, code: int, seconds: float):
        with self._lock:
            key = (route, code)
            self._requests[key] = self._requests.get(key, 0) + 1
            h = self._hist.setdefault(route,
                                      [0] * (len(_LATENCY_BUCKETS) + 1))
            for i, ub in enumerate(_LATENCY_BUCKETS):
                if seconds <= ub:
                    h[i] += 1
            h[-1] += 1
            self._sum[route] = self._sum.get(route, 0.0) + seconds

    def render(self, extra_counters: Dict[str, list],
               gauges: Dict[str, float]) -> str:
        """extra_counters: metric name -> [(label_str, value)]."""
        with self._lock:
            lines = ["# TYPE seld_requests_total counter"]
            for (route, code), n in sorted(self._requests.items()):
                lines.append(f'seld_requests_total{{route="{route}",'
                             f'code="{code}"}} {n}')
            lines.append("# TYPE seld_request_seconds histogram")
            for route in sorted(self._hist):
                h = self._hist[route]
                for i, ub in enumerate(_LATENCY_BUCKETS):
                    lines.append(f'seld_request_seconds_bucket{{route='
                                 f'"{route}",le="{ub}"}} {h[i]}')
                lines.append(f'seld_request_seconds_bucket{{route="{route}"'
                             f',le="+Inf"}} {h[-1]}')
                lines.append(f'seld_request_seconds_sum{{route="{route}"}} '
                             f'{self._sum[route]:.6f}')
                lines.append(f'seld_request_seconds_count{{route="{route}"'
                             f'}} {h[-1]}')
        for name, samples in extra_counters.items():
            lines.append(f"# TYPE {name} counter")
            for labels, v in samples:
                lines.append(f"{name}{{{labels}}} {v}")
        for name, v in gauges.items():
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {v}")
        return "\n".join(lines) + "\n"


def _label_escape(value: str) -> str:
    """Escape a Prometheus label VALUE (backslash, quote, newline)."""
    return (value.replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


class _Pending:
    """One queued /v1/score request awaiting a batched dispatch.

    `state` pins the _SlotState the request was validated against; the
    dispatch runs on it, so a concurrent /v1/reload cannot fail requests
    that were valid when enqueued."""
    __slots__ = ("x", "rows", "event", "result", "error", "state")

    def __init__(self, x: torch.Tensor, state: "_SlotState"):
        self.x, self.rows = x, x.shape[0]
        self.event = threading.Event()
        self.result = None
        self.error: Optional[HTTPError] = None
        self.state = state


class _SlotState:
    """One loaded artifact, the number of devices it spans and its content
    hash, swapped as ONE reference."""
    __slots__ = ("artifact", "meta", "nr_devices", "content_hash")

    def __init__(self, artifact, meta, nr_devices, content_hash):
        self.artifact = artifact
        self.meta = meta
        self.nr_devices = nr_devices
        self.content_hash = content_hash


class _ScoreSlot:
    """One loaded score artifact (window or clip unit) + its batcher.

    Slots share the server's dispatch lock (one device, one dispatch at a
    time across every model) but each window-unit slot runs its own
    greedy-drain batcher thread; a clip request is one dispatch. Reload is two-phase (`prepare_reload` loads and validates off to
    the side, `commit_reload` publishes the new state as a single reference
    swap); in-flight dispatches complete on the state they captured."""

    def __init__(self, name: str, path: str, dispatch_lock: threading.Lock,
                 *, batch_window_ms: float = 0.0, max_batch: int = 32,
                 bucket_pad: bool = True, device="cuda"):
        self.name = name
        self.path = path
        self.device = device
        self._dispatch_lock = dispatch_lock
        self.batch_window_ms = float(batch_window_ms)
        self.max_batch = int(max_batch)
        self.bucket_pad = bool(bucket_pad)
        self.batch_stats = {"requests": 0, "dispatches": 0, "rows": 0}
        self._state = self._load_state()
        self._queue: Optional[queue.Queue] = None
        if self.batch_window_ms > 0 and self.meta.get("unit") == "window":
            self._queue = queue.Queue()
            threading.Thread(target=self._batch_loop, daemon=True,
                             name=f"seld-batcher-{name}").start()

    @property
    def artifact(self):
        return self._state.artifact

    @property
    def meta(self) -> dict:
        return self._state.meta

    @property
    def nr_devices(self) -> int:
        return self._state.nr_devices

    def _load_state(self) -> _SlotState:
        import hashlib

        from seld_tpu_torch.inference.export import load_exported
        with open(self.path, "rb") as f:
            digest = hashlib.sha1(f.read()).hexdigest()
        # a data-parallel artifact builds its replicas on every card here,
        # before a reload publishes it
        art = load_exported(self.path, device=self.device)
        return _SlotState(art, dict(art.meta), art.nr_devices, digest)

    def prepare_reload(self) -> _SlotState:
        """Phase 1: load + validate the new artifact WITHOUT publishing."""
        new = self._load_state()
        old_unit, new_unit = self.meta.get("unit"), new.meta.get("unit")
        if new_unit != old_unit:
            # the batcher (or its absence) is wired for the original unit;
            # switching window<->clip needs a fresh slot, not a hot swap
            raise ValueError(f"unit changed {old_unit!r} -> {new_unit!r}; "
                             f"restart to swap artifact units")
        return new

    def commit_reload(self, new: _SlotState) -> dict:
        """Phase 2: publish (single reference swap; cannot fail)."""
        changed = new.content_hash != self._state.content_hash
        self._state = new
        return {"path": self.path, "bytes": new.meta.get("bytes"),
                "changed": changed}

    def _validate(self, x: torch.Tensor, st: _SlotState) -> torch.Tensor:
        art = st.artifact
        per = art.input_shape
        if x.is_complex():
            raise HTTPError(400, f"input dtype {x.dtype} is complex")
        if art.unit == "clip":
            if tuple(x.shape) != per:
                raise HTTPError(400, f"clip artifact wants {list(per)}; "
                                     f"got {tuple(x.shape)}")
            return x.to(art.dtype).contiguous()
        if tuple(x.shape) == per:                  # bare window: add batch
            x = x[None]
        if x.dim() != len(per) + 1 or tuple(x.shape[1:]) != per:
            raise HTTPError(400, f"window artifact wants [b, {per}]; "
                                 f"got {tuple(x.shape)}")
        if x.shape[0] == 0:
            raise HTTPError(400, "empty batch (0 windows)")
        # accept clients that send f32 to a bf16 artifact (and vice versa)
        return x.to(art.dtype).contiguous()

    def score(self, x: torch.Tensor) -> Dict[str, np.ndarray]:
        st = self._state                   # one read
        x = self._validate(x, st)
        if self._queue is not None:
            return self._score_batched(x, st)
        if st.artifact.unit == "window" and st.artifact.batch is not None \
                and x.shape[0] != st.artifact.batch:
            raise HTTPError(400, f"static-batch artifact wants b="
                                 f"{st.artifact.batch}; got {x.shape[0]} "
                                 "(serve with batch_window_ms > 0 to "
                                 "pad-and-chunk)")
        with self._dispatch_lock:
            sed, doa = st.artifact.call(x)
        return {"sed": sed, "doa": doa}

    # ---- dynamic micro-batching ----

    def _score_batched(self, x: torch.Tensor,
                       st: _SlotState) -> Dict[str, np.ndarray]:
        p = _Pending(x, st)
        self._queue.put(p)
        if not p.event.wait(timeout=1200.0):
            raise HTTPError(504, "batched dispatch timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def close(self):
        """Stop the batcher thread (pending requests still complete)."""
        if self._queue is not None:
            self._queue.put(None)

    def _batch_loop(self):
        # Greedy-drain policy: a request never idle-waits. An empty queue
        # dispatches immediately (solo clients pay zero added latency);
        # under concurrent load, requests arriving while a dispatch is in
        # flight drain into the next batch — coalescing via backpressure.
        carry = None
        while True:
            first = carry if carry is not None else self._queue.get()
            carry = None
            if first is None:
                return
            batch = [first]
            while sum(p.rows for p in batch) < self.max_batch:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._dispatch_batch(batch)
                    return
                if nxt.state is not first.state:
                    # reload landed mid-queue: never coalesce requests
                    # validated against different artifacts
                    carry = nxt
                    break
                batch.append(nxt)
            self._dispatch_batch(batch)

    def _chunks(self, total: int, static: Optional[int]):
        """(lo, n, padded rows) per dispatch of a `total`-row batch."""
        size = static or self.max_batch
        for lo in range(0, total, size):
            n = min(size, total - lo)
            if static:
                rows = static
            elif self.bucket_pad:
                rows = 1 << (n - 1).bit_length()
            else:
                rows = n
            yield lo, n, rows

    def _dispatch_batch(self, batch):
        try:
            st = batch[0].state  # the state every request here validated on
            art = st.artifact
            xs = (torch.cat([p.x for p in batch]) if len(batch) > 1
                  else batch[0].x)
            total = xs.shape[0]
            seds, doas = [], []
            with self._dispatch_lock:
                for lo, n, rows in self._chunks(total, art.batch):
                    chunk = xs[lo:lo + n]
                    if rows != n:
                        pad = torch.zeros((rows - n, *chunk.shape[1:]),
                                          dtype=chunk.dtype)
                        chunk = torch.cat([chunk, pad])
                    s, d = art.call(chunk)
                    seds.append(s[:n])
                    doas.append(d[:n])
            sed, doa = np.concatenate(seds), np.concatenate(doas)
            self.batch_stats["requests"] += len(batch)
            self.batch_stats["dispatches"] += len(seds)
            self.batch_stats["rows"] += total
            lo = 0
            for p in batch:
                p.result = {"sed": sed[lo:lo + p.rows],
                            "doa": doa[lo:lo + p.rows]}
                lo += p.rows
        except Exception as e:
            err = e if isinstance(e, HTTPError) else HTTPError(500, repr(e))
            for p in batch:
                p.error = err
        finally:
            for p in batch:
                p.event.set()


class SELDServer:
    """Serves window and clip artifacts and/or a streaming bundle.

    Args:
      artifact: path to the DEFAULT window or clip artifact
        (seld_tpu_torch.inference.export_model), served by bare /v1/score.
      bundle: path to a streaming bundle directory (`--unit stream`),
        served by /v1/stream/<sid>/...
      max_sessions: refuse new streaming sessions beyond this (429).
      artifacts: extra named models, `{name: path}`, served by
        `/v1/score?model=<name>`; each window-unit slot gets its own
        micro-batcher.
        GET /v1/models lists them; POST /v1/reload hot-swaps every slot
        (and the streaming template) from its file, without dropping live
        streaming sessions.
      batch_window_ms: > 0 enables dynamic micro-batching of window
        artifacts (see the module docstring): concurrent /v1/score requests
        coalesce into one device dispatch.
      max_batch: chunk dispatches at this many rows (also the largest
        power-of-two bucket).
      bucket_pad: pad a coalesced dispatch up to the next power of two
        (result rows sliced back), bounding the batch shapes the device
        sees to log2(max_batch) + 1.
      device: where the artifacts and the bundle run; "cuda" unless the
        caller asks for "cpu".
    """

    DEFAULT = "default"

    def __init__(self, artifact: Optional[str] = None,
                 bundle: Optional[str] = None, max_sessions: int = 64,
                 batch_window_ms: float = 0.0, max_batch: int = 32,
                 bucket_pad: bool = True,
                 artifacts: Optional[Dict[str, str]] = None,
                 device="cuda"):
        if not artifact and not bundle and not artifacts:
            raise ValueError("need an artifact and/or a streaming bundle")
        self._dispatch_lock = threading.Lock()   # one device, one dispatch
        self._sessions_lock = threading.Lock()   # session-table mutations
        self.max_sessions = max_sessions
        self.device = device
        slot_kw = dict(batch_window_ms=batch_window_ms, max_batch=max_batch,
                       bucket_pad=bucket_pad, device=device)
        self._slots: Dict[str, _ScoreSlot] = {}
        if artifact:
            self._slots[self.DEFAULT] = _ScoreSlot(
                self.DEFAULT, artifact, self._dispatch_lock, **slot_kw)
        for name, path in (artifacts or {}).items():
            if name in self._slots:
                raise ValueError(f"duplicate model name {name!r}")
            self._slots[name] = _ScoreSlot(name, path, self._dispatch_lock,
                                           **slot_kw)
        # bare /v1/score with no default artifact but exactly one named
        # model serves that model (the unambiguous case)
        self._default_name = (self.DEFAULT if artifact else
                              next(iter(self._slots))
                              if len(self._slots) == 1 else None)

        self._bundle_path = bundle
        self._stream_template = None
        self.bundle_meta: dict = {}
        if bundle:
            from seld_tpu_torch.inference.streaming import StreamingSELD
            self._stream_template = StreamingSELD.from_exported(
                bundle, device=device)
            self.bundle_meta = dict(self._stream_template.meta)
        self._sessions: Dict[str, object] = {}
        self.metrics = _Metrics()
        self.batch_window_ms = float(batch_window_ms)
        self.max_batch = int(max_batch)

    @property
    def _default_slot(self) -> Optional[_ScoreSlot]:
        return self._slots.get(self._default_name)

    @property
    def artifact_meta(self) -> dict:
        s = self._default_slot
        return s.meta if s is not None else {}

    @property
    def batch_stats(self) -> dict:
        s = self._default_slot
        return s.batch_stats if s is not None else {}

    @property
    def nr_devices(self) -> int:
        s = self._default_slot
        return s.nr_devices if s is not None else 1

    # ---- service methods (HTTP-agnostic; raise HTTPError) ----

    def health(self) -> dict:
        slot = self._default_slot
        units = [slot.meta["unit"]] if slot is not None else []
        if self._stream_template is not None:
            units.append("stream")
        out = {"status": "ok", "units": units,
               "sessions": len(self._sessions),
               "artifact_meta": self.artifact_meta,
               "bundle_meta": self.bundle_meta}
        if len(self._slots) > (1 if self._default_name else 0):
            out["models"] = {n: s.meta.get("unit")
                             for n, s in self._slots.items()}
        if slot is not None and slot._queue is not None:
            out["batching"] = {"window_ms": self.batch_window_ms,
                               "max_batch": self.max_batch,
                               **self.batch_stats}
        return out

    def models(self) -> dict:
        """GET /v1/models: every slot's meta (+ whether it's the default)."""
        return {name: {"default": name == self._default_name,
                       "path": slot.path, **slot.meta}
                for name, slot in self._slots.items()}

    def reload(self) -> dict:
        """POST /v1/reload: hot-swap every artifact slot and the streaming
        template from their files. Live streaming sessions keep the engine
        they started with; new sessions get the reloaded bundle.

        All-or-nothing: every artifact (and the bundle) is loaded and
        validated BEFORE any slot is published."""
        prepared = {}
        for name, slot in self._slots.items():
            try:
                prepared[name] = slot.prepare_reload()
            except Exception as e:
                raise HTTPError(500, f"reload {name!r} from {slot.path}: "
                                     f"{e!r} (no artifacts were swapped)")
        new_template = None
        if self._bundle_path:
            from seld_tpu_torch.inference.streaming import StreamingSELD
            try:
                new_template = StreamingSELD.from_exported(
                    self._bundle_path, device=self.device)
            except Exception as e:
                raise HTTPError(500, f"reload bundle from "
                                     f"{self._bundle_path}: {e!r} "
                                     f"(no artifacts were swapped)")
        # commit phase: pure reference swaps, cannot fail
        out = {name: self._slots[name].commit_reload(state)
               for name, state in prepared.items()}
        if new_template is not None:
            self._stream_template = new_template
            self.bundle_meta = dict(new_template.meta)
            out["bundle"] = {"path": self._bundle_path}
        return out

    def metrics_text(self) -> str:
        counters: Dict[str, list] = {}
        for name, slot in self._slots.items():
            label = f'model="{_label_escape(name)}"'
            for k, v in slot.batch_stats.items():
                counters.setdefault(f"seld_batch_{k}_total",
                                    []).append((label, v))
        return self.metrics.render(
            counters, {"seld_stream_sessions": len(self._sessions)})

    def score(self, x: torch.Tensor,
              model: Optional[str] = None) -> Dict[str, np.ndarray]:
        name = model or self._default_name
        slot = self._slots.get(name) if name else None
        if slot is None:
            if model:
                raise HTTPError(404, f"no such model: {model!r} (have "
                                     f"{sorted(self._slots)})")
            raise HTTPError(404, "no score artifact loaded (serve started "
                                 "without --artifact)" if not self._slots
                            else f"multiple models loaded and no default; "
                                 f"pass ?model= (have {sorted(self._slots)})")
        return slot.score(x)

    def close(self):
        """Stop the batcher threads (pending requests still complete)."""
        for slot in self._slots.values():
            slot.close()

    def _get_session(self, sid: str, create: bool):
        with self._sessions_lock:
            eng = self._sessions.get(sid)
            if eng is None:
                if not create:
                    raise HTTPError(404, f"no such stream session: {sid}")
                if self._stream_template is None:
                    raise HTTPError(404, "no streaming bundle loaded (serve "
                                         "started without --bundle)")
                if len(self._sessions) >= self.max_sessions:
                    raise HTTPError(429, f"session limit "
                                         f"({self.max_sessions}) reached")
                eng = copy.copy(self._stream_template)
                eng.reset()
                self._sessions[sid] = eng
            return eng

    def stream_push(self, sid: str, feats: torch.Tensor
                    ) -> Dict[str, np.ndarray]:
        eng = self._get_session(sid, create=True)
        if feats.is_complex():
            raise HTTPError(400, f"input dtype {feats.dtype} is complex")
        with self._dispatch_lock:
            try:
                emits = eng.push(feats.float().numpy())
            except (ValueError, RuntimeError) as e:
                raise HTTPError(400, str(e))
        return _stack_emits(emits)

    def stream_finalize(self, sid: str) -> Dict[str, np.ndarray]:
        eng = self._get_session(sid, create=False)
        with self._dispatch_lock:
            try:
                emits = eng.finalize()
            except (ValueError, RuntimeError) as e:
                raise HTTPError(400, str(e))
        with self._sessions_lock:
            self._sessions.pop(sid, None)
        return _stack_emits(emits)

    def stream_drop(self, sid: str) -> dict:
        with self._sessions_lock:
            existed = self._sessions.pop(sid, None) is not None
        return {"dropped": existed}


def build_handler(service: SELDServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: N802
            pass

        def _reply(self, code: int, ctype: str, body: bytes):
            # Buffered: _timed records the metric first, THEN writes, so a
            # client that scrapes /metrics right after its reply sees its
            # request counted.
            self._pending_reply = (code, ctype, body)
            return code

        def _reply_json(self, code: int, obj: dict):
            return self._reply(code, "application/json",
                               json.dumps(obj).encode())

        def _reply_npz(self, arrays: Dict[str, np.ndarray]):
            return self._reply(200, "application/x-npz",
                               _npz_bytes(**arrays))

        def _route(self) -> str:
            m = _STREAM_RE.match(self.path)
            if m:
                return "/v1/stream/" + m.group(2)
            if _STREAM_DEL_RE.match(self.path):
                return "/v1/stream/drop"
            path = self.path.split("?", 1)[0]
            if path in ("/v1/score", "/v1/models", "/v1/reload",
                        "/healthz", "/metrics"):
                return path
            return "other"

        def _query(self) -> Dict[str, str]:
            if "?" not in self.path:
                return {}
            from urllib.parse import parse_qsl
            return dict(parse_qsl(self.path.split("?", 1)[1]))

        def _timed(self, impl):
            t0 = time.monotonic()
            self._pending_reply = None
            code = 500
            try:
                code = impl()
            finally:
                service.metrics.observe(self._route(), code,
                                        time.monotonic() - t0)
                if self._pending_reply is not None:
                    pcode, ctype, body = self._pending_reply
                    self.send_response(pcode)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

        def _read_body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0) or 0)
            if n <= 0:
                raise HTTPError(400, "missing request body")
            if n > MAX_BODY_BYTES:
                raise HTTPError(413, f"body {n} B > {MAX_BODY_BYTES} B")
            return self.rfile.read(n)

        def _drain_body(self):
            # keep-alive: consume an unused body before replying
            n = int(self.headers.get("Content-Length", 0) or 0)
            if 0 < n <= MAX_BODY_BYTES:
                self.rfile.read(n)

        def do_GET(self):  # noqa: N802
            return self._timed(self._get_impl)

        def _get_impl(self):
            path = self.path.split("?", 1)[0]
            if path == "/healthz":
                return self._reply_json(200, service.health())
            if path == "/metrics":
                return self._reply(200, "text/plain; version=0.0.4",
                                   service.metrics_text().encode())
            if path == "/v1/models":
                return self._reply_json(200, service.models())
            return self._reply_json(404, {"error": f"no route {path}"})

        def do_DELETE(self):  # noqa: N802
            return self._timed(self._delete_impl)

        def _delete_impl(self):
            m = _STREAM_DEL_RE.match(self.path)
            if m:
                return self._reply_json(200, service.stream_drop(m.group(1)))
            return self._reply_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            return self._timed(self._post_impl)

        def _post_impl(self):
            try:
                path = self.path.split("?", 1)[0]
                if path == "/v1/score":
                    x = _load_npy(self._read_body(),
                                  self.headers.get("X-SELD-Dtype"))
                    model = self._query().get("model")
                    return self._reply_npz(service.score(x, model=model))
                if path == "/v1/reload":
                    return self._reply_json(200, service.reload())
                m = _STREAM_RE.match(self.path)
                if m and m.group(2) == "push":
                    feats = _load_npy(self._read_body(),
                                      self.headers.get("X-SELD-Dtype"))
                    return self._reply_npz(service.stream_push(m.group(1),
                                                               feats))
                self._drain_body()
                if m:
                    return self._reply_npz(service.stream_finalize(
                        m.group(1)))
                return self._reply_json(404,
                                        {"error": f"no route {self.path}"})
            except HTTPError as e:
                return self._reply_json(e.code, {"error": str(e)})
            except Exception as e:  # don't kill the connection thread
                return self._reply_json(500, {"error": repr(e)})

    return Handler


def serve(service: SELDServer, host: str = "127.0.0.1", port: int = 8765
          ) -> ThreadingHTTPServer:
    """Bind and return the server (caller runs serve_forever / shutdown)."""
    return ThreadingHTTPServer((host, port), build_handler(service))
