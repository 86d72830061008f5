"""Asyncio HTTP front end over the serving engine.

Counterpart of `repro.serving.server`, with the same routes, status codes,
NDJSON stream and drain (stdlib only, a hand-rolled HTTP/1.1 server on
`asyncio.start_server`):

    POST /generate   JSON body (engine.SPEC_KEYS + "stream"). With "stream":
                     true the response is application/x-ndjson, one JSON
                     object per token as it is sampled; otherwise one JSON
                     object with the terminal status and the tokens.
    POST /cancel     {"rid": n} -> {"cancelled": bool}
    GET  /healthz    process liveness (200 while the loop runs)
    GET  /readyz     503 while draining or when the backend has died, else 200
    GET  /metrics    Prometheus text: every numeric stat under `lutnn_serving_`
                     (and `lutnn_replica_*{replica="i"}` behind a router)
    GET  /stats      the same stats as JSON

The engine is synchronous, so `EnginePump` drives it on a daemon thread that
steps it whenever work is queued, diffs its output through `TokenTap` and
fires per-request events, which the asyncio side bridges into per-connection
queues with `call_soon_threadsafe`. Every engine call happens under one lock.
On the card the pump thread runs the CUDA forwards: the engine enters
`torch.inference_mode()` for each forward itself (grad mode is per thread),
and the kernels launch on the current stream, the default one every thread
shares.

Graceful drain (SIGTERM or `FrontEnd.request_shutdown()`): readyz and
/generate answer 503, in-flight requests finish, the server stops.
`serve_forever()` returns 0 after a clean drain, `EXIT_STRANDED` when
`drain_timeout_s` expired with requests unresolved (they are aborted as
"error", so no rid is lost). `EngineSupervisor` and `EngineRouter` implement
the same backend interface as `EnginePump`.

The stats of a local pump (and of a supervised worker) also carry the
kernels' launch counts (`kernels.counters.stats`), so a run can show which
kernels served it.
"""

from __future__ import annotations

import asyncio
import json
import signal
import threading
import time
from typing import Any, Callable

from repro_torch.kernels import counters
from repro_torch.serving.engine import ServingEngine, TokenTap, submit_from_spec
from repro_torch.serving.faults import InjectedKill

# event tuples fired at subscribers, from the pump/monitor thread:
#   ("tokens", list[int])            incremental output
#   ("restart", None)                generation restarted from scratch
#                                    (supervised backend, after a crash)
#   ("done", (status, out_tokens))   terminal
EventCallback = Callable[[tuple[str, Any]], None]

EXIT_STRANDED = 3


class EnginePump:
    """Drives a local ServingEngine on a daemon thread.

    Backend interface (shared with EngineSupervisor):
      submit(spec, on_event) -> rid ; cancel(rid) ; stats() ; pending() ;
      healthy ; close()
    """

    def __init__(self, engine: ServingEngine, *, idle_wait_s: float = 0.02):
        self.engine = engine
        self._tap = TokenTap(engine, consume=True)
        self._subs: dict[int, EventCallback] = {}
        self._live: set[int] = set()
        self._lock = threading.RLock()
        self._wake = threading.Event()
        self._stop = False
        self._dead: BaseException | None = None
        self._idle_wait_s = idle_wait_s
        self._thread = threading.Thread(
            target=self._run, name="engine-pump", daemon=True
        )
        self._thread.start()

    # -- backend interface -------------------------------------------------
    @property
    def healthy(self) -> bool:
        return self._dead is None and not self._stop

    def submit(self, spec: dict[str, Any], on_event: EventCallback | None = None) -> int:
        with self._lock:
            if self._dead is not None:
                raise RuntimeError(f"engine died: {self._dead!r}")
            rid = submit_from_spec(self.engine, spec)
            self._live.add(rid)
            if on_event is not None:
                self._subs[rid] = on_event
        self._wake.set()
        return rid

    def cancel(self, rid: int) -> bool:
        with self._lock:
            hit = self.engine.cancel(rid)
        if hit:
            self._wake.set()       # pump dispatches the "cancelled" done event
        return hit

    def stats(self) -> dict[str, Any]:
        with self._lock:
            s = self.engine.stats()
        s.update(counters.stats())
        s["backend"] = "local"
        s["restarts"] = 0
        s["pending"] = self.pending()
        return s

    def pending(self) -> int:
        with self._lock:
            return len(self._live)

    def close(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=10)

    def abort_pending(self) -> int:
        """Force-resolve every live request with status "error" (used when a
        drain deadline expires). Returns how many were aborted."""
        with self._lock:
            n = len(self.engine.abort_all("error"))
        self._wake.set()
        return n

    # -- pump loop ---------------------------------------------------------
    def _dispatch(self, events: list[tuple[int, tuple[str, Any]]]) -> None:
        for rid, ev in events:
            cb = self._subs.get(rid)
            if cb is not None:
                try:
                    cb(ev)
                except Exception:      # noqa: BLE001 — a bad subscriber
                    pass               # must not kill the pump
            if ev[0] == "done":
                self._subs.pop(rid, None)

    def _run(self) -> None:
        while not self._stop:
            out: list[tuple[int, tuple[str, Any]]] = []
            with self._lock:
                work = self.engine.has_work()
                if work and self._dead is None:
                    try:
                        self.engine.step()
                    except (Exception, InjectedKill) as e:  # noqa: BLE001
                        # unsupervised backend: an engine fault is fatal —
                        # resolve every live rid as "error", refuse new work
                        self._dead = e
                        self.engine.abort_all("error")
                tokens, done = self._tap.poll()
                out.extend((rid, ("tokens", toks)) for rid, toks in tokens)
                for req in done:
                    self._live.discard(req.rid)
                    out.append((req.rid, ("done", (req.status, req.out_tokens))))
            self._dispatch(out)
            if not work:
                self._wake.wait(self._idle_wait_s)
                self._wake.clear()


# ---------------------------------------------------------------------------
# HTTP front end
# ---------------------------------------------------------------------------

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
             405: "Method Not Allowed", 429: "Too Many Requests",
             503: "Service Unavailable"}


def metrics_text(stats: dict[str, Any], prefix: str = "lutnn_serving_") -> str:
    """Prometheus text exposition of every numeric stat.

    A `per_replica` sub-dict (EngineRouter) renders as labelled gauges —
    `lutnn_replica_<stat>{replica="i"}` — one TYPE line per family."""
    lines = []
    for k in sorted(stats):
        v = stats[k]
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        name = prefix + k
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {v}")
    per = stats.get("per_replica")
    if isinstance(per, dict):
        families: dict[str, list[str]] = {}
        for rep in sorted(per, key=lambda r: (len(r), r)):
            for k in sorted(per[rep]):
                v = per[rep][k]
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                families.setdefault(f"lutnn_replica_{k}", []).append(
                    f'lutnn_replica_{k}{{replica="{rep}"}} {v}')
        for name in sorted(families):
            lines.append(f"# TYPE {name} gauge")
            lines.extend(families[name])
    return "\n".join(lines) + "\n"


class FrontEnd:
    def __init__(
        self,
        backend: Any,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        drain_timeout_s: float = 30.0,
    ):
        self.backend = backend
        self.host = host
        self.port = port          # 0 = ephemeral; real port set by start()
        self.drain_timeout_s = drain_timeout_s
        self.draining = False
        self.exit_code = 0
        self._server: asyncio.AbstractServer | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._done = None         # asyncio.Event, created in start()

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._done = asyncio.Event()
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    def install_signal_handlers(self) -> None:
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._loop.add_signal_handler(sig, self.request_shutdown)

    def request_shutdown(self) -> None:
        """Begin a graceful drain: stop admitting, finish in-flight, exit.
        Safe to call more than once; signal-handler and test entry point."""
        if not self.draining:
            self.draining = True
            self._loop.create_task(self._drain())

    async def _drain(self) -> None:
        deadline = time.monotonic() + self.drain_timeout_s
        while self.backend.pending() and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        stranded = self.backend.pending()
        if stranded:
            self.exit_code = EXIT_STRANDED
            abort = getattr(self.backend, "abort_pending", None)
            if abort is not None:
                abort()            # stranded rids still resolve (as "error")
        self._server.close()
        await self._server.wait_closed()
        self._done.set()

    async def serve_forever(self) -> int:
        """Serve until a drain completes; returns the process exit code."""
        await self._done.wait()
        self.backend.close()
        return self.exit_code

    # -- request plumbing --------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request = await reader.readline()
            parts = request.decode("latin-1").split()
            if len(parts) < 2:
                return
            method, path = parts[0].upper(), parts[1]
            headers = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            n = int(headers.get("content-length", "0") or 0)
            if n:
                body = await reader.readexactly(n)
            await self._route(method, path, body, writer)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, RuntimeError):
                pass

    def _respond(self, writer: asyncio.StreamWriter, code: int, payload: Any,
                 content_type: str = "application/json") -> None:
        body = (json.dumps(payload).encode()
                if content_type == "application/json"
                else payload.encode())
        writer.write(
            f"HTTP/1.1 {code} {_REASONS.get(code, '')}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n".encode() + body
        )

    async def _route(self, method: str, path: str, body: bytes,
                     writer: asyncio.StreamWriter) -> None:
        if path == "/healthz":
            self._respond(writer, 200, "ok\n", "text/plain")
        elif path == "/readyz":
            ready = not self.draining and self.backend.healthy
            self._respond(writer, 200 if ready else 503,
                          ("ready\n" if ready else "draining\n"), "text/plain")
        elif path == "/metrics":
            self._respond(writer, 200, metrics_text(self.backend.stats()),
                          "text/plain; version=0.0.4")
        elif path == "/stats":
            self._respond(writer, 200, self.backend.stats())
        elif path == "/generate":
            if method != "POST":
                self._respond(writer, 405, {"error": "POST required"})
            else:
                await self._generate(body, writer)
        elif path == "/cancel":
            if method != "POST":
                self._respond(writer, 405, {"error": "POST required"})
            else:
                try:
                    rid = int(json.loads(body or b"{}")["rid"])
                except (ValueError, KeyError, TypeError):
                    self._respond(writer, 400, {"error": "body must be {'rid': int}"})
                    return
                self._respond(writer, 200, {"cancelled": self.backend.cancel(rid)})
        else:
            self._respond(writer, 404, {"error": f"no route {path}"})

    async def _generate(self, body: bytes, writer: asyncio.StreamWriter) -> None:
        if self.draining or not self.backend.healthy:
            self._respond(writer, 503, {"error": "draining" if self.draining
                                        else "engine unavailable"})
            return
        try:
            spec = json.loads(body or b"{}")
            if not isinstance(spec, dict):
                raise ValueError("body must be a JSON object")
            stream = bool(spec.pop("stream", False))
        except ValueError as e:
            self._respond(writer, 400, {"error": str(e)})
            return

        q: asyncio.Queue = asyncio.Queue()
        loop = self._loop

        def on_event(ev: tuple[str, Any]) -> None:
            loop.call_soon_threadsafe(q.put_nowait, ev)

        try:
            rid = self.backend.submit(spec, on_event)
        except (ValueError, TypeError) as e:
            self._respond(writer, 400, {"error": str(e)})
            return
        except RuntimeError as e:           # backend died between checks
            self._respond(writer, 503, {"error": str(e)})
            return

        if stream:
            await self._stream_events(rid, q, writer)
        else:
            tokens: list[int] = []
            restarts = 0
            while True:
                kind, payload = await q.get()
                if kind == "tokens":
                    tokens.extend(payload)
                elif kind == "restart":
                    tokens.clear()
                    restarts += 1
                elif kind == "done":
                    status, out_tokens = payload
                    resp = {"rid": rid, "status": status, "tokens": out_tokens,
                            "n_tokens": len(out_tokens)}
                    if restarts:
                        resp["restarts"] = restarts
                    code = {"ok": 200, "shed": 429}.get(status, 200)
                    self._respond(writer, code, resp)
                    return

    async def _stream_events(self, rid: int, q: asyncio.Queue,
                             writer: asyncio.StreamWriter) -> None:
        def line(obj: dict) -> bytes:
            return (json.dumps(obj) + "\n").encode()

        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: application/x-ndjson\r\n"
            b"Cache-Control: no-store\r\n"
            b"Connection: close\r\n\r\n"
        )
        writer.write(line({"rid": rid}))
        try:
            await writer.drain()
            while True:
                kind, payload = await q.get()
                if kind == "tokens":
                    for tok in payload:
                        writer.write(line({"rid": rid, "token": tok}))
                elif kind == "restart":
                    # supervised backend restarted generation from scratch:
                    # the client must discard tokens streamed so far
                    writer.write(line({"rid": rid, "restart": True}))
                elif kind == "done":
                    status, out_tokens = payload
                    writer.write(line({"rid": rid, "status": status,
                                       "tokens": out_tokens,
                                       "n_tokens": len(out_tokens)}))
                    await writer.drain()
                    return
                await writer.drain()
        except (ConnectionError, RuntimeError):
            # client went away mid-stream: cancel so the request stops
            # burning decode steps (best effort — it may already be done)
            self.backend.cancel(rid)


async def run_server(
    backend: Any,
    host: str = "127.0.0.1",
    port: int = 8000,
    *,
    drain_timeout_s: float = 30.0,
    signals: bool = True,
    on_started: Callable[["FrontEnd"], None] | None = None,
) -> int:
    """Start a FrontEnd and serve until SIGTERM/SIGINT drains it.
    Returns the process exit code (see module docstring)."""
    fe = FrontEnd(backend, host, port, drain_timeout_s=drain_timeout_s)
    await fe.start()
    if signals:
        fe.install_signal_handlers()
    if on_started is not None:
        on_started(fe)
    return await fe.serve_forever()
