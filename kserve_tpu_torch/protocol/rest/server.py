"""HTTP/1.1 REST server on `asyncio.start_server` (standard library only).

Port of kserve_tpu/protocol/rest/server.py with its V1, V2 and OpenAI
heads (v1_endpoints.py, v2_endpoints.py, protocol/openai/endpoints.py);
the JAX package's aiohttp stack is not available on the card machine.
The models live in a `ModelRepository`; the V1 and V2 routes go through
its `DataPlane` (protocol/dataplane.py).

Routes:
  GET  /                 {"status": "alive"}
  GET  /v1/models, /v1/models/{m}; POST /v1/models/{m}:predict, :explain
  GET  /v2, /v2/models/{m}, /v2/models/{m}/ready; POST
       /v2/models/{m}[/versions/{v}]/infer (JSON or the binary-tensor
       extension), /v2/repository/models/{m}/load and /unload
  GET  /v2/health/live   200, or 503 once a model's engine is wedged
  GET  /v2/health/ready  503 with {"ready", "lifecycle"} unless READY, else
       503 {"ready": false} unless every model is healthy
  POST /v1/timeseries/forecast, GET /v1/timeseries/models  the
       forecasting head (protocol/timeseries.py; kserve_tpu/protocol/rest/
       server.py:239-245), on every server as in the JAX package
  GET  /openai/v1/models
  POST /openai/v1/completions, /openai/v1/chat/completions
       (JSON, or text/event-stream with `"stream": true`, ending
       `data: [DONE]`), /openai/v1/embeddings, /openai/v1/rerank
       (kserve_tpu/protocol/openai/endpoints.py:140-162); a model is
       looked up as the JAX OpenAI data plane does (dataplane.py:31-39):
       404 unknown, 503 not ready, 400 "does not support this endpoint"
       when it has no method of the route's verb
  GET  /metrics          the engine's series (metrics.py), text format 0.0.4
  GET  /admin/telemetry  per model: TTFT / ITL / queue-wait percentiles and
       recent request timelines, and the profiler's status
       (kserve_tpu/observability/introspection.py:115-126)
  POST /admin/profile    a torch.profiler capture of {"seconds": s} (2 by
       default) into {"dir": d} or $KSERVE_TPU_PROFILE_DIR as a Chrome
       trace, CUDA activity included when an engine is on a CUDA device:
       202 with the target, 409 while one runs, 400 for seconds outside
       (0, 300], 501 without a profiler (observability/introspection.py)
  GET  /v1/internal/scheduler/state  the endpoint picker's view: summed
       queue depth, inflight and free pages, each model's
       engine.scheduler_state(), the lifecycle state, the shed counts and
       the worst TTFT / ITL p99 (kserve_tpu/protocol/rest/server.py:249)
  POST /admin/drain      start the replica's drain (with a lifecycle);
  GET  /admin/drain      reads its state (`?source=prestop` starts it)
  POST /v1/prefill/{model}  a prefill-role model's detached prefill
       (protocol/pd.py): the KV as application/octet-stream with the
       X-KV-Meta header and a Content-Length (kserve_tpu/protocol/pd.py:
       82-102); a model without `handle_prefill` answers 400
  GET  /v1/internal/kv/pages/{digest}  one persisted prefix page in the
       peer fabric's verifiable wire form (kvstore/peer.py), read on a
       worker thread, at most PEER_PAGE_CONCURRENCY at once; 404 for a
       page not held or a digest that is not hex; counts
       kv_peer_pages_served_total (kserve_tpu/protocol/rest/server.py:
       317-345)
The /openai/v1 routes also answer under /openai.

Admission gates, in the JAX server's middleware order (kserve_tpu/
protocol/rest/server.py:79-125, :164-257; lifecycle/middleware.py):
lifecycle (an inference POST while draining: 503 + Retry-After), load
shedding (an inference POST past the queue watermark: 429 + Retry-After),
then the `x-request-deadline` budget (expired: 504, else bound for the
engine's admission).  Errors map as there: InvalidInput and
UnsupportedProtocol 400, ModelNotFound 404, ModelNotReady /
ServerNotReady / ServerNotLive 503, NotImplementedError 501,
InferenceError 500, DeadlineExceededError 504, ReplicaDrainingError 503 +
Retry-After, GenerationPreempted 503 with the checkpoint in the body (and
in `x-generation-checkpoint` while it fits CHECKPOINT_HEADER_SAFE_BYTES).  A streamed answer that is preempted ends
on an event {"error": {"type": "generation_preempted", ...},
"checkpoint": ...} without [DONE] (kserve_tpu/protocol/openai/
endpoints.py:73-88).  The request head may carry a checkpoint header of
up to CHECKPOINT_FIELD_SIZE_LIMIT bytes.  On `/`, `/v1/models...` and
`/v2...` and `/v1/timeseries/...` an error's body is the JAX server's
{"error": reason}; on the
other routes it is the OpenAI form {"error": {"message", "type"}}.

The wire (keep-alive, bodies, the request's trace context and span and
the `x-request-id` echo) is http_server.HTTPServer's; `_route_template`
names a request's span by the JAX server's route templates
("/v2/models/{model_name}/infer", ...).
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, unquote

from ...errors import (
    InferenceError,
    InvalidInput,
    ModelNotFound,
    ModelNotReady,
    ServerNotLive,
    ServerNotReady,
    UnsupportedProtocol,
)
from ...lifecycle import (
    CHECKPOINT_HEADER,
    CHECKPOINT_HEADER_SAFE_BYTES,
    READY,
    GenerationPreempted,
    ReplicaDrainingError,
    ReplicaLifecycle,
)
from ...kvstore.peer import PAGE_ROUTE
from ...model_repository import ModelRepository
from ...metrics import (
    CONTENT_TYPE_LATEST,
    DEADLINE_REJECTED,
    KV_PEER_PAGES_SERVED,
    SHED_REQUESTS,
    generate_latest,
)
from ...resilience import (
    DEADLINE_HEADER,
    Deadline,
    DeadlineExceededError,
    LoadShedder,
    ShedConfig,
    deadline_scope,
    is_inference_path,
)
from ...observability.introspection import ProfilerSession, profile_route
from ..dataplane import DataPlane
from ..model_repository_extension import ModelRepositoryExtension
from ..openai.types import (
    ChatCompletionRequest,
    CompletionRequest,
    EmbeddingRequest,
    ModelCard,
    ModelList,
    RerankRequest,
    error_body,
)
from ..pd import KV_META_HEADER, PREFILL_ROUTE, parse_prefill_body
from ..timeseries import ForecastRequest, TimeSeriesDataPlane
from .http_server import (  # noqa: F401 — MAX_HEAD_BYTES: tests read it here
    IDLE_TIMEOUT_S,
    MAX_HEAD_BYTES,
    HTTPError as _HTTPError,
    HTTPServer,
    request_span,
)
from .v1_endpoints import V1Endpoints
from .v2_endpoints import V2Endpoints

logger = logging.getLogger(__name__)

# peer page reads at once, so that cold peers cannot starve local decoding
# of disk bandwidth and worker threads
PEER_PAGE_CONCURRENCY = 4

# OpenAI route -> (request type, the model's verb)
_OPENAI_ROUTES = {
    "/openai/v1/completions": (CompletionRequest, "create_completion"),
    "/openai/v1/chat/completions": (ChatCompletionRequest, "create_chat_completion"),
    "/openai/v1/embeddings": (EmbeddingRequest, "create_embedding"),
    "/openai/v1/rerank": (RerankRequest, "create_rerank"),
}


# routes whose path is its own template
_FIXED_ROUTES = frozenset({
    "/", "/v2/health/live", "/v2/health/ready", "/openai/v1/models", "/metrics",
    "/admin/telemetry", "/admin/profile", "/admin/drain",
    "/v1/internal/scheduler/state", "/v1/timeseries/forecast",
    "/v1/timeseries/models", *_OPENAI_ROUTES})
# a V1 / V2 pattern's name groups, in order
_GROUP_NAMES = ("{model_name}", "{model_version}")


def _template_of(pattern: "re.Pattern") -> str:
    """The aiohttp-style template of a V1 / V2 route pattern."""
    names = iter(_GROUP_NAMES)
    return re.sub(r"\([^)]*\)", lambda _: next(names), pattern.pattern)


def _jax_error_form(path: str) -> bool:
    """The routes whose error bodies are the JAX server's {"error": reason}."""
    return path == "/" or path == "/v2" or path.startswith(
        ("/v1/models", "/v2/", "/v1/timeseries/"))


class RESTServer(HTTPServer):
    """Serves the models of `repository`.  A generative model has `name`, `ready`, `async
    create_completion(req, headers)` and `async
    create_chat_completion(req, headers)` (returning a response object or,
    for a streamed request, an async iterator of chunks), and optionally
    `async live()`, `async healthy()` and an `engine`; an encoder model has
    `async create_embedding(req, headers)` and `async create_rerank(req,
    headers)`; a predictive model
    is a `Model` (model.py) answering the V1 and V2 routes.  `lifecycle`
    (a ReplicaLifecycle) turns on the drain gate and the /admin/drain
    routes, whose POST starts `on_drain()` (an async callable) once.  `shed_config` sets the
    load-shedding watermark (default: from the environment)."""

    def __init__(self, repository: ModelRepository,
                 host: str = "0.0.0.0",
                 port: int = 8080, idle_timeout: float = IDLE_TIMEOUT_S,
                 lifecycle: Optional[ReplicaLifecycle] = None,
                 on_drain: Optional[Callable] = None,
                 shed_config: Optional[ShedConfig] = None):
        super().__init__(host, port, idle_timeout)
        self.repository = repository
        self.dataplane = DataPlane(self.repository)
        self.timeseries = TimeSeriesDataPlane(self.repository)
        # (method, path pattern, handler) of the V1 and V2 heads
        self._dataplane_routes = (
            V1Endpoints(self.dataplane).routes
            + V2Endpoints(self.dataplane,
                          ModelRepositoryExtension(self.repository)).routes)
        self.lifecycle = lifecycle
        self.on_drain = on_drain
        # inference POSTs bounce 429 once the summed engine queue reaches
        # the watermark (KSERVE_TPU_SHED_WATERMARK; <= 0 disables)
        self.shedder = LoadShedder(
            shed_config or ShedConfig.from_env(),
            on_shed=lambda: SHED_REQUESTS.labels(component="rest").inc())
        # the running drain task (a bare create_task is weakly held)
        self._drain_tasks: list = []
        self._peer_page_sem: Optional[asyncio.Semaphore] = None
        self.profiler = ProfilerSession(cuda=self._on_cuda)
        # (compiled pattern, template) of the V1 / V2 routes
        self._templates = [(p, _template_of(p)) for _, p, _ in self._dataplane_routes]

    def _on_cuda(self) -> bool:
        """Whether a model's engine, or the model, is on a CUDA device."""
        for model in self.models.values():
            device = getattr(getattr(model, "engine", None), "device", None)
            device = device if device is not None else getattr(model, "device", None)
            if getattr(device, "type", device) == "cuda":
                return True
        return False

    def _route_template(self, method: str, path: str) -> Tuple[str, Optional[str]]:
        if path.startswith("/openai/") and not path.startswith("/openai/v1/"):
            path = "/openai/v1/" + path[len("/openai/"):]
        if path in _FIXED_ROUTES:
            return path, None
        if path.startswith(PREFILL_ROUTE):
            return PREFILL_ROUTE + "{model_name}", path[len(PREFILL_ROUTE):]
        if path.startswith(PAGE_ROUTE + "/"):
            return PAGE_ROUTE + "/{digest}", None
        for pattern, template in self._templates:
            m = pattern.fullmatch(path)
            if m is not None:
                return template, unquote(m.group(1)) if m.groups() else None
        return path, None

    @property
    def models(self) -> Dict[str, object]:
        return self.repository.models

    async def _respond(self, method: str, path: str, query: str, headers,
                       body: bytes, writer, keep_alive: bool) -> None:
        """The gates and the route, with the JAX server's error mapping."""
        try:
            await self._gated(method, path, query, headers, body, writer, keep_alive)
        except (_HTTPError, ConnectionError, asyncio.IncompleteReadError):
            raise  # the wire's to answer
        except DeadlineExceededError as e:
            await self._send_json(writer, 504, error_body(str(e), "deadline_exceeded"),
                                  keep_alive)
        except ReplicaDrainingError as e:
            # this replica is going away: Retry-After sends the client's
            # retry (or the EPP) to a healthy one
            await self._send_json(writer, 503, error_body(str(e), "replica_draining"),
                                  keep_alive,
                                  headers={"Retry-After": f"{e.retry_after_s:g}"})
        except GenerationPreempted as e:
            # the drain budget expired mid-generation: the body carries the
            # portable checkpoint, the header too while it fits the parsers
            # of stock intermediaries
            out_headers = {"Retry-After": "1"}
            header_form = e.checkpoint.to_header()
            if len(header_form) <= CHECKPOINT_HEADER_SAFE_BYTES:
                out_headers[CHECKPOINT_HEADER] = header_form
            await self._send_json(
                writer, 503, {"error": str(e), "checkpoint": e.checkpoint.to_dict()},
                keep_alive, headers=out_headers)
        except (InvalidInput, UnsupportedProtocol) as e:
            await self._send_error(writer, path, 400, str(e), "invalid_request_error",
                                   keep_alive)
        except ModelNotFound as e:
            message = (e.reason if _jax_error_form(path)
                       else f"model {e.model_name!r} is not served here")
            await self._send_error(writer, path, 404, message, "not_found", keep_alive)
        except (ModelNotReady, ServerNotReady, ServerNotLive) as e:
            await self._send_error(writer, path, 503, str(e), "not_ready", keep_alive)
        except NotImplementedError as e:
            await self._send_error(writer, path, 501, str(e) or "Not implemented",
                                   "not_implemented", keep_alive)
        except InferenceError as e:
            await self._send_error(writer, path, 500, str(e), "internal_error",
                                   keep_alive)

    async def _on_error(self, exc: Exception, path: str, writer,
                        keep_alive: bool) -> None:
        logger.error("request failed", exc_info=exc)
        message = f"{type(exc).__name__}: {exc}" if _jax_error_form(path) else str(exc)
        await self._send_error(writer, path, 500, message, "internal_error", keep_alive)

    async def _send_error(self, writer, path: str, status: int, message: str,
                          err_type: str, keep_alive: bool) -> None:
        body = ({"error": message} if _jax_error_form(path)
                else error_body(message, err_type))
        await self._send_json(writer, status, body, keep_alive)

    def _event(self, obj) -> bytes:
        return self._chunk(f"data: {json.dumps(obj)}\n\n".encode("utf-8"))

    async def _send_sse(self, writer, chunks, keep_alive: bool) -> None:
        """Server-sent events in a chunked body: one chunk per event, then
        `data: [DONE]` and the last chunk.  A stream that fails ends on an
        error event instead of [DONE]: a preempted one's carries the
        checkpoint the client resumes elsewhere (its header form), and it
        splices the continuation after what it already has."""
        writer.write(self._head(200, "text/event-stream", None, keep_alive))
        await writer.drain()
        try:
            async for chunk in chunks:
                writer.write(self._event(chunk.to_dict()))
                await writer.drain()
            writer.write(self._chunk(b"data: [DONE]\n\n"))
        except ConnectionError:
            raise
        except GenerationPreempted as e:
            writer.write(self._event({
                "error": {"type": "generation_preempted", "message": str(e)},
                "checkpoint": e.checkpoint.to_header()}))
        except ReplicaDrainingError as e:
            # a drain landed between admission and the first enqueue: the
            # client retries from the start on a healthy replica
            writer.write(self._event(
                {"error": {"type": "replica_draining", "message": str(e)}}))
        except Exception as e:  # noqa: BLE001 — headers are sent: report in-band
            # a second response cannot follow the headers: the stream ends
            # with an error event and without [DONE]
            logger.exception("mid-stream failure")
            writer.write(self._event(error_body(str(e), "internal_error")))
        finally:
            # a client that went away releases its engine slot now, not at GC
            await chunks.aclose()
        writer.write(b"0\r\n\r\n")
        await writer.drain()

    # ---------------- admission gates ----------------

    async def _gated(self, method: str, path: str, query: str, headers,
                     body: bytes, writer, keep_alive: bool) -> None:
        """The lifecycle, shedding and deadline gates, then the route."""
        lc = self.lifecycle
        if lc is not None:
            if path == "/v2/health/ready" and not lc.ready:
                return await self._send_json(
                    writer, 503, {"ready": lc.state == READY, "lifecycle": lc.state},
                    keep_alive)
            if method == "POST" and is_inference_path(path) and not lc.accepting:
                return await self._send_json(
                    writer, 503,
                    {"error": "replica is draining; retry another replica",
                     "lifecycle": lc.state},
                    keep_alive, headers={"Retry-After": "1"})
        if (method == "POST" and is_inference_path(path)
                and self.shedder.should_shed(self._total_queue_depth())):
            return await self._send_json(
                writer, 429, {"error": "server overloaded, shedding load"},
                keep_alive,
                headers={"Retry-After": f"{self.shedder.retry_after_s:g}"})
        deadline = Deadline.from_header(headers.get(DEADLINE_HEADER))
        if deadline is None:
            return await self._route(method, path, query, headers, body, writer,
                                     keep_alive)
        if deadline.expired:
            DEADLINE_REJECTED.labels(component="rest").inc()
            return await self._send_json(
                writer, 504, {"error": "request deadline exceeded before handling"},
                keep_alive)
        with deadline_scope(deadline):
            return await self._route(method, path, query, headers, body, writer,
                                     keep_alive)

    def _engines(self):
        for name, model in self.models.items():
            engine = getattr(model, "engine", None)
            if engine is not None:
                yield name, engine

    def _total_queue_depth(self) -> int:
        """The summed engine queue depth: the shedding watermark's signal."""
        return sum(int(getattr(e, "queue_depth", 0) or 0) for _, e in self._engines())

    # ---------------- routes ----------------

    async def _route(self, method: str, path: str, query: str, headers, body: bytes,
                     writer, keep_alive: bool) -> None:
        if path.startswith("/openai/") and not path.startswith("/openai/v1/"):
            path = "/openai/v1/" + path[len("/openai/"):]
        if path == "/":
            self._expect(method, "GET")
            return await self._send_json(writer, 200, {"status": "alive"}, keep_alive)
        if path == "/v2/health/live":
            self._expect(method, "GET")
            live = (await self.dataplane.live())["status"] == "alive"
            # non-2xx once wedged: kubelet's probe reads the status code
            return await self._send_json(writer, 200 if live else 503,
                                         {"live": live}, keep_alive)
        if path == "/v2/health/ready":
            self._expect(method, "GET")
            ready = await self.dataplane.ready()
            return await self._send_json(writer, 200 if ready else 503,
                                         {"ready": ready}, keep_alive)
        if path == "/v1/timeseries/forecast":
            self._expect(method, "POST")
            result = await self.timeseries.forecast(
                ForecastRequest.from_json(self._json(body)))
            return await self._send_json(writer, 200, result.to_dict(), keep_alive)
        if path == "/v1/timeseries/models":
            self._expect(method, "GET")
            return await self._send_json(writer, 200, await self.timeseries.models(),
                                         keep_alive)
        if _jax_error_form(path):
            return await self._dataplane_route(method, path, headers, body, writer,
                                               keep_alive)
        if path == "/openai/v1/models":
            self._expect(method, "GET")
            # a model's LoRA adapters list as models of their own (vLLM's
            # semantics; kserve_tpu/protocol/openai/dataplane.py:66-75)
            cards = [ModelCard(id=card) for name, model in self.models.items()
                     for card in (name, *getattr(model, "aliases", ()))]
            return await self._send_json(writer, 200, ModelList(data=cards).to_dict(),
                                         keep_alive)
        if path == "/metrics":
            self._expect(method, "GET")
            return await self._send(writer, 200, CONTENT_TYPE_LATEST,
                                    generate_latest(), keep_alive)
        if path == "/admin/telemetry":
            self._expect(method, "GET")
            return await self._send_json(writer, 200, self._telemetry(), keep_alive)
        if path == "/admin/profile":
            self._expect(method, "POST")
            status, payload = await profile_route(self.profiler, body)
            return await self._send_json(writer, status, payload, keep_alive)
        if path == "/v1/internal/scheduler/state":
            self._expect(method, "GET")
            return await self._send_json(writer, 200, self.scheduler_state(),
                                         keep_alive)
        if path == "/admin/drain" and self.lifecycle is not None:
            return await self._send_json(writer, 200, self._drain_route(method, query),
                                         keep_alive)
        if path.startswith(PREFILL_ROUTE):
            self._expect(method, "POST")
            return await self._prefill(path[len(PREFILL_ROUTE):], body, writer,
                                       keep_alive)
        if path.startswith(PAGE_ROUTE + "/"):
            self._expect(method, "GET")
            return await self._peer_page(path[len(PAGE_ROUTE) + 1:], writer,
                                         keep_alive)
        if path not in _OPENAI_ROUTES:
            raise _HTTPError(404, f"no route for {path}")
        self._expect(method, "POST")
        request_type, verb = _OPENAI_ROUTES[path]
        req = request_type.from_json(self._json(body))
        span = request_span()
        if span is not None and req.model:
            span.set_attribute("kserve.model", req.model)
        result = await getattr(self._openai_model(req.model, verb), verb)(req, headers)
        if getattr(req, "stream", False):
            return await self._send_sse(writer, result, keep_alive)
        return await self._send_json(writer, 200, result.to_dict(), keep_alive)

    async def _dataplane_route(self, method: str, path: str, headers, body: bytes,
                               writer, keep_alive: bool) -> None:
        """A V1 or V2 route: the first pattern that matches the whole path
        (405 if only another method's does)."""
        allowed = None
        for route_method, pattern, handler in self._dataplane_routes:
            m = pattern.fullmatch(path)
            if m is None:
                continue
            if route_method != method:
                allowed = route_method
                continue
            status, obj, extra = await handler(
                headers, body, *(unquote(g) for g in m.groups()))
            if isinstance(obj, (bytes, bytearray)):
                ctype = extra.pop("content-type", "application/octet-stream")
                return await self._send(writer, status, ctype, obj, keep_alive, extra)
            ctype = extra.pop("content-type", None) or "application/json"
            return await self._send(writer, status, ctype,
                                    json.dumps(obj).encode("utf-8"), keep_alive, extra)
        if allowed is not None:
            raise _HTTPError(405, f"method {method} not allowed")
        raise _HTTPError(404, f"no route for {path}")

    async def _prefill(self, name: str, body: bytes, writer, keep_alive: bool) -> None:
        """POST /v1/prefill/{model}: one detached prefill's KV."""
        model = self.models.get(name)
        if model is None or not hasattr(model, "handle_prefill"):
            raise InvalidInput(f"model {name!r} does not serve prefill")
        if not model.ready:
            raise _HTTPError(503, f"model {name!r} is not ready")
        prompt_ids, params, adapter = parse_prefill_body(self._json(body))
        meta_json, payload = await model.handle_prefill(prompt_ids, params,
                                                        adapter=adapter)
        await self._send(writer, 200, "application/octet-stream", payload,
                         keep_alive, headers={KV_META_HEADER: meta_json})

    async def _peer_page(self, digest_hex: str, writer, keep_alive: bool) -> None:
        """GET /v1/internal/kv/pages/{digest}: the first engine holding the
        page serves its wire form, read on a worker thread."""
        try:
            digest = bytes.fromhex(digest_hex)
        except ValueError:
            return await self._send_json(writer, 404, error_body(
                "not a page digest", "not_found"), keep_alive)
        if self._peer_page_sem is None:
            self._peer_page_sem = asyncio.Semaphore(PEER_PAGE_CONCURRENCY)
        async with self._peer_page_sem:
            for _, engine in self._engines():
                reader = getattr(engine, "read_peer_page", None)
                if reader is None:
                    continue
                wire = await asyncio.to_thread(reader, digest)
                if wire is not None:
                    KV_PEER_PAGES_SERVED.inc()
                    return await self._send(writer, 200, "application/octet-stream",
                                             wire, keep_alive)
        await self._send_json(writer, 404, error_body("page not resident", "not_found"),
                              keep_alive)

    def scheduler_state(self) -> dict:
        """The GET /v1/internal/scheduler/state payload (kserve_tpu/protocol/
        rest/server.py:249-291)."""
        models = {name: e.scheduler_state() for name, e in self._engines()
                  if hasattr(e, "scheduler_state")}
        telemetry = [m.get("telemetry") or {} for m in models.values()]

        def worst(key: str):
            vals = [t.get(key) for t in telemetry if t.get(key) is not None]
            return max(vals) if vals else None

        return {
            "queue_depth": sum(m["queue_depth"] for m in models.values()),
            "inflight": sum(m.get("inflight", 0) for m in models.values()),
            "free_pages": sum(m["free_pages"] for m in models.values()),
            "models": models,
            "lifecycle": self.lifecycle.state if self.lifecycle is not None else READY,
            "shed": {"count": self.shedder.shed_count,
                     "shedding": self.shedder.shedding},
            "telemetry": {"ttft_p99_s": worst("ttft_p99_s"),
                          "itl_p99_s": worst("itl_p99_s")},
        }

    def _drain_route(self, method: str, query: str) -> dict:
        """POST /admin/drain flips to DRAINING (idempotent) and starts
        `on_drain` once; it answers at once with the state and the budget
        left.  GET reads the drain's state: kubelet's preStop httpGet hook
        drains only with `?source=prestop`, so a stray GET cannot retire a
        healthy replica (kserve_tpu/lifecycle/middleware.py:58-102)."""
        lc = self.lifecycle
        if method == "POST" or (
                method == "GET" and parse_qs(query).get("source") == ["prestop"]):
            first = lc.drain_deadline is None
            deadline = lc.begin_drain()
            if self.on_drain is not None and first:
                self._drain_tasks.append(
                    asyncio.get_running_loop().create_task(self._run_drain()))
            return {"lifecycle": lc.state,
                    "drain_remaining_s": max(deadline.remaining(), 0.0)}
        self._expect(method, "GET")
        deadline = lc.drain_deadline
        return {"lifecycle": lc.state,
                "drain_remaining_s": (max(deadline.remaining(), 0.0)
                                      if deadline is not None else None),
                "hint": "GET is read-only; drain via POST or GET ?source=prestop"}

    async def _run_drain(self) -> None:
        try:
            await self.on_drain()
        except Exception:  # noqa: BLE001 — a failed drain must be loud, not lost
            logger.exception("graceful drain failed")

    def _telemetry(self) -> dict:
        """The GET /admin/telemetry payload: each model's engine
        telemetry_snapshot()."""
        models = {}
        for name, model in self.models.items():
            snap = getattr(getattr(model, "engine", None), "telemetry_snapshot", None)
            if callable(snap):
                models[name] = snap()
        return {"models": models, "profiler": self.profiler.status()}

    @staticmethod
    def _json(body: bytes):
        try:
            return json.loads(body)
        except (ValueError, UnicodeDecodeError) as e:
            raise InvalidInput(f"invalid JSON body: {e}") from None

    def _openai_model(self, name: str, verb: str):
        """The served model of `name`, directly or through an alias (a
        LoRA adapter selects its model by the OpenAI `model` field), that
        has the method `verb`."""
        model = self.repository.get_model(name)
        if model is None:
            raise ModelNotFound(name)
        if not model.ready:
            raise _HTTPError(503, f"model {name!r} is not ready")
        if not callable(getattr(model, verb, None)):
            raise InvalidInput(f"Model {name} does not support this endpoint")
        return model
