"""HTTP transport: a client of a real Kubernetes apiserver (port of
kserve_tpu/api/http_transport.py, on urllib).

It speaks the Kubernetes REST wire protocol with the standard library
only: create by POST, update by PUT (after a create's 409), status by a
merge-patch of the `status` subresource, list and get at the canonical
paths, and `?watch=true` streams of JSON lines resumed from a
resourceVersion.  An apiserver's 429 (flow control) is retried under the
port's `RetryPolicy`, honouring `Retry-After`.

`HTTPCluster` offers the store surface of the JAX package's FakeCluster
(`apply/get/list/delete/update_status/all_objects`) and `apply_yaml`; the
autoscaler's `DeploymentActuator` and the activator's
`deployment_scaler` drive Deployments through it.  `apply_yaml` needs
PyYAML, which the card machine may lack: it is imported when called.
"""

from __future__ import annotations

import json
import os
import ssl
import time
import urllib.error
import urllib.request
from typing import Dict, Iterator, List, Optional, Tuple

from ..controlplane.gvk import (
    BUILTIN_RESOURCES,
    Resource,
    api_version_of,
    collection_path,
    object_path,
    resource_from_crd,
)
from ..logging import logger
from ..metrics import RETRY_ATTEMPTS
from ..resilience import RetryPolicy, parse_retry_after


def iter_yaml_documents(path: str) -> Iterator[dict]:
    """Every YAML document under a file or a directory tree, sorted and
    multi-document aware, kustomization.yaml skipped (kubectl apply -f
    -R; kserve_tpu/controlplane/objects.py:115).  Raises ValueError for a
    directory with no YAML, and ImportError naming PyYAML without it."""
    try:
        import yaml
    except ImportError:
        raise ImportError("apply_yaml needs PyYAML (the yaml package), "
                          "which is not installed") from None
    paths = []
    if os.path.isdir(path):
        for root, _, files in sorted(os.walk(path)):
            for entry in sorted(files):
                if entry == "kustomization.yaml":
                    continue
                if entry.endswith((".yaml", ".yml")):
                    paths.append(os.path.join(root, entry))
        if not paths:
            raise ValueError(f"no YAML documents under {path!r}")
    else:
        paths = [path]
    for file_path in paths:
        with open(file_path) as f:
            for doc in yaml.safe_load_all(f):
                if doc:
                    yield doc


class APIError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"apiserver returned {status}: {message}")
        self.status = status
        self.message = message


class HTTPCluster:
    """Store-surface client for one apiserver (`base_url`, optional bearer
    token / CA bundle — in-cluster config is read from the standard
    serviceaccount mount when ``in_cluster=True``).

    TLS is verified against `ca_file`.  In-cluster config without the
    mount's ``ca.crt`` is refused, so the serviceaccount token never goes
    out over unverified TLS; an explicit https `base_url` without a CA
    bundle is not verified, with a warning (the JAX transport accepts
    both silently)."""

    SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

    def __init__(self, base_url: str, token: Optional[str] = None,
                 ca_file: Optional[str] = None, in_cluster: bool = False,
                 timeout: float = 30.0):
        if in_cluster:
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            base_url = f"https://{host}:{port}"
            try:
                with open(f"{self.SA_DIR}/token") as f:
                    token = f.read().strip()
            except OSError:
                pass
            ca_file = f"{self.SA_DIR}/ca.crt"
            if not os.path.exists(ca_file):
                raise FileNotFoundError(
                    f"in-cluster config needs {ca_file}: the serviceaccount "
                    "token is not sent over unverified TLS")
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout = timeout
        # apiserver flow control (429) is retried under the shared policy:
        # the request was rejected before execution, so any verb is safe
        self.retry_policy = RetryPolicy(
            max_attempts=3, base_backoff_s=0.2, max_backoff_s=2.0
        )
        self._ssl_ctx = None
        if self.base_url.startswith("https"):
            self._ssl_ctx = ssl.create_default_context(cafile=ca_file)
            if ca_file is None:
                logger.warning("apiserver %s: no CA bundle, TLS certificate "
                               "not verified", self.base_url)
                self._ssl_ctx.check_hostname = False
                self._ssl_ctx.verify_mode = ssl.CERT_NONE
        self._resources: Dict[str, Resource] = dict(BUILTIN_RESOURCES)

    # ---------------- plumbing ----------------

    def _request(self, method: str, path: str, body=None,
                 content_type: str = "application/json",
                 timeout: Optional[float] = None, stream: bool = False):
        url = self.base_url + path
        data = None
        headers = {"Accept": "application/json"}
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = content_type
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(url, data=data, headers=headers,
                                     method=method)
        attempt = 0
        started = time.monotonic()
        while True:
            attempt += 1
            try:
                resp = urllib.request.urlopen(
                    req, timeout=timeout or self.timeout, context=self._ssl_ctx)
                break
            except urllib.error.HTTPError as exc:
                detail = exc.read().decode(errors="replace")
                retry_after = parse_retry_after(exc.headers.get("Retry-After"))
                try:
                    detail = json.loads(detail).get("message", detail)
                except ValueError:
                    pass  # non-JSON error body: keep the raw text
                if exc.code == 429 and not stream:
                    delay = self.retry_policy.next_delay(
                        attempt, retry_after=retry_after,
                        elapsed=time.monotonic() - started)
                    if delay is not None:
                        RETRY_ATTEMPTS.labels(component="cluster").inc()
                        # sync bootstrap/controller client — no event loop
                        time.sleep(delay)
                        continue
                raise APIError(exc.code, detail) from None
        if stream:
            return resp
        with resp:
            payload = resp.read()
        if not payload:
            return {}
        try:
            return json.loads(payload)
        except ValueError:  # non-JSON endpoints (/readyz)
            return {"raw": payload.decode(errors="replace")}

    def _resource(self, kind: str) -> Resource:
        res = self._resources.get(kind)
        if res is None:
            self.refresh_discovery()
            res = self._resources.get(kind)
        if res is None:
            raise KeyError(f"no served resource for kind {kind!r}")
        return res

    def has_kind(self, kind: str) -> bool:
        return kind in self._resources

    def refresh_discovery(self) -> None:
        """Learn CRD-backed kinds from the server (the RESTMapper refresh)."""
        try:
            crds = self.list("CustomResourceDefinition")
        except APIError:
            return
        for crd in crds:
            res = resource_from_crd(crd)
            if res is not None:
                self._resources[res.kind] = res

    # ---------------- FakeCluster store surface ----------------

    def _coords(self, obj: dict):
        res = self._resource(obj.get("kind", ""))
        meta = obj.get("metadata", {})
        ns = meta.get("namespace", "default") if res.namespaced else None
        return res, ns, meta.get("name", "")

    def create(self, obj: dict) -> dict:
        """Strict POST — 409 AlreadyExists raises (leader election and
        anything else racing on create-wins semantics needs this; apply()
        would silently fall through to a replace)."""
        res, ns, _ = self._coords(obj)
        obj = dict(obj)
        obj.setdefault("apiVersion", api_version_of(res))
        return self._request("POST", collection_path(res, ns), obj)

    def replace(self, obj: dict) -> dict:
        """Strict PUT — carries metadata.resourceVersion so a concurrent
        writer surfaces as a 409 Conflict (optimistic concurrency)."""
        res, ns, name = self._coords(obj)
        obj = dict(obj)
        obj.setdefault("apiVersion", api_version_of(res))
        return self._request("PUT", object_path(res, ns, name), obj)

    def apply(self, obj: dict) -> dict:
        try:
            return self.create(obj)
        except APIError as exc:
            if exc.status != 409:
                raise
        # exists → replace (the server preserves the status subresource);
        # drop any stale resourceVersion — apply semantics are last-write-wins
        obj = dict(obj)
        if obj.get("metadata", {}).get("resourceVersion"):
            obj["metadata"] = {k: v for k, v in obj["metadata"].items()
                               if k != "resourceVersion"}
        return self.replace(obj)

    def get(self, kind: str, name: str,
            namespace: str = "default") -> Optional[dict]:
        res = self._resource(kind)
        ns = namespace if res.namespaced else None
        try:
            return self._request("GET", object_path(res, ns, name))
        except APIError as exc:
            if exc.status == 404:
                return None
            raise

    def list_collection(self, kind: str, namespace: Optional[str] = None,
                        label_selector: Optional[str] = None) -> dict:
        """Full <Kind>List response — items plus the collection
        resourceVersion watch loops resume from."""
        res = self._resource(kind)
        ns = namespace if res.namespaced else None
        path = collection_path(res, ns)
        if label_selector:
            from urllib.parse import quote

            path += f"?labelSelector={quote(label_selector)}"
        return self._request("GET", path)

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[str] = None) -> List[dict]:
        return self.list_collection(kind, namespace,
                                    label_selector).get("items", [])

    def delete(self, kind: str, name: str,
               namespace: str = "default") -> bool:
        res = self._resource(kind)
        ns = namespace if res.namespaced else None
        try:
            self._request("DELETE", object_path(res, ns, name))
            return True
        except APIError as exc:
            if exc.status == 404:
                return False
            raise

    def update_status(self, kind: str, name: str, namespace: str,
                      status: dict) -> None:
        res = self._resource(kind)
        ns = namespace if res.namespaced else None
        try:
            self._request(
                "PATCH", object_path(res, ns, name) + "/status",
                {"status": status},
                content_type="application/merge-patch+json")
        except APIError as exc:
            if exc.status == 404:
                logger.debug("status patch target %s/%s gone", kind, name)
            else:
                raise

    def all_objects(self) -> List[dict]:
        """Every object of every known resource type (the reconcilers'
        prune pass needs an ownership sweep; a real controller would use
        per-type informer caches)."""
        out: List[dict] = []
        for kind in list(self._resources):
            try:
                out.extend(self.list(kind))
            except APIError:
                continue
        return out

    # ---------------- watch ----------------

    def watch(self, kind: str, namespace: Optional[str] = None,
              resource_version: Optional[str] = None,
              timeout_seconds: float = 300,
              ) -> Iterator[Tuple[str, dict]]:
        """Yield (event_type, object) from one watch request; returns when
        the server closes the stream (callers loop + resume from the last
        seen resourceVersion)."""
        res = self._resource(kind)
        ns = namespace if res.namespaced else None
        path = (f"{collection_path(res, ns)}?watch=true"
                f"&timeoutSeconds={int(timeout_seconds)}")
        if resource_version:
            path += f"&resourceVersion={resource_version}"
        resp = self._request("GET", path, stream=True,
                             timeout=timeout_seconds + 15)
        with resp:
            for raw in resp:
                line = raw.strip()
                if not line:
                    continue
                try:
                    event = json.loads(line)
                except ValueError:
                    continue
                yield event.get("type", ""), event.get("object", {})

    # ---------------- manifests and readiness ----------------

    def apply_yaml(self, path: str) -> List[dict]:
        applied = [self.apply(doc) for doc in iter_yaml_documents(path)]
        self.refresh_discovery()
        return applied

    def wait_ready(self, timeout: float = 15.0) -> None:
        # readiness probing rides the shared backoff policy (capped by the
        # caller's timeout) instead of a fixed-interval poll
        policy = RetryPolicy(
            max_attempts=10_000, base_backoff_s=0.2, max_backoff_s=1.0,
            retry_budget_s=timeout,
        )
        started = time.monotonic()
        attempt = 0
        while True:
            attempt += 1
            try:
                self._request("GET", "/readyz")
                return
            except (APIError, OSError):
                delay = policy.next_delay(
                    attempt, elapsed=time.monotonic() - started)
                if delay is None:
                    break
                # sync bootstrap client: runs before any event loop exists
                # (manager/agent main() readiness gate)
                time.sleep(delay)
        raise TimeoutError(f"apiserver at {self.base_url} not ready")
