"""Model artifact storage: URI-scheme dispatch and unpack (port of
kserve_tpu/storage/storage.py on urllib).

The scheme table is the JAX package's: file:// and bare paths, pvc://,
Azure blob and file shares (before generic http(s), which would shadow
them), http(s)://, gs://, s3:// and s3a://, hdfs:// and webhdfs://,
hf://, and oci:// / oci+fetch://.  Azure, WebHDFS, OCI and plain http(s)
speak the providers' REST APIs through `urllib.request` (the card machine
has no httpx); gs://, s3:// and hf:// need their SDKs and raise a
StorageError naming the missing package without them.  Archives (tar,
tar.gz, tgz, zip) are exploded in place, as the reference does.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import shutil
import tarfile
import tempfile
import urllib.error
import urllib.request
import zipfile
from typing import Dict, Iterator, List, Optional
from urllib.parse import quote, unquote, urlencode, urlparse

from ..logging import logger

_LOCAL_PREFIX = "file://"
_PVC_PREFIX = "pvc://"
# seconds one exchange may take (httpx's timeout=600 in the JAX package)
_TIMEOUT_S = 600
_CHUNK = 1 << 20


class StorageError(RuntimeError):
    pass


def _require(module: str, provider: str):
    try:
        return __import__(module)
    except ImportError as e:
        raise StorageError(
            f"{provider} download requires the '{module}' package, which is "
            f"not installed in this image"
        ) from e


def _safe_rel(key: str, prefix: str) -> str:
    """Relative path of object `key` under listing `prefix`, refusing any
    result that would escape the output directory.

    Object-store listings match prefixes as strings, so the prefix is
    stripped as a string ('models/foo-a/x.bin' under 'models/foo' is
    '-a/x.bin', as the reference kserve_storage does), never by relpath
    (which would give '../foo-a/x.bin'); anything that still normalizes to
    a parent or absolute path is refused.
    """
    if key == prefix:
        return os.path.basename(key)
    if prefix and key.startswith(prefix):
        rel = key[len(prefix):].lstrip("/")
    else:
        rel = key
    norm = os.path.normpath(rel)
    if not norm or norm == "." or norm.startswith("..") or os.path.isabs(norm):
        raise StorageError(f"unsafe object path {key!r} under prefix {prefix!r}")
    return norm


# STORAGE_CONFIG json field -> the env var a downloader reads (the control
# plane delivers the chosen storage secret entry as STORAGE_CONFIG and the
# storage spec's parameters as STORAGE_OVERRIDE_CONFIG)
_STORAGE_CONFIG_ENV_MAP = {
    "access_key_id": "AWS_ACCESS_KEY_ID",
    "secret_access_key": "AWS_SECRET_ACCESS_KEY",
    "session_token": "AWS_SESSION_TOKEN",
    "endpoint_url": "AWS_ENDPOINT_URL",
    "region": "AWS_DEFAULT_REGION",
    "anonymous": "AWS_ANONYMOUS_CREDENTIAL",
    "verify_ssl": "S3_VERIFY_SSL",
    "certificate": "AWS_CA_BUNDLE",
    "user_name": "HDFS_USER",
    "hdfs_namenode": "HDFS_NAMENODE",
    "access_key": "AZURE_STORAGE_ACCESS_KEY",
}


def _apply_storage_config_env() -> None:
    """Fold STORAGE_CONFIG (the secret's JSON) and STORAGE_OVERRIDE_CONFIG
    (the storage spec's parameters, which win) into the downloaders' env:
    the operator chose this config for this pull, so it overrides the
    ambient env."""
    merged: Dict[str, str] = {}
    for env_name in ("STORAGE_CONFIG", "STORAGE_OVERRIDE_CONFIG"):
        raw = os.getenv(env_name)
        if not raw:
            continue
        try:
            merged.update(json.loads(raw))
        except (TypeError, ValueError):
            raise StorageError(f"{env_name} is not valid JSON")
    for field, env_name in _STORAGE_CONFIG_ENV_MAP.items():
        if field in merged and merged[field] is not None:
            os.environ[env_name] = str(merged[field])


@contextlib.contextmanager
def _get(url: str, headers: Optional[Dict[str, str]] = None,
         params: Optional[Dict[str, str]] = None) -> Iterator:
    """GET `url` (with `params` added to its query), following redirects;
    yields the open response, whatever its status (`.status`, `.headers`,
    and the body to read)."""
    if params:
        url += ("&" if "?" in url else "?") + urlencode(params, quote_via=quote)
    request = urllib.request.Request(url, headers=headers or {}, method="GET")
    try:
        response = urllib.request.urlopen(request, timeout=_TIMEOUT_S)
    except urllib.error.HTTPError as e:
        response = e  # a non-2xx answer: its status, headers and body
    try:
        yield response
    finally:
        response.close()


def _read(url: str, headers=None, params=None):
    """(status, headers, body bytes) of a GET."""
    with _get(url, headers, params) as r:
        return r.status, r.headers, r.read()


def _stream_to(response, dest: str) -> None:
    with open(dest, "wb") as f:
        shutil.copyfileobj(response, f, _CHUNK)


class Storage:
    """`Storage.download(uri, out_dir)` -> local directory with artifacts."""

    @staticmethod
    def download(uri: str, out_dir: Optional[str] = None) -> str:
        if out_dir is None:
            out_dir = tempfile.mkdtemp()
        os.makedirs(out_dir, exist_ok=True)
        logger.info("Downloading %s to %s", uri, out_dir)
        _apply_storage_config_env()
        if uri.startswith(_LOCAL_PREFIX) or uri.startswith("/"):
            return Storage._download_local(uri, out_dir)
        if uri.startswith(_PVC_PREFIX):
            return Storage._download_pvc(uri, out_dir)
        if re.match(r"https?://[^/]+?\.blob\.core\.windows\.net/(.+)", uri):
            # before the generic http(s) branch, or it is unreachable ([^/]
            # keeps a URL whose path merely contains the suffix on http)
            return Storage._download_azure_blob(uri, out_dir)
        if re.match(r"https?://[^/]+?\.file\.core\.windows\.net/(.+)", uri):
            return Storage._download_azure_file(uri, out_dir)
        if uri.startswith(("http://", "https://")):
            return Storage._download_http(uri, out_dir)
        if uri.startswith("gs://"):
            return Storage._download_gcs(uri, out_dir)
        if uri.startswith(("s3://", "s3a://")):
            return Storage._download_s3(uri, out_dir)
        if uri.startswith(("hdfs://", "webhdfs://")):
            return Storage._download_hdfs(uri, out_dir)
        if uri.startswith("hf://"):
            return Storage._download_hf(uri, out_dir)
        if uri.startswith(("oci://", "oci+fetch://")):
            return Storage._download_oci(uri, out_dir)
        raise StorageError(
            f"Cannot recognize storage type for {uri!r}; supported prefixes: "
            "[file://, pvc://, gs://, s3://, hdfs://, webhdfs://, hf://, "
            "oci://, http(s)://]"
        )

    @staticmethod
    def download_files(uris: List[str], out_dirs: List[str]) -> List[str]:
        if len(uris) != len(out_dirs):
            raise StorageError("uris and out_dirs length mismatch")
        return [Storage.download(u, d) for u, d in zip(uris, out_dirs)]

    # ---------------- local-capable providers ----------------

    @staticmethod
    def _download_local(uri: str, out_dir: str) -> str:
        path = uri[len(_LOCAL_PREFIX):] if uri.startswith(_LOCAL_PREFIX) else uri
        if not os.path.exists(path):
            raise StorageError(f"local path {path} does not exist")
        if os.path.isdir(path):
            for entry in sorted(glob.glob(os.path.join(path, "*"))):
                dest = os.path.join(out_dir, os.path.basename(entry))
                if os.path.isdir(entry):
                    shutil.copytree(entry, dest, dirs_exist_ok=True)
                else:
                    shutil.copy2(entry, dest)
                    _maybe_unpack(dest, out_dir)
        else:
            dest = os.path.join(out_dir, os.path.basename(path))
            shutil.copy2(path, dest)
            _maybe_unpack(dest, out_dir)
        return out_dir

    @staticmethod
    def _download_pvc(uri: str, out_dir: str) -> str:
        # pvc://{name}/{path}: the storage-initializer injector mounts the
        # claim at /mnt/pvc/{name}
        rest = uri[len(_PVC_PREFIX):]
        pvc_name, _, subpath = rest.partition("/")
        local = os.path.join("/mnt", "pvc", pvc_name, subpath)
        return Storage._download_local(local, out_dir)

    @staticmethod
    def _download_http(uri: str, out_dir: str) -> str:
        name = os.path.basename(urlparse(uri).path) or "model"
        dest = os.path.join(out_dir, name)
        with _get(uri) as r:
            if r.status != 200:
                raise StorageError(f"GET {uri} -> HTTP {r.status}")
            _stream_to(r, dest)
        _maybe_unpack(dest, out_dir)
        return out_dir

    @staticmethod
    def _download_hf(uri: str, out_dir: str) -> str:
        """hf://{org}/{repo}[:revision] through huggingface_hub where it is
        installed (HF_HUB_OFFLINE caches honoured)."""
        try:
            from huggingface_hub import snapshot_download
        except ImportError as e:
            raise StorageError(
                "hf:// download requires huggingface_hub, not installed"
            ) from e
        spec = uri[len("hf://"):]
        repo, _, revision = spec.partition(":")
        snapshot_download(
            repo_id=repo, revision=revision or None, local_dir=out_dir
        )
        return out_dir

    @staticmethod
    def _download_oci(uri: str, out_dir: str) -> str:
        """oci://registry/repo[:tag|@sha256:...], the `fetch` delivery mode:
        the model image through the OCI distribution HTTP API (anonymous
        or bearer token), each layer's /models tree extracted, layers in
        manifest order so that later ones overwrite earlier ones.  A 401
        with `WWW-Authenticate: Bearer` runs the token exchange
        ($OCI_REGISTRY_TOKEN is sent upfront when set); TLS unless
        OCI_REGISTRY_PLAIN_HTTP=true (local and test registries)."""
        ref = uri.split("://", 1)[1]
        registry, _, rest = ref.partition("/")
        if not rest:
            raise StorageError(f"oci uri needs registry/repository: {uri!r}")
        if "@" in rest:
            repo, _, digest_ref = rest.partition("@")
            tag = digest_ref
        else:
            repo, _, tag = rest.rpartition(":")
            if not repo:  # no tag given
                repo, tag = rest, "latest"
        scheme = ("http" if os.getenv("OCI_REGISTRY_PLAIN_HTTP", "").lower()
                  in ("1", "true") else "https")
        base = f"{scheme}://{registry}/v2/{repo}"
        accept = ", ".join((
            "application/vnd.oci.image.manifest.v1+json",
            "application/vnd.docker.distribution.manifest.v2+json",
            "application/vnd.oci.image.index.v1+json",
            "application/vnd.docker.distribution.manifest.list.v2+json",
        ))
        headers: Dict[str, str] = {}
        token = os.getenv("OCI_REGISTRY_TOKEN", "")
        if token:
            headers["Authorization"] = f"Bearer {token}"

        def _authorize(r) -> bool:
            """On a 401, the bearer-token exchange that WWW-Authenticate
            names; True if a token was obtained."""
            if r.status != 401 or "Authorization" in headers:
                return False
            challenge = r.headers.get("www-authenticate", "")
            if not challenge.lower().startswith("bearer "):
                return False
            fields = dict(
                part.split("=", 1)
                for part in challenge[7:].replace('"', "").split(",")
                if "=" in part
            )
            realm = fields.pop("realm", "")
            if not realm:
                return False
            status, _, body = _read(realm, params=fields)
            if status != 200:
                return False
            headers["Authorization"] = f"Bearer {json.loads(body).get('token', '')}"
            return True

        def get_json(url: str, extra=None) -> dict:
            for _ in range(2):
                with _get(url, {**headers, **(extra or {})}) as r:
                    if r.status == 200:
                        return json.loads(r.read())
                    status = r.status
                    if not _authorize(r):
                        break
            raise StorageError(f"GET {url} -> HTTP {status}")

        def fetch_blob(url: str) -> str:
            """A layer blob streamed to a temp file (multi-GB weights never
            buffer in the initializer's memory)."""
            for _ in range(2):
                with _get(url, dict(headers)) as r:
                    if r.status == 200:
                        fd, tmp = tempfile.mkstemp(prefix="oci-layer-")
                        with os.fdopen(fd, "wb") as f:
                            shutil.copyfileobj(r, f, _CHUNK)
                        return tmp
                    status = r.status
                    if not _authorize(r):
                        break
            raise StorageError(f"GET {url} -> HTTP {status}")

        manifest = get_json(f"{base}/manifests/{tag}", extra={"Accept": accept})
        if "manifests" in manifest:  # an image index: the first linux entry
            chosen = manifest["manifests"][0]
            for m in manifest["manifests"]:
                if m.get("platform", {}).get("os") == "linux":
                    chosen = m
                    break
            manifest = get_json(f"{base}/manifests/{chosen['digest']}",
                                extra={"Accept": accept})
        layers = manifest.get("layers", [])
        if not layers:
            raise StorageError(f"manifest for {uri!r} has no layers")
        found = 0
        for layer in layers:
            tmp = fetch_blob(f"{base}/blobs/{layer['digest']}")
            try:
                media = layer.get("mediaType", "")
                with open(tmp, "rb") as probe:
                    magic = probe.read(2)
                if "zstd" in media:
                    raise StorageError("zstd OCI layers are not supported")
                mode = "r:gz" if ("gzip" in media or magic == b"\x1f\x8b") else "r:"
                with tarfile.open(tmp, mode=mode) as tf:
                    for member in tf:
                        path = member.name.lstrip("./")
                        if not path.startswith("models/"):
                            continue
                        rel = _safe_rel(path, "models")
                        dest = os.path.join(out_dir, rel)
                        if member.isdir():
                            os.makedirs(dest, exist_ok=True)
                            continue
                        if member.issym() or member.islnk() or not member.isfile():
                            continue  # links inside images are skipped (unsafe)
                        os.makedirs(os.path.dirname(dest) or out_dir, exist_ok=True)
                        src = tf.extractfile(member)
                        if src is None:
                            continue
                        with open(dest, "wb") as f:
                            shutil.copyfileobj(src, f)
                        found += 1
            finally:
                os.unlink(tmp)
        if found == 0:
            raise StorageError(
                f"image {uri!r} has no files under /models — not a "
                "modelcar image")
        return out_dir

    # ---------------- SDK-gated providers ----------------

    @staticmethod
    def _download_gcs(uri: str, out_dir: str) -> str:
        _require("google.cloud.storage", "gs://")
        from google.cloud import storage as gcs_storage  # type: ignore

        parsed = urlparse(uri)
        bucket_name, prefix = parsed.netloc, parsed.path.lstrip("/")
        bucket = gcs_storage.Client().bucket(bucket_name)
        count = 0
        for blob in bucket.list_blobs(prefix=prefix):
            if blob.name.endswith("/"):
                continue
            dest = os.path.join(out_dir, _safe_rel(blob.name, prefix))
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            blob.download_to_filename(dest)
            _maybe_unpack(dest, out_dir)
            count += 1
        if count == 0:
            raise StorageError(f"no objects under {uri}")
        return out_dir

    @staticmethod
    def _download_s3(uri: str, out_dir: str) -> str:
        _require("boto3", "s3://")
        import boto3  # type: ignore

        parsed = urlparse(uri)
        bucket, prefix = parsed.netloc, parsed.path.lstrip("/")
        kwargs = {}
        if os.getenv("AWS_ENDPOINT_URL"):
            kwargs["endpoint_url"] = os.getenv("AWS_ENDPOINT_URL")
        s3 = boto3.client("s3", **kwargs)
        count = 0
        for page in s3.get_paginator("list_objects_v2").paginate(
                Bucket=bucket, Prefix=prefix):
            for obj in page.get("Contents", []):
                key = obj["Key"]
                if key.endswith("/"):
                    continue
                dest = os.path.join(out_dir, _safe_rel(key, prefix))
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                s3.download_file(bucket, key, dest)
                _maybe_unpack(dest, out_dir)
                count += 1
        if count == 0:
            raise StorageError(f"no objects under {uri}")
        return out_dir

    @staticmethod
    def _download_hdfs(uri: str, out_dir: str) -> str:
        """hdfs:// and webhdfs:// through the WebHDFS REST API.  An hdfs://
        URI's port is the NameNode RPC port, so its REST port comes from
        $HDFS_WEBHDFS_PORT (9870 by default); auth is the simple
        `user.name` parameter from $HDFS_USER when set."""
        parsed = urlparse(uri)
        host = parsed.hostname or "localhost"
        if uri.startswith("hdfs://"):
            port = int(os.getenv("HDFS_WEBHDFS_PORT", "9870"))
        else:
            port = parsed.port or int(os.getenv("HDFS_WEBHDFS_PORT", "9870"))
        base = f"http://{host}:{port}/webhdfs/v1"
        params: Dict[str, str] = {}
        if os.getenv("HDFS_USER"):
            params["user.name"] = os.environ["HDFS_USER"]

        def q(path: str) -> str:
            # percent-encode the segments ('%', '#', '?', spaces); '/'
            # stays a separator
            return quote(path, safe="/")

        def list_status(path: str) -> List[dict]:
            status, _, body = _read(base + q(path), params={**params, "op": "LISTSTATUS"})
            if status != 200:
                raise StorageError(f"webhdfs LISTSTATUS {path} -> HTTP {status}")
            return json.loads(body)["FileStatuses"]["FileStatus"]

        def fetch_file(path: str, dest: str) -> None:
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            with _get(base + q(path), params={**params, "op": "OPEN"}) as r:
                if r.status != 200:
                    raise StorageError(f"webhdfs OPEN {path} -> HTTP {r.status}")
                _stream_to(r, dest)
            _maybe_unpack(dest, out_dir)

        # the URI's path arrives percent-encoded: decode once, as q()
        # encodes again ('%20' must not become '%2520')
        root = unquote(parsed.path) or "/"
        count = 0
        stack = [(root, "")]
        while stack:
            path, rel = stack.pop()
            for st in list_status(path):
                name = st["pathSuffix"] or os.path.basename(path)
                sub_rel = os.path.join(rel, name) if rel else name
                sub_path = (path.rstrip("/") + "/" + st["pathSuffix"]
                            if st["pathSuffix"] else path)
                if st["type"] == "DIRECTORY":
                    stack.append((sub_path, sub_rel))
                else:
                    fetch_file(sub_path, os.path.join(out_dir, _safe_rel(sub_rel, "")))
                    count += 1
        if count == 0:
            raise StorageError(f"no files under {uri}")
        return out_dir

    @staticmethod
    def _download_azure_blob(uri: str, out_dir: str) -> str:
        """Azure Blob through the Blob service REST API: public containers
        anonymously, private ones with $AZURE_STORAGE_SAS_TOKEN;
        $KSERVE_AZURE_BLOB_ENDPOINT overrides the account endpoint
        (emulators, local fakes)."""
        import xml.etree.ElementTree as ET

        m = re.match(r"https?://(.+?)\.blob\.core\.windows\.net/([^/]+)/?(.*)", uri)
        if not m:
            raise StorageError(f"unrecognized azure blob uri {uri!r}")
        account, container, prefix = m.group(1), m.group(2), m.group(3)
        endpoint = os.getenv(
            "KSERVE_AZURE_BLOB_ENDPOINT",
            f"https://{account}.blob.core.windows.net",
        ).rstrip("/")
        sas = os.getenv("AZURE_STORAGE_SAS_TOKEN", "").lstrip("?")

        def list_blobs() -> List[str]:
            names: List[str] = []
            marker = ""
            while True:
                params = {"restype": "container", "comp": "list", "prefix": prefix}
                if marker:
                    params["marker"] = marker
                url = f"{endpoint}/{container}" + (f"?{sas}" if sas else "")
                status, _, body = _read(url, params=params)
                if status != 200:
                    raise StorageError(f"azure list {container} -> HTTP {status}")
                tree = ET.fromstring(body)
                for blob in tree.iter("Blob"):
                    name = blob.findtext("Name")
                    if name and not name.endswith("/"):
                        names.append(name)
                marker = tree.findtext("NextMarker") or ""
                if not marker:
                    return names

        count = 0
        for name in list_blobs():
            dest = os.path.join(out_dir, _safe_rel(name, prefix))
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            # blob names may hold '?', '#' and '%': quote all but '/'
            url = (f"{endpoint}/{container}/{quote(name, safe='/')}"
                   + (f"?{sas}" if sas else ""))
            with _get(url) as r:
                if r.status != 200:
                    raise StorageError(f"azure GET {name} -> HTTP {r.status}")
                _stream_to(r, dest)
            _maybe_unpack(dest, out_dir)
            count += 1
        if count == 0:
            raise StorageError(f"no blobs under {uri}")
        return out_dir

    @staticmethod
    def _download_azure_file(uri: str, out_dir: str) -> str:
        """An Azure File share through the File service REST API, walked
        one directory level at a time (`restype=directory&comp=list`);
        $AZURE_STORAGE_SAS_TOKEN authenticates private shares and
        $KSERVE_AZURE_FILE_ENDPOINT overrides the endpoint.  A URI naming a
        single file (the archive layout) falls back to a plain GET."""
        import xml.etree.ElementTree as ET

        m = re.match(
            r"https?://([^/]+?)\.file\.core\.windows\.net/([^/]+)/?(.*)", uri)
        if not m:
            raise StorageError(f"unrecognized azure file uri {uri!r}")
        account, share = m.group(1), m.group(2)
        # decode once so that quote() on the wire does not double-encode
        prefix = unquote(m.group(3).rstrip("/"))
        endpoint = os.getenv(
            "KSERVE_AZURE_FILE_ENDPOINT",
            f"https://{account}.file.core.windows.net",
        ).rstrip("/")
        sas = os.getenv("AZURE_STORAGE_SAS_TOKEN", "").lstrip("?")

        def url_of(path: str) -> str:
            return (f"{endpoint}/{share}/{quote(path, safe='/')}"
                    + (f"?{sas}" if sas else ""))

        def fetch_file(full: str, rel: str) -> None:
            dest = os.path.join(out_dir, rel)
            os.makedirs(os.path.dirname(dest) or out_dir, exist_ok=True)
            with _get(url_of(full)) as r:
                if r.status != 200:
                    raise StorageError(f"azure file GET {full} -> HTTP {r.status}")
                _stream_to(r, dest)
            _maybe_unpack(dest, out_dir)

        def list_dir(path: str):
            """(files, subdirs) one level down, following NextMarker (the
            service caps a response at 5,000 entries)."""
            files: List[str] = []
            dirs: List[str] = []
            marker = ""
            while True:
                params = {"restype": "directory", "comp": "list"}
                if marker:
                    params["marker"] = marker
                status, _, body = _read(url_of(path), params=params)
                if status != 200:
                    raise StorageError(f"azure file list {path!r} -> HTTP {status}")
                tree = ET.fromstring(body)
                files.extend(f.findtext("Name") for f in tree.iter("File")
                             if f.findtext("Name"))
                dirs.extend(d.findtext("Name") for d in tree.iter("Directory")
                            if d.findtext("Name"))
                marker = tree.findtext("NextMarker") or ""
                if not marker:
                    return files, dirs

        try:
            root_files, root_dirs = list_dir(prefix)
        except StorageError:
            fetch_file(prefix, os.path.basename(prefix) or "model")
            return out_dir
        count = 0
        stack = [(prefix, root_files, root_dirs)]
        while stack:
            cur, files, dirs = stack.pop()
            for d in dirs:
                sub = f"{cur}/{d}" if cur else d
                stack.append((sub, *list_dir(sub)))
            for name in files:
                full = f"{cur}/{name}" if cur else name
                fetch_file(full, _safe_rel(full, prefix))
                count += 1
        if count == 0:
            raise StorageError(f"no files under {uri}")
        return out_dir


def _maybe_unpack(path: str, out_dir: str) -> None:
    """Explode a model archive (tar, tar.gz, tgz, zip) into `out_dir` and
    remove it, as the reference explodes archives into the model mount."""
    if path.endswith((".tar", ".tar.gz", ".tgz")):
        with tarfile.open(path) as tar:
            tar.extractall(out_dir, filter="data")
        os.remove(path)
    elif path.endswith(".zip"):
        with zipfile.ZipFile(path) as z:
            z.extractall(out_dir)
        os.remove(path)
