"""The port's model storage and storage initializer (kserve_tpu_torch/
storage/) against the JAX package's on the CPU: the cases of
tests/test_storage.py (local, tar, zip, an unknown scheme, the gated
providers including hf://, `_safe_rel`, Azure blob and file shares,
WebHDFS, STORAGE_CONFIG, OCI with token auth, all on the same fake
servers) run through both, the output trees byte-equal and the errors
alike; plain http(s) from a standard-library file server; and the
initializer's manifest byte-identical to the JAX one for the same tree."""

import asyncio
import functools
import gzip
import hashlib
import http.server
import io
import json
import os
import socket
import subprocess
import sys
import tarfile
import threading
import zipfile
from pathlib import Path

import pytest

from kserve_tpu.storage import initializer as jinit
from kserve_tpu.storage import storage as jstorage
from kserve_tpu_torch.storage import initializer as tinit
from kserve_tpu_torch.storage import storage as tstorage
from test_storage import _FakeCloudHandler, fake_cloud_port  # noqa: F401  (fixture)

REPO = Path(__file__).resolve().parents[1]
MODULES = {"jax": jstorage, "port": tstorage}


def _tree(root) -> dict:
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _both(tmp_path, uri: str) -> dict:
    """`uri` downloaded by the JAX Storage and by the port's into dirs of
    their own; both trees, which must be equal."""
    trees = {}
    for key, mod in MODULES.items():
        out = tmp_path / f"out-{key}"
        assert mod.Storage.download(uri, str(out)) == str(out)
        trees[key] = _tree(out)
    assert trees["port"] == trees["jax"]
    return trees["port"]


def _both_raise(tmp_path, uri: str, match=None) -> str:
    messages = []
    for key, mod in MODULES.items():
        with pytest.raises(mod.StorageError, match=match) as e:
            mod.Storage.download(uri, str(tmp_path / f"out-{key}"))
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    return messages[0]


@pytest.fixture
def model_src(tmp_path):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "model.joblib").write_bytes(b"weights" * 100)
    (src / "meta.json").write_text("{}")
    (src / "sub" / "config.json").write_text('{"a": 1}')
    return src


def _archives(tmp_path, model_src):
    tar_path = tmp_path / "model.tar.gz"
    with tarfile.open(tar_path, "w:gz") as tar:
        tar.add(model_src, arcname=".")
    zip_path = tmp_path / "model.zip"
    with zipfile.ZipFile(zip_path, "w") as z:
        for rel, data in _tree(model_src).items():
            z.writestr(rel, data)
    plain_tar = tmp_path / "model.tar"
    with tarfile.open(plain_tar, "w") as tar:
        tar.add(model_src / "meta.json", arcname="meta.json")
    return {"tar.gz": tar_path, "zip": zip_path, "tar": plain_tar}


@pytest.mark.parametrize("form", ["file_dir", "bare_dir", "bare_file", "tar.gz", "zip",
                                  "tar"])
def test_local_trees_equal_jax(tmp_path, model_src, form):
    archives = _archives(tmp_path, model_src)
    uri = {"file_dir": f"file://{model_src}", "bare_dir": str(model_src),
           "bare_file": str(model_src / "model.joblib")}.get(form) or str(archives[form])
    tree = _both(tmp_path, uri)
    if form in ("file_dir", "bare_dir", "tar.gz", "zip"):
        assert tree == _tree(model_src)
    assert not any(name.endswith((".tar.gz", ".zip", ".tar")) for name in tree)


def test_download_files_and_errors_like_jax(tmp_path, model_src):
    outs = tstorage.Storage.download_files(
        [str(model_src / "meta.json"), str(model_src / "model.joblib")],
        [str(tmp_path / "oa"), str(tmp_path / "ob")])
    assert os.listdir(outs[0]) == ["meta.json"] and os.listdir(outs[1]) == ["model.joblib"]
    with pytest.raises(tstorage.StorageError, match="length mismatch"):
        tstorage.Storage.download_files(["a"], [])
    _both_raise(tmp_path, f"file://{tmp_path}/nope", match="does not exist")
    msg = _both_raise(tmp_path, "ftp://example.com/model", match="Cannot recognize")
    assert "oci://" in msg
    _both_raise(tmp_path, "oci://onlyregistry", match="registry/repository")


@pytest.mark.parametrize("uri,package", [("s3://bucket/model", "boto3"),
                                         ("s3a://bucket/model", "boto3"),
                                         ("gs://bucket/model", "google.cloud.storage"),
                                         ("hf://org/repo:rev", "huggingface_hub")])
def test_gated_providers_name_the_package(tmp_path, monkeypatch, uri, package):
    # blocked in both packages, installed here or not: no download is tried
    for name in ("boto3", "google.cloud.storage", "huggingface_hub"):
        monkeypatch.setitem(sys.modules, name, None)
    msg = _both_raise(tmp_path, uri)
    assert package in msg


def test_safe_rel_like_jax():
    cases = [("models/foobar", "models/foo"), ("models/foo-a/x.bin", "models/foo"),
             ("models/foo/w.bin", "models/foo"), ("models/foo", "models/foo"),
             ("a/b/c.bin", ""), ("weights.bin", "models")]
    for key, prefix in cases:
        assert tstorage._safe_rel(key, prefix) == jstorage._safe_rel(key, prefix)
    assert tstorage._safe_rel("models/foo-a/x.bin", "models/foo") == "-a/x.bin"
    for key, prefix in (("models/foo/../../etc/passwd", "models/foo"), ("/etc/passwd", ""),
                        ("..", "")):
        with pytest.raises(tstorage.StorageError):
            tstorage._safe_rel(key, prefix)
        with pytest.raises(jstorage.StorageError):
            jstorage._safe_rel(key, prefix)


def test_azure_blob_like_jax(tmp_path, fake_cloud_port, monkeypatch):  # noqa: F811
    monkeypatch.setenv("KSERVE_AZURE_BLOB_ENDPOINT", f"http://127.0.0.1:{fake_cloud_port}")
    tree = _both(tmp_path, "https://acct.blob.core.windows.net/models")
    assert tree == {k: v for k, v in _FakeCloudHandler.files.items()}
    # a prefix under the container
    assert _both(tmp_path / "p", "https://acct.blob.core.windows.net/models/sub") == {
        "config.json": b"{}"}


def test_azure_file_share_like_jax(tmp_path, fake_cloud_port, monkeypatch):  # noqa: F811
    monkeypatch.setenv("KSERVE_AZURE_FILE_ENDPOINT", f"http://127.0.0.1:{fake_cloud_port}")
    tree = _both(tmp_path, "https://acct.file.core.windows.net/fileshare/models")
    assert tree == {"weights.bin": b"W" * 64, "sub/config.json": b"{}"}
    # a URI naming a single file: the listing fails, a plain GET follows
    tree = _both(tmp_path / "single", "https://acct.file.core.windows.net/fileshare/single.bin")
    assert tree == {"single.bin": b"S" * 16}


def test_webhdfs_like_jax(tmp_path, fake_cloud_port, monkeypatch):  # noqa: F811
    monkeypatch.setenv("HDFS_USER", "alice")
    tree = _both(tmp_path, f"webhdfs://127.0.0.1:{fake_cloud_port}/model")
    assert tree == {"weights.bin": b"W" * 64, "sub/config.json": b"{}"}
    # an hdfs:// URI's port is the RPC port: REST goes to $HDFS_WEBHDFS_PORT
    monkeypatch.setenv("HDFS_WEBHDFS_PORT", str(fake_cloud_port))
    assert _both(tmp_path / "h", "hdfs://127.0.0.1:8020/model") == tree


def test_storage_config_env_like_jax(monkeypatch):
    monkeypatch.setenv("STORAGE_CONFIG", json.dumps({
        "type": "s3", "access_key_id": "AKID", "secret_access_key": "SK",
        "endpoint_url": "http://minio:9000", "region": "us-x-1", "anonymous": None}))
    monkeypatch.setenv("STORAGE_OVERRIDE_CONFIG", json.dumps({
        "region": "eu-y-2", "user_name": "alice"}))
    keys = sorted(set(tstorage._STORAGE_CONFIG_ENV_MAP.values()))
    assert tstorage._STORAGE_CONFIG_ENV_MAP == jstorage._STORAGE_CONFIG_ENV_MAP
    envs = []
    for mod in (jstorage, tstorage):
        for k in keys:
            monkeypatch.delenv(k, raising=False)
        mod._apply_storage_config_env()
        envs.append({k: os.environ.get(k) for k in keys})
    assert envs[0] == envs[1]
    assert envs[1]["AWS_DEFAULT_REGION"] == "eu-y-2" and envs[1]["HDFS_USER"] == "alice"
    assert envs[1]["AWS_ANONYMOUS_CREDENTIAL"] is None
    monkeypatch.setenv("STORAGE_CONFIG", "{not json")
    with pytest.raises(tstorage.StorageError, match="STORAGE_CONFIG"):
        tstorage._apply_storage_config_env()


def _serve_thread(app):
    """An aiohttp app on a thread of its own: (port, stop)."""
    from aiohttp import web

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def serve():
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(app)
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
        started.set()
        loop.run_forever()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    assert started.wait(5)

    def stop():
        loop.call_soon_threadsafe(loop.stop)
        t.join(timeout=5)

    return port, stop


def _layer(files) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name, payload in files:
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tf.addfile(info, io.BytesIO(payload))
    return gzip.compress(buf.getvalue())


@pytest.fixture
def fake_registry():
    """A registry that demands a bearer token (401 + WWW-Authenticate) and
    serves an image index over a two-layer manifest: the second layer
    overwrites a file of the first; one layer holds paths outside
    /models; and an image without /models."""
    from aiohttp import web

    layers = [_layer([("models/weights.bin", b"W" * 32), ("models/sub/config.json", b"{}"),
                      ("etc/passwd", b"nope")]),
              _layer([("./models/sub/config.json", b'{"v": 2}'),
                      ("models/extra.bin", b"E" * 8)])]
    empty = _layer([("app/bin", b"x")])
    blobs = {"sha256:" + hashlib.sha256(b).hexdigest(): b for b in layers + [empty]}
    digests = list(blobs)
    manifest = {"schemaVersion": 2, "layers": [
        {"mediaType": "application/vnd.oci.image.layer.v1.tar+gzip", "digest": d,
         "size": len(blobs[d])} for d in digests[:2]]}
    index = {"manifests": [{"digest": "sha256:win", "platform": {"os": "windows"}},
                           {"digest": "sha256:lin", "platform": {"os": "linux"}}]}
    seen = {"challenged": 0, "tokens": 0}

    def authorized(request):
        if request.headers.get("Authorization") == "Bearer tok123":
            return True
        seen["challenged"] += 1
        return False

    def challenge(request):
        return web.Response(status=401, headers={"WWW-Authenticate":
            f'Bearer realm="http://127.0.0.1:{request.url.port}/token",'
            'service="reg",scope="repository:org/model:pull"'})

    async def manifests(request):
        if request.match_info["repo"] == "empty":
            return web.json_response({"schemaVersion": 2, "layers": [
                {"mediaType": "application/vnd.oci.image.layer.v1.tar+gzip",
                 "digest": digests[2], "size": len(empty)}]})
        if not authorized(request):
            return challenge(request)
        tag = request.match_info["tag"]
        return web.json_response(index if tag == "v1" else manifest)

    async def blob(request):
        if request.match_info["repo"] != "empty" and not authorized(request):
            return challenge(request)
        body = blobs.get(request.match_info["digest"])
        return web.Response(body=body) if body is not None else web.Response(status=404)

    async def token(request):
        seen["tokens"] += 1
        assert request.query.get("service") == "reg"
        return web.json_response({"token": "tok123"})

    app = web.Application()
    app.router.add_get("/v2/org/{repo}/manifests/{tag}", manifests)
    app.router.add_get("/v2/org/{repo}/blobs/{digest}", blob)
    app.router.add_get("/token", token)
    port, stop = _serve_thread(app)
    yield port, seen
    stop()


def test_oci_pull_with_token_auth_like_jax(tmp_path, fake_registry, monkeypatch):
    port, seen = fake_registry
    monkeypatch.setenv("OCI_REGISTRY_PLAIN_HTTP", "true")
    tree = _both(tmp_path, f"oci://127.0.0.1:{port}/org/model:v1")
    assert tree == {"weights.bin": b"W" * 32, "sub/config.json": b'{"v": 2}',
                    "extra.bin": b"E" * 8}
    assert seen["tokens"] >= 2 and seen["challenged"] >= 2  # each package's exchange
    msg = _both_raise(tmp_path, f"oci://127.0.0.1:{port}/org/empty:v1",
                      match="no files under /models")
    assert "modelcar" in msg
    # a registry token given upfront skips the exchange
    monkeypatch.setenv("OCI_REGISTRY_TOKEN", "tok123")
    before = seen["tokens"]
    _both(tmp_path / "t", f"oci://127.0.0.1:{port}/org/model@sha256:lin")
    assert seen["tokens"] == before


class _Quiet(http.server.SimpleHTTPRequestHandler):
    def log_message(self, *args):
        pass


@pytest.fixture
def file_server(tmp_path, model_src):
    """A standard-library HTTP server over a directory holding the model
    as .tar.gz, .zip and a plain file."""
    root = tmp_path / "www"
    root.mkdir()
    for form, path in _archives(tmp_path, model_src).items():
        os.replace(path, root / f"model.{form}")
    (root / "model.joblib").write_bytes((model_src / "model.joblib").read_bytes())
    server = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(_Quiet, directory=str(root)))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield server.server_address[1]
    server.shutdown()
    server.server_close()


@pytest.mark.parametrize("name", ["model.tar.gz", "model.zip", "model.joblib"])
def test_http_like_jax(tmp_path, model_src, file_server, name):
    tree = _both(tmp_path, f"http://127.0.0.1:{file_server}/{name}")
    want = {"model.joblib": (model_src / "model.joblib").read_bytes()} \
        if name == "model.joblib" else _tree(model_src)
    assert tree == want


def test_http_error_status_like_jax(tmp_path, file_server):
    _both_raise(tmp_path, f"http://127.0.0.1:{file_server}/missing.bin",
                match="HTTP 404")


def test_initializer_manifest_is_the_jax_manifest(tmp_path, model_src):
    archives = _archives(tmp_path, model_src)
    for key, mod in (("jax", jinit), ("port", tinit)):
        assert mod.main(["--manifest", str(archives["tar.gz"]), str(tmp_path / f"a-{key}"),
                         f"file://{model_src}", str(tmp_path / f"b-{key}")]) == 0
        assert mod.main(["only-one"]) == 2 and mod.main(["a", "b", "c"]) == 2
    for d in ("a", "b"):
        port = (tmp_path / f"{d}-port" / tinit.MANIFEST_NAME).read_bytes()
        assert port == (tmp_path / f"{d}-jax" / jinit.MANIFEST_NAME).read_bytes()
        files = json.loads(port)["files"]
        assert files == {k: len(v) for k, v in _tree(model_src).items()}
        assert _tree(tmp_path / f"{d}-port") == _tree(tmp_path / f"{d}-jax")


def test_initializer_cli(tmp_path, model_src):
    """`python -m kserve_tpu_torch.storage.initializer`: a pull with a
    manifest, and exit 2 on a bad argument count."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    cmd = [sys.executable, "-m", "kserve_tpu_torch.storage.initializer"]
    proc = subprocess.run(cmd + ["--manifest", str(model_src), str(tmp_path / "d")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert set(json.loads((tmp_path / "d" / tinit.MANIFEST_NAME).read_text())["files"]) == \
        set(_tree(model_src))
    proc = subprocess.run(cmd + ["--manifest", "x"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "usage" in proc.stderr


def test_a_manifest_pull_is_served_by_the_port(tmp_path):
    """C23: an XGBoost directory pulled with --manifest holds
    `.kserve_manifest.json`, which sorts before `model.json`; the port's
    runtimes pass hidden files over and serve the model, the JAX
    runtime's artifact lookup picks the manifest and fails to load."""
    import numpy as np

    import chip_smoke
    from kserve_tpu.runtimes import gbdt_server as jgbdt
    from kserve_tpu_torch.runtimes.predictive_server import build_model

    src = tmp_path / "src"
    src.mkdir()
    (src / "model.json").write_text(json.dumps(
        chip_smoke.xgb_dump(np.random.default_rng(0), 4, 3, 5)))
    assert tinit.main(["--manifest", f"file://{src}", str(tmp_path / "pulled")]) == 0
    model = build_model("xgboost", "x", str(tmp_path / "pulled"), device="cpu")
    assert model.load()
    direct = build_model("xgboost", "x", str(src), device="cpu")
    direct.load()
    rows = {"instances": np.random.default_rng(1).normal(size=(8, 5)).tolist()}
    assert asyncio.run(model(rows)) == asyncio.run(direct(rows))
    with pytest.raises(KeyError):
        jgbdt.XGBoostModel("x", str(tmp_path / "pulled")).load()
