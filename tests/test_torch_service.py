"""The port's serving layer (tpumil_torch/infer/service.py,
tpumil_torch/cli/serve.py, tpumil_torch/infer/client.py) on the CPU,
mirroring tests/test_service.py.

The load-bearing claim: a row's features are bitwise identical whichever
concurrent requests it shares a batch with. Patches are 64^2 (at 32^2
ResNet18's instance-normed last stage is 1x1 and every feature is 0).
"""

import argparse
import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpumil_torch.infer.service import (_DEFAULT_PALETTE, InferenceService,
                                        MicroBatcher)
from tpumil_torch.io import torch_ckpt
from tpumil_torch.models import embedder
from tpumil_torch.models.embedder import EmbedderConfig
from tpumil_torch.utils.device import select_device

DATA = os.path.join(os.path.dirname(__file__), "data")
CPU = torch.device("cpu")
PATCH = 64
BATCH = 8
FEATS = 512
CLASSES = 2


@pytest.fixture(scope="module")
def emb():
    cfg = EmbedderConfig(backbone="resnet18", norm="instance",
                         num_classes=CLASSES, precision="f32")
    model = embedder.init_params(0, cfg, CPU)
    rng = np.random.default_rng(1)
    # a non-zero head so instance logits vary
    return model.set_head(rng.standard_normal((CLASSES, FEATS)) * 0.05,
                          np.zeros(CLASSES))


@pytest.fixture(scope="module")
def agg():
    model, _, _ = torch_ckpt.load_mil_pth(
        os.path.join(DATA, "tcga_aggregator.pth"), CPU)
    return model


@pytest.fixture(scope="module")
def service(emb, agg):
    svc = InferenceService(emb, CPU, aggregator=agg, batch_size=BATCH,
                           patch_size=PATCH, max_wait_ms=5.0)
    yield svc
    svc.close()


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, PATCH, PATCH, 3), np.uint8)


@pytest.fixture(scope="module")
def direct_fwd(emb):
    """Oracle: the same fixed-[BATCH] forward, fed request by request (each
    request padded alone at offset 0)."""
    def run(images):
        feats_out, logits_out = [], []
        with torch.inference_mode():
            for s in range(0, images.shape[0], BATCH):
                chunk = images[s:s + BATCH]
                buf = np.zeros((BATCH, PATCH, PATCH, 3), np.uint8)
                buf[:len(chunk)] = chunk
                f, c = emb(torch.from_numpy(buf))
                feats_out.append(f.numpy()[:len(chunk)])
                logits_out.append(c.numpy()[:len(chunk)])
        if not feats_out:
            return (np.zeros((0, FEATS), np.float32),
                    np.zeros((0, CLASSES), np.float32))
        return np.concatenate(feats_out), np.concatenate(logits_out)

    return run


def _direct_predict(agg, feats, logits=None):
    with torch.inference_mode():
        return agg(torch.from_numpy(np.asarray(feats, np.float32)), None,
                   ins_logits=None if logits is None else
                   torch.from_numpy(np.asarray(logits, np.float32)))


def test_embed_matches_direct_bitwise(service, direct_fwd):
    imgs = _images(3)
    got = service.embed(imgs)
    want, _ = direct_fwd(imgs)
    assert np.abs(want).max() > 0.1
    np.testing.assert_array_equal(got, want)


def test_embed_oversize_request_spans_batches(service, direct_fwd):
    imgs = _images(BATCH * 2 + 3, seed=1)
    np.testing.assert_array_equal(service.embed(imgs), direct_fwd(imgs)[0])


def test_concurrent_requests_pack_and_stay_exact(service, direct_fwd):
    sizes = [3, 5, 2, BATCH, 13, 1]
    imgs = [_images(n, seed=10 + i) for i, n in enumerate(sizes)]
    results = [None] * len(sizes)
    errors = []

    def worker(i):
        try:
            results[i] = service.embed(imgs[i])
        except BaseException as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(sizes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    for i in range(len(sizes)):
        np.testing.assert_array_equal(results[i], direct_fwd(imgs[i])[0])


def test_packing_window_merges_small_requests(emb):
    svc = InferenceService(emb, CPU, batch_size=BATCH, patch_size=PATCH,
                           max_wait_ms=500.0)
    try:
        reqs = [svc._batcher.submit(_images(2, seed=20 + i)) for i in range(3)]
        for r in reqs:
            r.result(timeout=120)
        assert svc._batcher.stats.batches == 1
        assert svc._batcher.stats.batch_rows == 6
    finally:
        svc.close()


def test_worker_runs_under_inference_mode():
    """Grad mode is thread-local: the worker thread enters inference_mode
    itself."""
    seen = []

    def fwd(batch):
        seen.append(torch.is_inference_mode_enabled())
        return np.zeros((batch.shape[0], 4), np.float32)

    b = MicroBatcher(fwd, batch_size=4, patch_size=8, out_width=4,
                     max_wait_ms=1.0)
    try:
        b.submit(np.zeros((1, 8, 8, 3), np.uint8)).result(timeout=30)
    finally:
        b.close()
    assert seen == [True]


def test_empty_request(service):
    assert service.embed(_images(0)).shape == (0, FEATS)


def test_submit_validation(service):
    with pytest.raises(ValueError):
        service.embed(np.zeros((2, PATCH, PATCH, 3), np.float32))  # dtype
    with pytest.raises(ValueError):
        service.embed(np.zeros((2, 16, 16, 3), np.uint8))          # shape


def test_submit_after_close_raises():
    b = MicroBatcher(lambda batch: np.zeros((batch.shape[0], 4), np.float32),
                     batch_size=4, patch_size=8, out_width=4)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(np.zeros((1, 8, 8, 3), np.uint8))


def test_batcher_error_containment():
    calls = []

    def fwd(batch):
        calls.append(len(batch))
        if len(calls) == 1:
            raise RuntimeError("injected device failure")
        return np.ones((batch.shape[0], 4), np.float32)

    b = MicroBatcher(fwd, batch_size=4, patch_size=8, out_width=4,
                     max_wait_ms=2.0)
    try:
        req1 = b.submit(np.zeros((2, 8, 8, 3), np.uint8))
        with pytest.raises(RuntimeError, match="injected"):
            req1.result(timeout=30)
        out = b.submit(np.zeros((3, 8, 8, 3), np.uint8)).result(timeout=30)
        np.testing.assert_array_equal(out, np.ones((3, 4), np.float32))
        assert b.stats.errors == 1
    finally:
        b.close()


def test_predict_matches_direct_forward(service, agg):
    feats = np.random.default_rng(3).standard_normal((11, FEATS)) \
        .astype(np.float32)
    result = service.predict(feats)
    c, bag_logits, attn, _ = _direct_predict(agg, feats)
    np.testing.assert_array_equal(result["scores"],
                                  torch.sigmoid(bag_logits).numpy())
    np.testing.assert_array_equal(result["attention"], attn.numpy())
    np.testing.assert_array_equal(result["ins_logits"], c.numpy())
    assert result["detected"] == [
        int(i) for i in np.nonzero(result["scores"] >= 0.5)[0]]


def test_predict_patches_uses_embedder_instance_logits(service, direct_fwd,
                                                       agg):
    imgs = _images(6, seed=4)
    result = service.predict_patches(imgs)
    feats, logits = direct_fwd(imgs)
    _, bag_logits, _, _ = _direct_predict(agg, feats, logits)
    np.testing.assert_array_equal(result["scores"],
                                  torch.sigmoid(bag_logits).numpy())
    np.testing.assert_array_equal(result["ins_logits"], logits)


def test_predict_average_mode(emb, agg, direct_fwd):
    svc = InferenceService(emb, CPU, aggregator=agg, batch_size=BATCH,
                           patch_size=PATCH, average=True)
    try:
        imgs = _images(5, seed=5)
        result = svc.predict_patches(imgs)
        feats, logits = direct_fwd(imgs)
        _, bag_logits, _, _ = _direct_predict(agg, feats, logits)
        bag_sig = torch.sigmoid(bag_logits).numpy()
        ins_sig = 1.0 / (1.0 + np.exp(-np.max(logits, axis=0)))
        np.testing.assert_allclose(result["scores"], (bag_sig + ins_sig) / 2,
                                   rtol=0, atol=1e-7)
    finally:
        svc.close()


def test_heatmap_matches_manual_composition(service):
    from tpumil_torch.infer.heatmap import render_color_map

    imgs = _images(6, seed=40)
    positions = np.asarray([[0, 0], [0, 1], [1, 0], [1, 1], [2, 0], [2, 1]])
    image01, result = service.heatmap(imgs, positions)
    want = service.predict_patches(imgs)
    np.testing.assert_array_equal(result["scores"], want["scores"])
    want_img = render_color_map(want["attention"], positions, want["detected"],
                                [_DEFAULT_PALETTE[c] for c in range(CLASSES)])
    np.testing.assert_array_equal(image01, want_img)
    assert image01.shape == (3 * 32, 2 * 32, 3)


def test_heatmap_render_matches_jax_package():
    """The copied render is the JAX package's, value for value."""
    from tpumil.infer.heatmap import render_color_map as jax_render
    from tpumil_torch.infer.heatmap import render_color_map

    rng = np.random.default_rng(41)
    attn = rng.random((6, CLASSES))
    pos = np.asarray([[0, 0], [0, 1], [1, 0], [1, 1], [3, 0], [2, 2]])
    colors = [_DEFAULT_PALETTE[c] for c in range(CLASSES)]
    for detected in ([], [1], [0, 1]):
        np.testing.assert_array_equal(
            render_color_map(attn, pos, detected, colors),
            jax_render(attn, pos, detected, colors))


def test_heatmap_validation(service):
    imgs = _images(3, seed=41)
    with pytest.raises(ValueError, match="positions"):
        service.heatmap(imgs, np.asarray([[0, 0], [0, 1]]))
    with pytest.raises(ValueError, match="non-negative"):
        service.heatmap(imgs, np.asarray([[0, 0], [0, 1], [-1, 0]]))
    with pytest.raises(ValueError, match="empty bag"):
        service.heatmap(np.zeros((0, PATCH, PATCH, 3), np.uint8),
                        np.zeros((0, 2), np.int64))
    with pytest.raises(ValueError, match="grid too large"):
        service.heatmap(imgs[:1], np.asarray([[4096, 4096]]))


def test_predict_validation(service):
    with pytest.raises(ValueError, match="empty bag"):
        service.predict(np.zeros((0, FEATS), np.float32))
    with pytest.raises(ValueError, match="features"):
        service.predict(np.zeros((3, FEATS + 1), np.float32))


def test_select_device_never_lands_on_cpu_silently():
    assert select_device("cpu") == CPU
    with pytest.raises(ValueError, match="unknown device"):
        select_device("auto")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            select_device("cuda")


# ---------------------------------------------------------------------------
# HTTP front
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def http_server(service):
    from tpumil_torch.cli.serve import make_server

    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    yield f"http://{host}:{port}"
    server.shutdown()
    server.server_close()


def _npy_bytes(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _post(url, body):
    req = urllib.request.Request(url, data=body)
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def test_http_healthz_and_stats(http_server):
    with urllib.request.urlopen(http_server + "/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["backend"] == "cpu"
    assert health["batch_size"] == BATCH and health["model"] == "dsmil"
    with urllib.request.urlopen(http_server + "/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert set(stats) >= {"requests", "patches", "batches", "errors"}


def test_http_embed_roundtrip(http_server, direct_fwd):
    imgs = _images(4, seed=6)
    status, ctype, body = _post(http_server + "/v1/embed", _npy_bytes(imgs))
    assert status == 200 and ctype == "application/x-npy"
    np.testing.assert_array_equal(np.load(io.BytesIO(body)),
                                  direct_fwd(imgs)[0])


def test_http_predict_patches_json(http_server):
    status, ctype, body = _post(
        http_server + "/v1/predict_patches?attention=1",
        _npy_bytes(_images(5, seed=7)))
    assert status == 200 and ctype == "application/json"
    out = json.loads(body)
    assert len(out["scores"]) == CLASSES and out["num_instances"] == 5
    assert np.asarray(out["attention"]).shape == (5, CLASSES)
    assert all(0.0 <= s <= 1.0 for s in out["scores"])


def test_http_predict_features_json(http_server):
    feats = np.random.default_rng(8).standard_normal((7, FEATS)) \
        .astype(np.float32)
    status, _, body = _post(http_server + "/v1/predict", _npy_bytes(feats))
    out = json.loads(body)
    assert status == 200
    assert len(out["scores"]) == CLASSES and "attention" not in out


def test_http_heatmap_png(http_server):
    imgs = _images(4, seed=42)
    buf = io.BytesIO()
    np.savez(buf, images=imgs, positions=np.asarray([[0, 0], [0, 1], [1, 0],
                                                     [1, 1]]))
    req = urllib.request.Request(http_server + "/v1/heatmap",
                                 data=buf.getvalue())
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"] == "image/png"
        scores = json.loads(resp.headers["X-Tpumil-Scores"])
        detected = json.loads(resp.headers["X-Tpumil-Detected"])
        body = resp.read()
    from PIL import Image

    assert Image.open(io.BytesIO(body)).size == (2 * 32, 2 * 32)
    assert len(scores) == CLASSES and isinstance(detected, list)
    buf = io.BytesIO()
    np.savez(buf, images=imgs)  # no positions -> 400
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(http_server + "/v1/heatmap", buf.getvalue())
    assert exc.value.code == 400


def test_serving_client_roundtrips(http_server, direct_fwd):
    from tpumil_torch.infer.client import ServingClient

    c = ServingClient(http_server, timeout=120)
    assert c.health()["status"] == "ok"
    imgs = _images(4, seed=50)
    np.testing.assert_array_equal(c.embed(imgs), direct_fwd(imgs)[0])
    out = c.predict_patches(imgs, attention=True)
    assert np.asarray(out["attention"]).shape == (4, CLASSES)
    feats = np.random.default_rng(51).standard_normal((9, FEATS)) \
        .astype(np.float32)
    assert len(c.predict(feats)["scores"]) == CLASSES
    hm = c.heatmap(imgs, np.asarray([[0, 0], [0, 1], [1, 0], [1, 1]]))
    assert hm["png"][:8] == b"\x89PNG\r\n\x1a\n"
    assert c.stats()["errors"] == 0


def test_http_errors(http_server):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(http_server + "/v1/embed", b"not an npy file")
    assert exc.value.code == 400
    assert "error" in json.loads(exc.value.read())
    bad = np.zeros((3, FEATS + 1), np.float32)
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(http_server + "/v1/predict", _npy_bytes(bad))
    assert exc.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(http_server + "/v1/nope", _npy_bytes(bad))
    assert exc.value.code == 404


def test_zerocopy_decode_and_fallbacks():
    from tpumil_torch.cli.serve import _load_npy_zerocopy, _npy_chunks

    arr = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    out = _load_npy_zerocopy(_npy_bytes(arr))
    np.testing.assert_array_equal(out, arr)
    assert out.base is not None and not out.flags.writeable  # a view
    fortran = np.asfortranarray(np.arange(12.0).reshape(3, 4))
    np.testing.assert_array_equal(_load_npy_zerocopy(_npy_bytes(fortran)),
                                  fortran)
    buf = io.BytesIO()
    np.lib.format.write_array(buf, np.arange(6, dtype=np.int32),
                              version=(2, 0))
    np.testing.assert_array_equal(_load_npy_zerocopy(buf.getvalue()),
                                  np.arange(6))
    with pytest.raises(ValueError):
        _load_npy_zerocopy(b"definitely not an npy body")
    for a in (np.arange(10, dtype=np.float32), np.ones((4, 5), np.uint8)):
        assert b"".join(bytes(c) for c in _npy_chunks(a)) == _npy_bytes(a)


def test_build_service_end_to_end(tmp_path):
    """cli.serve.build_service assembles a service from a surgered embedder
    checkpoint and a shipped aggregator on --device cpu, with the instance
    head taken from the aggregator."""
    from tpumil_torch.cli.serve import build_service, parse_args

    cfg = EmbedderConfig(backbone="resnet18", num_classes=CLASSES)
    ckpt = str(tmp_path / "embedder.pth")
    torch.save(embedder.export_embedder_state_dict(
        embedder.init_params(0, cfg, CPU)), ckpt)
    agg_path = os.path.join(DATA, "tcga_aggregator.pth")
    args = parse_args(["--embedder_weights", ckpt, "--aggregator_weights",
                       agg_path, "--num_classes", "2", "--device", "cpu",
                       "--batch_size", "4", "--patch_size", str(PATCH)])
    svc = build_service(args)
    try:
        assert svc.health()["backend"] == "cpu"
        sd = torch.load(agg_path, weights_only=True)
        assert torch.equal(svc.embedder.fc.weight,
                           sd["i_classifier.fc.0.weight"])
        out = svc.predict_patches(_images(3, seed=60))
        assert out["scores"].shape == (CLASSES,)
        assert np.isfinite(out["attention"]).all()
    finally:
        svc.close()
    with pytest.raises(ValueError, match="classes"):
        build_service(argparse.Namespace(**{**vars(args), "num_classes": 3}))
    with pytest.raises(SystemExit):
        parse_args(["--embedder_weights", ckpt, "--device", "tpu"])


def test_serve_module_runs_and_drains_on_sigterm(tmp_path):
    """``python -m tpumil_torch.cli.serve`` starts, answers /healthz, and
    exits 0 after draining on SIGTERM."""
    import re
    import signal
    import subprocess
    import sys

    cfg = EmbedderConfig(backbone="resnet18", num_classes=CLASSES)
    ckpt = str(tmp_path / "embedder.pth")
    torch.save(embedder.export_embedder_state_dict(
        embedder.init_params(0, cfg, CPU)), ckpt)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpumil_torch.cli.serve", "--device", "cpu",
         "--embedder_weights", ckpt, "--port", "0", "--batch_size", "2",
         "--patch_size", str(PATCH)],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        url = re.search(r"http://[\d.]+:\d+", line)
        assert url, (line, proc.stderr.read() if proc.poll() is not None
                     else "")
        with urllib.request.urlopen(url.group(0) + "/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
        assert health["backend"] == "cpu" and health["model"] is None
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0
        assert "draining" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_cli_flags_match_jax():
    """The JAX server's flag surface and defaults, with cuda in place of
    auto; --data_parallel's refusals come before any weights are read."""
    from test_torch_testing_cli import _flags
    from tpumil.cli import serve as jax_serve
    from tpumil_torch.cli import serve

    port = _flags(lambda: serve.parse_args([]))
    jax_flags = _flags(lambda: jax_serve.main([]))
    assert (port.pop("device"), jax_flags.pop("device")) == ("cuda", "auto")
    assert port == jax_flags
    assert serve.parse_args(["--embedder_weights", "w"]).data_parallel == 0
    for n, msg in (("-1", "must be >= 0, got -1"),
                   ("3", "batch_size 128 must divide by")):
        with pytest.raises(ValueError, match=msg):
            serve.main(["--embedder_weights", "w", "--device", "cpu",
                        "--data_parallel", n])
