"""Online serving of the port (efficientvlm_tpu_torch/serving) on the CPU:

- the batcher's cases of JAX's tests/test_serving.py against the port's own
  copy of DynamicBatcher (the two error-propagation cases, single-stage and
  pipelined, merged into one parametrised case; the bucket rule held to
  JAX's pad_to_bucket / pad_items), plus the backlog cap;
- the port's InferenceService on tiny configs in f32, from one
  reference-keyed .th written here, against JAX's InferenceService on the
  same file: captions equal (2-beam search from the prompt), VQA answers
  equal (k-way ranking over an answer list);
- an HTTP round trip (/health, /caption from concurrent clients, /stats,
  400 and 404);
- given no device and no GPU, the service raises.
"""

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from efficientvlm_tpu_torch.serving import (DynamicBatcher, InferenceService, make_http_server,
                                            pad_items, pad_to_bucket, serve_forever_in_thread)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------


def test_pad_to_bucket_matches_jax():
    from efficientvlm_tpu.serving import batching as JB

    assert [pad_to_bucket(n, 16) for n in (1, 2, 3, 5, 9, 16)] == [1, 2, 4, 8, 16, 16]
    assert pad_to_bucket(30, 16) == 16
    assert pad_items([1, 2, 3], 4) == [1, 2, 3, 3] and pad_items([1, 2], 2) == [1, 2]
    for cap in (1, 4, 16):
        for n in range(1, 40):
            assert pad_to_bucket(n, cap) == JB.pad_to_bucket(n, cap)
            assert pad_items(list(range(n)), max(n, cap)) == JB.pad_items(list(range(n)),
                                                                          max(n, cap))


def test_batcher_coalesces_and_orders():
    seen = []

    def run(items):
        seen.append(len(items))
        time.sleep(0.02)  # a window for coalescing
        return [x * 10 for x in items]

    b = DynamicBatcher(run, max_batch_size=8, max_wait_ms=30)
    try:
        futs = [b.submit(i) for i in range(12)]
        assert [f.result(timeout=10) for f in futs] == [i * 10 for i in range(12)]
        s = b.stats()
        assert s["requests"] == 12 and max(seen) > 1 and s["batches"] < 12
        assert s["p50_ms"] is not None
    finally:
        b.close()


def test_batcher_close_fails_queued_futures():
    release = threading.Event()

    def run(items):
        release.wait(5)  # hold the worker, so the next submit stays queued
        return items

    b = DynamicBatcher(run, max_batch_size=1, max_wait_ms=1)
    first = b.submit("a")
    time.sleep(0.05)
    stuck = b.submit("b")
    threading.Timer(0.2, release.set).start()
    b.close()
    assert first.result(timeout=10) == "a"
    with pytest.raises(RuntimeError, match="batcher closed"):
        stuck.result(timeout=10)


def test_batcher_pipelined_overlap_and_stage_stats():
    events, lock = [], threading.Lock()

    def dispatch(items):
        with lock:
            events.append(("d", list(items)))
        return [x * 10 for x in items]

    def finish(handle, items):
        time.sleep(0.05)  # the device busy: dispatch runs meanwhile
        with lock:
            events.append(("f", list(items)))
        return handle

    b = DynamicBatcher(dispatch, finish_batch=finish, max_batch_size=4, max_wait_ms=5)
    try:
        futs = [b.submit(i) for i in range(8)]
        assert [f.result(timeout=10) for f in futs] == [i * 10 for i in range(8)]
        s = b.stats()
        assert s["requests"] == 8 and sum(k * v for k, v in s["buckets"].items()) == 8
        assert s["dispatch_mean_ms"] is not None and s["finish_mean_ms"] is not None
        assert s["queue_wait_p95_ms"] is not None and s["device_busy_s"] > 0
        kinds = [k for k, _ in events]
        assert kinds.count("d") == kinds.count("f") == s["batches"]
        if s["batches"] >= 2:
            first_f = kinds.index("f")
            assert "d" in kinds[first_f + 1:] or kinds[:first_f].count("d") >= 2
    finally:
        b.close()


def test_batcher_busy_drain_coalesces_past_deadline():
    release, batches = threading.Event(), []

    def dispatch(items):
        batches.append(list(items))
        return list(items)

    def finish(handle, items):
        release.wait(10)  # the pipeline slot stays full
        return handle

    b = DynamicBatcher(dispatch, finish_batch=finish, max_batch_size=8, max_wait_ms=5)
    try:
        futs = [b.submit(0)]
        time.sleep(0.1)
        futs.append(b.submit(1))
        time.sleep(0.1)
        for i in range(2, 6):  # spaced 10x past max_wait_ms, still coalesced
            futs.append(b.submit(i))
            time.sleep(0.05)
        release.set()
        assert [f.result(timeout=10) for f in futs] == list(range(6))
        assert any(len(bt) >= 4 for bt in batches), batches
    finally:
        release.set()
        b.close()


def test_batcher_dispatch_lock_serializes_external_device_work():
    """warmup_buckets holds dispatch_lock around its own dispatch; the
    batcher's dispatch thread waits for it."""
    import concurrent.futures as cf

    b = DynamicBatcher(lambda items: list(items), max_batch_size=4, max_wait_ms=2)
    try:
        with b.dispatch_lock:
            fut = b.submit("x")
            done, _ = cf.wait([fut], timeout=0.3)
            assert not done, "dispatch ran while the lock was held"
        assert fut.result(timeout=10) == "x"
    finally:
        b.close()


@pytest.mark.parametrize("stage", ["dispatch", "finish"])
def test_batcher_propagates_exceptions(stage):
    """An exception of either stage reaches every Future of its batch; a
    failed batch still counts in /stats; a closed batcher refuses."""
    def dispatch(items):
        if stage == "dispatch":
            raise ValueError("boom")
        return items

    def finish(handle, items):
        raise ValueError("boom")

    b = DynamicBatcher(dispatch, finish_batch=finish if stage == "finish" else None,
                       max_batch_size=2, max_wait_ms=2)
    try:
        fut = b.submit(1)
        with pytest.raises(ValueError, match="boom"):
            fut.result(timeout=10)
        assert b.stats()["requests"] == 1
    finally:
        b.close()
    with pytest.raises(RuntimeError):
        b.submit(2)


def test_batcher_wedged_finish_watchdog():
    release = threading.Event()

    def finish(handle, items):
        release.wait(30)  # a device result that never arrives
        return items

    b = DynamicBatcher(lambda items: items, finish_batch=finish, max_batch_size=2,
                       max_wait_ms=1, finish_watchdog_s=0.2)
    try:
        first = b.submit(1)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            time.sleep(0.05)
            try:
                fut = b.submit(2)
            except RuntimeError as e:
                assert "wedged" in str(e)
                break
        else:
            raise AssertionError("watchdog never tripped")
        t0 = time.monotonic()
        b.close()
        assert time.monotonic() - t0 < 5
        with pytest.raises(RuntimeError, match="batcher closed"):
            fut.result(timeout=1)
    finally:
        release.set()
        b.close()
    assert first.done() or first.exception(timeout=5) is not None


def test_batcher_backlog_cap_refuses():
    release = threading.Event()

    def run(items):
        release.wait(10)
        return items

    b = DynamicBatcher(run, max_batch_size=1, max_wait_ms=1, max_backlog=2)
    try:
        b.submit(0)
        time.sleep(0.05)  # the worker holds 0; the next two queue
        b.submit(1)
        b.submit(2)
        with pytest.raises(RuntimeError, match="overloaded"):
            b.submit(3)
    finally:
        release.set()
        b.close()


# ---------------------------------------------------------------------------
# the service against JAX's
# ---------------------------------------------------------------------------


def _tiny(mod, impl: str):
    return mod.Config.from_dict({
        "vision": mod.VisionConfig.create(vision_width=32, num_attention_heads=4,
                                          intermediate_size=64, num_hidden_layers=2,
                                          image_res=32, patch_size=8),
        "text": mod.TextConfig.create(vocab_size=200, hidden_size=32, num_hidden_layers=4,
                                      num_attention_heads=4, intermediate_size=64,
                                      encoder_width=32, max_position_embeddings=48,
                                      hidden_dropout_prob=0.0,
                                      attention_probs_dropout_prob=0.0),
        "image_res": 32, "patch_size": 8, "embed_dim": 16, "temp": 0.07, "text_encoder": "",
        "compute_dtype": "f32", "attn_impl": impl, "prompt": "a picture of ", "num_beams": 2,
        "max_length": 8, "min_length": 2, "max_tokens": 12, "k_test": 3})


ANSWERS = ["yes", "no", "red", "two", "left side"]
QUESTIONS = ["what color is it?", "how many dogs?", "is it a cat?"]


def _b64_image(seed=0, size=40):
    rng = np.random.RandomState(seed)
    buf = io.BytesIO()
    Image.fromarray(np.uint8(rng.rand(size, size, 3) * 255)).save(buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def th_file(tmp_path_factory):
    """A reference-keyed .th of a seeded XVLMForPretrain (the captioning and
    VQA imports derive their decoders from it)."""
    from efficientvlm_tpu_torch import config as tcfg
    from efficientvlm_tpu_torch.models.model_pretrain import XVLMForPretrain
    from efficientvlm_tpu_torch.train import checkpoint as TC

    cfg = _tiny(tcfg, "plain")
    params = XVLMForPretrain(cfg["vision"], cfg["text"], cfg).init(3, device="cpu")
    sd = TC.xvlm_state_dict_from_params(params, fusion_layer=cfg["text"]["fusion_layer"])
    path = str(tmp_path_factory.mktemp("serve") / "xvlm.th")
    torch.save({"model": sd}, path)
    return path


def _jax_outputs(task: str, th: str, images: list) -> list:
    """JAX's service on the .th, its dispatch and finish called on the
    requests as one batch (one compile)."""
    from efficientvlm_tpu import config as jcfg
    from efficientvlm_tpu.serving import InferenceService as JService

    svc = JService(task, _tiny(jcfg, "xla"), checkpoint=th, answer_list=ANSWERS,
                   max_batch_size=4, warmup=False)
    try:
        items = [{"image": im} if task == "caption" else {"image": im, "question": q}
                 for im, q in zip(images, QUESTIONS)]
        return svc._finish_batch(svc._dispatch_batch(items), items)
    finally:
        svc.close()


@pytest.mark.parametrize("task", ["caption", "vqa"])
def test_service_matches_jax(task, th_file):
    """Three concurrent requests through the port's batcher (every bucket
    warmed first) against JAX's service on the same .th and images."""
    from efficientvlm_tpu_torch import config as tcfg

    svc = InferenceService(task, _tiny(tcfg, "plain"), checkpoint=th_file, answer_list=ANSWERS,
                           max_batch_size=4, max_wait_ms=50, device="cpu")
    try:
        images = [svc.preprocess(_b64_image(i)) for i in range(3)]
        assert images[0].dtype == np.uint8 and images[0].shape == (32, 32, 3)
        futs = [svc.submit_caption(im) if task == "caption" else svc.submit_vqa(im, q)
                for im, q in zip(images, QUESTIONS)]
        got = [f.result(timeout=120) for f in futs]
        stats = svc.stats()
    finally:
        svc.close()
    assert stats["requests"] == 3 and stats["preprocess_mean_ms"] is not None
    want = _jax_outputs(task, th_file, images)
    assert got == want
    if task == "vqa":
        assert all(a in ANSWERS for a in got)
    else:
        assert all(isinstance(c, str) for c in got)


def _post(url, payload, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_http_caption_roundtrip(th_file):
    from efficientvlm_tpu_torch import config as tcfg

    svc = InferenceService("caption", _tiny(tcfg, "plain"), checkpoint=th_file,
                           max_batch_size=4, max_wait_ms=50, device="cpu")
    server = make_http_server(svc, "127.0.0.1", 0)
    serve_forever_in_thread(server)
    host, port = server.server_address
    base = f"http://{host}:{port}"
    try:
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            assert r.status == 200 and json.loads(r.read())["task"] == "caption"
        results = {}

        def one(i):
            results[i] = _post(base + "/caption", {"image_b64": _b64_image(i)})

        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert set(results) == {0, 1, 2, 3}
        assert all(s == 200 and isinstance(p["caption"], str) for s, p in results.values())
        # the same image through the service directly: the same caption
        direct = svc.submit_caption(svc.preprocess(_b64_image(2))).result(timeout=60)
        assert results[2][1]["caption"] == direct
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["requests"] >= 4 and stats["batches"] >= 1 and "buckets" in stats
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/caption", {"nope": 1})
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/vqa", {"image_b64": _b64_image(0), "question": "?"})
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def test_http_backlog_takes_the_clients():
    """JAX's server listens with the standard library's backlog of 5: more
    concurrent connects than that are dropped and retried by the client
    after 1 s (ROADMAP C); the port's takes 128, and 32 clients that connect
    at once are all answered."""
    from efficientvlm_tpu.serving.service import make_http_server as jax_server

    class Stub:
        task = "caption"

    for make, want in ((jax_server, 5), (make_http_server, 128)):
        server = make(Stub(), "127.0.0.1", 0)
        try:
            assert server.request_queue_size == want
        finally:
            server.server_close()
    server = make_http_server(Stub(), "127.0.0.1", 0)
    serve_forever_in_thread(server)
    url = f"http://127.0.0.1:{server.server_address[1]}/health"
    codes = []

    def one():
        with urllib.request.urlopen(url, timeout=30) as r:
            codes.append(r.status)

    try:
        threads = [threading.Thread(target=one) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert codes == [200] * 32
    finally:
        server.shutdown()
        server.server_close()


def test_service_runs_on_the_card_by_default(th_file):
    """Given no device, the service resolves cuda: without a GPU it raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from efficientvlm_tpu_torch import config as tcfg

    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceService("caption", _tiny(tcfg, "plain"), checkpoint=th_file)
