"""Online inference service: model hosting, dynamic batching and HTTP (port
of efficientvlm_tpu/serving/service.py).

`InferenceService` puts a task's inference unit (captioning's beam search
from the prompt, XVLMForCaptioning.generate, or VQA's answer ranking,
XVLMForVQA.forward_eval: the drivers' evaluation calls) behind a pipelined
`DynamicBatcher`. Each HTTP request thread decodes and resizes its own image
(PIL releases the GIL, so decodes run in parallel) to uint8 at the
evaluation geometry (ImageTransform.uint8(res, margin=1.0)); the images go
to the card as uint8, a quarter of the f32 bytes, and are normalised there
(data/device_pipeline.normalize). The request then waits on a Future while
the batcher's threads serve coalesced, bucket-padded batches.

The split between the batcher's two threads. JAX's generate is one
asynchronous program, so its dispatch thread only launches it. The port's
decode loop runs on the host and reads the stop condition from the card
every step, so here the dispatch thread runs the whole of a batch's device
work:
- dispatch (the only thread that launches kernels): the batch's uint8
  images are copied from pinned memory on a side stream (an event orders
  the compute stream after the copy), then the encode and the decode or
  answer ranking run, and the result's copy back into pinned host memory
  is queued behind them with a CUDA event recorded after it;
- finish: waits on that event, reads the pinned buffer and detokenizes.
So the finisher's detokenization and the next batch's collection overlap
the dispatch thread's device work, and the next batch's upload (side
stream) can overlap the end of the last one's; the decode itself does not
overlap anything on the host, since its loop waits for the card each step.

Every kernel is built and every bucket shape (1, 2, 4, ..., max_batch_size)
runs once in warmup_buckets, under the batcher's dispatch_lock, before a
server starts taking requests. `make_http_server` exposes the service over
the standard library's ThreadingHTTPServer: POST /caption, POST /vqa, GET
/health, GET /stats (with per-stage timings). scripts/serve.py is the CLI.

Checkpoints accepted (drivers/common.load_eval_params): a reference-keyed
torch `.th` (through the task driver's load_torch_params), or a native
`.ckpt` of train/checkpoint: a dense snapshot, a gated training snapshot
(its stored gates made deterministic, L0Module.forward_deterministic), a
physically pruned export or an int8 export. The service serves `caption` and `vqa`,
as JAX's does.
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence

import numpy as np
import torch

from .batching import DynamicBatcher, pad_items, pad_to_bucket


def _decode_b64_image(data: str, transform) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(base64.b64decode(data))).convert("RGB")
    return np.asarray(transform(img))


class InferenceService:
    """task: 'caption' or 'vqa'. Give `checkpoint` (a path) or `params` (and
    optionally `zs`). The device is `device` (default cuda: without a GPU
    the constructor raises; pass "cpu" for the plain versions on the CPU).
    All device work happens on the batcher's dispatch thread (and in
    warmup_buckets under its lock); submit_* return Futures."""

    def __init__(self, task: str, config, *, checkpoint: str = "", params=None, zs=None,
                 answer_list: Optional[Sequence[str]] = None, max_batch_size: int = 16,
                 max_wait_ms: float = 10.0, warmup: bool = True, device=None):
        from ..data.tokenizer import build_tokenizer
        from ..data.transforms import ImageTransform
        from ..device import resolve_device
        from ..drivers.common import compute_dtype

        if task not in ("caption", "vqa"):
            raise ValueError(f"unsupported task {task!r}")
        self.task, self.config = task, config
        self.device = resolve_device(device)
        self.tokenizer = build_tokenizer(config.get("text_encoder", ""))
        # margin=1.0: the evaluation geometry (bicubic resize to image_res),
        # as uint8; normalize on the card gives ImageTransform.test's values
        self.transform = ImageTransform.uint8(int(config.get("image_res", 384)), margin=1.0)
        self.max_batch_size = int(max_batch_size)
        self.impl = config.get("attn_impl", "fused")
        self.dtype = compute_dtype(config)
        cuda = self.device.type == "cuda"
        self._upload = torch.cuda.Stream(self.device) if cuda else None

        if task == "caption":
            from ..drivers.captioning import build_l0, build_models, load_torch_params

            self.model, _ = build_models(config)
            self.params, self.zs = self._resolve_params(
                build_l0(config), checkpoint, params, zs, load_torch_params)
            self._prompt = config.get("prompt", "a picture of ")
            self._prompt_ids = np.asarray(self.tokenizer([self._prompt])["input_ids"],
                                          np.int64)[:, :-1]  # without [SEP]
            self.model.prompt_length = self._prompt_ids.shape[1]
        else:
            from ..drivers.vqa import build_l0, build_models, load_torch_params

            self.model, _ = build_models(config)
            self.params, self.zs = self._resolve_params(
                build_l0(config), checkpoint, params, zs, load_torch_params)
            if answer_list is None:
                with open(config["answer_list"]) as f:
                    answer_list = json.load(f)
            self.answers = list(answer_list)
            ans = self.tokenizer([a + "[SEP]" for a in self.answers], padding="longest",
                                 truncation=True, max_length=20)
            self._answer_ids = torch.as_tensor(np.asarray(ans["input_ids"], np.int64),
                                               device=self.device)
            self._answer_atts = torch.as_tensor(np.asarray(ans["attention_mask"]),
                                                device=self.device)
            self._k = min(int(config.get("k_test", 128)), len(self.answers))

        self._pre_lock = threading.Lock()
        self._pre_ms_total, self._pre_count = 0.0, 0
        self._batcher = DynamicBatcher(self._dispatch_batch, finish_batch=self._finish_batch,
                                       max_batch_size=max_batch_size, max_wait_ms=max_wait_ms,
                                       name=f"{task}-batcher")
        if warmup:
            self.warmup_buckets(self.max_batch_size)

    # -- loading ----------------------------------------------------------
    def _resolve_params(self, l0, checkpoint, params, zs, torch_loader):
        """(params, zs) as given, or read once from the checkpoint
        (drivers/common.load_eval_params)."""
        from ..drivers.common import load_eval_params

        if params is not None:
            return params, zs
        if not checkpoint:
            raise ValueError("provide checkpoint= or params=")
        return load_eval_params(self.model, l0, checkpoint, torch_loader, self.device)

    # -- request paths ----------------------------------------------------
    def preprocess(self, image_b64: str) -> np.ndarray:
        """Decode and resize to uint8 on the caller's thread."""
        t0 = time.monotonic()
        out = _decode_b64_image(image_b64, self.transform)
        dt = (time.monotonic() - t0) * 1e3
        with self._pre_lock:
            self._pre_ms_total += dt
            self._pre_count += 1
        return out

    def submit_caption(self, image: np.ndarray):
        return self._batcher.submit({"image": image})

    def submit_vqa(self, image: np.ndarray, question: str):
        return self._batcher.submit({"image": image, "question": question})

    def stats(self) -> dict:
        with self._pre_lock:
            pre = (self._pre_ms_total / self._pre_count) if self._pre_count else None
        return {"task": self.task, "preprocess_mean_ms": pre, **self._batcher.stats()}

    def reset_stats(self) -> None:
        with self._pre_lock:
            self._pre_ms_total, self._pre_count = 0.0, 0
        self._batcher.reset_stats()

    def close(self) -> None:
        self._batcher.close()

    # -- device side ------------------------------------------------------
    def _images(self, padded: List[dict]) -> torch.Tensor:
        """The batch's uint8 images on the device, normalised to f32: on the
        card copied from pinned memory on the side stream, the compute
        stream ordered after the copy."""
        from ..data.device_pipeline import normalize

        host = torch.from_numpy(np.stack([it["image"] for it in padded]))
        if self._upload is None:
            return normalize(host.float())
        host = host.pin_memory()
        with torch.cuda.stream(self._upload):
            dev = host.to(self.device, non_blocking=True)
        compute = torch.cuda.current_stream(self.device)
        compute.wait_stream(self._upload)
        dev.record_stream(compute)
        return normalize(dev.float())

    @torch.inference_mode()
    def _dispatch_batch(self, items: List[dict]):
        """Dispatch-thread half: pad to the bucket, upload, run the device
        work, queue the result's copy to pinned host memory and record an
        event after it. Returns (host tensor, event or None)."""
        bucket = pad_to_bucket(len(items), self.max_batch_size)
        padded = pad_items(items, bucket)
        image = self._images(padded)
        tok = self.tokenizer
        if self.task == "caption":
            pids = torch.as_tensor(np.repeat(self._prompt_ids, bucket, axis=0),
                                   device=self.device)
            out = self.model.generate(
                self.params, image, pids, max_length=int(self.config.get("max_length", 20)),
                min_length=int(self.config.get("min_length", 5)),
                num_beams=int(self.config.get("num_beams", 3)), eos_id=tok.sep_token_id,
                pad_id=tok.pad_token_id, zs=self.zs, dtype=self.dtype, impl=self.impl)
        else:
            q = tok([it["question"] for it in padded], padding="max_length", truncation=True,
                    max_length=int(self.config.get("max_tokens", 40)))
            topk_ids, _ = self.model.forward_eval(
                self.params, image,
                torch.as_tensor(np.asarray(q["input_ids"], np.int64), device=self.device),
                torch.as_tensor(np.asarray(q["attention_mask"]), device=self.device),
                self._answer_ids, self._answer_atts, k=self._k, zs=self.zs, dtype=self.dtype,
                impl=self.impl)
            out = topk_ids[:, 0]
        if self._upload is None:
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _finish_batch(self, handle, items: List[dict]) -> List:
        """Finisher-thread half: wait for the event, read the host copy,
        detokenize (the padded rows dropped)."""
        from ..drivers.captioning import strip_prompt

        host, done = handle
        if done is not None:
            done.synchronize()
        rows = host.numpy()[:len(items)]
        if self.task == "caption":
            return [strip_prompt(self.tokenizer.decode(t, skip_special_tokens=True),
                                 self._prompt) for t in rows]
        return [self.answers[int(a)] for a in rows]

    def warmup_buckets(self, up_to: int) -> None:
        """Run every power-of-two bucket <= pad_to_bucket(up_to) once (each
        under the batcher's dispatch lock, so a live endpoint's dispatch
        thread never runs beside it): the kernels built and loaded, cuBLAS
        and the caching allocator sized for each batch shape, before any
        request pays for it."""
        res = int(self.config.get("image_res", 384))
        dummy = {"image": np.zeros((res, res, 3), np.uint8)}
        if self.task == "vqa":
            dummy["question"] = "warmup ?"
        top = pad_to_bucket(max(1, int(up_to)), self.max_batch_size)
        b = 1
        while b <= top:
            items = [dummy] * b
            with self._batcher.dispatch_lock:
                handle = self._dispatch_batch(items)
            self._finish_batch(handle, items)
            b *= 2


# -- HTTP ------------------------------------------------------------------

def make_http_server(service: InferenceService, host: str = "127.0.0.1", port: int = 8000,
                     request_timeout_s: float = 600.0):
    """A ThreadingHTTPServer over the service, with a listen backlog of
    _Server.request_queue_size connections. Endpoints:
    POST /caption {"image_b64": ...} -> {"caption": ...}
    POST /vqa {"image_b64": ..., "question": ...} -> {"answer": ...}
    GET /health, GET /stats. Port 0 picks a free port
    (server.server_address[1])."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet: /stats carries the signal
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok", "task": service.task})
            elif self.path == "/stats":
                self._json(200, service.stats())
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/caption" and service.task == "caption":
                    img = service.preprocess(req["image_b64"])
                    fut = service.submit_caption(img)
                    self._json(200, {"caption": fut.result(timeout=request_timeout_s)})
                elif self.path == "/vqa" and service.task == "vqa":
                    img = service.preprocess(req["image_b64"])
                    fut = service.submit_vqa(img, str(req["question"]))
                    self._json(200, {"answer": fut.result(timeout=request_timeout_s)})
                else:
                    self._json(404, {"error": f"{self.path} not served by "
                                              f"task={service.task}"})
            except KeyError as e:
                self._json(400, {"error": f"missing field {e}"})
            except Exception as e:  # noqa: BLE001 (the client gets the error)
                self._json(500, {"error": repr(e)})

    return _Server((host, port), Handler)


class _Server(ThreadingHTTPServer):
    # the listen backlog: the standard library's 5 drops the connects of more
    # concurrent clients than that, and a dropped SYN is retried after 1 s
    request_queue_size = 128


def serve_forever_in_thread(server) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True, name="http-serve")
    t.start()
    return t
