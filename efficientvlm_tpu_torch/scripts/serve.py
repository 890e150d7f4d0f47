"""Online serving: the HTTP endpoint with dynamic request batching (port of
scripts/serve.py).

  python -m efficientvlm_tpu_torch.scripts.serve --task caption \\
      --checkpoint pruned.ckpt --config configs/x-vlm-small-ft/Captioning.yaml --port 8000

  curl -s localhost:8000/caption -d '{"image_b64": "'"$(base64 -w0 img.jpg)"'"}'
  curl -s localhost:8000/health ; curl -s localhost:8000/stats

It accepts the checkpoints infer does (a reference .th, a native snapshot,
a pruned or int8 export). Before the server opens its port the kernels are
built and every batch bucket runs once (serving/service.warmup_buckets).
Requests decode and resize their image on their own HTTP thread; the card
runs coalesced power-of-two batches on the batcher's dispatch thread.
SIGTERM and SIGINT shut the server down cleanly and print its /stats; a
process forked after the handler is installed dies of SIGTERM as usual.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading

from ..config import load_task_config
from ..run import REPO_ROOT
from ..serving import InferenceService, make_http_server


def install_shutdown(server) -> None:
    """SIGTERM / SIGINT -> server.shutdown() on a helper thread (it waits
    for serve_forever's loop, which runs on the thread the handler
    interrupts). A forked child takes the signal's default action."""
    owner = os.getpid()

    def _shutdown(signum, frame):
        if os.getpid() != owner:
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        print(f"### signal {signum}: shutting down", flush=True)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", required=True, choices=["caption", "vqa"])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--config", required=True, help="task YAML (model geometry)")
    ap.add_argument("--answer_list", default="", help="vqa: JSON list of answers")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000, help="0 picks a free port")
    ap.add_argument("--max_batch_size", type=int, default=16)
    ap.add_argument("--max_wait_ms", type=float, default=10.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    config = load_task_config(args.config if os.path.isabs(args.config)
                              else os.path.join(REPO_ROOT, args.config), repo_root=REPO_ROOT)
    if args.answer_list:
        config["answer_list"] = args.answer_list
    print(f"### building the {args.task} service from {args.checkpoint} (every bucket up to "
          f"{args.max_batch_size} runs once first)", flush=True)
    service = InferenceService(args.task, config, checkpoint=args.checkpoint,
                               max_batch_size=args.max_batch_size,
                               max_wait_ms=args.max_wait_ms, device=args.device)
    service.reset_stats()
    server = make_http_server(service, args.host, args.port)
    install_shutdown(server)
    host, port = server.server_address[:2]
    print(f"### serving {args.task} on http://{host}:{port} (max_batch={args.max_batch_size}, "
          f"max_wait={args.max_wait_ms}ms)", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.close()
        print("### stats:", service.stats(), flush=True)


if __name__ == "__main__":
    main()
