"""Inference server over an exported artifact (counterpart of
`mrclip_tpu/serve.py`, same HTTP API and error paths).

Loads a `.mrclip` artifact onto the card and answers JSON over HTTP with
embeddings or image<->text scores. Stdlib-only (http.server),
thread-per-request. Concurrent requests are DYNAMICALLY BATCHED per
endpoint: a worker thread coalesces requests that arrive within
`--batch-window-ms` (default 5) up to `--max-batch` (default 32) into one
device call. Set `--max-batch 1` to disable.

Run: `python -m mrclip_tpu_torch.serve --model model.mrclip --port 8080`

API:
  POST /encode_text   {"texts": ["a brain MRI ..."]}           -> {"features": [[...]]}
  POST /encode_image  {"images": [[...HWC floats...]]}          -> {"features": [[...]]}
  POST /score         {"images": [...], "texts": [...]}         -> {"logits": [[...]]}
  GET  /health                                                  -> {"ok": true, "meta": {...}}
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .serving import load_exported
from .tokenizer import SimpleTokenizer

__all__ = ["make_server", "main"]


class _Batcher:
    """Coalesce concurrent requests into one batched device call.

    Requests arriving within `window_s` of the first pending one are
    concatenated along axis 0 (up to `max_batch` rows) and answered from a
    single `fn` call. A dedicated worker thread per endpoint serializes
    device access, so no extra lock is needed.
    """

    def __init__(self, fn, max_batch: int = 32, window_s: float = 0.005):
        self.fn = fn
        self.max_batch = max_batch
        self.window_s = window_s
        self.q: "queue.Queue" = queue.Queue()
        threading.Thread(target=self._worker, daemon=True).start()

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        arr = np.asarray(arr)
        if arr.ndim == 0:
            # Reject in the caller's thread: a 0-d payload reaching the
            # worker would raise outside any future's scope.
            raise ValueError("payload must be a batch (got a scalar)")
        fut: Future = Future()
        self.q.put((arr, fut))
        return fut.result()

    def _worker(self):
        pending = []  # requests deferred from earlier groups, in order
        while True:
            first = pending.pop(0) if pending else self.q.get()
            items = [first]
            try:
                deferred = []
                rows = len(first[0])
                shape = first[0].shape[1:]
                deadline = time.monotonic() + self.window_s
                while rows < self.max_batch:
                    if pending:
                        nxt = pending.pop(0)
                    else:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        try:
                            nxt = self.q.get(timeout=remaining)
                        except queue.Empty:
                            break
                    # Only coalesce compatible requests: same per-item shape
                    # and within the row cap. Everything else defers to the
                    # NEXT group rather than failing (or bloating) this one.
                    if nxt[0].shape[1:] != shape or rows + len(nxt[0]) > self.max_batch:
                        deferred.append(nxt)
                        continue
                    items.append(nxt)
                    rows += len(nxt[0])
                pending = deferred + pending
                if len(items) == 1:
                    out = np.asarray(self.fn(items[0][0]))
                    items[0][1].set_result(out)
                    continue
                out = np.asarray(self.fn(np.concatenate([a for a, _ in items], axis=0)))
                ofs = 0
                for arr, fut in items:
                    fut.set_result(out[ofs:ofs + len(arr)])
                    ofs += len(arr)
            except Exception as e:  # noqa: BLE001 - deliver to every waiter;
                # the worker thread itself must survive any request.
                for _, fut in items:
                    if not fut.done():
                        fut.set_exception(e)


def make_server(
    artifact_path: str,
    host: str = "0.0.0.0",
    port: int = 8080,
    *,
    max_batch: int = 32,
    batch_window_ms: float = 5.0,
    device=None,
):
    """An HTTP server over the artifact, loaded on `device` (CUDA unless
    given; raises without a card). Call `serve_forever()` on it."""
    served = load_exported(artifact_path, device=device)
    tokenizer = SimpleTokenizer(context_length=served.meta.get("context_length", 98))
    if max_batch > 1:
        # Batcher workers serialize device access themselves — handlers must
        # NOT share a lock, or requests serialize before they can coalesce.
        enc_img = _Batcher(served.encode_image, max_batch, batch_window_ms / 1e3)
        enc_txt = _Batcher(served.encode_text, max_batch, batch_window_ms / 1e3)
    else:
        lock = threading.Lock()  # one card: serialize compute

        def enc_img(images):
            with lock:
                return served.encode_image(images)

        def enc_txt(tokens):
            with lock:
                return served.encode_text(tokens)

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet
            pass

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"ok": True, "meta": served.meta})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                return self._json(400, {"error": f"bad json: {e}"})

            try:
                if self.path == "/encode_text":
                    feats = enc_txt(tokenizer(req["texts"]))
                    return self._json(200, {"features": np.asarray(feats).tolist()})
                if self.path == "/encode_image":
                    feats = enc_img(np.asarray(req["images"], np.float32))
                    return self._json(200, {"features": np.asarray(feats).tolist()})
                if self.path == "/score":
                    img = np.asarray(enc_img(np.asarray(req["images"], np.float32)))
                    txt = np.asarray(enc_txt(tokenizer(req["texts"])))
                    logits = (
                        served.meta.get("logit_scale", 100.0) * img @ txt.T
                        + served.meta.get("logit_bias", 0.0)
                    )
                    return self._json(200, {"logits": logits.tolist()})
                return self._json(404, {"error": "unknown path"})
            except KeyError as e:
                return self._json(400, {"error": f"missing field {e}"})
            except Exception as e:  # surface shape/dtype issues to the client
                return self._json(500, {"error": str(e)})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    parser = argparse.ArgumentParser("mrclip_tpu_torch.serve")
    parser.add_argument("--model", required=True, help="path to a .mrclip export")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--max-batch", type=int, default=32,
                        help="dynamic batching: max coalesced rows (1 disables)")
    parser.add_argument("--batch-window-ms", type=float, default=5.0,
                        help="dynamic batching: wait window for coalescing")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' to run without one)")
    args = parser.parse_args(argv)
    server = make_server(
        args.model, args.host, args.port,
        max_batch=args.max_batch, batch_window_ms=args.batch_window_ms,
        device=args.device,
    )
    print(f"serving {args.model} on {args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
