"""HTTP micro-batching inference server for the multimodal model.

One process loads a checkpoint (or seeded random weights for smoke tests),
warms a fixed-batch `serve.Predictor` on the GPU and scores concurrent HTTP
requests through a `serve.MicroBatcher`: whatever arrives within
--max_delay_ms is coalesced into ONE padded forward.

  python -m multimodalaggressionrecognition_tpu_torch.cli.serve \
      --path_to_checkpoint model.pt --modalities audio,text --port 8000

Protocol:
  GET  /healthz -> {"ok": true, "models": {"model": {modalities, heads,
                    batch_size}}, + the same fields flat}
  GET  /statz   -> {"model": requests, clips, dispatches, coalescing factor
                    (clips/dispatches), recent-latency p50/p99}
  POST /score   -> {"phys": [[p_neg, p_aggr], ...], "verb": ...}
      Body is JSON ({"audio": clip-or-batch, "text": ...}) or an np.savez
      archive with Content-Type application/x-npz.  A clip is audio (L,) or
      text (T, H); a leading batch dim is accepted, and variable lengths
      are padded/truncated to the model's sizes.  Every request carries the
      server's full modality set; batches larger than --batch_size are
      chunked across micro-batch groups.

Runs on CUDA unless --device cpu; serving pre-exported artifacts
(--exported) is not ported yet.
"""

import io
import json
import threading
import time
from collections import deque
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .common import parse_config
from .train_multimodal import MultimodalConfig, build_model


@dataclass
class ServeConfig(MultimodalConfig):
    path_to_checkpoint: str = ""
    host: str = "127.0.0.1"
    port: int = 8000
    batch_size: int = 32
    max_delay_ms: float = 2.0   # micro-batch coalescing window
    device: str = "cuda"
    # explicit opt-in for serving untrained weights (smoke tests only);
    # without it a missing --path_to_checkpoint is an error, never a
    # healthy-looking server scoring garbage
    allow_random_weights: bool = False


@dataclass
class _Endpoint:
    """The served model: its batcher plus everything the handler needs."""

    predictor: object
    batcher: object
    modalities: set
    pads: dict
    ndims: dict  # modality -> expected single-clip ndim
    batch_size: int
    heads: list

    def __post_init__(self):
        # wall-clock ms per completed /score request (bounded window;
        # deque.append is GIL-atomic so handler threads need no lock).
        # `requests += 1` is a read-modify-write and DOES need the lock.
        self.latencies = deque(maxlen=2048)
        self.requests = 0
        self.count_lock = threading.Lock()

    def info(self):
        return {"modalities": sorted(self.modalities),
                "heads": sorted(self.heads),
                "batch_size": self.batch_size}

    def stats(self):
        out = {"requests": self.requests, **self.batcher.stats}
        if out["dispatches"]:
            out["mean_group_size"] = round(
                out["clips"] / out["dispatches"], 2)
        lat = sorted(self.latencies)
        if lat:
            out["recent_latency_ms"] = {
                "p50": round(lat[len(lat) // 2], 2),
                "p99": round(lat[min(int(len(lat) * 0.99),
                                     len(lat) - 1)], 2),
                "window": len(lat)}
        return out


def _as_batch(name: str, value, pad, nd: int) -> np.ndarray:
    """Normalize a request value to a padded (n, ...) float32 batch."""
    try:
        arr = np.asarray(value, dtype=np.float32)
    except (ValueError, TypeError):
        # ragged JSON batch: variable-length clips, pad each
        return np.stack([pad(np.asarray(c, np.float32)) for c in value])
    if arr.ndim == nd:
        return pad(arr)[None]
    if arr.ndim == nd + 1:
        return np.stack([pad(c) for c in arr])
    raise ValueError(f"{name}: expected a {nd}-d clip or {nd + 1}-d batch, "
                     f"got {arr.ndim}-d")


class _Handler(BaseHTTPRequestHandler):
    timeout = 60  # bound a stalled client so shutdown's join can't hang

    def log_message(self, fmt, *args):  # quiet access log
        pass

    def _reply(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        ep = self.server.endpoint
        if self.path == "/healthz":
            self._reply(200, {"ok": True, "models": {"model": ep.info()},
                              **ep.info()})
        elif self.path == "/statz":
            self._reply(200, {"model": ep.stats()})
        else:
            self._reply(404, {"error": f"unknown path {self.path!r}"})

    def do_POST(self):
        ep = self.server.endpoint
        if self.path != "/score":
            return self._reply(404, {"error": f"unknown path {self.path!r}"})
        try:
            raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            if self.headers.get("Content-Type", "").startswith(
                    "application/x-npz"):
                request = dict(np.load(io.BytesIO(raw)))
            else:
                request = json.loads(raw)
            if set(request) != ep.modalities:
                raise ValueError(
                    f"request modalities {sorted(request)} != served set "
                    f"{sorted(ep.modalities)} (one presence pattern; start "
                    "the server with --modalities to change)")
            batch = {m: _as_batch(m, v, ep.pads[m], ep.ndims[m])
                     for m, v in request.items()}
            sizes = {m: a.shape[0] for m, a in batch.items()}
            n = next(iter(sizes.values()))
            if any(s != n for s in sizes.values()):
                raise ValueError(f"modalities disagree on batch size: {sizes}")
        except Exception as e:  # malformed request: the caller's fault
            return self._reply(400, {"error": str(e)})
        try:
            t0 = time.monotonic()
            # chunk oversized batches across micro-batch groups; submit all
            # chunks before waiting so they pipeline through the batcher
            futs = [ep.batcher.submit(
                {m: a[s:s + ep.batch_size] for m, a in batch.items()})
                for s in range(0, n, ep.batch_size)]
            scores = [f.result() for f in futs]
            out = {h: np.concatenate([s[h] for s in scores]).round(4).tolist()
                   for h in scores[0]}
            with ep.count_lock:
                ep.requests += 1
            ep.latencies.append((time.monotonic() - t0) * 1e3)
            self._reply(200, out)
        except Exception as e:
            self._reply(500, {"error": str(e)})


def build_server(cfg: ServeConfig, state_dict=None) -> ThreadingHTTPServer:
    """Construct the HTTP server (not yet serving): builds the model, loads
    its weights, warms the Predictor on `cfg.device` and starts the
    MicroBatcher.  Pass `state_dict` to skip checkpoint restore (tests)."""
    from ..data.transforms import pad_audio, pad_text
    from ..io.checkpoint import restore_variables
    from ..models.layers import seeded_init_
    from ..serve import MicroBatcher, Predictor, resolve_device
    from .common import clip_shapes_from_config

    device = resolve_device(cfg.device)  # fail before any model work
    modalities = tuple(sorted(cfg.modalities.split(",")))
    model = build_model(cfg, modalities)
    if state_dict is None:
        if cfg.path_to_checkpoint:
            state_dict, _ = restore_variables(cfg.path_to_checkpoint)
        elif cfg.allow_random_weights:
            seeded_init_(model, cfg.seed)
        else:
            raise SystemExit(
                "--path_to_checkpoint is required: serving freshly "
                "initialized weights produces garbage scores behind a "
                "healthy-looking endpoint (pass --allow_random_weights "
                "true for smoke tests)")

    shapes = clip_shapes_from_config(cfg, modalities)
    predictor = Predictor(model, state_dict, batch_size=cfg.batch_size,
                          device=device)
    predictor.warmup({m: np.zeros((1,) + shapes[m], np.float32)
                      for m in modalities})
    pad_builders = {"audio": pad_audio, "text": pad_text}
    endpoint = _Endpoint(
        predictor=predictor,
        batcher=MicroBatcher(predictor, max_delay_ms=cfg.max_delay_ms),
        modalities=set(shapes),
        pads={m: pad_builders[m](shapes[m][0]) for m in shapes},
        ndims={m: len(shapes[m]) for m in shapes},
        batch_size=cfg.batch_size, heads=predictor.heads)

    server = ThreadingHTTPServer((cfg.host, cfg.port), _Handler)
    # NON-daemon handler threads: server_close() joins only non-daemon
    # handlers, and the drain contract needs that join; server_close() runs
    # BEFORE the batcher closes (see main), so in-flight handlers can still
    # submit() and their futures resolve
    server.daemon_threads = False
    server.endpoint = endpoint
    server.predictor = predictor
    server.batcher = endpoint.batcher
    return server


def main(argv=None):
    import signal

    cfg = parse_config(ServeConfig, argv)
    server = build_server(cfg)
    host, port = server.server_address[:2]
    print(json.dumps({"serving": f"http://{host}:{port}",
                      "models": {"model": server.endpoint.info()}}),
          flush=True)

    # graceful drain on SIGTERM: stop accepting, finish in-flight scoring,
    # exit 0
    def _drain(signum, frame):
        print(json.dumps({"draining": signum}), flush=True)
        threading.Thread(target=server.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _drain)
    except ValueError:  # not the main thread (tests drive serve_forever)
        pass
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # join in-flight handler threads FIRST, then drain the batcher
        server.server_close()
        server.batcher.close()


if __name__ == "__main__":
    main()
