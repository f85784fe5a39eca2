"""HTTP micro-batching inference server for the multimodal model.

One process loads a checkpoint (or seeded random weights for smoke tests),
warms a fixed-batch `serve.Predictor` on the GPU and scores concurrent HTTP
requests through a `serve.MicroBatcher`: whatever arrives within
--max_delay_ms is coalesced into ONE padded forward.  `--quantize int8|w8a8`
serves int8 weights (utils/quantize.py).  `--exported` serves artifacts of
cli/export_model.py instead, with no model class or checkpoint load:
`--exported <dir>` one model at POST /score, `--exported a=<dir1>,b=<dir2>`
co-resident models at POST /score/a and /score/b.

  python -m multimodalaggressionrecognition_tpu_torch.cli.serve \
      --path_to_checkpoint model.pt --modalities audio,text,video --port 8000

Protocol:
  GET  /healthz -> {"ok": true, "models": {name: {modalities, heads,
                    batch_size}}} (+ the same fields flat with one model)
  GET  /statz   -> per model: requests, clips, dispatches, coalescing
                    factor (clips/dispatches), recent-latency p50/p99
  POST /score   -> {"phys": [[p_neg, p_aggr], ...], "verb": ...}
  POST /score/<name> -> the same, from one of several co-resident models
      Body is JSON ({"audio": clip-or-batch, "text": ...}) or an np.savez
      archive with Content-Type application/x-npz.  A clip is audio (L,),
      text (T, H) or video (T, S, S, 3) frames at the model's --video_size
      (a feature-sequence artifact's video is (T, D)); a leading batch dim
      is accepted, and variable lengths (samples, tokens, frames) are
      padded/truncated to the model's sizes.  Every request carries the
      model's full modality set; batches larger than its batch size are
      chunked across micro-batch groups.

Runs on CUDA unless --device cpu.  `--data_parallel` serves one replica
on every visible card (the CPU is one device), the batch split evenly over
them (`serve.Predictor(devices=...)`).  `--model_parallelism N` > 1 serves
dp x tp over every visible card, with or without --data_parallel, as the
JAX package does: N must divide the card count, each group of N cards
holds one model copy with its transformer blocks split over them, and the
batch is split over the card count / N groups
(`serve.Predictor(devices=..., model_parallelism=N)`).  torch has one CPU
device, so `--device cpu` holds all N shards on it (one data group).
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
    # serve export_model artifacts instead of a model from config +
    # checkpoint; every shape comes from the artifact's meta:
    #   --exported <dir>               one model at POST /score
    #   --exported a=<dir1>,b=<dir2>   co-resident models, /score/<name>
    exported: str = ""
    host: str = "127.0.0.1"
    port: int = 8000
    batch_size: int = 32
    max_delay_ms: float = 2.0   # micro-batch coalescing window
    quantize: str = ""          # '', 'int8' (weight-only), 'w8a8'
    device: str = "cuda"
    # explicit opt-in for serving untrained weights (smoke tests only);
    # without it a missing --path_to_checkpoint is an error, never a
    # healthy-looking server scoring garbage
    allow_random_weights: bool = False


@dataclass
class _Endpoint:
    """One served model: its batcher plus everything the handler needs."""

    name: str
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

    def _endpoint(self):
        """/score (the sole model) or /score/<name> -> its endpoint."""
        endpoints = self.server.endpoints
        if self.path == "/score":
            if len(endpoints) == 1:
                return next(iter(endpoints.values()))
            raise LookupError(
                f"this server hosts multiple models {sorted(endpoints)}; "
                "POST /score/<name>")
        if self.path.startswith("/score/"):
            name = self.path[len("/score/"):]
            if name in endpoints:
                return endpoints[name]
            raise LookupError(
                f"unknown model {name!r}; served: {sorted(endpoints)}")
        raise LookupError(f"unknown path {self.path!r}")

    def do_GET(self):
        endpoints = self.server.endpoints
        if self.path == "/healthz":
            payload = {"ok": True, "models": {name: ep.info() for name, ep
                                              in endpoints.items()}}
            if len(endpoints) == 1:  # one model keeps the flat fields
                payload.update(next(iter(endpoints.values())).info())
            self._reply(200, payload)
        elif self.path == "/statz":
            self._reply(200, {name: ep.stats()
                              for name, ep in endpoints.items()})
        else:
            self._reply(404, {"error": f"unknown path {self.path!r}"})

    def do_POST(self):
        try:
            ep = self._endpoint()
        except LookupError as e:
            return self._reply(404, {"error": str(e)})
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


def _exported_entries(cfg) -> dict:
    """--exported -> {name: artifact dir}: one unnamed dir is "model";
    several must all be named, each name once."""
    if cfg.path_to_checkpoint or cfg.quantize:
        raise SystemExit(
            "--exported conflicts with --path_to_checkpoint/--quantize: the "
            "artifact's weights (and any int8 quantization) were baked in "
            "at export time; re-export to change them")
    entries = [e for e in cfg.exported.split(",") if e]
    if not any("=" in e for e in entries):
        if len(entries) != 1:
            raise SystemExit(
                "--exported: multiple artifacts need names (a=dir1,b=dir2)")
        return {"model": entries[0]}
    if not all("=" in e for e in entries):
        raise SystemExit("--exported: mixing named (name=dir) and unnamed "
                         "entries is ambiguous; name all of them")
    pairs = [e.split("=", 1) for e in entries]
    names = [n for n, _ in pairs]
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        # a duplicate name would serve only the last artifact while the
        # operator believes both are live
        raise SystemExit(f"--exported: duplicate model names {dupes}; each "
                         "name maps to one artifact")
    return dict(pairs)


def build_server(cfg: ServeConfig, state_dict=None,
                 devices=None) -> ThreadingHTTPServer:
    """Construct the HTTP server (not yet serving): builds the model, loads
    its weights, warms the Predictor on `cfg.device` and starts the
    MicroBatcher; or, with --exported, loads and warms each artifact.
    Pass `state_dict` to skip checkpoint restore, and `devices` to serve
    over that device list in place of the visible ones (tests and the
    smoke run: e.g. ["cuda:0", "cuda:0"] serves tp 2 on one card); neither
    is a flag."""
    from ..data.transforms import pad_audio, pad_text, pad_video
    from ..serve import MicroBatcher, resolve_device

    device = resolve_device(cfg.device)  # fail before any model work
    devices = serving_devices(cfg, device, devices)
    pad_builders = {"audio": pad_audio, "text": pad_text, "video": pad_video}

    def endpoint(name, predictor, shapes):
        # pad/truncate each modality to its clip length (the leading dim of
        # its clip shape) and validate clips by the shapes' ndims, so a
        # feature-sequence artifact's (T, D) "video" works too
        return _Endpoint(
            name=name, predictor=predictor,
            batcher=MicroBatcher(predictor, max_delay_ms=cfg.max_delay_ms),
            modalities=set(shapes),
            pads={m: pad_builders[m](shapes[m][0]) for m in shapes},
            ndims={m: len(shapes[m]) for m in shapes},
            batch_size=predictor.batch_size, heads=predictor.heads)

    endpoints = {}
    if cfg.exported:
        from ..io.export import ExportedPredictor

        for name, path in _exported_entries(cfg).items():
            pred = ExportedPredictor(
                path, device=device, devices=devices,
                model_parallelism=cfg.model_parallelism).warmup()
            endpoints[name] = endpoint(name, pred, pred.clip_shapes)
    else:
        endpoints["model"] = endpoint(
            "model", *_live_predictor(cfg, device, state_dict, devices))

    server = ThreadingHTTPServer((cfg.host, cfg.port), _Handler)
    # NON-daemon handler threads: server_close() joins only non-daemon
    # handlers, and the drain contract needs that join; server_close() runs
    # BEFORE the batchers close (see main), so in-flight handlers can still
    # submit() and their futures resolve
    server.daemon_threads = False
    server.endpoints = endpoints
    if len(endpoints) == 1:  # flat aliases for the one-model case
        ep = next(iter(endpoints.values()))
        server.endpoint = ep
        server.predictor = ep.predictor
        server.batcher = ep.batcher
    return server


def serving_devices(cfg, device, devices=None):
    """The devices to serve over, or None for one device: `devices` when
    given, else under --data_parallel or --model_parallelism > 1 every
    visible card (torch's one CPU device once for --data_parallel, N times
    for --model_parallelism N).  --model_parallelism must divide their
    number."""
    tp = cfg.model_parallelism
    if devices is None:
        if not cfg.data_parallel and tp <= 1:
            return None
        if device.type != "cuda":
            return [device] * tp
        import torch

        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if tp < 1 or len(devices) % tp:
        raise SystemExit(f"--model_parallelism {tp} does not divide the "
                         f"{len(devices)} available devices")
    return devices


def _live_predictor(cfg, device, state_dict, devices=None):
    """(the warmed Predictor of the config's model, its clip shapes)."""
    from ..io.checkpoint import restore_variables
    from ..models.layers import seeded_init_
    from ..serve import Predictor
    from .common import clip_shapes_from_config, compute_dtype, quantize_mode

    dtype, quantize = compute_dtype(cfg), quantize_mode(cfg)
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
                          device=device, compute_dtype=dtype,
                          quantize=quantize, devices=devices,
                          model_parallelism=cfg.model_parallelism)
    predictor.warmup({m: np.zeros((1,) + shapes[m], np.float32)
                      for m in modalities})
    return predictor, shapes


def main(argv=None):
    import signal

    cfg = parse_config(ServeConfig, argv)
    server = build_server(cfg)
    host, port = server.server_address[:2]
    print(json.dumps({"serving": f"http://{host}:{port}",
                      "models": {name: ep.info() for name, ep
                                 in server.endpoints.items()}}),
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
        # join in-flight handler threads FIRST, then drain every batcher
        server.server_close()
        for ep in server.endpoints.values():
            ep.batcher.close()


if __name__ == "__main__":
    main()
