"""Inference REST service over the port's sampler.

* ``POST /api/v1.0/bird``  — one caption -> ``{"bird": {small, medium,
  large, map1, map2, caption, elapsed}}``, 201 (one label per stage the
  generator makes: GDCGAN's one image is ``small``, as in the JAX
  service);
* ``POST /api/v1.0/birds`` — six generations -> ``{"bird": {bird1..bird6,
  caption, elapsed}}``, 201;
* ``GET  /``               — name and version;
* ``GET  /images/<name>``  — a stored image;
* telemetry: one event per request (WSGI middleware) and per generation,
  plus the container lifecycle events, to a JSON-lines sink named by the
  ``TELEMETRY`` environment variable ('' = stdout).

A dependency-free WSGI app.  Images go to a :class:`BlobStore`
(:class:`LocalDiskStore` by default).  Run with
``python -m sba_gan_tpu_torch.serving.app --synthetic`` (wsgiref) or under
any WSGI server.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np

__version__ = "1.0"


def make_telemetry(target: Optional[str] = None) -> Callable[[Dict], None]:
    """Telemetry sink: ``target`` a file path for JSON-lines output;
    None/'' or '-' emits to stdout."""
    if target and target != "-":
        def emit(event: Dict) -> None:
            with open(target, "a") as f:
                f.write(json.dumps({"telemetry": event}) + "\n")
        return emit
    return lambda event: print(json.dumps({"telemetry": event}), flush=True)


class TelemetryMiddleware:
    """WSGI middleware emitting one event per request."""

    def __init__(self, app: Callable, telemetry: Callable[[Dict], None]):
        self.app = app
        self.telemetry = telemetry

    def __call__(self, environ, start_response):
        t0 = time.time()
        status_box = {}

        def start(status, headers, exc_info=None):
            status_box["status"] = status
            return start_response(status, headers, exc_info)

        try:
            return self.app(environ, start)
        finally:
            self.telemetry({
                "event": "request",
                "method": environ.get("REQUEST_METHOD", ""),
                "path": environ.get("PATH_INFO", ""),
                "status": status_box.get("status", "500 Internal Server Error"),
                "ms": round((time.time() - t0) * 1000.0, 3),
            })


class BlobStore:
    """Minimal blob interface."""

    def put(self, name: str, data: bytes) -> str:
        raise NotImplementedError

    def get(self, name: str) -> Optional[bytes]:
        raise NotImplementedError


class LocalDiskStore(BlobStore):
    def __init__(self, root: str, url_prefix: str = "/images"):
        self.root = root
        self.url_prefix = url_prefix
        os.makedirs(root, exist_ok=True)

    def put(self, name: str, data: bytes) -> str:
        path = os.path.join(self.root, name)
        os.makedirs(os.path.dirname(path) or self.root, exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        return f"{self.url_prefix}/{name}"

    def get(self, name: str) -> Optional[bytes]:
        # confine to the blob root: reject traversal ("../", absolute paths)
        root = os.path.realpath(self.root)
        path = os.path.realpath(os.path.join(root, name))
        if not (path.startswith(root + os.sep) and os.path.isfile(path)):
            return None
        with open(path, "rb") as f:
            return f.read()


def _encode_uint8(img: np.ndarray, fmt: str) -> bytes:
    """Encode a HxWx3 uint8 array as 'png' (zlib level SBA_PNG_LEVEL,
    default 1) or 'jpeg' (PIL, quality SBA_JPEG_QUALITY, default 90).  Both
    release the GIL, so the service runs them concurrently."""
    if fmt == "jpeg":
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(img).save(
            buf, "JPEG",
            quality=int(os.environ.get("SBA_JPEG_QUALITY", "90")))
        return buf.getvalue()
    from sba_gan_tpu_torch.utils.image import png_bytes

    return png_bytes(img, level=int(os.environ.get("SBA_PNG_LEVEL", "1")))


class GanService:
    """caption -> urls of the generated stages and attention maps.

    ``sampler(captions, cap_lens, seed) -> (fakes, atts)`` returns tensors
    on the device without waiting for them (``Sampler.launch``);
    ``telemetry`` is an optional callable(event_dict), by default one JSON
    line per generation to stdout."""

    def __init__(self, sampler: Callable, wordtoix: Dict[str, int],
                 ixtoword: Dict[int, str], words_num: int, store: BlobStore,
                 telemetry: Optional[Callable] = None):
        self.sampler = sampler
        self.wordtoix = wordtoix
        self.ixtoword = ixtoword
        self.words_num = words_num
        self.store = store
        self.telemetry = telemetry if telemetry is not None else (
            make_telemetry(os.environ.get("TELEMETRY"))
        )

    def generate(self, caption: str, copies: int = 1, seed: int = 0,
                 map_format: str = "png", map_scale: float = 1.0) -> Dict:
        """``map_format`` ('png' | 'jpeg') and ``map_scale`` (0 < s <= 1)
        shrink the two attention-grid payloads; the defaults give PNG at full
        size.  The result's ``phases`` holds the wall-clock seconds of each
        step of the pipeline."""
        from sba_gan_tpu_torch.data.vocab import encode_free_text
        from sba_gan_tpu_torch.train.sample import fetch
        from sba_gan_tpu_torch.utils.image import to_uint8
        from sba_gan_tpu_torch.utils.viz import build_super_images

        t0 = time.time()
        phases: Dict[str, float] = {}

        def mark(name: str, since: float) -> float:
            now = time.time()
            phases[name] = round(phases.get(name, 0.0) + now - since, 4)
            return now

        t = t0
        ids, lens = encode_free_text([caption] * copies, self.wordtoix,
                                     self.words_num)
        t = mark("tokenize", t)
        fakes, atts = self.sampler(ids, lens, seed)
        # the sampler returns once its work is queued on the device ...
        t = mark("dispatch", t)
        # ... and the .cpu() copy is the fence that waits for it
        fakes, atts = fetch((fakes, atts))
        t = mark("compute_fetch", t)
        prefix = uuid.uuid4().hex[:12]
        names = ["small", "medium", "large"]
        map_ext = "jpg" if map_format == "jpeg" else "png"
        # jobs: (entry_idx, label, blob_name, uint8, fmt), encoded together
        jobs: List[tuple] = []
        for j in range(copies):
            for k, stage in enumerate(fakes):
                label = names[k] if k < len(names) else f"stage{k}"
                jobs.append((j, label, f"{prefix}/{j}_{label}.png",
                             to_uint8(stage[j]), "png"))
        t = mark("to_uint8", t)
        for j in range(copies):
            for a, att in enumerate(atts):
                stage_idx = min(a + 1, len(fakes) - 1)
                grid = build_super_images(
                    fakes[stage_idx][j: j + 1], ids[j: j + 1],
                    self.ixtoword, att[j: j + 1])
                g8 = to_uint8(grid / 127.5 - 1.0)
                if map_scale < 1.0:
                    from PIL import Image

                    im = Image.fromarray(g8)
                    im = im.resize((max(1, int(im.width * map_scale)),
                                    max(1, int(im.height * map_scale))),
                                   Image.BILINEAR)
                    g8 = np.asarray(im)
                jobs.append((j, f"map{a + 1}",
                             f"{prefix}/{j}_attn{a}.{map_ext}", g8,
                             map_format))
        t = mark("attn_viz", t)
        with ThreadPoolExecutor(max_workers=min(4, max(1, len(jobs)))) as pool:
            blobs = list(pool.map(lambda job: _encode_uint8(job[3], job[4]),
                                  jobs))
        t = mark("png", t)
        entries: List[Dict] = [{} for _ in range(copies)]
        for (j, label, blob_name, _, _), data in zip(jobs, blobs):
            entries[j][label] = self.store.put(blob_name, data)
        t = mark("blob", t)
        elapsed = round(time.time() - t0, 3)
        self.telemetry({"event": "generate", "copies": copies,
                        "elapsed": elapsed, "phases": phases})
        return {"caption": caption, "results": entries, "elapsed": elapsed,
                "phases": phases}


def make_wsgi_app(service: GanService):
    def respond(start, status: str, payload, ctype="application/json"):
        body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
        start(status, [("Content-Type", ctype),
                       ("Content-Length", str(len(body)))])
        return [body]

    def app(environ, start_response):
        path = environ.get("PATH_INFO", "/")
        method = environ.get("REQUEST_METHOD", "GET")
        if method == "GET" and path == "/":
            return respond(start_response, "200 OK",
                           {"version": __version__, "name": "sba_gan_tpu_torch"})
        if method == "GET" and path.startswith("/images/"):
            data = service.store.get(path[len("/images/"):])
            if data is None:
                return respond(start_response, "404 Not Found",
                               {"error": "not found"})
            ctype = ("image/jpeg" if path.endswith((".jpg", ".jpeg"))
                     else "image/png")
            return respond(start_response, "200 OK", data, ctype)
        if method == "POST" and path in ("/api/v1.0/bird", "/api/v1.0/birds"):
            try:
                n = int(environ.get("CONTENT_LENGTH") or 0)
                req = json.loads(environ["wsgi.input"].read(n) or b"{}")
                caption = req["caption"]
                seed = int(req.get("seed", 0))
            except (KeyError, TypeError, ValueError):
                return respond(start_response, "400 Bad Request",
                               {"error": "body must be JSON with 'caption'"})
            if not isinstance(caption, str):
                return respond(start_response, "400 Bad Request",
                               {"error": "'caption' must be a string"})
            copies = 6 if path.endswith("birds") else 1
            map_format = str(req.get("map_format", "png"))
            try:
                map_scale = float(req.get("map_scale", 1.0))
            except (TypeError, ValueError):
                map_scale = -1.0
            if map_format not in ("png", "jpeg") \
                    or not 0.0 < map_scale <= 1.0:
                return respond(
                    start_response, "400 Bad Request",
                    {"error": "map_format must be 'png'|'jpeg'; "
                              "map_scale in (0, 1]"})
            out = service.generate(caption, copies=copies, seed=seed,
                                   map_format=map_format, map_scale=map_scale)
            if copies == 1:
                bird = dict(out["results"][0])
            else:
                bird = {f"bird{j + 1}": out["results"][j]
                        for j in range(copies)}
            bird["caption"] = out["caption"]
            bird["elapsed"] = out["elapsed"]
            return respond(start_response, "201 Created", {"bird": bird})
        return respond(start_response, "404 Not Found", {"error": "no route"})

    return app


def require_word_vocabulary(cfg) -> None:
    """The service encodes captions with the word-id vocabulary, as the JAX
    package's does; ``MODEL.TEXT_ENCODER: bert`` raises."""
    if cfg.MODEL.TEXT_ENCODER != "rnn":
        raise NotImplementedError(
            f"MODEL.TEXT_ENCODER={cfg.MODEL.TEXT_ENCODER!r}: serving encodes captions "
            "with the word-id vocabulary only (ROADMAP.md, section 3)")


def build_service(cfg, sampler, wordtoix: Dict[str, int],
                  ixtoword: Dict[int, str], store_root: str,
                  telemetry: Optional[Callable] = None) -> GanService:
    """A GanService over ``sampler`` (a :class:`Sampler`): the service
    launches on the device and fences with its own ``.cpu()`` copy.  The
    word-id vocabulary only (:func:`require_word_vocabulary`)."""
    require_word_vocabulary(cfg)
    return GanService(sampler.launch, wordtoix, ixtoword, cfg.TEXT.WORDS_NUM,
                      LocalDiskStore(store_root), telemetry=telemetry)


def _read_vocab(path: str):
    """Word-id vocabulary from a caption cache in the reference layout
    ``[train_caps, test_caps, ixtoword, wordtoix]`` (pickle; read only a
    cache this repository wrote)."""
    import pickle

    with open(path, "rb") as f:
        _, _, ixtoword, wordtoix = pickle.load(f)[:4]
    return wordtoix, ixtoword


def main(argv=None):
    import argparse

    from sba_gan_tpu_torch.config import cfg_from_file, preset
    from sba_gan_tpu_torch.data.vocab import synthetic_vocab
    from sba_gan_tpu_torch.train.sample import Sampler

    p = argparse.ArgumentParser(description="serve text -> image over HTTP")
    p.add_argument("--cfg", default=None,
                   help="YAML preset (default: the port's eval_bird.yml)")
    p.add_argument("--weights", default=None,
                   help=".npz of the JAX package's trees (utils/weights.py); "
                        "random weights from --seed if absent")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic vocabulary w1..w{n_words-1}")
    p.add_argument("--n_words", type=int, default=5450,
                   help="vocabulary size with --synthetic (CUB: 5450)")
    p.add_argument("--captions", default=None,
                   help="captions.pickle whose vocabulary to serve")
    p.add_argument("--store", default="serving_blobs")
    p.add_argument("--device", default="cuda")
    p.add_argument("--port", type=int, default=8080)
    args = p.parse_args(argv)

    if args.synthetic == bool(args.captions):
        p.error("give exactly one of --synthetic and --captions")
    cfg = cfg_from_file(args.cfg) if args.cfg else preset("eval_bird")
    telemetry = make_telemetry(os.environ.get("TELEMETRY"))
    t0 = time.time()
    telemetry({"event": "container initializing"})
    if args.synthetic:
        wordtoix, ixtoword = synthetic_vocab(args.n_words)
    else:
        wordtoix, ixtoword = _read_vocab(args.captions)
    sampler = Sampler.from_config(cfg, len(ixtoword), seed=args.seed,
                                  weights=args.weights, device=args.device)
    service = build_service(cfg, sampler, wordtoix, ixtoword, args.store,
                            telemetry=telemetry)
    from wsgiref.simple_server import make_server

    telemetry({"event": "container start",
               "starttime": round(time.time() - t0, 3)})
    print(f"serving on :{args.port}", flush=True)
    app = TelemetryMiddleware(make_wsgi_app(service), telemetry)
    make_server("", args.port, app).serve_forever()


if __name__ == "__main__":
    main()
