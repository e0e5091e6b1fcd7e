"""HTTP model server: `python -m recalgorithm_tpu_torch.cli.serve --model DIN ...`

Counterpart of ``recalgorithm_tpu/cli/serve.py``: a standalone JSON/HTTP
server over the best export of ``--model_dir`` (optionally with int8 tables,
``--quantize``), or hermetically over ``torch.export`` artifacts of
serving/export.py with no model code (``--stablehlo``, repeatable as
``name=path``, each routed at ``/predict/<name>``), with dynamic request
batching (serving/server.py), on the GPU unless ``--device cpu``.

    POST /predict   {"userid": 12, "feedid": "feedid_987", "dense": [...],
                     "his_read_comment_7d_seq": [3, 17, ...]}
                ->  {"predictions": {"read_comment": 0.031, ...}}
    GET  /healthz   "ok"
    GET  /metrics   batching counters; batch_latency_ms_p50/p99 (a flush,
                    from stacking to its answers) and queue_wait_ms_p50/p99
                    (each batch's oldest example, from its enqueue to the
                    flush), over the last 4,096 batches

Features may be pre-translated int ids (the framework's standard serving
input) or raw string tokens when --vocabulary_dir is given (host-side
translation, same as training).  Missing features default to 0 / PAD —
`tf.Example` absent-feature semantics.  Sequences are truncated/padded to
the schema's max length and their `*_len` columns derived automatically.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import typing
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def make_example(schema, payload, vocabs=None) -> dict[str, np.ndarray]:
    """One JSON feature dict -> one framework example (unbatched arrays)."""

    def to_id(field, v):
        if isinstance(v, str):
            if vocabs is None:
                raise ValueError(
                    f"{field.name}: string token {v!r} needs --vocabulary_dir"
                )
            return vocabs[field.vocab].lookup(v)
        return int(v)

    ex: dict[str, np.ndarray] = {}
    dense = np.zeros(len(schema.dense), np.float32)
    if "dense" in payload:
        vals = np.asarray(payload["dense"], np.float32)
        dense[: len(vals)] = vals
    else:
        for i, f in enumerate(schema.dense):
            if f.name in payload:
                dense[i] = float(payload[f.name])
    ex["dense"] = dense
    for f in schema.categorical:
        ex[f.name] = np.int32(to_id(f, payload.get(f.name, 0)))
    for f in schema.sequence:
        toks = payload.get(f.name, []) or []
        ids = [to_id(f, t) for t in toks][: f.max_length]
        arr = np.zeros(f.max_length, np.int32)
        arr[: len(ids)] = ids
        ex[f.name] = arr
        ex[f.name + "_len"] = np.int32(len(ids))
    return ex


class _RouteError(Exception):
    """Unknown path / model name — the only errors mapped to HTTP 404."""


def build_handler(batchers, schema, vocabs=None, timeout_s: float = 30.0):
    """``batchers``: {model_name: BatchingPredictor}.  One model serves at
    /predict; several at /predict/<name>, with /predict routing only when
    the name is unambiguous."""
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet access log
            pass

        def _send(self, code: int, body: dict | str):
            data = (body if isinstance(body, str) else json.dumps(body)).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json"
                             if not isinstance(body, str) else "text/plain")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _batching(self, path):
            if path.startswith("/predict/"):
                name = path[len("/predict/"):]
                if name in batchers:
                    return batchers[name]
                raise _RouteError(f"unknown model {name!r}; serving "
                                  f"{sorted(batchers)}")
            if path == "/predict":
                if len(batchers) == 1:
                    return next(iter(batchers.values()))
                raise _RouteError(f"several models served — POST to "
                                  f"/predict/<name>, one of {sorted(batchers)}")
            raise _RouteError("unknown path")

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, "ok")
            elif self.path == "/metrics":
                stats = {n: b.stats() for n, b in batchers.items()}
                self._send(200, next(iter(stats.values()))
                           if len(stats) == 1 else stats)
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            # input-shaped failures (JSON, coercion, routing) -> 400;
            # anything after the example is enqueued (timeout, worker
            # fault) is a SERVER error -> 500, so monitoring/retry policy
            # sees the outage
            try:
                batching = self._batching(self.path)
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                ex = make_example(schema, payload, vocabs)
            except Exception as exc:
                self._send(404 if isinstance(exc, _RouteError) else 400,
                           {"error": f"{type(exc).__name__}: {exc}"})
                return
            try:
                out = batching.predict_async(ex).result(timeout=timeout_s)
                preds = {
                    t: (v if np.ndim(v) == 0 else np.asarray(v).tolist())
                    for t, v in out.items()
                }
                self._send(200, {"predictions": preds})
            except Exception as exc:  # never kills the server
                self._send(500, {"error": f"{type(exc).__name__}: {exc}"})

    return Handler


def build_server(args) -> tuple[ThreadingHTTPServer, dict]:
    """Construct (httpd, {name: BatchingPredictor}) from parsed args;
    caller serves and closes every batcher.  ``args.device`` (default
    ``cuda``) places the model; no card and no ``cpu`` request raises."""
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.serving.predictor import HLOPredictor, Predictor
    from recalgorithm_tpu_torch.serving.server import BatchingPredictor
    from recalgorithm_tpu_torch.utils.device import resolve_device

    device = resolve_device(getattr(args, "device", None))
    vocabs = None
    if args.vocabulary_dir:
        from recalgorithm_tpu_torch.features.vocab import VocabularyStore

        vocabs = VocabularyStore.from_dir(args.vocabulary_dir)
        schema = wechat_schema(vocabs.sizes())
    else:
        from recalgorithm_tpu_torch.data.synthetic import SyntheticWeChat, SyntheticConfig

        gen = SyntheticWeChat(
            wechat_schema(),
            SyntheticConfig(seed=0, vocab_scale=args.synthetic_vocab_scale),
        )
        schema = wechat_schema(gen.vocab_sizes())

    if getattr(args, "stablehlo", None):
        # hermetic mode: artifacts only, no model code.  Each spec is "path"
        # or "name=path" (several models behind one server, routed by name);
        # "name=" only when the left side has no path separator
        batchers = {}
        for i, spec in enumerate(args.stablehlo):
            name, sep, path = spec.partition("=")
            if not sep or not name or "/" in name:
                name, path = "", spec
            name = name or (f"model_{i}" if len(args.stablehlo) > 1 else "default")
            pred = HLOPredictor(path, device=device)
            batchers[name] = BatchingPredictor(
                pred, max_batch_size=pred.batch_size,
                max_delay_ms=args.max_delay_ms, buckets=(pred.batch_size,))
    else:
        from recalgorithm_tpu_torch.models import MODEL_REGISTRY

        cfg_cls, model_cls = MODEL_REGISTRY[args.model]
        cfg_kwargs = {
            f.name: getattr(args, f.name)
            for f in dataclasses.fields(cfg_cls) if hasattr(args, f.name)
        }
        model = model_cls(config=cfg_cls(**cfg_kwargs), schema=schema)
        export_dir = args.export_dir or Predictor.latest_best(args.model_dir)
        pred = Predictor(model, export_dir, device=device,
                         quantize=getattr(args, "quantize", False))
        batchers = {args.model: BatchingPredictor(
            pred, max_batch_size=args.max_batch_size,
            max_delay_ms=args.max_delay_ms,
        )}
    for b in batchers.values():
        b.warmup(make_example(schema, {}, vocabs))
    handler = build_handler(batchers, schema, vocabs)

    class _Server(ThreadingHTTPServer):
        # drain semantics: shutdown() must wait for in-flight handler
        # threads (each bounded by the predict timeout) BEFORE the caller
        # closes the batchers — otherwise a request enqueued after the
        # worker sentinel never resolves and its client sees a reset
        daemon_threads = False
        block_on_close = True

    httpd = _Server((args.host, args.port), handler)
    return httpd, batchers


def add_dataclass_flags(parser: argparse.ArgumentParser, cfg_cls) -> None:
    """One ``--<field>`` flag per config field, parsed as the JAX CLI parses
    them (bools from true/1/yes, tuples comma-separated)."""
    hints = typing.get_type_hints(cfg_cls)
    for f in dataclasses.fields(cfg_cls):
        name = "--" + f.name
        ftype = hints.get(f.name, str)
        if ftype is bool:
            parser.add_argument(
                name, type=lambda s: s.lower() in ("true", "1", "yes"),
                default=f.default,
            )
        elif typing.get_origin(ftype) is tuple:
            args = typing.get_args(ftype)
            elem = args[0] if args else str
            parser.add_argument(
                name, type=lambda s, e=elem: tuple(e(x) for x in s.split(",") if x),
                default=f.default,
            )
        elif ftype in (int, float, str):
            parser.add_argument(name, type=ftype, default=f.default)
        else:
            parser.add_argument(name, type=str, default=f.default)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--model", default=None)
    pre_args, _ = pre.parse_known_args(argv)
    # the model code is imported only when a --model is served: an artifact
    # (--stablehlo) serves without it
    registry = {}
    if pre_args.model is not None:
        from recalgorithm_tpu_torch.models import MODEL_REGISTRY as registry

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default=None, choices=sorted(registry) or None,
                   help="model class of the export; not needed with --stablehlo")
    p.add_argument("--stablehlo", action="append", default=None,
                   help="serve a torch.export artifact of serving/export.py with no "
                   "model code (the name is the JAX CLI's); batch size and inputs come "
                   "from its .manifest.json.  Repeatable as name=path to serve several "
                   "models at /predict/<name>")
    p.add_argument("--model_dir", default="./model_dir",
                   help="training dir; serves its best export")
    p.add_argument("--export_dir", default=None,
                   help="explicit export directory (overrides --model_dir)")
    p.add_argument("--vocabulary_dir", default=None,
                   help="enables raw string tokens in requests")
    p.add_argument("--synthetic_vocab_scale", type=float, default=0.01,
                   help="schema sizing when no vocabulary_dir (1.0 = the "
                   "real WeChat table sizes)")
    p.add_argument("--quantize", action="store_true",
                   help="serve the gather-path embedding tables as per-row int8")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model: cuda (default; raises "
                   "without a GPU) or cpu")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8377)
    p.add_argument("--max_batch_size", type=int, default=256)
    p.add_argument("--max_delay_ms", type=float, default=2.0)
    if pre_args.model in registry:
        add_dataclass_flags(p, registry[pre_args.model][0])
    args = p.parse_args(argv)
    if not args.model and not args.stablehlo:
        p.error("one of --model or --stablehlo is required")

    httpd, batchers = build_server(args)
    print(f"serving {sorted(batchers)} on http://{args.host}:{args.port} "
          f"(device={args.device}, quantize={args.quantize})", flush=True)

    # graceful drain on SIGTERM (K8s/preemption): stop accepting, finish
    # queued requests, exit 0
    import signal
    import threading

    def _term(signum, frame):
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        for b in batchers.values():
            b.close()
        print(f"shutdown: { {n: b.stats() for n, b in batchers.items()} }",
              flush=True)


if __name__ == "__main__":
    main()
