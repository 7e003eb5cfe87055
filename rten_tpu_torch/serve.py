"""HTTP serving front-end over the continuous-batching engine (port of
``rten_tpu/serve.py``).

An OpenAI-style completions API with server-sent-event streaming, backed
by one ``ServingEngine`` whose continuous batch is shared by all
connections.

Design: HTTP handler threads never touch the engine (it is not
thread-safe, and every CUDA launch stays on one thread). A single driver
thread owns the engine — handlers marshal submissions, prefix
registrations and /stats snapshots through a queue and receive token
deltas (host ints) through per-request queues. The
driver runs ``step_burst`` while work is pending, so concurrent requests
ride the same decode step via slot recycling.

    python -m rten_tpu_torch.serve --demo --quantize int8 --port 8000
    python -m rten_tpu_torch.serve --demo --device cpu --port 8000
    curl -d '{"prompt": [1,2,3], "max_tokens": 8}' localhost:8000/v1/completions

Endpoints: POST /v1/completions (stream=true → SSE), POST
/v1/chat/completions, POST /v1/prefixes, GET /v1/models, GET /health,
GET /stats.

Not ported yet: ``--mesh`` and ``--overlap`` raise naming ROADMAP.md
Queue 1, parallel/; ``--spec-draft`` builds the engine as the reference
does (``spec_adaptive="auto"``), which raises naming ROADMAP.md Queue 1,
speculative gate.
"""

from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .generate.text_decoder import TextDecoder


class StreamHandle:
    """Per-request channel from the driver thread to an HTTP handler."""

    def __init__(self):
        self.q: queue.Queue = queue.Queue()
        self.request = None          # engine Request, set on admission

    def events(self):
        """Yield ("tokens", [ids]) deltas until ("done", reason) or
        ("error", message)."""
        while True:
            kind, payload = self.q.get()
            yield kind, payload
            if kind in ("done", "error"):
                return


class EngineDriver:
    """Single thread that owns a ServingEngine; thread-safe submit()."""

    def __init__(self, engine, burst: int = 8, idle_poll_s: float = 0.02):
        self.engine = engine
        self.burst = burst
        self._submit_q: queue.Queue = queue.Queue()
        self._wake = threading.Event()
        self._stop = threading.Event()
        # (handle, request, n_delivered) for requests still streaming.
        self._live: list[list] = []
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="engine-driver")

    def start(self):
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0):
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout)

    def submit(self, prompt_ids, max_new_tokens=128, stop_ids=(),
               sampling=None) -> StreamHandle:
        handle = StreamHandle()
        self._submit_q.put(("gen", handle, list(prompt_ids),
                            int(max_new_tokens), tuple(stop_ids), sampling))
        self._wake.set()
        return handle

    def cancel(self, handle: StreamHandle):
        """Thread-safe cancellation (e.g. the client disconnected
        mid-stream): the driver thread aborts the engine request and
        stops delivering to this handle."""
        self._submit_q.put(("cancel", handle))
        self._wake.set()

    def register_prefix(self, prompt_ids, timeout: float = 600.0):
        """Thread-safe prefix-cache registration (blocks until the
        driver thread has prefilled and pinned the fragment)."""
        reply: queue.Queue = queue.Queue()
        self._submit_q.put(("prefix", reply, list(prompt_ids)))
        self._wake.set()
        kind, payload = reply.get(timeout=timeout)
        if kind == "error":
            raise ValueError(payload)
        return payload

    def stats(self, timeout: float = 60.0) -> dict:
        """The engine's ``stats()``, taken on the driver thread between
        bursts (the engine's counters and latency reservoirs change under
        every step, so no other thread reads them)."""
        reply: queue.Queue = queue.Queue()
        self._submit_q.put(("stats", reply))
        self._wake.set()
        return reply.get(timeout=timeout)

    # -- driver thread --------------------------------------------------

    def _drain_submits(self):
        while True:
            try:
                entry = self._submit_q.get_nowait()
            except queue.Empty:
                return
            if entry[0] == "cancel":
                _, handle = entry
                if handle.request is not None:
                    self.engine.cancel(handle.request)
                self._live = [e for e in self._live if e[0] is not handle]
                continue
            if entry[0] == "stats":
                entry[1].put(self.engine.stats())
                continue
            if entry[0] == "prefix":
                _, reply, ids = entry
                try:
                    reply.put(("ok", self.engine.register_prefix(ids)))
                except Exception as exc:
                    reply.put(("error", str(exc)))
                continue
            _, handle, ids, max_new, stop_ids, sampling = entry
            try:
                req = self.engine.submit(ids, max_new_tokens=max_new,
                                         stop_ids=stop_ids,
                                         sampling=sampling)
            except Exception as exc:
                handle.q.put(("error", str(exc)))
                continue
            handle.request = req
            self._live.append([handle, req, 0])

    def _deliver(self):
        still = []
        for entry in self._live:
            handle, req, delivered = entry
            fresh = req.tokens[delivered:]
            if fresh:
                handle.q.put(("tokens", fresh))
                entry[2] = len(req.tokens)
            if req.done:
                reason = ("stop" if req.tokens and
                          req.tokens[-1] in req.stop_ids else "length")
                handle.q.put(("done", reason))
            else:
                still.append(entry)
        self._live = still

    def _loop(self):
        while not self._stop.is_set():
            self._drain_submits()
            if self.engine._pending():
                try:
                    if self.burst > 1:
                        self.engine.step_burst(self.burst)
                    else:
                        self.engine.step()
                except Exception as exc:  # noqa: BLE001
                    # A stepping failure must not kill the driver thread
                    # (handlers would block forever): fail the in-flight
                    # requests, drop engine queue state, keep serving.
                    for handle, _req, _n in self._live:
                        handle.q.put(("error", f"engine error: {exc}"))
                    self._live = []
                    self.engine.queue.clear()
                    continue
                self._deliver()
            else:
                self._wake.wait(timeout=0.25)
                self._wake.clear()
        # Unblock any handler still waiting.
        for handle, _req, _n in self._live:
            handle.q.put(("error", "server shutting down"))


def _sse(wfile, payload):
    data = payload if isinstance(payload, str) else json.dumps(payload)
    wfile.write(f"data: {data}\n\n".encode())
    wfile.flush()


def make_handler(driver: EngineDriver, tokenizer=None,
                 model_id: str = "rten-tpu", quiet: bool = True,
                 chat_template="plain"):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: N802
            if not quiet:
                super().log_message(fmt, *args)

        def _json(self, status, payload):
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/health":
                self._json(200, {"status": "ok"})
            elif self.path == "/stats":
                self._json(200, driver.stats())
            elif self.path == "/v1/models":
                self._json(200, {"object": "list",
                                 "data": [{"id": model_id,
                                           "object": "model"}]})
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            chat = self.path in ("/v1/chat/completions",
                                 "/chat/completions")
            if not chat and self.path not in ("/v1/completions",
                                              "/completions",
                                              "/v1/prefixes"):
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError) as exc:
                self._json(400, {"error": f"bad request body: {exc}"})
                return

            prompt = body.get("prompt")
            if chat:
                if tokenizer is None:
                    self._json(400, {"error": "chat completions need a "
                                              "tokenizer"})
                    return
                from .generate.chat import render_chat
                try:
                    prompt = render_chat(body.get("messages"),
                                         chat_template)
                except ValueError as exc:
                    self._json(400, {"error": str(exc)})
                    return
            if self.path == "/v1/prefixes":
                # Pin a shared prompt prefix (system prompt) in the KV
                # prefix cache; later completions extending it skip its
                # prefill.
                if isinstance(prompt, str) and tokenizer is not None:
                    prompt = tokenizer.encode(prompt)
                if not (isinstance(prompt, list) and all(
                        isinstance(t, int) for t in prompt)):
                    self._json(400, {"error": "prompt must be token ids "
                                              "(or a string with a "
                                              "tokenizer)"})
                    return
                try:
                    n = driver.register_prefix(prompt)
                except ValueError as exc:
                    self._json(400, {"error": str(exc)})
                    return
                self._json(200, {"registered": n})
                return
            if isinstance(prompt, str):
                if tokenizer is None:
                    self._json(400, {"error": "string prompt needs a "
                                              "tokenizer; pass token ids"})
                    return
                prompt_ids = tokenizer.encode(prompt)
            elif isinstance(prompt, list) and all(
                    isinstance(t, int) for t in prompt):
                prompt_ids = prompt
            else:
                self._json(400, {"error": "prompt must be a string or a "
                                          "list of token ids"})
                return

            max_tokens = int(body.get("max_tokens", 128))
            stop_ids = tuple(body.get("stop_ids", ()))
            stream = bool(body.get("stream", False))
            sampling = None
            if any(k in body for k in ("temperature", "top_k", "top_p")):
                from .generate.sampler import SamplingParams
                sampling = SamplingParams(
                    temperature=float(body.get("temperature", 1.0)),
                    top_k=int(body.get("top_k", 0)),
                    top_p=float(body.get("top_p", 1.0)))
            handle = driver.submit(prompt_ids, max_tokens, stop_ids,
                                   sampling)
            decoder = TextDecoder(tokenizer) if tokenizer else None

            obj = "chat.completion.chunk" if chat else "completion.chunk"

            def chunk(token_ids, text, finish=None):
                if chat:
                    c = {"delta": {"content": text} if text else {}}
                else:
                    c = {"token_ids": token_ids, "text": text}
                if finish is not None:
                    c["finish_reason"] = finish
                return {"object": obj, "choices": [c]}

            if stream:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                try:
                    for kind, payload in handle.events():
                        if kind == "tokens":
                            text = ("".join(decoder.push(t)
                                            for t in payload)
                                    if decoder else "")
                            _sse(self.wfile, chunk(payload, text))
                        elif kind == "done":
                            if decoder:
                                tail = decoder.flush()
                                if tail:
                                    _sse(self.wfile, chunk([], tail))
                            _sse(self.wfile, chunk([], "", finish=payload))
                            _sse(self.wfile, "[DONE]")
                        else:  # error
                            _sse(self.wfile, {"error": payload})
                except (BrokenPipeError, ConnectionResetError):
                    # Client went away mid-stream: stop generating for it
                    # so the slot goes back to the batch.
                    driver.cancel(handle)
                return

            tokens, reason = [], "length"
            for kind, payload in handle.events():
                if kind == "tokens":
                    tokens.extend(payload)
                elif kind == "done":
                    reason = payload
                else:
                    self._json(400, {"error": payload})
                    return
            req = handle.request
            text = tokenizer.decode(tokens) if tokenizer else ""
            if chat:
                choice = {"index": 0,
                          "message": {"role": "assistant", "content": text},
                          "finish_reason": reason}
            else:
                choice = {"index": 0, "token_ids": tokens, "text": text,
                          "finish_reason": reason}
            if body.get("logprobs") and req is not None and req.logprobs:
                choice["logprobs"] = {
                    "token_logprobs": [round(v, 6) for v in req.logprobs],
                    "tokens": list(tokens)}
            resp = {
                "object": "chat.completion" if chat else "text_completion",
                "model": model_id,
                "choices": [choice],
                "usage": {
                    "prompt_tokens": len(prompt_ids),
                    "completion_tokens": len(tokens),
                    "total_tokens": len(prompt_ids) + len(tokens),
                },
            }
            if req is not None and req.metrics.ttft_s is not None:
                resp["metrics"] = {
                    "ttft_s": round(req.metrics.ttft_s, 4),
                    "tokens_per_s": round(
                        req.metrics.tokens_per_second(), 2),
                }
            self._json(200, resp)

    return Handler


class _Server(ThreadingHTTPServer):
    """A ThreadingHTTPServer whose listen backlog holds a burst of
    concurrent connections (the socketserver default of 5 resets the
    rest when a hundred clients connect at once)."""
    request_queue_size = 1024
    daemon_threads = True


def serve(engine, tokenizer=None, host="127.0.0.1", port=8000,
          burst: int = 8, model_id: str = "rten-tpu", quiet: bool = True,
          chat_template="plain"):
    """Start the driver thread + a ThreadingHTTPServer (not yet serving;
    call ``serve_forever`` or use it from a test). Returns (server,
    driver)."""
    driver = EngineDriver(engine, burst=burst).start()
    handler = make_handler(driver, tokenizer, model_id, quiet=quiet,
                           chat_template=chat_template)
    server = _Server((host, port), handler)
    return server, driver


def build_engine(args, parser=None):
    """CLI args → (ServingEngine, tokenizer). Split out of main() so the
    flag→engine wiring is unit-testable: under ``--quantize`` the KV cache
    policy is ``cache="auto"`` (the int8 cache, with its tail window where
    the engine's gate allows it), and it must reach the engine.
    ``args.device`` (default "cuda") raises without a card."""
    from .device import resolve_device
    from .generate.engine import ServingEngine
    from .generate.sampler import ArgMaxSampler, PerRequestSampler
    from .models.transformer import (TransformerConfig, TransformerLM,
                                     quantize_weights)

    if getattr(args, "mesh", None) or getattr(args, "overlap", False):
        raise NotImplementedError(
            "--mesh/--overlap: meshes are not ported yet (ROADMAP.md "
            "Queue 1, parallel/)")
    device = resolve_device(getattr(args, "device", None) or "cuda")
    cfg = TransformerConfig.gpt2()
    model = TransformerLM(cfg)
    if args.weights:
        from .models import hf_loader
        from .models.convert import params_from_numpy
        params = params_from_numpy(hf_loader.load_gpt2(args.weights, cfg),
                                   device=device)
    elif args.demo:
        params = model.init_params(0, device=device)
    else:
        if parser is None:
            raise ValueError("pass --weights or --demo")
        parser.error("pass --weights or --demo")
    if args.quantize:
        params = quantize_weights(params, args.quantize)

    tok = None
    if args.tokenizer:
        from .text import from_json_file
        tok = from_json_file(args.tokenizer)

    sampler = (ArgMaxSampler() if args.fixed_greedy or args.spec_draft
               else PerRequestSampler())
    # The int8 cache under --quantize: the engine's "auto" policy resolves
    # it, falling back to bf16 where the decode kernels cannot read int8.
    kv = args.kv_cache or ("auto" if args.quantize else "f32")
    engine = ServingEngine(model, params, max_batch=args.max_batch,
                           capacity=args.capacity, sampler=sampler,
                           cache=kv,
                           paged=args.paged, page_size=args.page_size,
                           spec_draft=args.spec_draft,
                           logprobs=args.logprobs, device=device)
    return engine, tok


def main(argv=None):  # pragma: no cover - exercised via --demo smoke
    import argparse

    parser = argparse.ArgumentParser(
        description="Serve a model over HTTP (OpenAI-style completions).")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--demo", action="store_true",
                        help="random-weight GPT-2-small (no files needed)")
    parser.add_argument("--weights", help="HF GPT-2 weights file")
    parser.add_argument("--tokenizer", help="HF tokenizer.json")
    parser.add_argument("--quantize", choices=["int8", "int4"])
    parser.add_argument("--kv-cache",
                        choices=["auto", "bf16", "int8", "f32"],
                        help="KV cache storage: int8 (default under "
                        "--quantize via auto), bf16, f32, or auto (int8 "
                        "where the decode kernels read it, else bf16)")
    parser.add_argument("--paged", action="store_true",
                        help="block-paged KV pool (composes with "
                        "--kv-cache int8)")
    parser.add_argument("--page-size", type=int, default=64)
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--capacity", type=int, default=1024)
    parser.add_argument("--burst", type=int, default=8)
    parser.add_argument("--fixed-greedy", action="store_true",
                        help="engine-wide greedy sampling (enables the "
                             "fused LM-head+argmax kernel) instead of "
                             "per-request temperature/top_k/top_p")
    parser.add_argument("--spec-draft", type=int, default=0, metavar="K",
                        help="speculative decoding: draft K tokens per "
                             "step by n-gram prompt lookup (greedy-only; "
                             "implies --fixed-greedy; raises until the "
                             "speculation gate is ported)")
    parser.add_argument("--logprobs", action="store_true",
                        help="emit per-token logprobs (adds a logsumexp "
                             "to each decode step; disables the fused "
                             "argmax head)")
    parser.add_argument("--chat-template", default="plain",
                        help="chat template for /v1/chat/completions: "
                             "plain | zephyr | chatml")
    parser.add_argument("--mesh", metavar="DATAxMODEL",
                        help="shard the engine over a device mesh (not "
                             "ported yet: raises)")
    parser.add_argument("--overlap", action="store_true",
                        help="with --mesh: ring-overlapped TP decode (not "
                             "ported yet: raises)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or "
                             "cpu (the kernels' plain versions)")
    args = parser.parse_args(argv)
    engine, tok = build_engine(args, parser)
    server, driver = serve(engine, tok, args.host, args.port,
                           burst=args.burst, quiet=False,
                           chat_template=args.chat_template)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(batch {args.max_batch}, burst {args.burst})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        driver.stop()
        server.server_close()


if __name__ == "__main__":  # pragma: no cover
    main()
