"""The port's HTTP serving front end (``rten_tpu_torch/serve.py``) on the
CPU: the tests of ``tests/test_serve.py`` (all but the mesh one) run on the
port's server over a tiny random-weight model carried across from the JAX
package, greedy completions are held equal to the reference's server on
the same weights, and the flags that do not serve yet raise naming their
ROADMAP.md items."""

import argparse
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from rten_tpu.generate.engine import ServingEngine as JServingEngine
from rten_tpu.generate.sampler import PerRequestSampler as JPerRequestSampler
from rten_tpu.models import transformer as jtr
from rten_tpu.serve import serve as jserve
from rten_tpu_torch.generate.engine import ServingEngine
from rten_tpu_torch.generate.sampler import PerRequestSampler
from rten_tpu_torch.models import (TransformerConfig, TransformerLM,
                                   params_from_numpy)
from rten_tpu_torch.serve import build_engine, main, serve

# GPT-2-family rows of 2 heads of 64 (128 values), so an int8 cache takes
# the tail window at max_batch 4, as GPT-2-small's does.
TAIL_CFG = dict(n_heads=2, d_model=128)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(seed, quantize=False, **cfg):
    """(reference model, its params, port model, the same params carried
    across by params_from_numpy on the CPU)."""
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_test(**cfg))
    jp = jm.init_params(jax.random.PRNGKey(seed))
    if quantize:
        jp = jtr.quantize_weights(jp, "int8")
    pm = TransformerLM(TransformerConfig.tiny_test(**cfg))
    return jm, jp, pm, params_from_numpy(_np_tree(jp), device="cpu")


def _start(engine, serve_fn=serve, **kw):
    """Serve ``engine`` on a free port in a thread; returns (base URL,
    stop)."""
    srv, driver = serve_fn(engine, port=0, **kw)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def stop():
        srv.shutdown()
        driver.stop()
        srv.server_close()

    return f"http://127.0.0.1:{srv.server_address[1]}", stop


@pytest.fixture(scope="module")
def server():
    _, _, pm, pp = _models(0)
    # The server's default: per-request sampling (requests without
    # sampling params decode greedily).
    engine = ServingEngine(pm, pp, max_batch=2, capacity=64,
                           prefill_buckets=(16,),
                           sampler=PerRequestSampler(max_k=16), device="cpu")
    base, stop = _start(engine, burst=1)
    yield base
    stop()


def _post(base, path, payload, timeout=300):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _completion(base, payload):
    with _post(base, "/v1/completions", payload) as resp:
        return json.load(resp)["choices"][0]


def _stream(base, path, payload):
    """(the SSE chunks' choices, in order) of a streamed request."""
    choices = []
    with _post(base, path, {**payload, "stream": True}) as resp:
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            data = line[len("data: "):]
            if data == "[DONE]":
                break
            choices.append(json.loads(data)["choices"][0])
    return choices


def test_health_and_models(server):
    with urllib.request.urlopen(server + "/health", timeout=60) as resp:
        assert json.load(resp)["status"] == "ok"
    with urllib.request.urlopen(server + "/v1/models", timeout=60) as resp:
        data = json.load(resp)
    assert data["data"][0]["id"] == "rten-tpu"


def test_completion_basic(server):
    with _post(server, "/v1/completions",
               {"prompt": [1, 2, 3], "max_tokens": 5}) as resp:
        data = json.load(resp)
    choice = data["choices"][0]
    assert len(choice["token_ids"]) == 5
    assert choice["finish_reason"] == "length"
    assert data["usage"] == {"prompt_tokens": 3, "completion_tokens": 5,
                             "total_tokens": 8}
    assert data["metrics"]["tokens_per_s"] > 0


def test_completion_deterministic_across_requests(server):
    results = [_completion(server, {"prompt": [7, 8, 9, 10],
                                    "max_tokens": 6})["token_ids"]
               for _ in range(2)]
    # Greedy sampling: same prompt -> same tokens regardless of slot.
    assert results[0] == results[1]


def test_streaming_matches_non_streaming(server):
    payload = {"prompt": [4, 5, 6], "max_tokens": 4}
    full = _completion(server, payload)["token_ids"]
    chunks = _stream(server, "/v1/completions", payload)
    streamed = [t for c in chunks for t in c["token_ids"]]
    finish = [c["finish_reason"] for c in chunks if c.get("finish_reason")]
    assert streamed == full
    assert finish == ["length"]


def test_stop_ids(server):
    # Learn the greedy continuation, then stop on its second token.
    tokens = _completion(server, {"prompt": [1, 2, 3],
                                  "max_tokens": 5})["token_ids"]
    stop = tokens[1]
    expected = tokens[:tokens.index(stop) + 1]  # first occurrence wins
    data = _completion(server, {"prompt": [1, 2, 3], "max_tokens": 5,
                                "stop_ids": [stop]})
    assert data["token_ids"] == expected
    assert data["finish_reason"] == "stop"


def test_concurrent_requests_share_batch(server):
    results = {}

    def fetch(name, prompt):
        results[name] = _completion(server, {"prompt": prompt,
                                             "max_tokens": 6})["token_ids"]

    threads = [threading.Thread(target=fetch, args=(i, [10 + i, 20 + i]))
               for i in range(3)]  # 3 requests > max_batch=2: queueing too
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert sorted(results) == [0, 1, 2]
    assert all(len(v) == 6 for v in results.values())


def test_bad_requests(server):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server, "/v1/completions", {"prompt": "text prompt"})
    assert err.value.code == 400  # no tokenizer configured
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server, "/v1/completions", {"prompt": {"bad": 1}})
    assert err.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server, "/nope", {})
    assert err.value.code == 404


def test_stats_counts(server):
    _completion(server, {"prompt": [2, 3], "max_tokens": 2})
    with urllib.request.urlopen(server + "/stats", timeout=60) as resp:
        stats = json.load(resp)
    assert stats["submitted"] >= stats["completed"] > 0
    assert stats["tokens"] > 0


def test_per_request_sampling_params(server):
    greedy = _completion(server, {"prompt": [11, 12, 13],
                                  "max_tokens": 6})["token_ids"]
    # temperature=0 in the body must reproduce it, and so must top_k=1 and
    # a tiny top_p at a temperature.
    for knobs in ({"temperature": 0.0}, {"temperature": 1.0, "top_k": 1},
                  {"temperature": 1.0, "top_p": 1e-6}):
        assert _completion(server, {"prompt": [11, 12, 13], "max_tokens": 6,
                                    **knobs})["token_ids"] == greedy, knobs
    # A hot stochastic request runs in the same engine.
    hot = _completion(server, {"prompt": [11, 12, 13], "max_tokens": 6,
                               "temperature": 1.2, "top_k": 8,
                               "top_p": 0.9})["token_ids"]
    assert len(hot) == 6 and all(0 <= t < 128 for t in hot)


def test_prefix_registration_endpoint(server):
    system = [42, 43, 44, 45]
    cold = _completion(server, {"prompt": system + [46],
                                "max_tokens": 5})["token_ids"]
    with _post(server, "/v1/prefixes", {"prompt": system}) as resp:
        assert json.load(resp)["registered"] == 4
    warm = _completion(server, {"prompt": system + [46],
                                "max_tokens": 5})["token_ids"]
    assert warm == cold
    with urllib.request.urlopen(server + "/stats", timeout=60) as resp:
        assert json.load(resp)["prefix_hits"] >= 1
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server, "/v1/prefixes", {"prompt": []})
    assert err.value.code == 400


# -- chat completions --------------------------------------------------------

class _CharTok:
    """Char-level stub tokenizer (vocab 128 = tiny_test's vocab)."""

    def encode(self, text, add_special=False):
        return [min(ord(c), 127) for c in text]

    def decode(self, ids):
        return "".join(chr(i) for i in ids)


@pytest.fixture(scope="module")
def chat_server():
    _, _, pm, pp = _models(1)
    engine = ServingEngine(pm, pp, max_batch=2, capacity=64,
                           prefill_buckets=(32,), device="cpu")
    base, stop = _start(engine, tokenizer=_CharTok(), burst=1,
                        chat_template="plain")
    yield base
    stop()


def test_chat_completion_basic(chat_server):
    with _post(chat_server, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 4}) as resp:
        data = json.load(resp)
    assert data["object"] == "chat.completion"
    msg = data["choices"][0]["message"]
    assert msg["role"] == "assistant"
    assert isinstance(msg["content"], str) and len(msg["content"]) == 4
    assert data["usage"]["completion_tokens"] == 4


def test_chat_streaming_matches_non_streaming(chat_server):
    body = {"messages": [{"role": "user", "content": "abc"}],
            "max_tokens": 5}
    with _post(chat_server, "/v1/chat/completions", body) as resp:
        want = json.load(resp)["choices"][0]["message"]["content"]
    chunks = _stream(chat_server, "/v1/chat/completions", body)
    text = "".join(c.get("delta", {}).get("content", "") for c in chunks)
    finish = [c["finish_reason"] for c in chunks if c.get("finish_reason")]
    assert text == want
    assert finish == ["length"]


def test_chat_bad_messages(chat_server):
    for bad in ({}, {"messages": []},
                {"messages": [{"role": "alien", "content": "x"}]},
                {"messages": [{"content": "x"}]}):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(chat_server, "/v1/chat/completions", bad)
        assert exc.value.code == 400


def test_prompt_exceeding_bucket_is_rejected_not_hung(chat_server):
    """A prompt longer than the largest prefill bucket must 400, and the
    server keeps serving."""
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(chat_server, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "x" * 64}],
            "max_tokens": 2}, timeout=60)
    assert exc.value.code == 400
    with _post(chat_server, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "ok"}],
            "max_tokens": 2}, timeout=120) as resp:
        assert json.load(resp)["choices"][0]["finish_reason"] == "length"


def test_logprobs_in_response():
    """Engine logprobs surface through the completions API, equal to the
    reference server's within 1e-5."""
    jm, jp, pm, pp = _models(2)
    kw = dict(max_batch=2, capacity=64, prefill_buckets=(16,),
              logprobs=True)
    base, stop = _start(ServingEngine(pm, pp, device="cpu", **kw), burst=1)
    jbase, jstop = _start(JServingEngine(jm, jp, **kw), jserve, burst=1)
    try:
        body = {"prompt": [1, 2, 3], "max_tokens": 4, "logprobs": True}
        choice, ref = _completion(base, body), _completion(jbase, body)
        lps = choice["logprobs"]["token_logprobs"]
        assert len(lps) == 4 and all(v <= 0.0 for v in lps)
        assert choice["token_ids"] == ref["token_ids"]
        np.testing.assert_allclose(lps, ref["logprobs"]["token_logprobs"],
                                   rtol=0, atol=1e-5)
        # Without the flag the field is absent.
        assert "logprobs" not in _completion(base, {"prompt": [1, 2, 3],
                                                    "max_tokens": 2})
    finally:
        stop()
        jstop()


def test_serve_quantized_default_int8_cache():
    """int8 weights + the engine's cache="auto" policy (what `--quantize`
    resolves to) serves a completion over HTTP on the int8 cache with its
    tail window, and the same engine configuration offline emits the same
    tokens."""
    _, _, pm, pp = _models(3, quantize=True, **TAIL_CFG)
    kw = dict(max_batch=4, capacity=64, prefill_buckets=(16,), cache="auto",
              device="cpu")
    engine = ServingEngine(pm, pp, **kw)
    assert engine.quantized_cache and engine._tail_flush == 16
    base, stop = _start(engine, burst=1)
    try:
        choice = _completion(base, {"prompt": [1, 2, 3], "max_tokens": 4})
        assert len(choice["token_ids"]) == 4
        eng2 = ServingEngine(pm, pp, **kw)
        assert eng2.generate([[1, 2, 3]],
                             max_new_tokens=4)[0] == choice["token_ids"]
    finally:
        stop()


@pytest.mark.parametrize("quantize,burst", [(False, 1), (True, 3)])
def test_greedy_completions_equal_reference_server(quantize, burst):
    """The same weights behind the port's and the reference's server, the
    same requests one at a time (the same sequence of admissions): greedy
    completions give the same ids, plain and streamed, cold and under a
    registered prefix (f32 weights; int8 weights on the int8 cache with
    its tail window, whose warm path is the reference's warm path)."""
    cfg = TAIL_CFG if quantize else {}
    jm, jp, pm, pp = _models(4, quantize=quantize, **cfg)
    kw = dict(max_batch=4, capacity=64, prefill_buckets=(8, 16))
    if quantize:
        kw["cache"] = "auto"
    port = ServingEngine(pm, pp, sampler=PerRequestSampler(max_k=16),
                         device="cpu", **kw)
    ref = JServingEngine(jm, jp, sampler=JPerRequestSampler(max_k=16), **kw)
    assert port._tail_flush == ref._tail_flush == (16 if quantize else 0)
    base, stop = _start(port, burst=burst)
    jbase, jstop = _start(ref, jserve, burst=burst)
    try:
        system = [9, 8, 7, 6, 5]
        prompts = [[1, 2, 3], system + [4], [100, 3, 7, 7, 1, 2]]
        for b in (base, jbase):
            with _post(b, "/v1/prefixes", {"prompt": system}) as resp:
                assert json.load(resp)["registered"] == len(system)
        for prompt in prompts + [system + [4, 4, 2]]:
            body = {"prompt": prompt, "max_tokens": 7}
            got = _completion(base, body)["token_ids"]
            assert got == _completion(jbase, body)["token_ids"], prompt
            for b in (base, jbase):
                streamed = [t for c in _stream(b, "/v1/completions", body)
                            for t in c["token_ids"]]
                assert streamed == got, (b, prompt)
        stats = [json.load(urllib.request.urlopen(b + "/stats", timeout=60))
                 for b in (base, jbase)]
        assert stats[0]["prefix_hits"] == stats[1]["prefix_hits"] == 4
    finally:
        stop()
        jstop()


# -- build_engine and the CLI -------------------------------------------------

def _args(**kw):
    base = dict(weights=None, demo=True, quantize="int8", tokenizer=None,
                fixed_greedy=False, spec_draft=0, kv_cache=None, mesh=None,
                max_batch=2, capacity=64, paged=False, page_size=64,
                logprobs=False, overlap=False, device="cpu")
    return argparse.Namespace(**{**base, **kw})


def test_serve_cli_cache_wiring():
    """--quantize must reach the engine as cache="auto": the int8 cache
    (the reference's pin of this wiring is tests/test_serve.py:409), with
    the per-request sampler, so the fused head is off."""
    engine, tok = build_engine(_args())
    assert tok is None
    assert engine.quantized_cache            # auto resolved to int8
    assert engine.cache.scales is not None
    assert isinstance(engine.sampler, PerRequestSampler)
    assert not engine._fused_head
    assert engine.model.config == TransformerConfig.gpt2()
    fixed, _ = build_engine(_args(quantize=None, fixed_greedy=True))
    assert not fixed.quantized_cache and fixed._fused_head


@pytest.mark.parametrize("flag", [dict(mesh="2x2"), dict(overlap=True)])
def test_mesh_flags_raise_naming_parallel(flag):
    with pytest.raises(NotImplementedError, match="Queue 1, parallel/"):
        build_engine(_args(**flag))


def test_spec_draft_raises_naming_the_speculative_gate():
    with pytest.raises(NotImplementedError, match="speculative gate"):
        build_engine(_args(spec_draft=3))


def test_cli_defaults_to_the_card():
    """Without --device cpu the CLI asks for the card, which raises here
    before any weights are drawn."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--demo", "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(_args(device="cuda"))
